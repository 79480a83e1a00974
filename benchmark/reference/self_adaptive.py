"""Plain self-adaptive-subset 2D DIC on one image pair: SIFT2D ->
FeatureAffine2D with self-adaptive subsets -> ICGN2D1 at each POI's own
radii -> Strain (OpenCorr's test_2d_dic_self_adaptive_subset.cpp).

* Keypoints: :mod:`reference.sift2d`, matched with the ratio test.
* Subsets (oc_feature_affine.cpp:128-179): each POI's ``feature_min``
  nearest reference keypoints (the lower index first among equal
  distances); a POI outside their bounding box moves to its centre, and
  the radii cover the box from the POI, truncated to integers and at
  least ``radius_min``.  OpenCorr computes the box in float, with float
  keypoint coordinates, and so does this file.
* Guess (oc_feature_affine.cpp:230-342): RANSAC over those keypoints,
  centred on the (moved) POI: ``trials`` fits of an affine to 3 distinct
  keypoints, each keypoint an inlier within ``error_threshold``, the
  first largest consensus set, then the least-squares affine on it.  The
  trials take the port's documented draws (``torch.randint`` from a CPU
  generator seeded with ``seed``, [3, N, trials] in [0, 2^30)) and its
  rule for turning them into 3 distinct indices; a trial whose 3 points
  are collinear gives no model.  Fewer than 3 keypoints: -1; a largest
  set under 3: -2.
* Refinement: first-order IC-GN (oc_icgn.cpp:144-351) from the whole
  affine guess, on the (2 sry + 1) x (2 srx + 1) subset of each POI,
  sampled with :func:`reference.dic2d.bicubic_sampler`; the convergence
  norm weighs dp by 1, srx^2 and sry^2.
* Strain: :func:`reference.common.strain` on the moved POIs.

Nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from . import common
from . import sift2d as plain_sift
from .common import window_index
from .dic2d import bicubic_sampler, grid_points
from .icgn import _params, _warp

f32 = plain_sift.as_float32


def ransac_draws(seed: int, n: int, trials: int) -> torch.Tensor:
    """[3, n, trials] int64 draws in [0, 2^30) from a CPU generator seeded
    with ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, 1 << 30, (3, n, trials), generator=gen,
                         dtype=torch.int64)


def nearest(points, keypoints, k: int, rows: int = 2048):
    """[N, k] indices of each point's ``k`` nearest keypoints, nearest
    first, the lower index first among equal distances."""
    out = []
    for i in range(0, points.shape[0], rows):
        q = points[i:i + rows]
        d2 = ((q[:, None, :] - keypoints[None, :, :]) ** 2).sum(-1)
        out.append(torch.sort(d2, dim=1, stable=True).indices[:, :k])
    return torch.cat(out)


def adapt(pts, ref_kp, feature_min: int, radius_min: int):
    """The self-adaptive subsets: (moved POIs [N, 2], radii [N, 2] (srx,
    sry), the KNN indices [N, k])."""
    knn = nearest(pts, ref_kp, min(feature_min, ref_kp.shape[0]))
    kx, ky = ref_kp[knn, 0], ref_kp[knn, 1]
    x, y = pts[:, 0], pts[:, 1]
    lo_x, hi_x = kx.min(1).values, kx.max(1).values
    lo_y, hi_y = ky.min(1).values, ky.max(1).values
    inside = (x >= lo_x) & (x <= hi_x) & (y >= lo_y) & (y <= hi_y)
    half = lambda a: f32(0.5 * f32(a))
    srx = torch.where(inside, torch.maximum(f32(hi_x - x), f32(x - lo_x)),
                      half(hi_x - lo_x))
    sry = torch.where(inside, torch.maximum(f32(hi_y - y), f32(y - lo_y)),
                      half(hi_y - lo_y))
    mx = torch.where(inside, x, half(hi_x + lo_x))
    my = torch.where(inside, y, half(hi_y + lo_y))
    moved = torch.trunc(torch.stack([mx, my], -1))
    radii = torch.clamp(torch.trunc(torch.stack([srx, sry], -1)),
                        min=float(radius_min))
    return moved, radii, knn


def _affine(src, dst):
    """The affine [.., 3, 3] taking the rows [x y 1] of 3 points ``src``
    [.., 3, 2] to those of ``dst``, and whether the 3 points span the
    plane (else no model)."""
    one = torch.ones_like(src[..., :1])
    a = torch.cat([src, one], -1)
    sol, info = torch.linalg.solve_ex(a, torch.cat([dst, one], -1))
    return sol, (info == 0) & (torch.linalg.det(a) != 0)


def ransac(rc, tc, draws, error_threshold: float):
    """rc, tc [N, k, 2] keypoint pairs about each POI; draws [3, N, T],
    one trial a column.
    Returns (p [N, 6] u ux uy v vx vy, code [N]: 0, -1 or -2)."""
    n, k = rc.shape[:2]
    nn = max(k, 3)
    u = draws.to(rc.device)
    j1 = u[0] % nn
    j2 = (j1 + 1 + u[1] % (nn - 1)) % nn
    lo, hi = torch.minimum(j1, j2), torch.maximum(j1, j2)
    j3 = u[2] % max(nn - 2, 1)
    j3 = j3 + (j3 >= lo)
    j3 = j3 + (j3 >= hi)
    pick = torch.stack([j1, j2, j3], -1)  # [N, T, 3]
    rows = torch.arange(n, device=rc.device)[:, None, None]
    aff, ok = _affine(rc[rows, pick], tc[rows, pick])  # [N, T, 3, 3]
    one = torch.ones_like(rc[..., :1])
    rch = torch.cat([rc, one], -1)
    mapped = torch.einsum("nka,ntab->ntkb", rch, aff)[..., :2]
    err = (mapped - tc[:, None]).norm(dim=-1)
    inlier = (err < error_threshold) & ok[..., None]
    size = inlier.sum(-1)
    best = torch.argmax(size, 1)
    keep = inlier[torch.arange(n, device=rc.device), best]  # [N, k]
    w = keep.to(rc.dtype)[..., None]
    a = torch.cat([rc, one], -1)
    b = torch.cat([tc, one], -1)
    af = torch.linalg.solve_ex((a * w).transpose(1, 2) @ a,
                               (a * w).transpose(1, 2) @ b)[0]
    p = torch.stack([af[:, 2, 0], af[:, 0, 0] - 1.0, af[:, 1, 0],
                     af[:, 2, 1], af[:, 0, 1], af[:, 1, 1] - 1.0], -1)
    found = k >= 3
    good = found & (size.gather(1, best[:, None])[:, 0] >= 3)
    code = torch.where(good, torch.zeros_like(p[:, 0]),
                       torch.full_like(p[:, 0], -2.0 if found else -1.0))
    return torch.where(good[:, None], p, torch.zeros_like(p)), code


def icgn_subsets(ref, grads, sampler, centers, radii, p0, zncc_in,
                 conv: float, max_iter: int, samples: int = 1 << 23):
    """First-order IC-GN of every POI at its own radii, from the whole
    guess ``p0`` [N, 6] (u ux uy v vx vy), POIs of one radius pair at a
    time, about ``samples`` subset pixels a block.  Returns (p [N, 6],
    zncc [N], iterations [N], closest [N]: the least |sample| the POI's
    steps read)."""
    dt, dev = ref.dtype, ref.device
    h, w = ref.shape
    n = centers.shape[0]
    p_out = p0.clone()
    zncc_out = torch.zeros(n, dtype=dt, device=dev)
    it_out = torch.zeros(n, dtype=dt, device=dev)
    closest_out = torch.full((n,), float("inf"), dtype=dt, device=dev)
    dims = torch.tensor([w, h], dtype=dt, device=dev)
    key = radii[:, 0] * 4096 + radii[:, 1]
    for k in torch.unique(key).tolist():
        group = torch.nonzero(key == k)[:, 0]
        rx, ry = int(radii[group[0], 0]), int(radii[group[0], 1])
        sw, sh = 2 * rx + 1, 2 * ry + 1
        rad = torch.tensor([rx, ry], dtype=dt, device=dev)
        xl = (torch.arange(sw, dtype=dt, device=dev) - rx).repeat(sh)
        yl = (torch.arange(sh, dtype=dt, device=dev) - ry).repeat_interleave(
            sw)
        homog = torch.stack([xl, yl, torch.ones_like(xl)])
        nw = torch.tensor([1.0, rx * rx, ry * ry] * 2, dtype=dt, device=dev)
        block = max(1, samples // (sw * sh))
        for b0 in range(0, group.shape[0], block):
            ib = group[b0:b0 + block]
            c = centers[ib]
            seed = p0[ib][:, [0, 3]]
            z_in = zncc_in[ib]
            ok = (((c - rad) >= 0) & ((c + rad) <= dims - 1)
                  & (seed.abs() < dims) & ~torch.isnan(seed)).all(1) & (
                z_in >= 0)
            b = c.shape[0]
            starts = torch.stack([c[:, 1] - ry, c[:, 0] - rx], 1).long()
            starts = torch.minimum(torch.clamp(starts, min=0),
                                   torch.tensor([h - sh, w - sw],
                                                device=dev))
            idx = window_index(starts, [sh, sw])
            ref_sub = ref[idx].reshape(b, -1)
            ref_zm = ref_sub - ref_sub.mean(1, keepdim=True)
            rn = torch.sqrt((ref_zm * ref_zm).sum(1))
            chans = []
            for g in grads:
                gs = g[idx].reshape(b, -1)
                chans += [gs, gs * xl, gs * yl]
            sd = torch.stack(chans, 1)
            hinv = torch.linalg.inv(torch.bmm(sd, sd.transpose(1, 2)))
            start = p0[ib]
            wmat = _warp(start, 2)
            active = ok.clone()
            it = torch.zeros(b, dtype=dt, device=dev)
            dpn = torch.zeros(b, dtype=dt, device=dev)
            znssd = torch.zeros(b, dtype=dt, device=dev)
            oob = torch.zeros(b, dtype=torch.bool, device=dev)
            closest = torch.full((b,), float("inf"), dtype=dt, device=dev)
            while bool(active.any()):
                coords = torch.matmul(wmat[:, :2, :], homog) + c[:, :, None]
                tval = sampler([coords[:, 0], coords[:, 1]])
                fail = (tval < 0).any(1) & active
                closest = torch.where(active, torch.minimum(
                    closest, tval.abs().amin(1)), closest)
                tar_zm = tval - tval.mean(1, keepdim=True)
                tn = torch.sqrt((tar_zm * tar_zm).sum(1))
                err = tar_zm * (rn / tn)[:, None] - ref_zm
                znssd_new = (err * err).sum(1) / (rn * rn)
                dp = torch.bmm(hinv, torch.bmm(sd, err[:, :, None]))[:, :, 0]
                wnew = torch.bmm(wmat, torch.linalg.inv(_warp(dp, 2)))
                dpn_new = torch.sqrt((dp * dp * nw).sum(1))
                step = active & ~fail
                wmat = torch.where(step[:, None, None], wnew, wmat)
                znssd = torch.where(step, znssd_new, znssd)
                dpn = torch.where(step, dpn_new, dpn)
                it = torch.where(step, it + 1.0, it)
                oob = oob | fail
                active = step & (dpn >= conv) & (it < max_iter)
            p = _params(wmat, 2)
            zncc = 1.0 - 0.5 * znssd
            zncc = torch.where((dpn >= conv) & (it >= max_iter),
                               torch.full_like(zncc, -4.0), zncc)
            disp = p[:, [0, 3]]
            nan = torch.isnan(zncc) | torch.isnan(disp).any(1)
            zncc = torch.where(nan, torch.full_like(zncc, -5.0), zncc)
            p[:, [0, 3]] = torch.where(nan[:, None], seed, disp)
            computed = ok & ~oob
            guard = torch.where(z_in >= 0, torch.full_like(zncc, -3.0), z_in)
            p_out[ib] = torch.where(computed[:, None], p, start)
            zncc_out[ib] = torch.where(ok, torch.where(
                oob, torch.full_like(zncc, -3.0), zncc), guard)
            it_out[ib] = torch.where(computed, it, torch.zeros_like(it))
            closest_out[ib] = closest
    return p_out, zncc_out, it_out, closest_out


def run(ref_u8: np.ndarray, tar_u8: np.ndarray, cfg: dict, device,
        dtype=torch.float64) -> dict:
    """The pair's results as host arrays: ``seed`` [N, 4] (the adapted x,
    y, srx, sry), ``p`` [N, 6] (u ux uy v vx vy), ``zncc`` [N],
    ``iterations`` [N] (IC-GN's, 1 where only the guess ran), ``closest``
    [N], ``strain`` [N, 3] (exx, eyy, exy), and the matched keypoints
    ``ref_kp``, ``tar_kp`` [M, 2]."""
    ref_kp, tar_kp, _ = plain_sift.sift_matches(ref_u8, tar_u8,
                                                cfg["sift2d"], dtype, device)
    ref = torch.as_tensor(ref_u8, device=device).to(dtype)
    tar = torch.as_tensor(tar_u8, device=device).to(dtype)
    fa = cfg["feature_affine"]
    pts = torch.as_tensor(grid_points(cfg), dtype=dtype, device=device)
    moved, radii, knn = adapt(pts, ref_kp, fa["subset_feature_min"],
                              fa["subset_radius_min"])
    rs = fa["ransac"]
    draws = ransac_draws(fa["seed"], pts.shape[0], rs["trials"])
    guess, code = ransac(ref_kp[knn] - moved[:, None],
                         tar_kp[knn] - moved[:, None], draws,
                         rs["error_threshold"])
    ic = cfg["icgn"]
    grads = [common.gradient(ref, 1), common.gradient(ref, 0)]
    p, zncc, iters, closest = icgn_subsets(
        ref, grads, bicubic_sampler(tar), moved, radii, guess, code,
        ic["conv"], ic["max_iter"])
    iters = torch.where((iters == 0) & (code == 0), torch.ones_like(iters),
                        iters)
    st = cfg["strain"]
    e = common.strain(moved, p[:, [0, 3]], zncc, st["radius"],
                      st["neighbor_min"], st["zncc_min"], block=512)
    return {k: v.cpu().numpy() for k, v in dict(
        seed=torch.cat([moved, radii], 1), p=p, zncc=zncc,
        iterations=iters, closest=closest, strain=e, ref_kp=ref_kp,
        tar_kp=tar_kp).items()}
