"""Plain stereo 3D-DIC on one frame pair, each frame two views: OpenCorr's
test_3d_dic_epipolar_sift.cpp in its four phases.

1. ref1 -> ref2: the epipolar search, then second-order IC-GN;
2. ref1 -> tar1: SIFT matches, the FeatureAffine2D guess, first-order
   IC-GN;
3. ref1 -> tar2: the epipolar search tar1 -> tar2 from the tar1 matches
   rounded to pixels, its displacement added to phase 2's, then
   second-order IC-GN ref1 -> tar2 from that guess (its entry guard reads
   phase 2's code);
4. both pairs triangulated; the 3D displacement is tar - ref.

* Cameras (oc_calibration.cpp): P = K [R | t], R by Rodrigues.  The
  undistortion maps invert the distortion at every integer sensor pixel
  by the fixed-point iteration of :161-219 (``convergence`` px, at most
  ``iteration`` steps; a pixel stops once both residuals are within it),
  and ``undistort`` (:221-264) looks a point up bilinearly, its position
  clamped into [0, W-2] x [0, H-2].
* Fundamental matrix (oc_stereovision.cpp:36-54): F = K2^-T [t2]x R2
  K1^-1, camera 1 at the origin.
* Search (oc_epipolar_search.cpp:120-205): the parallax estimate, the
  epipolar line of the point in view 2, x_view2 = (int)((k (y + py - b) +
  x + px) / (k^2 + 1)) and y_view2 = (int)(k x_view2 + b) (k, b the
  line's slope and intercept), candidates at x_view2 + (0, +s, -s, +2s,
  -2s, ...) below the search radius with y = (int)(k x + b), each refined
  by first-order IC-GN (:func:`reference.icgn.icgn1`) from its integer
  displacement; a candidate whose subset leaves the image is not chosen,
  the centre always may be; the first largest ZNCC wins, with its whole
  deformation and its candidate's displacement as u0, v0 (0 where its
  IC-GN never ran).  ``(int)`` truncates toward zero.
* FeatureAffine2D (oc_feature_affine.cpp:182-342): each POI's keypoints
  nearer than the search radius (strict), nearest first and the lower
  index first among equal distances, at most ``k_cap``, or its
  ``neighbor_number`` nearest where fewer lie in the radius; fewer than 3
  in the radius: -1; then the RANSAC of
  :func:`reference.self_adaptive.ransac` with the port's documented draws
  (:func:`reference.self_adaptive.ransac_draws`).
* IC-GN: first order from the whole affine guess at fixed radii
  (:func:`reference.self_adaptive.icgn_subsets`); second order
  (oc_icgn.cpp:685-908) in :func:`icgn2`.  Samples come from
  :func:`reference.dic2d.bicubic_sampler`.
* Triangulation (oc_stereovision.cpp:70-124): both points undistorted,
  the four rows x P[2] - P[0], y P[2] - P[1] of each view solved by least
  squares; a NaN coordinate gives the zero point.

Departures: OpenCorr's FLANN match and nanoflann k-d tree are exact here
(:mod:`reference.sift2d`); the RANSAC draws are the port's, not
``rand()``'s; and the search's coarse IC-GN runs 10 iterations, the
example's 5 not reproducing the GT4 golden table.

Everything is computed in the given dtype (float64), from the 8-bit
views; ``sample_dtype`` rounds every target sample to a lower precision
(the control).  Nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from . import common
from . import sift2d as plain_sift
from .common import window_index
from .dic2d import bicubic_sampler, grid_points
from .icgn import icgn1
from .self_adaptive import icgn_subsets, ransac, ransac_draws

def _rodrigues(rx, ry, rz):
    v = np.array([rx, ry, rz], np.float64)
    th = np.linalg.norm(v)
    if th == 0.0:
        return np.eye(3)
    k = v / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * (kx @ kx)


def cameras(cfg: dict) -> list:
    """The configuration's cameras as dicts of float64 numbers and
    matrices (``K``, ``R``, ``T``, ``P``), the principal points moved to
    ``sensor_origin`` (the corner of a window of the sensor, when the
    configuration gives one)."""
    ox, oy = cfg.get("sensor_origin", (0, 0))
    out = []
    for cam in cfg["cameras"]:
        c = dict(fx=0.0, fy=0.0, fs=0.0, cx=0.0, cy=0.0, k1=0.0, k2=0.0,
                 k3=0.0, k4=0.0, k5=0.0, k6=0.0, p1=0.0, p2=0.0)
        c.update(cam["intrinsics"])
        c["cx"] -= ox
        c["cy"] -= oy
        e = dict(tx=0.0, ty=0.0, tz=0.0, rx=0.0, ry=0.0, rz=0.0)
        e.update(cam["extrinsics"])
        c["K"] = np.array([[c["fx"], c["fs"], c["cx"]], [0, c["fy"], c["cy"]],
                           [0, 0, 1.0]])
        c["R"] = _rodrigues(e["rx"], e["ry"], e["rz"])
        c["T"] = np.array([e["tx"], e["ty"], e["tz"]])
        c["P"] = c["K"] @ np.concatenate([c["R"], c["T"][:, None]], 1)
        out.append(c)
    return out


def fundamental(c1: dict, c2: dict) -> np.ndarray:
    t = c2["T"]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    return np.linalg.inv(c2["K"]).T @ tx @ c2["R"] @ np.linalg.inv(c1["K"])


def _distort(c, x, y):
    r2 = x * x + y * y
    rad = ((1 + c["k1"] * r2 + c["k2"] * r2 ** 2 + c["k3"] * r2 ** 3)
           / (1 + c["k4"] * r2 + c["k5"] * r2 ** 2 + c["k6"] * r2 ** 3))
    return (x * rad + 2 * c["p1"] * x * y + c["p2"] * (r2 + 2 * x * x),
            y * rad + c["p1"] * (r2 + 2 * y * y) + 2 * c["p2"] * x * y)


def undistortion_maps(c: dict, h: int, w: int, convergence: float,
                      iteration: int, dtype, device):
    """(map_x, map_y) [H, W]: the undistorted image coordinates of every
    integer sensor pixel."""
    rows, cols = torch.meshgrid(
        torch.arange(h, dtype=dtype, device=device),
        torch.arange(w, dtype=dtype, device=device), indexing="ij")
    y0 = (rows - c["cy"]) / c["fy"]
    x0 = (cols - c["cx"] - c["fs"] * y0) / c["fx"]
    ix, iy = x0, y0
    done = torch.zeros_like(x0, dtype=torch.bool)
    for _ in range(iteration):
        dx, dy = _distort(c, ix, iy)
        dev_x = cols - (dx * c["fx"] + dy * c["fs"] + c["cx"])
        dev_y = rows - (dy * c["fy"] + c["cy"])
        inf = torch.isinf(dev_x) | torch.isinf(dev_y)
        conv = (dev_x.abs() <= convergence) & (dev_y.abs() <= convergence)
        step_y = dev_y / c["fy"]
        ny = torch.where(inf, y0, iy + step_y)
        nx = torch.where(inf, x0, ix + (dev_x - step_y * c["fs"]) / c["fx"])
        move = ~done & ~conv
        ix = torch.where(move, nx, ix)
        iy = torch.where(move, ny, iy)
        done = done | conv | inf
    return ix, iy


def undistort(c: dict, maps, pts: torch.Tensor) -> torch.Tensor:
    """Sensor points [N, 2] -> undistorted sensor points [N, 2]."""
    mx, my = maps
    h, w = mx.shape
    x = pts[:, 0].clamp(0.0, w - 2.0)
    y = pts[:, 1].clamp(0.0, h - 2.0)
    xi, yi = torch.floor(x).long(), torch.floor(y).long()
    xd, yd = x - xi.to(x.dtype), y - yi.to(y.dtype)

    def bil(m):
        return ((m[yi, xi] * (1 - xd) + m[yi, xi + 1] * xd) * (1 - yd)
                + (m[yi + 1, xi] * (1 - xd) + m[yi + 1, xi + 1] * xd) * yd)

    ix, iy = bil(mx), bil(my)
    return torch.stack([ix * c["fx"] + iy * c["fs"] + c["cx"],
                        iy * c["fy"] + c["cy"]], -1)


def triangulate(cams, maps, p1: torch.Tensor, p2: torch.Tensor):
    """Matched sensor points [N, 2] of both views -> world points [N, 3]
    by linear least squares; a NaN coordinate gives the zero point."""
    bad = torch.isnan(p1).any(1) | torch.isnan(p2).any(1)
    p1 = torch.where(bad[:, None], torch.zeros_like(p1), p1)
    p2 = torch.where(bad[:, None], torch.zeros_like(p2), p2)
    rows, rhs = [], []
    for c, m, p in zip(cams, maps, (p1, p2)):
        proj = torch.as_tensor(c["P"], dtype=p.dtype, device=p.device)
        q = undistort(c, m, p)
        for axis in (0, 1):
            rows.append(q[:, axis, None] * proj[2, :3] - proj[axis, :3])
            rhs.append(proj[axis, 3] - q[:, axis] * proj[2, 3])
    a = torch.stack(rows, 1)  # [N, 4, 3]
    b = torch.stack(rhs, 1)[:, :, None]
    at = a.transpose(1, 2)
    world = torch.linalg.solve(at @ a, at @ b)[:, :, 0]
    return torch.where(bad[:, None], torch.zeros_like(world), world)


def epipolar_search(ref, grads, sampler, fmat, pts, par, ecfg: dict,
                    samples: int = 1 << 22):
    """The search from view-1 points ``pts`` [N, 2] (integer).  Returns
    (p [N, 6] u ux uy v vx vy of the winner, its zncc [N], its candidate
    displacement [N, 2] where its IC-GN ran (else 0), the candidates
    outside the image [N])."""
    dt, dev = ref.dtype, ref.device
    h, w = ref.shape
    rad = int(ecfg["radius"])
    step, reach = int(ecfg["search_step"]), int(ecfg["search_radius"])
    offs = [0.0]
    for i in range(step, reach, step):
        offs += [float(i), float(-i)]
    offs = torch.tensor(offs, dtype=dt, device=dev)
    c = offs.shape[0]
    x, y = pts[:, 0], pts[:, 1]
    f = torch.as_tensor(fmat, dtype=dt, device=dev)
    line = torch.stack([x, y, torch.ones_like(x)], -1) @ f.T
    slope = -line[:, 0] / line[:, 1]
    icp = -line[:, 2] / line[:, 1]
    px = par[0][0] * (x - w // 2) + par[0][1] * (y - h // 2) + par[0][2]
    py = par[1][0] * (x - w // 2) + par[1][1] * (y - h // 2) + par[1][2]
    x_v2 = torch.trunc((slope * (y + py - icp) + x + px) / (slope * slope + 1))
    x_tr = x_v2[:, None] + offs[None, :]
    y_tr = torch.trunc(slope[:, None] * x_tr + icp[:, None])
    ok = ((x_tr - rad > 0) & (x_tr + rad < w - 1)
          & (y_tr - rad > 0) & (y_tr + rad < h - 1))
    ok[:, 0] = True
    seed = torch.stack([x_tr - x[:, None], y_tr - y[:, None]], -1)
    n = pts.shape[0]
    p, zncc, it, _ = icgn1(
        ref, grads, sampler, pts.repeat_interleave(c, 0),
        seed.reshape(-1, 2), torch.zeros(n * c, dtype=dt, device=dev),
        (rad, rad), float(ecfg["conv"]), float(ecfg["max_iter"]),
        [1.0, rad * rad, rad * rad] * 2,
        block=max(1, samples // (2 * rad + 1) ** 2))
    score = torch.where(ok, zncc.reshape(n, c),
                        torch.full((n, c), -float("inf"), dtype=dt,
                                   device=dev))
    best = torch.argmax(score, 1)
    rows = torch.arange(n, device=dev)
    pick = lambda a: a.reshape(n, c, *a.shape[1:])[rows, best]
    ran = pick(it) > 0
    return (pick(p), pick(zncc),
            torch.where(ran[:, None], seed[rows, best], torch.zeros_like(
                seed[:, 0])), (~ok).sum(1))


def _warp2(p: torch.Tensor) -> torch.Tensor:
    """[B, 12] (u ux uy uxx uxy uyy v vx vy vxx vxy vyy) -> [B, 6, 6]
    second-order warp (oc_deformation.cpp:301-350)."""
    u, ux, uy, uxx, uxy, uyy, v, vx, vy, vxx, vxy, vyy = p.unbind(-1)
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    rows = [
        [1 + 2 * ux + ux * ux + u * uxx, 2 * u * uxy + 2 * (1 + ux) * uy,
         uy * uy + u * uyy, 2 * u * (1 + ux), 2 * u * uy, u * u],
        [0.5 * (v * uxx + 2 * (1 + ux) * vx + u * vxx),
         1 + uy * vx + ux * vy + v * uxy + u * vxy + vy + ux,
         0.5 * (v * uyy + 2 * uy * (1 + vy) + u * vyy),
         v + v * ux + u * vx, u + v * uy + u * vy, u * v],
        [vx * vx + v * vxx, 2 * v * vxy + 2 * vx * (1 + vy),
         1 + 2 * vy + vy * vy + v * vyy, 2 * v * vx, 2 * v * (1 + vy),
         v * v],
        [0.5 * uxx, uxy, 0.5 * uyy, 1 + ux, uy, u],
        [0.5 * vxx, vxy, 0.5 * vyy, vx, 1 + vy, v],
        [zero, zero, zero, zero, zero, one]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _params2(wm: torch.Tensor) -> torch.Tensor:
    """[B, 6, 6] -> [B, 12] (oc_deformation.cpp:284-299)."""
    return torch.stack(
        [wm[:, 3, 5], wm[:, 3, 3] - 1, wm[:, 3, 4], 2 * wm[:, 3, 0],
         wm[:, 3, 1], 2 * wm[:, 3, 2], wm[:, 4, 5], wm[:, 4, 3],
         wm[:, 4, 4] - 1, 2 * wm[:, 4, 0], wm[:, 4, 1], 2 * wm[:, 4, 2]], -1)


def icgn2(ref, grads, sampler, centers, p_in, zncc_in, radius: int,
          conv: float, max_iter: int, block: int):
    """Second-order IC-GN (oc_icgn.cpp:685-908) of every POI from the
    first-order part of its row ``p_in`` [N, 12] (:765), on a (2r+1)^2
    subset: steepest-descent images of each gradient times 1, x, y,
    x^2/2, xy, y^2/2, the warp w <- w . w(dp)^-1 and the convergence norm
    with weights 1, r^2, r^2, (int)(r^4/4), r^4, (int)(r^4/4) a component
    (:836-856).  The rest as :func:`reference.icgn.icgn1`; a POI the guard
    rejects or that fails with -3 keeps ``p_in``.  Returns (p [N, 12],
    zncc, iterations, closest)."""
    dt, dev = ref.dtype, ref.device
    h, w = ref.shape
    r = radius
    side = 2 * r + 1
    xl = (torch.arange(side, dtype=dt, device=dev) - r).repeat(side)
    yl = (torch.arange(side, dtype=dt, device=dev) - r).repeat_interleave(
        side)
    monos = [torch.ones_like(xl), xl, yl, 0.5 * xl * xl, xl * yl,
             0.5 * yl * yl]
    basis = torch.stack([xl * xl, xl * yl, yl * yl, xl, yl,
                         torch.ones_like(xl)])  # [6, S]
    r4 = float(int(r ** 4 * 0.25))
    nw = torch.tensor([1.0, r * r, r * r, r4, r ** 4, r4] * 2, dtype=dt,
                      device=dev)
    dims = torch.tensor([w, h], dtype=dt, device=dev)
    first = [0, 1, 2, 6, 7, 8]
    n = centers.shape[0]
    p_out = p_in.clone()
    zncc_out = torch.zeros(n, dtype=dt, device=dev)
    it_out = torch.zeros(n, dtype=dt, device=dev)
    closest_out = torch.full((n,), float("inf"), dtype=dt, device=dev)
    for b0 in range(0, n, block):
        c = centers[b0:b0 + block]
        pin = p_in[b0:b0 + block]
        z_in = zncc_in[b0:b0 + block]
        seed = pin[:, [0, 6]]
        b = c.shape[0]
        ok = (((c - r) >= 0) & ((c + r) <= dims - 1) & (seed.abs() < dims)
              & ~torch.isnan(seed)).all(1) & (z_in >= 0)
        starts = torch.stack([c[:, 1] - r, c[:, 0] - r], 1).long()
        starts = torch.minimum(torch.clamp(starts, min=0), torch.tensor(
            [h - side, w - side], device=dev))
        idx = window_index(starts, [side, side])
        ref_sub = ref[idx].reshape(b, -1)
        ref_zm = ref_sub - ref_sub.mean(1, keepdim=True)
        rn = torch.sqrt((ref_zm * ref_zm).sum(1))
        sd = torch.stack([g[idx].reshape(b, -1) * m for g in grads
                          for m in monos], 1)  # [B, 12, S]
        hinv = torch.linalg.inv(torch.bmm(sd, sd.transpose(1, 2)))
        start = torch.zeros_like(pin)
        start[:, first] = pin[:, first]
        wmat = _warp2(start)
        active = ok.clone()
        it = torch.zeros(b, dtype=dt, device=dev)
        dpn = torch.zeros(b, dtype=dt, device=dev)
        znssd = torch.zeros(b, dtype=dt, device=dev)
        oob = torch.zeros(b, dtype=torch.bool, device=dev)
        closest = torch.full((b,), float("inf"), dtype=dt, device=dev)
        while bool(active.any()):
            coords = torch.matmul(wmat[:, 3:5, :], basis) + c[:, :, None]
            tval = sampler([coords[:, 0], coords[:, 1]])
            fail = (tval < 0).any(1) & active
            closest = torch.where(active, torch.minimum(
                closest, tval.abs().amin(1)), closest)
            tar_zm = tval - tval.mean(1, keepdim=True)
            tn = torch.sqrt((tar_zm * tar_zm).sum(1))
            err = tar_zm * (rn / tn)[:, None] - ref_zm
            znssd_new = (err * err).sum(1) / (rn * rn)
            dp = torch.bmm(hinv, torch.bmm(sd, err[:, :, None]))[:, :, 0]
            wnew = torch.bmm(wmat, torch.linalg.inv(_warp2(dp)))
            dpn_new = torch.sqrt((dp * dp * nw).sum(1))
            step = active & ~fail
            wmat = torch.where(step[:, None, None], wnew, wmat)
            znssd = torch.where(step, znssd_new, znssd)
            dpn = torch.where(step, dpn_new, dpn)
            it = torch.where(step, it + 1.0, it)
            oob = oob | fail
            active = step & (dpn >= conv) & (it < max_iter)
        p = _params2(wmat)
        zncc = 1.0 - 0.5 * znssd
        zncc = torch.where((dpn >= conv) & (it >= max_iter),
                           torch.full_like(zncc, -4.0), zncc)
        nan = torch.isnan(zncc) | torch.isnan(p[:, [0, 6]]).any(1)
        zncc = torch.where(nan, torch.full_like(zncc, -5.0), zncc)
        p[:, [0, 6]] = torch.where(nan[:, None], seed, p[:, [0, 6]])
        computed = ok & ~oob
        guard = torch.where(z_in >= 0, torch.full_like(zncc, -3.0), z_in)
        p_out[b0:b0 + block] = torch.where(computed[:, None], p, pin)
        zncc_out[b0:b0 + block] = torch.where(ok, torch.where(
            oob, torch.full_like(zncc, -3.0), zncc), guard)
        it_out[b0:b0 + block] = torch.where(computed, it, torch.zeros_like(it))
        closest_out[b0:b0 + block] = closest
    return p_out, zncc_out, it_out, closest_out


def feature_guess(pts, ref_kp, tar_kp, fcfg: dict):
    """FeatureAffine2D's guess of every POI: (p [N, 6] u ux uy v vx vy,
    code [N]: 0, -1 or -2)."""
    dt, dev = pts.dtype, pts.device
    n = pts.shape[0]
    kc = min(int(fcfg["k_cap"]), ref_kp.shape[0])
    radius = float(fcfg["search_radius"])
    near_min = int(fcfg["neighbor_number"])
    rs = fcfg["ransac"]
    d2 = ((pts[:, None, :] - ref_kp[None, :, :]) ** 2).sum(-1)
    order = torch.sort(d2, dim=1, stable=True).indices[:, :kc]
    dist = torch.sqrt(torch.gather(d2, 1, order))
    in_r = (dist < radius).sum(1)
    count = torch.where(in_r >= near_min, in_r,
                        torch.full_like(in_r, min(near_min, kc)))
    enough = in_r >= int(rs["samples"])
    draws = ransac_draws(fcfg["seed"], n, int(rs["trials"])).to(dev)
    p = torch.zeros((n, 6), dtype=dt, device=dev)
    code = torch.full((n,), -1.0, dtype=dt, device=dev)
    for k in torch.unique(count[enough]).tolist():
        g = torch.nonzero(enough & (count == k))[:, 0]
        idx = order[g, :k]
        ctr = pts[g][:, None, :]
        p[g], code[g] = ransac(ref_kp[idx] - ctr, tar_kp[idx] - ctr,
                               draws[:, g], float(rs["error_threshold"]))
    return p, code


def slot_codes(codes: np.ndarray) -> np.ndarray:
    """[N, 3] the three matches' codes (ZNCC or failure) -> the codes the
    comparison reads, a slot a match: where a POI failed, the first
    failure in phase order on all three slots (a POI fails when any match
    does), else each match's ZNCC."""
    failed = codes < 0
    first = np.argmax(failed, 1)
    code = codes[np.arange(len(codes)), first]
    return np.where(failed.any(1)[:, None], code[:, None], codes)


def slots(disp: np.ndarray, matched: np.ndarray) -> np.ndarray:
    """[N, 3, 5]: a slot a match, each the POI's 3D displacement (u, v, w)
    and the match's position (x, y); ``matched`` [N, 3, 2]."""
    return np.concatenate([np.repeat(disp[:, None, :], 3, 1), matched], -1)


def run(views_ref: np.ndarray, views_tar: np.ndarray, cfg: dict, device,
        dtype=torch.float64, sample_dtype=None) -> dict:
    """The pair's results as host arrays: ``seed`` [N, 4] (the two
    searches' candidate displacements), ``zncc`` [N, 3] (:func:`slot_codes`
    of ``codes`` [N, 3]), ``p`` [N, 3, 5] (:func:`slots`), ``closest``
    [N, 3] (each POI's least |sample| over its three refinements, on every
    slot), ``iterations`` [N] (1: both searches ran), ``strain`` [N, 3]
    (zeros: no Strain in the pair)."""
    as_t = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)
    ref1, ref2 = as_t(views_ref[0]), as_t(views_ref[1])
    tar1, tar2 = as_t(views_tar[0]), as_t(views_tar[1])
    h, w = ref1.shape
    cams = cameras(cfg)
    fmat = fundamental(*cams)
    und = cfg["undistortion"]
    maps = [undistortion_maps(c, h, w, float(und["convergence"]),
                              int(und["iteration"]), dtype, device)
            for c in cams]
    ecfg = cfg["epipolar"]
    par = [(0.0, 0.0, float(ecfg["parallax"][0])),
           (0.0, 0.0, float(ecfg["parallax"][1]))]

    def sampler(img):
        s = bicubic_sampler(img)
        if sample_dtype is None:
            return s
        return lambda c: s(c).to(sample_dtype).to(dtype)

    def gradients(img):
        return [common.gradient(img, 1), common.gradient(img, 0)]

    pts = torch.as_tensor(grid_points(cfg), dtype=dtype, device=device)
    n = pts.shape[0]
    g1 = gradients(ref1)
    i2 = cfg["icgn2d2"]
    r2 = int(i2["radius"])
    block2 = max(1, (1 << 21) // (2 * r2 + 1) ** 2)

    # phase 1: ref1 -> ref2
    s2 = sampler(ref2)
    p_s1, z_s1, seed1, _ = epipolar_search(ref1, g1, s2, fmat, pts, par,
                                           ecfg)
    row = torch.zeros((n, 12), dtype=dtype, device=device)
    row[:, [0, 1, 2, 6, 7, 8]] = p_s1
    p_r2, z_r2, _, cl_r2 = icgn2(ref1, g1, s2, pts, row, z_s1, r2,
                                 float(i2["conv"]), float(i2["max_iter"]),
                                 block2)
    m_r2 = pts + p_r2[:, [0, 6]]

    # phase 2: ref1 -> tar1
    ref_kp, tar_kp, _ = plain_sift.sift_matches(
        views_ref[0], views_tar[0], cfg["sift2d"], dtype, device)
    guess, code = feature_guess(pts, ref_kp, tar_kp, cfg["feature_affine"])
    i1 = cfg["icgn2d1"]
    r1 = int(i1["radius"])
    p_t1, z_t1, _, cl_t1 = icgn_subsets(
        ref1, g1, sampler(tar1), pts, torch.full_like(pts, float(r1)), guess,
        code, float(i1["conv"]), float(i1["max_iter"]))
    m_t1 = pts + p_t1[:, [0, 3]]

    # phase 3: ref1 -> tar2 through the search tar1 -> tar2
    start = torch.round(m_t1)
    p_s2, _, seed2, _ = epipolar_search(tar1, gradients(tar1), sampler(tar2),
                                        fmat, start, par, ecfg)
    row = torch.zeros((n, 12), dtype=dtype, device=device)
    row[:, [0, 1, 2, 6, 7, 8]] = p_t1
    row[:, 0] += p_s2[:, 0]
    row[:, 6] += p_s2[:, 3]
    p_t2, z_t2, _, cl_t2 = icgn2(ref1, g1, sampler(tar2), pts, row, z_t1,
                                 r2, float(i2["conv"]), float(i2["max_iter"]),
                                 block2)
    m_t2 = pts + p_t2[:, [0, 6]]

    # phase 4: triangulation
    ref3d = triangulate(cams, maps, pts, m_r2)
    tar3d = triangulate(cams, maps, m_t1, m_t2)
    host = lambda a: a.cpu().numpy()
    codes = host(torch.stack([z_r2, z_t1, z_t2], 1))
    closest = host(torch.stack([cl_r2, cl_t1, cl_t2], 1).amin(1))
    return dict(
        seed=host(torch.cat([seed1, seed2], 1)), zncc=slot_codes(codes),
        codes=codes,
        p=slots(host(tar3d - ref3d),
                host(torch.stack([m_r2, m_t1, m_t2], 1))),
        closest=np.repeat(closest[:, None], 3, 1),
        iterations=np.ones(n), strain=np.zeros((n, 3)))
