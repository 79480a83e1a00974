"""First-order inverse-compositional Gauss-Newton, plain, for 2D and 3D
(oc_icgn.cpp: ICGN2D1 and ICGN3D1).

Per POI: the entry guard (the subset inside the image, a finite seed
smaller than the image, no earlier failure, else -3 or the earlier code);
the reference subset less its mean and its norm; steepest-descent images
(each gradient times 1 and each local coordinate) and their Hessian,
inverted once; then at most ``max_iter`` steps: warp the local grid,
sample the target (a sample out of range reads -1, and any negative
sample fails the POI with -3), error = target * (|ref| / |target|) - ref
(both less their means), ZNSSD = |error|^2 / |ref|^2, dp = H^-1 sd^T
error, warp <- warp . warp(dp)^-1, stop once the weighted norm of dp is
below ``conv``.  ZNCC = 1 - ZNSSD / 2 of the last step; -4 where the
limit was reached unconverged, -5 on NaN (displacement back to the seed).
Each POI also keeps the sample that came closest to zero over its steps
(``closest``): where that is a rounding error from zero, the -3 rule can
go either way between two precisions.
"""

from __future__ import annotations

import torch

from .common import window_index


def _warp(p: torch.Tensor, d: int) -> torch.Tensor:
    """[B, d*(d+1)] rows (c, c_x, c_y[, c_z]) per component c -> [B, d+1,
    d+1] homogeneous affine warp."""
    b = p.shape[0]
    w = torch.zeros((b, d + 1, d + 1), dtype=p.dtype, device=p.device)
    for c in range(d):
        row = p[:, c * (d + 1):(c + 1) * (d + 1)]
        w[:, c, d] = row[:, 0]
        w[:, c, :d] = row[:, 1:]
        w[:, c, c] += 1.0
    w[:, d, d] = 1.0
    return w


def _params(w: torch.Tensor, d: int) -> torch.Tensor:
    cols = []
    for c in range(d):
        cols.append(w[:, c, d])
        for j in range(d):
            cols.append(w[:, c, j] - (1.0 if j == c else 0.0))
    return torch.stack(cols, -1)


def icgn1(ref: torch.Tensor, grads, sampler, centers: torch.Tensor,
          seed: torch.Tensor, zncc_in: torch.Tensor, radius, conv: float,
          max_iter: int, norm_weights, block: int):
    """``ref`` and ``grads`` (d/dx, d/dy[, d/dz]) in array axis order
    ([H, W] or [Z, Y, X]); ``sampler(coords)`` evaluates the target at
    float coordinates given in x, y(, z) order, -1 out of range;
    ``centers`` [N, d] integer POIs and ``seed`` [N, d] displacements,
    x first; ``radius`` per x, y(, z); ``norm_weights`` [d*(d+1)] weigh
    dp^2 in the convergence norm.  Returns (p [N, d*(d+1)] in rows (c, c_x,
    c_y[, c_z]), zncc [N], iterations [N], closest [N]: the least |sample|
    the POI's steps read)."""
    dt = ref.dtype
    dev = ref.device
    n, d = centers.shape
    k = d * (d + 1)
    dims_xyz = torch.tensor(list(reversed(ref.shape)), dtype=dt, device=dev)
    rad = torch.tensor(radius, dtype=dt, device=dev)
    valid = (((centers - rad) >= 0) & ((centers + rad) <= dims_xyz - 1)
             & (seed.abs() < dims_xyz) & ~torch.isnan(seed)).all(1) & (
        zncc_in >= 0)
    sides = [2 * r + 1 for r in radius]
    top = torch.tensor([s - w for s, w in zip(ref.shape, reversed(sides))],
                       device=dev)
    # local coordinates, x fastest, as [d, S] (x, y, z rows)
    axes = [torch.arange(-r, r + 1, dtype=dt, device=dev) for r in radius]
    mesh = torch.meshgrid(*reversed(axes), indexing="ij")
    local = torch.stack([m.reshape(-1) for m in reversed(mesh)])
    nw = torch.as_tensor(norm_weights, dtype=dt, device=dev)

    p_out = torch.zeros((n, k), dtype=dt, device=dev)
    zncc_out = torch.zeros(n, dtype=dt, device=dev)
    it_out = torch.zeros(n, dtype=dt, device=dev)
    closest_out = torch.full((n,), float("inf"), dtype=dt, device=dev)
    for b0 in range(0, n, block):
        c = centers[b0:b0 + block]
        ok = valid[b0:b0 + block]
        b = c.shape[0]
        corner = (c - rad).round().long()
        starts = torch.stack([corner[:, a] for a in reversed(range(d))], 1)
        starts = torch.minimum(torch.clamp(starts, min=0), top)
        idx = window_index(starts, list(reversed(sides)))
        ref_sub = ref[idx].reshape(b, -1)
        ref_zm = ref_sub - ref_sub.mean(1, keepdim=True)
        rn = torch.sqrt((ref_zm * ref_zm).sum(1))
        chans = []
        for g in grads:
            gs = g[idx].reshape(b, -1)
            chans.append(gs)
            chans.extend(gs * local[j] for j in range(d))
        sd = torch.stack(chans, 1)  # [B, K, S]
        hinv = torch.linalg.inv(torch.bmm(sd, sd.transpose(1, 2)))

        p0 = torch.zeros((b, k), dtype=dt, device=dev)
        for a in range(d):
            p0[:, a * (d + 1)] = seed[b0:b0 + block, a]
        wmat = _warp(p0, d)
        active = ok.clone()
        it = torch.zeros(b, dtype=dt, device=dev)
        dpn = torch.zeros(b, dtype=dt, device=dev)
        znssd = torch.zeros(b, dtype=dt, device=dev)
        oob = torch.zeros(b, dtype=torch.bool, device=dev)
        closest = torch.full((b,), float("inf"), dtype=dt, device=dev)
        homog = torch.cat([local, torch.ones_like(local[:1])])  # [d+1, S]
        while bool(active.any()):
            coords = torch.matmul(wmat[:, :d, :], homog) + c[:, :, None]
            tval = sampler([coords[:, a] for a in range(d)])
            fail = (tval < 0).any(1) & active
            closest = torch.where(active, torch.minimum(
                closest, tval.abs().amin(1)), closest)
            tar_zm = tval - tval.mean(1, keepdim=True)
            tn = torch.sqrt((tar_zm * tar_zm).sum(1))
            err = tar_zm * (rn / tn)[:, None] - ref_zm
            znssd_new = (err * err).sum(1) / (rn * rn)
            dp = torch.bmm(hinv, torch.bmm(sd, err[:, :, None]))[:, :, 0]
            wnew = torch.bmm(wmat, torch.linalg.inv(_warp(dp, d)))
            dpn_new = torch.sqrt((dp * dp * nw).sum(1))
            step = active & ~fail
            wmat = torch.where(step[:, None, None], wnew, wmat)
            znssd = torch.where(step, znssd_new, znssd)
            dpn = torch.where(step, dpn_new, dpn)
            it = torch.where(step, it + 1.0, it)
            oob = oob | fail
            active = step & (dpn >= conv) & (it < max_iter)
        p = _params(wmat, d)
        zncc = 1.0 - 0.5 * znssd
        zncc = torch.where((dpn >= conv) & (it >= max_iter),
                           torch.full_like(zncc, -4.0), zncc)
        disp = p[:, ::d + 1]
        nan = torch.isnan(zncc) | torch.isnan(disp).any(1)
        zncc = torch.where(nan, torch.full_like(zncc, -5.0), zncc)
        p[:, ::d + 1] = torch.where(nan[:, None], p0[:, ::d + 1], disp)
        computed = ok & ~oob
        p = torch.where(computed[:, None], p, p0)
        guard = torch.where(zncc_in[b0:b0 + block] >= 0,
                            torch.full_like(zncc, -3.0),
                            zncc_in[b0:b0 + block])
        zncc = torch.where(ok, torch.where(oob, torch.full_like(zncc, -3.0),
                                           zncc), guard)
        p_out[b0:b0 + block] = p
        zncc_out[b0:b0 + block] = zncc
        it_out[b0:b0 + block] = torch.where(computed, it,
                                            torch.zeros_like(it))
        closest_out[b0:b0 + block] = closest
    return p_out, zncc_out, it_out, closest_out
