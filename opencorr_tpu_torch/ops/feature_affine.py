"""Batched feature-affine RANSAC: a per-POI deformation guess from matched
keypoints, in 2D (oc_feature_affine.cpp:118-342) and 3D (:347-560).

Per POI: the candidate keypoints (a host k-d tree, see
``models/feature_affine.py``, or the all-pairs search on the device,
:func:`device_candidates`), then ``trials`` RANSAC trials at once, each
fitting an affine to 3 (2D) or 4 (3D) distinct random candidates and
counting the consensus set; the best set (the first maximum) gets a
least-squares affine, which gives the 6 first-order DIC or the 12 DVC
parameters.  Failure codes -1 (too few keypoints in reach) and -2
(inconsistent consensus).

The reference draws from std::mt19937_64 seeded by random_device, so no two
of its runs agree; the JAX package draws from jax.random, which PyTorch
cannot reproduce.  The trial draws are therefore an argument here: integer
draws [S, N, T] in [0, 2^30) (S = 3 in 2D, 4 in 3D), which the modules make
from a seeded ``torch.Generator`` and the tests take from the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.precision import f32, fma
from .linalg import normal_product, solve_small


def ransac_draws(seed: int, n: int, trials: int,
                 samples: int = 4) -> torch.Tensor:
    """[samples, n, trials] int64 draws in [0, 2^30) from a CPU generator
    seeded with ``seed``: the same numbers whatever device the RANSAC runs
    on."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, 1 << 30, (samples, n, trials), generator=gen,
                         dtype=torch.int64)


# bytes of [rows, keypoints] work arrays one chunk of the device search may
# fill, at ``SEARCH_ENTRY_BYTES`` an entry (the float32 differences, the
# float64 fused sums, the distance and the int64 sort key)
SEARCH_BUDGET = 1 << 30
SEARCH_ENTRY_BYTES = 48


def squared_distances(q: torch.Tensor, kp: torch.Tensor, *,
                      fused: bool = True) -> torch.Tensor:
    """[N, M] squared distances between query points q [N, D] and keypoints
    kp [M, D] in float32, (x - kx)^2 + (y - ky)^2 (+ (z - kz)^2).

    ``fused`` rounds them as XLA compiles the JAX package's device search
    for the CPU: dy^2 rounded, then fused multiply-adds dx^2 + that, then
    dz^2 + that (``utils/precision.fma``).  Otherwise each square rounds
    and the sum runs left to right, as numpy computes the self-adaptive
    subsets' distances."""
    diffs = [q[:, a, None] - kp[None, :, a] for a in range(q.shape[1])]
    if not fused:
        d2 = diffs[0] * diffs[0]
        for d in diffs[1:]:
            d2 += d * d
        return d2
    d2 = diffs[1] * diffs[1]
    for d in [diffs[0]] + diffs[2:]:
        d2 = fma(d, d, d2)
    return d2


def nearest(d2: torch.Tensor, k: int):
    """The k smallest entries of every row of d2 (float32 >= 0) in
    ascending order, the lower column first among equal values, as
    ``jax.lax.top_k`` orders them: (values [N, k], columns [N, k] int64).
    A non-negative float's bits order as the float does, so one int64 key
    (bits << 32 | column) ranks distance, then column."""
    col = torch.arange(d2.shape[1], device=d2.device)
    key = (d2.view(torch.int32).to(torch.int64) << 32) | col
    top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    idx = top & 0xFFFFFFFF
    return torch.gather(d2, 1, idx), idx


def device_candidates(ref_kp: torch.Tensor, q: torch.Tensor, radius: float,
                      neighbor_min: int, samples: int, k_cap: int, *,
                      knn_k=None, fused: bool = True):
    """The JAX package's device neighbour stage (``feature_affine_2d``/
    ``_3d``): every POI's squared distance to every keypoint, the
    in-radius count nr, the kc = min(k_cap, M) nearest in ascending
    distance, and the candidate mask: the in-radius ones where nr reaches
    ``neighbor_min``, else the nearest ``neighbor_min``; with ``knn_k``
    (self-adaptive mode) the nearest ``knn_k``.  ``enough``: nr >= samples,
    or with ``knn_k`` at least ``samples`` candidates.  ``fused``: the
    distances' rounding (:func:`squared_distances`).  In row chunks of at
    most ``SEARCH_BUDGET`` bytes of work arrays.  Returns (idx [N, kc]
    int32, cand_mask [N, kc] bool, enough [N] bool) on q's device."""
    n, m = q.shape[0], ref_kp.shape[0]
    kc = min(int(k_cap), m)
    r2 = f32(f32(radius) * f32(radius))
    nmin = f32(neighbor_min)
    pos = torch.arange(kc, dtype=torch.float32, device=q.device)[None, :]
    rows = max(1, SEARCH_BUDGET // (SEARCH_ENTRY_BYTES * max(m, 1)))
    idxs, cands, enoughs = [], [], []
    for lo in range(0, n, rows):
        d2 = squared_distances(q[lo:lo + rows], ref_kp, fused=fused)
        cand_d2, idx = nearest(d2, kc)
        if knn_k is not None:
            cand = (pos < f32(knn_k)).expand(idx.shape[0], kc)
            enough = cand.sum(1) >= samples
        else:
            nr = (d2 < r2).sum(1)
            cand = torch.where((nr >= nmin)[:, None], cand_d2 < r2,
                               pos < nmin)
            enough = nr >= samples
        del d2
        idxs.append(idx.to(torch.int32))
        cands.append(cand)
        enoughs.append(enough)
    if not idxs:
        return (torch.zeros((0, kc), dtype=torch.int32, device=q.device),
                torch.zeros((0, kc), dtype=torch.bool, device=q.device),
                torch.zeros((0,), dtype=torch.bool, device=q.device))
    return torch.cat(idxs), torch.cat(cands), torch.cat(enoughs)


def feature_affine_2d_idx(ref_kp, tar_kp, xs, ys, idx, cand_mask, enough,
                          neighbor_min, error_threshold, draws, *,
                          trials: int, samples: int):
    """2D RANSAC on precomputed candidates: idx/cand_mask [N, kc], enough
    [N], draws [3, N, trials].  Returns (p6 [N, 6] u ux uy v vx vy,
    zncc_out, iteration, feature, ok)."""
    ctr = torch.stack([xs, ys], -1)
    idx = idx.long()
    rc = ref_kp[idx] - ctr[:, None]
    tc = tar_kp[idx] - ctr[:, None]
    n_cand = cand_mask.sum(1)
    return _ransac_core(rc, tc, cand_mask, n_cand, enough, neighbor_min,
                        error_threshold, draws, trials=trials,
                        samples=samples)


def feature_affine_3d_idx(ref_kp, tar_kp, xs, ys, zs, idx, cand_mask,
                          enough, neighbor_min, error_threshold, draws, *,
                          trials: int, samples: int):
    """RANSAC on precomputed candidates: idx/cand_mask [N, kc] (nearest
    keypoints and which of them count), enough [N].  Returns (p12 [N, 12],
    zncc_out, iteration, feature, ok)."""
    ctr = torch.stack([xs, ys, zs], -1)
    idx = idx.long()
    rc = ref_kp[idx] - ctr[:, None]
    tc = tar_kp[idx] - ctr[:, None]
    n_cand = cand_mask.sum(1)
    return _ransac_core(rc, tc, cand_mask, n_cand, enough, neighbor_min,
                        error_threshold, draws, trials=trials,
                        samples=samples)


def _trial_errs(rc, tc, aff):
    """Residual |ref * affine - tar| of every candidate: aff [N, T', D+1,
    D+1] -> [N, T', kc], D = 2 or 3."""
    dim = rc.shape[-1]
    e2 = None
    for d in range(dim):
        pd = rc[:, None, :, 0] * aff[..., 0, d, None]
        for i in range(1, dim):
            pd = pd + rc[:, None, :, i] * aff[..., i, d, None]
        dd = (pd + aff[..., dim, d, None]) - tc[:, None, :, d]
        e2 = dd * dd if e2 is None else e2 + dd * dd
    return torch.sqrt(e2)


def _ransac_core(rc, tc, cand_mask, n_cand, enough, neighbor_min,
                 error_threshold, draws, *, trials: int, samples: int):
    """rc/tc [N, kc, D] POI-centred candidate coordinates (D = 2 or 3),
    cand_mask [N, kc], n_cand [N], enough [N], draws [D+1, N, trials]:
    D+1 distinct candidates a trial."""
    dim = rc.shape[-1]
    fl = torch.float32
    n, kc = rc.shape[0], rc.shape[1]
    dev = rc.device
    u = draws.to(dev)
    nn = torch.clamp(n_cand.long(), min=samples)[:, None]
    j1 = u[0] % nn
    j2 = (j1 + 1 + u[1] % (nn - 1)) % nn
    lo = torch.minimum(j1, j2)
    hi = torch.maximum(j1, j2)
    j3 = u[2] % torch.clamp(nn - 2, min=1)
    j3 = torch.where(j3 >= lo, j3 + 1, j3)
    j3 = torch.where(j3 >= hi, j3 + 1, j3)
    picks = [j1, j2, j3]
    if dim == 3:  # a fourth distinct index
        s = torch.sort(torch.stack(picks, -1), -1).values
        j4 = u[3] % torch.clamp(nn - 3, min=1)
        for i in range(3):
            j4 = torch.where(j4 >= s[..., i], j4 + 1, j4)
        picks.append(j4)
    sample_idx = torch.stack(picks, -1)  # [N, T, D+1]

    rows = torch.arange(n, device=dev)[:, None, None]
    a_ref = rc[rows, sample_idx]  # [N, T, D+1, D]
    a_tar = tc[rows, sample_idx]
    ones = torch.ones(a_ref.shape[:-1] + (1,), dtype=fl, device=dev)
    affine = solve_small(torch.cat([a_ref, ones], -1),
                         torch.cat([a_tar, ones], -1))  # [N, T, D+1, D+1]

    thr = f32(error_threshold)
    err = _trial_errs(rc, tc, affine)
    inlier = (err < thr) & cand_mask[:, None, :]
    set_size = inlier.sum(2)
    err_sum = torch.where(inlier, err, torch.zeros((), device=dev)).sum(2)
    mean_err = err_sum / set_size  # NaN when empty, like the reference
    del err, inlier

    best_t = torch.argmax(set_size, 1)  # the first maximum, like > compare
    best_size = set_size.gather(1, best_t[:, None])[:, 0]
    best_aff = affine[torch.arange(n, device=dev), best_t][:, None]
    best_inlier = (_trial_errs(rc, tc, best_aff)[:, 0] < thr) & cand_mask

    # the recorded trial count of the do-while stopping rule
    # (oc_feature_affine.cpp:291-292)
    run_max = torch.cummax(set_size, 1).values
    nmin = f32(neighbor_min)
    stop_ok = (run_max >= nmin) & ~(mean_err > float(
        np.float32(thr) / np.float32(nmin)))
    any_stop = stop_ok.any(1)
    first = torch.argmax(stop_ok.to(torch.uint8), 1) + 1
    iteration = torch.where(any_stop, first, torch.full_like(first, trials)
                            ).to(fl)

    one = torch.ones((n, kc, 1), dtype=fl, device=dev)
    rch = torch.cat([rc, one], -1)
    aw = rch * best_inlier.to(fl)[..., None]
    ata = normal_product(aw, rch)
    atb = normal_product(aw, torch.cat([tc, one], -1))
    af = solve_small(ata, atb)  # [N, D+1, D+1]

    # per axis: the translation, then the gradient (the diagonal minus 1),
    # u ux uy (uz) v vx vy (vz) (w wx wy wz) (cpp:319-324, :536-548)
    p = torch.stack([af[:, i, d] - (1.0 if i == d else 0.0) if i < dim
                     else af[:, dim, d]
                     for d in range(dim) for i in [dim] + list(range(dim))],
                    -1)

    # 2D accepts any consensus of 3 (cpp:296-299), 3D one of ``samples``
    ok = enough & (best_size >= (3 if dim == 2 else samples))
    zero = torch.zeros((), dtype=fl, device=dev)
    zncc_out = torch.where(ok, zero, torch.where(
        enough, torch.full_like(zero, -2.0), torch.full_like(zero, -1.0)))
    p = torch.where(ok[:, None], p, zero)
    return p, zncc_out, iteration, best_size.to(fl), ok
