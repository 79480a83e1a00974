"""Batched 3D feature-affine RANSAC: a per-POI deformation guess from
matched keypoints (oc_feature_affine.cpp:347-560).

Per POI: the candidate keypoints (a host k-d tree, see
``models/feature_affine.py``), then ``trials`` RANSAC trials at once, each
fitting a 4x4 affine to 4 distinct random candidates and counting the
consensus set; the best set (the first maximum) gets a least-squares affine,
which gives the 12 first-order DVC parameters.  Failure codes -1 (too few
keypoints in reach) and -2 (inconsistent consensus).

The reference draws from std::mt19937_64 seeded by random_device, so no two
of its runs agree; the JAX package draws from jax.random, which PyTorch
cannot reproduce.  The trial draws are therefore an argument here: integer
draws [4, N, T] in [0, 2^30), which the module makes from a seeded
``torch.Generator`` and the tests take from the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.precision import f32
from .linalg import solve_small


def ransac_draws(seed: int, n: int, trials: int) -> torch.Tensor:
    """[4, n, trials] int64 draws in [0, 2^30) from a CPU generator seeded
    with ``seed``: the same numbers whatever device the RANSAC runs on."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, 1 << 30, (4, n, trials), generator=gen,
                         dtype=torch.int64)


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
    return _ransac_core_3d(rc, tc, cand_mask, n_cand, enough, neighbor_min,
                           error_threshold, draws, trials=trials,
                           samples=samples)


def _trial_errs(rc, tc, aff):
    """Residual |ref * affine - tar| of every candidate: aff [N, T', 4, 4]
    -> [N, T', kc]."""
    e2 = None
    for d in range(3):
        pd = (rc[:, None, :, 0] * aff[..., 0, d, None]
              + rc[:, None, :, 1] * aff[..., 1, d, None]
              + rc[:, None, :, 2] * aff[..., 2, d, None]
              + aff[..., 3, d, None])
        dd = pd - tc[:, None, :, d]
        e2 = dd * dd if e2 is None else e2 + dd * dd
    return torch.sqrt(e2)


def _normal_product(a, b):
    """sum_k a[n, k, i] * b[n, k, j] -> [N, I, J], each term added in k
    order as one fused multiply-add rounded to float32 (the order in which
    XLA computes the JAX package's small batched einsum on the CPU)."""
    acc = torch.zeros((a.shape[0], a.shape[2], b.shape[2]), dtype=a.dtype,
                      device=a.device)
    for k in range(a.shape[1]):
        acc = (a[:, k, :, None].double() * b[:, k, None, :].double()
               + acc.double()).to(a.dtype)
    return acc


def _ransac_core_3d(rc, tc, cand_mask, n_cand, enough, neighbor_min,
                    error_threshold, draws, *, trials: int, samples: int):
    """rc/tc [N, kc, 3] POI-centred candidate coordinates, cand_mask
    [N, kc], n_cand [N], enough [N], draws [4, N, trials]."""
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
    # a fourth distinct index
    s = torch.sort(torch.stack([j1, j2, j3], -1), -1).values
    j4 = u[3] % torch.clamp(nn - 3, min=1)
    for i in range(3):
        j4 = torch.where(j4 >= s[..., i], j4 + 1, j4)
    sample_idx = torch.stack([j1, j2, j3, j4], -1)  # [N, T, 4]

    rows = torch.arange(n, device=dev)[:, None, None]
    a_ref = rc[rows, sample_idx]  # [N, T, 4, 3]
    a_tar = tc[rows, sample_idx]
    ones = torch.ones(a_ref.shape[:-1] + (1,), dtype=fl, device=dev)
    affine = solve_small(torch.cat([a_ref, ones], -1),
                         torch.cat([a_tar, ones], -1))  # [N, T, 4, 4]

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
    ata = _normal_product(aw, rch)
    atb = _normal_product(aw, torch.cat([tc, one], -1))
    af = solve_small(ata, atb)  # [N, 4, 4]

    # u ux uy uz v vx vy vz w wx wy wz from the affine
    p12 = torch.stack([
        af[:, 3, 0], af[:, 0, 0] - 1.0, af[:, 1, 0], af[:, 2, 0],
        af[:, 3, 1], af[:, 0, 1], af[:, 1, 1] - 1.0, af[:, 2, 1],
        af[:, 3, 2], af[:, 0, 2], af[:, 1, 2], af[:, 2, 2] - 1.0], -1)

    ok = enough & (best_size >= samples)
    zero = torch.zeros((), dtype=fl, device=dev)
    zncc_out = torch.where(ok, zero, torch.where(
        enough, torch.full_like(zero, -2.0), torch.full_like(zero, -1.0)))
    p12 = torch.where(ok[:, None], p12, zero)
    return p12, zncc_out, iteration, best_size.to(fl), ok
