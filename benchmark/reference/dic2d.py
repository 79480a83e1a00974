"""Plain 2D DIC: FFTCC2D -> ICGN2D1 -> Strain on one image pair.

The target is sampled with OpenCorr's bicubic B-spline
(oc_cubic_bspline.cpp, Z. Pan et al., TAML 6(3):126-130, 2016): at
(x, y) = (i + fx, j + fy) the value is sum_{n,m} wy_n wx_m I[j-1+n, i-1+m]
with w_t(f) = sum_k BC[3-k][t] f^k, and -1 outside 1 <= x < W-2,
1 <= y < H-2.  The 4x4 neighbourhood is read from the raw image for every
sample (no per-pixel table is kept).
"""

from __future__ import annotations

import numpy as np
import torch

from . import common
from .icgn import icgn1

# BC = B * C (oc_cubic_bspline.h), in units of 1/336
_BC = np.array([[-144.0, 384.0, -384.0, 144.0],
                [342.0, -702.0, 450.0, -90.0],
                [-198.0, -18.0, 270.0, -54.0],
                [0.0, 336.0, 0.0, 0.0]]) / 336.0


def bicubic_sampler(img: torch.Tensor):
    """``sample([x, y]) -> values`` of ``img`` [H, W] at float coordinates,
    -1 out of range."""
    h, w = img.shape
    powers_to_taps = torch.tensor(_BC[::-1].copy(), dtype=img.dtype,
                                  device=img.device)  # [k, t]
    flat = img.reshape(-1)
    rows = flat.as_strided((flat.numel() - 3, 4), (1, 1))

    def weights(f):
        pw = torch.stack([torch.ones_like(f), f, f * f, f * f * f], -1)
        return pw @ powers_to_taps

    def sample(coords):
        x, y = coords
        oob = ((x < 1) | (y < 1) | (x >= w - 2) | (y >= h - 2)
               | torch.isnan(x) | torch.isnan(y))
        xq = torch.where(oob, torch.ones_like(x), x)
        yq = torch.where(oob, torch.ones_like(y), y)
        xi = torch.floor(xq)
        yi = torch.floor(yq)
        wx = weights(xq - xi)
        wy = weights(yq - yi)
        base = (yi.long() - 1) * w + xi.long() - 1
        nb = torch.stack([rows[base + t * w] for t in range(4)], -2)
        val = torch.einsum("...a,...ab,...b->...", wy, nb, wx)
        return torch.where(oob, torch.full_like(val, -1.0), val)

    return sample


def grid_points(cfg) -> np.ndarray:
    """The POI grid [N, 2] (x, y), x fastest."""
    g = cfg["poi_grid"]
    (x0, y0), nx, ny, step = (g["upper_left"], g["number_x"], g["number_y"],
                              g["step"])
    jj, ii = np.meshgrid(np.arange(nx), np.arange(ny))
    return np.stack([(x0 + jj * step).reshape(-1),
                     (y0 + ii * step).reshape(-1)], -1).astype(np.float64)


def run(ref_u8: np.ndarray, tar_u8: np.ndarray, cfg: dict, device,
        dtype=torch.float64) -> dict:
    """The pair's results as host arrays: ``seed`` [N, 2] (FFTCC's u, v),
    ``p`` [N, 6] (u ux uy v vx vy), ``zncc`` [N], ``iterations`` [N],
    ``closest`` [N] (the least |sample| of each POI's steps) and ``strain``
    [N, 3] (exx, eyy, exy)."""
    ref = torch.as_tensor(ref_u8, device=device).to(dtype)
    tar = torch.as_tensor(tar_u8, device=device).to(dtype)
    pts = torch.as_tensor(grid_points(cfg), dtype=dtype, device=device)
    rf = cfg["fftcc"]["radius"]
    shift, zncc_f, valid = common.fftcc(
        ref, tar, pts.flip(1).long(), (rf, rf), block=8192)
    seed = shift.flip(1).to(dtype)
    zncc_in = torch.where(valid, zncc_f, torch.zeros_like(zncc_f))
    ic = cfg["icgn"]
    r = ic["radius"]
    grads = [common.gradient(ref, 1), common.gradient(ref, 0)]
    p, zncc, iters, closest = icgn1(
        ref, grads, bicubic_sampler(tar), pts, seed, zncc_in, (r, r),
        ic["conv"], ic["max_iter"], [1.0, r * r, r * r] * 2, block=4096)
    st = cfg["strain"]
    e = common.strain(pts, p[:, [0, 3]], zncc, st["radius"],
                      st["neighbor_min"], st["zncc_min"], block=512)
    return {k: v.cpu().numpy() for k, v in dict(
        seed=seed, p=p, zncc=zncc, iterations=iters, closest=closest,
        strain=e).items()}
