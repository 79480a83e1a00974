"""Plain DVC: FFTCC3D -> ICGN3D1 -> Strain on one volume pair.

The target is sampled with OpenCorr's tricubic B-spline
(oc_cubic_bspline.cpp, J. Yang et al., OLEN 136:106323, 2021): the volume
is prefiltered along x, then y, then z by the symmetric 15-tap filter
(taps oc_cubic_bspline.h) with edge clamping, and a sample at
(x, y, z) sums the cubic B-spline basis over the 4x4x4 coefficients
around it, -1 outside 1 <= x < X-2 (and y, z alike).  The sum is taken as
eight trilinear reads at shifted positions (each pair of basis weights
w0, w1 is one linear read at i - 1 + w1 / (w0 + w1), scaled by w0 + w1),
which is the same sum and reads 8 points a sample where the plain form
gathers 64.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import common
from .icgn import icgn1

PREFILTER = (1.732176555412860, -0.464135309171000, 0.124364681271139,
             -0.033323415913556, 0.008928982383084, -0.002392513618779,
             0.000641072092032, -0.000171774749350)
# cubic B-spline basis b_t(f) = sum_k _BASIS[k][t] f^k, t = 0..3 for the
# coefficients at i-1 .. i+2
_BASIS = np.array([[1.0, 4.0, 1.0, 0.0],
                   [-3.0, 0.0, 3.0, 0.0],
                   [3.0, -6.0, 3.0, 0.0],
                   [-1.0, 3.0, -3.0, 1.0]]) / 6.0


def prefilter(vol: torch.Tensor) -> torch.Tensor:
    """B-spline coefficients of ``vol`` [Z, Y, X]: the 15-tap filter along
    x, then y, then z, indices clamped at the edges."""
    out = vol
    for axis in (2, 1, 0):
        n = out.shape[axis]
        i = torch.arange(n, device=vol.device)
        acc = PREFILTER[0] * out
        for t in range(1, 8):
            acc = acc + PREFILTER[t] * (
                out.index_select(axis, torch.clamp(i - t, 0, n - 1))
                + out.index_select(axis, torch.clamp(i + t, 0, n - 1)))
        out = acc
    return out


def tricubic_sampler(coeff: torch.Tensor):
    """``sample([x, y, z]) -> values`` of the spline with coefficients
    ``coeff`` [Z, Y, X], -1 out of range."""
    dims = [coeff.shape[2], coeff.shape[1], coeff.shape[0]]  # x, y, z
    basis = torch.tensor(_BASIS, dtype=coeff.dtype, device=coeff.device)
    inp = coeff[None, None]

    def axis_reads(q):
        i = torch.floor(q)
        f = q - i
        w = torch.stack([torch.ones_like(f), f, f * f, f * f * f],
                        -1) @ basis
        g0 = w[..., 0] + w[..., 1]
        g1 = w[..., 2] + w[..., 3]
        return ((g0, i - 1.0 + w[..., 1] / g0), (g1, i + 1.0 + w[..., 3] / g1))

    def sample(coords):
        oob = torch.zeros_like(coords[0], dtype=torch.bool)
        for c, n in zip(coords, dims):
            oob |= (c < 1) | (c >= n - 2) | torch.isnan(c)
        reads = [axis_reads(torch.where(oob, torch.ones_like(c), c))
                 for c in coords]
        shape = coords[0].shape
        val = torch.zeros_like(coords[0])
        for gz, hz in reads[2]:
            for gy, hy in reads[1]:
                for gx, hx in reads[0]:
                    grid = torch.stack(
                        [2.0 * h / (n - 1) - 1.0
                         for h, n in ((hx, dims[0]), (hy, dims[1]),
                                      (hz, dims[2]))], -1)
                    lin = F.grid_sample(inp, grid.reshape(1, -1, 1, 1, 3),
                                        mode="bilinear", padding_mode="border",
                                        align_corners=True)
                    val = val + gz * gy * gx * lin.reshape(shape)
        return torch.where(oob, torch.full_like(val, -1.0), val)

    return sample


def grid_points(cfg) -> np.ndarray:
    """The POI grid [N, 3] (x, y, z), x fastest, then y, then z."""
    g = cfg["poi_grid"]
    (x0, y0, z0), step = g["origin"], g["step"]
    kk, ii, jj = np.meshgrid(np.arange(g["number_z"]),
                             np.arange(g["number_y"]),
                             np.arange(g["number_x"]), indexing="ij")
    return np.stack([(x0 + jj * step).reshape(-1),
                     (y0 + ii * step).reshape(-1),
                     (z0 + kk * step).reshape(-1)], -1).astype(np.float64)


def run(ref_u8: np.ndarray, tar_u8: np.ndarray, cfg: dict, device,
        dtype=torch.float64) -> dict:
    """The pair's results as host arrays: ``seed`` [N, 3] (FFTCC's u, v,
    w), ``p`` [N, 12] (u ux uy uz v vx vy vz w wx wy wz), ``zncc`` [N],
    ``iterations`` [N], ``closest`` [N] (the least |sample| of each POI's
    steps) and ``strain`` [N, 6] (exx, eyy, ezz, exy, eyz, ezx)."""
    ref = torch.as_tensor(ref_u8, device=device).to(dtype)
    tar = torch.as_tensor(tar_u8, device=device).to(dtype)
    pts = torch.as_tensor(grid_points(cfg), dtype=dtype, device=device)
    rf = cfg["fftcc"]["radius"]
    shift, zncc_f, valid = common.fftcc(
        ref, tar, pts.flip(1).long(), (rf, rf, rf), block=64)
    seed = shift.flip(1).to(dtype)
    zncc_in = torch.where(valid, zncc_f, torch.zeros_like(zncc_f))
    ic = cfg["icgn"]
    r = ic["radius"]
    grads = [common.gradient(ref, 2), common.gradient(ref, 1),
             common.gradient(ref, 0)]
    sampler = tricubic_sampler(prefilter(tar))
    del tar
    p, zncc, iters, closest = icgn1(
        ref, grads, sampler, pts, seed, zncc_in, (r, r, r), ic["conv"],
        ic["max_iter"], [1.0, 0.0, 0.0, 0.0] * 3, block=48)
    st = cfg["strain"]
    e = common.strain(pts, p[:, [0, 4, 8]], zncc, st["radius"],
                      st["neighbor_min"], st["zncc_min"], block=1024)
    return {k: v.cpu().numpy() for k, v in dict(
        seed=seed, p=p, zncc=zncc, iterations=iters, closest=closest,
        strain=e).items()}
