"""Batched forward-additive Newton-Raphson refinement, first order (the
classic method, kept for comparison).

Reference: ``oc_nr.cpp``.  ``prepare()`` builds B-spline LUTs of the
*target* image and of both its gradient maps (:119-158).  Each iteration
samples the warped target subset and its two gradients (three evals), builds
the Hessian from the *target* steepest-descent images (:214-243), forms the
error image ref * (tn / rn) - tar with ZNSSD over the target norm
(:246-249), and updates p <- p + dp (:276-277).  The entry guard's code is
-1 (:170), kept where the POI already carries a code below -1.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from . import linalg as linalg_ops
from .gather2d import gather_windows_2d
from .icgn import (FIRST, _dp_weights, entry_guard, finish, hessian, iterate,
                   local_grid, make_windowed_eval2d, sd_images,
                   subset_corners, zero_mean)


def nr_guard(zncc_in: torch.Tensor) -> torch.Tensor:
    """The code of a POI the entry guard rejects (oc_nr.cpp:170)."""
    return torch.where(zncc_in < -1.0, zncc_in, torch.full_like(zncc_in,
                                                                -1.0))


def nr2d1(ref_img: torch.Tensor, tar_lut: torch.Tensor,
          tar_lut_gx: torch.Tensor, tar_lut_gy: torch.Tensor,
          xs: torch.Tensor, ys: torch.Tensor, p_in: torch.Tensor,
          zncc_in: torch.Tensor, conv: float, max_iter: float,
          tar_img: Optional[torch.Tensor] = None,
          tar_gx_img: Optional[torch.Tensor] = None,
          tar_gy_img: Optional[torch.Tensor] = None, *, rx: int, ry: int,
          window_margin: Optional[int] = None,
          stats: Optional[collections.Counter] = None, layer: str = "nr"):
    """First-order NR over a POI queue.  ``window_margin`` None evaluates
    the target and its gradients through their global LUTs; an int M
    through three windowed evals (``ops/icgn.make_windowed_eval2d``), each
    on its own image and LUT.  ``layer``, the calling module's family,
    names the spans and host reads.  Returns (p_out [N,12], u0, v0, zncc,
    iteration, convergence, computed)."""
    h, w = ref_img.shape
    n = xs.shape[0]
    sh, sw = 2 * ry + 1, 2 * rx + 1
    count = stats if stats is not None else collections.Counter()
    u_in, v_in = p_in[:, 0], p_in[:, 6]
    valid = entry_guard((xs, ys), (rx, ry), (u_in, v_in), zncc_in, (w, h))
    x0, y0 = subset_corners(xs, ys, rx, ry, h, w)
    ref_zm = zero_mean(gather_windows_2d(ref_img, y0, x0, sh=sh,
                                         sw=sw).reshape(n, sh * sw))
    rn = torch.sqrt(torch.sum(ref_zm * ref_zm, dim=1))
    xl, yl = local_grid(rx, ry, ref_img.dtype, ref_img.device)
    dp_w = _dp_weights(1, rx, ry).to(ref_img.device)[None, :]

    evals = [make_windowed_eval2d(img, lut, xs, ys, u_in, v_in, rx=rx, ry=ry,
                                  margin=window_margin, stats=count,
                                  layer=layer)
             for img, lut in ((tar_img, tar_lut), (tar_gx_img, tar_lut_gx),
                              (tar_gy_img, tar_lut_gy))]

    def body(state):
        p6, active, it, dpn, znssd_out = state
        # forward warp of the local grid (oc_nr.cpp:200-212)
        u, ux, uy, v, vx, vy = (p6[:, i, None] for i in range(6))
        gxc = xs[:, None] + (1.0 + ux) * xl + uy * yl + u
        gyc = ys[:, None] + vx * xl + (1.0 + vy) * yl + v
        tval, tgx, tgy = (ev(gxc, gyc, active) for ev in evals)
        tar_zm = zero_mean(tval)
        tn = torch.sqrt(torch.sum(tar_zm * tar_zm, dim=1))
        sd = sd_images(tgx, tgy, xl, yl, 1)
        hinv = linalg_ops.inv_small(hessian(sd))
        # error image and ZNSSD over the target norm (oc_nr.cpp:246-249)
        err = ref_zm * (tn / rn)[:, None] - tar_zm
        znssd = torch.sum(err * err, dim=1) / (tn * tn)
        num = torch.sum(sd * err[:, None, :], dim=2)
        dp = torch.bmm(hinv, num[:, :, None])[:, :, 0]
        p6_new = p6 + dp  # forward-additive (oc_nr.cpp:276-277)
        dpn_new = torch.sqrt(torch.sum(dp * dp * dp_w, dim=1))

        p6 = torch.where(active[:, None], p6_new, p6)
        znssd_out = torch.where(active, znssd, znssd_out)
        dpn = torch.where(active, dpn_new, dpn)
        it = torch.where(active, it + 1.0, it)
        active = active & (dpn >= conv) & (it < max_iter)
        return p6, active, it, dpn, znssd_out

    zf = torch.zeros_like(xs)
    p6, _, it, dpn, znssd = iterate(
        body, (p_in[:, list(FIRST)], valid, zf, zf, zf), count, "iter_full",
        layer)
    p_out, zncc_out, computed = finish(
        p6, p_in, zncc_in, valid, torch.zeros_like(valid), it, dpn, znssd,
        conv, max_iter, nr_guard(zncc_in), cols=FIRST)
    return p_out, u_in, v_in, zncc_out, it, dpn, computed
