"""Batched inverse-compositional Levenberg-Marquardt (IC-LM) refinement.

Reference: ``oc_iclm.cpp``, the IC-GN skeleton with a damped Hessian
``(H + lambda I)^-1`` recomputed every iteration (:266).  The damping starts
at ``pow(lambda0, znssd / znssd0) - 1`` on the first iteration, znssd0 = 4
(:259-263); then each step is accepted (znssd < znssd0: lambda *= alpha, the
warp updated, znssd0 <- znssd) or rejected (lambda *= beta, the warp kept)
(:292-310).  Damping defaults (lambda, alpha, beta) = (100, 0.1, 10)
(oc_iclm.h:32-37).  Unlike IC-GN there is no out-of-range abort: the -1
sentinel of a sample off the image, or off its (r+margin) window in the
windowed eval, blends into the cost as in the reference.

The POI queue is the batch axis, as in ``ops/icgn.py``: every POI runs the
same iteration under a per-POI ``active`` mask, with per-POI (lambda,
znssd0), until none is active (one device sync an iteration).
"""

from __future__ import annotations

import collections
from typing import Optional, Sequence

import torch

from . import linalg as linalg_ops
from .gather2d import gather_windows_2d
from .icgn import (FIRST, _dp_weights, adaptive_subsets, dp_weights_per_poi,
                   entry_guard, finish, global_eval2d, hessian, icgn_guard,
                   iterate, local_grid, make_windowed_eval2d, sd_images,
                   subset_corners, warp_start, warped, zero_mean)


def _lm_loop(order, ev, hess, sd, ref_zm, rn, xs, ys, xl, yl, p_in, zncc_in,
             valid, dp_w, conv, max_iter, damping, count, layer, pmf=None,
             cnt=None):
    """The damped iteration and its codes (oc_iclm.cpp:225-340); ``pmf`` /
    ``cnt``: the self-adaptive pixel mask and counts; ``layer`` names the
    spans and host reads."""
    lam0, alpha, beta = (float(d) for d in damping)
    k = sd.shape[1]
    eye = torch.eye(k, dtype=hess.dtype, device=hess.device)
    wmat0, warp_from_p, p_from_warp = warp_start(order, p_in)

    def body(state):
        wmat, active, it, dpn, znssd_out, lam, znssd0 = state
        gxc, gyc = warped(order, wmat, xs, ys, xl, yl)
        tval = ev(gxc, gyc, active)
        tar_zm = zero_mean(tval, pmf, cnt)
        tn = torch.sqrt(torch.sum(tar_zm * tar_zm, dim=1))
        err = tar_zm * (rn / tn)[:, None] - ref_zm
        znssd = torch.sum(err * err, dim=1) / (rn * rn)

        # first-iteration damping (oc_iclm.cpp:259-263)
        lam = torch.where(it == 0, torch.pow(lam0, znssd / znssd0) - 1.0,
                          lam)
        hinv = linalg_ops.inv_small(hess + lam[:, None, None] * eye)
        num = torch.sum(sd * err[:, None, :], dim=2)
        dp = torch.bmm(hinv, num[:, :, None])[:, :, 0]
        wmat_acc = torch.bmm(wmat, linalg_ops.inv_small(warp_from_p(dp)))
        dpn_new = torch.sqrt(torch.sum(dp * dp * dp_w, dim=1))

        accept = znssd < znssd0
        lam_new = torch.where(accept, lam * alpha, lam * beta)
        znssd0_new = torch.where(accept, znssd, znssd0)
        wmat_new = torch.where(accept[:, None, None], wmat_acc, wmat)

        wmat = torch.where(active[:, None, None], wmat_new, wmat)
        lam = torch.where(active, lam_new, lam)
        znssd0 = torch.where(active, znssd0_new, znssd0)
        znssd_out = torch.where(active, znssd, znssd_out)
        dpn = torch.where(active, dpn_new, dpn)
        it = torch.where(active, it + 1.0, it)
        active = active & (dpn >= conv) & (it < max_iter)
        return wmat, active, it, dpn, znssd_out, lam, znssd0

    zf = torch.zeros_like(xs)
    wmat, _, it, dpn, znssd = iterate(
        body, (wmat0, valid, zf, zf, zf, zf, zf + 4.0), count, "iter_full",
        layer)[:5]
    p_out, zncc_out, computed = finish(
        p_from_warp(wmat), p_in, zncc_in, valid, torch.zeros_like(valid), it,
        dpn, znssd, conv, max_iter, icgn_guard(zncc_in),
        cols=FIRST if order == 1 else None)
    return p_out, p_in[:, 0], p_in[:, 6], zncc_out, it, dpn, computed


def iclm2d(gx: torch.Tensor, gy: torch.Tensor, ref_img: torch.Tensor,
           tar_lut: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
           p_in: torch.Tensor, zncc_in: torch.Tensor, conv: float,
           max_iter: float, damping: Sequence[float],
           tar_img: Optional[torch.Tensor] = None, *, order: int, rx: int,
           ry: int, window_margin: Optional[int] = None,
           stats: Optional[collections.Counter] = None,
           layer: str = "iclm"):
    """First- or second-order IC-LM over a POI queue; ``damping`` is
    (lambda, alpha, beta).  ``window_margin`` None evaluates the target
    through the global per-pixel LUT; an int M through per-POI windows of
    half-extent r+M around the seeded center and the lattice kernel
    (``ops/icgn.make_windowed_eval2d``).  ``stats`` counts the eval
    branches and iterations; ``layer``, the calling module's family, names
    the spans and host reads.  Returns (p_out [N,12], u0, v0, zncc,
    iteration, convergence, computed)."""
    if order not in (1, 2):
        raise ValueError(f"iclm2d: order must be 1 or 2, got {order}")
    h, w = ref_img.shape
    n = xs.shape[0]
    sh, sw = 2 * ry + 1, 2 * rx + 1
    s = sh * sw
    count = stats if stats is not None else collections.Counter()
    u_in, v_in = p_in[:, 0], p_in[:, 6]
    valid = entry_guard((xs, ys), (rx, ry), (u_in, v_in), zncc_in, (w, h))
    x0, y0 = subset_corners(xs, ys, rx, ry, h, w)
    cut = lambda img: gather_windows_2d(img, y0, x0, sh=sh,
                                        sw=sw).reshape(n, s)
    ref_zm = zero_mean(cut(ref_img))
    rn = torch.sqrt(torch.sum(ref_zm * ref_zm, dim=1))
    xl, yl = local_grid(rx, ry, ref_img.dtype, ref_img.device)
    sd = sd_images(cut(gx), cut(gy), xl, yl, order)
    ev = make_windowed_eval2d(tar_img, tar_lut, xs, ys, u_in, v_in, rx=rx,
                              ry=ry, margin=window_margin, stats=count,
                              layer=layer)
    dp_w = _dp_weights(order, rx, ry).to(ref_img.device)[None, :]
    return _lm_loop(order, ev, hessian(sd), sd, ref_zm, rn, xs, ys, xl, yl,
                    p_in, zncc_in, valid, dp_w, conv, max_iter, damping,
                    count, layer)


def iclm2d_adaptive(gx: torch.Tensor, gy: torch.Tensor,
                    ref_img: torch.Tensor, tar_lut: torch.Tensor,
                    xs: torch.Tensor, ys: torch.Tensor, srx: torch.Tensor,
                    sry: torch.Tensor, p_in: torch.Tensor,
                    zncc_in: torch.Tensor, conv: float, max_iter: float,
                    damping: Sequence[float], *, order: int, r_max: int,
                    stats: Optional[collections.Counter] = None,
                    layer: str = "iclm"):
    """Self-adaptive-subset IC-LM (oc_iclm.cpp:158-164, :510-516): the
    masked ``r_max`` grid of ``ops/icgn.icgn2d_adaptive`` on the damped
    iteration, every sample through the global LUT; ``layer`` as in
    :func:`iclm2d`."""
    h, w = ref_img.shape
    count = stats if stats is not None else collections.Counter()
    u_in, v_in = p_in[:, 0], p_in[:, 6]
    a = adaptive_subsets(gx, gy, ref_img, xs, ys, srx, sry, order=order,
                         r_max=r_max)
    valid = entry_guard((xs, ys), (a["rxf"], a["ryf"]), (u_in, v_in),
                        zncc_in, (w, h))
    dp_w = dp_weights_per_poi(order, a["rxf"], a["ryf"])
    return _lm_loop(order, global_eval2d(tar_lut), hessian(a["sd"]),
                    a["sd"], a["ref_zm"], a["rn"], xs, ys, a["xl"], a["yl"],
                    p_in, zncc_in, valid, dp_w, conv, max_iter, damping,
                    count, layer, pmf=a["pmf"], cnt=a["count"])
