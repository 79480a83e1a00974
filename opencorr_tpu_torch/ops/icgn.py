"""Batched inverse-compositional Gauss-Newton (IC-GN) refinement: 2D first
and second order with the stereo center offsets (``icgn2d``), with
self-adaptive subsets (``icgn2d_adaptive``), and 3D first order
(``icgn3d1``, at the end).  The pieces the other refiners share (the
windowed eval, the entry guard, the steepest-descent images, the warp, the
host loop and the exit codes) live here too: ``ops/iclm.py`` and
``ops/nr.py`` use them.

Reference semantics: ``oc_icgn.cpp`` -- per POI: entry guard (bounds / NaN /
prior failure -> ZNCC -3, oc_icgn.cpp:160-167); reference subset and its
zero-mean norm (:174-176); steepest-descent images and Hessian from the
reference gradients (:179-207), inverted once (:210); then at most
``stop_condition`` iterations (:225-307): warp the local grid, sample the
target, reject the POI if any sample is out of range (-1 sentinel -> ZNCC
-3, :251-255), error image = tar*(rn/tn) - ref (:260), ZNSSD (:263),
dp = H^-1 (sd^T err) (:266-287), inverse-compositional update (:290),
convergence norm weighted by the subset radii (:296-306).  Exit codes -4
(not converged, :329-332) and -5 (NaN, :335-340).

The POI queue is the batch axis.  Every POI runs the same iteration under a
per-POI ``active`` mask; finished POIs freeze their state (:func:`gn_update`),
and the host loop (:func:`iterate`) ends when none is active, one device
sync per iteration.  Every window is cut by the gather kernel
(ops/gather2d.py) and every target sample is evaluated by the lattice
kernel (ops/lattice2d.py) through the windowed eval below.  The
self-adaptive refine, as the JAX package's, cuts plain subsets and samples
the global LUT.
"""

from __future__ import annotations

import collections
import functools
from typing import Optional

import torch

from ..utils import timing
from . import bspline, icgn3d_step, linalg as linalg_ops, warp as warp_ops
from .gather2d import gather_windows_2d, gather_windows_2d_plain
from .lattice2d import lattice_eval_2d
from .lattice3d import lattice_eval_3d

# Queue width above which the GN loop runs two-phase: full width until
# <= 1/4 of the POIs are active, then a compacted quarter-width tail.
_COMPACT_MIN = 4096

_I32 = torch.int32
_F32 = torch.float32


def compact_idx(mask: torch.Tensor, k: int):
    """Indices of the first k set bits of ``mask`` in scan order.

    Returns ``(gi, si, ok)``: ``gi`` [k] gather indices (clamped in-range
    duplicates on padding slots), ``si`` [k] scatter indices (= n on padding
    slots: scatter into an (n+1)-row buffer and drop the last row), ``ok``
    [k] bool."""
    n = mask.shape[0]
    cs = torch.cumsum(mask.to(_I32), 0, dtype=_I32)
    want = torch.arange(1, k + 1, dtype=_I32, device=mask.device)
    raw = torch.searchsorted(cs, want, side="left")
    ok = torch.arange(k, device=mask.device) < cs[-1]
    return (torch.clamp(raw, max=n - 1),
            torch.where(ok, raw, torch.full_like(raw, n)), ok)


def _put(full: torch.Tensor, si: torch.Tensor, vals: torch.Tensor
         ) -> torch.Tensor:
    """``full`` with rows ``si`` set to ``vals``; rows with si = n drop."""
    buf = torch.cat([full, full[:1]])
    buf[si] = vals
    return buf[:-1]


def make_windowed_eval2d_state(img, lut, cx, cy, u_seed, v_seed, *, rx, ry,
                               margin, stats: Optional[collections.Counter]
                               = None, layer: str = "icgn"):
    """Windowed-lattice interpolation for the iterative refiners.

    ``img``/``lut``: the image being sampled and its exact per-pixel LUT
    (the escalation fallback).  ``cx``/``cy``: per-POI subset centers;
    ``u_seed``/``v_seed``: the seeded displacement the windows center on.
    Returns ``(state, eval_fn)``: ``state`` is a dict of per-POI tensors
    (leading axis N) that callers may index-compact, and
    ``eval_fn(state, gxc, gyc, active) -> [N', S]`` evaluates with the -1
    out-of-range sentinel; samples leaving their (r+margin) window read as
    out of range.  ``stats``, when given, counts the branches taken.
    ``layer``: the calling refiner's family, which names the spans and host
    reads (``<layer>.eval``, ``.correct``, ``.exact``, ``.sync.wobble``,
    ``.sync.still``).
    """
    if img is None:
        raise ValueError(f"{layer}: the windowed eval needs the image it "
                         "samples")
    dev = img.device
    h, w = img.shape
    sh, sw = 2 * ry + 1, 2 * rx + 1
    s = sh * sw
    mx, my = rx + margin, ry + margin
    swx, swy = 2 * mx + 1, 2 * my + 1
    fcx = torch.floor(cx + u_seed).to(_I32)
    fcy = torch.floor(cy + v_seed).to(_I32)
    wcx = torch.clamp(fcx - mx, 0, w - swx)
    wcy = torch.clamp(fcy - my, 0, h - swy)
    # D=2 block on a FIXED base from the seeded center, gathered once per
    # compute; the [0, 2D] placement range absorbs ~2 px of solver drift
    # plus strain before the compacted correction takes over.
    D = 2
    pw = 1 + D
    wlat = 4 + 2 * D
    elx, ely = sw + wlat - 1, sh + wlat - 1
    iixf = torch.arange(sw, dtype=_I32, device=dev).repeat(sh)  # x fastest
    iiyf = torch.arange(sh, dtype=_I32, device=dev).repeat_interleave(sw)
    # Seed-centered base in padded-window coords; its bounds keep the
    # gather corner inside the image (clamp's max wins where they cross,
    # as jnp.clip does).
    seed_cx = fcx - wcx
    seed_cy = fcy - wcy
    bx0 = torch.clamp(seed_cx + pw - rx - 1 - D,
                      torch.clamp(pw - wcx, min=0),
                      torch.clamp(w - elx + pw - wcx, max=swx + 2 * pw - elx))
    by0 = torch.clamp(seed_cy + pw - ry - 1 - D,
                      torch.clamp(pw - wcy, min=0),
                      torch.clamp(h - ely + pw - wcy, max=swy + 2 * pw - ely))
    eblk = gather_windows_2d(img, wcy - pw + by0, wcx - pw + bx0, sh=ely,
                             sw=elx)
    state = dict(wcxf=wcx.to(_F32), wcyf=wcy.to(_F32), bx0=bx0, by0=by0,
                 eblk=eblk)
    # Correction-subset cap, sized at the FACTORY width: the compacted tail
    # concentrates the wobbled POIs, so a cap proportional to its width
    # would overflow onto the whole-chunk exact fallback.
    n0 = cx.shape[0]
    cap0 = min(n0, max(256, n0 // 32))
    D6 = 6
    w6 = 4 + 2 * D6
    e6x, e6y = sw + w6 - 1, sh + w6 - 1
    cidx = (sh // 2) * sw + sw // 2
    count = stats if stats is not None else collections.Counter()
    s_eval, s_correct, s_exact, s_wobble, s_still = (
        f"{layer}.{k}" for k in ("eval", "correct", "exact", "sync.wobble",
                                 "sync.still"))

    def _correct(val, gxc, gyc, oob, wob_poi, cap):
        """Re-centered D=6 lattice eval on a compacted subset of the wobbled
        POIs, with the exact LUT for the few samples D=6 cannot hold."""
        gi, si, okc = compact_idx(wob_poi, cap)
        oob_c = oob[gi]
        two = torch.full((), 2.0, dtype=_F32, device=dev)
        gxq = torch.where(oob_c, two, gxc[gi])
        gyq = torch.where(oob_c, two, gyc[gi])
        exg = torch.floor(gxq).to(_I32)
        eyg = torch.floor(gyq).to(_I32)
        fxg = gxq - exg.to(_F32)
        fyg = gyq - eyg.to(_F32)
        bx = torch.clamp(exg[:, cidx] - rx - 1 - D6, 0, w - e6x)
        by = torch.clamp(eyg[:, cidx] - ry - 1 - D6, 0, h - e6y)
        neg = torch.full((), -1, dtype=_I32, device=dev)
        pdx = torch.where(oob_c, neg, exg - 1 - bx[:, None] - iixf[None, :])
        pdy = torch.where(oob_c, neg, eyg - 1 - by[:, None] - iiyf[None, :])
        eblk6 = gather_windows_2d(img, by, bx, sh=e6y, sw=e6x)
        c = gi.shape[0]
        v6 = lattice_eval_2d(
            eblk6, pdy.reshape(c, sh, sw), pdx.reshape(c, sh, sw),
            fyg.reshape(c, sh, sw), fxg.reshape(c, sh, sw),
            d_wobble=D6).reshape(c, s)
        # padding slots (okc False) repeat a real POI and are dropped below
        still = torch.any(
            ((pdx < 0) | (pdx > 2 * D6) | (pdy < 0) | (pdy > 2 * D6))
            & ~oob_c, dim=1) & okc
        ns = timing.host_read(s_still, still.sum(), int)
        caps = min(cap, 64)
        if ns > caps:
            count["exact_all"] += 1
            with timing.span(s_exact):
                tv, _ = bspline.bicubic_eval(lut, gxq, gyq)
                v6 = torch.where(still[:, None], tv, v6)
        elif ns > 0:
            count["exact"] += 1
            with timing.span(s_exact):
                gj, sj, _okj = compact_idx(still, caps)
                tv, _ = bspline.bicubic_eval(lut, gxq[gj], gyq[gj])
                v6 = _put(v6, sj, tv)
        v6 = torch.where(oob_c, torch.full_like(v6, -1.0), v6)
        return _put(val, si, v6)

    def eval_fn(st, gxc, gyc, active):
        with timing.span(s_eval):
            n = gxc.shape[0]
            cap = min(n, cap0)
            wcxf = st["wcxf"][:, None]
            wcyf = st["wcyf"][:, None]
            # global range guard: the exact float comparisons of the LUT path
            oob_g = ((gxc < 1) | (gyc < 1) | (gxc >= w - 2) | (gyc >= h - 2)
                     | torch.isnan(gxc) | torch.isnan(gyc))
            two = torch.full((), 2.0, dtype=_F32, device=dev)
            lx = torch.where(oob_g, two, gxc - wcxf)
            ly = torch.where(oob_g, two, gyc - wcyf)
            exf = torch.floor(lx.clamp(-9.0, swx + 9.0)).to(_I32)
            eyf = torch.floor(ly.clamp(-9.0, swy + 9.0)).to(_I32)
            oob = (oob_g | (exf < 1) | (exf > swx - 3)
                   | (eyf < 1) | (eyf > swy - 3))
            fxf = lx - exf.to(_F32)
            fyf = ly - eyf.to(_F32)
            neg = torch.full((), -1, dtype=_I32, device=dev)
            pdx = torch.where(
                oob, neg, exf + pw - 1 - st["bx0"][:, None] - iixf[None, :])
            pdy = torch.where(
                oob, neg, eyf + pw - 1 - st["by0"][:, None] - iiyf[None, :])
            doomed = torch.any(oob, dim=1)
            # only active POIs need exact values: a frozen POI's values are
            # discarded by the step mask
            wobble = (((pdx < 0) | (pdx > 2 * D) | (pdy < 0) | (pdy > 2 * D))
                      & ~oob & (~doomed & active)[:, None])
            wob_poi = torch.any(wobble, dim=1)
            n_wob = timing.host_read(s_wobble, wob_poi.sum(), int)

            val = lattice_eval_2d(
                st["eblk"], pdy.reshape(n, sh, sw), pdx.reshape(n, sh, sw),
                fyf.reshape(n, sh, sw), fxf.reshape(n, sh, sw), d_wobble=D)
            val = torch.where(oob, torch.full((), -1.0, dtype=_F32,
                                              device=dev), val.reshape(n, s))
            if n_wob > cap:
                # more wobbled POIs than the cap: exact eval of the whole
                # chunk
                count["full"] += 1
                with timing.span(s_exact):
                    tval, _ = bspline.bicubic_eval(lut, gxc, gyc)
                    return torch.where(oob, torch.full_like(tval, -1.0),
                                       tval)
            if n_wob > 0:
                count["correct"] += 1
                with timing.span(s_correct):
                    return _correct(val, gxc, gyc, oob, wob_poi, cap)
            return val

    return state, eval_fn


def make_windowed_eval2d(img, lut, cx, cy, u_seed, v_seed, *, rx, ry, margin,
                         stats: Optional[collections.Counter] = None,
                         layer: str = "icgn"):
    """Closure form of :func:`make_windowed_eval2d_state` for the refiners
    that never compact their queue (ICLM, NR): ``eval_fn(gxc, gyc, active)
    -> [N, S]``; ``margin`` None samples the global per-pixel LUT
    (:func:`global_eval2d`)."""
    if margin is None:
        return global_eval2d(lut)
    st, fn = make_windowed_eval2d_state(img, lut, cx, cy, u_seed, v_seed,
                                        rx=rx, ry=ry, margin=margin,
                                        stats=stats, layer=layer)
    return lambda gxc, gyc, active: fn(st, gxc, gyc, active)


def global_eval2d(lut):
    """``eval_fn(gxc, gyc, active) -> [N, S]`` through the global per-pixel
    LUT, -1 out of range."""
    return lambda gxc, gyc, active: bspline.bicubic_eval(lut, gxc, gyc)[0]


def gather_subsets_2d(img: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                      rx: int, ry: int) -> torch.Tensor:
    """[N] corners -> [N, 2ry+1, 2rx+1] windows by plain indexing, as the
    JAX package's vmapped slice: the self-adaptive refiners' subsets, on
    which the JAX package runs no kernel either."""
    return gather_windows_2d_plain(img, y0, x0, sh=2 * ry + 1, sw=2 * rx + 1)


def _dp_weights(order: int, rx: int, ry: int) -> torch.Tensor:
    """Convergence-norm weights (oc_icgn.cpp:296-306, :836-856).  The
    reference computes the second order's r^4 weights as ints truncated from
    r^4/4 (oc_icgn.cpp:840-841), reproduced exactly."""
    rx2, ry2 = float(rx * rx), float(ry * ry)
    if order == 1:
        w = [1.0, rx2, ry2, 1.0, rx2, ry2]
    else:
        rx4 = float(int(rx * rx * rx * rx * 0.25))
        ry4 = float(int(ry * ry * ry * ry * 0.25))
        w = [1.0, rx2, ry2, rx4, rx2 * ry2, ry4] * 2
    return torch.tensor(w, dtype=_F32)


def dp_weights_per_poi(order: int, rxf: torch.Tensor,
                       ryf: torch.Tensor) -> torch.Tensor:
    """:func:`_dp_weights` for per-POI radii [N] -> [N, K], in float32 as
    the JAX package computes them (r^4/4 truncated)."""
    rx2 = rxf * rxf
    ry2 = ryf * ryf
    one = torch.ones_like(rx2)
    if order == 1:
        return torch.stack([one, rx2, ry2, one, rx2, ry2], -1)
    rx4 = torch.trunc(rx2 * rx2 * 0.25)
    ry4 = torch.trunc(ry2 * ry2 * 0.25)
    rxy2 = rx2 * ry2
    return torch.stack([one, rx2, ry2, rx4, rxy2, ry4] * 2, -1)


def entry_guard(centers, radii, seeds, zncc_in, sides) -> torch.Tensor:
    """The entry guard (oc_icgn.cpp:160-167, :1279): the subset inside
    the image or volume, a finite seed smaller than it, no earlier
    failure.  Per axis, x first: ``centers`` [N], ``radii`` (ints or
    per-POI radii), ``seeds`` (u, v[, w]) and ``sides`` (w, h[, d])."""
    ok = zncc_in >= 0
    for c, r, u, side in zip(centers, radii, seeds, sides):
        ok = (ok & (c - r >= 0) & (c + r <= side - 1) & (u.abs() < side)
              & ~torch.isnan(u))
    return ok


def subset_corners(xs, ys, rx: int, ry: int, h: int, w: int):
    """Top-left corners (x0, y0) of each POI's subset, from the C-style
    truncation (int)poi->x, clamped into the image."""
    return (torch.clamp(xs.to(_I32) - rx, 0, w - (2 * rx + 1)),
            torch.clamp(ys.to(_I32) - ry, 0, h - (2 * ry + 1)))


def local_grid(rx: int, ry: int, dtype, device):
    """[1, S] local x and y of a (2ry+1) x (2rx+1) subset, x fastest
    (row-major, as the reference's loops)."""
    sh, sw = 2 * ry + 1, 2 * rx + 1
    xl = (torch.arange(sw, dtype=dtype, device=device) - rx).repeat(sh)
    yl = (torch.arange(sh, dtype=dtype, device=device)
          - ry).repeat_interleave(sw)
    return xl[None, :], yl[None, :]


def zero_mean(vals: torch.Tensor, pmf: Optional[torch.Tensor] = None,
              count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Subset values [N, S] less their mean (oc_subset.cpp:39-53).  With a
    pixel mask ``pmf`` [N, S] (self-adaptive subsets) the mean is taken
    over the ``count`` masked pixels and the others are zeroed, so they add
    nothing to any sum."""
    if pmf is None:
        return vals - vals.mean(dim=1, keepdim=True)
    return (vals - (torch.sum(vals * pmf, dim=1) / count)[:, None]) * pmf


def sd_images(gxs: torch.Tensor, gys: torch.Tensor, xl, yl,
              order: int) -> torch.Tensor:
    """Steepest-descent images [N, K, S] (oc_icgn.cpp:179-207, :719-759):
    each gradient times each shape-function monomial, (gx * m..., gy *
    m...), each product rounded as the JAX package rounds it."""
    if order == 1:
        monos = (None, xl, yl)
    else:
        monos = (None, xl, yl, xl * xl * 0.5, xl * yl, yl * yl * 0.5)
    return torch.stack([g if m is None else g * m for g in (gxs, gys)
                        for m in monos], dim=1)


def hessian(sd: torch.Tensor) -> torch.Tensor:
    """[N, K, K] sums of sd channel products over the subset, one plain
    reduction an entry."""
    n, k_ch = sd.shape[:2]
    hess = torch.empty((n, k_ch, k_ch), dtype=sd.dtype, device=sd.device)
    for i in range(k_ch):
        for j in range(i, k_ch):  # (a*b) == (b*a) exactly: mirror the rest
            hess[:, i, j] = torch.sum(sd[:, i] * sd[:, j], dim=1)
            hess[:, j, i] = hess[:, i, j]
    return hess


# u ux uy v vx vy: the first-order columns of the 12-dof 2D rows
FIRST = (0, 1, 2, 6, 7, 8)


def warp_start(order: int, p_in: torch.Tensor):
    """(initial warp matrices, warp_from_p, p_from_warp).  The guess is
    always the first-order part of ``p_in`` (oc_icgn.cpp:216, :765)."""
    first = list(FIRST)
    if order == 1:
        return (warp_ops.warp2d1_from_p(p_in[:, first]),
                warp_ops.warp2d1_from_p, warp_ops.p_from_warp2d1)
    p12 = torch.zeros_like(p_in)
    p12[:, first] = p_in[:, first]
    return (warp_ops.warp2d2_from_p(p12), warp_ops.warp2d2_from_p,
            warp_ops.p_from_warp2d2)


def warped(order: int, wmat, tcx, tcy, xl, yl):
    """Target coordinates of the warped local grid about the centers
    (tcx, tcy) (oc_deformation.cpp:94-105, :268-282)."""
    if order == 1:
        rows, basis = wmat[:, :2], (xl, yl)
    else:
        rows, basis = wmat[:, 3:5], (xl * xl, xl * yl, yl * yl, xl, yl)
    out = []
    for r, ctr in enumerate((tcx, tcy)):
        acc = rows[:, r, len(basis)][:, None]
        for c, b in enumerate(basis):
            acc = acc + rows[:, r, c][:, None] * b
        out.append(ctr[:, None] + acc)
    return out


def icgn_guard(zncc_in: torch.Tensor) -> torch.Tensor:
    """The code of a POI the entry guard rejects (oc_icgn.cpp:165): -3,
    or its earlier failure code."""
    return torch.where(zncc_in >= 0, torch.full_like(zncc_in, -3.0),
                       zncc_in)


def finish(p_new, p_in, zncc_in, valid, oob_fail, it, dpn, znssd,
           conv: float, max_iter: float, zncc_guard, *, disp=(0, 6),
           cols=None):
    """Codes and merged rows of a finished refinement, 2D or 3D.

    ``p_new`` holds the columns ``cols`` of ``p_in``'s rows: [N, 6] u ux uy
    v vx vy of a 2D row (``FIRST``), or all of them (None: 2D second order
    [N, 12], 3D [N, 12]); it is the caller's own tensor, restored in place.
    ZNCC from ZNSSD, -4 where the last step still exceeded ``conv`` at
    ``max_iter`` (oc_icgn.cpp:329-332), -5 on NaN with the displacements
    restored to the guess (:335-340; ``disp``, columns of ``p_in``: u, v
    in 2D, u, v, w in 3D), -3 where a sample fell out of range,
    ``zncc_guard`` where the entry guard failed.  Returns (p_out [N, 12],
    zncc_out, computed)."""
    computed = valid & ~oob_fail
    zncc = 0.5 * (2.0 - znssd)
    zncc = torch.where((dpn >= conv) & (it >= max_iter),
                       torch.full_like(zncc, -4.0), zncc)
    at = [c if cols is None else cols.index(c) for c in disp]
    isnan = torch.isnan(zncc)
    for c in at:
        isnan = isnan | torch.isnan(p_new[:, c])
    zncc = torch.where(isnan, torch.full_like(zncc, -5.0), zncc)
    for c, orig in zip(at, disp):
        p_new[:, c] = torch.where(isnan, p_in[:, orig], p_new[:, c])
    if cols is None:
        p_out = torch.where(computed[:, None], p_new, p_in)
    else:
        p_out = p_in.clone()
        for src, dst in enumerate(cols):
            p_out[:, dst] = torch.where(computed, p_new[:, src], p_in[:, dst])
    zncc_out = torch.where(
        valid, torch.where(oob_fail, torch.full_like(zncc, -3.0), zncc),
        zncc_guard)
    return p_out, zncc_out, computed


def iterate(body, state, count: collections.Counter, key: str, layer: str,
            above: Optional[int] = None):
    """The refiners' host loop: ``state = body(state)`` while the active
    mask ``state[1]`` holds any POI or, with ``above``, more than ``above``
    POIs.  Each check is one host read ``<layer>.sync.active`` (a bool, or
    the int count), each iteration adds 1 to ``count[key]`` and runs in the
    span ``<layer>.iter``.  Returns the last state."""
    site, span = f"{layer}.sync.active", f"{layer}.iter"
    while (timing.host_read(site, state[1].any(), bool) if above is None
           else timing.host_read(site, state[1].sum(), int) > above):
        count[key] += 1
        with timing.span(span):
            state = body(state)
    return state


def gn_state(wmat0: torch.Tensor, valid: torch.Tensor, xs: torch.Tensor):
    """The Gauss-Newton loop's state at the start: (warp, active,
    iteration, convergence norm, ZNSSD, out-of-range failure), every POI
    that passed the entry guard active, the counters zero in ``xs``'s
    dtype."""
    zf = torch.zeros_like(xs)
    return wmat0, valid, zf, zf, zf, torch.zeros_like(valid)


def gn_update(state, fail, wmat_new, znssd_new, dpn_new, conv: float,
              max_iter: float):
    """The masked Gauss-Newton update of 2D and 3D IC-GN: an active POI
    with an out-of-range sample (``fail``) stops with its failure marked;
    the other active POIs take the new warp, ZNSSD and norm and count the
    iteration; a POI stays active while its norm is at least ``conv`` and
    its count below ``max_iter`` (oc_icgn.cpp:296-307).  Finished POIs
    keep their state."""
    wmat, active, it, dpn, znssd, oob_fail = state
    fail_now = fail & active
    step = active & ~fail_now
    wmat = torch.where(step[:, None, None], wmat_new, wmat)
    znssd = torch.where(step, znssd_new, znssd)
    dpn = torch.where(step, dpn_new, dpn)
    it = torch.where(step, it + 1.0, it)
    oob_fail = oob_fail | fail_now
    active = step & (dpn >= conv) & (it < max_iter)
    return wmat, active, it, dpn, znssd, oob_fail


def gn_body2d(order: int, ev_fn, warp_from_p, dp_w: torch.Tensor,
              conv: float, max_iter: float, pmask=None, pmf=None, cnt=None):
    """One 2D IC-GN iteration (oc_icgn.cpp:225-307) as ``body(cc, state) ->
    state``.  ``cc``: the per-POI constants, which the compacted tail
    gathers (target centers ``tcx``/``tcy``, local grid ``xl``/``yl``,
    ``sd`` images, ``ref_zm``, ``rn``, ``hinv`` and the eval's state
    ``ev``); ``ev_fn(cc["ev"], gxc, gyc, active) -> [N, S]`` samples the
    target, -1 out of range; ``dp_w``: the convergence weights, [1, K] or
    per POI [N, K].  ``pmask``/``pmf``/``cnt``: a self-adaptive subset's
    pixel mask (bool, float) and pixel counts, which confine the range
    check and the means to its own pixels; None is the fixed subset."""

    def body(cc, state):
        wmat, active = state[:2]
        rn = cc["rn"]
        gx_c, gy_c = warped(order, wmat, cc["tcx"], cc["tcy"], cc["xl"],
                            cc["yl"])
        tval = ev_fn(cc["ev"], gx_c, gy_c, active)

        # Out-of-range detection, -1 sentinel (oc_icgn.cpp:244-255).
        neg = tval < 0.0
        fail = torch.any(neg if pmask is None else neg & pmask, dim=1)

        tar_zm = zero_mean(tval, pmf, cnt)
        tn = torch.sqrt(torch.sum(tar_zm * tar_zm, dim=1))
        err = tar_zm * (rn / tn)[:, None] - cc["ref_zm"]
        znssd_new = torch.sum(err * err, dim=1) / (rn * rn)
        num = torch.sum(cc["sd"] * err[:, None, :], dim=2)  # [N, K]
        dp = torch.bmm(cc["hinv"], num[:, :, None])[:, :, 0]
        wmat_new = torch.bmm(wmat, linalg_ops.inv_small(warp_from_p(dp)))
        dpn_new = torch.sqrt(torch.sum(dp * dp * dp_w, dim=1))
        return gn_update(state, fail, wmat_new, znssd_new, dpn_new, conv,
                         max_iter)

    return body


def lut_eval2d(lut: torch.Tensor, span: str):
    """``ev_fn`` of :func:`gn_body2d` through the global per-pixel LUT, -1
    out of range, in the span ``span``."""

    def ev_fn(st, gxc, gyc, active):
        with timing.span(span):
            return bspline.bicubic_eval(lut, gxc, gyc)[0]

    return ev_fn


def icgn2d(gx: torch.Tensor, gy: torch.Tensor, ref_img: torch.Tensor,
           tar_lut: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
           p_in: torch.Tensor, zncc_in: torch.Tensor, conv: float,
           max_iter: float, tar_img: Optional[torch.Tensor] = None, *,
           order: int = 1, rx: int, ry: int,
           center_offset: Optional[torch.Tensor] = None,
           window_margin: Optional[int] = None,
           stats: Optional[collections.Counter] = None,
           layer: str = "icgn"):
    """First- or second-order IC-GN over a POI queue.

    Returns (p_out [N,12], u0, v0, zncc, iteration, convergence, computed).
    ``center_offset`` [N, 2] (the stereo overload, oc_icgn.cpp:353-560)
    moves each target subset's center to (x + ox, y + oy) and offsets the
    local coordinates of the steepest-descent images by (-ox, -oy); None
    is the plain path.  ``window_margin`` None evaluates every sample
    through the global per-pixel LUT; an int M uses per-POI target windows
    of half-extent r+M around the seeded target center and the lattice
    kernel, where a sample leaving its window reads as out of range (-3).
    ``stats``, when given, counts the eval branches and loop phases
    taken; ``layer``, the calling module's family, names the spans and host
    reads (``<layer>.iter``, ``<layer>.sync.active``, ...).  It computes
    in the images' dtype: float32 as the package runs it, float64 for a
    reference replay on the CPU (with the global LUT)."""
    if order not in (1, 2):
        raise ValueError(f"icgn2d: order must be 1 or 2, got {order}")
    dev = ref_img.device
    fdt = ref_img.dtype
    h, w = ref_img.shape
    n = xs.shape[0]
    sh, sw = 2 * ry + 1, 2 * rx + 1
    s = sh * sw
    count = stats if stats is not None else collections.Counter()

    u_in = p_in[:, 0]
    v_in = p_in[:, 6]
    with timing.span(f"{layer}.setup"):
        valid = entry_guard((xs, ys), (rx, ry), (u_in, v_in), zncc_in,
                            (w, h))
        x0, y0 = subset_corners(xs, ys, rx, ry, h, w)

        # Reference subset, zero-mean norm.
        ref_sub = gather_windows_2d(ref_img, y0, x0, sh=sh,
                                    sw=sw).reshape(n, s)
        ref_zm = zero_mean(ref_sub)
        rn = torch.sqrt(torch.sum(ref_zm * ref_zm, dim=1))

        # Local grid, offset by the center offsets for the sd images and the
        # warp (oc_icgn.cpp:400-408).
        xl, yl = local_grid(rx, ry, fdt, dev)
        if center_offset is None:
            xl = xl.expand(n, s)
            yl = yl.expand(n, s)
            tcx, tcy = xs, ys
        else:
            ox, oy = center_offset[:, 0], center_offset[:, 1]
            xl = xl - ox[:, None]
            yl = yl - oy[:, None]
            tcx, tcy = xs + ox, ys + oy  # target center (oc_icgn.cpp:425-426)

        # Steepest-descent images and Hessian (oc_icgn.cpp:179-210).  The sd
        # channels are gradient * monomial products, so the Hessian and the
        # per-iteration numerator are plain weighted reductions over [N, S].
        gxs = gather_windows_2d(gx, y0, x0, sh=sh, sw=sw).reshape(n, s)
        gys = gather_windows_2d(gy, y0, x0, sh=sh, sw=sw).reshape(n, s)
        sd = sd_images(gxs, gys, xl, yl, order)  # [N, K, S]
        hinv = linalg_ops.inv_small(hessian(sd))
        wmat0, warp_from_p, p_from_warp = warp_start(order, p_in)

        if window_margin is None:
            ev_state, ev_fn = {}, lut_eval2d(tar_lut, f"{layer}.eval")
        else:
            ev_state, ev_fn = make_windowed_eval2d_state(
                tar_img, tar_lut, tcx, tcy, u_in, v_in, rx=rx, ry=ry,
                margin=window_margin, stats=count, layer=layer)

        dp_w = _dp_weights(order, rx, ry).to(device=dev, dtype=fdt)[None, :]

        # Per-POI loop constants: the two-phase compaction gathers a shrunken
        # copy of everything the GN body reads.
        cc = dict(tcx=tcx, tcy=tcy, xl=xl, yl=yl, sd=sd, ref_zm=ref_zm, rn=rn,
                  hinv=hinv, ev=ev_state)

    body = gn_body2d(order, ev_fn, warp_from_p, dp_w, conv, max_iter)
    state = gn_state(wmat0, valid, xs)
    if n >= _COMPACT_MIN:
        # Phase 1 at full width until <= n/4 POIs remain active; phase 2
        # runs the same body on a gather-compacted quarter-width state
        # (each POI's math is independent and unchanged).
        m = -(-n // 4)
        state = iterate(functools.partial(body, cc), state, count,
                        "iter_full", layer, above=m)
        with timing.span(f"{layer}.compact"):
            wmat, active1, it, dpn, znssd, oob_fail = state
            gi, si, okc = compact_idx(active1, m)
            cc_s = {k: ({kk: vv[gi] for kk, vv in v.items()}
                        if isinstance(v, dict) else v[gi])
                    for k, v in cc.items()}
            sub = (wmat[gi], active1[gi] & okc, it[gi], dpn[gi], znssd[gi],
                   oob_fail[gi])
        sub = iterate(functools.partial(body, cc_s), sub, count,
                      "iter_compact", layer)
        with timing.span(f"{layer}.compact"):
            wmat = _put(wmat, si, sub[0])
            it = _put(it, si, sub[2])
            dpn = _put(dpn, si, sub[3])
            znssd = _put(znssd, si, sub[4])
            oob_fail = _put(oob_fail, si, sub[5])
    else:
        wmat, _, it, dpn, znssd, oob_fail = iterate(
            functools.partial(body, cc), state, count, "iter_full", layer)

    with timing.span(f"{layer}.finish"):
        p_out, zncc_out, computed = finish(
            p_from_warp(wmat), p_in, zncc_in, valid, oob_fail, it, dpn,
            znssd, conv, max_iter, icgn_guard(zncc_in),
            cols=FIRST if order == 1 else None)
    return p_out, u_in, v_in, zncc_out, it, dpn, computed


def adaptive_subsets(gx, gy, ref_img, xs, ys, srx, sry, *, order: int,
                     r_max: int):
    """The self-adaptive refiners' reference side: every POI on the static
    ``r_max`` grid with a pixel mask of its own radii (clamped to r_max).
    Masked pixels add nothing to any sum, and the masked mean and count
    reproduce the smaller subset.  Returns a dict of rxf, ryf, pmask, pmf,
    count, ref_zm, rn, xl, yl and sd."""
    h, w = ref_img.shape
    n = xs.shape[0]
    s = (2 * r_max + 1) ** 2
    rxf = torch.clamp(srx, max=float(r_max))
    ryf = torch.clamp(sry, max=float(r_max))
    x0, y0 = subset_corners(xs, ys, r_max, r_max, h, w)
    xl, yl = local_grid(r_max, r_max, ref_img.dtype, ref_img.device)
    pmask = (xl.abs() <= rxf[:, None]) & (yl.abs() <= ryf[:, None])
    pmf = pmask.to(ref_img.dtype)
    cnt = torch.sum(pmf, dim=1)
    cut = lambda img: gather_subsets_2d(img, x0, y0, r_max,
                                        r_max).reshape(n, s)
    ref_zm = zero_mean(cut(ref_img), pmf, cnt)
    rn = torch.sqrt(torch.sum(ref_zm * ref_zm, dim=1))
    sd = sd_images(cut(gx) * pmf, cut(gy) * pmf, xl, yl, order)
    return dict(rxf=rxf, ryf=ryf, pmask=pmask, pmf=pmf, count=cnt,
                ref_zm=ref_zm, rn=rn, xl=xl, yl=yl, sd=sd)


def icgn2d_adaptive(gx: torch.Tensor, gy: torch.Tensor,
                    ref_img: torch.Tensor, tar_lut: torch.Tensor,
                    xs: torch.Tensor, ys: torch.Tensor, srx: torch.Tensor,
                    sry: torch.Tensor, p_in: torch.Tensor,
                    zncc_in: torch.Tensor, conv: float, max_iter: float, *,
                    order: int, r_max: int,
                    stats: Optional[collections.Counter] = None,
                    layer: str = "icgn"):
    """Self-adaptive-subset IC-GN (oc_icgn.cpp:152-158): per-POI subset
    radii ``srx``/``sry`` [N] on the static ``r_max`` grid
    (:func:`adaptive_subsets`), every sample through the global LUT (the
    span ``<layer>.lut_eval``), :func:`icgn2d`'s iteration on the masked
    subsets; ``layer`` names the spans and host reads, as in
    :func:`icgn2d`, and ``stats`` counts the iterations as
    ``iter_adaptive``.
    Returns (p_out, u0, v0, zncc, iteration, convergence, computed)."""
    h, w = ref_img.shape
    count = stats if stats is not None else collections.Counter()
    u_in, v_in = p_in[:, 0], p_in[:, 6]
    a = adaptive_subsets(gx, gy, ref_img, xs, ys, srx, sry, order=order,
                         r_max=r_max)
    valid = entry_guard((xs, ys), (a["rxf"], a["ryf"]), (u_in, v_in),
                        zncc_in, (w, h))
    hinv = linalg_ops.inv_small(hessian(a["sd"]))
    wmat0, warp_from_p, p_from_warp = warp_start(order, p_in)
    body = gn_body2d(order, lut_eval2d(tar_lut, f"{layer}.lut_eval"),
                     warp_from_p, dp_weights_per_poi(order, a["rxf"],
                                                     a["ryf"]),
                     conv, max_iter, a["pmask"], a["pmf"], a["count"])
    cc = dict(tcx=xs, tcy=ys, xl=a["xl"], yl=a["yl"], sd=a["sd"],
              ref_zm=a["ref_zm"], rn=a["rn"], hinv=hinv, ev={})
    wmat, _, it, dpn, znssd, oob_fail = iterate(
        functools.partial(body, cc), gn_state(wmat0, valid, xs), count,
        "iter_adaptive", layer)
    p_out, zncc_out, computed = finish(
        p_from_warp(wmat), p_in, zncc_in, valid, oob_fail, it, dpn, znssd,
        conv, max_iter, icgn_guard(zncc_in),
        cols=FIRST if order == 1 else None)
    return p_out, u_in, v_in, zncc_out, it, dpn, computed


# --- DVC -------------------------------------------------------------------

# Per-POI working set of icgn3d1 in subset-sized float32 arrays: the 12
# steepest-descent channels and the reference subset, plus the warped
# coordinates, their window-local parts, offsets, masks and the
# interpolated values of one iteration.  ICGN3D1's chunk budget divides by
# it; the peak measured on the card at r=30 was 33 such arrays a POI.
WORKSET_ARRAYS_3D = 40


def _windows3d(coeff, xs, ys, zs, u_in, v_in, w_in, *, rx, ry, rz,
               margin):
    """The POIs' coefficient windows of half-extent r+margin on the seeded
    center, clamped into the volume: their corners ``[wcx, wcy, wcz]``
    ([N] int32 each) and sides ``(swx, swy, swz)``."""
    dz_, dy_, dx_ = coeff.shape
    sides = tuple(2 * (r + margin) + 1 for r in (rx, ry, rz))
    return [torch.clamp(torch.floor(c + u).to(_I32) - (sw // 2), 0, dim - sw)
            for c, u, sw, dim in ((xs, u_in, sides[0], dx_),
                                  (ys, v_in, sides[1], dy_),
                                  (zs, w_in, sides[2], dz_))], sides


def _exact_window_eval3d(coeff, gxc, gyc, gzc, wc, sides):
    """Every sample through the global coefficient volume (JAX
    ``icgn.py:905-953``, whose tile LUT gives the same values bit for bit),
    and -1 where a sample leaves the volume (or is NaN) or its localised
    integer floor leaves [1, sw - 3] of its POI's window."""
    oob = icgn3d_step.window_local_3d(gxc, gyc, gzc, *wc,
                                      vol_shape=coeff.shape, sides=sides)[-1]
    tval, _ = bspline.tricubic_eval(coeff, gxc, gyc, gzc)
    return torch.where(oob, torch.full_like(tval, -1.0), tval)


def _lattice_eval3d(coeff, xs, ys, zs, wc, sides, coords, *, rx, ry, rz,
                    margin, count, layer: str):
    """The windowed lattice eval of icgn3d1 (JAX ``icgn.py:899-1041``).

    In the POIs' coefficient windows (``wc``, ``sides``), a sample leaving
    its window, or the volume, reads -1.  Every iteration cuts a D=1 block
    from the window (padded by 1+D zeros per side) at a base taken from the
    center sample and evaluates all samples with the lattice kernel, its
    inputs from the prologue (``icgn3d_step.lattice_prologue_3d``).  When
    any active, non-doomed sample wobbles past D, the whole chunk is
    evaluated through the global coefficient volume instead
    (:func:`_exact_window_eval3d` on ``coords(wmat)``), as the JAX package
    does.

    Returns ``eval_tar(wmat, active) -> (tval [N, S], fail0)``: with the
    lattice, ``fail0`` marks the POIs with an out-of-range sample (their
    values are the kernel's, not -1); with the exact fallback, it is None
    and those samples read -1."""
    n = xs.shape[0]
    D = 1

    def eval_tar(wmat, active):
        pdz, pdy, pdx, fz, fy, fx, eblk, doomed, wobble = \
            icgn3d_step.lattice_prologue_3d(
                wmat, xs, ys, zs, *wc, coeff, rx=rx, ry=ry, rz=rz,
                margin=margin, d_wobble=D)
        # a POI with any out-of-range sample fails -3 this iteration
        # whatever its values, and a frozen POI's values are discarded:
        # neither may send the chunk to the exact fallback
        if timing.host_read(f"{layer}.sync.wobble",
                            (wobble & ~doomed & active).any(), bool):
            del pdz, pdy, pdx, fz, fy, fx, eblk
            count["fallback"] += 1
            with timing.span(f"{layer}.exact"):
                return _exact_window_eval3d(coeff, *coords(wmat), wc,
                                            sides), None
        count["lattice"] += 1
        val = lattice_eval_3d(eblk, pdz, pdy, pdx, fz, fy, fx, d_wobble=D)
        return val.reshape(n, -1), doomed

    return eval_tar


def icgn3d1(gx: torch.Tensor, gy: torch.Tensor, gz: torch.Tensor,
            ref_vol: torch.Tensor, tar_coeff: torch.Tensor, xs: torch.Tensor,
            ys: torch.Tensor, zs: torch.Tensor, p_in: torch.Tensor,
            zncc_in: torch.Tensor, conv: float, max_iter: float, *, rx: int,
            ry: int, rz: int, window_margin: Optional[int] = None,
            eval_mode: str = "lattice", z_guard_lo=None, z_guard_hi=None,
            stats: Optional[collections.Counter] = None,
            layer: str = "icgn"):
    """3D first-order IC-GN (oc_icgn.cpp:1270-1490) over a POI queue.

    Returns (p_out [N,12], u0, v0, w0, zncc, iteration, convergence,
    computed).  ``window_margin`` None evaluates every sample through the
    global coefficient volume; an int M evaluates through per-POI windows
    of half-extent r+M, where a sample leaving its window reads as out of
    range (-3): with ``eval_mode="tile"`` at the global eval's values
    (:func:`_exact_window_eval3d`), with any other mode (the default
    "lattice", as in the JAX package) through the lattice kernel
    (:func:`_lattice_eval3d`).  The
    convergence norm takes the displacement increments only
    (oc_icgn.cpp:1445).  ``z_guard_lo``/``z_guard_hi`` (floats; None or
    +-inf turns a side off) tighten the range guard along z, as the sharded
    DVC path needs on a halo-extended block: a warped sample with
    z < lo or z >= hi fails its POI with -3.  ``stats``, when given, counts
    iterations, lattice launches and fallback iterations; ``layer`` names
    the spans and host reads, as in :func:`icgn2d`.  It computes in the
    volumes' dtype: float32 as the package runs it, and on a card always
    (the kernels take float32 alone), float64 for a reference replay on
    the CPU."""
    z_guarded = z_guard_lo is not None or z_guard_hi is not None
    z_lo = -float("inf") if z_guard_lo is None else float(z_guard_lo)
    z_hi = float("inf") if z_guard_hi is None else float(z_guard_hi)
    dev = ref_vol.device
    fdt = ref_vol.dtype
    count = stats if stats is not None else collections.Counter()

    with timing.span(f"{layer}.setup"):
        u_in, v_in, w_in = p_in[:, 0], p_in[:, 4], p_in[:, 8]
        valid = entry_guard((xs, ys, zs), (rx, ry, rz), (u_in, v_in, w_in),
                            zncc_in, ref_vol.shape[::-1])

        # Reference subsets, their zero-mean norms and the inverse Hessians
        # of the steepest-descent images (oc_icgn.cpp:1314-1325).
        ref = icgn3d_step.reference_3d(gx, gy, gz, ref_vol, xs, ys, zs,
                                       rx=rx, ry=ry, rz=rz)
        grid = icgn3d_step.local_grid_3d(rx, ry, rz, fdt, dev)

        def coords(wmat):
            return tuple(icgn3d_step.warped_3d(wmat, row, c, grid)
                         for row, c in enumerate((xs, ys, zs)))

        wmat0 = warp_ops.warp3d1_from_p(p_in)

        if window_margin is None:
            def eval_tar(wmat, active):
                return bspline.tricubic_eval(tar_coeff, *coords(wmat))[0], None
        else:
            wc, sides = _windows3d(tar_coeff, xs, ys, zs, u_in, v_in, w_in,
                                   rx=rx, ry=ry, rz=rz, margin=window_margin)
            if eval_mode == "tile":
                def eval_tar(wmat, active):
                    return _exact_window_eval3d(tar_coeff, *coords(wmat), wc,
                                                sides), None
            else:
                eval_tar = _lattice_eval3d(
                    tar_coeff, xs, ys, zs, wc, sides, coords, rx=rx, ry=ry,
                    rz=rz, margin=window_margin, count=count, layer=layer)

    z_guard = (z_lo, z_hi) if z_guarded else None

    def body(state):
        wmat, active = state[:2]
        with timing.span(f"{layer}.eval"):
            tval, fail0 = eval_tar(wmat, active)
        # A negative sample, the -1 sentinel included, fails the POI, as
        # does a sample past the z guards.
        fail_any, znssd_new, num = icgn3d_step.residual_3d(
            tval, fail0, ref, wmat, zs, rx=rx, ry=ry, rz=rz, z_guard=z_guard)
        del tval
        dp = torch.bmm(ref.hinv, num[:, :, None])[:, :, 0]
        winc = warp_ops.warp3d1_from_p(dp)
        wmat_new = torch.bmm(wmat, linalg_ops.inv_small(winc))
        # displacement-only convergence norm (oc_icgn.cpp:1445)
        dpn_new = torch.sqrt(dp[:, 0] * dp[:, 0] + dp[:, 4] * dp[:, 4]
                             + dp[:, 8] * dp[:, 8])
        return gn_update(state, fail_any, wmat_new, znssd_new, dpn_new, conv,
                         max_iter)

    wmat, _, it, dpn, znssd, oob_fail = iterate(
        body, gn_state(wmat0, valid, xs), count, "iter", layer)

    with timing.span(f"{layer}.finish"):
        p_out, zncc_out, computed = finish(
            warp_ops.p_from_warp3d1(wmat), p_in, zncc_in, valid, oob_fail, it,
            dpn, znssd, conv, max_iter, icgn_guard(zncc_in), disp=(0, 4, 8))
    return p_out, u_in, v_in, w_in, zncc_out, it, dpn, computed
