"""Batched FFT-accelerated zero-mean cross-correlation (integer-pixel initial
guess).

Reference: ``oc_fftcc.cpp`` -- per POI, a 2rx x 2ry window is cut from the
reference image at the POI and from the target image displaced by the
existing initial guess (oc_fftcc.cpp:187-219); both windows are zero-meaned
(:225-231); the conjugate spectral product is inverted (:237-243); the
argmax of the circular correlation is unwrapped to a signed displacement
(:246-266); ZNCC = peak / (|ref| |tar|) (:274).  POIs whose window would
cross the image edge are skipped (:190-196; deformation left unchanged).

All windows are cut at once (2D: by the gather kernel) and one batched
``rfft2``/``irfft2`` (3D: ``rfftn``/``irfftn``) handles the queue.
"""

from __future__ import annotations

import collections
from typing import Optional, Tuple

import torch

from ..utils import timing
from . import rerank3d
from .gather2d import gather_windows_2d
from .window3d import gather_windows_3d

_NCAND = 16  # f32 peak candidates re-scored exactly


def _compact(mask: torch.Tensor, k: int):
    """Indices of the first k set elements of ``mask`` in scan order.

    Returns ``(idx [k] int64, ok [k] bool)``; slots past the population
    count carry a clamped in-range index and ok=False."""
    n = mask.shape[0]
    cs = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
    want = torch.arange(1, k + 1, dtype=torch.int32, device=mask.device)
    idx = torch.searchsorted(cs, want, side="left")
    ok = torch.arange(k, device=mask.device) < cs[-1]
    return torch.clamp(idx, max=n - 1), ok


def _rerank(ri: torch.Tensor, ti: torch.Tensor, cand: torch.Tensor, wh: int,
            ww: int) -> torch.Tensor:
    """Exact integer scores of the candidate shifts ([B, S] operands); the
    winner is the smallest flat index among the best-scoring candidates."""
    dev = ri.device
    flat = torch.arange(wh * ww, device=dev)
    yy, xx = flat // ww, flat % ww
    scores = []
    for j in range(cand.shape[1]):
        dv = cand[:, j: j + 1] // ww
        du = cand[:, j: j + 1] % ww
        src = ((yy[None, :] + dv) % wh) * ww + (xx[None, :] + du) % ww
        scores.append(torch.sum(ri * torch.gather(ti, 1, src), dim=1,
                                dtype=torch.int32))
    scores = torch.stack(scores, dim=1)  # [B, 16] exact int32
    best = scores.max(dim=1, keepdim=True).values
    none = torch.full_like(cand, wh * ww)
    return torch.where(scores == best, cand, none).min(dim=1).values


def fftcc2d(ref_img: torch.Tensor, tar_img: torch.Tensor, xs: torch.Tensor,
            ys: torch.Tensor, u_in: torch.Tensor, v_in: torch.Tensor, *,
            rx: int, ry: int,
            stats: Optional[collections.Counter] = None,
            layer: str = "fftcc"
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (u, v, zncc, valid); invalid POIs keep their inputs.
    ``stats``, when given, counts the re-rank branches taken; ``layer``,
    the calling module's family, names the spans, host reads and the
    ``<layer>.calls`` counter."""
    count = stats if stats is not None else collections.Counter()
    timing.count(f"{layer}.calls")
    h, w = ref_img.shape
    n = xs.shape[0]
    ww, wh = 2 * rx, 2 * ry
    i32 = torch.int32

    with timing.span(f"{layer}.correlate"):
        xi = xs.to(i32)  # (int)poi->x -- C truncation
        yi = ys.to(i32)
        txi = (xs + u_in).to(i32)  # int(poi->x + u)
        tyi = (ys + v_in).to(i32)

        # Boundary guard (oc_fftcc.cpp:190-196).
        valid = ((xi >= rx) & (xi < w - rx) & (yi >= ry) & (yi < h - ry)
                 & (txi >= rx) & (txi < w - rx) & (tyi >= ry) & (tyi < h - ry))

        ref_w = gather_windows_2d(ref_img, (yi - ry).clamp(0, h - wh),
                                  (xi - rx).clamp(0, w - ww), sh=wh, sw=ww)
        tar_w = gather_windows_2d(tar_img, (tyi - ry).clamp(0, h - wh),
                                  (txi - rx).clamp(0, w - ww), sh=wh, sw=ww)

        ref_zm = ref_w - ref_w.mean(dim=(1, 2), keepdim=True)
        tar_zm = tar_w - tar_w.mean(dim=(1, 2), keepdim=True)
        ref_norm = torch.sum(ref_zm * ref_zm, dim=(1, 2))
        tar_norm = torch.sum(tar_zm * tar_zm, dim=(1, 2))

        spec = torch.conj(torch.fft.rfft2(ref_zm)) * torch.fft.rfft2(tar_zm)
        corr = torch.fft.irfft2(spec, s=(wh, ww))  # [N, wh, ww]
        flat = corr.reshape(n, wh * ww)
        idx = torch.argmax(flat, dim=1)  # first maximum, like the reference

        # Exact peak re-rank for 8-bit images: over the circular window the
        # zero-mean correction is shift-independent, so argmax_d corr_zm[d] =
        # argmax_d sum(R * T_shift_d), an integer <= 2rx*2ry*255^2 < 2^31 that
        # int32 holds exactly.
        # The f32 top-16 candidates of near-tie POIs are re-scored exactly;
        # exact ties take the first flat index in scan order, matching the
        # reference's strict-> first-max loop (oc_fftcc.cpp:246-255).
        # Non-integral images keep the f32 argmax.
        ri = torch.round(ref_w)
        ti = torch.round(tar_w)
        is_int = ((ref_w == ri).all(dim=2).all(dim=1)
                  & (tar_w == ti).all(dim=2).all(dim=1))
        # Range guard: the exact path needs max|R|*max|T|*S < 2^31 (8-bit
        # windows give ~2^26); 16-bit integral images keep the f32 peak.
        cap = (ri.abs().amax(dim=(1, 2)) * ti.abs().amax(dim=(1, 2))
               * (wh * ww))
        is_int = is_int & (cap < 0.99 * 2.0 ** 31)
        ri_flat = ri.reshape(n, wh * ww).to(torch.int32)
        ti_flat = ti.reshape(n, wh * ww).to(torch.int32)
        topv, cand = torch.topk(flat, _NCAND, dim=1)

        # Only near-tie peaks can flip (f32 FFT noise is ~1e-6 relative):
        # re-rank the POIs whose top-2 gap is under a 3e-3-relative margin;
        # past the cap, re-rank every integral POI.
        near_tie = (topv[:, 0] - topv[:, 1]) <= 3e-3 * torch.clamp(
            topv[:, 0].abs(), min=1e-20)
        need = is_int & near_tie
    n_need = timing.host_read(f"{layer}.sync.need", need.sum(), int)
    capf = min(n, max(256, n // 16))
    if n_need > capf:
        count["rerank_full"] += 1
        with timing.span(f"{layer}.rerank"):
            idx = torch.where(is_int, _rerank(ri_flat, ti_flat, cand, wh,
                                              ww), idx)
    elif n_need > 0:
        count["rerank_gated"] += 1
        with timing.span(f"{layer}.rerank"):
            idx_r, okr = _compact(need, capf)
            ex = _rerank(ri_flat[idx_r], ti_flat[idx_r], cand[idx_r], wh,
                         ww)
            # padding slots write to row n, which is dropped
            dst = torch.where(okr, idx_r, torch.full_like(idx_r, n))
            buf = torch.cat([idx, idx[:1]])
            buf[dst] = ex
            idx = buf[:n]

    peak = torch.gather(flat, 1, idx[:, None])[:, 0]
    du = idx % ww
    dv = idx // ww
    du = torch.where(du > rx, du - ww, du)
    dv = torch.where(dv > ry, dv - wh, dv)

    u_out = du.to(torch.float32) + u_in
    v_out = dv.to(torch.float32) + v_in
    # irfft2's normalized inverse already divides by the window size, so
    # ZNCC = peak / sqrt(ref_norm * tar_norm) (cf. oc_fftcc.cpp:274).
    zncc = peak / torch.sqrt(ref_norm * tar_norm)
    return (torch.where(valid, u_out, u_in), torch.where(valid, v_out, v_in),
            zncc, valid)


_NCAND_3D = rerank3d.NCAND  # f32 peak candidates re-scored exactly in 3D


def fftcc3d(ref_vol: torch.Tensor, tar_vol: torch.Tensor, xs: torch.Tensor,
            ys: torch.Tensor, zs: torch.Tensor, u_in: torch.Tensor,
            v_in: torch.Tensor, w_in: torch.Tensor, *, rx: int, ry: int,
            rz: int, stats: Optional[collections.Counter] = None,
            layer: str = "fftcc"):
    """3D FFTCC (oc_fftcc.cpp:327-427).  Returns (u, v, w, zncc, valid);
    invalid POIs keep their inputs.

    Windows that would cross the volume edge are skipped, as in 2D (the
    reference's 3D path has no guard; a clipped window would correlate the
    wrong voxels).  Integral volumes get an exact re-rank of the top-8 f32
    peaks, on every POI (3D has no near-tie gate): the integer correlation
    reaches (2r)^3 * 255^2 (about 1.4e10 at r=30), past int32, so each
    product is split hi/lo (p = 256*(p>>8) + (p&0xFF), exact in two's
    complement), the two partial sums are carry-normalised and compared
    lexicographically, and exact ties take the first flat index in scan
    order (the reference's strict-> first-max loop).  ``torch.sum`` of
    int32 returns int64; under the range guards both sums fit int32
    anyway, so the numbers are the JAX package's.  On CUDA one kernel
    scores the candidates straight from the float32 windows
    (:func:`rerank3d.rerank_3d`, the same winners); on the CPU
    :func:`_rerank3d` does.  ``stats``, when given,
    counts the computes that ran the re-rank; ``layer`` as in
    :func:`fftcc2d`."""
    count = stats if stats is not None else collections.Counter()
    timing.count(f"{layer}.calls")
    dz, dy, dx = ref_vol.shape
    n = xs.shape[0]
    wx, wy, wz = 2 * rx, 2 * ry, 2 * rz
    v = wz * wy * wx
    i32 = torch.int32

    with timing.span(f"{layer}.correlate"):
        xi, yi, zi = xs.to(i32), ys.to(i32), zs.to(i32)  # C truncation
        txi = (xs + u_in).to(i32)
        tyi = (ys + v_in).to(i32)
        tzi = (zs + w_in).to(i32)
        valid = ((xi >= rx) & (xi < dx - rx) & (yi >= ry) & (yi < dy - ry)
                 & (zi >= rz) & (zi < dz - rz)
                 & (txi >= rx) & (txi < dx - rx) & (tyi >= ry)
                 & (tyi < dy - ry)
                 & (tzi >= rz) & (tzi < dz - rz))

        ref_w = gather_windows_3d(
            ref_vol, (zi - rz).clamp(0, dz - wz), (yi - ry).clamp(0, dy - wy),
            (xi - rx).clamp(0, dx - wx), wz, wy, wx)
        tar_w = gather_windows_3d(
            tar_vol, (tzi - rz).clamp(0, dz - wz),
            (tyi - ry).clamp(0, dy - wy),
            (txi - rx).clamp(0, dx - wx), wz, wy, wx)

        dims = (1, 2, 3)
        ref_zm = ref_w - ref_w.mean(dim=dims, keepdim=True)
        tar_zm = tar_w - tar_w.mean(dim=dims, keepdim=True)
        ref_norm = torch.sum(ref_zm * ref_zm, dim=dims)
        tar_norm = torch.sum(tar_zm * tar_zm, dim=dims)

        spec = (torch.conj(torch.fft.rfftn(ref_zm, dim=dims))
                * torch.fft.rfftn(tar_zm, dim=dims))
        corr = torch.fft.irfftn(spec, s=(wz, wy, wx), dim=dims)
        del spec
        flat = corr.reshape(n, v)
        idx = torch.argmax(flat, dim=1)  # first maximum, like the reference

        ri = torch.round(ref_w)
        ti = torch.round(tar_w)
        is_int = ((ref_w == ri).reshape(n, v).all(dim=1)
                  & (tar_w == ti).reshape(n, v).all(dim=1))
        # Partial-sum range guards: v * (max|p|/256 + 1) bounds the hi sum and
        # v * 255 the lo sum (negative products leave p & 0xFF up to 255).
        cap = ri.abs().amax(dim=dims) * ti.abs().amax(dim=dims)
        is_int = is_int & (v * (cap / 256.0 + 1.0) < 0.99 * 2.0 ** 31)
        if v * 255.0 >= 0.99 * 2.0 ** 31:
            is_int = torch.zeros_like(is_int)
    if timing.host_read(f"{layer}.sync.integral", is_int.any(), bool):
        count["rerank"] += 1
        with timing.span(f"{layer}.rerank"):
            if ref_w.is_cuda:
                cand = torch.topk(flat, _NCAND_3D, dim=1).indices
                best = rerank3d.rerank_3d(ref_w, tar_w, cand)
            else:
                best = _rerank3d(ri.reshape(n, v).to(i32),
                                 ti.reshape(n, v).to(i32), flat, wz, wy, wx)
            idx = torch.where(is_int, best, idx)

    peak = torch.gather(flat, 1, idx[:, None])[:, 0]
    du = idx % wx
    dv = (idx // wx) % wy
    dw = idx // (wx * wy)
    du = torch.where(du > rx, du - wx, du)
    dv = torch.where(dv > ry, dv - wy, dv)
    dw = torch.where(dw > rz, dw - wz, dw)

    u_out = du.to(torch.float32) + u_in
    v_out = dv.to(torch.float32) + v_in
    w_out = dw.to(torch.float32) + w_in
    zncc = peak / torch.sqrt(ref_norm * tar_norm)
    return (torch.where(valid, u_out, u_in), torch.where(valid, v_out, v_in),
            torch.where(valid, w_out, w_in), zncc, valid)


def _rerank3d(ri: torch.Tensor, ti: torch.Tensor, flat: torch.Tensor,
              wz: int, wy: int, wx: int) -> torch.Tensor:
    """Exact hi/lo integer scores of the top-8 f32 peaks ([N, V] int32
    operands); the winner is the smallest flat index among the
    best-scoring candidates."""
    v = wz * wy * wx
    cand = torch.topk(flat, _NCAND_3D, dim=1).indices  # [N, 8]
    lin = torch.arange(v, device=flat.device)
    zz = lin // (wy * wx)
    yy = (lin // wx) % wy
    xx = lin % wx
    his, los = [], []
    for j in range(_NCAND_3D):
        c = cand[:, j: j + 1]
        src = (((zz + c // (wx * wy)) % wz) * (wy * wx)
               + ((yy + (c // wx) % wy) % wy) * wx
               + (xx + c % wx) % wx)
        p = ri * torch.gather(ti, 1, src)  # |p| <= 255^2 < 2^31
        del src
        hi = torch.sum(p >> 8, dim=1)
        lo = torch.sum(p & 0xFF, dim=1)
        his.append(hi + (lo >> 8))  # carry-normalise: lo in [0, 255]
        los.append(lo & 0xFF)
    his = torch.stack(his, dim=1)
    los = torch.stack(los, dim=1)
    sel1 = his == his.max(dim=1, keepdim=True).values
    best_lo = torch.where(sel1, los, torch.full_like(los, -2 ** 31)).max(
        dim=1, keepdim=True).values
    sel = sel1 & (los == best_lo)
    return torch.where(sel, cand, torch.full_like(cand, v)).min(dim=1).values
