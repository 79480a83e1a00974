"""2D SIFT detection, description and matching on the device.

The reference calls OpenCV's CPU SIFT (``oc_sift.cpp:60-130``); the JAX
package re-implements it with OpenCV's parameterization (contrast threshold
scaling, banker's rounding, reflect-101 blur borders, the 0.8 orientation
peak ratio, the 4x4x8 descriptor with trilinear binning, the 0.2 magnitude
clip and the 512 scaling with uchar saturation) as batched array programs,
and this module ports that re-implementation:

* Gaussian pyramid: separable blurs per octave (static sigmas).
* DoG extrema: 26-neighbour comparisons; candidates extracted in scan order
  by a cumsum compaction into ``k_raw`` per octave.
* Sub-pixel refinement: the 5-step quadratic fit, batched over candidates
  with masked state; survivors compacted into ``k_kp``.
* The octave's size sets ``k_raw`` and ``k_kp`` (:func:`octave_caps`, the
  JAX package's fixed caps); where a count passes one, its buffer grows to
  hold every extremum, keypoint and orientation instance, as OpenCV's
  SIFT with ``nfeatures`` 0 keeps them all.
* Orientation peaks (at most 3 per keypoint) and the descriptor over fixed
  windows per keypoint, the descriptor's trilinear scatter written as dense
  tent-weight products, in chunks of ``DESC_CHUNK`` instances.
* Matching: an exact 2-NN with Lowe's ratio test from one distance matmul
  (the reference's FLANN search is approximate).

Where XLA fuses a float32 multiply-add of the JAX package on the CPU, the
port rounds it once too (``fma``).  The blur sums in float64 and rounds
once, the same on every device; the window sums and the transcendental
functions round in each library's own order (ROADMAP §3).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from ..utils import timing
from ..utils.precision import f32, fma
from .linalg import solve_small

# the family of this module's spans and host reads (``utils/timing``)
LAYER = "sift2d"

# OpenCV SIFT constants
IMG_BORDER = 5
MAX_INTERP_STEPS = 5
ORI_HIST_BINS = 36
ORI_SIG_FCTR = 1.5
ORI_RADIUS = 3 * ORI_SIG_FCTR
ORI_PEAK_RATIO = 0.8
DESCR_WIDTH = 4
DESCR_HIST_BINS = 8
DESCR_SCL_FCTR = 3.0
DESCR_MAG_THR = 0.2
INT_DESCR_FCTR = 512.0

MAX_ORI_PEAKS = 3  # OpenCV emits one keypoint per histogram peak
DESC_CHUNK = 1024  # descriptor instances computed at once

_F = torch.float32
_I = torch.int32


def _gauss_kernel(sigma: float) -> np.ndarray:
    """cv::getGaussianKernel for float images: ksize = round(8*sigma+1)|1."""
    ksize = int(round(sigma * 8 + 1)) | 1
    half = ksize // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _reflect_index(n: int, half: int, device) -> torch.Tensor:
    """Source indices of a BORDER_REFLECT_101 padding of ``half`` on each
    side of a length-``n`` axis (numpy's "reflect", repeated when ``half``
    exceeds the axis)."""
    i = torch.arange(-half, n + half, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    m = torch.remainder(i, period)
    return torch.where(m >= n, period - m, m)


def blur(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable Gaussian blur with BORDER_REFLECT_101, rows then columns.
    Each pass adds its taps' products in float64, in tap order, and rounds
    once to float32 (the product of two float32 values is exact in
    float64), so every device computes the same pyramid.  XLA's CPU
    convolution, which runs the JAX package's blur, rounds in an order the
    port does not reproduce: the two pyramids differ in the last bits
    (ROADMAP §3)."""
    half = len(kernel) // 2
    taps = [float(v) for v in kernel]
    out = img
    for dim in (0, 1):
        n = out.shape[dim]
        p = out.index_select(dim, _reflect_index(n, half, out.device)).double()
        acc = p.narrow(dim, 0, n) * taps[0]
        for i in range(1, len(taps)):
            acc.add_(p.narrow(dim, i, n), alpha=taps[i])
        del p
        out = acc.float()
    return out


def compact(mask: torch.Tensor, k: int):
    """Indices of the first ``k`` set elements of ``mask`` in scan order:
    (idx [k] int64, ok [k] bool); slots past the population count hold a
    clamped in-range index and ok False."""
    n = mask.shape[0]
    cs = torch.cumsum(mask.to(_I), 0, dtype=_I)
    want = torch.arange(1, k + 1, dtype=_I, device=mask.device)
    idx = torch.searchsorted(cs, want, side="left")
    ok = torch.arange(k, device=mask.device) < cs[-1]
    return torch.clamp(idx, max=n - 1), ok


def n_octaves_for(shape: Tuple[int, int]) -> int:
    """Octave count incl. the doubled base (cv::SIFT with firstOctave=-1)."""
    base_min = min(shape) * 2
    return max(int(round(math.log2(base_min) - 2)) + 1, 1)


def octave_sigmas(sigma: float, n_layers: int) -> List[float]:
    """Incremental blur sigmas per layer (sift.cpp buildGaussianPyramid)."""
    k = 2.0 ** (1.0 / n_layers)
    sig = [sigma]
    for i in range(1, n_layers + 3):
        sig_prev = sigma * k ** (i - 1)
        sig_total = sig_prev * k
        sig.append(math.sqrt(sig_total * sig_total - sig_prev * sig_prev))
    return sig


def upscale2x(img: torch.Tensor) -> torch.Tensor:
    """2x bilinear upscale with half-pixel centres and edge clamping
    (``jax.image.resize(..., "linear")``): output i samples input
    i/2 - 1/4.  On 8-bit input every product and sum is exact, so the order
    of the taps does not matter."""

    def axis(a, dim):
        n = a.shape[dim]
        idx = torch.arange(n, device=a.device)
        prev = a.index_select(dim, torch.clamp(idx - 1, min=0))
        nxt = a.index_select(dim, torch.clamp(idx + 1, max=n - 1))
        even = 0.75 * a + 0.25 * prev
        odd = 0.75 * a + 0.25 * nxt
        out = torch.stack([even, odd], dim=dim + 1)
        shape = list(a.shape)
        shape[dim] = 2 * n
        return out.reshape(shape)

    return axis(axis(img, 0), 1)


def build_base(img: torch.Tensor, *, sigma: float) -> torch.Tensor:
    """createInitialImage: u8-rounded input, 2x bilinear upscale,
    pre-blur."""
    img = torch.round(img.clamp(0.0, 255.0))
    sig_diff = math.sqrt(max(sigma * sigma - 1.0, 0.01))
    return blur(upscale2x(img), _gauss_kernel(sig_diff))


def build_octave(base: torch.Tensor, *, sigmas):
    """One octave: [nL+3, H, W] Gaussian stack and [nL+2, H, W] DoG."""
    layers = [base]
    for s in sigmas[1:]:
        layers.append(blur(layers[-1], _gauss_kernel(s)))
    gauss = torch.stack(layers)
    return gauss, gauss[1:] - gauss[:-1]


def extremum_mask(dog: torch.Tensor, thr: float, n_layers: int):
    """26-neighbour extremum test over layers 1..n_layers ([nL, H, W])."""
    center = dog[1: 1 + n_layers]
    ge = torch.ones_like(center, dtype=torch.bool)
    le = torch.ones_like(center, dtype=torch.bool)
    for dl in (-1, 0, 1):
        sl = dog[1 + dl: 1 + dl + n_layers]
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                if dl == 0 and dr == 0 and dc == 0:
                    continue
                nb = torch.roll(sl, (-dr, -dc), dims=(1, 2))
                ge &= center >= nb
                le &= center <= nb
    mask = (center.abs() > thr) & (((center > 0) & ge) | ((center < 0) & le))
    h, w = dog.shape[1], dog.shape[2]
    rr = torch.arange(h, device=dog.device)[None, :, None]
    cc = torch.arange(w, device=dog.device)[None, None, :]
    border = ((rr >= IMG_BORDER) & (rr < h - IMG_BORDER)
              & (cc >= IMG_BORDER) & (cc < w - IMG_BORDER))
    return mask & border


def _cube(dog, layer, r, c):
    """[K, 3, 3, 3] neighbourhoods of (layer, r, c), the corner clamped
    into the stack as ``lax.dynamic_slice`` clamps it (only padding slots
    reach the clamp)."""
    o = torch.arange(3, device=dog.device)
    start = lambda a, n: (torch.clamp(a - 1, 0, n - 3)[:, None] + o)
    return dog[start(layer, dog.shape[0])[:, :, None, None],
               start(r, dog.shape[1])[:, None, :, None],
               start(c, dog.shape[2])[:, None, None, :]]


_IMG_SCALE = f32(1.0 / 255.0)
_DERIV_SCALE = f32(np.float32(_IMG_SCALE) * np.float32(0.5))
_CROSS_SCALE = f32(np.float32(_IMG_SCALE) * np.float32(0.25))


def _second(v):
    """dxx, dyy, dxy of the centre of [K, 3, 3, 3] cubes."""
    c2 = v[:, 1, 1, 1] * 2.0
    dxx = (v[:, 1, 1, 2] + v[:, 1, 1, 0] - c2) * _IMG_SCALE
    dyy = (v[:, 1, 2, 1] + v[:, 1, 0, 1] - c2) * _IMG_SCALE
    dxy = (v[:, 1, 2, 2] - v[:, 1, 2, 0] - v[:, 1, 0, 2]
           + v[:, 1, 0, 0]) * _CROSS_SCALE
    return c2, dxx, dyy, dxy


def _derivs(v):
    dD = torch.stack([(v[:, 1, 1, 2] - v[:, 1, 1, 0]) * _DERIV_SCALE,
                      (v[:, 1, 2, 1] - v[:, 1, 0, 1]) * _DERIV_SCALE,
                      (v[:, 2, 1, 1] - v[:, 0, 1, 1]) * _DERIV_SCALE], -1)
    c2, dxx, dyy, dxy = _second(v)
    dss = (v[:, 2, 1, 1] + v[:, 0, 1, 1] - c2) * _IMG_SCALE
    dxs = (v[:, 2, 1, 2] - v[:, 2, 1, 0] - v[:, 0, 1, 2]
           + v[:, 0, 1, 0]) * _CROSS_SCALE
    dys = (v[:, 2, 2, 1] - v[:, 2, 0, 1] - v[:, 0, 2, 1]
           + v[:, 0, 0, 1]) * _CROSS_SCALE
    hess = torch.stack([torch.stack([dxx, dxy, dxs], -1),
                        torch.stack([dxy, dyy, dys], -1),
                        torch.stack([dxs, dys, dss], -1)], -2)
    return dD, hess


def refine_candidates(dog, layer0, r0, c0, cand_ok, *, n_layers,
                      contrast_thr, edge_thr):
    """adjustLocalExtrema (sift.cpp): the 5-step quadratic fit, batched,
    then the contrast and edge tests at the final location."""
    h, w = dog.shape[1], dog.shape[2]
    layer, r, c = layer0, r0, c0
    alive = cand_ok
    done = torch.zeros_like(cand_ok)
    xc = torch.zeros(r.shape, dtype=_F, device=r.device)
    xr = torch.zeros_like(xc)
    xi = torch.zeros_like(xc)
    big = 7.15e8
    for _ in range(MAX_INTERP_STEPS):
        dD, hess = _derivs(_cube(dog, layer, r, c))
        x = solve_small(hess, dD)
        xc_n, xr_n, xi_n = -x[:, 0], -x[:, 1], -x[:, 2]
        step = alive & ~done
        xc = torch.where(step, xc_n, xc)
        xr = torch.where(step, xr_n, xr)
        xi = torch.where(step, xi_n, xi)
        converged = ((xc_n.abs() < 0.5) & (xr_n.abs() < 0.5)
                     & (xi_n.abs() < 0.5))
        blown = ((xc_n.abs() > big) | (xr_n.abs() > big) | (xi_n.abs() > big)
                 | ~torch.isfinite(xc_n) | ~torch.isfinite(xr_n)
                 | ~torch.isfinite(xi_n))
        alive = alive & ~(step & blown)
        done = done | (step & converged & ~blown)
        move = step & ~converged & ~blown
        # round before the cast: NaN/inf only on blown (frozen) rows
        safe_round = lambda a: torch.round(torch.nan_to_num(
            a, nan=0.0, posinf=0.0, neginf=0.0).clamp(-big, big)).to(_I)
        c_next = c + safe_round(xc_n)
        r_next = r + safe_round(xr_n)
        l_next = layer + safe_round(xi_n)
        inb = ((l_next >= 1) & (l_next <= n_layers)
               & (c_next >= IMG_BORDER) & (c_next < w - IMG_BORDER)
               & (r_next >= IMG_BORDER) & (r_next < h - IMG_BORDER))
        alive = alive & ~(move & ~inb)
        safe = move & inb
        c = torch.where(safe, c_next, c)
        r = torch.where(safe, r_next, r)
        layer = torch.where(safe, l_next, layer)

    valid = alive & done  # not converged in 5 steps: rejected

    # contrast at the final location
    v = _cube(dog, layer, r, c)
    dD, _ = _derivs(v)
    t = fma(dD[:, 2], xi, fma(dD[:, 0], xc, dD[:, 1] * xr))
    contr = fma(v[:, 1, 1, 1], _IMG_SCALE, t * 0.5)
    valid = valid & (contr.abs() * n_layers >= contrast_thr)

    # edge response on the 2x2 spatial Hessian
    _, dxx, dyy, dxy = _second(v)
    tr = dxx + dyy
    det = fma(dxx, dyy, -(dxy * dxy))
    e = f32(edge_thr)
    valid = valid & (det > 0) & (tr * tr * e < (e + 1) * (e + 1) * det)
    return dict(valid=valid, layer=layer, r=r, c=c, xc=xc, xr=xr, xi=xi,
                response=contr.abs())


class Padded:
    """An octave's Gaussian layers edge-padded by ``pad`` on each side,
    once, for the window gathers of its orientation and descriptor
    stages."""

    def __init__(self, gauss: torch.Tensor, pad: int):
        self.pad = pad
        self.shape = gauss.shape
        self.data = torch.nn.functional.pad(
            gauss[:, None], (pad, pad, pad, pad), mode="replicate")[:, 0]


def window_grads(padded: Padded, layer, r, c, R):
    """[K, 2R+1, 2R+1] central-difference gradients (dx, dy) of windows
    centred at (r, c) of layer ``layer``, from the edge-padded layers."""
    rw = R + 1
    win = 2 * rw + 1
    o = torch.arange(win, device=layer.device) + (padded.pad - rw)
    w_img = padded.data[layer.long()[:, None, None],
                        (r.long()[:, None] + o)[:, :, None],
                        (c.long()[:, None] + o)[:, None, :]]
    dx = w_img[:, 1:-1, 2:] - w_img[:, 1:-1, :-2]
    dy = w_img[:, :-2, 1:-1] - w_img[:, 2:, 1:-1]
    return dx, dy


def _grid(R, device):
    g = torch.arange(-R, R + 1, dtype=_F, device=device)
    return g[None, :, None], g[None, None, :]  # ii (rows), jj (cols)


def ori_and_peaks(padded, layer, r, c, scl_octv, valid, *, radius_max):
    """calcOrientationHist and the 0.8-ratio peak loop: (angles [K, P],
    peak_ok [K, P]), P = MAX_ORI_PEAKS, peaks in decreasing height."""
    h, w = padded.shape[1], padded.shape[2]
    kk = r.shape[0]
    dev = r.device
    radius = torch.round(ORI_RADIUS * scl_octv)[:, None, None]
    # pixels past every keypoint's radius add exact zeros: cut them
    rmax = min(radius_max, timing.host_read(
        f"{LAYER}.sync.ori_radius", radius.max(), int) if kk else 0)
    dx, dy = window_grads(padded, layer, r, c, rmax)
    ii, jj = _grid(rmax, dev)
    sig = ORI_SIG_FCTR * scl_octv
    expf_scale = (-1.0 / (2.0 * sig * sig))[:, None, None]
    yy = r[:, None, None].to(_F) + ii
    xx = c[:, None, None].to(_F) + jj
    ok = ((ii.abs() <= radius) & (jj.abs() <= radius)
          & (yy > 0) & (yy < h - 1) & (xx > 0) & (xx < w - 1))
    wgt = torch.exp(fma(ii, ii, jj * jj) * expf_scale)
    mag = torch.sqrt(fma(dx, dx, dy * dy)) * wgt
    mag = torch.where(ok, mag, torch.zeros((), device=dev))
    ori = torch.rad2deg(torch.atan2(dy, dx))
    ori = torch.where(ori < 0, ori + 360.0, ori)
    bins = torch.round(ori * f32(ORI_HIST_BINS / 360.0)).to(torch.int64)
    bins = torch.where(bins >= ORI_HIST_BINS, bins - ORI_HIST_BINS, bins)
    bins = torch.where(bins < 0, bins + ORI_HIST_BINS, bins)
    hist = torch.zeros((kk, ORI_HIST_BINS), dtype=_F, device=dev)
    hist.scatter_add_(1, bins.reshape(kk, -1), mag.reshape(kk, -1))

    # circular smoothing [1, 4, 6, 4, 1] / 16
    roll = lambda k: torch.roll(hist, k, dims=1)
    hist = fma(hist, 6.0 / 16.0, fma(roll(2) + roll(-2), 1.0 / 16.0,
                                     (roll(1) + roll(-1)) * (4.0 / 16.0)))
    omax = hist.max(dim=1, keepdim=True).values
    hl = torch.roll(hist, 1, dims=1)
    hr = torch.roll(hist, -1, dims=1)
    is_peak = (hist > hl) & (hist > hr) & (hist >= f32(ORI_PEAK_RATIO) * omax)
    peak_val = torch.where(is_peak, hist, torch.full((), -1.0, device=dev))
    # top 3, the lower bin first among equal heights (lax.top_k's order)
    topv, topi = torch.sort(peak_val, dim=1, descending=True, stable=True)
    topv, topi = topv[:, :MAX_ORI_PEAKS], topi[:, :MAX_ORI_PEAKS]
    peak_ok = (topv > 0) & valid[:, None]

    hl_s = hl.gather(1, topi)
    hr_s = hr.gather(1, topi)
    hc_s = hist.gather(1, topi)
    denom = hl_s - 2.0 * hc_s + hr_s
    b = topi.to(_F) + 0.5 * (hl_s - hr_s) / torch.where(
        denom == 0, torch.ones((), device=dev), denom)
    b = torch.where(b < 0, b + ORI_HIST_BINS,
                    torch.where(b >= ORI_HIST_BINS, b - ORI_HIST_BINS, b))
    angle = fma(-(360.0 / ORI_HIST_BINS), b, 360.0)
    angle = torch.where((angle - 360.0).abs() < f32(1.19e-7),
                        torch.zeros((), device=dev), angle)
    return angle, peak_ok


def descriptor_chunk(padded, layer, r_f, c_f, scl_octv, angle, valid, *,
                     radius_max):
    """calcSIFTDescriptor for one chunk of instances: [C, 128]."""
    d, nb = DESCR_WIDTH, DESCR_HIST_BINS
    h, w = padded.shape[1], padded.shape[2]
    dev = r_f.device
    zero = torch.zeros((), device=dev)
    r_i = torch.round(r_f).to(_I)
    c_i = torch.round(c_f).to(_I)
    ori = 360.0 - angle
    ori = torch.where((ori - 360.0).abs() < f32(1.19e-7), zero, ori)
    ori_rad = torch.deg2rad(ori)
    hist_width = DESCR_SCL_FCTR * scl_octv
    cos_t = (torch.cos(ori_rad) / hist_width)[:, None, None]
    sin_t = (torch.sin(ori_rad) / hist_width)[:, None, None]
    radius = torch.round(hist_width * f32(math.sqrt(2.0)) * (d + 1) * 0.5)
    radius = torch.clamp(radius, max=f32(math.sqrt(h * h + w * w)))
    radius = radius[:, None, None]
    # pixels past every instance's radius add exact zeros: cut them
    rmax = min(radius_max, timing.host_read(f"{LAYER}.sync.desc_radius",
                                            radius.max(), int))
    dx, dy = window_grads(padded, layer, r_i, c_i, rmax)

    ii, jj = _grid(rmax, dev)
    c_rot = fma(jj, cos_t, -(ii * sin_t))
    r_rot = fma(jj, sin_t, ii * cos_t)
    rbin = r_rot + (d / 2 - 0.5)
    cbin = c_rot + (d / 2 - 0.5)
    yy = r_i[:, None, None].to(_F) + ii
    xx = c_i[:, None, None].to(_F) + jj
    ok = ((ii.abs() <= radius) & (jj.abs() <= radius)
          & (rbin > -1) & (rbin < d) & (cbin > -1) & (cbin < d)
          & (yy > 0) & (yy < h - 1) & (xx > 0) & (xx < w - 1))

    grad_ori = torch.rad2deg(torch.atan2(dy, dx))
    grad_ori = torch.where(grad_ori < 0, grad_ori + 360.0, grad_ori)
    obin = (grad_ori - ori[:, None, None]) * f32(nb / 360.0)
    exp_scale = f32(-1.0 / (d * d * 0.5))
    wgt = torch.exp(fma(c_rot, c_rot, r_rot * r_rot) * exp_scale)
    mag = torch.sqrt(fma(dx, dx, dy * dy)) * wgt
    mag = torch.where(ok, mag, zero)

    # Dense tent weights == OpenCV's trilinear scatter: each pixel adds to
    # at most 2 bins per axis.
    kk = r_f.shape[0]
    flat = lambda a: a.reshape(kk, -1)
    rbin_f, cbin_f, obin_f, mag_f = flat(rbin), flat(cbin), flat(obin), \
        flat(mag)
    br = torch.arange(d, dtype=_F, device=dev)
    wr = torch.clamp(1.0 - (rbin_f[..., None] - br).abs(), min=0.0)
    wc = torch.clamp(1.0 - (cbin_f[..., None] - br).abs(), min=0.0)
    bo = torch.arange(nb, dtype=_F, device=dev)
    dist = torch.remainder(obin_f[..., None] - bo, float(nb))
    wo = torch.clamp(1.0 - torch.minimum(dist, nb - dist), min=0.0)
    rc = ((wr * mag_f[..., None])[..., :, None] * wc[..., None, :])
    desc = torch.bmm(rc.reshape(kk, -1, d * d).transpose(1, 2), wo)
    desc = desc.reshape(kk, d * d * nb)

    # normalize, clip at 0.2, renormalize to 512, uchar saturation
    nrm2 = torch.sum(desc * desc, dim=1, keepdim=True)
    desc = torch.minimum(desc, torch.sqrt(nrm2) * f32(DESCR_MAG_THR))
    nrm2 = torch.sum(desc * desc, dim=1, keepdim=True)
    scale = INT_DESCR_FCTR / torch.clamp(torch.sqrt(nrm2), min=f32(1.19e-7))
    desc = torch.clamp(torch.round(desc * scale), 0.0, 255.0)
    return torch.where(valid[:, None], desc, zero)


def detect_octave(gauss, dog, *, n_layers, contrast_thr, edge_thr, sigma,
                  k_raw, k_kp, radius_ori, radius_desc):
    """One octave's detection.  Returns per-instance tensors of length
    ``k_kp`` or more: (ok, x, y, layer+xi, scl_octv, response, angle,
    desc) and the counts (candidates beside ``k_raw``, refined keypoints
    and orientation instances beside ``k_kp``).  A count past its cap
    grows the buffer to it, in whole ``DESC_CHUNK``s for keypoints and
    instances."""
    h, w = dog.shape[1], dog.shape[2]
    thr = math.floor(0.5 * contrast_thr / n_layers * 255)
    fit = lambda cap, n: max(cap, -(-n // DESC_CHUNK) * DESC_CHUNK)

    mask = extremum_mask(dog, thr, n_layers)
    n_cand = timing.host_read(f"{LAYER}.sync.candidates", mask.sum(), int)
    idx, cand_ok = compact(mask.reshape(-1), max(k_raw, n_cand))
    layer0 = (idx // (h * w)).to(_I) + 1
    rc = idx % (h * w)
    r0 = (rc // w).to(_I)
    c0 = (rc % w).to(_I)
    ref = refine_candidates(dog, layer0, r0, c0, cand_ok, n_layers=n_layers,
                            contrast_thr=contrast_thr, edge_thr=edge_thr)

    n_kp = timing.host_read(f"{LAYER}.sync.keypoints", ref["valid"].sum(),
                            int)
    kp_idx, kp_ok = compact(ref["valid"], fit(k_kp, n_kp))
    g = lambda a: a[kp_idx]
    layer, r, c = g(ref["layer"]), g(ref["r"]), g(ref["c"])
    xc, xr, xi = g(ref["xc"]), g(ref["xr"]), g(ref["xi"])
    resp = g(ref["response"])
    scl_octv = sigma * torch.exp2((layer.to(_F) + xi) / n_layers)

    padded = Padded(gauss, max(radius_ori, radius_desc) + 1)
    angle, peak_ok = ori_and_peaks(padded, layer, r, c, scl_octv, kp_ok,
                                   radius_max=radius_ori)

    # the [K, P] orientation instances, compacted for descriptors
    inst_ok = peak_ok.reshape(-1)
    n_inst = timing.host_read(f"{LAYER}.sync.instances", inst_ok.sum(), int)
    k_inst = fit(k_kp, n_inst)
    inst_idx, sel_ok = compact(inst_ok, k_inst)
    src = inst_idx // MAX_ORI_PEAKS
    s_layer, s_scl, s_resp = layer[src], scl_octv[src], resp[src]
    s_rf = (r.to(_F) + xr)[src]
    s_cf = (c.to(_F) + xc)[src]
    s_li = (layer.to(_F) + xi)[src]
    s_angle = angle.reshape(-1)[inst_idx]

    dwidth = DESCR_WIDTH * DESCR_WIDTH * DESCR_HIST_BINS
    desc = torch.zeros((k_inst, dwidth), dtype=_F, device=dog.device)
    # instances are front-compacted: the padding past them keeps zeros
    for lo in range(0, n_inst, DESC_CHUNK):
        sl = slice(lo, min(lo + DESC_CHUNK, n_inst))
        desc[sl] = descriptor_chunk(
            padded, s_layer[sl], s_rf[sl], s_cf[sl], s_scl[sl], s_angle[sl],
            sel_ok[sl], radius_max=radius_desc)
    counts = dict(candidates=n_cand, k_raw=k_raw, keypoints=n_kp,
                  instances=n_inst, k_kp=k_kp)
    return (sel_ok, s_cf, s_rf, s_li, s_scl, s_resp, s_angle, desc), counts


def radius_caps(sigma: float, n_layers: int) -> Tuple[int, int]:
    """Worst-case orientation and descriptor window radii of an octave."""
    scl_max = sigma * 2.0 ** ((n_layers + 0.5) / n_layers)
    r_ori = int(round(ORI_RADIUS * scl_max))
    r_desc = int(round(DESCR_SCL_FCTR * scl_max * math.sqrt(2.0)
                       * (DESCR_WIDTH + 1) * 0.5))
    return r_ori, r_desc


def octave_caps(hh: int, ww: int, n_layers: int) -> Tuple[int, int]:
    """(k_raw, k_kp) of an octave of hh x ww: the candidate and keypoint
    caps, k_kp a multiple of DESC_CHUNK; ``detect_octave`` grows a buffer
    past its cap where the octave's count needs it."""
    k_raw = int(np.clip(3 * hh * ww // 8, 4096, 262144))
    k_kp = int(np.clip(hh * ww // 32, 2048, 24576))
    k_kp = -(-k_kp // DESC_CHUNK) * DESC_CHUNK
    return min(k_raw, n_layers * hh * ww), k_kp


def detect_and_compute(img: torch.Tensor, *, n_octave_layers=3,
                       contrast_threshold=0.04, edge_threshold=10.0,
                       sigma=1.6):
    """SIFT on one image (a float32 tensor on the device).  Returns a list
    of per-octave results, each (ok, x, y, layer+xi, scl_octv, response,
    angle, desc, octave_index), and a list of per-octave counts."""
    h, w = img.shape
    n_oct = n_octaves_for((h, w))
    sigmas = tuple(octave_sigmas(sigma, n_octave_layers))
    r_ori, r_desc = radius_caps(sigma, n_octave_layers)
    cur = build_base(img.to(_F), sigma=sigma)
    results, counts = [], []
    for o in range(n_oct):
        hh, ww = cur.shape
        if min(hh, ww) < 2 * IMG_BORDER + 2:
            break
        gauss, dog = build_octave(cur, sigmas=sigmas)
        k_raw, k_kp = octave_caps(hh, ww, n_octave_layers)
        out, cnt = detect_octave(
            gauss, dog, n_layers=n_octave_layers,
            contrast_thr=float(contrast_threshold),
            edge_thr=float(edge_threshold), sigma=float(sigma),
            k_raw=k_raw, k_kp=k_kp, radius_ori=r_ori, radius_desc=r_desc)
        results.append(out + (o,))
        counts.append(dict(octave=o, shape=[hh, ww], **cnt))
        cur = gauss[n_octave_layers][::2, ::2].contiguous()
    return results, counts


def gather_keypoints(results):
    """Host assembly of the per-octave results: (pts [N, 2] in input-image
    coordinates, desc [N, 128], sizes, angles, responses) as numpy."""
    pts, descs, sizes, angles, resps = [], [], [], [], []
    for (ok, x, y, li, scl, resp, angle, desc, o) in results:
        ok = timing.host_read(f"{LAYER}.sync.ok", ok)
        if not ok.any():
            continue
        f = 2.0 ** (o - 1)  # octave o of the doubled pyramid
        host = lambda a: timing.host_read(f"{LAYER}.sync.keypoint", a)[ok]
        pts.append(np.stack([host(x) * f, host(y) * f], -1))
        descs.append(host(desc))
        sizes.append(host(scl) * f * 2.0)
        angles.append(host(angle))
        resps.append(host(resp))
    if not pts:
        z = np.zeros((0,), np.float32)
        return (np.zeros((0, 2), np.float32), np.zeros((0, 128), np.float32),
                z, z, z)
    cat = lambda a: np.concatenate(a).astype(np.float32)
    return cat(pts), cat(descs), cat(sizes), cat(angles), cat(resps)


def compact_octaves(results, k_total: int):
    """The valid keypoints of all octaves in input-image coordinates,
    compacted on the device to ``k_total`` (at least their count, or the
    last are dropped): (x, y, desc, ok)."""
    scale = [2.0 ** (r[8] - 1) for r in results]
    x_all = torch.cat([r[1] * s for r, s in zip(results, scale)])
    y_all = torch.cat([r[2] * s for r, s in zip(results, scale)])
    ok_all = torch.cat([r[0] for r in results])
    desc_all = torch.cat([r[7] for r in results])
    idx, ok = compact(ok_all, k_total)
    return x_all[idx], y_all[idx], desc_all[idx], ok


def match_device(ref_desc, ref_ok, tar_desc, tar_ok, ratio: float, *,
                 chunk: int = 4096):
    """Exact 2-NN L2 matching with Lowe's ratio test (the reference uses
    FLANN's approximate search, oc_sift.cpp:104-130), in row chunks.
    Returns (keep [N1] bool, best_idx [N1] int64).  Descriptors are
    integers in [0, 255], so every distance is an exact float32 integer
    whatever the summation order; among equal distances the lower index
    wins, as ``lax.top_k`` orders them."""
    n1 = ref_desc.shape[0]
    tt = torch.sum(tar_desc * tar_desc, dim=1)[None, :]
    bad = torch.full((), 3.4e38, dtype=_F, device=ref_desc.device)
    ratio = f32(ratio)
    keeps, idxs = [], []
    for lo in range(0, n1, chunk):
        r = ref_desc[lo: lo + chunk]
        rr = torch.sum(r * r, dim=1, keepdim=True)
        d2 = torch.clamp(rr + tt - 2.0 * (r @ tar_desc.T), min=0.0)
        d2 = torch.where(tar_ok[None, :], d2, bad)
        i1 = torch.argmin(d2, dim=1)
        rows = torch.arange(d2.shape[0], device=d2.device)
        d_first = d2[rows, i1]
        d2[rows, i1] = float("inf")
        d_second = d2.min(dim=1).values
        keep = ref_ok[lo: lo + chunk] & (
            torch.sqrt(d_first) < ratio * torch.sqrt(d_second))
        keeps.append(keep)
        idxs.append(i1)
    return torch.cat(keeps), torch.cat(idxs)
