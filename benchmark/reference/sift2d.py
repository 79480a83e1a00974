"""Plain SIFT2D: OpenCV's SIFT detector and descriptor (what OpenCorr's
SIFT2D calls, oc_sift.cpp:60-130; D. Lowe, IJCV 60(2):91-110, 2004) and an
exact 2-NN match with Lowe's ratio test.

Written from OpenCV's sift.cpp: a doubled first octave pre-blurred to
sigma, n + 3 Gaussian layers an octave with reflect-101 borders and
Gaussian kernels of round(8 sigma + 1) | 1 taps held as floats, the
contrast threshold scaled by the layers, extrema over 26 neighbours past
a 5-pixel border, 5 quadratic interpolation steps, the contrast and edge
tests, an orientation histogram of 36 bins smoothed by [1 4 6 4 1] / 16
with peaks above 0.8 of its maximum, and the 4 x 4 x 8 descriptor with
trilinear binning, the 0.2 clip and the 512 scale with uchar
saturation.  Keypoint positions, like OpenCV's ``KeyPoint.pt``, are
floats (float32).  Where the port departs from OpenCV it documents a rule
of its own (``opencorr_tpu_torch/ops/sift2d.py``, ``models/sift2d.py``),
and this file follows that rule:

* the doubled base is a bilinear resize with half-pixel centres and edge
  clamping; gradient angles and weights use exact ``atan2`` and ``exp``;
* a keypoint gives at most 3 orientations, the highest peak first (the
  lower bin first among equal heights);
* every extremum, keypoint and orientation instance is kept, as OpenCV
  keeps them with ``nfeatures`` 0; the instances are listed in octave
  order and, within an octave, in scan order (layer, row, column; a
  keypoint's orientations together);
* matching searches every target keypoint exactly (OpenCV's FLANN is
  approximate), the lower index first among equal distances.

Everything is computed in the given dtype (the reference in float64),
and nothing of the program is imported.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

IMG_BORDER = 5
MAX_INTERP_STEPS = 5
ORI_HIST_BINS = 36
ORI_SIG_FCTR = 1.5
ORI_RADIUS = 3 * ORI_SIG_FCTR
ORI_PEAK_RATIO = float(np.float32(0.8))
DESCR_WIDTH = 4
DESCR_HIST_BINS = 8
DESCR_SCL_FCTR = 3.0
DESCR_MAG_THR = float(np.float32(0.2))
INT_DESCR_FCTR = 512.0
MAX_PEAKS = 3
FLT_EPSILON = float(np.finfo(np.float32).eps)
INT_MAX_3 = float((2 ** 31 - 1) // 3)
# OpenCV's float constants, as floats hold them
IMG_SCALE = float(np.float32(1.0 / 255.0))
DERIV_SCALE = float(np.float32(IMG_SCALE) * np.float32(0.5))
CROSS_SCALE = float(np.float32(IMG_SCALE) * np.float32(0.25))


def as_float32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the nearest float32 value, in its own dtype."""
    return t.to(torch.float32).to(t.dtype)


def gaussian_taps(sigma: float) -> list:
    """cv::getGaussianKernel for float images: round(8 sigma + 1) | 1
    taps, normalised, held as floats."""
    ksize = int(round(sigma * 8 + 1)) | 1
    x = np.arange(ksize, dtype=np.float64) - ksize // 2
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return [float(v) for v in (k / k.sum()).astype(np.float32)]


def blur(img: torch.Tensor, taps: list) -> torch.Tensor:
    """Separable convolution with reflect-101 borders, along rows (axis 0)
    and then along columns."""
    half = len(taps) // 2
    for dim in (0, 1):
        n = img.shape[dim]
        i = torch.arange(-half, n + half, device=img.device)
        period = 2 * (n - 1)
        m = torch.remainder(i, period)
        padded = img.index_select(dim, torch.where(m >= n, period - m, m))
        img = sum(t * padded.narrow(dim, k, n) for k, t in enumerate(taps))
    return img


def upscale2x(img: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x resize, half-pixel centres, edges clamped: output 2i
    is 3/4 of input i and 1/4 of input i - 1, output 2i + 1 3/4 of i and
    1/4 of i + 1."""
    for dim in (0, 1):
        n = img.shape[dim]
        i = torch.arange(n, device=img.device)
        prev = img.index_select(dim, torch.clamp(i - 1, min=0))
        nxt = img.index_select(dim, torch.clamp(i + 1, max=n - 1))
        pair = torch.stack([0.75 * img + 0.25 * prev,
                            0.75 * img + 0.25 * nxt], dim + 1)
        shape = list(img.shape)
        shape[dim] = 2 * n
        img = pair.reshape(shape)
    return img


def octave_count(h: int, w: int) -> int:
    """Octaves of the doubled pyramid: round(log2(2 min(h, w)) - 2) + 1."""
    return max(int(round(math.log2(2 * min(h, w)) - 2)) + 1, 1)


def layer_sigmas(sigma: float, layers: int) -> list:
    """The blur that takes each Gaussian layer of an octave to the next."""
    k = 2.0 ** (1.0 / layers)
    out = [sigma]
    for i in range(1, layers + 3):
        prev = sigma * k ** (i - 1)
        out.append(math.sqrt((prev * k) ** 2 - prev ** 2))
    return out


def _cube(dog, layer, r, c):
    """[K, 3, 3, 3] neighbourhoods (layer, row, column) about each point."""
    o = torch.arange(-1, 2, device=dog.device)
    return dog[(layer[:, None] + o)[:, :, None, None],
               (r[:, None] + o)[:, None, :, None],
               (c[:, None] + o)[:, None, None, :]]


def _derivatives(v):
    """(gradient [K, 3] in x, y, layer; Hessian [K, 3, 3]) at the centre."""
    d = torch.stack([(v[:, 1, 1, 2] - v[:, 1, 1, 0]) * DERIV_SCALE,
                     (v[:, 1, 2, 1] - v[:, 1, 0, 1]) * DERIV_SCALE,
                     (v[:, 2, 1, 1] - v[:, 0, 1, 1]) * DERIV_SCALE], -1)
    v2 = v[:, 1, 1, 1] * 2.0
    dxx = (v[:, 1, 1, 2] + v[:, 1, 1, 0] - v2) * IMG_SCALE
    dyy = (v[:, 1, 2, 1] + v[:, 1, 0, 1] - v2) * IMG_SCALE
    dss = (v[:, 2, 1, 1] + v[:, 0, 1, 1] - v2) * IMG_SCALE
    dxy = (v[:, 1, 2, 2] - v[:, 1, 2, 0] - v[:, 1, 0, 2]
           + v[:, 1, 0, 0]) * CROSS_SCALE
    dxs = (v[:, 2, 1, 2] - v[:, 2, 1, 0] - v[:, 0, 1, 2]
           + v[:, 0, 1, 0]) * CROSS_SCALE
    dys = (v[:, 2, 2, 1] - v[:, 2, 0, 1] - v[:, 0, 2, 1]
           + v[:, 0, 0, 1]) * CROSS_SCALE
    hess = torch.stack([torch.stack([dxx, dxy, dxs], -1),
                        torch.stack([dxy, dyy, dys], -1),
                        torch.stack([dxs, dys, dss], -1)], -2)
    return d, hess


def candidates(dog, layers: int, contrast: float):
    """The scan-order extrema (layer, row, column) of the DoG stack: above
    the threshold, at least (at most) every one of their 26 neighbours,
    past the border."""
    _, h, w = dog.shape
    thr = math.floor(0.5 * contrast / layers * 255)
    top = F.max_pool3d(dog[None, None], 3, stride=1)[0, 0]
    low = -F.max_pool3d(-dog[None, None], 3, stride=1)[0, 0]
    mid = dog[1:1 + layers, 1:-1, 1:-1]
    ext = (mid.abs() > thr) & (((mid > 0) & (mid >= top))
                               | ((mid < 0) & (mid <= low)))
    found = torch.nonzero(ext)
    found[:, 1:] += 1
    b = IMG_BORDER
    inside = ((found[:, 1] >= b) & (found[:, 1] < h - b)
              & (found[:, 2] >= b) & (found[:, 2] < w - b))
    found = found[inside]
    return found[:, 0] + 1, found[:, 1], found[:, 2]


def refine(dog, layer, r, c, layers: int, contrast: float, edge: float):
    """adjustLocalExtrema: up to 5 steps of the quadratic fit, then the
    contrast and edge tests.  Returns (valid, layer, r, c, offset [K, 3]
    in x, y, layer)."""
    _, h, w = dog.shape
    alive = torch.ones_like(layer, dtype=torch.bool)
    done = torch.zeros_like(alive)
    off = torch.zeros((layer.shape[0], 3), dtype=dog.dtype,
                      device=dog.device)
    for _ in range(MAX_INTERP_STEPS):
        d, hess = _derivatives(_cube(dog, layer, r, c))
        sol, info = torch.linalg.solve_ex(hess, d)
        x = torch.where(info[:, None] == 0, -sol,
                        torch.full_like(sol, float("nan")))
        step = alive & ~done
        off = torch.where(step[:, None], x, off)
        converged = (x.abs() < 0.5).all(1)
        blown = ~torch.isfinite(x).all(1) | (x.abs() > INT_MAX_3).any(1)
        alive = alive & ~(step & blown)
        done = done | (step & converged & ~blown)
        move = step & ~converged & ~blown
        shift = torch.round(torch.nan_to_num(x).clamp(-INT_MAX_3, INT_MAX_3)
                            ).long()
        c2, r2, l2 = c + shift[:, 0], r + shift[:, 1], layer + shift[:, 2]
        inb = ((l2 >= 1) & (l2 <= layers) & (c2 >= IMG_BORDER)
               & (c2 < w - IMG_BORDER) & (r2 >= IMG_BORDER)
               & (r2 < h - IMG_BORDER))
        alive = alive & ~(move & ~inb)
        go = move & inb
        c = torch.where(go, c2, c)
        r = torch.where(go, r2, r)
        layer = torch.where(go, l2, layer)
    valid = alive & done
    v = _cube(dog, layer, r, c)
    d, hess = _derivatives(v)
    contr = v[:, 1, 1, 1] * IMG_SCALE + 0.5 * (d * off).sum(1)
    valid = valid & (contr.abs() * layers >= contrast)
    dxx, dyy, dxy = hess[:, 0, 0], hess[:, 1, 1], hess[:, 0, 1]
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    valid = valid & (det > 0) & (tr * tr * edge < (edge + 1) ** 2 * det)
    return valid, layer, r, c, off


def _window_gradients(gauss, layer, r, c, radius):
    """(dx, dy, inside) [K, 2R+1, 2R+1] of the windows of half-extent
    ``radius`` about (r, c) of each point's layer: central differences,
    ``inside`` where the pixel lies in the image's interior."""
    _, h, w = gauss.shape
    o = torch.arange(-radius, radius + 1, device=gauss.device)
    yy = r[:, None, None] + o[None, :, None]
    xx = c[:, None, None] + o[None, None, :]
    lay = layer[:, None, None]

    def at(y, x):
        return gauss[lay, y.clamp(0, h - 1), x.clamp(0, w - 1)]

    dx = at(yy, xx + 1) - at(yy, xx - 1)
    dy = at(yy - 1, xx) - at(yy + 1, xx)
    inside = (yy > 0) & (yy < h - 1) & (xx > 0) & (xx < w - 1)
    return dx, dy, inside, o.to(gauss.dtype)


def _degrees(dy, dx):
    ang = torch.rad2deg(torch.atan2(dy, dx))
    return torch.where(ang < 0, ang + 360.0, ang)


def orientations(gauss, layer, r, c, scl):
    """calcOrientationHist and its peaks: (angles [K, 3], ok [K, 3]),
    the highest peak first."""
    n = ORI_HIST_BINS
    k = layer.shape[0]
    radius = torch.round(ORI_RADIUS * scl)
    big = int(radius.max()) if k else 0
    dx, dy, inside, o = _window_gradients(gauss, layer, r, c, big)
    ii, jj = o[None, :, None], o[None, None, :]
    rad = radius[:, None, None]
    sig = ORI_SIG_FCTR * scl[:, None, None]
    ok = inside & (ii.abs() <= rad) & (jj.abs() <= rad)
    wgt = torch.exp((ii * ii + jj * jj) * (-1.0 / (2.0 * sig * sig)))
    mag = torch.where(ok, torch.sqrt(dx * dx + dy * dy) * wgt,
                      torch.zeros_like(dx))
    bins = torch.round(_degrees(dy, dx) * float(np.float32(n / 360.0))
                       ).long() % n
    hist = torch.zeros((k, n), dtype=gauss.dtype, device=gauss.device)
    hist.scatter_add_(1, bins.reshape(k, -1), mag.reshape(k, -1))
    roll = lambda s: torch.roll(hist, s, dims=1)
    hist = ((roll(2) + roll(-2)) * (1.0 / 16.0)
            + (roll(1) + roll(-1)) * (4.0 / 16.0) + hist * (6.0 / 16.0))
    left, right = torch.roll(hist, 1, dims=1), torch.roll(hist, -1, dims=1)
    thr = hist.max(dim=1, keepdim=True).values * ORI_PEAK_RATIO
    peak = (hist > left) & (hist > right) & (hist >= thr)
    order = torch.sort(torch.where(peak, hist, torch.full_like(hist, -1.0)),
                       dim=1, descending=True, stable=True).indices
    j = order[:, :MAX_PEAKS]
    ok = peak.gather(1, j)
    hl, hc, hr = (a.gather(1, j) for a in (left, hist, right))
    b = j.to(hist.dtype) + 0.5 * (hl - hr) / (hl - 2.0 * hc + hr)
    b = torch.where(b < 0, b + n, torch.where(b >= n, b - n, b))
    angle = 360.0 - (360.0 / n) * b
    angle = torch.where((angle - 360.0).abs() < FLT_EPSILON,
                        torch.zeros_like(angle), angle)
    return angle, ok


def descriptors(gauss, layer, yo, xo, scl, angle):
    """calcSIFTDescriptor: [K, 128] of the instances at the float octave
    positions (xo, yo)."""
    d, nb = DESCR_WIDTH, DESCR_HIST_BINS
    _, h, w = gauss.shape
    k = layer.shape[0]
    r, c = torch.round(yo).long(), torch.round(xo).long()
    ori = 360.0 - angle
    ori = torch.where((ori - 360.0).abs() < FLT_EPSILON,
                      torch.zeros_like(ori), ori)
    width = DESCR_SCL_FCTR * scl
    radius = torch.round(width * float(np.float32(math.sqrt(2.0)))
                         * (d + 1) * 0.5)
    radius = torch.clamp(radius, max=float(int(math.sqrt(h * h + w * w))))
    cos_t = (torch.cos(torch.deg2rad(ori)) / width)[:, None, None]
    sin_t = (torch.sin(torch.deg2rad(ori)) / width)[:, None, None]
    big = int(radius.max())
    o = torch.arange(-big, big + 1, device=gauss.device)
    ii, jj = o[None, :, None], o[None, None, :]
    c_rot = jj * cos_t - ii * sin_t
    r_rot = jj * sin_t + ii * cos_t
    rbin = r_rot + (d / 2 - 0.5)
    cbin = c_rot + (d / 2 - 0.5)
    yy = r[:, None, None] + ii
    xx = c[:, None, None] + jj
    rad = radius[:, None, None]
    ok = ((ii.abs() <= rad) & (jj.abs() <= rad) & (rbin > -1) & (rbin < d)
          & (cbin > -1) & (cbin < d) & (yy > 0) & (yy < h - 1) & (xx > 0)
          & (xx < w - 1))
    # the samples that count, one entry each
    kk = torch.nonzero(ok)[:, 0]
    y, x, lay = yy.expand_as(ok)[ok], xx.expand_as(ok)[ok], layer[kk]
    dx = gauss[lay, y, x + 1] - gauss[lay, y, x - 1]
    dy = gauss[lay, y - 1, x] - gauss[lay, y + 1, x]
    rb, cb, cr, rr = rbin[ok], cbin[ok], c_rot[ok], r_rot[ok]
    ob = (_degrees(dy, dx) - ori[kk]) * float(np.float32(nb / 360.0))
    mag = torch.sqrt(dx * dx + dy * dy) * torch.exp(
        (cr * cr + rr * rr) * (-1.0 / (d * d * 0.5)))
    # trilinear: each sample adds to the two nearest bins of each axis,
    # the orientation's wrapping; spatial bins past the grid are dropped
    r0, c0, o0 = torch.floor(rb), torch.floor(cb), torch.floor(ob)
    fr, fc, fo = rb - r0, cb - c0, ob - o0
    r0, c0, o0 = r0.long(), c0.long(), o0.long() % nb
    hist = torch.zeros(k * d * d * nb + 1, dtype=gauss.dtype,
                       device=gauss.device)
    for dr in (0, 1):
        for dc in (0, 1):
            for do in (0, 1):
                rbi, cbi = r0 + dr, c0 + dc
                keep = (rbi >= 0) & (rbi < d) & (cbi >= 0) & (cbi < d)
                slot = kk * (d * d * nb) + (rbi * d + cbi) * nb + (
                    (o0 + do) % nb)
                wgt = (mag * (fr if dr else 1.0 - fr)
                       * (fc if dc else 1.0 - fc) * (fo if do else 1.0 - fo))
                hist.index_add_(0, torch.where(keep, slot, hist.shape[0] - 1),
                                wgt)
    desc = hist[:-1].reshape(k, d * d * nb)
    desc = torch.minimum(desc, desc.norm(dim=1, keepdim=True) * DESCR_MAG_THR)
    scale = INT_DESCR_FCTR / torch.clamp(desc.norm(dim=1, keepdim=True),
                                         min=FLT_EPSILON)
    return torch.clamp(torch.round(desc * scale), 0.0, 255.0)


def _chunks(n: int, size: int):
    return [slice(i, min(i + size, n)) for i in range(0, n, size)]


def octave(gauss, dog, layers, contrast, edge, sigma, chunk=512):
    """One octave: (x, y, descriptors) of its orientation instances, in
    octave coordinates, and its counts."""
    layer, r, c = candidates(dog, layers, contrast)
    found = layer.shape[0]
    valid, layer, r, c, off = refine(dog, layer, r, c, layers, contrast,
                                     edge)
    keep = torch.nonzero(valid)[:, 0]
    layer, r, c, off = layer[keep], r[keep], c[keep], off[keep]
    scl = sigma * 2.0 ** ((layer.to(dog.dtype) + off[:, 2]) / layers)
    xo = as_float32(c.to(dog.dtype) + off[:, 0])
    yo = as_float32(r.to(dog.dtype) + off[:, 1])
    angle = torch.zeros((keep.shape[0], MAX_PEAKS), dtype=dog.dtype,
                        device=dog.device)
    peak = torch.zeros(angle.shape, dtype=torch.bool, device=dog.device)
    for s in _chunks(keep.shape[0], 8 * chunk):
        angle[s], peak[s] = orientations(gauss, layer[s], r[s], c[s], scl[s])
    inst = torch.nonzero(peak.reshape(-1))[:, 0]
    counts = dict(candidates=found, keypoints=keep.shape[0],
                  instances=inst.shape[0])
    src = inst // MAX_PEAKS
    ang = angle.reshape(-1)[inst]
    desc = torch.zeros((inst.shape[0], 128), dtype=dog.dtype,
                       device=dog.device)
    for s in _chunks(inst.shape[0], chunk):
        i = src[s]
        desc[s] = descriptors(gauss, layer[i], yo[i], xo[i], scl[i], ang[s])
    return xo[src], yo[src], desc, counts


def detect(img_u8, dtype, device, layers=3, contrast=0.04, edge=10.0,
           sigma=1.6):
    """SIFT on one 8-bit image [H, W]: (points [K, 2] (x, y) in image
    coordinates, float32 values; descriptors [K, 128]; per-octave
    counts)."""
    img = torch.as_tensor(np.asarray(img_u8), device=device).to(dtype)
    h, w = img.shape
    sigmas = layer_sigmas(sigma, layers)
    base = blur(upscale2x(img), gaussian_taps(
        math.sqrt(max(sigma * sigma - 1.0, 0.01))))
    pts, descs, counts = [], [], []
    for o in range(octave_count(h, w)):
        hh, ww = base.shape
        if min(hh, ww) < 2 * IMG_BORDER + 2:
            break
        stack = [base]
        for s in sigmas[1:]:
            stack.append(blur(stack[-1], gaussian_taps(s)))
        gauss = torch.stack(stack)
        x, y, desc, cnt = octave(gauss, gauss[1:] - gauss[:-1], layers,
                                 contrast, edge, sigma)
        f = 2.0 ** (o - 1)
        pts.append(torch.stack([x * f, y * f], -1))
        descs.append(desc)
        counts.append(dict(octave=o, shape=[hh, ww], **cnt))
        base = gauss[layers][::2, ::2]
    return torch.cat(pts), torch.cat(descs), counts


def match(ref_desc, tar_desc, ratio: float, rows: int = 2048):
    """Exact nearest target of every reference descriptor and Lowe's ratio
    test on the two nearest: (keep [K] bool, nearest [K])."""
    tt = (tar_desc * tar_desc).sum(1)[None, :]
    keeps, nearest = [], []
    for s in _chunks(ref_desc.shape[0], rows):
        r = ref_desc[s]
        d2 = torch.clamp((r * r).sum(1, keepdim=True) + tt
                         - 2.0 * (r @ tar_desc.T), min=0.0)
        first = torch.argmin(d2, dim=1)
        rows_ = torch.arange(d2.shape[0], device=d2.device)
        best = d2[rows_, first]
        d2[rows_, first] = float("inf")
        second = d2.min(dim=1).values
        keeps.append(torch.sqrt(best) < ratio * torch.sqrt(second))
        nearest.append(first)
    return torch.cat(keeps), torch.cat(nearest)


def sift_matches(ref_u8, tar_u8, cfg: dict, dtype, device):
    """The matched keypoints of a pair: (ref [M, 2], tar [M, 2], counts of
    both images' octaves)."""
    kw = dict(layers=cfg["n_octave_layers"],
              contrast=cfg["contrast_threshold"],
              edge=cfg["edge_threshold"], sigma=cfg["sigma"])
    rp, rd, rc = detect(ref_u8, dtype, device, **kw)
    tp, td, tc = detect(tar_u8, dtype, device, **kw)
    keep, nearest = match(rd, td, float(np.float32(cfg["matching_ratio"])))
    return rp[keep], tp[nearest[keep]], rc + tc
