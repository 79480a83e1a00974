"""3D SIFT (B. Rister et al., IEEE TIP 26(10) 4900-4910, after the
reference's ``oc_sift.cpp``): pyramid, extrema, orientation, the exact
descriptor and matching, in PyTorch.

Pipeline (reference lines in parentheses):

* Gaussian pyramid: separable mirror-padded blur with the reference's taps
  (gaussianBlur :365-548), stride-2 downsampling (:549-562).
* DoG layers and their max |DoG| (:756-793).
* Extrema: strict max/min over 6 spatial and 2 scale neighbours above
  alpha * max|DoG| (detectExtrema :795-847), compacted in scan order.
* Orientation: eigenvectors of the Gaussian-weighted gradient structure
  tensor in a spherical window, rejecting weak gradients and ambiguous
  eigenvalues or angles (assignOrientation :849-1050).
* Descriptor: 4x4x4 sub-cubes x 12 icosahedron vertices = 768 bins
  (constructDescriptor :1051-1250).  :func:`construct_descriptor` is the
  exact Moller-Trumbore path; layers whose crop fits take the fused
  histogram of ``ops/desc3d.py`` instead (kernel 4).
* Matching: masked 2-NN over squared descriptor distances.

Every function keeps the JAX package's operation order, so the pyramid, the
extrema and the compaction agree exactly with it on the same inputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.precision import bf16_round, f32, fma

IMG_BORDER = 1  # oc_sift.h:22

# Icosahedron triangle tiles (oc_sift.cpp:209-232): vertex indices and vertex
# coordinates per triangle.
_T = 0.5257311
_S = 0.8506508
ICOSA_TRIPLETS = np.array(
    [
        [1, 0, 8], [8, 0, 4], [4, 0, 5], [5, 0, 9], [9, 0, 1],
        [6, 1, 8], [6, 8, 10], [10, 8, 4], [10, 4, 2], [2, 4, 5],
        [2, 5, 11], [11, 5, 9], [11, 9, 7], [7, 9, 1], [7, 1, 6],
        [6, 3, 7], [7, 3, 11], [11, 3, 2], [2, 3, 10], [10, 3, 6],
    ],
    np.int32,
)
ICOSA_VERTICES = np.array(
    [
        [0, _T, _S], [0, -_T, _S], [0, _T, -_S], [0, -_T, -_S],
        [_T, _S, 0], [-_T, _S, 0], [_T, -_S, 0], [-_T, -_S, 0],
        [_S, 0, _T], [-_S, 0, _T], [_S, 0, -_T], [-_S, 0, -_T],
    ],
    np.float32,
)

F32_EPS = float(np.finfo(np.float32).eps)
EPS10 = float(np.float32(F32_EPS) * np.float32(10.0))  # oc_sift.cpp threshold
# keypoint-voxels of one slab of the exact descriptor's histogram
SLAB_ELEMS = 1 << 20


# --- pyramid ----------------------------------------------------------------

def _reflect_index(n: int, r: int, device) -> torch.Tensor:
    """Source indices of an axis of length ``n`` padded by ``r`` on each side
    in numpy's "reflect" mode (edge not repeated, reflected again past the
    far edge)."""
    i = torch.arange(-r, n + r, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    m = i.abs() % period
    return torch.where(m < n, m, period - m)


def blur_taps(sigma: float, unit_xyz) -> list:
    """Per-axis (axis, radius, taps) of the separable blur: kernel radius
    ceil(3 sigma) (at least 1) scaled by unit_max/unit_axis, taps
    exp(-0.5 (i/sigma)^2) normalised (oc_sift.cpp:365-548)."""
    unit_max = max(unit_xyz)
    if sigma > 0:
        kernel_radius = max(int(math.ceil(3.0 * sigma)), 1)
    else:
        sigma = 0.0
        kernel_radius = 1
    out = []
    for axis, unit in ((2, unit_xyz[0]), (1, unit_xyz[1]), (0, unit_xyz[2])):
        radius = kernel_radius * int(math.floor(unit_max / unit + 0.5))
        taps = np.ones(radius + 1, np.float32)
        for i in range(1, radius + 1):
            x = i / (sigma + np.finfo(np.float32).eps)
            taps[i] = math.exp(-0.5 * x * x)
            taps[0] += taps[i] * 2.0
        taps[0] = 1.0 / taps[0]
        taps[1:] *= taps[0]
        out.append((axis, radius, [float(t) for t in taps]))
    return out


def gaussian_blur(vol: torch.Tensor, sigma: float, unit_xyz) -> torch.Tensor:
    """Separable mirror-extension blur: per axis, t0 * v plus, for each
    r >= 1, t_r * (v[-r] + v[+r]) in increasing r.

    The JAX package's blur, as XLA compiles it for the CPU, rounds the tap
    sum as fused multiply-adds: fma(t0, v, t1 * side_1) (the second product
    rounded), then fma(t_r, side_r, acc).  The port computes exactly those
    operations on every device, so it reproduces the JAX package on the
    CPU and the card reproduces the CPU."""
    out = vol
    for axis, radius, taps in blur_taps(sigma, unit_xyz):
        n = out.shape[axis]
        padded = out.index_select(axis, _reflect_index(n, radius, out.device))

        def side(r):
            return padded.narrow(axis, radius - r, n) \
                + padded.narrow(axis, radius + r, n)

        acc = fma(taps[0], out, side(1).mul_(taps[1]))
        for r in range(2, radius + 1):
            acc = fma(taps[r], side(r), acc)
        del padded
        out = acc
    return out


def downsample(vol: torch.Tensor, dst_shape) -> torch.Tensor:
    """Stride-2 sampling (oc_sift.cpp:549-562)."""
    dz, dy, dx = dst_shape
    return vol[: 2 * dz: 2, : 2 * dy: 2, : 2 * dx: 2].contiguous()


def dog_layer(upper: torch.Tensor, lower: torch.Tensor):
    d = upper - lower
    return d, d.abs().max()


def octave_stack(seed: torch.Tensor, *, sigmas, unit_xyz, downsample_to=None):
    """An octave: optional stride-2 downsample of the seed, the blur chain
    (``sigmas[i]`` is layer i's incremental blur, None for a downsampled
    layer 0), every DoG layer and its max|.|.  Returns (gaussians, dogs,
    max_abs), lists of tensors."""
    if downsample_to is not None:
        seed = downsample(seed, downsample_to)
    g = []
    for i, s in enumerate(sigmas):
        g.append(seed if s is None else
                 gaussian_blur(g[i - 1] if i else seed, s, unit_xyz))
    dogs, max_abs = [], []
    for i in range(len(g) - 1):
        d, m = dog_layer(g[i + 1], g[i])
        dogs.append(d)
        max_abs.append(m)
    return g, dogs, max_abs


# --- extrema ----------------------------------------------------------------

def extrema_mask(dog_prev, dog_cur, dog_next, alpha_max_abs) -> torch.Tensor:
    """Strict 8-neighbour extremum mask (detectExtrema, oc_sift.cpp:795-847);
    the 1-voxel border is False."""
    v = dog_cur
    big = v.abs() >= alpha_max_abs
    gt = big.clone()
    lt = big
    shifts = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
              (0, 0, -1))
    for sh in shifts:
        nb = torch.roll(dog_cur, sh, dims=(0, 1, 2))
        gt &= v > nb
        lt &= v < nb
        del nb
    for nb in (dog_prev, dog_next):
        gt &= v > nb
        lt &= v < nb
    mask = gt | lt
    b = IMG_BORDER
    mask[:b] = False
    mask[-b:] = False
    mask[:, :b] = False
    mask[:, -b:] = False
    mask[:, :, :b] = False
    mask[:, :, -b:] = False
    return mask


def compact_count(mask: torch.Tensor, k: int):
    """Indices of the first k set elements of a flat ``mask`` in scan order:
    (idx [k] int64, ok [k] bool, count).  Slots past the population hold
    the clamped index n-1 and ok=False; ``count`` is the population before
    the cap (one host sync)."""
    n = mask.shape[0]
    found = torch.nonzero(mask).reshape(-1)
    count = int(found.numel())
    idx = torch.full((k,), n - 1, dtype=torch.int64, device=mask.device)
    m = min(count, k)
    idx[:m] = found[:m]
    ok = torch.arange(k, device=mask.device) < count
    return idx, ok, count


def _compact(mask: torch.Tensor, k: int):
    """(idx [k], ok [k]) of :func:`compact_count`."""
    idx, ok, _ = compact_count(mask, k)
    return idx, ok


def extrema_compact(dog_prev, dog_cur, dog_next, alpha_max_abs, *, k_cap):
    """Extremum mask -> the first k_cap candidate coordinates in scan
    (z-major) order: (x, y, z int64 [k_cap], ok [k_cap], count before the
    cap)."""
    mask = extrema_mask(dog_prev, dog_cur, dog_next, alpha_max_abs)
    idx, ok, count = compact_count(mask.reshape(-1), k_cap)
    _, dy, dx = dog_cur.shape
    z = idx // (dy * dx)
    rem = idx % (dy * dx)
    return rem % dx, rem // dx, z, ok, count


# --- orientation ------------------------------------------------------------

def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _sym_eigh_desc_3x3(a: torch.Tensor):
    """Closed-form eigendecomposition of symmetric [..., 3, 3]: eigenvalues
    in DESCENDING order and unit eigenvectors [..., 3(vec), 3(comp)]."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a11, a12, a22 = a[..., 1, 1], a[..., 1, 2], a[..., 2, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2, min=1e-30) / 6.0)
    inv_p = 1.0 / p
    b00 = (a00 - q) * inv_p
    b01 = a01 * inv_p
    b02 = a02 * inv_p
    b11 = (a11 - q) * inv_p
    b12 = a12 * inv_p
    b22 = (a22 - q) * inv_p
    detb = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l1 = q + 2.0 * p * torch.cos(phi)
    l3 = q + 2.0 * p * torch.cos(phi + f32(2.0 * math.pi / 3.0))
    l2 = 3.0 * q - l1 - l3

    def eigvec(lam):
        # rows of (A - lam I); eigenvector = the largest cross product
        r0 = torch.stack([a00 - lam, a01, a02], -1)
        r1 = torch.stack([a01, a11 - lam, a12], -1)
        r2 = torch.stack([a02, a12, a22 - lam], -1)
        cands = torch.stack([_cross(r0, r1), _cross(r0, r2), _cross(r1, r2)],
                            -2)  # [..., 3cand, 3]
        norms = (cands * cands).sum(-1)
        best = torch.argmax(norms, dim=-1)
        v = torch.gather(cands, -2, best[..., None, None].expand(
            *best.shape, 1, 3))[..., 0, :]
        return v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True),
                                          min=1e-30))

    vecs = torch.stack([eigvec(l1), eigvec(l2), eigvec(l3)], -2)
    vals = torch.stack([l1, l2, l3], -1)
    return vals, vecs


def _sh(win, dz, dy, dx):
    return torch.roll(win, (dz, dy, dx), dims=(1, 2, 3))


def _axis_coords(c0, s):
    return c0[:, None] + torch.arange(s, device=c0.device)[None, :]


def assign_orientation(win, x0, y0, z0, xi, yi, zi, dims, scale, units,
                       grad_threshold, beta, gamma):
    """Orientation of K keypoints from pre-gathered windows.

    win [K, s, s, s] (clamped starts x0, y0, z0 [K]); xi, yi, zi [K]
    keypoint coordinates in the layer; dims (dx, dy, dz); ``scale`` the
    layer's physical scale; ``units`` its voxel pitch (ux, uy, uz).
    Returns (rot [K, 3, 3] with rows as in the reference, ok [K])."""
    dx, dy, dz = (int(d) for d in dims)
    ux, uy, uz = (f32(u) for u in units)
    s = win.shape[1]
    k = win.shape[0]
    zc, yc, xc = _axis_coords(z0, s), _axis_coords(y0, s), _axis_coords(x0, s)
    inbz = (zc >= IMG_BORDER) & (zc <= dz - 1 - IMG_BORDER)
    inby = (yc >= IMG_BORDER) & (yc <= dy - 1 - IMG_BORDER)
    inbx = (xc >= IMG_BORDER) & (xc <= dx - 1 - IMG_BORDER)

    sigma_w = np.float32(1.5) * np.float32(scale)
    wrad = np.float32(3.0) * sigma_w
    fl = torch.float32
    px = (xc.to(fl) - xi.to(fl)[:, None]) * ux
    py = (yc.to(fl) - yi.to(fl)[:, None]) * uy
    pz = (zc.to(fl) - zi.to(fl)[:, None]) * uz
    # separable Gaussian exp(-0.5 d2/s^2) = ex*ey*ez, border masks folded in
    inv2s2 = float(np.float32(-0.5) / (sigma_w * sigma_w))
    ex = torch.exp(inv2s2 * px * px) * inbx
    ey = torch.exp(inv2s2 * py * py) * inby
    ez = torch.exp(inv2s2 * pz * pz) * inbz

    # central differences 0.5 (I[k+1] - I[k-1]) (oc_sift.cpp:905-907):
    # _sh(+1)[x] = win[x-1], so the positive side is the -1 shift
    gxv = 0.5 * (_sh(win, 0, 0, -1) - _sh(win, 0, 0, 1)) / ux
    gyv = 0.5 * (_sh(win, 0, -1, 0) - _sh(win, 0, 1, 0)) / uy
    gzv = 0.5 * (_sh(win, -1, 0, 0) - _sh(win, 1, 0, 0)) / uz

    cyx = s * s
    gxf, gyf, gzf = (a.reshape(k, s, cyx) for a in (gxv, gyv, gzv))
    del gxv, gyv, gzv
    wyx = (ey[:, :, None] * ex[:, None, :]).reshape(k, cyx)
    pyx2 = (py[:, :, None] ** 2 + px[:, None, :] ** 2).reshape(k, cyx)
    sphere = (pz[:, :, None] ** 2 + pyx2[:, None, :]) <= float(wrad * wrad)
    weight = ez[:, :, None] * wyx[:, None, :] * sphere
    del sphere

    axes = (1, 2)
    sxx = (gxf * gxf * weight).sum(axes)
    sxy = (gxf * gyf * weight).sum(axes)
    sxz = (gxf * gzf * weight).sum(axes)
    syy = (gyf * gyf * weight).sum(axes)
    syz = (gyf * gzf * weight).sum(axes)
    szz = (gzf * gzf * weight).sum(axes)
    st = torch.stack([torch.stack([sxx, sxy, sxz], -1),
                      torch.stack([sxy, syy, syz], -1),
                      torch.stack([sxz, syz, szz], -1)], -2)
    d_vec = torch.stack([(gxf * weight).sum(axes), (gyf * weight).sum(axes),
                         (gzf * weight).sum(axes)], -1)
    del gxf, gyf, gzf, weight

    dd = (d_vec * d_vec).sum(-1)
    ok = dd >= f32(grad_threshold)
    vals, vecs = _sym_eigh_desc_3x3(st)
    l1, l2, l3 = vals[:, 0], vals[:, 1], vals[:, 2]
    beta, gamma = f32(beta), f32(gamma)
    ok = ok & ~((l2 / l1 > beta) | (l3 / l2 > beta)
                | ((l1 - l2).abs() < F32_EPS) | ((l2 - l3).abs() < F32_EPS)
                | ((l3 - l1).abs() < F32_EPS))
    dn = torch.sqrt(torch.clamp(dd, min=1e-30))
    q1, q2 = vecs[:, 0], vecs[:, 1]
    qd1 = (q1 * d_vec).sum(-1)
    qd2 = (q2 * d_vec).sum(-1)
    cos_phi = torch.minimum(qd1.abs() / dn, qd2.abs() / dn)
    ok = ok & (cos_phi >= gamma)
    one = torch.ones_like(qd1)
    r1 = q1 * torch.where(qd1 > 0, one, -one)[:, None]
    r2 = q2 * torch.where(qd2 > 0, one, -one)[:, None]
    rot = torch.stack([r1, r2, _cross(r1, r2)], -2)  # oc_sift.cpp:1015-1027
    return rot, ok


def gather_windows_3d(vol: torch.Tensor, xi, yi, zi, r: int):
    """[K, s, s, s] windows (s = 2r+1) with starts clamped into the volume:
    (win, x0, y0, z0)."""
    s = 2 * r + 1
    dz, dy, dx = vol.shape
    x0 = torch.clamp(xi - r, 0, dx - s)
    y0 = torch.clamp(yi - r, 0, dy - s)
    z0 = torch.clamp(zi - r, 0, dz - s)
    zz, yy, xx = (_axis_coords(a.long(), s) for a in (z0, y0, x0))
    flat = ((zz[:, :, None, None] * dy + yy[:, None, :, None]) * dx
            + xx[:, None, None, :])
    return vol.reshape(-1)[flat], x0, y0, z0


def _chunk_len(per_item_bytes: int, budget: int, n: int) -> int:
    return max(1, min(n, budget // max(per_item_bytes, 1)))


def work_budget(device: torch.device) -> int:
    """Bytes the per-keypoint stages may fill at once: a tenth of the card's
    memory, 1 GiB on the CPU."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[1] // 10
    return 1 << 30


def orient_keypoints(vol, xi, yi, zi, scale, unit_xyz, grad_threshold, beta,
                     gamma, *, r):
    """Window gather + :func:`assign_orientation` over the given (live)
    keypoints, in chunks sized from :func:`work_budget`.  Returns
    (rot [K, 3, 3], ok [K])."""
    dz, dy, dx = vol.shape
    n = xi.shape[0]
    s = 2 * r + 1
    chunk = _chunk_len(s ** 3 * 4 * 24, work_budget(vol.device), n)
    rots, oks = [], []
    for lo in range(0, n, chunk):
        sl = slice(lo, lo + chunk)
        win, x0, y0, z0 = gather_windows_3d(vol, xi[sl], yi[sl], zi[sl], r)
        rot, ok = assign_orientation(win, x0, y0, z0, xi[sl], yi[sl], zi[sl],
                                     (dx, dy, dz), scale, unit_xyz,
                                     grad_threshold, beta, gamma)
        rots.append(rot)
        oks.append(ok)
    if not rots:
        return (torch.zeros((0, 3, 3), device=vol.device),
                torch.zeros((0,), dtype=torch.bool, device=vol.device))
    return torch.cat(rots), torch.cat(oks)


# --- the exact (einsum) descriptor -----------------------------------------

def _sphere_crop(r, scale, unit_xyz):
    """Per-axis active radii (z, y, x) of the descriptor sphere: window
    voxels with |offset_axis| * unit > 2 sigma = 10 sqrt(2) scale contribute
    exactly zero (+1 voxel float safety), capped at the window radius r."""
    rad = 2.0 * 5.0 * math.sqrt(2.0) * float(scale)
    return tuple(min(r, int(rad / u) + 1) for u in
                 (unit_xyz[2], unit_xyz[1], unit_xyz[0]))


def _triangle_tables(device):
    """Per-triangle constants of the Moller-Trumbore search, [20, 3] each
    (e1, e2, tv, qv, v1, v2, v3) and qe2 [20], float32 as the JAX package
    builds them."""
    verts, tri = ICOSA_VERTICES, ICOSA_TRIPLETS
    rows = {k: [] for k in ("e1", "e2", "tv", "qv", "v1", "v2", "v3", "qe2")}
    for t in range(20):
        v1, v2, v3 = verts[tri[t, 0]], verts[tri[t, 1]], verts[tri[t, 2]]
        e1 = v2 - v1
        e2 = v3 - v1
        tv = -v1
        qv = np.cross(tv, e1).astype(np.float32)
        for key, val in (("e1", e1), ("e2", e2), ("tv", tv), ("qv", qv),
                         ("v1", v1), ("v2", v2), ("v3", v3)):
            rows[key].append(val)
        rows["qe2"].append(np.float32(np.dot(qv, e2)))
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
            for k, v in rows.items()}


def _tent(sub):
    """4-bin tent weights [..., 4] with the reference's (int) truncation
    quirk: bin trunc(sub) gets 1 - frac, the next gets frac, frac from floor
    (oc_sift.cpp:1184-1199)."""
    a4 = torch.arange(4, dtype=torch.float32, device=sub.device)
    i = sub.to(torch.int32).to(torch.float32)[..., None]
    dfrac = (sub - torch.floor(sub))[..., None]
    return (a4 == i) * (1.0 - dfrac) + (a4 == i + 1.0) * dfrac


def _crop_slice(a, c0, csz):
    """Per-keypoint [K, cz, cy, cx] boxes of ``a`` [K, s, s, s] at starts
    c0 = (z, y, x) [K] each."""
    k = a.shape[0]
    kk = torch.arange(k, device=a.device)[:, None, None, None]
    zz, yy, xx = (_axis_coords(c, n) for c, n in zip(c0, csz))
    return a[kk, zz[:, :, None, None], yy[:, None, :, None],
             xx[:, None, None, :]]


def _normalise(desc, truncate):
    """normalize -> truncate -> normalize (oc_sift.cpp:1217-1248)."""
    desc = desc / (torch.sqrt((desc * desc).sum(-1, keepdim=True)) + F32_EPS)
    desc = torch.clamp(desc, max=f32(truncate))
    return desc / (torch.sqrt((desc * desc).sum(-1, keepdim=True)) + F32_EPS)


def construct_descriptor(win, x0, y0, z0, xi, yi, zi, dims, rot, scale,
                         units, truncate, parts: str = "full", crop=None,
                         hist_bf16: bool = False) -> torch.Tensor:
    """[K, 768] descriptors from pre-gathered windows (constructDescriptor,
    oc_sift.cpp:1051-1250): gradients rotated into the keypoint frame,
    soft-assigned barycentrically onto the first icosahedron triangle the
    Moller-Trumbore test accepts, and trilinearly over the 4x4x4 sub-cubes.

    ``crop`` (z, y, x active radii) keeps only the box around the keypoint
    that can hold in-sphere voxels.  The histogram runs in voxel slabs of
    at most ``SLAB_ELEMS`` keypoint-voxels.  ``hist_bf16`` rounds the two
    operands of the histogram product (vertex and cube weights) to
    bfloat16, nearest even, and sums their exact products in float32, as
    the JAX package's option does.  ``parts`` is the JAX package's
    benchmark knob, not ported."""
    if parts != "full":
        raise NotImplementedError(
            f"construct_descriptor: parts={parts!r} is a benchmark knob of "
            "the JAX package and is not ported")
    fl = torch.float32
    dev = win.device
    k = xi.shape[0]
    s = win.shape[1]
    dx, dy, dz = (int(d) for d in dims)
    ux, uy, uz = (f32(u) for u in units)

    sqrt2 = np.float32(np.sqrt(np.float32(2.0)))
    sigma = np.float32(5.0) * sqrt2 * np.float32(scale)
    sphere_radius = np.float32(2.0) * sigma
    cube_radius = float(sphere_radius / sqrt2)
    sigma, sphere_radius = float(sigma), float(sphere_radius)

    zc, yc, xc = _axis_coords(z0, s), _axis_coords(y0, s), _axis_coords(x0, s)
    inb = (((zc >= IMG_BORDER) & (zc <= dz - 1 - IMG_BORDER))[:, :, None, None]
           & ((yc >= IMG_BORDER) & (yc <= dy - 1 - IMG_BORDER))[:, None, :, None]
           & ((xc >= IMG_BORDER) & (xc <= dx - 1 - IMG_BORDER))[:, None, None, :])
    px = (xc.to(fl) - xi.to(fl)[:, None]) * ux
    py = (yc.to(fl) - yi.to(fl)[:, None]) * uy
    pz = (zc.to(fl) - zi.to(fl)[:, None]) * uz
    pxb = px[:, None, None, :]
    pyb = py[:, None, :, None]
    pzb = pz[:, :, None, None]
    dist = torch.sqrt(pxb ** 2 + pyb ** 2 + pzb ** 2)
    valid = (dist <= sphere_radius) & inb
    del inb

    def rotate(ax, ay, az):
        r = [rot[:, i, j, None, None, None] for i in range(3) for j in range(3)]
        return (r[0] * ax + r[1] * ay + r[2] * az,
                r[3] * ax + r[4] * ay + r[5] * az,
                r[6] * ax + r[7] * ay + r[8] * az)

    zero = 0 * dist
    rx, ry, rz = rotate(pxb + zero, pyb + zero, pzb + zero)
    del zero
    subs = [2.0 * (a + cube_radius) / cube_radius - 0.5 for a in (rx, ry, rz)]
    del rx, ry, rz
    for sub in subs:
        valid &= (sub > -0.5) & (sub < 3.5)

    weight = torch.exp(-0.5 * (dist / sigma) ** 2)
    del dist
    # the +0.5 (I[k+1] - I[k-1]) convention of oc_sift.cpp:1131-1133
    gxv = 0.5 * (_sh(win, 0, 0, -1) - _sh(win, 0, 0, 1)) / ux * weight
    gyv = 0.5 * (_sh(win, 0, -1, 0) - _sh(win, 0, 1, 0)) / uy * weight
    gzv = 0.5 * (_sh(win, -1, 0, 0) - _sh(win, 1, 0, 0)) / uz * weight
    del weight
    gg = list(rotate(gxv, gyv, gzv))
    del gxv, gyv, gzv

    if crop is not None:
        csz = tuple(2 * c + 1 for c in crop)
        c0 = tuple(torch.clamp(ci - wi - c, 0, s - n) for ci, wi, c, n in
                   zip((zi, yi, xi), (z0, y0, x0), crop, csz))
        gg = [_crop_slice(a, c0, csz) for a in gg]
        subs = [_crop_slice(a, c0, csz) for a in subs]
        valid = _crop_slice(valid, c0, csz)
    v = gg[0][0].numel()
    flat = [a.reshape(k, v) for a in (*gg, *subs)]
    okf = valid.reshape(k, v)
    del gg, subs, valid

    tab = _triangle_tables(dev)
    tri = torch.from_numpy(ICOSA_TRIPLETS.astype(np.int64)).to(dev)
    i12 = torch.arange(12, device=dev)
    tol = -EPS10
    desc = torch.zeros((k, 12, 64), dtype=fl, device=dev)
    vs = max(1, min(v, SLAB_ELEMS // max(k, 1)))
    for lo in range(0, v, vs):
        gx, gy, gz, sx, sy, sz = (a[:, lo: lo + vs] for a in flat)
        mag2 = gx * gx + gy * gy + gz * gz
        okv = okf[:, lo: lo + vs] & (mag2 >= EPS10)
        mg = torch.sqrt(torch.clamp(mag2, min=1e-30))
        del mag2
        # the 20 triangles at once ([K, vs, 20]); the first accepted wins
        # (cartisan2Barycentric, oc_sift.cpp:579-624)
        gx3, gy3, gz3 = gx[..., None], gy[..., None], gz[..., None]
        e1, e2, tv, qv = tab["e1"], tab["e2"], tab["tv"], tab["qv"]
        p0 = gy3 * e2[:, 2] - gz3 * e2[:, 1]
        p1 = gz3 * e2[:, 0] - gx3 * e2[:, 2]
        p2 = gx3 * e2[:, 1] - gy3 * e2[:, 0]
        det = e1[:, 0] * p0 + e1[:, 1] * p1 + e1[:, 2] * p2
        det_ok = det.abs() >= EPS10
        det_inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
        del det
        bz_t = det_inv * (gx3 * qv[:, 0] + gy3 * qv[:, 1] + gz3 * qv[:, 2])
        by_t = det_inv * (p0 * tv[:, 0] + p1 * tv[:, 1] + p2 * tv[:, 2])
        del p0, p1, p2
        bx_t = 1.0 - by_t - bz_t
        kk = det_inv * tab["qe2"]
        del det_inv
        ok_t = det_ok & (kk >= 0) & (bx_t > tol) & (by_t > tol) & (bz_t > tol)
        # residual check (oc_sift.cpp:615-620)
        v1, v2, v3 = tab["v1"], tab["v2"], tab["v3"]
        res = None
        for c, g3 in enumerate((gx3, gy3, gz3)):
            rc = kk * g3 - (bx_t * v1[:, c] + by_t * v2[:, c]
                            + bz_t * v3[:, c])
            res = rc * rc if res is None else res + rc * rc
        del kk
        ok_t &= res <= EPS10 * EPS10
        del res
        found = ok_t.any(-1)
        tsel = torch.argmax(ok_t.to(torch.uint8), dim=-1)
        del ok_t
        pick = lambda b: torch.where(
            found, torch.gather(b, -1, tsel[..., None])[..., 0],
            torch.zeros((), dtype=fl, device=dev))
        b0, b1, b2 = pick(bx_t), pick(by_t), pick(bz_t)
        del bx_t, by_t, bz_t
        mgf = mg * (okv & found)
        ids = tri[tsel]  # [K, vs, 3]
        vw0 = ((i12 == ids[..., 0:1]) * b0[..., None]
               + (i12 == ids[..., 1:2]) * b1[..., None]
               + (i12 == ids[..., 2:3]) * b2[..., None])
        wx, wy, wz = _tent(sx), _tent(sy), _tent(sz)
        cube_w = (wz[:, :, :, None, None] * wy[:, :, None, :, None]
                  * wx[:, :, None, None, :]).reshape(k, -1, 64)
        vert_w = vw0 * mgf[..., None]
        if hist_bf16:
            vert_w, cube_w = (bf16_round(a) for a in (vert_w, cube_w))
        desc += torch.bmm(vert_w.transpose(1, 2), cube_w)
    desc = desc.transpose(1, 2).reshape(k, 768)
    return _normalise(desc, truncate)


def describe_keypoints(vol, xi, yi, zi, rot, scale, unit_xyz, truncate, *, r,
                       crop=None, hist_bf16: bool = False) -> torch.Tensor:
    """Window gather + :func:`construct_descriptor` over the given
    keypoints, chunked by :func:`work_budget`.  Returns [K, 768]."""
    dz, dy, dx = vol.shape
    n = xi.shape[0]
    s = 2 * r + 1
    chunk = _chunk_len(s ** 3 * 4 * 28, work_budget(vol.device), n)
    out = [torch.zeros((0, 768), device=vol.device)]
    for lo in range(0, n, chunk):
        sl = slice(lo, lo + chunk)
        win, x0, y0, z0 = gather_windows_3d(vol, xi[sl], yi[sl], zi[sl], r)
        out.append(construct_descriptor(
            win, x0, y0, z0, xi[sl], yi[sl], zi[sl], (dx, dy, dz), rot[sl],
            scale, unit_xyz, truncate, crop=crop, hist_bf16=hist_bf16))
    return torch.cat(out)


# --- one octave ---------------------------------------------------------------

def crop_fits(crop, dims) -> bool:
    """Whether a layer takes the fused histogram (kernel 4): its crop box
    plus the 1-voxel gradient margin fits inside the layer."""
    return all(2 * (c + 1) + 1 <= d for c, d in zip(crop, dims))


def octave_features(seed, cfg, *, sigmas, unit_xyz, downsample_to,
                    layer_params, seed_layer: int, hist_bf16: bool = False):
    """An octave's feature path: downsample + blur chain + DoGs, then per
    extraction layer the extrema compaction, orientation of the live
    candidates, the survivors' compaction and their descriptors.

    ``cfg`` carries alpha, gradient_threshold, beta, gamma and
    truncate_threshold.  ``layer_params``: (layer_index, k_e, r_orient, k_d,
    r_desc, scale) per extraction layer.  Returns (next seed, per layer
    (x, y, z, desc, stats)) with only the kept keypoints, in scan order."""
    from . import desc3d

    g, dogs, max_abs = octave_stack(seed, sigmas=sigmas, unit_xyz=unit_xyz,
                                    downsample_to=downsample_to)
    alpha = f32(cfg.alpha)
    outs = []
    for (n, k_e, r_o, k_d, r_d, scale) in layer_params:
        crop = _sphere_crop(r_d, scale, unit_xyz)
        x, y, z, _, count = extrema_compact(
            dogs[n - 1], dogs[n], dogs[n + 1], alpha * max_abs[n], k_cap=k_e)
        live = min(count, k_e)
        x, y, z = x[:live], y[:live], z[:live]
        rot, ok2 = orient_keypoints(
            g[n], x, y, z, scale, unit_xyz, cfg.gradient_threshold,
            cfg.beta, cfg.gamma, r=r_o)
        survivors = int(ok2.sum())
        kept = min(survivors, k_d)
        xd, yd, zd, rotd, _ = compact_gather(ok2, x, y, z, rot, k_cap=kept)
        fused = crop_fits(crop, g[n].shape)
        if fused:
            desc = desc3d.describe_keypoints_fused(
                g[n], xd, yd, zd, rotd, cfg.truncate_threshold, crop=crop,
                scale=scale, unit_xyz=unit_xyz, hist_bf16=hist_bf16)
        else:
            desc = describe_keypoints(
                g[n], xd, yd, zd, rotd, scale, unit_xyz,
                cfg.truncate_threshold, r=r_d, crop=crop,
                hist_bf16=hist_bf16)
        stats = dict(layer=n, dims=list(g[n].shape), candidates=count,
                     k_e=k_e, oriented=survivors, k_d=k_d, kept=kept,
                     crop=list(crop), fused=fused)
        outs.append((xd, yd, zd, desc, stats))
    return g[seed_layer], outs


# --- assembly and matching ----------------------------------------------------

def compact_gather(ok, x, y, z, rot, *, k_cap):
    """Scan-order compaction of a survivor mask and the survivors' records:
    (x, y, z, rot, ok) at [k_cap], padding slots clamped and ok=False."""
    idx, okc = _compact(ok, k_cap)
    return x[idx], y[idx], z[idx], rot[idx], okc


def assemble_keypoints(xs, ys, zs, oks, descs, metas, *, k_cap):
    """Merge per-(octave, layer) keypoints into one table: concatenate every
    layer, keep the first k_cap valid entries in layer order.  metas: per
    layer (coord_factor 2^octave, octave, layer, scale).  Returns
    (kp [k_cap, 6] (x, y, z, octave, layer, scale), desc [k_cap, 768],
    ok [k_cap])."""
    rows = []
    for x, y, z, mt in zip(xs, ys, zs, metas):
        mt = torch.as_tensor(np.asarray(mt, np.float32), device=x.device)
        coor = torch.stack([x.to(torch.float32) * mt[0],
                            y.to(torch.float32) * mt[0],
                            z.to(torch.float32) * mt[0]], 1)
        rows.append(torch.cat([coor, mt[1:4].expand(x.shape[0], 3)], 1))
    kp = torch.cat(rows)
    idx, okc = _compact(torch.cat(oks), k_cap)
    return kp[idx], torch.cat(descs)[idx], okc


def match_top2(desc1, desc2, ok2, *, chunk=2048):
    """Masked 2-NN squared distances (the FLANN step, oc_sift.cpp:1251): for
    each row of desc1 the two smallest ||d1 - d2||^2 over the valid rows of
    desc2 (invalid rows are 3.4e38 and never win), in chunks of ``chunk``
    rows.  Returns (d2 [K1, 2], idx [K1, 2])."""
    tt = (desc2 * desc2).sum(1)[None, :]
    big = torch.tensor(3.4e38, dtype=torch.float32, device=desc1.device)
    ds, ids = [], []
    for lo in range(0, desc1.shape[0], chunk):
        d1c = desc1[lo: lo + chunk]
        rr = (d1c * d1c).sum(1, keepdim=True)
        dist2 = torch.clamp(rr + tt - 2.0 * (d1c @ desc2.T), min=0.0)
        dist2 = torch.where(ok2[None, :], dist2, big)
        d, i = torch.topk(dist2, 2, dim=1, largest=False, sorted=True)
        ds.append(d)
        ids.append(i)
    if not ds:
        return (torch.zeros((0, 2), device=desc1.device),
                torch.zeros((0, 2), dtype=torch.int64, device=desc1.device))
    return torch.cat(ds), torch.cat(ids)
