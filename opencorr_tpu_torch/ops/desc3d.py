"""The fused SIFT3D descriptor histogram (kernel 4) and its callers.

The histogram restructures constructDescriptor (oc_sift.cpp:1051-1250) so
that a voxel costs a handful of products:

* **Argmax face.**  The icosahedron is convex with the origin inside, so a
  gradient direction g lies in the face whose unit normal maximises n_t . g
  (the first maximum wins).  The ray meets that face's plane at
  g * (d / max_dot), and barycentric coordinates are linear on the plane.
  This agrees with the reference's first-match Moller-Trumbore loop but for
  directions exactly on a face edge.
* **Deferred vertex binning.**  With alpha = |g| d / max_dot the histogram
  factorises as desc[j, c] = W'[j, (a,t)] @ S[(a,t), c] with
      S[a*20+t, c] = sum_v [face(v)=t] alpha(v) g_a(v) cube_w(v, c),
  and W'[12, 60] a constant fold applied per keypoint after the histogram.
* **Separable weights.**  The Gaussian weight and the volume border mask are
  per-axis tables; the sphere test runs on squared offsets.

The CUDA kernel is ``csrc/desc3d.cu`` (it visits only the in-sphere
voxels, row by row, with a warp's lanes 8 voxels apart):
:func:`descriptor_hist` launches it for CUDA tensors and takes
:func:`descriptor_hist_plain` for CPU tensors.
Both read the layer volume directly through the keypoints' window starts
and per-axis tables (:func:`prepare_tables`).  The plain version keeps the
JAX package's two levels: it forms the gradient windows and tables
(:func:`hist_inputs`) and runs :func:`hist_from_tables`, whose arguments are
those of the JAX package's ``pallas_desc.descriptor_hist``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..utils.precision import bf16_round, f32
from . import _kernels
from .sift3d import (EPS10, ICOSA_TRIPLETS, ICOSA_VERTICES, IMG_BORDER,
                     _normalise)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# The function's float work per keypoint-voxel (whatever loop computes
# it): every voxel of the sphere pays the weight, sphere test, gradients,
# rotations, sub-cube coordinates and |g|^2; a voxel that is in the cube
# with |g|^2 >= EPS10 also pays the square root, 20 face dots and their
# maxima, alpha, the tents, 8 corner weights and 24 products and sums.
# Kernel 4's operation bound counts these.
FLOPS_SPHERE_VOXEL = 2 + 2 + 6 + 3 + 15 + 15 + 12 + 5
FLOPS_LIVE_VOXEL = 1 + 20 * 5 + 19 + 3 + 6 + 12 + 3 + 24 * 2


@functools.lru_cache(None)
def _face_tables():
    """(normals [20, 3], dhat, W' [12, 60]) in float32 (built in float64).
    The 60 axis is ordered a * 20 + t."""
    tri = ICOSA_TRIPLETS
    v = ICOSA_VERTICES.astype(np.float64)
    n = np.zeros((20, 3))
    w = np.zeros((12, 20, 3))
    dhat = 0.0
    for t in range(20):
        v1, v2, v3 = v[tri[t]]
        nt = v1 + v2 + v3
        nt /= np.linalg.norm(nt)
        n[t] = nt
        dhat = float(nt @ v1)  # the same for every face (regular solid)
        bt = np.linalg.inv(np.stack([v1, v2, v3], axis=1))
        for i in range(3):
            w[tri[t, i], t] += bt[i]
    return (n.astype(np.float32), np.float32(dhat),
            np.ascontiguousarray(w.transpose(0, 2, 1)).reshape(12, 60)
            .astype(np.float32))


def _radii(scale: float):
    """(sphere radius^2, cube radius, 1/cube radius, -0.5/sigma^2) in
    float32 for a layer of physical ``scale`` (oc_sift.cpp:1130-1140)."""
    sigma = 5.0 * math.sqrt(2.0) * float(scale)
    sphere_radius = 2.0 * sigma
    cube_radius = sphere_radius / math.sqrt(2.0)
    return (f32(sphere_radius * sphere_radius), f32(cube_radius),
            f32(1.0 / cube_radius), f32(-0.5 / (sigma * sigma)))


def prepare_tables(vol_shape, xi, yi, zi, *, crop, scale, unit_xyz):
    """Window starts and per-axis tables of K keypoints.

    The window is the crop box plus a 1-voxel gradient margin,
    (2 c + 3) voxels a side, its start clamped into the volume.  Returns
    (starts [K, 3] int32 (z0, y0, x0), tab [K, 3, CZ+CY+CX] float32): rows
    w (Gaussian x border mask), p (physical offset from the keypoint) and
    p^2, the z columns first, then y, then x, for the crop voxels at
    absolute coordinate start + 1 + i."""
    dz, dy, dx = vol_shape
    ux, uy, uz = unit_xyz
    inv_2s2 = _radii(scale)[3]
    starts, ws, ps, p2s = [], [], [], []
    for ci, c, unit, dim in ((zi, crop[0], uz, dz), (yi, crop[1], uy, dy),
                             (xi, crop[2], ux, dx)):
        n = 2 * c + 1
        c0 = torch.clamp(ci - (c + 1), 0, dim - (n + 2))
        coords = c0[:, None] + 1 + torch.arange(n, device=ci.device)[None, :]
        p = (coords - ci[:, None]).to(torch.float32) * f32(unit)
        inb = (coords >= IMG_BORDER) & (coords <= dim - 1 - IMG_BORDER)
        ws.append(torch.exp(inv_2s2 * p * p) * inb)
        ps.append(p)
        p2s.append(p * p)
        starts.append(c0)
    tab = torch.stack([torch.cat(ws, 1), torch.cat(ps, 1),
                       torch.cat(p2s, 1)], 1)
    return torch.stack(starts, 1).to(torch.int32), tab.contiguous()


def hist_inputs(vol, starts, tab, *, crop, unit_xyz):
    """The JAX package's ``descriptor_hist`` arguments from the volume,
    the window starts and the tables: gradient windows gxw/gyw/gzw
    [CZ, K, CYX] (central differences w.r.t. physical coordinates), wz/pz/
    pz2 [CZ, K, 1] and wyx/px/py/pyx2 [K, CYX]."""
    k = starts.shape[0]
    cz, cy, cx = (2 * c + 1 for c in crop)
    ux, uy, uz = unit_xyz
    dz, dy, dx = vol.shape
    dev = vol.device
    o = [torch.arange(n + 2, device=dev) for n in (cz, cy, cx)]
    zz, yy, xx = (starts[:, i].long()[:, None] + o[i] for i in range(3))
    flat = ((zz[:, :, None, None] * dy + yy[:, None, :, None]) * dx
            + xx[:, None, None, :])
    win = vol.reshape(-1)[flat]  # [K, cz+2, cy+2, cx+2]
    del flat
    cyx = cy * cx

    def lead_z(a):
        return a.reshape(k, cz, cyx).transpose(0, 1).contiguous()

    gxw = lead_z((win[:, 1:-1, 1:-1, 2:] - win[:, 1:-1, 1:-1, :-2])
                 * f32(0.5 / ux))
    gyw = lead_z((win[:, 1:-1, 2:, 1:-1] - win[:, 1:-1, :-2, 1:-1])
                 * f32(0.5 / uy))
    gzw = lead_z((win[:, 2:, 1:-1, 1:-1] - win[:, :-2, 1:-1, 1:-1])
                 * f32(0.5 / uz))
    del win
    wt, pt, p2t = tab[:, 0], tab[:, 1], tab[:, 2]
    zs, ys, xs = slice(0, cz), slice(cz, cz + cy), slice(cz + cy, None)
    ztab = lambda a: a.T[:, :, None].contiguous()  # [K, CZ] -> [CZ, K, 1]
    wyx = (wt[:, ys][:, :, None] * wt[:, xs][:, None, :]).reshape(k, cyx)
    pyx2 = (p2t[:, ys][:, :, None] + p2t[:, xs][:, None, :]).reshape(k, cyx)
    pxf = pt[:, xs][:, None, :].expand(k, cy, cx).reshape(k, cyx)
    pyf = pt[:, ys][:, :, None].expand(k, cy, cx).reshape(k, cyx)
    return (gxw, gyw, gzw, ztab(wt[:, zs]), ztab(pt[:, zs]), ztab(p2t[:, zs]),
            wyx, pxf, pyf, pyx2)


def _tent_bins(sub):
    """The two tent bins of a sub-cube coordinate and their weights, with
    the reference's (int) truncation quirk: bin trunc(sub) gets 1 - frac,
    the next bin frac, frac from floor.  Bins past 3 carry weight 0."""
    i = sub.to(torch.int32)
    dfrac = sub - torch.floor(sub)
    lo_w = 1.0 - dfrac
    hi_ok = i + 1 <= 3
    return ((i, lo_w), (torch.where(hi_ok, i + 1, torch.zeros_like(i)),
                        torch.where(hi_ok, dfrac, torch.zeros_like(dfrac))))


def hist_from_tables(gxw, gyw, gzw, wz, pz, pz2, wyx, px, py, pyx2, rot, *,
                     scale, counts=None, hist_bf16: bool = False):
    """The [K, 60, 64] deferred histogram S in plain PyTorch, with the
    arguments of the JAX package's ``pallas_desc.descriptor_hist`` (see
    :func:`hist_inputs`); rot is [K, 9] (row-major rows of the 3x3).

    Per z-slice it computes every voxel's weight, rotated gradient,
    sub-cube coordinates, face and alpha as the kernel does, and adds the
    24 products alpha * g_a * wz * (wy * wx) of each live voxel into its
    rows a*20+t with ``index_add_``.  ``counts``, a dict, receives the
    number of in-sphere and of live keypoint-voxels.  ``hist_bf16`` rounds
    the two factors alpha * g_a and wz * (wy * wx) to bfloat16 (nearest
    even) before their product, as the JAX kernel's bf16 operands do."""
    nf, dhat, _ = _face_tables()
    r2, cr, inv_cr, _ = _radii(scale)
    cz, k, cyx = gxw.shape
    dev = gxw.device
    s_flat = torch.zeros(k * 60 * 64, dtype=torch.float32, device=dev)
    rr = [rot[:, i][:, None] for i in range(9)]
    kbase = (torch.arange(k, device=dev) * 3840)[:, None]
    n_sphere = n_live = 0
    for z in range(cz):
        insph = pz2[z] + pyx2 <= r2
        w = torch.where(insph, wz[z] * wyx, torch.zeros((), device=dev))
        gx, gy, gz = gxw[z] * w, gyw[z] * w, gzw[z] * w
        gg = [rr[3 * i] * gx + rr[3 * i + 1] * gy + rr[3 * i + 2] * gz
              for i in range(3)]
        pzz = pz[z]
        subs = [2.0 * (rr[3 * i] * px + rr[3 * i + 1] * py
                       + rr[3 * i + 2] * pzz + cr) * inv_cr - 0.5
                for i in range(3)]
        in_cube = torch.ones_like(insph)
        for sub in subs:
            in_cube &= (sub > -0.5) & (sub < 3.5)
        mag2 = gg[0] * gg[0] + gg[1] * gg[1] + gg[2] * gg[2]
        okv = in_cube & (mag2 >= EPS10)
        n_sphere += int(insph.sum())
        live = torch.nonzero(okv.reshape(-1)).reshape(-1)
        n_live += int(live.numel())
        if not live.numel():
            continue
        ggl = [a.reshape(-1)[live] for a in gg]
        mg = torch.sqrt(mag2.reshape(-1)[live])
        best = nf[0, 0] * ggl[0] + nf[0, 1] * ggl[1] + nf[0, 2] * ggl[2]
        face = torch.zeros_like(live)
        for t in range(1, 20):
            d_t = nf[t, 0] * ggl[0] + nf[t, 1] * ggl[1] + nf[t, 2] * ggl[2]
            face = torch.where(d_t > best, t, face)
            best = torch.maximum(best, d_t)
        # a true division (a Python number over a tensor would multiply by
        # the reciprocal)
        alpha = mg * torch.div(torch.full_like(best, float(dhat)),
                               torch.clamp(best, min=1e-30))
        tz, ty, tx = (_tent_bins(s.reshape(-1)[live]) for s in
                      (subs[2], subs[1], subs[0]))
        rows = (kbase.expand(k, cyx).reshape(-1)[live] + face * 64)
        idx, val = [], []
        rnd = bf16_round if hist_bf16 else (lambda a: a)
        for a in range(3):
            ag = rnd(alpha * ggl[a])
            for bz, wzv in tz:
                for by, wyv in ty:
                    for bx, wxv in tx:
                        idx.append(rows + a * 1280 + ((bz * 4 + by) * 4 + bx))
                        val.append(ag * rnd(wzv * (wyv * wxv)))
        s_flat.index_add_(0, torch.cat(idx), torch.cat(val))
    if counts is not None:
        counts["sphere_voxels"] = counts.get("sphere_voxels", 0) + n_sphere
        counts["live_voxels"] = counts.get("live_voxels", 0) + n_live
    return s_flat.reshape(k, 60, 64)


def descriptor_hist_plain(vol, starts, tab, rot, *, crop, scale, unit_xyz,
                          counts=None, hist_bf16: bool = False):
    """The kernel's contract in plain PyTorch: :func:`hist_inputs` then
    :func:`hist_from_tables`."""
    args = hist_inputs(vol, starts, tab, crop=crop, unit_xyz=unit_xyz)
    return hist_from_tables(*args, rot.reshape(-1, 9), scale=scale,
                            counts=counts, hist_bf16=hist_bf16)


def bind(lib: ctypes.CDLL, hist_bf16: bool = False):
    """The kernel's C entry point in a loaded library, typed: the float32
    instance, or with ``hist_bf16`` the bfloat16-operand one."""
    fn = lib.oc_desc3d_hist_bf16 if hist_bf16 else lib.oc_desc3d_hist
    fn.argtypes = [_P] * 5 + [_I] * 7 + [_F] * 7 + [_P, _P]
    fn.restype = _I
    return fn


def c_args(vol, starts, tab, rot, out, *, crop, scale, unit_xyz):
    """The C entry point's arguments for checked tensors, on the current
    stream (the normals' ctypes array lives in the tuple)."""
    nf, dhat, _ = _face_tables()
    normals = (ctypes.c_float * 60)(*nf.reshape(-1).tolist())
    r2, cr, inv_cr, _ = _radii(scale)
    ux, uy, uz = unit_xyz
    cz, cy, cx = (2 * c + 1 for c in crop)
    return (vol.data_ptr(), starts.data_ptr(), tab.data_ptr(), rot.data_ptr(),
            out.data_ptr(), starts.shape[0], cz, cy, cx, *vol.shape, r2, cr,
            inv_cr, f32(0.5 / ux), f32(0.5 / uy), f32(0.5 / uz), float(dhat),
            ctypes.cast(normals, _P), torch.cuda.current_stream().cuda_stream,
            normals)


def descriptor_hist(vol, starts, tab, rot, *, crop, scale, unit_xyz,
                    hist_bf16: bool = False):
    """[K, 60, 64] deferred histogram S of K keypoints of one layer.

    vol [dz, dy, dx] float32 layer; starts [K, 3] int32 window starts and
    tab [K, 3, CZ+CY+CX] float32 per-axis tables from
    :func:`prepare_tables`; rot [K, 3, 3] or [K, 9].  ``crop`` (z, y, x)
    active radii, ``scale`` the layer's physical scale, ``unit_xyz`` its
    voxel pitch.  ``hist_bf16`` rounds both factors of every product to
    bfloat16 first (the JAX package's bf16 operands).  Float atomics make
    the kernel's summation order vary from run to run."""
    k = starts.shape[0]
    cz, cy, cx = (2 * c + 1 for c in crop)
    if vol.dim() != 3:
        raise ValueError(f"vol must be [dz, dy, dx], got {tuple(vol.shape)}")
    if tuple(starts.shape) != (k, 3) or tuple(tab.shape) != (
            k, 3, cz + cy + cx):
        raise ValueError(f"starts {tuple(starts.shape)} / tab "
                         f"{tuple(tab.shape)} do not match crop {crop}")
    rot = rot.reshape(k, 9)
    if any(d < n + 2 for d, n in zip(vol.shape, (cz, cy, cx))):
        raise ValueError(f"crop {crop} plus its margin exceeds the volume "
                         f"{tuple(vol.shape)}")
    if vol.device.type == "cpu":
        return descriptor_hist_plain(vol, starts, tab, rot, crop=crop,
                                     scale=scale, unit_xyz=unit_xyz,
                                     hist_bf16=hist_bf16)
    if vol.device.type != "cuda":
        raise ValueError(f"unsupported device {vol.device}")
    for name, t, dt in (("vol", vol, torch.float32),
                        ("starts", starts, torch.int32),
                        ("tab", tab, torch.float32),
                        ("rot", rot, torch.float32)):
        if t.device != vol.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on "
                             f"{vol.device}, got {t.dtype} on {t.device}")
    out = torch.zeros((k, 60, 64), dtype=torch.float32, device=vol.device)
    if k:
        with torch.cuda.device(vol.device):
            fn = bind(_kernels.load("desc3d"), hist_bf16)
            args = c_args(vol, starts, tab, rot, out, crop=crop, scale=scale,
                          unit_xyz=unit_xyz)
            _kernels.launch(descriptor_hist, lambda: fn(*args[:-1]),
                            shape=(k, *crop))
    return out


descriptor_hist.launches = 0  # kernel launches, for run-level checks
# a dict: launches by shape (k, crop z, y, x), counted while it is set
descriptor_hist.shapes = None
# a list: (start, end) CUDA events and the shape of a launch
descriptor_hist.events = None


def construct_descriptor_fused(vol, xi, yi, zi, rot, truncate, *, crop,
                               scale, unit_xyz, hist_bf16: bool = False):
    """[K, 768] descriptors through the fused histogram: the tables, S,
    the W' fold and the reference's normalize -> truncate -> renormalize
    (oc_sift.cpp:1217-1248)."""
    k = xi.shape[0]
    starts, tab = prepare_tables(vol.shape, xi, yi, zi, crop=crop,
                                 scale=scale, unit_xyz=unit_xyz)
    s_hist = descriptor_hist(vol, starts, tab, rot.reshape(k, 9).contiguous(),
                             crop=crop, scale=scale, unit_xyz=unit_xyz,
                             hist_bf16=hist_bf16)
    w_fold = torch.from_numpy(_face_tables()[2]).to(vol.device)
    desc = torch.matmul(w_fold, s_hist)  # [K, 12, 64]
    return _normalise(desc.transpose(1, 2).reshape(k, 768), truncate)


def describe_keypoints_fused(vol, xi, yi, zi, rot, truncate, *, crop, scale,
                             unit_xyz, hist_bf16: bool = False):
    """:func:`construct_descriptor_fused` over a layer's keypoints: one
    kernel launch for all of them on the card; on the CPU in chunks that
    keep the plain version's windows near 256 MB."""
    n = xi.shape[0]
    if vol.device.type == "cuda":
        chunk = max(n, 1)
    else:
        side = [2 * c + 3 for c in crop]
        chunk = max(1, (256 << 20) // (16 * side[0] * side[1] * side[2]))
    out = [torch.zeros((0, 768), device=vol.device)]
    for lo in range(0, n, chunk):
        sl = slice(lo, lo + chunk)
        out.append(construct_descriptor_fused(
            vol, xi[sl], yi[sl], zi[sl], rot[sl], truncate, crop=crop,
            scale=scale, unit_xyz=unit_xyz, hist_bf16=hist_bf16))
    return torch.cat(out)
