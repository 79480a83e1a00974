"""Cubic B-spline interpolation: bicubic 2D, tricubic 3D.

2D (Z. Pan et al., TAML 6(3):126-130, 2016) matches the reference's per-pixel 4x4 coefficient LUT
(``oc_cubic_bspline.cpp:84-132``): for each interior pixel the 4x4 grayscale
neighborhood Q maps to the polynomial coefficient matrix
C = flip(BC . Q . BC^T), BC being the fixed basis*control matrix
(``oc_cubic_bspline.h:52-58``); a query evaluates the bivariate cubic
sum_{k,l} C[k,l] yd^k xd^l (``oc_cubic_bspline.cpp:134-181``).  Out-of-range
queries (x<1, y<1, x>=W-2, y>=H-2, or NaN) return the -1.0 sentinel the
refinement kernels use to detect out-of-bounds warps.  On CUDA tensors a
query batch is one hand-written kernel, ``csrc/bicubic2d.cu``, whose plain
version is :func:`bicubic_eval_plain`.

3D (J. Yang et al., OLEN 136:106323, 2021): a global separable 15-tap
symmetric prefilter along x, y and z with edge clamping (taps
``oc_cubic_bspline.h:80-90``), then a 4x4x4 basis-function evaluation per
query (``oc_cubic_bspline.cpp:353-405``), with the same -1 sentinel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _kernels

_P = ctypes.c_void_p
_I = ctypes.c_int

# BC = B * C from oc_cubic_bspline.h:52-58.
BC_MATRIX = np.array(
    [
        [-144.0 / 336.0, 384.0 / 336.0, -384.0 / 336.0, 144.0 / 336.0],
        [342.0 / 336.0, -702.0 / 336.0, 450.0 / 336.0, -90.0 / 336.0],
        [-198.0 / 336.0, -18.0 / 336.0, 270.0 / 336.0, -54.0 / 336.0],
        [0.0, 1.0, 0.0, 0.0],
    ],
    dtype=np.float32,
)


# Symmetric prefilter taps b0..b7 from oc_cubic_bspline.h:80-90.
BSPLINE_PREFILTER = np.array(
    [
        1.732176555412860,
        -0.464135309171000,
        0.124364681271139,
        -0.033323415913556,
        0.008928982383084,
        -0.002392513618779,
        0.000641072092032,
        -0.000171774749350,
    ],
    dtype=np.float32,
)

# Samples per slab of the global tricubic eval: its [slab, 64] tap gather
# is the transient that bounds memory.
TRICUBIC_SLAB = 1 << 20


def _below(bound: int) -> float:
    """Largest float32 strictly below ``bound``.

    The upper clip for in-range samples: the range guards exclude
    x >= bound, so every unmasked sample is < bound and the clip must not
    perturb its fractional part."""
    return float(np.nextafter(np.float32(bound), np.float32(0)))


def bicubic_prepare(img: torch.Tensor) -> torch.Tensor:
    """Build the [H, W, 4, 4] coefficient LUT (oc_cubic_bspline.cpp:84-132).

    Border pixels (r<1, r>=H-2, c<1, c>=W-2) keep zero coefficients, as the
    reference leaves them unset; queries never touch them (range guard)."""
    h, w = img.shape
    bc = torch.as_tensor(BC_MATRIX, device=img.device)
    # q[r, c, n, m] = img[r-1+n, c-1+m] over the interior r in [1, h-3]
    q = torch.stack(
        [torch.stack([img[n: n + h - 3, m: m + w - 3] for m in range(4)],
                     dim=-1) for n in range(4)], dim=-2)
    # mat_p[k, l] = sum_{m,n} BC[l, m] BC[k, n] q[n, m]  (cpp:108-120)
    p = torch.einsum("kn,hwnm,lm->hwkl", bc, q, bc)
    lut = torch.zeros((h, w, 4, 4), dtype=torch.float32, device=img.device)
    # coefficient[k][l] = mat_p[3-k][3-l]  (cpp:123-129)
    lut[1: h - 2, 1: w - 2] = p.flip(-1, -2)
    return lut


def bicubic_eval_plain(lut: torch.Tensor, xs: torch.Tensor,
                       ys: torch.Tensor):
    """The plain version of :func:`bicubic_eval`, on any device and dtype.

    Each product and sum is rounded on its own, in the order of the CUDA
    kernel (``csrc/bicubic2d.cu``), so that the two agree to the last bit
    in float32: t_l = ((c[0,l] + yd c[1,l]) + yd^2 c[2,l]) + yd^3 c[3,l],
    then ((t_0 + xd t_1) + xd^2 t_2) + xd^3 t_3.  That is also the order
    in which PyTorch's CPU einsum summed the port's first version, a
    gather and ``einsum("...kl,...k,...l->...")``: on the tests' inputs
    the two give the same bits."""
    h, w = lut.shape[:2]
    oob = ((xs < 1) | (ys < 1) | (xs >= w - 2) | (ys >= h - 2)
           | torch.isnan(xs) | torch.isnan(ys))
    # Clip to just below the range guard: a sample in
    # [nextafter(w-2), w-2) passes the guard and must evaluate at its exact
    # fractional part; the clip only sanitizes masked samples (NaN -> 1).
    xq = torch.nan_to_num(xs, nan=1.0).clamp(1.0, _below(w - 2))
    yq = torch.nan_to_num(ys, nan=1.0).clamp(1.0, _below(h - 2))
    xf = torch.floor(xq)
    yf = torch.floor(yq)
    xd = xq - xf
    yd = (yq - yf)[..., None]
    c = lut.reshape(h * w, 4, 4)[yf.to(torch.int64) * w
                                 + xf.to(torch.int64)]  # [..., 4, 4]
    yd2 = yd * yd
    t = (c[..., 0, :] + c[..., 1, :] * yd + c[..., 2, :] * yd2
         + c[..., 3, :] * (yd2 * yd))  # [..., 4], t_l
    xd2 = xd * xd
    val = (t[..., 0] + t[..., 1] * xd + t[..., 2] * xd2
           + t[..., 3] * (xd2 * xd))
    return torch.where(oob, torch.full_like(val, -1.0), val), oob


def check_kernel_args(lut: torch.Tensor, xs: torch.Tensor,
                      ys: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the kernel takes these tensors: a
    contiguous float32 [H, W, 4, 4] LUT on a 16-byte boundary (it is read
    in 16-byte loads) and contiguous float32 coordinates of one shape, all
    on one device."""
    if lut.dim() != 4 or tuple(lut.shape[2:]) != (4, 4):
        raise ValueError(f"bicubic_eval: LUT shape {tuple(lut.shape)}, "
                         "expected [H, W, 4, 4]")
    for name, t in (("lut", lut), ("xs", xs), ("ys", ys)):
        if (t.device != lut.device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"bicubic_eval: {name} needs a contiguous "
                             f"float32 tensor on {lut.device}, got "
                             f"{t.dtype} on {t.device}")
    if lut.data_ptr() % 16:
        raise ValueError("bicubic_eval: the LUT must start on a 16-byte "
                         "boundary")
    if xs.shape != ys.shape:
        raise ValueError(f"bicubic_eval: coordinate shapes "
                         f"{tuple(xs.shape)} and {tuple(ys.shape)}")


def bicubic_eval(lut: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """Evaluate the bicubic spline at float coords.

    Returns ``(value, oob)``; out-of-range queries carry the reference's
    -1.0 sentinel (oc_cubic_bspline.cpp:134-181).  CPU tensors take
    :func:`bicubic_eval_plain`; CUDA tensors the kernel
    ``csrc/bicubic2d.cu``, which raises on tensors it does not take
    (:func:`check_kernel_args`)."""
    dev = lut.device
    if dev.type == "cpu":
        return bicubic_eval_plain(lut, xs, ys)
    if dev.type != "cuda":
        raise ValueError(f"bicubic_eval: unsupported device {dev}")
    check_kernel_args(lut, xs, ys)
    h, w = lut.shape[:2]
    n = xs.numel()
    val = torch.empty_like(xs)
    oob = torch.empty(xs.shape, dtype=torch.bool, device=dev)
    if n:
        fn = _bicubic_entry()
        with _kernels.on_device(dev):
            _kernels.launch(bicubic_eval, lambda: fn(
                lut.data_ptr(), h, w, xs.data_ptr(), ys.data_ptr(), n,
                val.data_ptr(), oob.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream), shape=(n,))
    return val, oob


bicubic_eval.launches = 0  # kernel launches, for run-level checks
# a dict: launches by sample count (n,), counted while it is set
bicubic_eval.shapes = None


def bind_bicubic(lib: ctypes.CDLL):
    """The kernel's C entry point in a loaded library, typed."""
    fn = lib.oc_bicubic_eval_2d
    fn.argtypes = [_P, _I, _I, _P, _P, ctypes.c_longlong, _P, _P, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _bicubic_entry():
    """The typed entry point of the package's build, bound once."""
    return bind_bicubic(_kernels.load("bicubic2d"))


def _prefilter_axis(vol: torch.Tensor, axis: int) -> torch.Tensor:
    """15-tap symmetric convolution with edge clamping along one axis
    (oc_cubic_bspline.cpp:223-351).  The reference clamps only the outward
    side of the stencil near each edge, which clamping both shifted index
    arrays reproduces: for interior points no clamp fires."""
    n = vol.shape[axis]
    idx = torch.arange(n, device=vol.device)
    out = float(BSPLINE_PREFILTER[0]) * vol
    for t in range(1, 8):
        lo = torch.clamp(idx - t, 0, n - 1)
        hi = torch.clamp(idx + t, 0, n - 1)
        out = out + float(BSPLINE_PREFILTER[t]) * (
            vol.index_select(axis, lo) + vol.index_select(axis, hi))
    return out


def tricubic_prepare(vol: torch.Tensor) -> torch.Tensor:
    """Prefiltered coefficient volume [Z, Y, X] (oc_cubic_bspline.cpp:
    214-351), filtered along x, then y, then z as the reference does."""
    coeff = _prefilter_axis(vol, 2)
    coeff = _prefilter_axis(coeff, 1)
    return _prefilter_axis(coeff, 0)


def basis4(d: torch.Tensor):
    """The four cubic B-spline basis values of fractional parts ``d``
    (oc_cubic_bspline.cpp:35-53), each rounded in the JAX package's order;
    ``csrc/lattice3d.cu`` repeats these roundings."""
    sixth = 1.0 / 6.0
    return [sixth * (d * (d * (-d + 3.0) - 3.0) + 1.0),
            sixth * (d * d * (3.0 * d - 6.0) + 4.0),
            sixth * (d * (d * (-3.0 * d + 3.0) + 3.0) + 1.0),
            sixth * (d * d * d)]


def _basis(d: torch.Tensor) -> torch.Tensor:
    return torch.stack(basis4(d), dim=-1)


def tricubic_eval(coeff: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                  zs: torch.Tensor, slab: int = TRICUBIC_SLAB):
    """Evaluate the tricubic spline at float coords; -1 sentinel outside
    [1, dim-2) on any axis or for NaN (oc_cubic_bspline.cpp:353-405).
    Returns ``(value, oob)``.

    The 64 taps of every sample are gathered from the global coefficient
    volume.  More than ``2 * slab`` samples are evaluated ``slab`` at a
    time, which bounds the [slab, 64] gather transient (1M samples: about
    1 GB with its indices and weights)."""
    shp = xs.shape
    xs, ys, zs = xs.reshape(-1), ys.reshape(-1), zs.reshape(-1)
    size = xs.shape[0]
    if size <= 2 * slab:
        val, oob = _tricubic_eval_impl(coeff, xs, ys, zs)
        return val.reshape(shp), oob.reshape(shp)
    val = torch.empty_like(xs)
    oob = torch.empty(size, dtype=torch.bool, device=xs.device)
    for s0 in range(0, size, slab):
        sl = slice(s0, s0 + slab)
        val[sl], oob[sl] = _tricubic_eval_impl(coeff, xs[sl], ys[sl], zs[sl])
    return val.reshape(shp), oob.reshape(shp)


def _tricubic_eval_impl(coeff, xs, ys, zs):
    dz, dy, dx = coeff.shape
    oob = ((xs < 1) | (ys < 1) | (zs < 1)
           | (xs >= dx - 2) | (ys >= dy - 2) | (zs >= dz - 2)
           | torch.isnan(xs) | torch.isnan(ys) | torch.isnan(zs))
    xq = torch.nan_to_num(xs, nan=1.0).clamp(1.0, _below(dx - 2))
    yq = torch.nan_to_num(ys, nan=1.0).clamp(1.0, _below(dy - 2))
    zq = torch.nan_to_num(zs, nan=1.0).clamp(1.0, _below(dz - 2))
    xi = torch.floor(xq).to(torch.int64)
    yi = torch.floor(yq).to(torch.int64)
    zi = torch.floor(zq).to(torch.int64)
    bx = _basis(xq - xi.to(torch.float32))  # [P, 4]
    by = _basis(yq - yi.to(torch.float32))
    bz = _basis(zq - zi.to(torch.float32))
    off = torch.arange(-1, 3, device=xs.device)
    zidx = zi[:, None] + off
    yidx = yi[:, None] + off
    xidx = xi[:, None] + off
    lin = ((zidx[:, :, None, None] * dy + yidx[:, None, :, None]) * dx
           + xidx[:, None, None, :]).reshape(-1, 64)
    nb = coeff.reshape(-1)[lin]  # [P, 64]
    w = (bz[:, :, None, None] * by[:, None, :, None]
         * bx[:, None, None, :]).reshape(-1, 64)
    val = torch.sum(nb * w, dim=-1)
    return torch.where(oob, torch.full_like(val, -1.0), val), oob
