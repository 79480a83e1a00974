"""Gather-free tricubic B-spline evaluation over per-POI extended blocks.

For POI n and subset sample (k, j, i) with placement offsets (dz, dy, dx)
and fractional parts (fz, fy, fx):

  out[n,k,j,i] = sum_{tz,ty,tx} bz_tz * by_ty * bx_tx
                                * eblk[n, k+dz+tz, j+dy+ty, i+dx+tx]

with b_t the cubic B-spline basis (``bspline.basis4``), summed in (tz, ty,
tx) order as ``((bz*by)*bx)*e`` from 0, and exactly 0 when any offset lies
outside [0, 2D].  These are the non-zero terms of the JAX package's
placement sum, in the order it adds them.

The CUDA kernel is ``csrc/lattice3d.cu``.  ``lattice_eval_3d`` launches it
for CUDA tensors and uses :func:`lattice_eval_3d_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels
from .bspline import basis4

_P = ctypes.c_void_p
_I = ctypes.c_int


def lattice_eval_3d_plain(eblk: torch.Tensor, dz: torch.Tensor,
                          dy: torch.Tensor, dx: torch.Tensor,
                          fz: torch.Tensor, fy: torch.Tensor,
                          fx: torch.Tensor, *, d_wobble: int) -> torch.Tensor:
    """The kernel's 64-tap sum in PyTorch, with the same taps, the same
    roundings in the same order and the same zeroing."""
    n, sz, sy, sx = dz.shape
    ey, ex = eblk.shape[2], eblk.shape[3]
    dmax = 2 * d_wobble
    ok = ((dz >= 0) & (dz <= dmax) & (dy >= 0) & (dy <= dmax)
          & (dx >= 0) & (dx <= dmax))
    zero = torch.zeros((), dtype=dz.dtype, device=dz.device)
    oz, oy, ox = (torch.where(ok, a, zero).to(torch.int64)
                  for a in (dz, dy, dx))
    dev = dz.device
    kk = torch.arange(sz, device=dev)[None, :, None, None]
    jj = torch.arange(sy, device=dev)[None, None, :, None]
    ii = torch.arange(sx, device=dev)[None, None, None, :]
    corner = (((kk + oz) * ey + (jj + oy)) * ex + (ii + ox)).reshape(n, -1)
    del oz, oy, ox
    flat = eblk.reshape(n, -1)
    bz, by, bx = basis4(fz), basis4(fy), basis4(fx)
    acc = torch.zeros_like(fz)
    for tz in range(4):
        for ty in range(4):
            wzy = bz[tz] * by[ty]
            for tx in range(4):
                tap = torch.gather(flat, 1, corner + ((tz * ey + ty) * ex
                                                      + tx))
                acc = acc + (wzy * bx[tx]) * tap.reshape(n, sz, sy, sx)
    return torch.where(ok, acc, torch.zeros_like(acc))


def bind(lib: ctypes.CDLL):
    """The kernel's C entry point in a loaded library, typed."""
    fn = lib.oc_lattice_eval_3d
    fn.argtypes = [_P] * 8 + [_I] * 8 + [_P]
    fn.restype = _I
    return fn


def c_args(eblk, dz, dy, dx, fz, fy, fx, out, d_wobble: int):
    """The C entry point's arguments for checked tensors, on the current
    stream."""
    return (eblk.data_ptr(), dz.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            fz.data_ptr(), fy.data_ptr(), fx.data_ptr(), out.data_ptr(),
            *dz.shape, *eblk.shape[1:], 2 * d_wobble,
            torch.cuda.current_stream().cuda_stream)


def lattice_eval_3d(eblk: torch.Tensor, dz: torch.Tensor, dy: torch.Tensor,
                    dx: torch.Tensor, fz: torch.Tensor, fy: torch.Tensor,
                    fx: torch.Tensor, *, d_wobble: int) -> torch.Tensor:
    """eblk: [N, sz+w-1, sy+w-1, sx+w-1] per-POI extended coefficient
    blocks, w = 4+2D; dz/dy/dx: [N, sz, sy, sx] int32 placement offsets in
    [0, 2D] (others give 0); fz/fy/fx: [N, sz, sy, sx] f32 fractional
    parts.  Returns [N, sz, sy, sx] f32."""
    if dz.dim() != 4:
        raise ValueError(f"dz must be [N, sz, sy, sx], got {tuple(dz.shape)}")
    n, sz, sy, sx = dz.shape
    w = 4 + 2 * d_wobble
    ext = (n, sz + w - 1, sy + w - 1, sx + w - 1)
    if tuple(eblk.shape) != ext:
        raise ValueError(f"eblk shape {tuple(eblk.shape)}, expected {ext}")
    for name, t in (("dy", dy), ("dx", dx), ("fz", fz), ("fy", fy),
                    ("fx", fx)):
        if t.shape != dz.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != dz shape "
                             f"{tuple(dz.shape)}")
    if eblk.device.type == "cpu":
        return lattice_eval_3d_plain(eblk, dz, dy, dx, fz, fy, fx,
                                     d_wobble=d_wobble)
    if eblk.device.type != "cuda":
        raise ValueError(f"unsupported device {eblk.device}")
    for name, t, dt in (("eblk", eblk, torch.float32),
                        ("dz", dz, torch.int32), ("dy", dy, torch.int32),
                        ("dx", dx, torch.int32), ("fz", fz, torch.float32),
                        ("fy", fy, torch.float32), ("fx", fx, torch.float32)):
        if t.device != eblk.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on "
                             f"{eblk.device}, got {t.dtype} on {t.device}")
    out = torch.empty((n, sz, sy, sx), dtype=torch.float32,
                      device=eblk.device)
    if n:
        with torch.cuda.device(eblk.device):
            fn = bind(_kernels.load("lattice3d"))
            _kernels.launch(lattice_eval_3d, lambda: fn(*c_args(
                eblk, dz, dy, dx, fz, fy, fx, out, d_wobble)),
                shape=(n, sz, sy, sx, d_wobble))
    return out


lattice_eval_3d.launches = 0  # kernel launches, for run-level checks
# a dict: launches by shape (n, sz, sy, sx, D), counted while it is set
lattice_eval_3d.shapes = None
# a list: (start, end) CUDA events and the shape of a launch
lattice_eval_3d.events = None
