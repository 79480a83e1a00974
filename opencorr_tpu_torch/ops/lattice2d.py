"""Gather-free bicubic B-spline evaluation over per-POI extended blocks.

For POI b and subset sample (i, j):

  out[b,i,j] = sum_{ty,tx} wy_ty(fy) * wx_tx(fx) * eblk[b, i+dy+ty, j+dx+tx]

with w_t the ``BC_MATRIX`` cubics, and exactly 0 when dy or dx lies outside
[0, 2D].  This is the reference's per-pixel polynomial evaluation
(oc_cubic_bspline.cpp:134-181) written as a separable 4x4-tap sum over the
raw image: the same real number as the LUT eval, with the float32 sum
reordered (~1e-6 relative).

The CUDA kernel is ``csrc/lattice2d.cu``.  ``lattice_eval_2d`` launches it
for CUDA tensors and uses :func:`lattice_eval_2d_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _kernels
from .bspline import BC_MATRIX

_P = ctypes.c_void_p
_I = ctypes.c_int
_BC = [[float(v) for v in row] for row in BC_MATRIX]


def _tap_weights(f: torch.Tensor):
    """The four cubic weights of fractional parts ``f``, in the kernel's
    rounding order."""
    return [_BC[3][t] + f * (_BC[2][t] + f * (_BC[1][t] + f * _BC[0][t]))
            for t in range(4)]


def lattice_eval_2d_plain(eblk: torch.Tensor, dy: torch.Tensor,
                          dx: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor,
                          *, d_wobble: int) -> torch.Tensor:
    """The kernel's 16-tap sum in PyTorch, with the same taps, the same
    order and the same zeroing."""
    n, sy, sx = dy.shape
    ex = eblk.shape[2]
    dmax = 2 * d_wobble
    ok = (dy >= 0) & (dy <= dmax) & (dx >= 0) & (dx <= dmax)
    zero = torch.zeros((), dtype=dy.dtype, device=dy.device)
    oy = torch.where(ok, dy, zero).to(torch.int64)
    ox = torch.where(ok, dx, zero).to(torch.int64)
    ii = torch.arange(sy, device=dy.device)[None, :, None]
    jj = torch.arange(sx, device=dy.device)[None, None, :]
    corner = ((ii + oy) * ex + (jj + ox)).reshape(n, -1)
    flat = eblk.reshape(n, -1)
    wy = _tap_weights(fy)
    wx = _tap_weights(fx)
    acc = torch.zeros_like(fy)
    for ty in range(4):
        for tx in range(4):
            tap = torch.gather(flat, 1, corner + (ty * ex + tx))
            acc = acc + (wy[ty] * wx[tx]) * tap.reshape(n, sy, sx)
    return torch.where(ok, acc, torch.zeros_like(acc))


def bind(lib: ctypes.CDLL):
    """The kernel's C entry point in a loaded library, typed."""
    fn = lib.oc_lattice_eval_2d
    fn.argtypes = [_P] * 6 + [_I] * 6 + [_P]
    fn.restype = _I
    return fn


def c_args(eblk, dy, dx, fy, fx, out, d_wobble: int):
    """The C entry point's arguments for checked tensors, on the current
    stream."""
    return (eblk.data_ptr(), dy.data_ptr(), dx.data_ptr(), fy.data_ptr(),
            fx.data_ptr(), out.data_ptr(), *dy.shape, *eblk.shape[1:],
            2 * d_wobble, torch.cuda.current_stream().cuda_stream)


@functools.lru_cache(maxsize=None)
def _entry():
    """The typed entry point of the package's build, bound once."""
    return bind(_kernels.load("lattice2d"))


def lattice_eval_2d(eblk: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                    fy: torch.Tensor, fx: torch.Tensor, *,
                    d_wobble: int) -> torch.Tensor:
    """eblk: [N, sy+w-1, sx+w-1] per-POI extended image blocks, w = 4+2D;
    dy/dx: [N, sy, sx] int32 placement offsets in [0, 2D] (others give 0);
    fy/fx: [N, sy, sx] f32 fractional parts.  Returns [N, sy, sx] f32."""
    n, sy, sx = dy.shape
    w = 4 + 2 * d_wobble
    ey, ex = sy + w - 1, sx + w - 1
    if tuple(eblk.shape) != (n, ey, ex):
        raise ValueError(f"eblk shape {tuple(eblk.shape)}, expected "
                         f"{(n, ey, ex)}")
    for name, t in (("dx", dx), ("fy", fy), ("fx", fx)):
        if t.shape != dy.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != dy shape "
                             f"{tuple(dy.shape)}")
    if eblk.device.type == "cpu":
        return lattice_eval_2d_plain(eblk, dy, dx, fy, fx, d_wobble=d_wobble)
    if eblk.device.type != "cuda":
        raise ValueError(f"unsupported device {eblk.device}")
    for name, t, dt in (("eblk", eblk, torch.float32),
                        ("dy", dy, torch.int32), ("dx", dx, torch.int32),
                        ("fy", fy, torch.float32), ("fx", fx, torch.float32)):
        if t.device != eblk.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on "
                             f"{eblk.device}, got {t.dtype} on {t.device}")
    out = torch.empty((n, sy, sx), dtype=torch.float32, device=eblk.device)
    if n:
        fn = _entry()
        with _kernels.on_device(eblk.device):
            _kernels.launch(lattice_eval_2d, lambda: fn(*c_args(
                eblk, dy, dx, fy, fx, out, d_wobble)),
                shape=(n, sy, sx, d_wobble))
    return out


lattice_eval_2d.launches = 0  # kernel launches, for run-level checks
# a dict: launches by shape (n, sy, sx, D), counted while it is set
lattice_eval_2d.shapes = None
