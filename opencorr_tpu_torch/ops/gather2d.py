"""Batched 2D window gather: N corners -> [N, sh, sw] windows of one image.

The CUDA kernel is ``csrc/gather2d.cu``.  ``gather_windows_2d`` launches it
for CUDA tensors and uses :func:`gather_windows_2d_plain` for CPU tensors.
Corners are clamped into the image, so both versions agree bit for bit on
any corner.  For corners >= 0 this is ``lax.dynamic_slice``'s clamp; a
negative corner clamps to 0, where ``dynamic_slice`` would first wrap it
from the end (no caller passes one).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _kernels

_P = ctypes.c_void_p
_I = ctypes.c_int


def gather_windows_2d_plain(img: torch.Tensor, y0: torch.Tensor,
                            x0: torch.Tensor, *, sh: int,
                            sw: int) -> torch.Tensor:
    """Advanced-indexing twin of the CUDA kernel."""
    h, w = img.shape
    yc = y0.to(torch.int64).clamp(0, h - sh)
    xc = x0.to(torch.int64).clamp(0, w - sw)
    rows = yc[:, None] + torch.arange(sh, device=img.device)
    cols = xc[:, None] + torch.arange(sw, device=img.device)
    return img[rows[:, :, None], cols[:, None, :]]


def bind(lib: ctypes.CDLL):
    """The kernel's C entry point in a loaded library, typed."""
    fn = lib.oc_gather_windows_2d
    fn.argtypes = [_P, _I, _I, _P, _P, _I, _I, _I, _P, _P]
    fn.restype = _I
    return fn


def c_args(img, y0, x0, out, sh: int, sw: int):
    """The C entry point's arguments for checked tensors, on the current
    stream."""
    return (img.data_ptr(), img.shape[0], img.shape[1], y0.data_ptr(),
            x0.data_ptr(), y0.shape[0], sh, sw, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)


@functools.lru_cache(maxsize=None)
def _entry():
    """The typed entry point of the package's build, bound once."""
    return bind(_kernels.load("gather2d"))


def gather_windows_2d(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                      *, sh: int, sw: int) -> torch.Tensor:
    """[N] int32 corners (y0, x0) -> [N, sh, sw] f32 windows of ``img``
    [H, W], corners clamped into the image."""
    if img.dim() != 2 or not (1 <= sh <= img.shape[0]
                              and 1 <= sw <= img.shape[1]):
        raise ValueError(f"window {sh}x{sw} does not fit image "
                         f"{tuple(img.shape)}")
    if img.device.type == "cpu":
        return gather_windows_2d_plain(img, y0, x0, sh=sh, sw=sw)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    n = y0.shape[0]
    for name, t, dt in (("img", img, torch.float32), ("y0", y0, torch.int32),
                        ("x0", x0, torch.int32)):
        if t.device != img.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on "
                             f"{img.device}, got {t.dtype} on {t.device}")
    if y0.shape != (n,) or x0.shape != (n,):
        raise ValueError(f"corner shapes {tuple(y0.shape)}, "
                         f"{tuple(x0.shape)}")
    out = torch.empty((n, sh, sw), dtype=torch.float32, device=img.device)
    if n:
        fn = _entry()
        with _kernels.on_device(img.device):
            _kernels.launch(gather_windows_2d, lambda: fn(*c_args(
                img, y0, x0, out, sh, sw)), shape=(n, sh, sw))
    return out


gather_windows_2d.launches = 0  # kernel launches, for run-level checks
# a dict: launches by shape (n, sh, sw), counted while it is set
gather_windows_2d.shapes = None
