"""FFTCC3D's exact re-rank of its candidate peaks in one CUDA kernel.

For POI n with float32 windows R and T ([N, wz, wy, wx], each voxel
rounded half to even as ``torch.round`` rounds it) and candidate flat
shifts c ([N, 8]), the kernel scores

  S_c = sum_x R[x] * T[(x + c) mod (wz, wy, wx)]

exactly in 64 bits and returns each POI's winner: the largest S_c, the
smallest flat index among equal scores.  No [N, V] tensor is made.

The kernel is ``csrc/fftcc3d_rerank.cuh``, built into the ``lattice3d``
library.  Its plain version is ``fftcc._rerank3d``, which takes the
rounded windows as int32 and the correlation to draw the candidates from;
``fftcc.fftcc3d`` runs that on the CPU and this wrapper on CUDA.  Where
the plain version's int32 products do not wrap (FFTCC3D's range guards
hold for windows of 256 voxels and more), the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels

NCAND = 8  # candidates a POI

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _bind(lib: ctypes.CDLL):
    fn = lib.oc_fftcc3d_rerank
    fn.argtypes = [_P] * 5 + [_LL] + [_I] * 3 + [_P]
    fn.restype = _I
    smem = lib.oc_fftcc3d_rerank_smem
    smem.argtypes = [_I] * 3
    smem.restype = _LL
    return fn, smem


def smem_bytes(wz: int, wy: int, wx: int) -> int:
    """Dynamic shared memory a block of the kernel takes at (wz, wy, wx)
    windows (0: its planes are read unstaged)."""
    return int(_bind(_kernels.load("lattice3d"))[1](wz, wy, wx))


def rerank_3d(ref_w: torch.Tensor, tar_w: torch.Tensor,
              cand: torch.Tensor) -> torch.Tensor:
    """Winners [N] int64 of ``cand`` ([N, 8] int64 flat shifts in [0, V))
    for the windows ``ref_w`` and ``tar_w`` ([N, wz, wy, wx] float32), all
    contiguous on one CUDA device."""
    dev = ref_w.device
    if dev.type != "cuda":
        raise ValueError(f"rerank_3d runs on CUDA tensors, got {dev} (the "
                         "plain version is fftcc._rerank3d)")
    for name, t, dt in (("ref_w", ref_w, torch.float32),
                        ("tar_w", tar_w, torch.float32),
                        ("cand", cand, torch.int64)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    if ref_w.dim() != 4 or tar_w.shape != ref_w.shape:
        raise ValueError(f"windows {tuple(ref_w.shape)} and "
                         f"{tuple(tar_w.shape)}: need two [N, wz, wy, wx]")
    n, wz, wy, wx = ref_w.shape
    if tuple(cand.shape) != (n, NCAND):
        raise ValueError(f"cand shape {tuple(cand.shape)}, expected "
                         f"{(n, NCAND)}")
    out = torch.empty(n, dtype=torch.int64, device=dev)
    scores = torch.empty((n, NCAND), dtype=torch.int64, device=dev)
    if n:
        with _kernels.on_device(dev):
            fn = _bind(_kernels.load("lattice3d"))[0]
            _kernels.launch(rerank_3d, lambda: fn(
                ref_w.data_ptr(), tar_w.data_ptr(), cand.data_ptr(),
                scores.data_ptr(), out.data_ptr(), n, wz, wy, wx,
                torch.cuda.current_stream(dev).cuda_stream),
                shape=(n, wz, wy, wx))
    return out


rerank_3d.launches = 0  # calls (two kernel launches each), for run checks
# a dict: calls by shape (n, wz, wy, wx), counted while it is set
rerank_3d.shapes = None
# a list: (start, end) CUDA events and the shape of a call
rerank_3d.events = None
