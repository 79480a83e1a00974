"""Batched small-matrix inverses and solves.

The same unrolled Gauss-Jordan elimination without pivoting as the JAX
package, so both give the same numbers for the 3x3..12x12 systems of DIC
and DVC (2D and 3D warp inverses, the 6x6 and 12x12 Hessians, strain
normal equations).  No pivoting is safe
for every system this engine produces: Hessians and normal equations are
SPD, warp matrices are near-identity.  A zero pivot yields inf/NaN, which
the callers' NaN code (-5) handles.
"""

from __future__ import annotations

import torch

from ..utils.precision import fma


def normal_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a[n, k, i] * b[n, k, j] -> [N, I, J] float32, each term added
    in k order as one fused multiply-add (``fma``): the order in which XLA
    computes the JAX package's small batched einsums (normal equations) on
    the CPU."""
    acc = torch.zeros((a.shape[0], a.shape[2], b.shape[2]),
                      dtype=torch.float32, device=a.device)
    for k in range(a.shape[1]):
        acc = fma(a[:, k, :, None], b[:, k, None, :], acc)
    return acc


def _eliminate(aug: torch.Tensor, k: int) -> torch.Tensor:
    """Each update aug - factor * row rounds once to float32, as a fused
    multiply-add: XLA compiles the JAX package's elimination so on the CPU.
    The product of two float32 values is exact in float64, so only the
    difference rounds (``fma``'s rule, written out here to keep float64
    systems, such as IC-GN's reference replay, in float64)."""
    for i in range(k):
        pivot = aug[..., i: i + 1, i: i + 1]
        row = aug[..., i: i + 1, :] / pivot
        factors = aug[..., :, i: i + 1]
        aug = (aug.double() - factors.double() * row.double()).to(aug.dtype)
        aug[..., i, :] = row[..., 0, :]
    return aug


def inv_small(a: torch.Tensor) -> torch.Tensor:
    """Inverse of [..., K, K] (K small) via unrolled Gauss-Jordan."""
    k = a.shape[-1]
    eye = torch.eye(k, dtype=a.dtype, device=a.device).expand(a.shape)
    return _eliminate(torch.cat([a, eye], dim=-1), k)[..., :, k:]


def solve_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a x = b with a [..., K, K] and b [..., K] or [..., K, M]."""
    vec = b.dim() == a.dim() - 1
    if vec:
        b = b[..., None]
    k = a.shape[-1]
    x = _eliminate(torch.cat([a, b], dim=-1), k)[..., :, k:]
    return x[..., 0] if vec else x
