"""Shape functions <-> homogeneous warp matrices.

Mirrors ``oc_deformation.cpp``, batched: in 2D first order 6 dof (u ux uy v
vx vy) <-> [N, 3, 3] affine (:107-128), second order 12 dof (u ux uy uxx
uxy uyy v vx vy vxx vxy vyy) <-> [N, 6, 6] quadratic warp (:284-350); in 3D
12 dof (u ux uy uz v vx vy vz w wx wy wz) <-> [N, 4, 4] (:416-432,
:495-516).  Parameter index order follows the POI unions (data/poi.py).
"""

from __future__ import annotations

import torch


def warp2d1_from_p(p6: torch.Tensor) -> torch.Tensor:
    """[N, 6] (u ux uy v vx vy) -> [N, 3, 3] (oc_deformation.cpp:117-128)."""
    u, ux, uy, v, vx, vy = (p6[..., i] for i in range(6))
    one = torch.ones_like(u)
    zero = torch.zeros_like(u)
    rows = [
        torch.stack([1.0 + ux, uy, u], dim=-1),
        torch.stack([vx, 1.0 + vy, v], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def p_from_warp2d1(w: torch.Tensor) -> torch.Tensor:
    """[N, 3, 3] -> [N, 6] (oc_deformation.cpp:107-115)."""
    return torch.stack(
        [w[..., 0, 2], w[..., 0, 0] - 1.0, w[..., 0, 1],
         w[..., 1, 2], w[..., 1, 0], w[..., 1, 1] - 1.0], dim=-1)


def warp2d2_from_p(p12: torch.Tensor) -> torch.Tensor:
    """[N, 12] (u ux uy uxx uxy uyy v vx vy vxx vxy vyy) -> [N, 6, 6]
    (oc_deformation.cpp:301-350), the full second-order composition."""
    u, ux, uy, uxx, uxy, uyy, v, vx, vy, vxx, vxy, vyy = (
        p12[..., i] for i in range(12))
    one = torch.ones_like(u)
    zero = torch.zeros_like(u)
    r0 = [1.0 + 2.0 * ux + ux * ux + u * uxx,
          2.0 * u * uxy + 2.0 * (1.0 + ux) * uy,
          uy * uy + u * uyy,
          2.0 * u * (1.0 + ux),
          2.0 * u * uy,
          u * u]
    r1 = [0.5 * (v * uxx + 2.0 * (1.0 + ux) * vx + u * vxx),
          1.0 + uy * vx + ux * vy + v * uxy + u * vxy + vy + ux,
          0.5 * (v * uyy + 2.0 * uy * (1.0 + vy) + u * vyy),
          v + v * ux + u * vx,
          u + v * uy + u * vy,
          u * v]
    r2 = [vx * vx + v * vxx,
          2.0 * v * vxy + 2.0 * vx * (1.0 + vy),
          1.0 + 2.0 * vy + vy * vy + v * vyy,
          2.0 * v * vx,
          2.0 * v * (1.0 + vy),
          v * v]
    r3 = [0.5 * uxx, uxy, 0.5 * uyy, 1.0 + ux, uy, u]
    r4 = [0.5 * vxx, vxy, 0.5 * vyy, vx, 1.0 + vy, v]
    r5 = [zero, zero, zero, zero, zero, one]
    return torch.stack([torch.stack(r, dim=-1)
                        for r in (r0, r1, r2, r3, r4, r5)], dim=-2)


def p_from_warp2d2(w: torch.Tensor) -> torch.Tensor:
    """[N, 6, 6] -> [N, 12] (oc_deformation.cpp:284-299)."""
    return torch.stack(
        [w[..., 3, 5], w[..., 3, 3] - 1.0, w[..., 3, 4], w[..., 3, 0] * 2.0,
         w[..., 3, 1], w[..., 3, 2] * 2.0,
         w[..., 4, 5], w[..., 4, 3], w[..., 4, 4] - 1.0, w[..., 4, 0] * 2.0,
         w[..., 4, 1], w[..., 4, 2] * 2.0], dim=-1)


def warp3d1_from_p(p12: torch.Tensor) -> torch.Tensor:
    """[N, 12] (u ux uy uz v vx vy vz w wx wy wz) -> [N, 4, 4] homogeneous
    (oc_deformation.cpp:495-516)."""
    u, ux, uy, uz, v, vx, vy, vz, w, wx, wy, wz = (p12[..., i]
                                                   for i in range(12))
    one = torch.ones_like(u)
    zero = torch.zeros_like(u)
    rows = [
        torch.stack([1.0 + ux, uy, uz, u], dim=-1),
        torch.stack([vx, 1.0 + vy, vz, v], dim=-1),
        torch.stack([wx, wy, 1.0 + wz, w], dim=-1),
        torch.stack([zero, zero, zero, one], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def p_from_warp3d1(w: torch.Tensor) -> torch.Tensor:
    """[N, 4, 4] -> [N, 12] (oc_deformation.cpp:416-432)."""
    return torch.stack(
        [w[..., 0, 3], w[..., 0, 0] - 1.0, w[..., 0, 1], w[..., 0, 2],
         w[..., 1, 3], w[..., 1, 0], w[..., 1, 1] - 1.0, w[..., 1, 2],
         w[..., 2, 3], w[..., 2, 0], w[..., 2, 1], w[..., 2, 2] - 1.0],
        dim=-1)
