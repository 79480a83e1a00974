"""First-order shape functions <-> homogeneous warp matrices.

Mirrors ``oc_deformation.cpp``, batched: in 2D 6 dof (u ux uy v vx vy) <->
[N, 3, 3] affine (:107-128); in 3D 12 dof (u ux uy uz v vx vy vz w wx wy
wz) <-> [N, 4, 4] (:416-432, :495-516).  Parameter index order follows the
POI unions (data/poi.py).
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
