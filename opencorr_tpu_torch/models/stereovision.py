"""Stereo triangulation (reference API: ``Stereovision``,
oc_stereovision.h:20).

Fundamental matrix F = K2^-T [t]x R2 K1^-1 (oc_stereovision.cpp:36-54);
``reconstruct`` undistorts both 2D points and solves the 4x3 linear
triangulation by least squares through its normal equations (:70-124),
batched over point arrays on the cameras' device, in the span
``stereovision.reconstruct``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import linalg as linalg_ops
from ..utils import timing
from ..utils.precision import fma
from .calibration import Calibration, undistort_points


def fundamental_matrix(view1_cam: Calibration,
                       view2_cam: Calibration) -> np.ndarray:
    """oc_stereovision.cpp:36-54, in numpy."""
    k2_inv_t = np.linalg.inv(view2_cam.intrinsic_matrix).T
    t = view2_cam.translation_vector
    t_x = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]],
                   np.float32)
    e = t_x @ view2_cam.rotation_matrix
    k1_inv = np.linalg.inv(view1_cam.intrinsic_matrix)
    return (k2_inv_t @ e @ k1_inv).astype(np.float32)


def triangulate(p1: torch.Tensor, p2: torch.Tensor, x1, y1, x2, y2):
    """Batched linear triangulation (oc_stereovision.cpp:87-122): the four
    rows x * P[2] - P[0], y * P[2] - P[1] of each view, solved through the
    normal equations.  p1/p2: [3, 4] projection matrices."""

    def rows(p, x, y):
        return (fma(x[:, None], p[2, :3], -p[0, :3]),
                fma(y[:, None], p[2, :3], -p[1, :3]),
                fma(-x, p[2, 3], p[0, 3]), fma(-y, p[2, 3], p[1, 3]))

    a0, a1, b0, b1 = rows(p1, x1, y1)
    a2, a3, b2, b3 = rows(p2, x2, y2)
    amat = torch.stack([a0, a1, a2, a3], dim=1)  # [N, 4, 3]
    bvec = torch.stack([b0, b1, b2, b3], dim=1)  # [N, 4]
    ata = linalg_ops.normal_product(amat, amat)
    atb = linalg_ops.normal_product(amat, bvec[:, :, None])[:, :, 0]
    return linalg_ops.solve_small(ata, atb)


class Stereovision:
    """Triangulation of matched points of two calibrated views; both
    cameras must be prepared (undistortion maps) on one device."""

    def __init__(self, view1_cam: Calibration, view2_cam: Calibration):
        self.view1_cam = view1_cam
        self.view2_cam = view2_cam
        self.fundamental_matrix = None

    def update_cameras(self, view1_cam: Calibration,
                       view2_cam: Calibration) -> None:
        self.view1_cam = view1_cam
        self.view2_cam = view2_cam

    def prepare(self) -> None:
        self.view1_cam.update_matrices()
        self.view2_cam.update_matrices()
        self.fundamental_matrix = fundamental_matrix(self.view1_cam,
                                                     self.view2_cam)

    def reconstruct(self, view1_pts, view2_pts) -> torch.Tensor:
        """[N, 2] points in both views -> [N, 3] world coordinates.  A NaN
        coordinate gives the zero point (oc_stereovision.cpp:72-76)."""
        c1, c2 = self.view1_cam, self.view2_cam
        if c1.map_x is None or c2.map_x is None:
            raise RuntimeError("prepare both cameras first")
        with timing.span("stereovision.reconstruct"):
            dev = c1.map_x.device
            as_t = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)
            v1, v2 = as_t(view1_pts), as_t(view2_pts)
            bad = torch.isnan(v1).any(1) | torch.isnan(v2).any(1)
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            v1 = torch.where(bad[:, None], zero, v1)
            v2 = torch.where(bad[:, None], zero, v2)
            x1, y1 = undistort_points(c1.map_x, c1.map_y, c1.intrinsics,
                                      v1[:, 0], v1[:, 1])
            x2, y2 = undistort_points(c2.map_x, c2.map_y, c2.intrinsics,
                                      v2[:, 0], v2[:, 1])
            world = triangulate(as_t(c1.projection_matrix),
                                as_t(c2.projection_matrix), x1, y1, x2, y2)
            return torch.where(bad[:, None], zero, world)
