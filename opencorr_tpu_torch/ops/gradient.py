"""4th-order-accurate first-derivative maps of images and volumes.

Reference: ``oc_gradient.cpp`` -- central difference with stencil +-2 px and
coefficients 1/12, 2/3 (oc_gradient.cpp:21-22), border 2 px left at zero.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

FIRST = float(np.float32(1.0 / 12.0))
SECOND = float(np.float32(2.0 / 3.0))


def gradient_x_2d(img: torch.Tensor) -> torch.Tensor:
    """d/dx with zero 2-px borders (oc_gradient.cpp:37-57). img: [H, W]."""
    g = ((img[:, :-4] - img[:, 4:]) * FIRST
         + (img[:, 3:-1] - img[:, 1:-3]) * SECOND)
    return F.pad(g, (2, 2))


def gradient_y_2d(img: torch.Tensor) -> torch.Tensor:
    """d/dy with zero 2-px borders (oc_gradient.cpp:59-79)."""
    g = ((img[:-4, :] - img[4:, :]) * FIRST
         + (img[3:-1, :] - img[1:-3, :]) * SECOND)
    return F.pad(g, (0, 0, 2, 2))


def gradient_x_3d(vol: torch.Tensor) -> torch.Tensor:
    """d/dx over a [Z, Y, X] volume, zero 2-voxel borders
    (oc_gradient.cpp:143-171)."""
    g = ((vol[:, :, :-4] - vol[:, :, 4:]) * FIRST
         + (vol[:, :, 3:-1] - vol[:, :, 1:-3]) * SECOND)
    return F.pad(g, (2, 2))


def gradient_y_3d(vol: torch.Tensor) -> torch.Tensor:
    g = ((vol[:, :-4, :] - vol[:, 4:, :]) * FIRST
         + (vol[:, 3:-1, :] - vol[:, 1:-3, :]) * SECOND)
    return F.pad(g, (0, 0, 2, 2))


def gradient_z_3d(vol: torch.Tensor) -> torch.Tensor:
    g = ((vol[:-4] - vol[4:]) * FIRST + (vol[3:-1] - vol[1:-3]) * SECOND)
    return F.pad(g, (0, 0, 0, 0, 2, 2))
