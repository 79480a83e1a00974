"""Camera calibration: pinhole with rational radial and tangential
distortion (reference API: ``Calibration``, oc_calibration.h:47-96).

Intrinsics fx, fy, fs, cx, cy, k1..k6, p1, p2 (oc_calibration.h:25-35);
extrinsics a translation and an axis-angle rotation vector (:37-45,
Rodrigues, oc_calibration.cpp:50-60); projection matrix P = K[R|t]
(:69-77).  ``prepare`` inverts the distortion at every integer sensor pixel
by the reference's fixed-point iteration (conv 0.001, at most 40
iterations, :161-219), all pixels at once on the device; ``undistort`` looks
points up in those maps bilinearly and maps them back to the sensor
(:221-264), batched over point arrays.  ``prepare`` runs in the span
``calibration.prepare``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils import timing
from ..utils.precision import DeviceLike, f32, fma, resolve_device


@dataclasses.dataclass
class CameraIntrinsics:
    """oc_calibration.h:25-35."""

    fx: float = 0.0
    fy: float = 0.0
    fs: float = 0.0
    cx: float = 0.0
    cy: float = 0.0
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    k5: float = 0.0
    k6: float = 0.0
    p1: float = 0.0
    p2: float = 0.0


@dataclasses.dataclass
class CameraExtrinsics:
    """oc_calibration.h:37-45."""

    tx: float = 0.0
    ty: float = 0.0
    tz: float = 0.0
    rx: float = 0.0
    ry: float = 0.0
    rz: float = 0.0


_INTR = ("fx", "fy", "fs", "cx", "cy", "k1", "k2", "k3", "k4", "k5", "k6",
         "p1", "p2")


def rodrigues(rx: float, ry: float, rz: float) -> np.ndarray:
    """Axis-angle vector -> float32 rotation matrix (oc_calibration.cpp:
    50-60); the zero vector maps to the identity."""
    v = np.array([rx, ry, rz], np.float64)
    theta = np.linalg.norm(v)
    if theta < 1e-12:
        return np.eye(3, dtype=np.float32)
    k = v / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]],
                  np.float64)
    r = np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * (kx @ kx)
    return r.astype(np.float32)


def _distort(c, ix, iy):
    """Forward distortion of image coordinates (oc_calibration.cpp:
    136-159).  Each multiply-add rounds once where XLA fuses the JAX
    package's (the left product of a sum, ``fma``): the undistortion maps
    then equal the JAX package's bit for bit, so every pixel stops its
    fixed-point iteration on the same step."""
    xx = ix * ix
    yy = iy * iy
    xy = ix * iy
    r2 = fma(ix, ix, yy)
    r4 = r2 * r2
    r6 = r2 * r4
    radial = (fma(c["k3"], r6, fma(c["k2"], r4, fma(c["k1"], r2, 1.0)))
              / fma(c["k6"], r6, fma(c["k5"], r4, fma(c["k4"], r2, 1.0))))
    dy = fma(2 * c["p2"], xy, fma(iy, radial, c["p1"] * (r2 + 2 * yy)))
    dx = fma(c["p2"], r2 + 2 * xx, fma(ix, radial, 2 * c["p1"] * xy))
    return dx, dy


def build_undistortion_maps(intr: CameraIntrinsics, convergence: float,
                            height: int, width: int, iteration: int,
                            device: torch.device):
    """Per integer sensor pixel, the undistorted image coordinates
    (map_x, map_y) [H, W] float32, by the fixed-point inversion of the
    distortion (oc_calibration.cpp:161-219): every pixel iterates until
    both sensor residuals are within ``convergence``, at most ``iteration``
    times; a pixel whose residual is infinite reverts to its first guess
    and stops (:198-203)."""
    c = {k: f32(getattr(intr, k)) for k in _INTR}
    conv = f32(convergence)
    rgrid, cgrid = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    # sensor_to_image
    y0 = (rgrid - c["cy"]) / c["fy"]
    x0 = (cgrid - c["cx"] - c["fs"] * y0) / c["fx"]
    ix, iy = x0, y0
    done = torch.zeros_like(x0, dtype=torch.bool)
    for _ in range(iteration):
        dx_i, dy_i = _distort(c, ix, iy)
        # image_to_sensor
        sy = fma(dy_i, c["fy"], c["cy"])
        sx = fma(dx_i, c["fx"], dy_i * c["fs"]) + c["cx"]
        dev_x = cgrid - sx
        dev_y = rgrid - sy
        isinf = torch.isinf(dev_x) | torch.isinf(dev_y)
        converged = (dev_x.abs() <= conv) & (dev_y.abs() <= conv)
        step_y = dev_y / c["fy"]
        ny = torch.where(isinf, y0, iy + step_y)
        nx = torch.where(isinf, x0,
                         ix + fma(-step_y, c["fs"], dev_x) / c["fx"])
        upd = ~done & ~converged
        ix = torch.where(upd, nx, ix)
        iy = torch.where(upd, ny, iy)
        done = done | converged | isinf
    return ix, iy


def undistort_points(map_x: torch.Tensor, map_y: torch.Tensor,
                     intr: CameraIntrinsics, xs: torch.Tensor,
                     ys: torch.Tensor):
    """Batched ``undistort`` (oc_calibration.cpp:221-264): clamp into the
    map, bilinear lookup, then image -> sensor, with the JAX package's
    fused multiply-adds (``fma``)."""
    h, w = map_x.shape
    x = xs.clamp(0.0, w - 2.0)
    y = ys.clamp(0.0, h - 2.0)
    xi = torch.floor(x).long()
    yi = torch.floor(y).long()
    xd = x - xi.to(x.dtype)
    yd = y - yi.to(y.dtype)

    def bil(m):
        acc = fma(m[yi, xi] * (1 - yd), 1 - xd,
                  m[yi + 1, xi] * yd * (1 - xd))
        acc = fma(m[yi, xi + 1] * (1 - yd), xd, acc)
        return fma(m[yi + 1, xi + 1] * yd, xd, acc)

    ix = bil(map_x)
    iy = bil(map_y)
    sy = fma(iy, f32(intr.fy), f32(intr.cy))
    sx = fma(ix, f32(intr.fx), iy * f32(intr.fs)) + f32(intr.cx)
    return sx, sy


class Calibration:
    """Reference API (oc_calibration.h:47-96).  The undistortion maps live
    on ``device`` (cuda unless the caller names the CPU)."""

    def __init__(self, intrinsics: Optional[CameraIntrinsics] = None,
                 extrinsics: Optional[CameraExtrinsics] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.intrinsics = intrinsics or CameraIntrinsics()
        self.extrinsics = extrinsics or CameraExtrinsics()
        self.convergence = 0.001  # oc_calibration.cpp:23
        self.iteration = 40  # :24
        self.map_x: Optional[torch.Tensor] = None
        self.map_y: Optional[torch.Tensor] = None
        self.update_matrices()

    def update_matrices(self) -> None:
        i = self.intrinsics
        self.intrinsic_matrix = np.array(
            [[i.fx, i.fs, i.cx], [0, i.fy, i.cy], [0, 0, 1]], np.float32)
        self.rotation_matrix = rodrigues(
            self.extrinsics.rx, self.extrinsics.ry, self.extrinsics.rz)
        self.translation_vector = np.array(
            [self.extrinsics.tx, self.extrinsics.ty, self.extrinsics.tz],
            np.float32)
        rt = np.concatenate(
            [self.rotation_matrix, self.translation_vector[:, None]], axis=1)
        self.projection_matrix = self.intrinsic_matrix @ rt

    def update_calibration(self, intrinsics: CameraIntrinsics,
                           extrinsics: CameraExtrinsics) -> None:
        self.intrinsics = intrinsics
        self.extrinsics = extrinsics
        self.update_matrices()

    def set_undistortion(self, convergence: float, iteration: int) -> None:
        self.convergence = float(convergence)
        self.iteration = int(iteration)

    def prepare(self, height: int, width: int) -> None:
        """Build the [height, width] undistortion maps on the device."""
        with timing.span("calibration.prepare"):
            self.map_x, self.map_y = build_undistortion_maps(
                self.intrinsics, self.convergence, int(height), int(width),
                self.iteration, self.device)

    def undistort(self, xs, ys):
        """Sensor coordinates -> undistorted sensor coordinates, batched."""
        if self.map_x is None:
            raise RuntimeError("call prepare(height, width) first")
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32).to(
            self.device)
        return undistort_points(self.map_x, self.map_y, self.intrinsics,
                                as_t(xs), as_t(ys))

    def image_to_sensor(self, xs, ys):
        i = self.intrinsics
        return xs * i.fx + ys * i.fs + i.cx, ys * i.fy + i.cy

    def sensor_to_image(self, xs, ys):
        i = self.intrinsics
        iy = (ys - i.cy) / i.fy
        return (xs - i.cx - i.fs * iy) / i.fx, iy
