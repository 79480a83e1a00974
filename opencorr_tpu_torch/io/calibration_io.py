"""Camera calibration CSV I/O (``IO2D::loadCalibration``, oc_io.cpp:142-247).

Format: a header line, then 13 intrinsics rows and 6 extrinsics rows, each
``<name>,<cam1 value>,<cam2 value>``.  Intrinsics order follows the
``CameraIntrinsics`` union (fx, fy, fs, cx, cy, k1..k6, p1, p2,
oc_calibration.h:25-35); extrinsics tx, ty, tz, rx, ry, rz (:37-45).
"""

from __future__ import annotations

from typing import Tuple

from ..models.calibration import Calibration, CameraExtrinsics, CameraIntrinsics
from ..utils.precision import DeviceLike

_INTR_FIELDS = ["fx", "fy", "fs", "cx", "cy", "k1", "k2", "k3", "k4", "k5",
                "k6", "p1", "p2"]
_EXTR_FIELDS = ["tx", "ty", "tz", "rx", "ry", "rz"]


def load_calibration(path: str, delimiter: str = ",",
                     device: DeviceLike = None
                     ) -> Tuple[Calibration, Calibration]:
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    i1, i2 = CameraIntrinsics(), CameraIntrinsics()
    e1, e2 = CameraExtrinsics(), CameraExtrinsics()
    for i, name in enumerate(_INTR_FIELDS):
        cells = lines[1 + i].split(delimiter)
        setattr(i1, name, float(cells[1]))
        setattr(i2, name, float(cells[2]))
    for i, name in enumerate(_EXTR_FIELDS):
        cells = lines[14 + i].split(delimiter)
        setattr(e1, name, float(cells[1]))
        setattr(e2, name, float(cells[2]))
    return (Calibration(i1, e1, device=device),
            Calibration(i2, e2, device=device))


def save_calibration(path: str, cam1: Calibration, cam2: Calibration,
                     delimiter: str = ",") -> None:
    with open(path, "w") as f:
        f.write(delimiter.join(["parameter", "cam1", "cam2"]) + "\n")
        for name in _INTR_FIELDS:
            f.write(delimiter.join(
                [name, repr(getattr(cam1.intrinsics, name)),
                 repr(getattr(cam2.intrinsics, name))]) + "\n")
        for name in _EXTR_FIELDS:
            f.write(delimiter.join(
                [name, repr(getattr(cam1.extrinsics, name)),
                 repr(getattr(cam2.extrinsics, name))]) + "\n")
