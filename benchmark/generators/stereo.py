"""Stereo frames of a speckled plate seen by two calibrated cameras.

The scene of OpenCorr's stereo example (``test_3d_dic_epipolar_sift.cpp``
on the GT4 pair): the example's two cameras (``CAMERAS``, pinhole with
radial distortion k1-k3) on a sensor of ``SENSOR`` pixels.  A plate lies
on the plane through the point of camera 1's ray through the sensor's
centre where the view-2 x parallax is ``parallax_x`` px (about 387 mm
deep for -30), its normal bisecting the two optical axes.  Its texture is
white noise filtered by a Gaussian of ``sigma`` cells, scaled to ``mean``
and ``std`` grey levels, on square cells of ``cell_mm`` laid along the
plane; it covers the plane over the view-1 rectangle ``plate`` (x0, y0,
x1, y1, sensor px), and past it the background is a uniform ``mean``.

A mix that names this generator (``"generator": "stereo"``) gives the
number of target frames, the ranges of the plate's rigid translation
(``translation_mm``: [low, high] per world axis x, y, z; z points away
from camera 1) and of its in-plane stretch about the moved centre point
(``stretch``), the scene (``parallax_x``, ``plate``) and the speckle.
Each target shows the plate at X' = c + t + (1 + s)(X - c), c the
plate's centre point.  Every seed gets the same set of motions: each
parameter takes the midpoints of ``targets`` equal strata of its range,
and the seed permutes which target takes which (a Latin hypercube); the
texture comes from the seed too.

Each view is rendered on the device in float64 by inverse mapping: pixel
-> its undistorted ray (the distortion inverted by fixed-point iteration)
-> the plate's plane -> the material point -> the texture, sampled by a
Catmull-Rom cubic, rounded to 8 bits.  A frame is a stereo pair, host
uint8 [2, H, W] (view 1, view 2), as two loaded images are.  ``origin``
(x, y), when the mix gives it, renders the window of the sensor whose
top-left pixel it is (a smaller ``shape`` then sees that window).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

SENSOR = (1200, 1920)  # GT4's views [H, W]
# the example's cameras (test_3d_dic_epipolar_sift.cpp:58-100) as
# (intrinsics, extrinsics); the configuration's file holds the same
CAMERAS = (
    (dict(fx=6673.315918, fy=6669.302734, fs=0.0, cx=872.15778,
          cy=579.95532, k1=0.032258954, k2=-1.01141417, k3=29.78838921),
     dict(tx=0.0, ty=0.0, tz=0.0, rx=0.0, ry=0.0, rz=0.0)),
    (dict(fx=6607.618164, fy=6602.857422, fs=0.0, cx=917.9733887,
          cy=531.6352539, k1=0.064598486, k2=-4.531373978, k3=29.78838921),
     dict(tx=122.24886, ty=1.8488892, tz=17.624638, rx=0.00307711,
          ry=-0.33278773, rz=0.00524556)))
RAY_ITERATIONS = 30  # the inversion contracts by 1e-2 or more a step


def rodrigues(rx: float, ry: float, rz: float) -> np.ndarray:
    """Axis-angle vector -> float64 rotation matrix."""
    v = np.array([rx, ry, rz], np.float64)
    th = np.linalg.norm(v)
    if th == 0.0:
        return np.eye(3)
    k = v / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * (kx @ kx)


class Camera:
    """One camera in float64 on ``device``: the intrinsics (k1-k6, p1,
    p2 as OpenCorr's, oc_calibration.cpp:136-159), rotation R and
    translation T (camera = R world + T)."""

    def __init__(self, intr: dict, extr: dict, device):
        self.k = dict(fx=0.0, fy=0.0, fs=0.0, cx=0.0, cy=0.0, k1=0.0, k2=0.0,
                      k3=0.0, k4=0.0, k5=0.0, k6=0.0, p1=0.0, p2=0.0)
        self.k.update(intr)
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float64,
                                         device=device)
        self.r = as_t(rodrigues(extr["rx"], extr["ry"], extr["rz"]))
        self.t = as_t([extr["tx"], extr["ty"], extr["tz"]])

    def distort(self, x, y):
        c = self.k
        r2 = x * x + y * y
        rad = ((1 + c["k1"] * r2 + c["k2"] * r2 ** 2 + c["k3"] * r2 ** 3)
               / (1 + c["k4"] * r2 + c["k5"] * r2 ** 2 + c["k6"] * r2 ** 3))
        return (x * rad + 2 * c["p1"] * x * y + c["p2"] * (r2 + 2 * x * x),
                y * rad + c["p1"] * (r2 + 2 * y * y) + 2 * c["p2"] * x * y)

    def project(self, pts: torch.Tensor) -> torch.Tensor:
        """World points [N, 3] -> distorted sensor coordinates [N, 2]."""
        c = self.k
        xc = pts @ self.r.T + self.t
        x, y = self.distort(xc[:, 0] / xc[:, 2], xc[:, 1] / xc[:, 2])
        return torch.stack([c["fx"] * x + c["fs"] * y + c["cx"],
                            c["fy"] * y + c["cy"]], -1)

    def rays(self, u: torch.Tensor, v: torch.Tensor):
        """Sensor coordinates -> (origin [3], unit directions [N, 3]) of
        the rays they see."""
        c = self.k
        yd = (v - c["cy"]) / c["fy"]
        xd = (u - c["cx"] - c["fs"] * yd) / c["fx"]
        x, y = xd, yd
        for _ in range(RAY_ITERATIONS):
            dx, dy = self.distort(x, y)
            x, y = x + (xd - dx), y + (yd - dy)
        d = torch.stack([x, y, torch.ones_like(x)], -1) @ self.r
        return -self.r.T @ self.t, d / d.norm(dim=1, keepdim=True)


def _gaussian(field: torch.Tensor, sigma: float, radius: int):
    """Separable Gaussian over both axes, 'valid' extent."""
    t = torch.arange(-radius, radius + 1, dtype=torch.float64)
    taps = torch.exp(-0.5 * (t / sigma) ** 2)
    taps = (taps / taps.sum()).tolist()
    for axis in range(2):
        n = field.shape[axis] - 2 * radius
        acc = taps[0] * field.narrow(axis, 0, n)
        for k in range(1, 2 * radius + 1):
            acc = acc + taps[k] * field.narrow(axis, k, n)
        field = acc
    return field


def _catmull_rom(t: torch.Tensor) -> torch.Tensor:
    return torch.stack([0.5 * (-t ** 3 + 2 * t ** 2 - t),
                        0.5 * (3 * t ** 3 - 5 * t ** 2 + 2),
                        0.5 * (-3 * t ** 3 + 4 * t ** 2 + t),
                        0.5 * (t ** 3 - t ** 2)], -1)


class Scene:
    """The plate, its texture and the two cameras (module docstring)."""

    def __init__(self, mix: dict, seed: int, device):
        self.dev = torch.device(device)
        self.cams = [Camera(i, e, self.dev) for i, e in CAMERAS]
        h, w = SENSOR
        c1, c2 = self.cams
        # the depth along camera 1's central ray where the x parallax is
        # parallax_x (bisection; the parallax grows with depth)
        o, d = c1.rays(*(torch.tensor([a], dtype=torch.float64,
                                      device=self.dev) for a in (w / 2.0,
                                                                 h / 2.0)))
        want = float(mix["parallax_x"])
        par = lambda s: float(c2.project(o + d * s)[0, 0]) - w / 2.0 - want
        lo, hi = 50.0, 5000.0
        if par(lo) * par(hi) >= 0:
            raise ValueError("no depth gives the parallax")
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            lo, hi = (mid, hi) if par(mid) * par(lo) > 0 else (lo, mid)
        self.x0 = (o + d * lo)[0]
        axes = [cam.r.T @ torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64,
                                       device=self.dev) for cam in self.cams]
        n = -(axes[0] + axes[1])
        self.normal = n / n.norm()
        e1 = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64,
                          device=self.dev) - self.normal[0] * self.normal
        self.e1 = e1 / e1.norm()
        self.e2 = torch.linalg.cross(self.normal, self.e1)
        sp = mix["speckle"]
        self.cell = float(sp["cell_mm"])
        self.mean = float(sp["mean"])
        x0, y0, x1, y1 = mix["plate"]
        gy, gx = torch.meshgrid(
            torch.linspace(y0, y1, 9, dtype=torch.float64, device=self.dev),
            torch.linspace(x0, x1, 9, dtype=torch.float64, device=self.dev),
            indexing="ij")
        st = self.plane_coords(self.on_plane(0, gx.reshape(-1),
                                             gy.reshape(-1), self.x0))
        self.lo = st.min(0).values
        cells = torch.ceil((st.max(0).values - self.lo) / self.cell).long() + 1
        radius = int(math.ceil(4.0 * sp["sigma"]))
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(int(seed))
        noise = torch.randn((int(cells[1]) + 2 * radius,
                             int(cells[0]) + 2 * radius), generator=gen,
                            device=self.dev, dtype=torch.float64)
        tex = _gaussian(noise, sp["sigma"], radius)
        tex = (tex - tex.mean()) / tex.std() * sp["std"] + self.mean
        # two cells of background on each side for the cubic's taps
        self.tex = torch.nn.functional.pad(tex, (2, 2, 2, 2),
                                           value=self.mean)

    def plane_coords(self, pts: torch.Tensor) -> torch.Tensor:
        """Points on the reference plane -> (s, t) mm along (e1, e2)."""
        rel = pts - self.x0
        return torch.stack([rel @ self.e1, rel @ self.e2], -1)

    def on_plane(self, view: int, u, v, point) -> torch.Tensor:
        """The points of the plane through ``point`` (normal ``normal``)
        seen at sensor (u, v) of ``view``."""
        o, d = self.cams[view].rays(u, v)
        t = ((point - o) @ self.normal) / (d @ self.normal)
        return o + d * t[:, None]

    def texture(self, st: torch.Tensor) -> torch.Tensor:
        """Grey levels at plane coordinates [N, 2] (mm)."""
        q = (st - self.lo) / self.cell + 2.0  # [N, 2] (col, row)
        rows, cols = self.tex.shape
        inside = ((q[:, 0] >= 1) & (q[:, 0] < cols - 2)
                  & (q[:, 1] >= 1) & (q[:, 1] < rows - 2))
        q = torch.where(inside[:, None], q, torch.ones_like(q))
        i = torch.floor(q)
        wx = _catmull_rom(q[:, 0] - i[:, 0])
        wy = _catmull_rom(q[:, 1] - i[:, 1])
        base = (i[:, 1].long() - 1) * cols + i[:, 0].long() - 1
        flat = self.tex.reshape(-1)
        val = torch.zeros_like(q[:, 0])
        for a in range(4):
            for b in range(4):
                val = val + wy[:, a] * wx[:, b] * flat[base + a * cols + b]
        return torch.where(inside, val, torch.full_like(val, self.mean))

    def render(self, view: int, shape, origin, shift=None,
               stretch: float = 0.0, band: int = 256) -> np.ndarray:
        """View ``view`` [H, W] uint8 of the plate, moved by ``shift``
        [3] mm and stretched by ``stretch`` about the moved centre."""
        h, w = shape
        moved = self.x0 if shift is None else self.x0 + shift
        out = torch.empty((h, w), dtype=torch.uint8, device=self.dev)
        cols = torch.arange(w, dtype=torch.float64, device=self.dev)
        for r0 in range(0, h, band):
            rows = torch.arange(r0, min(r0 + band, h), dtype=torch.float64,
                                device=self.dev)
            vv, uu = torch.meshgrid(rows + origin[1], cols + origin[0],
                                    indexing="ij")
            pts = self.on_plane(view, uu.reshape(-1), vv.reshape(-1), moved)
            if shift is not None:  # the material point now at pts
                pts = self.x0 + (pts - moved) / (1.0 + stretch)
            val = self.texture(self.plane_coords(pts))
            out[r0:r0 + len(rows)] = torch.clamp(torch.round(val), 0, 255).to(
                torch.uint8).reshape(len(rows), w)
        return out.cpu().numpy()


@dataclasses.dataclass
class Sequence:
    """A reference stereo pair and its target pairs (host uint8 [2, H, W]),
    with each target's rigid translation [T, 3] (mm) and in-plane stretch
    [T, 1] about the plate's centre point ``center`` [3] (mm)."""

    reference: np.ndarray
    targets: List[np.ndarray]
    translations: np.ndarray
    strains: np.ndarray
    center: np.ndarray
    scene: Scene
    origin: tuple

    def displacement(self, k: int, points: np.ndarray) -> np.ndarray:
        """Target ``k``'s 3D displacement (mm) of reference points [N, 3]
        on the plate (world coordinates, mm)."""
        return (self.translations[k] + self.strains[k]
                * (np.asarray(points, np.float64) - self.center))

    def truth(self, k: int, points: np.ndarray) -> dict:
        """Frame points [N, 2] of view 1 -> their true matches [N, 2]:
        ``r2`` (view 2 of the reference), ``t1``, ``t2`` (the target's
        views), the reference points ``ref3d`` and their displacement
        ``disp`` [N, 3] (mm)."""
        sc = self.scene
        org = torch.tensor(self.origin, dtype=torch.float64, device=sc.dev)
        pts = torch.as_tensor(np.asarray(points, np.float64),
                              device=sc.dev) + org
        ref = sc.on_plane(0, pts[:, 0], pts[:, 1], sc.x0)
        disp = torch.as_tensor(self.displacement(k, ref.cpu().numpy()),
                               device=sc.dev)
        tar = ref + disp
        to = lambda a: a.cpu().numpy()
        return dict(r2=to(sc.cams[1].project(ref) - org),
                    t1=to(sc.cams[0].project(tar) - org),
                    t2=to(sc.cams[1].project(tar) - org), ref3d=to(ref),
                    disp=to(disp))


def motions(traffic: dict, seed: int):
    """(translations [T, 3] mm, stretches [T, 1]) of the mix for
    ``seed``."""
    n = int(traffic["targets"])
    rng = np.random.default_rng(seed)
    mid = (np.arange(n) + 0.5) / n
    ranges = list(traffic["translation_mm"]) + [traffic["stretch"]]
    cols = [lo + (hi - lo) * mid[rng.permutation(n)] for lo, hi in ranges]
    return np.stack(cols[:3], -1), np.stack(cols[3:], -1)


def make_sequence(shape, traffic: dict, seed: int, device) -> Sequence:
    """The reference and target stereo pairs, each view of ``shape`` [H,
    W], for ``seed``."""
    trans, stretch = motions(traffic, seed)
    scene = Scene(traffic, seed, device)
    origin = tuple(float(a) for a in traffic.get("origin", (0, 0)))
    dev = scene.dev

    def pair(shift=None, s=0.0):
        return np.stack([scene.render(v, shape, origin, shift, s)
                         for v in (0, 1)])

    targets = [pair(torch.as_tensor(trans[k], device=dev),
                    float(stretch[k, 0])) for k in range(len(trans))]
    return Sequence(pair(), targets, trans, stretch,
                    scene.x0.cpu().numpy(), scene, origin)
