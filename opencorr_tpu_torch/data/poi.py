"""POI (point-of-interest) tables as dataclasses of tensors, 2D and 3D.

Field layouts follow the reference unions (oc_poi.h:32-98) so OpenCorr CSV
files read and write unmodified:

* 2D deformation ``p``: u ux uy uxx uxy uyy v vx vy vxx vxy vyy
* 2D result ``r``: u0 v0 zncc iteration convergence feature
* 2D strain ``e``: exx eyy exy
* 3D deformation ``p``: u ux uy uz v vx vy vz w wx wy wz
* 3D result ``r``: u0 v0 w0 zncc iteration convergence feature
* 3D strain ``e``: exx eyy ezz exy eyz ezx
* stereo (2DS) result ``r``: r1r2_zncc r1t1_zncc r1t2_zncc r2_x r2_y t1_x
  t1_y t2_x t2_y (oc_poi.h:57); ``p`` is the 3D displacement (u, v, w) and
  ``e`` the 3D strain

Negative ZNCC encodes the reference failure taxonomy (oc_dic.h:28-34):
0 reset, -1 insufficient features, -2 RANSAC inconsistent, -3 out of bounds
or aborted, -4 not converged, -5 NaN.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import timing
from ..utils.precision import DeviceLike, resolve_device

# Indices into the 2D deformation vector p[12].
U, UX, UY, UXX, UXY, UYY, V, VX, VY, VXX, VXY, VYY = range(12)
# Indices into the 2D result vector r[6].
R_U0, R_V0, R_ZNCC, R_ITER, R_CONV, R_FEAT = range(6)
# Indices into the 3D deformation vector p[12].
U3, UX3, UY3, UZ3, V3, VX3, VY3, VZ3, W3, WX3, WY3, WZ3 = range(12)
# Indices into the 3D result vector r[7].
R3_U0, R3_V0, R3_W0, R3_ZNCC, R3_ITER, R3_CONV, R3_FEAT = range(7)


@dataclasses.dataclass
class POITable2D:
    """Dense batch of 2D DIC POIs (mirrors ``POI2D``, oc_poi.h:102)."""

    # per-POI tensor fields, in constructor order
    FIELDS = ("x", "y", "p", "r", "e", "sr")
    # widths of the [N, k] fields
    WIDTHS = (("p", 12), ("r", 6), ("e", 3), ("sr", 2))

    x: torch.Tensor  # [N] f32
    y: torch.Tensor  # [N] f32
    p: torch.Tensor  # [N, 12] f32 deformation
    r: torch.Tensor  # [N, 6] f32 result
    e: torch.Tensor  # [N, 3] f32 strain
    sr: torch.Tensor  # [N, 2] f32 subset radius (x, y)
    # host copy of (x, y), filled on first use by host-side neighbor
    # searches and carried across replace() while x and y are unchanged
    host_xy: Optional[Tuple[np.ndarray, np.ndarray]] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def u(self) -> torch.Tensor:
        return self.p[:, U]

    @property
    def v(self) -> torch.Tensor:
        return self.p[:, V]

    @property
    def zncc(self) -> torch.Tensor:
        return self.r[:, R_ZNCC]

    def replace(self, **kw) -> "POITable2D":
        if "x" in kw or "y" in kw:
            kw.setdefault("host_xy", None)
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "POITable2D":
        """Apply ``fn`` to every per-POI tensor (x and y included)."""
        return type(self)(*(fn(getattr(self, f)) for f in self.FIELDS))

    def xy_numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        """Host float32 copies of x and y, read back once per table (the
        host read ``poi.sync.coords``, ``utils/timing.host_read``)."""
        if self.host_xy is None:
            self.host_xy = tuple(timing.host_read("poi.sync.coords", a)
                                 for a in (self.x, self.y))
        return self.host_xy

    coords_numpy = xy_numpy


@dataclasses.dataclass
class POITable3D:
    """Dense batch of DVC POIs (mirrors ``POI3D``, oc_poi.h:187)."""

    FIELDS = ("x", "y", "z", "p", "r", "e", "sr")
    WIDTHS = (("p", 12), ("r", 7), ("e", 6), ("sr", 3))

    x: torch.Tensor  # [N] f32
    y: torch.Tensor  # [N] f32
    z: torch.Tensor  # [N] f32
    p: torch.Tensor  # [N, 12] f32 deformation
    r: torch.Tensor  # [N, 7] f32 result
    e: torch.Tensor  # [N, 6] f32 strain
    sr: torch.Tensor  # [N, 3] f32 subset radius (x, y, z)
    # host copy of (x, y, z), as POITable2D.host_xy
    host_xyz: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = \
        dataclasses.field(default=None, repr=False, compare=False)

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def u(self) -> torch.Tensor:
        return self.p[:, U3]

    @property
    def v(self) -> torch.Tensor:
        return self.p[:, V3]

    @property
    def w(self) -> torch.Tensor:
        return self.p[:, W3]

    @property
    def zncc(self) -> torch.Tensor:
        return self.r[:, R3_ZNCC]

    def replace(self, **kw) -> "POITable3D":
        if "x" in kw or "y" in kw or "z" in kw:
            kw.setdefault("host_xyz", None)
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "POITable3D":
        """Apply ``fn`` to every per-POI tensor (x, y and z included)."""
        return POITable3D(*(fn(getattr(self, f)) for f in self.FIELDS))

    def coords_numpy(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host float32 copies of x, y and z, read back once per table
        (the host read ``poi.sync.coords``)."""
        if self.host_xyz is None:
            self.host_xyz = tuple(timing.host_read("poi.sync.coords", a)
                                  for a in (self.x, self.y, self.z))
        return self.host_xyz


@dataclasses.dataclass
class POITable2DS:
    """Dense batch of stereo DIC POIs (mirrors ``POI2DS``, oc_poi.h:140)."""

    FIELDS = ("x", "y", "p", "r", "ref_coor", "tar_coor", "e", "sr")
    WIDTHS = (("p", 3), ("r", 9), ("ref_coor", 3), ("tar_coor", 3),
              ("e", 6), ("sr", 2))

    x: torch.Tensor  # [N] f32
    y: torch.Tensor  # [N] f32
    p: torch.Tensor  # [N, 3] f32 displacement (u, v, w)
    r: torch.Tensor  # [N, 9] f32 result (3 znccs, 2D coords in 3 views)
    ref_coor: torch.Tensor  # [N, 3] f32 reconstructed reference point
    tar_coor: torch.Tensor  # [N, 3] f32 reconstructed target point
    e: torch.Tensor  # [N, 6] f32 strain
    sr: torch.Tensor  # [N, 2] f32 subset radius (x, y)
    # host copy of (x, y), as POITable2D.host_xy
    host_xy: Optional[Tuple[np.ndarray, np.ndarray]] = dataclasses.field(
        default=None, repr=False, compare=False)

    # the same table mechanics as POITable2D's
    n = POITable2D.n
    device = POITable2D.device
    replace = POITable2D.replace
    map = POITable2D.map
    xy_numpy = coords_numpy = POITable2D.xy_numpy


def _new_table(cls, x, y, device: DeviceLike):
    """A 2D or stereo table at view-1 points (x, y), all data zeroed."""
    dev = resolve_device(device)
    xh = np.asarray(x, np.float32).reshape(-1)
    yh = np.asarray(y, np.float32).reshape(-1)
    n = xh.shape[0]
    return cls(torch.from_numpy(xh.copy()).to(dev),
               torch.from_numpy(yh.copy()).to(dev),
               *(torch.zeros((n, k), dtype=torch.float32, device=dev)
                 for _, k in cls.WIDTHS), host_xy=(xh, yh))


def new_table_2d(x, y, device: DeviceLike = None) -> POITable2D:
    """Fresh POI table with all data zeroed (``POI2D::clear``, oc_poi.h:128)."""
    return _new_table(POITable2D, x, y, device)


def new_table_2ds(x, y, device: DeviceLike = None) -> POITable2DS:
    """Fresh stereo POI table with all data zeroed."""
    return _new_table(POITable2DS, x, y, device)


def poi_grid_2d(upper_left: Tuple[float, float], number_x: int, number_y: int,
                grid_space: int, device: DeviceLike = None) -> POITable2D:
    """POI grid in the reference example layout: x varies fastest
    (``examples/test_2d_dic_fftcc_icgn1.cpp:57-66``)."""
    x0, y0 = upper_left
    jj, ii = np.meshgrid(np.arange(number_x), np.arange(number_y))
    xs = (x0 + jj * grid_space).astype(np.float32).reshape(-1)
    ys = (y0 + ii * grid_space).astype(np.float32).reshape(-1)
    return new_table_2d(xs, ys, device)


def new_table_3d(x, y, z, device: DeviceLike = None) -> POITable3D:
    """Fresh DVC POI table with all data zeroed (``POI3D::clear``)."""
    dev = resolve_device(device)
    host = tuple(np.asarray(a, np.float32).reshape(-1) for a in (x, y, z))
    n = host[0].shape[0]
    zero = lambda k: torch.zeros((n, k), dtype=torch.float32, device=dev)
    xt, yt, zt = (torch.from_numpy(a.copy()).to(dev) for a in host)
    return POITable3D(x=xt, y=yt, z=zt, p=zero(12), r=zero(7), e=zero(6),
                      sr=zero(3), host_xyz=host)


def poi_grid_3d(origin: Tuple[float, float, float], number_x: int,
                number_y: int, number_z: int, grid_space: int,
                device: DeviceLike = None) -> POITable3D:
    """POI grid for DVC: x fastest, then y, then z."""
    x0, y0, z0 = origin
    kk, ii, jj = np.meshgrid(np.arange(number_z), np.arange(number_y),
                             np.arange(number_x), indexing="ij")
    xs = (x0 + jj * grid_space).astype(np.float32).reshape(-1)
    ys = (y0 + ii * grid_space).astype(np.float32).reshape(-1)
    zs = (z0 + kk * grid_space).astype(np.float32).reshape(-1)
    return new_table_3d(xs, ys, zs, device)


def _from_numpy(cls, coords, fields, device: DeviceLike):
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32, copy=True)).to(dev)
    out = cls(*(t(a).reshape(-1) for a in coords), *(t(a) for a in fields))
    n = out.n
    for name, k in cls.WIDTHS:
        if tuple(getattr(out, name).shape) != (n, k):
            raise ValueError(f"field {name}: expected shape ({n}, {k}), got "
                             f"{tuple(getattr(out, name).shape)}")
    return out


def table_from_numpy(x, y, p, r, e, sr, device: DeviceLike = None
                     ) -> POITable2D:
    """A table from host arrays (for example ``np.asarray`` of each field of
    a table computed elsewhere), so that two computations start from the
    same state."""
    return _from_numpy(POITable2D, (x, y), (p, r, e, sr), device)


def table_from_numpy_3d(x, y, z, p, r, e, sr, device: DeviceLike = None
                        ) -> POITable3D:
    """The DVC counterpart of :func:`table_from_numpy`."""
    return _from_numpy(POITable3D, (x, y, z), (p, r, e, sr), device)


def table_from_numpy_2ds(x, y, p, r, ref_coor, tar_coor, e, sr,
                         device: DeviceLike = None) -> POITable2DS:
    """The stereo counterpart of :func:`table_from_numpy`."""
    return _from_numpy(POITable2DS, (x, y), (p, r, ref_coor, tar_coor, e, sr),
                       device)


def table_to_numpy(t) -> dict:
    """Host float32 copies of every field of a 2D, 2DS or 3D table, keyed
    by field name."""
    return {f: getattr(t, f).cpu().numpy() for f in t.FIELDS}
