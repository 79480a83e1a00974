"""OpenCorr-compatible CSV tables and the DVC matrix checkpoint.

Schemas mirror ``oc_io.cpp`` so the reference's files load unmodified:

* 2D result table (``saveTable2D``, oc_io.cpp:318-373): header
  x,y,u,v,u0,v0,ZNCC,iteration,convergence,feature,exx,eyy,exy,subset_rx,
  subset_ry with fixed 8-decimal precision and a trailing delimiter per row;
* 2D deformation table (``saveDeformationTable2D``, oc_io.cpp:375-421);
* 2D value maps (``saveMap2D``, oc_io.cpp:423-504): an image-sized grid with
  one selected variable rasterized at each POI position;
* stereo result table (``saveTable2DS``, oc_io.cpp:588-669) and value maps
  (``saveMap2DS``, oc_io.cpp:671-826);
* DVC result table (``saveTable3D``, oc_io.cpp:1004-1089), 3D value maps
  (``saveMap3D``) and the binary matrix checkpoint (``saveMatrixBin``);
* headerless point lists (``loadPoint2D``/``savePoint2D``/``loadPoint3D``).

All writers format like C++ ``std::fixed`` with 8 decimals.  The result
tables are written and read through the native codec (``io/native.py``)
where it builds, else in Python.
"""

from __future__ import annotations

import io
from typing import Iterable, Sequence

import numpy as np

from ..data import poi as poi_mod
from ..utils.precision import DeviceLike
from . import native

_F = "%.8f"


def _fmt_row(vals: Iterable[float], delim: str) -> str:
    return delim.join(_F % v for v in vals) + delim


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy()


def save_table_2d(path: str, table: poi_mod.POITable2D,
                  delimiter: str = ",") -> None:
    cols = [
        "x", "y", "u", "v", "u0", "v0", "ZNCC", "iteration", "convergence",
        "feature", "exx", "eyy", "exy", "subset_rx", "subset_ry",
    ]
    p = _np(table.p)
    data = np.column_stack(
        [_np(table.x), _np(table.y), p[:, poi_mod.U], p[:, poi_mod.V],
         _np(table.r), _np(table.e), _np(table.sr)])
    _write_csv(path, cols, data, delimiter)


def load_table_2d(path: str, delimiter: str = ",",
                  device: DeviceLike = None) -> poi_mod.POITable2D:
    """Parse a result table (``loadTable2D``, oc_io.cpp:249-316).  Tolerates
    the older 13-column files without subset radii."""
    raw = _read_csv(path, delimiter)
    n = raw.shape[0]
    p = np.zeros((n, 12), np.float32)
    p[:, poi_mod.U] = raw[:, 2]
    p[:, poi_mod.V] = raw[:, 3]
    r = np.zeros((n, 6), np.float32)
    r[:, : min(6, raw.shape[1] - 4)] = raw[:, 4: 4 + min(6, raw.shape[1] - 4)]
    e = np.zeros((n, 3), np.float32)
    if raw.shape[1] >= 13:
        e[:] = raw[:, 10:13]
    sr = np.zeros((n, 2), np.float32)
    if raw.shape[1] >= 15:
        sr[:] = raw[:, 13:15]
    return poi_mod.table_from_numpy(raw[:, 0], raw[:, 1], p, r, e, sr, device)


def load_points_2d(path: str, delimiter: str = ",") -> np.ndarray:
    """``loadPoint2D`` (oc_io.cpp:66-118): no header, x,y per line."""
    return np.atleast_2d(
        np.genfromtxt(path, delimiter=delimiter, dtype=np.float32))


def save_points_2d(path: str, points: np.ndarray,
                   delimiter: str = ",") -> None:
    """``savePoint2D`` (oc_io.cpp:120-140)."""
    with open(path, "w") as f:
        for p in np.asarray(points):
            f.write(_fmt_row(p[:2], delimiter) + "\n")


def load_points_3d(path: str, delimiter: str = ",") -> np.ndarray:
    """``loadPoint3D`` (oc_io.cpp:828+): no header, x,y,z per line."""
    return np.atleast_2d(
        np.genfromtxt(path, delimiter=delimiter, dtype=np.float32))


def save_deformation_table_2d(path: str, table: poi_mod.POITable2D,
                              delimiter: str = ",") -> None:
    cols = ["x", "y", "u", "ux", "uy", "uxx", "uxy", "uyy", "v", "vx", "vy",
            "vxx", "vxy", "vyy", "subset_rx", "subset_ry"]
    data = np.column_stack(
        [_np(table.x), _np(table.y), _np(table.p), _np(table.sr)])
    _write_csv(path, cols, data, delimiter)


# OutputVariable enum (oc_io.h:25-51)
_MAP_VARS_2D = {
    "u": lambda t: _np(t.p)[:, poi_mod.U],
    "v": lambda t: _np(t.p)[:, poi_mod.V],
    "zncc": lambda t: _np(t.r)[:, poi_mod.R_ZNCC],
    "u0": lambda t: _np(t.r)[:, poi_mod.R_U0],
    "v0": lambda t: _np(t.r)[:, poi_mod.R_V0],
    "iteration": lambda t: _np(t.r)[:, poi_mod.R_ITER],
    "deformation_increment": lambda t: _np(t.r)[:, poi_mod.R_CONV],
    "convergence": lambda t: _np(t.r)[:, poi_mod.R_CONV],
    "feature": lambda t: _np(t.r)[:, poi_mod.R_FEAT],
    "exx": lambda t: _np(t.e)[:, 0],
    "eyy": lambda t: _np(t.e)[:, 1],
    "exy": lambda t: _np(t.e)[:, 2],
}


def _save_map(path, table, vals, height, width, delimiter) -> None:
    """Write ``vals`` rasterized at each POI's (x, y) on an image-sized
    grid."""
    out = np.zeros((height, width), np.float32)
    xs, ys = table.xy_numpy()
    out[ys.astype(np.int32), xs.astype(np.int32)] = vals
    with open(path, "w") as f:
        for row in out:
            f.write(_fmt_row(row, delimiter) + "\n")


def save_map_2d(path: str, table: poi_mod.POITable2D, variable: str,
                height: int, width: int, delimiter: str = ",") -> None:
    """Rasterize one variable onto an image-sized grid (oc_io.cpp:423-504)."""
    _save_map(path, table, _MAP_VARS_2D[variable](table), height, width,
              delimiter)


def save_table_2ds(path: str, table: poi_mod.POITable2DS,
                   delimiter: str = ",") -> None:
    """Stereo result table (``saveTable2DS``, oc_io.cpp:588-669), in the
    column layout of the reference's GT4-0273_0_epipolar_sift_r16.csv."""
    cols = ["x", "y", "u", "v", "w", "r1r2 ZNCC", "r1t1 ZNCC", "r1t2 ZNCC",
            "r2_x", "r2_y", "t1_x", "t1_y", "t2_x", "t2_y",
            "ref_x", "ref_y", "ref_z", "tar_x", "tar_y", "tar_z",
            "exx", "eyy", "ezz", "exy", "eyz", "ezx"]
    data = np.column_stack(
        [_np(table.x), _np(table.y), _np(table.p), _np(table.r),
         _np(table.ref_coor), _np(table.tar_coor), _np(table.e)])
    _write_csv(path, cols, data, delimiter)


def load_table_2ds(path: str, delimiter: str = ",",
                   device: DeviceLike = None) -> poi_mod.POITable2DS:
    """Parse a stereo result table (``loadTable2DS``, oc_io.cpp:506-586);
    tolerates files without the strain columns."""
    raw = _read_csv(path, delimiter)
    n = raw.shape[0]
    e = np.zeros((n, 6), np.float32)
    if raw.shape[1] >= 26:
        e[:] = raw[:, 20:26]
    return poi_mod.table_from_numpy_2ds(
        raw[:, 0], raw[:, 1], raw[:, 2:5], raw[:, 5:14], raw[:, 14:17],
        raw[:, 17:20], e, np.zeros((n, 2), np.float32), device)


_MAP_VARS_2DS = {
    "u": lambda t: _np(t.p)[:, 0],
    "v": lambda t: _np(t.p)[:, 1],
    "w": lambda t: _np(t.p)[:, 2],
    "zncc_r1r2": lambda t: _np(t.r)[:, 0],
    "zncc_r1t1": lambda t: _np(t.r)[:, 1],
    "zncc_r1t2": lambda t: _np(t.r)[:, 2],
    "exx": lambda t: _np(t.e)[:, 0],
    "eyy": lambda t: _np(t.e)[:, 1],
    "ezz": lambda t: _np(t.e)[:, 2],
    "exy": lambda t: _np(t.e)[:, 3],
    "eyz": lambda t: _np(t.e)[:, 4],
    "ezx": lambda t: _np(t.e)[:, 5],
}


def save_map_2ds(path: str, table: poi_mod.POITable2DS, variable: str,
                 height: int, width: int, delimiter: str = ",") -> None:
    """Stereo value map (``saveMap2DS``, oc_io.cpp:671-826): one variable
    rasterized at each POI's view-1 position."""
    _save_map(path, table, _MAP_VARS_2DS[variable](table), height, width,
              delimiter)


def save_table_3d(path: str, table: poi_mod.POITable3D,
                  delimiter: str = ",") -> None:
    """DVC result table (oc_io.cpp:1004-1089), 21 columns."""
    cols = ["x", "y", "z", "u", "v", "w", "u0", "v0", "w0", "ZNCC",
            "iteration", "convergence", "exx", "eyy", "ezz", "exy", "eyz",
            "ezx", "subset_rx", "subset_ry", "subset_rz"]
    p = _np(table.p)
    r = _np(table.r)
    data = np.column_stack(
        [_np(table.x), _np(table.y), _np(table.z), p[:, poi_mod.U3],
         p[:, poi_mod.V3], p[:, poi_mod.W3], r[:, :6], _np(table.e),
         _np(table.sr)])
    _write_csv(path, cols, data, delimiter)


def load_table_3d(path: str, delimiter: str = ",",
                  device: DeviceLike = None) -> poi_mod.POITable3D:
    """Parse a DVC result table; tolerates files without the strain and
    subset-radius columns."""
    raw = _read_csv(path, delimiter)
    n, ncols = raw.shape
    p = np.zeros((n, 12), np.float32)
    p[:, poi_mod.U3] = raw[:, 3]
    p[:, poi_mod.V3] = raw[:, 4]
    p[:, poi_mod.W3] = raw[:, 5]
    r = np.zeros((n, 7), np.float32)
    r[:, :3] = raw[:, 6:9]
    if ncols > 9:
        r[:, 3] = raw[:, 9]
    if ncols > 11:
        r[:, 4:6] = raw[:, 10:12]
    e = np.zeros((n, 6), np.float32)
    if ncols >= 18:
        e[:] = raw[:, 12:18]
    return poi_mod.table_from_numpy_3d(
        raw[:, 0], raw[:, 1], raw[:, 2], p, r, e, np.zeros((n, 3), np.float32),
        device)


_MAP_VARS_3D = {
    "u": lambda t: _np(t.p)[:, poi_mod.U3],
    "v": lambda t: _np(t.p)[:, poi_mod.V3],
    "w": lambda t: _np(t.p)[:, poi_mod.W3],
    "zncc": lambda t: _np(t.r)[:, poi_mod.R3_ZNCC],
    "iteration": lambda t: _np(t.r)[:, poi_mod.R3_ITER],
    "deformation_increment": lambda t: _np(t.r)[:, poi_mod.R3_CONV],
    "feature": lambda t: _np(t.r)[:, poi_mod.R3_FEAT],
    "exx": lambda t: _np(t.e)[:, 0],
    "eyy": lambda t: _np(t.e)[:, 1],
    "ezz": lambda t: _np(t.e)[:, 2],
    "exy": lambda t: _np(t.e)[:, 3],
    "eyz": lambda t: _np(t.e)[:, 4],
    "ezx": lambda t: _np(t.e)[:, 5],
}


def save_map_3d(path: str, table: poi_mod.POITable3D, variable: str,
                dims: Sequence[int], delimiter: str = ",") -> None:
    """Volume value map (``saveMap3D``, oc_io.cpp:1091-1200): one z-slice per
    blank-line-separated block.  ``dims`` is (dim_x, dim_y, dim_z)."""
    dim_x, dim_y, dim_z = (int(d) for d in dims)
    vals = _MAP_VARS_3D[variable](table)
    out = np.zeros((dim_z, dim_y, dim_x), np.float32)
    xs, ys, zs = (a.astype(np.int32) for a in table.coords_numpy())
    out[zs, ys, xs] = vals
    with open(path, "w") as f:
        for z in range(dim_z):
            for row in out[z]:
                f.write(_fmt_row(row, delimiter) + "\n")
            f.write("\n")


def save_matrix_bin_3d(path: str, table: poi_mod.POITable3D,
                       dims: Sequence[int]) -> None:
    """Compact DVC checkpoint (``saveMatrixBin``, oc_io.cpp:1202-1246):
    int32[4] {data_length, dim_x, dim_y, dim_z}, then float32 records
    (x, y, z, u, v, w, zncc, convergence), one per POI."""
    p = _np(table.p)
    r = _np(table.r)
    rec = np.column_stack(
        [_np(table.x), _np(table.y), _np(table.z), p[:, poi_mod.U3],
         p[:, poi_mod.V3], p[:, poi_mod.W3], r[:, poi_mod.R3_ZNCC],
         r[:, poi_mod.R3_CONV]]).astype(np.float32)
    with open(path, "wb") as f:
        np.array([rec.size, dims[0], dims[1], dims[2]], np.int32).tofile(f)
        rec.tofile(f)


def load_matrix_bin_3d(path: str):
    """Returns (records [N, 8] float32, (dim_x, dim_y, dim_z))."""
    with open(path, "rb") as f:
        head = np.fromfile(f, np.int32, 4)
        data = np.fromfile(f, np.float32, int(head[0]))
    return data.reshape(-1, 8), (int(head[1]), int(head[2]), int(head[3]))


def _write_csv(path: str, cols, data: np.ndarray, delim: str) -> None:
    """Through the native codec (io/native.py), else row by row in
    Python; both write the same text for finite values."""
    header = delim.join(cols) + delim
    data = np.asarray(data, np.float32)
    if native.write_table(path, header, data, delim):
        return
    buf = io.StringIO()
    buf.write(header + "\n")
    for row in data:
        buf.write(_fmt_row(row, delim) + "\n")
    with open(path, "w") as f:
        f.write(buf.getvalue())


def _read_csv(path: str, delimiter: str) -> np.ndarray:
    """A numeric table with a header row: the native codec, else numpy."""
    raw = native.read_table(path, skip_header=True, delimiter=delimiter)
    if raw is None:
        raw = np.genfromtxt(path, delimiter=delimiter, skip_header=1,
                            dtype=np.float32)
        raw = np.atleast_2d(raw)
        if np.isnan(raw[:, -1]).all():  # the trailing delimiter's column
            raw = raw[:, :-1]
    return raw
