"""Strain module (reference API: ``Strain``, oc_strain.h:32), 2D, stereo
(2DS) and 3D tables."""

from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch

from ..data import poi as poi_mod
from ..ops import strain as strain_ops
from ..utils import timing
from ..utils.precision import DeviceLike, resolve_device
from . import base


class Strain:
    """Pointwise strain from the displacement field.

    Defaults mirror the reference ctor (oc_strain.cpp:31-46): ZNCC threshold
    0.9, Lagrangian description, Cauchy approximation.  The per-thread k-d
    trees (oc_strain.cpp:97-147) become two paths:

    * **grid** (POI queues laid out as regular grids): the in-radius neighbor
      set is a fixed offset stencil and every POI's neighbor indices come
      from index arithmetic on the device;
    * **scattered**: one host cKDTree precomputes a fixed-width neighbor
      table (exact-k ``knnSearch`` fallback included); the fits run batched
      on the device.

    The coordinates are copied to the host once per table (cached on the
    table) for the neighbor search.  ``layer`` names the spans
    (``utils/timing``).
    """

    layer = "strain"

    def __init__(self, subregion_radius: float = 20.0,
                 neighbor_number_min: int = 5,
                 chunk_size: Optional[int] = None,
                 device: DeviceLike = None):
        """``chunk_size=None`` sizes POI chunks from a poi*neighbor budget
        (a 30k r=20 field runs as one chunk)."""
        self.device = resolve_device(device)
        self.subregion_radius = float(subregion_radius)
        self.neighbor_number_min = int(neighbor_number_min)
        self.zncc_threshold = 0.9
        self.description = 1  # 1: Lagrangian, 2: Eulerian (output doc only)
        self.approximation = 1  # 1: Cauchy, 2: Green-Lagrange
        self.chunk_size = chunk_size
        self._cache = []  # [(weakref(x), (radius, nmin), data)]

    def set_subregion_radius(self, r: float):
        self.subregion_radius = float(r)

    def set_neighbor_min(self, n: int):
        self.neighbor_number_min = int(n)

    def set_zncc_threshold(self, t: float):
        self.zncc_threshold = float(t)

    def set_description(self, d: int):
        self.description = int(d)

    def set_approximation(self, a: int):
        self.approximation = int(a)

    def prepare(self, table: Optional[poi_mod.POITable2D] = None) -> None:
        """Optionally pre-build the neighbor structure for a table; repeated
        compute() calls on the same table reuse it."""
        if table is not None:
            self._neighbor_data(table)

    def _chunk(self, k: int) -> int:
        """POI chunk length bounding the [chunk, K] working set."""
        if self.chunk_size is not None:
            return self.chunk_size
        return max(4096, 64_000_000 // max(int(k), 1))

    def _grid_2d(self, x, y, device):
        """Grid-path pieces for a 2D point set, or None."""
        g = strain_ops.detect_grid_2d(x, y)
        if g is None:
            return None
        iy, ix, lookup, gy, gx = g
        st = strain_ops.grid_stencil_2d(gy, gx, self.subregion_radius,
                                        self.neighbor_number_min)
        if st is None:  # corner POIs could need the exact-KNN fallback
            return None
        to = lambda a: torch.from_numpy(a).to(device)
        return tuple(to(a) for a in (iy, ix, lookup, *st))

    def _grid_3d(self, x, y, z, device):
        """Grid-path pieces for a 3D point set, or None."""
        g = strain_ops.detect_grid_3d(x, y, z)
        if g is None:
            return None
        iz, iy, ix, lookup, gz, gy, gx = g
        st = strain_ops.grid_stencil_3d(gz, gy, gx, self.subregion_radius,
                                        self.neighbor_number_min)
        if st is None:
            return None
        to = lambda a: torch.from_numpy(a).to(device)
        return tuple(to(a) for a in (iz, iy, ix, lookup, *st))

    def _neighbors(self, search_pts: np.ndarray, device):
        idx, ok, use_radius = strain_ops.neighbor_lists(
            search_pts, search_pts, self.subregion_radius,
            self.neighbor_number_min)
        return tuple(torch.from_numpy(a).to(device)
                     for a in (idx, ok, use_radius))

    def _neighbor_data(self, table):
        """The neighbor structure of a 2D or 3D ``table``, memoized on its
        coordinate tensor so steady-state compute() calls do no host
        work."""
        params = (self.subregion_radius, self.neighbor_number_min)
        for ref, p, data in self._cache:
            if p == params and ref() is table.x:
                return data
        with timing.span(self.layer + ".neighbors"):
            coords = table.coords_numpy()
            grid_fn = self._grid_2d if len(coords) == 2 else self._grid_3d
            grid = grid_fn(*coords, table.device)
            data = (("grid", grid) if grid is not None else
                    ("kdtree", self._neighbors(np.stack(coords, axis=-1),
                                               table.device)))
        self._cache.append((weakref.ref(table.x), params, data))
        if len(self._cache) > 8:
            self._cache.pop(0)
        return data

    def _fit(self, run, table, chunk: int, *extras):
        """``base.chunked`` of the fit, in the span ``<layer>.fit``."""
        with timing.span(self.layer + ".fit"):
            return base.chunked(run, table, chunk, *extras)

    def compute(self, table):
        """Strain of a 2D (exx, eyy, exy), stereo or 3D (exx, eyy, ezz,
        exy, eyz, ezx) table, in the span ``<layer>.compute``."""
        with timing.span(self.layer + ".compute"):
            return self._compute(table)

    def _compute(self, table):
        if not isinstance(table, (poi_mod.POITable2D, poi_mod.POITable2DS,
                                  poi_mod.POITable3D)):
            raise TypeError(f"Strain: {type(table).__name__} is no POI "
                            "table")
        if table.device != self.device:
            raise ValueError(f"POI table on {table.device}, Strain on "
                             f"{self.device}")
        if isinstance(table, poi_mod.POITable3D):
            return self._compute_3d(table)
        if isinstance(table, poi_mod.POITable2DS):
            return self._compute_2ds(table)
        mode, data = self._neighbor_data(table)
        approx = self.approximation
        args = dict(radius=self.subregion_radius,
                    zncc_threshold=self.zncc_threshold,
                    neighbor_min=float(self.neighbor_number_min),
                    approximation=approx)
        xs, ys = table.x, table.y
        us, vs = table.p[:, poi_mod.U], table.p[:, poi_mod.V]
        zn = table.r[:, poi_mod.R_ZNCC]
        if mode == "grid":
            iy, ix, lookup, di, dj = data

            def run_g(t, iy_c, ix_c):
                e = strain_ops.strain2d_grid(
                    xs, ys, us, vs, zn, t.x, t.y, t.r[:, poi_mod.R_ZNCC],
                    t.e, iy_c, ix_c, lookup, di, dj, **args)
                return t.replace(e=e)

            return self._fit(run_g, table, self._chunk(di.shape[0]),
                             iy, ix)

        nb_idx, nb_ok, use_radius = data

        def run(t, idx_c, ok_c, ur_c):
            e = strain_ops.strain2d(
                xs, ys, us, vs, zn, t.x, t.y, t.r[:, poi_mod.R_ZNCC], t.e,
                idx_c, ok_c, ur_c, **args)
            return t.replace(e=e)

        return self._fit(run, table, self._chunk(nb_idx.shape[1]),
                         nb_idx, nb_ok, use_radius)

    def _compute_3d(self, table: poi_mod.POITable3D) -> poi_mod.POITable3D:
        """DVC strain (oc_strain.cpp:372-472): grid stencil or k-d tree."""
        mode, data = self._neighbor_data(table)
        args = dict(radius=self.subregion_radius,
                    zncc_threshold=self.zncc_threshold,
                    neighbor_min=float(self.neighbor_number_min),
                    approximation=self.approximation)
        full = (table.x, table.y, table.z, table.p[:, poi_mod.U3],
                table.p[:, poi_mod.V3], table.p[:, poi_mod.W3],
                table.r[:, poi_mod.R3_ZNCC])

        def query(t):
            return (t.x, t.y, t.z, t.r[:, poi_mod.R3_ZNCC], t.e)

        if mode == "grid":
            iz, iy, ix, lookup, dk, di, dj = data

            def run_g(t, iz_c, iy_c, ix_c):
                e = strain_ops.strain3d_grid(*full, *query(t), iz_c, iy_c,
                                             ix_c, lookup, dk, di, dj, **args)
                return t.replace(e=e)

            return self._fit(run_g, table, self._chunk(dk.shape[0]), iz,
                             iy, ix)

        nb_idx, nb_ok, use_radius = data

        def run(t, idx_c, ok_c, ur_c):
            e = strain_ops.strain3d(*full, *query(t), idx_c, ok_c, ur_c,
                                    **args)
            return t.replace(e=e)

        return self._fit(run, table, self._chunk(nb_idx.shape[1]),
                         nb_idx, nb_ok, use_radius)

    def _compute_2ds(self, table: poi_mod.POITable2DS
                     ) -> poi_mod.POITable2DS:
        """Stereo strain (oc_strain.cpp:250-355): neighbours on the view-1
        image coordinates, the fit on the reconstructed 3D reference
        coordinates; a POI takes part only where all three ZNCCs pass."""
        mode, data = self._neighbor_data(table)
        args = dict(radius=self.subregion_radius,
                    zncc_threshold=self.zncc_threshold,
                    neighbor_min=float(self.neighbor_number_min),
                    approximation=self.approximation)
        rc, p = table.ref_coor, table.p
        full = (table.x, table.y, rc[:, 0], rc[:, 1], rc[:, 2], p[:, 0],
                p[:, 1], p[:, 2], table.r[:, 0:3].min(dim=1).values)

        def query(t):
            return (t.x, t.y, t.ref_coor[:, 0], t.ref_coor[:, 1],
                    t.ref_coor[:, 2], t.r[:, 0:3].min(dim=1).values, t.e)

        if mode == "grid":
            iy, ix, lookup, di, dj = data

            def run_g(t, iy_c, ix_c):
                e = strain_ops.strain2ds_grid(*full, *query(t), iy_c, ix_c,
                                              lookup, di, dj, **args)
                return t.replace(e=e)

            return self._fit(run_g, table, self._chunk(di.shape[0]), iy,
                             ix)

        nb_idx, nb_ok, use_radius = data

        def run(t, idx_c, ok_c, ur_c):
            e = strain_ops.strain2ds(*full, *query(t), idx_c, ok_c, ur_c,
                                     **args)
            return t.replace(e=e)

        return self._fit(run, table, self._chunk(nb_idx.shape[1]),
                         nb_idx, nb_ok, use_radius)
