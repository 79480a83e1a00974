"""FFTCC modules (reference API: ``FFTCC2D``/``FFTCC3D``,
oc_fftcc.h:54-96)."""

from __future__ import annotations

import collections
from typing import Optional

import torch

from ..data import poi as poi_mod
from ..ops import fftcc as fftcc_ops
from ..utils import timing
from ..utils.precision import DeviceLike
from . import base


class FFTCC2D(base.Module2D):
    """Integer-pixel initial guess by batched FFT cross-correlation.

    Replaces the reference's per-thread FFTW pool and OpenMP loop
    (oc_fftcc.cpp:151-285) with one batched FFT over the POI queue.
    ``stats`` counts the exact re-rank branches of every compute."""

    layer = "fftcc"

    def __init__(self, subset_radius_x: int, subset_radius_y: int,
                 chunk_size: Optional[int] = 65536,
                 device: DeviceLike = None):
        super().__init__(subset_radius_x, subset_radius_y, device)
        self.chunk_size = chunk_size
        self.stats = collections.Counter()

    def compute(self, table: poi_mod.POITable2D) -> poi_mod.POITable2D:
        self._check_table(table)
        rx, ry = self.subset_radius_x, self.subset_radius_y

        def run(t):
            p, r = t.p, t.r
            u, v, zncc, valid = fftcc_ops.fftcc2d(
                self.ref_img, self.tar_img, t.x, t.y, p[:, poi_mod.U],
                p[:, poi_mod.V], rx=rx, ry=ry, stats=self.stats,
                layer=self.layer)
            p_new = p.clone()
            p_new[:, poi_mod.U] = u
            p_new[:, poi_mod.V] = v
            # u0/v0/zncc updated only for processed POIs (oc_fftcc.cpp:268-274)
            r_new = r.clone()
            for col, val in ((poi_mod.R_U0, p[:, poi_mod.U]),
                             (poi_mod.R_V0, p[:, poi_mod.V]),
                             (poi_mod.R_ZNCC, zncc)):
                r_new[:, col] = torch.where(valid, val, r[:, col])
            return t.replace(p=p_new, r=r_new)

        with timing.computing(self.layer, self.stats):
            return base.chunked(run, table, self.chunk_size)


class FFTCC3D(base.Module3D):
    """3D FFTCC for DVC (oc_fftcc.cpp:300-437): one batched ``rfftn`` per
    chunk of 512 POIs.  ``stats`` counts the chunks that ran the exact
    re-rank."""

    layer = "fftcc"

    def __init__(self, subset_radius_x: int, subset_radius_y: int,
                 subset_radius_z: int, chunk_size: Optional[int] = 512,
                 device: DeviceLike = None):
        super().__init__(subset_radius_x, subset_radius_y, subset_radius_z,
                         device)
        self.chunk_size = chunk_size
        self.stats = collections.Counter()

    def compute(self, table: poi_mod.POITable3D) -> poi_mod.POITable3D:
        self._check_table(table)
        rx, ry, rz = (self.subset_radius_x, self.subset_radius_y,
                      self.subset_radius_z)
        cols = (poi_mod.U3, poi_mod.V3, poi_mod.W3)

        def run(t):
            p, r = t.p, t.r
            *uvw, zncc, valid = fftcc_ops.fftcc3d(
                self.ref_vol, self.tar_vol, t.x, t.y, t.z,
                *(p[:, c] for c in cols), rx=rx, ry=ry, rz=rz,
                stats=self.stats, layer=self.layer)
            p_new = p.clone()
            for c, val in zip(cols, uvw):
                p_new[:, c] = val
            # u0/v0/w0/zncc updated only for processed POIs
            r_new = r.clone()
            for col, val in ((poi_mod.R3_U0, p[:, poi_mod.U3]),
                             (poi_mod.R3_V0, p[:, poi_mod.V3]),
                             (poi_mod.R3_W0, p[:, poi_mod.W3]),
                             (poi_mod.R3_ZNCC, zncc)):
                r_new[:, col] = torch.where(valid, val, r[:, col])
            return t.replace(p=p_new, r=r_new)

        with timing.computing(self.layer, self.stats):
            return base.chunked(run, table, self.chunk_size)
