"""Epipolar-constrained stereo matching (reference API: ``EpipolarSearch``,
oc_epipolar_search.h:30).

Per POI (oc_epipolar_search.cpp:120-205): a parallax estimate from a
bilinear model (:136-137), the projection of the view-1 point onto its
epipolar line in view 2 (:140-148), trial candidates stepping by
``search_step`` up to ``search_radius`` along the line (:157-180), each
refined by a coarse first-order IC-GN (:182-188), and the candidate of
largest ZNCC (:190-194).  The reference loops over POIs with an OpenMP loop
over candidates inside; here the candidate axis becomes a batch axis: the
[N_poi x N_candidates] queue runs through one batched ``icgn2d`` on the
global LUT, then a per-POI argmax (the first maximum) picks the winner.

The search's coarse refiner takes the search's layer: ``prepare`` runs in
the span ``epipolar.prepare`` (> ``epipolar.gradient``,
``epipolar.prefilter``), ``compute`` in ``epipolar.compute`` (>
``epipolar.setup``, ``.iter``, ``.eval``, ``.finish`` and the host reads
``epipolar.sync.*``), and the refiner's ``stats`` go to the process's
counters as ``epipolar.<key>``: its iterations (``iter_full``,
``iter_compact``) and the search's ``candidates`` (candidate problems
queued, padding included), ``candidates_out`` (candidates outside the
image, which the argmax skips) and ``padded`` (padded POIs computed and
dropped).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data import poi as poi_mod
from ..ops import icgn as icgn_ops
from ..utils import timing
from ..utils.precision import f32, fma
from . import base
from .calibration import Calibration
from .icgn import ICGN2D1
from .stereovision import fundamental_matrix

_I32 = torch.int32


class EpipolarSearch(base.Module2D):
    """``chunk_size`` bounds the candidate queue: a chunk holds
    max(256, chunk_size // n_candidates) POIs."""

    layer = "epipolar"

    def __init__(self, view1_cam: Calibration, view2_cam: Calibration,
                 chunk_size: Optional[int] = 16384,
                 device=None):
        super().__init__(0, 0, device)
        self.view1_cam = view1_cam
        self.view2_cam = view2_cam
        self.search_radius = 0
        self.search_step = 0
        self.parallax_x = np.zeros(3, np.float32)
        self.parallax_y = np.zeros(3, np.float32)
        self.icgn1: Optional[ICGN2D1] = None
        self.fundamental_matrix = None
        self.chunk_size = chunk_size

    def set_search(self, search_radius: int, search_step: int) -> None:
        if search_radius < search_step:
            raise ValueError("Search radius is less than search step")
        self.search_radius = int(search_radius)
        self.search_step = int(search_step)

    def set_parallax(self, parallax_or_cx, cy=None) -> None:
        """A constant parallax (the Point2D overload,
        oc_epipolar_search.cpp:73-84) or the bilinear coefficients
        (a, b, c) of x and of y (:86-95): p = a (x - W/2) + b (y - H/2) +
        c."""
        if cy is None:
            px, py = parallax_or_cx
            self.parallax_x = np.array([0, 0, px], np.float32)
            self.parallax_y = np.array([0, 0, py], np.float32)
        else:
            self.parallax_x = np.asarray(parallax_or_cx, np.float32)
            self.parallax_y = np.asarray(cy, np.float32)

    def create_icgn(self, subset_radius_x: int, subset_radius_y: int,
                    conv_criterion: float, stop_condition: float) -> None:
        self.icgn1 = ICGN2D1(subset_radius_x, subset_radius_y,
                             conv_criterion, stop_condition,
                             window_margin=None, device=self.device)
        self.icgn1.layer = self.layer

    def update_cameras(self, view1_cam: Calibration,
                       view2_cam: Calibration) -> None:
        self.view1_cam = view1_cam
        self.view2_cam = view2_cam

    def prepare(self) -> None:
        self.view1_cam.update_matrices()
        self.view2_cam.update_matrices()
        self.fundamental_matrix = fundamental_matrix(self.view1_cam,
                                                     self.view2_cam)
        self.icgn1.set_images(self.ref_img, self.tar_img)
        self.icgn1.prepare()

    @property
    def stats(self):
        """The coarse refiner's ``stats``, which also count the search's
        candidates."""
        return self.icgn1.stats

    def candidate_offsets(self) -> np.ndarray:
        """Candidate steps along the line in the reference's order: the
        center, then (+i, -i) for i in range(step, radius, step)."""
        steps = range(self.search_step, self.search_radius, self.search_step)
        offs = [0.0]
        for i in steps:
            offs += [float(i), float(-i)]
        return np.array(offs, np.float32)

    def chunk_pois(self) -> Optional[int]:
        """POIs a chunk of the search holds (None: one chunk); each chunk
        runs its POIs x candidates as one IC-GN queue."""
        if self.chunk_size is None:
            return None
        return max(256, self.chunk_size // len(self.candidate_offsets()))

    def compute(self, table: poi_mod.POITable2D) -> poi_mod.POITable2D:
        if self.icgn1 is None or self.fundamental_matrix is None:
            raise RuntimeError("call create_icgn() and prepare() first")
        with timing.computing(self.layer, self.stats):
            return self._compute(table)

    def _compute(self, table: poi_mod.POITable2D) -> poi_mod.POITable2D:
        self._check_table(table)
        offsets = self.candidate_offsets()
        chunk = self.chunk_pois()
        m = self.icgn1
        outside = []  # each chunk's count of candidates outside the image
        args = dict(
            fmat=[[f32(v) for v in row] for row in self.fundamental_matrix],
            par_x=[f32(v) for v in self.parallax_x],
            par_y=[f32(v) for v in self.parallax_y],
            offsets=torch.from_numpy(offsets).to(self.device),
            conv=m.conv_criterion, max_iter=m.stop_condition,
            rx=m.subset_radius_x, ry=m.subset_radius_y, stats=m.stats)

        def run(t):
            p, r, out = epipolar_compute(m._gx, m._gy, self.ref_img, m._lut,
                                         t.x, t.y, t.p, **args)
            outside.append(out)
            return t.replace(p=p, r=r)

        out = base.chunked(run, table, chunk)
        padded = 0 if chunk is None or table.n <= chunk else -table.n % chunk
        m.stats["padded"] += padded
        m.stats["candidates"] += (table.n + padded) * len(offsets)
        m.stats["candidates_out"] += timing.host_read(
            f"{self.layer}.sync.candidates_out", sum(outside), int)
        return out


def epipolar_compute(gx, gy, ref_img, tar_lut, xs, ys, p_in, *, fmat, par_x,
                     par_y, offsets, conv, max_iter, rx, ry, stats=None):
    """One chunk of the search.  ``fmat``: 3x3 float32 values as nested
    lists, ``par_x``/``par_y`` the bilinear parallax coefficients,
    ``offsets`` [C] the candidate steps.  Returns (p [N, 12], r [N, 6],
    the count of candidates outside the image, on the device).

    The line and candidate arithmetic rounds each multiply-add once where
    XLA fuses the JAX package's (``fma``), so that the ``(int)``
    truncations land on the same pixels."""
    dev = xs.device
    n = xs.shape[0]
    c = offsets.shape[0]
    h, w = ref_img.shape
    half_w, half_h = w // 2, h // 2
    fl = torch.float32

    u_in = p_in[:, 0]
    v_in = p_in[:, 6]
    # parallax estimate (oc_epipolar_search.cpp:136-137)
    px = fma(par_x[0], xs - half_w, par_x[1] * (ys - half_h)) + par_x[2]
    py = fma(par_y[0], xs - half_w, par_y[1] * (ys - half_h)) + par_y[2]

    # epipolar line of (x+u, y+v) in view 2 (:140-148)
    vx = xs + u_in
    vy = ys + v_in
    l0, l1, l2 = (fma(f[0], vx, f[1] * vy) + f[2] for f in fmat)
    slope = -l0 / l1
    intercept = -l2 / l1
    # (int) truncations of the reference
    x_view2 = ((fma(slope, vy + py - intercept, vx) + px)
               / fma(slope, slope, 1.0)).to(_I32)
    y_view2 = fma(slope, x_view2.to(fl), intercept).to(_I32)

    # trial locations along the line (:157-180)
    x_trial = x_view2[:, None] + offsets[None, :].to(_I32)  # [N, C]
    y_trial = fma(slope[:, None], x_trial.to(fl),
                  intercept[:, None]).to(_I32)
    y_trial = torch.where(offsets[None, :] == 0.0, y_view2[:, None], y_trial)
    cand_ok = ((x_trial - rx > 0) & (x_trial + rx < w - 1)
               & (y_trial - ry > 0) & (y_trial + ry < h - 1))
    cand_ok[:, 0] = True  # the center is always tried (:151-155)

    u_c = x_trial.to(fl) - xs[:, None]
    v_c = y_trial.to(fl) - ys[:, None]

    # the [N, C] candidates as one coarse IC-GN queue on the global LUT
    p_flat = torch.zeros((n * c, 12), dtype=fl, device=dev)
    p_flat[:, 0] = u_c.reshape(-1)
    p_flat[:, 6] = v_c.reshape(-1)
    p_out, u0, v0, zncc, it, dpn, computed = icgn_ops.icgn2d(
        gx, gy, ref_img, tar_lut, xs.repeat_interleave(c),
        ys.repeat_interleave(c), p_flat, torch.zeros(n * c, dtype=fl,
                                                     device=dev),
        conv, max_iter, order=1, rx=rx, ry=ry, window_margin=None,
        stats=stats, layer=EpipolarSearch.layer)

    zncc_nc = zncc.reshape(n, c)
    score = torch.where(cand_ok, zncc_nc,
                        torch.full((), -float("inf"), device=dev))
    best = torch.argmax(score, dim=1)  # the first maximum
    rows = torch.arange(n, device=dev)

    def take(a):
        return a.reshape(n, c, *a.shape[1:])[rows, best]

    # failed candidates keep a fresh POI's zeroed bookkeeping fields (the
    # reference's early returns never touch u0/iteration/convergence)
    comp = take(computed)
    zero = torch.zeros((), dtype=fl, device=dev)
    r_best = torch.stack(
        [torch.where(comp, take(u0), zero), torch.where(comp, take(v0), zero),
         take(zncc), torch.where(comp, take(it), zero),
         torch.where(comp, take(dpn), zero), torch.zeros(n, dtype=fl,
                                                         device=dev)], -1)
    # the winner's whole deformation vector (:193)
    return take(p_out), r_best, (~cand_ok).sum()
