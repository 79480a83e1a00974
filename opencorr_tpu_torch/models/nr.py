"""NR module (reference API: ``NR2D1``, oc_nr.h:47)."""

from __future__ import annotations

from ..data import poi as poi_mod
from ..ops import bspline, gradient, nr as nr_ops
from ..utils import timing
from .icgn import Refiner2D, merge_refined


class NR2D1(Refiner2D):
    """Forward-additive Newton-Raphson with the first-order shape function
    (oc_nr.cpp:160-333).  ``prepare`` builds the B-spline LUTs of the
    target image and of both its gradient maps, and keeps the gradient
    images for the windowed evals (oc_nr.cpp:119-158).  Its entry-guard
    code is -1.  No self-adaptive mode (the reference has none)."""

    layer = "nr"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._tgx = self._tgy = None
        self._lut_gx = self._lut_gy = None

    def prepare(self) -> None:
        with timing.span(self.layer + ".prepare"):
            with timing.span(self.layer + ".gradient"):
                self._tgx = gradient.gradient_x_2d(self.tar_img).contiguous()
                self._tgy = gradient.gradient_y_2d(self.tar_img).contiguous()
            with timing.span(self.layer + ".prefilter"):
                self._lut = bspline.bicubic_prepare(self.tar_img)
                self._lut_gx = bspline.bicubic_prepare(self._tgx)
                self._lut_gy = bspline.bicubic_prepare(self._tgy)

    def set_self_adaptive(self, flag: bool) -> None:
        if flag:
            raise NotImplementedError("NR2D1 has no self-adaptive subsets")

    def _compute(self, table: poi_mod.POITable2D) -> poi_mod.POITable2D:
        self._ready(table)
        rx, ry = self.subset_radius_x, self.subset_radius_y
        margin = self._margin()

        def run(t):
            return merge_refined(t, nr_ops.nr2d1(
                self.ref_img, self._lut, self._lut_gx, self._lut_gy, t.x,
                t.y, t.p, t.r[:, poi_mod.R_ZNCC], self.conv_criterion,
                self.stop_condition, self.tar_img, self._tgx, self._tgy,
                rx=rx, ry=ry, window_margin=margin, stats=self.stats,
                layer=self.layer))

        return self._fixed(run, table)
