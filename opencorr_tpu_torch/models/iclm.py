"""IC-LM modules (reference API: ``ICLM2D1``/``ICLM2D2``,
oc_iclm.h:54-146)."""

from __future__ import annotations

from ..data import poi as poi_mod
from ..ops import iclm as iclm_ops
from .icgn import Refiner2D, merge_refined


class ICLM2D1(Refiner2D):
    """First-order IC-LM (oc_iclm.cpp:150-368): IC-GN's skeleton with the
    damped Hessian and no out-of-range abort.  ``set_damping`` sets
    (lambda, alpha, beta), by default (100, 0.1, 10) (oc_iclm.h:32-37).
    After ``set_self_adaptive(True)`` each POI refines at its radii in
    ``table.sr`` (oc_iclm.cpp:158-164), through the global LUT."""

    layer = "iclm"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.damping_lambda = 100.0
        self.damping_alpha = 0.1
        self.damping_beta = 10.0

    def set_damping(self, lam: float, alpha: float, beta: float):
        """oc_iclm.cpp:114-119."""
        self.damping_lambda = float(lam)
        self.damping_alpha = float(alpha)
        self.damping_beta = float(beta)

    def _compute(self, table: poi_mod.POITable2D) -> poi_mod.POITable2D:
        self._ready(table)
        conv, stop = self.conv_criterion, self.stop_condition
        damping = (self.damping_lambda, self.damping_alpha,
                   self.damping_beta)
        if self.self_adaptive:
            return self._adaptive(table, lambda t, r_max: (
                iclm_ops.iclm2d_adaptive(
                    self._gx, self._gy, self.ref_img, self._lut, t.x, t.y,
                    t.sr[:, 0], t.sr[:, 1], t.p, t.r[:, poi_mod.R_ZNCC],
                    conv, stop, damping, order=self.order, r_max=r_max,
                    stats=self.stats, layer=self.layer)))
        rx, ry = self.subset_radius_x, self.subset_radius_y
        margin = self._margin()

        def run(t):
            return merge_refined(t, iclm_ops.iclm2d(
                self._gx, self._gy, self.ref_img, self._lut, t.x, t.y, t.p,
                t.r[:, poi_mod.R_ZNCC], conv, stop, damping, self.tar_img,
                order=self.order, rx=rx, ry=ry, window_margin=margin,
                stats=self.stats, layer=self.layer), (rx, ry))

        return self._fixed(run, table)


class ICLM2D2(ICLM2D1):
    """Second-order IC-LM (oc_iclm.cpp:502-731): the 12-dof quadratic warp,
    otherwise as :class:`ICLM2D1`."""

    order = 2
