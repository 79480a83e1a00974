"""IC-GN modules (reference API: ``ICGN2D1``, ``ICGN3D1``,
oc_icgn.h:45-188)."""

from __future__ import annotations

import collections
from typing import Optional

import torch

from ..data import poi as poi_mod
from ..ops import bspline, gradient, icgn as icgn_ops
from ..utils import timing
from ..utils.precision import DeviceLike
from . import base

# Memory ICGN3D1's automatic chunks may fill on the CPU.  On a card it is a
# fifth of the card's memory, which leaves room for the volumes and the
# allocator's slack.
_CPU_WORKSET_BUDGET = 16 * 2 ** 30


def _workset_budget(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[1] // 5
    return _CPU_WORKSET_BUDGET


def merge_refined(t, outs, radii=None):
    """A refiner's outputs (p_out, u0, v0[, w0], zncc, iteration,
    convergence, computed) written into the 2D or 3D table ``t``: the code
    everywhere, the rest where computed; ``radii`` (rx, ry[, rz]), when
    given, into ``sr`` where computed (a self-adaptive refine keeps the
    table's radii)."""
    p_out, *seeds, zncc, it, dpn, computed = outs
    if len(seeds) == 3:
        zeta, cols = poi_mod.R3_ZNCC, (poi_mod.R3_U0, poi_mod.R3_V0,
                                       poi_mod.R3_W0, poi_mod.R3_ITER,
                                       poi_mod.R3_CONV)
    else:
        zeta, cols = poi_mod.R_ZNCC, (poi_mod.R_U0, poi_mod.R_V0,
                                      poi_mod.R_ITER, poi_mod.R_CONV)
    r = t.r.clone()
    r[:, zeta] = zncc
    for col, val in zip(cols, (*seeds, it, dpn)):
        r[:, col] = torch.where(computed, val, t.r[:, col])
    if radii is None:
        return t.replace(p=p_out, r=r)
    sr = t.sr.clone()
    for col, rad in enumerate(radii):
        sr[:, col] = torch.where(computed, float(rad), t.sr[:, col])
    return t.replace(p=p_out, r=r, sr=sr)


class Refiner2D(base.Module2D):
    """What the 2D iterative refiners share: the iteration limits, the
    reference gradients and the target LUT, POI chunks of at most
    ``chunk_size`` within ``base.budget_chunk``'s working set, and the
    windowed eval's margin (``window_margin``, default 8; ``None``, an
    ``eval_mode`` other than "lattice" or an image smaller than the window
    (``base.eval_margin``) takes the global LUT, as in the JAX package).
    ``stats`` counts the eval branches and iterations of every compute."""

    layer = "icgn"
    order = 1

    def __init__(self, subset_radius_x: int, subset_radius_y: int,
                 conv_criterion: float = 0.001, stop_condition: float = 10,
                 chunk_size: Optional[int] = 65536,
                 window_margin: Optional[int] = 8,
                 eval_mode: str = "lattice", device: DeviceLike = None):
        super().__init__(subset_radius_x, subset_radius_y, device)
        self.conv_criterion = float(conv_criterion)
        self.stop_condition = float(stop_condition)
        self.chunk_size = chunk_size
        self.window_margin = window_margin
        self.eval_mode = eval_mode
        self.stats = collections.Counter()
        self._gx = None
        self._gy = None
        self._lut = None

    def set_iteration(self, conv_criterion: float, stop_condition: float):
        self.conv_criterion = float(conv_criterion)
        self.stop_condition = float(stop_condition)

    def prepare_ref(self) -> None:
        """Gradient maps of the reference image (oc_icgn.cpp:115-125)."""
        with timing.span(self.layer + ".gradient"):
            self._gx = gradient.gradient_x_2d(self.ref_img).contiguous()
            self._gy = gradient.gradient_y_2d(self.ref_img).contiguous()

    def prepare_tar(self) -> None:
        """B-spline LUT of the target image (oc_icgn.cpp:127-136)."""
        with timing.span(self.layer + ".prefilter"):
            self._lut = bspline.bicubic_prepare(self.tar_img)

    def prepare(self) -> None:
        with timing.span(self.layer + ".prepare"):
            self.prepare_ref()
            self.prepare_tar()

    def compute(self, table: poi_mod.POITable2D, *args, **kwargs
                ) -> poi_mod.POITable2D:
        """The refined table (the refiner's ``_compute``), under the span
        ``<layer>.compute``; the call's ``stats`` go to the process's
        counters."""
        with timing.computing(self.layer, self.stats):
            return self._compute(table, *args, **kwargs)

    def _ready(self, table) -> None:
        if self._lut is None:
            raise RuntimeError("call prepare() before compute()")
        self._check_table(table)

    def _margin(self) -> Optional[int]:
        """The windowed eval's margin, or None (the global path) for an
        ``eval_mode`` other than "lattice" or an image smaller than the
        window."""
        if self.eval_mode != "lattice":
            return None
        return base.eval_margin(
            self.window_margin, (self.subset_radius_x, self.subset_radius_y),
            self.ref_img.shape[::-1])

    def _fixed(self, run, table, *extras) -> poi_mod.POITable2D:
        """``run(t, *extras)`` over chunks of ``table`` at the fixed radii
        (``extras``: per-POI tensors chunked alongside)."""
        return base.chunked(run, table, base.budget_chunk(
            self.chunk_size, self.subset_radius_x, self.subset_radius_y),
            *extras)

    def _adaptive(self, table, refine) -> poi_mod.POITable2D:
        """Self-adaptive mode: every POI on the static grid of the largest
        radius in ``table.sr`` (one host read), each with its own radii.
        ``refine(t, r_max)`` returns the refiner's outputs for a chunk; the
        chunk shrinks with the (2 r_max + 1)^2 grid."""
        r_max = int(max(timing.host_read(f"{self.layer}.sync.radius",
                                         table.sr.max(), float), 1.0))
        return base.chunked(lambda t: merge_refined(t, refine(t, r_max)),
                            table, base.budget_chunk(self.chunk_size, r_max,
                                                     r_max))


class ICGN2D1(Refiner2D):
    """First-order IC-GN (oc_icgn.cpp:144-351).

    With the windowed eval (the default), a POI whose GN iterate drifts
    more than margin-2 px past its seed fails with -3.
    ``compute(table, center_offset)`` takes the stereo overload's [N, 2]
    target-center offsets (oc_icgn.cpp:353-560), chunked with the table.
    After ``set_self_adaptive(True)`` each POI refines at its radii in
    ``table.sr`` (oc_icgn.cpp:152-158), through the global LUT."""

    def _compute(self, table: poi_mod.POITable2D,
                 center_offset: Optional[torch.Tensor] = None
                 ) -> poi_mod.POITable2D:
        self._ready(table)
        conv, stop = self.conv_criterion, self.stop_condition
        if self.self_adaptive:
            if center_offset is not None:
                raise ValueError("ICGN2D: self-adaptive subsets take no "
                                 "center offsets")
            return self._adaptive(table, lambda t, r_max: (
                icgn_ops.icgn2d_adaptive(
                    self._gx, self._gy, self.ref_img, self._lut, t.x, t.y,
                    t.sr[:, 0], t.sr[:, 1], t.p, t.r[:, poi_mod.R_ZNCC],
                    conv, stop, order=self.order, r_max=r_max,
                    stats=self.stats, layer=self.layer)))
        rx, ry = self.subset_radius_x, self.subset_radius_y
        margin = self._margin()

        def run(t, *offs):
            return merge_refined(t, icgn_ops.icgn2d(
                self._gx, self._gy, self.ref_img, self._lut, t.x, t.y, t.p,
                t.r[:, poi_mod.R_ZNCC], conv, stop, self.tar_img,
                order=self.order, rx=rx, ry=ry,
                center_offset=offs[0] if offs else None,
                window_margin=margin, stats=self.stats, layer=self.layer),
                (rx, ry))

        if center_offset is None:
            return self._fixed(run, table)
        offs = torch.as_tensor(center_offset, dtype=torch.float32).to(
            self.device)
        if tuple(offs.shape) != (table.n, 2):
            raise ValueError(f"center_offset {tuple(offs.shape)}, expected "
                             f"{(table.n, 2)}")
        return self._fixed(run, table, offs)


class ICGN3D1(base.Module3D):
    """3D first-order IC-GN for DVC (oc_icgn.cpp:1270-1501).

    ``window_margin`` (default 8) evaluates the target through per-POI
    coefficient windows of half-extent r+margin, where a sample leaving
    its window fails its POI with -3: with ``eval_mode="lattice"`` (the
    default) through the lattice kernel, a chunk in which any active
    sample wobbles past the lattice's D=1 falling back to the exact global
    eval for that iteration; with ``"tile"`` at the global eval's values
    (the JAX package's tile-LUT path, without its TPU layout).  ``None``
    evaluates every sample through the global coefficient volume.  Volumes
    too small for the window take the global path.

    ``chunk_size=None`` sizes POI chunks from the working set: about
    ``WORKSET_ARRAYS_3D`` subset-sized float32 arrays per POI plus its
    lattice block, within a fifth of the card's memory (16 GiB on the CPU).
    At r=30 that is 37.5 MB per POI; on an 80 GB card at most 453 POIs a
    chunk, so 5,733 POIs run as 13 even chunks of 441.  An explicit
    ``chunk_size`` overrides it.  ``stats``
    counts chunks, Gauss-Newton iterations, lattice launches and fallback
    iterations."""

    layer = "icgn"

    def __init__(self, subset_radius_x: int, subset_radius_y: int,
                 subset_radius_z: int, conv_criterion: float = 0.001,
                 stop_condition: float = 10,
                 chunk_size: Optional[int] = None,
                 window_margin: Optional[int] = 8,
                 eval_mode: str = "lattice", device: DeviceLike = None):
        super().__init__(subset_radius_x, subset_radius_y, subset_radius_z,
                         device)
        self.conv_criterion = float(conv_criterion)
        self.stop_condition = float(stop_condition)
        self.chunk_size = chunk_size
        self.window_margin = window_margin
        self.eval_mode = eval_mode
        self.stats = collections.Counter()
        self._gx = self._gy = self._gz = None
        self._coeff = None

    def set_iteration(self, conv_criterion: float, stop_condition: float):
        self.conv_criterion = float(conv_criterion)
        self.stop_condition = float(stop_condition)

    def prepare_ref(self) -> None:
        """Gradient volumes (oc_icgn.cpp:1240-1251)."""
        with timing.span(self.layer + ".gradient"):
            self._gx = gradient.gradient_x_3d(self.ref_vol).contiguous()
            self._gy = gradient.gradient_y_3d(self.ref_vol).contiguous()
            self._gz = gradient.gradient_z_3d(self.ref_vol).contiguous()

    def prepare_tar(self) -> None:
        """Prefiltered tricubic coefficient volume (oc_icgn.cpp:1253-1262)."""
        with timing.span(self.layer + ".prefilter"):
            self._coeff = bspline.tricubic_prepare(self.tar_vol).contiguous()

    def prepare(self) -> None:
        with timing.span(self.layer + ".prepare"):
            self.prepare_ref()
            self.prepare_tar()

    def auto_chunk(self, n: int) -> int:
        """POIs per chunk for a queue of ``n``: as few chunks as the
        working-set budget allows, of even length."""
        sides = [2 * r + 1 for r in (self.subset_radius_x,
                                     self.subset_radius_y,
                                     self.subset_radius_z)]
        s = sides[0] * sides[1] * sides[2]
        blk = (sides[0] + 5) * (sides[1] + 5) * (sides[2] + 5)
        per_poi = 4 * (icgn_ops.WORKSET_ARRAYS_3D * s + blk)
        most = max(1, _workset_budget(self.device) // per_poi)
        return -(-n // -(-n // most)) if n else most

    def compute(self, table: poi_mod.POITable3D) -> poi_mod.POITable3D:
        with timing.computing(self.layer, self.stats):
            return self._compute(table)

    def _compute(self, table: poi_mod.POITable3D) -> poi_mod.POITable3D:
        if self._coeff is None:
            raise RuntimeError("call prepare() before compute()")
        self._check_table(table)
        rx, ry, rz = (self.subset_radius_x, self.subset_radius_y,
                      self.subset_radius_z)
        margin = base.eval_margin(self.window_margin, (rx, ry, rz),
                                  self.ref_vol.shape[::-1])
        chunk = self.chunk_size or self.auto_chunk(table.n)
        self.stats["chunks"] += max(1, -(-table.n // chunk))

        def run(t):
            with timing.span(self.layer + ".chunk"):
                out = icgn_ops.icgn3d1(
                    self._gx, self._gy, self._gz, self.ref_vol, self._coeff,
                    t.x, t.y, t.z, t.p, t.r[:, poi_mod.R3_ZNCC],
                    self.conv_criterion, self.stop_condition, rx=rx, ry=ry,
                    rz=rz, window_margin=margin, eval_mode=self.eval_mode,
                    stats=self.stats, layer=self.layer)
            return merge_refined(t, out, (rx, ry, rz))

        return base.chunked(run, table, chunk)


class ICGN2D2(ICGN2D1):
    """Second-order IC-GN (oc_icgn.cpp:685-908): the 12-dof quadratic warp,
    otherwise as :class:`ICGN2D1`."""

    order = 2
