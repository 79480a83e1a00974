"""FeatureAffine2D and FeatureAffine3D (reference API:
oc_feature_affine.h:37-118): a per-POI first-order deformation guess from
matched keypoints, by RANSAC over the keypoints near each POI."""

from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Optional

import numpy as np
import torch

from ..data import poi as poi_mod
from ..ops import feature_affine as fa_ops
from ..utils import timing
from ..utils.precision import DeviceLike, resolve_device
from . import base


def _merge_2d(t: poi_mod.POITable2D, out) -> poi_mod.POITable2D:
    """As :func:`_merge_3d` for a 2D table: u ux uy v vx vy go to their
    columns of the 12-dof rows."""
    p6, zncc, it, feat, ok = out
    p = t.p.clone()
    for src, dst in enumerate((0, 1, 2, 6, 7, 8)):
        p[:, dst] = torch.where(ok, p6[:, src], t.p[:, dst])
    r = t.r.clone()
    r[:, poi_mod.R_ZNCC] = zncc
    r[:, poi_mod.R_ITER] = torch.where(ok, it, t.r[:, poi_mod.R_ITER])
    r[:, poi_mod.R_FEAT] = torch.where(ok, feat, t.r[:, poi_mod.R_FEAT])
    return t.replace(p=p, r=r)


def _merge_3d(t: poi_mod.POITable3D, out) -> poi_mod.POITable3D:
    """Write RANSAC results into a table: p and the iteration and feature
    counts where the fit succeeded, the code (0, -1 or -2) everywhere."""
    p12, zncc, it, feat, ok = out
    r = t.r.clone()
    r[:, poi_mod.R3_ZNCC] = zncc
    r[:, poi_mod.R3_ITER] = torch.where(ok, it, t.r[:, poi_mod.R3_ITER])
    r[:, poi_mod.R3_FEAT] = torch.where(ok, feat, t.r[:, poi_mod.R3_FEAT])
    return t.replace(p=torch.where(ok[:, None], p12, t.p), r=r)


class _CandidateCache:
    """Candidate tables memoised on the identity of the POI table's x
    tensor and the search parameters, so that repeated ``compute`` calls on
    one queue query the k-d tree once."""

    def __init__(self, cap: int = 8):
        self._entries = []  # [(weakref(x), params, data)]
        self._cap = cap

    def get(self, xobj, params, build):
        for ref, p, data in self._entries:
            if p == params and ref() is xobj:
                return data
        data = build()
        self._entries.append((weakref.ref(xobj), params, data))
        if len(self._entries) > self._cap:
            self._entries.pop(0)
        return data

    def clear(self):
        self._entries = []


def _trim(idx, cand, samples: int):
    """(idx, cand) [N, kc] (numpy arrays or tensors) without the columns
    past every row's last candidate (a row's candidates are a prefix of
    it), keeping a multiple of 16 and at least ``samples``: the draws are
    taken modulo each row's candidate count, so no result changes."""
    kc = idx.shape[1]
    keep = int(cand.sum(1).max()) if cand.shape[0] else 0
    kc_eff = min(kc, max(16, -(-max(keep, samples) // 16) * 16))
    return idx[:, :kc_eff], cand[:, :kc_eff]


def _host_candidates(tree, q, kc, radius, neighbor_min, samples):
    """The k-d tree candidate stage (the reference's nanoflann radius search
    with KNN fallback, oc_feature_affine.cpp:182-222): per query point the
    nearest keypoints in ascending distance; the candidates are the
    in-radius ones when there are at least ``neighbor_min``, else the
    nearest ``neighbor_min``.  Returns (idx [N, kc_eff] int32, cand_mask
    [N, kc_eff] bool, enough [N] bool).

    The query starts at k0 = max(16, neighbor_min, samples) neighbours and
    doubles k only for rows whose k-th neighbour is still in radius, up to
    ``kc``; the kept set is a prefix of each row (:func:`_trim`)."""
    k = min(kc, max(16, int(neighbor_min), int(samples)))
    d, idx = tree.query(q, k=k, workers=-1)
    if k == 1:
        d, idx = d[:, None], idx[:, None]
    while k < kc:
        sat = d[:, -1] < radius  # a full row in radius: may have more
        if not sat.any():
            break
        k2 = min(kc, 2 * k)
        d2, i2 = tree.query(q[sat], k=k2, workers=-1)
        d = np.pad(d, ((0, 0), (0, k2 - k)), constant_values=np.inf)
        idx = np.pad(idx, ((0, 0), (0, k2 - k)))
        d[sat], idx[sat] = d2, i2
        k = k2
    in_r = d < radius  # strict <, as d2 < r*r in the reference
    nr = in_r.sum(1)
    pos = np.arange(k)[None, :]
    cand_mask = np.where((nr >= neighbor_min)[:, None], in_r,
                         pos < neighbor_min)
    return _trim(idx.astype(np.int32), cand_mask, samples) + (
        nr >= samples,)


@dataclasses.dataclass
class RansacConfig:
    """oc_feature_affine.h:26-31."""

    trial_number: int
    sample_number: int
    error_threshold: float


class _FeatureAffine:
    """What FeatureAffine2D and FeatureAffine3D share: the keypoint pair,
    the candidate keypoints of every POI and the chunked RANSAC.

    ``neighbor_backend``: ``"host"`` (the default, as in the JAX package)
    searches with a host k-d tree (scipy's cKDTree, as the reference's
    nanoflann); ``"device"`` with the all-pairs search on the module's
    device (``ops.feature_affine.device_candidates``).  Both give the same
    candidates but where two keypoints lie at one distance from a POI (the
    k-d tree may order them either way; the device search takes the lower
    index first, as the JAX package's ``top_k``) or a distance rounds
    across the radius in float32.  The candidate columns past every POI's
    last candidate are dropped before the RANSAC, which changes no result.
    The RANSAC draws come from a ``torch.Generator`` seeded with ``seed``
    on the CPU, so a queue gets the same draws on every device.
    ``chunk_size`` POIs run at once.  ``compute`` runs in the span
    ``feature_affine.compute``, its RANSAC in ``feature_affine.ransac``;
    ``stats`` counts the POIs that end with -1 (``insufficient``) and -2
    (``inconsistent``), read once a compute, and in self-adaptive mode
    those moved to the centre of their keypoints' box (``moved``)."""

    dim = 0
    table_type = None
    zncc_col = 0
    layer = "feature_affine"

    def __init__(self, radii, neighbor_min: int, ransac: "RansacConfig",
                 k_cap: int, seed: int, chunk_size: Optional[int],
                 neighbor_backend: str, device: DeviceLike):
        if neighbor_backend not in ("host", "device"):
            raise ValueError(f"{type(self).__name__}: neighbor_backend "
                             f"{neighbor_backend!r}; 'host' or 'device'")
        self.device = resolve_device(device)
        self.neighbor_search_radius = float(
            np.sqrt(sum(r ** 2 for r in radii)))
        self.neighbor_number_min = int(neighbor_min)
        self.ransac = ransac
        self.k_cap = int(k_cap)
        self.seed = int(seed)
        self.chunk_size = chunk_size
        self.neighbor_backend = neighbor_backend
        self.ref_kp: Optional[np.ndarray] = None
        self.tar_kp: Optional[np.ndarray] = None
        self._tree = None
        self._cand = _CandidateCache()
        self.stats = collections.Counter()

    def set_search(self, radius: float, neighbor_min: int):
        self.neighbor_search_radius = float(radius)
        self.neighbor_number_min = int(neighbor_min)

    def set_ransac_config(self, cfg: RansacConfig):
        self.ransac = cfg

    def set_keypoint_pair(self, ref_kp, tar_kp):
        self.ref_kp = np.asarray(ref_kp, np.float32).reshape(-1, self.dim)
        self.tar_kp = np.asarray(tar_kp, np.float32).reshape(-1, self.dim)
        self._tree = None
        self._cand.clear()

    def prepare(self, table=None, points=None):
        """Build the keypoint k-d tree (the reference's prepare() builds its
        nanoflann index, oc_feature_affine.cpp:112-116; the device search
        needs none); with ``table``, also its candidate tables (``points``
        [N, D] spares the host search reading the coordinates back)."""
        if self.ref_kp is not None:
            if self.neighbor_backend == "host":
                from scipy.spatial import cKDTree

                self._tree = cKDTree(self.ref_kp)
            if table is not None:
                self._candidates(table, points)

    def _candidates(self, table, points=None):
        kc = min(self.k_cap, len(self.ref_kp))
        sm = self.ransac.sample_number
        params = (self.neighbor_backend, kc, self.neighbor_search_radius,
                  self.neighbor_number_min, sm)

        def build():
            if self.neighbor_backend == "device":
                idx, cand, enough = fa_ops.device_candidates(
                    self._keypoints()[0], self._coords(table),
                    self.neighbor_search_radius, self.neighbor_number_min,
                    sm, kc)
                return _trim(idx, cand, sm) + (enough,)
            if points is not None:
                q = np.asarray(points, np.float64).reshape(-1, self.dim)
            else:
                q = np.stack(table.coords_numpy(), -1).astype(np.float64)
            idx, cand, enough = _host_candidates(
                self._tree, q, kc, self.neighbor_search_radius,
                self.neighbor_number_min, sm)
            return tuple(torch.from_numpy(a).to(self.device)
                         for a in (idx, cand, enough))

        return self._cand.get(table.x, params, build)

    def _keypoints(self):
        """(ref_kp, tar_kp) as float32 tensors on the module's device."""
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (self.ref_kp, self.tar_kp))

    def _coords(self, table) -> torch.Tensor:
        """[N, D] POI coordinates (x, y[, z]) of ``table``, on its device."""
        axes = ("x", "y", "z")[:self.dim]
        return torch.stack([getattr(table, a) for a in axes], -1)

    def _ransac(self, ref_kp, tar_kp, t, idx, cand, enough, draws, trials,
                samples):  # pragma: no cover - overridden
        raise NotImplementedError

    def compute(self, table, draws: Optional[torch.Tensor] = None):
        """The guess for every POI of ``table``.  ``draws`` [D+1, N, trials]
        integer RANSAC draws in [0, 2^30) replace the module's own
        (``ops.feature_affine.ransac_draws(seed, N, trials, D+1)``)."""
        with timing.computing(self.layer, self.stats):
            self._ready(table)
            return self._counted(self._run(table, *self._candidates(table),
                                           draws))

    def _counted(self, table):
        """``table``, its -1 and -2 codes counted in ``stats``."""
        z = table.r[:, self.zncc_col]
        few, bad = timing.host_read(
            f"{self.layer}.sync.codes",
            torch.stack([(z == -1.0).sum(), (z == -2.0).sum()]))
        self.stats["insufficient"] += int(few)
        self.stats["inconsistent"] += int(bad)
        return table

    def _ready(self, table) -> None:
        if self.ref_kp is None:
            raise RuntimeError("call set_keypoint_pair() first")
        if not isinstance(table, self.table_type):
            raise TypeError(f"{type(self).__name__} takes "
                            f"{self.table_type.__name__}, got "
                            f"{type(table).__name__}")
        if table.device != self.device:
            raise ValueError(f"POI table on {table.device}, module on "
                             f"{self.device}")
        if self._tree is None and self.neighbor_backend == "host":
            self.prepare()

    def _run(self, table, idx, cand, enough, draws):
        """RANSAC over the candidate keypoints ``idx``/``cand`` [N, k] of
        every POI, chunked."""
        tr, sm = self.ransac.trial_number, self.ransac.sample_number
        shape = (self.dim + 1, table.n, tr)
        if draws is None:
            draws = fa_ops.ransac_draws(self.seed, table.n, tr, self.dim + 1)
        if tuple(draws.shape) != shape:
            raise ValueError(f"draws {tuple(draws.shape)}, expected {shape}")
        draws = draws.to(device=self.device, dtype=torch.int64)
        ref_kp, tar_kp = self._keypoints()

        def run(t, idx_c, cand_c, en_c, draws_c):
            return self._ransac(ref_kp, tar_kp, t, idx_c, cand_c, en_c,
                                draws_c.transpose(0, 1), tr, sm)

        with timing.span(f"{self.layer}.ransac"):
            return base.chunked(run, table, self.chunk_size, idx, cand,
                                enough, draws.transpose(0, 1))


class FeatureAffine2D(_FeatureAffine):
    """Per-POI 6-parameter guess from matched keypoints
    (oc_feature_affine.cpp:118-342).  Defaults per the reference's
    constructor (:34-47): search radius |(rx, ry)|, at least 7 neighbours,
    20 trials of 3 samples, 1.5 px error threshold.  After
    ``set_self_adaptive(True)`` each POI also gets the subset that covers
    its ``subset_feature_min`` nearest keypoints (:128-179)."""

    dim = 2
    table_type = poi_mod.POITable2D
    zncc_col = poi_mod.R_ZNCC

    def __init__(self, radius_x: int, radius_y: int, k_cap: int = 128,
                 seed: int = 0, chunk_size: Optional[int] = 16384,
                 neighbor_backend: str = "host", device: DeviceLike = None):
        super().__init__((radius_x, radius_y), 7,
                         RansacConfig(trial_number=20, sample_number=3,
                                      error_threshold=1.5),
                         k_cap, seed, chunk_size, neighbor_backend, device)
        self.subset_feature_min = 14  # self-adaptive mode (:46)
        self.subset_radius_min = 10  # (:47)
        self.self_adaptive = False

    def set_subset_adjustment(self, feature_min: int, radius_min: int):
        self.subset_feature_min = int(feature_min)
        self.subset_radius_min = int(radius_min)

    def set_self_adaptive(self, flag: bool) -> None:
        self.self_adaptive = bool(flag)

    def compute(self, table: poi_mod.POITable2D,
                draws: Optional[torch.Tensor] = None) -> poi_mod.POITable2D:
        if not self.self_adaptive:
            return super().compute(table, draws)
        with timing.computing(self.layer, self.stats):
            self._ready(table)
            return self._counted(self._adaptive(table, draws))

    def _adaptive(self, table, draws):
        with timing.span(f"{self.layer}.adapt"):
            t, knn = self._adapt_subsets(table)
        n, k = knn.shape
        sm = self.ransac.sample_number
        if self.neighbor_backend == "device":
            # the k nearest keypoints of the moved POIs (the JAX package's
            # knn_only search)
            idx, cand, enough = fa_ops.device_candidates(
                self._keypoints()[0], self._coords(t), 0.0,
                self.neighbor_number_min, sm, self.k_cap, knn_k=k)
            return self._run(t, *_trim(idx, cand, sm), enough, draws)
        to = lambda a: torch.from_numpy(a).to(self.device)
        return self._run(t, to(knn.astype(np.int32)),
                         to(np.ones((n, k), bool)), to(np.full(n, k >= sm)),
                         draws)

    def _adapt_subsets(self, table: poi_mod.POITable2D):
        """The self-adaptive subsets (oc_feature_affine.cpp:128-179): each
        POI's ``subset_feature_min`` nearest keypoints (by the k-d tree, or
        by the device search on float32 distances); a POI outside their
        bounding box moves to its centre; the radii cover the box from the
        POI, truncated to int as the reference does, and at least
        ``subset_radius_min``.  Returns (the table with the moved x, y and
        the radii in ``sr``, the KNN indices [N, k])."""
        xs, ys = (a.copy() for a in table.xy_numpy())
        n = table.n
        k = min(self.subset_feature_min, len(self.ref_kp))
        if self.neighbor_backend == "device":
            q = torch.from_numpy(np.stack([xs, ys], -1)).to(self.device)
            knn = fa_ops.device_candidates(
                self._keypoints()[0], q, 0.0, 0, 0, k, knn_k=k,
                fused=False)[0].cpu().numpy().astype(np.int64)
        else:
            _, knn = self._tree.query(np.stack([xs, ys], -1), k=k,
                                      workers=-1)
        knn = knn.reshape(n, k)
        kx = self.ref_kp[knn, 0]
        ky = self.ref_kp[knn, 1]
        x_min, x_max = kx.min(1), kx.max(1)
        y_min, y_max = ky.min(1), ky.max(1)
        half = np.float32(0.5)
        inside = (xs >= x_min) & (xs <= x_max) & (ys >= y_min) & (ys <= y_max)
        self.stats["moved"] += int((~inside).sum())
        srx = np.where(
            inside,
            np.maximum(np.abs(x_max - xs), np.abs(xs - x_min)).astype(np.int32),
            (half * (x_max - x_min)).astype(np.int32))
        sry = np.where(
            inside,
            np.maximum(np.abs(y_max - ys), np.abs(ys - y_min)).astype(np.int32),
            (half * (y_max - y_min)).astype(np.int32))
        xs = np.where(inside, xs, (half * (x_max + x_min)).astype(np.int32))
        ys = np.where(inside, ys, (half * (y_max + y_min)).astype(np.int32))
        sr = np.stack([np.maximum(srx, self.subset_radius_min),
                       np.maximum(sry, self.subset_radius_min)], -1)
        to = lambda a: torch.from_numpy(
            np.ascontiguousarray(a, np.float32)).to(self.device)
        t = table.replace(x=to(xs), y=to(ys), sr=to(sr))
        t.host_xy = (xs.astype(np.float32), ys.astype(np.float32))
        return t, knn

    def _ransac(self, ref_kp, tar_kp, t, idx, cand, enough, draws, trials,
                samples):
        out = fa_ops.feature_affine_2d_idx(
            ref_kp, tar_kp, t.x, t.y, idx, cand, enough,
            self.neighbor_number_min, self.ransac.error_threshold, draws,
            trials=trials, samples=samples)
        return _merge_2d(t, out)


class FeatureAffine3D(_FeatureAffine):
    """Per-POI 12-parameter guess from matched keypoints
    (oc_feature_affine.cpp:357-560).  Defaults per the reference's
    constructor: search radius |(rx, ry, rz)|, at least 16 neighbours,
    32 trials of 4 samples, 3.2 voxel error threshold."""

    dim = 3
    table_type = poi_mod.POITable3D
    zncc_col = poi_mod.R3_ZNCC

    def __init__(self, radius_x: int, radius_y: int, radius_z: int,
                 k_cap: int = 128, seed: int = 0,
                 chunk_size: Optional[int] = 131072,
                 neighbor_backend: str = "host", device: DeviceLike = None):
        super().__init__((radius_x, radius_y, radius_z), 16,
                         RansacConfig(trial_number=32, sample_number=4,
                                      error_threshold=3.2),
                         k_cap, seed, chunk_size, neighbor_backend, device)

    def _ransac(self, ref_kp, tar_kp, t, idx, cand, enough, draws, trials,
                samples):
        out = fa_ops.feature_affine_3d_idx(
            ref_kp, tar_kp, t.x, t.y, t.z, idx, cand, enough,
            self.neighbor_number_min, self.ransac.error_threshold, draws,
            trials=trials, samples=samples)
        return _merge_3d(t, out)
