"""Stereo 3D-DIC on one frame pair, each frame two views, chained as
``opencorr_tpu_torch/examples/stereo_3d_dic_epipolar_sift.py::run``
chains its four phases (new modules each pair, ``set_images`` from the
host views, a synchronise after each stage):

1. EpipolarSearch ref1 -> ref2, then ICGN2D2;
2. SIFT2D ref1 -> tar1, FeatureAffine2D, then ICGN2D1;
3. EpipolarSearch tar1 -> tar2 on the tar1 matches rounded to pixels, its
   displacement added to phase 2's, then ICGN2D2 ref1 -> tar2;
4. Stereovision's triangulation of both pairs (the cameras' undistortion
   maps built first).

The pair ends when the stereo table is on the host, laid out for
``core/check.py`` a slot a match (r2, t1, t2): ``p`` [N, 3, 5] holds on
every slot the POI's 3D displacement (u, v, w, mm) and the match's
position (x, y, px); ``r`` the three slot codes (a POI's first failure on
all three slots, else each match's ZNCC), the two searches' candidate
displacements (u0, v0 of each winner), a column of ones (both searches
run every POI) and the three matches' own codes.  No table is written to
disk.
"""

from __future__ import annotations

import numpy as np
import torch

import opencorr_tpu_torch as ot
from opencorr_tpu_torch.data import poi as poi_mod
from opencorr_tpu_torch.ops import _kernels, bspline
from opencorr_tpu_torch.utils import timing

from core.check import Layout
from reference import stereo as plain

# the kernels the path launches, built at set-up: kernel 1 (the searches'
# and refiners' window gathers), kernel 2 (the refiners' windowed eval)
# and kernel 6 (the searches' global-LUT eval), whose launches the
# roofline reader counts
KERNELS = ("gather2d", "lattice2d", "bicubic2d")
COUNTED = {"bicubic2d": bspline.bicubic_eval}
LAYOUT = Layout(seed=(3, 4, 5, 6), zncc=(0, 1, 2), iterations=7,
                disp=(0, 1, 2), grad=(3, 4), ref_disp=(0, 1, 2),
                ref_grad=(3, 4))


def calibrations(cfg: dict, device) -> list:
    """The configuration's cameras as the port's Calibration objects, the
    principal points moved to ``sensor_origin`` when it is given."""
    ox, oy = cfg.get("sensor_origin", (0, 0))
    und = cfg["undistortion"]
    out = []
    for cam in cfg["cameras"]:
        i = dict(cam["intrinsics"])
        i["cx"] -= ox
        i["cy"] -= oy
        c = ot.Calibration(ot.CameraIntrinsics(**i),
                           ot.CameraExtrinsics(**cam["extrinsics"]),
                           device=device)
        c.set_undistortion(und["convergence"], und["iteration"])
        out.append(c)
    return out


def _matched(t) -> torch.Tensor:
    """[N, 2] matched positions x + u, y + v of a refined table."""
    return torch.stack([t.x + t.p[:, poi_mod.U], t.y + t.p[:, poi_mod.V]],
                       -1)


class Pipeline:
    def __init__(self, cfg: dict, device):
        if not hasattr(ot.EpipolarSearch, "stats"):
            # the cell reads the search's own spans and counters
            # (``epipolar.*``), which a program before them lacks
            raise SystemExit("stereo_epipolar_sift: this program's "
                             "EpipolarSearch keeps no stats")
        self.cfg = cfg
        self.dev = ot.resolve_device(device)
        # build seconds by kernel, 0 for a library found built
        self.build_s = {}
        if self.dev.type == "cuda":
            self.build_s = _kernels.build(KERNELS)
            for name in KERNELS:
                _kernels.load(name)
        self.ref = None
        # the last pair's branch counts of every module (their ``stats``)
        self.stats = {}

    def setup(self, reference_u8) -> None:
        self.ref = [ot.Image2D.from_array(v) for v in reference_u8]

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _search(self, cams, views, table):
        ec = self.cfg["epipolar"]
        epi = ot.EpipolarSearch(*cams, chunk_size=ec["chunk_size"],
                                device=self.dev)
        epi.set_parallax(tuple(ec["parallax"]))
        epi.set_search(ec["search_radius"], ec["search_step"])
        epi.create_icgn(ec["radius"], ec["radius"], ec["conv"],
                        ec["max_iter"])
        epi.set_images(*views)
        epi.prepare()
        return epi, epi.compute(table)

    def _icgn2(self, views, table):
        ic = self.cfg["icgn2d2"]
        icgn = ot.ICGN2D2(ic["radius"], ic["radius"], ic["conv"],
                          ic["max_iter"], device=self.dev)
        icgn.set_images(*views)
        icgn.prepare()
        return icgn, icgn.compute(table)

    def pair(self, target_u8, span) -> dict:
        cfg, dev = self.cfg, self.dev
        ref1, ref2 = self.ref
        tar1, tar2 = (ot.Image2D.from_array(v) for v in target_u8)
        pts = plain.grid_points(cfg).astype(np.float32)
        cams = calibrations(cfg, dev)
        stats = {}

        def keep(m):
            stats.update({f"{m.layer}.{k}": stats.get(f"{m.layer}.{k}", 0)
                          + v for k, v in m.stats.items()})

        # phase 1: ref1 -> ref2
        fresh = lambda p: ot.new_table_2d(p[:, 0], p[:, 1], device=dev)
        with span("epipolar"):
            epi, s1 = self._search(cams, (ref1, ref2), fresh(pts))
            keep(epi)
            self._sync()
        with span("icgn2d2"):
            icgn, r2 = self._icgn2((ref1, ref2), s1)
            keep(icgn)
            self._sync()

        # phase 2: ref1 -> tar1
        sc = cfg["sift2d"]
        sift = ot.SIFT2D(backend=sc["backend"], device=dev)
        sift.set_sift_config(ot.Sift2dConfig(
            n_features=sc["n_features"], n_octave_layers=sc["n_octave_layers"],
            contrast_threshold=sc["contrast_threshold"],
            edge_threshold=sc["edge_threshold"], sigma=sc["sigma"]))
        sift.set_matching(sc["matching_ratio"])
        with span("sift2d"):
            sift.set_images(ref1, tar1)
            sift.prepare()
            sift.compute()
            keep(sift)
            self._sync()
        fc = cfg["feature_affine"]
        rs = fc["ransac"]
        fa = ot.FeatureAffine2D(fc["radius"], fc["radius"], k_cap=fc["k_cap"],
                                seed=fc["seed"], device=dev)
        fa.set_search(fc["search_radius"], fc["neighbor_number"])
        fa.set_ransac_config(ot.RansacConfig(
            rs["trials"], rs["samples"], rs["error_threshold"]))
        with span("feature_affine"):
            fa.set_keypoint_pair(sift.ref_matched_kp, sift.tar_matched_kp)
            t1 = fresh(pts)
            fa.prepare(t1, points=pts)
            t1 = fa.compute(t1)
            keep(fa)
            self._sync()
        ic = cfg["icgn2d1"]
        icgn1 = ot.ICGN2D1(ic["radius"], ic["radius"], ic["conv"],
                           ic["max_iter"], device=dev)
        with span("icgn2d1"):
            icgn1.set_images(ref1, tar1)
            icgn1.prepare()
            t1 = icgn1.compute(t1)
            keep(icgn1)
            self._sync()
        m_t1 = _matched(t1)

        # phase 3: ref1 -> tar2 through the search tar1 -> tar2
        with span("epipolar"):
            start = timing.host_read("epipolar.sync.points",
                                     torch.round(m_t1))
            epi, s2 = self._search(cams, (tar1, tar2), fresh(start))
            keep(epi)
            self._sync()
        with span("icgn2d2"):
            p = t1.p.clone()
            p[:, poi_mod.U] += s2.p[:, poi_mod.U]
            p[:, poi_mod.V] += s2.p[:, poi_mod.V]
            icgn, t2 = self._icgn2((ref1, tar2), t1.replace(p=p))
            keep(icgn)
            self._sync()

        # phase 4: triangulation of both pairs
        h, w = ref1.mat.shape[:2]
        with span("reconstruct"):
            for c in cams:
                c.prepare(h, w)
            stereo = ot.Stereovision(*cams)
            stereo.prepare()
            m_r2, m_t2 = _matched(r2), _matched(t2)
            ref3d = stereo.reconstruct(torch.stack([r2.x, r2.y], -1), m_r2)
            tar3d = stereo.reconstruct(m_t1, m_t2)
            self._sync()
        self.stats = stats
        with span("readback"):
            z = poi_mod.R_ZNCC
            codes = torch.stack([r2.r[:, z], t1.r[:, z], t2.r[:, z]], 1)
            seeds = torch.cat([s1.r[:, :2], s2.r[:, :2]], 1)
            matched = torch.stack([m_r2, m_t1, m_t2], 1)
            host = lambda a: a.cpu().numpy().astype(np.float64)
            codes, seeds = host(codes), host(seeds)
            r = np.concatenate([plain.slot_codes(codes), seeds,
                                np.ones((len(codes), 1)), codes], 1)
            return {"p": plain.slots(host(tar3d - ref3d), host(matched)),
                    "r": r, "e": np.zeros((len(codes), 3))}

    def close(self) -> None:
        self.ref = None


def reference(cfg: dict, reference_u8, target_u8, device,
              dtype=torch.float64, sample_dtype=None) -> dict:
    return plain.run(reference_u8, target_u8, cfg, device, dtype,
                     sample_dtype)


def as_table(ref: dict) -> dict:
    """A reference result laid out as the program's table."""
    n = len(ref["seed"])
    return {"p": ref["p"], "e": ref["strain"], "r": np.concatenate(
        [ref["zncc"], ref["seed"], np.ones((n, 1)), ref["codes"]], 1)}


def control(cfg: dict, reference_u8, target_u8, device) -> dict:
    """The control of ``correct``, laid out as the program's table: the
    plain reference computed in float32 with every target sample rounded
    to float16, the precision below the configuration's float32."""
    return as_table(reference(cfg, reference_u8, target_u8, device,
                              torch.float32, torch.float16))
