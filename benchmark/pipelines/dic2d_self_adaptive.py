"""Self-adaptive-subset 2D DIC on one pair: SIFT2D -> FeatureAffine2D with
self-adaptive subsets -> ICGN2D1 at each POI's radii through the global
LUT -> Strain, chained as ``opencorr_tpu_torch/examples/dic_2d.py::run``
chains its ``self_adaptive`` workload (new modules each pair,
``set_images`` from the host frames, a synchronise after each stage).
The pair ends when the result table is on the host: p, e, and r with the
adapted x, y, srx and sry appended, which fix where and on what subset
each POI is refined.  No table is written to disk.
"""

from __future__ import annotations

import torch

import opencorr_tpu_torch as ot

from core.check import Layout
from reference import self_adaptive as plain

# no hand-written kernel runs on this path: the refiner samples the global
# LUT (ops/bspline.py) and SIFT2D and FeatureAffine2D are PyTorch
KERNELS = ()
COUNTED = {}
# zncc and iteration of r and the appended x y srx sry; u v and ux uy vx vy
# of p (12-dof rows)
LAYOUT = Layout(seed=(6, 7, 8, 9), zncc=2, iterations=3, disp=(0, 6),
                grad=(1, 2, 7, 8), ref_disp=(0, 3), ref_grad=(1, 2, 4, 5))


class Pipeline:
    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.dev = ot.resolve_device(device)
        self.build_s = {}
        self.ref = None
        # the last pair's branch counts of SIFT2D, FeatureAffine2D and the
        # refiner (their ``stats``)
        self.stats = {}

    def setup(self, reference_u8) -> None:
        self.ref = ot.Image2D.from_array(reference_u8)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def pair(self, target_u8, span) -> dict:
        cfg, dev = self.cfg, self.dev
        tar = ot.Image2D.from_array(target_u8)
        g = cfg["poi_grid"]
        pois = ot.poi_grid_2d(tuple(g["upper_left"]), g["number_x"],
                              g["number_y"], g["step"], device=dev)
        sc = cfg["sift2d"]
        sift = ot.SIFT2D(backend=sc["backend"], device=dev)
        sift.set_sift_config(ot.Sift2dConfig(
            n_octave_layers=sc["n_octave_layers"],
            contrast_threshold=sc["contrast_threshold"],
            edge_threshold=sc["edge_threshold"], sigma=sc["sigma"]))
        sift.set_matching(sc["matching_ratio"])
        with span("sift2d"):
            sift.set_images(self.ref, tar)
            sift.prepare()
            sift.compute()
            self._sync()
        fc = cfg["feature_affine"]
        rs = fc["ransac"]
        fa = ot.FeatureAffine2D(fc["radius"], fc["radius"], seed=fc["seed"],
                                device=dev)
        fa.set_search(fc["search_radius"], fc["neighbor_number"])
        fa.set_ransac_config(ot.RansacConfig(
            rs["trials"], rs["samples"], rs["error_threshold"]))
        fa.set_self_adaptive(fc["self_adaptive"])
        fa.set_subset_adjustment(fc["subset_feature_min"],
                                 fc["subset_radius_min"])
        with span("feature_affine"):
            fa.set_keypoint_pair(sift.ref_matched_kp, sift.tar_matched_kp)
            pois = fa.compute(pois)
            self._sync()
        ic = cfg["icgn"]
        icgn = ot.ICGN2D1(ic["radius"], ic["radius"], ic["conv"],
                          ic["max_iter"], device=dev)
        icgn.set_self_adaptive(ic["self_adaptive"])
        with span("icgn.adaptive"):
            icgn.set_images(self.ref, tar)
            icgn.prepare()
            pois = icgn.compute(pois)
            self._sync()
        self.stats = {f"{m.layer}.{k}": v for m in (sift, fa, icgn)
                      for k, v in m.stats.items()}
        st = cfg["strain"]
        strain = ot.Strain(st["radius"], st["neighbor_min"], device=dev)
        strain.set_zncc_threshold(st["zncc_min"])
        with span("strain"):
            pois = strain.compute(pois)
            self._sync()
        with span("readback"):
            r = torch.cat([pois.r, pois.x[:, None], pois.y[:, None],
                           pois.sr], 1)
            return {"p": pois.p.cpu().numpy(), "r": r.cpu().numpy(),
                    "e": pois.e.cpu().numpy()}

    def close(self) -> None:
        self.ref = None


def reference(cfg: dict, reference_u8, target_u8, device,
              dtype=torch.float64) -> dict:
    return plain.run(reference_u8, target_u8, cfg, device, dtype)
