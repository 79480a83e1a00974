"""Stereo 3D-DIC: epipolar search, SIFT feature matching and triangulation.

The reference's workload ``test_3d_dic_epipolar_sift.cpp`` in four phases:
stereo match ref1 -> ref2 (coarse epipolar search, then ICGN2D2), temporal
match ref1 -> tar1 (SIFT2D -> FeatureAffine2D -> ICGN2D1), cross match
ref1 -> tar2 (epipolar search tar1 -> tar2 on the rounded tar1 points, the
displacements composed, then ICGN2D2), and the triangulation of both pairs
into 3D displacements.  ``run`` takes the images, the points and the two
cameras; ``load_gt4`` reads them from the GT4 directory layout.

Usage: python -m opencorr_tpu_torch.examples.stereo_3d_dic_epipolar_sift
    DATA_DIR [OUT_CSV]
"""

from __future__ import annotations

import contextlib
import sys
from typing import Optional

import numpy as np
import torch

from ..data import poi as poi_mod
from ..data.image import Image2D
from ..io import table as io_table
from ..models.calibration import Calibration, CameraExtrinsics, \
    CameraIntrinsics
from ..models.epipolar import EpipolarSearch
from ..models.feature_affine import FeatureAffine2D
from ..models.icgn import ICGN2D1, ICGN2D2
from ..models.sift2d import SIFT2D
from ..models.stereovision import Stereovision
from ..utils.precision import DeviceLike, resolve_device
from ..utils import timing
from ..utils.timing import StageTimer


def gt4_cameras(device: DeviceLike = None):
    """The example's two cameras (test_3d_dic_epipolar_sift.cpp:58-100)."""
    cam1 = Calibration(
        CameraIntrinsics(fx=6673.315918, fy=6669.302734, fs=0.0,
                         cx=872.15778, cy=579.95532, k1=0.032258954,
                         k2=-1.01141417, k3=29.78838921),
        CameraExtrinsics(), device=device)
    cam2 = Calibration(
        CameraIntrinsics(fx=6607.618164, fy=6602.857422, fs=0.0,
                         cx=917.9733887, cy=531.6352539, k1=0.064598486,
                         k2=-4.531373978, k3=29.78838921),
        CameraExtrinsics(tx=122.24886, ty=1.8488892, tz=17.624638,
                         rx=0.00307711, ry=-0.33278773, rz=0.00524556),
        device=device)
    return cam1, cam2


def load_gt4(data_dir: str, device: DeviceLike = None):
    """(ref_view1, ref_view2, tar_view1, tar_view2, points [N, 2], cam1,
    cam2) from the reference's 3d_dic example directory."""
    images = [Image2D.load(f"{data_dir}/{name}.tif") for name in
              ("GT4-0000_0", "GT4-0000_1", "GT4-0273_0", "GT4-0273_1")]
    pts = np.genfromtxt(f"{data_dir}/GT4-POIs.csv", delimiter=",",
                        skip_header=1, dtype=np.float32)[:, :2]
    return (*images, pts, *gt4_cameras(device))


def _view_pts(t: poi_mod.POITable2D) -> torch.Tensor:
    """[N, 2] matched positions x + u, y + v."""
    return torch.stack([t.x + t.p[:, poi_mod.U], t.y + t.p[:, poi_mod.V]],
                       -1)


def run(ref_view1, ref_view2, tar_view1, tar_view2, pts, cam1: Calibration,
        cam2: Calibration, out_path: Optional[str] = None,
        sift_features: int = 0, sift_matches=None, ransac_draws=None,
        stats: Optional[dict] = None, device: DeviceLike = None):
    """The four phases with the example's parameters: IC-GN at r=16, conv
    0.001, 10 iterations; the epipolar search at radius 30, step 5, its
    coarse IC-GN at r=20, conv 0.05, 10 iterations, parallax (-30, -40).

    ``pts`` [N, 2] view-1 points; the cameras must live on ``device``.
    ``sift_features``: the retainBest cap (0 keeps all, as the reference);
    ``sift_matches``: (ref_kp, tar_kp) host arrays that replace the SIFT
    stage; ``ransac_draws`` [3, N, 20]: FeatureAffine2D's trial draws
    (default: its seeded generator's).  ``stats``, a dict, receives the
    SIFT2D octave counts, the match count and the matched keypoints,
    FeatureAffine2D's codes and the IC-GN branch counts.  ``out_path`` None skips
    ``save_table_2ds``.  Returns (POITable2DS, timings in seconds of the
    phases r1_to_r2 (epipolar_r2, icgn2d2_r2), r1_to_t1 (sift2d,
    feature_affine2d, icgn2d1), r1_to_t2 (epipolar_t2, icgn2d2_t2),
    reconstruction and, when written, save_table_2ds, each closed by a
    device synchronisation)."""
    dev = resolve_device(device)
    pts = np.asarray(pts, np.float32).reshape(-1, 2)
    h, w = np.asarray(getattr(ref_view1, "mat", ref_view1)).shape[:2]
    timer = StageTimer()

    @contextlib.contextmanager
    def stage(name):
        """A stage of the timer, closed by the device's
        synchronisation."""
        with timer.stage(name):
            yield
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    cam1.prepare(h, w)
    cam2.prepare(h, w)
    stereo = Stereovision(cam1, cam2)
    pois = poi_mod.new_table_2d(pts[:, 0], pts[:, 1], device=dev)
    result = poi_mod.new_table_2ds(pts[:, 0], pts[:, 1], device=dev)

    subset_r = 16
    icgn1 = ICGN2D1(subset_r, subset_r, 0.001, 10, device=dev)
    icgn2 = ICGN2D2(subset_r, subset_r, 0.001, 10, device=dev)
    sift = SIFT2D(device=dev)
    if sift_features:
        sift.sift_config.n_features = int(sift_features)
    fa = FeatureAffine2D(subset_r, subset_r, device=dev)
    epi = EpipolarSearch(cam1, cam2, device=dev)
    epi.set_parallax((-30.0, -40.0))
    epi.set_search(30, 5)
    # 10 coarse iterations, as the JAX package's example (its note: the
    # reference example's 5 does not reproduce the GT4 golden table)
    epi.create_icgn(20, 20, 0.05, 10)
    r = result.r.clone()

    with stage("r1_to_r2"):  # phase 1: stereo match ref1 -> ref2
        with stage("epipolar_r2"):
            epi.set_images(ref_view1, ref_view2)
            epi.prepare()
            pois = epi.compute(pois)
        with stage("icgn2d2_r2"):
            icgn2.set_images(ref_view1, ref_view2)
            icgn2.prepare()
            pois = icgn2.compute(pois)
    ref_view2_pts = _view_pts(pois)
    r[:, 0] = pois.r[:, poi_mod.R_ZNCC]
    r[:, 3:5] = ref_view2_pts

    with stage("r1_to_t1"):  # phase 2: temporal match ref1 -> tar1
        with stage("sift2d"):
            if sift_matches is None:
                sift.set_images(ref_view1, tar_view1)
                sift.prepare()
                sift.compute()
                ref_mk, tar_mk = sift.ref_matched_kp, sift.tar_matched_kp
            else:
                ref_mk, tar_mk = sift_matches
        with stage("feature_affine2d"):
            fa.set_keypoint_pair(ref_mk, tar_mk)
            pois_t = poi_mod.new_table_2d(pts[:, 0], pts[:, 1], device=dev)
            fa.prepare(pois_t, points=pts)
            pois_t = fa.compute(pois_t, draws=ransac_draws)
            fa_codes = pois_t.r[:, poi_mod.R_ZNCC]
        with stage("icgn2d1"):
            icgn1.set_images(ref_view1, tar_view1)
            icgn1.prepare()
            pois_t = icgn1.compute(pois_t)
    tar_view1_pts = _view_pts(pois_t)
    r[:, 1] = pois_t.r[:, poi_mod.R_ZNCC]
    r[:, 5:7] = tar_view1_pts

    with stage("r1_to_t2"):  # phase 3: cross match ref1 -> tar2
        with stage("epipolar_t2"):
            rounded = timing.host_read("epipolar.sync.points",
                                       torch.round(tar_view1_pts))
            round_pois = poi_mod.new_table_2d(rounded[:, 0], rounded[:, 1],
                                              device=dev)
            epi.set_images(tar_view1, tar_view2)
            epi.prepare()
            round_pois = epi.compute(round_pois)
        with stage("icgn2d2_t2"):
            p = pois_t.p.clone()
            p[:, poi_mod.U] += round_pois.p[:, poi_mod.U]
            p[:, poi_mod.V] += round_pois.p[:, poi_mod.V]
            icgn2.set_images(ref_view1, tar_view2)
            icgn2.prepare()
            pois_x = icgn2.compute(pois_t.replace(p=p))
    tar_view2_pts = _view_pts(pois_x)
    r[:, 2] = pois_x.r[:, poi_mod.R_ZNCC]
    r[:, 7:9] = tar_view2_pts

    with stage("reconstruction"):  # phase 4: triangulation of both pairs
        stereo.prepare()
        ref_3d = stereo.reconstruct(torch.stack([pois.x, pois.y], -1),
                                    ref_view2_pts)
        tar_3d = stereo.reconstruct(tar_view1_pts, tar_view2_pts)
        disp = tar_3d - ref_3d

    result = result.replace(r=r, ref_coor=ref_3d, tar_coor=tar_3d, p=disp)
    if stats is not None:
        codes = fa_codes.cpu().numpy()
        stats.update(sift2d_octaves=list(sift.octave_stats),
                     matches=len(ref_mk), sift_matches=(ref_mk, tar_mk),
                     feature_affine2d_codes={
                         str(c): int((codes == c).sum())
                         for c in (0.0, -1.0, -2.0)},
                     icgn2d1=dict(icgn1.stats), icgn2d2=dict(icgn2.stats),
                     epipolar_icgn=dict(epi.icgn1.stats))
    if out_path is not None:
        with stage("save_table_2ds"):
            io_table.save_table_2ds(out_path, result)
    return result, dict(zip(timer.names, timer.seconds))


if __name__ == "__main__":
    args = sys.argv[1:]
    if not args:
        sys.exit(__doc__)
    *inputs, c1, c2 = load_gt4(args[0])
    _, times = run(*inputs, c1, c2, out_path=args[1] if len(args) > 1
                   else "GT4-0273_0_epipolar_sift_r16.csv")
    for k, v in times.items():
        print(f"{k}: {v:.3f}s")
