"""3D surface reconstruction from one stereo pair (the reference's
test_3d_reconstruction_epipolar.cpp and
test_3d_reconstruction_sift_epipolar.cpp).

A dense POI grid of view 1 is matched into view 2 by the epipolar search,
then each matched pair is triangulated.  With SIFT, a bilinear parallax
model is fitted to the SIFT2D matches and the search runs only +-6 px
around it (``set_search(8, 2)``); without, the search spans +-25 px around
the constant parallax (-30, -40).  Writes ``x,y,X,Y,Z,ZNCC`` rows.

The reference's "Step18" dataset is not committed; the GT4 pair is the
default input, read from the ``3d_dic`` folder of the directory that
``OPENCORR_REFERENCE_DIR`` names (the reference's ``examples``).

Usage:
  python -m opencorr_tpu_torch.examples.reconstruction_epipolar [--sift]
      [VIEW1 VIEW2 OUT_CSV]
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

from ..data import poi as poi_mod
from ..models.epipolar import EpipolarSearch
from ..models.sift2d import SIFT2D
from ..models.stereovision import Stereovision
from ..utils.precision import DeviceLike, resolve_device
from ..utils.timing import StageTimer
from .dic_2d import _image
from .stereo_3d_dic_epipolar_sift import gt4_cameras

VIEWS = ("GT4-0000_0.tif", "GT4-0000_1.tif")
SIFT_SEARCH = (8, 2)  # candidates at 0, +-2, +-4, +-6 px
CONSTANT_PARALLAX = (-30.0, -40.0)
CONSTANT_SEARCH = (30, 5)  # candidates at 0, +-5, ..., +-25 px


def reference_views():
    """The GT4 pair from ``$OPENCORR_REFERENCE_DIR/3d_dic``; raises
    FileNotFoundError naming what is missing."""
    root = os.environ.get("OPENCORR_REFERENCE_DIR")
    if root is None:
        raise FileNotFoundError(
            "no views given, and OPENCORR_REFERENCE_DIR (the reference's "
            f"examples directory) is not set; it needs 3d_dic/{VIEWS[0]} "
            f"and 3d_dic/{VIEWS[1]}")
    paths = [os.path.join(root, "3d_dic", name) for name in VIEWS]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(f"missing {', '.join(missing)}")
    return paths


def fit_parallax(ref_kp, tar_kp, width, height):
    """Bilinear parallax model fitted to SIFT matches
    (test_3d_reconstruction_sift_epipolar.cpp): least squares in float64,
    the coefficients (a, b, c) of x and of y rounded to float32."""
    dx = tar_kp[:, 0] - ref_kp[:, 0]
    dy = tar_kp[:, 1] - ref_kp[:, 1]
    a = np.stack(
        [ref_kp[:, 0] - width // 2, ref_kp[:, 1] - height // 2,
         np.ones(len(ref_kp))], axis=1)
    cx, *_ = np.linalg.lstsq(a, dx, rcond=None)
    cy, *_ = np.linalg.lstsq(a, dy, rcond=None)
    return cx.astype(np.float32), cy.astype(np.float32)


def run(use_sift: bool = True, view1=None, view2=None,
        out_path: Optional[str] = None, device: DeviceLike = None, *,
        sift_matches=None, stats: Optional[dict] = None):
    """Match ``poi_grid_2d((100, 100), (W-200)//5, (H-200)//5, 5)`` of view 1
    into view 2 and triangulate it, with the GT4 cameras; the epipolar
    search's coarse IC-GN at r=20, conv 0.05, 5 iterations.

    ``view1``/``view2``: paths, Image2D objects or arrays (None: the GT4
    pair, :func:`reference_views`).  ``sift_matches``: (ref_kp, tar_kp)
    host arrays that replace SIFT2D.  ``stats``, a dict, receives the
    SIFT2D octave counts, the match count, the parallax coefficients, the
    search's IC-GN counts and the matched view-2 points [N, 2]
    (``view2_points``).  Returns (rows [N, 6]: x, y, X, Y, Z, ZNCC;
    the StageTimer)."""
    dev = resolve_device(device)
    if view1 is None:
        view1, view2 = reference_views()
    if out_path is None:
        out_path = os.path.join(tempfile.gettempdir(), "reconstruction.csv")
    view1, view2 = _image(view1), _image(view2)
    info = stats if stats is not None else {}
    cam1, cam2 = gt4_cameras(dev)
    cam1.prepare(view1.height, view1.width)
    cam2.prepare(view2.height, view2.width)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    timer = StageTimer()
    epi = EpipolarSearch(cam1, cam2, device=dev)
    if use_sift:
        with timer.stage("SIFT"):
            if sift_matches is None:
                sift = SIFT2D(device=dev)
                sift.set_images(view1, view2)
                sift.prepare()
                sift.compute()
                sync()
                info["sift2d_octaves"] = list(sift.octave_stats)
                ref_kp, tar_kp = sift.ref_matched_kp, sift.tar_matched_kp
            else:
                ref_kp, tar_kp = (np.asarray(k, np.float32)
                                  for k in sift_matches)
        with timer.stage("Parallax fit"):
            cx, cy = fit_parallax(ref_kp, tar_kp, view1.width, view1.height)
        info.update(matches=int(len(ref_kp)), parallax_x=cx.tolist(),
                    parallax_y=cy.tolist())
        epi.set_parallax(cx, cy)
        epi.set_search(*SIFT_SEARCH)  # tight search around the fitted model
    else:
        epi.set_parallax(CONSTANT_PARALLAX)
        epi.set_search(*CONSTANT_SEARCH)
    epi.create_icgn(20, 20, 0.05, 5)
    epi.set_images(view1, view2)
    epi.prepare()

    pois = poi_mod.poi_grid_2d((100, 100), (view1.width - 200) // 5,
                               (view1.height - 200) // 5, 5, device=dev)
    with timer.stage("Epipolar matching"):
        pois = epi.compute(pois)
        sync()
    info["epipolar_icgn"] = dict(epi.icgn1.stats)

    sv = Stereovision(cam1, cam2)
    sv.prepare()
    with timer.stage("Reconstruction"):
        p1 = torch.stack([pois.x, pois.y], -1)
        p2 = torch.stack([pois.x + pois.p[:, poi_mod.U],
                          pois.y + pois.p[:, poi_mod.V]], -1)
        world = sv.reconstruct(p1, p2)
        sync()
    info["view2_points"] = p2

    rows = np.column_stack([pois.x.cpu().numpy(), pois.y.cpu().numpy(),
                            world.cpu().numpy(), pois.zncc.cpu().numpy()])
    with open(out_path, "w") as f:
        f.write("x,y,X,Y,Z,ZNCC\n")
        np.savetxt(f, rows, delimiter=",", fmt="%.6f")
    return rows, timer


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    rows, timer = run("--sift" in sys.argv or not args, *args)
    good = rows[:, 5] > 0.9
    print(timer.report())
    print(f"POIs {len(rows)}, ZNCC>0.9: {good.mean():.3f}, "
          f"Z range {np.percentile(rows[good, 4], [5, 50, 95])}")
