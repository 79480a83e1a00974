"""2D DIC workloads: every planar pipeline of the reference example suite.

One entry point runs the reference programs (6_Examples.md):

* ``fftcc_icgn1``   test_2d_dic_fftcc_icgn1.cpp (path-independent DIC)
* ``fftcc_iclm1``   test_2d_dic_fftcc_iclm1.cpp
* ``fftcc_nr1``     test_2d_dic_fftcc_nr1.cpp
* ``sift_icgn2``    test_2d_dic_sift_icgn2.cpp (large rotation)
* ``sift_iclm2``    test_2d_dic_sift_iclm2.cpp
* ``self_adaptive`` test_2d_dic_self_adaptive_subset.cpp
* ``strain``        test_2d_dic_strain.cpp (resumes from a result table)

Each writes the result table, the deformation table and the stage times
(``<out_prefix>_<workload>.csv``, ``..._deformation.csv``,
``..._time.csv``); ``strain`` writes its table, the eyy map and its time.

Usage:
  python -m opencorr_tpu_torch.examples.dic_2d WORKLOAD [REF TAR [OUT_PREFIX]]
  python -m opencorr_tpu_torch.examples.dic_2d strain [TABLE_CSV [OUT_PREFIX]]

Without images, the reference's datasets are read from the ``2d_dic``
folder of the directory that ``OPENCORR_REFERENCE_DIR`` names (the
reference's ``examples``); a missing file raises and is named.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from ..data import poi as poi_mod
from ..data.image import Image2D
from ..io import native, table as io_table
from ..models.feature_affine import FeatureAffine2D
from ..models.fftcc import FFTCC2D
from ..models.icgn import ICGN2D1, ICGN2D2
from ..models.iclm import ICLM2D1, ICLM2D2
from ..models.nr import NR2D1
from ..models.sift2d import SIFT2D
from ..models.strain import Strain
from ..utils.precision import DeviceLike, resolve_device
from ..utils.timing import StageTimer

WORKLOADS = ("fftcc_icgn1", "fftcc_iclm1", "fftcc_nr1", "sift_icgn2",
             "sift_iclm2", "self_adaptive", "strain")
# the reference programs' subset radii and POI grids
# (upper-left corner, number in x, number in y, step)
RADIUS = {"fftcc_icgn1": 16, "fftcc_iclm1": 16, "fftcc_nr1": 16,
          "sift_icgn2": 12, "sift_iclm2": 12, "self_adaptive": 30}
_FFTCC_GRID = ((30, 30), 100, 300, 2)  # oht_cfrp
_SIFT_GRID = ((50, 50), 205, 205, 2)  # rotation
GRIDS = {"fftcc_icgn1": _FFTCC_GRID, "fftcc_iclm1": _FFTCC_GRID,
         "fftcc_nr1": _FFTCC_GRID, "sift_icgn2": _SIFT_GRID,
         "sift_iclm2": _SIFT_GRID,
         "self_adaptive": ((50, 50), 480, 80, 5)}  # utn
_OHT = ("oht_cfrp_0.bmp", "oht_cfrp_4.bmp")
_ROT = ("rotation_000.tif", "rotation_170.tif")
IMAGES = {"fftcc_icgn1": _OHT, "fftcc_iclm1": _OHT, "fftcc_nr1": _OHT,
          "sift_icgn2": _ROT, "sift_iclm2": _ROT,
          "self_adaptive": ("utn_00.bmp", "utn_30.bmp"),
          "strain": ("oht_cfrp_4_fftcc_icgn1_r16.csv",)}
# the strain workload's eyy map: the oht_cfrp image's size
STRAIN_MAP_HW = (900, 280)
_REFINERS = {"fftcc_icgn1": ICGN2D1, "fftcc_iclm1": ICLM2D1,
             "fftcc_nr1": NR2D1, "sift_icgn2": ICGN2D2,
             "sift_iclm2": ICLM2D2}


def reference_inputs(workload: str):
    """The reference's files of ``workload``, from the ``2d_dic`` folder
    of ``$OPENCORR_REFERENCE_DIR``; raises FileNotFoundError naming what
    is missing."""
    root = os.environ.get("OPENCORR_REFERENCE_DIR")
    names = IMAGES[workload]
    if root is None:
        raise FileNotFoundError(
            f"{workload}: no inputs given, and OPENCORR_REFERENCE_DIR (the "
            f"reference's examples directory) is not set; it needs "
            f"2d_dic/{', 2d_dic/'.join(names)}")
    paths = [os.path.join(root, "2d_dic", name) for name in names]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(f"{workload}: missing {', '.join(missing)}")
    return paths


def _image(img):
    """A path (loaded as 8-bit grayscale), an Image2D or an array."""
    if isinstance(img, (str, os.PathLike)):
        return Image2D.load(os.fspath(img))
    return img if hasattr(img, "mat") else Image2D.from_array(img)


def run(workload: str, ref=None, tar=None, out_prefix: Optional[str] = None,
        device: DeviceLike = None, *, grid=None, sift_matches=None,
        ransac_draws: Optional[torch.Tensor] = None,
        stats: Optional[dict] = None):
    """Run one workload with the reference program's parameters.

    ``ref``/``tar``: image paths or arrays; for ``strain``, ``ref`` is the
    result table to resume from.  None reads the reference's datasets
    (:func:`reference_inputs`).  ``grid``: ``poi_grid_2d``'s (upper-left,
    number_x, number_y, step), by default the program's.
    ``sift_matches``: (ref_kp, tar_kp) host arrays that replace the SIFT
    stage; ``ransac_draws`` [3, N, 20]: FeatureAffine2D's trial draws
    (default: its seeded generator's).  ``stats``, a dict, receives the
    modules' branch counts, the SIFT2D octave counts and matched
    keypoints, FeatureAffine2D's codes, the self-adaptive r_max, which table writer ran and the table
    writes' seconds.  Each stage is the span ``oc:<name>``
    (:class:`StageTimer`), recorded only under ``torch.profiler``.
    Returns (the result table, the StageTimer)."""
    if workload not in WORKLOADS:
        raise ValueError(f"unknown workload {workload!r}; one of "
                         f"{', '.join(WORKLOADS)}")
    dev = resolve_device(device)
    if out_prefix is None:
        out_prefix = os.path.join(tempfile.gettempdir(), "dic2d")
    info = stats if stats is not None else {}
    timer = StageTimer()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def save(name, fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        info[f"{name}_s"] = time.perf_counter() - t0
        info["writer"] = "native" if native.available() else "python"

    if workload == "strain":
        table_path = ref if ref is not None else reference_inputs(
            workload)[0]
        pois = io_table.load_table_2d(table_path, device=dev)
        strain = Strain(subregion_radius=20.0, neighbor_number_min=5,
                        device=dev)
        with timer.stage("Strain calculation"):
            strain.prepare(pois)
            pois = strain.compute(pois)
            sync()
        save("save_table_2d", io_table.save_table_2d,
             f"{out_prefix}_strain_r20.csv", pois)
        io_table.save_map_2d(f"{out_prefix}_eyy.csv", pois, "eyy",
                             *STRAIN_MAP_HW)
        timer.save_csv(f"{out_prefix}_strain_r20_time.csv", pois.n)
        return pois, timer

    if ref is None:
        ref, tar = reference_inputs(workload)
    ref, tar = _image(ref), _image(tar)
    pois = poi_mod.poi_grid_2d(*(grid or GRIDS[workload]), device=dev)
    r = RADIUS[workload]

    def features(stage):
        """SIFT2D (or the given matches) under ``stage``."""
        with timer.stage(stage):
            if sift_matches is not None:
                return sift_matches
            sift = SIFT2D(device=dev)
            sift.set_images(ref, tar)
            sift.prepare()
            sift.compute()
            sync()
            info["sift2d_octaves"] = list(sift.octave_stats)
            info["sift_matches"] = (sift.ref_matched_kp, sift.tar_matched_kp)
            return sift.ref_matched_kp, sift.tar_matched_kp

    def refine(module, stage, table):
        module.set_images(ref, tar)
        with timer.stage(stage):
            module.prepare()
            table = module.compute(table)
            sync()
        info["refine_stats"] = dict(module.stats)
        return table

    def fa_codes(table):
        codes = table.r[:, poi_mod.R_ZNCC].cpu().numpy()
        info["feature_affine2d_codes"] = {
            str(c): int((codes == c).sum()) for c in (0.0, -1.0, -2.0)}

    if workload.startswith("fftcc"):
        fftcc = FFTCC2D(r, r, device=dev)
        fftcc.set_images(ref, tar)
        with timer.stage("FFTCC"):
            pois = fftcc.compute(pois)
            sync()
        info["fftcc_stats"] = dict(fftcc.stats)
        pois = refine(_REFINERS[workload](r, r, 0.001, 10, device=dev),
                      workload.split("_")[1].upper(), pois)
    elif workload.startswith("sift"):
        kp = features("SIFT")
        fa = FeatureAffine2D(r, r, device=dev)
        fa.set_keypoint_pair(*kp)
        with timer.stage("FeatureAffine"):
            pois = fa.compute(pois, draws=ransac_draws)
            sync()
        fa_codes(pois)
        pois = refine(_REFINERS[workload](r, r, 0.001, 10, device=dev),
                      workload.split("_")[1].upper(), pois)
    else:  # self_adaptive
        kp = features("Feature extraction and matching")
        fa = FeatureAffine2D(r, r, device=dev)
        # the reference program: neighbor_num = 2 * getNeighborMin() = 14
        neighbor_num = 2 * fa.neighbor_number_min
        fa.set_search(float(np.sqrt(2.0 * r * r)), neighbor_num)
        fa.set_self_adaptive(True)
        fa.set_subset_adjustment(neighbor_num, 10)
        fa.set_keypoint_pair(*kp)
        with timer.stage("Subset optimization"):
            pois = fa.compute(pois, draws=ransac_draws)
            sync()
        fa_codes(pois)
        info["r_max"] = int(pois.sr.max())
        icgn = ICGN2D1(r, r, 0.001, 10, device=dev)
        icgn.set_self_adaptive(True)
        pois = refine(icgn, "ICGN", pois)
        strain = Strain(25.0, 10, device=dev)
        with timer.stage("Strain"):
            pois = strain.compute(pois)
            sync()

    save("save_table_2d", io_table.save_table_2d,
         f"{out_prefix}_{workload}.csv", pois)
    save("save_deformation_table_2d", io_table.save_deformation_table_2d,
         f"{out_prefix}_{workload}_deformation.csv", pois)
    timer.save_csv(f"{out_prefix}_{workload}_time.csv", pois.n)
    return pois, timer


if __name__ == "__main__":
    args = sys.argv[1:]
    if not args:
        sys.exit(__doc__)
    wl, rest = args[0], args[1:]
    n_in = 1 if wl == "strain" else 2
    inputs = (rest[:n_in] + [None] * n_in)[:n_in] + [None] * (2 - n_in)
    _, timer = run(wl, *inputs, *rest[n_in:n_in + 1])
    print(timer.report())
