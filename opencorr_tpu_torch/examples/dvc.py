"""DVC (digital volume correlation) workloads of the reference's examples.

* ``fftcc_icgn1``  test_dvc_fftcc_icgn1.cpp (al_foam4: FFTCC3D + ICGN3D1,
  r=30)
* ``sift_icgn1``   test_dvc_sift_icgn1.cpp (Torus: SIFT3D +
  FeatureAffine3D + ICGN3D1, r=16)
* ``strain``       test_dvc_strain.cpp (resumes from a result table)

The reference's CT volumes are external downloads; without volumes a
synthetic deformed speckle volume runs the whole pipeline.  Volumes load
from OpenCorr ``.bin`` (an int32[3] dims header and a float32 payload) or a
multi-page TIFF, or are given as ``Image3D`` objects, arrays or tensors.
Each refining workload writes ``<out_prefix>_<workload>.csv``, its ``.bin``
matrix and ``..._time.csv``; ``strain`` writes ``<out_prefix>_strain_r30.csv``
and its time.

Usage:
  python -m opencorr_tpu_torch.examples.dvc WORKLOAD [REF TAR [POI_CSV
      [OUT_PREFIX]]]
  python -m opencorr_tpu_torch.examples.dvc strain TABLE_CSV [OUT_PREFIX]
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
from ..data.image import Image3D
from ..io import native, table as io_table
from ..models.feature_affine import FeatureAffine3D
from ..models.fftcc import FFTCC3D
from ..models.icgn import ICGN3D1
from ..models.sift3d import SIFT3D
from ..models.strain import Strain
from ..utils.precision import DeviceLike, resolve_device
from ..utils.timing import StageTimer

WORKLOADS = ("fftcc_icgn1", "sift_icgn1", "strain")


def synthetic_pair(d=96, seed=0):
    """A [d, d, d] speckle volume and its target translated by (u, v, w) =
    (0.5, -0.8, 1.2) voxels."""
    from scipy.ndimage import gaussian_filter, shift as ndshift

    rng = np.random.default_rng(seed)
    pad = 12
    base = gaussian_filter(
        rng.standard_normal((d + 2 * pad,) * 3).astype(np.float32), 1.4
    ) * 80 + 128
    ref = base[pad:-pad, pad:-pad, pad:-pad]
    tar = ndshift(base, (1.2, -0.8, 0.5), order=3)[pad:-pad, pad:-pad,
                                                   pad:-pad]
    return Image3D.from_array(ref), Image3D.from_array(tar)


def _volume(vol):
    """A path (``.bin`` or TIFF), an Image3D, an array or a tensor."""
    if isinstance(vol, (str, os.PathLike)):
        return Image3D.load(os.fspath(vol))
    return vol


def _dims_xyz(vol):
    z, y, x = getattr(vol, "mat", vol).shape
    return int(x), int(y), int(z)


def run(workload: str = "fftcc_icgn1", ref=None, tar=None, poi_csv=None,
        out_prefix: Optional[str] = None, device: DeviceLike = None, *,
        sift_backend: Optional[str] = None,
        ransac_draws: Optional[torch.Tensor] = None,
        stats: Optional[dict] = None):
    """Run one workload with the reference program's parameters: r=30 for
    ``fftcc_icgn1``, r=16 for ``sift_icgn1`` (r=10 on the synthetic pair),
    ICGN3D1 at conv 0.001 and 10 iterations, Strain(30, 10).

    ``ref``/``tar``: the volumes; for ``strain``, ``ref`` is the result
    table to resume from.  ``poi_csv``: the POIs (x, y, z columns under a
    header); by default a grid at step 20 from 40 voxels inside.
    ``sift_backend``: SIFT3D's ``pyramid_backend`` (default: the class
    default, ``"host"``, as the reference program's SIFT3D(); ``"device"``
    takes the capped device path).  ``ransac_draws`` [4, N, 32]:
    FeatureAffine3D's trial draws (default: its seeded generator's).  ``stats``, a dict, receives the modules' counts,
    SIFT3D's layer and keypoint counts and matched keypoints,
    FeatureAffine3D's codes, the seeded table IC-GN starts from
    (``seeded``), which table writer ran and the table writes' seconds.
    Returns (the result table, the StageTimer)."""
    if workload not in WORKLOADS:
        raise ValueError(f"unknown workload {workload!r}; one of "
                         f"{', '.join(WORKLOADS)}")
    dev = resolve_device(device)
    if out_prefix is None:
        out_prefix = os.path.join(tempfile.gettempdir(), "dvc")
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
        pois = io_table.load_table_3d(ref, device=dev)
        strain = Strain(subregion_radius=30.0, neighbor_number_min=10,
                        device=dev)
        with timer.stage("Strain calculation"):
            pois = strain.compute(pois)
            sync()
        save("save_table_3d", io_table.save_table_3d,
             f"{out_prefix}_strain_r30.csv", pois)
        timer.save_csv(f"{out_prefix}_strain_r30_time.csv", pois.n)
        return pois, timer

    if ref is None:
        ref, tar = synthetic_pair()
        r = 10
        pois = poi_mod.poi_grid_3d((20, 20, 20), 6, 6, 6, 10, device=dev)
    else:
        ref, tar = _volume(ref), _volume(tar)
        r = 30 if workload == "fftcc_icgn1" else 16
        if poi_csv is not None:
            pts = np.genfromtxt(poi_csv, delimiter=",", skip_header=1,
                                dtype=np.float32).reshape(-1, 3)
            pois = poi_mod.new_table_3d(pts[:, 0], pts[:, 1], pts[:, 2],
                                        device=dev)
        else:
            dx, dy, dz = _dims_xyz(ref)
            pois = poi_mod.poi_grid_3d((40, 40, 40), (dx - 80) // 20,
                                       (dy - 80) // 20, (dz - 80) // 20, 20,
                                       device=dev)

    if workload == "fftcc_icgn1":
        fftcc = FFTCC3D(r, r, r, device=dev)
        fftcc.set_images(ref, tar)
        with timer.stage("FFTCC"):
            pois = fftcc.compute(pois)
            sync()
        info["fftcc_stats"] = dict(fftcc.stats)
    else:  # sift_icgn1
        sift = (SIFT3D(device=dev) if sift_backend is None else
                SIFT3D(pyramid_backend=sift_backend, device=dev))
        sift.set_images(ref, tar)
        with timer.stage("SIFT"):
            sift.prepare()
            sift.compute()
            sync()
        info["sift3d_layers"] = [dict(st) for st in sift.layer_stats]
        info["sift3d_stage_ms"] = dict(sift.stage_ms)
        info["keypoints"] = [sift.ref_kp_count, sift.tar_kp_count]
        info["sift_matches"] = (sift.ref_matched_kp, sift.tar_matched_kp)
        fa = FeatureAffine3D(r, r, r, device=dev)
        fa.set_keypoint_pair(sift.ref_matched_kp, sift.tar_matched_kp)
        with timer.stage("FeatureAffine"):
            pois = fa.compute(pois, draws=ransac_draws)
            sync()
        codes = pois.r[:, poi_mod.R3_ZNCC].cpu().numpy()
        info["feature_affine3d_codes"] = {
            str(c): int((codes == c).sum()) for c in (0.0, -1.0, -2.0)}

    info["seeded"] = pois
    icgn = ICGN3D1(r, r, r, 0.001, 10, device=dev)
    icgn.set_images(ref, tar)
    with timer.stage("ICGN"):
        icgn.prepare()
        pois = icgn.compute(pois)
        sync()
    info["icgn_stats"] = dict(icgn.stats)

    save("save_table_3d", io_table.save_table_3d,
         f"{out_prefix}_{workload}.csv", pois)
    save("save_matrix_bin_3d", io_table.save_matrix_bin_3d,
         f"{out_prefix}_{workload}.bin", pois, _dims_xyz(ref))
    timer.save_csv(f"{out_prefix}_{workload}_time.csv", pois.n)
    return pois, timer


if __name__ == "__main__":
    args = sys.argv[1:]
    wl, rest = (args[0], args[1:]) if args else ("fftcc_icgn1", [])
    if wl == "strain":
        if not rest:
            sys.exit(__doc__)
        pois, timer = run(wl, rest[0], out_prefix=(rest[1:2] or [None])[0])
    else:
        pois, timer = run(wl, *rest)
    z = pois.zncc.cpu().numpy()
    print(timer.report())
    print(f"converged {(z > 0.9).mean():.3f}  "
          f"u med {float(pois.u.median()):.3f}  "
          f"v med {float(pois.v.median()):.3f}  "
          f"w med {float(pois.w.median()):.3f}")
