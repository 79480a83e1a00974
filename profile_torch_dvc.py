#!/usr/bin/env python3
"""Device-time breakdown of the port's DVC, stereo and self-adaptive 2D
paths on one GPU.

Run from the root of the repository:

    python3 profile_torch_dvc.py              # FFTCC3D -> ICGN3D1 -> Strain
    python3 profile_torch_dvc.py --path sift  # SIFT3D -> FA3D -> ICGN3D1
    python3 profile_torch_dvc.py --path stereo  # the stereo example's run
    python3 profile_torch_dvc.py --path self_adaptive  # dic_2d's workload

It builds the CUDA kernels and makes ``chip_smoke.py``'s volume pair.  The
default path warms up on 512 POIs, then runs FFTCC3D(30) ->
ICGN3D1(30, 0.001, 10) -> Strain(30, 10) on the 5,733 POIs of the al_foam4
grid of the 700x100x100 speckle pair.  ``--path sift`` warms up on a
sub-volume, then runs SIFT3D() -> FeatureAffine3D(16, 16, 16) ->
ICGN3D1(16, 16, 16, 0.001, 10) on the 78,246 POIs of the 568x288x940
Torus-size pair.  ``--path stereo`` warms up on a crop, then runs
``examples/stereo_3d_dic_epipolar_sift.run`` on ``chip_smoke.py``'s
1920x1200 stereo scene (10,000 POIs), whose phases open their own ranges.
``--path self_adaptive`` warms up on a small grid, then runs
``examples/dic_2d.run("self_adaptive")`` on ``chip_smoke.py``'s utn-size
pair (38,400 POIs), whose StageTimer opens a range per stage.
Each runs under ``torch.profiler`` and prints, per
stage, the host wall time, the device time of the kernels launched in it
(their sum over the wall time is the device's busy share), the kernels
that took the most of it and the port's own kernels, as JSON lines, the
card's name and power limit before the last line.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time


# the stage ranges: this script's own, and the examples' StageTimer spans
RANGES = ("stage:", "oc:")
# the port's hand-written kernels, by the names of their __global__
# functions: reported in every stage whether or not they are in its top
PORT_KERNELS = ("gather_windows_kernel", "lattice2d_kernel",
                "lattice3d_kernel", "desc3d_kernel")


def _dvc_path(torch, cs, ot):
    """FFTCC3D(30) -> ICGN3D1(30) -> Strain(30, 10) on the al_foam4 grid."""
    ref, tar = (ot.Image3D.from_array(v) for v in cs.speckle_volumes(seed=2))
    pois = ot.poi_grid_3d((35, 35, 60), 7, 7, 117, 5)
    cs.run_dvc(torch, ot, ref, tar, pois.map(lambda a: a[:512]), "cuda")
    r = cs.DVC_R
    fftcc = ot.FFTCC3D(r, r, r)
    fftcc.set_images(ref, tar)
    icgn = ot.ICGN3D1(r, r, r, 0.001, 10)
    icgn.set_images(ref, tar)
    icgn.prepare()
    strain = ot.Strain(r, 10)
    run = (("fftcc3d", fftcc.compute), ("icgn3d1", icgn.compute),
           ("strain", strain.compute))
    return run, pois, lambda: {"icgn_stats": dict(icgn.stats),
                               "fftcc_stats": dict(fftcc.stats)}


def _sift_path(torch, cs, ot):
    """SIFT3D -> FeatureAffine3D(16) -> ICGN3D1(16) on the Torus grid."""
    ref, tar = cs.sift_pair(torch, cs.TORUS_SHAPE, seed=3, device="cuda")
    pois = ot.poi_grid_3d(*cs.TORUS_GRID)
    sub = (slice(0, 160), slice(0, 128), slice(0, 192))
    cs.run_sift_slice(torch, ot, ref[sub].contiguous(), tar[sub].contiguous(),
                      ot.poi_grid_3d((40, 40, 40), 4, 2, 3, 30), "cuda")
    r = cs.TORUS_R
    sift = ot.SIFT3D()
    sift.set_images(ref, tar)
    fa = ot.FeatureAffine3D(r, r, r)
    icgn = ot.ICGN3D1(r, r, r, 0.001, 10)
    icgn.set_images(ref, tar)
    icgn.prepare()

    def match(table):
        sift.compute()
        fa.set_keypoint_pair(sift.ref_matched_kp, sift.tar_matched_kp)
        fa.prepare()
        return table

    run = (("sift3d", match), ("feature_affine3d", fa.compute),
           ("icgn3d1", icgn.compute))
    return run, pois, lambda: {"icgn_stats": dict(icgn.stats),
                               "keypoints": [sift.ref_kp_count,
                                             sift.tar_kp_count],
                               "matches": len(sift.ref_matched_kp)}


def _stereo_path(torch, cs, ot):
    """The stereo example's run at GT4's size on chip_smoke.py's scene; its
    phases are the ranges ``oc:<name>`` its StageTimer opens."""
    from opencorr_tpu_torch.examples import stereo_3d_dic_epipolar_sift as ex

    views, pts, _, _ = cs.stereo_inputs()
    crops, local, offset = cs.stereo_crop(views, pts)
    ex.run(*[ot.Image2D.from_array(c) for c in crops], local,
           *cs.stereo_calibrations(ot, "cuda", offset))
    imgs = [ot.Image2D.from_array(v) for v in views]
    info = {}

    def stereo(table):
        out, times = ex.run(*imgs, pts, *cs.stereo_calibrations(ot, "cuda"),
                            stats=info)
        info["stage_ms"] = {k: v * 1e3 for k, v in times.items()}
        return out

    return (("stereo", stereo),), ot.new_table_2d(pts[:, 0], pts[:, 1]), \
        lambda: {k: v for k, v in info.items() if k != "sift2d_octaves"}


def _self_adaptive_path(torch, cs, ot):
    """The planar suite's self_adaptive workload (SIFT2D ->
    FeatureAffine2D -> self-adaptive ICGN2D1(30) -> Strain(25, 10)) at the
    utn size on chip_smoke.py's pair; its stages are its StageTimer's
    ranges."""
    import tempfile

    from opencorr_tpu_torch.examples import dic_2d

    ref, tar, center = cs.speckle_pair(seed=0)
    uref, utar, _ = cs.dic2d_inputs(ref, tar, center)["utn"]
    prefix = os.path.join(tempfile.mkdtemp(), "dic2d")
    dic_2d.run("self_adaptive", uref, utar, prefix, "cuda",
               grid=((50, 50), 20, 20, 5))
    info = {}

    def adaptive(table):
        out, timer = dic_2d.run("self_adaptive", uref, utar, prefix, "cuda",
                                stats=info)
        info["stage_ms"] = {n: s * 1e3 for n, s in zip(timer.names,
                                                        timer.seconds)}
        return out

    return (("self_adaptive", adaptive),), \
        ot.poi_grid_2d(*dic_2d.GRIDS["self_adaptive"]), \
        lambda: {k: v for k, v in info.items() if k != "sift2d_octaves"}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--path", choices=("dvc", "sift", "stereo",
                                           "self_adaptive"),
                        default="dvc")
    args = parser.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("profile_torch_dvc: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as cs
    import opencorr_tpu_torch as ot
    from opencorr_tpu_torch.ops import _kernels

    if args.path == "sift":
        _kernels.build(["lattice3d", "desc3d"])
        run, pois, stats = _sift_path(torch, cs, ot)
    elif args.path == "stereo":
        _kernels.build(["gather2d", "lattice2d"])
        run, pois, stats = _stereo_path(torch, cs, ot)
    elif args.path == "self_adaptive":
        _kernels.build(["gather2d", "lattice2d"])
        run, pois, stats = _self_adaptive_path(torch, cs, ot)
    else:
        _kernels.build(["lattice3d"])
        run, pois, stats = _dvc_path(torch, cs, ot)
    torch.cuda.synchronize()

    stages = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        table = pois
        for name, fn in run:
            t0 = time.perf_counter()
            with record_function(f"stage:{name}"):
                table = fn(table)
                torch.cuda.synchronize()
            stages[name] = (time.perf_counter() - t0) * 1e3

    info = stats()
    stages.update(info.pop("stage_ms", {}))  # ranges a stage opened itself
    events = prof.events()
    on_device = lambda e: str(e.device_type).endswith("CUDA")
    # the stage ranges on the host, and the kernels (the device events that
    # are not the ranges' own device-side annotations)
    ranges = {e.name.split(":", 1)[1]: e for e in events
              if e.name.startswith(RANGES) and not on_device(e)}
    kernels = [e for e in events
               if on_device(e) and not e.name.startswith(RANGES)]
    out = {}
    for name, wall in stages.items():
        t0, t1 = ranges[name].time_range.start, ranges[name].time_range.end
        mine = [k for k in kernels if t0 <= k.time_range.start <= t1]
        busy = sum(k.time_range.elapsed_us() for k in mine) / 1e3
        by_name = collections.defaultdict(lambda: [0.0, 0])
        for k in mine:
            by_name[k.name][0] += k.time_range.elapsed_us() / 1e3
            by_name[k.name][1] += 1
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        out[name] = dict(
            wall_ms=wall, device_ms=busy,
            busy_share=busy / wall if wall else None, kernels=len(mine),
            top=[dict(name=k[:120], device_ms=v[0], launches=v[1],
                      share=v[0] / busy if busy else None)
                 for k, v in top],
            port_kernels={k: dict(device_ms=v[0], launches=v[1])
                          for k, v in by_name.items()
                          if any(p in k for p in PORT_KERNELS)})
    for name, rec in out.items():
        print(json.dumps({"stage": name, "pois": pois.n, **rec}), flush=True)
    print(json.dumps(info, default=lambda o: o.tolist()), flush=True)
    print(cs.card_line(), flush=True)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
