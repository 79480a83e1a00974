#!/usr/bin/env python3
"""Kernels 3 and 4 of the PyTorch/CUDA port against other builds of their
sources, on the same inputs on one GPU.

Run from the root of the repository:

    python3 bench_torch_kernels.py [--build TAG=DIR ...]

It builds ``csrc/lattice3d.cu`` and ``csrc/desc3d.cu`` as the package does
("new") and, for each ``--build``, whichever of the two files ``DIR`` holds
(for example an earlier commit's ``opencorr_tpu_torch/csrc`` unpacked with
``git show``, or an edited copy in a gitignored directory).  Then, on one
set of inputs per case, each build's C entry point is timed with CUDA
events in turns (the other builds, new, new, the other builds in reverse),
and every build is held to the plain PyTorch version:

* kernel 3 at one DVC chunk (ICGN3D1's auto chunk of the 5,733-POI queue
  at r=30, 441 x 61^3 on an 80 GB card), one SIFT-path chunk (of the
  78,246-POI queue at r=16, 2,795 x 33^3) and, at a radius no driven path
  uses, one chunk of the same queue at r=20, with offsets and fractions
  from a smooth affine warp per POI, as ICGN3D1 makes them ("path"), and
  at the two paths' chunks also with random ones, 2% out of range
  ("random"): bit-equal (``==``), out-of-range samples exactly 0;
* kernel 4 at the Torus path's octave-0 counts and crops (4,689 / 12,187 /
  13,808 keypoints at 23 / 29 / 36) on a 96x100x120 volume Gaussian-blurred
  at the layer's sigma ("blurred") and on white noise ("noise"): within
  1e-5 x max|S| on every keypoint.

One JSON line per case; the card's name and power limit before the last
line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
KERNELS = ("lattice3d", "desc3d")
# a subset radius that neither driven path uses, timed for kernel 3
OTHER_R = 20


def build_all(others):
    """{(kernel, build): typed C entry point}, one nvcc each, in parallel.
    ``others`` maps a build's tag to a directory of sources."""
    from opencorr_tpu_torch.ops import _kernels, desc3d, lattice3d

    bind = {"lattice3d": lattice3d.bind, "desc3d": desc3d.bind}
    _kernels.build(KERNELS)
    out = {(k, "new"): bind[k](_kernels.load(k)) for k in KERNELS}
    bdir = _kernels.BUILD_DIR / "bench"
    bdir.mkdir(parents=True, exist_ok=True)
    procs = []
    for tag, src_dir in others.items():
        for k in KERNELS:
            src = Path(src_dir) / f"{k}.cu"
            if not src.exists():
                continue
            so = bdir / f"lib{k}-{tag}.so"
            procs.append((k, tag, so, subprocess.Popen(
                [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(so),
                 str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for k, tag, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"build {k} {tag} failed:\n{log[-3000:]}")
        for ln in log.splitlines():
            if "registers" in ln:
                print(f"build {k} {tag}: {ln.strip()}", flush=True)
        out[(k, tag)] = bind[k](ctypes.CDLL(str(so)))
    for k in KERNELS:
        for ln in _kernels.BUILD_LOGS.get(k, "").splitlines():
            if "registers" in ln:
                print(f"build {k} new: {ln.strip()}", flush=True)
    return out


def in_turns(torch, cs, fns, reps):
    """Mean ms of each build: the other builds, new, new, the other builds
    in reverse."""
    others = [b for b in fns if b != "new"]
    ms = {}
    for b in others + ["new", "new"] + others[::-1]:
        ms.setdefault(b, []).append(cs.cuda_ms(torch, fns[b], reps))
    return {b: sum(v) / len(v) for b, v in ms.items()}


def bench_lattice(torch, cs, fns, n, s, d, kind, gen, reps):
    from opencorr_tpu_torch.ops import lattice3d

    eblk, offs, fracs = cs.lattice3d_inputs(torch, n, s, d, kind, gen)
    want = lattice3d.lattice_eval_3d_plain(eblk, *offs, *fracs, d_wobble=d)
    out = torch.empty_like(want)
    oor = torch.zeros_like(offs[0], dtype=torch.bool)
    for a in offs:
        oor |= (a < 0) | (a > 2 * d)
    calls, equal = {}, {}
    for b, fn in fns.items():
        args = lattice3d.c_args(eblk, *offs, *fracs, out, d)
        calls[b] = (lambda fn=fn, args=args: fn(*args))
        out.fill_(float("nan"))
        if calls[b]() != 0:
            raise RuntimeError(f"lattice3d {b}: launch failed")
        torch.cuda.synchronize()
        equal[b] = bool(torch.equal(out, want))
        if not equal[b] or not bool((out[oor] == 0).all()):
            raise AssertionError(f"lattice3d {b} at {n}x{s}^3 ({kind}) is "
                                 "not bit-equal to the plain version")
    nbytes = (eblk.numel() + 7 * n * s ** 3) * 4
    ms = in_turns(torch, cs, calls, reps)
    rec = dict(kernel="lattice_eval_3d", shape=[n, s, s, s], d_wobble=d,
               offsets=kind, out_of_range=int(oor.sum()), bit_equal=equal,
               ms=ms, bytes=nbytes, bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3)
    print(json.dumps(rec), flush=True)
    return rec


def bench_desc(torch, cs, fns, vol, crop, scale, k, kind, rng, reps):
    from opencorr_tpu_torch.ops import desc3d

    dev = vol.device
    shape = tuple(vol.shape)
    units = (1.0, 1.0, 1.0)
    coords = [rng.integers(c + 1, dd - c - 1, k) for c, dd in zip(crop, shape)]
    zi, yi, xi = (torch.from_numpy(c.astype(np.int32)).to(dev)
                  for c in coords)
    rot = torch.from_numpy(cs.random_rotations(rng, k)).to(dev)
    starts, tab = desc3d.prepare_tables(shape, xi, yi, zi, crop=crop,
                                        scale=scale, unit_xyz=units)
    kw = dict(crop=crop, scale=scale, unit_xyz=units)
    counts = {}
    want = torch.cat([desc3d.descriptor_hist_plain(
        vol, starts[lo:lo + 1024], tab[lo:lo + 1024], rot[lo:lo + 1024],
        counts=counts, **kw) for lo in range(0, k, 1024)])
    tol = 1e-5 * float(want.abs().max())
    out = torch.zeros_like(want)
    args = desc3d.c_args(vol, starts, tab, rot, out, **kw)
    calls, err = {}, {}
    for b, fn in fns.items():
        calls[b] = (lambda fn=fn: fn(*args[:-1]))
        out.zero_()
        if calls[b]() != 0:
            raise RuntimeError(f"desc3d {b}: launch failed")
        torch.cuda.synchronize()
        err[b] = float((out - want).abs().max())
        if not err[b] <= tol:
            raise AssertionError(f"desc3d {b}, {k} keypoints at crop {crop} "
                                 f"({kind}): max|err| {err[b]} > {tol}")
    flops = (counts["sphere_voxels"] * desc3d.FLOPS_SPHERE_VOXEL
             + counts["live_voxels"] * desc3d.FLOPS_LIVE_VOXEL)
    ms = in_turns(torch, cs, calls, reps)
    rec = dict(kernel="descriptor_hist", shape=[k] + [2 * c + 1 for c in crop],
               volume=kind, max_abs_err=err, tolerance=tol, ms=ms,
               sphere_voxels=counts["sphere_voxels"],
               live_voxels=counts["live_voxels"], flops=flops,
               bound_ms=flops / cs.F32_FLOP_PER_S * 1e3)
    print(json.dumps(rec), flush=True)
    return rec


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--build", action="append", default=[],
                        metavar="TAG=DIR", help="a directory holding other "
                        "sources of lattice3d.cu and/or desc3d.cu")
    args = parser.parse_args()
    others = dict(b.split("=", 1) for b in args.build)
    if "new" in others:
        parser.error("the tag 'new' names the package's own build")
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    import opencorr_tpu_torch as ot
    from opencorr_tpu_torch.ops import sift3d
    from scipy.ndimage import gaussian_filter

    card = cs.card_line()
    print(card, flush=True)
    fns = build_all(others)
    by = lambda kern: {b: f for (k, b), f in fns.items() if k == kern}
    gen = torch.Generator(device="cuda").manual_seed(7)
    rng = np.random.default_rng(7)
    n_other = ot.ICGN3D1(OTHER_R, OTHER_R, OTHER_R, device="cuda").auto_chunk(
        int(np.prod(cs.TORUS_GRID[1:4])))
    cases = [(n, s, kind) for n, s in cs.lattice3d_chunks(torch)
             for kind in ("path", "random")]
    for n, s, kind in cases + [(n_other, 2 * OTHER_R + 1, "path")]:
        bench_lattice(torch, cs, by("lattice3d"), n, s, 1, kind, gen, 10)
        torch.cuda.empty_cache()

    layers = ot.SIFT3D(device="cuda")._plan_layers(cs.TORUS_SHAPE)[1:4]
    shape = (96, 100, 120)
    noise = np.float32(128 + 40 * rng.standard_normal(shape))
    for lay, k in zip(layers, cs.TORUS_KEPT):
        crop = sift3d._sphere_crop(64, lay.scale, (1.0, 1.0, 1.0))
        for kind in ("blurred", "noise"):
            v = gaussian_filter(noise, lay.scale) if kind == "blurred" \
                else noise
            vol = torch.from_numpy(np.float32(v)).cuda()
            bench_desc(torch, cs, by("desc3d"), vol, crop, lay.scale, k,
                       kind, rng, 3)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    os.chdir(HERE)
    sys.exit(main())
