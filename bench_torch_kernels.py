#!/usr/bin/env python3
"""The four kernels of the PyTorch/CUDA port against other builds of their
sources, on the same inputs on one GPU.

Run from the root of the repository:

    python3 bench_torch_kernels.py [--build TAG=DIR ...] [--kernels K,...]

It builds ``csrc/{gather2d,lattice2d,lattice3d,desc3d}.cu`` as the package
does ("new") and, for each ``--build``, whichever of those files ``DIR``
holds (for example an earlier commit's ``opencorr_tpu_torch/csrc``
unpacked with ``git show``, or an edited copy in a gitignored directory);
``--kernels`` picks some of the four.  Then, on one set of inputs per
case, each build's C entry point is timed in turns (the other builds, new,
new, the other builds in reverse), and every build is held to the plain
PyTorch version:

* kernels 1 and 2 at every launch shape of ``chip_smoke.py`` phase 2
  (``kernel12_cases``), on phase 2's random inputs (kernel 2 also on
  offsets from a smooth affine warp per POI, "path"), timed as device
  time: launches enqueued behind a sleep kernel so that none waits on the
  host (``chip_smoke.launch_timing``).  Kernel 1 ``==`` the plain version;
  kernel 2 bit-equal across builds, within phase 2's gate of the plain
  version and exactly 0 out of range.  Beside them, the host us of a
  call of each build's C entry point and of a wrapper call: the
  package's ``ops/gather2d.py`` / ``ops/lattice2d.py`` and, where ``DIR``
  holds a file of that name, that wrapper (loaded into the package beside
  its own, launching the package's build);

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
line.  Kernels 3 and 4 are timed with CUDA events around a batch of
launches (their launches take milliseconds).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
KERNELS = ("gather2d", "lattice2d", "lattice3d", "desc3d")
# a subset radius that neither driven path uses, timed for kernel 3
OTHER_R = 20


def build_all(others, kernels):
    """{(kernel, build): typed C entry point}, one nvcc each, in parallel.
    ``others`` maps a build's tag to a directory of sources; a header
    that the directory lacks is taken from the package's ``csrc``."""
    from opencorr_tpu_torch.ops import (_kernels, desc3d, gather2d,
                                        lattice2d, lattice3d)

    bind = {"gather2d": gather2d.bind, "lattice2d": lattice2d.bind,
            "lattice3d": lattice3d.bind, "desc3d": desc3d.bind}
    _kernels.build(kernels)
    out = {(k, "new"): bind[k](_kernels.load(k)) for k in kernels}
    bdir = _kernels.BUILD_DIR / "bench"
    bdir.mkdir(parents=True, exist_ok=True)
    procs = []
    for tag, src_dir in others.items():
        for k in kernels:
            src = Path(src_dir) / f"{k}.cu"
            if not src.exists():
                continue
            so = bdir / f"lib{k}-{tag}.so"
            procs.append((k, tag, so, subprocess.Popen(
                [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I",
                 str(_kernels.CSRC), "-o", str(so), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for k, tag, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"build {k} {tag} failed:\n{log[-3000:]}")
        for ln in log.splitlines():
            if "registers" in ln:
                print(f"build {k} {tag}: {ln.strip()}", flush=True)
        out[(k, tag)] = bind[k](ctypes.CDLL(str(so)))
    for k in kernels:
        for ln in _kernels.BUILD_LOGS.get(k, "").splitlines():
            if "registers" in ln:
                print(f"build {k} new: {ln.strip()}", flush=True)
    return out


def in_turns(torch, cs, fns, reps, device=False):
    """Mean ms a launch of each build: the other builds, new, new, the
    other builds in reverse.  CUDA events around a batch of launches, or,
    with ``device``, around launches enqueued behind a sleep kernel."""
    others = [b for b in fns if b != "new"]
    ms = {}
    for b in others + ["new", "new"] + others[::-1]:
        t = (cs.launch_timing(torch, fns[b], reps)[0] if device
             else cs.cuda_ms(torch, fns[b], reps))
        ms.setdefault(b, []).append(t)
    return {b: sum(v) / len(v) for b, v in ms.items()}


def load_wrappers(others, name, wrapper):
    """{tag: wrapper}: the function ``wrapper`` of the package's
    ``ops/<name>.py`` as "new" and of each ``--build`` directory's
    ``<name>.py``, loaded into the package under its own name so that its
    relative imports resolve (its launches take the package's build)."""
    import importlib

    mod = importlib.import_module(f"opencorr_tpu_torch.ops.{name}")
    out = {"new": getattr(mod, wrapper)}
    for tag, src_dir in others.items():
        path = Path(src_dir) / f"{name}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"opencorr_tpu_torch.ops._{tag}_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            fn = getattr(mod, wrapper)
            # an earlier wrapper may predate the per-shape launch count
            fn.shapes = getattr(fn, "shapes", None)
            out[tag] = fn
    return out


def host_us(torch, cs, calls, reps=200):
    """Host us a call of each of ``calls``, enqueued behind a sleep
    kernel."""
    return {t: cs.launch_timing(torch, c, reps)[1] for t, c in calls.items()}


def yardsticks(torch, cs, nbytes, out_bytes, reps):
    """Device ms of two PyTorch calls that move the kernel's bytes: fill_
    of its output (writes only) and copy_ of nbytes / 2 (as much read as
    written), each as a share of the data sheet's rate, for what a trivial
    kernel reaches on this card."""
    dst = torch.empty(out_bytes // 4, device="cuda")
    half = torch.empty(nbytes // 8, device="cuda")
    src = torch.ones_like(half)
    out = {}
    for name, call, moved in (
            ("fill", lambda: dst.fill_(1.0), out_bytes),
            ("copy", lambda: half.copy_(src), nbytes // 8 * 8)):
        ms = cs.launch_timing(torch, call, reps)[0]
        out[name] = dict(ms=ms, share=moved / cs.HBM_BYTES_PER_S * 1e3 / ms)
    return out


def bench_gather(torch, cs, fns, wrappers, img, n, sh, sw, rng, reps):
    from opencorr_tpu_torch.ops import gather2d

    h, w = img.shape
    y0, x0, _ = cs.gather_corners(torch, img, n, sh, sw, rng)
    want = gather2d.gather_windows_2d_plain(img, y0, x0, sh=sh, sw=sw)
    out = torch.empty_like(want)
    args = gather2d.c_args(img, y0, x0, out, sh, sw)
    calls, equal = {}, {}
    for b, fn in fns.items():
        calls[b] = (lambda fn=fn: cs.check(fn(*args) == 0, "gather launch"))
        out.fill_(float("nan"))
        calls[b]()
        torch.cuda.synchronize()
        equal[b] = bool(torch.equal(out, want))
        if not equal[b]:
            raise AssertionError(f"gather2d {b} at {n}x{sh}x{sw} is not == "
                                 "the plain version")
    nbytes = (h * w + n * sh * sw + 2 * n) * 4
    ms = in_turns(torch, cs, calls, reps, device=True)
    bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
    rec = dict(kernel="gather_windows_2d", shape=[n, sh, sw],
               image=[h, w], equal=equal, ms=ms, bytes=nbytes, bound_ms=bound,
               share_of_bound={b: bound / t for b, t in ms.items()},
               yardsticks=yardsticks(torch, cs, nbytes, n * sh * sw * 4,
                                     reps),
               entry_host_us=host_us(torch, cs, calls),
               wrapper_host_us=host_us(torch, cs, {
                   t: (lambda f=f: f(img, y0, x0, sh=sh, sw=sw))
                   for t, f in wrappers.items()}))
    print(json.dumps(rec), flush=True)
    return rec


def bench_lattice2d(torch, cs, fns, wrappers, n, s, d, exact, kind, rng,
                    reps):
    from opencorr_tpu_torch.ops import lattice2d

    args = cs.lattice2d_inputs(torch, "cuda", n, s, d, rng, kind)
    eblk, dy, dx = args[:3]
    want = lattice2d.lattice_eval_2d_plain(*args, d_wobble=d)
    oor = (dy < 0) | (dy > 2 * d) | (dx < 0) | (dx > 2 * d)
    tol = 0.0 if exact else 1e-6 * float(eblk.abs().max())
    out = torch.empty_like(want)
    cargs = lattice2d.c_args(*args, out, d)
    calls, err, got = {}, {}, {}
    for b, fn in fns.items():
        calls[b] = (lambda fn=fn: cs.check(fn(*cargs) == 0,
                                           "lattice2d launch"))
        out.fill_(float("nan"))
        calls[b]()
        torch.cuda.synchronize()
        got[b] = out.clone()
        err[b] = float((out - want).abs().max())
        if not (err[b] <= tol and bool((out[oor] == 0).all())):
            raise AssertionError(f"lattice2d {b} at D={d} {n}x{s}x{s} "
                                 f"({kind}): max|err| {err[b]} > {tol}")
    equal = {b: bool(torch.equal(g, got["new"])) for b, g in got.items()}
    if not all(equal.values()):
        raise AssertionError(f"lattice2d at D={d} {n}x{s}x{s} ({kind}): "
                             f"builds differ {equal}")
    del got
    nbytes = (eblk.numel() + 5 * n * s * s) * 4
    flops = int((~oor).sum()) * cs.LATTICE_FLOPS
    bound = max(nbytes / cs.HBM_BYTES_PER_S, flops / cs.F32_FLOP_PER_S) * 1e3
    ms = in_turns(torch, cs, calls, reps, device=True)
    rec = dict(kernel="lattice_eval_2d", shape=[n, s, s], d_wobble=d,
               offsets=kind, out_of_range=int(oor.sum()), max_abs_err=err,
               tolerance=tol, equal_to_new=equal, ms=ms, bytes=nbytes,
               flops=flops, bound_ms=bound,
               share_of_bound={b: bound / t for b, t in ms.items()},
               yardsticks=yardsticks(torch, cs, nbytes, n * s * s * 4, reps),
               entry_host_us=host_us(torch, cs, calls),
               wrapper_host_us=host_us(torch, cs, {
                   t: (lambda f=f: f(*args, d_wobble=d))
                   for t, f in wrappers.items()}))
    print(json.dumps(rec), flush=True)
    return rec


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
                        "sources of some of the kernels (and wrappers of "
                        "kernels 1 and 2)")
    parser.add_argument("--kernels", default=",".join(KERNELS),
                        help="the kernels to run, of " + ",".join(KERNELS))
    args = parser.parse_args()
    others = dict(b.split("=", 1) for b in args.build)
    if "new" in others:
        parser.error("the tag 'new' names the package's own build")
    kernels = tuple(k for k in KERNELS if k in args.kernels.split(","))
    if set(args.kernels.split(",")) - set(KERNELS):
        parser.error(f"--kernels: not all of {args.kernels} are kernels")
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
    fns = build_all(others, kernels)
    by = lambda kern: {b: f for (k, b), f in fns.items() if k == kern}
    gen = torch.Generator(device="cuda").manual_seed(7)
    rng = np.random.default_rng(7)
    gathers, lattices = cs.kernel12_cases(ot)
    if "gather2d" in kernels:
        main_img = torch.from_numpy(cs.speckle_pair(seed=0)[0].astype(
            np.float32)).cuda()
        images = cs.case_images(torch, main_img, rng)
        wrappers = load_wrappers(others, "gather2d", "gather_windows_2d")
        for n, sh, sw, src in gathers:
            bench_gather(torch, cs, by("gather2d"), wrappers, images[src], n,
                         sh, sw, rng, 50)
    if "lattice2d" in kernels:
        wrappers = load_wrappers(others, "lattice2d", "lattice_eval_2d")
        for n, s, d, exact in lattices:
            for kind in ("random", "path"):
                bench_lattice2d(torch, cs, by("lattice2d"), wrappers, n, s,
                                d, exact, kind, rng, 50)
                torch.cuda.empty_cache()

    if "lattice3d" in kernels:
        n_other = ot.ICGN3D1(OTHER_R, OTHER_R, OTHER_R,
                             device="cuda").auto_chunk(
            int(np.prod(cs.TORUS_GRID[1:4])))
        cases = [(n, s, kind) for n, s in cs.lattice3d_chunks(torch)
                 for kind in ("path", "random")]
        for n, s, kind in cases + [(n_other, 2 * OTHER_R + 1, "path")]:
            bench_lattice(torch, cs, by("lattice3d"), n, s, 1, kind, gen, 10)
            torch.cuda.empty_cache()

    if "desc3d" in kernels:
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
