#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``opencorr_tpu_torch``) on one GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package.  Phases, in order
(any failure raises and the script exits non-zero without a result line):

1. Identify the card (``nvidia-smi`` name and power limit) and build the
   three CUDA kernels from ``opencorr_tpu_torch/csrc`` (one ``nvcc`` each,
   all started together).
2. Each kernel against its plain PyTorch version on the card at the main
   paths' shapes: the window gather bit-exact at 30k x 32x32, 33x33 and
   40x40 and 940 x 48x48 with corners that need clamping; the 2D lattice
   eval at D=2 (30k POIs) and D=6 (940 POIs) and the 3D lattice eval at
   D=1 (441 x 61^3) within 1e-6 x max|eblk|, and exactly 0 for
   out-of-range offsets.  Kernel, plain and library times.
3. The main path on ``cuda``: FFTCC2D(16,16) -> ICGN2D1(16,16,0.001,10) ->
   Strain(20,5) on ``poi_grid_2d((30,30),100,300,2)`` (30,000 POIs) of a
   900x280 8-bit speckle pair whose target is the reference under a known
   sub-pixel translation plus 0.5% strain, then ``save_table_2d``.  Launch
   counters are zeroed just before the timed run (after one warm-up run)
   and read just after it.  Checks convergence and recovered displacement
   and strain against the imposed field.
4. The same modules on ``cuda`` and on ``cpu`` (the plain versions) on a
   2,000-POI subset, with every 8th seed displaced by 3 px so that the
   IC-GN windowed eval takes its D=6 correction branch: FFTCC u/v equal,
   IC-GN codes equal, u/v within 1e-3 px.
5. The DVC path on ``cuda``: FFTCC3D(30) -> ICGN3D1(30, 0.001, 10) ->
   Strain(30, 10) on ``poi_grid_3d((35,35,60),7,7,117,5)`` (5,733 POIs, the
   al_foam4 golden table's grid) of a 700x100x100 8-bit speckle volume pair
   whose target is the reference under u=0.4, v=-0.3 and w=0.6 plus 0.5%
   strain along z, then ``save_table_3d`` and ``save_matrix_bin_3d``.
   Counters zeroed just before the timed run (after a 512-POI warm-up) and
   read just after.  Checks convergence, the recovered field and ezz.
6. The DVC modules on ``cuda`` and on ``cpu`` on 64 POIs at r=16, every
   8th seed given a 0.2 z strain so that IC-GN takes its whole-chunk exact
   fallback: FFTCC u/v/w equal, codes equal, u/v/w within 1e-3 voxel.
7. JSON lines: per-kernel records, the stage times, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# The main path's image pair: bench.py's synthetic size; translation and
# strain imposed on the target.
H, W = 900, 280
SHIFT_X, SHIFT_Y = 1.37, -0.62
STRAIN = 0.005
# Lattice eval flops per in-range sample: 8 cubic weights (3 mul + 3 add
# each) and 16 taps (2 mul + 1 add each).
LATTICE_FLOPS = 8 * 6 + 16 * 3
# 3D lattice eval flops per in-range sample: 12 basis values (21 flops per
# axis), 16 yz products, and 64 taps (2 mul + 1 add each).
LATTICE3D_FLOPS = 3 * 21 + 16 + 64 * 3
# The DVC path: al_foam4's volume size [z, y, x], the golden table's POI
# grid, r=30, and the field imposed on the target.
DVC_SHAPE = (700, 100, 100)
DVC_R = 30
DVC_UVW = (0.4, -0.3, 0.6)
DVC_STRAIN = 0.005
DVC_CZ = (DVC_SHAPE[0] - 1) / 2.0


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` launches, CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def speckle_pair(seed: int):
    """900x280 uint8 pair: the target is the reference under a sub-pixel
    translation plus isotropic 0.5% strain about the image center."""
    from scipy.ndimage import gaussian_filter, map_coordinates

    rng = np.random.default_rng(seed)
    pad = 16
    base = gaussian_filter(rng.standard_normal((H + 2 * pad, W + 2 * pad)),
                           1.5)
    # 128 +- 28 gray levels: the darkest pixel stays ~4.5 sigma above 0, so
    # no interpolated sample undershoots below 0 (IC-GN reads a negative
    # sample as the out-of-range sentinel, code -3)
    base = base / base.std() * 28.0 + 128.0
    ref = np.clip(np.round(base[pad:pad + H, pad:pad + W]), 0, 255)
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    # target(x') = reference(X) with x' = X + u(X), u linear in X
    sx = cx + (xx - SHIFT_X - cx) / (1.0 + STRAIN)
    sy = cy + (yy - SHIFT_Y - cy) / (1.0 + STRAIN)
    tar = map_coordinates(base, [sy + pad, sx + pad], order=3,
                          mode="nearest")
    tar = np.clip(np.round(tar), 0, 255)
    return ref.astype(np.uint8), tar.astype(np.uint8), (cx, cy)


def true_uv(x, y, center):
    cx, cy = center
    return SHIFT_X + STRAIN * (x - cx), SHIFT_Y + STRAIN * (y - cy)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def phase_kernels(torch, img, rng, reps):
    """Kernel vs plain version on the card at the main path's shapes."""
    from opencorr_tpu_torch.ops import gather2d, lattice2d

    dev = img.device
    h, w = img.shape
    records = {"gather": [], "lattice": []}
    for n, sh, sw in ((30000, 32, 32), (30000, 33, 33), (30000, 40, 40),
                      (940, 48, 48)):
        y0 = rng.integers(0, h - sh + 1, n)
        x0 = rng.integers(0, w - sw + 1, n)
        bad = rng.uniform(size=n) < 0.1  # corners that need clamping
        y0[bad] = rng.integers(-sh, h + sh, bad.sum())
        x0[bad] = rng.integers(-sw, w + sw, bad.sum())
        y0 = torch.from_numpy(y0.astype(np.int32)).to(dev)
        x0 = torch.from_numpy(x0.astype(np.int32)).to(dev)
        got = gather2d.gather_windows_2d(img, y0, x0, sh=sh, sw=sw)
        want = gather2d.gather_windows_2d_plain(img, y0, x0, sh=sh, sw=sw)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"gather {n}x{sh}x{sw} not bit-exact")

        def library():
            yc = y0.long().clamp(0, h - sh)
            xc = x0.long().clamp(0, w - sw)
            return img.unfold(0, sh, 1).unfold(1, sw, 1)[yc, xc]

        check(torch.equal(library(), want), "gather library call differs")
        nbytes = (h * w + n * sh * sw + 2 * n) * 4
        rec = dict(
            shape=[n, sh, sw], max_abs_err=0.0,
            ms=cuda_ms(torch, lambda: gather2d.gather_windows_2d(
                img, y0, x0, sh=sh, sw=sw), reps),
            plain_ms=cuda_ms(torch, lambda: gather2d.gather_windows_2d_plain(
                img, y0, x0, sh=sh, sw=sw), reps),
            library_ms=cuda_ms(torch, library, reps),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            bytes=nbytes, clamped=int(bad.sum()))
        records["gather"].append(rec)
        log(json.dumps({"kernel": "gather_windows_2d", **rec}))

    for n, d in ((30000, 2), (940, 6)):
        s = 33
        wl = 4 + 2 * d
        eblk = torch.from_numpy(np.round(rng.uniform(
            0, 255, (n, s + wl - 1, s + wl - 1))).astype(np.float32)).to(dev)
        dy = rng.integers(0, 2 * d + 1, (n, s, s))
        dx = rng.integers(0, 2 * d + 1, (n, s, s))
        for a in (dy, dx):
            bad = rng.uniform(size=a.shape) < 0.05
            a[bad] = rng.choice([-1, 2 * d + 1, -9, 40], bad.sum())
        dy = torch.from_numpy(dy.astype(np.int32)).to(dev)
        dx = torch.from_numpy(dx.astype(np.int32)).to(dev)
        fy = torch.from_numpy(rng.uniform(0, 1, (n, s, s)).astype(
            np.float32)).to(dev)
        fx = torch.from_numpy(rng.uniform(0, 1, (n, s, s)).astype(
            np.float32)).to(dev)
        args = (eblk, dy, dx, fy, fx)
        got = lattice2d.lattice_eval_2d(*args, d_wobble=d)
        want = lattice2d.lattice_eval_2d_plain(*args, d_wobble=d)
        torch.cuda.synchronize()
        oor = (dy < 0) | (dy > 2 * d) | (dx < 0) | (dx > 2 * d)
        check(bool((got[oor] == 0).all()), f"lattice D={d}: nonzero out of "
              "range")
        err = float((got - want).abs().max())
        tol = 1e-6 * float(eblk.abs().max())
        check(err <= tol, f"lattice D={d}: max|err| {err} > {tol}")
        in_range = int((~oor).sum())
        nbytes = (eblk.numel() + 5 * n * s * s) * 4
        flops = in_range * LATTICE_FLOPS
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        tf = flops / F32_FLOP_PER_S * 1e3
        rec = dict(
            shape=[n, s, s], d_wobble=d, max_abs_err=err, tolerance=tol,
            ms=cuda_ms(torch, lambda: lattice2d.lattice_eval_2d(
                *args, d_wobble=d), reps),
            plain_ms=cuda_ms(torch, lambda: lattice2d.lattice_eval_2d_plain(
                *args, d_wobble=d), reps),
            library_ms=None, bound_ms=max(tb, tf),
            bound_by="bytes" if tb >= tf else "operations",
            bytes=nbytes, flops=flops, out_of_range=int(oor.sum()))
        records["lattice"].append(rec)
        log(json.dumps({"kernel": "lattice_eval_2d", **rec}))
    records["lattice3d"] = [phase_lattice3d(torch, rng, reps)]
    return records


def phase_lattice3d(torch, rng, reps, n=441, s=61, d=1):
    """The 3D lattice kernel against its plain version at the shape of one
    of the DVC path's ICGN3D1 chunks (441 POIs at r=30 on an 80 GB card),
    with out-of-range offsets on every axis."""
    from opencorr_tpu_torch.ops import lattice3d

    dev = torch.device("cuda")
    e = s + 3 + 2 * d
    eblk = torch.from_numpy(np.round(rng.uniform(
        0, 255, (n, e, e, e))).astype(np.float32)).to(dev)
    offs = []
    for far in (-7, 40, 2 * d + 9):  # z, y, x
        a = rng.integers(0, 2 * d + 1, (n, s, s, s), dtype=np.int32)
        bad = rng.uniform(size=a.shape) < 0.02
        a[bad] = rng.choice([-1, 2 * d + 1, far], bad.sum())
        offs.append(torch.from_numpy(a).to(dev))
    fracs = [torch.from_numpy(rng.uniform(0, 1, (n, s, s, s)).astype(
        np.float32)).to(dev) for _ in range(3)]
    args = (eblk, *offs, *fracs)
    got = lattice3d.lattice_eval_3d(*args, d_wobble=d)
    want = lattice3d.lattice_eval_3d_plain(*args, d_wobble=d)
    torch.cuda.synchronize()
    oor = torch.zeros_like(offs[0], dtype=torch.bool)
    for a in offs:
        oor |= (a < 0) | (a > 2 * d)
    check(bool((got[oor] == 0).all()), "lattice3d: nonzero out of range")
    err = float((got - want).abs().max())
    tol = 1e-6 * float(eblk.abs().max())
    check(err <= tol, f"lattice3d: max|err| {err} > {tol}")
    del got, want
    in_range = int((~oor).sum())
    nbytes = (eblk.numel() + 7 * n * s ** 3) * 4
    flops = in_range * LATTICE3D_FLOPS
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOP_PER_S * 1e3
    rec = dict(
        shape=[n, s, s, s], d_wobble=d, max_abs_err=err, tolerance=tol,
        ms=cuda_ms(torch, lambda: lattice3d.lattice_eval_3d(
            *args, d_wobble=d), reps),
        plain_ms=cuda_ms(torch, lambda: lattice3d.lattice_eval_3d_plain(
            *args, d_wobble=d), max(2, reps // 4)),
        library_ms=None,
        library_note="no single PyTorch call computes a tricubic B-spline "
                     "sum over per-POI blocks at per-sample offsets",
        bound_ms=max(tb, tf), bound_by="bytes" if tb >= tf else "operations",
        bytes=nbytes, flops=flops, out_of_range=int(oor.sum()))
    log(json.dumps({"kernel": "lattice_eval_3d", **rec}))
    return rec


def run_path(torch, ot, ref, tar, pois, device, csv_path=None):
    """FFTCC2D -> ICGN2D1 -> Strain on ``pois``; per-stage milliseconds."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    ms = {}
    t0 = time.perf_counter()
    fftcc = ot.FFTCC2D(16, 16, device=device)
    fftcc.set_images(ref, tar)
    icgn = ot.ICGN2D1(16, 16, 0.001, 10, device=device)
    icgn.set_images(ref, tar)
    icgn.prepare()
    strain = ot.Strain(20, 5, device=device)
    sync()
    ms["setup_prepare"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    seeded = fftcc.compute(pois)
    sync()
    ms["fftcc"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    refined = icgn.compute(seeded)
    sync()
    ms["icgn"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out = strain.compute(refined)
    sync()
    ms["strain"] = (time.perf_counter() - t0) * 1e3
    if csv_path is not None:
        t0 = time.perf_counter()
        ot.save_table_2d(csv_path, out)
        ms["save_table"] = (time.perf_counter() - t0) * 1e3
    return seeded, refined, out, ms, dict(icgn.stats)


def phase_main(torch, ot, ref, tar, center, tmpdir):
    from opencorr_tpu_torch.ops import gather2d, lattice2d

    pois = ot.poi_grid_2d((30, 30), 100, 300, 2)
    check(pois.n == 30000, "main grid size")
    csv = os.path.join(tmpdir, "main.csv")
    run_path(torch, ot, ref, tar, pois, "cuda", csv)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    gather2d.gather_windows_2d.launches = 0
    lattice2d.lattice_eval_2d.launches = 0
    seeded, refined, out, ms, stats = run_path(torch, ot, ref, tar, pois,
                                               "cuda", csv)
    launches = {"gather_windows_2d": gather2d.gather_windows_2d.launches,
                "lattice_eval_2d": lattice2d.lattice_eval_2d.launches}
    peak = torch.cuda.max_memory_allocated()
    for k, v in launches.items():
        check(v > 0, f"main path launched {k} no time")

    t = ot.table_to_numpy(out)
    for f, k in (("p", 12), ("r", 6), ("e", 3), ("sr", 2)):
        check(t[f].shape == (30000, k), f"field {f} shape {t[f].shape}")
    zn = t["r"][:, 2]
    conv = zn > 0.9
    ut, vt = true_uv(t["x"].astype(np.float64), t["y"].astype(np.float64),
                     center)
    du = np.abs(t["p"][conv, 0] - ut[conv])
    dv = np.abs(t["p"][conv, 6] - vt[conv])
    exx = t["e"][conv, 0]
    eyy = t["e"][conv, 1]
    with open(csv) as f:
        n_lines = sum(1 for _ in f)
    res = dict(
        pois=30000, converged_frac=float(conv.mean()),
        mean_abs_du=float(du.mean()), mean_abs_dv=float(dv.mean()),
        max_abs_du=float(du.max()), max_abs_dv=float(dv.max()),
        mean_exx=float(exx.mean()), mean_eyy=float(eyy.mean()),
        imposed_strain=STRAIN,
        codes={str(c): int((zn == c).sum()) for c in (-1.0, -3.0, -4.0,
                                                       -5.0)},
        mean_iterations=float(t["r"][conv, 3].mean()),
        icgn_branches=stats, launches=launches, stage_ms=ms,
        peak_mem_mb=peak / 2**20, csv_lines=n_lines)
    log(json.dumps({"main_path": res}))
    check(np.isfinite(t["p"][conv]).all() and np.isfinite(t["e"][conv]).all(),
          "non-finite results on converged POIs")
    check(res["converged_frac"] >= 0.9, f"converged {res['converged_frac']}")
    check(res["mean_abs_du"] < 0.01 and res["mean_abs_dv"] < 0.01,
          f"displacement error {res['mean_abs_du']}, {res['mean_abs_dv']}")
    check(abs(res["mean_exx"] - STRAIN) < 1e-3
          and abs(res["mean_eyy"] - STRAIN) < 1e-3,
          f"strain {res['mean_exx']}, {res['mean_eyy']} vs {STRAIN}")
    check(n_lines == 30001, f"csv lines {n_lines}")
    return res, launches


def phase_cpu_agreement(torch, ot, ref, tar):
    """The modules on cuda and on cpu on one 2,000-POI subset, seeds of
    every 8th POI displaced by 3 px (the D=6 correction branch)."""
    devices = card, host = ("cuda", "cpu")
    full = ot.poi_grid_2d((30, 30), 100, 300, 2, device="cpu")
    keep = np.arange(0, full.n, 15)
    x = full.x.numpy()[keep]
    y = full.y.numpy()[keep]
    res = {}
    seeded = {}
    for dev in devices:
        f = ot.FFTCC2D(16, 16, device=dev)
        f.set_images(ref, tar)
        seeded[dev] = ot.table_to_numpy(
            f.compute(ot.new_table_2d(x, y, device=dev)))
    fu = np.array_equal(seeded[card]["p"], seeded[host]["p"])
    check(fu, "FFTCC u/v differ between cuda and cpu: "
          f"{int((seeded[card]['p'] != seeded[host]['p']).any(1).sum())}")
    p = seeded[host]["p"].copy()
    p[::8, 0] += 3.0
    outs = {}
    for dev in devices:
        s = seeded[host]
        t = ot.table_from_numpy(s["x"], s["y"], p, s["r"], s["e"], s["sr"],
                                device=dev)
        m = ot.ICGN2D1(16, 16, 0.001, 10, device=dev)
        m.set_images(ref, tar)
        m.prepare()
        outs[dev] = ot.table_to_numpy(m.compute(t))
        res[f"branches_{dev}"] = dict(m.stats)
    zc, zp = outs[card]["r"][:, 2], outs[host]["r"][:, 2]
    codes_equal = np.array_equal(np.where(zc < 0, zc, 1), np.where(zp < 0, zp,
                                                                   1))
    both = (zc > 0) & (zp > 0)
    du = np.abs(outs[card]["p"][both][:, [0, 6]]
                - outs[host]["p"][both][:, [0, 6]])
    it_eq = float((outs[card]["r"][:, 3] == outs[host]["r"][:, 3]).mean())
    res.update(pois=len(keep), fftcc_uv_equal=fu, codes_equal=codes_equal,
               max_abs_duv=float(du.max()), iterations_equal_frac=it_eq,
               converged=int(both.sum()))
    log(json.dumps({"cuda_vs_cpu": res}))
    check(codes_equal, "IC-GN codes differ between cuda and cpu")
    check(res["max_abs_duv"] <= 1e-3, f"u/v differ by {res['max_abs_duv']}")
    check(res[f"branches_{card}"].get("correct", 0) > 0,
          "the D=6 correction branch did not run on cuda")
    return res


def speckle_volumes(seed: int):
    """700x100x100 uint8 pair: Gaussian-filtered noise at 128 +- 20 grey
    levels; the target is the reference under the imposed DVC field.

    A volume holds 28 times the voxels of the 2D pair, so its extremes lie
    further out: at +- 28 about 250 voxels fall below 20, and the B-spline
    undershoot near them fails every subset that holds one (-3, 8 of 40
    POIs in a CPU trial).  At +- 20 the darkest voxel is 32."""
    from scipy.ndimage import gaussian_filter, map_coordinates

    rng = np.random.default_rng(seed)
    pad = 8
    shp = tuple(d + 2 * pad for d in DVC_SHAPE)
    base = gaussian_filter(rng.standard_normal(shp, dtype=np.float32), 1.5)
    base = base / base.std() * 20.0 + 128.0
    ref = np.clip(np.round(base[pad:-pad, pad:-pad, pad:-pad]), 0, 255)
    zz, yy, xx = np.mgrid[0:DVC_SHAPE[0], 0:DVC_SHAPE[1],
                          0:DVC_SHAPE[2]].astype(np.float32)
    u, v, w = DVC_UVW
    # target(x') = reference(X), x' = X + u(X), w linear in Z
    sz = DVC_CZ + (zz - w - DVC_CZ) / (1.0 + DVC_STRAIN)
    tar = map_coordinates(base, [sz + pad, yy - v + pad, xx - u + pad],
                          order=3, mode="nearest")
    tar = np.clip(np.round(tar), 0, 255)
    return ref.astype(np.uint8), tar.astype(np.uint8)


def true_uvw(z):
    u, v, w = DVC_UVW
    return u, v, w + DVC_STRAIN * (z - DVC_CZ)


def run_dvc(torch, ot, ref, tar, pois, device, r=DVC_R, out_dir=None):
    """FFTCC3D -> ICGN3D1 -> Strain on ``pois``; per-stage milliseconds."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    ms = {}
    t0 = time.perf_counter()
    fftcc = ot.FFTCC3D(r, r, r, device=device)
    fftcc.set_images(ref, tar)
    icgn = ot.ICGN3D1(r, r, r, 0.001, 10, device=device)
    icgn.set_images(ref, tar)
    icgn.prepare()
    strain = ot.Strain(r, 10, device=device)
    sync()
    ms["setup_prepare"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    seeded = fftcc.compute(pois)
    sync()
    ms["fftcc3d"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    refined = icgn.compute(seeded)
    sync()
    ms["icgn3d1"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out = strain.compute(refined)
    sync()
    ms["strain"] = (time.perf_counter() - t0) * 1e3
    if out_dir is not None:
        dims = (DVC_SHAPE[2], DVC_SHAPE[1], DVC_SHAPE[0])
        t0 = time.perf_counter()
        ot.save_table_3d(os.path.join(out_dir, "dvc.csv"), out)
        ms["save_table_3d"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ot.save_matrix_bin_3d(os.path.join(out_dir, "dvc.bin"), out, dims)
        ms["save_matrix_bin_3d"] = (time.perf_counter() - t0) * 1e3
    return out, ms, dict(icgn.stats), dict(fftcc.stats)


def phase_dvc(torch, ot, ref, tar, tmpdir):
    from opencorr_tpu_torch.ops import lattice3d

    pois = ot.poi_grid_3d((35, 35, 60), 7, 7, 117, 5)
    n = pois.n
    check(n == 5733, "DVC grid size")
    run_dvc(torch, ot, ref, tar, pois.map(lambda a: a[:512]), "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lattice3d.lattice_eval_3d.launches = 0
    out, ms, stats, fstats = run_dvc(torch, ot, ref, tar, pois, "cuda",
                                     out_dir=tmpdir)
    launches = {"lattice_eval_3d": lattice3d.lattice_eval_3d.launches}
    peak = torch.cuda.max_memory_allocated()
    check(launches["lattice_eval_3d"] > 0,
          "the DVC path launched lattice_eval_3d no time")

    t = ot.table_to_numpy(out)
    for f, k in (("p", 12), ("r", 7), ("e", 6), ("sr", 3)):
        check(t[f].shape == (n, k), f"field {f} shape {t[f].shape}")
    zn = t["r"][:, 3]
    conv = zn > 0.9
    ut, vt, wt = true_uvw(t["z"].astype(np.float64))
    du = np.abs(t["p"][conv, 0] - ut)
    dv = np.abs(t["p"][conv, 4] - vt)
    dw = np.abs(t["p"][conv, 8] - wt[conv])
    ezz = t["e"][conv, 2]
    with open(os.path.join(tmpdir, "dvc.csv")) as f:
        n_lines = sum(1 for _ in f)
    rec, dims = ot.load_matrix_bin_3d(os.path.join(tmpdir, "dvc.bin"))
    res = dict(
        pois=n, r=DVC_R, volume=list(DVC_SHAPE),
        converged_frac=float(conv.mean()), mean_abs_du=float(du.mean()),
        mean_abs_dv=float(dv.mean()), mean_abs_dw=float(dw.mean()),
        max_abs_duvw=float(max(du.max(), dv.max(), dw.max())),
        mean_ezz=float(ezz.mean()), mean_exx=float(t["e"][conv, 0].mean()),
        imposed_ezz=DVC_STRAIN,
        codes={str(c): int((zn == c).sum()) for c in (-1.0, -3.0, -4.0,
                                                       -5.0)},
        mean_iterations=float(t["r"][conv, 4].mean()),
        icgn_stats=stats, fftcc_stats=fstats, launches=launches,
        stage_ms=ms, peak_mem_mb=peak / 2**20, csv_lines=n_lines,
        matrix_bin_records=int(rec.shape[0]))
    log(json.dumps({"dvc_path": res}))
    check(np.isfinite(t["p"][conv]).all() and np.isfinite(t["e"][conv]).all(),
          "non-finite DVC results on converged POIs")
    check(res["converged_frac"] >= 0.9, f"DVC converged {res['converged_frac']}")
    check(max(res["mean_abs_du"], res["mean_abs_dv"], res["mean_abs_dw"])
          < 0.01, f"DVC displacement error {res['mean_abs_du']}, "
          f"{res['mean_abs_dv']}, {res['mean_abs_dw']}")
    check(abs(res["mean_ezz"] - DVC_STRAIN) < 1e-3,
          f"DVC ezz {res['mean_ezz']} vs {DVC_STRAIN}")
    check(n_lines == n + 1, f"DVC csv lines {n_lines}")
    check(rec.shape == (n, 8) and dims == (100, 100, 700), "matrix bin")
    return res, launches


def phase_dvc_cpu_agreement(torch, ot, ref, tar, r=16, n_pois=64):
    """The DVC modules on cuda and on cpu on a 64-POI subset at r=16, every
    8th seed strained by 0.2 along z (the whole-chunk exact fallback)."""
    devices = card, host = ("cuda", "cpu")
    full = ot.poi_grid_3d((35, 35, 60), 7, 7, 117, 5, device="cpu")
    keep = np.linspace(0, full.n - 1, n_pois).astype(np.int64)
    xyz = [a[keep] for a in full.coords_numpy()]
    seeded = {}
    for dev in devices:
        f = ot.FFTCC3D(r, r, r, device=dev)
        f.set_images(ref, tar)
        seeded[dev] = ot.table_to_numpy(
            f.compute(ot.new_table_3d(*xyz, device=dev)))
    fu = np.array_equal(seeded[card]["p"], seeded[host]["p"])
    check(fu, "FFTCC3D u/v/w differ between cuda and cpu")
    s = seeded[host]
    p = s["p"].copy()
    p[::8, 11] = 0.2
    outs, res = {}, {}
    for dev in devices:
        t = ot.table_from_numpy_3d(s["x"], s["y"], s["z"], p, s["r"], s["e"],
                                   s["sr"], device=dev)
        m = ot.ICGN3D1(r, r, r, 0.001, 10, device=dev)
        m.set_images(ref, tar)
        m.prepare()
        outs[dev] = ot.table_to_numpy(m.compute(t))
        res[f"stats_{dev}"] = dict(m.stats)
    zc, zp = outs[card]["r"][:, 3], outs[host]["r"][:, 3]
    codes_equal = np.array_equal(np.where(zc < 0, zc, 1),
                                 np.where(zp < 0, zp, 1))
    both = (zc > 0) & (zp > 0)
    duvw = np.abs(outs[card]["p"][both][:, [0, 4, 8]]
                  - outs[host]["p"][both][:, [0, 4, 8]])
    it_eq = float((outs[card]["r"][:, 4] == outs[host]["r"][:, 4]).mean())
    res.update(pois=n_pois, r=r, fftcc_uvw_equal=fu, codes_equal=codes_equal,
               max_abs_duvw=float(duvw.max()) if both.any() else None,
               iterations_equal_frac=it_eq, converged=int(both.sum()))
    log(json.dumps({"dvc_cuda_vs_cpu": res}))
    check(codes_equal, "ICGN3D1 codes differ between cuda and cpu")
    check(both.any() and res["max_abs_duvw"] <= 1e-3,
          f"u/v/w differ by {res['max_abs_duvw']}")
    for dev in devices:
        check(res[f"stats_{dev}"].get("fallback", 0) > 0,
              f"the exact fallback did not run on {dev}")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import opencorr_tpu_torch as ot
        from opencorr_tpu_torch.ops import _kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    # phase 1: the card and the build
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    names = ["gather2d", "lattice2d", "lattice3d"]
    build_s = _kernels.build(names)
    for name in names:
        log(f"build {name}: {build_s[name]:.1f} s")
        for ln in _kernels.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in ln or "error" in ln.lower():
                log(f"  {ln.strip()}")

    ref, tar, center = speckle_pair(seed=0)
    img = torch.from_numpy(ref.astype(np.float32)).cuda()
    rng = np.random.default_rng(1)

    # phase 2: each kernel against its plain version, after ~0.3 s of
    # matrix products so that the first timing does not meet idle clocks
    warm = torch.ones((4096, 4096), device="cuda")
    for _ in range(50):
        warm = warm @ warm * (1.0 / 4096)
    torch.cuda.synchronize()
    del warm
    records = phase_kernels(torch, img, rng, reps=20)

    # phase 3: the main path
    with tempfile.TemporaryDirectory() as tmpdir:
        main_res, launches = phase_main(torch, ot, ot.Image2D.from_array(ref),
                                        ot.Image2D.from_array(tar), center,
                                        tmpdir)

    # phase 4: cuda against the plain versions on the cpu
    phase_cpu_agreement(torch, ot, ot.Image2D.from_array(ref),
                        ot.Image2D.from_array(tar))

    # phase 5: the DVC path
    t0 = time.perf_counter()
    vref, vtar = speckle_volumes(seed=2)
    log(json.dumps({"dvc_volumes_s": time.perf_counter() - t0}))
    vref, vtar = ot.Image3D.from_array(vref), ot.Image3D.from_array(vtar)
    with tempfile.TemporaryDirectory() as tmpdir:
        dvc_res, dvc_launches = phase_dvc(torch, ot, vref, vtar, tmpdir)
    launches.update(dvc_launches)

    # phase 6: the DVC modules on cuda against the cpu
    phase_dvc_cpu_agreement(torch, ot, vref, vtar)

    # phase 7: the records
    def summary(name, route, source, replaces, recs, ref_shape):
        r = next(x for x in recs if x["shape"] == ref_shape)
        return dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(x["max_abs_err"] for x in recs),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=ref_shape, shapes=recs)

    kernels = [
        summary("gather_windows_2d", "cuda",
                "opencorr_tpu_torch/csrc/gather2d.cu",
                "opencorr_tpu/ops/pallas_gather2d.py:33", records["gather"],
                [30000, 33, 33]),
        summary("lattice_eval_2d", "cuda",
                "opencorr_tpu_torch/csrc/lattice2d.cu",
                "opencorr_tpu/ops/pallas_lattice2d.py:68",
                records["lattice"], [30000, 33, 33]),
        summary("lattice_eval_3d", "cuda",
                "opencorr_tpu_torch/csrc/lattice3d.cu",
                "opencorr_tpu/ops/pallas_lattice.py:74",
                records["lattice3d"], [441, 61, 61, 61]),
    ]
    log(json.dumps({"stage_ms": main_res["stage_ms"],
                    "dvc_stage_ms": dvc_res["stage_ms"],
                    "total_s": time.perf_counter() - t_start}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
