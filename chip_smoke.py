#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``opencorr_tpu_torch``) on one GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package.  Phases, in order
(any failure raises and the script exits non-zero without a result line):

1. Identify the card (``nvidia-smi`` name and power limit) and build the
   five CUDA libraries from ``opencorr_tpu_torch/csrc`` (one ``nvcc`` each,
   all started together).
2. Each kernel against its plain PyTorch version on the card at the main
   paths' shapes (``kernel12_cases`` for kernels 1 and 2): the window
   gather bit-exact at 30k x 32x32, 33x33 and 40x40, 940 x 48x48, the
   epipolar candidates at 41x41 of the stereo path (16,379 windows) and of
   the reconstruction example (16,380 windows: 2,340 POIs x 7 candidates),
   every chunk's, from the search's own chunk rule, and the stereo path's
   IC-GN at 10,000 x 33x33 and 40x40 and 312 x 48x48, with corners that
   need clamping; the 2D lattice eval at D=2 (30k, 10k and the stereo
   path's compacted 2,500 POIs) and D=6 (940 and 312 POIs) within 1e-6 x
   max|eblk|; kernels 1 and 2 also through their C entry points, whose
   device time a launch (launches enqueued behind a sleep kernel, so that
   none waits on the host: ``launch_timing``) is each record's ``ms``,
   beside the wrapper's CUDA-event time (``wrapper_ms``) and the host us a
   call of each; the
   3D lattice eval at D=1 at one ICGN3D1 chunk of the DVC path (441 x
   61^3) and of the SIFT path (2,795 x 33^3), on offsets from a smooth
   affine warp per POI (as ICGN3D1 makes them) and on random ones, equal
   with ``==``; both lattice evals exactly 0 for out-of-range offsets;
   ICGN3D1's step kernels at those two chunks (``phase_icgn3d_step``):
   the prologue ``==`` its plain version on all nine outputs, the residual
   with and without z guards within the card test's tolerance of its plain
   version (fail flags equal) and equal from run to run; FFTCC3D's
   re-rank kernel ``==`` its plain version at one DVC chunk (512 x 60^3,
   8 candidates clustered about the peak and scattered), timed against
   the two windows' bytes, with the memory it allocates and its ptxas
   lines (``phase_rerank3d``); the global-LUT bicubic eval's kernel
   (``bspline.bicubic_eval``) ``==`` its plain version, value and mask, at
   one chunk of the self-adaptive path (10,749 POIs x 61^2 on a 3751x501
   LUT, warped near identity, every 97th POI moved off the image), at the
   flagship's exact fallback (940 x 33^2 on a 900x280 LUT) and on the edge
   cases of the range guard, timed with and without its mask beside its
   byte bound, the plain version and the port's first einsum, with its
   ptxas lines (``phase_lut_eval2d``); the
   SIFT3D descriptor histogram at the octave-0 crops 23, 29 and 36, with
   random rotations, at 64 keypoints (some near the volume's faces in
   clamped windows; the kernel splits each box into z-bands) and at the
   reference volume's kept count of that layer on white noise, and at
   every launch shape of phase 7 (``TORUS_DESC``: both volumes' kept
   counts on the octave-0, -1 and -2 layers whose crop fits, 4,689 to
   13,808 keypoints at one block a keypoint, 164 to 564 in z-bands) on the
   volume blurred at the layer's sigma and voxel pitch, every keypoint
   within 1e-5 x max|S| (float atomics sum in a varying order).  Kernels 1
   and 2 also ``==`` their plain versions at every shape of phase 12's planar
   suite that the lists above lack, derived from the port's own chunk,
   correction-cap and compaction rules (``dic2d_launch_shapes``): the
   gather at 42,025 x 25x25 and 32x32, 1,313 x 40x40 and 937 x 48x48, the
   lattice eval at D=2 on 42,025 and 10,507 x 25x25 and 7,500 x 33x33 and
   at D=6 on 1,313 x 25x25 and 937 x 33x33.  Kernel, plain and library
   times; kernel 4's bound counts the voxels it must read.
3. The main path on ``cuda``: FFTCC2D(16,16) -> ICGN2D1(16,16,0.001,10) ->
   Strain(20,5) on ``poi_grid_2d((30,30),100,300,2)`` (30,000 POIs) of a
   900x280 8-bit speckle pair whose target is the reference under a known
   sub-pixel translation plus 0.5% strain, then ``save_table_2d``.  Launch
   counters are zeroed just before the timed run (after one warm-up run)
   and read just after it, kernels 1 and 2 counted per launch shape, their
   time estimated from phase 2's device time (``device_sum``).  Checks
   convergence and recovered displacement and strain against the imposed
   field.
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
   read just after; the launches of kernel 3 and of ICGN3D1's step
   kernels (prologue and residual) in that run are also timed with CUDA
   events and summed, and their shapes must be phase 2's.  Checks
   convergence, the recovered field and ezz.
6. The DVC modules on ``cuda`` and on ``cpu`` on 64 POIs at r=16, every
   8th seed given a 0.2 z strain so that IC-GN takes its whole-chunk exact
   fallback: FFTCC u/v/w equal, codes equal, u/v/w within 1e-3 voxel.
7. The feature-seeded DVC path on ``cuda`` at the Torus CT pair's
   dimensions, 568x288x940 8-bit, built on the card (synthetic pores over a
   weak speckle, grey levels 18-238; the target is the reference
   translated by u=0.5, v=-0.8, w=1.2 through a Fourier phase shift),
   through ``examples/dvc.run``'s ``sift_icgn1`` workload with SIFT3D's
   capped device path (``sift_backend="device"``, whose kernel-4 launch
   shapes phase 2 checks): SIFT3D -> FeatureAffine3D(16, 16, 16) ->
   ICGN3D1(16, 16, 16, 0.001, 10) ->
   ``save_table_3d``, ``save_matrix_bin_3d`` on
   ``poi_grid_3d((30,30,30),81,21,46,11)`` (78,246 POIs) read from a POI
   CSV.  Counters zeroed after a warm-up on a sub-volume and read just
   after, kernels 3 and 4 and the step kernels timed per launch with CUDA
   events in that run.
   Reports every pyramid layer's candidate and survivor counts beside its
   caps; checks the median matched displacement (within 1 voxel of the
   shift), the converged fraction (>= 0.9), mean |du|, |dv|, |dw| (< 0.01
   voxel), the native writer and that every launch shape of kernels 3 and
   4 and of the step kernels is one phase 2 checked.
8. SIFT3D (device path), FeatureAffine3D and ICGN3D1 on ``cuda`` and on
   ``cpu`` on a 64x64x72 pair: keypoint counts and matched sets equal; FeatureAffine3D
   on the same matches with the same RANSAC draws: codes equal, p within
   1e-4; ICGN3D1 from the same seeds: codes equal, u/v/w within 1e-3 voxel.
9. The stereo slice's modules on ``cuda`` and on ``cpu`` on a 288x352
   crop of phase 10's scene (the cameras' principal points moved to the
   crop's corner): SIFT2D's octave counts equal and matched sets within 1%;
   FeatureAffine2D on the cpu's matches: codes equal, p within 1e-4;
   EpipolarSearch, then ICGN2D2 from the cpu's epipolar table: codes
   equal, u/v within 1e-3 px; ``reconstruct`` within 1e-3 mm.
10. The stereo path on ``cuda`` at the GT4 pair's size, 1920x1200 8-bit:
   a speckled plate rendered in float64 through the example's two cameras
   (pixel -> undistorted ray -> plane -> texture), the targets the plate
   moved by STEREO_SHIFT mm and stretched 0.5% in-plane; 10,000 POIs on a
   grid.  ``examples/stereo_3d_dic_epipolar_sift.run`` (EpipolarSearch ->
   ICGN2D2, SIFT2D -> FeatureAffine2D -> ICGN2D1, the cross match, the
   triangulation, ``save_table_2ds``) and ``examples/stereo_strain.run``,
   after a warm-up on the crop; kernels 1 and 2 counted per launch shape,
   their device time from phase 2's (every launch shape must be one phase
   2 timed; the epipolar gathers the shape phase 2 checked).  Prints the
   epipolar reach, every SIFT2D octave's counts beside its caps, the
   matches and FeatureAffine2D's codes; checks each pair's
   converged fraction (>= 0.9), each view's mean position error (< 0.02
   px) and the mean 3D displacement error against the bound from moving
   every matched coordinate by 0.02 px.
11. ICLM2D1, NR2D1 (phase 3's pair, every 40th POI, FFTCC seeds, every
   8th moved 3 px for ICLM2D1), ICLM2D2 (phase 12's rotation pair) and
   the self-adaptive ICGN2D1 and ICLM2D1 (the utn-size pair, radii 10-25)
   on ``cuda`` and on ``cpu``: codes equal, u/v within 1e-3 px.
12. The planar example suite on ``cuda``: ``examples/dic_2d.run`` for all
   seven workloads at the reference programs' grids and radii, after a
   warm-up of each on a small grid: fftcc_icgn1, fftcc_iclm1 and fftcc_nr1
   (30,000 POIs, r=16) on phase 3's pair; sift_icgn2 and sift_iclm2
   (42,025 POIs, r=12) on a 512x512 pair whose target is rotated 170
   degrees; self_adaptive (38,400 POIs, SIFT2D -> FeatureAffine2D
   self-adaptive -> ICGN2D1(30) self-adaptive -> Strain(25, 10)) on a
   3751x501 pair stretched 0.5% along x; strain (Strain(20, 5)) from the
   fftcc_icgn1 table just written.  Counters zeroed after the warm-up and
   read after the suite, kernels 1 and 2 counted per launch shape per
   workload, their device time from phase 2's, and the global-LUT eval's
   launches per workload (self_adaptive: one a Gauss-Newton step, equal
   to its ``iter_adaptive`` count);
   prints each workload's stage times, table-writer times, branch counts,
   SIFT2D octave counts beside their caps, r_max and the writer.  Checks:
   the native table codec loaded and wrote every table; converged >= 0.9
   and mean |u - u_true|, |v - v_true| < 0.01 px on every refining
   workload (self_adaptive at the moved POIs, every radius >= 10); mean
   exx and eyy of strain, and exx of self_adaptive, within 1e-3 of the
   imposed 0.005; the fftcc_icgn1 table equal to phase 3's; every launch
   shape one that phase 2 checked.
13. The DVC example (``examples/dvc.run``) on ``cuda``: ``fftcc_icgn1`` on
   ``.bin`` files of phase 5's volumes with phase 5's grid as a POI CSV
   (r=30), then ``strain`` on the table it wrote.  Checks the table
   equals phase 5's, phase 5's gates, mean ezz within 1e-3 of 0.005, the
   native writers and every launch shape of kernel 3 and of the step
   kernels against phase 2's.
14. Sharded DVC (``parallel/halo.ShardedICGN3D1``) on a real NCCL group of
   one (``make_mesh(1, axis="z")``): ShardedICGN3D1(30,30,30,0.001,10) on
   phase 5's uint8 volumes and FFTCC3D seeds (5,733 POIs) against phase
   5's ICGN3D1 table, codes equal and u/v/w within 1e-5 voxel, every
   launch shape of kernel 3 and of the step kernels (the residual with z
   guards) one phase 2 checked; then 64 POIs at r=16 (four
   at the z faces, which the z guards and the global edge guard fail -3)
   on ``cuda`` and on the group's cpu mesh: codes equal, u/v/w within
   1e-3 voxel.  Prints the stage times (halo exchange, prepare, refine,
   gather) and the launches of kernel 3 and the step kernels.
15. The reconstruction example (``examples/reconstruction_epipolar.run``,
   SIFT mode) on ``cuda`` on 1920x1200 views of a curved speckled surface
   (``ReconScene``: its view-2 x parallax is bilinear in the view-1
   position, so the fitted model's +-6 px search reaches every truth; a
   plane through these cameras leaves 74% of the truths out of reach),
   68,800 POIs, after a warm-up on a 300x400 crop.  Prints the fitted
   parallax, every truth's epipolar reach from the fitted estimate (and
   how many lie past 6 px), the SIFT2D octave counts and the stage times;
   kernel 1's launches counted per shape, their device time from phase
   2's.
   Checks ZNCC > 0.9 on at least 0.9 of POIs, mean |view-2 position -
   truth| < 0.02 px, the mean 3D error under the bound from moving each
   matched coordinate by 0.02 px, and that every kernel-1 launch shape is
   one phase 2 checked.  The constant-parallax branch is held against the
   JAX package on the CPU only (tests/test_torch_examples_dvc_recon.py).
16. (a) SIFT3D's host path (the default of SIFT3D() and of the DVC
   example, every extremum kept) through ``examples/dvc.run``'s
   ``sift_icgn1`` on phase 7's pair and grid, after a warm-up on a
   sub-volume; kernels 3 and 4 and the step kernels counted and timed per
   launch.  Prints every
   layer's extrema, oriented and kept counts and its descriptor route
   (kernel 4, or the einsum path where the crop does not fit or the window
   clips the sphere), and the host stages' wall ms (blur, DoG, extrema,
   orientation and descriptors with their window gathers, match).  Every
   kernel-4 launch's layer is launched again at its own (count, crop),
   with float32 and bfloat16 operands, each held against its plain
   version on 256 keypoints spread over the launch within 1e-5 x max|S|
   and timed.  Gates: every layer with keypoints takes the route the
   layer plan gives it (``expected_routes``), FeatureAffine3D's -1 share
   no more than phase 7's plus 0.01, converged >= 0.9, mean |u - u_true|
   < 0.01 voxel, the median matched displacement within 1 voxel, every
   launch shape of kernel 3 and the step kernels one phase 2 checked.  (b) The host path, and the device path with
   ``hist_bf16=True``, on ``cuda`` and on ``cpu`` on phase 8's pair:
   keypoint counts and matched sets equal; the host path's descriptor
   stage on the same keypoints and rotations within 1e-5 x max|desc|, and
   on kernel-4 layers the bfloat16 histogram S from the same tables
   within 1e-5 x max|S|; the two devices' rotations within 1e-4 on four
   pairs, and three injected orientation faults above it.  (c)
   FeatureAffine2D with ``neighbor_backend="device"`` against ``"host"``
   at the stereo path's 10,000 POIs, the rotation's 42,025 and the utn
   pair's self-adaptive 38,400 (each on its own SIFT2D matches from phases
   10 and 12), and FeatureAffine3D at 78,246 (on (a)'s matches): both
   timed, codes, counts and p equal on every POI whose candidate list
   holds no distance tie; prints the ties.  (d) ICGN3D1 with
   ``eval_mode="tile"`` on phase 5's queue against ``window_margin=None``
   (equal wherever the tile path does not fail -3), ShardedICGN3D1 with
   the tile eval on an NCCL group of one against it (codes equal, u/v/w
   within 1e-5 voxel), no kernel-3 launch, and 64 POIs at r=16 on ``cuda``
   and on ``cpu`` (codes equal, u/v/w within 1e-3 voxel).
17. JSON lines: per-kernel records (each kernel's time per path,
   ``path_ms``: kernels 1 and 2 estimated, launches x phase 2's device ms
   per launch shape, its ``timing`` saying so; kernels 3 and 4 and the
   step kernels CUDA events a launch, each residual call's four launches
   as one), the stage times, and last
   ``{"ok": true, "device": {...}}``.  The script refuses to start when
   ``OPENCORR_SIFT2D`` is set.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import re
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
DVC_GRID = ((35, 35, 60), 7, 7, 117, 5)  # poi_grid_3d's arguments
DVC_R = 30
DVC_UVW = (0.4, -0.3, 0.6)
DVC_STRAIN = 0.005
DVC_CZ = (DVC_SHAPE[0] - 1) / 2.0
# FFTCC3D's re-rank at one chunk of the DVC path: 512 POIs (FFTCC3D's
# chunk) of (2r)^3 windows
RERANK_CHUNK = (512, 2 * DVC_R, 2 * DVC_R, 2 * DVC_R)
# The feature-seeded DVC path (test_dvc_sift_icgn1): the Torus CT pair's
# dimensions [z, y, x] (bench_dvc_torus.py:39,71), r=16, the translation
# imposed on the target (examples/dvc.py:43), and a POI grid close to
# Torus_POIs.csv's 78,700 points, every POI 24 voxels or more inside.
TORUS_SHAPE = (568, 288, 940)
TORUS_R = 16
# phase 16(b): the host path's rotations on the card against the cpu's on
# these pairs, and the limit between them, which the faults must pass
ROT_SEEDS = (5, 6, 7, 8)
ROT_TOL = 1e-4
ROT_FAULTS = ("layer rounded to float16", "scale x 1.001",
              "keypoint x + 1")
TORUS_UVW = (0.5, -0.8, 1.2)
TORUS_GRID = ((30, 30, 30), 81, 21, 46, 11)
# The synthetic pores: clusters of four Gaussian spikes (sigma 2.8 or 3.4
# voxels, dark or bright, up to 30 grey levels a spike) one per 12.5^3
# voxels on average, over a speckle of sigma 2 and 1.5 grey levels.  Phase 7
# prints every pyramid layer's candidate count beside its cap: denser or
# finer textures fill the scan-order caps, sparser ones leave POIs with
# fewer than 4 matched keypoints in FeatureAffine3D's radius (code -1).
PORES = dict(spacing=12.5, sigmas=(2.8, 3.4), amp=30.0, speckle_sigma=2.0,
             speckle_std=1.5)
# Keypoints the Torus-size path keeps on each pyramid layer whose crop fits
# kernel 4, as (reference, target), by the layer's index in SIFT3D's plan
# (phase 7 prints them): octave 0 (layers 1-3, crops 23, 29, 36), octave 1
# (7-9, the same crops at twice the voxel pitch) and octave 2 (13-14).
# Phase 2 launches kernel 4 at every one of these counts, the launch shapes
# of phase 7; at 1,056 keypoints and more a launch runs one block per
# keypoint, below it splits each keypoint's box into z-bands.
TORUS_DESC = {1: (4689, 3485), 2: (12187, 12229), 3: (13808, 13686),
              7: (5942, 5917), 8: (1507, 1529), 9: (564, 540),
              13: (338, 320), 14: (167, 164)}
# the reference volume's octave-0 counts (bench_torch_kernels.py's)
TORUS_KEPT = tuple(TORUS_DESC[i][0] for i in (1, 2, 3))
# csrc/desc3d.cu's kTargetBlocks: below this many keypoints a launch splits
# each keypoint's box into z-bands.
DESC_TARGET_BLOCKS = 132 * 8
DESC_PLAIN_CHUNK = 1024
# The stereo path (test_3d_dic_epipolar_sift): GT4's image size [H, W], the
# example's two cameras (examples/stereo_3d_dic_epipolar_sift.py:48-57) as
# (intrinsics, extrinsics), its parallax estimate, and a POI grid like
# GT4-POIs.csv's 9,997 points (here 100 x 100 at step 10 px).
STEREO_SIZE = (1200, 1920)
STEREO_CAMS = (
    (dict(fx=6673.315918, fy=6669.302734, fs=0.0, cx=872.15778,
          cy=579.95532, k1=0.032258954, k2=-1.01141417, k3=29.78838921),
     dict()),
    (dict(fx=6607.618164, fy=6602.857422, fs=0.0, cx=917.9733887,
          cy=531.6352539, k1=0.064598486, k2=-4.531373978, k3=29.78838921),
     dict(tx=122.24886, ty=1.8488892, tz=17.624638, rx=0.00307711,
          ry=-0.33278773, rz=0.00524556)))
STEREO_PARALLAX = (-30.0, -40.0)
STEREO_SEARCH = (30, 5)  # set_search(radius, step)
STEREO_EPI_R = 20  # create_icgn(20, 20, ...)
STEREO_GRID = ((460, 100), 100, 100, 10)
STEREO_POIS = STEREO_GRID[1] * STEREO_GRID[2]
# The scene: a speckled plate on the plane through the point of camera 1's
# ray through the image centre where the x parallax is the example's -30 px
# (about 387 mm deep), its normal bisecting the two optical axes.  The
# targets show it translated by STEREO_SHIFT mm and stretched in-plane by
# STEREO_STRETCH about the moved centre point.  The shift is toward the
# cameras: at +2 mm in z the cross match's true points would lie up to 29 px
# along the epipolar line from the parallax estimate, past the search's
# reach (25 px of candidates plus the coarse IC-GN's capture).  The speckle:
# Gaussian-filtered noise of STEREO_SPECKLE cells at STEREO_CELL_MM a cell
# (about 1 px in either view), 128 +- 28 grey levels, 8-bit, on a plate
# STEREO_PLATE_PX view-1 pixels wider than the POI grid on each side; the
# background is a uniform 128 without SIFT features.
STEREO_SHIFT = (0.5, -0.3, -2.0)
STEREO_STRETCH = 0.005
STEREO_CELL_MM = 0.058
STEREO_SPECKLE = 1.5
STEREO_PLATE_PX = 70
STEREO_TOL_PX = 0.02  # mean |position - truth| gate of r2, t1 and t2


# The planar example suite (examples/dic_2d.py: the reference's
# test_2d_dic_*.cpp programs at their grids and radii), on synthetic 8-bit
# pairs of the reference datasets' sizes: the oht_cfrp workloads on phase
# 3's pair; the rotation pair (rotation_000/170), a 512x512 speckle whose
# target is rotated ROT_DEG about the centre and shifted; the utn pair's
# size, 3751x501, stretched UTN_STRETCH along x about the centre and
# shifted.
ROT_SIZE = (512, 512)
ROT_DEG = 170.0
ROT_SHIFT = (0.3, -0.4)
UTN_SIZE = (501, 3751)
UTN_STRETCH = 0.005
UTN_SHIFT = (0.43, -0.27)
# The global-LUT eval's launch shapes checked in phase 2: (LUT shape, POIs,
# r).  One chunk of the self-adaptive path (ICGN2D1 at r_max=30 on the utn
# pair, ``budget_chunk``'s 40 M-sample budget: 10,749 POIs, every chunk
# padded to it) and the flagship's exact fallback (940 POIs at r=16).
LUT_EVAL_CASES = ((UTN_SIZE, 40_000_000 // 61 ** 2, 30), ((H, W), 940, 16))


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warm: int = 2) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` launches after ``warm``
    untimed ones, CUDA events."""
    for _ in range(warm):
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


def launch_timing(torch, call, reps: int, warm: int = 2, rounds: int = 3):
    """Device ms and host us a call of ``call``, over ``reps`` calls
    enqueued while the stream waits behind a sleep kernel: the time between
    two events around them on the device, so that no launch waits on the
    host, and the host's time to enqueue them; each the median of
    ``rounds`` rounds (one round read a kernel of 43 us as 72).  Fails
    unless the sleep was still running when a round's last call was
    enqueued."""
    for _ in range(warm):
        call()
    torch.cuda.synchronize()
    cycles = 1 << 21
    device_ms, host_us = [], []
    for _ in range(4 + rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        host_s = time.perf_counter() - t0
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if not ahead:
            cycles <<= 2
            continue
        device_ms.append(start.elapsed_time(end) / reps)
        host_us.append(host_s / reps * 1e6)
        if len(device_ms) == rounds:
            return float(np.median(device_ms)), float(np.median(host_us))
    raise AssertionError("the host did not enqueue ahead of the device")


def entry_call(torch, name, bind, args):
    """One launch of the package's build of kernel ``name`` through its C
    entry point, ``bind`` typing it, on ``args``; raises on a CUDA error."""
    from opencorr_tpu_torch.ops import _kernels

    fn = bind(_kernels.load(name))
    return lambda: _kernels.check(fn(*args), name)


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


def by_shape_record(wrapper, ms_of, timing):
    """Launch count and summed milliseconds of ``wrapper``'s launches since
    its ``shapes`` dict was set, in all and per launch shape, the ms of
    ``k`` launches at a shape being ``ms_of(shape, k)``; stops the
    counting."""
    shapes, wrapper.shapes = wrapper.shapes, None
    by_shape = {}
    for shape, k in shapes.items():
        ms = ms_of(shape, k)
        by_shape["x".join(map(str, shape))] = dict(
            launches=k, ms_per_launch=ms / k, ms_sum=ms)
    n = sum(shapes.values())
    ms = sum(v["ms_sum"] for v in by_shape.values())
    return dict(launches=n, ms_sum=ms, ms_per_launch=ms / n if n else None,
                by_shape=by_shape, timing=timing)


def event_ms(wrapper):
    """``by_shape_record`` of kernel 3's or 4's launches since its
    ``shapes`` dict and ``events`` list were set, each launch's ms from its
    CUDA events; stops the recording."""
    ev, wrapper.events = wrapper.events, None
    ms = {}
    for a, b, shape in ev:
        ms[shape] = ms.get(shape, 0.0) + a.elapsed_time(b)
    return by_shape_record(wrapper, lambda shape, k: ms[shape], "events")


def merge_event_ms(recs):
    """``event_ms`` or ``device_sum`` records of several runs summed, per
    kernel."""
    out = {}
    for rec in recs:
        for name, ev in rec.items():
            m = out.setdefault(name, dict(launches=0, ms_sum=0.0,
                                          by_shape={}, timing=ev["timing"]))
            m["launches"] += ev["launches"]
            m["ms_sum"] += ev["ms_sum"]
            for s, v in ev["by_shape"].items():
                b = m["by_shape"].setdefault(s, dict(launches=0, ms_sum=0.0))
                b["launches"] += v["launches"]
                b["ms_sum"] += v["ms_sum"]
    return out


# how ``device_sum`` records are timed: not on the path itself
ESTIMATED = "estimated: launches x phase 2 device ms"


def device_sum(wrapper, device_ms):
    """``by_shape_record`` of kernel 1's or 2's launches since its
    ``shapes`` dict was set, estimated: launches x the device ms a launch
    that phase 2 measured at that shape (``device_ms``, by the shape as
    the wrapper records it), on phase 2's inputs and not on the path's;
    fails on a shape that phase 2 did not time."""
    def ms_of(shape, k):
        key = "x".join(map(str, shape))
        check(key in device_ms, f"{wrapper.__name__} launched at {key}, "
              "which phase 2 did not time")
        return k * device_ms[key]

    return by_shape_record(wrapper, ms_of, ESTIMATED)


def epipolar_windows(ot):
    """Candidate windows a chunk of the stereo path's EpipolarSearch
    gathers: the search's own chunk rule over STEREO_POIS POIs (the last
    chunk is padded to the full size, ``models/base.chunked``)."""
    e = ot.EpipolarSearch(None, None, device="cpu")
    e.set_search(*STEREO_SEARCH)
    return min(e.chunk_pois(), STEREO_POIS) * len(e.candidate_offsets())


def recon_windows(ot):
    """Candidate windows a chunk of the reconstruction example's
    EpipolarSearch gathers at GT4 size (``set_search(8, 2)``: 7
    candidates; the search's own chunk rule over its 68,800 POIs)."""
    from opencorr_tpu_torch.examples import reconstruction_epipolar as rec

    e = ot.EpipolarSearch(None, None, device="cpu")
    e.set_search(*rec.SIFT_SEARCH)
    _, nx, ny, _ = recon_grid(STEREO_SIZE)
    return min(e.chunk_pois(), nx * ny) * len(e.candidate_offsets())


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def gather_corners(torch, src, n, sh, sw, rng):
    """``n`` random window corners in ``src`` for kernel 1, one in ten
    needing a clamp (up to a window past either end), int32 on ``src``'s
    device; and how many need one."""
    h, w = src.shape
    y0 = rng.integers(0, h - sh + 1, n)
    x0 = rng.integers(0, w - sw + 1, n)
    bad = rng.uniform(size=n) < 0.1
    y0[bad] = rng.integers(-sh, h + sh, bad.sum())
    x0[bad] = rng.integers(-sw, w + sw, bad.sum())
    return (*(torch.from_numpy(a.astype(np.int32)).to(src.device)
              for a in (y0, x0)), int(bad.sum()))


def lattice2d_inputs(torch, dev, n, s, d, rng, kind="random"):
    """eblk and the four sample arrays of kernel 2 for ``n`` POIs at side
    ``s`` and wobble ``d``: "random", uniform offsets in [0, 2D] (5% out
    of range: -1, 2D+1, -9 or 40) and fractions; "path", per POI a
    translation in [0, 1)^2 and a displacement gradient of N(0, 0.003) per
    entry, the samples' local coordinates split into floor offsets (D at
    rest) and fractions, as IC-GN splits them."""
    wl = 4 + 2 * d
    eblk = np.round(rng.uniform(0, 255, (n, s + wl - 1, s + wl - 1)))
    if kind == "random":
        offs = [rng.integers(0, 2 * d + 1, (n, s, s)) for _ in range(2)]
        for a in offs:
            bad = rng.uniform(size=a.shape) < 0.05
            a[bad] = rng.choice([-1, 2 * d + 1, -9, 40], bad.sum())
        fracs = [rng.uniform(0, 1, (n, s, s)) for _ in range(2)]
    else:
        t = rng.uniform(0, 1, (n, 2))
        grad = 0.003 * rng.standard_normal((n, 2, 2))
        q = np.arange(s) - (s - 1) / 2
        qs = (q[:, None], q[None, :])
        offs, fracs = [], []
        for a in range(2):  # y, x
            loc = d + t[:, a, None, None] + sum(
                grad[:, a, b, None, None] * qs[b] for b in range(2))
            offs.append(np.floor(loc))
            fracs.append(loc - np.floor(loc))
    return (torch.from_numpy(eblk.astype(np.float32)).to(dev),
            *(torch.from_numpy(a.astype(np.int32)).to(dev) for a in offs),
            *(torch.from_numpy(a.astype(np.float32)).to(dev)
              for a in fracs))


def gather_case(torch, src, n, sh, sw, rng, reps, **tags):
    """Kernel 1 ``==`` its plain version and ``unfold`` + index on ``n``
    random corners of ``src``, one in ten needing a clamp, through the
    wrapper and through the C entry point; timed: ``ms`` the device time a
    launch of the C entry point (``launch_timing``), ``wrapper_ms`` CUDA
    events around back-to-back wrapper calls (host time included where it
    is longer), and the host us a call of each."""
    from opencorr_tpu_torch.ops import gather2d

    h, w = src.shape
    y0, x0, clamped = gather_corners(torch, src, n, sh, sw, rng)
    got = gather2d.gather_windows_2d(src, y0, x0, sh=sh, sw=sw)
    want = gather2d.gather_windows_2d_plain(src, y0, x0, sh=sh, sw=sw)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"gather {n}x{sh}x{sw} not bit-exact")

    def library():
        yc = y0.long().clamp(0, h - sh)
        xc = x0.long().clamp(0, w - sw)
        return src.unfold(0, sh, 1).unfold(1, sw, 1)[yc, xc]

    check(torch.equal(library(), want), "gather library call differs")
    out = torch.full_like(want, float("nan"))
    entry = entry_call(torch, "gather2d", gather2d.bind,
                       gather2d.c_args(src, y0, x0, out, sh, sw))
    ms, entry_us = launch_timing(torch, entry, max(reps, 50))
    check(torch.equal(out, want), f"gather {n}x{sh}x{sw} through the C "
          "entry point not bit-exact")
    wrapped = lambda: gather2d.gather_windows_2d(src, y0, x0, sh=sh, sw=sw)
    _, wrapper_us = launch_timing(torch, wrapped, max(reps, 50))
    nbytes = (h * w + n * sh * sw + 2 * n) * 4
    rec = dict(
        shape=[n, sh, sw], **tags, max_abs_err=0.0, ms=ms,
        wrapper_ms=cuda_ms(torch, wrapped, reps), entry_host_us=entry_us,
        wrapper_host_us=wrapper_us,
        plain_ms=cuda_ms(torch, lambda: gather2d.gather_windows_2d_plain(
            src, y0, x0, sh=sh, sw=sw), reps),
        library_ms=cuda_ms(torch, library, reps),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        bytes=nbytes, clamped=clamped)
    log(json.dumps({"kernel": "gather_windows_2d", **rec}))
    return rec


def lattice_case(torch, dev, n, s, d, rng, reps, exact=False, **tags):
    """Kernel 2 against its plain version on random blocks and offsets (5%
    out of range, which must give exactly 0): within 1e-6 x max|eblk|, or
    ``==`` when ``exact``; the C entry point ``==`` the wrapper; timed as
    ``gather_case`` times kernel 1."""
    from opencorr_tpu_torch.ops import lattice2d

    args = lattice2d_inputs(torch, dev, n, s, d, rng)
    eblk, dy, dx = args[:3]
    got = lattice2d.lattice_eval_2d(*args, d_wobble=d)
    want = lattice2d.lattice_eval_2d_plain(*args, d_wobble=d)
    torch.cuda.synchronize()
    oor = (dy < 0) | (dy > 2 * d) | (dx < 0) | (dx > 2 * d)
    check(bool((got[oor] == 0).all()), f"lattice D={d}: nonzero out of "
          "range")
    err = float((got - want).abs().max())
    tol = 0.0 if exact else 1e-6 * float(eblk.abs().max())
    check(torch.equal(got, want) if exact else err <= tol,
          f"lattice D={d} {n}x{s}x{s}: max|err| {err} > {tol}")
    out = torch.full_like(got, float("nan"))
    entry = entry_call(torch, "lattice2d", lattice2d.bind,
                       lattice2d.c_args(*args, out, d))
    ms, entry_us = launch_timing(torch, entry, max(reps, 50))
    check(torch.equal(out, got), f"lattice D={d} {n}x{s}x{s} through the C "
          "entry point differs from the wrapper's")
    wrapped = lambda: lattice2d.lattice_eval_2d(*args, d_wobble=d)
    _, wrapper_us = launch_timing(torch, wrapped, max(reps, 50))
    in_range = int((~oor).sum())
    nbytes = (eblk.numel() + 5 * n * s * s) * 4
    flops = in_range * LATTICE_FLOPS
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOP_PER_S * 1e3
    rec = dict(
        shape=[n, s, s], d_wobble=d, **tags, max_abs_err=err, tolerance=tol,
        ms=ms, wrapper_ms=cuda_ms(torch, wrapped, reps),
        entry_host_us=entry_us, wrapper_host_us=wrapper_us,
        plain_ms=cuda_ms(torch, lambda: lattice2d.lattice_eval_2d_plain(
            *args, d_wobble=d), reps),
        library_ms=None, bound_ms=max(tb, tf),
        bound_by="bytes" if tb >= tf else "operations",
        bytes=nbytes, flops=flops, out_of_range=int(oor.sum()))
    log(json.dumps({"kernel": "lattice_eval_2d", **rec}))
    return rec


def kernel12_cases(ot):
    """The launch shapes at which phase 2 checks and times kernels 1 and 2.
    Gathers (n, sh, sw, image), the image "main" (phase 3's 900x280
    reference), "gt4" (1920x1200) or "rotation" (512x512); lattice evals
    (n, s, D, exact), ``exact``: ``==`` the plain version, else within
    1e-6 x max|eblk|.  First the main, stereo and reconstruction paths'
    shapes, then the planar suite's that those lack
    (``dic2d_launch_shapes``)."""
    side = 2 * STEREO_EPI_R + 1
    cap = max(256, STEREO_POIS // 32)
    # the main path's FFTCC windows, subsets, D=2 and D=6 blocks; the
    # stereo path's epipolar candidates (a chunk's POIs x 11 candidates)
    # and the reconstruction example's (x 7) at r=20; the stereo path's
    # IC-GN at r=16 on its 10,000 POIs: subsets, D=2 blocks and, for the
    # correction cap max(256, n/32), D=6 blocks
    gathers = [(30000, 32, 32, "main"), (30000, 33, 33, "main"),
               (30000, 40, 40, "main"), (940, 48, 48, "main"),
               (epipolar_windows(ot), side, side, "gt4"),
               (recon_windows(ot), side, side, "gt4"),
               (STEREO_POIS, 33, 33, "gt4"), (STEREO_POIS, 40, 40, "gt4"),
               (cap, 48, 48, "gt4")]
    # the main path's D=2 block and D=6 correction, and the stereo path's
    # second-order ones: the chunk, the correction cap and IC-GN's
    # compacted tail ceil(n/4)
    lattices = [(30000, 33, 2, False), (940, 33, 6, False),
                (STEREO_POIS, 33, 2, False), (cap, 33, 6, False),
                (-(-STEREO_POIS // 4), 33, 2, False)]
    suite_g, suite_l = dic2d_launch_shapes(ot)
    gathers += [(n, sh, sw, "rotation") for n, sh, sw in sorted(
        suite_g - {g[:3] for g in gathers})]
    lattices += [(n, s, d, True) for n, s, _, d in sorted(
        suite_l - {(n, s, s, d) for n, s, d, _ in lattices})]
    return gathers, lattices


def case_images(torch, img, rng):
    """The images ``kernel12_cases`` names, on ``img``'s device."""
    dev = img.device
    rand = lambda shape: torch.from_numpy(np.round(rng.uniform(
        0, 255, shape)).astype(np.float32)).to(dev)
    return {"main": img, "gt4": rand(STEREO_SIZE), "rotation": rand(ROT_SIZE)}


def phase_kernels(torch, ot, img, rng, reps):
    """Kernel vs plain version on the card at the paths' shapes: kernels 1
    and 2 at ``kernel12_cases``, kernel 3 and ICGN3D1's step kernels at
    one chunk of each 3D path, FFTCC3D's re-rank at one DVC chunk and the
    global-LUT eval at ``LUT_EVAL_CASES``."""
    dev = img.device
    gathers, lattices = kernel12_cases(ot)
    images = case_images(torch, img, rng)
    records = {"gather": [
        gather_case(torch, images[src], n, sh, sw, rng, reps,
                    **({"slice": "dic2d"} if src == "rotation" else {}))
        for n, sh, sw, src in gathers], "lattice": []}
    for n, s, d, exact in lattices:
        records["lattice"].append(lattice_case(
            torch, dev, n, s, d, rng, reps, exact=exact,
            **({"slice": "dic2d"} if exact else {})))
        torch.cuda.empty_cache()
    records["lattice3d"] = []
    records["prologue3d"], records["residual3d"] = [], []
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(2**31)))
    for n, s in lattice3d_chunks(torch):
        for kind in ("path", "random"):
            records["lattice3d"].append(phase_lattice3d(
                torch, gen, reps, n=n, s=s, kind=kind))
            torch.cuda.empty_cache()
        pro, res = phase_icgn3d_step(torch, gen, reps, n, (s - 1) // 2)
        records["prologue3d"].append(pro)
        records["residual3d"].append(res)
    records["rerank3d"] = phase_rerank3d(torch, reps)
    records["lut2d"] = phase_lut_eval2d(torch, reps)
    return records


def lattice3d_chunks(torch):
    """(POIs, side) of one ICGN3D1 chunk on the DVC path (r=30, 441 POIs on
    an 80 GB card) and on the SIFT path (r=16, 2,795 POIs)."""
    import opencorr_tpu_torch as ot

    out = []
    for r, n_queue in ((DVC_R, int(np.prod(DVC_GRID[1:4]))),
                       (TORUS_R, int(np.prod(TORUS_GRID[1:4])))):
        icgn = ot.ICGN3D1(r, r, r, device="cuda")
        out.append((icgn.auto_chunk(n_queue), 2 * r + 1))
    return out


def lattice3d_inputs(torch, n, s, d, kind, gen):
    """eblk and the six sample arrays of ``n`` POIs at side ``s``, built on
    the card from ``gen``.  "path": per POI a translation in [0, 1)^3 and a
    displacement gradient of N(0, 0.003) per entry, the samples' local
    coordinates split into floor offsets (D at rest) and fractions as
    ICGN3D1 splits them, so neighbouring samples share offsets; "random":
    uniform offsets in [0, 2D], 2% of them out of range (-1, 2D+1, or -7
    on z, 40 on y, 2D+9 on x), and uniform fractions."""
    dev = torch.device("cuda")
    e = s + 3 + 2 * d
    eblk = torch.round(torch.rand((n, e, e, e), generator=gen, device=dev)
                       * 255)
    offs, fracs = [], []
    if kind == "path":
        t = torch.rand((n, 3), generator=gen, device=dev)
        grad = 0.003 * torch.randn((n, 3, 3), generator=gen, device=dev)
        q = torch.arange(s, device=dev, dtype=torch.float32) - (s - 1) / 2
        qs = (q[:, None, None], q[None, :, None], q[None, None, :])
        for a in range(3):  # z, y, x
            loc = d + t[:, a, None, None, None] + sum(
                grad[:, a, b, None, None, None] * qs[b] for b in range(3))
            fl = torch.floor(loc)
            offs.append(fl.to(torch.int32).contiguous())
            fracs.append((loc - fl).contiguous())
            del loc, fl
    else:
        for far in (-7, 40, 2 * d + 9):
            a = torch.randint(0, 2 * d + 1, (n, s, s, s), generator=gen,
                              device=dev, dtype=torch.int32)
            bad = torch.rand(a.shape, generator=gen, device=dev) < 0.02
            vals = torch.tensor([-1, 2 * d + 1, far], dtype=torch.int32,
                                device=dev)
            a[bad] = vals[torch.randint(0, 3, (int(bad.sum()),),
                                        generator=gen, device=dev)]
            offs.append(a)
            fracs.append(torch.rand(a.shape, generator=gen, device=dev))
    return eblk, offs, fracs


def phase_lattice3d(torch, gen, reps, n, s, kind, d=1):
    """The 3D lattice kernel against its plain version at one ICGN3D1
    chunk's shape, on ``kind`` offsets (``lattice3d_inputs``): equal with
    ``==``, and exactly 0 wherever an offset is out of range."""
    from opencorr_tpu_torch.ops import lattice3d

    eblk, offs, fracs = lattice3d_inputs(torch, n, s, d, kind, gen)
    args = (eblk, *offs, *fracs)
    got = lattice3d.lattice_eval_3d(*args, d_wobble=d)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = lattice3d.lattice_eval_3d_plain(*args, d_wobble=d)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    oor = torch.zeros_like(offs[0], dtype=torch.bool)
    for a in offs:
        oor |= (a < 0) | (a > 2 * d)
    check(bool((got[oor] == 0).all()), "lattice3d: nonzero out of range")
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"lattice3d {n}x{s}^3 ({kind}): not "
          f"bit-equal to the plain version, max|err| {err}")
    del got, want
    in_range = int((~oor).sum())
    nbytes = (eblk.numel() + 7 * n * s ** 3) * 4
    flops = in_range * LATTICE3D_FLOPS
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOP_PER_S * 1e3
    rec = dict(
        shape=[n, s, s, s], d_wobble=d, offsets=kind, max_abs_err=err,
        bit_equal=True,
        ms=cuda_ms(torch, lambda: lattice3d.lattice_eval_3d(
            *args, d_wobble=d), reps),
        plain_ms=plain_ms, library_ms=None,
        library_note="no single PyTorch call computes a tricubic B-spline "
                     "sum over per-POI blocks at per-sample offsets",
        bound_ms=max(tb, tf), bound_by="bytes" if tb >= tf else "operations",
        bytes=nbytes, flops=flops, out_of_range=int(oor.sum()))
    log(json.dumps({"kernel": "lattice_eval_3d", **rec}))
    return rec


def rerank3d_case(n, shape, kind, seed):
    """Inputs of FFTCC3D's exact re-rank, made with numpy from ``seed``:
    float32 windows ``ref_w`` and ``tar_w`` [n, *shape] and a stand-in
    correlation ``flat`` [n, V] whose top 8 are the candidates (values in
    [0, 1), the candidates planted above them).  The target is the
    reference circularly shifted by a shift s in [-2, 2]^3 per POI (T[x +
    s] = R[x]).  ``kind``:
    "random": 8-bit reference, 0-2 grey levels of integral noise on the
    target; candidates s and 7 of its 26 neighbours (a peak's top 8
    cluster so, and shifts near 0 wrap);
    "scattered": as "random", with 8 random candidates;
    "tie": the reference periodic along x (period wx / 2; wx even), no
    noise: s and s + wx / 2 along x tie at the top exactly, beside 6
    random candidates;
    "negative": integral values in [-255, 255], so negative products;
    "cap": integral values in [-a, a] with a = max|R| = max|T| the
    largest that FFTCC3D's range guard passes (v (a^2 / 256 + 1) < 0.99 x
    2^31);
    "half": as "random", with 0.5 added to every 7th voxel of POI 0's
    windows: not integral (fftcc3d drops its result), and rounded half
    to even by both versions."""
    rng = np.random.default_rng(seed)
    wz, wy, wx = shape
    v = wz * wy * wx
    full = (n, *shape)
    if kind == "negative":
        ref = rng.integers(-255, 256, full, dtype=np.int32)
    elif kind == "cap":
        a = math.isqrt(int(256 * (0.99 * 2 ** 31 / v - 1)))
        while v * (a * a / 256 + 1) >= 0.99 * 2 ** 31:
            a -= 1
        ref = rng.integers(-a, a + 1, full, dtype=np.int32)
        ref[:, 0, 0, 0] = a
    elif kind == "tie":
        half = rng.integers(0, 256, (n, wz, wy, wx // 2), dtype=np.int32)
        ref = np.concatenate([half, half], axis=3)
    else:
        ref = rng.integers(0, 256, full, dtype=np.int32)
    shifts = rng.integers(-2, 3, (n, 3))
    tar = np.stack([np.roll(ref[i], tuple(shifts[i]), axis=(0, 1, 2))
                    for i in range(n)])
    if kind in ("random", "scattered", "negative", "half"):
        tar += rng.integers(0, 3, full, dtype=np.int32)
    ref, tar = ref.astype(np.float32), tar.astype(np.float32)
    if kind == "half":
        ref[0].reshape(-1)[::7] += 0.5
        tar[0].reshape(-1)[3::7] += 0.5

    def flat_index(d):
        d = np.mod(d, shape)
        return int((d[0] * wy + d[1]) * wx + d[2])

    near = [d for d in itertools.product((-1, 0, 1), repeat=3) if any(d)]
    flat = rng.random((n, v), dtype=np.float32)
    for i, s in enumerate(shifts):
        if kind == "tie":
            first = [s, s + (0, 0, wx // 2)]
        elif kind == "scattered":
            first = []
        else:
            first = [s] + [s + near[k] for k in rng.permutation(26)]
        cands = list(dict.fromkeys(flat_index(d) for d in first))
        while len(cands) < 8:
            c = int(rng.integers(v))
            if c not in cands:
                cands.append(c)
        flat[i, cands[:8]] = 2 + rng.permutation(8)
    return ref, tar, flat


def ptxas_usage(name, lib):
    """The ptxas lines (registers, shared memory, spills) of the entry
    functions of library ``lib`` whose names hold ``name``, from this
    process's build log, by function."""
    from opencorr_tpu_torch.ops import _kernels

    out, cur = {}, None
    for ln in _kernels.BUILD_LOGS.get(lib, "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = m.group(1) if name in m.group(1) else None
        elif cur and ("registers" in ln or "spill" in ln):
            out.setdefault(cur, []).append(ln.split(": ", 1)[-1].strip())
    return out


def phase_rerank3d(torch, reps):
    """FFTCC3D's re-rank kernel against its plain version at one chunk of
    the DVC path (``RERANK_CHUNK``, 8 candidates), on clustered and on
    scattered candidates (``rerank3d_case``), ``==``; timed beside its
    bound (the two float32 windows read once, the candidates and the
    winners) and the plain version, with the memory it allocates past its
    inputs and, from this process's build, its registers and shared
    memory."""
    from opencorr_tpu_torch.ops import fftcc, rerank3d

    n, *shape = RERANK_CHUNK
    v = int(np.prod(shape))
    recs = []
    for kind, seed in (("random", 31), ("scattered", 32)):
        ref_w, tar_w, flat = (torch.from_numpy(a).cuda()
                              for a in rerank3d_case(n, shape, kind, seed))
        cand = torch.topk(flat, rerank3d.NCAND, dim=1).indices
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = rerank3d.rerank_3d(ref_w, tar_w, cand)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        plain = lambda: fftcc._rerank3d(
            torch.round(ref_w).reshape(n, v).to(torch.int32),
            torch.round(tar_w).reshape(n, v).to(torch.int32), flat, *shape)
        plain()  # its allocations made, so that the second call is timed
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        want = plain()
        end.record()
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"rerank_3d {n}x{shape} ({kind}): "
              "winners differ from the plain version's")
        nbytes = 2 * n * v * 4 + n * rerank3d.NCAND * 8 + n * 8
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        ms = cuda_ms(torch, lambda: rerank3d.rerank_3d(ref_w, tar_w, cand),
                     reps)
        rec = dict(
            shape=[n, *shape], candidates=kind, bit_equal=True,
            max_abs_err=0.0, ms=ms,
            plain_ms=start.elapsed_time(end), library_ms=None,
            library_note="no single PyTorch call scores circular shifts "
                         "of a window",
            bound_ms=tb, bound_by="bytes", share=tb / ms, bytes=nbytes,
            allocated_bytes=extra,
            smem_bytes=rerank3d.smem_bytes(*shape),
            ptxas=ptxas_usage("fftcc3d_rerank", "lattice3d"))
        log(json.dumps({"kernel": "rerank_3d", **rec}))
        recs.append(rec)
        del ref_w, tar_w, flat, cand, got, want
        torch.cuda.empty_cache()
    return recs


def lut_edge_coords(h, w, n, seed):
    """[n] float32 coordinates over and past an h x w image, drawn from
    ``seed``, the first eight the range guard's edge cases: the band just
    below w-2 and h-2, the exact guards, NaN, and exact integers (samples
    0, 2 and 5 in range, 1, 3, 4, 6 and 7 out)."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-2, w + 1, n).astype(np.float32)
    ys = rng.uniform(-2, h + 1, n).astype(np.float32)
    below_w = np.nextafter(np.float32(w - 2), np.float32(0))
    below_h = np.nextafter(np.float32(h - 2), np.float32(0))
    xs[:8] = [below_w, w - 2, 1.0, np.nan, 3.0, below_w, 0.999, 7.0]
    ys[:8] = [5.5, 5.5, 1.0, 4.0, np.nan, below_h, 3.0, h - 2]
    return xs, ys


def lut_eval_case(torch, shape, n, r, seed, device="cuda"):
    """The global-LUT eval's inputs as the refiner makes them, built on
    ``device`` from ``seed``: the [H, W, 4, 4] LUT of a random 8-bit image
    of ``shape`` and [n, (2r+1)^2] float32 sample coordinates of n POIs
    on a step-5 grid from (50, 50), in the grid's order (up to 480 a row,
    as the self-adaptive cell's grid), each under a first-order warp near
    identity (|u|, |v| < 1 px, gradients below 0.01); every 97th POI is
    moved 80 px left, so that some of its samples leave the image."""
    from opencorr_tpu_torch.ops import bspline

    h, w = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *s: torch.rand(s, generator=gen, device=device)
    img = torch.round(rand(h, w) * 255.0)
    lut = bspline.bicubic_prepare(img)
    per_row = min(480, (w - 100) // 5)
    i = torch.arange(n, device=device)
    cx = (50 + 5 * (i % per_row) - 80 * (i % 97 == 0)).to(torch.float32)
    cy = (50 + 5 * (i // per_row)).to(torch.float32)
    side = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    xl = side.repeat(2 * r + 1)[None, :]
    yl = side.repeat_interleave(2 * r + 1)[None, :]
    u, v = ((rand(n) * 2 - 1)[:, None] for _ in range(2))
    ux, uy, vx, vy = ((rand(n) * 0.02 - 0.01)[:, None] for _ in range(4))
    gx = cx[:, None] + xl + (u + ux * xl + uy * yl)
    gy = cy[:, None] + yl + (v + vx * xl + vy * yl)
    return lut, gx.contiguous(), gy.contiguous()


def einsum_eval(torch, lut, xs, ys):
    """The port's first global-LUT eval, the yardstick of kernel 6: a
    gather of [..., 4, 4] coefficients and one einsum, which cuBLAS runs
    as batched 4x4 gemv on the card.  Returns (value, oob)."""
    from opencorr_tpu_torch.ops import bspline

    h, w = lut.shape[:2]
    oob = ((xs < 1) | (ys < 1) | (xs >= w - 2) | (ys >= h - 2)
           | torch.isnan(xs) | torch.isnan(ys))
    xq = torch.nan_to_num(xs, nan=1.0).clamp(1.0, bspline._below(w - 2))
    yq = torch.nan_to_num(ys, nan=1.0).clamp(1.0, bspline._below(h - 2))
    xi = torch.floor(xq).to(torch.int64)
    yi = torch.floor(yq).to(torch.int64)
    xd = xq - xi.to(xq.dtype)
    yd = yq - yi.to(yq.dtype)
    one = torch.ones_like(xd)
    px = torch.stack([one, xd, xd * xd, xd * xd * xd], dim=-1)
    py = torch.stack([one, yd, yd * yd, yd * yd * yd], dim=-1)
    val = torch.einsum("...kl,...k,...l->...", lut[yi, xi], py, px)
    return torch.where(oob, torch.full_like(val, -1.0), val), oob


def lut_eval_bytes(torch, lut, xs, ys, oob):
    """The global-LUT eval's bytes at one launch: (the bound's count, the
    coordinates, value and mask once and each LUT entry the launch touches
    once; the per-sample count, every sample's 64-byte entry from HBM;
    the distinct entries)."""
    w = lut.shape[1]
    at = (torch.floor(ys[~oob]).to(torch.int64) * w
          + torch.floor(xs[~oob]).to(torch.int64))
    distinct = int(torch.unique(at).numel())
    n = xs.numel()
    return n * 13 + distinct * 64, n * 13 + int((~oob).sum()) * 64, distinct


def phase_lut_eval2d(torch, reps):
    """Kernel 6, the global-LUT bicubic eval (``bspline.bicubic_eval``),
    against its plain version at ``LUT_EVAL_CASES`` and on the range
    guard's edge cases, value and mask ``==`` bit for bit (and the mask
    ``==`` the einsum's); timed with its mask and without (the C entry
    with a null mask) beside its byte bound (``lut_eval_bytes``), the
    plain version and the port's first einsum (``library_ms``), with its
    registers from this process's build."""
    from opencorr_tpu_torch.ops import _kernels, bspline

    bits = lambda t: t.view(torch.int32)
    for h, w in ((37, 45), UTN_SIZE):
        lut = bspline.bicubic_prepare(torch.round(torch.rand(
            (h, w), device="cuda") * 255.0))
        xs, ys = (torch.from_numpy(a).cuda()
                  for a in lut_edge_coords(h, w, 4099, seed=h))
        got, oob = bspline.bicubic_eval(lut, xs, ys)
        want, oob_want = bspline.bicubic_eval_plain(lut, xs, ys)
        check(torch.equal(oob, oob_want)
              and torch.equal(oob, einsum_eval(torch, lut, xs, ys)[1])
              and torch.equal(bits(got), bits(want))
              and bool((got[oob] == -1.0).all()),
              f"bicubic_eval edge cases on {h}x{w}: the kernel differs "
              "from its plain version")
    recs = []
    fn = bspline.bind_bicubic(_kernels.load("bicubic2d"))
    for shape, n, r in LUT_EVAL_CASES:
        lut, gx, gy = lut_eval_case(torch, shape, n, r, seed=n)
        s = gx.shape[1]
        before = bspline.bicubic_eval.launches
        got, oob = bspline.bicubic_eval(lut, gx, gy)
        check(bspline.bicubic_eval.launches == before + 1,
              "bicubic_eval did not count its launch")
        plain = lambda: bspline.bicubic_eval_plain(lut, gx, gy)
        plain()  # its allocations made, so that the second call is timed
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        want, oob_want = plain()
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        check(torch.equal(oob, oob_want)
              and torch.equal(bits(got), bits(want)),
              f"bicubic_eval {n}x{s}: the kernel differs from its plain "
              "version")
        del want, oob_want
        torch.cuda.empty_cache()
        library_ms = cuda_ms(torch, lambda: einsum_eval(torch, lut, gx, gy),
                             2, warm=1)
        nbytes, per_sample, distinct = lut_eval_bytes(torch, lut, gx, gy,
                                                      oob)
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        ms = cuda_ms(torch, lambda: bspline.bicubic_eval(lut, gx, gy), reps)
        val = torch.empty_like(gx)
        stream = torch.cuda.current_stream().cuda_stream
        ms_no_mask = cuda_ms(torch, lambda: _kernels.check(fn(
            lut.data_ptr(), shape[0], shape[1], gx.data_ptr(), gy.data_ptr(),
            gx.numel(), val.data_ptr(), None, stream), "bicubic2d"), reps)
        check(torch.equal(bits(val), bits(got)),
              "bicubic_eval without its mask differs")
        rec = dict(
            shape=[n, s], lut_shape=list(shape), bit_equal=True,
            max_abs_err=0.0, oob_samples=int(oob.sum()), ms=ms,
            ms_no_mask=ms_no_mask, plain_ms=plain_ms, library_ms=library_ms,
            library_note="the port's first version: gather + einsum "
                         "(cuBLAS gemv)",
            bound_ms=tb, bound_by="bytes", share=tb / ms, bytes=nbytes,
            per_sample_bytes=per_sample,
            per_sample_bound_ms=per_sample / HBM_BYTES_PER_S * 1e3,
            distinct_pixels=distinct,
            ptxas=ptxas_usage("bicubic", "bicubic2d"))
        log(json.dumps({"kernel": "bicubic_eval", **rec}))
        recs.append(rec)
        del lut, gx, gy, got, oob, val
        torch.cuda.empty_cache()
    return recs


def step_chunk(torch, gen, n, r, margin=8):
    """One ICGN3D1 chunk as the step kernels see it on its path, built on
    the card from ``gen``: the first ``n`` POIs of the path's grid and its
    volume's size (r=30: the DVC path's, ``DVC_GRID`` on ``DVC_SHAPE``;
    r=16: the SIFT path's, ``TORUS_GRID`` on ``TORUS_SHAPE``), seeds within
    a voxel, warps within 0.5% strain and a voxel of translation, windows
    of ``margin`` on the seeds; a speckle reference volume (a 3x3x3 mean of
    noise) with its gradients and a coefficient volume.  Returns ``(wmat,
    xs, ys, zs, wc, coeff, grads, ref)``."""
    import opencorr_tpu_torch as ot
    from opencorr_tpu_torch.ops import gradient

    dev = torch.device("cuda")
    grid, dims = {DVC_R: (DVC_GRID, DVC_SHAPE),
                  TORUS_R: (TORUS_GRID, TORUS_SHAPE)}[r]
    rnd = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    pois = ot.poi_grid_3d(*grid, device="cpu")
    cen = [a[:n].to(dev) for a in (pois.x, pois.y, pois.z)]
    u = 2 * rnd(3, n) - 1
    wmat = torch.eye(4, device=dev).repeat(n, 1, 1)
    wmat[:, :3, :3] += 0.01 * rnd(n, 3, 3) - 0.005
    wmat[:, :3, 3] = u.T + 0.6 * rnd(n, 3) - 0.3
    side = 2 * (r + margin) + 1
    wc = [torch.clamp(torch.floor(c + uu).to(torch.int32) - (r + margin), 0,
                      d - side) for c, uu, d in zip(cen, u, dims[::-1])]
    coeff = 320 * rnd(*dims) - 30
    ref = (torch.nn.functional.avg_pool3d(
        torch.randn(dims, generator=gen, device=dev)[None, None], 3, 1, 1)
        [0, 0] * 40 + 128)
    grads = [getattr(gradient, f"gradient_{a}_3d")(ref).contiguous()
             for a in "xyz"]
    return wmat, *cen, wc, coeff, grads, ref


def box_bytes(lo, hi, dims):
    """float32 bytes of the box spanned by the corners ``lo`` (per axis,
    the least) to ``hi`` (the greatest end), clipped to ``dims``."""
    return 4 * int(np.prod([min(int(h), d) - max(int(l), 0)
                            for l, h, d in zip(lo, hi, dims)]))


def phase_icgn3d_step(torch, gen, reps, n, r, margin=8, d=1):
    """ICGN3D1's step kernels against their plain versions at one chunk
    (``step_chunk``): the prologue ``==`` on all nine outputs, then kernel
    3 on them; the residual, on values near the reference subsets with one
    failing POI, without and with z guards (which fail some POIs): fail
    flags equal, ZNSSD within 1e-5 relative and each of the 12 sums within
    2e-5 of the sum of its terms' magnitudes (the card test's tolerance:
    the kernels add in another order).  Each timed, with its least time:
    the prologue writes six [N, S] arrays and the blocks and reads the
    coefficient volume under the windows; the residual reads the values
    once and the four volumes under the subsets (the boxes the windows and
    the subsets span).  Returns a record for each kernel."""
    from opencorr_tpu_torch.ops import icgn3d_step, lattice3d

    wmat, xs, ys, zs, wc, coeff, grads, ref_vol = step_chunk(
        torch, gen, n, r, margin)
    s1 = 2 * r + 1
    s = s1 ** 3
    kw = dict(rx=r, ry=r, rz=r, margin=margin, d_wobble=d)
    pro = lambda: icgn3d_step.lattice_prologue_3d(wmat, xs, ys, zs, *wc,
                                                  coeff, **kw)
    got = pro()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = icgn3d_step.lattice_prologue_3d_plain(wmat, xs, ys, zs, *wc,
                                                 coeff, **kw)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    names = ("pdz", "pdy", "pdx", "fz", "fy", "fx", "eblk", "doomed",
             "wobble")
    for name, g, w in zip(names, got, want):
        check(torch.equal(g, w), f"icgn3d prologue {n}x{s1}^3: {name} not "
              "bit-equal to the plain version")
    del want
    side = 2 * (r + margin) + 1
    nbytes = (6 * n * s + got[6].numel()) * 4 + box_bytes(
        [int(w.min()) for w in wc[::-1]],
        [int(w.max()) + side for w in wc[::-1]], coeff.shape)
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    pro_rec = dict(
        shape=[n, s1, s1, s1], margin=margin, d_wobble=d, max_abs_err=0.0,
        bit_equal=True, doomed=int(got[7].sum()), wobble=int(got[8].sum()),
        ms=cuda_ms(torch, pro, reps), plain_ms=plain_ms, library_ms=None,
        library_note="no single PyTorch call warps, guards and places "
                     "samples on a lattice",
        bound_ms=tb, bound_by="bytes", bytes=nbytes)
    log(json.dumps({"kernel": "lattice_prologue_3d", **pro_rec}))
    tval = lattice3d.lattice_eval_3d(got[6], *got[:6],
                                     d_wobble=d).reshape(n, s)
    del got
    torch.cuda.empty_cache()

    side_ref = icgn3d_step.reference_3d(*grads, ref_vol, xs, ys, zs, rx=r,
                                        ry=r, rz=r)
    check(side_ref.sd is None, "the card's reference side kept sd")
    _, zm, sd = icgn3d_step._subsets_3d(side_ref, r, r, r)
    full = dataclasses.replace(side_ref, zm=zm, sd=sd)
    # values near the reference subsets, so that the sums are a residual's
    tval = zm[torch.randperm(n, generator=gen, device="cuda")] * 0.3 + (
        zm * 0.7 + 128 + 2 * torch.randn(zm.shape, generator=gen,
                                         device="cuda"))
    tval[3, s // 3] = -1.0  # a failing POI
    t64 = tval.double()
    tz = t64 - t64.mean(1, keepdim=True)
    err = (tz * (side_ref.rn.double() / tz.norm(dim=1))[:, None]
           - zm).float()
    del t64, tz
    scale = torch.bmm(sd.abs(), err.abs()[:, :, None])[:, :, 0].double()
    del err
    # guards that fail the POIs of the lowest z layer translated down and
    # those of the highest translated up by more than half a voxel
    guarded = (float(zs.min()) - r, float(zs.max()) + r + 0.5)
    rec = None
    for guard in (None, guarded):
        rkw = dict(rx=r, ry=r, rz=r, z_guard=guard)
        res = lambda: icgn3d_step.residual_3d(tval, None, side_ref, wmat,
                                              zs, **rkw)
        got, again = res(), res()
        start.record()
        want = icgn3d_step.residual_3d_plain(tval, None, full, wmat, zs,
                                             **rkw)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"icgn3d residual {n}x{s1}^3: two runs differ")
        check(torch.equal(got[0], want[0]), f"icgn3d residual {n}x{s1}^3: "
              "fail flags differ from the plain version's")
        ok = ~want[0]
        check(bool(want[0][3]) and int(ok.sum()) >= n // 4,
              f"icgn3d residual: {int(want[0].sum())} of {n} POIs failed")
        zn_gap = float(((got[1] - want[1]).abs() / want[1].abs())[ok].max())
        gap = (got[2] - want[2]).double().abs()[ok]
        num_gap = float((gap / scale[ok]).max())
        check(zn_gap <= 1e-5 and num_gap <= 2e-5, f"icgn3d residual "
              f"{n}x{s1}^3: ZNSSD {zn_gap}, sums {num_gap} (relative)")
        if guard is None:
            corner = torch.stack((side_ref.z0, side_ref.y0, side_ref.x0))
            nbytes = n * s * 4 + 4 * box_bytes(
                corner.min(1).values.tolist(),
                (corner.max(1).values + s1).tolist(), ref_vol.shape)
            tb = nbytes / HBM_BYTES_PER_S * 1e3
            rec = dict(
                shape=[n, s1, s1, s1], max_abs_err=float(gap.max()),
                znssd_rel_gap=zn_gap, sums_rel_gap=num_gap,
                failed=int(want[0].sum()), ms=cuda_ms(torch, res, reps),
                plain_ms=plain_ms, library_ms=None,
                library_note="no single PyTorch call reduces the residual "
                             "and its 12 steepest-descent sums",
                bound_ms=tb, bound_by="bytes", bytes=nbytes)
        else:
            rec["guarded"] = dict(failed=int(want[0].sum()),
                                  znssd_rel_gap=zn_gap, sums_rel_gap=num_gap)
        del got, again, want
    log(json.dumps({"kernel": "residual_3d", **rec}))
    del full, zm, sd, tval, scale
    torch.cuda.empty_cache()
    return pro_rec, rec


def dvc_wrappers():
    """Kernel 3 and ICGN3D1's step kernels: the wrappers each 3D path
    counts and times a launch."""
    from opencorr_tpu_torch.ops import icgn3d_step, lattice3d

    return (lattice3d.lattice_eval_3d, icgn3d_step.lattice_prologue_3d,
            icgn3d_step.residual_3d)


def start_counts(wrappers):
    """Count and time every launch of ``wrappers`` from now on."""
    for fn in wrappers:
        fn.launches = 0
        fn.shapes = {}
        fn.events = []


def read_counts(wrappers):
    """Launches and ``event_ms`` records of ``wrappers`` since
    ``start_counts``; stops the counting."""
    return ({fn.__name__: fn.launches for fn in wrappers},
            {fn.__name__: event_ms(fn) for fn in wrappers})


def random_rotations(rng, n):
    rots = []
    for _ in range(n):
        a = rng.standard_normal(3)
        a /= np.linalg.norm(a)
        b = rng.standard_normal(3)
        b -= (b @ a) * a
        b /= np.linalg.norm(b)
        rots.append(np.stack([a, b, np.cross(a, b)]).reshape(9))
    return np.float32(rots)


def desc3d_read_bytes(torch, vol_shape, starts, tab, crop, scale):
    """Bytes of the layer volume that the descriptor histogram must read:
    the six neighbours of every in-sphere voxel with a non-zero weight (the
    voxels whose gradients it forms), each voxel once over all keypoints."""
    from opencorr_tpu_torch.ops import desc3d

    dev = tab.device
    r2 = desc3d._radii(scale)[0]
    cz, cy, cx = (2 * c + 1 for c in crop)
    dz, dy, dx = vol_shape
    seen = torch.zeros(dz * dy * dx, dtype=torch.bool, device=dev)
    o = [torch.arange(n + 2, device=dev) for n in (cz, cy, cx)]
    zs, ys, xs = slice(0, cz), slice(cz, cz + cy), slice(cz + cy, None)
    for lo in range(0, starts.shape[0], 64):
        t, s = tab[lo:lo + 64], starts[lo:lo + 64].long()
        w, p2 = t[:, 0], t[:, 2]
        # the kernel's sphere and weight tests, in its order of roundings
        d2 = p2[:, zs, None, None] + (p2[:, None, ys, None]
                                      + p2[:, None, None, xs])
        wv = w[:, zs, None, None] * (w[:, None, ys, None]
                                     * w[:, None, None, xs])
        act = (d2 <= r2) & (wv != 0)
        del d2, wv
        read = torch.zeros((t.shape[0], cz + 2, cy + 2, cx + 2),
                           dtype=torch.bool, device=dev)
        mid = slice(1, -1)
        for sl in ((slice(0, -2), mid, mid), (slice(2, None), mid, mid),
                   (mid, slice(0, -2), mid), (mid, slice(2, None), mid),
                   (mid, mid, slice(0, -2)), (mid, mid, slice(2, None))):
            read[(slice(None),) + sl] |= act
        zz, yy, xx = (s[:, i, None] + o[i] for i in range(3))
        flat = ((zz[:, :, None, None] * dy + yy[:, None, :, None]) * dx
                + xx[:, None, None, :])
        seen[flat[read]] = True
    return 4 * int(seen.sum())


def desc3d_case(torch, vol, crop, scale, k, rng, reps, near_faces,
                units=(1.0, 1.0, 1.0), volume="noise"):
    """One descriptor-histogram launch of ``k`` keypoints at ``crop``
    against its plain version on every keypoint, timed, with its bound.
    ``near_faces``: a quarter of the keypoints sit within 3 voxels of a
    face, off centre in their clamped windows; the rest sit in centred
    windows, as on the main path.  The plain version runs once, timed, in
    chunks of ``DESC_PLAIN_CHUNK`` keypoints (its gradient windows take
    4.7 MB a keypoint at crop 36); each keypoint's rows of S depend only on
    its own inputs."""
    from opencorr_tpu_torch.ops import desc3d

    dev = vol.device
    shape = tuple(vol.shape)
    coords = [rng.integers(c + 1, d - c - 1, k) for c, d in zip(crop, shape)]
    for j in range(k // 4 if near_faces else 0):
        a = rng.integers(0, 3)
        coords[a][j] = rng.choice([rng.integers(0, 3),
                                   shape[a] - 1 - rng.integers(0, 3)])
    zi, yi, xi = (torch.from_numpy(c.astype(np.int32)).to(dev)
                  for c in coords)
    rot = torch.from_numpy(random_rotations(rng, k)).to(dev)
    starts, tab = desc3d.prepare_tables(shape, xi, yi, zi, crop=crop,
                                        scale=scale, unit_xyz=units)
    kw = dict(crop=crop, scale=scale, unit_xyz=units)

    def plain(counts=None):
        return torch.cat([desc3d.descriptor_hist_plain(
            vol, starts[lo:lo + DESC_PLAIN_CHUNK],
            tab[lo:lo + DESC_PLAIN_CHUNK], rot[lo:lo + DESC_PLAIN_CHUNK],
            counts=counts, **kw) for lo in range(0, k, DESC_PLAIN_CHUNK)])

    got = desc3d.descriptor_hist(vol, starts, tab, rot, **kw)
    counts = {}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = plain(counts)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    err = float((got - want).abs().max())
    tol = 1e-5 * float(want.abs().max())
    check(err <= tol, f"descriptor_hist {k} keypoints, crop {crop}: "
          f"max|err| {err} > {tol}")
    del want
    nbytes = desc3d_read_bytes(torch, shape, starts, tab, crop, scale) + 4 * (
        tab.numel() + rot.numel() + starts.numel() + got.numel())
    flops = (counts["sphere_voxels"] * desc3d.FLOPS_SPHERE_VOXEL
             + counts["live_voxels"] * desc3d.FLOPS_LIVE_VOXEL)
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOP_PER_S * 1e3
    # the kernel's split of a keypoint's box into z-bands (oc_desc3d_hist)
    cz = 2 * crop[0] + 1
    band = -(-cz // min(cz, -(-DESC_TARGET_BLOCKS // k)))
    rec = dict(
        shape=[k] + [2 * c + 1 for c in crop], scale=scale,
        launch="x".join(map(str, (k, *crop))),
        units=list(units), volume=volume,
        max_abs_err=err, tolerance=tol, z_bands=-(-cz // band),
        ms=cuda_ms(torch, lambda: desc3d.descriptor_hist(
            vol, starts, tab, rot, **kw), reps),
        plain_ms=plain_ms, library_ms=None,
        library_note="no single PyTorch call computes this histogram",
        bound_ms=max(tb, tf), bound_by="bytes" if tb >= tf
        else "operations", bytes=nbytes, flops=flops,
        sphere_voxels=counts["sphere_voxels"],
        live_voxels=counts["live_voxels"])
    log(json.dumps({"kernel": "descriptor_hist", **rec}))
    return rec


def phase_desc3d(torch, ot, rng, reps, k=64):
    """The descriptor-histogram kernel against its plain version at every
    launch shape of the Torus-size path (``TORUS_DESC``: each layer's
    crop, scale and voxel pitch at the reference's and the target's kept
    counts), on a 96x100x120 volume Gaussian-blurred at the layer's sigma
    in voxels (as the path's pyramid layers are: neighbouring voxels then
    share their face and tent bins); on octave 0 also ``k`` keypoints of
    white noise, some near the faces (the kernel splits each keypoint's
    box into z-bands to fill the card), and the reference's count on the
    noise."""
    from scipy.ndimage import gaussian_filter

    from opencorr_tpu_torch.ops import sift3d

    layers = ot.SIFT3D(device="cuda")._plan_layers(TORUS_SHAPE)
    shape = (96, 100, 120)
    noise = np.float32(128 + 40 * rng.standard_normal(shape))
    vol = torch.from_numpy(noise).cuda()
    recs = []
    for index, counts in TORUS_DESC.items():
        lay = layers[index]
        units = tuple(float(u) for u in lay.units)
        crop = sift3d._sphere_crop(64, lay.scale, units)
        blurred = torch.from_numpy(np.float32(gaussian_filter(
            noise, lay.scale / units[0]))).cuda()
        if lay.octave == 0:
            recs.append(desc3d_case(torch, vol, crop, lay.scale, k, rng,
                                    reps, near_faces=True, units=units))
            recs.append(desc3d_case(torch, vol, crop, lay.scale, counts[0],
                                    rng, max(2, reps // 3), near_faces=False,
                                    units=units))
        for k_path in counts:
            recs.append(desc3d_case(torch, blurred, crop, lay.scale, k_path,
                                    rng, max(2, reps // 3), near_faces=False,
                                    units=units, volume="blurred"))
        del blurred
    return recs


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


def phase_main(torch, ot, ref, tar, center, device_ms, tmpdir):
    from opencorr_tpu_torch.ops import gather2d, lattice2d

    pois = ot.poi_grid_2d((30, 30), 100, 300, 2)
    check(pois.n == 30000, "main grid size")
    csv = os.path.join(tmpdir, "main.csv")
    run_path(torch, ot, ref, tar, pois, "cuda", csv)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    wrappers = (gather2d.gather_windows_2d, lattice2d.lattice_eval_2d)
    for fn in wrappers:
        fn.launches = 0
        fn.shapes = {}
    seeded, refined, out, ms, stats = run_path(torch, ot, ref, tar, pois,
                                               "cuda", csv)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    kernel_ms = {fn.__name__: device_sum(fn, device_ms[fn.__name__])
                 for fn in wrappers}
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
        icgn_branches=stats, launches=launches, kernel_device_ms=kernel_ms,
        stage_ms=ms, peak_mem_mb=peak / 2**20, csv_lines=n_lines)
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
    return res, launches, ot.table_to_numpy(refined)


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
    return seeded, refined, out, ms, dict(icgn.stats), dict(fftcc.stats)


def phase_dvc(torch, ot, ref, tar, checked, tmpdir):
    from opencorr_tpu_torch.ops import rerank3d

    pois = ot.poi_grid_3d(*DVC_GRID)
    n = pois.n
    check(n == int(np.prod(DVC_GRID[1:4])), "DVC grid size")
    run_dvc(torch, ot, ref, tar, pois.map(lambda a: a[:512]), "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = (*dvc_wrappers(), rerank3d.rerank_3d)
    start_counts(wrappers)
    seeded, refined, out, ms, stats, fstats = run_dvc(
        torch, ot, ref, tar, pois, "cuda", out_dir=tmpdir)
    launches, kernel_ms = read_counts(wrappers)
    peak = torch.cuda.max_memory_allocated()
    for name, v in launches.items():
        check(v > 0, f"the DVC path launched {name} no time")
        checked_launches(kernel_ms, name, checked[name], "the DVC path")

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
        kernel_event_ms=kernel_ms, stage_ms=ms, peak_mem_mb=peak / 2**20,
        csv_lines=n_lines,
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
    check(rec.shape == (n, 8) and dims == DVC_SHAPE[::-1], "matrix bin")
    return res, launches, ot.table_to_numpy(seeded), ot.table_to_numpy(refined)


def phase_dvc_cpu_agreement(torch, ot, ref, tar, r=16, n_pois=64):
    """The DVC modules on cuda and on cpu on a 64-POI subset at r=16, every
    8th seed strained by 0.2 along z (the whole-chunk exact fallback)."""
    devices = card, host = ("cuda", "cpu")
    full = ot.poi_grid_3d(*DVC_GRID, device="cpu")
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


def sift_pair(torch, shape, seed, device, pad=16):
    """An 8-bit volume pair [z, y, x] built with torch on ``device``: pores
    (``PORES``) over a weak speckle, all band-limited, and the target the
    reference translated by ``TORUS_UVW`` through a Fourier phase shift of
    the padded base (exact for a band-limited periodic base; the padding
    keeps the wrapped border out of the crop).  Grey levels are then
    soft-clipped to 128 +- 110 by a tanh, pointwise, so the target stays the
    exact translation of the clipped continuous field, and no voxel is
    near 0 (IC-GN reads a sample below 0 as out of range, code -3)."""
    dev = torch.device(device)
    full = [d + 2 * pad for d in shape]
    gen = torch.Generator(device=dev).manual_seed(seed)
    kz = torch.fft.fftfreq(full[0], device=dev)[:, None, None]
    ky = torch.fft.fftfreq(full[1], device=dev)[None, :, None]
    kx = torch.fft.rfftfreq(full[2], device=dev)[None, None, :]
    k2 = kz * kz + ky * ky + kx * kx
    dims = torch.tensor(full, device=dev)
    sig_all = PORES["sigmas"]
    n_pore = int(np.prod(full) / PORES["spacing"] ** 3 / len(sig_all))
    spec = None
    for sig in sig_all:
        spikes = torch.zeros(full, device=dev)
        ctr = (torch.rand((n_pore, 3), generator=gen, device=dev)
               * dims).long()
        sign = torch.where(torch.rand(n_pore, generator=gen, device=dev)
                           < 0.5, -1.0, 1.0)
        # a spike of this weight peaks at PORES["amp"] once blurred
        peak = PORES["amp"] * (2 * math.pi) ** 1.5 * sig ** 3
        for j in range(4):
            off = (torch.randint(-4, 5, (n_pore, 3), generator=gen,
                                 device=dev) if j else 0)
            amp = sign * peak * (0.3 + 0.7 * torch.rand(
                n_pore, generator=gen, device=dev)) * (1.0 - 0.2 * j)
            p = (ctr + off) % dims
            spikes.index_put_((p[:, 0], p[:, 1], p[:, 2]), amp,
                              accumulate=True)
        part = torch.fft.rfftn(spikes) * torch.exp(
            -2 * math.pi ** 2 * sig ** 2 * k2)
        del spikes
        spec = part if spec is None else spec + part
    noise = torch.fft.rfftn(torch.randn(full, generator=gen, device=dev))
    noise *= torch.exp(-2 * math.pi ** 2 * PORES["speckle_sigma"] ** 2 * k2)
    std = float(torch.fft.irfftn(noise, s=full).std())
    spec += noise * (PORES["speckle_std"] / std)
    del noise
    u, v, w = TORUS_UVW
    shift = torch.exp(-2j * math.pi * (kz * w + ky * v + kx * u))
    crop = tuple(slice(pad, pad + d) for d in shape)
    out = []
    for sp in (spec, spec * shift):
        vol = torch.fft.irfftn(sp, s=full)[crop]
        vol = 128.0 + 110.0 * torch.tanh(vol / 110.0)
        out.append(torch.round(vol).contiguous())
        del vol
    return out


def run_sift_slice(torch, ot, ref, tar, pois, device, r=TORUS_R,
                   csv_path=None):
    """SIFT3D -> FeatureAffine3D -> ICGN3D1 on ``pois``; per-stage ms
    (``profile_torch_dvc.py``'s warm-up; phase 7 runs the path through
    ``examples/dvc.py``)."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    ms = {}
    t0 = time.perf_counter()
    sift = ot.SIFT3D(device=device)
    sift.set_images(ref, tar)
    sift.prepare()
    sift.compute()
    sync()
    ms["sift3d"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fa = ot.FeatureAffine3D(r, r, r, device=device)
    fa.set_keypoint_pair(sift.ref_matched_kp, sift.tar_matched_kp)
    fa.prepare()
    seeded = fa.compute(pois)
    sync()
    ms["feature_affine3d"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    icgn = ot.ICGN3D1(r, r, r, 0.001, 10, device=device)
    icgn.set_images(ref, tar)
    icgn.prepare()
    sync()
    ms["icgn3d1_prepare"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out = icgn.compute(seeded)
    sync()
    ms["icgn3d1"] = (time.perf_counter() - t0) * 1e3
    if csv_path is not None:
        t0 = time.perf_counter()
        ot.save_table_3d(csv_path, out)
        ms["save_table_3d"] = (time.perf_counter() - t0) * 1e3
    return sift, seeded, out, ms, dict(icgn.stats)


def write_pois_csv(path, table):
    """A POI CSV (x, y, z under a header) of ``table``'s coordinates, as
    ``examples/dvc.run`` reads one."""
    np.savetxt(path, np.stack(table.coords_numpy(), -1), delimiter=",",
               header="x,y,z", comments="", fmt="%.1f")


def checked_launches(kernel_ms, name, checked, what):
    """Fail unless every launch shape of ``name`` in ``kernel_ms`` (an
    ``event_ms`` or ``device_sum`` record per kernel) is one of
    ``checked``."""
    got = set(kernel_ms[name]["by_shape"])
    check(got <= checked, f"{what}: {name} launched at "
          f"{sorted(got - checked)}, which phase 2 did not check")


def phase_sift(torch, ot, checked, tmpdir):
    """The feature-seeded DVC path through ``examples/dvc.run``'s
    ``sift_icgn1`` workload with SIFT3D's capped device path
    (``sift_backend="device"``: SIFT3D -> FeatureAffine3D(16) -> ICGN3D1(16) ->
    save_table_3d, save_matrix_bin_3d) on the Torus-size pair built on the
    card and a POI CSV, after a warm-up on a sub-volume; kernels 3 and 4
    and the step kernels counted and timed per launch, every launch shape
    one of ``checked`` (phase 2's)."""
    from opencorr_tpu_torch.examples import dvc
    from opencorr_tpu_torch.ops import desc3d

    t0 = time.perf_counter()
    ref, tar = sift_pair(torch, TORUS_SHAPE, seed=3, device="cuda")
    torch.cuda.synchronize()
    synth_ms = (time.perf_counter() - t0) * 1e3
    pois = ot.poi_grid_3d(*TORUS_GRID, device="cpu")
    n = pois.n
    check(n == TORUS_GRID[1] * TORUS_GRID[2] * TORUS_GRID[3],
          f"Torus grid size {n}")
    csv_in = os.path.join(tmpdir, "torus_pois.csv")
    write_pois_csv(csv_in, pois)
    # warm-up on a sub-volume
    sub = (slice(0, 160), slice(0, 128), slice(0, 192))
    warm_csv = os.path.join(tmpdir, "warm_pois.csv")
    write_pois_csv(warm_csv, ot.poi_grid_3d((40, 40, 40), 4, 2, 3, 30,
                                            device="cpu"))
    dvc.run("sift_icgn1", ref[sub].contiguous(), tar[sub].contiguous(),
            warm_csv, os.path.join(tmpdir, "warm"), "cuda",
            sift_backend="device")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = (desc3d.descriptor_hist, *dvc_wrappers())
    start_counts(wrappers)
    prefix = os.path.join(tmpdir, "torus")
    info = {}
    out, timer = dvc.run("sift_icgn1", ref, tar, csv_in, prefix, "cuda",
                         sift_backend="device", stats=info)
    launches, kernel_ms = read_counts(wrappers)
    peak = torch.cuda.max_memory_allocated()
    for name, v in launches.items():
        check(v > 0, f"the SIFT path launched {name} no time")
    stage_ms = {k: v * 1e3 for k, v in zip(timer.names, timer.seconds)}
    for k in ("save_table_3d", "save_matrix_bin_3d"):
        stage_ms[k] = info[f"{k}_s"] * 1e3

    layers = info["sift3d_layers"]
    cap_hits = [st for st in layers if st["candidates"] > st["k_e"]
                or st["oriented"] > st["k_d"]]
    mk1, mk2 = info["sift_matches"]
    med = np.median(mk2 - mk1, axis=0) if len(mk1) else np.full(3, np.nan)
    fa = ot.table_to_numpy(info["seeded"])
    t = ot.table_to_numpy(out)
    zn = t["r"][:, 3]
    conv = zn > 0.9
    u, v, w = TORUS_UVW
    du = np.abs(t["p"][conv, 0] - u)
    dv = np.abs(t["p"][conv, 4] - v)
    dw = np.abs(t["p"][conv, 8] - w)
    with open(f"{prefix}_sift_icgn1.csv") as f:
        n_lines = sum(1 for _ in f)
    rec, dims = ot.load_matrix_bin_3d(f"{prefix}_sift_icgn1.bin")
    res = dict(
        volume=list(TORUS_SHAPE), pois=n, r=TORUS_R, synth_ms=synth_ms,
        ref_kp=info["keypoints"][0], tar_kp=info["keypoints"][1],
        matches=int(len(mk1)), median_match_dxyz=[float(x) for x in med],
        matches_within_1=float(np.mean(np.all(np.abs(
            mk2 - mk1 - np.array(TORUS_UVW)) <= 1.0, axis=1))),
        cap_hits=cap_hits,
        fa3d_codes=info["feature_affine3d_codes"],
        fa3d_mean_abs_duvw=[float(np.abs(fa["p"][fa["r"][:, 3] == 0, col]
                                         - x).mean())
                            for col, x in ((0, u), (4, v), (8, w))],
        converged_frac=float(conv.mean()), mean_abs_du=float(du.mean()),
        mean_abs_dv=float(dv.mean()), mean_abs_dw=float(dw.mean()),
        max_abs_duvw=float(max(du.max(), dv.max(), dw.max())),
        codes={str(c): int((zn == c).sum()) for c in (-1.0, -2.0, -3.0,
                                                       -4.0, -5.0)},
        mean_iterations=float(t["r"][conv, 4].mean()),
        icgn_stats=info["icgn_stats"], writer=info["writer"],
        launches=launches, kernel_event_ms=kernel_ms, stage_ms=stage_ms,
        peak_mem_mb=peak / 2**20, csv_lines=n_lines)
    for st in layers:
        log(json.dumps({"sift_layer": st}))
    log(json.dumps({"sift_path": res}))
    for name in launches:
        checked_launches(kernel_ms, name, checked[name], "the SIFT path")
    check(all(abs(m - x) <= 1.0 for m, x in zip(med, TORUS_UVW)),
          f"median matched displacement {med} vs {TORUS_UVW}")
    check(np.isfinite(t["p"][conv]).all(), "non-finite results")
    check(res["converged_frac"] >= 0.9,
          f"SIFT path converged {res['converged_frac']}")
    check(max(res["mean_abs_du"], res["mean_abs_dv"], res["mean_abs_dw"])
          < 0.01, f"SIFT path displacement error {res['mean_abs_du']}, "
          f"{res['mean_abs_dv']}, {res['mean_abs_dw']}")
    check(n_lines == n + 1, f"Torus csv lines {n_lines}")
    check(rec.shape == (n, 8) and dims == TORUS_SHAPE[::-1],
          f"Torus matrix bin {rec.shape} {dims}")
    check(info["writer"] == "native", f"table writer {info['writer']}")
    return res, launches


def phase_sift_cpu_agreement(torch, ot, shape=(64, 64, 72), r=TORUS_R):
    """SIFT3D, FeatureAffine3D and ICGN3D1 on cuda and on cpu on one small
    pair.  FeatureAffine3D gets the cpu's matches on both devices and makes
    the same draws from its seed on both; ICGN3D1 starts from the cpu's
    FeatureAffine3D table on both."""
    devices = card, host = ("cuda", "cpu")
    ref, tar = sift_pair(torch, shape, seed=5, device="cpu")
    vols = {host: (ref, tar), card: (ref.cuda(), tar.cuda())}
    res = {}
    sifts = {}
    for dev in devices:
        s = ot.SIFT3D(pyramid_backend="device", device=dev)
        s.set_images(*vols[dev])
        s.compute()
        sifts[dev] = s
    sets = {dev: set(map(tuple, np.concatenate(
        [sifts[dev].ref_matched_kp, sifts[dev].tar_matched_kp], 1).tolist()))
        for dev in devices}
    res.update(
        kp={dev: [sifts[dev].ref_kp_count, sifts[dev].tar_kp_count]
            for dev in devices},
        matches={dev: len(sets[dev]) for dev in devices},
        matches_only_on={dev: len(sets[dev] - sets[o]) for dev, o in
                         ((card, host), (host, card))},
        fused_layers=sum(st["fused"] for st in sifts[card].layer_stats))
    mk1, mk2 = sifts[host].ref_matched_kp, sifts[host].tar_matched_kp
    grid = ((20, 20, 20), (shape[2] - 40) // 10 + 1,
            (shape[1] - 40) // 10 + 1, (shape[0] - 40) // 10 + 1, 10)
    seeded, outs = {}, {}
    for dev in devices:
        fa = ot.FeatureAffine3D(r, r, r, device=dev)
        fa.set_keypoint_pair(mk1, mk2)
        seeded[dev] = ot.table_to_numpy(fa.compute(ot.poi_grid_3d(
            *grid, device=dev)))
    s0 = seeded[host]
    fa_codes_equal = np.array_equal(seeded[card]["r"][:, 3], s0["r"][:, 3])
    fa_dp = float(np.abs(seeded[card]["p"] - s0["p"]).max())
    for dev in devices:
        t = ot.table_from_numpy_3d(s0["x"], s0["y"], s0["z"], s0["p"],
                                   s0["r"], s0["e"], s0["sr"], device=dev)
        m = ot.ICGN3D1(r, r, r, 0.001, 10, device=dev)
        m.set_images(*vols[dev])
        m.prepare()
        outs[dev] = ot.table_to_numpy(m.compute(t))
    zc, zp = outs[card]["r"][:, 3], outs[host]["r"][:, 3]
    codes_equal = np.array_equal(np.where(zc < 0, zc, 1),
                                 np.where(zp < 0, zp, 1))
    both = (zc > 0) & (zp > 0)
    duvw = np.abs(outs[card]["p"][both][:, [0, 4, 8]]
                  - outs[host]["p"][both][:, [0, 4, 8]])
    res.update(shape=list(shape), pois=int(len(zc)),
               fa3d_codes_equal=fa_codes_equal, fa3d_max_abs_dp=fa_dp,
               fa3d_ok=int((s0["r"][:, 3] == 0).sum()),
               icgn_codes_equal=codes_equal, converged=int(both.sum()),
               max_abs_duvw=float(duvw.max()) if both.any() else None)
    log(json.dumps({"sift_cuda_vs_cpu": res}))
    check(res["fused_layers"] > 0, "the small pair reached kernel 4 on no "
          "layer")
    check(res["kp"][card] == res["kp"][host], "keypoint counts differ")
    check(sets[card] == sets[host], "matched sets differ")
    check(fa_codes_equal and fa_dp <= 1e-4,
          f"FeatureAffine3D differs: codes {fa_codes_equal}, dp {fa_dp}")
    check(res["fa3d_ok"] > 0, "FeatureAffine3D fitted no POI")
    check(codes_equal and both.any() and res["max_abs_duvw"] <= 1e-3,
          f"ICGN3D1 differs: codes {codes_equal}, {res['max_abs_duvw']}")
    return res


# --- the stereo scene (float64, independent of the port's Calibration) ----


def rodrigues64(rx, ry, rz):
    """Axis-angle vector -> float64 rotation matrix."""
    v = np.array([rx, ry, rz], np.float64)
    th = np.linalg.norm(v)
    if th == 0.0:
        return np.eye(3)
    k = v / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * (kx @ kx)


def stereo_camera(intr, extr, offset=(0, 0)):
    """One camera as a dict: intrinsics (the principal point moved by
    ``offset`` (x0, y0), the corner of a crop), rotation R, translation T."""
    c = {k: 0.0 for k in ("fx", "fy", "fs", "cx", "cy", "k1", "k2", "k3",
                          "k4", "k5", "k6", "p1", "p2")}
    c.update(intr)
    c["cx"] -= offset[0]
    c["cy"] -= offset[1]
    e = dict(dict(tx=0.0, ty=0.0, tz=0.0, rx=0.0, ry=0.0, rz=0.0), **extr)
    c["R"] = rodrigues64(e["rx"], e["ry"], e["rz"])
    c["T"] = np.array([e["tx"], e["ty"], e["tz"]], np.float64)
    return c


def _distort(c, x, y):
    """oc_calibration.cpp:136-159 on normalized image coordinates."""
    r2 = x * x + y * y
    rad = ((1 + c["k1"] * r2 + c["k2"] * r2 ** 2 + c["k3"] * r2 ** 3)
           / (1 + c["k4"] * r2 + c["k5"] * r2 ** 2 + c["k6"] * r2 ** 3))
    return (x * rad + 2 * c["p1"] * x * y + c["p2"] * (r2 + 2 * x * x),
            y * rad + c["p1"] * (r2 + 2 * y * y) + 2 * c["p2"] * x * y)


def project64(c, pts):
    """World points [N, 3] -> distorted sensor coordinates [N, 2]."""
    xc = pts @ c["R"].T + c["T"]
    x, y = _distort(c, xc[:, 0] / xc[:, 2], xc[:, 1] / xc[:, 2])
    return np.stack([c["fx"] * x + c["fs"] * y + c["cx"],
                     c["fy"] * y + c["cy"]], -1)


def pixel_rays(c, u, v):
    """Sensor coordinates -> (origin [3], unit directions [N, 3]) of the
    rays they see, the distortion inverted by fixed-point iteration."""
    yd = (v - c["cy"]) / c["fy"]
    xd = (u - c["cx"] - c["fs"] * yd) / c["fx"]
    x, y = xd, yd
    for _ in range(50):
        dx, dy = _distort(c, x, y)
        x, y = x + (xd - dx), y + (yd - dy)
        if max(np.abs(xd - dx).max(), np.abs(yd - dy).max()) < 1e-15:
            break
    d = np.stack([x, y, np.ones_like(x)], -1) @ c["R"]  # R^T d, row-wise
    return -c["R"].T @ c["T"], d / np.linalg.norm(d, axis=1, keepdims=True)


def on_plane(c, u, v, point, normal):
    """The points of the plane (point, normal) seen at sensor (u, v)."""
    o, d = pixel_rays(c, np.asarray(u, np.float64), np.asarray(v, np.float64))
    t = ((point - o) @ normal) / (d @ normal)
    return o + d * t[:, None]


class StereoScene:
    """The speckled plate of the stereo path, seen by ``cams`` (two
    ``stereo_camera`` dicts) in images of ``size`` [H, W]; the plate spans
    the view-1 rectangle ``plate`` (x0, y0, x1, y1) on the plane.  Renders
    each view by inverse mapping (pixel -> undistorted ray -> plane ->
    material point -> texture) and gives the true matches of view-1
    points."""

    def __init__(self, cams, size, plate, seed):
        from scipy.ndimage import gaussian_filter, spline_filter

        self.cams, self.size = cams, size
        c1, c2 = cams
        h, w = size
        # depth along camera 1's central ray where the x parallax is
        # STEREO_PARALLAX[0] (bisection; the parallax grows with depth)
        o, d = pixel_rays(c1, np.array([w / 2.0]), np.array([h / 2.0]))
        par = lambda s: project64(c2, o + d * s)[0, 0] - w / 2.0
        lo, hi = 50.0, 5000.0
        if not (par(lo) - STEREO_PARALLAX[0]) * (par(hi) - STEREO_PARALLAX[0]) \
                < 0:
            raise AssertionError("no depth gives the example's parallax")
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if (par(mid) - STEREO_PARALLAX[0]) * (par(lo) - STEREO_PARALLAX[0]) \
                    > 0:
                lo = mid
            else:
                hi = mid
        self.x0 = (o + d * lo)[0]
        axes = [cam["R"].T @ np.array([0.0, 0.0, 1.0]) for cam in cams]
        n = -(axes[0] + axes[1])
        self.normal = n / np.linalg.norm(n)
        e1 = np.array([1.0, 0.0, 0.0]) - self.normal[0] * self.normal
        self.e1 = e1 / np.linalg.norm(e1)
        self.e2 = np.cross(self.normal, self.e1)
        self.shift = np.array(STEREO_SHIFT, np.float64)
        # the plate's texture: cells on the plane over the view-1 rectangle
        px, py = np.meshgrid(np.linspace(plate[0], plate[2], 9),
                             np.linspace(plate[1], plate[3], 9))
        st = self.plane_coords(on_plane(c1, px.ravel(), py.ravel(), self.x0,
                                        self.normal))
        self.lo = st.min(0)
        cells = np.ceil((st.max(0) - self.lo) / STEREO_CELL_MM).astype(int) + 1
        rng = np.random.default_rng(seed)
        tex = gaussian_filter(rng.standard_normal((cells[1], cells[0])),
                              STEREO_SPECKLE)
        tex = tex / tex.std() * 28.0 + 128.0
        self.tex = spline_filter(tex, order=3)

    def plane_coords(self, pts):
        """Points on the reference plane -> (s, t) mm along (e1, e2)."""
        rel = pts - self.x0
        return np.stack([rel @ self.e1, rel @ self.e2], -1)

    def moved(self, pts):
        """Reference points -> where the motion takes them."""
        return self.x0 + self.shift + (1.0 + STEREO_STRETCH) * (pts - self.x0)

    def render(self, view, moved=False):
        """One 8-bit view [H, W] of the reference (or moved) plate."""
        from scipy.ndimage import map_coordinates

        h, w = self.size
        out = np.empty((h, w), np.uint8)
        band = 128
        for r0 in range(0, h, band):
            vv, uu = np.mgrid[r0:min(r0 + band, h), 0:w].astype(np.float64)
            pts = on_plane(self.cams[view], uu.ravel(), vv.ravel(),
                           self.x0 + (self.shift if moved else 0.0),
                           self.normal)
            if moved:  # the material point now at pts
                pts = self.x0 + (pts - self.x0 - self.shift) / (
                    1.0 + STEREO_STRETCH)
            st = (self.plane_coords(pts) - self.lo) / STEREO_CELL_MM
            val = map_coordinates(self.tex, [st[:, 1], st[:, 0]], order=3,
                                  mode="constant", cval=128.0,
                                  prefilter=False)
            out[r0:r0 + band] = np.clip(np.round(val), 0, 255).reshape(
                vv.shape).astype(np.uint8)
        return out

    def truth(self, pts):
        """View-1 points [N, 2] -> dict of true view-2 matches r2, moved
        positions t1 and t2 [N, 2], reference 3D points and 3D
        displacements [N, 3]."""
        c1, c2 = self.cams
        ref = on_plane(c1, pts[:, 0], pts[:, 1], self.x0, self.normal)
        tar = self.moved(ref)
        return dict(r2=project64(c2, ref), t1=project64(c1, tar),
                    t2=project64(c2, tar), ref3d=ref, disp=tar - ref)


def epipolar_reach(cams, src, dst, parallax=STEREO_PARALLAX):
    """Distance (px) along view 2's epipolar line of each view-1 point
    ``src`` from the projection of the parallax estimate (x, y; constants
    or per point) to the true match ``dst``, and its distance from the line
    (F from the undistorted cameras, as EpipolarSearch uses it)."""
    c1, c2 = cams
    k = lambda c: np.array([[c["fx"], c["fs"], c["cx"]], [0, c["fy"], c["cy"]],
                            [0, 0, 1.0]])
    t = c2["T"]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    f = np.linalg.inv(k(c2)).T @ tx @ c2["R"] @ np.linalg.inv(k(c1))
    line = np.concatenate([src, np.ones((len(src), 1))], 1) @ f.T
    slope, icp = -line[:, 0] / line[:, 1], -line[:, 2] / line[:, 1]
    ex = src[:, 0] + parallax[0]
    ey = src[:, 1] + parallax[1]
    xv = (slope * (ey - icp) + ex) / (slope * slope + 1)
    xd = (slope * (dst[:, 1] - icp) + dst[:, 0]) / (slope * slope + 1)
    along = (xd - xv) * np.sqrt(1 + slope * slope)
    off = np.abs(slope * dst[:, 0] - dst[:, 1] + icp) / np.sqrt(
        1 + slope * slope)
    return along, off


def triangulate64(cams, p1, p2):
    """Linear triangulation in float64 of sensor points [N, 2] in both
    views (the distortion inverted as in ``pixel_rays``)."""
    rows = []
    for c, p in zip(cams, (p1, p2)):
        o, d = pixel_rays(c, p[:, 0], p[:, 1])
        rows.append((o, d))
    # closest point of the two rays
    (o1, d1), (o2, d2) = rows
    w0 = o1 - o2
    a, b, cc = (d1 * d1).sum(1), (d1 * d2).sum(1), (d2 * d2).sum(1)
    dd, e = (d1 * w0).sum(1), (d2 * w0).sum(1)
    den = a * cc - b * b
    s = (b * e - cc * dd) / den
    t = (a * e - b * dd) / den
    return 0.5 * ((o1 + d1 * s[:, None]) + (o2 + d2 * t[:, None]))


def displacement_bound(cams, pts, truth, px=STEREO_TOL_PX):
    """Mean over POIs of the largest change of the triangulated 3D
    displacement when each of the six matched coordinates (r2, t1, t2)
    moves by ``px``: the sum over coordinates of |d disp / d coordinate| *
    px, by central differences."""
    base = dict(r2=truth["r2"], t1=truth["t1"], t2=truth["t2"])

    def disp(m):
        return (triangulate64(cams, m["t1"], m["t2"])
                - triangulate64(cams, pts.astype(np.float64), m["r2"]))

    total = np.zeros(len(pts))
    for key in ("r2", "t1", "t2"):
        for axis in (0, 1):
            moved = []
            for sign in (1.0, -1.0):
                m = {k: v.copy() for k, v in base.items()}
                m[key][:, axis] += sign * px
                moved.append(disp(m))
            total += np.linalg.norm(moved[0] - moved[1], axis=1) / 2.0
    return float(total.mean())


def reconstruction_bound(cams, pts, r2, px=STEREO_TOL_PX):
    """Mean over POIs of the largest change of the triangulated point when
    each of the two matched view-2 coordinates moves by ``px``: the sum of
    |d point / d coordinate| * px, by central differences."""
    p1 = pts.astype(np.float64)
    total = np.zeros(len(pts))
    for axis in (0, 1):
        moved = []
        for sign in (1.0, -1.0):
            m = r2.copy()
            m[:, axis] += sign * px
            moved.append(triangulate64(cams, p1, m))
        total += np.linalg.norm(moved[0] - moved[1], axis=1) / 2.0
    return float(total.mean())


def stereo_grid_points(grid):
    (x0, y0), nx, ny, step = grid
    gx, gy = np.meshgrid(x0 + step * np.arange(nx), y0 + step * np.arange(ny))
    return np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)


def stereo_inputs(size=STEREO_SIZE, grid=STEREO_GRID, seed=11):
    """Four 8-bit views (ref1, ref2, tar1, tar2) of ``size`` [H, W] through
    the example's cameras, the view-1 POIs [N, 2] float32 on ``grid``,
    their truth and the scene (a plate STEREO_PLATE_PX wider than the
    grid).  Smaller sizes see the sensors' top-left corners."""
    cams = [stereo_camera(*c) for c in STEREO_CAMS]
    pts = stereo_grid_points(grid)
    m = STEREO_PLATE_PX
    plate = (pts[:, 0].min() - m, pts[:, 1].min() - m, pts[:, 0].max() + m,
             pts[:, 1].max() + m)
    scene = StereoScene(cams, size, plate, seed)
    views = [scene.render(0), scene.render(1), scene.render(0, True),
             scene.render(1, True)]
    return views, pts, scene.truth(pts.astype(np.float64)), scene


def stereo_calibrations(ot, device, offset=(0, 0)):
    """The port's Calibration pair of the example's cameras, the principal
    points moved by ``offset`` (x0, y0), the corner of a crop."""
    out = []
    for intr, extr in STEREO_CAMS:
        i = dict(intr, cx=intr["cx"] - offset[0], cy=intr["cy"] - offset[1])
        out.append(ot.Calibration(ot.CameraIntrinsics(**i),
                                  ot.CameraExtrinsics(**extr), device=device))
    return out


# --- the surface of the reconstruction example ----------------------------

# The reconstruction example (examples/reconstruction_epipolar.py) fits a
# bilinear parallax to SIFT matches and searches only +-6 px around it.  A
# plane seen through the GT4 cameras (19 degrees apart) has a parallax that
# no bilinear model follows: the best fit leaves 74% of a full-size grid's
# truths more than 6 px along the epipolar line from it.  So the surface is
# curved: every view-1 pixel's ray meets it where the view-2 x parallax is
# RECON_PARALLAX_X, a bilinear function of the view-1 position about the
# GT4 sensor's centre (a, b, c of p = a (x - 960) + b (y - 600) + c; the
# best fit of a plane at the stereo scene's depth), 378-395 mm deep.
RECON_PARALLAX_X = (-0.0056, -0.0054, -44.5)
RECON_MARGIN = 100  # view-1 pixels of surface past each side of the image
RECON_MAP_STEP = 4  # pixel step of the forward map that view 2 inverts


def recon_grid(size):
    """The example's POI grid of a view of ``size`` [H, W]."""
    h, w = size
    return ((100, 100), (w - 200) // 5, (h - 200) // 5, 5)


class ReconScene:
    """The reconstruction example's specimen, seen by ``cams`` (two
    ``stereo_camera`` dicts) in views of ``size`` [H, W] (a smaller size
    sees the sensors' top-left corners).  The speckle (STEREO_SPECKLE
    cells of one view-1 pixel, 128 +- 28 grey levels) lies on the surface
    at its view-1 pixel coordinates, so view 1 shows it as it is; view 2
    is rendered by inverse mapping (pixel -> the view-1 point whose
    surface point it sees, by fixed-point iteration on the forward map)."""

    def __init__(self, cams, size, seed):
        from scipy.ndimage import gaussian_filter, spline_filter

        self.cams, self.size = cams, size
        h, w = size
        m = RECON_MARGIN
        rng = np.random.default_rng(seed)
        tex = gaussian_filter(rng.standard_normal((h + 2 * m, w + 2 * m)),
                              STEREO_SPECKLE)
        self.raw = tex / tex.std() * 28.0 + 128.0
        self.tex = spline_filter(self.raw, order=3)
        # the forward map view 1 -> view 2 on a coarse grid of the extended
        # image (linear interpolation between its nodes errs by about 5e-5
        # px: the map's second derivatives are about 2e-5 px/px^2)
        st = RECON_MAP_STEP
        yy, xx = np.mgrid[-m:h + m + st:st, -m:w + m + st:st].astype(
            np.float64)
        self.fwd = self.match(np.stack([xx.ravel(), yy.ravel()], -1)).T \
            .reshape((2,) + xx.shape)

    def match(self, pts, iters=12):
        """View-1 points [N, 2] -> their view-2 positions [N, 2]: the depth
        along each view-1 ray where the x parallax is RECON_PARALLAX_X
        (secant steps from the stereo scene's depth)."""
        c1, c2 = self.cams
        a, b, c = RECON_PARALLAX_X
        out = np.empty_like(pts, dtype=np.float64)
        for lo in range(0, len(pts), 1 << 20):
            x, y = (pts[lo:lo + (1 << 20), k].astype(np.float64)
                    for k in (0, 1))
            o, d = pixel_rays(c1, x, y)
            target = x + a * (x - 960.0) + b * (y - 600.0) + c
            s = np.full(len(x), 387.0)
            proj = lambda s: project64(c2, o + d * s[:, None])
            p = proj(s)
            for _ in range(iters):
                slope = proj(s + 1.0)[:, 0] - p[:, 0]
                s = s - (p[:, 0] - target) / slope
                p = proj(s)
            out[lo:lo + len(x)] = p
        return out

    def render(self, view):
        """One 8-bit view [H, W]."""
        from scipy.ndimage import map_coordinates

        h, w = self.size
        m = RECON_MARGIN
        if view == 0:
            val = self.raw[m:m + h, m:m + w]
        else:
            vv, uu = np.mgrid[0:h, 0:w].astype(np.float64)
            u, v = uu.ravel(), vv.ravel()
            x1, y1 = u - RECON_PARALLAX_X[2], v + 40.0  # a first guess
            top = [n - 1 for n in self.fwd.shape[1:]]
            for _ in range(5):
                at = [np.clip((y1 + m) / RECON_MAP_STEP, 0, top[0]),
                      np.clip((x1 + m) / RECON_MAP_STEP, 0, top[1])]
                x1 = x1 + (u - map_coordinates(self.fwd[0], at, order=1))
                y1 = y1 + (v - map_coordinates(self.fwd[1], at, order=1))
            val = map_coordinates(self.tex, [y1 + m, x1 + m], order=3,
                                  mode="nearest", prefilter=False
                                  ).reshape(h, w)
        return np.clip(np.round(val), 0, 255).astype(np.uint8)


def recon_inputs(size=STEREO_SIZE, seed=13):
    """The two 8-bit views of the reconstruction scene at ``size``, the
    example's view-1 POIs [N, 2] float32, their true view-2 matches and the
    scene."""
    cams = [stereo_camera(*c) for c in STEREO_CAMS]
    scene = ReconScene(cams, size, seed)
    pts = stereo_grid_points(recon_grid(size))
    return ([scene.render(0), scene.render(1)], pts,
            scene.match(pts.astype(np.float64)), scene)


def recon_sift_matches(scene, n, seed):
    """``n`` exact matches (view-1 points and their view-2 positions) on
    the view-1 image, float32, in place of SIFT2D's."""
    h, w = scene.size
    rng = np.random.default_rng(seed)
    kp = rng.uniform((40, 40), (w - 40, h - 40), (n, 2))
    return kp.astype(np.float32), scene.match(kp).astype(np.float32)


def epipolar_reach_bilinear(cams, src, dst, cx, cy, size):
    """``epipolar_reach`` about the bilinear parallax estimate (cx, cy) of
    EpipolarSearch.set_parallax (centred at the view's W//2, H//2): the
    distance (px) along view 2's epipolar line from the estimate's
    projection to the true match, for each view-1 point."""
    h, w = size
    ex = src[:, 0] + cx[0] * (src[:, 0] - w // 2) + cx[1] * (
        src[:, 1] - h // 2) + cx[2]
    ey = src[:, 1] + cy[0] * (src[:, 0] - w // 2) + cy[1] * (
        src[:, 1] - h // 2) + cy[2]
    return epipolar_reach(cams, src, dst, (ex - src[:, 0], ey - src[:, 1]))[0]


# The crop of phases 10 and 11 [y0, x0, h, w] and its POIs (view-1 grid
# points whose view-2 and moved matches stay inside the crop).
STEREO_CROP = (400, 760, 288, 352)


def stereo_crop(views, pts, step=1):
    y0, x0, h, w = STEREO_CROP
    crops = [np.ascontiguousarray(v[y0:y0 + h, x0:x0 + w]) for v in views]
    inside = ((pts[:, 0] >= x0 + 60) & (pts[:, 0] < x0 + w - 30)
              & (pts[:, 1] >= y0 + 90) & (pts[:, 1] < y0 + h - 30))
    local = (pts[inside] - np.array([x0, y0], np.float32))[::step]
    return crops, local, (x0, y0)


def phase_stereo_cpu_agreement(torch, ot, views, pts):
    """SIFT2D, FeatureAffine2D, EpipolarSearch, ICGN2D2 and reconstruct on
    cuda and on cpu on a crop of the scene (the cameras' principal points
    moved to the crop's corner).  Each module after the first starts from
    the cpu's results on both devices."""
    devices = card, host = ("cuda", "cpu")
    crops, local, offset = stereo_crop(views, pts, step=2)
    res = dict(crop=list(STEREO_CROP), pois=int(len(local)))
    sifts = {}
    for dev in devices:
        s = ot.SIFT2D(device=dev)
        s.set_images(crops[0], crops[2])
        s.compute()
        sifts[dev] = s
    kp = {dev: [(st["image"], st["candidates"], st["keypoints"],
                 st["instances"]) for st in sifts[dev].octave_stats]
          for dev in devices}
    sets = {dev: set(map(tuple, np.concatenate(
        [sifts[dev].ref_matched_kp, sifts[dev].tar_matched_kp], 1).tolist()))
        for dev in devices}
    res.update(sift_octaves_equal=kp[card] == kp[host],
               matches={dev: len(sets[dev]) for dev in devices},
               matches_only_on={dev: len(sets[dev] - sets[o]) for dev, o in
                                ((card, host), (host, card))})
    mk = (sifts[host].ref_matched_kp, sifts[host].tar_matched_kp)
    fa = {}
    for dev in devices:
        m = ot.FeatureAffine2D(16, 16, device=dev)
        m.set_keypoint_pair(*mk)
        fa[dev] = ot.table_to_numpy(m.compute(ot.new_table_2d(
            local[:, 0], local[:, 1], device=dev)))
    fa_codes = np.array_equal(fa[card]["r"][:, 2], fa[host]["r"][:, 2])
    fa_dp = float(np.abs(fa[card]["p"] - fa[host]["p"]).max())
    epi, icgn = {}, {}
    for dev in devices:
        cams = stereo_calibrations(ot, dev, offset)
        e = ot.EpipolarSearch(*cams, device=dev)
        e.set_parallax(STEREO_PARALLAX)
        e.set_search(*STEREO_SEARCH)
        e.create_icgn(STEREO_EPI_R, STEREO_EPI_R, 0.05, 10)
        e.set_images(crops[0], crops[1])
        e.prepare()
        epi[dev] = ot.table_to_numpy(e.compute(ot.new_table_2d(
            local[:, 0], local[:, 1], device=dev)))
    e0 = epi[host]
    for dev in devices:
        m = ot.ICGN2D2(16, 16, 0.001, 10, device=dev)
        m.set_images(crops[0], crops[1])
        m.prepare()
        icgn[dev] = ot.table_to_numpy(m.compute(ot.table_from_numpy(
            e0["x"], e0["y"], e0["p"], e0["r"], e0["e"], e0["sr"],
            device=dev)))
    i0 = icgn[host]
    v2 = np.stack([i0["x"] + i0["p"][:, 0], i0["y"] + i0["p"][:, 6]], -1)
    rec = {}
    for dev in devices:
        c1, c2 = stereo_calibrations(ot, dev, offset)
        h, w = crops[0].shape
        c1.prepare(h, w)
        c2.prepare(h, w)
        sv = ot.Stereovision(c1, c2)
        sv.prepare()
        rec[dev] = sv.reconstruct(local, v2).cpu().numpy()

    def agree(a, b, col_z, cols):
        za, zb = a["r"][:, col_z], b["r"][:, col_z]
        codes = np.array_equal(np.where(za < 0, za, 1), np.where(zb < 0, zb,
                                                                   1))
        both = (za > 0) & (zb > 0)
        d = np.abs(a["p"][both][:, cols] - b["p"][both][:, cols])
        return codes, float(d.max()) if both.any() else None, int(both.sum())

    ec, ed, en = agree(epi[card], e0, 2, [0, 6])
    ic, idd, inn = agree(icgn[card], i0, 2, [0, 6])
    res.update(fa2d_codes_equal=fa_codes, fa2d_max_abs_dp=fa_dp,
               fa2d_ok=int((fa[host]["r"][:, 2] == 0).sum()),
               epipolar_codes_equal=ec, epipolar_max_abs_duv=ed,
               epipolar_converged=en, icgn2d2_codes_equal=ic,
               icgn2d2_max_abs_duv=idd, icgn2d2_converged=inn,
               reconstruct_max_abs_mm=float(np.abs(rec[card]
                                                   - rec[host]).max()))
    log(json.dumps({"stereo_cuda_vs_cpu": res}))
    n_match = max(res["matches"][host], 1)
    check(res["sift_octaves_equal"], "SIFT2D octave counts differ")
    check(max(res["matches_only_on"].values()) <= 0.01 * n_match,
          f"SIFT2D matched sets differ: {res['matches_only_on']}")
    check(fa_codes and fa_dp <= 1e-4, f"FeatureAffine2D differs: codes "
          f"{fa_codes}, dp {fa_dp}")
    check(res["fa2d_ok"] > 0, "FeatureAffine2D fitted no POI")
    check(ec and en > 0 and ed <= 1e-3, f"EpipolarSearch differs: {ec} {ed}")
    check(ic and inn > 0 and idd <= 1e-3, f"ICGN2D2 differs: {ic} {idd}")
    check(res["reconstruct_max_abs_mm"] <= 1e-3,
          f"reconstruct differs by {res['reconstruct_max_abs_mm']} mm")
    return res


def phase_stereo(torch, ot, views, pts, truth, scene, device_ms, tmpdir):
    """The stereo path at GT4's size: the example's four phases, the
    triangulation, save_table_2ds and stereo strain, after a warm-up on the
    crop; kernels 1 and 2 counted per launch shape in the timed run, their
    time estimated from phase 2's device time (``device_sum``)."""
    from opencorr_tpu_torch.examples import stereo_3d_dic_epipolar_sift as ex
    from opencorr_tpu_torch.examples import stereo_strain
    from opencorr_tpu_torch.ops import gather2d, lattice2d

    imgs = [ot.Image2D.from_array(v) for v in views]
    crops, local, offset = stereo_crop(views, pts)
    warm, _ = ex.run(*[ot.Image2D.from_array(c) for c in crops], local,
                     *stereo_calibrations(ot, "cuda", offset), device="cuda")
    stereo_strain.run(warm, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = (gather2d.gather_windows_2d, lattice2d.lattice_eval_2d)
    for fn in wrappers:
        fn.launches = 0
        fn.shapes = {}
    csv = os.path.join(tmpdir, "stereo.csv")
    info = {}
    out, times = ex.run(*imgs, pts, *stereo_calibrations(ot, "cuda"),
                        out_path=csv, stats=info, device="cuda")
    strained, strain_s = stereo_strain.run(out, device="cuda")
    launches = {fn.__name__: fn.launches for fn in wrappers}
    kernel_ms = {fn.__name__: device_sum(fn, device_ms[fn.__name__])
                 for fn in wrappers}
    peak = torch.cuda.max_memory_allocated()
    for name, v in launches.items():
        check(v > 0, f"the stereo path launched {name} no time")
    stage_ms = {k: v * 1e3 for k, v in times.items()}
    stage_ms["strain"] = strain_s * 1e3

    t = ot.table_to_numpy(strained)
    zn = t["r"][:, :3]
    conv = zn > 0.9
    pos = {}
    for k, cols, c in (("r2", [3, 4], 0), ("t1", [5, 6], 1),
                       ("t2", [7, 8], 2)):
        pos[k] = float(np.abs(t["r"][conv[:, c]][:, cols]
                              - truth[k][conv[:, c]]).mean())
    ok = conv.all(1)
    err3 = np.linalg.norm(t["p"][ok] - truth["disp"][ok], axis=1)
    bound = displacement_bound(scene.cams, pts[ok], {
        k: v[ok] for k, v in truth.items()})
    reach = {name: [float(x) for x in (a.min(), a.max())] for name, a in (
        ("r1r2", epipolar_reach(scene.cams, pts.astype(np.float64),
                                truth["r2"])[0]),
        ("t1t2", epipolar_reach(scene.cams, np.round(truth["t1"]),
                                truth["t2"])[0]))}
    with open(csv) as f:
        n_lines = sum(1 for _ in f)
    # a cap passed: more candidates than k_raw, or more refined keypoints
    # or orientation instances than k_kp (the octave's buffers grow)
    caps = [st for st in info["sift2d_octaves"]
            if st["candidates"] > st["k_raw"] or st["keypoints"] > st["k_kp"]
            or st["instances"] > st["k_kp"]]
    res = dict(
        size=list(STEREO_SIZE), pois=int(len(pts)),
        plane_point_mm=[float(x) for x in scene.x0], reach_px=reach,
        converged_frac={p: float(conv[:, c].mean()) for c, p in enumerate(
            ("r1r2", "r1t1", "r1t2"))},
        mean_abs_position_px=pos, mean_disp_err_mm=float(err3.mean()),
        disp_err_bound_mm=bound, matches=info["matches"],
        fa2d_codes=info["feature_affine2d_codes"], cap_hits=caps,
        codes={str(c): int((zn == c).sum()) for c in (-1.0, -2.0, -3.0,
                                                       -4.0, -5.0)},
        strain_computed=int((t["e"] != 0).any(1).sum()),
        icgn_stats={k: info[k] for k in ("icgn2d1", "icgn2d2",
                                         "epipolar_icgn")},
        launches=launches, kernel_device_ms=kernel_ms, stage_ms=stage_ms,
        peak_mem_mb=peak / 2**20, csv_lines=n_lines)
    for st in info["sift2d_octaves"]:
        log(json.dumps({"sift2d_octave": st}))
    log(json.dumps({"stereo_path": res}))
    # phase 2 checked kernel 1 at the epipolar shape this run launched
    side = 2 * STEREO_EPI_R + 1
    epi = {s for s in kernel_ms["gather_windows_2d"]["by_shape"]
           if s.endswith(f"x{side}x{side}")}
    want = {f"{epipolar_windows(ot)}x{side}x{side}"}
    check(epi == want, f"epipolar gathers {sorted(epi)}, phase 2 checked "
          f"{sorted(want)}")
    check(n_lines == len(pts) + 1, f"stereo csv lines {n_lines}")
    check(np.isfinite(t["p"][ok]).all(), "non-finite displacements")
    for p, f in res["converged_frac"].items():
        check(f >= 0.9, f"stereo {p} converged {f}")
    for k, e in pos.items():
        check(e < STEREO_TOL_PX, f"stereo {k} mean position error {e}")
    check(res["mean_disp_err_mm"] < bound,
          f"3D displacement error {res['mean_disp_err_mm']} >= {bound}")
    return res, launches, info["sift_matches"]


# --- the planar example suite (examples/dic_2d.py) ---------------------------


def dic2d_launch_shapes(ot):
    """The kernel shapes the planar suite launches at the reference sizes,
    from the port's own rules: each refining workload's grid is one chunk
    (``base.budget_chunk``); a windowed refine gathers its subsets
    (2r+1)^2, its D=2 blocks (2r+7)^2 and correction blocks (2r+15)^2 for
    the correction cap max(256, n/32), and evaluates D=2 at the chunk and,
    in IC-GN, at its compacted tail ceil(n/4) past ``_COMPACT_MIN``, and
    D=6 at the cap; FFTCC2D gathers (2r)^2 windows.  The self-adaptive
    refine launches no kernel (plain subsets, the global LUT).  Returns
    ({(n, sh, sw)}, {(n, s, s, D)})."""
    from opencorr_tpu_torch.examples import dic_2d
    from opencorr_tpu_torch.models import base
    from opencorr_tpu_torch.ops import icgn

    gathers, lattices = set(), set()
    for wl in ("fftcc_icgn1", "fftcc_iclm1", "fftcc_nr1", "sift_icgn2",
               "sift_iclm2"):
        _, nx, ny, _ = dic_2d.GRIDS[wl]
        r = dic_2d.RADIUS[wl]
        chunk = base.budget_chunk(ot.ICGN2D1(r, r, device="cpu").chunk_size,
                                  r, r)
        n = nx * ny
        check(n <= chunk, f"{wl}: {n} POIs are more than one chunk")
        s = 2 * r + 1
        cap = min(n, max(256, n // 32))
        gathers |= {(n, s, s), (n, s + 7, s + 7), (cap, s + 15, s + 15)}
        lattices |= {(n, s, s, 2), (cap, s, s, 6)}
        if wl.startswith("fftcc"):
            gathers.add((n, 2 * r, 2 * r))
        if "icgn" in wl and n >= icgn._COMPACT_MIN:
            lattices.add((-(-n // 4), s, s, 2))
    return gathers, lattices


def warped_pair(shape, a, t, seed):
    """8-bit (ref, tar, fwd) of shape [H, W]: one Gaussian-filtered noise
    field (sigma 1.5, 128 +- 28 grey levels, as phase 3's), the target
    showing the reference's texture at x' = A (X - c) + c + t (c the image
    centre), bicubic; ``fwd`` maps reference points [N, 2] to the
    target."""
    from scipy.ndimage import gaussian_filter, map_coordinates

    h, w = shape
    pad = 24
    rng = np.random.default_rng(seed)
    base = gaussian_filter(rng.standard_normal((h + 2 * pad, w + 2 * pad)),
                           1.5)
    base = base / base.std() * 28.0 + 128.0
    ref = np.clip(np.round(base[pad:pad + h, pad:pad + w]), 0, 255)
    c = np.array([(w - 1) / 2.0, (h - 1) / 2.0])
    a = np.asarray(a, np.float64)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    q = (np.stack([xx - c[0] - t[0], yy - c[1] - t[1]], -1)
         @ np.linalg.inv(a).T + c)
    tar = map_coordinates(base, [q[..., 1] + pad, q[..., 0] + pad], order=3,
                          mode="nearest")
    tar = np.clip(np.round(tar), 0, 255)

    def fwd(pts):
        return (np.asarray(pts, np.float64) - c) @ a.T + c + np.asarray(t)

    return ref.astype(np.uint8), tar.astype(np.uint8), fwd


def dic2d_inputs(ref, tar, center):
    """The suite's three pairs: phase 3's for the oht_cfrp workloads, the
    rotation pair and the utn-size stretched pair, each (ref, tar, fwd)."""
    def main_fwd(pts):
        pts = np.asarray(pts, np.float64)
        u, v = true_uv(pts[:, 0], pts[:, 1], center)
        return pts + np.stack([u, v], -1)

    th = np.deg2rad(ROT_DEG)
    rot = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
    return {"main": (ref, tar, main_fwd),
            "rotation": warped_pair(ROT_SIZE, rot, ROT_SHIFT, seed=4),
            "utn": warped_pair(UTN_SIZE, [[1.0 + UTN_STRETCH, 0.0],
                                          [0.0, 1.0]], UTN_SHIFT, seed=5)}


DIC2D_PAIR = {"fftcc_icgn1": "main", "fftcc_iclm1": "main",
              "fftcc_nr1": "main", "sift_icgn2": "rotation",
              "sift_iclm2": "rotation", "self_adaptive": "utn"}


def uv_error(t, fwd):
    """Converged fraction (ZNCC > 0.9) and mean |u - u_true|, |v - v_true|
    over the converged POIs of a numpy table, at its (moved) positions."""
    zn = t["r"][:, 2]
    conv = zn > 0.9
    xy = np.stack([t["x"], t["y"]], -1).astype(np.float64)
    truth = fwd(xy) - xy
    du = np.abs(t["p"][conv, 0] - truth[conv, 0])
    dv = np.abs(t["p"][conv, 6] - truth[conv, 1])
    return (float(conv.mean()), float(du.mean()) if conv.any() else None,
            float(dv.mean()) if conv.any() else None)


def phase_dic2d_cpu_agreement(torch, ot, pairs):
    """ICLM2D1, NR2D1, ICLM2D2 and the self-adaptive ICGN2D1 and ICLM2D1 on
    cuda and on cpu from the same seeds: every 40th POI of the oht grid
    (FFTCC on the cpu, every 8th seed moved 3 px: the D=6 correction),
    every 150th of the rotation grid and every 128th of the utn grid
    seeded from the true field (u, v rounded), the utn POIs with radii
    10-25.  FFTCC's seeds of every 8th POI are moved 3 px for ICLM2D1 (the
    D=6 correction).  Codes equal, u/v within 1e-3 px."""
    from opencorr_tpu_torch.examples import dic_2d

    devices = card, host = ("cuda", "cpu")
    res = {}

    def grid_pts(wl, step):
        g = ot.poi_grid_2d(*dic_2d.GRIDS[wl], device="cpu")
        return g.x.numpy()[::step], g.y.numpy()[::step]

    def seeds_from_truth(x, y, fwd, sr=None):
        xy = np.stack([x, y], -1).astype(np.float64)
        uv = np.round(fwd(xy) - xy)
        n = len(x)
        p = np.zeros((n, 12), np.float32)
        p[:, 0], p[:, 6] = uv[:, 0], uv[:, 1]
        sr = np.zeros((n, 2), np.float32) if sr is None else sr
        return (x, y, p, np.zeros((n, 6), np.float32),
                np.zeros((n, 3), np.float32), sr)

    ref, tar, _ = pairs["main"]
    x, y = grid_pts("fftcc_icgn1", 40)
    f = ot.FFTCC2D(16, 16, device=host)
    f.set_images(ref, tar)
    s = ot.table_to_numpy(f.compute(ot.new_table_2d(x, y, device=host)))
    main_seed = tuple(s[k] for k in ("x", "y", "p", "r", "e", "sr"))
    moved = tuple(a.copy() for a in main_seed)
    moved[2][::8, 0] += 3.0
    rref, rtar, rfwd = pairs["rotation"]
    rx, ry = grid_pts("sift_icgn2", 150)
    ang = np.deg2rad(ROT_DEG)
    rot_seed = seeds_from_truth(rx, ry, rfwd)
    rot_seed[2][:, [1, 2, 7, 8]] = [np.cos(ang) - 1, -np.sin(ang),
                                    np.sin(ang), np.cos(ang) - 1]
    uref, utar, ufwd = pairs["utn"]
    ux, uy = grid_pts("self_adaptive", 128)
    sr = np.random.default_rng(9).integers(10, 26, (len(ux), 2)).astype(
        np.float32)
    utn_seed = seeds_from_truth(ux, uy, ufwd, sr)
    cases = (("iclm2d1", ot.ICLM2D1, 16, (ref, tar), moved, False),
             ("nr2d1", ot.NR2D1, 16, (ref, tar), main_seed, False),
             ("iclm2d2", ot.ICLM2D2, 12, (rref, rtar), rot_seed, False),
             ("icgn2d1_adaptive", ot.ICGN2D1, 30, (uref, utar), utn_seed,
              True),
             ("iclm2d1_adaptive", ot.ICLM2D1, 30, (uref, utar), utn_seed,
              True))
    for name, cls, r, imgs, seed, adaptive in cases:
        outs, branches = {}, {}
        for dev in devices:
            m = cls(r, r, 0.001, 10, device=dev)
            m.set_images(*imgs)
            m.prepare()
            m.set_self_adaptive(adaptive)
            outs[dev] = ot.table_to_numpy(m.compute(ot.table_from_numpy(
                *seed, device=dev)))
            branches[dev] = dict(m.stats)
        zc, zp = outs[card]["r"][:, 2], outs[host]["r"][:, 2]
        codes = np.array_equal(np.where(zc < 0, zc, 1),
                               np.where(zp < 0, zp, 1))
        both = (zc > 0) & (zp > 0)
        duv = np.abs(outs[card]["p"][both][:, [0, 6]]
                     - outs[host]["p"][both][:, [0, 6]])
        res[name] = dict(pois=len(zc), codes_equal=codes,
                         converged=int(both.sum()),
                         max_abs_duv=float(duv.max()) if both.any() else None,
                         branches=branches)
    log(json.dumps({"dic2d_cuda_vs_cpu": res}))
    for name, r in res.items():
        check(r["codes_equal"], f"{name}: codes differ between cuda and cpu")
        check(r["converged"] > 0, f"{name}: no POI converged")
        check(r["max_abs_duv"] <= 1e-3, f"{name}: u/v differ by "
              f"{r['max_abs_duv']}")
    check(res["iclm2d1"]["branches"][card].get("correct", 0) > 0,
          "ICLM2D1: the D=6 correction branch did not run on cuda")
    return res


def phase_dic2d(torch, ot, pairs, main_table, checked, device_ms, tmpdir):
    """The seven workloads of ``examples/dic_2d.run`` on the card at the
    reference's sizes, after a warm-up of each on a small grid; kernels 1
    and 2 counted over the whole suite and per launch shape per workload,
    their time estimated from phase 2's device time (``device_sum``).
    Checks every workload's gates, the fftcc_icgn1 table against phase
    3's, and that every launch shape is one phase 2 checked."""
    from opencorr_tpu_torch.examples import dic_2d
    from opencorr_tpu_torch.io import native
    from opencorr_tpu_torch.ops import bspline, gather2d, lattice2d

    check(native.available(), "the native table codec did not load")
    small = {"main": ((30, 30), 20, 20, 2), "rotation": ((50, 50), 20, 20, 2),
             "utn": ((50, 50), 20, 20, 5)}
    warm = os.path.join(tmpdir, "warm")
    for wl, pair in DIC2D_PAIR.items():
        dic_2d.run(wl, *pairs[pair][:2], warm, "cuda", grid=small[pair])
    torch.cuda.synchronize()
    wrappers = (gather2d.gather_windows_2d, lattice2d.lattice_eval_2d)
    lut_eval = bspline.bicubic_eval
    for fn in (*wrappers, lut_eval):
        fn.launches = 0
    prefix = os.path.join(tmpdir, "dic2d")
    results = {}
    tables = {}
    matches = {}
    for wl in dic_2d.WORKLOADS:
        for fn in (*wrappers, lut_eval):
            fn.shapes = {}
        info = {}
        t0 = time.perf_counter()
        if wl == "strain":
            out, timer = dic_2d.run(wl, f"{prefix}_fftcc_icgn1.csv", None,
                                    prefix, "cuda", stats=info)
        else:
            out, timer = dic_2d.run(wl, *pairs[DIC2D_PAIR[wl]][:2], prefix,
                                    "cuda", stats=info)
        wall_s = time.perf_counter() - t0
        t = ot.table_to_numpy(out)
        tables[wl] = t
        rec = dict(pois=int(out.n), wall_s=wall_s,
                   stage_s=dict(zip(timer.names, timer.seconds)),
                   kernel_device_ms={
                       fn.__name__: device_sum(fn, device_ms[fn.__name__])
                       for fn in wrappers},
                   lut_eval_launches={"x".join(map(str, k)): v
                                      for k, v in lut_eval.shapes.items()},
                   **{k: v for k, v in info.items()
                      if k not in ("sift2d_octaves", "sift_matches")})
        if wl != "strain":
            conv, du, dv = uv_error(t, pairs[DIC2D_PAIR[wl]][2])
            rec.update(converged_frac=conv, mean_abs_du=du, mean_abs_dv=dv,
                       codes={str(c): int((t["r"][:, 2] == c).sum())
                              for c in (-1.0, -2.0, -3.0, -4.0, -5.0)})
        if wl in ("strain", "self_adaptive"):
            ok = t["r"][:, 2] > 0.9
            rec.update(mean_exx=float(t["e"][ok, 0].mean()),
                       mean_eyy=float(t["e"][ok, 1].mean()),
                       strain_computed=int((t["e"] != 0).any(1).sum()))
        for st in info.get("sift2d_octaves", []):
            log(json.dumps({"dic2d_sift2d_octave": dict(workload=wl, **st)}))
        log(json.dumps({"dic2d": {wl: rec}}))
        results[wl] = rec
        if "sift_matches" in info:
            matches[wl] = info["sift_matches"]
    lut_eval.shapes = None
    launches = {fn.__name__: fn.launches for fn in (*wrappers, lut_eval)}
    log(json.dumps({"dic2d_launches": launches}))

    for name, v in launches.items():
        check(v > 0, f"the planar suite launched {name} no time")
    gathers, lattices = checked
    for wl, rec in results.items():
        km = rec["kernel_device_ms"]
        got_g = {tuple(int(v) for v in s.split("x"))
                 for s in km["gather_windows_2d"]["by_shape"]}
        got_l = {tuple(int(v) for v in s.split("x"))
                 for s in km["lattice_eval_2d"]["by_shape"]}
        check(got_g <= gathers, f"{wl}: gathers {sorted(got_g - gathers)} "
              "that phase 2 did not check")
        check(got_l <= lattices, f"{wl}: lattice evals "
              f"{sorted(got_l - lattices)} that phase 2 did not check")
        check(rec.get("writer") == "native", f"{wl}: table writer "
              f"{rec.get('writer')}")
        if wl == "strain":
            continue
        check(rec["converged_frac"] >= 0.9,
              f"{wl}: converged {rec['converged_frac']}")
        check(rec["mean_abs_du"] < 0.01 and rec["mean_abs_dv"] < 0.01,
              f"{wl}: displacement error {rec['mean_abs_du']}, "
              f"{rec['mean_abs_dv']}")
    sa = results["self_adaptive"]
    sa_evals = sum(sa["lut_eval_launches"].values())
    check(sa_evals == sa["refine_stats"]["iter_adaptive"],
          f"self_adaptive: {sa_evals} global-LUT eval launches, "
          f"{sa['refine_stats']['iter_adaptive']} Gauss-Newton steps")
    sr = tables["self_adaptive"]["sr"]
    r_max = results["self_adaptive"]["r_max"]
    check(r_max == int(sr.max()) and (sr >= 10).all(),
          f"self_adaptive radii {sr.min()}..{sr.max()}, r_max {r_max}")
    check(abs(results["self_adaptive"]["mean_exx"] - UTN_STRETCH) < 1e-3,
          f"self_adaptive exx {results['self_adaptive']['mean_exx']}")
    st = results["strain"]
    check(abs(st["mean_exx"] - STRAIN) < 1e-3
          and abs(st["mean_eyy"] - STRAIN) < 1e-3,
          f"strain {st['mean_exx']}, {st['mean_eyy']} vs {STRAIN}")
    ex = tables["fftcc_icgn1"]
    same = all(np.array_equal(ex[f], main_table[f], equal_nan=True)
               for f in ("x", "y", "p", "r", "sr"))
    log(json.dumps({"dic2d_fftcc_icgn1_equals_phase3": same}))
    check(same, "the example's fftcc_icgn1 table differs from phase 3's")
    return results, launches, matches


# --- this slice: the DVC example, sharded DVC, the reconstruction example --


def phase_dvc_example(torch, ot, vref, vtar, dvc_refined, checked, tmpdir):
    """``examples/dvc.run``'s ``fftcc_icgn1`` workload on ``.bin`` files of
    phase 5's volumes with phase 5's grid as a POI CSV (r=30), then its
    ``strain`` workload on the table just written; kernel 3 and the step
    kernels counted and timed per launch.  Checks the table against phase
    5's, phase 5's gates, the strain, the writers and that every launch
    shape is one of ``checked``."""
    from opencorr_tpu_torch.examples import dvc

    paths = [os.path.join(tmpdir, f"{name}.bin") for name in ("ref", "tar")]
    for path, vol in zip(paths, (vref, vtar)):
        vol.save_bin(path)
    pois = ot.poi_grid_3d(*DVC_GRID, device="cpu")
    csv_in = os.path.join(tmpdir, "al_foam4_pois.csv")
    write_pois_csv(csv_in, pois)
    prefix = os.path.join(tmpdir, "dvc_example")
    wrappers = dvc_wrappers()
    start_counts(wrappers)
    info = {}
    out, timer = dvc.run("fftcc_icgn1", *paths, csv_in, prefix, "cuda",
                         stats=info)
    launches, kernel_ms = read_counts(wrappers)
    sinfo = {}
    strained, stimer = dvc.run("strain", f"{prefix}_fftcc_icgn1.csv",
                               out_prefix=prefix, device="cuda", stats=sinfo)
    t = ot.table_to_numpy(out)
    zn = t["r"][:, 3]
    conv = zn > 0.9
    ut, vt, wt = true_uvw(t["z"].astype(np.float64))
    du = np.abs(t["p"][conv, 0] - ut)
    dv = np.abs(t["p"][conv, 4] - vt)
    dw = np.abs(t["p"][conv, 8] - wt[conv])
    ezz = strained.e[strained.zncc > 0.9, 2].cpu().numpy()
    diff = {f: float(np.abs(t[f] - dvc_refined[f]).max())
            for f in ("p", "r")}
    same = all(np.array_equal(t[f], dvc_refined[f], equal_nan=True)
               for f in ("x", "y", "z", "p", "r", "sr"))
    rec, dims = ot.load_matrix_bin_3d(f"{prefix}_fftcc_icgn1.bin")
    res = dict(
        pois=int(out.n), r=DVC_R, converged_frac=float(conv.mean()),
        mean_abs_du=float(du.mean()), mean_abs_dv=float(dv.mean()),
        mean_abs_dw=float(dw.mean()), mean_ezz=float(ezz.mean()),
        imposed_ezz=DVC_STRAIN, equals_phase5=same, max_diff_phase5=diff,
        stage_ms={k: v * 1e3 for k, v in zip(timer.names, timer.seconds)},
        strain_stage_ms={k: v * 1e3 for k, v in zip(stimer.names,
                                                     stimer.seconds)},
        save_ms={k: info[f"{k}_s"] * 1e3 for k in ("save_table_3d",
                                                   "save_matrix_bin_3d")},
        writer=[info["writer"], sinfo["writer"]],
        icgn_stats=info["icgn_stats"], launches=launches,
        kernel_event_ms=kernel_ms)
    log(json.dumps({"dvc_example": res}))
    for name, v in launches.items():
        check(v > 0, f"the DVC example launched {name} no time")
        checked_launches(kernel_ms, name, checked[name], "the DVC example")
    check(same, f"the example's fftcc_icgn1 table differs from phase 5's: "
          f"{diff}")
    check(res["converged_frac"] >= 0.9, f"converged {res['converged_frac']}")
    check(max(res["mean_abs_du"], res["mean_abs_dv"], res["mean_abs_dw"])
          < 0.01, "DVC example displacement error")
    check(abs(res["mean_ezz"] - DVC_STRAIN) < 1e-3,
          f"DVC example ezz {res['mean_ezz']} vs {DVC_STRAIN}")
    check(rec.shape == (out.n, 8) and dims == DVC_SHAPE[::-1], "matrix bin")
    check(res["writer"] == ["native", "native"], f"writers {res['writer']}")
    return res, launches


def phase_sharded(torch, ot, vref, vtar, dvc_seeded, dvc_refined, checked,
                  r_cmp=16):
    """ShardedICGN3D1 on an NCCL group of one (``make_mesh(1, axis="z")``)
    on phase 5's volumes and FFTCC3D seeds, against phase 5's ICGN3D1
    table: codes equal, u/v/w within 1e-5 voxel; kernel 3 and the step
    kernels counted and their launch shapes one of ``checked``.  Then 64 POIs at r=``r_cmp`` on cuda
    and on the same group's cpu mesh, four of them near the z faces (the z
    guards and the global edge guard fail them -3): codes equal, u/v/w
    within 1e-3 voxel.  Ends the process group it made."""
    from opencorr_tpu_torch.parallel import halo, mesh

    mesh_gpu = mesh.make_mesh(1, axis="z")
    s = dvc_seeded
    table = ot.table_from_numpy_3d(s["x"], s["y"], s["z"], s["p"], s["r"],
                                   s["e"], s["sr"], device="cuda")
    m = halo.ShardedICGN3D1(DVC_R, DVC_R, DVC_R, 0.001, 10)
    m.set_images(vref, vtar)
    m.compute(table.map(lambda a: a[:512]), mesh_gpu)  # warm-up
    torch.cuda.synchronize()
    wrappers = dvc_wrappers()
    start_counts(wrappers)
    m.stats.clear()
    t0 = time.perf_counter()
    out = ot.table_to_numpy(m.compute(table, mesh_gpu))
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches, kernel_ms = read_counts(wrappers)
    zs, zb = out["r"][:, 3], dvc_refined["r"][:, 3]
    codes = np.array_equal(np.where(zs < 0, zs, 1), np.where(zb < 0, zb, 1))
    d = float(np.abs(out["p"][:, [0, 4, 8]]
                     - dvc_refined["p"][:, [0, 4, 8]]).max())
    res = dict(pois=len(zs), halo=m.halo, ranks=1,
               backend=torch.distributed.get_backend(), wall_ms=wall_ms,
               stage_ms={k.replace("_s", "_ms"): v * 1e3
                         for k, v in m.times.items()},
               stats=dict(m.stats), codes_equal_phase5=codes,
               max_abs_duvw_phase5=d,
               converged_frac=float((zs > 0.9).mean()), launches=launches,
               kernel_event_ms=kernel_ms)
    # cuda against cpu on 64 POIs: 60 of the grid with phase 5's seeds,
    # and four at the z faces seeded at the rounded field: the subsets of
    # the first three touch the faces, so their warped samples reach below
    # z=1 or to dim-2 and the z guards fail them; the last crosses the top
    # face (the global edge guard)
    keep = np.linspace(0, len(zs) - 1, 60).astype(np.int64)
    dz = DVC_SHAPE[0]
    face_z = np.float32([r_cmp, r_cmp, dz - 1 - r_cmp, dz - r_cmp])
    mid = DVC_SHAPE[2] // 2
    face_x = np.float32([mid, mid - 7, mid, mid - 7])
    xyz = [np.concatenate([s[a][keep], f]) for a, f in (
        ("x", face_x), ("y", face_x), ("z", face_z))]
    p = np.concatenate([s["p"][keep], np.zeros((4, 12), np.float32)])
    for col, val in zip((0, 4, 8), true_uvw(face_z.astype(np.float64))):
        p[60:, col] = np.round(val)
    outs, stats = {}, {}
    for dev, msh in (("cuda", mesh_gpu),
                     ("cpu", mesh.make_mesh(1, axis="z", device="cpu"))):
        c = halo.ShardedICGN3D1(r_cmp, r_cmp, r_cmp, 0.001, 10)
        c.set_images(vref, vtar)
        outs[dev] = ot.table_to_numpy(c.compute(ot.table_from_numpy_3d(
            *xyz, p, np.zeros((64, 7), np.float32),
            np.zeros((64, 6), np.float32), np.zeros((64, 3), np.float32),
            device=dev), msh))
        stats[dev] = dict(c.stats)
    zc, zp = outs["cuda"]["r"][:, 3], outs["cpu"]["r"][:, 3]
    both = (zc > 0) & (zp > 0)
    res.update(cmp_pois=64, cmp_r=r_cmp,
               cmp_codes_equal=bool(np.array_equal(np.where(zc < 0, zc, 1),
                                                   np.where(zp < 0, zp, 1))),
               cmp_face_codes=[float(x) for x in zc[60:]],
               cmp_max_abs_duvw=float(np.abs(
                   outs["cuda"]["p"][both][:, [0, 4, 8]]
                   - outs["cpu"]["p"][both][:, [0, 4, 8]]).max()),
               cmp_converged=int(both.sum()), cmp_stats=stats)
    log(json.dumps({"sharded_dvc": res}))
    for name, v in launches.items():
        check(v > 0, f"the sharded path launched {name} no time")
        checked_launches(kernel_ms, name, checked[name], "sharded DVC")
    check(codes, "sharded codes differ from phase 5's")
    check(d <= 1e-5, f"sharded u/v/w differ from phase 5's by {d}")
    check(res["cmp_codes_equal"], "sharded codes differ between cuda and cpu")
    check(res["cmp_converged"] > 0 and res["cmp_max_abs_duvw"] <= 1e-3,
          f"sharded cuda vs cpu u/v/w {res['cmp_max_abs_duvw']}")
    check(all(c == -3.0 for c in res["cmp_face_codes"]),
          f"POIs at the z faces: codes {res['cmp_face_codes']}")
    torch.distributed.destroy_process_group()
    return res, launches


def phase_reconstruction(torch, ot, views, pts, truth, scene, checked,
                         device_ms, tmpdir):
    """``examples/reconstruction_epipolar.run(use_sift=True)`` on the
    GT4-size views of the reconstruction scene, after a warm-up on their
    top-left 300x400 crop; kernel 1 counted per launch shape, its time
    estimated from phase 2's device time (``device_sum``), every launch
    shape one of
    ``checked``.  Prints the fitted parallax, the
    epipolar reach of every truth from the fitted estimate (how many lie
    past the search's 6 px) and the stage times.  Gates: ZNCC > 0.9 on at
    least 0.9 of the POIs, mean |view-2 position - truth| < 0.02 px, mean
    3D error below ``displacement_bound`` for 0.02 px."""
    from opencorr_tpu_torch.examples import reconstruction_epipolar as rec
    from opencorr_tpu_torch.ops import gather2d

    h, w = STEREO_SIZE
    # the reach of the model fitted to exact matches, before the run
    cx, cy = rec.fit_parallax(*recon_sift_matches(scene, 4000, seed=5), w, h)
    reach = epipolar_reach_bilinear(scene.cams, pts.astype(np.float64),
                                    truth, cx, cy, (h, w))
    log(json.dumps({"recon_scene": dict(
        pois=int(len(pts)), exact_fit_x=cx.tolist(), exact_fit_y=cy.tolist(),
        reach_px=[float(reach.min()), float(reach.max())],
        past_search=int((np.abs(reach) > 6.0).sum()))}))
    rec.run(True, *(v[:300, :400] for v in views),
            os.path.join(tmpdir, "warm.csv"), "cuda")
    torch.cuda.synchronize()
    wrapper = gather2d.gather_windows_2d
    wrapper.launches = 0
    wrapper.shapes = {}
    info = {}
    rows, timer = rec.run(True, *views, os.path.join(tmpdir, "rec.csv"),
                          "cuda", stats=info)
    launches = {"gather_windows_2d": wrapper.launches}
    kernel_ms = {"gather_windows_2d": device_sum(
        wrapper, device_ms["gather_windows_2d"])}
    cx, cy = info["parallax_x"], info["parallax_y"]
    reach = epipolar_reach_bilinear(scene.cams, pts.astype(np.float64),
                                    truth, cx, cy, (h, w))
    ok = rows[:, 5] > 0.9
    got = info["view2_points"].cpu().numpy()
    pos = np.abs(got - truth).sum(1)
    world = triangulate64(scene.cams, pts.astype(np.float64), truth)
    err3 = np.linalg.norm(rows[ok, 2:5] - world[ok], axis=1)
    bound = reconstruction_bound(scene.cams, pts[ok], truth[ok])
    res = dict(
        size=[h, w], pois=int(len(rows)), matches=info["matches"],
        parallax_x=cx, parallax_y=cy,
        reach_px=[float(reach.min()), float(reach.max())],
        past_search=int((np.abs(reach) > 6.0).sum()),
        converged_frac=float(ok.mean()),
        mean_abs_position_px=float(np.abs(got[ok] - truth[ok]).mean()),
        max_position_px=float(pos[ok].max()),
        mean_3d_err_mm=float(err3.mean()), err_bound_mm=bound,
        codes={str(c): int((rows[:, 5] == c).sum())
               for c in (-1.0, -3.0, -4.0, -5.0)},
        stage_ms={k: v * 1e3 for k, v in zip(timer.names, timer.seconds)},
        epipolar_icgn=info["epipolar_icgn"], launches=launches,
        kernel_device_ms=kernel_ms)
    for st in info["sift2d_octaves"]:
        log(json.dumps({"recon_sift2d_octave": st}))
    log(json.dumps({"reconstruction": res}))
    check(launches["gather_windows_2d"] > 0,
          "the reconstruction launched gather_windows_2d no time")
    checked_launches(kernel_ms, "gather_windows_2d", checked,
                     "the reconstruction")
    check(res["converged_frac"] >= 0.9,
          f"reconstruction converged {res['converged_frac']}")
    check(res["mean_abs_position_px"] < STEREO_TOL_PX,
          f"reconstruction position error {res['mean_abs_position_px']}")
    check(res["mean_3d_err_mm"] < bound,
          f"reconstruction 3D error {res['mean_3d_err_mm']} >= {bound}")
    return res, launches



# --- phase 16: the host SIFT3D path, FeatureAffine's device search, the
# tile eval ------------------------------------------------------------------


class Kernel4Layers:
    """While open, records every layer that SIFT3D's host path sends to
    kernel 4 (the layer volume, its keypoints, rotations, crop, scale and
    voxel pitch), by wrapping ``SIFT3D._describe``."""

    def __init__(self, sift_cls):
        self.cls = sift_cls
        self.orig = sift_cls._describe
        self.layers = []

    def __enter__(self):
        orig, layers = self.orig, self.layers

        def describe(sift, vg, g, x, y, z, rot):
            out = orig(sift, vg, g, x, y, z, rot)
            if out[2] == "kernel 4":
                layers.append(dict(vol=vg, x=x, y=y, z=z, rot=rot,
                                   crop=tuple(out[1]), scale=g.scale,
                                   units=tuple(g.units)))
            return out

        self.cls._describe = describe
        return self.layers

    def __exit__(self, *exc):
        self.cls._describe = self.orig
        return False


def kernel4_launch_check(torch, lay, keep=256, reps=3, seed=0):
    """Kernel 4 on one recorded host-path layer at its own (count, crop),
    float32 and bfloat16 operands, each held against its plain version on
    ``keep`` keypoints drawn evenly over the launch (a seeded permutation:
    the keypoints come in z-major scan order, so the first ones all lie at
    the z=0 face) within 1e-5 x max|S|; CUDA-event ms of both (``reps``
    launches each), the plain version's ms on the sample, and the
    operation bound from the sample's voxel counts scaled to the launch's
    count."""
    from opencorr_tpu_torch.ops import desc3d

    vol, crop = lay["vol"], lay["crop"]
    k = int(lay["x"].shape[0])
    kw = dict(crop=crop, scale=lay["scale"], unit_xyz=lay["units"])
    starts, tab = desc3d.prepare_tables(vol.shape, lay["x"], lay["y"],
                                        lay["z"], **kw)
    rot = lay["rot"].reshape(k, 9).contiguous()
    gen = torch.Generator().manual_seed(seed)
    pick = torch.randperm(k, generator=gen)[:keep].sort().values.to(
        vol.device)
    zs = lay["z"][pick].float()
    rec = dict(launch="x".join(map(str, (k, *crop))), keypoints=k,
               crop=list(crop), scale=lay["scale"], checked=int(pick.numel()),
               checked_z_range=[float(zs.min()), float(zs.max())],
               layer_z=int(vol.shape[0]))
    counts = {}
    for bf16 in (False, True):
        tag = "bf16_" if bf16 else ""
        got = desc3d.descriptor_hist(vol, starts, tab, rot, hist_bf16=bf16,
                                     **kw)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        want = desc3d.descriptor_hist_plain(
            vol, starts[pick], tab[pick], rot[pick], hist_bf16=bf16,
            counts=None if bf16 else counts, **kw)
        end.record()
        torch.cuda.synchronize()
        err = float((got[pick] - want).abs().max())
        tol = 1e-5 * float(want.abs().max())
        check(err <= tol, f"kernel 4 at {rec['launch']} (bf16 {bf16}): "
              f"max|err| {err} > {tol} on {pick.numel()} spread keypoints")
        rec[f"{tag}max_abs_err"] = err
        rec[f"{tag}tolerance"] = tol
        rec[f"{tag}plain_ms_sample"] = start.elapsed_time(end)
        rec[f"{tag}ms"] = cuda_ms(torch, lambda: desc3d.descriptor_hist(
            vol, starts, tab, rot, hist_bf16=bf16, **kw), reps, warm=1)
        del got, want
    scale_k = k / pick.numel()
    flops = scale_k * (counts["sphere_voxels"] * desc3d.FLOPS_SPHERE_VOXEL
                       + counts["live_voxels"] * desc3d.FLOPS_LIVE_VOXEL)
    rec.update(bound_ms=flops / F32_FLOP_PER_S * 1e3, bound_by="operations",
               bound_note=f"voxel counts of {pick.numel()} spread keypoints "
                          "scaled to the launch's count")
    return rec


def expected_routes(ot, shape):
    """The descriptor route each (octave, layer) of a ``shape`` volume must
    take on the host path, from the layer plan alone: the einsum path where
    the crop box plus its 1-voxel margin does not fit the layer, or where
    the descriptor sphere's reach on an axis (int(rad / unit) + 1) passes
    the window radius r_desc; kernel 4 everywhere else."""
    s = ot.SIFT3D(device="cpu")
    plan = s._plan_layers(shape)
    cfg = s.sift_config
    out = {}
    for m in range(cfg.n_octave):
        for n in range(1, cfg.n_octave_layers + 1):
            g = plan[m * (cfg.n_octave_layers + 3) + n]
            r_desc = s._radii(g)[1]
            rad = 2.0 * 5.0 * math.sqrt(2.0) * float(g.scale)
            reach = [int(rad / u) + 1 for u in (g.units[2], g.units[1],
                                                 g.units[0])]
            crop = [min(r_desc, c) for c in reach]
            if any(2 * (c + 1) + 1 > d for c, d in zip(crop, g.dims)):
                out[(m, n)] = "plain: crop does not fit"
            elif any(c > r_desc for c in reach):
                out[(m, n)] = "plain: window clips the sphere"
            else:
                out[(m, n)] = "kernel 4"
    return out


def phase_sift_host(torch, ot, checked, device_fa_codes, tmpdir,
                    shape=TORUS_SHAPE, grid=TORUS_GRID, dev="cuda"):
    """SIFT3D's host path (the default) through ``examples/dvc.run``'s
    ``sift_icgn1`` on phase 7's Torus-size pair and POI grid, after a
    warm-up on a sub-volume.  Kernels 3 and 4 and the step kernels counted
    and timed per launch in that run; afterwards every kernel-4 launch's layer is launched again
    at its own (count, crop), float32 and bfloat16, and held against the
    plain version on 256 keypoints spread over it.  Prints every layer's
    extrema, oriented and kept counts (no caps) and descriptor route, and
    the host path's stage times.  Gates: FeatureAffine3D's -1 share no
    more than phase 7's (device path) plus 0.01, converged >= 0.9, mean
    |u - u_true| < 0.01 voxel, the median matched displacement within 1
    voxel, every kernel-3 and step-kernel launch shape one of
    ``checked``, every layer with keypoints on the route its plan gives
    it.  ``shape``,
    ``grid`` and ``dev`` let a rehearsal run it small on the cpu."""
    from opencorr_tpu_torch.examples import dvc
    from opencorr_tpu_torch.models import sift3d as tmodel
    from opencorr_tpu_torch.ops import desc3d

    t0 = time.perf_counter()
    ref, tar = sift_pair(torch, shape, seed=3, device=dev)
    torch.cuda.synchronize()
    synth_ms = (time.perf_counter() - t0) * 1e3
    pois = ot.poi_grid_3d(*grid, device="cpu")
    csv_in = os.path.join(tmpdir, "torus_pois.csv")
    write_pois_csv(csv_in, pois)
    sub = (slice(0, 160), slice(0, 128), slice(0, 192))
    warm_csv = os.path.join(tmpdir, "warm_pois.csv")
    write_pois_csv(warm_csv, ot.poi_grid_3d((40, 40, 40), 4, 2, 3, 30,
                                            device="cpu"))
    dvc.run("sift_icgn1", ref[sub].contiguous(), tar[sub].contiguous(),
            warm_csv, os.path.join(tmpdir, "warm"), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = (desc3d.descriptor_hist, *dvc_wrappers())
    start_counts(wrappers)
    info = {}
    with Kernel4Layers(tmodel.SIFT3D) as layers_k4:
        out, timer = dvc.run("sift_icgn1", ref, tar, csv_in,
                             os.path.join(tmpdir, "host"), dev, stats=info)
    launches, kernel_ms = read_counts(wrappers)
    peak = torch.cuda.max_memory_allocated()
    for name, v in launches.items():
        check(v > 0, f"the host SIFT path launched {name} no time")
    check(len(layers_k4) == launches["descriptor_hist"],
          f"{len(layers_k4)} kernel-4 layers recorded, "
          f"{launches['descriptor_hist']} launches")
    for fn in dvc_wrappers():
        checked_launches(kernel_ms, fn.__name__, checked[fn.__name__],
                         "the host SIFT path")
    stage_ms = {k: v * 1e3 for k, v in zip(timer.names, timer.seconds)}
    del ref, tar
    launch_recs = [kernel4_launch_check(torch, lay) for lay in layers_k4]
    del layers_k4
    torch.cuda.empty_cache()

    layers = info["sift3d_layers"]
    mk1, mk2 = info["sift_matches"]
    med = np.median(mk2 - mk1, axis=0) if len(mk1) else np.full(3, np.nan)
    codes = info["feature_affine3d_codes"]
    n = pois.n
    minus1 = codes["-1.0"] / n
    minus1_device = device_fa_codes["-1.0"] / n
    t = ot.table_to_numpy(out)
    zn = t["r"][:, 3]
    conv = zn > 0.9
    u, v, w = TORUS_UVW
    err = [float(np.abs(t["p"][conv, c] - x).mean())
           for c, x in ((0, u), (4, v), (8, w))]
    res = dict(
        volume=list(shape), pois=n, synth_ms=synth_ms,
        ref_kp=info["keypoints"][0], tar_kp=info["keypoints"][1],
        matches=int(len(mk1)), median_match_dxyz=[float(x) for x in med],
        fa3d_codes=codes, fa3d_minus1_share=minus1,
        fa3d_minus1_share_device_path=minus1_device,
        converged_frac=float(conv.mean()), mean_abs_duvw=err,
        routes={r: sum(1 for st in layers if st.get("route") == r)
                for r in sorted({st.get("route") for st in layers
                                 if st.get("route")})},
        plain_layers=sorted({(st["octave"], st["layer"], st["route"])
                             for st in layers if st.get("route")
                             and st["route"] != "kernel 4"}),
        host_stage_ms=info["sift3d_stage_ms"], stage_ms=stage_ms,
        icgn_stats=info["icgn_stats"], launches=launches,
        kernel_event_ms=kernel_ms, peak_mem_mb=peak / 2**20,
        kernel4_launches=launch_recs)
    for st in layers:
        log(json.dumps({"sift_host_layer": st}))
    log(json.dumps({"sift_host_path": res}))
    check(all(abs(m - x) <= 1.0 for m, x in zip(med, TORUS_UVW)),
          f"median matched displacement {med} vs {TORUS_UVW}")
    check(minus1 <= minus1_device + 0.01,
          f"FeatureAffine3D -1 share {minus1} (device path {minus1_device})")
    check(np.isfinite(t["p"][conv]).all(), "non-finite results")
    check(res["converged_frac"] >= 0.9,
          f"host SIFT path converged {res['converged_frac']}")
    check(max(err) < 0.01, f"host SIFT path displacement error {err}")
    check(all(st["kept"] == st["oriented"] for st in layers),
          "the host path capped a layer")
    want = expected_routes(ot, shape)
    for st in layers:
        if st["kept"]:
            check(st.get("route") == want[(st["octave"], st["layer"])],
                  f"descriptor route {st.get('route')!r} where the layer "
                  f"plan gives {want[(st['octave'], st['layer'])]!r}: {st}")
    check(sum(st.get("route") == "kernel 4" for st in layers)
          == launches["descriptor_hist"],
          "kernel-4 layers and kernel-4 launches differ")
    return res, launches, (mk1, mk2)


def rotation_gaps(torch, ot, vol, devices=("cuda", "cpu")):
    """The host path's orientation of ``vol``'s keypoints (extracted on the
    first device) on both devices from the same pyramid layers: per
    (octave, layer), the largest |rot_card - rot_cpu| and, for each of
    ``ROT_FAULTS`` injected on the card's side (the layer rounded to
    float16, the weighting scale 0.1% off, the keypoint one voxel off in
    x), the same reading of the faulted rotations."""
    from opencorr_tpu_torch.ops import sift3d as ops3d

    card, host = devices
    s = ot.SIFT3D(device=card)
    plan, vols = s._gaussian_pyramid(vol.to(card))
    kp = s._extract(vol.to(card), "ref")[0].cpu().numpy()
    cfg = s.sift_config

    def orient(vg, g, xyz, r, dev, fault=None):
        vg, scale = vg.to(dev), g.scale
        x, y, z = (xyz[:, j].to(dev) for j in range(3))
        if fault == ROT_FAULTS[0]:
            vg = vg.half().float()
        elif fault == ROT_FAULTS[1]:
            scale = scale * 1.001
        elif fault == ROT_FAULTS[2]:
            x = x + 1
        win, x0, y0, z0 = ops3d.gather_windows_3d(vg, x, y, z, r)
        return ops3d.assign_orientation(
            win, x0, y0, z0, x, y, z, tuple(vg.shape[::-1]), scale, g.units,
            cfg.gradient_threshold, cfg.beta, cfg.gamma)[0].cpu()

    out = []
    for m in range(cfg.n_octave):
        for n in range(1, cfg.n_octave_layers + 1):
            sel = (kp[:, 3] == m) & (kp[:, 4] == n)
            if not sel.any():
                continue
            i = m * (cfg.n_octave_layers + 3) + n
            g, vg = plan[i], vols[i].cpu()
            xyz = torch.from_numpy((kp[sel, :3] / 2 ** m).astype(np.int64))
            r = s._radii(g)[0]
            want = orient(vg, g, xyz, r, host)
            rec = dict(octave=m, layer=n, keypoints=int(sel.sum()),
                       max_abs_drot=float(
                           (orient(vg, g, xyz, r, card) - want).abs().max()))
            rec["faults"] = {f: float((orient(vg, g, xyz, r, card, f)
                                       - want).abs().max())
                             for f in ROT_FAULTS}
            out.append(rec)
    return out


def phase_sift_host_cpu_agreement(torch, ot, shape=(64, 64, 72),
                                  devices=("cuda", "cpu")):
    """SIFT3D on ``cuda`` and on ``cpu`` on phase 8's pair.  The host path
    (kernel 4 where its route allows on cuda): keypoint counts and matched
    sets equal.  Its descriptor stage on common inputs, the reference
    volume's keypoints and the cpu's rotations, layer by layer: within
    1e-5 x max|desc| on every keypoint; on the kernel-4 layers also the
    bfloat16 histogram S from the cpu's tables within 1e-5 x max|S|.  The
    two devices' own rotations within ``ROT_TOL`` on the pairs of
    ``ROT_SEEDS`` (their structure-tensor sums run in another order, which
    moves a few descriptors by about 1e-3, as against the JAX package,
    ROADMAP §3), and each of ``ROT_FAULTS`` above it.  The device path with ``hist_bf16=True``:
    keypoint counts and matched sets equal, kernel 4 launched on cuda."""
    from opencorr_tpu_torch.ops import desc3d, sift3d as ops3d

    card, host = devices
    ref, tar = sift_pair(torch, shape, seed=5, device="cpu")
    res = {}
    for backend, bf16 in (("host", False), ("device", True)):
        got = {}
        for dev in devices:
            s = ot.SIFT3D(pyramid_backend=backend, hist_bf16=bf16,
                          device=dev)
            s.set_images(ref, tar)
            before = desc3d.descriptor_hist.launches
            s.compute()
            got[dev] = dict(kp=(s.ref_kp_count, s.tar_kp_count),
                            match=(s.ref_matched_kp, s.tar_matched_kp),
                            k4=desc3d.descriptor_hist.launches - before)
        c, p = got[card], got[host]
        res[backend] = dict(
            hist_bf16=bf16, keypoints=p["kp"], kp_equal=c["kp"] == p["kp"],
            matches=len(p["match"][0]),
            matches_equal=all(np.array_equal(x, y)
                              for x, y in zip(c["match"], p["match"])),
            kernel4_launches=c["k4"], kernel4_launches_cpu=p["k4"])

    # the host path's descriptor stage on common keypoints and rotations
    sh = {dev: ot.SIFT3D(device=dev) for dev in devices}
    plan, vols = sh[host]._gaussian_pyramid(ref)
    kp, _ = sh[host]._extract(ref, "ref")
    kp = kp.numpy()
    cfg = sh[host].sift_config
    layers = []
    for m in range(cfg.n_octave):
        for n in range(1, cfg.n_octave_layers + 1):
            sel = (kp[:, 3] == m) & (kp[:, 4] == n)
            if not sel.any():
                continue
            i = m * (cfg.n_octave_layers + 3) + n
            g = plan[i]
            xyz = torch.from_numpy((kp[sel, :3] / 2 ** m).astype(np.int64))
            win, x0, y0, z0 = ops3d.gather_windows_3d(
                vols[i], *(xyz[:, j] for j in range(3)),
                sh[host]._radii(g)[0])
            rots = {host: ops3d.assign_orientation(
                win, x0, y0, z0, *(xyz[:, j] for j in range(3)),
                tuple(vols[i].shape[::-1]), g.scale, g.units,
                cfg.gradient_threshold, cfg.beta, cfg.gamma)[0]}
            rec = dict(octave=m, layer=n, keypoints=int(sel.sum()))
            for bf16 in (False, True):
                if bf16 and rec["route"] != "kernel 4":
                    continue
                descs = {}
                if bf16:  # S from the cpu's tables, whose exp() the
                    # card would round one ulp apart, which moves a
                    # bfloat16 operand a whole step now and then
                    kw = dict(crop=ops3d._sphere_crop(
                        sh[host]._radii(g)[1], g.scale, g.units),
                        scale=g.scale, unit_xyz=g.units)
                    starts, tab = desc3d.prepare_tables(
                        vols[i].shape, *(xyz[:, j] for j in range(3)), **kw)
                for dev in devices:
                    vg = vols[i].to(dev)
                    x, y, z = (xyz[:, j].to(dev) for j in range(3))
                    rot = rots[host].to(dev)
                    if bf16:
                        descs[dev] = desc3d.descriptor_hist(
                            vg, starts.to(dev), tab.to(dev),
                            rot.reshape(-1, 9).contiguous(), hist_bf16=True,
                            **kw).cpu()
                    else:
                        d, _, route = sh[dev]._describe(vg, g, x, y, z, rot)
                        descs[dev] = d.cpu()
                        rec["route"] = route
                tag = "bf16_hist_" if bf16 else ""
                rec[f"{tag}max_abs_diff"] = float(
                    (descs[card] - descs[host]).abs().max())
                rec[f"{tag}tolerance"] = 1e-5 * float(
                    descs[host].abs().max())
            layers.append(rec)
    res["host_descriptor_stage"] = layers
    res["rotations"] = {}
    for seed in ROT_SEEDS:
        pair = ref if seed == 5 else sift_pair(torch, shape, seed=seed,
                                                device="cpu")[0]
        res["rotations"][seed] = rotation_gaps(torch, ot, pair, devices)
    rot_recs = [r for v in res["rotations"].values() for r in v]
    res["rotation_sound_max"] = max(r["max_abs_drot"] for r in rot_recs)
    res["rotation_fault_min_of_max"] = {
        f: min(max(r["faults"][f] for r in v)
               for v in res["rotations"].values()) for f in ROT_FAULTS}
    log(json.dumps({"sift_host_cuda_vs_cpu": res}))
    for backend in ("host", "device"):
        r = res[backend]
        check(r["kp_equal"], f"{backend}: keypoint counts differ")
        check(r["matches_equal"] and r["matches"] > 0,
              f"{backend}: matched sets differ")
        check(r["kernel4_launches"] > 0 and r["kernel4_launches_cpu"] == 0
              or card == "cpu", f"{backend}: kernel 4 launched "
              f"{r['kernel4_launches']} times on cuda, "
              f"{r['kernel4_launches_cpu']} on cpu")
    check(any(r.get("route") == "kernel 4" for r in layers),
          "no layer of the small pair took kernel 4")
    # float32 sums in another order, about 1e-6, amplified up to 10x by
    # eigenvalue ratios below the 0.9 the orientation accepts; each fault
    # must read above the limit on every pair
    check(res["rotation_sound_max"] <= ROT_TOL,
          f"rotations differ by {res['rotation_sound_max']} > {ROT_TOL}")
    for f, v in res["rotation_fault_min_of_max"].items():
        check(v > ROT_TOL or card == "cpu",
              f"rotation fault {f!r} reads {v}, within the limit {ROT_TOL}")
    for r in layers:
        for tag in ("", "bf16_hist_"):
            if f"{tag}max_abs_diff" in r:
                check(r[f"{tag}max_abs_diff"] <= r[f"{tag}tolerance"],
                      f"descriptor stage differs: {r}")
    return res


def candidate_ties(torch, fa, table, knn_k=None, r2_rel=2.0 ** -21):
    """POIs whose candidate list holds a distance tie: two adjacent entries
    of the list (the in-radius keypoints, the nearest ``neighbor_min``
    ones, or with ``knn_k`` the nearest ``knn_k``), or its last entry and
    the next, whose float64 distances lie within ``r2_rel`` of each other
    (float32 cannot order them), or an entry within it of the search
    radius (either side of the strict in-radius test).  Such a POI's
    candidates may be ordered or counted differently by the k-d tree
    (float64) and the device search (float32, lower index first)."""
    from opencorr_tpu_torch.ops import feature_affine as fops

    dev = table.x.device
    ref = torch.from_numpy(fa.ref_kp).to(dev)
    q = fa._coords(table)
    kc = min(fa.k_cap, ref.shape[0])
    r2 = float(fa.neighbor_search_radius) ** 2
    nmin = fa.neighbor_number_min
    pos = torch.arange(kc - 1, device=dev)
    out = []
    rows = max(1, fops.SEARCH_BUDGET // (fops.SEARCH_ENTRY_BYTES
                                         * ref.shape[0]))
    for lo in range(0, q.shape[0], rows):
        qc = q[lo:lo + rows]
        d2 = fops.squared_distances(qc, ref)
        nr = (d2 < fops.f32(r2)).sum(1)
        _, idx = fops.nearest(d2, kc)
        del d2
        if knn_k is not None:
            n_use = torch.full_like(nr, knn_k)
        else:
            n_use = torch.where(nr >= nmin, nr, torch.full_like(nr, nmin))
        d64 = ((qc.double()[:, None, :] - ref.double()[idx]) ** 2).sum(-1)
        d64 = torch.sort(d64, 1).values
        close = ((d64[:, 1:] - d64[:, :-1]) <= r2_rel * d64[:, 1:]) \
            & (pos[None, :] < n_use[:, None])
        edge = ((d64 - r2).abs() <= r2_rel * r2) if knn_k is None else \
            torch.zeros_like(close)
        out.append(close.any(1) | edge.any(1))
    return torch.cat(out).cpu().numpy()


def fa_backends_case(torch, ot, name, make, kp, table, reps=2,
                     moved=False):
    """One queue through ``make(backend)`` (a FeatureAffine module) on the
    host k-d tree and on the device search, each timed (the second of
    ``reps`` computes, candidates included, synchronised): codes,
    iteration and feature counts and p equal on every POI whose candidate
    list holds no distance tie (``candidate_ties``; with ``moved``, the
    self-adaptive mode, also at the POIs' moved positions)."""
    outs, ms = {}, {}
    for backend in ("host", "device"):
        for _ in range(reps):
            fa = make(backend)
            fa.set_keypoint_pair(*kp)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fa.compute(table)
            torch.cuda.synchronize()
            ms[backend] = (time.perf_counter() - t0) * 1e3
        outs[backend] = ot.table_to_numpy(out)
    h, d = outs["host"], outs["device"]
    same = (h["r"] == d["r"]).all(1) & (h["p"] == d["p"]).all(1) & \
        (h["x"] == d["x"]) & (h["y"] == d["y"])
    probe = make("device")
    probe.set_keypoint_pair(*kp)
    if moved:  # the self-adaptive KNN, at the POIs and where they moved
        k = min(probe.subset_feature_min, len(kp[0]))
        ties = candidate_ties(torch, probe, table, knn_k=k) | candidate_ties(
            torch, probe, ot.new_table_2d(d["x"], d["y"],
                                          device=table.x.device), knn_k=k)
    else:
        ties = candidate_ties(torch, probe, table)
    zc = h["r"][:, 3 if "z" in h else 2]
    rec = dict(case=name, pois=int(table.n), keypoints=int(len(kp[0])),
               host_ms=ms["host"], device_ms=ms["device"],
               tie_pois=int(ties.sum()), differing_pois=int((~same).sum()),
               differing_without_tie=int((~same & ~ties).sum()),
               codes={str(c): int((zc == c).sum()) for c in (0.0, -1.0,
                                                             -2.0)})
    log(json.dumps({"feature_affine_backends": rec}))
    check(rec["differing_without_tie"] == 0,
          f"{name}: the backends differ on {rec['differing_without_tie']} "
          "POIs without a distance tie")
    return rec


def phase_fa_backends(torch, ot, stereo_kp, dic_kp, torus_kp):
    """FeatureAffine2D on the device search against the host k-d tree at
    the stereo path's 10,000 POIs (its SIFT2D matches, r=16), the rotation
    pair's 42,025 (sift_icgn2's matches, r=12) and the utn pair's
    self-adaptive 38,400 (r=30, as ``examples/dic_2d.run``), and
    FeatureAffine3D at the Torus grid's 78,246 (the host SIFT3D path's
    matches, r=16)."""
    from opencorr_tpu_torch.examples import dic_2d

    def fa2d(r, adaptive=False):
        def make(backend):
            fa = ot.FeatureAffine2D(r, r, neighbor_backend=backend,
                                    device="cuda")
            if adaptive:
                nn = 2 * fa.neighbor_number_min
                fa.set_search(float(np.sqrt(2.0 * r * r)), nn)
                fa.set_self_adaptive(True)
                fa.set_subset_adjustment(nn, 10)
            return fa
        return make

    def fa3d(backend):
        return ot.FeatureAffine3D(TORUS_R, TORUS_R, TORUS_R,
                                  neighbor_backend=backend, device="cuda")

    sp = stereo_grid_points(STEREO_GRID)
    cases = (
        ("stereo", fa2d(16), stereo_kp,
         ot.new_table_2d(sp[:, 0], sp[:, 1], device="cuda")),
        ("rotation", fa2d(dic_2d.RADIUS["sift_icgn2"]), dic_kp["sift_icgn2"],
         ot.poi_grid_2d(*dic_2d.GRIDS["sift_icgn2"], device="cuda")),
        ("utn_self_adaptive", fa2d(dic_2d.RADIUS["self_adaptive"], True),
         dic_kp["self_adaptive"],
         ot.poi_grid_2d(*dic_2d.GRIDS["self_adaptive"], device="cuda")),
        ("torus", fa3d, torus_kp, ot.poi_grid_3d(*TORUS_GRID,
                                                 device="cuda")))
    return [fa_backends_case(torch, ot, *c, moved=c[0].endswith("adaptive"))
            for c in cases]


def phase_tile(torch, ot, vref, vtar, dvc_seeded, r_cmp=16, r=DVC_R,
               dev="cuda"):
    """``eval_mode="tile"`` on phase 5's DVC queue (5,733 POIs, r=30):
    ICGN3D1 with the tile eval against ``window_margin=None`` (the global
    eval; both timed, beside phase 5's lattice eval), the tile table equal
    to the global one on every POI it does not fail -3, and those it fails
    -3 are window exits; no kernel-3 launch.  ShardedICGN3D1(eval_mode=
    "tile") on an NCCL group of one against ICGN3D1's tile table (codes
    equal, u/v/w within 1e-5 voxel).  Then 64 POIs at r=16 on cuda and on
    cpu: codes equal, u/v/w within 1e-3 voxel.  ``r`` and ``dev`` let a
    rehearsal run it small on the cpu."""
    from opencorr_tpu_torch.ops import lattice3d
    from opencorr_tpu_torch.parallel import halo, mesh

    s = dvc_seeded
    table = ot.table_from_numpy_3d(s["x"], s["y"], s["z"], s["p"], s["r"],
                                   s["e"], s["sr"], device=dev)
    outs, ms, stats = {}, {}, {}
    for mode, margin in (("tile", 8), ("global", None)):
        m = ot.ICGN3D1(r, r, r, 0.001, 10, window_margin=margin,
                       eval_mode="tile" if mode == "tile" else "lattice",
                       device=dev)
        m.set_images(vref, vtar)
        m.prepare()
        before = lattice3d.lattice_eval_3d.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = m.compute(table)
        torch.cuda.synchronize()
        ms[mode] = (time.perf_counter() - t0) * 1e3
        stats[mode] = dict(m.stats, kernel3_launches=
                           lattice3d.lattice_eval_3d.launches - before)
        outs[mode] = ot.table_to_numpy(out)
    tile, glob = outs["tile"], outs["global"]
    zt, zg = tile["r"][:, 3], glob["r"][:, 3]
    held = zt != -3.0
    same = bool(np.array_equal(tile["p"][held], glob["p"][held])
                and np.array_equal(tile["r"][held], glob["r"][held]))
    exits = int((~held & (zg != -3.0)).sum())

    msh = mesh.make_mesh(1, axis="z", device=dev)
    sh = halo.ShardedICGN3D1(r, r, r, 0.001, 10, eval_mode="tile")
    sh.set_images(vref, vtar)
    before = lattice3d.lattice_eval_3d.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    so = ot.table_to_numpy(sh.compute(table, msh))
    ms["sharded_tile"] = (time.perf_counter() - t0) * 1e3
    sh_launches = lattice3d.lattice_eval_3d.launches - before
    zs = so["r"][:, 3]
    sh_codes = bool(np.array_equal(np.where(zs < 0, zs, 1),
                                   np.where(zt < 0, zt, 1)))
    sh_d = float(np.abs(so["p"][:, [0, 4, 8]] - tile["p"][:, [0, 4, 8]]).max())
    torch.distributed.destroy_process_group()

    keep = np.linspace(0, len(zt) - 1, 64).astype(np.int64)
    cmp = {}
    for side in (dev, "cpu"):
        m = ot.ICGN3D1(r_cmp, r_cmp, r_cmp, 0.001, 10, eval_mode="tile",
                       device=side)
        m.set_images(vref, vtar)
        m.prepare()
        cmp[side] = ot.table_to_numpy(m.compute(ot.table_from_numpy_3d(
            *(s[k][keep] for k in ("x", "y", "z", "p", "r", "e", "sr")),
            device=side)))
    zc, zp = cmp[dev]["r"][:, 3], cmp["cpu"]["r"][:, 3]
    both = (zc > 0) & (zp > 0)
    res = dict(
        pois=len(zt), r=r, ms=ms, stats=stats,
        tile_equals_global_where_held=same, tile_minus3=int((~held).sum()),
        window_exits=exits, global_minus3=int((zg == -3.0).sum()),
        converged_tile=float((zt > 0.9).mean()),
        sharded_tile_codes_equal=sh_codes, sharded_tile_max_abs_duvw=sh_d,
        sharded_tile_kernel3_launches=sh_launches,
        sharded_stage_ms={k.replace("_s", "_ms"): v * 1e3
                          for k, v in sh.times.items()},
        cmp_pois=64, cmp_r=r_cmp,
        cmp_codes_equal=bool(np.array_equal(np.where(zc < 0, zc, 1),
                                            np.where(zp < 0, zp, 1))),
        cmp_max_abs_duvw=float(np.abs(
            cmp[dev]["p"][both][:, [0, 4, 8]]
            - cmp["cpu"]["p"][both][:, [0, 4, 8]]).max())
        if both.any() else None, cmp_converged=int(both.sum()))
    log(json.dumps({"tile_eval": res}))
    check(same, "the tile table differs from the global one on POIs it "
          "holds")
    check(stats["tile"]["kernel3_launches"] == 0 and sh_launches == 0,
          "the tile eval launched kernel 3")
    check(res["converged_tile"] >= 0.9,
          f"tile converged {res['converged_tile']}")
    check(sh_codes and sh_d <= 1e-5,
          f"sharded tile differs: codes {sh_codes}, u/v/w {sh_d}")
    check(res["cmp_codes_equal"] and both.any()
          and res["cmp_max_abs_duvw"] <= 1e-3,
          f"tile cuda vs cpu: codes {res['cmp_codes_equal']}, "
          f"{res['cmp_max_abs_duvw']}")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if os.environ.get("OPENCORR_SIFT2D"):
        print("chip_smoke: OPENCORR_SIFT2D is set; it would change SIFT2D's "
              "backend on every path checked here", file=sys.stderr)
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
    names = ["gather2d", "lattice2d", "lattice3d", "desc3d", "bicubic2d"]
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
    records = phase_kernels(torch, ot, img, rng, reps=20)
    lattice_shape = records["lattice3d"][0]["shape"]  # one DVC chunk
    records["desc"] = phase_desc3d(torch, ot, rng, reps=10)
    checked = ({tuple(r["shape"]) for r in records["gather"]},
               {(*r["shape"], r["d_wobble"]) for r in records["lattice"]})
    # launch shapes as the wrappers record them
    checked_3d = {
        "lattice_eval_3d": {"x".join(map(str, (*r["shape"], r["d_wobble"])))
                            for r in records["lattice3d"]},
        "lattice_prologue_3d": {"x".join(map(str, (*r["shape"], r["margin"],
                                                   r["d_wobble"])))
                                for r in records["prologue3d"]},
        "residual_3d": {"x".join(map(str, (*r["shape"], guarded)))
                        for r in records["residual3d"]
                        for guarded in (False, True)},
        "descriptor_hist": {r["launch"] for r in records["desc"]},
        "rerank_3d": {"x".join(map(str, r["shape"]))
                      for r in records["rerank3d"]}}
    checked_gathers = {"x".join(map(str, g)) for g in checked[0]}
    # kernels 1 and 2: phase 2's device ms a launch, by launch shape as the
    # wrappers record it, for the paths' sums
    device_ms = {
        "gather_windows_2d": {"x".join(map(str, r["shape"])): r["ms"]
                              for r in records["gather"]},
        "lattice_eval_2d": {"x".join(map(str, (*r["shape"], r["d_wobble"]))):
                            r["ms"] for r in records["lattice"]}}

    # phase 3: the main path
    with tempfile.TemporaryDirectory() as tmpdir:
        main_res, launches, main_table = phase_main(
            torch, ot, ot.Image2D.from_array(ref), ot.Image2D.from_array(tar),
            center, device_ms, tmpdir)

    # phase 4: cuda against the plain versions on the cpu
    phase_cpu_agreement(torch, ot, ot.Image2D.from_array(ref),
                        ot.Image2D.from_array(tar))

    # phase 5: the DVC path
    t0 = time.perf_counter()
    vref8, vtar8 = speckle_volumes(seed=2)
    log(json.dumps({"dvc_volumes_s": time.perf_counter() - t0}))
    vref, vtar = ot.Image3D.from_array(vref8), ot.Image3D.from_array(vtar8)
    with tempfile.TemporaryDirectory() as tmpdir:
        dvc_res, dvc_launches, dvc_seeded, dvc_refined = phase_dvc(
            torch, ot, vref, vtar, checked_3d, tmpdir)
    by_path = {"2d": dict(launches), "dvc": dict(dvc_launches)}
    launches.update(dvc_launches)

    # phase 6: the DVC modules on cuda against the cpu
    phase_dvc_cpu_agreement(torch, ot, vref, vtar)

    # phase 7: the feature-seeded DVC path at the Torus dimensions, through
    # examples/dvc.py
    with tempfile.TemporaryDirectory() as tmpdir:
        sift_res, sift_launches = phase_sift(torch, ot, checked_3d, tmpdir)
    torch.cuda.empty_cache()
    by_path["sift"] = dict(sift_launches)
    launches["descriptor_hist"] = sift_launches["descriptor_hist"]

    # phase 8: the SIFT slice's modules on cuda against the cpu
    phase_sift_cpu_agreement(torch, ot)

    # phase 9: the stereo slice's modules on cuda against the cpu (a crop)
    t0 = time.perf_counter()
    views, spts, struth, scene = stereo_inputs()
    log(json.dumps({"stereo_render_s": time.perf_counter() - t0}))
    phase_stereo_cpu_agreement(torch, ot, views, spts)

    # phase 10: the stereo path at GT4's size
    with tempfile.TemporaryDirectory() as tmpdir:
        stereo_res, stereo_launches, stereo_kp = phase_stereo(
            torch, ot, views, spts, struth, scene, device_ms, tmpdir)
    by_path["stereo"] = dict(stereo_launches)
    del views, spts, struth, scene
    torch.cuda.empty_cache()

    # phase 11: the planar refiners on cuda against the cpu
    t0 = time.perf_counter()
    pairs = dic2d_inputs(ref, tar, center)
    log(json.dumps({"dic2d_pairs_s": time.perf_counter() - t0}))
    phase_dic2d_cpu_agreement(torch, ot, pairs)

    # phase 12: the planar example suite at the reference's sizes
    with tempfile.TemporaryDirectory() as tmpdir:
        dic_res, dic_launches, dic_kp = phase_dic2d(
            torch, ot, pairs, main_table, checked, device_ms, tmpdir)
    by_path["dic2d"] = dict(dic_launches)
    launches["bicubic_eval"] = dic_launches["bicubic_eval"]
    del pairs
    torch.cuda.empty_cache()

    # phase 13: the DVC example's fftcc_icgn1 and strain at al_foam4's size
    with tempfile.TemporaryDirectory() as tmpdir:
        dvx_res, dvx_launches = phase_dvc_example(
            torch, ot, vref, vtar, dvc_refined, checked_3d, tmpdir)
    by_path["dvc_example"] = dict(dvx_launches)
    del vref, vtar

    # phase 14: sharded DVC on a group of one
    shard_res, shard_launches = phase_sharded(
        torch, ot, vref8, vtar8, dvc_seeded, dvc_refined, checked_3d)
    by_path["sharded"] = dict(shard_launches)
    torch.cuda.empty_cache()

    # phase 15: the reconstruction example at GT4's size
    t0 = time.perf_counter()
    rviews, rpts, rtruth, rscene = recon_inputs()
    log(json.dumps({"recon_render_s": time.perf_counter() - t0}))
    with tempfile.TemporaryDirectory() as tmpdir:
        recon_res, recon_launches = phase_reconstruction(
            torch, ot, rviews, rpts, rtruth, rscene, checked_gathers,
            device_ms, tmpdir)
    by_path["reconstruction"] = dict(recon_launches)
    del rviews, rpts, rtruth, rscene
    torch.cuda.empty_cache()

    # phase 16: (a) SIFT3D's host path (the default) through the DVC
    # example at the Torus dimensions, every kernel-4 launch held at its
    # own shape; (b) the host path and the bf16 histograms on cuda against
    # cpu; (c) FeatureAffine's device neighbour search against the host
    # k-d tree on four paths' queues; (d) the tile eval on the DVC queue
    with tempfile.TemporaryDirectory() as tmpdir:
        host_res, host_launches, torus_kp = phase_sift_host(
            torch, ot, checked_3d, sift_res["fa3d_codes"],
            tmpdir)
    by_path["sift_host"] = dict(host_launches)
    torch.cuda.empty_cache()
    host_cmp = phase_sift_host_cpu_agreement(torch, ot)
    fa_res = phase_fa_backends(torch, ot, stereo_kp, dic_kp, torus_kp)
    tile_res = phase_tile(torch, ot, ot.Image3D.from_array(vref8),
                          ot.Image3D.from_array(vtar8), dvc_seeded)
    del vref8, vtar8
    log(json.dumps({"phase16": dict(
        sift_host_kernel4=host_res["kernel4_launches"],
        sift_host_cuda_vs_cpu=host_cmp, feature_affine_backends=fa_res,
        tile_ms=tile_res["ms"], lattice_icgn_ms_phase5=dvc_res[
            "stage_ms"]["icgn3d1"])}))

    # phase 17: the records
    # kernels 3 and 4 and the step kernels: CUDA events a launch (a call
    # of the residual's four); kernels 1 and 2 estimated:
    # phase 2's device ms a launch x launches, per shape (``ESTIMATED``)
    path_ms = {"2d": main_res["kernel_device_ms"],
               "dvc": dvc_res["kernel_event_ms"],
               "sift": sift_res["kernel_event_ms"],
               "sift_host": host_res["kernel_event_ms"],
               "stereo": stereo_res["kernel_device_ms"],
               "dic2d": merge_event_ms([r["kernel_device_ms"]
                                        for r in dic_res.values()]),
               "dvc_example": dvx_res["kernel_event_ms"],
               "sharded": shard_res["kernel_event_ms"],
               "reconstruction": recon_res["kernel_device_ms"]}
    def summary(name, route, source, replaces, recs, ref_shape, **pick):
        r = next(x for x in recs if x["shape"] == ref_shape
                 and all(x.get(k) == v for k, v in pick.items()))
        return dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=launches[name],
            launches_by_path={p: v[name] for p, v in by_path.items()
                              if name in v},
            path_ms={p: v[name] for p, v in path_ms.items() if name in v},
            max_abs_err=max(x["max_abs_err"] for x in recs),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            **{k: r[k] for k in ("wrapper_ms", "wrapper_host_us") if k in r},
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
                records["lattice3d"], list(lattice_shape), offsets="path"),
        summary("lattice_prologue_3d", "cuda",
                "opencorr_tpu_torch/csrc/lattice3d.cu",
                "none: fuses ICGN3D1's glue before kernel 3",
                records["prologue3d"], list(lattice_shape)),
        summary("residual_3d", "cuda",
                "opencorr_tpu_torch/csrc/lattice3d.cu",
                "none: fuses ICGN3D1's residual after kernel 3",
                records["residual3d"], list(lattice_shape)),
        summary("rerank_3d", "cuda",
                "opencorr_tpu_torch/csrc/fftcc3d_rerank.cuh",
                "none: scores FFTCC3D's candidate peaks from the windows",
                records["rerank3d"], list(RERANK_CHUNK), candidates="random"),
        summary("bicubic_eval", "cuda",
                "opencorr_tpu_torch/csrc/bicubic2d.cu",
                "none: the JAX package's bicubic_eval is an XLA gather and "
                "einsum", records["lut2d"],
                [LUT_EVAL_CASES[0][1], (2 * LUT_EVAL_CASES[0][2] + 1) ** 2]),
        summary("descriptor_hist", "cuda",
                "opencorr_tpu_torch/csrc/desc3d.cu",
                "opencorr_tpu/ops/pallas_desc.py:87", records["desc"],
                [TORUS_DESC[3][0], 73, 73, 73], volume="blurred",
                units=[1.0] * 3),
    ]
    log(json.dumps({"stage_ms": main_res["stage_ms"],
                    "dvc_stage_ms": dvc_res["stage_ms"],
                    "sift_stage_ms": sift_res["stage_ms"],
                    "sift_host_stage_ms": host_res["stage_ms"],
                    "sift_host_stages_ms": host_res["host_stage_ms"],
                    "stereo_stage_ms": stereo_res["stage_ms"],
                    "dic2d_stage_s": {wl: r["stage_s"]
                                      for wl, r in dic_res.items()},
                    "dvc_example_stage_ms": dvx_res["stage_ms"],
                    "sharded_stage_ms": shard_res["stage_ms"],
                    "reconstruction_stage_ms": recon_res["stage_ms"],
                    "total_s": time.perf_counter() - t_start}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
