"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``; each test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Gather: bit-exact, corners clamped into the image, also at the shapes
that stress its walk in groups of four outputs (windows of 1-3 outputs,
N = 1, sw = W) and on inputs off the 16-byte grid.  Lattice (2D and 3D):
within 1e-6 x max|eblk| (the 3D kernel also ``==`` on the shapes that
exercise its ring of staged planes), and exactly 0 where a placement
offset is out of range; the 2D kernel ``==`` where its ring of staged
POIs and bands meets odd shapes (N = 1, N below and above the persistent
grid, D = 1, 2 and 6, sy != sx, blocks off the 16-byte grid).  The SIFT3D
descriptor histogram: within 1e-5 x max|S| (float atomics sum in an order
that varies from run to run), on white noise and on blurred volumes.
Gather and lattice also at the planar suite's r=12 shapes, the lattice
there ``==``; the gather at the reconstruction search's chunk.  The DVC modules, the SIFT3D slice, the
planar refiners, the z-guarded icgn3d1 and ShardedICGN3D1 on a group of
one: cuda against cpu on small pairs.  ICGN3D1's step kernels: the
prologue ``==`` its plain version at one DVC chunk and at odd shapes, the
residual within a stated tolerance of its plain version and equal run to
run, and ``icgn3d1`` through both (with and without z guards) within
1e-5 voxel of the cpu.  FFTCC3D's re-rank kernel: winners ``==`` the
plain ``fftcc._rerank3d`` at one DVC chunk, a short chunk, odd shapes and
planes too large for shared memory, on ties, negative products, values
just inside the range guard and half-integral voxels; ``fftcc3d`` on cuda
``==`` on cpu where some windows are not integral.  The global-LUT
bicubic eval: value and mask ``==`` its plain version bit for bit at one
chunk of the self-adaptive path, at the flagship's exact fallback, at a
ragged size and on the range guard's edge cases; no launch on an empty
input."""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from opencorr_tpu_torch.ops import (bspline, desc3d, fftcc, gather2d,
                                    lattice2d, lattice3d, rerank3d)

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)


def _corners(n, h, w, sh, sw, seed, low=0):
    """Random corners, many of them past H-sh or W-sw (and below ``low``
    when it is negative), the first half and the last one legal."""
    rng = np.random.default_rng(seed)
    y0 = rng.integers(low, h + 2, n).astype(np.int32)
    x0 = rng.integers(low, w + 2, n).astype(np.int32)
    y0[: n // 2] = rng.integers(0, h - sh + 1, n // 2)
    x0[: n // 2] = rng.integers(0, w - sw + 1, n // 2)
    y0[-1], x0[-1] = h - sh, w - sw  # the last legal corner
    return y0, x0


def _lattice_inputs(n, s, d, seed):
    """eblk and sample arrays at subset side ``s`` (an int, or (sy, sx))
    and wobble ``d``, with out-of-range offsets (-1 and 2d+1, and far ones)
    injected."""
    rng = np.random.default_rng(seed)
    w = 4 + 2 * d
    sy, sx = (s, s) if np.isscalar(s) else s
    side = (n, sy, sx)
    eblk = np.round(rng.uniform(0, 255, (n, sy + w - 1, sx + w - 1))
                    ).astype(np.float32)
    dy = rng.integers(0, 2 * d + 1, side).astype(np.int32)
    dx = rng.integers(0, 2 * d + 1, side).astype(np.int32)
    bad = rng.uniform(size=side) < 0.1
    dy[bad] = rng.choice([-1, 2 * d + 1, -7, 99], bad.sum())
    bad2 = rng.uniform(size=side) < 0.1
    dx[bad2] = rng.choice([-1, 2 * d + 1, -3, 50], bad2.sum())
    fy = rng.uniform(0, 1, side).astype(np.float32)
    fx = rng.uniform(0, 1, side).astype(np.float32)
    fy[0, 0, :4] = [0.0, np.float32(np.nextafter(1, 0)), 0.5, 0.25]
    return eblk, dy, dx, fy, fx


def _out_of_range(dy, dx, d):
    return (dy < 0) | (dy > 2 * d) | (dx < 0) | (dx > 2 * d)


def _lattice3d_inputs(n, s, d, seed):
    """eblk [n, s+w-1, ...] and the six [n, s, s, s] sample arrays at
    wobble ``d`` (``s`` an int, or the side per axis (sz, sy, sx)), with
    out-of-range offsets (-1 and 2d+1, and far ones) injected on every
    axis."""
    rng = np.random.default_rng(seed)
    side = (s,) * 3 if np.isscalar(s) else tuple(s)
    ext = tuple(x + 3 + 2 * d for x in side)
    eblk = np.round(rng.uniform(0, 255, (n, *ext))).astype(np.float32)
    offs = []
    for far in ((-4, 30), (-2, 77), (-9, 5 + 2 * d)):
        a = rng.integers(0, 2 * d + 1, (n, *side)).astype(np.int32)
        bad = rng.uniform(size=a.shape) < 0.05
        a[bad] = rng.choice([-1, 2 * d + 1, *far], bad.sum())
        offs.append(a)
    fracs = [rng.uniform(0, 1, (n, *side)).astype(np.float32)
             for _ in range(3)]
    fracs[2][0, 0, 0, :4] = [0.0, np.float32(np.nextafter(1, 0)), 0.5, 0.25]
    return (eblk, *offs, *fracs)


def _out_of_range_3d(dz, dy, dx, d):
    return ((dz < 0) | (dz > 2 * d) | (dy < 0) | (dy > 2 * d) | (dx < 0)
            | (dx > 2 * d))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sh,sw", [(32, 32), (33, 33), (40, 40), (48, 48)])
def test_gather_kernel_bit_exact(cuda, sh, sw):
    rng = np.random.default_rng(sh)
    img = torch.from_numpy(rng.uniform(0, 255, (900, 280)).astype(np.float32))
    y0, x0 = (torch.from_numpy(a) for a in _corners(3000, 900, 280, sh, sw,
                                                    seed=sh, low=-sh))
    before = gather2d.gather_windows_2d.launches
    got = gather2d.gather_windows_2d(img.to(cuda), y0.to(cuda), x0.to(cuda),
                                     sh=sh, sw=sw)
    torch.cuda.synchronize()
    assert gather2d.gather_windows_2d.launches == before + 1
    want = gather2d.gather_windows_2d_plain(img, y0, x0, sh=sh, sw=sw)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", [(2, 500), (6, 100)])
def test_lattice_kernel_vs_plain(cuda, d, n):
    arrs = [torch.from_numpy(a) for a in _lattice_inputs(n, 33, d, seed=d)]
    got = lattice2d.lattice_eval_2d(*(a.to(cuda) for a in arrs), d_wobble=d)
    want = lattice2d.lattice_eval_2d_plain(*(a.to(cuda) for a in arrs),
                                           d_wobble=d)
    torch.cuda.synchronize()
    bad = _out_of_range(arrs[1], arrs[2], d).to(cuda)
    assert (got[bad] == 0).all()
    tol = 1e-6 * float(arrs[0].abs().max())
    assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,n,sh,sw", [
    (900, 280, 3001, 25, 25),  # 625 outputs a window: groups of 4 straddle
    (900, 280, 10007, 33, 33),  # several rounds of the grid, ragged
    (1200, 1920, 1489, 41, 41),
    (90, 70, 5, 1, 1),  # 1x1 windows: a group of 4 spans four windows
    (90, 70, 7, 1, 70),  # 1xW rows: sw = W
    (90, 70, 9, 2, 1),  # 2 outputs a window
    (90, 70, 13, 1, 3),  # 3 outputs a window
    (90, 70, 1, 33, 33),  # N = 1: one group short of 1,089, a tail of 1
    (90, 70, 2, 5, 7),  # 70 outputs: a tail of 2
    (90, 70, 4, 90, 70),  # the whole image
])
def test_gather_kernel_edge_shapes(cuda, h, w, n, sh, sw):
    """Kernel 1 ``==`` its plain version where the flat walk in groups of
    four outputs crosses rows and windows oddly: sh*sw not a multiple of 4,
    fewer than 4 outputs a window, N = 1, N past one round of the
    persistent grid, sw = W, and corners that need clamping (the first half
    legal, the rest up to a window past either end)."""
    rng = np.random.default_rng(h + n + sh * sw)
    img = torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32))
    y0, x0 = (torch.from_numpy(a) for a in _corners(n, h, w, sh, sw,
                                                    seed=n, low=-sh))
    before = gather2d.gather_windows_2d.launches
    got = gather2d.gather_windows_2d(img.to(cuda), y0.to(cuda), x0.to(cuda),
                                     sh=sh, sw=sw)
    torch.cuda.synchronize()
    assert gather2d.gather_windows_2d.launches == before + 1
    want = gather2d.gather_windows_2d_plain(img, y0, x0, sh=sh, sw=sw)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_gather_kernel_unaligned_inputs(cuda):
    """Kernel 1 on an image and corners that start 4 bytes past a 16-byte
    boundary (views into larger tensors): ``==`` its plain version."""
    rng = np.random.default_rng(5)
    big = torch.from_numpy(rng.uniform(0, 255, 900 * 280 + 1).astype(
        np.float32)).to(cuda)
    img = big[1:].view(900, 280)
    y0, x0 = (torch.from_numpy(np.concatenate([a[:1], a])).to(cuda)[1:]
              for a in _corners(777, 900, 280, 33, 33, seed=5, low=-33))
    got = gather2d.gather_windows_2d(img, y0, x0, sh=33, sw=33)
    want = gather2d.gather_windows_2d_plain(img, y0, x0, sh=33, sw=33)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d,n,s", [
    (2, 1, 33),  # N = 1: the POI splits into bands of rows to fill the card
    (6, 1, 33),
    (1, 1, 5),
    (1, 37, 17),  # N below the persistent grid
    (2, 3, 7),
    (2, 2500, 33),  # N above the grid, 1,089 samples a POI
    (2, 4001, 25),
    (6, 940, 33),  # D=6: three slots of a whole POI do not fit, two do
    (6, 1313, 25),
    (2, 300, 45),  # not even two slots fit: bands of rows in three slots
    (6, 200, 41),
    (1, 600, 9),
    (2, 50, (9, 31)),  # sy != sx
    (2, 9, 32),  # even sides: POI blocks off the 16-byte grid
])
def test_lattice_kernel_edge_shapes(cuda, d, n, s):
    """Kernel 2 ``==`` its plain version, and exactly 0 where an offset is
    out of range, where the persistent blocks, the ring of staged items and
    the bands of rows meet odd shapes: samples a POI not a multiple of 4,
    N = 1, N below and above the grid, D = 1, 2 and 6, rings of three and
    of two whole POIs, and POIs split into bands because one does not fit
    a slot."""
    arrs = [torch.from_numpy(a).to(cuda)
            for a in _lattice_inputs(n, s, d, seed=n + d)]
    before = lattice2d.lattice_eval_2d.launches
    got = lattice2d.lattice_eval_2d(*arrs, d_wobble=d)
    want = lattice2d.lattice_eval_2d_plain(*arrs, d_wobble=d)
    torch.cuda.synchronize()
    assert lattice2d.lattice_eval_2d.launches == before + 1
    bad = _out_of_range(arrs[1], arrs[2], d)
    assert bad.any() and (got[bad] == 0).all()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_lattice_kernel_unaligned_inputs(cuda):
    """Kernel 2 on blocks and sample arrays that start 4 bytes past a
    16-byte boundary (views into larger tensors): ``==`` its plain
    version."""
    arrs = []
    for a in _lattice_inputs(300, 33, 2, seed=9):
        flat = torch.from_numpy(np.concatenate([a.ravel()[:1], a.ravel()]))
        arrs.append(flat.to(cuda)[1:].view(a.shape))
    got = lattice2d.lattice_eval_2d(*arrs, d_wobble=2)
    want = lattice2d.lattice_eval_2d_plain(*arrs, d_wobble=2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_bad_tensors(cuda):
    img = torch.zeros((20, 20), device=cuda)
    c64 = torch.zeros(3, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        gather2d.gather_windows_2d(img, c64, c64, sh=4, sw=4)
    c32 = torch.zeros(3, dtype=torch.int32)  # on the CPU
    with pytest.raises(ValueError):
        gather2d.gather_windows_2d(img, c32, c32, sh=4, sw=4)


@pytest.mark.cuda
@pytest.mark.parametrize("d,n,s", [(1, 6, 61), (1, 40, 17), (2, 5, 33)])
def test_lattice3d_kernel_vs_plain(cuda, d, n, s):
    """The main path's 61^3 shape and two others; bit-equal to the plain
    version (the same roundings in the same order), 0 out of range."""
    arrs = [torch.from_numpy(a) for a in _lattice3d_inputs(n, s, d, seed=s)]
    before = lattice3d.lattice_eval_3d.launches
    got = lattice3d.lattice_eval_3d(*(a.to(cuda) for a in arrs), d_wobble=d)
    want = lattice3d.lattice_eval_3d_plain(*(a.to(cuda) for a in arrs),
                                           d_wobble=d)
    torch.cuda.synchronize()
    assert lattice3d.lattice_eval_3d.launches == before + 1
    bad = _out_of_range_3d(*arrs[1:4], d).to(cuda)
    assert bad.any() and (got[bad] == 0).all()
    tol = 1e-6 * float(arrs[0].abs().max())
    assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("d,n,side", [
    (1, 150, (37, 33, 33)),  # runs of planes that do not divide 37
    (1, 7, (37, 61, 45)),  # r=30 rows: two bands; ragged runs
    (1, 2, (5, 64, 201)),  # wide rows: five bands of 13 and 12 rows
    (1, 5, (9, 6, 6)),  # 11x11 planes: a range that is not 16-byte aligned
    (2, 3, (11, 20, 9)),  # D=2: a ring of 9 planes
])
def test_lattice3d_kernel_equals_plain(cuda, d, n, side):
    """The ring of staged planes on shapes that split a POI into runs of
    planes and bands of rows, or stage ranges off the 16-byte grid: equal
    to the plain version with ``==``, 0 out of range on every axis."""
    arrs = [torch.from_numpy(a).to(cuda)
            for a in _lattice3d_inputs(n, side, d, seed=sum(side))]
    got = lattice3d.lattice_eval_3d(*arrs, d_wobble=d)
    want = lattice3d.lattice_eval_3d_plain(*arrs, d_wobble=d)
    torch.cuda.synchronize()
    bad = _out_of_range_3d(*arrs[1:4], d)
    for a in arrs[1:4]:
        assert ((a < 0) | (a > 2 * d)).any()
    assert (got[bad] == 0).all()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_lattice3d_wrapper_refuses_bad_tensors(cuda):
    arrs = [torch.from_numpy(a).to(cuda)
            for a in _lattice3d_inputs(2, 5, 1, seed=0)]
    with pytest.raises(ValueError):
        lattice3d.lattice_eval_3d(*arrs, d_wobble=2)  # eblk too small
    bad = list(arrs)
    bad[1] = bad[1].to(torch.int64)
    with pytest.raises(ValueError):
        lattice3d.lattice_eval_3d(*bad, d_wobble=1)
    bad = list(arrs)
    bad[4] = bad[4].cpu()
    with pytest.raises(ValueError):
        lattice3d.lattice_eval_3d(*bad, d_wobble=1)
    bad = list(arrs)
    bad[5] = bad[5].transpose(1, 3)
    with pytest.raises(ValueError):
        lattice3d.lattice_eval_3d(*bad, d_wobble=1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,shape,kind,staged", [
    (512, (60, 60, 60), "random", True),  # one DVC chunk
    (512, (60, 60, 60), "scattered", True),
    (101, (60, 60, 60), "tie", True),  # the DVC queue's last chunk
    (101, (60, 60, 60), "negative", True),
    (101, (60, 60, 60), "cap", True),
    (101, (60, 60, 60), "half", True),
    (6, (12, 10, 14), "random", True),
    (6, (12, 10, 14), "scattered", True),
    (6, (12, 10, 14), "tie", True),
    (6, (12, 10, 14), "negative", True),
    (6, (12, 10, 14), "cap", True),
    (6, (12, 10, 14), "half", True),
    (5, (7, 9, 11), "random", True),  # slabs of 4 and 3 planes
    (3, (2, 180, 172), "tie", True),  # runs of one staged plane
    (3, (2, 250, 240), "random", False),  # planes past shared memory
    (3, (2, 250, 240), "tie", False),
])
def test_rerank3d_kernel_equals_plain(cuda, n, shape, kind, staged):
    import chip_smoke as cs

    ref_w, tar_w, flat = (torch.from_numpy(a).to(cuda) for a in
                          cs.rerank3d_case(n, shape, kind, seed=n + shape[0]))
    v = flat.shape[1]
    cand = torch.topk(flat, rerank3d.NCAND, dim=1).indices
    assert (rerank3d.smem_bytes(*shape) > 0) == staged
    before = rerank3d.rerank_3d.launches
    got = rerank3d.rerank_3d(ref_w, tar_w, cand)
    assert rerank3d.rerank_3d.launches == before + 1
    want = fftcc._rerank3d(torch.round(ref_w).reshape(n, v).to(torch.int32),
                           torch.round(tar_w).reshape(n, v).to(torch.int32),
                           flat, *shape)
    assert torch.equal(got, want)
    assert torch.equal(rerank3d.rerank_3d(ref_w, tar_w, cand), got)


@pytest.mark.cuda
def test_rerank3d_wrapper_refuses_bad_tensors(cuda):
    import chip_smoke as cs

    ref_w, tar_w, flat = (torch.from_numpy(a).to(cuda) for a in
                          cs.rerank3d_case(4, (6, 8, 10), "random", seed=0))
    cand = torch.topk(flat, rerank3d.NCAND, dim=1).indices
    for bad in ((ref_w.double(), tar_w, cand),
                (ref_w, tar_w, cand.to(torch.int32)),
                (ref_w.cpu(), tar_w.cpu(), cand.cpu()),
                (ref_w, tar_w.cpu(), cand),
                (ref_w.transpose(1, 3), tar_w, cand),
                (ref_w, tar_w[:3], cand),
                (ref_w, tar_w, cand[:, :4].contiguous())):
        with pytest.raises(ValueError):
            rerank3d.rerank_3d(*bad)


@pytest.mark.cuda
def test_fftcc3d_rerank_cuda_matches_cpu(cuda):
    """fftcc3d on cuda (the re-rank kernel) and on cpu (``_rerank3d``) on
    an integral pair with a block of half-integral target voxels: the POIs
    whose windows meet it are not integral and keep their float32 argmax;
    displacements and validity equal, zncc within 1e-5."""
    rng = np.random.default_rng(5)
    dims, r = (40, 40, 40), 6
    ref = rng.integers(0, 256, dims).astype(np.float32)
    tar = (np.roll(ref, (1, -2, 1), axis=(0, 1, 2))
           + rng.integers(0, 3, dims)).astype(np.float32)
    tar[24:28, 24:28, 24:28] += 0.5
    g = np.arange(r, 40 - r, 3, dtype=np.float32)
    zs, ys, xs = (a.ravel() for a in np.meshgrid(g, g, g, indexing="ij"))
    c = np.stack([zs, ys, xs])
    near = ((c - r < 28) & (c + r > 24)).all(axis=0)
    assert near.any() and not near.all()
    zero = np.zeros_like(xs)
    outs, stats = {}, {}
    for dev in (cuda, torch.device("cpu")):
        stats[dev.type] = collections.Counter()
        args = [torch.from_numpy(a).to(dev)
                for a in (ref, tar, xs, ys, zs, zero, zero, zero)]
        outs[dev.type] = [a.cpu() for a in fftcc.fftcc3d(
            *args, rx=r, ry=r, rz=r, stats=stats[dev.type])]
    assert stats["cuda"] == stats["cpu"] == {"rerank": 1}
    for a, b in zip(outs["cuda"][:3] + outs["cuda"][4:],
                    outs["cpu"][:3] + outs["cpu"][4:]):
        assert torch.equal(a, b)
    torch.testing.assert_close(outs["cuda"][3], outs["cpu"][3], rtol=0,
                               atol=1e-5)


@pytest.mark.cuda
def test_dvc_modules_cuda_match_cpu(cuda):
    """FFTCC3D -> ICGN3D1 on cuda (the lattice kernel, and the exact
    fallback for strained seeds) against the same modules on the cpu."""
    import opencorr_tpu_torch as ot
    from scipy.ndimage import gaussian_filter, map_coordinates

    rng = np.random.default_rng(11)
    shape = (64, 48, 48)
    base = gaussian_filter(rng.standard_normal(shape), 1.5)
    ref = np.clip(np.round(base / base.std() * 28 + 128), 0, 255)
    zz, yy, xx = np.mgrid[0:64, 0:48, 0:48].astype(np.float64)
    tar = map_coordinates(ref, [zz - 0.6, yy + 0.3, xx - 0.4], order=3,
                          mode="nearest")
    ref, tar = ref.astype(np.float32), np.round(tar).astype(np.float32)
    seeded = {}
    for dev in ("cuda", "cpu"):
        f = ot.FFTCC3D(8, 8, 8, device=dev)
        f.set_images(ref, tar)
        seeded[dev] = ot.table_to_numpy(f.compute(ot.poi_grid_3d(
            (16, 16, 16), 3, 3, 4, 8, device=dev)))
    np.testing.assert_array_equal(seeded["cuda"]["p"], seeded["cpu"]["p"])
    s = seeded["cpu"]
    p = s["p"].copy()
    p[::4, 11] = 0.25  # strained seeds: the exact fallback
    outs, stats = {}, {}
    for dev in ("cuda", "cpu"):
        t = ot.table_from_numpy_3d(s["x"], s["y"], s["z"], p, s["r"],
                                   s["e"], s["sr"], device=dev)
        m = ot.ICGN3D1(8, 8, 8, device=dev)
        m.set_images(ref, tar)
        m.prepare()
        outs[dev] = ot.table_to_numpy(m.compute(t))
        stats[dev] = dict(m.stats)
    assert stats["cuda"]["lattice"] > 0 and stats["cuda"]["fallback"] > 0
    zc, zp = outs["cuda"]["r"][:, 3], outs["cpu"]["r"][:, 3]
    np.testing.assert_array_equal(np.where(zc < 0, zc, 1),
                                  np.where(zp < 0, zp, 1))
    ok = zc > 0
    assert ok.mean() > 0.9
    np.testing.assert_allclose(outs["cuda"]["p"][ok][:, [0, 4, 8]],
                               outs["cpu"]["p"][ok][:, [0, 4, 8]], rtol=0,
                               atol=1e-4)


def _desc_inputs(k, crop, scale, seed, shape=(80, 84, 90), blur=0.0):
    """A random volume (Gaussian-blurred at ``blur`` voxels when given), k
    keypoints (a quarter within 2 voxels of a face), random rotations, and
    their window starts and tables."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    noise = 128 + 40 * rng.standard_normal(shape)
    if blur:
        noise = gaussian_filter(noise, blur)
    vol = torch.from_numpy(np.float32(noise))
    coords = [rng.integers(0, d, k) for d in shape]
    for j in range(k // 4):
        coords[j % 3][j] = rng.choice([0, 1, shape[j % 3] - 2])
    zi, yi, xi = (torch.from_numpy(c.astype(np.int32)) for c in coords)
    rots = []
    for _ in range(k):
        a = rng.standard_normal(3)
        a /= np.linalg.norm(a)
        b = rng.standard_normal(3)
        b -= (b @ a) * a
        b /= np.linalg.norm(b)
        rots.append(np.stack([a, b, np.cross(a, b)]).reshape(9))
    rot = torch.from_numpy(np.float32(rots))
    starts, tab = desc3d.prepare_tables(shape, xi, yi, zi, crop=crop,
                                        scale=scale, unit_xyz=(1.0, 1.0, 1.0))
    return vol, starts, tab, rot


@pytest.mark.cuda
@pytest.mark.parametrize("crop_r,scale,k", [(23, 1.6, 40), (29, 2.0159, 9),
                                            (36, 2.5398, 3), (8, 0.55, 300),
                                            (23, 1.6, 1200)])
def test_desc3d_kernel_vs_plain(cuda, crop_r, scale, k):
    """The Torus path's three octave-0 crops and a small crop at fewer
    keypoints than the 1,056 blocks the kernel aims for (each keypoint's
    box split into z-bands that add into S), and crop 23 at 1,200
    keypoints, as on the main path's layers (one block per keypoint, which
    stores its S).  The plain version runs in chunks of 300 keypoints."""
    crop = (crop_r,) * 3
    args = [a.to(cuda) for a in _desc_inputs(k, crop, scale, seed=crop_r)]
    kw = dict(crop=crop, scale=scale, unit_xyz=(1.0, 1.0, 1.0))
    before = desc3d.descriptor_hist.launches
    got = desc3d.descriptor_hist(*args, **kw)
    torch.cuda.synchronize()
    assert desc3d.descriptor_hist.launches == before + 1
    want = torch.cat([desc3d.descriptor_hist_plain(
        *(a[lo:lo + 300] if i else a for i, a in enumerate(args)), **kw)
        for lo in range(0, k, 300)])
    m = float(want.abs().max())
    assert m > 0
    assert float((got - want).abs().max()) <= 1e-5 * m


@pytest.mark.cuda
@pytest.mark.parametrize("crop,scale,k,blur,shape", [
    ((23, 23, 23), 1.6, 1100, 1.6, (80, 84, 90)),  # one block a keypoint
    ((29, 29, 29), 2.0159, 600, 2.0, (80, 84, 90)),  # z-bands
    ((10, 14, 20), 0.9, 700, 1.0, (80, 84, 90)),  # a box of unequal sides
    ((50, 50, 50), 3.5, 12, 3.0, (110, 112, 114)),  # more rows than a block
])
def test_desc3d_kernel_on_blurred_volumes(cuda, crop, scale, k, blur,
                                          shape):
    """Blurred volumes, where neighbouring voxels share their face and tent
    bins and the kernel merges their adds across the warp, above and below
    the 1,056 blocks it aims for, with windows clamped at the faces, and a
    crop whose 101x101 (z, y) rows exceed one block's row table: every
    keypoint within 1e-5 x max|S| of the plain version."""
    args = [a.to(cuda) for a in _desc_inputs(k, crop, scale, seed=k,
                                             shape=shape, blur=blur)]
    kw = dict(crop=crop, scale=scale, unit_xyz=(1.0, 1.0, 1.0))
    got = desc3d.descriptor_hist(*args, **kw)
    want = torch.cat([desc3d.descriptor_hist_plain(
        *(a[lo:lo + 300] if i else a for i, a in enumerate(args)), **kw)
        for lo in range(0, k, 300)])
    torch.cuda.synchronize()
    m = float(want.abs().max())
    assert m > 0
    assert float((got - want).abs().max()) <= 1e-5 * m


@pytest.mark.cuda
def test_desc3d_wrapper_refuses_bad_tensors(cuda):
    crop = (6, 6, 6)
    vol, starts, tab, rot = (a.to(cuda) for a in _desc_inputs(
        4, crop, 0.4, seed=1, shape=(20, 22, 24)))
    kw = dict(crop=crop, scale=0.4, unit_xyz=(1.0, 1.0, 1.0))
    with pytest.raises(ValueError):
        desc3d.descriptor_hist(vol, starts.long(), tab, rot, **kw)
    with pytest.raises(ValueError):
        desc3d.descriptor_hist(vol, starts, tab.cpu(), rot, **kw)
    with pytest.raises(ValueError):
        desc3d.descriptor_hist(vol.double(), starts, tab, rot, **kw)
    with pytest.raises(ValueError):
        desc3d.descriptor_hist(vol, starts, tab[:, :, ::2], rot, **kw)


@pytest.mark.cuda
def test_sift3d_slice_cuda_match_cpu(cuda):
    """SIFT3D on cuda (kernel 4 on octave 0's first layer) and on the cpu
    on one small pair: equal keypoint counts and matched sets."""
    import opencorr_tpu_torch as ot
    from scipy.ndimage import gaussian_filter, shift as ndshift

    rng = np.random.default_rng(2)
    base = (gaussian_filter(rng.standard_normal((72, 72, 72)), 1.5) * 50
            + 128).astype(np.float32)
    ref = base[10:62, 10:62, 10:62]
    tar = ndshift(base, (2.0, -1.0, 1.5), order=3)[10:62, 10:62, 10:62]
    out = {}
    for dev in ("cuda", "cpu"):
        s = ot.SIFT3D(pyramid_backend="device", device=dev)
        s.set_images(np.ascontiguousarray(ref), np.ascontiguousarray(tar))
        before = desc3d.descriptor_hist.launches
        s.compute()
        out[dev] = (s.ref_kp_count, s.tar_kp_count,
                    set(map(tuple, s.ref_matched_kp.tolist())),
                    desc3d.descriptor_hist.launches - before)
    assert out["cuda"][:3] == out["cpu"][:3]
    assert out["cuda"][3] == 2 and out["cpu"][3] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("crop_r,scale,k", [(23, 1.6, 40), (36, 2.5398, 1100)])
def test_desc3d_kernel_bf16_vs_plain(cuda, crop_r, scale, k):
    """The bfloat16-operand instance (``hist_bf16``) against the plain
    version with the same flag: both round the same float32 factors, so
    within 1e-5 x max|S| (the sums' order); and away from the float32
    histogram."""
    crop = (crop_r,) * 3
    args = [a.to(cuda) for a in _desc_inputs(k, crop, scale, seed=k,
                                             blur=1.6)]
    kw = dict(crop=crop, scale=scale, unit_xyz=(1.0, 1.0, 1.0))
    got = desc3d.descriptor_hist(*args, hist_bf16=True, **kw)
    f32 = desc3d.descriptor_hist(*args, **kw)
    want = torch.cat([desc3d.descriptor_hist_plain(
        *(a[lo:lo + 300] if i else a for i, a in enumerate(args)),
        hist_bf16=True, **kw) for lo in range(0, k, 300)])
    torch.cuda.synchronize()
    m = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * m
    assert float((f32 - want).abs().max()) > 1e-4 * m


@pytest.mark.cuda
def test_sift3d_host_path_cuda_match_cpu(cuda):
    """SIFT3D's host path (the default) on cuda (kernel 4 on the layers its
    route allows) and on the cpu: equal keypoints and matched sets; the
    descriptor stage on the cpu's keypoints and rotations within 1e-5 x
    max|desc| on every layer.  (The devices' own rotations differ by
    float32 noise, which moves a few descriptors by about 1e-3.)"""
    import opencorr_tpu_torch as ot
    from scipy.ndimage import gaussian_filter, shift as ndshift
    from opencorr_tpu_torch.ops import sift3d as ops3d

    rng = np.random.default_rng(2)
    base = (gaussian_filter(rng.standard_normal((72, 72, 72)), 1.5) * 50
            + 128).astype(np.float32)
    ref = np.ascontiguousarray(base[10:62, 10:62, 10:62])
    tar = np.ascontiguousarray(
        ndshift(base, (2.0, -1.0, 1.5), order=3)[10:62, 10:62, 10:62])
    mods, launches = {}, {}
    for dev in ("cuda", "cpu"):
        s = ot.SIFT3D(device=dev)
        s.set_images(ref, tar)
        before = desc3d.descriptor_hist.launches
        s.compute()
        mods[dev] = s
        launches[dev] = desc3d.descriptor_hist.launches - before
    c, p = mods["cuda"], mods["cpu"]
    assert (c.ref_kp_count, c.tar_kp_count) == (p.ref_kp_count,
                                                p.tar_kp_count)
    np.testing.assert_array_equal(c.ref_matched_kp, p.ref_matched_kp)
    np.testing.assert_array_equal(c.tar_matched_kp, p.tar_matched_kp)
    assert launches["cuda"] == 2 and launches["cpu"] == 0
    plan, vols = p._gaussian_pyramid(torch.from_numpy(ref))
    kp = p._extract(torch.from_numpy(ref), "ref")[0].numpy()
    cfg = p.sift_config
    routes = set()
    for m in range(cfg.n_octave):
        for n in range(1, cfg.n_octave_layers + 1):
            sel = (kp[:, 3] == m) & (kp[:, 4] == n)
            if not sel.any():
                continue
            i = m * (cfg.n_octave_layers + 3) + n
            g, vg = plan[i], vols[i]
            x, y, z = (torch.from_numpy((kp[sel, j] / 2 ** m).astype(
                np.int64)) for j in range(3))
            win, x0, y0, z0 = ops3d.gather_windows_3d(vg, x, y, z,
                                                      p._radii(g)[0])
            rot = ops3d.assign_orientation(
                win, x0, y0, z0, x, y, z, tuple(vg.shape[::-1]), g.scale,
                g.units, cfg.gradient_threshold, cfg.beta, cfg.gamma)[0]
            want, _, route = p._describe(vg, g, x, y, z, rot)
            got, _, _ = c._describe(vg.cuda(), g, x.cuda(), y.cuda(),
                                    z.cuda(), rot.cuda())
            routes.add(route)
            m_ = float(want.abs().max())
            assert float((got.cpu() - want).abs().max()) <= 1e-5 * m_
    assert "kernel 4" in routes


@pytest.mark.cuda
def test_feature_affine_device_search_cuda_matches_cpu(cuda):
    """The device neighbour search and FeatureAffine3D/2D on it: cuda equal
    to cpu (indices, masks, codes; p within 1e-5)."""
    import opencorr_tpu_torch as ot
    from opencorr_tpu_torch.ops import feature_affine as fops

    rng = np.random.default_rng(3)
    for dim in (2, 3):
        ref = rng.uniform(10, 200, (3000, dim)).astype(np.float32)
        tar = ref + rng.normal(0, 0.2, ref.shape).astype(np.float32) + 1.5
        q = rng.uniform(0, 210, (5000, dim)).astype(np.float32)
        outs = {}
        for dev in ("cuda", "cpu"):
            outs[dev] = [a.cpu() for a in fops.device_candidates(
                torch.from_numpy(ref).to(dev), torch.from_numpy(q).to(dev),
                12.0, 7, dim + 1, 128)]
        for a, b in zip(outs["cuda"], outs["cpu"]):
            assert torch.equal(a, b)
        tabs = {}
        for dev in ("cuda", "cpu"):
            if dim == 2:
                m = ot.FeatureAffine2D(10, 10, neighbor_backend="device",
                                       device=dev)
                t = ot.new_table_2d(*q.T, device=dev)
            else:
                m = ot.FeatureAffine3D(10, 10, 10, neighbor_backend="device",
                                       device=dev)
                t = ot.new_table_3d(*q.T, device=dev)
            m.set_keypoint_pair(ref, tar)
            tabs[dev] = m.compute(t)
        assert torch.equal(tabs["cuda"].r.cpu(), tabs["cpu"].r)
        assert float((tabs["cuda"].p.cpu() - tabs["cpu"].p).abs().max()) \
            <= 1e-5


@pytest.mark.cuda
def test_icgn3d1_tile_cuda_matches_cpu(cuda):
    """``eval_mode="tile"``: cuda against cpu on the guard volumes, codes
    equal and u/v/w within 1e-4 voxel; no lattice launch."""
    from opencorr_tpu_torch.ops import bspline, gradient, icgn

    ref, tar = _guard_volumes()
    rng = np.random.default_rng(5)
    n = 24
    xs, ys, zs = (rng.uniform(10, 30, n).astype(np.float32)
                  for _ in range(3))
    p0 = np.zeros((n, 12), np.float32)
    p0[:4, 0] = -1.7  # seeds whose iterates leave a 2-voxel window
    outs = {}
    for dev in ("cuda", "cpu"):
        r = torch.from_numpy(ref).to(dev)
        before = lattice3d.lattice_eval_3d.launches
        out = icgn.icgn3d1(
            *(getattr(gradient, f"gradient_{a}_3d")(r) for a in "xyz"), r,
            bspline.tricubic_prepare(torch.from_numpy(tar).to(dev)),
            *(torch.from_numpy(a.copy()).to(dev) for a in (xs, ys, zs, p0)),
            torch.zeros(n, device=dev), 0.001, 10.0, rx=6, ry=6, rz=6,
            window_margin=2, eval_mode="tile")
        assert lattice3d.lattice_eval_3d.launches == before
        outs[dev] = [a.cpu() for a in out]
    zc, zp = outs["cuda"][4], outs["cpu"][4]
    assert torch.equal(torch.where(zc < 0, zc, 1.0), torch.where(zp < 0, zp,
                                                                  1.0))
    assert (zp[4:] > 0.9).all()
    ok = zp > 0
    d = (outs["cuda"][0] - outs["cpu"][0])[ok][:, [0, 4, 8]].abs().max()
    assert float(d) <= 1e-4


@pytest.mark.cuda
def test_gather_kernel_epipolar_windows(cuda):
    """Kernel 1 at the stereo path's 41x41 epipolar candidate subsets (one
    chunk: 1,489 POIs x 11 candidates) on a GT4-size image."""
    rng = np.random.default_rng(41)
    img = torch.from_numpy(np.round(rng.uniform(0, 255, (1200, 1920))).astype(
        np.float32))
    y0, x0 = (torch.from_numpy(a) for a in _corners(16379, 1200, 1920, 41,
                                                    41, seed=41, low=-41))
    got = gather2d.gather_windows_2d(img.to(cuda), y0.to(cuda), x0.to(cuda),
                                     sh=41, sw=41)
    torch.cuda.synchronize()
    want = gather2d.gather_windows_2d_plain(img, y0, x0, sh=41, sw=41)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0.3, 3.2])
def test_windowed_eval_second_order_layouts(cuda, shift):
    """Kernel 2 through the windowed eval on second-order warped subsets
    (r=16): D=2 blocks for all POIs and, where every 8th POI has the
    larger seed error, the D=6 correction; cuda within 1e-6 x 255 of
    cpu."""
    from opencorr_tpu_torch.ops import bspline
    from opencorr_tpu_torch.ops import icgn as ticgn
    from opencorr_tpu_torch.ops import warp as twarp

    rng = np.random.default_rng(int(shift * 10))
    img = np.round(rng.uniform(30, 220, (300, 320))).astype(np.float32)
    n, r = 400, 16
    cx = rng.integers(60, 260, n).astype(np.float32)
    cy = rng.integers(60, 240, n).astype(np.float32)
    p = np.zeros((n, 12), np.float32)
    p[:, [0, 6]] = rng.uniform(-1.5, 1.5, (n, 2))
    p[:, [1, 2, 7, 8]] = rng.normal(0, 0.01, (n, 4))
    p[:, [3, 4, 5, 9, 10, 11]] = rng.normal(0, 2e-4, (n, 6))
    wm = twarp.warp2d2_from_p(torch.from_numpy(p)).double().numpy()
    g = np.arange(-r, r + 1, dtype=np.float64)
    xl, yl = np.tile(g, 2 * r + 1), np.repeat(g, 2 * r + 1)
    basis = np.stack([xl * xl, xl * yl, yl * yl, xl, yl, np.ones_like(xl)])
    off = np.where(np.arange(n) % 8 == 0, shift, 0.3)[:, None]
    gx = (cx[:, None] + off + wm[:, 3] @ basis).astype(np.float32)
    gy = (cy[:, None] - off + wm[:, 4] @ basis).astype(np.float32)
    seed = [torch.from_numpy(a) for a in (cx, cy, p[:, 0], p[:, 6])]
    outs, branches = {}, {}
    for dev in ("cpu", "cuda"):
        t_img = torch.from_numpy(img).to(dev)
        lut = bspline.bicubic_prepare(t_img)
        branches[dev] = collections.Counter()
        st, fn = ticgn.make_windowed_eval2d_state(
            t_img, lut, *(a.to(dev) for a in seed), rx=r, ry=r, margin=8,
            stats=branches[dev])
        before = lattice2d.lattice_eval_2d.launches
        outs[dev] = fn(st, torch.from_numpy(gx).to(dev),
                       torch.from_numpy(gy).to(dev),
                       torch.ones(n, dtype=torch.bool, device=dev)).cpu()
    torch.cuda.synchronize()
    assert lattice2d.lattice_eval_2d.launches > before
    assert branches["cuda"] == branches["cpu"]
    assert (branches["cuda"]["correct"] > 0) == (shift > 1)
    np.testing.assert_array_equal(outs["cuda"] == -1, outs["cpu"] == -1)
    assert float((outs["cuda"] - outs["cpu"]).abs().max()) <= 255e-6


@pytest.mark.cuda
def test_epipolar_search_cuda_matches_cpu(cuda):
    """EpipolarSearch with the stereo example's settings on a small pair
    rendered through the GT4 cameras (chip_smoke.py's scene): codes and
    iterations equal, u/v within 1e-3 px."""
    import chip_smoke as cs
    import opencorr_tpu_torch as ot

    views, pts, _, _ = cs.stereo_inputs((224, 288), ((76, 104), 13, 8, 12),
                                        seed=5)
    outs = {}
    for dev in ("cpu", "cuda"):
        epi = ot.EpipolarSearch(*cs.stereo_calibrations(ot, dev),
                                device=dev)
        epi.set_parallax(cs.STEREO_PARALLAX)
        epi.set_search(30, 5)
        epi.create_icgn(20, 20, 0.05, 10)
        epi.set_images(views[0], views[1])
        epi.prepare()
        outs[dev] = ot.table_to_numpy(epi.compute(ot.new_table_2d(
            pts[:, 0], pts[:, 1], device=dev)))
    zc, zp = outs["cuda"]["r"][:, 2], outs["cpu"]["r"][:, 2]
    np.testing.assert_array_equal(np.where(zc < 0, zc, 1),
                                  np.where(zp < 0, zp, 1))
    np.testing.assert_array_equal(outs["cuda"]["r"][:, 3],
                                  outs["cpu"]["r"][:, 3])
    np.testing.assert_allclose(outs["cuda"]["p"], outs["cpu"]["p"], rtol=0,
                               atol=1e-3)
    assert (zp > 0.9).mean() > 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("n,sh,sw", [(42025, 25, 25), (42025, 32, 32),
                                     (1313, 40, 40)])
def test_gather_kernel_planar_r12_shapes(cuda, n, sh, sw):
    """Kernel 1 at the r=12 shapes of the planar suite's second-order
    workloads (42,025 POIs): subsets, D=2 blocks and the correction cap's
    D=6 blocks, on a rotation-size image."""
    rng = np.random.default_rng(sh)
    img = torch.from_numpy(np.round(rng.uniform(0, 255, (512, 512))).astype(
        np.float32))
    y0, x0 = (torch.from_numpy(a) for a in _corners(n, 512, 512, sh, sw,
                                                    seed=sh, low=-sh))
    got = gather2d.gather_windows_2d(img.to(cuda), y0.to(cuda), x0.to(cuda),
                                     sh=sh, sw=sw)
    torch.cuda.synchronize()
    want = gather2d.gather_windows_2d_plain(img, y0, x0, sh=sh, sw=sw)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", [(2, 42025), (6, 1313)])
def test_lattice_kernel_equals_plain_r12(cuda, d, n):
    """Kernel 2 ``==`` its plain version at r=12: D=2 on 42,025 POIs and
    D=6 at the correction cap."""
    arrs = [torch.from_numpy(a).to(cuda)
            for a in _lattice_inputs(n, 25, d, seed=12 + d)]
    got = lattice2d.lattice_eval_2d(*arrs, d_wobble=d)
    want = lattice2d.lattice_eval_2d_plain(*arrs, d_wobble=d)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_planar_refiners_cuda_match_cpu(cuda):
    """ICLM2D1/2, NR2D1 and the self-adaptive ICGN2D1 and ICLM2D1 on a
    small translated pair: cuda against cpu, codes equal, u/v within 1e-3
    px."""
    import opencorr_tpu_torch as ot
    from scipy.ndimage import gaussian_filter, shift as ndshift

    rng = np.random.default_rng(6)
    base = gaussian_filter(rng.standard_normal((220, 240)), 1.5)
    base = base / base.std() * 28.0 + 128.0
    ref = np.round(base[20:200, 20:220]).astype(np.float32)
    tar = np.round(ndshift(base, (-0.7, 1.3), order=3)[20:200, 20:220]
                   ).astype(np.float32)
    grid = ot.poi_grid_2d((40, 40), 8, 6, 16, device="cpu")
    n = grid.n
    p = np.zeros((n, 12), np.float32)
    p[:, 0], p[:, 6] = 1.0, -1.0
    sr = rng.integers(10, 19, (n, 2)).astype(np.float32)
    seed = (grid.x.numpy(), grid.y.numpy(), p, np.zeros((n, 6), np.float32),
            np.zeros((n, 3), np.float32), sr)
    for cls, adaptive in ((ot.ICLM2D1, False), (ot.ICLM2D2, False),
                          (ot.NR2D1, False), (ot.ICGN2D1, True),
                          (ot.ICLM2D1, True)):
        outs = {}
        for dev in ("cpu", "cuda"):
            m = cls(12, 12, 0.001, 10, device=dev)
            m.set_images(ref, tar)
            m.prepare()
            if adaptive:
                m.set_self_adaptive(True)
            outs[dev] = ot.table_to_numpy(m.compute(ot.table_from_numpy(
                *seed, device=dev)))
        zc, zp = outs["cuda"]["r"][:, 2], outs["cpu"]["r"][:, 2]
        np.testing.assert_array_equal(np.where(zc < 0, zc, 1),
                                      np.where(zp < 0, zp, 1))
        np.testing.assert_allclose(outs["cuda"]["p"][:, [0, 6]],
                                   outs["cpu"]["p"][:, [0, 6]], rtol=0,
                                   atol=1e-3)
        assert (zp > 0.9).mean() > 0.9


@pytest.mark.cuda
def test_gather_kernel_reconstruction_windows(cuda):
    """Kernel 1 at the reconstruction search's 41x41 candidate subsets (one
    chunk: 2,340 POIs x 7 candidates) on a GT4-size image."""
    rng = np.random.default_rng(43)
    img = torch.from_numpy(np.round(rng.uniform(0, 255, (1200, 1920))).astype(
        np.float32))
    y0, x0 = (torch.from_numpy(a) for a in _corners(16380, 1200, 1920, 41,
                                                    41, seed=43, low=-41))
    got = gather2d.gather_windows_2d(img.to(cuda), y0.to(cuda), x0.to(cuda),
                                     sh=41, sw=41)
    torch.cuda.synchronize()
    want = gather2d.gather_windows_2d_plain(img, y0, x0, sh=41, sw=41)
    assert torch.equal(got.cpu(), want)


def _guard_volumes():
    from scipy.ndimage import gaussian_filter, map_coordinates

    rng = np.random.default_rng(12)
    shape = (48, 40, 44)
    base = gaussian_filter(rng.standard_normal(shape), 1.5)
    ref = np.clip(np.round(base / base.std() * 28 + 128), 0, 255)
    zz, yy, xx = np.mgrid[0:48, 0:40, 0:44].astype(np.float64)
    tar = map_coordinates(ref, [zz - 0.6, yy + 0.3, xx - 0.4], order=3,
                          mode="nearest")
    return ref.astype(np.float32), np.round(tar).astype(np.float32)


@pytest.mark.cuda
def test_z_guarded_icgn3d1_cuda_matches_cpu(cuda):
    """icgn3d1 with z guards through kernel 3 on cuda against the plain
    lattice eval on the cpu: codes equal (some POIs fail at the guards),
    u/v/w within 1e-4 voxel."""
    from opencorr_tpu_torch.ops import bspline, gradient, icgn

    ref, tar = _guard_volumes()
    n, r = 12, 5
    xs = np.full(n, 21.0, np.float32)
    ys = np.full(n, 19.0, np.float32)
    zs = np.linspace(10, 37, n).astype(np.float32)
    outs = {}
    for dev in ("cpu", "cuda"):
        t = lambda a: torch.from_numpy(a.copy()).to(dev)
        tref = t(ref)
        outs[dev] = [a.cpu().numpy() for a in icgn.icgn3d1(
            *(getattr(gradient, f"gradient_{a}_3d")(tref) for a in "xyz"),
            tref, bspline.tricubic_prepare(t(tar)), t(xs), t(ys), t(zs),
            t(np.zeros((n, 12), np.float32)), t(np.zeros(n, np.float32)),
            0.001, 10.0, rx=r, ry=r, rz=r, window_margin=8,
            z_guard_lo=14.5, z_guard_hi=33.5)]
    zc, zp = outs["cuda"][4], outs["cpu"][4]
    np.testing.assert_array_equal(np.where(zc < 0, zc, 1),
                                  np.where(zp < 0, zp, 1))
    assert (zp == -3.0).any() and (zp > 0.9).sum() >= 3
    np.testing.assert_allclose(outs["cuda"][0][:, [0, 4, 8]],
                               outs["cpu"][0][:, [0, 4, 8]], rtol=0,
                               atol=1e-4)


@pytest.mark.cuda
def test_sharded_icgn3d1_one_rank_cuda_matches_cpu(cuda):
    """ShardedICGN3D1 on an NCCL group of one (``make_mesh(1, axis="z")``)
    against the same group's cpu mesh, POIs near both z faces included:
    codes equal, u/v/w within 1e-4 voxel."""
    import torch.distributed as dist

    import opencorr_tpu_torch as ot
    from opencorr_tpu_torch.parallel import halo, mesh

    ref, tar = _guard_volumes()
    z = np.float32([5.0, 6.0, 24.0, 24.0, 41.0, 42.0])
    xy = np.float32([22.0, 20.0, 22.0, 20.0, 22.0, 20.0])
    p = np.zeros((6, 12), np.float32)
    p[:, 0], p[:, 4], p[:, 8] = 0.4, -0.3, 0.6
    outs = {}
    try:
        meshes = {"cuda": mesh.make_mesh(1, axis="z"),
                  "cpu": mesh.make_mesh(1, axis="z", device="cpu")}
        for dev, m in meshes.items():
            s = halo.ShardedICGN3D1(5, 5, 5, 0.001, 10)
            s.set_images(ref, tar)
            t = ot.table_from_numpy_3d(
                xy, xy, z, p, np.zeros((6, 7), np.float32),
                np.zeros((6, 6), np.float32), np.zeros((6, 3), np.float32),
                device=dev)
            outs[dev] = ot.table_to_numpy(s.compute(t, m))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    zc, zp = outs["cuda"]["r"][:, 3], outs["cpu"]["r"][:, 3]
    np.testing.assert_array_equal(np.where(zc < 0, zc, 1),
                                  np.where(zp < 0, zp, 1))
    assert (zp == -3.0).any() and (zp > 0.9).any()
    np.testing.assert_allclose(outs["cuda"]["p"][:, [0, 4, 8]],
                               outs["cpu"]["p"][:, [0, 4, 8]], rtol=0,
                               atol=1e-4)


def _dvc_step_queue(seed, device):
    """One chunk of the DVC cell as the prologue sees it: 441 POIs of the
    al_foam4 grid (7 x 7 x 9 at step 5 from (35, 35, 60)) at r=30 on a
    700 x 100 x 100 coefficient volume, windows of margin 8 on seeds within
    a voxel, and warps near the identity (0.5% strain, a voxel of
    translation) with every tenth POI pushed past its window or wobbling,
    and one NaN."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(60 + 5 * np.arange(9), 35 + 5 * np.arange(7),
                          35 + 5 * np.arange(7), indexing="ij")
    xs, ys, zs = (a.reshape(-1).astype(np.float32) for a in (x, y, z))
    n = xs.shape[0]
    u = rng.uniform(-1, 1, (3, n))
    wmat = np.tile(np.eye(4), (n, 1, 1))
    wmat[:, :3, :3] += rng.uniform(-0.005, 0.005, (n, 3, 3))
    wmat[:, :3, 3] = u.T + rng.uniform(-0.3, 0.3, (n, 3))
    wmat[::10, 2, 2] += 0.06  # wobble past D=1
    wmat[5::10, 0, 3] += rng.choice([-9.0, 9.0], len(wmat[5::10]))  # exits
    wmat[7, 1, 3] = np.nan
    dims = (700, 100, 100)
    wc = []
    for c, uu, dim in ((xs, u[0], dims[2]), (ys, u[1], dims[1]),
                       (zs, u[2], dims[0])):
        c_t = torch.from_numpy(c)
        u_t = torch.from_numpy(uu.astype(np.float32))
        wc.append(torch.clamp(torch.floor(c_t + u_t).to(torch.int32) - 38,
                              0, dim - 77).to(device))
    coeff = torch.from_numpy(rng.uniform(-30, 290, dims).astype(np.float32))
    t = lambda a: torch.from_numpy(np.float32(a)).to(device)
    return t(wmat), t(xs), t(ys), t(zs), wc, coeff.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dvc_chunk", "odd"])
def test_icgn3d_prologue_kernel_equals_plain(cuda, case):
    """The prologue kernel against its plain version on the card: offsets,
    fractions, blocks and both flags equal, bit for bit, at one chunk of
    the DVC cell (441 x 61^3, margin 8) and at a small odd shape (r = 4, 3,
    2; margin 2 and 4) with NaN warps, exits through each face and
    wobble."""
    from opencorr_tpu_torch.ops import icgn3d_step
    from test_torch_icgn3d_step import RX, RY, RZ, _queue

    if case == "dvc_chunk":
        runs = [(*_dvc_step_queue(3, cuda), dict(rx=30, ry=30, rz=30,
                                                 margin=8))]
    else:
        runs = []
        for margin in (2, 4):
            wmat, xs, ys, zs, wc, coeff, _ = _queue(torch.float32, margin,
                                                    seed=margin)
            runs.append((*(a.to(cuda) for a in (wmat, xs, ys, zs)),
                         [a.to(cuda) for a in wc], coeff.to(cuda),
                         dict(rx=RX, ry=RY, rz=RZ, margin=margin)))
    names = ("pdz", "pdy", "pdx", "fz", "fy", "fx", "eblk", "doomed",
             "wobble")
    for wmat, xs, ys, zs, wc, coeff, kw in runs:
        before = icgn3d_step.lattice_prologue_3d.launches
        got = icgn3d_step.lattice_prologue_3d(wmat, xs, ys, zs, *wc, coeff,
                                              d_wobble=1, **kw)
        torch.cuda.synchronize()
        assert icgn3d_step.lattice_prologue_3d.launches == before + 1
        want = icgn3d_step.lattice_prologue_3d_plain(
            wmat, xs, ys, zs, *wc, coeff, d_wobble=1, **kw)
        for name, g, w in zip(names, got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert torch.equal(g, w), name
        doomed, wobble = got[7], got[8]
        assert doomed.any() and (~doomed).any() and wobble.any()
        if kw["margin"] > 2:  # a 2-voxel margin holds no more drift than D=1
            assert (wobble & ~doomed).any()


def _step_reference(seed, n, r, device, margin=8):
    """Volumes, a queue and its reference side for the residual: the
    gradients of a speckle volume, values near a shifted copy of the
    reference subsets, and those subsets' zero-mean values and
    steepest-descent images, which the card's reference side frees."""
    from scipy.ndimage import gaussian_filter
    from opencorr_tpu_torch.ops import gradient, icgn3d_step

    rng = np.random.default_rng(seed)
    shape = (2 * r + 2 * margin + 24, 2 * r + 2 * margin + 10,
             2 * r + 2 * margin + 12)
    base = gaussian_filter(rng.standard_normal(shape), 1.5)
    ref = torch.from_numpy(np.float32(base / base.std() * 20 + 128)).to(
        device)
    gx, gy, gz = (getattr(gradient, f"gradient_{a}_3d")(ref).contiguous()
                  for a in "xyz")
    lo = r + margin + 1
    c = [rng.uniform(lo, d - lo, n).astype(np.float32)
         for d in shape[::-1]]
    xs, ys, zs = (torch.from_numpy(a).to(device) for a in c)
    side = icgn3d_step.reference_3d(gx, gy, gz, ref, xs, ys, zs, rx=r,
                                    ry=r, rz=r)
    assert side.zm is None and side.sd is None
    _, zm, sd = icgn3d_step._subsets_3d(side, r, r, r)
    wmat = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    wmat[:, :3, 3] = rng.uniform(-0.5, 0.5, (n, 3))
    wmat[:, 2, 2] += 0.02
    wmat = torch.from_numpy(wmat).to(device)
    zm_h = zm.cpu().numpy()
    tval = zm_h[rng.permutation(n)] * 0.3 + zm_h * 0.7 + 128 + rng.normal(
        0, 2, zm_h.shape)
    tval = torch.from_numpy(np.float32(tval)).to(device)
    return side, zm, sd, wmat, zs, tval


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", [(441, 30), (37, 7)])
def test_icgn3d_residual_kernel_vs_plain(cuda, n, r):
    """The residual kernels against the plain version on the card, with
    and without ``fail0`` and z guards: fail flags equal; ZNSSD within
    1e-5 relative and each of the 12 sums within 2e-5 of the sum of its
    terms' magnitudes, because the kernels add the same terms in another
    order (the mean and the norm too, which shifts every error term by a
    rounding); and two runs equal bit for bit."""
    from opencorr_tpu_torch.ops import icgn3d_step

    side, zm, sd, wmat, zs, tval = _step_reference(4, n, r, cuda)
    tval[3, 1000 % tval.shape[1]] = -1.0  # a failing POI
    fail0 = torch.zeros(n, dtype=torch.bool, device=cuda)
    fail0[5] = True
    zmid = float(zs.median())
    full = dataclasses.replace(side, zm=zm, sd=sd)
    # the error image and the magnitudes of the sums' terms, in float64
    t64 = tval.double()
    tz = t64 - t64.mean(1, keepdim=True)
    err = tz * (side.rn.double() / tz.norm(dim=1))[:, None] - zm
    scale = torch.bmm(sd.double().abs(), err.abs()[:, :, None])[:, :, 0]
    guard = (zmid - r - 3.0, zmid + r + 40.0)  # fails POIs below zmid - 3
    for fail0_, guard in ((None, None), (fail0, guard)):
        want = icgn3d_step.residual_3d_plain(tval, fail0_, full, wmat, zs,
                                             rx=r, ry=r, rz=r, z_guard=guard)
        before = icgn3d_step.residual_3d.launches
        got = icgn3d_step.residual_3d(tval, fail0_, side, wmat, zs, rx=r,
                                      ry=r, rz=r, z_guard=guard)
        again = icgn3d_step.residual_3d(tval, fail0_, side, wmat, zs, rx=r,
                                        ry=r, rz=r, z_guard=guard)
        torch.cuda.synchronize()
        assert icgn3d_step.residual_3d.launches == before + 2
        assert torch.equal(got[0], want[0])
        assert want[0][3] and (~want[0]).sum() >= n // 4
        if guard is not None:
            assert want[0][5] and int(want[0].sum()) > 2
        for a, b in zip(got, again):
            assert torch.equal(a, b)
        ok = ~want[0]
        torch.testing.assert_close(got[1][ok], want[1][ok], rtol=1e-5,
                                   atol=0)
        gap = (got[2] - want[2]).double().abs()[ok]
        assert (gap <= 2e-5 * scale[ok]).all(), float((gap / scale[ok]).max())


def _fused_pair():
    from scipy.ndimage import gaussian_filter, map_coordinates

    rng = np.random.default_rng(21)
    shape = (56, 50, 52)
    base = gaussian_filter(rng.standard_normal(shape), 1.5)
    ref = np.clip(np.round(base / base.std() * 20 + 128), 0, 255)
    zz, yy, xx = np.mgrid[0:56, 0:50, 0:52].astype(np.float64)
    tar = map_coordinates(ref, [zz - 0.5 - 0.004 * (zz - 28), yy + 0.3,
                                xx - 0.4], order=3, mode="nearest")
    return ref.astype(np.float32), np.round(tar).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("guards", [None, (10.0, 45.0)])
def test_fused_icgn3d1_cuda_matches_cpu(cuda, guards):
    """icgn3d1 through the prologue, kernel 3 and the residual kernels on
    the card against the plain path on the cpu, on the same float32
    gradients and coefficients: codes equal, u/v/w within 1e-5 voxel,
    every iteration through the residual kernels; with z guards some POIs
    fail -3.  A float64 volume on the card raises."""
    from opencorr_tpu_torch.ops import bspline, gradient, icgn, icgn3d_step

    ref, tar = _fused_pair()
    tref = torch.from_numpy(ref)
    prep = [*(getattr(gradient, f"gradient_{a}_3d")(tref) for a in "xyz"),
            tref, bspline.tricubic_prepare(torch.from_numpy(tar))]
    rng = np.random.default_rng(8)
    n, r = 40, 8
    xs, ys = (rng.uniform(18, 32, n).astype(np.float32) for _ in range(2))
    zs = rng.uniform(17, 39, n).astype(np.float32)
    p = np.zeros((n, 12), np.float32)
    p[:, 0], p[:, 4], p[:, 8] = 0.2, -0.1, 0.3  # the truth: 0.4, -0.3, 0.5
    kw = dict(rx=r, ry=r, rz=r, window_margin=8)
    if guards is not None:
        kw.update(z_guard_lo=guards[0], z_guard_hi=guards[1])
    outs, stats = {}, {}
    before = icgn3d_step.residual_3d.launches
    for dev in ("cpu", "cuda"):
        t = lambda a: torch.as_tensor(a).to(dev)
        stats[dev] = collections.Counter()
        outs[dev] = [a.cpu().numpy() for a in icgn.icgn3d1(
            *(a.to(dev) for a in prep), t(xs), t(ys), t(zs), t(p),
            t(np.zeros(n, np.float32)), 0.001, 10.0, stats=stats[dev],
            **kw)]
    assert (icgn3d_step.residual_3d.launches - before
            == stats["cuda"]["iter"] > 0)
    assert stats["cuda"]["lattice"] == stats["cpu"]["lattice"]
    zc, zp = outs["cuda"][4], outs["cpu"][4]
    np.testing.assert_array_equal(np.where(zc < 0, zc, 1),
                                  np.where(zp < 0, zp, 1))
    assert (zp > 0.9).sum() >= n // 2
    if guards is not None:
        assert (zp == -3.0).sum() >= 3
    np.testing.assert_allclose(outs["cuda"][0][:, [0, 4, 8]],
                               outs["cpu"][0][:, [0, 4, 8]], rtol=0,
                               atol=1e-5)
    with pytest.raises(ValueError, match="unsupported"):
        icgn.icgn3d1(*(a.to(cuda, torch.float64) for a in prep),
                     *(torch.as_tensor(a).to(cuda, torch.float64)
                       for a in (xs, ys, zs, p, np.zeros(n))),
                     0.001, 10.0, **kw)


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n,r", [
    ((501, 3751), 10749, 30),  # one self-adaptive chunk: 40.0 M samples
    ((900, 280), 940, 16),  # the flagship's exact fallback
    ((900, 280), 77, 6),  # 13,013 samples: a ragged last block
])
def test_bicubic_kernel_equals_plain(cuda, shape, n, r):
    """Warped coordinates near identity as on the refiners' path, some
    POIs moved off the image: value and mask equal bit for bit."""
    import chip_smoke as cs

    lut, gx, gy = cs.lut_eval_case(torch, shape, n, r, seed=n)
    before = bspline.bicubic_eval.launches
    got, oob = bspline.bicubic_eval(lut, gx, gy)
    assert bspline.bicubic_eval.launches == before + 1
    want, oob_want = bspline.bicubic_eval_plain(lut, gx, gy)
    assert torch.equal(oob, oob_want)
    assert torch.equal(_bits(got), _bits(want))
    assert oob.any() and not oob.all()


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(37, 45), (501, 3751)])
def test_bicubic_kernel_edge_cases(cuda, h, w):
    """The _below band, the exact guards, NaN and exact integers: the mask
    equal to the plain version's and to the port's first einsum's, -1 on
    every masked sample, values equal bit for bit; an empty input makes
    no launch."""
    import chip_smoke as cs

    rng = np.random.default_rng(h)
    img = torch.from_numpy(np.round(rng.uniform(0, 255, (h, w))).astype(
        np.float32)).to(cuda)
    lut = bspline.bicubic_prepare(img)
    xs, ys = (torch.from_numpy(a).to(cuda)
              for a in cs.lut_edge_coords(h, w, 4099, seed=h))
    got, oob = bspline.bicubic_eval(lut, xs, ys)
    want, oob_want = bspline.bicubic_eval_plain(lut, xs, ys)
    assert torch.equal(oob, oob_want)
    assert torch.equal(oob, cs.einsum_eval(torch, lut, xs, ys)[1])
    assert (got[oob] == -1.0).all()
    assert torch.equal(_bits(got), _bits(want))
    assert not oob[[0, 2, 5]].any() and oob[[1, 3, 4, 6, 7]].all()
    before = bspline.bicubic_eval.launches
    empty = torch.empty((0, 3721), device=cuda)
    val, mask = bspline.bicubic_eval(lut, empty, empty)
    assert bspline.bicubic_eval.launches == before
    assert val.shape == (0, 3721) and mask.shape == (0, 3721)


@pytest.mark.cuda
def test_bicubic_wrapper_refuses_bad_tensors(cuda):
    lut = torch.zeros((12, 10, 4, 4), device=cuda)
    xs = torch.zeros((6, 5), device=cuda)
    off = torch.zeros(12 * 10 * 16 + 1, device=cuda)[1:].view(12, 10, 4, 4)
    for bad in ((lut.double(), xs, xs), (lut, xs.double(), xs.double()),
                (lut, xs.cpu(), xs.cpu()), (lut, xs.t(), xs.t()),
                (lut.reshape(12, 10, 16), xs, xs), (lut, xs, xs[:5]),
                (off, xs, xs)):
        with pytest.raises(ValueError):
            bspline.bicubic_eval(*bad)
