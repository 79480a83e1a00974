"""The plain versions of ICGN3D1's Gauss-Newton step
(``ops/icgn3d_step.py``) on the CPU, in float32 and float64, held to what
they compute rather than to a copy of their code: the prologue's offsets,
fractions and blocks put every sample of a sound POI where the global
tricubic eval puts it, and mark out of range exactly the samples out of
the volume or out of their windows; the residual's fail flags, ZNSSD and
steepest-descent sums equal their definitions, summed per POI in float64
from subsets sliced out of the volumes with numpy.

The inputs put samples out of the volume, NaN coordinates, window exits
through each face, lattice wobble past D=1 and z guards into one queue.
The CUDA kernels against these plain versions are in test_torch_cuda.py;
``icgn3d1`` as a whole is held to the JAX package and to a float64
replay by the DVC tests."""

import dataclasses

import numpy as np
import pytest
import torch

from opencorr_tpu_torch.ops import bspline, icgn3d_step, lattice3d

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)

VOL = (30, 33, 36)  # dz, dy, dx
RX, RY, RZ = 4, 3, 2
# Lattice against global eval: the lattice takes each fraction from the
# window-local coordinate g - wc, the global eval from g itself, and the
# two sum the 64 taps in another order; on coefficients of up to 280 the
# largest gap reads 7.6e-5 in float32 and 1.7e-13 in float64.
EVAL_ATOL = {torch.float32: 5e-4, torch.float64: 1e-11}


def _queue(dtype, margin, seed=0):
    """POIs whose warps send samples out of the volume (the last two
    translated past a face), to NaN, through each face of their windows,
    and past the lattice's D=1 (a strain), beside plain ones; and their
    window corners as ``_lattice_eval3d`` sets them."""
    rng = np.random.default_rng(seed)
    dz_, dy_, dx_ = VOL
    n = 16
    # centres 0.4 past a voxel and the windows on them: a warp within
    # [-1.4, 0.6) voxel of the identity stays in a 2-voxel margin
    xs = rng.integers(RX + margin + 2, dx_ - RX - margin - 3, n) + 0.4
    ys = rng.integers(RY + margin + 2, dy_ - RY - margin - 3, n) + 0.4
    zs = rng.integers(RZ + margin + 2, dz_ - RZ - margin - 3, n) + 0.4
    wmat = np.tile(np.eye(4), (n, 1, 1))
    wmat[:, :3, :3] += rng.normal(0, 0.01, (n, 3, 3))
    wmat[:, :3, 3] = rng.uniform(-0.3, 0.3, (n, 3))
    big = margin + 1.6
    for a in range(3):  # window exits through each face: POIs 1-6
        wmat[1 + 2 * a, a, 3] = big
        wmat[2 + 2 * a, a, 3] = -big
    wmat[7, 0, 3] = np.nan  # NaN x for every sample
    wmat[8, 1, 1] = np.inf  # NaN y on the centre row (inf * 0), inf off it
    wmat[9, 0, 0] = 1.45  # stretch: wobble past D=1
    wmat[10, 2, 1] = 0.7  # shear of z along y: wobble
    wmat[11, 1, 1] = 0.9  # compression of y
    xs[12] = 1.5  # samples below the volume in x (the window sits at 0)
    zs[13] = dz_ - 3.0  # samples past the volume in z
    wmat[14, 2, 3] = -zs[14] - 2.0  # the whole subset below z = 1
    wc = []
    for c, r, dim in ((xs, RX, dx_), (ys, RY, dy_), (zs, RZ, dz_)):
        sw = 2 * (r + margin) + 1
        c32 = torch.from_numpy(c).to(dtype)
        wc.append(torch.clamp(torch.floor(c32).to(torch.int32)
                              - (r + margin), 0, dim - sw))
    coeff = torch.from_numpy(rng.uniform(-20, 280, VOL)).to(dtype)
    active = torch.from_numpy(rng.uniform(size=n) < 0.85)
    t = lambda a: torch.from_numpy(a).to(dtype)
    return t(wmat), t(xs), t(ys), t(zs), wc, coeff, active


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("margin", [2, 4])
def test_prologue_plain_places_samples_as_the_global_eval(dtype, margin):
    """Offsets, fractions and blocks through the lattice eval give every
    sample of a POI neither doomed nor wobbling the global eval's value;
    the out-of-range samples (offsets -1) are those out of [1, dim - 2)
    or NaN, or whose floor in the window leaves [1, sw - 3]; ``doomed``
    marks their POIs, and the exits, NaNs and wobbles of the queue land
    where they are put."""
    wmat, xs, ys, zs, wc, coeff, _ = _queue(dtype, margin, seed=margin)
    before = icgn3d_step.lattice_prologue_3d.launches
    pdz, pdy, pdx, fz, fy, fx, eblk, doomed, wobble = \
        icgn3d_step.lattice_prologue_3d(
            wmat, xs, ys, zs, *wc, coeff, rx=RX, ry=RY, rz=RZ,
            margin=margin, d_wobble=1)
    # the wrapper took the plain version for CPU tensors, uncounted
    assert icgn3d_step.lattice_prologue_3d.launches == before
    n = xs.shape[0]
    shp = (n, 2 * RZ + 1, 2 * RY + 1, 2 * RX + 1)
    grid = icgn3d_step.local_grid_3d(RX, RY, RZ, dtype, "cpu")
    g = [icgn3d_step.warped_3d(wmat, row, c, grid)
         for row, c in enumerate((xs, ys, zs))]
    oob = torch.zeros(g[0].shape, dtype=torch.bool)
    for gc, w, r, dim in zip(g, wc, (RX, RY, RZ), VOL[::-1]):
        sw = 2 * (r + margin) + 1
        fl = torch.floor(gc - w.to(dtype)[:, None])
        oob |= (torch.isnan(gc) | (gc < 1) | (gc >= dim - 2) | (fl < 1)
                | (fl > sw - 3))
    oob = oob.reshape(shp)
    for pd in (pdz, pdy, pdx):
        assert (pd[oob] == -1).all()
    assert torch.equal(doomed, oob.flatten(1).any(dim=1))
    pd = torch.stack((pdz, pdy, pdx))
    assert torch.equal(wobble, (((pd < 0) | (pd > 2)).any(dim=0)
                                & ~oob).flatten(1).any(dim=1))
    sound = ~doomed & ~wobble
    assert sound[[0, 11, 15]].all()
    got = lattice3d.lattice_eval_3d_plain(eblk, pdz, pdy, pdx, fz, fy, fx,
                                          d_wobble=1).reshape(n, -1)
    want, _ = bspline.tricubic_eval(coeff, *g)
    torch.testing.assert_close(got[sound], want[sound], rtol=0,
                               atol=EVAL_ATOL[dtype])
    for f in (fz, fy, fx):
        assert ((f >= 0) & (f < 1))[~oob].all()
    # the queue covers what it is meant to
    assert doomed[1:9].all() and doomed[12:15].all()
    assert not doomed[[0, 11, 15]].any()
    assert wobble[10]
    if margin > 2:  # a 2-voxel margin holds no more drift than D=1
        assert wobble[9] and not doomed[[9, 10]].any()
    assert (oob.flatten(1).sum(1) < oob[0].numel())[[12, 13]].all()
    assert torch.isnan(g[0][7]).all() and torch.isnan(g[1][8]).any()


def _residual_by_definition(tval, vols, xs, ys, zs, wmat, fail0, z_guard):
    """Fail flags, ZNSSD and the 12 sums of one residual, POI by POI in
    float64 numpy: subsets sliced at the (int)-truncated corners, the
    steepest-descent images g, g*xl, g*yl, g*zl for g in gx, gy, gz, and
    err = (t - mean t) * rn / tn - (ref - mean ref)."""
    ref_vol, gx, gy, gz = (v.double().numpy() for v in vols)
    t = tval.double().numpy()
    w = wmat.double().numpy()
    n = t.shape[0]
    dz_, dy_, dx_ = ref_vol.shape
    sx, sy, sz = 2 * RX + 1, 2 * RY + 1, 2 * RZ + 1
    zl, yl, xl = (a.ravel() for a in np.meshgrid(
        np.arange(-RZ, RZ + 1), np.arange(-RY, RY + 1),
        np.arange(-RX, RX + 1), indexing="ij"))
    fail = np.zeros(n, bool)
    znssd = np.zeros(n)
    num = np.zeros((n, 12))
    for i in range(n):
        x0 = min(max(int(xs[i]) - RX, 0), dx_ - sx)
        y0 = min(max(int(ys[i]) - RY, 0), dy_ - sy)
        z0 = min(max(int(zs[i]) - RZ, 0), dz_ - sz)
        cut = lambda v: v[z0:z0 + sz, y0:y0 + sy, x0:x0 + sx].ravel()
        ref = cut(ref_vol) - cut(ref_vol).mean()
        rn = np.sqrt((ref * ref).sum())
        tz = t[i] - t[i].mean()
        err = tz * rn / np.sqrt((tz * tz).sum()) - ref
        znssd[i] = (err * err).sum() / rn ** 2
        sd = [c * m for c in (cut(gx), cut(gy), cut(gz))
              for m in (1, xl, yl, zl)]
        num[i] = [(k * err).sum() for k in sd]
        fail[i] = (t[i] < 0).any() or (fail0 is not None and bool(fail0[i]))
        if z_guard is not None:
            gzc = float(zs[i]) + (w[i, 2, 0] * xl + w[i, 2, 1] * yl
                                  + w[i, 2, 2] * zl + w[i, 2, 3])
            fail[i] |= ((gzc < z_guard[0]) | (gzc >= z_guard[1])).any()
    return fail, znssd, num


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("z_guard", [None, (12.0, 19.5)])
def test_residual_plain_matches_its_definition(dtype, z_guard):
    """Fail flags equal, ZNSSD and the 12 sums within the rounding of the
    dtype (each sum against the sum of its terms' magnitudes), with and
    without ``fail0``; a POI with a -1 sample fails; and the reference
    side with its subsets freed, as the kernels take it, gives the plain
    version the same bits from the volumes."""
    rng = np.random.default_rng(5)
    wmat, xs, ys, zs, _, _, _ = _queue(dtype, 2, seed=9)
    xs, ys, zs = (torch.clamp(c, 6.0, 20.0) for c in (xs, ys, zs))
    vol = lambda: torch.from_numpy(rng.uniform(40, 220, VOL)).to(dtype)
    vols = (vol(), vol() - 130, vol() - 130, vol() - 130)
    n, s = xs.shape[0], (2 * RX + 1) * (2 * RY + 1) * (2 * RZ + 1)
    tval = torch.from_numpy(rng.uniform(30, 230, (n, s))).to(dtype)
    tval[3, 17] = -1.0  # a failing POI
    fail0 = torch.zeros(n, dtype=torch.bool)
    fail0[5] = True
    ref = icgn3d_step.reference_3d(*vols[1:], vols[0], xs, ys, zs, rx=RX,
                                   ry=RY, rz=RZ)
    assert ref.sd is not None and ref.hinv.shape == (n, 12, 12)
    bare = dataclasses.replace(ref, zm=None, sd=None)
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    before = icgn3d_step.residual_3d.launches
    fails = []
    for f0 in (None, fail0):
        got = icgn3d_step.residual_3d(tval, f0, ref, wmat, zs, rx=RX,
                                      ry=RY, rz=RZ, z_guard=z_guard)
        fail, znssd, num = _residual_by_definition(
            tval, vols, xs.numpy(), ys.numpy(), zs.numpy(), wmat, f0,
            z_guard)
        np.testing.assert_array_equal(got[0].numpy(), fail)
        fails.append(fail)
        ok = ~fail
        np.testing.assert_allclose(got[1].double().numpy()[ok], znssd[ok],
                                   rtol=rtol)
        assert got[2].shape == (n, 12)
        gap = np.abs(got[2].double().numpy() - num)[ok]
        scale = np.abs(num[ok]).max(axis=1, keepdims=True) + 1e-300
        assert (gap <= 10 * rtol * scale).all(), float((gap / scale).max())
        again = icgn3d_step.residual_3d_plain(tval, f0, bare, wmat, zs,
                                              rx=RX, ry=RY, rz=RZ,
                                              z_guard=z_guard)
        for a, b in zip(got, again):
            assert torch.equal(a, b)
    assert icgn3d_step.residual_3d.launches == before
    assert fails[0][3] and fails[1][5]
    if z_guard is None:
        assert int(fails[0].sum()) == 1
    else:  # the guards fail some POIs, not all
        assert 1 < int(fails[0].sum()) < n


def test_step_wrappers_refuse_other_devices():
    """The plain versions serve CPU tensors alone; the kernels CUDA
    float32 ones (test_torch_cuda.py); anything else raises."""
    wmat, xs, ys, zs, wc, coeff, _ = _queue(torch.float32, 2)
    meta = lambda t: t.to("meta")
    with pytest.raises(ValueError, match="unsupported"):
        icgn3d_step.lattice_prologue_3d(
            *map(meta, (wmat, xs, ys, zs, *wc, coeff)), rx=RX, ry=RY, rz=RZ,
            margin=2, d_wobble=1)
    ref = icgn3d_step.reference_3d(coeff, coeff, coeff, coeff, xs, ys, zs,
                                   rx=RX, ry=RY, rz=RZ)
    s = (2 * RX + 1) * (2 * RY + 1) * (2 * RZ + 1)
    tval = torch.zeros((xs.shape[0], s), device="meta")
    with pytest.raises(ValueError, match="unsupported"):
        icgn3d_step.residual_3d(tval, None, ref, wmat, zs, rx=RX, ry=RY,
                                rz=RZ)
