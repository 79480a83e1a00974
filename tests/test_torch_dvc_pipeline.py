"""The port's DVC refinement and the DVC slice as a whole against the JAX
package on the CPU: icgn3d1 through the lattice kernel (the JAX package
runs its Pallas kernel in interpret mode here) and through the global
eval, the whole-chunk exact fallback, the -3 window exit and entry guard,
the margin->None rule, and FFTCC3D -> ICGN3D1 -> Strain on the 3D speckle
pair with equal chunk sizes.

u/v/w within 1e-5 voxel (2e-5 on the slice's pair, with the reason there),
zncc within 1e-5, codes equal, iteration counts equal but for stopping
decisions inside float noise (as in 2D, see
``test_torch_icgn_queue._assert_icgn_equal``), strain within 1e-5."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, map_coordinates

import opencorr_tpu as oc
import opencorr_tpu_torch as ot
from opencorr_tpu.ops import bspline as jbs
from opencorr_tpu.ops import gradient as jgrad
from opencorr_tpu.ops import icgn as jicgn
from opencorr_tpu_torch.data import poi as tpoi
from opencorr_tpu_torch.models import base
from opencorr_tpu_torch.ops import bspline as tbs
from opencorr_tpu_torch.ops import gradient as tgrad
from opencorr_tpu_torch.ops import icgn as ticgn
from opencorr_tpu_torch.parallel.halo import ShardedICGN3D1

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)

CPU = "cpu"
FIELDS_3D = ("x", "y", "z", "p", "r", "e", "sr")


def _pair(e, seed=0):
    """The JAX package's lattice test pair (tests/test_ops.py:321-353): a
    48x52x56 speckle volume and its target under a translation plus a z
    strain ``e``."""
    rng = np.random.default_rng(seed)
    d, h, w = 48, 52, 56
    ref = (gaussian_filter(rng.standard_normal((d, h, w)), 1.6) * 55
           + 128).astype(np.float32)
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                             indexing="ij")
    tar = map_coordinates(ref, [zz - 0.4 + e * (zz - d / 2), yy + 0.25,
                                xx - 0.6], order=3,
                          mode="nearest").astype(np.float32)
    return ref, tar, rng


def _queue(rng, n, shape, p_fn=None):
    d, h, w = shape
    xs = rng.uniform(16, w - 17, n).astype(np.float32)
    ys = rng.uniform(16, h - 17, n).astype(np.float32)
    zs = rng.uniform(16, d - 17, n).astype(np.float32)
    p0 = np.zeros((n, 12), np.float32)
    if p_fn is not None:
        p_fn(p0, zs)
    return xs, ys, zs, p0


def _run_ops(ref, tar, xs, ys, zs, p0, zncc0=None, *, r=8, margin=8,
             eval_mode="lattice"):
    """icgn3d1 of both packages on the same inputs; numpy outputs and the
    port's branch counts."""
    n = xs.shape[0]
    zncc0 = np.zeros(n, np.float32) if zncc0 is None else zncc0
    gj = [getattr(jgrad, f"gradient_{a}_3d")(jnp.asarray(ref)) for a in "xyz"]
    out_j = jicgn.icgn3d1(
        *gj, jnp.asarray(ref), jbs.tricubic_prepare(jnp.asarray(tar)),
        *map(jnp.asarray, (xs, ys, zs, p0, zncc0)), jnp.float32(0.001),
        jnp.float32(10), rx=r, ry=r, rz=r, window_margin=margin,
        eval_mode=eval_mode)
    tref = torch.from_numpy(ref)
    stats = collections.Counter()
    out_t = ticgn.icgn3d1(
        *(getattr(tgrad, f"gradient_{a}_3d")(tref) for a in "xyz"), tref,
        tbs.tricubic_prepare(torch.from_numpy(tar)),
        *(torch.from_numpy(a.copy()) for a in (xs, ys, zs, p0, zncc0)),
        0.001, 10.0, rx=r, ry=r, rz=r, window_margin=margin,
        eval_mode=eval_mode, stats=stats)
    return ([np.asarray(a) for a in out_j], [a.numpy() for a in out_t],
            dict(stats))


def _assert_ops_equal(oj, ot_, conv=0.001, tol=1e-5):
    """(p, u0, v0, w0, zncc, iteration, convergence, computed): codes and
    the computed mask equal, seeds equal, iterations equal, p within
    ``tol`` and zncc within 1e-5 (the stopping-noise allowance of 2D)."""
    pj, pt = oj[0], ot_[0]
    zj, zt = oj[4], ot_[4]
    np.testing.assert_array_equal(np.where(zt < 0, zt, 1),
                                  np.where(zj < 0, zj, 1))
    np.testing.assert_array_equal(ot_[7], oj[7])
    for a, b in zip(ot_[1:4], oj[1:4]):
        np.testing.assert_array_equal(a, b)
    marginal = oj[5] != ot_[5]
    assert marginal.sum() <= max(1, len(zj) // 1000)
    assert (np.abs(oj[5] - ot_[5])[marginal] == 1).all()
    first = np.where(ot_[5] < oj[5], ot_[6], oj[6])[marginal]
    assert ((first >= 0.99 * conv) & (first < conv)).all(), first
    same = ~marginal
    np.testing.assert_allclose(zt[same], zj[same], rtol=0, atol=1e-5)
    np.testing.assert_allclose(pt[same], pj[same], rtol=0, atol=tol)
    np.testing.assert_allclose(pt[marginal], pj[marginal], rtol=0, atol=conv)


@pytest.mark.parametrize("margin", [8, None])
def test_icgn3d1_matches_jax(margin):
    """The lattice path (margin 8) and the global eval (None) at 1% strain,
    seeded at zero displacement."""
    ref, tar, rng = _pair(0.01)
    oj, ot_, stats = _run_ops(ref, tar, *_queue(rng, 7, ref.shape),
                              margin=margin)
    _assert_ops_equal(oj, ot_)
    assert (ot_[4] > 0.99).all()
    assert stats["iter"] == int(ot_[5].max()) > 0
    if margin is None:
        assert "lattice" not in stats and "fallback" not in stats
    else:
        assert stats["lattice"] == stats["iter"] and "fallback" not in stats


@pytest.mark.parametrize("case", ["strain_1pct", "strain_25pct",
                                  "window_exit"])
def test_icgn3d1_tile_matches_jax(case):
    """``eval_mode="tile"`` against the JAX package's tile path: codes
    equal, u/v/w within 2e-5 voxel (as ICGN3D1's other 3D gates).  The
    port's tile values are the global eval's: every POI the tile path does
    not fail -3 equals ``window_margin=None`` bit for bit, and the POIs it
    fails -3 (window exits) iterate on without it."""
    margin, e, zncc0 = 8, 0.01, None
    if case == "strain_25pct":
        e = 0.25
    ref, tar, rng = _pair(e, seed=1 if case == "window_exit" else 0)

    def seed(p0, zs):
        if case == "strain_25pct":
            p0[:, 8] = 0.4 - e * (zs - 24)
            p0[:, 11] = -e
        if case == "window_exit":
            p0[:4, 0] = 0.6 - 1.3

    queue = _queue(rng, 7 if case != "window_exit" else 9, ref.shape, seed)
    if case == "window_exit":
        margin = 2
    oj, ot_, stats = _run_ops(ref, tar, *queue, margin=margin,
                              eval_mode="tile")
    _assert_ops_equal(oj, ot_, tol=2e-5)
    assert "lattice" not in stats and "fallback" not in stats
    _, glob, _ = _run_ops(ref, tar, *queue, margin=None)
    held = ot_[4] != -3
    assert held.any()
    np.testing.assert_array_equal(ot_[0][held], glob[0][held])
    np.testing.assert_array_equal(ot_[4][held], glob[4][held])
    if case == "window_exit":
        assert (ot_[4][:4] == -3).all() and (glob[4][:4] > 0.9).all()
    else:
        assert held.all()


def test_icgn3d1_exact_fallback_every_iteration():
    """25% strain: the lattice deviation at r=8 is about 2 voxels, past
    D=1, so every iteration of the chunk evaluates through the global
    coefficient volume, in both packages."""
    e = 0.25

    def seed(p0, zs):  # seeded near the truth, at the strained warp
        p0[:, 8] = 0.4 - e * (zs - 24)
        p0[:, 11] = -e

    ref, tar, rng = _pair(e)
    oj, ot_, stats = _run_ops(ref, tar, *_queue(rng, 7, ref.shape, seed))
    _assert_ops_equal(oj, ot_)
    assert (ot_[4] > 0.99).all()
    assert stats["fallback"] == stats["iter"] > 0 and "lattice" not in stats


@pytest.mark.parametrize("eval_mode", ["lattice", "tile"])
def test_icgn3d1_window_exit_and_entry_guard(eval_mode):
    """With a 2-voxel margin a sample leaves its window once the iterate
    moves 1 - frac voxels up from its seed: seeds 1.3 voxels below the
    truth fail -3 on the way to it.  Also a POI whose subset crosses the
    volume edge (-3 without iterating), one that failed earlier (keeps its
    code) and one with a NaN seed (-3).  Both windowed evals end in the
    shared exit codes (``ops/icgn.finish``)."""
    ref, tar, rng = _pair(0.0, seed=1)

    def seed(p0, zs):
        p0[:4, 0] = 0.6 - 1.3

    xs, ys, zs, p0 = _queue(rng, 9, ref.shape, seed)
    xs[5] = 4.0  # subset off the volume
    p0[7, 4] = np.nan
    zncc0 = np.zeros(9, np.float32)
    zncc0[6] = -1.0
    oj, ot_, stats = _run_ops(ref, tar, xs, ys, zs, p0, zncc0, margin=2,
                              eval_mode=eval_mode)
    _assert_ops_equal(oj, ot_)
    z = ot_[4]
    assert (z[[0, 1, 2, 3, 5, 7]] == -3.0).all() and z[6] == -1.0
    assert (z[[4, 8]] > 0.99).all() and ot_[7][[4, 8]].all()
    assert not ot_[7][[0, 1, 2, 3, 5, 6, 7]].any()
    assert (stats.get("lattice", 0) > 0) == (eval_mode == "lattice")


def _module_pair(ref, tar, r, chunk, margin=8, device=CPU):
    mj = oc.ICGN3D1(r, r, r, 0.001, 10, chunk_size=chunk,
                    window_margin=margin)
    mj.set_images(ref, tar)
    mj.prepare()
    mt = ot.ICGN3D1(r, r, r, 0.001, 10, chunk_size=chunk,
                    window_margin=margin, device=device)
    mt.set_images(ot.Image3D.from_array(ref), ot.Image3D.from_array(tar))
    mt.prepare()
    return mj, mt


def _tables(t_jax):
    arrs = [np.asarray(getattr(t_jax, f)) for f in FIELDS_3D]
    return ot.table_from_numpy_3d(*arrs, device=CPU)


def _assert_tables_equal(tj, tt, tol=1e-5):
    """Module-level tables: as :func:`_assert_ops_equal` on the fields."""
    j = {f: np.asarray(getattr(tj, f)) for f in FIELDS_3D}
    t = ot.table_to_numpy(tt)
    for f in ("x", "y", "z", "sr"):
        np.testing.assert_array_equal(t[f], j[f])
    rj, rt = j["r"], t["r"]
    oj = [j["p"], rj[:, 0], rj[:, 1], rj[:, 2], rj[:, 3], rj[:, 4], rj[:, 5],
          j["sr"][:, 0] > 0]
    ot_ = [t["p"], rt[:, 0], rt[:, 1], rt[:, 2], rt[:, 3], rt[:, 4],
           rt[:, 5], t["sr"][:, 0] > 0]
    _assert_ops_equal(oj, ot_, tol=tol)


def test_icgn3d1_margin_rule_small_volume(speckle_pair_3d):
    """r=16 on a 48^3 volume: min(48 - 32) - 1 < 2 * 8, so the window
    margin gives way to the global eval, in both packages."""
    ref, tar, _, _, _ = speckle_pair_3d
    mj, mt = _module_pair(ref, tar, 16, chunk=None)
    tj = oc.poi_grid_3d((20, 20, 20), 2, 2, 2, 6)
    outj = mj.compute(tj)
    outt = mt.compute(_tables(tj))
    _assert_tables_equal(outj, outt)
    assert mt.stats["iter"] > 0 and "lattice" not in mt.stats
    assert (outt.zncc.numpy() > 0.9).all()


def test_sharded_margin_rule_extended_block():
    """ShardedICGN3D1 takes ICGN3D1's window rule on a rank's extended
    block: at r=8 and margin 8 (halo 17), two ranks of a 48-plane volume
    hold 24 planes each, too few for the window alone (24 - 16 - 1 < 16),
    but 58 with the halos; a 32-voxel y side (32 - 16 - 1 < 16) gives way
    to the global eval on any mesh, a 33-voxel one does not."""
    sh = ShardedICGN3D1(8, 8, 8)
    assert sh.halo == 17
    for dy, want in ((40, 8), (33, 8), (32, None)):
        sh.set_images(np.zeros((48, dy, 40)), np.zeros((48, dy, 40)))
        assert sh._margin(2) == want and sh._margin(1) == want
        assert base.eval_margin(8, (8, 8, 8), (40, dy, 24)) is None


def test_dvc_slice_matches_jax(speckle_pair_3d):
    """FFTCC3D -> ICGN3D1 -> Strain on the 3D speckle pair, chunk_size 10
    for both packages over 27 POIs (the last chunk padded)."""
    ref, tar, tu, tv, tw = speckle_pair_3d
    grid = ((16, 16, 16), 3, 3, 3, 6)
    fj = oc.FFTCC3D(8, 8, 8, chunk_size=10)
    fj.set_images(ref, tar)
    sj = fj.compute(oc.poi_grid_3d(*grid))
    mj, mt = _module_pair(ref, tar, 8, chunk=10)
    rj = mj.compute(sj)
    ej = oc.Strain(13, 5).compute(rj)

    ft = ot.FFTCC3D(8, 8, 8, chunk_size=10, device=CPU)
    ft.set_images(ot.Image3D.from_array(ref), ot.Image3D.from_array(tar))
    st = ft.compute(ot.poi_grid_3d(*grid, device=CPU))
    rt = mt.compute(st)
    strain = ot.Strain(13, 5, device=CPU)
    et = strain.compute(rt)

    np.testing.assert_array_equal(st.p.numpy(), np.asarray(sj.p))
    np.testing.assert_allclose(st.r.numpy(), np.asarray(sj.r), rtol=0,
                               atol=1e-5)
    # The 12x12 Hessian amplifies float32 rounding: on this pair the JAX
    # package's u/v/w lie up to 1.6e-5 voxel from a float64 replay of the
    # same iteration, the port's within 1.2e-6.  So the port is held to the
    # replay at 2e-6 and to the JAX package at 2e-5.
    _assert_tables_equal(rj, rt, tol=2e-5)
    t64 = [getattr(st, f).double() for f in ("x", "y", "z", "p")]
    r64, v64 = (torch.from_numpy(a.astype(np.float64)) for a in (ref, tar))
    p64 = ticgn.icgn3d1(
        *(getattr(tgrad, f"gradient_{a}_3d")(r64) for a in "xyz"), r64,
        tbs.tricubic_prepare(v64), *t64, st.r[:, tpoi.R3_ZNCC].double(),
        0.001, 10.0, rx=8, ry=8, rz=8, window_margin=8)[0].numpy()
    np.testing.assert_allclose(rt.p.numpy()[:, [0, 4, 8]], p64[:, [0, 4, 8]],
                               rtol=0, atol=2e-6)
    assert mt.stats["chunks"] == 3 and mt.stats["lattice"] > 0
    assert strain._cache[-1][2][0] == "grid"
    etn = et.e.numpy()
    np.testing.assert_allclose(etn, np.asarray(ej.e), rtol=0, atol=1e-5)
    zn = et.zncc.numpy()
    assert (zn > 0.9).all()
    for col, truth in ((tpoi.U3, tu), (tpoi.V3, tv), (tpoi.W3, tw)):
        assert abs(et.p[:, col].numpy().mean() - truth) < 0.05
    assert np.abs(etn).max() < 0.01  # a pure translation


def test_icgn3d1_chunked_matches_whole(speckle_pair_3d):
    """Chunked ICGN3D1 (the tail padded with replicas of the last POI) and
    the even auto-sized chunks give the whole-queue results."""
    ref, tar, _, _, _ = speckle_pair_3d
    f = ot.FFTCC3D(6, 6, 6, device=CPU)
    f.set_images(ref, tar)
    seeded = f.compute(ot.poi_grid_3d((14, 14, 14), 3, 3, 2, 8, device=CPU))
    outs = []
    for chunk in (None, 7, 18):
        m = ot.ICGN3D1(6, 6, 6, chunk_size=chunk, device=CPU)
        m.set_images(ref, tar)
        m.prepare()
        outs.append(ot.table_to_numpy(m.compute(seeded)))
        assert m.stats["chunks"] == {None: 1, 7: 3, 18: 1}[chunk]
    for o in outs[1:]:
        for fld in FIELDS_3D:
            np.testing.assert_allclose(o[fld], outs[0][fld], rtol=0,
                                       atol=1e-6)
    m = ot.ICGN3D1(30, 30, 30, device=CPU)
    assert m.auto_chunk(5733) == 441 and m.auto_chunk(100) == 100


def test_icgn3d1_unported_options_raise():
    """Every option of the JAX package's icgn3d1 and ICGN3D1 is ported:
    ``eval_mode="tile"`` (test_icgn3d1_tile_matches_jax) and the z guards
    (tests/test_torch_parallel.py) run; a module used before ``prepare``
    or on a 2D table still raises."""
    m = ot.ICGN3D1(8, 8, 8, eval_mode="tile", device=CPU)
    assert m.eval_mode == "tile"
    args = [torch.zeros((20, 20, 20))] * 5 + [torch.zeros(1)] * 3 + [
        torch.zeros((1, 12)), torch.zeros(1), 0.001, 10.0]
    out = ticgn.icgn3d1(*args, rx=4, ry=4, rz=4, window_margin=2,
                        eval_mode="tile")
    assert out[4].shape == (1,)
    out = ticgn.icgn3d1(*args, rx=4, ry=4, rz=4, z_guard_lo=0.0,
                        z_guard_hi=10.0)
    assert out[4].shape == (1,)
    m = ot.ICGN3D1(8, 8, 8, device=CPU)
    with pytest.raises(RuntimeError):
        m.compute(ot.poi_grid_3d((10, 10, 10), 2, 2, 2, 2, device=CPU))
    m.set_images(np.zeros((30, 30, 30)), np.zeros((30, 30, 30)))
    m.prepare()
    with pytest.raises(TypeError):
        m.compute(ot.poi_grid_2d((10, 10), 2, 2, 2, device=CPU))
