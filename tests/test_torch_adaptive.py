"""The port's self-adaptive subsets against the JAX package on the CPU:
``icgn2d_adaptive`` and ``iclm2d_adaptive`` (orders 1 and 2, through the
modules after ``set_self_adaptive(True)``) on mixed per-POI radii, and
FeatureAffine2D's self-adaptive branch with the JAX package's draws.

Refiners: first order as ``_assert_icgn_equal`` (u/v within 1e-5 px, codes
and iteration counts equal), second order as ICGN2D2 (median 1e-5, worst
5e-5); with every radius at r the adaptive refine equals the fixed-radius
module within 1e-4, as tests/test_iclm_nr.py holds the JAX package.
FeatureAffine2D: the moved x/y and the radii equal exactly, codes and
counts equal, p within 1e-5."""

import jax
import numpy as np
import pytest
import torch

import opencorr_tpu as oc
import opencorr_tpu_torch as ot
from opencorr_tpu_torch.data import poi as tpoi
from test_torch_icgn_queue import _assert_icgn_equal
from test_torch_stereo_icgn import _assert_close_12
from test_torch_stereo_sift2d import _affine_kp

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)

CPU = "cpu"
CLASSES = {("icgn", 1): (oc.ICGN2D1, ot.ICGN2D1),
           ("icgn", 2): (oc.ICGN2D2, ot.ICGN2D2),
           ("iclm", 1): (oc.ICLM2D1, ot.ICLM2D1),
           ("iclm", 2): (oc.ICLM2D2, ot.ICLM2D2)}


@pytest.fixture(scope="module")
def seeded(speckle_pair_2d):
    """The JAX FFTCC table of a grid on the speckle pair, as numpy arrays,
    with mixed radii 7-13 in ``sr`` (one POI's radius reaches past the
    image border: the entry guard's -3)."""
    ref, tar, _, _ = speckle_pair_2d
    f = oc.FFTCC2D(10, 10)
    f.set_images(ref, tar)
    tj = f.compute(oc.poi_grid_2d((22, 22), 12, 10, 12))
    t = {k: np.array(getattr(tj, k)) for k in ("x", "y", "p", "r", "e",
                                                "sr")}
    rng = np.random.default_rng(3)
    t["sr"] = rng.integers(7, 14, t["sr"].shape).astype(np.float32)
    t["sr"][0] = (23.0, 9.0)
    return ref, tar, t


def _tables(t, sr=None):
    sr = t["sr"] if sr is None else sr
    jt = oc.new_table_2d(t["x"], t["y"]).replace(p=t["p"], r=t["r"],
                                                 e=t["e"], sr=sr)
    return jt, ot.table_from_numpy(t["x"], t["y"], t["p"], t["r"], t["e"],
                                   sr, device=CPU)


def _modules(kind, order, ref, tar, adaptive=True):
    jcls, tcls = CLASSES[(kind, order)]
    jm = jcls(10, 10, 0.001, 10)
    tm = tcls(10, 10, 0.001, 10, device=CPU)
    for m in (jm, tm):
        m.set_images(ref, tar)
        m.prepare()
        m.set_self_adaptive(adaptive)
    return jm, tm


@pytest.mark.parametrize("kind,order", list(CLASSES))
def test_adaptive_refiners_match_jax(seeded, kind, order):
    ref, tar, t = seeded
    jm, tm = _modules(kind, order, ref, tar)
    jt, tt = _tables(t)
    outj = jm.compute(jt)
    j = {f: np.asarray(getattr(outj, f)) for f in ("p", "r", "sr")}
    got = ot.table_to_numpy(tm.compute(tt))
    if order == 1:
        _assert_icgn_equal(j, got)
    else:
        _assert_close_12(j, got)
    np.testing.assert_array_equal(got["sr"], t["sr"])  # radii kept
    z = got["r"][:, tpoi.R_ZNCC]
    assert z[0] == -3.0
    assert (z > 0.9).mean() > 0.8
    iters = "iter_adaptive" if kind == "icgn" else "iter_full"
    assert tm.stats[iters] > 0 and "correct" not in tm.stats


@pytest.mark.parametrize("kind", ["icgn", "iclm"])
def test_adaptive_at_fixed_radius_equals_fixed_module(seeded, kind):
    ref, tar, t = seeded
    _, fixed = _modules(kind, 1, ref, tar, adaptive=False)
    _, adap = _modules(kind, 1, ref, tar)
    sr = np.full_like(t["sr"], 10.0)
    tt = _tables(t, sr)[1]
    base = fixed.compute(tt)
    out = adap.compute(tt)
    np.testing.assert_allclose(out.p.numpy(), base.p.numpy(), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(out.zncc.numpy(), base.zncc.numpy(), rtol=0,
                               atol=1e-4)


def test_fa2d_self_adaptive_matches_jax():
    """The example's self-adaptive settings: set_search(|(r, r)|, 14),
    set_subset_adjustment(14, 10).  POIs beyond the keypoints move to their
    KNN box's centre."""
    ref, tar, _, _ = _affine_kp(noise=0.2, outliers=40)
    jm = oc.FeatureAffine2D(30, 30, seed=4)
    tm = ot.FeatureAffine2D(30, 30, seed=4, device=CPU)
    for m in (jm, tm):
        m.set_search(float(np.sqrt(2.0 * 30 * 30)), 14)
        m.set_self_adaptive(True)
        m.set_subset_adjustment(14, 10)
        m.set_keypoint_pair(ref, tar)
    grid = ((5, 5), 14, 14, 20)  # reaches past the keypoints' [10, 250]
    jt = jm.compute(oc.poi_grid_2d(*grid))
    tt = ot.poi_grid_2d(*grid, device=CPU)
    draws = jax.random.randint(jax.random.PRNGKey(4), (3, tt.n, 20), 0,
                               1 << 30)
    got = ot.table_to_numpy(tm.compute(tt, draws=torch.from_numpy(
        np.array(draws))))
    for f in ("x", "y", "sr", "r"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jt, f)))
    np.testing.assert_allclose(got["p"], np.asarray(jt.p), rtol=0,
                               atol=1e-5)
    moved = got["x"] != tt.x.numpy()
    assert moved.any() and (got["sr"] >= 10).all()
    assert (got["r"][:, tpoi.R_ZNCC] == 0).mean() > 0.8
    assert (got["r"][:, tpoi.R_FEAT] <= 14).all()  # of the 14 KNN
