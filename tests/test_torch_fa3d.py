"""The port's FeatureAffine3D against the JAX package's on the CPU.

The candidate tables are equal.  ``feature_affine_3d_idx`` given the JAX
package's own RANSAC draws (jax.random.randint(PRNGKey(seed), (4, N, T),
0, 2^30), as ``_ransac_core_3d`` draws them) gives equal codes, iteration
and feature counts and p12 within 1e-5 (the least-squares normal equations
are summed in another order).  With its own torch.Generator draws the
module meets the JAX package's acceptance test for an exact affine field
(tests/test_feature.py:70-88)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import opencorr_tpu as oc
import opencorr_tpu_torch as ot
from opencorr_tpu.models import feature_affine as jfa
from opencorr_tpu.ops import feature_affine as jops
from opencorr_tpu_torch.data import poi as tpoi
from opencorr_tpu_torch.models import feature_affine as tfa
from opencorr_tpu_torch.ops import feature_affine as tops

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _affine_kp(n=500, seed=1, noise=0.0, outliers=0):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(20, 200, (n, 3)).astype(np.float32)
    a = (np.eye(3) + rng.normal(0, 0.01, (3, 3))).astype(np.float32)
    t = np.array([1.5, -2.0, 0.7], np.float32)
    tar = ref @ a + t + rng.normal(0, noise, (n, 3)).astype(np.float32)
    if outliers:
        tar[:outliers] += rng.uniform(5, 20, (outliers, 3)).astype(np.float32)
    return ref, tar, a, t


def _queries(seed=3, n=300):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 220, (n, 3))
    q[:10] = rng.uniform(300, 400, (10, 3))  # far away: too few in reach
    return q


@pytest.mark.parametrize("kc,radius,nmin", [(128, 27.71, 16), (24, 40.0, 16),
                                            (64, 20.0, 7)])
def test_host_candidates_equal(kc, radius, nmin):
    ref, _, _, _ = _affine_kp()
    tree = cKDTree(ref)
    q = _queries()
    want = jfa._host_candidates(tree, q, kc, radius, nmin, 4)
    got = tfa._host_candidates(tree, q, kc, radius, nmin, 4)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    assert not got[2].all() and got[2].any()


@pytest.mark.parametrize("noise,outliers,seed", [(0.0, 0, 0), (0.3, 60, 5),
                                                 (1.0, 150, 11)])
def test_ransac_with_jax_draws(noise, outliers, seed):
    ref, tar, _, _ = _affine_kp(noise=noise, outliers=outliers)
    q = _queries().astype(np.float32)
    idx, cand, enough = jfa._host_candidates(cKDTree(ref), q.astype(
        np.float64), 128, 27.71, 16, 4)
    trials = 32
    want = jops.feature_affine_3d_idx(
        jnp.asarray(ref), jnp.asarray(tar), *(jnp.asarray(q[:, i])
                                              for i in range(3)),
        jnp.asarray(idx), jnp.asarray(cand), jnp.asarray(enough),
        jnp.float32(16), jnp.float32(3.2), jnp.int32(seed), trials=trials,
        samples=4)
    draws = np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                          (4, len(q), trials), 0, 1 << 30))
    got = tops.feature_affine_3d_idx(
        _t(ref), _t(tar), *(_t(q[:, i]) for i in range(3)), _t(idx),
        _t(cand), _t(enough), 16, 3.2, _t(draws), trials=trials, samples=4)
    p_w, z_w, it_w, f_w, ok_w = (np.asarray(a) for a in want)
    p_g, z_g, it_g, f_g, ok_g = (a.numpy() for a in got)
    np.testing.assert_array_equal(ok_g, ok_w)
    np.testing.assert_array_equal(z_g, z_w)
    np.testing.assert_array_equal(it_g, it_w)
    np.testing.assert_array_equal(f_g, f_w)
    np.testing.assert_allclose(p_g, p_w, rtol=0, atol=1e-5)
    assert (z_g == -1).any() and ok_g.mean() > 0.3


def test_module_with_jax_draws_equals_jax_module():
    """FeatureAffine3D with the JAX package's draws reproduces the JAX
    module's table (one chunk, so its draws are those of PRNGKey(seed))."""
    ref, tar, _, _ = _affine_kp(noise=0.2, outliers=40)
    pois = oc.poi_grid_3d((40, 40, 40), 5, 4, 3, 30)
    jout = oc.FeatureAffine3D(16, 16, 16, seed=3)
    jout.set_keypoint_pair(ref, tar)
    jt = jout.compute(pois)
    fa = ot.FeatureAffine3D(16, 16, 16, seed=3, device="cpu")
    fa.set_keypoint_pair(ref, tar)
    tt = ot.poi_grid_3d((40, 40, 40), 5, 4, 3, 30, device="cpu")
    draws = jax.random.randint(jax.random.PRNGKey(3), (4, tt.n, 32), 0,
                               1 << 30)
    got = fa.compute(tt, draws=_t(np.asarray(draws)))
    np.testing.assert_array_equal(got.r.numpy(), np.asarray(jt.r))
    np.testing.assert_allclose(got.p.numpy(), np.asarray(jt.p), rtol=0,
                               atol=1e-5)


def test_feature_affine_3d_exact():
    """tests/test_feature.py:70-88 with the port's own draws."""
    ref, tar, a, t = _affine_kp()
    fa = ot.FeatureAffine3D(16, 16, 16, device="cpu")
    fa.set_keypoint_pair(ref, tar)
    out = fa.compute(ot.poi_grid_3d((60, 60, 60), 4, 4, 4, 20, device="cpu"))
    ok = out.zncc.numpy() == 0
    assert ok.mean() > 0.7
    p = out.p.numpy()[ok]
    xyz = np.stack(out.coords_numpy(), -1)[ok]
    exp = xyz @ a + t - xyz
    for col, c in ((tpoi.U3, 0), (tpoi.V3, 1), (tpoi.W3, 2)):
        assert np.abs(p[:, col] - exp[:, c]).max() < 2e-2


def test_feature_affine_3d_codes_and_draws():
    """-1 far from every keypoint, draws independent of the device, chunked
    computes equal to one chunk, and the device neighbour search
    (tests/test_torch_fa_device.py) equal to the host one here."""
    ref, tar, _, _ = _affine_kp(noise=0.1, outliers=30)
    xyz = np.array([[100.0, 100.0, 100.0], [120.0, 90.0, 60.0],
                    [900.0, 900.0, 900.0]], np.float32)
    d1 = tops.ransac_draws(7, 5, 32)
    assert torch.equal(d1, tops.ransac_draws(7, 5, 32))
    assert d1.dtype == torch.int64 and int(d1.max()) < (1 << 30)
    outs = []
    for chunk in (131072, 2):
        fa = ot.FeatureAffine3D(16, 16, 16, seed=7, chunk_size=chunk,
                                device="cpu")
        fa.set_keypoint_pair(ref, tar)
        outs.append(fa.compute(ot.new_table_3d(*xyz.T, device="cpu")))
    z = outs[0].zncc.numpy()
    assert list(z) == [0.0, 0.0, -1.0]
    for f in ("p", "r"):
        assert torch.equal(getattr(outs[0], f), getattr(outs[1], f))
    fa = ot.FeatureAffine3D(16, 16, 16, seed=7, neighbor_backend="device",
                            device="cpu")
    fa.set_keypoint_pair(ref, tar)
    dev = fa.compute(ot.new_table_3d(*xyz.T, device="cpu"))
    for f in ("p", "r"):
        assert torch.equal(getattr(dev, f), getattr(outs[0], f))
