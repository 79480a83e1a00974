"""FeatureAffine2D/3D with ``neighbor_backend="device"`` (the all-pairs
neighbour search) against the JAX package's device backend on the CPU.

* ``device_candidates`` against the JAX package's own search (its lines
  of ``ops/feature_affine.feature_affine_2d``/``_3d`` under ``jit``):
  indices equal (the lower index first among equal distances, as
  ``jax.lax.top_k``), candidate masks and ``enough`` equal, in the radius
  branch, the KNN fallback and the self-adaptive ``knn_only`` mode.  XLA
  rounds the squared distances as fused multiply-adds, which the port
  reproduces.
* The modules, plain (2D and 3D) and self-adaptive (2D), with the JAX
  package's RANSAC draws: codes, iteration and feature counts equal, the
  moved POIs and radii equal, p within 1e-5.
* On integer keypoints, where distance ties are common, the device search
  and the host k-d tree give equal tables except on POIs whose candidate
  list holds a tie.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencorr_tpu as oc
import opencorr_tpu_torch as ot
from opencorr_tpu_torch.data import poi as tpoi
from opencorr_tpu_torch.models import feature_affine as tfa
from opencorr_tpu_torch.ops import feature_affine as tops

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)

CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.partial(jax.jit, static_argnames=("kc", "samples", "knn_only"))
def _jax_search(ref_kp, q, radius, nmin, knn_k, *, kc, samples, knn_only):
    """The neighbour stage of the JAX package's ``feature_affine_2d`` and
    ``feature_affine_3d``, line for line."""
    f32 = jnp.float32
    n = q.shape[0]
    d2 = (q[:, 0][:, None] - ref_kp[None, :, 0]) ** 2 \
        + (q[:, 1][:, None] - ref_kp[None, :, 1]) ** 2
    if q.shape[1] == 3:
        d2 = d2 + (q[:, 2][:, None] - ref_kp[None, :, 2]) ** 2
    in_radius = d2 < radius * radius
    nr = jnp.sum(in_radius, axis=1)
    neg, idx = jax.lax.top_k(-d2, kc)
    cand_d2 = -neg
    pos = jnp.arange(kc, dtype=f32)[None, :]
    if knn_only:
        cand = jnp.broadcast_to(pos < knn_k, (n, kc))
        enough = jnp.sum(cand, axis=1).astype(jnp.int32) >= samples
    else:
        cand = jnp.where((nr >= nmin)[:, None],
                         cand_d2 < radius * radius, pos < nmin)
        enough = nr >= samples
    return idx, cand, enough


def _kp(n, dim, seed=1, lo=10.0, hi=250.0, integer=False):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(lo, hi, (n, dim)).astype(np.float32)
    if integer:
        ref = np.round(ref)
    a = (np.eye(dim) + rng.normal(0, 0.01, (dim, dim))).astype(np.float32)
    t = np.float32([3.5, -2.0, 1.0][:dim])
    tar = ref @ a + t + rng.normal(0, 0.2, (n, dim)).astype(np.float32)
    tar[:30] += rng.uniform(4, 15, (30, dim)).astype(np.float32)
    return ref, tar


@pytest.mark.parametrize("dim,kc,radius,nmin,knn", [
    (2, 128, 22.63, 7, None), (2, 24, 12.0, 7, None), (2, 128, 0.0, 7, 14),
    (3, 128, 27.71, 16, None), (3, 64, 40.0, 16, None)])
def test_device_candidates_equal_jax(dim, kc, radius, nmin, knn):
    ref, _ = _kp(500, dim)
    rng = np.random.default_rng(3)
    q = rng.uniform(0, 260, (300, dim)).astype(np.float32)
    q[:10] += 300.0  # far away: the KNN fallback, too few in reach
    samples = dim + 1
    want = _jax_search(jnp.asarray(ref), jnp.asarray(q), jnp.float32(radius),
                       jnp.float32(nmin), jnp.float32(knn or 0), kc=kc,
                       samples=samples, knn_only=knn is not None)
    got = tops.device_candidates(_t(ref), _t(q), radius, nmin, samples, kc,
                                 knn_k=knn)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    if knn is None:
        assert not got[2].all() and got[2].any()


def test_nearest_orders_ties_by_index():
    d2 = _t(np.float32([[4, 1, 4, 1, 0, 4], [2, 2, 2, 2, 2, 2]]))
    vals, idx = tops.nearest(d2, 4)
    assert idx.tolist() == [[4, 1, 3, 0], [0, 1, 2, 3]]
    assert vals.tolist() == [[0, 1, 1, 4], [2, 2, 2, 2]]
    neg, jidx = jax.lax.top_k(-jnp.asarray(d2.numpy()), 4)
    assert idx.tolist() == np.asarray(jidx).tolist()


@pytest.mark.parametrize("chunk", [16384, 50])
def test_fa2d_device_module_with_jax_draws(chunk):
    """One JAX chunk (its draws are those of PRNGKey(seed)); the port in
    chunks of ``chunk``, which changes nothing."""
    ref, tar = _kp(400, 2)
    grid = ((20, 20), 12, 10, 20)
    jm = oc.FeatureAffine2D(16, 16, seed=4, neighbor_backend="device")
    jm.set_keypoint_pair(ref, tar)
    jt = jm.compute(oc.poi_grid_2d(*grid))
    tm = ot.FeatureAffine2D(16, 16, seed=4, chunk_size=chunk,
                            neighbor_backend="device", device=CPU)
    tm.set_keypoint_pair(ref, tar)
    tt = ot.poi_grid_2d(*grid, device=CPU)
    draws = jax.random.randint(jax.random.PRNGKey(4), (3, tt.n, 20), 0,
                               1 << 30)
    got = tm.compute(tt, draws=_t(draws))
    np.testing.assert_array_equal(got.r.numpy(), np.asarray(jt.r))
    np.testing.assert_allclose(got.p.numpy(), np.asarray(jt.p), rtol=0,
                               atol=1e-5)
    assert (got.zncc.numpy() == 0).mean() > 0.8


def test_fa2d_device_self_adaptive_with_jax_draws():
    """The example's self-adaptive settings on the device search: the
    moved POIs, the radii, codes and counts equal, p within 1e-5."""
    ref, tar = _kp(400, 2)
    jm = oc.FeatureAffine2D(30, 30, seed=4, neighbor_backend="device")
    tm = ot.FeatureAffine2D(30, 30, seed=4, neighbor_backend="device",
                            device=CPU)
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
    got = ot.table_to_numpy(tm.compute(tt, draws=_t(draws)))
    for f in ("x", "y", "sr", "r"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jt, f)))
    np.testing.assert_allclose(got["p"], np.asarray(jt.p), rtol=0,
                               atol=1e-5)
    assert (got["x"] != tt.x.numpy()).any()
    assert (got["r"][:, tpoi.R_ZNCC] == 0).mean() > 0.8


def test_fa3d_device_module_with_jax_draws():
    ref, tar = _kp(500, 3, lo=20.0, hi=200.0)
    grid = ((40, 40, 40), 5, 4, 3, 30)
    jm = oc.FeatureAffine3D(16, 16, 16, seed=3, neighbor_backend="device")
    jm.set_keypoint_pair(ref, tar)
    jt = jm.compute(oc.poi_grid_3d(*grid))
    tm = ot.FeatureAffine3D(16, 16, 16, seed=3, neighbor_backend="device",
                            device=CPU)
    tm.set_keypoint_pair(ref, tar)
    tt = ot.poi_grid_3d(*grid, device=CPU)
    draws = jax.random.randint(jax.random.PRNGKey(3), (4, tt.n, 32), 0,
                               1 << 30)
    got = tm.compute(tt, draws=_t(draws))
    np.testing.assert_array_equal(got.r.numpy(), np.asarray(jt.r))
    np.testing.assert_allclose(got.p.numpy(), np.asarray(jt.p), rtol=0,
                               atol=1e-5)
    assert (got.zncc.numpy() == 0).mean() > 0.8


def _tie_rows(ref, q, radius, nmin, kc):
    """POIs whose candidate list (and the entry past it) holds two equal
    float32 distances, or a distance equal to the radius squared."""
    d2 = tops.squared_distances(_t(q), _t(ref))
    vals, _ = tops.nearest(d2, min(kc, ref.shape[0]))
    vals = vals.numpy()
    r2 = np.float32(radius) * np.float32(radius)
    ties = (vals[:, 1:] == vals[:, :-1]).any(1) | (vals == r2).any(1)
    return ties


@pytest.mark.parametrize("dim", [2, 3])
def test_device_search_equals_host_but_on_ties(dim):
    """On integer keypoints the two backends' tables are equal on every
    POI without a distance tie in its candidate list; ties exist."""
    ref, tar = (_kp(600, 2, integer=True) if dim == 2 else
                _kp(1500, 3, lo=20.0, hi=200.0, integer=True))
    cls = ot.FeatureAffine2D if dim == 2 else ot.FeatureAffine3D
    args = (16,) * dim
    grid = (((20, 20), 12, 11, 20) if dim == 2
            else ((30, 30, 30), 5, 5, 5, 30))
    new = ot.poi_grid_2d if dim == 2 else ot.poi_grid_3d
    outs = {}
    for backend in ("host", "device"):
        m = cls(*args, seed=2, neighbor_backend=backend, device=CPU)
        m.set_keypoint_pair(ref, tar)
        outs[backend] = m.compute(new(*grid, device=CPU))
    h, d = outs["host"], outs["device"]
    q = np.stack(h.xy_numpy() if dim == 2 else h.coords_numpy(), -1)
    m = cls(*args, device=CPU)
    ties = _tie_rows(ref, q, m.neighbor_search_radius, m.neighbor_number_min,
                     m.k_cap)
    assert ties.any()
    same = ((h.r == d.r).all(1) & (h.p == d.p).all(1)).numpy()
    assert same[~ties].all()
    assert (h.zncc.numpy() == 0).mean() > 0.5


def test_backend_is_checked():
    with pytest.raises(ValueError):
        ot.FeatureAffine2D(16, 16, neighbor_backend="kdtree", device=CPU)
    m = ot.FeatureAffine3D(16, 16, 16, neighbor_backend="device", device=CPU)
    assert m.neighbor_backend == "device"
    assert tfa._trim(torch.zeros((2, 128), dtype=torch.int32),
                     torch.ones((2, 128), dtype=torch.bool), 4)[0].shape[1] \
        == 128
