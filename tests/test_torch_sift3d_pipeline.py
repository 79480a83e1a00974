"""The feature-seeded DVC slice as a whole against the JAX package on the
CPU: SIFT3D -> FeatureAffine3D -> ICGN3D1 on a 52^3 speckle pair, the
smallest size at which octave 0's first layer takes the fused descriptor
histogram (kernel 4; its crop of 23 plus the gradient margin needs 49
voxels).

Keypoint counts and matched sets equal the JAX package's device path
(``pyramid_backend="device"``, whose Pallas kernel runs in interpret mode
here).  FeatureAffine3D on those matches with the JAX package's RANSAC
draws: codes equal, p within 1e-5.  ICGN3D1 from the same seeded table:
codes equal, u/v/w within 2e-5 voxel (the 12x12 Gauss-Newton solve
amplifies float32 rounding; test_torch_dvc_pipeline.py)."""

import jax
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, shift as ndshift

import opencorr_tpu as oc
import opencorr_tpu_torch as ot
from opencorr_tpu_torch.ops import desc3d

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)

SHIFT_ZYX = (2.0, -1.0, 1.5)


@pytest.fixture(scope="module")
def pair():
    """tests/test_sift3d.py's device-path pair at D=52."""
    d = 52
    rng = np.random.default_rng(2)
    base = gaussian_filter(rng.standard_normal((d + 20,) * 3).astype(
        np.float32), 1.5) * 50 + 128
    ref = base[10:10 + d, 10:10 + d, 10:10 + d]
    tar = ndshift(base, SHIFT_ZYX, order=3)[10:10 + d, 10:10 + d, 10:10 + d]
    return np.ascontiguousarray(ref), np.ascontiguousarray(tar)


@pytest.fixture(scope="module")
def matched(pair):
    ref, tar = pair
    j = oc.SIFT3D(pyramid_backend="device")
    j.set_images(ref, tar)
    j.compute()
    before = desc3d.descriptor_hist.launches
    t = ot.SIFT3D(pyramid_backend="device", device="cpu")
    t.set_images(ref, tar)
    t.compute()
    assert desc3d.descriptor_hist.launches == before  # plain on the CPU
    return j, t


def _rows(kp):
    return set(map(tuple, np.round(kp, 3).tolist()))


def test_sift3d_matches_jax_device_path(matched):
    j, t = matched
    assert (t.ref_kp_count, t.tar_kp_count) == (j.ref_kp_count,
                                                j.tar_kp_count)
    pairs_j = _rows(np.concatenate([j.ref_matched_kp, j.tar_matched_kp], 1))
    pairs_t = _rows(np.concatenate([t.ref_matched_kp, t.tar_matched_kp], 1))
    assert pairs_t == pairs_j
    assert len(pairs_t) >= 8
    fused = [st for st in t.layer_stats if st["fused"]]
    assert fused and all(st["octave"] == 0 and st["layer"] == 1
                         for st in fused)
    assert sum(st["kept"] for st in fused) > 0
    med = np.median(t.tar_matched_kp - t.ref_matched_kp, axis=0)
    for m, s in zip(med, SHIFT_ZYX[::-1]):
        assert abs(m - s) <= 1.0


def test_fa3d_and_icgn3d1_on_the_matches(pair, matched):
    ref, tar = pair
    _, t = matched
    grid = ((20, 20, 20), 2, 2, 2, 10)
    seed = 4
    jfa = oc.FeatureAffine3D(16, 16, 16, seed=seed)
    jfa.set_keypoint_pair(t.ref_matched_kp, t.tar_matched_kp)
    jseed = jfa.compute(oc.poi_grid_3d(*grid))
    fa = ot.FeatureAffine3D(16, 16, 16, seed=seed, device="cpu")
    fa.set_keypoint_pair(t.ref_matched_kp, t.tar_matched_kp)
    pois = ot.poi_grid_3d(*grid, device="cpu")
    draws = np.array(jax.random.randint(jax.random.PRNGKey(seed),
                                        (4, pois.n, 32), 0, 1 << 30))
    seeded = fa.compute(pois, draws=torch.from_numpy(draws))
    np.testing.assert_array_equal(seeded.r.numpy(), np.asarray(jseed.r))
    np.testing.assert_allclose(seeded.p.numpy(), np.asarray(jseed.p),
                               rtol=0, atol=1e-5)
    assert (seeded.zncc.numpy() == 0).all()

    s = ot.table_to_numpy(seeded)
    jt = oc.new_table_3d(s["x"], s["y"], s["z"]).replace(
        p=jax.numpy.asarray(s["p"]), r=jax.numpy.asarray(s["r"]))
    jic = oc.ICGN3D1(16, 16, 16, 0.001, 10)
    jic.set_images(ref, tar)
    jic.prepare()
    jout = jic.compute(jt)
    tic = ot.ICGN3D1(16, 16, 16, 0.001, 10, device="cpu")
    tic.set_images(ref, tar)
    tic.prepare()
    tout = ot.table_to_numpy(tic.compute(seeded))
    zj, zt = np.asarray(jout.r)[:, 3], tout["r"][:, 3]
    np.testing.assert_array_equal(np.where(zt < 0, zt, 1),
                                  np.where(zj < 0, zj, 1))
    ok = zt > 0.9
    assert ok.all()
    np.testing.assert_allclose(tout["p"][:, [0, 4, 8]],
                               np.asarray(jout.p)[:, [0, 4, 8]], rtol=0,
                               atol=2e-5)
    # the field is the imposed translation
    np.testing.assert_allclose(tout["p"][:, [8, 4, 0]],
                               np.broadcast_to(SHIFT_ZYX, (pois.n, 3)),
                               rtol=0, atol=0.02)
