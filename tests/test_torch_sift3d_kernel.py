"""The plain PyTorch version of the port's SIFT3D descriptor-histogram
kernel (kernel 4, ``ops/desc3d.py``) against the JAX package's Pallas
kernel (``pallas_desc.descriptor_hist``) in interpret mode on the CPU (the
CUDA kernel against its plain version is in test_torch_cuda.py).

The histogram S within 1e-5 x max|S| on identical inputs (the sums run in
another order: index_add_ here, a one-hot matrix product there); the fused
descriptors within 1e-6, the JAX package's own gate between its two
descriptor paths (tests/test_sift3d.py:166), on that test's near-border
keypoints."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencorr_tpu.ops import pallas_desc as jpd
from opencorr_tpu.ops import sift3d as jops
from opencorr_tpu_torch.ops import desc3d
from opencorr_tpu_torch.ops import sift3d as tops
from test_torch_sift3d_primitives import _descriptor_inputs, _random_rotations

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)

TRUNC = 0.2 * 128 / 768


def _t(a):
    return torch.from_numpy(np.array(a))


def test_face_tables_equal():
    for a, b in zip(jpd._face_tables(), desc3d._face_tables()):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("scale,units", [(0.5, (1.0, 1.0, 1.0)),
                                         (1.0, (1.0, 1.0, 2.0))])
def test_hist_plain_vs_jax(scale, units):
    """hist_from_tables against the Pallas kernel on the same [CZ, K, CYX]
    gradients, tables and rotations, keypoints central and at the edges."""
    rng = np.random.default_rng(int(10 * scale))
    shape = (30, 34, 38)
    vol = _t(np.float32(128 + 40 * rng.standard_normal(shape)))
    crop = tops._sphere_crop(64, scale, units)
    k = 8
    xi = _t(np.int32([19, 1, 36, 19, 0, 10, 30, 37]))
    yi = _t(np.int32([17, 17, 2, 33, 16, 5, 20, 1]))
    zi = _t(np.int32([15, 15, 15, 1, 28, 29, 0, 14]))
    rot = _random_rotations(rng, k).reshape(k, 9)
    starts, tab = desc3d.prepare_tables(shape, xi, yi, zi, crop=crop,
                                        scale=scale, unit_xyz=units)
    args = [a.numpy() for a in desc3d.hist_inputs(vol, starts, tab,
                                                  crop=crop, unit_xyz=units)]
    want = np.asarray(jpd.descriptor_hist(*map(jnp.asarray, args),
                                          jnp.asarray(rot), scale=scale,
                                          interpret=True))
    counts = {}
    got = desc3d.hist_from_tables(*map(_t, args), _t(rot), scale=scale,
                                  counts=counts).numpy()
    assert 0 < counts["live_voxels"] < counts["sphere_voxels"]
    m = np.abs(want).max()
    assert m > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * m)


@pytest.mark.parametrize("scale,units", [(0.5, (1.0, 1.0, 1.0)),
                                         (1.0, (1.0, 1.0, 2.0))])
def test_hist_plain_bf16_vs_jax(scale, units):
    """``hist_bf16``: both factors of every product rounded to bfloat16, as
    the Pallas kernel's bf16 operands, and away from the float32
    histogram.  XLA contracts the kernel's rotations into fused
    multiply-adds, so a factor can differ from the port's by one float32
    ulp, and where that ulp straddles a bfloat16 rounding boundary the
    product moves by one bfloat16 step (2^-8 relative): all but 0.1% of
    the entries within 1e-5 x max|S|, every one within 2^-7 relative."""
    rng = np.random.default_rng(int(10 * scale) + 1)
    shape = (30, 34, 38)
    vol = _t(np.float32(128 + 40 * rng.standard_normal(shape)))
    crop = tops._sphere_crop(64, scale, units)
    k = 6
    xi = _t(np.int32([19, 1, 36, 19, 10, 30]))
    yi = _t(np.int32([17, 17, 2, 33, 5, 20]))
    zi = _t(np.int32([15, 15, 15, 1, 29, 0]))
    rot = _random_rotations(rng, k).reshape(k, 9)
    starts, tab = desc3d.prepare_tables(shape, xi, yi, zi, crop=crop,
                                        scale=scale, unit_xyz=units)
    args = [a.numpy() for a in desc3d.hist_inputs(vol, starts, tab,
                                                  crop=crop, unit_xyz=units)]
    want = np.asarray(jpd.descriptor_hist(*map(jnp.asarray, args),
                                          jnp.asarray(rot), scale=scale,
                                          hist_bf16=True, interpret=True))
    got = desc3d.hist_from_tables(*map(_t, args), _t(rot), scale=scale,
                                  hist_bf16=True).numpy()
    f32 = desc3d.hist_from_tables(*map(_t, args), _t(rot),
                                  scale=scale).numpy()
    m = np.abs(want).max()
    assert (np.abs(got - want) > 1e-5 * m).mean() < 1e-3
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-5 * m)
    assert np.abs(f32 - want).max() > 1e-4 * m
    # the wrapper's plain route takes the flag
    plain = desc3d.descriptor_hist(vol, starts, tab, _t(rot), crop=crop,
                                   scale=scale, unit_xyz=units,
                                   hist_bf16=True)
    assert torch.equal(plain, _t(got))


def test_fused_descriptor_vs_jax():
    vol, xi, yi, zi, rot = _descriptor_inputs()
    scale, units, r_desc = 1.0, (1.0, 1.0, 1.0), 16
    crop = jops._sphere_crop(r_desc, scale, units)
    want = np.asarray(jpd.construct_descriptor_fused(
        jnp.asarray(vol), *map(jnp.asarray, (xi, yi, zi)), jnp.asarray(rot),
        jnp.float32(TRUNC), crop=crop, scale=scale, unit_xyz=units,
        interpret=True))
    before = desc3d.descriptor_hist.launches
    got = desc3d.construct_descriptor_fused(
        _t(vol), *map(_t, (xi, yi, zi)), _t(rot), TRUNC, crop=crop,
        scale=scale, unit_xyz=units).numpy()
    # the wrapper takes the plain version for CPU tensors, uncounted
    assert desc3d.descriptor_hist.launches == before
    assert np.abs(got - want).max() < 1e-6
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_fused_descriptor_matches_einsum_path():
    """The port's two descriptor paths agree as the JAX package's do
    (tests/test_sift3d.py:125-167)."""
    vol, xi, yi, zi, rot = _descriptor_inputs()
    scale, units, r_desc = 1.0, (1.0, 1.0, 1.0), 16
    crop = tops._sphere_crop(r_desc, scale, units)
    xs, ys, zs = map(_t, (xi, yi, zi))
    de = tops.describe_keypoints(_t(vol), xs, ys, zs, _t(rot), scale, units,
                                 TRUNC, r=r_desc, crop=crop).numpy()
    df = desc3d.describe_keypoints_fused(_t(vol), xs, ys, zs, _t(rot), TRUNC,
                                         crop=crop, scale=scale,
                                         unit_xyz=units).numpy()
    assert np.abs(de - df).max() < 1e-6


def test_wrapper_is_plain_on_cpu_and_checks_shapes():
    rng = np.random.default_rng(5)
    shape = (24, 26, 28)
    vol = _t(np.float32(128 + 40 * rng.standard_normal(shape)))
    crop = (6, 6, 6)
    xi, yi, zi = (_t(np.int32([3, 12, 20])) for _ in range(3))
    rot = _t(_random_rotations(rng, 3).reshape(3, 9))
    starts, tab = desc3d.prepare_tables(shape, xi, yi, zi, crop=crop,
                                        scale=0.4, unit_xyz=(1.0, 1.0, 1.0))
    kw = dict(crop=crop, scale=0.4, unit_xyz=(1.0, 1.0, 1.0))
    before = desc3d.descriptor_hist.launches
    got = desc3d.descriptor_hist(vol, starts, tab, rot, **kw)
    assert desc3d.descriptor_hist.launches == before
    assert torch.equal(got, desc3d.descriptor_hist_plain(vol, starts, tab,
                                                         rot, **kw))
    assert got.shape == (3, 60, 64) and got.abs().max() > 0
    with pytest.raises(ValueError):
        desc3d.descriptor_hist(vol, starts, tab[:, :, :-1], rot, **kw)
    with pytest.raises(ValueError):
        desc3d.descriptor_hist(vol, starts[:, :2], tab, rot, **kw)
    with pytest.raises(ValueError):
        desc3d.descriptor_hist(vol[:14], starts, tab, rot, **kw)
