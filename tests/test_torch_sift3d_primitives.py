"""The port's SIFT3D primitives against the JAX package's on the CPU, on the
same numpy inputs.

Equal: the blur (taps, mirror padding, tap order), the octave stack and its
DoG layers and maxima, the extremum mask, the scan-order compaction, the
window gathers, ``match_top2``'s neighbour indices and the two elimination
tails.  Within 1e-5: the orientation rotations (the structure tensor's sums
are taken in another order), ``match_top2``'s distances; ``ok`` equal.
Within 1e-6: the exact einsum descriptor (the JAX package's own gate between
its two descriptor paths, tests/test_sift3d.py:166)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencorr_tpu.models import sift3d as jmodel
from opencorr_tpu.ops import sift3d as jops
from opencorr_tpu.ops.sift2d import _compact as j_compact
from opencorr_tpu_torch.models import sift3d as tmodel
from opencorr_tpu_torch.ops import sift3d as tops

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)


def _vol(shape, seed, scale=40.0):
    rng = np.random.default_rng(seed)
    return (128 + scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _random_rotations(rng, n):
    rots = []
    for _ in range(n):
        a = rng.standard_normal(3)
        a /= np.linalg.norm(a)
        b = rng.standard_normal(3)
        b -= (b @ a) * a
        b /= np.linalg.norm(b)
        rots.append(np.stack([a, b, np.cross(a, b)]))
    return np.float32(rots)


@pytest.mark.parametrize("shape,sigma,units", [
    ((20, 22, 24), 1.23, (1.0, 1.0, 1.0)),
    ((18, 20, 26), 0.54, (1.0, 1.0, 1.0)),
    ((12, 14, 16), 1.54, (2.0, 2.0, 4.0)),
    ((6, 9, 12), 2.45, (1.0, 1.0, 1.0)),  # radius 8 > axis length: re-reflected
    ((10, 11, 12), 0.0, (1.0, 1.0, 1.0)),
])
def test_gaussian_blur_equal(shape, sigma, units):
    v = _vol(shape, seed=len(shape) + shape[0])
    want = np.asarray(jops.gaussian_blur(jnp.asarray(v), sigma, units))
    got = tops.gaussian_blur(_t(v), sigma, units).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("down", [None, (9, 10, 11)])
def test_octave_stack_equal(down):
    v = _vol((19, 21, 23), seed=5)
    sigmas = (0.54, 0.97, 1.23, 1.54, 1.95, 2.45) if down is None else (
        None, 0.97, 1.23, 1.54, 1.95, 2.45)
    jg, jd, jm = jops.octave_stack(jnp.asarray(v), sigmas=sigmas,
                                   unit_xyz=(1.0, 1.0, 1.0),
                                   downsample_to=down)
    tg, td, tm = tops.octave_stack(_t(v), sigmas=sigmas,
                                   unit_xyz=(1.0, 1.0, 1.0),
                                   downsample_to=down)
    for a, b in zip(jg, tg):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jd, td):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert [float(m) for m in tm] == [float(m) for m in jm]


def _dogs(seed=7, shape=(22, 24, 26)):
    g, d, m = tops.octave_stack(_t(_vol(shape, seed)),
                                sigmas=(0.54, 0.97, 1.23, 1.54),
                                unit_xyz=(1.0, 1.0, 1.0))
    return [x.numpy() for x in d], [float(x) for x in m]


def test_extrema_mask_equal():
    d, m = _dogs()
    thr = np.float32(0.1) * np.float32(m[1])
    want = np.asarray(jops.extrema_mask(*(jnp.asarray(x) for x in d[:3]),
                                        jnp.float32(thr)))
    got = tops.extrema_mask(*(_t(x) for x in d[:3]), float(thr)).numpy()
    assert want.sum() > 10
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 37, 500])
def test_compact_equal(k):
    rng = np.random.default_rng(k)
    mask = rng.uniform(size=300) < 0.2
    ji, jo = j_compact(jnp.asarray(mask), k)
    ti, to = tops._compact(_t(mask), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("k_cap", [8, 256])
def test_extrema_compact_equal(k_cap):
    """The first k_cap candidates in scan (z-major) order; with k_cap below
    the count the cap keeps the low-z ones."""
    d, m = _dogs()
    thr = np.float32(0.1) * np.float32(m[1])
    jx, jy, jz, jok = jops.extrema_compact(
        *(jnp.asarray(x) for x in d[:3]), jnp.float32(thr), k_cap=k_cap)
    tx, ty, tz, tok, count = tops.extrema_compact(
        *(_t(x) for x in d[:3]), float(thr), k_cap=k_cap)
    for a, b in ((jx, tx), (jy, ty), (jz, tz), (jok, tok)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert count == int(np.asarray(jops.extrema_mask(
        *(jnp.asarray(x) for x in d[:3]), jnp.float32(thr))).sum())
    assert int(tok.sum()) == min(count, k_cap)
    assert count > 8  # the small cap cuts


def test_gather_windows_equal():
    v = _vol((20, 22, 24), seed=1)
    xi = np.array([0, 12, 23, 3], np.int32)
    yi = np.array([21, 11, 0, 2], np.int32)
    zi = np.array([10, 0, 19, 18], np.int32)
    jw = jops._gather_windows_3d(jnp.asarray(v), *map(jnp.asarray,
                                                      (xi, yi, zi)), 4)
    tw = tops.gather_windows_3d(_t(v), *map(_t, (xi, yi, zi)), 4)
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _orientation_inputs():
    """Windows of a smooth speckle volume at central and near-border
    keypoints, plus the JAX package's isotropic and anisotropic windows
    (tests/test_sift3d.py:61-93)."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(3)
    v = (gaussian_filter(rng.standard_normal((30, 32, 34)), 1.5) * 200
         + 128).astype(np.float32)
    xi = np.array([17, 2, 31, 17, 10, 25], np.int32)
    yi = np.array([16, 16, 3, 30, 8, 20], np.int32)
    zi = np.array([15, 15, 15, 1, 27, 12], np.int32)
    return v, xi, yi, zi


def test_assign_orientation_close():
    v, xi, yi, zi = _orientation_inputs()
    r = 8
    args = jops._gather_windows_3d(jnp.asarray(v), *map(jnp.asarray,
                                                       (xi, yi, zi)), r)
    dims = (v.shape[2], v.shape[1], v.shape[0])
    extra = (1.6, (1.0, 1.0, 1.0), 1e-10, 0.9, 0.4)
    jr, jo = jops.assign_orientation(
        *args, *map(jnp.asarray, (xi, yi, zi)),
        jnp.asarray(np.int32(dims)), jnp.float32(extra[0]),
        jnp.asarray(np.float32(extra[1])), *map(jnp.float32, extra[2:]))
    tr, to = tops.assign_orientation(
        *(_t(np.asarray(a)) for a in args), *map(_t, (xi, yi, zi)), dims,
        *extra)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert to.numpy().any()
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-5)


def test_assign_orientation_beta_gamma_cases():
    """The JAX package's isotropic (rejected) and anisotropic (accepted)
    windows give the same verdicts and rotations in the port."""
    rng = np.random.default_rng(0)
    s = 17
    r = (s - 1) // 2
    iso = rng.standard_normal((s, s, s)).astype(np.float32)
    zz, yy, xx = np.meshgrid(*([np.arange(s, dtype=np.float32)] * 3),
                             indexing="ij")
    aniso = (np.sin(xx * 0.9) * 40 + np.sin(yy * 0.31) * 9
             + np.sin(zz * 0.17) * 3).astype(np.float32)
    wins = np.stack([iso, aniso])
    c = np.array([r, r], np.int32)
    z0 = np.zeros(2, np.int32)
    jr, jo = jops.assign_orientation(
        jnp.asarray(wins), *map(jnp.asarray, (z0, z0, z0, c, c, c)),
        jnp.asarray(np.int32([s, s, s])), jnp.float32(1.6),
        jnp.asarray(np.ones(3, np.float32)), jnp.float32(1e-10),
        jnp.float32(0.9), jnp.float32(0.4))
    tr, to = tops.assign_orientation(
        _t(wins), *map(_t, (z0, z0, z0, c, c, c)), (s, s, s), 1.6,
        (1.0, 1.0, 1.0), 1e-10, 0.9, 0.4)
    assert list(to.numpy()) == [False, True] == list(np.asarray(jo))
    np.testing.assert_allclose(tr.numpy()[1], np.asarray(jr)[1], rtol=0,
                               atol=1e-5)


def test_sym_eigh_close():
    rng = np.random.default_rng(9)
    a = rng.standard_normal((50, 3, 3)).astype(np.float32)
    a = a @ a.transpose(0, 2, 1)
    jv, je = jops._sym_eigh_desc_3x3(jnp.asarray(a))
    tv, te = tops._sym_eigh_desc_3x3(_t(a))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(np.abs(te.numpy()), np.abs(np.asarray(je)),
                               rtol=0, atol=2e-4)


def _descriptor_inputs():
    """tests/test_sift3d.py:137-156: near-border keypoints off-centre in
    their edge-clamped windows, random rotations, r_desc 16, scale 1."""
    rng = np.random.default_rng(42)
    dz, dy, dx = 40, 44, 48
    vol = np.float32(128 + 40 * rng.standard_normal((dz, dy, dx)))
    xi = np.array([24, 5, 45, 24, 2, 24, 30, 46], np.int32)
    yi = np.array([22, 22, 22, 3, 41, 22, 20, 2], np.int32)
    zi = np.array([20, 20, 20, 20, 20, 2, 37, 38], np.int32)
    return vol, xi, yi, zi, _random_rotations(rng, len(xi))


@pytest.mark.parametrize("use_crop", [True, False])
def test_construct_descriptor_close(use_crop, monkeypatch):
    vol, xi, yi, zi, rot = _descriptor_inputs()
    scale, units, trunc, r_desc = 1.0, (1.0, 1.0, 1.0), 0.2 * 128 / 768, 16
    crop = jops._sphere_crop(r_desc, scale, units) if use_crop else None
    assert tops._sphere_crop(r_desc, scale, units) == \
        jops._sphere_crop(r_desc, scale, units)
    dims = (vol.shape[2], vol.shape[1], vol.shape[0])
    win, x0, y0, z0 = jops._gather_windows_3d(
        jnp.asarray(vol), *map(jnp.asarray, (xi, yi, zi)), r_desc)
    want = np.asarray(jops.construct_descriptor(
        win, x0, y0, z0, *map(jnp.asarray, (xi, yi, zi)),
        jnp.asarray(np.int32(dims)), jnp.asarray(rot), jnp.float32(scale),
        jnp.asarray(np.float32(units)), jnp.float32(trunc), crop=crop))
    # several histogram slabs, as on the main path's larger layers
    monkeypatch.setattr(tops, "SLAB_ELEMS", 8 * 3000)
    got = tops.construct_descriptor(
        *(_t(np.asarray(a)) for a in (win, x0, y0, z0)),
        *map(_t, (xi, yi, zi)), dims, _t(rot), scale, units, trunc,
        crop=crop).numpy()
    assert np.abs(got - want).max() < 1e-6
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_construct_descriptor_options_not_ported():
    """``parts`` (a benchmark knob) still raises; ``hist_bf16`` is ported:
    the bf16-operand histogram against the JAX package's, within 1e-6 as
    the float32 one (the operands round alike, their products are exact,
    the sums run in another order), and away from the float32 one."""
    vol, xi, yi, zi, rot = _descriptor_inputs()
    win, x0, y0, z0 = tops.gather_windows_3d(_t(vol), *map(_t, (xi, yi, zi)),
                                             4)
    args = (win, x0, y0, z0, *map(_t, (xi, yi, zi)), (48, 44, 40), _t(rot),
            1.0, (1.0, 1.0, 1.0), 0.03)
    with pytest.raises(NotImplementedError):
        tops.construct_descriptor(*args, parts="nobary")
    scale, units, trunc, r_desc = 1.0, (1.0, 1.0, 1.0), 0.2 * 128 / 768, 16
    dims = (vol.shape[2], vol.shape[1], vol.shape[0])
    win, x0, y0, z0 = jops._gather_windows_3d(
        jnp.asarray(vol), *map(jnp.asarray, (xi, yi, zi)), r_desc)
    jargs = (win, x0, y0, z0, *map(jnp.asarray, (xi, yi, zi)),
             jnp.asarray(np.int32(dims)), jnp.asarray(rot),
             jnp.float32(scale), jnp.asarray(np.float32(units)),
             jnp.float32(trunc))
    want = np.asarray(jops.construct_descriptor(*jargs, hist_bf16=True))
    targs = (*(_t(np.asarray(a)) for a in (win, x0, y0, z0)),
             *map(_t, (xi, yi, zi)), dims, _t(rot), scale, units, trunc)
    got = tops.construct_descriptor(*targs, hist_bf16=True).numpy()
    f32 = tops.construct_descriptor(*targs).numpy()
    assert np.abs(got - want).max() < 1e-6
    assert np.abs(f32 - want).max() > 1e-5


def test_match_top2_and_eliminations_equal():
    rng = np.random.default_rng(1)
    n1, n2 = 40, 48
    d2_ = rng.uniform(0.1, 1.0, (n2, 768)).astype(np.float32)
    d2_ /= np.linalg.norm(d2_, axis=1, keepdims=True)
    d1_ = d2_[rng.permutation(n2)[:n1 - 5]]
    d1_ = np.concatenate([d1_ + 0.01 * rng.standard_normal(d1_.shape),
                          rng.uniform(0.1, 1, (5, 768))]).astype(np.float32)
    d1_[3] = d1_[4]  # two refs share a target: many-to-one
    ok2 = np.ones(n2, bool)
    ok2[-3:] = False  # padding rows never win
    jd, ji = jops.match_top2(jnp.asarray(d1_), jnp.asarray(d2_),
                             jnp.asarray(ok2), chunk=8)
    td, ti = tops.match_top2(_t(d1_), _t(d2_), _t(ok2), chunk=8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)
    kp1 = rng.uniform(0, 50, (n1, 6)).astype(np.float32)
    kp2 = rng.uniform(0, 50, (n2, 6)).astype(np.float32)
    dd, ii = np.asarray(jd), np.asarray(ji)
    v1 = np.ones(n1, bool)
    v1[7] = False
    for ratio in (0.85, 0.99):
        for a, b in zip(jmodel._mono_eliminate(kp1, v1, kp2, n2 - 3, dd, ii,
                                               ratio),
                        tmodel._mono_eliminate(kp1, v1, kp2, n2 - 3, dd, ii,
                                               ratio)):
            np.testing.assert_array_equal(a, b)
    jd21, ji21 = jops.match_top2(jnp.asarray(d2_), jnp.asarray(d1_),
                                 jnp.asarray(v1), chunk=8)
    d21, i21 = np.asarray(jd21), np.asarray(ji21)
    for a, b in zip(
            jmodel._bi_eliminate(kp1, v1, kp2, ok2, dd, ii, d21, i21, 0.9),
            tmodel._bi_eliminate(kp1, v1, kp2, ok2, dd, ii, d21, i21, 0.9)):
        np.testing.assert_array_equal(a, b)
        assert len(a) > 10


def test_compact_gather_and_assemble_equal():
    rng = np.random.default_rng(4)
    ok = rng.uniform(size=50) < 0.4
    x, y, z = (rng.integers(0, 30, 50).astype(np.int32) for _ in range(3))
    rot = rng.standard_normal((50, 3, 3)).astype(np.float32)
    jo = jops.compact_gather(*map(jnp.asarray, (ok, x, y, z, rot)), k_cap=32)
    to = tops.compact_gather(*map(_t, (ok, x, y, z, rot)), k_cap=32)
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    sizes = (5, 9, 4)
    layers = [(rng.integers(0, 30, n).astype(np.int32),
               rng.integers(0, 30, n).astype(np.int32),
               rng.integers(0, 30, n).astype(np.int32),
               rng.uniform(size=n) < 0.6,
               rng.standard_normal((n, 768)).astype(np.float32),
               np.float32([2.0 ** o, o, 1 + o, 1.6 * 2 ** o]))
              for o, n in enumerate(sizes)]
    cols = list(zip(*layers))
    ja = jops.assemble_keypoints(
        *(tuple(jnp.asarray(a) for a in c) for c in cols), k_cap=8)
    ta = tops.assemble_keypoints(*([_t(a) for a in c] for c in cols[:5]),
                                 cols[5], k_cap=8)
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_plan_layers_equal():
    for shape in ((568, 288, 940), (52, 52, 52), (40, 60, 80)):
        j = jmodel.SIFT3D()._plan_layers(shape)
        t = tmodel.SIFT3D(device="cpu")._plan_layers(shape)
        assert len(j) == len(t)
        for a, b in zip(j, t):
            assert (a.dims, a.units, a.octave) == (b.dims, b.units, b.octave)
            assert (a.scale, a.sigma) == (b.scale, b.sigma)


def test_not_ported_options_raise():
    """The host path and the bf16 histograms are ported
    (tests/test_torch_sift3d_host.py, tests/test_torch_sift3d_kernel.py):
    the constructor's defaults follow the JAX package's, and it keeps the
    options it is given."""
    j, t = jmodel.SIFT3D(), tmodel.SIFT3D(device="cpu")
    for name in ("pyramid_backend", "match_mode", "hist_bf16",
                 "kp_chunk_budget"):
        assert getattr(t, name) == getattr(j, name)
    assert t.pyramid_backend == "host"
    m = tmodel.SIFT3D(pyramid_backend="device", hist_bf16=True, device="cpu")
    assert m.pyramid_backend == "device" and m.hist_bf16
