"""The port's image-level primitives against the JAX package on the CPU:
gradients, the bicubic B-spline LUT and its evaluation, warps and the small
unpivoted Gauss-Jordan solves.  Tolerance: 1e-6 relative to the largest
magnitude of the compared field (float32 sums taken in another order).
The bicubic eval's plain version, whose rounding order the CUDA kernel
repeats, also against the port's first einsum (``chip_smoke.einsum_eval``)
within 8 float32 ulps, and what the CUDA wrapper refuses."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs

from opencorr_tpu.ops import bspline as jbs
from opencorr_tpu.ops import gradient as jgrad
from opencorr_tpu.ops import linalg as jlin
from opencorr_tpu.ops import warp as jwarp
from opencorr_tpu_torch.ops import bspline as tbs
from opencorr_tpu_torch.ops import gradient as tgrad
from opencorr_tpu_torch.ops import linalg as tlin
from opencorr_tpu_torch.ops import warp as twarp

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)


def _close(a, b, rel=1e-6):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(np.abs(b).max(), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale)


def _img(h=37, w=45, seed=0):
    rng = np.random.default_rng(seed)
    return np.round(rng.uniform(0, 255, (h, w))).astype(np.float32)


@pytest.mark.parametrize("axis", ["x", "y"])
def test_gradient_matches_jax(axis):
    img = _img()
    jf = getattr(jgrad, f"gradient_{axis}_2d")
    tf = getattr(tgrad, f"gradient_{axis}_2d")
    _close(tf(torch.from_numpy(img)).numpy(), jf(jnp.asarray(img)))


def test_bspline_constants_match_jax():
    np.testing.assert_array_equal(tbs.BC_MATRIX, jbs.BC_MATRIX)
    for b in (5, 45, 278, 898):
        assert tbs._below(b) == float(jbs._below(b))
        assert np.float32(tbs._below(b)) < np.float32(b)


def test_bicubic_prepare_matches_jax():
    img = _img(seed=1)
    lt = tbs.bicubic_prepare(torch.from_numpy(img)).numpy()
    lj = np.asarray(jbs.bicubic_prepare(jnp.asarray(img)))
    assert lt.shape == (37, 45, 4, 4)
    _close(lt, lj)
    # zero borders, as the reference leaves them unset
    assert not lt[0].any() and not lt[-2:].any()
    assert not lt[:, 0].any() and not lt[:, -2:].any()


def test_bicubic_eval_matches_jax():
    img = _img(seed=2)
    h, w = img.shape
    lut = np.array(jbs.bicubic_prepare(jnp.asarray(img)))
    rng = np.random.default_rng(3)
    xs = rng.uniform(-2, w + 1, 400).astype(np.float32)
    ys = rng.uniform(-2, h + 1, 400).astype(np.float32)
    below_w = np.float32(jbs._below(w - 2))
    below_h = np.float32(jbs._below(h - 2))
    # the _below band, the exact guards, NaN, and exact integers
    xs[:8] = [below_w, w - 2, 1.0, np.nan, 3.0, below_w, 0.999, 7.0]
    ys[:8] = [5.5, 5.5, 1.0, 4.0, np.nan, below_h, 3.0, h - 2]
    vt, ot_ = tbs.bicubic_eval(torch.from_numpy(lut), torch.from_numpy(xs),
                               torch.from_numpy(ys))
    vj, oj = jbs.bicubic_eval(jnp.asarray(lut), jnp.asarray(xs),
                              jnp.asarray(ys))
    np.testing.assert_array_equal(ot_.numpy(), np.asarray(oj))
    vt, vj = vt.numpy(), np.asarray(vj)
    oob = np.asarray(oj)
    assert (vt[oob] == -1.0).all() and (vj[oob] == -1.0).all()
    assert not oob[[0, 2, 5]].any() and oob[[1, 3, 4, 6, 7]].all()
    _close(vt[~oob], vj[~oob])


def _speckle(h, w, seed):
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    base = gaussian_filter(rng.standard_normal((h, w)), 1.5)
    return np.round(base / base.std() * 28.0 + 128.0).astype(np.float32)


@pytest.mark.parametrize("texture", ["noise", "speckle"])
def test_bicubic_eval_plain_matches_einsum(texture):
    """The plain version (the CUDA kernel's rounding order) against the
    port's first einsum formula: the oob mask equal, the -1 sentinel on
    the same samples, values within 8 float32 ulps.  On speckle (grey
    levels far from 0) the ulps are the value's; on white noise the terms
    of the bicubic sum cancel, so they are the ulps of its magnitude
    sum_kl |c_kl| yd^k xd^l (a float32 sum in any order rounds within
    about 4 of them)."""
    h, w = 37, 45
    img = _img(h, w, seed=2) if texture == "noise" else _speckle(h, w, 5)
    lut = tbs.bicubic_prepare(torch.from_numpy(img))
    xs, ys = map(torch.from_numpy, cs.lut_edge_coords(h, w, 4000, seed=3))
    want, oob_want = cs.einsum_eval(torch, lut, xs, ys)
    # in range, xd and yd lie in [0, 1): the eval of |c| is the magnitude
    mag = cs.einsum_eval(torch, lut.abs(), xs, ys)[0]
    for got, oob in (tbs.bicubic_eval_plain(lut, xs, ys),
                     tbs.bicubic_eval(lut, xs, ys)):
        assert torch.equal(oob, oob_want)
        assert (got[oob] == -1.0).all()
        assert not oob[[0, 2, 5]].any() and oob[[1, 3, 4, 6, 7]].all()
        scale = mag if texture == "noise" else want.abs()
        ulp = torch.from_numpy(np.spacing(scale.numpy().astype(np.float32)))
        assert ((got - want).abs() <= 8 * ulp)[~oob].all()
    assert oob.sum() > 100 and (~oob).sum() > 2000


def test_bicubic_eval_plain_float64_matches_einsum():
    """The float64 replay's path: the plain version in float64 within
    1e-12 of the einsum formula's magnitude, the mask equal."""
    h, w = 37, 45
    lut = tbs.bicubic_prepare(torch.from_numpy(_speckle(h, w, 6))).double()
    xs, ys = (torch.from_numpy(a).double()
              for a in cs.lut_edge_coords(h, w, 1000, seed=4))
    want, oob_want = cs.einsum_eval(torch, lut, xs, ys)
    mag = cs.einsum_eval(torch, lut.abs(), xs, ys)[0]
    got, oob = tbs.bicubic_eval_plain(lut, xs, ys)
    assert got.dtype == torch.float64 and torch.equal(oob, oob_want)
    assert ((got - want).abs() <= 1e-12 * mag)[~oob].all()


def test_bicubic_kernel_args_refused():
    """What the CUDA wrapper refuses, checked on CPU tensors: a wrong
    dtype, LUT shape, layout, alignment, coordinate shape or device; and
    a device that is neither CPU nor CUDA."""
    lut = torch.zeros((12, 10, 4, 4))
    xs = torch.zeros((6, 5))
    tbs.check_kernel_args(lut, xs, xs)  # what it takes
    off = torch.zeros(12 * 10 * 16 + 1)[1:].view(12, 10, 4, 4)
    for bad in ((lut.double(), xs, xs), (lut, xs.double(), xs),
                (lut, xs, xs.half()), (lut.reshape(12, 10, 16), xs, xs),
                (lut.transpose(0, 1), xs, xs), (lut, xs.t(), xs.t()),
                (lut, xs[:, ::2], xs[:, ::2]), (off, xs, xs),
                (lut, xs, xs[:5]), (lut, xs, xs.to("meta"))):
        with pytest.raises(ValueError):
            tbs.check_kernel_args(*bad)
    with pytest.raises(ValueError):
        tbs.bicubic_eval(lut.to("meta"), xs.to("meta"), xs.to("meta"))


def test_warp_round_trip_matches_jax():
    rng = np.random.default_rng(4)
    p6 = rng.normal(size=(50, 6)).astype(np.float32) * 0.1
    wt = twarp.warp2d1_from_p(torch.from_numpy(p6))
    wj = jwarp.warp2d1_from_p(jnp.asarray(p6))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(twarp.p_from_warp2d1(wt).numpy(),
                                  np.asarray(jwarp.p_from_warp2d1(wj)))


@pytest.mark.parametrize("k", [3, 6])
def test_inv_small_matches_jax(k):
    rng = np.random.default_rng(k)
    a = rng.normal(size=(64, k, k)).astype(np.float32)
    spd = (a @ a.transpose(0, 2, 1) + k * np.eye(k, dtype=np.float32))
    near_id = np.eye(k, dtype=np.float32) + 0.1 * a
    for m in (spd, near_id):
        _close(tlin.inv_small(torch.from_numpy(m)).numpy(),
               jlin.inv_small(jnp.asarray(m)))


def test_solve_small_matches_jax():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(40, 3, 3)).astype(np.float32)
    spd = a @ a.transpose(0, 2, 1) + 3 * np.eye(3, dtype=np.float32)
    b = rng.normal(size=(40, 3)).astype(np.float32)
    bm = rng.normal(size=(40, 3, 2)).astype(np.float32)
    _close(tlin.solve_small(torch.from_numpy(spd), torch.from_numpy(b)).numpy(),
           jlin.solve_small(jnp.asarray(spd), jnp.asarray(b)))
    _close(tlin.solve_small(torch.from_numpy(spd), torch.from_numpy(bm)).numpy(),
           jlin.solve_small(jnp.asarray(spd), jnp.asarray(bm)))
