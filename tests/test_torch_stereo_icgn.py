"""The port's second-order IC-GN, center offsets and EpipolarSearch against
the JAX package on the CPU, from identical state.

Second order (12 dof): codes and iteration counts equal (but for stopping
decisions inside float32 noise, ``_assert_icgn_equal``), u/v of half the
POIs within 1e-5 px and of all within 5e-5 px, every other parameter
within 5e-5.  The 12x12 system amplifies float32 rounding: on this pair
the JAX package and the port each lie up to about 4e-5 px from a float64
replay of the same iterations, in different directions (ROADMAP §3), so
no float32 summation order the port could choose holds 1e-5 everywhere.
First order with offsets: u/v within 2e-5 px, for the same reason.
EpipolarSearch is held in test_torch_stereo_pipeline.py."""

import numpy as np
import pytest
import torch

import opencorr_tpu as oc
import opencorr_tpu_torch as ot
from opencorr_tpu.data import poi as jpoi
from opencorr_tpu.ops import warp as jwarp
from opencorr_tpu_torch.data import poi as tpoi
from opencorr_tpu_torch.ops import icgn as ticgn
from opencorr_tpu_torch.ops import warp as twarp
from test_torch_icgn_queue import _port_table

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)

CPU = "cpu"


def test_warp2d2_matches_jax():
    rng = np.random.default_rng(4)
    p = rng.normal(0, 0.05, (64, 12)).astype(np.float32)
    p[:, [0, 6]] *= 40
    want = np.asarray(jwarp.warp2d2_from_p(p))
    got = twarp.warp2d2_from_p(torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(twarp.p_from_warp2d2(got).numpy(),
                               np.asarray(jwarp.p_from_warp2d2(want)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(twarp.p_from_warp2d2(got).numpy(), p,
                               rtol=0, atol=1e-5)


def _seeded(speckle_pair_2d):
    ref, tar, _, _ = speckle_pair_2d
    tj = oc.poi_grid_2d((30, 30), 10, 8, 12)
    f = oc.FFTCC2D(10, 10)
    f.set_images(ref, tar)
    return ref, tar, f.compute(tj)


def _assert_close_12(j, t, conv=0.001, uv_tol=5e-5):
    """Codes equal, the near-stop rule of test_torch_icgn_queue, u/v of half
    the POIs within 1e-5 and of all within ``uv_tol``; the other parameters
    within 5e-5."""
    zj, zt = j["r"][:, tpoi.R_ZNCC], t["r"][:, tpoi.R_ZNCC]
    np.testing.assert_array_equal(np.where(zt < 0, zt, 1),
                                  np.where(zj < 0, zj, 1))
    np.testing.assert_array_equal(t["sr"], j["sr"])
    itj, itt = j["r"][:, jpoi.R_ITER], t["r"][:, tpoi.R_ITER]
    marginal = itj != itt
    assert marginal.sum() <= max(1, len(itj) // 1000), np.where(marginal)[0]
    first = np.where(itt < itj, t["r"][:, tpoi.R_CONV],
                     j["r"][:, jpoi.R_CONV])[marginal]
    assert ((first >= 0.98 * conv) & (first < conv)).all(), first
    same = ~marginal
    duv = np.abs(t["p"][:, [0, 6]] - j["p"][:, [0, 6]]).max(1)[same]
    assert np.median(duv) <= 1e-5 and duv.max() <= uv_tol, duv.max()
    np.testing.assert_allclose(t["p"][same], j["p"][same], rtol=0,
                               atol=uv_tol)
    np.testing.assert_allclose(zt[same], zj[same], rtol=0, atol=1e-5)
    np.testing.assert_allclose(t["p"][marginal], j["p"][marginal], rtol=0,
                               atol=conv)


@pytest.mark.parametrize("order,margin,offsets", [
    (2, 8, False), (2, 8, True), (2, None, False), (2, None, True),
    (1, 8, True)])
def test_icgn2d_matches_jax(speckle_pair_2d, order, margin, offsets):
    """ICGN2D2 and center offsets (the stereo overload), windowed (the
    target windows centred on x + ox, y + oy) and on the global LUT."""
    ref, tar, tj = _seeded(speckle_pair_2d)
    # the JAX package reads no offsets as zero offsets (ops/icgn.py:335-337);
    # it gets zeros here so that both cases share one compile
    off = np.zeros((tj.n, 2), np.float32)
    if offsets:
        off = np.random.default_rng(0).uniform(-0.7, 0.7, (tj.n, 2)).astype(
            np.float32)
    jcls, tcls = ((oc.ICGN2D1, ot.ICGN2D1) if order == 1
                  else (oc.ICGN2D2, ot.ICGN2D2))
    mj = jcls(10, 10, 0.001, 10, window_margin=margin)
    mj.set_images(ref, tar)
    mj.prepare()
    outj = mj.compute(tj, off)
    mt = tcls(10, 10, 0.001, 10, window_margin=margin, device=CPU)
    mt.set_images(ref, tar)
    mt.prepare()
    outt = mt.compute(_port_table(tj), torch.from_numpy(off) if offsets
                      else None)
    j = {f: np.asarray(getattr(outj, f)) for f in ("p", "r", "sr")}
    t = ot.table_to_numpy(outt)
    _assert_close_12(j, t, uv_tol=5e-5 if order == 2 else 2e-5)
    assert (t["r"][:, tpoi.R_ZNCC] > 0.9).mean() > 0.9
    if margin is not None:
        assert mt.stats["iter_full"] > 0
    if order == 2 and margin is None and not offsets:
        # both packages against a float64 replay of the port's iteration
        d = lambda a: a.double()
        tt = _port_table(tj)
        p64 = ticgn.icgn2d(d(mt._gx), d(mt._gy), d(mt.ref_img), d(mt._lut),
                           d(tt.x), d(tt.y), d(tt.p), d(tt.r[:, 2]), 0.001,
                           10, order=2, rx=10, ry=10)[0].numpy()
        ok = t["r"][:, tpoi.R_ZNCC] > 0
        for side in (j, t):
            assert np.abs(side["p"][ok][:, [0, 6]]
                          - p64[ok][:, [0, 6]]).max() < 6e-5
    with pytest.raises(ValueError):
        mt.compute(_port_table(tj), torch.zeros((3, 2)))
