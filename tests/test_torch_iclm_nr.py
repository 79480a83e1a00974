"""The port's IC-LM (orders 1 and 2) and Newton-Raphson refiners against the
JAX package on the CPU, from identical state: the JAX FFTCC table of the
speckle pair, carried across as numpy arrays, through both modules'
``compute``.

The queue holds, beside the grid, POIs whose samples leave the image or
their window (IC-LM and NR blend the -1 sentinel into the cost, with no
abort) and POIs the entry guard rejects (IC-LM -3, NR -1 unless the POI
already carries a code below -1).  IC-LM first order: u/v within 1e-5
px, codes and iteration counts equal but for stopping decisions inside
float32 noise (``_assert_icgn_equal``).  Second order: the 12-dof gate of
ICGN2D2 (median 1e-5, worst 5e-5; ROADMAP §3).

NR rebuilds and inverts its Hessian from the sampled target gradients every
iteration, which amplifies float32 rounding: on this pair the JAX package
lies up to 1.05e-5 px from a float64 replay of the same iterations and the
port up to 7.2e-6, on different sides, so the two differ by up to 1.4e-5
(ROADMAP §3).  NR is gated as first-order IC-GN with offsets: codes and
iteration counts equal, u/v of the converged POIs median 1e-5 and worst
2e-5, and both packages within 1.5e-5 of the replay.  The edge POI never
converges (-4): its steps wander with the rounding, so only its code and
iteration count are compared."""

import numpy as np
import pytest
import torch

import opencorr_tpu as oc
import opencorr_tpu_torch as ot
from opencorr_tpu.ops import iclm as jiclm
from opencorr_tpu_torch.data import poi as tpoi
from opencorr_tpu_torch.ops import iclm as ticlm
from opencorr_tpu_torch.ops import nr as tnr
from test_torch_icgn_queue import _assert_icgn_equal
from test_torch_stereo_icgn import _assert_close_12

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)

CPU = "cpu"
R = 10


@pytest.fixture(scope="module")
def queue(speckle_pair_2d):
    """The FFTCC-seeded grid plus: an edge POI whose subset the target
    motion pushes off the image; a POI seeded 7 px off the truth (it
    leaves its r+8 window as it converges back); border and earlier-code
    POIs the entry guard rejects."""
    ref, tar, _, _ = speckle_pair_2d
    h, w = ref.shape
    grid = oc.poi_grid_2d((30, 30), 10, 8, 12)
    xs = np.concatenate([np.asarray(grid.x), [w - 1 - R, 90.0, 2.0, 60.0,
                                              72.0]])
    ys = np.concatenate([np.asarray(grid.y), [80.0, 96.0, 50.0, 60.0,
                                              72.0]])
    f = oc.FFTCC2D(R, R)
    f.set_images(ref, tar)
    tj = f.compute(oc.new_table_2d(xs.astype(np.float32),
                                   ys.astype(np.float32)))
    t = {k: np.array(getattr(tj, k)) for k in ("x", "y", "p", "r", "e",
                                                "sr")}
    n = len(xs)
    t["p"][n - 5, 0] = 2.0  # the edge POI keeps a sound seed
    t["r"][n - 5, tpoi.R_ZNCC] = 0.9
    t["p"][n - 4, 0] += 7.0
    t["r"][n - 2, tpoi.R_ZNCC] = -2.0  # an earlier code below -1: kept
    t["r"][n - 1, tpoi.R_ZNCC] = -0.5  # a code above -1: NR writes -1
    return ref, tar, t


def _tables(t):
    jt = oc.new_table_2d(t["x"], t["y"]).replace(
        p=t["p"], r=t["r"], e=t["e"], sr=t["sr"])
    return jt, ot.table_from_numpy(*(t[k] for k in ("x", "y", "p", "r", "e",
                                                    "sr")), device=CPU)


def _run(jcls, tcls, ref, tar, t, margin, **kw):
    jm = jcls(R, R, 0.001, 10, **kw)
    tm = tcls(R, R, 0.001, 10, device=CPU, **kw)
    for m in (jm, tm):
        m.window_margin = margin
        m.set_images(ref, tar)
        m.prepare()
    jt, tt = _tables(t)
    outj = jm.compute(jt)
    j = {f: np.asarray(getattr(outj, f)) for f in ("p", "r", "sr")}
    return j, ot.table_to_numpy(tm.compute(tt)), tm


@pytest.mark.parametrize("order,margin", [(1, 8), (1, None), (2, 8),
                                          (2, None)])
def test_iclm_matches_jax(queue, order, margin):
    ref, tar, t = queue
    jcls, tcls = ((oc.ICLM2D1, ot.ICLM2D1) if order == 1
                  else (oc.ICLM2D2, ot.ICLM2D2))
    j, got, tm = _run(jcls, tcls, ref, tar, t, margin)
    if order == 1:
        _assert_icgn_equal(j, got)
    else:
        _assert_close_12(j, got)
    z = got["r"][:, tpoi.R_ZNCC]
    assert (z[:80] > 0.9).mean() > 0.9
    assert (z[-3:] == [-3.0, -2.0, -0.5]).all()  # guard: -3 or kept
    assert z[-5] != -3.0  # the off-image samples blend in: no abort
    assert tm.stats["iter_full"] > 0
    if margin is not None:
        assert tm.stats["correct"] > 0  # the 7 px seed needs D=6


def test_iclm_damping_and_op(queue):
    """Other damping through ``set_damping``, and the op called directly
    with the module's inputs."""
    ref, tar, t = queue
    jm = oc.ICLM2D1(R, R, 0.001, 10)
    tm = ot.ICLM2D1(R, R, 0.001, 10, device=CPU)
    for m in (jm, tm):
        m.set_damping(10.0, 0.5, 4.0)
        m.set_images(ref, tar)
        m.prepare()
    jt, tt = _tables(t)
    j = jm.compute(jt)
    _assert_icgn_equal({f: np.asarray(getattr(j, f)) for f in ("p", "r",
                                                               "sr")},
                       ot.table_to_numpy(tm.compute(tt)))
    outs = ticlm.iclm2d(tm._gx, tm._gy, tm.ref_img, tm._lut, tt.x, tt.y,
                        tt.p, tt.r[:, 2], 0.001, 10, (10.0, 0.5, 4.0),
                        order=1, rx=R, ry=R)
    want = jiclm.iclm2d(jm._gx, jm._gy, jm.ref_img, jm._lut, jt.x, jt.y,
                        jt.p, jt.r[:, 2], np.float32(0.001),
                        np.float32(10), np.float32([10.0, 0.5, 4.0]),
                        order=1, rx=R, ry=R)
    np.testing.assert_array_equal(outs[6].numpy(), np.asarray(want[6]))
    np.testing.assert_array_equal(outs[3].numpy() < 0,
                                  np.asarray(want[3]) < 0)


def _assert_nr_equal(j, got):
    """NR's gate (module docstring): codes equal, the failed POIs'
    iteration counts equal, the others as ``_assert_close_12`` with u/v
    worst 2e-5."""
    zj, zt = j["r"][:, tpoi.R_ZNCC], got["r"][:, tpoi.R_ZNCC]
    np.testing.assert_array_equal(np.where(zt < 0, zt, 1),
                                  np.where(zj < 0, zj, 1))
    failed = zt < 0
    np.testing.assert_array_equal(got["r"][failed, tpoi.R_ITER],
                                  j["r"][failed, tpoi.R_ITER])
    _assert_close_12({k: v[~failed] for k, v in j.items()},
                     {k: v[~failed] for k, v in got.items()}, uv_tol=2e-5)


@pytest.mark.parametrize("margin", [8, None])
def test_nr_matches_jax(queue, margin):
    """Three evals an iteration (target and its two gradients), windowed
    or global, and the -1 guard."""
    ref, tar, t = queue
    j, got, tm = _run(oc.NR2D1, ot.NR2D1, ref, tar, t, margin)
    _assert_nr_equal(j, got)
    ok = got["r"][:, tpoi.R_ZNCC] >= 0
    zt = got["r"][:, tpoi.R_ZNCC]
    # both packages against a float64 replay of the port's iteration on the
    # global LUTs
    d = lambda a: a.double()
    tt = _tables(t)[1]
    p64 = tnr.nr2d1(d(tm.ref_img), d(tm._lut), d(tm._lut_gx),
                    d(tm._lut_gy), d(tt.x), d(tt.y), d(tt.p),
                    d(tt.r[:, tpoi.R_ZNCC]), 0.001, 10, rx=R,
                    ry=R)[0].numpy()
    for side in (j, got):
        assert np.abs(side["p"][ok][:, [0, 6]]
                      - p64[ok][:, [0, 6]]).max() < 1.5e-5
    assert (zt[:80] > 0.9).mean() > 0.9
    assert (zt[-3:] == [-1.0, -2.0, -1.0]).all()
    assert tm.stats["iter_full"] > 0
    with pytest.raises(NotImplementedError):
        tm.set_self_adaptive(True)


@pytest.mark.parametrize("kind", ["icgn1", "icgn2", "iclm1", "nr1"])
def test_global_eval_mode_matches_jax(queue, kind):
    """An ``eval_mode`` other than "lattice" takes the global LUT in both
    packages (the JAX package's ``icgn.py:421-430``), whatever the
    margin: no windowed branch runs, and the tables agree with each
    refiner's gate above."""
    ref, tar, t = queue
    jcls, tcls = {"icgn1": (oc.ICGN2D1, ot.ICGN2D1),
                  "icgn2": (oc.ICGN2D2, ot.ICGN2D2),
                  "iclm1": (oc.ICLM2D1, ot.ICLM2D1),
                  "nr1": (oc.NR2D1, ot.NR2D1)}[kind]
    jm = jcls(R, R, 0.001, 10)
    tm = tcls(R, R, 0.001, 10, device=CPU)
    for m in (jm, tm):
        m.window_margin = 8
        m.eval_mode = "global"
        m.set_images(ref, tar)
        m.prepare()
    jt, tt = _tables(t)
    outj = jm.compute(jt)
    j = {f: np.asarray(getattr(outj, f)) for f in ("p", "r", "sr")}
    got = ot.table_to_numpy(tm.compute(tt))
    if kind == "nr1":
        _assert_nr_equal(j, got)
    elif kind == "icgn2":
        _assert_close_12(j, got)
    else:
        _assert_icgn_equal(j, got)
    assert not {"full", "correct", "exact", "exact_all"} & set(tm.stats)
    assert tm.stats["iter_full"] > 0
    assert tcls(R, R, eval_mode="global", device=CPU)._margin() is None


@pytest.mark.parametrize("kind", ["icgn1", "iclm1", "nr1"])
def test_margin_rule_small_image(kind):
    """The windowed eval gives way to the global LUT on an image too small
    for the window (``base.eval_margin``): at
    r = 8 and margin 8, min(side - 2r) - 1 < 2 * margin below 33 px."""
    tcls = {"icgn1": ot.ICGN2D1, "iclm1": ot.ICLM2D1, "nr1": ot.NR2D1}[kind]
    m = tcls(8, 8, window_margin=8, device=CPU)
    for shape, want in (((40, 33), 8), ((33, 40), 8), ((32, 40), None),
                        ((40, 32), None)):
        m.set_images(np.zeros(shape, np.uint8), np.zeros(shape, np.uint8))
        assert m._margin() == want, shape
    m.window_margin = None
    assert m._margin() is None
