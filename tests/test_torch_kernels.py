"""The plain PyTorch versions of the port's two kernels against the JAX
package's Pallas kernels in interpret mode on the CPU (the CUDA kernels
against their plain versions are in test_torch_cuda.py).

Gather: bit-exact, corners past the image clamped into it as
``lax.dynamic_slice`` clamps them.  Lattice:
within 1e-6 x max|eblk| (the float32 tap sum is taken in another order),
and exactly 0 where a placement offset is out of range.  Also the
launch bookkeeping the card runs read: launches counted per shape, and
``chip_smoke.py``'s path sums from phase 2's device times at the shapes
it checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencorr_tpu.ops.pallas_gather2d import gather_windows_2d as j_gather
from opencorr_tpu.ops.pallas_lattice2d import lattice_eval_2d as j_lattice
from opencorr_tpu_torch.ops import gather2d, lattice2d
from test_torch_cuda import _corners, _lattice_inputs, _out_of_range

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("sh,sw", [(32, 32), (33, 33), (40, 40), (48, 48),
                                   (7, 11)])
def test_gather_plain_bit_exact_vs_jax(sh, sw):
    rng = np.random.default_rng(sh * 100 + sw)
    img = rng.uniform(-50, 300, (90, 70)).astype(np.float32)
    y0, x0 = _corners(40, 90, 70, sh, sw, seed=sh + sw)
    want = np.asarray(j_gather(jnp.asarray(img), jnp.asarray(y0),
                               jnp.asarray(x0), sh=sh, sw=sw, interpret=True))
    got = gather2d.gather_windows_2d_plain(
        torch.from_numpy(img), torch.from_numpy(y0), torch.from_numpy(x0),
        sh=sh, sw=sw)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors, uncounted
    before = gather2d.gather_windows_2d.launches
    wrapped = gather2d.gather_windows_2d(
        torch.from_numpy(img), torch.from_numpy(y0), torch.from_numpy(x0),
        sh=sh, sw=sw)
    np.testing.assert_array_equal(wrapped.numpy(), want)
    assert gather2d.gather_windows_2d.launches == before


def test_gather_plain_clamps_negative_corners():
    """A negative corner clamps to 0 (``lax.dynamic_slice`` would first wrap
    it from the end; no caller passes one)."""
    img = torch.arange(90 * 70, dtype=torch.float32).reshape(90, 70)
    y0 = torch.tensor([-5, -1, 0, 95], dtype=torch.int32)
    x0 = torch.tensor([-3, 60, -70, -1], dtype=torch.int32)
    got = gather2d.gather_windows_2d_plain(img, y0, x0, sh=32, sw=32)
    assert torch.equal(got[0], img[:32, :32])
    assert torch.equal(got[1], img[:32, 38:])
    assert torch.equal(got[2], img[:32, :32])
    assert torch.equal(got[3], img[58:, :32])


@pytest.mark.parametrize("d,n,s", [(2, 12, 33), (6, 6, 33), (2, 9, 11)])
def test_lattice_plain_vs_jax(d, n, s):
    eblk, dy, dx, fy, fx = _lattice_inputs(n, s, d, seed=10 * d + n)
    want = np.asarray(j_lattice(
        jnp.asarray(eblk), jnp.asarray(dy), jnp.asarray(dx),
        jnp.asarray(fy), jnp.asarray(fx), d_wobble=d, interpret=True))
    got = lattice2d.lattice_eval_2d(
        torch.from_numpy(eblk), torch.from_numpy(dy), torch.from_numpy(dx),
        torch.from_numpy(fy), torch.from_numpy(fx), d_wobble=d).numpy()
    bad = _out_of_range(dy, dx, d)
    assert bad.any() and (~bad).any()
    assert (got[bad] == 0.0).all() and (want[bad] == 0.0).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(eblk).max())


def test_wrappers_check_shapes():
    img = torch.zeros((20, 20))
    c = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        gather2d.gather_windows_2d(img, c, c, sh=21, sw=4)
    eblk, dy, dx, fy, fx = (torch.from_numpy(a) for a in
                            _lattice_inputs(2, 5, 2, seed=0))
    with pytest.raises(ValueError):
        lattice2d.lattice_eval_2d(eblk, dy, dx, fy, fx, d_wobble=6)
    with pytest.raises(ValueError):
        lattice2d.lattice_eval_2d(eblk, dy, dx[:, :4], fy, fx, d_wobble=2)


def test_launch_counts_shapes():
    """``_kernels.launch`` counts a launch on the wrapper and, while its
    ``shapes`` dict is set, per launch shape; a failed launch raises and
    counts nothing."""
    from opencorr_tpu_torch.ops import _kernels

    def wrapper():
        pass

    wrapper.launches, wrapper.shapes = 0, {}
    for shape in ((30, 33, 33), (30, 33, 33), (7, 40, 40)):
        _kernels.launch(wrapper, lambda: 0, shape=shape)
    assert wrapper.launches == 3
    assert wrapper.shapes == {(30, 33, 33): 2, (7, 40, 40): 1}
    with pytest.raises(RuntimeError):
        _kernels.launch(wrapper, lambda: 700, shape=(1, 1, 1))
    assert wrapper.launches == 3 and (1, 1, 1) not in wrapper.shapes
    wrapper.shapes = None
    _kernels.launch(wrapper, lambda: 0, shape=(7, 40, 40))
    assert wrapper.launches == 4


def test_device_sum_takes_phase2_times_per_shape():
    """chip_smoke's path sums of kernels 1 and 2: launches x the device ms a
    launch at each shape, as phase 2 measured it; a shape that phase 2 did
    not time fails the run."""
    import chip_smoke

    def wrapper():
        pass

    wrapper.shapes = {(30000, 33, 33, 2): 3, (7500, 33, 33, 2): 1}
    rec = chip_smoke.device_sum(wrapper, {"30000x33x33x2": 0.3,
                                          "7500x33x33x2": 0.08, "1x1x1x2": 9})
    assert wrapper.shapes is None
    assert rec["launches"] == 4 and rec["timing"] == chip_smoke.ESTIMATED
    assert rec["timing"].startswith("estimated")
    assert rec["ms_sum"] == pytest.approx(0.98)
    assert rec["by_shape"]["30000x33x33x2"] == dict(
        launches=3, ms_per_launch=0.3, ms_sum=pytest.approx(0.9))
    wrapper.shapes = {(2, 5, 5, 2): 1}
    with pytest.raises(AssertionError, match="did not time"):
        chip_smoke.device_sum(wrapper, {"30000x33x33x2": 0.3})


def test_event_ms_sums_events_per_counted_shape():
    """chip_smoke's path sums of kernels 3 and 4: launches per shape from
    the wrapper's ``shapes`` count, ms summed from each launch's events;
    both recordings stop."""
    import chip_smoke

    class Event:
        def __init__(self, t):
            self.t = t

        def elapsed_time(self, end):
            return end.t - self.t

    def wrapper():
        pass

    wrapper.shapes = {(441, 61, 61, 61, 1): 2, (9, 33, 33, 33, 1): 1}
    wrapper.events = [(Event(0.0), Event(1.5), (441, 61, 61, 61, 1)),
                      (Event(2.0), Event(2.25), (9, 33, 33, 33, 1)),
                      (Event(3.0), Event(4.75), (441, 61, 61, 61, 1))]
    rec = chip_smoke.event_ms(wrapper)
    assert wrapper.shapes is None and wrapper.events is None
    assert rec["launches"] == 3 and rec["timing"] == "events"
    assert rec["ms_sum"] == pytest.approx(3.5)
    assert rec["by_shape"]["441x61x61x61x1"] == dict(
        launches=2, ms_per_launch=pytest.approx(1.625),
        ms_sum=pytest.approx(3.25))
    merged = chip_smoke.merge_event_ms([{"k": rec}, {"k": rec}])["k"]
    assert merged["launches"] == 6 and merged["ms_sum"] == pytest.approx(7.0)


def test_kernel12_cases_cover_the_paths_launch_shapes():
    """Phase 2's shapes of kernels 1 and 2 hold every shape the planar
    suite's rules give, the stereo path's IC-GN shapes and its epipolar
    chunk, each once."""
    import chip_smoke
    import opencorr_tpu_torch as ot

    gathers, lattices = chip_smoke.kernel12_cases(ot)
    g = [c[:3] for c in gathers]
    lat = [(n, s, s, d) for n, s, d, _ in lattices]
    assert len(set(g)) == len(g) and len(set(lat)) == len(lat)
    suite_g, suite_l = chip_smoke.dic2d_launch_shapes(ot)
    assert suite_g <= set(g) and suite_l <= set(lat)
    n, side = chip_smoke.STEREO_POIS, 2 * chip_smoke.STEREO_EPI_R + 1
    assert {(n, 33, 33), (n, 40, 40), (312, 48, 48),
            (chip_smoke.epipolar_windows(ot), side, side)} <= set(g)
    assert {(n, 33, 33, 2), (2500, 33, 33, 2), (312, 33, 33, 6)} <= set(lat)
    assert {c[3] for c in gathers} == {"main", "gt4", "rotation"}
