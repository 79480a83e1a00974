"""The frozen byte and operation counts give the bounds PERF.md records
for kernels 1-3 at the paths' launch shapes."""

import types

import pytest

from core import roofline, trace


def test_kernel_bounds_at_the_recorded_shapes():
    # kernel 1 at 30,000 windows of 33x33 on the 900x280 image
    assert roofline.gather2d((30000, 33, 33), (900, 280)) * 1e3 == \
        pytest.approx(0.0394, abs=5e-5)
    # kernel 2 at D=2, 30,000 POIs of 33x33
    assert roofline.lattice2d((30000, 33, 33, 2)) * 1e3 == \
        pytest.approx(0.2524, abs=5e-5)
    # kernel 3 at D=1, a 441-POI chunk of 61^3
    assert roofline.lattice3d((441, 61, 61, 61, 1)) * 1e3 == \
        pytest.approx(0.988, abs=5e-4)


@pytest.mark.parametrize("shape", [(30000, 33, 33, 2), (940, 33, 33, 6),
                                   (10000, 33, 33, 2)])
def test_bytes_bound_the_lattice_evals(shape):
    n, sy, sx, d = shape
    ops = n * sy * sx * roofline.LATTICE2D_FLOPS / roofline.PEAK_F32_FLOP_PER_S
    assert roofline.lattice2d(shape) > 2 * ops
    ops3 = 441 * 61 ** 3 * roofline.LATTICE3D_FLOPS / \
        roofline.PEAK_F32_FLOP_PER_S
    assert roofline.lattice3d((441, 61, 61, 61, 1)) > 2 * ops3


def test_share_sums_launches_and_reads_nothing_without_a_trace():
    tr = trace.Trace(window_s=1.0, busy_s=0.5,
                     kernel_s={"void lattice2d_kernel<3>(float*)": 0.001},
                     gaps=[])
    run = types.SimpleNamespace(
        trace=tr, launch_shapes={"lattice2d": {(30000, 33, 33, 2): 2}})
    share = roofline.share(run, "lattice2d", "lattice2d_kernel",
                           roofline.lattice2d)
    assert share == pytest.approx(100 * 2 * 0.2524e-3 / 0.001, rel=1e-3)
    assert roofline.share(types.SimpleNamespace(trace=None, launch_shapes={}),
                          "lattice2d", "lattice2d_kernel",
                          roofline.lattice2d) is None
    run.launch_shapes = {}
    assert roofline.share(run, "lattice2d", "lattice2d_kernel",
                          roofline.lattice2d) is None
