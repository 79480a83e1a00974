"""The stereo cell (``stereo_epipolar_sift.seq``) on the CPU: its
configuration, mix, generator, pipeline and metrics load through
``core/spec``; its plain reference imports nothing of the program and no
JAX; the generator gives the same frames for a seed and others for
another, the same set of motions for every seed, the configuration's
cameras and a scene that the rendered views and the imposed field agree
on; the cell at a window of the sensor is correct, and not with the
cross match's refiner skipped; the control breaks a limit; and each new
reader reads its span, counter or launches, or gives None."""

import json
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from conftest import BENCH, ROOT, make_checkout
from core import check
from core.cell import Run, run_cell
from core.spec import Spec
from generators import stereo as gen

import opencorr_tpu_torch as ot
from opencorr_tpu_torch.utils import timing

CELL = "stereo_epipolar_sift.seq"
NEW = ("epipolar.ms_per_pair", "icgn2d2.ms_per_pair",
       "epipolar.iterations_per_pair", "lut2d_roofline")
ORIGIN = [760, 400]
# the configuration at a window of the sensor the CPU runs in a minute:
# 60 POIs
TINY = dict(frame_shape=[224, 352], sensor_origin=ORIGIN,
            poi_grid={"upper_left": [60, 90], "number_x": 10,
                      "number_y": 6, "step": 20})


def _tiny_mix(mix):
    return dict(mix, targets=2, origin=ORIGIN)


@pytest.fixture
def tiny(tmp_path):
    root = make_checkout(tmp_path)
    bench = root / "benchmark"
    path = bench / "configs" / "stereo_epipolar_sift.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), **TINY)))
    path = bench / "traffic" / "gt4_stereo_seq.json"
    path.write_text(json.dumps(_tiny_mix(json.loads(path.read_text()))))
    return root


def test_the_cell_loads_through_the_spec():
    spec = Spec(ROOT)
    cell = spec.cell(CELL)
    assert cell["chips"] == 1
    cfg = spec.config(cell["config"])
    assert cfg["pipeline"] == "stereo_epipolar_sift"
    assert cfg["frame_shape"] == [1200, 1920] and cfg["reduced"] == ["images"]
    g = cfg["poi_grid"]
    assert g["number_x"] * g["number_y"] == 10000
    assert "sensor_origin" not in cfg
    mix = spec.traffic(cell["traffic"])
    assert mix["generator"] == "stereo" and mix["loop"] == "closed"
    assert "origin" not in mix and mix["targets"] == 8
    assert spec.generator(mix["generator"]).make_sequence
    assert spec.loop(mix["loop"]).run
    pipe = spec.pipeline(cfg["pipeline"])
    assert pipe.KERNELS == ("gather2d", "lattice2d", "bicubic2d")
    assert pipe.COUNTED["bicubic2d"] is ot.ops.bspline.bicubic_eval
    assert set(cfg["check"]["limits"]) <= {
        "seed_mismatch", "code_mismatch", "disp_gap", "disp_gap_mean",
        "grad_gap", "zncc_gap"}
    assert [m["name"] for m in spec.metrics(CELL, False)] == [
        "pairs_per_s", "setup_s"]
    traced = [m["name"] for m in spec.metrics(CELL, True)]
    assert traced == ["device_idle_share", *NEW]
    for name in traced:
        assert spec.reader(name).read


def test_the_generator_holds_the_configuration_s_cameras():
    cfg = Spec(ROOT).config("stereo_epipolar_sift")
    assert [(c["intrinsics"], c["extrinsics"]) for c in cfg["cameras"]] == [
        (dict(i), dict(e)) for i, e in gen.CAMERAS]
    assert tuple(cfg["frame_shape"]) == gen.SENSOR


def test_the_reference_imports_nothing_of_the_program():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(BENCH)!r}]\n"
        "import reference.stereo, generators.stereo\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'opencorr_tpu_torch', 'opencorr_tpu', 'jax', 'jaxlib'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=BENCH)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def _mix(targets=2):
    return _tiny_mix(dict(Spec(ROOT).traffic("gt4_stereo_seq"),
                          targets=targets))


def test_frames_repeat_for_a_seed_and_differ_across_seeds():
    shape = [48, 64]
    a = gen.make_sequence(shape, _mix(), 2 ** 31 + 11, "cpu")
    b = gen.make_sequence(shape, _mix(), 2 ** 31 + 11, "cpu")
    c = gen.make_sequence(shape, _mix(), 7, "cpu")
    assert a.reference.dtype == np.uint8
    assert a.reference.shape == (2, *shape)
    assert len(a.targets) == 2 and a.targets[0].shape == (2, *shape)
    assert np.array_equal(a.reference, b.reference)
    assert all(np.array_equal(x, y) for x, y in zip(a.targets, b.targets))
    assert not np.array_equal(a.reference, c.reference)
    assert not np.array_equal(a.targets[0], c.targets[0])


def test_every_seed_gets_the_same_set_of_motions():
    mix = dict(Spec(ROOT).traffic("gt4_stereo_seq"))
    t1, s1 = gen.motions(mix, 1)
    t2, s2 = gen.motions(mix, 2 ** 31 + 3)
    for a in range(3):
        assert np.allclose(np.sort(t1[:, a]), np.sort(t2[:, a]))
    assert np.allclose(np.sort(s1[:, 0]), np.sort(s2[:, 0]))
    assert not np.array_equal(t1, t2)
    assert np.abs(t1[:, :2]).max() < 0.5
    assert t1[:, 2].min() > -2.0 and t1[:, 2].max() < 0.0
    assert s1.min() > 0.0 and s1.max() < 0.005


def test_the_views_show_the_plate_where_the_truth_puts_it():
    """The scene's depth gives the parallax asked for; the imposed
    displacement is the motion's; and a target's views show, at the true
    matches of view-1 points, the texture view 1 of the reference shows
    there (bicubic samples of the 8-bit views, within their rounding and
    the cubic's error)."""
    shape = [224, 352]
    seq = gen.make_sequence(shape, _mix(), 2 ** 31 + 5, "cpu")
    sc = seq.scene
    h, w = gen.SENSOR
    centre = sc.cams[1].project(sc.x0[None])[0]
    assert abs(float(centre[0]) - w / 2.0 - (-30.0)) < 1e-6
    pts = np.stack(np.meshgrid(np.arange(80.0, 300.0, 7.0),
                               np.arange(100.0, 190.0, 7.0)), -1)
    pts = pts.reshape(-1, 2)
    truth = seq.truth(1, pts)
    want = seq.translations[1] + seq.strains[1] * (truth["ref3d"]
                                                   - seq.center)
    np.testing.assert_allclose(truth["disp"], want, rtol=0, atol=1e-12)

    def at(img, p):
        from scipy.ndimage import map_coordinates
        return map_coordinates(img.astype(np.float64), [p[:, 1], p[:, 0]],
                               order=3)

    ref1 = at(seq.reference[0], pts)
    for view, key in ((seq.reference[1], "r2"), (seq.targets[1][0], "t1"),
                      (seq.targets[1][1], "t2")):
        gap = np.abs(at(view, truth[key]) - ref1)
        assert np.median(gap) < 3.0, (key, np.median(gap))


@pytest.mark.parametrize("fault", [None, "unrefined"])
def test_the_tiny_cell_is_correct_and_not_without_the_cross_refiner(
        tiny, monkeypatch, fault):
    if fault:
        # the cross match keeps its guess: ICGN2D2 ref1 -> tar2 skipped
        compute = ot.ICGN2D2.compute
        calls = []

        def skip_second(self, table, *a, **kw):
            calls.append(1)
            return table if len(calls) % 2 == 0 else compute(self, table,
                                                              *a, **kw)

        monkeypatch.setattr(ot.ICGN2D2, "compute", skip_second)
    result, checks = run_cell(Spec(tiny), CELL, 2 ** 31 + 5, 0.3, False,
                              "cpu", time.perf_counter())
    assert result["correct"] is (fault is None), checks
    assert set(result["metrics"]) == {"pairs_per_s", "setup_s"}


def test_the_control_breaks_a_limit(tiny):
    spec = Spec(tiny)
    c = spec.cell(CELL)
    cfg = spec.config(c["config"])
    pipe = spec.pipeline(cfg["pipeline"])
    mix = spec.traffic(c["traffic"])
    seq = spec.generator(mix["generator"]).make_sequence(
        cfg["frame_shape"], mix, 2 ** 31 + 7, "cpu")
    limits = cfg["check"]["limits"]
    ref = pipe.reference(cfg, seq.reference, seq.targets[0], "cpu")
    got = check.compare(pipe.LAYOUT, pipe.control(
        cfg, seq.reference, seq.targets[0], "cpu"), ref)
    assert any(got[k] > lim for k, lim in limits.items()), got
    same = check.compare(pipe.LAYOUT, pipe.as_table(ref), ref)
    assert all(v == 0 for v in same.values()), same


def _run(spans, traced=True, shapes=None):
    return Run(cell={"name": CELL}, config={}, setup_s=1.0,
               window_start=0.0, pair_ends=[1.0, 2.0],
               latencies_s=[1.0, 1.0], spans=spans,
               trace=types.SimpleNamespace(
                   seconds_of=lambda k: 2e-3 if k == "bicubic_eval_kernel"
                   else 0.0) if traced else None,
               launch_shapes=shapes or {})


@pytest.mark.parametrize("name, span", [
    ("epipolar.ms_per_pair", "epipolar"),
    ("icgn2d2.ms_per_pair", "icgn2d2")])
def test_each_span_reader_reads_its_spans_a_pair_or_none(name, span):
    reader = Spec(ROOT).reader(name)
    # two spans a pair over the window's two pairs
    assert reader.read(_run({span: [0.5, 0.7, 0.5, 0.7], "pair": [3.0]})) \
        == pytest.approx(1200.0)
    assert reader.read(_run({"pair": [3.0]})) is None


def test_the_iteration_reader_reads_its_counters_or_none(monkeypatch):
    reader = Spec(ROOT).reader("epipolar.iterations_per_pair")
    monkeypatch.setattr(timing, "counts", lambda: {
        "epipolar.iter_full": 54, "epipolar.iter_compact": 3,
        "icgn.iter_full": 7})
    # the warm-up pair and the window's two
    assert reader.read(_run({})) == pytest.approx(19.0)
    assert reader.read(_run({}, traced=False)) is None
    monkeypatch.setattr(timing, "counts", lambda: {"icgn.iter_full": 7})
    assert reader.read(_run({})) is None
    monkeypatch.delattr(timing, "counts")
    assert reader.read(_run({})) is None


def test_the_roofline_reader_counts_13_bytes_a_sample():
    reader = Spec(ROOT).reader("lut2d_roofline")
    n = 16_379 * 41 * 41  # a chunk of the search
    want = 100.0 * 3 * (13 * n / 3.35e12) / 2e-3
    got = reader.read(_run({}, shapes={"bicubic2d": {(n,): 3}}))
    assert got == pytest.approx(want)
    assert reader.read(_run({}, shapes={})) is None
    assert reader.read(_run({}, traced=False,
                            shapes={"bicubic2d": {(n,): 3}})) is None
