"""The self-adaptive cell (``dic2d_self_adaptive.seq``) on the CPU: its
configuration, mix, pipeline and metrics load through ``core/spec``; its
plain reference imports nothing of the program; a traced pair opens the
port's new spans nested as stated and counts its new counters; the cell
at a tiny size is correct, and not with the refiner skipped; and each new
reader reads its span or counter, or gives None."""

import collections
import json
import subprocess
import sys
import time
import types

import pytest
import torch

from conftest import BENCH, ROOT, make_checkout
from core.cell import Run, Spans, run_cell
from core.spec import Spec

import opencorr_tpu_torch as ot
from opencorr_tpu_torch.ops import sift2d as sift_ops
from opencorr_tpu_torch.utils import timing

CELL = "dic2d_self_adaptive.seq"
NEW = ("sift2d.ms_per_pair", "feature_affine.ms_per_pair",
       "icgn.adaptive_ms_per_pair", "icgn.adaptive_iterations_per_pair")
# the configuration at a size the CPU runs in seconds: 390 POIs
TINY = dict(frame_shape=[80, 448],
            poi_grid={"upper_left": [30, 30], "number_x": 78,
                      "number_y": 5, "step": 5})


@pytest.fixture
def tiny(tmp_path):
    root = make_checkout(tmp_path)
    path = root / "benchmark" / "configs" / "dic2d_self_adaptive.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), **TINY)))
    return root


def test_the_cell_loads_through_the_spec():
    spec = Spec(ROOT)
    cell = spec.cell(CELL)
    assert cell["chips"] == 1
    cfg = spec.config(cell["config"])
    assert cfg["pipeline"] == "dic2d_self_adaptive"
    assert cfg["frame_shape"] == [501, 3751] and cfg["reduced"] == ["images"]
    g = cfg["poi_grid"]
    assert g["number_x"] * g["number_y"] == 38400
    mix = spec.traffic(cell["traffic"])
    assert spec.generator(mix["generator"]).make_sequence
    assert spec.loop(mix["loop"]).run
    pipe = spec.pipeline(cfg["pipeline"])
    assert pipe.KERNELS == () and pipe.COUNTED == {}
    assert set(cfg["check"]["limits"]) <= {
        "seed_mismatch", "code_mismatch", "disp_gap", "disp_gap_mean",
        "grad_gap", "zncc_gap", "strain_gap"}
    assert [m["name"] for m in spec.metrics(CELL, False)] == [
        "pairs_per_s", "setup_s"]
    traced = [m["name"] for m in spec.metrics(CELL, True)]
    assert traced == ["device_idle_share", *NEW]
    for name in traced:
        assert spec.reader(name).read


def test_the_reference_imports_nothing_of_the_program():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(BENCH)!r}]\n"
        "import reference.self_adaptive, reference.sift2d\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'opencorr_tpu_torch', 'opencorr_tpu', 'jax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=BENCH)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def _traced(fn):
    """The ``oc:`` ranges of one call under the profiler: {name: count}
    and {name: set of parent names} (the innermost enclosing ``oc:``
    range, or None)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    ranges = sorted(
        ((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
          ev.name()[len(timing.PREFIX):])
         for ev in prof.profiler.kineto_results.events()
         if ev.name().startswith(timing.PREFIX)),
        key=lambda r: (r[0], -r[1]))
    names = collections.Counter(name for _, _, name in ranges)
    parents = collections.defaultdict(set)
    stack = []
    for s, e, name in ranges:
        while stack and stack[-1][1] < e:
            stack.pop()
        parents[name].add(stack[-1][2] if stack else None)
        stack.append((s, e, name))
    return names, parents


# each new span's parent, and the refiner's and Strain's on this path
NEST = {
    "sift2d.compute": {None}, "sift2d.detect": {"sift2d.compute"},
    "sift2d.sync.candidates": {"sift2d.detect"},
    "sift2d.sync.keypoints": {"sift2d.detect"},
    "sift2d.sync.instances": {"sift2d.detect"},
    "sift2d.sync.ori_radius": {"sift2d.detect"},
    "sift2d.sync.desc_radius": {"sift2d.detect"},
    "sift2d.match": {"sift2d.compute"},
    "sift2d.sync.keep": {"sift2d.compute"},
    "sift2d.sync.idx": {"sift2d.compute"},
    "sift2d.sync.ref_xy": {"sift2d.compute"},
    "sift2d.sync.tar_xy": {"sift2d.compute"},
    "feature_affine.compute": {None},
    "feature_affine.adapt": {"feature_affine.compute"},
    "feature_affine.ransac": {"feature_affine.compute"},
    "feature_affine.sync.codes": {"feature_affine.compute"},
    "icgn.upload": {None}, "icgn.prepare": {None},
    "icgn.gradient": {"icgn.prepare"}, "icgn.prefilter": {"icgn.prepare"},
    "icgn.compute": {None}, "icgn.sync.radius": {"icgn.compute"},
    "icgn.sync.active": {"icgn.compute"}, "icgn.iter": {"icgn.compute"},
    "icgn.lut_eval": {"icgn.iter"},
    "strain.compute": {None}, "strain.neighbors": {"strain.compute"},
    "strain.fit": {"strain.compute"},
}


def test_a_traced_pair_opens_the_new_spans_nested_and_counts(tiny,
                                                             monkeypatch):
    spec = Spec(tiny)
    c = spec.cell(CELL)
    cfg = spec.config(c["config"])
    mix = spec.traffic(c["traffic"])
    seq = spec.generator(mix["generator"]).make_sequence(
        cfg["frame_shape"], mix, 2 ** 31 + 3, "cpu")
    pipeline = spec.pipeline(cfg["pipeline"]).Pipeline(cfg, "cpu")
    pipeline.setup(seq.reference)
    # caps below this pair's counts, so that they are passed
    caps = sift_ops.octave_caps
    monkeypatch.setattr(sift_ops, "octave_caps",
                        lambda hh, ww, n: (min(caps(hh, ww, n)[0], 600), 512))
    sifts = []
    compute = ot.SIFT2D.compute
    monkeypatch.setattr(ot.SIFT2D, "compute",
                        lambda self: (sifts.append(self), compute(self)))
    before = timing.counts()
    names, parents = _traced(lambda: pipeline.pair(seq.targets[1], Spans()))
    got = timing.counts()
    got.subtract(before)
    got = +got
    assert set(NEST) <= set(names), set(NEST) - set(names)
    for name, where in NEST.items():
        assert parents[name] <= where, (name, parents[name])
    assert set(names) <= set(NEST), \
        set(names) - set(NEST)
    assert names["sift2d.detect"] == 2 and names["sift2d.match"] == 1
    assert names["icgn.lut_eval"] == names["icgn.iter"] >= 1
    # the counters: the modules' ``stats`` under their layers
    mine = {k: n for k, n in got.items() if ".sync." not in k}
    assert mine == {k: n for k, n in pipeline.stats.items() if n}
    assert got["icgn.iter_adaptive"] == names["icgn.iter"]
    assert "icgn.iter_full" not in got
    assert got["feature_affine.sync.codes"] == 1
    # SIFT2D's counters from its octave counts: the caps passed, the
    # instances it matched from (all of them) and the matches
    (sift,) = sifts
    octaves = sift.octave_stats
    assert got["sift2d.cap_hits"] == sum(
        (o["candidates"] > o["k_raw"]) + (o["keypoints"] > o["k_kp"])
        + (o["instances"] > o["k_kp"]) for o in octaves) >= 2
    assert got["sift2d.keypoints"] == sum(o["instances"] for o in octaves)
    assert got["sift2d.matches"] == len(sift.ref_matched_kp) > 100


@pytest.mark.parametrize("fault", [None, "unchanged"])
def test_the_tiny_cell_is_correct_and_not_without_the_refiner(
        tiny, monkeypatch, fault):
    if fault:
        monkeypatch.setattr(ot.ICGN2D1, "compute",
                            lambda self, table, *a, **kw: table)
    result, checks = run_cell(Spec(tiny), CELL, 2 ** 31 + 5, 0.3, False,
                              "cpu", time.perf_counter())
    assert result["correct"] is (fault is None), checks
    assert set(result["metrics"]) == {"pairs_per_s", "setup_s"}


def test_the_reference_laid_out_as_the_table_compares_to_itself(tiny):
    import calibrate
    from core import check

    spec = Spec(tiny)
    c = spec.cell(CELL)
    cfg = spec.config(c["config"])
    pipe = spec.pipeline(cfg["pipeline"])
    mix = spec.traffic(c["traffic"])
    seq = spec.generator(mix["generator"]).make_sequence(
        cfg["frame_shape"], mix, 3, "cpu")
    ref = pipe.reference(cfg, seq.reference, seq.targets[0], "cpu")
    got = check.compare(pipe.LAYOUT, calibrate.as_table(pipe.LAYOUT, ref),
                        ref)
    assert all(v == 0 for v in got.values()), got


def _run(spans, traced=True):
    return Run(cell={"name": CELL}, config={}, setup_s=1.0,
               window_start=0.0, pair_ends=[1.0, 2.0],
               latencies_s=[1.0, 1.0], spans=spans,
               trace=types.SimpleNamespace() if traced else None,
               launch_shapes={})


@pytest.mark.parametrize("name, span", [
    ("sift2d.ms_per_pair", "sift2d"),
    ("feature_affine.ms_per_pair", "feature_affine"),
    ("icgn.adaptive_ms_per_pair", "icgn.adaptive")])
def test_each_span_reader_reads_its_span_or_none(name, span):
    reader = Spec(ROOT).reader(name)
    assert reader.read(_run({span: [0.5, 0.7], "pair": [3.0]})) == \
        pytest.approx(600.0)
    assert reader.read(_run({"pair": [3.0]})) is None


def test_the_iteration_reader_reads_its_counter_or_none(monkeypatch):
    reader = Spec(ROOT).reader("icgn.adaptive_iterations_per_pair")
    monkeypatch.setattr(timing, "counts", lambda: {
        "icgn.iter_adaptive": 54, "icgn.iter_full": 7})
    # the warm-up pair and the window's two
    assert reader.read(_run({})) == pytest.approx(18.0)
    assert reader.read(_run({}, traced=False)) is None
    monkeypatch.setattr(timing, "counts", lambda: {"icgn.iter_full": 7})
    assert reader.read(_run({})) is None
    monkeypatch.delattr(timing, "counts")
    assert reader.read(_run({})) is None
