"""The port's stereo 3D-DIC program against the benchmark's plain
reference on the CPU: EpipolarSearch -> ICGN2D2, SIFT2D ->
FeatureAffine2D -> ICGN2D1, the cross match through the search tar1 ->
tar2 and ICGN2D2, and the triangulation of both pairs, chained by the
benchmark's pipeline (``benchmark/pipelines/stereo_epipolar_sift.py``) in
float32, against ``benchmark/reference/stereo.py`` in float64, on a
224 x 352 window of the cell's scene (the generator's plate through the
GT4 cameras, their principal points moved to the window's corner) with
200 POIs and two seeded targets.  Also: a traced pair opens the search's,
the triangulation's and the undistortion maps' spans, nested as stated,
and counts the search's counters; every read of a device value on the
path goes through ``timing.host_read``.

Tolerances, each from the float32 arithmetic of one side:

* the searches' winners: differ at most at 3% of the POIs (the coarse
  IC-GN of two neighbouring candidates converges to one optimum, their
  ZNCCs within rounding, and either may come first: 1.5% and 1.0%
  measured);
* codes: equal;
* matched positions within 1e-4 px (float32 LUT samples against float64
  B-spline sums over at most 10 steps: 1.1e-5 measured);
* ZNCC within 1e-6 (3.3e-8 measured);
* the 3D displacement within 1e-3 mm, 1e-4 on average (the port solves
  the triangulation's normal equations in float32, whose condition
  squares the 4 x 3 system's: 2.7e-4 and 2.5e-5 measured, as large as
  the reference's own float32 run).

The lower-precision case, the reference in float32 with every sample
rounded to float16 (the benchmark's control), breaks the position and
ZNCC tolerances (4.7e-4 px and 2.5e-6 measured).
"""

import collections
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import opencorr_tpu_torch as ot
from opencorr_tpu_torch.utils import timing

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from core import check  # noqa: E402
from core.cell import Spans  # noqa: E402
from core.spec import Spec  # noqa: E402

torch.set_num_threads(1)

ORIGIN = [760, 400]  # the window's top-left sensor pixel (x, y)
SHAPE = [224, 352]
GRID = {"upper_left": [60, 90], "number_x": 20, "number_y": 10, "step": 10}
SEED = 2 ** 31 + 11
TARGETS = (0, 1)
TOL = dict(winners=0.03, position=1e-4, zncc=1e-6, disp=1e-3,
           disp_mean=1e-4)


@pytest.fixture(scope="module")
def cell():
    spec = Spec(BENCH.parent)
    c = spec.cell("stereo_epipolar_sift.seq")
    cfg = dict(spec.config(c["config"]), frame_shape=SHAPE, poi_grid=GRID,
               sensor_origin=ORIGIN)
    mix = dict(spec.traffic(c["traffic"]), targets=len(TARGETS),
               origin=ORIGIN)
    seq = spec.generator(mix["generator"]).make_sequence(SHAPE, mix, SEED,
                                                         "cpu")
    return spec.pipeline(cfg["pipeline"]), cfg, seq


# the Tensor methods that read a device value to the host
READS = ("__bool__", "__int__", "__float__", "__index__", "__array__",
         "item", "tolist", "cpu", "numpy")
PKG = str(Path(ot.__file__).resolve().parent)
TIMING = str(Path(timing.__file__).resolve())


def _reads_outside_host_read(stray: collections.Counter):
    """Tensor methods that count, in ``stray``, each read of a device
    value made in the port's files outside ``timing.host_read``."""
    def wrap(method):
        original = getattr(torch.Tensor, method)

        def read(self, *args, **kwargs):
            frame = sys._getframe(1)
            if frame.f_code.co_filename.startswith(PKG):
                via = frame
                while via is not None and not (
                        via.f_code.co_filename == TIMING
                        and via.f_code.co_name == "host_read"):
                    via = via.f_back
                if via is None:
                    stray[f"{Path(frame.f_code.co_filename).name}:"
                          f"{frame.f_lineno} {method}"] += 1
            return original(self, *args, **kwargs)

        return read

    return {method: wrap(method) for method in READS}


def _ranges(prof):
    """The ``oc:`` ranges of a profile: {name: count} and {name: set of
    parent names} (the innermost enclosing ``oc:`` range, or None)."""
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


@pytest.fixture(scope="module")
def results(cell):
    """Per target: the program's table and the reference's result; for
    the first target also the traced pair's ranges, the program's reads
    outside ``host_read`` and its counters; and the control's table."""
    pipe, cfg, seq = cell
    program = pipe.Pipeline(cfg, "cpu")
    program.setup(seq.reference)
    out = {}
    for k in TARGETS:
        if k == TARGETS[0]:
            stray = collections.Counter()
            with pytest.MonkeyPatch.context() as mp:
                for method, read in _reads_outside_host_read(stray).items():
                    mp.setattr(torch.Tensor, method, read)
                before = timing.counts()
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU]) as prof:
                    table = program.pair(seq.targets[k], Spans())
                counts = timing.counts()
            counts.subtract(before)
            out["traced"] = (*_ranges(prof), stray, +counts,
                             dict(program.stats))
        else:
            table = program.pair(seq.targets[k], Spans())
        out[k] = (table, pipe.reference(cfg, seq.reference, seq.targets[k],
                                        "cpu"))
    out["control"] = pipe.control(cfg, seq.reference,
                                  seq.targets[TARGETS[0]], "cpu")
    return out


def _gaps(table, ref):
    """The comparison's numbers of a table against the reference, and the
    per-match gaps where every match succeeded on both sides."""
    pipe_codes = table["r"][:, 8:11]
    ok = (pipe_codes >= 0).all(1) & (ref["codes"] >= 0).all(1)
    return dict(
        winners=float((table["r"][:, 3:7] != ref["seed"]).any(1).mean()),
        codes=np.array_equal(np.where(pipe_codes < 0, pipe_codes, 1),
                             np.where(ref["codes"] < 0, ref["codes"], 1)),
        position=float(np.abs(table["p"][ok][:, :, 3:]
                              - ref["p"][ok][:, :, 3:]).max()),
        zncc=float(np.abs(pipe_codes[ok] - ref["codes"][ok]).max()),
        disp=float(np.abs(table["p"][ok][:, 0, :3]
                          - ref["p"][ok][:, 0, :3]).max()),
        disp_mean=float(np.abs(table["p"][ok][:, 0, :3]
                               - ref["p"][ok][:, 0, :3]).mean()),
        ok=float(ok.mean()))


@pytest.mark.parametrize("k", TARGETS)
def test_search_winners_and_codes_agree(results, k):
    got = _gaps(*results[k])
    assert got["winners"] <= TOL["winners"], got
    assert got["codes"], got
    assert got["ok"] > 0.95, got


@pytest.mark.parametrize("k", TARGETS)
def test_matched_positions_and_zncc_within_float32(results, k):
    got = _gaps(*results[k])
    assert got["position"] <= TOL["position"], got
    assert got["zncc"] <= TOL["zncc"], got


@pytest.mark.parametrize("k", TARGETS)
def test_3d_displacement_within_float32(results, k):
    got = _gaps(*results[k])
    assert got["disp"] <= TOL["disp"], got
    assert got["disp_mean"] <= TOL["disp_mean"], got


@pytest.mark.parametrize("k", TARGETS)
def test_the_pair_recovers_the_scene(cell, results, k):
    """Against the rendered truth: positions within 0.02 px on average,
    the 3D displacement within 0.01 mm on average."""
    pipe, cfg, seq = cell
    table, ref = results[k]
    truth = seq.truth(k, pipe.plain.grid_points(cfg))
    ok = (table["r"][:, 8:11] > 0.9).all(1)
    assert ok.mean() > 0.95
    for slot, name in enumerate(("r2", "t1", "t2")):
        err = np.abs(table["p"][ok][:, slot, 3:] - truth[name][ok]).mean()
        assert err < 0.02, (name, err)
    err = np.linalg.norm(table["p"][ok][:, 0, :3] - truth["disp"][ok], axis=1)
    assert err.mean() < 0.01


def test_the_control_breaks_a_tolerance(results):
    got = _gaps(results["control"], results[TARGETS[0]][1])
    assert got["position"] > TOL["position"] or got["zncc"] > TOL["zncc"], \
        got


def test_the_reference_laid_out_as_the_table_compares_to_itself(cell,
                                                                 results):
    pipe = cell[0]
    ref = results[TARGETS[0]][1]
    got = check.compare(pipe.LAYOUT, pipe.as_table(ref), ref)
    assert all(v == 0 for v in got.values()), got


# each span's parent on the search's, the triangulation's and the maps'
# paths
NEST = {
    "epipolar.upload": {None},
    "epipolar.prepare": {None},
    "epipolar.gradient": {"epipolar.prepare"},
    "epipolar.prefilter": {"epipolar.prepare"},
    "epipolar.compute": {None},
    "epipolar.setup": {"epipolar.compute"},
    "epipolar.sync.active": {"epipolar.compute"},
    "epipolar.iter": {"epipolar.compute"},
    "epipolar.eval": {"epipolar.iter"},
    "epipolar.finish": {"epipolar.compute"},
    "epipolar.sync.candidates_out": {"epipolar.compute"},
    "epipolar.sync.points": {None},
    "calibration.prepare": {None},
    "stereovision.reconstruct": {None},
}


def test_a_traced_pair_opens_the_stereo_spans_nested(results):
    names, parents = results["traced"][:2]
    assert set(NEST) <= set(names), set(NEST) - set(names)
    for name, where in NEST.items():
        assert parents[name] <= where, (name, parents[name])
    assert names["epipolar.compute"] == 2
    assert names["calibration.prepare"] == 2
    assert names["stereovision.reconstruct"] == 2
    assert names["epipolar.eval"] == names["epipolar.iter"] >= 2
    # the search's IC-GN lands under its own layer, the refiners' under
    # icgn: ICGN2D2 twice, ICGN2D1 once
    assert names["icgn.compute"] == 3


def test_a_traced_pair_counts_the_search(results, cell):
    names, _, _, counts, stats = results["traced"]
    n = GRID["number_x"] * GRID["number_y"]
    # one chunk a search (200 POIs < 1,489), 11 candidates a POI
    assert counts["epipolar.candidates"] == 2 * n * 11
    assert counts["epipolar.candidates_out"] == stats.get(
        "epipolar.candidates_out", 0)
    assert counts["epipolar.iter_full"] == names["epipolar.iter"]
    assert "epipolar.padded" not in counts
    assert counts["epipolar.sync.points"] == 1
    mine = {k: v for k, v in counts.items() if ".sync." not in k}
    assert mine == {k: v for k, v in stats.items() if v}


def test_every_host_read_of_the_path_goes_through_host_read(results):
    stray, counts = results["traced"][2:4]
    assert not stray, stray
    sites = {k for k in counts if ".sync." in k}
    assert {"epipolar.sync.active", "epipolar.sync.candidates_out",
            "epipolar.sync.points", "sift2d.sync.keep",
            "feature_affine.sync.codes", "icgn.sync.active"} <= sites, sites


@pytest.mark.parametrize("pois, padded", [(300, 212), (200, 0)])
def test_the_search_counts_its_padding(cell, pois, padded):
    """A queue over one chunk (256 POIs at this chunk size) is padded to
    whole chunks with replicas of its last POI; the padding is counted,
    and the candidates with it.  A coarse IC-GN of r = 5 and 2 steps keeps
    it quick: the counters do not depend on either."""
    pipe, cfg, seq = cell
    cams = pipe.calibrations(cfg, "cpu")
    epi = ot.EpipolarSearch(*cams, chunk_size=256 * 11, device="cpu")
    epi.set_parallax((-30.0, -40.0))
    epi.set_search(30, 5)
    epi.create_icgn(5, 5, 0.05, 2)
    epi.set_images(*seq.reference)
    epi.prepare()
    pts = pipe.plain.grid_points(dict(cfg, poi_grid=dict(
        GRID, number_x=30, number_y=10)))[:pois].astype(np.float32)
    before = timing.counts()
    out = epi.compute(ot.new_table_2d(pts[:, 0], pts[:, 1], device="cpu"))
    got = timing.counts()
    got.subtract(before)
    assert out.n == pois
    assert got["epipolar.padded"] == padded
    assert got["epipolar.candidates"] == (pois + padded) * 11
    assert got["epipolar.sync.candidates_out"] == 1
