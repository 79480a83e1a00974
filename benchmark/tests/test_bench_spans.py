"""``core/spans.split`` on a hand-made kineto-like event list, and the
readers of the program's counters: the idle time splits over the spans
open on the host and adds up to the window's, a gap that opens in a host
read and runs into the next span is split between them, the program's
ranges change nothing ``core/trace.reduce`` gives, and every new reader
returns None where its trace or counter is absent."""

import types

import pytest

from conftest import ROOT
from core import spans, trace
from core.cell import Run
from core.spec import Spec


class Ev:
    """The part of a ``torch.profiler`` kineto event that ``trace.reduce``
    and ``spans.split`` read."""

    def __init__(self, name, start, end, device=False, corr=0,
                 annotation=False):
        self._name, self._start, self._dur = name, start, end - start
        self._device, self._corr = device, corr
        self._annotation = annotation

    def name(self):
        return self._name

    def device_type(self):
        return "DeviceType.CUDA" if self._device else "DeviceType.CPU"

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._annotation


# host ranges (ns): the harness's and, inside them, the program's
BENCH = [("bench:window", 0, 1000), ("bench:pair", 0, 900),
         ("bench:fftcc", 100, 400), ("bench:icgn.compute", 400, 700)]
PROGRAM = [("oc:fftcc.compute", 110, 380), ("oc:fftcc.sync.need", 200, 260),
           ("oc:fftcc.rerank", 260, 350), ("oc:icgn.compute", 410, 690),
           ("oc:icgn.iter", 420, 600), ("oc:icgn.sync.active", 600, 650)]
# runtime calls (name, start, correlation id) and the device work they
# enqueued (name, start, end, correlation id); "stray" has no call
CALLS = [("cudaLaunchKernel", 120, 1), ("cudaLaunchKernel", 270, 2),
         ("cudaLaunchKernel", 430, 3), ("cuLaunchKernel", 440, 4),
         ("cudaMemcpyAsync", 610, 5), ("cudaStreamSynchronize", 615, 0),
         ("cudaLaunchKernel", 950, 6)]
DEVICE = [("gather_windows_kernel", 130, 230, 1), ("topk", 280, 330, 2),
          ("lattice2d_kernel", 460, 500, 3), ("mul", 500, 560, 4),
          ("Memcpy DtoH", 620, 630, 5), ("stray", 800, 810, 99),
          ("add", 960, 980, 6)]
# the idle ns each span holds, worked out by hand
IDLE = {"pair": 290, "fftcc": 30, "oc:fftcc.compute": 50,
        "oc:fftcc.sync.need": 30, "oc:fftcc.rerank": 40, "icgn.compute": 20,
        "oc:icgn.compute": 50, "oc:icgn.iter": 80, "oc:icgn.sync.active": 40,
        "window": 80}


def events(program=True):
    ranges = BENCH + (PROGRAM if program else [])
    evs = [Ev(n, s, e, annotation=True) for n, s, e in ranges]
    # the ranges' device-side mirrors
    evs += [Ev(n, s + 5, e + 5, device=True, annotation=True)
            for n, s, e in ranges]
    evs += [Ev(n, t, t + 4, corr=c) for n, t, c in CALLS]
    evs += [Ev(n, s, e, device=True, corr=c) for n, s, e, c in DEVICE]
    return evs


def reduced(program=True):
    return trace.reduce(types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(
            events=lambda: events(program)))))


def split(program=True):
    return spans.split(events(program))


def test_the_idle_time_splits_over_the_spans_and_adds_up():
    tr = split()
    idle = tr.window_s - tr.busy_s
    assert idle == pytest.approx(710e-9)
    assert sum(tr.idle_by_span.values()) == pytest.approx(idle)
    assert tr.idle_by_span == pytest.approx(
        {k: v / 1e9 for k, v in IDLE.items()})
    # the four parts ``span_split.py`` gives: FFTCC, the refiner, Strain,
    # outside the program
    parts = [tr.sum_by_span("idle_by_span", "oc:fftcc."),
             tr.sum_by_span("idle_by_span", "oc:icgn."),
             tr.sum_by_span("idle_by_span", "oc:strain.")]
    outside = sum(v for k, v in tr.idle_by_span.items()
                  if not k.startswith("oc:"))
    assert sum(parts) + outside == pytest.approx(idle)
    assert tr.launches_by_span == {
        "oc:fftcc.compute": 1, "oc:fftcc.rerank": 1, "oc:icgn.iter": 2,
        "oc:icgn.sync.active": 1, "window": 1}
    assert tr.kernel_s_by_span[("oc:icgn.iter", "lattice2d_kernel")] == \
        pytest.approx(40e-9)
    assert tr.kernel_s_by_span[("unmatched", "stray")] == \
        pytest.approx(10e-9)
    ops = tr.breakdown()["device_ops"]
    assert ops[0] == ["oc:fftcc.compute | gather_windows_kernel",
                      pytest.approx(100e-9)]


def test_a_gap_that_opens_in_a_host_read_is_split_with_the_next_span():
    tr = split()
    # the gap 230-280 opens under fftcc.sync.need (until 260) and runs
    # into fftcc.rerank; it is labelled by the larger part
    assert ("oc:fftcc.sync.need", pytest.approx(50e-9)) in [
        (label, pytest.approx(s)) for label, s in tr.gaps]
    assert tr.idle_by_span["oc:fftcc.sync.need"] == pytest.approx(30e-9)
    assert tr.gaps[0] == ("pair", pytest.approx(170e-9))
    assert ("oc:icgn.iter", pytest.approx(130e-9)) in tr.gaps


def _run(tr):
    return Run(cell={"name": "c"}, config={"frame_shape": [280, 900]},
               setup_s=1.0, window_start=0.0, pair_ends=[1.0, 2.0],
               latencies_s=[1.0, 1.0], spans={}, trace=tr,
               launch_shapes={"lattice2d": {(30000, 33, 33, 2): 2},
                              "gather2d": {(30000, 32, 32): 1}})


def test_the_program_ranges_change_no_existing_number():
    spec = Spec(ROOT)
    with_ranges, without = reduced(True), reduced(False)
    assert with_ranges == without
    # the split reckons the window and the device time as reduce does
    for tr in (split(True), split(False)):
        assert (tr.window_s, tr.busy_s) == (with_ranges.window_s,
                                            with_ranges.busy_s)
    assert not split(False).sum_by_span("idle_by_span", "oc:")
    old = [m["name"] for m in spec.data["per_layer"]
           if m["source"] != "program_counter"]
    assert "device_idle_share" in old and "lattice2d_roofline" in old
    for name in old:
        reader = spec.reader(name)
        assert reader.read(_run(with_ranges)) == \
            reader.read(_run(without)), name


COUNTERS = {"icgn.iter_full": 9, "icgn.iter_compact": 3,
            "fftcc.calls": 4, "fftcc.rerank_full": 1,
            "icgn.sync.active": 12, "fftcc.sync.need": 3, "icgn.full": 1}
# each reader's value on COUNTERS over a window of two pairs, with the
# warm-up pair three
WANT = {"icgn.iterations_per_pair": 4.0, "fftcc.rerank_full_share": 25.0,
        "host_syncs_per_pair": 5.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_new_reader_reads_its_counters_or_none(name, monkeypatch):
    from opencorr_tpu_torch.utils import timing

    reader = Spec(ROOT).reader(name)
    monkeypatch.setattr(timing, "counts", lambda: dict(COUNTERS))
    assert reader.read(_run(reduced())) == pytest.approx(WANT[name])
    # no trace (a run off the card or untraced), or a program without
    # counters, as the parent's
    assert reader.read(_run(None)) is None
    monkeypatch.setattr(timing, "counts", dict)
    assert reader.read(_run(reduced())) is None
    monkeypatch.delattr(timing, "counts")
    assert reader.read(_run(reduced())) is None


@pytest.mark.parametrize("cell", ["dic2d_fftcc_icgn1.seq",
                                  "dvc_fftcc_icgn1.seq"])
def test_span_split_runs_a_tiny_cell_on_the_cpu(checkout, cell):
    # the set-up of ``core/setup.py`` and the window of ``span_split.py``:
    # on the CPU no device work, so the whole window is idle, and its parts
    # (FFTCC, the refiner, Strain, outside the program) add up to it
    import torch

    import span_split

    out = span_split.split_cell(Spec(checkout), cell, 2 ** 31 + 7,
                                torch.device("cpu"), 0.2)
    assert out["pairs"] >= 1 and out["busy_s"] == 0
    parts = [out[f"{k}.idle_ms_per_pair"]
             for k in ("fftcc", "icgn", "strain", "outside")]
    assert all(p > 0 for p in parts)
    assert sum(parts) == pytest.approx(out["idle_ms_per_pair"], rel=1e-9)
    assert out["counters_per_pair"]["fftcc.calls"] == 1.0
