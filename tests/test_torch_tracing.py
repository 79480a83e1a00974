"""The port's spans, counters and host reads (``utils/timing``) on the CPU:
a span costs no profiler range while no profiler records; under
``torch.profiler`` a 2D pair (FFTCC2D -> refiner -> Strain) and a DVC pair
(FFTCC3D -> ICGN3D1 -> Strain) open the named ``oc:`` ranges, nested as
the modules call each other; the process counters take each compute's
``stats`` under the module's layer; and every read of a device value by
the port's files goes through ``timing.host_read``."""

import collections
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, shift

import opencorr_tpu_torch as ot
from opencorr_tpu_torch.utils import timing

torch.set_num_threads(1)

CPU = "cpu"
PKG = str(Path(ot.__file__).resolve().parent)
TIMING = str(Path(timing.__file__).resolve())


def _speckle(shape, seed):
    rng = np.random.default_rng(seed)
    img = gaussian_filter(rng.standard_normal(shape), 1.5)
    return img / img.std() * 25.0 + 128.0


def _frames(shape, move, seed=3):
    ref = _speckle(shape, seed)
    tar = shift(ref, move, order=3, mode="nearest")
    return (np.clip(np.round(ref), 0, 255).astype(np.uint8),
            np.clip(np.round(tar), 0, 255).astype(np.uint8))


def pair_2d(refiner=ot.ICGN2D1, side=64, adaptive=False):
    """FFTCC2D -> refiner -> Strain on side^2 POIs of a 100 x 100 pair: 64
    gives 4,096, wide enough for ICGN2D1's compacted phase.  ``adaptive``:
    self-adaptive subsets of radii 5 to 8 drawn per POI."""
    ref, tar = (ot.Image2D.from_array(a) for a in
                _frames((100, 100), (0.6, -1.3)))
    pois = ot.poi_grid_2d((18, 18), side, side, 64 // side, device=CPU)
    fftcc = ot.FFTCC2D(8, 8, device=CPU)
    fftcc.set_images(ref, tar)
    pois = fftcc.compute(pois)
    ic = refiner(8, 8, 0.001, 10, device=CPU)
    if adaptive:
        radii = np.random.default_rng(7).integers(5, 9, (pois.n, 2))
        pois = pois.replace(sr=torch.from_numpy(radii.astype(np.float32)))
        ic.set_self_adaptive(True)
    ic.set_images(ref, tar)
    ic.prepare()
    pois = ic.compute(pois)
    strain = ot.Strain(5, 5, device=CPU)
    strain.prepare(pois)
    return strain.compute(pois), {"fftcc": fftcc, ic.layer: ic}


def pair_3d():
    """FFTCC3D -> ICGN3D1 in three chunks -> Strain on 36 POIs of a
    48 x 36 x 32 pair; the chunks leave the table without its host
    coordinates, so Strain reads them back."""
    ref, tar = (ot.Image3D.from_array(a) for a in
                _frames((48, 36, 32), (0.7, -0.4, 0.3), seed=5))
    pois = ot.poi_grid_3d((12, 12, 12), 2, 3, 6, 4, device=CPU)
    fftcc = ot.FFTCC3D(6, 6, 6, device=CPU)
    fftcc.set_images(ref, tar)
    pois = fftcc.compute(pois)
    ic = ot.ICGN3D1(6, 6, 6, 0.001, 10, chunk_size=16, device=CPU)
    ic.set_images(ref, tar)
    ic.prepare()
    pois = ic.compute(pois)
    return ot.Strain(9, 10, device=CPU).compute(pois), \
        {"fftcc": fftcc, "icgn": ic}


PAIRS = {"icgn2d1": pair_2d, "dvc": pair_3d,
         "icgn2d1_small": lambda: pair_2d(side=16),
         "icgn2d1_adaptive": lambda: pair_2d(adaptive=True),
         "iclm2d1": lambda: pair_2d(ot.ICLM2D1),
         "nr2d1": lambda: pair_2d(ot.NR2D1)}
# the refiner's loops in each pair: ICGN2D1's two phases on 4,096 POIs, one
# loop a compute on fewer and in the other 2D refiners, one a chunk in
# ICGN3D1
LOOPS = {"icgn2d1": 2, "dvc": 3, "icgn2d1_small": 1, "icgn2d1_adaptive": 1,
         "iclm2d1": 1, "nr2d1": 1}


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


def test_a_span_opens_no_range_while_no_profiler_records(monkeypatch):
    opened = []

    def record(name):
        opened.append(name)
        return timing._OFF

    monkeypatch.setattr(torch.profiler, "record_function", record)
    assert not torch.autograd._profiler_enabled()
    assert timing.span("icgn.iter") is timing._OFF
    pair_2d()
    assert opened == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with timing.span("icgn.iter"):
            pass
    assert opened == ["oc:icgn.iter"]


# each span's parent: the span around it on the host thread (None: no
# program span)
NEST_2D = {
    "fftcc.upload": {None}, "fftcc.compute": {None},
    "fftcc.correlate": {"fftcc.compute"},
    "fftcc.sync.need": {"fftcc.compute"},
    "icgn.upload": {None}, "icgn.prepare": {None},
    "icgn.gradient": {"icgn.prepare"}, "icgn.prefilter": {"icgn.prepare"},
    "icgn.compute": {None}, "icgn.setup": {"icgn.compute"},
    "icgn.sync.active": {"icgn.compute"}, "icgn.iter": {"icgn.compute"},
    "icgn.eval": {"icgn.iter"}, "icgn.sync.wobble": {"icgn.eval"},
    "icgn.compact": {"icgn.compute"}, "icgn.finish": {"icgn.compute"},
    "strain.neighbors": {None}, "strain.compute": {None},
    "strain.fit": {"strain.compute"},
}
NEST_3D = {
    "fftcc.upload": {None}, "fftcc.compute": {None},
    "fftcc.correlate": {"fftcc.compute"},
    "fftcc.sync.integral": {"fftcc.compute"},
    "fftcc.rerank": {"fftcc.compute"},
    "icgn.upload": {None}, "icgn.prepare": {None},
    "icgn.gradient": {"icgn.prepare"}, "icgn.prefilter": {"icgn.prepare"},
    "icgn.compute": {None}, "icgn.chunk": {"icgn.compute"},
    "icgn.setup": {"icgn.chunk"}, "icgn.sync.active": {"icgn.chunk"},
    "icgn.iter": {"icgn.chunk"}, "icgn.eval": {"icgn.iter"},
    "icgn.sync.wobble": {"icgn.eval"}, "icgn.finish": {"icgn.chunk"},
    "strain.compute": {None}, "strain.neighbors": {"strain.compute"},
    "poi.sync.coords": {"strain.neighbors"},
    "strain.fit": {"strain.compute"},
}
# spans that open only on some branches, and where they nest when they do
BRANCHES = {"fftcc.rerank": {"fftcc.compute"},
            "icgn.correct": {"icgn.eval"},
            "icgn.exact": {"icgn.eval", "icgn.correct"},
            "icgn.sync.still": {"icgn.correct"}}


@pytest.mark.parametrize("pair, nest", [("icgn2d1", NEST_2D),
                                        ("dvc", NEST_3D)])
def test_a_traced_pair_opens_the_named_spans_nested(pair, nest):
    names, parents = _traced(PAIRS[pair])
    assert set(nest) <= set(names), set(nest) - set(names)
    for name, where in {**BRANCHES, **nest}.items():
        if name in names:
            assert parents[name] == where, (name, parents[name])
    assert set(names) <= set(nest) | set(BRANCHES)
    if pair == "dvc":
        assert names["icgn.chunk"] == 3
        assert names["icgn.iter"] == names["icgn.sync.active"] - 3


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_the_counters_take_each_compute_under_its_layer(pair):
    before = timing.counts()
    _, modules = PAIRS[pair]()
    got = timing.counts()
    got.subtract(before)
    got = +got
    for layer, module in modules.items():
        mine = {k: n for k, n in got.items() if k.startswith(layer + ".")
                and ".sync." not in k and k != "fftcc.calls"}
        assert mine == {f"{layer}.{k}": n for k, n in module.stats.items()
                        if n}, layer
    assert got["fftcc.calls"] == 1
    refiner = list(modules)[-1]
    iters = sum(n for k, n in got.items() if k.split(".", 1)[1]
                in ("iter_full", "iter_compact", "iter_adaptive", "iter"))
    # one read of the active count an iteration, and one more that ends
    # each loop
    assert iters > 0
    assert got[f"{refiner}.sync.active"] == iters + LOOPS[pair]


# the Tensor methods that read a device value to the host
READS = ("__bool__", "__int__", "__float__", "__index__", "__array__",
         "item", "tolist", "cpu", "numpy")


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_every_host_read_of_the_port_goes_through_host_read(monkeypatch,
                                                           pair):
    stray = collections.Counter()
    inside = collections.Counter()

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
                where = (f"{Path(frame.f_code.co_filename).name}:"
                         f"{frame.f_lineno} {method}")
                (inside if via is not None else stray)[where] += 1
            return original(self, *args, **kwargs)

        return read

    for method in READS:
        monkeypatch.setattr(torch.Tensor, method, wrap(method))
    before = timing.counts()
    PAIRS[pair]()
    got = timing.counts()
    got.subtract(before)
    assert not stray, stray
    # host_read itself made every read
    assert {where.split(":")[0] for where in inside} == {"timing.py"}
    assert sum(n for k, n in got.items() if ".sync." in k) >= 2
