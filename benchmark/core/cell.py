"""One run of one cell: set-up, the timed window, the trace, the check.

Set-up builds the cell's kernels (or finds them built), makes the frames
from the seed with the generator the traffic mix names, and runs one
warm-up pair on the cell's shapes.  The window is the loop the mix names
(``benchmark/loops/<loop>.py``), new pairs starting until ``seconds``
have passed.  After it the program's state is freed and the plain
reference recomputes the pairs of a seed-drawn set of targets; every pair
of those targets in the window is compared with it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from . import check
from . import trace as trace_mod


class Spans:
    """Host seconds of each named stage, in order; with ``traced`` each
    span is also a profiler range ``bench:<name>``."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.seconds: Dict[str, List[float]] = collections.defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        rng = (torch.profiler.record_function(trace_mod.PREFIX + name)
               if self.traced else contextlib.nullcontext())
        with rng:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name].append(time.perf_counter() - t0)


@dataclasses.dataclass
class Window:
    """What a loop leaves: each pair's target and host table, end, latency
    (from when the pair was due) and the process's CPU seconds in it."""

    start: float
    results: List[tuple] = dataclasses.field(default_factory=list)
    ends: List[float] = dataclasses.field(default_factory=list)
    latencies: List[float] = dataclasses.field(default_factory=list)
    cpu_s: List[float] = dataclasses.field(default_factory=list)

    def done(self, k: int, out: dict, due: float, cpu: float) -> None:
        """Record target ``k``'s pair, ending now, which was due at the
        host time ``due`` and started at the process CPU time ``cpu``."""
        self.ends.append(time.perf_counter())
        self.cpu_s.append(time.process_time() - cpu)
        self.latencies.append(self.ends[-1] - due)
        self.results.append((k, out))


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: dict
    config: dict
    setup_s: float
    window_start: float
    pair_ends: List[float]
    latencies_s: List[float]
    spans: Dict[str, List[float]]
    trace: Optional[trace_mod.Trace]
    launch_shapes: Dict[str, Dict[tuple, int]]

    @property
    def pairs(self) -> int:
        return len(self.pair_ends)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def _profiler(dev: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def run_cell(spec, cell_name: str, seed: int, seconds: float, traced: bool,
             device, t_start: float) -> Tuple[dict, Dict[str, tuple]]:
    """Returns (the result line's object without the checks, {number:
    (value, limit)})."""
    parts = {"imports": time.perf_counter() - t_start}
    cell = spec.cell(cell_name)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    pipe = spec.pipeline(cfg["pipeline"])
    loop = spec.loop(traffic["loop"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def lap(name):
        sync()
        parts[name] = time.perf_counter() - t_start - sum(parts.values())

    pipeline = pipe.Pipeline(cfg, dev)
    lap("kernels")
    seq = spec.generator(traffic["generator"]).make_sequence(
        cfg["frame_shape"], traffic, seed, dev)
    lap("frames")
    pipeline.setup(seq.reference)
    pipeline.pair(seq.targets[0], Spans())
    if traced:  # the profiler's own start-up stays out of the window
        with _profiler(dev):
            torch.ones(1, device=dev).add_(1.0)
            sync()
    lap("warm_up")
    setup_s = time.perf_counter() - t_start

    counted = getattr(pipe, "COUNTED", {}) if traced else {}
    for wrapper in counted.values():
        wrapper.shapes = {}
    prof = _profiler(dev) if traced else None
    if prof is not None:
        prof.start()
    spans = Spans(traced)
    window = (torch.profiler.record_function(trace_mod.PREFIX
                                             + trace_mod.WINDOW)
              if traced else contextlib.nullcontext())
    with window:
        win = loop.run(pipeline, seq.targets, seconds, spans, traffic)
    shapes = {}
    reduced = None
    if prof is not None:
        prof.stop()
        reduced = trace_mod.reduce(prof) if cuda else None
        del prof
    for name, wrapper in counted.items():
        shapes[name] = dict(wrapper.shapes)
        wrapper.shapes = None
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    retries = (torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)
               if cuda else 0)
    built = {k: v for k, v in getattr(pipeline, "build_s", {}).items() if v}

    pipeline.close()
    del pipeline
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ran = {k for k, _ in win.results}
    chosen, readings, ref_s = check.judge(
        pipe, cfg, seq, lambda k: [o for kk, o in win.results if kk == k],
        ran, seed, dev)
    checks, failed, correct = check.verdict(readings,
                                            cfg["check"]["limits"])

    run = Run(cell=cell, config=cfg, setup_s=setup_s, window_start=win.start,
              pair_ends=win.ends, latencies_s=win.latencies,
              spans=dict(spans.seconds), trace=reduced,
              launch_shapes=shapes)
    metrics = {}
    for m in spec.metrics(cell_name, traced):
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    slow = max(range(run.pairs), key=win.latencies.__getitem__)
    info = dict(pairs=run.pairs, slowest_pair=slow,
                slowest_pair_s=win.latencies[slow],
                slowest_pair_cpu_s=win.cpu_s[slow],
                window_cpu_s=sum(win.cpu_s), alloc_retries=retries,
                compared=len(readings), targets_compared=chosen,
                reference_s=ref_s, window_s=win.ends[-1] - win.start,
                setup_s=setup_s, kernels_built=",".join(sorted(built)) or "none",
                **{f"setup_{k}_s": v for k, v in parts.items()})
    if cuda:
        device_info = {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(dev),
                       "count": int(cell["chips"]),
                       "memory_peak_bytes": peak,
                       "power_limit": power_limit()}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1,
                       "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": run.pairs, "failed": failed,
              "metrics": metrics, "device": device_info}
    if reduced is not None:
        device_info["busy_s"] = reduced.busy_s
        device_info["window_s"] = reduced.window_s
        result["breakdown"] = reduced.breakdown()
    print("run " + " ".join(f"{k}={v}" for k, v in info.items()),
          file=sys.stderr)
    return result, checks
