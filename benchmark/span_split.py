#!/usr/bin/env python3
"""Where the device's idle time of a cell goes, by the program's spans.

    python3 benchmark/span_split.py --workload <cell> [<cell> ...] \
        --seed <n> --seconds <s>

Run it from the root of a checkout, on a CUDA card.  For each cell it sets
up as ``benchmark/run.py`` does (the cell's pipeline, frames from the seed,
one warm-up pair), then runs the mix's loop for ``--seconds`` under
``torch.profiler``, as a traced run does, and splits the window
(``core/spans.py``): the device's idle milliseconds a pair by the
innermost span open on the host, and their sums under FFTCC's, the
refiner's and Strain's spans and outside the program's, which add up to
the window's idle time; the runtime calls a pair by span; the heaviest
(span, kernel) entries and the longest gaps; the program's counters a
pair over the window; the device time no runtime call in the trace
launched.  One JSON line a cell; nothing is compared with the reference.
"""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for _p in (str(BENCH.parent), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from core import setup  # noqa: E402

LAYERS = ("fftcc", "icgn", "strain")


def split_cell(spec, cell_name: str, seed: int, dev, seconds: float) -> dict:
    import torch

    from core import spans as spans_mod
    from core import trace as trace_mod
    from core.cell import Spans
    from opencorr_tpu_torch.utils import timing

    pipeline, seq, mix = setup.prepared(spec, cell_name, seed, dev)
    prof = setup.profiler(dev)
    before = timing.counts()
    prof.start()
    with torch.profiler.record_function(trace_mod.PREFIX + trace_mod.WINDOW):
        win = spec.loop(mix["loop"]).run(pipeline, seq.targets, seconds,
                                         Spans(True), mix)
    prof.stop()
    counters = timing.counts()
    counters.subtract(before)
    split = spans_mod.split(prof.profiler.kineto_results.events())
    del prof
    pipeline.close()

    pairs = len(win.ends)

    def per_pair(d, scale=1.0):
        """``d`` a pair, largest first."""
        return {k: v * scale / pairs
                for k, v in sorted(d.items(), key=lambda kv: -kv[1])}

    idle = {f"{layer}.idle_ms_per_pair": 1e3 * split.sum_by_span(
        "idle_by_span", f"{spans_mod.PROGRAM}{layer}.") / pairs
        for layer in LAYERS}
    idle["outside.idle_ms_per_pair"] = 1e3 * sum(
        s for label, s in split.idle_by_span.items()
        if not label.startswith(spans_mod.PROGRAM)) / pairs
    return {"workload": cell_name, "seed": seed,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "pairs": pairs, "window_s": split.window_s,
            "busy_s": split.busy_s,
            "idle_ms_per_pair": 1e3 * (split.window_s - split.busy_s)
            / pairs,
            **idle,
            "icgn.launches_per_pair": split.sum_by_span(
                "launches_by_span", f"{spans_mod.PROGRAM}icgn.") / pairs,
            "unmatched_device_s": sum(
                s for (span, _), s in split.kernel_s_by_span.items()
                if span == spans_mod.UNMATCHED),
            "idle_ms_by_span": per_pair(split.idle_by_span, 1e3),
            "launches_by_span": per_pair(split.launches_by_span),
            "counters_per_pair": per_pair(+counters),
            "breakdown": split.breakdown()}


if __name__ == "__main__":
    sys.exit(setup.main(None, __doc__, split_cell, seconds=True))
