"""What the side tools that run a cell outside ``run.py``
(``benchmark/span_split.py``, ``benchmark/sync_check.py``) share: the
cell's set-up as ``core/cell.run_cell`` makes it (the pipeline, the frames
from the seed, one warm-up pair), the profiler a traced run records with,
and their command line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from .cell import Spans, _profiler

BENCH = Path(__file__).resolve().parent.parent


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prepared(spec, cell_name: str, seed: int, dev):
    """(the pipeline, the frame sequence, the traffic mix) of a cell, set
    up and past one warm-up pair."""
    cell = spec.cell(cell_name)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    pipeline = spec.pipeline(cfg["pipeline"]).Pipeline(cfg, dev)
    seq = spec.generator(mix["generator"]).make_sequence(
        cfg["frame_shape"], mix, seed, dev)
    pipeline.setup(seq.reference)
    pipeline.pair(seq.targets[0], Spans())
    _sync(dev)
    return pipeline, seq, mix


def profiler(dev):
    """A new profiler set as a traced run's, the profiler's own start-up
    already made outside it."""
    with _profiler(dev):
        torch.ones(1, device=dev).add_(1.0)
        _sync(dev)
    return _profiler(dev)


def main(argv, doc: str, one, seconds: bool = False) -> int:
    """The tools' command line: ``--workload`` (one or more cells),
    ``--seed`` (the k-th cell takes seed + k) and, with ``seconds``,
    ``--seconds``.  ``one(spec, cell, seed, dev[, seconds])`` gives each
    cell's JSON object, printed as one line; exit 2 without a CUDA card."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--workload", nargs="+", required=True)
    ap.add_argument("--seed", type=int, required=True)
    if seconds:
        ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from .spec import Spec

    if not torch.cuda.is_available():
        print(f"{Path(sys.argv[0]).stem}: no CUDA card", file=sys.stderr)
        return 2
    spec = Spec(BENCH.parent)
    dev = torch.device("cuda")
    extra = (args.seconds,) if seconds else ()
    for k, name in enumerate(args.workload):
        print(json.dumps(one(spec, name, args.seed + k, dev, *extra)),
              flush=True)
        torch.cuda.empty_cache()
    return 0
