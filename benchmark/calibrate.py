#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, on a CUDA card.

    python3 benchmark/calibrate.py --workload <cell> --seeds S1,S2,...
                                   [--control-seeds C1,C2,...]

For each seed: the cell's frames, and one pair through the timed path
(the run's own pipeline, after a warm-up pair) of each target that a run
with that seed compares, judged against the plain reference in float64 by
the runs' own comparison (``core/check.judge``); it prints the worst of
each compared number over them (the lower readings), and each pair's
milliseconds, refiner iterations and branch counts.  For each control
seed: the reference computed in float32 with TF32 matrix products on (the
precision below the configuration's), put in the program's place and
judged the same way (the upper readings).  One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def as_table(layout, ref: dict) -> dict:
    """A reference result laid out as the program's table."""
    import numpy as np

    n = ref["zncc"].shape[0]
    p = np.zeros((n, 12))
    p[:, list(layout.disp)] = ref["p"][:, list(layout.ref_disp)]
    p[:, list(layout.grad)] = ref["p"][:, list(layout.ref_grad)]
    r = np.zeros((n, max(*layout.seed, layout.zncc, layout.iterations) + 1))
    r[:, list(layout.seed)] = ref["seed"]
    r[:, layout.zncc] = ref["zncc"]
    r[:, layout.iterations] = ref["iterations"]
    return {"p": p, "r": r, "e": ref["strain"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH.parent), str(BENCH)]
    import torch

    from core import check
    from core.cell import Spans
    from core.spec import Spec
    from reference.common import matmul_precision

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    spec = Spec(BENCH.parent)
    cell = spec.cell(args.workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    pipe = spec.pipeline(cfg["pipeline"])
    dev = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    pipeline = pipe.Pipeline(cfg, dev)
    generator = spec.generator(traffic["generator"])
    for seed in seeds + controls:
        control = seed in controls and seed not in seeds
        seq = generator.make_sequence(cfg["frame_shape"], traffic, seed, dev)
        ran = range(len(seq.targets))
        outs, pairs = {}, []
        if not control:
            pipeline.setup(seq.reference)
            pipeline.pair(seq.targets[0], Spans())
            for k in check.drawn(seed, ran, int(cfg["check"]["targets"])):
                t0 = time.perf_counter()
                outs[k] = pipeline.pair(seq.targets[k], Spans())
                its = outs[k]["r"][:, pipe.LAYOUT.iterations]
                pairs.append({"target": k, "stats": pipeline.stats,
                              "ms": (time.perf_counter() - t0) * 1e3,
                              "iterations_mean": float(its[its >= 1].mean()),
                              "iterations_max": float(its.max()),
                              "translation": seq.translations[k].tolist(),
                              "strain": seq.strains[k].tolist()})
            pipeline.close()
            torch.cuda.empty_cache()

        def outputs(k):
            if not control:
                return [outs[k]]
            with matmul_precision(True):
                low = pipe.reference(cfg, seq.reference, seq.targets[k], dev,
                                     torch.float32)
            torch.cuda.empty_cache()
            return [as_table(pipe.LAYOUT, low)]

        chosen, readings, ref_s = check.judge(pipe, cfg, seq, outputs, ran,
                                              seed, dev)
        print(json.dumps({"seed": seed, "control": control,
                          "worst": check.worst(readings), "targets": chosen,
                          "per_target": readings, "pairs": pairs,
                          "reference_s": ref_s,
                          "device": torch.cuda.get_device_name(dev)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
