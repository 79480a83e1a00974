#!/usr/bin/env python3
"""The upper readings of a cell's limits, on a CUDA card: the control of
``correct`` put in the program's place.

    python3 benchmark/control.py --workload <cell> --seeds C1,C2,...

For each seed: the cell's frames, and for each target that a run with
that seed compares, the pipeline's ``control`` (the plain reference in a
precision below the configuration's, laid out as the program's table)
judged against the plain reference by the runs' own comparison
(``core/check.judge``).  It prints, a line a seed, the worst of each
compared number, each target's readings and whether the control broke a
limit of the configuration on every target.  ``calibrate.py`` gives the
lower readings (the program on the same comparison); a pipeline without
``control`` takes ``calibrate.py``'s control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH.parent), str(BENCH)]
    import torch

    from core import check
    from core.spec import Spec

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    spec = Spec(BENCH.parent)
    cell = spec.cell(args.workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    pipe = spec.pipeline(cfg["pipeline"])
    dev = torch.device("cuda")
    limits = cfg["check"]["limits"]
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        seq = spec.generator(traffic["generator"]).make_sequence(
            cfg["frame_shape"], traffic, seed, dev)

        def outputs(k):
            out = pipe.control(cfg, seq.reference, seq.targets[k], dev)
            torch.cuda.empty_cache()
            return [out]

        chosen, readings, ref_s = check.judge(
            pipe, cfg, seq, outputs, range(len(seq.targets)), seed, dev)
        broke = [any(r[k] > lim for k, lim in limits.items())
                 for r in readings]
        print(json.dumps({"seed": seed, "control": True,
                          "worst": check.worst(readings), "targets": chosen,
                          "per_target": readings, "broke_a_limit": broke,
                          "reference_s": ref_s,
                          "device": torch.cuda.get_device_name(dev)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
