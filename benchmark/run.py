#!/usr/bin/env python3
"""One run of one cell of the opencorr_tpu_torch benchmark on a CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Run it from the root of a checkout.  The cell comes from ``BENCHMARK.json``
beside this folder.  With ``--trace 0`` the last line of standard output
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics (a run of its own under ``torch.profiler``), as one JSON object
with ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(``breakdown`` when traced) and, last, ``checks``: each number the
comparison with the plain reference held to its limit, which also end
standard error.  Without a CUDA card, or with fewer cards than the cell
asks for, it exits 2 and prints no result; if the JAX package or JAX was
loaded it exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
# top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "opencorr_tpu")


def forbidden_modules():
    """The forbidden top-level names among the loaded modules, each module
    compared by its whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for p in (str(BENCH.parent), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from core.spec import Spec

    spec = Spec(BENCH.parent)
    cell = spec.cell(args.workload)
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < int(cell["chips"]):
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees {cards}", file=sys.stderr)
        return 2
    from core.cell import run_cell

    result, checks = run_cell(spec, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    err, line = finish(result, checks)
    print(err, file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


def finish(result: dict, checks: dict):
    """(the last lines of standard error, the result line): each compared
    number beside its limit, in both, under ``checks`` last in the line."""
    result = dict(result)
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in checks.items()}
    err = "\n".join(f"check {name} {v!r} limit {lim!r}"
                    for name, (v, lim) in checks.items())
    return err, json.dumps(result)


if __name__ == "__main__":
    sys.exit(main())
