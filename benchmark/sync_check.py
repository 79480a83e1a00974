#!/usr/bin/env python3
"""Which calls of one pair make the host wait for the device, and whether
the program counted each.  On a CUDA card, for each named cell: its
pipeline at the cell's size, one warm-up pair, then one pair under
``torch.cuda.set_sync_debug_mode("warn")``.

    python3 benchmark/sync_check.py --workload <cell> [<cell> ...] \
        --seed <n>

Run it from the root of a checkout.  CUDA reports every synchronising
call; each is put down to the innermost frame of the program
(``opencorr_tpu_torch/``) or of the pipeline that made it, and counted as a
read when it ran inside ``utils/timing.host_read``.  One JSON line a cell:
the sites and their calls, the counted reads, and the program's
``<layer>.sync.<what>`` counters over the pair, which equal the counted
reads where the program counts every read it makes.
"""

import collections
import sys
import traceback
import warnings
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for _p in (str(BENCH.parent), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from core import setup  # noqa: E402


def _site(stack):
    """(the innermost frame of the program or the pipeline, whether the
    call ran inside ``timing.host_read``)."""
    inside = any(f.name == "host_read" and f.filename.endswith(
        "utils/timing.py") for f in stack)
    for f in reversed(stack):
        if f.filename.endswith("utils/timing.py"):
            continue
        if "opencorr_tpu_torch" in f.filename or "pipelines" in f.filename:
            parts = Path(f.filename).parts
            return f"{'/'.join(parts[-2:])}:{f.lineno}", inside
    return "elsewhere", inside


def check(spec, cell_name: str, seed: int, dev) -> dict:
    import torch

    from core.cell import Spans
    from opencorr_tpu_torch.utils import timing

    pipeline, seq, _ = setup.prepared(spec, cell_name, seed, dev)

    sites = collections.Counter()
    counted = collections.Counter()
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):
            return
        site, inside = _site(traceback.extract_stack()[:-1])
        sites[site] += 1
        if inside:
            counted[site] += 1

    before = timing.counts()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pipeline.pair(seq.targets[1 % len(seq.targets)], Spans())
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = shown
    after = timing.counts()
    after.subtract(before)
    syncs = {k: n for k, n in after.items() if ".sync." in k and n}
    pipeline.close()
    return {"workload": cell_name, "seed": seed,
            "device": torch.cuda.get_device_name(dev),
            "synchronising_calls": sum(sites.values()),
            "counted_reads": sum(counted.values()),
            "sync_counters": sum(syncs.values()),
            "counters": syncs,
            "sites": dict(sites.most_common()),
            "uncounted": {k: n - counted[k] for k, n in sites.items()
                          if n > counted[k]}}


if __name__ == "__main__":
    sys.exit(setup.main(None, __doc__, check))
