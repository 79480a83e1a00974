"""The program's counters for the per-layer readers.

``opencorr_tpu_torch/utils/timing.counts()`` copies the process's
counters: each compute's branch counts under its layer
(``fftcc.rerank_full``, ``icgn.iter_full``, ...), one count a host read
under its site (``<layer>.sync.<what>``) and ``fftcc.calls``.  They are
the whole process's, from its start: not the traced window's alone.  In a
run the program runs only the harness's warm-up pair (``core/cell.py``,
always target 0) and the window's pairs, so a reader divides by both; a
second warm-up, or anything else in the process that ran a module of the
port, would change every value without a sign.  The window's own counts
need ``Run.counters``, a difference of ``counts()`` taken around the
loop in ``core/cell.py``, which only a ``benchmark`` change may add; the
readers then drop the warm-up pair.
"""

from __future__ import annotations

from typing import Optional, Tuple


def read(run) -> Optional[Tuple[dict, int]]:
    """(the program's counters, the pairs they span), or None: for a run
    without a trace, as the other per-layer metrics (the CPU runs hold
    none), or a program that keeps no counters."""
    if run.trace is None:
        return None
    from opencorr_tpu_torch.utils import timing

    counts = getattr(timing, "counts", None)
    if counts is None:
        return None
    return counts(), run.pairs + 1
