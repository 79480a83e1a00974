"""Gauss-Newton iterations a pair of the self-adaptive refiner: the
program's counter ``icgn.iter_adaptive`` (one a loop step over a chunk of
the queue), over the warm-up pair and the traced window's pairs: the
process's counts (``core/counters.py``)."""

from core import counters

KEY = "icgn.iter_adaptive"


def read(run):
    got = counters.read(run)
    if got is None or KEY not in got[0]:
        return None
    counts, pairs = got
    return counts[KEY] / pairs
