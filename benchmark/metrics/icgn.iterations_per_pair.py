"""Gauss-Newton iterations a pair of the refiner: the program's counters
``icgn.iter_full`` and ``icgn.iter_compact`` (2D, full width and
compacted) and ``icgn.iter`` (3D, summed over the chunks), over the
warm-up pair and the traced window's pairs: the process's counts
(``core/counters.py``)."""

from core import counters

KEYS = ("icgn.iter_full", "icgn.iter_compact", "icgn.iter")


def read(run):
    got = counters.read(run)
    if got is None or not any(k in got[0] for k in KEYS):
        return None
    counts, pairs = got
    return sum(counts.get(k, 0) for k in KEYS) / pairs
