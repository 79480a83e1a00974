"""Gauss-Newton iterations a pair of the epipolar searches' coarse IC-GN
(one a loop step over a chunk of the candidate queue, both searches): the
program's counters ``epipolar.iter_full`` and ``epipolar.iter_compact``,
over the warm-up pair and the traced window's pairs: the process's counts
(``core/counters.py``)."""

from core import counters

PREFIX = "epipolar.iter_"


def read(run):
    got = counters.read(run)
    if got is None:
        return None
    counts, pairs = got
    iters = [n for k, n in counts.items() if k.startswith(PREFIX)]
    return sum(iters) / pairs if iters else None
