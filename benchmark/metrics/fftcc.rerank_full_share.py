"""The share (%) of FFTCC2D's calls that re-ranked every integral POI
exactly (more near-tie POIs than its cap): the program's counters
``fftcc.rerank_full`` over ``fftcc.calls`` (one call a pair on a
one-chunk queue), over the warm-up pair and the traced window's: the
process's counts (``core/counters.py``)."""

from core import counters


def read(run):
    got = counters.read(run)
    if got is None or not got[0].get("fftcc.calls"):
        return None
    counts = got[0]
    return 100.0 * counts.get("fftcc.rerank_full", 0) / counts["fftcc.calls"]
