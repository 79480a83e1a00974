"""Reads of a device value by the host a pair: the sum of the program's
``<layer>.sync.<what>`` counters, one for each read its hot path makes
through ``timing.host_read``, over the warm-up pair and the traced
window's pairs: the process's counts (``core/counters.py``)."""

from core import counters


def read(run):
    got = counters.read(run)
    if got is None:
        return None
    counts, pairs = got
    syncs = [n for k, n in counts.items() if ".sync." in k]
    return sum(syncs) / pairs if syncs else None
