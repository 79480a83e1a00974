"""Spans, counters and host reads of the port, and stage timing in the
reference's CSV schema.

* :func:`span` opens the profiler range ``oc:<name>`` while a
  ``torch.profiler`` session records, and does nothing otherwise (one
  check of the profiler's state).  The ranges are the profiler's events, on
  the device trace's clock; a span's parent is the span around it on the
  host thread.
* :func:`count` adds to the process's counters, always on; :func:`counts`
  copies them.  A module's ``compute`` runs under :func:`computing`, which
  also adds the call's increments of the module's ``stats`` to the
  counters as ``<layer>.<key>``.
* :func:`host_read` is how the hot path reads a device value to the host:
  the read is counted under its site, ``<layer>.sync.<what>``, and runs in
  the span of that name.

To trace a call, run it under one ``torch.profiler.profile`` and export
that session's trace; to read the counters, take :func:`counts` before and
after it.

The reference examples time each stage with ``omp_get_wtime`` and write a
``*_time.csv``: a header row of stage names and one row of seconds
(examples/test_2d_dic_fftcc_icgn1.cpp:131-139).  ``StageTimer`` writes the
same file.  A stage measures the host clock: callers synchronise the device
inside it.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import List

import torch

PREFIX = "oc:"
_OFF = contextlib.nullcontext()
_COUNTS: collections.Counter = collections.Counter()


def span(name: str):
    """The range ``oc:<name>`` while a profiler records, else a context
    that does nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF


def count(name: str, k: int = 1) -> None:
    _COUNTS[name] += k


def counts() -> collections.Counter:
    """A copy of the process's counters."""
    return collections.Counter(_COUNTS)


@contextlib.contextmanager
def computing(layer: str, stats: collections.Counter):
    """The span ``<layer>.compute``; on leaving it, what the call added to
    the module's ``stats`` goes to the process's counters as
    ``<layer>.<key>``."""
    before = dict(stats)
    with span(layer + ".compute"):
        yield
    for key, n in stats.items():
        if n != before.get(key, 0):
            _COUNTS[f"{layer}.{key}"] += n - before.get(key, 0)


def host_read(site: str, value: torch.Tensor, kind=None):
    """``kind(value)`` (``int``, ``bool``, ``float``), or with no ``kind``
    the host copy ``value.cpu().numpy()``: one read of the device, counted
    under ``site`` and run in its span."""
    _COUNTS[site] += 1
    with span(site):
        return value.cpu().numpy() if kind is None else kind(value)


class StageTimer:
    """Each stage is the span of its name (:func:`span`) and its host
    seconds."""

    def __init__(self):
        self.names: List[str] = []
        self.seconds: List[float] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        with span(name):
            yield
        self.names.append(name)
        self.seconds.append(time.perf_counter() - t0)

    def save_csv(self, path: str, poi_number: int, delimiter: str = ","):
        """Header 'POI number,<stage>,...' and one row of seconds (the
        reference's schema)."""
        with open(path, "w") as f:
            f.write(delimiter.join(["POI number"] + self.names) + "\n")
            f.write(delimiter.join(
                [str(poi_number)] + [repr(round(s, 7)) for s in self.seconds]
            ) + "\n")

    def report(self) -> str:
        return ", ".join(
            f"{n}: {s:.3f}s" for n, s in zip(self.names, self.seconds))
