"""The device's idle time, the CUDA runtime calls and the device time of
a traced window, each put down to the span open on the host.

The harness opens a ``record_function`` range ``bench:<span>`` around each
of its spans (``core/cell.py``), and the program opens ``oc:<span>``
ranges inside its modules while a profiler records
(``opencorr_tpu_torch/utils/timing``), so the host's spans and the
device's operations share the trace's clock.  The ranges nest on the host
thread, so every instant of the host's time lies under one innermost
range: a program span (labelled ``oc:<name>``) or a benchmark span
(labelled ``<name>``; ``window`` outside them all).  Each stretch of an
idle gap of the device goes to the innermost range open over it
(``idle_by_span``, which adds up to the window's idle time), each runtime
call that enqueues device work (kernel launches, copies, fills) to the
innermost range open when it was made (``launches_by_span``), and each
device operation, through the correlation id it shares with its runtime
call, to that call's range (``kernel_s_by_span``; ``unmatched`` where the
trace holds no such call).  Device time and the gaps are reckoned as
``core/trace.py`` reckons them; the ranges' device-side mirrors are no
device work.  ``benchmark/span_split.py`` prints the split of a cell.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from .trace import PREFIX, WINDOW, _ns, _on_device

PROGRAM = "oc:"
UNMATCHED = "unmatched"
# the CUDA calls that enqueue device work (runtime API, and cuLaunchKernel)
RUNTIME = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset")
# before any event of a trace (ns)
_NEVER = -2 ** 62


@dataclasses.dataclass
class Split:
    window_s: float
    busy_s: float
    # the ten longest gaps, each by the span that holds most of it
    gaps: List[Tuple[str, float]]
    # idle seconds of the window by innermost span
    idle_by_span: Dict[str, float]
    # runtime calls that enqueue device work, by innermost span
    launches_by_span: Dict[str, int]
    # device seconds by (span of the launching call, operation name)
    kernel_s_by_span: Dict[Tuple[str, str], float]
    # host ranges by label, how many the trace holds
    span_counts: Dict[str, int]

    def sum_by_span(self, field: str, prefix: str) -> float:
        """The sum of ``field`` (``idle_by_span`` or ``launches_by_span``)
        over the labels that start with ``prefix``."""
        return sum(v for label, v in getattr(self, field).items()
                   if label.startswith(prefix))

    def breakdown(self, top: int = 10) -> dict:
        heavy = sorted(self.kernel_s_by_span.items(),
                       key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[f"{span} | {name}"[:160], s]
                               for (span, name), s in heavy],
                "idle_gaps": [[label, s] for label, s in self.gaps[:top]]}


def _label(name: str) -> str:
    return name[len(PREFIX):] if name.startswith(PREFIX) else name


def _stretches(ranges) -> List[Tuple[int, int, str]]:
    """The host's time under the ranges, cut into stretches in time order,
    each labelled with the innermost range open over it (a range that ends
    after its parent is cut at the parent's end)."""
    out: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []  # (end, label), innermost last
    cursor = None

    def close(until):
        nonlocal cursor
        while stack and stack[-1][0] <= until:
            end, label = stack.pop()
            if end > cursor:
                out.append((cursor, end, label))
                cursor = end

    for s, e, label in sorted(ranges, key=lambda r: (r[0], -r[1])):
        close(s)
        if stack and s > cursor:
            out.append((cursor, s, stack[-1][1]))
        cursor = s if cursor is None else max(cursor, s)
        stack.append((min(e, stack[-1][0]) if stack else e, label))
    if stack:
        close(stack[0][0])
    return out


def _segments(stretches):
    """(bounds [K + 1], the label index of each segment [K], the labels):
    the whole time line cut into segments [bounds[k], bounds[k + 1]), the
    stretches and, around and between them, ``window``."""
    labels, index = [WINDOW], {WINDOW: 0}
    bounds, labs = [_NEVER], [0]
    for s, e, label in stretches:
        if s > bounds[-1]:
            bounds.append(s)
            labs.append(index.setdefault(label, len(labels)))
        else:
            labs[-1] = index.setdefault(label, len(labels))
        if len(index) > len(labels):
            labels.append(label)
        bounds.append(e)
        labs.append(0)
    bounds.append(-_NEVER)
    return np.array(bounds, dtype=np.int64), np.array(labs), labels


def split(events) -> Split:
    """The split of one traced window's kineto events (what
    ``torch.profiler.profile`` keeps in ``.profiler.kineto_results``)."""
    ranges = []  # host ranges of both kinds: (start, end, label)
    calls = []  # runtime calls: (start, correlation id)
    device = []  # (start, end, name, correlation id)
    for ev in events:
        name = ev.name()
        if name.startswith((PREFIX, PROGRAM)):
            if not _on_device(ev):
                start = _ns(ev, "start")
                ranges.append((start, start + _ns(ev, "duration"),
                               _label(name)))
            continue
        annotation = getattr(ev, "is_user_annotation", None)
        if _on_device(ev):
            if not (annotation and annotation()):
                start = _ns(ev, "start")
                device.append((start, start + _ns(ev, "duration"), name,
                               ev.correlation_id()))
        elif name.startswith(RUNTIME):
            calls.append((_ns(ev, "start"), ev.correlation_id()))
    window = [r for r in ranges if r[2] == WINDOW]
    if not window:
        raise RuntimeError("the trace holds no window range")
    w0, w1 = window[0][0], window[0][1]
    # union of the device intervals inside the window, and the gaps
    busy = 0
    gaps = []
    cursor = w0
    for s, e, _, _ in sorted(device):
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if s > cursor:
            gaps.append((cursor, s - cursor))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if w1 > cursor:
        gaps.append((cursor, w1 - cursor))

    bounds, labs, labels = _segments(_stretches(ranges))
    gaps.sort()
    g0 = np.array([g for g, _ in gaps], dtype=np.int64)
    gd = np.array([d for _, d in gaps], dtype=np.int64)
    # each segment's overlap with the gaps: G(t), the gap time before t, at
    # both of its ends
    before = np.concatenate([[0], np.cumsum(gd)])

    def gap_time_before(t):
        j = np.searchsorted(g0, t, side="right") - 1
        inside = np.clip(t - g0[np.maximum(j, 0)], 0, gd[np.maximum(j, 0)])
        return np.where(j >= 0, before[j] + inside, 0)

    if gaps:
        overlap = np.diff(gap_time_before(bounds))
        idle_ns = np.bincount(labs, weights=overlap, minlength=len(labels))
    else:
        idle_ns = np.zeros(len(labels))
    # the ten longest gaps, each by the label that holds most of it
    labelled = []
    for i in np.argsort(-gd, kind="stable")[:10]:
        k0, k1 = np.searchsorted(bounds, [g0[i], g0[i] + gd[i]],
                                 side="right") - 1
        held = collections.defaultdict(int)
        for k in range(k0, k1 + 1):
            held[labs[k]] += (min(bounds[k + 1], g0[i] + gd[i])
                              - max(bounds[k], g0[i]))
        labelled.append((labels[max(held, key=held.get)],
                         float(gd[i]) / 1e9))

    # each runtime call by the label open when it was made, and its device
    # work by its call's label
    when = np.array([t for t, _ in calls], dtype=np.int64)
    made = labs[np.searchsorted(bounds, when, side="right") - 1]
    launches = np.bincount(made, minlength=len(labels))
    owner = dict(zip((c for _, c in calls), made.tolist()))
    by_span = collections.defaultdict(float)
    for s, e, name, corr in device:
        k = owner.get(corr)
        by_span[(UNMATCHED if k is None else labels[k], name)] += \
            (e - s) / 1e9
    return Split(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                 gaps=labelled,
                 idle_by_span={labels[k]: v / 1e9
                               for k, v in enumerate(idle_ns) if v},
                 launches_by_span={labels[k]: int(n)
                                   for k, n in enumerate(launches) if n},
                 kernel_s_by_span=dict(by_span),
                 span_counts=dict(collections.Counter(
                     label for _, _, label in ranges)))
