"""Reduce a ``torch.profiler`` trace of the window to what the per-layer
readers and the result's ``breakdown`` need.

The harness opens a ``record_function`` range ``bench:<span>`` around each
of its spans, so the host's spans and the device's operations share the
trace's clock.  Device time is the union of the intervals of every device
operation (kernels, copies, fills); the ranges' device-side mirrors are
left out.  An idle gap is a stretch of the window with no device
operation, labelled with the innermost benchmark span open on the host
when it began.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Tuple

PREFIX = "bench:"
WINDOW = "window"


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _on_device(ev) -> bool:
    return str(ev.device_type()).rsplit(".", 1)[-1] in ("CUDA", "cuda")


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]
    gaps: List[Tuple[str, float]]  # longest first

    def seconds_of(self, kernel: str) -> float:
        """Device seconds of the operations whose name holds ``kernel``."""
        return sum(s for name, s in self.kernel_s.items() if kernel in name)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[name[:160], s] for name, s in ops],
                "idle_gaps": [[label, s] for label, s in self.gaps[:top]]}


def reduce(prof) -> Trace:
    events = prof.profiler.kineto_results.events()
    spans = []
    device = []
    for ev in events:
        name = ev.name()
        if name.startswith(PREFIX):
            if not _on_device(ev):
                start = _ns(ev, "start")
                spans.append((start, start + _ns(ev, "duration"),
                              name[len(PREFIX):]))
            continue
        annotation = getattr(ev, "is_user_annotation", None)
        if _on_device(ev) and not (annotation and annotation()):
            start = _ns(ev, "start")
            device.append((start, start + _ns(ev, "duration"), name))
    window = [s for s in spans if s[2] == WINDOW]
    if not window:
        raise RuntimeError("the trace holds no window range")
    w0, w1 = window[0][0], window[0][1]
    kernel_s = collections.defaultdict(float)
    for s, e, name in device:
        kernel_s[name] += (e - s) / 1e9
    # union of the device intervals inside the window, and the gaps
    busy = 0
    gaps = []
    cursor = w0
    for s, e, _ in sorted(device):
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
    inner = sorted((s for s in spans if s[2] != WINDOW),
                   key=lambda sp: sp[0])

    def label(t):
        best = WINDOW
        best_start = None
        for s, e, name in inner:
            if s > t:
                break
            if e >= t and (best_start is None or s >= best_start):
                best, best_start = name, s
        return best

    gaps.sort(key=lambda g: -g[1])
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                 kernel_s=dict(kernel_s),
                 gaps=[(label(t), d / 1e9) for t, d in gaps[:10]])
