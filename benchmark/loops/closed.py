"""The closed loop with one caller, the way a user works through a
sequence: pair after pair, cycling through the targets against the fixed
reference, each pair starting when the one before it has ended, new
pairs starting until ``seconds`` have passed.  A pair's latency runs from
its start to its end.  A mix names it as its ``"loop": "closed"``."""

from __future__ import annotations

import time

from core.cell import Window


def run(pipeline, targets, seconds: float, span, mix: dict) -> Window:
    win = Window(start=time.perf_counter())
    while not win.ends or time.perf_counter() - win.start < seconds:
        k = len(win.results) % len(targets)
        due, cpu = time.perf_counter(), time.process_time()
        with span("pair"):
            out = pipeline.pair(targets[k], span)
        win.done(k, out, due, cpu)
    return win
