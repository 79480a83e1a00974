"""Stage timing in the reference's CSV schema.

The reference examples time each stage with ``omp_get_wtime`` and write a
``*_time.csv``: a header row of stage names and one row of seconds
(examples/test_2d_dic_fftcc_icgn1.cpp:131-139).  ``StageTimer`` writes the
same file, and can also record each stage with ``torch.profiler``.  A stage
measures the host clock: callers synchronise the device inside it.
"""

from __future__ import annotations

import contextlib
import os
import re
import time
from typing import List, Optional

import torch


class StageTimer:
    """A profiler sees each stage as the range ``stage:<name>``.
    ``profile_dir``, when given, wraps every stage in
    ``torch.profiler.profile`` and writes its trace there as
    ``<stage>.json`` (Chrome trace format)."""

    def __init__(self, profile_dir: Optional[str] = None):
        self.names: List[str] = []
        self.seconds: List[float] = []
        self.profile_dir = profile_dir

    @contextlib.contextmanager
    def stage(self, name: str):
        prof = contextlib.nullcontext()
        if self.profile_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
        t0 = time.perf_counter()
        with prof, torch.profiler.record_function(f"stage:{name}"):
            yield
        self.names.append(name)
        self.seconds.append(time.perf_counter() - t0)
        if self.profile_dir:
            os.makedirs(self.profile_dir, exist_ok=True)
            fname = re.sub(r"[^A-Za-z0-9_.-]+", "_", name) + ".json"
            prof.export_chrome_trace(os.path.join(self.profile_dir, fname))

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
