"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix.  The configuration's file
(its ``file`` entry) names its pipeline; the mix is
``benchmark/traffic/<traffic>.json``, a file of parameters that names the
generator of its frames and the loop that offers them, and is read by
them: ``benchmark/generators/<generator>.py`` and
``benchmark/loops/<loop>.py``.  The pipeline is
``benchmark/pipelines/<pipeline>.py`` and every metric
``benchmark/metrics/<metric name>.py``.  Adding a cell, a mix, a
generator, a loop, a pipeline or a metric therefore means adding files and
entries, never editing one.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """The benchmark file of the checkout at ``root``, and lookups into
    its ``benchmark/`` folder."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench_dir = self.root / "benchmark"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        known = ", ".join(c["name"] for c in self.data["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({known})")

    def config(self, name: str) -> dict:
        for entry in self.data["configs"]:
            if entry["name"] == name:
                return json.loads((self.root / entry["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads(
            (self.bench_dir / "traffic" / f"{name}.json").read_text())

    def generator(self, name: str) -> ModuleType:
        return _module(self.bench_dir / "generators" / f"{name}.py",
                       f"bench_generator_{name}")

    def loop(self, name: str) -> ModuleType:
        return _module(self.bench_dir / "loops" / f"{name}.py",
                       f"bench_loop_{name}")

    def pipeline(self, name: str) -> ModuleType:
        return _module(self.bench_dir / "pipelines" / f"{name}.py",
                       f"bench_pipeline_{name}")

    def metrics(self, cell: str, trace: bool) -> list:
        """The cell's metric entries: with ``trace`` its per-layer ones,
        else its end-to-end ones (an entry without ``workloads`` belongs to
        every cell)."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> ModuleType:
        return _module(self.bench_dir / "metrics" / f"{metric}.py",
                       f"bench_metric_{metric}")
