"""The harness's CPU tests: the ``cuda`` marker, import paths, and a
throwaway checkout with every cell cut to a size the CPU runs in
seconds."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# each configuration at a size the CPU runs in a second or two
TINY = {
    "dic2d_fftcc_icgn1": dict(
        frame_shape=[96, 80],
        poi_grid={"upper_left": [20, 20], "number_x": 10, "number_y": 14,
                  "step": 4},
        fftcc={"radius": 8}, icgn={"radius": 8, "conv": 0.001,
                                   "max_iter": 10},
        strain={"radius": 10, "neighbor_min": 5, "zncc_min": 0.9}),
    "dvc_fftcc_icgn1": dict(
        frame_shape=[48, 36, 32],
        poi_grid={"origin": [12, 12, 12], "number_x": 2, "number_y": 3,
                  "number_z": 6, "step": 4},
        fftcc={"radius": 6}, icgn={"radius": 6, "conv": 0.001,
                                   "max_iter": 10},
        strain={"radius": 9, "neighbor_min": 10, "zncc_min": 0.9}),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


def make_checkout(dest: Path, tiny: bool = True) -> Path:
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` under ``dest``, its
    configurations cut to ``TINY`` sizes."""
    shutil.copytree(BENCH, dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    if tiny:
        for name, sizes in TINY.items():
            path = dest / "benchmark" / "configs" / f"{name}.json"
            cfg = json.loads(path.read_text())
            cfg.update(sizes)
            path.write_text(json.dumps(cfg))
    return dest


@pytest.fixture
def checkout(tmp_path):
    return make_checkout(tmp_path)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
