"""The harness end to end on the CPU at tiny sizes: it finds what a cell
names by file name, prints the line the contract asks for, loads no JAX,
refuses to run without a card, and decides ``correct`` by the plain
reference: true on the program as it is, false with the timed path
broken."""

import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import run as bench_run
from conftest import BENCH, ROOT, make_checkout
from core.cell import run_cell
from core.spec import Spec

import opencorr_tpu_torch as ot

CELLS = ("dic2d_fftcc_icgn1.seq", "dvc_fftcc_icgn1.seq")


def _run(root, cell, trace=False, seconds=0.3, seed=2 ** 31 + 9):
    spec = Spec(root)
    return run_cell(spec, cell, seed, seconds, trace, "cpu",
                    time.perf_counter())


def _digest(root: Path):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_files_add_a_cell_without_editing_one(checkout):
    bench = checkout / "benchmark"
    before = _digest(bench)
    (bench / "configs" / "tiny.json").write_text(json.dumps(dict(
        json.loads((bench / "configs" / "dic2d_fftcc_icgn1.json")
                   .read_text()), pipeline="tiny_pipe")))
    (bench / "traffic" / "tiny_mix.json").write_text(json.dumps(
        {"generator": "tiny_gen", "loop": "tiny_loop", "targets": 2,
         "translation": [0.5, 0.5],
         "strain": {"range": [0.0, 0.001], "axes": [1.0, 1.0]},
         "speckle": {"sigma": 1.5, "mean": 128.0, "std": 28.0}}))
    # a generator that turns every target upside down, on both sides
    (bench / "generators" / "tiny_gen.py").write_text(
        (bench / "generators" / "affine.py").read_text()
        + "\n_affine = make_sequence\n\n"
        "def make_sequence(shape, traffic, seed, device):\n"
        "    seq = _affine(shape, traffic, seed, device)\n"
        "    seq.reference = seq.reference[::-1].copy()\n"
        "    seq.targets = [t[::-1].copy() for t in seq.targets]\n"
        "    return seq\n")
    # a loop that offers the second target only
    (bench / "loops" / "tiny_loop.py").write_text(
        (bench / "loops" / "closed.py").read_text().replace(
            "k = len(win.results) % len(targets)", "k = 1"))
    (bench / "pipelines" / "tiny_pipe.py").write_text(
        (bench / "pipelines" / "dic2d_fftcc_icgn1.py").read_text())
    (bench / "metrics" / "tiny_count.py").write_text(
        "def read(run):\n    return float(run.pairs)\n")
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "a test",
                            "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny.seq", "config": "tiny",
                              "traffic": "tiny_mix", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"].append({"name": "tiny_count", "unit": "pairs",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["tiny.seq"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(spec))
    result, checks = _run(checkout, "tiny.seq")
    assert result["correct"], checks
    assert "bench_generator_tiny_gen" in sys.modules
    assert "bench_loop_tiny_loop" in sys.modules
    assert result["metrics"]["tiny_count"]["value"] == result["attempted"]
    after = _digest(bench)
    assert all(after[p] == h for p, h in before.items())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_holds_the_contract_keys(checkout, cell, trace):
    result, checks = _run(checkout, cell, trace)
    err, line = bench_run.finish(result, checks)
    out = json.loads(line)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[:5] == keys and list(out)[-1] == "checks"
    assert set(out) <= set(keys) | {"breakdown", "checks"}
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    spec = Spec(checkout)
    want = {m["name"] for m in spec.metrics(cell, trace)}
    # device-side readers find nothing to read on the CPU
    cpu_only = {"pairs_per_s", "pair_ms_p95", "pair_ms_p50", "setup_s",
                "fftcc.ms_per_pair", "icgn.prepare_ms_per_pair",
                "icgn.compute_ms_per_pair", "strain.ms_per_pair"}
    assert set(out["metrics"]) == want & cpu_only
    for m in out["metrics"].values():
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"]
        assert f"check {name} " in err
    assert err.splitlines()[-1].startswith("check ")


def test_a_run_loads_no_jax():
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(BENCH)!r}]\n"
        "import run as r\n"
        "from conftest import make_checkout\n"
        "import tempfile, pathlib\n"
        "from core.spec import Spec\n"
        "from core.cell import run_cell\n"
        "root = make_checkout(pathlib.Path(tempfile.mkdtemp()))\n"
        "for cell in ('dic2d_fftcc_icgn1.seq', 'dvc_fftcc_icgn1.seq'):\n"
        "    run_cell(Spec(root), cell, 5, 0.2, True,"
        " 'cpu', time.perf_counter())\n"
        "print(r.forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH=str(BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "opencorr_tpu_torch.x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert "opencorr_tpu" not in bench_run.forbidden_modules()
    assert "jax" not in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "opencorr_tpu.ops", sys)
    assert "opencorr_tpu" in bench_run.forbidden_modules()


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "benchmark/run.py", "--workload",
           "dic2d_fftcc_icgn1.seq", "--seed", "1", "--seconds", "1",
           "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    # without the program beside it, a run fails before any result
    make_checkout(tmp_path, tiny=False)
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _unchanged(self, table, *args, **kw):
    return table


def _half(original):
    def compute(self, table, *args, **kw):
        h = table.n // 2
        done = original(self, table.map(lambda a: a[:h]), *args, **kw)
        rest = table.map(lambda a: a[h:])
        return type(table)(*(torch.cat([getattr(done, f),
                                        getattr(rest, f)])
                             for f in table.FIELDS))
    return compute


def _altered(original):
    def compute(self, table, *args, **kw):
        out = original(self, table, *args, **kw)
        p = out.p.clone()
        p[out.n // 3, 0] += 0.01
        return out.replace(p=p)
    return compute


@pytest.mark.parametrize("cell, refiner", [
    ("dic2d_fftcc_icgn1.seq", ot.ICGN2D1), ("dvc_fftcc_icgn1.seq",
                                            ot.ICGN3D1)])
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(checkout, monkeypatch, cell,
                                            refiner, fault):
    original = refiner.compute
    patched = {"unchanged": _unchanged, "half": _half(original),
               "altered": _altered(original)}[fault]
    monkeypatch.setattr(refiner, "compute", patched)
    result, checks = _run(checkout, cell)
    assert result["correct"] is False
    assert result["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_a_reference_laid_out_as_the_table_compares_to_itself(checkout,
                                                              cell):
    import calibrate
    from core import check

    spec = Spec(checkout)
    c = spec.cell(cell)
    cfg = spec.config(c["config"])
    pipe = spec.pipeline(cfg["pipeline"])
    mix = spec.traffic(c["traffic"])
    seq = spec.generator(mix["generator"]).make_sequence(
        cfg["frame_shape"], mix, 3, "cpu")
    ref = pipe.reference(cfg, seq.reference, seq.targets[0], "cpu")
    got = check.compare(pipe.LAYOUT, calibrate.as_table(pipe.LAYOUT, ref),
                        ref)
    assert all(v == 0 for v in got.values()), got


def test_the_references_import_nothing_of_the_program():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(BENCH)!r}]\n"
        "import reference.dic2d, reference.dvc\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'opencorr_tpu_torch', 'opencorr_tpu', 'jax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=BENCH)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_runs_and_calibration_draw_the_same_targets():
    from core import check

    a = check.drawn(2 ** 31 + 21, range(256), 8)
    assert a == check.drawn(2 ** 31 + 21, range(256), 8)
    assert a != check.drawn(2 ** 31 + 22, range(256), 8)
    assert len(a) == 8 == len(set(a)) and a == sorted(a)
    # a run that reached only some targets draws among those
    assert set(check.drawn(5, [3, 9, 12], 2)) <= {3, 9, 12}
    assert check.drawn(5, range(4), 8) == [0, 1, 2, 3]


@pytest.mark.parametrize("closest, counted", [(0.004, 0.0), (3.0, 1.0)])
def test_a_minus_3_on_one_side_is_a_tie_only_at_a_sample_near_zero(
        closest, counted):
    from core import check
    from pipelines.dic2d_fftcc_icgn1 import LAYOUT

    n = 4
    ref = {"seed": np.zeros((n, 2)), "p": np.zeros((n, 6)),
           "zncc": np.full(n, 0.99), "iterations": np.full(n, 3.0),
           "closest": np.full(n, 40.0), "strain": np.zeros((n, 3))}
    ref["closest"][1] = closest
    out = {"p": np.zeros((n, 12)), "r": np.zeros((n, 4)),
           "e": np.zeros((n, 3))}
    out["r"][:, LAYOUT.zncc] = 0.99
    out["r"][:, LAYOUT.iterations] = 3.0
    out["r"][1, LAYOUT.zncc] = -3.0
    out["r"][1, LAYOUT.iterations] = 0.0
    ref["strain"][1] = 0.004  # only the reference gives POI 1 strain
    got = check.compare(LAYOUT, out, ref)
    assert got["code_mismatch"] == counted
    assert got["strain_gap"] == (0.0 if counted == 0 else 0.004)
