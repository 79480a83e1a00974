"""``BENCHMARK.json`` keeps to the benchmark's contract as far as a file
can be checked, and every name in it has the file that serves it."""

import json
import re

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_file_keeps_to_the_contract():
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    spec = json.loads(raw)
    assert set(spec) == KEYS
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert spec["paths"] == ["benchmark"]
    assert isinstance(spec["run_seconds"], int) and \
        1 <= spec["run_seconds"] <= 51
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and \
            _line(c["why"])
        assert c["file"].startswith("benchmark/") and \
            (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert (BENCH / "pipelines" / f"{cfg['pipeline']}.py").is_file()
        names.add(c["name"])
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (BENCH / "generators" / f"{mix['generator']}.py").is_file()
        assert (BENCH / "loops" / f"{mix['loop']}.py").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    cells = {w["name"] for w in spec["workloads"]}
    assert {w["config"] for w in spec["workloads"]} == names
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    metric_names = set()
    for group, extra in (("end_to_end", {"bound"}),
                         ("per_layer", {"layer", "moves"})):
        for m in spec[group]:
            assert set(m) - {"workloads"} == {"name", "unit", "better",
                                              "source"} | extra
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["name"] not in metric_names
            metric_names.add(m["name"])
            assert set(m.get("workloads", cells)) <= cells
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
            if group == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert m["moves"] in e2e and _line(m["layer"])
                assert m["source"] in ("device_trace", "program_span",
                                       "program_counter", "host_clock")
                if m["name"].endswith("_roofline"):
                    assert m["unit"] == "%"
    for cell in cells:
        mine = [m for m in spec["end_to_end"]
                if cell in m.get("workloads", cells)]
        assert len(mine) >= 2 and "setup_s" in {m["name"] for m in mine}
        assert any(cell in m.get("workloads", cells)
                   for m in spec["per_layer"])
    # a full check of 24 cells fits its time
    n = 24
    assert (2 + 14 * n) * (spec["run_seconds"] + 60) + n * 180 + 1200 \
        <= 43200
