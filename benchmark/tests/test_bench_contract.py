"""BENCHMARK.json against the benchmark's contract, and the result line."""

import json
import re
from pathlib import Path

import harness
import tiny

ROOT = tiny.ROOT
BENCH = tiny.BENCH
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_entries():
    b = _bench()
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        names.append(c["name"])
    cells = []
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        cells.append(w["name"])
    assert len(set(cells)) == len(cells)
    assert {w["config"] for w in b["workloads"]} == set(names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert {"call_s", "call_s.exact", "setup_s"} <= e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert harness.reader_path(BENCH, m["name"]).is_file()
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        moved = [e for e in b["end_to_end"] if e["name"] == m["moves"]][0]
        assert set(m["workloads"]) <= set(moved["workloads"])
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    assert len({m["name"] for m in b["end_to_end"] + b["per_layer"]}) == \
        len(b["end_to_end"]) + len(b["per_layer"])


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    import harness
    for w in _bench()["workloads"]:
        cell = harness.load_cell(w["name"], ROOT)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


def test_configs_name_their_checks_and_limits():
    import harness
    for w in _bench()["workloads"]:
        cell = harness.load_cell(w["name"], ROOT)
        for c in cell.cfg["checks"]:
            assert (BENCH / "checks" / f"{c}.py").is_file()
        assert cell.cfg["limits"]


def test_result_line(tiny_root):
    run, line = tiny.run_tiny(tiny_root, "tiny_mf.scan", seed=2**31 + 9)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == run.calls >= 1
    assert set(line["metrics"]) >= {"setup_s"} and len(line["metrics"]) == 2
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for k, (value, limit) in line["compared"].items():
        assert value <= limit, k
    json.dumps(line)
