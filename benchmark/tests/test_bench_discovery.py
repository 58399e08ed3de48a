"""Cells, traffic mixes, metrics and checks are found by name from files;
a cell added as files and entries only is picked up with no edit."""

import json

import pytest

import tiny


def test_cells_are_found_by_name():
    import harness
    cell = harness.load_cell("cohort50k.scan", tiny.ROOT)
    assert cell.cfg["n_individuals"] == 50000 and cell.maxit == 3
    assert cell.traffic["entry"] == "am"
    assert {m["name"] for m in cell.end_to_end} == {"call_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "krylov_s.mf", "sweep_s.mf", "stack_passes", "packed_roofline_pct",
        "idle_pct", "peak_mem_gb"}
    cell = harness.load_cell("cohort26k.scan", tiny.ROOT)
    assert cell.maxit == 5
    assert {m["name"] for m in cell.end_to_end} == {"call_s.exact",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "eigh_s", "sweep_s.exact", "exact_gemm_roofline_pct",
        "idle_pct.exact", "peak_mem_gb.exact"}


@pytest.mark.parametrize("name, reader", [
    ("idle_pct.exact", "idle_pct.py"), ("peak_mem_gb.exact", "peak_mem_gb.py"),
    ("call_s.exact", "call_s.py"), ("sweep_s.exact", "sweep_s.exact.py"),
    ("idle_pct", "idle_pct.py")])
def test_a_variant_is_read_by_its_base(name, reader):
    """One quantity named apart for each end-to-end metric it moves has one
    reader; a variant with a reader of its own keeps it."""
    import harness
    assert harness.reader_path(tiny.BENCH, name).name == reader


def test_unknown_cell_is_refused():
    import harness
    with pytest.raises(harness.Refused):
        harness.load_cell("nope.scan", tiny.ROOT)


@pytest.mark.parametrize("cell", ["tiny_mf.scan", "tiny_ex.scan",
                                  "tiny_multi.scan"])
def test_a_cell_added_as_files_runs(tiny_root, cell):
    """The copy holds the committed files unchanged plus new files and new
    entries; each new cell runs end to end and comes out correct."""
    for rel in ("benchmark/harness.py", "benchmark/run.py",
                "benchmark/configs/cohort50k.json"):
        assert (tiny_root / rel).read_bytes() == \
            (tiny.ROOT / rel).read_bytes()
    run, line = tiny.run_tiny(tiny_root, cell)
    assert line["correct"], line["compared"]
    assert run.logs and all(run.logs)


def test_a_metric_added_as_a_file_is_read(tiny_root, tmp_path):
    """A per-layer reader dropped into metrics/ is found by its name."""
    import harness
    (tiny_root / "benchmark" / "metrics" / "calls_in_window.py").write_text(
        "def read(run):\n    return run.calls\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                               "better": "higher",
                               "source": "host_clock", "layer": "entry",
                               "moves": "call_s",
                               "workloads": ["tiny_ex.scan"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("tiny_ex.scan", tiny_root)
    assert "calls_in_window" in {m["name"] for m in cell.per_layer}
    mod = harness._module(cell.bench_dir / "metrics" / "calls_in_window.py",
                          "metric reader")

    class R:
        calls = 3
    assert mod.read(R) == 3


def test_readers_leave_out_what_they_cannot_read():
    """A reader with nothing to read returns None (the metric is then left
    out of the line), never 0 for a roofline share."""
    import harness

    class R:
        logs, profile, shapes, peak_bytes = [], None, {}, 0
        calls, window_s, setup_s = 0, 1.0, 2.0
    for path in sorted((tiny.BENCH / "metrics").glob("*.py")):
        if path.stem in ("setup_s",):
            continue
        mod = harness._module(path, "metric reader")
        assert mod.read(R) is None, path.name
