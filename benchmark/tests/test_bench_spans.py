"""The readers of the program's spans (``spans.py``; ``unspanned_s``,
``host_busy_s``, ``k_trip_s.exact``, ``rescore_s.mf``) on the tiny cells
of both engines on the CPU, and on a log without a span tree."""

import json
import math

import pytest

import harness
import spans
import tiny

NEW = ("unspanned_s.mf", "unspanned_s.exact", "host_busy_s.mf",
       "host_busy_s.exact", "k_trip_s.exact", "rescore_s.mf")
# the new metrics each tiny cell reports (as the cell it is like does)
OWN = {"tiny_mf.scan": ("unspanned_s.mf", "host_busy_s.mf",
                        "rescore_s.mf"),
       "tiny_ex.scan": ("unspanned_s.exact", "host_busy_s.exact",
                        "k_trip_s.exact")}


def _read(name, run):
    path = harness.reader_path(tiny.BENCH, name)
    return harness._module(path, "metric reader").read(run)


@pytest.fixture(scope="module")
def runs(tiny_root):
    return {cell: tiny.run_tiny(tiny_root, cell, seed=2**31 + 77)
            for cell in OWN}


def test_new_entries_are_per_layer_metrics_of_their_cells():
    b = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    got = {m["name"]: m for m in b["per_layer"] if m["name"] in NEW}
    assert set(got) == set(NEW)
    for name, m in got.items():
        assert m["source"] == "program_span" and m["unit"] == "s"
        assert m["better"] == "lower"
        cell = "cohort50k.scan" if m["moves"] == "call_s" else \
            "cohort26k.scan"
        assert m["workloads"] == [cell]
        assert name.endswith(".mf") == (cell == "cohort50k.scan")


@pytest.mark.parametrize("cell", sorted(OWN))
def test_each_new_metric_reads_its_engine(runs, cell):
    run, line = runs[cell]
    assert line["correct"] is True and run.calls >= 1
    call_s = run.window_s / run.calls
    for name in OWN[cell]:
        v = _read(name, run)
        assert v is not None and math.isfinite(v) and v >= 0.0, name
    assert _read("unspanned_s.mf", run) < 0.1 * call_s
    assert _read("host_busy_s.mf", run) <= 1.05 * call_s
    other = "rescore_s.mf" if cell == "tiny_ex.scan" else "k_trip_s.exact"
    assert _read(other, run) is None
    assert set(OWN[cell]) <= {m["name"] for m in run.cell.per_layer}


def test_k_trip_on_the_host_has_no_upload(runs):
    run, _ = runs["tiny_ex.scan"]
    names = {s.name for ev in run.logs for r in spans.roots(ev)
             for s in r.walk()}
    assert {"k_to_host", "k_norm"} <= names and "k_upload" not in names
    trip = _read("k_trip_s.exact", run)
    per = [sum(s.wall for s in spans.named(r, ("k_to_host", "k_norm")))
           for ev in run.logs for r in spans.roots(ev)]
    assert trip == pytest.approx(sum(per) / len(per))


def test_a_log_without_a_tree_reads_nothing():
    """The scan log as a program that records no span tree writes it:
    phases without ids, so every new reader gives None."""
    old = [{"event": "phase", "elapsed_s": 1.0, "phase": p,
            "wallclock_s": 0.5} for p in ("context", "reml", "sweep")]
    old.append({"event": "stack_passes", "total": 3})

    class Run:
        logs = [old, old]
    for name in NEW:
        assert _read(name, Run()) is None, name


def test_the_tree_of_a_log():
    ev = [{"event": "phase", "phase": "b", "wallclock_s": 1.0, "id": 3,
           "parent": 2, "call": "c", "wait_s": 0.25},
          {"event": "phase", "phase": "a", "wallclock_s": 3.0, "id": 2,
           "parent": 1, "call": "c", "wait_s": 0.5},
          {"event": "phase", "phase": "am", "wallclock_s": 4.0, "id": 1,
           "parent": None, "call": "c", "wait_s": 0.0}]
    (root,) = spans.roots(ev)
    assert root.name == "am" and root.own == 1.0
    assert [s.name for s in root.walk()] == ["am", "a", "b"]

    class Run:
        logs = [ev]
    assert _read("unspanned_s.mf", Run()) == 1.0
    assert _read("host_busy_s.exact", Run()) == pytest.approx(4.0 - 0.75)


def test_phase_ranges_still_wrap_the_program(tiny_root):
    """The benchmark's own ``phase::`` ranges (recorder.PhaseRanges, a
    subclass of the program's Phase swapped in for the window) leave the
    span tree as it is."""
    import recorder
    with recorder.PhaseRanges():
        run, line = tiny.run_tiny(tiny_root, "tiny_mf.scan", seed=11)
    assert line["correct"] is True
    (root,) = spans.roots(run.logs[0])
    assert root.name == "am" and {"context", "sweep"} <= {
        c.name for c in root.children}
