"""The cell ``multi50k.traits4`` at CPU size: a copy of the benchmark with a
tiny configuration of ``multi50k``'s shape (four traits a call through
``am_multi``, its checks and limits) added as files and entries, run
through the harness; its check ``multi_fit`` and the three readers of the
lockstep path's spans and counters."""

import json
import math

import pytest

import harness
import tiny

CELL = "tiny_m4.traits4"
NEW = ("union_basis_s.multi", "trait_fit_s.multi", "multi_pass_roofline_pct")


def _add_tiny_multi(root):
    """``multi50k``'s configuration and ``traits4``'s traffic at 1 024 ×
    4 608 (the traffic unchanged but for the engine the size needs),
    named into the copy's BENCHMARK.json as the cell ``tiny_m4.traits4``,
    which reports what ``multi50k.traits4`` reports. On the CPU
    kernel_matvec computes its product without packed_tdot, so K2 has no
    launch to judge."""
    base = json.loads((tiny.BENCH / "configs" / "multi50k.json").read_text())
    limits = {k: v for k, v in base["limits"].items() if k != "k2_gap"}
    cfg = dict(base, n_individuals=1024, n_snps=4608, limits=limits,
               warmup=None)
    bench_dir = root / "benchmark"
    (bench_dir / "configs" / "tiny_m4.json").write_text(json.dumps(cfg))
    traffic = json.loads((tiny.BENCH / "traffic" / "traits4.json")
                         .read_text())
    traffic["engine"] = "matfree"
    (bench_dir / "traffic" / "traits4_tiny.json").write_text(
        json.dumps(traffic))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_m4", "source": "test",
                             "file": "benchmark/configs/tiny_m4.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny_m4",
                               "traffic": "traits4_tiny", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "multi50k.traits4" in m.get("workloads", ()):
            m["workloads"] = m["workloads"] + [CELL]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One run of the tiny cell with the window's operations recorded as a
    traced run records them (the operand shapes; on the CPU no device
    trace), its result line, and its checks' control readings."""
    import torch
    root = tiny.make_root(tmp_path_factory.mktemp("multi"))
    _add_tiny_multi(root)
    h = tiny.harness_on(root)
    cell = h.load_cell(CELL, root)
    run = h.Run(cell, 2**31 + 41, 1.0, True, torch.device("cpu"))
    run.tmp = h.new_tmp()
    try:
        out = h.execute(run, tiny.ROOT, 0.0)
        ctl = {}
        for c in run.checks:
            ctl.update(c.control())
    finally:
        h.cleanup(run.tmp)
    return run, h.result_line(run, out), ctl


def _read(name, run):
    path = harness.reader_path(tiny.BENCH, name)
    return harness._module(path, "metric reader").read(run)


def _check(run):
    return next(c for c in run.checks
                if type(c).__module__.endswith("multi_fit"))


def test_the_cell_is_correct_and_judges_every_trait(traced):
    run, line, _ = traced
    assert line["correct"] is True, line["compared"]
    assert run.calls >= 1 and run.failed == 0
    assert set(line["compared"]) == {
        "k1_gap", "k3_gap", "multi_extbic_gap", "multi_t_gap",
        "wide_k1_gap", "not_planted", "short_calls"}
    chk = _check(run)
    traits, got, wide = chk.kept[0]
    assert len(traits) == len(got) == len(chk.ref) == 4
    # every trait is fitted along its own selections, and the wide launch
    # kept is the pass of all four traits side by side (4 × (1 + 8 + 128))
    for (sel, path, t), ref in zip(got, chk.ref):
        assert len(sel) == run.cell.maxit
        assert len(ref["extbic_path"]) == len(path) == len(sel) + 1
        assert len(ref["t"]) == len(t) == len(sel)
    assert wide is not None and wide[1].shape[0] == 1024
    assert chk.notes["multi"]["extbic"] == [p for _, p, _ in got]


def test_a_trait_in_the_wrong_slot_fails():
    """Two traits' results swapped: the reference, fitting each trait
    along its own selections, no longer agrees."""
    mf = harness._module(tiny.BENCH / "checks" / "multi_fit.py", "check")
    ref = [{"extbic_path": [10.0, 8.0], "t": [30.0]},
           {"extbic_path": [20.0, 15.0], "t": [50.0]}]
    ok = [[10.0, 8.0], [20.0, 15.0]]
    assert max(mf.path_gap(e, r["extbic_path"])
               for e, r in zip(ok, ref)) == 0.0
    assert max(mf.path_gap(e, r["extbic_path"])
               for e, r in zip(ok[::-1], ref)) > 0.4
    assert mf.path_gap([1.0], [1.0, 2.0]) == math.inf


def test_control_reads_wider_than_the_program(traced):
    run, line, ctl = traced
    limits = run.cell.cfg["limits"]
    for k in ("multi_extbic_gap", "multi_t_gap", "wide_k1_gap"):
        assert ctl[k] > line["compared"][k][0], k
    assert [k for k, v in ctl.items() if k in limits
            and not v <= limits[k]]


def test_the_readers_read_the_spans_and_counters(traced):
    run, _, _ = traced
    call_s = run.window_s / run.calls
    for name in ("union_basis_s.multi", "trait_fit_s.multi"):
        v = _read(name, run)
        assert v is not None and 0.0 < v < call_s, name
    # the CPU gives no device trace: the share reads nothing there, and
    # with one (a device time for the range) its bound over that time
    assert _read("multi_pass_roofline_pct", run) is None
    stat = [e for ev in run.logs for e in ev
            if e.get("phase") == "stat_pass"]
    assert stat and all(e["cols"] == 4 * 137 and e["traits"] == 4
                        and e["launches"] == 1 for e in stat)
    p, n, _, nw = max(run.shapes["packed_dot"])
    assert (p, n) == (4608, 1024)
    import yardstick
    least = len(stat) * yardstick.bound("packed_dot", n, p, 548, nw)[0]
    run.profile = {"range_device_s": {"matfree_stat_rows_multi": 0.5}}
    try:
        got = _read("multi_pass_roofline_pct", run)
    finally:
        run.profile = None
    assert got == pytest.approx(100.0 * least / 1e3 / 0.5)
    assert set(NEW) <= {m["name"] for m in run.cell.per_layer}


def test_a_log_without_the_new_spans_reads_nothing():
    """The scan log of a program that records neither the new spans nor
    the stat pass's counters (the parent's): every new reader gives
    None."""
    tree = [{"event": "phase", "phase": p, "wallclock_s": 0.5, "id": i,
             "parent": 1 if i > 1 else None, "call": "c", "wait_s": 0.0}
            for i, p in enumerate(("am_multi", "context", "reml",
                                   "stat_pass", "refit"), 1)]

    class Run:
        logs = [tree, tree]
        profile = {"range_device_s": {"matfree_stat_rows_multi": 0.4}}
        shapes = {"packed_dot": [(4608, 1024, 548, 64)]}
    for name in NEW:
        assert _read(name, Run()) is None, name
