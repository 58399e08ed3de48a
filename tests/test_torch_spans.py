"""The port's spans (utils/logging.Phase) on tiny cohorts on the CPU: the
span tree of an ``am()`` / ``am_multi()`` call in its scan log, the
waits credited to the innermost open span, and the profiler ranges a span
opens only while a profiler records."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import eagleeverything_tpu_torch as port  # noqa: E402
from eagleeverything_tpu_torch.data.simulate import (  # noqa: E402
    simulate_dataset)
from eagleeverything_tpu_torch.utils import logging as scanlog  # noqa: E402

N, P = 300, 2000
TREE = ("start_s", "id", "parent", "call", "wait_s", "h2d_bytes",
        "d2h_bytes")
# the six names the scan log had before spans nested, each a direct child
# of the call's root, by engine
TOP = {"jax": {"mmt", "eigh", "sweep"}, "matfree": {"context", "reml",
                                                    "sweep", "refit"}}
# spans inside them: name → its parent's name. One trait's matrix-free
# fit is the lockstep loop's at R = 1: its basis and δ search sit inside
# ``reml`` one level down, in ``union_basis`` and ``trait_fit``
INNER = {"jax": {"stack": "mmt", "k_to_host": "mmt",
                 "eigh_solve": "eigh", "sweep_state": "sweep"},
         "matfree": {"s0": "context", "stack": "s0",
                     "union_basis": "reml", "trait_fit": "reml",
                     "krylov_basis": "union_basis",
                     "delta_search": "trait_fit", "polish": "trait_fit",
                     "solve": "sweep", "probes": "sweep",
                     "stat_pass": "sweep", "rescore": "sweep",
                     "escalate": "sweep"}}


@pytest.fixture(scope="module")
def sim():
    return simulate_dataset(n=N, p=P, n_qtl=3, seed=21)


def _events(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _spans(events):
    return [e for e in events if e["event"] == "phase"]


@pytest.fixture(scope="module")
def logs(sim, tmp_path_factory):
    """The scan log of one call of each entry on each engine: {(entry,
    engine): [events]}."""
    d = tmp_path_factory.mktemp("spans")
    out = {}
    for engine in ("jax", "matfree"):
        log = str(d / f"am_{engine}.jsonl")
        port.am("y", sim.geno, {"y": sim.y}, maxit=2, engine=engine,
                device="cpu", log_jsonl=log)
        out["am", engine] = _events(log)
        log = str(d / f"multi_{engine}.jsonl")
        port.am_multi(["y", "age"], sim.geno,
                      {"y": sim.y, "age": sim.covariate}, maxit=2,
                      engine=engine, device="cpu", log_jsonl=log)
        out["am_multi", engine] = _events(log)
    return out


CALLS = [("am", "jax"), ("am", "matfree"), ("am_multi", "jax"),
         ("am_multi", "matfree")]


@pytest.mark.parametrize("entry,engine", CALLS)
def test_every_phase_event_is_a_span(logs, entry, engine):
    spans = _spans(logs[entry, engine])
    assert len(spans) >= 8
    for e in spans:
        assert {"event", "elapsed_s", "phase", "wallclock_s"} <= set(e)
        assert set(TREE) <= set(e)
    ids = [e["id"] for e in spans]
    assert len(set(ids)) == len(ids)


@pytest.mark.parametrize("entry,engine", CALLS)
def test_one_root_a_call_and_children_inside_their_parents(logs, entry,
                                                           engine):
    spans = _spans(logs[entry, engine])
    by_id = {e["id"]: e for e in spans}
    roots = [e for e in spans if e["parent"] is None]
    assert [r["phase"] for r in roots] == [entry]
    assert {e["call"] for e in spans} == {roots[0]["call"]}
    tol = 2e-4          # walls are logged to 1e-4 s
    for e in spans:
        if e["parent"] is None:
            continue
        up = by_id[e["parent"]]
        assert up["start_s"] <= e["start_s"] + tol
        assert (e["start_s"] + e["wallclock_s"]
                <= up["start_s"] + up["wallclock_s"] + tol)
        assert 0.0 <= e["wait_s"] <= e["wallclock_s"]
        assert e["h2d_bytes"] == e["d2h_bytes"] == 0    # no card here


@pytest.mark.parametrize("engine", ["jax", "matfree"])
def test_the_old_names_stay_where_they_were(logs, engine):
    spans = _spans(logs["am", engine])
    by_id = {e["id"]: e for e in spans}
    root = next(e for e in spans if e["parent"] is None)
    top = {e["phase"] for e in spans if e["parent"] == root["id"]}
    assert TOP[engine] <= top
    assert {"prep", "backend"} <= top
    for name, parent in INNER[engine].items():
        got = {by_id[e["parent"]]["phase"] for e in spans
               if e["phase"] == name}
        assert parent in got, name
    if engine == "jax":
        assert {"k_norm", "basis", "fit0", "refit"} <= top
        # the host decomposes K at this size: nothing goes up again
        assert "k_upload" not in {e["phase"] for e in spans}


def test_waits_go_to_the_innermost_open_span(tmp_path):
    import time
    log = str(tmp_path / "w.jsonl")
    lg = scanlog.ScanLogger(jsonl_path=log)
    assert scanlog.on_card(lambda x: x + 1, 1, h2d=8) == 2   # none open
    with scanlog.Phase(lg, "outer"):
        scanlog.on_card(time.sleep, 0.002, d2h=16)
        with scanlog.Phase(None, "inner"):       # the logger in reach
            scanlog.on_card(time.sleep, 0.01, h2d=32)
    with scanlog.Phase(None, "alone"):           # no span open: no event
        pass
    lg.close()
    ev = {e["phase"]: e for e in _spans(_events(log))}
    assert set(ev) == {"outer", "inner"}
    assert ev["inner"]["parent"] == ev["outer"]["id"]
    assert ev["inner"]["call"] == ev["outer"]["call"] == lg.call
    assert ev["inner"]["wait_s"] >= 0.01 and ev["inner"]["h2d_bytes"] == 32
    assert 0.002 <= ev["outer"]["wait_s"] < 0.01
    assert (ev["outer"]["d2h_bytes"], ev["outer"]["h2d_bytes"]) == (16, 0)


def test_a_second_logger_starts_a_tree_of_its_own(tmp_path):
    a = scanlog.ScanLogger(jsonl_path=str(tmp_path / "a.jsonl"))
    b = scanlog.ScanLogger(jsonl_path=str(tmp_path / "b.jsonl"))
    with scanlog.Phase(a, "outer"):
        with scanlog.Phase(b, "other"):
            pass
    a.close()
    b.close()
    (e,) = _spans(_events(str(tmp_path / "b.jsonl")))
    assert e["parent"] is None and e["call"] == b.call != a.call


def test_console_line_leaves_the_tree_out(capsys):
    lg = scanlog.ScanLogger(quiet=False)
    with scanlog.Phase(lg, "work", items=10):
        pass
    err = capsys.readouterr().err
    assert err.startswith("[phase] phase=work wallclock_s=")
    for k in TREE:
        assert f"{k}=" not in err


def test_host0_alone_writes(tmp_path):
    log = str(tmp_path / "r1.jsonl")
    lg = scanlog.ScanLogger(jsonl_path=log, is_host0=False)
    with scanlog.Phase(lg, "work"):
        scanlog.on_card(lambda: None, h2d=4)
    lg.close()
    assert not (tmp_path / "r1.jsonl").exists()


@pytest.fixture
def tiny():
    return simulate_dataset(n=120, p=600, n_qtl=2, seed=5)


@pytest.mark.parametrize("engine", ["jax", "matfree"])
def test_spans_are_profiler_ranges_while_it_records(tiny, engine, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    log = str(tmp_path / "p.jsonl")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        port.am("y", tiny.geno, {"y": tiny.y}, maxit=1, engine=engine,
                device="cpu", log_jsonl=log)
    ranges = {e.name for e in prof.events()}
    names = {e["phase"] for e in _spans(_events(log))}
    assert names >= {"am", "prep", "sweep"}
    assert {f"phase::{n}" for n in names} <= ranges


@pytest.mark.parametrize("engine", ["jax", "matfree"])
def test_no_range_is_entered_without_a_profiler(tiny, engine, monkeypatch):
    import torch.autograd.profiler as prof
    entered = []
    base = prof.record_function.__enter__

    def counting(self):
        entered.append(self.name)
        return base(self)

    monkeypatch.setattr(prof.record_function, "__enter__", counting)
    res = port.am("y", tiny.geno, {"y": tiny.y}, maxit=1, engine=engine,
                  device="cpu")
    assert res.indices and entered == []
    assert np.isfinite(res.extbic_path).all()
