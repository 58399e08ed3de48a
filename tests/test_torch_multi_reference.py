"""``am_multi``'s lockstep matrix-free scan held to the plain reference of
its semantics on the CPU: each trait of a call gets the fits that a
single-trait scan of that trait alone would make along the same
selections. The reference is the benchmark's (``benchmark/reference_mf.py``
applied trait by trait, ``benchmark/checks/multi_fit.py``: plain torch f64
on its own genotype draws, no kernel of the port). Also: the selections of
four single-trait scans, the traits' slots, the lockstep path's spans and
counters, and results that do not depend on whether the spans are
recorded."""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import eagleeverything_tpu_torch as port  # noqa: E402
from eagleeverything_tpu_torch.utils.config import EagleConfig  # noqa: E402

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

import cohort  # noqa: E402


def _multi_fit():
    spec = importlib.util.spec_from_file_location(
        "bench_checks_multi_fit", BENCH / "checks" / "multi_fit.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SEED = 2**31 + 20
R, MAXIT = 4, 3
NAMES = [f"y{i}" for i in range(R)]
# the limits the card's comparison (multi50k.traits4) holds the program
# to: the same numbers, here on the CPU's plain products
LIMITS = json.loads((BENCH / "configs" / "multi50k.json").read_text())[
    "limits"]


def _cfg():
    base = json.loads((BENCH / "configs" / "multi50k.json").read_text())
    return dict(base, name="multi_ref", n_individuals=1024, n_snps=4608)


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    """The cohort (multi50k's recipe at 1 024 × 4 608), its handle, the
    four traits of call 0, and one logged am_multi call over them."""
    cfg = _cfg()
    d = tmp_path_factory.mktemp("multi_ref")
    coh, handle = cohort.make(cfg, SEED, "cpu", str(d / "store"))
    ys = [coh.trait(0, i) for i in range(R)]
    log = str(d / "scan.jsonl")
    res = port.am_multi(NAMES, handle, dict(zip(NAMES, ys)), maxit=MAXIT,
                        engine="matfree", device="cpu", log_jsonl=log)
    with open(log) as f:
        events = [json.loads(ln) for ln in f if ln.strip()]
    return {"cfg": cfg, "cohort": coh, "handle": handle, "ys": ys,
            "res": res, "events": events, "dir": d}


def _same(a, b):
    """Two results equal bit for bit: selections, extBIC and LL paths,
    every sweep's statistics, the final fit."""
    assert list(a.indices) == list(b.indices)
    assert list(a.extbic_path) == list(b.extbic_path)
    assert list(a.loglik_path) == list(b.loglik_path)
    assert len(a.outlier_stats) == len(b.outlier_stats)
    for s, t in zip(a.outlier_stats, b.outlier_stats):
        assert np.array_equal(s, t)
    assert (a.delta, a.sigma2_g) == (b.delta, b.sigma2_g)


def test_each_trait_matches_the_plain_reference(cell):
    mf = _multi_fit()
    res = [cell["res"][t] for t in NAMES]
    sels = [list(r.indices) for r in res]
    planted = {int(q) for q in cell["cohort"].qtl}
    for sel in sels:
        assert len(sel) == MAXIT and set(sel) <= planted
    ref = mf.reference_scans(cell["cfg"], SEED, "cpu", cell["ys"], sels,
                             1.0)
    for r, want in zip(res, ref):
        t = [float(r.outlier_stats[i][j]) for i, j in enumerate(r.indices)]
        assert mf.path_gap(r.extbic_path, want["extbic_path"]) \
            <= LIMITS["multi_extbic_gap"]
        assert mf.rel_gap(t, want["t"]) <= LIMITS["multi_t_gap"]
    # a trait's results in another trait's slot do not pass
    swapped = mf.path_gap(res[1].extbic_path, ref[0]["extbic_path"])
    assert swapped > 10 * LIMITS["multi_extbic_gap"]


@pytest.fixture(scope="module")
def singles(cell):
    """Each trait scanned alone by ``am()`` on the same engine, with its
    scan log."""
    out = []
    for i, y in enumerate(cell["ys"]):
        log = str(cell["dir"] / f"single_{i}.jsonl")
        res = port.am("y", cell["handle"], {"y": y}, maxit=MAXIT,
                      engine="matfree", device="cpu", log_jsonl=log)
        with open(log) as f:
            out.append((res, [json.loads(ln) for ln in f if ln.strip()]))
    return out


def test_selections_equal_four_single_trait_scans(cell, singles):
    for name, (one, _) in zip(NAMES, singles):
        got = cell["res"][name]
        assert list(got.indices) == list(one.indices)
        # the union basis is the single-trait basis column by column and
        # every value is polished by an exact CG solve to 1e-8
        np.testing.assert_allclose(got.extbic_path, one.extbic_path,
                                   rtol=1e-7)


def test_permuting_the_traits_permutes_the_results(cell):
    order = [2, 0, 3, 1]
    names = [NAMES[i] for i in order]
    res = port.am_multi(names, cell["handle"],
                        {NAMES[i]: cell["ys"][i] for i in order},
                        maxit=MAXIT, engine="matfree", device="cpu")
    for name in NAMES:
        a, b = res[name], cell["res"][name]
        assert a.trait_name == b.trait_name == name
        assert list(a.indices) == list(b.indices)
        np.testing.assert_allclose(a.extbic_path, b.extbic_path, rtol=1e-7)


def _spans(events):
    return [e for e in events if e.get("event") == "phase"]


def test_the_lockstep_spans_and_counters(cell):
    spans = _spans(cell["events"])
    by_id = {e["id"]: e for e in spans}

    def parent(e):
        return by_id[e["parent"]]["phase"]

    union = [e for e in spans if e["phase"] == "union_basis"]
    # one in the initial fits (4 traits × [1 y] at depth 128), one a refit
    # (4 × [1 w y], [1 w w y] at 64)
    assert [parent(e) for e in union] == ["reml"] + ["refit"] * MAXIT
    assert [(e["cols"], e["m"], e["cached"]) for e in union] == [
        (8, 128, True), (12, 64, True), (16, 64, True), (20, 64, True)]
    for e in union:
        inner = [s["phase"] for s in spans if s["parent"] == e["id"]]
        assert inner == ["krylov_basis"]
    fits = [e for e in spans if e["phase"] == "trait_fit"]
    assert len(fits) == R * (1 + MAXIT)
    assert [e["trait"] for e in fits] == list(range(R)) * (1 + MAXIT)
    assert {parent(e) for e in fits} == {"reml", "refit"}
    for e in fits:
        inner = {s["phase"] for s in spans if s["parent"] == e["id"]}
        assert inner == {"delta_search", "polish"}
    stat = [e for e in spans if e["phase"] == "stat_pass"]
    assert len(stat) == MAXIT and {parent(e) for e in stat} == {"sweep"}
    assert all((e["cols"], e["traits"], e["launches"]) == (4 * 137, R, 1)
               for e in stat)
    root = next(e for e in spans if e["parent"] is None)
    assert root["phase"] == "am_multi"


def test_the_single_trait_scan_logs_none_of_them(singles):
    """A single-trait scan is the lockstep loop at R = 1: its spans and
    counters count its one trait, none of another: a union basis of its
    own [X y] block an initial fit and a refit, trait 0's fits, one-trait
    stat passes."""
    spans = _spans(singles[0][1])
    union = [e for e in spans if e["phase"] == "union_basis"]
    assert [(e["cols"], e["m"]) for e in union] == [(2, 128), (3, 64),
                                                    (4, 64), (5, 64)]
    fits = [e for e in spans if e["phase"] == "trait_fit"]
    assert [e["trait"] for e in fits] == [0] * (1 + MAXIT)
    stat = [e for e in spans if e["phase"] == "stat_pass"]
    assert len(stat) == MAXIT
    assert all((e["cols"], e["traits"], e["launches"]) == (137, 1, 1)
               for e in stat)


def test_a_union_block_over_the_budget_falls_back(cell, tmp_path):
    """Two traits under a cache budget below their union block (4 columns
    × 128 steps × n f64, 4.2 MB here; 6 × 64 × n, 3.1 MB, at a refit)
    and above one trait's (2.1 MB): no union basis is built, each trait's
    fit builds a basis of its own, and the selections stand."""
    log = str(tmp_path / "small.jsonl")
    names = NAMES[:2]
    res = port.am_multi(names, cell["handle"],
                        dict(zip(names, cell["ys"])), maxit=1,
                        engine="matfree", device="cpu", log_jsonl=log,
                        config=EagleConfig(matfree_cache_gb=2.5e-3))
    with open(log) as f:
        spans = _spans([json.loads(ln) for ln in f if ln.strip()])
    by_id = {e["id"]: e for e in spans}
    union = [e for e in spans if e["phase"] == "union_basis"]
    assert [(e["cols"], e["cached"]) for e in union] == [(4, False),
                                                        (6, False)]
    assert not [s for s in spans for u in union if s["parent"] == u["id"]]
    own = [e for e in spans if e["phase"] == "krylov_basis"
           and by_id[e["parent"]]["phase"] == "trait_fit"]
    assert len(own) == 2 * len(names)
    for name in names:
        assert list(res[name].indices) == list(
            cell["res"][name].indices[:1])


def test_results_do_not_depend_on_the_spans(cell):
    """The spans logged (as a run with tracing off logs them), logged with
    the profiler recording (each span then opens a profiler range), and
    not logged at all: the results are equal bit for bit, and so are the
    stack passes counted."""
    kw = dict(maxit=1, engine="matfree", device="cpu")
    traits = dict(zip(NAMES, cell["ys"]))
    logs = [str(cell["dir"] / f"{k}.jsonl") for k in ("off", "on")]
    off = port.am_multi(NAMES, cell["handle"], traits, log_jsonl=logs[0],
                        **kw)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        on = port.am_multi(NAMES, cell["handle"], traits, log_jsonl=logs[1],
                           **kw)
    bare = port.am_multi(NAMES, cell["handle"], traits, **kw)
    for name in NAMES:
        _same(on[name], off[name])
        _same(bare[name], off[name])
    passes = []
    for log in logs:
        with open(log) as f:
            passes.append([json.loads(ln)["total"] for ln in f
                           if '"stack_passes"' in ln])
    assert passes[0] == passes[1] and len(passes[0]) == 1
