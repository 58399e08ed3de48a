"""A copy of the benchmark at CPU size in a temporary directory: the
committed files, plus a tiny configuration of each engine and a traffic
mix that forces the engine, as a later change would add them."""

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# each tiny cell keeps the limits of the cell whose engine it runs; on the
# CPU kernel_matvec computes its product without packed_tdot, so K2 has no
# launch to judge there
TINY = {
    "tiny_mf": {"n_individuals": 1024, "n_snps": 4608, "maxit": 2,
                "like": "cohort50k", "drop": ("k2_gap",),
                "engine": "matfree"},
    "tiny_ex": {"n_individuals": 1024, "n_snps": 4608, "maxit": 2,
                "like": "cohort26k", "drop": (), "engine": "jax"},
    # am_multi on two traits a call
    "tiny_multi": {"n_individuals": 1024, "n_snps": 4608, "maxit": 2,
                   "like": "cohort50k", "drop": ("k2_gap",),
                   "engine": "matfree", "entry": "am_multi", "traits": 2},
}


def make_root(tmp: Path) -> Path:
    """A checkout-like root at ``tmp``: BENCHMARK.json and the benchmark's
    files, with the cells of TINY (``<name>.scan``) added as new files and
    entries only."""
    root = tmp / "root"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, t in TINY.items():
        base = json.loads(
            (BENCH / "configs" / f"{t['like']}.json").read_text())
        limits = {k: v for k, v in base["limits"].items()
                  if k not in t["drop"]}
        cfg = dict(base, n_individuals=t["n_individuals"],
                   n_snps=t["n_snps"], maxit=t["maxit"], limits=limits,
                   warmup=None)
        (root / "benchmark" / "configs" / f"{name}.json").write_text(
            json.dumps(cfg))
        traffic = json.loads(
            (BENCH / "traffic" / "scan.json").read_text())
        traffic.update(engine=t["engine"], entry=t.get("entry", "am"),
                       traits=t.get("traits", 1))
        (root / "benchmark" / "traffic" / f"scan_{name}.json").write_text(
            json.dumps(traffic))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"benchmark/configs/{name}.json",
                                 "reduced": [], "why": "test"})
        bench["workloads"].append({"name": f"{name}.scan", "config": name,
                                   "traffic": f"scan_{name}", "chips": 1,
                                   "why": "test"})
        like = f"{t['like']}.scan"
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"] = m["workloads"] + [f"{name}.scan"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def harness_on(root: Path):
    """The harness module of the copy at ``root``, importable as the run
    script imports it."""
    for p in (str(root / "benchmark"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import harness
    return harness


def run_tiny(root: Path, cell: str, seed: int = 5, seconds: float = 1.0,
             device: str = "cpu"):
    """One run of ``cell`` (the run script's look for a card skipped):
    (run, result line). A second of window holds at least two calls of
    the tiny exact cell, one of which its check judges."""
    import torch
    harness = harness_on(root)
    c = harness.load_cell(cell, root)
    run = harness.Run(c, seed, seconds, False, torch.device(device))
    run.tmp = harness.new_tmp()
    try:
        out = harness.execute(run, ROOT, 0.0)
    finally:
        harness.cleanup(run.tmp)
    return run, harness.result_line(run, out)
