"""Run one cell of ``BENCHMARK.json`` once: set up, time a window of whole
calls of the program's entry, judge what the window produced against the
plain reference, and build the result line.

Everything that belongs to one configuration, traffic mix, metric or check
is a file of its own, found by name:

- ``BENCHMARK.json`` names the cell's configuration (its ``file``) and
  traffic mix; the mix is ``traffic/<name>.json``;
- each metric that applies to the cell is read by ``metrics/<name>.py``,
  whose ``read(run)`` returns a number, or None when the run has nothing
  for it to read (the metric is then left out of the line); a metric
  ``<base>.<variant>`` with no reader of its own (one quantity, named
  apart for each end-to-end metric it moves) is read by ``<base>.py``;
- each check the configuration lists under ``checks`` is
  ``checks/<name>.py``, a class ``Check(run)`` with ``targets()`` (the
  program's functions to watch in the window), ``listen(name, args,
  out)``, ``observe(call, traits, results)`` after each call,
  ``judge()`` → {number: reading} once the window has closed, and
  ``control()`` → the same readings of the reference in the precision
  below (calibration only). The configuration's ``limits`` hold each
  number's limit: a run is correct when every reading lies at or below it.

The window runs whole calls back to back, one client, each on a fresh
trait, and closes at the end of the first call that ends after
``--seconds``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "eagleeverything_tpu")
PACKAGE = "eagleeverything_tpu_torch"
ENTRIES = ("am", "am_multi")    # the program's entries a traffic mix drives


class Refused(RuntimeError):
    """The run cannot give a result (no card, an unknown cell, a checkout
    without the program, a forbidden import): exit non-zero, print none."""


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, what: str):
    if not path.is_file():
        raise Refused(f"no {what} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(bench_dir: Path, name: str) -> Path:
    """The reader of metric ``name``: ``metrics/<name>.py``, else, for a
    name ``<base>.<variant>``, ``metrics/<base>.py``."""
    own = bench_dir / "metrics" / f"{name}.py"
    if own.is_file() or "." not in name:
        return own
    return bench_dir / "metrics" / f"{name.rsplit('.', 1)[0]}.py"


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict                   # the configuration file, with its name
    traffic: dict               # the traffic file, with its name
    chips: int
    end_to_end: list            # BENCHMARK.json entries that apply
    per_layer: list
    bench_dir: Path

    @property
    def maxit(self) -> int:
        return self.traffic.get("maxit") or self.cfg["maxit"]


def _applies(entry: dict, cell: str, reported: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") is None or entry["moves"] in reported


def load_cell(name: str, root: Path) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its files read."""
    bench = _load_json(root / "BENCHMARK.json")
    work = [w for w in bench["workloads"] if w["name"] == name]
    if not work:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    w = work[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]]
    if not conf:
        raise Refused(f"no configuration {w['config']!r}")
    bench_dir = root / Path(bench["paths"][0])
    cfg = dict(_load_json(root / conf[0]["file"]), name=w["config"])
    traffic = dict(_load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                   name=w["traffic"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, cfg, traffic, int(w["chips"]), e2e, layer, bench_dir)


@dataclasses.dataclass
class Run:
    """What a run measured, as the metric readers and checks see it."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    tmp: str = ""
    cohort: object = None
    setup_s: float = math.nan
    window_s: float = math.nan
    calls: int = 0
    failed: int = 0
    logs: list = dataclasses.field(default_factory=list)  # events a call
    shapes: dict = dataclasses.field(default_factory=dict)
    profile: Optional[dict] = None
    peak_bytes: int = 0
    build: dict = dataclasses.field(default_factory=dict)
    checks: list = dataclasses.field(default_factory=list)
    call_walls: list = dataclasses.field(default_factory=list)
    setup_parts: dict = dataclasses.field(default_factory=dict)
    judge_s: float = math.nan


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (the part before the first dot, compared whole: the port's
    own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def import_program(root: Path):
    """The port, as found inside the checkout at ``root`` and nowhere
    else."""
    try:
        import eagleeverything_tpu_torch as ep
    except ImportError as e:
        raise Refused(f"the program is not in this checkout: {e}") from e
    where = Path(ep.__file__).resolve()
    if root.resolve() not in where.parents:
        raise Refused(f"{PACKAGE} was imported from {where}, outside the "
                      f"checkout {root}")
    return ep


def _sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _warm(run: Run, ep, torch) -> None:
    """One small call of the cell's entry on the cell's engine, on a small
    cohort of the same recipe (``warmup`` in the configuration): loads the
    kernels and the device libraries and imports what the first call
    would, so that the window's first call does what the others do."""
    import cohort as cohort_mod
    w = run.cell.cfg.get("warmup")
    if not w:
        return
    cfg = dict(run.cell.cfg, n_individuals=w["n_individuals"],
               n_snps=w["n_snps"])
    store = os.path.join(run.tmp, "warmup")
    c, handle = cohort_mod.make(cfg, run.seed, run.device, store)
    ep.am("y", handle, {"y": c.trait(0)}, maxit=1, engine=w["engine"],
          device=run.device)
    _sync(torch, run.device)
    shutil.rmtree(store, ignore_errors=True)


def _call(run: Run, ep, handle, traits: list, log: str) -> list:
    """One call of the traffic's entry; its results, one a trait."""
    tr = run.cell.traffic
    kw = dict(maxit=run.cell.maxit, lam=tr.get("lam", 1.0),
              engine=tr.get("engine", "auto"), log_jsonl=log,
              device=run.device)
    if tr["entry"] == "am":
        return [ep.am("y", handle, {"y": traits[0]}, **kw)]
    names = [f"y{i}" for i in range(len(traits))]
    out = ep.am_multi(names, handle, dict(zip(names, traits)), **kw)
    return [out[t] for t in names]


def _read_log(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def execute(run: Run, root: Path, t_start: float) -> dict:
    """Set up, run the window, judge it. Returns {"metrics", "checks",
    "device", "breakdown"}; ``t_start`` is the process's start on the host
    clock, where set-up begins."""
    import torch

    import cohort as cohort_mod
    import recorder
    import tracing

    cell = run.cell
    if cell.traffic["entry"] not in ENTRIES:
        raise Refused(f"unknown entry {cell.traffic['entry']!r}")
    ep = import_program(root)
    cuda = torch.device(run.device).type == "cuda"
    parts = run.setup_parts
    parts["start"] = time.perf_counter() - t_start
    if cuda:
        from eagleeverything_tpu_torch.ops import build
        t0 = time.perf_counter()
        run.build = {k: v["seconds"] for k, v in build.build_all().items()}
        run.build["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run.cohort, handle = cohort_mod.make(cell.cfg, run.seed, run.device,
                                         os.path.join(run.tmp, "store"))
    parts["cohort"] = time.perf_counter() - t0
    checks = run.checks = [
        _module(cell.bench_dir / "checks" / f"{c}.py", "check").Check(run)
        for c in cell.cfg["checks"]]
    t0 = time.perf_counter()
    _warm(run, ep, torch)
    parts["warmup"] = time.perf_counter() - t0
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - t_start

    listeners = [c.listen for c in checks]
    targets = {}
    for c in checks:
        targets.update(c.targets())
    if run.trace:
        from eagleeverything_tpu_torch.ops import kernels, packed
        shapes = recorder.Shapes()
        listeners.append(shapes)
        for name in ("packed_dot", "packed_tdot"):
            targets[name] = (packed, name)
        for name in ("mmt_accumulate", "eig_T_tile"):
            targets[name] = (kernels, name)
    traits_a_call = cell.traffic.get("traits", 1)
    window = (tracing.Window(torch, os.path.join(run.tmp, "trace.json"))
              if run.trace and cuda else None)
    with contextlib.ExitStack() as stack:
        stack.enter_context(recorder.Calls(targets, listeners,
                                           ranges=window is not None))
        if window:
            stack.enter_context(recorder.PhaseRanges())
            stack.enter_context(window)
        t0 = time.perf_counter()
        while True:
            k = run.calls
            traits = [run.cohort.trait(k, i) for i in range(traits_a_call)]
            log = os.path.join(run.tmp, f"scan_{k}.jsonl")
            t_call = time.perf_counter()
            try:
                results = _call(run, ep, handle, traits, log)
            except Exception:       # a failed call is counted, not fatal
                traceback.print_exc()
                run.failed += 1
                results = None
            _sync(torch, run.device)
            run.call_walls.append(time.perf_counter() - t_call)
            run.calls += 1
            for c in checks:
                c.observe(k, traits, results)
            if time.perf_counter() - t0 >= run.seconds:
                break
        run.window_s = time.perf_counter() - t0
    if cuda:
        run.peak_bytes = int(torch.cuda.max_memory_allocated())
    run.logs = [_read_log(os.path.join(run.tmp, f"scan_{k}.jsonl"))
                for k in range(run.calls)]
    if run.trace:
        run.shapes = shapes.calls
        if window:
            run.profile = tracing.summarize(window.path, window.wall_s)
            os.remove(window.path)
            if run.profile["busy_s"] is None:
                raise Refused("the profiler recorded no device activity")

    del handle
    if cuda:
        torch.cuda.empty_cache()
    numbers = {}
    limits = cell.cfg["limits"]
    t0 = time.perf_counter()
    for c in checks:
        for key, value in c.judge().items():
            numbers[key] = {"value": float(value), "limit": limits[key]}
    run.judge_s = time.perf_counter() - t0

    metrics = {}
    for m in (cell.per_layer if run.trace else cell.end_to_end):
        value = _module(reader_path(cell.bench_dir, m["name"]),
                        "metric reader").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": (torch.cuda.get_device_name(run.device) if cuda
                       else "cpu"),
              "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    out = {"metrics": metrics, "checks": numbers, "device": device}
    if run.profile:
        device["busy_s"] = run.profile["busy_s"]
        device["window_s"] = run.profile["window_s"]
        out["breakdown"] = {"device_ops": run.profile["device_ops"],
                            "idle_gaps": run.profile["idle_gaps"]}
    return out


def result_line(run: Run, out: dict) -> dict:
    """The result's JSON object; the numbers compared come last."""
    correct = run.failed == 0 and run.calls > 0 and all(
        v["value"] <= v["limit"] for v in out["checks"].values())
    line = {"correct": correct, "attempted": run.calls, "failed": run.failed,
            "metrics": out["metrics"], "device": out["device"]}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["compared"] = {k: [v["value"], v["limit"]]
                        for k, v in out["checks"].items()}
    return line


def new_tmp() -> str:
    """A directory for this run's store, scan logs and trace, under the
    run's own TMPDIR; removed when the run ends."""
    return tempfile.mkdtemp(prefix="eagle-bench-")


def cleanup(tmp: str) -> None:
    shutil.rmtree(tmp, ignore_errors=True)


def describe(line: dict) -> str:
    """The numbers compared, one a line, beside their limits."""
    return "\n".join(f"compared {k}: {v[0]!r} (limit {v[1]!r})"
                     for k, v in line["compared"].items())


