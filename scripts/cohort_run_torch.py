#!/usr/bin/env python
"""BASELINE config 3 at its true size, 50 000 individuals x 1 000 000
SNPs, on the PyTorch/CUDA port (eagleeverything_tpu_torch), one process on
one card: the port of scripts/cohort_run.py.

  --gen   write the JAX script's cohort byte for byte (seed 7, 8 QTL planted
          in the first 4096 SNPs, blocks of 4096 SNPs, an 8-shard 2-bit
          packed store of 12.5 GB, y.npy and meta.json), never holding the
          50 GB dense matrix: each block's uint16 draws are taken on the
          host (biobank_axes_torch.uint16_draws, held to numpy's own draw),
          turned into genotypes and packed on the card;
  --run   am() of the port on the store (the matrix-free engine, K1/K2/K3
          over the resident 12.5 GB stack), with the scan log, checkpoint
          and resume of the JAX script's run.

and the JAX script's other modes:

  --warm-sweep     one warm sweep at the checkpointed model: the refit and
                   score_sweep_matfree, their walls and stack passes;
  --rescore-truth  under the final model, each planted SNP's t and, for
                   those not selected, the extBIC change its addition gives;
  --pallas-bench   the JAX script set its Pallas kernels against its XLA
                   unpack; the port's two forms are the CUDA kernels and
                   their plain PyTorch versions, so it times kernel_matvec
                   and matfree_stat_rows both ways on the true stack (the
                   plain ones once: they take seconds a call) and reports
                   the gap.

``--pallas`` is accepted and ignored, as EagleConfig.pallas_packed is: the
CUDA kernels are the only packed path on a card. Results (result.json,
warm_sweep.json, cohort_power_check.json, pallas_cohort_bench.json) go to
``--out`` (default ``--dir``), never into docs/, whose files are the
record a run here is held to (docs/cohort50k1m_result_r4.json,
docs/cohort_power_check.json).

Usage (from the root of a checkout; CUDA unless ``--device cpu``):

  python scripts/cohort_run_torch.py --gen --run [--maxit 8]
  python scripts/cohort_run_torch.py --rescore-truth | --warm-sweep |
         --pallas-bench

``--dir`` defaults to $EAGLE_COHORT_DIR, else build/cohort in the
checkout; ``--n``/``--p`` shrink the cohort; ``--maf LO,HI`` draws each
SNP's minor-allele frequency from [LO, HI] in place of [0.05, 0.5] (the
same draws in the same order, so the default stays the JAX script's
cohort byte for byte; a low range raises the kernel's top eigenvalue over
its bulk, as ROADMAP F5's cohorts need), and ``--poly K`` makes every SNP
from K on monomorphic (W = -1: the mean component alone, which raises the
top eigenvalue further). Disk: 12.5 GB for the store.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

BLOCK = 4096      # SNPs a generator block


def _axes():
    """scripts/biobank_axes_torch.py, imported by path (its uint16 draws
    and the card's name)."""
    spec = importlib.util.spec_from_file_location(
        "biobank_axes_torch",
        os.path.join(REPO, "scripts", "biobank_axes_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _where(device: torch.device) -> str:
    return _axes().card() if device.type == "cuda" else "cpu"


def generate(dir: str, n: int, p: int, n_qtl: int = 8, seed: int = 7,
             block: int = BLOCK, device="cpu",
             maf: tuple[float, float] = (0.05, 0.5),
             poly: int | None = None) -> dict:
    """The JAX script's cohort, byte for byte: ``<dir>/store`` (8 packed
    shards and the manifest), ``y.npy`` and ``meta.json`` (whose
    ``gen_seconds`` is this run's). Each block's MAFs and uint16 draws
    come from the host generator in the JAX script's order; the threshold
    comparisons and the pack run on ``device``. Returns the timings."""
    from eagleeverything_tpu_torch.io.genostore import GenotypeStore

    axes = _axes()
    dev = torch.device(device)
    os.makedirs(dir, exist_ok=True)
    store_dir = os.path.join(dir, "store")
    rng = np.random.default_rng(seed)
    # QTL planted in the first block so their columns are kept in memory
    qtl_idx = np.sort(rng.choice(block, size=n_qtl, replace=False))
    axes._check_draws(rng)
    qtl_cols = {}
    draw_s = [0.0]

    def blocks():
        t0 = time.perf_counter()
        for j0 in range(0, p, block):
            b = min(block, p - j0)
            td = time.perf_counter()
            # per-SNP MAF in ``maf`` ([0.05, 0.5]); HWE genotypes 0/1/2
            # from 16-bit thresholds of uint16 draws
            f = rng.uniform(maf[0], maf[1], size=(b, 1))
            if poly is not None:
                # SNPs from ``poly`` on are monomorphic (MAF 0: W = -1)
                f[max(poly - j0, 0):] = 0.0
            t_hom = np.rint(65536.0 * f**2).astype(np.uint16)
            t_het = np.rint(65536.0 * (f**2 + 2 * f * (1 - f))
                            ).astype(np.uint16)
            u = axes.uint16_draws(rng, b * n)
            draw_s[0] += time.perf_counter() - td
            # u < t on the device, as int32 (0..65535)
            ud = torch.from_numpy(u.view(np.int16)).to(dev).view(b, n)
            ud = ud.to(torch.int32) & 0xFFFF
            hom = torch.from_numpy(t_hom.astype(np.int32)).to(dev)
            het = torch.from_numpy(t_het.astype(np.int32)).to(dev)
            blk = (ud < hom).to(torch.int8) + (ud < het).to(torch.int8)
            del ud
            if j0 == 0:
                for q in qtl_idx:
                    qtl_cols[int(q)] = blk[q].cpu().numpy().astype(
                        np.float64)
            if j0 % (block * 32) == 0:
                el = time.perf_counter() - t0
                done = j0 + b
                print(f"[gen] {done}/{p} SNPs ({el:.0f}s, "
                      f"{done / max(el, 1e-9) / 1e3:.1f}k SNPs/s)",
                      flush=True)
            yield j0, blk

    t0 = time.perf_counter()
    GenotypeStore.create_from_snp_blocks(
        store_dir, blocks(), n=n, p=p, n_shards=8, packed=True,
        source=f"cohort-sim-seed{seed}")
    gen_s = time.perf_counter() - t0

    beta = rng.normal(0, 1.0, size=n_qtl) * np.sqrt(0.4 / n_qtl)
    g = sum(beta[i] * (qtl_cols[int(q)] - qtl_cols[int(q)].mean())
            for i, q in enumerate(qtl_idx))
    y = g + rng.normal(0, np.sqrt(max(1e-6, 1.0 - float(np.var(g)))), size=n)
    np.save(os.path.join(dir, "y.npy"), y)
    meta = {"n": n, "p": p, "qtl_indices": [int(q) for q in qtl_idx],
            "beta": beta.tolist(), "seed": seed,
            **({} if tuple(maf) == (0.05, 0.5) else {"maf": list(maf)}),
            **({} if poly is None else {"poly": poly}),
            "gen_seconds": gen_s,
            "store_bytes": sum(
                os.path.getsize(os.path.join(store_dir, f))
                for f in os.listdir(store_dir))}
    with open(os.path.join(dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(f"[gen] done in {gen_s:.0f}s (host draws {draw_s[0]:.0f}s); store "
          f"{meta['store_bytes'] / 1e9:.2f} GB", flush=True)
    return {"gen_s": gen_s, "draw_s": draw_s[0]}


def _cohort_cfg(pallas: str = "off", host_eigh_max_n: int = 32768):
    """The JAX script's engine config for the 50k x 1M scan:
    device_cache_gb=14.5 (the port's gate keeps the 12.5 GB stack on the
    card by its free memory, whatever this says), snp_tile=1024.
    ``pallas`` sets pallas_packed as the JAX script does; the port ignores
    it."""
    from eagleeverything_tpu_torch.utils.config import EagleConfig
    flag = {"on": True, "off": False, "auto": None}[pallas]
    return EagleConfig(host_eigh_max_n=host_eigh_max_n,
                       device_cache_gb=14.5, snp_tile=1024,
                       pallas_packed=flag)


def _load(dir: str) -> tuple[dict, np.ndarray]:
    with open(os.path.join(dir, "meta.json")) as f:
        meta = json.load(f)
    return meta, np.load(os.path.join(dir, "y.npy"))


def _backend(dir: str, meta: dict, pallas: str, dev: torch.device):
    """engine_torch.TiledScan over the cohort's store, as the engine's
    ``am()`` makes it."""
    import eagleeverything_tpu_torch as ep
    from eagleeverything_tpu_torch.models import engine_torch
    handle = ep.GenoHandle(n=meta["n"], p=meta["p"], source="cohort",
                           store_dir=os.path.join(dir, "store"))
    src = engine_torch._make_source(handle, None)
    return engine_torch.TiledScan(src, _cohort_cfg(pallas), dev)


def _write(out: str, name: str, obj: dict) -> str:
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, name)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
    return path


def run(dir: str, maxit: int, engine: str = "matfree",
        host_eigh_max_n: int = 32768, pallas: str = "off", device="cuda",
        out: str = "") -> dict:
    """``am()`` on the cohort with the JAX script's config, scan log
    (``<dir>/scan_log.jsonl``) and checkpoint (``<dir>/ckpt``, resumed
    when it exists); writes ``<out>/result.json`` in the JAX script's
    shape, plus the device, its peak memory and the kernel launches, and
    returns it."""
    import eagleeverything_tpu_torch as ep
    from eagleeverything_tpu_torch.ops import packed

    dev = torch.device(device)
    meta, y = _load(dir)
    handle = ep.GenoHandle(n=meta["n"], p=meta["p"], source="cohort",
                           store_dir=os.path.join(dir, "store"))
    log = os.path.join(dir, "scan_log.jsonl")
    ckpt = os.path.join(dir, "ckpt")
    resumed = os.path.exists(ckpt)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    packed.reset_launches()
    t0 = time.perf_counter()
    res = ep.am("y", handle, {"y": y}, maxit=maxit, engine=engine,
                quiet=False, log_jsonl=log,
                config=_cohort_cfg(pallas, host_eigh_max_n),
                ckpt_dir=ckpt, resume=resumed, device=dev)
    wall = time.perf_counter() - t0
    launches = dict(packed.LAUNCHES)
    result = {
        "config": "BASELINE-3 (50k x 1M, 1 host)" if meta["n"] >= 50000
                  else f"cohort {meta['n']} x {meta['p']}",
        "n": meta["n"], "p": meta["p"], "engine": engine,
        "selected": [int(j) for j in res.indices],
        "qtl_truth": meta["qtl_indices"],
        "extbic_path": [float(v) for v in res.extbic_path],
        "wall_seconds": round(wall, 1),
        "iterations": len(res.extbic_path),
        "device": _where(dev), "resumed": resumed, "launches": launches,
        "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
    }
    _write(out or dir, "result.json", result)
    print(json.dumps(result), flush=True)
    return result


def warm_sweep(dir: str, pallas: str = "on", device="cuda",
               out: str = "") -> dict:
    """One warm sweep at the checkpointed model: the state resumed from
    ``<dir>/ckpt``, the δ-hinted refit, then one full score_sweep_matfree,
    with their walls and stack passes (``backend.stack_passes``). Writes
    ``<out>/warm_sweep.json``."""
    from eagleeverything_tpu_torch.models import bigscan
    from eagleeverything_tpu_torch.utils import checkpoint as ckpt

    dev = torch.device(device)
    meta, y = _load(dir)
    state = ckpt.load_scan_state(os.path.join(dir, "ckpt"))
    if state is None:
        raise FileNotFoundError("no scan checkpoint: run --run first")
    backend = _backend(dir, meta, pallas, dev)
    selected = [int(j) for j in state["selected"]]
    X = np.ones((meta["n"], 1))
    for j in selected:
        X = np.hstack([X, backend.column_f64(j)[:, None]])
    ctx = bigscan.make_context(backend, meta["n"])
    ctx.solve_m, ctx.solve_m_refit = 128, 64

    t0 = time.perf_counter()
    d0 = backend.stack_passes
    fit, sk = bigscan.reml_maximize_matfree(
        ctx, y, X, delta_hint=state.get("delta"), return_sk=True)
    refit_s = time.perf_counter() - t0
    refit_passes = backend.stack_passes - d0

    t1 = time.perf_counter()
    d1 = backend.stack_passes
    t, cand, info = bigscan.score_sweep_matfree(
        ctx, backend, y, X, fit, column_f64=backend.column_f64,
        exclude=selected, sol0=sk.solve(fit.delta) if sk else None)
    sweep_s = time.perf_counter() - t1
    result = {
        "what": "warm steady-state sweep at the checkpointed "
                f"{len(selected)}-marker model ({meta['n']} x {meta['p']})",
        "selected_model": selected,
        "refit_s": round(refit_s, 1), "refit_stack_passes": refit_passes,
        "sweep_s": round(sweep_s, 1),
        "sweep_stack_passes": backend.stack_passes - d1,
        "snps_per_s": round(meta["p"] / sweep_s, 1),
        "candidate": int(cand), "t_cand": float(t[cand]),
        "escalation": info, "pallas": pallas, "device": _where(dev),
    }
    _write(out or dir, "warm_sweep.json", result)
    print(json.dumps(result), flush=True)
    return result


def rescore_truth(dir: str, device="cuda", out: str = "") -> dict:
    """Power cross-check: under the scan's final model (``<out>/result.json``,
    else ``<dir>/result.json``, and the δ of ``<dir>/ckpt``), every planted SNP's exact t and, for
    each one not selected, the extBIC change its addition would give (> 0:
    adding it worsens extBIC, so the stop was the criterion's decision).
    Writes ``<out>/cohort_power_check.json``."""
    from eagleeverything_tpu_torch.models import bigscan, reml_core
    from eagleeverything_tpu_torch.utils import checkpoint as ckptmod

    dev = torch.device(device)
    meta, y = _load(dir)
    path = os.path.join(out or dir, "result.json")
    if not os.path.exists(path):
        path = os.path.join(dir, "result.json")
    with open(path) as f:
        result = json.load(f)
    n, p = meta["n"], meta["p"]
    backend = _backend(dir, meta, "off", dev)
    ctx = bigscan.make_context(backend, n)
    col = backend.column_f64

    selected = [int(j) for j in result["selected"]]
    X = np.ones((n, 1))
    for j in selected:
        X = np.hstack([X, col(j)[:, None]])
    # re-enter the δ search at the scan's checkpointed optimum (the
    # unhinted profile at a multi-marker X can peak at the grid's edge)
    st = ckptmod.load_scan_state(os.path.join(dir, "ckpt"))
    hint = float(st["delta"]) if st is not None and "delta" in st else None
    fit, sk = bigscan.reml_maximize_matfree(ctx, y, X, return_sk=True,
                                            delta_hint=hint)
    ebic_base = reml_core.extbic(fit.loglik, n, p, len(selected), 1.0)

    B = np.column_stack([X, y])
    Sol = ctx.solve_block(fit.delta, B,
                          x0=sk.solve(fit.delta) if sk else None)
    q = X.shape[1]
    HiX, Hiy = Sol[:, :q], Sol[:, q]
    XtHiX = X.T @ HiX
    Py = Hiy - HiX @ np.linalg.solve(XtHiX, X.T @ Hiy)
    XtHiX_inv = np.linalg.inv(XtHiX)

    rows = []
    for j in (int(j) for j in meta["qtl_indices"]):
        w = col(j)
        Hiw = ctx.solve_block(fit.delta, w[:, None])[:, 0]
        ahat = float(w @ Py)
        u = HiX.T @ w
        vara = fit.sigma2_g * max(
            float(w @ Hiw) - float(u @ XtHiX_inv @ u), 1e-12)
        t_j = ahat * ahat / vara if vara > 1e-12 else 0.0
        row = {"snp": j, "selected": j in selected, "t": round(t_j, 3)}
        if j not in selected:
            fit_j = bigscan.reml_maximize_matfree(
                ctx, y, np.hstack([X, w[:, None]]), delta_hint=fit.delta)
            ebic_j = reml_core.extbic(fit_j.loglik, n, p,
                                      len(selected) + 1, 1.0)
            row["extbic_delta_if_added"] = round(ebic_j - ebic_base, 3)
        rows.append(row)
        print(f"[power-check] {row}", flush=True)

    check = {"config": result.get("config"), "n": n, "p": p,
             "selected": selected, "extbic_base": round(ebic_base, 3),
             "delta": fit.delta, "truth_snps": rows, "device": _where(dev),
             "note": "extbic_delta_if_added > 0 means adding that truth "
                     "SNP would WORSEN extBIC: the scan's stop was the "
                     "criterion-correct decision for this trait's power"}
    _write(out or dir, "cohort_power_check.json", check)
    print(json.dumps(check), flush=True)
    return check


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def pallas_bench(dir: str, device="cuda", out: str = "") -> dict:
    """The packed products on the true stack both ways: kernel_matvec (the
    Krylov unit, V (n, 8)) and matfree_stat_rows (the sweep's pass, A (n,
    10), q = 1) through the CUDA kernels (first call, then the median of
    3) and through their plain versions (one call each), with the gaps
    (max |kernel − plain| / max |plain|, the worst of â, u, the diagonal
    and the projection for the stat rows). Writes
    ``<out>/pallas_cohort_bench.json``."""
    from eagleeverything_tpu_torch.models import engine_torch
    from eagleeverything_tpu_torch.ops import packed

    dev = torch.device(device)
    meta, _ = _load(dir)
    n = meta["n"]
    rng = np.random.default_rng(0)
    V = rng.standard_normal((n, 8)).astype(np.float64)
    A = rng.standard_normal((n, 10))
    Minv = np.ones((1, 1))
    scan = _backend(dir, meta, "off", dev)
    if scan.stack_mode != "resident":
        raise RuntimeError(f"the stack does not stay on the card: "
                           f"{scan.stack_info()}")

    def timed(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        val = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return val, time.perf_counter() - t0

    _, up = timed(scan._packed_stack)
    kv, kv_first = timed(lambda: scan.kernel_matvec(V))
    kv_t = [timed(lambda: scan.kernel_matvec(V))[1] for _ in range(3)]
    rows, st_first = timed(lambda: scan.matfree_stat_rows(A, 1, Minv))
    st_t = [timed(lambda: scan.matfree_stat_rows(A, 1, Minv))[1]
            for _ in range(3)]
    kv_plain, kv_plain_s = timed(lambda: scan._to_host(
        packed.kernel_matvec_plain(scan._pstack, scan._to_device(V),
                                   scan._pmeans, n)))
    # the stat rows from the plain K1 on the unpadded A (the kernel's pass
    # pads q to 8 with inert zero columns)
    out_plain, st_plain_s = timed(lambda: scan._to_host(
        engine_torch._stats_from_D_multi(
            packed.packed_dot_plain(scan._pstack, scan._to_device(A),
                                    scan._pmeans, n),
            scan._to_device(Minv[None]), 1, 1)))
    rows_plain = (out_plain[:, 0], out_plain[:, 1:2], out_plain[:, 2],
                  out_plain[:, 3])
    result = {
        "n": n, "p": meta["p"], "device": _where(dev),
        "kernel": {
            "stack_upload_s": round(up, 1),
            "matvec_s_median": round(float(np.median(kv_t)), 3),
            "matvec_first_s": round(kv_first, 1),
            "stats_s_median": round(float(np.median(st_t)), 3),
            "stats_first_s": round(st_first, 1),
            "kv_checksum": float(np.sum(kv)),
            "stats_checksum": float(np.sum(rows[0]))},
        "plain": {
            "matvec_s": round(kv_plain_s, 3),
            "stats_s": round(st_plain_s, 3),
            "kv_checksum": float(np.sum(kv_plain)),
            "stats_checksum": float(np.sum(rows_plain[0]))},
        "matvec_speedup": round(kv_plain_s / float(np.median(kv_t)), 3),
        "stats_speedup": round(st_plain_s / float(np.median(st_t)), 3),
        "kv_rel_err": _rel(kv, kv_plain),
        "stats_rel_err": max(_rel(got, ref)
                             for got, ref in zip(rows, rows_plain)),
    }
    _write(out or dir, "pallas_cohort_bench.json", result)
    print(json.dumps(result), flush=True)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=os.environ.get(
        "EAGLE_COHORT_DIR", os.path.join(REPO, "build", "cohort")))
    ap.add_argument("--out", default="",
                    help="directory of the result files (default --dir)")
    ap.add_argument("--n", type=int, default=50000)
    ap.add_argument("--p", type=int, default=1000000)
    ap.add_argument("--maf", default="0.05,0.5",
                    help="LO,HI: the range of each SNP's minor-allele "
                         "frequency (--gen)")
    ap.add_argument("--poly", type=int, default=None,
                    help="K: SNPs from K on are monomorphic (--gen)")
    ap.add_argument("--gen", action="store_true")
    ap.add_argument("--run", action="store_true")
    ap.add_argument("--maxit", type=int, default=3)
    # matfree is the only engine that fits 50k x 1M on one card; "auto"
    # takes it too (n > matfree_min_n = 32768)
    ap.add_argument("--engine", default="matfree")
    ap.add_argument("--pallas", default="off",
                    choices=["auto", "on", "off"],
                    help="accepted for the JAX script's CLI; ignored")
    ap.add_argument("--pallas-bench", action="store_true",
                    help="the CUDA kernels against their plain versions "
                         "at the true stack size, then exit")
    ap.add_argument("--rescore-truth", action="store_true",
                    help="power cross-check: exact t + extBIC delta of "
                         "every planted truth SNP under the final model")
    ap.add_argument("--warm-sweep", action="store_true",
                    help="one warm steady-state sweep at the checkpointed "
                         "model (wall + stack passes)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu")
    if args.gen or not os.path.exists(os.path.join(args.dir, "meta.json")):
        lo, hi = (float(v) for v in args.maf.split(","))
        generate(args.dir, args.n, args.p, device=args.device, maf=(lo, hi),
                 poly=args.poly)
    if args.pallas_bench:
        pallas_bench(args.dir, args.device, args.out)
        return
    if args.warm_sweep:
        warm_sweep(args.dir, "on" if args.pallas == "auto" else args.pallas,
                   args.device, args.out)
        return
    if args.run:
        run(args.dir, args.maxit, args.engine, pallas=args.pallas,
            device=args.device, out=args.out)
    if args.rescore_truth:
        rescore_truth(args.dir, args.device, args.out)


if __name__ == "__main__":
    main()
