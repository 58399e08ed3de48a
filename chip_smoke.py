#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (eagleeverything_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py [--p 262144] [--seed 7]

Phases, each fatal when its check fails:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the hand-written CUDA kernels from ops/csrc (nvcc, sm_90a); this
   also fails when a kernel's ptxas report shows spilled registers or is
   missing;
3. hold each kernel against its plain PyTorch version on the card at ragged
   shapes (SHAPES_RAGGED: n no multiple of 16, p no multiple of anything,
   one shape with a single split of packed_tdot; r ∈ WIDTHS_RAGGED, every
   column tiling and its edge; 3% missing codes, one all-missing SNP), and
   packed_dot and packed_tdot each against itself bit for bit;
4. at the main path's shapes (50 000 individuals × 262 144 SNPs, r ∈
   WIDTHS_MAIN): check each kernel against its plain version again and time it
   (CUDA events, median of 10) beside its bound, its plain version and one
   ``torch.matmul`` on the unpacked f32 W (a yardstick the port never
   calls);
5. a small parity check: ``am(engine="matfree")`` at n = 2000, p = 20 000
   on the card and on the CPU must select the same SNPs;
6. the main path as a user runs it: ``am(engine="auto")`` on a cohort of
   50 000 × p generated on the card from ``--seed`` (50 000 >
   matfree_min_n, so auto takes the matrix-free engine), with the kernels' launch counts read
   around exactly that call; every selected SNP must be a planted QTL;
7. a summary line per kernel and the kernels' JSON line, then the last
   line ``{"ok": true, "device": {...}}``.

Without CUDA, or outside a checkout, it exits non-zero with no result line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N = 50000            # BASELINE config 3's individuals: the main path's n
P_KERNELS = 262144   # SNP rows of the kernel timing phase
# operand widths the main path launches: 2 (shifted Lanczos on [X y]), 8
# (CG blocks padded to 8), 16 (the s0 estimate), 32 (the logdet probe
# Lanczos), 64 and ~137 (probe Lanczos and stat rows); between them they
# take every column tiling of both kernels (N = 8, 16, 32, 64 and 144,
# mma_tile_width in packed_common.cuh) with the split count of packed_tdot
# that goes with each
WIDTHS_MAIN = (2, 8, 16, 32, 64, 137)
# and the edges of every column tiling: one column past a tile (9, 17, 33,
# 65, 145: 145 takes two 144-wide tiles of packed_tdot) and a full one (144)
WIDTHS_RAGGED = (1, 2, 8, 9, 16, 17, 32, 33, 64, 65, 137, 144, 145)
# (n, p) of the ragged phase: n no multiple of 16 with a short last
# genotype tile, p no multiple of the 32-row k-step; p = 201 < 256 rows
# gives packed_tdot a single split (no reduce launch)
SHAPES_RAGGED = ((1001, 20011), (50000, 3001), (50000, 201))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense bf16 on the tensor
# cores (both kernels run their products there)
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS_PER_S = 989e12
# kernel vs plain version, as max |kernel − plain| / max |plain|: both are
# fp32 sums of up to 262 144 terms taken in different orders; the rounding
# of such a sum is ~√K·2⁻²⁴ of its scale (≈3e-5 at K = 262 144, worst
# case), and packed_tdot's bf16x3 products add about 2⁻¹⁷ of each term
# (tests/test_torch_packed.py::test_bf16_split_numerics emulates both),
# so 1e-4 passes every correct kernel and fails any wrong term
TOL = 1e-4
KERNELS = {
    "packed_dot": {
        "source": "eagleeverything_tpu_torch/ops/csrc/packed_dot.cu",
        "replaces": "eagleeverything_tpu/ops/pallas_packed.py:142"},
    "packed_tdot": {
        "source": "eagleeverything_tpu_torch/ops/csrc/packed_tdot.cu",
        "replaces": "eagleeverything_tpu/ops/pallas_packed.py:203"},
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def random_stack(torch, packed, n: int, p: int, seed: int, dev,
                 chunk: int = 4096):
    """A packed stack (p, nw) of random codes made on the card: 3% missing,
    SNP 0 all missing, the store's code-0 pad genotypes in each row's last
    real byte and 0x55 pad bytes after it. Returns (stack, means)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    nw = packed.words_per_row(n)
    nb = -(-n // 4)
    stack = torch.empty((p, nw), dtype=torch.int32, device=dev)
    for i0 in range(0, p, chunk):
        rows = min(chunk, p - i0)
        codes = torch.full((rows, nw * 16), 1, dtype=torch.uint8, device=dev)
        codes[:, n : nb * 4] = 0
        c = torch.randint(0, 3, (rows, n), generator=gen, device=dev,
                          dtype=torch.uint8)
        c[torch.rand((rows, n), generator=gen, device=dev) < 0.03] = 3
        codes[:, :n] = c
        if i0 == 0:
            codes[0, :n] = 3
        q = codes.view(rows, nw * 4, 4)
        byts = q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) \
            | (q[..., 3] << 6)
        stack[i0 : i0 + rows] = byts.contiguous().view(torch.int32)
    return stack, packed.row_means(stack, n)


def rel_err(torch, got, ref) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|)."""
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    return err, err / max(scale, 1e-30)


def timed(torch, fn, reps: int, warmup: int):
    """(last output, median ms) over ``reps`` calls of fn, each between two
    CUDA events, after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return out, float(np.median(times))


def bound(kind: str, n: int, p: int, r: int,
          nw: int) -> tuple[float, str, str]:
    """Least time (ms) the card could take for the work, whether bytes or
    operations bound it, and the unit that sets it: each input read once
    and each output written once over the HBM rate, against the function's
    own 2·p·n·r FLOPs as one dense bf16 product at the tensor cores' peak.

    That is the least any tensor-core route could do, though fp32 accuracy
    needs the skinny operand split into bf16 pieces: packed_tdot executes
    three products (W_hi·T_0, W_hi·T_1 and W_lo·T_0, whose W_lo is zero
    except at missing codes) and packed_dot four (A in three pieces);
    :func:`executed_flops` counts those. kernel_matvec is the two launches
    in turn, so its bound is the sum of theirs."""
    if kind == "kernel_matvec":
        parts = [bound(k, n, p, r, nw) for k in ("packed_dot", "packed_tdot")]
        return (sum(b[0] for b in parts),
                " + ".join(b[1] for b in parts),
                " + ".join(b[2] for b in parts))
    stack, means = p * nw * 4, p * 4
    nbytes = stack + means + (n + p) * r * 4   # A→D or T→out: (n+p)·r f32
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * p * n * r / BF16_TC_FLOPS_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", "bf16 tensor cores"
    return t_bytes, "bytes", "HBM"


def executed_flops(kind: str, n: int, p: int, r: int) -> int:
    """FLOPs the kernel executes, beside the function's 2·p·n·r of the
    bound: packed_dot runs four dense bf16 products, packed_tdot three."""
    if kind == "kernel_matvec":
        return sum(executed_flops(k, n, p, r)
                   for k in ("packed_dot", "packed_tdot"))
    return (4 if kind == "packed_dot" else 3) * 2 * p * n * r


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def card_phase(torch) -> str:
    phase("1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip() != "",
          f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"python {sys.version.split()[0]}", flush=True)
    return card


def build_phase(build) -> None:
    phase("2. build the CUDA kernels (nvcc, sm_90a, one process a source)")
    t0 = time.perf_counter()
    report = build.build_all()
    for name in build.SOURCES:
        build.load(name)
        rep = report[name]
        lines = [ln.strip() for ln in rep["ptxas"].splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln]
        print(f"{name}: " + ("reused, ptxas report of its build"
                             if rep["reused"] else
                             f"nvcc {rep['seconds']:.1f} s"))
        for ln in lines:
            print(f"  {ln}")
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill",
                                             rep["ptxas"])]
        check(spills and not any(spills),
              f"{name}: ptxas reports spilled registers, or no report")
    print(f"build wall {time.perf_counter() - t0:.1f} s", flush=True)


def ragged_phase(torch, packed, dev, seed: int) -> dict:
    phase("3. kernels vs plain versions at ragged shapes "
          f"(tolerance {TOL:g} of the plain result's scale)")
    worst = {k: 0.0 for k in ("packed_dot", "packed_tdot", "kernel_matvec")}
    for n, p in SHAPES_RAGGED:
        stack, means = random_stack(torch, packed, n, p, seed + n, dev)
        check(means[0].item() == 1.0, "all-missing SNP must get mean 1.0")
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        for r in WIDTHS_RAGGED:
            A = torch.randn((n, r), generator=gen, device=dev)
            T = torch.randn((p, r), generator=gen, device=dev)
            D = packed.packed_dot(stack, A, means, n)
            D_again = packed.packed_dot(stack, A, means, n)
            out = packed.packed_tdot(stack, T, means, n)
            again = packed.packed_tdot(stack, T, means, n)
            torch.cuda.synchronize()
            check(not D[0].any().item(), "all-missing SNP row must be 0")
            check(torch.equal(D, D_again),
                  f"packed_dot not bitwise repeatable at n={n} r={r}")
            check(torch.equal(out, again),
                  f"packed_tdot not bitwise repeatable at n={n} r={r}")
            cases = (
                ("packed_dot", D, packed.packed_dot_plain(stack, A, means, n)),
                ("packed_tdot", out,
                 packed.packed_tdot_plain(stack, T, means, n)),
                ("kernel_matvec", packed.kernel_matvec(stack, A, means, n),
                 packed.kernel_matvec_plain(stack, A, means, n)))
            for name, got, ref in cases:
                err, rel = rel_err(torch, got, ref)
                worst[name] = max(worst[name], rel)
                print(f"{name:14s} n={n:6d} p={p:6d} r={r:4d}  max abs err "
                      f"{err:.3e}  rel {rel:.3e}")
                check(rel <= TOL, f"{name} disagrees with its plain version "
                      f"at n={n} p={p} r={r}: rel {rel:.3e} > {TOL:g}")
        del stack, means
    torch.cuda.empty_cache()
    return worst


def timing_phase(torch, packed, dev, n: int, p: int, seed: int) -> dict:
    phase(f"4. kernels at the main path's shapes: n={n}, p={p} "
          "(CUDA events: kernels and torch.matmul median of 10, plain "
          "versions median of 3; bound from the H100 SXM data sheet: "
          "3.35 TB/s HBM against the function's 2·p·n·r FLOPs at 989 "
          "TFLOP/s on the bf16 tensor cores, for both kernels)")
    stack, means = random_stack(torch, packed, n, p, seed, dev)
    nw = stack.shape[1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    widths = WIDTHS_MAIN
    ops = {
        "packed_dot": (lambda X: packed.packed_dot(stack, X[0], means, n),
                       lambda X: packed.packed_dot_plain(stack, X[0], means,
                                                         n)),
        "packed_tdot": (lambda X: packed.packed_tdot(stack, X[1], means, n),
                        lambda X: packed.packed_tdot_plain(stack, X[1],
                                                           means, n)),
        "kernel_matvec": (
            lambda X: packed.kernel_matvec(stack, X[0], means, n),
            lambda X: packed.kernel_matvec_plain(stack, X[0], means, n)),
    }
    res = {name: {} for name in ops}
    outs = {}
    inputs = {r: (torch.randn((n, r), generator=gen, device=dev),
                  torch.randn((p, r), generator=gen, device=dev))
              for r in widths}
    for r in widths:
        X = inputs[r]
        for name, (kern, plain) in ops.items():
            k_out, k_ms = timed(torch, lambda: kern(X), 10, 2)
            p_out, p_ms = timed(torch, lambda: plain(X), 3, 0)
            err, rel = rel_err(torch, k_out, p_out)
            check(rel <= TOL, f"{name} disagrees with its plain version at "
                  f"n={n} p={p} r={r}: rel {rel:.3e} > {TOL:g}")
            b_ms, b_by, b_unit = bound(name, n, p, r, nw)
            res[name][r] = {"max_abs_err": err, "rel_err": rel, "ms": k_ms,
                            "plain_ms": p_ms, "bound_ms": b_ms,
                            "bound_by": b_by, "bound_unit": b_unit,
                            "executed_tflops": executed_flops(name, n, p, r)
                            / k_ms / 1e9}
            outs[name, r] = k_out
            del p_out
    # the yardstick: one torch.matmul on the already-unpacked f32 W
    # (p·n·4 bytes on the card; the port itself never holds it)
    W = torch.empty((p, n), dtype=torch.float32, device=dev)
    step = 4096
    for i0 in range(0, p, step):
        W[i0 : i0 + step] = packed.recode(stack[i0 : i0 + step],
                                          means[i0 : i0 + step], n)
    lib = {"packed_dot": lambda X: torch.matmul(W, X[0]),
           "packed_tdot": lambda X: torch.matmul(W.T, X[1]),
           "kernel_matvec": lambda X: torch.matmul(W.T,
                                                   torch.matmul(W, X[0]))}
    for r in widths:
        for name, fn in lib.items():
            l_out, l_ms = timed(torch, lambda: fn(inputs[r]), 10, 1)
            err, rel = rel_err(torch, l_out, outs[name, r])
            check(rel <= TOL, f"torch.matmul and {name} disagree at r={r}: "
                  f"rel {rel:.3e}")
            res[name][r]["library_ms"] = l_ms
    del W, stack, means, inputs, outs
    torch.cuda.empty_cache()
    for name, by_r in res.items():
        for r, m in by_r.items():
            print(f"{name:14s} r={r:4d}  kernel {m['ms']:9.3f} ms  plain "
                  f"{m['plain_ms']:9.3f} ms  torch.matmul on f32 W "
                  f"{m['library_ms']:9.3f} ms  bound {m['bound_ms']:8.3f} ms "
                  f"({m['bound_by']} on {m['bound_unit']}, "
                  f"{m['bound_ms'] / m['ms']:.1%} of it)  executes "
                  f"{m['executed_tflops']:.1f} TFLOP/s  "
                  f"max abs err {m['max_abs_err']:.2e}", flush=True)
    return res


def read_log(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def parity_phase(torch, ep, tmp: str, seed: int, dev) -> None:
    from eagleeverything_tpu_torch.data.simulate import simulate_cohort
    n, p = 2000, 20000
    phase(f"5. parity: am(engine='matfree') at n={n}, p={p} on cuda and cpu")
    c = simulate_cohort(os.path.join(tmp, "parity"), n=n, p=p, seed=seed,
                        device=dev)
    h = ep.GenoHandle(n=n, p=p, source="parity", store_dir=c.store_dir)
    out = {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out[d] = ep.am("y", h, {"y": c.y}, maxit=3, engine="matfree",
                       device=d)
        print(f"{d}: indices {out[d].indices}  extBIC "
              f"{[round(v, 4) for v in out[d].extbic_path]}  "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(out["cuda"].indices == out["cpu"].indices,
          "cuda and cpu selections differ")
    check(len(out["cuda"].indices) >= 1, "the parity scan selected nothing")
    check(np.allclose(out["cuda"].extbic_path, out["cpu"].extbic_path,
                      rtol=1e-3, atol=0.0),
          "cuda and cpu extBIC paths differ beyond rtol 1e-3")


def main_path_phase(torch, ep, packed, tmp: str, n: int, p: int, seed: int,
                    dev) -> dict:
    from eagleeverything_tpu_torch.data.simulate import simulate_cohort
    phase(f"6. main path: am(engine='auto') on a generated cohort of {n} x "
          f"{p} (seed {seed}, 8 planted QTL)")
    t0 = time.perf_counter()
    c = simulate_cohort(os.path.join(tmp, "cohort"), n=n, p=p, n_qtl=8,
                        seed=seed, device=dev)
    print(f"cohort written in {time.perf_counter() - t0:.1f} s; planted QTL "
          f"{c.qtl_idx.tolist()}", flush=True)
    stack_gb = p * packed.words_per_row(n) * 4 / 1e9
    log = os.path.join(tmp, "scan.jsonl")
    handle = ep.GenoHandle(n=n, p=p, source="cohort", store_dir=c.store_dir)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    packed.reset_launches()
    t0 = time.perf_counter()
    res = ep.am("y", handle, {"y": c.y}, maxit=3, engine="auto",
                log_jsonl=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(packed.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    events = read_log(log)
    for e in events:
        if e["event"] == "phase":
            print(f"  phase {e['phase']:8s} {e['wallclock_s']:9.2f} s")
        elif e["event"] == "iteration":
            print(f"  iteration {e['it']}: candidate {e['candidate']} t "
                  f"{e['t_max']:.1f} extBIC {e['extbic']:.3f} accepted "
                  f"{e['accepted']}")
        elif e["event"] == "stack_passes":
            print(f"  stack passes {e['total']}")
    print(f"selected {res.indices} (planted {c.qtl_idx.tolist()})")
    print(f"extBIC path {res.extbic_path}")
    print(f"am() wall {wall:.1f} s; launches {launches}; peak device memory "
          f"{peak / 1e9:.2f} GB (stack {stack_gb:.2f} GB)", flush=True)
    check(len(res.indices) >= 1, "the main-path scan selected nothing")
    check(set(res.indices) <= set(int(q) for q in c.qtl_idx),
          f"selected SNPs {res.indices} are not all planted QTL")
    check(all(math.isfinite(v) for v in res.extbic_path),
          "non-finite extBIC on the main path")
    for name in KERNELS:
        check(launches[name] >= 1,
              f"{name} was never launched on the main path")
    return {"launches": launches, "wall_s": wall, "peak_bytes": peak,
            "indices": res.indices}


def run(args) -> None:
    import torch

    from eagleeverything_tpu_torch.ops import build, packed
    import eagleeverything_tpu_torch as ep

    dev = torch.device("cuda")
    # IEEE fp32 throughout: no TF32 in the plain versions' matmuls either
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card_phase(torch)
    build_phase(build)
    ragged = ragged_phase(torch, packed, dev, args.seed)
    timing = timing_phase(torch, packed, dev, N, P_KERNELS, args.seed)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                     prefix="smoke_") as tmp:
        parity_phase(torch, ep, tmp, args.seed, dev)
        main = main_path_phase(torch, ep, packed, tmp, N, args.p,
                               args.seed, dev)

    phase("7. kernels")
    entries = []
    head = 64
    for name, meta in KERNELS.items():
        by_r = timing[name]
        m = by_r[head]
        print(f"{name}: checked (ragged worst rel err {ragged[name]:.2e}), "
              f"launches on the main path {main['launches'][name]}, "
              + ", ".join(f"r={r}: {v['ms']:.3f} ms"
                          for r, v in by_r.items()))
        entries.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": main["launches"][name],
            "max_abs_err": max(v["max_abs_err"] for v in by_r.values()),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "bound_unit": m["bound_unit"],
            "library_ms": m["library_ms"],
            "shape": {"n": N, "p": P_KERNELS, "r": head},
            "by_r": {str(r): v for r, v in by_r.items()}})
    kv = timing["kernel_matvec"]
    print("kernel_matvec (packed_dot then packed_tdot): "
          + ", ".join(f"r={r}: {v['ms']:.3f} ms" for r, v in kv.items()))
    print(f"total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--p", type=int, default=262144,
                    help="SNPs of the main-path cohort (BASELINE config 3 "
                         "has 1 000 000)")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", flush=True)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this script needs "
              "an NVIDIA GPU", flush=True)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import eagleeverything_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the port is not importable beside this script ({e})",
              flush=True)
        return 1
    try:
        run(args)
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
