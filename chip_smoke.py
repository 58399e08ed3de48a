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
   column tiling and its edge, and three 144-wide tiles; 3% missing codes,
   one all-missing SNP), and packed_dot and packed_tdot each against itself
   bit for bit, packed_dot's narrow design (r <= 32) against its wide one;
4. at the main path's shapes (50 000 individuals × 262 144 SNPs, r ∈
   WIDTHS_MAIN, and packed_dot alone at the multi-trait widths
   WIDTHS_K1_WIDE, bit for bit against itself there): check each kernel
   against its plain version again and time it (CUDA events, median of 10)
   beside its bound, its plain version and one ``torch.matmul`` on the
   unpacked f32 W (a yardstick the port never calls); packed_dot at r <= 32
   takes its narrow design here and is timed through the wide one too,
   both bit for bit the same;
4b. the kernels at BASELINE config 4's axes (AXIS_SHAPES: K1, K2 and K3 at
   500 000 × 32 768, K1 at 2 048 × 5 000 000), each timed beside its bound
   and ``torch.matmul`` on the f32 W a row block at a time (LIB_BLOCKS,
   median of 3, the blocks' times summed), bit for bit against itself,
   and against its
   plain version (one call, timed) and the library's blocks;
5. a small parity check: ``am(engine="matfree")`` at n = 2000, p = 20 000
   on the card; its CPU leg, and those of phases 12-14, run in a process
   of this script's own (``--cpu-legs``, started after phase 6) beside the
   card phases, and phase 15 holds each pair together;
6. the matrix-free path as a user runs it: ``am(engine="auto")`` on a
   cohort of 50 000 × p generated on the card from ``--seed`` (50 000 >
   matfree_min_n, so auto takes the matrix-free engine), with the kernels'
   launch counts, and packed_dot's by design, read around exactly that
   call (the narrow design must have run); every selected SNP must be a
   planted QTL. Before it, the device Lanczos of the REML's [1 y] block
   (128 steps) is held to the host f64 recurrence over the same card
   matvec; after it, a second call (maxit 2) traces iteration 1 (a sweep
   and its refit) with ``torch.profiler``, summarised by its top device
   ops and host gaps;
7. exact-engine parity: ``am(engine="jax")`` at n = 2000, p = 20 000 on the
   card and on the CPU must select the same SNPs, extBIC within rtol 1e-6;
8. the exact engine's path as a user runs it, on BASELINE config 2 (the
   mouse panel, 2000 × 100 000, uncut): ``am(engine="auto")`` (2000 ≤
   matfree_min_n, so auto takes the exact eigenbasis engine) with its
   device ops counted and timed between CUDA events around each call; the
   packed-stack kernels must not launch, every selected SNP must be
   planted;
9. the exact engine's large-n branch: ``am(engine="auto")`` at 16 384 ×
   65 536 — the eigendecomposition runs on the card (n > host_eigh_max_n)
   and U never reaches the host, T is recomputed every sweep (p·n·4 bytes
   exceed half of device_cache_gb); every selected SNP must be planted;
10. Eagle's workflow on BASELINE config 2, uncut, through files: phase 8's
   cohort written by the port's writers (PLINK .bed/.bim/.fam, spaced
   ASCII, phenotypes, map), read back by ``read_marker`` with the native
   ingest into stores that must hold phase 8's shard bytes, ``am()`` from
   the .bed (phase 8's selection and extBIC path), ``summary_am`` exact and
   matrix-free (the latter's packed_dot/packed_tdot launches counted around
   exactly that call, the first launch of each kernel at each width held
   against its plain version on the same operand; β and se within
   tests/test_api.py's bands),
   ``fpr4am`` with 100 permutations, ``plot_am`` to .html, and the CLI as
   a process of its own (the same selection);
11. ``fpr4am`` (20 permutations) and the exact ``summary_am`` on phase 7's
   cohort, card against CPU: the same candidates, λ_crit, β, se and p
   within rtol 1e-6;
12. Zmat on the matrix-free engine: parity at 2000 × 20 000 with 2400
   records (the card leg);
   then 50 000 individuals × 65 536 SNPs with 60 000 records, which auto
   routes to the matrix-free engine (every selection planted), and its
   matrix-free ``summary_am``;
13. ``am_multi`` on the matrix-free engine: parity at 2000 × 20 000 (the
   card leg; each trait against the single-trait matrix-free ``am()`` on
   the card), then four traits on phase 12's cohort, three carrying a
   disjoint pair of its planted QTL and one pure noise (each selection
   planted for its own trait, none for the noise), with the widths
   packed_dot launched at and its first launch at each width over one tile
   held against its plain version;
14. ``fpr4am`` on the matrix-free engine: 20 permutations at 2000 × 20 000
   (the card leg), then 10 permutations on phase 12's cohort (auto), timed
   a permutation;
15. the matrix-free parity cells, card against CPU: the same selections
   (candidates), extBIC (λ_crit) within rtol 1e-3;
16. world 1 on a real NCCL group (``cpu:gloo,cuda:nccl``):
   ``am(engine="sharded")`` on phase 8's cohort must select what phase 8
   selected, extBIC within rtol 1e-6, with ``mmt_psum`` and
   ``score_and_argmax_from_T`` timed between CUDA events; the Lp-form
   sweep op in f32 and bf16 on the card;
17. two ranks of this script on the one card (``--rank``; gloo, handed the
   CUDA tensors: NCCL refuses two ranks on one device): the sharded scan
   on phase 8's cohort (phase 16's selection) and the matrix-free scan
   through MultiHostTiledScan on phase 6's cohort (phase 6's selection,
   extBIC within rtol 1e-3), each rank's kernel launches read around
   exactly that call and the first launch at each width held against the
   plain version; both ranks must exit 0 with equal bits;
18. the streamed stack: the host link's rate (a 1 GB page-locked copy,
   median of 5); phase 6's cohort with a ballast tensor on the card that
   leaves free only the scan's reserve and half the stack, so the gate
   streams the stack (at least 3 chunks): its first K·V at r = 8 and 128
   against the resident K·V (1e-4 of its scale) and against itself (bit
   for bit), a pass of the ring's copies alone (the link as the stack's
   pages see it), one streamed K3 pass timed against the resident one and
   its bound, ``am()`` through the normal entry point (phase 6's selection,
   extBIC within rtol 1e-3; every pass copies the whole stack) and a
   second call tracing iteration 1; then BASELINE config 2 on the exact
   engine under the same kind of ballast (phase 8's selection, extBIC
   within rtol 1e-6);
19. the stack read from the store on every pass (under phase 18's kind of
   ballast, with ``availmem_gb`` below the stack, so that no host stack is
   built and a reader thread fills two page-locked staging buffers): on
   phase 6's cohort, K·V at r = 8 and 128 against the resident one (1e-5),
   the pinned-streamed one and itself (bit for bit), a pass timed beside
   phase 18's pinned pass with the reader's rate and the page-locked bytes
   (at most ``availmem_gb``); ``am()`` through the normal entry point on
   phase 12's cohort (50 000 × 65 536, every selection planted, every
   pass reads the store once, every launch at each width and both chunk
   lengths against the plain version); BASELINE config 2 on the exact
   engine from an unpacked copy of phase 8's store, its int8 rows packed on
   the card (phase 8's selection, extBIC within rtol 1e-6). The stores
   were written in the run, so the page cache is warm;
20. BASELINE config 4's n axis at its true size: 500 000 × 32 768 written
   by scripts/biobank_axes_torch.py's gen_n (the JAX script's cohort), the
   gate's plan printed (the 4.10 GB stack must stay on the card), then its
   run_n (the matrix-free scan with the recorded Krylov protocol,
   N_AXIS_MAXIT steps, the last one traced), held to
   docs/biobank_axis_n_result.json: the recorded selections in order, all
   planted, each extBIC within rtol 1e-3; the launches counted around the
   call, the first at each width bit for bit against itself and against
   the plain version on SLICE_ROWS rows; the allocator's peak printed
   beside stack_reserve's figure;
21. BASELINE config 4's p axis at its true size: 2 048 × 5 000 000 packed
   into a 4-shard store by gen_p (``store_only``), then run_p's REML fit,
   one full stat sweep and its column reads: the recorded argmax, t at the
   planted SNPs beside the record's, the launches held as in phase 20.
   Each axis phase deletes its store when it ends;
22. scripts/cohort_run_torch.py (BASELINE config 3) with p cut to 65 536:
   its ``generate`` writes scripts/cohort_run.py's cohort (the first and
   last 4096-SNP blocks held byte for byte to numpy's own draws), its
   ``run`` scans it through ``am()`` (maxit 3, every selection planted),
   the launches counted and held as in phase 20;
23. ``bench_cuda.py --quick`` for each of its five configs, a process
   each (sweep, eigsweep and multitrait started with phase 22 and run
   beside it; cohort-full on phase 22's store; cohort alone on the card):
   bench.py's metric and unit, a value, no error; the cohort config read
   the store on every sweep and cohort-full launched packed_dot. Phase
   22's store is then deleted;
Phases 24, 25, 27, 29 and 30 run after phase 14, while the CPU legs
finish (the card would wait for them in phase 15); phase 26 runs after
phase 23.

24. scripts/debug_resume_fit_torch.py --exact on phase 5's parity cohort:
   the REML profiles of [1] and [1, its first selection] on the
   matrix-free engine at both protocols (launches counted) and the exact
   one by both routes (eigenbasis, blocked Cholesky on the card): the
   tight protocol's profiles within 1e-3 away from the grid's ends, each
   matrix-free δ̂ a maximiser of the exact profile, the two exact routes
   within 1e-8 on the grid and its tail e⁹…e¹⁶, their δ → ∞ limits
   equal;
25. examples/python_api_torch.py on the card, beside its CPU leg (a
   process each): the same selections, extBIC within rtol 1e-6;
26. scripts/ingest_bench_torch.py --gb 0.5 --format both: MB/s for each
   format through the native ingest;
27. scripts/weakscale_torch.py --device cuda --quick --rounds 1
   --share-card: N = 1, and N = 2 with both ranks on the one card (flagged
   shared_card, no scaling measurement), K1/K2 launched in its phases (b)
   and (e);
29. the exact engine's eigendecomposition above cuSOLVER's limit
   (engine_torch.DEVICE_EIGH_MAX_N): engine_torch.eigh_large forced at
   n = 16 384 against torch.linalg.eigh on the same kernel made on the card
   (eigenvalues within 1e-5 of d_max, residual and orthogonality within
   10x of cuSOLVER's), torch.linalg.eigh at the limit (the yardstick) and
   refusing one past it, eigh_large at n = 50 000 (within 10x of cuSOLVER's
   residuals at the limit, the trace and Frobenius identities; its stages'
   seconds and peak), then ``am(engine="auto")`` at n = matfree_min_n (32
   768, the exact engine's largest) × 65 536 through eigh_large, every
   selection planted;
30. ROADMAP F5's step: tests/test_torch_f5.py's cohort (96 × 180 224, the
   first 128 SNPs polymorphic) generated on the card; the device Lanczos
   of [1, six markers, y] on the card and on the CPU must zero β_1 of the
   six marker columns alone (the breakdown guard), agree on T up to it
   and hold exact zeros after it, with no negative raw Ritz value; the
   REML profile over the card's bases within the f32 bound of the CPU's;
   scripts/debug_resume_fit_torch.py --exact on the card must fire the
   guard where the CPU record (docs/f5_bisect_torch/) does, its profile
   gap and extBIC excess within 20% of the record's;
28. a summary line per kernel and the kernels' JSON line (launches by path,
   each read around exactly that call: the matrix-free am, summary_am,
   am with Zmat, am_multi, fpr4am, each rank of phase 17's matrix-free am,
   phase 18's streamed matrix-free and exact am, phase 19's, the two
   axes of phases 20-21, phase 22's run, phase 23's cohort-full, phase
   24's profile, rank 0 of each point of phase 27 and phase 30's
   profile), then the last line
   ``{"ok": true, "device": {...}}``.

Without CUDA, or outside a checkout, it exits non-zero with no result line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import shutil
import socket
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
# packed_dot alone at the multi-trait widths: matfree_stat_rows_multi puts
# 4 traits of 1 + 8 + 128 columns (548) in one launch, up to its cap of
# MULTI_STAT_COLS (640) — several 144-wide column tiles on grid.y
WIDTHS_K1_WIDE = (548, 640)
# and the edges of every column tiling: one column past a tile (9, 17, 33,
# 65, 145: 145 takes two 144-wide tiles) and a full one (144), and 289,
# one column past two whole tiles (three tiles on grid.y)
WIDTHS_RAGGED = (1, 2, 8, 9, 16, 17, 32, 33, 64, 65, 137, 144, 145, 289)
# (n, p) of the ragged phase: n no multiple of 16 with a short last
# genotype tile, p no multiple of the 32-row k-step; p = 201 < 256 rows
# gives packed_tdot a single split (no reduce launch)
SHAPES_RAGGED = ((1001, 20011), (50000, 3001), (50000, 201))

# the shapes of BASELINE config 4's axes (phases 20-21), timed in phase 4b:
# K1, K2 and K3 at n = 500 000 x 32 768 SNPs, K1 alone at 2 048 x 5 000 000
AXIS_SHAPES = (((500000, 32768), ("packed_dot", "packed_tdot",
                                  "kernel_matvec"), (8, 16, 144)),
               ((2048, 5000000), ("packed_dot",), (8, 144)))
# the f32 W of those shapes (65.5 and 41.0 GB) is recoded, and multiplied by
# torch.matmul, this many row blocks at a time; their times are summed
LIB_BLOCKS = 4
# stack rows on which each launch of phases 20-21 is held against the plain
# version (a plain pass over the whole stack takes seconds a launch there)
SLICE_ROWS = 4096
# forward-selection steps of the n-axis scan (phase 20): the recorded run
# selected six SNPs, one a step, so each step is held to the record
N_AXIS_MAXIT = 6
# phase 22: scripts/cohort_run_torch.py on BASELINE config 3's n with p cut
# (the true 50 000 x 1 000 000 runs in the script alone), its generator's
# block of SNPs, and the scan's steps
COHORT_P = 65536
COHORT_BLOCK = 4096
COHORT_MAXIT = 3
# phase 29: the exact engine's eigendecomposition above cuSOLVER's limit
# (engine_torch.DEVICE_EIGH_MAX_N): eigh_large forced at EIGH_CHECK_N
# against torch.linalg.eigh on the same kernel, and alone at N; every kernel
# is W·Wᵀ/n with W standard normal n × n made on the card. Then the exact
# engine at auto's edge (n = matfree_min_n), which takes eigh_large, on a
# cohort of AUTO_EDGE_P SNPs (phase 22's)
EIGH_CHECK_N = 16384
AUTO_EDGE_P = 65536
AUTO_EDGE_MAXIT = 3
# phase 30: ROADMAP F5's step on tests/test_torch_f5.py's cohort (scripts/
# cohort_run_torch.py's generator, only the first F5_POLY SNPs
# polymorphic), its six marker columns beside the intercept and y, F5_M
# device Lanczos steps; F5_RECORD is the debug script's run of the same
# cohort on the CPU (the port's plain versions), F5_JAX the JAX package's
# (tests/jax_matfree_profile.py) on it
F5_N, F5_P, F5_POLY = 96, 180224, 128
F5_MARKERS = [3, 17, 40, 77, 90, 120]
F5_M = 16
F5_RECORD = "docs/f5_bisect_torch/n96_p180224_poly128_cpu.json"
F5_JAX = "docs/f5_bisect_torch/n96_p180224_poly128_jax_cpu.json"
# phase 23: bench.py's metric and unit of each config (bench.py:180, :426,
# :561, :627, :677), which bench_cuda.py's lines must carry
BENCH_LINES = {
    "sweep": ("snps_scored_per_sec_per_chip", "SNPs/s"),
    "eigsweep": ("snps_scored_per_sec_per_chip_eigenbasis", "SNPs/s"),
    "multitrait": ("trait_snps_scored_per_sec_per_chip", "trait·SNPs/s"),
    "cohort": ("snps_scored_per_sec_per_chip_outofcore", "SNPs/s"),
    "cohort-full": ("snps_scored_per_sec_per_chip_cohort_full", "SNPs/s"),
}

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense bf16 on the tensor
# cores (both kernels run their products there); fp32 outside the tensor
# cores, where the exact engine's IEEE fp32 products run
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12
# kernel vs plain version, as max |kernel − plain| / max |plain|: both are
# fp32 sums of up to 262 144 terms taken in different orders; the rounding
# of such a sum is ~√K·2⁻²⁴ of its scale (≈3e-5 at K = 262 144, worst
# case), and packed_tdot's bf16x3 products add about 2⁻¹⁷ of each term
# (tests/test_torch_packed.py::test_bf16_split_numerics emulates both),
# so 1e-4 passes every correct kernel and fails any wrong term
TOL = 1e-4
# the run's time limit, seconds: the CPU legs are waited for up to it
LIMIT_S = 1140
KERNELS = {
    "packed_dot": {
        "source": "eagleeverything_tpu_torch/ops/csrc/packed_dot.cu",
        "replaces": "eagleeverything_tpu/ops/pallas_packed.py:142"},
    "packed_tdot": {
        "source": "eagleeverything_tpu_torch/ops/csrc/packed_tdot.cu",
        "replaces": "eagleeverything_tpu/ops/pallas_packed.py:203"},
}


STARTED = time.perf_counter()


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(title: str) -> None:
    """A phase's header, with the seconds since the script started."""
    print(f"\n== {title} [at {time.perf_counter() - STARTED:.1f} s]",
          flush=True)


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


@contextlib.contextmanager
def k1_design(packed, design: str):
    """packed_dot through one of its designs ("narrow", "wide") whatever
    the shapes, for the length of the block (both give the same bits)."""
    choose = packed.k1_path
    packed.k1_path = lambda *_: design
    try:
        yield
    finally:
        packed.k1_path = choose


def k1_taken(packed, before: dict) -> str:
    """The packed_dot design that launched since ``before`` (a copy of
    packed.K1_PATHS), the one with more launches."""
    return max(packed.K1_PATHS,
               key=lambda k: packed.K1_PATHS[k] - before[k])


def same_bits(torch, a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


class OpTimer:
    """Counts and times the calls of some functions for the length of a
    ``with`` block: each named attribute of each object is replaced by a
    wrapper that records a CUDA event before and after the call (no
    synchronisation, so the run is not slowed), and is restored on exit.
    ``flops(args) -> (FLOPs, bytes)`` of a call come from its operands'
    shapes. ``last`` keeps each op's last return value."""

    def __init__(self, torch, targets: dict):
        self.torch = torch
        self.targets = targets          # name → (object, attribute, flops)
        self.calls = {name: [] for name in targets}
        self.last = {}
        self._saved = []

    def __enter__(self):
        for name, (obj, attr, cost) in self.targets.items():
            fn = getattr(obj, attr)
            self._saved.append((obj, attr, fn))
            setattr(obj, attr, self._wrap(name, fn, cost))
        return self

    def _wrap(self, name, fn, cost):
        torch = self.torch

        def timed_call(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            self.calls[name].append((a, b, cost(args)))
            self.last[name] = out
            return out
        return timed_call

    def __exit__(self, *exc):
        for obj, attr, fn in reversed(self._saved):
            setattr(obj, attr, fn)
        return False

    def report(self) -> dict:
        """{name: {calls, ms (sum), ms_per_call, flops_per_call,
        bytes_per_call, tflops, pct_fp32_peak, pct_hbm}}."""
        self.torch.cuda.synchronize()
        out = {}
        for name, calls in self.calls.items():
            if not calls:
                out[name] = {"calls": 0}
                continue
            ms = sum(a.elapsed_time(b) for a, b, _ in calls)
            flops = sum(c[0] for _, _, c in calls)
            nbytes = sum(c[1] for _, _, c in calls)
            out[name] = {
                "calls": len(calls), "ms": ms, "ms_per_call": ms / len(calls),
                "flops_per_call": flops / len(calls),
                "bytes_per_call": nbytes / len(calls),
                "tflops": flops / ms / 1e9,
                "pct_fp32_peak": 100 * flops / (ms * 1e-3) / FP32_FLOPS_PER_S,
                "pct_hbm": 100 * nbytes / (ms * 1e-3) / HBM_BYTES_PER_S}
        return out


class LaunchRecorder:
    """For the length of a ``with`` block, wraps packed_dot, packed_tdot and
    kernel_matvec of ``packed`` (the engine and kernel_matvec itself look
    them up through the module at call time): it counts the calls at each
    width, and the first call at each width that ``keep`` selects, on an
    operand that is not all zero (on a zero block any kernel agrees with
    its plain version), keeps a copy of its operand and its result. It
    launches nothing of its own, so the launch counts stay the path's.

    With ``streamed``, the stack a kernel reads is a chunk in a ring slot
    that the next copy overwrites: the first call at each width and each
    chunk length (a full chunk, and the shorter last one) is kept, and
    with it a host copy of its chunk and its means, one a chunk; every
    kept tensor goes to the host, which the ballast of a streamed run
    leaves no room for on the card."""

    NAMES = ("packed_dot", "packed_tdot", "kernel_matvec")

    def __init__(self, packed, keep=lambda name, r: True, streamed=False):
        self.packed = packed
        self.keep = keep    # which (name, r) to keep a copy of
        self.streamed = streamed
        # (name, r), or (name, r, chunk rows) when streamed →
        # (Wp, means, n, operand, result)
        self.kept = {}
        self.widths = {name: {} for name in self.NAMES}   # r → calls
        self._chunks = {}   # (means pointer, rows) → host (Wp, means)
        self._saved = {}

    def __enter__(self):
        for name in self.NAMES:
            self._saved[name] = getattr(self.packed, name)
            setattr(self.packed, name, self._wrap(name, self._saved[name]))
        return self

    def _wrap(self, name, fn):
        def call(Wp, X, means, n):
            out = fn(Wp, X, means, n)
            r = X.shape[1]
            self.widths[name][r] = self.widths[name].get(r, 0) + 1
            key = (name, r, Wp.shape[0]) if self.streamed else (name, r)
            if key in self.kept or not self.keep(name, r) or not X.any():
                return out
            if self.streamed:
                chunk = (means.data_ptr(), Wp.shape[0])
                if chunk not in self._chunks:
                    self._chunks[chunk] = (Wp.to("cpu", copy=True),
                                           means.to("cpu", copy=True))
                self.kept[key] = (*self._chunks[chunk], n,
                                  X.to("cpu", copy=True),
                                  out.to("cpu", copy=True))
            else:
                self.kept[key] = (Wp, means, n, X.clone(), out.clone())
            return out
        return call

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.packed, name, fn)
        return False


class IterationTrace:
    """For the length of a ``with`` block, traces one forward-selection
    iteration of the matrix-free scan with ``torch.profiler`` (CPU and CUDA
    activity): the profiler starts when the sweep of iteration ``it``
    begins (bigscan.score_sweep_matfree_multi, looked up through the
    module at call time) and stops when the refit after it (the next
    reml_maximize_matfree with a delta hint) returns. The Chrome trace is
    written to ``path``; ``wall_s`` is the host wall of the traced window,
    which carries the profiler's own cost."""

    def __init__(self, torch, bigscan, it: int, path: str):
        from torch.profiler import ProfilerActivity, profile
        self.torch, self.bigscan, self.it, self.path = torch, bigscan, it, path
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.sweeps = 0
        self.active = False
        self.done = False
        self.wall_s = None

    def _start(self):
        self.torch.cuda.synchronize()
        self.prof.start()
        self.active = True
        self._t0 = time.perf_counter()

    def _stop(self):
        self.torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.stop()
        self.active, self.done = False, True
        self.prof.export_chrome_trace(self.path)

    def __enter__(self):
        self._sweep = self.bigscan.score_sweep_matfree_multi
        self._reml = self.bigscan.reml_maximize_matfree

        def sweep(*a, **k):
            if self.sweeps == self.it and not self.done:
                self._start()
            self.sweeps += 1
            return self._sweep(*a, **k)

        def reml(*a, **k):
            out = self._reml(*a, **k)
            if self.active and k.get("delta_hint") is not None:
                self._stop()
            return out

        self.bigscan.score_sweep_matfree_multi = sweep
        self.bigscan.reml_maximize_matfree = reml
        return self

    def __exit__(self, *exc):
        self.bigscan.score_sweep_matfree_multi = self._sweep
        self.bigscan.reml_maximize_matfree = self._reml
        if self.active:
            self._stop()
        return False


def trace_summary(path: str, wall_s: float, top: int = 8) -> dict:
    """Device time by kernel name and the host gaps of a Chrome trace:
    the union of the device's kernel, copy and set intervals against the
    traced window, and the idle stretches between them."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events,
                                                             dict) else events
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        return {"device_events": 0}
    by_name: dict = {}
    for e in dev:
        k = e["name"][:70]
        cnt, us = by_name.get(k, (0, 0.0))
        by_name[k] = (cnt + 1, us + float(e["dur"]))
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev)
    busy, gaps = 0.0, []
    lo, hi = spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            gaps.append((a - hi, hi - spans[0][0]))
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    window_us = wall_s * 1e6
    big = sorted((g for g in gaps if g[0] > 1000.0), reverse=True)
    return {
        "device_events": len(dev),
        "window_ms": window_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / window_us,
        "top_ops": sorted(((k, c, us / 1e3) for k, (c, us) in by_name.items()),
                          key=lambda t: -t[2])[:top],
        "gaps_over_1ms": len(big),
        "gaps_over_1ms_total_ms": sum(g for g, _ in big) / 1e3,
        "largest_gaps_ms_at_ms": [(g / 1e3, at / 1e3) for g, at in big[:5]]}


def exact_op_targets(torch, kernels) -> dict:
    """The exact engine's device ops and their work, from the operands'
    shapes: FLOPs of the products (2 a multiply-add) and elementwise
    passes, bytes of each input read once and each output written once.
    The eigendecomposition counts 9n³, the textbook count for eigenvalues
    and eigenvectors of a symmetric matrix (Golub & Van Loan)."""
    def unpack(a):
        tile, n = a[0], a[1]
        return 0, tile.numel() * tile.element_size() + tile.shape[0] * n * 4

    def mmt(a):
        (n, _), (b, _) = a[0].shape, a[1].shape
        return 2 * b * n * n, 4 * (2 * n * n + b * n)

    def eig_t(a):
        (b, n), (_, m) = a[0].shape, a[1].shape
        return 2 * b * n * m, 4 * (b * n + n * m + b * m)

    def score(a):
        (b, n), q = a[0].shape, a[2].shape[1]
        return 2 * b * n * (1 + q) + 3 * b * n, 4 * (b * n + n * q + b)

    def eigh(a):
        n = a[0].shape[0]
        return 9 * n ** 3, 4 * (2 * n * n + n)

    return {"unpack_recode_tile": (kernels, "unpack_recode_tile", unpack),
            "mmt_accumulate": (kernels, "mmt_accumulate", mmt),
            "eig_T_tile": (kernels, "eig_T_tile", eig_t),
            "score_from_T": (kernels, "score_from_T", score),
            "torch.linalg.eigh": (torch.linalg, "eigh", eigh)}


def print_ops(ops: dict) -> None:
    for name, m in ops.items():
        if not m["calls"]:
            print(f"  {name:20s} not called")
            continue
        print(f"  {name:20s} {m['calls']:4d} calls  {m['ms_per_call']:10.3f} "
              f"ms a call  {m['flops_per_call'] / 1e9:10.2f} GFLOP a call  "
              f"{m['tflops']:7.2f} TFLOP/s ({m['pct_fp32_peak']:5.1f}% of "
              f"67 TFLOP/s fp32)  {m['bytes_per_call'] / 1e9:7.3f} GB a "
              f"call ({m['pct_hbm']:5.1f}% of 3.35 TB/s)", flush=True)


def scan_phases(events: list[dict]) -> dict:
    """{phase: [wall s, ...]} from a scan log."""
    out: dict = {}
    for e in events:
        if e["event"] == "phase":
            out.setdefault(e["phase"], []).append(e["wallclock_s"])
    return out


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
            if r <= 32:
                # the narrow design, forced at these p, gives the wide bits
                with k1_design(packed, "narrow"):
                    D_narrow = packed.packed_dot(stack, A, means, n)
                with k1_design(packed, "wide"):
                    D_wide = packed.packed_dot(stack, A, means, n)
                check(same_bits(torch, D_narrow, D_wide),
                      f"narrow packed_dot differs from the wide design at "
                      f"n={n} p={p} r={r}")
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
    phase(f"4. kernels at the main path's shapes: n={n}, p={p}, r in "
          f"{WIDTHS_MAIN}, packed_dot also at r in {WIDTHS_K1_WIDE} (bit "
          "for bit against itself there) "
          "(CUDA events: kernels and torch.matmul median of 10, plain "
          "versions one call; bound from the H100 SXM data sheet: "
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
    # packed_dot alone at the wide widths (only its input is made there)
    names = {r: (tuple(ops) if r in widths else ("packed_dot",))
             for r in widths + WIDTHS_K1_WIDE}
    inputs = {r: (torch.randn((n, r), generator=gen, device=dev),
                  torch.randn((p, r), generator=gen, device=dev)
                  if r in widths else None)
              for r in names}
    for r, these in names.items():
        X = inputs[r]
        for name in these:
            kern, plain = ops[name]
            before = dict(packed.K1_PATHS)
            k_out, k_ms = timed(torch, lambda: kern(X), 10, 2)
            design = k1_taken(packed, before)
            # one call: the plain versions take seconds a call (2 s at
            # r = 8), and three of each took 80 s of the time limit
            p_out, p_ms = timed(torch, lambda: plain(X), 1, 0)
            err, rel = rel_err(torch, k_out, p_out)
            check(rel <= TOL, f"{name} disagrees with its plain version at "
                  f"n={n} p={p} r={r}: rel {rel:.3e} > {TOL:g}")
            if r not in widths:
                check(torch.equal(k_out, kern(X)),
                      f"{name} not bitwise repeatable at r={r}")
            b_ms, b_by, b_unit = bound(name, n, p, r, nw)
            res[name][r] = {"max_abs_err": err, "rel_err": rel, "ms": k_ms,
                            "plain_ms": p_ms, "bound_ms": b_ms,
                            "bound_by": b_by, "bound_unit": b_unit,
                            "executed_tflops": executed_flops(name, n, p, r)
                            / k_ms / 1e9}
            if name == "packed_dot" and r <= 32:
                # K1's design at these shapes, and the wide one beside it
                # (the same bits)
                res[name][r]["design"] = design
                with k1_design(packed, "wide"):
                    w_out, w_ms = timed(torch, lambda: kern(X), 10, 2)
                check(same_bits(torch, w_out, k_out),
                      f"packed_dot's designs differ at n={n} p={p} r={r}")
                res[name][r]["wide_ms"] = w_ms
                del w_out
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
    for r, these in names.items():
        for name in these:
            fn = lib[name]
            l_out, l_ms = timed(torch, lambda: fn(inputs[r]), 10, 1)
            err, rel = rel_err(torch, l_out, outs[name, r])
            check(rel <= TOL, f"torch.matmul and {name} disagree at r={r}: "
                  f"rel {rel:.3e}")
            res[name][r]["library_ms"] = l_ms
    del W, stack, means, inputs, outs
    torch.cuda.empty_cache()
    for name, by_r in res.items():
        for r, m in by_r.items():
            design = (f"  ({m['design']} design; wide "
                      f"{m['wide_ms']:.3f} ms)" if "wide_ms" in m else "")
            print(f"{name:14s} r={r:4d}  kernel {m['ms']:9.3f} ms{design}  "
                  f"plain {m['plain_ms']:9.3f} ms  torch.matmul on f32 W "
                  f"{m['library_ms']:9.3f} ms  bound {m['bound_ms']:8.3f} ms "
                  f"({m['bound_by']} on {m['bound_unit']}, "
                  f"{m['bound_ms'] / m['ms']:.1%} of it)  executes "
                  f"{m['executed_tflops']:.1f} TFLOP/s  "
                  f"max abs err {m['max_abs_err']:.2e}", flush=True)
    return res


def axis_timing_phase(torch, packed, dev, seed: int) -> dict:
    """Phase 4b: the kernels at BASELINE config 4's two axes (AXIS_SHAPES),
    on random stacks made on the card, each beside its bound and the
    library. Each launch is bitwise repeatable, and every result is held
    against the plain version and the library's blocks (TOL). Returns
    {(n, p): {name: {r: metrics}}}."""
    phase("4b. kernels at BASELINE config 4's axes: K1, K2 and K3 at "
          "n = 500 000, p = 32 768, r in (8, 16, 144); K1 at n = 2 048, "
          "p = 5 000 000, r in (8, 144) (CUDA events, median of 10; the "
          "plain versions one call; torch.matmul on the f32 W "
          f"{LIB_BLOCKS} row blocks at a time, median of 3, the blocks' "
          "times summed, "
          "since the whole W is 65.5 / 41.0 GB)")
    out = {}
    for (n, p), names, widths in AXIS_SHAPES:
        stack, means = random_stack(torch, packed, n, p, seed + 3, dev,
                                    chunk=max(1, (1 << 28) // n))
        nw = stack.shape[1]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 4)
        X = {r: (torch.randn((n, r), generator=gen, device=dev),
                 torch.randn((p, r), generator=gen, device=dev)
                 if "packed_tdot" in names else None) for r in widths}

        def operand(name, r):
            return X[r][1] if name == "packed_tdot" else X[r][0]

        res = {name: {} for name in names}
        outs = {}
        for r in widths:
            for name in names:
                fn = getattr(packed, name)
                plain = getattr(packed, f"{name}_plain")
                A = operand(name, r)
                before = dict(packed.K1_PATHS)
                k_out, ms = timed(torch, lambda: fn(stack, A, means, n), 10,
                                  2)
                design = k1_taken(packed, before)
                check(torch.equal(k_out, fn(stack, A, means, n)),
                      f"{name} not bitwise repeatable at n={n} p={p} r={r}")
                p_out, p_ms = timed(torch, lambda: plain(stack, A, means, n),
                                    1, 0)
                err, rel = rel_err(torch, k_out, p_out)
                del p_out
                check(rel <= TOL, f"{name} disagrees with its plain version "
                      f"at n={n} p={p} r={r}: rel {rel:.3e}")
                b_ms, b_by, b_unit = bound(name, n, p, r, nw)
                res[name][r] = {"ms": ms, "plain_ms": p_ms, "bound_ms": b_ms,
                                "bound_by": b_by, "bound_unit": b_unit,
                                "library_ms": 0.0, "max_abs_err": err,
                                "rel_err": rel,
                                "executed_tflops": executed_flops(
                                    name, n, p, r) / ms / 1e9}
                if name == "packed_dot":
                    res[name][r]["design"] = design
                if name == "packed_tdot":
                    res[name][r]["splits"] = \
                        packed._tdot_lib().ee_packed_tdot_splits(p, n, r)
                outs[name, r] = k_out
        # the library, a row block of W at a time: K1's rows are its
        # blocks' products, K2's and K3's results their sums
        rows = -(-p // LIB_BLOCKS)
        sums = {key: torch.zeros_like(v) for key, v in outs.items()
                if key[0] != "packed_dot"}
        k1_err = {r: 0.0 for r in widths}
        for i0 in range(0, p, rows):
            W = packed.recode(stack[i0 : i0 + rows], means[i0 : i0 + rows],
                              n)
            for r in widths:
                A, T = X[r][0], X[r][1]
                lib = {"packed_dot": lambda: torch.matmul(W, A),
                       "packed_tdot": lambda: torch.matmul(
                           W.T, T[i0 : i0 + rows]),
                       "kernel_matvec": lambda: torch.matmul(
                           W.T, torch.matmul(W, A))}
                for name in names:
                    l_out, l_ms = timed(torch, lib[name], 3, 1)
                    res[name][r]["library_ms"] += l_ms
                    if name == "packed_dot":
                        k1_err[r] = max(k1_err[r], (
                            l_out - outs[name, r][i0 : i0 + rows]
                        ).abs().max().item())
                    else:
                        sums[name, r] += l_out
                    del l_out
            del W
            torch.cuda.empty_cache()
        for (name, r), got in outs.items():
            if name == "packed_dot":
                rel = k1_err[r] / max(got.abs().max().item(), 1e-30)
            else:
                rel = rel_err(torch, got, sums[name, r])[1]
            check(rel <= TOL, f"torch.matmul and {name} disagree at n={n} "
                  f"p={p} r={r}: rel {rel:.3e}")
            m = res[name][r]
            print(f"{name:14s} n={n:6d} p={p:7d} r={r:4d}  kernel "
                  f"{m['ms']:9.3f} ms  plain {m['plain_ms']:9.1f} ms  "
                  f"torch.matmul on f32 W, {LIB_BLOCKS} row blocks summed "
                  f"{m['library_ms']:9.3f} ms  bound {m['bound_ms']:8.3f} ms "
                  f"({m['bound_by']} on {m['bound_unit']}, "
                  f"{m['bound_ms'] / m['ms']:.1%} of it)  executes "
                  f"{m['executed_tflops']:.1f} TFLOP/s  "
                  + (f"split-K {m['splits']}  " if "splits" in m else "")
                  + (f"{m['design']} design  " if "design" in m else "")
                  + f"vs plain: max abs err {m['max_abs_err']:.2e} (rel "
                  f"{m['rel_err']:.2e}); vs torch.matmul: rel {rel:.2e}",
                  flush=True)
        out[n, p] = res
        del stack, means, X, outs, sums
        torch.cuda.empty_cache()
    return out


def read_log(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def parity_phase(torch, ep, tmp: str, seed: int, dev) -> tuple:
    """The card leg of the matrix-free parity cell; its CPU leg runs in
    the CPU-legs process and phase 15 holds the two together. Returns
    (cohort, card result)."""
    from eagleeverything_tpu_torch.data.simulate import simulate_cohort
    n, p = 2000, 20000
    phase(f"5. parity: am(engine='matfree') at n={n}, p={p} on cuda (the "
          "cpu leg runs beside the card phases, compared in phase 15)")
    c = simulate_cohort(os.path.join(tmp, "parity"), n=n, p=p, seed=seed,
                        device=dev)
    h = ep.GenoHandle(n=c.n, p=c.p, source="parity", store_dir=c.store_dir)
    t0 = time.perf_counter()
    res = ep.am("y", h, {"y": c.y}, maxit=3, engine="matfree")
    print(f"cuda: indices {res.indices}  extBIC "
          f"{[round(v, 4) for v in res.extbic_path]}  "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(len(res.indices) >= 1, "the parity scan selected nothing")
    return c, {"indices": res.indices, "extbic_path": res.extbic_path}


class CpuLegs:
    """The CPU legs of the matrix-free parity cells, run by this script in
    a process of its own (``--cpu-legs SPEC OUT``) beside the card phases,
    so that their hundreds of seconds of plain-version work overlap the
    card's. ``add`` records a job with its arrays, ``start`` launches the
    process, ``results`` waits for it; leaving the ``with`` block stops it
    if it still runs."""

    THREADS = "6"           # of the host's cores; the card phases keep two

    def __init__(self, tmp: str):
        self.tmp, self.jobs, self.proc = tmp, {}, None

    def add(self, key: str, kind: str, cohort, arrays: dict, **kw) -> None:
        data = os.path.join(self.tmp, f"leg_{key}.npz")
        np.savez(data, **arrays)
        self.jobs[key] = dict(kind=kind, store=cohort.store_dir, n=cohort.n,
                              p=cohort.p, data=data, **kw)

    def start(self) -> None:
        spec = os.path.join(self.tmp, "legs.json")
        with open(spec, "w") as f:
            json.dump(self.jobs, f)
        self.out = os.path.join(self.tmp, "legs_out.json")
        self.log_path = os.path.join(self.tmp, "legs.log")
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS=self.THREADS,
                   MKL_NUM_THREADS=self.THREADS,
                   OPENBLAS_NUM_THREADS=self.THREADS)
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-legs", spec,
             self.out], cwd=ROOT, env=env, stdout=self._log,
            stderr=subprocess.STDOUT)
        self.t0 = time.perf_counter()
        print(f"CPU legs started ({', '.join(self.jobs)}; "
              f"{self.THREADS} threads, pid {self.proc.pid})", flush=True)

    def results(self, timeout: float) -> tuple[dict, float]:
        try:
            rc = self.proc.wait(timeout=max(timeout, 1.0))
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"the CPU legs did not finish in {timeout:.0f}"
                               " s") from None
        with open(self.log_path) as f:
            log = f.read()
        check(rc == 0, f"the CPU legs failed (rc {rc}): {log[-2000:]}")
        with open(self.out) as f:
            return json.load(f), time.perf_counter() - self.t0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.proc is not None:
            if self.proc.poll() is None:
                self.proc.kill()
            self.proc.wait()
            self._log.close()
        return False


def incidence(z_idx: np.ndarray, n: int) -> np.ndarray:
    """The dense f64 0/1 Zmat of a record → individual index, as
    ``read_zmat`` returns it; at biobank n nearly all of it is zero pages
    that are never written."""
    Z = np.zeros((len(z_idx), n))
    Z[np.arange(len(z_idx)), z_idx] = 1.0
    return Z


def cpu_legs(spec_path: str, out_path: str) -> int:
    """Run each job of a CpuLegs spec on the CPU and write the results."""
    import eagleeverything_tpu_torch as ep
    with open(spec_path) as f:
        jobs = json.load(f)
    out = {}
    for key, job in jobs.items():
        d = np.load(job["data"])
        h = ep.GenoHandle(n=job["n"], p=job["p"], source=key,
                          store_dir=job["store"])
        t0 = time.perf_counter()
        if job["kind"] == "am":
            Z = (incidence(d["z_idx"], job["n"]) if "z_idx" in d.files
                 else None)
            r = ep.am("y", h, {"y": d["y"]}, Zmat=Z, maxit=3,
                      engine="matfree", device="cpu")
            res = {"indices": r.indices, "extbic_path": r.extbic_path}
        elif job["kind"] == "am_multi":
            rs = ep.am_multi(job["traits"], h,
                             {t: d[t] for t in job["traits"]}, maxit=3,
                             engine="matfree", device="cpu")
            res = {t: {"indices": r.indices, "extbic_path": r.extbic_path}
                   for t, r in rs.items()}
        else:
            cal = ep.fpr4am("y", h, {"y": d["y"]}, numreps=job["numreps"],
                            seed=1, engine="matfree", device="cpu")
            res = {"candidates": cal["candidates"].tolist(),
                   "lambda_crits": cal["lambda_crits"].tolist(),
                   "lambda": cal["lambda"]}
        out[key] = {"result": res, "s": time.perf_counter() - t0}
        print(f"{key}: {out[key]['s']:.1f} s", flush=True)
    with open(out_path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(out_path + ".tmp", out_path)
    return 0


def lanczos_check(torch, ep, bigscan, engine_torch, c, dev) -> dict:
    """The device Lanczos at the main path's shapes: the REML's own call
    (the block [1 y], solve_m = 128 steps, full reorthogonalisation) on the
    cohort's stack, against the host f64 recurrence over the same card
    matvec (tests/test_packed_stack.py:107's bounds: z_norm at rtol 1e-6,
    the leading 8 α and β at rtol/atol 1e-3). Each is timed: the device
    one between CUDA events, the host one by the host clock."""
    backend = engine_torch.TiledScan(
        engine_torch.StoreTileSource(c.store_dir), ep.EagleConfig(), dev)
    ctx = bigscan.make_context(backend, c.n)
    B = np.column_stack([np.ones(c.n), c.y])
    m = ctx.solve_m
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    ad, bd, zd, basis = ctx.device_lanczos(B, m, True)
    b.record()
    b.synchronize()
    dev_ms = a.elapsed_time(b)
    basis_bytes = basis.numel() * basis.element_size()
    del basis
    t0 = time.perf_counter()
    ah, bh, zh, _ = bigscan._lanczos(ctx.kernel_matvec, B, m, reorth=True)
    host_ms = (time.perf_counter() - t0) * 1e3

    def gap(x, y):
        return float(np.max(np.abs(x - y) / (1e-3 + 1e-3 * np.abs(y))))

    out = {"m": m, "device_ms": dev_ms, "host_ms": host_ms,
           "z_norm_rel": float(np.max(np.abs(zd[:2] - zh) / zh)),
           "alpha_gap": gap(ad[:8, :2], ah[:8, :2]),
           "beta_gap": gap(bd[:8, :2], bh[:8, :2]),
           "basis_gb": basis_bytes / 1e9}
    print(f"device Lanczos, [1 y] ({c.n} x 2, padded to 8), m = {m}, "
          f"reorthogonalised: {dev_ms:.1f} ms on the card (basis "
          f"{out['basis_gb']:.2f} GB), host f64 recurrence over the same "
          f"matvec {host_ms:.1f} ms; z_norm rel {out['z_norm_rel']:.2e} "
          f"(limit 1e-6), leading 8 alpha / beta at "
          f"{out['alpha_gap']:.3f} / {out['beta_gap']:.3f} of rtol/atol "
          f"1e-3", flush=True)
    check(out["z_norm_rel"] <= 1e-6, "device Lanczos z_norm off")
    check(out["alpha_gap"] <= 1.0 and out["beta_gap"] <= 1.0,
          "device Lanczos coefficients differ from the host recurrence's")
    del backend, ctx
    torch.cuda.empty_cache()
    return out


def main_path_phase(torch, ep, packed, tmp: str, n: int, p: int, seed: int,
                    dev) -> dict:
    from eagleeverything_tpu_torch.data.simulate import simulate_cohort
    from eagleeverything_tpu_torch.models import bigscan, engine_torch
    phase(f"6. matrix-free path: am(engine='auto') on a generated cohort of "
          f"{n} x {p} (seed {seed}, 8 planted QTL), after its device "
          "Lanczos is held to the host recurrence; one iteration traced")
    t0 = time.perf_counter()
    c = simulate_cohort(os.path.join(tmp, "cohort"), n=n, p=p, n_qtl=8,
                        seed=seed, device=dev)
    print(f"cohort written in {time.perf_counter() - t0:.1f} s; planted QTL "
          f"{c.qtl_idx.tolist()}", flush=True)
    lz = lanczos_check(torch, ep, bigscan, engine_torch, c, dev)
    stack_gb = p * packed.words_per_row(n) * 4 / 1e9
    log = os.path.join(tmp, "scan.jsonl")
    handle = ep.GenoHandle(n=c.n, p=c.p, source="cohort", store_dir=c.store_dir)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    packed.reset_launches()
    t0 = time.perf_counter()
    res = ep.am("y", handle, {"y": c.y}, maxit=3, engine="auto",
                log_jsonl=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(packed.LAUNCHES)
    k1_designs = dict(packed.K1_PATHS)
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
    print(f"am() wall {wall:.1f} s; launches {launches}; packed_dot by "
          f"design {k1_designs}; peak device memory "
          f"{peak / 1e9:.2f} GB (stack {stack_gb:.2f} GB)", flush=True)
    check(len(res.indices) >= 1, "the main-path scan selected nothing")
    check(set(res.indices) <= set(int(q) for q in c.qtl_idx),
          f"selected SNPs {res.indices} are not all planted QTL")
    check(all(math.isfinite(v) for v in res.extbic_path),
          "non-finite extBIC on the main path")
    for name in KERNELS:
        check(launches[name] >= 1,
              f"{name} was never launched on the main path")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = packed._dot_lib().ee_packed_dot_narrow_rows(8)
    check(k1_designs["narrow"] >= 1
          or packed.k1_path(p, rows, sms, True) == "wide",
          "packed_dot never took its narrow design on the main path")
    # the trace in a call of its own (maxit 2, iteration 1 traced), so that
    # the profiler's start-up and cost stay out of the walls above
    with IterationTrace(torch, bigscan, 1,
                        os.path.join(tmp, "iteration_trace.json")) as tr:
        ep.am("y", handle, {"y": c.y}, maxit=2, engine="auto")
    trace = print_trace(tr)
    return {"launches": launches, "k1_designs": k1_designs,
            "wall_s": wall, "peak_bytes": peak,
            "indices": res.indices, "extbic_path": res.extbic_path,
            "cohort": c, "lanczos": lz,
            "trace": trace, "phases": scan_phases(events)}


def print_trace(tr: IterationTrace,
                what: str = "iteration 1 (sweep + refit, under the profiler, "
                            "in a second am() call with maxit 2)") -> dict:
    """Summarise and print the iteration an IterationTrace recorded."""
    trace = {"device_events": 0}
    if tr.done:
        trace = trace_summary(tr.path, tr.wall_s)
    if trace["device_events"]:
        print(f"traced {what}: "
              f"window {trace['window_ms']:.1f} ms, device busy "
              f"{trace['device_busy_ms']:.1f} ms, idle share "
              f"{trace['device_idle_share']:.1%}; {trace['gaps_over_1ms']} "
              f"host gaps over 1 ms, {trace['gaps_over_1ms_total_ms']:.1f} "
              "ms in all; largest (ms, at ms) "
              + ", ".join(f"{g:.1f} at {at:.0f}"
                          for g, at in trace["largest_gaps_ms_at_ms"]))
        for name, cnt, ms in trace["top_ops"]:
            print(f"  device op {name:70s} {cnt:6d} calls {ms:10.1f} ms")
    else:
        print("the profiler recorded no device events in the traced "
              "iteration (traced: " + str(tr.done) + ")", flush=True)
    return trace


def rel_gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300),
                        initial=0.0))


def records(c, extra: int, seed: int):
    """A repeated-measures design over cohort ``c``: the record →
    individual index (every individual once, ``extra`` of them drawn
    again) and a record-level trait, the individual's trait plus record
    noise (sd 0.3)."""
    rng = np.random.default_rng(seed)
    z_idx = np.concatenate([np.arange(c.n), rng.integers(0, c.n, extra)])
    return z_idx, c.y[z_idx] + 0.3 * rng.standard_normal(len(z_idx))


def start_cpu_legs(legs: CpuLegs, ep, tmp: str, mf_parity, seed: int,
                   dev) -> dict:
    """Make the data of the matrix-free parity cells — phase 5's cohort and
    four traits over it (phase 13), and a Zmat cohort of 2000 × 20 000 with
    2400 records (phase 12) — and start their CPU legs."""
    from eagleeverything_tpu_torch.data.simulate import simulate_cohort
    zc = simulate_cohort(os.path.join(tmp, "zmat_parity"), n=2000, p=20000,
                         seed=seed + 2, device=dev)
    z_idx, y_rec = records(zc, 400, seed)
    pheno, pairs = trait_pairs(ep, mf_parity, seed)
    legs.add("am", "am", mf_parity, {"y": mf_parity.y})
    legs.add("zmat", "am", zc, {"y": y_rec, "z_idx": z_idx})
    legs.add("am_multi", "am_multi", mf_parity, pheno, traits=list(pheno))
    legs.add("fpr4am", "fpr4am", mf_parity, {"y": mf_parity.y}, numreps=20)
    legs.start()
    return {"zmat_cohort": zc, "z_idx": z_idx, "y_rec": y_rec,
            "pheno": pheno, "pairs": pairs}


def run_counted(torch, packed, fn, recorder=None):
    """(result, host wall s, launches) of fn(), the launch counts set to 0
    just before and read just after it."""
    torch.cuda.synchronize()
    packed.reset_launches()
    t0 = time.perf_counter()
    with recorder if recorder is not None else contextlib.nullcontext():
        out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(packed.LAUNCHES)


def zmat_phase(torch, ep, packed, tmp: str, prep: dict, seed: int,
               dev) -> dict:
    """Zmat on the matrix-free engine: the card leg of the parity cell
    (2000 × 20 000 with 2400 records), then 50 000 individuals × 65 536
    SNPs with 60 000 records, which auto routes to the matrix-free engine,
    and its matrix-free summary."""
    from eagleeverything_tpu_torch.data.simulate import simulate_cohort
    phase("12. Zmat on the matrix-free engine: parity at 2000 x 20 000 with "
          "2400 records on cuda (the cpu leg: phase 15), then 50 000 x "
          "65 536 with 60 000 records (engine='auto') and its matrix-free "
          "summary_am")
    c = prep["zmat_cohort"]
    h = ep.GenoHandle(n=c.n, p=c.p, source="zmat_parity",
                      store_dir=c.store_dir)
    t0 = time.perf_counter()
    res = ep.am("y", h, {"y": prep["y_rec"]},
                Zmat=incidence(prep["z_idx"], c.n), maxit=3,
                engine="matfree")
    print(f"cuda: indices {res.indices} (planted {c.qtl_idx.tolist()})  "
          f"extBIC {[round(v, 4) for v in res.extbic_path]}  "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(len(res.indices) >= 1, "the Zmat parity scan selected nothing")
    card = {"indices": res.indices, "extbic_path": res.extbic_path}

    n, p = N, 65536
    t0 = time.perf_counter()
    c = simulate_cohort(os.path.join(tmp, "zmat"), n=n, p=p, n_qtl=8,
                        seed=seed + 3, device=dev)
    z_idx, y = records(c, 10000, seed)
    Z = incidence(z_idx, c.n)
    print(f"cohort {n} x {p} and its {Z.shape[0]} records made in "
          f"{time.perf_counter() - t0:.1f} s (the dense Zmat {Z.nbytes / 1e9:.1f}"
          f" GB, nearly all of it untouched zero pages); planted QTL "
          f"{c.qtl_idx.tolist()}", flush=True)
    h = ep.GenoHandle(n=c.n, p=c.p, source="zmat", store_dir=c.store_dir)
    log = os.path.join(tmp, "zmat.jsonl")
    res, wall, launches = run_counted(torch, packed, lambda: ep.am(
        "y", h, {"y": y}, Zmat=Z, maxit=3, engine="auto", log_jsonl=log))
    phases = scan_phases(read_log(log))
    print(f"am(Zmat, engine='auto'): {wall:.1f} s; phases "
          + ", ".join(f"{k} " + " / ".join(f"{w:.2f}" for w in v)
                      for k, v in phases.items())
          + f" s; launches {launches}; selected {res.indices}; extBIC "
          f"{res.extbic_path}", flush=True)
    check(len(res.indices) >= 1, "the full-width Zmat scan selected nothing")
    check(set(res.indices) <= set(int(q) for q in c.qtl_idx),
          f"Zmat: selected SNPs {res.indices} are not all planted QTL")
    check(all(math.isfinite(v) for v in res.extbic_path),
          "non-finite extBIC on the Zmat scan")
    for k in KERNELS:
        check(launches[k] >= 1, f"{k} was never launched by am() with Zmat")
    summ, s_wall, s_launches = run_counted(torch, packed, lambda: (
        ep.summary_am(res, "y", h, {"y": y}, Zmat=Z, engine="matfree",
                      quiet=True)))
    print(f"summary_am(Zmat, engine='matfree'): {s_wall:.2f} s; beta "
          f"{summ.beta}, se {summ.se}, p {summ.pvalue}; launches "
          f"{s_launches}", flush=True)
    check(bool(np.all(np.isfinite(summ.beta)) and np.all(summ.se > 0)),
          "the Zmat summary has non-finite beta or se")
    check(bool(np.all(summ.pvalue < 0.05)), "a selected planted marker has "
          f"p >= 0.05 in the Zmat summary: {summ.pvalue}")
    del Z
    return {"cohort": c, "launches": launches, "wall_s": wall,
            "phases": phases, "summary_s": s_wall, "card": card}


def trait_pairs(ep, c, seed: int) -> tuple[dict, list]:
    """Four traits over cohort ``c``: three each carry a disjoint pair of
    its planted QTL (h² 0.3 a trait), one is pure noise."""
    store = ep.GenotypeStore.open(c.store_dir)
    rng = np.random.default_rng(seed)
    pheno, pairs = {}, []
    for t in range(3):
        pair = [int(q) for q in c.qtl_idx[2 * t : 2 * t + 2]]
        g = sum(b * (store.column(j) - store.column(j).mean())
                for b, j in zip(rng.choice((-1.0, 1.0), 2), pair))
        g = g / g.std() * np.sqrt(0.3)
        pheno[f"t{t}"] = g + rng.normal(0.0, np.sqrt(0.7), c.n)
        pairs.append(pair)
    pheno["noise"] = rng.standard_normal(c.n)
    return pheno, pairs + [[]]


def multi_phase(torch, ep, packed, tmp: str, parity_cohort, prep: dict,
                main_cohort, seed: int) -> dict:
    """am_multi on the matrix-free engine (BASELINE config 5 at biobank n):
    the card leg of the parity cell at 2000 × 20 000, each trait held to
    the single-trait matrix-free am() on the card, then four traits on
    ``main_cohort`` (auto; phase 12's 50 000 × 65 536), with the widths
    packed_dot launched at."""
    phase("13. am_multi on the matrix-free engine: parity at 2000 x 20 000 "
          "on cuda (against single-trait am; the cpu leg: phase 15), then "
          f"R = 4 traits at {main_cohort.n} x {main_cohort.p} "
          "(engine='auto')")
    c = parity_cohort
    h = ep.GenoHandle(n=c.n, p=c.p, source="parity", store_dir=c.store_dir)
    pheno = prep["pheno"]
    traits = list(pheno)
    t0 = time.perf_counter()
    res = ep.am_multi(traits, h, pheno, maxit=3, engine="matfree")
    print("cuda: " + "; ".join(f"{t} {r.indices}" for t, r in res.items())
          + f"  {time.perf_counter() - t0:.1f} s", flush=True)
    single = {t: ep.am(t, h, pheno, maxit=3, engine="matfree")
              for t in traits}
    gaps = {t: rel_gap(res[t].extbic_path, single[t].extbic_path)
            for t in traits}
    print("largest relative extBIC gaps, am_multi vs single-trait am on the "
          "card: " + ", ".join(f"{t} {g:.2e}" for t, g in gaps.items()),
          flush=True)
    for t, pair in zip(traits, prep["pairs"]):
        check(res[t].indices == single[t].indices,
              f"am_multi {t}: differs from single-trait am()")
        check(gaps[t] <= 1e-3, f"am_multi {t}: extBIC beyond rtol 1e-3 of "
              "single-trait am()")
        check(set(res[t].indices) <= set(pair),
              f"am_multi {t}: selected {res[t].indices}, not its own QTL")
    check(any(res[t].indices for t in traits),
          "the am_multi parity scan selected nothing")
    card = {t: {"indices": r.indices, "extbic_path": r.extbic_path}
            for t, r in res.items()}

    c = main_cohort
    h = ep.GenoHandle(n=c.n, p=c.p, source="cohort", store_dir=c.store_dir)
    pheno, pairs = trait_pairs(ep, c, seed)
    traits = list(pheno)
    log = os.path.join(tmp, "multi.jsonl")
    rec = LaunchRecorder(packed, keep=lambda name, r: (
        name == "packed_dot" and r > 144))
    res, wall, launches = run_counted(torch, packed, lambda: ep.am_multi(
        traits, h, pheno, maxit=3, engine="auto", log_jsonl=log), rec)
    phases = scan_phases(read_log(log))
    k1_widths = dict(sorted(rec.widths["packed_dot"].items()))
    print(f"am_multi(R = {len(traits)}, engine='auto'): {wall:.1f} s; "
          "phases " + ", ".join(f"{k} " + " / ".join(f"{w:.2f}" for w in v)
                                for k, v in phases.items())
          + f" s; launches {launches}", flush=True)
    print(f"packed_dot launched at widths (r: launches) {k1_widths}")
    for t, pair in zip(traits, pairs):
        print(f"  {t}: selected {res[t].indices} (its planted pair {pair}); "
              f"extBIC {res[t].extbic_path}")
        check(set(res[t].indices) <= set(pair),
              f"am_multi {t}: selected {res[t].indices}, not its own QTL")
        check(all(math.isfinite(v) for v in res[t].extbic_path),
              f"am_multi {t}: non-finite extBIC")
    check(res["noise"].indices == [], "the noise trait selected SNPs")
    check(all(res[t].indices for t in traits[:3]),
          "a trait with planted QTL selected nothing")
    check(max(k1_widths) > 144, "packed_dot never ran wider than one tile")
    for k in KERNELS:
        check(launches[k] >= 1, f"{k} was never launched by am_multi")
    wide = kept_checks(torch, packed, rec.kept, "am_multi")
    return {"launches": launches, "wall_s": wall, "phases": phases,
            "k1_widths": k1_widths, "wide_rel_err": wide.get("packed_dot"),
            "card": card}


def fpr_matfree_phase(torch, ep, packed, parity_cohort,
                      zmat_cohort) -> dict:
    """fpr4am on the matrix-free engine: the card leg of the parity cell
    (20 permutations at 2000 × 20 000), then 10 permutations (BASELINE's
    100 cut) at 50 000 × 65 536 (p cut from 262 144), which auto routes
    to it."""
    reps, big_reps = 20, 10
    phase(f"14. fpr4am on the matrix-free engine: parity at 2000 x 20 000 "
          f"({reps} permutations, on cuda; the cpu leg: phase 15), then "
          f"{big_reps} permutations at {zmat_cohort.n} x {zmat_cohort.p} "
          "(engine='auto')")
    c = parity_cohort
    h = ep.GenoHandle(n=c.n, p=c.p, source="parity", store_dir=c.store_dir)
    t0 = time.perf_counter()
    cal = ep.fpr4am("y", h, {"y": c.y}, numreps=reps, seed=1,
                    engine="matfree")
    print(f"cuda: candidates {cal['candidates'].tolist()}  lambda* "
          f"{cal['lambda']:.6f}  {time.perf_counter() - t0:.1f} s",
          flush=True)
    card = {"candidates": cal["candidates"].tolist(),
            "lambda_crits": cal["lambda_crits"].tolist(),
            "lambda": cal["lambda"]}

    c = zmat_cohort
    h = ep.GenoHandle(n=c.n, p=c.p, source="zmat", store_dir=c.store_dir)
    out, wall, launches = run_counted(torch, packed, lambda: ep.fpr4am(
        "y", h, {"y": c.y}, numreps=big_reps, seed=1))
    crits = np.asarray(out["lambda_crits"])
    print(f"fpr4am({big_reps} permutations, engine='auto'): {wall:.1f} s, "
          f"{wall / big_reps:.2f} s a permutation; lambda* "
          f"{out['lambda']:.4f}, "
          f"lambda_crit range [{crits.min():.3f}, {crits.max():.3f}]; "
          f"launches {launches}", flush=True)
    check(math.isfinite(out["lambda"]) and bool(np.all(np.isfinite(crits))),
          "non-finite lambda from the matrix-free fpr4am")
    for k in KERNELS:
        check(launches[k] >= 1, f"{k} was never launched by fpr4am")
    return {"launches": launches, "wall_s": wall,
            "per_perm_s": wall / big_reps, "card": card}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def collective_costs() -> dict:
    """OpTimer targets for the sharded engine's collectives: (FLOPs, bytes)
    of a call from its operands' shapes (each input read once, each output
    written once)."""
    from eagleeverything_tpu_torch.parallel import collectives

    def mmt(args):
        rows, n = args[0].shape
        return 2 * rows * n * n, 4 * (rows * n + n * n)

    def from_t(args):
        (rows, e), q = args[0].shape, args[2].shape[1]
        return 2 * rows * e * (q + 1) + 3 * rows * e, 4 * (rows * e + 2 * rows)

    return {"mmt_psum": (collectives, "mmt_psum", mmt),
            "score_and_argmax_from_T": (collectives,
                                        "score_and_argmax_from_T", from_t)}


def world1_phase(torch, ep, packed, kernels, tmp: str, cfg2: dict,
                 dev) -> dict:
    """Phase 16: the SNP-sharded exact engine at world 1 on a real NCCL
    group (``cpu:gloo,cuda:nccl`` over a local TCP store): phase 8's
    cohort, phase 8's selection; its collectives timed between CUDA
    events. Then the Lp-form sweep op in f32 and bf16 on the card."""
    import torch.distributed as dist
    from eagleeverything_tpu_torch.utils import distributed
    phase("16. world 1 on an NCCL group: am(engine='sharded') at BASELINE "
          "config 2 (2000 x 100 000, phase 8's cohort, uncut)")
    c = cfg2["cohort"]
    distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        backend = str(dist.get_backend_config())
        print(f"group: world {dist.get_world_size()}, backend {backend}",
              flush=True)
        check("cuda:nccl" in backend, f"no NCCL group for CUDA: {backend}")
        handle = ep.GenoHandle(n=c.n, p=c.p, source="config2",
                               store_dir=c.store_dir)
        log = os.path.join(tmp, "sharded_w1.jsonl")
        torch.cuda.synchronize()
        packed.reset_launches()
        t0 = time.perf_counter()
        with OpTimer(torch, collective_costs()) as timer:
            res = ep.am("y", handle, {"y": c.y}, maxit=10,
                        engine="sharded", log_jsonl=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(packed.LAUNCHES)
        ops = timer.report()
        warm = warm_collectives(torch, ep, c, dev)
    finally:
        distributed.shutdown()
    phases = scan_phases(read_log(log))
    print("  phase mmt {:.3f} s, eigh {:.3f} s, sweeps {} s".format(
        phases["mmt"][0], phases["eigh"][0],
        " / ".join(f"{w:.3f}" for w in phases.get("sweep", []))))
    print_ops(ops)
    print(f"selected {res.indices} (phase 8: {cfg2['indices']}); extBIC "
          f"path {res.extbic_path}")
    gap = rel_gap(res.extbic_path, cfg2["extbic_path"])
    print(f"am(engine='sharded') wall {wall:.1f} s; extBIC gap to phase 8 "
          f"{gap:.2e}; packed-stack launches {launches}", flush=True)
    check(res.indices == cfg2["indices"],
          "the sharded engine selected other SNPs than phase 8")
    check(gap <= 1e-6, f"extBIC of the sharded engine off phase 8's: {gap}")
    check(not any(launches.values()),
          f"the sharded engine launched packed-stack kernels: {launches}")
    check(ops["mmt_psum"]["calls"] == 1 and
          ops["score_and_argmax_from_T"]["calls"] >= 1,
          "the sharded engine did not run its collectives")
    print("  (the calls inside am() carry the NCCL communicators' set-up, "
          "made at each group's first collective)")
    for name, w in warm.items():
        print(f"{name} (warm, median of {w['reps']}, CUDA events): "
              f"{w['ms']:.3f} ms; bound {w['bound_ms']:.3f} ms "
              f"({w['bound_by']}: {w['flops'] / 1e9:.1f} GFLOP at 67 TFLOP/s "
              f"fp32, {w['bytes'] / 1e9:.3f} GB at 3.35 TB/s)", flush=True)

    # the Lp-form sweep op (the bench's sweep rung) at config 2's n
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    W = torch.randint(-1, 2, (16384, c.n), generator=gen, device=dev,
                      dtype=torch.int8).to(torch.float32)
    Lp = torch.randn((c.n, 24), generator=gen, device=dev) / 10
    Py = torch.randn(c.n, generator=gen, device=dev)
    sweep_ms = {}
    for name in ("score_tile_sqrt", "score_tile_sqrt_bf16"):
        fn = getattr(kernels, name)
        out, sweep_ms[name] = timed(
            torch, lambda fn=fn: fn(W, Lp, Py, 0.7), reps=10, warmup=2)
        sweep_ms[name + "_out"] = out
    _, rel = rel_err(torch, sweep_ms.pop("score_tile_sqrt_bf16_out"),
                     sweep_ms.pop("score_tile_sqrt_out"))
    print(f"score_tile_sqrt on a 16 384 x {c.n} tile: f32 "
          f"{sweep_ms['score_tile_sqrt']:.3f} ms, bf16 "
          f"{sweep_ms['score_tile_sqrt_bf16']:.3f} ms; bf16 rel err {rel:.2e}"
          " (the JAX package states ~1e-2 for its bf16 policy)", flush=True)
    check(rel <= 1e-2, f"the bf16 sweep op is off the f32 one: {rel:.2e}")
    return {"indices": res.indices, "extbic_path": res.extbic_path,
            "wall_s": wall, "ops": ops, "phases": phases,
            "sweep_ms": sweep_ms, "warm": warm}


def warm_collectives(torch, ep, c, dev) -> dict:
    """``mmt_psum`` and ``score_and_argmax_from_T`` timed on their own over
    a ShardedScan of cohort ``c`` (the group open, its communicators made
    by the am() before): CUDA events, median of several calls, beside the
    bound of each (FLOPs at the fp32 peak — the products are IEEE fp32 —
    or bytes at the HBM rate, each input read once)."""
    from eagleeverything_tpu_torch.models import engine_torch
    from eagleeverything_tpu_torch.parallel import collectives
    from eagleeverything_tpu_torch.utils.config import DEFAULT_CONFIG
    handle = ep.GenoHandle(n=c.n, p=c.p, source="config2",
                           store_dir=c.store_dir)
    scan = engine_torch.ShardedScan(
        engine_torch._make_source(handle, None), DEFAULT_CONFIG, dev)
    rows, n = scan.Wt.shape
    _, mmt_ms = timed(torch, lambda: collectives.mmt_psum(scan.Wt,
                                                          scan.mesh),
                      reps=5, warmup=1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    U, _ = torch.linalg.qr(torch.randn((n, n), generator=gen, device=dev))
    scan.set_eigenbasis(U)
    q = 16
    s = torch.rand(n, generator=gen, device=dev) + 0.5
    Q, _ = torch.linalg.qr(torch.randn((n, q), generator=gen, device=dev))
    z3 = torch.randn(n, generator=gen, device=dev)
    mask = scan._mask([])
    _, sweep_ms = timed(
        torch, lambda: collectives.score_and_argmax_from_T(
            scan._T, s, Q, z3, 0.7, mask, scan.mesh), reps=10, warmup=2)
    out = {}
    for name, ms, flops, nbytes, reps in (
            ("mmt_psum", mmt_ms, 2 * rows * n * n, 4 * (rows * n + n * n), 5),
            ("score_and_argmax_from_T", sweep_ms,
             2 * rows * n * (q + 1) + 3 * rows * n, 4 * (rows * n + rows), 10)):
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = {"ms": ms, "reps": reps, "flops": flops, "bytes": nbytes,
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes"}
    del scan
    torch.cuda.empty_cache()
    return out


def rank_job(spec_path: str, out_path: str) -> int:
    """One rank of phase 17 (``--rank SPEC OUT``, started by
    :func:`two_rank_phase`): joins the group on the transport the phase
    chose, runs the sharded scan and the matrix-free scan through ``am``,
    and writes what it selected, its kernel launches and the transport's
    cost."""
    import hashlib
    import torch
    import torch.distributed as dist
    import eagleeverything_tpu_torch as ep
    from eagleeverything_tpu_torch.ops import packed
    from eagleeverything_tpu_torch.utils import distributed
    with open(spec_path) as f:
        spec = json.load(f)
    distributed.initialize(os.environ["EAGLE_COORD_ADDR"], 2,
                           int(os.environ["EAGLE_PROC_ID"]),
                           backend=spec["transport"])
    rank = distributed.process_index()
    out = {"rank": rank}

    def scan(key: str, engine: str, recorder=None) -> dict:
        job = spec[key]
        handle = ep.GenoHandle(n=job["n"], p=job["p"], source=key,
                               store_dir=job["store"])
        y = np.load(job["y"])
        log = f"{out_path}.{key}.jsonl"
        # the device all-reduces (the Krylov steps' K·V blocks, the
        # sharded sweeps' collectives) counted and timed around the call
        calls, real = [], dist.all_reduce

        def all_reduce(t, *a, **k):
            if not t.is_cuda:
                return real(t, *a, **k)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            res = real(t, *a, **k)
            ev[1].record()
            calls.append(ev)
            return res

        dist.all_reduce = all_reduce
        try:
            res, wall, launches = run_counted(
                torch, packed, lambda: ep.am("y", handle, {"y": y},
                                             maxit=job["maxit"],
                                             engine=engine, log_jsonl=log),
                recorder)
        finally:
            dist.all_reduce = real
        t = np.stack(res.outlier_stats)
        return {"indices": res.indices, "extbic_path": res.extbic_path,
                "t_sha256": hashlib.sha256(t.tobytes()).hexdigest(),
                "wall_s": wall, "launches": launches,
                "allreduces": len(calls),
                "allreduce_ms": sum(a.elapsed_time(b) for a, b in calls),
                # only rank 0 writes the scan log
                "phases": (scan_phases(read_log(log)) if os.path.exists(log)
                           else {})}

    out["sharded"] = scan("sharded", "sharded")
    rec = LaunchRecorder(packed, keep=lambda name, r: name != "kernel_matvec")
    out["matfree"] = scan("matfree", "matfree", rec)
    out["matfree"]["widths"] = {name: {str(r): c for r, c in w.items()}
                                for name, w in rec.widths.items()}
    out["matfree"]["rel_err"] = kept_checks(
        torch, packed, rec.kept, f"rank {rank}'s matrix-free am")
    out["matfree"]["checked"] = len(rec.kept)
    distributed.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def two_rank_phase(torch, tmp: str, cfg2: dict, world1: dict, main: dict,
                   timeout: float) -> dict:
    """Phase 17: two ranks of this script on the one card, over gloo with
    the CUDA tensors handed to it (NCCL refuses two ranks on one device):
    ``am(engine="sharded")`` on phase 8's cohort (about 50 000 SNPs a
    rank) and ``am(engine="matfree")`` through MultiHostTiledScan on phase
    6's cohort (131 072 SNPs a rank). Both ranks must exit 0 with equal
    bits, phase 16's and phase 6's selections. Two ranks on one card
    measure correctness and the transport's cost, not scaling."""
    transport = "gloo"
    c2, c6 = cfg2["cohort"], main["cohort"]
    phase(f"17. two ranks on the one card (transport: {transport}, the CUDA "
          f"tensors handed to it): am(engine='sharded') at {c2.n} x {c2.p}, "
          f"am(engine='matfree') at {c6.n} x {c6.p}")
    spec = {"transport": transport}
    for key, c, maxit in (("sharded", c2, 10), ("matfree", c6, 3)):
        y = os.path.join(tmp, f"rank_{key}_y.npy")
        np.save(y, c.y)
        spec[key] = {"store": c.store_dir, "n": c.n, "p": c.p, "y": y,
                     "maxit": maxit}
    spec_path = os.path.join(tmp, "ranks.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    addr = f"127.0.0.1:{free_port()}"
    procs, logs, outs = [], [], []
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        for r in (0, 1):
            outs.append(os.path.join(tmp, f"rank{r}.json"))
            logs.append(open(os.path.join(tmp, f"rank{r}.log"), "w"))
            env = dict(os.environ, PYTHONPATH=ROOT, EAGLE_COORD_ADDR=addr,
                       EAGLE_NUM_PROCS="2", EAGLE_PROC_ID=str(r),
                       OMP_NUM_THREADS="4")
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank",
                 spec_path, outs[-1]], cwd=ROOT, env=env, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        deadline = time.perf_counter() + timeout
        for pr in procs:
            try:
                pr.wait(timeout=max(deadline - time.perf_counter(), 1.0))
            except subprocess.TimeoutExpired:
                break
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
            pr.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    texts = []
    for r, pr in enumerate(procs):
        with open(os.path.join(tmp, f"rank{r}.log")) as f:
            texts.append(f.read())
        print(f"-- rank {r} (rc {pr.returncode}), the end of its log:\n"
              + texts[-1][-1500:], flush=True)
    for r, pr in enumerate(procs):
        check(pr.returncode == 0, f"rank {r} of phase 17 exited "
              f"{pr.returncode}")
    res = []
    for path in outs:
        with open(path) as f:
            res.append(json.load(f))
    for key in ("sharded", "matfree"):
        for field in ("indices", "extbic_path", "t_sha256"):
            check(res[0][key][field] == res[1][key][field],
                  f"the ranks' {key} {field} differ")
        for r in (0, 1):
            o = res[r][key]
            ph = " ".join(f"{k} " + "/".join(f"{w:.2f}" for w in v)
                          for k, v in o["phases"].items())
            print(f"rank {r} {key}: am() {o['wall_s']:.1f} s ({ph}); "
                  f"{o['allreduces']} device all-reduces, "
                  f"{o['allreduce_ms']:.1f} ms; launches {o['launches']}",
                  flush=True)
    for r in (0, 1):
        o = res[r]["matfree"]
        print(f"rank {r}: {o['checked']} first launches (a kernel at a "
              "width) held against the plain version, worst rel err "
              + ", ".join(f"{k} {v:.2e}" for k, v in o["rel_err"].items()),
              flush=True)
    sh, mf = res[0]["sharded"], res[0]["matfree"]
    print(f"sharded selected {sh['indices']} (phase 16: "
          f"{world1['indices']}); matrix-free selected {mf['indices']} "
          f"(phase 6: {main['indices']}); phase wall {wall:.1f} s "
          f"(process start and both scans)", flush=True)
    check(sh["indices"] == world1["indices"],
          "two ranks' sharded scan selected other SNPs than phase 16")
    gap_sh = rel_gap(sh["extbic_path"], world1["extbic_path"])
    check(gap_sh <= 1e-6, f"two ranks' sharded extBIC off: {gap_sh:.2e}")
    check(mf["indices"] == main["indices"],
          "two ranks' matrix-free scan selected other SNPs than phase 6")
    gap_mf = rel_gap(mf["extbic_path"], main["extbic_path"])
    check(gap_mf <= 1e-3, f"two ranks' matrix-free extBIC off: {gap_mf:.2e}")
    check(set(mf["indices"]) <= set(int(q) for q in c6.qtl_idx),
          f"two ranks selected SNPs {mf['indices']} that are not planted")
    for r in (0, 1):
        for name in KERNELS:
            check(res[r]["matfree"]["launches"][name] >= 1,
                  f"{name} never launched on rank {r}")
        check(res[r]["matfree"]["allreduces"] >= 1,
              f"rank {r}'s collective device Krylov did not engage")
    print(f"extBIC gaps: sharded {gap_sh:.2e} (to phase 16), matrix-free "
          f"{gap_mf:.2e} (to phase 6)", flush=True)
    return {"ranks": res, "transport": transport, "wall_s": wall,
            "gap_sharded": gap_sh, "gap_matfree": gap_mf}


def legs_phase(legs: CpuLegs, cards: dict, timeout: float) -> dict:
    """Phase 15: wait for the CPU legs and hold each matrix-free parity
    cell's card leg to its CPU leg — the same selections (candidates),
    extBIC (λ_crit) within rtol 1e-3."""
    phase("15. matrix-free parity cells, cuda against cpu (the cpu legs ran "
          "in a process of their own beside phases 7-14)")
    cpu, wall = legs.results(timeout)
    print("cpu legs: " + ", ".join(f"{k} {v['s']:.1f} s"
                                   for k, v in cpu.items())
          + f"; {wall:.1f} s from their start", flush=True)
    gaps = {}

    def same_scan(key, a, b):
        print(f"  {key}: cuda {a['indices']}, cpu {b['indices']}; extBIC "
              f"gap {rel_gap(a['extbic_path'], b['extbic_path']):.2e}")
        check(a["indices"] == b["indices"],
              f"{key}: cuda and cpu selections differ")
        gaps[key] = rel_gap(a["extbic_path"], b["extbic_path"])
        check(gaps[key] <= 1e-3, f"{key}: extBIC gap {gaps[key]:.3e}")

    same_scan("am", cards["am"], cpu["am"]["result"])
    same_scan("zmat", cards["zmat"], cpu["zmat"]["result"])
    for t, a in cards["am_multi"].items():
        same_scan(f"am_multi {t}", a, cpu["am_multi"]["result"][t])
    a, b = cards["fpr4am"], cpu["fpr4am"]["result"]
    gaps["fpr4am"] = rel_gap(a["lambda_crits"], b["lambda_crits"])
    print(f"  fpr4am: candidates equal {a['candidates'] == b['candidates']}; "
          f"lambda_crit gap {gaps['fpr4am']:.2e}, lambda* {a['lambda']:.6f} "
          f"/ {b['lambda']:.6f}", flush=True)
    check(a["candidates"] == b["candidates"],
          "fpr4am: candidates differ between cuda and cpu")
    check(gaps["fpr4am"] <= 1e-3, f"fpr4am: lambda_crit gap "
          f"{gaps['fpr4am']:.3e}")
    return {"gaps": gaps, "cpu_s": {k: v["s"] for k, v in cpu.items()}}


def exact_parity_phase(torch, ep, tmp: str, seed: int, dev) -> dict:
    from eagleeverything_tpu_torch.data.simulate import simulate_cohort
    n, p = 2000, 20000
    phase(f"7. exact parity: am(engine='jax') at n={n}, p={p} on cuda and "
          "cpu")
    c = simulate_cohort(os.path.join(tmp, "exact_parity"), n=n, p=p,
                        seed=seed, device=dev)
    h = ep.GenoHandle(n=n, p=p, source="exact_parity", store_dir=c.store_dir)
    out = {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out[d] = ep.am("y", h, {"y": c.y}, maxit=5, engine="jax", device=d)
        print(f"{d}: indices {out[d].indices}  extBIC "
              f"{[round(v, 4) for v in out[d].extbic_path]}  "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(out["cuda"].indices == out["cpu"].indices,
          "cuda and cpu selections differ on the exact engine")
    check(len(out["cuda"].indices) >= 1, "the exact parity scan selected "
          "nothing")
    gap = float(np.max(np.abs(np.subtract(out["cuda"].extbic_path,
                                          out["cpu"].extbic_path))
                       / np.abs(out["cpu"].extbic_path)))
    print(f"largest relative extBIC gap, cuda vs cpu: {gap:.3e} (limit 1e-6)")
    check(gap <= 1e-6, f"cuda and cpu extBIC paths differ by {gap:.3e} > "
          "1e-6 relative")
    return {"gap": gap, "cohort": c, "result": out["cuda"]}


def exact_scan_phase(torch, ep, packed, kernels, engine_torch, tmp: str,
                     title: str, n: int, p: int, maxit: int, seed: int,
                     dev, extra: dict | None = None) -> dict:
    """``am(engine="auto")`` on a generated n × p cohort (8 planted QTL)
    that auto routes to the exact engine, with the device ops (and the
    ``extra`` OpTimer targets) counted and timed, the packed-stack kernels'
    launch counts read around exactly that call, and the eigenbasis it
    used kept for the caller's checks."""
    from eagleeverything_tpu_torch.data.simulate import simulate_cohort
    phase(f"{title}: am(engine='auto') on a generated cohort of {n} x {p} "
          f"(seed {seed}, 8 planted QTL, maxit {maxit})")
    check(n <= ep.EagleConfig().matfree_min_n,
          f"n={n} would take the matrix-free engine")
    t0 = time.perf_counter()
    c = simulate_cohort(os.path.join(tmp, f"exact_{n}x{p}"), n=n, p=p,
                        n_qtl=8, seed=seed, device=dev)
    print(f"cohort written in {time.perf_counter() - t0:.1f} s; planted QTL "
          f"{c.qtl_idx.tolist()}", flush=True)
    log = os.path.join(tmp, f"exact_{n}x{p}.jsonl")
    handle = ep.GenoHandle(n=n, p=p, source=f"exact_{n}x{p}",
                           store_dir=c.store_dir)
    targets = exact_op_targets(torch, kernels)
    targets["eigh_basis"] = (engine_torch, "eigh_basis", lambda a: (0, 0))
    targets.update(extra or {})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    packed.reset_launches()
    t0 = time.perf_counter()
    with OpTimer(torch, targets) as timer:
        res = ep.am("y", handle, {"y": c.y}, maxit=maxit, engine="auto",
                    log_jsonl=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(packed.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ops = timer.report()
    del ops["eigh_basis"]
    phases = scan_phases(read_log(log))
    sweeps = phases.get("sweep", [])
    tile = ep.EagleConfig().resolve_snp_tile(n, -(-p // 128) * 128)
    n_tiles = -(-p // tile)
    print(f"  phase mmt {phases['mmt'][0]:.3f} s ({2 * p * n * n / 1e12:.2f} "
          f"TFLOP), eigh {phases['eigh'][0]:.3f} s, sweeps "
          + " / ".join(f"{w:.3f}" for w in sweeps) + " s")
    later = sweeps[1:] or sweeps
    snps_s = {"first_sweep": p / sweeps[0],
              "later_sweeps_median": p / float(np.median(later))}
    print(f"  SNPs scored per second: first sweep {snps_s['first_sweep']:.0f}"
          f", later sweeps (median) {snps_s['later_sweeps_median']:.0f}")
    print(f"  {n_tiles} tiles of {tile} SNPs; device ops (CUDA events around "
          "each call):")
    print_ops(ops)
    print(f"selected {res.indices} (planted {c.qtl_idx.tolist()})")
    print(f"extBIC path {res.extbic_path}")
    print(f"am() wall {wall:.1f} s; packed-stack kernel launches {launches}; "
          f"peak device memory {peak / 1e9:.2f} GB", flush=True)
    check(not any(launches.values()),
          f"the exact engine launched packed-stack kernels: {launches}")
    check(len(res.indices) >= 1, f"the {n} x {p} scan selected nothing")
    check(set(res.indices) <= set(int(q) for q in c.qtl_idx),
          f"selected SNPs {res.indices} are not all planted QTL")
    check(all(math.isfinite(v) for v in res.extbic_path),
          "non-finite extBIC on the exact engine")
    check(ops["mmt_accumulate"]["calls"] == n_tiles,
          "mmt_accumulate was not called once a tile")
    return {"wall_s": wall, "peak_bytes": peak, "phases": phases,
            "snps_per_s": snps_s, "ops": ops, "n_tiles": n_tiles,
            "basis": timer.last["eigh_basis"], "indices": res.indices,
            "extbic_path": res.extbic_path, "cohort": c}


def config2_phase(torch, ep, packed, kernels, engine_torch, tmp: str,
                  seed: int, dev) -> dict:
    """BASELINE config 2 at its full size: the main path of the exact
    engine. Its W and T tiles fit the device cache, so T is computed once
    and the host eigendecomposition keeps U on the host."""
    out = exact_scan_phase(torch, ep, packed, kernels, engine_torch, tmp,
                           "8. BASELINE config 2 (exact engine)", 2000,
                           100000, 10, seed, dev)
    nt = out["n_tiles"]
    check(out["basis"].host_f64 is not None,
          "config 2 must decompose K on the host (n ≤ host_eigh_max_n)")
    check(out["ops"]["eig_T_tile"]["calls"] == nt,
          "T must be computed once a tile and cached")
    check(out["ops"]["unpack_recode_tile"]["calls"] == nt,
          "W must be recoded once a tile and cached")
    return out


def large_n_phase(torch, ep, packed, kernels, engine_torch, tmp: str,
                  seed: int, dev) -> dict:
    """The exact engine above host_eigh_max_n: the eigendecomposition runs
    on the card and U never reaches the host; p·n·4 bytes of T exceed half
    of device_cache_gb, so every sweep recodes W and recomputes T."""
    n, p = 16384, 65536
    cfg = ep.EagleConfig()
    check(n > cfg.host_eigh_max_n and p * n * 4 > 0.5 * cfg.device_cache_gb
          * 1e9, "the large-n cell must take the device eigh, uncached T")
    out = exact_scan_phase(torch, ep, packed, kernels, engine_torch, tmp,
                           "9. large-n branch (exact engine)", n, p, 5, seed,
                           dev)
    nt, sweeps = out["n_tiles"], len(out["phases"]["sweep"])
    check(out["basis"].host_f64 is None,
          "U reached the host above host_eigh_max_n")
    check(out["ops"]["torch.linalg.eigh"]["calls"] == 1,
          "torch.linalg.eigh must run once on the card")
    check(out["ops"]["eig_T_tile"]["calls"] == nt * sweeps,
          "T must be recomputed every sweep")
    return out


def write_phase_files(sim_mod, sim, d: str) -> dict:
    """The workflow's input files, written by the port's writers: PLINK
    .bed/.bim/.fam, spaced ASCII with one-character codes, the phenotype
    table with its covariates, and the map. Prints each file's size and
    write time."""
    os.makedirs(d, exist_ok=True)
    f = {"bed": os.path.join(d, "geno.bed"), "txt": os.path.join(d,
                                                                  "geno.txt"),
         "pheno": os.path.join(d, "pheno.txt"),
         "map": os.path.join(d, "map.txt")}
    writes = (
        ("bed", lambda: sim_mod.write_plink_bed(sim, f["bed"]),
         [f["bed"], f["bed"][:-4] + ".bim", f["bed"][:-4] + ".fam"]),
        ("txt", lambda: sim_mod.write_ascii_geno(sim, f["txt"], AA="0",
                                                 AB="1", BB="2"), [f["txt"]]),
        ("pheno", lambda: sim_mod.write_pheno(sim, f["pheno"]), [f["pheno"]]),
        ("map", lambda: sim_mod.write_map(sim, f["map"]), [f["map"]]))
    for name, write, paths in writes:
        t0 = time.perf_counter()
        write()
        wall = time.perf_counter() - t0
        size = sum(os.path.getsize(p) for p in paths)
        print(f"  wrote {name:5s} {size / 1e6:9.1f} MB in {wall:6.2f} s "
              f"({', '.join(os.path.basename(p) for p in paths)})",
              flush=True)
    return f


def same_shards(a, b) -> bool:
    """Two stores hold the same shard files, byte for byte."""
    import filecmp
    if a.shard_offsets != b.shard_offsets or (a.n, a.p) != (b.n, b.p):
        return False
    return all(filecmp.cmp(os.path.join(a.dir, f"shard_{k:05d}.bin"),
                           os.path.join(b.dir, f"shard_{k:05d}.bin"),
                           shallow=False) for k in range(a.n_shards))


def kept_checks(torch, packed, kept: dict, what: str) -> dict:
    """Hold each launch a LaunchRecorder kept against the plain version on
    the same operand, at TOL, on the card (a streamed run's host copies
    are moved there, each chunk once). Returns {kernel: worst rel err}."""
    worst = {}
    on_card = {}

    def card(t):
        if t.is_cuda:
            return t
        if id(t) not in on_card:
            on_card[id(t)] = t.cuda()
        return on_card[id(t)]

    for key, (Wp, means, n, X, got) in sorted(kept.items()):
        name, r = key[:2]
        Wp, means, X, got = card(Wp), card(means), X.cuda(), got.cuda()
        ref = getattr(packed, f"{name}_plain")(Wp, X, means, n)
        err, rel = rel_err(torch, got, ref)
        worst[name] = max(worst.get(name, 0.0), rel)
        print(f"  {name:14s} n={n} p={Wp.shape[0]} r={r:3d} (as {what} "
              f"launched it): max abs err {err:.3e}, rel {rel:.3e}")
        check(rel <= TOL, f"{name} disagrees with its plain version on "
              f"{what}'s operand at r={r}: rel {rel:.3e}")
    return worst


def summary_kernel_checks(torch, packed, kept: dict, delta: float) -> dict:
    """Hold each launch that the matrix-free summary kept (the first at each
    width: the s0 probe's and the CG's) against the plain version on the
    same operand, at TOL. Then print how much of H·P = K·P/s0 + δ·P the
    kernel carries in the first CG step: where δ dominates, the summary's
    β and se barely depend on K, and only these checks hold the kernels.
    Returns {kernel: worst rel err}."""
    worst = kept_checks(torch, packed, kept, "the matrix-free summary")
    check(set(worst) == set(LaunchRecorder.NAMES),
          f"the matrix-free summary called only {sorted(worst)}")
    widths = sorted(r for name, r in kept if name == "kernel_matvec")
    if 16 in widths and len(widths) > 1:
        _, _, n, Z, KZ = kept[("kernel_matvec", 16)]
        s0 = float((Z * KZ).sum(0).mean()) / n
        _, _, _, P, KP = kept[("kernel_matvec",
                               next(r for r in widths if r != 16))]
        share = float(KP.norm()) / s0 / (delta * float(P.norm()))
        print(f"  first CG step: |K·P/s0| / |δ·P| = {share:.3e} (s0 "
              f"{s0:.2f}, δ {delta:.4g})", flush=True)
    return worst


def workflow_phase(torch, ep, packed, engine_torch, tmp: str, cfg2: dict,
                   seed: int) -> dict:
    """Eagle's workflow around am() at BASELINE config 2, uncut, on phase
    8's cohort through files: write them, read them with the native
    ingest, scan, summarise (exact and matrix-free), calibrate λ, plot to
    .html and run the CLI."""
    from eagleeverything_tpu_torch.data import simulate as sim_mod
    from eagleeverything_tpu_torch.io import native
    c = cfg2["cohort"]
    n, p = c.n, c.p
    phase(f"10. Eagle's workflow on BASELINE config 2 ({n} x {p}, uncut) "
          "through files: write, read_marker (native), am, summary_am "
          "(exact, matfree), fpr4am (100 permutations), plot_am (.html), "
          "the CLI")
    out: dict = {}
    store = ep.GenotypeStore.open(c.store_dir)
    t0 = time.perf_counter()
    G = store.to_dense()
    print(f"phase 8's store: {store.n_shards} shards, to_dense "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(seed)
    chrom = np.arange(p) * 20 // p + 1          # 20 chromosomes
    pos = np.concatenate([np.sort(rng.integers(1, 150_000_000,
                                               int((chrom == k).sum())))
                          for k in range(1, 21)])
    sim = sim_mod.SimData(
        geno=G, y=c.y, qtl_idx=c.qtl_idx, qtl_beta=c.qtl_beta, chrom=chrom,
        pos=pos, marker_names=[f"snp{j:06d}" for j in range(p)],
        covariate=rng.uniform(20, 60, size=n).round(1),
        group=rng.integers(0, 2, size=n))
    files = write_phase_files(sim_mod, sim, os.path.join(tmp, "workflow"))
    del G, sim

    check(native.get_lib() is not None,
          "the native ingest library did not build or load")
    print(f"native ingest library loaded: {native.lib_path()}")
    handles = {}
    for name, kw in (("bed", {"type": "PLINK"}),
                     ("txt", {"AA": "0", "AB": "1", "BB": "2"})):
        path = files[name]
        t0 = time.perf_counter()
        h = ep.read_marker(path, store_dir=path + ".store", packed=True,
                           n_shards=store.n_shards, **kw)
        wall = time.perf_counter() - t0
        mb = os.path.getsize(path) / 1e6
        out[f"read_{name}"] = {"s": wall, "MB_per_s": mb / wall}
        print(f"read_marker {os.path.basename(path)}: {mb:.1f} MB in "
              f"{wall:.2f} s, {mb / wall:.1f} MB/s", flush=True)
        check((h.n, h.p) == (n, p), f"{name}: read {h.n} x {h.p}")
        check(same_shards(ep.GenotypeStore.open(h.store_dir), store),
              f"the store read from {name} differs from phase 8's")
        handles[name] = h
    print("both stores hold phase 8's shard bytes")

    pheno = ep.read_pheno(files["pheno"])
    mp = ep.read_map(files["map"])
    h = handles["bed"]
    t0 = time.perf_counter()
    res = ep.am("y", h, pheno, map=mp, maxit=10)
    torch.cuda.synchronize()
    out["am_s"] = time.perf_counter() - t0
    gap = float(np.max(np.abs(np.subtract(res.extbic_path,
                                          cfg2["extbic_path"]))
                       / np.abs(cfg2["extbic_path"])))
    print(f"am(): {out['am_s']:.2f} s, selected {res.indices} "
          f"{res.marker_names}, extBIC {res.extbic_path}; phase 8: "
          f"{cfg2['indices']}, largest relative extBIC gap {gap:.3e} (y is "
          "read back at 6 decimals)", flush=True)
    check(res.indices == cfg2["indices"], "the scan from files selected "
          f"{res.indices}, phase 8 {cfg2['indices']}")
    check(gap <= 1e-5, f"extBIC path differs from phase 8's by {gap:.3e}")
    check(res.marker_names == [mp.marker_names[j] for j in res.indices],
          "marker names do not come from the map")

    sums = {}
    rec = LaunchRecorder(packed)
    for engine in ("exact", "matfree"):
        packed.reset_launches()
        t0 = time.perf_counter()
        with rec if engine == "matfree" else contextlib.nullcontext():
            sums[engine] = ep.summary_am(res, "y", h, pheno, quiet=True,
                                         engine=engine)
        torch.cuda.synchronize()
        out[f"summary_{engine}_s"] = time.perf_counter() - t0
        out[f"summary_{engine}_launches"] = dict(packed.LAUNCHES)
        s = sums[engine]
        print(f"summary_am(engine='{engine}'): "
              f"{out[f'summary_{engine}_s']:.2f} s, beta {s.beta}, se "
              f"{s.se}, p {s.pvalue}, %var {100 * s.var_explained}; "
              f"kernel launches {dict(packed.LAUNCHES)}", flush=True)
        check(bool(np.all(s.pvalue < 0.05)), f"{engine}: a selected planted "
              f"marker has p >= 0.05: {s.pvalue}")
    ex, mf = sums["exact"], sums["matfree"]
    check(np.allclose(mf.beta, ex.beta, rtol=0.05, atol=0.0)
          and np.allclose(mf.se, ex.se, rtol=0.10, atol=0.0),
          "the matrix-free summary is outside tests/test_api.py's bands "
          "(beta rtol 0.05, se rtol 0.10)")
    for k in KERNELS:
        check(out["summary_matfree_launches"][k] >= 1,
              f"{k} was never launched by the matrix-free summary")
    check(not any(out["summary_exact_launches"].values()),
          "the exact summary launched packed-stack kernels")
    out["summary_matfree_rel_err"] = summary_kernel_checks(
        torch, packed, rec.kept, res.delta)

    def sweep_cost(a):
        s, Q = a[1], a[2]
        R, q = s.shape[0], Q.shape[2]
        return (R * (2 * p * n * (1 + q) + 3 * p * n),
                4 * (p * n + R * n * (q + 2) + R * p))

    targets = {"sweep_eig_batched": (engine_torch.TiledScan,
                                     "sweep_eig_batched", sweep_cost)}
    reps = 100
    with OpTimer(torch, targets) as timer:
        t0 = time.perf_counter()
        cal = ep.fpr4am("y", h, pheno, numreps=reps, seed=1)
        torch.cuda.synchronize()
        out["fpr4am_s"] = time.perf_counter() - t0
    sweep = timer.report()["sweep_eig_batched"]
    out["fpr4am_sweep_ms"] = sweep.get("ms", 0.0)
    crits = np.asarray(cal["lambda_crits"])
    print(f"fpr4am({reps} permutations): {out['fpr4am_s']:.2f} s, "
          f"{out['fpr4am_s'] / reps * 1e3:.2f} ms a permutation; "
          f"sweep_eig_batched {sweep['calls']} call(s), "
          f"{out['fpr4am_sweep_ms']:.2f} ms; lambda* {cal['lambda']:.4f}, "
          f"lambda_crit range [{crits.min():.3f}, {crits.max():.3f}]",
          flush=True)
    print_ops({"sweep_eig_batched": sweep})
    check(bool(np.all(np.isfinite(crits))) and crits.size == reps,
          "non-finite lambda_crit")
    check(cal["lambda"] >= 0.0, "negative calibrated lambda")

    html = os.path.join(tmp, "workflow", "scan.html")
    t0 = time.perf_counter()
    ep.plot_am(res, mp, save=html)
    out["plot_s"] = time.perf_counter() - t0
    with open(html) as f:
        text = f.read()
    print(f"plot_am(.html): {out['plot_s']:.2f} s, {len(text) / 1e6:.2f} MB")
    check(all(name in text for name in res.marker_names),
          "the .html plot does not name every selected marker")
    check("matplotlib" not in sys.modules, "matplotlib was imported")

    cli_json = os.path.join(tmp, "workflow", "cli.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "eagleeverything_tpu_torch.cli", "am",
         "--geno", files["bed"], "--geno-type", "PLINK", "--pheno",
         files["pheno"], "--trait", "y", "--map", files["map"], "--maxit",
         "10", "--json", cli_json],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=600)
    out["cli_s"] = time.perf_counter() - t0
    check(proc.returncode == 0, f"the CLI failed: {proc.stderr[-2000:]}")
    with open(cli_json) as f:
        cli_res = json.load(f)
    print(f"CLI am (a process of its own): {out['cli_s']:.2f} s, indices "
          f"{cli_res['indices']}", flush=True)
    check(cli_res["indices"] == res.indices, "the CLI selected "
          f"{cli_res['indices']}, the API {res.indices}")
    return out


def fpr_parity_phase(torch, ep, parity: dict) -> dict:
    """fpr4am and the exact summary_am on the card against the CPU, on
    phase 7's cohort: K is a sum of integers, exact in f32, so the host
    REML sees the same inputs on both."""
    c = parity["cohort"]
    phase(f"11. fpr4am and summary_am parity, cuda against cpu, at "
          f"{c.n} x {c.p} (20 permutations)")
    h = ep.GenoHandle(n=c.n, p=c.p, source="exact_parity",
                      store_dir=c.store_dir)
    pheno = {"y": c.y}
    cal, summ = {}, {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        cal[d] = ep.fpr4am("y", h, pheno, numreps=20, seed=1, device=d)
        summ[d] = ep.summary_am(parity["result"], "y", h, pheno, quiet=True,
                                engine="exact", device=d)
        print(f"{d}: candidates {cal[d]['candidates'].tolist()}  lambda* "
              f"{cal[d]['lambda']:.6f}  p {summ[d].pvalue}  "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))

    gaps = {"lambda_crits": rel(cal["cuda"]["lambda_crits"],
                                cal["cpu"]["lambda_crits"])}
    for f in ("beta", "se", "pvalue"):
        gaps[f] = rel(getattr(summ["cuda"], f), getattr(summ["cpu"], f))
    print("largest relative gaps, cuda vs cpu (limit 1e-6): "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    check(np.array_equal(cal["cuda"]["candidates"],
                         cal["cpu"]["candidates"]),
          "fpr4am's per-permutation candidates differ between cuda and cpu")
    check(max(gaps.values()) <= 1e-6,
          f"cuda and cpu differ beyond rtol 1e-6: {gaps}")
    return gaps


def link_rate(torch, dev) -> dict:
    """The host link's rate: one 1 GiB page-locked host → card copy,
    between CUDA events, median of 5 after one warm-up."""
    nbytes = 1 << 30
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    _, ms = timed(torch, lambda: card.copy_(host, non_blocking=True), 5, 1)
    del host, card
    torch.cuda.empty_cache()
    return {"bytes": nbytes, "ms": ms, "gb_s": nbytes / ms / 1e6}


@contextlib.contextmanager
def ballast(torch, dev, free_target: int):
    """For the length of a ``with`` block, one tensor on the card that
    leaves ``free_target`` bytes free, counted as the stack gate counts
    them (engine_torch._stack_plan); yields its size. It is freed, with
    the allocator's cache, on exit."""
    torch.cuda.empty_cache()
    free = (torch.cuda.mem_get_info(dev)[0] + torch.cuda.memory_reserved(dev)
            - torch.cuda.memory_allocated(dev))
    check(free > free_target, f"{free / 1e9:.2f} GB free on the card, less "
          f"than the {free_target / 1e9:.2f} GB the ballast must leave")
    weight = torch.empty(free - free_target, dtype=torch.uint8, device=dev)
    try:
        yield weight.numel()
    finally:
        del weight
        torch.cuda.empty_cache()


def gate_target(torch, engine_torch, cfg, store_dir: str, dev,
                matfree: bool) -> tuple[int, int]:
    """(free bytes to leave, stack bytes) for a cohort's store: the
    smallest reserve with which the gate keeps a stack resident (the
    matrix-free engine's at KRYLOV_COLS, the exact engine's), plus half
    the stack; the sizes are read from a backend made before any ballast
    (its stack is not built)."""
    probe = engine_torch.TiledScan(engine_torch.StoreTileSource(store_dir),
                                   cfg, dev, matfree)
    check(probe.stack_mode == "resident", "the stack does not fit the card "
          "even before the ballast")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    src = probe.src
    fixed, per_row = engine_torch.stack_reserve(
        src.n, src.p, cfg, sms, probe.cache_device,
        engine_torch.KRYLOV_COLS if matfree else 0, probe.tile_snps)
    stack = probe.stack_info()["stack_bytes"]
    return fixed + per_row * src.p + stack // 2, stack


def stack_events(events: list[dict]) -> tuple[dict, dict]:
    """The scan log's stack gate (``stack``) and its end-of-scan counters
    (``stack_passes``; the exact engine logs the gate at its end)."""
    gate = [e for e in events if e["event"] == "stack"]
    end = [e for e in events if e["event"] == "stack_passes"]
    check(len(gate) == 1, "the scan log holds no stack gate")
    return gate[0], (end[0] if end else gate[0])


def streamed_phase(torch, ep, packed, engine_torch, tmp: str, card: str,
                   main: dict, cfg2: dict, dev) -> dict:
    """Phase 18: the out-of-core path on the card. A ballast tensor leaves
    free only the scan's reserve and half the stack, so the gate takes the
    decision a stack larger than the card forces: phase 6's cohort streams
    through a ring of chunk buffers on every pass. Its K·V is held to the
    resident one and to itself, one K3 pass is timed against the resident
    pass and against the link, am() runs through the normal entry point
    and a second call traces iteration 1; then BASELINE config 2 runs on
    the exact engine over a streamed stack."""
    from eagleeverything_tpu_torch.models import bigscan
    c, c2 = main["cohort"], cfg2["cohort"]
    n, p = c.n, c.p
    phase(f"18. streamed stack: am() on phase 6's cohort ({n} x {p}) and on "
          f"BASELINE config 2 ({c2.n} x {c2.p}, exact engine), each under a "
          "ballast that leaves free the scan's reserve and half its stack")
    print(card)
    link = link_rate(torch, dev)
    print(f"host link: 1 GiB page-locked host -> card {link['ms']:.3f} ms "
          f"(median of 5): {link['gb_s']:.2f} GB/s", flush=True)
    cfg = ep.EagleConfig()
    target, stack_bytes = gate_target(torch, engine_torch, cfg, c.store_dir,
                                      dev, matfree=True)

    # the resident K·V first (the stack cannot stay on the card under the
    # ballast), timed a pass (CUDA events, median of 5)
    res = engine_torch.TiledScan(engine_torch.StoreTileSource(c.store_dir),
                                 cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    kv = {}
    for r in (8, 128):
        V = torch.randn((n, r), generator=gen, device=dev)
        ref, ms = timed(torch, lambda: res._device_kv(V), 5, 1)
        kv[r] = {"V": V, "ref": ref, "resident_ms": ms}
    nw = res.nw
    del res
    torch.cuda.empty_cache()

    out = {"link": link, "stack_bytes": stack_bytes}
    with ballast(torch, dev, target) as weight:
        st = engine_torch.TiledScan(engine_torch.StoreTileSource(c.store_dir),
                                    cfg, dev)
        gate = st.stack_info()
        print(f"ballast {weight / 1e9:.3f} GB; the gate saw "
              f"{gate['free_bytes'] / 1e9:.3f} GB free for the "
              f"{stack_bytes / 1e9:.3f} GB stack and its "
              f"{gate['reserve_bytes'] / 1e9:.3f} GB reserve: {gate['mode']}"
              f", {gate['chunks']} chunks of {gate['chunk_rows']} rows, "
              f"{gate['slots']} slots", flush=True)
        check(gate["mode"] == "streamed" and gate["chunks"] >= 3,
              f"the gate did not stream the stack in 3 chunks or more: "
              f"{gate}")
        for r, k in kv.items():
            got = st._device_kv(k["V"])     # the first builds the stack
            again = st._device_kv(k["V"])
            torch.cuda.synchronize()
            check(torch.equal(got, again),
                  f"the streamed K·V is not bitwise repeatable at r={r}")
            k["err"], k["rel"] = rel_err(torch, got, k["ref"])
            check(k["rel"] <= TOL, f"the streamed K·V is off the resident "
                  f"one at r={r}: rel {k['rel']:.3e}")
            del got, again
        # the ring's own copies, a pass of them alone: a reading of the
        # code under test, reported beside the link and not used in the
        # bound, which takes the link's rate from the 1 GiB copy alone
        _, copy_ms = timed(torch, lambda: sum(1 for _ in st._stack_chunks()),
                           5, 1)
        link["ring_gb_s"] = stack_bytes / copy_ms / 1e6
        print(f"a pass of the ring's copies alone: {copy_ms:.2f} ms (median "
              f"of 5), {link['ring_gb_s']:.2f} GB/s, "
              f"{link['ring_gb_s'] / link['gb_s']:.1%} of the 1 GiB copy's "
              "rate", flush=True)
        b_link = stack_bytes / (link["gb_s"] * 1e9) * 1e3
        for r, k in kv.items():
            _, ms = timed(torch, lambda: st._device_kv(k["V"]), 5, 0)
            b_k3 = bound("kernel_matvec", n, p, r, nw)[0]
            k.update(streamed_ms=ms, bound_ms=max(b_k3, b_link),
                     bound_by="link" if b_link >= b_k3 else "K3")
            print(f"K3 at r={r}: streamed {ms:.2f} ms a pass "
                  f"({stack_bytes / ms / 1e6:.2f} GB/s), resident "
                  f"{k['resident_ms']:.2f} ms; bound {k['bound_ms']:.2f} ms "
                  f"(by the {k['bound_by']}: link {b_link:.2f} ms, K3 "
                  f"{b_k3:.2f} ms), {k['bound_ms'] / ms:.1%} of it; vs "
                  f"resident: max abs err {k['err']:.3e}, rel "
                  f"{k['rel']:.3e}; bitwise equal over two calls", flush=True)
        print(f"pinned stack built in {st.build_s:.2f} s (pinning, the "
              "store's tiles and one pass for the means)")
        check(st.h2d_bytes == st.stream_passes * stack_bytes,
              "the streamed passes did not each copy the whole stack")
        del st
        torch.cuda.empty_cache()

        handle = ep.GenoHandle(n=n, p=p, source="cohort",
                               store_dir=c.store_dir)
        log = os.path.join(tmp, "streamed.jsonl")
        rec = LaunchRecorder(packed, streamed=True)
        res, wall, launches = run_counted(torch, packed, lambda: ep.am(
            "y", handle, {"y": c.y}, maxit=3, engine="auto", log_jsonl=log),
            rec)
        events = read_log(log)
        gate, end = stack_events(events)
        phases = scan_phases(events)
        with IterationTrace(torch, bigscan, 1,
                            os.path.join(tmp, "streamed_trace.json")) as tr:
            ep.am("y", handle, {"y": c.y}, maxit=2, engine="auto")
    trace = print_trace(tr)
    gap = rel_gap(res.extbic_path, main["extbic_path"])
    print("am(engine='auto'), streamed: "
          f"{wall:.1f} s (phase 6: {main['wall_s']:.1f} s); phases "
          + ", ".join(f"{k} " + " / ".join(f"{w:.2f}" for w in v)
                      for k, v in phases.items())
          + f" s; {end['stream_passes']} passes through {gate['chunks']} "
          f"chunks of {gate['chunk_rows']} rows, "
          f"{end['h2d_bytes'] / 1e9:.1f} GB copied, "
          f"{end['h2d_bytes'] / wall / 1e9:.2f} GB/s over the whole scan "
          f"({end['h2d_bytes'] / wall / 1e9 / link['gb_s']:.1%} of the "
          f"link); stack built in {gate['build_s']:.2f} s; launches "
          f"{launches}; selected {res.indices} (phase 6: {main['indices']}),"
          f" extBIC gap {gap:.2e}", flush=True)
    check(gate["mode"] == "streamed" and gate["chunks"] >= 3,
          f"am() did not stream the stack: {gate}")
    check(end["h2d_bytes"] == end["stream_passes"] * stack_bytes,
          "am()'s passes did not each copy the whole stack")
    check(res.indices == main["indices"],
          "the streamed scan selected other SNPs than phase 6")
    check(gap <= 1e-3, f"the streamed extBIC is off phase 6's: {gap:.2e}")
    for name in KERNELS:
        check(launches[name] >= 1,
              f"{name} was never launched by the streamed am()")
    # every width the streamed am() launched each kernel at, on a full
    # chunk and on the shorter last one, against the plain version
    last = p - (gate["chunks"] - 1) * gate["chunk_rows"]
    held = {(key[0], key[2]) for key in rec.kept}
    kept = kept_checks(torch, packed, rec.kept, "the streamed am()")
    rec.kept.clear()
    for name in LaunchRecorder.NAMES:
        check({(name, gate["chunk_rows"]), (name, last)} <= held,
              f"{name}: the streamed am()'s launches held against the "
              f"plain version miss a chunk length ({sorted(held)})")
    out.update(kv={r: {k: v for k, v in d.items()
                       if k not in ("V", "ref")} for r, d in kv.items()},
               wall_s=wall, launches=launches, gate=gate,
               passes=end["stream_passes"], h2d_bytes=end["h2d_bytes"],
               phases=phases, trace=trace, gap=gap, kept_rel_err=kept)

    target2, _ = gate_target(torch, engine_torch, cfg, c2.store_dir, dev,
                             matfree=False)
    h2 = ep.GenoHandle(n=c2.n, p=c2.p, source="config2",
                       store_dir=c2.store_dir)
    log2 = os.path.join(tmp, "streamed_exact.jsonl")
    with ballast(torch, dev, target2):
        res2, wall2, launches2 = run_counted(torch, packed, lambda: ep.am(
            "y", h2, {"y": c2.y}, maxit=10, engine="auto", log_jsonl=log2))
    gate2, _ = stack_events(read_log(log2))
    gap2 = rel_gap(res2.extbic_path, cfg2["extbic_path"])
    print(f"exact am(engine='auto') on config 2, streamed: {wall2:.2f} s "
          f"(phase 8: {cfg2['wall_s']:.2f} s); {gate2['chunks']} chunks of "
          f"{gate2['chunk_rows']} rows, {gate2['stream_passes']} passes; "
          f"selected {res2.indices} (phase 8: {cfg2['indices']}), extBIC "
          f"gap {gap2:.2e}; packed-stack launches {launches2}", flush=True)
    check(gate2["mode"] == "streamed", f"config 2 did not stream: {gate2}")
    check(res2.indices == cfg2["indices"],
          "the streamed exact scan selected other SNPs than phase 8")
    check(gap2 <= 1e-6, f"the streamed exact extBIC is off phase 8's: "
          f"{gap2:.2e}")
    check(not any(launches2.values()),
          f"the exact engine launched packed-stack kernels: {launches2}")
    out.update(exact_wall_s=wall2, exact_launches=launches2, exact_gap=gap2,
               exact_gate=gate2)
    return out


def store_phase(torch, ep, packed, engine_torch, tmp: str, card: str,
                main: dict, streamed: dict, cfg2: dict, cohort,
                dev) -> dict:
    """Phase 19: the stack read from the store on every pass. Under phase
    18's kind of ballast, and with ``availmem_gb`` below the stack, the gate
    streams the stack and builds no host stack: a reader thread fills two
    page-locked staging buffers from the store. Phase 6's cohort: K·V held
    to the resident one, to the pinned-streamed one at the same chunking
    and to itself, one pass timed beside phase 18's pinned pass with the
    reader's rate; ``am()`` through the normal entry point on ``cohort``
    (phase 12's 50 000 x 65 536, p cut from phase 6's 262 144), every
    launch against its plain version; BASELINE config 2 on the exact engine
    from an unpacked copy of phase 8's store, whose int8 rows are packed on
    the card. Every store was written in this run, so the page cache is
    warm."""
    from eagleeverything_tpu_torch.io.genostore import GenotypeStore
    c = main["cohort"]
    n, p = c.n, c.p
    phase(f"19. stack read from the store on every pass: K3 on phase 6's "
          f"cohort ({n} x {p}), am() on {cohort.n} x {cohort.p}, and "
          "BASELINE config 2 from an unpacked store (exact engine), each "
          "under a ballast and with availmem_gb below its stack")
    print(card)
    print("page cache: warm (every store was written earlier in this run)")
    base = ep.EagleConfig()
    target, stack_bytes = gate_target(torch, engine_torch, base, c.store_dir,
                                      dev, matfree=True)
    cfg = ep.EagleConfig(availmem_gb=round(0.6 * stack_bytes / 1e9, 3))
    res = engine_torch.TiledScan(engine_torch.StoreTileSource(c.store_dir),
                                 base, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    kv = {}
    for r in (8, 128):
        V = torch.randn((n, r), generator=gen, device=dev)
        kv[r] = {"V": V, "ref": res._device_kv(V)}
    del res
    torch.cuda.empty_cache()
    out = {"stack_bytes": stack_bytes, "availmem_gb": cfg.availmem_gb}
    with ballast(torch, dev, target):
        pin = engine_torch.TiledScan(
            engine_torch.StoreTileSource(c.store_dir), base, dev)
        check(pin.stack_info()["host"] == "pinned", "under the default "
              f"availmem_gb the stack is not pinned: {pin.stack_info()}")
        for r, k in kv.items():
            k["pinned"] = pin._device_kv(k["V"]).cpu()
        del pin
        torch.cuda.empty_cache()
        st = engine_torch.TiledScan(engine_torch.StoreTileSource(c.store_dir),
                                    cfg, dev)
        gate = st.stack_info()
        print(f"availmem_gb {cfg.availmem_gb} for the {stack_bytes / 1e9:.3f}"
              f" GB stack: {gate['mode']} from the {gate['host']}, "
              f"{gate['chunks']} chunks of {gate['chunk_rows']} rows, "
              f"{gate['slots']} slots", flush=True)
        check(gate["mode"] == "streamed" and gate["host"] == "store"
              and gate["chunks"] >= 3, f"the gate did not read the stack "
              f"from the store in 3 chunks or more: {gate}")
        for r, k in kv.items():
            got = st._device_kv(k["V"])     # the first pass: the means
            again = st._device_kv(k["V"])
            torch.cuda.synchronize()
            check(torch.equal(got, again), "the store-streamed K·V is not "
                  f"bitwise repeatable at r={r}")
            check(torch.equal(got.cpu(), k["pinned"]), "the store-streamed "
                  f"K·V differs from the pinned-streamed one at r={r}")
            k["err"], k["rel"] = rel_err(torch, got, k["ref"])
            check(k["rel"] <= 1e-5, f"the store-streamed K·V is off the "
                  f"resident one at r={r}: rel {k['rel']:.3e}")
            del got, again
        for r, k in kv.items():
            passes, rb, rs = st.stream_passes, st.read_bytes, st.read_s
            _, ms = timed(torch, lambda: st._device_kv(k["V"]), 5, 0)
            k.update(store_ms=ms, pinned_ms=streamed["kv"][r]["streamed_ms"],
                     read_gb_s=(st.read_bytes - rb) / (st.read_s - rs) / 1e9,
                     pass_gb_s=stack_bytes / ms / 1e6)
            check(st.stream_passes - passes == 5, "a timed K·V was not one "
                  "pass")
            print(f"K3 at r={r}: read from the store {ms:.2f} ms a pass "
                  f"({k['pass_gb_s']:.2f} GB/s of stack), pinned (phase 18) "
                  f"{k['pinned_ms']:.2f} ms; the reader "
                  f"{k['read_gb_s']:.2f} GB/s while it reads; vs resident: "
                  f"max abs err {k['err']:.3e}, rel {k['rel']:.3e}; bitwise "
                  "equal to the pinned-streamed K·V and over two calls",
                  flush=True)
        info = st.stack_info()
        print(f"page-locked host memory {info['host_bytes'] / 1e9:.3f} GB "
              f"(two staging buffers; availmem_gb {cfg.availmem_gb}); "
              f"{info['read_bytes'] / 1e9:.2f} GB read in "
              f"{info['read_s']:.2f} s over {info['stream_passes']} passes",
              flush=True)
        check(st._pstack is None, "a host stack was built")
        check(0 < info["host_bytes"] <= cfg.availmem_gb * 1e9,
              f"{info['host_bytes']} B page-locked over availmem_gb")
        check(info["read_bytes"] == info["stream_passes"] * p * (-(-n // 4)),
              "a pass did not read every row of the store once")
        del st
        torch.cuda.empty_cache()
    out.update(kv={r: {k: v for k, v in d.items()
                       if k not in ("V", "ref", "pinned")}
                   for r, d in kv.items()}, host_bytes=info["host_bytes"])

    # am() through the normal entry point, from the store
    target_m, stack_m = gate_target(torch, engine_torch, base,
                                    cohort.store_dir, dev, matfree=True)
    cfg_m = ep.EagleConfig(availmem_gb=round(0.5 * stack_m / 1e9, 3))
    handle = ep.GenoHandle(n=cohort.n, p=cohort.p, source="store_cohort",
                           store_dir=cohort.store_dir)
    log = os.path.join(tmp, "store.jsonl")
    rec = LaunchRecorder(packed, streamed=True)
    with ballast(torch, dev, target_m):
        res_m, wall, launches = run_counted(torch, packed, lambda: ep.am(
            "y", handle, {"y": cohort.y}, maxit=3, engine="auto",
            config=cfg_m, log_jsonl=log), rec)
    events = read_log(log)
    gate, end = stack_events(events)
    phases = scan_phases(events)
    print(f"am(engine='auto') from the store on {cohort.n} x {cohort.p} "
          f"(availmem_gb {cfg_m.availmem_gb} for its {stack_m / 1e9:.3f} GB "
          f"stack): {wall:.1f} s; phases "
          + ", ".join(f"{k} " + " / ".join(f"{w:.2f}" for w in v)
                      for k, v in phases.items())
          + f" s; {end['stream_passes']} passes through {gate['chunks']} "
          f"chunks of {gate['chunk_rows']} rows, "
          f"{end['read_bytes'] / 1e9:.1f} GB read in {end['read_s']:.1f} s "
          f"({end['read_bytes'] / end['read_s'] / 1e9:.2f} GB/s while "
          f"reading), {end['h2d_bytes'] / 1e9:.1f} GB copied, "
          f"{gate['host_bytes'] / 1e9:.3f} GB page-locked; launches "
          f"{launches}; selected {res_m.indices} (planted "
          f"{cohort.qtl_idx.tolist()})", flush=True)
    check(gate["mode"] == "streamed" and gate["host"] == "store"
          and gate["chunks"] >= 3, f"am() did not read the store: {gate}")
    check(end["read_bytes"] == end["stream_passes"] * cohort.p
          * (-(-cohort.n // 4)), "am()'s passes did not each read the store")
    check(end["h2d_bytes"] == end["stream_passes"] * stack_m,
          "am()'s passes did not each copy the whole stack")
    check(0 < end["host_bytes"] <= cfg_m.availmem_gb * 1e9,
          "am() held more page-locked memory than availmem_gb")
    check(len(res_m.indices) >= 1, "the store-streamed scan selected nothing")
    check(set(res_m.indices) <= set(int(q) for q in cohort.qtl_idx),
          f"selected SNPs {res_m.indices} are not all planted QTL")
    check(all(math.isfinite(v) for v in res_m.extbic_path),
          "non-finite extBIC on the store-streamed scan")
    for name in KERNELS:
        check(launches[name] >= 1,
              f"{name} was never launched by the store-streamed am()")
    last = cohort.p - (gate["chunks"] - 1) * gate["chunk_rows"]
    held = {(key[0], key[2]) for key in rec.kept}
    kept = kept_checks(torch, packed, rec.kept, "the store-streamed am()")
    rec.kept.clear()
    for name in LaunchRecorder.NAMES:
        check({(name, gate["chunk_rows"]), (name, last)} <= held,
              f"{name}: the store-streamed am()'s launches held against the "
              f"plain version miss a chunk length ({sorted(held)})")
    out.update(wall_s=wall, launches=launches, gate=gate,
               passes=end["stream_passes"], read_bytes=end["read_bytes"],
               read_s=end["read_s"], phases=phases, kept_rel_err=kept,
               indices=res_m.indices)

    # config 2 on the exact engine from an unpacked store: int8 rows, packed
    # on the card chunk by chunk
    c2 = cfg2["cohort"]
    d8 = os.path.join(tmp, "config2_int8")
    t0 = time.perf_counter()
    src = GenotypeStore.open(c2.store_dir)
    GenotypeStore.create_from_snp_blocks(d8, src.iter_tiles(8192), n=c2.n,
                                         p=c2.p, n_shards=src.n_shards)
    print(f"phase 8's store copied unpacked (int8) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    target2, stack2 = gate_target(torch, engine_torch, base, d8, dev,
                                  matfree=False)
    cfg2s = ep.EagleConfig(availmem_gb=round(0.5 * stack2 / 1e9, 4))
    h2 = ep.GenoHandle(n=c2.n, p=c2.p, source="config2_int8", store_dir=d8)
    log2 = os.path.join(tmp, "store_exact.jsonl")
    with ballast(torch, dev, target2):
        res2, wall2, launches2 = run_counted(torch, packed, lambda: ep.am(
            "y", h2, {"y": c2.y}, maxit=10, engine="auto", config=cfg2s,
            log_jsonl=log2))
    gate2, _ = stack_events(read_log(log2))
    gap2 = rel_gap(res2.extbic_path, cfg2["extbic_path"])
    print(f"exact am(engine='auto') on config 2 from its unpacked store: "
          f"{wall2:.2f} s (phase 8: {cfg2['wall_s']:.2f} s); "
          f"{gate2['rows']} rows packed on the card, {gate2['chunks']} chunks"
          f" of {gate2['chunk_rows']} rows, {gate2['stream_passes']} passes, "
          f"{gate2['read_bytes'] / 1e9:.2f} GB read, "
          f"{gate2['host_bytes'] / 1e9:.4f} GB page-locked (availmem_gb "
          f"{cfg2s.availmem_gb}); selected {res2.indices} (phase 8: "
          f"{cfg2['indices']}), extBIC gap {gap2:.2e}; packed-stack launches "
          f"{launches2}", flush=True)
    check(gate2["mode"] == "streamed" and gate2["host"] == "store"
          and gate2["rows"] == "int8", f"config 2 did not read int8 rows "
          f"from the store: {gate2}")
    check(0 < gate2["host_bytes"] <= cfg2s.availmem_gb * 1e9,
          "config 2 held more page-locked memory than availmem_gb")
    check(res2.indices == cfg2["indices"],
          "the exact scan from the store selected other SNPs than phase 8")
    check(gap2 <= 1e-6, f"the exact extBIC from the store is off phase 8's: "
          f"{gap2:.2e}")
    check(not any(launches2.values()),
          f"the exact engine launched packed-stack kernels: {launches2}")
    out.update(exact_wall_s=wall2, exact_launches=launches2, exact_gap=gap2,
               exact_gate=gate2)
    return out


def load_script(name: str):
    """scripts/<name>.py, imported by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def slice_checks(torch, packed, kept: dict, what: str) -> dict:
    """Hold each launch a LaunchRecorder (``streamed``: host copies) kept
    on a stack where a plain pass takes seconds: bit for bit against the
    kernel launched again on the same operands, and against the plain
    version on the stack's first SLICE_ROWS rows, at TOL: K1's output rows
    there; K2 and K3, whose output sums over every row, launched again on
    those rows. Returns {kernel: worst rel err}."""
    worst = {}
    on_card = {}

    def card(t):
        if id(t) not in on_card:
            on_card[id(t)] = t.cuda()
        return on_card[id(t)]

    s = slice(0, SLICE_ROWS)
    for key, (Wp, means, n, X, got) in sorted(kept.items()):
        name, r = key[:2]
        Wp, means, X, got = card(Wp), card(means), X.cuda(), got.cuda()
        fn, plain = getattr(packed, name), getattr(packed, f"{name}_plain")
        again = fn(Wp, X, means, n)
        torch.cuda.synchronize()
        check(torch.equal(again, got), f"{name} at r={r} is not bitwise "
              f"repeatable on {what}'s operand")
        if name == "packed_dot":
            k_out, ref = got[s], plain(Wp[s], X, means[s], n)
        else:
            Xs = X[s] if name == "packed_tdot" else X
            k_out, ref = fn(Wp[s], Xs, means[s], n), plain(Wp[s], Xs,
                                                           means[s], n)
        err, rel = rel_err(torch, k_out, ref)
        worst[name] = max(worst.get(name, 0.0), rel)
        print(f"  {name:14s} n={n} p={Wp.shape[0]} r={r:3d} (as {what} "
              f"launched it): bitwise repeatable; on {SLICE_ROWS} rows vs "
              f"plain: max abs err {err:.3e}, rel {rel:.3e}", flush=True)
        check(rel <= TOL, f"{name} disagrees with its plain version on "
              f"{what}'s operand at r={r}: rel {rel:.3e}")
        del again, k_out, ref, X, got
    check(set(worst) == set(LaunchRecorder.NAMES),
          f"{what} launched only {sorted(worst)}")
    del on_card
    torch.cuda.empty_cache()
    return worst


def n_axis_phase(torch, packed, engine_torch, axes, tmp: str, card: str,
                 dev) -> dict:
    """Phase 20: BASELINE config 4's n axis at its true size, 500 000 x
    32 768, generated by the port's gen_n (the JAX script's cohort, byte
    for byte) and scanned by the port's run_n with the recorded protocol,
    ``N_AXIS_MAXIT`` steps, the last traced; held to the recorded
    selections and extBIC path (docs/biobank_axis_n_result.json)."""
    from eagleeverything_tpu_torch.models import bigscan
    with open(os.path.join(ROOT, "docs", "biobank_axis_n_result.json")) as f:
        record = json.load(f)
    maxit = N_AXIS_MAXIT
    phase(f"20. BASELINE config 4's n axis, uncut: 500 000 x 32 768 from "
          "the port's gen_n (seed 11), run_n with the recorded protocol "
          f"({', '.join(f'{k}={v}' for k, v in axes.N_PROTOCOL.items())}), "
          f"maxit {maxit}, iteration {maxit - 1} traced; held to "
          "docs/biobank_axis_n_result.json")
    print(card)
    d = os.path.join(tmp, "biobank_n")
    gen = axes.gen_n(d, device=dev)
    store = os.path.join(d, "store_full")
    print(f"cohort generated and written in {gen['gen_s']:.1f} s (host "
          f"draws {gen['draw_s']:.1f} s)", flush=True)

    # the gate's plan before the run, at the protocol's config and at am()'s
    # default matrix-free fields
    probe = engine_torch.TiledScan(engine_torch.StoreTileSource(store),
                                   axes.protocol_config(), dev)
    plan, info = probe.plan, probe.stack_info()
    n, p = probe.src.n, probe.src.p
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    defaults = {}
    for width in (engine_torch.MULTI_STAT_COLS, engine_torch.KRYLOV_COLS):
        fixed, per_row = engine_torch.stack_reserve(
            n, p, axes.axis_config(), sms, probe.cache_device, width,
            probe.tile_snps)
        defaults[width] = fixed + per_row * p
    del probe
    print(f"gate: {plan.mode}, stack {info['stack_bytes'] / 1e9:.3f} GB "
          f"({p} x {packed.words_per_row(n)} words), stack_reserve at the "
          f"protocol {plan.reserve_bytes / 1e9:.3f} GB (stat rows at "
          f"{plan.stat_cols} columns), {plan.free_bytes / 1e9:.3f} GB free; "
          "at am()'s default matrix-free fields the reserve would be "
          + ", ".join(f"{v / 1e9:.3f} GB at {w} columns"
                      for w, v in defaults.items()), flush=True)
    check(plan.mode == "resident", f"the n-axis stack does not stay on the "
          f"card: {info}")

    rec = LaunchRecorder(packed, streamed=True)
    with IterationTrace(torch, bigscan, maxit - 1,
                        os.path.join(tmp, "n_axis_trace.json")) as tr:
        res, wall, launches = run_counted(torch, packed, lambda: axes.run_n(
            d, maxit, device=dev, out=os.path.join(d, "result.json")), rec)
    trace = print_trace(tr, f"iteration {maxit - 1} (sweep + refit, under "
                        "the profiler, inside the scan)")
    for e in res["phase_events"]:
        print(f"  phase {e['phase']:8s} {e['wallclock_s']:9.2f} s")
    for e in res["iteration_events"]:
        print(f"  iteration {e['it']}: candidate {e['candidate']} t "
              f"{e['t_max']:.1f} extBIC {e['extbic']:.4f} accepted "
              f"{e['accepted']}")
    k = len(res["selected"])
    rec_path = record["extbic_path"][: k + 1]
    gaps = [abs(a - b) / abs(b) for a, b in zip(res["extbic_path"],
                                                rec_path)]
    peak = res["peak_device_bytes"]
    stack_bytes = res["stack"]["stack_bytes"]
    print(f"run_n wall {wall:.1f} s (iteration {maxit - 1} under the "
          f"profiler); {res['stack_passes'].get('total')} stack passes; "
          f"launches {launches}; selected {res['selected']} (record "
          f"{record['selected']}), extBIC {res['extbic_path']} (record "
          f"{rec_path}), rel gaps {[f'{g:.2e}' for g in gaps]}; peak device "
          f"memory {peak / 1e9:.3f} GB: the stack {stack_bytes / 1e9:.3f} GB "
          f"and {(peak - stack_bytes) / 1e9:.3f} GB beside it, against "
          f"stack_reserve's {res['stack']['reserve_bytes'] / 1e9:.3f} GB; "
          f"Krylov cache {res['krylov_cache']}", flush=True)
    check(res["stack"].get("mode") == "resident", "the scan streamed")
    check(k == maxit, f"the n-axis scan took {k} steps of {maxit}; the "
          "record accepted six")
    check(res["selected"] == record["selected"][:k],
          f"the n-axis scan selected {res['selected']}, the record "
          f"{record['selected'][:k]}")
    check(res["selected_all_planted"], "an n-axis selection is not planted")
    check(max(gaps) <= 1e-3, f"the n-axis extBIC path is off the record's: "
          f"{gaps}")
    for name in KERNELS:
        check(launches[name] >= 1, f"{name} was never launched by the "
              "n-axis scan")
    kept = slice_checks(torch, packed, rec.kept, "the n-axis scan")
    rec.kept.clear()
    shutil.rmtree(d)
    return {"gen": gen, "wall_s": wall, "launches": launches, "trace": trace,
            "selected": res["selected"], "gaps": gaps, "peak_bytes": peak,
            "stack_bytes": stack_bytes,
            "reserve_bytes": res["stack"]["reserve_bytes"],
            "reserve_defaults": defaults, "phases": res["phase_events"],
            "passes": res["stack_passes"].get("total"), "kept_rel_err": kept}


def p_axis_phase(torch, packed, axes, tmp: str, card: str, dev) -> dict:
    """Phase 21: BASELINE config 4's p axis at its true size, 2 048 x
    5 000 000, from the port's gen_p with ``store_only`` (the JAX script's
    draws packed into the store its ingest writes, no text), then run_p's
    REML fit and one full matrix-free stat sweep; held to the recorded
    argmax (docs/biobank_axis_p_result.json)."""
    with open(os.path.join(ROOT, "docs", "biobank_axis_p_result.json")) as f:
        record = json.load(f)
    phase("21. BASELINE config 4's p axis, uncut: 2 048 x 5 000 000 from the "
          "port's gen_p --store-only (seed 12, 4 packed shards, no text), "
          "then run_p (make_context "
          f"{axes.P_CONTEXT}, reml_maximize_matfree, score_sweep_matfree "
          f"{axes.P_SWEEP}) and the column reads; held to "
          "docs/biobank_axis_p_result.json")
    print(card)
    d = os.path.join(tmp, "biobank_p")
    gen = axes.gen_p(d, store_only=True, device=dev)
    print(f"rows drawn in {gen['write_s']:.1f} s, the store packed and "
          f"written in {gen['store_s']:.1f} s", flush=True)
    rec = LaunchRecorder(packed, streamed=True)
    (res, t), wall, launches = run_counted(torch, packed, lambda: axes.run_p(
        d, device=dev, out=os.path.join(d, "result.json")), rec)
    qtl = res["qtl_planted"]
    print(f"run_p wall {wall:.1f} s: context {res['context_s']:.2f} s, reml "
          f"{res['reml_s']:.2f} s, sweep {res['sweep_seconds']:.2f} s "
          f"({res['snps_per_second_sweep']:.0f} SNPs/s); stack "
          f"{res['stack']['mode']} ({res['stack']['stack_bytes'] / 1e9:.3f} "
          f"GB, built in {res['stack']['build_s']:.2f} s); launches "
          f"{launches}; argmax {res['argmax']} (record {record['argmax']}); "
          "t at the planted SNPs "
          + ", ".join(f"{j}: {a:.4f} (record {b:.4f})" for j, a, b in zip(
              qtl, res["t_at_planted"], record["t_at_planted"]))
          + f"; t quantiles {res['t_quantiles']} (record "
          f"{record['t_quantiles']}); escalation {res['escalation']}; "
          f"column reads {res['column_roundtrip_ok']}", flush=True)
    check(qtl == record["qtl_planted"], f"the p-axis cohort planted {qtl}, "
          f"the record {record['qtl_planted']}")
    check(res["argmax"] == record["argmax"], f"the p-axis argmax is "
          f"{res['argmax']}, the record's {record['argmax']}")
    check(res["column_roundtrip_ok"], "a p-axis column read failed")
    check(res["stack"]["mode"] == "resident", "the p-axis stack streamed")
    check(bool(np.all(np.isfinite(t))) and t.shape == (res["p"],),
          "the p-axis t vector is not finite or not p long")
    for name in KERNELS:
        check(launches[name] >= 1, f"{name} was never launched by the "
              "p-axis run")
    kept = slice_checks(torch, packed, rec.kept, "the p-axis run")
    rec.kept.clear()
    shutil.rmtree(d)
    return {"gen": gen, "wall_s": wall, "launches": launches,
            "sweep_s": res["sweep_seconds"],
            "snps_per_s": res["snps_per_second_sweep"],
            "reml_s": res["reml_s"], "context_s": res["context_s"],
            "argmax": res["argmax"], "t_at_planted": res["t_at_planted"],
            "kept_rel_err": kept}


def redraw_block(n: int, p: int, which: str, seed: int = 7,
                 block: int = COHORT_BLOCK, n_qtl: int = 8
                 ) -> tuple[int, np.ndarray]:
    """(first row, (b, n) int8 genotypes) of scripts/cohort_run.py's
    ``which`` ("first" or "last") 4096-SNP block, drawn by numpy's own
    Generator in that script's order; the blocks between are skipped with
    the bit generator's ``advance`` (a full block takes b doubles and
    b·n/4 64-bit words of uint16 draws, and leaves a kept 32-bit half as
    it found it, when 4 divides b·n)."""
    rng = np.random.default_rng(seed)
    rng.choice(block, size=n_qtl, replace=False)

    def draw(b: int) -> np.ndarray:
        maf = rng.uniform(0.05, 0.5, size=(b, 1))
        t_hom = np.rint(65536.0 * maf**2).astype(np.uint16)
        t_het = np.rint(65536.0 * (maf**2 + 2 * maf * (1 - maf))
                        ).astype(np.uint16)
        u = rng.integers(0, 65536, size=(b, n), dtype=np.uint16)
        return (u < t_hom).view(np.int8) + (u < t_het).view(np.int8)

    first = draw(min(block, p))
    if which == "first":
        return 0, first
    nblocks = -(-p // block)
    check((block * n) % 4 == 0 and nblocks >= 2,
          "the re-draw's skip needs 4 | 4096·n and two blocks")
    skip = (nblocks - 2) * (block + block * n // 4)
    bg = rng.bit_generator
    if skip and bg.state["has_uint32"]:
        # the skipped draws end on a kept high half: the last word's
        bg.advance(skip - 1)
        word = int(bg.random_raw())
        st = bg.state
        st["has_uint32"], st["uinteger"] = 1, word >> 32
        bg.state = st
    elif skip:
        bg.advance(skip)
    j0 = (nblocks - 1) * block
    return j0, draw(p - j0)


def store_rows(store: str, lo: int, hi: int) -> np.ndarray:
    """Rows [lo, hi) of a packed store's shards, as bytes, read through
    its manifest's offsets."""
    with open(os.path.join(store, "manifest.json")) as f:
        man = json.load(f)
    off, nb = man["shard_offsets"], -(-man["n"] // 4)
    parts = []
    for k in range(len(off) - 1):
        a, b = max(lo, off[k]), min(hi, off[k + 1])
        if a < b:
            shard = np.memmap(os.path.join(store, f"shard_{k:05d}.bin"),
                              dtype=np.uint8, mode="r",
                              shape=(off[k + 1] - off[k], nb))
            parts.append(np.array(shard[a - off[k] : b - off[k]]))
    return np.concatenate(parts)


def pack_rows(g: np.ndarray) -> np.ndarray:
    """(b, n) genotypes → the store's 2-bit bytes (genotype j at bits
    2(j mod 4) of byte j/4)."""
    b, n = g.shape
    c = np.zeros((b, -(-n // 4) * 4), dtype=np.uint8)
    c[:, :n] = g
    c = c.reshape(b, -1, 4)
    return c[..., 0] | c[..., 1] << 2 | c[..., 2] << 4 | c[..., 3] << 6


def cohort_run_phase(torch, packed, crt, tmp: str, card: str, dev) -> dict:
    """Phase 22: scripts/cohort_run_torch.py cut to N x COHORT_P, in
    process through its functions: ``generate`` (its first and last
    blocks held byte for byte to a numpy re-draw), then ``run`` (am() on
    the store, COHORT_MAXIT steps, every selection planted), its launches
    counted and the first at each width held as in phase 20. The store
    stays for phase 23."""
    phase(f"22. scripts/cohort_run_torch.py cut to {N} x {COHORT_P}: "
          "generate (scripts/cohort_run.py's cohort, seed 7; the first and "
          "last 4096-SNP blocks held byte for byte to a numpy re-draw), run "
          f"(am() on the store, maxit {COHORT_MAXIT}; every selection "
          "planted), the launches held as in phase 20")
    print(card)
    d = os.path.join(tmp, "cohort")
    gen = crt.generate(d, N, COHORT_P, device=dev)
    store = os.path.join(d, "store")
    t0 = time.perf_counter()
    for which in ("first", "last"):
        j0, g = redraw_block(N, COHORT_P, which)
        same = np.array_equal(pack_rows(g), store_rows(store, j0,
                                                       j0 + g.shape[0]))
        print(f"  {which} block (rows {j0}..{j0 + g.shape[0] - 1}) against "
              f"numpy's re-draw: {'identical' if same else 'DIFFERENT'}")
        check(same, f"generate's {which} block differs from numpy's draw")
    redraw_s = time.perf_counter() - t0
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    print(f"generated in {gen['gen_s']:.1f} s (host draws "
          f"{gen['draw_s']:.1f} s), store {meta['store_bytes'] / 1e9:.3f} "
          f"GB; re-draw check {redraw_s:.1f} s; planted "
          f"{meta['qtl_indices']}", flush=True)
    rec = LaunchRecorder(packed, streamed=True)
    res, wall, launches = run_counted(torch, packed, lambda: crt.run(
        d, COHORT_MAXIT, device=dev), rec)
    events = read_log(os.path.join(d, "scan_log.jsonl"))
    phases = scan_phases(events)
    print(f"run wall {wall:.1f} s (phases "
          + ", ".join(f"{k} " + " / ".join(f"{w:.2f}" for w in v)
                      for k, v in phases.items())
          + f"); launches {launches}; selected {res['selected']}, extBIC "
          f"{res['extbic_path']}; peak device memory "
          f"{res['peak_device_bytes'] / 1e9:.3f} GB", flush=True)
    check(res["selected"], "cohort_run_torch's run selected nothing")
    check(all(j in meta["qtl_indices"] for j in res["selected"]),
          f"cohort_run_torch's run selected {res['selected']}, not all "
          f"planted ({meta['qtl_indices']})")
    check(all(math.isfinite(v) for v in res["extbic_path"]),
          "a non-finite extBIC")
    for name in KERNELS:
        check(launches[name] >= 1, f"{name} was never launched by "
              "cohort_run_torch's run")
    kept = slice_checks(torch, packed, rec.kept, "cohort_run_torch's run")
    rec.kept.clear()
    return {"dir": d, "gen": gen, "wall_s": wall, "launches": launches,
            "selected": res["selected"], "phases": phases,
            "peak_bytes": res["peak_device_bytes"], "kept_rel_err": kept}


class BenchRuns:
    """``bench_cuda.py --quick --config C`` in a process of its own for
    each config given, all started at once (each one's output in a file
    under ``tmp``; the cohort directory is EAGLE_COHORT_DIR); on leaving a
    ``with`` block every one still running is killed."""

    def __init__(self, tmp: str, configs, cohort_dir: str):
        env = dict(os.environ, EAGLE_COHORT_DIR=cohort_dir)
        self.runs = {}
        for config in configs:
            path = os.path.join(tmp, f"bench_{config}.out")
            with open(path, "w") as log:
                proc = subprocess.Popen(
                    [sys.executable, os.path.join(ROOT, "bench_cuda.py"),
                     "--quick", "--config", config, "--watchdog", "300"],
                    cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
            self.runs[config] = (proc, path, time.perf_counter())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for proc, _, _ in self.runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        return False

    def result(self, config: str) -> dict:
        """The config's last JSON line (its wall beside it), once its
        process ends; fails on a non-zero exit or no line."""
        proc, path, t0 = self.runs[config]
        try:
            rc = proc.wait(timeout=360)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "killed after 360 s"
        wall = time.perf_counter() - t0
        with open(path) as f:
            text = f.read()
        lines = [ln for ln in text.splitlines() if ln.startswith("{")]
        check(rc == 0 and lines, f"bench_cuda.py --config {config} failed "
              f"(rc {rc}): {text[-1500:]}")
        print(f"  {config:11s} {wall:5.1f} s: {lines[-1]}", flush=True)
        return dict(json.loads(lines[-1]), wall_s=wall)


def bench_phase(torch, cohort: dict, early: BenchRuns, card: str) -> dict:
    """Phase 23: ``bench_cuda.py --quick --config X`` for every config, a
    process each: sweep, eigsweep and multitrait (``early``) started with
    phase 22 and run beside it; then cohort-full on phase 22's store, then
    cohort alone on the card (its ballast takes the rest of it). Each last
    line must carry bench.py's metric and unit (BENCH_LINES), a value > 0
    and no error, and name this card; cohort must have read the store,
    cohort-full launched packed_dot. Deletes phase 22's cohort."""
    phase("23. bench_cuda.py --quick, every config in a process of its own "
          "(sweep, eigsweep and multitrait started with phase 22, beside "
          "it; cohort-full on phase 22's store; cohort alone on the card)")
    print(card)
    out = {c: early.result(c) for c in early.runs}
    torch.cuda.empty_cache()
    for config in ("cohort-full", "cohort"):
        with BenchRuns(os.path.dirname(cohort["dir"]), (config,),
                       cohort["dir"]) as one:
            out[config] = one.result(config)
    check(set(out) == set(BENCH_LINES), f"configs run: {sorted(out)}")
    for config, js in out.items():
        metric, unit = BENCH_LINES[config]
        det = js["detail"]
        check((js["metric"], js["unit"]) == (metric, unit),
              f"{config}: {js['metric']} in {js['unit']}, bench.py's "
              f"{metric} in {unit}")
        check(js["value"] > 0 and "error" not in det,
              f"{config} gave no result: {js}")
        check(det["device"] == torch.cuda.get_device_name(0),
              f"{config} ran on {det['device']}")
    coh = out["cohort"]["detail"]
    check(coh["host"] == "store" and coh["read_bytes"] > 0,
          f"the cohort config did not read the store: {coh}")
    full = out["cohort-full"]["detail"]
    check(full["launches"]["packed_dot"] > 0,
          f"cohort-full launched no packed_dot: {full['launches']}")
    check("error" not in full["multitrait_matfree"],
          f"cohort-full's multi-trait row failed: "
          f"{full['multitrait_matfree']}")
    shutil.rmtree(cohort["dir"])
    return out


def debug_fit_phase(torch, packed, tmp: str, parity_cohort, am_card: dict,
                    dev) -> dict:
    """Phase 24: scripts/debug_resume_fit_torch.py --exact on phase 5's
    parity cohort: the REML profile of the intercept model and of it plus
    phase 5's first selection, on the matrix-free engine (K1/K2 on the
    card, at both protocols, the launches counted around the call) and on
    the exact engine by both routes (the eigenbasis; a blocked f64
    Cholesky of K + δI on the card at each δ). The tight protocol's
    profiles must agree with the exact ones within 1e-3 away from the
    grid's ends, each matrix-free δ̂ must be a maximiser of
    the exact profile (within 0.05 log-likelihood units; the intercept
    model's δ̂ within 0.1 in log δ), and the two exact routes agree to
    1e-8 on the grid and its tail, with equal δ → ∞ limits."""
    c = parity_cohort
    add = int(am_card["indices"][0])
    phase(f"24. scripts/debug_resume_fit_torch.py --exact at {c.n} x {c.p}: "
          f"the REML profiles of [1] and [1, {add}], matrix-free against "
          "exact (eigenbasis and blocked Cholesky)")
    dbg = load_script("debug_resume_fit_torch")
    d = os.path.join(tmp, "debug_fit")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump({"n": c.n, "p": c.p}, f)
    np.save(os.path.join(d, "y.npy"), c.y)
    os.symlink(c.store_dir, os.path.join(d, "store"))
    res, wall, launches = run_counted(torch, packed, lambda: dbg.run(
        d, [], add, True, ["default", "tight"], device=dev,
        out=os.path.join(d, "f4.json"), routes=("eigh", "cholesky")))
    ex, ch = res["exact"], res["exact_cholesky"]

    def gaps(proto: str) -> dict:
        out = {}
        for name, m in res["matfree"][proto]["models"].items():
            a = np.array([r["ll"] for r in m["profile"]])
            b = np.array([r["ll"] for r in ex["models"][name]["profile"]])
            out[name] = float(np.max(np.abs(a[2:-2] / b[2:-2] - 1.0)))
        return out

    # the default protocol's 32 probes leave an SLQ error near 1e-3 of the
    # log-likelihood at the grid's small δ; the tight one is held to it
    print(f"profile gaps away from the grid's ends: default {gaps('default')}"
          f", tight {gaps('tight')}")
    mf = res["matfree"]["tight"]
    worst = max(gaps("tight").values())
    for name, m in mf["models"].items():
        b = np.array([r["ll"] for r in ex["models"][name]["profile"]])
        gap = gaps("tight")[name]
        e = ex["models"][name]
        print(f"{name}: δ̂ matrix-free {m['delta_hat']:.4g} exact "
              f"{e['delta_hat']:.4g}; LL {m['loglik']:.4f} / "
              f"{e['loglik']:.4f}, exact LL at the matrix-free δ̂ "
              f"{m['exact_ll_at_delta_hat']:.4f}; log|H| there "
              f"{m['logdet_at_delta_hat']:.3f} (SLQ) / "
              f"{m['exact_logdet_at_delta_hat']:.3f}; profile gap {gap:.2e}")
        check(gap < 1e-3, f"{name}: the profiles differ by {gap:.2e}")
        check(m["exact_ll_at_delta_hat"] > e["loglik"] - 0.05,
              f"{name}: the matrix-free δ̂ is no maximiser of the exact "
              "profile")
        for rows in ("profile", "tail"):
            chol = [r["ll"] for r in ch["models"][name][rows]]
            eig = [r["ll"] for r in ex["models"][name][rows]]
            check(np.allclose(chol, eig, rtol=1e-8, atol=0.0),
                  f"{name}: the Cholesky route's {rows} differs from the "
                  "eigenbasis")
        check(ch["models"][name]["loglik_limit"]
              == ex["models"][name]["loglik_limit"],
              f"{name}: the two routes' δ → ∞ limits differ")
    check(np.sign(mf["extbic_change"]) == np.sign(ex["extbic_change"]),
          "the engines' extBIC changes differ in sign")
    print(f"extBIC change for {add}: matrix-free {mf['extbic_change']:.3f} "
          f"(hinted {mf['extbic_change_hinted']:.3f}), exact "
          f"{ex['extbic_change']:.3f}; Cholesky residual "
          f"{ch['chol_residual']:.2e} ({ch['factorizations']} factorisations"
          f", {ch['factor_s']:.2f} s); {wall:.1f} s; launches {launches}",
          flush=True)
    return {"launches": launches, "wall_s": wall, "profile_gap": worst,
            "extbic_change": {"matfree": mf["extbic_change"],
                              "exact": ex["extbic_change"]}}


def vignette_phase(tmp: str) -> dict:
    """Phase 25: examples/python_api_torch.py on the card and, beside it,
    its CPU leg (a process each): the same selections, extBIC within rtol
    1e-6, both engines agreeing in each."""
    phase("25. examples/python_api_torch.py on the card and its CPU leg")
    script = os.path.join(ROOT, "examples", "python_api_torch.py")
    procs, logs = {}, {}
    try:
        for leg in ("cpu", "cuda"):
            logs[leg] = open(os.path.join(tmp, f"vignette_{leg}.log"), "w+")
            env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="4")
            procs[leg] = subprocess.Popen(
                [sys.executable, script, "--device", leg, "--plots",
                 os.path.join(tmp, f"vignette_{leg}")], cwd=ROOT, env=env,
                stdout=logs[leg], stderr=subprocess.STDOUT)
        t0 = time.perf_counter()
        for leg, pr in procs.items():
            pr.wait(timeout=300)
        wall = time.perf_counter() - t0
    finally:
        for pr in procs.values():
            if pr.poll() is None:
                pr.kill()
            pr.wait()
    out = {}
    for leg, f in logs.items():
        f.seek(0)
        text = f.read()
        f.close()
        check(procs[leg].returncode == 0, f"the vignette's {leg} leg failed "
              f"(rc {procs[leg].returncode}): {text[-2000:]}")
        out[leg] = json.loads(text.strip().splitlines()[-1])
    got, want = out["cuda"], out["cpu"]
    check(got["selected"] == want["selected"] == got["matfree_selected"],
          f"the vignette selected {got['selected']} on the card, "
          f"{want['selected']} on the CPU")
    gap = rel_gap(got["extbic_path"], want["extbic_path"])
    check(gap < 1e-6, f"the vignette's extBIC paths differ by {gap:.2e}")
    print(f"selected {got['selected']} on both legs (extBIC gap {gap:.2e}), "
          f"λ {got['lambda']:.3f} (card) / {want['lambda']:.3f} (CPU); "
          f"plots {got['plots']}; both legs {wall:.1f} s", flush=True)
    return {"selected": got["selected"], "wall_s": wall}


def ingest_bench_phase(tmp: str, card: str) -> dict:
    """Phase 26: scripts/ingest_bench_torch.py --gb 0.5 --format both on
    the card's host: MB/s for each format through the native ingest."""
    phase("26. scripts/ingest_bench_torch.py --gb 0.5 --format both")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "ingest_bench_torch.py"),
         "--gb", "0.5", "--format", "both", "--dir",
         os.path.join(tmp, "ingest_bench")], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300)
    check(res.returncode == 0, f"ingest_bench_torch.py failed: "
          f"{res.stderr[-2000:]}")
    results = json.loads(res.stdout.strip().splitlines()[-1])["results"]
    check([r["format"] for r in results] == ["vcf", "text"],
          f"ingest_bench_torch.py reported {results}")
    for r in results:
        check(r["mb_per_s"] > 0 and r["parser"] == "native",
              f"no native MB/s for {r['format']}: {r}")
        print(f"{r['format']}: {r['input_gb']} GB ({r['n']} x {r['p']}) in "
              f"{r['wall_s']} s, {r['mb_per_s']} MB/s, {r['snps_per_s']} "
              f"SNPs/s, store {r['store_gb']} GB ({card}'s host)",
              flush=True)
    return {r["format"]: r for r in results}


def weakscale_phase(tmp: str) -> dict:
    """Phase 27: scripts/weakscale_torch.py --device cuda --quick --rounds
    1 --share-card: N = 1 on the card, N = 2 with both ranks on it over
    gloo (flagged shared_card: no scaling measurement), each point's K1/K2
    launches in (b) and (e) counted on rank 0."""
    phase("27. scripts/weakscale_torch.py --device cuda --quick --rounds 1 "
          "--share-card")
    out = os.path.join(tmp, "weakscale.json")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "weakscale_torch.py"),
         "--device", "cuda", "--quick", "--rounds", "1", "--share-card",
         "--out", out,
         "--timeout", "240"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="4"),
        capture_output=True, text=True, timeout=600)
    print(res.stdout[-2500:], flush=True)
    check(res.returncode == 0, f"weakscale_torch.py failed: "
          f"{res.stderr[-2000:]}")
    with open(out) as f:
        rep = json.load(f)
    check(rep["points"]["1"]["shared_card"] is False
          and rep["points"]["2"]["shared_card"] is True,
          "weakscale_torch.py flagged its points wrongly")
    launches = {}
    for n, pt in rep["points"].items():
        lc = pt["launches"]
        check(lc["matvec"]["packed_dot"] >= 1
              and lc["matvec"]["packed_tdot"] >= 1
              and lc["statrows"]["packed_dot"] >= 1,
              f"N={n}: K1/K2 did not launch in (b)/(e): {lc}")
        launches[n] = {k: lc["matvec"][k] + lc["statrows"][k]
                       for k in lc["matvec"]}
    return {"launches": launches, "report": rep}


def card_kernel(torch, n: int, seed: int, dev, block: int = 8192):
    """K = W·Wᵀ/n on the card, W standard normal n × n drawn a column block
    at a time from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    K = torch.zeros((n, n), device=dev)
    for c0 in range(0, n, block):
        W = torch.randn((n, min(block, n - c0)), generator=g, device=dev)
        K.addmm_(W, W.T, alpha=1.0 / n)
        del W
    return K


def eigh_phase(torch, ep, packed, kernels, engine_torch, tmp: str,
               seed: int, dev) -> dict:
    """Phase 29: the exact engine's eigendecomposition above cuSOLVER's
    limit. engine_torch.eigh_large (Householder tridiagonalisation, divide
    and conquer with leaves for torch.linalg.eigh, compact-WY
    back-transform; leaves as eigh_basis sets them) forced at EIGH_CHECK_N
    against torch.linalg.eigh on the same kernel: the eigenvalues within
    1e-5 of d_max, residual and orthogonality within 10x of cuSOLVER's.
    torch.linalg.eigh at DEVICE_EIGH_MAX_N (its residuals, the yardstick
    below) and refusing one past it. eigh_large at N: residual and
    orthogonality within 10x of cuSOLVER's at the limit, |Σd − tr K|/tr K
    ≤ 1e-5, |Σd² − ‖K‖²_F|/‖K‖²_F ≤ 1e-4, its stages' seconds and its peak
    beside the kernel. Then ``am(engine="auto")`` at matfree_min_n, the
    exact engine's largest n, which takes eigh_large once (counted by its
    stage a, whose bytes are the trailing blocks read once a column):
    every selection planted."""
    lim = engine_torch.DEVICE_EIGH_MAX_N
    leaf = min(lim, engine_torch.EIGH_LEAF_N)
    edge = ep.EagleConfig().matfree_min_n
    phase(f"29. the exact engine above cuSOLVER's limit (DEVICE_EIGH_MAX_N "
          f"= {lim}): eigh_large (leaves of {leaf}) against "
          f"torch.linalg.eigh at n = {EIGH_CHECK_N}, cuSOLVER at {lim} and "
          f"{lim + 1}, eigh_large at n = {N}, then am(engine='auto') at "
          f"{edge} x {AUTO_EDGE_P}")
    out = {"limit": lim, "leaf": leaf}

    def route(K) -> tuple[dict, object]:
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        t0 = time.perf_counter()
        d, U = engine_torch.eigh_large(K.clone(), leaf, stats=stats)
        torch.cuda.synchronize()
        r = {"seconds": time.perf_counter() - t0, "stages": stats,
             "peak_squares": (torch.cuda.max_memory_allocated() - base)
             / (4.0 * K.shape[0] ** 2)}
        r["residual"], r["orthogonality"] = engine_torch.eig_residuals(
            K, d, U)
        return r, d

    def library(K) -> tuple[dict, object]:
        t0 = time.perf_counter()
        d, U = torch.linalg.eigh(K)
        torch.cuda.synchronize()
        r = {"seconds": time.perf_counter() - t0}
        r["residual"], r["orthogonality"] = engine_torch.eig_residuals(
            K, d, U)
        return r, d

    K = card_kernel(torch, EIGH_CHECK_N, seed, dev)
    lib, d_lib = library(K)
    mine, d = route(K)
    del K
    gap = float(torch.max(torch.abs(d - d_lib.double()))) / float(d[-1])
    print(f"n = {EIGH_CHECK_N}: eigh_large {mine['seconds']:.2f} s "
          f"(stages {mine['stages']}), residual {mine['residual']:.2e}, "
          f"orthogonality {mine['orthogonality']:.2e}; torch.linalg.eigh "
          f"{lib['seconds']:.2f} s, {lib['residual']:.2e}, "
          f"{lib['orthogonality']:.2e}; eigenvalue gap {gap:.2e} of d_max",
          flush=True)
    check(gap <= 1e-5, f"eigh_large's eigenvalues differ from cuSOLVER's "
          f"by {gap:.2e} of d_max")
    for key in ("residual", "orthogonality"):
        check(mine[key] <= 10 * lib[key], f"eigh_large's {key} "
              f"{mine[key]:.2e} is over 10x cuSOLVER's {lib[key]:.2e}")
    out["check"] = {"route": mine, "cusolver": lib, "gap": gap}
    torch.cuda.empty_cache()

    K = card_kernel(torch, lim, seed, dev)
    at_lim, _ = library(K)
    del K
    torch.cuda.empty_cache()
    past = torch.eye(lim + 1, device=dev)
    try:
        torch.linalg.eigh(past)
        refused = ""
    except torch.linalg.LinAlgError as e:
        # the probe: one past the limit the library must refuse the kernel
        refused = str(e).split(".")[0]
    del past
    print(f"torch.linalg.eigh at n = {lim}: {at_lim['seconds']:.2f} s, "
          f"residual {at_lim['residual']:.2e}, orthogonality "
          f"{at_lim['orthogonality']:.2e}; at {lim + 1}: {refused}",
          flush=True)
    check("cusolverDnXsyevd_bufferSize" in refused,
          f"torch.linalg.eigh took n = {lim + 1}: DEVICE_EIGH_MAX_N is not "
          "the card's limit")
    out["cusolver_at_limit"] = at_lim
    torch.cuda.empty_cache()

    K = card_kernel(torch, N, seed, dev)
    big, d = route(K)
    tr = float(torch.sum(K.diagonal().double()))
    fro2 = sum(float(torch.sum(K[r0:r0 + 8192].double() ** 2))
               for r0 in range(0, N, 8192))
    del K
    big["trace_rel"] = abs(float(torch.sum(d)) - tr) / tr
    big["frobenius_rel"] = abs(float(torch.sum(d * d)) - fro2) / fro2
    print(f"n = {N}: eigh_large {big['seconds']:.1f} s (stages "
          + ", ".join(f"{k} {v:.1f}" for k, v in big["stages"].items())
          + f"), peak {big['peak_squares']:.2f} n² f32 beside the kernel, "
          f"residual {big['residual']:.2e}, orthogonality "
          f"{big['orthogonality']:.2e}, |Σd − tr K|/tr K "
          f"{big['trace_rel']:.2e}, |Σd² − ‖K‖²|/‖K‖² "
          f"{big['frobenius_rel']:.2e}; d in [{float(d[0]):.3g}, "
          f"{float(d[-1]):.3g}]", flush=True)
    for key in ("residual", "orthogonality"):
        check(big[key] <= 10 * at_lim[key], f"eigh_large's {key} at n = {N}"
              f" {big[key]:.2e} is over 10x cuSOLVER's at its limit "
              f"{at_lim[key]:.2e}")
    check(big["trace_rel"] <= 1e-5 and big["frobenius_rel"] <= 1e-4,
          f"eigh_large at n = {N} misses the trace or Frobenius identity")
    out["large"] = big
    torch.cuda.empty_cache()

    edge_run = exact_scan_phase(
        torch, ep, packed, kernels, engine_torch, tmp,
        "29b. the exact engine at auto's edge", edge, AUTO_EDGE_P,
        AUTO_EDGE_MAXIT, seed, dev,
        {"eigh_large stage a": (engine_torch, "_tridiagonalize",
                                lambda a: (0, 4 * a[0].shape[0] ** 3 / 3))})
    stage_a = edge_run["ops"]["eigh_large stage a"]
    check(edge_run["basis"].host_f64 is None and stage_a["calls"] == 1,
          f"am(engine='auto') at n = {edge} did not take eigh_large once")
    print(f"eigh_large inside am(): {edge_run['phases']['eigh'][0]:.1f} s "
          f"(its stage a {stage_a['ms'] / 1e3:.1f} s); am() "
          f"{edge_run['wall_s']:.1f} s", flush=True)
    out["auto_edge"] = {k: edge_run[k] for k in (
        "wall_s", "peak_bytes", "indices", "extbic_path", "phases")}
    out["auto_edge"]["eigh_large_s"] = edge_run["phases"]["eigh"][0]
    return out


def f5_phase(torch, packed, tmp: str, dev) -> dict:
    """Phase 30: ROADMAP F5's step on the card. tests/test_torch_f5.py's
    cohort is generated on the card and the device Lanczos of [1,
    W_markers, y] runs on the card (K1/K2) and on the CPU (the plain
    versions) with one s0: the breakdown guard zeroes β_1 of the six
    marker columns and of neither the intercept nor y on both, T's
    coefficients agree up to it (rtol 1e-4; atol 1e-6 of the largest α)
    and are exact zeros after it, no raw Ritz value is negative; the REML
    profile over the card's bases lies within max(1e-6, 8·ε·κ(δ)) of the
    CPU's (the bound the test holds the port to the JAX package with).
    Then scripts/debug_resume_fit_torch.py --exact (default protocol, the
    launches counted) profiles [1, five markers] and it plus the sixth on
    the card: the same guard steps as the CPU record F5_RECORD, and, as
    ROADMAP F5 decided (A: the reference's algorithm, the card adding
    nothing), the card's profile gap to the exact profile and its extBIC
    excess over the exact supremum within 20% of the CPU's, or within the
    same f32 bound where that is wider (at the grid's small end here)."""
    from eagleeverything_tpu_torch.models import bigscan
    phase(f"30. ROADMAP F5's step on the card: the device Lanczos's guard "
          f"at {F5_N} x {F5_P} ({F5_POLY} polymorphic SNPs), card against "
          "CPU and the CPU record")
    crt = load_script("cohort_run_torch")
    dbg = load_script("debug_resume_fit_torch")
    d = os.path.join(tmp, "f5")
    crt.generate(d, F5_N, F5_P, device=dev, poly=F5_POLY)
    meta, y = crt._load(d)
    where = {"cuda": dev, "cpu": torch.device("cpu")}
    bs = {k: crt._backend(d, meta, "off", v) for k, v in where.items()}
    X = dbg.models(bs["cpu"], F5_N, F5_MARKERS, None)["model"]
    s0 = dbg.hutchinson_s0(bs["cpu"], F5_N)
    B = np.column_stack([X, y])
    r = B.shape[1]
    sk = {k: bigscan.ShiftedKrylov(
        None, B, F5_M, reorth=True,
        device_lanczos=lambda Z, m, ro, b=b: b.device_lanczos(Z, m, ro, s0))
        for k, b in bs.items()}
    want = [-1] + [1] * len(F5_MARKERS) + [-1]
    atol = 1e-6 * np.abs(sk["cpu"].alphas).max()
    for k, v in sk.items():
        print(f"{k}: guard steps {v.guard_step.tolist()}, ratios "
              + ", ".join(f"{g:.3g}" for g in v.guard_ratio)
              + f"; raw Ritz min {v.w_raw.min():.6g}, "
              f"{int((v.w_raw < 0).sum())} below 0")
        check(v.guard_step.tolist() == want,
              f"{k}: the guard fired at {v.guard_step.tolist()}")
        check(not (v.w_raw < 0).any(), f"{k}: a raw Ritz value below 0")
    a, c = sk["cuda"], sk["cpu"]
    for j, k in enumerate(want):
        kept = slice(None) if k < 0 else slice(0, k + 1)
        check(np.allclose(a.alphas[kept, j], c.alphas[kept, j], rtol=1e-4,
                          atol=atol)
              and np.allclose(a.betas[kept, j][: F5_M - 1],
                              c.betas[kept, j][: F5_M - 1], rtol=1e-4,
                              atol=atol),
              f"column {j}: T's coefficients differ, card against cpu")
        if k >= 0:
            check(np.all(a.alphas[k + 1:, j] == 0.0)
                  and np.all(a.betas[k:, j] == 0.0),
                  f"column {j}: no exact zeros after the guard on the card")
    lam = np.linalg.eigvalsh(bs["cpu"].compute_K() / s0)
    eps = np.finfo(np.float32).eps / 2
    worst = 0.0
    for delta in dbg.GRID:
        logdet = float(np.sum(np.log(lam + delta)))
        got, want_ll = (bigscan._ll_from_solution(y, X, v.solve(delta),
                                                  logdet)[0]
                        for v in (a, c))
        kappa = (lam[-1] + delta) / (lam[0] + delta)
        worst = max(worst, abs(got - want_ll) / (
            max(1e-6, 8 * eps * kappa) * abs(want_ll)))
    print(f"profile over the guarded bases, card against cpu: at most "
          f"{worst:.3f} of the f32 bound")
    check(worst <= 1.0, "the card's profile leaves the f32 bound")
    res, wall, launches = run_counted(torch, packed, lambda: dbg.run(
        d, F5_MARKERS[:-1], F5_MARKERS[-1], True, ["default"], device=dev,
        out=os.path.join(d, "f5_card.json")))
    with open(os.path.join(ROOT, F5_RECORD)) as f:
        rec = json.load(f)
    ex = rec["exact"]
    lo = ex["floor_matfree"]
    hi = ex["d_max"] * ex["s0_exact"] / ex["s0_matfree"]

    def f32_bound(delta: float, ll: float) -> float:
        # what two f32 bases may move a log-likelihood at δ, as above
        return 8 * eps * (hi + delta) / (lo + delta) * abs(ll)

    for name, m in res["matfree"]["default"]["models"].items():
        cm = rec["matfree"]["default"]["models"][name]
        print(f"{name}: guard steps {m['guard_step']} (cpu "
              f"{cm['guard_step']}), raw Ritz min {m['w_raw_min']:.6g} "
              f"({m['n_negative']} below 0), weight below the floor "
              f"{max(m['weight_below_floor']):.2e}; profile gap "
              f"{m['profile_gap_max']:.3f} (cpu {cm['profile_gap_max']:.3f})"
              f", extBIC excess {m['extbic_excess']:.3f} (cpu "
              f"{cm['extbic_excess']:.3f}); δ̂ {m['delta_hat']:.4g} (cpu "
              f"{cm['delta_hat']:.4g})")
        check(m["guard_step"] == cm["guard_step"],
              f"{name}: the guard fired elsewhere than on the cpu")
        # within 20% of the record, or within what f32 lets two bases
        # differ: at every trimmed grid point for the gap, twice the bound
        # at δ̂ for the excess (extBIC is -2 LL + its penalty)
        tol = {"profile_gap_max": max(
                   f32_bound(r["delta"], r["ll"])
                   for r in ex["models"][name]["profile"][2:-2]),
               "extbic_excess": 2 * f32_bound(cm["delta_hat"],
                                              cm["loglik"])}
        for key, t in tol.items():
            check(abs(m[key] - cm[key]) <= max(0.2 * abs(cm[key]), t),
                  f"{name}: {key} {m[key]:.3f} against the cpu's "
                  f"{cm[key]:.3f} (f32 bound {t:.3f})")
    print(f"{wall:.1f} s; launches {launches}", flush=True)
    shutil.rmtree(d, ignore_errors=True)
    return {"launches": launches, "wall_s": wall, "bound_share": worst}


def run(args) -> None:
    import torch

    from eagleeverything_tpu_torch.models import engine_torch
    from eagleeverything_tpu_torch.ops import build, kernels, packed
    import eagleeverything_tpu_torch as ep

    dev = torch.device("cuda")
    # IEEE fp32 throughout: no TF32 in the plain versions' matmuls either
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_phase(torch)
    build_phase(build)
    ragged = ragged_phase(torch, packed, dev, args.seed)
    timing = timing_phase(torch, packed, dev, N, P_KERNELS, args.seed)
    axis_timing = axis_timing_phase(torch, packed, dev, args.seed)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                     prefix="smoke_") as tmp, \
            CpuLegs(tmp) as legs:
        mf_parity, am_card = parity_phase(torch, ep, tmp, args.seed, dev)
        main = main_path_phase(torch, ep, packed, tmp, N, args.p,
                               args.seed, dev)
        # the CPU legs of the matrix-free parity cells start once the main
        # path's walls are taken, and overlap phases 7-14
        prep = start_cpu_legs(legs, ep, tmp, mf_parity, args.seed, dev)
        parity = exact_parity_phase(torch, ep, tmp, args.seed, dev)
        cfg2 = config2_phase(torch, ep, packed, kernels, engine_torch, tmp,
                             args.seed, dev)
        large_n_phase(torch, ep, packed, kernels, engine_torch, tmp,
                      args.seed, dev)
        flow = workflow_phase(torch, ep, packed, engine_torch, tmp, cfg2,
                              args.seed)
        fpr_parity_phase(torch, ep, parity)
        zmat = zmat_phase(torch, ep, packed, tmp, prep, args.seed, dev)
        multi = multi_phase(torch, ep, packed, tmp, mf_parity, prep,
                            zmat["cohort"], args.seed)
        fpr_mf = fpr_matfree_phase(torch, ep, packed, mf_parity,
                                   zmat["cohort"])
        # phases 24, 25, 27, 29 and 30 need none of phases 15-23 and run
        # while the CPU legs finish, in the card's idle wait for them
        debug_fit = debug_fit_phase(torch, packed, tmp, mf_parity, am_card,
                                    dev)
        vignette = vignette_phase(tmp)
        weak = weakscale_phase(tmp)
        eigh = eigh_phase(torch, ep, packed, kernels, engine_torch, tmp,
                          args.seed, dev)
        f5 = f5_phase(torch, packed, tmp, dev)
        legs_phase(legs, {"am": am_card, "zmat": zmat["card"],
                          "am_multi": multi["card"],
                          "fpr4am": fpr_mf["card"]},
                   LIMIT_S - (time.perf_counter() - t_start))
        # the multi-process phases run once the CPU legs are done, so that
        # their host work does not compete with them
        world1 = world1_phase(torch, ep, packed, kernels, tmp, cfg2, dev)
        ranks = two_rank_phase(
            torch, tmp, cfg2, world1, main,
            min(600.0, LIMIT_S - (time.perf_counter() - t_start)))
        streamed = streamed_phase(torch, ep, packed, engine_torch, tmp, card,
                                  main, cfg2, dev)
        store = store_phase(torch, ep, packed, engine_torch, tmp, card,
                            main, streamed, cfg2, zmat["cohort"], dev)
        axes = load_script("biobank_axes_torch")
        n_axis = n_axis_phase(torch, packed, engine_torch, axes, tmp, card,
                              dev)
        p_axis = p_axis_phase(torch, packed, axes, tmp, card, dev)
        with BenchRuns(tmp, ("sweep", "eigsweep", "multitrait"),
                       os.path.join(tmp, "cohort")) as early:
            cohort = cohort_run_phase(torch, packed,
                                      load_script("cohort_run_torch"), tmp,
                                      card, dev)
            benches = bench_phase(torch, cohort, early, card)
        # the ingest bench alone on the host, so that its rate is its own
        ingest = ingest_bench_phase(tmp, card)

    phase("28. kernels")
    by_path = {"am_matfree": main["launches"],
               "summary_am_matfree": flow["summary_matfree_launches"],
               "am_matfree_zmat": zmat["launches"],
               "am_multi_matfree": multi["launches"],
               "fpr4am_matfree": fpr_mf["launches"]}
    for r, out in enumerate(ranks["ranks"]):
        by_path[f"am_matfree_rank{r}_of_2"] = out["matfree"]["launches"]
    by_path["am_matfree_streamed"] = streamed["launches"]
    by_path["am_matfree_store"] = store["launches"]
    by_path["biobank_n_axis"] = n_axis["launches"]
    by_path["biobank_p_axis"] = p_axis["launches"]
    by_path["cohort_run_matfree"] = cohort["launches"]
    by_path["debug_fit_matfree"] = debug_fit["launches"]
    by_path["f5_profile_matfree"] = f5["launches"]
    for n, counts in weak["launches"].items():
        by_path[f"weakscale_N{n}_rank0"] = counts
    w1 = world1["warm"]
    print(f"world 1 (NCCL): am(engine='sharded') {world1['wall_s']:.1f} s, "
          f"mmt_psum {w1['mmt_psum']['ms']:.3f} ms, "
          "score_and_argmax_from_T "
          f"{w1['score_and_argmax_from_T']['ms']:.3f} ms a call (warm); "
          f"two ranks on one card ({ranks['transport']}): "
          + ", ".join(f"rank {o['rank']} sharded {o['sharded']['wall_s']:.1f}"
                      f" s, matrix-free {o['matfree']['wall_s']:.1f} s "
                      f"({o['matfree']['allreduces']} all-reduces, "
                      f"{o['matfree']['allreduce_ms']:.0f} ms)"
                      for o in ranks["ranks"]))
    print(f"packed_dot by design on the main path: {main['k1_designs']}")
    print("matrix-free walls: am() " + f"{main['wall_s']:.1f} s (phases "
          + ", ".join(f"{k} " + " / ".join(f"{w:.2f}" for w in v)
                      for k, v in main["phases"].items())
          + f"), am(Zmat) {zmat['wall_s']:.1f} s, am_multi (R = 4) "
          f"{multi['wall_s']:.1f} s, fpr4am {fpr_mf['per_perm_s']:.2f} s a "
          f"permutation; device Lanczos m = {main['lanczos']['m']} "
          f"{main['lanczos']['device_ms']:.1f} ms vs host "
          f"{main['lanczos']['host_ms']:.1f} ms")
    print(f"streamed stack ({card}): am() {streamed['wall_s']:.1f} s, "
          f"{streamed['passes']} passes of {streamed['gate']['chunks']} "
          f"chunks, link {streamed['link']['gb_s']:.2f} GB/s (1 GiB copy), "
          f"{streamed['link']['ring_gb_s']:.2f} GB/s (the ring's copies); "
          "K3 a pass "
          + ", ".join(f"r={r}: streamed {k['streamed_ms']:.2f} ms, resident "
                      f"{k['resident_ms']:.2f} ms, bound {k['bound_ms']:.2f} "
                      f"ms ({k['bound_by']})"
                      for r, k in streamed["kv"].items())
          + f"; idle share of a traced iteration "
          f"{streamed['trace'].get('device_idle_share', float('nan')):.1%}; "
          f"exact config 2 {streamed['exact_wall_s']:.2f} s")
    print(f"stack read from the store ({card}): am() on "
          f"{store['gate']['chunks']} chunks of {store['gate']['chunk_rows']}"
          f" rows {store['wall_s']:.1f} s, {store['passes']} passes, "
          f"{store['read_bytes'] / 1e9:.1f} GB read at "
          f"{store['read_bytes'] / store['read_s'] / 1e9:.2f} GB/s while "
          "reading; K3 a pass on phase 6's cohort "
          + ", ".join(f"r={r}: {k['store_ms']:.2f} ms (pinned "
                      f"{k['pinned_ms']:.2f} ms), reader {k['read_gb_s']:.2f}"
                      " GB/s" for r, k in store["kv"].items())
          + f"; {store['host_bytes'] / 1e9:.3f} GB page-locked; exact config "
          f"2 from int8 rows {store['exact_wall_s']:.2f} s")
    print(f"BASELINE config 4's n axis ({card}): gen_n "
          f"{n_axis['gen']['gen_s']:.1f} s, run_n {n_axis['wall_s']:.1f} s "
          f"({N_AXIS_MAXIT} steps, {n_axis['passes']} stack passes), selected "
          f"{n_axis['selected']}, peak {n_axis['peak_bytes'] / 1e9:.3f} GB "
          f"(stack {n_axis['stack_bytes'] / 1e9:.3f} GB, reserve "
          f"{n_axis['reserve_bytes'] / 1e9:.3f} GB), idle share of the "
          "traced iteration "
          f"{n_axis['trace'].get('device_idle_share', float('nan')):.1%}; "
          f"p axis: gen_p --store-only {p_axis['gen']['write_s']:.1f} + "
          f"{p_axis['gen']['store_s']:.1f} s, run_p {p_axis['wall_s']:.1f} "
          f"s, sweep {p_axis['sweep_s']:.2f} s ({p_axis['snps_per_s']:.0f} "
          f"SNPs/s), argmax {p_axis['argmax']}")
    print(f"cohort_run_torch at {N} x {COHORT_P} ({card}): generate "
          f"{cohort['gen']['gen_s']:.1f} s, run {cohort['wall_s']:.1f} s, "
          f"selected {cohort['selected']}; bench_cuda.py --quick: "
          + ", ".join(f"{c} {b['value']} {b['unit']} ({b['wall_s']:.1f} s)"
                      for c, b in benches.items()))
    wpts = weak["report"]["points"]
    print(f"debug_resume_fit_torch at the parity cohort: profile gap "
          f"{debug_fit['profile_gap']:.2e}, {debug_fit['wall_s']:.1f} s; "
          f"vignette {vignette['selected']} ({vignette['wall_s']:.1f} s); "
          "ingest "
          + ", ".join(f"{k} {v['mb_per_s']} MB/s" for k, v in ingest.items())
          + "; weakscale (N = 2 shares the card: no scaling) "
          + ", ".join(f"N={n} {ph} {wpts[n][ph]['t_s_median']:.4f} s"
                      for n in wpts for ph in ("matvec", "statrows")))
    big, lim = eigh["large"], eigh["cusolver_at_limit"]
    print(f"eigh_large ({card}): n = {N} {big['seconds']:.1f} s (stages "
          + ", ".join(f"{k} {v:.1f}" for k, v in big["stages"].items())
          + f"), peak {big['peak_squares']:.2f} n², residual "
          f"{big['residual']:.2e} / orthogonality {big['orthogonality']:.2e}"
          f" against cuSOLVER's {lim['residual']:.2e} / "
          f"{lim['orthogonality']:.2e} at n = {eigh['limit']} "
          f"({lim['seconds']:.1f} s); am(engine='auto') at auto's edge "
          f"{eigh['auto_edge']['wall_s']:.1f} s (eigh_large "
          f"{eigh['auto_edge']['eigh_large_s']:.1f} s), selected "
          f"{eigh['auto_edge']['indices']}")
    entries = []
    head = 64
    for name, meta in KERNELS.items():
        by_r = timing[name]
        m = by_r[head]
        print(f"{name}: checked (ragged worst rel err {ragged[name]:.2e}), "
              "launches by path "
              + ", ".join(f"{k} {v[name]}" for k, v in by_path.items())
              + " (rel err in the matrix-free summary_am "
              f"{flow['summary_matfree_rel_err'][name]:.2e}), "
              + ", ".join(f"r={r}: {v['ms']:.3f} ms"
                          for r, v in by_r.items()))
        for path, counts in by_path.items():
            check(counts[name] >= 1, f"{name} has no launch on {path}")
        entries.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": main["launches"][name],
            "launches_by_path": {
                **{k: v[name] for k, v in by_path.items()},
                "exact_streamed": streamed["exact_launches"][name],
                "exact_store": store["exact_launches"][name],
                "bench_cohort_full_quick": benches["cohort-full"]["detail"][
                    "launches"][name]},
            "summary_am_matfree_rel_err":
                flow["summary_matfree_rel_err"][name],
            "two_rank_rel_err": max(o["matfree"]["rel_err"][name]
                                    for o in ranks["ranks"]),
            "max_abs_err": max(v["max_abs_err"] for v in by_r.values()),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "bound_unit": m["bound_unit"],
            "library_ms": m["library_ms"],
            "shape": {"n": N, "p": P_KERNELS, "r": head},
            "by_r": {str(r): v for r, v in by_r.items()},
            "axis_shapes": {f"{n}x{p}": {str(r): v for r, v in
                                         res[name].items()}
                            for (n, p), res in axis_timing.items()
                            if name in res},
            "axis_rel_err": max(n_axis["kept_rel_err"][name],
                                p_axis["kept_rel_err"][name]),
            "cohort_run_rel_err": cohort["kept_rel_err"][name]})
        if name == "packed_dot":
            entries[-1]["am_multi_wide_rel_err"] = multi["wide_rel_err"]
            entries[-1]["am_multi_widths"] = {
                str(r): c for r, c in multi["k1_widths"].items()}
    kv = timing["kernel_matvec"]
    print("kernel_matvec (packed_dot then packed_tdot): "
          + ", ".join(f"r={r}: {v['ms']:.3f} ms" for r, v in kv.items())
          + "; at n = 500 000, p = 32 768: "
          + ", ".join(f"r={r}: {v['ms']:.3f} ms" for r, v in
                      axis_timing[500000, 32768]["kernel_matvec"].items()))
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
    ap.add_argument("--cpu-legs", nargs=2, metavar=("SPEC", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank", nargs=2, metavar=("SPEC", "OUT"),
                    help=argparse.SUPPRESS)
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
    if args.cpu_legs:
        # the CPU-legs process a run starts (CpuLegs): CPU work only
        return cpu_legs(*args.cpu_legs)
    if args.rank:
        # one of the two ranks phase 17 starts
        try:
            return rank_job(*args.rank)
        except SmokeFailure as e:
            print(f"FAIL: {e}", flush=True)
            return 1
    try:
        run(args)
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
