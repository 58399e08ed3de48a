#!/usr/bin/env python
"""Find the largest n whose kernel ``torch.linalg.eigh`` (cuSOLVER's
``cusolverDnXsyevd``) decomposes on the card, for the exact engine's
``engine_torch.DEVICE_EIGH_MAX_N``.

Two measurements, one process, one card:

1. the workspace query alone: ``cusolverDnXsyevd_bufferSize`` called
   through ctypes on the library torch loaded, with the arguments torch's
   eigh passes (jobz vectors, lower, lda = n), bisected over n for f32
   and f64. It reads no matrix, so every n costs microseconds;
2. ``torch.linalg.eigh`` itself at ``--sizes`` and at both sides of the
   bisected limit, on a PSD kernel made on the card from ``--seed``
   (K = W·Wᵀ/p, W standard normal n × p, p = 4n, built a column block of
   W at a time), each with its time, ‖KU − UΛ‖_F/‖K‖_F and ‖UᵀU − I‖_F/√n
   (engine_torch.eig_residuals), or its error. Then the same at the
   smallest failing n in f64, and in f32 with
   ``torch.backends.cuda.preferred_linalg_library("magma")``;
3. with ``--route N,...``: the exact engine's own route above the limit,
   ``engine_torch.eigh_large`` with leaves of ``--leaf``, on the same
   kind of kernel at each n: each stage's seconds, the allocator's peak
   beside the kernel (in n × n f32 squares), the residuals, |Σd − tr K| /
   tr K and |Σd² − ‖K‖²_F| / ‖K‖²_F, and cuSOLVER on the same kernel
   where n allows it. With ``--leaves``, the divide and conquer alone on
   the largest n's tridiagonal at each of those leaf sizes first;
4. with ``--gemv N``: the product that costs stage (a) its time, the
   trailing block of an N × N matrix times a vector, at trailing sizes N,
   N/2 and N/4, in the forms torch offers (A·v, vᵀ·A), and the panel's
   skinny products (64 reflectors against a vector, and back), each the
   median of 5 between CUDA events, beside its bytes over 3.35 TB/s;
5. with ``--trace N``: stage (a) at N under ``torch.profiler``, its
   device time by op (key_averages) and its wall.

Usage (from the root of a checkout, on a machine with one card):

  python scripts/eigh_limit_torch.py [--sizes 16384,24576,...]
      [--no-limit] [--route 16384,50000] [--leaf 4096]
      [--leaves 2048,4096,8192] [--gemv 50000] [--seed 7] [--out FILE]

It prints one JSON line a measurement and writes them all to ``--out``
(default build/eigh_limit.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SIZES = (16384, 24576, 32767, 32768, 40000, 46340)
# cusolver_common.h / library_types.h / cublas_api.h
CUDA_R_32F, CUDA_R_64F = 0, 1
CUSOLVER_EIG_MODE_VECTOR = 1
CUBLAS_FILL_MODE_LOWER = 0


def _emit(rows: list, row: dict) -> None:
    rows.append(row)
    print(json.dumps(row), flush=True)


def _cusolver() -> ctypes.CDLL:
    """The cuSOLVER library this process's torch loaded (found in the
    process's maps after one small eigh on the card)."""
    torch.linalg.eigh(torch.eye(4, device="cuda"))
    torch.cuda.synchronize()
    with open("/proc/self/maps") as f:
        paths = sorted({line.split()[-1] for line in f
                        if "libcusolver.so" in line and "Mg" not in line})
    # else the library of the nvidia wheels beside torch, or by its soname
    site = os.path.dirname(os.path.dirname(torch.__file__))
    wheel = os.path.join(site, "nvidia", "cusolver", "lib",
                         "libcusolver.so.11")
    path = paths[0] if paths else wheel if os.path.exists(wheel) \
        else "libcusolver.so.11"
    lib = ctypes.CDLL(path)
    lib.cusolverDnCreate.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    lib.cusolverDnCreateParams.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    lib.cusolverDnXsyevd_bufferSize.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t)]
    for fn in (lib.cusolverDnCreate, lib.cusolverDnCreateParams,
               lib.cusolverDnXsyevd_bufferSize):
        fn.restype = ctypes.c_int
    lib.path = path
    return lib


class Query:
    """``cusolverDnXsyevd_bufferSize`` at any n, on one handle."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib
        self.handle, self.params = ctypes.c_void_p(), ctypes.c_void_p()
        if lib.cusolverDnCreate(ctypes.byref(self.handle)) or \
                lib.cusolverDnCreateParams(ctypes.byref(self.params)):
            raise RuntimeError("cusolverDnCreate failed")
        # the pointers are only passed through: the query reads no matrix
        self.buf = torch.empty(16, device="cuda")

    def __call__(self, n: int, dtype: torch.dtype) -> dict:
        t = CUDA_R_32F if dtype == torch.float32 else CUDA_R_64F
        dev_b, host_b = ctypes.c_size_t(0), ctypes.c_size_t(0)
        ptr = ctypes.c_void_p(self.buf.data_ptr())
        status = self.lib.cusolverDnXsyevd_bufferSize(
            self.handle, self.params, CUSOLVER_EIG_MODE_VECTOR,
            CUBLAS_FILL_MODE_LOWER, n, t, ptr, n, t, ptr, t,
            ctypes.byref(dev_b), ctypes.byref(host_b))
        return {"n": n, "status": status, "device_bytes": dev_b.value,
                "host_bytes": host_b.value}


def bisect(query: Query, dtype: torch.dtype, hi: int = 1 << 17) -> dict:
    """The largest n in [1, hi) whose query returns success, assuming one
    edge (checked: 1 succeeds and ``hi`` fails)."""
    lo = 1
    if query(lo, dtype)["status"] or not query(hi, dtype)["status"]:
        raise RuntimeError(f"no single edge in [1, {hi}] for {dtype}")
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if query(mid, dtype)["status"] == 0:
            lo = mid
        else:
            hi = mid
    return {"dtype": str(dtype), "largest_ok": query(lo, dtype),
            "smallest_failing": query(hi, dtype)}


def kernel(n: int, seed: int, dtype: torch.dtype,
           block: int = 8192) -> torch.Tensor:
    """K = W·Wᵀ/p on the card, W standard normal n × 4n drawn a column
    block at a time from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    p = 4 * n
    K = torch.zeros((n, n), dtype=dtype, device="cuda")
    for c0 in range(0, p, block):
        W = torch.randn((n, min(block, p - c0)), generator=g, dtype=dtype,
                        device="cuda")
        K.addmm_(W, W.T, alpha=1.0 / p)
        del W
    return K


def run_eigh(n: int, seed: int, dtype: torch.dtype, library: str) -> dict:
    from eagleeverything_tpu_torch.models import engine_torch

    row = {"n": n, "dtype": str(dtype), "library": library}
    K = kernel(n, seed, dtype)
    torch.backends.cuda.preferred_linalg_library(library)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        d, U = torch.linalg.eigh(K)
        torch.cuda.synchronize()
    except (RuntimeError, torch.OutOfMemoryError) as e:
        # the measurement is whether the call works: its error is the result
        row.update(ok=False, error=f"{type(e).__name__}: {e}"[:600])
        return row
    finally:
        torch.backends.cuda.preferred_linalg_library("default")
    row.update(ok=True, seconds=time.perf_counter() - t0,
               peak_bytes=torch.cuda.max_memory_allocated())
    res, orth = engine_torch.eig_residuals(K, d, U)
    row.update(residual=res, orthogonality=orth,
               d_min=float(d[0]), d_max=float(d[-1]))
    return row


def limit_probes(rows: list, sizes: str, seed: int) -> None:
    """Parts 1 and 2: the query bisected, then torch.linalg.eigh."""
    lib = _cusolver()
    q = Query(lib)
    limits = {}
    for dtype in (torch.float32, torch.float64):
        b = bisect(q, dtype)
        _emit(rows, {"query": lib.path, **b})
        limits[dtype] = b
    edge = limits[torch.float32]["largest_ok"]["n"]
    for n in sorted({int(s) for s in sizes.split(",") if s}
                    | {edge, edge + 1}):
        _emit(rows, {"query": q(n, torch.float32), **run_eigh(
            n, seed, torch.float32, "cusolver")})
        torch.cuda.empty_cache()
    _emit(rows, run_eigh(edge + 1, seed, torch.float64, "cusolver"))
    torch.cuda.empty_cache()
    _emit(rows, run_eigh(edge + 1, seed, torch.float32, "magma"))


def _sum_sq(K: torch.Tensor, block: int = 4096) -> float:
    return sum(float(torch.sum(K[r0:r0 + block].double() ** 2))
               for r0 in range(0, K.shape[0], block))


def run_route(n: int, seed: int, leaf: int, leaves: list[int]) -> dict:
    """eigh_large at n (and its divide and conquer alone at ``leaves``)."""
    from eagleeverything_tpu_torch.models import engine_torch

    dev = torch.device("cuda")
    row = {"n": n, "leaf": leaf, "panel": engine_torch.EIGH_PANEL}
    K = kernel(n, seed, torch.float32)
    torch.cuda.synchronize()
    if leaves:
        A = K.clone()
        t0 = time.perf_counter()
        d, e, _ = engine_torch._tridiagonalize(A, engine_torch.EIGH_PANEL)
        dh, eh = d.double().cpu().numpy(), e.double().cpu().numpy()
        row["tridiagonal_alone_s"] = time.perf_counter() - t0
        del A
        row["divide_conquer_alone_s"] = {}
        for lf in leaves:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, Q = engine_torch._tridiag_eigh(dh, eh, lf, dev)
            torch.cuda.synchronize()
            row["divide_conquer_alone_s"][lf] = time.perf_counter() - t0
            del Q
            torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stats: dict = {}
    t0 = time.perf_counter()
    d, U = engine_torch.eigh_large(K.clone(), leaf, stats=stats)
    torch.cuda.synchronize()
    row.update(stats, seconds=time.perf_counter() - t0,
               peak_squares=(torch.cuda.max_memory_allocated() - base)
               / (4.0 * n * n))
    row["residual"], row["orthogonality"] = engine_torch.eig_residuals(
        K, d, U)
    tr, fro2 = float(torch.sum(K.diagonal().double())), _sum_sq(K)
    row["trace_rel"] = abs(float(torch.sum(d)) - tr) / tr
    row["frobenius_rel"] = abs(float(torch.sum(d * d)) - fro2) / fro2
    row.update(d_min=float(d[0]), d_max=float(d[-1]))
    del U
    torch.cuda.empty_cache()
    if n <= engine_torch.DEVICE_EIGH_MAX_N:
        t0 = time.perf_counter()
        dl, Ul = torch.linalg.eigh(K)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        res, orth = engine_torch.eig_residuals(K, dl, Ul)
        row["cusolver"] = {
            "seconds": secs, "residual": res, "orthogonality": orth,
            "d_gap": float(torch.max(torch.abs(dl.double() - d)))
            / float(d[-1])}
    return row


def _cublas_symv():
    """cuBLAS's ssymv (lower triangle only) on torch's current handle and
    stream, through ctypes: y = A·x for a symmetric A, reading half of
    it."""
    torch.mv(torch.ones(2, 2, device="cuda"), torch.ones(2, device="cuda"))
    with open("/proc/self/maps") as f:
        paths = sorted({line.split()[-1] for line in f
                        if "libcublas.so" in line and "Lt" not in line})
    lib = ctypes.CDLL(paths[0])
    fn = lib.cublasSsymv_v2
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_float), ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_float), ctypes.c_void_p,
                   ctypes.c_int]
    fn.restype = ctypes.c_int
    one, zero = ctypes.c_float(1.0), ctypes.c_float(0.0)

    def symv(B: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        y = torch.empty_like(v)
        status = fn(torch.cuda.current_blas_handle(), CUBLAS_FILL_MODE_LOWER,
                    B.shape[0], ctypes.byref(one), B.data_ptr(), B.stride(0),
                    v.data_ptr(), 1, ctypes.byref(zero), y.data_ptr(), 1)
        if status:
            raise RuntimeError(f"cublasSsymv_v2 returned {status}")
        return y
    return symv


def run_gemv(n: int, seed: int) -> dict:
    """Part 4: the trailing block's product with a vector, as stage (a)
    runs it (A[j:, j:] of the row-major n × n matrix, row stride n)."""
    A = torch.randn((n, n), device="cuda")
    A = A + A.T
    row = {"n": n}
    for m in (n, n // 2, n // 4):
        j = n - m
        B = A[j:, j:]
        v = torch.randn(m, device="cuda")
        P = torch.randn((64, m), device="cuda")
        symv = _cublas_symv()
        ref = torch.mv(B, v)
        got = symv(B, v)
        row_err = float(torch.max(torch.abs(got - ref))
                        / torch.max(torch.abs(ref)))
        c = torch.randn(64, device="cuda")
        forms = {"mv": lambda: torch.mv(B, v), "vT_A": lambda: v @ B,
                 "mv_rows_8192": lambda: torch.cat(
                     [torch.mv(B[r:r + 8192], v) for r in range(0, m, 8192)]),
                 "panel_P_v": lambda: P @ v,
                 "panel_P_v_sum": lambda: torch.sum(P * v, dim=1),
                 "panel_PT_c": lambda: P.T @ c,
                 "symv_lower": lambda: symv(B, v)}
        got = {}
        for name, fn in forms.items():
            fn()
            times = []
            for _ in range(5):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                torch.cuda.synchronize()
                times.append(a.elapsed_time(b))
            got[name] = sorted(times)[2]
        got["bound_ms"] = 4.0 * m * m / 3.35e12 * 1e3
        got["symv_rel_err"] = row_err
        row[str(m)] = got
    return row


def run_trace(n: int, seed: int) -> dict:
    """Part 5: stage (a) at n under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from eagleeverything_tpu_torch.models import engine_torch

    A = kernel(n, seed, torch.float32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine_torch._tridiagonalize(A, engine_torch.EIGH_PANEL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    rows = sorted(({"op": e.key, "calls": e.count,
                    "device_ms": e.device_time_total / 1e3,
                    "cpu_ms": e.cpu_time_total / 1e3} for e in ka),
                  key=lambda r: -r["device_ms"])
    print(ka.table(sort_by="device_time_total", row_limit=25), flush=True)
    return {"n": n, "trace_wall_s": wall, "ops": rows[:25]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--no-limit", action="store_true",
                    help="skip the bisection and the library probes")
    ap.add_argument("--route", default="")
    ap.add_argument("--leaf", type=int, default=0,
                    help="eigh_large's leaves (default: the engine's)")
    ap.add_argument("--leaves", default="")
    ap.add_argument("--gemv", type=int, default=0)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "eigh_limit.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("this script needs a CUDA device")
    from eagleeverything_tpu_torch.models import engine_torch
    engine_torch._ieee_fp32()
    rows: list = []
    _emit(rows, {"device": torch.cuda.get_device_name(0),
                 "torch": torch.__version__, "cuda": torch.version.cuda,
                 "has_magma": bool(torch.cuda.has_magma)})
    if not args.no_limit:
        limit_probes(rows, args.sizes, args.seed)
    route = [int(s) for s in args.route.split(",") if s]
    leaves = [int(s) for s in args.leaves.split(",") if s]
    leaf = args.leaf or min(engine_torch.DEVICE_EIGH_MAX_N,
                            engine_torch.EIGH_LEAF_N)
    if args.gemv:
        _emit(rows, run_gemv(args.gemv, args.seed))
    if args.trace:
        _emit(rows, run_trace(args.trace, args.seed))
    for n in route:
        _emit(rows, run_route(n, args.seed, leaf,
                              leaves if n == max(route) else []))
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
