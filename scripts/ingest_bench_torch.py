#!/usr/bin/env python
"""Multi-GB ingest throughput benchmark on the PyTorch/CUDA port
(eagleeverything_tpu_torch): the port of scripts/ingest_bench.py.

Generates a synthetic VCF and/or no-space ASCII genotype file of the
requested size (the JAX script's generators, byte for byte for a seed),
then measures the port's ``read_marker`` end to end: parse + recode +
2-bit pack + sharded store write, through the port's native C++ layer
(io/native/ingest.cpp, built into build/torch_native/: mmap + threaded
recode), with the pure-Python parsers via ``--python`` for comparison.
This is host work: no card is used. One JSON line a result, under the
JAX script's keys, then ``{"results": [...]}``.

Usage: python scripts/ingest_bench_torch.py [--gb 2.0]
       [--format vcf|ascii|both] [--n 2000] [--python] [--dir DIR] [--keep]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def gen_vcf(path: str, n: int, p: int, seed: int = 0,
            chunk: int = 2048) -> None:
    """Fixed-width GT fields written via numpy byte-matrix tobytes() —
    generates ~100 MB/s so multi-GB inputs are practical to synthesize."""
    rng = np.random.default_rng(seed)
    codes = np.array([b"\t0/0", b"\t0/1", b"\t1/1"], dtype="S4")
    t0 = time.perf_counter()
    with open(path, "wb", buffering=1 << 22) as f:
        f.write(b"##fileformat=VCFv4.2\n")
        f.write(b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT")
        for i in range(n):
            f.write(f"\tind{i:06d}".encode())
        f.write(b"\n")
        for j0 in range(0, p, chunk):
            b = min(chunk, p - j0)
            maf = rng.uniform(0.05, 0.5, size=(b, 1))
            u = rng.random(size=(b, n))
            g = ((u < maf**2) * 2
                 + ((u >= maf**2) & (u < maf**2 + 2 * maf * (1 - maf))))
            gt = codes[g.astype(np.int8)]          # (b, n) S4
            for r in range(b):
                j = j0 + r
                f.write(f"1\t{1000 + j}\tsnp{j:07d}\tA\tC\t.\tPASS\t.\tGT"
                        .encode())
                f.write(gt[r].tobytes())
                f.write(b"\n")
    print(f"[gen] vcf {os.path.getsize(path) / 1e9:.2f} GB in "
          f"{time.perf_counter() - t0:.0f}s", flush=True)


def gen_ascii(path: str, n: int, p: int, seed: int = 0) -> None:
    """No-space single-char coding (reference ASCII format), one row per
    individual — n rows of p chars."""
    rng = np.random.default_rng(seed)
    codes = np.array([b"0", b"1", b"2"], dtype="S1")
    t0 = time.perf_counter()
    with open(path, "wb", buffering=1 << 22) as f:
        for i in range(n):
            g = rng.integers(0, 3, size=p, dtype=np.int8)
            f.write(codes[g].tobytes())
            f.write(b"\n")
    print(f"[gen] ascii {os.path.getsize(path) / 1e9:.2f} GB in "
          f"{time.perf_counter() - t0:.0f}s", flush=True)


def bench_one(path: str, type_: str, store: str, use_python: bool) -> dict:
    from eagleeverything_tpu_torch.api.read import read_marker
    from eagleeverything_tpu_torch.io import native

    # force the pure-Python parsers by marking the native lib unavailable
    native._lib, native._lib_failed = None, bool(use_python)
    if not use_python and native.get_lib() is None:
        raise RuntimeError("the native ingest library did not build")
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    h = read_marker(path, type=type_, AA="0", AB="1", BB="2",
                    store_dir=store, packed=True, n_shards=8)
    wall = time.perf_counter() - t0
    store_bytes = sum(os.path.getsize(os.path.join(store, f))
                      for f in os.listdir(store))
    return {
        "format": type_, "input_gb": round(size / 1e9, 3),
        "n": h.n, "p": h.p, "wall_s": round(wall, 1),
        "mb_per_s": round(size / 1e6 / wall, 1),
        "snps_per_s": round(h.p / wall, 1),
        "store_gb": round(store_bytes / 1e9, 3),
        "parser": "python" if use_python else "native",
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gb", type=float, default=2.0)
    ap.add_argument("--format", default="both",
                    choices=["vcf", "ascii", "both"])
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--python", action="store_true",
                    help="also measure the pure-Python fallback on a "
                         "1/20-size slice")
    ap.add_argument("--dir", default=None)
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args()

    tmp = args.dir or tempfile.mkdtemp(prefix="eagle_ingest_bench_")
    os.makedirs(tmp, exist_ok=True)
    results = []
    try:
        if args.format in ("vcf", "both"):
            # bytes/SNP-line ≈ 4n + ~40 → p for the target size
            p = int(args.gb * 1e9 / (4 * args.n + 40))
            path = os.path.join(tmp, "bench.vcf")
            if not os.path.exists(path):
                gen_vcf(path, args.n, p)
            results.append(bench_one(path, "vcf",
                                     os.path.join(tmp, "store_vcf"), False))
            print(json.dumps(results[-1]), flush=True)
            if args.python:
                pp = max(p // 20, 1000)
                small = os.path.join(tmp, "small.vcf")
                gen_vcf(small, args.n, pp)
                results.append(bench_one(
                    small, "vcf", os.path.join(tmp, "store_vcf_py"), True))
                print(json.dumps(results[-1]), flush=True)
        if args.format in ("ascii", "both"):
            p = int(args.gb * 1e9 / args.n)
            path = os.path.join(tmp, "bench.txt")
            if not os.path.exists(path):
                gen_ascii(path, args.n, p)
            results.append(bench_one(path, "text",
                                     os.path.join(tmp, "store_txt"), False))
            print(json.dumps(results[-1]), flush=True)
        print(json.dumps({"results": results}))
    finally:
        if not args.keep:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
