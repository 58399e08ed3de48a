"""ThreadSanitizer check of the native ingest's two threaded paths.

``python -m eagleeverything_tpu_torch.io.native.tsan_check`` builds the
instrumented library from ``ingest.cpp`` (``native.build_tsan``, into
``build/torch_native/``) and runs this file as a child interpreter under
``LD_PRELOAD`` of g++'s ``libtsan.so``, with four recode threads. The child
parses

- a generated multi-block ASCII genotype file through ``ee_ascii_open`` /
  ``ee_ascii_next`` (the threaded ``recode_rows``), and
- a generated multi-block VCF through ``ee_vcf_open`` / ``ee_vcf_next``
  (its threaded GT scan),

and holds both to the genotypes it wrote. The check fails on a wrong
dose, a nonzero exit or any ThreadSanitizer report. The child imports
only numpy and ctypes, so that nothing but the ingest runs under the
sanitizer.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

MISSING = -9                        # ingest.cpp kMissing
CHROM_W, ID_W = 64, 128             # ingest.cpp kChromW / kIdW
BLOCK = 128                         # rows a call: several blocks a file


def _ascii(lib: ctypes.CDLL, d: str) -> int:
    lib.ee_ascii_open.restype = ctypes.c_void_p
    lib.ee_ascii_open.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.ee_ascii_next.restype = ctypes.c_int64
    lib.ee_ascii_next.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS"),
        ctypes.c_int64,
    ]
    lib.ee_ascii_close.argtypes = [ctypes.c_void_p]

    rng = np.random.default_rng(0)
    n, p = 512, 400
    codes = np.array(["AA", "AB", "BB"])
    geno = rng.integers(0, 3, (n, p))
    path = os.path.join(d, "geno.txt")
    with open(path, "w") as f:
        for row in geno:
            f.write(" ".join(codes[row]) + "\n")
    nr, nc, ns = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int()
    h = lib.ee_ascii_open(path.encode(), b"AA", b"AB", b"BB", b"NA",
                          ctypes.byref(nr), ctypes.byref(nc),
                          ctypes.byref(ns))
    assert h and nr.value == n and nc.value == p
    rows = []
    while True:
        buf = np.empty((BLOCK, p), dtype=np.int8)
        got = lib.ee_ascii_next(h, buf, BLOCK)
        assert got >= 0, f"parse error {got}"
        if got == 0:
            break
        rows.append(buf[:got])
    lib.ee_ascii_close(h)
    out = np.concatenate(rows)
    assert np.array_equal(out, geno), "ASCII doses differ"
    return out.shape[0]


def _vcf(lib: ctypes.CDLL, d: str) -> int:
    lib.ee_vcf_open.restype = ctypes.c_void_p
    lib.ee_vcf_open.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.ee_vcf_next.restype = ctypes.c_int64
    lib.ee_vcf_next.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int64,
    ]
    lib.ee_vcf_close.argtypes = [ctypes.c_void_p]

    rng = np.random.default_rng(1)
    n, p = 300, 700
    dose = rng.integers(0, 3, (p, n)).astype(np.int8)
    dose[rng.random((p, n)) < 0.02] = MISSING
    gt = {0: "0/0", 1: "0/1", 2: "1/1", MISSING: "./."}
    path = os.path.join(d, "geno.vcf")
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(f"S{i}" for i in range(n)) + "\n")
        for j in range(p):
            f.write(f"1\t{1000 + j}\trs{j}\tA\tG\t.\tPASS\t.\tGT\t"
                    + "\t".join(gt[int(v)] for v in dose[j]) + "\n")
    ns, nv = ctypes.c_int64(), ctypes.c_int64()
    h = lib.ee_vcf_open(path.encode(), ctypes.byref(ns), ctypes.byref(nv))
    assert h and ns.value == n and nv.value == p
    rows, poss = [], []
    while True:
        buf = np.empty((BLOCK, n), dtype=np.int8)
        pos = np.empty(BLOCK, dtype=np.int64)
        chrom = np.empty((BLOCK, CHROM_W), dtype=np.uint8)
        vid = np.empty((BLOCK, ID_W), dtype=np.uint8)
        got = lib.ee_vcf_next(h, buf, pos, chrom, vid, BLOCK)
        assert got >= 0, f"malformed record {got}"
        if got == 0:
            break
        rows.append(buf[:got])
        poss.append(pos[:got])
    lib.ee_vcf_close(h)
    out = np.concatenate(rows)
    assert np.array_equal(out, dose), "VCF doses differ"
    assert np.array_equal(np.concatenate(poss), 1000 + np.arange(p))
    return out.shape[0]


def check(lib_file: str) -> int:
    """Parse both files with the library at ``lib_file`` (the child's
    work)."""
    lib = ctypes.CDLL(lib_file)
    with tempfile.TemporaryDirectory() as d:
        a = _ascii(lib, d)
        v = _vcf(lib, d)
    print(f"TSAN ingest check passed: {a} ASCII rows, {v} VCF variants",
          flush=True)
    return 0


def run(timeout: float = 300.0) -> subprocess.CompletedProcess:
    """Build the instrumented library and run the check in a child under
    ThreadSanitizer. Returns the finished child (its output in
    ``stdout``, stderr folded in); raises RuntimeError when g++ has no
    ``libtsan.so``."""
    from eagleeverything_tpu_torch.io import native
    runtime = native.tsan_runtime()
    if runtime is None:
        raise RuntimeError("g++ has no libtsan.so")
    lib = native.build_tsan()
    env = dict(os.environ, LD_PRELOAD=runtime, EE_NCPU="4",
               TSAN_OPTIONS="halt_on_error=1 exitcode=66")
    return subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", str(lib)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=timeout)


def passed(proc: subprocess.CompletedProcess) -> bool:
    """The child exited 0 and ThreadSanitizer reported nothing."""
    return proc.returncode == 0 and "ThreadSanitizer" not in proc.stdout


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        return check(sys.argv[2])
    proc = run()
    sys.stdout.write(proc.stdout)
    if not passed(proc):
        print(f"TSAN ingest check FAILED (rc {proc.returncode})",
              file=sys.stderr)
        return proc.returncode or 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
