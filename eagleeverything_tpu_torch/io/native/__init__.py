"""ctypes bindings for the native ingest library (ingest.cpp).

The library is compiled with ``g++`` at first use into ``build/torch_native/``
at the root of the checkout, named by a hash of its source and flags, so an
edited source is rebuilt and an unchanged one reused. The build writes a
name of its own and renames it into place, so processes that race to build
it are safe. Every consumer falls back to the pure-Python parsers when the
toolchain or the library is unavailable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "ingest.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_native"
_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


# the ThreadSanitizer build of the same source (tsan_check.py runs it)
_TSAN_FLAGS = ("-O1", "-g", "-std=c++17", "-fPIC", "-pthread",
               "-fsanitize=thread", "-shared")


def lib_path(flags: tuple[str, ...] = _FLAGS, stem: str = "libeagleingest"
             ) -> Path:
    """Where the library of the current source is (or will be) built."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:12]}.so"


def _compile(out: Path, flags: tuple[str, ...]) -> None:
    """g++ ``flags`` on the source into ``out``, through a name of this
    process's own; raises on failure with the compiler's output."""
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *flags, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def _build(out: Path) -> bool:
    try:
        _compile(out, _FLAGS)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def build_tsan() -> Path:
    """The ThreadSanitizer-instrumented library of the current source
    (``-O1 -g -fsanitize=thread``), built into ``build/torch_native/`` if
    it is not there; raises when g++ fails."""
    out = lib_path(_TSAN_FLAGS, "libeagleingest_tsan")
    if not out.exists():
        _compile(out, _TSAN_FLAGS)
    return out


def tsan_runtime() -> Optional[str]:
    """g++'s ``libtsan.so``, which must be preloaded into an uninstrumented
    interpreter that loads the instrumented library; None when g++ has
    none."""
    try:
        out = subprocess.run(["g++", "-print-file-name=libtsan.so"],
                             check=True, capture_output=True, text=True,
                             timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out if os.path.isabs(out) and os.path.exists(out) else None


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        so = lib_path()
        if not so.exists() and not _build(so):
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            _lib_failed = True
            return None
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
        lib.ee_ascii_close.restype = None
        lib.ee_ascii_close.argtypes = [ctypes.c_void_p]
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
        lib.ee_vcf_close.restype = None
        lib.ee_vcf_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def iter_ascii_blocks_native(
    path: str, AA: str, AB: str, BB: str, missing: str,
    block_rows: int = 4096,
) -> Optional[Iterator[np.ndarray]]:
    """Native streamed ASCII recode; None if the library is unavailable or
    the codes don't fit the native fast path (multi-char no-space codes)."""
    lib = get_lib()
    if lib is None:
        return None

    n_rows = ctypes.c_int64()
    n_cols = ctypes.c_int64()
    nospace = ctypes.c_int()
    handle = lib.ee_ascii_open(
        path.encode(), AA.encode(), AB.encode(), BB.encode(),
        missing.encode(), ctypes.byref(n_rows), ctypes.byref(n_cols),
        ctypes.byref(nospace),
    )
    if not handle:
        raise ValueError(f"empty or unreadable genotype file: {path}")
    if nospace.value and not (len(AA) == len(AB) == len(BB) == 1):
        # native LUT path needs single-char codes; caller falls back
        lib.ee_ascii_close(handle)
        return None

    def gen():
        p = n_cols.value
        try:
            while True:
                buf = np.empty((block_rows, p), dtype=np.int8)
                got = lib.ee_ascii_next(handle, buf, block_rows)
                if got < 0:
                    raise ValueError(
                        f"unrecognized genotype token at data row "
                        f"{-got} of a block in {path}"
                    )
                if got == 0:
                    break
                yield buf[:got]
        finally:
            lib.ee_ascii_close(handle)

    return gen()


_VCF_CHROM_W, _VCF_ID_W = 64, 128  # ingest.cpp kChromW / kIdW


def iter_vcf_blocks_native(
    path: str, block_snps: int = 4096
) -> Optional[Iterator[tuple]]:
    """Native streamed VCF GT scan (multithreaded mmap'd recode); yields
    the same ``(geno [n × b], names, chroms, pos)`` tuples as the Python
    ``parsers.iter_vcf_blocks``. None when the library is unavailable or
    the file lacks a #CHROM header (the Python parser then raises the
    descriptive error)."""
    lib = get_lib()
    if lib is None:
        return None
    # probe open/close to decide native-vs-fallback WITHOUT holding the
    # mmap + line index hostage to a generator that may never be iterated;
    # gen() reopens (one extra memchr pass over the mapping — negligible
    # next to the GT scan)
    n_samples = ctypes.c_int64()
    n_variants = ctypes.c_int64()
    probe = lib.ee_vcf_open(
        path.encode(), ctypes.byref(n_samples), ctypes.byref(n_variants)
    )
    if not probe:
        return None
    lib.ee_vcf_close(probe)

    def gen():
        n = n_samples.value
        handle = lib.ee_vcf_open(
            path.encode(), ctypes.byref(ctypes.c_int64()),
            ctypes.byref(ctypes.c_int64()),
        )
        if not handle:
            raise ValueError(f"VCF became unreadable between open and "
                             f"scan: {path}")
        try:
            while True:
                dose = np.empty((block_snps, n), dtype=np.int8)
                pos = np.empty(block_snps, dtype=np.int64)
                chrom = np.empty((block_snps, _VCF_CHROM_W), dtype=np.uint8)
                vid = np.empty((block_snps, _VCF_ID_W), dtype=np.uint8)
                got = lib.ee_vcf_next(handle, dose, pos, chrom, vid,
                                      block_snps)
                if got < 0:
                    raise ValueError(
                        f"malformed VCF record at data row {-got} of a "
                        f"block in {path} (bad GT/POS field, oversized "
                        f"CHROM/ID, or field-count mismatch)"
                    )
                if got == 0:
                    break
                chroms = [
                    bytes(chrom[r]).rstrip(b"\x00").decode()
                    for r in range(got)
                ]
                ids = [
                    bytes(vid[r]).rstrip(b"\x00").decode()
                    for r in range(got)
                ]
                poss = [int(x) for x in pos[:got]]
                names = [
                    ids[r] if ids[r] != "." else f"{chroms[r]}:{poss[r]}"
                    for r in range(got)
                ]
                yield dose[:got].T, names, chroms, poss
        finally:
            lib.ee_vcf_close(handle)

    return gen()


def vcf_dims_native(path: str) -> Optional[tuple[int, int]]:
    """(n_samples, n_variants) via the native header scan; None if
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n_samples = ctypes.c_int64()
    n_variants = ctypes.c_int64()
    handle = lib.ee_vcf_open(
        path.encode(), ctypes.byref(n_samples), ctypes.byref(n_variants)
    )
    if not handle:
        return None
    lib.ee_vcf_close(handle)
    return int(n_samples.value), int(n_variants.value)
