"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Each ``.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``. The
libraries go to ``build/torch_kernels/`` at the root of the checkout, named
by a hash of their sources, each beside the ptxas report of its build, so an
edited source is rebuilt and an unchanged one is reused with its report. All sources compile in parallel, one ``nvcc`` each. Nothing
here runs at import time: the first call to :func:`load` builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("packed_dot", "packed_tdot")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "eagleeverything_tpu_torch build on a machine "
                           "with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def _log_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def build_all() -> dict[str, dict]:
    """Compile every source whose library or ptxas report is missing, all in
    parallel.

    Returns {name: {"seconds": wall of its nvcc (0.0 when reused),
    "reused": bool, "ptxas": nvcc's resource report of the build that made
    the library}}; raises with nvcc's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report: dict[str, dict] = {}
    procs = {}
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists() and _log_path(out).exists():
            report[name] = {"seconds": 0.0, "reused": True,
                            "ptxas": _log_path(out).read_text()}
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, out)
    for name, (proc, t0, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        _log_path(out).write_text(log)
        os.replace(tmp, out)
        report[name] = {"seconds": seconds, "reused": False, "ptxas": log}
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    err = getattr(lib, f"ee_{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib
