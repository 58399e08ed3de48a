"""Scan-state checkpoint / resume (SURVEY.md §6.3, §6.4).

The reference's durable artifact is the packed genotype binary (mirrored by
io/genostore); per-run state is tiny — the selected-SNP list, extBIC
trajectory, REML state — kilobytes. The rebuild checkpoints it at every
iteration boundary so an N-host biobank scan that loses a host restarts
from the last accepted marker instead of from zero. Plus a cached MMt:
the n×n kernel is iteration- and permutation-invariant, so it is persisted
keyed by the genotype source and reused across AM / FPR4AM runs.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np

_STATE = "scan_state.json"


def save_scan_state(
    ckpt_dir: str,
    selected: list[int],
    extbic_path: list[float],
    loglik_path: list[float],
    delta: float,
    sigma2_g: float,
    sigma2_e: float,
    meta: Optional[dict] = None,
) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    state = {
        "version": 1,
        "selected": [int(j) for j in selected],
        "extbic_path": [float(v) for v in extbic_path],
        "loglik_path": [float(v) for v in loglik_path],
        "delta": float(delta),
        "sigma2_g": float(sigma2_g),
        "sigma2_e": float(sigma2_e),
        "meta": meta or {},
    }
    tmp = os.path.join(ckpt_dir, f"{_STATE}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(state, f, indent=1)
    # atomic, and race-safe under concurrent SPMD writers: each host uses
    # its OWN tmp name (contents are bit-identical; last replace wins)
    os.replace(tmp, os.path.join(ckpt_dir, _STATE))


def load_scan_state(ckpt_dir: str) -> Optional[dict]:
    path = os.path.join(ckpt_dir, _STATE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


_MSTATE = "multi_scan_state.json"


def save_multi_scan_state(ckpt_dir: str, states: list[dict],
                          meta: Optional[dict] = None) -> None:
    """Multi-trait scan checkpoint: one atomic file holding every
    trait's state (selected/extbic_path/loglik_path/delta/sigma2_g/
    sigma2_e/active + a per-trait fingerprint inside each entry).
    The lockstep loop resumes every trait from the same iteration
    boundary, so one file keeps the traits mutually consistent
    (SURVEY.md §6.3/§6.4; VERDICT r4 item 3)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {"version": 1, "states": states, "meta": meta or {}}
    tmp = os.path.join(ckpt_dir, f"{_MSTATE}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, os.path.join(ckpt_dir, _MSTATE))


def load_multi_scan_state(ckpt_dir: str) -> Optional[dict]:
    path = os.path.join(ckpt_dir, _MSTATE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def clear_scan_state(ckpt_dir: str) -> None:
    path = os.path.join(ckpt_dir, _STATE)
    if os.path.exists(path):
        os.remove(path)


# ---------------------------------------------------------------------------
# MMt cache (SURVEY.md §6.4: "MMt is cheap to persist and permutation/
# iteration-invariant — cache it keyed by the genotype-store hash")
# ---------------------------------------------------------------------------


def mmt_cache_key(source: str, n: int, p: int,
                  keep: Optional[np.ndarray],
                  content_token: str = "") -> str:
    h = hashlib.sha256()
    h.update(f"{source}|{n}|{p}|{content_token}".encode())
    if keep is not None:
        h.update(np.ascontiguousarray(keep).tobytes())
    return h.hexdigest()[:24]


def genotype_content_token(handle) -> str:
    """Cheap content fingerprint of a genotype handle, so the MMt cache
    cannot serve a kernel computed from different data that happens to
    share a source label and shape.

    - in-memory arrays: full sha256 up to 64 MB, else a strided 1 MB
      sample plus the exact byte count;
    - store-backed: manifest bytes + per-shard (size, mtime).
    """
    h = hashlib.sha256()
    if getattr(handle, "geno", None) is not None:
        arr = np.ascontiguousarray(handle.geno, dtype=np.int8)
        buf = arr.reshape(-1).view(np.uint8)
        if buf.nbytes <= 64_000_000:
            h.update(buf.tobytes())
        else:
            stride = max(1, buf.nbytes // 1_000_000)
            h.update(buf[::stride].tobytes())
            h.update(str(buf.nbytes).encode())
    elif getattr(handle, "store_dir", None) is not None:
        d = handle.store_dir
        try:
            with open(os.path.join(d, "manifest.json"), "rb") as f:
                h.update(f.read())
            for name in sorted(os.listdir(d)):
                if name.endswith(".bin"):
                    st = os.stat(os.path.join(d, name))
                    h.update(f"{name}:{st.st_size}:{st.st_mtime_ns}".encode())
        except OSError:
            return ""  # unreadable → no caching benefit, disable keying
    return h.hexdigest()[:16]


def save_mmt(ckpt_dir: str, key: str, K_raw: np.ndarray) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"mmt_{key}.npy.tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        np.save(f, K_raw)  # file handle: avoids np.save's .npy suffixing
    os.replace(tmp, os.path.join(ckpt_dir, f"mmt_{key}.npy"))


def load_mmt(ckpt_dir: str, key: str) -> Optional[np.ndarray]:
    path = os.path.join(ckpt_dir, f"mmt_{key}.npy")
    if not os.path.exists(path):
        return None
    return np.load(path)


def save_eig(ckpt_dir: str, key: str, d: np.ndarray, U: np.ndarray) -> None:
    """Cache the eigendecomposition of the (normalized) kernel — like MMt
    it is iteration- and permutation-invariant."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"eig_{key}.npz.tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        np.savez(f, d=d, U=U)
    os.replace(tmp, os.path.join(ckpt_dir, f"eig_{key}.npz"))


def load_eig(ckpt_dir: str, key: str):
    path = os.path.join(ckpt_dir, f"eig_{key}.npz")
    if not os.path.exists(path):
        return None
    z = np.load(path)
    return z["d"], z["U"]
