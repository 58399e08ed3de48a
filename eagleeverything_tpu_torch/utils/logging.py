"""Structured scan logging / metrics (SURVEY.md §6.1, §6.5).

The reference logs via ``message()``/``cat`` gated by ``quiet``; the
rebuild makes the north-star metric (SNPs scored/sec/chip) first-class:
every scan iteration emits a structured record — candidate SNP, t_max,
extBIC, variance components, wall-clock, SNPs/s — as JSON lines to an
optional file plus human-readable console lines. One writer (host 0 in a
multi-host run).
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional


def _jsonable(v):
    """json.dumps fallback: numpy scalars/arrays → native Python.

    numpy 2.x bools/floats leak into event fields easily (e.g. a bare
    ``a < b`` comparison of np.float64 is np.bool_, which json rejects);
    a 50k×1M scan must not die on a log line (it did, r3)."""
    import numpy as np

    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return str(v)


class ScanLogger:
    def __init__(self, quiet: bool = True, jsonl_path: Optional[str] = None,
                 is_host0: bool = True):
        self.quiet = quiet
        self.is_host0 = is_host0
        self._fh: Optional[IO] = None
        if jsonl_path and is_host0:
            self._fh = open(jsonl_path, "a")
        self._t0 = time.perf_counter()

    def event(self, kind: str, **fields) -> None:
        if not self.is_host0:
            return
        rec = {"event": kind, "elapsed_s": round(time.perf_counter() - self._t0, 4)}
        rec.update(fields)
        if self._fh:
            self._fh.write(json.dumps(rec, default=_jsonable) + "\n")
            self._fh.flush()
        if not self.quiet:
            msg = " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in fields.items()
            )
            print(f"[{kind}] {msg}", file=sys.stderr)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


class Phase:
    """Context manager timing one phase; emits wall-clock and optional
    throughput (items/s) to the logger."""

    def __init__(self, logger: ScanLogger, name: str, items: Optional[int] = None):
        self.logger = logger
        self.name = name
        self.items = items

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._start
        fields = {"phase": self.name, "wallclock_s": round(dt, 4)}
        if self.items is not None and dt > 0:
            fields["items_per_s"] = round(self.items / dt, 1)
        self.logger.event("phase", **fields)
        return False
