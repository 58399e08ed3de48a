"""Structured scan logging / metrics (SURVEY.md §6.1, §6.5).

The reference logs via ``message()``/``cat`` gated by ``quiet``; the
rebuild makes the north-star metric (SNPs scored/sec/chip) first-class:
every scan iteration emits a structured record — candidate SNP, t_max,
extBIC, variance components, wall-clock, SNPs/s — as JSON lines to an
optional file plus human-readable console lines. One writer (host 0 in a
multi-host run).

Spans. :class:`Phase` times one step of a call and logs it as a ``phase``
event. Spans nest: each open span is the parent of the spans opened inside
it (a context-local stack), and code with no logger in reach opens a span
with ``Phase(None, name)``, which logs into the innermost open span's
logger (with none open it only reads the clock twice). Every span of one
logger shares its ``call`` id, one logger a call of ``am()`` /
``am_multi()``. The port's blocking host↔card copies go through
:func:`to_host`, :func:`to_device` and :func:`on_card`, which credit the
innermost open span with the seconds the host waited and the bytes moved,
so a span's wall splits into host work (``wallclock_s - wait_s`` less its
children) and waiting on the card. While ``torch.profiler`` (or
``emit_nvtx``) is recording, each span also opens a profiler range
``phase::<name>`` on the trace's clock. A span may carry counters of
the work it did, given when it opens or added inside it by :func:`count`;
they are fields of its ``phase`` event.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
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


# the innermost open span of this thread / task (None: no span open)
_OPEN: contextvars.ContextVar = contextvars.ContextVar("eagle_scan_span",
                                                       default=None)
_span_ids = itertools.count(1)
_call_ids = itertools.count(1)
# a span's place in the tree and its waits: in the JSON line, left out of
# the console line
_TREE_FIELDS = ("start_s", "id", "parent", "call", "wait_s", "h2d_bytes",
                "d2h_bytes")


class ScanLogger:
    def __init__(self, quiet: bool = True, jsonl_path: Optional[str] = None,
                 is_host0: bool = True):
        self.quiet = quiet
        self.is_host0 = is_host0
        self._fh: Optional[IO] = None
        if jsonl_path and is_host0:
            self._fh = open(jsonl_path, "a")
        self._t0 = time.perf_counter()
        # the id every span of this logger carries (one logger a call)
        self.call = f"{os.getpid()}-{next(_call_ids)}"

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
                for k, v in fields.items() if k not in _TREE_FIELDS
            )
            print(f"[{kind}] {msg}", file=sys.stderr)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


def _profiler_range(name: str):
    """An entered ``record_function("phase::<name>")`` while a profiler
    records, else None (no range is built)."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not getattr(prof, "_is_profiler_enabled", False):
        return None
    rng = prof.record_function(f"phase::{name}")
    rng.__enter__()
    return rng


class Phase:
    """Context manager timing one span of a call; emits its wall-clock,
    optional throughput (items/s), its start on the logger's clock, its
    ``id``, its ``parent`` span's id (None for a root), the ``call`` id,
    and the seconds and bytes of the host↔card copies it made itself
    (``wait_s``, ``h2d_bytes``, ``d2h_bytes``; a child's are the
    child's), and its ``counters``. ``logger`` None logs into the
    innermost open span's logger."""

    def __init__(self, logger: Optional[ScanLogger] = None, name: str = "",
                 items: Optional[int] = None, **counters):
        self.logger = logger
        self.name = name
        self.items = items
        self.counters = counters

    def __enter__(self):
        up = _OPEN.get()
        if self.logger is None and up is not None:
            self.logger = up.logger
        self._token = None
        if self.logger is not None:
            self.id = next(_span_ids)
            self.parent = (up.id if up is not None
                           and up.logger is self.logger else None)
            self.wait_s = 0.0
            self.h2d_bytes = self.d2h_bytes = 0
            self._token = _OPEN.set(self)
            self._trace = _profiler_range(self.name)
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._start
        if self._token is None:
            return False
        if self._trace is not None:
            self._trace.__exit__(*exc)
        _OPEN.reset(self._token)
        fields = {"phase": self.name, "wallclock_s": round(dt, 4)}
        if self.items is not None and dt > 0:
            fields["items_per_s"] = round(self.items / dt, 1)
        lg = self.logger
        fields.update(start_s=round(self._start - lg._t0, 6), id=self.id,
                      parent=self.parent, call=lg.call,
                      wait_s=round(min(self.wait_s, dt), 6),
                      h2d_bytes=self.h2d_bytes, d2h_bytes=self.d2h_bytes)
        fields.update(self.counters)
        lg.event("phase", **fields)
        return False


def on_card(fn, *args, h2d: int = 0, d2h: int = 0):
    """``fn(*args)``, a call in which the host blocks on the card (a copy,
    and the work queued before it); its seconds and ``h2d`` / ``d2h``
    bytes are credited to the innermost open span."""
    span = _OPEN.get()
    if span is None:
        return fn(*args)
    t0 = time.perf_counter()
    out = fn(*args)
    span.wait_s += time.perf_counter() - t0
    span.h2d_bytes += h2d
    span.d2h_bytes += d2h
    return out


def count(**counters) -> None:
    """Adds each of ``counters`` to the innermost open span's counter of
    its name (from 0)."""
    span = _OPEN.get()
    if span is None:
        return
    for k, v in counters.items():
        span.counters[k] = span.counters.get(k, 0) + v


def to_host(t):
    """``t.cpu().numpy()``: from a card, through :func:`on_card`."""
    if t.device.type == "cpu":
        return t.numpy()
    return on_card(t.cpu, d2h=t.numel() * t.element_size()).numpy()


def to_device(a, device):
    """The host array ``a`` as a contiguous f32 tensor on ``device``:
    converted on the host, as ``torch.as_tensor(a, dtype=float32,
    device=device)`` converts before its copy, then copied to a card
    through :func:`on_card`."""
    import numpy as np
    import torch

    t = torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)
    device = torch.device(device)
    if device.type == "cpu":
        return t
    return on_card(t.to, device, h2d=t.numel() * t.element_size())
