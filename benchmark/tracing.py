"""The device trace of a window: ``torch.profiler`` (CPU and CUDA activity)
over the whole window, read back from its Chrome trace.

The reading follows ``trace_summary`` of ``chip_smoke.py:614``: the union
of the device's kernel, copy and set intervals against the traced window,
and the idle stretches between them. Beside it: the device time of the
kernels launched inside each ``bench::`` range (a launch is matched to its
kernel by the trace's correlation id), and for each idle stretch what the
host was doing, named by the scan-log phase and the innermost host
operation open at its middle.
"""

from __future__ import annotations

import bisect
import json
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


class Window:
    """Profiles the ``with`` block; ``wall_s`` is the block's host wall
    between two synchronisations, which carries the profiler's own cost."""

    def __init__(self, torch, path: str):
        from torch.profiler import ProfilerActivity, profile
        self.torch, self.path = torch, path
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.wall_s = None

    def __enter__(self):
        self.torch.cuda.synchronize()
        self.prof.start()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.stop()
        self.prof.export_chrome_trace(self.path)
        return False


def _union(spans):
    """Busy seconds·1e6 of sorted (start, end) spans, and the gaps between
    them as (start, end)."""
    busy, gaps = 0.0, []
    lo, hi = spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            gaps.append((hi, a))
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    return busy, gaps


def summarize(path: str, wall_s: float, top: int = 10) -> dict:
    """{busy_s, window_s, range_device_s: {range: s}, device_ops: [[name,
    s]], idle_gaps: [[what the host did, s]]}; busy_s is None when the
    trace holds no device activity."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    dev, launches, ranges, host = [], {}, {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = float(e["ts"])
        if cat in HOST_CATS:
            host.append(e)
            name = e.get("name", "")
            if name.startswith("bench::"):
                ranges.setdefault(name[7:], []).append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    out = {"busy_s": None, "window_s": wall_s, "range_device_s": {},
           "device_ops": [], "idle_gaps": []}
    if not dev:
        return out
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev)
    busy_us, gaps = _union(spans)
    out["busy_s"] = busy_us / 1e6

    by_name: dict = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    out["device_ops"] = [[k[:160], us / 1e6] for k, us in
                         sorted(by_name.items(), key=lambda t: -t[1])[:top]]

    for name, spans_r in ranges.items():
        spans_r.sort()
        starts = [a for a, _ in spans_r]
        us = 0.0
        for e in dev:
            at = launches.get(e.get("args", {}).get("correlation"))
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and spans_r[i][0] <= at <= spans_r[i][1]:
                us += float(e["dur"])
        out["range_device_s"][name] = us / 1e6

    out["idle_gaps"] = _name_gaps(gaps, host, top)
    return out


def _name_gaps(gaps, host, top: int) -> list:
    """Idle stretches over 1 ms, summed by what the host was doing at each
    one's middle: the innermost ``phase::`` range and the innermost host
    operation open there (``python`` where none is)."""
    phases = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"][7:]) for e in host
                    if e["name"].startswith("phase::"))
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["name"]) for e in host
                 if not e["name"].startswith(("phase::", "bench::")))
    op_starts = [a for a, _, _ in ops]
    totals: dict = {}
    for a, b in gaps:
        if b - a <= 1000.0:
            continue
        mid = 0.5 * (a + b)
        phase = next((nm for s, t, nm in reversed(phases) if s <= mid <= t),
                     "outside a phase")
        what = "python"
        # the innermost open op: the latest-starting one that covers mid
        i = bisect.bisect_right(op_starts, mid) - 1
        for s, t, nm in reversed(ops[max(0, i - 64): i + 1]):
            if s <= mid <= t:
                what = nm
                break
        key = f"{phase}/{what}"
        totals[key] = totals.get(key, 0.0) + (b - a)
    return [[k, us / 1e6] for k, us in
            sorted(totals.items(), key=lambda t: -t[1])[:top]]
