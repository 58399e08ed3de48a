"""Wrappers around the program's operations for the length of a window.

:class:`Calls` follows ``LaunchRecorder`` of ``chip_smoke.py:491``: each
named attribute (a module function such as ``packed.packed_dot``, which the
program looks up through its module at call time) is replaced by a wrapper
that calls the original, then tells each listener the call's arguments and
result, and is restored on exit. It launches nothing of its own, so the
program's launches stay the program's. With ``ranges`` each call also runs
inside a profiler range named ``bench::<name>``, so that a device trace can
give the time of the kernels it launched.
"""

from __future__ import annotations

import contextlib


class Calls:
    def __init__(self, targets: dict, listeners=(), ranges: bool = False):
        self.targets = targets      # name → (object, attribute)
        self.listeners = list(listeners)
        self.ranges = ranges
        self._saved = []

    def __enter__(self):
        for name, (obj, attr) in self.targets.items():
            fn = getattr(obj, attr)
            self._saved.append((obj, attr, fn))
            setattr(obj, attr, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        listeners = self.listeners
        if self.ranges:
            from torch.profiler import record_function
            label = f"bench::{name}"
        else:
            label = None

        def call(*args, **kwargs):
            with (record_function(label) if label
                  else contextlib.nullcontext()):
                out = fn(*args, **kwargs)
            for listen in listeners:
                listen(name, args, out)
            return out
        return call

    def __exit__(self, *exc):
        for obj, attr, fn in reversed(self._saved):
            setattr(obj, attr, fn)
        self._saved.clear()
        return False


class Shapes:
    """A listener that keeps the operand shapes of every call, by name, as
    the per-layer readers need them: the packed-stack kernels' (p, n, r,
    nw), the exact engine's products' (tile, n, m)."""

    def __init__(self):
        self.calls: dict[str, list[tuple]] = {}

    def __call__(self, name, args, out):
        if name in ("packed_dot", "packed_tdot"):
            Wp, X, _, n = args[:4]
            shape = (Wp.shape[0], int(n), X.shape[1], Wp.shape[1])
        elif name == "mmt_accumulate":
            K, Wt = args[:2]
            shape = (Wt.shape[0], Wt.shape[1], K.shape[1])
        elif name == "eig_T_tile":
            Wt, U = args[:2]
            shape = (Wt.shape[0], Wt.shape[1], U.shape[1])
        else:
            return
        self.calls.setdefault(name, []).append(shape)


class PhaseRanges:
    """For the length of a ``with`` block, opens a profiler range
    ``phase::<name>`` around each phase of the program's scan log, so that
    a device trace can say in which phase the device sat idle. The program
    looks ``Phase`` up in ``utils.logging`` each time it runs a scan."""

    def __init__(self):
        from eagleeverything_tpu_torch.utils import logging as scan_logging
        self.module = scan_logging
        self._saved = None

    def __enter__(self):
        from torch.profiler import record_function
        base = self._saved = self.module.Phase

        class Ranged(base):
            def __enter__(self):
                self._range = record_function(f"phase::{self.name}")
                self._range.__enter__()
                return super().__enter__()

            def __exit__(self, *exc):
                out = super().__exit__(*exc)
                self._range.__exit__(*exc)
                return out

        self.module.Phase = Ranged
        return self

    def __exit__(self, *exc):
        self.module.Phase = self._saved
        return False
