"""The program's spans, as its scan log (``utils/logging.Phase``) records
them: each ``phase`` event that carries an ``id`` is a span, with its
``parent`` span's id (None for a call's root), its ``call`` id, its wall
(``wallclock_s``) and the seconds it waited on the card itself
(``wait_s``, its children's not counted). A log without these fields
(a program that records no span tree) gives no tree, and the readers
built on this module then read nothing."""

from __future__ import annotations

import dataclasses

import scanlog


@dataclasses.dataclass
class Span:
    name: str
    wall: float
    wait: float
    children: list = dataclasses.field(default_factory=list)

    @property
    def own(self) -> float:
        """Seconds of the span that no child of it names."""
        return self.wall - sum(c.wall for c in self.children)

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


def roots(events: list) -> list:
    """The root span of each call in one call's log, in log order."""
    by_call: dict = {}
    for e in events:
        if e.get("event") == "phase" and "id" in e and "call" in e:
            by_call.setdefault(e["call"], []).append(e)
    out = []
    for evs in by_call.values():
        spans = {e["id"]: Span(e["phase"], float(e["wallclock_s"]),
                               float(e.get("wait_s", 0.0))) for e in evs}
        for e in evs:           # a child's event precedes its parent's
            if e.get("parent") in spans:
                spans[e["parent"]].children.append(spans[e["id"]])
        out.extend(spans[e["id"]] for e in evs
                   if e.get("parent") not in spans)
    return out


def per_call(run, fn, kind: str = ""):
    """The mean over the window's calls (of engine ``kind``, when given)
    of ``fn(root span)``, over the calls whose value is not None; None
    when none has one."""
    vals = []
    for events in run.logs:
        if kind and scanlog.engine(events) != kind:
            continue
        for root in roots(events):
            v = fn(root)
            if v is not None:
                vals.append(v)
    return sum(vals) / len(vals) if vals else None


def per_span(run, name: str, fn, kind: str = ""):
    """The mean over every span ``name`` of the window's calls (of engine
    ``kind``, when given) of ``fn(span)``, over the spans whose value is
    not None; None when none has one."""
    vals = [fn(s) for events in run.logs
            if not kind or scanlog.engine(events) == kind
            for root in roots(events) for s in named(root, (name,))]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None


def named(root: Span, names) -> list:
    """The spans of the tree under ``root`` whose name is in ``names``."""
    return [s for s in root.walk() if s.name in names]
