"""Reading the program's scan log (``utils/logging.ScanLogger``): one list
of events a call of the window."""


def phases(events: list) -> dict:
    """{phase: [wall s, ...]} of one call."""
    out: dict = {}
    for e in events:
        if e.get("event") == "phase":
            out.setdefault(e["phase"], []).append(float(e["wallclock_s"]))
    return out


def engine(events: list) -> str:
    """"matfree" when the call ran the matrix-free engine (its log has a
    ``context`` phase), "exact" when it ran the eigenbasis engine (``mmt``
    or ``eigh``), else ""."""
    ph = phases(events)
    if "context" in ph:
        return "matfree"
    if "mmt" in ph or "eigh" in ph:
        return "exact"
    return ""


def per_call(run, kind: str, fn):
    """The mean over the window's calls of ``fn(phases of a call)``, over
    the calls that ran engine ``kind``; None when none did."""
    vals = [fn(phases(ev)) for ev in run.logs if engine(ev) == kind]
    return sum(vals) / len(vals) if vals else None


def per_phase(run, kind: str, name: str):
    """The mean wall of phase ``name`` over every time a call of engine
    ``kind`` ran it; None when none did."""
    vals = [s for ev in run.logs if engine(ev) == kind
            for s in phases(ev).get(name, [])]
    return sum(vals) / len(vals) if vals else None
