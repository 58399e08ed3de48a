"""stack_passes: full passes over the packed stack a call (the scan log's
``stack_passes`` event), mean over the window's calls."""


def read(run):
    vals = [e["total"] for ev in run.logs for e in ev
            if e.get("event") == "stack_passes"]
    return sum(vals) / len(vals) if vals else None
