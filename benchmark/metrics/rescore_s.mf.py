"""rescore_s.mf: seconds of one sweep of the matrix-free engine spent
rescoring its candidates exactly (the shortlist, ``rescore``, and the
escalation rounds, ``escalate``: the columns read from the source and
their CG solves), mean over every sweep of the window."""

import spans

RESCORE = ("rescore", "escalate")


def _rescore(sweep):
    parts = [c for c in sweep.children if c.name in RESCORE]
    return sum(c.wall for c in parts) if parts else None


def read(run):
    return spans.per_span(run, "sweep", _rescore, kind="matfree")
