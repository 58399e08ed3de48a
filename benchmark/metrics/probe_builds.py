"""probe_builds: builds of the sweep's probe Krylov basis a call of the
matrix-free engine (the spans ``krylov_basis`` under the spans ``probes``,
one a sweep; a sweep that takes the cached basis builds none), mean over
the window's calls; None when the program records no ``probes`` span."""

import spans


def _builds(root):
    probes = spans.named(root, ("probes",))
    if not probes:
        return None
    return sum(len(spans.named(p, ("krylov_basis",))) for p in probes)


def read(run):
    return spans.per_call(run, _builds)
