"""The reader of ``probe_builds`` (``benchmark/metrics/probe_builds.py``)
on synthetic span trees: builds of the sweep's probe basis a call."""

import pytest

import harness
import tiny


def _read(name, run):
    path = harness.reader_path(tiny.BENCH, name)
    return harness._module(path, "metric reader").read(run)


def _sweeps(builds):
    """One call's span tree: a sweep a list entry, each with a ``probes``
    span that holds a ``krylov_basis`` span where the entry is True."""
    ev, ids = [], iter(range(2, 100))
    for built in builds:
        sweep, probes = next(ids), next(ids)
        if built:
            ev.append({"event": "phase", "phase": "krylov_basis",
                       "wallclock_s": 3.0, "id": next(ids),
                       "parent": probes, "call": "c"})
        ev += [{"event": "phase", "phase": "probes", "wallclock_s": 3.5,
                "id": probes, "parent": sweep, "call": "c",
                "cached": 0 if built else 1},
               {"event": "phase", "phase": "sweep", "wallclock_s": 5.0,
                "id": sweep, "parent": 1, "call": "c"}]
    ev.append({"event": "phase", "phase": "am", "wallclock_s": 20.0,
               "id": 1, "parent": None, "call": "c"})
    return ev


@pytest.mark.parametrize("builds, want", [
    ([True, True, True], 3.0),        # rebuilt every sweep
    ([True, False, False], 1.0),      # built once, then two cache hits
    ([], None),                       # no probes span: nothing to read
])
def test_probe_builds_counts_the_builds_under_probes(builds, want):
    class Run:
        logs = [_sweeps(builds), _sweeps(builds)]
    # a krylov_basis span outside the probes spans (a refit's) is not one
    Run.logs[0].insert(0, {"event": "phase", "phase": "krylov_basis",
                           "wallclock_s": 1.0, "id": 99, "parent": 1,
                           "call": "c"})
    assert _read("probe_builds", Run()) == want
