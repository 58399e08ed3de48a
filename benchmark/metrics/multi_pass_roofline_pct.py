"""multi_pass_roofline_pct: the share of its bound at which ``am_multi``'s
wide stat-row pass ran (``TiledScan.matfree_stat_rows_multi``: every
active trait's block side by side in one K1 ``packed_dot`` a launch, then
the per-trait statistics): the sum over the window's passes of the least
time of their K1 launches (``yardstick.bound`` at the width each
``stat_pass`` span counts, ``cols`` over ``launches``) over the device
time of everything those calls launched (their ``bench::`` ranges in the
device trace: the products, the reduction and the copies). None without a
trace, or when the program's spans count no width."""

import yardstick

RANGE = "matfree_stat_rows_multi"


def _passes(run):
    """(cols, launches) of every counted stat pass of the window."""
    return [(e["cols"], e.get("launches", 1)) for events in run.logs
            for e in events if e.get("event") == "phase"
            and e.get("phase") == "stat_pass" and "cols" in e]


def read(run):
    if not run.profile:
        return None
    spent = run.profile["range_device_s"].get(RANGE, 0.0)
    shapes = run.shapes.get("packed_dot", [])
    passes = _passes(run)
    if spent <= 0 or not shapes or not passes:
        return None
    p, n, _, nw = max(shapes)       # the whole stack's launches
    least = sum(k * yardstick.bound("packed_dot", n, p, cols / k, nw)[0]
                for cols, k in passes) / 1e3
    return 100.0 * least / spent
