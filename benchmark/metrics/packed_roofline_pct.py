"""packed_roofline_pct: the share of their bound at which the window's
K1 ``packed_dot`` and K2 ``packed_tdot`` launches ran: the sum of each
call's least time (``yardstick.bound`` on its (p, n, r, nw)) over the
device time of the kernels those calls launched, from the device trace."""

import yardstick

KINDS = ("packed_dot", "packed_tdot")


def read(run):
    if not run.profile:
        return None
    least = sum(yardstick.bound(k, n, p, r, nw)[0] / 1e3
                for k in KINDS for p, n, r, nw in run.shapes.get(k, []))
    spent = sum(run.profile["range_device_s"].get(k, 0.0) for k in KINDS)
    return 100.0 * least / spent if least > 0 and spent > 0 else None
