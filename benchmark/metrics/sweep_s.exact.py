"""sweep_s.exact: seconds of one sweep of the exact eigenbasis engine
(scan-log phase ``sweep``; T = W·U recomputed when it is not cached), mean
over every sweep of the window."""

import scanlog


def read(run):
    return scanlog.per_phase(run, "exact", "sweep")
