"""sweep_s.mf: seconds of one sweep of the matrix-free engine (scan-log
phase ``sweep``), mean over every sweep of the window."""

import scanlog


def read(run):
    return scanlog.per_phase(run, "matfree", "sweep")
