"""eigh_s: seconds the exact engine spends on the kernel's
eigendecomposition, once a call (scan-log phase ``eigh``), mean over the
window's calls."""

import scanlog


def read(run):
    return scanlog.per_phase(run, "exact", "eigh")
