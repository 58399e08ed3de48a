"""krylov_s.mf: seconds a call of the matrix-free engine spends on its
Krylov context and first REML fit (scan-log phases ``context`` +
``reml``), mean over the window's calls."""

import scanlog


def read(run):
    return scanlog.per_call(
        run, "matfree",
        lambda ph: sum(ph.get("context", [])) + sum(ph.get("reml", [])))
