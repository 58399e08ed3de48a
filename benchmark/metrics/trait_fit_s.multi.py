"""trait_fit_s.multi: seconds a call of ``am_multi``'s lockstep
matrix-free scan spends on its traits' δ searches (the spans
``trait_fit``, one a trait in ``reml`` and in each ``refit``: the host's
REML profile over the union basis and the exact polish), mean over the
window's calls; None when the program records no such span."""

import spans


def _fits(root):
    parts = spans.named(root, ("trait_fit",))
    return sum(s.wall for s in parts) if parts else None


def read(run):
    return spans.per_call(run, _fits, kind="matfree")
