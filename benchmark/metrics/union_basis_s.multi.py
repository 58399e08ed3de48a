"""union_basis_s.multi: seconds a call of ``am_multi``'s lockstep
matrix-free scan spends building its union Krylov bases (the spans
``union_basis``, one in ``reml`` and one a ``refit``: one Lanczos over
every trait's [X y] block side by side), mean over the window's calls;
None when the program records no such span."""

import spans


def _union(root):
    parts = spans.named(root, ("union_basis",))
    return sum(s.wall for s in parts) if parts else None


def read(run):
    return spans.per_call(run, _union, kind="matfree")
