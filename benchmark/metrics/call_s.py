"""call_s (the matrix-free cell) and call_s.exact (the exact engine's,
whose host-paced calls spread wider and get a bound of their own): the
window's wall seconds over the calls of the cell's entry it completed
(host clock), the time a user waits for one trait's loci."""


def read(run):
    return run.window_s / run.calls if run.calls else None
