"""unspanned_s.mf and unspanned_s.exact (one a call_s metric): seconds
of a call of the program's entry that no span inside it names (the root
span ``am`` / ``am_multi`` less its direct children), mean over the
window's calls; None when the program records no span tree."""

import spans


def read(run):
    return spans.per_call(run, lambda root: root.own)
