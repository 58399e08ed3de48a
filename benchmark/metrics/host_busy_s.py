"""host_busy_s.mf and host_busy_s.exact (one a call_s metric): host
seconds of a call in which the host worked rather than waited on the
card: over every span of the call's tree, its own seconds (its wall less
its children's) less the seconds it waited on the card itself
(``wait_s``: the blocking copies and the work queued before them), mean
over the window's calls. The most that moving the host's work to the
card, or overlapping it with the card's, could take off a call."""

import spans


def read(run):
    return spans.per_call(
        run, lambda root: sum(s.own - s.wait for s in root.walk()))
