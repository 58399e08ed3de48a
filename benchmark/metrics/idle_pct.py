"""idle_pct and idle_pct.exact (one a call_s metric): the share of the
traced window in which no kernel, copy or set ran on the device (the
profiler's trace)."""


def read(run):
    if not run.profile or not run.profile["window_s"]:
        return None
    return 100.0 * (1.0 - run.profile["busy_s"] / run.profile["window_s"])
