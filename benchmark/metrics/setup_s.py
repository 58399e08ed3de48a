"""setup_s: host seconds from the process's start to the window's: the
CUDA context, loading (on a checkout's first run, building) the kernels,
drawing the cohort and handing it to the program, and the warm-up."""


def read(run):
    return run.setup_s
