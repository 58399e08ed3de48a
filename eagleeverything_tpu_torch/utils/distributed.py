"""Single-process forms of the host collectives the matrix-free scan calls.

The JAX package moves float64 payloads between processes and reduces them
on the host in process order (its utils/distributed.py). With one process
each collective is the identity; the multi-process forms, over
``torch.distributed``, are later work.
"""

from __future__ import annotations

import numpy as np


def process_index() -> int:
    return 0


def is_host0() -> bool:
    return process_index() == 0


def allreduce_sum_f64(x):
    """Cross-process sum of a host f64 array (one process: ``x``)."""
    return x


def allgather_concat_f64(x_local, sizes):
    """Concatenate per-process arrays along axis 0 in process order."""
    return np.ascontiguousarray(x_local, dtype=np.float64)


def allgather_varlen_f64(x_local):
    """Variable-length concat along axis 0 in process order."""
    return np.ascontiguousarray(x_local, dtype=np.float64)
