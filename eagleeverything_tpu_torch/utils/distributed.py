"""Multi-process runtime over ``torch.distributed``.

Set three variables on every process and call :func:`maybe_initialize`
(the CLI does):

  EAGLE_COORD_ADDR  host:port of rank 0's TCP store
  EAGLE_NUM_PROCS   the number of processes (the world size)
  EAGLE_PROC_ID     this process's rank

One process per card: rank r runs on ``cuda:{r % torch.cuda.device_count()}``
(:func:`local_device`). On cards the default group is
``"cpu:gloo,cuda:nccl"``: tensors on the card go over NCCL, the host
float64 collectives below over gloo; without CUDA it is plain gloo.

The decision path is host float64 and must be bitwise identical on every
rank, or ranks take different branches and deadlock inside a collective.
So the f64 helpers move raw f64 bytes (an all-gather) and reduce ON THE
HOST in process order: every rank computes the same bits. Without an
initialised group the world is one process and every collective is the
identity.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def maybe_initialize(backend: Optional[str] = None) -> bool:
    """Initialise the default group from the EAGLE_* variables; a no-op
    without them (False) or when the caller opened the group already."""
    addr = os.environ.get("EAGLE_COORD_ADDR")
    if not addr:
        return False
    if dist.is_initialized():
        return True
    initialize(addr, int(os.environ["EAGLE_NUM_PROCS"]),
               int(os.environ["EAGLE_PROC_ID"]), backend=backend)
    return True


def initialize(addr: str, world_size: int, rank: int,
               backend: Optional[str] = None) -> None:
    """``init_process_group`` over a TCP store at ``addr`` (host:port).
    ``backend`` defaults to ``"cpu:gloo,cuda:nccl"`` where CUDA is
    available and ``"gloo"`` elsewhere; on a card the rank's device is made
    current first, so NCCL binds each rank to its own card."""
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialised")
    if backend is None:
        backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
                   else "gloo")
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend=backend, init_method=f"tcp://{addr}",
                            world_size=world_size, rank=rank)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_host0() -> bool:
    return process_index() == 0


def local_device() -> torch.device:
    """This rank's card: ``cuda:{rank % device_count}``."""
    return torch.device("cuda", process_index() % torch.cuda.device_count())


# ---------------------------------------------------------------------------
# Host float64 collectives (bit-exact transport, process-order reduction)
# ---------------------------------------------------------------------------


def allgather_f64(x) -> np.ndarray:
    """x (any shape, the same on every rank) → (P, *x.shape) f64, bit for
    bit what each rank sent."""
    x = np.ascontiguousarray(x, dtype=np.float64)
    P = process_count()
    if P == 1:
        return x[None]
    t = torch.from_numpy(x.reshape(-1).copy())
    parts = [torch.empty_like(t) for _ in range(P)]
    dist.all_gather(parts, t)
    return torch.stack(parts).numpy().reshape((P,) + x.shape)


def allreduce_sum_f64(x):
    """The cross-process sum of a host f64 array, added in process order on
    every rank (the same bits everywhere)."""
    if process_count() == 1:
        return x
    parts = allgather_f64(x)
    out = parts[0].copy()
    for k in range(1, parts.shape[0]):
        out += parts[k]
    return out


def allgather_concat_f64(x_local, sizes: list[int]) -> np.ndarray:
    """Concatenate per-process arrays along axis 0 in process order.
    ``sizes`` is every process's axis-0 length (the same list on every
    rank); the trailing dims must match."""
    if process_count() == 1:
        return np.ascontiguousarray(x_local, dtype=np.float64)
    x_local = np.asarray(x_local, dtype=np.float64)
    pad = np.zeros((max(sizes),) + x_local.shape[1:], dtype=np.float64)
    pad[: x_local.shape[0]] = x_local
    parts = allgather_f64(pad)
    return np.concatenate([parts[i, : sizes[i]] for i in range(len(sizes))],
                          axis=0)


def allgather_varlen_f64(x_local) -> np.ndarray:
    """Variable-length concatenation along axis 0 (sizes exchanged
    first)."""
    if process_count() == 1:
        return np.ascontiguousarray(x_local, dtype=np.float64)
    sizes = allgather_f64(np.array([np.shape(x_local)[0]], dtype=np.float64))
    return allgather_concat_f64(x_local, [int(s[0]) for s in sizes])


def process_snp_range(p: int) -> tuple[int, int]:
    """This process's contiguous SNP range [lo, hi) under the near-equal
    split every multi-process component agrees on."""
    nproc, pid = process_count(), process_index()
    return (p * pid) // nproc, (p * (pid + 1)) // nproc


def local_snp_sizes(p: int) -> list[int]:
    """Every process's SNP count under :func:`process_snp_range`."""
    nproc = process_count()
    return [(p * (i + 1)) // nproc - (p * i) // nproc for i in range(nproc)]
