"""Device selection for the entry points: CUDA unless the caller asks for
the CPU, and never a silent drop to the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

from eagleeverything_tpu_torch.utils import distributed


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``; raises when CUDA is asked for and absent. A
    bare ``cuda`` in a multi-process run is the rank's own card
    (utils/distributed.local_device: one process per card)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    if dev.type == "cuda" and dev.index is None \
            and distributed.process_count() > 1:
        dev = distributed.local_device()
    return dev
