"""The JAX package's resident packed stack in the port's layout, for the
tests that hold the port's stack and wrappers to the JAX package's."""

import numpy as np
import torch

from eagleeverything_tpu_torch.ops import packed


def stack_from_jax(Wp: np.ndarray, means: np.ndarray, n: int, p: int,
                   device) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's resident stack and means, as numpy arrays (int32
    (p_pad, nw_pad) padded to its Pallas blocks, f32 (p_pad, 1)), → the
    port's stack (p, ⌈⌈n/4⌉/4⌉) and means (p,) on ``device``. Both
    packages fill bytes past a row's ⌈n/4⌉ with 0x55, so the words agree."""
    nw = packed.words_per_row(n)
    Wp = np.asarray(Wp)
    if Wp.dtype != np.int32 or Wp.shape[0] < p or Wp.shape[1] < nw:
        raise ValueError(f"expected an int32 stack of at least ({p}, {nw}), "
                         f"got {Wp.dtype} {Wp.shape}")
    W_t = torch.from_numpy(np.array(Wp[:p, :nw])).to(device)
    m_t = torch.from_numpy(
        np.array(np.asarray(means, np.float32).reshape(-1)[:p])).to(device)
    return W_t, m_t
