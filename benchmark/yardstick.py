"""The benchmark's yardstick: the card's published peaks and the least time
the card could take for the work of each timed operation.

Frozen here so that a change to the program cannot move it. ``bound`` is
copied from ``chip_smoke.py:392`` (``bound``) and the peaks from
``chip_smoke.py:295``; the exact engine's work functions follow the count of
``chip_smoke.py:657`` (``exact_op_targets``), with each input read once and
each output written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS_PER_S = 989e12


def bound(kind: str, n: int, p: int, r: int, nw: int) -> tuple[float, str]:
    """Least time (ms) of one packed-stack kernel call, and whether bytes or
    operations bound it: each input read once and each output written once
    over the HBM rate, against the function's own 2·p·n·r FLOPs as one
    dense bf16 product at the tensor cores' peak. ``kernel_matvec`` is the
    two launches in turn, so its bound is the sum of theirs."""
    if kind == "kernel_matvec":
        parts = [bound(k, n, p, r, nw) for k in ("packed_dot", "packed_tdot")]
        return (sum(b[0] for b in parts), " + ".join(b[1] for b in parts))
    stack, means = p * nw * 4, p * 4
    nbytes = stack + means + (n + p) * r * 4   # A→D or T→out: (n+p)·r f32
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * p * n * r / BF16_TC_FLOPS_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations"
    return t_bytes, "bytes"


def gemm_bound(flops: float, nbytes: float) -> float:
    """Least time (ms) of a product: the larger of its FLOPs at the bf16
    tensor cores' peak and its bytes at the HBM rate. The bf16 peak, not
    fp32's, so that the same work reads the same whatever implements it
    and no faster route can read above 100%."""
    return max(flops / BF16_TC_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3


def mmt_work(tile: int, n: int) -> tuple[float, float]:
    """(FLOPs, bytes) of ``kernels.mmt_accumulate``: K (n, n) += Wᵀ·W for a
    tile W (tile, n): 2·tile·n² FLOPs; reads W and K, writes K (f32)."""
    return 2.0 * tile * n * n, 4.0 * (tile * n + 2 * n * n)


def eig_t_work(tile: int, n: int, m: int) -> tuple[float, float]:
    """(FLOPs, bytes) of ``kernels.eig_T_tile``: T = W·U for W (tile, n)
    and U (n, m): 2·tile·n·m FLOPs; reads W and U, writes T (f32)."""
    return 2.0 * tile * n * m, 4.0 * (tile * n + n * m + tile * m)
