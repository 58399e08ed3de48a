"""Device ops of the exact eigenbasis engine over SNP-major genotype tiles.

Counterpart of the JAX package's ops/kernels.py, whose XLA kernels are
plain torch ops here (no hand-written kernel: the JAX package reaches no
Pallas kernel on this path):

- :func:`recode_impute_tile`, :func:`unpack_recode_tile`: genotypes (int8,
  or the 2-bit packed bytes) → mean-imputed W = dose − 1;
- :func:`mmt_accumulate`: K += Wᵀ·W over one tile (the MMt);
- :func:`eig_T_tile`: T = W·U, a tile in K's eigenbasis;
- :func:`score_from_T` (and its batched form): the per-SNP outlier
  statistic t from a T tile, with the guards of
  :func:`score_from_T_parts` and :func:`t_from_ahat_vara`;
- :func:`score_tile` and :func:`score_tile_sqrt` (the sweep from the
  projector P̃ or its factor L, P̃ = L·Lᵀ; :func:`projector_sqrt` makes L),
  their ``_bf16`` forms and :func:`score_tile_batched`: the Lp-form sweep
  of ``TiledScan.sweep`` and the collective sweep.

Tiles are ``(b, n)``, one row per SNP. Every product is IEEE fp32 (the
callers switch TF32 off on CUDA). The ``compute_dtype="bfloat16"`` policy
rounds W to bf16 and computes with it in f32, as the JAX package does when
it promotes a bf16 W against an f32 operand. Only the ``score_tile*_bf16``
forms multiply in bf16, as the JAX package's do: both operands rounded to
bf16, products accumulated in f32 (on CUDA one bf16 GEMM with an f32
result; on the CPU the same numbers, since a product of two bf16 values is
exact in f32).
"""

from __future__ import annotations

import numpy as np
import torch

from eagleeverything_tpu_torch.ops import packed

MISSING = -9
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def recode_impute_tile(g_tile: torch.Tensor,
                       compute_dtype: str = "float32") -> torch.Tensor:
    """int8 (b, n) {0,1,2,-9} → W tile: mean-imputed per SNP, minus 1.

    All-missing SNPs impute to the heterozygote (W = 0). The sums are of
    integers, so the f32 mean equals the reference's bit for bit."""
    miss = g_tile == MISSING
    cnt = (~miss).sum(dim=1)
    s = torch.where(miss, 0, g_tile).sum(dim=1, dtype=torch.int64)
    mean = s.to(torch.float32) / cnt.clamp(min=1).to(torch.float32)
    mean = torch.where(cnt > 0, mean, 1.0)
    W = torch.where(miss, mean[:, None], g_tile.to(torch.float32)) - 1.0
    return W.to(_DTYPES[compute_dtype])


def _words(tile: torch.Tensor) -> torch.Tensor:
    """uint8 (b, nb) packed bytes → int32 (b, ⌈nb/4⌉) little-endian words,
    the tail padded with 0x55 (het codes)."""
    b, nb = tile.shape
    buf = torch.full((b, -(-nb // 4) * 4), 0x55, dtype=torch.uint8,
                     device=tile.device)
    buf[:, :nb] = tile
    return buf.view(torch.int32)


def unpack_recode_tile(tile: torch.Tensor, n: int,
                       compute_dtype: str = "float32") -> torch.Tensor:
    """2-bit packed tile → recoded W tile (b, n), on the tile's device.

    Takes both typings of the store's byte stream (codes 0/1/2 = dose,
    3 = missing; genotype j of a row at bits 2(j mod 4) of byte j/4):
    uint8 (b, ⌈n/4⌉) bytes, or the resident stack's int32 (b, ⌈⌈n/4⌉/4⌉)
    words. Per-SNP means come from the tile's own codes, as in
    :func:`recode_impute_tile`."""
    if tile.dtype == torch.uint8:
        tile = _words(tile)
    elif tile.dtype != torch.int32:
        raise ValueError(f"packed tile must be uint8 or int32, got "
                         f"{tile.dtype}")
    W = packed.recode(tile, packed.row_means(tile, n), n)
    return W.to(_DTYPES[compute_dtype])


def mmt_accumulate(K: torch.Tensor, Wt: torch.Tensor) -> torch.Tensor:
    """K (n, n) f32 += Wtᵀ·Wt for a SNP-major tile Wt (b, n), in place.

    Summed over tiles this is the whole MMt (the reference's ReadBlock →
    GEMM → accumulate loop of ``calculateMMt_rcpp``)."""
    W = Wt.to(torch.float32)
    return K.addmm_(W.T, W)


def eig_T_tile(Wt: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """T = Wt·U (b, n') f32: the tile in K's eigenbasis. U is fixed for
    the scan, so T is iteration-invariant and worth caching."""
    return Wt.to(torch.float32) @ U


def t_from_ahat_vara(ahat: torch.Tensor, vara: torch.Tensor) -> torch.Tensor:
    """t = â²/var(â), 0 where var(â) ≤ 1e-12 (monomorphic or padded SNPs)."""
    return torch.where(vara > 1e-12, (ahat * ahat) / vara, 0.0)


def score_from_T_parts(ahat: torch.Tensor, ts2: torch.Tensor,
                       TQ: torch.Tensor, sigma2_g) -> torch.Tensor:
    """The eigenbasis scoring epilogue from â = T·z3, ts2 = ‖Ts‖²_row and
    TQ = Ts·Q. var(â) = σ²_g·(ts2 − ‖TQ‖²_row) is a difference of squares;
    where it keeps less than 1e-6 of ts2 the SNP is (almost) inside the
    model, f32 cancellation has eaten it, and t is 0."""
    vara_raw = ts2 - torch.sum(TQ * TQ, dim=1)
    vara = sigma2_g * vara_raw
    valid = vara_raw > 1e-6 * torch.clamp(ts2, min=1e-12)
    return torch.where(valid, t_from_ahat_vara(ahat, vara), 0.0)


def score_from_T(T: torch.Tensor, s: torch.Tensor, Q: torch.Tensor,
                 z3: torch.Tensor, sigma2_g) -> torch.Tensor:
    """Outlier statistics (b,) from an eigenbasis tile T (b, n).

    With Ts = T∘s and orthonormal Q (zero-padded columns are inert):
    â = T·z3 (P̃y = U·z3), var(â) = σ²_g·(‖Ts‖²_row − ‖Ts·Q‖²_row).
    ``sigma2_g`` is a 0-d f32 tensor (or a float)."""
    ahat = T @ z3
    Ts = T * s[None, :]
    ts2 = torch.sum(Ts * Ts, dim=1)
    TQ = Ts @ Q
    return score_from_T_parts(ahat, ts2, TQ, sigma2_g)


def score_from_T_batched(T: torch.Tensor, s: torch.Tensor, Q: torch.Tensor,
                         z3: torch.Tensor, sigma2_g: torch.Tensor
                         ) -> torch.Tensor:
    """:func:`score_from_T` for R states at once: s (R, n), Q (R, n, q),
    z3 (R, n), σ²_g (R,) → (R, b). One state at a time, so the (b, n)
    temporaries are not multiplied by R."""
    return torch.stack([score_from_T(T, s[r], Q[r], z3[r], sigma2_g[r])
                        for r in range(s.shape[0])])


def _bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b with both operands rounded to bf16 and an f32 result (the JAX
    package's ``preferred_element_type=f32`` on bf16 inputs): one bf16
    GEMM on CUDA; on the CPU the f32 product of the rounded operands, the
    same numbers up to the order of the f32 sums."""
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.device.type == "cuda":
        return torch.mm(a16, b16, out_dtype=torch.float32)
    return a16.to(torch.float32) @ b16.to(torch.float32)


def score_tile(Wt: torch.Tensor, Pm: torch.Tensor, Py: torch.Tensor,
               sigma2_g) -> torch.Tensor:
    """Outlier statistics t (b,) of one tile from the projector P̃ (n, n):
    â = Wt·P̃y, var(â) = σ²_g·rowsum(Wt ∘ Wt·P̃), t = â²/var(â) (0 where
    var ≤ 1e-12: monomorphic or padded SNPs)."""
    W = Wt.to(torch.float32)
    ahat = W @ Py
    vara = sigma2_g * torch.sum(W * (W @ Pm), dim=1)
    return t_from_ahat_vara(ahat, vara)


def score_tile_sqrt(Wt: torch.Tensor, Lp: torch.Tensor, Py: torch.Tensor,
                    sigma2_g) -> torch.Tensor:
    """:func:`score_tile` from the projector's factor L (P̃ = L·Lᵀ, (n, m)):
    var(â)/σ²_g = ‖Lᵀ·w_j‖², so vara = σ²_g·rowsum((Wt·L)²)."""
    W = Wt.to(torch.float32)
    ahat = W @ Py
    B = W @ Lp
    return t_from_ahat_vara(ahat, sigma2_g * torch.sum(B * B, dim=1))


def score_tile_sqrt_bf16(Wt: torch.Tensor, Lp: torch.Tensor,
                         Py: torch.Tensor, sigma2_g) -> torch.Tensor:
    """:func:`score_tile_sqrt` with bf16 products (f32 accumulation)."""
    ahat = _bf16_mm(Wt, Py[:, None])[:, 0]
    B = _bf16_mm(Wt, Lp)
    return t_from_ahat_vara(ahat, sigma2_g * torch.sum(B * B, dim=1))


def score_tile_bf16(Wt: torch.Tensor, Pm: torch.Tensor, Py: torch.Tensor,
                    sigma2_g) -> torch.Tensor:
    """:func:`score_tile` with bf16 products (f32 accumulation); the
    elementwise Wt ∘ (Wt·P̃) stays f32, as in the JAX package."""
    ahat = _bf16_mm(Wt, Py[:, None])[:, 0]
    WtP = _bf16_mm(Wt, Pm)
    vara = sigma2_g * torch.sum(Wt.to(torch.float32) * WtP, dim=1)
    return t_from_ahat_vara(ahat, vara)


def score_tile_batched(Wt: torch.Tensor, Lp: torch.Tensor, Py: torch.Tensor,
                       sigma2_g: torch.Tensor) -> torch.Tensor:
    """:func:`score_tile_sqrt` for R projector factors against one tile:
    Lp (R, n, m), Py (R, n), σ²_g (R,) → (R, b) (the permutation-batched
    sweep of fpr4am)."""
    W = Wt.to(torch.float32)
    ahat = Py @ W.T
    B = torch.matmul(W, Lp)
    vara = sigma2_g[:, None] * torch.sum(B * B, dim=2)
    return t_from_ahat_vara(ahat, vara)


def projector_sqrt(Pm: np.ndarray) -> np.ndarray:
    """Host f64 symmetric square root L of the PSD projector P̃ (P̃ = L·Lᵀ;
    eigenvalues clipped at 0)."""
    w, U = np.linalg.eigh(0.5 * (Pm + Pm.T))
    return U * np.sqrt(np.clip(w, 0.0, None))[None, :]
