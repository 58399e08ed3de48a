"""Single-dataclass configuration for the engine (SURVEY.md §6.6).

The fields and defaults are the JAX package's, less its switch for the
Pallas kernels: on this package's packed path the hand-written CUDA
kernels (ops/packed) are the only path on a card.

The reference exposes knobs only as function arguments (``availmemGb``,
``ncpu``, ``ngpu``, ``maxit``, ``fixit``, ``lambda``); we keep that spirit —
every public API function accepts plain arguments — and use this dataclass
only for the machine-level knobs that have no reference analog (mesh shape,
dtype policy, tile sizes).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class EagleConfig:
    """Machine/runtime configuration.

    Attributes:
      mesh_shape: logical device mesh shape as ``(ind, snp)`` axis sizes.
        ``None`` → 1-D mesh over all local devices on the ``snp`` axis
        (SNP-sharding is the primary partition; SURVEY.md §3.4).
      compute_dtype: dtype for the p-scale device sweeps ("bfloat16" or
        "float32"). Accumulation is always float32
        (``preferred_element_type``).
      (The decision path — REML 1-D optimization, extBIC, projector
        state — is hardwired to host float64 by design, not configurable:
        forward selection is a discrete argmax and tiny numeric drift
        flips markers; SURVEY.md §8 "hardest parts" (1).)
      snp_tile: number of SNPs per host tile while the packed stack is
        built; must be a multiple of 128. ``None`` (default) auto-sizes to
        ~512 MB of float32 per tile.
      availmem_gb: host-RAM budget per block for out-of-core streaming —
        the reference's ``availmemGb`` knob.
      device_cache_gb: the JAX package's device budget for its resident
        packed stack. This package does not read it: the stack is the only
        matrix-free path here, so it is held against the card's free memory
        (engine_torch.TiledScan) and refused when it does not fit.
      host_eigh_max_n: the exact engine's host/device eigendecomposition
        threshold (that engine is not in this package yet).
      matfree_min_n: ``am(engine="auto")`` switches to the matrix-free
        engine above this many individuals — the regime where even the
        device-f32 n×n kernel/eigenbasis strains HBM (n=32768 f32 ≈ 4.3 GB
        for U alone, plus eigh workspace).
      seed: base PRNG seed for permutation tests.
    """

    mesh_shape: Optional[Tuple[int, int]] = None
    compute_dtype: str = "float32"
    snp_tile: Optional[int] = None
    availmem_gb: float = 8.0
    device_cache_gb: float = 8.0
    host_eigh_max_n: int = 8192
    matfree_min_n: int = 32768
    seed: int = 0
    # --- matrix-free engine accuracy/cost knobs (bigscan) -------------
    # Defaults match forward_select_matfree's signature; lowering them
    # trades sweep-estimate sharpness for wall-clock (the decision path
    # stays exact: shortlist + escalation guard rescore by exact CG).
    # Exposed here so biobank-n runs on slow hosts (e.g. the 2-core
    # CPU-mesh config-4 smokes) can bound the Krylov work per iteration.
    matfree_probes: int = 32          # SLQ logdet probe columns
    matfree_lanczos_m: int = 40       # logdet/isqrt Lanczos depth
    matfree_diag_probes: int = 128    # Hutchinson diag probe columns
    matfree_exact_topk: int = 64      # exact-CG rescored shortlist size
    matfree_solve_m: int = 128        # shifted-solve Lanczos depth
    matfree_solve_m_refit: int = 64   # …for delta-hinted accept-tests
    matfree_cache_gb: float = 2.0     # per-basis Krylov cache budget

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32|bfloat16, got {self.compute_dtype}")
        if self.snp_tile is not None and self.snp_tile % 128 != 0:
            raise ValueError(f"snp_tile must be a multiple of 128, got {self.snp_tile}")

    def resolve_snp_tile(self, n: int, p_pad: int) -> int:
        """Tile size in SNPs: explicit setting, else ~512 MB f32 auto."""
        if self.snp_tile is not None:
            return min(self.snp_tile, p_pad)
        auto = int(512e6 / 4 / max(n, 1)) // 128 * 128
        return max(128, min(max(auto, 1024), p_pad))


DEFAULT_CONFIG = EagleConfig()
