"""The matrix-free scan backend over the resident 2-bit packed stack.

Counterpart of the matrix-free subset of the JAX package's
models/engine_jax.py. The whole genotype matrix lives on the device as one
int32 packed stack (four genotypes a byte, sixteen a word); every pass over
it is one of the two hand-written kernels of ops/packed:

- ``kernel_matvec``: K·V = Wᵀ(W·V), packed_dot then packed_tdot — the unit
  of every Krylov step (the s0 estimate, the host Lanczos recurrences of
  models/bigscan, and the device CG);
- ``sweep_dots`` and ``matfree_stat_rows``: one packed_dot over all SNPs.

The decision path stays on the host in float64; the device works in IEEE
fp32. The CG solve keeps its X/R/P block on the device and the host reads
only the (r,) residual norms, every other step — the form the JAX package
ran on the TPU. Every source is packed into the same stack: a 2-bit store
ships its raw bytes, and a dense handle, an unpacked store or a row-masked
source is packed on the host first.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from eagleeverything_tpu_torch.api.read import GenoHandle
from eagleeverything_tpu_torch.io import genostore
from eagleeverything_tpu_torch.ops import packed
from eagleeverything_tpu_torch.utils.config import EagleConfig

MISSING = -9


# ---------------------------------------------------------------------------
# Tile sources: host-side streaming (the ReadBlock contract, SURVEY.md §3.3)
# ---------------------------------------------------------------------------


class TileSource:
    """Yields SNP-major int8 tiles (b, n_kept), packed tiles and columns."""

    n: int
    p: int

    def tiles(self, tile_snps: int) -> Iterator[tuple[int, np.ndarray]]:
        raise NotImplementedError

    def packed_tiles(self, tile_snps: int
                     ) -> Iterator[tuple[int, np.ndarray]]:
        """(offset, uint8 (b, ⌈n/4⌉)) 2-bit tiles in the store's byte
        layout — by default the int8 tiles packed on the host."""
        for j0, tile in self.tiles(tile_snps):
            yield j0, genostore.pack2(tile)

    def column(self, j: int) -> np.ndarray:
        raise NotImplementedError


class DenseTileSource(TileSource):
    def __init__(self, geno: np.ndarray, keep: Optional[np.ndarray] = None):
        G = np.asarray(geno, dtype=np.int8)
        if keep is not None:
            G = G[keep]
        self._Gt = np.ascontiguousarray(G.T)  # (p, n)
        self.p, self.n = self._Gt.shape

    def tiles(self, tile_snps: int):
        for j0 in range(0, self.p, tile_snps):
            yield j0, self._Gt[j0 : j0 + tile_snps]

    def column(self, j: int) -> np.ndarray:
        return self._Gt[j]


class StoreTileSource(TileSource):
    def __init__(self, store_dir: str, keep: Optional[np.ndarray] = None):
        self._store = genostore.GenotypeStore.open(store_dir)
        self._keep = keep
        self.p = self._store.p
        self.n = self._store.n if keep is None else int(len(keep))

    def tiles(self, tile_snps: int):
        for j0, tile in self._store.iter_tiles(tile_snps):
            if self._keep is not None:
                tile = tile[:, self._keep]
            yield j0, tile

    def packed_tiles(self, tile_snps: int):
        """A 2-bit store with every individual kept ships its raw bytes."""
        if self._store.packed and self._keep is None:
            return self._store.iter_raw_tiles(tile_snps)
        return super().packed_tiles(tile_snps)

    def column(self, j: int) -> np.ndarray:
        col = self._store.column(j)
        return col if self._keep is None else col[self._keep]


def _make_source(handle: GenoHandle, keep: Optional[np.ndarray]) -> TileSource:
    if handle.geno is not None:
        return DenseTileSource(handle.geno, keep)
    if handle.store_dir is not None:
        return StoreTileSource(handle.store_dir, keep)
    raise ValueError("GenoHandle has neither in-memory genotypes nor a store")


def _impute_column_f64(col_raw: np.ndarray) -> np.ndarray:
    """Recode one raw int8 column to the f64 W column the oracle would
    produce (mean-impute, minus 1) — used for the fixed-effects update so
    the REML decision inputs stay f64-exact."""
    col = col_raw.astype(np.float64)
    miss = col_raw == MISSING
    if miss.any():
        obs = col[~miss]
        mean = float(obs.mean()) if obs.size else 1.0
        col[miss] = mean
    return col - 1.0


def _shift_param(delta, r_pad: int) -> np.ndarray:
    """CG shift: a scalar δ, or PER-COLUMN shifts padded to the padded RHS
    width. Pad value 1.0 is inert: padded columns start with rs = 0 and
    stay frozen."""
    d = np.asarray(delta, dtype=np.float32)
    if d.ndim == 0:
        return d
    out = np.ones(r_pad, np.float32)
    out[: d.shape[0]] = d
    return out


def _pad_cols8(B: np.ndarray) -> np.ndarray:
    """Zero-pad trailing columns to a multiple of 8, as the reference does
    (zero columns are inert: zero norm → frozen)."""
    r = B.shape[1]
    r_pad = -(-r // 8) * 8
    if r_pad == r:
        return B
    return np.pad(B, ((0, 0), (0, r_pad - r)))


def _stats_from_D(D: torch.Tensor, Minv: torch.Tensor, q: int) -> torch.Tensor:
    """The matfree sweep's per-SNP statistics from the dot block D
    ((p, 1+q+r), on the device): (p, q+3) rows [â, u, diag, proj]."""
    ahat = D[:, :1]
    U = D[:, 1 : 1 + q]
    WHZ = D[:, 1 + q :]
    diag = torch.sum(WHZ * WHZ, dim=1, keepdim=True) / WHZ.shape[1]
    proj = torch.einsum("jq,qr,jr->j", U, Minv, U)[:, None]
    return torch.cat([ahat, U, diag, proj], dim=1)


def stack_from_jax(Wp: np.ndarray, means: np.ndarray, n: int, p: int,
                   device) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's resident stack and means, as numpy arrays (int32
    (p_pad, nw_pad) padded to its Pallas blocks, f32 (p_pad, 1)), → this
    package's stack (p, ⌈⌈n/4⌉/4⌉) and means (p,) on ``device``. Both
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


def _cg_step(Wp, means, n: int, X, R, P, rs, thresh, delta, s0: float):
    """One CG iteration on H = K/s0 + δI with the block state on the
    device; converged columns are frozen (α = β = 0)."""
    active = rs > thresh
    HP = packed.kernel_matvec(Wp, P, means, n) / s0 + delta * P
    pHp = torch.sum(P * HP, dim=0)
    zero = torch.zeros_like(rs)
    alpha = torch.where(active & (pHp > 0), rs / pHp.clamp(min=1e-30), zero)
    X = X + P * alpha[None, :]
    R = R - HP * alpha[None, :]
    rs_new = torch.sum(R * R, dim=0)
    beta = torch.where(active, rs_new / rs.clamp(min=1e-30), zero)
    P = R + P * beta[None, :]
    return X, R, P, rs_new


class TiledScan:
    """Single-device matrix-free backend over the resident packed stack
    (reference: the per-iteration ReadBlock sweep of
    ``calculate_a_and_vara_rcpp``, SURVEY.md §4.2, with device memory
    standing in for disk)."""

    def __init__(self, src: TileSource, config: EagleConfig,
                 device: torch.device):
        self.src = src
        self.config = config
        self.device = torch.device(device)
        # observability: full passes over the genotype rows (matvecs,
        # CG steps, stat rows)
        self.stack_passes = 0
        self.tile_snps = config.resolve_snp_tile(src.n,
                                                 -(-src.p // 128) * 128)
        self.nw = packed.words_per_row(src.n)
        if self.device.type == "cuda":
            # the packed stack is the only matrix-free path on the card: a
            # stack larger than the card's free memory is refused, never
            # streamed
            packed_bytes = src.p * self.nw * 4
            free, total = torch.cuda.mem_get_info(self.device)
            if packed_bytes > free:
                raise ValueError(
                    f"the packed stack of {src.n} individuals x {src.p} "
                    f"SNPs takes {packed_bytes / 1e9:.3f} GB, more than the "
                    f"{free / 1e9:.3f} GB free of {total / 1e9:.3f} GB on "
                    f"{self.device}")
            # IEEE fp32 on the card: no TF32 in any matmul or convolution
            # (the kernels and the decision path's inputs are full fp32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self._pstack: Optional[torch.Tensor] = None
        self._pmeans: Optional[torch.Tensor] = None

    def _packed_stack(self) -> torch.Tensor:
        """The whole source as ONE device-resident (p, ⌈⌈n/4⌉/4⌉) int32
        stack (little-endian word view of the 2-bit byte stream: word w
        holds genotypes 16w+k at bits 2k), built tile by tile into a
        preallocated buffer so peak device memory is 1× the packed size;
        bytes past a row's ⌈n/4⌉ are 0x55 (het codes → W = 0). The
        per-SNP means are computed once, with the stack."""
        if self._pstack is not None:
            return self._pstack
        nw = self.nw
        buf = torch.full((self.src.p, nw), packed.PAD_WORD,
                         dtype=torch.int32, device=self.device)
        for j0, raw in self.src.packed_tiles(self.tile_snps):
            # uint8 (b, nb) tile → little-endian int32 (b, nw) words (the
            # host is little-endian, so a view is the right bits)
            wb = np.full((raw.shape[0], nw * 4), 0x55, dtype=np.uint8)
            wb[:, : raw.shape[1]] = raw
            buf[j0 : j0 + raw.shape[0]] = torch.from_numpy(
                wb.view(np.int32)).to(self.device)
        self._pstack = buf
        self._pmeans = packed.row_means(buf, self.src.n)
        return buf

    def _to_device(self, V: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(V), dtype=torch.float32,
                               device=self.device)

    @staticmethod
    def _to_host(T: torch.Tensor) -> np.ndarray:
        return T.cpu().numpy().astype(np.float64)

    def kernel_matvec(self, V: np.ndarray) -> np.ndarray:
        """Raw-kernel matvec MMt·V (V (n, r)) — K is never materialized."""
        self.stack_passes += 1
        Wp = self._packed_stack()
        return self._to_host(packed.kernel_matvec(
            Wp, self._to_device(V), self._pmeans, self.src.n))

    def _h_apply_host(self, X: np.ndarray, delta, s0: float) -> np.ndarray:
        """H·X for warm-start residuals."""
        return self.kernel_matvec(X) / s0 + delta * X

    def device_cg(self, B: np.ndarray, delta, s0: float,
                  tol: float = 1e-6, maxiter: int = 400,
                  x0: Optional[np.ndarray] = None) -> np.ndarray:
        """Solve (WᵀW/s0 + δI)·X = B: a host-driven loop of single CG steps
        with X/R/P resident on the device; the host reads the (r,) residual
        norms every other step to test convergence and stalls. f32 on the
        device, so tol is floored at 1e-6. ``x0`` warm-starts the solve in
        residual form (convergence stays relative to the ORIGINAL ‖B‖)."""
        r = B.shape[1]
        if x0 is not None and x0.shape != B.shape:
            x0 = None
        Wp = self._packed_stack()
        Bp = _pad_cols8(B)
        r_pad = Bp.shape[1]
        bn2 = np.maximum(np.sum(Bp.astype(np.float32) ** 2, axis=0), 1e-30)
        if x0 is not None:
            R0 = B - self._h_apply_host(x0, delta, s0)
        else:
            R0, x0 = B, np.zeros_like(B)
        Rd = self._to_device(_pad_cols8(R0))
        Xd = torch.zeros_like(Rd)
        Pd = Rd
        rs = torch.sum(Rd * Rd, dim=0)
        tol_e = max(tol, 1e-6)
        thresh = torch.tensor(np.float32(tol_e) * np.float32(tol_e) * bn2,
                              dtype=torch.float32, device=self.device)
        dlt = torch.as_tensor(_shift_param(delta, r_pad), device=self.device)
        # stall detection: the f32 matvec floors the reachable residual;
        # once no active column has QUARTERED its norm² in 10 steps,
        # further iterations only burn stack passes
        floor = self._to_host(rs)
        since = 0
        for it in range(maxiter):
            # convergence/stall test every OTHER step (each read is a
            # device sync; converged columns are frozen on the device)
            if it % 2 == 0:
                rs_h = self._to_host(rs)
                if not np.any(rs_h > tol_e * tol_e * bn2):
                    break
                if np.all(rs_h >= 0.25 * floor):
                    since += 1
                    if since >= 5:
                        break
                else:
                    since = 0
                floor = np.minimum(floor, rs_h)
            Xd, Rd, Pd, rs = _cg_step(Wp, self._pmeans, self.src.n, Xd, Rd,
                                      Pd, rs, thresh, dlt, float(s0))
            self.stack_passes += 1
        return x0 + self._to_host(Xd)[:, :r]

    def sweep_dots(self, A: np.ndarray) -> np.ndarray:
        """Per-SNP dot products W·A ((p, r)), one packed_dot launch."""
        Wp = self._packed_stack()
        return self._to_host(packed.packed_dot(
            Wp, self._to_device(A), self._pmeans, self.src.n))

    def matfree_stat_rows(
        self, A: np.ndarray, q: int, XtHiX_inv: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Per-SNP matfree sweep statistics (â, u, Hutchinson diag, proj)
        for A = [P̃y, H⁻¹X, H^(-1/2)·probes]: one packed_dot, then the
        probe block is reduced ON THE DEVICE, so (p, q+3) comes back, not
        (p, 1+q+r). q is padded to a multiple of 8 as in the reference
        (zero u/Minv columns are inert)."""
        self.stack_passes += 1
        Wp = self._packed_stack()
        r = A.shape[1] - 1 - q
        q8 = -(-max(q, 1) // 8) * 8
        A_pad = np.zeros((A.shape[0], 1 + q8 + r))
        A_pad[:, 0] = A[:, 0]
        A_pad[:, 1 : 1 + q] = A[:, 1 : 1 + q]
        A_pad[:, 1 + q8 :] = A[:, 1 + q :]
        M_pad = np.zeros((q8, q8))
        M_pad[:q, :q] = XtHiX_inv
        D = packed.packed_dot(Wp, self._to_device(A_pad), self._pmeans,
                              self.src.n)
        out = self._to_host(_stats_from_D(D, self._to_device(M_pad), q8))
        return (out[:, 0], out[:, 1 : 1 + q], out[:, 1 + q8], out[:, 2 + q8])

    def column_f64(self, j: int) -> np.ndarray:
        """The f64 recoded W column for SNP j (reference:
        ``extract_geno_rcpp``, SURVEY.md §3.3)."""
        return _impute_column_f64(self.src.column(j))
