"""The scan backend over the 2-bit packed stack, and the exact eigenbasis
engine's forward selection.

Counterpart of the JAX package's models/engine_jax.py. The whole genotype
matrix (in a multi-process run: the rank's SNP range, MultiHostTiledScan)
is one int32 packed stack (four genotypes a byte, sixteen a word): on the
device when it fits there beside what the scan holds, else streamed through
the device chunk by chunk on every pass (:func:`_stack_plan`,
:meth:`TiledScan._stack_chunks`), from page-locked host memory when it fits
``availmem_gb``, else read anew from the source on every pass by a reader
thread, as the JAX package's producer thread reads it. Two engines read it:

- the matrix-free engine (models/bigscan), whose every pass over the stack
  is one of the two hand-written kernels of ops/packed: ``kernel_matvec``
  (K·V = Wᵀ(W·V), packed_dot then packed_tdot — the unit of every step of
  the device CG and the device Lanczos, whose state and basis stay on the
  device) and ``sweep_dots`` / ``matfree_stat_rows`` /
  ``matfree_stat_rows_multi`` (one packed_dot, R traits side by side in
  the last), each once a chunk on a streamed stack;
- the exact eigenbasis engine (:func:`forward_select`,
  :func:`forward_select_multi`), the default below ``matfree_min_n``: the
  stack is unpacked a tile at a time into f32 W for the torch ops of
  ops/kernels — MMt = WᵀW once, one eigendecomposition of K, T = W·U once
  (cached on the device when it fits), then each sweep scores every SNP
  from T with skinny products. Its SNP-sharded form (:class:`ShardedScan`,
  ``am(engine="sharded")``) keeps a recoded W block a rank on the (ind,
  snp) mesh of the ranks and sweeps it with parallel/collectives.

The decision path stays on the host in float64; the device works in IEEE
fp32. The CG solve keeps its X/R/P block on the device and the host reads
only the (r,) residual norms, every other step — the form the JAX package
ran on the TPU; the Lanczos recurrence reads nothing until its last step.
A one-hot Zmat enters both as a record → individual index (a segment sum
and a gather around the kernel matvec). Every source is packed into the
same stack: a 2-bit store ships its raw bytes, and a dense handle, an
unpacked store or a row-masked source is packed on the host first — or, read
from the source on every pass, its int8 rows are packed on the device.
"""

from __future__ import annotations

import hashlib
import math
import queue
import threading
import time
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from eagleeverything_tpu_torch.api.read import GenoHandle
from eagleeverything_tpu_torch.io import genostore
from eagleeverything_tpu_torch.models import reml_core
from eagleeverything_tpu_torch.models.oracle import AMResult
from eagleeverything_tpu_torch.ops import kernels, packed
from eagleeverything_tpu_torch.parallel import collectives
from eagleeverything_tpu_torch.parallel import mesh as meshlib
from eagleeverything_tpu_torch.utils import distributed
from eagleeverything_tpu_torch.utils.config import DEFAULT_CONFIG, EagleConfig

MISSING = -9


# ---------------------------------------------------------------------------
# Tile sources: host-side streaming (the ReadBlock contract, SURVEY.md §3.3)
# ---------------------------------------------------------------------------


class TileSource:
    """Yields SNP-major int8 tiles (b, n_kept), packed tiles and columns,
    and fills a buffer with a range of rows (:meth:`read_rows`)."""

    n: int
    p: int
    # what read_rows gives: "int8" genotypes (n bytes a row), or "raw", a
    # 2-bit store's own bytes (⌈n/4⌉ a row)
    row_format = "int8"

    def tiles(self, tile_snps: int) -> Iterator[tuple[int, np.ndarray]]:
        raise NotImplementedError

    def tiles_in(self, lo: int, hi: int, tile_snps: int
                 ) -> Iterator[tuple[int, np.ndarray]]:
        """Tiles restricted to the SNP range [lo, hi) (a rank's own rows in
        a multi-process run). This form clips the full stream; a store
        overrides it so that no foreign shard is opened."""
        for j0, tile in self.tiles(tile_snps):
            a, b = max(j0, lo), min(j0 + tile.shape[0], hi)
            if a < b:
                yield a, tile[a - j0 : b - j0]

    def packed_tiles(self, tile_snps: int
                     ) -> Iterator[tuple[int, np.ndarray]]:
        """(offset, uint8 (b, ⌈n/4⌉)) 2-bit tiles in the store's byte
        layout — by default the int8 tiles packed on the host."""
        for j0, tile in self.tiles(tile_snps):
            yield j0, genostore.pack2(tile)

    def packed_tiles_in(self, lo: int, hi: int, tile_snps: int
                        ) -> Iterator[tuple[int, np.ndarray]]:
        """:meth:`packed_tiles` restricted to the SNP range [lo, hi)."""
        for j0, tile in self.tiles_in(lo, hi, tile_snps):
            yield j0, genostore.pack2(tile)

    def read_rows(self, lo: int, hi: int, out: torch.Tensor) -> None:
        """Fill ``out`` with SNP rows [lo, hi) as :attr:`row_format` says:
        int8 (hi - lo, n), or the raw bytes in the first ⌈n/4⌉ columns of a
        uint8 (hi - lo, ≥ ⌈n/4⌉) buffer. This form copies the int8 tiles of
        :meth:`tiles_in`."""
        for j0, tile in self.tiles_in(lo, hi, hi - lo):
            out[j0 - lo : j0 - lo + tile.shape[0]].copy_(
                torch.from_numpy(np.ascontiguousarray(tile)))

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

    def read_rows(self, lo: int, hi: int, out: torch.Tensor) -> None:
        out.copy_(torch.from_numpy(self._Gt[lo:hi]))

    def column(self, j: int) -> np.ndarray:
        return self._Gt[j]


class StoreTileSource(TileSource):
    def __init__(self, store_dir: str, keep: Optional[np.ndarray] = None):
        self._store = genostore.GenotypeStore.open(store_dir)
        self._keep = keep
        self.p = self._store.p
        self.n = self._store.n if keep is None else int(len(keep))
        if self._store.packed and keep is None:
            self.row_format = "raw"

    def tiles(self, tile_snps: int):
        for j0, tile in self._store.iter_tiles(tile_snps):
            if self._keep is not None:
                tile = tile[:, self._keep]
            yield j0, tile

    def tiles_in(self, lo: int, hi: int, tile_snps: int):
        """Range-restricted tiles: only the shards that intersect [lo, hi)
        are opened (a rank reads its own shard files only)."""
        st = self._store
        for k in range(st.n_shards):
            s0, s1 = st.shard_offsets[k], st.shard_offsets[k + 1]
            if s1 <= lo or s0 >= hi:
                continue
            raw = st._shard_raw(k)
            for t0 in range(max(s0, lo), min(s1, hi), tile_snps):
                t1 = min(t0 + tile_snps, s1, hi)
                tile = genostore._decode(np.asarray(raw[t0 - s0 : t1 - s0]),
                                         st.n, st.packed)
                yield t0, tile if self._keep is None else tile[:, self._keep]

    def packed_tiles(self, tile_snps: int):
        """A 2-bit store with every individual kept ships its raw bytes."""
        if self._store.packed and self._keep is None:
            return self._store.iter_raw_tiles(tile_snps)
        return super().packed_tiles(tile_snps)

    def packed_tiles_in(self, lo: int, hi: int, tile_snps: int):
        if self._store.packed and self._keep is None:
            return self._store.iter_raw_tiles_in(lo, hi, tile_snps)
        return super().packed_tiles_in(lo, hi, tile_snps)

    def read_rows(self, lo: int, hi: int, out: torch.Tensor) -> None:
        """With every individual kept, the store's own bytes (2-bit or
        int8) straight from its shards; with a mask, the decoded tiles."""
        if self._keep is None:
            self._store.read_rows(lo, hi, out)
        else:
            super().read_rows(lo, hi, out)

    def column(self, j: int) -> np.ndarray:
        col = self._store.column(j)
        return col if self._keep is None else col[self._keep]


class RangeTileSource(TileSource):
    """A base source restricted to the SNP range [lo, hi), offsets from 0:
    a rank's slice of the genotype matrix in a multi-process run (store
    shard ↔ rank locality)."""

    def __init__(self, base: TileSource, lo: int, hi: int):
        self.base, self.lo, self.hi = base, lo, hi
        self.n = base.n
        self.p = hi - lo
        self.row_format = base.row_format

    def tiles(self, tile_snps: int):
        for j0, tile in self.base.tiles_in(self.lo, self.hi, tile_snps):
            yield j0 - self.lo, tile

    def packed_tiles(self, tile_snps: int):
        for j0, raw in self.base.packed_tiles_in(self.lo, self.hi,
                                                 tile_snps):
            yield j0 - self.lo, raw

    def read_rows(self, lo: int, hi: int, out: torch.Tensor) -> None:
        self.base.read_rows(self.lo + lo, self.lo + hi, out)

    def column(self, j: int) -> np.ndarray:
        return self.base.column(self.lo + j)


def _make_source(handle: GenoHandle, keep: Optional[np.ndarray]) -> TileSource:
    if handle.geno is not None:
        return DenseTileSource(handle.geno, keep)
    if handle.store_dir is not None:
        return StoreTileSource(handle.store_dir, keep)
    raise ValueError("GenoHandle has neither in-memory genotypes nor a store")


def normalized_kernel(
    K_raw: np.ndarray, Z: Optional[np.ndarray] = None
) -> np.ndarray:
    """Mean-diagonal normalization of the raw MMt (+ Zᵀ record-level
    transform) — the shared prologue of every scan-level entry point."""
    s0 = float(np.mean(np.diag(K_raw)))
    K = K_raw / (s0 if s0 > 0 else 1.0)
    return Z @ K @ Z.T if Z is not None else K


class EigenBasis:
    """The kernel eigenbasis with a host- or device-resident U.

    Up to ``host_eigh_max_n`` U lives on the host in float64 (decision path
    exactness); above it U is computed AND kept on the device in float32,
    since all the host decision path needs of it are O(n·q) projections
    Uᵀ·v, which are device products here."""

    def __init__(self, d: np.ndarray, U_host: Optional[np.ndarray],
                 U_dev: Optional[torch.Tensor], device: torch.device):
        self.d = d
        self._U_host = U_host
        self._U_dev = U_dev
        self._device = torch.device(device)

    def project(self, M: np.ndarray) -> np.ndarray:
        """Uᵀ·M → host f64 (M is (n,) or (n, q) — small output); f32 on
        the device when U lives there."""
        if self._U_host is not None:
            return self._U_host.T @ M
        Md = torch.as_tensor(np.ascontiguousarray(M), dtype=torch.float32,
                             device=self._device)
        return (self._U_dev.T @ Md).cpu().numpy().astype(np.float64)

    def device_basis(self) -> torch.Tensor:
        if self._U_dev is None:
            self._U_dev = torch.as_tensor(self._U_host, dtype=torch.float32,
                                          device=self._device)
        return self._U_dev

    @property
    def host_f64(self) -> Optional[np.ndarray]:
        return self._U_host


# The largest n whose n × n f32 kernel torch.linalg.eigh decomposes on the
# card. Above it cuSOLVER's workspace query, cusolverDnXsyevd_bufferSize,
# returns CUSOLVER_STATUS_INVALID_VALUE (f32 and f64 alike), the error
# torch raises at n = 50 000. Bisected on an NVIDIA H100 80GB HBM3 (torch
# 2.11, CUDA 12.8) by scripts/eigh_limit_torch.py: the query over every n
# (26 733 works, asking 11.45 GB; 26 734 fails), then torch.linalg.eigh at
# 26 733 (8.9 s) and at 26 734, 32 767, 32 768, 40 000 and 46 340 (each
# refused).
DEVICE_EIGH_MAX_N = 26733
# the largest tridiagonal block eigh_large hands torch.linalg.eigh; bigger
# ones are split and merged. Measured at n = 50 000 on the H100 (the same
# script, --leaves): the divide and conquer and its last product take
# 15.2 / 15.3 / 16.0 / 23.3 s with leaves of 2 048 / 4 096 / 8 192 / 26 733
EIGH_LEAF_N = 4096
# columns of a Householder panel (stage a) and reflectors of a compact-WY
# block (stage c) in eigh_large
EIGH_PANEL = 128
# f64 elements of one block of the merge's secular work (roots × poles)
_SECULAR_BLOCK = 1 << 25
# the peak of the eigendecomposition above host_eigh_max_n on the device,
# in n × n f32 squares with K and U counted, measured on an NVIDIA H100 by
# scripts/eigh_limit_torch.py: torch.linalg.eigh 6.0 at n = 16 384 to
# 26 733 (cuSOLVER's workspace alone is 4 squares); eigh_large 2.5 at
# n = 50 000 (K, the merged factor and the halves' eigenvectors) and 3.0
# at 16 384, where its secular blocks weigh more beside the squares
EIGH_SQUARES_LIBRARY = 6
EIGH_SQUARES_ROUTE = 2.5


def eigh_basis(K: np.ndarray, config: EagleConfig,
               device) -> EigenBasis:
    """Eigendecomposition of the normalized kernel: host f64 LAPACK up to
    ``config.host_eigh_max_n``; above it f32 on ``device`` (U then never
    reaches the host): ``torch.linalg.eigh`` up to DEVICE_EIGH_MAX_N,
    :func:`eigh_large` above it. Eigenvalues are clipped at 0 (K is
    PSD)."""
    n = K.shape[0]
    if n <= config.host_eigh_max_n:
        d, U = np.linalg.eigh(K)
        return EigenBasis(np.maximum(d, 0.0), U, None, device)
    if n <= DEVICE_EIGH_MAX_N:
        d_dev, U_dev = torch.linalg.eigh(
            torch.as_tensor(K, dtype=torch.float32, device=device))
    else:
        d_dev, U_dev = eigh_large(
            torch.as_tensor(K, dtype=torch.float32, device=device),
            min(DEVICE_EIGH_MAX_N, EIGH_LEAF_N))
    d = np.maximum(d_dev.cpu().numpy().astype(np.float64), 0.0)
    return EigenBasis(d, None, U_dev, device)


def eigh_reserve(n: int, config: EagleConfig) -> int:
    """Device bytes the exact engine holds while it decomposes K: U alone
    when the host decomposes it (it reaches the device by
    ``set_eigenbasis``), else the measured peak of the route eigh_basis
    takes at n; eigh_large's also counts four f64 blocks of its secular
    work."""
    square = 4 * n * n
    if n <= config.host_eigh_max_n:
        return square
    if n <= DEVICE_EIGH_MAX_N:
        return EIGH_SQUARES_LIBRARY * square
    return int(EIGH_SQUARES_ROUTE * square + 4 * 8 * _SECULAR_BLOCK)


def _tridiagonalize(A: torch.Tensor, nb: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reduce the symmetric A (both triangles stored) to tridiagonal form
    A = Q·T·Qᵀ in place by blocked Householder (LAPACK's sytrd with latrd):
    a panel of ``nb`` columns at a time, each column one product with the
    trailing block (read as the block stood before the panel, its update
    applied to the vector), then the trailing block's rank-2·nb update.
    Reflector j, H_j = I − τ_j·v·vᵀ with v[0] = 1, is stored in row j right
    of the diagonal, A[j, j+1:] (column j by symmetry, which no later step
    reads), and A's diagonal becomes T's. A column with nothing left to
    annihilate but a nonzero subdiagonal gets τ = 2 (a sign flip, still
    orthogonal), one that is all zero τ = 0.

    Every column of a panel runs the same device ops on vectors of the
    panel's length, the column index a device scalar: on CUDA the first
    column runs as it comes and the others replay it as one CUDA graph, so
    that the host issues one launch a column, not some thirty. Returns the
    diagonal d, the off-diagonal e and τ, on A's device; nothing is read
    back to the host."""
    n, dev, dt = A.shape[0], A.device, A.dtype
    e = torch.empty(max(n - 1, 0), dtype=dt, device=dev)
    tau = torch.zeros(max(n - 1, 0), dtype=dt, device=dev)
    if dev.type == "cuda":
        # one side stream for every panel's capture (torch.cuda.graph's own
        # context would also collect garbage and empty the allocator's
        # cache at each panel); each graph's memory pool goes with it
        side = torch.cuda.Stream(dev)
    for j0 in range(0, n - 1, nb):
        jb = min(nb, n - 1 - j0)
        step, VW = _panel_step(A, j0, jb, e, tau)
        if dev.type == "cuda":
            main = torch.cuda.current_stream(dev)
            side.wait_stream(main)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                step()
                graph.capture_begin()
                step()
                graph.capture_end()
            main.wait_stream(side)
            for _ in range(jb - 1):
                graph.replay()
            del graph
        else:
            for _ in range(jb):
                step()
        V, W = VW[:, 0, jb:], VW[:, 1, jb:]
        trail = A[j0 + jb:, j0 + jb:]
        trail.addmm_(V.T, W, alpha=-1)
        trail.addmm_(W.T, V, alpha=-1)
    return A.diagonal().clone(), e, tau


def _panel_step(A: torch.Tensor, j0: int, jb: int, e: torch.Tensor,
                tau: torch.Tensor):
    """One column of the panel of ``jb`` columns at ``j0``, as a function
    of no arguments over fixed tensors (so that CUDA can replay it as a
    graph): column j = j0 + i, i the device counter it advances. Positions
    are local to rows j0:; the panel's reflectors v_k and their images w_k
    are kept side by side in VW (rows v_0, w_0, v_1, w_1, ...; zero until
    filled), so that k ≥ i add nothing. Returns (step, VW)."""
    n, dev, dt = A.shape[0], A.device, A.dtype
    m = n - j0
    rows = A[j0:j0 + jb, j0:]        # the panel's rows
    block = A[j0:, j0:]              # its rows ≤ i hold reflectors: masked
    VW = torch.zeros((jb, 2, m), dtype=dt, device=dev)
    P = VW.view(2 * jb, m)
    e_p, tau_p = e[j0:j0 + jb], tau[j0:j0 + jb]
    pos = torch.arange(m, device=dev)
    i = torch.zeros(1, dtype=torch.long, device=dev)

    def swap(c: torch.Tensor) -> torch.Tensor:
        """[a_0, b_0, a_1, b_1, ...] → [b_0, a_0, b_1, a_1, ...]."""
        return c.view(jb, 2).flip(1).reshape(2 * jb)

    def step() -> None:
        # column j as the panel's updates leave it: x −= Σ_k v_k·w_k[i] +
        # w_k·v_k[i] (row j by symmetry; positions < i are not used)
        x = torch.addmv(rows.index_select(0, i).view(m), P.T,
                        swap(VW.index_select(2, i).view(2 * jb)), alpha=-1)
        below = pos > i
        alpha = x.index_select(0, i + 1)
        beta = torch.copysign(torch.linalg.vector_norm(x * below),
                              alpha).neg_()
        live = beta != 0
        t = torch.where(live, 1 - alpha / beta, 0.0)
        v = (x * below) * torch.where(live, 1 / (alpha - beta), 0.0)
        v = v.index_fill(0, i + 1, 1.0)
        # row j keeps the updated diagonal and, right of it, v
        rows.index_copy_(0, i, (v + (pos == i) * x).view(1, m))
        # w = τ·(A·v − Σ_k v_k·(w_k·v) + w_k·(v_k·v)), then w −= τ/2·(w·v)·v
        w = torch.addmv(torch.mv(block, v), P.T, swap(P @ v), alpha=-1)
        w = w * below * t
        w = w - (0.5 * t * torch.dot(w, v)) * v
        VW.index_copy_(0, i, torch.stack([v, w]).view(1, 2, m))
        e_p.index_copy_(0, i, beta)
        tau_p.index_copy_(0, i, t)
        i.add_(1)

    return step, VW


def _apply_reflectors(A: torch.Tensor, tau: torch.Tensor, B: torch.Tensor,
                      nb: int) -> None:
    """B ← Q·B in place for the Q of :func:`_tridiagonalize` (reflectors
    in A's rows), ``nb`` reflectors at a time in compact-WY form,
    H_j0···H_j1−1 = I − Vᵀ·T·V, the last block first. T comes from its
    inverse, striu(V·Vᵀ) + diag(1/τ); a reflector with τ = 0 (the identity)
    has its row zeroed."""
    n = A.shape[0]
    for j0 in reversed(range(0, n - 1, nb)):
        j1 = min(j0 + nb, n - 1)
        t = tau[j0:j1]
        live = t != 0
        V = torch.triu(A[j0:j1, j0 + 1:]) * live[:, None]
        T_inv = torch.triu(V @ V.T, diagonal=1) + torch.diag(
            torch.where(live, 1.0 / t, torch.ones_like(t)))
        T = torch.linalg.solve_triangular(
            T_inv, torch.eye(j1 - j0, dtype=A.dtype, device=A.device),
            upper=True)
        Bs = B[j0 + 1:]
        Bs.addmm_(V.T, T @ (V @ Bs), alpha=-1)


def _secular_roots(dk: torch.Tensor, z2: torch.Tensor, rho: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The roots of 1 + ρ·Σ z_j²/(d_j − λ) (d strictly increasing, z ≠ 0,
    ρ > 0), one in each (d_i, d_i+1) and the last in (d_K, d_K + ρ·Σz²),
    as origin + offset: each root's origin is the nearer of its two poles
    (the sign of the function at the interval's middle says which), and
    the offset τ is bisected in the differences d_j − origin, so that
    d_j − λ = (d_j − origin) − τ keeps its relative accuracy near the
    poles. 100 halvings resolve an offset far below its interval's f64
    resolution, also for a root near a pole with a tiny z."""
    K = dk.shape[0]
    o = torch.empty_like(dk)
    tau = torch.empty_like(dk)
    top = rho * float(torch.sum(z2))
    rows = max(1, _SECULAR_BLOCK // K)
    for r0 in range(0, K, rows):
        i = torch.arange(r0, min(K, r0 + rows), device=dk.device)
        last = i == K - 1
        nxt = dk[torch.clamp(i + 1, max=K - 1)]
        half = torch.where(last, torch.full_like(nxt, top),
                           (nxt - dk[i]) / 2)
        delta = dk[None, :] - dk[i][:, None]
        g = 1 + rho * torch.sum(z2 / (delta - half[:, None]), dim=1)
        lower = last | (g > 0)
        oi = torch.where(lower, dk[i], nxt)
        lo = torch.where(lower, torch.zeros_like(half), -half)
        hi = torch.where(lower, half, torch.zeros_like(half))
        delta = dk[None, :] - oi[:, None]
        for _ in range(100):
            mid = (lo + hi) / 2
            g = 1 + rho * torch.sum(z2 / (delta - mid[:, None]), dim=1)
            pos = g > 0
            hi = torch.where(pos, mid, hi)
            lo = torch.where(pos, lo, mid)
        o[i], tau[i] = oi, (lo + hi) / 2
    return o, tau


def _secular_vectors(dk: torch.Tensor, zk: torch.Tensor, rho: float,
                     o: torch.Tensor, tau: torch.Tensor):
    """The merge's ẑ by Gu and Eisenstat's formula from the computed roots
    λ_i = o_i + τ_i, ẑ_k² = Π_i (λ_i − d_k) / (ρ·Π_j≠k (d_j − d_k)), each
    root paired with a pole so that every ratio lies in (0, 1]; the
    eigenvectors ẑ_j/(d_j − λ_i) are then orthogonal to working accuracy
    whatever the roots' own error. Returns a function of root indices
    giving those (K, c) unit columns."""
    K = dk.shape[0]
    logz2 = torch.empty_like(dk)
    rows = max(1, _SECULAR_BLOCK // K)
    i = torch.arange(K - 1, device=dk.device)
    for k0 in range(0, K, rows):
        k = torch.arange(k0, min(K, k0 + rows), device=dk.device)
        diff = (o[None, :] - dk[k][:, None]) + tau[None, :]   # λ_i − d_k
        den = torch.where(i[None, :] >= k[:, None], dk[None, 1:],
                          dk[None, :-1]) - dk[k][:, None]
        logz2[k] = (torch.log(diff[:, -1]) - math.log(rho)
                    + torch.sum(torch.log(diff[:, :-1] / den), dim=1))
    zhat = torch.copysign(torch.exp(logz2 / 2), zk)

    def columns(r: torch.Tensor) -> torch.Tensor:
        Y = zhat[:, None] / ((dk[:, None] - o[r][None, :]) - tau[r][None, :])
        return Y / torch.linalg.vector_norm(Y, dim=0, keepdim=True)

    return columns


def _tridiag_eigh(d: np.ndarray, e: np.ndarray, leaf: int,
                  device: torch.device, left=None
                  ) -> tuple[np.ndarray, torch.Tensor]:
    """Eigenpairs of the symmetric tridiagonal T (diagonal d, off-diagonal
    e; host f64) by Cuppen's divide and conquer: a block of at most
    ``leaf`` rows goes to f32 ``torch.linalg.eigh`` whole; a larger one is
    torn at its middle, T = diag(T1, T2) + ρ·u·uᵀ, both halves solved, and
    merged through the rank-one update (LAPACK's laed2/laed3/laed4 in f64
    on ``device``: deflation of small z and of near-equal poles by Givens
    rotations, the secular roots, Gu–Eisenstat vectors). Returns the
    ascending eigenvalues (host f64) and the f32 eigenvectors Q on
    ``device``. ``left``, when given, is applied in place to the rows of
    the last factor before the last product: Q = left(B)·Ŭ."""
    n = d.shape[0]
    if n <= leaf:
        T = torch.zeros((n, n), dtype=torch.float32, device=device)
        T.diagonal().copy_(torch.as_tensor(d))
        if n > 1:
            T.diagonal(1).copy_(torch.as_tensor(e))
            T.diagonal(-1).copy_(torch.as_tensor(e))
        lam, Q = torch.linalg.eigh(T)
        del T
        if left is not None:
            left(Q)
        return lam.double().cpu().numpy(), Q
    m = n // 2
    rho, sign = abs(e[m - 1]), (1.0 if e[m - 1] >= 0 else -1.0)
    d1, d2 = d[:m].copy(), d[m:].copy()
    d1[-1] -= rho
    d2[0] -= rho
    lam1, Q1 = _tridiag_eigh(d1, e[:m - 1], leaf, device)
    lam2, Q2 = _tridiag_eigh(d2, e[m:], leaf, device)
    # T = diag(T1, T2) + ρ·u·uᵀ with u = e_m + sign·e_m+1; in the halves'
    # eigenbases the update's vector is z = [last row of Q1, sign·first row
    # of Q2] (norm √2): scaled to norm 1, ρ doubles
    z = np.concatenate([Q1[-1].double().cpu().numpy(),
                        sign * Q2[0].double().cpu().numpy()]) / math.sqrt(2)
    B = torch.zeros((n, n), dtype=torch.float32, device=device)
    B[:m, :m] = Q1
    del Q1
    B[m:, m:] = Q2
    del Q2
    return _merge(np.concatenate([lam1, lam2]), z, 2.0 * rho, B, left)


def _merge(D: np.ndarray, z: np.ndarray, rho: float, B: torch.Tensor,
           left) -> tuple[np.ndarray, torch.Tensor]:
    """Eigenpairs of B·(diag(D) + ρ·z·zᵀ)·Bᵀ (‖z‖ = 1, B the halves'
    eigenvectors, rotated in place by the deflation): the eigenvalues
    ascending (host f64) and B·Ŭ (f32)."""
    n, device = D.shape[0], B.device
    perm = np.argsort(D, kind="stable")
    dd, zz = D[perm], z[perm]
    eps = np.finfo(np.float64).eps
    tol = 8.0 * eps * max(float(np.max(np.abs(dd))),
                          rho * float(np.max(np.abs(zz))))
    deflated = rho * np.abs(zz) <= tol
    pj = -1
    for j in np.flatnonzero(~deflated):
        if pj >= 0:
            r = math.hypot(zz[pj], zz[j])
            c, s = zz[j] / r, -zz[pj] / r
            if abs((dd[j] - dd[pj]) * c * s) <= tol:
                # a Givens rotation of columns pj, j moves z_pj into z_j;
                # pj leaves with the rotated diagonal
                zz[j], zz[pj] = r, 0.0
                a, b = int(perm[pj]), int(perm[j])
                Bpj = B[:, a].clone()
                B[:, a].mul_(c).add_(B[:, b], alpha=s)
                B[:, b].mul_(c).sub_(Bpj, alpha=s)
                dd[pj], dd[j] = (dd[pj] * c * c + dd[j] * s * s,
                                 dd[pj] * s * s + dd[j] * c * c)
                deflated[pj] = True
        pj = j
    keep = np.flatnonzero(~deflated)
    lam = dd.copy()
    if keep.size:
        dk = torch.as_tensor(dd[keep], device=device)
        zk = torch.as_tensor(zz[keep], device=device)
        o, tau = _secular_roots(dk, zk * zk, rho)
        lam[keep] = (o + tau).cpu().numpy()
        columns = _secular_vectors(dk, zk, rho, o, tau)
    # each eigenvalue's source: its secular root (≥ 0) or its deflated pole
    root = np.full(n, -1)
    root[keep] = np.arange(keep.size)
    order = np.argsort(lam, kind="stable")
    if left is not None:
        left(B)
    U = torch.empty((n, n), dtype=torch.float32, device=device)
    rows_k = torch.as_tensor(perm[keep], device=device)
    step = max(1, _SECULAR_BLOCK // max(keep.size, 1))
    for c0 in range(0, n, step):
        cols = order[c0:c0 + step]
        Y = torch.zeros((n, cols.size), dtype=torch.float64, device=device)
        r = root[cols]
        at = np.flatnonzero(r >= 0)
        if at.size:
            Y[rows_k[:, None], torch.as_tensor(at, device=device)[None, :]] \
                = columns(torch.as_tensor(r[at], device=device))
        flat = np.flatnonzero(r < 0)
        Y[torch.as_tensor(perm[cols[flat]], device=device),
          torch.as_tensor(flat, device=device)] = 1.0
        U[:, c0:c0 + cols.size] = B @ Y.float()
    return lam[order], U


def eigh_large(K: torch.Tensor, max_n: int, nb: int = EIGH_PANEL,
               stats: Optional[dict] = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(d, U) of the symmetric f32 K on its device, ascending like
    ``torch.linalg.eigh``, with no library call on a block larger than
    ``max_n``: (a) Householder tridiagonalisation in place
    (:func:`_tridiagonalize`, panels of ``nb``), (b) the tridiagonal
    problem by divide and conquer (:func:`_tridiag_eigh`, leaves of at most
    ``max_n`` to ``torch.linalg.eigh``, merges in f64), (c) the reflectors
    applied to the last merge's factor in compact-WY blocks
    (:func:`_apply_reflectors`). K is overwritten, and released once (c)
    has read it when the caller holds no other reference. Products run in
    IEEE fp32. ``stats``, when given, receives each stage's seconds (the
    device synchronised at their edges)."""
    device = K.device
    if device.type == "cuda":
        _ieee_fp32()

    mark = [time.perf_counter()]

    def lap(name: str) -> None:
        if stats is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            now = time.perf_counter()
            stats[name] = now - mark[0]
            mark[0] = now

    d, e, tau = _tridiagonalize(K, nb)
    held = [K]
    del K
    lap("tridiagonal_s")

    def left(B: torch.Tensor) -> None:
        lap("divide_conquer_s")
        _apply_reflectors(held.pop(), tau, B, nb)
        lap("back_transform_s")

    lam, U = _tridiag_eigh(d.double().cpu().numpy(),
                           e.double().cpu().numpy(), max_n, device, left)
    lap("last_product_s")
    return torch.as_tensor(lam, device=device), U


def eig_residuals(K: torch.Tensor, d: torch.Tensor, U: torch.Tensor,
                  block: int = 4096) -> tuple[float, float]:
    """(‖KU − UΛ‖_F / ‖K‖_F, ‖UᵀU − I‖_F / √n) of an eigendecomposition,
    in K's dtype on K's device, a column block of U at a time."""
    n = K.shape[0]
    dd = d.to(K.dtype)
    rr = oo = 0.0
    for c0 in range(0, n, block):
        Ub = U[:, c0:c0 + block]
        rr += float(torch.sum((K @ Ub - Ub * dd[c0:c0 + block]) ** 2))
        G = U.T @ Ub
        G[c0:c0 + Ub.shape[1]].diagonal().sub_(1.0)
        oo += float(torch.sum(G * G))
    kk = sum(float(torch.sum(K[r0:r0 + block].double() ** 2))
             for r0 in range(0, n, block))
    return math.sqrt(rr / kk), math.sqrt(oo / n)


def _eigh_kernel(K: np.ndarray, config: EagleConfig,
                 device) -> tuple[np.ndarray, np.ndarray]:
    """(d, U_host) for callers that need U on the host: host LAPACK up to
    ``host_eigh_max_n``; above it the f32 eigenvectors computed on
    ``device`` are pulled back as f64. Prefer :func:`eigh_basis`."""
    basis = eigh_basis(K, config, device)
    U = basis.host_f64
    if U is None:
        U = basis.device_basis().cpu().numpy().astype(np.float64)
    return basis.d, U


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


def _stats_from_D_multi(D: torch.Tensor, Minv: torch.Tensor, q: int,
                        R: int) -> torch.Tensor:
    """R traits' statistics from one wide dot block D ((p, R·(1+q+r)), on
    the device; Minv (R, q, q)): (p, R·(q+3)) rows [â, u, diag, proj] a
    trait (reference: engine_jax._stats_from_D_multi_jit)."""
    c = D.shape[1] // R
    D3 = D.reshape(D.shape[0], R, c)
    ahat = D3[:, :, :1]
    U = D3[:, :, 1 : 1 + q]
    WHZ = D3[:, :, 1 + q :]
    diag = torch.sum(WHZ * WHZ, dim=2, keepdim=True) / WHZ.shape[2]
    proj = torch.einsum("jtq,tqk,jtk->jt", U, Minv, U)[..., None]
    return torch.cat([ahat, U, diag, proj], dim=2).reshape(D.shape[0],
                                                          R * (q + 3))


# columns of one matfree_stat_rows_multi pass (the reference's default
# width cap): R traits' blocks are sub-batched under it
MULTI_STAT_COLS = 640


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


def _kernel_apply(kv, n: int, V: torch.Tensor,
                  z_idx: Optional[torch.Tensor]) -> torch.Tensor:
    """K·V by ``kv`` (the device kernel matvec, TiledScan._device_kv: one
    launch each of packed_dot and packed_tdot); with the record →
    individual index ``z_idx`` of a 0/1 incidence Z, the record-space
    Z·K·Zᵀ·V: Zᵀ·V is a segment sum (``index_add_``, atomics on CUDA, so
    not bitwise repeatable with repeated records) and Z·U a gather."""
    if z_idx is None:
        return kv(V)
    Vi = torch.zeros((n, V.shape[1]), dtype=V.dtype,
                     device=V.device).index_add_(0, z_idx, V)
    return kv(Vi)[z_idx]


def _cg_step(matvec, X, R, P, rs, thresh, delta):
    """One CG iteration on H = matvec + δI (``matvec`` applies K/s0, in
    record space with a Zmat) with the block state on the device;
    converged columns are frozen (α = β = 0)."""
    active = rs > thresh
    HP = matvec(P) + delta * P
    pHp = torch.sum(P * HP, dim=0)
    zero = torch.zeros_like(rs)
    alpha = torch.where(active & (pHp > 0), rs / pHp.clamp(min=1e-30), zero)
    X = X + P * alpha[None, :]
    R = R - HP * alpha[None, :]
    rs_new = torch.sum(R * R, dim=0)
    beta = torch.where(active, rs_new / rs.clamp(min=1e-30), zero)
    P = R + P * beta[None, :]
    return X, R, P, rs_new


def _lanczos_step(matvec, basis: torch.Tensor, V: torch.Tensor,
                  V_prev: torch.Tensor, beta_prev: torch.Tensor,
                  reorth: bool):
    """One batched Lanczos step on the device (reference: the body of
    engine_jax._lanczos_chunk_steps). ``basis`` (r, k+1, n) holds the
    vectors built so far, V (n, r) the newest; returns (α, β, next V).

    Breakdown guard: β at the f32 roundoff floor means the column reached
    an invariant subspace (e.g. a rank-deficient Z·K·Zᵀ); the next vector
    is zeroed there, not divided by ~0, so the tridiagonal decouples and
    the space already built stays exact."""
    Hv = matvec(V)
    alpha = torch.sum(V * Hv, dim=0)
    Wv = Hv - V * alpha[None, :] - V_prev * beta_prev[None, :]
    if reorth:
        # full reorthogonalisation against the built basis, one batched
        # product a column: coef (r, k+1) = basis · w, w -= basisᵀ · coef
        coef = torch.bmm(basis, Wv.T[:, :, None])
        Wv = Wv - torch.bmm(basis.transpose(1, 2), coef)[:, :, 0].T
    beta = torch.linalg.vector_norm(Wv, dim=0)
    ok = beta > 1e-5 * (torch.abs(alpha) + beta_prev + 1e-3)
    beta = torch.where(ok, beta, torch.zeros_like(beta))
    Vn = torch.where(ok[None, :], Wv / beta.clamp(min=1e-30)[None, :],
                     torch.zeros_like(Wv))
    return alpha, beta, Vn


def _ieee_fp32() -> None:
    """IEEE fp32 on the card: no TF32 in any matmul or convolution (the
    kernels, the exact engine's products and the decision path's inputs
    are full fp32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# the widest block a Krylov step holds and K3 runs at: one 144-wide column
# tile of the kernels (mma_tile_width in ops/csrc/packed_common.cuh), which
# takes the 128 probe columns of the sweep and every narrower block
KRYLOV_COLS = 144
# results a pass gathers for every SNP, f32 (the stat rows of every trait,
# joined in chunk order, or the exact engine's batched scores), counted in
# the reserve
RESULT_COLS = 64


class StackPlan(NamedTuple):
    """Where the packed stack lives (:func:`_stack_plan`)."""

    mode: str            # "resident" or "streamed"
    chunk_rows: int      # stack rows a pass hands the kernels at once
    slots: int           # device chunk buffers of the ring (streamed)
    free_bytes: int      # device memory the gate saw free (0 on the CPU)
    reserve_bytes: int   # what a scan holds beside a resident stack
    # the widest K1 block of a stat-row pass (matfree_stat_rows_multi
    # sub-batches its traits under it); 0 for the exact engine
    stat_cols: int = MULTI_STAT_COLS
    # where a pass reads the stack from: "device" (resident), "pinned" (the
    # whole stack in page-locked host memory) or "store" (the source, read
    # anew every pass through two page-locked staging buffers)
    host: str = "pinned"


def stack_reserve(n: int, p: int, config: EagleConfig, sms: int,
                  cache_device: bool, stat_cols: int,
                  tile_snps: int, int8_rows: bool = False
                  ) -> tuple[int, int]:
    """Device bytes a scan holds beside the packed stack, as (fixed, a
    row): the fixed part does not depend on how many stack rows a pass
    hands the kernels at once, the other grows with them (all p rows when
    the stack is resident, one chunk when it streams). ``stat_cols`` is
    the widest K1 block of the matrix-free scan's stat-row passes, 0 for
    the exact engine, which runs neither K1 nor K2 and holds no Krylov
    state. ``int8_rows``: the stack streams from a source of int8 rows,
    which are packed on the device. Read off the code:

    fixed, every scan
      - the per-SNP means and up to RESULT_COLS f32 results a SNP;
    fixed, the matrix-free engine (``stat_cols`` > 0)
      - the Krylov bases, (r_pad, m, n) f32 on the device
        (``device_lanczos``): one basis that ShiftedKrylov caches (its f64
        count is held to ``matfree_cache_gb``, so its f32 to half of it),
        and the probe basis of ``isqrt_probes`` (``matfree_diag_probes``
        columns, ``matfree_lanczos_m`` deep), cached or not;
      - eight (n, KRYLOV_COLS) f32 blocks: the CG's X, R, P and H·P with
        the step's temporaries, the Lanczos V, V_prev and W;
      - K1's operand at ``stat_cols`` f32 columns and its three bf16
        pieces;
      - K2's split partials, (nsplit, n, KRYLOV_COLS) f32, nsplit as
        ``ee_packed_tdot_splits`` bounds it for ``sms`` SMs (sixteen
        128-row blocks an SM, at most 64);
    fixed, the exact engine (``stat_cols`` = 0)
      - one n×n f32 matrix: K while MMt accumulates, then the eigenbasis
        U (``set_eigenbasis``); above ``host_eigh_max_n``, where the
        eigendecomposition runs on the device, its measured peak
        (:func:`eigh_reserve`: K, U and what the route needs beside them);
      - one tile's recoded W (compute_dtype), its image T (f32, or the
        Lp-form sweep's W·L) and the scorer's two tile-sized f32
        temporaries (T∘s and its square in ``score_from_T``, the square
        of W·L in ``score_tile_sqrt``);
      - the unpack's temporaries, a row chunk of the tile at a time
        (packed.recode: the chunk's bytes as int64, the table's gathered
        f32 codes, their NaN mask and the imputed values: 96·nw + 5·n
        bytes a row);
      - the W and T caches when ``cache_device`` holds (both while T is
        built);
    a row, the matrix-free engine
      - K1's output, at ``stat_cols`` or at KRYLOV_COLS as K3's first
        half, and the stat rows' reduction of it: two f32 rows;
      - K2's two bf16 pieces of its operand at KRYLOV_COLS.
    The exact engine holds nothing a row beyond the stack itself.
    a row, either engine, with ``int8_rows``
      - the chunk's int8 slot (n bytes) and the pack's temporaries
        (genostore.pack2_words: at most three bytes a genotype of the row
        padded to its words, 48·nw).

    At 50 000 × 262 144 the matrix-free reserve is 2.82 GB fixed and
    5.7 kB a row at ``stat_cols`` = MULTI_STAT_COLS (4.31 GB with the rows
    of a resident stack), 2.57 GB and 1.7 kB a row at KRYLOV_COLS (3.02
    GB), against the 1.80 GB beside the stack at which the smoke's
    single-trait matrix-free am() peaks."""
    itemsize = 2 if config.compute_dtype == "bfloat16" else 4
    fixed = p * (1 + RESULT_COLS) * 4
    int8_row = n + 48 * packed.words_per_row(n) if int8_rows else 0
    if not stat_cols:
        unpack_rows = min(packed.unpack_chunk_rows(n), tile_snps)
        fixed += (eigh_reserve(n, config)
                  + tile_snps * n * (itemsize + 3 * 4)
                  + unpack_rows * (96 * packed.words_per_row(n) + 5 * n))
        if cache_device:
            fixed += p * n * (itemsize + 4)
        return int(fixed), int8_row
    cache = config.matfree_cache_gb * 1e9 / 2
    probes = (-(-config.matfree_diag_probes // 8) * 8
              * config.matfree_lanczos_m * n * 4)
    nsplit = min(64, -(-16 * sms // -(-n // 128)))
    fixed += (cache + max(cache, probes)
              + 8 * n * KRYLOV_COLS * 4
              + n * stat_cols * (4 + 3 * 2)
              + nsplit * n * KRYLOV_COLS * 4)
    per_row = (2 * max(stat_cols, KRYLOV_COLS) * 4 + 2 * KRYLOV_COLS * 2
               + int8_row)
    return int(fixed), per_row


def _whole_chunk(rows: int, tile_snps: int) -> int:
    """``rows`` rounded down to whole tiles, or to 128 rows when not one
    tile fits."""
    return (rows // tile_snps * tile_snps if rows >= tile_snps
            else rows // 128 * 128)


def _stack_plan(p: int, nw: int, n: int, device: torch.device,
                config: EagleConfig, tile_snps: int, cache_device: bool,
                matfree: bool, row_format: str = "raw") -> StackPlan:
    """Resident or streamed, the chunk of a streamed stack, and where a
    streamed stack is read from.

    Resident when the stack and the scan's reserve (:func:`stack_reserve`)
    fit the card's free memory: ``torch.cuda.mem_get_info``'s free plus
    what the caching allocator holds unallocated, so a later scan of a
    process whose blocks are cached takes the same decision. The
    matrix-free reserve is tried at two widths of the stat-row passes:
    MULTI_STAT_COLS, where ``am_multi`` scans several traits in one pass,
    then KRYLOV_COLS, where it takes a pass a trait (the single-trait
    block, 1 + q8 + 128 columns, fits it up to q = 8 fixed effects) and
    the stack still stays. Otherwise the stack streams, at the narrower
    width, through a ring of 3 (else 2) chunk buffers that fit beside the
    fixed reserve, a chunk a multiple of ``tile_snps`` rows (of 128 when
    not even one tile fits), so that the exact engine's W tiles fall as
    they do on a resident stack. On the CPU the stack is always resident.

    A streamed stack lives in page-locked host memory ("pinned") when its
    p·nw·4 bytes fit ``config.availmem_gb``. Otherwise ("store") every
    pass reads it from the source (TileSource.read_rows, in its
    ``row_format``) into two page-locked staging buffers of a chunk each,
    which must fit ``availmem_gb`` too: the chunk shrinks, in the same
    whole units, until they do. Int8 rows are packed on the device, so
    their slot and the pack's temporaries count a row there. Raises when
    not even two 128-row chunks fit the card, or two 128-row staging
    buffers the host budget."""
    if device.type != "cuda":
        return StackPlan("resident", p, 0, 0, 0, host="device")
    free, _ = torch.cuda.mem_get_info(device)
    free += (torch.cuda.memory_reserved(device)
             - torch.cuda.memory_allocated(device))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    row = nw * 4
    for width in ((MULTI_STAT_COLS, KRYLOV_COLS) if matfree else (0,)):
        fixed, per_row = stack_reserve(n, p, config, sms, cache_device,
                                       width, tile_snps)
        reserve = fixed + per_row * p
        if p * row + reserve <= free:
            return StackPlan("resident", p, 0, free, reserve, width,
                             "device")
    budget = int(config.availmem_gb * 1e9)
    host, staged = "pinned", p
    if p * row > budget:
        host = "store"
        stage_row = row if row_format == "raw" else n
        staged = _whole_chunk(budget // (2 * stage_row), tile_snps)
        if staged < 128:
            raise ValueError(
                f"the packed stack of {n} individuals x {p} SNPs "
                f"({p * row / 1e9:.3f} GB) exceeds availmem_gb "
                f"({config.availmem_gb} GB), and the two staging buffers "
                f"of 128 rows that read it from the store need "
                f"{2 * 128 * stage_row / 1e9:.3f} GB of it")
        if row_format != "raw":
            fixed, per_row = stack_reserve(n, p, config, sms, cache_device,
                                           width, tile_snps, True)
    for slots in (3, 2):
        c = _whole_chunk(max(free - fixed, 0) // (slots * row + per_row),
                         tile_snps)
        if c >= 128:
            return StackPlan("streamed", min(c, staged, p), slots, free,
                             reserve, width, host)
    raise ValueError(
        f"the packed stack of {n} individuals x {p} SNPs "
        f"({p * row / 1e9:.3f} GB) can neither stay on {device} nor stream "
        f"through it: {free / 1e9:.3f} GB free, {fixed / 1e9:.3f} GB of it "
        f"held for the scan, and two chunks of 128 rows need "
        f"{2 * 128 * row / 1e9:.3f} GB more")


class _StoreReader:
    """The producer of one pass over a stack read from its source
    (reference: engine_jax.TiledScan._device_tiles' producer thread and its
    queue of 2): a thread reads each chunk's rows [lo, hi) into a free one
    of the two staging buffers (TileSource.read_rows) and hands its index
    over, in chunk order. It makes no CUDA call but one: before it refills
    a buffer it waits for the event of the copy that last read it
    (``done``, set by :meth:`release` and kept by the scan across passes).
    An exception in the thread is raised by :meth:`get` in the caller;
    :meth:`close` stops the thread and joins it, also mid-pass."""

    def __init__(self, src: TileSource, staging: list[torch.Tensor],
                 done: list, ranges: list[tuple[int, int]]):
        self.read_bytes = 0
        self.read_s = 0.0
        self._src, self._staging, self._done = src, staging, done
        self._raw = src.row_format == "raw"
        self._row_bytes = -(-src.n // 4) if self._raw else src.n
        self._full: queue.Queue = queue.Queue()
        self._free: queue.Queue = queue.Queue()
        for i in range(len(staging)):
            self._free.put(i)
        self._stop = False
        self._thread = threading.Thread(target=self._run, args=(ranges,),
                                        name="eagle-store-reader",
                                        daemon=True)
        self._thread.start()

    def _run(self, ranges) -> None:
        try:
            for lo, hi in ranges:
                i = self._free.get()
                if i is None or self._stop:
                    return
                if self._done[i] is not None:
                    self._done[i].synchronize()
                t0 = time.perf_counter()
                buf = self._staging[i][: hi - lo]
                self._src.read_rows(lo, hi,
                                    buf.view(torch.uint8) if self._raw
                                    else buf)
                self.read_s += time.perf_counter() - t0
                self.read_bytes += (hi - lo) * self._row_bytes
                self._full.put(i)
        except BaseException as e:   # surfaced to the caller by get()
            self._full.put(e)

    def get(self) -> int:
        """The staging buffer that holds the next chunk."""
        item = self._full.get()
        if isinstance(item, BaseException):
            raise item
        return item

    def release(self, i: int, done) -> None:
        """Hand buffer ``i`` back; ``done`` (a CUDA event, or None) is
        complete once nothing reads the buffer any more."""
        self._done[i] = done
        self._free.put(i)

    def close(self) -> None:
        self._stop = True
        self._free.put(None)
        self._thread.join()


class TiledScan:
    """Single-device backend over the packed stack (reference: the
    per-iteration ReadBlock sweep of ``calculate_a_and_vara_rcpp``,
    SURVEY.md §4.2, with device memory standing in for disk): the
    matrix-free engine's kernel passes, and the exact engine's MMt and
    eigenbasis sweeps over recoded W tiles.

    The stack stays on the card when it fits beside what the scan holds
    there (:func:`_stack_plan`); otherwise every pass streams it through
    the card chunk by chunk (:meth:`_stack_chunks`), K1/K2 running on each
    chunk while the next is copied: from page-locked host memory when the
    whole stack fits ``availmem_gb``, else read anew from the source on
    every pass, as the reference does, through two page-locked staging
    buffers. Every primitive reads the stack through that one iterator,
    so the engines above run unchanged on either. ``matfree`` says which
    engine reads it, so that the gate reserves what that engine holds
    beside the stack. The decision (``plan``, ``stack_mode``,
    ``chunk_rows``) and the streaming counters (``stream_passes``,
    ``h2d_bytes``, ``read_bytes``, ``read_s``) are attributes and go to
    the scan log (:meth:`stack_info`)."""

    def __init__(self, src: TileSource, config: EagleConfig,
                 device: torch.device, matfree: bool = True):
        self.src = src
        self.config = config
        self.device = torch.device(device)
        # observability: full passes over the genotype rows (matvecs,
        # CG steps, stat rows)
        self.stack_passes = 0
        self.tile_snps = config.resolve_snp_tile(src.n,
                                                 -(-src.p // 128) * 128)
        self.nw = packed.words_per_row(src.n)
        # the exact engine keeps its recoded W tiles, then their eigenbasis
        # images T, on the device when p·n of them fit half of
        # device_cache_gb; otherwise every sweep recodes W from the stack
        # and recomputes T
        itemsize = 2 if config.compute_dtype == "bfloat16" else 4
        self.cache_device = (src.p * src.n * itemsize
                             <= config.device_cache_gb * 1e9 * 0.5)
        self._wcache: Optional[list[tuple[int, torch.Tensor]]] = None
        self._tcache: Optional[list[tuple[int, torch.Tensor]]] = None
        self._U_dev: Optional[torch.Tensor] = None
        if self.device.type == "cuda":
            _ieee_fp32()
        self.plan = _stack_plan(src.p, self.nw, src.n, self.device, config,
                                self.tile_snps, self.cache_device, matfree,
                                src.row_format)
        # passes through the chunk ring, and the bytes they copied to the
        # card (0 on the CPU, where a chunk is a host tensor); the bytes the
        # store reader read from the source and its seconds
        self.stream_passes = 0
        self.h2d_bytes = 0
        self.read_bytes = 0
        self.read_s = 0.0
        self.build_s: Optional[float] = None
        self._pstack: Optional[torch.Tensor] = None
        self._pmeans: Optional[torch.Tensor] = None
        self._ring: Optional[list[torch.Tensor]] = None
        self._copy_stream = None
        self._freed: list = []
        self._slot = 0
        # the store reader's two page-locked staging buffers, the events of
        # the copies that last read them, and on a card the int8 slot of a
        # source of int8 rows and the event of the pack that last read it
        self._staging: Optional[list[torch.Tensor]] = None
        self._staged: list = [None, None]
        self._int8_slot: Optional[torch.Tensor] = None
        self._int8_freed = None
        self._score = (kernels.score_tile_sqrt_bf16
                       if config.compute_dtype == "bfloat16"
                       else kernels.score_tile_sqrt)

    @property
    def stack_mode(self) -> str:
        return self.plan.mode

    @property
    def chunk_rows(self) -> int:
        return self.plan.chunk_rows

    def _build_stack(self, dest: torch.Tensor) -> None:
        """Fill ``dest`` ((p, ⌈⌈n/4⌉/4⌉) int32, on the device or on the
        host) with the source tile by tile: the little-endian word view of
        the 2-bit byte stream (word w holds genotypes 16w+k at bits 2k),
        bytes past a row's ⌈n/4⌉ set to 0x55 (het codes → W = 0)."""
        nw = self.nw
        for j0, raw in self.src.packed_tiles(self.tile_snps):
            # uint8 (b, nb) tile → little-endian int32 (b, nw) words (the
            # host is little-endian, so a view is the right bits)
            wb = np.full((raw.shape[0], nw * 4), 0x55, dtype=np.uint8)
            wb[:, : raw.shape[1]] = raw
            dest[j0 : j0 + raw.shape[0]] = torch.from_numpy(wb.view(np.int32))

    def _page_locked(self, what: str, shape: tuple[int, int],
                     dtype: torch.dtype) -> torch.Tensor:
        """An uninitialised host tensor, page-locked on a card (the copies
        from it are then asynchronous DMA; from pageable memory each would
        be a synchronous copy); a failed pin raises ValueError with the
        sizes."""
        try:
            return torch.empty(shape, dtype=dtype,
                               pin_memory=self.device.type == "cuda")
        except RuntimeError as e:
            unit = "words" if dtype == torch.int32 else "bytes"
            size = shape[0] * shape[1] * dtype.itemsize
            raise ValueError(
                f"could not allocate the page-locked {what} of {shape[0]} "
                f"SNPs x {shape[1]} {unit} ({size / 1e9:.3f} GB) to stream "
                f"from: {e}") from e

    def _packed_stack(self) -> Optional[torch.Tensor]:
        """The whole source as ONE (p, ⌈⌈n/4⌉/4⌉) int32 stack, built once:
        on the device when resident (into a preallocated buffer, so peak
        device memory is 1× the packed size), in page-locked host memory
        when it streams from there (a failed pin raises ValueError with the
        sizes), and not at all when every pass reads it from the source
        (None). The per-SNP means are computed with it and stay on the
        device; a streamed stack computes them chunk by chunk, in one pass
        through the ring. ``build_s`` times it all."""
        if self._pmeans is not None:
            return self._pstack
        t0 = time.perf_counter()
        p, n = self.src.p, self.src.n
        if self.stack_mode == "resident":
            buf = torch.full((p, self.nw), packed.PAD_WORD,
                             dtype=torch.int32, device=self.device)
            self._build_stack(buf)
            self._pstack = buf
            self._pmeans = packed.row_means(buf, n)
        else:
            if self.plan.host == "pinned":
                buf = self._page_locked("host stack", (p, self.nw),
                                        torch.int32)
                self._build_stack(buf)
                self._pstack = buf
            means = torch.empty(p, dtype=torch.float32, device=self.device)
            for r0, Wc in self._chunks():
                means[r0 : r0 + Wc.shape[0]] = packed.row_means(Wc, n)
            self._pmeans = means
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.build_s = time.perf_counter() - t0
        return self._pstack

    def _stack_chunks(self) -> Iterator[tuple[int, torch.Tensor]]:
        """(row0, Wp chunk) over the stack, in row order: the unit every
        pass reads (the stack and its means are built first). Resident:
        one chunk, the stack itself, no copy. A chunk is valid until the
        consumer asks for the next one."""
        self._packed_stack()
        yield from self._chunks()

    def _chunks(self) -> Iterator[tuple[int, torch.Tensor]]:
        """One pass over the stack, as :meth:`_stack_chunks` hands it out.

        Streamed on a card (reference: engine_jax.TiledScan._device_tiles'
        producer thread and queue of 2): each chunk's host rows — a row
        slice of the page-locked stack, or a staging buffer the store
        reader (:class:`_StoreReader`) filled on its thread — are copied
        into ring slot i mod k on a copy stream when the consumer asks for
        chunk i, so the copy runs under the kernels of chunk i - 1. A slot
        is overwritten only after an event that the compute stream records
        once the last launch reading it is queued (when the consumer asks
        for the next chunk); the compute stream waits on the copy's event
        before the kernels read it, and a staging buffer goes back to the
        reader with that event, which the reader waits for before it
        refills the buffer. Int8 rows are copied into one int8 slot
        instead and packed into the ring slot on the compute stream
        (genostore.pack2_words), the copy into the int8 slot waiting for
        the pack that last read it. The ring is allocated once on the
        compute stream, and every copy that was issued is waited for by
        the compute stream before the consumer sees its chunk, so the
        allocator can never hand a slot on while a copy still writes it.
        Slots rotate across passes, so a pass's first copy waits only for
        the compute that last read its slot. The last chunk is ragged; row
        slices of the contiguous buffers are contiguous, as the kernels'
        wrappers require. On the CPU a chunk is the host tensor itself (or
        its words, packed on the host). The reader's thread ends with the
        pass, also when the consumer stops early or it raised.

        ``stream_passes`` counts the passes that reached the end;
        ``h2d_bytes`` the bytes copied to the card; ``read_bytes`` and
        ``read_s`` what the reader read from the source, and its time."""
        if self.stack_mode == "resident":
            yield 0, self._pstack
            return
        p, C = self.src.p, self.chunk_rows
        starts = range(0, p, C)
        cuda = self.device.type == "cuda"
        int8 = self.plan.host == "store" and self.src.row_format != "raw"
        reader = None
        if self.plan.host == "store":
            if self._staging is None:
                self._staging = [
                    self._page_locked("staging buffer", (C, self.src.n),
                                      torch.int8) if int8 else
                    self._page_locked("staging buffer", (C, self.nw),
                                      torch.int32).fill_(packed.PAD_WORD)
                    for _ in range(2)]
            reader = _StoreReader(self.src, self._staging, self._staged,
                                  [(r0, min(r0 + C, p)) for r0 in starts])
        if cuda and self._ring is None:
            self._ring = [torch.empty((C, self.nw), dtype=torch.int32,
                                      device=self.device)
                          for _ in range(self.plan.slots)]
            if int8:
                self._int8_slot = torch.empty((C, self.src.n),
                                              dtype=torch.int8,
                                              device=self.device)
            self._copy_stream = torch.cuda.Stream(self.device)
            self._freed = [None] * self.plan.slots
        compute = torch.cuda.current_stream(self.device) if cuda else None
        try:
            for i, r0 in enumerate(starts):
                rows = min(C, p - r0)
                b = None
                if reader is None:
                    host = self._pstack[r0 : r0 + rows]
                else:
                    b = reader.get()
                    host = self._staging[b][:rows]
                if cuda:
                    s = (self._slot + i) % len(self._ring)
                    chunk = self._ring[s][:rows]
                    done = self._h2d(host, chunk, s, int8)
                    if b is not None:
                        reader.release(b, done)
                elif int8:
                    chunk = genostore.pack2_words(host, self.nw)
                    reader.release(b, None)
                else:
                    # the consumer reads the staging buffer itself: it goes
                    # back to the reader when the next chunk is asked for
                    chunk = host
                try:
                    yield r0, chunk
                finally:
                    if cuda:
                        freed = torch.cuda.Event()
                        freed.record(compute)
                        self._freed[s] = freed
                    elif b is not None and not int8:
                        reader.release(b, None)
        finally:
            if reader is not None:
                reader.close()
                self.read_bytes += reader.read_bytes
                self.read_s += reader.read_s
            if cuda:
                self._slot = (self._slot + len(starts)) % len(self._ring)
        self.stream_passes += 1

    def _h2d(self, host: torch.Tensor, chunk: torch.Tensor, s: int,
             int8: bool):
        """Copy a chunk's page-locked host rows to the card on the copy
        stream, into ``chunk`` (ring slot ``s``) once the compute that last
        read the slot is done; int8 rows into the int8 slot once the pack
        that last read it is done, then packed into ``chunk`` on the
        compute stream. The compute stream waits for the copy; returns the
        copy's event."""
        compute = torch.cuda.current_stream(self.device)
        copy = self._copy_stream
        dest = self._int8_slot[: host.shape[0]] if int8 else chunk
        after = self._int8_freed if int8 else self._freed[s]
        with torch.cuda.stream(copy):
            if after is not None:
                copy.wait_event(after)
            dest.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy)
        self.h2d_bytes += host.numel() * host.element_size()
        compute.wait_event(done)
        if int8:
            genostore.pack2_words(dest, self.nw, out=chunk)
            self._int8_freed = torch.cuda.Event()
            self._int8_freed.record(compute)
        return done

    def stack_info(self) -> dict:
        """The gate's decision and the streaming counters (for the scan
        log: ``build_s`` is the stack's build, pinning included;
        ``host_bytes`` the host memory the scan holds for the stack —
        the pinned stack or the two staging buffers, page-locked on a
        card)."""
        held = list(self._staging or [])
        if self.plan.host == "pinned" and self._pstack is not None:
            held.append(self._pstack)
        return {"mode": self.stack_mode, "host": self.plan.host,
                "rows": self.src.row_format,
                "chunk_rows": self.chunk_rows,
                "chunks": -(-self.src.p // self.chunk_rows),
                "slots": self.plan.slots,
                "stack_bytes": self.src.p * self.nw * 4,
                "free_bytes": self.plan.free_bytes,
                "reserve_bytes": self.plan.reserve_bytes,
                "build_s": self.build_s,
                "stream_passes": self.stream_passes,
                "h2d_bytes": self.h2d_bytes,
                "read_bytes": self.read_bytes, "read_s": self.read_s,
                "host_bytes": sum(t.numel() * t.element_size()
                                  for t in held)}

    def _to_device(self, V: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(V), dtype=torch.float32,
                               device=self.device)

    @staticmethod
    def _to_host(T: torch.Tensor) -> np.ndarray:
        return T.cpu().numpy().astype(np.float64)

    def _means(self, r0: int, Wc: torch.Tensor) -> torch.Tensor:
        return self._pmeans[r0 : r0 + Wc.shape[0]]

    def _local_kv(self, V: torch.Tensor) -> torch.Tensor:
        """MMt·V = Σ_c W_cᵀ(W_c·V) over the stack's chunks (K1 then K2 on
        each; one chunk when resident), summed in chunk order into one
        (n, r) f32 block, so the result is bitwise repeatable."""
        out = None
        for r0, Wc in self._stack_chunks():
            KV = packed.kernel_matvec(Wc, V, self._means(r0, Wc), self.src.n)
            out = KV if out is None else out.add_(KV)
        return out

    def _by_rows(self, fn) -> torch.Tensor:
        """``fn(means, chunk)`` on each chunk of the stack, a block of the
        chunk's rows each, joined in row order."""
        parts = [fn(self._means(r0, Wc), Wc)
                 for r0, Wc in self._stack_chunks()]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def kernel_matvec(self, V: np.ndarray) -> np.ndarray:
        """Raw-kernel matvec MMt·V (V (n, r)) — K is never materialized."""
        self.stack_passes += 1
        return self._to_host(self._local_kv(self._to_device(V)))

    def _device_kv(self, V: torch.Tensor) -> torch.Tensor:
        """MMt·V on the device, V (n, r) a device tensor: the unit of every
        device CG and Lanczos step."""
        return self._local_kv(V)

    def _h_apply_host(self, X: np.ndarray, delta, s0: float,
                      z_idx: Optional[np.ndarray] = None) -> np.ndarray:
        """H·X for warm-start residuals — record space when a Zmat index is
        given (H = Z·K·Zᵀ/s0 + δI), else individual space."""
        if z_idx is None:
            return self.kernel_matvec(X) / s0 + delta * X
        Vi = np.zeros((self.src.n, X.shape[1]))
        np.add.at(Vi, z_idx, X)
        return self.kernel_matvec(Vi)[z_idx] / s0 + delta * X

    def _z_index(self, z_idx: Optional[np.ndarray]
                 ) -> Optional[torch.Tensor]:
        if z_idx is None:
            return None
        return torch.as_tensor(np.asarray(z_idx, dtype=np.int64),
                               device=self.device)

    def device_cg(self, B: np.ndarray, delta, s0: float,
                  tol: float = 1e-6, maxiter: int = 400,
                  x0: Optional[np.ndarray] = None,
                  z_idx: Optional[np.ndarray] = None) -> np.ndarray:
        """Solve (WᵀW/s0 + δI)·X = B: a host-driven loop of single CG steps
        with X/R/P resident on the device; the host reads the (r,) residual
        norms every other step to test convergence and stalls. f32 on the
        device, so tol is floored at 1e-6. ``x0`` warm-starts the solve in
        residual form (convergence stays relative to the ORIGINAL ‖B‖).
        ``z_idx`` (record → individual index of a 0/1 incidence Zmat)
        switches the operator to record space H = Z·K·Zᵀ/s0 + δI.

        A streamed stack keeps this loop (each step's K·V streams the
        chunks), where the reference falls back to its host CG once the
        stack is not on the device: the answer is the same within the
        matrix-free engine's tolerance."""
        r = B.shape[1]
        if x0 is not None and x0.shape != B.shape:
            x0 = None
        zi = self._z_index(z_idx)

        def matvec(V):
            return _kernel_apply(self._device_kv, self.src.n, V, zi) / s0

        Bp = _pad_cols8(B)
        r_pad = Bp.shape[1]
        bn2 = np.maximum(np.sum(Bp.astype(np.float32) ** 2, axis=0), 1e-30)
        if x0 is not None:
            R0 = B - self._h_apply_host(x0, delta, s0, z_idx)
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
            Xd, Rd, Pd, rs = _cg_step(matvec, Xd, Rd, Pd, rs, thresh, dlt)
            self.stack_passes += 1
        return x0 + self._to_host(Xd)[:, :r]

    def device_lanczos(self, Z: np.ndarray, m: int, reorth: bool,
                       s0: float, z_idx: Optional[np.ndarray] = None):
        """Batched Lanczos on K = WᵀW/s0 with the basis resident on the
        device (reference: engine_jax.TiledScan.device_lanczos, its packed
        branch). One Python loop of m steps, each one kernel matvec (K1
        then K2) and a few torch ops; the host reads nothing until the end.
        Columns are zero-padded to a multiple of 8 (inert). ``z_idx``
        switches to the record-space kernel Z·K·Zᵀ/s0 (see device_cg).

        Returns (alphas (m, r_pad), betas (m-1, r_pad), z_norm (r_pad,) —
        host f64 — and the basis, a device f32 (r_pad, m, n_rows) tensor:
        column-major, so reorthogonalisation and every later apply are
        batched products a column)."""
        m = min(m, Z.shape[0])
        zi = self._z_index(z_idx)

        def matvec(V):
            return _kernel_apply(self._device_kv, self.src.n, V, zi) / s0

        Zd = self._to_device(_pad_cols8(Z))
        n_rows, r = Zd.shape
        z_norm = torch.linalg.vector_norm(Zd, dim=0)
        V = Zd / z_norm.clamp(min=1e-30)[None, :]
        basis = torch.empty((r, m, n_rows), dtype=torch.float32,
                            device=self.device)
        basis[:, 0] = V.T
        alphas = torch.zeros((m, r), dtype=torch.float32, device=self.device)
        betas = torch.zeros_like(alphas)
        V_prev, beta_prev = torch.zeros_like(V), torch.zeros_like(z_norm)
        for k in range(m):
            alpha, beta, Vn = _lanczos_step(matvec, basis[:, : k + 1], V,
                                            V_prev, beta_prev, reorth)
            self.stack_passes += 1
            alphas[k], betas[k] = alpha, beta
            if k + 1 < m:
                basis[:, k + 1] = Vn.T
            V_prev, V, beta_prev = V, Vn, beta
        return (self._to_host(alphas), self._to_host(betas)[: m - 1],
                self._to_host(z_norm), basis)

    def sweep_dots(self, A: np.ndarray) -> np.ndarray:
        """Per-SNP dot products W·A ((p, r)), one packed_dot launch a
        chunk."""
        A_d = self._to_device(A)
        return self._to_host(self._by_rows(
            lambda m, Wc: packed.packed_dot(Wc, A_d, m, self.src.n)))

    def matfree_stat_rows(
        self, A: np.ndarray, q: int, XtHiX_inv: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Per-SNP matfree sweep statistics (â, u, Hutchinson diag, proj)
        for A = [P̃y, H⁻¹X, H^(-1/2)·probes]: one packed_dot a chunk, whose
        probe block is reduced ON THE DEVICE, so (p, q+3) comes back, not
        (p, 1+q+r). q is padded to a multiple of 8 as in the reference
        (zero u/Minv columns are inert)."""
        self.stack_passes += 1
        r = A.shape[1] - 1 - q
        q8 = -(-max(q, 1) // 8) * 8
        A_pad = np.zeros((A.shape[0], 1 + q8 + r))
        A_pad[:, 0] = A[:, 0]
        A_pad[:, 1 : 1 + q] = A[:, 1 : 1 + q]
        A_pad[:, 1 + q8 :] = A[:, 1 + q :]
        M_pad = np.zeros((q8, q8))
        M_pad[:q, :q] = XtHiX_inv
        A_d, M_d = self._to_device(A_pad), self._to_device(M_pad)
        out = self._to_host(self._by_rows(lambda m, Wc: _stats_from_D(
            packed.packed_dot(Wc, A_d, m, self.src.n), M_d, q8)))
        return (out[:, 0], out[:, 1 : 1 + q], out[:, 1 + q8], out[:, 2 + q8])

    def matfree_stat_rows_multi(
        self, A_list: list[np.ndarray], q_list: list[int],
        Minv_list: list[np.ndarray],
    ) -> list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """R traits' (or permutations') sweep statistics from ONE packed_dot
        a chunk over the concatenated blocks (reference:
        engine_jax.TiledScan.matfree_stat_rows_multi).

        A_list[t] = [P̃y_t, H⁻¹X_t (q_t cols), H^(-1/2)probes_t (r cols)]
        with a common probe count r; q_t may differ, and every trait is
        padded to one multiple-of-8 q (zero columns are inert). Traits are
        sub-batched so one launch stays within the columns the stack's
        gate reserved (MULTI_STAT_COLS, or KRYLOV_COLS when the stack
        stays on the card only at that width or streams).
        Returns per-trait (ahat, U, diag, proj)."""
        R = len(A_list)
        if R == 1:
            return [self.matfree_stat_rows(A_list[0], q_list[0],
                                           Minv_list[0])]
        r = A_list[0].shape[1] - 1 - q_list[0]
        q8 = -(-max(max(q_list), 1) // 8) * 8
        c = 1 + q8 + r
        if R * c > self.plan.stat_cols:
            per = max(1, self.plan.stat_cols // c)
            out = []
            for s in range(0, R, per):
                out.extend(self.matfree_stat_rows_multi(
                    A_list[s : s + per], q_list[s : s + per],
                    Minv_list[s : s + per]))
            return out
        self.stack_passes += 1
        A_cat = np.zeros((A_list[0].shape[0], R * c))
        M_cat = np.zeros((R, q8, q8))
        for t, (A, qt) in enumerate(zip(A_list, q_list)):
            if A.shape[1] - 1 - qt != r:
                raise ValueError("matfree_stat_rows_multi needs a common "
                                 "probe count")
            A_cat[:, t * c] = A[:, 0]
            A_cat[:, t * c + 1 : t * c + 1 + qt] = A[:, 1 : 1 + qt]
            A_cat[:, t * c + 1 + q8 : (t + 1) * c] = A[:, 1 + qt :]
            M_cat[t, :qt, :qt] = Minv_list[t]
        A_d, M_d = self._to_device(A_cat), self._to_device(M_cat)
        out = self._to_host(self._by_rows(lambda m, Wc: _stats_from_D_multi(
            packed.packed_dot(Wc, A_d, m, self.src.n), M_d, q8, R)))
        w = q8 + 3
        return [(out[:, t * w], out[:, t * w + 1 : t * w + 1 + qt],
                 out[:, t * w + 1 + q8], out[:, t * w + 2 + q8])
                for t, qt in enumerate(q_list)]

    def sweep(self, Lp: np.ndarray, Py: np.ndarray,
              sigma2_g: float) -> np.ndarray:
        """Score every SNP from the projector factor Lp (P̃ = Lp·Lpᵀ, (n,
        m)) and P̃y over the W tiles (kernels.score_tile_sqrt, or its bf16
        form under the bfloat16 policy)."""
        Lp_d, Py_d = self._to_device(Lp), self._to_device(Py)
        s2g = torch.tensor(sigma2_g, dtype=torch.float32, device=self.device)
        out = torch.empty(self.src.p, dtype=torch.float32, device=self.device)
        for j0, w in self._device_tiles():
            out[j0 : j0 + w.shape[0]] = self._score(w, Lp_d, Py_d, s2g)
        return self._to_host(out)

    def sweep_batched(self, Lp: np.ndarray, Py: np.ndarray,
                      sigma2_g: np.ndarray) -> np.ndarray:
        """:meth:`sweep` for R projector factors in one pass over the
        tiles: Lp (R, n, m), Py (R, n), σ²_g (R,) → t (R, p)."""
        Lp_d, Py_d, s2g = (self._to_device(a) for a in (Lp, Py, sigma2_g))
        out = torch.empty((Lp_d.shape[0], self.src.p), dtype=torch.float32,
                          device=self.device)
        for j0, w in self._device_tiles():
            out[:, j0 : j0 + w.shape[0]] = kernels.score_tile_batched(
                w, Lp_d, Py_d, s2g)
        return self._to_host(out)

    def column_f64(self, j: int) -> np.ndarray:
        """The f64 recoded W column for SNP j (reference:
        ``extract_geno_rcpp``, SURVEY.md §3.3)."""
        return _impute_column_f64(self.src.column(j))

    # ---- the exact engine: MMt, then sweeps in K's eigenbasis

    def _device_tiles(self) -> Iterator[tuple[int, torch.Tensor]]:
        """(offset, W tile (b, n) in compute_dtype), recoded on the device
        from row slices of the stack's chunks (of the resident stack, or of
        each chunk as it streams through); kept in a device cache when
        ``cache_device``.

        The reference feeds a TPU from the host: a producer thread streams
        int8 or packed tiles (or serves them from a separate stack of W),
        padded to one tile shape for its compiled programs. Here every
        source is already packed into the stack, so each tile is unpacked
        from its chunk, the last one of a chunk simply shorter. A streamed
        chunk is a multiple of ``tile_snps`` rows (when one tile fits the
        ring), so the tiles, and MMt's sum over them, are the resident
        stack's."""
        if self._wcache is not None:
            yield from self._wcache
            return
        cache = [] if self.cache_device else None
        for r0, Wc in self._stack_chunks():
            for t in range(0, Wc.shape[0], self.tile_snps):
                w = kernels.unpack_recode_tile(Wc[t : t + self.tile_snps],
                                               self.src.n,
                                               self.config.compute_dtype)
                if cache is not None:
                    cache.append((r0 + t, w))
                yield r0 + t, w
        if cache is not None:
            self._wcache = cache

    def compute_K(self) -> np.ndarray:
        """The raw MMt = WᵀW (n, n), accumulated in f32 on the device over
        the W tiles, returned as host f64."""
        n = self.src.n
        K = torch.zeros((n, n), dtype=torch.float32, device=self.device)
        for _, w in self._device_tiles():
            K = kernels.mmt_accumulate(K, w)
        return self._to_host(K)

    def set_eigenbasis(self, U_eff) -> None:
        """Place the (possibly Zᵀ-projected) eigenbasis on the device once
        per scan (a host array or a device tensor); the sweeps then take
        only O(n·q) inputs per iteration."""
        self._U_dev = torch.as_tensor(U_eff, dtype=torch.float32,
                                      device=self.device)
        self._tcache = None

    def _T_tiles(self) -> Iterator[tuple[int, torch.Tensor]]:
        """Eigenbasis tiles T = W·U — iteration-invariant, so cached on the
        device with the W tiles' rule; the W cache is released once T
        exists (the exact scan needs W no more)."""
        if self._tcache is not None:
            yield from self._tcache
            return
        cache = [] if self.cache_device else None
        for j0, w in self._device_tiles():
            T = kernels.eig_T_tile(w, self._U_dev)
            if cache is not None:
                cache.append((j0, T))
            yield j0, T
        if cache is not None:
            self._tcache = cache
            self._wcache = None

    def sweep_eig(self, s: np.ndarray, Q: np.ndarray, z3: np.ndarray,
                  sigma2_g: float) -> np.ndarray:
        """Eigenbasis score sweep (kernels.score_from_T) over every SNP;
        s, Q, z3 are the host-f64 per-iteration state. One copy to the
        host a sweep."""
        s_d, Q_d, z3_d = (self._to_device(a) for a in (s, Q, z3))
        s2g = torch.tensor(sigma2_g, dtype=torch.float32, device=self.device)
        out = torch.empty(self.src.p, dtype=torch.float32, device=self.device)
        for j0, T in self._T_tiles():
            out[j0 : j0 + T.shape[0]] = kernels.score_from_T(T, s_d, Q_d,
                                                             z3_d, s2g)
        return self._to_host(out)

    def sweep_eig_batched(self, s: np.ndarray, Q: np.ndarray,
                          z3: np.ndarray, sigma2_g: np.ndarray) -> np.ndarray:
        """Batched eigenbasis sweep: s (R, n), Q (R, n, q), z3 (R, n),
        σ²_g (R,) → (R, p). The T tiles are shared by the whole batch."""
        s_d, Q_d, z3_d, s2g = (self._to_device(a)
                               for a in (s, Q, z3, sigma2_g))
        out = torch.empty((s_d.shape[0], self.src.p), dtype=torch.float32,
                          device=self.device)
        for j0, T in self._T_tiles():
            out[:, j0 : j0 + T.shape[0]] = kernels.score_from_T_batched(
                T, s_d, Q_d, z3_d, s2g)
        return self._to_host(out)


class MultiHostTiledScan(TiledScan):
    """The multi-process backend (BASELINE config 4: biobank n over several
    cards), one rank a card.

    Each rank holds ONLY its SNP range [lo, hi) as its packed stack
    (store shard ↔ rank locality: a split store's foreign shards are never
    opened), resident or streamed by the rank's own gate (read from the
    store, a rank's every pass reads its own range), and the primitives
    compose across ranks:

    - ``kernel_matvec`` and ``compute_K``: the rank's partial, summed over
      the ranks in process order on the host (utils/distributed, f64);
    - the device CG and Lanczos: each step's K·V is the rank's K1/K2
      partial on its own stack, summed on the device by one
      ``all_reduce`` of the (n, r) f32 block (counted in
      ``device_allreduces``) before the step goes on — the JAX package's
      GSPMD program over a global dense W, here with each rank's 2-bit
      stack. Every later decision reads the reduced block, so every rank
      takes it alike;
    - ``sweep_dots`` and the stat rows stay LOCAL (the matrix-free sweep
      gathers only what it needs); the ``sweep*`` forms gather their rows
      into the global statistic vector;
    - ``column_f64``: the owning rank reads the column, the others send
      zeros, one f64 all-reduce.

    Every method that communicates is a collective: every rank calls it,
    with the same arguments."""

    def __init__(self, src: TileSource, config: EagleConfig,
                 device: torch.device, matfree: bool = True):
        self.p_global = src.p
        self.global_src = src
        self.snp_range = distributed.process_snp_range(src.p)
        self.local_sizes = distributed.local_snp_sizes(src.p)
        self.device_allreduces = 0
        super().__init__(RangeTileSource(src, *self.snp_range), config,
                         device, matfree)

    def kernel_matvec(self, V: np.ndarray) -> np.ndarray:
        return distributed.allreduce_sum_f64(super().kernel_matvec(V))

    def compute_K(self) -> np.ndarray:
        return distributed.allreduce_sum_f64(super().compute_K())

    def _device_kv(self, V: torch.Tensor) -> torch.Tensor:
        KV = self._local_kv(V)
        dist.all_reduce(KV)
        self.device_allreduces += 1
        return KV

    def column_f64(self, j: int) -> np.ndarray:
        lo, hi = self.snp_range
        if lo <= j < hi:
            col = _impute_column_f64(self.src.column(j - lo))
        else:
            col = np.zeros(self.src.n, dtype=np.float64)
        return distributed.allreduce_sum_f64(col)

    def _gather_rows(self, t_local: np.ndarray) -> np.ndarray:
        return distributed.allgather_concat_f64(t_local, self.local_sizes)

    def sweep(self, Lp, Py, sigma2_g):
        return self._gather_rows(super().sweep(Lp, Py, sigma2_g))

    def sweep_batched(self, Lp, Py, sigma2_g):
        return self._gather_rows(super().sweep_batched(Lp, Py, sigma2_g).T).T

    def sweep_eig(self, s, Q, z3, sigma2_g):
        return self._gather_rows(super().sweep_eig(s, Q, z3, sigma2_g))

    def sweep_eig_batched(self, s, Q, z3, sigma2_g):
        return self._gather_rows(
            super().sweep_eig_batched(s, Q, z3, sigma2_g).T).T


def scan_backend(src: TileSource, config: EagleConfig, device,
                 matfree: bool = True) -> TiledScan:
    """The backend over the packed stack that the matrix-free engine,
    ``am_multi``, ``summary_am`` and ``fpr4am`` build:
    :class:`MultiHostTiledScan` in a multi-process run, else
    :class:`TiledScan`; ``matfree`` False for their exact paths."""
    if distributed.process_count() > 1:
        return MultiHostTiledScan(src, config, device, matfree)
    return TiledScan(src, config, device, matfree)


class ShardedScan:
    """The SNP-sharded exact engine over the (ind, snp) mesh of the ranks
    (``am(engine="sharded")``): rank (i, s) holds rows [s·rows, (s+1)·rows)
    and columns [i·n_loc, (i+1)·n_loc) of the recoded Wt, p padded to
    snp·128 rows of W = 0 (masked out of every sweep). MMt merges with
    one all-reduce; each sweep is scored on the shards with one collective
    argmax (parallel/collectives). At one process without a group it runs
    the same code on one device."""

    def __init__(self, src: TileSource, config: EagleConfig, device):
        self.src = src
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda":
            _ieee_fp32()
        self.mesh = meshlib.make_mesh(config.mesh_shape, self.device.type)
        n_snp = self.mesh.shape[meshlib.SNP_AXIS]
        n_ind = self.mesh.shape[meshlib.IND_AXIS]
        if src.n % n_ind:
            raise ValueError(f"{src.n} individuals do not split evenly over "
                             f"the mesh's {n_ind} ind shards")
        self.p_pad = meshlib.pad_to_multiple(src.p, n_snp * 128)
        self.rows = self.p_pad // n_snp
        self.r0 = self.mesh.coord[meshlib.SNP_AXIS] * self.rows
        self.n_loc = src.n // n_ind
        self.c0 = self.mesh.coord[meshlib.IND_AXIS] * self.n_loc
        dtype = kernels._DTYPES[config.compute_dtype]
        self.Wt = torch.zeros((self.rows, self.n_loc), dtype=dtype,
                              device=self.device)
        hi = min(self.r0 + self.rows, src.p)
        tile = config.resolve_snp_tile(src.n, self.rows)
        for j0, g in src.tiles_in(self.r0, hi, tile):
            w = kernels.recode_impute_tile(
                torch.from_numpy(np.ascontiguousarray(g)).to(self.device),
                config.compute_dtype)
            self.Wt[j0 - self.r0 : j0 - self.r0 + w.shape[0]] = \
                w[:, self.c0 : self.c0 + self.n_loc]
        self._T: Optional[torch.Tensor] = None

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=self.device)

    def compute_K(self) -> np.ndarray:
        K = collectives.mmt_psum(self.Wt, self.mesh)
        return K.cpu().numpy().astype(np.float64)

    def set_eigenbasis(self, U_eff) -> None:
        """T = Wt·U (the rank's rows, all of U's columns summed over
        ``ind``), kept as the rank's column slice for the sweeps."""
        U = torch.as_tensor(U_eff, dtype=torch.float32, device=self.device)
        n_ind = self.mesh.shape[meshlib.IND_AXIS]
        if U.shape[1] % n_ind:
            raise ValueError(f"the eigenbasis' {U.shape[1]} columns do not "
                             f"split evenly over {n_ind} ind shards")
        T = kernels.eig_T_tile(self.Wt, U[self.c0 : self.c0 + self.n_loc])
        T = collectives._all_reduce(T, self.mesh, meshlib.IND_AXIS)
        self.e_loc = U.shape[1] // n_ind
        self.e0 = self.mesh.coord[meshlib.IND_AXIS] * self.e_loc
        self._T = T[:, self.e0 : self.e0 + self.e_loc].contiguous()

    def _mask(self, exclude: Optional[list[int]]) -> torch.Tensor:
        mask = np.ones(self.p_pad, dtype=np.float32)
        mask[self.src.p :] = 0.0
        if exclude:
            mask[np.asarray(exclude)] = 0.0
        return self._to_device(mask[self.r0 : self.r0 + self.rows])

    def _result(self, out) -> tuple[np.ndarray, int, float]:
        t, i_glob, m_glob = out
        return (t.cpu().numpy()[: self.src.p].astype(np.float64),
                int(i_glob), float(m_glob))

    def sweep_eig(self, s, Q, z3, sigma2_g,
                  exclude: Optional[list[int]] = None):
        """The eigenbasis sweep and its collective argmax: (t (p,), global
        index, global max)."""
        sl = slice(self.e0, self.e0 + self.e_loc)
        s2g = torch.tensor(sigma2_g, dtype=torch.float32, device=self.device)
        return self._result(collectives.score_and_argmax_from_T(
            self._T, self._to_device(s[sl]), self._to_device(Q[sl]),
            self._to_device(z3[sl]), s2g, self._mask(exclude), self.mesh))

    def sweep(self, Lp, Py, sigma2_g, exclude: Optional[list[int]] = None):
        """The Lp-form sweep (P̃ = Lp·Lpᵀ) and its collective argmax."""
        sl = slice(self.c0, self.c0 + self.n_loc)
        s2g = torch.tensor(sigma2_g, dtype=torch.float32, device=self.device)
        return self._result(collectives.score_and_argmax(
            self.Wt, self._to_device(Lp[sl]), self._to_device(Py[sl]), s2g,
            self._mask(exclude), self.mesh))

    def column_f64(self, j: int) -> np.ndarray:
        """Global SNP column j as f64 W. Multi-process: the rank at ind 0
        whose rows hold j reads it, the others send zeros, one f64
        all-reduce (a collective: the same j on every rank)."""
        if distributed.process_count() == 1:
            return _impute_column_f64(self.src.column(j))
        owner = (self.r0 <= j < min(self.r0 + self.rows, self.src.p)
                 and self.mesh.coord[meshlib.IND_AXIS] == 0)
        col = (_impute_column_f64(self.src.column(j)) if owner
               else np.zeros(self.src.n, dtype=np.float64))
        return distributed.allreduce_sum_f64(col)


# ---------------------------------------------------------------------------
# The exact eigenbasis engine's forward selection (shared decision path)
# ---------------------------------------------------------------------------


def _eig_iteration_state(
    d: np.ndarray, y_star: np.ndarray, Xs: np.ndarray, delta: float,
    qmax: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-iteration host state for the eigenbasis sweep: s = (d+δ)^(-1/2),
    Q = orth basis of S·X* (zero-padded to qmax columns so the sweep keeps
    one shape for the whole scan — zero columns leave QQᵀ unchanged), and
    z3 with P̃y = U·z3:
      z3 = s ∘ [(I−QQᵀ)(s ∘ y*)].
    All O(n·q) — the only n² object is the device-resident U."""
    s = 1.0 / np.sqrt(d + delta)
    Xr, _ = reml_core.independent_cols(np.asarray(Xs, np.float64))
    V = Xr * s[:, None]
    Q, _ = np.linalg.qr(V)
    z1 = s * y_star
    z2 = z1 - Q @ (Q.T @ z1)
    z3 = s * z2
    if Q.shape[1] < qmax:
        Q = np.concatenate(
            [Q, np.zeros((Q.shape[0], qmax - Q.shape[1]))], axis=1)
    elif Q.shape[1] > qmax:
        raise ValueError(f"q={Q.shape[1]} exceeds qmax={qmax}")
    return s, Q, z3


def forward_select(
    y: np.ndarray,
    X0: np.ndarray,
    handle: GenoHandle,
    maxit: int = 40,
    fixit: bool = False,
    lam_ebic: float = 1.0,
    Z: Optional[np.ndarray] = None,
    quiet: bool = True,
    config: EagleConfig = DEFAULT_CONFIG,
    keep_records: Optional[np.ndarray] = None,
    ckpt_dir: Optional[str] = None,
    resume: bool = False,
    log_jsonl: Optional[str] = None,
    device="cuda",
    sharded: bool = False,
) -> AMResult:
    """The AM forward-selection loop on the exact eigenbasis engine
    (SURVEY.md §4.2): on one device, or with ``sharded`` SNP-sharded over
    the mesh of the ranks (:class:`ShardedScan`, a collective argmax each
    sweep; every rank runs this loop and takes the same decisions).

    With ``ckpt_dir``, the n×n MMt is cached keyed by the genotype source
    (iteration/permutation-invariant, SURVEY.md §6.4), and so is a host
    eigendecomposition; the tiny scan state is checkpointed at every
    accepted iteration, and ``resume=True`` restarts a killed scan (in a
    multi-process run: the whole job) from the last iteration boundary
    (§6.3)."""
    from eagleeverything_tpu_torch.utils import checkpoint as ckpt
    from eagleeverything_tpu_torch.utils.logging import Phase, ScanLogger

    y = np.asarray(y, dtype=np.float64)
    X0 = np.asarray(X0, dtype=np.float64)
    src = _make_source(handle, keep_records)
    n = y.shape[0]
    p = src.p
    logger = ScanLogger(quiet=quiet, jsonl_path=log_jsonl,
                        is_host0=distributed.is_host0())
    backend = (ShardedScan(src, config, device) if sharded
               else TiledScan(src, config, device, matfree=False))

    K_raw = None
    mmt_key = None
    if ckpt_dir is not None:
        mmt_key = ckpt.mmt_cache_key(
            handle.source, src.n, src.p, keep_records,
            content_token=ckpt.genotype_content_token(handle))
        K_raw = ckpt.load_mmt(ckpt_dir, mmt_key)
        if K_raw is not None and K_raw.shape != (src.n, src.n):
            K_raw = None
    if K_raw is None:
        with Phase(logger, "mmt", items=p):
            K_raw = backend.compute_K()
        if ckpt_dir is not None:
            ckpt.save_mmt(ckpt_dir, mmt_key, K_raw)
    if Z is None and n != src.n:
        raise ValueError(f"trait has {n} records but {src.n} genotyped "
                         "individuals")
    K_eff = normalized_kernel(K_raw, Z)

    selected: list[int] = []
    extbic_path: list[float] = []
    loglik_path: list[float] = []
    outlier_stats: list[np.ndarray] = []

    X = X0
    if resume and ckpt_dir is not None:
        state = ckpt.load_scan_state(ckpt_dir)
        if state is not None:
            meta = state.get("meta", {})
            expect = {"trait_n": n, "p": p, "lam_ebic": lam_ebic}
            mismatch = {k: (meta.get(k), v) for k, v in expect.items()
                        if meta.get(k) != v}
            if mismatch:
                raise ValueError(
                    f"refusing to resume: checkpoint in {ckpt_dir} was "
                    f"written for different inputs {mismatch} "
                    "(saved vs current)")
            selected = [int(j) for j in state["selected"]]
            for j in selected:
                w_col = backend.column_f64(j)
                x_col = Z @ w_col if Z is not None else w_col
                X = np.hstack([X, x_col[:, None]])
            extbic_path = [float(v) for v in state["extbic_path"][:-1]]
            loglik_path = [float(v) for v in state["loglik_path"][:-1]]
            logger.event("resume", markers=len(selected))

    # One eigendecomposition of K for the whole scan (FaST-LMM style):
    # every later REML fit is O(n·q²) in this basis, and the sweep is
    # O(n·q) a SNP. Cached beside MMt, keyed by the kernel's CONTENT so a
    # changed MMt cache cannot serve a stale basis.
    basis = None
    eig_key = None
    if ckpt_dir is not None and Z is None:
        eig_key = (mmt_key + "-"
                   + hashlib.sha256(np.ascontiguousarray(K_eff).tobytes())
                   .hexdigest()[:16])
        cached = ckpt.load_eig(ckpt_dir, eig_key)
        if cached is not None and cached[0].shape[0] == n:
            basis = EigenBasis(np.maximum(cached[0], 0.0), cached[1], None,
                               backend.device)
    if basis is None:
        with Phase(logger, "eigh", items=n):
            basis = eigh_basis(K_eff, config, backend.device)
        if eig_key is not None and basis.host_f64 is not None:
            ckpt.save_eig(ckpt_dir, eig_key, basis.d, basis.host_f64)
    d_eig = basis.d
    y_star = basis.project(y)
    Xs = basis.project(X)
    # the sweep runs in K's eigenbasis on the device (T = W·U tiles); with
    # Z the basis is Zᵀ·U (T_j = (Z·w_j)ᵀU = w_jᵀ·(ZᵀU)), folded on the
    # host when U is there, else on the device, so U never reaches the host
    if Z is None:
        backend.set_eigenbasis(basis.device_basis())
    elif basis.host_f64 is not None:
        backend.set_eigenbasis(Z.T @ basis.host_f64)
    else:
        backend.set_eigenbasis(
            torch.as_tensor(np.ascontiguousarray(Z.T), dtype=torch.float32,
                            device=backend.device) @ basis.device_basis())
    qmax = -(-(X0.shape[1] + maxit + 1) // 8) * 8

    fit = reml_core.reml_maximize_diag(d_eig, y_star, Xs)
    best = reml_core.extbic(fit.loglik, n, p, len(selected), lam_ebic)
    extbic_path.append(best)
    loglik_path.append(fit.loglik)
    if not quiet:
        print(f"[engine] start: extBIC={best:.4f} delta={fit.delta:.4g} "
              f"k={len(selected)}")

    for it in range(len(selected), maxit):
        with Phase(logger, "sweep", items=p):
            s_vec, Qp, z3 = _eig_iteration_state(
                d_eig, y_star, Xs, fit.delta, qmax)
            if sharded:
                t, cand, _ = backend.sweep_eig(s_vec, Qp, z3, fit.sigma2_g,
                                               exclude=selected)
            else:
                t = backend.sweep_eig(s_vec, Qp, z3, fit.sigma2_g)
                t[selected] = 0.0
                cand = int(np.argmax(t))
        outlier_stats.append(t)
        if t[cand] <= 0.0:
            # exhausted: every remaining SNP is selected or zero-variance
            # (the collective argmax returns index 0 with max 0 here)
            break

        w_col = backend.column_f64(cand)
        x_col = Z @ w_col if Z is not None else w_col
        X_new = np.hstack([X, x_col[:, None]])
        Xs_new = np.hstack([Xs, basis.project(x_col)[:, None]])
        fit_new = reml_core.reml_maximize_diag(d_eig, y_star, Xs_new)
        ebic_new = reml_core.extbic(fit_new.loglik, n, p, len(selected) + 1,
                                    lam_ebic)
        if not quiet:
            print(f"[engine] it={it} cand={cand} t_max={t[cand]:.4f} "
                  f"extBIC {best:.4f} -> {ebic_new:.4f}")
        accepted = ebic_new < best or fixit
        logger.event(
            "iteration", it=it, candidate=cand, t_max=float(t[cand]),
            extbic=float(ebic_new), accepted=accepted,
            sigma2_g=float(fit_new.sigma2_g),
            sigma2_e=float(fit_new.sigma2_e),
        )
        if not accepted:
            break
        selected.append(cand)
        X, Xs, fit, best = X_new, Xs_new, fit_new, ebic_new
        extbic_path.append(ebic_new)
        loglik_path.append(fit_new.loglik)
        if ckpt_dir is not None:
            ckpt.save_scan_state(
                ckpt_dir, selected, extbic_path, loglik_path,
                fit.delta, fit.sigma2_g, fit.sigma2_e,
                meta={"trait_n": n, "p": p, "lam_ebic": lam_ebic},
            )

    if not sharded:
        logger.event("stack", **backend.stack_info())
    logger.close()
    return AMResult(
        indices=selected, extbic_path=extbic_path,
        outlier_stats=outlier_stats, loglik_path=loglik_path,
        sigma2_g=fit.sigma2_g, sigma2_e=fit.sigma2_e, delta=fit.delta,
        n=n, p=p, lam_ebic=lam_ebic,
    )


def forward_select_multi(
    ys: np.ndarray,
    X0: np.ndarray,
    handle: GenoHandle,
    maxit: int = 40,
    fixit: bool = False,
    lam_ebic: float = 1.0,
    quiet: bool = True,
    config: EagleConfig = DEFAULT_CONFIG,
    keep_records: Optional[np.ndarray] = None,
    trait_names: Optional[list[str]] = None,
    device="cuda",
) -> list[AMResult]:
    """Lockstep multi-trait scan on the exact engine (BASELINE config 5).

    All T traits share one MMt, one kernel eigendecomposition and the T
    tiles; at each iteration the still-active traits' sweeps run as ONE
    batched pass over the tiles. Each trait keeps its own forward-selection
    state and extBIC stopping. In a multi-process run each rank holds its
    SNP range (:class:`MultiHostTiledScan`: collective K, gathered sweeps,
    the owning rank's columns), and every rank selects alike."""
    from eagleeverything_tpu_torch.utils.logging import Phase, ScanLogger

    ys = np.asarray(ys, dtype=np.float64)
    T, n = ys.shape
    X0 = np.asarray(X0, dtype=np.float64)
    src = _make_source(handle, keep_records)
    logger = ScanLogger(quiet=quiet, is_host0=distributed.is_host0())
    p = src.p
    if n > config.host_eigh_max_n:
        # the per-trait projections below need U as a HOST f64 matrix —
        # above host_eigh_max_n that is an n² f64 surprise (20 GB at
        # n = 50k): a loud error, not an out-of-memory
        raise ValueError(
            f"forward_select_multi's eigenbasis path materializes the "
            f"n×n eigenvector matrix on the host (n={n} > "
            f"host_eigh_max_n={config.host_eigh_max_n} → "
            f"{8 * n * n / 1e9:.0f} GB f64). Raise config.host_eigh_max_n "
            f"explicitly if the host truly has the memory.")
    backend = scan_backend(src, config, device, matfree=False)
    with Phase(logger, "mmt", items=p):
        K_raw = backend.compute_K()
    if n != src.n:
        raise ValueError(f"traits have {n} records but {src.n} individuals")
    K = normalized_kernel(K_raw)

    with Phase(logger, "eigh", items=n):
        basis = eigh_basis(K, config, backend.device)
    d_eig, U_eig = basis.d, basis.host_f64       # n ≤ host_eigh_max_n
    ystars = ys @ U_eig          # (T, n): row t is Uᵀ·y_t
    Xs0 = U_eig.T @ X0
    backend.set_eigenbasis(U_eig)
    qmax = -(-(X0.shape[1] + maxit + 1) // 8) * 8

    class _TraitState:
        def __init__(self, t):
            self.t = t
            self.selected: list[int] = []
            self.Xs = Xs0
            self.extbic_path: list[float] = []
            self.loglik_path: list[float] = []
            self.outlier: list[np.ndarray] = []
            self.fit = reml_core.reml_maximize_diag(d_eig, ystars[t], Xs0)
            self.best = reml_core.extbic(self.fit.loglik, n, p, 0, lam_ebic)
            self.extbic_path.append(self.best)
            self.loglik_path.append(self.fit.loglik)
            self.active = True

    states = [_TraitState(t) for t in range(T)]

    for it in range(maxit):
        active = [s for s in states if s.active]
        if not active:
            break
        B = len(active)
        s_all = np.empty((B, n))
        Q_all = np.empty((B, n, qmax))
        z3_all = np.empty((B, n))
        for b, st in enumerate(active):
            s_all[b], Q_all[b], z3_all[b] = _eig_iteration_state(
                d_eig, ystars[st.t], st.Xs, st.fit.delta, qmax)
        with Phase(logger, "sweep", items=p * B):
            t_all = backend.sweep_eig_batched(
                s_all, Q_all, z3_all,
                np.array([st.fit.sigma2_g for st in active]))
        for b, s in enumerate(active):
            t_vec = t_all[b]
            t_vec[s.selected] = 0.0
            s.outlier.append(t_vec)
            cand = int(np.argmax(t_vec))
            if t_vec[cand] <= 0.0:
                s.active = False  # exhausted for this trait
                continue
            w_col = backend.column_f64(cand)
            Xs_new = np.hstack([s.Xs, (U_eig.T @ w_col)[:, None]])
            fit_new = reml_core.reml_maximize_diag(d_eig, ystars[s.t], Xs_new)
            ebic_new = reml_core.extbic(
                fit_new.loglik, n, p, len(s.selected) + 1, lam_ebic)
            if ebic_new < s.best or fixit:
                s.selected.append(cand)
                s.Xs, s.fit, s.best = Xs_new, fit_new, ebic_new
                s.extbic_path.append(ebic_new)
                s.loglik_path.append(fit_new.loglik)
            else:
                s.active = False
            logger.event("iteration", it=it, trait=s.t, candidate=cand,
                         accepted=s.active or fixit,
                         extbic=float(ebic_new))

    logger.event("stack", **backend.stack_info())
    logger.close()
    return [
        AMResult(
            indices=s.selected, extbic_path=s.extbic_path,
            outlier_stats=s.outlier, loglik_path=s.loglik_path,
            sigma2_g=s.fit.sigma2_g, sigma2_e=s.fit.sigma2_e,
            delta=s.fit.delta, n=n, p=p, lam_ebic=lam_ebic,
            trait_name=(trait_names[s.t] if trait_names else f"trait{s.t}"),
        )
        for s in states
    ]
