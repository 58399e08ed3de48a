"""Matrix-free biobank-scale scan: CG solves + stochastic Lanczos REML.

Implements docs/design_biobank_scale.md's n-scale plan: at n where the
n×n kernel (or its eigendecomposition) cannot be materialized, every
appearance of K reduces to streamed matvecs K·V = Wᵀ(W·V) over the
SNP-sharded genotype tiles (reference hot-loop machinery re-aimed at a
new call site; no new distributed primitives).

Pieces:
- :func:`blocked_cg`       — H⁻¹·B for a block of RHS (H = K/s0 + δI), the
  host solver of designs the device hooks do not cover
- :func:`slq_logdet`      — log|H| by Hutchinson + Lanczos quadrature
  (common random probes across all δ so likelihood DIFFERENCES are smooth)
- :func:`reml_maximize_matfree` — the 1-D δ profile with the matrix-free
  LL evaluator (same grid+refine semantics as reml_core)
- :func:`score_sweep_matfree_multi` — t_j for all p SNPs, R traits on
  one set of store passes: exact â_j and the X-projection term;
  diag(WᵀH⁻¹W) by Hutchinson probes through H^(-1/2) (Lanczos
  square-root matvec), with exact CG rescoring of the top candidates so
  the argmax decision is exact
- :func:`forward_select_matfree_multi` — the AM loop on these pieces, R
  traits in lockstep on shared store passes (:class:`_UnionKrylov`)

One trait is the case R = 1 of both: :func:`score_sweep_matfree` and
:func:`forward_select_matfree` (``am()``'s entry) call them so.

Accuracy contract: stochastic terms (log|H|, probe diagonals) use common
random numbers across candidate models within an iteration, so the
extBIC accept/stop comparisons and the argmax see smooth differences;
tests validate selection equality against the exact engine at moderate n.

Where the context carries the backend's device hooks (:func:`make_context`:
no Zmat, or a one-hot Zmat as a record → individual index), every CG solve
keeps its block state on the device (engine_torch.TiledScan.device_cg) and
every Lanczos recurrence runs there too, with its basis resident
(TiledScan.device_lanczos); each matvec is two hand-written kernel
launches, two a chunk when the packed stack streams through the device.
The reference falls back to its host CG once its stack is not on the
device; the port keeps the device CG and Lanczos on a streamed stack,
whose answer is the same within the matrix-free tolerance. A Zmat that is
not one-hot wraps the kernel matvec on the host and takes the host f64
recurrences (:func:`blocked_cg`, :func:`_lanczos`), whose matvec still
launches the kernels.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Optional

import numpy as np

from eagleeverything_tpu_torch.models import reml_core
from eagleeverything_tpu_torch.models.oracle import AMResult
from eagleeverything_tpu_torch.utils import logging as scanlog

Matvec = Callable[[np.ndarray], np.ndarray]  # (n, r) -> (n, r)


# ---------------------------------------------------------------------------
# Krylov primitives
# ---------------------------------------------------------------------------


def blocked_cg(
    matvec_h: Matvec, B: np.ndarray, tol: float = 1e-8, maxiter: int = 400,
    x0: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Solve H·X = B column-blocked (classic CG, per-column scalars).

    One ``matvec_h`` per iteration serves every RHS column; columns that
    have converged are frozen (their α/β forced to 0) so late stragglers
    don't perturb finished solutions. ``x0`` warm-starts the iteration
    (convergence is still measured against ‖B‖, so the result meets the
    same relative tolerance as a cold solve).
    """
    B = np.asarray(B, dtype=np.float64)
    if x0 is not None:
        X = np.array(x0, dtype=np.float64, copy=True)
        R = B - matvec_h(X)
    else:
        X = np.zeros_like(B)
        R = B.copy()
    P = R.copy()
    rs = np.sum(R * R, axis=0)
    b_norm2 = np.maximum(np.sum(B * B, axis=0), 1e-300)
    # stall guard: with an f32 device matvec underneath, the reachable
    # residual floors near f32 noise — once no active column has
    # QUARTERED its norm² within 10 iterations, further matvecs (each a
    # full store pass) buy nothing
    floor = rs.copy()
    since_progress = 0
    for _ in range(maxiter):
        active = rs > tol * tol * b_norm2
        if not active.any():
            break
        HP = matvec_h(P)
        pHp = np.sum(P * HP, axis=0)
        alpha = np.where(active & (pHp > 0), rs / np.maximum(pHp, 1e-300), 0.0)
        X += P * alpha[None, :]
        R -= HP * alpha[None, :]
        rs_new = np.sum(R * R, axis=0)
        beta = np.where(active, rs_new / np.maximum(rs, 1e-300), 0.0)
        P = R + P * beta[None, :]
        rs = rs_new
        if np.all(rs >= 0.25 * floor):
            since_progress += 1
            if since_progress >= 10:
                break
        else:
            since_progress = 0
        floor = np.minimum(floor, rs)
    return X


def _lanczos(matvec_h: Matvec, Z: np.ndarray, m: int, reorth: bool = False,
             need_basis: bool = True):
    """Batched Lanczos: for each column z of Z run m steps, returning the
    tridiagonal coefficients (alphas (m, r), betas (m-1, r)) and the
    initial norms. ``reorth=False`` is the plain 3-term recurrence
    (adequate for quadrature use); ``reorth=True`` fully reorthogonalizes
    each step against the stored basis (needed when the basis is reused
    for shifted SOLVES, where loss of orthogonality degrades accuracy)."""
    n, r = Z.shape
    alphas = np.zeros((m, r))
    betas = np.zeros((max(m - 1, 0), r))
    z_norm = np.linalg.norm(Z, axis=0)
    V_prev = np.zeros_like(Z)
    V = Z / np.maximum(z_norm, 1e-300)[None, :]
    beta_prev = np.zeros(r)
    # preallocated basis buffer: reorthogonalization works on views
    # (basis[:k+1]) with no per-step copies
    basis = np.empty((m, n, r)) if (need_basis or reorth) else None
    if basis is not None:
        basis[0] = V
    for k in range(m):
        Hv = matvec_h(V)
        alpha = np.sum(V * Hv, axis=0)
        alphas[k] = alpha
        Wv = Hv - V * alpha[None, :] - V_prev * beta_prev[None, :]
        if reorth:
            Vb = basis[: k + 1]                           # view, no copy
            coef = np.einsum("knr,nr->kr", Vb, Wv)
            Wv = Wv - np.einsum("knr,kr->nr", Vb, coef)
        beta = np.linalg.norm(Wv, axis=0)
        # breakdown guard (as in the reference's device Lanczos): an
        # invariant subspace zeroes the recurrence instead of amplifying
        # roundoff noise — the decoupled zero block carries no quadrature
        # or solve weight, so the built space stays exact
        ok = beta > 1e-12 * (np.abs(alpha) + beta_prev + 1e-6)
        beta = np.where(ok, beta, 0.0)
        if k < m - 1:
            betas[k] = beta
            V_prev = V
            V = np.where(ok[None, :],
                         Wv / np.maximum(beta, 1e-300)[None, :], 0.0)
            beta_prev = beta
            if basis is not None:
                basis[k + 1] = V
    return alphas, betas, z_norm, basis


def guard_steps(betas: np.ndarray) -> np.ndarray:
    """Each column's first Lanczos step whose β the breakdown guard set to
    0 (``_lanczos``, ``engine_torch._lanczos_step``: a kept β is > 0, a
    zeroed one exactly 0, and every step after it is 0 as well), or -1
    where the guard never fired. ``betas`` (m-1, r) as the recurrence
    returns them; the last step's β is never returned, so it cannot
    show."""
    hit = np.asarray(betas) == 0.0
    if hit.shape[0] == 0:
        return np.full(hit.shape[1], -1)
    return np.where(hit.any(axis=0), np.argmax(hit, axis=0), -1)


def guard_ratio_min(alphas: np.ndarray, betas: np.ndarray) -> np.ndarray:
    """Each column's smallest β_k / (|α_k| + β_{k-1}) over the steps the
    guard kept: how near the recurrence came to its breakdown guard (the
    device Lanczos zeroes a step below 1e-5 of it, the host one below
    1e-12). inf for a column with no kept step."""
    alphas, betas = np.asarray(alphas), np.asarray(betas)
    k, r = betas.shape
    if k == 0:
        return np.full(r, np.inf)
    prev = np.vstack([np.zeros((1, r)), betas[:-1]])
    ratio = np.where(betas > 0.0,
                     betas / np.maximum(np.abs(alphas[:k]) + prev, 1e-300),
                     np.inf)
    return ratio.min(axis=0)


class ShiftedKrylov:
    """One batched Lanczos pass on the UNSHIFTED kernel, reusable for
    EVERY shift δ: the Krylov space of H(δ) = K + δI is independent of δ
    (same basis V_m; tridiagonal becomes T_m + δI). One set of streamed
    store matvecs therefore serves all of:

      solve(δ)  ≈ (K+δI)⁻¹·Z      (FOM/CG-equivalent after m steps)
      isqrt(δ)  ≈ (K+δI)^(-1/2)·Z  (Lanczos function application)
      logdet(δ) ≈ SLQ log|K+δI|    (quadrature nodes shift to θ+δ)

    This is what makes the REML δ-profile cheap: the grid + refinement
    evaluate at ~35 shifts, and without the cache each evaluation re-ran
    CG (up to cg_maxiter store passes) plus a fresh probe Lanczos.
    """

    def __init__(self, matvec_k: Matvec, Z: np.ndarray, m: int,
                 reorth: bool = False, device_lanczos=None,
                 need_basis: bool = True):
        with scanlog.Phase(None, "krylov_basis"):
            self._build(matvec_k, Z, m, reorth, device_lanczos,
                        need_basis)

    def _build(self, matvec_k, Z, m, reorth, device_lanczos,
               need_basis) -> None:
        Z = np.asarray(Z, dtype=np.float64)
        n, r = Z.shape
        m = min(m, n)
        self.n, self.r, self.m = n, r, m
        self._V_dev = None
        if device_lanczos is not None:
            # the backend's device Lanczos: padded-width coefficients and
            # an (r_pad, m, n) f32 basis that stays on the device
            alphas, betas, z_norm, V_dev = device_lanczos(Z, m, reorth)
            # logdet-only users (need_basis=False) drop the basis at once —
            # quadrature needs only w/Q0/z_norm
            self._V_dev = V_dev if need_basis else None
            m = alphas.shape[0]
            self.m = m
            alphas, betas, z_norm = alphas[:, :r], betas[:, :r], z_norm[:r]
            self.V = None
        else:
            alphas, betas, z_norm, basis = _lanczos(
                matvec_k, Z, m, reorth=reorth, need_basis=need_basis)
            self.V = basis if need_basis else None        # (m, n, r)
        self.z_norm = z_norm
        self.w = np.empty((m, r))                         # Ritz values of K
        self.Q = np.empty((r, m, m))                      # eigvecs of T per col
        for j in range(r):
            T = np.diag(alphas[:, j])
            if m > 1:
                T += np.diag(betas[:, j], 1) + np.diag(betas[:, j], -1)
            w, Q = np.linalg.eigh(T)
            self.w[:, j] = w
            self.Q[j] = Q
        # what the clip below hides, kept for diagnosis (ROADMAP F5): T's
        # coefficients, the Ritz values as T gives them, and each column's
        # breakdown step
        self.alphas, self.betas = alphas, betas
        self.w_raw = self.w.copy()
        self.guard_step = guard_steps(betas)
        self.guard_ratio = guard_ratio_min(alphas, betas)
        # the kernel is PSD by construction (K = W·Wᵀ/s0, or Z·K·Zᵀ);
        # negative Ritz values are pure f32 Lanczos noise, and 1/(w+δ)
        # at small δ turns them into huge negative solve components that
        # corrupt the REML profile's small-δ end (measured at 50k×1M:
        # the resumed 5-column fit's LL became monotone-decreasing from
        # the grid edge and the downstream near-singular solve NaN'd)
        self.w = np.maximum(self.w, 0.0)
        self.Q0 = self.Q[:, 0, :].T                       # (m, r): first rows

    @staticmethod
    def cache_bytes(n: int, r: int, m: int) -> int:
        return min(m, n) * n * r * 8

    @staticmethod
    def device_bytes(n: int, r: int, m: int) -> int:
        """The bytes of the basis the device Lanczos holds: (r_pad, m, n)
        f32, r zero-padded to a multiple of 8
        (engine_torch.TiledScan.device_lanczos)."""
        return -(-r // 8) * 8 * min(m, n) * n * 4

    def _apply(self, fvals: np.ndarray,
               sl: slice = slice(None)) -> np.ndarray:
        """f(K+δI)·Z from eigen-coordinate values fvals (m, width) for
        the column slice ``sl`` (all columns by default). Slice-aware so
        a union-block caller (_UnionKrylov) pays O(width), not O(r_total),
        per trait per δ. A device basis is contracted on the device, one
        batched f32 product over the slice's columns, and the (n, width)
        result comes back as f64."""
        c = np.einsum("jkl,lj->kj", self.Q[sl], fvals * self.Q0[:, sl])
        c *= self.z_norm[sl][None, :]
        if self._V_dev is not None:
            import torch
            s0, s1, _ = sl.indices(self.r)   # resolve vs the TRUE width
            V = self._V_dev[s0:s1]                         # (w, m, n)
            cd = scanlog.to_device(c.T[:, :, None], V.device)
            out = torch.bmm(V.transpose(1, 2), cd)[:, :, 0]   # (w, n)
            return scanlog.to_host(out.T).astype(np.float64)
        return np.einsum("mnr,mr->nr", self.V[:, :, sl], c)

    def solve(self, delta: float, sl: slice = slice(None)) -> np.ndarray:
        return self._apply(
            1.0 / np.maximum(self.w[:, sl] + delta, 1e-300), sl)

    def isqrt(self, delta: float) -> np.ndarray:
        return self._apply(1.0 / np.sqrt(np.maximum(self.w + delta, 1e-300)))

    def logdet(self, delta: float) -> float:
        """SLQ estimate of log|K+δI| — requires Z to be the Hutchinson
        probe block (Rademacher)."""
        nodes = np.maximum(self.w + delta, 1e-300)
        per_probe = np.sum((self.Q0**2) * np.log(nodes), axis=0)
        return float(self.n * np.mean(per_probe))


def _tridiag_eigh(alphas: np.ndarray, betas: np.ndarray):
    """Eigen-decompose each column's tridiagonal T_m; returns
    (theta (m, r), tau0sq (m, r)) where tau0sq are squared first-row
    eigenvector components (the Gauss-quadrature weights)."""
    m, r = alphas.shape
    theta = np.empty((m, r))
    tau0 = np.empty((m, r))
    for j in range(r):
        T = np.diag(alphas[:, j])
        if m > 1:
            T += np.diag(betas[:, j], 1) + np.diag(betas[:, j], -1)
        w, Q = np.linalg.eigh(T)
        theta[:, j] = w
        tau0[:, j] = Q[0, :] ** 2
    return theta, tau0


def slq_logdet(
    matvec_h: Matvec, n: int, probes: np.ndarray, m: int = 40,
) -> float:
    """log|H| ≈ (n/r)·Σ_i Σ_k τ²_{ik} log θ_{ik} (Hutchinson + Lanczos
    quadrature). ``probes`` (n, r) are caller-provided Rademacher vectors
    — pass the SAME probes across δ/candidate evaluations."""
    alphas, betas, _, _ = _lanczos(matvec_h, probes, m, need_basis=False)
    theta, tau0 = _tridiag_eigh(alphas, betas)
    theta = np.maximum(theta, 1e-300)
    per_probe = np.sum(tau0 * np.log(theta), axis=0)
    return float(n * np.mean(per_probe))


def lanczos_isqrt_apply(matvec_h: Matvec, Z: np.ndarray, m: int = 40) -> np.ndarray:
    """H^(-1/2)·Z via Lanczos function application:
    H^(-1/2) z ≈ ‖z‖ · V_m · T_m^(-1/2) e₁ per column."""
    alphas, betas, z_norm, basis = _lanczos(matvec_h, Z, m)
    F = np.empty((m, Z.shape[1]))
    for j in range(Z.shape[1]):
        T = np.diag(alphas[:, j])
        if m > 1:
            T += np.diag(betas[:, j], 1) + np.diag(betas[:, j], -1)
        w, Q = np.linalg.eigh(T)
        F[:, j] = Q @ ((Q[0, :] / np.sqrt(np.maximum(w, 1e-300))))
    # one contraction over the basis, where the reference loops over the
    # r columns and m steps in Python
    return np.einsum("knr,kr->nr", basis, F) * z_norm[None, :]


# ---------------------------------------------------------------------------
# Matrix-free REML
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MatfreeContext:
    """Shared state for one scan: the kernel matvec, common probes, and
    the per-scan shift-invariant Krylov caches (K is FIXED for the whole
    scan, so its Lanczos decompositions of the fixed probe blocks are
    iteration- and δ-invariant)."""

    kernel_matvec: Matvec       # V ↦ K_norm·V  (normalized kernel)
    n: int
    probes: np.ndarray          # (n, r) Rademacher, fixed for the scan
    lanczos_m: int = 40
    cg_tol: float = 1e-8
    cg_maxiter: int = 400
    solve_m: int = 128          # Lanczos steps for cached shifted solves
    # refit basis depth: candidate accept-tests arrive with a delta_hint
    # (δ̂ moves slowly across forward steps) and their final LL is an
    # exact warm-started CG regardless — the basis only locates δ̂, where
    # the LL is flat (dLL/dδ = 0), so half the depth costs ~nothing in
    # decision accuracy and halves the dominant per-iteration store work
    solve_m_refit: int = 64
    # the budget counts a basis as the reference's host f64 one (V is
    # m·n·r f64), so the port takes the same cache and chunking decisions,
    # save for the sweep's probe basis: it is counted where it is held
    # (_probe_basis)
    cache_max_bytes: int = 2 << 30
    # device-resident CG: (B, delta, tol, maxiter, x0=) -> X
    # (engine_torch.TiledScan.device_cg with s0 bound) — the X/R/P block
    # state stays on the device, the host reads (r,) norms per step
    device_solve: Optional[Callable[..., np.ndarray]] = None
    # device-resident Lanczos: (Z, m, reorth) -> (alphas, betas, z_norm,
    # basis_dev) — ShiftedKrylov keeps the basis on the device
    device_lanczos: Optional[Callable] = None
    # record → individual index of a one-hot Zmat (None: no Zmat, or one
    # that is not one-hot); Zᵀ·A and Z·W become a segment sum and a gather
    z_idx: Optional[np.ndarray] = None
    _logdet_sk: Optional[ShiftedKrylov] = dataclasses.field(
        default=None, init=False, repr=False)
    _isqrt_sk: Optional[ShiftedKrylov] = dataclasses.field(
        default=None, init=False, repr=False)
    _isqrt_probes_ref: Optional[np.ndarray] = dataclasses.field(
        default=None, init=False, repr=False)

    def h_matvec(self, delta: float) -> Matvec:
        return lambda V: self.kernel_matvec(V) + delta * V

    def solve_block(self, delta: float, B: np.ndarray,
                    x0: Optional[np.ndarray] = None) -> np.ndarray:
        """H(δ)⁻¹·B: :meth:`solve_block_shifts` with δ for every column."""
        return self.solve_block_shifts(np.full(B.shape[1], delta), B, x0=x0)

    def solve_block_shifts(self, shifts: np.ndarray, B: np.ndarray,
                           x0: Optional[np.ndarray] = None) -> np.ndarray:
        """H(δ_col)⁻¹·B with a PER-COLUMN shift δ (one per RHS column), by
        the device CG when it is wired, else the host blocked CG. ``x0``
        (e.g. a cached Krylov solve at the same δ) warm-starts either; the
        result meets the same relative tolerance as a cold solve.

        The multi-shift batched solve behind the lockstep multi-trait and
        permutation paths: trait operators H_t = K/s0 + δ_t·I differ only
        in the diagonal, so one kernel matvec per CG iteration (one stack
        pass) serves every trait's columns (blocked CG freezes converged
        columns)."""
        shifts = np.asarray(shifts, dtype=np.float64)
        if shifts.shape != (B.shape[1],):
            raise ValueError(f"{shifts.shape[0]} shifts for {B.shape[1]} "
                             "columns")
        if x0 is not None and x0.shape != B.shape:
            x0 = None
        if self.device_solve is not None:
            return self.device_solve(B, shifts, self.cg_tol, self.cg_maxiter,
                                     x0=x0)
        return blocked_cg(
            lambda V: self.kernel_matvec(V) + V * shifts[None, :],
            B, tol=self.cg_tol, maxiter=self.cg_maxiter, x0=x0)

    def z_apply(self, Z: Optional[np.ndarray], W: np.ndarray) -> np.ndarray:
        """Z·W (individual-level columns to record level); a gather when
        Z is one-hot, the identity without a Zmat."""
        if Z is None:
            return W
        return W[self.z_idx] if self.z_idx is not None else Z @ W

    def zt_apply(self, Z: Optional[np.ndarray], A: np.ndarray) -> np.ndarray:
        """Zᵀ·A (record-level columns to individual level); a segment sum
        when Z is one-hot, the identity without a Zmat."""
        if Z is None:
            return A
        if self.z_idx is None:
            return Z.T @ A
        out = np.zeros((Z.shape[1],) + A.shape[1:])
        np.add.at(out, self.z_idx, A)
        return out

    def _probe_basis(self, probes: np.ndarray) -> Optional[ShiftedKrylov]:
        """The cached Krylov basis of the probe block, built on first use
        (and again for a different block: the cache is held to the block's
        values, not its shape); None when it is over the budget, which
        counts the basis where it is held: the card's f32 basis where the
        device Lanczos is wired, else the host recurrence's f64 one (the
        reference's count). The innermost open span counts ``cached``: 1
        when the basis was already built, 0 when this call built it."""
        size = (ShiftedKrylov.cache_bytes if self.device_lanczos is None
                else ShiftedKrylov.device_bytes)
        if size(*probes.shape, self.lanczos_m) > self.cache_max_bytes:
            return None
        if self._isqrt_sk is not None \
                and self._isqrt_probes_ref.shape == probes.shape \
                and np.array_equal(self._isqrt_probes_ref, probes):
            scanlog.count(cached=1)
            return self._isqrt_sk
        scanlog.count(cached=0)
        self._isqrt_sk = ShiftedKrylov(self.kernel_matvec, probes,
                                       self.lanczos_m,
                                       device_lanczos=self.device_lanczos)
        self._isqrt_probes_ref = probes
        return self._isqrt_sk

    def isqrt_probes_shifts(self, deltas, probes: np.ndarray
                            ) -> list[np.ndarray]:
        """(K+δ_t·I)^(-1/2)·probes for each shift δ_t: the cached probe
        basis when it fits the budget (:meth:`_probe_basis`); over it, one
        uncached device Lanczos serves every shift, so R traits or
        permutations cost one set of stack passes, not R (the span counts
        ``cached`` 0). Without the device hook each shift runs the host
        recurrence (a host basis is what the budget bounds)."""
        sk = self._probe_basis(probes)
        if sk is None:
            scanlog.count(cached=0)
            if self.device_lanczos is None:
                return [lanczos_isqrt_apply(self.h_matvec(d), probes,
                                            m=self.lanczos_m)
                        for d in deltas]
            sk = ShiftedKrylov(self.kernel_matvec, probes, self.lanczos_m,
                               device_lanczos=self.device_lanczos)
        return [sk.isqrt(d) for d in deltas]

    def logdet(self, delta: float) -> float:
        """log|K+δI| from the scan-wide probe Lanczos (built once;
        quadrature needs only the tridiagonal — no basis is retained)."""
        if self._logdet_sk is None:
            self._logdet_sk = ShiftedKrylov(
                self.kernel_matvec, self.probes, self.lanczos_m,
                device_lanczos=self.device_lanczos, need_basis=False)
        return self._logdet_sk.logdet(delta)

    def isqrt_probes(self, delta: float, probes: np.ndarray) -> np.ndarray:
        """(K+δI)^(-1/2)·probes: :meth:`isqrt_probes_shifts` at one
        shift."""
        return self.isqrt_probes_shifts([delta], probes)[0]


def _ll_from_solution(y, X, Sol, logdetH):
    """(LL, yᵀP̃y) from a solution block Sol ≈ H⁻¹·[X y] (EMMA constant
    convention, reml_core)."""
    n, q = X.shape
    nq = n - q
    HiX, Hiy = Sol[:, :q], Sol[:, q]
    XtHiX = X.T @ HiX
    XtHiy = X.T @ Hiy
    yPy = float(y @ Hiy - XtHiy @ np.linalg.solve(XtHiX, XtHiy))
    if yPy <= 0:
        return -math.inf, yPy
    s1, ld1 = np.linalg.slogdet(XtHiX)
    s2, ld2 = np.linalg.slogdet(X.T @ X)
    if s1 <= 0 or s2 <= 0:
        return -math.inf, yPy
    ll = 0.5 * (
        nq * math.log(nq / (2.0 * math.pi)) - nq - nq * math.log(yPy)
        - (logdetH + ld1 - ld2)
    )
    return ll, yPy


def reml_loglik_matfree(
    ctx: MatfreeContext, delta: float, y: np.ndarray, X: np.ndarray,
    x0: Optional[np.ndarray] = None,
) -> tuple[float, float]:
    """(LL(δ), yᵀP̃y): exact blocked-CG solves + cached SLQ logdet.
    ``x0`` warm-starts the solves (same tolerance as a cold solve)."""
    X, _ = reml_core.independent_cols(np.asarray(X, np.float64))
    B = np.column_stack([X, y])
    return _ll_from_solution(y, X, ctx.solve_block(delta, B, x0=x0),
                             ctx.logdet(delta))


def reml_maximize_matfree(
    ctx: MatfreeContext, y: np.ndarray, X: np.ndarray,
    llim: float = -6.0, ulim: float = 8.0, ngrids: int = 24,
    delta_hint: Optional[float] = None,
    return_sk: bool = False,
    solver: Optional[Callable[[float], np.ndarray]] = None,
):
    """Grid + golden-refine on the matrix-free LL. The grid is coarser
    than the exact path (each evaluation costs CG passes over the store);
    common probes make the profile smooth in δ. ``delta_hint`` (the
    previous iteration's optimum) narrows the grid to ±2 in log-δ AND
    shrinks the Lanczos basis to ``ctx.solve_m_refit`` — forward
    selection moves δ̂ slowly and LL is flat at its optimum, so the
    hinted refit needs far fewer store passes for the same decision.
    The final fit values at δ̂ always come from an exact CG solve
    (warm-started from the basis), so reported LL/σ² are basis-depth-
    independent to the CG tolerance.

    ``return_sk=True`` additionally returns the reorthogonalized
    ShiftedKrylov basis on [X y] (or None when it didn't fit the cache
    budget) — the caller can reuse it to warm-start the next sweep's
    H⁻¹[X y] solves (K is scan-invariant; only δ moves).

    ``solver`` (δ → H(δ)⁻¹[X y], width rank(X)+1) replaces the internal
    basis build entirely — the multi-trait driver passes column slices of
    ONE union-block Krylov basis shared by every trait, so R traits cost
    one set of store passes instead of R."""
    m_basis = ctx.solve_m
    if delta_hint is not None and delta_hint > 0:
        c = math.log(delta_hint)
        llim = max(llim, c - 2.0)
        ulim = min(ulim, c + 2.0)
        if llim >= ulim:
            llim, ulim = c - 2.0, c + 2.0
        ngrids = min(ngrids, 8)
        m_basis = min(ctx.solve_m, max(ctx.solve_m_refit, 16))

    # One reorthogonalized Lanczos pass on [X y] serves the WHOLE δ search
    # (shift-invariant Krylov space) — vs one full CG per grid point.
    Xi, _ = reml_core.independent_cols(np.asarray(X, np.float64))
    B = np.column_stack([Xi, y])
    sk = None
    if solver is not None:
        # width check via the solver's advertised shape when it has one
        # (a _UnionKrylov slice) — probing with a full solve just for the
        # shape costs an O(n·m·width) apply
        sshape = getattr(solver, "shape", None)
        if sshape is not None:
            if tuple(sshape) != B.shape:
                solver = None  # rank changed under the caller
        else:
            probe = solver(1.0)
            if probe is None or probe.shape != B.shape:
                solver = None
    if solver is not None:
        def ll_of(d: float) -> float:
            return _ll_from_solution(y, Xi, solver(d), ctx.logdet(d))[0]
    elif ShiftedKrylov.cache_bytes(*B.shape, m_basis) <= ctx.cache_max_bytes:
        sk = ShiftedKrylov(ctx.kernel_matvec, B, m=m_basis, reorth=True,
                           device_lanczos=ctx.device_lanczos)

        def ll_of(d: float) -> float:
            return _ll_from_solution(y, Xi, sk.solve(d), ctx.logdet(d))[0]
    else:
        def ll_of(d: float) -> float:
            return reml_loglik_matfree(ctx, d, y, X)[0]

    with scanlog.Phase(None, "delta_search"):
        grid = np.exp(np.linspace(llim, ulim, ngrids + 1))
        lls = np.array([ll_of(d) for d in grid])
        lls = np.where(np.isfinite(lls), lls, -np.inf)  # NaN never wins
        i = int(np.argmax(lls))
        lo = grid[max(i - 1, 0)]
        hi = grid[min(i + 1, ngrids)]
        # golden-section refinement on log-delta
        import scipy.optimize as _opt
        res = _opt.minimize_scalar(
            lambda ld: -ll_of(math.exp(ld)),
            bounds=(math.log(lo), math.log(hi)), method="bounded",
            options={"xatol": 1e-3},
        )
        delta = float(math.exp(res.x))
    # final fit values at δ̂ use exact CG solves (decision-path accuracy),
    # warm-started from the basis solution at δ̂ when one exists
    with scanlog.Phase(None, "polish"):
        x0 = solver(delta) if solver is not None else (
            sk.solve(delta) if sk else None)
        ll, yPy = reml_loglik_matfree(ctx, delta, y, X, x0=x0)
    # nq uses the RANK of X (independent_cols-reduced), matching the
    # n−q convention of the LL itself — collinear columns don't inflate σ²
    nq = y.shape[0] - Xi.shape[1]
    s2g = yPy / nq
    out = reml_core.RemlResult(delta=delta, loglik=ll, sigma2_g=s2g,
                               sigma2_e=delta * s2g)
    return (out, sk) if return_sk else out


# ---------------------------------------------------------------------------
# Matrix-free score sweep
# ---------------------------------------------------------------------------


def score_sweep_matfree(
    ctx: MatfreeContext,
    backend,                     # TiledScan / MultiHostTiledScan
    y: np.ndarray,
    X: np.ndarray,
    fit: reml_core.RemlResult,
    exclude: Optional[list[int]] = None,
    sol0: Optional[np.ndarray] = None,
    **kw,
) -> tuple[np.ndarray, int, dict]:
    """One trait's sweep, ``(t, cand, info)``: the one-trait case of
    :func:`score_sweep_matfree_multi`, whose keywords ``kw`` are
    (``exclude`` and ``sol0`` are its one-element ``excludes``/``sol0s``)."""
    return score_sweep_matfree_multi(
        ctx, backend, [y], [X], [fit],
        excludes=[[] if exclude is None else exclude], sol0s=[sol0],
        **kw)[0]


def _sweep_cache(sweep_ckpt: str, y: np.ndarray, X: np.ndarray,
                 fit: reml_core.RemlResult, exclude
                 ) -> tuple[str, str]:
    """(file, key) of a one-trait sweep's stage-0 cache: this process's
    ``sweep_h<process>.npz`` in ``sweep_ckpt``, keyed by the exact
    decision state (trait/X/δ/σ moments + exclusions)."""
    import hashlib

    from eagleeverything_tpu_torch.utils import distributed

    n, q = X.shape
    h = hashlib.sha256()
    h.update(np.asarray(
        [n, q, fit.delta, fit.sigma2_g, float(np.sum(y)),
         float(y @ y), float(np.sum(X * X))]
        + sorted(exclude)).tobytes())
    os.makedirs(sweep_ckpt, exist_ok=True)
    return (os.path.join(sweep_ckpt,
                         f"sweep_h{distributed.process_index()}.npz"),
            h.hexdigest()[:16])


def _sweep_stats(ctx: MatfreeContext, backend, ys, Xs, deltas, sol0s,
                 diag_probes: int, Z: Optional[np.ndarray]):
    """Stage 0 of the sweep: every trait's [X y] solve (one multi-shift
    CG), its probe block's H^(-1/2) and ONE stat-row pass over the stack.
    Returns per-trait (ahat, U, diag, proj) rows and (XᵀH⁻¹X)⁻¹."""
    R, n = len(ys), ys[0].shape[0]
    qs = [X.shape[1] for X in Xs]
    B_cat = np.concatenate(
        [np.column_stack([Xs[t], ys[t]]) for t in range(R)], axis=1)
    shifts = np.concatenate([np.full(q + 1, d) for q, d in zip(qs, deltas)])
    x0 = None
    if all(s is not None and s.shape == (n, q + 1)
           for s, q in zip(sol0s, qs)):
        x0 = np.concatenate(sol0s, axis=1)
    with scanlog.Phase(None, "solve"):
        # sol0 (the accept-test's Krylov solve of the SAME [X y] block at
        # the same δ̂) warm-starts the CG — typically a handful of
        # polishing iterations, not a cold solve
        Sol_cat = ctx.solve_block_shifts(shifts, B_cat, x0=x0)
        Py_t, HiX_t, Minv_t = [], [], []
        c0 = 0
        for X, q in zip(Xs, qs):
            HiX, Hiy = Sol_cat[:, c0 : c0 + q], Sol_cat[:, c0 + q]
            c0 += q + 1
            XtHiX = X.T @ HiX
            Py_t.append(Hiy - HiX @ np.linalg.solve(XtHiX, X.T @ Hiy))
            HiX_t.append(HiX)
            Minv_t.append(np.linalg.inv(XtHiX))

    # one probe block (seed 12345) for every trait and sweep: per-trait
    # H_t^(-1/2)·probes are cheap per-δ applies of ONE probe-Krylov basis
    # (cached, or one uncached device pass over the budget)
    with scanlog.Phase(None, "probes"):
        rng = np.random.default_rng(12345)
        probes = rng.choice((-1.0, 1.0), size=(n, diag_probes))
        HZ_t = ctx.isqrt_probes_shifts(deltas, probes)

    # one device pass computes every trait's per-SNP statistics; with an
    # incidence matrix the effective sweep columns are Z·w_j, so dots
    # against record-level vectors become Wᵀ·(Zᵀ·A). The resident packed
    # stack reduces the probe block on device
    # (engine_torch.TiledScan.matfree_stat_rows_multi: (p, q+3) a trait
    # transferred, not (p, 1+q+r))
    with scanlog.Phase(None, "stat_pass"):
        A_list = [ctx.zt_apply(Z, np.column_stack([Py_t[t], HiX_t[t],
                                                   HZ_t[t]]))
                  for t in range(R)]
        stats = backend.matfree_stat_rows_multi(A_list, qs, Minv_t)
    return stats, Minv_t


def score_sweep_matfree_multi(
    ctx: MatfreeContext,
    backend,                     # TiledScan / MultiHostTiledScan
    ys: list[np.ndarray],
    Xs: list[np.ndarray],
    fits: list[reml_core.RemlResult],
    diag_probes: int = 128,
    exact_topk: int = 64,
    column_f64: Optional[Callable[[int], np.ndarray]] = None,
    Z: Optional[np.ndarray] = None,
    guard_sigmas: float = 4.0,
    max_escalation_rounds: int = 4,
    excludes: Optional[list[list[int]]] = None,
    sol0s: Optional[list[Optional[np.ndarray]]] = None,
    escalation_batch: Optional[int] = None,
    sweep_ckpt: Optional[str] = None,
) -> list[tuple[np.ndarray, int, dict]]:
    """All-SNP outlier statistics without P̃ as a matrix, for R traits (or
    permutations) on ONE set of store passes (SURVEY.md §4.3's batching
    rule); one trait is the case R = 1.

      t_j = â_j² / (σ²_g·vara_j),  â_j = w_jᵀ·P̃y,
      vara_j = w_jᵀH⁻¹w_j − u_jᵀ(XᵀH⁻¹X)⁻¹u_j,  u_j = (H⁻¹X)ᵀw_j

    - P̃y and H⁻¹X: every trait's [X_t y_t] block in ONE multi-shift
      device CG (``solve_block_shifts``: H_t differ only by δ_t, so one
      kernel matvec per iteration serves every trait's columns).
    - â and u for ALL p SNPs, and diag(WᵀH⁻¹W) by Hutchinson —
      E_z[(WᵀH^(-1/2)z)²] with H^(-1/2)z by Lanczos, one probe block
      (seed 12345) for every trait: ONE ``matfree_stat_rows_multi`` pass
      over the stack.
    - The top ``exact_topk`` candidates of each trait by the probe
      estimate are rescored EXACTLY (CG solves H⁻¹w_j), THEN an
      escalation guard rescores any SNP whose probe estimate, inflated to
      the upper edge of the Hutchinson noise envelope (``guard_sigmas``
      standard errors of the diagonal estimate, relative std ≈ √(2/r)),
      could still beat the trait's shortlist maximum — so each returned
      argmax is exact unless ``max_escalation_rounds`` is exhausted. Each
      round rescores every trait's whole violating set (up to
      ``escalation_batch``, default max(exact_topk, 128) a trait) in ONE
      multi-shift CG; rounds advance in LOCKSTEP across traits.
      Exhaustion with live candidates is LOUD: it is reported in the
      trait's info dict, never silently folded into the argmax.
    - ``excludes`` (each trait's selected SNPs) are masked out BEFORE the
      shortlist, so a returned candidate is never a selected SNP and the
      decision never falls back to non-rescored estimates.
    - ``Z`` (an incidence matrix shared by every trait): the stat pass
      takes Zᵀ·A, the rescore the record-level columns Z·w_j.
    - ``sweep_ckpt`` (one trait only): stage 0's output — a few MB, where
      the CG and the stack pass are hours of a CPU-mesh iteration at
      biobank n — is cached in that directory (:func:`_sweep_cache`), so a
      scan killed mid-sweep resumes at the rescore (VERDICT r4 weak 1).
      Multi-host: each process caches its LOCAL rows under its own suffix.

    Returns, a trait, ``(t, cand, info)``; ``info`` carries the guard
    bookkeeping: ``escalation_rounds`` executed, ``exhausted`` (True iff
    candidates still violated the noise bound when the round budget ran
    out — the argmax is then unproven), and ``n_rescored``.

    Multi-host SPMD: with a backend exposing ``snp_range`` (process-local
    rows; MultiHostTiledScan), the per-SNP dot block stays host-local —
    only the O(p) statistic vectors, the O(k·q) shortlist rows, and the
    variable-length escalation sets cross hosts (deterministic f64
    collectives, utils/distributed). Every host executes the SAME CG
    rescoring calls in lockstep, as the collective kernel matvec requires.

    Scale note: H here is built on the NORMALIZED kernel K/s0, while the
    w_j dotted against it are the raw recoded columns — but t_j is
    invariant to any uniform rescaling of w_j (it cancels between â² and
    σ²_g·vara, see models/oracle.py), so no column scaling is needed.
    """
    from eagleeverything_tpu_torch.utils import distributed

    R = len(ys)
    excludes = excludes if excludes is not None else [[] for _ in range(R)]
    sol0s = sol0s if sol0s is not None else [None] * R
    deltas = np.array([f.delta for f in fits])
    Xs = [reml_core.independent_cols(np.asarray(X, np.float64))[0]
          for X in Xs]
    qs = [X.shape[1] for X in Xs]

    ck_file = cached = None
    if sweep_ckpt is not None:
        if R != 1:
            raise ValueError("the sweep cache holds one trait")
        ck_file, key = _sweep_cache(sweep_ckpt, ys[0], Xs[0], fits[0],
                                    excludes[0])
        if os.path.exists(ck_file):
            z = np.load(ck_file)
            if "key" in z.files and str(z["key"]) == key:
                cached = z
    if cached is not None:
        stats = [(cached["ahat_l"], cached["U_l"], cached["diag_l"],
                  cached["proj_l"])]
        Minv_t = [cached["XtHiX_inv"]]
    else:
        stats, Minv_t = _sweep_stats(ctx, backend, ys, Xs, deltas, sol0s,
                                     diag_probes, Z)
        if ck_file is not None:
            tmp = ck_file + f".tmp.{os.getpid()}"
            ahat_l, U_l, diag_l, proj_l = stats[0]
            with open(tmp, "wb") as f:
                np.savez(f, key=key, ahat_l=ahat_l, U_l=U_l, diag_l=diag_l,
                         proj_l=proj_l, XtHiX_inv=Minv_t[0])
            os.replace(tmp, ck_file)

    mh = getattr(backend, "snp_range", None)
    lo = mh[0] if mh is not None else 0
    p = backend.p_global if mh is not None else stats[0][0].shape[0]
    p_l = stats[0][0].shape[0]

    t_est_t, excluded_t = [], []
    for t in range(R):
        ahat_l, U_l, diag_l, proj_l = stats[t]
        vara_l = fits[t].sigma2_g * np.maximum(diag_l - proj_l, 1e-12)
        with np.errstate(divide="ignore", invalid="ignore"):
            te_l = np.where(vara_l > 1e-12, ahat_l * ahat_l / vara_l, 0.0)
        te = (distributed.allgather_concat_f64(te_l, backend.local_sizes)
              if mh is not None else te_l)
        excl = np.zeros(p, dtype=bool)
        if len(excludes[t]):
            excl[np.asarray(excludes[t], dtype=np.int64)] = True
            te[excl] = 0.0
        t_est_t.append(te)
        excluded_t.append(excl)

    if exact_topk <= 0 or column_f64 is None:
        return [(t_est_t[t], int(np.argmax(t_est_t[t])),
                 {"escalation_rounds": 0, "exhausted": False,
                  "n_rescored": 0}) for t in range(R)]

    # excluded SNPs never enter the shortlist, the escalation bound, or
    # the final argmax — treat them as already-settled at t = 0
    t_t = [te.copy() for te in t_est_t]
    rescored_t = [excluded_t[t].copy() for t in range(R)]

    def rescore_batched(idx_lists: list[np.ndarray]) -> list[np.ndarray]:
        """Exact t per trait for per-trait global SNP index lists — ONE
        multi-shift CG over the concatenated (record-level) candidate
        columns (collective: every host solves the same block) + the
        (â, u) rows gathered from their owning host."""
        widths = [len(ix) for ix in idx_lists]
        if sum(widths) == 0:
            return [np.zeros(0) for _ in range(R)]
        Wsel = ctx.z_apply(Z, np.column_stack(
            [column_f64(int(j)) for ix in idx_lists for j in ix]))
        sh = np.concatenate(
            [np.full(widths[t], deltas[t]) for t in range(R)])
        HiW = ctx.solve_block_shifts(sh, Wsel)
        out, c0 = [], 0
        for t in range(R):
            w = widths[t]
            Ws, Hs = Wsel[:, c0 : c0 + w], HiW[:, c0 : c0 + w]
            c0 += w
            if w == 0:
                out.append(np.zeros(0))
                continue
            diag_exact = np.sum(Ws * Hs, axis=0)
            ahat_l, U_l = stats[t][0], stats[t][1]
            rows = np.zeros((w, 1 + qs[t]))
            for i, j in enumerate(idx_lists[t]):
                jl = int(j) - lo
                if 0 <= jl < p_l:
                    rows[i, 0] = ahat_l[jl]
                    rows[i, 1:] = U_l[jl]
            if mh is not None:
                rows = distributed.allreduce_sum_f64(rows)
            a_r, u_r = rows[:, 0], rows[:, 1:]
            proj_r = np.einsum("jq,qr,jr->j", u_r, Minv_t[t], u_r)
            vara_r = fits[t].sigma2_g * np.maximum(diag_exact - proj_r,
                                                   1e-12)
            out.append(np.where(vara_r > 1e-12, a_r * a_r / vara_r, 0.0))
        return out

    # stage 1: per-trait probe-ranked shortlists (non-excluded), one
    # batched CG
    tops, t_best = [], [0.0] * R
    with scanlog.Phase(None, "rescore"):
        for t in range(R):
            elig = np.nonzero(~excluded_t[t])[0]
            k = min(exact_topk, elig.size)
            top = elig[np.argpartition(t_est_t[t][elig], -k)[-k:]] \
                if k > 0 else np.zeros(0, np.int64)
            tops.append(top[np.argsort(-t_est_t[t][top], kind="stable")])
        ts1 = rescore_batched(tops)
        for t in range(R):
            if tops[t].size:
                t_t[t][tops[t]] = ts1[t]
                rescored_t[t][tops[t]] = True
                t_best[t] = float(ts1[t].max())

    # stage 2 — escalation guard: with r probes the diagonal estimate has
    # relative std ≈ √(2/r); any non-rescored SNP whose statistic at the
    # guard_sigmas-deflated diagonal could exceed its trait's exact max is
    # rescored too (the sets are agreed globally so the collective CG
    # calls stay in lockstep). Rounds strictly shrink the candidate sets
    # because rescored only grows and t_best only rises. A round rescores
    # each trait's WHOLE violating set (blocked CG serves every column
    # with the same kernel matvecs, so a wide rescore costs the same
    # number of STORE PASSES as a narrow one); the cap bounds host memory
    # and column-fetch traffic (VERDICT r4 item 4: ~77 s a sweep of
    # narrow rounds at 50k×1M folded into one)
    rel = min(0.9, guard_sigmas * math.sqrt(2.0 / max(diag_probes, 1)))
    rounds = [0] * R
    exhausted = [False] * R
    cap = escalation_batch if escalation_batch is not None \
        else max(exact_topk, 128)
    for round_i in range(max_escalation_rounds + 1):
        with scanlog.Phase(None, "escalate"):
            esc_sets = []
            for t in range(R):
                ahat_l, _, diag_l, proj_l = stats[t]
                vara_lb_l = fits[t].sigma2_g * np.maximum(
                    diag_l * (1.0 - rel) - proj_l, 1e-12)
                with np.errstate(divide="ignore", invalid="ignore"):
                    t_ub_l = np.where(vara_lb_l > 1e-12,
                                      ahat_l * ahat_l / vara_lb_l, 0.0)
                t_ub_l = np.where(rescored_t[t][lo : lo + p_l], 0.0,
                                  t_ub_l)
                cand_l = np.nonzero(t_ub_l > t_best[t])[0]
                pairs_l = np.column_stack([
                    (cand_l + lo).astype(np.float64), t_ub_l[cand_l]])
                pairs = (distributed.allgather_varlen_f64(pairs_l)
                         if mh is not None else pairs_l)
                if pairs.shape[0] == 0:
                    esc_sets.append(np.zeros(0, np.int64))
                    continue
                # deterministic order: descending bound, ties by
                # ascending index
                order = np.lexsort((pairs[:, 0], -pairs[:, 1]))
                esc_sets.append(pairs[order[:cap], 0].astype(np.int64))
            live = [t for t in range(R) if esc_sets[t].size]
            if not live:
                break  # every bound is dominated: each argmax is proven
            if round_i == max_escalation_rounds:
                # round budget spent with candidates still above the noise
                # bound — those traits' argmax below is UNPROVEN
                for t in live:
                    exhausted[t] = True
                break
            ts = rescore_batched(esc_sets)
            for t in live:
                t_t[t][esc_sets[t]] = ts[t]
                rescored_t[t][esc_sets[t]] = True
                t_best[t] = max(t_best[t], float(ts[t].max()))
                rounds[t] += 1

    # argmax over exactly-rescored, non-excluded entries (ascending index
    # order → lowest global index wins ties, the find_qtl contract); a
    # trait with no eligible SNP returns candidate 0 with t = 0
    out = []
    for t in range(R):
        exact_idx = np.nonzero(rescored_t[t] & ~excluded_t[t])[0]
        if exact_idx.size == 0:
            out.append((t_t[t], 0, {"escalation_rounds": 0,
                                    "exhausted": False, "n_rescored": 0}))
            continue
        cand = int(exact_idx[int(np.argmax(t_t[t][exact_idx]))])
        out.append((t_t[t], cand, {
            "escalation_rounds": rounds[t], "exhausted": exhausted[t],
            "n_rescored": int(np.count_nonzero(
                rescored_t[t] & ~excluded_t[t]))}))
    return out


def gls_wald_stats_matfree(
    solve_block, y: np.ndarray, X0: np.ndarray, Wcols: np.ndarray,
    indices, delta: float, sigma2_g: float, sigma2_e: float,
):
    """Matrix-free GLS + Wald tests (reference ``SummaryAM()`` at biobank
    n): identical algebra to oracle.gls_wald_stats but V⁻¹-products come
    from CG solves against the kernel matvec — V = σ²_g·(K+δI) is never
    materialized. Uses the scan's own (δ, σ²) fit for the final model."""
    from scipy import stats as _stats

    from eagleeverything_tpu_torch.models.oracle import WaldSummary

    idx = list(indices)
    X = np.hstack([X0, Wcols])
    B = np.column_stack([X, y])
    Sol = solve_block(delta, B)                 # H⁻¹·[X y]
    HiX, Hiy = Sol[:, :-1], Sol[:, -1]
    XtVinvX = (X.T @ HiX) / sigma2_g
    cov = np.linalg.inv(XtVinvX)
    beta = cov @ (X.T @ Hiy) / sigma2_g
    q0 = X0.shape[1]
    b = beta[q0:]
    se = np.sqrt(np.diag(cov)[q0:])
    wald = (b / se) ** 2
    pval = _stats.chi2.sf(wald, df=1)
    vary = float(np.var(y))
    varexp = np.array(
        [float(b[i] ** 2 * np.var(Wcols[:, i])) / vary if vary > 0 else 0.0
         for i in range(len(idx))])
    return WaldSummary(
        indices=idx, beta=b, se=se, wald=wald, pvalue=pval,
        var_explained=varexp, sigma2_g=sigma2_g, sigma2_e=sigma2_e,
    )


def make_context(backend, n: int, Z: Optional[np.ndarray] = None,
                 probes: int = 32, seed: int = 4242,
                 lanczos_m: int = 40,
                 s0: Optional[float] = None) -> MatfreeContext:
    """Build a MatfreeContext over a scan backend: Hutchinson s0 estimate,
    normalized (optionally Z-wrapped) kernel matvec, and the device CG and
    Lanczos hooks (shared by the scan and summary).

    A one-hot Z (one individual a record) reduces to an index vector:
    Zᵀ·V is a segment sum and Z·U a gather, on the device inside the CG
    and Lanczos steps, so repeated-measures designs keep the device
    Krylov path. Any other Z (weights, several links a record) gets no
    device hooks: its matvec Z·K·(Zᵀ·V)/s0 is wrapped on the host, solves
    take :func:`blocked_cg` and recurrences the host :func:`_lanczos`."""
    n_ind = backend.src.n
    if s0 is None:
        # mean diag of MMt = E_j ‖w_j‖² — estimate with one probe pass:
        # tr(MMt)/n = Σ_j ‖w_j‖²/n via Hutchinson on MMt
        with scanlog.Phase(None, "s0"):
            rng0 = np.random.default_rng(0)
            Zp = rng0.choice((-1.0, 1.0), size=(n_ind, 16))
            KZ = backend.kernel_matvec(Zp)
            s0 = float(np.mean(np.sum(Zp * KZ, axis=0)) / n_ind)
    s0 = s0 if s0 > 0 else 1.0

    z_idx = None
    if Z is not None:
        Z = np.asarray(Z, dtype=np.float64)
        # one-hot: each row's largest entry is 1 and the rows hold n_rec
        # nonzeros in all, so that 1 is a row's only nonzero (its row sum
        # is then 1, which the reference also tests) — two vectorised
        # passes over Z, tens of GB at biobank n
        cand = np.argmax(Z, axis=1)
        if (np.all(Z[np.arange(Z.shape[0]), cand] == 1.0)
                and np.count_nonzero(Z) == Z.shape[0]):
            z_idx = cand.astype(np.int64)

    if Z is None:
        def kernel_matvec(V):
            return backend.kernel_matvec(V) / s0
    elif z_idx is not None:
        def kernel_matvec(V):
            Vi = np.zeros((n_ind, V.shape[1]))
            np.add.at(Vi, z_idx, V)
            return backend.kernel_matvec(Vi)[z_idx] / s0
    else:
        def kernel_matvec(V):
            return Z @ backend.kernel_matvec(Z.T @ V) / s0

    device_solve = device_lanczos = None
    if Z is None or z_idx is not None:
        def device_solve(B, delta, tol, maxiter, x0=None):
            return backend.device_cg(B, delta, s0, tol=tol, maxiter=maxiter,
                                     x0=x0, z_idx=z_idx)

        def device_lanczos(Zc, m, reorth):
            return backend.device_lanczos(Zc, m, reorth, s0, z_idx=z_idx)

    rng = np.random.default_rng(seed)
    return MatfreeContext(
        kernel_matvec=kernel_matvec, n=n,
        probes=rng.choice((-1.0, 1.0), size=(n, probes)),
        lanczos_m=lanczos_m,
        device_solve=device_solve,
        device_lanczos=device_lanczos,
        z_idx=z_idx,
    )


# ---------------------------------------------------------------------------
# Forward selection on the matrix-free pieces, one trait or R in lockstep
# ---------------------------------------------------------------------------


def forward_select_matfree(
    y: np.ndarray,
    X0: np.ndarray,
    backend,                       # TiledScan over the genotype source
    **kw,
) -> AMResult:
    """The AM loop with matrix-free REML + sweep (biobank n-scale mode) for
    one trait: the one-trait case of :func:`forward_select_matfree_multi`,
    whose keywords these are, with am()'s files in ``ckpt_dir``
    (``scan_state.json`` and the sweep's stage-0 cache)."""
    return forward_select_matfree_multi(
        np.asarray(y, dtype=np.float64)[None], X0, backend,
        _single_state=True, **kw)[0]


class _UnionKrylov:
    """ONE batched reorthogonalized Lanczos pass over the column-
    concatenation of several per-trait [X y] blocks; each trait's shifted
    solves are column slices at that trait's own δ. Batched Lanczos treats
    columns independently (per-column tridiagonals), so the union basis is
    mathematically identical to R separate per-trait bases — but costs one
    set of store passes instead of R. This is the fpr4am chunked-
    permutation pattern applied to am_multi.

    Its build is the span ``union_basis``, with the counters ``cols`` (the
    union block's width), ``m`` (the basis depth) and ``cached`` (False
    when the block exceeds the cache budget and no basis is built)."""

    def __init__(self, ctx: MatfreeContext, blocks: list[np.ndarray],
                 m: int):
        self.slices: list[slice] = []
        c0 = 0
        for b in blocks:
            self.slices.append(slice(c0, c0 + b.shape[1]))
            c0 += b.shape[1]
        B = np.concatenate(blocks, axis=1)
        self.sk: Optional[ShiftedKrylov] = None
        cached = ShiftedKrylov.cache_bytes(*B.shape, m) <= ctx.cache_max_bytes
        with scanlog.Phase(None, "union_basis", cols=B.shape[1], m=m,
                           cached=cached):
            if cached:
                self.sk = ShiftedKrylov(ctx.kernel_matvec, B, m=m,
                                        reorth=True,
                                        device_lanczos=ctx.device_lanczos)

    def solver(self, t: int):
        """δ ↦ H(δ)⁻¹[X_t y_t] for trait slot ``t`` (None when the union
        block exceeded the basis cache budget — callers fall back to CG).
        The returned callable carries ``.shape`` so the caller's validity
        check is a tuple compare, not a full union-width solve; the
        eigen-coordinate apply touches ONLY this trait's column slice
        (O(width) per δ, not O(r_total))."""
        if self.sk is None:
            return None
        sl = self.slices[t]

        def f(d, _sl=sl):
            return self.sk.solve(d, sl=_sl)

        f.shape = (self.sk.n, sl.stop - sl.start)
        return f


def forward_select_matfree_multi(
    ys: np.ndarray,                # (R, n) traits
    X0: np.ndarray,
    backend,
    maxit: int = 40,
    fixit: bool = False,
    lam_ebic: float = 1.0,
    probes: int = 32,
    lanczos_m: int = 40,
    diag_probes: int = 128,
    exact_topk: int = 64,
    solve_m: int = 128,
    solve_m_refit: int = 64,
    cache_max_bytes: Optional[int] = None,
    cg_tol: float = 1e-8,
    cg_maxiter: int = 400,
    column_f64: Optional[Callable[[int], np.ndarray]] = None,
    quiet: bool = True,
    trait_names: Optional[list[str]] = None,
    s0: Optional[float] = None,
    log_jsonl: Optional[str] = None,
    Z: Optional[np.ndarray] = None,
    ckpt_dir: Optional[str] = None,
    resume: bool = False,
    logger=None,
    _single_state: bool = False,
) -> list[AMResult]:
    """The AM loop for R traits in lockstep at biobank n (matrix-free); one
    trait is the case R = 1 (:func:`forward_select_matfree`).

    Shared across traits: the kernel matvec and device packed stack, the
    SLQ logdet cache (X-independent), the Hutchinson isqrt-probe basis
    (same probe block for every trait), and — per iteration — ONE union-
    block Krylov basis serving every active trait's δ-profile, sweep
    warm start, and accept-test (see :class:`_UnionKrylov`); the sweeps
    of every active trait run as one :func:`score_sweep_matfree_multi`
    (multi-shift CG, one wide stat-rows pass, lockstep rescores).

    Each trait's selections are those of a scan of that trait alone up to
    CG tolerance: per-column Lanczos data in the union basis is identical
    to the single-trait bases, and every decision value (final LL,
    rescored t) is polished by exact CG. Reference: repeated ``AM()``
    calls (SURVEY.md §3.1 FPR4AM/AM notes); BASELINE config 5.

    With an incidence matrix Z (n_rec × n_ind), shared by every trait, the
    record-level kernel K_eff = Z·K·Zᵀ is reached matrix-free too:
    K_eff·V = Z·(Wᵀ(W·(Zᵀ·V)))/s0 — Z never touches the device kernels;
    selected columns enter X as Z·w_j.

    ``ckpt_dir`` takes every trait's state at each iteration's end
    (``multi_scan_state.json``, utils/checkpoint); ``resume`` restarts
    from it, refusing one written for other inputs. ``_single_state``
    (internal, set by :func:`forward_select_matfree`) keeps am()'s files
    there instead: ``scan_state.json``, written on each accepted marker,
    and the sweep's stage-0 cache. ``logger`` (a ScanLogger, which the
    caller closes) takes the place of one opened on ``log_jsonl``. Each
    trait's δ search, in the initial fits and in each refit, is the span
    ``trait_fit`` with the counter ``trait`` (its index in ``ys``).
    """
    from eagleeverything_tpu_torch.utils import checkpoint as ckpt
    from eagleeverything_tpu_torch.utils import distributed
    from eagleeverything_tpu_torch.utils.logging import Phase, ScanLogger

    ys = np.asarray(ys, dtype=np.float64)
    X0 = np.asarray(X0, dtype=np.float64)
    R, n = ys.shape
    p = getattr(backend, "p_global", backend.src.p)
    if column_f64 is None:
        raise ValueError("the matrix-free AM loop needs column_f64")
    if Z is not None:
        Z = np.asarray(Z, dtype=np.float64)
    own_log = logger is None
    if own_log:
        logger = ScanLogger(quiet=quiet, jsonl_path=log_jsonl,
                            is_host0=distributed.is_host0())

    # the first kernel matvec (the s0 estimate) builds the stack (and
    # pins it on the host when it streams from there)
    with Phase(logger, "context"):
        ctx = make_context(backend, n, Z=Z, probes=probes,
                           lanczos_m=lanczos_m, s0=s0)
    logger.event("stack", **backend.stack_info())
    ctx.solve_m = solve_m
    ctx.solve_m_refit = solve_m_refit
    ctx.cg_tol = cg_tol
    ctx.cg_maxiter = cg_maxiter
    if cache_max_bytes is not None:
        ctx.cache_max_bytes = int(cache_max_bytes)
    m_refit = min(ctx.solve_m, max(ctx.solve_m_refit, 16))

    def with_column(X, j: int) -> np.ndarray:
        """X with SNP j's record-level column appended."""
        return np.hstack([X, ctx.z_apply(Z, column_f64(j))[:, None]])

    def reduced_block(y, X):
        Xi, _ = reml_core.independent_cols(X)
        return np.column_stack([Xi, y])

    def trait_fp(t: int) -> list:
        return [round(float(np.sum(ys[t])), 6),
                round(float(ys[t] @ ys[t]), 6)]

    # per-trait state
    X_t = [X0 for _ in range(R)]
    selected: list[list[int]] = [[] for _ in range(R)]
    extbic_path: list[list[float]] = [[] for _ in range(R)]
    loglik_path: list[list[float]] = [[] for _ in range(R)]
    outlier_stats: list[list[np.ndarray]] = [[] for _ in range(R)]
    esc_exhausted: list[list[int]] = [[] for _ in range(R)]
    active = list(range(R))
    fits: list = [None] * R
    best = [math.inf] * R
    solver_t: list = [None] * R
    it0 = 0

    state = None
    if resume and ckpt_dir is not None:
        state = ckpt.load_trait_states(ckpt_dir, single=_single_state)
    if state is not None:
        meta = state["meta"]
        fps = [s.get("fingerprint") for s in state["states"]]
        # content fingerprint: shape equality alone accepted a STALE
        # checkpoint once (same n/p/lambda, regenerated trait+store) and
        # silently resumed the wrong scan — the traits' moments must match
        if (meta.get("n"), meta.get("p"), meta.get("lam_ebic"),
                len(state["states"])) != (n, p, lam_ebic, R) \
                or fps != [trait_fp(t) for t in range(R)]:
            raise ValueError("refusing to resume: matfree checkpoint was "
                             "written for different inputs (shape or "
                             "trait fingerprints)")
        active = []
        for t, st in enumerate(state["states"]):
            selected[t] = [int(j) for j in st["selected"]]
            for j in selected[t]:
                X_t[t] = with_column(X_t[t], j)
            extbic_path[t] = [float(v) for v in st["extbic_path"]]
            loglik_path[t] = [float(v) for v in st["loglik_path"]]
            best[t] = extbic_path[t][-1]
            # the checkpointed fit is the loop's own exact accepted fit —
            # at biobank n the re-fit it replaces is tens of minutes of
            # store passes (the first sweep's CG runs cold)
            fits[t] = reml_core.RemlResult(
                delta=float(st["delta"]),
                loglik=float(st["loglik_path"][-1]),
                sigma2_g=float(st["sigma2_g"]),
                sigma2_e=float(st["sigma2_e"]))
            if st["active"]:
                active.append(t)
        it0 = int(meta["it_next"])
        logger.event("resume", it_next=it0, active=len(active),
                     markers=sum(len(s) for s in selected))
    else:
        # initial fits: one union basis over [X0 y_t] for every trait
        with Phase(logger, "reml"):
            uk = _UnionKrylov(ctx, [reduced_block(ys[t], X0)
                                    for t in range(R)], ctx.solve_m)
            for t in range(R):
                solver_t[t] = uk.solver(t)
                with Phase(logger, "trait_fit", trait=t):
                    fits[t] = reml_maximize_matfree(ctx, ys[t], X_t[t],
                                                    solver=solver_t[t])
                best[t] = reml_core.extbic(fits[t].loglik, n, p, 0,
                                           lam_ebic)
                extbic_path[t].append(best[t])
                loglik_path[t].append(fits[t].loglik)

    def save_ckpt(it_next: int) -> None:
        if ckpt_dir is None:
            return
        # every host writes (bit-identical replicated decision state):
        # works with shared AND host-local ckpt dirs; writes are atomic
        ckpt.save_trait_states(
            ckpt_dir,
            [{"selected": selected[t], "extbic_path": extbic_path[t],
              "loglik_path": loglik_path[t], "delta": fits[t].delta,
              "sigma2_g": fits[t].sigma2_g, "sigma2_e": fits[t].sigma2_e,
              "active": t in active, "fingerprint": trait_fp(t)}
             for t in range(R)],
            meta={"n": n, "p": p, "lam_ebic": lam_ebic,
                  "it_next": it_next},
            single=_single_state)

    for it in range(it0, maxit):
        if not active:
            break
        # 1) ONE batched sweep for every active trait: one multi-shift CG
        #    for the [X_t y_t] solves, one matfree_stat_rows_multi pass
        #    over the SHARED stack, lockstep batched rescores. Selected
        #    SNPs are masked INSIDE the sweep, so each candidate is an
        #    exactly-rescored, unselected SNP; the accepted refit's Krylov
        #    basis is on exactly this [X y] block — its solve at δ̂
        #    warm-starts the sweep's exact CG
        cands: dict[int, int] = {}
        with Phase(logger, "sweep", items=p * len(active)):
            sweeps = score_sweep_matfree_multi(
                ctx, backend,
                [ys[t] for t in active], [X_t[t] for t in active],
                [fits[t] for t in active],
                diag_probes=diag_probes, exact_topk=exact_topk,
                column_f64=column_f64, Z=Z,
                excludes=[selected[t] for t in active],
                sol0s=[solver_t[t](fits[t].delta) if solver_t[t] else None
                       for t in active],
                sweep_ckpt=ckpt_dir if _single_state else None)
        for slot, t in enumerate(active):
            tv, cand, esc = sweeps[slot]
            if esc["exhausted"]:
                # candidates above the Hutchinson noise bound were never
                # exactly rescored: the argmax is unproven. Surface it
                # (log + result) instead of silently selecting on noise.
                esc_exhausted[t].append(it)
                logger.event("escalation_exhausted", it=it, trait=t,
                             rounds=esc["escalation_rounds"],
                             n_rescored=esc["n_rescored"])
            outlier_stats[t].append(tv)
            if tv[cand] > 0.0:        # else exhausted (oracle/engine stop)
                cands[t] = cand
        active = [t for t in active if t in cands]
        if not active:
            break

        # 2) one union refit basis over [X_t w_t y_t] for active traits
        Xnew = {t: with_column(X_t[t], cands[t]) for t in active}
        with Phase(logger, "refit"):
            uk = _UnionKrylov(
                ctx, [reduced_block(ys[t], Xnew[t]) for t in active],
                m_refit)
            solvers = [uk.solver(slot) for slot in range(len(active))]
            fits_new = []
            for t, sv in zip(active, solvers):
                with Phase(logger, "trait_fit", trait=t):
                    fits_new.append(reml_maximize_matfree(
                        ctx, ys[t], Xnew[t], delta_hint=fits[t].delta,
                        solver=sv))
        still = []
        for t, sv, fit_new in zip(active, solvers, fits_new):
            ebic_new = reml_core.extbic(fit_new.loglik, n, p,
                                        len(selected[t]) + 1, lam_ebic)
            accepted = bool(ebic_new < best[t]) or fixit
            tmax = float(outlier_stats[t][-1][cands[t]])
            logger.event("iteration", it=it, trait=t, candidate=cands[t],
                         t_max=tmax, extbic=float(ebic_new),
                         accepted=accepted)
            if not quiet:
                print(f"[matfree] it={it} trait={t} cand={cands[t]} "
                      f"t={tmax:.3f} extBIC {best[t]:.4f} -> "
                      f"{ebic_new:.4f} {'+' if accepted else 'stop'}")
            if accepted:
                selected[t].append(cands[t])
                X_t[t], fits[t], best[t] = Xnew[t], fit_new, ebic_new
                extbic_path[t].append(ebic_new)
                loglik_path[t].append(fit_new.loglik)
                solver_t[t] = sv     # [X_new y] block = next sweep's [X y]
                still.append(t)
        active = still
        save_ckpt(it + 1)

    logger.event("stack_passes", total=backend.stack_passes,
                 stream_passes=backend.stream_passes,
                 h2d_bytes=backend.h2d_bytes,
                 read_bytes=backend.read_bytes, read_s=backend.read_s,
                 host_bytes=backend.stack_info()["host_bytes"])
    if own_log:
        logger.close()
    out = []
    for t in range(R):
        res = AMResult(
            indices=selected[t], extbic_path=extbic_path[t],
            outlier_stats=outlier_stats[t], loglik_path=loglik_path[t],
            sigma2_g=fits[t].sigma2_g, sigma2_e=fits[t].sigma2_e,
            delta=fits[t].delta, n=n, p=p, lam_ebic=lam_ebic,
            escalation_exhausted=esc_exhausted[t] or None,
        )
        if trait_names is not None:
            res.trait_name = trait_names[t]
        out.append(res)
    return out
