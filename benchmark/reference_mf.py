"""The plain reference of the matrix-free engine's decision path: Eagle's
forward selection with REML over Krylov bases, written out again in
float64 on a dense kernel of the benchmark's own genotype draws.

The matrix-free method estimates what the exact method computes, and its
estimates are part of the method: the kernel's scale s0 is a Hutchinson
trace over 16 fixed Rademacher probes, log|K̃ + δI| a stochastic Lanczos
quadrature over 32 fixed probes (40 steps), and δ is searched on a grid
and refined over a shifted Krylov basis of [X y] (128 steps, 64 for a
refit hinted at the previous δ̂), with an exact solve at δ̂. The probes are
fixed by the method's own seeds (0 and 4242), so the reference makes the
same estimates from the same probes. What it does not share with the
program is the arithmetic (float64 dense products and recurrences on the
device, where the program runs the packed bf16 kernels and f32 device
recurrences) and the genotypes (its own draws, never the program's store).

Frozen from ``eagleeverything_tpu_torch/models/bigscan.py``: the s0
estimate of ``make_context`` (:1150), ``_lanczos`` (:114),
``ShiftedKrylov`` (:190: its solve and logdet), ``_ll_from_solution``
(:490), ``reml_maximize_matfree`` (:524) and the exact statistic of
``score_sweep_matfree``'s ``rescore`` (:778).

The control computes every product with the kernel in TF32 (K̃ and the
vectors rounded to TF32's 10-bit mantissa, the sums in IEEE fp32), the
step below the configuration's fp32; the recurrences stay float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy import optimize as _opt

import cohort as cohort_mod
import reference

S0_SEED, S0_PROBES = 0, 16          # make_context's scale estimate
LD_SEED, LD_PROBES, LD_M = 4242, 32, 40   # its logdet probes and depth
SOLVE_M, SOLVE_M_REFIT = 128, 64    # the δ search's basis depths
CG_TOL, CG_MAXITER = 1e-10, 2000


def rademacher(seed: int, n: int, r: int) -> np.ndarray:
    return np.random.default_rng(seed).choice((-1.0, 1.0), size=(n, r))


def dense_kernel(cfg: dict, seed: int, device) -> torch.Tensor:
    """K = W·Wᵀ (n, n) f64 of the recoded genotypes W = dose − 1 (p, n).
    On the card the sums run as int8 products into int32: sums of −1, 0
    and 1, exact (|K_ij| ≤ p < 2³¹). Its diagonal is held to the count of
    nonzero genotypes of each individual, so a product that is not exact
    raises."""
    n, p = cfg["n_individuals"], cfg["n_snps"]
    if torch.device(device).type != "cuda":
        K = torch.zeros((n, n), dtype=torch.float64, device=device)
        for _, G in cohort_mod.blocks(cfg, seed, device):
            W = G.to(torch.float64) - 1.0
            K.addmm_(W.T, W)
        return K
    Wt = torch.empty((n, p), dtype=torch.int8, device=device)
    nonzero = torch.zeros(n, dtype=torch.int64, device=device)
    for j0, G in cohort_mod.blocks(cfg, seed, device):
        W = G - 1
        Wt[:, j0:j0 + W.shape[0]] = W.T
        nonzero += (W != 0).sum(0)
    K = torch.empty((n, n), dtype=torch.float64, device=device)
    rows = 4096
    for i0 in range(0, n, rows):
        K[i0:i0 + rows] = torch._int_mm(Wt[i0:i0 + rows], Wt.T)
    del Wt
    if not torch.equal(K.diagonal().to(torch.int64), nonzero):
        raise RuntimeError("the int8 kernel product is not exact")
    return K


def _tf32_copy(K: torch.Tensor) -> torch.Tensor:
    """K rounded to TF32, as an f32 tensor, a block of rows at a time."""
    out = torch.empty(K.shape, dtype=torch.float32, device=K.device)
    for i0 in range(0, K.shape[0], 4096):
        out[i0:i0 + 4096] = reference.tf32(K[i0:i0 + 4096])
    return out


class Kernel:
    """V ↦ K̃·V with K̃ = K / s0 (K is scaled in place); the control's
    products read K and V in TF32 and sum in fp32."""

    def __init__(self, K: torch.Tensor, control: bool):
        n = K.shape[0]
        Zp = torch.as_tensor(rademacher(S0_SEED, n, S0_PROBES),
                             device=K.device)
        self.Kc = _tf32_copy(K) if control else None
        self.K = K
        self.s0 = float(torch.sum(Zp * self(Zp), dim=0).mean() / n)
        K.div_(self.s0)
        if control:
            del self.Kc
            self.Kc = _tf32_copy(K)

    def __call__(self, V: torch.Tensor) -> torch.Tensor:
        if self.Kc is None:
            return self.K @ V
        return (self.Kc @ reference.tf32(V.float())).double()


def lanczos(op, Z: torch.Tensor, m: int, reorth: bool):
    """Batched Lanczos of ``bigscan._lanczos``, on the device in f64:
    (alphas (m, r), betas (m − 1, r), z_norm (r,)) on the host and the
    basis (m, n, r) (None without ``reorth``)."""
    n, r = Z.shape
    dev = Z.device
    z_norm = torch.linalg.vector_norm(Z, dim=0)
    V = Z / z_norm.clamp(min=1e-300)[None, :]
    V_prev = torch.zeros_like(Z)
    beta_prev = torch.zeros(r, dtype=torch.float64, device=dev)
    alphas = torch.zeros((m, r), dtype=torch.float64, device=dev)
    betas = torch.zeros((max(m - 1, 0), r), dtype=torch.float64, device=dev)
    basis = None
    if reorth:
        basis = torch.empty((m, n, r), dtype=torch.float64, device=dev)
        basis[0] = V
    for k in range(m):
        Hv = op(V)
        alpha = torch.sum(V * Hv, dim=0)
        alphas[k] = alpha
        Wv = Hv - V * alpha[None, :] - V_prev * beta_prev[None, :]
        if reorth:
            Vb = basis[: k + 1]
            coef = torch.einsum("knr,nr->kr", Vb, Wv)
            Wv = Wv - torch.einsum("knr,kr->nr", Vb, coef)
        beta = torch.linalg.vector_norm(Wv, dim=0)
        ok = beta > 1e-12 * (alpha.abs() + beta_prev + 1e-6)
        beta = torch.where(ok, beta, torch.zeros_like(beta))
        if k < m - 1:
            betas[k] = beta
            V_prev = V
            V = torch.where(ok[None, :], Wv / beta.clamp(min=1e-300)[None, :],
                            torch.zeros_like(Wv))
            beta_prev = beta
            if reorth:
                basis[k + 1] = V
    return (alphas.cpu().numpy(), betas.cpu().numpy(),
            z_norm.cpu().numpy(), basis)


class Krylov:
    """``ShiftedKrylov``: one Lanczos of the unshifted K̃ on a block Z
    serves every shift δ: solve(δ) ≈ (K̃ + δI)⁻¹·Z and, for Rademacher
    probes, logdet(δ) ≈ log|K̃ + δI|. Ritz values are clipped at 0 (K̃ is
    PSD)."""

    def __init__(self, op, Z: torch.Tensor, m: int, reorth: bool):
        n, r = Z.shape
        m = min(m, n)
        alphas, betas, self.z_norm, self.V = lanczos(op, Z, m, reorth)
        self.n = n
        self.w = np.empty((m, r))
        self.Q = np.empty((r, m, m))
        for j in range(r):
            T = np.diag(alphas[:, j])
            if m > 1:
                T += np.diag(betas[:, j], 1) + np.diag(betas[:, j], -1)
            self.w[:, j], self.Q[j] = np.linalg.eigh(T)
        self.w = np.maximum(self.w, 0.0)
        self.Q0 = self.Q[:, 0, :].T

    def solve(self, delta: float) -> np.ndarray:
        f = 1.0 / np.maximum(self.w + delta, 1e-300)
        c = np.einsum("jkl,lj->kj", self.Q, f * self.Q0)
        c *= self.z_norm[None, :]
        cd = torch.as_tensor(c, device=self.V.device)
        return torch.einsum("mnr,mr->nr", self.V, cd).cpu().numpy()

    def logdet(self, delta: float) -> float:
        nodes = np.maximum(self.w + delta, 1e-300)
        return float(self.n * np.mean(np.sum(self.Q0 ** 2 * np.log(nodes),
                                             axis=0)))


def cg(op, B: np.ndarray, delta: float, x0=None, tol: float = CG_TOL,
       maxiter: int = CG_MAXITER) -> np.ndarray:
    """(K̃ + δI)⁻¹·B by blocked CG on the device (``bigscan.blocked_cg``
    with its stall guard: the control's TF32 products floor the residual),
    to a relative residual of ``tol`` a column."""
    dev = op.K.device
    Bd = torch.as_tensor(B, dtype=torch.float64, device=dev)
    if x0 is not None:
        X = torch.as_tensor(x0, dtype=torch.float64, device=dev).clone()
        R = Bd - (op(X) + delta * X)
    else:
        X = torch.zeros_like(Bd)
        R = Bd.clone()
    P = R.clone()
    rs = torch.sum(R * R, dim=0)
    bn2 = torch.sum(Bd * Bd, dim=0).clamp(min=1e-300)
    floor = rs.clone()
    since = 0
    for _ in range(maxiter):
        active = rs > tol * tol * bn2
        if not bool(active.any()):
            break
        HP = op(P) + delta * P
        pHp = torch.sum(P * HP, dim=0)
        alpha = torch.where(active & (pHp > 0), rs / pHp.clamp(min=1e-300),
                            torch.zeros_like(rs))
        X += P * alpha[None, :]
        R -= HP * alpha[None, :]
        rs_new = torch.sum(R * R, dim=0)
        beta = torch.where(active, rs_new / rs.clamp(min=1e-300),
                           torch.zeros_like(rs))
        P = R + P * beta[None, :]
        rs = rs_new
        if bool(torch.all(rs >= 0.25 * floor)):
            since += 1
            if since >= 10:
                break
        else:
            since = 0
        floor = torch.minimum(floor, rs)
    return X.cpu().numpy()


def ll_from_solution(y, X, Sol, logdetH):
    """(LL, yᵀP̃y) from Sol ≈ H⁻¹·[X y] (EMMA's constant convention)."""
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
    return 0.5 * (nq * math.log(nq / (2.0 * math.pi)) - nq
                  - nq * math.log(yPy) - (logdetH + ld1 - ld2)), yPy


def reml_fit(op, ld: Krylov, y, X, hint=None, w=None) -> dict:
    """``reml_maximize_matfree``: the δ̂ of the grid and the bounded search
    over the Krylov basis of [X y], then LL and σ²_g from an exact solve at
    δ̂. With ``w``, the statistic t of column w at this fit
    (``rescore``'s exact t), from the same solve."""
    llim, ulim, ngrids, m = -6.0, 8.0, 24, SOLVE_M
    if hint is not None and hint > 0:
        c = math.log(hint)
        llim, ulim = max(llim, c - 2.0), min(ulim, c + 2.0)
        if llim >= ulim:
            llim, ulim = c - 2.0, c + 2.0
        ngrids = min(ngrids, 8)
        m = min(SOLVE_M, max(SOLVE_M_REFIT, 16))
    Xi = reference.independent_cols(np.asarray(X, np.float64))
    q = Xi.shape[1]
    B = np.column_stack([Xi, y])
    sk = Krylov(op, torch.as_tensor(B, device=op.K.device), m, reorth=True)

    def ll_of(d):
        return ll_from_solution(y, Xi, sk.solve(d), ld.logdet(d))[0]

    grid = np.exp(np.linspace(llim, ulim, ngrids + 1))
    lls = np.array([ll_of(d) for d in grid])
    lls = np.where(np.isfinite(lls), lls, -np.inf)
    i = int(np.argmax(lls))
    lo, hi = grid[max(i - 1, 0)], grid[min(i + 1, ngrids)]
    res = _opt.minimize_scalar(lambda t: -ll_of(math.exp(t)),
                               bounds=(math.log(lo), math.log(hi)),
                               method="bounded", options={"xatol": 1e-3})
    delta = float(math.exp(res.x))
    x0 = sk.solve(delta)
    if w is not None:
        B = np.column_stack([B, w])
        x0 = np.column_stack([x0, np.zeros_like(w)])
    Sol = cg(op, B, delta, x0=x0)
    ll, yPy = ll_from_solution(y, Xi, Sol[:, :q + 1], ld.logdet(delta))
    fit = {"delta": delta, "loglik": ll, "sigma2_g": yPy / (y.shape[0] - q)}
    if w is not None:
        HiX, Hiy, Hiw = Sol[:, :q], Sol[:, q], Sol[:, q + 1]
        XtHiX = Xi.T @ HiX
        Py = Hiy - HiX @ np.linalg.solve(XtHiX, Xi.T @ Hiy)
        u = HiX.T @ w
        proj = float(u @ np.linalg.inv(XtHiX) @ u)
        vara = fit["sigma2_g"] * max(float(w @ Hiw) - proj, 1e-12)
        ahat = float(w @ Py)
        fit["t"] = ahat * ahat / vara if vara > 1e-12 else 0.0
    return fit


def column(cfg: dict, seed: int, j: int, device) -> np.ndarray:
    """The recoded genotypes (dose − 1) of SNP j, host f64."""
    j0 = j // cohort_mod.BLOCK * cohort_mod.BLOCK
    G = cohort_mod.genotype_block(cfg, seed, j0, device)
    return G[j - j0].double().cpu().numpy() - 1.0


def matfree_scan(cfg: dict, seed: int, device, y: np.ndarray,
                 selected: list, lam: float, control: bool = False) -> dict:
    """The method's fits along the program's selections: {extbic_path
    (the base model's and each accepted model's), t (the statistic of each
    selected SNP at the fit it was selected from), delta}."""
    reference._ieee()
    n, p = cfg["n_individuals"], cfg["n_snps"]
    op = Kernel(dense_kernel(cfg, seed, device), control)
    ld = Krylov(op, torch.as_tensor(rademacher(LD_SEED, n, LD_PROBES),
                                    device=device), LD_M, reorth=False)
    cols = [column(cfg, seed, int(j), device) for j in selected]
    X = np.ones((n, 1))
    fit = reml_fit(op, ld, y, X, w=cols[0] if cols else None)
    path = [reference.extbic(fit["loglik"], n, p, 0, lam)]
    ts, deltas = [], [fit["delta"]]
    for k, w in enumerate(cols):
        ts.append(fit["t"])
        X = np.column_stack([X, w])
        fit = reml_fit(op, ld, y, X, hint=fit["delta"],
                       w=cols[k + 1] if k + 1 < len(cols) else None)
        path.append(reference.extbic(fit["loglik"], n, p, k + 1, lam))
        deltas.append(fit["delta"])
    del op
    return {"extbic_path": path, "t": ts, "delta": deltas}
