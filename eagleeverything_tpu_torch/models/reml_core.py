"""Host-side float64 decision-path math shared by the oracle and the TPU engine.

EMMA-style REML on the spectral decomposition (Kang et al. 2008, as vendored
by the reference into its internal ``emma.REMLE`` / ``emma.eigen.*`` /
``emma.delta.REML.*`` functions — SURVEY.md §3.2), plus the extended-BIC
model-selection criterion (Chen & Chen 2008; reference: the internal extBIC
computation inside ``AM()``'s forward loop, SURVEY.md §3.2).

Everything here is deliberately NumPy/SciPy float64 **on the host**: forward
selection is a discrete argmax and the accept/stop rule is a float
comparison, so the decision path must not depend on device dtype policy
(SURVEY.md §8, "hardest parts" (1)). The inputs are tiny — O(n) eigenvalue
vectors — so this is never a performance concern; the p-scale and n²-scale
work happens on-device elsewhere.

Model: y = Xβ + u + ε with u ~ N(0, σ²_g K), ε ~ N(0, σ²_e I), and
δ = σ²_e / σ²_g. With S = I − X(XᵀX)⁻¹Xᵀ and the nonzero spectrum
{λ_i, U_i} of S·K·S (i = 1..n−q, q = rank X), η = Uᵀy, the restricted
log-likelihood is a cheap 1-D function of δ:

  LL(δ) = ½ [ (n−q)(log((n−q)/2π) − 1 − log Σ η²_i/(λ_i+δ)) − Σ log(λ_i+δ) ]

maximized by grid search over log δ plus root-refinement of dLL/dδ.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
from scipy import optimize as _opt
from scipy.special import gammaln


@dataclasses.dataclass(frozen=True)
class RemlResult:
    """REML fit at the optimum of the 1-D δ profile."""

    delta: float        # σ²_e / σ²_g at the optimum
    loglik: float       # restricted log-likelihood at the optimum
    sigma2_g: float
    sigma2_e: float


def reml_loglik(delta: float, lam: np.ndarray, eta2: np.ndarray) -> float:
    """Restricted log-likelihood LL(δ) on the spectral parametrization."""
    nq = lam.shape[0]
    denom = lam + delta
    q1 = float(np.sum(eta2 / denom))
    return 0.5 * (
        nq * (math.log(nq / (2.0 * math.pi)) - 1.0 - math.log(q1))
        - float(np.sum(np.log(denom)))
    )


def reml_dloglik(delta: float, lam: np.ndarray, eta2: np.ndarray) -> float:
    """dLL/dδ — used for root-finding between grid points."""
    nq = lam.shape[0]
    denom = lam + delta
    s1 = float(np.sum(eta2 / denom))
    s2 = float(np.sum(eta2 / (denom * denom)))
    s3 = float(np.sum(1.0 / denom))
    return 0.5 * (nq * s2 / s1 - s3)


def reml_maximize(
    lam: np.ndarray,
    eta2: np.ndarray,
    llim: float = -10.0,
    ulim: float = 10.0,
    ngrids: int = 100,
) -> RemlResult:
    """Maximize LL(δ) by EMMA's grid-plus-root-refinement scheme.

    A log-spaced grid of δ over [e^llim, e^ulim]; every sign change of
    dLL/dδ from + to − brackets a local maximum which is refined by Brent's
    method on the derivative; the endpoints are also candidates; the global
    argmax over all candidates wins. Mirrors the reference's vendored
    ``emma.REMLE`` (SURVEY.md §3.2) with llim/ulim/ngrids defaults.
    """
    lam = np.asarray(lam, dtype=np.float64)
    eta2 = np.asarray(eta2, dtype=np.float64)
    nq = lam.shape[0]

    logdelta = np.linspace(llim, ulim, ngrids + 1)
    grid = np.exp(logdelta)
    dll = np.array([reml_dloglik(d, lam, eta2) for d in grid])

    candidates = [grid[0], grid[-1]]
    for i in range(ngrids):
        if dll[i] > 0.0 and dll[i + 1] < 0.0:
            try:
                root = _opt.brentq(
                    reml_dloglik, grid[i], grid[i + 1], args=(lam, eta2),
                    xtol=1e-12, rtol=8.9e-16, maxiter=200,
                )
                candidates.append(root)
            except ValueError:
                pass  # numerical non-bracket at the boundary; grid point stays a candidate

    lls = np.array([reml_loglik(d, lam, eta2) for d in candidates])
    best = int(np.argmax(lls))
    delta = float(candidates[best])
    loglik = float(lls[best])
    sigma2_g = float(np.sum(eta2 / (lam + delta)) / nq)
    sigma2_e = delta * sigma2_g
    return RemlResult(delta=delta, loglik=loglik, sigma2_g=sigma2_g, sigma2_e=sigma2_e)


def spectral_inputs(
    y: np.ndarray, X: np.ndarray, K: np.ndarray
) -> tuple[np.ndarray, np.ndarray, int]:
    """Compute (λ, η², q) for the REML profile from dense y, X, K.

    Follows EMMA's ``eigen.R`` trick: eigendecompose S(K+I)S and subtract 1
    from the eigenvalues, which separates the n−q informative eigenpairs
    from the q null ones by a unit gap instead of relying on tiny-magnitude
    thresholds. Host float64.
    """
    y = np.asarray(y, dtype=np.float64)
    X = np.asarray(X, dtype=np.float64)
    K = np.asarray(K, dtype=np.float64)
    n = y.shape[0]
    # one SVD provides BOTH the rank and the projector with the SAME
    # singular-value cut — mixing matrix_rank's tolerance with pinv's
    # rcond can miscount the null eigenvalues for X near the boundary
    if X.shape[1]:
        Ux, sv, _ = np.linalg.svd(X, full_matrices=False)
        tol = max(X.shape) * np.finfo(np.float64).eps * (sv[0] if sv.size else 0.0)
        q = int(np.sum(sv > tol))
        S = np.eye(n) - Ux[:, :q] @ Ux[:, :q].T
    else:
        q = 0
        S = np.eye(n)
    A = S @ (K + np.eye(n)) @ S
    A = 0.5 * (A + A.T)
    w, U = np.linalg.eigh(A)  # ascending
    lam = w[q:] - 1.0         # top n-q eigenvalues of SKS
    lam = np.maximum(lam, 0.0)
    eta = U[:, q:].T @ y
    return lam, eta * eta, q


def independent_cols(X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Reduce X to a maximal linearly-independent column subset (pivoted
    QR, original order preserved). REML depends on X only through its
    column space, so the reduction is exact; it guards every X-consuming
    path against aliased covariates or perfectly collinear selected
    markers."""
    from scipy import linalg as sla
    if X.shape[1] == 0:
        return X, np.arange(0)
    _, R, piv = sla.qr(X, mode="economic", pivoting=True)
    diag = np.abs(np.diag(R))
    if diag.size == 0 or diag[0] == 0.0:
        return X[:, :0], np.arange(0)
    tol = max(X.shape) * np.finfo(np.float64).eps * diag[0]
    rank = int(np.sum(diag > tol))
    keep = np.sort(piv[:rank])
    return X[:, keep], keep


def reml_loglik_diag(
    delta: float, d: np.ndarray, y_star: np.ndarray, X_star: np.ndarray,
    q: int, ld2: Optional[float] = None,
) -> float:
    """Restricted log-likelihood in K's eigenbasis (FaST-LMM formulation).

    With K = U·diag(d)·Uᵀ computed ONCE per scan, y* = Uᵀy, X* = UᵀX, the
    EMMA-convention restricted likelihood is, for any fixed-effects X:

      LL(δ) = ½[ nq·log(nq/2π) − nq − nq·log(yᵀP̃y)
                 − (log|H| + log|XᵀH⁻¹X| − log|XᵀX|) ],  nq = n − q,

    where every term is O(n·q²) because H is diagonal in this basis. This
    removes the per-iteration O(n³) eigendecomposition the vendored EMMA
    code pays when X grows (verified ≡ :func:`reml_loglik` to 1e-14).
    """
    n = d.shape[0]
    nq = n - q
    w = 1.0 / (d + delta)
    Xw = X_star * w[:, None]
    XtHiX = Xw.T @ X_star
    b = Xw.T @ y_star
    yPy = float(y_star @ (w * y_star) - b @ np.linalg.solve(XtHiX, b))
    if yPy <= 0:
        return -math.inf
    s1, ld1 = np.linalg.slogdet(XtHiX)
    if s1 <= 0:
        return -math.inf
    if ld2 is None:
        # log|XᵀX| is δ-invariant: maximizers precompute and pass it so
        # the ~100-point grid doesn't redo this O(n·q²) GEMM per point
        s2, ld2 = np.linalg.slogdet(X_star.T @ X_star)
        if s2 <= 0:
            return -math.inf
    logdetH = float(np.sum(np.log(d + delta)))
    return 0.5 * (
        nq * math.log(nq / (2.0 * math.pi)) - nq - nq * math.log(yPy)
        - (logdetH + ld1 - ld2)
    )


def reml_maximize_diag(
    d: np.ndarray,
    y_star: np.ndarray,
    X_star: np.ndarray,
    llim: float = -10.0,
    ulim: float = 10.0,
    ngrids: int = 100,
) -> RemlResult:
    """Maximize the diagonal-basis LL(δ): grid bracket + bounded Brent.

    Same grid limits as :func:`reml_maximize`; local maxima are bracketed
    by grid triples LL[i−1] < LL[i] > LL[i+1] and refined by bounded
    scalar maximization. Agrees with the EMMA-form optimizer to ~1e-9 in
    δ (the two formulations evaluate the identical function).
    """
    d = np.asarray(d, dtype=np.float64)
    d = np.maximum(d, 0.0)
    y_star = np.asarray(y_star, dtype=np.float64)
    X_star = np.asarray(X_star, dtype=np.float64)
    X_star, _ = independent_cols(X_star)
    q = X_star.shape[1]

    if q:
        s2, ld2 = np.linalg.slogdet(X_star.T @ X_star)
        if s2 <= 0:  # cannot happen after independent_cols; defensive
            ld2 = None
    else:
        ld2 = 0.0

    logdelta = np.linspace(llim, ulim, ngrids + 1)
    grid = np.exp(logdelta)
    lls = np.array([reml_loglik_diag(dd, d, y_star, X_star, q, ld2)
                    for dd in grid])

    candidates = [(grid[0], lls[0]), (grid[-1], lls[-1])]
    for i in range(1, ngrids):
        if lls[i] > lls[i - 1] and lls[i] > lls[i + 1]:
            res = _opt.minimize_scalar(
                lambda dd: -reml_loglik_diag(dd, d, y_star, X_star, q, ld2),
                bounds=(grid[i - 1], grid[i + 1]), method="bounded",
                options={"xatol": 1e-12},
            )
            candidates.append((float(res.x), -float(res.fun)))
    best = max(candidates, key=lambda c: c[1])
    delta, loglik = best
    # sigma2_g at the optimum: yᵀP̃y / (n−q)
    w = 1.0 / (d + delta)
    Xw = X_star * w[:, None]
    XtHiX = Xw.T @ X_star
    b = Xw.T @ y_star
    yPy = float(y_star @ (w * y_star) - b @ np.linalg.solve(XtHiX, b))
    nq = d.shape[0] - q
    sigma2_g = yPy / nq
    return RemlResult(delta=float(delta), loglik=float(loglik),
                      sigma2_g=sigma2_g, sigma2_e=float(delta) * sigma2_g)


def log_choose(p: int, k: int) -> float:
    """log C(p, k) via lgamma — the extBIC combinatorial penalty term."""
    if k < 0 or k > p:
        return -math.inf
    return float(gammaln(p + 1) - gammaln(k + 1) - gammaln(p - k + 1))


def extbic(loglik: float, n: int, p: int, k: int, lam_ebic: float = 1.0) -> float:
    """Extended BIC: −2·LL + k·log n + 2·λ·log C(p, k).

    k = number of selected markers; λ (a.k.a. gamma, default 1) is the
    sparsity weight that FPR4AM calibrates. Accept a candidate iff extBIC
    decreases (reference: the extBIC stopping rule inside AM()'s loop,
    SURVEY.md §3.2 / §4.2).
    """
    return -2.0 * loglik + k * math.log(n) + 2.0 * lam_ebic * log_choose(p, k)
