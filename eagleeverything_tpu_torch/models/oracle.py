"""Dense NumPy oracle — the in-memory float64 reference implementation.

This is Phase 0 of the build plan (SURVEY.md §8): a complete, dense,
single-machine implementation of the reference's multiple-locus
forward-selection LMM scan (reference call stack: ``AM()`` in SURVEY.md
§4.2). Every production path — the jitted single-chip engine, the
out-of-core streamed path, and the SNP-sharded multi-host path — is tested
against this module for identical marker selection and matching extBIC
trajectories.

Algorithm (reference: SURVEY.md §1, §3.2, §4.2):
  1. Recode genotypes {0,1,2} (mean-impute missing), shift to {−1,0,1}.
  2. K = W·Wᵀ, normalized by mean(diag) so δ lives in EMMA's grid range.
     (Marker selection is invariant to the normalization constant: σ²_g
     absorbs it and it cancels in the score statistic.)
  3. REML variance components by the EMMA spectral trick (reml_core).
  4. Per-SNP outlier statistic t_j = â_j² / var(â_j) with
     â = Wᵀ·P̃·y and var(â_j) = σ²_g·(Wᵀ·P̃·W)_jj, where
     P̃ = H⁻¹ − H⁻¹X(XᵀH⁻¹X)⁻¹XᵀH⁻¹ and H = K + δI (the WGAIM-style
     outlier statistic, Verbyla et al.; reference:
     ``calculate_a_and_vara_rcpp`` + ``find_qtl``, SURVEY.md §3.3).
  5. argmax_j t_j → candidate; accept iff extBIC decreases (or ``fixit``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
from scipy import stats as _stats

from eagleeverything_tpu_torch.models import reml_core

MISSING = -9  # missing-genotype sentinel in raw {0,1,2} coded matrices


@dataclasses.dataclass
class AMResult:
    """Result of a forward-selection scan (reference: the ``AMclass`` list
    returned by ``AM()``, SURVEY.md §3.1)."""

    indices: list[int]             # selected SNP indices, in selection order
    extbic_path: list[float]       # extBIC after iteration 0 (null), 1, ...
    outlier_stats: list[np.ndarray]  # per-iteration t_j vectors (p,)
    loglik_path: list[float]
    sigma2_g: float                # at the final accepted model
    sigma2_e: float
    delta: float
    n: int
    p: int
    lam_ebic: float
    trait_name: str = "trait"
    marker_names: Optional[Sequence[str]] = None
    chr: Optional[Sequence[str]] = None
    pos: Optional[Sequence[float]] = None
    # NA bookkeeping (reference: indxNA) — indices of dropped records
    dropped_records: Optional[np.ndarray] = None
    # matfree engine only: iterations where the escalation guard ran out
    # of rounds with candidates still above the Hutchinson noise bound —
    # those iterations' argmax decisions are unproven (None = all proven)
    escalation_exhausted: Optional[list[int]] = None


def recode_and_impute(geno_raw: np.ndarray) -> np.ndarray:
    """{0,1,2,MISSING} int matrix (n×p) → float64 W ∈ [−1,1] (n×p).

    Missing entries are mean-imputed per SNP in {0..2} space (SURVEY.md §8
    Phase 5: reference likely mean-imputes at recode), then 1 is subtracted
    so genotypes are centered at the heterozygote (reference:
    ``calculateMMt_rcpp``'s on-the-fly recode/scale, SURVEY.md §3.3).
    """
    G = np.asarray(geno_raw)
    W = G.astype(np.float64)
    miss = G == MISSING
    if miss.any():
        W[miss] = np.nan
        col_mean = np.nanmean(W, axis=0)
        col_mean = np.where(np.isnan(col_mean), 1.0, col_mean)  # all-missing SNP → het
        idx = np.where(miss)
        W[idx] = col_mean[idx[1]]
    return W - 1.0


def grm(W: np.ndarray) -> tuple[np.ndarray, float]:
    """Genomic relationship matrix K = W·Wᵀ / mean(diag(W·Wᵀ)).

    Returns (K, s0) where s0 is the normalization constant. (Reference:
    ``calculateMMt_rcpp`` forms the raw MMt; the rebuild normalizes so the
    REML δ grid covers realistic heritabilities — selection is invariant,
    see module docstring.)
    """
    K = W @ W.T
    s0 = float(np.mean(np.diag(K)))
    if s0 <= 0.0:
        s0 = 1.0
    return K / s0, s0


def fit_reml(y: np.ndarray, X: np.ndarray, K: np.ndarray) -> reml_core.RemlResult:
    """One REML fit: spectral inputs (dense, f64) + 1-D δ maximization."""
    lam, eta2, _ = reml_core.spectral_inputs(y, X, K)
    return reml_core.reml_maximize(lam, eta2)


def projector(X: np.ndarray, K: np.ndarray, delta: float) -> np.ndarray:
    """P̃ = H⁻¹ − H⁻¹X(XᵀH⁻¹X)⁻¹XᵀH⁻¹ with H = K + δI (dense, f64).

    X is reduced to independent columns first (same guard as every
    engine-side X consumer) — a collinear design must degrade identically
    here and there, or the oracle stops being the parity reference."""
    X, _ = reml_core.independent_cols(X)
    n = K.shape[0]
    H = K + delta * np.eye(n)
    Hinv = np.linalg.inv(H)
    HinvX = Hinv @ X
    XtHinvX = X.T @ HinvX
    return Hinv - HinvX @ np.linalg.solve(XtHinvX, HinvX.T)


def score_sweep(
    W: np.ndarray, P: np.ndarray, y: np.ndarray, sigma2_g: float
) -> np.ndarray:
    """Per-SNP outlier statistic t_j = â_j²/var(â_j) for all p SNPs.

    Dense equivalent of the reference's blocked ``calculate_a_and_vara_rcpp``
    sweep (SURVEY.md §3.3): â = Wᵀ(P̃y), var(â_j) = σ²_g·(WᵀP̃W)_jj,
    computed as colsum(W ∘ P̃W) without materializing p×p.
    """
    Py = P @ y
    ahat = W.T @ Py
    PW = P @ W
    vara = sigma2_g * np.einsum("ij,ij->j", W, PW)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(vara > 1e-12, (ahat * ahat) / vara, 0.0)
    return t


def forward_select(
    y: np.ndarray,
    X0: np.ndarray,
    geno_raw: np.ndarray,
    maxit: int = 40,
    fixit: bool = False,
    lam_ebic: float = 1.0,
    Z: Optional[np.ndarray] = None,
    quiet: bool = True,
) -> AMResult:
    """The complete dense AM scan (reference: ``AM()``, SURVEY.md §4.2).

    Args:
      y: trait vector (n_records,) — NA rows already dropped.
      X0: base fixed-effects design (n_records × q0) from the formula,
        including the intercept.
      geno_raw: genotypes (n_individuals × p) coded {0,1,2,MISSING}.
      maxit: maximum number of forward-selection steps.
      fixit: force exactly ``maxit`` selections, ignoring extBIC.
      lam_ebic: extBIC sparsity weight λ (a.k.a. gamma; default 1).
      Z: optional incidence matrix (n_records × n_individuals) linking
        records to genotyped individuals (reference: ``ReadZmat()``). When
        given, the polygenic covariance is Z·K·Zᵀ and marker columns enter
        the design as Z·W[:,j].
    """
    y = np.asarray(y, dtype=np.float64)
    X0 = np.asarray(X0, dtype=np.float64)
    W = recode_and_impute(geno_raw)
    n_ind, p = W.shape
    K, _ = grm(W)
    if Z is not None:
        Z = np.asarray(Z, dtype=np.float64)
        K_eff = Z @ K @ Z.T
        W_eff = Z @ W
    else:
        K_eff, W_eff = K, W
    n = y.shape[0]

    selected: list[int] = []
    extbic_path: list[float] = []
    loglik_path: list[float] = []
    outlier_stats: list[np.ndarray] = []

    X = X0
    fit = fit_reml(y, X, K_eff)
    best = reml_core.extbic(fit.loglik, n, p, 0, lam_ebic)
    extbic_path.append(best)
    loglik_path.append(fit.loglik)
    if not quiet:
        print(f"[oracle] null model: extBIC={best:.4f} delta={fit.delta:.4g}")

    for it in range(maxit):
        P = projector(X, K_eff, fit.delta)
        t = score_sweep(W_eff, P, y, fit.sigma2_g)
        t[selected] = 0.0
        outlier_stats.append(t)
        cand = int(np.argmax(t))  # ties → lowest index (np.argmax contract)
        if t[cand] <= 0.0:
            # exhausted: every remaining SNP is already selected or has
            # zero score variance — nothing scoreable left (also guards
            # fixit/maxit > p from re-selecting duplicates)
            break
        X_new = np.hstack([X, W_eff[:, cand : cand + 1]])
        fit_new = fit_reml(y, X_new, K_eff)
        ebic_new = reml_core.extbic(fit_new.loglik, n, p, len(selected) + 1, lam_ebic)
        if not quiet:
            print(
                f"[oracle] it={it} cand={cand} t_max={t[cand]:.4f} "
                f"extBIC {best:.4f} -> {ebic_new:.4f}"
            )
        if ebic_new < best or fixit:
            selected.append(cand)
            X, fit, best = X_new, fit_new, ebic_new
            extbic_path.append(ebic_new)
            loglik_path.append(fit_new.loglik)
        else:
            break

    return AMResult(
        indices=selected,
        extbic_path=extbic_path,
        outlier_stats=outlier_stats,
        loglik_path=loglik_path,
        sigma2_g=fit.sigma2_g,
        sigma2_e=fit.sigma2_e,
        delta=fit.delta,
        n=n,
        p=p,
        lam_ebic=lam_ebic,
    )


@dataclasses.dataclass
class WaldSummary:
    """Per-marker Wald inference (reference: ``SummaryAM()``, SURVEY.md §4.4)."""

    indices: list[int]
    beta: np.ndarray          # GLS effect estimates for the selected markers
    se: np.ndarray
    wald: np.ndarray          # β̂²/var(β̂) ~ χ²₁
    pvalue: np.ndarray
    var_explained: np.ndarray  # per-marker share of phenotypic variance
    sigma2_g: float
    sigma2_e: float


def gls_wald_stats(
    y: np.ndarray,
    X0: np.ndarray,
    Wcols: np.ndarray,
    K: np.ndarray,
    indices: Sequence[int],
    fit: "reml_core.RemlResult",
) -> WaldSummary:
    """GLS estimates + Wald tests for the selected-marker fixed effects.

    Shared by the dense oracle and the engine-backed ``summary_am``:
    β̂ = (XᵀV⁻¹X)⁻¹XᵀV⁻¹y with V = σ²_g·K + σ²_e·I; per marker the Wald
    statistic β̂²/var(β̂) ~ χ²₁ and a variance-explained share
    β̂²·var(w_j)/var(y).
    """
    idx = list(indices)
    X = np.hstack([X0, Wcols])
    n = y.shape[0]
    V = fit.sigma2_g * K + fit.sigma2_e * np.eye(n)
    Vinv = np.linalg.inv(V)
    XtVinvX = X.T @ Vinv @ X
    cov = np.linalg.inv(XtVinvX)
    beta = cov @ (X.T @ (Vinv @ y))
    q0 = X0.shape[1]
    b = beta[q0:]
    se = np.sqrt(np.diag(cov)[q0:])
    wald = (b / se) ** 2
    pval = _stats.chi2.sf(wald, df=1)
    vary = float(np.var(y))
    varexp = np.array(
        [float(b[i] ** 2 * np.var(Wcols[:, i])) / vary if vary > 0 else 0.0
         for i in range(len(idx))]
    )
    return WaldSummary(
        indices=idx, beta=b, se=se, wald=wald, pvalue=pval,
        var_explained=varexp, sigma2_g=fit.sigma2_g, sigma2_e=fit.sigma2_e,
    )


def wald_summary(
    y: np.ndarray,
    X0: np.ndarray,
    geno_raw: np.ndarray,
    indices: Sequence[int],
    Z: Optional[np.ndarray] = None,
) -> WaldSummary:
    """Refit the final model and Wald-test each selected marker's effect."""
    y = np.asarray(y, dtype=np.float64)
    X0 = np.asarray(X0, dtype=np.float64)
    W = recode_and_impute(geno_raw)
    K, _ = grm(W)
    if Z is not None:
        Z = np.asarray(Z, dtype=np.float64)
        K = Z @ K @ Z.T
        W = Z @ W
    idx = list(indices)
    Wcols = W[:, idx] if idx else np.zeros((y.shape[0], 0))
    fit = fit_reml(y, np.hstack([X0, Wcols]), K)
    return gls_wald_stats(y, X0, Wcols, K, idx, fit)
