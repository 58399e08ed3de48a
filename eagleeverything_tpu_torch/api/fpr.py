"""``fpr4am()`` — calibrate the extBIC sparsity weight λ for a target
false-positive rate by trait permutation.

Reference: ``FPR4AM()`` (SURVEY.md §3.1, call stack §4.3): permute the
trait ``numreps`` times, find per permutation the smallest λ at which a
(false) marker would be selected, and return the λ achieving the desired
FPR. The permutation-invariances the survey flags (§4.3) are exploited:
MMt and the null-model eigendecomposition are computed ONCE and shared
across all permutations; each permutation then costs one cheap host REML
(on permuted η), its share of one batched device sweep, and one candidate
REML.

The accept rule at the first step (k: 0→1) is
  −2·LL₁ + log n + 2λ·log C(p,1)  <  −2·LL₀
so the critical weight is  λ_crit = (2(LL₁−LL₀) − log n) / (2·log p),
and a permutation yields a false positive iff λ < λ_crit. λ* for a target
FPR α is the (1−α) empirical quantile of the λ_crit sample.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch

from eagleeverything_tpu_torch.api.common import prepare_inputs
from eagleeverything_tpu_torch.api.read import GenoHandle, PhenoHandle
from eagleeverything_tpu_torch.models import engine_torch, reml_core
from eagleeverything_tpu_torch.utils.config import DEFAULT_CONFIG, EagleConfig
from eagleeverything_tpu_torch.utils.device import resolve_device


def fpr4am(
    trait: str,
    geno: Union[GenoHandle, np.ndarray],
    pheno: Union[PhenoHandle, dict, np.ndarray],
    fformula: Optional[str] = None,
    Zmat: Optional[np.ndarray] = None,
    falseposrate: float = 0.05,
    numreps: int = 100,
    seed: int = 0,
    quiet: bool = True,
    config: EagleConfig = DEFAULT_CONFIG,
    perm_batch: Optional[int] = None,
    engine: str = "auto",
    device: Optional[Union[str, torch.device]] = None,
) -> dict:
    """Return the calibrated λ (``setlambda``) for :func:`am`.

    Returns a dict with keys ``lambda`` (the calibrated weight),
    ``lambda_crits`` (the per-permutation critical weights),
    ``candidates`` (the SNP each permutation's sweep picked), and
    ``falseposrate``/``numreps`` bookkeeping.

    ``engine``: "auto" or "eig" takes the shared-eigenbasis device-batched
    path. The matrix-free calibration ("matfree", and "auto" above
    ``config.matfree_min_n`` individuals) is not in this package yet and
    raises NotImplementedError. ``device``: where MMt and the sweeps run,
    CUDA unless the caller passes ``"cpu"``.
    """
    dev = resolve_device(device)
    prep = prepare_inputs(trait, geno, pheno, fformula, Zmat)
    y, X0, Z = prep.y, prep.X0, prep.Z
    n = y.shape[0]

    if engine == "auto":
        engine = "matfree" if prep.handle.n > config.matfree_min_n else "eig"
    if engine == "matfree":
        raise NotImplementedError(
            "fpr4am on the matrix-free engine is not in the PyTorch port yet "
            "(ROADMAP.md queue 1 item 7); up to "
            f"matfree_min_n={config.matfree_min_n} individuals use "
            "engine='eig'")
    if engine != "eig":
        raise ValueError(f"unknown fpr4am engine {engine!r}")

    src = engine_torch._make_source(prep.handle, prep.keep_individuals)
    backend = engine_torch.TiledScan(src, config, dev)
    p = src.p
    if p < 2:
        raise ValueError(
            f"FPR calibration needs at least 2 SNPs (got p={p}): the "
            "extBIC penalty difference log C(p,1) is zero at p=1")

    K_eff = engine_torch.normalized_kernel(backend.compute_K(), Z)

    # shared across ALL permutations: one eigendecomposition of the kernel
    # (FaST-LMM basis) — every per-permutation REML fit is then O(n·q²)
    d_eig, U = engine_torch._eigh_kernel(K_eff, config, backend.device)
    Xs0 = U.T @ X0
    backend.set_eigenbasis(U if Z is None else Z.T @ U)
    q0 = Xs0.shape[1]

    rng = np.random.default_rng(seed)
    log_choose_p1 = math.log(p)
    lam_crits = np.empty(numreps)
    cands = np.empty(numreps, dtype=np.int64)

    # permutations are batched through the device sweep (SURVEY.md §4.3:
    # "batch permutations as a leading axis"); per-permutation device
    # state is O(n·q), so the batch can be large
    chunk = perm_batch or max(1, min(numreps, int(5e8 / max(n * q0, 1))))
    for c0 in range(0, numreps, chunk):
        B = min(chunk, numreps - c0)
        y_perms = np.stack([rng.permutation(y) for _ in range(B)])
        fits0 = []
        ystars = np.empty((B, n))
        s_all = np.empty((B, n))
        Q_all = np.empty((B, n, q0))
        z3_all = np.empty((B, n))
        for b in range(B):
            ystars[b] = U.T @ y_perms[b]
            fit0 = reml_core.reml_maximize_diag(d_eig, ystars[b], Xs0)
            fits0.append(fit0)
            s_all[b], Q_all[b], z3_all[b] = engine_torch._eig_iteration_state(
                d_eig, ystars[b], Xs0, fit0.delta, q0)
        t_all = backend.sweep_eig_batched(
            s_all, Q_all, z3_all, np.array([f.sigma2_g for f in fits0])
        )
        for b in range(B):
            r = c0 + b
            fit0 = fits0[b]
            cand = int(np.argmax(t_all[b]))
            cands[r] = cand
            w_col = backend.column_f64(cand)
            x_col = Z @ w_col if Z is not None else w_col
            Xs1 = np.hstack([Xs0, (U.T @ x_col)[:, None]])
            fit1 = reml_core.reml_maximize_diag(d_eig, ystars[b], Xs1)
            lam_crits[r] = (
                2.0 * (fit1.loglik - fit0.loglik) - math.log(n)
            ) / (2.0 * log_choose_p1)
            if not quiet:
                print(f"[fpr4am] rep={r} cand={cand} "
                      f"lambda_crit={lam_crits[r]:.4f}")

    out = _calibrate(lam_crits, falseposrate, numreps, quiet)
    out["candidates"] = cands
    return out


def _calibrate(lam_crits: np.ndarray, falseposrate: float, numreps: int,
               quiet: bool) -> dict:
    """λ* = (1-α) quantile of the λ_crit sample; FPR(λ*) = P(λ_crit>λ*) ≈ α."""
    lam_star = max(float(np.quantile(lam_crits, 1.0 - falseposrate)), 0.0)
    if not quiet:
        print(f"[fpr4am] lambda* = {lam_star:.4f} for target FPR {falseposrate}")
    return {
        "lambda": lam_star,
        "lambda_crits": lam_crits,
        "falseposrate": falseposrate,
        "numreps": numreps,
    }
