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

    ``engine``: "auto" takes the shared-eigenbasis device-batched path and
    switches to "matfree" above ``config.matfree_min_n`` individuals (like
    :func:`am`); "eig"/"matfree" force a path. ``device``: where MMt, the
    kernel matvecs and the sweeps run, CUDA unless the caller passes
    ``"cpu"``.
    """
    dev = resolve_device(device)
    prep = prepare_inputs(trait, geno, pheno, fformula, Zmat)
    y, X0, Z = prep.y, prep.X0, prep.Z
    n = y.shape[0]

    src = engine_torch._make_source(prep.handle, prep.keep_individuals)
    if engine == "auto":
        engine = "matfree" if prep.handle.n > config.matfree_min_n else "eig"
    backend = engine_torch.scan_backend(src, config, dev,
                                        matfree=(engine == "matfree"))
    p = src.p
    if p < 2:
        raise ValueError(
            f"FPR calibration needs at least 2 SNPs (got p={p}): the "
            "extBIC penalty difference log C(p,1) is zero at p=1")

    if engine == "matfree":
        lam_crits, cands = _matfree_lam_crits(prep, src, backend, numreps,
                                              seed, quiet)
        out = _calibrate(lam_crits, falseposrate, numreps, quiet)
        out["candidates"] = cands
        return out
    if engine != "eig":
        raise ValueError(f"unknown fpr4am engine {engine!r}")

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
    """λ* = (1-α) quantile of the λ_crit sample; FPR(λ*) = P(λ_crit>λ*) ≈ α.
    Shared tail of both calibration engines."""
    lam_star = max(float(np.quantile(lam_crits, 1.0 - falseposrate)), 0.0)
    if not quiet:
        print(f"[fpr4am] lambda* = {lam_star:.4f} for target FPR {falseposrate}")
    return {
        "lambda": lam_star,
        "lambda_crits": lam_crits,
        "falseposrate": falseposrate,
        "numreps": numreps,
    }


def _matfree_lam_crits(prep, src, backend, numreps: int, seed: int,
                       quiet: bool) -> tuple[np.ndarray, np.ndarray]:
    """FPR calibration at biobank n: the kernel is never materialized.
    Returns (λ_crit, candidate SNP) a permutation.

    Same λ_crit algebra as the eigenbasis path, but LL₀/LL₁ come from
    matrix-free REML (Krylov solves + cached SLQ logdet, models/bigscan)
    and the per-permutation sweep is the two-stage probe/exact score
    sweep. The SLQ probe set and Hutchinson scale s0 are shared across
    all permutations, and every store-bound stage batches across a chunk
    of permutations:

    - null-model solves ride ONE shift-invariant Lanczos pass on the
      block [X | y_π1 … y_πR] (the Krylov space of H(δ)=K+δI is
      δ-independent, so one pass serves every permutation × every δ-grid
      point × the golden refinement);
    - the score sweeps ride ONE ``score_sweep_matfree_multi`` call (one
      stat-rows stack pass + multi-shift CG rescores for the whole
      chunk);
    - the candidate REML refits share ONE union Krylov basis over the
      per-rep [X w_cand y] blocks (the am_multi refit pattern).

    Chunk size is capped by the basis cache budget. A Zmat design rides
    the same batched sweep (the Zmat is shared by every permutation)."""
    import scipy.optimize as _opt

    from eagleeverything_tpu_torch.models import bigscan
    from eagleeverything_tpu_torch.models.bigscan import ShiftedKrylov

    y, X0, Z = prep.y, prep.X0, prep.Z
    n = y.shape[0]
    p = src.p
    ctx = bigscan.make_context(backend, n, Z=Z)
    column_f64 = backend.column_f64

    rng = np.random.default_rng(seed)
    log_choose_p1 = math.log(p)
    lam_crits = np.empty(numreps)
    cands_all = np.empty(numreps, dtype=np.int64)

    Xi, _ = reml_core.independent_cols(np.asarray(X0, np.float64))
    q = Xi.shape[1]
    # chunk permutations so the (m, n, q+R) basis fits the cache budget
    per_col = ShiftedKrylov.cache_bytes(n, 1, ctx.solve_m)
    chunk = max(1, min(numreps,
                       int(ctx.cache_max_bytes / max(per_col, 1)) - q))
    hint = None
    for c0 in range(0, numreps, chunk):
        R = min(chunk, numreps - c0)
        Y = np.column_stack([rng.permutation(y) for _ in range(R)])
        sk = ShiftedKrylov(ctx.kernel_matvec, np.column_stack([Xi, Y]),
                           m=ctx.solve_m, reorth=True,
                           device_lanczos=ctx.device_lanczos)

        def cols(rep: int) -> list[int]:
            return list(range(q)) + [q + rep]

        def ll_of(rep: int, d: float, _sk=sk, _Y=Y) -> float:
            return bigscan._ll_from_solution(
                _Y[:, rep], Xi, _sk.solve(d)[:, cols(rep)],
                ctx.logdet(d))[0]

        # shared coarse δ grid: one cached solve per grid point serves
        # every permutation in the chunk
        llim, ulim, ngrids = -6.0, 8.0, 24
        if hint is not None and hint > 0:
            c = math.log(hint)
            llim, ulim, ngrids = c - 2.0, c + 2.0, 8
        grid = np.exp(np.linspace(llim, ulim, ngrids + 1))
        grid_lls = np.empty((len(grid), R))
        for gi, d in enumerate(grid):
            Sol = sk.solve(float(d))
            ld = ctx.logdet(float(d))
            for rep in range(R):
                grid_lls[gi, rep] = bigscan._ll_from_solution(
                    Y[:, rep], Xi, Sol[:, cols(rep)], ld)[0]

        fits0: list = []
        for rep in range(R):
            gi = int(np.argmax(grid_lls[:, rep]))
            lo = grid[max(gi - 1, 0)]
            hi = grid[min(gi + 1, ngrids)]
            res = _opt.minimize_scalar(
                lambda ld: -ll_of(rep, math.exp(ld)),
                bounds=(math.log(lo), math.log(hi)), method="bounded",
                options={"xatol": 1e-3})
            d0 = float(math.exp(res.x))
            ll0, yPy = bigscan._ll_from_solution(
                Y[:, rep], Xi, sk.solve(d0)[:, cols(rep)], ctx.logdet(d0))
            s2g = yPy / (n - q)
            fits0.append(reml_core.RemlResult(delta=d0, loglik=ll0,
                                              sigma2_g=s2g,
                                              sigma2_e=d0 * s2g))
            hint = d0

        # the chunk's sweeps: ONE batched pass; the chunk basis
        # warm-starts every rep's [X y] solve at its δ̂
        sweeps = bigscan.score_sweep_matfree_multi(
            ctx, backend, [Y[:, rep] for rep in range(R)], [X0] * R, fits0,
            column_f64=column_f64, Z=Z,
            sol0s=[sk.solve(fits0[rep].delta)[:, cols(rep)]
                   for rep in range(R)])
        cands = [cand for _, cand, _ in sweeps]

        # the chunk's candidate refits: one union Krylov basis over the
        # per-rep [X w_cand y] blocks (am_multi's refit pattern)
        X1s = [np.hstack([X0, ctx.z_apply(Z, column_f64(c))[:, None]])
               for c in cands]
        m_refit = min(ctx.solve_m, max(ctx.solve_m_refit, 16))
        uk = bigscan._UnionKrylov(ctx, [
            np.column_stack([reml_core.independent_cols(X1s[rep])[0],
                             Y[:, rep]]) for rep in range(R)], m_refit)
        for rep in range(R):
            r_glob = c0 + rep
            fit1 = bigscan.reml_maximize_matfree(
                ctx, Y[:, rep], X1s[rep], delta_hint=fits0[rep].delta,
                solver=uk.solver(rep))
            lam_crits[r_glob] = (
                2.0 * (fit1.loglik - fits0[rep].loglik) - math.log(n)
            ) / (2.0 * log_choose_p1)
            cands_all[r_glob] = cands[rep]
            if not quiet:
                print(f"[fpr4am:matfree] rep={r_glob} cand={cands[rep]} "
                      f"lambda_crit={lam_crits[r_glob]:.4f}")
    return lam_crits, cands_all
