#!/usr/bin/env python
"""The REML profile of one fixed model on BASELINE config 3's cohort, on
the PyTorch/CUDA port (eagleeverything_tpu_torch): the port of
scripts/debug_resume_fit.py, which rebuilt the resumed fit of the model
[3175, 3863, 922, 2366] at 50 000 x 1 000 000 to find where its NaN was
born.

For the model 1 + ``--selected`` (and, with ``--add J``, the model plus
SNP J) it prints the JAX script's lines: the design's rank, the health of
the shift-invariant Krylov basis on [X y] (its Ritz values' range, the
columns' norms) and, for each δ of the grid exp(linspace(-6, 8, 25)), the
SLQ log-determinant, the restricted log-likelihood, yᵀP̃y and whether the
solve is finite; each δ also as one JSON line. That is the matrix-free
engine, bigscan.make_context / ShiftedKrylov / MatfreeContext.logdet /
_ll_from_solution, at each ``--protocol``:

  default  EagleConfig's matfree fields (32 probes, Lanczos depth 40,
           solve depth 128, refit depth 64);
  tight    128 probes, depth 80, solve depths 256.

Each model's maximiser δ̂ is bigscan.reml_maximize_matfree's over that
basis (its final log-likelihood from an exact CG solve); the model plus J
is also refit as the scan's accept test does it, δ-hinted at the model's
δ̂. extBIC is reml_core.extbic at the cohort's p.

``--exact`` profiles the same models exactly, from TiledScan.compute_K
(computed once), by each of ``--routes`` (default ``exact_route``'s):

  eigh      the exact engine's own REML: engine_torch.eigh_basis of the
            normalised kernel (host f64 up to host_eigh_max_n; above it
            f32 on the card, torch.linalg.eigh up to
            engine_torch.DEVICE_EIGH_MAX_N and engine_torch.eigh_large
            above it), Uᵀ[X y] rotated in f64 column blocks, and
            reml_core's reml_loglik_diag / reml_maximize_diag, as
            engine_torch.forward_select fits; it reports ‖KU − UD‖/‖K‖
            and ‖UᵀU − I‖/√n. The route at every n.
  cholesky  the f64 cross-check, numerics of this script's own, not the
            package's: K + δI is factored in f64 on the card by a blocked
            Cholesky (CholeskyKernel) at each δ, and
            bigscan._ll_from_solution and reml_maximize_matfree's δ search
            run on its exact log|H| and solves. The tests and smoke phase
            24 hold it to the eigh route.

The exact profile is on the matrix-free context's δ scale (the kernel
over the same Hutchinson s0; the restricted likelihood does not depend on
the kernel's scale once δ moves with it), so the two profiles compare
point by point; the eigh route's δ̂ is also given on its own scale. Both
δ searches stop at the grid's upper end e⁸, so the exact engine also
evaluates each model on a tail grid e⁹ … e¹⁶ and at the limit δ → ∞ (H
a multiple of I, which is the OLS REML of [X y]), and reports the extBIC
change for J at each model's supremum over all of them. Beside each
matrix-free δ̂ it gives the SLQ log-determinant and the exact one, the
exact log-likelihood there, and how far the matrix-free extBIC lies
above the exact engine's.

Usage (from the root of a checkout, CUDA unless ``--device cpu``; the
cohort from scripts/cohort_run_torch.py --gen):

  python scripts/debug_resume_fit_torch.py [--dir DIR]
      [--selected 3175,3863,922,2366] [--add J] [--exact]
      [--protocol default,tight] [--routes eigh,cholesky] [--out FILE]

The result JSON goes to ``--out`` (default ``<dir>/f4_debug.json``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SELECTED = [3175, 3863, 922, 2366]       # the JAX script's model
GRID = np.exp(np.linspace(-6.0, 8.0, 25))
TAIL = np.exp(np.arange(9.0, 17.0))       # past both δ searches' bound
PROTOCOLS = {
    "default": None,                      # EagleConfig's matfree fields
    "tight": {"probes": 128, "lanczos_m": 80, "solve_m": 256,
              "solve_m_refit": 256},
}


def _cohort_run():
    """scripts/cohort_run_torch.py, imported by path (the cohort's
    config, store and trait)."""
    spec = importlib.util.spec_from_file_location(
        "cohort_run_torch", os.path.join(REPO, "scripts",
                                         "cohort_run_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def protocol(name: str) -> dict:
    """The Krylov protocol ``name``: probes, Lanczos depth and the two
    solve depths."""
    if PROTOCOLS[name] is not None:
        return dict(PROTOCOLS[name])
    from eagleeverything_tpu_torch.utils.config import EagleConfig
    c = EagleConfig()
    return {"probes": c.matfree_probes, "lanczos_m": c.matfree_lanczos_m,
            "solve_m": c.matfree_solve_m,
            "solve_m_refit": c.matfree_solve_m_refit}


def hutchinson_s0(backend, n: int) -> float:
    """The kernel's scale as bigscan.make_context estimates it (16
    Rademacher probes from seed 0), so that every context of a run and
    the exact engine share one δ scale."""
    Zp = np.random.default_rng(0).choice((-1.0, 1.0), size=(n, 16))
    KZ = backend.kernel_matvec(Zp)
    s0 = float(np.mean(np.sum(Zp * KZ, axis=0)) / n)
    return s0 if s0 > 0 else 1.0


def models(backend, n: int, selected: list[int],
           add: int | None) -> dict[str, np.ndarray]:
    """{"model": [1, W_selected], "model+J": [1, W_selected, W_J]}."""
    X = np.ones((n, 1))
    for j in selected:
        X = np.hstack([X, backend.column_f64(j)[:, None]])
    out = {"model": X}
    if add is not None:
        out[f"model+{add}"] = np.hstack([X, backend.column_f64(add)[:, None]])
    return out


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def matfree_profile(backend, y: np.ndarray, Xs: dict[str, np.ndarray],
                    proto_name: str, s0: float,
                    lanczos: str = "device") -> dict:
    """The matrix-free engine's profile, δ̂ and log-likelihood of each
    model at one protocol; the model plus J also refit as the scan's
    accept test (δ-hinted at the model's δ̂). ``lanczos`` builds the basis
    on [X y] by the backend's device Lanczos (the engine's own) or, with
    "host", by ShiftedKrylov's host f64 recurrence over the same kernel
    matvec (the JAX package's path on a TPU, whose breakdown guard is
    1e-12 where the device one is 1e-5)."""
    from eagleeverything_tpu_torch.models import bigscan, reml_core
    from eagleeverything_tpu_torch.ops import packed

    proto = protocol(proto_name)
    n, p = y.shape[0], backend.src.p
    # the kernels' launches in this profile, read as a difference so that
    # a caller's own count around the run stays whole
    before = dict(packed.LAUNCHES)
    t0 = time.perf_counter()
    ctx = bigscan.make_context(backend, n, probes=proto["probes"],
                               lanczos_m=proto["lanczos_m"], s0=s0)
    ctx.solve_m, ctx.solve_m_refit = proto["solve_m"], proto["solve_m_refit"]
    out = {"protocol": proto_name, **proto, "lanczos": lanczos,
           "models": {}}
    fits = {}
    # each model's raw Ritz values and quadrature weights (Q0²), for
    # weight_below_floor once the exact spectrum is known (run pops them)
    nodes = out["_nodes"] = {}
    for name, X in Xs.items():
        Xi, _ = reml_core.independent_cols(X)
        B = np.column_stack([Xi, y])
        print(f"[dbg] {proto_name} {name}: X rank {Xi.shape[1]} of "
              f"{X.shape[1]}; B finite:", bool(np.all(np.isfinite(B))),
              flush=True)
        t1 = time.perf_counter()
        sk = bigscan.ShiftedKrylov(
            ctx.kernel_matvec, B, m=ctx.solve_m, reorth=True,
            device_lanczos=ctx.device_lanczos if lanczos == "device"
            else None)
        sk_s = time.perf_counter() - t1
        print(f"[dbg] sk built in {sk_s:.0f}s; w finite:",
              bool(np.all(np.isfinite(sk.w))), "w range",
              float(np.min(sk.w)), float(np.max(sk.w)),
              "znorm", sk.z_norm.tolist(), flush=True)
        rows = []
        for d_ in GRID:
            Sol = sk.solve(d_)
            ld = ctx.logdet(d_)
            ll, yPy = bigscan._ll_from_solution(y, Xi, Sol, ld)
            finite = bool(np.all(np.isfinite(Sol)))
            print(f"[dbg] delta={d_:10.4g} logdet={ld:14.3f} ll={ll:16.4f} "
                  f"yPy={yPy:12.4f} sol_finite={finite}", flush=True)
            row = {"engine": "matfree", "protocol": proto_name,
                   "model": name, "delta": float(d_), "logdet": ld,
                   "ll": ll, "yPy": yPy, "sol_finite": finite}
            _emit(row)
            rows.append(row)
        # the unhinted fit over this same basis (reml_maximize_matfree
        # builds the identical one when no solver is given)
        t1 = time.perf_counter()
        fit = bigscan.reml_maximize_matfree(ctx, y, X, solver=sk.solve)
        k = X.shape[1] - 1
        m = {"k": k, "delta_hat": fit.delta, "loglik": fit.loglik,
             "extbic": reml_core.extbic(fit.loglik, n, p, k),
             "logdet_at_delta_hat": ctx.logdet(fit.delta),
             "w_min": float(np.min(sk.w)), "w_max": float(np.max(sk.w)),
             **krylov_fields(sk),
             "z_norm": sk.z_norm.tolist(), "basis_s": sk_s,
             "fit_s": time.perf_counter() - t1, "profile": rows}
        print(f"[dbg] {proto_name} {name}: raw Ritz min {m['w_raw_min']:.6g}"
              f" ({m['n_negative']} below 0), guard steps "
              f"{m['guard_step']}", flush=True)
        out["models"][name] = m
        nodes[name] = (sk.w_raw, sk.Q0 ** 2)
        fits[name] = fit
        del sk
    names = list(Xs)
    if len(names) == 2:
        base, plus = names
        t1 = time.perf_counter()
        hinted = bigscan.reml_maximize_matfree(
            ctx, y, Xs[plus], delta_hint=fits[base].delta)
        k = Xs[plus].shape[1] - 1
        out["models"][plus]["hinted_refit"] = {
            "delta_hat": hinted.delta, "loglik": hinted.loglik,
            "extbic": reml_core.extbic(hinted.loglik, n, p, k),
            "fit_s": time.perf_counter() - t1}
        mb, mp = out["models"][base], out["models"][plus]
        out["extbic_change"] = mp["extbic"] - mb["extbic"]
        out["extbic_change_hinted"] = (mp["hinted_refit"]["extbic"]
                                       - mb["extbic"])
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = {k: v - before[k] for k, v in packed.LAUNCHES.items()}
    return out


def krylov_fields(sk) -> dict:
    """What ShiftedKrylov's clip of negative Ritz values to 0 hides (ROADMAP
    F5), over the columns of [X y]: the smallest raw Ritz value, how many
    fall below 0, the three lowest of each column, each column's
    breakdown-guard step (-1: never) and its smallest β_k / (|α_k| +
    β_{k-1}) (the device guard fires below 1e-5)."""
    low = np.sort(sk.w_raw, axis=0)[:3]
    return {"w_raw_min": float(np.min(sk.w_raw)),
            "n_negative": int(np.sum(sk.w_raw < 0.0)),
            "w_raw_low": low.T.tolist(),
            "guard_step": [int(g) for g in sk.guard_step],
            "guard_ratio_min": [float(g) for g in sk.guard_ratio],
            "alpha_head": sk.alphas[:4].T.tolist(),
            "beta_head": sk.betas[:4].T.tolist()}


# a Ritz value counts as below the exact floor only past this share of
# the largest one: an f32 Lanczos resolves a Ritz value to ~ε·‖K‖ (6e-8),
# so one that converged on the floor lands within a few of those of it
FLOOR_MARGIN = 1e-6


def weight_below(w_raw: np.ndarray, q0sq: np.ndarray,
                 floor: float) -> list[float]:
    """Each column's quadrature weight (Q0², of 1 in all) on Ritz values
    below ``floor``, the exact kernel's smallest eigenvalue on the same δ
    scale, by more than FLOOR_MARGIN of the largest: the share of the
    column's solve that 1/(w + δ) reads off nodes the kernel does not
    have."""
    below = w_raw < floor - FLOOR_MARGIN * np.max(w_raw)
    return [float(v) for v in np.sum(np.where(below, q0sq, 0.0), axis=0)]


def _rotate(basis, B: np.ndarray, device: torch.device,
            block: int = 4096) -> np.ndarray:
    """Uᵀ·B in f64: on the host when U is there, else on the device in
    column blocks of U (each block widened to f64)."""
    U = basis.host_f64
    if U is not None:
        return U.T @ B
    Ud = basis.device_basis()
    Bd = torch.as_tensor(B, dtype=torch.float64, device=device)
    out = torch.empty((Ud.shape[1], B.shape[1]), dtype=torch.float64,
                      device=device)
    for c0 in range(0, Ud.shape[1], block):
        out[c0:c0 + block] = Ud[:, c0:c0 + block].double().T @ Bd
    return out.cpu().numpy()


def _eig_residuals(K: np.ndarray, basis,
                   device: torch.device) -> tuple[float, float]:
    """(‖KU − UD‖_F / ‖K‖_F, ‖UᵀU − I‖_F / √n) of the eigendecomposition,
    in f64 on the host when U is there, else in f32 on the device
    (engine_torch.eig_residuals)."""
    from eagleeverything_tpu_torch.models import engine_torch

    n = K.shape[0]
    d = basis.d
    U = basis.host_f64
    if U is not None:
        r = np.linalg.norm(K @ U - U * d[None, :]) / np.linalg.norm(K)
        o = np.linalg.norm(U.T @ U - np.eye(n)) / math.sqrt(n)
        return float(r), float(o)
    return engine_torch.eig_residuals(
        torch.as_tensor(K, dtype=torch.float32, device=device),
        torch.as_tensor(d, device=device), basis.device_basis())


class CholeskyKernel:
    """H(δ) = K + δI for the normalised kernel K (on the matrix-free δ
    scale), factored H = L·Lᵀ in f64 on ``device`` by a blocked
    right-looking Cholesky: torch.linalg.cholesky on diagonal blocks of
    ``block`` rows, triangular solves for the panels and products for the
    trailing update, so that no solver call sees more than block² entries.
    It is the f64 cross-check of the eigh route, which holds K in f32. The
    last factor is kept; log|H| and H⁻¹·B are exact up to f64 rounding of
    K."""

    def __init__(self, K_raw: np.ndarray, s0: float, device: torch.device,
                 block: int = 8192):
        self.K = torch.as_tensor(K_raw, dtype=torch.float64,
                                 device=device).div_(s0)
        self.n, self.block, self.device = K_raw.shape[0], block, device
        self.factorizations = 0
        self.factor_s = 0.0
        self._delta: float | None = None
        self._L: torch.Tensor | None = None

    def factor(self, delta: float) -> torch.Tensor:
        if self._delta == delta:
            return self._L
        self._L = None
        t0 = time.perf_counter()
        A = self.K.clone()
        A.diagonal().add_(delta)
        n, b = self.n, self.block
        for k0 in range(0, n, b):
            k1 = min(n, k0 + b)
            L11 = torch.linalg.cholesky(A[k0:k1, k0:k1])
            A[k0:k1, k0:k1] = L11
            if k1 == n:
                break
            # L21 = A21·L11⁻ᵀ, then the lower trailing block -= L21·L21ᵀ
            L21 = torch.linalg.solve_triangular(L11.mT, A[k1:, k0:k1],
                                                upper=True, left=False)
            A[k1:, k0:k1] = L21
            for i0 in range(k1, n, b):
                i1 = min(n, i0 + b)
                A[i0:i1, k1:i1] -= L21[i0 - k1:i1 - k1] @ L21[:i1 - k1].T
        A.tril_()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.factor_s += time.perf_counter() - t0
        self.factorizations += 1
        self._L, self._delta = A, delta
        return A

    def logdet(self, delta: float) -> float:
        return 2.0 * float(torch.sum(torch.log(
            torch.diagonal(self.factor(delta)))))

    def solve(self, delta: float, B: np.ndarray) -> np.ndarray:
        """H(δ)⁻¹·B by blocked forward and back substitution."""
        L = self.factor(delta)
        n, b = self.n, self.block
        X = torch.as_tensor(np.ascontiguousarray(B), dtype=torch.float64,
                            device=self.device).clone()
        for k0 in range(0, n, b):
            k1 = min(n, k0 + b)
            rhs = X[k0:k1] - L[k0:k1, :k0] @ X[:k0]
            X[k0:k1] = torch.linalg.solve_triangular(L[k0:k1, k0:k1], rhs,
                                                     upper=False)
        for k0 in reversed(range(0, n, b)):
            k1 = min(n, k0 + b)
            rhs = X[k0:k1] - L[k1:, k0:k1].T @ X[k1:]
            X[k0:k1] = torch.linalg.solve_triangular(
                L[k0:k1, k0:k1].mT, rhs, upper=True)
        return X.cpu().numpy()

    def residual(self, delta: float) -> float:
        """‖L·Lᵀ − H(δ)‖_F / ‖H(δ)‖_F, a row block at a time."""
        L = self.factor(delta)
        rr = hh = 0.0
        for i0 in range(0, self.n, self.block):
            i1 = min(self.n, i0 + self.block)
            H = self.K[i0:i1].clone()
            H[:, i0:i1].diagonal().add_(delta)
            rr += float(torch.sum((L[i0:i1, :i1] @ L[:, :i1].T - H) ** 2))
            hh += float(torch.sum(H * H))
        return math.sqrt(rr / hh)


class _ExactContext:
    """What bigscan.reml_maximize_matfree asks of its context, answered
    exactly by a CholeskyKernel: log|H(δ)| and H(δ)⁻¹·B, each δ factored
    once (the solve of the widest [X y] is kept by δ and each model reads
    its columns)."""

    solve_m = solve_m_refit = 0          # no Krylov basis is built

    def __init__(self, chol: CholeskyKernel, B_full: np.ndarray):
        self.chol, self.B_full = chol, B_full
        self._cache: dict[float, tuple[float, np.ndarray]] = {}

    def _at(self, delta: float) -> tuple[float, np.ndarray]:
        if delta not in self._cache:
            self._cache[delta] = (self.chol.logdet(delta),
                                  self.chol.solve(delta, self.B_full))
        return self._cache[delta]

    def logdet(self, delta: float) -> float:
        return self._at(delta)[0]

    def solver(self, q: int):
        """δ ↦ H(δ)⁻¹·[X_q y] for the model of the first q columns."""
        cols = list(range(q)) + [self.B_full.shape[1] - 1]
        return lambda delta: self._at(delta)[1][:, cols]

    def solve_block(self, delta: float, B: np.ndarray,
                    x0: np.ndarray | None = None) -> np.ndarray:
        return self.chol.solve(delta, B)


def _host_free_gb() -> float | None:
    try:
        with open("/proc/meminfo") as f:
            info = dict(line.split(":", 1) for line in f)
        return int(info["MemAvailable"].split()[0]) / 2**20
    except (OSError, KeyError, ValueError):
        return None


def _exact_eigh(K_raw: np.ndarray, s0_e: float, scale: float, y, Xs,
                config, dev, out: dict) -> dict:
    """The eigh route: engine_torch.eigh_basis of the normalised kernel,
    Uᵀ[X y], reml_core.reml_loglik_diag / reml_maximize_diag. Returns
    {model: (profile rows, fit)}, and the exact log|H(δ)| on out."""
    from eagleeverything_tpu_torch.models import engine_torch, reml_core

    K = engine_torch.normalized_kernel(K_raw)
    out["host_free_gb_after_K"] = _host_free_gb()
    t0 = time.perf_counter()
    basis = engine_torch.eigh_basis(K, config, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["eigh_s"] = time.perf_counter() - t0
    out["eigh_on"] = "host f64" if basis.host_f64 is not None \
        else f"{dev.type} f32"
    t0 = time.perf_counter()
    out["eig_residual"], out["orth_residual"] = _eig_residuals(K, basis, dev)
    out["residual_s"] = time.perf_counter() - t0
    del K
    d_e = basis.d
    d_mf = d_e * scale          # the spectrum of K_raw / s0_mf
    out.update(d_min=float(d_e[0]), d_max=float(d_e[-1]),
               floor_matfree=float(d_mf[0]))
    names = list(Xs)
    t0 = time.perf_counter()
    R = _rotate(basis, np.column_stack([Xs[names[-1]], y]), dev)
    out["rotate_s"] = time.perf_counter() - t0
    ys = R[:, -1]
    res, Xst = {}, {}
    for name in names:
        q = Xs[name].shape[1]
        Xst[name], _ = reml_core.independent_cols(R[:, :q])
        rows = [reml_core.reml_loglik_diag(float(d_), d_mf, ys, Xst[name],
                                           Xst[name].shape[1])
                for d_ in np.concatenate([GRID, TAIL])]
        fit = reml_core.reml_maximize_diag(d_e, ys, R[:, :q])
        res[name] = (rows, fit.delta / scale, fit.loglik,
                     {"delta_hat_exact_scale": fit.delta})
    out["_logdet"] = lambda d_: float(np.sum(np.log(d_mf + d_)))
    out["_ll_at"] = lambda name, d_: reml_core.reml_loglik_diag(
        float(d_), d_mf, ys, Xst[name], Xst[name].shape[1])
    return res


def _exact_cholesky(K_raw: np.ndarray, s0_mf: float, y, Xs, dev,
                    out: dict, block: int) -> dict:
    """The Cholesky route: each δ's H(δ) factored on the device
    (CholeskyKernel), bigscan._ll_from_solution on the exact log|H| and
    H⁻¹[X y], each model's δ̂ by bigscan.reml_maximize_matfree's search
    over them. Returns {model: (profile rows, fit)}."""
    from eagleeverything_tpu_torch.models import bigscan, reml_core

    t0 = time.perf_counter()
    chol = CholeskyKernel(K_raw, s0_mf, dev, block)
    out["upload_s"] = time.perf_counter() - t0
    names = list(Xs)
    ctx = _ExactContext(chol, np.column_stack([Xs[names[-1]], y]))
    res = {}
    for name in names:
        X = Xs[name]
        Xi, _ = reml_core.independent_cols(X)
        if Xi.shape[1] != X.shape[1]:
            raise ValueError(f"{name}: X has rank {Xi.shape[1]} of "
                             f"{X.shape[1]}")
        solver = ctx.solver(X.shape[1])
        rows = [bigscan._ll_from_solution(y, X, solver(float(d_)),
                                          ctx.logdet(float(d_)))[0]
                for d_ in np.concatenate([GRID, TAIL])]
        fit = bigscan.reml_maximize_matfree(ctx, y, X, solver=solver)
        res[name] = (rows, fit.delta, fit.loglik, {})
    t0 = time.perf_counter()
    delta = res[names[0]][1]
    out["chol_residual"] = chol.residual(delta)
    out["chol_residual_delta"] = delta
    out["residual_s"] = time.perf_counter() - t0
    out.update(factorizations=chol.factorizations, factor_s=chol.factor_s,
               block=block)
    out["_logdet"] = ctx.logdet
    out["_ll_at"] = lambda name, d_: bigscan._ll_from_solution(
        y, Xs[name], ctx.solver(Xs[name].shape[1])(float(d_)),
        ctx.logdet(float(d_)))[0]
    return res


def exact_route(n: int, device: torch.device) -> str:
    """"eigh", the exact engine's own REML, at every n and on every
    device: eigh_basis decomposes every kernel the card holds
    (engine_torch.eigh_large above the library's limit). "cholesky" runs
    only when asked for."""
    return "eigh"


def limit_loglik(y: np.ndarray, X: np.ndarray) -> float:
    """The restricted log-likelihood as δ → ∞: H = K + δI tends to a
    multiple of I, which the profiled likelihood does not see, so it is
    _ll_from_solution at H = I (the OLS REML of [X y])."""
    from eagleeverything_tpu_torch.models import bigscan, reml_core
    Xi, _ = reml_core.independent_cols(X)
    return bigscan._ll_from_solution(y, Xi, np.column_stack([Xi, y]),
                                     0.0)[0]


def compute_K(backend) -> tuple[np.ndarray, dict]:
    """The raw kernel (TiledScan.compute_K), its seconds and the host's
    free memory before it."""
    out = {"host_free_gb_before_K": _host_free_gb()}
    t0 = time.perf_counter()
    K_raw = backend.compute_K()
    if backend.device.type == "cuda":
        torch.cuda.synchronize(backend.device)
    out["compute_K_s"] = time.perf_counter() - t0
    return K_raw, out


def exact_profile(backend, y: np.ndarray, Xs: dict[str, np.ndarray],
                  s0_mf: float, config, route: str = "eigh",
                  block: int = 8192, kernel=None) -> dict:
    """The exact engine's profile, δ̂ and log-likelihood of each model, on
    the matrix-free δ scale (s0_mf), by ``route``: "eigh" (the exact
    engine's eigenbasis REML) or "cholesky" (exact log|H| and solves at
    each δ in f64, its cross-check); each model also on the tail grid, at
    δ → ∞, and its supremum over all of them. ``kernel``: compute_K's
    result, to share one kernel between routes (else computed here)."""
    from eagleeverything_tpu_torch.models import reml_core

    n, p = y.shape[0], backend.src.p
    dev = backend.device
    K_raw, out = kernel or compute_K(backend)
    out = {"route": route, **out}
    s0_e = float(np.mean(np.diag(K_raw)))
    scale = s0_e / s0_mf
    out.update(s0_exact=s0_e, s0_matfree=s0_mf)
    if route == "eigh":
        res = _exact_eigh(K_raw, s0_e, scale, y, Xs, config, dev, out)
    else:
        res = _exact_cholesky(K_raw, s0_mf, y, Xs, dev, out, block)
    del K_raw, kernel
    out["models"] = {}
    for name, (lls, delta, ll, extra) in res.items():
        rows = []
        for d_, ll_d in zip(np.concatenate([GRID, TAIL]), lls):
            row = {"engine": "exact", "model": name, "delta": float(d_),
                   "logdet": out["_logdet"](float(d_)), "ll": ll_d}
            print(f"[dbg] exact {name} delta={d_:10.4g} "
                  f"logdet={row['logdet']:14.3f} ll={ll_d:16.4f}",
                  flush=True)
            _emit(row)
            rows.append(row)
        k = Xs[name].shape[1] - 1
        tail = rows[len(GRID):]
        ll_inf = limit_loglik(y, Xs[name])
        sup = max(ll, ll_inf, *(r["ll"] for r in tail))
        print(f"[dbg] exact {name} delta=inf ll={ll_inf:16.4f}; "
              f"supremum {sup:.4f}", flush=True)
        out["models"][name] = {
            "k": k, "delta_hat": delta, "loglik": ll,
            "extbic": reml_core.extbic(ll, n, p, k), **extra,
            "loglik_limit": ll_inf, "loglik_sup": sup,
            "extbic_limit": reml_core.extbic(ll_inf, n, p, k),
            "extbic_sup": reml_core.extbic(sup, n, p, k),
            "profile": rows[:len(GRID)], "tail": tail}
    names = list(Xs)
    if len(names) == 2:
        mb, mp = (out["models"][m] for m in names)
        for key in ("", "_limit", "_sup"):
            out["extbic_change" + key] = (mp["extbic" + key]
                                          - mb["extbic" + key])
    return out


def run(dir: str, selected: list[int], add: int | None, exact: bool,
        protocols: list[str], device="cuda", out: str = "",
        routes: tuple[str, ...] | None = None, block: int = 8192,
        host_eigh_max_n: int = 32768, lanczos: str = "device") -> dict:
    """Profile the model (and the model plus ``add``) on the cohort in
    ``dir`` with the matrix-free engine at each protocol and, with
    ``exact``, the exact engine by each of ``routes`` (default the one
    ``exact_route`` picks); write and return the result (``exact`` holds
    the first route's, ``exact_<route>`` each other's)."""
    crt = _cohort_run()
    dev = torch.device(device)
    meta, y = crt._load(dir)
    n, p = meta["n"], meta["p"]
    t0 = time.perf_counter()
    backend = crt._backend(dir, meta, "off", dev)
    Xs = models(backend, n, selected, add)
    s0 = hutchinson_s0(backend, n)
    result = {"n": n, "p": p, "selected": selected, "add": add,
              "device": crt._where(dev), "grid": GRID.tolist(),
              "s0": s0, "context_s": time.perf_counter() - t0,
              "stack": backend.stack_info(), "matfree": {}}
    routes = routes or (exact_route(n, dev),)
    path = out or os.path.join(dir, "f4_debug.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def save() -> None:
        with open(path, "w") as f:
            json.dump(result, f, indent=1)

    nodes = {}
    for name in protocols:
        result["matfree"][name] = matfree_profile(backend, y, Xs, name, s0,
                                                  lanczos)
        nodes[name] = result["matfree"][name].pop("_nodes")
        save()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    kernel = compute_K(backend) if exact and len(routes) > 1 else None
    for i, route in enumerate(routes if exact else ()):
        ex = exact_profile(backend, y, Xs, s0,
                           crt._cohort_cfg("off", host_eigh_max_n),
                           route, block, kernel)
        logdet, ll_at = ex.pop("_logdet"), ex.pop("_ll_at")
        if i == 0:
            # the exact engine at each matrix-free δ̂: its log|H| beside
            # the SLQ one, its log-likelihood there, and how far the
            # matrix-free extBIC lies above the exact one (at the exact
            # supremum) and its profile from the exact profile
            for mf in result["matfree"].values():
                for name, m in mf["models"].items():
                    em = ex["models"][name]
                    m["exact_logdet_at_delta_hat"] = logdet(m["delta_hat"])
                    m["exact_ll_at_delta_hat"] = ll_at(name, m["delta_hat"])
                    m["extbic_excess"] = m["extbic"] - em["extbic_sup"]
                    m["profile_gap_max"] = max(
                        abs(a["ll"] - b["ll"]) for a, b in
                        zip(m["profile"][2:-2], em["profile"][2:-2]))
            if "floor_matfree" in ex:
                for proto, mf in result["matfree"].items():
                    for name, m in mf["models"].items():
                        m["weight_below_floor"] = weight_below(
                            *nodes[proto][name], ex["floor_matfree"])
        result["exact" if i == 0 else f"exact_{route}"] = ex
        save()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if dev.type == "cuda":
        result["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    result["seconds"] = time.perf_counter() - t0
    save()
    summary = {k: v for k, v in result.items()
               if k not in ("matfree", "grid", "stack")
               and not k.startswith("exact")}
    for name, mf in result["matfree"].items():
        summary[f"matfree_{name}"] = {
            m: {k: v[k] for k in ("delta_hat", "loglik", "extbic",
                                  "extbic_excess", "profile_gap_max",
                                  "w_raw_min", "n_negative", "guard_step",
                                  "weight_below_floor")
                if k in v}
            for m, v in mf["models"].items()}
        summary[f"matfree_{name}"]["extbic_change"] = mf.get("extbic_change")
    if exact:
        summary["exact"] = {
            m: {k: v[k] for k in ("delta_hat", "loglik", "extbic",
                                  "loglik_limit", "loglik_sup")}
            for m, v in result["exact"]["models"].items()}
        for key in ("", "_limit", "_sup"):
            summary["exact"]["extbic_change" + key] = result["exact"].get(
                "extbic_change" + key)
        for key in ("route", "eig_residual", "chol_residual"):
            if key in result["exact"]:
                summary["exact"][key] = result["exact"][key]
    print(json.dumps(summary), flush=True)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=os.environ.get(
        "EAGLE_COHORT_DIR", os.path.join(REPO, "build", "cohort")))
    ap.add_argument("--selected", default=",".join(map(str, SELECTED)))
    ap.add_argument("--add", type=int, default=None)
    ap.add_argument("--exact", action="store_true")
    ap.add_argument("--protocol", default="default",
                    help="comma-separated: default, tight")
    ap.add_argument("--routes", default="",
                    help="comma-separated exact routes: eigh, cholesky "
                         "(default: exact_route's)")
    ap.add_argument("--host-eigh-max-n", type=int, default=32768,
                    help="the eigh route decomposes on the host in f64 up "
                         "to this n (the cohort config's), on the device "
                         "above it")
    ap.add_argument("--lanczos", default="device", choices=["device", "host"],
                    help="the [X y] basis by the device Lanczos (the "
                         "engine's) or the host f64 recurrence over the same "
                         "matvec")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu")
    protocols = [s for s in args.protocol.split(",") if s]
    for name in protocols:
        if name not in PROTOCOLS:
            raise SystemExit(f"unknown protocol {name!r}")
    routes = tuple(s for s in args.routes.split(",") if s) or None
    for route in routes or ():
        if route not in ("eigh", "cholesky"):
            raise SystemExit(f"unknown route {route!r}")
    run(args.dir, [int(s) for s in args.selected.split(",") if s],
        args.add, args.exact, protocols, args.device, args.out, routes,
        host_eigh_max_n=args.host_eigh_max_n, lanczos=args.lanczos)


if __name__ == "__main__":
    main()
