#!/usr/bin/env python
"""The JAX package's matrix-free REML profile and fit on a cohort of
scripts/cohort_run_torch.py, held to what scripts/debug_resume_fit_torch.py
wrote for the same cohort (its ``--out`` JSON, taken on the card or the
CPU): the reference's side of ROADMAP F5 at a cohort too large for the
test suite.

For each model of the port's JSON it builds, over the JAX TiledScan on the
same store, bigscan.make_context at the JSON's protocol and s0 (the same
Hutchinson and SLQ probes), ShiftedKrylov on [X y] and _ll_from_solution
on the grid exp(linspace(-6, 8, 25)), and reml_maximize_matfree over that
basis, as the port's script does. It reports, per model, the largest gap
between the two profiles and between the two fits' log-likelihoods, and
the JAX fit's extBIC above the port's exact supremum (``extbic_excess``,
the port's own figure beside it) and its profile's largest gap to the
port's exact one. Beside them it records what ShiftedKrylov's clip of
negative Ritz values hides, as the port's script does: the JAX backend's
device Lanczos is recorded as ShiftedKrylov calls it, and each column's
tridiagonal T is decomposed in f64 as ShiftedKrylov does, giving the raw
Ritz values (``w_raw_min``, ``n_negative``, ``w_raw_low``), the step at
which the breakdown guard zeroed each column (``guard_step``, -1: never),
each column's smallest β_k / (|α_k| + β_{k-1}) (``guard_ratio_min``), T's
first coefficients, and the quadrature weight Q0² on Ritz values below
the exact kernel's smallest eigenvalue by more than 1e-6 of the largest
(``weight_below_floor``, from the port's ``floor_matfree``). Prints one
JSON object and writes it to ``--out``.

Usage (from the root of a checkout, on the CPU):

  JAX_PLATFORMS=cpu python tests/jax_matfree_profile.py --dir COHORT \\
      --port PORT.json [--card CARD.json] [--protocol default[,tight]]
      [--out FILE]

``--card`` sets the debug script's run of the same cohort on the card
beside the two CPU runs (``side_by_side`` in the output).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

GRID = np.exp(np.linspace(-6.0, 8.0, 25))


def krylov_fields(alphas: np.ndarray, betas: np.ndarray,
                  floor: float | None) -> dict:
    """The raw Ritz values, guard steps and ratios (the port's
    bigscan.guard_steps / guard_ratio_min), T's first coefficients and the
    weight below ``floor`` of one Lanczos run's (α (m, r), β (m-1, r)),
    each column's T decomposed as ShiftedKrylov decomposes it."""
    from eagleeverything_tpu_torch.models.bigscan import (guard_ratio_min,
                                                          guard_steps)

    m, r = alphas.shape
    w = np.empty((m, r))
    q0sq = np.empty((m, r))
    for j in range(r):
        T = np.diag(alphas[:, j])
        if m > 1:
            T += np.diag(betas[:, j], 1) + np.diag(betas[:, j], -1)
        w[:, j], Q = np.linalg.eigh(T)
        q0sq[:, j] = Q[0] ** 2
    out = {"w_raw_min": float(w.min()), "n_negative": int(np.sum(w < 0.0)),
           "w_raw_low": np.sort(w, axis=0)[:3].T.tolist(),
           "guard_step": guard_steps(betas).tolist(),
           "guard_ratio_min": guard_ratio_min(alphas, betas).tolist(),
           "alpha_head": alphas[:4].T.tolist(),
           "beta_head": betas[:4].T.tolist()}
    if floor is not None:
        # below the floor by more than 1e-6 of the largest Ritz value (the
        # port's debug script's FLOOR_MARGIN: f32 Lanczos noise)
        below = w < floor - 1e-6 * w.max()
        out["weight_below_floor"] = np.sum(
            np.where(below, q0sq, 0.0), axis=0).tolist()
    return out


def profile(dir: str, port: dict, proto_name: str) -> dict:
    from eagleeverything_tpu.api.read import GenoHandle
    from eagleeverything_tpu.models import bigscan as jbs
    from eagleeverything_tpu.models import engine_jax
    from eagleeverything_tpu.models import reml_core as jrc
    from eagleeverything_tpu.utils.config import EagleConfig as JCfg

    n, p = port["n"], port["p"]
    y = np.load(os.path.join(dir, "y.npy"))
    mf = port["matfree"][proto_name]
    jsrc = engine_jax._make_source(
        GenoHandle(n=n, p=p, source="cohort",
                   store_dir=os.path.join(dir, "store")), None)
    jb = engine_jax.TiledScan(jsrc, JCfg(snp_tile=1024))
    t0 = time.perf_counter()
    ctx = jbs.make_context(jb, n, probes=mf["probes"],
                           lanczos_m=mf["lanczos_m"], s0=port["s0"])
    ctx.solve_m, ctx.solve_m_refit = mf["solve_m"], mf["solve_m_refit"]
    X = np.ones((n, 1))
    for j in port["selected"]:
        X = np.hstack([X, jb.column_f64(j)[:, None]])
    Xs = {"model": X}
    if port["add"] is not None:
        Xs[f"model+{port['add']}"] = np.hstack(
            [X, jb.column_f64(port["add"])[:, None]])
    exact = port.get("exact", {}).get("models", {})
    floor = port.get("exact", {}).get("floor_matfree")
    out = {"n": n, "p": p, "protocol": proto_name, "models": {}}
    for name, Xm in Xs.items():
        Xi, _ = jrc.independent_cols(Xm)
        B = np.column_stack([Xi, y])
        seen = []

        def recorded(Z, m, reorth):
            # the JAX backend's device Lanczos as ShiftedKrylov calls it;
            # None (its host recurrence) is passed on as it is
            res = ctx.device_lanczos(Z, m, reorth)
            if res is not None:
                seen.append((np.asarray(res[0])[:, :B.shape[1]],
                             np.asarray(res[1])[:, :B.shape[1]]))
            return res

        sk = jbs.ShiftedKrylov(ctx.kernel_matvec, B, m=ctx.solve_m,
                               reorth=True, device_lanczos=recorded
                               if ctx.device_lanczos else None)
        lls = [jbs._ll_from_solution(y, Xi, sk.solve(d), ctx.logdet(d))[0]
               for d in GRID]
        fit = jbs.reml_maximize_matfree(ctx, y, Xm, solver=sk.solve)
        k = Xm.shape[1] - 1
        pm = mf["models"][name]
        got = np.array([r["ll"] for r in pm["profile"]])
        m = {"delta_hat": fit.delta, "loglik": fit.loglik,
             "extbic": jrc.extbic(fit.loglik, n, p, k),
             "port_delta_hat": pm["delta_hat"], "port_loglik": pm["loglik"],
             "profile": lls,
             "profile_gap_max": float(np.max(np.abs(got - lls))),
             "profile_rel_gap_max": float(np.max(np.abs(got / lls - 1.0))),
             "loglik_gap": pm["loglik"] - fit.loglik,
             "lanczos": "device" if seen else "host"}
        if seen:
            m.update(krylov_fields(*seen[0], floor))
        if name in exact:
            m["extbic_excess"] = m["extbic"] - exact[name]["extbic_sup"]
            m["port_extbic_excess"] = pm.get("extbic_excess")
            ex = np.array([r["ll"] for r in exact[name]["profile"]])
            m["profile_gap_exact_max"] = float(
                np.max(np.abs(np.asarray(lls)[2:-2] - ex[2:-2])))
        out["models"][name] = m
        print(f"[jax] {name}: δ̂ {fit.delta:.4g} (port {pm['delta_hat']:.4g}),"
              f" LL {fit.loglik:.4f} (port {pm['loglik']:.4f}), profile gap "
              f"{m['profile_gap_max']:.3g}; raw Ritz min "
              f"{m.get('w_raw_min', float('nan')):.6g} (port "
              f"{pm.get('w_raw_min', float('nan')):.6g}), guard steps "
              f"{m.get('guard_step')} (port {pm.get('guard_step')})",
              flush=True)
    out["seconds"] = time.perf_counter() - t0
    return out


SIDE = ("w_raw_min", "n_negative", "guard_step", "delta_hat", "loglik",
        "profile_gap_max", "extbic_excess")


def side_by_side(res: dict, runs: dict[str, dict]) -> dict:
    """Per protocol and model, the F5 figures of the JAX run beside each
    of the port's ``runs`` (debug script JSONs by label): raw Ritz
    minimum, negative raw Ritz values, guard steps, δ̂, the log-likelihood
    there, the profile's largest gap to that run's exact profile and the
    extBIC excess over its exact supremum (the JAX run's gap and excess
    against the first run's exact side)."""
    out = {}
    for proto, pr in res["protocols"].items():
        out[proto] = {}
        for name, m in pr["models"].items():
            rows = {"jax cpu": {k: m.get(k) for k in SIDE}
                    | {"profile_gap_max": m.get("profile_gap_exact_max")}}
            for label, run in runs.items():
                rm = run["matfree"].get(proto, {}).get("models", {}).get(name)
                if rm is not None:
                    rows[label] = {k: rm.get(k) for k in SIDE}
            out[proto][name] = rows
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", required=True)
    ap.add_argument("--port", required=True)
    ap.add_argument("--card", default="",
                    help="the debug script's JSON of the same cohort on the "
                         "card, set beside the two CPU runs")
    ap.add_argument("--protocol", default="default")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    with open(args.port) as f:
        port = json.load(f)
    res = {"port_device": port["device"], "protocols": {}}
    for name in args.protocol.split(","):
        res["protocols"][name] = profile(args.dir, port, name)
    runs = {f"port {port['device']}": port}
    if args.card:
        with open(args.card) as f:
            card = json.load(f)
        runs[f"port {card['device']}"] = card
    res["side_by_side"] = side_by_side(res, runs)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    brief = ("profile", "w_raw_low", "guard_ratio_min", "alpha_head",
             "beta_head")
    print(json.dumps({name: {k: v for k, v in pr.items() if k != "models"}
                      | {m: {k: v for k, v in f.items() if k not in brief}
                         for m, f in pr["models"].items()}
                      for name, pr in res["protocols"].items()}))
    for proto, models in res["side_by_side"].items():
        for name, rows in models.items():
            print(f"{proto} {name}:")
            for label, r in rows.items():
                print(f"  {label:40s} w_raw_min {r['w_raw_min']:.6g} "
                      f"({r['n_negative']} < 0), guard {r['guard_step']}, "
                      f"δ̂ {r['delta_hat']:.5g}, LL {r['loglik']:.4f}, gap "
                      f"{r['profile_gap_max']:.3f}, excess "
                      f"{r['extbic_excess']:.3f}")


if __name__ == "__main__":
    main()
