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
the port's own figure beside it). Prints one JSON object and writes it to
``--out``.

Usage (from the root of a checkout, on the CPU):

  JAX_PLATFORMS=cpu python tests/jax_matfree_profile.py --dir COHORT \\
      --port PORT.json [--protocol default] [--out FILE]
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
    out = {"n": n, "p": p, "protocol": proto_name, "models": {}}
    for name, Xm in Xs.items():
        Xi, _ = jrc.independent_cols(Xm)
        sk = jbs.ShiftedKrylov(ctx.kernel_matvec, np.column_stack([Xi, y]),
                               m=ctx.solve_m, reorth=True,
                               device_lanczos=ctx.device_lanczos)
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
             "loglik_gap": pm["loglik"] - fit.loglik}
        if name in exact:
            m["extbic_excess"] = m["extbic"] - exact[name]["extbic_sup"]
            m["port_extbic_excess"] = pm.get("extbic_excess")
        out["models"][name] = m
        print(f"[jax] {name}: δ̂ {fit.delta:.4g} (port {pm['delta_hat']:.4g}),"
              f" LL {fit.loglik:.4f} (port {pm['loglik']:.4f}), profile gap "
              f"{m['profile_gap_max']:.3g}", flush=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", required=True)
    ap.add_argument("--port", required=True)
    ap.add_argument("--protocol", default="default")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    with open(args.port) as f:
        port = json.load(f)
    res = profile(args.dir, port, args.protocol)
    res["port_device"] = port["device"]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "models"}
                     | {name: {k: v for k, v in m.items() if k != "profile"}
                        for name, m in res["models"].items()}))


if __name__ == "__main__":
    main()
