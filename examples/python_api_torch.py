"""End-to-end Python-API walk-through on the PyTorch/CUDA port: the
vignette of examples/python_api.py (ReadMarker → ReadPheno → ReadMap → AM
→ SummaryAM → PlotAM, then the FPR calibration and the matrix-free
engine) with ``import eagleeverything_tpu_torch as ee``, on the committed
tutorial files.

Run from the root of a checkout, on the card unless ``--device cpu``:

  python examples/python_api_torch.py [--device cpu] [--plots DIR]

The plots go to ``--plots`` (default: a new temporary directory): the
Manhattan plot as interactive ``.html``, the extBIC trace as ``.png``
where matplotlib is installed. The last line is one JSON object with the
selection of each engine and the calibrated λ.
"""

import argparse
import importlib.util
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import eagleeverything_tpu_torch as ee  # noqa: E402

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tutorial")


def main() -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--plots", default="",
                    help="directory of the plots (default: a new "
                         "temporary directory)")
    args = ap.parse_args()
    dev = args.device
    plots = args.plots or tempfile.mkdtemp(prefix="eagle_vignette_")
    os.makedirs(plots, exist_ok=True)

    # 1. ingest ---------------------------------------------------------------
    geno = ee.read_marker(os.path.join(HERE, "geno.txt"), type="text")
    pheno = ee.read_pheno(os.path.join(HERE, "pheno.txt"))
    map_h = ee.read_map(os.path.join(HERE, "map.txt"))
    print(f"genotypes: {geno.n} individuals x {geno.p} SNPs")

    # 2. scan (reference AM()) --------------------------------------------------
    res = ee.am(trait="y", fformula="age + sex", geno=geno, pheno=pheno,
                map=map_h, maxit=8, quiet=False, device=dev)
    print("selected:", res.marker_names)

    # 3. inference (reference SummaryAM()) -------------------------------------
    ee.summary_am(res, trait="y", geno=geno, pheno=pheno,
                  fformula="age + sex", device=dev)

    # 4. plot (reference PlotAM()) ----------------------------------------------
    written = [ee.plot_am(res, map=map_h,
                          save=os.path.join(plots, "manhattan.html"))]
    if importlib.util.find_spec("matplotlib") is not None:
        trace = os.path.join(plots, "extbic.png")
        ee.plot_am(res, type="trace", save=trace)
        written.append(trace)
    else:
        print("extBIC trace not drawn: matplotlib is not installed")
    print("plots:", " ".join(written))

    # 5. extBIC-lambda calibration (reference FPR4AM()) ------------------------
    cal = ee.fpr4am(trait="y", fformula="age + sex", geno=geno, pheno=pheno,
                    numreps=10, falseposrate=0.05, device=dev)
    print(f"calibrated lambda for 5% FPR: {cal['lambda']:.3f}")

    # 6. the matrix-free engine (K1/K2 on the card: no n x n kernel matrix,
    #    CG + stochastic Lanczos REML, device-resident Krylov loops)
    res_mf = ee.am(trait="y", fformula="age + sex", geno=geno, pheno=pheno,
                   map=map_h, maxit=8, engine="matfree", device=dev)
    if res_mf.indices != res.indices:
        raise SystemExit(f"the engines disagree: {res.indices} against "
                         f"{res_mf.indices}")
    print("matfree selection identical:", res_mf.marker_names)

    out = {"device": str(dev), "selected": [int(j) for j in res.indices],
           "matfree_selected": [int(j) for j in res_mf.indices],
           "extbic_path": [float(v) for v in res.extbic_path],
           "lambda": float(cal["lambda"]), "plots": written}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
