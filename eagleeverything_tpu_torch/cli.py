"""Command-line interface of the PyTorch/CUDA port — the scriptable
replacement for the reference's Shiny GUI (SURVEY.md §8 design stance: "a
notebook/CLI replaces the GUI"). Run as
``python -m eagleeverything_tpu_torch.cli``; the subcommands mirror the
exported API 1:1:

  simulate  --out DIR [--n N --p P --seed S]
  am        --geno F --pheno F --trait NAME [--map F ... --summary --plot F]
  fpr4am    --geno F --pheno F --trait NAME [--numreps R ...]
  gui       [--host H --port P --no-browser]

``am``, ``fpr4am`` and ``gui`` run on CUDA unless given ``--device cpu``.
A multi-process run starts one process a card, each with EAGLE_COORD_ADDR
(rank 0's host:port), EAGLE_NUM_PROCS and EAGLE_PROC_ID set
(utils/distributed); ``--engine sharded`` then shards the exact engine over
them, and the matrix-free engine holds each rank's SNP range.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="eagle-torch",
        description="Whole-genome multiple-locus association mapping on "
                    "PyTorch/CUDA",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("simulate", help="write a simulated tutorial dataset")
    sp.add_argument("--out", required=True)
    sp.add_argument("--n", type=int, default=150)
    sp.add_argument("--p", type=int, default=5000)
    sp.add_argument("--seed", type=int, default=7)

    def add_device_arg(p):
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="where the scan runs (default cuda)")

    def add_scan_args(p):
        p.add_argument("--geno", required=True, help="genotype file")
        p.add_argument("--geno-type", default="text",
                       choices=["text", "PLINK", "vcf"])
        p.add_argument("--AA", default="AA")
        p.add_argument("--AB", default="AB")
        p.add_argument("--BB", default="BB")
        p.add_argument("--missing", default="NA")
        p.add_argument("--pheno", required=True)
        p.add_argument("--trait", required=True)
        p.add_argument("--fformula", default=None,
                       help="fixed-effects formula RHS, e.g. 'age + sex'")
        p.add_argument("--map", default=None)
        p.add_argument("--zmat", default=None)
        p.add_argument("--availmemGb", type=float, default=8.0)
        p.add_argument("--engine", default="auto",
                       choices=["auto", "jax", "sharded", "matfree", "oracle"])
        add_device_arg(p)

    am_p = sub.add_parser("am", help="run the multiple-locus scan")
    add_scan_args(am_p)
    am_p.add_argument("--traits", default=None,
                      help="comma-separated trait list for a lockstep "
                           "multi-trait scan (overrides --trait)")
    am_p.add_argument("--maxit", type=int, default=40)
    am_p.add_argument("--fixit", action="store_true")
    am_p.add_argument("--lambda", dest="lam", type=float, default=1.0)
    am_p.add_argument("--plot", default=None, help="write Manhattan plot here")
    am_p.add_argument("--json", default=None, help="write result JSON here")
    am_p.add_argument("--ckpt-dir", default=None,
                      help="checkpoint dir (MMt cache + scan state)")
    am_p.add_argument("--resume", action="store_true",
                      help="resume a checkpointed scan")
    am_p.add_argument("--log-jsonl", default=None,
                      help="structured per-iteration metrics file")
    am_p.add_argument("--profile", default=None, metavar="DIR",
                      help="write a torch.profiler trace (Chrome/Perfetto "
                           "JSON) of the scan to DIR")
    am_p.add_argument("--summary", action="store_true",
                      help="also print SummaryAM-style Wald table")

    gui_p = sub.add_parser("gui", help="launch the browser GUI (OpenGUI analog)")
    gui_p.add_argument("--host", default="127.0.0.1")
    gui_p.add_argument("--port", type=int, default=8765)
    gui_p.add_argument("--no-browser", action="store_true")
    add_device_arg(gui_p)

    fpr_p = sub.add_parser("fpr4am", help="calibrate extBIC lambda by permutation")
    add_scan_args(fpr_p)
    fpr_p.add_argument("--falseposrate", type=float, default=0.05)
    fpr_p.add_argument("--numreps", type=int, default=100)
    fpr_p.add_argument("--seed", type=int, default=0)

    args = ap.parse_args(argv)
    from eagleeverything_tpu_torch.utils.distributed import maybe_initialize
    maybe_initialize()  # a multi-process run when EAGLE_COORD_ADDR is set
    try:
        return _run(args)
    except (KeyError, ValueError, FileNotFoundError,
            NotImplementedError) as e:
        msg = e.args[0] if e.args else e
        print(f"error: {msg}", file=sys.stderr)
        return 2


@contextlib.contextmanager
def _profiled(trace_dir, device: str):
    """Trace the block with torch.profiler (CUDA activity too on the card)
    and write its Chrome trace into ``trace_dir``; without a directory,
    run it untraced."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def _run(args) -> int:
    if args.cmd == "simulate":
        from eagleeverything_tpu_torch.data.simulate import write_tutorial
        sim = write_tutorial(args.out, n=args.n, p=args.p, seed=args.seed)
        print(f"wrote {args.out}: geno.txt pheno.txt map.txt "
              f"({sim.geno.shape[0]} x {sim.geno.shape[1]}, "
              f"QTL at {sim.qtl_idx.tolist()})")
        return 0

    if args.cmd == "gui":
        from eagleeverything_tpu_torch.gui import open_gui
        open_gui(host=args.host, port=args.port,
                 open_browser=not args.no_browser, block=True,
                 device=args.device)
        return 0

    # scan-style commands share the data loading
    import eagleeverything_tpu_torch as ee

    geno = ee.read_marker(args.geno, type=args.geno_type, AA=args.AA,
                          AB=args.AB, BB=args.BB, missing=args.missing,
                          availmemGb=args.availmemGb)
    pheno = ee.read_pheno(args.pheno)
    map_h = ee.read_map(args.map) if args.map else None
    zmat = ee.read_zmat(args.zmat) if args.zmat else None

    if args.cmd == "am":
        prof = _profiled(args.profile, args.device)
        if args.traits:
            traits = [t.strip() for t in args.traits.split(",") if t.strip()]
            with prof:
                results = ee.am_multi(traits, geno=geno, pheno=pheno,
                                      fformula=args.fformula, map=map_h,
                                      maxit=args.maxit, fixit=args.fixit,
                                      lam=args.lam, quiet=False,
                                      ckpt_dir=args.ckpt_dir,
                                      resume=args.resume,
                                      log_jsonl=args.log_jsonl,
                                      device=args.device)
            if args.json:
                payload = {t: {"indices": r.indices,
                               "marker_names": r.marker_names,
                               "extbic_path": r.extbic_path}
                           for t, r in results.items()}
                with open(args.json, "w") as f:
                    json.dump(payload, f, indent=1)
                print(f"results written to {args.json}")
            return 0
        with prof:
            res = ee.am(trait=args.trait, geno=geno, pheno=pheno,
                        fformula=args.fformula, map=map_h, Zmat=zmat,
                        maxit=args.maxit, fixit=args.fixit, lam=args.lam,
                        quiet=False, engine=args.engine,
                        ckpt_dir=args.ckpt_dir, resume=args.resume,
                        log_jsonl=args.log_jsonl, device=args.device)
        if args.profile:
            print(f"profiler trace written to {args.profile}")
        if args.summary:
            ee.summary_am(res, trait=args.trait, geno=geno, pheno=pheno,
                          fformula=args.fformula, Zmat=zmat,
                          device=args.device)
        if args.plot:
            ee.plot_am(res, map=map_h, save=args.plot)
            print(f"plot written to {args.plot}")
        if args.json:
            payload = {
                "trait": res.trait_name,
                "indices": res.indices,
                "marker_names": res.marker_names,
                "chr": res.chr,
                "pos": res.pos,
                "extbic_path": res.extbic_path,
                "sigma2_g": res.sigma2_g,
                "sigma2_e": res.sigma2_e,
            }
            with open(args.json, "w") as f:
                json.dump(payload, f, indent=1)
            print(f"result written to {args.json}")
        return 0

    if args.cmd == "fpr4am":
        # map the shared --engine flag onto fpr4am's paths ("jax"/"sharded"
        # both mean the shared-eigenbasis device-batched calibration)
        fpr_engine = {"jax": "eig", "sharded": "eig", "oracle": "eig"}.get(
            args.engine, args.engine)
        out = ee.fpr4am(trait=args.trait, geno=geno, pheno=pheno,
                        fformula=args.fformula, Zmat=zmat,
                        falseposrate=args.falseposrate,
                        numreps=args.numreps, seed=args.seed, quiet=False,
                        engine=fpr_engine, device=args.device)
        print(f"calibrated lambda = {out['lambda']:.4f} "
              f"(target FPR {out['falseposrate']}, {out['numreps']} reps)")
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
