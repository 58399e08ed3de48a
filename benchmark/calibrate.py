#!/usr/bin/env python3
"""Readings that set the limits of a cell's comparisons; not run by the
benchmark's own runs.

    python3 benchmark/calibrate.py --workload <name> --seeds 11,12,13 \
        [--control] [--seconds 0] [--out FILE]

For each seed, in one process: set up the cell as a run does, run a short
window (``--seconds``; 0 runs one call, and a check that judges a call
drawn from the first two needs two) and judge it: the program's
readings. With ``--control``, also the control's readings: the same
comparisons with the plain reference computed in the precision next below
the configuration's (TF32 for IEEE fp32) in the program's place. A limit
lies above the program's readings and below the control's. One JSON object
a seed goes to ``--out`` (and standard output).
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    sys.path.insert(1, str(ROOT))
    import torch

    import harness
    if not torch.cuda.is_available():
        print("calibration needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(cell, seed, args.seconds, False,
                          torch.device("cuda", 0))
        run.tmp = harness.new_tmp()
        t0 = time.perf_counter()
        try:
            out = harness.execute(run, ROOT, t0)
            rec = {"workload": cell.name, "seed": seed, "calls": run.calls,
                   "call_s": run.window_s / max(run.calls, 1),
                   "setup_s": run.setup_s, "judge_s": run.judge_s,
                   "program": {k: v["value"]
                               for k, v in out["checks"].items()}}
            for c in run.checks:
                rec.setdefault("notes", {}).update(getattr(c, "notes", {}))
            if args.control:
                t1 = time.perf_counter()
                rec["control"] = {}
                for c in run.checks:
                    rec["control"].update(c.control())
                rec["control_s"] = time.perf_counter() - t1
                for c in run.checks:
                    rec["notes"].update(getattr(c, "notes", {}))
        finally:
            harness.cleanup(run.tmp)
            del run
            torch.cuda.empty_cache()
        rec["wall_s"] = time.perf_counter() - t0
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
