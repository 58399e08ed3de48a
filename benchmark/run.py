#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the machine it is started on.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Set-up draws the cell's cohort on the card from
``--seed`` and hands it to the program; the window then runs whole calls of
the program's entry, back to back, until the first call that ends after
``--seconds``. With ``--trace 0`` the result carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read under
``torch.profiler``. Each run judges what its window produced against the
plain reference, prints each number compared beside its limit as the last
lines of standard error, and prints one JSON object as the last line of
standard output. It exits non-zero, printing no result, without enough
CUDA cards, outside a checkout that holds the program, or when JAX or the
JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only a checkout's first run builds."""
    cache = ROOT / "build" / "bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, str(BENCH))
    sys.path.insert(1, str(ROOT))
    import harness

    try:
        cell = harness.load_cell(args.workload, ROOT)
        import torch
        if not torch.cuda.is_available():
            raise harness.Refused("CUDA is not available")
        if torch.cuda.device_count() < cell.chips:
            raise harness.Refused(f"{cell.name} needs {cell.chips} cards, "
                                  f"{torch.cuda.device_count()} visible")
        run = harness.Run(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0))
        run.tmp = harness.new_tmp()
        try:
            out = harness.execute(run, ROOT, T_START)
        finally:
            harness.cleanup(run.tmp)
        found = harness.forbidden_modules()
        if found:
            raise harness.Refused("loaded once the window closed: "
                                  + ", ".join(found))
    except harness.Refused as e:
        print(f"benchmark refused: {e}", file=sys.stderr)
        return 2
    line = harness.result_line(run, out)
    print(json.dumps({"setup_s": run.setup_s, "window_s": run.window_s,
                      "calls": run.calls, "call_walls": run.call_walls,
                      "build": run.build, "setup_parts": run.setup_parts,
                      "judge_s": run.judge_s},
                     separators=(",", ":")), file=sys.stderr)
    print(json.dumps(line, separators=(",", ":")))
    sys.stdout.flush()
    print(harness.describe(line), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
