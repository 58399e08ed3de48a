#!/usr/bin/env python3
"""Time the port's main path for two checkouts of the repo, in turns on one
card: A, B, B, A.

    python3 scripts/ab_main_path.py --a DIR --b DIR [--p 262144] [--seed 7]

Each run is a process of its own that imports the port and ``chip_smoke.py``
from its checkout, builds that checkout's kernels (into its own
``build/torch_kernels/``) and runs ``chip_smoke.main_path_phase``:
``am(engine="auto")`` on a cohort of 50 000 × p generated on the card from
``--seed``, checked to select only planted QTL. The script prints the card
(``nvidia-smi`` name and power limit), one JSON line per run (the scan log's
phase times in order, ``am()`` wall, launches, selection) and a mean per
checkout of the ``am()`` wall and of each phase kind. It needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

CHILD = r"""
import json, os, sys, tempfile
root, p, seed = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
sys.path.insert(0, root)
import torch
import chip_smoke
import eagleeverything_tpu_torch as ep
from eagleeverything_tpu_torch.ops import build, packed
assert os.path.abspath(packed.__file__).startswith(os.path.abspath(root))
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build_all()
os.makedirs(os.path.join(root, "build"), exist_ok=True)
with tempfile.TemporaryDirectory(dir=os.path.join(root, "build"),
                                 prefix="ab_") as tmp:
    res = chip_smoke.main_path_phase(torch, ep, packed, tmp, chip_smoke.N,
                                     p, seed, torch.device("cuda"))
print("RESULT " + json.dumps({k: res[k] for k in
                              ("wall_s", "launches", "indices")}))
"""

PHASE = re.compile(r"^\s+phase (\w+)\s+([\d.]+) s$")


def run_one(root: str, p: int, seed: int) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, root, str(p),
                           str(seed)], capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stdout.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"the run of {root} failed ({proc.returncode})")
    phases = [(m.group(1), float(m.group(2)))
              for m in map(PHASE.match, proc.stdout.splitlines()) if m]
    result = next(json.loads(ln[len("RESULT "):])
                  for ln in proc.stdout.splitlines()
                  if ln.startswith("RESULT "))
    return {"phases": phases, **result}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", required=True, help="checkout A (the parent)")
    ap.add_argument("--b", required=True, help="checkout B (the change)")
    ap.add_argument("--p", type=int, default=262144)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    runs = []
    for label, root in (("A", args.a), ("B", args.b), ("B", args.b),
                        ("A", args.a)):
        r = run_one(os.path.abspath(root), args.p, args.seed)
        r.update(label=label, root=root)
        runs.append(r)
        print(json.dumps(r), flush=True)
    for label in ("A", "B"):
        mine = [r for r in runs if r["label"] == label]
        kinds: dict[str, list[float]] = {}
        for r in mine:
            for kind in {k for k, _ in r["phases"]}:
                kinds.setdefault(kind, []).append(
                    sum(s for k, s in r["phases"] if k == kind))
        wall = sum(r["wall_s"] for r in mine) / len(mine)
        print(f"{label} ({mine[0]['root']}): am() wall {wall:.2f} s mean; "
              + ", ".join(f"{k} {sum(v) / len(v):.2f} s" for k, v
                          in sorted(kinds.items())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
