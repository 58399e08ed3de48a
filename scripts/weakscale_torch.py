#!/usr/bin/env python
"""Weak-scaling harness on the PyTorch/CUDA port (eagleeverything_tpu_torch):
the port of scripts/weakscale.py.

Each point N holds the per-process shard fixed: a packed store of
N · p_local SNPs in N shards, scanned by N processes of the port's
process group (utils/distributed, the EAGLE_* variables), with
MultiHostTiledScan for N > 1 and TiledScan for N = 1. Every point times
the JAX script's phases under its keys:

  (c) compute_K with its f64 all-reduce                  mmt_s
  (a) sweep_eig with the O(p) statistic gather           sweep_eig_s
  (b) kernel_matvec at r = 16 with its all-reduce: K3,   matvec_s
      i.e. K1 then K2, on every rank's stack
  (e) matfree_stat_rows at 1 + 8 + 16 columns: K1,       statrows_s
      with its gather
  (d) the host blocked CG against the device CG          cg_host_s,
                                                          cg_device_s

and each phase's collective alone (``*_collective_s``, ``sweep_gather_s``),
then reports, over ``--rounds`` paired repeats of every point, the
median time, the efficiency t(1)/t(N) with its range, and the collective
fraction. Rank 0 also counts the K1/K2 launches of (b) and (e).

Two modes (the card unless ``--device cpu`` is given):

  --device cpu   the JAX script's own setup: gloo, one torch thread and
                 one core a process (taskset). Rows with N > cores
                 timeshare the compute and are flagged.
  --device cuda  one process a card on NCCL ("cpu:gloo,cuda:nccl") for
                 N <= torch.cuda.device_count(). Points beyond the card
                 count run only with --share-card: their ranks share one
                 card over plain gloo (NCCL refuses two ranks on one
                 device) and the row is flagged "shared_card": true. Such
                 a row measures correctness and the transport's cost, not
                 scaling.

The report names the device (on a card: its name and power limit as
nvidia-smi gives them).

Usage: python scripts/weakscale_torch.py [--device cuda|cpu] [--quick]
       [--share-card] [--out weakscale.json] [--procs 1,2,4,8] [--n 512]
       [--p-local 16384] [--reps 5] [--rounds 5] [--dir DIR]

``--dir`` keeps the stores and each point's arrays (rank 0's K·V and the
gathered stat rows, ``ws_<N>_r<round>.npz``) there; without it they live
in a temporary directory that is removed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

PHASES = (("sweep_eig", "sweep_gather_s"),
          ("matvec", "matvec_collective_s"),
          ("mmt", "mmt_collective_s"),
          ("statrows", "statrows_collective_s"))


def worker() -> int:
    """One rank of a point (``--worker``; the WS_* and EAGLE_* variables
    say which). Rank 0 writes the point's JSON to $WS_OUT."""
    import torch
    from eagleeverything_tpu_torch.models import bigscan, engine_torch
    from eagleeverything_tpu_torch.ops import packed
    from eagleeverything_tpu_torch.utils import distributed
    from eagleeverything_tpu_torch.utils.config import EagleConfig

    mode = os.environ["WS_DEVICE"]
    if mode == "cpu":
        # one compute thread a process, so that each rank's compute is a
        # constant and the efficiency isolates the collectives
        torch.set_num_threads(1)
    nproc = int(os.environ["EAGLE_NUM_PROCS"])
    if nproc > 1:
        distributed.initialize(os.environ["EAGLE_COORD_ADDR"], nproc,
                               int(os.environ["EAGLE_PROC_ID"]),
                               backend=os.environ["WS_BACKEND"] or None)
    dev = (distributed.local_device() if mode == "cuda"
           else torch.device("cpu"))
    rank = distributed.process_index()
    n = int(os.environ["WS_N"])
    reps = int(os.environ["WS_REPS"])
    src = engine_torch.StoreTileSource(os.environ["WS_STORE"])
    cfg = EagleConfig()
    backend = (engine_torch.MultiHostTiledScan(src, cfg, dev) if nproc > 1
               else engine_torch.TiledScan(src, cfg, dev))
    p_glob = getattr(backend, "p_global", src.p)
    rng = np.random.default_rng(0)

    def med(f, k=reps):
        ts = []
        for _ in range(k):
            t0 = time.perf_counter()
            f()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    def launches(f) -> dict:
        packed.reset_launches()
        f()
        return dict(packed.LAUNCHES)

    out = {"launches": {}}

    # (c) MMt formation: local accumulate + n² all-reduce
    t0 = time.perf_counter()
    K = backend.compute_K()
    out["mmt_s"] = time.perf_counter() - t0
    out["mmt_collective_s"] = (
        med(lambda: distributed.allreduce_sum_f64(K)) if nproc > 1 else 0.0)

    # (a) eigenbasis sweep: local T sweep + O(p) gather
    d, U = np.linalg.eigh(engine_torch.normalized_kernel(K))
    backend.set_eigenbasis(np.ascontiguousarray(U))
    qmax = 8
    s = 1.0 / np.sqrt(np.maximum(d, 0) + 1.0)
    Q = np.linalg.qr(rng.standard_normal((n, qmax)))[0]
    z3 = rng.standard_normal(n)
    backend.sweep_eig(s, Q, z3, 1.0)   # builds the T cache
    out["sweep_eig_s"] = med(lambda: backend.sweep_eig(s, Q, z3, 1.0))
    if nproc > 1:
        t_l = np.zeros(backend.src.p)
        out["sweep_gather_s"] = med(lambda: backend._gather_rows(t_l))
    else:
        out["sweep_gather_s"] = 0.0

    # (b) matrix-free kernel matvec (K3 = K1 then K2 on the rank's stack)
    # + the (n, r) all-reduce
    V = rng.standard_normal((n, 16))
    out["launches"]["matvec"] = launches(lambda: backend.kernel_matvec(V))
    out["matvec_s"] = med(lambda: backend.kernel_matvec(V))
    KV = backend.kernel_matvec(V)
    out["matvec_collective_s"] = (
        med(lambda: distributed.allreduce_sum_f64(KV)) if nproc > 1 else 0.0)

    # (e) matrix-free stat-rows pass (K1 at 1 + 8 + 16 columns): local,
    # its only cross-rank cost the O(p) statistic gather
    A_sr = np.ascontiguousarray(rng.standard_normal((n, 1 + 8 + 16)))
    Minv_sr = np.eye(8)
    out["launches"]["statrows"] = launches(
        lambda: backend.matfree_stat_rows(A_sr, 8, Minv_sr))
    out["statrows_s"] = med(
        lambda: backend.matfree_stat_rows(A_sr, 8, Minv_sr))
    rows = backend.matfree_stat_rows(A_sr, 8, Minv_sr)
    rows = np.column_stack([rows[0], rows[1], rows[2], rows[3]])
    if nproc > 1:
        te_l = np.zeros(backend.src.p)
        out["statrows_collective_s"] = med(lambda: (
            distributed.allgather_concat_f64(te_l, backend.local_sizes)))
        rows = distributed.allgather_concat_f64(rows, backend.local_sizes)
    else:
        out["statrows_collective_s"] = 0.0

    out["payload_bytes"] = {
        "mmt": n * n * 8, "matvec": n * 16 * 8,
        "sweep_eig": int(p_glob * 8), "statrows": int(p_glob * 8)}

    # (d) a whole CG solve: the host blocked CG (one f64 all-reduce an
    # iteration) against the device CG (one device all-reduce a step)
    B = rng.standard_normal((n, 8))
    s0 = float(np.mean(np.diag(K)))

    def host_cg():
        return bigscan.blocked_cg(
            lambda X: backend.kernel_matvec(X) / s0 + 0.5 * X, B, tol=1e-6)

    host_cg()
    out["cg_host_s"] = med(host_cg, k=max(2, reps // 2))
    backend.device_cg(B, 0.5, s0, tol=1e-6)
    out["cg_device_s"] = med(lambda: backend.device_cg(B, 0.5, s0, tol=1e-6),
                             k=max(2, reps // 2))

    out["p_local"] = backend.src.p
    out["p_global"] = p_glob
    out["device"] = str(dev)
    if rank == 0:
        with open(os.environ["WS_OUT"], "w") as f:
            json.dump(out, f)
        if os.environ.get("WS_ARRAYS"):
            np.savez(os.environ["WS_ARRAYS"], KV=KV, statrows=rows, V=V,
                     A=A_sr)
    distributed.shutdown()
    print("worker", rank, "done", flush=True)
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_store(tmp: str, nproc: int, n: int, p_local: int) -> str:
    """The point's store: N · p_local SNPs of uniform genotypes (seed 7),
    packed in N shards."""
    from eagleeverything_tpu_torch.io.genostore import GenotypeStore
    store = os.path.join(tmp, f"store_{nproc}")
    if not os.path.isdir(store):
        rng = np.random.default_rng(7)
        geno = rng.integers(0, 3, size=(n, p_local * nproc), dtype=np.int8)
        GenotypeStore.create_from_dense(store, geno, n_shards=nproc,
                                        packed=True)
    return store


def run_point(nproc: int, n: int, p_local: int, reps: int, tmp: str,
              device: str, backend: str, arrays: str = "",
              timeout: float = 900.0) -> dict:
    """One weak-scaling point: ``nproc`` ranks of :func:`worker` on a
    store of nproc · p_local SNPs. Every rank is killed when one fails or
    the deadline passes."""
    store = make_store(tmp, nproc, n, p_local)
    out_file = os.path.join(tmp, f"ws_{nproc}.json")
    port = _free_port()
    ncores = os.cpu_count() or 1
    procs, logs = [], []
    try:
        for pid in range(nproc):
            env = dict(os.environ, PYTHONPATH=REPO,
                       EAGLE_COORD_ADDR=f"127.0.0.1:{port}",
                       EAGLE_NUM_PROCS=str(nproc), EAGLE_PROC_ID=str(pid),
                       WS_N=str(n), WS_P_LOCAL=str(p_local),
                       WS_REPS=str(reps), WS_STORE=store, WS_OUT=out_file,
                       WS_DEVICE=device, WS_BACKEND=backend,
                       WS_ARRAYS=arrays)
            argv = [sys.executable, os.path.abspath(__file__), "--worker"]
            if device == "cpu":
                env.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
                           MKL_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
                # one core a rank, so that N = 1 cannot spread over the
                # machine while N > 1 shares it
                if shutil.which("taskset"):
                    argv = ["taskset", "-c", str(pid % ncores)] + argv
            logs.append(tempfile.TemporaryFile(mode="w+"))
            procs.append(subprocess.Popen(argv, env=env, cwd=REPO,
                                          stdout=logs[-1],
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(pr.poll() is None for pr in procs):
            if (any(pr.poll() not in (None, 0) for pr in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.05)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.send_signal(signal.SIGKILL)
            pr.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    for pid, pr in enumerate(procs):
        if pr.returncode != 0:
            raise RuntimeError(f"rank {pid} of N={nproc} failed "
                               f"(rc {pr.returncode}):\n"
                               + texts[pid][-3000:])
    with open(out_file) as f:
        return json.load(f)


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def report(rounds: list[dict], procs: list[int], args, ncores: int,
           device: str, shared: dict) -> dict:
    """The JAX script's report over the paired rounds, with the device and
    each point's shared-card flag."""
    rep = {"n": args.n, "p_local": args.p_local, "ncores": ncores,
           "rounds": args.rounds, "mode": args.device, "device": device,
           "points": {}, "note": (
               "Each row's efficiency is t(1)/t(N) at a fixed shard a "
               "process, paired a round; the collective fraction is the "
               "collective's time alone over the phase's. On the CPU the "
               "ranks talk over gloo on localhost, one core each; rows "
               "with N > ncores timeshare the compute. On cards, a row "
               "flagged shared_card puts its ranks on one card over gloo: "
               "it measures correctness and the transport's cost, not "
               "scaling.")}
    hdr = (f"{'N':>3} {'phase':<10} {'t(N) med s':>11} {'eff med':>8} "
           f"{'eff range':>13} {'coll% med':>10} {'oversub':>8} "
           f"{'shared':>7}")
    print("\n" + hdr)
    print("-" * len(hdr))
    for nproc in procs:
        pt = {}
        for phase, coll_key in PHASES:
            key = f"{phase}_s"
            tns = np.array([r[nproc][key] for r in rounds], float)
            effs = np.array([r[procs[0]][key] / r[nproc][key]
                             for r in rounds if r[nproc][key] > 0])
            fracs = np.array([r[nproc].get(coll_key, 0.0) / r[nproc][key]
                              for r in rounds if r[nproc][key] > 0])
            over = args.device == "cpu" and nproc > ncores
            print(f"{nproc:>3} {phase:<10} {np.median(tns):>11.4f} "
                  f"{np.median(effs):>8.2f} "
                  f"{effs.min():>6.2f}..{effs.max():<5.2f} "
                  f"{100 * np.median(fracs):>9.1f}% "
                  f"{'yes' if over else 'no':>8} "
                  f"{'yes' if shared[nproc] else 'no':>7}")
            pt[phase] = {
                "t_s_median": float(np.median(tns)),
                "t_s_range": [float(tns.min()), float(tns.max())],
                "efficiency_median": round(float(np.median(effs)), 4),
                "efficiency_range": [round(float(effs.min()), 4),
                                     round(float(effs.max()), 4)],
                "collective_fraction_median": round(
                    float(np.median(fracs)), 4),
                "tpu_efficiency_lower_bound": round(
                    1.0 - float(np.median(fracs)), 4),
                "oversubscribed": over,
            }
        cgh = [r[nproc].get("cg_host_s") for r in rounds]
        cgd = [r[nproc].get("cg_device_s") for r in rounds]
        pt["cg_host_s_median"] = (float(np.median([x for x in cgh if x]))
                                  if any(cgh) else None)
        pt["cg_device_s_median"] = (float(np.median([x for x in cgd if x]))
                                    if any(cgd) else None)
        pt["collective_payload_bytes"] = rounds[0][nproc].get(
            "payload_bytes")
        pt["shared_card"] = shared[nproc]
        pt["launches"] = rounds[0][nproc]["launches"]
        rep["points"][nproc] = pt
    return rep


def main() -> None:
    if sys.argv[1:] == ["--worker"]:
        sys.exit(worker())
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--share-card", action="store_true",
                    help="on cards, run the points beyond the card count "
                         "with their ranks on one card over gloo")
    ap.add_argument("--procs", default="1,2,4,8")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--p-local", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=5,
                    help="independent repeats of every point; the "
                         "efficiencies are paired a round, reported as "
                         "the median with its min..max range")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--dir", default=None,
                    help="keep the stores and each point's arrays here")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a point may take")
    args = ap.parse_args()
    if args.quick:
        args.n, args.p_local, args.reps = 128, 2048, 3
        args.procs = "1,2"
        args.rounds = 2 if args.rounds == ap.get_default("rounds") \
            else args.rounds
    procs = [int(x) for x in args.procs.split(",")]
    ncores = os.cpu_count() or 1

    shared, backend = {}, {}
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available; pass --device cpu")
        cards = torch.cuda.device_count()
        device = _card()
        for nproc in procs:
            shared[nproc] = nproc > cards
            if shared[nproc] and not args.share_card:
                raise SystemExit(f"N={nproc} needs {nproc} cards, this "
                                 f"machine has {cards}; pass --share-card "
                                 "to run its ranks on one card (no "
                                 "scaling measurement)")
            backend[nproc] = "gloo" if shared[nproc] else ""
    else:
        device = "cpu"
        shared = {nproc: False for nproc in procs}
        backend = {nproc: "gloo" for nproc in procs}

    rounds: list[dict] = []
    tmp = args.dir or tempfile.mkdtemp(prefix="eagle_ws_")
    os.makedirs(tmp, exist_ok=True)
    try:
        for rd in range(args.rounds):
            results = {}
            for nproc in procs:
                print(f"[weakscale] round {rd + 1}/{args.rounds} "
                      f"N={nproc} (p_global={nproc * args.p_local}) ...",
                      flush=True)
                arrays = (os.path.join(tmp, f"ws_{nproc}_r{rd}.npz")
                          if args.dir else "")
                results[nproc] = run_point(
                    nproc, args.n, args.p_local, args.reps, tmp,
                    args.device, backend[nproc], arrays, args.timeout)
            rounds.append(results)
    finally:
        if not args.dir:
            shutil.rmtree(tmp, ignore_errors=True)

    rep = report(rounds, procs, args, ncores, device, shared)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)
        print(f"\n[weakscale] wrote {args.out}")
    print(json.dumps({"device": device, "mode": args.device,
                      "points": {str(k): {"shared_card": v["shared_card"],
                                          "launches": v["launches"]}
                                 for k, v in rep["points"].items()}}),
          flush=True)


if __name__ == "__main__":
    main()
