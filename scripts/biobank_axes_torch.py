#!/usr/bin/env python
"""BASELINE config 4 ("500k x 5M") along each of its two axes at its true
size, on the PyTorch/CUDA port (eagleeverything_tpu_torch), one process on
one card.

  --axis n   500 000 individuals x 32 768 SNPs, a 2-shard packed store
             (4.10 GB as the card's packed stack): the matrix-free scan
             (models/bigscan.forward_select_matfree over
             engine_torch.TiledScan, the K1/K2 kernels) with the Krylov
             protocol of the recorded run, at the n where an f64 n-vector
             is 4 MB.
  --axis p   2 048 individuals x 5 000 000 SNPs: a 10.24 GB no-space ASCII
             genotype file through the native ingest into a 4-shard packed
             store (2.56 GB), then one full matrix-free stat sweep over all
             5 M SNPs and its argmax. ``--store-only`` packs the same draws
             straight into the store and writes no text.

Both cohorts are the JAX package's (scripts/biobank_axes.py): the same
seeds, the same numpy draws in the same order, the same shard bytes,
manifests, traits and meta files, so a run here is held against the
answers recorded in docs/biobank_axis_{n,p}_result.json. Disk: 4.1 GB for
the n axis; 10.24 GB of text plus the 2.56 GB store for the p axis.

Usage (from the root of a checkout; CUDA unless ``--device cpu``):

  python scripts/biobank_axes_torch.py --axis n --gen --run [--maxit 6]
         [--entry engine|am] [--split]
  python scripts/biobank_axes_torch.py --axis p --gen --run [--store-only]

``--dir`` (default build/biobank in the checkout) holds the cohorts; each
run writes its result JSON to ``--out`` (default
<dir>/biobank_axis_{n,p}_result.json). ``--n``/``--p`` shrink an axis.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

BASE = os.path.join(REPO, "build", "biobank")

N_AXIS = dict(n=500_000, p=32_768, n_qtl=6, seed=11)
P_AXIS = dict(n=2_048, p=5_000_000, n_qtl=4, seed=12)
# the recorded n-axis run's Krylov protocol (docs/biobank_axis_n_result.json)
N_PROTOCOL = dict(probes=8, lanczos_m=12, diag_probes=16, exact_topk=2,
                  solve_m=24, solve_m_refit=16, cache_max_bytes=8 << 30,
                  cg_tol=1e-6, cg_maxiter=100)
# the p-axis sweep (the JAX script's defaults)
P_CONTEXT = dict(probes=16, lanczos_m=24)
P_SWEEP = dict(diag_probes=32, exact_topk=8)
N_BLOCK = 512   # SNPs an n-axis generator block


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _where(device: torch.device) -> str:
    return card() if device.type == "cuda" else "cpu"


def axis_config(**fields):
    """The runs' EagleConfig: the recorded runs' device_cache_gb of 8.0,
    plus ``fields``."""
    from eagleeverything_tpu_torch.utils.config import EagleConfig
    return EagleConfig(device_cache_gb=8.0, **fields)


def protocol_config():
    """axis_config with EagleConfig's matrix-free fields set to
    N_PROTOCOL, so that the stack gate reckons the Krylov state this
    protocol holds (and ``am()`` runs it, but for its CG tolerance)."""
    pr = N_PROTOCOL
    return axis_config(
        matfree_probes=pr["probes"], matfree_lanczos_m=pr["lanczos_m"],
        matfree_diag_probes=pr["diag_probes"],
        matfree_exact_topk=pr["exact_topk"], matfree_solve_m=pr["solve_m"],
        matfree_solve_m_refit=pr["solve_m_refit"],
        matfree_cache_gb=pr["cache_max_bytes"] / 1e9)


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------


# 64-bit words a thread of raw_words draws at least
RAW_PART_WORDS = 1 << 22


def raw_words(bg, out: np.ndarray) -> None:
    """Fill ``out`` (uint32, even length 2k) with ``bg.random_raw(k)``'s
    words, low half first, drawn by up to eight threads, each from a copy
    of the bit generator advanced to its part (PCG64 fills, and numpy
    copies, without the interpreter lock); ``bg`` ends advanced past all
    k words, which clears its kept 32-bit half. A bit generator without
    ``advance`` draws them alone."""
    k = out.size // 2
    parts = min(os.cpu_count() or 1, 8, k // RAW_PART_WORDS)
    if parts < 2 or not hasattr(bg, "advance"):
        out[:] = bg.random_raw(k).view(np.uint32)
        return
    cut = [k * i // parts for i in range(parts + 1)]
    state = bg.state

    def fill(i: int) -> None:
        g = type(bg)()
        g.state = state
        g.advance(cut[i])
        out[2 * cut[i] : 2 * cut[i + 1]] = g.random_raw(
            cut[i + 1] - cut[i]).view(np.uint32)

    with ThreadPoolExecutor(parts) as pool:
        list(pool.map(fill, range(parts)))
    bg.advance(k)


def uint16_draws(rng: np.random.Generator, count: int) -> np.ndarray:
    """``rng.integers(0, 65536, size=count, dtype=np.uint16)``: the same
    values, and the same generator state after it, from the bit
    generator's raw 64-bit words. numpy fills a full-range uint16 draw two
    values a 32-bit draw, low half first, and PCG64 hands each 64-bit word
    out as two 32-bit draws, low half first, keeping the high half for the
    next (``has_uint32``/``uinteger`` in its state). So the values are the
    raw words' little-endian 16-bit pieces, behind a kept half if there is
    one, the words drawn by several threads (:func:`raw_words`): many times
    faster than the draw itself."""
    bg = rng.bit_generator
    st = bg.state
    need = (count + 1) // 2          # 32-bit draws the fill takes
    words = np.empty(need, dtype=np.uint32)
    # after the fill: whether a high half is kept, and the last word's
    # high half (numpy leaves it in ``uinteger`` once it is handed out)
    has, high = st["has_uint32"], st["uinteger"]
    lead = 1 if has and need else 0
    if lead:
        has = 0
        words[0] = high
    k = (need - lead) // 2
    raw_words(bg, words[lead : lead + 2 * k])
    if k:
        high = int(words[lead + 2 * k - 1])
    if (need - lead) % 2:
        last = bg.random_raw(1).view(np.uint32)
        words[-1] = last[0]
        has, high = 1, int(last[1])
    st = bg.state
    st["has_uint32"], st["uinteger"] = has, high
    bg.state = st
    return words.view("<u2")[:count]


def _set_after(bg, state: dict, stream: np.ndarray, lead: int,
               c: int) -> None:
    """Leave ``bg`` where numpy leaves it after ``c`` 32-bit draws from
    ``state``, whose draws are ``stream`` (the kept half first when
    ``lead``): the kept half, then whole 64-bit words, the last one's
    high half kept when an odd count remains; ``uinteger`` holds the last
    high half handed out or kept."""
    has, high = state["has_uint32"], state["uinteger"]
    if lead and c:
        has, c = 0, c - 1
    w, odd = divmod(c, 2)
    bg.state = state
    if w + odd:
        bg.advance(w + odd)
    if w:
        high = int(stream[lead + 2 * w - 1])
    if odd:
        has, high = 1, int(stream[lead + 2 * w + 1])
    st = bg.state
    st["has_uint32"], st["uinteger"] = has, high
    bg.state = st


def ternary_rows(rng: np.random.Generator, rows: int, p: int,
                 device="cpu", batch_bytes: int = 1 << 28):
    """``rng.integers(0, 3, size=p, dtype=np.uint8)`` ``rows`` times in a
    row: yields the same rows (uint8 numpy arrays) and leaves the
    generator where numpy leaves it. numpy reads each value off one byte
    of its 32-bit draws, low byte first, a row starting on a fresh 32-bit
    draw: a byte b gives (3·b) >> 8, and b = 0 is rejected (Lemire's method
    for a range of 3, whose threshold is 1). So a batch of rows is one
    long stream of 32-bit draws, taken from raw words by several threads
    (:func:`raw_words`) from a copy of the generator, and each row's
    bytes are scanned on ``device``: its p-th accepted byte says where the
    next row starts."""
    bg = rng.bit_generator
    dev = torch.device(device)
    # 32-bit draws a row may take: its p bytes, the rejected ones (b = 0,
    # 1 in 256: p/256 expected; a margin of twice that and 64 more)
    span = -(-(p + p // 128 + 64) // 4)
    done = 0
    while done < rows:
        state = bg.state
        lead = 1 if state["has_uint32"] else 0
        batch = max(1, min(rows - done, batch_bytes // (4 * span)))
        k = (batch * span + 1) // 2
        stream = np.empty(lead + 2 * k, dtype=np.uint32)
        if lead:
            stream[0] = state["uinteger"]
        g = type(bg)()
        g.state = state
        raw_words(g, stream[lead:])
        b = torch.from_numpy(stream.view(np.uint8)).to(dev)
        s = 0                        # 32-bit draws this batch has used
        while done < rows and 4 * (s + span) <= b.numel():
            region = b[4 * s : 4 * (s + span)]
            ok = region != 0
            last = int(torch.searchsorted(torch.cumsum(ok, 0, dtype=torch.int32),
                                          p))
            if last >= region.numel():
                raise RuntimeError("a row rejected more bytes than its margin")
            vals = region[: last + 1][ok[: last + 1]].to(torch.int32)
            yield ((vals * 3) >> 8).to(torch.uint8).cpu().numpy()
            s += last // 4 + 1
            done += 1
        _set_after(bg, state, stream, lead, s)


def _check_draws(rng: np.random.Generator, device="cpu") -> None:
    """Hold :func:`uint16_draws` and :func:`ternary_rows` to numpy's own
    draws on copies of ``rng`` (odd and even counts, values and states),
    so that a numpy whose fill differs stops the run before it writes
    another cohort."""
    a = np.random.Generator(type(rng.bit_generator)())
    b = np.random.Generator(type(rng.bit_generator)())
    a.bit_generator.state = b.bit_generator.state = rng.bit_generator.state
    for count in (1001, 1000):
        want = a.integers(0, 65536, size=count, dtype=np.uint16)
        got = uint16_draws(b, count)
        if not (np.array_equal(want, got)
                and a.bit_generator.state == b.bit_generator.state):
            raise RuntimeError("uint16_draws differs from numpy's "
                               "integers(0, 65536, dtype=uint16)")
    want = [a.integers(0, 3, size=1001, dtype=np.uint8) for _ in range(3)]
    got = list(ternary_rows(b, 3, 1001, device))
    if not (all(np.array_equal(x, y) for x, y in zip(want, got))
            and a.bit_generator.state == b.bit_generator.state):
        raise RuntimeError("ternary_rows differs from numpy's "
                           "integers(0, 3, dtype=uint8)")


# ---------------------------------------------------------------------------
# axis n: 500 000 individuals x 32 768 SNPs
# ---------------------------------------------------------------------------


def gen_n(dir: str, n_override: int = 0, p_override: int = 0,
          split: bool = False, device="cpu") -> dict:
    """The n-axis cohort: ``<dir>/store_full`` (2 packed shards and the
    manifest), ``y_n.npy`` and ``meta_n.json``, the JAX script's bytes.
    Each 512-SNP block is drawn on the host (:func:`uint16_draws`) and
    turned into genotypes and packed on ``device``. ``split`` moves each
    shard, with a copy of the manifest, into ``<dir>/proc{0,1}`` as the
    JAX script does for its two processes. Returns the timings."""
    from eagleeverything_tpu_torch.io.genostore import GenotypeStore

    dev = torch.device(device)
    n = n_override or N_AXIS["n"]
    p = p_override or N_AXIS["p"]
    n_qtl, seed = N_AXIS["n_qtl"], N_AXIS["seed"]
    os.makedirs(dir, exist_ok=True)
    full = os.path.join(dir, "store_full")
    rng = np.random.default_rng(seed)
    qtl_idx = np.sort(rng.choice(N_BLOCK, size=n_qtl, replace=False))
    _check_draws(rng)
    qtl_cols = {}
    draw_s = [0.0]

    def blocks():
        t0 = time.perf_counter()
        for j0 in range(0, p, N_BLOCK):
            b = min(N_BLOCK, p - j0)
            td = time.perf_counter()
            maf = rng.uniform(0.05, 0.5, size=(b, 1))
            t_hom = np.rint(65536.0 * maf**2).astype(np.uint16)
            t_het = np.rint(65536.0 * (maf**2 + 2 * maf * (1 - maf))
                            ).astype(np.uint16)
            u = uint16_draws(rng, b * n)
            draw_s[0] += time.perf_counter() - td
            # u < t on the device, as int32 (0..65535)
            ud = torch.from_numpy(u.view(np.int16)).to(dev).view(b, n)
            ud = ud.to(torch.int32) & 0xFFFF
            hom = torch.from_numpy(t_hom.astype(np.int32)).to(dev)
            het = torch.from_numpy(t_het.astype(np.int32)).to(dev)
            blk = (ud < hom).to(torch.int8) + (ud < het).to(torch.int8)
            del ud
            if j0 == 0:
                for q in qtl_idx:
                    qtl_cols[int(q)] = blk[q].cpu().numpy().astype(
                        np.float64)
            if (j0 // N_BLOCK) % 16 == 0:
                print(f"[gen-n] {j0 + b}/{p} SNPs "
                      f"({time.perf_counter() - t0:.0f}s)", flush=True)
            yield j0, blk

    t0 = time.perf_counter()
    GenotypeStore.create_from_snp_blocks(
        full, blocks(), n=n, p=p, n_shards=2, packed=True,
        source=f"biobank-n-axis-seed{seed}")
    gen_s = time.perf_counter() - t0

    beta = rng.normal(0, 1.0, size=n_qtl) * np.sqrt(0.5 / n_qtl)
    g = sum(beta[i] * (qtl_cols[int(q)] - qtl_cols[int(q)].mean())
            for i, q in enumerate(qtl_idx))
    y = g + rng.normal(0, np.sqrt(max(1e-6, 1.0 - float(np.var(g)))), size=n)
    np.save(os.path.join(dir, "y_n.npy"), y)
    if split:
        for pid in (0, 1):
            d = os.path.join(dir, f"proc{pid}")
            os.makedirs(d, exist_ok=True)
            shutil.copy(os.path.join(full, "manifest.json"), d)
            shutil.move(os.path.join(full, f"shard_{pid:05d}.bin"),
                        os.path.join(d, f"shard_{pid:05d}.bin"))
    meta = {"axis": "n", **N_AXIS, "n": n, "p": p,
            "qtl_indices": [int(q) for q in qtl_idx],
            "beta": beta.tolist(), "gen_seconds": round(gen_s, 1)}
    with open(os.path.join(dir, "meta_n.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(f"[gen-n] done in {gen_s:.0f}s (draws {draw_s[0]:.0f}s)",
          flush=True)
    return {"gen_s": gen_s, "draw_s": draw_s[0]}


def _read_events(path: str) -> list[dict]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def krylov_cache(n: int, q_max: int, budget: int, protocol: dict) -> dict:
    """Whether the Krylov cache budget binds, at the bytes the scan counts
    against it: the f64 count of the [X y] solve basis at the scan's
    widest X (``q_max`` columns), at the first fit's depth and the
    refits', and the f32 count of the sweep's probe basis as the card
    holds it (MatfreeContext._probe_basis: the n axis has no Zmat, so
    the device Lanczos is always wired); over the budget a basis is
    not cached (the [X y] fit solves by CG at every δ, the probe basis is
    rebuilt at each sweep)."""
    from eagleeverything_tpu_torch.models.bigscan import ShiftedKrylov
    sizes = {
        "solve_basis": ShiftedKrylov.cache_bytes(n, q_max + 1,
                                                 protocol["solve_m"]),
        "refit_basis": ShiftedKrylov.cache_bytes(
            n, q_max + 1, min(protocol["solve_m"],
                              max(protocol["solve_m_refit"], 16))),
        "probe_basis": ShiftedKrylov.device_bytes(n, protocol["diag_probes"],
                                                  protocol["lanczos_m"])}
    return {"budget_bytes": int(budget),
            **{k + "_bytes": int(v) for k, v in sizes.items()},
            **{k + "_binds": bool(v > budget) for k, v in sizes.items()}}


def run_n(dir: str, maxit: int, device="cuda", entry: str = "engine",
          out: str = "", ckpt: str = "", protocol: dict = N_PROTOCOL) -> dict:
    """The n-axis scan on one card: ``entry="engine"`` builds
    engine_torch.TiledScan over the store and calls
    bigscan.forward_select_matfree with ``protocol`` (the recorded run's,
    whose CG tolerance ``am()`` cannot take), checkpointing into
    ``ckpt`` and resuming from it; ``entry="am"`` runs the user's entry
    point, ``am(engine="auto")``, with EagleConfig's matrix-free fields at
    the protocol's values. Writes the result JSON to ``out`` (default
    <dir>/biobank_axis_n_result.json) and returns it."""
    import eagleeverything_tpu_torch as ep
    from eagleeverything_tpu_torch.io.genostore import GenotypeStore
    from eagleeverything_tpu_torch.models import bigscan, engine_torch

    dev = torch.device(device)
    with open(os.path.join(dir, "meta_n.json")) as f:
        meta = json.load(f)
    y = np.load(os.path.join(dir, "y_n.npy"))
    store_dir = os.path.join(dir, "store_full")
    store = GenotypeStore.open(store_dir)
    n, p = store.n, store.p
    if len(y) != n:
        raise ValueError(f"y_n.npy has {len(y)} values, the store {n} "
                         "individuals")
    missing = [k for k in range(store.n_shards) if not os.path.exists(
        os.path.join(store_dir, f"shard_{k:05d}.bin"))]
    if missing:
        raise FileNotFoundError(
            f"{store_dir} lacks shards {missing}: a store split for two "
            "processes (--split) is not read by this one-process run")
    out = out or os.path.join(dir, "biobank_axis_n_result.json")
    ckpt = ckpt or os.path.join(dir, "ckpt_n")
    log = os.path.join(dir, "scan_n.jsonl")
    if os.path.exists(log):
        os.remove(log)
    state_file = os.path.join(ckpt, "scan_state.json")
    ck0 = None
    if entry == "engine" and os.path.exists(state_file):
        with open(state_file) as f:
            ck0 = json.load(f)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    if entry == "engine":
        backend = engine_torch.TiledScan(
            engine_torch.StoreTileSource(store_dir), protocol_config(), dev)
        res = bigscan.forward_select_matfree(
            y, np.ones((n, 1)), backend, maxit=maxit,
            column_f64=backend.column_f64, quiet=False, ckpt_dir=ckpt,
            resume=True, log_jsonl=log, **protocol)
    elif entry == "am":
        handle = ep.GenoHandle(n=n, p=p, source="biobank-n-axis",
                               store_dir=store_dir)
        res = ep.am("y", handle, {"y": y}, maxit=maxit, engine="auto",
                    config=protocol_config(), quiet=False, log_jsonl=log,
                    device=dev)
    else:
        raise ValueError(f"unknown entry {entry!r}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    events = _read_events(log)
    gate = next((e for e in events if e["event"] == "stack"), {})
    qtl = meta["qtl_indices"]
    result = {
        "axis": "n", "n": n, "p": p, "entry": entry,
        "device": _where(dev),
        "selected": [int(j) for j in res.indices],
        "extbic_path": [float(v) for v in res.extbic_path],
        "qtl_planted": qtl,
        "selected_all_planted": all(j in qtl for j in res.indices),
        "escalation_exhausted": res.escalation_exhausted,
        "delta_final": float(res.delta), "sigma2_g": float(res.sigma2_g),
        "sigma2_e": float(res.sigma2_e),
        "wall_seconds": wall,
        "ckpt_dir": ckpt if entry == "engine" else None,
        "resumed_from": ({"selected": ck0.get("selected")}
                         if ck0 else None),
        "stack": gate,
        "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "krylov_cache": krylov_cache(n, 1 + len(res.indices),
                                     protocol["cache_max_bytes"], protocol),
        "iteration_events": [e for e in events if e["event"] == "iteration"],
        "phase_events": [e for e in events if e["event"] == "phase"],
        "stack_passes": next((e for e in events
                              if e["event"] == "stack_passes"), {}),
        "protocol": (f"one process on {_where(dev)}, "
                     + ("bigscan.forward_select_matfree on "
                        "engine_torch.TiledScan " if entry == "engine"
                        else "am(engine='auto') ")
                     + " ".join(f"{k}={v}" for k, v in protocol.items())),
    }
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"[run-n] selected {result['selected']} in {wall:.1f}s; result "
          f"at {out}", flush=True)
    return result


# ---------------------------------------------------------------------------
# axis p: 2 048 individuals x 5 000 000 SNPs
# ---------------------------------------------------------------------------


def gen_p(dir: str, n_override: int = 0, p_override: int = 0,
          store_only: bool = False, device="cpu") -> dict:
    """The p-axis cohort: ``<dir>/geno_p.txt`` (one no-space ASCII row an
    individual, written straight from its uint8 draws as the JAX script
    writes it; the draws are numpy's, read off raw words and scanned on
    ``device`` by :func:`ternary_rows`), ``y_p.npy`` and ``meta_p.json``.
    With ``store_only`` the same rows go into ``<dir>/store_p`` (4 packed
    shards, the bytes the ingest writes from the text; transposed and
    packed on ``device``) and no text is written. Returns the timings."""
    from eagleeverything_tpu_torch.io.genostore import GenotypeStore

    n = n_override or P_AXIS["n"]
    p = p_override or P_AXIS["p"]
    n_qtl, seed = P_AXIS["n_qtl"], P_AXIS["seed"]
    os.makedirs(dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    qtl_idx = np.sort(rng.choice(p, size=n_qtl, replace=False))
    qtl_geno = rng.integers(0, 3, size=(n_qtl, n), dtype=np.uint8)
    _check_draws(rng, device)
    path = os.path.join(dir, "geno_p.txt")
    rows = np.empty((n, p), dtype=np.uint8) if store_only else None
    t0 = time.perf_counter()
    with (contextlib.nullcontext() if store_only
          else open(path, "wb", buffering=1 << 22)) as f:
        for i, row in enumerate(ternary_rows(rng, n, p, device)):
            row[qtl_idx] = qtl_geno[:, i]
            if store_only:
                rows[i] = row
            else:
                f.write((row + ord("0")).tobytes())
                f.write(b"\n")
            if i % 256 == 0:
                print(f"[gen-p] row {i}/{n} "
                      f"({time.perf_counter() - t0:.0f}s)", flush=True)
    write_s = time.perf_counter() - t0
    timings = {"write_s": write_s}
    if store_only:
        t1 = time.perf_counter()
        dev = torch.device(device)
        step = max(1, (1 << 30) // n)

        def blocks():
            for j0 in range(0, p, step):
                blk = torch.from_numpy(rows[:, j0 : j0 + step]).to(dev)
                yield j0, blk.t().contiguous().view(torch.int8)

        GenotypeStore.create_from_snp_blocks(
            os.path.join(dir, "store_p"), blocks(), n=n, p=p, n_shards=4,
            packed=True, source=path)
        timings["store_s"] = time.perf_counter() - t1
        del rows
    beta = rng.normal(0, 1.0, size=n_qtl) * np.sqrt(0.6 / n_qtl)
    W = qtl_geno.astype(np.float64)
    g = sum(beta[i] * (W[i] - W[i].mean()) for i in range(n_qtl))
    y = g + rng.normal(0, np.sqrt(max(1e-6, 1.0 - float(np.var(g)))), size=n)
    np.save(os.path.join(dir, "y_p.npy"), y)
    meta = {"axis": "p", **P_AXIS, "n": n, "p": p,
            "qtl_indices": [int(q) for q in qtl_idx],
            "beta": beta.tolist(),
            "text_bytes": 0 if store_only else os.path.getsize(path),
            "write_seconds": round(write_s, 1)}
    if store_only:
        meta["store_only"] = True
    with open(os.path.join(dir, "meta_p.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(f"[gen-p] {'store' if store_only else 'text'} written in "
          f"{time.perf_counter() - t0:.0f}s", flush=True)
    return timings


def run_p(dir: str, device="cuda", out: str = "") -> tuple[dict, np.ndarray]:
    """The p-axis run: the text through ``read_marker`` (the native
    ingest on every core, 4 packed shards, the JAX script's 16 GB host
    budget) unless ``<dir>/store_p`` holds a store already, then
    engine_torch.TiledScan over it, the REML fit (bigscan.make_context
    with P_CONTEXT, reml_maximize_matfree) and one full matrix-free stat
    sweep (score_sweep_matfree with P_SWEEP) and its argmax, and the
    column reads of :func:`_col_check`. Writes the result JSON to ``out``
    (default <dir>/biobank_axis_p_result.json); returns it and the t
    vector."""
    import eagleeverything_tpu_torch as ep
    from eagleeverything_tpu_torch.models import bigscan, engine_torch

    dev = torch.device(device)
    with open(os.path.join(dir, "meta_p.json")) as f:
        meta = json.load(f)
    y = np.load(os.path.join(dir, "y_p.npy"))
    n, p = meta["n"], meta["p"]
    store = os.path.join(dir, "store_p")

    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(store, "manifest.json")):
        handle = ep.read_marker(os.path.join(dir, "geno_p.txt"), type="text",
                                AA="0", AB="1", BB="2", missing="9",
                                store_dir=store, n_shards=4, packed=True,
                                availmemGb=16.0)
        ingest_s = time.perf_counter() - t0
    else:
        handle = ep.GenoHandle(n=n, p=p, source="<store>", store_dir=store)
        ingest_s = 0.0
    if (handle.n, handle.p) != (n, p):
        raise ValueError(f"the store holds {handle.n} x {handle.p}, "
                         f"meta_p.json says {n} x {p}")

    times = {}
    t1 = time.perf_counter()
    backend = engine_torch.TiledScan(engine_torch.StoreTileSource(store),
                                     axis_config(), dev)
    ctx = bigscan.make_context(backend, n, **P_CONTEXT)
    times["context_s"] = time.perf_counter() - t1
    X0 = np.ones((n, 1))
    t1 = time.perf_counter()
    fit = bigscan.reml_maximize_matfree(ctx, y, X0)
    times["reml_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    t, cand, info = bigscan.score_sweep_matfree(
        ctx, backend, y, X0, fit, column_f64=backend.column_f64, **P_SWEEP)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    sweep_s = time.perf_counter() - t1

    qtl = meta["qtl_indices"]
    text = meta["text_bytes"]
    result = {"axis": "p", "n": n, "p": p, "device": _where(dev),
              "ingest_seconds": ingest_s,
              "text_gb": text / 1e9,
              "ingest_gb_s": (text / ingest_s / 1e9) if ingest_s else None,
              **times,
              "sweep_seconds": sweep_s,
              "snps_per_second_sweep": p / sweep_s,
              "argmax": int(cand), "argmax_is_planted": bool(cand in qtl),
              "qtl_planted": qtl,
              "t_at_planted": [float(t[j]) for j in qtl],
              "t_quantiles": {q: float(np.quantile(t, float(q)))
                              for q in ("0.5", "0.99", "0.999")},
              "escalation": info, "stack": backend.stack_info(),
              "delta": float(fit.delta),
              "column_roundtrip_ok": bool(_col_check(backend, meta))}
    out = out or os.path.join(dir, "biobank_axis_p_result.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result, t


def _col_check(backend, meta) -> bool:
    """Random and QTL column reads at offsets across the whole p: the
    manifest and shard arithmetic must address the right bytes at the
    real p."""
    rng = np.random.default_rng(0)
    p = meta["p"]
    ok = True
    for j in list(meta["qtl_indices"]) + [0, p - 1] + list(
            rng.integers(0, p, size=4)):
        col = backend.column_f64(int(j))
        ok &= col.shape[0] == meta["n"] and np.all(np.isfinite(col))
    return ok


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--axis", choices=["n", "p"], required=True)
    ap.add_argument("--gen", action="store_true")
    ap.add_argument("--run", action="store_true")
    ap.add_argument("--maxit", type=int, default=3)
    ap.add_argument("--dir", default=BASE)
    ap.add_argument("--out", default="",
                    help="result JSON (default <dir>/biobank_axis_<axis>_"
                         "result.json)")
    ap.add_argument("--n", type=int, default=0, help="override n")
    ap.add_argument("--p", type=int, default=0, help="override p")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--entry", choices=["engine", "am"], default="engine",
                    help="--axis n: the engine with the recorded protocol, "
                         "or am(engine='auto')")
    ap.add_argument("--ckpt", default="",
                    help="--axis n checkpoint dir (default <dir>/ckpt_n)")
    ap.add_argument("--split", action="store_true",
                    help="--axis n --gen: one directory a shard, for two "
                         "processes")
    ap.add_argument("--store-only", action="store_true",
                    help="--axis p --gen: pack the draws into the store, no "
                         "text")
    args = ap.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu")
    if args.axis == "n":
        if args.gen:
            gen_n(args.dir, args.n, args.p, args.split, args.device)
        if args.run:
            run_n(args.dir, args.maxit, args.device, args.entry, args.out,
                  args.ckpt)
    else:
        if args.gen:
            gen_p(args.dir, args.n, args.p, args.store_only, args.device)
        if args.run:
            run_p(args.dir, args.device, args.out)


if __name__ == "__main__":
    main()
