"""``am()`` and ``am_multi()`` — the multiple-locus forward-selection LMM
scan.

Reference: ``AM()`` (SURVEY.md §3.1, call stack §4.2). These are the entry
points: input validation and NA bookkeeping on the host, then dispatch to an
engine — the dense float64 oracle, the exact eigenbasis engine
(engine_torch.forward_select: MMt, one eigendecomposition and eigenbasis
sweeps as torch ops on the device; the default up to ``matfree_min_n``
individuals), or the matrix-free engine over the packed stack, on the
device or streamed through it (models/bigscan on engine_torch.TiledScan,
with the hand-written CUDA kernels of ops/packed; the default above it) —
all of which share the same host-f64 REML/extBIC decision path
(models/reml_core).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import numpy as np
import torch

from eagleeverything_tpu_torch.api.common import prepare_inputs
from eagleeverything_tpu_torch.api.read import GenoHandle, MapHandle, PhenoHandle
from eagleeverything_tpu_torch.models import oracle
from eagleeverything_tpu_torch.models.oracle import AMResult
from eagleeverything_tpu_torch.utils import distributed
from eagleeverything_tpu_torch.utils import logging as scanlog
from eagleeverything_tpu_torch.utils.config import DEFAULT_CONFIG, EagleConfig
from eagleeverything_tpu_torch.utils.device import resolve_device


@contextlib.contextmanager
def _call_log(name: str, quiet: bool, log_jsonl: Optional[str]):
    """The call's one scan logger (on ``log_jsonl``, host 0 only), open
    for the call inside its root span ``name``; the engines log into it."""
    logger = scanlog.ScanLogger(quiet=quiet, jsonl_path=log_jsonl,
                                is_host0=distributed.is_host0())
    try:
        with scanlog.Phase(logger, name):
            yield logger
    finally:
        logger.close()


def _matfree_kw(config: EagleConfig, backend, maxit: int, fixit: bool,
                lam: float, quiet: bool, logger, ckpt_dir: Optional[str],
                resume: bool) -> dict:
    """The matrix-free AM loop's keywords from a call's arguments and
    ``config``'s ``matfree_*`` fields (``am`` and ``am_multi`` alike)."""
    return dict(
        maxit=maxit, fixit=fixit, lam_ebic=lam, quiet=quiet, logger=logger,
        probes=config.matfree_probes,
        lanczos_m=config.matfree_lanczos_m,
        diag_probes=config.matfree_diag_probes,
        exact_topk=config.matfree_exact_topk,
        solve_m=config.matfree_solve_m,
        solve_m_refit=config.matfree_solve_m_refit,
        cache_max_bytes=int(config.matfree_cache_gb * 1e9),
        column_f64=backend.column_f64, ckpt_dir=ckpt_dir, resume=resume)


def am(
    trait: str,
    geno: Union[GenoHandle, np.ndarray],
    pheno: Union[PhenoHandle, dict, np.ndarray],
    fformula: Optional[str] = None,
    map: Optional[MapHandle] = None,
    Zmat: Optional[np.ndarray] = None,
    maxit: int = 40,
    fixit: bool = False,
    lam: float = 1.0,
    quiet: bool = True,
    engine: str = "auto",
    config: EagleConfig = DEFAULT_CONFIG,
    ckpt_dir: Optional[str] = None,
    resume: bool = False,
    log_jsonl: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> AMResult:
    """Run the whole-genome multiple-locus scan (reference: ``AM()``).

    Args:
      trait: phenotype column name holding the trait.
      geno: handle from :func:`read_marker` (a :class:`GenoHandle` over
        in-memory genotypes or a genotype store), or a raw int8
        {0,1,2,-9} n×p matrix.
      pheno: handle from :func:`read_pheno`, a dict of named columns, or a
        bare trait vector.
      fformula: fixed-effects formula RHS over phenotype columns
        (e.g. ``"age + sex"``); intercept is always included.
      map: optional marker map; selected markers are reported with
        name/chr/pos when given.
      Zmat: optional incidence matrix linking trait records to genotyped
        individuals (reference: ``ReadZmat``). Every engine takes it; on
        the matrix-free engine a one-hot Zmat keeps the device Krylov
        path, any other one solves on the host over the kernel matvec.
      maxit: maximum forward-selection steps (reference default 40).
      fixit: force exactly ``maxit`` selections, ignoring extBIC.
      lam: extBIC sparsity weight λ/gamma (calibrate with :func:`fpr4am`).
      engine: "auto" (the exact eigenbasis engine up to
        ``config.matfree_min_n`` individuals, "matfree" above it, where the
        n×n kernel no longer fits), "jax" (the exact engine, under the JAX
        package's name so one call runs on both packages), "sharded" (the
        exact engine SNP-sharded over the (ind, snp) mesh of the ranks,
        ``config.mesh_shape``; one process runs it on its one device),
        "matfree" or "oracle". In a multi-process run (utils/distributed)
        every rank calls ``am`` alike; the matrix-free engine then holds
        each rank's SNP range (engine_torch.MultiHostTiledScan).
      ckpt_dir, resume: MMt/eigenbasis cache and per-iteration scan state
        (exact and matrix-free engines); ``resume`` restarts from the last
        accepted marker.
      log_jsonl: the scan log, appended to as JSON lines: a ``phase``
        event for each span of the call (its root ``am``, the steps inside
        it), iterations and counters (utils/logging).
      device: where the exact and matrix-free engines run: CUDA unless the
        caller passes ``"cpu"`` (raises when CUDA is asked for and absent).
    """
    with _call_log("am", quiet, log_jsonl) as logger:
        with scanlog.Phase(logger, "prep"):
            dev = resolve_device(device)
            prep = prepare_inputs(trait, geno, pheno, fformula, Zmat)
            if engine == "auto":
                n_ind = prep.handle.n
                engine = "matfree" if n_ind > config.matfree_min_n else "jax"
        if engine == "oracle":
            geno_raw = prep.handle.materialize()
            if prep.keep_individuals is not None:
                geno_raw = geno_raw[prep.keep_individuals]
            res = oracle.forward_select(
                prep.y, prep.X0, geno_raw, maxit=maxit, fixit=fixit,
                lam_ebic=lam, Z=prep.Z, quiet=quiet,
            )
        elif engine in ("jax", "sharded"):
            from eagleeverything_tpu_torch.models import engine_torch
            res = engine_torch.forward_select(
                prep.y, prep.X0, prep.handle, maxit=maxit, fixit=fixit,
                lam_ebic=lam, Z=prep.Z, quiet=quiet, config=config,
                keep_records=prep.keep_individuals, ckpt_dir=ckpt_dir,
                resume=resume, device=dev, sharded=(engine == "sharded"),
                logger=logger,
            )
        elif engine == "matfree":
            # biobank n-scale mode: K never materialized — CG/SLQ REML and
            # the two-stage probe/exact score sweep
            # (docs/design_biobank_scale.md) over the packed stack, on the
            # device or streamed through it (each rank's SNP range in a
            # multi-process run: the kernel matvec sums over the ranks)
            from eagleeverything_tpu_torch.models import bigscan, engine_torch
            with scanlog.Phase(logger, "backend"):
                src = engine_torch._make_source(prep.handle,
                                                prep.keep_individuals)
                backend = engine_torch.scan_backend(src, config, dev)
            res = bigscan.forward_select_matfree(
                prep.y, prep.X0, backend, Z=prep.Z,
                **_matfree_kw(config, backend, maxit, fixit, lam, quiet,
                              logger, ckpt_dir, resume))
        else:
            raise ValueError(f"unknown engine {engine!r}")

        # enrich with map info (reference AMclass: Mrk/Chr/Pos)
        res.trait_name = trait
        res.dropped_records = prep.dropped
        handle = prep.handle
        if map is not None:
            if map.p != handle.p:
                raise ValueError(f"map has {map.p} rows but genotypes "
                                 f"have {handle.p} SNPs")
            res.marker_names = [map.marker_names[j] for j in res.indices]
            res.chr = [str(map.chrom[j]) for j in res.indices]
            res.pos = [float(map.pos[j]) for j in res.indices]
        elif handle.marker_names is not None:
            res.marker_names = [handle.marker_names[j] for j in res.indices]
            res.chr = [str(handle.chrom[j]) for j in res.indices]
            res.pos = [float(handle.pos[j]) for j in res.indices]
        if not quiet:
            _print_result(res)
        return res


def am_multi(
    traits: list[str],
    geno: Union[GenoHandle, np.ndarray],
    pheno: Union[PhenoHandle, dict],
    fformula: Optional[str] = None,
    map: Optional[MapHandle] = None,
    maxit: int = 40,
    fixit: bool = False,
    lam: float = 1.0,
    quiet: bool = True,
    engine: str = "auto",
    config: EagleConfig = DEFAULT_CONFIG,
    ckpt_dir: Optional[str] = None,
    resume: bool = False,
    log_jsonl: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> dict[str, AMResult]:
    """Scan several traits in one pass (BASELINE config 5).

    MMt, its eigendecomposition and the device T tiles are shared; each
    iteration's sweeps for all still-active traits run as one batched pass.
    Records with a missing value in ANY trait or covariate are dropped for
    all traits (union NA rule) so the shared kernel stays valid. Returns
    {trait_name: AMResult}.

    ``engine``: "auto" (the exact eigenbasis engine; "matfree" above
    ``config.matfree_min_n`` individuals, as :func:`am` routes), "jax"
    (force the exact engine) or "matfree" (force the lockstep matrix-free
    scan: the resident stack, one union Krylov basis and one batched
    sweep an iteration for every trait,
    ``bigscan.forward_select_matfree_multi``). ``ckpt_dir`` and
    ``resume`` are honoured by the matrix-free engine and accepted,
    unused, by the exact one, as in the JAX package; ``log_jsonl`` (the
    scan log) and ``device`` as in :func:`am`.
    """
    from eagleeverything_tpu_torch.models import engine_torch

    with _call_log("am_multi", quiet, log_jsonl) as logger:
        with scanlog.Phase(logger, "prep"):
            dev = resolve_device(device)
            ys, X, drop, keep_idx, handle = _multi_inputs(traits, geno,
                                                          pheno, fformula)
            if engine == "auto":
                engine = ("matfree" if handle.n > config.matfree_min_n
                          else "jax")
        if engine == "matfree":
            # biobank n-scale multi-trait: the shared resident stack and ONE
            # union Krylov basis an iteration for every trait (BASELINE
            # config 5 at config 3's n)
            from eagleeverything_tpu_torch.models import bigscan
            with scanlog.Phase(logger, "backend"):
                backend = engine_torch.scan_backend(
                    engine_torch._make_source(handle, keep_idx), config, dev)
            results = bigscan.forward_select_matfree_multi(
                ys, X, backend, trait_names=list(traits),
                **_matfree_kw(config, backend, maxit, fixit, lam, quiet,
                              logger, ckpt_dir, resume))
        elif engine == "jax":
            results = engine_torch.forward_select_multi(
                ys, X, handle,
                maxit=maxit, fixit=fixit, lam_ebic=lam, quiet=quiet,
                config=config, keep_records=keep_idx,
                trait_names=list(traits), device=dev, logger=logger,
            )
        else:
            raise ValueError(f"unknown engine {engine!r}")
        out = {}
        for res in results:
            res.dropped_records = drop
            if map is not None:
                res.marker_names = [map.marker_names[j] for j in res.indices]
                res.chr = [str(map.chrom[j]) for j in res.indices]
                res.pos = [float(map.pos[j]) for j in res.indices]
            out[res.trait_name] = res
            if not quiet:
                _print_result(res)
        return out


def _multi_inputs(traits, geno, pheno, fformula):
    """am_multi's traits (R, kept records), design (kept records, q), the
    dropped records, the kept indices (None when all are kept) and the
    genotype handle, under the union NA rule."""
    from eagleeverything_tpu_torch.api.design import build_design, na_rows

    if isinstance(pheno, PhenoHandle):
        columns = pheno.columns
    else:
        columns = {k: np.asarray(v) for k, v in pheno.items()}
    missing = [t for t in traits if t not in columns]
    if missing:
        raise KeyError(f"traits {missing} not in phenotype columns "
                       f"{sorted(columns)}")
    ys_full = np.stack([np.asarray(columns[t], dtype=np.float64)
                        for t in traits])
    n_rec = ys_full.shape[1]
    X_full, _ = build_design(columns, fformula, n_rec)
    used = [ys_full[i] for i in range(len(traits))] + [
        X_full[:, j] for j in range(1, X_full.shape[1])]
    drop = na_rows(*used)
    keep = np.setdiff1d(np.arange(n_rec), drop)

    handle = geno if isinstance(geno, GenoHandle) else None
    if handle is None:
        arr = np.asarray(geno)
        handle = GenoHandle(n=arr.shape[0], p=arr.shape[1],
                            source="<array>", geno=arr)
    if handle.n != n_rec:
        raise ValueError(f"{n_rec} phenotype records vs {handle.n} "
                         "individuals")
    keep_idx = keep if len(keep) != n_rec else None
    return ys_full[:, keep], X_full[keep], drop, keep_idx, handle


def _print_result(res: AMResult) -> None:
    print(f"\nAM scan complete: {len(res.indices)} marker(s) selected "
          f"(n={res.n}, p={res.p}, lambda={res.lam_ebic})")
    for rank, j in enumerate(res.indices):
        name = res.marker_names[rank] if res.marker_names else f"snp[{j}]"
        loc = (f" chr={res.chr[rank]} pos={res.pos[rank]:.0f}" if res.chr else "")
        print(f"  {rank+1}. {name} (index {j}){loc} "
              f"extBIC={res.extbic_path[rank+1]:.3f}")
