"""``am()`` — the multiple-locus forward-selection LMM scan.

Reference: ``AM()`` (SURVEY.md §3.1, call stack §4.2). This is the entry
point: input validation and NA bookkeeping on the host, then dispatch to an
engine — the dense float64 oracle or the matrix-free engine over the
device-resident packed stack (models/bigscan on engine_torch.TiledScan,
with the hand-written CUDA kernels of ops/packed) — both of which share
the same host-f64 REML/extBIC decision path (models/reml_core). The exact
eigenbasis engine of the JAX package is not in this package yet.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from eagleeverything_tpu_torch.api.common import prepare_inputs
from eagleeverything_tpu_torch.api.read import GenoHandle, MapHandle, PhenoHandle
from eagleeverything_tpu_torch.models import oracle
from eagleeverything_tpu_torch.models.oracle import AMResult
from eagleeverything_tpu_torch.utils.config import DEFAULT_CONFIG, EagleConfig
from eagleeverything_tpu_torch.utils.device import resolve_device


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
      geno: a :class:`GenoHandle` over in-memory genotypes or a genotype
        store directory (or a raw int8 {0,1,2,-9} n×p matrix).
      pheno: handle from :func:`read_pheno`, a dict of named columns, or a
        bare trait vector.
      fformula: fixed-effects formula RHS over phenotype columns
        (e.g. ``"age + sex"``); intercept is always included.
      map: optional marker map; selected markers are reported with
        name/chr/pos when given.
      Zmat: optional incidence matrix linking trait records to genotyped
        individuals (reference: ``ReadZmat``); oracle engine only for now.
      maxit: maximum forward-selection steps (reference default 40).
      fixit: force exactly ``maxit`` selections, ignoring extBIC.
      lam: extBIC sparsity weight λ/gamma.
      engine: "auto" ("matfree" above ``config.matfree_min_n``
        individuals, where the n×n kernel no longer fits; the exact engine
        below it), "matfree" or "oracle". The exact engines ("jax",
        "sharded") are not in this package yet and raise
        NotImplementedError, as "auto" does below ``matfree_min_n``.
      device: where the matrix-free engine runs: CUDA unless the caller
        passes ``"cpu"`` (raises when CUDA is asked for and absent).
    """
    dev = resolve_device(device)
    prep = prepare_inputs(trait, geno, pheno, fformula, Zmat)

    if engine == "auto":
        n_ind = prep.handle.n
        engine = "matfree" if n_ind > config.matfree_min_n else "jax"
    if engine in ("jax", "sharded"):
        raise NotImplementedError(
            f"engine {engine!r}: the exact eigenbasis engine is the next "
            "slice of the PyTorch port; below matfree_min_n="
            f"{config.matfree_min_n} individuals use engine='matfree' or "
            "engine='oracle'")
    if engine == "oracle":
        geno_raw = prep.handle.materialize()
        if prep.keep_individuals is not None:
            geno_raw = geno_raw[prep.keep_individuals]
        res = oracle.forward_select(
            prep.y, prep.X0, geno_raw, maxit=maxit, fixit=fixit,
            lam_ebic=lam, Z=prep.Z, quiet=quiet,
        )
    elif engine == "matfree":
        # biobank n-scale mode: K never materialized — CG/SLQ REML and the
        # two-stage probe/exact score sweep (docs/design_biobank_scale.md)
        # over the device-resident packed stack
        if prep.Z is not None:
            raise NotImplementedError(
                "Zmat on the matrix-free engine is not in the PyTorch port "
                "yet; use engine='oracle'")
        from eagleeverything_tpu_torch.models import bigscan, engine_torch
        src = engine_torch._make_source(prep.handle, prep.keep_individuals)
        backend = engine_torch.TiledScan(src, config, dev)
        res = bigscan.forward_select_matfree(
            prep.y, prep.X0, backend, maxit=maxit, fixit=fixit,
            lam_ebic=lam, quiet=quiet, log_jsonl=log_jsonl,
            probes=config.matfree_probes,
            lanczos_m=config.matfree_lanczos_m,
            diag_probes=config.matfree_diag_probes,
            exact_topk=config.matfree_exact_topk,
            solve_m=config.matfree_solve_m,
            solve_m_refit=config.matfree_solve_m_refit,
            cache_max_bytes=int(config.matfree_cache_gb * 1e9),
            column_f64=backend.column_f64,
            ckpt_dir=ckpt_dir, resume=resume,
        )
    else:
        raise ValueError(f"unknown engine {engine!r}")

    # enrich with map info (reference AMclass: Mrk/Chr/Pos)
    res.trait_name = trait
    res.dropped_records = prep.dropped
    handle = prep.handle
    if map is not None:
        if map.p != handle.p:
            raise ValueError(f"map has {map.p} rows but genotypes have {handle.p} SNPs")
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


def _print_result(res: AMResult) -> None:
    print(f"\nAM scan complete: {len(res.indices)} marker(s) selected "
          f"(n={res.n}, p={res.p}, lambda={res.lam_ebic})")
    for rank, j in enumerate(res.indices):
        name = res.marker_names[rank] if res.marker_names else f"snp[{j}]"
        loc = (f" chr={res.chr[rank]} pos={res.pos[rank]:.0f}" if res.chr else "")
        print(f"  {rank+1}. {name} (index {j}){loc} "
              f"extBIC={res.extbic_path[rank+1]:.3f}")
