"""``summary_am()`` — post-fit inference on the selected model.

Reference: ``SummaryAM()`` (SURVEY.md §3.1, call stack §4.4): pull the
selected genotype columns, one extra REML fit at the final model, Wald
tests / p-values / effect sizes / % variance explained, pretty tables.
The n×n GLS algebra runs host-f64; the genomic kernel K comes from the
device backend (so the store path needs no dense matrix), and the
matrix-free form solves against the kernel matvec of the packed-stack
kernels (ops/packed) by device CG.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from eagleeverything_tpu_torch.api.common import prepare_inputs
from eagleeverything_tpu_torch.api.read import GenoHandle, PhenoHandle
from eagleeverything_tpu_torch.models import engine_torch, reml_core
from eagleeverything_tpu_torch.models.oracle import (AMResult, WaldSummary,
                                                     gls_wald_stats)
from eagleeverything_tpu_torch.utils.config import DEFAULT_CONFIG, EagleConfig
from eagleeverything_tpu_torch.utils.device import resolve_device


def summary_am(
    res: AMResult,
    trait: str,
    geno: Union[GenoHandle, np.ndarray],
    pheno: Union[PhenoHandle, dict, np.ndarray],
    fformula: Optional[str] = None,
    Zmat: Optional[np.ndarray] = None,
    quiet: bool = False,
    config: EagleConfig = DEFAULT_CONFIG,
    engine: str = "auto",
    device: Optional[Union[str, torch.device]] = None,
) -> WaldSummary:
    """Wald inference for each selected marker (reference: ``SummaryAM()``).

    ``engine``: "exact" (dense n×n kernel + fresh REML refit), "matfree"
    (biobank n: V⁻¹-products by device CG against the kernel matvec,
    reusing the scan's own (δ, σ²) final-model fit; a Zmat solves in
    record space, on the device when it is one-hot), or "auto" (matfree
    above ``config.matfree_min_n``). ``device``: where K or the kernel
    matvecs are computed, CUDA unless the caller passes ``"cpu"``."""
    dev = resolve_device(device)
    prep = prepare_inputs(trait, geno, pheno, fformula, Zmat)
    y, X0, Z = prep.y, prep.X0, prep.Z

    src = engine_torch._make_source(prep.handle, prep.keep_individuals)
    if engine == "auto":
        engine = "matfree" if src.n > config.matfree_min_n else "exact"
    if engine not in ("exact", "matfree"):
        raise ValueError(f"unknown summary engine {engine!r}")
    backend = engine_torch.scan_backend(src, config, dev,
                                        matfree=(engine == "matfree"))

    idx = list(res.indices)
    Wcols = np.column_stack(
        [backend.column_f64(j) for j in idx]
    ) if idx else np.zeros((src.n, 0))

    if engine == "matfree":
        from eagleeverything_tpu_torch.models import bigscan
        ctx = bigscan.make_context(backend, y.shape[0], Z=Z)
        Wcols = ctx.z_apply(Z, Wcols)
        out = bigscan.gls_wald_stats_matfree(
            ctx.solve_block, y, X0, Wcols, idx,
            res.delta, res.sigma2_g, res.sigma2_e)
    else:
        if Z is not None:
            Wcols = Z @ Wcols
        K = engine_torch.normalized_kernel(backend.compute_K(), Z)
        lam_s, eta2_s, _ = reml_core.spectral_inputs(
            y, np.hstack([X0, Wcols]), K)
        fit = reml_core.reml_maximize(lam_s, eta2_s)
        out = gls_wald_stats(y, X0, Wcols, K, idx, fit)
    if not quiet:
        _print_summary(out, res)
    return out


def _print_summary(s: WaldSummary, res: AMResult) -> None:
    print(f"\nSummary of the {len(s.indices)}-marker model "
          f"(trait: {res.trait_name})")
    print(f"  sigma2_g = {s.sigma2_g:.6g}   sigma2_e = {s.sigma2_e:.6g}")
    hdr = f"  {'marker':<16}{'index':>8}{'beta':>12}{'se':>10}{'Wald':>10}{'p':>12}{'%var':>8}"
    print(hdr)
    for i, j in enumerate(s.indices):
        name = res.marker_names[i] if res.marker_names else f"snp[{j}]"
        print(f"  {name:<16}{j:>8}{s.beta[i]:>12.4f}{s.se[i]:>10.4f}"
              f"{s.wald[i]:>10.3f}{s.pvalue[i]:>12.3e}"
              f"{100*s.var_explained[i]:>8.2f}")
