"""Synthetic GWAS data with planted QTL.

- :func:`simulate_dataset` — the JAX package's test/tutorial generator
  (LD blocks, polygenic background), numpy, deterministic given a seed.
- :func:`simulate_cohort` — a biobank-sized cohort written straight into a
  2-bit genotype store: per-SNP MAF, Hardy-Weinberg genotypes drawn on the
  given device, planted QTL and a trait (the logic of the JAX package's
  scripts/cohort_run.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from eagleeverything_tpu_torch.io.genostore import GenotypeStore
from eagleeverything_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class SimData:
    geno: np.ndarray        # (n, p) int8 {0,1,2}
    y: np.ndarray           # (n,) trait
    qtl_idx: np.ndarray     # planted causal SNP indices
    qtl_beta: np.ndarray    # planted effect sizes
    chrom: np.ndarray       # (p,) chromosome labels (1-based ints)
    pos: np.ndarray         # (p,) base-pair positions
    marker_names: list[str]
    covariate: np.ndarray   # (n,) a numeric covariate ("age")
    group: np.ndarray       # (n,) a 2-level factor covariate ("sex")


def simulate_dataset(
    n: int = 150,
    p: int = 5000,
    n_qtl: int = 3,
    h2_qtl: float = 0.35,
    h2_poly: float = 0.30,
    seed: int = 7,
    missing_rate: float = 0.0,
) -> SimData:
    """Simulate genotypes with LD blocks and a trait with planted QTL.

    Genotypes: per-SNP allele frequencies from Beta(2,2); individuals get
    correlated SNPs within small LD blocks (AR(1)-style latent Gaussian)
    so the scan faces realistic local correlation. Trait = planted additive
    QTL effects + polygenic background (from all SNPs) + noise, with the
    QTL/polygenic variance shares controlled by h2_qtl/h2_poly.
    """
    rng = np.random.default_rng(seed)
    freqs = rng.beta(2.0, 2.0, size=p) * 0.9 + 0.05

    block = 25  # SNPs per LD block
    rho = 0.7
    G = np.empty((n, p), dtype=np.int8)
    for start in range(0, p, block):
        end = min(start + block, p)
        width = end - start
        # latent AR(1) Gaussian per haplotype, thresholded at the allele freq
        for hap in range(2):
            z = np.empty((n, width))
            z[:, 0] = rng.standard_normal(n)
            for j in range(1, width):
                z[:, j] = rho * z[:, j - 1] + np.sqrt(1 - rho**2) * rng.standard_normal(n)
            thresh = _norm_ppf(freqs[start:end])
            allele = (z < thresh[None, :]).astype(np.int8)
            if hap == 0:
                G[:, start:end] = allele
            else:
                G[:, start:end] += allele

    qtl_idx = np.sort(rng.choice(p, size=n_qtl, replace=False))
    qtl_beta = rng.choice([-1.0, 1.0], size=n_qtl) * (1.0 + rng.random(n_qtl))

    Wq = G[:, qtl_idx].astype(np.float64)
    Wq = Wq - Wq.mean(axis=0)
    g_qtl = Wq @ qtl_beta

    Wall = G.astype(np.float64)
    Wall = Wall - Wall.mean(axis=0)
    u = Wall @ rng.standard_normal(p) / np.sqrt(p)

    def _scaled(x, target_var):
        v = np.var(x)
        return x * np.sqrt(target_var / v) if v > 0 else x

    h2_e = max(1.0 - h2_qtl - h2_poly, 0.05)
    y = (
        _scaled(g_qtl, h2_qtl)
        + _scaled(u, h2_poly)
        + rng.standard_normal(n) * np.sqrt(h2_e)
    )

    covariate = rng.uniform(20, 60, size=n).round(1)
    group = rng.integers(0, 2, size=n)
    y = y + 0.01 * (covariate - covariate.mean()) + 0.2 * (group - 0.5)

    if missing_rate > 0:
        mask = rng.random((n, p)) < missing_rate
        G = G.copy()
        G[mask] = -9

    snps_per_chr = (p + 3) // 4
    chrom = (np.arange(p) // snps_per_chr + 1).astype(np.int64)
    pos = np.concatenate(
        [np.sort(rng.integers(1, 50_000_000, size=int((chrom == c).sum())))
         for c in np.unique(chrom)]
    )
    names = [f"snp{j:06d}" for j in range(p)]
    return SimData(
        geno=G, y=y, qtl_idx=qtl_idx, qtl_beta=qtl_beta,
        chrom=chrom, pos=pos, marker_names=names,
        covariate=covariate, group=group,
    )


def _norm_ppf(q: np.ndarray) -> np.ndarray:
    from scipy.stats import norm
    return norm.ppf(q)


# ---------------------------------------------------------------------------
# Writers for the reference's text formats (exercised by the ingest tests)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cohort:
    store_dir: str
    n: int
    p: int
    y: np.ndarray           # (n,) trait
    qtl_idx: np.ndarray     # planted causal SNP indices
    qtl_beta: np.ndarray    # planted effect sizes


def simulate_cohort(
    store_dir: str,
    n: int,
    p: int,
    n_qtl: int = 8,
    seed: int = 7,
    device=None,
) -> Cohort:
    """Write an n × p cohort into a 2-bit packed store at ``store_dir``.

    Per-SNP minor-allele frequencies are uniform on [0.05, 0.5] and
    genotypes are Hardy-Weinberg draws, made on ``device`` from a
    ``torch.Generator`` seeded with ``seed`` and packed there, so only the
    packed bytes cross to the host. ``n_qtl`` QTL are planted in the first
    block with total heritability 0.4; y = genetic value + noise. MAFs,
    QTL and the noise come from numpy's generator with the same seed.
    ``device`` defaults to CUDA."""
    device = resolve_device(device)
    block = 4096            # SNPs generated and packed at a time
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    qtl_idx = np.sort(rng.choice(min(block, p), size=n_qtl, replace=False))
    qtl_cols: dict[int, np.ndarray] = {}

    def blocks():
        for j0 in range(0, p, block):
            b = min(block, p - j0)
            maf = torch.as_tensor(rng.uniform(0.05, 0.5, size=(b, 1)),
                                  dtype=torch.float32, device=device)
            u = torch.rand((b, n), generator=gen, device=device)
            geno = ((u < maf * maf).to(torch.int8)
                    + (u < maf * maf + 2 * maf * (1 - maf)).to(torch.int8))
            if j0 == 0:
                for q in qtl_idx:
                    qtl_cols[int(q)] = geno[q].cpu().numpy().astype(
                        np.float64)
            yield j0, geno

    GenotypeStore.create_from_snp_blocks(
        store_dir, blocks(), n=n, p=p, n_shards=8, packed=True,
        source=f"cohort-sim-seed{seed}")
    beta = rng.normal(0, 1.0, size=n_qtl) * np.sqrt(0.4 / n_qtl)
    g = sum(beta[i] * (qtl_cols[int(q)] - qtl_cols[int(q)].mean())
            for i, q in enumerate(qtl_idx))
    y = g + rng.normal(0, np.sqrt(max(1e-6, 1.0 - float(np.var(g)))),
                       size=n)
    return Cohort(store_dir=store_dir, n=n, p=p, y=y, qtl_idx=qtl_idx,
                  qtl_beta=beta)
