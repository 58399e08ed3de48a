"""The cohort and its traits, made from the seed by the benchmark itself.

A configuration file gives the recipe: ``n_individuals`` × ``n_snps``,
per-SNP minor-allele frequency uniform on [``maf_lo``, ``maf_hi``],
Hardy-Weinberg genotypes, and ``n_qtl`` QTL planted in the first
``qtl_block`` SNPs. Genotypes are drawn on the device, a block of
``BLOCK`` SNPs at a time, each block from a ``torch.Generator`` seeded by
(seed, block), so that the reference can draw any block again, alone and in
any order, and get the same bytes. The program is handed the genotypes as a
2-bit genotype store in a temporary directory (its own input format); the
reference never reads that store.

A trait is the planted QTL's effects plus noise. Every trait of every seed
has the same set of effect sizes, ``qtl_shares`` (each QTL's share of the
trait's variance), dealt to the QTL in an order and with signs drawn from
(seed, call), so that each call does the same work whatever the seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

BLOCK = 4096                    # SNPs drawn at a time
_MASK = (1 << 63) - 1


def block_seed(seed: int, j0: int) -> int:
    """The generator seed of the block of SNPs that starts at ``j0``."""
    return (seed * 0x9E3779B97F4A7C15 + (j0 + 1) * 0xBF58476D1CE4E5B9) & _MASK


def genotype_block(cfg: dict, seed: int, j0: int, device) -> torch.Tensor:
    """Dosages {0, 1, 2} int8 (b, n) of SNPs [j0, j0 + b), b ≤ BLOCK."""
    n, p = cfg["n_individuals"], cfg["n_snps"]
    b = min(BLOCK, p - j0)
    gen = torch.Generator(device=device)
    gen.manual_seed(block_seed(seed, j0))
    lo, hi = cfg["maf_lo"], cfg["maf_hi"]
    maf = lo + (hi - lo) * torch.rand((b, 1), generator=gen, device=device)
    u = torch.rand((b, n), generator=gen, device=device)
    hom = maf * maf
    return ((u < hom).to(torch.int8)
            + (u < hom + 2 * maf * (1 - maf)).to(torch.int8))


def blocks(cfg: dict, seed: int, device):
    """(offset, dosages) of every block, in order."""
    for j0 in range(0, cfg["n_snps"], BLOCK):
        yield j0, genotype_block(cfg, seed, j0, device)


def qtl_positions(cfg: dict, seed: int) -> np.ndarray:
    """The planted QTL's SNP indices, sorted, in the first ``qtl_block``."""
    rng = np.random.default_rng([seed, 1])
    span = min(cfg["qtl_block"], cfg["n_snps"])
    return np.sort(rng.choice(span, size=cfg["n_qtl"], replace=False))


def qtl_columns(cfg: dict, seed: int, qtl: np.ndarray, device) -> np.ndarray:
    """Dosages (n_qtl, n) f64 of the planted QTL, drawn again."""
    cols = []
    for j in qtl:
        j0 = int(j) // BLOCK * BLOCK
        g = genotype_block(cfg, seed, j0, device)
        cols.append(g[int(j) - j0].cpu().numpy().astype(np.float64))
    return np.stack(cols)


@dataclasses.dataclass
class Cohort:
    cfg: dict
    seed: int
    qtl: np.ndarray             # planted SNP indices
    qtl_dose: np.ndarray        # (n_qtl, n) f64 dosages of the QTL

    @property
    def n(self) -> int:
        return self.cfg["n_individuals"]

    @property
    def p(self) -> int:
        return self.cfg["n_snps"]

    def trait(self, call: int, trait: int = 0) -> np.ndarray:
        """The trait of one call (and trait index, for several a call):
        Σ βᵢ·(gᵢ − ḡᵢ) + noise, var(βᵢ·gᵢ) = the share dealt to QTL i."""
        rng = np.random.default_rng([self.seed, 2, call, trait])
        shares = np.asarray(self.cfg["qtl_shares"], dtype=np.float64)
        shares = shares[rng.permutation(len(shares))]
        signs = rng.choice((-1.0, 1.0), size=len(shares))
        g = self.qtl_dose - self.qtl_dose.mean(axis=1, keepdims=True)
        sd = g.std(axis=1)
        beta = signs * np.sqrt(shares) / np.where(sd > 0, sd, 1.0)
        noise = rng.normal(0.0, np.sqrt(1.0 - shares.sum()), size=self.n)
        return beta @ g + noise


def make(cfg: dict, seed: int, device, store_dir: str):
    """Draw the cohort and write it as a 2-bit store at ``store_dir``.
    Returns (cohort, GenoHandle over the store)."""
    from eagleeverything_tpu_torch import GenoHandle, GenotypeStore

    n, p = cfg["n_individuals"], cfg["n_snps"]
    qtl = qtl_positions(cfg, seed)
    GenotypeStore.create_from_snp_blocks(
        store_dir, blocks(cfg, seed, device), n=n, p=p, n_shards=8,
        packed=True, source=f"benchmark-{cfg['name']}-{seed}")
    cohort = Cohort(cfg, seed, qtl, qtl_columns(cfg, seed, qtl, device))
    return cohort, GenoHandle(n=n, p=p, source=f"benchmark-{cfg['name']}",
                              store_dir=store_dir)
