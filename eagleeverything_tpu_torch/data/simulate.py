"""Synthetic GWAS data with planted QTL.

- :func:`simulate_dataset` — the JAX package's test/tutorial generator
  (LD blocks, polygenic background), numpy, deterministic given a seed.
- the writers of the reference's file formats (:func:`write_ascii_geno`,
  :func:`write_plink_bed`, :func:`write_vcf`, … :func:`write_tutorial`),
  byte for byte the JAX package's;
- :func:`simulate_cohort` — a biobank-sized cohort written straight into a
  2-bit genotype store: per-SNP MAF, Hardy-Weinberg genotypes drawn on the
  given device, planted QTL and a trait (the logic of the JAX package's
  scripts/cohort_run.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator

import numpy as np
import torch

from eagleeverything_tpu_torch.io.genostore import MISSING, GenotypeStore
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
# Writers for the reference's text formats (exercised by the ingest tests).
# Each writes the bytes the JAX package's writer of the same name writes,
# building whole rows with numpy where that one loops per genotype.
# ---------------------------------------------------------------------------

_BLOCK_BYTES = 1 << 26      # .bed bytes built and written a block at a time


def _code_index(G: np.ndarray) -> np.ndarray:
    """Genotypes {0, 1, 2, -9} → token indices {0, 1, 2, 3}."""
    G = np.asarray(G)
    if not np.isin(G, (0, 1, 2, MISSING)).all():
        raise KeyError("genotypes must be coded 0, 1, 2 or -9")
    return np.where(G == MISSING, 3, G).astype(np.intp)


def _joined_rows(G: np.ndarray, tokens: tuple[str, str, str, str],
                 sep: str) -> Iterator[list[bytes]]:
    """Yield the rows of G, 256 at a time, each as the bytes of its
    genotypes' tokens (``tokens[k]`` for code k, index 3 for missing)
    joined by ``sep``."""
    table = np.array(tokens, dtype=object)
    for r0 in range(0, G.shape[0], 256):
        yield [sep.join(table[row].tolist()).encode()
               for row in _code_index(G[r0 : r0 + 256])]


def write_ascii_geno(
    sim: SimData, path: str, AA: str = "AA", AB: str = "AB", BB: str = "BB",
    missing: str = "NA", sep: str = " ",
) -> None:
    """Space-separated ASCII genotypes, one row per individual (reference:
    ``ReadMarker(type='text')`` input, SURVEY.md §3.1/§4.1)."""
    with open(path, "wb") as f:
        for rows in _joined_rows(sim.geno, (AA, AB, BB, missing), sep):
            f.write(b"".join(r + b"\n" for r in rows))


def write_ascii_geno_nospace(sim: SimData, path: str) -> None:
    """Single-character no-space coding 0/1/2 (reference supports a no-space
    text variant; missing = 'X' here)."""
    write_ascii_geno(sim, path, "0", "1", "2", "X", sep="")


def write_pheno(sim: SimData, path: str, trait_name: str = "y") -> None:
    """Space-separated phenotype table with header (reference:
    ``ReadPheno()`` input). Columns: trait, numeric covariate, factor."""
    with open(path, "w") as f:
        f.write(f"{trait_name} age sex\n")
        for yi, c, g in zip(sim.y, sim.covariate, sim.group):
            f.write(f"{yi:.6f} {c:.1f} {'M' if g else 'F'}\n")


def write_map(sim: SimData, path: str) -> None:
    """Marker map: Mrk Chr Pos (reference: ``ReadMap()`` input)."""
    with open(path, "w") as f:
        f.write("Mrk Chr Pos\n")
        for name, c, bp in zip(sim.marker_names, sim.chrom, sim.pos):
            f.write(f"{name} {c} {bp}\n")


def _family_lead(sim: SimData, i: int) -> str:
    return f"FAM{i+1} IND{i+1} 0 0 {1 + int(sim.group[i])} {sim.y[i]:.6f}"


def write_plink_ped(sim: SimData, ped_path: str, map_path: str) -> None:
    """PLINK .ped/.map pair (reference: ``ReadMarker(type='PLINK')``).

    .ped: FID IID PID MID SEX PHENO then two allele chars per SNP
    (A=ref, B=alt → AA/AB/BB; 0 0 = missing).
    """
    with open(ped_path, "wb") as f:
        i = 0
        for rows in _joined_rows(sim.geno, ("A A", "A B", "B B", "0 0"),
                                 " "):
            for r in rows:
                f.write(_family_lead(sim, i).encode() + b" " + r + b"\n")
                i += 1
    with open(map_path, "w") as f:
        for name, c, bp in zip(sim.marker_names, sim.chrom, sim.pos):
            f.write(f"{c} {name} 0 {bp}\n")


def write_plink_bed(sim: SimData, bed_path: str) -> None:
    """Binary PLINK .bed/.bim/.fam trio (SNP-major, 2-bit).

    Codes per PLINK spec: 00=hom A1, 01=missing, 10=het, 11=hom A2, with
    dose = count of A1, so dose {2,1,0,missing} → {00,10,11,01}. The pad
    individuals of a SNP's last byte code 00.
    """
    base = bed_path[:-4] if bed_path.endswith(".bed") else bed_path
    n, p = sim.geno.shape
    code = np.array([0b11, 0b10, 0b00, 0b01], dtype=np.uint8)  # 0, 1, 2, -9
    bpr = (n + 3) // 4
    snps = max(1, _BLOCK_BYTES // max(4 * bpr, 1))
    with open(base + ".bed", "wb") as f:
        f.write(bytes([0x6C, 0x1B, 0x01]))
        for j0 in range(0, p, snps):
            c = code[_code_index(sim.geno[:, j0 : j0 + snps].T)]
            q = np.zeros((c.shape[0], 4 * bpr), dtype=np.uint8)
            q[:, :n] = c
            q = q.reshape(c.shape[0], bpr, 4)
            f.write((q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4)
                     | (q[..., 3] << 6)).tobytes())
    with open(base + ".bim", "w") as f:
        for name, c, bp in zip(sim.marker_names, sim.chrom, sim.pos):
            f.write(f"{c}\t{name}\t0\t{bp}\tA\tB\n")
    with open(base + ".fam", "w") as f:
        for i in range(n):
            f.write(_family_lead(sim, i) + "\n")


# the JAX package's source tag, so both packages write the same file
_VCF_SOURCE = "##source=%s.simulate\n" % "eagleeverything_tpu"


def write_vcf(sim: SimData, path: str) -> None:
    """Minimal VCF with GT fields (reference: ``ReadMarker(type='vcf')``).

    Note the orientation: VCF rows are SNPs, columns are individuals."""
    n, p = sim.geno.shape
    with open(path, "wb") as f:
        f.write(b"##fileformat=VCFv4.2\n")
        f.write(_VCF_SOURCE.encode())
        header = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER",
                  "INFO", "FORMAT"]
        header += [f"IND{i+1}" for i in range(n)]
        f.write(("\t".join(header) + "\n").encode())
        j = 0
        for rows in _joined_rows(sim.geno.T, ("0/0", "0/1", "1/1", "./."),
                                 "\t"):
            for r in rows:
                lead = (f"{sim.chrom[j]}\t{sim.pos[j]}\t{sim.marker_names[j]}"
                        "\tA\tB\t.\tPASS\t.\tGT\t")
                f.write(lead.encode() + r + b"\n")
                j += 1


def write_zmat(Z: np.ndarray, path: str) -> None:
    """0/1 incidence matrix, space-separated (reference: ``ReadZmat()``)."""
    np.savetxt(path, Z, fmt="%d")


def write_tutorial(outdir: str, n: int = 150, p: int = 5000,
                   seed: int = 7) -> SimData:
    """Generate and write the full tutorial dataset in every format."""
    os.makedirs(outdir, exist_ok=True)
    sim = simulate_dataset(n=n, p=p, seed=seed)
    write_ascii_geno(sim, os.path.join(outdir, "geno.txt"))
    write_pheno(sim, os.path.join(outdir, "pheno.txt"))
    write_map(sim, os.path.join(outdir, "map.txt"))
    np.savetxt(os.path.join(outdir, "qtl_truth.txt"),
               np.c_[sim.qtl_idx, sim.qtl_beta], fmt="%.6f")
    return sim


# ---------------------------------------------------------------------------
# A biobank-sized cohort, generated on the device into a 2-bit store
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
