"""Data readers: phenotypes and the marker map, and the genotype handle.

Reference surface (SURVEY.md §3.1): ``ReadPheno()``, ``ReadMap()``. A
:class:`GenoHandle` carries in-memory genotypes or the directory of an
on-disk genotype store (io/genostore — the same bytes the JAX package
writes). Genotype ingestion from text, PLINK and VCF files (``read_marker``)
is not part of this package yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

@dataclasses.dataclass
class GenoHandle:
    """Handle to ingested genotypes (reference: the list returned by
    ``ReadMarker`` — paths + dims + availmemGb, SURVEY.md §3.1)."""

    n: int
    p: int
    source: str
    geno: Optional[np.ndarray] = None          # in-memory int8 (n, p), {0,1,2,-9}
    store_dir: Optional[str] = None            # on-disk sharded store (out-of-core)
    availmem_gb: float = 8.0
    marker_names: Optional[list[str]] = None   # populated by VCF ingest
    chrom: Optional[list[str]] = None
    pos: Optional[list[int]] = None

    def materialize(self) -> np.ndarray:
        """Dense int8 (n, p) matrix — loads from the store if out-of-core."""
        if self.geno is not None:
            return self.geno
        from eagleeverything_tpu_torch.io.genostore import GenotypeStore
        return GenotypeStore.open(self.store_dir).to_dense()


@dataclasses.dataclass
class PhenoHandle:
    columns: dict[str, np.ndarray]
    names: list[str]

    @property
    def n(self) -> int:
        return len(next(iter(self.columns.values())))


@dataclasses.dataclass
class MapHandle:
    marker_names: list[str]
    chrom: np.ndarray
    pos: np.ndarray

    @property
    def p(self) -> int:
        return len(self.marker_names)


def read_pheno(filename: str, missing: str = "NA") -> PhenoHandle:
    """Read the phenotype table (reference: ``ReadPheno()``).

    Space/tab-separated with a header row. Columns parse as float64 where
    possible (missing → NaN); otherwise they stay as string factors.
    """
    with open(filename, "r") as f:
        header = f.readline().split()
        rows = [ln.split() for ln in f if ln.strip()]
    if not header:
        raise ValueError(f"empty phenotype file: {filename}")
    ncol = len(header)
    for r in rows:
        if len(r) != ncol:
            raise ValueError(
                f"phenotype row has {len(r)} fields, header has {ncol}: {r[:4]}..."
            )
    cols: dict[str, np.ndarray] = {}
    raw = np.array(rows, dtype=object)
    for j, name in enumerate(header):
        col = raw[:, j].astype(str)
        try:
            num = np.where(col == missing, "nan", col).astype(np.float64)
            cols[name] = num
        except ValueError:
            cols[name] = col
    return PhenoHandle(columns=cols, names=header)


def read_map(filename: str) -> MapHandle:
    """Read the marker map: Mrk Chr Pos (reference: ``ReadMap()``)."""
    with open(filename, "r") as f:
        header = f.readline().split()
        rows = [ln.split() for ln in f if ln.strip()]
    if len(header) < 3:
        raise ValueError("map file needs at least 3 columns: Mrk Chr Pos")
    names = [r[0] for r in rows]
    chrom = np.array([r[1] for r in rows])
    pos = np.array([float(r[2]) for r in rows])
    return MapHandle(marker_names=names, chrom=chrom, pos=pos)
