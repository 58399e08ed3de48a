"""Data readers: genotypes, phenotypes, marker map, incidence matrix.

Reference surface (SURVEY.md §3.1): ``ReadMarker()``, ``ReadPheno()``,
``ReadMap()``, ``ReadZmat()``. ``read_marker`` returns a handle; small data
stays in memory, large data goes to the sharded on-disk genotype store
(io/genostore — the same bytes the JAX package writes), the durable
ingestion artifact (SURVEY.md §6.4). Text and VCF parsing run in the native
ingest library (io/native) when it builds, in numpy otherwise.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from eagleeverything_tpu_torch.io import parsers


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


def read_marker(
    filename: str,
    type: str = "text",
    AA: str = "AA",
    AB: str = "AB",
    BB: str = "BB",
    missing: str = "NA",
    availmemGb: float = 8.0,
    store_dir: Optional[str] = None,
    n_shards: Optional[int] = None,
    packed: bool = False,
    quiet: bool = True,
    ncpu: int = 0,
) -> GenoHandle:
    """Ingest genotypes (reference: ``ReadMarker()``, SURVEY.md §3.1/§4.1).

    Args:
      filename: genotype file path. For ``type='PLINK'`` either a text
        ``.ped`` or a binary ``.bed`` (with ``.bim``/``.fam`` companions).
      type: "text" (ASCII, spaced or no-space), "PLINK", or "vcf".
      AA/AB/BB/missing: genotype codes for ASCII input.
      availmemGb: host-RAM block budget for out-of-core ingestion.
      store_dir: write the sharded on-disk store here (out-of-core path);
        otherwise genotypes stay in memory.
      n_shards: shard count for the store (default 1; the JAX package
        defaults to its local device count, so pass it where both packages
        must write the same shards).
      packed: store shards 2-bit packed (4× smaller; reference's
        packed-binary spirit).
      ncpu: thread cap for the native recode pool — the reference's
        ``ncpu`` argument (SURVEY.md §3.4 row 1). 0 (default) uses all
        hardware threads.
    """
    if ncpu < 0:
        raise ValueError(f"ncpu must be >= 0, got {ncpu}")
    # the native pool reads EE_NCPU at dispatch time (io/native/ingest.cpp
    # hw_threads); scope the override to this call
    old = os.environ.get("EE_NCPU")
    if ncpu > 0:
        os.environ["EE_NCPU"] = str(int(ncpu))
    try:
        return _read_marker_impl(filename, type, AA, AB, BB, missing,
                                 availmemGb, store_dir, n_shards, packed,
                                 quiet)
    finally:
        if ncpu > 0:
            if old is None:
                os.environ.pop("EE_NCPU", None)
            else:
                os.environ["EE_NCPU"] = old


def _read_marker_impl(
    filename: str,
    type: str,
    AA: str,
    AB: str,
    BB: str,
    missing: str,
    availmemGb: float,
    store_dir: Optional[str],
    n_shards: Optional[int],
    packed: bool,
    quiet: bool,
) -> GenoHandle:
    from eagleeverything_tpu_torch.io.genostore import GenotypeStore

    type_l = type.lower()
    names = chrom = pos = None
    is_bed = type_l == "plink" and filename.endswith(".bed")
    orig_filename = filename
    if type_l == "plink" and filename.endswith(".bed.gz"):
        raise ValueError(
            "gzipped binary PLINK (.bed.gz) is not supported — gunzip it "
            "first (the .bim/.fam companions are located by the .bed path)")
    if not is_bed:
        # transparent .gz support (text / .ped / VCF); .bed stays as-is
        # (its .bim/.fam companions are path-derived)
        filename = parsers.ensure_plain_text(filename)

    # auto-spill: a file bigger than the host-RAM budget goes straight to
    # the on-disk sharded store (reference: ReadMarker always writes the
    # packed binary artifact; we keep small data in RAM but match the
    # out-of-core behavior past availmemGb, SURVEY.md §4.1)
    if store_dir is None and os.path.getsize(filename) > availmemGb * 1e9:
        store_dir = filename + ".store"

    if type_l in ("text", "ascii"):
        blocks_iter = parsers.iter_ascii_blocks(filename, AA, AB, BB, missing)
    elif is_bed:
        names, chrom, pos = parsers.read_plink_bim(filename)
        blocks_iter = None
    elif type_l == "plink":
        blocks_iter = parsers.iter_plink_ped_blocks(filename)
        # populate marker metadata from the .map companion when present;
        # for gzipped input the companion sits next to the ORIGINAL file
        # (x.ped.gz -> x.map), not the decompressed sibling
        def _map_candidate(path: str) -> str:
            if path.endswith(".gz"):
                path = path[:-3]
            return (path[:-4] if path.endswith(".ped") else path) + ".map"
        map_path = _map_candidate(filename)
        if not os.path.exists(map_path):
            map_path = _map_candidate(orig_filename)
        if os.path.exists(map_path):
            _names, _chrom, _pos = [], [], []
            with open(map_path) as f:
                for ln in f:
                    parts = ln.split()
                    if len(parts) >= 4:
                        _chrom.append(parts[0])
                        _names.append(parts[1])
                        _pos.append(int(parts[3]))
            if _names:
                names, chrom, pos = _names, _chrom, _pos
    elif type_l == "vcf":
        blocks_iter = None
    else:
        raise ValueError(f"unknown genotype file type {type!r}")

    if store_dir is not None:
        if is_bed:
            base = filename[:-4]
            with open(base + ".fam") as f:
                n = sum(1 for ln in f if ln.strip())
            store = GenotypeStore.create_from_snp_blocks(
                store_dir, parsers.iter_plink_bed_blocks(filename),
                n=n, p=len(names), n_shards=n_shards, packed=packed,
                source=filename,
            )
        elif type_l == "vcf":
            # stream VCF SNP-major straight into the store (no transpose,
            # no whole-file materialization): a cheap first pass counts
            # samples/records for the shard plan, the second pass streams
            n, p_count = parsers.vcf_dims(filename)
            names, chrom, pos = [], [], []

            def vcf_blocks():
                off = 0
                for g, nm, ch, po in parsers.iter_vcf_blocks(filename):
                    names.extend(nm)
                    chrom.extend(ch)
                    pos.extend(po)
                    yield off, g.T
                    off += g.shape[1]

            store = GenotypeStore.create_from_snp_blocks(
                store_dir, vcf_blocks(), n=n, p=p_count,
                n_shards=n_shards, packed=packed, source=filename,
            )
        else:
            store = GenotypeStore.create_from_row_blocks(
                store_dir, blocks_iter, n_shards=n_shards,
                availmem_gb=availmemGb, packed=packed, source=filename,
            )
        return GenoHandle(n=store.n, p=store.p, source=filename,
                          store_dir=store_dir, availmem_gb=availmemGb,
                          marker_names=names or None,
                          chrom=chrom or None, pos=pos or None)

    if is_bed:
        geno = parsers.parse_plink_bed(filename)
    elif type_l == "vcf":
        geno, names, chrom, pos = parsers.parse_vcf(filename)
    else:
        geno = np.vstack(list(blocks_iter))
    n, p = geno.shape
    if not quiet:
        # reference: ReadMarker prints dimensions + memory-need estimates
        print(f"ReadMarker: {n} individuals x {p} SNPs from {filename}; "
              f"in-memory int8 {n * p / 1e6:.1f} MB, f32 working set "
              f"{n * p * 4 / 1e6:.1f} MB (availmemGb={availmemGb})")
    return GenoHandle(n=n, p=p, source=filename, geno=geno,
                      availmem_gb=availmemGb, marker_names=names,
                      chrom=chrom, pos=pos)


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


def read_zmat(filename: str) -> np.ndarray:
    """Read the 0/1 incidence matrix Z (reference: ``ReadZmat()``)."""
    Z = np.loadtxt(filename)
    if Z.ndim == 1:
        Z = Z[None, :]
    if not np.isin(Z, (0.0, 1.0)).all():
        raise ValueError("Zmat entries must be 0/1")
    if not np.allclose(Z.sum(axis=1), 1.0):
        raise ValueError("each Zmat row must link a record to exactly one individual")
    return Z.astype(np.float64)
