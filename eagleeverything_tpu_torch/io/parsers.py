"""Text-format genotype parsers: ASCII (spaced / no-space), PLINK .ped, VCF.

Reference: the native ``createM_ASCII_rcpp`` / ``createM_PLINK``-style /
VCF ingest kernels (SURVEY.md §3.3, §4.1). These Python implementations are
numpy-vectorized per line-block; a C ingest library (io/native) accelerates
the ASCII hot path when built, with these as the always-available fallback.

Output convention everywhere: int8 matrix, individuals × SNPs, coded
{0,1,2} with missing = -9 (oracle.MISSING).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

MISSING = -9


def _recode_tokens(tokens: np.ndarray, AA: str, AB: str, BB: str, missing: str) -> np.ndarray:
    out = np.full(tokens.shape, MISSING, dtype=np.int8)
    out[tokens == AA] = 0
    out[tokens == AB] = 1
    out[tokens == BB] = 2
    known = (tokens == AA) | (tokens == AB) | (tokens == BB) | (tokens == missing)
    if not known.all():
        bad = tokens[~known][:5]
        raise ValueError(
            f"unrecognized genotype tokens {bad.tolist()} "
            f"(expected AA={AA!r} AB={AB!r} BB={BB!r} missing={missing!r})"
        )
    return out


def iter_ascii_blocks(
    path: str,
    AA: str = "AA",
    AB: str = "AB",
    BB: str = "BB",
    missing: str = "NA",
    block_rows: int = 4096,
    use_native: bool = True,
) -> Iterator[np.ndarray]:
    """Stream an ASCII genotype file in row blocks (individuals-major).

    Uses the native C++ ingest library (io/native, the rebuild's
    ``createM_ASCII_rcpp`` analog) when available; this numpy fallback
    otherwise. Auto-detects no-space single-character coding (line has no
    separator; the declared codes are used when they are single characters,
    else literal '0','1','2' with anything else missing).
    """
    if use_native:
        from eagleeverything_tpu_torch.io import native
        try:
            it = native.iter_ascii_blocks_native(
                path, AA, AB, BB, missing, block_rows
            )
        except ValueError:
            raise
        if it is not None:
            yield from it
            return
    with open(path, "r") as f:
        first = f.readline()
        if not first:
            return
        nospace = " " not in first.strip() and "\t" not in first.strip()
        f.seek(0)
        buf: list[str] = []
        for line in f:
            line = line.strip()
            if not line:
                continue
            buf.append(line)
            if len(buf) >= block_rows:
                yield _decode_ascii_block(buf, nospace, AA, AB, BB, missing)
                buf = []
        if buf:
            yield _decode_ascii_block(buf, nospace, AA, AB, BB, missing)


def _decode_ascii_block(
    lines: list[str], nospace: bool, AA: str, AB: str, BB: str, missing: str
) -> np.ndarray:
    if nospace:
        arr = np.frombuffer("".join(lines).encode("ascii"), dtype=np.uint8)
        arr = arr.reshape(len(lines), -1)
        if len(AA) == 1 and len(AB) == 1 and len(BB) == 1:
            codes = (ord(AA), ord(AB), ord(BB))
        else:
            codes = (ord("0"), ord("1"), ord("2"))
        out = np.full(arr.shape, MISSING, dtype=np.int8)
        out[arr == codes[0]] = 0
        out[arr == codes[1]] = 1
        out[arr == codes[2]] = 2
        # unknown characters are errors, like the spaced-token path
        known = (arr == codes[0]) | (arr == codes[1]) | (arr == codes[2])
        if len(missing) == 1:
            known |= arr == ord(missing)
        if not known.all():
            bad = arr[~known][:5]
            raise ValueError(
                f"unrecognized genotype characters "
                f"{[chr(b) for b in bad]} in no-space file")
        return out
    tokens = np.array([ln.split() for ln in lines], dtype=object)
    return _recode_tokens(tokens.astype(str), AA, AB, BB, missing)


def parse_ascii(path: str, AA="AA", AB="AB", BB="BB", missing="NA") -> np.ndarray:
    blocks = list(iter_ascii_blocks(path, AA, AB, BB, missing))
    if not blocks:
        raise ValueError(f"empty genotype file: {path}")
    return np.vstack(blocks)


def iter_plink_ped_blocks(path: str, block_rows: int = 1024) -> Iterator[np.ndarray]:
    """Stream a PLINK .ped file in row blocks.

    Per line: FID IID PID MID SEX PHENO then 2 allele tokens per SNP;
    '0' = missing allele. Allele orientation must not depend on row order,
    so this is two-pass: pass 1 collects the (≤2) observed alleles per SNP;
    the dose is then the count of the lexicographically larger allele —
    deterministic, and only the sign of downstream effect estimates depends
    on it (association statistics are orientation-invariant).
    """
    # ---- pass 1: per-SNP allele inventory ----
    lo: Optional[np.ndarray] = None  # lexicographically smaller allele
    hi: Optional[np.ndarray] = None  # lexicographically larger allele
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            alleles = np.array(parts[6:], dtype="U4")
            if alleles.size % 2:
                raise ValueError("odd allele count in .ped row")
            a1, a2 = alleles[0::2], alleles[1::2]
            if lo is None:
                p = a1.shape[0]
                lo = np.full(p, "", dtype="U4")
                hi = np.full(p, "", dtype="U4")
            for arr in (a1, a2):
                valid = arr != "0"
                empty = (lo == "") & valid
                lo[empty] = arr[empty]
                differs = valid & (lo != "") & (arr != lo)
                new_hi = differs & (hi == "")
                hi[new_hi] = arr[new_hi]
                if np.any(differs & (hi != "") & (arr != hi)):
                    raise ValueError("more than 2 alleles at a SNP in .ped")
                # keep lo < hi lexicographically
                both = (hi != "")
                swap = both & (lo > hi)
                lo[swap], hi[swap] = hi[swap], lo[swap]
    if lo is None:
        return
    alt = np.where(hi != "", hi, "\x7f")  # monomorphic SNPs: dose stays 0

    # ---- pass 2: decode doses ----
    def decode(lines: list[str]) -> np.ndarray:
        rows = []
        for ln in lines:
            parts = ln.split()
            alleles = np.array(parts[6:], dtype="U4")
            a1, a2 = alleles[0::2], alleles[1::2]
            missing = (a1 == "0") | (a2 == "0")
            dose = (a1 == alt).astype(np.int8) + (a2 == alt).astype(np.int8)
            dose[missing] = MISSING
            rows.append(dose)
        return np.vstack(rows)

    with open(path, "r") as f:
        buf: list[str] = []
        for line in f:
            line = line.strip()
            if not line:
                continue
            buf.append(line)
            if len(buf) >= block_rows:
                yield decode(buf)
                buf = []
        if buf:
            yield decode(buf)


def parse_plink_ped(path: str) -> np.ndarray:
    blocks = list(iter_plink_ped_blocks(path))
    if not blocks:
        raise ValueError(f"empty .ped file: {path}")
    return np.vstack(blocks)


def iter_plink_bed_blocks(
    bed_path: str, block_snps: int = 4096
) -> Iterator[tuple[int, np.ndarray]]:
    """Stream a binary PLINK .bed file in SNP-major blocks.

    Yields (snp_offset, int8 block (b, n)) — already SNP-major, the native
    layout for the sharded genotype store (SURVEY.md §3.3 "PLINK ingest":
    .bed's 2-bit packing is near-isomorphic to the target shard format).

    .bed layout: magic 0x6c 0x1b, mode 0x01 (SNP-major), then per SNP
    ceil(n/4) bytes of 2-bit codes: 00=hom A1, 01=missing, 10=het,
    11=hom A2. Dose counts A1 (the PLINK minor-allele convention):
    00→2, 10→1, 11→0, 01→missing.
    """
    import os
    base = bed_path[:-4] if bed_path.endswith(".bed") else bed_path
    fam, bim = base + ".fam", base + ".bim"
    if not (os.path.exists(fam) and os.path.exists(bim)):
        raise ValueError(f".bed needs companion {fam} and {bim}")
    with open(fam) as f:
        n = sum(1 for ln in f if ln.strip())
    with open(bim) as f:
        p = sum(1 for ln in f if ln.strip())
    bpr = (n + 3) // 4  # bytes per SNP row
    lut = np.empty(4, dtype=np.int8)
    lut[0b00], lut[0b01], lut[0b10], lut[0b11] = 2, MISSING, 1, 0
    with open(bed_path, "rb") as f:
        magic = f.read(3)
        if magic[:2] != b"\x6c\x1b":
            raise ValueError(f"{bed_path}: bad .bed magic")
        if magic[2] != 1:
            raise ValueError(f"{bed_path}: only SNP-major .bed supported")
        for j0 in range(0, p, block_snps):
            b = min(block_snps, p - j0)
            raw = np.frombuffer(f.read(b * bpr), dtype=np.uint8)
            if raw.size != b * bpr:
                raise ValueError(f"{bed_path}: truncated at SNP {j0}")
            raw = raw.reshape(b, bpr)
            codes = np.stack(
                [(raw >> s) & 3 for s in (0, 2, 4, 6)], axis=2
            ).reshape(b, bpr * 4)[:, :n]
            yield j0, lut[codes]


def parse_plink_bed(bed_path: str) -> np.ndarray:
    """Whole .bed → dense individuals-major int8 (n, p)."""
    blocks = [blk for _, blk in iter_plink_bed_blocks(bed_path)]
    if not blocks:
        raise ValueError(f"no SNPs in {bed_path}")
    return np.vstack(blocks).T


def read_plink_bim(bed_path: str):
    """Marker names/chrom/pos from the .bim companion of a .bed file."""
    base = bed_path[:-4] if bed_path.endswith(".bed") else bed_path
    names, chroms, poss = [], [], []
    with open(base + ".bim") as f:
        for ln in f:
            parts = ln.split()
            if not parts:
                continue
            chroms.append(parts[0])
            names.append(parts[1])
            poss.append(int(parts[3]))
    return names, chroms, poss


def ensure_plain_text(path: str) -> str:
    """Transparent gzip support: a gzip-compressed genotype file (e.g. the
    de-facto-standard ``.vcf.gz``) is stream-decompressed once to a cached
    sibling (``x.vcf.gz`` → ``x.ungz.vcf``, preserving the extension so
    type dispatch and the native mmap scanners work) and that path is
    returned; plain files pass through untouched. The sibling is reused
    while it is newer than the source — same spirit as the reference's
    reusable packed-binary ingest artifacts (SURVEY.md §6.4)."""
    with open(path, "rb") as f:
        if f.read(2) != b"\x1f\x8b":
            return path
    base = path[:-3] if path.endswith(".gz") else path
    root, ext = os.path.splitext(base)
    out = root + ".ungz" + ext
    if (os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(path)):
        return out
    import gzip
    import shutil
    import tempfile
    # unique temp name: concurrent ingests of the same .gz (multi-host
    # launchers, parallel test workers) must not interleave writes; the
    # atomic replace makes the last finisher win with a complete file
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(out) or ".",
                               prefix=os.path.basename(out) + ".")
    try:
        with gzip.open(path, "rb") as src, os.fdopen(fd, "wb") as dst:
            shutil.copyfileobj(src, dst, length=1 << 24)
        os.replace(tmp, out)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return out


def vcf_dims(path: str) -> tuple[int, int]:
    """(n_samples, n_variants) from a cheap line scan (no GT decoding)."""
    from eagleeverything_tpu_torch.io import native
    dims = native.vcf_dims_native(path)
    if dims is not None:
        return dims
    n = p = 0
    with open(path, "r") as f:
        for line in f:
            if line.startswith("##") or not line.strip():
                continue
            if line.startswith("#CHROM"):
                n = len(line.rstrip("\n").split("\t")) - 9
                continue
            p += 1
    if n <= 0:
        raise ValueError(f"no #CHROM sample header in VCF: {path}")
    return n, p


def iter_vcf_blocks(path: str, block_snps: int = 4096,
                    use_native: bool = True):
    """Stream a VCF: yields (geno_block [n × b], names, chrom, pos) tuples.

    VCF rows are SNPs (SNP-major on disk — the native layout for the
    SNP-sharded store). Only the GT subfield is read; '.' calls → missing.
    Uses the native C++ GT scanner (io/native, multithreaded over an
    mmap'd line index — the rebuild's answer to SURVEY §8's "ingest
    throughput for 5M-SNP VCFs" hot spot) when available; this pure-Python
    scan otherwise.
    """
    if use_native:
        from eagleeverything_tpu_torch.io import native
        it = native.iter_vcf_blocks_native(path, block_snps)
        if it is not None:
            yield from it
            return
    with open(path, "r") as f:
        samples: Optional[list[str]] = None
        rows: list[np.ndarray] = []
        names: list[str] = []
        chroms: list[str] = []
        poss: list[int] = []
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                samples = line.split("\t")[9:]
                continue
            if samples is None:
                raise ValueError("VCF data before #CHROM header")
            parts = line.split("\t")
            fmt = parts[8].split(":")
            gt_idx = fmt.index("GT")
            calls = parts[9:]
            dose = np.empty(len(calls), dtype=np.int8)
            for i, c in enumerate(calls):
                gt = c.split(":")[gt_idx]
                a = gt.replace("|", "/").split("/")
                if "." in a or len(a) < 2:
                    dose[i] = MISSING
                else:
                    dose[i] = min(int(a[0]), 1) + min(int(a[1]), 1)
            rows.append(dose)
            names.append(parts[2] if parts[2] != "." else f"{parts[0]}:{parts[1]}")
            chroms.append(parts[0])
            poss.append(int(parts[1]))
            if len(rows) >= block_snps:
                yield np.vstack(rows).T, names, chroms, poss
                rows, names, chroms, poss = [], [], [], []
        if rows:
            yield np.vstack(rows).T, names, chroms, poss


def parse_vcf(path: str):
    """Parse a whole VCF → (geno [n×p] int8, marker_names, chrom, pos)."""
    genos, names, chroms, poss = [], [], [], []
    for g, nm, ch, po in iter_vcf_blocks(path):
        genos.append(g)
        names += nm
        chroms += ch
        poss += po
    if not genos:
        raise ValueError(f"no variant records in VCF: {path}")
    return np.hstack(genos), names, chroms, poss
