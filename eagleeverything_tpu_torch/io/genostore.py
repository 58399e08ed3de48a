"""Sharded, SNP-major, on-disk genotype store — the out-of-core layer.

The rebuild's analog of the reference's packed binary ``M``/``Mt`` files
plus the ``ReadBlock`` streaming contract (SURVEY.md §3.3 L1/L2, §6.4):
ingestion runs once, the store is the durable artifact, and every p-scale
sweep streams SNP-major tiles host-RAM → device.

Layout: ``<dir>/manifest.json`` + ``<dir>/shard_{k:05d}.bin``. Shard k is a
contiguous SNP range stored row-major ``(p_k, n)`` — one row per SNP — so
per-SNP (column) access is sequential on disk, which is why the reference
maintains the transpose ``Mt`` (SURVEY.md §3.3 "Transpose ingest": the
SNP-major store makes the explicit transpose artifact unnecessary). Shard
boundaries align with the device mesh: shard k feeds device/host k in the
SNP-sharded scan.

Two physical encodings per manifest ``layout``:
- ``snp_major``      — int8, 1 byte/genotype.
- ``snp_major_2bit`` — 2-bit packed (00/01/10 = dose, 11 = missing), the
  reference's packed-binary spirit and PLINK-.bed-adjacent; 4× less disk
  and page-cache traffic. Rows are padded to a whole number of bytes
  (n rounded up to a multiple of 4) so SNP rows stay byte-addressable.

The bytes on disk are the JAX package's, so each package opens a store the
other wrote. Packing runs in torch (:func:`pack2`), on the device of the
block it is given.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, Optional

import numpy as np
import torch

MISSING = -9
_MANIFEST = "manifest.json"


@dataclasses.dataclass
class GenotypeStore:
    dir: str
    n: int                  # individuals
    p: int                  # SNPs
    shard_offsets: list[int]  # start SNP index of each shard (len n_shards+1)
    packed: bool = False
    source: str = ""

    # ---------------- creation ----------------

    @classmethod
    def create_from_row_blocks(
        cls,
        dir: str,
        row_blocks: Iterator[np.ndarray],
        n_shards: Optional[int] = None,
        availmem_gb: float = 8.0,
        packed: bool = False,
        source: str = "",
    ) -> "GenotypeStore":
        """Ingest from individuals-major row blocks (as text parsers yield)
        via a biobank-safe chunked two-pass transpose (reference:
        ``createM`` then ``createMt``, SURVEY.md §4.1).

        Pass 1 streams rows into a RAM buffer bounded by ``availmem_gb``;
        each flush transposes the buffered individuals and APPENDS the
        already-ENCODED column-slab to one temp file per shard (slab
        widths are multiples of 4 individuals, so 2-bit slabs concatenate
        byte-aligned). Pass 2 stitches each shard's slabs into the final
        row-per-SNP file with purely sequential reads/writes, deleting the
        temp as it goes. Peak scratch disk ≈ one encoded store (the temps)
        on top of the final store — never the n·p int8 row-major temp the
        naive blocked transpose needs — and RAM never exceeds the buffer
        plus one transposed slab. When everything fits in one flush the
        slab IS the shard and is renamed, not copied.
        """
        os.makedirs(dir, exist_ok=True)
        it = iter(row_blocks)
        first = next(it, None)
        if first is None:
            raise ValueError("no genotype rows")
        first = np.ascontiguousarray(first, dtype=np.int8)
        p = first.shape[1]
        offsets = cls._shard_plan(p, n_shards)
        ns = len(offsets) - 1
        # buffer rows: a multiple of 4 (2-bit slab alignment), sized so
        # buffer + the largest transposed slab stay inside availmem_gb
        rows_cap = max(4, (int(availmem_gb * 1e9 / 1.5) // max(p, 1)) // 4 * 4)
        buf = np.empty((rows_cap, p), dtype=np.int8)
        tmp_paths = [os.path.join(dir, f"_slab_{k:05d}.tmp")
                     for k in range(ns)]
        tmps = [open(tp, "wb") for tp in tmp_paths]
        slab_rows: list[int] = []    # individuals per flush
        n = 0
        fill = 0

        def flush():
            nonlocal fill
            if fill == 0:
                return
            for k in range(ns):
                j0, j1 = offsets[k], offsets[k + 1]
                tmps[k].write(_encode(
                    np.ascontiguousarray(buf[:fill, j0:j1].T), packed))
            slab_rows.append(fill)
            fill = 0

        def push(blk: np.ndarray):
            nonlocal fill, n
            r0 = 0
            while r0 < blk.shape[0]:
                take = min(rows_cap - fill, blk.shape[0] - r0)
                buf[fill : fill + take] = blk[r0 : r0 + take]
                fill += take
                r0 += take
                n += take
                if fill == rows_cap:
                    flush()

        try:
            push(first)
            for blk in it:
                blk = np.ascontiguousarray(blk, dtype=np.int8)
                if blk.shape[1] != p:
                    raise ValueError("inconsistent SNP count across row blocks")
                push(blk)
            flush()
        finally:
            for f in tmps:
                f.close()
        del buf

        # pass 2: stitch slabs → final shards (sequential I/O both ways)
        row_b = ((n + 3) // 4) if packed else n
        slab_b = [((r + 3) // 4) if packed else r for r in slab_rows]
        for k in range(ns):
            j0, j1 = offsets[k], offsets[k + 1]
            pk = j1 - j0
            final = os.path.join(dir, f"shard_{k:05d}.bin")
            if len(slab_rows) == 1:
                os.replace(tmp_paths[k], final)   # slab == shard layout
                continue
            mm = np.memmap(tmp_paths[k], dtype=np.uint8, mode="r")
            slabs = []
            off = 0
            for sb in slab_b:
                slabs.append(mm[off : off + pk * sb].reshape(pk, sb))
                off += pk * sb
            tile = max(1, int(availmem_gb * 1e9 / 2 / max(row_b, 1)))
            with open(final, "wb") as f:
                for t0 in range(0, pk, tile):
                    t1 = min(t0 + tile, pk)
                    out = np.empty((t1 - t0, row_b), dtype=np.uint8)
                    c = 0
                    for sl, sb in zip(slabs, slab_b):
                        out[:, c : c + sb] = sl[t0:t1]
                        c += sb
                    f.write(out.tobytes())
            del slabs, mm
            os.remove(tmp_paths[k])

        cls._write_manifest(dir, n, p, offsets, packed, source)
        return cls(dir=dir, n=n, p=p, shard_offsets=offsets,
                   packed=packed, source=source)

    @classmethod
    def create_from_dense(
        cls, dir: str, geno: np.ndarray, n_shards: Optional[int] = None,
        availmem_gb: float = 8.0, packed: bool = False, source: str = "",
    ) -> "GenotypeStore":
        geno = np.asarray(geno, dtype=np.int8)
        n, p = geno.shape
        return cls._write_shards(
            dir, lambda j0, j1: np.ascontiguousarray(geno[:, j0:j1].T),
            n=n, p=p, n_shards=n_shards, availmem_gb=availmem_gb,
            packed=packed, source=source,
        )

    @classmethod
    def create_from_snp_blocks(
        cls, dir: str, snp_blocks: Iterator[tuple[int, np.ndarray]],
        n: int, p: int, n_shards: Optional[int] = None,
        packed: bool = False, source: str = "",
    ) -> "GenotypeStore":
        """Ingest from already-SNP-major (offset, (b, n)) blocks — the
        no-transpose fast path for VCF and PLINK .bed input. A block may be
        a numpy array or a torch tensor; a tensor is packed on its own
        device, so a generator on the card ships only packed bytes."""
        os.makedirs(dir, exist_ok=True)
        offsets = cls._shard_plan(p, n_shards)
        files = [open(os.path.join(dir, f"shard_{k:05d}.bin"), "wb")
                 for k in range(len(offsets) - 1)]
        try:
            expect = 0
            for j0, blk in snp_blocks:
                if j0 != expect:
                    raise ValueError("snp blocks must be contiguous and ordered")
                if not isinstance(blk, torch.Tensor):
                    blk = np.ascontiguousarray(blk, dtype=np.int8)
                expect += blk.shape[0]
                r0 = 0
                while r0 < blk.shape[0]:
                    g = j0 + r0
                    k = int(np.searchsorted(np.asarray(offsets), g,
                                            side="right") - 1)
                    take = min(offsets[k + 1] - g, blk.shape[0] - r0)
                    files[k].write(_encode(blk[r0 : r0 + take], packed))
                    r0 += take
            if expect != p:
                raise ValueError(f"snp blocks covered {expect} of {p} SNPs")
        finally:
            for f in files:
                f.close()
        cls._write_manifest(dir, n, p, offsets, packed, source)
        return cls(dir=dir, n=n, p=p, shard_offsets=offsets,
                   packed=packed, source=source)

    @classmethod
    def _write_shards(
        cls, dir, get_cols, n, p, n_shards, availmem_gb, packed, source
    ) -> "GenotypeStore":
        os.makedirs(dir, exist_ok=True)
        offsets = cls._shard_plan(p, n_shards)
        block_cols = max(1, int(availmem_gb * 1e9 / max(n, 1) / 4))
        for k in range(len(offsets) - 1):
            j0, j1 = offsets[k], offsets[k + 1]
            with open(os.path.join(dir, f"shard_{k:05d}.bin"), "wb") as f:
                for c0 in range(j0, j1, block_cols):
                    c1 = min(c0 + block_cols, j1)
                    f.write(_encode(get_cols(c0, c1).astype(np.int8), packed))
        cls._write_manifest(dir, n, p, offsets, packed, source)
        return cls(dir=dir, n=n, p=p, shard_offsets=offsets,
                   packed=packed, source=source)

    @staticmethod
    def _shard_plan(p: int, n_shards: Optional[int]) -> list[int]:
        if n_shards is None:
            n_shards = 1
        n_shards = max(1, min(n_shards, p))
        base, rem = divmod(p, n_shards)
        sizes = [base + (1 if k < rem else 0) for k in range(n_shards)]
        return np.concatenate([[0], np.cumsum(sizes)]).tolist()

    @staticmethod
    def _write_manifest(dir, n, p, offsets, packed, source) -> None:
        manifest = {
            "version": 1, "dtype": "int8",
            "layout": "snp_major_2bit" if packed else "snp_major",
            "n": int(n), "p": int(p), "shard_offsets": offsets,
            "source": source, "missing": MISSING,
        }
        # write-then-rename: the manifest is the store's commit record
        # (written LAST, after all shards), so a killed ingest leaves a
        # directory that GenotypeStore.open refuses rather than a torn
        # manifest (SURVEY.md §6.3 restartable-ingest contract)
        tmp = os.path.join(dir, _MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, os.path.join(dir, _MANIFEST))

    # ---------------- access ----------------

    @classmethod
    def open(cls, dir: str) -> "GenotypeStore":
        with open(os.path.join(dir, _MANIFEST)) as f:
            m = json.load(f)
        if m.get("layout") not in ("snp_major", "snp_major_2bit"):
            raise ValueError(f"unsupported store manifest: {m}")
        return cls(dir=dir, n=m["n"], p=m["p"],
                   shard_offsets=m["shard_offsets"],
                   packed=(m["layout"] == "snp_major_2bit"),
                   source=m.get("source", ""))

    @property
    def n_shards(self) -> int:
        return len(self.shard_offsets) - 1

    @property
    def _row_bytes(self) -> int:
        return ((self.n + 3) // 4) if self.packed else self.n

    def _shard_raw(self, k: int) -> np.ndarray:
        """Memory-mapped raw bytes of shard k, shape (p_k, row_bytes)."""
        j0, j1 = self.shard_offsets[k], self.shard_offsets[k + 1]
        return np.memmap(os.path.join(self.dir, f"shard_{k:05d}.bin"),
                         dtype=np.uint8 if self.packed else np.int8,
                         mode="r", shape=(j1 - j0, self._row_bytes))

    def shard_mmap(self, k: int) -> np.ndarray:
        """SNP-major int8 view of shard k, shape (p_k, n). For packed
        stores this decodes into memory; prefer iter_tiles for streaming."""
        raw = self._shard_raw(k)
        return _decode(np.asarray(raw), self.n, self.packed)

    def iter_tiles(self, tile_snps: int) -> Iterator[tuple[int, np.ndarray]]:
        """Yield (global_snp_offset, int8 tile (b, n)) SNP-major tiles —
        the ``ReadBlock`` streaming contract (SURVEY.md §3.3 L1)."""
        for k in range(self.n_shards):
            raw = self._shard_raw(k)
            j0 = self.shard_offsets[k]
            for t0 in range(0, raw.shape[0], tile_snps):
                t1 = min(t0 + tile_snps, raw.shape[0])
                yield j0 + t0, _decode(np.asarray(raw[t0:t1]), self.n,
                                       self.packed)

    def iter_raw_tiles(self, tile_snps: int) -> Iterator[tuple[int, np.ndarray]]:
        """Yield (global_snp_offset, raw shard bytes (b, row_bytes)) without
        decoding — for 2-bit stores the packed bytes go to the device as-is
        and are unpacked on-chip (4× less H2D traffic; ops/kernels
        unpack_recode_tile)."""
        yield from self.iter_raw_tiles_in(0, self.p, tile_snps)

    def iter_raw_tiles_in(
        self, lo: int, hi: int, tile_snps: int
    ) -> Iterator[tuple[int, np.ndarray]]:
        """Range-restricted iter_raw_tiles: only shards intersecting
        [lo, hi) are opened (host-local shard reads in multi-host SPMD,
        mirroring ``tiles_in``)."""
        for k in range(self.n_shards):
            s0, s1 = self.shard_offsets[k], self.shard_offsets[k + 1]
            if s1 <= lo or s0 >= hi:
                continue
            raw = self._shard_raw(k)
            a, b = max(s0, lo), min(s1, hi)
            for t0 in range(a, b, tile_snps):
                t1 = min(t0 + tile_snps, b)
                yield t0, np.asarray(raw[t0 - s0 : t1 - s0])

    def read_rows(self, lo: int, hi: int, out: torch.Tensor) -> None:
        """Copy the store's own bytes of SNP rows [lo, hi) — 2-bit packed
        (uint8), or int8 genotypes in an unpacked store — into the first
        ``row_bytes`` columns of ``out`` ((hi - lo, ≥ row_bytes) of that
        dtype, on the host), the rest of each row untouched. A chunk that
        crosses shard boundaries is assembled from each shard's part; only
        the shards that intersect [lo, hi) are opened, and each call maps
        its range anew, so a shard file that is missing or too short raises
        here. The copy is torch's parallel CPU copy from the mapped pages."""
        rb = self._row_bytes
        dtype = np.uint8 if self.packed else np.int8
        for k in range(self.n_shards):
            s0, s1 = self.shard_offsets[k], self.shard_offsets[k + 1]
            if s1 <= lo or s0 >= hi:
                continue
            a, b = max(s0, lo), min(s1, hi)
            # copy-on-write: a writable view of the file's pages (nothing
            # is written), which torch.from_numpy takes without a warning
            mm = np.memmap(os.path.join(self.dir, f"shard_{k:05d}.bin"),
                           dtype=dtype, mode="c", offset=(a - s0) * rb,
                           shape=(b - a, rb))
            out[a - lo : b - lo, :rb].copy_(torch.from_numpy(mm))
            del mm

    def column(self, j: int) -> np.ndarray:
        """One genotype column (SNP j) — reference: ``extract_geno_rcpp``
        (SURVEY.md §3.3): a single sequential row read in SNP-major layout."""
        k = int(np.searchsorted(np.asarray(self.shard_offsets), j, side="right") - 1)
        raw = self._shard_raw(k)
        row = np.asarray(raw[j - self.shard_offsets[k]])[None, :]
        return _decode(row, self.n, self.packed)[0]

    def to_dense(self) -> np.ndarray:
        """Dense individuals-major (n, p) matrix (small data only)."""
        out = np.empty((self.n, self.p), dtype=np.int8)
        for j0, tile in self.iter_tiles(tile_snps=65536):
            out[:, j0 : j0 + tile.shape[0]] = tile.T
        return out


def _pack2_bytes(block) -> torch.Tensor:
    """(b, n) int8 {0,1,2,-9} → (b, ⌈n/4⌉) uint8 on the block's device:
    genotype 4c+k at bits 2k of byte c, missing = code 3, the pad genotypes
    of a row's last byte code 0."""
    g = block if isinstance(block, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(block, dtype=np.int8))
    b, n = g.shape
    n4 = -(-n // 4) * 4
    codes = torch.zeros((b, n4), dtype=torch.uint8, device=g.device)
    codes[:, :n] = torch.where(g == MISSING, 3, g.to(torch.int8))
    q = codes.view(b, n4 // 4, 4)
    return q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) | (q[..., 3] << 6)


def pack2(block) -> np.ndarray:
    """The store's 2-bit bytes of a (b, n) int8 block, (b, ⌈n/4⌉) uint8 on
    the host (:func:`_pack2_bytes`). A torch tensor is packed on its own
    device."""
    return _pack2_bytes(block).cpu().numpy()


def pack2_words(block: torch.Tensor, nw: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The device form of :func:`pack2`: a (b, n) int8 tensor → its (b, nw)
    int32 words on the tensor's own device, the little-endian view of
    pack2's bytes with every byte past a row's ⌈n/4⌉ set to 0x55 (four het
    codes, W = 0) — the packed stack's rows, bit for bit. Written into
    ``out`` (contiguous (b, nw) int32) when given."""
    byts = _pack2_bytes(block)
    if out is None:
        out = torch.empty((block.shape[0], nw), dtype=torch.int32,
                          device=block.device)
    u8 = out.view(torch.uint8)
    u8[:, byts.shape[1]:] = 0x55
    u8[:, : byts.shape[1]] = byts
    return out


def unpack2(raw: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack2`: (b, row_bytes) uint8 → (b, n) int8."""
    raw = np.asarray(raw, dtype=np.uint8)
    codes = np.stack([(raw >> s) & 3 for s in (0, 2, 4, 6)],
                     axis=-1).reshape(raw.shape[0], -1)[:, :n]
    return np.where(codes == 3, MISSING, codes).astype(np.int8)


def _encode(block, packed: bool) -> bytes:
    """(b, n) int8 → shard bytes (2-bit packing pads n to a multiple of 4)."""
    if not packed:
        if isinstance(block, torch.Tensor):
            block = block.cpu().numpy()
        return np.ascontiguousarray(block, dtype=np.int8).tobytes()
    return pack2(block).tobytes()


def _decode(raw: np.ndarray, n: int, packed: bool) -> np.ndarray:
    """shard bytes (b, row_bytes) → (b, n) int8."""
    if not packed:
        return raw
    return unpack2(raw, n)
