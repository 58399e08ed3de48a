"""Kernels over the resident 2-bit packed genotype stack.

Counterpart of the JAX package's ops/pallas_packed.py. The stack is int32
``(p, nw)``, ``nw = ⌈⌈n/4⌉/4⌉``: a little-endian word view of the store's
2-bit byte stream, so word w of SNP row i holds genotypes j = 16w + k at
bits 2k. Codes 0/1/2 recode to dose − 1 and code 3 (missing) to the SNP's
mean dose − 1 (:func:`row_means`). Bytes past a row's ⌈n/4⌉ real bytes
are 0x55 (het codes, W = 0); genotype positions j ≥ n inside the real bytes
are never allowed to reach an output.

- :func:`packed_dot`  D = W·A, A (n, r) → (p, r)    — CUDA ``csrc/packed_dot.cu``
- :func:`packed_tdot` Wᵀ·T, T (p, r) → (n, r)       — CUDA ``csrc/packed_tdot.cu``
- :func:`kernel_matvec` K·V = Wᵀ(W·V): the two launches in turn

The TPU kernels took the skinny operand in a permuted "plane" order; these
take and return it in natural genotype order. Each wrapper takes its
plain PyTorch version (unpack + ``torch.matmul``) for a tensor on the CPU
and launches its kernel for a CUDA tensor; there is no fallback between
the two. ``LAUNCHES`` counts kernel launches per wrapper, ``K1_PATHS``
``packed_dot``'s launches by design (:func:`k1_path`).

Numerics: both kernels run on the bf16 tensor cores with fp32
accumulation and split each operand into bf16 pieces: W = W_hi + W_lo
(W_lo is nonzero only at missing codes) and the skinny operand X into
X_0 + X_1 (+ X_2), each piece the bf16 of what the earlier ones leave.
``packed_tdot`` sums W_hi·T_0 + W_hi·T_1 + W_lo·T_0 (bf16x3; T kept to 16
bits, about 2⁻¹⁷ of each term). ``packed_dot`` keeps A to 24 bits, as
fp32 does, with a third piece and a fourth product W_hi·A_2: its rounding
of A is one vector δA whose error W·δA ``kernel_matvec`` would amplify
along the top eigenvectors of K. Both stay well inside the 1e-4-of-scale
tolerance the kernels are held to. Each 32-deep k-step is summed from
zero and added to the running sum with an IEEE fp32 add, since the tensor
cores' own accumulation is not one. No TF32. Each wrapper allocates its
scratch: the bf16 planes of X (rows padded to the 32-deep k-step, columns
to whole column tiles) and, for ``packed_tdot``'s split-K, ``nsplit·n·r``
f32 partials that a second launch adds in a fixed order. ``packed_dot``
needs no split: one thread sums each output element over all n genotypes.
Both are bitwise repeatable. ``packed_dot`` has two designs with the same
MMAs in the same order, so the same bits: a narrow one for column tiles of
at most 32 that unpacks W straight into the tensor cores' operand
registers, and the wide one for every width; :func:`k1_path` picks one
from the shapes and the stack's alignment.
"""

from __future__ import annotations

import ctypes

import torch

PAD_WORD = 0x55555555        # sixteen het codes → W = 0

LAUNCHES = {"packed_dot": 0, "packed_tdot": 0}
K1_PATHS = {"narrow": 0, "wide": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, K1_PATHS):
        for k in counts:
            counts[k] = 0


def k1_path(p: int, rows: int, sms: int, aligned: bool) -> str:
    """The packed_dot design for p SNP rows on a card of ``sms`` SMs, where
    the narrow design takes ``rows`` SNP rows a block at the launch's width
    (0 above 32 columns, which it does not take): "narrow" where its blocks
    number at least half the SMs and the stack starts on a 16-byte boundary
    (``aligned``: it copies the words 16 bytes at a time), else "wide".
    Under half a wave the wide kernel's blocks of 128 rows finish first at
    16 and 32 columns, and lose by at most 13% at 8 (one rule for every
    width). Both give the same bits."""
    return ("narrow" if rows and aligned and 2 * -(-p // rows) >= sms
            else "wide")


def words_per_row(n: int) -> int:
    """int32 words per packed row of n genotypes."""
    return -(-(-(-n // 4)) // 4)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _byte_table(device, missing=None) -> torch.Tensor:
    """(256, 4) table: the four 2-bit codes of each byte value (bits 2k),
    as uint8 codes, or — given ``missing`` — as f32 dose − 1 with code 3
    mapped to ``missing``."""
    b = torch.arange(256, dtype=torch.int32, device=device)
    codes = torch.stack([(b >> s) & 3 for s in (0, 2, 4, 6)], dim=1)
    if missing is None:
        return codes.to(torch.uint8)
    return torch.where(codes == 3, missing, codes.to(torch.float32) - 1.0)


def _bytes(Wp: torch.Tensor) -> torch.Tensor:
    """(rows, nw) int32 words → (rows, 4·nw) int64 byte values (the words
    are a little-endian view of the byte stream)."""
    return Wp.contiguous().view(torch.uint8).to(torch.int64)


def unpack_codes(Wp: torch.Tensor, n: int) -> torch.Tensor:
    """(rows, nw) int32 words → (rows, n) uint8 2-bit codes."""
    codes = _byte_table(Wp.device)[_bytes(Wp)]          # (rows, 4·nw, 4)
    return codes.reshape(Wp.shape[0], -1)[:, :n]


def unpack_chunk_rows(n: int) -> int:
    """Rows per chunk so one unpacked f32 chunk stays near 256 MB."""
    return max(1, (1 << 26) // max(n, 1))


def row_means(Wp: torch.Tensor, n: int) -> torch.Tensor:
    """Per-SNP mean dose of the valid codes, f32 (p,); an all-missing SNP
    gets 1.0 (so W = 0), as engine_jax._packed_rowmeans_jit."""
    p = Wp.shape[0]
    out = torch.ones(p, dtype=torch.float32, device=Wp.device)
    for i0 in range(0, p, unpack_chunk_rows(n)):
        codes = unpack_codes(Wp[i0 : i0 + unpack_chunk_rows(n)], n)
        valid = codes != 3
        cnt = valid.sum(dim=1)
        # integer sums are exact, so the f32 quotient matches the
        # reference's f32 sum / count bit for bit
        s = torch.where(valid, codes, 0).sum(dim=1, dtype=torch.int64)
        mean = s.to(torch.float32) / cnt.clamp(min=1).to(torch.float32)
        out[i0 : i0 + codes.shape[0]] = torch.where(
            cnt > 0, mean, torch.ones_like(mean))
    return out


def recode(Wp: torch.Tensor, means: torch.Tensor, n: int) -> torch.Tensor:
    """(rows, nw) packed words → (rows, n) f32 recoded W, unpacked a row
    chunk at a time so the gather's f32 and int64 blocks stay near 256 MB
    whatever the number of rows."""
    rows = Wp.shape[0]
    out = torch.empty((rows, n), dtype=torch.float32, device=Wp.device)
    table = _byte_table(Wp.device, float("nan"))
    step = unpack_chunk_rows(n)
    for i0 in range(0, rows, step):
        byts = _bytes(Wp[i0 : i0 + step])
        # one row of the table a byte (index_select: a plain gather of
        # whole rows, faster on the CPU than advanced indexing)
        vals = table.index_select(0, byts.reshape(-1))
        vals = vals.reshape(byts.shape[0], -1)[:, :n]
        out[i0 : i0 + step] = torch.where(
            torch.isnan(vals), means[i0 : i0 + step, None] - 1.0, vals)
    return out


def packed_dot_plain(Wp: torch.Tensor, A: torch.Tensor, means: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Plain version of :func:`packed_dot`, row chunk by row chunk."""
    p = Wp.shape[0]
    D = torch.empty((p, A.shape[1]), dtype=torch.float32, device=A.device)
    step = unpack_chunk_rows(n)
    for i0 in range(0, p, step):
        D[i0 : i0 + step] = recode(Wp[i0 : i0 + step],
                                   means[i0 : i0 + step], n) @ A
    return D


def packed_tdot_plain(Wp: torch.Tensor, T: torch.Tensor, means: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Plain version of :func:`packed_tdot`, row chunk by row chunk."""
    p = Wp.shape[0]
    out = torch.zeros((n, T.shape[1]), dtype=torch.float32, device=T.device)
    step = unpack_chunk_rows(n)
    for i0 in range(0, p, step):
        out += recode(Wp[i0 : i0 + step], means[i0 : i0 + step],
                      n).T @ T[i0 : i0 + step]
    return out


def kernel_matvec_plain(Wp: torch.Tensor, V: torch.Tensor,
                        means: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of :func:`kernel_matvec`: each row chunk of W is
    recoded once and serves both products."""
    p = Wp.shape[0]
    out = torch.zeros((n, V.shape[1]), dtype=torch.float32, device=V.device)
    step = unpack_chunk_rows(n)
    for i0 in range(0, p, step):
        Wc = recode(Wp[i0 : i0 + step], means[i0 : i0 + step], n)
        out += Wc.T @ (Wc @ V)
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(Wp: torch.Tensor, X: torch.Tensor, means: torch.Tensor, n: int,
           x_rows: int, what: str) -> None:
    p = Wp.shape[0] if Wp.dim() == 2 else -1
    if Wp.dtype != torch.int32 or Wp.dim() != 2 or p < 1:
        raise ValueError(f"stack must be int32 (p, nw), got {Wp.dtype} "
                         f"{tuple(Wp.shape)}")
    if Wp.shape[1] != words_per_row(n):
        raise ValueError(f"stack has {Wp.shape[1]} words a row; n={n} "
                         f"needs {words_per_row(n)}")
    if means.dtype != torch.float32 or tuple(means.shape) != (p,):
        raise ValueError(f"means must be f32 ({p},), got {means.dtype} "
                         f"{tuple(means.shape)}")
    if X.dtype != torch.float32 or X.dim() != 2 or X.shape[0] != x_rows \
            or X.shape[1] < 1:
        raise ValueError(f"{what} must be f32 ({x_rows}, r ≥ 1), got "
                         f"{X.dtype} {tuple(X.shape)}")
    if not (Wp.device == X.device == means.device):
        raise ValueError(f"stack, {what} and means must share a device: "
                         f"{Wp.device}, {X.device}, {means.device}")
    if Wp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {Wp.device}")
    if Wp.device.type == "cuda" and not (Wp.is_contiguous()
                                         and X.is_contiguous()
                                         and means.is_contiguous()):
        raise ValueError("CUDA operands must be contiguous")
    if max(p, n, X.shape[1]) >= 2**31:
        raise ValueError("p, n and r must each fit the kernels' int32")


def _raise_on(rc: int, name: str, lib) -> None:
    if rc != 0:
        msg = getattr(lib, f"ee_{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def _dot_lib():
    from eagleeverything_tpu_torch.ops import build
    lib = build.load("packed_dot")
    for fn, nargs in (("ee_packed_dot_split_pieces", 0),
                      ("ee_packed_dot_split_rows", 1),
                      ("ee_packed_dot_split_cols", 1),
                      ("ee_packed_dot_narrow_rows", 1)):
        getattr(lib, fn).argtypes = [ctypes.c_int] * nargs
        getattr(lib, fn).restype = ctypes.c_int
    for fn in ("ee_packed_dot", "ee_packed_dot_narrow"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _tdot_lib():
    from eagleeverything_tpu_torch.ops import build
    lib = build.load("packed_tdot")
    for fn, nargs in (("ee_packed_tdot_splits", 3),
                      ("ee_packed_tdot_split_rows", 1),
                      ("ee_packed_tdot_split_cols", 1)):
        getattr(lib, fn).argtypes = [ctypes.c_int] * nargs
        getattr(lib, fn).restype = ctypes.c_int
    lib.ee_packed_tdot.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    lib.ee_packed_tdot.restype = ctypes.c_int
    return lib


def packed_dot(Wp: torch.Tensor, A: torch.Tensor, means: torch.Tensor,
               n: int) -> torch.Tensor:
    """D = W·A: (p, r) f32 for the stack Wp (p, nw) and A (n, r) f32."""
    _check(Wp, A, means, n, n, "A")
    if Wp.device.type == "cpu":
        return packed_dot_plain(Wp, A, means, n)
    lib = _dot_lib()
    p, nw = Wp.shape
    r = A.shape[1]
    path = k1_path(p, lib.ee_packed_dot_narrow_rows(r),
                   torch.cuda.get_device_properties(
                       Wp.device).multi_processor_count,
                   Wp.data_ptr() % 16 == 0)
    launch = lib.ee_packed_dot_narrow if path == "narrow" else lib.ee_packed_dot
    # launch on the operands' card, whichever card is current
    with torch.cuda.device(Wp.device):
        D = torch.empty((p, r), dtype=torch.float32, device=A.device)
        # the bf16 pieces of A, written by the kernel's own pre-pass
        split = torch.empty((lib.ee_packed_dot_split_pieces(),
                             lib.ee_packed_dot_split_rows(n),
                             lib.ee_packed_dot_split_cols(r)),
                            dtype=torch.bfloat16, device=A.device)
        rc = launch(Wp.data_ptr(), A.data_ptr(), means.data_ptr(),
                    split.data_ptr(), D.data_ptr(), p, nw, n, r,
                    torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "packed_dot", lib)
    LAUNCHES["packed_dot"] += 1
    K1_PATHS[path] += 1
    return D


def packed_tdot(Wp: torch.Tensor, T: torch.Tensor, means: torch.Tensor,
                n: int) -> torch.Tensor:
    """Wᵀ·T: (n, r) f32 for the stack Wp (p, nw) and T (p, r) f32."""
    _check(Wp, T, means, n, Wp.shape[0] if Wp.dim() == 2 else -1, "T")
    if Wp.device.type == "cpu":
        return packed_tdot_plain(Wp, T, means, n)
    lib = _tdot_lib()
    p, nw = Wp.shape
    r = T.shape[1]
    # the split count reads the current card's SM count, and the launch
    # goes to the current card: make that the operands' card
    with torch.cuda.device(Wp.device):
        nsplit = lib.ee_packed_tdot_splits(p, n, r)
        out = torch.empty((n, r), dtype=torch.float32, device=T.device)
        part = (torch.empty((nsplit, n, r), dtype=torch.float32,
                            device=T.device) if nsplit > 1 else out)
        # T_hi and T_lo, written by the kernel's own pre-pass
        split = torch.empty((2, lib.ee_packed_tdot_split_rows(p),
                             lib.ee_packed_tdot_split_cols(r)),
                            dtype=torch.bfloat16, device=T.device)
        rc = lib.ee_packed_tdot(Wp.data_ptr(), T.data_ptr(), means.data_ptr(),
                                split.data_ptr(), part.data_ptr(),
                                out.data_ptr(), p, nw, n, r,
                                nsplit, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "packed_tdot", lib)
    LAUNCHES["packed_tdot"] += 1
    return out


def kernel_matvec(Wp: torch.Tensor, V: torch.Tensor, means: torch.Tensor,
                  n: int) -> torch.Tensor:
    """K·V = Wᵀ(W·V), (n, r): one packed_dot then one packed_tdot."""
    _check(Wp, V, means, n, n, "V")
    if Wp.device.type == "cpu":
        return kernel_matvec_plain(Wp, V, means, n)
    return packed_tdot(Wp, packed_dot(Wp, V, means, n), means, n)
