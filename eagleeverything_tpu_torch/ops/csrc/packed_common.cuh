// Shared pieces of the packed-stack kernels (packed_dot.cu, packed_tdot.cu).
//
// The stack is int32 (p, nw): word w of SNP row i holds genotypes
// j = 16w + k at bits 2k (a little-endian view of the store's 2-bit byte
// stream). Codes 0/1/2 recode to dose - 1 and code 3 (missing) to the SNP's
// mean dose - 1. Genotype positions j >= n in a row's last word are never
// allowed to reach an output: packed_dot multiplies them by rows of zeros
// in its A planes, packed_tdot drops those output rows.
//
// Numerics, both kernels. They run on the bf16 tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 accumulate) with every operand split into bf16
// pieces whose products are exact in fp32: W_hi = bf16(W) is exact for
// codes 0/1/2 (-1, 0, +1) and is bf16(mean - 1) at a missing code, W_lo =
// bf16((mean - 1) - W_hi) there and 0 elsewhere (an all-missing SNP has mean
// 1, so both are 0 and its W is exactly 0). A pre-pass splits the skinny
// operand X into P pieces, X_0 = bf16(X) and each next piece the bf16 of
// what is left, and the MMAs form W_hi·X_0 + ... + W_hi·X_{P-1} + W_lo·X_0
// (split_kstep).
//   packed_tdot: P = 2 (bf16x3): T is kept to 16 bits, about 2^-17 of each
//     term, as is the dropped W_lo·T_1.
//   packed_dot: P = 3 (four products): A is kept to 24 bits, as in fp32.
//     Its rounding error is one vector dA, so D's error is W·dA, and in
//     kernel_matvec K·dA: K = WᵀW amplifies it along its top eigenvectors
//     (with A in two pieces, past the tolerance an exact packed_dot meets:
//     tests/test_torch_packed.py::test_kernel_matvec_split_numerics).
// The tensor cores' own accumulation is not IEEE fp32, so each tile's
// 32-deep k-step is summed by its MMAs into a fresh accumulator and added to
// the running sum with an fp32 add (add_rn). No TF32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ee {

constexpr int kThreads = 256;        // threads per block
constexpr int kTile = 128;           // MMA rows (the m side) per block
constexpr int kKStep = 32;           // contraction depth per k-step (2 x k16)

// low and high bytes of the bf16 values of codes 0/1/2 (-1, 0, +1) in
// bytes 0-2; byte 3 (code 3, missing) is the SNP's own
constexpr uint32_t kLutLow = 0x00800080u;
constexpr uint32_t kLutHigh = 0x003F00BFu;

// ---------------------------------------------------------------------------
// copies, fragments and MMAs
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async to a shared-memory address (bytes); cp_async4 zero-fills the
// destination when !valid (src is not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `kPending` of this thread's groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// ldmatrix at a shared-memory address (bytes), plain and .trans
__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&d)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&d)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(d[0]), "=r"(d[1])
      : "r"(addr)
      : "memory");
}

// c += a·b, m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a·b, m16n8k16, starting from a zero accumulator
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// c += d with round-to-nearest fp32 adds.
//
// The tensor cores do not add into their accumulator in IEEE fp32 round to
// nearest (they align the addends and drop the bits shifted out), so one
// accumulator chained over tens of thousands of contraction rows is not an
// fp32 sum and its error grows with the length. So the products of a
// tile's 32-deep k-step (2(P + 1) MMAs, split_kstep) are summed into a fresh
// accumulator d, which is added to the tile's fp32 sum here, as a plain
// fp32 loop over the k-steps would. The adds are asm volatile so that they stay in place among
// the MMAs: otherwise the compiler holds every tile's d live to the end of
// the k-step (72 more registers at N = 144).
__device__ __forceinline__ void add_rn(float (&c)[4], const float (&d)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    asm volatile("add.rn.f32 %0, %0, %1;\n" : "+f"(c[q]) : "f"(d[q]));
  }
}

// ---------------------------------------------------------------------------
// the unpack: one packed word -> sixteen bf16 values of each W plane
// ---------------------------------------------------------------------------

// eight 2-bit codes (bits 2k of x, k < 8) -> one code a nibble (bits 4k):
// the byte selectors of __byte_perm, four codes to a 16-bit half
__device__ __forceinline__ uint32_t spread_codes(uint32_t x) {
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  return (x | (x << 2)) & 0x33333333u;
}

// sixteen codes (one packed word) -> sixteen bf16 values, two a word, from
// the per-row tables lut_l / lut_h: byte k of each holds the low / high
// byte of the value of code k. One table lookup is one byte permute.
__device__ __forceinline__ void unpack_word(uint32_t sel_lo, uint32_t sel_hi,
                                            uint32_t lut_l, uint32_t lut_h,
                                            uint32_t (&out)[8]) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const uint32_t sel = g < 2 ? (g == 0 ? sel_lo : sel_lo >> 16)
                               : (g == 2 ? sel_hi : sel_hi >> 16);
    const uint32_t lows = __byte_perm(lut_l, 0u, sel);
    const uint32_t highs = __byte_perm(lut_h, 0u, sel);
    out[2 * g] = __byte_perm(lows, highs, 0x5140);
    out[2 * g + 1] = __byte_perm(lows, highs, 0x7362);
  }
}

// One SNP's byte tables of both W planes: W_hi is -1/0/+1 and bf16(mean - 1)
// at code 3; W_lo is 0 and, at code 3, the rounding residual of mean - 1.
struct CodeLut {
  uint32_t hi_l, hi_h, lo_l, lo_h;
};

__device__ __forceinline__ CodeLut code_lut(float mean_m1) {
  const __nv_bfloat16 mh = __float2bfloat16_rn(mean_m1);
  const __nv_bfloat16 ml = __float2bfloat16_rn(mean_m1 - __bfloat162float(mh));
  const uint32_t mhb = __bfloat16_as_ushort(mh);
  const uint32_t mlb = __bfloat16_as_ushort(ml);
  return {kLutLow | ((mhb & 0xFFu) << 24), kLutHigh | ((mhb >> 8) << 24),
          (mlb & 0xFFu) << 24, (mlb >> 8) << 24};
}

// one packed word -> its sixteen genotypes in both planes, natural order
__device__ __forceinline__ void unpack_planes(uint32_t word,
                                              const CodeLut& lut,
                                              uint32_t (&hi)[8],
                                              uint32_t (&lo)[8]) {
  const uint32_t sel_lo = spread_codes(word & 0xFFFFu);
  const uint32_t sel_hi = spread_codes(word >> 16);
  unpack_word(sel_lo, sel_hi, lut.hi_l, lut.hi_h, hi);
  unpack_word(sel_lo, sel_hi, lut.lo_l, lut.lo_h, lo);
}

// ---------------------------------------------------------------------------
// the warp tiling of a 128 x N block tile and its k-step of MMAs
// ---------------------------------------------------------------------------

// Column tiles come in steps of 8 (the MMA's N): N = 8, 16, 32, 64 or 144,
// the least that covers r, so r = 137 is one tile and r = 2 pays for 8
// columns. r > 144 takes several 144-wide tiles.
inline int mma_tile_width(int r) {
  return r <= 8 ? 8 : r <= 16 ? 16 : r <= 32 ? 32 : r <= 64 ? 64 : 144;
}

// The eight warps of a block tile its kTile x N output as WM x WN: 4 x 2
// (2 m16 tiles x N/16 columns each) or, for an odd number of n8 tiles, 8 x 1.
template <int N_>
struct MmaTile {
  static constexpr int N = N_;
  static constexpr int WN = (N / 8) % 2 == 0 ? 2 : 1;  // warps along columns
  static constexpr int WM = 8 / WN;                     // warps along rows
  static constexpr int NT = N / 8 / WN;                 // n8 tiles a warp
  static constexpr int MT = kTile / 16 / WM;            // m16 tiles a warp
  // row stride of an N-wide bf16 tile of the skinny operand: an odd number
  // of 16-byte units, so the eight rows an ldmatrix reads hit distinct banks
  static constexpr int LD = (N / 8) % 2 == 0 ? N + 8 : N + 16;
  static_assert(N % 8 == 0 && WM * MT * 16 == kTile, "tiling");
};

// One 32-deep k-step of a warp's MT x NT tiles, summed into one fresh
// partial a tile and added to acc: given the A fragments of both k16
// halves of the step (ah: W_hi, al: W_lo) and this lane's ldmatrix row
// address b in the step's piece X_0 of the skinny operand (row-major
// kKStep x Tile::LD bf16 tiles, piece q at b + q * plane_bytes). The MMAs
// form W_hi·X_0 + ... + W_hi·X_{P-1} + W_lo·X_0 for P = kPieces. For each
// pair of n8 tiles: the B fragments, then P + 1 rounds of MMAs over the
// pair's tiles and both halves (independent MMAs between the dependent
// ones) into d, then the fp32 adds.
template <class Tile, int kPieces>
__device__ __forceinline__ void split_kstep(
    float (&acc)[Tile::MT][Tile::NT][4],
    const uint32_t (&ah)[2][Tile::MT][4],
    const uint32_t (&al)[2][Tile::MT][4], uint32_t b, uint32_t plane_bytes) {
  constexpr int MT = Tile::MT;
  constexpr int NT = Tile::NT;
#pragma unroll
  for (int nt = 0; nt + 1 < NT; nt += 2) {
    float d[MT][2][4];
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      const uint32_t o = (kh * 16 * Tile::LD + nt * 8) * 2;
      uint32_t bx[kPieces][4];
#pragma unroll
      for (int q = 0; q < kPieces; ++q) ldsm_x4_t(bx[q], b + o + q * plane_bytes);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (kh == 0) {
            mma_bf16_zero(d[mt][h], ah[kh][mt], bx[0][2 * h], bx[0][2 * h + 1]);
          } else {
            mma_bf16(d[mt][h], ah[kh][mt], bx[0][2 * h], bx[0][2 * h + 1]);
          }
        }
#pragma unroll
      for (int q = 1; q < kPieces; ++q)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            mma_bf16(d[mt][h], ah[kh][mt], bx[q][2 * h], bx[q][2 * h + 1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mma_bf16(d[mt][h], al[kh][mt], bx[0][2 * h], bx[0][2 * h + 1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) add_rn(acc[mt][nt + h], d[mt][h]);
  }
  if constexpr (NT % 2 == 1) {
    float d[MT][4];
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      const uint32_t o = (kh * 16 * Tile::LD + (NT - 1) * 8) * 2;
      uint32_t bx[kPieces][2];
#pragma unroll
      for (int q = 0; q < kPieces; ++q) ldsm_x2_t(bx[q], b + o + q * plane_bytes);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (kh == 0) {
          mma_bf16_zero(d[mt], ah[kh][mt], bx[0][0], bx[0][1]);
        } else {
          mma_bf16(d[mt], ah[kh][mt], bx[0][0], bx[0][1]);
        }
      }
#pragma unroll
      for (int q = 1; q < kPieces; ++q)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_bf16(d[mt], ah[kh][mt], bx[q][0], bx[q][1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma_bf16(d[mt], al[kh][mt], bx[0][0], bx[0][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) add_rn(acc[mt][NT - 1], d[mt]);
  }
}

// ---------------------------------------------------------------------------
// the pre-pass that splits the skinny operand
// ---------------------------------------------------------------------------

// Rows and columns of each bf16 plane of a (rows, r) skinny operand: rows
// padded to the k-step, columns to whole column tiles, so that every tile
// copy is an aligned, unguarded 16-byte cp.async.
inline int split_rows(int rows) { return (rows + kKStep - 1) / kKStep * kKStep; }

inline int split_cols(int r) {
  const int bn = mma_tile_width(r);
  return (r + bn - 1) / bn * bn;
}

namespace {

// X (rows, cols) f32 -> kPieces bf16 planes (rows_pad, ld), one after the
// other: X_0 = bf16(X), X_q = bf16(X - X_0 - ... - X_{q-1}) (each remainder
// is exact in fp32); rows i >= rows and columns c >= cols are zero
template <int kPieces>
__global__ void __launch_bounds__(kThreads)
split_bf16_kernel(const float* __restrict__ X,
                  __nv_bfloat16* __restrict__ planes, int rows, int cols,
                  int rows_pad, int ld) {
  const size_t count = (size_t)rows_pad * ld;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < count;
       e += stride) {
    const int i = static_cast<int>(e / ld);
    const int c = static_cast<int>(e % ld);
    float v = (i < rows && c < cols) ? X[(size_t)i * cols + c] : 0.0f;
#pragma unroll
    for (int q = 0; q < kPieces; ++q) {
      const __nv_bfloat16 h = __float2bfloat16_rn(v);
      planes[q * count + e] = h;
      v -= __bfloat162float(h);
    }
  }
}

}  // namespace

inline unsigned grid_1d(size_t count) {
  const size_t blocks = (count + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 4096 ? blocks : 4096);
}

}  // namespace ee
