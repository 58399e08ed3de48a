// packed_tdot: out = Wᵀ·T over the resident 2-bit packed genotype stack,
// on the bf16 tensor cores with fp32-accurate products (bf16x3).
//
// Replaces the TPU kernel eagleeverything_tpu/ops/pallas_packed.py::
// packed_tdot (:203; body _tdot_kernel :181).
//
//   Wp    int32 (p, nw)  packed stack, nw = ceil(ceil(n/4)/4) words a row
//   T     f32   (p, r)   one row per SNP
//   means f32   (p,)     per-SNP mean dose (the missing-code impute value)
//   out   f32   (n, r)   out[j, c] = sum_i W[i, j] T[i, c], natural order
//
// Numerics. Every product is split into bf16 halves whose products are
// exact in fp32: W_hi = bf16(W) is exact for codes 0/1/2 (-1, 0, 1) and is
// bf16(mean - 1) at a missing code, W_lo = bf16((mean - 1) - W_hi) there and
// 0 elsewhere (an all-missing SNP has mean 1, so both are 0); T_hi = bf16(T),
// T_lo = bf16(T - T_hi). The MMAs form W_hi·T_hi + W_hi·T_lo + W_lo·T_hi;
// the dropped W_lo·T_lo and the rounding of T_lo are about 2^-17 of each
// term. The tensor cores' own accumulation is not IEEE fp32, so each tile's
// k-step is summed by the MMAs into a fresh accumulator and added to its
// running sum with an fp32 add (add_rn below). No TF32.
//
// Structure. A pre-pass (split_t_kernel) writes T_hi and T_lo once per
// launch into two bf16 (p_pad, ldt) scratch planes: rows padded with zeros
// to a multiple of the 32-row k-step and columns to whole column tiles, so
// every tile copy below is an aligned, unguarded 16-byte cp.async. The main
// kernel runs 256 threads a block, one block per (128-genotype tile, column
// tile, split of the p rows). Blocks run in no order, so the p rows are
// split (a split-K) and a second launch adds the splits in a fixed order: no
// float atomics, so the result is bitwise repeatable run to run (CG
// residuals and near-tie argmaxes depend on it).
//
// A block walks its rows in 32-row k-steps through a ring of S shared-memory
// stages filled by cp.async (the step's packed words, row means and T_hi /
// T_lo tiles), S - 1 steps ahead, and two buffers of the unpacked W tile.
// One barrier a step; after it each thread
//   1. issues the copy of step t + S - 1;
//   2. unpacks one packed word of step t + 1 into both bf16 planes of the
//      k-major 32 x 128 W tile (byte permutes through a per-SNP table, two
//      16-byte stores a plane);
//   3. runs step t on the tensor cores: mma.sync m16n8k16 (bf16 in, fp32
//      accumulate), A by ldmatrix.trans from the k-major W tile, B by
//      ldmatrix.trans from the row-major T tile, six MMAs a tile a step. The
//      eight warps tile the 128 x N block as 4 x 2 (2 m16 tiles x N/16
//      columns each) or, for N = 8, as 8 x 1.
// Row strides are an odd number of 16-byte units, so the eight rows an
// ldmatrix reads, and the quarter-warp's 16-byte stores of the unpack, hit
// distinct banks.
//
// Column tiles come in steps of 8 (the MMA's N): N = 8, 16, 32, 64 or 144,
// the least that covers r, so r = 137 is one tile (each genotype tile is
// unpacked once) and r = 2 pays for 8 columns. r > 144 takes several
// 144-wide tiles.
//
// Bound on an H100 SXM: the function's 2·p·n·r FLOPs at the dense bf16
// tensor-core peak of 989 TFLOP/s against the stack's p·nw·4 bytes (plus T,
// means and out) at 3.35 TB/s: bytes-bound up to r of about 37,
// operations-bound above (3.6 ms at n = 50 000, p = 262 144, r = 137). The
// kernel executes three such products, 3x the bound's FLOPs. Shared memory
// is the likely limit beyond that: each k-step moves the W tile through it
// twice (unpack stores, ldmatrix loads) and every warp reads its B
// fragments, about 142 KB a step at N = 144 against some 1300 cycles of
// MMAs (counted from the code, not measured). T is read again by every
// genotype tile (about 56 GB
// of L2 traffic at r = 137, 391 tiles); the grid walks the genotype tiles
// fastest, so the blocks resident together belong to one split and stream
// the same T rows through L2. A 256-genotype tile would halve that traffic
// but needs 144 accumulators a thread at N = 144 (with 256 threads), which
// the register file cannot hold, so the tile stays at 128 genotypes.
#include <cuda_bf16.h>

#include "packed_common.cuh"

namespace ee {
namespace {

constexpr int kKR = 32;              // SNP rows per k-step
constexpr int kWords = kTile / 16;   // packed words of a block's genotypes
constexpr int kWordLD = kWords + 1;  // row stride of the staged words
constexpr int kWLD = kTile + 8;      // row stride of the W planes (17 units)
constexpr int kWPlane = kKR * kWLD;  // bf16 elements of one W plane
constexpr int kWBytes = 2 * 2 * kWPlane * 2;  // two buffers of W_hi, W_lo
static_assert(kKR * kWords == kThreads, "one packed word per thread");

// low and high bytes of the bf16 values of codes 0/1/2 (-1, 0, +1) in
// bytes 0-2; byte 3 (code 3, missing) is the SNP's own
constexpr uint32_t kLutLow = 0x00800080u;
constexpr uint32_t kLutHigh = 0x003F00BFu;

// The warp tiling of a 128 x N block tile, its ring of stages and the
// resident blocks per SM that its registers are held to.
template <int N_>
struct TdotTile {
  static constexpr int N = N_;
  static constexpr int WN = (N / 8) % 2 == 0 ? 2 : 1;  // warps along columns
  static constexpr int WM = 8 / WN;                     // warps along rows
  static constexpr int NT = N / 8 / WN;                 // n8 tiles a warp
  static constexpr int MT = kTile / 16 / WM;            // m16 tiles a warp
  // row stride of a T tile: an odd number of 16-byte units
  static constexpr int LDT = (N / 8) % 2 == 0 ? N + 8 : N + 16;
  static constexpr int kTBytes = kKR * LDT * 2;         // one plane
  static constexpr int kStageBytes =
      2 * kTBytes + kKR * kWordLD * 4 + kKR * 4;
  // N = 144 needs about 210 registers a thread (72 accumulators, the A
  // fragments of a whole k-step, one pair's B fragments and d): held to
  // 128 for two blocks an SM, ptxas spills, so one block an SM runs it, with
  // a deeper ring. The narrower tilings fit two or three blocks an SM.
  static constexpr int kMinBlocks = N == 144 ? 1 : 2;
  static constexpr int kStages = N == 144 ? 6 : N == 64 ? 6 : 8;
  static constexpr int kSmemBytes = kWBytes + kStages * kStageBytes;
  static_assert(N % 8 == 0 && WM * MT * 16 == kTile, "tiling");
  static_assert(kStageBytes % 16 == 0, "16-byte aligned stages");
  static_assert(kStages >= 3, "the ring keeps two stages in flight");
};

inline int tdot_tile_width(int r) {
  return r <= 8 ? 8 : r <= 16 ? 16 : r <= 32 ? 32 : r <= 64 ? 64 : 144;
}

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

// ldmatrix .trans at a shared-memory address (bytes)
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
// accumulator chained over a split's tens of thousands of rows is not an
// fp32 sum and its error grows with the split. So the 96
// products of a tile's 32-row k-step (six MMAs) are summed into a fresh
// accumulator d, which is added to the tile's fp32 sum here, as a plain
// fp32 loop over the k-steps would. The adds are asm volatile
// so that they stay in place among the MMAs: otherwise the compiler holds
// every tile's d live to the end of the k-step (72 more registers at
// N = 144).
__device__ __forceinline__ void add_rn(float (&c)[4], const float (&d)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    asm volatile("add.rn.f32 %0, %0, %1;\n" : "+f"(c[q]) : "f"(d[q]));
  }
}

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

// T_hi/T_lo planes (p_pad, ldt): rows i >= p and columns c >= r are zero
__global__ void __launch_bounds__(kThreads)
split_t_kernel(const float* __restrict__ T, __nv_bfloat16* __restrict__ Thi,
               __nv_bfloat16* __restrict__ Tlo, int p, int r, int p_pad,
               int ldt) {
  const size_t count = (size_t)p_pad * ldt;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < count;
       e += stride) {
    const int i = static_cast<int>(e / ldt);
    const int c = static_cast<int>(e % ldt);
    const float v = (i < p && c < r) ? T[(size_t)i * r + c] : 0.0f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    Thi[e] = hi;
    Tlo[e] = __float2bfloat16_rn(v - __bfloat162float(hi));
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, TdotTile<N>::kMinBlocks)
packed_tdot_kernel(const int32_t* __restrict__ Wp,
                   const __nv_bfloat16* __restrict__ Thi,
                   const __nv_bfloat16* __restrict__ Tlo, int ldt,
                   const float* __restrict__ means, float* __restrict__ part,
                   int p, int nw, int n, int r, int rows_per_split) {
  using C = TdotTile<N>;
  constexpr int S = C::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  // W planes, k-major, two buffers: w_hi(u)[k * kWLD + m] is genotype m of
  // the tile in SNP row k of the k-step unpacked into buffer u
  auto w_hi = [&](int u) {
    return reinterpret_cast<__nv_bfloat16*>(smem) + u * 2 * kWPlane;
  };
  auto w_lo = [&](int u) { return w_hi(u) + kWPlane; };
  unsigned char* const stages = smem + kWBytes;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % C::WM;
  const int wn = warp / C::WM;
  const int j0 = blockIdx.x * kTile;          // first genotype of the tile
  const int col0 = blockIdx.y * N;
  const int i_begin = blockIdx.z * rows_per_split;
  const int i_end = min(p, i_begin + rows_per_split);
  const int nsteps = i_end > i_begin ? (i_end - i_begin + kKR - 1) / kKR : 0;

  // stage layout: T_hi tile, T_lo tile (LDT-strided rows), packed words,
  // row means
  auto words = [&](int b) {
    return reinterpret_cast<uint32_t*>(stages + b * C::kStageBytes +
                                       2 * C::kTBytes);
  };
  auto row_means = [&](int b) {
    return reinterpret_cast<float*>(words(b) + kKR * kWordLD);
  };

  // one cp.async group a call: k-step t into stage t % S (an empty group
  // past the last step, so that every thread counts groups alike)
  const uint32_t stage0 = smem_addr(stages);
  auto issue = [&](int t) {
    if (t < nsteps) {
      const uint32_t sb = stage0 + (t % S) * C::kStageBytes;
      const int i0 = i_begin + t * kKR;
      {
        // packed words: eight neighbouring threads read one row's 32 bytes;
        // rows i >= p and words w >= nw are zero-filled (their W reaches no
        // output: T is zero there, or the genotypes j >= n are dropped)
        const int rr = tid / kWords;
        const int kw = tid % kWords;
        const int i = i0 + rr;
        const int w = j0 / 16 + kw;
        const bool ok = i < p && w < nw;
        cp_async4(sb + 2 * C::kTBytes + (rr * kWordLD + kw) * 4,
                  ok ? Wp + (size_t)i * nw + w : Wp, ok);
      }
      if (tid < kKR) {
        const int i = i0 + tid;
        cp_async4(sb + 2 * C::kTBytes + (kKR * kWordLD + tid) * 4,
                  i < p ? means + i : means, i < p);
      }
      // the T_hi and T_lo tiles, 16 bytes a copy
      constexpr int kChunks = kKR * N / 8;    // 16-byte chunks of a plane
      const size_t row0 = (size_t)i0 * ldt + col0;
      for (int e = tid; e < 2 * kChunks; e += kThreads) {
        const int plane = e / kChunks;
        const int q = e % kChunks;
        const int rr = q / (N / 8);
        const int c8 = (q % (N / 8)) * 8;
        cp_async16(sb + plane * C::kTBytes + (rr * C::LDT + c8) * 2,
                   (plane ? Tlo : Thi) + row0 + rr * ldt + c8);
      }
    }
    cp_async_commit();
  };

  // this thread's packed word in the unpack: row kr, word kw of the tile;
  // consecutive threads take consecutive rows, so the 16-byte stores of a
  // quarter-warp land on distinct banks (row stride 17 units)
  const int kr = tid % kKR;
  const int kw = tid / kKR;
  // k-step t's packed words (stage t % S) -> both W planes of buffer t & 1
  auto unpack = [&](int t) {
    const int b = t % S;
    const uint32_t word = words(b)[kr * kWordLD + kw];
    const float m1 = row_means(b)[kr] - 1.0f;
    const __nv_bfloat16 mh = __float2bfloat16_rn(m1);
    const __nv_bfloat16 ml = __float2bfloat16_rn(m1 - __bfloat162float(mh));
    const uint32_t mhb = __bfloat16_as_ushort(mh);
    const uint32_t mlb = __bfloat16_as_ushort(ml);
    const uint32_t sel_lo = spread_codes(word & 0xFFFFu);
    const uint32_t sel_hi = spread_codes(word >> 16);
    uint32_t hi[8], lo[8];
    // W_hi: -1/0/+1 and bf16(mean - 1); W_lo: 0 and its rounding residual
    unpack_word(sel_lo, sel_hi, kLutLow | ((mhb & 0xFFu) << 24),
                kLutHigh | ((mhb >> 8) << 24), hi);
    unpack_word(sel_lo, sel_hi, (mlb & 0xFFu) << 24, (mlb >> 8) << 24, lo);
    uint4* dh = reinterpret_cast<uint4*>(w_hi(t & 1) + kr * kWLD + kw * 16);
    uint4* dl = reinterpret_cast<uint4*>(w_lo(t & 1) + kr * kWLD + kw * 16);
    dh[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    dh[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    dl[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    dl[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
  };

  // this lane's ldmatrix rows: A (x4: four 8x8 blocks, k rows 0-7 / 8-15 x
  // genotypes 0-7 / 8-15 of the m16 tile) in W buffer 0, and B (x4: k rows
  // 0-7 / 8-15 x columns 0-7 / 8-15 of an n8 pair) in stage 0
  const uint32_t a_lane = smem_addr(w_hi(0)) +
      (((lane & 7) + ((lane >> 4) << 3)) * kWLD + wm * C::MT * 16 +
       ((lane >> 3) & 1) * 8) * 2;
  const uint32_t b_lane = smem_addr(stages) +
      (((lane & 7) + ((lane >> 3) & 1) * 8) * C::LDT + wn * C::NT * 8 +
       (lane >> 4) * 8) * 2;
  float acc[C::MT][C::NT][4] = {};
  // The ring: S - 1 k-steps in flight. At the top of step t the groups of
  // steps up to t + S - 2 have been issued; waiting until S - 3 are pending
  // lands step t + 1. One barrier a step then (a) shows step t + 1's stage
  // and step t's W buffer to every thread and (b) ends every warp's reads
  // of the previous step (its stage and the other W buffer), which the
  // step then refills: the copy of step t + S - 1 into stage (t - 1) % S
  // and the unpack of step t + 1 into W buffer (t + 1) & 1. Warps that
  // finish the unpack go on to step t's MMAs while others unpack.
  if (nsteps > 0) {
    for (int t = 0; t < S - 1; ++t) issue(t);
    cp_async_wait<S - 2>();
    __syncthreads();
    unpack(0);
  }
  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<S - 3>();
    __syncthreads();
    issue(t + S - 1);
    if (t + 1 < nsteps) unpack(t + 1);

    // shared-memory byte addresses of this lane's rows in step t's W
    // buffer and T stage; every fragment below is at a constant offset
    const uint32_t wa = a_lane + (t & 1) * (2 * kWPlane * 2);
    const uint32_t ta = b_lane + (t % S) * C::kStageBytes;
    // A fragments (16 genotypes x 16 SNP rows) of both halves of the
    // k-step from the k-major W tile
    uint32_t ah[2][C::MT][4], al[2][C::MT][4];
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
        const uint32_t o = (kh * 16 * kWLD + mt * 16) * 2;
        ldsm_x4_t(ah[kh][mt], wa + o);
        ldsm_x4_t(al[kh][mt], wa + o + kWPlane * 2);
      }
    }
    // For each pair of n8 tiles: B fragments (16 SNP rows x 8 columns) from
    // the row-major T tile, then three rounds of MMAs over the pair's tiles
    // and both halves (independent MMAs between the dependent ones) into d,
    // then the adds.
#pragma unroll
    for (int nt = 0; nt + 1 < C::NT; nt += 2) {
      float d[C::MT][2][4];
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const uint32_t o = (kh * 16 * C::LDT + nt * 8) * 2;
        uint32_t bh[4], bl[4];
        ldsm_x4_t(bh, ta + o);
        ldsm_x4_t(bl, ta + o + C::kTBytes);
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (kh == 0) {
              mma_bf16_zero(d[mt][h], ah[kh][mt], bh[2 * h], bh[2 * h + 1]);
            } else {
              mma_bf16(d[mt][h], ah[kh][mt], bh[2 * h], bh[2 * h + 1]);
            }
          }
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            mma_bf16(d[mt][h], ah[kh][mt], bl[2 * h], bl[2 * h + 1]);
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            mma_bf16(d[mt][h], al[kh][mt], bh[2 * h], bh[2 * h + 1]);
      }
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) add_rn(acc[mt][nt + h], d[mt][h]);
    }
    if constexpr (C::NT % 2 == 1) {
      float d[C::MT][4];
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const uint32_t o = (kh * 16 * C::LDT + (C::NT - 1) * 8) * 2;
        uint32_t bh[2], bl[2];
        ldsm_x2_t(bh, ta + o);
        ldsm_x2_t(bl, ta + o + C::kTBytes);
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt) {
          if (kh == 0) {
            mma_bf16_zero(d[mt], ah[kh][mt], bh[0], bh[1]);
          } else {
            mma_bf16(d[mt], ah[kh][mt], bh[0], bh[1]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt)
          mma_bf16(d[mt], ah[kh][mt], bl[0], bl[1]);
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt)
          mma_bf16(d[mt], al[kh][mt], bh[0], bh[1]);
      }
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) add_rn(acc[mt][C::NT - 1], d[mt]);
    }
  }
  cp_async_wait<0>();   // no copy outlives the block (the tail groups are empty)

  // accumulator (row g or g + 8, columns 2t and 2t + 1 of the n8 tile);
  // genotypes j >= n (the pad positions of the last word) are dropped
  float* out = part + (size_t)blockIdx.z * n * r;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      const int col = col0 + (wn * C::NT + nt) * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + (wm * C::MT + mt) * 16 + (lane >> 2) + 8 * h;
        if (j >= n) continue;
        if (col < r) out[(size_t)j * r + col] = acc[mt][nt][2 * h];
        if (col + 1 < r) out[(size_t)j * r + col + 1] = acc[mt][nt][2 * h + 1];
      }
    }
  }
}

// out[e] = sum over splits s = 0, 1, ... of part[s][e], in that order
__global__ void __launch_bounds__(kThreads)
reduce_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                     size_t count, int nsplit) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < count;
       e += stride) {
    float s = 0.0f;
    for (int k = 0; k < nsplit; ++k) s += part[(size_t)k * count + e];
    out[e] = s;
  }
}

inline unsigned grid_1d(size_t count) {
  const size_t blocks = (count + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 4096 ? blocks : 4096);
}

inline int split_rows(int p) { return (p + kKR - 1) / kKR * kKR; }

inline int split_cols(int r) {
  const int bn = tdot_tile_width(r);
  return (r + bn - 1) / bn * bn;
}

template <int N>
int launch(const int32_t* Wp, const float* T, const float* means,
           __nv_bfloat16* Thi, __nv_bfloat16* Tlo, float* part, float* out,
           int p, int nw, int n, int r, int nsplit, cudaStream_t stream) {
  const int p_pad = split_rows(p);
  const int ldt = split_cols(r);
  split_t_kernel<<<grid_1d((size_t)p_pad * ldt), kThreads, 0, stream>>>(
      T, Thi, Tlo, p, r, p_pad, ldt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int smem = TdotTile<N>::kSmemBytes;
  err = cudaFuncSetAttribute(packed_tdot_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rows = (p + nsplit - 1) / nsplit;
  rows = (rows + kKR - 1) / kKR * kKR;
  const dim3 grid((n + kTile - 1) / kTile, ldt / N, nsplit);
  packed_tdot_kernel<N><<<grid, kThreads, smem, stream>>>(
      Wp, Thi, Tlo, ldt, means, nsplit == 1 ? out : part, p, nw, n, r, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  const size_t count = (size_t)n * r;
  reduce_splits_kernel<<<grid_1d(count), kThreads, 0, stream>>>(part, out,
                                                                count, nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace ee

extern "C" {

// Shape of each of the two bf16 scratch planes (T_hi, T_lo) the caller
// allocates for an (p, r) T: split_rows(p) x split_cols(r).
int ee_packed_tdot_split_rows(int p) { return ee::split_rows(p); }
int ee_packed_tdot_split_cols(int r) { return ee::split_cols(r); }

// How many row ranges packed_tdot splits p into for an (n, r) output on
// the current device: about sixteen blocks per SM (several waves of the
// two or more blocks an SM holds, so the last wave is short), at least 256
// rows a split, at most 64 splits. The caller allocates nsplit*n*r floats
// of scratch.
int ee_packed_tdot_splits(int p, int n, int r) {
  int dev = 0;
  int sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int bn = ee::tdot_tile_width(r);
  const long tiles = (long)((n + ee::kTile - 1) / ee::kTile) *
                     ((r + bn - 1) / bn);
  long s = (16L * sms + tiles - 1) / tiles;
  const long by_rows = (p + 255) / 256;
  if (s > by_rows) s = by_rows;
  if (s > 64) s = 64;
  return s < 1 ? 1 : static_cast<int>(s);
}

// Launches on `stream`: the T split, the MMA kernel and (when nsplit > 1)
// the fixed-order reduce of the splits; `part` is unused when nsplit == 1.
// Returns the first CUDA error code (0 when every launch was accepted).
int ee_packed_tdot(const int32_t* Wp, const float* T, const float* means,
                   void* Thi, void* Tlo, float* part, float* out, int p,
                   int nw, int n, int r, int nsplit, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* th = static_cast<__nv_bfloat16*>(Thi);
  auto* tl = static_cast<__nv_bfloat16*>(Tlo);
  switch (ee::tdot_tile_width(r)) {
    case 8:
      return ee::launch<8>(Wp, T, means, th, tl, part, out, p, nw, n, r,
                           nsplit, s);
    case 16:
      return ee::launch<16>(Wp, T, means, th, tl, part, out, p, nw, n, r,
                            nsplit, s);
    case 32:
      return ee::launch<32>(Wp, T, means, th, tl, part, out, p, nw, n, r,
                            nsplit, s);
    case 64:
      return ee::launch<64>(Wp, T, means, th, tl, part, out, p, nw, n, r,
                            nsplit, s);
    default:
      return ee::launch<144>(Wp, T, means, th, tl, part, out, p, nw, n, r,
                             nsplit, s);
  }
}

const char* ee_packed_tdot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
