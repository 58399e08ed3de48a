// packed_dot: D = W·A over the resident 2-bit packed genotype stack, on the
// bf16 tensor cores with split bf16 products that keep fp32's precision.
//
// Replaces the TPU kernel eagleeverything_tpu/ops/pallas_packed.py::
// packed_dot (:142; body _dot_kernel :120, unpack _plane_w :111).
//
//   Wp    int32 (p, nw)  packed stack, nw = ceil(ceil(n/4)/4) words a row
//   A     f32   (n, r)   skinny operand, natural genotype order
//   means f32   (p,)     per-SNP mean dose (the missing-code impute value)
//   D     f32   (p, r)   D[i, c] = sum_j W[i, j] A[j, c]
//
// The TPU kernel permuted A into a "plane" order so that Mosaic never
// shuffled lanes. Here a thread turns one word into its sixteen genotypes
// j = 16w + k in natural order, so A is taken as it is.
//
// Numerics (packed_common.cuh): A in three bf16 pieces A_0 + A_1 + A_2 (24
// bits, as fp32), four products D = W_hi·A_0 + W_hi·A_1 + W_hi·A_2 +
// W_lo·A_0, the 32-genotype k-step of each tile summed by its MMAs from
// zero and added to the running sum with an IEEE fp32 add, so the sum over
// n = 50 000 genotypes is an fp32 sum of k-step partials. With A in two
// pieces (bf16x3, as packed_tdot) A's rounding is one fixed vector dA of up
// to 2^-16 |A|, and kernel_matvec's K = WᵀW amplifies W·dA along its top
// eigenvectors, past the tolerance that kernel_matvec with an exact
// packed_dot meets (tests/test_torch_packed.py::
// test_kernel_matvec_split_numerics). No TF32.
//
// Structure, wide design (packed_dot_kernel, every r). A pre-pass
// (split_bf16_kernel) writes the three pieces once per launch into three
// bf16 (n_pad, lda) scratch planes, one after the other, that the wrapper
// allocates: rows padded with zeros to the 32-genotype k-step and columns
// to whole column tiles, so every tile copy below is an aligned, unguarded
// 16-byte cp.async. Rows j >= n are zero, so the pad genotypes of a row's
// last word (code 0, W = -1) and the zero-filled words past nw add nothing.
// The main kernel runs 256 threads a block, one block per (128-SNP row
// tile, column tile). p = 262 144 rows give 2048 row tiles, enough blocks
// to fill the card without splitting the genotypes, so there is no split-K
// and no reduce launch: each output element is summed by one thread, from
// MMAs in one fixed order over the k-steps, so the result is bitwise
// repeatable run to run (no float atomics; CG residuals and near-tie argmaxes
// depend on it).
//
// A block walks the genotypes in 32-genotype k-steps (two packed words a
// row) through a ring of S shared-memory stages filled by cp.async (the
// step's packed words and the three A tiles), S - 1 steps ahead, and two
// buffers of the unpacked W tile. One barrier a step; after it each thread
//   1. issues the copy of step t + S - 1;
//   2. unpacks one packed word of step t + 1 into both bf16 planes of the
//      row-major 128 x 32 W tile (byte permutes through the SNP's table,
//      two 16-byte stores a plane). A thread's SNP row is the same in every
//      step, so its table is built once, before the loop;
//   3. runs step t on the tensor cores (split_kstep): A by plain ldmatrix
//      from the row-major W tile, B by ldmatrix.trans from the row-major A
//      tiles, eight MMAs a tile a step, over the warp tiling of DotTile.
// Row strides of the W tile (5 units) and the A tiles are an odd number of
// 16-byte units, so the eight rows an ldmatrix reads, and the quarter-warp's
// 16-byte stores of the unpack, hit distinct banks. Column tiles:
// mma_tile_width (N = 8 ... 144; r = 137 is one tile, so each W tile is
// unpacked once; r = 2 pays for 8 columns).
//
// Bound on an H100 SXM: the function's 2·p·n·r FLOPs at the dense bf16
// tensor-core peak of 989 TFLOP/s against the stack's p·nw·4 bytes (plus A,
// means and D) at 3.35 TB/s: bytes-bound up to r of about 37,
// operations-bound above (3.6 ms at n = 50 000, p = 262 144, r = 137). The
// kernel executes four such products. As in packed_tdot, shared memory is
// the likely limit beyond that (the W tile passes through it twice and
// every warp along the rows reads the same B fragments). A is read again by
// every row tile (43.2 MB of bf16 planes at r = 137, so about 88 GB of L2
// traffic over 2048 row tiles); the grid walks the row tiles fastest, so
// the blocks resident together stream the same A tiles through L2.
//
// The narrow design (packed_dot_narrow_kernel, column tiles N <= 32: r <=
// 32). At these widths the wide design runs at 7-9% of its bound whatever
// r, paced by shared memory: each 1 KB of packed words costs ~32 KB of
// unpacked W written and read back as A fragments, plus eight warps reading
// the same B fragments. The narrow design stages only the packed words and
// the A pieces, through the same cp.async ring, KS k-steps a stage (one
// barrier for KS k-steps). Each lane unpacks its own A fragments in
// registers: in the m16n8k16 A fragment, lane (g, t) holds genotypes {2t,
// 2t+1, 2t+8, 2t+9} of rows g and g + 8 in each k16, nibbles t and t + 4 of
// the row's word, which row_frag turns into bf16 pairs of W_hi and W_lo by
// byte permutes through two table words a row (ten integer instructions a
// row a k16 half); four lanes read each word. Each warp holds MT m16 tiles
// of rows by all N columns, so every B fragment, ldmatrix.trans'd once a
// k16 half, feeds MT x 4 MMAs. The packed words come in 16-byte chunks:
// rows start o = row·nw mod 4 words past an aligned word, so each row
// stages KS / 2 + 1 chunks and its lanes read from offset o, the same o
// for every row of a lane's; bytes past a row's end are zero-filled, as the
// wide design's 4-byte copies of words past nw are.
//
// Its bits. The narrow kernel takes the same A pieces (the same pre-pass
// and scratch) and W_hi, W_lo values (code_lut's), keeps the genotype-to-k
// mapping, and forms each k-step's partial of each output element from
// zero by the same eight MMAs in the same order (split_kstep's), added to
// the running sum by the same fp32 add, over the k-steps in ascending
// order in one thread. The MMA's result for an element depends only on its
// row of A, its column of B and its accumulator, so the row blocking and
// the interleaving across tiles change nothing: D is the wide design's bit
// for bit (tests/test_torch_cuda.py holds every narrow width to the wide
// kernel's columns, ragged shapes and an all-missing SNP included).
//
// What bounds it (H100 80GB HBM3, 700 W; 50 000 x 262 144): not bytes (the
// stack streams at 0.3-0.8 TB/s). On this card mma.sync and the integer
// unpack do not overlap: alone, m16n8k16 bf16 MMAs run at ~640 TFLOP/s
// (~6.7 cycles an MMA an SM sub-partition), and each byte permute beside
// them adds ~2 cycles. So a tile's time is about the sum of its MMAs and its
// integer work. At N = 8 (r = 8: 4.37 ms, 22% of the bound; the wide design
// 10.58) the unpack's work per MMA is largest: removing it saves ~0.55 ms,
// half the MMAs ~0.75 ms, the word copy ~1.0 ms (as 4-byte copies; 16-byte
// chunks took back ~0.15 ms of it). At N = 32 (r = 32: 10.99 ms, 9%; wide
// 13.85) the four products dominate: half of them take ~5 ms. The tilings
// (NarrowTile) are the fastest that ptxas compiles without a spill; at N =
// 32 the spilling two-block tiling ran 9.7 ms.
//
// Where it runs (packed.k1_path): at r <= 32 where its row blocks number at
// least half the SMs. Under that, one block sets the time, and a narrow
// block of 512 rows (N = 16) or of 32 columns takes longer than a wide one
// of 128 rows: at 50 000 x 2 048, r = 16 / 32, 1.54 / 1.38 ms against 0.96
// / 1.20 (at N = 8, 0.70 against 0.81). Above it the narrow design wins at
// every width, config 4's n axis (500 000 x 32 768) included: r = 8 / 32,
// 7.0 / 13.4 ms against 13.2 / 17.1.
#include "packed_common.cuh"

namespace ee {
namespace {

constexpr int kAPieces = 3;          // bf16 pieces of A
constexpr int kKC = kKStep;          // genotypes per k-step
constexpr int kKW = kKC / 16;        // packed words a row per k-step
// staged words, word kw of row i at kw * kWordLD + i: the copy's warp (16
// rows x 2 words) and the unpack's warp (32 rows, one word) hit 32 banks
constexpr int kWordLD = kTile + 16;
constexpr int kWLD = kKC + 8;        // row stride of the W planes (5 units)
constexpr int kWPlane = kTile * kWLD;  // bf16 elements of one W plane
constexpr int kWBytes = 2 * 2 * kWPlane * 2;  // two buffers of W_hi, W_lo
static_assert(kTile * kKW == kThreads, "one packed word per thread");

// The stage layout of a 128-SNP x N block tile, its ring of stages and the
// resident blocks per SM that its registers are held to. N = 144 needs over
// 200 registers a thread (as packed_tdot), so one block an SM. N = 64 spills
// at the 128 registers of two blocks an SM (the third piece of A costs one
// more B fragment a pair than packed_tdot), so it runs one block an SM too.
// Six stages: 218 KB at N = 144, near the most a block can have; at N = 32
// two blocks an SM fit, at N <= 16 three.
template <int N_>
struct DotTile : MmaTile<N_> {
  static constexpr int kABytes = kKC * MmaTile<N_>::LD * 2;  // one piece
  static constexpr int kStageBytes =
      kAPieces * kABytes + kKW * kWordLD * 4;
  static constexpr int kMinBlocks = N_ >= 64 ? 1 : 2;
  static constexpr int kStages = 6;
  static constexpr int kSmemBytes = kWBytes + kStages * kStageBytes;
  static_assert(kStageBytes % 16 == 0, "16-byte aligned stages");
  static_assert(kStages >= 3, "the ring keeps two stages in flight");
};

template <int N>
__global__ void __launch_bounds__(kThreads, DotTile<N>::kMinBlocks)
packed_dot_kernel(const int32_t* __restrict__ Wp,
                  const __nv_bfloat16* __restrict__ Ax, size_t a_plane,
                  int lda, const float* __restrict__ means,
                  float* __restrict__ D, int p, int nw, int r) {
  using C = DotTile<N>;
  constexpr int S = C::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  // W planes, row-major, two buffers: w_hi(u)[m * kWLD + k] is genotype k
  // of the k-step in SNP row m of the tile, unpacked into buffer u
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
  const int row0 = blockIdx.x * kTile;        // first SNP row of the tile
  const int col0 = blockIdx.y * N;
  const int nsteps = (nw + kKW - 1) / kKW;    // n_pad / kKC A rows

  // stage layout: the A tiles of the three pieces (LD-strided rows), the
  // packed words
  auto words = [&](int b) {
    return reinterpret_cast<const uint32_t*>(stages + b * C::kStageBytes +
                                             kAPieces * C::kABytes);
  };

  // one cp.async group a call: k-step t into stage t % S (an empty group
  // past the last step, so that every thread counts groups alike)
  const uint32_t stage0 = smem_addr(stages);
  auto issue = [&](int t) {
    if (t < nsteps) {
      const uint32_t sb = stage0 + (t % S) * C::kStageBytes;
      {
        // packed words: neighbouring threads read a row's two words; rows
        // i >= p and words w >= nw are zero-filled (rows i >= p are never
        // stored, and A is zero at the genotypes of words past nw)
        const int ri = tid / kKW;
        const int rw = tid % kKW;
        const int row = row0 + ri;
        const int w = t * kKW + rw;
        const bool ok = row < p && w < nw;
        cp_async4(sb + kAPieces * C::kABytes + (rw * kWordLD + ri) * 4,
                  ok ? Wp + (size_t)row * nw + w : Wp, ok);
      }
      // the tiles of the three A pieces, 16 bytes a copy
      constexpr int kChunks = kKC * N / 8;    // 16-byte chunks of a piece
      const size_t a0 = (size_t)t * kKC * lda + col0;
      for (int e = tid; e < kAPieces * kChunks; e += kThreads) {
        const int plane = e / kChunks;
        const int q = e % kChunks;
        const int rr = q / (N / 8);
        const int c8 = (q % (N / 8)) * 8;
        cp_async16(sb + plane * C::kABytes + (rr * C::LD + c8) * 2,
                   Ax + plane * a_plane + a0 + (size_t)rr * lda + c8);
      }
    }
    cp_async_commit();
  };

  // this thread's packed word in the unpack: row i, word kw of every
  // k-step; consecutive threads take consecutive rows, so the 16-byte
  // stores of a quarter-warp land on distinct banks (row stride 5 units).
  // The row never changes, so neither does its byte table.
  const int i = tid % kTile;
  const int kw = tid / kTile;
  const CodeLut lut = code_lut(row0 + i < p ? means[row0 + i] - 1.0f : 0.0f);
  // k-step t's packed words (stage t % S) -> both W planes of buffer t & 1
  auto unpack = [&](int t) {
    const uint32_t word = words(t % S)[kw * kWordLD + i];
    uint32_t hi[8], lo[8];
    unpack_planes(word, lut, hi, lo);
    uint4* dh = reinterpret_cast<uint4*>(w_hi(t & 1) + i * kWLD + kw * 16);
    uint4* dl = reinterpret_cast<uint4*>(w_lo(t & 1) + i * kWLD + kw * 16);
    dh[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    dh[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    dl[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    dl[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
  };

  // this lane's ldmatrix rows: A (x4: four 8x8 blocks, SNP rows 0-7 / 8-15
  // x genotypes 0-7 / 8-15 of the m16 tile) in W buffer 0, and B (x4:
  // genotypes 0-7 / 8-15 x columns 0-7 / 8-15 of an n8 pair) in stage 0
  const uint32_t a_lane = smem_addr(w_hi(0)) +
      ((wm * C::MT * 16 + (lane & 15)) * kWLD + (lane >> 4) * 8) * 2;
  const uint32_t b_lane = smem_addr(stages) +
      (((lane & 7) + ((lane >> 3) & 1) * 8) * C::LD + wn * C::NT * 8 +
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
    // buffer and A stage; every fragment below is at a constant offset
    const uint32_t wa = a_lane + (t & 1) * (2 * kWPlane * 2);
    const uint32_t ta = b_lane + (t % S) * C::kStageBytes;
    // A fragments (16 SNP rows x 16 genotypes) of both halves of the
    // k-step from the row-major W tile
    uint32_t ah[2][C::MT][4], al[2][C::MT][4];
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
        const uint32_t o = (mt * 16 * kWLD + kh * 16) * 2;
        ldsm_x4(ah[kh][mt], wa + o);
        ldsm_x4(al[kh][mt], wa + o + kWPlane * 2);
      }
    }
    // B fragments (16 genotypes x 8 columns) from the row-major A tiles
    split_kstep<C, kAPieces>(acc, ah, al, ta, C::kABytes);
  }
  cp_async_wait<0>();   // no copy outlives the block (the tail groups are empty)

  // accumulator (row g or g + 8, columns 2t and 2t + 1 of the n8 tile)
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      const int col = col0 + (wn * C::NT + nt) * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + (wm * C::MT + mt) * 16 + (lane >> 2) + 8 * h;
        if (row >= p) continue;
        if (col < r) D[(size_t)row * r + col] = acc[mt][nt][2 * h];
        if (col + 1 < r) D[(size_t)row * r + col + 1] = acc[mt][nt][2 * h + 1];
      }
    }
  }
}

// The A split, shared by both designs: A's three bf16 pieces written into
// `Ax` as split_pieces() planes of split_rows(n) x split_cols(r). Returns
// the launch's error and sets n_pad, lda and a_plane.
cudaError_t split_a(const float* A, __nv_bfloat16* Ax, int n, int r,
                    cudaStream_t stream, int& n_pad, int& lda,
                    size_t& a_plane) {
  n_pad = split_rows(n);
  lda = split_cols(r);
  a_plane = (size_t)n_pad * lda;
  split_bf16_kernel<kAPieces>
      <<<grid_1d(a_plane), kThreads, 0, stream>>>(A, Ax, n, r, n_pad, lda);
  return cudaGetLastError();
}

template <int N>
int launch(const int32_t* Wp, const float* A, const float* means,
           __nv_bfloat16* Ax, float* D, int p, int nw, int n, int r,
           cudaStream_t stream) {
  int n_pad, lda;
  size_t a_plane;
  cudaError_t err = split_a(A, Ax, n, r, stream, n_pad, lda, a_plane);
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int smem = DotTile<N>::kSmemBytes;
  err = cudaFuncSetAttribute(packed_dot_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p + kTile - 1) / kTile, lda / N);
  packed_dot_kernel<N><<<grid, kThreads, smem, stream>>>(
      Wp, Ax, a_plane, lda, means, D, p, nw, r);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the narrow design: column tiles N <= 32, the A fragments unpacked in
// registers
// ---------------------------------------------------------------------------

// The tiling of a narrow block: eight warps, each MT m16 tiles of SNP rows
// by all N columns, so each B fragment feeds MT x 4 MMAs; stages of KS
// k-steps (kWords packed words a row), S of them in the ring, at least
// kMinBlocks blocks an SM (launch bounds).
template <int N_, int MT_, int KS_, int S_, int kMinBlocks_>
struct NarrowTiling {
  static constexpr int N = N_;
  static constexpr int NT = N / 8;               // n8 tiles a warp
  static constexpr int MT = MT_;                 // m16 tiles a warp
  static constexpr int kRows = kThreads / 32 * MT * 16;  // SNP rows a block
  static constexpr int KS = KS_;                 // k-steps a stage
  static constexpr int kWords = 2 * KS;          // packed words a row a stage
  // row stride (bf16) of a staged A piece: an odd number of 16-byte units,
  // so the eight rows an ldmatrix reads hit distinct banks
  static constexpr int LD = N == 8 ? 8 : N + 8;
  static constexpr int kABytes = KS * kKStep * LD * 2;   // one piece
  // a row's staged words: kCh 16-byte chunks from the aligned word at or
  // below its first, in a row of kRW words (48 bytes: the eight rows of an
  // LDS hit distinct banks whatever their offsets)
  static constexpr int kCh = kWords / 4 + 1;
  static constexpr int kRW = 12;
  static constexpr int kStageBytes = kAPieces * kABytes + kRows * kRW * 4;
  static constexpr int kStages = S_;
  static constexpr int kMinBlocks = kMinBlocks_;
  static constexpr int kSmemBytes = kStages * kStageBytes;
  static_assert(N == 8 || N == 16 || N == 32, "narrow tiles");
  static_assert(kABytes % 16 == 0 && kStageBytes % 16 == 0, "alignment");
  static_assert(kWords % 4 == 0 && 4 * kCh <= kRW, "word chunks");
  static_assert(kStages >= 3, "the ring keeps two stages in flight");
};

// the tiling each narrow width runs, the fastest of those that keep every
// register (ptxas reports no spill): N = 8 three blocks of 256 rows an SM
// (80 registers), N = 16 one of 512 (246), N = 32 one of 256 (199)
template <int N>
struct NarrowTile;
template <>
struct NarrowTile<8> : NarrowTiling<8, 2, 4, 4, 3> {};
template <>
struct NarrowTile<16> : NarrowTiling<16, 4, 4, 3, 1> {};
template <>
struct NarrowTile<32> : NarrowTiling<32, 2, 2, 4, 1> {};

// bytes 0-3 of the W_hi table: the low and high bytes of -1 (code 0) and of
// 0 (code 1); a row's own word h holds bytes 4-7 (+1, code 2; the row's
// bf16(mean - 1), code 3), its word l those of W_lo (0 for codes 0-2 from
// the zero word beside it)
constexpr uint32_t kWhiBytes = 0x0000BF80u;

// One SNP row's table words: h = [0x80, 0x3F, mh.lo, mh.hi], l = [0, 0,
// ml.lo, ml.hi] with mh, ml the bf16 pieces of mean - 1 as code_lut takes
// them, so W_hi and W_lo are the wide design's values bit for bit.
__device__ __forceinline__ void row_tables(float mean_m1, uint32_t& h,
                                           uint32_t& l) {
  const CodeLut lut = code_lut(mean_m1);
  h = 0x3F80u | ((lut.hi_l >> 24) << 16) | ((lut.hi_h >> 24) << 24);
  l = ((lut.lo_l >> 24) << 16) | ((lut.lo_h >> 24) << 24);
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// One SNP row's A-fragment registers of a k16 half, in this lane (t = lane
// % 4): genotypes {2t, 2t+1} and {2t+8, 2t+9} of the half's packed word, its
// nibbles t and t+4, as bf16 pairs of W_hi (hi0, hi1) and of W_lo (lo0,
// lo1). x holds the four codes c at bits 0, 2, 16 and 18; s puts in the
// byte of each code the selector pair (2c, 2c + 1), read by prmt from
// bits 0-15 (hi0, lo0) and 16-31 (hi1, lo1): code c takes bytes 2c and
// 2c + 1 of {table word, row word}.
__device__ __forceinline__ void row_frag(uint32_t word, uint32_t shift,
                                         uint32_t h, uint32_t l,
                                         uint32_t& hi0, uint32_t& hi1,
                                         uint32_t& lo0, uint32_t& lo1) {
  const uint32_t x = (word >> shift) & 0x000F000Fu;
  const uint32_t s = x * 0x22u + (x & 0x000C000Cu) * 2142u + 0x10101010u;
  const uint32_t s1 = s >> 16;
  hi0 = prmt(kWhiBytes, h, s);
  hi1 = prmt(kWhiBytes, h, s1);
  lo0 = prmt(0u, l, s);
  lo1 = prmt(0u, l, s1);
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t d;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(d) : "r"(addr) : "memory");
  return d;
}

// a 16-byte cp.async of which the first `bytes` (0-16) come from src and the
// rest is zero-filled
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
                                                 int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// The B fragments of k16 half kh of k-step ks for every n8 tile and piece:
// bx[kh][q][nt] from piece q's staged tile (row-major, C::LD-strided) at
// this lane's ldmatrix row address b. N = 8 takes both halves with one x4 a
// piece (at kh = 0: lane l addresses row l of the k-step), wider tiles an
// x4 a pair of n8 tiles a half.
template <class C>
__device__ __forceinline__ void narrow_b(uint32_t (&bx)[2][kAPieces][C::NT][2],
                                         uint32_t b, int ks, int kh) {
  if constexpr (C::N == 8) {
    if (kh == 0) {
#pragma unroll
      for (int q = 0; q < kAPieces; ++q) {
        uint32_t t4[4];
        ldsm_x4_t(t4, b + q * C::kABytes + ks * kKStep * C::LD * 2);
        bx[0][q][0][0] = t4[0];
        bx[0][q][0][1] = t4[1];
        bx[1][q][0][0] = t4[2];
        bx[1][q][0][1] = t4[3];
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < kAPieces; ++q)
#pragma unroll
      for (int nt = 0; nt < C::NT; nt += 2) {
        uint32_t t4[4];
        ldsm_x4_t(t4, b + q * C::kABytes +
                          ((ks * kKStep + kh * 16) * C::LD + nt * 8) * 2);
        bx[kh][q][nt][0] = t4[0];
        bx[kh][q][nt][1] = t4[1];
        bx[kh][q][nt + 1][0] = t4[2];
        bx[kh][q][nt + 1][1] = t4[3];
      }
  }
}

// One stage's k-steps (all KS of them, or the first `ksteps` of the last
// stage) of a warp's MT x NT tiles. Each k-step's partial d is summed from
// zero by the wide design's MMAs in its order (split_kstep: for each half,
// W_hi·A_0, W_hi·A_1, W_hi·A_2, W_lo·A_0) and added to acc with an fp32
// add, so each output element gets the wide design's bits. w: this lane's
// address of its first row's first word in the stage (every row of the
// lane's has the same offset in its staged chunks); b: its ldmatrix row
// address in the stage's A tiles.
template <class C, bool kFull>
__device__ __forceinline__ void narrow_stage(
    float (&acc)[C::MT][C::NT][4], const uint32_t (&th)[C::MT][2],
    const uint32_t (&tl)[C::MT][2], uint32_t shift, uint32_t w, uint32_t b,
    int ksteps) {
  constexpr int MT = C::MT;
  constexpr int NT = C::NT;
#pragma unroll
  for (int ks = 0; ks < C::KS; ++ks) {
    if (!kFull && ks >= ksteps) break;
    uint32_t bx[2][kAPieces][NT][2];
    float d[MT][NT][4];
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      narrow_b<C>(bx, b, ks, kh);
      // the half's word of each of this lane's rows (g and g + 8 of each
      // m16 tile), as A fragments
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        row_frag(lds32(w + (mt * 16 * C::kRW + ks * 2 + kh) * 4), shift,
                 th[mt][0], tl[mt][0], ah[mt][0], ah[mt][2], al[mt][0],
                 al[mt][2]);
        row_frag(lds32(w + ((mt * 16 + 8) * C::kRW + ks * 2 + kh) * 4),
                 shift, th[mt][1], tl[mt][1], ah[mt][1], ah[mt][3],
                 al[mt][1], al[mt][3]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (kh == 0) {
            mma_bf16_zero(d[mt][nt], ah[mt], bx[kh][0][nt][0],
                          bx[kh][0][nt][1]);
          } else {
            mma_bf16(d[mt][nt], ah[mt], bx[kh][0][nt][0],
                     bx[kh][0][nt][1]);
          }
        }
#pragma unroll
      for (int q = 1; q < kAPieces; ++q)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(d[mt][nt], ah[mt], bx[kh][q][nt][0],
                     bx[kh][q][nt][1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(d[mt][nt], al[mt], bx[kh][0][nt][0], bx[kh][0][nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) add_rn(acc[mt][nt], d[mt][nt]);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, NarrowTile<N>::kMinBlocks)
packed_dot_narrow_kernel(const int32_t* __restrict__ Wp,
                         const __nv_bfloat16* __restrict__ Ax,
                         size_t a_plane, const float* __restrict__ means,
                         float* __restrict__ D, int p, int nw, int n_pad,
                         int r) {
  using C = NarrowTile<N>;
  constexpr int S = C::kStages;
  constexpr int KS = C::KS;
  constexpr int kStageRows = KS * kKStep;        // genotypes a stage
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t smem0 = smem_addr(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * C::kRows;        // first SNP row of the block
  const int nk = n_pad / kKStep;                 // k-steps: ceil(nw / 2)
  const int ns = (nk + KS - 1) / KS;             // stages

  // this thread's chunks of the packed words: chunk wc of block rows wi0,
  // wi0 + kRowStep, ...; a row R's words start o = R·nw mod 4 words past an
  // aligned word, the same o for every row of the thread's (and of a
  // lane's below: their rows differ by multiples of 4). Bytes past a row's
  // end (words >= nw) and rows >= p are zero-filled, as the wide design's.
  constexpr int kSlots = C::kCh > 2 ? 4 : 2;       // threads a row
  constexpr int kRowStep = kThreads / kSlots;
  const int wc = tid % kSlots;
  const int wi0 = tid / kSlots;
  const long long word0 = (long long)(row0 + wi0) * nw;
  const int wo = static_cast<int>(word0 & 3);
  const char* const wsrc =
      reinterpret_cast<const char*>(Wp + (word0 - wo)) + wc * 16;
  const size_t wstep = (size_t)kRowStep * nw * 4;
  const int wrows = p - row0 - wi0;
  const int wleft = (nw + wo - 4 * wc) * 4;      // bytes to the row's end
  const uint32_t wdst = kAPieces * C::kABytes + (wi0 * C::kRW + 4 * wc) * 4;

  // one cp.async group a call: stage t into slot t % S (an empty group past
  // the last stage, so that every thread counts groups alike)
  auto fetch = [&](int t) {
    if (t < ns) {
      const uint32_t sb = smem0 + (t % S) * C::kStageBytes;
      // the stage's rows of the three A pieces, 16 bytes a copy (lda = N:
      // a piece's stage tile is contiguous), none past n_pad
      constexpr int kChunks = kStageRows * N / 8;
      constexpr int kAJ = (kAPieces * kChunks + kThreads - 1) / kThreads;
      const int chunks = min(kStageRows, n_pad - t * kStageRows) * (N / 8);
      const size_t a0 = (size_t)t * kStageRows * N;
#pragma unroll
      for (int j = 0; j < kAJ; ++j) {
        const int e = tid + j * kThreads;
        const int q = e / kChunks;
        const int c = e % kChunks;
        if (q < kAPieces && c < chunks) {
          cp_async16(sb + q * C::kABytes + ((c / (N / 8)) * C::LD +
                                            (c % (N / 8)) * 8) * 2,
                     Ax + q * a_plane + a0 + (size_t)c * 8);
        }
      }
      // the packed words
      if (wc < C::kCh) {
        const int bytes = min(max(wleft - t * C::kWords * 4, 0), 16);
        const char* const src = wsrc + (size_t)t * C::kWords * 4;
#pragma unroll
        for (int j = 0; j < C::kRows / kRowStep; ++j) {
          const int nb = j * kRowStep < wrows ? bytes : 0;
          cp_async16_zfill(sb + wdst + j * kRowStep * C::kRW * 4,
                           nb ? src + j * wstep : static_cast<const void*>(Wp),
                           nb);
        }
      }
    }
    cp_async_commit();
  };

  // this lane's rows: g and g + 8 of each of the warp's MT m16 tiles, their
  // tables held for the whole loop
  const int g = lane >> 2;
  const uint32_t shift = 4 * (lane & 3);
  uint32_t th[C::MT][2], tl[C::MT][2];
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + (warp * C::MT + mt) * 16 + g + 8 * h;
      row_tables(row < p ? means[row] - 1.0f : 0.0f, th[mt][h], tl[mt][h]);
    }
  // stage-relative addresses: this lane's first row's words, and its
  // ldmatrix row in the A tiles (N = 8: k row = lane of the k-step; wider:
  // k rows 0-15 of the half, columns 0-7 / 8-15 of an n8 pair)
  const int lane_row = row0 + warp * C::MT * 16 + g;
  const int o_lane = static_cast<int>(((long long)lane_row * nw) & 3);
  const uint32_t w_lane = kAPieces * C::kABytes +
                          ((warp * C::MT * 16 + g) * C::kRW + o_lane) * 4;
  const uint32_t b_lane =
      N == 8 ? lane * C::LD * 2
             : (((lane & 7) + ((lane >> 3) & 1) * 8) * C::LD +
                (lane >> 4) * 8) * 2;

  float acc[C::MT][C::NT][4] = {};
  // The ring: S - 1 stages in flight. At the top of stage t the groups of
  // stages up to t + S - 2 have been started; waiting until S - 2 are
  // pending lands stage t. The barrier then shows it to every thread and
  // ends every warp's reads of stage t - 1, whose slot the copy of stage
  // t + S - 1 refills.
  for (int t = 0; t < S - 1; ++t) fetch(t);
  for (int t = 0; t < ns; ++t) {
    cp_async_wait<S - 2>();
    __syncthreads();
    fetch(t + S - 1);
    const uint32_t sb = smem0 + (t % S) * C::kStageBytes;
    const int ksteps = nk - t * KS;
    if (ksteps >= KS) {
      narrow_stage<C, true>(acc, th, tl, shift, sb + w_lane, sb + b_lane, KS);
    } else {
      narrow_stage<C, false>(acc, th, tl, shift, sb + w_lane, sb + b_lane,
                             ksteps);
    }
  }
  cp_async_wait<0>();   // no copy outlives the block (the tail groups are empty)

  // accumulator (row g or g + 8, columns 2t and 2t + 1 of the n8 tile)
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      const int col = nt * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + (warp * C::MT + mt) * 16 + g + 8 * h;
        if (row >= p) continue;
        if (col < r) D[(size_t)row * r + col] = acc[mt][nt][2 * h];
        if (col + 1 < r) D[(size_t)row * r + col + 1] = acc[mt][nt][2 * h + 1];
      }
    }
  }
}

template <int N>
int launch_narrow(const int32_t* Wp, const float* A, const float* means,
                  __nv_bfloat16* Ax, float* D, int p, int nw, int n, int r,
                  cudaStream_t stream) {
  using C = NarrowTile<N>;
  int n_pad, lda;   // lda = N: r <= N fills one column tile
  size_t a_plane;
  cudaError_t err = split_a(A, Ax, n, r, stream, n_pad, lda, a_plane);
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int smem = C::kSmemBytes;
  err = cudaFuncSetAttribute(packed_dot_narrow_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (p + C::kRows - 1) / C::kRows;
  packed_dot_narrow_kernel<N><<<grid, kThreads, smem, stream>>>(
      Wp, Ax, a_plane, means, D, p, nw, n_pad, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace ee

extern "C" {

// The bf16 scratch the caller allocates for an (n, r) A: split_pieces()
// planes, one after the other, each split_rows(n) x split_cols(r).
// split_rows(n) is the k-steps' ceil(nw / 2) * 32 genotypes for
// nw = ceil(n / 16).
int ee_packed_dot_split_pieces() { return ee::kAPieces; }
int ee_packed_dot_split_rows(int n) { return ee::split_rows(n); }
int ee_packed_dot_split_cols(int r) { return ee::split_cols(r); }

// Launches on `stream`: the A split into `planes`, then the MMA kernel of
// the wide design (every r). Returns the first CUDA error code (0 when both
// launches were accepted).
int ee_packed_dot(const int32_t* Wp, const float* A, const float* means,
                  void* planes, float* D, int p, int nw, int n, int r,
                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* ax = static_cast<__nv_bfloat16*>(planes);
  switch (ee::mma_tile_width(r)) {
    case 8:
      return ee::launch<8>(Wp, A, means, ax, D, p, nw, n, r, s);
    case 16:
      return ee::launch<16>(Wp, A, means, ax, D, p, nw, n, r, s);
    case 32:
      return ee::launch<32>(Wp, A, means, ax, D, p, nw, n, r, s);
    case 64:
      return ee::launch<64>(Wp, A, means, ax, D, p, nw, n, r, s);
    default:
      return ee::launch<144>(Wp, A, means, ax, D, p, nw, n, r, s);
  }
}

// The same, through the narrow design: r <= 32 only (else
// cudaErrorInvalidValue) and Wp on a 16-byte boundary (its words are
// copied 16 bytes at a time; else cudaErrorMisalignedAddress, before any
// launch); the same scratch, the same bits.
int ee_packed_dot_narrow(const int32_t* Wp, const float* A,
                         const float* means, void* planes, float* D, int p,
                         int nw, int n, int r, void* stream) {
  if (reinterpret_cast<uintptr_t>(Wp) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* ax = static_cast<__nv_bfloat16*>(planes);
  switch (r <= 32 ? ee::mma_tile_width(r) : 0) {
    case 8:
      return ee::launch_narrow<8>(Wp, A, means, ax, D, p, nw, n, r, s);
    case 16:
      return ee::launch_narrow<16>(Wp, A, means, ax, D, p, nw, n, r, s);
    case 32:
      return ee::launch_narrow<32>(Wp, A, means, ax, D, p, nw, n, r, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// SNP rows a block of the narrow design at r (0 when r > 32), which
// packed.k1_path weighs against the card's SMs
int ee_packed_dot_narrow_rows(int r) {
  switch (r <= 32 ? ee::mma_tile_width(r) : 0) {
    case 8:
      return ee::NarrowTile<8>::kRows;
    case 16:
      return ee::NarrowTile<16>::kRows;
    case 32:
      return ee::NarrowTile<32>::kRows;
    default:
      return 0;
  }
}

const char* ee_packed_dot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
