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
// Structure. A pre-pass (split_bf16_kernel) writes the three pieces once
// per launch into three bf16 (n_pad, lda) scratch planes, one after the
// other, that the wrapper allocates: rows padded with zeros to the
// 32-genotype k-step and columns to whole column tiles, so every tile copy
// below is an aligned, unguarded 16-byte cp.async. Rows j >= n are zero, so the pad genotypes of a row's
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

template <int N>
int launch(const int32_t* Wp, const float* A, const float* means,
           __nv_bfloat16* Ax, float* D, int p, int nw, int n, int r,
           cudaStream_t stream) {
  const int n_pad = split_rows(n);
  const int lda = split_cols(r);
  const size_t a_plane = (size_t)n_pad * lda;
  split_bf16_kernel<kAPieces>
      <<<grid_1d(a_plane), kThreads, 0, stream>>>(A, Ax, n, r, n_pad, lda);
  cudaError_t err = cudaGetLastError();
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

// Launches on `stream`: the A split into `planes`, then the MMA kernel.
// Returns the first CUDA error code (0 when both launches were accepted).
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

const char* ee_packed_dot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
