// packed_tdot: out = Wᵀ·T over the resident 2-bit packed genotype stack,
// on the bf16 tensor cores with split bf16 products (bf16x3).
//
// Replaces the TPU kernel eagleeverything_tpu/ops/pallas_packed.py::
// packed_tdot (:203; body _tdot_kernel :181).
//
//   Wp    int32 (p, nw)  packed stack, nw = ceil(ceil(n/4)/4) words a row
//   T     f32   (p, r)   one row per SNP
//   means f32   (p,)     per-SNP mean dose (the missing-code impute value)
//   out   f32   (n, r)   out[j, c] = sum_i W[i, j] T[i, c], natural order
//
// Numerics (packed_common.cuh): T in two bf16 pieces, three products
// W_hi·T_hi + W_hi·T_lo + W_lo·T_hi, k-step partials added in fp32. The
// MMA's m side is the genotypes, its k side the SNP rows.
//
// Structure. A pre-pass (split_bf16_kernel) writes T_hi and T_lo once per
// launch into two bf16 (p_pad, ldt) scratch planes, one after the other: rows padded with zeros
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
//   3. runs step t on the tensor cores (split_kstep): A by ldmatrix.trans
//      from the k-major W tile, B by ldmatrix.trans from the row-major T
//      tile, six MMAs a tile a step, over the warp tiling of MmaTile.
// Row strides are an odd number of 16-byte units, so the eight rows an
// ldmatrix reads, and the quarter-warp's 16-byte stores of the unpack, hit
// distinct banks. Column tiles: mma_tile_width (N = 8 ... 144).
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
#include "packed_common.cuh"

namespace ee {
namespace {

constexpr int kKR = kKStep;          // SNP rows per k-step
constexpr int kWords = kTile / 16;   // packed words of a block's genotypes
constexpr int kWordLD = kWords + 1;  // row stride of the staged words
constexpr int kWLD = kTile + 8;      // row stride of the W planes (17 units)
constexpr int kWPlane = kKR * kWLD;  // bf16 elements of one W plane
constexpr int kWBytes = 2 * 2 * kWPlane * 2;  // two buffers of W_hi, W_lo
static_assert(kKR * kWords == kThreads, "one packed word per thread");

// The stage layout of a 128-genotype x N block tile, its ring of stages and
// the resident blocks per SM that its registers are held to.
template <int N_>
struct TdotTile : MmaTile<N_> {
  static constexpr int kTBytes = kKR * MmaTile<N_>::LD * 2;  // one plane
  static constexpr int kStageBytes =
      2 * kTBytes + kKR * kWordLD * 4 + kKR * 4;
  // N = 144 needs about 210 registers a thread (72 accumulators, the A
  // fragments of a whole k-step, one pair's B fragments and d): held to
  // 128 for two blocks an SM, ptxas spills, so one block an SM runs it, with
  // a deeper ring. The narrower tilings fit two or three blocks an SM.
  static constexpr int kMinBlocks = N_ == 144 ? 1 : 2;
  static constexpr int kStages = N_ == 144 ? 6 : N_ == 64 ? 6 : 8;
  static constexpr int kSmemBytes = kWBytes + kStages * kStageBytes;
  static_assert(kStageBytes % 16 == 0, "16-byte aligned stages");
  static_assert(kStages >= 3, "the ring keeps two stages in flight");
};

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

  // stage layout: T_hi tile, T_lo tile (LD-strided rows), packed words,
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
        cp_async16(sb + plane * C::kTBytes + (rr * C::LD + c8) * 2,
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
    uint32_t hi[8], lo[8];
    unpack_planes(word, code_lut(row_means(b)[kr] - 1.0f), hi, lo);
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
    // B fragments (16 SNP rows x 8 columns) from the row-major T tile
    split_kstep<C, 2>(acc, ah, al, ta, C::kTBytes);
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

template <int N>
int launch(const int32_t* Wp, const float* T, const float* means,
           __nv_bfloat16* Thi, float* part, float* out, int p, int nw, int n,
           int r, int nsplit, cudaStream_t stream) {
  const int p_pad = split_rows(p);
  const int ldt = split_cols(r);
  const __nv_bfloat16* Tlo = Thi + (size_t)p_pad * ldt;
  split_bf16_kernel<2><<<grid_1d((size_t)p_pad * ldt), kThreads, 0, stream>>>(
      T, Thi, p, r, p_pad, ldt);
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
// allocates, one after the other, for an (p, r) T: split_rows(p) x
// split_cols(r).
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
  const int bn = ee::mma_tile_width(r);
  const long tiles = (long)((n + ee::kTile - 1) / ee::kTile) *
                     ((r + bn - 1) / bn);
  long s = (16L * sms + tiles - 1) / tiles;
  const long by_rows = (p + 255) / 256;
  if (s > by_rows) s = by_rows;
  if (s > 64) s = 64;
  return s < 1 ? 1 : static_cast<int>(s);
}

// Launches on `stream`: the T split into `planes`, the MMA kernel and
// (when nsplit > 1) the fixed-order reduce of the splits; `part` is unused
// when nsplit == 1. Returns the first CUDA error code (0 when every launch
// was accepted).
int ee_packed_tdot(const int32_t* Wp, const float* T, const float* means,
                   void* planes, float* part, float* out, int p, int nw, int n,
                   int r, int nsplit, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* th = static_cast<__nv_bfloat16*>(planes);
  switch (ee::mma_tile_width(r)) {
    case 8:
      return ee::launch<8>(Wp, T, means, th, part, out, p, nw, n, r,
                           nsplit, s);
    case 16:
      return ee::launch<16>(Wp, T, means, th, part, out, p, nw, n, r,
                            nsplit, s);
    case 32:
      return ee::launch<32>(Wp, T, means, th, part, out, p, nw, n, r,
                            nsplit, s);
    case 64:
      return ee::launch<64>(Wp, T, means, th, part, out, p, nw, n, r,
                            nsplit, s);
    default:
      return ee::launch<144>(Wp, T, means, th, part, out, p, nw, n, r,
                             nsplit, s);
  }
}

const char* ee_packed_tdot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
