// packed_tdot: out = Wᵀ·T over the resident 2-bit packed genotype stack.
//
// Replaces the TPU kernel eagleeverything_tpu/ops/pallas_packed.py::
// packed_tdot (:203; body _tdot_kernel :181).
//
//   Wp    int32 (p, nw)  packed stack, nw = ceil(ceil(n/4)/4) words a row
//   T     f32   (p, r)   one row per SNP
//   means f32   (p,)     per-SNP mean dose (the missing-code impute value)
//   out   f32   (n, r)   out[j, c] = sum_i W[i, j] T[i, c], natural order
//
// The contraction runs over all p SNP rows into a small (n, r) output. On
// the TPU the grid ran in order and carried the sum across steps; here
// blocks run in parallel, so the rows are split into `nsplit` ranges (a
// split-K). Block (genotype tile, column tile, split) writes its partial
// (128, BN) sum to scratch, and a second launch adds the splits in a fixed
// order. No float atomics: their order changes from run to run, which moves
// CG residuals and can flip a near-tie argmax.
//
// Bound on an H100 SXM: the same 2*p*16*nw*r fp32 FLOPs and p*nw*4 stack
// bytes as packed_dot, so fp32-FMA-bound on the CUDA cores (67 TFLOP/s)
// from r of about 3 up. Each block recodes a 32-SNP x 128-genotype tile
// into shared memory once (one packed word a thread) and reuses it across
// up to 64 columns of T, with a 4x8 (or 4x4, 1x4) register tile of
// accumulators. The split count is set so that about sixteen blocks per SM
// are launched (several waves, so the last one is short); the scratch it
// costs is nsplit*n*r floats, allocated by the caller.
#include "packed_common.cuh"

namespace ee {
namespace {

constexpr int kKR = 32;              // SNP rows per k-step
constexpr int kWords = kTile / 16;   // packed words of a block's genotypes
constexpr int kLD = kKR + 4;         // row stride of the genotype-major tile

template <class Cfg>
__global__ void __launch_bounds__(kThreads)
packed_tdot_kernel(const int32_t* __restrict__ Wp, const float* __restrict__ T,
                   const float* __restrict__ means, float* __restrict__ part,
                   int p, int nw, int n, int r, int rows_per_split) {
  __shared__ __align__(16) float Ws[kTile][kLD];     // recoded W, Ws[j][k]
  __shared__ __align__(16) float Ts[kKR][Cfg::BN];
  static_assert(kKR * kWords == kThreads, "one packed word per thread");
  const int tid = threadIdx.x;
  const int ty = tid / Cfg::TCOLS;
  const int tx = tid % Cfg::TCOLS;
  const int j0 = blockIdx.x * kTile;          // first genotype of the tile
  const int col0 = blockIdx.y * Cfg::BN;
  const int i_begin = blockIdx.z * rows_per_split;
  const int i_end = min(p, i_begin + rows_per_split);
  // this thread's packed word in every k-step: row i0 + kr, word kw of the
  // tile; consecutive threads take consecutive rows, so the sixteen
  // shared-memory stores of a warp are conflict-free
  const int kr = tid % kKR;
  const int kw = tid / kKR;
  const int w = j0 / 16 + kw;
  float acc[Cfg::TM][Cfg::TN] = {};

  for (int i0 = i_begin; i0 < i_end; i0 += kKR) {
    const int i = i0 + kr;
    uint32_t word = kPadWord;
    float m1 = 0.0f;
    if (i < i_end) {
      m1 = means[i] - 1.0f;
      if (w < nw) word = static_cast<uint32_t>(Wp[(size_t)i * nw + w]);
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      Ws[kw * 16 + k][kr] = recode((word >> (2 * k)) & 3u, m1);
    }
    for (int e = tid; e < kKR * Cfg::BN; e += kThreads) {
      const int rr = e / Cfg::BN;
      const int c = e % Cfg::BN;
      const int ii = i0 + rr;
      const int col = col0 + c;
      Ts[rr][c] = (ii < i_end && col < r) ? T[(size_t)ii * r + col] : 0.0f;
    }
    __syncthreads();
    mma_smem<Cfg, kKR, kLD>(Ws, Ts, ty, tx, acc);
    __syncthreads();
  }

  // genotypes j >= n (the pad positions of the last word) are dropped
  float* out = part + (size_t)blockIdx.z * n * r;
#pragma unroll
  for (int ii = 0; ii < Cfg::TM; ++ii) {
    const int j = j0 + ty * Cfg::TM + ii;
    if (j >= n) continue;
#pragma unroll
    for (int c = 0; c < Cfg::TN; ++c) {
      const int col = col0 + tile_col<Cfg>(tx, c);
      if (col < r) out[(size_t)j * r + col] = acc[ii][c];
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

template <class Cfg>
int launch(const int32_t* Wp, const float* T, const float* means, float* part,
           float* out, int p, int nw, int n, int r, int nsplit,
           cudaStream_t stream) {
  int rows = (p + nsplit - 1) / nsplit;
  rows = (rows + kKR - 1) / kKR * kKR;
  const dim3 grid((n + kTile - 1) / kTile, (r + Cfg::BN - 1) / Cfg::BN,
                  nsplit);
  packed_tdot_kernel<Cfg><<<grid, kThreads, 0, stream>>>(
      Wp, T, means, nsplit == 1 ? out : part, p, nw, n, r, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  const size_t count = (size_t)n * r;
  const size_t blocks = (count + kThreads - 1) / kThreads;
  reduce_splits_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), kThreads,
                         0, stream>>>(part, out, count, nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace ee

extern "C" {

// How many row ranges packed_tdot splits p into for an (n, r) output on
// the current device: about sixteen blocks per SM, at least 256 rows a
// split, at most 64 splits. The caller allocates nsplit*n*r floats of
// scratch.
int ee_packed_tdot_splits(int p, int n, int r) {
  int dev = 0;
  int sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int bn = ee::tile_width(r);
  const long tiles = (long)((n + ee::kTile - 1) / ee::kTile) *
                     ((r + bn - 1) / bn);
  long s = (16L * sms + tiles - 1) / tiles;
  const long by_rows = (p + 255) / 256;
  if (s > by_rows) s = by_rows;
  if (s > 64) s = 64;
  return s < 1 ? 1 : static_cast<int>(s);
}

// Launches on `stream` (a second launch reduces the splits when
// nsplit > 1; `part` is unused when nsplit == 1); returns the
// cudaGetLastError() code.
int ee_packed_tdot(const int32_t* Wp, const float* T, const float* means,
                   float* part, float* out, int p, int nw, int n, int r,
                   int nsplit, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ee::tile_width(r)) {
    case 8:
      return ee::launch<ee::TileNarrow>(Wp, T, means, part, out, p, nw, n, r,
                                        nsplit, s);
    case 32:
      return ee::launch<ee::TileMid>(Wp, T, means, part, out, p, nw, n, r,
                                     nsplit, s);
    default:
      return ee::launch<ee::TileWide>(Wp, T, means, part, out, p, nw, n, r,
                                      nsplit, s);
  }
}

const char* ee_packed_tdot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
