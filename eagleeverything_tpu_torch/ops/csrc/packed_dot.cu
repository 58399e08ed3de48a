// packed_dot: D = W·A over the resident 2-bit packed genotype stack.
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
// shuffled lanes. Here one thread turns one word into its sixteen
// genotypes j = 16w + k in natural order, so A is taken as it is.
//
// Bound on an H100 SXM: 2*p*16*nw*r fp32 FLOPs against p*nw*4 bytes of
// stack plus (n + p)*r*4 bytes of operands. At 2 bits a genotype the stack
// is 1/16 of the f32 matrix, so from r of about 3 up the kernel is bound by
// fp32 FMA throughput on the CUDA cores (67 TFLOP/s), not by the 3.35 TB/s
// of HBM. The design spends its effort there: each block recodes a
// 128-row x 32-genotype tile into shared memory once (one packed word a
// thread) and reuses it across up to 64 columns of A, each thread keeps a
// 4x8 (or 4x4, 1x4) register tile of accumulators, and the inner loop
// issues one float4 load of W per four genotypes and two of A per genotype
// for 32 FMAs. Tensor cores (a decomposition of W into integer
// codes plus a missing-value correction), TMA and a pipelined ring of
// tiles are later work.
//
// Deterministic: every output element is summed by one thread in
// increasing genotype order.
#include "packed_common.cuh"

namespace ee {
namespace {

// A block computes a kTile x BN output tile with kThreads threads; each
// thread owns TM consecutive output rows and TN columns, the columns in
// groups of four that are TCOLS*4 apart (so a warp's float4 reads of one
// shared-memory row are contiguous and conflict-free).
template <int TM_, int TN_, int TCOLS_>
struct Tiling {
  static constexpr int TM = TM_;
  static constexpr int TN = TN_;
  static constexpr int TCOLS = TCOLS_;
  static constexpr int TROWS = kThreads / TCOLS;
  static constexpr int BN = TN * TCOLS;
  static_assert(TROWS * TM == kTile, "thread rows must cover the block tile");
  static_assert(TN % 4 == 0, "thread columns come in groups of four");
};

// three tilings, chosen by the operand width r: narrow CG/Lanczos blocks,
// mid-width blocks, and wide blocks (probe sweeps, stat rows)
using TileNarrow = Tiling<1, 4, 2>;   // BN = 8
using TileMid = Tiling<4, 4, 8>;      // BN = 32
using TileWide = Tiling<4, 8, 8>;     // BN = 64

inline int tile_width(int r) { return r <= 8 ? 8 : (r <= 32 ? 32 : 64); }

// column (within the block tile) of a thread's c-th accumulator
template <class Cfg>
__device__ __forceinline__ int tile_col(int tx, int c) {
  return (c / 4) * 4 * Cfg::TCOLS + tx * 4 + (c % 4);
}

// acc[TM][TN] += sum over k < K of Xs[this thread's rows][k] *
// Ys[k][this thread's columns], in increasing k (a fixed order). Xs is
// row-major over the block's output rows with a row stride LD = K + 4:
// a thread reads four k of one row with one float4 load, and stores that
// fill Xs one row per thread hit distinct banks.
template <class Cfg, int K, int LD>
__device__ __forceinline__ void mma_smem(float (*Xs)[LD],
                                         float (*Ys)[Cfg::BN],
                                         int ty, int tx,
                                         float (&acc)[Cfg::TM][Cfg::TN]) {
  static_assert(K % 4 == 0 && LD % 4 == 0, "float4 rows of Xs");
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 4) {
    float4 xv[Cfg::TM];
#pragma unroll
    for (int i = 0; i < Cfg::TM; ++i) {
      xv[i] = *reinterpret_cast<float4*>(&Xs[ty * Cfg::TM + i][k0]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float yv[Cfg::TN];
#pragma unroll
      for (int g = 0; g < Cfg::TN / 4; ++g) {
        const float4 v = *reinterpret_cast<float4*>(
            &Ys[k0 + kk][g * 4 * Cfg::TCOLS + tx * 4]);
        yv[4 * g] = v.x;
        yv[4 * g + 1] = v.y;
        yv[4 * g + 2] = v.z;
        yv[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < Cfg::TM; ++i) {
        const float x = kk == 0 ? xv[i].x
                      : kk == 1 ? xv[i].y
                      : kk == 2 ? xv[i].z : xv[i].w;
#pragma unroll
        for (int c = 0; c < Cfg::TN; ++c) {
          acc[i][c] = fmaf(x, yv[c], acc[i][c]);
        }
      }
    }
  }
}

constexpr int kKW = 2;            // packed words per k-step
constexpr int kKC = 16 * kKW;     // genotypes per k-step
constexpr int kLD = kKC + 4;      // row stride of the row-major tile

template <class Cfg>
__global__ void __launch_bounds__(kThreads)
packed_dot_kernel(const int32_t* __restrict__ Wp, const float* __restrict__ A,
                  const float* __restrict__ means, float* __restrict__ D,
                  int p, int nw, int n, int r) {
  __shared__ __align__(16) float Ws[kTile][kLD];     // recoded W, Ws[i][k]
  __shared__ __align__(16) float As[kKC][Cfg::BN];
  static_assert(kTile * kKW == kThreads, "one packed word per thread");
  const int tid = threadIdx.x;
  const int ty = tid / Cfg::TCOLS;
  const int tx = tid % Cfg::TCOLS;
  const int row0 = blockIdx.x * kTile;
  const int col0 = blockIdx.y * Cfg::BN;
  // this thread's packed word in every k-step: row i, word kw of the step;
  // it writes its sixteen genotypes as four float4 to row i of Ws, and the
  // eight threads of a quarter-warp hit distinct banks (row stride kLD)
  const int i = tid % kTile;
  const int kw = tid / kTile;
  const int row = row0 + i;
  const float m1 = row < p ? means[row] - 1.0f : 0.0f;
  float acc[Cfg::TM][Cfg::TN] = {};

  for (int w0 = 0; w0 < nw; w0 += kKW) {
    const int w = w0 + kw;
    const uint32_t word = (row < p && w < nw)
        ? static_cast<uint32_t>(Wp[(size_t)row * nw + w]) : kPadWord;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      *reinterpret_cast<float4*>(&Ws[i][kw * 16 + 4 * g]) = make_float4(
          recode((word >> (8 * g)) & 3u, m1),
          recode((word >> (8 * g + 2)) & 3u, m1),
          recode((word >> (8 * g + 4)) & 3u, m1),
          recode((word >> (8 * g + 6)) & 3u, m1));
    }
    // the matching kKC genotype rows of A; rows j >= n are zero, so the
    // pad genotypes of a row's last word never reach D
    for (int e = tid; e < kKC * Cfg::BN; e += kThreads) {
      const int kk = e / Cfg::BN;
      const int c = e % Cfg::BN;
      const int j = 16 * w0 + kk;
      const int col = col0 + c;
      As[kk][c] = (j < n && col < r) ? A[(size_t)j * r + col] : 0.0f;
    }
    __syncthreads();
    mma_smem<Cfg, kKC, kLD>(Ws, As, ty, tx, acc);
    __syncthreads();
  }

#pragma unroll
  for (int ii = 0; ii < Cfg::TM; ++ii) {
    const int rr = row0 + ty * Cfg::TM + ii;
    if (rr >= p) continue;
#pragma unroll
    for (int c = 0; c < Cfg::TN; ++c) {
      const int col = col0 + tile_col<Cfg>(tx, c);
      if (col < r) D[(size_t)rr * r + col] = acc[ii][c];
    }
  }
}

template <class Cfg>
int launch(const int32_t* Wp, const float* A, const float* means, float* D,
           int p, int nw, int n, int r, cudaStream_t stream) {
  const dim3 grid((p + kTile - 1) / kTile, (r + Cfg::BN - 1) / Cfg::BN);
  packed_dot_kernel<Cfg><<<grid, kThreads, 0, stream>>>(Wp, A, means, D, p,
                                                        nw, n, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace ee

extern "C" {

// Launches on `stream`; returns the cudaGetLastError() code of the launch.
int ee_packed_dot(const int32_t* Wp, const float* A, const float* means,
                  float* D, int p, int nw, int n, int r, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ee::tile_width(r)) {
    case 8:
      return ee::launch<ee::TileNarrow>(Wp, A, means, D, p, nw, n, r, s);
    case 32:
      return ee::launch<ee::TileMid>(Wp, A, means, D, p, nw, n, r, s);
    default:
      return ee::launch<ee::TileWide>(Wp, A, means, D, p, nw, n, r, s);
  }
}

const char* ee_packed_dot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
