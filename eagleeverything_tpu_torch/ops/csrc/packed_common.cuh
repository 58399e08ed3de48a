// Shared pieces of the packed-stack kernels (packed_dot.cu, packed_tdot.cu).
//
// The stack is int32 (p, nw): word w of SNP row i holds genotypes
// j = 16w + k at bits 2k (a little-endian view of the store's 2-bit byte
// stream). Codes 0/1/2 recode to dose - 1 and code 3 (missing) to the SNP's
// mean dose - 1. Genotype positions j >= n in a row's last word are never
// allowed to reach an output: the kernels zero the skinny operand there
// (packed_dot) or drop those output rows (packed_tdot).
//
// Both kernels stage a tile of recoded genotypes and a tile of the skinny
// operand in shared memory and run the same register-tiled fp32 FMA loop
// on CUDA cores (mma_smem below). No tensor cores and no TF32: every
// product and sum is IEEE fp32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ee {

constexpr int kThreads = 256;        // threads per block
constexpr int kTile = 128;           // output rows per block
constexpr uint32_t kPadWord = 0x55555555u;  // sixteen het codes: W = 0

// 2-bit code -> recoded genotype: 0/1/2 -> dose - 1, 3 (missing) -> mean - 1
__device__ __forceinline__ float recode(uint32_t code, float mean_m1) {
  return code == 3u ? mean_m1 : static_cast<float>(code) - 1.0f;
}

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

// The three tilings, chosen by the operand width r: narrow CG/Lanczos
// blocks, mid-width blocks, and wide blocks (probe sweeps, stat rows).
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

}  // namespace ee
