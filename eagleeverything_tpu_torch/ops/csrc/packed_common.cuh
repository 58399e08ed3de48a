// Shared pieces of the packed-stack kernels (packed_dot.cu, packed_tdot.cu).
//
// The stack is int32 (p, nw): word w of SNP row i holds genotypes
// j = 16w + k at bits 2k (a little-endian view of the store's 2-bit byte
// stream). Codes 0/1/2 recode to dose - 1 and code 3 (missing) to the SNP's
// mean dose - 1. Genotype positions j >= n in a row's last word are never
// allowed to reach an output: the kernels zero the skinny operand there
// (packed_dot) or drop those output rows (packed_tdot).
//
// packed_dot runs IEEE fp32 FMAs on the CUDA cores; packed_tdot runs on the
// bf16 tensor cores with each operand split into bf16 halves so that its
// products keep fp32 accuracy. Neither uses TF32.
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

}  // namespace ee
