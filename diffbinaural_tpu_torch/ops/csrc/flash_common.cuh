// Pieces shared by the head-dimension-32 flash attention kernels (csrc/ and
// csrc_variants/): the head dimension, the exp2 constants, and the bfloat16
// packing that the Hopper kernels (flash_hopper.cuh) use.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int FD = 32;        // head dimension

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Two floats as one bfloat16 pair (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
