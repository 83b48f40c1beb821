// Device code shared by K3's two tensor-core blocks: the bfloat16 forward and
// the dz kernel (snake_conv.cu) and the float32 forward taken as split-TF32
// products (snake_conv_f32.cu).  Both are implicit GEMMs on wgmma with A from
// registers — ldmatrix at the tap's row offset into an activated tile Z in
// shared memory — and B a no-swizzle K-major weight tile brought by one bulk
// copy per step into a ring of stages.
#pragma once
#include "afa_common.cuh"
#include "flash_hopper.cuh"

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// wgmma descriptor of a K-major tile without swizzle: start >> 4, the two
// 16-byte core matrices of a row group 128 bytes apart (leading byte
// offset), 8-row groups 256 bytes apart (stride byte offset).  One k-step
// of either type: 16 bfloat16 or 8 tf32 values, 32 bytes of each row.
__device__ __forceinline__ uint64_t sch_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}
