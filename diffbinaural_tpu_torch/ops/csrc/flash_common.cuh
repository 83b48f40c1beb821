// Pieces shared by the head-dimension-32 flash attention kernels: the forward
// (flash_d32.cu) and the backward (flash_d32_bwd.cu).  Tile geometry, the
// shared-memory tile loaders of both element types, and the tensor-core
// primitives (mma.sync.m16n8k16 on bfloat16, ldmatrix.trans).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int FD = 32;        // head dimension
constexpr int FQ = 128;       // float32: rows per block (one per thread)
constexpr int FK = 64;        // float32: rows per shared-memory tile

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ void load8(const float* p, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float* src) {
  *reinterpret_cast<float4*>(p) = make_float4(src[0], src[1], src[2], src[3]);
  *reinterpret_cast<float4*>(p + 4) =
      make_float4(src[4], src[5], src[6], src[7]);
}
// Copy one tile of FK rows x 32 values (rows >= n_rows zero-filled) into
// shared memory.  The tile is one contiguous run in global memory.
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int n_rows, float* dst, int tid) {
  for (int v = tid; v < FK * FD / 8; v += FQ) {
    const int row = v / (FD / 8);
    float vals[8];
    if (row < n_rows) {
      load8(src + (size_t)v * 8, vals);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) vals[i] = 0.0f;
    }
    store8(dst + v * 8, vals);
  }
}

// ------------------------------------------------------------ tensor cores

constexpr int MQ = 64;        // rows per block: 4 warps x 16 rows
constexpr int MK = 64;        // rows per shared-memory tile
constexpr int MS = FD + 8;    // padded shared row, in bfloat16 values
constexpr int MTHREADS = 128;

// d (16x8, f32) += a (16x16, bf16, row) * b (16x8, bf16, col).  With
// g = lane / 4 and t = lane % 4:  a0 = A[g][2t..], a1 = A[g+8][2t..],
// a2 = A[g][2t+8..], a3 = A[g+8][2t+8..];  b0 = B[2t..][g], b1 = B[2t+8..][g];
// c0,c1 = C[g][2t..], c2,c3 = C[g+8][2t..].
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One 64 x 32 tile (rows >= n_rows zero-filled) into padded shared rows.
__device__ __forceinline__ void load_tile_bf16(const __nv_bfloat16* __restrict__ src,
                                               int n_rows, __nv_bfloat16* dst,
                                               int tid) {
  for (int v = tid; v < MK * FD / 8; v += MTHREADS) {
    const int row = v >> 2;
    const int ch = v & 3;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row < n_rows) raw = *reinterpret_cast<const uint4*>(src + (size_t)v * 8);
    *reinterpret_cast<uint4*>(dst + row * MS + ch * 8) = raw;
  }
}

// Rows r_lo and r_hi (= r_lo + 8 of a 16-row tile) of a row-major (rows, 32)
// bfloat16 matrix as the A fragments of two k-steps of 16 over the 32 columns.
__device__ __forceinline__ void load_a_frags(const __nv_bfloat16* __restrict__ lo,
                                             const __nv_bfloat16* __restrict__ hi,
                                             int t, uint32_t (*a)[4]) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    a[ks][0] = *reinterpret_cast<const uint32_t*>(lo + 16 * ks + 2 * t);
    a[ks][1] = *reinterpret_cast<const uint32_t*>(hi + 16 * ks + 2 * t);
    a[ks][2] = *reinterpret_cast<const uint32_t*>(lo + 16 * ks + 8 + 2 * t);
    a[ks][3] = *reinterpret_cast<const uint32_t*>(hi + 16 * ks + 8 + 2 * t);
  }
}

// Shared-memory address this lane hands to ldmatrix.x4.trans for a 16-row x
// 16-column block of a padded tile: matrices (rows 0-7, cols 0-7), (rows
// 8-15, cols 0-7), (rows 0-7, cols 8-15), (rows 8-15, cols 8-15).
__device__ __forceinline__ uint32_t ldmatrix_lane_addr(const __nv_bfloat16* tile,
                                                       int lane) {
  const int lm_row = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int lm_col = (lane >> 4) * 8;
  return (uint32_t)__cvta_generic_to_shared(tile + lm_row * MS + lm_col);
}

// The B fragments of a tile used as a (rows = k, 32 columns = n) operand:
// for the 16 rows from `row0` and the 16 columns from `col0`, b0/b1 feed the
// first 8 columns and b2/b3 the next 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t lane_addr, int row0,
                                                  int col0, uint32_t& b0,
                                                  uint32_t& b1, uint32_t& b2,
                                                  uint32_t& b3) {
  const uint32_t addr =
      lane_addr + (uint32_t)((row0 * MS + col0) * sizeof(__nv_bfloat16));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
      : "r"(addr));
}
