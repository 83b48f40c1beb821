// Weight gradient of the fused snake -> k-tap dilated Conv1d (K3b's dW):
//   dW[co, ci, j] = sum_{b, t} dy[b, co, t] * z[b, ci, t + (j - (k-1)/2) * dil]
// with z = the activation (bfloat16, zero outside [0, T)), on (B, C, T) with
// C % 128 == 0.
//
// Replaces the weight half of the VJP of the XLA convolution inside
// _core_bwd (diffbinaural_tpu/ops/snake_conv.py:197-207), which has no
// pallas_call of its own: the TPU package leaves it to XLA.
//
// Bound by operations: k products of C x C over K = B*T (2*B*T*k*C^2 FLOP
// against 2*B*C*T + k*C^2 elements moved).  A block owns one tap j and a
// tile of SCW_BM input channels x SCW_BN output channels and runs over the
// K axis in steps of SCW_BK time steps of one batch element; each step is
// TMA boxes from 3-D tensor maps, whose out-of-bounds zero fill supplies
// the convolution's zero padding, times beyond T and channels beyond C:
//   * B = dy as it lies ((B, C, T), time contiguous: K-major), one box of
//     SCW_BN channels x SCW_BK times over (T, C, B);
//   * A = z shifted by the tap, (j - (k-1)/2) * dil times.  A TMA box may
//     not start at an arbitrary time along the contiguous axis (a box at
//     such a shift traps with an illegal instruction), so a first kernel
//     (snake_conv_wgrad_zt_kernel) writes z transposed, (B, hz + T + hz, C)
//     with hz zero rows on each side, hz = (k-1)/2 * dil: the tap shift is
//     then a row coordinate (t + shift + hz >= 0), and A is an MN-major
//     operand (time rows of 64 channels = 128 bytes), one box per consumer
//     warpgroup;
//   * tiles land in the 128-byte swizzle in a ring of SCW_STAGES stages
//     (mbarrier full / empty), filled by one thread of a producer
//     warpgroup;
//   * two consumer warpgroups each take 64 input channels and issue
//     wgmma m64n256k16 from shared memory (A transposed), fp32 sums in
//     registers (128 per thread);
//   * where the tiles alone would fill fewer than half the SMs, the K axis
//     is split over blocks (the wrapper picks the split); each block writes
//     its fp32 sums to its own slice of the partials, which the wrapper adds
//     in a fixed order: no atomics, the same bits in every run.
#include "flash_hopper.cuh"

constexpr int SCW_BM = 128;        // input channels per block (A rows)
constexpr int SCW_BN = 256;        // output channels per block (B rows)
constexpr int SCW_BK = 64;         // time steps per stage: one 128-byte row
constexpr int SCW_STAGES = 4;
constexpr int SCW_CONSUMERS = 2;   // warpgroups of 64 input channels
// + a producer warpgroup (only its first thread works: wgmma wants every
// warpgroup of the block whole)
constexpr int SCW_THREADS = (SCW_CONSUMERS + 1) * WG_THREADS;
constexpr int SCW_A_WG_BYTES = 64 * SCW_BK * 2;  // one warpgroup's A box
constexpr int SCW_A_BYTES = SCW_BM * SCW_BK * 2;
constexpr int SCW_B_BYTES = SCW_BN * SCW_BK * 2;
constexpr int SCW_STAGE_BYTES = SCW_A_BYTES + SCW_B_BYTES;
constexpr int SCW_BARS = SCW_STAGES * SCW_STAGE_BYTES;  // full[S], empty[S]
constexpr int SCW_SMEM = SCW_BARS + 16 * SCW_STAGES;
static_assert(SCW_SMEM + TILE_ALIGN <= MAX_DYNAMIC_SMEM, "wgrad smem");
static_assert(SCW_A_BYTES % TILE_ALIGN == 0 && SCW_B_BYTES % TILE_ALIGN == 0,
              "tiles on swizzle-atom boundaries");

// wgmma descriptor of a tile of 128-byte rows in the 128-byte swizzle:
// start >> 4, 8-row groups 1024 bytes apart (SBO); LBO unused (one atom
// spans the K extent of a K-major operand and the 64-wide M extent of an
// MN-major one).  The next 16 values along K are 32 bytes further in a
// K-major tile (start + 2) and 16 rows further in an MN-major one (+ 128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// d (64 x 256, f32) += A (64 x 16) B^T (256 x 16), both from shared memory
// in the 128-byte swizzle: A MN-major (transpose bit set), B K-major.
__device__ __forceinline__ void wgmma_m64n256k16_ss(float* d, uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// The same with D = A B^T: the accumulator is written, not read, so the
// first product of a block needs no zeroed registers (an instruction that
// defined them would serialise the products).
__device__ __forceinline__ void wgmma_m64n256k16_ss_first(float* d, uint64_t da,
                                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63]), "=f"(d[64]), "=f"(d[65]), "=f"(d[66]), "=f"(d[67]), "=f"(d[68]), "=f"(d[69]), "=f"(d[70]), "=f"(d[71]), "=f"(d[72]), "=f"(d[73]), "=f"(d[74]), "=f"(d[75]), "=f"(d[76]), "=f"(d[77]), "=f"(d[78]), "=f"(d[79]), "=f"(d[80]), "=f"(d[81]), "=f"(d[82]), "=f"(d[83]), "=f"(d[84]), "=f"(d[85]), "=f"(d[86]), "=f"(d[87]), "=f"(d[88]), "=f"(d[89]), "=f"(d[90]), "=f"(d[91]), "=f"(d[92]), "=f"(d[93]), "=f"(d[94]), "=f"(d[95]), "=f"(d[96]), "=f"(d[97]), "=f"(d[98]), "=f"(d[99]), "=f"(d[100]), "=f"(d[101]), "=f"(d[102]), "=f"(d[103]), "=f"(d[104]), "=f"(d[105]), "=f"(d[106]), "=f"(d[107]), "=f"(d[108]), "=f"(d[109]), "=f"(d[110]), "=f"(d[111]), "=f"(d[112]), "=f"(d[113]), "=f"(d[114]), "=f"(d[115]), "=f"(d[116]), "=f"(d[117]), "=f"(d[118]), "=f"(d[119]), "=f"(d[120]), "=f"(d[121]), "=f"(d[122]), "=f"(d[123]), "=f"(d[124]), "=f"(d[125]), "=f"(d[126]), "=f"(d[127])
      : "l"(da), "l"(db), "r"(0));
}

// part: (n_split, k, C, C) float32 over (split, tap, ci, co).  Block order:
// output-channel tile fastest, then input-channel tile, tap, split.
__global__ void __launch_bounds__(SCW_THREADS, 1)
snake_conv_wgrad_kernel(const __grid_constant__ CUtensorMap zt_map,
                        const __grid_constant__ CUtensorMap dy_map,
                        float* __restrict__ part, int C, int k, int dil,
                        int n_tt, int n_ci, int n_co, int per_split,
                        int n_kt) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  const uint32_t full0 = base + SCW_BARS;
  const uint32_t empty0 = full0 + 8 * SCW_STAGES;
  int blk = blockIdx.x;
  const int co0 = (blk % n_co) * SCW_BN;
  blk /= n_co;
  const int ci0 = (blk % n_ci) * SCW_BM;
  blk /= n_ci;
  const int j = blk % k;
  const int split = blk / k;
  const int row_shift = j * dil;  // (j - (k-1)/2) * dil + hz
  const int kt0 = split * per_split;
  const int n_steps = min(per_split, n_kt - kt0);  // >= 1 (the caller's split)
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SCW_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, SCW_CONSUMERS * WG_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == SCW_CONSUMERS) {
    // ---- producer: one thread issues every copy
    if (threadIdx.x == SCW_CONSUMERS * WG_THREADS) {
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % SCW_STAGES;
        if (i >= SCW_STAGES) mbar_wait(empty0 + 8 * s, (i / SCW_STAGES - 1) & 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, SCW_STAGE_BYTES);
        const int kt = kt0 + i;
        const int b = kt / n_tt;
        const int t = (kt - b * n_tt) * SCW_BK;
        const uint32_t a = base + s * SCW_STAGE_BYTES;
        for (int w = 0; w < SCW_CONSUMERS; ++w)
          tma_load_3d(a + w * SCW_A_WG_BYTES, &zt_map, bar, ci0 + 64 * w,
                      t + row_shift, b);
        tma_load_3d(a + SCW_A_BYTES, &dy_map, bar, t, co0, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns input channels ci0 + 64 wg ... + 63.
  // Step 0 (every block has one) is peeled: its first product writes the
  // accumulator.
  float acc[SCW_BN / 2];
  const uint32_t a_off = wg * SCW_A_WG_BYTES;
  mbar_wait(full0, 0);
  wgmma_fence();
  wgmma_m64n256k16_ss_first(acc, sw128_desc(base + a_off),
                            sw128_desc(base + SCW_A_BYTES));
#pragma unroll
  for (int kk = 1; kk < SCW_BK / 16; ++kk)
    wgmma_m64n256k16_ss(acc, sw128_desc(base + a_off) + 128 * kk,
                        sw128_desc(base + SCW_A_BYTES) + 2 * kk);
  wgmma_commit();
  for (int i = 1; i < n_steps; ++i) {
    const int s = i % SCW_STAGES;
    mbar_wait(full0 + 8 * s, (i / SCW_STAGES) & 1);
    const uint32_t a = base + s * SCW_STAGE_BYTES;
    const uint64_t da = sw128_desc(a + a_off);
    const uint64_t db = sw128_desc(a + SCW_A_BYTES);
    fence_regs<SCW_BN / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SCW_BK / 16; ++kk)
      wgmma_m64n256k16_ss(acc, da + 128 * kk, db + 2 * kk);
    wgmma_commit();
    // step i-1's products are done: free its stage (one arrival per warp)
    wgmma_wait<1>();
    if ((threadIdx.x & 31) == 0)
      mbar_arrive(empty0 + 8 * ((i - 1) % SCW_STAGES));
  }
  wgmma_wait<0>();
  fence_regs<SCW_BN / 2>(acc);

  // ---- epilogue: rows g and g + 8 of each warp's 16, columns 2 t4, 2 t4 + 1
  // of each 8-column chunk, as float2 stores along co
  const int tid = threadIdx.x % WG_THREADS;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int ci = ci0 + 64 * wg + 16 * (tid >> 5) + g;
  float* row0 = part + (((size_t)split * k + j) * C + ci) * C;
  float* row1 = row0 + (size_t)8 * C;
#pragma unroll
  for (int i = 0; i < SCW_BN / 8; ++i) {
    const int co = co0 + 8 * i + 2 * t4;
    if (co < C) {
      *reinterpret_cast<float2*>(row0 + co) = make_float2(acc[4 * i], acc[4 * i + 1]);
      *reinterpret_cast<float2*>(row1 + co) = make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
}

// zt[b, r, c] = z[b, c, r - hz] for r in [hz, hz + T), zero for the other
// rows r < T + 2 hz: the transposed, padded A operand.  A block moves a tile
// of 64 rows x 64 channels through shared memory: reads along time, writes
// along channels, both coalesced (a tile row of 66 values keeps the
// column reads on distinct banks).
constexpr int SCW_ZT_THREADS = 256;
__global__ void __launch_bounds__(SCW_ZT_THREADS)
snake_conv_wgrad_zt_kernel(const __nv_bfloat16* __restrict__ z,
                           __nv_bfloat16* __restrict__ zt, int C, int T_len,
                           int hz, int rows) {
  __shared__ __nv_bfloat16 tile[64][66];
  const int r0 = blockIdx.x * 64, c0 = blockIdx.y * 64, b = blockIdx.z;
  const __nv_bfloat16* zb = z + ((size_t)b * C + c0) * T_len;
  for (int i = threadIdx.x; i < 64 * 64; i += SCW_ZT_THREADS) {
    const int c = i >> 6, t = r0 + (i & 63) - hz;
    tile[c][i & 63] = (t >= 0 && t < T_len) ? zb[(size_t)c * T_len + t]
                                            : __float2bfloat16(0.0f);
  }
  __syncthreads();
  __nv_bfloat16* ztb = zt + ((size_t)b * rows + r0) * C + c0;
  for (int i = threadIdx.x; i < 64 * 64; i += SCW_ZT_THREADS) {
    const int r = i >> 6, c = i & 63;
    if (r0 + r < rows) ztb[(size_t)r * C + c] = tile[c][r];
  }
}

// The tensor map of a 3-D bfloat16 tensor (d2, d1, d0), d0 contiguous, as
// (d0, d1, d2), boxes of (64, rows, 1) in the 128-byte swizzle, zeros
// outside.  Returns 0 or a CUDA error code.
static int make_map(CUtensorMap* map, const void* ptr, int d2, int d1, int d0,
                    int rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * 2, (cuuint64_t)d1 * d0 * 2};
  const cuuint32_t box[3] = {64u, (cuuint32_t)rows, 1u};
  const cuuint32_t elem[3] = {1u, 1u, 1u};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
static_assert(SCW_BK == 64, "both maps' boxes are 64 values wide");

// z: (B, C, T) bfloat16; zt: scratch for z transposed and padded, (B, hz +
// T + hz, C) bfloat16 with hz = (k-1)/2 * dil; dy: (B, C, T8) bfloat16, T8 =
// T rounded up to a multiple of 8 (its map's row stride), the times from T
// on zero; zt and dy 16-byte aligned; part: (n_split, k, C, C) float32.
// Every split must hold at least one step: n_split = ceil(n_kt / ceil(n_kt /
// n_split)), n_kt = B * ceil(T8 / SCW_BK).
extern "C" int snake_conv_wgrad(const void* z, void* zt, const void* dy,
                                void* part, int B, int C, int T_len, int k,
                                int dil, int n_split, void* stream) {
  if (B <= 0 || C <= 0 || C % SCW_BM != 0 || T_len <= 0 || k % 2 != 1 ||
      dil < 1 || n_split < 1)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)zt | (uintptr_t)dy) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int t8 = (T_len + 7) / 8 * 8;
  const int hz = (k - 1) / 2 * dil;
  const int zt_rows = T_len + 2 * hz;
  const int n_tt = (t8 + SCW_BK - 1) / SCW_BK;
  const long long n_kt = (long long)B * n_tt;
  const int per_split = (int)((n_kt + n_split - 1) / n_split);
  if (n_kt > 2147483647LL || (long long)(n_split - 1) * per_split >= n_kt ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_ci = C / SCW_BM;
  const int n_co = (C + SCW_BN - 1) / SCW_BN;
  const long long blocks = (long long)n_split * k * n_ci * n_co;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2];
  int e = make_map(&maps[0], zt, B, zt_rows, C, 64);
  if (e == 0) e = make_map(&maps[1], dy, B, C, t8, SCW_BN);
  if (e == 0) e = allow_smem<snake_conv_wgrad_kernel>(SCW_SMEM);
  if (e != 0) return e;
  cudaStream_t s = (cudaStream_t)stream;
  snake_conv_wgrad_zt_kernel<<<dim3((zt_rows + 63) / 64, C / 64, B),
                               SCW_ZT_THREADS, 0, s>>>(
      (const __nv_bfloat16*)z, (__nv_bfloat16*)zt, C, T_len, hz, zt_rows);
  snake_conv_wgrad_kernel<<<(unsigned)blocks, SCW_THREADS, SCW_SMEM + TILE_ALIGN,
                            s>>>(maps[0], maps[1], (float*)part, C, k, dil,
                                 n_tt, n_ci, n_co, per_split, (int)n_kt);
  return (int)cudaGetLastError();
}
