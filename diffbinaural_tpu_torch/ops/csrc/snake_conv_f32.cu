// Fused alias-free snake activation -> k-tap dilated Conv1d, forward, float32:
//   out[b, co, t] = bias[co] + sum_{j, ci} w[co, ci, j] * z[b, ci, t + (j-ctr)*dil]
//   z = down2(snake(up2(x)))   (afa_common.cuh), z == 0 outside [0, T)
// on (B, C, T) with C_in == C_out == C, C % 128 == 0, odd k, stride 1.
//
// Replaces the Pallas kernel _kernel (fused_snake_conv -> _fused_forward) of
// diffbinaural_tpu/ops/snake_conv.py for float32 inputs; snake_conv.cu is the
// bfloat16 instance.
//
// Bound by operations: 2*B*T*k*C*C FLOP, which the tensor cores take as
// three TF32 products per float32 product (split TF32, flash_f32_hopper.cuh:
// x = hi + lo, a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi; one TF32 product
// alone would miss the float32 checks), plus the activation on the CUDA cores
// once per output-channel block.  An implicit GEMM on wgmma, as the bfloat16
// block, out[t, co] = bias[co] + sum_j Z[t + j*dil, :] . W_j[co, :]^T:
//   * A block owns SCF_TM = 128 time steps of one batch element (two
//     warpgroups of 64 rows) and N output channels (192 where C allows, else
//     128; scf_co_block): both warpgroups read the same weight tile, so the
//     weight streams from L2 once per 128 steps.
//   * Z in float32 over all C would not fit shared memory (as tf32 hi and lo
//     it would take 8 bytes per element), so the input channels go in chunks
//     of SCF_CH.  Per chunk the threads activate its channels into Z as two
//     [row][channel] tiles of tf32 bits, hi and lo, 128 + 2 HZ rows each, 16
//     bytes of padding per row so that ldmatrix's eight row addresses fall on
//     distinct banks.  The activation is per channel: chunking recomputes
//     nothing.  The chunk's x windows (128 + 2 HZ + 10 samples a channel,
//     clamped to the row) are first copied into shared memory, coalesced
//     along t; then a thread computes a run of SCF_RUN rows of one channel
//     in registers, as K2 does (afa_common.cuh:afa_run).  With only eight
//     warps on the SM, a warp per channel through a shared-memory lattice
//     (the bfloat16 block's way) took as long as the products, and runs
//     reading x from device memory, 32 rows per load, nearly as long
//     (PERF.md).
//   * The weight's hi / lo split is a pre-pass (snake_conv_f32_split_kernel)
//     into a scratch laid out step by step: each step (chunk, tap, 8 input
//     channels) is one contiguous stage, its hi tile then its lo tile, each
//     in wgmma's no-swizzle K-major core-matrix order (8 rows x 16 bytes,
//     k-halves 128 bytes apart, 8-row groups 256 bytes apart).  Thread 0
//     brings a stage with one bulk copy into a ring (mbarrier full / empty)
//     as soon as every warp has freed it; the ring runs on across chunks, so
//     the next chunk's first stages arrive during its activation.
//   * .tf32 wgmma reads shared memory K-major only, and both operands are
//     K-major here (Z as [row][channel], W as [co][ci]).  A comes from
//     registers: ldmatrix b16 x4 at the tap's row offset j*dil (a row
//     address, which no descriptor expresses) gives each lane one 32-bit
//     element of four 8-row x 4-column tiles, (row lane/4, column lane%4) of
//     rows 0-7 | 8-15 at columns 0-3, then 4-7: the m64n*k8 tf32 A fragment
//     in order.  Each step issues the three products; one step stays in
//     flight while the next one's A (hi and lo) is loaded.
//   * The tensor cores' float32 accumulation does not round to nearest and
//     drifts with the length of the sum, so each chunk's k * SCF_CH / 8 steps
//     go into a fresh accumulator (its first product writes it) that is added
//     to the running sum on the CUDA cores.
//   * Epilogue: bias added, stored straight from the running sum: each
//     store writes eight consecutive time steps (32 bytes) of each of four
//     output channels.
// No atomics and no split over input channels: the same bits every run.
// Registers: the fresh accumulator and the running sum take N / 2 each of
// 255 (two warpgroups, 256 threads), A's hi and lo 16 in two sets; ptxas
// places the 192-channel block in 255 without a spill, which chip_smoke.py's
// build phase checks.
#include "snake_conv_common.cuh"
#include "flash_f32_hopper.cuh"

constexpr int SCF_TM = 128;           // time steps per block: two warpgroups
constexpr int SCF_THREADS = 2 * WG_THREADS;
constexpr int SCF_WARPS = SCF_THREADS / 32;
constexpr int SCF_CH = 64;            // input channels per chunk
constexpr int SCF_KC = 8;             // input channels per step (wgmma K)
constexpr int SCF_ZPAD = 16;          // padding bytes per Z row
constexpr int SCF_Z_ROW = SCF_CH * 4 + SCF_ZPAD;  // bytes per row of Z hi (lo)
constexpr int SCF_MAX_STAGES = 8;
constexpr int SCF_RUN = 8;            // activation: rows of one channel per thread
constexpr int SCF_BAR_BYTES = 16 * SCF_MAX_STAGES;  // full[8], empty[8]

// Output channels per block: 192 where C allows (at C = 768: four groups,
// 112 blocks at (1, 768, 3584), one wave), else 128.
static int scf_co_block(int C) { return C % 192 == 0 ? 192 : 128; }

// Shared-memory plan of one launch: Z hi | Z lo | x windows | ring stages |
// barriers (after the base is aligned to TILE_ALIGN).  A channel's x window
// takes xs_row floats: room for the last run's reads, one more than a
// multiple of 32, so that the lanes of a warp (neighbouring channels) read
// distinct banks.  Returns false if it does not fit.
struct ScfPlan {
  int zr, z_bytes, xs_row, xs_bytes, stages, bytes;
};
static bool scf_plan(int k, int dil, int stage_bytes, ScfPlan* p) {
  const int hz = (k - 1) / 2 * dil;
  p->zr = SCF_TM + 2 * hz;
  p->z_bytes = round_up(2 * p->zr * SCF_Z_ROW, TILE_ALIGN);
  p->xs_row = round_up(p->zr + SCF_RUN + 10, 32) + 1;
  p->xs_bytes = round_up(SCF_CH * p->xs_row * 4, TILE_ALIGN);
  const int avail = MAX_DYNAMIC_SMEM - TILE_ALIGN - p->z_bytes - p->xs_bytes -
                    SCF_BAR_BYTES;
  p->stages = avail / stage_bytes;
  if (p->stages > SCF_MAX_STAGES) p->stages = SCF_MAX_STAGES;
  p->bytes = p->z_bytes + p->xs_bytes + p->stages * stage_bytes + SCF_BAR_BYTES;
  return p->stages >= 2;
}

// d (64 x 128, f32) += A (64 x 8, tf32 in registers, the mma.sync
// A-fragment layout) B (8 x 128, tf32 in shared memory, K-major).
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(
    float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// The same with d = A B: the accumulator is written, not read.
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs_first(
    float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}
// d (64 x 192, f32) += A (64 x 8, tf32 in registers, the mma.sync
// A-fragment layout) B (8 x 192, tf32 in shared memory, K-major).
__device__ __forceinline__ void wgmma_m64n192k8_tf32_rs(
    float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// The same with d = A B: the accumulator is written, not read.
__device__ __forceinline__ void wgmma_m64n192k8_tf32_rs_first(
    float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63]), "=f"(d[64]), "=f"(d[65]), "=f"(d[66]), "=f"(d[67]), "=f"(d[68]), "=f"(d[69]), "=f"(d[70]), "=f"(d[71]), "=f"(d[72]), "=f"(d[73]), "=f"(d[74]), "=f"(d[75]), "=f"(d[76]), "=f"(d[77]), "=f"(d[78]), "=f"(d[79]), "=f"(d[80]), "=f"(d[81]), "=f"(d[82]), "=f"(d[83]), "=f"(d[84]), "=f"(d[85]), "=f"(d[86]), "=f"(d[87]), "=f"(d[88]), "=f"(d[89]), "=f"(d[90]), "=f"(d[91]), "=f"(d[92]), "=f"(d[93]), "=f"(d[94]), "=f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

template <int N>
__device__ __forceinline__ void scf_wgmma(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (N == 192) {
    wgmma_m64n192k8_tf32_rs(d, a, db);
  } else {
    wgmma_m64n128k8_tf32_rs(d, a, db);
  }
}
template <int N>
__device__ __forceinline__ void scf_wgmma_first(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (N == 192) {
    wgmma_m64n192k8_tf32_rs_first(d, a, db);
  } else {
    wgmma_m64n128k8_tf32_rs_first(d, a, db);
  }
}

// The warpgroups' product loop.  Step s of the block is chunk s / per_chunk;
// inside its chunk, step r = s % per_chunk is tap j = r / (SCF_CH / 8) and
// input channels 8 (r % (SCF_CH / 8)) ... + 7 of the chunk.
struct ScfStep {
  uint32_t a_base;   // this lane's ldmatrix row address in Z hi at step 0
  int lo_bytes;      // Z lo - Z hi
  int tap_bytes;     // Z bytes per tap: dil rows
  int stages, stage_bytes, tile_bytes, n_steps;
  uint32_t ring0, full0, empty0;
  const uint8_t* wsrc;  // the block's weight stages, step by step
  __device__ __forceinline__ uint32_t a_addr(int r) const {
    const int j = r / (SCF_CH / SCF_KC);
    return a_base + j * tap_bytes + (r - j * (SCF_CH / SCF_KC)) * (SCF_KC * 4);
  }
};
// Thread 0: bulk copy of step s's stage (hi and lo tiles) into its slot,
// once every warp has freed the slot (skipped for the first round).
__device__ __forceinline__ void scf_load(const ScfStep& st, int s) {
  if (s >= st.n_steps) return;
  const int slot = s % st.stages;
  if (s >= st.stages) mbar_wait(st.empty0 + 8 * slot, (s / st.stages - 1) & 1);
  const uint32_t bar = st.full0 + 8 * slot;
  mbar_expect_tx(bar, st.stage_bytes);
  bulk_load(st.ring0 + slot * st.stage_bytes,
            st.wsrc + (size_t)s * st.stage_bytes, st.stage_bytes, bar);
}
// A of chunk step r: hi in a[0..3], lo in a[4..7].
__device__ __forceinline__ void scf_load_a(const ScfStep& st, int r, uint32_t* a) {
  const uint32_t addr = st.a_addr(r);
  ldmatrix_x4(a, addr);
  ldmatrix_x4(a + 4, addr + st.lo_bytes);
}
// Issue step s's three products: a_lo b_hi (which writes a fresh
// accumulator at a chunk's first step), a_hi b_lo, a_hi b_hi.
template <int N, bool FRESH>
__device__ __forceinline__ void scf_issue(const ScfStep& st, int s, float* acc,
                                          const uint32_t* a) {
  const int slot = s % st.stages;
  mbar_wait(st.full0 + 8 * slot, (s / st.stages) & 1);
  const uint32_t b = st.ring0 + slot * st.stage_bytes;
  const uint64_t b_hi = sch_desc(b), b_lo = sch_desc(b + st.tile_bytes);
  // a fresh accumulator's old values are dead (added to the running sum)
  if constexpr (!FRESH) fence_regs<N / 2>(acc);
  wgmma_fence();
  if constexpr (FRESH) {
    scf_wgmma_first<N>(acc, a + 4, b_hi);
  } else {
    scf_wgmma<N>(acc, a + 4, b_hi);
  }
  scf_wgmma<N>(acc, a, b_lo);
  scf_wgmma<N>(acc, a, b_hi);
  wgmma_commit();
}
// Free step s's slot (one arrival per warp) and (thread 0) refill it with
// step s + stages.
__device__ __forceinline__ void scf_release(const ScfStep& st, int s) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(st.empty0 + 8 * (s % st.stages));
  if (threadIdx.x == 0) scf_load(st, s + st.stages);
  __syncwarp();
}
// Load A of step s (chunk step r) into cur, issue it, wait for step s-1
// (whose A is in prev) and free its slot.
template <int N>
__device__ __forceinline__ void scf_next(const ScfStep& st, int s, int r, float* acc,
                                         uint32_t* cur, uint32_t* prev) {
  scf_load_a(st, r, cur);
  scf_issue<N, false>(st, s, acc, cur);
  wgmma_wait<1>();
  fence_regs<8>(prev);
  scf_release(st, s - 1);
}

// Step 1 of a chunk: Z hi / lo [r][ci - c0] = split(z[t_lo + r]) for the
// chunk's SCF_CH input channels, r < zr.  First the x windows xs[ci - c0][p]
// = x[ci][clamp(t_lo - 5 + p)], p < zr + 10, coalesced along t.  Then a
// thread takes a run of SCF_RUN rows of one channel (the lanes of a warp:
// neighbouring channels, so that their reads of xs and stores to Z fall on
// distinct banks) and computes it in registers: the lattice's two phases with
// their halo, the down-FIR, the lattice clamp only in a run that touches an
// edge.  Rows outside [0, T) are zero (the convolution's zero padding).
__device__ __forceinline__ void scf_activate(const float* __restrict__ xb,
                                             const float* __restrict__ alpha,
                                             const float* __restrict__ inv_beta,
                                             int c0, int T_len, int t_lo, int zr,
                                             float* xs, int xs_row, uint8_t* zp,
                                             int lo_bytes) {
  const int xw_len = zr + 10;
  for (int i = threadIdx.x; i < SCF_CH * xw_len; i += SCF_THREADS) {
    const int cl = i / xw_len, p = i - cl * xw_len;
    xs[cl * xs_row + p] =
        xb[(size_t)(c0 + cl) * T_len + afa_clamp(t_lo - 5 + p, 0, T_len - 1)];
  }
  __syncthreads();
  const int items = (zr + SCF_RUN - 1) / SCF_RUN * SCF_CH;
  for (int it = threadIdx.x; it < items; it += SCF_THREADS) {
    const int cl = it % SCF_CH, r0 = it / SCF_CH * SCF_RUN;
    const int ci = c0 + cl, t0 = t_lo + r0;
    const float a = alpha[ci], ib = inv_beta[ci];
    // the last run's window may reach past zr + 10 (into the row's padding):
    // only rows >= zr, which are not stored, use those values
    float xw[SCF_RUN + 10], z[SCF_RUN];
#pragma unroll
    for (int p = 0; p < SCF_RUN + 10; ++p) xw[p] = xs[cl * xs_row + r0 + p];
    if (t0 >= 5 && t0 + SCF_RUN + 5 <= T_len) {
      afa_run<SCF_RUN, false>(xw, t0, T_len, a, ib, 0.0f, 0.0f, z);
    } else {
      const float* row = xb + (size_t)ci * T_len;
      afa_run<SCF_RUN, true>(xw, t0, T_len, a, ib,
                             afa_mid_row<true>(row, T_len, 0, a, ib),
                             afa_mid_row<true>(row, T_len, 2 * T_len - 1, a, ib), z);
    }
    uint8_t* at = zp + r0 * SCF_Z_ROW + 4 * cl;
#pragma unroll
    for (int i = 0; i < SCF_RUN; ++i) {
      if (r0 + i < zr) {
        const int t = t0 + i;
        uint32_t hi, lo;
        split_tf32(t >= 0 && t < T_len ? z[i] : 0.0f, hi, lo);
        *reinterpret_cast<uint32_t*>(at + i * SCF_Z_ROW) = hi;
        *reinterpret_cast<uint32_t*>(at + i * SCF_Z_ROW + lo_bytes) = lo;
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(SCF_THREADS, 1)
snake_conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ alpha,
                      const float* __restrict__ inv_beta,
                      const uint32_t* __restrict__ wb,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int C, int T_len, int k, int dil, int n_tt, int n_groups,
                      int zr, int z_bytes, int xs_row, int xs_bytes, int stages) {
  constexpr int STAGE_BYTES = N * SCF_KC * 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  uint8_t* zp = smem_raw + (base - smem_u32(smem_raw));
  float* xs = reinterpret_cast<float*>(zp + z_bytes);
  const uint32_t ring0 = base + z_bytes + xs_bytes;
  const uint32_t full0 = ring0 + stages * STAGE_BYTES;
  const uint32_t empty0 = full0 + 8 * SCF_MAX_STAGES;
  const int hz = (k - 1) / 2 * dil;
  const int lo_bytes = zr * SCF_Z_ROW;
  int blk = blockIdx.x;
  const int grp = blk % n_groups;
  blk /= n_groups;
  const int tb = (blk % n_tt) * SCF_TM;
  const int b = blk / n_tt;
  const int per_chunk = k * (SCF_CH / SCF_KC);  // even: 8k
  const int n_steps = C / SCF_CH * per_chunk;

  const int tid = threadIdx.x % WG_THREADS;
  const int wg = threadIdx.x / WG_THREADS;
  const int warp = tid >> 5, lane = tid & 31;
  // ldmatrix x4: lanes 0-7 / 8-15 / 16-23 / 24-31 give the row addresses of
  // the four 8-row x 16-byte tiles (rows 0-7 | 8-15 at columns 0-3, then at
  // columns 4-7 of the step's 8 channels): registers a0..a3 of the tf32 A
  // fragment, (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
  const uint32_t a_base =
      base + (64 * wg + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * SCF_Z_ROW +
      16 * (lane >> 4);
  const ScfStep st{a_base, lo_bytes, dil * SCF_Z_ROW, stages, STAGE_BYTES,
                   N * SCF_KC * 4, n_steps, ring0, full0, empty0,
                   reinterpret_cast<const uint8_t*>(wb) +
                       (size_t)grp * n_steps * STAGE_BYTES};

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, SCF_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) scf_load(st, s);
  }

  const float* xb = x + (size_t)b * C * T_len;
  float sum[N / 2], acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sum[i] = 0.0f;
  uint32_t a0[8], a1[8];
  for (int c0 = 0; c0 < C; c0 += SCF_CH) {
    // every warpgroup is done with the previous chunk's Z
    __syncthreads();
    scf_activate(xb, alpha, inv_beta, c0, T_len, tb - hz, zr, xs, xs_row, zp,
                 lo_bytes);
    __syncthreads();

    // the chunk's products into a fresh accumulator: A alternates between
    // two register sets (per_chunk is even), so no branch surrounds a wgmma
    const int s0 = c0 / SCF_CH * per_chunk;
    scf_load_a(st, 0, a0);
    scf_issue<N, true>(st, s0, acc, a0);
    for (int r = 1; r < per_chunk - 1; r += 2) {
      scf_next<N>(st, s0 + r, r, acc, a1, a0);
      scf_next<N>(st, s0 + r + 1, r + 1, acc, a0, a1);
    }
    scf_next<N>(st, s0 + per_chunk - 1, per_chunk - 1, acc, a1, a0);
    wgmma_wait<0>();
    fence_regs<N / 2>(acc);
    fence_regs<8>(a1);
    scf_release(st, s0 + per_chunk - 1);
    add_tile<N / 2>(sum, acc);
  }

  // epilogue: thread (g, t4) of warp w holds rows 16 w + g (+ 8) and, per
  // 8-column group i, columns 8 i + 2 t4 (+ 1).  One output pointer walks
  // the groups: with a pointer per group the 192-channel block spilled 32
  // bytes (PERF.md)
  const int g = lane >> 2, t4 = lane & 3;
  const int t_row = tb + 64 * wg + 16 * warp + g;
  const float* bp = bias + grp * N + 2 * t4;
  float* r0 = out + ((size_t)b * C + grp * N + 2 * t4) * T_len + t_row;
#pragma unroll
  for (int i = 0; i < N / 8; ++i, r0 += 8 * (size_t)T_len) {
    const float b0 = bp[8 * i], b1 = bp[8 * i + 1];
    if (t_row < T_len) {
      r0[0] = sum[4 * i] + b0;
      r0[T_len] = sum[4 * i + 1] + b1;
    }
    if (t_row + 8 < T_len) {
      r0[8] = sum[4 * i + 2] + b0;
      r0[T_len + 8] = sum[4 * i + 3] + b1;
    }
  }
}

// w (C, C, k) float32, F.conv1d's (out, in, tap) -> the kernel's stages in
// order, as tf32 bits: (C / N, C / SCF_CH, k, SCF_CH / 8, 2, N / 8, 2, 8, 4)
// over (group, chunk, tap, 8-channel step, hi | lo, 8-row group, k-half,
// row, column); row = output channel, column = input channel.  A thread
// takes one weight and writes its hi and lo.
__global__ void __launch_bounds__(256)
snake_conv_f32_split_kernel(const float* __restrict__ w, uint32_t* __restrict__ wb,
                            int C, int k, int n, long long total) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  const int tile = n * SCF_KC;             // values of one hi (or lo) tile
  const int e = (int)(i % tile);
  const long long stage = i / tile;        // group * n_steps + step
  const int per_chunk = k * (SCF_CH / SCF_KC);
  const int n_steps = C / SCF_CH * per_chunk;
  const int grp = (int)(stage / n_steps), s = (int)(stage % n_steps);
  const int chunk = s / per_chunk, r = s % per_chunk;
  const int j = r / (SCF_CH / SCF_KC), kk = r % (SCF_CH / SCF_KC);
  const int q = e & 3, row = (e >> 2) & 7, half = (e >> 5) & 1, n8 = e >> 6;
  const int co = grp * n + 8 * n8 + row;
  const int ci = chunk * SCF_CH + SCF_KC * kk + 4 * half + q;
  uint32_t hi, lo;
  split_tf32(w[((size_t)co * C + ci) * k + j], hi, lo);
  const size_t o = (size_t)stage * 2 * tile + e;
  wb[o] = hi;
  wb[o + tile] = lo;
}

template <int N>
static int scf_launch(const void* x, const void* alpha, const void* inv_beta,
                      const void* w, void* w_split, const void* bias, void* out,
                      int B, int C, int T_len, int k, int dil, cudaStream_t s) {
  constexpr int STAGE_BYTES = N * SCF_KC * 8;
  ScfPlan plan;
  if (C % N != 0 || !scf_plan(k, dil, STAGE_BYTES, &plan))
    return (int)cudaErrorInvalidValue;
  // the whole of it allowed once per device, whatever this launch's plan
  int e = allow_smem<snake_conv_f32_kernel<N>>(MAX_DYNAMIC_SMEM - TILE_ALIGN);
  if (e != 0) return e;
  const int n_tt = (T_len + SCF_TM - 1) / SCF_TM;
  const int n_groups = C / N;
  const long long blocks = (long long)B * n_tt * n_groups;
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const long long total = (long long)k * C * C;
  snake_conv_f32_split_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      (const float*)w, (uint32_t*)w_split, C, k, N, total);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  snake_conv_f32_kernel<N><<<(unsigned)blocks, SCF_THREADS, plan.bytes + TILE_ALIGN, s>>>(
      (const float*)x, (const float*)alpha, (const float*)inv_beta,
      (const uint32_t*)w_split, (const float*)bias, (float*)out, C, T_len, k,
      dil, n_tt, n_groups, plan.zr, plan.z_bytes, plan.xs_row, plan.xs_bytes,
      plan.stages);
  return (int)cudaGetLastError();
}

// x, out (B, C, T) float32; w (C, C, k) float32 (F.conv1d's layout); w_split:
// scratch of 2 * k * C * C floats, 16-byte aligned, for the weight's hi / lo
// stages; alpha, inv_beta, bias (C,) float32.
extern "C" int snake_conv_f32_forward(const void* x, const void* alpha,
                                      const void* inv_beta, const void* w,
                                      void* w_split, const void* bias,
                                      void* out, int B, int C, int T_len,
                                      int k, int dil, void* stream) {
  if (C % 128 != 0 || k % 2 != 1 || dil < 1) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)w_split % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (scf_co_block(C) == 192)
    return scf_launch<192>(x, alpha, inv_beta, w, w_split, bias, out, B, C,
                           T_len, k, dil, s);
  return scf_launch<128>(x, alpha, inv_beta, w, w_split, bias, out, B, C, T_len,
                         k, dil, s);
}
