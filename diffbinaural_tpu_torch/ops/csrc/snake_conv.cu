// Fused alias-free snake activation -> k-tap dilated Conv1d, forward:
//   out[b, co, t] = bias[co] + sum_{j, ci} w[co, ci, j] * z[b, ci, t + (j-ctr)*dil]
//   z = down2(snake(up2(x)))   (afa_common.cuh), z == 0 outside [0, T)
// on (B, C, T) with C_in == C_out == C, C % 128 == 0, odd k, stride 1.
//
// Replaces the Pallas kernel _kernel (fused_snake_conv -> _fused_forward) of
// diffbinaural_tpu/ops/snake_conv.py.
//
// Bound by operations (2*B*T*k*C*C FLOP against (2*B*C*T + k*C*C) elements
// moved).  This file holds the bfloat16 instance; the float32 one, split-TF32
// products in blocks of the same kind, is snake_conv_f32.cu.
//
// bfloat16 (snake_conv_wg_kernel): an implicit GEMM on the tensor cores,
//   out[t, co] = bias[co] + sum_j Z[t + j*dil, :] . W_j[co, :]^T,
// the activation computed once per element.  A block owns SCH_TM = 64 time
// steps of one batch element and CO_BLK output channels (all 768 at
// C = 768: three warpgroups of 64 x 256, so no output-channel tile
// recomputes the activation; two groups of 384 when the grid would fill
// fewer than half the SMs).
//   1. Every warp activates input channels into Z, a [row][channel] bfloat16
//      tile of the 64 steps and the convolution's halo HZ on each side
//      (64 + 2 HZ rows, 16 bytes of padding per row so that ldmatrix's eight
//      row addresses fall on distinct banks).  Per channel, a warp loads
//      the x window (coalesced, one channel ahead, clamped only in tiles
//      that touch an edge) into a small float32 scratch, computes the 2x-rate
//      lattice from it, then the down-FIR, zero outside [0, T) (the
//      convolution's zero padding), rounded to bfloat16 as the TPU kernel's
//      scratch and the plain version round it.  Meanwhile the weight ring has started
//      to fill.
//   2. The product runs over k * C / 16 steps (tap-major, 16 input channels
//      each).  W_j[co-block, 16 channels] streams with one bulk copy per
//      step into a ring of stages (mbarrier full / empty), issued by thread
//      0 as soon as every warp has freed the stage (no producer warpgroup:
//      with one, 512 threads would cap each at 128 registers, fewer than a
//      64 x 256 float32 accumulator and its operands).  The
//      host lays the weight out so that each step's tile is contiguous and
//      already in wgmma's no-swizzle K-major core-matrix order (8 rows x 16
//      bytes, k-halves 128 bytes apart, 8-row groups 256 bytes apart).  Each
//      warpgroup loads its A fragment from Z with ldmatrix at row offset
//      j*dil — a tap shift is a row address, which no shared-memory
//      descriptor could express — and issues wgmma m64nNk16 with A in
//      registers; one product stays in flight while the next is loaded.
//   3. Epilogue: bias added in float32, the 64 x N tile staged through the
//      space of Z and the ring as [co][t] bfloat16 and stored as rows
//      coalesced along t.
// No atomics and no split over input channels: the same bits every run.
// The ring's last stage(s) hold the activation's scratch until the product
// starts, so only the stages before them are loaded during the activation.
//
// The same block, without the activation, is K3b's dz kernel
// (snake_conv_dgrad_kernel, snake_conv_dgrad): the gradient of a stride-1
// convolution with respect to its input is the convolution of dy with the
// kernel's channels swapped and taps reversed, W~[ci, co, j] = W[co, ci,
// k-1-j], at the same padding and dilation.  So Z is a copy of dy (step 1
// copies it, transposing to [row][channel], rows outside the clip zeroed)
// and the weight ring streams W~: the wrapper lays W out with channels
// swapped (ops/snake_conv.py:dgrad_blocked_weight) and the ring takes its
// taps in reverse order (SchStep::w_step); no bias.  It replaces the
// input half of the VJP of the XLA convolution in _core_bwd
// (diffbinaural_tpu/ops/snake_conv.py:197-207).
#include "snake_conv_common.cuh"

constexpr int SCH_TM = 64;            // time steps per block (wgmma M)
constexpr int SCH_KC = 16;            // input channels per step (wgmma K)
constexpr int SCH_ZPAD = 16;          // padding bytes per Z row
constexpr int SCH_MAX_STAGES = 8;
constexpr int SCH_XW_MAX = 128;       // activation: x window per channel
constexpr int SCH_RUN = 3;            // activation: points / rows per lane
constexpr int SCH_RUN_SLACK = SCH_RUN + 5;
// A warp's activation scratch in floats: the x window, the two lattice
// phases, each with the slack its last run reads past the end.
__host__ __device__ constexpr int sch_scratch_floats(int zr) {
  return (zr + 10) + 2 * (zr + 5) + 3 * SCH_RUN_SLACK;
}
constexpr int SCH_OUT_ROW = 2 * SCH_TM + 4;  // epilogue: bytes per [co] row
constexpr int SCH_BAR_BYTES = 16 * SCH_MAX_STAGES;  // full[8], empty[8]

// The three shapes of a block: NCONS warpgroups of N output channels each,
// CO_BLK = N * NCONS, picked by sch_co_block.  Registers: 65536 / THREADS
// per thread at most (168 at three warpgroups), of which the 64 x N float32
// accumulator takes N / 2.
template <int N, int NCONS>
struct SchCfg {
  static constexpr int CO_BLK = N * NCONS;
  static constexpr int THREADS = NCONS * WG_THREADS;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int STAGE_BYTES = CO_BLK * SCH_KC * 2;
  static constexpr int REGS = 65536 / THREADS / 8 * 8 < 255
                                  ? 65536 / THREADS / 8 * 8 : 255;
};
static_assert(256 / 2 + 2 * 4 + 16 <= SchCfg<256, 3>::REGS, "K3 registers");

// All 768 output channels in one block (no group activates the tile again)
// while the grid fills at least half the SMs; on a shorter grid (the
// stage-2 step's 16 x 256 samples: 64 time tiles) two groups of 384 double
// the blocks, each activating the tile.
static int sch_co_block(int C, int B, int T_len, int sms) {
  const int tiles = B * ((T_len + SCH_TM - 1) / SCH_TM);
  if (C % 768 == 0 && 2 * tiles * (C / 768) >= sms) return 768;
  if (C % 384 == 0) return 384;
  return 128;
}

// Shared-memory plan of one launch: Z | ring stages | barriers (after the
// base is aligned to TILE_ALIGN).  Returns false if it does not fit.  ACT:
// the forward, whose activation reads an x window of at most SCH_XW_MAX and
// borrows the ring's last stages as scratch; the dz kernel needs neither.
// ops/snake_conv.py:sch_plan is its transcription, which the model's gate
// asks before it sends a convolution to these kernels.
struct SchPlan {
  int z_bytes, stages, pre_stages, bytes;
};
static bool sch_plan(int C, int k, int dil, int warps, int stage_bytes,
                     bool act, SchPlan* p) {
  const int hz = (k - 1) / 2 * dil;
  const int zr = SCH_TM + 2 * hz;
  p->z_bytes = round_up(zr * (2 * C + SCH_ZPAD), TILE_ALIGN);
  const int avail = MAX_DYNAMIC_SMEM - TILE_ALIGN - p->z_bytes - SCH_BAR_BYTES;
  p->stages = avail / stage_bytes;
  if (p->stages > SCH_MAX_STAGES) p->stages = SCH_MAX_STAGES;
  const int scratch = act ? warps * sch_scratch_floats(zr) * 4 : 0;
  const int scratch_stages = (scratch + stage_bytes - 1) / stage_bytes;
  p->pre_stages = p->stages - scratch_stages;
  p->bytes = p->z_bytes + p->stages * stage_bytes + SCH_BAR_BYTES;
  // the epilogue stages CO_BLK rows of SCH_OUT_ROW bytes in the space of Z
  // and the ring, both idle by then
  return (!act || zr + 10 <= SCH_XW_MAX) && p->stages >= 2 &&
         p->pre_stages >= 1 &&
         stage_bytes / (SCH_KC * 2) * SCH_OUT_ROW <=
             p->z_bytes + p->stages * stage_bytes;
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// d (64 x 256, f32) += A (64 x 16, bfloat16 in registers, the mma.sync
// A-fragment layout) B (16 x 256, shared memory, K-major: the tile's rows are
// the n index, so the transpose bit is clear).
__device__ __forceinline__ void wgmma_m64n256k16_rs_kmajor(float* d, const uint32_t* a,
                                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (64 x 128, f32) += A (64 x 16, bfloat16 in registers, the mma.sync
// A-fragment layout) B (16 x 128, shared memory, K-major: the tile's rows are
// the n index, so the transpose bit is clear).
__device__ __forceinline__ void wgmma_m64n128k16_rs_kmajor(float* d, const uint32_t* a,
                                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void sch_wgmma(float* d, const uint32_t* a,
                                          uint64_t db) {
  if constexpr (N == 256) {
    wgmma_m64n256k16_rs_kmajor(d, a, db);
  } else {
    wgmma_m64n128k16_rs_kmajor(d, a, db);
  }
}

// The warpgroups' product loop: step s is tap j = s / c16 and input
// channels 16 (s % c16) ... + 15.
struct SchStep {
  uint32_t a_base;   // this lane's ldmatrix row address at step 0
  int tap_bytes;     // Z bytes per tap: dil rows
  int c16, stages, stage_bytes, n_steps;
  int rev_k;         // dz kernel: k, its weight tiles in reversed tap order
  uint32_t ring0, b0, full0, empty0;  // b0: ring stage 0 + this warpgroup's rows
  const uint8_t* wsrc;                // the block's weight tiles, step by step
  __device__ __forceinline__ uint32_t a_addr(int s) const {
    const int j = s / c16;
    return a_base + j * tap_bytes + (s - j * c16) * (SCH_KC * 2);
  }
  // the weight tile of step s: tap j, or tap k-1-j of the dz kernel's
  // weight (W~'s tap j is W's tap k-1-j)
  __device__ __forceinline__ int w_step(int s) const {
    if (rev_k == 0) return s;
    const int j = s / c16;
    return s + (rev_k - 1 - 2 * j) * c16;
  }
};
// Thread 0: bulk copy of step s's weight tile into its stage, once every
// warp has freed the stage (skipped for the first round).
__device__ __forceinline__ void sch_load(const SchStep& st, int s) {
  if (s >= st.n_steps) return;
  const int slot = s % st.stages;
  if (s >= st.stages) mbar_wait(st.empty0 + 8 * slot, (s / st.stages - 1) & 1);
  const uint32_t bar = st.full0 + 8 * slot;
  mbar_expect_tx(bar, st.stage_bytes);
  bulk_load(st.ring0 + slot * st.stage_bytes,
            st.wsrc + (size_t)st.w_step(s) * st.stage_bytes, st.stage_bytes,
            bar);
}
template <int N>
__device__ __forceinline__ void sch_issue(const SchStep& st, int s, float* acc,
                                          const uint32_t* a) {
  const int slot = s % st.stages;
  mbar_wait(st.full0 + 8 * slot, (s / st.stages) & 1);
  fence_regs<N / 2>(acc);
  wgmma_fence();
  sch_wgmma<N>(acc, a, sch_desc(st.b0 + slot * st.stage_bytes));
  wgmma_commit();
}
// Load A of step s into cur, issue it, wait for step s-1 (whose A is in
// prev), free its stage (one arrival per warp), and (thread 0) refill the
// stage with step s-1+stages.
template <int N>
__device__ __forceinline__ void sch_next(const SchStep& st, int s, float* acc,
                                         uint32_t* cur, uint32_t* prev) {
  ldmatrix_x4(cur, st.a_addr(s));
  sch_issue<N>(st, s, acc, cur);
  wgmma_wait<1>();
  fence_regs<4>(prev);
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(st.empty0 + 8 * ((s - 1) % st.stages));
  if (threadIdx.x == 0) sch_load(st, s - 1 + st.stages);
  __syncwarp();
}

// Step 1: Z[r][ci] = bf16(z[tb - hz + r]) for every input channel, all warps.
// A warp takes one channel at a time: its x window (zr + 10 samples, clamped
// to the row only in a tile that touches an edge) is loaded one channel
// ahead into registers with its snake parameters, so the loads' latency
// hides under the previous channel's arithmetic; then the window in shared memory, the lattice from
// it (mid[0] and mid[2T-1] for the lattice clamp, in an edge tile), and the
// down-FIR into Z.
template <int WARPS>
__device__ __forceinline__ void sch_activate(
    const __nv_bfloat16* __restrict__ xb, const float* __restrict__ alpha,
    const float* __restrict__ inv_beta, uint8_t* z, float* scratch, int C,
    int T_len, int tb, int hz, int z_stride) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int zr = SCH_TM + 2 * hz;
  const int xw = zr + 10;                  // x window
  const int nq = zr + 5;                   // lattice points per phase
  // xs[p] = x[clamp(t_lo-5+p)], me[q] = mid[2(t_lo-2+q)],
  // mo[q] = mid[2(t_lo-3+q)+1]; each with SCH_RUN_SLACK entries past its
  // end that the last lane's run reads and never uses
  float* xs = scratch + warp * sch_scratch_floats(zr);
  float* me = xs + xw + SCH_RUN_SLACK;
  float* mo = me + nq + SCH_RUN_SLACK;
  const int t_lo = tb - hz;                // time of Z's row 0
  const bool interior = t_lo >= 5 && t_lo + zr + 5 <= T_len;
  float xr[SCH_XW_MAX / 32], a_next, ib_next;
  auto fetch = [&](int ci) {
    const __nv_bfloat16* row = xb + (size_t)ci * T_len;
    a_next = alpha[ci];
    ib_next = inv_beta[ci];
#pragma unroll
    for (int i = 0; i < SCH_XW_MAX / 32; ++i) {
      const int p = lane + 32 * i;
      const int t = interior ? t_lo - 5 + p : afa_clamp(t_lo - 5 + p, 0, T_len - 1);
      xr[i] = p < xw ? __bfloat162float(row[t]) : 0.0f;
    }
  };
  if (warp < C) fetch(warp);
  for (int ci = warp; ci < C; ci += WARPS) {
#pragma unroll
    for (int i = 0; i < SCH_XW_MAX / 32; ++i)
      if (lane + 32 * i < xw) xs[lane + 32 * i] = xr[i];
    const float a = a_next, ib = ib_next;
    __syncwarp();
    if (ci + WARPS < C) fetch(ci + WARPS);
    float mid0 = 0.0f, mid_last = 0.0f;
    if (!interior) {
      // x[clamp(-3 + i)] and x[clamp(T - 3 + i)] lie in the window whenever
      // a lattice point of the tile needs them
      if (t_lo <= 2) mid0 = afa_mid_even(xs + 2 - t_lo, a, ib);
      if (t_lo + zr + 2 >= T_len) mid_last = afa_mid_odd(xs + T_len + 2 - t_lo, a, ib);
    }
    // a lane takes SCH_RUN consecutive points (lanes 3 words apart: no bank
    // conflict), reading the window they share once
    for (int q0 = SCH_RUN * lane; q0 < nq; q0 += 32 * SCH_RUN) {
      float v[SCH_RUN + 5];
#pragma unroll
      for (int i = 0; i < SCH_RUN + 5; ++i) v[i] = xs[q0 + i];
#pragma unroll
      for (int u = 0; u < SCH_RUN; ++u) {
        const int q = q0 + u;
        float ve = afa_mid_even(v + u, a, ib), vo = afa_mid_odd(v + u, a, ib);
        if (!interior) {
          const int m_e = t_lo - 2 + q, m_o = t_lo - 3 + q;
          ve = m_e < 0 ? mid0 : (m_e >= T_len ? mid_last : ve);
          vo = m_o < 0 ? mid0 : (m_o >= T_len ? mid_last : vo);
        }
        if (q < nq) {
          me[q] = ve;
          mo[q] = vo;
        }
      }
    }
    __syncwarp();
    // the down-FIR the same way: SCH_RUN consecutive rows per lane
    for (int r0 = SCH_RUN * lane; r0 < zr; r0 += 32 * SCH_RUN) {
      float e[SCH_RUN + 5], o[SCH_RUN + 5];
#pragma unroll
      for (int i = 0; i < SCH_RUN + 5; ++i) {
        e[i] = me[r0 + i];
        o[i] = mo[r0 + i];
      }
#pragma unroll
      for (int u = 0; u < SCH_RUN; ++u) {
        const int r = r0 + u, t = t_lo + r;
        if (r < zr) {
          const float v = (t >= 0 && t < T_len) ? afa_down(e, o, u) : 0.0f;
          *reinterpret_cast<__nv_bfloat16*>(z + r * z_stride + 2 * ci) =
              __float2bfloat16(v);
        }
      }
    }
    __syncwarp();
  }
}

// The dz kernel's step 1: Z[r][c] = dy[c][tb - hz + r] for every channel,
// zero outside [0, T).  A warp copies units of 8 rows x 8 channels: lane l
// takes row l & 7 and the channel pair 2 (l >> 3), so its 4-byte store
// falls in a bank of its own (Z's rows are 4 banks apart) and each channel's
// eight samples are one 16-byte run of dy.  SCH_DY_BATCH units' loads are
// issued before their stores, so that their latencies overlap (24 against 8
// or 1: 10 % off the dz kernel, PERF.md).
constexpr int SCH_DY_BATCH = 24;
template <int WARPS>
__device__ __forceinline__ void sch_stage_dy(const __nv_bfloat16* __restrict__ dyb,
                                             uint8_t* z, int C, int T_len,
                                             int tb, int hz, int z_stride) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int zr = SCH_TM + 2 * hz;
  const int t_lo = tb - hz;
  const int n_rb = (zr + 7) / 8;
  const int n_units = n_rb * (C / 8);
  const int r_in = lane & 7, c_in = 2 * (lane >> 3);
  for (int u0 = warp; u0 < n_units; u0 += SCH_DY_BATCH * WARPS) {
    __nv_bfloat162 v[SCH_DY_BATCH];
#pragma unroll
    for (int q = 0; q < SCH_DY_BATCH; ++q) {
      const int u = u0 + q * WARPS;
      const int r = (u % n_rb) * 8 + r_in;
      const int c = (u / n_rb) * 8 + c_in;
      const int t = t_lo + r;
      v[q] = __floats2bfloat162_rn(0.0f, 0.0f);
      if (u < n_units && r < zr && t >= 0 && t < T_len) {
        v[q].x = dyb[(size_t)c * T_len + t];
        v[q].y = dyb[(size_t)(c + 1) * T_len + t];
      }
    }
#pragma unroll
    for (int q = 0; q < SCH_DY_BATCH; ++q) {
      const int u = u0 + q * WARPS;
      const int r = (u % n_rb) * 8 + r_in;
      const int c = (u / n_rb) * 8 + c_in;
      if (u < n_units && r < zr)
        *reinterpret_cast<__nv_bfloat162*>(z + r * z_stride + 2 * c) = v[q];
    }
  }
}

// The bfloat16 block of both kernels.  ACT: the forward (Z = the activation
// of x, plus the bias); else the dz kernel (Z = dy, no bias; x is dy and
// alpha, inv_beta, bias are unused).
template <int N, int NCONS, bool ACT>
__device__ __forceinline__ void sch_block(const __nv_bfloat16* __restrict__ x,
                                          const float* __restrict__ alpha,
                                          const float* __restrict__ inv_beta,
                                          const __nv_bfloat16* __restrict__ wb,
                                          const float* __restrict__ bias,
                                          __nv_bfloat16* __restrict__ out, int C,
                                          int T_len, int k, int dil, int n_tt,
                                          int n_groups, int z_bytes, int stages,
                                          int pre_stages) {
  using Cfg = SchCfg<N, NCONS>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  uint8_t* zp = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t ring0 = base + z_bytes;
  const uint32_t full0 = ring0 + stages * Cfg::STAGE_BYTES;
  const uint32_t empty0 = full0 + 8 * SCH_MAX_STAGES;
  const int hz = (k - 1) / 2 * dil;
  const int z_stride = 2 * C + SCH_ZPAD;
  int blk = blockIdx.x;
  const int grp = blk % n_groups;
  blk /= n_groups;
  const int tb = (blk % n_tt) * SCH_TM;
  const int b = blk / n_tt;
  const int c16 = C / SCH_KC;
  const int n_steps = k * c16;
  // this block's weight tiles: (group, tap, 16-channel chunk), contiguous
  const uint8_t* wsrc =
      reinterpret_cast<const uint8_t*>(wb) + (size_t)grp * n_steps * Cfg::STAGE_BYTES;

  const int tid = threadIdx.x % WG_THREADS;
  const int wg = threadIdx.x / WG_THREADS;
  const int warp = tid >> 5, lane = tid & 31;
  // ldmatrix x4: lanes 0-7 / 8-15 / 16-23 / 24-31 give the rows of the
  // fragment's four 8x8 matrices (rows 0-7 | 8-15 at columns 0-7, then at
  // columns 8-15): registers a0..a3 of the mma.sync A layout
  const uint32_t a_base = base +
                          (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * z_stride +
                          16 * (lane >> 4);
  const SchStep st{a_base, dil * z_stride, c16, stages, Cfg::STAGE_BYTES,
                   n_steps, ACT ? 0 : k, ring0, ring0 + wg * N * (SCH_KC * 2),
                   full0, empty0, wsrc};

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, Cfg::WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < pre_stages; ++s) sch_load(st, s);
  }
  if constexpr (ACT) {
    sch_activate<Cfg::WARPS>(
        x + (size_t)b * C * T_len, alpha, inv_beta, zp,
        reinterpret_cast<float*>(zp + z_bytes + pre_stages * Cfg::STAGE_BYTES),
        C, T_len, tb, hz, z_stride);
  } else {
    sch_stage_dy<Cfg::WARPS>(x + (size_t)b * C * T_len, zp, C, T_len, tb, hz,
                             z_stride);
  }
  // the scratch's generic writes before the bulk copies that reuse it
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = pre_stages; s < stages; ++s) sch_load(st, s);
  }
  __syncwarp();

  // ---- the product: warpgroup wg owns output channels wg*N ... + N-1 of
  // the block's CO_BLK, all 64 time steps
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  uint32_t a0[4], a1[4];
  ldmatrix_x4(a0, st.a_addr(0));
  sch_issue<N>(st, 0, acc, a0);
  // steps 1 ...: A of step s loaded and issued while step s-1 runs, then
  // step s-1 waited for and its stage freed; A alternates between two
  // register sets (n_steps is even), so no branch surrounds a wgmma
  for (int s = 1; s < n_steps - 1; s += 2) {
    sch_next<N>(st, s, acc, a1, a0);
    sch_next<N>(st, s + 1, acc, a0, a1);
  }
  sch_next<N>(st, n_steps - 1, acc, a1, a0);
  wgmma_wait<0>();
  fence_regs<N / 2>(acc);

  // ---- epilogue: every warpgroup is done with Z and the ring; stage
  // [co][t] bfloat16 over them
  __syncthreads();
  const int g = lane >> 2, t4 = lane & 3;
  uint8_t* stage = zp + wg * N * SCH_OUT_ROW;
  const int co_blk0 = grp * Cfg::CO_BLK + wg * N;
  const int m0 = 16 * warp + g;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int n = 8 * i + 2 * t4;
    const float b0 = ACT ? bias[co_blk0 + n] : 0.0f;
    const float b1 = ACT ? bias[co_blk0 + n + 1] : 0.0f;
    __nv_bfloat16* r0 = reinterpret_cast<__nv_bfloat16*>(stage + n * SCH_OUT_ROW);
    __nv_bfloat16* r1 = reinterpret_cast<__nv_bfloat16*>(stage + (n + 1) * SCH_OUT_ROW);
    r0[m0] = __float2bfloat16(acc[4 * i] + b0);
    r1[m0] = __float2bfloat16(acc[4 * i + 1] + b1);
    r0[m0 + 8] = __float2bfloat16(acc[4 * i + 2] + b0);
    r1[m0 + 8] = __float2bfloat16(acc[4 * i + 3] + b1);
  }
  bar_sync(1 + wg, WG_THREADS);
  const int t = tb + 2 * lane;
  for (int n = warp; n < N; n += 4) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(stage + n * SCH_OUT_ROW + 4 * lane);
    __nv_bfloat16* dst = out + ((size_t)b * C + co_blk0 + n) * T_len + t;
    if ((T_len & 1) == 0 && t + 1 < T_len) {
      *reinterpret_cast<uint32_t*>(dst) = v;
    } else {
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
      if (t < T_len) dst[0] = h.x;
      if (t + 1 < T_len) dst[1] = h.y;
    }
  }
}

template <int N, int NCONS>
__global__ void __launch_bounds__(SchCfg<N, NCONS>::THREADS, 1)
snake_conv_wg_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ alpha,
                     const float* __restrict__ inv_beta,
                     const __nv_bfloat16* __restrict__ wb,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int C, int T_len, int k,
                     int dil, int n_tt, int n_groups, int z_bytes, int stages,
                     int pre_stages) {
  sch_block<N, NCONS, true>(x, alpha, inv_beta, wb, bias, out, C, T_len, k,
                            dil, n_tt, n_groups, z_bytes, stages, pre_stages);
}

template <int N, int NCONS>
__global__ void __launch_bounds__(SchCfg<N, NCONS>::THREADS, 1)
snake_conv_dgrad_kernel(const __nv_bfloat16* __restrict__ dy,
                        const __nv_bfloat16* __restrict__ wb,
                        __nv_bfloat16* __restrict__ dz, int C, int T_len, int k,
                        int dil, int n_tt, int n_groups, int z_bytes,
                        int stages, int pre_stages) {
  sch_block<N, NCONS, false>(dy, nullptr, nullptr, wb, nullptr, dz, C, T_len,
                             k, dil, n_tt, n_groups, z_bytes, stages,
                             pre_stages);
}

template <int N, int NCONS, bool ACT>
static int sch_launch(const void* x, const void* alpha, const void* inv_beta,
                      const void* w, const void* bias, void* out, int B, int C,
                      int T_len, int k, int dil, cudaStream_t s) {
  using Cfg = SchCfg<N, NCONS>;
  SchPlan plan;
  if (!sch_plan(C, k, dil, Cfg::WARPS, Cfg::STAGE_BYTES, ACT, &plan))
    return (int)cudaErrorInvalidValue;
  // the whole of it allowed once per device, whatever this launch's plan
  const int e = ACT ? allow_smem<snake_conv_wg_kernel<N, NCONS>>(
                          MAX_DYNAMIC_SMEM - TILE_ALIGN)
                    : allow_smem<snake_conv_dgrad_kernel<N, NCONS>>(
                          MAX_DYNAMIC_SMEM - TILE_ALIGN);
  if (e != 0) return e;
  const int n_tt = (T_len + SCH_TM - 1) / SCH_TM;
  const int n_groups = C / Cfg::CO_BLK;
  const long long blocks = (long long)B * n_tt * n_groups;
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  if constexpr (ACT) {
    snake_conv_wg_kernel<N, NCONS>
        <<<(unsigned)blocks, Cfg::THREADS, plan.bytes + TILE_ALIGN, s>>>(
            (const __nv_bfloat16*)x, (const float*)alpha, (const float*)inv_beta,
            (const __nv_bfloat16*)w, (const float*)bias, (__nv_bfloat16*)out, C,
            T_len, k, dil, n_tt, n_groups, plan.z_bytes, plan.stages,
            plan.pre_stages);
  } else {
    snake_conv_dgrad_kernel<N, NCONS>
        <<<(unsigned)blocks, Cfg::THREADS, plan.bytes + TILE_ALIGN, s>>>(
            (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
            (__nv_bfloat16*)out, C, T_len, k, dil, n_tt, n_groups,
            plan.z_bytes, plan.stages, plan.pre_stages);
  }
  return (int)cudaGetLastError();
}

// The block shape for (B, C, T) on this card: sch_co_block's choice.
template <bool ACT>
static int sch_dispatch(const void* x, const void* alpha, const void* inv_beta,
                        const void* w, const void* bias, void* out, int B,
                        int C, int T_len, int k, int dil, cudaStream_t s) {
  if (((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  switch (sch_co_block(C, B, T_len, sms)) {
    case 768:
      return sch_launch<256, 3, ACT>(x, alpha, inv_beta, w, bias, out, B, C,
                                     T_len, k, dil, s);
    case 384:
      return sch_launch<128, 3, ACT>(x, alpha, inv_beta, w, bias, out, B, C,
                                     T_len, k, dil, s);
    default:
      return sch_launch<128, 1, ACT>(x, alpha, inv_beta, w, bias, out, B, C,
                                     T_len, k, dil, s);
  }
}

// bfloat16: w in the blocked layout of ops/snake_conv.py:blocked_weight —
// (C / CO_BLK, k,
// C / 16, CO_BLK / 8, 2, 8, 8) over (group, tap, channel chunk, 8-row
// group, k-half, row, column), CO_BLK = sch_co_block(C, B, T, the card's
// SMs); x, w and out 16-byte aligned.
extern "C" int snake_conv_forward(const void* x, const void* alpha,
                                  const void* inv_beta, const void* w,
                                  const void* bias, void* out, int B, int C,
                                  int T_len, int k, int dil, void* stream) {
  if (C % 128 != 0 || k % 2 != 1 || dil < 1) return (int)cudaErrorInvalidValue;
  return sch_dispatch<true>(x, alpha, inv_beta, w, bias, out, B, C, T_len, k,
                            dil, (cudaStream_t)stream);
}

// dz = conv1d(dy, W~, padding (k-1)/2 * dil, dilation dil), bfloat16, with
// W~[ci, co, j] = W[co, ci, k-1-j]: w is blocked_weight's layout of
// W[co, ci, j] with co and ci swapped and the taps in W's order (CO_BLK as
// above); dy, w and dz 16-byte aligned.
extern "C" int snake_conv_dgrad(const void* dy, const void* w, void* dz, int B,
                                int C, int T_len, int k, int dil,
                                void* stream) {
  if (C % 128 != 0 || k % 2 != 1 || dil < 1) return (int)cudaErrorInvalidValue;
  return sch_dispatch<false>(dy, nullptr, nullptr, w, nullptr, dz, B, C, T_len,
                             k, dil, (cudaStream_t)stream);
}

