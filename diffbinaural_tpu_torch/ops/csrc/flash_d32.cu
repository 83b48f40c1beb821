// Flash attention forward for head dimension 32:
//   o = softmax(q k^T * scale) v   on (B*H, N, 32), non-causal, no mask,
// without materialising the N x N scores.
//
// Replaces the Pallas kernel _fwd_kernel of diffbinaural_tpu/ops/flash_d32.py
// in both of its uses: flash_sdpa -> _attn_core -> _fwd(save_residuals=False,
// exp2=True), the residual-free forward of the serving path
// (flash_d32_forward), and _attn_core_fwd -> _fwd(save_residuals=True), the
// training forward that also emits the softmax statistics
// (flash_d32_forward_lse).  The TPU kernel writes the row max m and the row
// sum l of exp(s - m), each broadcast over 128 lanes; here the training
// forward writes ONE float32 per row, lse = m + log(l) in base e of the
// scaled scores, which is all the backward needs.  Both uses are the same
// kernels: a template flag adds the one store, so the two give the same o.
//
// What bounds it on this card: 4*N*N*32 FLOP and N*N exp2 per head against
// 4*N*32 elements moved.  At their peaks the tensor cores need longer for
// the products than the special-function unit and the FMA pipes together
// (exp2 in software) would need for the exponentials; but these kernels take
// every exp2 on the special-function unit, 16 per clock per SM, and there
// the exponentials take 1.8 times the products' time.  A block cannot hold
// a whole K/V panel as the TPU's VMEM did, so K/V stream through shared
// memory with a running max and sum, and the output is normalised once at
// the end.  Keys beyond N are masked by index (their score is -inf); rows
// beyond N are computed and not stored.
//
//  * bfloat16 (what the serving and training paths run):
//    flash_d32_ws_kernel, warp-specialised for Hopper (flash_hopper.cuh).  A
//    block owns FWD_BLOCK_M = 192 query rows: three consumer warpgroups of 64
//    rows and one producer warp.  The producer loads q once and keeps a ring
//    of 4 K/V stages of 128 keys in flight with TMA (64-byte swizzle,
//    mbarrier completion), so no thread spends registers or instructions on
//    copies and all consumers share each K/V tile (one read from L2 per 192
//    query rows).  S = q k^T is wgmma.m64n128k16 x 2 from shared memory; the
//    softmax step folds scale*log2(e) and the row max into one FFMA before
//    ex2, and rescales the output only when a row max of the warp moves;
//    O += P V is wgmma.m64n32k16 x 8 with P from registers (the accumulator
//    layout of S is the A-register layout) and V MN-major (transpose bit).
//    The consumer warpgroups take turns to issue their products (a ring of
//    named barriers), so the others' exponentials run under one's products;
//    within a warpgroup tile j-1's P V runs under tile j's softmax, and the
//    first tile is peeled so that no branch surrounds a wgmma (ptxas would
//    serialise them).  setmaxnreg gives the consumers 160 registers, the
//    producer 24.  Three consumer warpgroups, 128-key tiles, 4 stages and the
//    skipped rescale were chosen against the alternatives that
//    ops/flash_d32_variants.py builds and times (readings in PERF.md).
//  * float32 runs flash_d32_f32.cu (split-TF32 products on wgmma); the
//    earlier one-thread-per-row CUDA-core kernel is kept as its yardstick in
//    csrc_variants/flash_d32_cuda_core.cu.
#include "flash_hopper.cuh"

// ---------------------------------------------------- tensor cores (Hopper)

// O += P V over one K/V stage: 8 k-steps of 16 keys, P from registers.
__device__ __forceinline__ void fwd_pv(float* acc, const uint32_t* pa,
                                       uint32_t v_tile) {
  const uint64_t vd = sw64_desc(v_tile);
#pragma unroll
  for (int kk = 0; kk < FWD_BLOCK_N / 16; ++kk)
    wgmma_m64n32k16_rs(acc, pa + 4 * kk, vd + kk * DESC_K16_MNMAJOR);
}

// S = q k^T over one K/V stage: 2 k-steps of 16 over the head dimension.
__device__ __forceinline__ void fwd_s(float* s, uint64_t q_desc, uint64_t k_desc) {
  wgmma_m64n128k16_ss_first(s, q_desc, k_desc);
  wgmma_m64n128k16_ss(s, q_desc + DESC_K16_KMAJOR, k_desc + DESC_K16_KMAJOR);
}

// One online-softmax step on the S of one K/V tile, of which the first `kv`
// keys are valid: S becomes P = exp2(s * qscale - m) in place, the row maxima
// m (in units of log2) move, the row sums l take the tile's P, and c_lo /
// c_hi are the factors by which the output so far must be rescaled.
__device__ __forceinline__ void fwd_softmax(float* s, int kv, int t, float qscale,
                                            float& m_lo, float& m_hi, float& l_lo,
                                            float& l_hi, float& c_lo, float& c_hi) {
  if (kv < FWD_BLOCK_N) {  // ragged last tile: mask keys beyond N by index
#pragma unroll
    for (int c = 0; c < FWD_BLOCK_N / 8; ++c) {
      const int key = 8 * c + 2 * t;
      if (key >= kv) s[4 * c] = s[4 * c + 2] = -INFINITY;
      if (key + 1 >= kv) s[4 * c + 1] = s[4 * c + 3] = -INFINITY;
    }
  }
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int c = 0; c < FWD_BLOCK_N / 8; ++c) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[4 * c], s[4 * c + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[4 * c + 2], s[4 * c + 3]));
  }
  // a row's scores live in the 4 lanes of its quad
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
  // the tile's first key is always valid, so the new maxima are finite
  const float mn_lo = fmaxf(m_lo, mx_lo * qscale);
  const float mn_hi = fmaxf(m_hi, mx_hi * qscale);
  c_lo = ex2(m_lo - mn_lo);
  c_hi = ex2(m_hi - mn_hi);
  m_lo = mn_lo;
  m_hi = mn_hi;
  float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
  for (int c = 0; c < FWD_BLOCK_N / 8; ++c) {
    s[4 * c] = ex2(fmaf(s[4 * c], qscale, -mn_lo));
    s[4 * c + 1] = ex2(fmaf(s[4 * c + 1], qscale, -mn_lo));
    s[4 * c + 2] = ex2(fmaf(s[4 * c + 2], qscale, -mn_hi));
    s[4 * c + 3] = ex2(fmaf(s[4 * c + 3], qscale, -mn_hi));
    sum_lo += s[4 * c] + s[4 * c + 1];      // this lane's columns; the
    sum_hi += s[4 * c + 2] + s[4 * c + 3];  // quad's sums meet at the end
  }
  l_lo = fmaf(l_lo, c_lo, sum_lo);
  l_hi = fmaf(l_hi, c_hi, sum_hi);
}

template <bool WRITE_LSE>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_d32_ws_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int N, int n_qtiles, float qscale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  const uint32_t full0 = base + FwdSmem::bars;     // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * FWD_STAGES;
  const uint32_t q_bar = empty0 + 8 * FWD_STAGES;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * FWD_BLOCK_M;
  const int n_kt = (N + FWD_BLOCK_N - 1) / FWD_BLOCK_N;
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, FWD_CONSUMERS * WG_THREADS);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == FWD_CONSUMERS) {
    // ---- producer: one thread issues every copy
    setmaxnreg_dec<FWD_PRODUCER_REGS>();
    if (threadIdx.x == FWD_CONSUMERS * WG_THREADS) {
      mbar_expect_tx(q_bar, tile_bytes(FWD_BLOCK_M));
      tma_load_rows(base + FwdSmem::q, &q_map, q_bar, q0, bh);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % FWD_STAGES;
        if (j >= FWD_STAGES) mbar_wait(empty0 + 8 * s, (j / FWD_STAGES - 1) & 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, 2 * tile_bytes(FWD_BLOCK_N));
        tma_load_rows(base + FwdSmem::k(s), &k_map, bar, j * FWD_BLOCK_N, bh);
        tma_load_rows(base + FwdSmem::v(s), &v_map, bar, j * FWD_BLOCK_N, bh);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg ... + 63
    setmaxnreg_inc<FWD_CONSUMER_REGS>();
    const int tid = threadIdx.x % WG_THREADS;
    const int lane = tid & 31;
    const int g = lane >> 2;      // row of the quad inside the warp's 16 rows
    const int t = lane & 3;       // position inside the quad
    const int r_lo = q0 + 64 * wg + 16 * (tid >> 5) + g;
    const int r_hi = r_lo + 8;
    // named barriers: this warpgroup's turn, and the next one's
    const int me = 1 + wg, other = 1 + (wg + 1) % FWD_CONSUMERS;
    const uint64_t q_desc = sw64_desc(base + FwdSmem::q + wg * tile_bytes(64));

    float s[FWD_BLOCK_N / 2];     // S, then P: 16 chunks of 8 keys x 4
    float acc[16];                // O: 4 chunks of 8 head columns x 4
    uint32_t pa[FWD_BLOCK_N / 4]; // P of the previous tile as A fragments
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.0f, l_hi = 0.0f;
    float c_lo, c_hi;

    if (wg == FWD_CONSUMERS - 1) named_arrive(1);  // warpgroup 0 issues first
    mbar_wait(q_bar, 0);
    // tile 0: S alone (there is no P V yet)
    mbar_wait(full0, 0);
    named_sync(me);
    wgmma_fence();
    fwd_s(s, q_desc, sw64_desc(base + FwdSmem::k(0)));
    wgmma_commit();
    named_arrive(other);
    wgmma_wait<0>();
    fence_regs<FWD_BLOCK_N / 2>(s);
    fwd_softmax(s, N, t, qscale, m_lo, m_hi, l_lo, l_hi, c_lo, c_hi);
    pack_a_frags<FWD_BLOCK_N / 2>(s, pa);
    int prev = 0;
    // tiles 1 ...: S of tile j and P V of tile j - 1 issued together, the
    // softmax of tile j under P V; the loop has no branch around a wgmma, so
    // the compiler keeps the products asynchronous
    for (int j = 1; j < n_kt; ++j) {
      const int st = j % FWD_STAGES;
      mbar_wait(full0 + 8 * st, (j / FWD_STAGES) & 1);
      named_sync(me);
      fence_regs<16>(acc);
      fence_regs<FWD_BLOCK_N / 4>(pa);
      wgmma_fence();
      fwd_s(s, q_desc, sw64_desc(base + FwdSmem::k(st)));
      wgmma_commit();
      wgmma_fence();
      fwd_pv(acc, pa, base + FwdSmem::v(prev));
      wgmma_commit();
      named_arrive(other);
      wgmma_wait<1>();
      fence_regs<FWD_BLOCK_N / 2>(s);
      fwd_softmax(s, N - j * FWD_BLOCK_N, t, qscale, m_lo, m_hi, l_lo, l_hi,
                  c_lo, c_hi);
      wgmma_wait<0>();  // the previous tile's P V: its stage is free
      fence_regs<16>(acc);
      fence_regs<FWD_BLOCK_N / 4>(pa);
      mbar_arrive(empty0 + 8 * prev);
      if (__any_sync(0xffffffffu, c_lo != 1.0f || c_hi != 1.0f)) {
#pragma unroll
        for (int dt = 0; dt < 4; ++dt) {
          acc[4 * dt] *= c_lo;
          acc[4 * dt + 1] *= c_lo;
          acc[4 * dt + 2] *= c_hi;
          acc[4 * dt + 3] *= c_hi;
        }
      }
      pack_a_frags<FWD_BLOCK_N / 2>(s, pa);
      prev = st;
    }
    // the last tile's P V
    named_sync(me);
    fence_regs<16>(acc);
    fence_regs<FWD_BLOCK_N / 4>(pa);
    wgmma_fence();
    fwd_pv(acc, pa, base + FwdSmem::v(prev));
    wgmma_commit();
    named_arrive(other);
    wgmma_wait<0>();
    fence_regs<16>(acc);
    if (wg == 0) named_sync(1);  // matches the last warpgroup's last arrival

    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
    const float inv_lo = 1.0f / l_lo;
    const float inv_hi = 1.0f / l_hi;
    const size_t base_o = (size_t)bh * N * FD;
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      if (r_lo < N) {
        *reinterpret_cast<uint32_t*>(o + base_o + (size_t)r_lo * FD + dt * 8 + 2 * t) =
            pack_bf16(acc[4 * dt] * inv_lo, acc[4 * dt + 1] * inv_lo);
      }
      if (r_hi < N) {
        *reinterpret_cast<uint32_t*>(o + base_o + (size_t)r_hi * FD + dt * 8 + 2 * t) =
            pack_bf16(acc[4 * dt + 2] * inv_hi, acc[4 * dt + 3] * inv_hi);
      }
    }
    if (WRITE_LSE && t == 0) {  // one lane of the quad that shares the row
      if (r_lo < N) lse[(size_t)bh * N + r_lo] = (m_lo + log2f(l_lo)) * LN2;
      if (r_hi < N) lse[(size_t)bh * N + r_hi] = (m_hi + log2f(l_hi)) * LN2;
    }
  }
}

// The three tensor maps of one bfloat16 forward: q in boxes of a block's
// rows, k and v in boxes of a stage's keys.
static int forward_maps(CUtensorMap* maps, const void* q, const void* k,
                        const void* v, int BH, int N) {
  int e = make_rows_map(&maps[0], q, BH, N, FWD_BLOCK_M);
  if (e == 0) e = make_rows_map(&maps[1], k, BH, N, FWD_BLOCK_N);
  if (e == 0) e = make_rows_map(&maps[2], v, BH, N, FWD_BLOCK_N);
  return e;
}

template <bool WRITE_LSE>
static int launch_forward(const void* q, const void* k, const void* v, void* o,
                          float* lse, int BH, int N, float scale, void* stream) {
  if (BH <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const int n_qtiles = (N + FWD_BLOCK_M - 1) / FWD_BLOCK_M;
  const long long blocks = (long long)BH * n_qtiles;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  int e = forward_maps(maps, q, k, v, BH, N);
  if (e == 0) e = allow_smem<flash_d32_ws_kernel<WRITE_LSE>>(FwdSmem::bytes);
  if (e != 0) return e;
  flash_d32_ws_kernel<WRITE_LSE>
      <<<(unsigned)blocks, FWD_THREADS, FwdSmem::bytes + TILE_ALIGN,
         (cudaStream_t)stream>>>(maps[0], maps[1], maps[2], (__nv_bfloat16*)o,
                                 lse, N, n_qtiles,
                                 scale * LOG2E);  // fold log2(e): exp2 in the kernel
  return (int)cudaGetLastError();
}

// q, k, v, o: (BH, N, 32) bfloat16.
extern "C" int flash_d32_forward(const void* q, const void* k, const void* v,
                                 void* o, int BH, int N, float scale,
                                 void* stream) {
  return launch_forward<false>(q, k, v, o, nullptr, BH, N, scale, stream);
}

// The training forward: the same output plus lse (BH, N), float32.
extern "C" int flash_d32_forward_lse(const void* q, const void* k,
                                     const void* v, void* o, void* lse, int BH,
                                     int N, float scale, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return launch_forward<true>(q, k, v, o, (float*)lse, BH, N, scale, stream);
}
