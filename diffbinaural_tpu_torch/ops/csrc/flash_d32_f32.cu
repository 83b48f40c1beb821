// Flash attention forward for head dimension 32 in float32:
//   o = softmax(q k^T * scale) v   on (B*H, N, 32), non-causal, no mask,
// without materialising the N x N scores.
//
// Replaces the Pallas kernel _fwd_kernel of diffbinaural_tpu/ops/flash_d32.py
// for float32 inputs, in both of its uses: flash_sdpa -> _attn_core ->
// _fwd(save_residuals=False, exp2=True) (flash_d32_f32_forward) and
// _attn_core_fwd -> _fwd(save_residuals=True) (flash_d32_f32_forward_lse,
// which also writes lse = m + log(l) per row, base e of the scaled scores).
// One kernel template serves both, so the two give the same o.  The JAX CLIs
// that test and train stage 1 build the UNet in float32, so this is what
// they run.
//
// What bounds it on this card: the products.  Float32 accuracy on the tensor
// cores takes three TF32 products per float32 product (flash_f32_hopper.cuh),
// so 3 x 4 N^2 32 FLOP per head at 494.7 TFLOP/s, against N^2 exp2 (one per
// score, on the special-function unit) and 4 N 32 floats moved: the products
// take about 1.7 times the exponentials' time.  The CUDA cores' float32 rate
// (67 TFLOP/s) would need 2.4 times as long as the split products.
//
// Design: the bfloat16 kernel's (flash_d32.cu) on float32 operands.  A
// pre-pass splits q and k into hi / lo rows and writes v's transposed forms
// (flash_f32_hopper.cuh), which .tf32 wgmma needs because it reads shared
// memory K-major only.  A block owns F32_FWD_BLOCK_M = 192 query rows: three
// consumer warpgroups of 64 rows and one producer warp.  The producer loads
// q hi / lo once and keeps a ring of 4 stages of 64 keys (k hi, k lo, v_t
// hi, v_t lo: 32 KB a stage at 128-byte rows) in flight with TMA.  S = q k^T
// is 12 wgmma.m64n64k8 from shared memory; the softmax step folds scale *
// log2(e) and the row max into one FFMA before ex2 and rescales the output
// only when a row max of the warp moves; P is split into tf32 hi / lo A
// fragments in registers (the accumulator's registers in the order that
// KEY_PERM matches), and O += P V is 24 wgmma.m64n32k8 against the v_t
// tiles into a fresh accumulator, added into O on the CUDA cores (round to
// nearest: the tensor cores' own float32 sums over a whole row would drift
// with N).  The consumer warpgroups take turns to issue their products (a ring
// of named barriers), and within a warpgroup tile j-1's P V runs under tile
// j's softmax; the first tile is peeled so that no branch surrounds a wgmma.
// Keys beyond N arrive as zeros and are masked by index (score -inf); rows
// beyond N are computed and not stored.  No atomics: the same bits in every
// run.  64-key tiles keep S (32 registers), P hi and lo (64), O and the
// tile's P V (32) of a thread inside the consumers' 160 registers.
#include "flash_f32_hopper.cuh"

// One online-softmax step on the S of one 64-key tile, of which the first
// `kv` keys are valid: S becomes P = exp2(s * qscale - m) in place, the row
// maxima m (in units of log2) move, the row sums l take the tile's P, and
// c_lo / c_hi are the factors by which the output so far must be rescaled.
__device__ __forceinline__ void f32_softmax(float* s, int kv, int t, float qscale,
                                            float& m_lo, float& m_hi, float& l_lo,
                                            float& l_hi, float& c_lo, float& c_hi) {
  constexpr int BN = F32_FWD_BLOCK_N;
  if (kv < BN) {  // ragged last tile: mask keys beyond N by index
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const int key = 8 * c + 2 * t;
      if (key >= kv) s[4 * c] = s[4 * c + 2] = -INFINITY;
      if (key + 1 >= kv) s[4 * c + 1] = s[4 * c + 3] = -INFINITY;
    }
  }
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
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
  for (int c = 0; c < BN / 8; ++c) {
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
__global__ void __launch_bounds__(F32_FWD_THREADS, 1)
flash_d32_f32_kernel(const __grid_constant__ CUtensorMap q_hi_map,
                     const __grid_constant__ CUtensorMap q_lo_map,
                     const __grid_constant__ CUtensorMap k_hi_map,
                     const __grid_constant__ CUtensorMap k_lo_map,
                     const __grid_constant__ CUtensorMap vt_hi_map,
                     const __grid_constant__ CUtensorMap vt_lo_map,
                     float* __restrict__ o, float* __restrict__ lse, int N,
                     int n_qtiles, float qscale) {
  constexpr int BM = F32_FWD_BLOCK_M, BN = F32_FWD_BLOCK_N, S = F32_FWD_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  const uint32_t full0 = base + F32FwdSmem::bars;  // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * S;
  const uint32_t q_bar = empty0 + 8 * S;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * BM;
  const int n_kt = (N + BN - 1) / BN;
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, F32_FWD_CONSUMERS * WG_THREADS);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == F32_FWD_CONSUMERS) {
    // ---- producer: one thread issues every copy
    setmaxnreg_dec<F32_FWD_PRODUCER_REGS>();
    if (threadIdx.x == F32_FWD_CONSUMERS * WG_THREADS) {
      mbar_expect_tx(q_bar, 2 * f32_tile(BM));
      tma_load_rows(base + F32FwdSmem::q_hi, &q_hi_map, q_bar, q0, bh);
      tma_load_rows(base + F32FwdSmem::q_lo, &q_lo_map, q_bar, q0, bh);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % S;
        if (j >= S) mbar_wait(empty0 + 8 * s, (j / S - 1) & 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, 4 * f32_tile(BN));
        // a tile of BN keys is rows j BN ... of the rows forms and of the
        // transposed forms alike (BN / TBLK blocks of TBLK rows)
        tma_load_rows(base + F32FwdSmem::k_hi(s), &k_hi_map, bar, j * BN, bh);
        tma_load_rows(base + F32FwdSmem::k_lo(s), &k_lo_map, bar, j * BN, bh);
        tma_load_rows(base + F32FwdSmem::vt_hi(s), &vt_hi_map, bar, j * BN, bh);
        tma_load_rows(base + F32FwdSmem::vt_lo(s), &vt_lo_map, bar, j * BN, bh);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg ... + 63
    setmaxnreg_inc<F32_FWD_CONSUMER_REGS>();
    const int tid = threadIdx.x % WG_THREADS;
    const int lane = tid & 31;
    const int g = lane >> 2;      // row of the quad inside the warp's 16 rows
    const int t = lane & 3;       // position inside the quad
    const int r_lo = q0 + 64 * wg + 16 * (tid >> 5) + g;
    const int r_hi = r_lo + 8;
    // named barriers: this warpgroup's turn, and the next one's
    const int me = 1 + wg, other = 1 + (wg + 1) % F32_FWD_CONSUMERS;
    const uint32_t q_hi = base + F32FwdSmem::q_hi + wg * f32_tile(64);
    const uint32_t q_lo = base + F32FwdSmem::q_lo + wg * f32_tile(64);

    float s[BN / 2];              // S, then P: 8 chunks of 8 keys x 4
    float acc[16];                // O: 4 chunks of 8 head columns x 4
    float pv[16];                 // one tile's P V, added into O
    uint32_t ph[BN / 2], pl[BN / 2];  // P of the previous tile, tf32 hi / lo
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.0f, l_hi = 0.0f;
    float c_lo, c_hi;

    if (wg == F32_FWD_CONSUMERS - 1) named_arrive(1);  // warpgroup 0 issues first
    mbar_wait(q_bar, 0);
    // tile 0: S alone (there is no P V yet)
    mbar_wait(full0, 0);
    named_sync(me);
    wgmma_fence();
    split_ss_64x64(s, q_hi, q_lo, base + F32FwdSmem::k_hi(0),
                   base + F32FwdSmem::k_lo(0));
    wgmma_commit();
    named_arrive(other);
    wgmma_wait<0>();
    fence_regs<BN / 2>(s);
    f32_softmax(s, N, t, qscale, m_lo, m_hi, l_lo, l_hi, c_lo, c_hi);
    split_a_frags<BN>(s, ph, pl);
    int prev = 0;
    // tiles 1 ...: S of tile j and P V of tile j - 1 issued together, the
    // softmax of tile j under P V
    for (int j = 1; j < n_kt; ++j) {
      const int st = j % S;
      mbar_wait(full0 + 8 * st, (j / S) & 1);
      named_sync(me);
      fence_regs<BN / 2>(ph);
      fence_regs<BN / 2>(pl);
      wgmma_fence();
      split_ss_64x64(s, q_hi, q_lo, base + F32FwdSmem::k_hi(st),
                     base + F32FwdSmem::k_lo(st));
      wgmma_commit();
      wgmma_fence();
      split_rs_x32<BN>(pv, ph, pl, base + F32FwdSmem::vt_hi(prev),
                       base + F32FwdSmem::vt_lo(prev));
      wgmma_commit();
      named_arrive(other);
      wgmma_wait<1>();
      fence_regs<BN / 2>(s);
      f32_softmax(s, N - j * BN, t, qscale, m_lo, m_hi, l_lo, l_hi, c_lo, c_hi);
      wgmma_wait<0>();  // the previous tile's P V: its stage is free
      fence_regs<16>(pv);
      fence_regs<BN / 2>(ph);
      fence_regs<BN / 2>(pl);
      mbar_arrive(empty0 + 8 * prev);
      add_tile<16>(acc, pv);
      if (__any_sync(0xffffffffu, c_lo != 1.0f || c_hi != 1.0f)) {
#pragma unroll
        for (int dt = 0; dt < 4; ++dt) {
          acc[4 * dt] *= c_lo;
          acc[4 * dt + 1] *= c_lo;
          acc[4 * dt + 2] *= c_hi;
          acc[4 * dt + 3] *= c_hi;
        }
      }
      split_a_frags<BN>(s, ph, pl);
      prev = st;
    }
    // the last tile's P V
    named_sync(me);
    fence_regs<BN / 2>(ph);
    fence_regs<BN / 2>(pl);
    wgmma_fence();
    split_rs_x32<BN>(pv, ph, pl, base + F32FwdSmem::vt_hi(prev),
                     base + F32FwdSmem::vt_lo(prev));
    wgmma_commit();
    named_arrive(other);
    wgmma_wait<0>();
    fence_regs<16>(pv);
    add_tile<16>(acc, pv);
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
      if (r_lo < N)
        *reinterpret_cast<float2*>(o + base_o + (size_t)r_lo * FD + dt * 8 + 2 * t) =
            make_float2(acc[4 * dt] * inv_lo, acc[4 * dt + 1] * inv_lo);
      if (r_hi < N)
        *reinterpret_cast<float2*>(o + base_o + (size_t)r_hi * FD + dt * 8 + 2 * t) =
            make_float2(acc[4 * dt + 2] * inv_hi, acc[4 * dt + 3] * inv_hi);
    }
    if (WRITE_LSE && t == 0) {  // one lane of the quad that shares the row
      if (r_lo < N) lse[(size_t)bh * N + r_lo] = (m_lo + log2f(l_lo)) * LN2;
      if (r_hi < N) lse[(size_t)bh * N + r_hi] = (m_hi + log2f(l_hi)) * LN2;
    }
  }
}

template <bool WRITE_LSE>
static int launch_forward(const float* q, const float* k, const float* v,
                          float* o, float* lse, void* scratch, int BH, int N,
                          float scale, void* stream) {
  if (BH <= 0 || N <= 0 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int n_qtiles = (N + F32_FWD_BLOCK_M - 1) / F32_FWD_BLOCK_M;
  const long long blocks = (long long)BH * n_qtiles;
  if (blocks > 2147483647LL || (long long)BH * f32_pad_rows(N) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* at = (float*)scratch;
  const SplitForm qf = take_rows(at, BH, N), kf = take_rows(at, BH, N);
  const SplitForm vf = take_transposed(at, BH, N);
  launch_split_rows(q, qf, BH, N, s);
  launch_split_rows(k, kf, BH, N, s);
  launch_split_transposed(v, vf, BH, N, s);

  const int n_pad = (int)f32_pad_rows(N);
  CUtensorMap maps[6];
  int e = make_rows_map_f32(&maps[0], qf.hi, BH, N, F32_FWD_BLOCK_M);
  if (e == 0) e = make_rows_map_f32(&maps[1], qf.lo, BH, N, F32_FWD_BLOCK_M);
  if (e == 0) e = make_rows_map_f32(&maps[2], kf.hi, BH, N, F32_FWD_BLOCK_N);
  if (e == 0) e = make_rows_map_f32(&maps[3], kf.lo, BH, N, F32_FWD_BLOCK_N);
  if (e == 0) e = make_rows_map_f32(&maps[4], vf.hi, BH, n_pad, F32_FWD_BLOCK_N);
  if (e == 0) e = make_rows_map_f32(&maps[5], vf.lo, BH, n_pad, F32_FWD_BLOCK_N);
  if (e == 0) e = allow_smem<flash_d32_f32_kernel<WRITE_LSE>>(F32FwdSmem::bytes);
  if (e != 0) return e;
  flash_d32_f32_kernel<WRITE_LSE>
      <<<(unsigned)blocks, F32_FWD_THREADS, F32FwdSmem::bytes + TILE_ALIGN, s>>>(
          maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], o, lse, N,
          n_qtiles, scale * LOG2E);  // fold log2(e): exp2 in the kernel
  return (int)cudaGetLastError();
}

// q, k, v, o: (BH, N, 32) float32; scratch: q and k as rows hi / lo, v as
// transposed hi / lo (flash_d32.py:_scratch), 16-byte aligned.
extern "C" int flash_d32_f32_forward(const void* q, const void* k, const void* v,
                                     void* o, void* scratch, int BH, int N,
                                     float scale, void* stream) {
  return launch_forward<false>((const float*)q, (const float*)k, (const float*)v,
                               (float*)o, nullptr, scratch, BH, N, scale, stream);
}

// The training forward: the same output plus lse (BH, N), float32.
extern "C" int flash_d32_f32_forward_lse(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         void* scratch, int BH, int N,
                                         float scale, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return launch_forward<true>((const float*)q, (const float*)k, (const float*)v,
                              (float*)o, (float*)lse, scratch, BH, N, scale,
                              stream);
}
