// Flash attention backward for head dimension 32 in float32, on (B*H, N, 32):
//
//   given q, k, v, o, do and lse (the log-sum-exp of the scaled scores, from
//   the training forward), with s = scale * q k^T and p = exp(s - lse):
//     di = rowsum(o * do)         dv = p^T do         dp = do v^T
//     ds = p * (dp - di)          dk = scale * ds^T q dq = scale * ds k
//
// Replaces _attn_core_bwd of diffbinaural_tpu/ops/flash_d32.py (the stock
// TPU kernels _flash_attention_bwd_dkv and _flash_attention_bwd_dq) for
// float32 inputs: the stage-1 train step of the float32 UNet runs it.  As in
// the bfloat16 backward (flash_d32_bwd.cu), the scale is applied inside on
// the unscaled q, rows and keys beyond N are masked by index (a masked p is
// exactly 0), and the work is split so that no atomics are needed and every
// run gives the same bits: a di row kernel, a dk/dv kernel whose blocks own
// keys and loop over query tiles, and a dq kernel whose blocks own query rows
// and loop over key tiles.  Both recompute s, p and dp: 14 N^2 32 FLOP per
// head where 10 are needed.
//
// What bounds it on this card: the products, three TF32 products for each
// float32 one (split TF32, flash_f32_hopper.cuh), against 2 N^2 exp2 and
// 8 N 32 floats moved.
//
// Design: the bfloat16 kernels' shapes on float32 operands.  A pre-pass
// writes di, the hi / lo rows of q, k, v and do and the transposed forms of
// q, do and k (wgmma reads .tf32 operands K-major only, so the products that
// sum over query rows or keys read transposed tiles: dv += p^T do and
// dk += ds^T q take do_t and q_t, dq += ds k takes k_t).  Both kernels have
// two consumer warpgroups at 240 registers and a producer warp that keeps a
// ring of 2 stages in flight with TMA (128-byte swizzle).
//   * dk/dv: a block owns 128 keys (64 per warpgroup; k and v hi / lo loaded
//     once) and streams tiles of 64 query rows: q and do hi / lo as rows,
//     their transposed forms, lse (base 2, +inf beyond N so that p = 0 there)
//     and di, the last two written by the producer warp's lanes.
//     s^T = k q^T and dp^T = v do^T are 24 wgmma.m64n64k8 with A = the
//     warpgroup's k / v rows and B = the streamed tile as it lies; p^T and
//     ds^T come out in the accumulator layout, are split into tf32 A
//     fragments (KEY_PERM order), and dv += p^T do, dk += ds^T q are 48
//     wgmma.m64n32k8 against do_t and q_t, into fresh accumulators that are
//     added on the CUDA cores (split_rs_x32).  A thread holds s^T, dp^T (32
//     registers each), p^T and ds^T hi / lo (128), dk, dv and the tile's
//     two products (64).
//   * dq: a block owns 128 query rows (q and do hi / lo loaded once) and
//     streams tiles of 64 keys: k and v hi / lo as rows and k_t hi / lo.
//     s = q k^T and dp = do v^T (24 wgmma.m64n64k8), ds = p (dp - di), split
//     into A fragments, dq += ds k (24 wgmma.m64n32k8 against k_t).
#include "flash_f32_hopper.cuh"

// di[row] = sum_d o[row][d] * do[row][d], float32, one thread per row.
__global__ void __launch_bounds__(256)
flash_d32_f32_di_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                        float* __restrict__ di, int rows) {
  const int r = blockIdx.x * 256 + threadIdx.x;
  if (r >= rows) return;
  const float4* a = reinterpret_cast<const float4*>(o + (size_t)r * FD);
  const float4* b = reinterpret_cast<const float4*>(dout + (size_t)r * FD);
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < FD / 4; ++i) {
    const float4 x = a[i], y = b[i];
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  di[r] = acc;
}

// Store a 64-row warpgroup accumulator of 32 columns (this thread's rows
// r_lo and r_lo + 8) times `factor`; rows >= N are not stored.
__device__ __forceinline__ void store_rows_f32(float* __restrict__ dst,
                                               const float* acc, int r_lo, int N,
                                               int t, float factor) {
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
    if (r_lo < N)
      *reinterpret_cast<float2*>(dst + (size_t)r_lo * FD + dt * 8 + 2 * t) =
          make_float2(acc[4 * dt] * factor, acc[4 * dt + 1] * factor);
    if (r_hi < N)
      *reinterpret_cast<float2*>(dst + (size_t)r_hi * FD + dt * 8 + 2 * t) =
          make_float2(acc[4 * dt + 2] * factor, acc[4 * dt + 3] * factor);
  }
}

// The eight streamed maps of the dk/dv kernel, in the order of the stage's
// tiles: q hi, q lo, do hi, do lo (rows), q_t hi, q_t lo, do_t hi, do_t lo.
struct KvStreamMaps {
  CUtensorMap m[8];
};
// k hi, k lo, v hi, v lo (rows), boxes of the block's keys.
struct KvOwnMaps {
  CUtensorMap m[4];
};

__global__ void __launch_bounds__(F32_BWD_THREADS, 1)
flash_d32_f32_bwd_dkv_kernel(const __grid_constant__ KvStreamMaps streamed,
                             const __grid_constant__ KvOwnMaps own,
                             const float* __restrict__ lse,
                             const float* __restrict__ di, float* __restrict__ dk,
                             float* __restrict__ dv, int N, int n_ktiles,
                             float scale) {
  constexpr int BM = F32_BWD_KV_BLOCK_M, S = F32_BWD_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full0 = base + F32BwdKvSmem::bars;
  const uint32_t empty0 = full0 + 8 * S;
  const uint32_t kv_bar = empty0 + 8 * S;
  const int bh = blockIdx.x / n_ktiles;
  const int k0 = (blockIdx.x % n_ktiles) * F32_BWD_KV_BLOCK_N;
  const int n_qt = (N + BM - 1) / BM;
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 32);  // the producer warp's lanes
      mbar_init(empty0 + 8 * s, F32_BWD_CONSUMERS * WG_THREADS);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == F32_BWD_CONSUMERS) {
    // ---- producer warp: lane 0 issues the copies, every lane stages lse/di
    setmaxnreg_dec<F32_BWD_PRODUCER_REGS>();
    if (threadIdx.x < F32_BWD_CONSUMERS * WG_THREADS + 32) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_expect_tx(kv_bar, 4 * F32BwdKvSmem::kv_tile);
        const int own_at[4] = {F32BwdKvSmem::k_hi, F32BwdKvSmem::k_lo,
                               F32BwdKvSmem::v_hi, F32BwdKvSmem::v_lo};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          tma_load_rows(base + own_at[i], &own.m[i], kv_bar, k0, bh);
      }
      const size_t rbase = (size_t)bh * N;
      for (int j = 0; j < n_qt; ++j) {
        const int s = j % S;
        if (j >= S) mbar_wait(empty0 + 8 * s, (j / S - 1) & 1);
        const uint32_t bar = full0 + 8 * s;
        float* ls = reinterpret_cast<float*>(smem + F32BwdKvSmem::lse(s));
        float* is = reinterpret_cast<float*>(smem + F32BwdKvSmem::di(s));
        // a query row beyond N has q = do = 0 in the tiles and lse = +inf,
        // so its p = exp2(0 - inf) is exactly 0 and so is its ds
        for (int i = lane; i < BM; i += 32) {
          const int row = j * BM + i;
          const bool valid = row < N;
          ls[i] = valid ? lse[rbase + row] * LOG2E : INFINITY;
          is[i] = valid ? di[rbase + row] : 0.0f;
        }
        if (lane == 0) {
          mbar_expect_tx(bar, 8 * F32BwdKvSmem::m_tile);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            tma_load_rows(base + F32BwdKvSmem::tile(s, i), &streamed.m[i], bar,
                          j * BM, bh);
        } else {
          mbar_arrive(bar);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys k0 + 64 wg ... + 63
    setmaxnreg_inc<F32_BWD_CONSUMER_REGS>();
    const int tid = threadIdx.x % WG_THREADS;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int j_lo = k0 + 64 * wg + 16 * (tid >> 5) + g;
    const float qscale = scale * LOG2E;
    const uint32_t own = wg * f32_tile(64);

    float st[BM / 2], dpt[BM / 2], dk_acc[16], dv_acc[16], dk_t[16], dv_t[16];
    uint32_t ph[BM / 2], pl[BM / 2], sh[BM / 2], sl[BM / 2];
#pragma unroll
    for (int i = 0; i < 16; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

    mbar_wait(kv_bar, 0);
    for (int j = 0; j < n_qt; ++j) {
      const int s = j % S;
      mbar_wait(full0 + 8 * s, (j / S) & 1);

      // st = k q^T and dpt = v do^T: 64 keys x BM queries
      wgmma_fence();
      split_ss_64x64(st, base + F32BwdKvSmem::k_hi + own,
                     base + F32BwdKvSmem::k_lo + own, base + F32BwdKvSmem::tile(s, 0),
                     base + F32BwdKvSmem::tile(s, 1));
      split_ss_64x64(dpt, base + F32BwdKvSmem::v_hi + own,
                     base + F32BwdKvSmem::v_lo + own, base + F32BwdKvSmem::tile(s, 2),
                     base + F32BwdKvSmem::tile(s, 3));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BM / 2>(st);
      fence_regs<BM / 2>(dpt);

      // columns 8c + 2t and + 1 of chunk c are queries; st becomes pt and
      // dpt becomes dst
      const float* ls = reinterpret_cast<const float*>(smem + F32BwdKvSmem::lse(s));
      const float* is = reinterpret_cast<const float*>(smem + F32BwdKvSmem::di(s));
#pragma unroll
      for (int c = 0; c < BM / 8; ++c) {
        const int col = 8 * c + 2 * t;
        const float l0 = ls[col], l1 = ls[col + 1];
        const float i0 = is[col], i1 = is[col + 1];
        st[4 * c] = ex2(fmaf(st[4 * c], qscale, -l0));
        st[4 * c + 1] = ex2(fmaf(st[4 * c + 1], qscale, -l1));
        st[4 * c + 2] = ex2(fmaf(st[4 * c + 2], qscale, -l0));
        st[4 * c + 3] = ex2(fmaf(st[4 * c + 3], qscale, -l1));
        dpt[4 * c] = st[4 * c] * (dpt[4 * c] - i0);
        dpt[4 * c + 1] = st[4 * c + 1] * (dpt[4 * c + 1] - i1);
        dpt[4 * c + 2] = st[4 * c + 2] * (dpt[4 * c + 2] - i0);
        dpt[4 * c + 3] = st[4 * c + 3] * (dpt[4 * c + 3] - i1);
      }
      split_a_frags<BM>(st, ph, pl);
      split_a_frags<BM>(dpt, sh, sl);

      // dv += pt do and dk += dst q over the BM queries: the tile's products
      // into fresh accumulators, added on the CUDA cores
      fence_regs<BM / 2>(ph);
      fence_regs<BM / 2>(pl);
      fence_regs<BM / 2>(sh);
      fence_regs<BM / 2>(sl);
      wgmma_fence();
      split_rs_x32<BM>(dv_t, ph, pl, base + F32BwdKvSmem::tile(s, 6),
                       base + F32BwdKvSmem::tile(s, 7));
      split_rs_x32<BM>(dk_t, sh, sl, base + F32BwdKvSmem::tile(s, 4),
                       base + F32BwdKvSmem::tile(s, 5));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<16>(dv_t);
      fence_regs<16>(dk_t);
      fence_regs<BM / 2>(ph);
      fence_regs<BM / 2>(pl);
      fence_regs<BM / 2>(sh);
      fence_regs<BM / 2>(sl);
      mbar_arrive(empty0 + 8 * s);
      add_tile<16>(dv_acc, dv_t);
      add_tile<16>(dk_acc, dk_t);
    }

    const size_t base_o = (size_t)bh * N * FD;
    store_rows_f32(dv + base_o, dv_acc, j_lo, N, t, 1.0f);
    store_rows_f32(dk + base_o, dk_acc, j_lo, N, t, scale);
  }
}

// q hi, q lo, do hi, do lo (rows), boxes of the block's query rows.
struct QOwnMaps {
  CUtensorMap m[4];
};
// k hi, k lo, v hi, v lo (rows), k_t hi, k_t lo, boxes of a key tile.
struct QStreamMaps {
  CUtensorMap m[6];
};

__global__ void __launch_bounds__(F32_BWD_THREADS, 1)
flash_d32_f32_bwd_dq_kernel(const __grid_constant__ QOwnMaps own,
                            const __grid_constant__ QStreamMaps streamed,
                            const float* __restrict__ lse,
                            const float* __restrict__ di, float* __restrict__ dq,
                            int N, int n_qtiles, float scale) {
  constexpr int BN = F32_BWD_Q_BLOCK_N, S = F32_BWD_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  const uint32_t full0 = base + F32BwdQSmem::bars;
  const uint32_t empty0 = full0 + 8 * S;
  const uint32_t q_bar = empty0 + 8 * S;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * F32_BWD_Q_BLOCK_M;
  const int n_kt = (N + BN - 1) / BN;
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, F32_BWD_CONSUMERS * WG_THREADS);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == F32_BWD_CONSUMERS) {
    // ---- producer: one thread issues every copy
    setmaxnreg_dec<F32_BWD_PRODUCER_REGS>();
    if (threadIdx.x == F32_BWD_CONSUMERS * WG_THREADS) {
      mbar_expect_tx(q_bar, 4 * F32BwdQSmem::q_tile);
      const int own_at[4] = {F32BwdQSmem::q_hi, F32BwdQSmem::q_lo,
                             F32BwdQSmem::do_hi, F32BwdQSmem::do_lo};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tma_load_rows(base + own_at[i], &own.m[i], q_bar, q0, bh);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % S;
        if (j >= S) mbar_wait(empty0 + 8 * s, (j / S - 1) & 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, 6 * F32BwdQSmem::n_tile);
#pragma unroll
        for (int i = 0; i < 6; ++i)
          tma_load_rows(base + F32BwdQSmem::tile(s, i), &streamed.m[i], bar,
                        j * BN, bh);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg ... + 63
    setmaxnreg_inc<F32_BWD_CONSUMER_REGS>();
    const int tid = threadIdx.x % WG_THREADS;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r_lo = q0 + 64 * wg + 16 * (tid >> 5) + g;
    const size_t rbase = (size_t)bh * N;
    const int rc_lo = min(r_lo, N - 1);
    const int rc_hi = min(r_lo + 8, N - 1);
    const float l_lo = lse[rbase + rc_lo] * LOG2E;
    const float l_hi = lse[rbase + rc_hi] * LOG2E;
    const float i_lo = di[rbase + rc_lo];
    const float i_hi = di[rbase + rc_hi];
    const float qscale = scale * LOG2E;
    const uint32_t own_rows = wg * f32_tile(64);

    float s_acc[BN / 2], dp[BN / 2], acc[16], dq_t[16];
    uint32_t sh[BN / 2], sl[BN / 2];  // ds as tf32 A fragments, hi / lo
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.0f;

    mbar_wait(q_bar, 0);
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % S;
      mbar_wait(full0 + 8 * s, (j / S) & 1);

      // s = q k^T and dp = do v^T: 64 rows x BN keys
      wgmma_fence();
      split_ss_64x64(s_acc, base + F32BwdQSmem::q_hi + own_rows,
                     base + F32BwdQSmem::q_lo + own_rows,
                     base + F32BwdQSmem::tile(s, 0), base + F32BwdQSmem::tile(s, 1));
      split_ss_64x64(dp, base + F32BwdQSmem::do_hi + own_rows,
                     base + F32BwdQSmem::do_lo + own_rows,
                     base + F32BwdQSmem::tile(s, 2), base + F32BwdQSmem::tile(s, 3));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BN / 2>(s_acc);
      fence_regs<BN / 2>(dp);

      // s becomes ds = p * (dp - di)
      const int kv = N - j * BN;
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        float p0 = ex2(fmaf(s_acc[4 * c], qscale, -l_lo));
        float p1 = ex2(fmaf(s_acc[4 * c + 1], qscale, -l_lo));
        float p2 = ex2(fmaf(s_acc[4 * c + 2], qscale, -l_hi));
        float p3 = ex2(fmaf(s_acc[4 * c + 3], qscale, -l_hi));
        if (kv < BN) {  // ragged last tile: keys beyond N have p = 0 exactly
          const int key = 8 * c + 2 * t;
          if (key >= kv) p0 = p2 = 0.0f;
          if (key + 1 >= kv) p1 = p3 = 0.0f;
        }
        s_acc[4 * c] = p0 * (dp[4 * c] - i_lo);
        s_acc[4 * c + 1] = p1 * (dp[4 * c + 1] - i_lo);
        s_acc[4 * c + 2] = p2 * (dp[4 * c + 2] - i_hi);
        s_acc[4 * c + 3] = p3 * (dp[4 * c + 3] - i_hi);
      }
      split_a_frags<BN>(s_acc, sh, sl);

      // dq += ds k over the BN keys: the tile's product into a fresh
      // accumulator, added on the CUDA cores
      fence_regs<BN / 2>(sh);
      fence_regs<BN / 2>(sl);
      wgmma_fence();
      split_rs_x32<BN>(dq_t, sh, sl, base + F32BwdQSmem::tile(s, 4),
                       base + F32BwdQSmem::tile(s, 5));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<16>(dq_t);
      fence_regs<BN / 2>(sh);
      fence_regs<BN / 2>(sl);
      mbar_arrive(empty0 + 8 * s);
      add_tile<16>(acc, dq_t);
    }

    store_rows_f32(dq + (size_t)bh * N * FD, acc, r_lo, N, t, scale);
  }
}

// --------------------------------------------------------------- host side

// q, k, v, o, dout: (BH, N, 32) float32; lse: (BH, N) float32 from the
// training forward; di: (BH, N) float32 scratch, written here; scratch: q,
// k, v, do as rows hi / lo, then q, do, k as transposed hi / lo
// (flash_d32.py:_scratch), 16-byte aligned; dq, dk, dv: (BH, N, 32) float32.
extern "C" int flash_d32_f32_backward(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout,
                                      const void* lse, void* di, void* scratch,
                                      void* dq, void* dk, void* dv, int BH, int N,
                                      float scale, void* stream) {
  if (BH <= 0 || N <= 0 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)BH * N;
  if (rows > 2147483647LL || (long long)BH * f32_pad_rows(N) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* lse_f = (const float*)lse;
  float* di_f = (float*)di;
  flash_d32_f32_di_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(
      (const float*)o, (const float*)dout, di_f, (int)rows);
  float* at = (float*)scratch;
  const float* src[4] = {(const float*)q, (const float*)k, (const float*)v,
                         (const float*)dout};
  SplitForm r[4], tq, tdo, tk;  // rows: q, k, v, do
  for (int i = 0; i < 4; ++i) {
    r[i] = take_rows(at, BH, N);
    launch_split_rows(src[i], r[i], BH, N, s);
  }
  tq = take_transposed(at, BH, N);
  tdo = take_transposed(at, BH, N);
  tk = take_transposed(at, BH, N);
  launch_split_transposed(src[0], tq, BH, N, s);
  launch_split_transposed(src[3], tdo, BH, N, s);
  launch_split_transposed(src[1], tk, BH, N, s);

  const int n_pad = (int)f32_pad_rows(N);
  KvStreamMaps kv_stream;
  KvOwnMaps kv_own;
  QOwnMaps q_own;
  QStreamMaps q_stream;
  int e = 0;
  for (int i = 0; i < 2 && e == 0; ++i) {  // q, do rows then transposed
    const SplitForm rf = i == 0 ? r[0] : r[3];
    const SplitForm tf = i == 0 ? tq : tdo;
    e = make_rows_map_f32(&kv_stream.m[2 * i], rf.hi, BH, N, F32_BWD_KV_BLOCK_M);
    if (e == 0)
      e = make_rows_map_f32(&kv_stream.m[2 * i + 1], rf.lo, BH, N, F32_BWD_KV_BLOCK_M);
    if (e == 0)
      e = make_rows_map_f32(&kv_stream.m[4 + 2 * i], tf.hi, BH, n_pad,
                            F32_BWD_KV_BLOCK_M);
    if (e == 0)
      e = make_rows_map_f32(&kv_stream.m[5 + 2 * i], tf.lo, BH, n_pad,
                            F32_BWD_KV_BLOCK_M);
  }
  for (int i = 0; i < 2 && e == 0; ++i) {  // k, v rows: the dk/dv block's own
    e = make_rows_map_f32(&kv_own.m[2 * i], r[1 + i].hi, BH, N, F32_BWD_KV_BLOCK_N);
    if (e == 0)
      e = make_rows_map_f32(&kv_own.m[2 * i + 1], r[1 + i].lo, BH, N,
                            F32_BWD_KV_BLOCK_N);
  }
  for (int i = 0; i < 2 && e == 0; ++i) {  // q, do rows: the dq block's own
    const SplitForm rf = i == 0 ? r[0] : r[3];
    e = make_rows_map_f32(&q_own.m[2 * i], rf.hi, BH, N, F32_BWD_Q_BLOCK_M);
    if (e == 0)
      e = make_rows_map_f32(&q_own.m[2 * i + 1], rf.lo, BH, N, F32_BWD_Q_BLOCK_M);
  }
  for (int i = 0; i < 2 && e == 0; ++i) {  // k, v rows streamed by dq
    e = make_rows_map_f32(&q_stream.m[2 * i], r[1 + i].hi, BH, N, F32_BWD_Q_BLOCK_N);
    if (e == 0)
      e = make_rows_map_f32(&q_stream.m[2 * i + 1], r[1 + i].lo, BH, N,
                            F32_BWD_Q_BLOCK_N);
  }
  if (e == 0) e = make_rows_map_f32(&q_stream.m[4], tk.hi, BH, n_pad, F32_BWD_Q_BLOCK_N);
  if (e == 0) e = make_rows_map_f32(&q_stream.m[5], tk.lo, BH, n_pad, F32_BWD_Q_BLOCK_N);
  if (e == 0) e = allow_smem<flash_d32_f32_bwd_dkv_kernel>(F32BwdKvSmem::bytes);
  if (e == 0) e = allow_smem<flash_d32_f32_bwd_dq_kernel>(F32BwdQSmem::bytes);
  if (e != 0) return e;

  const int n_ktiles = (N + F32_BWD_KV_BLOCK_N - 1) / F32_BWD_KV_BLOCK_N;
  const int n_qtiles = (N + F32_BWD_Q_BLOCK_M - 1) / F32_BWD_Q_BLOCK_M;
  flash_d32_f32_bwd_dkv_kernel<<<(unsigned)((long long)BH * n_ktiles),
                                 F32_BWD_THREADS, F32BwdKvSmem::bytes + TILE_ALIGN, s>>>(
      kv_stream, kv_own, lse_f, di_f, (float*)dk, (float*)dv, N, n_ktiles, scale);
  flash_d32_f32_bwd_dq_kernel<<<(unsigned)((long long)BH * n_qtiles),
                                F32_BWD_THREADS, F32BwdQSmem::bytes + TILE_ALIGN, s>>>(
      q_own, q_stream, lse_f, di_f, (float*)dq, N, n_qtiles, scale);
  // a refused launch is sticky until read: one read covers all of them
  return (int)cudaGetLastError();
}
