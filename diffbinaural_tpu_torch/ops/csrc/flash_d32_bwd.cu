// Flash attention backward for head dimension 32, on (B*H, N, 32):
//
//   given q, k, v, o, do and lse (the log-sum-exp of the scaled scores, from
//   the training forward), with s = scale * q k^T and p = exp(s - lse):
//     di = rowsum(o * do)         dv = p^T do         dp = do v^T
//     ds = p * (dp - di)          dk = scale * ds^T q dq = scale * ds k
//
// Replaces _attn_core_bwd of diffbinaural_tpu/ops/flash_d32.py, which calls
// the stock TPU kernels _flash_attention_bwd_dkv and _flash_attention_bwd_dq
// (jax.experimental.pallas.ops.tpu.flash_attention).  The TPU code scales q
// outside its custom-VJP core and runs both directions with sm_scale = 1;
// here the scale is applied inside the kernels on the unscaled q, so p is
// recomputed from the scaled scores and dq and dk each carry one factor of
// scale at the end.  The TPU code pads N to a multiple of 512 and masks with
// segment ids; here rows and keys beyond N are masked by index, and a masked
// p is exactly 0.
//
// What bounds it on this card: five products, 10*N*N*32 FLOP per head at
// the least, and N*N exp2 on the special-function unit (16 per clock per
// SM), against 8*N*32 elements moved.  Nothing carries over between blocks
// on this card, so the work is split the way that needs no atomics and
// gives the same sums in every run: one kernel whose blocks each own a tile
// of keys and loop over the query tiles (dk, dv), one whose blocks each own
// a tile of queries and loop over the key tiles (dq).  Both recompute s,
// p and dp, which makes 14*N*N*32 FLOP and 2*N*N exp2 per head in all.  A
// small first kernel writes di.
//
//  * bfloat16 (what the training path runs): two warp-specialised kernels
//    on the forward's machinery (flash_hopper.cuh): a producer warp keeps a
//    ring of 4 stages in flight with TMA, three consumer warpgroups of 64
//    rows (a block owns 192 keys, or 192 query rows) share each stage and
//    multiply with wgmma; float32 accumulators, p and ds rounded to bfloat16
//    for the second products.  Each warpgroup waits for its products before
//    it uses them; the other warpgroups' work fills the tensor cores and the
//    special-function unit meanwhile (three, not two: both are timed by
//    ops/flash_d32_variants.py, readings in PERF.md).  No operand is
//    transposed in memory: the dk/dv kernel computes s^T = k q^T and
//    dp^T = v do^T directly (A = its k or v rows from shared memory, B = the
//    streamed q or do tile, K-major as it lies), so p^T and ds^T come out in
//    the accumulator layout that is the register A operand of dv += p^T do
//    and dk += ds^T q, whose B is the same q / do tile read MN-major
//    (transpose bit).  The ring's stages also carry the tile's lse (base 2;
//    +inf beyond N, so that p = 0 there) and di, written by the producer
//    warp's lanes, each of which arrives on the stage's barrier.  The dq
//    kernel is the forward's loop with dp = do v^T beside s = q k^T (B = the
//    K and V tiles, K-major) and dq += ds k (B = the K tile, transpose bit).
//  * float32 runs flash_d32_f32_bwd.cu (split-TF32 products on wgmma); the
//    earlier CUDA-core kernels (one thread per key or query row) are kept as
//    its yardstick in csrc_variants/flash_d32_cuda_core.cu.
#include "flash_hopper.cuh"

// ------------------------------------------------------------------- di

// di[row] = sum_d o[row][d] * do[row][d], float32, one thread per row.
__global__ void __launch_bounds__(256)
flash_d32_di_kernel(const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout,
                    float* __restrict__ di, int rows) {
  const int r = blockIdx.x * 256 + threadIdx.x;
  if (r >= rows) return;
  const uint4* a = reinterpret_cast<const uint4*>(o + (size_t)r * FD);
  const uint4* b = reinterpret_cast<const uint4*>(dout + (size_t)r * FD);
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < FD / 8; ++c) {
    const uint4 ra = a[c], rb = b[c];
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&ra);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&rb);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = __bfloat1622float2(pa[i]);
      const float2 fb = __bfloat1622float2(pb[i]);
      acc = fmaf(fa.x, fb.x, acc);
      acc = fmaf(fa.y, fb.y, acc);
    }
  }
  di[r] = acc;
}

// ---------------------------------------------------- tensor cores (Hopper)

// Store a 64-row warpgroup accumulator of 32 columns (this thread's rows
// r_lo and r_hi = r_lo + 8) times `factor` as bfloat16; rows >= N are not
// stored.
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* __restrict__ dst,
                                                const float* acc, int r_lo,
                                                int N, int t, float factor) {
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
    if (r_lo < N) {
      *reinterpret_cast<uint32_t*>(dst + (size_t)r_lo * FD + dt * 8 + 2 * t) =
          pack_bf16(acc[4 * dt] * factor, acc[4 * dt + 1] * factor);
    }
    if (r_hi < N) {
      *reinterpret_cast<uint32_t*>(dst + (size_t)r_hi * FD + dt * 8 + 2 * t) =
          pack_bf16(acc[4 * dt + 2] * factor, acc[4 * dt + 3] * factor);
    }
  }
}

// One block owns BWD_KV_BLOCK_N keys (64 per consumer warpgroup) and streams
// the query tiles.  All products have the KEYS as their rows: st = k q^T,
// dpt = v do^T, dv += pt do, dk += dst q.
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_d32_bwd_dkv_ws_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const float* __restrict__ lse,
                            const float* __restrict__ di,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int N,
                            int n_ktiles, float scale) {
  constexpr int BM = BWD_KV_BLOCK_M;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full0 = base + BwdKvSmem::bars;
  const uint32_t empty0 = full0 + 8 * BWD_STAGES;
  const uint32_t kv_bar = empty0 + 8 * BWD_STAGES;
  const int bh = blockIdx.x / n_ktiles;
  const int k0 = (blockIdx.x % n_ktiles) * BWD_KV_BLOCK_N;
  const int n_qt = (N + BM - 1) / BM;
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 32);  // the producer warp's lanes
      mbar_init(empty0 + 8 * s, BWD_CONSUMERS * WG_THREADS);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == BWD_CONSUMERS) {
    // ---- producer warp: lane 0 issues the copies, every lane stages lse/di
    setmaxnreg_dec<BWD_PRODUCER_REGS>();
    if (threadIdx.x < BWD_CONSUMERS * WG_THREADS + 32) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_expect_tx(kv_bar, 2 * tile_bytes(BWD_KV_BLOCK_N));
        tma_load_rows(base + BwdKvSmem::k, &k_map, kv_bar, k0, bh);
        tma_load_rows(base + BwdKvSmem::v, &v_map, kv_bar, k0, bh);
      }
      const size_t rbase = (size_t)bh * N;
      for (int j = 0; j < n_qt; ++j) {
        const int s = j % BWD_STAGES;
        if (j >= BWD_STAGES) mbar_wait(empty0 + 8 * s, (j / BWD_STAGES - 1) & 1);
        const uint32_t bar = full0 + 8 * s;
        float* ls = reinterpret_cast<float*>(smem + BwdKvSmem::lse(s));
        float* is = reinterpret_cast<float*>(smem + BwdKvSmem::di(s));
        // a query row beyond N has q = do = 0 in the tile and lse = +inf,
        // so its p = exp2(0 - inf) is exactly 0 and so is its ds
        for (int i = lane; i < BM; i += 32) {
          const int row = j * BM + i;
          const bool valid = row < N;
          ls[i] = valid ? lse[rbase + row] * LOG2E : INFINITY;
          is[i] = valid ? di[rbase + row] : 0.0f;
        }
        if (lane == 0) {
          mbar_expect_tx(bar, 2 * tile_bytes(BM));
          tma_load_rows(base + BwdKvSmem::q(s), &q_map, bar, j * BM, bh);
          tma_load_rows(base + BwdKvSmem::dout(s), &do_map, bar, j * BM, bh);
        } else {
          mbar_arrive(bar);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys k0 + 64 wg ... + 63
    setmaxnreg_inc<BWD_CONSUMER_REGS>();
    const int tid = threadIdx.x % WG_THREADS;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int j_lo = k0 + 64 * wg + 16 * (tid >> 5) + g;
    const float qscale = scale * LOG2E;
    const uint64_t k_desc = sw64_desc(base + BwdKvSmem::k + wg * tile_bytes(64));
    const uint64_t v_desc = sw64_desc(base + BwdKvSmem::v + wg * tile_bytes(64));

    float st[BM / 2], dpt[BM / 2], dk_acc[16], dv_acc[16];
    uint32_t pa[BM / 4], sa[BM / 4];  // pt and dst as A fragments
#pragma unroll
    for (int i = 0; i < 16; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

    mbar_wait(kv_bar, 0);
    for (int j = 0; j < n_qt; ++j) {
      const int s = j % BWD_STAGES;
      mbar_wait(full0 + 8 * s, (j / BWD_STAGES) & 1);
      const uint64_t q_desc = sw64_desc(base + BwdKvSmem::q(s));
      const uint64_t do_desc = sw64_desc(base + BwdKvSmem::dout(s));

      // st = k q^T and dpt = v do^T: 64 keys x BM queries
      wgmma_fence();
      wgmma_m64n64k16_ss_first(st, k_desc, q_desc);
      wgmma_m64n64k16_ss(st, k_desc + DESC_K16_KMAJOR, q_desc + DESC_K16_KMAJOR);
      wgmma_m64n64k16_ss_first(dpt, v_desc, do_desc);
      wgmma_m64n64k16_ss(dpt, v_desc + DESC_K16_KMAJOR, do_desc + DESC_K16_KMAJOR);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BM / 2>(st);
      fence_regs<BM / 2>(dpt);

      // columns 8c + 2t and + 1 of chunk c are queries; st becomes pt and
      // dpt becomes dst
      const float* ls = reinterpret_cast<const float*>(smem + BwdKvSmem::lse(s));
      const float* is = reinterpret_cast<const float*>(smem + BwdKvSmem::di(s));
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
      pack_a_frags<BM / 2>(st, pa);
      pack_a_frags<BM / 2>(dpt, sa);

      // dv += pt do and dk += dst q: BM / 16 k-steps of 16 queries
      fence_regs<16>(dv_acc);
      fence_regs<16>(dk_acc);
      fence_regs<BM / 4>(pa);
      fence_regs<BM / 4>(sa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        wgmma_m64n32k16_rs(dv_acc, pa + 4 * kk, do_desc + kk * DESC_K16_MNMAJOR);
        wgmma_m64n32k16_rs(dk_acc, sa + 4 * kk, q_desc + kk * DESC_K16_MNMAJOR);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<16>(dv_acc);
      fence_regs<16>(dk_acc);
      fence_regs<BM / 4>(pa);
      fence_regs<BM / 4>(sa);
      mbar_arrive(empty0 + 8 * s);
    }

    const size_t base_o = (size_t)bh * N * FD;
    store_rows_bf16(dv + base_o, dv_acc, j_lo, N, t, 1.0f);
    store_rows_bf16(dk + base_o, dk_acc, j_lo, N, t, scale);
  }
}

// One block owns BWD_Q_BLOCK_M query rows (64 per consumer warpgroup) and
// streams the key tiles: s = q k^T, dp = do v^T, dq += ds k.
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_d32_bwd_dq_ws_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const float* __restrict__ lse,
                           const float* __restrict__ di,
                           __nv_bfloat16* __restrict__ dq, int N, int n_qtiles,
                           float scale) {
  constexpr int BN = BWD_Q_BLOCK_N;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  const uint32_t full0 = base + BwdQSmem::bars;
  const uint32_t empty0 = full0 + 8 * BWD_STAGES;
  const uint32_t q_bar = empty0 + 8 * BWD_STAGES;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * BWD_Q_BLOCK_M;
  const int n_kt = (N + BN - 1) / BN;
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, BWD_CONSUMERS * WG_THREADS);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == BWD_CONSUMERS) {
    // ---- producer: one thread issues every copy
    setmaxnreg_dec<BWD_PRODUCER_REGS>();
    if (threadIdx.x == BWD_CONSUMERS * WG_THREADS) {
      mbar_expect_tx(q_bar, 2 * tile_bytes(BWD_Q_BLOCK_M));
      tma_load_rows(base + BwdQSmem::q, &q_map, q_bar, q0, bh);
      tma_load_rows(base + BwdQSmem::dout, &do_map, q_bar, q0, bh);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % BWD_STAGES;
        if (j >= BWD_STAGES) mbar_wait(empty0 + 8 * s, (j / BWD_STAGES - 1) & 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, 2 * tile_bytes(BN));
        tma_load_rows(base + BwdQSmem::k(s), &k_map, bar, j * BN, bh);
        tma_load_rows(base + BwdQSmem::v(s), &v_map, bar, j * BN, bh);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg ... + 63
    setmaxnreg_inc<BWD_CONSUMER_REGS>();
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
    const uint64_t q_desc = sw64_desc(base + BwdQSmem::q + wg * tile_bytes(64));
    const uint64_t do_desc = sw64_desc(base + BwdQSmem::dout + wg * tile_bytes(64));

    float s_acc[BN / 2], dp[BN / 2], acc[16];
    uint32_t sa[BN / 4];  // ds as A fragments
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.0f;

    mbar_wait(q_bar, 0);
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % BWD_STAGES;
      mbar_wait(full0 + 8 * s, (j / BWD_STAGES) & 1);
      const uint64_t k_desc = sw64_desc(base + BwdQSmem::k(s));
      const uint64_t v_desc = sw64_desc(base + BwdQSmem::v(s));

      // s = q k^T and dp = do v^T: 64 rows x BN keys
      wgmma_fence();
      wgmma_m64n64k16_ss_first(s_acc, q_desc, k_desc);
      wgmma_m64n64k16_ss(s_acc, q_desc + DESC_K16_KMAJOR, k_desc + DESC_K16_KMAJOR);
      wgmma_m64n64k16_ss_first(dp, do_desc, v_desc);
      wgmma_m64n64k16_ss(dp, do_desc + DESC_K16_KMAJOR, v_desc + DESC_K16_KMAJOR);
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
      pack_a_frags<BN / 2>(s_acc, sa);

      // dq += ds k: BN / 16 k-steps of 16 keys
      fence_regs<16>(acc);
      fence_regs<BN / 4>(sa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_m64n32k16_rs(acc, sa + 4 * kk, k_desc + kk * DESC_K16_MNMAJOR);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<16>(acc);
      fence_regs<BN / 4>(sa);
      mbar_arrive(empty0 + 8 * s);
    }

    store_rows_bf16(dq + (size_t)bh * N * FD, acc, r_lo, N, t, scale);
  }
}

// --------------------------------------------------------------- host side

// The eight tensor maps and both launches of the bfloat16 backward.
static int launch_backward_bf16(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* di, void* dq, void* dk, void* dv,
                                int BH, int N, float scale, cudaStream_t s) {
  CUtensorMap kv_maps[4], q_maps[4];  // q, do, k, v for each kernel
  int e = 0;
  const void* src[4] = {q, dout, k, v};
  for (int i = 0; i < 4 && e == 0; ++i) {
    e = make_rows_map(&kv_maps[i], src[i], BH, N,
                      i < 2 ? BWD_KV_BLOCK_M : BWD_KV_BLOCK_N);
    if (e == 0)
      e = make_rows_map(&q_maps[i], src[i], BH, N,
                        i < 2 ? BWD_Q_BLOCK_M : BWD_Q_BLOCK_N);
  }
  if (e == 0) e = allow_smem<flash_d32_bwd_dkv_ws_kernel>(BwdKvSmem::bytes);
  if (e == 0) e = allow_smem<flash_d32_bwd_dq_ws_kernel>(BwdQSmem::bytes);
  if (e != 0) return e;
  const int n_ktiles = (N + BWD_KV_BLOCK_N - 1) / BWD_KV_BLOCK_N;
  const int n_qtiles = (N + BWD_Q_BLOCK_M - 1) / BWD_Q_BLOCK_M;
  flash_d32_bwd_dkv_ws_kernel<<<(unsigned)((long long)BH * n_ktiles), BWD_THREADS,
                                BwdKvSmem::bytes + TILE_ALIGN, s>>>(
      kv_maps[0], kv_maps[1], kv_maps[2], kv_maps[3], lse, di,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, N, n_ktiles, scale);
  flash_d32_bwd_dq_ws_kernel<<<(unsigned)((long long)BH * n_qtiles), BWD_THREADS,
                               BwdQSmem::bytes + TILE_ALIGN, s>>>(
      q_maps[0], q_maps[1], q_maps[2], q_maps[3], lse, di, (__nv_bfloat16*)dq,
      N, n_qtiles, scale);
  return 0;
}

// q, k, v, o, dout: (BH, N, 32) bfloat16; lse: (BH, N) float32 from the
// training forward; di: (BH, N) float32 scratch, written here; dq, dk, dv:
// (BH, N, 32) bfloat16.
extern "C" int flash_d32_backward(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* di, void* dq, void* dk,
                                  void* dv, int BH, int N, float scale,
                                  void* stream) {
  if (BH <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)BH * N;
  if (rows > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  flash_d32_di_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (float*)di,
      (int)rows);
  const int e = launch_backward_bf16(q, k, v, dout, (const float*)lse,
                                     (const float*)di, dq, dk, dv, BH, N,
                                     scale, s);
  if (e != 0) return e;
  // a refused launch is sticky until read: one read covers all three
  return (int)cudaGetLastError();
}
