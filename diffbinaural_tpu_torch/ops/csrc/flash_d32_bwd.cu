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
// Bound by operations: five products, 10*N*N*32 FLOP per head at the least,
// against 8*N*32 elements moved.  Nothing carries over between blocks on
// this card, so the work is split the way that needs no atomics and gives
// the same sums in every run: one kernel whose blocks each own a tile of
// keys and loop over the query tiles (dk, dv), one whose blocks each own a
// tile of queries and loop over the key tiles (dq).  Both recompute s and
// dp, which makes 14*N*N*32 FLOP per head in all.  A small first kernel
// writes di.
//
//  * bfloat16 (what the training path runs): tensor cores, mma.sync.m16n8k16,
//    float32 accumulators; p and ds are rounded to bfloat16 for the second
//    products.  The transposed operands are avoided, not transposed: the
//    dk/dv kernel computes s^T = k q^T and dp^T = v do^T directly (k and v
//    rows are the A fragments, held in registers; q and do tiles in shared
//    memory are read as B fragments exactly as the forward reads k), so p^T
//    and ds^T come out in the accumulator layout that, for two neighbouring
//    8-query tiles, IS the A fragment of p^T do and ds^T q; the B fragments
//    of those products come from ldmatrix.trans on the same shared tiles, as
//    the forward's do for v.  The dq kernel is the forward's loop with a
//    second score-like product (do v^T) and ldmatrix.trans on the k tile.
//  * float32: CUDA cores, one thread per key (dk/dv) or per query row (dq)
//    with its rows and accumulators in registers; every thread reads the
//    same shared row at a time, so shared reads are broadcasts.
#include "flash_common.cuh"

// ------------------------------------------------------------------- di

__device__ __forceinline__ float dot32(const float* a, const float* b) {
  float acc = 0.0f;
#pragma unroll
  for (int d = 0; d < FD; d += 8) {
    float x[8], y[8];
    load8(a + d, x);
    load8(b + d, y);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = fmaf(x[i], y[i], acc);
  }
  return acc;
}

__device__ __forceinline__ float dot32(const __nv_bfloat16* a,
                                       const __nv_bfloat16* b) {
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < FD / 8; ++c) {
    const uint4 ra = reinterpret_cast<const uint4*>(a)[c];
    const uint4 rb = reinterpret_cast<const uint4*>(b)[c];
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
  return acc;
}

// di[row] = sum_d o[row][d] * do[row][d], float32, one thread per row.
template <typename T>
__global__ void __launch_bounds__(256)
flash_d32_di_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ di, int rows) {
  const int r = blockIdx.x * 256 + threadIdx.x;
  if (r < rows) di[r] = dot32(o + (size_t)r * FD, dout + (size_t)r * FD);
}

// ------------------------------------------------------ float32, CUDA cores

// One block owns FQ keys (one per thread) and loops over query tiles of FK.
__global__ void __launch_bounds__(FQ)
flash_d32_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, float* __restrict__ dk,
                         float* __restrict__ dv, int N, int n_ktiles,
                         float scale) {
  __shared__ __align__(16) float Qs[FK * FD];
  __shared__ __align__(16) float Ds[FK * FD];
  __shared__ float Ls[FK];   // lse in base 2
  __shared__ float Is[FK];   // di

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / n_ktiles;
  const int key = (blockIdx.x % n_ktiles) * FQ + tid;
  const size_t base = (size_t)bh * N * FD;
  const size_t rbase = (size_t)bh * N;
  const int keyc = min(key, N - 1);
  const float qscale = scale * LOG2E;

  float kr[FD], vr[FD], dkr[FD], dvr[FD];
#pragma unroll
  for (int d = 0; d < FD; d += 8) {
    load8(k + base + (size_t)keyc * FD + d, kr + d);
    load8(v + base + (size_t)keyc * FD + d, vr + d);
  }
#pragma unroll
  for (int d = 0; d < FD; ++d) {
    dkr[d] = 0.0f;
    dvr[d] = 0.0f;
  }

  for (int q0 = 0; q0 < N; q0 += FK) {
    const int nq = min(FK, N - q0);
    __syncthreads();  // the previous tile is no longer being read
    load_tile(q + base + (size_t)q0 * FD, nq, Qs, tid);
    load_tile(dout + base + (size_t)q0 * FD, nq, Ds, tid);
    if (tid < FK) {
      const bool valid = tid < nq;
      Ls[tid] = valid ? lse[rbase + q0 + tid] * LOG2E : 0.0f;
      Is[tid] = valid ? di[rbase + q0 + tid] : 0.0f;
    }
    __syncthreads();

    // only the nq valid query rows are visited: a row beyond N adds nothing
    for (int i = 0; i < nq; ++i) {
      const float4* qr = reinterpret_cast<const float4*>(Qs + i * FD);
      const float4* dr = reinterpret_cast<const float4*>(Ds + i * FD);
      float s0 = 0.0f, s1 = 0.0f, p0 = 0.0f, p1 = 0.0f;
#pragma unroll
      for (int d4 = 0; d4 < FD / 4; d4 += 2) {
        const float4 qa = qr[d4], qb = qr[d4 + 1];
        const float4 da = dr[d4], db = dr[d4 + 1];
        s0 = fmaf(qa.x, kr[4 * d4 + 0], s0);
        s0 = fmaf(qa.y, kr[4 * d4 + 1], s0);
        s0 = fmaf(qa.z, kr[4 * d4 + 2], s0);
        s0 = fmaf(qa.w, kr[4 * d4 + 3], s0);
        s1 = fmaf(qb.x, kr[4 * d4 + 4], s1);
        s1 = fmaf(qb.y, kr[4 * d4 + 5], s1);
        s1 = fmaf(qb.z, kr[4 * d4 + 6], s1);
        s1 = fmaf(qb.w, kr[4 * d4 + 7], s1);
        p0 = fmaf(da.x, vr[4 * d4 + 0], p0);
        p0 = fmaf(da.y, vr[4 * d4 + 1], p0);
        p0 = fmaf(da.z, vr[4 * d4 + 2], p0);
        p0 = fmaf(da.w, vr[4 * d4 + 3], p0);
        p1 = fmaf(db.x, vr[4 * d4 + 4], p1);
        p1 = fmaf(db.y, vr[4 * d4 + 5], p1);
        p1 = fmaf(db.z, vr[4 * d4 + 6], p1);
        p1 = fmaf(db.w, vr[4 * d4 + 7], p1);
      }
      const float p = exp2f((s0 + s1) * qscale - Ls[i]);
      const float ds = p * ((p0 + p1) - Is[i]);
#pragma unroll
      for (int d4 = 0; d4 < FD / 4; ++d4) {
        const float4 qa = qr[d4];
        const float4 da = dr[d4];
        dvr[4 * d4 + 0] = fmaf(p, da.x, dvr[4 * d4 + 0]);
        dvr[4 * d4 + 1] = fmaf(p, da.y, dvr[4 * d4 + 1]);
        dvr[4 * d4 + 2] = fmaf(p, da.z, dvr[4 * d4 + 2]);
        dvr[4 * d4 + 3] = fmaf(p, da.w, dvr[4 * d4 + 3]);
        dkr[4 * d4 + 0] = fmaf(ds, qa.x, dkr[4 * d4 + 0]);
        dkr[4 * d4 + 1] = fmaf(ds, qa.y, dkr[4 * d4 + 1]);
        dkr[4 * d4 + 2] = fmaf(ds, qa.z, dkr[4 * d4 + 2]);
        dkr[4 * d4 + 3] = fmaf(ds, qa.w, dkr[4 * d4 + 3]);
      }
    }
  }

  if (key < N) {
#pragma unroll
    for (int d = 0; d < FD; ++d) dkr[d] *= scale;
#pragma unroll
    for (int d = 0; d < FD; d += 8) {
      store8(dk + base + (size_t)key * FD + d, dkr + d);
      store8(dv + base + (size_t)key * FD + d, dvr + d);
    }
  }
}

// One block owns FQ query rows (one per thread) and loops over key tiles.
__global__ void __launch_bounds__(FQ)
flash_d32_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, float* __restrict__ dq,
                        int N, int n_qtiles, float scale) {
  __shared__ __align__(16) float Ks[FK * FD];
  __shared__ __align__(16) float Vs[FK * FD];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / n_qtiles;
  const int row = (blockIdx.x % n_qtiles) * FQ + tid;
  const size_t base = (size_t)bh * N * FD;
  const size_t rbase = (size_t)bh * N;
  const int rowc = min(row, N - 1);
  const float qscale = scale * LOG2E;

  float qr[FD], dor[FD], acc[FD];
#pragma unroll
  for (int d = 0; d < FD; d += 8) {
    load8(q + base + (size_t)rowc * FD + d, qr + d);
    load8(dout + base + (size_t)rowc * FD + d, dor + d);
  }
#pragma unroll
  for (int d = 0; d < FD; ++d) {
    qr[d] *= qscale;
    acc[d] = 0.0f;
  }
  const float l2 = lse[rbase + rowc] * LOG2E;
  const float dii = di[rbase + rowc];

  for (int k0 = 0; k0 < N; k0 += FK) {
    const int kv = min(FK, N - k0);
    __syncthreads();  // the previous tile is no longer being read
    load_tile(k + base + (size_t)k0 * FD, kv, Ks, tid);
    load_tile(v + base + (size_t)k0 * FD, kv, Vs, tid);
    __syncthreads();

    // only the kv valid keys are visited: a key beyond N adds nothing
    for (int j = 0; j < kv; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(Ks + j * FD);
      const float4* vr = reinterpret_cast<const float4*>(Vs + j * FD);
      float s0 = 0.0f, s1 = 0.0f, p0 = 0.0f, p1 = 0.0f;
#pragma unroll
      for (int d4 = 0; d4 < FD / 4; d4 += 2) {
        const float4 ka = kr[d4], kb = kr[d4 + 1];
        const float4 va = vr[d4], vb = vr[d4 + 1];
        s0 = fmaf(qr[4 * d4 + 0], ka.x, s0);
        s0 = fmaf(qr[4 * d4 + 1], ka.y, s0);
        s0 = fmaf(qr[4 * d4 + 2], ka.z, s0);
        s0 = fmaf(qr[4 * d4 + 3], ka.w, s0);
        s1 = fmaf(qr[4 * d4 + 4], kb.x, s1);
        s1 = fmaf(qr[4 * d4 + 5], kb.y, s1);
        s1 = fmaf(qr[4 * d4 + 6], kb.z, s1);
        s1 = fmaf(qr[4 * d4 + 7], kb.w, s1);
        p0 = fmaf(dor[4 * d4 + 0], va.x, p0);
        p0 = fmaf(dor[4 * d4 + 1], va.y, p0);
        p0 = fmaf(dor[4 * d4 + 2], va.z, p0);
        p0 = fmaf(dor[4 * d4 + 3], va.w, p0);
        p1 = fmaf(dor[4 * d4 + 4], vb.x, p1);
        p1 = fmaf(dor[4 * d4 + 5], vb.y, p1);
        p1 = fmaf(dor[4 * d4 + 6], vb.z, p1);
        p1 = fmaf(dor[4 * d4 + 7], vb.w, p1);
      }
      const float p = exp2f((s0 + s1) - l2);
      const float ds = p * ((p0 + p1) - dii);
#pragma unroll
      for (int d4 = 0; d4 < FD / 4; ++d4) {
        const float4 ka = kr[d4];
        acc[4 * d4 + 0] = fmaf(ds, ka.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(ds, ka.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(ds, ka.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(ds, ka.w, acc[4 * d4 + 3]);
      }
    }
  }

  if (row < N) {
#pragma unroll
    for (int d = 0; d < FD; ++d) acc[d] *= scale;
#pragma unroll
    for (int d = 0; d < FD; d += 8) store8(dq + base + (size_t)row * FD + d, acc + d);
  }
}

// ------------------------------------------------------------ tensor cores

// Store a 16-row x 32-column float32 accumulator (4 tiles of 8 columns in
// the mma C layout) times `factor` as bfloat16 rows r_lo and r_hi.
__device__ __forceinline__ void store_acc_bf16(__nv_bfloat16* __restrict__ dst,
                                               float (*acc)[4], int r_lo,
                                               int r_hi, int N, int t,
                                               float factor) {
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
    if (r_lo < N) {
      *reinterpret_cast<uint32_t*>(dst + (size_t)r_lo * FD + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][0] * factor, acc[dt][1] * factor);
    }
    if (r_hi < N) {
      *reinterpret_cast<uint32_t*>(dst + (size_t)r_hi * FD + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2] * factor, acc[dt][3] * factor);
    }
  }
}

// One block owns MK keys (a warp 16 of them) and loops over query tiles.
// All products have the KEYS as their rows: st = k q^T, dpt = v do^T,
// dv += pt do, dk += dst q.
__global__ void __launch_bounds__(MTHREADS)
flash_d32_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ di,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int N,
                             int n_ktiles, float scale) {
  __shared__ __align__(16) __nv_bfloat16 Qs[MQ * MS];
  __shared__ __align__(16) __nv_bfloat16 Ds[MQ * MS];
  __shared__ float Ls[MQ];   // lse in base 2; +inf on rows beyond N
  __shared__ float Is[MQ];   // di

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x / n_ktiles;
  const int key0 = (blockIdx.x % n_ktiles) * MK + warp * 16;
  const size_t base = (size_t)bh * N * FD;
  const size_t rbase = (size_t)bh * N;
  const int j_lo = key0 + g;
  const int j_hi = key0 + g + 8;
  const float qscale = scale * LOG2E;

  uint32_t ka[2][4], va[2][4];
  {
    const size_t off_lo = base + (size_t)min(j_lo, N - 1) * FD;
    const size_t off_hi = base + (size_t)min(j_hi, N - 1) * FD;
    load_a_frags(k + off_lo, k + off_hi, t, ka);
    load_a_frags(v + off_lo, v + off_hi, t, va);
  }

  float dk_acc[4][4], dv_acc[4][4];
#pragma unroll
  for (int dt = 0; dt < 4; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dk_acc[dt][i] = 0.0f;
      dv_acc[dt][i] = 0.0f;
    }

  const uint32_t qs_addr = ldmatrix_lane_addr(Qs, lane);
  const uint32_t ds_addr = ldmatrix_lane_addr(Ds, lane);

  for (int q0 = 0; q0 < N; q0 += MQ) {
    const int nq = min(MQ, N - q0);
    __syncthreads();  // the previous tile is no longer being read
    load_tile_bf16(q + base + (size_t)q0 * FD, nq, Qs, tid);
    load_tile_bf16(dout + base + (size_t)q0 * FD, nq, Ds, tid);
    if (tid < MQ) {
      // a query row beyond N has q = do = 0 in the tile and lse = +inf, so
      // its p = exp2(0 - inf) is exactly 0 and so is its ds
      const bool valid = tid < nq;
      Ls[tid] = valid ? lse[rbase + q0 + tid] * LOG2E : INFINITY;
      Is[tid] = valid ? di[rbase + q0 + tid] : 0.0f;
    }
    __syncthreads();

    // st = k q^T and dpt = v do^T: 8 tiles of 8 queries
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.0f;
      dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.0f;
      const __nv_bfloat16* qr = Qs + (nt * 8 + g) * MS + 2 * t;
      const __nv_bfloat16* dr = Ds + (nt * 8 + g) * MS + 2 * t;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        mma_16816(st[nt], ka[ks],
                  *reinterpret_cast<const uint32_t*>(qr + 16 * ks),
                  *reinterpret_cast<const uint32_t*>(qr + 16 * ks + 8));
        mma_16816(dpt[nt], va[ks],
                  *reinterpret_cast<const uint32_t*>(dr + 16 * ks),
                  *reinterpret_cast<const uint32_t*>(dr + 16 * ks + 8));
      }
    }

    // columns 2t and 2t+1 of tile nt are queries nt*8 + 2t (+1); st becomes
    // pt and dpt becomes dst
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      const float l0 = Ls[c], l1 = Ls[c + 1];
      const float i0 = Is[c], i1 = Is[c + 1];
      st[nt][0] = exp2f(st[nt][0] * qscale - l0);
      st[nt][1] = exp2f(st[nt][1] * qscale - l1);
      st[nt][2] = exp2f(st[nt][2] * qscale - l0);
      st[nt][3] = exp2f(st[nt][3] * qscale - l1);
      dpt[nt][0] = st[nt][0] * (dpt[nt][0] - i0);
      dpt[nt][1] = st[nt][1] * (dpt[nt][1] - i1);
      dpt[nt][2] = st[nt][2] * (dpt[nt][2] - i0);
      dpt[nt][3] = st[nt][3] * (dpt[nt][3] - i1);
    }

    // dv += pt do and dk += dst q: 4 steps of 16 queries, 4 tiles of 8 columns
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4], sa[4];
      pa[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
      pa[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
      pa[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      pa[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
      sa[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
      sa[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
      sa[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
      sa[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(ds_addr, kk * 16, dp * 16, b0, b1, b2, b3);
        mma_16816(dv_acc[2 * dp], pa, b0, b1);
        mma_16816(dv_acc[2 * dp + 1], pa, b2, b3);
        ldmatrix_x4_trans(qs_addr, kk * 16, dp * 16, b0, b1, b2, b3);
        mma_16816(dk_acc[2 * dp], sa, b0, b1);
        mma_16816(dk_acc[2 * dp + 1], sa, b2, b3);
      }
    }
  }

  store_acc_bf16(dv + base, dv_acc, j_lo, j_hi, N, t, 1.0f);
  store_acc_bf16(dk + base, dk_acc, j_lo, j_hi, N, t, scale);
}

// One block owns MQ query rows (a warp 16 of them) and loops over key tiles:
// s = q k^T, dp = do v^T, dq += ds k.
__global__ void __launch_bounds__(MTHREADS)
flash_d32_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ di,
                            __nv_bfloat16* __restrict__ dq, int N,
                            int n_qtiles, float scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[MK * MS];
  __shared__ __align__(16) __nv_bfloat16 Vs[MK * MS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x / n_qtiles;
  const int row0 = (blockIdx.x % n_qtiles) * MQ + warp * 16;
  const size_t base = (size_t)bh * N * FD;
  const size_t rbase = (size_t)bh * N;
  const int r_lo = row0 + g;
  const int r_hi = row0 + g + 8;
  const int rc_lo = min(r_lo, N - 1);
  const int rc_hi = min(r_hi, N - 1);
  const float qscale = scale * LOG2E;

  uint32_t qa[2][4], da[2][4];
  load_a_frags(q + base + (size_t)rc_lo * FD, q + base + (size_t)rc_hi * FD, t, qa);
  load_a_frags(dout + base + (size_t)rc_lo * FD, dout + base + (size_t)rc_hi * FD,
               t, da);
  const float l_lo = lse[rbase + rc_lo] * LOG2E;
  const float l_hi = lse[rbase + rc_hi] * LOG2E;
  const float i_lo = di[rbase + rc_lo];
  const float i_hi = di[rbase + rc_hi];

  float acc[4][4];
#pragma unroll
  for (int dt = 0; dt < 4; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.0f;

  const uint32_t ks_addr = ldmatrix_lane_addr(Ks, lane);

  for (int k0 = 0; k0 < N; k0 += MK) {
    const int kv = min(MK, N - k0);
    __syncthreads();  // the previous tile is no longer being read
    load_tile_bf16(k + base + (size_t)k0 * FD, kv, Ks, tid);
    load_tile_bf16(v + base + (size_t)k0 * FD, kv, Vs, tid);
    __syncthreads();

    // s = q k^T and dp = do v^T: 8 tiles of 8 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.0f;
      const __nv_bfloat16* kr = Ks + (nt * 8 + g) * MS + 2 * t;
      const __nv_bfloat16* vr = Vs + (nt * 8 + g) * MS + 2 * t;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        mma_16816(s[nt], qa[ks],
                  *reinterpret_cast<const uint32_t*>(kr + 16 * ks),
                  *reinterpret_cast<const uint32_t*>(kr + 16 * ks + 8));
        mma_16816(dp[nt], da[ks],
                  *reinterpret_cast<const uint32_t*>(vr + 16 * ks),
                  *reinterpret_cast<const uint32_t*>(vr + 16 * ks + 8));
      }
    }

    // s becomes ds = p * (dp - di)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float p0 = exp2f(s[nt][0] * qscale - l_lo);
      float p1 = exp2f(s[nt][1] * qscale - l_lo);
      float p2 = exp2f(s[nt][2] * qscale - l_hi);
      float p3 = exp2f(s[nt][3] * qscale - l_hi);
      if (kv < MK) {  // ragged last tile: keys beyond N have p = 0 exactly
        const int key = nt * 8 + 2 * t;
        if (key >= kv) p0 = p2 = 0.0f;
        if (key + 1 >= kv) p1 = p3 = 0.0f;
      }
      s[nt][0] = p0 * (dp[nt][0] - i_lo);
      s[nt][1] = p1 * (dp[nt][1] - i_lo);
      s[nt][2] = p2 * (dp[nt][2] - i_hi);
      s[nt][3] = p3 * (dp[nt][3] - i_hi);
    }

    // dq += ds k: 4 steps of 16 keys, 4 tiles of 8 head columns
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t sa[4];
      sa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      sa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      sa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      sa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dpair = 0; dpair < 2; ++dpair) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(ks_addr, kk * 16, dpair * 16, b0, b1, b2, b3);
        mma_16816(acc[2 * dpair], sa, b0, b1);
        mma_16816(acc[2 * dpair + 1], sa, b2, b3);
      }
    }
  }

  store_acc_bf16(dq + base, acc, r_lo, r_hi, N, t, scale);
}

// --------------------------------------------------------------- host side

// q, k, v, o, dout: (BH, N, 32) of one type; lse: (BH, N) float32 from the
// training forward; di: (BH, N) float32 scratch, written here; dq, dk, dv:
// (BH, N, 32) in the inputs' type.
extern "C" int flash_d32_backward(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* di, void* dq, void* dk,
                                  void* dv, int BH, int N, float scale,
                                  int is_bf16, void* stream) {
  if (BH <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)BH * N;
  const int tile = is_bf16 ? MQ : FQ;
  const int n_tiles = (N + tile - 1) / tile;
  const long long blocks = (long long)BH * n_tiles;
  if (rows > 2147483647LL || blocks > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const unsigned di_blocks = (unsigned)((rows + 255) / 256);
  cudaStream_t s = (cudaStream_t)stream;
  const float* lse_f = (const float*)lse;
  float* di_f = (float*)di;
  if (is_bf16) {
    const __nv_bfloat16* qb = (const __nv_bfloat16*)q;
    const __nv_bfloat16* kb = (const __nv_bfloat16*)k;
    const __nv_bfloat16* vb = (const __nv_bfloat16*)v;
    const __nv_bfloat16* db = (const __nv_bfloat16*)dout;
    flash_d32_di_kernel<__nv_bfloat16><<<di_blocks, 256, 0, s>>>(
        (const __nv_bfloat16*)o, db, di_f, (int)rows);
    flash_d32_bwd_dkv_mma_kernel<<<(unsigned)blocks, MTHREADS, 0, s>>>(
        qb, kb, vb, db, lse_f, di_f, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, N,
        n_tiles, scale);
    flash_d32_bwd_dq_mma_kernel<<<(unsigned)blocks, MTHREADS, 0, s>>>(
        qb, kb, vb, db, lse_f, di_f, (__nv_bfloat16*)dq, N, n_tiles, scale);
  } else {
    const float* qf = (const float*)q;
    const float* kf = (const float*)k;
    const float* vf = (const float*)v;
    const float* df = (const float*)dout;
    flash_d32_di_kernel<float><<<di_blocks, 256, 0, s>>>(
        (const float*)o, df, di_f, (int)rows);
    flash_d32_bwd_dkv_kernel<<<(unsigned)blocks, FQ, 0, s>>>(
        qf, kf, vf, df, lse_f, di_f, (float*)dk, (float*)dv, N, n_tiles, scale);
    flash_d32_bwd_dq_kernel<<<(unsigned)blocks, FQ, 0, s>>>(
        qf, kf, vf, df, lse_f, di_f, (float*)dq, N, n_tiles, scale);
  }
  // a refused launch is sticky until read: one read covers all three
  return (int)cudaGetLastError();
}
