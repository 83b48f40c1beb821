// The float32 attention kernels on the CUDA cores, one thread per query row
// or key: the forward (and training forward) and the two backward kernels
// that the float32 path ran before it moved to split-TF32 products on wgmma
// (csrc/flash_d32_f32.cu, csrc/flash_d32_f32_bwd.cu).  Kept, and built beside
// the shipped kernels, as their yardstick: ops/flash_d32_variants.py builds
// this file and chip_smoke.py times it in the shipped wrappers' place
// (``cuda_core_ms``).  The port never calls it.  It exports the shipped float32
// libraries' C functions under the same names (the scratch is not read), so
// one library takes the place of both.
//
// The forward: one block of 128 threads owns 128 query rows; each thread
// keeps its query row and its 32-wide accumulator in registers; every thread
// reads the same K/V row at a time, so shared-memory reads are broadcasts;
// scores are taken 16 keys at a time, so the accumulator is rescaled once per
// 16 keys.  The backward: a block owns 128 keys (dk, dv) or 128 query rows
// (dq), one per thread, with its rows and accumulators in registers, and
// loops over tiles of the other side in shared memory; the scale is applied
// inside on the unscaled q, and rows and keys beyond N add nothing.
#include "flash_common.cuh"

constexpr int FQ = 128;       // float32: rows per block (one per thread)
constexpr int FK = 64;        // float32: rows per shared-memory tile

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

// ------------------------------------------------------------ forward

constexpr int FC = 16;        // keys per online-softmax step

template <bool WRITE_LSE>
__global__ void __launch_bounds__(FQ)
flash_d32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int N, int n_qtiles, float qscale) {
  __shared__ __align__(16) float Ks[FK * FD];
  __shared__ __align__(16) float Vs[FK * FD];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / n_qtiles;
  const int row = (blockIdx.x % n_qtiles) * FQ + tid;
  const size_t base = (size_t)bh * N * FD;
  const int rowc = min(row, N - 1);

  float qr[FD], acc[FD];
#pragma unroll
  for (int d = 0; d < FD; d += 8) load8(q + base + (size_t)rowc * FD + d, qr + d);
#pragma unroll
  for (int d = 0; d < FD; ++d) {
    qr[d] *= qscale;
    acc[d] = 0.0f;
  }
  float m = -INFINITY, l = 0.0f;

  for (int k0 = 0; k0 < N; k0 += FK) {
    const int kv = min(FK, N - k0);
    __syncthreads();  // the previous tile is no longer being read
    load_tile(k + base + (size_t)k0 * FD, kv, Ks, tid);
    load_tile(v + base + (size_t)k0 * FD, kv, Vs, tid);
    __syncthreads();

    for (int j0 = 0; j0 < kv; j0 += FC) {
      float s[FC];
#pragma unroll
      for (int jj = 0; jj < FC; ++jj) {
        const float4* kr = reinterpret_cast<const float4*>(Ks + (j0 + jj) * FD);
        float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
        for (int d4 = 0; d4 < FD / 4; d4 += 2) {
          const float4 ka = kr[d4];
          const float4 kb = kr[d4 + 1];
          a0 = fmaf(qr[4 * d4 + 0], ka.x, a0);
          a0 = fmaf(qr[4 * d4 + 1], ka.y, a0);
          a0 = fmaf(qr[4 * d4 + 2], ka.z, a0);
          a0 = fmaf(qr[4 * d4 + 3], ka.w, a0);
          a1 = fmaf(qr[4 * d4 + 4], kb.x, a1);
          a1 = fmaf(qr[4 * d4 + 5], kb.y, a1);
          a1 = fmaf(qr[4 * d4 + 6], kb.z, a1);
          a1 = fmaf(qr[4 * d4 + 7], kb.w, a1);
        }
        s[jj] = (j0 + jj < kv) ? (a0 + a1) : -INFINITY;
      }
      float mc = s[0];
#pragma unroll
      for (int jj = 1; jj < FC; ++jj) mc = fmaxf(mc, s[jj]);
      // key j0 is always valid, so m_new is finite and exp2f(-inf) == 0
      const float m_new = fmaxf(m, mc);
      const float corr = exp2f(m - m_new);
      m = m_new;
      l *= corr;
#pragma unroll
      for (int d = 0; d < FD; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < FC; ++jj) {
        const float p = exp2f(s[jj] - m_new);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(Vs + (j0 + jj) * FD);
#pragma unroll
        for (int d4 = 0; d4 < FD / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
    }
  }

  if (row < N) {
    const float inv_l = 1.0f / l;
#pragma unroll
    for (int d = 0; d < FD; ++d) acc[d] *= inv_l;
#pragma unroll
    for (int d = 0; d < FD; d += 8) store8(o + base + (size_t)row * FD + d, acc + d);
    // m and l are in base 2 (scale * log2(e) is folded into q)
    if (WRITE_LSE) lse[(size_t)bh * N + row] = (m + log2f(l)) * LN2;
  }
}

// ----------------------------------------------------------- backward

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

// di[row] = sum_d o[row][d] * do[row][d], float32, one thread per row.
__global__ void __launch_bounds__(256)
flash_d32_di_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                    float* __restrict__ di, int rows) {
  const int r = blockIdx.x * 256 + threadIdx.x;
  if (r < rows) di[r] = dot32(o + (size_t)r * FD, dout + (size_t)r * FD);
}

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

// --------------------------------------------------------------- host side

template <bool WRITE_LSE>
static int launch_forward(const void* q, const void* k, const void* v, void* o,
                          float* lse, int BH, int N, float scale, void* stream) {
  if (BH <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const int n_qtiles = (N + FQ - 1) / FQ;
  const long long blocks = (long long)BH * n_qtiles;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  flash_d32_kernel<WRITE_LSE><<<(unsigned)blocks, FQ, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, N,
      n_qtiles, scale * LOG2E);
  return (int)cudaGetLastError();
}

extern "C" int flash_d32_f32_forward(const void* q, const void* k, const void* v,
                                     void* o, void* scratch, int BH, int N,
                                     float scale, void* stream) {
  return launch_forward<false>(q, k, v, o, nullptr, BH, N, scale, stream);
}

extern "C" int flash_d32_f32_forward_lse(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         void* scratch, int BH, int N,
                                         float scale, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return launch_forward<true>(q, k, v, o, (float*)lse, BH, N, scale, stream);
}

extern "C" int flash_d32_f32_backward(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout,
                                      const void* lse, void* di, void* scratch,
                                      void* dq, void* dk, void* dv, int BH, int N,
                                      float scale, void* stream) {
  if (BH <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)BH * N;
  const int n_tiles = (N + FQ - 1) / FQ;
  const long long blocks = (long long)BH * n_tiles;
  if (rows > 2147483647LL || blocks > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  const float* df = (const float*)dout;
  const float* lse_f = (const float*)lse;
  float* di_f = (float*)di;
  flash_d32_di_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(
      (const float*)o, df, di_f, (int)rows);
  flash_d32_bwd_dkv_kernel<<<(unsigned)blocks, FQ, 0, s>>>(
      qf, kf, vf, df, lse_f, di_f, (float*)dk, (float*)dv, N, n_tiles, scale);
  flash_d32_bwd_dq_kernel<<<(unsigned)blocks, FQ, 0, s>>>(
      qf, kf, vf, df, lse_f, di_f, (float*)dq, N, n_tiles, scale);
  return (int)cudaGetLastError();
}
