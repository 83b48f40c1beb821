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
// kernels: a template flag adds the one store, so the residual-free
// instance is the code it was.
//
// Bound by operations (4*N*N*32 FLOP per head against 4*N*32 elements
// moved).  A block cannot hold a whole K/V panel as the TPU's VMEM did, so
// both kernels below stream K/V through shared memory in tiles of 64 keys
// with a running max and sum (exp2f; scale*log2(e) is applied in float32
// inside the kernel — the TPU code rounds the scaled q to q's own type, these
// kernels do not), and normalise the output once at the end.  Keys beyond N
// are masked by index (their score is -inf); rows beyond N are computed on a
// clamped row and not stored.
//
//  * bfloat16 (the type the serving path runs): flash_d32_mma_kernel, on the
//    tensor cores with mma.sync.m16n8k16.  One warp owns 16 query rows, a
//    block of 4 warps 64; q stays in registers as A fragments; S = q k^T is
//    accumulated in float32 registers, scaled, soft-maxed per row across the
//    quad that shares the row, rounded to bfloat16 and fed back as the A
//    operand of P v (the accumulator layout of two neighbouring 8-key tiles
//    IS an A fragment); V's B fragments come from ldmatrix.trans.  Shared
//    rows are padded from 32 to 40 values so that both the 32-bit K reads
//    and ldmatrix are free of bank conflicts.
//  * float32: flash_d32_kernel, on the CUDA cores.  One block of 128 threads
//    owns 128 query rows: each thread keeps its query row and its 32-wide
//    accumulator in registers; every thread reads the same K/V row at a
//    time, so shared-memory reads are broadcasts; scores are taken 16 keys
//    at a time, so the accumulator is rescaled once per 16 keys.
#include "flash_common.cuh"

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

// ------------------------------------------------------------ tensor cores

template <bool WRITE_LSE>
__global__ void __launch_bounds__(MTHREADS)
flash_d32_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int N, int n_qtiles, float qscale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[MK * MS];
  __shared__ __align__(16) __nv_bfloat16 Vs[MK * MS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;      // row of the quad inside the 16-row tile
  const int t = lane & 3;       // position inside the quad
  const int bh = blockIdx.x / n_qtiles;
  const int row0 = (blockIdx.x % n_qtiles) * MQ + warp * 16;
  const size_t base = (size_t)bh * N * FD;
  const int r_lo = row0 + g;
  const int r_hi = row0 + g + 8;

  // q as A fragments, two k-steps of 16 over the head dimension
  uint32_t qa[2][4];
  load_a_frags(q + base + (size_t)min(r_lo, N - 1) * FD,
               q + base + (size_t)min(r_hi, N - 1) * FD, t, qa);

  float acc[4][4];              // o: 4 tiles of 8 head columns
#pragma unroll
  for (int dt = 0; dt < 4; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.0f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.0f, l_hi = 0.0f;

  const uint32_t vs_addr = ldmatrix_lane_addr(Vs, lane);

  for (int k0 = 0; k0 < N; k0 += MK) {
    const int kv = min(MK, N - k0);
    __syncthreads();  // the previous tile is no longer being read
    load_tile_bf16(k + base + (size_t)k0 * FD, kv, Ks, tid);
    load_tile_bf16(v + base + (size_t)k0 * FD, kv, Vs, tid);
    __syncthreads();

    // s = q k^T: 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      const __nv_bfloat16* kr = Ks + (nt * 8 + g) * MS + 2 * t;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + 16 * ks);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 16 * ks + 8);
        mma_16816(s[nt], qa[ks], b0, b1);
      }
    }

    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] *= qscale;
      if (kv < MK) {  // ragged last tile: mask keys beyond N by index
        const int key = nt * 8 + 2 * t;
        if (key >= kv) s[nt][0] = s[nt][2] = -INFINITY;
        if (key + 1 >= kv) s[nt][1] = s[nt][3] = -INFINITY;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
    // a row's 64 scores live in the 4 lanes of its quad
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    // key k0 is always valid, so the new maxima are finite
    const float mn_lo = fmaxf(m_lo, mx_lo);
    const float mn_hi = fmaxf(m_hi, mx_hi);
    const float c_lo = exp2f(m_lo - mn_lo);
    const float c_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= c_lo;
    l_hi *= c_hi;
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      acc[dt][0] *= c_lo;
      acc[dt][1] *= c_lo;
      acc[dt][2] *= c_hi;
      acc[dt][3] *= c_hi;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn_lo);
      s[nt][1] = exp2f(s[nt][1] - mn_lo);
      s[nt][2] = exp2f(s[nt][2] - mn_hi);
      s[nt][3] = exp2f(s[nt][3] - mn_hi);
      l_lo += s[nt][0] + s[nt][1];   // this lane's columns; the quad's
      l_hi += s[nt][2] + s[nt][3];   // partial sums are added at the end
    }

    // o += p v: 4 steps of 16 keys, 4 tiles of 8 head columns
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(vs_addr, kk * 16, dp * 16, b0, b1, b2, b3);
        mma_16816(acc[2 * dp], pa, b0, b1);
        mma_16816(acc[2 * dp + 1], pa, b2, b3);
      }
    }
  }

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.0f / l_lo;
  const float inv_hi = 1.0f / l_hi;
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
    if (r_lo < N) {
      *reinterpret_cast<uint32_t*>(o + base + (size_t)r_lo * FD + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][0] * inv_lo, acc[dt][1] * inv_lo);
    }
    if (r_hi < N) {
      *reinterpret_cast<uint32_t*>(o + base + (size_t)r_hi * FD + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2] * inv_hi, acc[dt][3] * inv_hi);
    }
  }
  if (WRITE_LSE && t == 0) {  // one lane of the quad that shares the row
    if (r_lo < N) lse[(size_t)bh * N + r_lo] = (m_lo + log2f(l_lo)) * LN2;
    if (r_hi < N) lse[(size_t)bh * N + r_hi] = (m_hi + log2f(l_hi)) * LN2;
  }
}

template <bool WRITE_LSE>
static int launch_forward(const void* q, const void* k, const void* v, void* o,
                          float* lse, int BH, int N, float scale, int is_bf16,
                          void* stream) {
  if (BH <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const int rows = is_bf16 ? MQ : FQ;
  const int n_qtiles = (N + rows - 1) / rows;
  const long long blocks = (long long)BH * n_qtiles;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const float qscale = scale * LOG2E;  // fold log2(e): exp2f in the kernels
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    flash_d32_mma_kernel<WRITE_LSE><<<(unsigned)blocks, MTHREADS, 0, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)o, lse, N, n_qtiles, qscale);
  } else {
    flash_d32_kernel<WRITE_LSE><<<(unsigned)blocks, FQ, 0, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, N,
        n_qtiles, qscale);
  }
  return (int)cudaGetLastError();
}

extern "C" int flash_d32_forward(const void* q, const void* k, const void* v,
                                 void* o, int BH, int N, float scale,
                                 int is_bf16, void* stream) {
  return launch_forward<false>(q, k, v, o, nullptr, BH, N, scale, is_bf16,
                               stream);
}

// The training forward: the same output plus lse (BH, N), float32.
extern "C" int flash_d32_forward_lse(const void* q, const void* k,
                                     const void* v, void* o, void* lse, int BH,
                                     int N, float scale, int is_bf16,
                                     void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return launch_forward<true>(q, k, v, o, (float*)lse, BH, N, scale, is_bf16,
                              stream);
}
