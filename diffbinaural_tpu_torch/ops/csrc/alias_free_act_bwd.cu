// Fused alias-free snake activation, backward: from x and dz = dL/dz of
//   z = down2(snake(up2(x)))      (afa_common.cuh)
// compute dx (x's type) and per-channel partial sums of d alpha and d beta
// (float32), on (B, C, T).
//
// Replaces the Pallas kernels _bwd_kernel_mxu / _bwd_kernel of
// diffbinaural_tpu/ops/alias_free_act.py (_fused_backward).
//
// Bound by bytes: x and dz read once, dx written once (3 * B*C*T elements)
// against ~90 float32 operations and two hardware sines per sample.  The
// design is the forward's (K2, alias_free_act.cu), register-blocked: thread
// i owns the AFB_RUN = 8 consecutive outputs dx[t0, t0 + AFB_RUN) of one row
// (runs stay inside a row, so that a thread's d alpha / d beta terms belong
// to one channel; a row's last run may be short).  It loads its x and dz
// windows [t0 - 6, t0 + AFB_RUN + 6) into registers — in a run whose
// windows lie inside the row and whose row starts on a 16-byte boundary
// (T % 8 == 0), as aligned 16-byte vectors, the halo chunks
// coming from L1 as the neighbours' — then recomputes in registers the
// 2x-rate lattice's pre-snake values y, the adjoint down-FIR d mid, the
// snake's derivatives (sin^2(a y) and sin(2 a y) from one range-reduced
// hardware sincos, afa_sincos_pi: both have period pi in a y) and the
// adjoint up-FIR: AFB_RUN + 5 lattice points per phase for AFB_RUN outputs.
// No shared memory and no block barrier.
//
// Edges are the exact adjoint of the forward's composition: the forward
// clamps the index of x to [0, T-1] (replicate pad by 5) and the lattice
// index to [0, 2T-1] (the down-FIR's replicate pad), so the backward
// scatters every pad position's contribution back onto lattice point 0 /
// 2T-1 (before the snake derivative) and onto sample 0 / T-1 of x.  Only the
// runs that touch a row's first or last 6 samples (or rows with T % 8 != 0)
// take that path (afb_run<.., true>): clamped scalar loads, lattice points
// outside [0, T) zeroed by selects, the scatters from three samples of dz
// at each end.  (Edge runs that clamp the interior's vectors by selection
// instead kept 148 registers live against 112 in runs of 16, one block per
// SM instead of two, and ran K2b 40-70 % slower: PERF.md.)
//
// d alpha / d beta: the run that owns output sample t owns lattice points
// 2t and 2t+1, so each lattice point is counted once.  A warp's 32 runs may
// cover several rows: a segmented suffix sum over the warp's shuffles (rows
// are nondecreasing along the lanes) leaves each row's sum in its first
// lane, which writes it to the row's slot of that warp.  The wrapper sums
// the slots in a fixed order: no atomics, the same bits in every run.
#include "afa_common.cuh"

constexpr int AFB_RUN = 8;       // consecutive dx outputs per thread
constexpr int AFB_THREADS = 256;
constexpr int AFB_W = AFB_RUN + 12;  // x and dz windows [t0 - 6, t0 + RUN + 6)

// The six-tap sums of both phases (afa_common.cuh's up-FIR, and the
// adjoint down-FIR, which has the same taps on the same window offsets).
__device__ __forceinline__ float afb_even6(const float* p) {
  return AFA_H11 * p[0] + AFA_H9 * p[1] + AFA_H7 * p[2] + AFA_H5 * p[3] +
         AFA_H3 * p[4] + AFA_H1 * p[5];
}
__device__ __forceinline__ float afb_odd6(const float* p) {
  return AFA_H10 * p[0] + AFA_H8 * p[1] + AFA_H6 * p[2] + AFA_H4 * p[3] +
         AFA_H2 * p[4] + AFA_H0 * p[5];
}

// d y at one lattice point from its pre-snake value y (the up-FIR's gain of
// 2 applied) and d mid; an owned point adds its d alpha and d beta terms
// (mid = y + ib sin^2(a y): d/dy = 1 + a ib sin(2 a y), d/da = ib y
// sin(2 a y), d/d ib = sin^2(a y), and d ib / d beta = -ib^2).
__device__ __forceinline__ float afb_point(float y, float dm, float a, float ib,
                                           bool own, float& pa, float& pb) {
  float s, c;
  afa_sincos_pi(a * y, &s, &c);
  const float s2 = 2.0f * s * c;
  if (own) {
    pa = fmaf(dm * y, s2 * ib, pa);
    pb = fmaf(-dm * ib * ib, s * s, pb);
  }
  return dm * fmaf(a * ib, s2, 1.0f);
}

// dx[t0 + u], u < R, of one row from xw[p] = x[clamp(t0 - 6 + p)] and
// dw[p] = dz[t0 - 6 + p] (0 outside the row), p < R + 12.  Lattice point
// m = t0 - 3 + q: E[q] = d y at 2m (q in [1, R + 5]), O[q] = d y at 2m + 1
// (q in [0, R + 4]); the run owns q in [3, R + 3).  EDGE: points outside
// [0, T) are zero, scat_lo / scat_hi (the down-FIR's pad positions) join
// d mid at lattice points 0 / 2T-1, and the up-FIR's pad positions join
// dx[0] / dx[T-1].
template <int R, bool EDGE>
__device__ __forceinline__ void afb_run(const float* xw, const float* dw,
                                        int t0, int T_len, float a, float ib,
                                        float scat_lo, float scat_hi,
                                        float* dx, float& pa, float& pb) {
  float E[R + 6], O[R + 6];
  E[0] = 0.0f;
  O[R + 5] = 0.0f;
#pragma unroll
  for (int q = 0; q < R + 6; ++q) {
    const int m = t0 - 3 + q;
    const bool valid = !EDGE || (m >= 0 && m < T_len);
    const bool own = q >= 3 && q < R + 3 && valid;
    if (q >= 1) {
      float dm = afb_even6(dw + q);
      if (EDGE && m == 0) dm += scat_lo;
      const float v = afb_point(2.0f * afb_even6(xw + q), dm, a, ib, own, pa, pb);
      E[q] = valid ? v : 0.0f;
    }
    if (q <= R + 4) {
      float dm = afb_odd6(dw + q + 1);
      if (EDGE && m == T_len - 1) dm += scat_hi;
      const float v = afb_point(2.0f * afb_odd6(xw + q + 1), dm, a, ib, own, pa, pb);
      O[q] = valid ? v : 0.0f;
    }
  }
#pragma unroll
  for (int u = 0; u < R; ++u) {
    dx[u] = 2.0f * (AFA_H11 * E[u + 6] + AFA_H9 * E[u + 5] + AFA_H7 * E[u + 4] +
                    AFA_H5 * E[u + 3] + AFA_H3 * E[u + 2] + AFA_H1 * E[u + 1] +
                    AFA_H10 * O[u + 5] + AFA_H8 * O[u + 4] + AFA_H6 * O[u + 3] +
                    AFA_H4 * O[u + 2] + AFA_H2 * O[u + 1] + AFA_H0 * O[u]);
  }
  if (EDGE) {
    // x's pad positions -3 .. -1 read lattice points 0 .. 2 (at q = 3 .. 5
    // when t0 == 0), positions T .. T+2 read T-3 .. T-1
    if (t0 == 0) {
      dx[0] += 2.0f * ((AFA_H7 + AFA_H9 + AFA_H11) * E[3] +
                       (AFA_H9 + AFA_H11) * E[4] + AFA_H11 * E[5] +
                       (AFA_H8 + AFA_H10) * O[3] + AFA_H10 * O[4]);
    }
    float hi = 0.0f;
#pragma unroll
    for (int q = 0; q < R + 6; ++q) {
      const int k = T_len - 1 - (t0 - 3 + q);  // 0 at lattice point T-1
      const float ce = k == 0 ? AFA_H3 + AFA_H1 : (k == 1 ? AFA_H1 : 0.0f);
      const float co = k == 0 ? AFA_H4 + AFA_H2 + AFA_H0
                              : (k == 1 ? AFA_H2 + AFA_H0 : (k == 2 ? AFA_H0 : 0.0f));
      hi = fmaf(ce, E[q], fmaf(co, O[q], hi));
    }
#pragma unroll
    for (int u = 0; u < R; ++u)
      if (t0 + u == T_len - 1) dx[u] += 2.0f * hi;
  }
}

template <typename T>
__device__ __forceinline__ float afb_at(const T* row, int t, int T_len) {
  return (t >= 0 && t < T_len) ? afa_to_float(row[t]) : 0.0f;
}

// At most 64 registers, so that four blocks share an SM: the kernel waits on
// its loads and its sines, and more warps hide them (runs of 8 under this
// cap against runs of 16 at 112 registers, two blocks per SM: 0.040-0.060
// ms against 0.036-0.074 at the stage-2 shapes, PERF.md).
template <typename T>
__global__ void __launch_bounds__(AFB_THREADS, 4)
afa_snake_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dz,
                     const float* __restrict__ alpha,
                     const float* __restrict__ inv_beta, T* __restrict__ dx,
                     float* __restrict__ da_part, float* __restrict__ db_part,
                     int B, int C, int T_len, int runs_per_row, int n_runs,
                     int n_pieces) {
  const int g = blockIdx.x * AFB_THREADS + threadIdx.x;  // this thread's run
  const bool active = g < n_runs;
  const int row = active ? g / runs_per_row : 0x7fffffff;  // b * C + c
  float pa = 0.0f, pb = 0.0f;
  if (active) {
    const int t0 = (g - row * runs_per_row) * AFB_RUN;
    const int c = row % C;
    const float a = alpha[c], ib = inv_beta[c];
    const size_t off = (size_t)row * T_len;
    float out[AFB_RUN];
    if ((T_len & 7) == 0 && t0 >= 6 && t0 + AFB_RUN + 6 <= T_len) {
      // interior: x and dz [t0 - 8, t0 + RUN + 8) in aligned vectors
      float xv[AFB_RUN + 16], dv[AFB_RUN + 16];
#pragma unroll
      for (int i = 0; i < AFB_RUN + 16; i += 8) {
        afa_load8(x + off + t0 - 8 + i, xv + i);
        afa_load8(dz + off + t0 - 8 + i, dv + i);
      }
      afb_run<AFB_RUN, false>(xv + 2, dv + 2, t0, T_len, a, ib, 0.0f, 0.0f,
                              out, pa, pb);
#pragma unroll
      for (int i = 0; i < AFB_RUN; i += 8) afa_store8(dx + off + t0 + i, out + i);
    } else {
      const T* xrow = x + off;
      const T* dzrow = dz + off;
      float xw[AFB_W], dw[AFB_W];
#pragma unroll
      for (int p = 0; p < AFB_W; ++p) {
        const int t = t0 - 6 + p;
        xw[p] = afa_to_float(xrow[afa_clamp(t, 0, T_len - 1)]);
        dw[p] = afb_at(dzrow, t, T_len);
      }
      // the down-FIR's pad positions below 0 / from 2T: the dz samples that
      // reached them, with the sums of the taps that did
      const float scat_lo =
          (AFA_H0 + AFA_H1 + AFA_H2 + AFA_H3 + AFA_H4) * afb_at(dzrow, 0, T_len) +
          (AFA_H0 + AFA_H1 + AFA_H2) * afb_at(dzrow, 1, T_len) +
          AFA_H0 * afb_at(dzrow, 2, T_len);
      const float scat_hi =
          (AFA_H7 + AFA_H8 + AFA_H9 + AFA_H10 + AFA_H11) *
              afb_at(dzrow, T_len - 1, T_len) +
          (AFA_H9 + AFA_H10 + AFA_H11) * afb_at(dzrow, T_len - 2, T_len) +
          AFA_H11 * afb_at(dzrow, T_len - 3, T_len);
      afb_run<AFB_RUN, true>(xw, dw, t0, T_len, a, ib, scat_lo, scat_hi, out,
                             pa, pb);
#pragma unroll
      for (int u = 0; u < AFB_RUN; ++u)
        if (t0 + u < T_len) afa_store(dx + off + t0 + u, out[u]);
    }
  }
  // d alpha / d beta: segmented suffix sums over the warp (rows are
  // nondecreasing along the lanes; idle lanes carry a row of their own)
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float oa = __shfl_down_sync(0xffffffffu, pa, d);
    const float ob = __shfl_down_sync(0xffffffffu, pb, d);
    const int orow = __shfl_down_sync(0xffffffffu, row, d);
    if (lane + d < 32 && orow == row) {
      pa += oa;
      pb += ob;
    }
  }
  const int prev = __shfl_up_sync(0xffffffffu, row, 1);
  if (active && (lane == 0 || prev != row)) {
    // the row's slot for this warp (warps from the one holding its first
    // run), channel-major so that the wrapper's sum is over the last axis
    const int piece = (g >> 5) - ((row * runs_per_row) >> 5);
    const size_t slot = ((size_t)(row % C) * B + row / C) * n_pieces + piece;
    da_part[slot] = pa;
    db_part[slot] = pb;
  }
}

// x, dz, dx: (B, C, T) contiguous, one type, 16-byte aligned; alpha,
// inv_beta: (C,) float32; da_part, db_part: (C, B, n_pieces) float32 with
// n_pieces = ceil(runs_per_row / 32) + 1, runs_per_row = ceil(T / AFB_RUN),
// zero-filled by the caller (a row's slots beyond the warps it spans stay 0).
extern "C" int afa_snake_backward(const void* x, const void* dz,
                                  const void* alpha, const void* inv_beta,
                                  void* dx, void* da_part, void* db_part,
                                  int B, int C, int T_len, int n_pieces,
                                  int is_bf16, void* stream) {
  if (B <= 0 || C <= 0 || T_len <= 0) return (int)cudaErrorInvalidValue;
  const int runs_per_row = (T_len + AFB_RUN - 1) / AFB_RUN;
  if (n_pieces != (runs_per_row + 31) / 32 + 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * C;
  const long long n_runs = rows * runs_per_row;
  // flat int indices: runs, and row * runs_per_row for the slot
  if (n_runs > 2147483647LL - AFB_THREADS)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)dz | (uintptr_t)dx) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int blocks = (int)((n_runs + AFB_THREADS - 1) / AFB_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    afa_snake_bwd_kernel<__nv_bfloat16><<<blocks, AFB_THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)dz, (const float*)alpha,
        (const float*)inv_beta, (__nv_bfloat16*)dx, (float*)da_part,
        (float*)db_part, B, C, T_len, runs_per_row, (int)n_runs, n_pieces);
  } else {
    afa_snake_bwd_kernel<float><<<blocks, AFB_THREADS, 0, s>>>(
        (const float*)x, (const float*)dz, (const float*)alpha,
        (const float*)inv_beta, (float*)dx, (float*)da_part, (float*)db_part,
        B, C, T_len, runs_per_row, (int)n_runs, n_pieces);
  }
  return (int)cudaGetLastError();
}
