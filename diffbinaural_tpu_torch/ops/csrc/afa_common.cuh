// Shared device code of the alias-free snake activation (used by
// alias_free_act.cu and snake_conv.cu).
//
//   y_e[t] = 2 * sum_{i=0..5} h[11-2i] * x[t-3+i]        (up-FIR, even phase)
//   y_o[t] = 2 * sum_{i=0..5} h[10-2i] * x[t-2+i]        (up-FIR, odd phase)
//   mid[n] = y[n] + sin^2(alpha*y[n]) * inv_beta         (2x-rate lattice)
//   z[t]   = sum_{r=0..5} h[2r+1]*mid[2(t+r-2)] + h[2r]*mid[2(t+r-3)+1]
//
// Edge semantics are those of the unfused composition (replicate-pad x,
// up-FIR, snake, replicate-pad the 2x-rate signal, down-FIR): the index of x
// is clamped to [0, T-1] AND the lattice index n is clamped to [0, 2T-1].
// All arithmetic is float32 with the exact sinf.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "afa_taps.h"  // AFA_H0 .. AFA_H11, generated at build time

__device__ __forceinline__ float afa_to_float(float v) { return v; }
__device__ __forceinline__ float afa_to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void afa_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void afa_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ int afa_clamp(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Stage x[clamp(g0 + p)] for p in [0, width) into xs (float32).
template <typename T>
__device__ __forceinline__ void afa_stage_x(const T* __restrict__ row, int T_len,
                                            int g0, int width, float* xs,
                                            int tid, int nthreads) {
  for (int p = tid; p < width; p += nthreads) {
    xs[p] = afa_to_float(row[afa_clamp(g0 + p, 0, T_len - 1)]);
  }
}

// mid at lattice index n (clamped here).  xs holds x[clamp(g0 + p)] for
// p in [0, xs_width).  For every lattice point that a kept output needs, the
// six taps lie inside the staged window; the base clamp only keeps unneeded
// points (whose outputs are discarded) inside the buffer.
__device__ __forceinline__ float afa_mid(const float* xs, int g0, int xs_width,
                                         int n, int T_len, float alpha,
                                         float inv_beta) {
  const int nc = afa_clamp(n, 0, 2 * T_len - 1);
  const int tc = nc >> 1;
  float y;
  if (nc & 1) {
    const float* p = xs + afa_clamp(tc - 2 - g0, 0, xs_width - 6);
    y = AFA_H10 * p[0] + AFA_H8 * p[1] + AFA_H6 * p[2] + AFA_H4 * p[3] +
        AFA_H2 * p[4] + AFA_H0 * p[5];
  } else {
    const float* p = xs + afa_clamp(tc - 3 - g0, 0, xs_width - 6);
    y = AFA_H11 * p[0] + AFA_H9 * p[1] + AFA_H7 * p[2] + AFA_H5 * p[3] +
        AFA_H3 * p[4] + AFA_H1 * p[5];
  }
  y *= 2.0f;
  const float s = sinf(alpha * y);
  return y + inv_beta * (s * s);
}

// Fill the two lattice buffers for outputs t in [t0, t0 + width):
//   me[q] = mid[2*(t0 - 2 + q)],  mo[q] = mid[2*(t0 - 3 + q) + 1],
// q in [0, width + 5).  xs must hold x[clamp(t0 - 5 + p)], p < width + 10.
__device__ __forceinline__ void afa_fill_lattice(const float* xs, int t0,
                                                 int width, int T_len,
                                                 float alpha, float inv_beta,
                                                 float* me, float* mo, int tid,
                                                 int nthreads) {
  const int g0 = t0 - 5;
  const int xs_width = width + 10;
  const int nq = width + 5;
  for (int i = tid; i < 2 * nq; i += nthreads) {
    if (i < nq) {
      me[i] = afa_mid(xs, g0, xs_width, 2 * (t0 - 2 + i), T_len, alpha,
                      inv_beta);
    } else {
      const int q = i - nq;
      mo[q] = afa_mid(xs, g0, xs_width, 2 * (t0 - 3 + q) + 1, T_len, alpha,
                      inv_beta);
    }
  }
}

// z at local output index i (t = t0 + i) from the lattice buffers.
__device__ __forceinline__ float afa_down(const float* me, const float* mo,
                                          int i) {
  const float* e = me + i;
  const float* o = mo + i;
  return AFA_H1 * e[0] + AFA_H0 * o[0] + AFA_H3 * e[1] + AFA_H2 * o[1] +
         AFA_H5 * e[2] + AFA_H4 * o[2] + AFA_H7 * e[3] + AFA_H6 * o[3] +
         AFA_H9 * e[4] + AFA_H8 * o[4] + AFA_H11 * e[5] + AFA_H10 * o[5];
}
