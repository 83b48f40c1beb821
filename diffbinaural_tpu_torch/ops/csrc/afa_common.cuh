// Shared device code of the alias-free snake activation (used by
// alias_free_act.cu, alias_free_act_bwd.cu and snake_conv.cu).
//
//   y_e[t] = 2 * sum_{i=0..5} h[11-2i] * x[t-3+i]        (up-FIR, even phase)
//   y_o[t] = 2 * sum_{i=0..5} h[10-2i] * x[t-2+i]        (up-FIR, odd phase)
//   mid[n] = y[n] + sin^2(alpha*y[n]) * inv_beta         (2x-rate lattice)
//   z[t]   = sum_{r=0..5} h[2r+1]*mid[2(t+r-2)] + h[2r]*mid[2(t+r-3)+1]
//
// Edge semantics are those of the unfused composition (replicate-pad x,
// up-FIR, snake, replicate-pad the 2x-rate signal, down-FIR): the index of x
// is clamped to [0, T-1] AND the lattice index n is clamped to [0, 2T-1].
// All arithmetic is float32.  The shared-memory helpers below (afa_stage_x,
// afa_mid; the earlier kernels kept as yardsticks under csrc_variants/) use
// the exact sinf; the register-blocked code at the end of the file (K2, K2b
// and both K3 activations) uses a range-reduced hardware sine (afa_sin2,
// afa_sincos_pi).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// z at local output index i (t = t0 + i) from the lattice buffers.
__device__ __forceinline__ float afa_down(const float* me, const float* mo,
                                          int i) {
  const float* e = me + i;
  const float* o = mo + i;
  return AFA_H1 * e[0] + AFA_H0 * o[0] + AFA_H3 * e[1] + AFA_H2 * o[1] +
         AFA_H5 * e[2] + AFA_H4 * o[2] + AFA_H7 * e[3] + AFA_H6 * o[3] +
         AFA_H9 * e[4] + AFA_H8 * o[4] + AFA_H11 * e[5] + AFA_H10 * o[5];
}

// --------------------------------------------- register-blocked kernels

// The snake needs sin^2(u) (forward) and sin(2u) (backward), both of period
// pi, so u is reduced by the nearest multiple of pi (two-constant
// Cody-Waite) to [-pi/2, pi/2], where the hardware sine's absolute error is
// below 2^-20.9; the reduction itself is exact to ~1e-7 of u's last bit for
// |u| < 1e4.  An absolute error of 1e-6 in mid moves z by less than that
// (the down-FIR's taps sum to 1).
__device__ __forceinline__ float afa_reduce_pi(float u) {
  const float k = rintf(u * 0.318309886183790672f);
  const float r = fmaf(-k, 3.14159274101257324f, u);   // float(pi)
  return fmaf(-k, -8.74227766e-08f, r);                // pi - float(pi)
}
__device__ __forceinline__ float afa_sin2(float u) {
  const float s = __sinf(afa_reduce_pi(u));
  return s * s;
}
// sin(u) and cos(u), both times the same sign (-1)^k: exact for the
// products s * s and s * c (= sin(2u) / 2), both of period pi.
__device__ __forceinline__ void afa_sincos_pi(float u, float* s, float* c) {
  __sincosf(afa_reduce_pi(u), s, c);
}

// mid from the up-FIR of six consecutive x values (even phase: p[i] =
// x[m-3+i] for lattice point 2m; odd phase: p[i] = x[m-2+i] for 2m+1).
__device__ __forceinline__ float afa_snake(float y, float a, float ib) {
  y *= 2.0f;
  return fmaf(ib, afa_sin2(a * y), y);
}
__device__ __forceinline__ float afa_mid_even(const float* p, float a,
                                              float ib) {
  return afa_snake(AFA_H11 * p[0] + AFA_H9 * p[1] + AFA_H7 * p[2] +
                       AFA_H5 * p[3] + AFA_H3 * p[4] + AFA_H1 * p[5],
                   a, ib);
}
__device__ __forceinline__ float afa_mid_odd(const float* p, float a,
                                             float ib) {
  return afa_snake(AFA_H10 * p[0] + AFA_H8 * p[1] + AFA_H6 * p[2] +
                       AFA_H4 * p[3] + AFA_H2 * p[4] + AFA_H0 * p[5],
                   a, ib);
}

// mid at lattice index n of a row read straight from device memory; CLAMP
// clamps n to [0, 2T-1] and the x index to [0, T-1] (edge tiles), without
// it every index must lie inside the row (interior tiles).
template <bool CLAMP, typename T>
__device__ __forceinline__ float afa_mid_row(const T* __restrict__ row,
                                             int T_len, int n, float a,
                                             float ib) {
  if (CLAMP) n = afa_clamp(n, 0, 2 * T_len - 1);
  const int odd = n & 1;
  const int base = (n >> 1) - 3 + odd;
  float p[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int t = CLAMP ? afa_clamp(base + i, 0, T_len - 1) : base + i;
    p[i] = afa_to_float(row[t]);
  }
  return odd ? afa_mid_odd(p, a, ib) : afa_mid_even(p, a, ib);
}

// R consecutive outputs z[t0 .. t0+R) of one row from the x window
// xw[p] = x[clamp(t0 - 5 + p)], p < R + 10, all in registers: the lattice
// me[q] = mid[2(t0-2+q)], mo[q] = mid[2(t0-3+q)+1] (q < R + 5; the five
// extra points per phase are the halo, recomputed by the neighbouring run),
// then the down-FIR.  EDGE applies the lattice clamp: a point below 0 takes
// mid0 = mid[0] and one above 2T-1 takes mid_last = mid[2T-1] (the window's
// x clamp already holds for the rest).
template <int R, bool EDGE>
__device__ __forceinline__ void afa_run(const float* xw, int t0, int T_len,
                                        float a, float ib, float mid0,
                                        float mid_last, float* z) {
  float me[R + 5], mo[R + 5];
#pragma unroll
  for (int q = 0; q < R + 5; ++q) {
    me[q] = afa_mid_even(xw + q, a, ib);
    mo[q] = afa_mid_odd(xw + q, a, ib);
    if (EDGE) {
      const int m_e = t0 - 2 + q, m_o = t0 - 3 + q;
      me[q] = m_e < 0 ? mid0 : (m_e >= T_len ? mid_last : me[q]);
      mo[q] = m_o < 0 ? mid0 : (m_o >= T_len ? mid_last : mo[q]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) z[i] = afa_down(me, mo, i);
}

// ------------------------------------------------------ 16-byte vectors

// 8 consecutive values as float from a 16-byte aligned address.
__device__ __forceinline__ void afa_load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void afa_load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void afa_store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void afa_store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
