// K2b's earlier, tiled design, kept as the yardstick of the shipped
// register-blocked kernel (ops/csrc/alias_free_act_bwd.cu): built and timed
// only by ops/alias_free_act_variants.py and chip_smoke.py, never called by
// the port.
//
// Fused alias-free snake activation, backward: from x and dz = dL/dz of
//   z = down2(snake(up2(x)))      (afa_common.cuh)
// compute dx (x's type) and per-channel partial sums of d alpha and d beta
// (float32, one value per (batch, time tile, channel)), on (B, C, T).
//
// Replaces the Pallas kernels _bwd_kernel_mxu / _bwd_kernel of
// diffbinaural_tpu/ops/alias_free_act.py (_fused_backward).
//
// Bound by bytes: x and dz read once, dx written once (3 * B*C*T elements)
// against ~70 FMAs and one sincos per sample.  Layout as the forward: one
// block per TILE consecutive samples of one (b, c) row, time contiguous, so
// every load and store is coalesced.  x and dz are staged with a 6-sample
// halo on each side; the snake lattice is recomputed from x, the adjoint
// down-FIR and the snake derivatives give dy on the two phases of the
// 2x-rate lattice (kept in shared memory), and the adjoint up-FIR gives dx.
//
// Edges are the exact adjoint of the forward's composition: the forward
// clamps the index of x to [0, T-1] (replicate pad by 5) and the lattice
// index to [0, 2T-1] (the down-FIR's replicate pad, 5 left and 6 right), so
// the backward scatters every pad position's contribution back onto lattice
// point 0 / 2T-1 (before the snake derivative) and onto sample 0 / T-1 of
// x.  The d alpha / d beta sums take each lattice point t in [0, T) exactly
// once: the block that owns output sample t owns lattice points 2t and 2t+1.
// Partials are summed outside the kernel (no atomics: the same bits in
// every run).
#include "afa_common.cuh"

constexpr int AFB_TILE = 512;
constexpr int AFB_THREADS = 256;
constexpr int AFB_XW = AFB_TILE + 12;  // x staged at [t0-6, t0+TILE+6)
// dz staged at [t0-6, t0+TILE+9): lattice point T-1 may lie in a tile's
// right halo, and its edge scatter reads dz up to 3 lattice points further
constexpr int AFB_DW = AFB_TILE + 15;
constexpr int AFB_LW = AFB_TILE + 6;   // lattice buffers at [t0-3, t0+TILE+3)

// Adjoint down-FIR at lattice point u on each phase, unclamped (the
// contributions of dz that land on lattice position 2u / 2u+1 exactly).
// s holds dz[t0 - 6 + i] (zero outside the clip); q = u - (t0 - 3).
__device__ __forceinline__ float afb_dm_even(const float* s, int q) {
  return AFA_H11 * s[q] + AFA_H9 * s[q + 1] + AFA_H7 * s[q + 2] +
         AFA_H5 * s[q + 3] + AFA_H3 * s[q + 4] + AFA_H1 * s[q + 5];
}
__device__ __forceinline__ float afb_dm_odd(const float* s, int q) {
  return AFA_H10 * s[q + 1] + AFA_H8 * s[q + 2] + AFA_H6 * s[q + 3] +
         AFA_H4 * s[q + 4] + AFA_H2 * s[q + 5] + AFA_H0 * s[q + 6];
}

// Lattice buffer read with the range guard of the edge sums (entries
// outside the buffer lie outside the clip, where dy is zero).
__device__ __forceinline__ float afb_lat(const float* buf, int q) {
  return (q >= 0 && q < AFB_LW) ? buf[q] : 0.0f;
}

// Adjoint up-FIR: d x~[t0 + r] (the padded input) from the lattice
// buffers; the guarded form serves the edge sums at r outside the tile.
__device__ __forceinline__ float afb_dx(const float* e, const float* o, int r) {
  return 2.0f * (AFA_H11 * e[r + 6] + AFA_H9 * e[r + 5] + AFA_H7 * e[r + 4] +
                 AFA_H5 * e[r + 3] + AFA_H3 * e[r + 2] + AFA_H1 * e[r + 1] +
                 AFA_H10 * o[r + 5] + AFA_H8 * o[r + 4] + AFA_H6 * o[r + 3] +
                 AFA_H4 * o[r + 2] + AFA_H2 * o[r + 1] + AFA_H0 * o[r]);
}
__device__ __forceinline__ float afb_dx_guarded(const float* e, const float* o,
                                                int r) {
  return 2.0f *
         (AFA_H11 * afb_lat(e, r + 6) + AFA_H9 * afb_lat(e, r + 5) +
          AFA_H7 * afb_lat(e, r + 4) + AFA_H5 * afb_lat(e, r + 3) +
          AFA_H3 * afb_lat(e, r + 2) + AFA_H1 * afb_lat(e, r + 1) +
          AFA_H10 * afb_lat(o, r + 5) + AFA_H8 * afb_lat(o, r + 4) +
          AFA_H6 * afb_lat(o, r + 3) + AFA_H4 * afb_lat(o, r + 2) +
          AFA_H2 * afb_lat(o, r + 1) + AFA_H0 * afb_lat(o, r));
}

template <typename T>
__global__ void __launch_bounds__(AFB_THREADS)
afa_snake_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dz,
                     const float* __restrict__ alpha,
                     const float* __restrict__ inv_beta, T* __restrict__ dx,
                     float* __restrict__ da_part, float* __restrict__ db_part,
                     int C, int T_len, int n_tiles) {
  __shared__ float xs[AFB_XW];
  __shared__ float dzs[AFB_DW];
  __shared__ float dye[AFB_LW];
  __shared__ float dyo[AFB_LW];
  __shared__ float red[2][AFB_THREADS / 32];

  const int row = blockIdx.x / n_tiles;  // b * C + c
  const int tile = blockIdx.x % n_tiles;
  const int t0 = tile * AFB_TILE;
  const int c = row % C;
  const int b = row / C;
  const T* xrow = x + (size_t)row * T_len;
  const T* dzrow = dz + (size_t)row * T_len;
  const float a = alpha[c];
  const float ib = inv_beta[c];
  const int tid = threadIdx.x;

  afa_stage_x(xrow, T_len, t0 - 6, AFB_XW, xs, tid, AFB_THREADS);
  for (int p = tid; p < AFB_DW; p += AFB_THREADS) {
    const int t = t0 - 6 + p;
    dzs[p] = (t >= 0 && t < T_len) ? afa_to_float(dzrow[t]) : 0.0f;
  }
  __syncthreads();

  // lattice: y, d mid (with the edge scatters), snake derivatives
  float da_acc = 0.0f, db_acc = 0.0f;
  for (int i = tid; i < 2 * AFB_LW; i += AFB_THREADS) {
    const bool odd = i >= AFB_LW;
    const int q = odd ? i - AFB_LW : i;
    const int t = t0 - 3 + q;
    float dy = 0.0f;
    if (t >= 0 && t < T_len) {
      float y, dm;
      if (odd) {
        const float* p = xs + q + 1;
        y = AFA_H10 * p[0] + AFA_H8 * p[1] + AFA_H6 * p[2] + AFA_H4 * p[3] +
            AFA_H2 * p[4] + AFA_H0 * p[5];
        dm = afb_dm_odd(dzs, q);
        if (t == T_len - 1) {  // pad positions 2T .. 2T+5 land on 2T-1
          for (int k = 1; k <= 3; ++k)
            dm += afb_dm_even(dzs, q + k) + afb_dm_odd(dzs, q + k);
        }
      } else {
        const float* p = xs + q;
        y = AFA_H11 * p[0] + AFA_H9 * p[1] + AFA_H7 * p[2] + AFA_H5 * p[3] +
            AFA_H3 * p[4] + AFA_H1 * p[5];
        dm = afb_dm_even(dzs, q);
        if (t == 0) {  // pad positions -6 .. -1 land on 0
          for (int k = 1; k <= 3; ++k)
            dm += afb_dm_even(dzs, q - k) + afb_dm_odd(dzs, q - k);
        }
      }
      y *= 2.0f;
      float s, co;
      sincosf(a * y, &s, &co);
      const float s2 = 2.0f * s * co;  // sin(2 a y)
      dy = dm * (1.0f + a * s2 * ib);
      if (t >= t0 && t < t0 + AFB_TILE) {
        da_acc += dm * y * s2 * ib;
        db_acc -= dm * (s * s) * ib * ib;
      }
    }
    (odd ? dyo : dye)[q] = dy;
  }

  // d alpha / d beta: fixed-order block reduction
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    da_acc += __shfl_down_sync(0xffffffffu, da_acc, off);
    db_acc += __shfl_down_sync(0xffffffffu, db_acc, off);
  }
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = da_acc;
    red[1][tid >> 5] = db_acc;
  }
  __syncthreads();  // also: dye / dyo are complete
  if (tid == 0) {
    float sa = 0.0f, sb = 0.0f;
    for (int w = 0; w < AFB_THREADS / 32; ++w) {
      sa += red[0][w];
      sb += red[1][w];
    }
    const size_t slot = ((size_t)b * n_tiles + tile) * C + c;
    da_part[slot] = sa;
    db_part[slot] = sb;
  }

  // adjoint up-FIR, with the replicate pad's scatter onto samples 0 / T-1
  T* dxrow = dx + (size_t)row * T_len;
  for (int r = tid; r < AFB_TILE; r += AFB_THREADS) {
    const int t = t0 + r;
    if (t >= T_len) continue;
    float v = afb_dx(dye, dyo, r);
    if (t == 0) {
      for (int p = -5; p <= -1; ++p) v += afb_dx_guarded(dye, dyo, p - t0);
    }
    if (t == T_len - 1) {
      for (int p = T_len; p <= T_len + 4; ++p)
        v += afb_dx_guarded(dye, dyo, p - t0);
    }
    afa_store(dxrow + t, v);
  }
}

// x, dz, dx: (B, C, T) contiguous, one type; alpha, inv_beta: (C,) float32;
// da_part, db_part: (B, n_tiles, C) float32 with n_tiles = ceil(T / 512).
extern "C" int afa_snake_backward(const void* x, const void* dz,
                                  const void* alpha, const void* inv_beta,
                                  void* dx, void* da_part, void* db_part,
                                  int B, int C, int T_len, int n_tiles,
                                  int is_bf16, void* stream) {
  if (n_tiles != (T_len + AFB_TILE - 1) / AFB_TILE)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)B * C * n_tiles;
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    afa_snake_bwd_kernel<__nv_bfloat16><<<(unsigned)blocks, AFB_THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)dz, (const float*)alpha,
        (const float*)inv_beta, (__nv_bfloat16*)dx, (float*)da_part,
        (float*)db_part, C, T_len, n_tiles);
  } else {
    afa_snake_bwd_kernel<float><<<(unsigned)blocks, AFB_THREADS, 0, s>>>(
        (const float*)x, (const float*)dz, (const float*)alpha,
        (const float*)inv_beta, (float*)dx, (float*)da_part, (float*)db_part,
        C, T_len, n_tiles);
  }
  return (int)cudaGetLastError();
}
