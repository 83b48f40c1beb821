// Fused alias-free snake activation, forward:  z = down2(snake(up2(x)))
// on (B, C, T), one read of x and one write of z.
//
// Replaces the Pallas kernels _fwd_kernel_mxu / _fwd_kernel of
// diffbinaural_tpu/ops/alias_free_act.py (fused_alias_free_snake).
//
// Bound by bytes: 2 * B*C*T * sizeof(T) against ~70 float32 operations per
// sample.  Register-blocked: thread i owns the AFA_RUN outputs at flat
// positions [AFA_RUN i, AFA_RUN (i+1)) of the contiguous (B*C*T) array, so
// its loads and stores are aligned 16-byte vectors whatever T is, and
// neighbouring threads move neighbouring bytes.  A run whose x window
// [t0 - 5, t0 + AFA_RUN + 5) lies inside one row (interior) loads it with
// four vector loads (the halo chunks are the neighbours' and come from L1),
// computes the 2x-rate lattice and the snake in registers (the 5-point halo
// of each phase is recomputed, 21 points per 16 outputs) and the down-FIR
// from registers, with no clamp, no shared memory and no barrier.  A run
// that touches a row's first or last 5 samples, or holds the end of one row
// and the start of the next (T not a multiple of AFA_RUN, or short rows),
// takes the edge path: per row it touches, the window loaded with clamped
// indices and the lattice clamp applied by selects against the row's
// mid[0] and mid[2T-1] (afa_run<.., true>).
// Short rows pack into a block like long ones: a block is 256 runs.
#include "afa_common.cuh"

constexpr int AFA_RUN = 16;      // consecutive outputs per thread
constexpr int AFA_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(AFA_THREADS)
afa_snake_kernel(const T* __restrict__ x, const float* __restrict__ alpha,
                 const float* __restrict__ inv_beta, T* __restrict__ out,
                 int C, int T_len, int total, int n_runs) {
  const int run = blockIdx.x * AFA_THREADS + threadIdx.x;
  if (run >= n_runs) return;
  const int start = run * AFA_RUN;           // flat index of the first output
  const int row = start / T_len;
  const int t0 = start - row * T_len;
  float z[AFA_RUN];
  if (t0 >= 5 && t0 + AFA_RUN + 5 <= T_len && start + AFA_RUN + 8 <= total) {
    // interior: x[start-8 .. start+24) in four aligned vectors
    float v[AFA_RUN + 16];
#pragma unroll
    for (int c = 0; c < AFA_RUN + 16; c += 8) afa_load8(x + start - 8 + c, v + c);
    const int ch = row % C;
    afa_run<AFA_RUN, false>(v + 3, t0, T_len, alpha[ch], inv_beta[ch], 0.0f,
                            0.0f, z);
#pragma unroll
    for (int c = 0; c < AFA_RUN; c += 8) afa_store8(out + start + c, z + c);
    return;
  }
  // edge: every row the run touches, its window clamped to that row
  const int end = min(start + AFA_RUN, total);
  for (int r = row; r * T_len < end; ++r) {
    const int rt0 = start - r * T_len;      // may be negative for r > row
    const T* xrow = x + (size_t)r * T_len;
    float xw[AFA_RUN + 10];
#pragma unroll
    for (int p = 0; p < AFA_RUN + 10; ++p)
      xw[p] = afa_to_float(xrow[afa_clamp(rt0 - 5 + p, 0, T_len - 1)]);
    const int ch = r % C;
    const float a = alpha[ch], ib = inv_beta[ch];
    afa_run<AFA_RUN, true>(xw, rt0, T_len, a, ib,
                           afa_mid_row<true>(xrow, T_len, 0, a, ib),
                           afa_mid_row<true>(xrow, T_len, 2 * T_len - 1, a, ib),
                           z);
#pragma unroll
    for (int i = 0; i < AFA_RUN; ++i) {
      const int t = rt0 + i;
      if (t >= 0 && t < T_len && start + i < end) afa_store(out + start + i, z[i]);
    }
  }
}

extern "C" int afa_snake_forward(const void* x, const void* alpha,
                                 const void* inv_beta, void* out, int B, int C,
                                 int T_len, int is_bf16, void* stream) {
  const long long total = (long long)B * C * T_len;
  // flat int indices, with room for the last run's vector reads
  if (total <= 0 || total > 2147483647LL - 2 * AFA_RUN - 16)
    return (int)cudaErrorInvalidValue;
  const int n_runs = (int)((total + AFA_RUN - 1) / AFA_RUN);
  const int blocks = (n_runs + AFA_THREADS - 1) / AFA_THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    afa_snake_kernel<__nv_bfloat16><<<blocks, AFA_THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)alpha, (const float*)inv_beta,
        (__nv_bfloat16*)out, C, T_len, (int)total, n_runs);
  } else {
    afa_snake_kernel<float><<<blocks, AFA_THREADS, 0, s>>>(
        (const float*)x, (const float*)alpha, (const float*)inv_beta,
        (float*)out, C, T_len, (int)total, n_runs);
  }
  return (int)cudaGetLastError();
}
