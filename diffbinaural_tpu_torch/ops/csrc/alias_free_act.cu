// Fused alias-free snake activation, forward:  z = down2(snake(up2(x)))
// on (B, C, T), one read of x and one write of z.
//
// Replaces the Pallas kernels _fwd_kernel_mxu / _fwd_kernel of
// diffbinaural_tpu/ops/alias_free_act.py (fused_alias_free_snake).
//
// Bound by bytes: 2 * B*C*T * sizeof(T) against ~36 FMAs and two sines per
// sample.  One block handles TILE consecutive samples of one (b, c) row:
// the row is contiguous in time, so loads and stores are coalesced; the tile
// and its +-5-sample halo are staged once in shared memory (halo overhead
// 10/TILE), the 2x-rate snake lattice is computed once per lattice point
// into two shared arrays (even / odd phase, so the down-FIR reads are
// conflict-free), and the down-FIR writes the output.  The intermediate
// never leaves the SM.  One kernel serves every channel count.
#include "afa_common.cuh"

constexpr int AFA_TILE = 512;
constexpr int AFA_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(AFA_THREADS)
afa_snake_kernel(const T* __restrict__ x, const float* __restrict__ alpha,
                 const float* __restrict__ inv_beta, T* __restrict__ out,
                 int C, int T_len, int n_tiles) {
  __shared__ float xs[AFA_TILE + 10];
  __shared__ float me[AFA_TILE + 5];
  __shared__ float mo[AFA_TILE + 5];

  const int row = blockIdx.x / n_tiles;           // b * C + c
  const int t0 = (blockIdx.x % n_tiles) * AFA_TILE;
  const int c = row % C;
  const T* xrow = x + (size_t)row * T_len;
  T* orow = out + (size_t)row * T_len;
  const float a = alpha[c];
  const float ib = inv_beta[c];
  const int tid = threadIdx.x;

  afa_stage_x(xrow, T_len, t0 - 5, AFA_TILE + 10, xs, tid, AFA_THREADS);
  __syncthreads();
  afa_fill_lattice(xs, t0, AFA_TILE, T_len, a, ib, me, mo, tid, AFA_THREADS);
  __syncthreads();
  for (int i = tid; i < AFA_TILE; i += AFA_THREADS) {
    const int t = t0 + i;
    if (t < T_len) afa_store(orow + t, afa_down(me, mo, i));
  }
}

extern "C" int afa_snake_forward(const void* x, const void* alpha,
                                 const void* inv_beta, void* out, int B, int C,
                                 int T_len, int is_bf16, void* stream) {
  const int n_tiles = (T_len + AFA_TILE - 1) / AFA_TILE;
  const long long blocks = (long long)B * C * n_tiles;
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    afa_snake_kernel<__nv_bfloat16><<<(unsigned)blocks, AFA_THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)alpha, (const float*)inv_beta,
        (__nv_bfloat16*)out, C, T_len, n_tiles);
  } else {
    afa_snake_kernel<float><<<(unsigned)blocks, AFA_THREADS, 0, s>>>(
        (const float*)x, (const float*)alpha, (const float*)inv_beta,
        (float*)out, C, T_len, n_tiles);
  }
  return (int)cudaGetLastError();
}
