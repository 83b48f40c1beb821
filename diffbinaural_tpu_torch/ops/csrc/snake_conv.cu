// Fused alias-free snake activation -> k-tap dilated Conv1d, forward:
//   out[b, co, t] = bias[co] + sum_{j, ci} w[j, ci, co] * z[b, ci, t + (j-ctr)*dil]
//   z = down2(snake(up2(x)))   (afa_common.cuh), z == 0 outside [0, T)
// on (B, C, T) with C_in == C_out == C, C % 128 == 0, odd k, stride 1.
//
// Replaces the Pallas kernel _kernel (fused_snake_conv -> _fused_forward) of
// diffbinaural_tpu/ops/snake_conv.py.
//
// Bound by operations (2*B*T*k*C*C FLOP against (2*B*C*T + k*C*C) elements
// moved).  This first version runs on the CUDA cores in float32.  One block
// computes a tile of 128 output channels x 128 time steps of one batch
// element and loops over the input channels 16 at a time: for each chunk it
// stages x (+-(HZ+5) halo, HZ = (k-1)/2*dil), computes the activated rows
// z[16][128 + 2*HZ] into shared memory (rows outside the clip zeroed, so the
// convolution's zero padding is exact) and accumulates the k shifted
// products against w[j, chunk, co-tile], itself staged per tap.  The
// activated tile never goes to device memory; chunking the input channels
// keeps shared memory near 40 KB whatever C is.  Each thread holds an 8 x 8
// accumulator (8 contiguous output channels x 8 time steps strided by 16, so
// that the shifted reads of z hit consecutive banks).  The activation of a
// time tile is recomputed by each of the C/128 output-channel tiles
// (~70 operations per element against 2*k*128 in the products).
#include "afa_common.cuh"

constexpr int SC_CO = 128;      // output channels per block
constexpr int SC_T = 128;       // time steps per block
constexpr int SC_CK = 16;       // input channels per chunk
constexpr int SC_THREADS = 256; // 16 (time) x 16 (channel) threads, 8x8 each

template <typename T>
__global__ void __launch_bounds__(SC_THREADS)
snake_conv_kernel(const T* __restrict__ x, const float* __restrict__ alpha,
                  const float* __restrict__ inv_beta, const T* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ out, int C,
                  int T_len, int k, int dil, int n_ttiles) {
  extern __shared__ __align__(16) float smem[];
  const int HZ = (k - 1) / 2 * dil;
  const int ZW = SC_T + 2 * HZ;   // activated columns per row
  const int XW = ZW + 10;         // staged x columns per row (also z's stride)
  const int MW = ZW + 5;          // lattice entries per phase per row
  float* xz = smem;                       // [SC_CK][XW]: x, then z in place
  float* me = xz + SC_CK * XW;            // [SC_CK][MW]
  float* mo = me + SC_CK * MW;            // [SC_CK][MW]
  float* ws = mo + SC_CK * MW;            // [SC_CK][SC_CO]

  const int tid = threadIdx.x;
  const int tx = tid & 15;        // time lane
  const int ty = tid >> 4;        // channel lane
  const int n_cotiles = C / SC_CO;
  int blk = blockIdx.x;
  const int co0 = (blk % n_cotiles) * SC_CO;
  blk /= n_cotiles;
  const int tb = (blk % n_ttiles) * SC_T;
  const int b = blk / n_ttiles;
  const int t0 = tb - HZ;         // first activated column

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[i][n] = 0.0f;

  for (int ci0 = 0; ci0 < C; ci0 += SC_CK) {
    __syncthreads();  // previous chunk's products are done with xz and ws
    for (int i = tid; i < SC_CK * XW; i += SC_THREADS) {
      const int c = i / XW;
      const int p = i - c * XW;
      const T* row = x + ((size_t)b * C + ci0 + c) * T_len;
      xz[i] = afa_to_float(row[afa_clamp(t0 - 5 + p, 0, T_len - 1)]);
    }
    __syncthreads();
    for (int i = tid; i < SC_CK * 2 * MW; i += SC_THREADS) {
      const int c = i / (2 * MW);
      const int r = i - c * 2 * MW;
      const float a = alpha[ci0 + c];
      const float ib = inv_beta[ci0 + c];
      const float* xs = xz + c * XW;
      if (r < MW) {
        me[c * MW + r] =
            afa_mid(xs, t0 - 5, XW, 2 * (t0 - 2 + r), T_len, a, ib);
      } else {
        const int q = r - MW;
        mo[c * MW + q] =
            afa_mid(xs, t0 - 5, XW, 2 * (t0 - 3 + q) + 1, T_len, a, ib);
      }
    }
    __syncthreads();
    for (int i = tid; i < SC_CK * ZW; i += SC_THREADS) {
      const int c = i / ZW;
      const int p = i - c * ZW;
      const int t = t0 + p;
      xz[c * XW + p] = (t >= 0 && t < T_len)
                           ? afa_down(me + c * MW, mo + c * MW, p)
                           : 0.0f;
    }

    for (int j = 0; j < k; ++j) {
      __syncthreads();  // z is complete / the previous tap's ws is consumed
      const T* wj = w + ((size_t)j * C + ci0) * C + co0;
      for (int i = tid; i < SC_CK * SC_CO; i += SC_THREADS) {
        const int c = i / SC_CO;
        const int co = i - c * SC_CO;
        ws[i] = afa_to_float(wj[(size_t)c * C + co]);
      }
      __syncthreads();
      const int shift = j * dil;  // HZ + (j - ctr)*dil
#pragma unroll 4
      for (int c = 0; c < SC_CK; ++c) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(ws + c * SC_CO + ty * 8);
        const float4 a1 =
            *reinterpret_cast<const float4*>(ws + c * SC_CO + ty * 8 + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float* zr = xz + c * XW + shift + tx;
        float bv[8];
#pragma unroll
        for (int n = 0; n < 8; ++n) bv[n] = zr[16 * n];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int n = 0; n < 8; ++n) acc[i][n] = fmaf(av[i], bv[n], acc[i][n]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int co = co0 + ty * 8 + i;
    const float bco = bias[co];
    T* orow = out + ((size_t)b * C + co) * T_len;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int t = tb + tx + 16 * n;
      if (t < T_len) afa_store(orow + t, acc[i][n] + bco);
    }
  }
}

static size_t sc_smem_bytes(int k, int dil) {
  const int HZ = (k - 1) / 2 * dil;
  const int ZW = SC_T + 2 * HZ;
  return sizeof(float) *
         (size_t)(SC_CK * (ZW + 10) + 2 * SC_CK * (ZW + 5) + SC_CK * SC_CO);
}

template <typename T>
static int sc_launch(const void* x, const void* alpha, const void* inv_beta,
                     const void* w, const void* bias, void* out, int B, int C,
                     int T_len, int k, int dil, cudaStream_t s) {
  const size_t smem = sc_smem_bytes(k, dil);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      snake_conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_ttiles = (T_len + SC_T - 1) / SC_T;
  const long long blocks = (long long)B * n_ttiles * (C / SC_CO);
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  snake_conv_kernel<T><<<(unsigned)blocks, SC_THREADS, smem, s>>>(
      (const T*)x, (const float*)alpha, (const float*)inv_beta, (const T*)w,
      (const float*)bias, (T*)out, C, T_len, k, dil, n_ttiles);
  return (int)cudaGetLastError();
}

// w is tap-major: (k, C_in, C_out), contiguous, in x's type.
extern "C" int snake_conv_forward(const void* x, const void* alpha,
                                  const void* inv_beta, const void* w,
                                  const void* bias, void* out, int B, int C,
                                  int T_len, int k, int dil, int is_bf16,
                                  void* stream) {
  if (C % SC_CO != 0 || k % 2 != 1 || dil < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return sc_launch<__nv_bfloat16>(x, alpha, inv_beta, w, bias, out, B, C,
                                    T_len, k, dil, s);
  }
  return sc_launch<float>(x, alpha, inv_beta, w, bias, out, B, C, T_len, k,
                          dil, s);
}
