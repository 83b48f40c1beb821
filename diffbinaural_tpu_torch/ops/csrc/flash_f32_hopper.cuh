// Hopper machinery of the float32 flash attention kernels (flash_d32_f32.cu,
// flash_d32_f32_bwd.cu): split-TF32 products on wgmma.
//
// A float32 product a.b is taken as three TF32 products on the tensor cores,
//   a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi,
// with hi = tf32(x) (round to nearest, ties away: the low 13 bits of the
// float32 cleared) and lo = tf32(x - hi), summed in float32 accumulators
// (the small terms first).  What is dropped, a_lo.b_lo and the rounding of
// lo, is about 2^-21 of |a.b|; one TF32 product alone is off by 2^-11.
//
// wgmma takes .tf32 operands from shared memory K-major only (the transpose
// bits exist for 16-bit types alone), so every B operand lies in shared
// memory with the summed index innermost:
//   * the "rows" form of a (BH, N, 32) tensor: rows of 32 floats = 128
//     bytes, as it lies in memory (k for S = q k^T, q for s^T = k q^T, ...);
//   * the "transposed" form, for products that sum over keys or queries
//     (O += P V, dv += p^T do, dk += ds^T q, dq += ds k): blocks of TBLK = 32
//     keys, each block 32 rows (one per head column d) of 32 keys, with the
//     keys of every group of 8 in the order KEY_PERM.  A float32 wgmma
//     accumulator gives a thread columns {2t, 2t + 1} of each 8-column group,
//     the tf32 A fragment wants columns {t, t + 4}: reading the accumulator
//     as the A fragment takes accumulator column 2t for A column t and 2t + 1
//     for t + 4, so the B operand's column c of a group holds key
//     KEY_PERM[c] = {0, 2, 4, 6, 1, 3, 5, 7}[c].  No instruction in the loop
//     moves a value; the pre-pass that writes the transposed forms applies
//     the permutation once.
// Both forms and their hi / lo halves are written by a pre-pass (split_rows,
// split_transposed below) into scratch; the kernels load them with TMA in the
// 128-byte swizzle (16-byte chunk c of row r of each 1024-byte atom at chunk
// c ^ (r & 7)) and wgmma reads them through descriptors of the same swizzle,
// 8-row groups 1024 bytes apart, k-steps of 8 values 32 bytes apart.
#pragma once
#include "flash_hopper.cuh"

constexpr int F32_ROW_BYTES = FD * 4;          // one float32 row of the head dim
constexpr int SW128_ATOM = 8 * F32_ROW_BYTES;  // 8 rows x 128 bytes
constexpr int TBLK = 32;                       // keys per block of a transposed form

// forward: a block owns F32_FWD_BLOCK_M query rows (64 per consumer
// warpgroup) and streams tiles of F32_FWD_BLOCK_N keys through the ring
constexpr int F32_FWD_CONSUMERS = 3;
constexpr int F32_FWD_BLOCK_M = 64 * F32_FWD_CONSUMERS;
constexpr int F32_FWD_THREADS = (F32_FWD_CONSUMERS + 1) * WG_THREADS;
constexpr int F32_FWD_BLOCK_N = 64;
constexpr int F32_FWD_STAGES = 4;
constexpr int F32_FWD_PRODUCER_REGS = 24;
constexpr int F32_FWD_CONSUMER_REGS = 160;
// backward: both kernels have F32_BWD_CONSUMERS consumer warpgroups
constexpr int F32_BWD_CONSUMERS = 2;
constexpr int F32_BWD_THREADS = (F32_BWD_CONSUMERS + 1) * WG_THREADS;
// dk/dv: a block owns F32_BWD_KV_BLOCK_N keys, streams query tiles
constexpr int F32_BWD_KV_BLOCK_N = 64 * F32_BWD_CONSUMERS;
constexpr int F32_BWD_KV_BLOCK_M = 64;
// dq: a block owns F32_BWD_Q_BLOCK_M query rows, streams key tiles
constexpr int F32_BWD_Q_BLOCK_M = 64 * F32_BWD_CONSUMERS;
constexpr int F32_BWD_Q_BLOCK_N = 64;
constexpr int F32_BWD_STAGES = 2;
constexpr int F32_BWD_PRODUCER_REGS = 24;
constexpr int F32_BWD_CONSUMER_REGS = 240;
// The transposed forms hold N rounded up to F32_PAD keys (zeros beyond N),
// whole tiles of every kernel that streams them (flash_d32.py:_scratch sizes
// the scratch with the same number).
constexpr int F32_PAD = 64;

static_assert(regs_fit(F32_FWD_CONSUMERS, F32_FWD_PRODUCER_REGS,
                       F32_FWD_CONSUMER_REGS), "float32 forward registers");
static_assert(regs_fit(F32_BWD_CONSUMERS, F32_BWD_PRODUCER_REGS,
                       F32_BWD_CONSUMER_REGS), "float32 backward registers");
static_assert(F32_PAD % F32_FWD_BLOCK_N == 0 && F32_PAD % F32_BWD_KV_BLOCK_M == 0 &&
              F32_PAD % F32_BWD_Q_BLOCK_N == 0 && F32_PAD % TBLK == 0,
              "transposed forms in whole tiles");

__host__ __device__ constexpr int f32_tile(int rows) { return rows * F32_ROW_BYTES; }

// Byte offsets inside each kernel's dynamic shared memory (base aligned to
// TILE_ALIGN).  "_t" tiles are transposed forms: rows (block, d) of 32 keys.
// forward:  q hi, q lo | stage s: k hi, k lo, v_t hi, v_t lo | barriers
// full[S], empty[S], q
struct F32FwdSmem {
  static constexpr int q_hi = 0;
  static constexpr int q_lo = f32_tile(F32_FWD_BLOCK_M);
  static constexpr int stage0 = round_up(2 * f32_tile(F32_FWD_BLOCK_M), TILE_ALIGN);
  static constexpr int stage_bytes = round_up(4 * f32_tile(F32_FWD_BLOCK_N), TILE_ALIGN);
  __host__ __device__ static constexpr int k_hi(int s) { return stage0 + s * stage_bytes; }
  __host__ __device__ static constexpr int k_lo(int s) { return k_hi(s) + f32_tile(F32_FWD_BLOCK_N); }
  __host__ __device__ static constexpr int vt_hi(int s) { return k_lo(s) + f32_tile(F32_FWD_BLOCK_N); }
  __host__ __device__ static constexpr int vt_lo(int s) { return vt_hi(s) + f32_tile(F32_FWD_BLOCK_N); }
  static constexpr int bars = stage0 + F32_FWD_STAGES * stage_bytes;
  static constexpr int n_bars = 2 * F32_FWD_STAGES + 1;
  static constexpr int bytes = bars + 8 * n_bars;
};
// dk/dv:  k hi, k lo, v hi, v lo | stage s: q hi, q lo, do hi, do lo,
// q_t hi, q_t lo, do_t hi, do_t lo, lse, di | barriers full[S], empty[S], kv
struct F32BwdKvSmem {
  static constexpr int kv_tile = f32_tile(F32_BWD_KV_BLOCK_N);
  static constexpr int m_tile = f32_tile(F32_BWD_KV_BLOCK_M);
  static constexpr int k_hi = 0;
  static constexpr int k_lo = kv_tile;
  static constexpr int v_hi = 2 * kv_tile;
  static constexpr int v_lo = 3 * kv_tile;
  static constexpr int stage0 = round_up(4 * kv_tile, TILE_ALIGN);
  static constexpr int stage_bytes =
      round_up(8 * m_tile + 2 * 4 * F32_BWD_KV_BLOCK_M, TILE_ALIGN);
  // tile i of stage s: 0 q hi, 1 q lo, 2 do hi, 3 do lo, 4 q_t hi, 5 q_t lo,
  // 6 do_t hi, 7 do_t lo
  __host__ __device__ static constexpr int tile(int s, int i) {
    return stage0 + s * stage_bytes + i * m_tile;
  }
  __host__ __device__ static constexpr int lse(int s) { return tile(s, 8); }
  __host__ __device__ static constexpr int di(int s) { return lse(s) + 4 * F32_BWD_KV_BLOCK_M; }
  static constexpr int bars = stage0 + F32_BWD_STAGES * stage_bytes;
  static constexpr int n_bars = 2 * F32_BWD_STAGES + 1;
  static constexpr int bytes = bars + 8 * n_bars;
};
// dq:  q hi, q lo, do hi, do lo | stage s: k hi, k lo, v hi, v lo, k_t hi,
// k_t lo | barriers full[S], empty[S], q
struct F32BwdQSmem {
  static constexpr int q_tile = f32_tile(F32_BWD_Q_BLOCK_M);
  static constexpr int n_tile = f32_tile(F32_BWD_Q_BLOCK_N);
  static constexpr int q_hi = 0;
  static constexpr int q_lo = q_tile;
  static constexpr int do_hi = 2 * q_tile;
  static constexpr int do_lo = 3 * q_tile;
  static constexpr int stage0 = round_up(4 * q_tile, TILE_ALIGN);
  static constexpr int stage_bytes = round_up(6 * n_tile, TILE_ALIGN);
  // tile i of stage s: 0 k hi, 1 k lo, 2 v hi, 3 v lo, 4 k_t hi, 5 k_t lo
  __host__ __device__ static constexpr int tile(int s, int i) {
    return stage0 + s * stage_bytes + i * n_tile;
  }
  static constexpr int bars = stage0 + F32_BWD_STAGES * stage_bytes;
  static constexpr int n_bars = 2 * F32_BWD_STAGES + 1;
  static constexpr int bytes = bars + 8 * n_bars;
};
static_assert(F32FwdSmem::bytes + TILE_ALIGN <= MAX_DYNAMIC_SMEM, "float32 forward smem");
static_assert(F32BwdKvSmem::bytes + TILE_ALIGN <= MAX_DYNAMIC_SMEM, "float32 dk/dv smem");
static_assert(F32BwdQSmem::bytes + TILE_ALIGN <= MAX_DYNAMIC_SMEM, "float32 dq smem");
static_assert(f32_tile(64) % SW128_ATOM == 0 && TILE_ALIGN % SW128_ATOM == 0,
              "tiles of whole 128-byte-swizzle atoms");

// ------------------------------------------------------------ split-TF32

// tf32(x): round to nearest, ties away from zero, on the magnitude bits (the
// sign bit is not carried into); the low 13 bits are zero, so the tensor
// cores read exactly this value.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
// x as hi + lo, both tf32 (x - hi is exact in float32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// A float32 accumulator of N columns (S, p^T, ds, ds^T) as the tf32 A
// fragments of the next product, hi and lo: k-step kk (8 columns) is
// accumulator values 4 kk ... + 3, which hold (row g, column 2t), (g, 2t+1),
// (g+8, 2t), (g+8, 2t+1); the A fragment is (g, t'), (g+8, t'), (g, t'+4),
// (g+8, t'+4) with A column t' standing for key 2t and t'+4 for 2t+1
// (KEY_PERM), so the registers are taken in the order 0, 2, 1, 3.
template <int N>
__device__ __forceinline__ void split_a_frags(const float* acc, uint32_t* hi,
                                              uint32_t* lo) {
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
    split_tf32(acc[4 * c], hi[4 * c], lo[4 * c]);
    split_tf32(acc[4 * c + 2], hi[4 * c + 1], lo[4 * c + 1]);
    split_tf32(acc[4 * c + 1], hi[4 * c + 2], lo[4 * c + 2]);
    split_tf32(acc[4 * c + 3], hi[4 * c + 3], lo[4 * c + 3]);
  }
}

// ------------------------------------------------------------------ wgmma

// Descriptor of a tile of 128-byte rows in the 128-byte swizzle: start
// address >> 4, 8-row groups SW128_ATOM apart (SBO); LBO is not read (one
// atom spans the 32-value K extent).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(SW128_ATOM >> 4) << 32) | ((uint64_t)1 << 62);
}
// k-step of 8 tf32 values: 32 bytes further in each row
constexpr uint64_t DESC_K8_TF32 = 32 >> 4;
// k-step kk (8 keys) of a transposed tile: block kk / 4 (32 rows further),
// 32 bytes per k-step inside the block
__device__ __forceinline__ uint64_t t_kstep(int kk) {
  return (uint64_t)(((kk / 4) * f32_tile(FD) + (kk % 4) * 32) >> 4);
}

#define WG_ACC32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"
#define WG_ACC32_OPS(c)                                                       \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]),     \
      c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),     \
      c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]),   \
      c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]), c(d[27]), c(d[28]),   \
      c(d[29]), c(d[30]), c(d[31])
#define WG_RW(x) "+f"(x)
#define WG_W(x) "=f"(x)

// d (64 x 64, f32) = A (64 x 8) B^T (64 x 8) + d; A and B tf32 in shared
// memory, K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_ACC32
      ", %32, %33, p, 1, 1;\n}\n"
      : WG_ACC32_OPS(WG_RW)
      : "l"(da), "l"(db), "r"(1));
}
// The same with d = A B^T: the accumulator is written, not read.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_first(float* d, uint64_t da,
                                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_ACC32
      ", %32, %33, p, 1, 1;\n}\n"
      : WG_ACC32_OPS(WG_W)
      : "l"(da), "l"(db), "r"(0));
}
// The same with d = A B: the accumulator is written, not read.
__device__ __forceinline__ void wgmma_m64n32k8_tf32_rs_first(float* d, const uint32_t* a,
                                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}
// d (64 x 32, f32) = A (64 x 8, tf32 A fragments in registers) B (8 x 32,
// shared memory, K-major: a transposed tile) + d.
__device__ __forceinline__ void wgmma_m64n32k8_tf32_rs(float* d, const uint32_t* a,
                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Add a tile's product d into the running sum acc (N floats), on the CUDA
// cores.
template <int N>
__device__ __forceinline__ void add_tile(float* acc, const float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += d[i];
}

// acc (64 x 64) = A B^T over the 32 head columns in split TF32, A and B in
// the rows form: a_lo b_hi, then a_hi b_lo, then a_hi b_hi, 4 k-steps each
// (12 k-steps into one fresh accumulator).
__device__ __forceinline__ void split_ss_64x64(float* acc, uint32_t a_hi, uint32_t a_lo,
                                               uint32_t b_hi, uint32_t b_lo) {
  const uint64_t ah = sw128_desc(a_hi), al = sw128_desc(a_lo);
  const uint64_t bh = sw128_desc(b_hi), bl = sw128_desc(b_lo);
  wgmma_m64n64k8_tf32_first(acc, al, bh);
#pragma unroll
  for (int kk = 1; kk < FD / 8; ++kk)
    wgmma_m64n64k8_tf32(acc, al + kk * DESC_K8_TF32, bh + kk * DESC_K8_TF32);
#pragma unroll
  for (int kk = 0; kk < FD / 8; ++kk)
    wgmma_m64n64k8_tf32(acc, ah + kk * DESC_K8_TF32, bl + kk * DESC_K8_TF32);
#pragma unroll
  for (int kk = 0; kk < FD / 8; ++kk)
    wgmma_m64n64k8_tf32(acc, ah + kk * DESC_K8_TF32, bh + kk * DESC_K8_TF32);
}

// d (64 x 32) = A B over the K keys (or query rows) of one tile in split
// TF32: A as hi / lo fragments from split_a_frags, B a transposed tile (hi,
// lo): a_lo b_hi, a_hi b_lo, a_hi b_hi, K / 8 k-steps each.  The tensor
// cores' float32 accumulation does not round to nearest: its error grows
// with the number of k-steps summed into one accumulator and leans one
// way, so a kernel sums each tile into a fresh d and adds the tiles on the
// CUDA cores (round to nearest), which keeps the error flat in N.
template <int K>
__device__ __forceinline__ void split_rs_x32(float* d, const uint32_t* a_hi,
                                             const uint32_t* a_lo, uint32_t b_hi,
                                             uint32_t b_lo) {
  const uint64_t bh = sw128_desc(b_hi), bl = sw128_desc(b_lo);
  wgmma_m64n32k8_tf32_rs_first(d, a_lo, bh);
#pragma unroll
  for (int kk = 1; kk < K / 8; ++kk)
    wgmma_m64n32k8_tf32_rs(d, a_lo + 4 * kk, bh + t_kstep(kk));
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    wgmma_m64n32k8_tf32_rs(d, a_hi + 4 * kk, bl + t_kstep(kk));
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    wgmma_m64n32k8_tf32_rs(d, a_hi + 4 * kk, bh + t_kstep(kk));
}

// ------------------------------------------------------------- pre-pass

// x (rows x 32, contiguous) -> hi, lo of the same layout; 4 values a thread.
__global__ void __launch_bounds__(256)
split_rows_kernel(const float4* __restrict__ x, uint4* __restrict__ hi,
                  uint4* __restrict__ lo, long long n4) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n4) return;
  const float4 v = x[i];
  uint4 h, l;
  split_tf32(v.x, h.x, l.x);
  split_tf32(v.y, h.y, l.y);
  split_tf32(v.z, h.z, l.z);
  split_tf32(v.w, h.w, l.w);
  hi[i] = h;
  lo[i] = l;
}

// x (BH, N, 32) -> the transposed forms hi, lo (BH, n_pad, 32): block b of
// head bh is out[bh][b * 32 + d][c] = x[bh][b * 32 + 8 (c / 8) +
// KEY_PERM[c % 8]][d], zeros for keys >= N.  One block of 256 threads per
// 32-key block, staged through shared memory.
__global__ void __launch_bounds__(256)
split_transposed_kernel(const float* __restrict__ x, uint32_t* __restrict__ hi,
                        uint32_t* __restrict__ lo, int N, int n_pad) {
  __shared__ float tile[TBLK][FD + 1];
  const int blocks = n_pad / TBLK;
  const int bh = blockIdx.x / blocks, b = blockIdx.x % blocks;
  const size_t in0 = ((size_t)bh * N + (size_t)b * TBLK) * FD;
  for (int i = threadIdx.x; i < TBLK * FD; i += 256) {
    const int key = i / FD, d = i % FD;
    tile[key][d] = b * TBLK + key < N ? x[in0 + (size_t)key * FD + d] : 0.0f;
  }
  __syncthreads();
  const size_t out0 = ((size_t)bh * n_pad + (size_t)b * TBLK) * FD;
  for (int i = threadIdx.x; i < FD * TBLK; i += 256) {
    const int d = i / TBLK, c = i % TBLK, cg = c % 8;
    const int key = c - cg + (cg < 4 ? 2 * cg : 2 * (cg - 4) + 1);  // KEY_PERM
    uint32_t h, l;
    split_tf32(tile[key][d], h, l);
    hi[out0 + i] = h;
    lo[out0 + i] = l;
  }
}

// ------------------------------------------------------------- host side

// The tensor map of a float32 (BH, rows, 32) tensor as (32, rows, BH) with
// boxes of (32, box_rows, 1), 128-byte swizzle, zeros beyond `rows`.
static int make_rows_map_f32(CUtensorMap* map, const void* ptr, int BH, int rows,
                             int box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)FD, (cuuint64_t)rows, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)F32_ROW_BYTES,
                                 (cuuint64_t)rows * F32_ROW_BYTES};
  const cuuint32_t box[3] = {(cuuint32_t)FD, (cuuint32_t)box_rows, 1u};
  const cuuint32_t elem[3] = {1u, 1u, 1u};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

__host__ __device__ constexpr long long f32_pad_rows(int N) {
  return (long long)(N + F32_PAD - 1) / F32_PAD * F32_PAD;
}

// The split forms of one tensor in scratch: rows hi, rows lo (BH N 32 each),
// or transposed hi, transposed lo (BH n_pad 32 each).
struct SplitForm {
  float* hi;
  float* lo;
};
static SplitForm take_rows(float*& scratch, int BH, int N) {
  const size_t n = (size_t)BH * N * FD;
  SplitForm f{scratch, scratch + n};
  scratch += 2 * n;
  return f;
}
static SplitForm take_transposed(float*& scratch, int BH, int N) {
  const size_t n = (size_t)BH * f32_pad_rows(N) * FD;
  SplitForm f{scratch, scratch + n};
  scratch += 2 * n;
  return f;
}
static void launch_split_rows(const float* x, SplitForm f, int BH, int N,
                              cudaStream_t s) {
  const long long n4 = (long long)BH * N * FD / 4;
  split_rows_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(
      (const float4*)x, (uint4*)f.hi, (uint4*)f.lo, n4);
}
static void launch_split_transposed(const float* x, SplitForm f, int BH, int N,
                                    cudaStream_t s) {
  const int n_pad = (int)f32_pad_rows(N);
  split_transposed_kernel<<<(unsigned)((long long)BH * (n_pad / TBLK)), 256, 0, s>>>(
      x, (uint32_t*)f.hi, (uint32_t*)f.lo, N, n_pad);
}
