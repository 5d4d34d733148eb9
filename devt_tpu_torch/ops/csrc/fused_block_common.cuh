// Device code shared by the hand-written kernels for Hopper (sm_90a): the
// fused ViT-block forward and backward (fused_block_fwd.cu,
// fused_block_bwd.cu), the attention half of the MoE block (attn_half.cu),
// the packed-qkv attention backward (mha_bwd.cu) and, through
// attention_fwd.cuh, int8_common.cuh and block_bwd_parts.cuh, the
// attention forward, the int8 kernels and the backward pieces:
//
//   * warp and quad reductions, tanh GELU and its derivative;
//   * the bfloat16 tensor-core pieces of the mma.sync kernels (the
//     attention forward and backward bodies, kernel 5's products, kernel
//     7's out-projection): cp.async tile copies, ldmatrix fragment loads,
//     mma.sync m16n8k16 with f32 accumulation, and the 16 x 16 score tiles
//     of the two attention backward kernels (the block's other products
//     are block_sm90.cuh's, on wgmma);
//   * the dropout generator: counter-based Philox4x32-10 keyed by the
//     call's seed, with the counter made of (site, flat element index).
//     The mask of an element therefore does not depend on the grid, the
//     tile shape or the launch, so the backward regenerates the forward's
//     masks exactly.  keep = bits >= min(int(rate * 2^32), 2^32 - 1), kept
//     values scaled by 1 / (1 - rate), at the three sites of the block
//     (out-projection, FFN hidden, FFN output) and at the attention
//     probabilities of the packed-qkv attention;
//   * the float route's block-level FMA product on 32-row tiles, and its
//     LN1 + qkv on them.
//
// Everything sits in an anonymous namespace: each .cu that includes this
// header compiles its own copy into its own shared library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLnEps = 1e-5f;
constexpr float kNegInf = -1e30f;
constexpr float kGeluC = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluK = 0.044715f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) & ~static_cast<size_t>(127);
}

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// reductions over the 4 lanes of a quad, which hold one row of an
// mma accumulator tile
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// sum over the 8 lanes that hold one column of an mma accumulator tile
// (the lanes that differ in lane / 4); lanes 0..3 end up with the total
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

__device__ __forceinline__ float gelu_tanh(float z) {
  return 0.5f * z * (1.0f + tanhf(kGeluC * (z + kGeluK * z * z * z)));
}

__device__ __forceinline__ float dgelu_tanh(float z) {
  const float t = tanhf(kGeluC * (z + kGeluK * z * z * z));
  const float dinner = kGeluC * (1.0f + 3.0f * kGeluK * z * z);
  return 0.5f * (1.0f + t) + 0.5f * z * (1.0f - t * t) * dinner;
}

// Mean and 1/sqrt(var + eps) of one row, computed by one warp in two
// passes (mean, then mean of squared deviations) as the reference does.
// Lane l touches only the columns c == l (mod 32).
template <typename Src>
__device__ __forceinline__ void warp_row_stats(const Src* row, int n,
                                               float& mu, float& rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int c = lane; c < n; c += 32) s += to_f32(row[c]);
  mu = warp_sum(s) / n;
  float v = 0.f;
  for (int c = lane; c < n; c += 32) {
    const float dv = to_f32(row[c]) - mu;
    v += dv * dv;
  }
  rstd = rsqrtf(warp_sum(v) / n + kLnEps);
}

// ===========================================================================
// dropout: Philox4x32-10
// ===========================================================================

// The three dropout sites of the block, in the order the reference draws
// them, and the attention probabilities of the packed-qkv attention
// (mha_fwd.cu, mha_bwd.cu), counted flat over (sequence, head, query, key).
constexpr uint32_t kSiteOut = 0, kSiteHidden = 1, kSiteFfnOut = 2,
                   kSiteAttn = 3;

struct Drop {
  uint32_t key0, key1;  // the seed
  uint32_t cutoff;      // keep where bits >= cutoff
  float scale;          // 1 / (1 - rate)
  int on;               // 0: no dropout, nothing is drawn
};

inline Drop make_drop(double rate, unsigned long long seed) {
  Drop d{};
  d.on = rate > 0.0;
  if (!d.on) return d;
  d.key0 = static_cast<uint32_t>(seed);
  d.key1 = static_cast<uint32_t>(seed >> 32);
  const double c = rate * 4294967296.0;
  d.cutoff = c >= 4294967295.0 ? 4294967295u : static_cast<uint32_t>(c);
  d.scale = static_cast<float>(1.0 / (1.0 - rate));
  return d;
}

// The 4 words of counter (idx4, site) under the key: the bits of the flat
// elements 4*idx4 .. 4*idx4 + 3 of that site.
__device__ __forceinline__ uint4 philox4(const Drop& d, uint32_t site,
                                         unsigned long long idx4) {
  uint32_t c0 = static_cast<uint32_t>(idx4);
  uint32_t c1 = static_cast<uint32_t>(idx4 >> 32);
  uint32_t c2 = site, c3 = 0u;
  uint32_t k0 = d.key0, k1 = d.key1;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t word_of(const uint4& w, uint32_t i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// keep bit of flat element `flat` of `site`
__device__ __forceinline__ bool drop_keep(const Drop& d, uint32_t site,
                                          unsigned long long flat) {
  const uint4 w = philox4(d, site, flat >> 2);
  return word_of(w, static_cast<uint32_t>(flat & 3)) >= d.cutoff;
}

// keep bits of the flat elements `flat` and `flat + 1`, flat even (both
// come from one counter)
__device__ __forceinline__ void drop_keep2(const Drop& d, uint32_t site,
                                           unsigned long long flat, bool& k0,
                                           bool& k1) {
  const uint4 w = philox4(d, site, flat >> 2);
  const uint32_t i = static_cast<uint32_t>(flat & 3);
  k0 = word_of(w, i) >= d.cutoff;
  k1 = word_of(w, i + 1) >= d.cutoff;
}

// dropout of the pair (v0, v1) at flat elements (flat, flat + 1)
__device__ __forceinline__ void drop_pair(const Drop& d, uint32_t site,
                                          unsigned long long flat, float& v0,
                                          float& v1) {
  if (!d.on) return;
  bool k0, k1;
  drop_keep2(d, site, flat, k0, k1);
  v0 = k0 ? v0 * d.scale : 0.f;
  v1 = k1 ? v1 * d.scale : 0.f;
}

__device__ __forceinline__ float drop_one(const Drop& d, uint32_t site,
                                          unsigned long long flat, float v) {
  if (!d.on) return v;
  return drop_keep(d, site, flat) ? v * d.scale : 0.f;
}

// ===========================================================================
// bfloat16 route: mma.sync m16n8k16, ldmatrix, cp.async
// ===========================================================================

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, asynchronous; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows x cols (cols a multiple of 8) from global (row stride ldg) into
// shared (row stride lds); rows >= valid_rows become zero
__device__ __forceinline__ void cp_tile(bf16* dst, int lds, const bf16* src,
                                        size_t ldg, int rows, int cols,
                                        int valid_rows) {
  const int vecs = cols >> 3;
  for (int i = threadIdx.x; i < rows * vecs; i += blockDim.x) {
    const int r = i / vecs, c = (i - r * vecs) << 3;
    const bool ok = r < valid_rows;
    cp_async16(dst + r * lds + c, src + (ok ? r : 0) * ldg + c, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragment of rows m0..m0+15, columns k..k+15 of a row-major tile
// stored [m][k]
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* A,
                                       int lda, int m0, int k) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, A + (m0 + (lane & 15)) * lda + k + ((lane >> 4) << 3));
}

// B fragments of two n8 blocks (n0..n0+15), rows k..k+15, from a tile
// stored [k][n] (weights in the JAX layout): r[0..1] block n0, r[2..3]
// block n0 + 8
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* B,
                                          int ldb, int k, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, B + (k + (lane & 7) + (((lane >> 3) & 1) << 3)) * ldb + n0 +
                   ((lane >> 4) << 3));
}

// the same from a tile stored [n][k] (keys: one row per key; a weight
// used transposed)
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* B,
                                          int ldb, int k, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, B + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ldb + k +
                 (((lane >> 3) & 1) << 3));
}

// acc (16*MI x 8*NI warp tile at rows m0, columns n0) += A[:, 0:K] * B,
// A row-major bf16 in shared memory, B [k][n] bf16 in shared memory
template <int MI, int NI>
__device__ __forceinline__ void warp_mma_kn(float (&acc)[MI][NI][4],
                                            const bf16* A, int lda, int m0,
                                            const bf16* B, int ldb, int n0,
                                            int K) {
  static_assert(NI % 2 == 0, "B fragments come in pairs of n8 blocks");
  for (int k = 0; k < K; k += 16) {
    uint32_t a[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) load_a(a[i], A, lda, m0 + 16 * i, k);
#pragma unroll
    for (int j = 0; j < NI; j += 2) {
      uint32_t b[4];
      load_b_kn(b, B, ldb, k, n0 + 8 * j);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        mma_bf16(acc[i][j], a[i], b[0], b[1]);
        mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// Accumulator element e of tile (i, j): row m0 + 16i + lane/4 (+8 for
// e >= 2), column n0 + 8j + 2*(lane%4) + (e & 1).

// --- 16 x 16 score tiles of the attention backward kernels ---

// the 16 x 16 tile of accumulators (two n8 tiles) as the A fragment of
// the next product
__device__ __forceinline__ void pack_a(uint32_t (&a)[4],
                                       const float (&t)[2][4]) {
  a[0] = pack_bf16(t[0][0], t[0][1]);
  a[1] = pack_bf16(t[0][2], t[0][3]);
  a[2] = pack_bf16(t[1][0], t[1][1]);
  a[3] = pack_bf16(t[1][2], t[1][3]);
}

// t (16 x 16, f32) = X[r0:r0+16, :] @ Y[c0:c0+16, :]^T over HD features
// (X and Y with row stride HD + 8)
template <int HD>
__device__ __forceinline__ void tile_xyT(float (&t)[2][4], const bf16* X,
                                         int r0, const bf16* Y, int c0) {
  constexpr int ld = HD + 8;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) t[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4], b[4];
    load_a(a, X, ld, r0, 16 * kk);
    load_b_nk(b, Y, ld, 16 * kk, c0);
    mma_bf16(t[0], a, b[0], b[1]);
    mma_bf16(t[1], a, b[2], b[3]);
  }
}

// o (16 x NC) += a (16 x 16 fragment) @ Y[k0:k0+16, c0:c0+NC], Y with row
// stride ld
template <int NC>
__device__ __forceinline__ void acc_ay(float (&o)[NC / 8][4],
                                       const uint32_t (&a)[4], const bf16* Y,
                                       int ld, int k0, int c0) {
#pragma unroll
  for (int jn = 0; jn < NC / 8; jn += 2) {
    uint32_t b[4];
    load_b_kn(b, Y, ld, k0, c0 + 8 * jn);
    mma_bf16(o[jn], a, b[0], b[1]);
    mma_bf16(o[jn + 1], a, b[2], b[3]);
  }
}

// ===========================================================================
// float route: exact f32 FMA products on 32-row tiles
// ===========================================================================

constexpr int kF32Rows = 32, kF32Threads = 256;

__host__ __device__ constexpr int pad_f32(int n) { return n + 4; }

// C (M x N, ldc) = [C +] A (M x K, lda) * op(B): op(B) is B (K x N, ldb)
// or, with kBT, B^T with B stored N x K.  M and N multiples of 4; each
// thread owns 4x4 outputs.  No barrier inside.
template <bool kBT>
__device__ void block_gemm_f32(const float* A, int lda, const float* B,
                               int ldb, float* C, int ldc, int M, int N,
                               int K, bool acc) {
  const int cols = N >> 2, tiles = (M >> 2) * cols;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    const int i0 = (t / cols) << 2, j0 = (t % cols) << 2;
    float c[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        c[r][s] = acc ? C[(i0 + r) * ldc + j0 + s] : 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = A[(i0 + r) * lda + k];
#pragma unroll
      for (int s = 0; s < 4; ++s)
        b[s] = kBT ? B[(j0 + s) * ldb + k] : B[k * ldb + j0 + s];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) c[r][s] = fmaf(a[r], b[s], c[r][s]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) C[(i0 + r) * ldc + j0 + s] = c[r][s];
  }
}

// W[k0:k0+kr, n0:n0+nc] (row-major, ldw) into a shared tile (ld)
__device__ __forceinline__ void load_tile_f32(float* dst, int ld,
                                              const float* W, int ldw,
                                              int k0, int n0, int kr,
                                              int nc) {
  for (int i = threadIdx.x; i < kr * nc; i += blockDim.x) {
    const int k = i / nc, j = i - k * nc;
    dst[k * ld + j] = W[static_cast<size_t>(k0 + k) * ldw + n0 + j];
  }
}

// LN1 + qkv in f32 per 32 rows (the fused block's and the attention
// half's float forward): LN1 statistics to res, qkv NT columns at a time
__host__ __device__ constexpr size_t f32_qkv_smem(int D, int NT) {
  return align128(sizeof(float) * kF32Rows * pad_f32(D)) +
         align128(sizeof(float) * D * pad_f32(NT)) +
         align128(sizeof(float) * kF32Rows * pad_f32(NT));
}

__global__ void __launch_bounds__(kF32Threads)
    ln_qkv_f32(const float* __restrict__ x, const float* __restrict__ g1,
               const float* __restrict__ b1, const float* __restrict__ wqkv,
               float* __restrict__ qkv, float* __restrict__ res, int rows,
               int D, int N, int H, int lanes, int NT) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = pad_f32(D), ldb = pad_f32(NT), ldc = pad_f32(NT);
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + align128(sizeof(float) * kF32Rows * lda) / sizeof(float);
  float* Cs = Bs + align128(sizeof(float) * D * ldb) / sizeof(float);
  const int row0 = blockIdx.x * kF32Rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int r = warp; r < kF32Rows; r += kF32Threads / 32) {
    const int gr = row0 + r;
    float* ar = As + r * lda;
    if (gr < rows) {
      const float* xr = x + static_cast<size_t>(gr) * D;
      float mu, rstd;
      warp_row_stats(xr, D, mu, rstd);
      for (int c = lane; c < D; c += 32)
        ar[c] = (xr[c] - mu) * rstd * g1[c] + b1[c];
      if (lane == 0) {
        res[static_cast<size_t>(gr) * lanes + H] = mu;
        res[static_cast<size_t>(gr) * lanes + H + 1] = rstd;
      }
    } else {
      for (int c = lane; c < D; c += 32) ar[c] = 0.f;
    }
  }
  for (int n0 = 0; n0 < N; n0 += NT) {
    load_tile_f32(Bs, ldb, wqkv, N, 0, n0, D, NT);
    __syncthreads();
    block_gemm_f32<false>(As, lda, Bs, ldb, Cs, ldc, kF32Rows, NT, D, false);
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Rows * NT; i += blockDim.x) {
      const int r = i / NT, j = i - r * NT, gr = row0 + r;
      if (gr < rows) qkv[static_cast<size_t>(gr) * N + n0 + j] = Cs[r * ldc + j];
    }
  }
}

// Largest of 64, 32, 16 that is at most cap and divides a and b.
inline int pick_tile(int cap, int a, int b) {
  for (int t = 64; t >= 16; t >>= 1)
    if (t <= cap && a % t == 0 && b % t == 0) return t;
  return 0;
}

// ===========================================================================
// launch helpers
// ===========================================================================

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

#define DEVT_TRY(expr)                       \
  do {                                       \
    const cudaError_t e_ = (expr);           \
    if (e_ != cudaSuccess) return e_;        \
  } while (0)

}  // namespace
