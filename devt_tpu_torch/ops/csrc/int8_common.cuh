// Device code shared by the int8 kernels for Hopper (sm_90a): the fused
// int8 matmul (int8_matmul.cu) and the int8 fused ViT block
// (quant_block_fwd.cu).
//
//   * dynamic per-row quantization, the TPU kernels' formula:
//       inv = 127 / max(amax, 1e-8);  q = round_half_even(x * inv)  (no
//       clip: |x| * 127 / amax <= 127 by construction);  scale = amax/127
//     taken as amax * (1/127);
//   * mma.sync m16n8k32 s8 x s8 -> s32 with its fragment loads.  The A
//     fragment of an int8 tile stored [m][k] is the bf16 ldmatrix pattern
//     on 16-byte groups.  Weights keep the (K, N) layout of the JAX
//     package, n contiguous, whereas the B fragment wants 4 consecutive k
//     in one register, and ldmatrix cannot transpose bytes.  So a thread
//     reads one 32-bit word (4 columns) from each of 4 k rows and
//     transposes the 4 x 4 bytes with prmt, which yields the B fragments
//     of four n8 blocks at once.  That fixes which column an accumulator
//     element belongs to (load_b_s8 below): a thread ends up with 8
//     consecutive output columns per row, one 16-byte store in bf16;
//   * a row kernel (optional LayerNorm, then quantize) and a tiled int8
//     product with the dequantizing epilogue acc * row scale * column
//     scale, which int8_matmul.cu launches as its two stages (the product
//     for row-major weight codes; K-major ones take gemm_s8_sm90.cuh).
//     The float route of quant_block_fwd.cu reuses the row kernel; its
//     bf16 route takes the quantizer's formula (quant_inv, quant_code,
//     ln_value) into its own LayerNorm epilogues.
//
// The int32 sums are exact, so given the same int8 codes a product here
// and its plain PyTorch version agree bit for bit.

#pragma once

#include "fused_block_common.cuh"

namespace {

constexpr float kQuantEps = 1e-8f;
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

__device__ __forceinline__ float quant_inv(float amax) {
  return 127.0f / fmaxf(amax, kQuantEps);
}

__device__ __forceinline__ int quant_code(float v, float inv) {
  return __float2int_rn(__fmul_rn(v, inv));
}

// LayerNorm output with the plain version's roundings (no fused
// multiply-add): ((x - mu) * rstd) * g + b
__device__ __forceinline__ float ln_value(float x, float mu, float rstd,
                                          float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), rstd), g), b);
}

// c (16x8 s32) += a (16x32 s8, row) * b (32x8 s8, col)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows m0..m0+15, contraction bytes k..k+31 of an int8 tile
// stored [m][k] with a row stride of lda bytes (a multiple of 16)
__device__ __forceinline__ void load_a_s8(uint32_t (&a)[4], const int8_t* A,
                                          int lda, int m0, int k) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, reinterpret_cast<const bf16*>(A + (m0 + (lane & 15)) * lda + k +
                                           ((lane >> 4) << 4)));
}

// B fragments of the four n8 blocks of the 32-column group at n0, for the
// contraction bytes k..k+31, from an int8 tile stored [k][n] (row stride
// ldb bytes, a multiple of 4; n0 a multiple of 4).  Block j takes the
// columns n0 + 4*g + j, g = 0..7, so accumulator element e of block j is
// column n0 + 8 * (lane % 4) + 4 * (e & 1) + j (its row is lane / 4, +8 for
// e >= 2, as for any mma accumulator): for a fixed lane the 8 columns of
// (e & 1, j) are consecutive.
__device__ __forceinline__ void load_b_s8(uint32_t (&b)[4][2], const int8_t* B,
                                          int ldb, int k, int n0) {
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int8_t* p = B + (k + 16 * h + 4 * tq) * ldb + n0 + 4 * gq;
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + ldb);
    const uint32_t w2 = *reinterpret_cast<const uint32_t*>(p + 2 * ldb);
    const uint32_t w3 = *reinterpret_cast<const uint32_t*>(p + 3 * ldb);
    // 4 x 4 byte transpose: word i holds row k+i, byte j column 4*g + j
    const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
    const uint32_t t1 = __byte_perm(w2, w3, 0x5140);
    const uint32_t t2 = __byte_perm(w0, w1, 0x7362);
    const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
    b[0][h] = __byte_perm(t0, t1, 0x5410);
    b[1][h] = __byte_perm(t0, t1, 0x7632);
    b[2][h] = __byte_perm(t2, t3, 0x5410);
    b[3][h] = __byte_perm(t2, t3, 0x7632);
  }
}

// acc (16*MI x 32 warp tile at rows m0, columns n0) += A[:, 0:K] * B,
// A int8 [m][k], B int8 [k][n], both in shared memory; K a multiple of 32
template <int MI>
__device__ __forceinline__ void warp_mma_s8(int (&acc)[MI][4][4],
                                            const int8_t* A, int lda, int m0,
                                            const int8_t* B, int ldb, int n0,
                                            int K) {
  for (int k = 0; k < K; k += 32) {
    uint32_t a[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) load_a_s8(a[i], A, lda, m0 + 16 * i, k);
    uint32_t b[4][2];
    load_b_s8(b, B, ldb, k, n0);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
  }
}

// rows x row_bytes (a multiple of 16) from global (row stride ldg bytes)
// into shared (row stride lds bytes); rows >= valid_rows become zero
__device__ __forceinline__ void cp_tile_bytes(int8_t* dst, int lds,
                                              const int8_t* src, size_t ldg,
                                              int rows, int row_bytes,
                                              int valid_rows) {
  const int vecs = row_bytes >> 4;
  for (int i = threadIdx.x; i < rows * vecs; i += blockDim.x) {
    const int r = i / vecs, c = (i - r * vecs) << 4;
    const bool ok = r < valid_rows;
    cp_async16(dst + r * lds + c, src + (ok ? r : 0) * ldg + c, ok);
  }
}

// The 8 dequantized values acc * row_scale * col_scale[c] of one lane's
// row of a 32-column group (columns 8 * (lane % 4) .. + 7 of the group),
// from the accumulators of the four n8 blocks; half = 0 for the row
// lane / 4, 1 for the row 8 below.  col_scale points at the group.
__device__ __forceinline__ void dequant8(float (&v)[8], const int (&acc)[4][4],
                                         int half, float row_scale,
                                         const float* col_scale) {
  const int c0 = 8 * (threadIdx.x & 3);
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[4 * e + j] = __fmul_rn(
          __fmul_rn(static_cast<float>(acc[j][2 * half + e]), row_scale),
          col_scale[c0 + 4 * e + j]);
}

__device__ __forceinline__ void store8(bf16* dst, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// ---------------------------------------------------------------------------
// row kernel: [LayerNorm,] quantize each row of (rows, K) into int8 codes
// and an f32 scale; a warp per row
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;

template <typename Src, bool kLN>
__global__ void __launch_bounds__(kRowThreads)
    quant_rows(const Src* __restrict__ x, const float* __restrict__ g,
               const float* __restrict__ b, int8_t* __restrict__ q,
               float* __restrict__ scale, int rows, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kRowThreads / 32) + warp;
  if (row >= rows) return;
  const Src* xr = x + static_cast<size_t>(row) * K;
  float mu = 0.f, rstd = 1.f;
  if (kLN) warp_row_stats(xr, K, mu, rstd);
  auto value = [&](int c) {
    const float v = to_f32(xr[c]);
    return kLN ? ln_value(v, mu, rstd, g[c], b[c]) : v;
  };
  float amax = 0.f;
  for (int c = lane; c < K; c += 32) amax = fmaxf(amax, fabsf(value(c)));
  amax = warp_max(amax);
  const float inv = quant_inv(amax);
  int8_t* qr = q + static_cast<size_t>(row) * K;
  for (int c = lane; c < K; c += 32)
    qr[c] = static_cast<int8_t>(quant_code(value(c), inv));
  if (lane == 0) scale[row] = __fmul_rn(amax, kInv127);
}

template <typename Src, bool kLN>
cudaError_t launch_quant_rows(const Src* x, const float* g, const float* b,
                              int8_t* q, float* scale, int rows, int K,
                              cudaStream_t stream) {
  const int per_block = kRowThreads / 32;
  quant_rows<Src, kLN><<<(rows + per_block - 1) / per_block, kRowThreads, 0,
                         stream>>>(x, g, b, q, scale, rows, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// C (M, N) = (A (M, K) int8 @ W (K, N) int8 -> s32) * a_scale[m] * w_scale[n]
// 128-row tiles, 8 warps as WM x WN, each warp 128/WM rows x 32 columns;
// K in steps of 64 through a three-stage cp.async ring.
// ---------------------------------------------------------------------------

constexpr int kGemmRows = 128, kGemmK = 64, kGemmStages = 3;
constexpr int kGemmThreads = 256;

template <int WN>
__host__ __device__ constexpr size_t gemm_s8_stage() {
  return align128(kGemmRows * (kGemmK + 16)) +
         align128(kGemmK * (32 * WN + 16));
}

template <int WM, int WN, typename Out>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_s8(const int8_t* __restrict__ A, const float* __restrict__ a_scale,
            const int8_t* __restrict__ W, const float* __restrict__ w_scale,
            Out* __restrict__ C, int M, int K, int N) {
  static_assert(WM * WN == kGemmThreads / 32, "8 warps");
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int BN = 32 * WN, MI = kGemmRows / (16 * WM);
  constexpr int lda = kGemmK + 16, ldb = BN + 16;
  constexpr size_t stage = gemm_s8_stage<WN>();
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kGemmRows;
  const int valid = min(kGemmRows, M - m0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp / WN) * (16 * MI), wn = (warp % WN) * 32;
  const int nk = K / kGemmK;

  auto a_tile = [&](int s) {
    return reinterpret_cast<int8_t*>(smem + (s % kGemmStages) * stage);
  };
  auto b_tile = [&](int s) {
    return a_tile(s) + align128(kGemmRows * lda);
  };
  auto load = [&](int kt) {
    cp_tile_bytes(a_tile(kt), lda,
                  A + static_cast<size_t>(m0) * K + kt * kGemmK, K, kGemmRows,
                  kGemmK, valid);
    cp_tile_bytes(b_tile(kt), ldb,
                  W + static_cast<size_t>(kt) * kGemmK * N + n0, N, kGemmK,
                  BN, kGemmK);
  };

  for (int s = 0; s < kGemmStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  int acc[MI][4][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kGemmStages - 2>();
    __syncthreads();  // tile kt visible; the stage of tile kt - 1 is free
    if (kt + kGemmStages - 1 < nk) load(kt + kGemmStages - 1);
    cp_async_commit();
    warp_mma_s8<MI>(acc, a_tile(kt), lda, wm, b_tile(kt), ldb, wn, kGemmK);
  }

  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wm + 16 * i + gq + 8 * half;
      if (r >= M) continue;
      float v[8];
      dequant8(v, acc[i], half, a_scale[r], w_scale + n0 + wn);
      store8(C + static_cast<size_t>(r) * N + n0 + wn + 8 * tq, v);
    }
}

// N a multiple of 64 and K of 64; N a multiple of 128 takes 128-column
// tiles, else 64-column ones
template <typename Out>
cudaError_t launch_gemm_s8(const int8_t* A, const float* a_scale,
                           const int8_t* W, const float* w_scale, Out* C,
                           int M, int K, int N, cudaStream_t stream) {
  if (M < 1 || K % kGemmK || N % 64) return cudaErrorInvalidValue;
  const int row_tiles = (M + kGemmRows - 1) / kGemmRows;
  if (N % 128 == 0) {
    constexpr size_t bytes = kGemmStages * gemm_s8_stage<4>();
    DEVT_TRY(set_smem(gemm_s8<2, 4, Out>, bytes));
    gemm_s8<2, 4, Out><<<dim3(N / 128, row_tiles), kGemmThreads, bytes,
                         stream>>>(A, a_scale, W, w_scale, C, M, K, N);
  } else {
    constexpr size_t bytes = kGemmStages * gemm_s8_stage<2>();
    DEVT_TRY(set_smem(gemm_s8<4, 2, Out>, bytes));
    gemm_s8<4, 2, Out><<<dim3(N / 64, row_tiles), kGemmThreads, bytes,
                         stream>>>(A, a_scale, W, w_scale, C, M, K, N);
  }
  return cudaGetLastError();
}

}  // namespace
