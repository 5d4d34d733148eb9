// Int8 fused pre-norm ViT block forward for Hopper (sm_90a), eval only.
//
// Computes what devt_tpu/ops/quant.py:_quant_fwd_kernel computes, for
// x (B, S, D) in bfloat16 or float: the fused block of fused_block_fwd.cu
// without dropout, with the two products that read a LayerNorm output run
// in int8:
//
//   a        = LN1(x)                            (f32)
//   a_q, a_s = quantize rows of a                (int8_common.cuh's formula)
//   qkv      = (a_q @ Wqkv_q -> s32) * a_s * wqkv_s
//   att      = per head: softmax(q k^T * scale + mask) v, normalised after
//              PV, q, k, v and p rounded to x's type
//   u        = x + att @ Wo + bo                 (Wo in x's type)
//   b        = LN2(u);  b_q, b_s = quantize rows of b
//   z1       = (b_q @ W1_q -> s32) * b_s * w1_s + bb1
//   y        = u + gelu_tanh(z1) @ W2 + bb2      (W2 in x's type)
//
// Returns y alone (no residual lanes: there is no backward).
//
// Design.  Three launches, as the bf16 block: the middle one is the same
// attention launch (attention_fwd.cuh); the outer two are the bf16
// block's row-tile kernels with the LayerNorm output quantized where it
// is produced.  LN1 runs a warp per row with the row's values in
// registers, so the row's amax is one more warp reduction and the codes
// go straight to shared memory as the A tile of the int8 product.  In
// the second kernel u sits in the accumulator registers of the
// out-projection, spread over 4 warps per row; LN2's output overwrites
// it there, the amax joins the mean and the variance in the cross-warp
// reduction through shared memory, and the per-row scales of the 128-row
// tile stay in shared memory for the epilogue of the W1 product.  The
// int8 products are mma.sync m16n8k32 (K = D in steps of 32) with the
// fragment loads of int8_common.cuh; the dequantized z1 goes through
// GELU into the bf16 hidden slice, and the W2 product is the bf16 one.
//
// The float route is seven plain launches (LN+quantize rows, the tiled
// int8 product, attention, an FMA product for Wo and W2) with every
// intermediate in global memory; it exists to hold the arithmetic against
// the plain version in f32 and is on no serving path.
//
// Bound at the main-path shape (512, 208, 192, 3 heads, MLP 768,
// kv_len 197): 110.3 GOP per call, of which the qkv and W1 products
// (55.0 GOP) run at the int8 rate and the rest at the bf16 rate, against
// about 82 MB moved: operations bind it (0.084 ms on an H100 SXM).  The
// times are in PERF.md.

#include "attention_fwd.cuh"
#include "int8_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// 1. LN1, row quantize, int8 qkv product
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr size_t qkv_q8_stage() {
  return align128(D * (kQkvCols + 16));
}

template <int D>
__host__ __device__ constexpr size_t qkv_q8_smem() {
  return align128(kQkvRows * (D + 16)) + align128(sizeof(float) * kQkvRows) +
         2 * qkv_q8_stage<D>();
}

template <int D>
__global__ void __launch_bounds__(kQkvThreads)
    ln_qkv_q8(const bf16* __restrict__ x, const float* __restrict__ g1,
              const float* __restrict__ b1, const int8_t* __restrict__ wq,
              const float* __restrict__ ws, bf16* __restrict__ qkv, int rows,
              int N) {
  static_assert(D % 32 == 0, "k steps of 32 and a lane per 32 columns");
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int lda = D + 16, ldw = kQkvCols + 16, PER = D / 32;
  constexpr size_t stage = qkv_q8_stage<D>();
  int8_t* Aq = reinterpret_cast<int8_t*>(smem);
  float* rs = reinterpret_cast<float*>(smem + align128(kQkvRows * lda));
  int8_t* ring = reinterpret_cast<int8_t*>(rs) +
                 align128(sizeof(float) * kQkvRows);
  const int row0 = blockIdx.x * kQkvRows;
  const int valid = min(kQkvRows, rows - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = N / kQkvCols;

  cp_tile_bytes(ring, ldw, wq, N, D, kQkvCols, D);
  cp_async_commit();

  // LN1 and the row's int8 codes, a warp per row, the row in registers
  for (int r = warp; r < kQkvRows; r += kQkvThreads / 32) {
    int8_t* ar = Aq + r * lda;
    if (r >= valid) {
#pragma unroll
      for (int i = 0; i < PER; ++i) ar[lane + 32 * i] = 0;
      if (lane == 0) rs[r] = 0.f;
      continue;
    }
    const bf16* xr = x + static_cast<size_t>(row0 + r) * D;
    float v[PER];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      v[i] = to_f32(xr[lane + 32 * i]);
      s += v[i];
    }
    const float mu = warp_sum(s) / D;
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) var += (v[i] - mu) * (v[i] - mu);
    const float rstd = rsqrtf(warp_sum(var) / D + kLnEps);
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      v[i] = ln_value(v[i], mu, rstd, g1[c], b1[c]);
      amax = fmaxf(amax, fabsf(v[i]));
    }
    amax = warp_max(amax);
    const float inv = quant_inv(amax);
#pragma unroll
    for (int i = 0; i < PER; ++i)
      ar[lane + 32 * i] = static_cast<int8_t>(quant_code(v[i], inv));
    if (lane == 0) rs[r] = __fmul_rn(amax, kInv127);
  }

  // 64 qkv columns at a time, the next weight slice loading meanwhile;
  // 8 warps as 4 x 2, each a 32 x 32 tile
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int gq = lane >> 2, tq = lane & 3;
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      cp_tile_bytes(ring + ((c + 1) & 1) * stage, ldw,
                    wq + (c + 1) * kQkvCols, N, D, kQkvCols, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slice c (and, at c = 0, the codes) visible
    int acc[2][4][4] = {};
    warp_mma_s8<2>(acc, Aq, lda, wm, ring + (c & 1) * stage, ldw, wn, D);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm + 16 * i + gq + 8 * half;
        if (row0 + r >= rows) continue;
        float v[8];
        dequant8(v, acc[i], half, rs[r], ws + c * kQkvCols + wn);
        store8(qkv + static_cast<size_t>(row0 + r) * N + c * kQkvCols + wn +
                   8 * tq,
               v);
      }
    __syncthreads();  // slice c free for the load two steps on
  }
}

// ---------------------------------------------------------------------------
// 3. out-projection, residual, LN2, row quantize, int8 W1, GELU, W2, residual
// ---------------------------------------------------------------------------

constexpr int kFfnRows = 128, kFfnHidden = 64, kFfnSlice = 64;
constexpr int kFfnThreads = 512;

struct FfnQ8Smem {
  size_t off_h, off_red, off_ring, off_w2, stage, bytes;
};

template <int D>
__host__ __device__ constexpr FfnQ8Smem ffn_q8_smem() {
  FfnQ8Smem s{};
  // the att tile (bf16), later the int8 codes of LN2(u) in the same place
  s.off_h = align128(sizeof(bf16) * kFfnRows * (D + 8));
  s.off_red = s.off_h + align128(sizeof(bf16) * kFfnRows * (kFfnHidden + 8));
  // row partials of the sum, the variance and the amax, and the row scales
  s.off_ring = s.off_red + align128(sizeof(float) * 4 * kFfnRows * 4);
  // a stage holds W1_q[:, chunk] (D x 64 int8) then W2[chunk, :] (64 x D
  // bf16); a slice of 64 Wo rows (64 x D bf16) fits in it as well
  s.off_w2 = align128(D * (kFfnHidden + 16));
  s.stage = s.off_w2 + align128(sizeof(bf16) * kFfnHidden * (D + 8));
  s.bytes = s.off_ring + 2 * s.stage;
  return s;
}

template <int D>
__global__ void __launch_bounds__(kFfnThreads, 1)
    out_ffn_q8(const bf16* __restrict__ x, const bf16* __restrict__ att,
               const bf16* __restrict__ wo, const float* __restrict__ bo,
               const float* __restrict__ g2, const float* __restrict__ b2,
               const int8_t* __restrict__ w1q, const float* __restrict__ w1s,
               const float* __restrict__ bb1, const bf16* __restrict__ w2,
               const float* __restrict__ bb2, bf16* __restrict__ y,
               float* __restrict__ u32, int rows, int F) {
  static_assert(D % 64 == 0, "Wo slices of 64 rows");
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr FfnQ8Smem L = ffn_q8_smem<D>();
  constexpr int lda = D + 8, ldq = D + 16, ldh = kFfnHidden + 8;
  constexpr int ldw1 = kFfnHidden + 16, ldw2 = D + 8;
  constexpr int NI = D / 32;  // warp tile 32 x D/4 → NI n8 blocks
  constexpr int slices = D / kFfnSlice;
  bf16* As = reinterpret_cast<bf16*>(smem);      // att tile
  int8_t* Bq = reinterpret_cast<int8_t*>(smem);  // then the codes of LN2(u)
  bf16* Hs = reinterpret_cast<bf16*>(smem + L.off_h);       // GELU slice
  float* red = reinterpret_cast<float*>(smem + L.off_red);  // row partials
  float* row_scale = red + 3 * kFfnRows * 4;
  unsigned char* ring = smem + L.off_ring;                  // weight stages
  const int row0 = blockIdx.x * kFfnRows;
  const int valid = min(kFfnRows, rows - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3, wq = warp & 3;
  const int wm = (warp >> 2) * 32;  // 16 warps as 4 x 4 (bf16 products)
  const int wn = wq * (D / 4);
  const int zm = (warp >> 1) * 16;  // and as 8 x 2 (the int8 product)
  const int zn = (warp & 1) * 32;
  const int chunks = F / kFfnHidden;

  auto stage_at = [&](int s) { return ring + (s & 1) * L.stage; };
  auto load_wo = [&](int s) {  // Wo rows 64s..64s+63
    cp_tile(reinterpret_cast<bf16*>(stage_at(s)), ldw2,
            wo + static_cast<size_t>(s) * kFfnSlice * D, D, kFfnSlice, D,
            kFfnSlice);
  };
  auto load_ffn = [&](int step, int c) {
    cp_tile_bytes(reinterpret_cast<int8_t*>(stage_at(step)), ldw1,
                  w1q + c * kFfnHidden, F, D, kFfnHidden, D);
    cp_tile(reinterpret_cast<bf16*>(stage_at(step) + L.off_w2), ldw2,
            w2 + static_cast<size_t>(c) * kFfnHidden * D, D, kFfnHidden, D,
            kFfnHidden);
  };

  cp_tile(As, lda, att + static_cast<size_t>(row0) * D, D, kFfnRows, D,
          valid);
  load_wo(0);
  cp_async_commit();

  float acc[2][NI][4] = {};
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices)
      load_wo(s + 1);
    else
      load_ffn(s + 1, 0);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // slice s (and the att tile) visible
    warp_mma_kn<2, NI>(acc, As + kFfnSlice * s, lda, wm,
                       reinterpret_cast<bf16*>(stage_at(s)), ldw2, wn,
                       kFfnSlice);
    __syncthreads();  // slice s free; As no longer read
  }

  // u = x + (att @ Wo + bo) into acc and into u32 (f32, read back for y);
  // LN2 statistics across the 4 warps sharing each row
  float part[2][2] = {};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + 16 * i + gq + 8 * h, c = wn + 8 * j + 2 * tq;
        float u0 = 0.f, u1 = 0.f;
        if (r < valid) {
          const size_t g = static_cast<size_t>(row0 + r) * D + c;
          const __nv_bfloat162 xv =
              *reinterpret_cast<const __nv_bfloat162*>(x + g);
          u0 = __low2float(xv) + (acc[i][j][2 * h] + bo[c]);
          u1 = __high2float(xv) + (acc[i][j][2 * h + 1] + bo[c + 1]);
          *reinterpret_cast<float2*>(u32 + g) = make_float2(u0, u1);
        }
        acc[i][j][2 * h] = u0;
        acc[i][j][2 * h + 1] = u1;
        part[i][h] += u0 + u1;
      }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float p = quad_sum(part[i][h]);
      if (tq == 0) red[(wm + 16 * i + gq + 8 * h) * 4 + wq] = p;
    }
  __syncthreads();
  float mu[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* rr = red + (wm + 16 * i + gq + 8 * h) * 4;
      mu[i][h] = (rr[0] + rr[1] + rr[2] + rr[3]) / D;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const float d0 = acc[i][j][2 * h] - mu[i][h];
        const float d1 = acc[i][j][2 * h + 1] - mu[i][h];
        v += d0 * d0 + d1 * d1;
      }
      v = quad_sum(v);
      if (tq == 0) red[(kFfnRows + wm + 16 * i + gq + 8 * h) * 4 + wq] = v;
    }
  __syncthreads();
  // b = LN2(u) over acc, and the row's amax across the 4 warps
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + 16 * i + gq + 8 * h;
      const float* rr = red + (kFfnRows + r) * 4;
      const float rstd = rsqrtf((rr[0] + rr[1] + rr[2] + rr[3]) / D + kLnEps);
      float mx = 0.f;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c = wn + 8 * j + 2 * tq;
        const float v0 =
            ln_value(acc[i][j][2 * h], mu[i][h], rstd, g2[c], b2[c]);
        const float v1 = ln_value(acc[i][j][2 * h + 1], mu[i][h], rstd,
                                  g2[c + 1], b2[c + 1]);
        acc[i][j][2 * h] = v0;
        acc[i][j][2 * h + 1] = v1;
        mx = fmaxf(mx, fmaxf(fabsf(v0), fabsf(v1)));
      }
      mx = quad_max(mx);
      if (tq == 0) red[(2 * kFfnRows + r) * 4 + wq] = mx;
    }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + 16 * i + gq + 8 * h;
      const float* rr = red + (2 * kFfnRows + r) * 4;
      const float amax = fmaxf(fmaxf(rr[0], rr[1]), fmaxf(rr[2], rr[3]));
      const float inv = quant_inv(amax);
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c = wn + 8 * j + 2 * tq;
        const uint32_t q0 = quant_code(acc[i][j][2 * h], inv) & 0xff;
        const uint32_t q1 = quant_code(acc[i][j][2 * h + 1], inv) & 0xff;
        *reinterpret_cast<uint16_t*>(Bq + r * ldq + c) =
            static_cast<uint16_t>(q0 | (q1 << 8));
      }
      if (wq == 0 && tq == 0) row_scale[r] = __fmul_rn(amax, kInv127);
    }

  float yacc[2][NI][4] = {};
  for (int c = 0; c < chunks; ++c) {
    const int step = slices + c;
    if (c + 1 < chunks) {
      load_ffn(step + 1, c + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c, the codes and the row scales visible
    int z[1][4][4] = {};
    warp_mma_s8<1>(z, Bq, ldq, zm, reinterpret_cast<int8_t*>(stage_at(step)),
                   ldw1, zn, D);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = zm + gq + 8 * half;
      const int hc = c * kFfnHidden + zn;
      float v[8];
      dequant8(v, z[0], half, row_scale[r], w1s + hc);
#pragma unroll
      for (int t = 0; t < 8; ++t)
        v[t] = gelu_tanh(v[t] + bb1[hc + 8 * tq + t]);
      store8(Hs + r * ldh + zn + 8 * tq, v);
    }
    __syncthreads();  // GELU slice complete
    warp_mma_kn<2, NI>(yacc, Hs, ldh, wm,
                       reinterpret_cast<bf16*>(stage_at(step) + L.off_w2),
                       ldw2, wn, kFfnHidden);
    __syncthreads();  // chunk c and Hs free for reuse
  }

  // y = u + (h @ W2 + bb2); each thread reads back the u32 it wrote
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + 16 * i + gq + 8 * h, c = wn + 8 * j + 2 * tq;
        if (r < valid) {
          const size_t g = static_cast<size_t>(row0 + r) * D + c;
          const float2 uv = *reinterpret_cast<const float2*>(u32 + g);
          *reinterpret_cast<uint32_t*>(y + g) =
              pack_bf16(uv.x + (yacc[i][j][2 * h] + bb2[c]),
                        uv.y + (yacc[i][j][2 * h + 1] + bb2[c + 1]));
        }
      }
}

// ---------------------------------------------------------------------------
// float route: C = R + (act(A) @ B + bias) on 32-row tiles with FMA
// products; act is the identity, or gelu_tanh(a + a_bias[k]) with kGelu
// ---------------------------------------------------------------------------

__host__ __device__ constexpr size_t rows_gemm_smem(int K, int NT, int KT) {
  return align128(sizeof(float) * kF32Rows * pad_f32(K)) +
         align128(sizeof(float) * KT * pad_f32(NT)) +
         align128(sizeof(float) * kF32Rows * pad_f32(NT));
}

template <bool kGelu>
__global__ void __launch_bounds__(kF32Threads)
    rows_gemm_f32(const float* __restrict__ A, const float* __restrict__ a_bias,
                  const float* __restrict__ Bm, const float* __restrict__ bias,
                  const float* __restrict__ R, float* __restrict__ C, int M,
                  int K, int N, int NT, int KT) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = pad_f32(K), ldb = pad_f32(NT), ldc = pad_f32(NT);
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + align128(sizeof(float) * kF32Rows * lda) / sizeof(float);
  float* Cs = Bs + align128(sizeof(float) * KT * ldb) / sizeof(float);
  const int row0 = blockIdx.x * kF32Rows;

  for (int i = threadIdx.x; i < kF32Rows * K; i += blockDim.x) {
    const int r = i / K, k = i - r * K, gr = row0 + r;
    float v = 0.f;
    if (gr < M) {
      v = A[static_cast<size_t>(gr) * K + k];
      if (kGelu) v = gelu_tanh(v + a_bias[k]);
    }
    As[r * lda + k] = v;
  }
  for (int n0 = 0; n0 < N; n0 += NT) {
    for (int k0 = 0; k0 < K; k0 += KT) {
      load_tile_f32(Bs, ldb, Bm, N, k0, n0, KT, NT);
      __syncthreads();
      block_gemm_f32<false>(As + k0, lda, Bs, ldb, Cs, ldc, kF32Rows, NT, KT,
                            k0 > 0);
      __syncthreads();
    }
    for (int i = threadIdx.x; i < kF32Rows * NT; i += blockDim.x) {
      const int r = i / NT, j = i - r * NT, gr = row0 + r;
      if (gr < M) {
        const size_t g = static_cast<size_t>(gr) * N + n0 + j;
        C[g] = R[g] + (Cs[r * ldc + j] + bias[n0 + j]);
      }
    }
  }
}

template <bool kGelu>
cudaError_t launch_rows_gemm(const float* A, const float* a_bias,
                             const float* Bm, const float* bias,
                             const float* R, float* C, int M, int K, int N,
                             cudaStream_t stream) {
  const int nt = pick_tile(64, N, N), kt = pick_tile(32, K, K);
  if (!nt || !kt) return cudaErrorInvalidValue;
  const size_t bytes = rows_gemm_smem(K, nt, kt);
  if (bytes > kSmemPerBlock) return cudaErrorInvalidValue;
  DEVT_TRY(set_smem(rows_gemm_f32<kGelu>, bytes));
  rows_gemm_f32<kGelu><<<(M + kF32Rows - 1) / kF32Rows, kF32Threads, bytes,
                         stream>>>(A, a_bias, Bm, bias, R, C, M, K, N, nt, kt);
  return cudaGetLastError();
}

// ===========================================================================
// launches
// ===========================================================================

struct Args {
  const void *x, *g1, *b1, *wqkv_q, *wqkv_s, *wo, *bo, *g2, *b2, *w1_q, *w1_s,
      *bb1, *w2, *bb2;
  void *y, *qkv, *att, *lse, *u32, *codes, *row_scale, *z1;
  int B, S, D, H, F, kv_len;
  float scale;
  cudaStream_t stream;
};

template <int D, int HD>
cudaError_t launch_bf16_shape(const Args& a) {
  const int rows = a.B * a.S, N3 = 3 * D;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  auto q = [](const void* p) { return static_cast<const int8_t*>(p); };

  constexpr size_t s1 = qkv_q8_smem<D>();
  DEVT_TRY(set_smem(ln_qkv_q8<D>, s1));
  ln_qkv_q8<D><<<(rows + kQkvRows - 1) / kQkvRows, kQkvThreads, s1,
                 a.stream>>>(h(a.x), f(a.g1), f(a.b1), q(a.wqkv_q),
                             f(a.wqkv_s), static_cast<bf16*>(a.qkv), rows, N3);
  DEVT_TRY(cudaGetLastError());

  DEVT_TRY((launch_attention_bf16<HD, false>(
      h(a.qkv), static_cast<bf16*>(a.att), static_cast<float*>(a.lse), a.B,
      a.S, a.H, a.kv_len, a.H, a.scale, a.stream)));

  constexpr size_t s3 = ffn_q8_smem<D>().bytes;
  DEVT_TRY(set_smem(out_ffn_q8<D>, s3));
  out_ffn_q8<D><<<(rows + kFfnRows - 1) / kFfnRows, kFfnThreads, s3,
                  a.stream>>>(
      h(a.x), h(a.att), h(a.wo), f(a.bo), f(a.g2), f(a.b2), q(a.w1_q),
      f(a.w1_s), f(a.bb1), h(a.w2), f(a.bb2), static_cast<bf16*>(a.y),
      static_cast<float*>(a.u32), rows, a.F);
  return cudaGetLastError();
}

// the bfloat16 kernels are compiled for these widths (dim, head dim)
cudaError_t launch_bf16(const Args& a) {
  const int hd = a.D / a.H;
  if (a.F % kFfnHidden) return cudaErrorInvalidValue;
  if (a.D == 192 && hd == 64) return launch_bf16_shape<192, 64>(a);
  if (a.D == 64 && hd == 32) return launch_bf16_shape<64, 32>(a);
  return cudaErrorInvalidValue;
}

cudaError_t launch_f32(const Args& a) {
  const int d = a.D / a.H, rows = a.B * a.S;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto q = [](const void* p) { return static_cast<const int8_t*>(p); };
  int8_t* codes = static_cast<int8_t*>(a.codes);
  float* row_scale = static_cast<float*>(a.row_scale);
  float* qkv = static_cast<float*>(a.qkv);
  float* att = static_cast<float*>(a.att);
  float* u = static_cast<float*>(a.u32);
  float* z1 = static_cast<float*>(a.z1);

  DEVT_TRY((launch_quant_rows<float, true>(f(a.x), f(a.g1), f(a.b1), codes,
                                           row_scale, rows, a.D, a.stream)));
  DEVT_TRY(launch_gemm_s8<float>(codes, row_scale, q(a.wqkv_q), f(a.wqkv_s),
                                 qkv, rows, a.D, 3 * a.D, a.stream));
  DEVT_TRY(launch_attention_f32<false>(qkv, att, static_cast<float*>(a.lse),
                                       a.B, a.S, a.H, d, a.kv_len, a.H,
                                       a.scale, a.stream));
  DEVT_TRY(launch_rows_gemm<false>(att, nullptr, f(a.wo), f(a.bo), f(a.x), u,
                                   rows, a.D, a.D, a.stream));
  DEVT_TRY((launch_quant_rows<float, true>(u, f(a.g2), f(a.b2), codes,
                                           row_scale, rows, a.D, a.stream)));
  DEVT_TRY(launch_gemm_s8<float>(codes, row_scale, q(a.w1_q), f(a.w1_s), z1,
                                 rows, a.D, a.F, a.stream));
  return launch_rows_gemm<true>(z1, f(a.bb1), f(a.w2), f(a.bb2), u,
                                static_cast<float*>(a.y), rows, a.F, a.D,
                                a.stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x, y, wo and w2).  wqkv_q (D, 3D)
// and w1_q (D, F) are int8 in the (K, N) layout with their f32 column
// scales wqkv_s (3D) and w1_s (F); LN parameters and biases are f32.
// Scratch: qkv (B, S, 3D) and att (B, S, D) in x's type, lse (B, S, H) and
// u32 (B, S, D) f32; the float route also needs codes (B*S, D) int8,
// row_scale (B*S) f32 and z1 (B, S, F) f32, which the bfloat16 route
// ignores.
// Returns the CUDA error of the launches (0 on success); the launches are
// asynchronous on `stream`.
extern "C" int devt_quant_block_fwd(
    int dtype, const void* x, const void* g1, const void* b1,
    const void* wqkv_q, const void* wqkv_s, const void* wo, const void* bo,
    const void* g2, const void* b2, const void* w1_q, const void* w1_s,
    const void* bb1, const void* w2, const void* bb2, void* y, void* qkv,
    void* att, void* lse, void* u32, void* codes, void* row_scale, void* z1,
    int B, int S, int D, int H, int F, int kv_len, float scale,
    void* stream) {
  const Args a{x,    g1,  b1,  wqkv_q, wqkv_s, wo,    bo,        g2,
               b2,   w1_q, w1_s, bb1,  w2,     bb2,   y,         qkv,
               att,  lse, u32, codes,  row_scale, z1, B,         S,
               D,    H,   F,   kv_len, scale,
               static_cast<cudaStream_t>(stream)};
  if (D % H || (D / H) % 16 || D % 64 || F % 64 || kv_len < 1 || kv_len > S)
    return cudaErrorInvalidValue;
  if (dtype == 0) return launch_f32(a);
  if (dtype == 1) return launch_bf16(a);
  return cudaErrorInvalidValue;
}

extern "C" const char* devt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
