// Backward pieces shared by the fused ViT-block backward (kernel 2,
// fused_block_bwd.cu) and the attention half's backward (kernel 8,
// attn_half.cu), for Hopper (sm_90a):
//
//   * block_attention_bwd_bf16: the attention recompute and backward, the
//     route written once: where block_bwd_on_wgmma says (bfloat16, head
//     dim 16-64, at most 256 live keys: every main-path shape), the
//     recompute of att, do and delta from the stored lse on the one-shot
//     forward's wgmma body, then kernels 12's and 13's wgmma bodies
//     (flash_bwd_sm90.cuh, kBwdBlock); elsewhere attention_bwd_bf16, per
//     (head, sequence), q, k, v and datt of the head in shared memory;
//   * reduce_parts: the fixed-order sums of the partials, cast to each
//     gradient's type (no atomics: two runs give the same bits);
//   * the float route's generic FMA product and elementwise kernels, and
//     the attention backward batched over (sequence, head) on them.
//
// The bfloat16 products of both backwards (the row tiles with their
// LayerNorm epilogues and the weight gradients) are block_sm90.cuh's.
// Everything sits in an anonymous namespace, as in fused_block_common.cuh.

#pragma once

#include "flash_bwd_sm90.cuh"
#include "fused_block_common.cuh"

namespace {

// kernel 7's out-projection (attn_half.cu): 64-row tiles, 8 warps as 2
// (rows) x 4 (columns), 64-row Wo slices; the float route's column
// partials cover kTileRows rows and its weight gradients kSplitRows
constexpr int kTileRows = 64;
constexpr int kRowThreads = 256;
constexpr int kSlice = 64;
constexpr int kSplitRows = 2048;

// ===========================================================================
// bfloat16 route
// ===========================================================================

// ---------------------------------------------------------------------------
// attention recompute and backward
// ---------------------------------------------------------------------------

constexpr int kAttnMaxWarps = 16;

__host__ __device__ constexpr size_t attn_bwd_smem(int S, int hd) {
  return 4 * align128(sizeof(bf16) * S * (hd + 8)) +
         2 * align128(sizeof(float) * S);
}

template <int HD>
__global__ void __launch_bounds__(32 * kAttnMaxWarps)
    attention_bwd_bf16(const bf16* __restrict__ qkv,
                       const float* __restrict__ datt,
                       const float* __restrict__ res, bf16* __restrict__ att,
                       bf16* __restrict__ dqkv, int S, int H, int kv_len,
                       int lanes, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = HD + 8;
  const size_t tile = align128(sizeof(bf16) * S * ld);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + tile);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 2 * tile);
  bf16* DOs = reinterpret_cast<bf16*>(smem + 3 * tile);
  float* lse_s = reinterpret_cast<float*>(smem + 4 * tile);
  float* delta_s = lse_s + align128(sizeof(float) * S) / sizeof(float);
  const int h = blockIdx.x, b = blockIdx.y;
  const int Dt = H * HD, N3 = 3 * Dt;
  const size_t seq0 = static_cast<size_t>(b) * S;
  const bf16* base = qkv + seq0 * N3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int strips = S / 16;
  const int key_strips = (kv_len + 15) / 16;  // strips holding a live key

  cp_tile(Qs, ld, base + h * HD, N3, S, HD, S);
  cp_tile(Ks, ld, base + (H + h) * HD, N3, S, HD, S);
  cp_tile(Vs, ld, base + (2 * H + h) * HD, N3, S, HD, S);
  cp_async_commit();
  // datt of this head, rounded to the operand type
  for (int i = threadIdx.x; i < S * (HD / 2); i += blockDim.x) {
    const int r = i / (HD / 2), c = (i - r * (HD / 2)) * 2;
    const float2 v = *reinterpret_cast<const float2*>(
        datt + (seq0 + r) * Dt + h * HD + c);
    *reinterpret_cast<uint32_t*>(DOs + r * ld + c) = pack_bf16(v.x, v.y);
  }
  for (int r = threadIdx.x; r < S; r += blockDim.x)
    lse_s[r] = res[(seq0 + r) * lanes + h];
  cp_async_wait<0>();
  __syncthreads();

  // --- the warp owns 16 queries: o, delta and att, then dq ---
  for (int strip = warp; strip < strips; strip += nwarps) {
    const int r0 = strip * 16;
    const float lse0 = lse_s[r0 + gq], lse1 = lse_s[r0 + gq + 8];
    float o[HD / 8][4] = {};
    for (int kb = 0; kb < key_strips; ++kb) {
      const int kc = kb * 16;
      float s[2][4];
      tile_xyT<HD>(s, Qs, r0, Ks, kc);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kc + 8 * j + 2 * tq + (e & 1);
          s[j][e] = expf(s[j][e] * scale + (key < kv_len ? 0.f : kNegInf) -
                         (e < 2 ? lse0 : lse1));
        }
      uint32_t pa[4];
      pack_a(pa, s);
      acc_ay<HD>(o, pa, Vs, ld, kc, 0);
    }
    float delta[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const size_t row = seq0 + r0 + gq + 8 * hh;
#pragma unroll
      for (int jn = 0; jn < HD / 8; ++jn) {
        const int c = h * HD + 8 * jn + 2 * tq;
        const float2 dv =
            *reinterpret_cast<const float2*>(datt + row * Dt + c);
        delta[hh] += dv.x * o[jn][2 * hh] + dv.y * o[jn][2 * hh + 1];
        *reinterpret_cast<uint32_t*>(att + row * Dt + c) =
            pack_bf16(o[jn][2 * hh], o[jn][2 * hh + 1]);
      }
      delta[hh] = quad_sum(delta[hh]);
      if (tq == 0) delta_s[r0 + gq + 8 * hh] = delta[hh];
    }
    float dq[HD / 8][4] = {};
    for (int kb = 0; kb < key_strips; ++kb) {
      const int kc = kb * 16;
      float s[2][4], dp[2][4];
      tile_xyT<HD>(s, Qs, r0, Ks, kc);
      tile_xyT<HD>(dp, DOs, r0, Vs, kc);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kc + 8 * j + 2 * tq + (e & 1);
          const float p =
              expf(s[j][e] * scale + (key < kv_len ? 0.f : kNegInf) -
                   (e < 2 ? lse0 : lse1));
          s[j][e] = p * (dp[j][e] - delta[e >> 1]) * scale;
        }
      uint32_t da[4];
      pack_a(da, s);
      acc_ay<HD>(dq, da, Ks, ld, kc, 0);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const size_t row = seq0 + r0 + gq + 8 * hh;
#pragma unroll
      for (int jn = 0; jn < HD / 8; ++jn)
        *reinterpret_cast<uint32_t*>(dqkv + row * N3 + h * HD + 8 * jn +
                                     2 * tq) =
            pack_bf16(dq[jn][2 * hh], dq[jn][2 * hh + 1]);
    }
  }
  __syncthreads();  // delta of every query

  // --- the warp owns 16 keys: dk and dv from the transposed scores ---
  for (int strip = warp; strip < strips; strip += nwarps) {
    const int k0 = strip * 16;
    float dk[HD / 8][4] = {}, dv[HD / 8][4] = {};
    if (strip < key_strips) {
      for (int qb = 0; qb < strips; ++qb) {
        const int qc = qb * 16;
        float st[2][4], dpt[2][4];
        tile_xyT<HD>(st, Ks, k0, Qs, qc);
        tile_xyT<HD>(dpt, Vs, k0, DOs, qc);
        float ds[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + gq + 8 * (e >> 1);
            const int q = qc + 8 * j + 2 * tq + (e & 1);
            const float p =
                expf(st[j][e] * scale + (key < kv_len ? 0.f : kNegInf) -
                     lse_s[q]);
            st[j][e] = p;
            ds[j][e] = p * (dpt[j][e] - delta_s[q]) * scale;
          }
        uint32_t pa[4], da[4];
        pack_a(pa, st);
        pack_a(da, ds);
        acc_ay<HD>(dv, pa, DOs, ld, qc, 0);
        acc_ay<HD>(dk, da, Qs, ld, qc, 0);
      }
    }
    // strips wholly past kv_len have p = 0: their dk and dv are 0
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const size_t row = seq0 + k0 + gq + 8 * hh;
#pragma unroll
      for (int jn = 0; jn < HD / 8; ++jn) {
        const int c = 8 * jn + 2 * tq;
        *reinterpret_cast<uint32_t*>(dqkv + row * N3 + (H + h) * HD + c) =
            pack_bf16(dk[jn][2 * hh], dk[jn][2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(dqkv + row * N3 + (2 * H + h) * HD + c) =
            pack_bf16(dv[jn][2 * hh], dv[jn][2 * hh + 1]);
      }
    }
  }
}

// the attention backward of kernels 2 and 8 in bfloat16: att and dqkv from
// the packed qkv scratch, the f32 datt and lse at lane h of the residual
// rows; dout (B*H*S*HD bf16) and delta (B*H*S f32) are the wgmma route's
// scratch
template <int HD>
cudaError_t block_attention_bwd_bf16(const bf16* qkv, const float* datt,
                                     const float* res, bf16* att, bf16* dqkv,
                                     bf16* dout, float* delta, int B, int S,
                                     int H, int kv_len, int lanes,
                                     float scale, cudaStream_t stream) {
  if (block_bwd_on_wgmma(1, HD, kv_len))
    return launch_block_attention_bwd<HD>(qkv, datt, res, att, dqkv, dout,
                                          delta, B, S, H, kv_len, lanes,
                                          scale, stream);
  const size_t bytes = attn_bwd_smem(S, HD);
  if (bytes > kSmemPerBlock) return cudaErrorInvalidValue;
  const int warps = min(S / 16, kAttnMaxWarps);
  DEVT_TRY(set_smem(attention_bwd_bf16<HD>, bytes));
  attention_bwd_bf16<HD><<<dim3(H, B), 32 * warps, bytes, stream>>>(
      qkv, datt, res, att, dqkv, S, H, kv_len, lanes, scale);
  return cudaGetLastError();
}

// ===========================================================================
// fixed-order sums of the partials, cast to the gradient's type
// ===========================================================================

constexpr int kSegments = 11;

struct Segment {
  const float* part;  // [parts][n]
  void* out;
  int n, parts, out_bf16;
};

struct Segments {
  Segment s[kSegments];
};

// A block takes 32 consecutive elements of a segment at a time; warp w sums
// parts w, w + 8, ... in index order, then the 8 warps' sums are added in
// warp order: a fixed order, so two runs give the same bits, and 256
// threads share a segment of 192 elements and 832 parts.
__global__ void __launch_bounds__(256) reduce_parts(Segments segs) {
  __shared__ float red[8][32];
  const Segment g = segs.s[blockIdx.y];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int base = blockIdx.x * 32; base < g.n; base += gridDim.x * 32) {
    const int i = base + lane;
    float sum = 0.f;
    if (i < g.n)
      for (int p = w; p < g.parts; p += 8)
        sum += g.part[static_cast<size_t>(p) * g.n + i];
    red[w][lane] = sum;
    __syncthreads();
    if (w == 0 && i < g.n) {
      float total = 0.f;
      for (int k = 0; k < 8; ++k) total += red[k][lane];
      if (g.out_bf16)
        static_cast<bf16*>(g.out)[i] = __float2bfloat16(total);
      else
        static_cast<float*>(g.out)[i] = total;
    }
    __syncthreads();
  }
}

// ===========================================================================
// float route: FMA products and elementwise kernels, every intermediate
// in global memory
// ===========================================================================

// C = op(A) @ op(B) for each batch entry z = z1 * nb2 + z2 (element
// offsets z1 * x1 + z2 * x2).  op(A) is M x K: A stored [m][k], or [k][m]
// with ta.  op(B) is K x N: B stored [k][n], or [n][k] with tb.  With
// k_total > 0 entry z contracts over rows z*K .. min((z+1)*K, k_total):
// the split weight gradient.
struct Gemm32 {
  const float *A, *B;
  float* C;
  int M, N, K, lda, ldb, ldc, ta, tb, nb2;
  long long a1, a2, b1, b2, c1, c2;
  int k_total;
};

constexpr int kG32Tile = 64, kG32K = 16, kG32Threads = 256;

__global__ void __launch_bounds__(kG32Threads) gemm_f32(Gemm32 g) {
  __shared__ float As[kG32K][kG32Tile + 4];
  __shared__ float Bs[kG32K][kG32Tile + 4];
  const int z = blockIdx.z, z1 = z / g.nb2, z2 = z % g.nb2;
  const float* A = g.A + z1 * g.a1 + z2 * g.a2;
  const float* B = g.B + z1 * g.b1 + z2 * g.b2;
  float* C = g.C + z1 * g.c1 + z2 * g.c2;
  int K = g.K;
  if (g.k_total > 0) K = min(g.K, g.k_total - z * g.K);
  const int m0 = blockIdx.y * kG32Tile, n0 = blockIdx.x * kG32Tile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float c[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kG32K) {
    for (int i = threadIdx.x; i < kG32K * kG32Tile; i += kG32Threads) {
      int k, m;
      if (g.ta) {
        m = i % kG32Tile;
        k = i / kG32Tile;
      } else {
        k = i % kG32K;
        m = i / kG32K;
      }
      const bool ok = m0 + m < g.M && k0 + k < K;
      const size_t at =
          g.ta ? static_cast<size_t>(k0 + k) * g.lda + m0 + m
               : static_cast<size_t>(m0 + m) * g.lda + k0 + k;
      As[k][m] = ok ? A[at] : 0.f;
      int n;
      if (g.tb) {
        k = i % kG32K;
        n = i / kG32K;
      } else {
        n = i % kG32Tile;
        k = i / kG32Tile;
      }
      const bool okb = n0 + n < g.N && k0 + k < K;
      const size_t bt =
          g.tb ? static_cast<size_t>(n0 + n) * g.ldb + k0 + k
               : static_cast<size_t>(k0 + k) * g.ldb + n0 + n;
      Bs[k][n] = okb ? B[bt] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kG32K; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[kk][ty * 4 + r];
#pragma unroll
      for (int s = 0; s < 4; ++s) b[s] = Bs[kk][tx * 4 + s];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) c[r][s] = fmaf(a[r], b[s], c[r][s]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int m = m0 + ty * 4 + r, n = n0 + tx * 4 + s;
      if (m < g.M && n < g.N) C[static_cast<size_t>(m) * g.ldc + n] = c[r][s];
    }
}

cudaError_t run_gemm32(const Gemm32& g, int batches, cudaStream_t stream) {
  const dim3 grid((g.N + kG32Tile - 1) / kG32Tile,
                  (g.M + kG32Tile - 1) / kG32Tile, batches);
  gemm_f32<<<grid, kG32Threads, 0, stream>>>(g);
  return cudaGetLastError();
}

// one plain product, no batch
cudaError_t gemm32(const float* A, int lda, int ta, const float* B, int ldb,
                   int tb, float* C, int ldc, int M, int N, int K,
                   cudaStream_t stream) {
  const Gemm32 g{A, B, C, M, N, K, lda, ldb, ldc, ta, tb, 1,
                 0, 0, 0, 0, 0, 0, 0};
  return run_gemm32(g, 1, stream);
}

// xhat = (src - mu) * rstd and out = xhat * g + b, a warp per row
__global__ void ln_apply_f32(const float* __restrict__ src,
                             const float* __restrict__ res, int stat,
                             int lanes, const float* __restrict__ g,
                             const float* __restrict__ b,
                             float* __restrict__ xhat, float* __restrict__ out,
                             int rows, int D) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const size_t r = static_cast<size_t>(row);
  const float mu = res[r * lanes + stat], rstd = res[r * lanes + stat + 1];
  for (int c = lane; c < D; c += 32) {
    const float xh = (src[r * D + c] - mu) * rstd;
    xhat[r * D + c] = xh;
    out[r * D + c] = xh * g[c] + b[c];
  }
}

// out = resid + rstd * (dv*g - mean(dv*g) - xhat * mean(dv*g*xhat)), a
// warp per row
__global__ void ln_bwd_f32(const float* __restrict__ dv,
                           const float* __restrict__ xhat,
                           const float* __restrict__ res, int stat, int lanes,
                           const float* __restrict__ g,
                           const float* __restrict__ resid,
                           float* __restrict__ out, int rows, int D) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const size_t r = static_cast<size_t>(row);
  const float rstd = res[r * lanes + stat + 1];
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float e = dv[r * D + c] * g[c];
    s1 += e;
    s2 += e * xhat[r * D + c];
  }
  const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
  for (int c = lane; c < D; c += 32) {
    const float xh = xhat[r * D + c];
    out[r * D + c] =
        resid[r * D + c] + rstd * (dv[r * D + c] * g[c] - m1 - xh * m2);
  }
}

// part[tile][c] = sum over the tile's kTileRows rows of A[r][c] (* Bm[r][c])
__global__ void colsum_f32(const float* __restrict__ A,
                           const float* __restrict__ Bm,
                           float* __restrict__ part, int rows, int n) {
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const int r0 = blockIdx.x * kTileRows, r1 = min(rows, r0 + kTileRows);
  float sum = 0.f;
  for (int r = r0; r < r1; ++r) {
    const size_t at = static_cast<size_t>(r) * n + c;
    sum += Bm ? A[at] * Bm[at] : A[at];
  }
  part[static_cast<size_t>(blockIdx.x) * n + c] = sum;
}

// p = exp(s * scale + mask - lse) in place, a warp per (sequence, head,
// query) row of the S x S scores
__global__ void attn_p_f32(float* __restrict__ s, const float* __restrict__ res,
                           int total, int S, int H, int kv_len, int lanes,
                           float scale) {
  const int id = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (id >= total) return;
  const int lane = threadIdx.x & 31;
  const int q = id % S, bh = id / S, h = bh % H, b = bh / H;
  const float lse = res[(static_cast<size_t>(b) * S + q) * lanes + h];
  float* row = s + static_cast<size_t>(id) * S;
  for (int k = lane; k < S; k += 32)
    row[k] = expf(row[k] * scale + (k < kv_len ? 0.f : kNegInf) - lse);
}

// ds = p * (dp - delta) * scale in place over dp, delta = sum(datt * att)
// over the head's features
__global__ void attn_ds_f32(float* __restrict__ dp, const float* __restrict__ p,
                            const float* __restrict__ datt,
                            const float* __restrict__ att, int total, int S,
                            int H, int hd, float scale) {
  const int id = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (id >= total) return;
  const int lane = threadIdx.x & 31;
  const int q = id % S, bh = id / S, h = bh % H, b = bh / H;
  const size_t at = (static_cast<size_t>(b) * S + q) * (H * hd) + h * hd;
  float d = 0.f;
  for (int i = lane; i < hd; i += 32) d += datt[at + i] * att[at + i];
  const float delta = warp_sum(d);
  const size_t row = static_cast<size_t>(id) * S;
  for (int k = lane; k < S; k += 32)
    dp[row + k] = p[row + k] * (dp[row + k] - delta) * scale;
}

// part[tile][c]: the column sums of A (* Bm) over each 64-row tile
cudaError_t colsum32(const float* A, const float* Bm, float* part, int rows,
                     int n, cudaStream_t st) {
  colsum_f32<<<dim3((rows + kTileRows - 1) / kTileRows, (n + 255) / 256), 256,
               0, st>>>(A, Bm, part, rows, n);
  return cudaGetLastError();
}

// part[split] = A[rows of split]^T @ Bm[same rows] (A rows x M, Bm rows x
// N), splits of kSplitRows rows: the float route's weight gradient
cudaError_t wgrad32(const float* A, int M, const float* Bm, int N,
                    float* part, int rows, cudaStream_t st) {
  const Gemm32 g{A, Bm, part, M, N, kSplitRows, M, N, N, 1, 0, 1,
                 static_cast<long long>(kSplitRows) * M, 0,
                 static_cast<long long>(kSplitRows) * N, 0,
                 static_cast<long long>(M) * N, 0, rows};
  return run_gemm32(g, (rows + kSplitRows - 1) / kSplitRows, st);
}

// att and dqkv of the attention recompute and backward, batched over
// (sequence, head) with every intermediate in global memory: s and dp are
// (B*H, S, S) f32 scratch; p = exp(s * scale + mask - lse) with lse at
// res[row * lanes + h]
cudaError_t attention_bwd_f32(const float* qkv, const float* datt,
                              const float* res, float* att, float* dqkv,
                              float* sbuf, float* dpbuf, int B, int S, int D,
                              int H, int kv_len, int lanes, float scale,
                              cudaStream_t st) {
  const int hd = D / H, N3 = 3 * D;
  const int bh = B * H, att_rows = bh * S;
  const long long seq3 = static_cast<long long>(S) * N3;
  const long long seq1 = static_cast<long long>(S) * D;
  const long long ss = static_cast<long long>(S) * S;
  auto batched = [&](const float* A, int lda, int ta, long long a1,
                     long long a2, const float* Bm, int ldb, int tb,
                     long long b1, long long b2, float* C, int ldc,
                     long long c1, long long c2, int M, int N, int K) {
    const Gemm32 g{A, Bm, C, M, N, K, lda, ldb, ldc, ta, tb, H,
                   a1, a2, b1, b2, c1, c2, 0};
    return run_gemm32(g, bh, st);
  };
  const float *q = qkv, *k = qkv + D, *v = qkv + 2 * D;
  // s = q k^T, then p in place
  DEVT_TRY(batched(q, N3, 0, seq3, hd, k, N3, 1, seq3, hd, sbuf, S, ss * H, ss,
                   S, S, hd));
  attn_p_f32<<<(att_rows + 7) / 8, 256, 0, st>>>(sbuf, res, att_rows, S, H,
                                                 kv_len, lanes, scale);
  DEVT_TRY(cudaGetLastError());
  // att = p v;  dv = p^T datt;  dp = datt v^T
  DEVT_TRY(batched(sbuf, S, 0, ss * H, ss, v, N3, 0, seq3, hd, att, D, seq1,
                   hd, S, hd, S));
  DEVT_TRY(batched(sbuf, S, 1, ss * H, ss, datt, D, 0, seq1, hd, dqkv + 2 * D,
                   N3, seq3, hd, S, hd, S));
  DEVT_TRY(batched(datt, D, 0, seq1, hd, v, N3, 1, seq3, hd, dpbuf, S, ss * H,
                   ss, S, S, hd));
  attn_ds_f32<<<(att_rows + 7) / 8, 256, 0, st>>>(dpbuf, sbuf, datt, att,
                                                  att_rows, S, H, hd, scale);
  DEVT_TRY(cudaGetLastError());
  // dq = ds k;  dk = ds^T q
  DEVT_TRY(batched(dpbuf, S, 0, ss * H, ss, k, N3, 0, seq3, hd, dqkv, N3, seq3,
                   hd, S, hd, S));
  return batched(dpbuf, S, 1, ss * H, ss, q, N3, 0, seq3, hd, dqkv + D, N3,
                 seq3, hd, S, hd, S);
}

}  // namespace
