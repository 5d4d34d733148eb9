// Single-block attention backward for Hopper (sm_90a): the one body
// behind two wrappers, which differ only in how q, k, v and their
// gradients are laid out.
//
//   mha_bwd.cu    fused_mha's backward (kernel 4): packed qkv
//                 (B, S, 3, H, d), do (B, S, H, d), lse (B, S, H)
//   flash_bwd.cu  flash_attention's single-block backward (kernel 10):
//                 split q, k, v (B, H, S, d) given by strides, do, dq, dk,
//                 dv (B, H, S, d) and lse (B*H, S) contiguous
//
// Every operand is addressed by its element strides over (sequence b,
// head h, row r); the d elements of a row are contiguous.  Per (b, h):
//
//   delta = rowsum(f32(do) * f32(o))          o as stored, after dropout
//   s     = q k^T * scale, key columns >= kv_len at -1e30
//   p     = exp(s - lse)
//   mask  = keep ? 1 / (1 - rate) : 0         (1 without dropout)
//   dv    = round(p * mask)^T @ do
//   dp    = (do @ v^T) * mask
//   ds    = p * (dp - delta) * scale
//   dq    = round(ds) @ k;   dk = round(ds)^T @ q
//
// where round() is the cast to the operand type and every product sums in
// f32.  Keys at or past kv_len have p = 0 exactly, so their dk and dv are
// exact zeros.  The dropout mask (fused_mha only) is regenerated from the
// seed: Philox4x32-10 of (site kSiteAttn, flat index over (b, h, q, k)),
// as the forward draws it (attention_fwd.cuh), whatever either launch's
// grid.
//
// Design.  FlashAttention-2's split of the backward: a first launch writes
// delta, a warp per (row, head), laid out like lse; the second has the
// grid (2 * tiles, H, B).  Blocks [0, tiles) each own up to 64 queries of
// a head and compute their dq, a sum over the keys; blocks [tiles,
// 2 * tiles) each own up to 64 keys and compute their dk and dv, sums over
// the queries.  A block keeps its own rows (q and do, or k and v) in
// shared memory and streams the other side's rows (k and v, or q and do)
// through it up to 64 at a time, the next rows loading (cp.async) while a
// block works on the last ones, so shared memory does not grow with S:
// every S of a single kv block (512) fits at every head dim up to 256.
// Each output element has one owner that sums its terms in a fixed order,
// so there are no atomics and two runs give the same bits.  Inside a
// block a warp owns 16 rows and 64 output columns (the whole head below
// head dim 64); for each 16 streamed rows it recomputes its 16 x 16 score
// and dp tiles over the whole head dim (mma.sync m16n8k16, f32
// accumulation), so that its accumulators stay in registers at head dim
// 256.  The float route (the tests' f32 runs and f32 training) has the
// same split on 32-row tiles with the block-level FMA product, the scores
// in shared memory.

#pragma once

#include "attention_fwd.cuh"

namespace {

constexpr int kBwdRows = 64;  // rows a block owns, and streams at once
constexpr int kBwdMaxWarps = 16;

// element strides of a (B, H, S, d) operand: row r of head h of sequence
// b starts at b * b_ + h * h_ + r * r_
struct Strides {
  long long b_, h_, r_;
};

template <typename P>
__device__ __forceinline__ P* at(P* p, const Strides& s, int b, int h,
                                 int r) {
  return p + b * s.b_ + h * s.h_ + r * s.r_;
}

// the operands of one backward call; lse and delta share `sl`
template <typename T>
struct BwdOperands {
  const T *q, *k, *v, *dout;
  T *dq, *dk, *dv;
  const float* lse;
  float* delta;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv, sl;
};

// rows a block owns and streams: 64, or all of a shorter sequence
__host__ __device__ constexpr int bwd_rows(int Sp, int cap) {
  return Sp < cap ? Sp : cap;
}

__host__ __device__ constexpr size_t mha_bwd_smem_bf16(int Sp, int hd) {
  // own rows (2 tiles), two buffers of streamed rows (4 tiles); lse and
  // delta of the queries, padded to whole tiles
  return 6 * align128(sizeof(bf16) * bwd_rows(Sp, kBwdRows) * (hd + 8)) +
         2 * align128(sizeof(float) * round_up(Sp, bwd_rows(Sp, kBwdRows)));
}

// delta = rowsum(f32(do) * f32(o)) of every (row, head) pair, a warp each:
// o and do are (pairs, d) row-major, ordered as lse is, and delta (pairs)
template <typename T>
__global__ void __launch_bounds__(256)
    mha_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                  float* __restrict__ delta, int pairs, int d) {
  const int pair = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pair >= pairs) return;
  const size_t g = static_cast<size_t>(pair) * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32)
    acc += to_f32(dout[g + c]) * to_f32(o[g + c]);
  acc = warp_sum(acc);
  if (lane == 0) delta[pair] = acc;
}

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         int pairs, int d, cudaStream_t stream) {
  mha_bwd_delta<T><<<(pairs + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, pairs,
      d);
  return cudaGetLastError();
}

// lse and delta of queries [lo, hi) of head h into shared memory; rows
// past S get zeros
template <typename T>
__device__ __forceinline__ void load_lse_delta(float* lse_s, float* delta_s,
                                               const BwdOperands<T>& a, int b,
                                               int h, int S, int lo,
                                               int hi) {
  for (int r = lo + threadIdx.x; r < hi; r += blockDim.x) {
    const bool ok = r < S;
    const size_t g = b * a.sl.b_ + h * a.sl.h_ + (ok ? r : 0) * a.sl.r_;
    lse_s[r] = ok ? a.lse[g] : 0.f;
    delta_s[r] = ok ? a.delta[g] : 0.f;
  }
}

template <int HD, bool kDrop>
__global__ void __launch_bounds__(32 * kBwdMaxWarps)
    mha_bwd_bf16(const BwdOperands<bf16> a, int S, int H, int kv_len,
                 float scale, Drop drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = HD + 8;
  constexpr int OC = HD > 64 ? 64 : HD;  // output columns of one warp
  constexpr int kChunks = HD / OC;
  const int Sp = round_up(S, 16), R = bwd_rows(Sp, kBwdRows);
  const int tiles = (Sp + R - 1) / R;
  const int bx = blockIdx.x;
  const bool keys = bx >= tiles;  // dk and dv, else dq
  const int row0 = (keys ? bx - tiles : bx) * R;
  const size_t tile = align128(sizeof(bf16) * R * ld);
  bf16* X0 = reinterpret_cast<bf16*>(smem);             // own: q or k
  bf16* X1 = reinterpret_cast<bf16*>(smem + tile);      // own: do or v
  // streamed rows, buffer i: k or q at 2 + 2i, v or do at 3 + 2i
  float* lse_s = reinterpret_cast<float*>(smem + 6 * tile);
  float* delta_s =
      lse_s + align128(sizeof(float) * round_up(Sp, R)) / sizeof(float);
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = (warp / kChunks) * 16, oc = (warp % kChunks) * OC;
  const int live = round_up(kv_len, 16);  // keys in strips with a live key
  const int end = keys ? Sp : live;       // streamed rows
  // the warp's strip: inside the sequence, and for dk/dv with a live key
  // (strips wholly past kv_len have p = 0: dk = dv = 0)
  const bool mine = row0 + r0 < (keys ? live : Sp);
  float acc0[OC / 8][4] = {}, acc1[OC / 8][4] = {};  // dq, or dk and dv

  if (row0 < (keys ? live : Sp)) {  // else every strip of the block is dead
    const int rows = min(R, Sp - row0);
    // own rows; rows past S are zero (0 * garbage could be NaN)
    if (keys) {
      cp_tile(X0, ld, at(a.k, a.sk, b, h, row0), a.sk.r_, rows, HD,
              S - row0);
      cp_tile(X1, ld, at(a.v, a.sv, b, h, row0), a.sv.r_, rows, HD,
              S - row0);
    } else {
      cp_tile(X0, ld, at(a.q, a.sq, b, h, row0), a.sq.r_, rows, HD,
              S - row0);
      cp_tile(X1, ld, at(a.dout, a.sdo, b, h, row0), a.sdo.r_, rows, HD,
              S - row0);
    }
    // streamed rows c0.. into buffer buf
    auto stream_rows = [&](int c0, int buf) {
      const int n = min(R, end - c0);
      bf16* Y0 = reinterpret_cast<bf16*>(smem + (2 + 2 * buf) * tile);
      bf16* Y1 = reinterpret_cast<bf16*>(smem + (3 + 2 * buf) * tile);
      if (keys) {
        cp_tile(Y0, ld, at(a.q, a.sq, b, h, c0), a.sq.r_, n, HD, S - c0);
        cp_tile(Y1, ld, at(a.dout, a.sdo, b, h, c0), a.sdo.r_, n, HD,
                S - c0);
      } else {
        cp_tile(Y0, ld, at(a.k, a.sk, b, h, c0), a.sk.r_, n, HD, S - c0);
        cp_tile(Y1, ld, at(a.v, a.sv, b, h, c0), a.sv.r_, n, HD, S - c0);
      }
      cp_async_commit();
    };
    stream_rows(0, 0);  // one group with the own rows
    // the queries this block reads: its own (dq) or all of them (dk, dv)
    load_lse_delta(lse_s, delta_s, a, b, h, S, keys ? 0 : row0,
                   keys ? Sp : row0 + R);

    for (int c0 = 0, buf = 0; c0 < end; c0 += R, buf ^= 1) {
      const int n = min(R, end - c0);
      if (c0 + R < end) {
        stream_rows(c0 + R, buf ^ 1);  // its buffer was freed below
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* Y0 = reinterpret_cast<bf16*>(smem + (2 + 2 * buf) * tile);
      const bf16* Y1 = reinterpret_cast<bf16*>(smem + (3 + 2 * buf) * tile);
      if (mine && !keys) {
        // --- dq of the warp's 16 queries: a sum over the keys ---
        const int q0 = row0 + r0;
        const float lse_r[2] = {lse_s[q0 + gq], lse_s[q0 + gq + 8]};
        const float delta_r[2] = {delta_s[q0 + gq], delta_s[q0 + gq + 8]};
        for (int t = 0; t < n; t += 16) {
          float s[2][4], dp[2][4];
          tile_xyT<HD>(s, X0, r0, Y0, t);
          tile_xyT<HD>(dp, X1, r0, Y1, t);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = c0 + t + 8 * j + 2 * tq + (e & 1);
              const float p =
                  expf(s[j][e] * scale + (key < kv_len ? 0.f : kNegInf) -
                       lse_r[e >> 1]);
              float g = dp[j][e];
              if (kDrop)
                g = attn_keep(drop, b, h, H, S, q0 + gq + 8 * (e >> 1), key)
                        ? g * drop.scale
                        : 0.f;
              s[j][e] = p * (g - delta_r[e >> 1]) * scale;
            }
          uint32_t da[4];
          pack_a(da, s);
          acc_ay<OC>(acc0, da, Y0, ld, t, oc);
        }
      } else if (mine) {
        // --- dk and dv of the warp's 16 keys: sums over the queries ---
        for (int t = 0; t < n; t += 16) {
          float st[2][4], dpt[2][4], ds[2][4];
          tile_xyT<HD>(st, X0, r0, Y0, t);
          tile_xyT<HD>(dpt, X1, r0, Y1, t);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = row0 + r0 + gq + 8 * (e >> 1);
              const int q = c0 + t + 8 * j + 2 * tq + (e & 1);
              const float p =
                  q < S ? expf(st[j][e] * scale +
                               (key < kv_len ? 0.f : kNegInf) - lse_s[q])
                        : 0.f;
              float pm = p, g = dpt[j][e];
              if (kDrop) {
                const float m =
                    attn_keep(drop, b, h, H, S, q, key) ? drop.scale : 0.f;
                pm = p * m;
                g = g * m;
              }
              st[j][e] = pm;
              ds[j][e] = p * (g - delta_s[q]) * scale;
            }
          uint32_t pa[4], da[4];
          pack_a(pa, st);
          pack_a(da, ds);
          acc_ay<OC>(acc1, pa, Y1, ld, t, oc);  // dv
          acc_ay<OC>(acc0, da, Y0, ld, t, oc);  // dk
        }
      }
      __syncthreads();  // every warp is done with buffer buf
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + r0 + gq + 8 * hh;
    if (r >= S) continue;
    bf16* o0 = at(keys ? a.dk : a.dq, keys ? a.sdk : a.sdq, b, h, r) + oc +
               2 * tq;
    bf16* o1 = at(a.dv, a.sdv, b, h, r) + oc + 2 * tq;
#pragma unroll
    for (int jn = 0; jn < OC / 8; ++jn) {
      *reinterpret_cast<uint32_t*>(o0 + 8 * jn) =
          pack_bf16(acc0[jn][2 * hh], acc0[jn][2 * hh + 1]);
      if (keys)
        *reinterpret_cast<uint32_t*>(o1 + 8 * jn) =
            pack_bf16(acc1[jn][2 * hh], acc1[jn][2 * hh + 1]);
    }
  }
}

template <int HD, bool kDrop>
cudaError_t launch_bwd_bf16(const BwdOperands<bf16>& a, int B, int S, int H,
                            int kv_len, float scale, const Drop& drop,
                            cudaStream_t stream) {
  const int Sp = round_up(S, 16), R = bwd_rows(Sp, kBwdRows);
  const size_t bytes = mha_bwd_smem_bf16(Sp, HD);
  if (bytes > kSmemPerBlock) return cudaErrorInvalidValue;
  constexpr int kChunks = HD > 64 ? HD / 64 : 1;
  const int warps = (R / 16) * kChunks;  // one (strip, chunk) each, <= 16
  DEVT_TRY(set_smem(mha_bwd_bf16<HD, kDrop>, bytes));
  mha_bwd_bf16<HD, kDrop>
      <<<dim3(2 * ((Sp + R - 1) / R), H, B), 32 * warps, bytes, stream>>>(
          a, S, H, kv_len, scale, drop);
  return cudaGetLastError();
}

// the bfloat16 backward at head dim d (16, 32, 64, 128 or 256)
template <bool kDrop>
cudaError_t launch_bwd_bf16_d(const BwdOperands<bf16>& a, int B, int S,
                              int H, int d, int kv_len, float scale,
                              const Drop& drop, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_bwd_bf16<16, kDrop>(a, B, S, H, kv_len, scale, drop,
                                        stream);
    case 32:
      return launch_bwd_bf16<32, kDrop>(a, B, S, H, kv_len, scale, drop,
                                        stream);
    case 64:
      return launch_bwd_bf16<64, kDrop>(a, B, S, H, kv_len, scale, drop,
                                        stream);
    case 128:
      return launch_bwd_bf16<128, kDrop>(a, B, S, H, kv_len, scale, drop,
                                         stream);
    case 256:
      return launch_bwd_bf16<256, kDrop>(a, B, S, H, kv_len, scale, drop,
                                         stream);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// float: exact f32 FMA products, the same split on 32-row tiles
// ---------------------------------------------------------------------------

__host__ __device__ constexpr size_t mha_bwd_smem_f32(int Sp, int d) {
  // own rows, streamed rows and outputs (2 tiles each); p and ds; lse and
  // delta of the queries, padded to whole tiles
  return 6 * align128(sizeof(float) * bwd_rows(Sp, kF32Rows) * pad_f32(d)) +
         2 * align128(sizeof(float) * bwd_rows(Sp, kF32Rows) *
                      pad_f32(bwd_rows(Sp, kF32Rows))) +
         2 * align128(sizeof(float) * round_up(Sp, bwd_rows(Sp, kF32Rows)));
}

// rows [r0, r0 + n) of head h of sequence b of `src` (zero past S) into
// a shared tile with row stride ld
__device__ __forceinline__ void load_rows_f32(float* dst, int ld,
                                              const float* src,
                                              const Strides& s, int b, int h,
                                              int r0, int n, int d, int S) {
  for (int i = threadIdx.x; i < n * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    dst[r * ld + c] = r0 + r < S ? at(src, s, b, h, r0 + r)[c] : 0.f;
  }
}

template <bool kDrop>
__global__ void __launch_bounds__(kF32Threads)
    mha_bwd_f32(const BwdOperands<float> a, int S, int H, int d, int kv_len,
                float scale, Drop drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Sp = round_up(S, 16), R = bwd_rows(Sp, kF32Rows);
  const int tiles = (Sp + R - 1) / R;
  const int bx = blockIdx.x;
  const bool keys = bx >= tiles;  // dk and dv, else dq
  const int row0 = (keys ? bx - tiles : bx) * R;
  const int ldq = pad_f32(d), lds = pad_f32(R);
  const size_t tile = align128(sizeof(float) * R * ldq);
  const size_t stile = align128(sizeof(float) * R * lds);
  float* X0 = reinterpret_cast<float*>(smem);             // own: q or k
  float* X1 = reinterpret_cast<float*>(smem + tile);      // own: do or v
  float* Y0 = reinterpret_cast<float*>(smem + 2 * tile);  // streamed: k or q
  float* Y1 = reinterpret_cast<float*>(smem + 3 * tile);  // streamed: v or do
  float* O0 = reinterpret_cast<float*>(smem + 4 * tile);  // dq or dk
  float* O1 = reinterpret_cast<float*>(smem + 5 * tile);  // dv
  float* Ps = reinterpret_cast<float*>(smem + 6 * tile);
  float* DSs = reinterpret_cast<float*>(smem + 6 * tile + stile);
  float* lse_s = reinterpret_cast<float*>(smem + 6 * tile + 2 * stile);
  float* delta_s =
      lse_s + align128(sizeof(float) * round_up(Sp, R)) / sizeof(float);
  const int h = blockIdx.y, b = blockIdx.z;
  const int live = round_up(kv_len, 16);
  const int end = keys ? Sp : live;  // streamed rows

  // own rows (zero past S) and zeroed outputs
  load_rows_f32(X0, ldq, keys ? a.k : a.q, keys ? a.sk : a.sq, b, h, row0,
                R, d, S);
  load_rows_f32(X1, ldq, keys ? a.v : a.dout, keys ? a.sv : a.sdo, b, h,
                row0, R, d, S);
  for (int i = threadIdx.x; i < R * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    O0[r * ldq + c] = 0.f;
    O1[r * ldq + c] = 0.f;
  }
  load_lse_delta(lse_s, delta_s, a, b, h, S, keys ? 0 : row0,
                 keys ? Sp : row0 + R);
  // dk/dv tiles wholly past kv_len have p = 0: dk = dv = 0
  if (row0 < (keys ? live : Sp)) {
    for (int c0 = 0; c0 < end; c0 += R) {
      const int n = min(R, end - c0);
      __syncthreads();  // own rows, lse and delta; the last products done
      load_rows_f32(Y0, ldq, keys ? a.q : a.k, keys ? a.sq : a.sk, b, h, c0,
                    n, d, S);
      load_rows_f32(Y1, ldq, keys ? a.dout : a.v, keys ? a.sdo : a.sv, b, h,
                    c0, n, d, S);
      __syncthreads();
      // scores and dp: q k^T and do v^T (dq), or their transposes (dk, dv)
      block_gemm_f32<true>(X0, ldq, Y0, ldq, Ps, lds, R, n, d, false);
      block_gemm_f32<true>(X1, ldq, Y1, ldq, DSs, lds, R, n, d, false);
      __syncthreads();
      for (int i = threadIdx.x; i < R * n; i += blockDim.x) {
        const int r = i / n, j = i - r * n;
        const int q = keys ? c0 + j : row0 + r, k = keys ? row0 + r : c0 + j;
        const float p = q < S ? expf(Ps[r * lds + j] * scale +
                                     (k < kv_len ? 0.f : kNegInf) - lse_s[q])
                              : 0.f;
        float pm = p, g = DSs[r * lds + j];
        if (kDrop) {
          const float m = attn_keep(drop, b, h, H, S, q, k) ? drop.scale : 0.f;
          pm = p * m;
          g = g * m;
        }
        Ps[r * lds + j] = pm;
        DSs[r * lds + j] = p * (g - delta_s[q]) * scale;
      }
      __syncthreads();
      // dq += ds k, or dk += ds^T q and dv += (p * mask)^T do
      block_gemm_f32<false>(DSs, lds, Y0, ldq, O0, ldq, R, d, n, true);
      if (keys)
        block_gemm_f32<false>(Ps, lds, Y1, ldq, O1, ldq, R, d, n, true);
    }
  }
  __syncthreads();
  const int rows = min(R, S - row0);
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    if (!keys) {
      at(a.dq, a.sdq, b, h, row0 + r)[c] = O0[r * ldq + c];
    } else {
      at(a.dk, a.sdk, b, h, row0 + r)[c] = O0[r * ldq + c];
      at(a.dv, a.sdv, b, h, row0 + r)[c] = O1[r * ldq + c];
    }
  }
}

template <bool kDrop>
cudaError_t launch_bwd_f32(const BwdOperands<float>& a, int B, int S, int H,
                           int d, int kv_len, float scale, const Drop& drop,
                           cudaStream_t stream) {
  const int Sp = round_up(S, 16), R = bwd_rows(Sp, kF32Rows);
  const size_t bytes = mha_bwd_smem_f32(Sp, d);
  if (d % 4 || bytes > kSmemPerBlock) return cudaErrorInvalidValue;
  DEVT_TRY(set_smem(mha_bwd_f32<kDrop>, bytes));
  mha_bwd_f32<kDrop><<<dim3(2 * ((Sp + R - 1) / R), H, B), kF32Threads,
                       bytes, stream>>>(a, S, H, d, kv_len, scale, drop);
  return cudaGetLastError();
}

}  // namespace
