// Packed-qkv multi-head attention backward for Hopper (sm_90a).
//
// Computes what devt_tpu/ops/flash_attention.py:_mha_bwd_kernel computes
// (the backward of fused_mha), from qkv (B, S, 3*H*d), the stored output o
// and its gradient do (B, S, H*d), all three in qkv's type, and lse
// (B, S, H) f32, per (sequence, head):
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
// f32.  dq, dk and dv go to dqkv (B, S, 3*H*d) in qkv's type, in the
// packed (3, H, d) column order.  Keys at or past kv_len have p = 0
// exactly, so their dk and dv are exact zeros.  The dropout mask is
// regenerated from the seed: Philox4x32-10 of (site kSiteAttn, flat index
// over (b, h, q, k)), as the forward draws it (attention_fwd.cuh), whatever
// either launch's grid.
//
// Design.  FlashAttention-2's split of the backward: a first launch writes
// delta (B, S, H) f32, a warp per (row, head); the second has the grid
// (2 * tiles, H, B).  Blocks [0, tiles) each own up to 64 queries
// of a head and compute their dq, a sum over the keys; blocks [tiles,
// 2 * tiles) each own up to 64 keys and compute their dk and dv, sums over
// the queries.  A block keeps its own rows (q and do, or k and v) in
// shared memory and streams the other side's rows (k and v, or q and do)
// through it up to 64 at a time, the next rows loading (cp.async) while a
// block works on the last ones, so shared memory does not grow with S:
// every S the forward takes fits, and every S of a single kv block (512).
// Each output element has one owner that sums its terms in a fixed order,
// so there are no atomics and two runs give the same bits.  Inside a
// block a warp owns 16 rows and 64 output columns (the whole head below
// head dim 64); for each 16 streamed rows it recomputes its 16 x 16 score
// and dp tiles over the whole head dim (mma.sync m16n8k16, f32
// accumulation), so that its accumulators stay in registers at head dim
// 256.  At PTN's S = 14 and d = 256 a block owns one 16-row strip in 4
// column chunks: 4 warps, 2 blocks per (head, sequence).  The float route
// (the tests' f32 runs and f32 training) has the same split on 32-row
// tiles with the block-level FMA product, the scores in shared memory.
//
// Bound at the PTN training shape (B = 32, S = 14, kv_len 14, H = 8,
// d = 256, bf16): 5 products of 2 * S * kv_len * d operations per head,
// 0.13 GFLOP, against 14.7 MB read and written (qkv, o, do, lse, dqkv):
// bytes bind it, 0.0044 ms at 3.35 TB/s.  A block reads its own rows once
// and the streamed rows once (from L2 after the first block of a head), o
// is read once by the delta launch; what the design leaves on the table at
// S = 14 is parallelism, since 512 blocks of 4 warps keep most of the
// card idle.  The times are in PERF.md.

#include "attention_fwd.cuh"

namespace {

constexpr int kBwdRows = 64;  // rows a block owns, and streams at once
constexpr int kBwdMaxWarps = 16;

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
// o and do are (pairs, d) row-major, delta (pairs) like lse
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
cudaError_t launch_delta(const void* o, const void* dout, void* delta,
                         int pairs, int d, cudaStream_t stream) {
  mha_bwd_delta<T><<<(pairs + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), pairs, d);
  return cudaGetLastError();
}

// lse and delta of queries [lo, hi) of head h into shared memory; rows
// past S get zeros
__device__ __forceinline__ void load_lse_delta(
    float* lse_s, float* delta_s, const float* __restrict__ lse,
    const float* __restrict__ delta, size_t seq0, int S, int H, int h,
    int lo, int hi) {
  for (int r = lo + threadIdx.x; r < hi; r += blockDim.x) {
    const bool ok = r < S;
    const size_t g = (seq0 + (ok ? r : 0)) * H + h;
    lse_s[r] = ok ? lse[g] : 0.f;
    delta_s[r] = ok ? delta[g] : 0.f;
  }
}

template <int HD, bool kDrop>
__global__ void __launch_bounds__(32 * kBwdMaxWarps)
    mha_bwd_bf16(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dqkv,
                 int S, int H, int kv_len, float scale, Drop drop) {
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
  const int Dt = H * HD, N3 = 3 * Dt;
  const size_t seq0 = static_cast<size_t>(b) * S;
  const bf16* base = qkv + seq0 * N3;
  const bf16* dbase = dout + seq0 * Dt + h * HD;
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
    const size_t own = static_cast<size_t>(row0);
    const int rows = min(R, Sp - row0);
    // own rows; rows past S are zero (0 * garbage could be NaN)
    cp_tile(X0, ld, base + own * N3 + (keys ? H + h : h) * HD, N3, rows, HD,
            S - row0);
    if (keys)
      cp_tile(X1, ld, base + own * N3 + (2 * H + h) * HD, N3, rows, HD,
              S - row0);
    else
      cp_tile(X1, ld, dbase + own * Dt, Dt, rows, HD, S - row0);
    // streamed rows c0.. into buffer buf
    auto stream_rows = [&](int c0, int buf) {
      const int n = min(R, end - c0);
      const size_t at = static_cast<size_t>(c0);
      bf16* Y0 = reinterpret_cast<bf16*>(smem + (2 + 2 * buf) * tile);
      bf16* Y1 = reinterpret_cast<bf16*>(smem + (3 + 2 * buf) * tile);
      if (keys) {
        cp_tile(Y0, ld, base + at * N3 + h * HD, N3, n, HD, S - c0);
        cp_tile(Y1, ld, dbase + at * Dt, Dt, n, HD, S - c0);
      } else {
        cp_tile(Y0, ld, base + at * N3 + (H + h) * HD, N3, n, HD, S - c0);
        cp_tile(Y1, ld, base + at * N3 + (2 * H + h) * HD, N3, n, HD,
                S - c0);
      }
      cp_async_commit();
    };
    stream_rows(0, 0);  // one group with the own rows
    // the queries this block reads: its own (dq) or all of them (dk, dv)
    load_lse_delta(lse_s, delta_s, lse, delta, seq0, S, H, h,
                   keys ? 0 : row0, keys ? Sp : row0 + R);

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
    bf16* row = dqkv + (seq0 + r) * N3 + oc + 2 * tq;
#pragma unroll
    for (int jn = 0; jn < OC / 8; ++jn) {
      if (!keys) {
        *reinterpret_cast<uint32_t*>(row + h * HD + 8 * jn) =
            pack_bf16(acc0[jn][2 * hh], acc0[jn][2 * hh + 1]);
      } else {
        *reinterpret_cast<uint32_t*>(row + (H + h) * HD + 8 * jn) =
            pack_bf16(acc0[jn][2 * hh], acc0[jn][2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(row + (2 * H + h) * HD + 8 * jn) =
            pack_bf16(acc1[jn][2 * hh], acc1[jn][2 * hh + 1]);
      }
    }
  }
}

template <int HD, bool kDrop>
cudaError_t launch_bwd_bf16(const void* qkv, const void* dout,
                            const void* lse, const void* delta, void* dqkv,
                            int B, int S, int H, int kv_len, float scale,
                            const Drop& drop, cudaStream_t stream) {
  const int Sp = round_up(S, 16), R = bwd_rows(Sp, kBwdRows);
  const size_t bytes = mha_bwd_smem_bf16(Sp, HD);
  if (bytes > kSmemPerBlock) return cudaErrorInvalidValue;
  constexpr int kChunks = HD > 64 ? HD / 64 : 1;
  const int warps = (R / 16) * kChunks;  // one (strip, chunk) each, <= 16
  DEVT_TRY(set_smem(mha_bwd_bf16<HD, kDrop>, bytes));
  mha_bwd_bf16<HD, kDrop>
      <<<dim3(2 * ((Sp + R - 1) / R), H, B), 32 * warps, bytes, stream>>>(
          static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<bf16*>(dqkv), S, H, kv_len, scale, drop);
  return cudaGetLastError();
}

template <int HD>
cudaError_t run_bf16(const void* qkv, const void* dout, const void* lse,
                     const void* delta, void* dqkv, int B, int S, int H,
                     int kv_len, float scale, const Drop& drop,
                     cudaStream_t stream) {
  if (drop.on)
    return launch_bwd_bf16<HD, true>(qkv, dout, lse, delta, dqkv, B, S, H,
                                     kv_len, scale, drop, stream);
  return launch_bwd_bf16<HD, false>(qkv, dout, lse, delta, dqkv, B, S, H,
                                    kv_len, scale, drop, stream);
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

template <bool kDrop>
__global__ void __launch_bounds__(kF32Threads)
    mha_bwd_f32(const float* __restrict__ qkv,
                const float* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dqkv,
                int S, int H, int d, int kv_len, float scale, Drop drop) {
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
  const int Dt = H * d, N3 = 3 * Dt;
  const size_t seq0 = static_cast<size_t>(b) * S;
  const int live = round_up(kv_len, 16);
  const int end = keys ? Sp : live;  // streamed rows

  // own rows (zero past S) and zeroed outputs
  for (int i = threadIdx.x; i < R * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    const bool ok = row0 + r < S;
    const size_t g = seq0 + (ok ? row0 + r : 0);
    X0[r * ldq + c] = ok ? qkv[g * N3 + ((keys ? H : 0) + h) * d + c] : 0.f;
    X1[r * ldq + c] = ok ? (keys ? qkv[g * N3 + (2 * H + h) * d + c]
                                 : dout[g * Dt + h * d + c])
                         : 0.f;
    O0[r * ldq + c] = 0.f;
    O1[r * ldq + c] = 0.f;
  }
  load_lse_delta(lse_s, delta_s, lse, delta, seq0, S, H, h, keys ? 0 : row0,
                 keys ? Sp : row0 + R);
  // dk/dv tiles wholly past kv_len have p = 0: dk = dv = 0
  if (row0 < (keys ? live : Sp)) {
    for (int c0 = 0; c0 < end; c0 += R) {
      const int n = min(R, end - c0);
      __syncthreads();  // own rows, lse and delta; the last products done
      for (int i = threadIdx.x; i < n * d; i += blockDim.x) {
        const int r = i / d, c = i - r * d;
        const bool ok = c0 + r < S;
        const size_t g = seq0 + (ok ? c0 + r : 0);
        Y0[r * ldq + c] =
            ok ? qkv[g * N3 + ((keys ? 0 : H) + h) * d + c] : 0.f;
        Y1[r * ldq + c] = ok ? (keys ? dout[g * Dt + h * d + c]
                                     : qkv[g * N3 + (2 * H + h) * d + c])
                             : 0.f;
      }
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
    float* out = dqkv + (seq0 + row0 + r) * N3 + h * d + c;
    if (!keys) {
      out[0] = O0[r * ldq + c];
    } else {
      out[Dt] = O0[r * ldq + c];
      out[2 * Dt] = O1[r * ldq + c];
    }
  }
}

template <bool kDrop>
cudaError_t launch_bwd_f32(const void* qkv, const void* dout, const void* lse,
                           const void* delta, void* dqkv, int B, int S, int H,
                           int d, int kv_len, float scale, const Drop& drop,
                           cudaStream_t stream) {
  const int Sp = round_up(S, 16), R = bwd_rows(Sp, kF32Rows);
  const size_t bytes = mha_bwd_smem_f32(Sp, d);
  if (bytes > kSmemPerBlock) return cudaErrorInvalidValue;
  DEVT_TRY(set_smem(mha_bwd_f32<kDrop>, bytes));
  mha_bwd_f32<kDrop><<<dim3(2 * ((Sp + R - 1) / R), H, B), kF32Threads,
                       bytes, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dqkv), S, H, d, kv_len, scale, drop);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  qkv and dqkv (B, S, 3*H*d), o and do
// (B, S, H*d) in that type, lse (B, S, H) f32, delta (B, S, H) f32 scratch
// that the first launch fills; rate in [0, 1) and the forward's seed.  The
// bfloat16 kernel is compiled for head dims 16, 32, 64, 128 and 256, the
// float kernel takes any multiple of 4; shared memory holds up to 64 rows
// (float: 32) of a head at a time and grows with S only by lse and delta.
// Returns the CUDA error of the launches (0 on success, invalid value for
// a shape that is not covered); they are asynchronous on `stream`.
extern "C" int devt_mha_bwd(int dtype, const void* qkv, const void* o,
                            const void* dout, const void* lse, void* delta,
                            void* dqkv, int B, int S, int H, int d,
                            int kv_len, float scale, double rate,
                            unsigned long long seed, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1 || kv_len < 1 || kv_len > S || rate < 0.0 ||
      rate >= 1.0 || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  const Drop drop = make_drop(rate, seed);
  const int pairs = B * S * H;
  if (dtype == 0) {
    if (d % 4 || mha_bwd_smem_f32(round_up(S, 16), d) > kSmemPerBlock)
      return cudaErrorInvalidValue;
    DEVT_TRY(launch_delta<float>(o, dout, delta, pairs, d, s));
    return drop.on ? launch_bwd_f32<true>(qkv, dout, lse, delta, dqkv, B, S,
                                          H, d, kv_len, scale, drop, s)
                   : launch_bwd_f32<false>(qkv, dout, lse, delta, dqkv, B, S,
                                           H, d, kv_len, scale, drop, s);
  }
  if (d != 16 && d != 32 && d != 64 && d != 128 && d != 256)
    return cudaErrorInvalidValue;
  DEVT_TRY(launch_delta<bf16>(o, dout, delta, pairs, d, s));
  switch (d) {
    case 16:
      return run_bf16<16>(qkv, dout, lse, delta, dqkv, B, S, H, kv_len, scale,
                          drop, s);
    case 32:
      return run_bf16<32>(qkv, dout, lse, delta, dqkv, B, S, H, kv_len, scale,
                          drop, s);
    case 64:
      return run_bf16<64>(qkv, dout, lse, delta, dqkv, B, S, H, kv_len, scale,
                          drop, s);
    case 128:
      return run_bf16<128>(qkv, dout, lse, delta, dqkv, B, S, H, kv_len,
                           scale, drop, s);
    default:
      return run_bf16<256>(qkv, dout, lse, delta, dqkv, B, S, H, kv_len,
                           scale, drop, s);
  }
}

extern "C" const char* devt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
