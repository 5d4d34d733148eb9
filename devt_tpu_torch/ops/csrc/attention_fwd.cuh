// Single-block multi-head attention forward on the packed qkv layout, for
// Hopper (sm_90a): the streamed attention bodies behind three wrappers.
//
//   fused_block_fwd.cu   the middle launch of the fused ViT block
//   quant_block_fwd.cu   the same launch inside the int8 fused block
//   mha_fwd.cu           fused_mha, the packed-qkv attention on its own
//
// qkv is (B, S, 3*H*HD) with columns ordered (3, H, HD); per (sequence,
// head): s = q k^T * scale with key columns >= kv_len at -1e30,
// p = exp(s - max s), l = sum p, lse = max s + log l.  The two callers
// round in different places, as their TPU kernels do, and take different
// bodies:
//
//   attention_bf16        o = (round(p) @ v) / l   (fused_block._mha_fwd)
//   attention_bf16_tiled  o = round(p / l) @ v     (_mha_fwd_kernel)
//
// where round() is the cast to v's type.  In the tiled body (fused_mha),
// with kDrop (_mha_fwd_kernel's dropout_rate > 0) the normalised p of
// (sequence b, head h, query q, key k) is then kept, times 1 / (1 - rate),
// where the Philox bits of site kSiteAttn at the flat index
// ((b*H + h)*S + q)*S + k pass the cutoff, and is 0 elsewhere: the mask
// depends on the seed and the element alone, so the backward (mha_bwd.cu)
// regenerates it, and the TPU wrapper's need for one grid grouping in both
// passes (_mha_group(bwd=rate > 0)) does not arise.  lse is taken before
// the mask.  The float body below serves both roundings, by kNormFirst
// (true: fused_mha's, with kDrop its dropout).
//
// attention_bf16, the fused blocks' (which take it past the one-shot wgmma
// body's 256 keys): the softmax is one-shot (exact row max first), so the
// scores are recomputed per pass instead of kept: a pass over the keys for
// the max, then the product, l summed in its first pass.  Head dims above
// 64 take the product attn_out_cols(HD) output columns at a time, so the
// accumulators stay in registers.  K and V of one head sit in shared memory
// whole; key blocks wholly past kv_len are skipped (their probabilities
// are exactly 0).  lse goes to lse[row * lanes + h]: the residual lanes of
// the fused block, or a (B, S, H) scratch with lanes = H.

#pragma once

#include "fused_block_common.cuh"

namespace {

// dynamic shared memory one block may ask for on sm_90
constexpr size_t kSmemPerBlock = 232448;

// output columns of one product pass (forward) or of one warp's chunk
// (attention_bwd.cuh) at head dim hd: the whole head up to 64, else 64 where
// 64 divides the head, and 32 where it does not (224 = 7 x 32), so that the
// last pass ends at the head's last column and not in the next head's
__host__ __device__ constexpr int attn_out_cols(int hd) {
  return hd <= 64 ? hd : hd % 64 == 0 ? 64 : 32;
}

// whether a warp holds its 16 queries' q fragments in registers for the
// whole block (HD / 4 registers); past head dim 256 (448: 112 registers
// beside the accumulators) it reads them from Qs at each k-step instead
__host__ __device__ constexpr bool attn_q_in_regs(int hd) { return hd <= 256; }

// ---------------------------------------------------------------------------
// bfloat16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int kAttnQ = 64, kAttnKeys = 32, kAttnThreads = 128;

// keep bit of the attention probability (b, h, q, k) of a call over H
// heads and S tokens
__device__ __forceinline__ bool attn_keep(const Drop& d, int b, int h, int H,
                                          int S, int q, int k) {
  const unsigned long long flat =
      ((static_cast<unsigned long long>(b) * H + h) * S + q) * S + k;
  return drop_keep(d, kSiteAttn, flat);
}

__host__ __device__ constexpr size_t attn_smem_bf16(int hd, int kv_len) {
  return align128(sizeof(bf16) * kAttnQ * (hd + 8)) +
         2 * align128(sizeof(bf16) * round_up(kv_len, kAttnKeys) * (hd + 8));
}

// scores of the warp's 16 queries against keys kc..kc+31 (f32, unscaled)
template <int HD>
__device__ __forceinline__ void score_block(float (&s)[4][4],
                                            const uint32_t (&qa)[HD / 16][4],
                                            const bf16* Ks, int kc) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      uint32_t b[4];
      load_b_nk(b, Ks, HD + 8, 16 * kk, kc + 8 * j);
      mma_bf16(s[j], qa[kk], b[0], b[1]);
      mma_bf16(s[j + 1], qa[kk], b[2], b[3]);
    }
}

// the same with q's fragments read from shared memory (rows r0.. of Qs)
// at each k-step
template <int HD>
__device__ __forceinline__ void score_block_smem(float (&s)[4][4],
                                                 const bf16* Qs, int r0,
                                                 const bf16* Ks, int kc) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    load_a(a, Qs, HD + 8, r0, 16 * kk);
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      uint32_t b[4];
      load_b_nk(b, Ks, HD + 8, 16 * kk, kc + 8 * j);
      mma_bf16(s[j], a, b[0], b[1]);
      mma_bf16(s[j + 1], a, b[2], b[3]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kAttnThreads)
    attention_bf16(const bf16* __restrict__ qkv, bf16* __restrict__ att,
                   float* __restrict__ lse, int S, int H, int kv_len,
                   int lanes, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = HD + 8;
  constexpr int OC = attn_out_cols(HD);  // output columns per product pass
  static_assert(HD % OC == 0, "the passes cover the head exactly");
  constexpr bool kQRegs = attn_q_in_regs(HD);
  const int kp = round_up(kv_len, kAttnKeys);  // keys staged and visited
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(
      smem + align128(sizeof(bf16) * kAttnQ * ld));
  bf16* Vs = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(Ks) +
                                     align128(sizeof(bf16) * kp * ld));
  const int q0 = blockIdx.x * kAttnQ, h = blockIdx.y, b = blockIdx.z;
  const int N3 = 3 * H * HD;
  const bf16* base = qkv + static_cast<size_t>(b) * S * N3;

  // q of head h at column h*HD, k at (H+h)*HD, v at (2H+h)*HD; rows past
  // S are zero (V's must be: 0 * garbage could be NaN)
  cp_tile(Qs, ld, base + static_cast<size_t>(q0) * N3 + h * HD, N3, kAttnQ,
          HD, S - q0);
  cp_tile(Ks, ld, base + (H + h) * HD, N3, kp, HD, S);
  cp_tile(Vs, ld, base + (2 * H + h) * HD, N3, kp, HD, S);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  if (q0 + r0 >= S) return;  // no barrier follows
  const int gq = lane >> 2, tq = lane & 3;

  uint32_t qa[kQRegs ? HD / 16 : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) load_a(qa[kk], Qs, ld, r0, 16 * kk);
  }
  // scores of the warp's queries against keys kc..kc+31
  auto scores = [&](float(&s)[4][4], int kc) {
    if constexpr (kQRegs)
      score_block<HD>(s, qa, Ks, kc);
    else
      score_block_smem<HD>(s, Qs, r0, Ks, kc);
  };

  // masked, scaled score of accumulator element e of n8 block j
  auto masked = [&](float s, int kc, int j, int e) {
    const int key = kc + 8 * j + 2 * tq + (e & 1);
    return s * scale + (key < kv_len ? 0.f : kNegInf);
  };

  // pass 1: exact row max of the masked, scaled scores
  float m[2] = {-3.0e38f, -3.0e38f};
  for (int kc = 0; kc < kp; kc += kAttnKeys) {
    float s[4][4];
    scores(s, kc);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        m[e >> 1] = fmaxf(m[e >> 1], masked(s[j][e], kc, j, e));
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);

  // l = sum exp(s - m) in f32, summed during the first product pass
  float l[2] = {0.f, 0.f};
  const int HDt = H * HD;
#pragma unroll 1
  for (int oc = 0; oc < HD; oc += OC) {
    // o += bf16(p) @ v[:, oc:oc+OC]
    float o[OC / 8][4] = {};
    for (int kc = 0; kc < kp; kc += kAttnKeys) {
      float s[4][4];
      scores(s, kc);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(masked(s[j][e], kc, j, e) - m[e >> 1]);
          if (oc == 0) l[e >> 1] += p;
          s[j][e] = p;
        }
      // the accumulator layout of two n8 score tiles is the A layout of
      // one k16 probability fragment
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int jn = 0; jn < OC / 8; jn += 2) {
          uint32_t bv[4];
          load_b_kn(bv, Vs, ld, kc + 16 * kk, oc + 8 * jn);
          mma_bf16(o[jn], pa, bv[0], bv[1]);
          mma_bf16(o[jn + 1], pa, bv[2], bv[3]);
        }
      }
    }
    if (oc == 0) {
      l[0] = quad_sum(l[0]);
      l[1] = quad_sum(l[1]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q = q0 + r0 + gq + 8 * hh;
      if (q >= S) continue;
      const size_t row = static_cast<size_t>(b) * S + q;
#pragma unroll
      for (int jn = 0; jn < OC / 8; ++jn)
        *reinterpret_cast<uint32_t*>(att + row * HDt + h * HD + oc + 8 * jn +
                                     2 * tq) =
            pack_bf16(o[jn][2 * hh] / l[hh], o[jn][2 * hh + 1] / l[hh]);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int q = q0 + r0 + gq + 8 * hh;
    if (q < S && tq == 0)
      lse[(static_cast<size_t>(b) * S + q) * lanes + h] = m[hh] + logf(l[hh]);
  }
}

template <int HD>
cudaError_t launch_attention_bf16(const bf16* qkv, bf16* att, float* lse,
                                  int B, int S, int H, int kv_len, int lanes,
                                  float scale, cudaStream_t stream) {
  const size_t bytes = attn_smem_bf16(HD, kv_len);
  if (bytes > kSmemPerBlock) return cudaErrorInvalidValue;
  DEVT_TRY(set_smem(attention_bf16<HD>, bytes));
  attention_bf16<HD>
      <<<dim3((S + kAttnQ - 1) / kAttnQ, H, B), kAttnThreads, bytes, stream>>>(
          qkv, att, lse, S, H, kv_len, lanes, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 with K and V streamed: fused_mha's streamed route
// ---------------------------------------------------------------------------
//
// The body above keeps a head's K and V whole, which would cap kv_len at
// 160 at head dim 256, 64 at 448.  This one holds the block's 64 queries
// and streams K (and V's columns of the current output pass) through a
// two-stage cp.async ring of kAttnKeys-key tiles, so its shared memory does
// not depend on S: 126 KB at 448, 65 KB at 224.  The schedule is one loop
// of steps over (pass, key tile):
//
//   pass 0         an online pass over the key tiles: each lane keeps a
//                  running max of its masked, scaled scores and their sum
//                  of exp(s - max), rescaled when the max rises; at the
//                  last tile the quad's partials combine into the row's m
//                  and l, and lse = m + log l is written
//   pass 1 + i     output columns [i*OC, (i+1)*OC), OC = attn_out_cols(HD):
//                  the scores again, p = exp(s - m) / l (normalised before
//                  the product, as _mha_fwd_kernel rounds),
//                  dropout, then round(p) @ v[:, i*OC:(i+1)*OC]; the
//                  warp's 16 x OC accumulators (32 floats a lane at 448)
//                  are stored at the pass's last tile
//
// so the output accumulator is never the whole 64 x 448 f32 tile (115 KB,
// 224 floats a lane): the scores are recomputed once a pass instead.  The
// next step's tiles load while a step computes.  A warp whose queries lie
// past S still loads and meets every barrier, and computes nothing.
// Bound: at (2, 512, 2688), 2 heads of 448, about 1.9 GFLOP of products
// against 7.3 MB moved (qkv read, o and lse written): bytes bind it, at
// about 2 us; the recomputed scores (8 passes) and the 32 blocks of the
// grid keep it far from that.  The times are in PERF.md.

__host__ __device__ constexpr size_t attn_tiled_smem_bf16(int hd) {
  return align128(sizeof(bf16) * kAttnQ * (hd + 8)) +
         2 * align128(sizeof(bf16) * kAttnKeys * (hd + 8)) +
         2 * align128(sizeof(bf16) * kAttnKeys * (attn_out_cols(hd) + 8));
}

template <int HD, bool kDrop>
__global__ void __launch_bounds__(kAttnThreads)
    attention_bf16_tiled(const bf16* __restrict__ qkv, bf16* __restrict__ att,
                         float* __restrict__ lse, int S, int H, int kv_len,
                         float scale, Drop drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = HD + 8;
  constexpr int OC = attn_out_cols(HD);
  constexpr int ldv = OC + 8;
  constexpr int kPasses = HD / OC;
  static_assert(HD % OC == 0, "the passes cover the head exactly");
  constexpr bool kQRegs = attn_q_in_regs(HD);
  constexpr size_t kQBytes = align128(sizeof(bf16) * kAttnQ * ld);
  constexpr size_t kKBytes = align128(sizeof(bf16) * kAttnKeys * ld);
  constexpr size_t kVBytes = align128(sizeof(bf16) * kAttnKeys * ldv);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  auto Ks = [&](int buf) {
    return reinterpret_cast<bf16*>(smem + kQBytes + buf * kKBytes);
  };
  auto Vs = [&](int buf) {
    return reinterpret_cast<bf16*>(smem + kQBytes + 2 * kKBytes +
                                   buf * kVBytes);
  };
  const int q0 = blockIdx.x * kAttnQ, h = blockIdx.y, b = blockIdx.z;
  const int N3 = 3 * H * HD;
  const bf16* base = qkv + static_cast<size_t>(b) * S * N3;
  const int tiles = (kv_len + kAttnKeys - 1) / kAttnKeys;
  const int steps = tiles * (1 + kPasses);

  // step i into buffer buf: key tile i % tiles, and in a product pass V's
  // columns of that pass; rows past S are zero (V's must be: 0 * garbage
  // could be NaN)
  auto stage = [&](int i, int buf) {
    const int pass = i / tiles, kc = (i - pass * tiles) * kAttnKeys;
    const bf16* rows = base + static_cast<size_t>(kc) * N3;
    cp_tile(Ks(buf), ld, rows + (H + h) * HD, N3, kAttnKeys, HD, S - kc);
    if (pass > 0)
      cp_tile(Vs(buf), ldv, rows + (2 * H + h) * HD + (pass - 1) * OC, N3,
              kAttnKeys, OC, S - kc);
    cp_async_commit();
  };

  cp_tile(Qs, ld, base + static_cast<size_t>(q0) * N3 + h * HD, N3, kAttnQ,
          HD, S - q0);
  stage(0, 0);  // one group with Q
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16, gq = lane >> 2, tq = lane & 3;
  const bool live = q0 + r0 < S;
  uint32_t qa[kQRegs ? HD / 16 : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) load_a(qa[kk], Qs, ld, r0, 16 * kk);
  }
  // masked, scaled score of accumulator element e of n8 block j of the
  // tile at key kc
  auto masked = [&](float s, int kc, int j, int e) {
    const int key = kc + 8 * j + 2 * tq + (e & 1);
    return s * scale + (key < kv_len ? 0.f : kNegInf);
  };

  float m[2] = {-3.0e38f, -3.0e38f}, l[2] = {0.f, 0.f};
  float o[OC / 8][4] = {};
  const int HDt = H * HD;
#pragma unroll 1
  for (int i = 0; i < steps; ++i) {
    const int buf = i & 1;
    if (i + 1 < steps) stage(i + 1, buf ^ 1);  // freed by the last barrier
    const int pass = i / tiles, t = i - pass * tiles, kc = t * kAttnKeys;
    if (live) {
      float s[4][4];
      if constexpr (kQRegs)
        score_block<HD>(s, qa, Ks(buf), 0);
      else
        score_block_smem<HD>(s, Qs, r0, Ks(buf), 0);
      if (pass == 0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float mt = m[hh];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 2 * hh; e < 2 * hh + 2; ++e)
              mt = fmaxf(mt, masked(s[j][e], kc, j, e));
          float sum = l[hh] * expf(m[hh] - mt);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 2 * hh; e < 2 * hh + 2; ++e)
              sum += expf(masked(s[j][e], kc, j, e) - mt);
          m[hh] = mt;
          l[hh] = sum;
        }
        if (t == tiles - 1) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float mq = quad_max(m[hh]);
            l[hh] = quad_sum(l[hh] * expf(m[hh] - mq));
            m[hh] = mq;
            const int q = q0 + r0 + gq + 8 * hh;
            if (q < S && tq == 0)
              lse[(static_cast<size_t>(b) * S + q) * H + h] =
                  m[hh] + logf(l[hh]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = expf(masked(s[j][e], kc, j, e) - m[e >> 1]) / l[e >> 1];
            if (kDrop)
              p = attn_keep(drop, b, h, H, S, q0 + r0 + gq + 8 * (e >> 1),
                            kc + 8 * j + 2 * tq + (e & 1))
                      ? p * drop.scale
                      : 0.f;
            s[j][e] = p;
          }
        const bf16* V = Vs(buf);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint32_t pa[4] = {
              pack_bf16(s[2 * kk][0], s[2 * kk][1]),
              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int jn = 0; jn < OC / 8; jn += 2) {
            uint32_t bv[4];
            load_b_kn(bv, V, ldv, 16 * kk, 8 * jn);
            mma_bf16(o[jn], pa, bv[0], bv[1]);
            mma_bf16(o[jn + 1], pa, bv[2], bv[3]);
          }
        }
        if (t == tiles - 1) {
          const int oc = (pass - 1) * OC;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int q = q0 + r0 + gq + 8 * hh;
            if (q >= S) continue;
            const size_t row = static_cast<size_t>(b) * S + q;
#pragma unroll
            for (int jn = 0; jn < OC / 8; ++jn)
              *reinterpret_cast<uint32_t*>(att + row * HDt + h * HD + oc +
                                           8 * jn + 2 * tq) =
                  pack_bf16(o[jn][2 * hh], o[jn][2 * hh + 1]);
          }
#pragma unroll
          for (int jn = 0; jn < OC / 8; ++jn)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[jn][e] = 0.f;
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // step i + 1's tiles are in; buffer buf is free
  }
}

template <int HD, bool kDrop = false>
cudaError_t launch_attention_bf16_tiled(const bf16* qkv, bf16* att,
                                        float* lse, int B, int S, int H,
                                        int kv_len, float scale,
                                        cudaStream_t stream,
                                        Drop drop = Drop{}) {
  constexpr size_t bytes = attn_tiled_smem_bf16(HD);
  static_assert(bytes <= kSmemPerBlock, "the tiles fit a block");
  DEVT_TRY(set_smem(attention_bf16_tiled<HD, kDrop>, bytes));
  attention_bf16_tiled<HD, kDrop>
      <<<dim3((S + kAttnQ - 1) / kAttnQ, H, B), kAttnThreads, bytes, stream>>>(
          qkv, att, lse, S, H, kv_len, scale, drop);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float: exact f32 FMA products
// ---------------------------------------------------------------------------

__host__ __device__ constexpr size_t f32_attn_smem(int Sp, int d) {
  // Q, K, V tiles, the score tile (probabilities in place), O, m, l
  return align128(sizeof(float) * kF32Rows * pad_f32(d)) +
         2 * align128(sizeof(float) * Sp * pad_f32(d)) +
         align128(sizeof(float) * kF32Rows * pad_f32(Sp)) +
         align128(sizeof(float) * kF32Rows * pad_f32(d)) +
         2 * align128(sizeof(float) * kF32Rows);
}

template <bool kNormFirst, bool kDrop>
__global__ void __launch_bounds__(kF32Threads)
    attention_f32(const float* __restrict__ qkv, float* __restrict__ att,
                  float* __restrict__ lse, int S, int Sp, int H, int d,
                  int kv_len, int lanes, float scale, Drop drop) {
  static_assert(kNormFirst || !kDrop, "dropout follows the normalisation");
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldq = pad_f32(d), lds = pad_f32(Sp);
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + align128(sizeof(float) * kF32Rows * ldq) / sizeof(float);
  float* Vs = Ks + align128(sizeof(float) * Sp * ldq) / sizeof(float);
  float* Sc = Vs + align128(sizeof(float) * Sp * ldq) / sizeof(float);
  float* Os = Sc + align128(sizeof(float) * kF32Rows * lds) / sizeof(float);
  float* row_m = Os + align128(sizeof(float) * kF32Rows * ldq) / sizeof(float);
  float* row_l = row_m + align128(sizeof(float) * kF32Rows) / sizeof(float);
  const int q0 = blockIdx.x * kF32Rows, h = blockIdx.y, b = blockIdx.z;
  const int N3 = 3 * H * d, HD = H * d;
  const float* base = qkv + static_cast<size_t>(b) * S * N3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kF32Rows * d; i += blockDim.x) {
    const int r = i / d, j = i - r * d, q = q0 + r;
    Qs[r * ldq + j] = q < S ? base[static_cast<size_t>(q) * N3 + h * d + j]
                            : 0.f;
  }
  for (int i = threadIdx.x; i < Sp * d; i += blockDim.x) {
    const int r = i / d, j = i - r * d;
    const bool ok = r < S;
    const size_t row = static_cast<size_t>(r) * N3;
    Ks[r * ldq + j] = ok ? base[row + (H + h) * d + j] : 0.f;
    Vs[r * ldq + j] = ok ? base[row + (2 * H + h) * d + j] : 0.f;
  }
  __syncthreads();
  block_gemm_f32<true>(Qs, ldq, Ks, ldq, Sc, lds, kF32Rows, Sp, d, false);
  __syncthreads();
  for (int r = warp; r < kF32Rows; r += kF32Threads / 32) {
    float* sr = Sc + r * lds;
    float m = -3.0e38f;
    for (int c = lane; c < S; c += 32) {
      const float s = sr[c] * scale + (c < kv_len ? 0.f : kNegInf);
      sr[c] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int c = lane; c < Sp; c += 32) {
      const float p = c < S ? expf(sr[c] - m) : 0.f;
      l += p;
      sr[c] = p;
    }
    l = warp_sum(l);
    if (kNormFirst)
      for (int c = lane; c < Sp; c += 32) {
        float p = sr[c] / l;
        if (kDrop) p = attn_keep(drop, b, h, H, S, q0 + r, c) ? p * drop.scale
                                                               : 0.f;
        sr[c] = p;
      }
    if (lane == 0) {
      row_m[r] = m;
      row_l[r] = l;
    }
  }
  __syncthreads();
  block_gemm_f32<false>(Sc, lds, Vs, ldq, Os, ldq, kF32Rows, d, Sp, false);
  __syncthreads();
  for (int i = threadIdx.x; i < kF32Rows * d; i += blockDim.x) {
    const int r = i / d, j = i - r * d, q = q0 + r;
    if (q < S)
      att[(static_cast<size_t>(b) * S + q) * HD + h * d + j] =
          kNormFirst ? Os[r * ldq + j] : Os[r * ldq + j] / row_l[r];
  }
  for (int r = threadIdx.x; r < kF32Rows; r += blockDim.x) {
    const int q = q0 + r;
    if (q < S)
      lse[(static_cast<size_t>(b) * S + q) * lanes + h] =
          row_m[r] + logf(row_l[r]);
  }
}

// d a multiple of 4; one head's K and V (S rounded up to 16 rows) must
// fit a block's shared memory
template <bool kNormFirst, bool kDrop = false>
cudaError_t launch_attention_f32(const float* qkv, float* att, float* lse,
                                 int B, int S, int H, int d, int kv_len,
                                 int lanes, float scale, cudaStream_t stream,
                                 Drop drop = Drop{}) {
  const int Sp = round_up(S, 16);
  const size_t bytes = f32_attn_smem(Sp, d);
  if (bytes > kSmemPerBlock) return cudaErrorInvalidValue;
  DEVT_TRY(set_smem(attention_f32<kNormFirst, kDrop>, bytes));
  attention_f32<kNormFirst, kDrop>
      <<<dim3((S + kF32Rows - 1) / kF32Rows, H, B), kF32Threads, bytes,
         stream>>>(qkv, att, lse, S, Sp, H, d, kv_len, lanes, scale, drop);
  return cudaGetLastError();
}

}  // namespace
