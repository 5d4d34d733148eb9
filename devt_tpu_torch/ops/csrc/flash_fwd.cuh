// Attention forward on split q, k and v for Hopper (sm_90a): the body
// behind two wrappers.
//
//   flash_fwd.cu   flash_attention's forward, kernels 9 and 11: q
//                  (B, H, Sq, d), k and v (B, H, Skv, d), key columns at
//                  or past kv_len masked; o (B, H, Sq, d), lse (B*H, Sq)
//   ring_step.cu   one forward ring hop, kernel 14: q (B, S, H*d) and the
//                  packed kv shard (B, S, 2*H*d), an additive f32 column
//                  mask; o (B, S, H*d), lse (B, S, H)
//
// q, k, v, o and lse are each given by element strides over (sequence,
// head, row), the d elements of a row contiguous, so head views of a
// packed tensor need no copy.  Per (sequence, head): s = q k^T * scale in
// f32 plus the key bias (-1e30 at key columns >= kv_len, or the mask's
// 0 / -1e30); o in q's type; lse = max s + log sum exp(s - max) f32.  Rows
// past Sq are neither read nor written, keys past Skv are never read:
// there is no pad copy in device memory (the TPU wrapper pads both to its
// tiles, flash_attention.py:355-368).  A key past Skv (a ragged edge with
// a mask) counts as absent, not as masked.
//
//   kOnline = false  kernels 9 and 14, devt_tpu/ops/flash_attention.py:390
//                    _fwd_single_kernel and :792 _ring_fwd_kernel, at the
//                    shapes flash_fwd_sm90.cuh does not take (float; head
//                    dim 128 or 256; more than 256 live keys): the exact
//                    row max and l first, then o = round(p / l) @ v, p
//                    normalised and cast to v's type before the product.
//                    A row whose every key is masked has m = -1e30, p = 1,
//                    l = Skv and a finite o, as the TPU kernel's.  This
//                    branch computes each score twice (a max/sum pass over
//                    K, then a pass over K and V); the wgmma body holds the
//                    whole score row and computes it once.
//   kOnline = true   kernel 11, flash_attention.py:69 _fwd_kernel (longer
//                    or unequal sequences): one pass with the online
//                    softmax, per key tile m_new = max(m, max s),
//                    alpha = exp(m - m_new), acc = acc * alpha +
//                    round(exp(s - m_new)) @ v, l = l * alpha + sum p;
//                    o = acc / l at the end
//
// Design.  A block owns 64 queries of one (sequence, head), 4 warps of 16
// rows, and STREAMS K and V in tiles of 64 keys through a double-buffered
// cp.async ring in shared memory, so shared memory does not grow with the
// sequence (attention_fwd.cuh keeps a head's whole K and V, which is why
// kernel 3 refuses head dim 256 above about 160 tokens): 5 tiles of 64
// rows, 169 KB at head dim 256, every length at every head dim.  Tiles
// wholly past kv_len are not visited (their probabilities are exactly 0).
// The products are mma.sync m16n8k16 with f32 accumulation on ldmatrix
// fragments (score_block, load_b_kn of attention_fwd.cuh); q stays in
// registers; head dims above 64 take the product 64 output columns at a
// time and recompute the scores for each, so the accumulators stay in
// registers.  The one-shot kernels' first pass keeps a running max and sum
// per lane (one rescale per tile) and combines the four lanes of a row
// once; the online kernel rescales once per 32 keys, where the TPU kernel
// does once per 128: the bf16 result then differs from the plain version
// by the rounding of p, within the forward gate.  The float route (FMA
// products on 32-row tiles, 32-key tiles, the scores in shared memory)
// gives the exact comparison.

#pragma once

#include "attention_fwd.cuh"

namespace {

constexpr int kFlashQ = 64, kFlashKeys = 64, kFlashThreads = 128;

// one call: pointers, strides (sequence, head, row) in elements, shapes;
// mask: an additive f32 bias per key column, or null for the kv_len rule
struct FlashFwd {
  const void *q, *k, *v;
  void* o;
  float* lse;
  long long qs[3], ks[3], vs[3], os[3], ls[3];
  int H, Sq, Skv, kv_len;
  float scale;
  const float* mask;
};

// the additive bias of key column `key`: with kMask the mask's (a key past
// Skv is absent), else the kv_len rule
template <bool kMask>
__device__ __forceinline__ float flash_key_bias(const FlashFwd& a, int key) {
  if (kMask) return key < a.Skv ? a.mask[key] : __int_as_float(0xff800000);
  return key < a.kv_len ? 0.f : kNegInf;
}

__host__ __device__ constexpr size_t flash_tile_bf16(int hd) {
  return align128(sizeof(bf16) * kFlashKeys * (hd + 8));
}

// q, and two stages of k and v
__host__ __device__ constexpr size_t flash_smem_bf16(int hd) {
  return 5 * flash_tile_bf16(hd);
}

template <int HD, bool kOnline, bool kMask>
__global__ void __launch_bounds__(kFlashThreads)
    flash_fwd_bf16(const FlashFwd a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = HD + 8;
  constexpr int OC = HD > 64 ? 64 : HD;  // output columns per product pass
  constexpr size_t kTile = flash_tile_bf16(HD);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  // a flat grid, the query tiles of one head next to each other (they
  // read the same K and V, from L2 after the first)
  const int qtiles = (a.Sq + kFlashQ - 1) / kFlashQ;
  const int bh = blockIdx.x / qtiles, b = bh / a.H, h = bh - b * a.H;
  const int q0 = (blockIdx.x - bh * qtiles) * kFlashQ;
  const bf16* Q = static_cast<const bf16*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.vs[0] + h * a.vs[1];
  const int tiles = (a.kv_len + kFlashKeys - 1) / kFlashKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16, gq = lane >> 2, tq = lane & 3;
  const bool live = q0 + r0 < a.Sq;  // the warp has a row inside Sq

  // q; rows past Sq are zero
  cp_tile(Qs, ld, Q + q0 * a.qs[2], a.qs[2], kFlashQ, HD, a.Sq - q0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) load_a(qa[kk], Qs, ld, r0, 16 * kk);

  auto k_tile = [&](int stage) {
    return reinterpret_cast<bf16*>(smem + (1 + 2 * stage) * kTile);
  };
  auto v_tile = [&](int stage) {
    return reinterpret_cast<bf16*>(smem + (2 + 2 * stage) * kTile);
  };
  // keys k0.. (and their values) into a stage; rows past Skv are zero
  // (v's must be: 0 * garbage could be NaN)
  auto load = [&](int t, int stage, bool with_v) {
    const int k0 = t * kFlashKeys;
    cp_tile(k_tile(stage), ld, K + k0 * a.ks[2], a.ks[2], kFlashKeys, HD,
            a.Skv - k0);
    if (with_v)
      cp_tile(v_tile(stage), ld, V + k0 * a.vs[2], a.vs[2], kFlashKeys, HD,
              a.Skv - k0);
    cp_async_commit();
  };
  // one pass over the live key tiles, body(t, K tile, V tile) on each
  auto pass = [&](bool with_v, auto&& body) {
    load(0, 0, with_v);
    for (int t = 0; t < tiles; ++t) {
      if (t + 1 < tiles) {
        load(t + 1, (t + 1) & 1, with_v);  // its stage was freed below
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (live) body(t, k_tile(t & 1), v_tile(t & 1));
      __syncthreads();  // every warp is done with stage t & 1
    }
  };
  // masked, scaled score of accumulator element e of n8 block j of the 32
  // keys at kc
  auto masked = [&](float s, int kc, int j, int e) {
    return s * a.scale +
           flash_key_bias<kMask>(a, kc + 8 * j + 2 * tq + (e & 1));
  };
  // acc += round(p) @ v[kc.., oc..oc+OC) for the 32 keys at kc (key kc of
  // the tile at row kt of Vs)
  auto pv = [&](float (&acc)[OC / 8][4], float (&p)[4][4], const bf16* Vs,
                int kt, int oc) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      // the accumulator layout of two n8 score tiles is the A layout of
      // one k16 probability fragment
      const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                              pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                              pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                              pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int jn = 0; jn < OC / 8; jn += 2) {
        uint32_t bv[4];
        load_b_kn(bv, Vs, ld, kt + 16 * kk, oc + 8 * jn);
        mma_bf16(acc[jn], pa, bv[0], bv[1]);
        mma_bf16(acc[jn + 1], pa, bv[2], bv[3]);
      }
    }
  };

  float m[2], l[2];
  if (!kOnline) {
    // pass 1: row max and sum, per lane with a rescale per 32 keys, then
    // the four lanes of a row combined
    float ml[2] = {kNegInf, kNegInf}, ll[2] = {0.f, 0.f};
    pass(false, [&](int t, const bf16* Ks, const bf16*) {
#pragma unroll 1
      for (int kt = 0; kt < kFlashKeys; kt += 32) {
        float s[4][4];
        score_block<HD>(s, qa, Ks, kt);
        const int kc = t * kFlashKeys + kt;
        float mx[2] = {ml[0], ml[1]};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = masked(s[j][e], kc, j, e);
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          ll[hh] *= expf(ml[hh] - mx[hh]);
          ml[hh] = mx[hh];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ll[e >> 1] += expf(s[j][e] - ml[e >> 1]);
      }
    });
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[hh] = quad_max(ml[hh]);
      l[hh] = quad_sum(ll[hh] * expf(ml[hh] - m[hh]));
    }
  }

  bf16* O = static_cast<bf16*>(a.o) + b * a.os[0] + h * a.os[1];
  float* L = a.lse + b * a.ls[0] + h * a.ls[1];
#pragma unroll 1
  for (int oc = 0; oc < HD; oc += OC) {
    float acc[OC / 8][4] = {};
    if (kOnline) {
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;  // per lane until the end
    }
    pass(true, [&](int t, const bf16* Ks, const bf16* Vs) {
#pragma unroll 1
      for (int kt = 0; kt < kFlashKeys; kt += 32) {
        float s[4][4];
        score_block<HD>(s, qa, Ks, kt);
        const int kc = t * kFlashKeys + kt;
        if (kOnline) {
          float mx[2] = {m[0], m[1]};
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[j][e] = masked(s[j][e], kc, j, e);
              mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
            }
          float alpha[2];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            mx[hh] = quad_max(mx[hh]);
            alpha[hh] = expf(m[hh] - mx[hh]);
            l[hh] *= alpha[hh];
            m[hh] = mx[hh];
          }
#pragma unroll
          for (int jn = 0; jn < OC / 8; ++jn)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[jn][e] *= alpha[e >> 1];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p = expf(s[j][e] - m[e >> 1]);
              l[e >> 1] += p;
              s[j][e] = p;
            }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[j][e] =
                  expf(masked(s[j][e], kc, j, e) - m[e >> 1]) / l[e >> 1];
        }
        pv(acc, s, Vs, kt, oc);
      }
    });
    if (kOnline) {
      l[0] = quad_sum(l[0]);
      l[1] = quad_sum(l[1]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q = q0 + r0 + gq + 8 * hh;
      if (q >= a.Sq) continue;
      const float div = kOnline ? l[hh] : 1.f;
      bf16* row = O + q * a.os[2] + oc + 2 * tq;
#pragma unroll
      for (int jn = 0; jn < OC / 8; ++jn)
        *reinterpret_cast<uint32_t*>(row + 8 * jn) =
            pack_bf16(acc[jn][2 * hh] / div, acc[jn][2 * hh + 1] / div);
      if (oc == 0 && tq == 0) L[q * a.ls[2]] = m[hh] + logf(l[hh]);
    }
  }
}

template <int HD, bool kOnline, bool kMask>
cudaError_t launch_flash_bf16(const FlashFwd& a, int BH,
                              cudaStream_t stream) {
  const size_t bytes = flash_smem_bf16(HD);
  DEVT_TRY(set_smem(flash_fwd_bf16<HD, kOnline, kMask>, bytes));
  flash_fwd_bf16<HD, kOnline, kMask>
      <<<BH * ((a.Sq + kFlashQ - 1) / kFlashQ), kFlashThreads, bytes,
         stream>>>(a);
  return cudaGetLastError();
}

template <bool kOnline, bool kMask>
cudaError_t run_bf16(const FlashFwd& a, int BH, int d, cudaStream_t s) {
  switch (d) {
    case 16: return launch_flash_bf16<16, kOnline, kMask>(a, BH, s);
    case 32: return launch_flash_bf16<32, kOnline, kMask>(a, BH, s);
    case 64: return launch_flash_bf16<64, kOnline, kMask>(a, BH, s);
    case 128: return launch_flash_bf16<128, kOnline, kMask>(a, BH, s);
    case 256: return launch_flash_bf16<256, kOnline, kMask>(a, BH, s);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// float: exact f32 FMA products on 32-row tiles, 32-key tiles
// ---------------------------------------------------------------------------

constexpr int kF32Keys = 32;  // a warp's lanes, one key each

__host__ __device__ constexpr size_t flash_smem_f32(int d) {
  // q, k, v and o tiles, the score tile, alpha of each row
  return 4 * align128(sizeof(float) * kF32Rows * pad_f32(d)) +
         align128(sizeof(float) * kF32Rows * pad_f32(kF32Keys)) +
         align128(sizeof(float) * kF32Rows);
}

// rows [r0, r0 + n) of a strided head (zero past `valid`) into shared
// memory with row stride ld
__device__ __forceinline__ void load_head_rows(float* dst, int ld,
                                               const float* src,
                                               long long row_stride, int r0,
                                               int n, int d, int valid) {
  for (int i = threadIdx.x; i < n * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    dst[r * ld + c] =
        r0 + r < valid ? src[(r0 + r) * row_stride + c] : 0.f;
  }
}

template <bool kOnline, bool kMask>
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32(const FlashFwd a, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kRowsPerWarp = kF32Rows / (kF32Threads / 32);
  const int ldq = pad_f32(d), lds = pad_f32(kF32Keys);
  const size_t tile = align128(sizeof(float) * kF32Rows * ldq);
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = reinterpret_cast<float*>(smem + tile);
  float* Vs = reinterpret_cast<float*>(smem + 2 * tile);
  float* Os = reinterpret_cast<float*>(smem + 3 * tile);
  float* Sc = reinterpret_cast<float*>(smem + 4 * tile);
  float* alpha_s = reinterpret_cast<float*>(
      smem + 4 * tile + align128(sizeof(float) * kF32Rows * lds));
  const int qtiles = (a.Sq + kF32Rows - 1) / kF32Rows;
  const int bh = blockIdx.x / qtiles, b = bh / a.H, h = bh - b * a.H;
  const int q0 = (blockIdx.x - bh * qtiles) * kF32Rows;
  const float* Q = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const float* K = static_cast<const float*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const float* V = static_cast<const float*>(a.v) + b * a.vs[0] + h * a.vs[1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (a.kv_len + kF32Keys - 1) / kF32Keys;

  load_head_rows(Qs, ldq, Q, a.qs[2], q0, kF32Rows, d, a.Sq);
  for (int i = threadIdx.x; i < kF32Rows * d; i += blockDim.x)
    Os[(i / d) * ldq + i % d] = 0.f;
  // row r = warp * kRowsPerWarp + i of the block: its max and sum
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  // scores of the key tile at k0 into Sc, masked and scaled
  auto scores = [&](int k0) {
    __syncthreads();  // Ks loaded; Sc free
    block_gemm_f32<true>(Qs, ldq, Ks, ldq, Sc, lds, kF32Rows, kF32Keys, d,
                         false);
    __syncthreads();
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      Sc[r * lds + lane] = Sc[r * lds + lane] * a.scale +
                           flash_key_bias<kMask>(a, k0 + lane);
    }
  };
  if (!kOnline) {
    // pass 1: row max and sum, rescaled per tile
    for (int t = 0; t < tiles; ++t) {
      const int k0 = t * kF32Keys;
      __syncthreads();  // the last tile's scores read
      load_head_rows(Ks, ldq, K, a.ks[2], k0, kF32Keys, d, a.Skv);
      scores(k0);
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp * kRowsPerWarp + i;
        const float s = Sc[r * lds + lane];
        const float mn = fmaxf(m[i], warp_max(s));
        l[i] = l[i] * expf(m[i] - mn) + warp_sum(expf(s - mn));
        m[i] = mn;
      }
    }
  }
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kF32Keys;
    __syncthreads();  // the last tile's products done
    load_head_rows(Ks, ldq, K, a.ks[2], k0, kF32Keys, d, a.Skv);
    load_head_rows(Vs, ldq, V, a.vs[2], k0, kF32Keys, d, a.Skv);
    scores(k0);
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const float s = Sc[r * lds + lane];
      if (kOnline) {
        const float mn = fmaxf(m[i], warp_max(s));
        const float al = expf(m[i] - mn), p = expf(s - mn);
        l[i] = l[i] * al + warp_sum(p);
        m[i] = mn;
        Sc[r * lds + lane] = p;
        if (lane == 0) alpha_s[r] = al;
      } else {
        Sc[r * lds + lane] = expf(s - m[i]) / l[i];
      }
    }
    __syncthreads();
    if (kOnline) {
      for (int i = threadIdx.x; i < kF32Rows * d; i += blockDim.x) {
        const int r = i / d;
        Os[r * ldq + i - r * d] *= alpha_s[r];
      }
      __syncthreads();
    }
    block_gemm_f32<false>(Sc, lds, Vs, ldq, Os, ldq, kF32Rows, d, kF32Keys,
                          true);
  }
  float* O = static_cast<float*>(a.o) + b * a.os[0] + h * a.os[1];
  float* L = a.lse + b * a.ls[0] + h * a.ls[1];
  // lse, and the divisor of each row (l online, else 1: p was normalised)
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i, q = q0 + r;
    if (lane == 0) {
      if (q < a.Sq) L[q * a.ls[2]] = m[i] + logf(l[i]);
      alpha_s[r] = kOnline ? l[i] : 1.f;
    }
  }
  __syncthreads();  // the last product done, the divisors visible
  for (int i = threadIdx.x; i < kF32Rows * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d, q = q0 + r;
    if (q < a.Sq) O[q * a.os[2] + c] = Os[r * ldq + c] / alpha_s[r];
  }
}

template <bool kOnline, bool kMask>
cudaError_t launch_flash_f32(const FlashFwd& a, int BH, int d,
                             cudaStream_t stream) {
  const size_t bytes = flash_smem_f32(d);
  if (d % 4 || bytes > kSmemPerBlock) return cudaErrorInvalidValue;
  DEVT_TRY(set_smem(flash_fwd_f32<kOnline, kMask>, bytes));
  flash_fwd_f32<kOnline, kMask>
      <<<BH * ((a.Sq + kF32Rows - 1) / kF32Rows), kF32Threads, bytes,
         stream>>>(a, d);
  return cudaGetLastError();
}

// kernel 9 or 11 (kOnline), or 14 (one-shot, kMask: a.mask's bias), in
// the operands' type (0 float32, 1 bfloat16)
template <bool kOnline, bool kMask>
cudaError_t launch_flash(int dtype, const FlashFwd& a, int BH, int d,
                         cudaStream_t s) {
  if (dtype == 0) return launch_flash_f32<kOnline, kMask>(a, BH, d, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  return run_bf16<kOnline, kMask>(a, BH, d, s);
}

}  // namespace
