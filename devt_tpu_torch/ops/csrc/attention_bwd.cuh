// Attention backward for Hopper (sm_90a): the one body behind three
// wrappers, which differ in how q, k, v and their gradients are laid out.
//
//   mha_bwd.cu    fused_mha's backward (kernel 4): packed qkv
//                 (B, S, 3, H, d), do (B, S, H, d), lse (B, S, H)
//   flash_bwd.cu  flash_attention's backward: split q (B, H, Sq, d), k, v
//                 (B, H, Skv, d) given by strides, do, dq, dk, dv and lse
//                 (B*H, Sq) contiguous; kernel 10 (Sq == Skv <= 512, one
//                 launch) and kernels 12 and 13 (any Sq, Skv: the dq part
//                 and the dk/dv part as two launches)
//   ring_step.cu  one backward ring hop (kernel 15): q (B, S, H*d), the
//                 packed kv shard (B, S, 2*H*d), lse (B, S, H) the global
//                 one, an additive column mask; f32 dq and dkv
//
// Every operand is addressed by its element strides over (sequence b,
// head h, row r); the d elements of a row are contiguous.  Per (b, h):
//
//   delta = rowsum(f32(do) * f32(o))          o as stored, after dropout
//   s     = q k^T * scale + bias(key): -1e30 at key columns >= kv_len,
//           or the column mask's 0 / -1e30 when one is given
//   p     = exp(s - lse)
//   mask  = keep ? 1 / (1 - rate) : 0         (1 without dropout)
//   dv    = round(p * mask)^T @ do
//   dp    = (do @ v^T) * mask
//   ds    = p * (dp - delta) * scale
//   dq    = round(ds) @ k;   dk = round(ds)^T @ q
//
// where round() is the cast to the operand type and every product sums in
// f32; the outputs are stored in their own type (the operands' for
// kernels 4, 10, 12, 13; f32 for the ring hop, whose partials sum across
// hops).  Keys at or past kv_len have p = 0 exactly, so their dk and dv
// are exact zeros; query rows at or past Sq are not read (their terms are
// exact zeros), whatever lies in memory there.  The dropout mask (fused_mha
// only, Sq == Skv) is regenerated from the seed: Philox4x32-10 of (site
// kSiteAttn, flat index over (b, h, q, k)), as the forward draws it
// (attention_fwd.cuh), whatever either launch's grid.
//
// Design.  FlashAttention-2's split of the backward: a first launch writes
// delta, a warp per (row, head), laid out like lse; then blocks of two
// kinds, in one launch (kernels 4, 10, 15) or in a launch each (kernels 12
// and 13).  Blocks of the first kind each own up to 64 queries of a head
// and compute their dq, a sum over the keys; blocks of the second kind
// each own up to 64 keys and compute their dk and dv, sums over the
// queries.  A block keeps its own rows (q and do, or k and v) in shared
// memory and streams the other side's rows (k and v, or q and do, with
// the queries' lse and delta) through it up to 64 at a time, the next rows
// loading (cp.async) while the block works on the last ones, so shared
// memory does not grow with either length: every Sq and Skv fits at every
// head dim up to 256.  Each output element has one owner that sums its
// terms in a fixed order, so there are no atomics and two runs give the
// same bits.  Inside a block a warp owns 16 rows and attn_out_cols(HD)
// output columns (the whole head up to head dim 64, else 64, or 32 at
// 224); for each 16 streamed rows it recomputes its 16 x 16 score and dp
// tiles over the whole head dim (mma.sync m16n8k16, f32 accumulation), so
// that its accumulators stay in registers at head dim 256 and past it.  A
// block's warps are its strips times the head's chunks, at most 16, so at
// head dims 224 and 448 (FrameTransformer's, 7 chunks) a block owns and
// streams 32 rows at a time (bwd_rows): 14 warps, and at 448 175 KB of
// shared memory; the other head dims take 64.  Every S fits.  The float route
// (the tests' f32 runs and f32 training) has the same split on 32-row
// tiles with the block-level FMA product, the scores in shared memory.

#pragma once

#include "attention_fwd.cuh"

namespace {

constexpr int kBwdRows = 64;  // rows a block owns, and streams at once
constexpr int kBwdMaxWarps = 16;

// the output-column chunks of a head that a block's warps split (a warp a
// (16-row strip, chunk) pair): the kernel's and the launcher's count
__host__ __device__ constexpr int bwd_chunks(int hd) {
  return hd / attn_out_cols(hd);
}

// rows a bfloat16 block owns and streams at head dim hd: 64, or as many
// 16-row strips as leave a warp to each (strip, chunk) pair within
// kBwdMaxWarps (32 at 224 and 448)
__host__ __device__ constexpr int bwd_rows(int hd) {
  return kBwdMaxWarps / bwd_chunks(hd) * 16 < kBwdRows
             ? kBwdMaxWarps / bwd_chunks(hd) * 16
             : kBwdRows;
}

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

// the operands of one backward call, the gradients in type TO; lse and
// delta share `sl`.  colmask: the additive f32 bias of each key column
// (0, or -1e30 for a masked one), or null for the kv_len rule
template <typename T, typename TO = T>
struct BwdOperands {
  const T *q, *k, *v, *dout;
  TO *dq, *dk, *dv;
  const float* lse;
  float* delta;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv, sl;
  const float* colmask;
};

struct BwdShape {
  int Sq, Skv, H, kv_len;
  float scale;
};

// which blocks a launch runs: both kinds, or the dq or the dk/dv blocks
enum BwdPart { kBwdBoth = 0, kBwdDq = 1, kBwdDkv = 2 };

// rows a block owns and streams (`cap`, or all of a shorter sequence),
// and the number of query and key tiles
struct BwdGrid {
  int R, tq, tk;
};

__host__ __device__ inline BwdGrid bwd_grid(const BwdShape& sh, int cap) {
  const int sqp = round_up(sh.Sq, 16), skp = round_up(sh.Skv, 16);
  const int longer = sqp > skp ? sqp : skp;
  const int R = longer < cap ? longer : cap;
  return {R, (sqp + R - 1) / R, (skp + R - 1) / R};
}

// the additive bias of key column `key` of a sequence of Skv keys: with
// kMask the column mask's (a key past Skv is absent), else the kv_len rule
template <bool kMask>
__device__ __forceinline__ float key_bias(const float* colmask, int key,
                                          int kv_len, int Skv) {
  if (kMask) return key < Skv ? colmask[key] : __int_as_float(0xff800000);
  return key < kv_len ? 0.f : kNegInf;
}

// 4 bytes global → shared, asynchronous; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__host__ __device__ constexpr size_t mha_bwd_smem_bf16(int R, int hd) {
  // own rows (2 tiles), two buffers of streamed rows (4 tiles); lse and
  // delta of two buffers of queries
  return 6 * align128(sizeof(bf16) * R * (hd + 8)) +
         4 * align128(sizeof(float) * R);
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

// lse and delta of queries [r0, r0 + n) of head h into shared memory at
// [0, n), asynchronously in the open cp.async group; rows past Sq get
// zeros
template <typename T, typename TO>
__device__ __forceinline__ void cp_lse_delta(float* lse_s, float* delta_s,
                                             const BwdOperands<T, TO>& a,
                                             int b, int h, int Sq, int r0,
                                             int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = r0 + i;
    const bool ok = r < Sq;
    const size_t g = b * a.sl.b_ + h * a.sl.h_ + (ok ? r : 0) * a.sl.r_;
    cp_async4(lse_s + i, a.lse + g, ok);
    cp_async4(delta_s + i, a.delta + g, ok);
  }
}

// the same with plain loads (the float route, which loads synchronously)
template <typename T, typename TO>
__device__ __forceinline__ void load_lse_delta(float* lse_s, float* delta_s,
                                               const BwdOperands<T, TO>& a,
                                               int b, int h, int Sq, int r0,
                                               int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = r0 + i;
    const bool ok = r < Sq;
    const size_t g = b * a.sl.b_ + h * a.sl.h_ + (ok ? r : 0) * a.sl.r_;
    lse_s[i] = ok ? a.lse[g] : 0.f;
    delta_s[i] = ok ? a.delta[g] : 0.f;
  }
}

template <int HD, bool kDrop, bool kMask, typename TO>
__global__ void __launch_bounds__(32 * kBwdMaxWarps)
    mha_bwd_bf16(const BwdOperands<bf16, TO> a, BwdShape sh, int first,
                 Drop drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = HD + 8;
  constexpr int OC = attn_out_cols(HD);  // output columns of one warp
  constexpr int kChunks = bwd_chunks(HD);
  const BwdGrid g = bwd_grid(sh, bwd_rows(HD));
  const int R = g.R, Sq = sh.Sq, Skv = sh.Skv;
  const int bx = blockIdx.x + first;
  const bool keys = bx >= g.tq;  // dk and dv, else dq
  const int row0 = (keys ? bx - g.tq : bx) * R;
  const size_t tile = align128(sizeof(bf16) * R * ld);
  const size_t vec = align128(sizeof(float) * R);
  bf16* X0 = reinterpret_cast<bf16*>(smem);             // own: q or k
  bf16* X1 = reinterpret_cast<bf16*>(smem + tile);      // own: do or v
  // streamed rows, buffer i: k or q at 2 + 2i, v or do at 3 + 2i; then
  // lse and delta of buffer i's queries (dk, dv) or of the own queries
  // (dq: buffer 0)
  auto lse_s = [&](int i) {
    return reinterpret_cast<float*>(smem + 6 * tile + 2 * i * vec);
  };
  auto delta_s = [&](int i) {
    return reinterpret_cast<float*>(smem + 6 * tile + (2 * i + 1) * vec);
  };
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = (warp / kChunks) * 16, oc = (warp % kChunks) * OC;
  const int sqp = round_up(Sq, 16);
  const int live = round_up(sh.kv_len, 16);  // strips with a live key
  const int own_end = keys ? live : sqp;     // own rows with work
  const int end = keys ? sqp : live;         // streamed rows
  // the warp's strip: inside Sq, and for dk/dv with a live key (strips
  // wholly past kv_len have p = 0: dk = dv = 0)
  const bool mine = row0 + r0 < own_end;
  float acc0[OC / 8][4] = {}, acc1[OC / 8][4] = {};  // dq, or dk and dv

  if (row0 < own_end) {  // else every strip of the block is dead
    // own rows; rows past Sq or Skv are zero (0 * garbage could be NaN)
    if (keys) {
      const int rows = min(R, round_up(Skv, 16) - row0);
      cp_tile(X0, ld, at(a.k, a.sk, b, h, row0), a.sk.r_, rows, HD,
              Skv - row0);
      cp_tile(X1, ld, at(a.v, a.sv, b, h, row0), a.sv.r_, rows, HD,
              Skv - row0);
    } else {
      const int rows = min(R, sqp - row0);
      cp_tile(X0, ld, at(a.q, a.sq, b, h, row0), a.sq.r_, rows, HD,
              Sq - row0);
      cp_tile(X1, ld, at(a.dout, a.sdo, b, h, row0), a.sdo.r_, rows, HD,
              Sq - row0);
    }
    // streamed rows c0.. into buffer buf
    auto stream_rows = [&](int c0, int buf) {
      const int n = min(R, end - c0);
      bf16* Y0 = reinterpret_cast<bf16*>(smem + (2 + 2 * buf) * tile);
      bf16* Y1 = reinterpret_cast<bf16*>(smem + (3 + 2 * buf) * tile);
      if (keys) {
        cp_tile(Y0, ld, at(a.q, a.sq, b, h, c0), a.sq.r_, n, HD, Sq - c0);
        cp_tile(Y1, ld, at(a.dout, a.sdo, b, h, c0), a.sdo.r_, n, HD,
                Sq - c0);
      } else {
        cp_tile(Y0, ld, at(a.k, a.sk, b, h, c0), a.sk.r_, n, HD, Skv - c0);
        cp_tile(Y1, ld, at(a.v, a.sv, b, h, c0), a.sv.r_, n, HD, Skv - c0);
      }
      if (keys) cp_lse_delta(lse_s(buf), delta_s(buf), a, b, h, Sq, c0, n);
      cp_async_commit();
    };
    if (!keys) cp_lse_delta(lse_s(0), delta_s(0), a, b, h, Sq, row0, R);
    stream_rows(0, 0);  // one group with the own rows

    for (int c0 = 0, buf = 0; c0 < end; c0 += R, buf ^= 1) {
      const int n = min(R, end - c0);
      if (c0 + R < end) {
        stream_rows(c0 + R, buf ^ 1);  // its buffers were freed below
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
        const float* ls = lse_s(0);
        const float* ds_ = delta_s(0);
        const float lse_r[2] = {ls[r0 + gq], ls[r0 + gq + 8]};
        const float delta_r[2] = {ds_[r0 + gq], ds_[r0 + gq + 8]};
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
                  expf(s[j][e] * sh.scale +
                       key_bias<kMask>(a.colmask, key, sh.kv_len, Skv) -
                       lse_r[e >> 1]);
              float gr = dp[j][e];
              if (kDrop)
                gr = attn_keep(drop, b, h, sh.H, Sq, q0 + gq + 8 * (e >> 1),
                               key)
                         ? gr * drop.scale
                         : 0.f;
              s[j][e] = p * (gr - delta_r[e >> 1]) * sh.scale;
            }
          uint32_t da[4];
          pack_a(da, s);
          acc_ay<OC>(acc0, da, Y0, ld, t, oc);
        }
      } else if (mine) {
        // --- dk and dv of the warp's 16 keys: sums over the queries ---
        const float* ls = lse_s(buf);
        const float* dl = delta_s(buf);
        for (int t = 0; t < n; t += 16) {
          float st[2][4], dpt[2][4], ds[2][4];
          tile_xyT<HD>(st, X0, r0, Y0, t);
          tile_xyT<HD>(dpt, X1, r0, Y1, t);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = row0 + r0 + gq + 8 * (e >> 1);
              const int ql = t + 8 * j + 2 * tq + (e & 1), q = c0 + ql;
              const float bias =
                  key_bias<kMask>(a.colmask, key, sh.kv_len, Skv);
              const float p =
                  q < Sq ? expf(st[j][e] * sh.scale + bias - ls[ql]) : 0.f;
              float pm = p, gr = dpt[j][e];
              if (kDrop) {
                const float m =
                    attn_keep(drop, b, h, sh.H, Sq, q, key) ? drop.scale
                                                             : 0.f;
                pm = p * m;
                gr = gr * m;
              }
              st[j][e] = pm;
              ds[j][e] = p * (gr - dl[ql]) * sh.scale;
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

  const int own = keys ? Skv : Sq;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + r0 + gq + 8 * hh;
    if (r >= own) continue;
    TO* o0 = at(keys ? a.dk : a.dq, keys ? a.sdk : a.sdq, b, h, r) + oc +
             2 * tq;
    TO* o1 = at(a.dv, a.sdv, b, h, r) + oc + 2 * tq;
#pragma unroll
    for (int jn = 0; jn < OC / 8; ++jn) {
      store2(o0 + 8 * jn, acc0[jn][2 * hh], acc0[jn][2 * hh + 1]);
      if (keys) store2(o1 + 8 * jn, acc1[jn][2 * hh], acc1[jn][2 * hh + 1]);
    }
  }
}

// the grid of one launch of `part`: its block count and the first block's
// index among [dq blocks, dk/dv blocks)
inline void part_grid(const BwdGrid& g, BwdPart part, int* blocks,
                      int* first) {
  *blocks = part == kBwdDq ? g.tq : part == kBwdDkv ? g.tk : g.tq + g.tk;
  *first = part == kBwdDkv ? g.tq : 0;
}

template <int HD, bool kDrop, bool kMask, typename TO>
cudaError_t launch_bwd_bf16(const BwdOperands<bf16, TO>& a, int B,
                            const BwdShape& sh, BwdPart part,
                            const Drop& drop, cudaStream_t stream) {
  const BwdGrid g = bwd_grid(sh, bwd_rows(HD));
  const size_t bytes = mha_bwd_smem_bf16(g.R, HD);
  if (bytes > kSmemPerBlock) return cudaErrorInvalidValue;
  // one (strip, chunk) each: at head dims 224 and 448 (7 chunks) bwd_rows
  // holds R to 32
  const int warps = (g.R / 16) * bwd_chunks(HD);
  if (warps > kBwdMaxWarps) return cudaErrorInvalidValue;
  int blocks, first;
  part_grid(g, part, &blocks, &first);
  DEVT_TRY(set_smem(mha_bwd_bf16<HD, kDrop, kMask, TO>, bytes));
  mha_bwd_bf16<HD, kDrop, kMask, TO>
      <<<dim3(blocks, sh.H, B), 32 * warps, bytes, stream>>>(a, sh, first,
                                                             drop);
  return cudaGetLastError();
}

// the bfloat16 backward at head dim d (16, 32, 64, 128 or 256); kMask:
// the keys' bias from a.colmask
template <bool kDrop, bool kMask, typename TO>
cudaError_t launch_bwd_bf16_d(const BwdOperands<bf16, TO>& a, int B, int d,
                              const BwdShape& sh, BwdPart part,
                              const Drop& drop, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_bwd_bf16<16, kDrop, kMask>(a, B, sh, part, drop,
                                               stream);
    case 32:
      return launch_bwd_bf16<32, kDrop, kMask>(a, B, sh, part, drop,
                                               stream);
    case 64:
      return launch_bwd_bf16<64, kDrop, kMask>(a, B, sh, part, drop,
                                               stream);
    case 128:
      return launch_bwd_bf16<128, kDrop, kMask>(a, B, sh, part, drop,
                                                stream);
    case 256:
      return launch_bwd_bf16<256, kDrop, kMask>(a, B, sh, part, drop,
                                                stream);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// float: exact f32 FMA products, the same split on 32-row tiles
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t mha_bwd_smem_f32(const BwdShape& sh,
                                                   int d) {
  // own rows, streamed rows and outputs (2 tiles each); p and ds; lse and
  // delta of the queries
  const int R = bwd_grid(sh, kF32Rows).R;
  return 6 * align128(sizeof(float) * R * pad_f32(d)) +
         2 * align128(sizeof(float) * R * pad_f32(R)) +
         2 * align128(sizeof(float) * R);
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

template <bool kDrop, bool kMask>
__global__ void __launch_bounds__(kF32Threads)
    mha_bwd_f32(const BwdOperands<float> a, BwdShape sh, int first, int d,
                Drop drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdGrid g = bwd_grid(sh, kF32Rows);
  const int R = g.R, Sq = sh.Sq, Skv = sh.Skv;
  const int bx = blockIdx.x + first;
  const bool keys = bx >= g.tq;  // dk and dv, else dq
  const int row0 = (keys ? bx - g.tq : bx) * R;
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
  float* delta_s = lse_s + align128(sizeof(float) * R) / sizeof(float);
  const int h = blockIdx.y, b = blockIdx.z;
  const int sqp = round_up(Sq, 16);
  const int live = round_up(sh.kv_len, 16);
  const int own = keys ? Skv : Sq;
  const int end = keys ? sqp : live;  // streamed rows

  // own rows (zero past Sq or Skv), their lse and delta (dq), and zeroed
  // outputs
  load_rows_f32(X0, ldq, keys ? a.k : a.q, keys ? a.sk : a.sq, b, h, row0,
                R, d, own);
  load_rows_f32(X1, ldq, keys ? a.v : a.dout, keys ? a.sv : a.sdo, b, h,
                row0, R, d, own);
  for (int i = threadIdx.x; i < R * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    O0[r * ldq + c] = 0.f;
    O1[r * ldq + c] = 0.f;
  }
  if (!keys) load_lse_delta(lse_s, delta_s, a, b, h, Sq, row0, R);
  // dk/dv tiles wholly past kv_len have p = 0: dk = dv = 0
  if (row0 < (keys ? live : sqp)) {
    for (int c0 = 0; c0 < end; c0 += R) {
      const int n = min(R, end - c0);
      __syncthreads();  // own rows, lse and delta; the last products done
      load_rows_f32(Y0, ldq, keys ? a.q : a.k, keys ? a.sq : a.sk, b, h, c0,
                    n, d, keys ? Sq : Skv);
      load_rows_f32(Y1, ldq, keys ? a.dout : a.v, keys ? a.sdo : a.sv, b, h,
                    c0, n, d, keys ? Sq : Skv);
      if (keys) load_lse_delta(lse_s, delta_s, a, b, h, Sq, c0, n);
      __syncthreads();
      // scores and dp: q k^T and do v^T (dq), or their transposes (dk, dv)
      block_gemm_f32<true>(X0, ldq, Y0, ldq, Ps, lds, R, n, d, false);
      block_gemm_f32<true>(X1, ldq, Y1, ldq, DSs, lds, R, n, d, false);
      __syncthreads();
      for (int i = threadIdx.x; i < R * n; i += blockDim.x) {
        const int r = i / n, j = i - r * n;
        const int q = keys ? c0 + j : row0 + r, k = keys ? row0 + r : c0 + j;
        const int ql = keys ? j : r;
        const float bias = key_bias<kMask>(a.colmask, k, sh.kv_len, Skv);
        const float p =
            q < Sq ? expf(Ps[r * lds + j] * sh.scale + bias - lse_s[ql])
                   : 0.f;
        float pm = p, gr = DSs[r * lds + j];
        if (kDrop) {
          const float m =
              attn_keep(drop, b, h, sh.H, Sq, q, k) ? drop.scale : 0.f;
          pm = p * m;
          gr = gr * m;
        }
        Ps[r * lds + j] = pm;
        DSs[r * lds + j] = p * (gr - delta_s[ql]) * sh.scale;
      }
      __syncthreads();
      // dq += ds k, or dk += ds^T q and dv += (p * mask)^T do
      block_gemm_f32<false>(DSs, lds, Y0, ldq, O0, ldq, R, d, n, true);
      if (keys)
        block_gemm_f32<false>(Ps, lds, Y1, ldq, O1, ldq, R, d, n, true);
    }
  }
  __syncthreads();
  const int rows = min(R, own - row0);
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

template <bool kDrop, bool kMask>
cudaError_t launch_bwd_f32(const BwdOperands<float>& a, int B, int d,
                           const BwdShape& sh, BwdPart part, const Drop& drop,
                           cudaStream_t stream) {
  const size_t bytes = mha_bwd_smem_f32(sh, d);
  if (d % 4 || bytes > kSmemPerBlock) return cudaErrorInvalidValue;
  int blocks, first;
  part_grid(bwd_grid(sh, kF32Rows), part, &blocks, &first);
  DEVT_TRY(set_smem(mha_bwd_f32<kDrop, kMask>, bytes));
  mha_bwd_f32<kDrop, kMask>
      <<<dim3(blocks, sh.H, B), kF32Threads, bytes, stream>>>(a, sh, first,
                                                              d, drop);
  return cudaGetLastError();
}

}  // namespace
