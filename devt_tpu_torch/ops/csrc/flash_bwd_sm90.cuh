// The blockwise attention backward on Hopper's wgmma and TMA: kernels 12
// (dq, with delta) and 13 (dk and dv) of the port in bfloat16 at head dims
// 16, 32 and 64, behind flash_bwd.cu's devt_flash_blocked_bwd (and kernel
// 10 as both), and with kRing behind ring_step.cu's kernel 15.
//
//   flash_bwd_dq_wgmma<d, ring>   kernel 12, devt_tpu/ops/flash_attention.py:
//                                 158 _bwd_dq_kernel
//   flash_bwd_dkv_wgmma<d, ring>  kernel 13, flash_attention.py:198
//                                 _bwd_dkv_kernel
//
// kRing (a template parameter; kernels 10, 12 and 13 compile without it)
// is kernel 15, flash_attention.py:814 _ring_bwd_kernel, one ring hop: q,
// o, do (B, S, H*d) and the packed kv shard (B, S, 2*H*d) by strides, the
// GLOBAL lse (B, S, H), an additive f32 column bias of 0 or -1e30 in place
// of kv_len, Sq = Skv = S, and f32 dq (B, S, H*d) and dk, dv in the packed
// dkv (B, S, 2*H*d), stored through strides, partials that sum across hops.
// p = exp(s scale + bias - lse), the bias added to each scaled score and
// lse subtracted before the exponent, as the plain version does.  Kernel
// 12 stages the bias of every key tile in shared memory before its loop
// (-inf past Skv, so no tile needs the kv_len mask); in kernel 13 a
// thread's two key rows are constant for its whole loop, so their bias
// sits in two registers.  A fully masked column gets p = 0 exactly, so its
// dk and dv are exact zeros; rows past S still get +inf lse and 0 delta.
//
// kBwdBlock (block_bwd_dq_sm90 and block_bwd_dkv_sm90, entries of their
// own on the same bodies, which are __forceinline__ functions, dq_body and
// dkv_body, so that the entries above keep their code) is the attention
// backward of kernels 2 and 8, devt_tpu/ops/fused_block.py:119
// _mha_fwd_bwd, on the fused blocks' packed qkv scratch: q, k, v its head
// views by strides, lse read from the residual lanes by stride, delta
// given (not taken from bf16 o and do: JAX takes it from the f32 datt and
// the f32 o), dq, dk, dv stored by strides into the packed dqkv in bf16.
// A recompute launch before them, block_bwd_pre_sm90 (at the end of this
// header, on the one-shot forward's layout: a query tile's whole score row
// in registers), writes att, do = round(datt) and that delta.  The rule
// block_bwd_on_wgmma (bfloat16, head dim 16-64, at most 256 live keys)
// picks this route in block_bwd_parts.cuh:block_attention_bwd_bf16.
//
// kBwdMha (mha_bwd_dq_sm90 and mha_bwd_dkv_sm90, entries in
// mha_bwd_sm90.cuh) is kernel 4, fused_mha's backward
// (devt_tpu/ops/flash_attention.py:589 _mha_bwd_kernel), at head dims
// 16-64: q, k, v the head views of the packed qkv, o, do and lse (B, S, H)
// read by strides, delta into (B*H, S) scratch in the dq launch's
// prologue, dq, dk, dv stored by strides into the packed dqkv.  Its
// compile-time kDrop option (the bodies' third template argument) applies
// the forward's dropout: each 64 x 64 score tile's keep bits are drawn
// once into shared memory before the tile's products (draw_keep_tile: a
// thread a 32-key word of one query, two buffers and one barrier of the
// consumer warpgroup a tile), dP is multiplied by the mask and, in kernel
// 13's body, p too before dV.  Both options are if constexpr, so the
// instances above keep their code.
//
// What they compute is flash_bwd.cu's contract, per (sequence, head):
//
//   delta = rowsum(f32(do) * f32(o))
//   p     = exp(q k^T * scale - lse), keys at or past kv_len at 0
//   ds    = p * (do v^T - delta) * scale
//   dq    = round(ds) @ k;  dv = round(p)^T @ do;  dk = round(ds)^T @ q
//
// every product and sum in f32, round() the cast to bf16.  q, k, v are
// (B, H, S, d) by element strides (the head views of a packed qkv need no
// copy); o, do, dq, dk, dv contiguous; lse and delta (B*H, Sq) f32.  dk
// and dv past kv_len are exact zeros; rows past Sq and Skv are neither
// read as data (TMA zero-fills them) nor written.  The f32 sums run in
// another order than the plain version's 128-key (128-query) blocks: dq
// sums kBwdDqKeys keys a tile, dk and dv kBwdDkvQueries queries a tile,
// each tile's product over its 16-row steps inside the tensor core.  That
// is inside the backward gate, 4 bf16 ulps of each tensor's largest
// element (PERF.md section 2).  One owner per output element, a fixed
// order, no atomics: two runs give the same bits.
//
// The rule (blocked_bwd_on_wgmma, mirrored by ops/flash_attention.py
// blocked_bwd_on_wgmma): bfloat16 at head dim 16, 32 or 64, any Sq, Skv
// and kv_len.  Every main-path shape is inside it: ViViT at image 384 at
// (1536, 592, 64), kv_len 577.  float32 and head dims 128 and 256 stay on
// attention_bwd.cuh's streamed body, which kernels 4, 10 and 15 share and
// which this header leaves as it was.
//
// What bounds them on an H100 (NVIDIA H100 80GB HBM3, 700 W) at (1536,
// 592, 64), kv_len 577: kernel 12 three products (S, dP, dQ: 201 GFLOP,
// 0.20 ms at 989 TFLOP/s) against q, k, v, o, do read, dq written, lse
// read and delta written (706 MB, 0.21 ms at 3.35 TB/s): bytes, by a
// hair; kernel 13 four products (269 GFLOP, 0.27 ms) against the same
// bytes: operations.  Both take one exponential a score (1536 x 592 x 640
// ex2, 0.14-0.16 ms at 16 a clock an SM).  The streamed body they replace
// ran mma.sync from ldmatrix fragments, re-read the other side's tiles
// from L2 for every 64 rows through a cp.async ring, and launched delta
// on its own.
//
// Design.  A CTA is one consumer warpgroup (128 threads) and a producer
// warp, as kernel 11's (flash_fwd_sm90.cuh): independent one-warpgroup
// chains, two or three CTAs an SM, beat warpgroups that share tiles on
// this card (PERF.md, kernel 11's findings).  One lane of the producer issues TMA loads
// (4-d maps over (d, row, head, sequence) in the swizzle of a d-value
// row) through a two-stage ring with full and empty mbarriers; the
// consumers run every product on wgmma.
//
// Kernel 12: a CTA owns 64 query rows of one (sequence, head).  It loads
// its q and do tiles once; in the prologue each thread reads its two rows
// of o and do from device memory, the quad sums them into delta, the
// first lane writes delta for kernel 13 (no launch of its own), and lse
// is read once, times log2 e.  Then per tile of kBwdDqKeys keys, K and V
// arriving through the ring:
//   S  = Q K^T     wgmma, A = the Q tile, B = K (K-major), one k16 step
//                  per 16 of d
//   dP = dO V^T    wgmma, A = the dO tile, B = V (K-major): issued before
//                  S is read, so it runs under the exponentials
//   p  = 2^(s scale log2 e - lse log2 e), keys >= kv_len at 0 (the last
//        tile only); ds = p (dP - delta) scale, packed to bf16 A fragments
//   dQ += dS K     wgmma, A = dS from registers, B = the same K tile read
//                  MN-major through the descriptor's transpose bit
// V is handed back once dP has read it, K once dQ has.  dq is stored from
// the accumulators at the end, rows past Sq skipped.  64-key tiles at
// three CTAs an SM: 122 registers at d = 64, no spill; 128-key tiles need
// two CTAs an SM and spill, and ran 40 % slower.
//
// Kernel 13: a CTA owns 64 keys of one (sequence, head), loads their k
// and v tiles once and walks the query tiles of kBwdDkvQueries rows, q
// and do through the ring; the producer warp's lanes stage each tile's
// lse (times log2 e) and delta in shared memory beside it, +inf and 0 for
// rows past Sq (there TMA gives zero q and do, so p = 0 and ds = 0, and
// no p * 0 can make a NaN).  Keys as the M side:
//   S^T  = K Q^T   wgmma, A = the K tile, B = Q (K-major)
//   dP^T = V dO^T  wgmma, A = the V tile, B = dO (K-major), issued before
//                  S^T is read
//   p^T = 2^(s scale log2 e - lse log2 e) per query column;
//   ds^T = p^T (dP^T - delta) scale; both packed to bf16 A fragments
//   dV += P^T dO   wgmma, A = round(p^T) from registers, B = the same dO
//                  tile MN-major
//   dK += dS^T Q   wgmma, A = round(ds^T) from registers, B = the same Q
//                  tile MN-major
// so one shared tile of q and of do serves as a K-major and as an
// MN-major operand.  dV and dK are issued together after ds^T, when no
// f32 tile is live beside the fragments: issuing dV before ds^T (under
// its arithmetic) held p^T, dP^T and the fragments at once, which spilled
// at d = 64 and made ptxas serialise the wgmmas (C7512), 15 % slower.
// 64-query tiles at two CTAs an SM (168 registers at d = 64).  A key row
// at or past kv_len only ever meets itself (the products are row by row
// in M), so the epilogue stores zeros there instead of masking inside the
// loop; a CTA whose keys all lie past kv_len stores zeros and leaves.
//
// No runtime test sits between the wgmmas of a sequence (ptxas serialises
// them otherwise: C7511): the tile widths are compile-time constants, one
// template instance per head dim, and kernel 12's kv_len mask is a
// template parameter of its last tile's step.  Each tile waits for its
// accumulating products before the next tile's score products: leaving
// them in flight made ptxas serialise them across the loop (C7515) and ran
// 15-50 % slower.  tools/wgmma_variants.py times the tilings (PERF.md,
// kernels 12 and 13's findings).

#pragma once

#include <type_traits>

#include "flash_fwd_sm90.cuh"

namespace {

// kernel 12: keys a K/V tile, stages of the ring, CTAs an SM that the
// register cap of __launch_bounds__ leaves room for
constexpr int kBwdDqKeys = 64;
constexpr int kBwdDqStages = 2;
constexpr int kBwdDqCTAs = 3;
// kernel 13: queries a Q/dO tile, stages, CTAs an SM (64-query tiles at
// two CTAs an SM ran 3 % ahead of 32-query tiles at three in every round
// of tools/wgmma_variants.py: PERF.md)
constexpr int kBwdDkvQueries = 64;
constexpr int kBwdDkvStages = 2;
constexpr int kBwdDkvCTAs = 2;
constexpr int kBwdThreads = 128 + 32;  // a consumer warpgroup, a producer

// which blockwise backwards (kernels 12, 13) take these bodies: those whose
// forward (kernel 11) takes its wgmma body, online_on_wgmma's rule
__host__ __device__ constexpr bool blocked_bwd_on_wgmma(int dtype, int d) {
  return online_on_wgmma(dtype, d);
}

// 1 KB of slack to align the dynamic base, the CTA's own two tiles of 64
// rows, and per stage the two streamed tiles (each region 1024-byte
// aligned, the 128-byte swizzle's period)
__host__ __device__ constexpr size_t bwd_smem(int hd, int stages, int rows) {
  return 1024 + 2 * align1024(static_cast<size_t>(64) * hd * 2) +
         2 * stages * align1024(static_cast<size_t>(rows) * hd * 2);
}

// the operands the TMA maps do not carry
struct FlashBwd {
  const bf16 *o, *dout;  // (B, H, Sq, d) contiguous
  const float* lse;      // (B*H, Sq)
  float* delta;          // (B*H, Sq): kernel 12 writes it, 13 reads it
  bf16 *dq, *dk, *dv;    // (B, H, Sq or Skv, d) contiguous
  int H, Sq, Skv, kv_len;
  float scale;
};

// kernel 15's (kRing): element strides (sequence, head, row) of o, do and
// dq (qs), of dk and dv (ks) and of lse (ls); the f32 outputs; the additive
// column bias (Skv values).  delta stays (B*H, Sq) scratch, lse is read
// through ls, and the bf16 outputs of the base are unused.  A type of its
// own, so that the other instances' parameters stay as they were.
struct RingBwd : FlashBwd {
  long long qs[3], ks[3], ls[3];
  float *dqf, *dkf, *dvf;
  const float* mask;
};

// kernels 2's and 8's attention backward (kBwdBlock, the fused blocks'
// packed qkv scratch): lse read through ls (element strides (sequence,
// head, row) into the residual lanes), delta given (the recompute launch,
// block_bwd_pre_sm90, wrote it from the f32 datt and the f32 o), the bf16
// dq, dk and dv stored through gs (element strides (sequence, head, row))
// into the packed dqkv.  o is unused.  A type of its own, as RingBwd.
struct BlockBwd : FlashBwd {
  long long ls[3], gs[3];
};

// kernel 4's (kBwdMha, fused_mha's backward on the packed qkv): q, k, v
// the head views of qkv by strides, o and do (B, S, H*d) read through os
// (element strides (sequence, head, row)), lse (B, S, H) through ls, delta
// (B*H, S) scratch that the dq launch writes and the dk/dv launch reads,
// the bf16 dq, dk and dv stored through gs into the packed dqkv; with the
// bodies' kDrop option the forward's dropout, drop.  A type of its own,
// as RingBwd.
struct MhaBwd : FlashBwd {
  long long os[3], ls[3], gs[3];
  Drop drop;
};

// the bodies' compile-time options: kernels 10, 12, 13 (kBwdFlash), 15
// (kBwdRing), the attention backward of kernels 2 and 8 (kBwdBlock),
// kernel 4 (kBwdMha)
constexpr int kBwdFlash = 0, kBwdRing = 1, kBwdBlock = 2, kBwdMha = 3;

template <int kMode>
using BwdArgsOf = std::conditional_t<
    kMode == kBwdRing, RingBwd,
    std::conditional_t<
        kMode == kBwdBlock, BlockBwd,
        std::conditional_t<kMode == kBwdMha, MhaBwd, FlashBwd>>>;

template <bool kRing>
using BwdArgs = BwdArgsOf<kRing ? kBwdRing : kBwdFlash>;

// d[0, 16) = (acc ? d : 0) + A (64 x 16, shared, K-major) B (16 x 32,
// shared, K-major)
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t a, uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

// a 64 x N score-like step: d = (acc ? d : 0) + A (shared) B^T (shared),
// both K-major
template <int N>
__device__ __forceinline__ void wgmma_nt(float* d, uint64_t a, uint64_t b,
                                         int acc) {
  if constexpr (N == 32) {
    wgmma_ss_n32(d, a, b, acc);
  } else {
    wgmma_qk<N>(d, a, b, acc);
  }
}

// X (64 x N) = A (64 x HD tile) B^T (N x HD tile), one k16 step per 16 of
// HD, issued and committed as one group
template <int HD, int N>
__device__ __forceinline__ void issue_nt(float* x, uint64_t a, uint64_t b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_nt<N>(x, a + 2 * kk, b + 2 * kk, kk);
  wgmma_commit();
}

// Y (64 x HD) += F (64 x N, A fragments in registers) T (N x HD tile read
// MN-major), one k16 step per 16 rows of T, committed as one group
template <int HD, int N>
__device__ __forceinline__ void issue_acc(float* y, const uint32_t (*f)[4],
                                          uint64_t t) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_pv<HD>(y, f[kk], t + ((16 * kk * HD * 2) >> 4), 1);
  wgmma_commit();
}

// an accumulator tile (64 x N f32) in bf16 as the A fragments of its N / 16
// k16 steps (the accumulator layout of two 8-column blocks is the A layout
// of one 16-column step)
template <int N>
__device__ __forceinline__ void to_frags(uint32_t (*f)[4], const float* x) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const float* p = x + 8 * kk;
    f[kk][0] = pack_bf16(p[0], p[1]);
    f[kk][1] = pack_bf16(p[2], p[3]);
    f[kk][2] = pack_bf16(p[4], p[5]);
    f[kk][3] = pack_bf16(p[6], p[7]);
  }
}

template <int N>
__device__ __forceinline__ void fence_all(float* x) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(x[i]);
}

__device__ __forceinline__ float pos_inf() {
  return __int_as_float(0x7f800000);
}

// a barrier of the consumer warpgroup's 128 threads (id 1; the producer
// warp does not take part)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// bit i (i < n, 1 <= n <= 32) is the keep bit of flat attention element
// flat0 + i (site kSiteAttn): one Philox draw a 4 consecutive elements
__device__ __forceinline__ uint32_t keep_word(const Drop& d,
                                              unsigned long long flat0,
                                              int n) {
  uint32_t w = 0;
  const unsigned long long end = flat0 + n;
#pragma unroll 1
  for (unsigned long long i4 = flat0 >> 2; 4 * i4 < end; ++i4) {
    const uint4 x = philox4(d, kSiteAttn, i4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long pos = static_cast<long long>(4 * i4 + e) -
                            static_cast<long long>(flat0);
      if (pos >= 0 && pos < n && word_of(x, e) >= d.cutoff) w |= 1u << pos;
    }
  }
  return w;
}

// the keep bits of a 64 x 64 score tile of (sequence b, head h) of an
// S-token call, one word a consumer thread: word [r][w] bit i is the keep
// bit of (query q0 + r, key k0 + 32 w + i); queries past S and keys past
// kv_len get 0 (their p is 0).  Kernel 4's bodies draw them once a tile:
// a draw gives 4 consecutive keys of one query, and a thread's fragment
// holds 2 (query-major) or 1 (key-major) of them.
__device__ __forceinline__ void draw_keep_tile(uint32_t (*keep)[2],
                                               const Drop& d, int b, int h,
                                               int H, int S, int q0, int k0,
                                               int kv_len) {
  const int r = threadIdx.x >> 1, w = threadIdx.x & 1;
  const int q = q0 + r, k = k0 + 32 * w;
  const int n = min(32, kv_len - k);
  keep[r][w] =
      q < S && n > 0
          ? keep_word(d,
                      ((static_cast<unsigned long long>(b) * H + h) * S + q) *
                              S + k,
                      n)
          : 0u;
}

// stores rows row0 + 8 hh of a 64 x HD accumulator tile of this thread as
// bf16 pairs into the contiguous (rows, HD) slab at base, rows >= `rows`
// skipped, rows >= `live` stored as zeros
template <int HD>
__device__ __forceinline__ void store_tile(bf16* base, const float* acc,
                                           int row0, int tq4, int rows,
                                           int live) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= rows) continue;
    const bool keep = row < live;  // a select: NaN * 0 is NaN
    bf16* dst = base + static_cast<size_t>(row) * HD + 2 * tq4;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj)
      *reinterpret_cast<uint32_t*>(dst + 8 * jj) =
          pack_bf16(keep ? acc[4 * jj + 2 * hh] : 0.f,
                    keep ? acc[4 * jj + 2 * hh + 1] : 0.f);
  }
}

// stores rows row0 + 8 hh of a 64 x HD accumulator tile of this thread as
// bf16 pairs at base + row * rs (element strides), rows >= `rows` skipped,
// rows >= `live` stored as zeros
template <int HD>
__device__ __forceinline__ void store_tile_rs(bf16* base, const float* acc,
                                              int row0, int tq4, int rows,
                                              int live, long long rs) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= rows) continue;
    const bool keep = row < live;  // a select: NaN * 0 is NaN
    bf16* dst = base + row * rs + 2 * tq4;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj)
      *reinterpret_cast<uint32_t*>(dst + 8 * jj) =
          pack_bf16(keep ? acc[4 * jj + 2 * hh] : 0.f,
                    keep ? acc[4 * jj + 2 * hh + 1] : 0.f);
  }
}

// stores rows row0 + 8 hh of a 64 x HD accumulator tile of this thread as
// f32 pairs at base + row * rs (element strides), rows >= `rows` skipped
template <int HD>
__device__ __forceinline__ void store_tile_f32(float* base, const float* acc,
                                               int row0, int tq4, int rows,
                                               long long rs) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= rows) continue;
    float* dst = base + row * rs + 2 * tq4;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj)
      *reinterpret_cast<float2*>(dst + 8 * jj) =
          make_float2(acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]);
  }
}

// ---------------------------------------------------------------------------
// kernel 12: dq, and delta
// ---------------------------------------------------------------------------

// kernel 12's step over key tile j, K and V from ring stage j % stages
// (bars: K full, V full, K empty, V empty per stage): S and dP, p and ds
// in registers, dQ += dS K.  kMask sets the scores of keys past kv_len to
// p = 0; only the last tile takes it, as a template parameter, so that no
// runtime test sits among the wgmmas.  kRing (kernel 15) adds the staged
// column bias msk to each scaled score and takes p = 2^((s - lse) log2 e)
// with lc the raw lse, as the plain version subtracts (a row whose lse is
// about -1e30 then gives p = 1 where it does, not 2^(rounding error)); the
// bias is -inf past Skv, so every tile takes it and none needs kMask.
// kDrop (kernel 4 with dropout) multiplies dP by the mask of the tile's
// keep bits, keep[query row][key / 32] (draw_keep_tile), `ds` the kept
// probabilities' scale: ds = p (dP mask - delta) scale.
template <int HD, bool kMask, bool kRing = false, bool kDrop = false>
__device__ __forceinline__ void dq_tile(int j, const FlashBwd& a,
                                        const unsigned char* KV,
                                        uint64_t* bars, uint64_t qdesc,
                                        uint64_t dodesc, const float (&lc)[2],
                                        const float (&dl)[2], int tq4,
                                        int lane, float (&dq)[HD / 2],
                                        const float* msk = nullptr,
                                        const uint32_t (*keep)[2] = nullptr,
                                        float dscale = 0.f) {
  constexpr int N = kBwdDqKeys;
  constexpr int S = kBwdDqStages;
  constexpr uint32_t kSlot = align1024(N * HD * 2);
  static_assert(!kDrop || N == 64, "keep bits are drawn for 64-key tiles");
  const float c = a.scale * kLog2e;
  const int st = j % S;
  const uint32_t ph = (j / S) & 1;
  const unsigned char* Ks = KV + 2 * st * kSlot;
  const uint64_t kdesc = smem_desc<HD>(Ks);
  const uint64_t vdesc = smem_desc<HD>(Ks + kSlot);

  // S = Q K^T and dP = dO V^T: register 4 jj + e holds row gq + 8 (e / 2)
  // of the warp's 16, key column 8 jj + 2 tq4 + e % 2 of the tile
  float s[N / 2], dp[N / 2];
  mbar_wait(&bars[st], ph);
  issue_nt<HD, N>(s, qdesc, kdesc);
  mbar_wait(&bars[S + st], ph);
  issue_nt<HD, N>(dp, dodesc, vdesc);
  wgmma_wait<1>();  // S
  fence_all<N / 2>(s);

  if constexpr (kMask) {  // keys past kv_len: p = 0
    const int live = a.kv_len - j * N;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * jj + 2 * tq4 + (e & 1) >= live) s[4 * jj + e] = neg_inf();
  }
  if constexpr (kRing) {
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
      const float2 bias =
          *reinterpret_cast<const float2*>(msk + j * N + 8 * jj + 2 * tq4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[4 * jj + e];
        x = ex2((fmaf(x, a.scale, e & 1 ? bias.y : bias.x) - lc[e >> 1]) *
                kLog2e);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      s[i] = ex2(fmaf(s[i], c, -lc[(i >> 1) & 1]));
  }

  wgmma_wait_all();
  fence_all<N / 2>(dp);
  if (lane == 0) mbar_arrive(&bars[3 * S + st]);  // V read
  if constexpr (kDrop) {
    // register 4 jj + e: query row gq + 8 (e / 2) of the warp's 16, key
    // 8 jj + 2 tq4 + e % 2 (in word jj / 4 of the row)
    const int rw = 16 * (threadIdx.x >> 5) + (lane >> 2);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint32_t w0 = keep[rw + 8 * hh][0], w1 = keep[rw + 8 * hh][1];
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          const int key = (8 * jj + 2 * tq4 + (e & 1)) & 31;
          const float m = ((jj < 4 ? w0 : w1) >> key) & 1 ? dscale : 0.f;
          float& x = dp[4 * jj + e];
          x = s[4 * jj + e] * (x * m - dl[hh]) * a.scale;
        }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]) * a.scale;
  }
  uint32_t ds[N / 16][4];
  to_frags<N>(ds, dp);

  // dQ += dS K, K read MN-major
  issue_acc<HD, N>(dq, ds, kdesc);
  wgmma_wait_all();
  if (lane == 0) mbar_arrive(&bars[2 * S + st]);  // K read
}

// kernel 12's body: the __global__ entries below take it with their
// option (kMode, and kDrop for kBwdMha), the tensor maps being their
// __grid_constant__ parameters
template <int HD, int kMode, bool kDrop = false>
__device__ __forceinline__ void dq_body(const CUtensorMap& tq,
                                        const CUtensorMap& tk,
                                        const CUtensorMap& tv,
                                        const CUtensorMap& tdo,
                                        const BwdArgsOf<kMode>& a) {
  constexpr bool kRing = kMode == kBwdRing;
  constexpr int RB = HD * 2;  // bytes of a row
  constexpr int N = kBwdDqKeys;
  constexpr int S = kBwdDqStages;
  constexpr uint32_t kTile = N * RB;  // bytes of a K or V tile
  constexpr uint32_t kSlot = align1024(kTile);
  extern __shared__ unsigned char smem_raw[];
  // per stage: K full, V full, K empty, V empty; then Q and dO full
  __shared__ __align__(8) uint64_t bars[4 * S + 1];
  uint64_t* const fullk = bars;
  uint64_t* const fullv = bars + S;
  uint64_t* const emptyk = bars + 2 * S;
  uint64_t* const emptyv = bars + 3 * S;
  uint64_t* const qfull = bars + 4 * S;
  unsigned char* Qs =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* DOs = Qs + align1024(64 * RB);
  unsigned char* KV = DOs + align1024(64 * RB);  // stage st: K, then V
  const int parts = (a.Sq + 63) / 64;
  const int bh = blockIdx.x / parts, part = blockIdx.x - bh * parts;
  const int b = bh / a.H, h = bh - b * a.H;
  const int ntiles = (a.kv_len + N - 1) / N;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&fullk[i], 1);
      mbar_init(&fullv[i], 1);
      mbar_init(&emptyk[i], 4);
      mbar_init(&emptyv[i], 4);
    }
    mbar_init(qfull, 1);
    mbar_fence_init();
  }
  if constexpr (kRing) {  // the column bias of every key tile, -inf past Skv
    float* msk = reinterpret_cast<float*>(KV + 2 * S * kSlot);
    for (int c = threadIdx.x; c < ntiles * N; c += kBwdThreads)
      msk[c] = c < a.Skv ? a.mask[c] : neg_inf();
  }
  __syncthreads();

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq4 = lane & 3;
  if (threadIdx.x >= 128) {
    // the producer: one lane issues every load
    if (lane == 0) {
      mbar_expect_tx(qfull, 2 * 64 * RB);
      tma_load_4d(Qs, &tq, qfull, 0, 64 * part, h, b);
      tma_load_4d(DOs, &tdo, qfull, 0, 64 * part, h, b);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % S;
        const uint32_t freed = ((j / S) & 1) ^ 1;
        unsigned char* Ks = KV + 2 * st * kSlot;
        mbar_wait(&emptyk[st], freed);
        mbar_expect_tx(&fullk[st], kTile);
        tma_load_4d(Ks, &tk, &fullk[st], 0, j * N, h, b);
        mbar_wait(&emptyv[st], freed);
        mbar_expect_tx(&fullv[st], kTile);
        tma_load_4d(Ks + kSlot, &tv, &fullv[st], 0, j * N, h, b);
      }
    }
    return;
  }

  // delta of rows gq, gq + 8 of the warp's 16 (the quad's four lanes take
  // a quarter of the row each), written for kernel 13; lse times log2 e,
  // +inf past Sq (p = 0 there).  kBwdBlock reads the given delta, and lse
  // through its strides.
  const int row0 = 64 * part + 16 * warp + gq;
  const size_t head = static_cast<size_t>(bh) * a.Sq;
  float dl[2], lc[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if constexpr (kMode == kBwdBlock) {
      const bool ok = row < a.Sq;
      dl[hh] = ok ? a.delta[head + row] : 0.f;
      lc[hh] = ok ? a.lse[b * a.ls[0] + h * a.ls[1] + row * a.ls[2]] * kLog2e
                  : pos_inf();
      continue;
    }
    float acc = 0.f;
    if (row < a.Sq) {
      size_t g;
      if constexpr (kRing)
        g = b * a.qs[0] + h * a.qs[1] + row * a.qs[2] + tq4 * (HD / 4);
      else if constexpr (kMode == kBwdMha)
        g = b * a.os[0] + h * a.os[1] + row * a.os[2] + tq4 * (HD / 4);
      else
        g = (head + row) * HD + tq4 * (HD / 4);
      const __nv_bfloat162* op =
          reinterpret_cast<const __nv_bfloat162*>(a.o + g);
      const __nv_bfloat162* gp =
          reinterpret_cast<const __nv_bfloat162*>(a.dout + g);
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        const float2 x = __bfloat1622float2(op[i]);
        const float2 y = __bfloat1622float2(gp[i]);
        acc += y.x * x.x;
        acc += y.y * x.y;
      }
    }
    dl[hh] = quad_sum(acc);
    if constexpr (kRing)
      lc[hh] = row < a.Sq ? a.lse[b * a.ls[0] + h * a.ls[1] + row * a.ls[2]]
                          : pos_inf();
    else if constexpr (kMode == kBwdMha)
      lc[hh] = row < a.Sq ? a.lse[b * a.ls[0] + h * a.ls[1] + row * a.ls[2]] *
                                kLog2e
                          : pos_inf();
    else
      lc[hh] = row < a.Sq ? a.lse[head + row] * kLog2e : pos_inf();
    if (tq4 == 0 && row < a.Sq) a.delta[head + row] = dl[hh];
  }

  const uint64_t qdesc = smem_desc<HD>(Qs), dodesc = smem_desc<HD>(DOs);
  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  mbar_wait(qfull, 0);
  if constexpr (kRing) {
#pragma unroll 1
    for (int j = 0; j < ntiles; ++j)
      dq_tile<HD, false, true>(
          j, a, KV, bars, qdesc, dodesc, lc, dl, tq4, lane, dq,
          reinterpret_cast<const float*>(KV + 2 * S * kSlot));
    fence_all<HD / 2>(dq);
    store_tile_f32<HD>(a.dqf + b * a.qs[0] + h * a.qs[1], dq, row0, tq4,
                       a.Sq, a.qs[2]);
  } else if constexpr (kMode == kBwdMha && kDrop) {
    // the keep bits of each key tile, drawn before its products into one
    // of two buffers: a tile's barrier also tells the drawing threads that
    // the tile before the last is read
    __shared__ uint32_t keep[2][64][2];
#pragma unroll 1
    for (int j = 0; j < ntiles; ++j) {
      draw_keep_tile(keep[j & 1], a.drop, b, h, a.H, a.Sq, 64 * part, j * N,
                     a.kv_len);
      consumer_sync();
      if (j < ntiles - 1)
        dq_tile<HD, false, false, true>(j, a, KV, bars, qdesc, dodesc, lc,
                                        dl, tq4, lane, dq, nullptr,
                                        keep[j & 1], a.drop.scale);
      else
        dq_tile<HD, true, false, true>(j, a, KV, bars, qdesc, dodesc, lc, dl,
                                       tq4, lane, dq, nullptr, keep[j & 1],
                                       a.drop.scale);
    }
    fence_all<HD / 2>(dq);
    store_tile_rs<HD>(a.dq + b * a.gs[0] + h * a.gs[1], dq, row0, tq4, a.Sq,
                      a.Sq, a.gs[2]);
  } else {
#pragma unroll 1
    for (int j = 0; j < ntiles - 1; ++j)
      dq_tile<HD, false>(j, a, KV, bars, qdesc, dodesc, lc, dl, tq4, lane,
                         dq);
    // the last tile (kv_len >= 1: there is one) masks keys past kv_len
    dq_tile<HD, true>(ntiles - 1, a, KV, bars, qdesc, dodesc, lc, dl, tq4,
                      lane, dq);
    fence_all<HD / 2>(dq);

    if constexpr (kMode == kBwdBlock || kMode == kBwdMha)
      store_tile_rs<HD>(a.dq + b * a.gs[0] + h * a.gs[1], dq, row0, tq4,
                        a.Sq, a.Sq, a.gs[2]);
    else
      store_tile<HD>(a.dq + head * HD, dq, row0, tq4, a.Sq, a.Sq);
  }
}

template <int HD, bool kRing = false>
__global__ void __launch_bounds__(kBwdThreads, kBwdDqCTAs)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const BwdArgs<kRing> a) {
  dq_body<HD, kRing ? kBwdRing : kBwdFlash>(tq, tk, tv, tdo, a);
}

// kernel 12's body for the attention backward of kernels 2 and 8
template <int HD>
__global__ void __launch_bounds__(kBwdThreads, kBwdDqCTAs)
    block_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const BlockBwd a) {
  dq_body<HD, kBwdBlock>(tq, tk, tv, tdo, a);
}

// ---------------------------------------------------------------------------
// kernel 13: dk and dv
// ---------------------------------------------------------------------------

// kernel 13's body, taken as kernel 12's
template <int HD, int kMode, bool kDrop = false>
__device__ __forceinline__ void dkv_body(const CUtensorMap& tq,
                                         const CUtensorMap& tk,
                                         const CUtensorMap& tv,
                                         const CUtensorMap& tdo,
                                         const BwdArgsOf<kMode>& a) {
  constexpr bool kRing = kMode == kBwdRing;
  constexpr int RB = HD * 2;
  constexpr int N = kBwdDkvQueries;
  constexpr int S = kBwdDkvStages;
  constexpr uint32_t kTile = N * RB;  // bytes of a Q or dO tile
  constexpr uint32_t kSlot = align1024(kTile);
  extern __shared__ unsigned char smem_raw[];
  // per stage: Q full (with lse, delta), dO full, empty; then K and V full
  __shared__ __align__(8) uint64_t bars[3 * S + 1];
  // per stage: lse times log2 e and delta of the tile's queries
  __shared__ __align__(8) float lsm[S][N], dsm[S][N];
  uint64_t* const fullq = bars;
  uint64_t* const fulld = bars + S;
  uint64_t* const empty = bars + 2 * S;
  uint64_t* const kvfull = bars + 3 * S;
  unsigned char* Ks =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Vs = Ks + align1024(64 * RB);
  unsigned char* QD = Vs + align1024(64 * RB);  // stage st: Q, then dO
  const int parts = (a.Skv + 63) / 64;
  const int bh = blockIdx.x / parts, part = blockIdx.x - bh * parts;
  const int b = bh / a.H, h = bh - b * a.H;
  const int key0 = 64 * part;
  const size_t kbase = (static_cast<size_t>(bh) * a.Skv + key0) * HD;

  if constexpr (kMode == kBwdBlock || kMode == kBwdMha) {
    if (key0 >= a.kv_len) {  // every key of the block masked: zeros
      const int n = min(64, a.Skv - key0) * HD / 2;
      bf16* dk = a.dk + b * a.gs[0] + h * a.gs[1] + key0 * a.gs[2];
      bf16* dv = a.dv + b * a.gs[0] + h * a.gs[1] + key0 * a.gs[2];
      for (int i = threadIdx.x; i < n; i += kBwdThreads) {
        const long long e = (i / (HD / 2)) * a.gs[2] + 2 * (i % (HD / 2));
        *reinterpret_cast<uint32_t*>(dk + e) = 0u;
        *reinterpret_cast<uint32_t*>(dv + e) = 0u;
      }
      return;
    }
  } else if (!kRing && key0 >= a.kv_len) {  // every key of the block masked
    const int n = min(64, a.Skv - key0) * HD / 2;
    uint32_t* dk = reinterpret_cast<uint32_t*>(a.dk + kbase);
    uint32_t* dv = reinterpret_cast<uint32_t*>(a.dv + kbase);
    for (int i = threadIdx.x; i < n; i += kBwdThreads) dk[i] = dv[i] = 0u;
    return;
  }
  const int ntiles = (a.Sq + N - 1) / N;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&fullq[i], 32);  // the producer's lanes, and Q's bytes
      mbar_init(&fulld[i], 1);
      mbar_init(&empty[i], 4);
    }
    mbar_init(kvfull, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq4 = lane & 3;
  const size_t head = static_cast<size_t>(bh) * a.Sq;
  if (threadIdx.x >= 128) {
    // the producer: lane 0 issues the loads, every lane stages lse and
    // delta
    if (lane == 0) {
      mbar_expect_tx(kvfull, 2 * 64 * RB);
      tma_load_4d(Ks, &tk, kvfull, 0, key0, h, b);
      tma_load_4d(Vs, &tv, kvfull, 0, key0, h, b);
    }
    for (int j = 0; j < ntiles; ++j) {
      const int st = j % S;
      mbar_wait(&empty[st], ((j / S) & 1) ^ 1);
      for (int i = lane; i < N; i += 32) {
        const int r = j * N + i;
        const bool ok = r < a.Sq;
        if constexpr (kRing)  // the raw lse: kernel 12's kRing exponent
          lsm[st][i] =
              ok ? a.lse[b * a.ls[0] + h * a.ls[1] + r * a.ls[2]] : pos_inf();
        else if constexpr (kMode == kBwdBlock || kMode == kBwdMha)
          lsm[st][i] =
              ok ? a.lse[b * a.ls[0] + h * a.ls[1] + r * a.ls[2]] * kLog2e
                 : pos_inf();
        else
          lsm[st][i] = ok ? a.lse[head + r] * kLog2e : pos_inf();
        dsm[st][i] = ok ? a.delta[head + r] : 0.f;
      }
      unsigned char* Qs = QD + 2 * st * kSlot;
      if (lane == 0) {
        mbar_expect_tx(&fullq[st], kTile);
        tma_load_4d(Qs, &tq, &fullq[st], 0, j * N, h, b);
        mbar_expect_tx(&fulld[st], kTile);
        tma_load_4d(Qs + kSlot, &tdo, &fulld[st], 0, j * N, h, b);
      } else {
        mbar_arrive(&fullq[st]);
      }
    }
    return;
  }

  const uint64_t kdesc = smem_desc<HD>(Ks), vdesc = smem_desc<HD>(Vs);
  const float c = a.scale * kLog2e;
  // kRing: the column bias of this thread's two key rows, the same for the
  // whole loop (rows past Skv are never stored)
  float kb[2] = {0.f, 0.f};
  if constexpr (kRing) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = key0 + 16 * warp + gq + 8 * hh;
      kb[hh] = key < a.Skv ? a.mask[key] : 0.f;
    }
  }
  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  // kDrop: the keep bits of each query tile, keep[query][key / 32], drawn
  // before its products into one of two buffers, as kernel 12's
  static_assert(!kDrop || N == 64, "keep bits are drawn for 64-query tiles");
  uint32_t(*keep)[64][2] = nullptr;
  if constexpr (kDrop) {
    __shared__ uint32_t bufs[2][64][2];
    keep = bufs;
  }
  mbar_wait(kvfull, 0);
#pragma unroll 1
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % S;
    const uint32_t ph = (j / S) & 1;
    const unsigned char* Qs = QD + 2 * st * kSlot;
    const uint64_t qdesc = smem_desc<HD>(Qs);
    const uint64_t dodesc = smem_desc<HD>(Qs + kSlot);
    if constexpr (kDrop) {
      draw_keep_tile(keep[j & 1], a.drop, b, h, a.H, a.Sq, j * N, key0,
                     a.kv_len);
      consumer_sync();
    }

    // S^T = K Q^T and dP^T = V dO^T: register 4 jj + e holds key row gq +
    // 8 (e / 2) of the warp's 16, query column 8 jj + 2 tq4 + e % 2
    float s[N / 2], dp[N / 2];
    mbar_wait(&fullq[st], ph);
    issue_nt<HD, N>(s, kdesc, qdesc);
    mbar_wait(&fulld[st], ph);
    issue_nt<HD, N>(dp, vdesc, dodesc);
    wgmma_wait<1>();  // S^T
    fence_all<N / 2>(s);
    const float* lq = lsm[st];
    const float* dlt = dsm[st];
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
      const float2 l = *reinterpret_cast<const float2*>(lq + 8 * jj + 2 * tq4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[4 * jj + e];
        if constexpr (kRing)
          x = ex2((fmaf(x, a.scale, kb[e >> 1]) - (e & 1 ? l.y : l.x)) *
                  kLog2e);
        else
          x = ex2(fmaf(x, c, -(e & 1 ? l.y : l.x)));
      }
    }
    wgmma_wait_all();  // dP^T
    fence_all<N / 2>(dp);
    if constexpr (kDrop) {
      // register 4 jj + e: key row gq + 8 (e / 2) of the warp's 16 (bit
      // of word warp / 2), query column 8 jj + 2 tq4 + e % 2; ds from p,
      // then p times the mask for dV
      const int kw = warp >> 1, kb0 = (16 * warp + gq) & 31;
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj) {
        const float2 g =
            *reinterpret_cast<const float2*>(dlt + 8 * jj + 2 * tq4);
        const uint32_t w[2] = {keep[j & 1][8 * jj + 2 * tq4][kw],
                               keep[j & 1][8 * jj + 2 * tq4 + 1][kw]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float m =
              (w[e & 1] >> (kb0 + 8 * (e >> 1))) & 1 ? a.drop.scale : 0.f;
          float& x = dp[4 * jj + e];
          x = s[4 * jj + e] * (x * m - (e & 1 ? g.y : g.x)) * a.scale;
          s[4 * jj + e] *= m;
        }
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj) {
        const float2 g =
            *reinterpret_cast<const float2*>(dlt + 8 * jj + 2 * tq4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = dp[4 * jj + e];
          x = s[4 * jj + e] * (x - (e & 1 ? g.y : g.x)) * a.scale;
        }
      }
    }
    // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major; p and ds are
    // both in bf16 fragments first, so no f32 tile is live under them
    uint32_t pf[N / 16][4], df[N / 16][4];
    to_frags<N>(pf, s);
    to_frags<N>(df, dp);
    issue_acc<HD, N>(dv, pf, dodesc);
    issue_acc<HD, N>(dk, df, qdesc);
    wgmma_wait_all();
    if (lane == 0) mbar_arrive(&empty[st]);  // Q, dO, lse, delta read
  }
  fence_all<HD / 2>(dk);
  fence_all<HD / 2>(dv);

  const int row0 = 16 * warp + gq;
  const int rows = min(64, a.Skv - key0), live = a.kv_len - key0;
  if constexpr (kRing) {
    const size_t kr = b * a.ks[0] + h * a.ks[1] + key0 * a.ks[2];
    store_tile_f32<HD>(a.dkf + kr, dk, row0, tq4, rows, a.ks[2]);
    store_tile_f32<HD>(a.dvf + kr, dv, row0, tq4, rows, a.ks[2]);
  } else if constexpr (kMode == kBwdBlock || kMode == kBwdMha) {
    const long long kr = b * a.gs[0] + h * a.gs[1] + key0 * a.gs[2];
    store_tile_rs<HD>(a.dk + kr, dk, row0, tq4, rows, live, a.gs[2]);
    store_tile_rs<HD>(a.dv + kr, dv, row0, tq4, rows, live, a.gs[2]);
  } else {
    store_tile<HD>(a.dk + kbase, dk, row0, tq4, rows, live);
    store_tile<HD>(a.dv + kbase, dv, row0, tq4, rows, live);
  }
}

template <int HD, bool kRing = false>
__global__ void __launch_bounds__(kBwdThreads, kBwdDkvCTAs)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const BwdArgs<kRing> a) {
  dkv_body<HD, kRing ? kBwdRing : kBwdFlash>(tq, tk, tv, tdo, a);
}

// kernel 13's body for the attention backward of kernels 2 and 8
template <int HD>
__global__ void __launch_bounds__(kBwdThreads, kBwdDkvCTAs)
    block_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const BlockBwd a) {
  dkv_body<HD, kBwdBlock>(tq, tk, tv, tdo, a);
}

// ---------------------------------------------------------------------------
// kernels 2 and 8: the attention recompute before the two bodies
// ---------------------------------------------------------------------------

// the rule, written once: which attention backwards of the fused blocks
// (kernels 2 and 8, fused_block_bwd.cu and attn_half.cu) take
// block_bwd_pre_sm90 and the two bodies with kBwdBlock: bfloat16 at head
// dim 16, 32 or 64 with at most 256 live keys (the recompute holds a
// query tile's whole score row, as the one-shot forward does); the others
// keep block_bwd_parts.cuh's attention_bwd_bf16 (f32: attention_bwd_f32)
__host__ __device__ constexpr bool block_bwd_on_wgmma(int dtype, int d,
                                                      int kv_len) {
  return one_shot_on_wgmma(dtype, d, kv_len) && blocked_bwd_on_wgmma(dtype, d);
}

// the recompute's operands beside the TMA maps of q, k, v (the head views
// of the packed qkv scratch)
struct BlockPre {
  const float* datt;  // (B, S, H*d) f32, the product doproj @ Wo^T
  const float* lse;   // lane h of the residual rows of `lanes` floats
  bf16* att;          // (B, S, H*d)
  bf16* dout;         // (B, H, S, d): round(datt), the bodies' do
  float* delta;       // (B*H, S)
  int H, S, kv_len, lanes;
  float scale;
};

// What the JAX kernel's _mha_fwd_bwd computes before its backward products
// (devt_tpu/ops/fused_block.py:119), per (sequence, head), from the stored
// lse with no max pass and no 1 / l:
//   p     = exp(s scale - lse), keys at or past kv_len at 0
//   o     = round(p) @ v in f32 (unnormalised: lse holds log l)
//   att   = round(o), the operand of the Wo gradient
//   delta = rowsum(datt * o), both in f32 (not from rounded o and do, as
//           kernel 12's prologue takes it)
//   do    = round(datt), the bodies' dO operand
// The one-shot forward's body (flash_one_shot, flash_fwd_sm90.cuh) with
// its max and sum replaced by the given lse: a CTA of one warpgroup takes
// two query tiles of 64 rows of a (sequence, head), K and V whole (N rows),
// by TMA; S = Q K^T and O = P V on wgmma, p in registers as the bodies
// compute it (one ex2 of s scale log2 e - lse log2 e).  Rows past S get
// +inf lse (p = 0) and are not stored.
template <int HD, int N>
__global__ void __launch_bounds__(kOneShotThreads, one_shot_ctas(HD, N, true))
    block_bwd_pre_sm90(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const BlockPre a) {
  constexpr int RB = HD * 2;  // bytes of a row
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 + kOneShotQTiles];
  unsigned char* Qs =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tiles = one_shot_tiles(a.S);
  const int parts = ((a.S + 63) / 64 + tiles - 1) / tiles;
  const int bh = blockIdx.x / parts, t0 = (blockIdx.x - bh * parts) * tiles;
  const int b = bh / a.H, h = bh - b * a.H;
  const int ntiles = min(tiles, (a.S + 63) / 64 - t0);
  unsigned char* Ks = Qs + tiles * 64 * RB;
  unsigned char* Vs = Ks + align1024(N * RB);

  // bars[0] K, bars[1] V, bars[2 + i] query tile t0 + i
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 + ntiles; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    constexpr uint32_t kQBytes = 64 * RB, kKVBytes = N * RB;
    mbar_expect_tx(&bars[2], kQBytes);
    tma_load_4d(Qs, &tq, &bars[2], 0, 64 * t0, h, b);
    mbar_expect_tx(&bars[0], kKVBytes);
    tma_load_4d(Ks, &tk, &bars[0], 0, 0, h, b);
    mbar_expect_tx(&bars[1], kKVBytes);
    tma_load_4d(Vs, &tv, &bars[1], 0, 0, h, b);
    for (int i = 1; i < ntiles; ++i) {
      mbar_expect_tx(&bars[2 + i], kQBytes);
      tma_load_4d(Qs + i * 64 * RB, &tq, &bars[2 + i], 0, 64 * (t0 + i), h,
                  b);
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq4 = lane & 3;
  const uint64_t kdesc = smem_desc<HD>(Ks), vdesc = smem_desc<HD>(Vs);
  const long long Dt = static_cast<long long>(a.H) * HD;
  const float c = a.scale * kLog2e;

#pragma unroll 1
  for (int i = 0; i < ntiles; ++i) {
    const int t = t0 + i;
    float lc[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 64 * t + 16 * warp + gq + 8 * hh;
      lc[hh] = row < a.S ? a.lse[(static_cast<long long>(b) * a.S + row) *
                                     a.lanes + h] * kLog2e
                         : pos_inf();
    }
    mbar_wait(&bars[2 + i], 0);
    if (i == 0) mbar_wait(&bars[0], 0);

    // S = Q K^T: register 4 j + e holds row gq + 8 (e / 2) of the warp's
    // 16, key column 8 j + 2 tq4 + e % 2
    float s[N / 2];
    const uint64_t qdesc = smem_desc<HD>(Qs + i * 64 * RB);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_qk<N>(s, qdesc + 2 * kk, kdesc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_all<N / 2>(s);

    // p = 2^(s scale log2 e - lse log2 e), keys past kv_len at 0, in bf16
    // as the A fragments of P V
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& v = s[4 * j + e];
        v = 8 * j + 2 * tq4 + (e & 1) < a.kv_len
                ? ex2(fmaf(v, c, -lc[e >> 1]))
                : 0.f;
      }
    uint32_t pa[N / 16][4];
    to_frags<N>(pa, s);

    // O = P V, V read MN-major; the thread's datt loads in flight under it
    // (s is dead by now: the registers are free)
    if (i == 0) mbar_wait(&bars[1], 0);
    float o[HD / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_pv<HD>(o, pa[kk], vdesc + ((16 * kk * RB) >> 4), kk);
    wgmma_commit();
    float2 g[2][HD / 8];
    long long e[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 64 * t + 16 * warp + gq + 8 * hh;
      e[hh] = (static_cast<long long>(b) * a.S + row) * Dt + h * HD + 2 * tq4;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        g[hh][j] = row < a.S
                       ? *reinterpret_cast<const float2*>(a.datt + e[hh] +
                                                          8 * j)
                       : make_float2(0.f, 0.f);
    }
    wgmma_wait_all();
    fence_all<HD / 2>(o);

    // att, do and delta of the thread's two rows (a quad holds a row)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 64 * t + 16 * warp + gq + 8 * hh;
      const bool ok = row < a.S;
      const long long eo =
          (static_cast<long long>(bh) * a.S + row) * HD + 2 * tq4;
      float dl = 0.f;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        if (!ok) continue;
        const float o0 = o[4 * j + 2 * hh], o1 = o[4 * j + 2 * hh + 1];
        dl += g[hh][j].x * o0;
        dl += g[hh][j].y * o1;
        *reinterpret_cast<uint32_t*>(a.att + e[hh] + 8 * j) =
            pack_bf16(o0, o1);
        *reinterpret_cast<uint32_t*>(a.dout + eo + 8 * j) =
            pack_bf16(g[hh][j].x, g[hh][j].y);
      }
      dl = quad_sum(dl);
      if (ok && tq4 == 0) a.delta[static_cast<long long>(bh) * a.S + row] = dl;
    }
  }
}

// ---------------------------------------------------------------------------
// host: the tensor maps and the launches
// ---------------------------------------------------------------------------

template <int HD>
cudaError_t launch_blocked_bwd_d(int part, const CUtensorMap (&m)[4],
                                 const FlashBwd& a, int BH,
                                 cudaStream_t stream) {
  if (part == 1) {
    constexpr size_t bytes = bwd_smem(HD, kBwdDqStages, kBwdDqKeys);
    DEVT_TRY(set_smem(flash_bwd_dq_wgmma<HD>, bytes));
    flash_bwd_dq_wgmma<HD><<<BH * ((a.Sq + 63) / 64), kBwdThreads, bytes,
                             stream>>>(m[0], m[1], m[2], m[3], a);
  } else {
    constexpr size_t bytes = bwd_smem(HD, kBwdDkvStages, kBwdDkvQueries);
    DEVT_TRY(set_smem(flash_bwd_dkv_wgmma<HD>, bytes));
    flash_bwd_dkv_wgmma<HD><<<BH * ((a.Skv + 63) / 64), kBwdThreads, bytes,
                              stream>>>(m[0], m[1], m[2], m[3], a);
  }
  return cudaGetLastError();
}

// kernel 12 (part 1: delta and dq) or 13 (part 2: dk and dv, from part 1's
// delta) on the wgmma bodies, for a shape inside blocked_bwd_on_wgmma: q,
// k, v (B, H, S, d) bf16 by element strides (strides[0..2] q's (sequence,
// head, row), [3..5] k's, [6..8] v's; the rows 16-byte aligned, the
// strides multiples of 8), the rest in `a`; the TMA maps of q, k, v and
// do (64-row boxes for the CTA's own side, the tile width for the
// streamed one), then the launch of the head dim
inline cudaError_t launch_blocked_bwd_wgmma(int part, const FlashBwd& a,
                                            const void* q, const void* k,
                                            const void* v, int B, int d,
                                            const long long* st,
                                            cudaStream_t stream) {
  if (!blocked_bwd_on_wgmma(1, d) || (part != 1 && part != 2))
    return cudaErrorInvalidValue;
  const int qbox = part == 1 ? 64 : kBwdDkvQueries;
  const int kbox = part == 1 ? kBwdDqKeys : 64;
  const long long hs = static_cast<long long>(a.Sq) * d;
  CUtensorMap m[4];
  DEVT_TRY(head_map(&m[0], q, d, a.Sq, a.H, B, st[2], st[1], st[0], qbox));
  DEVT_TRY(head_map(&m[1], k, d, a.Skv, a.H, B, st[5], st[4], st[3], kbox));
  DEVT_TRY(head_map(&m[2], v, d, a.Skv, a.H, B, st[8], st[7], st[6], kbox));
  DEVT_TRY(head_map(&m[3], a.dout, d, a.Sq, a.H, B, d, hs, a.H * hs, qbox));
  switch (d) {
    case 16: return launch_blocked_bwd_d<16>(part, m, a, B * a.H, stream);
    case 32: return launch_blocked_bwd_d<32>(part, m, a, B * a.H, stream);
    case 64: return launch_blocked_bwd_d<64>(part, m, a, B * a.H, stream);
  }
  return cudaErrorInvalidValue;
}

template <int HD, int N>
cudaError_t launch_block_pre_n(const CUtensorMap (&m)[3], const BlockPre& p,
                               int BH, cudaStream_t stream) {
  const int tiles = one_shot_tiles(p.S);
  const size_t bytes = one_shot_smem(HD, tiles, N, false);
  const int parts = ((p.S + 63) / 64 + tiles - 1) / tiles;
  DEVT_TRY(set_smem(block_bwd_pre_sm90<HD, N>, bytes));
  block_bwd_pre_sm90<HD, N>
      <<<BH * parts, kOneShotThreads, bytes, stream>>>(m[0], m[1], m[2], p);
  return cudaGetLastError();
}

// the attention backward of kernels 2 and 8 for a shape inside
// block_bwd_on_wgmma, head dim HD: the recompute (att, do, delta), then
// kernel 12's body (dq) and kernel 13's (dk, dv) with kBwdBlock.  qkv and
// dqkv (B, S, 3*H*HD) bf16 packed (16-byte aligned), datt (B, S, H*HD)
// f32, lse at lane h of res rows of `lanes` floats, att (B, S, H*HD);
// dout (B*H*S*HD bf16) and delta (B*H*S f32) scratch
template <int HD>
cudaError_t launch_block_attention_bwd(const bf16* qkv, const float* datt,
                                       const float* res, bf16* att,
                                       bf16* dqkv, bf16* dout, float* delta,
                                       int B, int S, int H, int kv_len,
                                       int lanes, float scale,
                                       cudaStream_t stream) {
  if (!block_bwd_on_wgmma(1, HD, kv_len)) return cudaErrorInvalidValue;
  const long long hd = static_cast<long long>(H) * HD, rs = 3 * hd;
  const long long ss = S * rs;  // a sequence's elements in qkv, dqkv
  const bf16 *q = qkv, *k = qkv + hd, *v = qkv + 2 * hd;

  // 1. the recompute: K and V boxes of the score row's width
  const int n = one_shot_width(HD, kv_len);
  BlockPre p{datt, res, att, dout, delta, H, S, kv_len, lanes, scale};
  CUtensorMap m3[3];
  DEVT_TRY(head_map(&m3[0], q, HD, S, H, B, rs, HD, ss, 64));
  DEVT_TRY(head_map(&m3[1], k, HD, S, H, B, rs, HD, ss, n));
  DEVT_TRY(head_map(&m3[2], v, HD, S, H, B, rs, HD, ss, n));
  switch (n) {
    case 64: DEVT_TRY((launch_block_pre_n<HD, 64>(m3, p, B * H, stream)));
             break;
    case 128: DEVT_TRY((launch_block_pre_n<HD, 128>(m3, p, B * H, stream)));
              break;
    case 208: DEVT_TRY((launch_block_pre_n<HD, 208>(m3, p, B * H, stream)));
              break;
    case 256: DEVT_TRY((launch_block_pre_n<HD, 256>(m3, p, B * H, stream)));
              break;
    default:
      if constexpr (HD == 64) {
        DEVT_TRY((launch_block_pre_n<64, 160>(m3, p, B * H, stream)));
        break;
      }
      return cudaErrorInvalidValue;
  }

  // 2. and 3. the bodies, q, k, v by strides, do (B, H, S, HD)
  BlockBwd a{};
  a.dout = dout;
  a.lse = res;
  a.delta = delta;
  a.dq = dqkv;
  a.dk = dqkv + hd;
  a.dv = dqkv + 2 * hd;
  a.H = H;
  a.Sq = a.Skv = S;
  a.kv_len = kv_len;
  a.scale = scale;
  const long long ls[3] = {static_cast<long long>(S) * lanes, 1, lanes};
  const long long gs[3] = {ss, HD, rs};
  for (int i = 0; i < 3; ++i) a.ls[i] = ls[i], a.gs[i] = gs[i];
  const long long hs = static_cast<long long>(S) * HD;
  for (int part = 1; part <= 2; ++part) {
    const int qbox = part == 1 ? 64 : kBwdDkvQueries;
    const int kbox = part == 1 ? kBwdDqKeys : 64;
    CUtensorMap m[4];
    DEVT_TRY(head_map(&m[0], q, HD, S, H, B, rs, HD, ss, qbox));
    DEVT_TRY(head_map(&m[1], k, HD, S, H, B, rs, HD, ss, kbox));
    DEVT_TRY(head_map(&m[2], v, HD, S, H, B, rs, HD, ss, kbox));
    DEVT_TRY(head_map(&m[3], dout, HD, S, H, B, HD, hs, H * hs, qbox));
    if (part == 1) {
      constexpr size_t bytes = bwd_smem(HD, kBwdDqStages, kBwdDqKeys);
      DEVT_TRY(set_smem(block_bwd_dq_sm90<HD>, bytes));
      block_bwd_dq_sm90<HD><<<B * H * ((S + 63) / 64), kBwdThreads, bytes,
                              stream>>>(m[0], m[1], m[2], m[3], a);
    } else {
      constexpr size_t bytes = bwd_smem(HD, kBwdDkvStages, kBwdDkvQueries);
      DEVT_TRY(set_smem(block_bwd_dkv_sm90<HD>, bytes));
      block_bwd_dkv_sm90<HD><<<B * H * ((S + 63) / 64), kBwdThreads, bytes,
                               stream>>>(m[0], m[1], m[2], m[3], a);
    }
    DEVT_TRY(cudaGetLastError());
  }
  return cudaSuccess;
}

}  // namespace
