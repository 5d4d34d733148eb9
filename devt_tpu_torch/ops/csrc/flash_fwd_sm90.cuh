// The attention forwards on Hopper's wgmma and TMA: the one-shot bf16 body
// of kernels 9, 14 and 7's attention where a head's live keys fit one
// score row, and the online-softmax bf16 body of kernel 11
// (flash_fwd_wgmma, at the end).
//
//   flash_fwd.cu   kernel 9, devt_tpu/ops/flash_attention.py:390
//                  _fwd_single_kernel: q (B, H, Sq, d), k and v
//                  (B, H, Skv, d) by element strides, keys at or past
//                  kv_len masked; o (B, H, Sq, d), lse (B*H, Sq)
//   ring_step.cu   kernel 14, flash_attention.py:792 _ring_fwd_kernel: q
//                  (B, S, H*d), the packed kv shard (B, S, 2*H*d), an
//                  additive f32 column mask; o (B, S, H*d), lse (B, S, H)
//   attn_half.cu   the attention launch of kernel 7, devt_tpu/ops/
//                  fused_block.py:556 _attn_half_fwd_kernel (its _mha_fwd,
//                  :92): q, k, v the head views of the packed qkv scratch
//                  (B, S, 3*H*d), keys at or past kv_len masked; o into
//                  the att scratch (B, S, H*d), lse into lanes [0, H) of
//                  the f32 residual (B, S, lanes)
//
// Per (sequence, head) what the TPU kernels compute on their whole (S, S)
// block: s = q k^T * scale in f32 plus the key bias; the exact row max m
// over the live keys; l = sum exp(s - m); o = round_bf16(p * (1 / l)) @ v
// in f32, stored in q's type; lse = m + log l.  Kernel 7 normalises after
// the product instead, as its TPU kernel does: o = (round_bf16(p) @ v) / l
// (kNormAfter, a template parameter: kernels 9's and 14's instances are
// compiled without it).  Kernel 9's (and 7's) bias is -inf at
// key columns >= kv_len (the plain version's -1e30 gives the same exact
// zeros: kv_len >= 1 keeps m finite).  Kernel 14 adds the mask; a key past
// Skv is absent (p = 0), and a row whose every key is masked has m =
// -1e30, p = 1, l = Skv, a finite o and lse = -1e30 + log l, as the TPU
// kernel's.  Rows past Sq are neither read nor written.
//
// The rule (one_shot_on_wgmma, mirrored by ops/flash_attention.py
// one_shot_on_wgmma): bfloat16, head dim 16, 32 or 64, at most 256 live
// keys (kv_len for kernels 9 and 7, the shard's S for kernel 14).  Every
// main-path shape is inside it: kernel 9 at (1536, 197, 64), kernel 14 at
// (512, 208, 3 x 64) and the hop-by-hop ring's 160, kernel 7 at (512, 208,
// 3 x 64) with kv_len 197.  Other shapes stay on flash_fwd.cuh's streamed
// body (kernel 7's on attention_fwd.cuh's).
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W): at (1536, 197,
// 64) the bytes (q, k, v read once, o and lse written: 155 MB, 0.046 ms at
// 3.35 TB/s) and the exponentials: 1536 x 197 x 208 ex2 at 16 a clock per
// SM is about 0.02 ms, the two products 10.5 GFLOP padded to 208 keys
// about 0.01 ms at the tensor cores' peak.  The streamed body it replaces
// there computed every score twice (a max/sum pass, then a pass with v),
// exponentiated twice, divided per element, re-read K and V for every 64
// queries, and ran mma.sync from ldmatrix fragments.
//
// Design.  A CTA of one warpgroup (128 threads) takes two query tiles of
// 64 rows of one (sequence, head) (one when Sq <= 64).  Thread 0 issues
// TMA loads (cp.async.bulk.tensor, 4-d maps over (d, row, head, sequence)
// with the callers' byte strides, so head views of a packed qkv and the
// packed kv shard need no copy): the first query tile, all of K, all of
// V, then the second tile, each completing on its own mbarrier, so the
// first product starts while V is still in flight.  TMA writes the 128-,
// 64- or 32-byte swizzle that wgmma reads (a row of d bf16 values is the
// swizzle width) and zero-fills rows past Sq or Skv.  Per query tile:
//   1. S = Q K^T: one wgmma m64nNk16 per 16 of d, A = the Q tile and B = K
//      (K-major) from shared memory, into N / 2 f32 registers a thread:
//      the whole score row of 64 queries by N keys.  N is a template
//      parameter, the least of 64, 128, 208, 256 (and 160 at d = 64) that
//      holds the live keys: the host picks it, and the K and V boxes have
//      N rows.  (A first version took any key count in one instance,
//      issuing m64n64k16 per 64 keys behind warp-uniform tests: ptxas then
//      serialised every wgmma (its C7511 warning) and ran out of
//      registers.)
//   2. Softmax in registers: the bias, the row max over the thread's
//      elements and the 4 lanes of its row (quad_max), one ex2 per score
//      (kernel 9 folds scale * log2 e into one FMA with the max; kernel 14
//      exponentiates (s - m) * log2 e so that a wholly masked row gives
//      exactly 0 and p = 1), the row sum, one reciprocal of l; p * (1 / l)
//      packed to bf16 as wgmma A fragments (the accumulator layout of two
//      8-key blocks is the A layout of one 16-key step).  With kNormAfter
//      p itself is packed; l is the sum of the unrounded f32 p either way.
//   3. O = P V: wgmma m64nDk16, A from those registers, B = V from shared
//      memory, MN-major through the transpose bit, one step per 16 keys.
//   4. o stored from the accumulators as bf16 pairs (with kNormAfter each
//      f32 accumulator times its row's 1 / l first), lse by the quad's
//      first lane.
// Each score is computed once and exponentiated once.  Shared memory is
// the CTA's Q tiles, K and V (N rows each), kernel 14's staged mask: 69 KB
// at the main-path shapes, and at most 168 registers a thread (no spills:
// chip_smoke.py prints ptxas' report of every instance), so three CTAs
// share an SM and two compute while one waits for its loads (kernel 7's
// widest instance excepted: one_shot_ctas).  Measured by
// tools/one_shot_variants.py on an NVIDIA H100 80GB HBM3 at 700 W: kernel
// 9 at (1536, 197, 64) 0.0715 ms as built; a CTA per head holding all
// four query tiles (88 KB, two CTAs an SM) 0.0864; one tile a CTA (K and
// V read four times a head, from L2) 0.0789.  Without the exponentials it
// runs 0.068, without the P V product 0.065: what is left is mostly the
// loads' latency, since a CTA computes nothing until its K has landed.
//
// Kernel 11 (flash_fwd.cu, devt_tpu/ops/flash_attention.py:69 _fwd_kernel,
// the rule online_on_wgmma: bfloat16 at head dim 16, 32 or 64, any key
// count, Sq and Skv apart).  At ViViT's image-384 shape, (1536, 592, 64)
// with kv_len 577, bytes (466 MB, 0.139 ms at 3.35 TB/s), the products
// (134 GFLOP, 0.136 ms) and the exponentials (one per score, 0.14-0.16 ms
// at 16 ex2 a clock per SM) are level.  A CTA is one consumer warpgroup of
// 64 query rows and a producer warp; K and V come in 128-key tiles (the
// TPU kernel's block_kv, so the rescale points are the plain version's)
// through a two-stage TMA ring with full and empty mbarriers; S = Q K^T is
// one m64n128k16 per 16 of d into registers, the online softmax runs on
// them, and O += P V takes P from registers.  Each warpgroup's tile is a
// chain (products, softmax, products) whose waits bound it, not the
// bytes: three CTAs an SM (128 registers a thread; skipping O's rescale at
// the first tile, where O is zero, leaves ptxas no spill) run three chains
// side by side.  Warpgroups that share K and V tiles in one CTA fall into step
// with each other and ran slower, in every arrangement tools/
// wgmma_variants.py measures (PERF.md); halving the bytes read from L2 did
// not move it.

#pragma once

#include "flash_fwd.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kOneShotKeys = 256;    // the longest score row held
constexpr int kOneShotQTiles = 2;    // query tiles a CTA takes at most
constexpr int kOneShotThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// the rule, written once: which one-shot forwards take this body
__host__ __device__ constexpr bool one_shot_on_wgmma(int dtype, int d,
                                                     int keys) {
  return dtype == 1 && (d == 16 || d == 32 || d == 64) && keys >= 1 &&
         keys <= kOneShotKeys;
}

// the score row's width for `keys` live keys: the compiled widths (head
// dim 64 also 160, the hop-by-hop ring's shards), the least that holds them
__host__ __device__ constexpr int one_shot_width(int d, int keys) {
  return keys <= 64    ? 64
         : keys <= 128 ? 128
         : d == 64 && keys <= 160 ? 160
         : keys <= 208 ? 208
                       : 256;
}

// CTAs an SM that the register cap of __launch_bounds__ leaves room for:
// three (168 registers a thread), but two for kernel 7's instance at head
// dim 64 and 256 keys, which spilled 16 bytes under three's cap (and drew
// ptxas' C7512: wgmma serialised for registers) and whose shared memory
// (83 KB a CTA) holds it to two CTAs an SM anyway
__host__ __device__ constexpr int one_shot_ctas(int hd, int n,
                                                bool norm_after) {
  return norm_after && hd == 64 && n == 256 ? 2 : 3;
}

// query tiles of 64 rows a CTA takes: two (one when Sq <= 64), so a head
// of 197 queries is two CTAs that each read K and V (the second from L2)
__host__ __device__ constexpr int one_shot_tiles(int sq) {
  return sq > 64 ? 2 : 1;
}

// 1 KB of slack to align the dynamic base, the CTA's Q tiles, K and V
// (each region 1024-byte aligned, the 128-byte swizzle's period), kernel
// 14's mask
__host__ __device__ constexpr size_t one_shot_smem(int hd, int tiles, int n,
                                                   bool mask) {
  return 1024 + static_cast<size_t>(tiles) * 64 * hd * 2 +
         2 * align1024(static_cast<size_t>(n) * hd * 2) +
         (mask ? static_cast<size_t>(n) * sizeof(float) : 0);
}

// kernel 11, the online-softmax forward: keys a K/V tile (the TPU kernel's
// block_kv), consumer warpgroups a CTA (64 query rows each), stages of the
// K/V ring, and query groups (kOnlineWG x 64 rows) a CTA takes in turn
// (tools/wgmma_variants.py measures the others)
constexpr int kOnlineKeys = 128;
constexpr int kOnlineWG = 1;
constexpr int kOnlineStages = 2;
constexpr int kOnlineGroups = 1;
constexpr int kOnlineThreads = kOnlineWG * 128 + 32;  // and a producer warp
// CTAs an SM that the register cap of __launch_bounds__ leaves room for
constexpr int kOnlineCTAs = 3;

// the rule, written once: which online forwards (kernel 11) take this body
__host__ __device__ constexpr bool online_on_wgmma(int dtype, int d) {
  return dtype == 1 && (d == 16 || d == 32 || d == 64);
}

// CTAs a head takes: its query parts
__host__ __device__ constexpr int online_parts(int sq) {
  return (sq + kOnlineGroups * kOnlineWG * 64 - 1) /
         (kOnlineGroups * kOnlineWG * 64);
}

// 1 KB of slack to align the dynamic base, the Q tiles of a group, and per
// stage a K and a V tile (each 1024-byte aligned)
__host__ __device__ constexpr size_t online_smem(int hd) {
  return 1024 + static_cast<size_t>(kOnlineWG) * 64 * hd * 2 +
         2 * kOnlineStages *
             align1024(static_cast<size_t>(kOnlineKeys) * hd * 2);
}

// ---------------------------------------------------------------------------
// bf16 wgmma: descriptors and products
// ---------------------------------------------------------------------------

// shared-memory matrix descriptor of a tile whose rows are HD bf16 values
// (HD * 2 bytes: the swizzle width TMA wrote), 8-row groups dense; the
// leading offset is unused at these widths (K-major: a k16 step lies
// inside the swizzle row; MN-major: N = HD is one swizzle atom)
template <int HD>
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  constexpr uint64_t kLayout = HD == 64 ? 1 : HD == 32 ? 2 : 3;  // 128/64/32 B
  constexpr uint64_t kStride = 8 * HD * 2;  // bytes between 8-row groups
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (uint64_t{1} << 16) | ((kStride >> 4) << 32) | (kLayout << 62);
}

// d[0, 32) = (acc ? d : 0) + A (64 x 16, shared, K-major) B (16 x 64,
// shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d[0, 64) = (acc ? d : 0) + A (64 x 16, shared, K-major) B (16 x 128,
// shared, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a, uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// d[0, 80) = (acc ? d : 0) + A (64 x 16, shared, K-major) B (16 x 160,
// shared, K-major)
__device__ __forceinline__ void wgmma_ss_n160(float* d, uint64_t a, uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(a), "l"(b), "r"(acc));
}

// d[0, 104) = (acc ? d : 0) + A (64 x 16, shared, K-major) B (16 x 208,
// shared, K-major)
__device__ __forceinline__ void wgmma_ss_n208(float* d, uint64_t a, uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %106, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103"
      "}, %104, %105, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
      : "l"(a), "l"(b), "r"(acc));
}

// d[0, 128) = (acc ? d : 0) + A (64 x 16, shared, K-major) B (16 x 256,
// shared, K-major)
__device__ __forceinline__ void wgmma_ss_n256(float* d, uint64_t a, uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(acc));
}

// d[0, 32) = (acc ? d : 0) + A (64 x 16, registers) B (16 x 64, shared,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d[0, 16) = (acc ? d : 0) + A (64 x 16, registers) B (16 x 32, shared,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d[0, 8) = (acc ? d : 0) + A (64 x 16, registers) B (16 x 16, shared,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// S (64 x N) step: d = (acc ? d : 0) + Q (shared) K^T (shared)
template <int N>
__device__ __forceinline__ void wgmma_qk(float* d, uint64_t a, uint64_t b,
                                         int acc) {
  if constexpr (N == 64) {
    wgmma_ss_n64(d, a, b, acc);
  } else if constexpr (N == 128) {
    wgmma_ss_n128(d, a, b, acc);
  } else if constexpr (N == 160) {
    wgmma_ss_n160(d, a, b, acc);
  } else if constexpr (N == 208) {
    wgmma_ss_n208(d, a, b, acc);
  } else {
    wgmma_ss_n256(d, a, b, acc);
  }
}

// O (64 x HD) step: d = (acc ? d : 0) + P (registers) V (shared)
template <int HD>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a,
                                         uint64_t b, int acc) {
  if constexpr (HD == 64) {
    wgmma_rs_n64(d, a, b, acc);
  } else if constexpr (HD == 32) {
    wgmma_rs_n32(d, a, b, acc);
  } else {
    wgmma_rs_n16(d, a, b, acc);
  }
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <int HD, int N, bool kMask, bool kNormAfter>
__global__ void __launch_bounds__(kOneShotThreads,
                                  one_shot_ctas(HD, N, kNormAfter))
    flash_one_shot(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const FlashFwd a) {
  constexpr int RB = HD * 2;  // bytes of a row
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 + kOneShotQTiles];
  unsigned char* Qs =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // the CTA's query tiles t0 .. t1 - 1 of head (b, h)
  const int tiles = one_shot_tiles(a.Sq);
  const int parts = ((a.Sq + 63) / 64 + tiles - 1) / tiles;
  const int bh = blockIdx.x / parts, t0 = (blockIdx.x - bh * parts) * tiles;
  const int b = bh / a.H, h = bh - b * a.H;
  const int ntiles = min(tiles, (a.Sq + 63) / 64 - t0);
  unsigned char* Ks = Qs + tiles * 64 * RB;
  unsigned char* Vs = Ks + align1024(N * RB);
  float* msk = reinterpret_cast<float*>(Vs + align1024(N * RB));

  // bars[0] K, bars[1] V, bars[2 + i] query tile t0 + i: each completes
  // once
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 + ntiles; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  if (kMask)
    for (int c = threadIdx.x; c < N; c += kOneShotThreads)
      msk[c] = c < a.Skv ? a.mask[c] : neg_inf();  // past Skv: absent
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
  bf16* O = static_cast<bf16*>(a.o) + b * a.os[0] + h * a.os[1];
  float* L = a.lse + b * a.ls[0] + h * a.ls[1];

#pragma unroll 1
  for (int i = 0; i < ntiles; ++i) {
    const int t = t0 + i;
    mbar_wait(&bars[2 + i], 0);
    if (i == 0) mbar_wait(&bars[0], 0);

    // 1. S = Q K^T, one m64nNk16 per 16 of d (a k16 step is 32 bytes
    // along the swizzled row).  Register 4j + e of a thread holds row
    // gq + 8 (e / 2) of its warp's 16, key column 8 j + 2 tq4 + e % 2.
    float s[N / 2];
    const uint64_t qdesc = smem_desc<HD>(Qs + i * 64 * RB);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_qk<N>(s, qdesc + 2 * kk, kdesc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int e = 0; e < N / 2; ++e) reg_fence(s[e]);

    // 2. the bias and the row max (rows gq, gq + 8: m[0], m[1])
    float m[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + 2 * tq4;
      if (kMask) {
        const float2 bias = *reinterpret_cast<const float2*>(msk + col);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] = fmaf(s[4 * j + e], a.scale, e & 1 ? bias.y : bias.x);
      } else if (8 * j + 8 > a.kv_len) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + (e & 1) >= a.kv_len) s[4 * j + e] = neg_inf();
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[4 * j + e]);
    }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
    // kernel 9: m is the unscaled max, p = 2^(s c - m c) with c = scale
    // log2 e; kernel 14: s is scaled and biased, p = 2^((s - m) log2 e)
    const float cl = kMask ? kLog2e : a.scale * kLog2e;
    const float mc[2] = {m[0] * cl, m[1] * cl};
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      float& v = s[e];
      const int r = (e >> 1) & 1;
      v = kMask ? ex2((v - m[r]) * kLog2e) : ex2(fmaf(v, cl, -mc[r]));
      l[r] += v;
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    // p * (1 / l) in bf16 (kNormAfter: p): registers 8kk..8kk+7 are the A
    // fragment of the 16 keys at 16 kk
    uint32_t pa[N / 16][4];
    if constexpr (kNormAfter) {
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const float* p = s + 8 * kk;
        pa[kk][0] = pack_bf16(p[0], p[1]);
        pa[kk][1] = pack_bf16(p[2], p[3]);
        pa[kk][2] = pack_bf16(p[4], p[5]);
        pa[kk][3] = pack_bf16(p[6], p[7]);
      }
    } else {
      const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const float* p = s + 8 * kk;
        pa[kk][0] = pack_bf16(p[0] * inv[0], p[1] * inv[0]);
        pa[kk][1] = pack_bf16(p[2] * inv[1], p[3] * inv[1]);
        pa[kk][2] = pack_bf16(p[4] * inv[0], p[5] * inv[0]);
        pa[kk][3] = pack_bf16(p[6] * inv[1], p[7] * inv[1]);
      }
    }

    // 3. O = P V, one m64nHDk16 per 16 keys (16 rows of V)
    if (i == 0) mbar_wait(&bars[1], 0);
    float o[HD / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_pv<HD>(o, pa[kk], vdesc + ((16 * kk * RB) >> 4), kk);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) reg_fence(o[e]);

    // 4. o and lse
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 64 * t + 16 * warp + gq + 8 * hh;
      if (row >= a.Sq) continue;
      bf16* dst = O + row * a.os[2] + 2 * tq4;
      if constexpr (kNormAfter) {
        const float inv = 1.f / l[hh];
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(
              o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
      } else {
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              pack_bf16(o[4 * j + 2 * hh], o[4 * j + 2 * hh + 1]);
      }
      if (tq4 == 0)
        L[row * a.ls[2]] =
            (kMask ? m[hh] : m[hh] * a.scale) + logf(l[hh]);
    }
  }
}

// Kernel 11.  A CTA takes kOnlineGroups groups of kOnlineWG x 64 query rows
// of one (sequence, head), one group after the other; warpgroup w owns
// rows 64 w .. 64 w + 63 of a group.  Its grid index runs over the query
// parts of a head fastest, so the CTAs of a head run side by side and
// read its K and V from L2 after the first.  The last warp of a CTA is
// its producer: one lane issues the loads of the group's Q tiles and of
// the K and V tiles of 128 keys through a ring of kOnlineStages stages.
// Full barriers carry the bytes (one for K, one for V: S = Q K^T starts
// before V has landed); a K tile is handed back once S has read it, a V
// tile once P V has, so the next K lands under this tile's softmax.  When
// the live tiles all fit the ring they are loaded once and stay.  Per
// tile, in a consumer warpgroup:
//   S = Q K^T         wgmma m64n128k16 per 16 of d, into 64 f32 registers
//   mask              key columns >= kv_len at -inf, on the last tile only
//   m_new = max(m, row max s); alpha = 2^((m - m_new) c), c = scale log2 e
//   p = 2^(s c - m_new c), rounded to bf16 as wgmma A fragments
//   l = alpha l + sum p;  O = alpha O + P V (wgmma m64nDk16, A from
//                         registers, V MN-major through the transpose bit)
// At the end o = O / l and lse = m scale + log l, rows past Sq not stored.
// Every tile visited holds a live key, so m is finite after the first
// tile and the first alpha is 2^-inf = 0.
template <int HD>
__global__ void __launch_bounds__(kOnlineThreads, kOnlineCTAs)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const FlashFwd a) {
  constexpr int RB = HD * 2;                  // bytes of a row
  constexpr int kRows = kOnlineWG * 64;       // query rows of a group
  constexpr uint32_t kTile = kOnlineKeys * RB;  // bytes of a K or V tile
  constexpr int S = kOnlineStages;
  extern __shared__ unsigned char smem_raw[];
  // per stage: K full, V full, K empty, V empty; then Q full, Q empty
  __shared__ __align__(8) uint64_t bars[4 * S + 2];
  uint64_t* const fullk = bars;
  uint64_t* const fullv = bars + S;
  uint64_t* const emptyk = bars + 2 * S;
  uint64_t* const emptyv = bars + 3 * S;
  uint64_t* const qfull = bars + 4 * S;
  uint64_t* const qempty = qfull + 1;
  unsigned char* Qs =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* KV = Qs + kRows * RB;  // stage st: K, then V
  constexpr int span = kOnlineGroups * kRows;  // query rows a CTA covers
  const int parts = online_parts(a.Sq);
  const int bh = blockIdx.x / parts, part = blockIdx.x - bh * parts;
  const int b = bh / a.H, h = bh - b * a.H;
  const int ntiles = (a.kv_len + kOnlineKeys - 1) / kOnlineKeys;
  const bool resident = ntiles <= S;  // each tile loaded once, into stage j
  // the groups and warpgroups that hold query rows (a CTA of one group at
  // the end of Sq may have fewer warpgroups at work; the others leave)
  const int left = a.Sq - part * span;
  const int groups = min(kOnlineGroups, (left + kRows - 1) / kRows);
  const int active =
      groups > 1 ? kOnlineWG : min(kOnlineWG, (left + 63) / 64);

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&fullk[i], 1);
      mbar_init(&fullv[i], 1);
      mbar_init(&emptyk[i], 4 * active);
      mbar_init(&emptyv[i], 4 * active);
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, 4 * active);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq4 = lane & 3;
  if (wg == kOnlineWG) {
    // the producer: one lane issues every load
    if (lane == 0) {
      int g = 0;
      for (int it = 0; it < groups; ++it) {
        if (it > 0) mbar_wait(qempty, (it - 1) & 1);
        const int row0 = part * span + it * kRows;
        mbar_expect_tx(qfull, kRows * RB);
        for (int w = 0; w < kOnlineWG; ++w)
          tma_load_4d(Qs + w * 64 * RB, &tq, qfull, 0, row0 + 64 * w, h, b);
        if (resident && it > 0) continue;
        for (int j = 0; j < ntiles; ++j, ++g) {
          const int st = resident ? j : g % S;
          const uint32_t freed = ((g / S) & 1) ^ 1;
          unsigned char* Ks = KV + 2 * st * kTile;
          if (!resident) mbar_wait(&emptyk[st], freed);
          mbar_expect_tx(&fullk[st], kTile);
          tma_load_4d(Ks, &tk, &fullk[st], 0, j * kOnlineKeys, h, b);
          if (!resident) mbar_wait(&emptyv[st], freed);
          mbar_expect_tx(&fullv[st], kTile);
          tma_load_4d(Ks + kTile, &tv, &fullv[st], 0, j * kOnlineKeys, h, b);
        }
      }
    }
  } else if (wg < active) {
    const uint64_t qdesc = smem_desc<HD>(Qs + wg * 64 * RB);
    const float c = a.scale * kLog2e;
    int g = 0;  // tiles consumed so far: the ring's position
#pragma unroll 1
    for (int it = 0; it < groups; ++it) {
      mbar_wait(qfull, it & 1);
      float o[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
#pragma unroll 1
      for (int j = 0; j < ntiles; ++j, ++g) {
        const int st = resident ? j : g % S;
        const uint32_t ph = resident ? 0 : (g / S) & 1;
        const unsigned char* Ks = KV + 2 * st * kTile;
        mbar_wait(&fullk[st], ph);

        // S = Q K^T: register 4 jj + e holds row gq + 8 (e / 2) of the
        // warp's 16, key column 8 jj + 2 tq4 + e % 2 of the tile
        float s[kOnlineKeys / 2];
        const uint64_t kdesc = smem_desc<HD>(Ks);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss_n128(s, qdesc + 2 * kk, kdesc + 2 * kk, kk);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int i = 0; i < kOnlineKeys / 2; ++i) reg_fence(s[i]);
        if (lane == 0) {
          if (!resident) mbar_arrive(&emptyk[st]);   // K read
          if (j == ntiles - 1) mbar_arrive(qempty);  // Q read
        }

        if (j == ntiles - 1 && (a.kv_len % kOnlineKeys)) {
          const int live = a.kv_len - j * kOnlineKeys;
#pragma unroll
          for (int jj = 0; jj < kOnlineKeys / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (8 * jj + 2 * tq4 + (e & 1) >= live)
                s[4 * jj + e] = neg_inf();
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < kOnlineKeys / 2; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        mx[0] = quad_max(mx[0]);
        mx[1] = quad_max(mx[1]);
        const float alpha[2] = {ex2((m[0] - mx[0]) * c),
                                ex2((m[1] - mx[1]) * c)};
        const float mc[2] = {mx[0] * c, mx[1] * c};
        m[0] = mx[0];
        m[1] = mx[1];
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < kOnlineKeys / 2; ++i) {
          s[i] = ex2(fmaf(s[i], c, -mc[(i >> 1) & 1]));
          rs[(i >> 1) & 1] += s[i];
        }
        l[0] = l[0] * alpha[0] + rs[0];
        l[1] = l[1] * alpha[1] + rs[1];
        if (j > 0) {  // O is zero before the first tile
#pragma unroll
          for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        }
        // p in bf16: registers 8 kk .. 8 kk + 7 are the A fragment of the
        // 16 keys at 16 kk
        uint32_t pa[kOnlineKeys / 16][4];
#pragma unroll
        for (int kk = 0; kk < kOnlineKeys / 16; ++kk) {
          const float* p = s + 8 * kk;
          pa[kk][0] = pack_bf16(p[0], p[1]);
          pa[kk][1] = pack_bf16(p[2], p[3]);
          pa[kk][2] = pack_bf16(p[4], p[5]);
          pa[kk][3] = pack_bf16(p[6], p[7]);
        }

        // O += P V, one m64nHDk16 per 16 keys (16 rows of V)
        mbar_wait(&fullv[st], ph);
        const uint64_t vdesc = smem_desc<HD>(Ks + kTile);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kOnlineKeys / 16; ++kk)
          wgmma_pv<HD>(o, pa[kk], vdesc + ((16 * kk * RB) >> 4), 1);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) reg_fence(o[i]);
        if (!resident && lane == 0) mbar_arrive(&emptyv[st]);  // V read
      }

      // o = O / l and lse, the row sums of the quad first
      l[0] = quad_sum(l[0]);
      l[1] = quad_sum(l[1]);
      bf16* O = static_cast<bf16*>(a.o) + b * a.os[0] + h * a.os[1];
      float* L = a.lse + b * a.ls[0] + h * a.ls[1];
      const int row0 = part * span + it * kRows + wg * 64 + 16 * warp + gq;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + 8 * hh;
        if (row >= a.Sq) continue;
        bf16* dst = O + row * a.os[2] + 2 * tq4;
#pragma unroll
        for (int jj = 0; jj < HD / 8; ++jj)
          *reinterpret_cast<uint32_t*>(dst + 8 * jj) = pack_bf16(
              o[4 * jj + 2 * hh] / l[hh], o[4 * jj + 2 * hh + 1] / l[hh]);
        if (tq4 == 0) L[row * a.ls[2]] = m[hh] * a.scale + logf(l[hh]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host: the tensor maps and the launch
// ---------------------------------------------------------------------------

// a bf16 head view as a 4-d map over (d, row, head, sequence) with element
// strides (row, head, sequence), boxes of (d, box_rows, 1, 1) rows in
// the swizzle of a d-value row; rows past `rows` read as zeros
inline cudaError_t head_map(CUtensorMap* map, const void* base, int d,
                            int rows, int heads, int seqs, long long rs,
                            long long hs, long long ss, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seqs)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(rs) * sizeof(bf16),
                                 static_cast<cuuint64_t>(hs) * sizeof(bf16),
                                 static_cast<cuuint64_t>(ss) * sizeof(bf16)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(d),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      d == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
      : d == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD, int N, bool kMask, bool kNormAfter>
cudaError_t launch_one_shot_n(const CUtensorMap (&m)[3], const FlashFwd& a,
                              int BH, cudaStream_t stream) {
  const int tiles = one_shot_tiles(a.Sq);
  const size_t bytes = one_shot_smem(HD, tiles, N, kMask);
  const int parts = ((a.Sq + 63) / 64 + tiles - 1) / tiles;
  DEVT_TRY(set_smem(flash_one_shot<HD, N, kMask, kNormAfter>, bytes));
  flash_one_shot<HD, N, kMask, kNormAfter>
      <<<BH * parts, kOneShotThreads, bytes, stream>>>(m[0], m[1], m[2], a);
  return cudaGetLastError();
}

template <int HD, bool kMask, bool kNormAfter>
cudaError_t launch_one_shot_d(const CUtensorMap (&m)[3], const FlashFwd& a,
                              int BH, int n, cudaStream_t stream) {
  switch (n) {
    case 64:
      return launch_one_shot_n<HD, 64, kMask, kNormAfter>(m, a, BH, stream);
    case 128:
      return launch_one_shot_n<HD, 128, kMask, kNormAfter>(m, a, BH, stream);
    case 208:
      return launch_one_shot_n<HD, 208, kMask, kNormAfter>(m, a, BH, stream);
    case 256:
      return launch_one_shot_n<HD, 256, kMask, kNormAfter>(m, a, BH, stream);
  }
  if (HD == 64 && n == 160)
    return launch_one_shot_n<64, 160, kMask, kNormAfter>(m, a, BH, stream);
  return cudaErrorInvalidValue;
}

// the one-shot body's arguments for the heads of a packed qkv (B, S,
// 3*H*d) bf16, by strides: o (B, S, H*d), lse at lane h of rows of `lanes`
// floats (kernel 7's residual lanes, or kernel 3's (B, S, H) with lanes =
// H); keys at or past kv_len masked
inline FlashFwd packed_qkv_heads(const bf16* qkv, void* o, float* lse, int S,
                                 int H, int d, int kv_len, int lanes,
                                 float scale) {
  const long long hd = static_cast<long long>(H) * d;
  FlashFwd f{};
  f.q = qkv;
  f.k = qkv + hd;
  f.v = qkv + 2 * hd;
  f.o = o;
  f.lse = lse;
  for (int i = 0; i < 3; ++i) {
    // (sequence, head, row) strides of the packed layouts
    f.qs[i] = f.ks[i] = f.vs[i] = i == 0 ? S * 3 * hd : i == 1 ? d : 3 * hd;
    f.os[i] = i == 0 ? S * hd : i == 1 ? d : hd;
    f.ls[i] = i == 0 ? static_cast<long long>(S) * lanes : i == 1 ? 1 : lanes;
  }
  f.H = H;
  f.Sq = f.Skv = S;
  f.kv_len = kv_len;
  f.scale = scale;
  return f;
}

// kernel 9 (mask off: keys at or past a.kv_len masked), 14 (a.mask's
// bias) or, with kNormAfter, kernel 7's attention (the kv_len mask, o
// normalised after P V) on the wgmma body, for a bfloat16 shape inside
// one_shot_on_wgmma with a.kv_len live keys: the TMA maps of q, k and v
// (bf16 strides in a, the rows 16-byte aligned), then the launch of the
// score-row width
template <bool kMask, bool kNormAfter = false>
cudaError_t launch_one_shot(const FlashFwd& a, int B, int d,
                            cudaStream_t stream) {
  static_assert(!(kMask && kNormAfter), "kernel 7 masks by kv_len");
  if (!one_shot_on_wgmma(1, d, a.kv_len)) return cudaErrorInvalidValue;
  const int n = one_shot_width(d, a.kv_len);
  CUtensorMap m[3];
  DEVT_TRY(head_map(&m[0], a.q, d, a.Sq, a.H, B, a.qs[2], a.qs[1], a.qs[0],
                    64));
  DEVT_TRY(head_map(&m[1], a.k, d, a.Skv, a.H, B, a.ks[2], a.ks[1], a.ks[0],
                    n));
  DEVT_TRY(head_map(&m[2], a.v, d, a.Skv, a.H, B, a.vs[2], a.vs[1], a.vs[0],
                    n));
  switch (d) {
    case 16:
      return launch_one_shot_d<16, kMask, kNormAfter>(m, a, B * a.H, n,
                                                      stream);
    case 32:
      return launch_one_shot_d<32, kMask, kNormAfter>(m, a, B * a.H, n,
                                                      stream);
    case 64:
      return launch_one_shot_d<64, kMask, kNormAfter>(m, a, B * a.H, n,
                                                      stream);
  }
  return cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_online_d(const CUtensorMap (&m)[3], const FlashFwd& a,
                            int BH, cudaStream_t stream) {
  constexpr size_t bytes = online_smem(HD);
  DEVT_TRY(set_smem(flash_fwd_wgmma<HD>, bytes));
  flash_fwd_wgmma<HD><<<BH * online_parts(a.Sq), kOnlineThreads, bytes,
                        stream>>>(m[0], m[1], m[2], a);
  return cudaGetLastError();
}

// kernel 11 on the wgmma body, for a bfloat16 shape inside online_on_wgmma:
// the TMA maps of q (64-row boxes) and of k and v (128-key boxes), then
// the launch of the head dim
inline cudaError_t launch_online(const FlashFwd& a, int B, int d,
                                 cudaStream_t stream) {
  if (!online_on_wgmma(1, d)) return cudaErrorInvalidValue;
  CUtensorMap m[3];
  DEVT_TRY(head_map(&m[0], a.q, d, a.Sq, a.H, B, a.qs[2], a.qs[1], a.qs[0],
                    64));
  DEVT_TRY(head_map(&m[1], a.k, d, a.Skv, a.H, B, a.ks[2], a.ks[1], a.ks[0],
                    kOnlineKeys));
  DEVT_TRY(head_map(&m[2], a.v, d, a.Skv, a.H, B, a.vs[2], a.vs[1], a.vs[0],
                    kOnlineKeys));
  switch (d) {
    case 16: return launch_online_d<16>(m, a, B * a.H, stream);
    case 32: return launch_online_d<32>(m, a, B * a.H, stream);
    case 64: return launch_online_d<64>(m, a, B * a.H, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
