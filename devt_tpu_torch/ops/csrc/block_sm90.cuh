// The bf16 row-tile products of the fused ViT block on Hopper's wgmma and
// TMA: every bf16 product launch of kernels 1 and 2 (fused_block_fwd.cu,
// fused_block_bwd.cu) but the attention, and the ones kernels 7 and 8
// (attn_half.cu) share with them.
//
//   ln_qkv_sm90<D, stored>  LN1 + qkv (kernel 1; kernel 2's recompute with
//                           the stored statistics, also writing a)
//   out_ffn_sm90<D>         att @ Wo + bo + x = u, LN2, the FFN, y
//   ffn_dual_sm90<D>        b, z1 = b @ W1, dh = dz2 @ W2^T, h, dz1
//   row_nk_sm90<D, mode>    A @ W^T with the LayerNorm backward epilogues
//                           (block_bwd_parts.cuh's modes: datt, LN2, LN1)
//   wgrad_sm90<BN>          the weight gradients of a backward, one launch
//                           for all of them, split over the rows into as
//                           many splits as fill the SMs once
//
// What they replace computed the same on warp-level mma.sync m16n8k16 tiles
// fed by ldmatrix behind two-stage cp.async rings, on 64- or 128-row tiles
// that each streamed the whole weight from L2, at a fraction of the
// tensor cores' rate (PERF.md).
//
// Design.  A CTA is two consumer warpgroups and a producer warpgroup (384
// threads; the producer gives up its registers with setmaxnreg, one lane
// of it works).  Warpgroup w owns rows 64 w .. 64 w + 63 of a 128-row tile
// and issues wgmma m64nNk16 (N = 64, 128 or 192, the whole output width of
// a pass) into f32 registers; the producer keeps the weight boxes in
// flight through a ring of stages on full and empty mbarriers (full: the
// TMA bytes; empty: one arrival from each consumer warp once the wgmma
// group that read the stage has completed), as gemm_s8_sm90.cuh does.  Every operand lives in shared memory in the 128-byte swizzle that
// TMA writes: rows of 64 bf16 values, 8-row groups 1024 bytes apart.
// Weights stay in the (K, N) layout of the JAX kernels, which the callers
// pass: for 16-bit types wgmma reads B in either major order, so x @ W
// reads W's boxes MN-major (the transpose bit) and X @ W^T reads the same
// boxes K-major; the weight gradients read both operands MN-major.  No
// transposed copy is made.  A, the row operand, comes from one of three
// places:
//   * a prologue that normalises a TMA tile of x or u in place, in the
//     swizzle (LN1, LN2; f32 statistics computed in the forward, read
//     from the residual lanes in the backward), or drops dy in place;
//   * TMA boxes of an activation in global memory (att, dz1, doproj,
//     dqkv, du; the weight gradients' operands);
//   * registers: the FFN's hidden slice, whose z1 accumulators go through
//     gelu and dropout, are rounded to bf16 and become the A fragments of
//     the W2 product directly (the layout of two 8-column accumulator
//     blocks is that of one k16 A fragment), all built before it issues.
// The epilogues are the mma.sync launches' own arithmetic on the wgmma
// accumulator layout: a thread holds rows gq and gq + 8 of its warp's 16
// and columns 8 j + 2 (lane % 4) + {0, 1}, so a row is held by one quad
// (LayerNorm row sums are quad sums) and a column by the 8 quads of a warp
// (column partials go through shuffles, then a fixed-order sum over the 8
// warps in shared memory).  qkv, u, y, h and dz1 are staged in shared
// memory and written by TMA stores.  Each dropout bit is drawn from the
// element's flat index row * width + column, as everywhere in the block, so the
// masks match the forward's and the plain versions' whatever holds the
// accumulator.  No atomics: reruns are bit-equal.
//
// Bound on an NVIDIA H100 (989 TFLOP/s dense bf16, 3.35 TB/s) at the
// main-path shape (B*S = 106,496 rows, D = 192, MLP 768): out_ffn 70.7
// GFLOP (0.071 ms), ffn_dual 62.8, the four weight gradients 94.2 GFLOP
// against the bytes of their operands; ln_qkv by its bytes (x in, qkv
// out: 164 MB, 0.049 ms).  The times are in PERF.md.

#pragma once

#include "sm90_common.cuh"

namespace {

constexpr int kBlkRows = 128;  // rows a tile: two consumer warpgroups
constexpr int kBlkConsumers = 256;
constexpr int kBlkThreads = kBlkConsumers + 128;  // and a producer warpgroup
// registers a thread after setmaxnreg: the producer warpgroup keeps 40, the
// consumers take the rest (ptxas compiles for 168 at 384 threads)
constexpr int kBlkProducerRegs = 40, kBlkConsumerRegs = 232;
constexpr int kBlkStages = 4;     // ring stages of ln_qkv, row_nk, wgrad
constexpr int kFfnStages = 2;     // of out_ffn (a stage: W1 and W2 slices)
constexpr int kDualStages = 3;    // of ffn_dual (a stage: W1's or W2's slice)
constexpr int kQkvBN = 192;       // qkv columns a pass of ln_qkv
constexpr int kHidden = 64;       // FFN hidden columns a step
// the weight gradients' splits of the rows: as many as make their tiles
// fill the SMs this many times
constexpr int kWgWaves = 1;
constexpr int kBlkBox = 64 * 128;   // bytes of a (64 rows, 64 bf16) box
__host__ __device__ constexpr int blk_tiles(int rows) {
  return (rows + kBlkRows - 1) / kBlkRows;
}

// kPlain: the product in f32.  kLn2 (kernel 2): the LN2 backward from an
// f32 product db, du = dy + LN2'(db) and doproj = drop(du).  kLn1 (kernel
// 2): the LN1 backward, dx = du + LN1'(da) with du in f32.  kLn1Du
// (kernel 8): the same with du the bfloat16 upstream gradient, whose
// column sums (dbo) it also takes.
constexpr int kPlain = 0, kLn2 = 1, kLn1 = 2, kLn1Du = 3;

struct RowEpi {
  float* out_f32;       // kPlain: the product; kLn2: du
  bf16* out_bf16;       // kLn2: doproj; kLn1: dx
  const bf16* src;      // the LN input: u (kLn2), x (kLn1)
  const float* res;     // residual lanes; mu at stat, rstd at stat + 1
  const float* gamma;   // LN scale
  const bf16* resid_bf16;   // kLn2: dy; kLn1Du: du
  const float* resid_f32;   // kLn1: du
  float *part_g, *part_b, *part_o;  // column partials [tile][D]
  int stat, lanes;
  Drop drop;
};

// ---------------------------------------------------------------------------
// shared-memory layout, descriptors, barriers
// ---------------------------------------------------------------------------

// byte offset of element (r, c) of a K-major bf16 tile of kBlkRows rows in
// the 128-byte swizzle: 64-column blocks of kBlkRows x 128 bytes, the
// 16-byte chunks of row r XORed with r % 8
__device__ __forceinline__ uint32_t blk_off(int r, int c) {
  return static_cast<uint32_t>((c >> 6) * (kBlkRows * 128) + r * 128 +
                               ((((c & 63) >> 3) ^ (r & 7)) << 4) +
                               ((c & 7) << 1));
}

// wgmma descriptor of a 128-byte-swizzle operand at shared address `addr`:
// 8-row groups 1024 bytes apart; `lbo`, the bytes between the 64-element
// atoms of an MN-major operand wider than 64 (unused K-major)
__device__ __forceinline__ uint64_t blk_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// the generic proxy's shared-memory writes visible to wgmma
__device__ __forceinline__ void blk_fence_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier of `n` threads with id `id` (0 is __syncthreads')
__device__ __forceinline__ void blk_bar(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// gelu_tanh(z) and dgelu_tanh(z) (fused_block_common.cuh's expressions)
// from one tanh
__device__ __forceinline__ void gelu_both(float z, float& g, float& dg) {
  const float t = tanhf(kGeluC * (z + kGeluK * z * z * z));
  g = 0.5f * z * (1.0f + t);
  const float dinner = kGeluC * (1.0f + 3.0f * kGeluK * z * z);
  dg = 0.5f * (1.0f + t) + 0.5f * z * (1.0f - t * t) * dinner;
}

template <int N>
__device__ __forceinline__ void blk_fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(d[i]);
}

// ---------------------------------------------------------------------------
// bf16 wgmma m64nNk16 with f32 accumulators
// ---------------------------------------------------------------------------

// d[0, 32) = (acc ? d : 0) + A (64 x 16, shared; TA: MN-major) B (16 x 64,
// shared; TB: MN-major)
template <int TA, int TB>
__device__ __forceinline__ void blk_mma_ss_n64(float* d, uint64_t a, uint64_t b,
                                               int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

// d[0, 64) = (acc ? d : 0) + A (64 x 16, shared; TA: MN-major) B (16 x 128,
// shared; TB: MN-major)
template <int TA, int TB>
__device__ __forceinline__ void blk_mma_ss_n128(float* d, uint64_t a, uint64_t b,
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
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

// d[0, 96) = (acc ? d : 0) + A (64 x 16, shared; TA: MN-major) B (16 x 192,
// shared; TB: MN-major)
template <int TA, int TB>
__device__ __forceinline__ void blk_mma_ss_n192(float* d, uint64_t a, uint64_t b,
                                               int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
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
        "+f"(d[95])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

// d[0, 32) = (acc ? d : 0) + A (64 x 16, registers) B (16 x 64, shared;
// TB: MN-major)
template <int TB>
__device__ __forceinline__ void blk_mma_rs_n64(float* d, const uint32_t* a,
                                               uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
        "n"(TB));
}

// d[0, 96) = (acc ? d : 0) + A (64 x 16, registers) B (16 x 192, shared;
// TB: MN-major)
template <int TB>
__device__ __forceinline__ void blk_mma_rs_n192(float* d, const uint32_t* a,
                                               uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
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
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
        "n"(TB));
}

// one width per instance: a runtime test between wgmmas makes ptxas
// serialise them (PERF.md, C7511)
template <int N, int TA, int TB>
__device__ __forceinline__ void blk_mma_ss(float* d, uint64_t a, uint64_t b,
                                           int acc) {
  if constexpr (N == 64) {
    blk_mma_ss_n64<TA, TB>(d, a, b, acc);
  } else if constexpr (N == 128) {
    blk_mma_ss_n128<TA, TB>(d, a, b, acc);
  } else {
    static_assert(N == 192, "wgmma widths of the block: 64, 128, 192");
    blk_mma_ss_n192<TA, TB>(d, a, b, acc);
  }
}

template <int N, int TB>
__device__ __forceinline__ void blk_mma_rs(float* d, const uint32_t* a,
                                           uint64_t b, int acc) {
  if constexpr (N == 64) {
    blk_mma_rs_n64<TB>(d, a, b, acc);
  } else {
    static_assert(N == 192, "the W2 product's widths: the dims 64, 192");
    blk_mma_rs_n192<TB>(d, a, b, acc);
  }
}

// The four products of a 64-deep k block from stage memory, one warpgroup:
// A K-major at a_addr (rows 128 bytes apart), B at b_addr, K-major (TB 0:
// a k16 step is 32 bytes along the swizzled row) or MN-major (TB 1: a k16
// step is 16 rows of 128 bytes; `lbo` between 64-column atoms).
template <int N, int TB>
__device__ __forceinline__ void blk_kblock(float* acc, uint32_t a_addr,
                                           uint32_t b_addr, uint32_t lbo,
                                           int first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    blk_mma_ss<N, 0, TB>(acc, blk_desc(a_addr + 32 * kk, 0),
                         blk_desc(b_addr + (TB ? 2048 : 32) * kk, lbo),
                         !first || kk > 0);
}

// ---------------------------------------------------------------------------
// the ring: the producer's and the consumers' turns at step g
// ---------------------------------------------------------------------------

template <int S>
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty) {
  for (int i = 0; i < S; ++i) {
    mbar_init(&full[i], 1);
    mbar_init(&empty[i], kBlkConsumers / 32);  // one arrival a warp
  }
}

// the producer: stage g % S free again, `bytes` announced on its full
// barrier
template <int S>
__device__ __forceinline__ int ring_put(uint64_t* full, uint64_t* empty,
                                        int g, uint32_t bytes) {
  const int st = g % S;
  mbar_wait(&empty[st], ((g / S) & 1) ^ 1);
  mbar_expect_tx(&full[st], bytes);
  return st;
}

template <int S>
__device__ __forceinline__ int ring_get(uint64_t* full, int g) {
  const int st = g % S;
  mbar_wait(&full[st], (g / S) & 1);
  return st;
}

// a consumer warp hands stage g % S back
template <int S>
__device__ __forceinline__ void ring_free(uint64_t* empty, int g) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[g % S]);
}

__device__ __forceinline__ void blk_producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kBlkProducerRegs));
}

__device__ __forceinline__ void blk_consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kBlkConsumerRegs));
}

__device__ __forceinline__ unsigned char* blk_base(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// output tiles: staged in shared memory, written by TMA
// ---------------------------------------------------------------------------
//
// A warpgroup's 64 output rows go out through its own staging area of
// (64 rows, 64 columns) boxes in the 128-byte swizzle: the accumulators'
// pairs are written there (a warp's 8 rows fall on 8 different 16-byte
// chunks: no bank conflict), then one thread hands the boxes to TMA, which
// writes whole lines and clips the rows past the tensor's end, in place of
// the accumulator layout's scattered 4-byte stores (16 bytes of a row
// each).

// the box of `map` at (c0, c1) from shared memory at src
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}

// pair (v0, v1) of tile row r (0..63), columns c, c + 1 into the boxes at
// `stage`
__device__ __forceinline__ void blk_stage_pair(unsigned char* stage, int r,
                                               int c, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(
      stage + (c >> 6) * kBlkBox + r * 128 +
      ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1)) =
      pack_bf16(v0, v1);
}

// the warpgroup's 64 x N accumulators, rounded to bf16, into its boxes
template <int N>
__device__ __forceinline__ void blk_stage(unsigned char* stage,
                                          const float* acc) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      blk_stage_pair(stage, 16 * warp + (lane >> 2) + 8 * hh,
                     8 * j + 2 * (lane & 3), acc[4 * j + 2 * hh],
                     acc[4 * j + 2 * hh + 1]);
}

// the warpgroup's nb staged boxes to `map` at columns c0, c0 + 64, ... and
// rows r0 ..: visible to TMA, then issued by the warpgroup's first thread
__device__ __forceinline__ void blk_store(const CUtensorMap* map,
                                          const unsigned char* stage, int nb,
                                          int c0, int r0) {
  blk_fence_smem();
  blk_bar(2 + (threadIdx.x >> 7), 128);
  if ((threadIdx.x & 127) == 0) {
    for (int b = 0; b < nb; ++b)
      tma_store_2d(map, stage + b * kBlkBox, c0 + 64 * b, r0);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// before the warpgroup writes its staging area again: the stores issued
// from it have read it
__device__ __forceinline__ void blk_stage_free() {
  if ((threadIdx.x & 127) == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  blk_bar(2 + (threadIdx.x >> 7), 128);
}

// at the end: the warpgroup's stores complete before its CTA leaves
__device__ __forceinline__ void blk_store_drain() {
  if ((threadIdx.x & 127) == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ===========================================================================
// LN1 + qkv
// ===========================================================================

template <int D>
__host__ __device__ constexpr size_t ln_qkv_smem() {
  return 1024 + static_cast<size_t>(D) * kBlkRows * 2 +
         (kBlkStages + 2) * static_cast<size_t>(64) * kQkvBN * 2;
}

// LayerNorm of row r of a kBlkRows x D tile in shared memory, in place, by
// one warp (lane l holds the column pairs 64 t + 2 l): kStored reads mu and
// rstd from res (lanes stat, stat + 1) and writes the rounded output to
// `out` too; otherwise computes them (two passes, f32) and writes them to
// res.  The output is rounded to bf16.
template <int D, bool kStored>
__device__ __forceinline__ void blk_ln_row(unsigned char* A, int r, size_t g,
                                           const float* __restrict__ gamma,
                                           const float* __restrict__ beta,
                                           float* __restrict__ res, int stat,
                                           int lanes, bf16* __restrict__ out) {
  constexpr int KB = D / 64;
  const int lane = threadIdx.x & 31;
  float v[2 * KB];
#pragma unroll
  for (int t = 0; t < KB; ++t) {
    const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(
        A + blk_off(r, 64 * t + 2 * lane));
    v[2 * t] = __low2float(p);
    v[2 * t + 1] = __high2float(p);
  }
  float mu, rstd;
  if (kStored) {
    mu = res[g * lanes + stat];
    rstd = res[g * lanes + stat + 1];
  } else {
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < 2 * KB; ++t) s += v[t];
    mu = warp_sum(s) / D;
    float q = 0.f;
#pragma unroll
    for (int t = 0; t < 2 * KB; ++t) q += (v[t] - mu) * (v[t] - mu);
    rstd = rsqrtf(warp_sum(q) / D + kLnEps);
    if (lane == 0) {
      res[g * lanes + stat] = mu;
      res[g * lanes + stat + 1] = rstd;
    }
  }
#pragma unroll
  for (int t = 0; t < KB; ++t) {
    const int c = 64 * t + 2 * lane;
    const uint32_t a = pack_bf16((v[2 * t] - mu) * rstd * gamma[c] + beta[c],
                                 (v[2 * t + 1] - mu) * rstd * gamma[c + 1] +
                                     beta[c + 1]);
    *reinterpret_cast<uint32_t*>(A + blk_off(r, c)) = a;
    if (kStored) *reinterpret_cast<uint32_t*>(out + g * D + c) = a;
  }
}

// kStored = false (the forward): LN1 statistics are computed and written
// to res.  kStored = true (the backward's recompute): they are read from
// res, and a = LN1(x) is also written out, the operand of the Wqkv
// gradient.  The producer loads the tile's x by TMA and streams the Wqkv
// boxes (MN-major) through the ring; the consumers normalise the rows in
// place and take qkv = a @ Wqkv in passes of kQkvBN columns, each a chain
// of D / 64 k blocks, staged and stored by TMA.
template <int D, bool kStored>
__global__ void __launch_bounds__(kBlkThreads, 1)
    ln_qkv_sm90(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap tqkv,
                const float* __restrict__ g1, const float* __restrict__ b1,
                float* __restrict__ res, bf16* __restrict__ a_out, int rows,
                int H, int lanes) {
  constexpr int KB = D / 64, NC = 3 * D / kQkvBN, S = kBlkStages;
  constexpr uint32_t kStage = 64 * kQkvBN * 2, kABytes = D * kBlkRows * 2;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S], abar;
  unsigned char* As = blk_base(smem_raw);
  unsigned char* ring = As + kABytes;
  unsigned char* out = ring + S * kStage;  // a kStage staging area a warpgroup
  const int row0 = blockIdx.x * kBlkRows;
  if (threadIdx.x == 0) {
    ring_init<S>(full, empty);
    mbar_init(&abar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kBlkConsumers) {
    blk_producer_regs();
    if (threadIdx.x != kBlkConsumers) return;
    mbar_expect_tx(&abar, kABytes);
    for (int kb = 0; kb < KB; ++kb)
      tma_load_2d(As + kb * kBlkRows * 128, &tx, &abar, 64 * kb, row0);
    int g = 0;
    for (int nc = 0; nc < NC; ++nc)
      for (int kb = 0; kb < KB; ++kb, ++g) {
        const int st = ring_put<S>(full, empty, g, kStage);
        for (int j = 0; j < kQkvBN / 64; ++j)
          tma_load_2d(ring + st * kStage + j * kBlkBox, &tw, &full[st],
                      nc * kQkvBN + 64 * j, 64 * kb);
      }
    return;
  }
  blk_consumer_regs();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  unsigned char* stage = out + wg * kStage;
  // LN1 of the warpgroup's rows in place, a warp per row; rows past the
  // end stay TMA's zeros (their products are not stored)
  mbar_wait(&abar, 0);
  for (int i = warp; i < 64; i += 4) {
    const int r = 64 * wg + i;
    if (row0 + r < rows)
      blk_ln_row<D, kStored>(As, r, static_cast<size_t>(row0 + r), g1, b1,
                             res, H, lanes, a_out);
  }
  blk_fence_smem();
  blk_bar(2 + wg, 128);  // the warpgroup's rows of A written

  const uint32_t a_addr = smem_addr(As) + wg * 64 * 128;
  int g = 0;
#pragma unroll 1
  for (int nc = 0; nc < NC; ++nc) {
    float acc[kQkvBN / 2];
#pragma unroll 1
    for (int kb = 0; kb < KB; ++kb, ++g) {
      const int st = ring_get<S>(full, g);
      blk_fence_regs<kQkvBN / 2>(acc);
      wgmma_fence();
      blk_kblock<kQkvBN, 1>(acc, a_addr + kb * kBlkRows * 128,
                            smem_addr(ring + st * kStage), kBlkBox, kb == 0);
      wgmma_commit();
      wgmma_wait<1>();  // the group of the k block before has completed
      blk_fence_regs<kQkvBN / 2>(acc);
      if (kb > 0) ring_free<S>(empty, g - 1);
    }
    wgmma_wait<0>();
    blk_fence_regs<kQkvBN / 2>(acc);
    ring_free<S>(empty, g - 1);
    if (nc > 0) blk_stage_free();
    blk_stage<kQkvBN>(stage, acc);
    blk_store(&tqkv, stage, kQkvBN / 64, nc * kQkvBN, row0 + 64 * wg);
  }
  blk_store_drain();
}

// ===========================================================================
// forward: out-projection, residual, LN2, FFN, residual
// ===========================================================================

template <int D>
__host__ __device__ constexpr size_t out_ffn_stage() {
  return 2 * static_cast<size_t>(D) * 128;  // W1[:, slice] and W2[slice, :]
}

template <int D>
__host__ __device__ constexpr size_t out_ffn_smem() {
  return 1024 + 2 * static_cast<size_t>(D) * kBlkRows * 2 +
         kFfnStages * out_ffn_stage<D>();
}

// A = att (TMA, then LN2(u) in its place, each warpgroup over its own
// rows); steps of the ring: D / 64 k blocks of Wo (MN-major boxes), then
// per kHidden hidden columns W1[:, slice] (one MN-major box of D rows) and
// W2[slice, :] (D / 64 MN-major boxes).  u = x + drop(att @ Wo + bo) is
// written in x's type (staged, by TMA) and in f32 (u32, read back for
// y), LN2 runs on the accumulators (a row is one quad's), and y
// accumulates in registers, then goes out as u did.
template <int D>
__global__ void __launch_bounds__(kBlkThreads, 1)
    out_ffn_sm90(const __grid_constant__ CUtensorMap tatt,
                 const __grid_constant__ CUtensorMap two,
                 const __grid_constant__ CUtensorMap tw1,
                 const __grid_constant__ CUtensorMap tw2,
                 const __grid_constant__ CUtensorMap tu,
                 const __grid_constant__ CUtensorMap ty,
                 const bf16* __restrict__ x, const float* __restrict__ bo,
                 const float* __restrict__ g2, const float* __restrict__ b2,
                 const float* __restrict__ bb1, const float* __restrict__ bb2,
                 float* __restrict__ u32, float* __restrict__ res, int rows,
                 int F, int H, int lanes, Drop drop) {
  constexpr int KB = D / 64, S = kFfnStages;
  constexpr uint32_t kStage = out_ffn_stage<D>();
  constexpr uint32_t kHalf = D * 128;  // bytes of W1's slice, of W2's
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S], abar;
  unsigned char* As = blk_base(smem_raw);
  unsigned char* out = As + D * kBlkRows * 2;  // a warpgroup's D / 64 boxes
  unsigned char* ring = out + D * kBlkRows * 2;
  const int row0 = blockIdx.x * kBlkRows;
  const int chunks = F / kHidden;
  if (threadIdx.x == 0) {
    ring_init<S>(full, empty);
    mbar_init(&abar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kBlkConsumers) {
    blk_producer_regs();
    if (threadIdx.x != kBlkConsumers) return;
    mbar_expect_tx(&abar, D * kBlkRows * 2);
    for (int kb = 0; kb < KB; ++kb)
      tma_load_2d(As + kb * kBlkRows * 128, &tatt, &abar, 64 * kb, row0);
    int g = 0;
    for (int kb = 0; kb < KB; ++kb, ++g) {
      const int st = ring_put<S>(full, empty, g, kHalf);
      for (int j = 0; j < KB; ++j)
        tma_load_2d(ring + st * kStage + j * kBlkBox, &two, &full[st], 64 * j,
                    64 * kb);
    }
    for (int c = 0; c < chunks; ++c, ++g) {
      const int st = ring_put<S>(full, empty, g, kStage);
      unsigned char* dst = ring + st * kStage;
      tma_load_2d(dst, &tw1, &full[st], kHidden * c, 0);
      for (int j = 0; j < KB; ++j)
        tma_load_2d(dst + kHalf + j * kBlkBox, &tw2, &full[st], 64 * j,
                    kHidden * c);
    }
    return;
  }
  blk_consumer_regs();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq4 = lane & 3;
  const int rt = 64 * wg + 16 * warp + gq;  // the thread's first tile row
  const uint32_t a_addr = smem_addr(As) + wg * 64 * 128;
  unsigned char* stage = out + wg * D * 128;
  int g = 0;

  // u = x + drop(att @ Wo + bo)
  float acc[D / 2];
  mbar_wait(&abar, 0);
#pragma unroll 1
  for (int kb = 0; kb < KB; ++kb, ++g) {
    const int st = ring_get<S>(full, g);
    blk_fence_regs<D / 2>(acc);
    wgmma_fence();
    blk_kblock<D, 1>(acc, a_addr + kb * kBlkRows * 128,
                     smem_addr(ring + st * kStage), kBlkBox, kb == 0);
    wgmma_commit();
    wgmma_wait<1>();
    blk_fence_regs<D / 2>(acc);
    if (kb > 0) ring_free<S>(empty, g - 1);
  }
  wgmma_wait<0>();
  blk_fence_regs<D / 2>(acc);
  ring_free<S>(empty, g - 1);

  float mu[2], rstd[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int gr = row0 + rt + 8 * hh;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * tq4;
      float u0 = 0.f, u1 = 0.f;
      if (gr < rows) {
        const size_t e = static_cast<size_t>(gr) * D + c;
        const __nv_bfloat162 xv =
            *reinterpret_cast<const __nv_bfloat162*>(x + e);
        float o0 = acc[4 * j + 2 * hh] + bo[c];
        float o1 = acc[4 * j + 2 * hh + 1] + bo[c + 1];
        drop_pair(drop, kSiteOut, e, o0, o1);
        u0 = __low2float(xv) + o0;
        u1 = __high2float(xv) + o1;
        *reinterpret_cast<float2*>(u32 + e) = make_float2(u0, u1);
      }
      blk_stage_pair(stage, rt - 64 * wg + 8 * hh, c, u0, u1);
      acc[4 * j + 2 * hh] = u0;
      acc[4 * j + 2 * hh + 1] = u1;
      s += u0 + u1;
    }
    mu[hh] = quad_sum(s) / D;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float d0 = acc[4 * j + 2 * hh] - mu[hh];
      const float d1 = acc[4 * j + 2 * hh + 1] - mu[hh];
      q += d0 * d0 + d1 * d1;
    }
    rstd[hh] = rsqrtf(quad_sum(q) / D + kLnEps);
    if (hh == 1) blk_store(&tu, stage, D / 64, 0, row0 + 64 * wg);
    if (tq4 == 0 && gr < rows) {
      const size_t e = static_cast<size_t>(gr) * lanes;
      res[e + H + 2] = mu[hh];
      res[e + H + 3] = rstd[hh];
      for (int l = H + 4; l < lanes; ++l) res[e + l] = 0.f;
    }
  }
  // LN2(u) in x's type over the warpgroup's own rows of A (its Wo
  // products have completed)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * tq4;
      *reinterpret_cast<uint32_t*>(As + blk_off(rt + 8 * hh, c)) = pack_bf16(
          (acc[4 * j + 2 * hh] - mu[hh]) * rstd[hh] * g2[c] + b2[c],
          (acc[4 * j + 2 * hh + 1] - mu[hh]) * rstd[hh] * g2[c + 1] +
              b2[c + 1]);
    }
  blk_fence_smem();
  blk_bar(2 + wg, 128);

  // y = h @ W2, h = drop(gelu(LN2(u) @ W1 + bb1)) kHidden columns at a time
  float yacc[D / 2];
#pragma unroll 1
  for (int c = 0; c < chunks; ++c, ++g) {
    const int st = ring_get<S>(full, g);
    const uint32_t w1_addr = smem_addr(ring + st * kStage);
    float z[kHidden / 2];
    blk_fence_regs<kHidden / 2>(z);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      blk_mma_ss<kHidden, 0, 1>(
          z, blk_desc(a_addr + (kk >> 2) * kBlkRows * 128 + 32 * (kk & 3), 0),
          blk_desc(w1_addr + 2048 * kk, 0), kk);
    wgmma_commit();
    wgmma_wait<0>();
    blk_fence_regs<kHidden / 2>(z);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const unsigned long long row = static_cast<unsigned long long>(
          row0 + rt + 8 * hh);
#pragma unroll
      for (int j = 0; j < kHidden / 8; ++j) {
        const int hc = kHidden * c + 8 * j + 2 * tq4;
        float h0 = gelu_tanh(z[4 * j + 2 * hh] + bb1[hc]);
        float h1 = gelu_tanh(z[4 * j + 2 * hh + 1] + bb1[hc + 1]);
        drop_pair(drop, kSiteHidden, row * F + hc, h0, h1);
        z[4 * j + 2 * hh] = h0;
        z[4 * j + 2 * hh + 1] = h1;
      }
    }
    // registers 8 kk .. 8 kk + 7: the A fragment of hidden columns 16 kk ..
    uint32_t hf[kHidden / 16][4];
#pragma unroll
    for (int kk = 0; kk < kHidden / 16; ++kk) {
      const float* p = z + 8 * kk;
      hf[kk][0] = pack_bf16(p[0], p[1]);
      hf[kk][1] = pack_bf16(p[2], p[3]);
      hf[kk][2] = pack_bf16(p[4], p[5]);
      hf[kk][3] = pack_bf16(p[6], p[7]);
    }
    blk_fence_regs<D / 2>(yacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHidden / 16; ++kk)
      blk_mma_rs<D, 1>(yacc, hf[kk], blk_desc(w1_addr + kHalf + 2048 * kk,
                                              kBlkBox),
                       c > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    blk_fence_regs<D / 2>(yacc);
    ring_free<S>(empty, g);
  }

  // y = u + drop(h @ W2 + bb2); each thread reads back the u32 it wrote
  blk_stage_free();  // u's boxes read
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int gr = row0 + rt + 8 * hh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * tq4;
      const size_t e = static_cast<size_t>(gr) * D + c;
      float y0 = 0.f, y1 = 0.f;
      if (gr < rows) {
        const float2 uv = *reinterpret_cast<const float2*>(u32 + e);
        float z0 = yacc[4 * j + 2 * hh] + bb2[c];
        float z1 = yacc[4 * j + 2 * hh + 1] + bb2[c + 1];
        drop_pair(drop, kSiteFfnOut, e, z0, z1);
        y0 = uv.x + z0;
        y1 = uv.y + z1;
      }
      blk_stage_pair(stage, rt - 64 * wg + 8 * hh, c, y0, y1);
    }
  }
  blk_store(&ty, stage, D / 64, 0, row0 + 64 * wg);
  blk_store_drain();
}

// ===========================================================================
// backward: FFN recompute and backward up to dz1
// ===========================================================================

template <int D>
__host__ __device__ constexpr size_t ffn_dual_smem() {
  return 1024 + 2 * static_cast<size_t>(D) * kBlkRows * 2 +
         kDualStages * static_cast<size_t>(D) * 128 + 4 * kBlkBox +
         sizeof(float) * 8 * (2 * kHidden + D);
}

// A = b = LN2(u) (stored statistics) and dz2 = drop(dy), both from TMA
// tiles of u and dy normalised and dropped in place; per kHidden hidden
// columns two ring steps bring W1[:, slice] (MN-major for z1 = b @ W1) and
// W2[slice, :] (K-major for dh = dz2 @ W2^T).  Writes b (and dz2 with
// dropout) in x's type, h and dz1 staged and stored by TMA, and the
// column partials of dbb1 (f32 dz1) and dbb2 (f32 dz2) of the tile.
template <int D>
__global__ void __launch_bounds__(kBlkThreads, 1)
    ffn_dual_sm90(const __grid_constant__ CUtensorMap tu,
                  const __grid_constant__ CUtensorMap tdy,
                  const __grid_constant__ CUtensorMap tw1,
                  const __grid_constant__ CUtensorMap tw2,
                  const __grid_constant__ CUtensorMap th,
                  const __grid_constant__ CUtensorMap tdz1,
                  const float* __restrict__ res, const float* __restrict__ g2,
                  const float* __restrict__ b2, const float* __restrict__ bb1,
                  bf16* __restrict__ b_out, bf16* __restrict__ dz2_out,
                  float* __restrict__ part_bb1, float* __restrict__ part_bb2,
                  int rows, int F, int H, int lanes, Drop drop) {
  constexpr int KB = D / 64, S = kDualStages;
  constexpr uint32_t kHalf = D * 128;  // a stage: W1's slice or W2's
  constexpr uint32_t kABytes = D * kBlkRows * 2;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S], abar;
  unsigned char* Bs = blk_base(smem_raw);
  unsigned char* Zs = Bs + kABytes;
  unsigned char* ring = Zs + kABytes;
  unsigned char* out = ring + S * kHalf;  // a warpgroup's h box, dz1 box
  // per warp: the column sums of dz1 (two buffers, by chunk parity), of dz2
  float* colred = reinterpret_cast<float*>(out + 4 * kBlkBox);
  float* col2 = colred + 8 * 2 * kHidden;
  const int row0 = blockIdx.x * kBlkRows;
  const int chunks = F / kHidden;
  if (threadIdx.x == 0) {
    ring_init<S>(full, empty);
    mbar_init(&abar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kBlkConsumers) {
    blk_producer_regs();
    if (threadIdx.x != kBlkConsumers) return;
    mbar_expect_tx(&abar, 2 * kABytes);
    for (int kb = 0; kb < KB; ++kb) {
      tma_load_2d(Bs + kb * kBlkRows * 128, &tu, &abar, 64 * kb, row0);
      tma_load_2d(Zs + kb * kBlkRows * 128, &tdy, &abar, 64 * kb, row0);
    }
    for (int c = 0; c < chunks; ++c) {
      int st = ring_put<S>(full, empty, 2 * c, kHalf);
      tma_load_2d(ring + st * kHalf, &tw1, &full[st], kHidden * c, 0);
      st = ring_put<S>(full, empty, 2 * c + 1, kHalf);
      for (int j = 0; j < KB; ++j)
        tma_load_2d(ring + st * kHalf + j * kBlkBox, &tw2, &full[st], 64 * j,
                    kHidden * c);
    }
    return;
  }
  blk_consumer_regs();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int w8 = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq4 = lane & 3;
  const int rt = 64 * wg + 16 * warp + gq;
  unsigned char* stage = out + wg * 2 * kBlkBox;

  // in place over the TMA tiles, a warp per row: b = LN2(u) from the
  // stored statistics, dz2 = drop(dy); lane l holds the column pairs 64 t
  // + 2 l and sums its dz2 (f32) over the warp's rows.  Rows past the end
  // stay zeros.
  mbar_wait(&abar, 0);
  float cs[2 * KB] = {};
  for (int i = warp; i < 64; i += 4) {
    const int r = 64 * wg + i, gr = row0 + r;
    if (gr >= rows) continue;
    const size_t gl = static_cast<size_t>(gr);
    blk_ln_row<D, true>(Bs, r, gl, g2, b2, const_cast<float*>(res), H + 2,
                        lanes, b_out);
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      const int c = 64 * t + 2 * lane;
      uint32_t* zp = reinterpret_cast<uint32_t*>(Zs + blk_off(r, c));
      const __nv_bfloat162 dv = *reinterpret_cast<const __nv_bfloat162*>(zp);
      float d0 = __low2float(dv), d1 = __high2float(dv);
      drop_pair(drop, kSiteFfnOut, gl * D + c, d0, d1);
      cs[2 * t] += d0;
      cs[2 * t + 1] += d1;
      if (drop.on) {
        const uint32_t zv = pack_bf16(d0, d1);
        *zp = zv;
        *reinterpret_cast<uint32_t*>(dz2_out + gl * D + c) = zv;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < KB; ++t) {
    col2[w8 * D + 64 * t + 2 * lane] = cs[2 * t];
    col2[w8 * D + 64 * t + 2 * lane + 1] = cs[2 * t + 1];
  }
  blk_fence_smem();
  blk_bar(1, kBlkConsumers);  // b, dz2 and the dz2 sums of every warp
  for (int c = threadIdx.x; c < D; c += kBlkConsumers) {
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += col2[w * D + c];
    part_bb2[static_cast<size_t>(blockIdx.x) * D + c] = s;
  }

  const uint32_t a_off = wg * 64 * 128;
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    float z[kHidden / 2], dh[kHidden / 2];
    blk_fence_regs<kHidden / 2>(z);
    blk_fence_regs<kHidden / 2>(dh);
    const uint32_t w1_addr = smem_addr(ring + ring_get<S>(full, 2 * c) * kHalf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t k_off = (kk >> 2) * kBlkRows * 128 + 32 * (kk & 3) + a_off;
      blk_mma_ss<kHidden, 0, 1>(z, blk_desc(smem_addr(Bs) + k_off, 0),
                                blk_desc(w1_addr + 2048 * kk, 0), kk);
    }
    const uint32_t w2_addr =
        smem_addr(ring + ring_get<S>(full, 2 * c + 1) * kHalf);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t k_off = (kk >> 2) * kBlkRows * 128 + 32 * (kk & 3) + a_off;
      blk_mma_ss<kHidden, 0, 0>(
          dh, blk_desc(smem_addr(Zs) + k_off, 0),
          blk_desc(w2_addr + (kk >> 2) * kBlkBox + 32 * (kk & 3), 0), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    blk_fence_regs<kHidden / 2>(z);
    blk_fence_regs<kHidden / 2>(dh);
    ring_free<S>(empty, 2 * c);
    ring_free<S>(empty, 2 * c + 1);

    if (c > 0) blk_stage_free();
    float* cr = colred + (c & 1) * 8 * kHidden;
#pragma unroll
    for (int j = 0; j < kHidden / 8; ++j) {
      float csum[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int gr = row0 + rt + 8 * hh;
        const int hc = kHidden * c + 8 * j + 2 * tq4;
        const size_t e = static_cast<size_t>(gr) * F + hc;
        float h0, h1, dg0, dg1;
        gelu_both(z[4 * j + 2 * hh] + bb1[hc], h0, dg0);
        gelu_both(z[4 * j + 2 * hh + 1] + bb1[hc + 1], h1, dg1);
        float d0 = dh[4 * j + 2 * hh], d1 = dh[4 * j + 2 * hh + 1];
        if (drop.on) {
          bool k0, k1;
          drop_keep2(drop, kSiteHidden, e, k0, k1);
          h0 = k0 ? h0 * drop.scale : 0.f;
          h1 = k1 ? h1 * drop.scale : 0.f;
          d0 = k0 ? d0 * drop.scale : 0.f;
          d1 = k1 ? d1 * drop.scale : 0.f;
        }
        d0 *= dg0;
        d1 *= dg1;
        csum[0] += d0;  // rows past the end have dy = 0, so d = 0
        csum[1] += d1;
        // rows past the end: staged, and clipped by TMA
        blk_stage_pair(stage, rt - 64 * wg + 8 * hh, 8 * j + 2 * tq4, h0,
                       h1);
        blk_stage_pair(stage + kBlkBox, rt - 64 * wg + 8 * hh,
                       8 * j + 2 * tq4, d0, d1);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float s = column_sum(csum[q]);
        if (gq == 0) cr[w8 * kHidden + 8 * j + 2 * tq4 + q] = s;
      }
    }
    blk_fence_smem();
    blk_bar(2 + wg, 128);  // the warpgroup's h and dz1 boxes staged
    if ((threadIdx.x & 127) == 0) {
      tma_store_2d(&th, stage, kHidden * c, row0 + 64 * wg);
      tma_store_2d(&tdz1, stage + kBlkBox, kHidden * c, row0 + 64 * wg);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    blk_bar(1, kBlkConsumers);  // the column sums of every warp
    if (threadIdx.x < kHidden) {
      float s = 0.f;
      for (int w = 0; w < 8; ++w) s += cr[w * kHidden + threadIdx.x];
      part_bb1[static_cast<size_t>(blockIdx.x) * F + kHidden * c +
               threadIdx.x] = s;
    }
  }
  blk_store_drain();
}

// ===========================================================================
// backward: a 128-row tile times a transposed weight, and its epilogues
// ===========================================================================

template <int D>
__host__ __device__ constexpr size_t row_nk_stage() {
  return static_cast<size_t>(kBlkRows) * 128 + static_cast<size_t>(D) * 128;
}

template <int D>
__host__ __device__ constexpr size_t row_nk_smem() {
  return 1024 + kBlkStages * row_nk_stage<D>() + sizeof(float) * 3 * 8 * D;
}

// The epilogue of MODE for the rows of tile `tile` (row0 its first) from
// the warpgroup's accumulators; column partials of the tile through
// colred [3][8][D] (all 256 consumer threads take part)
template <int D, int MODE>
__device__ __forceinline__ void row_nk_epilogue(float* acc, const RowEpi& ep,
                                                int rows, int row0, int tile,
                                                float* colred) {
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int w8 = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq4 = lane & 3;
  const int rt = row0 + 64 * wg + 16 * warp + gq;  // the thread's first row
  if (MODE == kPlain) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gr = rt + 8 * hh;
      if (gr >= rows) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(ep.out_f32 + static_cast<size_t>(gr) * D +
                                   8 * j + 2 * tq4) =
            make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
    return;
  }

  // LN backward.  acc holds dv (db or da).  With xhat = (src - mu) * rstd:
  // out = resid + rstd * (dv*g - mean(dv*g) - xhat * mean(dv*g*xhat));
  // the column sums of dv * xhat and dv are the LN parameter gradients.
  float mu[2], rstd[2], s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int gr = rt + 8 * hh;
    const size_t gl = static_cast<size_t>(gr);
    mu[hh] = gr < rows ? ep.res[gl * ep.lanes + ep.stat] : 0.f;
    rstd[hh] = gr < rows ? ep.res[gl * ep.lanes + ep.stat + 1] : 0.f;
  }
  // the f32 xhat of the thread's two rows at columns c, c + 1
  auto xhat = [&](int hh, int c, float& v0, float& v1) {
    const int gr = rt + 8 * hh;
    v0 = v1 = 0.f;
    if (gr < rows) {
      const __nv_bfloat162 sv = *reinterpret_cast<const __nv_bfloat162*>(
          ep.src + static_cast<size_t>(gr) * D + c);
      v0 = (__low2float(sv) - mu[hh]) * rstd[hh];
      v1 = (__high2float(sv) - mu[hh]) * rstd[hh];
    }
  };
  // column partials of the warp's 16 rows: lanes gq == 0 store them
  auto col_put = [&](int q, int c, float v0, float v1) {
    v0 = column_sum(v0);
    v1 = column_sum(v1);
    if (gq == 0) {
      colred[(q * 8 + w8) * D + c] = v0;
      colred[(q * 8 + w8) * D + c + 1] = v1;
    }
  };
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * tq4;
    float cg0 = 0.f, cg1 = 0.f, cb0 = 0.f, cb1 = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float x0, x1;
      xhat(hh, c, x0, x1);
      const float d0 = acc[4 * j + 2 * hh], d1 = acc[4 * j + 2 * hh + 1];
      cg0 += d0 * x0;
      cg1 += d1 * x1;
      cb0 += d0;
      cb1 += d1;
      const float e0 = d0 * ep.gamma[c], e1 = d1 * ep.gamma[c + 1];
      acc[4 * j + 2 * hh] = e0;
      acc[4 * j + 2 * hh + 1] = e1;
      s1[hh] += e0 + e1;
      s2[hh] += e0 * x0 + e1 * x1;
    }
    col_put(0, c, cg0, cg1);
    col_put(1, c, cb0, cb1);
  }
  float m1[2], m2[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    m1[hh] = quad_sum(s1[hh]) / D;
    m2[hh] = quad_sum(s2[hh]) / D;
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * tq4;
    float co0 = 0.f, co1 = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gr = rt + 8 * hh;
      float x0, x1;
      xhat(hh, c, x0, x1);
      float t0 = rstd[hh] * (acc[4 * j + 2 * hh] - m1[hh] - x0 * m2[hh]);
      float t1 = rstd[hh] * (acc[4 * j + 2 * hh + 1] - m1[hh] - x1 * m2[hh]);
      if (gr >= rows) continue;  // t = 0 there: nothing to add or store
      const size_t e = static_cast<size_t>(gr) * D + c;
      if (MODE == kLn2) {
        const __nv_bfloat162 rv =
            *reinterpret_cast<const __nv_bfloat162*>(ep.resid_bf16 + e);
        t0 += __low2float(rv);
        t1 += __high2float(rv);
        *reinterpret_cast<float2*>(ep.out_f32 + e) = make_float2(t0, t1);
        drop_pair(ep.drop, kSiteOut, e, t0, t1);
        co0 += t0;
        co1 += t1;
      } else if (MODE == kLn1Du) {
        const __nv_bfloat162 rv =
            *reinterpret_cast<const __nv_bfloat162*>(ep.resid_bf16 + e);
        const float r0 = __low2float(rv), r1 = __high2float(rv);
        co0 += r0;
        co1 += r1;
        t0 += r0;
        t1 += r1;
      } else {
        const float2 rv = *reinterpret_cast<const float2*>(ep.resid_f32 + e);
        t0 += rv.x;
        t1 += rv.y;
      }
      *reinterpret_cast<uint32_t*>(ep.out_bf16 + e) = pack_bf16(t0, t1);
    }
    if (MODE == kLn2 || MODE == kLn1Du) col_put(2, c, co0, co1);
  }
  blk_bar(1, kBlkConsumers);  // the column sums of every warp
  for (int c = threadIdx.x; c < D; c += kBlkConsumers) {
    float sg = 0.f, sb = 0.f, so = 0.f;
    for (int w = 0; w < 8; ++w) {
      sg += colred[w * D + c];
      sb += colred[(8 + w) * D + c];
      if (MODE == kLn2 || MODE == kLn1Du) so += colred[(16 + w) * D + c];
    }
    const size_t o = static_cast<size_t>(tile) * D + c;
    ep.part_g[o] = sg;
    ep.part_b[o] = sb;
    if (MODE == kLn2 || MODE == kLn1Du) ep.part_o[o] = so;
  }
}

// acc (64 x D a warpgroup) = A[rows, 0:K] @ W[0:D, 0:K]^T over the CTA's
// 128-row tile: a stage is a 64-deep k block of A (a box of 128 rows) and
// of W (a box of D rows), both K-major.  Then the epilogue of MODE; column
// partials [tile][D].  A CTA a tile: a persistent grid whose ring ran on
// across tiles measured level (PERF.md).
template <int D, int MODE>
__global__ void __launch_bounds__(kBlkThreads, 1)
    row_nk_sm90(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tw, int K, RowEpi ep,
                int rows) {
  constexpr int S = kBlkStages;
  constexpr uint32_t kStage = row_nk_stage<D>();
  constexpr uint32_t kABytes = kBlkRows * 128;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  unsigned char* ring = blk_base(smem_raw);
  float* colred = reinterpret_cast<float*>(ring + S * kStage);  // [3][8][D]
  const int nk = K / 64, t = blockIdx.x;
  if (threadIdx.x == 0) {
    ring_init<S>(full, empty);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kBlkConsumers) {
    blk_producer_regs();
    if (threadIdx.x != kBlkConsumers) return;
    for (int kb = 0; kb < nk; ++kb) {
      const int st = ring_put<S>(full, empty, kb, kStage);
      tma_load_2d(ring + st * kStage, &ta, &full[st], 64 * kb, t * kBlkRows);
      tma_load_2d(ring + st * kStage + kABytes, &tw, &full[st], 64 * kb, 0);
    }
    return;
  }
  blk_consumer_regs();

  const int wg = threadIdx.x >> 7;
  float acc[D / 2];
#pragma unroll 1
  for (int kb = 0; kb < nk; ++kb) {
    const int st = ring_get<S>(full, kb);
    const uint32_t s_addr = smem_addr(ring + st * kStage);
    blk_fence_regs<D / 2>(acc);
    wgmma_fence();
    blk_kblock<D, 0>(acc, s_addr + wg * 64 * 128, s_addr + kABytes, 0,
                     kb == 0);
    wgmma_commit();
    wgmma_wait<1>();
    blk_fence_regs<D / 2>(acc);
    if (kb > 0) ring_free<S>(empty, kb - 1);
  }
  wgmma_wait<0>();
  blk_fence_regs<D / 2>(acc);
  row_nk_epilogue<D, MODE>(acc, ep, rows, t * kBlkRows, t, colred);
}

// ===========================================================================
// backward: the weight gradients, part[split] = A[rows of split]^T @ B
// ===========================================================================

constexpr int kWgJobs = 4;

// up to four products of one backward; CTA t belongs to the job whose
// [start, start of the next) holds it, and within it walks m tiles
// fastest, then n tiles, then splits
struct WgJobs {
  CUtensorMap ta[kWgJobs], tb[kWgJobs];  // A (rows, M), B (rows, N)
  float* part[kWgJobs];                  // [splits][M][N] f32
  int M[kWgJobs], N[kWgJobs], start[kWgJobs + 1];
  int jobs, rows, split_rows;
};

template <int BN>
__host__ __device__ constexpr size_t wgrad_stage() {
  return 2 * static_cast<size_t>(kBlkBox) + (BN / 64) * kBlkBox;
}

template <int BN>
__host__ __device__ constexpr size_t wgrad_smem() {
  return 1024 + kBlkStages * wgrad_stage<BN>();
}

// A CTA owns a 128 x BN output tile (warpgroup w its rows 64 w ..) and
// split_rows rows of the contraction: per 64 rows a stage holds a
// (64 m, 64 rows) box of A for each live warpgroup and BN / 64 (64 n, 64
// rows) boxes of B, both MN-major (the transpose bits); a warpgroup whose
// rows lie wholly past M loads nothing and only hands its stages back.
template <int BN>
__global__ void __launch_bounds__(kBlkThreads, 1)
    wgrad_sm90(const __grid_constant__ WgJobs jb) {
  constexpr int S = kBlkStages;
  constexpr uint32_t kStage = wgrad_stage<BN>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  unsigned char* ring = blk_base(smem_raw);
  int job = 0;
  while (job + 1 < jb.jobs && static_cast<int>(blockIdx.x) >= jb.start[job + 1])
    ++job;
  const int M = jb.M[job], N = jb.N[job];
  const int mt = (M + kBlkRows - 1) / kBlkRows, tiles = mt * (N / BN);
  const int local = blockIdx.x - jb.start[job];
  const int split = local / tiles, tile = local - split * tiles;
  const int m0 = (tile % mt) * kBlkRows, n0 = (tile / mt) * BN;
  const int r_begin = split * jb.split_rows;  // < rows: no split is empty
  const int nk = (min(jb.rows - r_begin, jb.split_rows) + 63) / 64;
  const int live = min(2, (M - m0) / 64);  // warpgroups with rows of M
  if (threadIdx.x == 0) {
    ring_init<S>(full, empty);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kBlkConsumers) {
    blk_producer_regs();
    if (threadIdx.x != kBlkConsumers) return;
    const uint32_t bytes = (live + BN / 64) * kBlkBox;
    for (int kb = 0; kb < nk; ++kb) {
      const int st = ring_put<S>(full, empty, kb, bytes);
      unsigned char* dst = ring + st * kStage;
      const int r = r_begin + 64 * kb;
      for (int w = 0; w < live; ++w)
        tma_load_2d(dst + w * kBlkBox, &jb.ta[job], &full[st], m0 + 64 * w, r);
      for (int j = 0; j < BN / 64; ++j)
        tma_load_2d(dst + 2 * kBlkBox + j * kBlkBox, &jb.tb[job], &full[st],
                    n0 + 64 * j, r);
    }
    return;
  }
  blk_consumer_regs();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq4 = lane & 3;
  if (wg >= live) {
    for (int kb = 0; kb < nk; ++kb) {
      ring_get<S>(full, kb);
      ring_free<S>(empty, kb);
    }
    return;
  }
  float acc[BN / 2];
#pragma unroll 1
  for (int kb = 0; kb < nk; ++kb) {
    const int st = ring_get<S>(full, kb);
    const uint32_t s_addr = smem_addr(ring + st * kStage);
    blk_fence_regs<BN / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      blk_mma_ss<BN, 1, 1>(
          acc, blk_desc(s_addr + wg * kBlkBox + 2048 * kk, 0),
          blk_desc(s_addr + 2 * kBlkBox + 2048 * kk, kBlkBox), kb | kk);
    wgmma_commit();
    wgmma_wait<1>();
    blk_fence_regs<BN / 2>(acc);
    if (kb > 0) ring_free<S>(empty, kb - 1);
  }
  wgmma_wait<0>();
  blk_fence_regs<BN / 2>(acc);
  ring_free<S>(empty, nk - 1);

  float* out = jb.part[job] + static_cast<size_t>(split) * M * N;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = m0 + 64 * wg + 16 * warp + gq + 8 * hh;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(m) * N + n0 +
                                 8 * j + 2 * tq4) =
          make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
}

// ===========================================================================
// host: tensor maps and launches
// ===========================================================================

// a bf16 matrix (rows, cols) with row stride ld elements as a 2-d map with
// boxes of (64 columns, box_rows rows) in the 128-byte swizzle; reads past
// the edges are zeros.  base 16-byte aligned, ld a multiple of 8.
inline cudaError_t blk_map(CUtensorMap* map, const void* base, int cols,
                           int rows, long long ld, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(bf16)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// LN1 + qkv of `rows` rows of x (D wide): qkv (rows, 3D); kStored also a
template <int D, bool kStored>
cudaError_t launch_ln_qkv(const bf16* x, const float* g1, const float* b1,
                          const bf16* wqkv, bf16* qkv, float* res,
                          bf16* a_out, int rows, int H, int lanes,
                          cudaStream_t stream) {
  CUtensorMap tx, tw, tqkv;
  DEVT_TRY(blk_map(&tx, x, D, rows, D, kBlkRows));
  DEVT_TRY(blk_map(&tw, wqkv, 3 * D, D, 3 * D, 64));
  DEVT_TRY(blk_map(&tqkv, qkv, 3 * D, rows, 3 * D, 64));
  constexpr size_t bytes = ln_qkv_smem<D>();
  DEVT_TRY(set_smem(ln_qkv_sm90<D, kStored>, bytes));
  ln_qkv_sm90<D, kStored><<<blk_tiles(rows), kBlkThreads, bytes, stream>>>(
      tx, tw, tqkv, g1, b1, res, a_out, rows, H, lanes);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_out_ffn(const bf16* x, const bf16* att, const bf16* wo,
                           const float* bo, const float* g2, const float* b2,
                           const bf16* w1, const float* bb1, const bf16* w2,
                           const float* bb2, bf16* y, bf16* u, float* u32,
                           float* res, int rows, int F, int H, int lanes,
                           Drop drop, cudaStream_t stream) {
  CUtensorMap ta, two, tw1, tw2, tu, ty;
  DEVT_TRY(blk_map(&ta, att, D, rows, D, kBlkRows));
  DEVT_TRY(blk_map(&two, wo, D, D, D, 64));
  DEVT_TRY(blk_map(&tw1, w1, F, D, F, D));
  DEVT_TRY(blk_map(&tw2, w2, D, F, D, 64));
  DEVT_TRY(blk_map(&tu, u, D, rows, D, 64));
  DEVT_TRY(blk_map(&ty, y, D, rows, D, 64));
  constexpr size_t bytes = out_ffn_smem<D>();
  DEVT_TRY(set_smem(out_ffn_sm90<D>, bytes));
  out_ffn_sm90<D><<<blk_tiles(rows), kBlkThreads, bytes, stream>>>(
      ta, two, tw1, tw2, tu, ty, x, bo, g2, b2, bb1, bb2, u32, res, rows, F,
      H, lanes, drop);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_ffn_dual(const bf16* u, const bf16* dy, const float* res,
                            const float* g2, const float* b2, const bf16* w1,
                            const float* bb1, const bf16* w2, bf16* b_out,
                            bf16* h_out, bf16* dz1_out, bf16* dz2_out,
                            float* part_bb1, float* part_bb2, int rows, int F,
                            int H, int lanes, Drop drop,
                            cudaStream_t stream) {
  CUtensorMap tu, tdy, tw1, tw2, th, tdz1;
  DEVT_TRY(blk_map(&tu, u, D, rows, D, kBlkRows));
  DEVT_TRY(blk_map(&tdy, dy, D, rows, D, kBlkRows));
  DEVT_TRY(blk_map(&tw1, w1, F, D, F, D));
  DEVT_TRY(blk_map(&tw2, w2, D, F, D, 64));
  DEVT_TRY(blk_map(&th, h_out, F, rows, F, 64));
  DEVT_TRY(blk_map(&tdz1, dz1_out, F, rows, F, 64));
  constexpr size_t bytes = ffn_dual_smem<D>();
  DEVT_TRY(set_smem(ffn_dual_sm90<D>, bytes));
  ffn_dual_sm90<D><<<blk_tiles(rows), kBlkThreads, bytes, stream>>>(
      tu, tdy, tw1, tw2, th, tdz1, res, g2, b2, bb1, b_out, dz2_out,
      part_bb1, part_bb2, rows, F, H, lanes, drop);
  return cudaGetLastError();
}

// ep's product: A (rows, K) @ W^T, W (D, K); K a multiple of 64
template <int D, int MODE>
cudaError_t launch_row_nk(const bf16* A, int K, const bf16* W,
                          const RowEpi& ep, int rows, cudaStream_t stream) {
  if (K % 64) return cudaErrorInvalidValue;
  CUtensorMap ta, tw;
  DEVT_TRY(blk_map(&ta, A, K, rows, K, kBlkRows));
  DEVT_TRY(blk_map(&tw, W, K, D, K, D));
  constexpr size_t bytes = row_nk_smem<D>();
  DEVT_TRY(set_smem(row_nk_sm90<D, MODE>, bytes));
  row_nk_sm90<D, MODE><<<blk_tiles(rows), kBlkThreads, bytes, stream>>>(
      ta, tw, K, ep, rows);
  return cudaGetLastError();
}

// one weight-gradient product: part[split] = A^T @ B over the split's rows
struct WgSpec {
  const bf16 *A, *B;  // (rows, M), (rows, N), rows contiguous
  int M, N;           // multiples of 64
  float* part;
};

// the column tile of a launch of products with these N: the widest of 192,
// 128 and 64 that divides every N
inline int wgrad_bn(const int* N, int n) {
  int bn = 192;
  for (int i = 0; i < n; ++i)
    if (N[i] % 192) bn = 128;
  for (int i = 0; i < n && bn == 128; ++i)
    if (N[i] % 128) bn = 64;
  return bn;
}

// rows of a split of the weight gradients (M[i] x N[i], i < n) over
// `rows`: the splits times the products' output tiles fill the card's SMs
// kWgWaves times (a multiple of 64 rows); 0 when the card cannot be asked
inline int wgrad_split_rows(int rows, const int* M, const int* N, int n) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  const int bn = wgrad_bn(N, n);
  int tiles = 0;
  for (int i = 0; i < n; ++i) tiles += blk_tiles(M[i]) * (N[i] / bn);
  const int splits = max(1, kWgWaves * sms / tiles);
  return round_up((rows + splits - 1) / splits, 64);
}

template <int BN>
cudaError_t launch_wgrad_bn(WgJobs& jb, cudaStream_t stream) {
  constexpr size_t bytes = wgrad_smem<BN>();
  DEVT_TRY(set_smem(wgrad_sm90<BN>, bytes));
  wgrad_sm90<BN><<<jb.start[jb.jobs], kBlkThreads, bytes, stream>>>(jb);
  return cudaGetLastError();
}

// the weight gradients of `n` products in one launch, in tiles of
// wgrad_bn's columns, splits of split_rows rows (wgrad_split_rows)
inline cudaError_t launch_wgrad(const WgSpec* specs, int n, int rows,
                                int split_rows, cudaStream_t stream) {
  if (n < 1 || n > kWgJobs || split_rows < 64 || split_rows % 64)
    return cudaErrorInvalidValue;
  int N[kWgJobs];
  for (int i = 0; i < n; ++i) {
    if (specs[i].M % 64 || specs[i].N % 64) return cudaErrorInvalidValue;
    N[i] = specs[i].N;
  }
  const int bn = wgrad_bn(N, n);
  const int splits = (rows + split_rows - 1) / split_rows;
  WgJobs jb{};
  jb.jobs = n;
  jb.rows = rows;
  jb.split_rows = split_rows;
  jb.start[0] = 0;
  for (int i = 0; i < n; ++i) {
    const WgSpec& s = specs[i];
    DEVT_TRY(blk_map(&jb.ta[i], s.A, s.M, rows, s.M, 64));
    DEVT_TRY(blk_map(&jb.tb[i], s.B, s.N, rows, s.N, 64));
    jb.part[i] = s.part;
    jb.M[i] = s.M;
    jb.N[i] = s.N;
    jb.start[i + 1] = jb.start[i] + blk_tiles(s.M) * (s.N / bn) * splits;
  }
  if (bn == 192) return launch_wgrad_bn<192>(jb, stream);
  if (bn == 128) return launch_wgrad_bn<128>(jb, stream);
  return launch_wgrad_bn<64>(jb, stream);
}

}  // namespace
