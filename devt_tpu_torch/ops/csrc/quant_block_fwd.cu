// Int8 fused pre-norm ViT block forward for Hopper (sm_90a), eval only:
// kernel 5 of the port.
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
// Returns y alone (no residual lanes: there is no backward).  The weight
// codes Wqkv_q and W1_q are K-major: (N, K) storage, k contiguous, as the
// site registry of ops/quant.py stores them (its callers see the (K, N)
// view with strides (1, K)), because the 8-bit wgmma reads B only K-major.
//
// Design.  Three launches, as the bf16 block (kernel 1), on the same
// parts: two row-tile kernels on block_sm90.cuh's CTA shape (two consumer
// warpgroups of 64 rows and a producer warpgroup whose one lane keeps TMA
// loads in flight through a ring of weight stages on full and empty
// mbarriers; setmaxnreg hands the producer's registers to the consumers),
// and between them the attention launch of kernels 1 and 7
// (block_attention.cuh: the one-shot wgmma body, normalising after P V,
// where one_shot_on_wgmma says, which is every main-path shape).
//
//   1. ln_qkv_q8_sm90<D>: TMA brings the tile's x (bf16, 128-byte swizzle).
//      A warp per row normalises its row in registers, takes the row's
//      amax, and writes the int8 codes in place of the row, in the
//      K-major 128-byte swizzle of 128-byte k blocks that the int8 wgmma
//      reads, and the row scale amax * (1/127) to shared memory.  The
//      qkv columns go in passes of kQkvBN = 192: the producer streams the
//      pass's weight codes as (128 k bytes, 192 rows) boxes, one k block a
//      stage; each warpgroup issues wgmma m64n192k32 .s32.s8.s8 over its
//      64 rows.  The epilogue takes f32(acc) * a_s, then * w_s, with no
//      fused multiply-add (the plain version's order, so the exact s32
//      sums dequantize to the same f32), rounds to bf16, and stores
//      through staged boxes by TMA.
//   2. the attention (block_attention.cuh).
//   3. out_ffn_q8_sm90<D>: u = x + (att @ Wo + bo) on bf16 wgmma m64nDk16
//      (Wo's boxes MN-major), as out_ffn_sm90; each thread keeps its u in
//      f32 in its own slots of shared memory (no f32 u scratch in device
//      memory), LN2 runs on the accumulators (a row is one quad's), its
//      codes go to the warpgroup's own rows of the att tile, K-major, and
//      the row scales to shared memory.  Then per kHidden = 64 hidden
//      columns one ring stage brings W1's code slice (K-major, one box a
//      k block) and W2's slice (MN-major boxes): z = codes @ W1_q on wgmma
//      m64n64k32 .s32.s8.s8, the dequantizing epilogue plus bb1 and
//      gelu_tanh rounded to bf16 A fragments in registers, and y += h @
//      W2 on bf16 wgmma m64nDk16 with A from registers.  At the end
//      y = u + (y + bb2), staged in the warpgroup's u slots and stored by
//      TMA.
//
// K = D int8 bytes is one and a half 128-byte k blocks at D = 192 and half
// of one at D = 64: only the k32 steps that hold codes are issued
// (q8_steps), so the bytes past D in a k block (TMA's zeros for the
// weights, stale x values for the codes) are never read.
//
// The float route (seven plain launches: LN and row codes, the int8
// product on gemm_s8_sm90.cuh's wgmma body with f32 output, the float
// attention, FMA products for Wo and W2, every intermediate in global
// memory) exists to hold the arithmetic against the plain version in f32
// and is on no serving path.
//
// Bound at the main-path shape (512, 208, 192, 3 heads, MLP 768,
// kv_len 197): 110.3 GOP per call, of which the qkv and W1 products
// (55.0 GOP) run at the int8 rate and the rest at the bf16 rate, against
// about 82 MB moved: operations bind it (0.084 ms on an H100 SXM).  The
// times are in PERF.md.

#include "block_attention.cuh"
#include "block_sm90.cuh"
#include "gemm_s8_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// int8 wgmma m64nNk32 with s32 accumulators, K-major int8 tiles
// ---------------------------------------------------------------------------

// bytes of a K-major int8 k block of kBlkRows rows: 128-byte rows
constexpr uint32_t kQ8Box = kBlkRows * 128;

// byte offset of code (r, k) of a K-major int8 tile of kBlkRows rows in the
// 128-byte swizzle (what TMA writes and s8_desc reads): k blocks of
// kBlkRows x 128 bytes, the 16-byte chunks of row r XORed with r % 8
__device__ __forceinline__ uint32_t q8_off(int r, int k) {
  return static_cast<uint32_t>((k >> 7) * kQ8Box + r * 128 +
                               ((((k & 127) >> 4) ^ (r & 7)) << 4) +
                               (k & 15));
}

// the k32 steps of k block kq of a K-deep product: 4, but in a last,
// partial block only those that hold codes (K = 192: 4 then 2; K = 64: 2)
__host__ __device__ constexpr int q8_steps(int K, int kq) {
  return K - 128 * kq >= 128 ? 4 : (K - 128 * kq) / 32;
}

// d[0, 32) = (acc ? d : 0) + A (64 x 32 s8, shared, K-major) B (32 x 64
// s8, shared, K-major), exact s32
__device__ __forceinline__ void q8_mma_n64(int* d, uint64_t a, uint64_t b,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d[0, 96) = (acc ? d : 0) + A (64 x 32 s8, shared, K-major) B (32 x 192
// s8, shared, K-major), exact s32
__device__ __forceinline__ void q8_mma_n192(int* d, uint64_t a, uint64_t b,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
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
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95])
      : "l"(a), "l"(b), "r"(acc));
}

// one width per instance: a runtime test between wgmmas makes ptxas
// serialise them (PERF.md, C7511)
template <int N>
__device__ __forceinline__ void q8_mma(int* d, uint64_t a, uint64_t b,
                                       int acc) {
  if constexpr (N == 64) {
    q8_mma_n64(d, a, b, acc);
  } else {
    static_assert(N == 192, "int8 wgmma widths of the block: 64, 192");
    q8_mma_n192(d, a, b, acc);
  }
}

template <int N>
__device__ __forceinline__ void q8_fence(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(d[i]);
}

// the STEPS k32 steps of one k block, one warpgroup: acc (= if kFirst,
// else +=) A (64 rows of codes at a, K-major, rows 128 bytes apart) B (N
// rows of weight codes at b, K-major); a k32 step is 32 bytes along the
// swizzled row (+2 in the descriptors' address field)
template <int N, int STEPS, bool kFirst>
__device__ __forceinline__ void q8_kblock(int* acc, const void* a,
                                          const void* b) {
  const uint64_t ad = s8_desc(a), bd = s8_desc(b);
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk)
    q8_mma<N>(acc, ad + 2 * kk, bd + 2 * kk, !kFirst || kk > 0);
}

// ===========================================================================
// 1. LN1, row codes, qkv on int8 wgmma
// ===========================================================================

template <int D>
__host__ __device__ constexpr size_t ln_qkv_q8_smem() {
  // x (its codes later in its place), the ring of weight-code k blocks,
  // a 64 x kQkvBN bf16 staging area a warpgroup
  return 1024 + static_cast<size_t>(D) * kBlkRows * 2 +
         kBlkStages * static_cast<size_t>(kQkvBN) * 128 +
         2 * static_cast<size_t>(64) * kQkvBN * 2;
}

// LN1 of row r of the x tile A (bf16, 128-byte swizzle) by one warp (lane
// l holds the column pairs 64 t + 2 l), in f32 with the plain version's
// roundings; the row's int8 codes in place of the row (K-major, q8_off)
// and its scale amax * (1/127) to rsc[r]
template <int D>
__device__ __forceinline__ void q8_ln_row(unsigned char* A, int r,
                                          const float* __restrict__ g,
                                          const float* __restrict__ b,
                                          float* rsc) {
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
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < 2 * KB; ++t) s += v[t];
  const float mu = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int t = 0; t < 2 * KB; ++t) q += (v[t] - mu) * (v[t] - mu);
  const float rstd = rsqrtf(warp_sum(q) / D + kLnEps);
  float amax = 0.f;
#pragma unroll
  for (int t = 0; t < KB; ++t) {
    const int c = 64 * t + 2 * lane;
    v[2 * t] = ln_value(v[2 * t], mu, rstd, g[c], b[c]);
    v[2 * t + 1] = ln_value(v[2 * t + 1], mu, rstd, g[c + 1], b[c + 1]);
    amax = fmaxf(amax, fmaxf(fabsf(v[2 * t]), fabsf(v[2 * t + 1])));
  }
  amax = warp_max(amax);
  const float inv = quant_inv(amax);
  // every code depends on the whole row (mu, rstd, amax): the row's x has
  // been read before any code overwrites it
#pragma unroll
  for (int t = 0; t < KB; ++t) {
    const int c = 64 * t + 2 * lane;
    const uint32_t q0 = quant_code(v[2 * t], inv) & 0xff;
    const uint32_t q1 = quant_code(v[2 * t + 1], inv) & 0xff;
    *reinterpret_cast<uint16_t*>(A + q8_off(r, c)) =
        static_cast<uint16_t>(q0 | (q1 << 8));
  }
  if (lane == 0) rsc[r] = __fmul_rn(amax, kInv127);
}

// The producer loads the tile's x by TMA and streams the Wqkv codes ((N,
// K) storage: boxes of 128 k bytes by kQkvBN rows), one k block a ring
// stage; the consumers quantize their rows in place and take qkv in
// passes of kQkvBN columns, staged and stored by TMA.
template <int D>
__global__ void __launch_bounds__(kBlkThreads, 1)
    ln_qkv_q8_sm90(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap tqkv,
                   const float* __restrict__ g1, const float* __restrict__ b1,
                   const float* __restrict__ ws) {
  constexpr int KB = D / 64, KQ = (D + 127) / 128, NC = 3 * D / kQkvBN;
  constexpr int S = kBlkStages;
  static_assert(D % 64 == 0 && (3 * D) % kQkvBN == 0 && KQ <= 2,
                "widths: D a multiple of 64, at most 256");
  constexpr uint32_t kStage = kQkvBN * 128, kXBytes = D * kBlkRows * 2;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S], abar;
  __shared__ float rsc[kBlkRows];  // the rows' scales
  unsigned char* As = blk_base(smem_raw);  // x, then its codes in place
  unsigned char* ring = As + kXBytes;
  unsigned char* out = ring + S * kStage;  // a kStage staging area a wg
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
    mbar_expect_tx(&abar, kXBytes);
    for (int kb = 0; kb < KB; ++kb)
      tma_load_2d(As + kb * kBlkRows * 128, &tx, &abar, 64 * kb, row0);
    int g = 0;
    for (int nc = 0; nc < NC; ++nc)
      for (int kq = 0; kq < KQ; ++kq, ++g) {
        const int st = ring_put<S>(full, empty, g, kStage);
        tma_load_2d(ring + st * kStage, &tw, &full[st], 128 * kq,
                    nc * kQkvBN);
      }
    return;
  }
  blk_consumer_regs();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq4 = lane & 3;
  unsigned char* stage = out + wg * kStage;
  // LN1 and codes of the warpgroup's rows, a warp per row, four rows at a
  // time so that their reductions' shuffle chains overlap; rows past the
  // end are TMA's zeros, normalised too (finite codes and scales, their
  // products not stored)
  mbar_wait(&abar, 0);
#pragma unroll 4
  for (int i = warp; i < 64; i += 4)
    q8_ln_row<D>(As, 64 * wg + i, g1, b1, rsc);
  blk_fence_smem();
  blk_bar(2 + wg, 128);  // the warpgroup's codes and scales written

  const unsigned char* a_codes = As + wg * 64 * 128;
  const int rt = 16 * warp + gq;  // the thread's first row of its 64
  const float rs[2] = {rsc[64 * wg + rt], rsc[64 * wg + rt + 8]};
  int g = 0;
#pragma unroll 1
  for (int nc = 0; nc < NC; ++nc) {
    int acc[kQkvBN / 2];
    int st = ring_get<S>(full, g);
    q8_fence<kQkvBN / 2>(acc);
    wgmma_fence();
    q8_kblock<kQkvBN, q8_steps(D, 0), true>(acc, a_codes,
                                            ring + st * kStage);
    wgmma_commit();
    ++g;
    if constexpr (KQ == 2) {
      st = ring_get<S>(full, g);
      q8_fence<kQkvBN / 2>(acc);
      wgmma_fence();
      q8_kblock<kQkvBN, q8_steps(D, 1), false>(acc, a_codes + kQ8Box,
                                               ring + st * kStage);
      wgmma_commit();
      wgmma_wait<1>();  // the first k block's group has completed
      q8_fence<kQkvBN / 2>(acc);
      ring_free<S>(empty, g - 1);
      ++g;
    }
    wgmma_wait<0>();
    q8_fence<kQkvBN / 2>(acc);
    ring_free<S>(empty, g - 1);

    // (f32(acc) * a_s) * w_s, rounded to bf16, staged and stored
    if (nc > 0) blk_stage_free();
#pragma unroll
    for (int j = 0; j < kQkvBN / 8; ++j) {
      const int c = 8 * j + 2 * tq4;
      const float2 w = *reinterpret_cast<const float2*>(ws + nc * kQkvBN + c);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        blk_stage_pair(
            stage, rt + 8 * hh, c,
            __fmul_rn(__fmul_rn(static_cast<float>(acc[4 * j + 2 * hh]),
                                rs[hh]),
                      w.x),
            __fmul_rn(__fmul_rn(static_cast<float>(acc[4 * j + 2 * hh + 1]),
                                rs[hh]),
                      w.y));
    }
    blk_store(&tqkv, stage, kQkvBN / 64, nc * kQkvBN, row0 + 64 * wg);
  }
  blk_store_drain();
}

// ===========================================================================
// 3. out-projection, residual, LN2, row codes, int8 W1, GELU, W2, residual
// ===========================================================================

// a ring stage: W1's code slice (kHidden rows, a box a 128-byte k block)
// and W2's slice (D / 64 boxes of kHidden rows); a Wo k block (D / 64
// boxes of 64 rows) fits in it as well
template <int D>
__host__ __device__ constexpr uint32_t out_ffn_q8_stage() {
  return ((D + 127) / 128) * kHidden * 128 + D * 128;
}

template <int D>
__host__ __device__ constexpr size_t out_ffn_q8_smem() {
  // att (LN2's codes later in its place), u in f32 (each thread's own
  // slots; a warpgroup's y staged in its part at the end), the ring
  return 1024 + static_cast<size_t>(D) * kBlkRows * 2 +
         static_cast<size_t>(D) * kBlkRows * 4 +
         kFfnStages * static_cast<size_t>(out_ffn_q8_stage<D>());
}

// A = att (TMA), then the codes of LN2(u) in the warpgroup's own rows of
// it; steps of the ring: D / 64 k blocks of Wo (MN-major boxes), then per
// kHidden hidden columns W1_q's slice (K-major) and W2's (MN-major).
template <int D>
__global__ void __launch_bounds__(kBlkThreads, 1)
    out_ffn_q8_sm90(const __grid_constant__ CUtensorMap tatt,
                    const __grid_constant__ CUtensorMap two,
                    const __grid_constant__ CUtensorMap tw1,
                    const __grid_constant__ CUtensorMap tw2,
                    const __grid_constant__ CUtensorMap ty,
                    const bf16* __restrict__ x, const float* __restrict__ bo,
                    const float* __restrict__ g2, const float* __restrict__ b2,
                    const float* __restrict__ w1s,
                    const float* __restrict__ bb1,
                    const float* __restrict__ bb2, int rows, int F) {
  constexpr int KB = D / 64, KQ = (D + 127) / 128, S = kFfnStages;
  static_assert(D % 64 == 0 && KQ <= 2, "widths: D a multiple of 64, <= 256");
  constexpr uint32_t kStage = out_ffn_q8_stage<D>();
  constexpr uint32_t kW1 = KQ * kHidden * 128;  // bytes of W1's code slice
  constexpr uint32_t kWo = D * 128;  // bytes of a Wo k block, of W2's slice
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S], abar;
  __shared__ float rsc[kBlkRows];  // the rows' scales of LN2's codes
  unsigned char* As = blk_base(smem_raw);
  float* Us = reinterpret_cast<float*>(As + D * kBlkRows * 2);
  unsigned char* ring = As + D * kBlkRows * 6;
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
      const int st = ring_put<S>(full, empty, g, kWo);
      for (int j = 0; j < KB; ++j)
        tma_load_2d(ring + st * kStage + j * kBlkBox, &two, &full[st], 64 * j,
                    64 * kb);
    }
    for (int c = 0; c < chunks; ++c, ++g) {
      const int st = ring_put<S>(full, empty, g, kStage);
      unsigned char* dst = ring + st * kStage;
      for (int kq = 0; kq < KQ; ++kq)
        tma_load_2d(dst + kq * kHidden * 128, &tw1, &full[st], 128 * kq,
                    kHidden * c);
      for (int j = 0; j < KB; ++j)
        tma_load_2d(dst + kW1 + j * kBlkBox, &tw2, &full[st], 64 * j,
                    kHidden * c);
    }
    return;
  }
  blk_consumer_regs();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq4 = lane & 3;
  const int rt = 64 * wg + 16 * warp + gq;  // the thread's first tile row
  const uint32_t a_addr = smem_addr(As) + wg * 64 * 128;
  // the thread's u: accumulator register i at ut[128 i]
  float* ut = Us + wg * (D * 64) + (threadIdx.x & 127);
  int g = 0;

  // u = x + (att @ Wo + bo)
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

  // u into the thread's slots and acc; LN2 over acc (a row is one quad's),
  // the row's amax, and its codes into the warpgroup's own rows of A (its
  // Wo products have completed).  Each loop takes a column pair's
  // parameters once for both of the thread's rows.
  const int gr[2] = {row0 + rt, row0 + rt + 8};
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * tq4;
    const float2 bias = *reinterpret_cast<const float2*>(bo + c);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = 4 * j + 2 * hh;
      float u0 = 0.f, u1 = 0.f;
      if (gr[hh] < rows) {
        const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
            x + static_cast<size_t>(gr[hh]) * D + c);
        u0 = __low2float(xv) + (acc[i] + bias.x);
        u1 = __high2float(xv) + (acc[i + 1] + bias.y);
      }
      acc[i] = u0;
      acc[i + 1] = u1;
      ut[128 * i] = u0;
      ut[128 * (i + 1)] = u1;
      s[hh] += u0 + u1;
    }
  }
  const float mu[2] = {quad_sum(s[0]) / D, quad_sum(s[1]) / D};
  float q[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float d0 = acc[4 * j + 2 * hh] - mu[hh];
      const float d1 = acc[4 * j + 2 * hh + 1] - mu[hh];
      q[hh] += d0 * d0 + d1 * d1;
    }
  const float rstd[2] = {rsqrtf(quad_sum(q[0]) / D + kLnEps),
                         rsqrtf(quad_sum(q[1]) / D + kLnEps)};
  float amax[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * tq4;
    const float2 g = *reinterpret_cast<const float2*>(g2 + c);
    const float2 b = *reinterpret_cast<const float2*>(b2 + c);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = 4 * j + 2 * hh;
      acc[i] = ln_value(acc[i], mu[hh], rstd[hh], g.x, b.x);
      acc[i + 1] = ln_value(acc[i + 1], mu[hh], rstd[hh], g.y, b.y);
      amax[hh] = fmaxf(amax[hh], fmaxf(fabsf(acc[i]), fabsf(acc[i + 1])));
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    amax[hh] = quad_max(amax[hh]);
    const float inv = quant_inv(amax[hh]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * tq4, i = 4 * j + 2 * hh;
      const uint32_t q0 = quant_code(acc[i], inv) & 0xff;
      const uint32_t q1 = quant_code(acc[i + 1], inv) & 0xff;
      *reinterpret_cast<uint16_t*>(As + q8_off(rt + 8 * hh, c)) =
          static_cast<uint16_t>(q0 | (q1 << 8));
    }
    if (tq4 == 0) rsc[rt + 8 * hh] = __fmul_rn(amax[hh], kInv127);
  }
  blk_fence_smem();
  blk_bar(2 + wg, 128);  // the warpgroup's codes and scales written

  // y = h @ W2, h = gelu((codes @ W1_q) * b_s * w1_s + bb1), kHidden
  // columns at a time
  const unsigned char* a_codes = As + wg * 64 * 128;
  const float rs[2] = {rsc[rt], rsc[rt + 8]};
  float yacc[D / 2];
#pragma unroll 1
  for (int c = 0; c < chunks; ++c, ++g) {
    const int st = ring_get<S>(full, g);
    const unsigned char* sp = ring + st * kStage;
    int z[kHidden / 2];
    q8_fence<kHidden / 2>(z);
    wgmma_fence();
    q8_kblock<kHidden, q8_steps(D, 0), true>(z, a_codes, sp);
    if constexpr (KQ == 2)
      q8_kblock<kHidden, q8_steps(D, 1), false>(z, a_codes + kQ8Box,
                                                sp + kHidden * 128);
    wgmma_commit();
    wgmma_wait<0>();
    q8_fence<kHidden / 2>(z);
    // h in bf16 straight into the A fragments, a column pair's scales
    // loaded once for both rows: fragment kk holds the accumulator blocks
    // j = 2 kk, 2 kk + 1 (hidden columns 16 kk ..), rows gq, gq + 8 each
    uint32_t hf[kHidden / 16][4];
#pragma unroll
    for (int kk = 0; kk < kHidden / 16; ++kk)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj, hc = kHidden * c + 8 * j + 2 * tq4;
        const float2 w = *reinterpret_cast<const float2*>(w1s + hc);
        const float2 bias = *reinterpret_cast<const float2*>(bb1 + hc);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * j + 2 * hh;
          hf[kk][2 * jj + hh] = pack_bf16(
              gelu_tanh(__fmul_rn(__fmul_rn(static_cast<float>(z[i]),
                                            rs[hh]),
                                  w.x) +
                        bias.x),
              gelu_tanh(__fmul_rn(__fmul_rn(static_cast<float>(z[i + 1]),
                                            rs[hh]),
                                  w.y) +
                        bias.y));
        }
      }
    blk_fence_regs<D / 2>(yacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHidden / 16; ++kk)
      blk_mma_rs<D, 1>(yacc, hf[kk],
                       blk_desc(smem_addr(sp + kW1) + 2048 * kk, kBlkBox),
                       c > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    blk_fence_regs<D / 2>(yacc);
    ring_free<S>(empty, g);
  }

  // y = u + (h @ W2 + bb2), u from the thread's own slots; then y staged
  // in the warpgroup's slots once all of them are read, and stored by TMA
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const float2 bias = *reinterpret_cast<const float2*>(bb2 + 8 * j +
                                                         2 * tq4);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = 4 * j + 2 * hh;
      yacc[i] = ut[128 * i] + (yacc[i] + bias.x);
      yacc[i + 1] = ut[128 * (i + 1)] + (yacc[i + 1] + bias.y);
    }
  }
  blk_bar(2 + wg, 128);
  unsigned char* stage = reinterpret_cast<unsigned char*>(Us + wg * (D * 64));
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      blk_stage_pair(stage, rt - 64 * wg + 8 * hh, 8 * j + 2 * tq4,
                     yacc[4 * j + 2 * hh], yacc[4 * j + 2 * hh + 1]);
  blk_store(&ty, stage, KB, 0, row0 + 64 * wg);
  blk_store_drain();
}

template <int D>
cudaError_t launch_ln_qkv_q8(const bf16* x, const float* g1, const float* b1,
                             const int8_t* wq, const float* ws, bf16* qkv,
                             int rows, cudaStream_t stream) {
  CUtensorMap tx, tw, tqkv;
  DEVT_TRY(blk_map(&tx, x, D, rows, D, kBlkRows));
  DEVT_TRY(s8_map(&tw, wq, D, 3 * D, kQkvBN));
  DEVT_TRY(blk_map(&tqkv, qkv, 3 * D, rows, 3 * D, 64));
  constexpr size_t bytes = ln_qkv_q8_smem<D>();
  DEVT_TRY(set_smem(ln_qkv_q8_sm90<D>, bytes));
  ln_qkv_q8_sm90<D><<<blk_tiles(rows), kBlkThreads, bytes, stream>>>(
      tx, tw, tqkv, g1, b1, ws);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_out_ffn_q8(const bf16* x, const bf16* att, const bf16* wo,
                              const float* bo, const float* g2,
                              const float* b2, const int8_t* w1q,
                              const float* w1s, const float* bb1,
                              const bf16* w2, const float* bb2, bf16* y,
                              int rows, int F, cudaStream_t stream) {
  CUtensorMap ta, two, tw1, tw2, ty;
  DEVT_TRY(blk_map(&ta, att, D, rows, D, kBlkRows));
  DEVT_TRY(blk_map(&two, wo, D, D, D, 64));
  DEVT_TRY(s8_map(&tw1, w1q, D, F, kHidden));
  DEVT_TRY(blk_map(&tw2, w2, D, F, D, 64));
  DEVT_TRY(blk_map(&ty, y, D, rows, D, 64));
  constexpr size_t bytes = out_ffn_q8_smem<D>();
  DEVT_TRY(set_smem(out_ffn_q8_sm90<D>, bytes));
  out_ffn_q8_sm90<D><<<blk_tiles(rows), kBlkThreads, bytes, stream>>>(
      ta, two, tw1, tw2, ty, x, bo, g2, b2, w1s, bb1, bb2, rows, F);
  return cudaGetLastError();
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
  const int rows = a.B * a.S;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  auto q = [](const void* p) { return static_cast<const int8_t*>(p); };
  bf16* qkv = static_cast<bf16*>(a.qkv);
  bf16* att = static_cast<bf16*>(a.att);

  DEVT_TRY(launch_ln_qkv_q8<D>(h(a.x), f(a.g1), f(a.b1), q(a.wqkv_q),
                               f(a.wqkv_s), qkv, rows, a.stream));
  // lse is (B, S, H) scratch: lanes = H
  DEVT_TRY(block_attention_bf16<HD>(qkv, att, static_cast<float*>(a.lse),
                                    a.B, a.S, a.H, a.kv_len, a.H, a.scale,
                                    a.stream));
  return launch_out_ffn_q8<D>(h(a.x), att, h(a.wo), f(a.bo), f(a.g2),
                              f(a.b2), q(a.w1_q), f(a.w1_s), f(a.bb1),
                              h(a.w2), f(a.bb2), static_cast<bf16*>(a.y),
                              rows, a.F, a.stream);
}

// the bfloat16 kernels are compiled for these widths (dim, head dim)
cudaError_t launch_bf16(const Args& a) {
  const int hd = a.D / a.H;
  if (a.F % kHidden) return cudaErrorInvalidValue;
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
  DEVT_TRY(launch_gemm_s8_wgmma<float>(codes, row_scale, q(a.wqkv_q),
                                       f(a.wqkv_s), qkv, rows, a.D, 3 * a.D,
                                       a.stream));
  DEVT_TRY(launch_attention_f32<false>(qkv, att, static_cast<float*>(a.lse),
                                       a.B, a.S, a.H, d, a.kv_len, a.H,
                                       a.scale, a.stream));
  DEVT_TRY(launch_rows_gemm<false>(att, nullptr, f(a.wo), f(a.bo), f(a.x), u,
                                   rows, a.D, a.D, a.stream));
  DEVT_TRY((launch_quant_rows<float, true>(u, f(a.g2), f(a.b2), codes,
                                           row_scale, rows, a.D, a.stream)));
  DEVT_TRY(launch_gemm_s8_wgmma<float>(codes, row_scale, q(a.w1_q),
                                       f(a.w1_s), z1, rows, a.D, a.F,
                                       a.stream));
  return launch_rows_gemm<true>(z1, f(a.bb1), f(a.w2), f(a.bb2), u,
                                static_cast<float*>(a.y), rows, a.F, a.D,
                                a.stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x, y, wo and w2).  wqkv_q and w1_q
// are the int8 weight codes stored K-major, (3D, D) and (F, D) with k
// contiguous and 16-byte aligned (TMA reads them), with their f32 column
// scales wqkv_s (3D) and w1_s (F); LN parameters and biases are f32.
// Scratch: qkv (B, S, 3D) and att (B, S, D) in x's type (bfloat16: 16-byte
// aligned) and lse (B, S, H) f32; the float route also needs u32 (B, S, D)
// f32, codes (B*S, D) int8, row_scale (B*S) f32 and z1 (B, S, F) f32,
// which the bfloat16 route ignores.  The bfloat16 route's attention launch
// takes the one-shot wgmma body where devt_quant_block_route says.
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

// 1 when kernel 5's attention launch of this dtype (0 float32, 1
// bfloat16), head dim and kv_len takes flash_fwd_sm90.cuh's one-shot body
extern "C" int devt_quant_block_route(int dtype, int d, int kv_len) {
  return one_shot_on_wgmma(dtype, d, kv_len) ? 1 : 0;
}

extern "C" const char* devt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
