// The int8 product of kernel 6 (int8_matmul.cu) on Hopper's int8 wgmma
// and TMA:
//
//   C (M, N) = f32(A (M, K) int8 @ W^T -> s32) * a_scale[m] * w_scale[n]
//
// A holds the activation codes quant_rows wrote, k contiguous; W holds the
// weight codes as (N, K), k contiguous, what the site registry of
// ops/quant.py stores (its callers see the (K, N) view with strides
// (1, K)).  For 8-bit types wgmma reads both operands from shared memory
// only K-major, and a TMA box of 128 k bytes in the 128-byte swizzle is
// exactly one swizzle row, so neither operand is transposed anywhere.  (The
// mma.sync body, gemm_s8 in int8_common.cuh, takes JAX's (K, N) layout,
// whose B fragments cost four 32-bit loads and a byte transpose each.)
//
// Bound on an NVIDIA H100 80GB HBM3 at 700 W at PTN's serving shape
// (3584, 2048) x (2048, 6144): 90.2 GOP at 1,979 TOP/s dense int8, 0.046
// ms, against 71 MB of device memory (0.021 ms): operations.  A 128 x 256
// tile reads 384 bytes of operands a k step for 65,536 products, so at the
// int8 peak the SMs would draw about 11.6 TB/s from L2, more than L2
// gives: the tile's own loads, not the tensor cores, set its pace.
//
// Design.  A CTA is two consumer warpgroups and a producer warp.  The
// producer's first lane walks the CTA's output tile (with kS8Persistent,
// tiles t, t + grid, ... of a grid of one CTA an SM: level with a CTA a
// tile at N = 2048 and 3 % slower at 6144, tools/wgmma_variants.py)
// and its k steps of 128 bytes, and keeps kS8Stages stages of a 128-row
// A box and a kS8BlockN-row W box in flight on full mbarriers; rows past M
// or N and k past K are zero-filled by TMA and add nothing.  Consumer
// warpgroup w multiplies rows 64 w .. 64 w + 63 of the tile by all its
// columns: per stage four wgmma m64nNk32 .s32.s8.s8 from the two
// descriptors, the group of stage i committed before stage i - 1's group
// is waited for, so the tensor cores always hold one stage's work, and
// each warp hands stage i - 1 back on its empty mbarrier.  The epilogue
// dequantizes the exact s32 sums in registers, f32(acc) * a_scale then *
// w_scale with no fused multiply-add (the plain version's order and
// roundings, so the two agree bit for bit), and stores x's type.

#pragma once

#include "int8_common.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kS8BlockM = 128;  // rows a tile: two warpgroups of 64
constexpr int kS8BlockN = 256;  // columns a tile: one wgmma's N (its most)
constexpr int kS8BlockK = 128;  // k bytes a stage: one 128-byte swizzle row
constexpr int kS8Stages = 4;
// a grid of one CTA an SM that walks the tiles, or (as built) a CTA a tile
constexpr bool kS8Persistent = false;
constexpr int kS8Threads = 2 * 128 + 32;  // and a producer warp

// the rule, written once: which fused int8 matmuls take this body (the
// weight codes K-major, (N, K) storage); the row-major (K, N) codes of the
// JAX layout take gemm_s8
__host__ __device__ constexpr bool int8_gemm_on_wgmma(int kmajor) {
  return kmajor != 0;
}

__host__ __device__ constexpr size_t s8_stage_bytes() {
  return static_cast<size_t>(kS8BlockM + kS8BlockN) * kS8BlockK;
}

// 1 KB of slack to align the dynamic base, then the stages (each a
// multiple of 1024 bytes, the 128-byte swizzle's period)
__host__ __device__ constexpr size_t s8_smem() {
  return 1024 + kS8Stages * s8_stage_bytes();
}

// descriptor of a K-major int8 tile whose rows are 128 bytes, 8-row groups
// 1024 bytes apart, in the 128-byte swizzle; a k32 step is 32 bytes along
// the row (+2 in the address field)
__device__ __forceinline__ uint64_t s8_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (uint64_t{1} << 16) | (uint64_t{1024 >> 4} << 32) |
         (uint64_t{1} << 62);
}

// d[0, 128) = (acc ? d : 0) + A (64 x 32 s8, shared, K-major) B (32 x 256
// s8, shared, K-major), exact s32
__device__ __forceinline__ void wgmma_s8_n256(int* d, uint64_t a, uint64_t b,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
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
      "}, %128, %129, p;\n}\n"
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
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

template <typename Out>
__global__ void __launch_bounds__(kS8Threads, 1)
    gemm_s8_wgmma(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tw,
                  const float* __restrict__ a_scale,
                  const float* __restrict__ w_scale, Out* __restrict__ C,
                  int M, int K, int N) {
  constexpr int BN = kS8BlockN, S = kS8Stages;
  static_assert(BN == 256, "one wgmma_s8_n256 a k32 step");
  constexpr uint32_t kABytes = kS8BlockM * kS8BlockK;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int mt = (M + kS8BlockM - 1) / kS8BlockM;
  const int tiles = mt * ((N + BN - 1) / BN);
  const int nk = (K + kS8BlockK - 1) / kS8BlockK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // one arrival from each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // the producer: one lane issues every load, running ahead across tiles
    if (threadIdx.x != 256) return;
    int g = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % mt) * kS8BlockM, n0 = (t / mt) * BN;
      for (int kb = 0; kb < nk; ++kb, ++g) {
        const int st = g % S;
        mbar_wait(&empty[st], ((g / S) & 1) ^ 1);
        unsigned char* As = base + st * s8_stage_bytes();
        mbar_expect_tx(&full[st], static_cast<uint32_t>(s8_stage_bytes()));
        tma_load_2d(As, &ta, &full[st], kb * kS8BlockK, m0);
        tma_load_2d(As + kABytes, &tw, &full[st], kb * kS8BlockK, n0);
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq4 = lane & 3;
  int g = 0;
#pragma unroll 1
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t % mt) * kS8BlockM, n0 = (t / mt) * BN;
    // register 4 j + e: row gq + 8 (e / 2) of the warp's 16, column
    // 8 j + 2 tq4 + e % 2 of the tile
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
#pragma unroll 1
    for (int kb = 0; kb < nk; ++kb, ++g) {
      const int st = g % S;
      mbar_wait(&full[st], (g / S) & 1);
      const unsigned char* As = base + st * s8_stage_bytes();
      const uint64_t ad = s8_desc(As + wg * 64 * kS8BlockK);
      const uint64_t bd = s8_desc(As + kABytes);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kS8BlockK / 32; ++kk)
        wgmma_s8_n256(acc, ad + 2 * kk, bd + 2 * kk, kb | kk);
      wgmma_commit();
      wgmma_wait<1>();  // the group of the stage before has completed
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
      if (kb > 0 && lane == 0) mbar_arrive(&empty[(g - 1) % S]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
    if (lane == 0) mbar_arrive(&empty[(g - 1) % S]);

    // out = (f32(acc) * a_scale) * w_scale, rows < M (N is a multiple of
    // 64, so a column pair is wholly inside or outside)
    const int r0 = m0 + wg * 64 + 16 * warp + gq;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
      if (r >= M) continue;
      const float rs = a_scale[r];
      Out* dst = C + static_cast<size_t>(r) * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * tq4;
        if (col >= N) continue;
        const float2 ws = *reinterpret_cast<const float2*>(w_scale + col);
        store2(dst + col,
               __fmul_rn(__fmul_rn(static_cast<float>(acc[4 * j + 2 * hh]),
                                   rs),
                         ws.x),
               __fmul_rn(
                   __fmul_rn(static_cast<float>(acc[4 * j + 2 * hh + 1]), rs),
                   ws.y));
      }
    }
  }
}

// rows of 128-byte k boxes of int8 codes (rows, K), k contiguous (K a
// multiple of 16), as a 2-d map with boxes of (128, box_rows) in the
// 128-byte swizzle; rows past `rows` and k past K read as zeros
inline cudaError_t s8_map(CUtensorMap* map, const void* base, int K, int rows,
                          int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {kS8BlockK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// C (M, N) in Out from the codes A (M, K) and W (N, K), both k contiguous
// and 16-byte aligned; K and N multiples of 64
template <typename Out>
cudaError_t launch_gemm_s8_wgmma(const int8_t* A, const float* a_scale,
                                 const int8_t* W, const float* w_scale,
                                 Out* C, int M, int K, int N,
                                 cudaStream_t stream) {
  if (M < 1 || K % 64 || N % 64) return cudaErrorInvalidValue;
  CUtensorMap ta, tw;
  DEVT_TRY(s8_map(&ta, A, K, M, kS8BlockM));
  DEVT_TRY(s8_map(&tw, W, K, N, kS8BlockN));
  const int tiles =
      ((M + kS8BlockM - 1) / kS8BlockM) * ((N + kS8BlockN - 1) / kS8BlockN);
  int grid = tiles;
  if (kS8Persistent) {
    int dev = 0, sms = 0;
    DEVT_TRY(cudaGetDevice(&dev));
    DEVT_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    grid = tiles < sms ? tiles : sms;
  }
  constexpr size_t bytes = s8_smem();
  DEVT_TRY(set_smem(gemm_s8_wgmma<Out>, bytes));
  gemm_s8_wgmma<Out><<<grid, kS8Threads, bytes, stream>>>(
      ta, tw, a_scale, w_scale, C, M, K, N);
  return cudaGetLastError();
}

}  // namespace
