// Fused int8 matmul for Hopper (sm_90a): x @ dequant(w_q) with the
// activations quantized per row on the way in.
//
// Computes what devt_tpu/ops/quant.py:_int8_matmul_kernel computes, for
// x (M, K) in bfloat16 or float, w_q (K, N) int8, w_scale (N) f32:
//
//   amax = max |x| per row;  inv = 127 / max(amax, 1e-8)
//   x_q  = round_half_even(x * inv)        (int8, no clip)
//   acc  = x_q @ w_q                        (s8 x s8 -> s32, exact)
//   out  = acc * (amax * (1/127)) * w_scale (f32, in that order), cast to
//          x's type
//
// Design.  The TPU kernel holds a 128-row tile of x whole in VMEM and
// quantizes it there, once per row tile, against all N columns.  Here
// enough blocks to fill 132 SMs means tiling N as well, and a block per
// (row tile, column tile) would quantize the same rows once per column
// tile; a 128-row tile of x at K = 2048 is 512 KB, more than shared memory
// holds.  So the wrapper's call is two launches: quant_rows (int8_common.cuh)
// reads x once and leaves the int8 codes (M x K bytes, which stay in L2 at
// the serving shapes) and the row scales; then the product, whose
// epilogue dequantizes the s32 accumulators in registers and writes x's
// type.  The product has two bodies, chosen by the layout of the weight
// codes (the rule int8_gemm_on_wgmma, mirrored by ops/quant.py
// int8_matmul_on_wgmma):
//
//   K-major codes, (N, K) storage (what the site registry stores): the
//     wgmma body of gemm_s8_sm90.cuh, TMA loads into a four-stage ring that
//     a producer warp keeps full, two consumer warpgroups on wgmma
//     m64n256k32 .s32.s8.s8, a persistent grid of one CTA an SM;
//   row-major (K, N) codes, JAX's layout: gemm_s8 (int8_common.cuh), a
//     tiled mma.sync m16n8k32 product over a three-stage cp.async ring.
//
// Bound at the serving shape (3584, 2048) x (2048, 6144): 90.2 GOP against
// about 71 MB moved, so operations bind it (0.046 ms at 1,979 TOP/s dense
// int8, NVIDIA H100 80GB HBM3 data sheet at 700 W); the times are in
// PERF.md.

#include "gemm_s8_sm90.cuh"

namespace {

template <typename T>
cudaError_t run(int kmajor, const void* x, const void* w_q,
                const void* w_scale, void* out, void* x_q, void* x_scale,
                int M, int K, int N, cudaStream_t stream) {
  if (M < 1 || K % 64 || N % 64) return cudaErrorInvalidValue;
  DEVT_TRY((launch_quant_rows<T, false>(
      static_cast<const T*>(x), nullptr, nullptr, static_cast<int8_t*>(x_q),
      static_cast<float*>(x_scale), M, K, stream)));
  const auto* codes = static_cast<const int8_t*>(x_q);
  const auto* rs = static_cast<const float*>(x_scale);
  const auto* w = static_cast<const int8_t*>(w_q);
  const auto* ws = static_cast<const float*>(w_scale);
  if (int8_gemm_on_wgmma(kmajor))
    return launch_gemm_s8_wgmma<T>(codes, rs, w, ws, static_cast<T*>(out), M,
                                   K, N, stream);
  return launch_gemm_s8<T>(codes, rs, w, ws, static_cast<T*>(out), M, K, N,
                           stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x and out).  kmajor: 1 when w_q
// holds the codes as (N, K), k contiguous (the wgmma body), 0 for (K, N),
// n contiguous (gemm_s8).  x_q (M, K) int8 and x_scale (M) f32 are
// scratch.  K a multiple of 64, N a multiple of 64; for kmajor, w_q
// 16-byte aligned.  Returns the CUDA error of the launches (0 on
// success); the launches are asynchronous on `stream`.
extern "C" int devt_int8_matmul(int dtype, int kmajor, const void* x,
                                const void* w_q, const void* w_scale,
                                void* out, void* x_q, void* x_scale, int M,
                                int K, int N, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(kmajor, x, w_q, w_scale, out, x_q, x_scale, M, K, N, s);
  if (dtype == 1)
    return run<bf16>(kmajor, x, w_q, w_scale, out, x_q, x_scale, M, K, N, s);
  return cudaErrorInvalidValue;
}

// 1 when the product of codes of this layout (1 K-major, 0 row-major)
// takes gemm_s8_sm90.cuh's body
extern "C" int devt_int8_matmul_route(int kmajor) {
  return int8_gemm_on_wgmma(kmajor) ? 1 : 0;
}

extern "C" const char* devt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
