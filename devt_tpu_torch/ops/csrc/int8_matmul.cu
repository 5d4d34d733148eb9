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
// tile.  So the wrapper's call is two launches: quant_rows reads x once
// and leaves the int8 codes (M x K bytes, which stay in L2 at the serving
// shapes) and the row scales; gemm_s8 is a tiled mma.sync m16n8k32
// product over a three-stage cp.async ring whose epilogue dequantizes the
// s32 accumulators in registers and writes x's type.  Both are in
// int8_common.cuh.
//
// Bound at the serving shape (3584, 2048) x (2048, 6144): 90.2 GOP against
// about 71 MB moved, so operations bind it (0.046 ms at 1,979 TOP/s dense
// int8).  mma.sync reaches a fraction of that rate; the times are in
// PERF.md.

#include "int8_common.cuh"

namespace {

template <typename T>
cudaError_t run(const void* x, const void* w_q, const void* w_scale, void* out,
                void* x_q, void* x_scale, int M, int K, int N,
                cudaStream_t stream) {
  DEVT_TRY((launch_quant_rows<T, false>(
      static_cast<const T*>(x), nullptr, nullptr, static_cast<int8_t*>(x_q),
      static_cast<float*>(x_scale), M, K, stream)));
  return launch_gemm_s8<T>(static_cast<const int8_t*>(x_q),
                           static_cast<const float*>(x_scale),
                           static_cast<const int8_t*>(w_q),
                           static_cast<const float*>(w_scale),
                           static_cast<T*>(out), M, K, N, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x and out).  x_q (M, K) int8 and
// x_scale (M) f32 are scratch.  K a multiple of 64, N a multiple of 64.
// Returns the CUDA error of the launches (0 on success); the launches are
// asynchronous on `stream`.
extern "C" int devt_int8_matmul(int dtype, const void* x, const void* w_q,
                                const void* w_scale, void* out, void* x_q,
                                void* x_scale, int M, int K, int N,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(x, w_q, w_scale, out, x_q, x_scale, M, K, N, s);
  if (dtype == 1) return run<bf16>(x, w_q, w_scale, out, x_q, x_scale, M, K, N, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* devt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
