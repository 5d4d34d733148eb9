// Packed-qkv multi-head attention forward for Hopper (sm_90a).
//
// Computes what devt_tpu/ops/flash_attention.py:_mha_fwd_kernel computes
// (fused_mha, without dropout), for qkv (B, S, 3*H*d) in bfloat16 or
// float with columns ordered (3, H, d), per head:
//
//   s   = q k^T * scale (f32), key columns >= kv_len at -1e30
//   m   = max s;  p = exp(s - m);  l = sum p
//   o   = round(p / l) @ v        (p normalised, then cast to v's type)
//   lse = m + log l
//
// o is (B, S, H*d) in qkv's type, lse (B, S, H) f32 (the TPU kernel
// broadcasts lse over 128 lanes, a layout of that chip; here it is one
// value per row and head).
//
// The attention body is attention_fwd.cuh's, shared with the fused ViT
// block, instantiated with p normalised before the product and for head
// dims 16, 32, 64, 128 and 256.  A block takes 64 queries of one (sequence,
// head); S is any length whose K and V (kv_len rounded up to 32 rows) fit
// a block's shared memory: 512 keys and more at head dim 64, 160 at 256.
//
// Bound: at the PTN serving shape (256, 16, 6144), H = 8, d = 256,
// kv_len 14, about 0.5 GFLOP against 67 MB moved, so bytes bind it
// (0.020 ms at 3.35 TB/s); at the ViT shape (512, 208, 576), H = 3,
// d = 64, kv_len 197, about 16 GFLOP against 165 MB, bytes again
// (0.049 ms).  The times are in PERF.md.

#include "attention_fwd.cuh"

namespace {

template <int HD>
cudaError_t run_bf16(const void* qkv, void* o, void* lse, int B, int S, int H,
                     int kv_len, float scale, cudaStream_t stream) {
  return launch_attention_bf16<HD, true>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(o),
      static_cast<float*>(lse), B, S, H, kv_len, H, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The bfloat16 kernel is compiled for
// head dims 16, 32, 64, 128 and 256; the float kernel takes any multiple of 4.
// Returns the CUDA error of the launch (0 on success, invalid value for a
// shape that is not covered); the launch is asynchronous on `stream`.
extern "C" int devt_mha_fwd(int dtype, const void* qkv, void* o, void* lse,
                            int B, int S, int H, int d, int kv_len,
                            float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1 || kv_len < 1 || kv_len > S)
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (d % 4) return cudaErrorInvalidValue;
    return launch_attention_f32<true>(
        static_cast<const float*>(qkv), static_cast<float*>(o),
        static_cast<float*>(lse), B, S, H, d, kv_len, H, scale, s);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  switch (d) {
    case 16: return run_bf16<16>(qkv, o, lse, B, S, H, kv_len, scale, s);
    case 32: return run_bf16<32>(qkv, o, lse, B, S, H, kv_len, scale, s);
    case 64: return run_bf16<64>(qkv, o, lse, B, S, H, kv_len, scale, s);
    case 128: return run_bf16<128>(qkv, o, lse, B, S, H, kv_len, scale, s);
    case 256: return run_bf16<256>(qkv, o, lse, B, S, H, kv_len, scale, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* devt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
