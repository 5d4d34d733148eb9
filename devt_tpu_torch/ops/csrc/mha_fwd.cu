// Packed-qkv multi-head attention forward for Hopper (sm_90a).
//
// Computes what devt_tpu/ops/flash_attention.py:_mha_fwd_kernel computes
// (fused_mha), for qkv (B, S, 3*H*d) in bfloat16 or float with columns
// ordered (3, H, d), per head:
//
//   s   = q k^T * scale (f32), key columns >= kv_len at -1e30
//   m   = max s;  p = exp(s - m);  l = sum p
//   pn  = p / l, then with dropout kept * 1 / (1 - rate) or 0
//   o   = round(pn) @ v        (p normalised, then cast to v's type)
//   lse = m + log l            (before the mask)
//
// o is (B, S, H*d) in qkv's type, lse (B, S, H) f32 (the TPU kernel
// broadcasts lse over 128 lanes, a layout of that chip; here it is one
// value per row and head).
//
// Three bodies, by the rule mha_fwd_route (mha_fwd_sm90.cuh; exported as
// devt_mha_fwd_route, mirrored by ops/flash_attention.py mha_fwd_on_wgmma):
//
//   packed     bf16 at rate 0, head dim 128 or 256, S <= 64:
//              mha_fwd_sm90.cuh's persistent wgmma/TMA body, 64 / S whole
//              sequences of one head to a 64-row tile (PTN's shapes)
//   one-shot   bf16 at rate 0, head dim 16, 32 or 64, kv_len <= 256:
//              kernel 9's one-shot instance (flash_fwd_sm90.cuh), on the
//              head views of qkv by strides, lse out through (B, S, H)
//              strides; it rounds p * (1 / l), kernel 9's form, within the
//              forward gate of the division
//   streamed   the rest (dropout, float, head dim 128 or 256 at S > 64,
//              head dims 224 and 448 at every S): in bfloat16
//              attention_fwd.cuh's attention_bf16_tiled, a block per 64
//              queries of one (sequence, head), K and V streamed in 32-key
//              tiles and the row statistics from an online pass, so its
//              shared memory does not depend on S (every S, at every head
//              dim); in float attention_fwd.cuh's f32 body.  Their dropout
//              mask is Philox4x32-10 of (seed; site kSiteAttn, flat index
//              over (b, h, q, k)), which devt_mha_dropout_masks also writes
//              out for the tests.
//
// Bound: at the PTN serving shape (256, 14, 6144), H = 8, d = 256,
// kv_len 14 (the path runs S = 14 unpadded; the TPU wrapper pads to 16),
// about 0.4 GFLOP against 59 MB moved, so bytes bind it (0.0176 ms at
// 3.35 TB/s); at the ViT shape (512, 208, 576), H = 3, d = 64, kv_len 197,
// about 16 GFLOP against 165 MB, bytes again (0.049 ms).  The dropout costs
// 10 Philox rounds per probability and output column chunk, integer work
// that adds no bytes.  The times are in PERF.md.

#include "attention_fwd.cuh"
#include "mha_fwd_sm90.cuh"

namespace {

// the streamed bfloat16 body: attention_fwd.cuh's, K and V streamed in key
// tiles, which takes every S
template <int HD>
cudaError_t run_bf16(const void* qkv, void* o, void* lse, int B, int S, int H,
                     int kv_len, float scale, const Drop& drop,
                     cudaStream_t stream) {
  const bf16* x = static_cast<const bf16*>(qkv);
  bf16* out = static_cast<bf16*>(o);
  float* l = static_cast<float*>(lse);
  if (drop.on)
    return launch_attention_bf16_tiled<HD, true>(x, out, l, B, S, H, kv_len,
                                                 scale, stream, drop);
  return launch_attention_bf16_tiled<HD>(x, out, l, B, S, H, kv_len, scale,
                                         stream);
}

__global__ void mha_masks_kernel(uint8_t* __restrict__ keep, int H, int S,
                                 size_t n, Drop drop) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(i % S);
    const int q = static_cast<int>(i / S % S);
    const size_t bh = i / (static_cast<size_t>(S) * S);
    keep[i] = attn_keep(drop, static_cast<int>(bh / H),
                        static_cast<int>(bh % H), H, S, q, k);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The bfloat16 kernel is compiled for
// head dims 16, 32, 64, 128, 224, 256 and 448, its streamed body at every
// S; the float kernel takes any multiple of 4.
// rate in [0, 1): 0 is no dropout, and the seed is then unused.  qkv is
// contiguous (bfloat16: 16-byte aligned, which the wgmma routes' TMA maps
// need).  devt_mha_fwd_route names the body a shape takes.  Returns the
// CUDA error of the launch (0 on success, invalid value for a shape that is
// not covered); the launch is asynchronous on `stream`.
extern "C" int devt_mha_fwd(int dtype, const void* qkv, void* o, void* lse,
                            int B, int S, int H, int d, int kv_len,
                            float scale, double rate, unsigned long long seed,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1 || kv_len < 1 || kv_len > S || rate < 0.0 ||
      rate >= 1.0)
    return cudaErrorInvalidValue;
  const Drop drop = make_drop(rate, seed);
  if (dtype == 0) {
    if (d % 4) return cudaErrorInvalidValue;
    const float* x = static_cast<const float*>(qkv);
    float* out = static_cast<float*>(o);
    float* l = static_cast<float*>(lse);
    if (drop.on)
      return launch_attention_f32<true, true>(x, out, l, B, S, H, d, kv_len,
                                              H, scale, s, drop);
    return launch_attention_f32<true>(x, out, l, B, S, H, d, kv_len, H, scale,
                                      s);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  switch (mha_fwd_route(dtype, d, S, kv_len, drop.on)) {
    case kMhaPacked:
      return launch_mha_packed(qkv, o, static_cast<float*>(lse), B, S, H, d,
                               kv_len, scale, s);
    case kMhaOneShot:  // kernel 9's wgmma instance on the heads of qkv
      return launch_one_shot<false>(
          packed_qkv_heads(static_cast<const bf16*>(qkv), o,
                           static_cast<float*>(lse), S, H, d, kv_len, H,
                           scale),
          B, d, s);
  }
  switch (d) {
    case 16: return run_bf16<16>(qkv, o, lse, B, S, H, kv_len, scale, drop, s);
    case 32: return run_bf16<32>(qkv, o, lse, B, S, H, kv_len, scale, drop, s);
    case 64: return run_bf16<64>(qkv, o, lse, B, S, H, kv_len, scale, drop, s);
    case 128:
      return run_bf16<128>(qkv, o, lse, B, S, H, kv_len, scale, drop, s);
    case 224:  // FrameTransformer's scene transformer (4 heads of 224)
      return run_bf16<224>(qkv, o, lse, B, S, H, kv_len, scale, drop, s);
    case 256:
      return run_bf16<256>(qkv, o, lse, B, S, H, kv_len, scale, drop, s);
    case 448:  // FrameTransformer's distil transformer (2 heads of 448)
      return run_bf16<448>(qkv, o, lse, B, S, H, kv_len, scale, drop, s);
  }
  return cudaErrorInvalidValue;
}

// The body devt_mha_fwd runs for this dtype (0 float32, 1 bfloat16), head
// dim, sequence length, kv_len and dropout rate: 0 streamed
// (attention_fwd.cuh), 1 packed (mha_fwd_sm90.cuh), 2 one-shot
// (flash_fwd_sm90.cuh, kernel 9's instance)
extern "C" int devt_mha_fwd_route(int dtype, int d, int S, int kv_len,
                                  double rate) {
  return mha_fwd_route(dtype, d, S, kv_len, rate > 0.0);
}

// The keep mask (B, H, S, S) as uint8 that devt_mha_fwd and devt_mha_bwd
// apply for this seed and rate, so that a test can hand it to the plain
// versions.
extern "C" int devt_mha_dropout_masks(void* keep, int B, int H, int S,
                                      double rate, unsigned long long seed,
                                      void* stream) {
  if (B < 1 || H < 1 || S < 1 || rate <= 0.0 || rate >= 1.0)
    return cudaErrorInvalidValue;
  const size_t n = static_cast<size_t>(B) * H * S * S;
  mha_masks_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(keep), H, S, n, make_drop(rate, seed));
  return cudaGetLastError();
}

extern "C" const char* devt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
