// Packed-qkv multi-head attention backward for Hopper (sm_90a).
//
// Computes what devt_tpu/ops/flash_attention.py:_mha_bwd_kernel computes
// (the backward of fused_mha), from qkv (B, S, 3*H*d), the stored output o
// and its gradient do (B, S, H*d), all three in qkv's type, and lse
// (B, S, H) f32, per (sequence, head):
//
//   delta = rowsum(f32(do) * f32(o))          o as stored, after dropout
//   s     = q k^T * scale, key columns >= kv_len at -1e30
//   p     = exp(s - lse)
//   mask  = keep ? 1 / (1 - rate) : 0         (1 without dropout)
//   dv    = round(p * mask)^T @ do
//   dp    = (do @ v^T) * mask
//   ds    = p * (dp - delta) * scale
//   dq    = round(ds) @ k;   dk = round(ds)^T @ q
//
// where round() is the cast to the operand type and every product sums in
// f32.  dq, dk and dv go to dqkv (B, S, 3*H*d) in qkv's type, in the
// packed (3, H, d) column order.  Keys at or past kv_len have p = 0
// exactly, so their dk and dv are exact zeros.  The dropout mask is
// regenerated from the seed: Philox4x32-10 of (site kSiteAttn, flat index
// over (b, h, q, k)), as the forward draws it (attention_fwd.cuh), whatever
// either launch's grid.
//
// Three bodies, by the rule mha_bwd_route (mha_bwd_sm90.cuh; exported as
// devt_mha_bwd_route, mirrored by ops/flash_attention.py mha_bwd_on_wgmma),
// at every dropout rate:
//
//   packed     bf16, head dim 128 or 256, S <= 64 (PTN training):
//              mha_bwd_sm90.cuh's mha_bwd_packed, one launch, several whole
//              sequences of one head to a 64-row wgmma tile, each score
//              computed once, delta from the tile's o and do rows
//   wgmma      bf16, head dim 16, 32 or 64 (the blocks the fused kernels do
//              not take: MoE-ViViT at dropout, ViViT at dim 384): kernels
//              12's and 13's wgmma bodies (flash_bwd_sm90.cuh) with kBwdMha,
//              the dq launch (delta into the scratch) then the dk/dv launch
//   streamed   float, head dim 128 or 256 at S > 64, and head dims 224 and
//              448 (FrameTransformer's; 32-row blocks): attention_bwd.cuh's
//              body, which flash_bwd.cu (kernel 10 and the float and wide
//              kernels 12, 13) shares: FlashAttention-2's split, a launch
//              that writes delta (B, S, H) f32, then blocks that own up to
//              64 queries of a head (dq) or up to 64 keys (dk, dv) and
//              stream the other side's rows through shared memory, so every
//              S of a single kv block (512) fits; here on the packed layout
//              (q, k and v of head h at columns h*d, (H + h)*d and
//              (2H + h)*d of a qkv row, dqkv likewise)
//
// Each body has one owner per output, no atomics: two runs give the same
// bits.  The bound and the design of the wgmma bodies are in
// mha_bwd_sm90.cuh, the times in PERF.md.

#include "attention_bwd.cuh"
#include "mha_bwd_sm90.cuh"

namespace {

// the packed operands: qkv and dqkv (B, S, 3*H*d), o and do (B, S, H*d),
// lse and delta (B, S, H)
template <typename T>
BwdOperands<T> packed(const void* qkv, const void* dout, const void* lse,
                      void* delta, void* dqkv, int S, int H, int d) {
  const long long hd = static_cast<long long>(H) * d, n3 = 3 * hd;
  const Strides s3{S * n3, d, n3}, so{S * hd, d, hd},
      sl{static_cast<long long>(S) * H, 1, H};
  const T* x = static_cast<const T*>(qkv);
  T* dx = static_cast<T*>(dqkv);
  return {x,      x + hd, x + 2 * hd, static_cast<const T*>(dout),
          dx,     dx + hd, dx + 2 * hd, static_cast<const float*>(lse),
          static_cast<float*>(delta), s3, s3, s3, so, s3, s3, s3, sl,
          nullptr};
}

// the streamed bf16 body at head dim HD, both kinds of block in one launch
template <int HD>
cudaError_t streamed_bf16(const BwdOperands<bf16>& a, int B,
                          const BwdShape& sh, const Drop& drop,
                          cudaStream_t s) {
  return drop.on
             ? launch_bwd_bf16<HD, true, false>(a, B, sh, kBwdBoth, drop, s)
             : launch_bwd_bf16<HD, false, false>(a, B, sh, kBwdBoth, drop, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  qkv and dqkv (B, S, 3*H*d), o and do
// (B, S, H*d) in that type (bfloat16: 16-byte aligned, which the wgmma
// bodies' TMA maps need), lse (B, S, H) f32, delta (B, S, H) f32 scratch
// that the first launch fills (unused by the packed body, which may be
// given null); rate in [0, 1) and the forward's seed.  The bfloat16 kernels
// are compiled for head dims 16, 32, 64, 128, 224, 256 and 448, the float
// kernel takes any multiple of 4; the streamed body's shared memory holds up
// to 64 rows (224 and 448: 32; float: 32) of a head at a time, with their
// lse and delta.
// devt_mha_bwd_route names the body a shape takes.  Returns the CUDA error
// of the launches (0 on success, invalid value for a shape that is not
// covered); they are asynchronous on `stream`.
extern "C" int devt_mha_bwd(int dtype, const void* qkv, const void* o,
                            const void* dout, const void* lse, void* delta,
                            void* dqkv, int B, int S, int H, int d,
                            int kv_len, float scale, double rate,
                            unsigned long long seed, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1 || kv_len < 1 || kv_len > S || rate < 0.0 ||
      rate >= 1.0 || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  const Drop drop = make_drop(rate, seed);
  const BwdShape sh{S, S, H, kv_len, scale};
  const int pairs = B * S * H;
  if (dtype == 0) {
    if (d % 4 || mha_bwd_smem_f32(sh, d) > kSmemPerBlock)
      return cudaErrorInvalidValue;
    const BwdOperands<float> a =
        packed<float>(qkv, dout, lse, delta, dqkv, S, H, d);
    DEVT_TRY(launch_delta<float>(o, dout, a.delta, pairs, d, s));
    return drop.on ? launch_bwd_f32<true, false>(a, B, d, sh, kBwdBoth, drop,
                                                 s)
                   : launch_bwd_f32<false, false>(a, B, d, sh, kBwdBoth,
                                                  drop, s);
  }
  if (d != 16 && d != 32 && d != 64 && d != 128 && d != 224 && d != 256 &&
      d != 448)
    return cudaErrorInvalidValue;
  switch (mha_bwd_route(dtype, d, S, kv_len, drop.on)) {
    case kMhaBwdPacked:
      return launch_mha_bwd_packed(qkv, o, dout, static_cast<const float*>(lse),
                                   dqkv, B, S, H, d, kv_len, scale, drop, s);
    case kMhaBwdWgmma:
      return launch_mha_bwd_wgmma(qkv, o, dout, static_cast<const float*>(lse),
                                  static_cast<float*>(delta), dqkv, B, S, H, d,
                                  kv_len, scale, drop, s);
  }
  // the streamed body: head dim 128 or 256 past one 64-row tile, 224 and
  // 448 (FrameTransformer's) at every S
  const BwdOperands<bf16> a =
      packed<bf16>(qkv, dout, lse, delta, dqkv, S, H, d);
  DEVT_TRY(launch_delta<bf16>(o, dout, a.delta, pairs, d, s));
  switch (d) {
    case 128: return streamed_bf16<128>(a, B, sh, drop, s);
    case 224: return streamed_bf16<224>(a, B, sh, drop, s);
    case 256: return streamed_bf16<256>(a, B, sh, drop, s);
    case 448: return streamed_bf16<448>(a, B, sh, drop, s);
  }
  return cudaErrorInvalidValue;
}

// The body devt_mha_bwd runs for this dtype (0 float32, 1 bfloat16), head
// dim, sequence length, kv_len and dropout rate: 0 streamed
// (attention_bwd.cuh), 1 packed (mha_bwd_sm90.cuh), 2 kernels 12's and 13's
// wgmma bodies (flash_bwd_sm90.cuh, kBwdMha)
extern "C" int devt_mha_bwd_route(int dtype, int d, int S, int kv_len,
                                  double rate) {
  return mha_bwd_route(dtype, d, S, kv_len, rate > 0.0);
}

extern "C" const char* devt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
