// Attention forward on split q, k and v for Hopper (sm_90a): kernels 9 and
// 11 of the port, behind flash_attention (ops/flash_attention.py).
//
// q (B, H, Sq, d), k and v (B, H, Skv, d), each given by its element
// strides over (sequence, head, row) with the d elements of a row
// contiguous, so the transposed head views that packed_mha and the int8
// block cut from a packed qkv need no copy.  Per (sequence, head):
// s = q k^T * scale in f32, keys at or past kv_len at -1e30;
// o (B, H, Sq, d) contiguous in q's type; lse = max s + log sum exp(s - max)
// (B*H, Sq) f32.
//
//   online = 0   kernel 9, devt_tpu/ops/flash_attention.py:390
//                _fwd_single_kernel (Sq == Skv <= 512): the exact row max
//                and l first, then o = round(p / l) @ v
//   online = 1   kernel 11, flash_attention.py:69 _fwd_kernel (longer or
//                unequal sequences): one pass with the online softmax
//
// Two bodies, each chosen by a rule written once in C and mirrored in
// ops/flash_attention.py.  Kernel 9 in bfloat16 at head dim 16, 32 or 64
// with at most 256 live keys (one_shot_on_wgmma: every main-path shape)
// runs flash_fwd_sm90.cuh's one-shot body: a CTA per two query tiles of a
// head, q, k and v loaded by TMA, the whole score row of 64 queries in
// wgmma accumulators, one exponential per score, P V on wgmma from
// registers.  Kernel 11 in bfloat16 at head dim 16, 32 or 64
// (online_on_wgmma: every main-path shape) runs the same header's online
// body: a CTA of one consumer warpgroup of 64 queries and a producer warp
// that brings K and V in 128-key tiles through a TMA ring, S = Q K^T and
// P V on wgmma, one rescale per 128 keys as the TPU kernel's, three CTAs
// an SM.  Every other shape
// and the float route run flash_fwd.cuh's streamed body (a block per 64
// queries, K and V streamed in 64-key tiles through a double-buffered
// cp.async ring, mma.sync bf16 products), so every length takes every head
// dim; the ring hop (ring_step.cu, kernel 14) shares the one-shot bodies.
//
// Bound at the main-path shapes (bf16) on an NVIDIA H100 80GB HBM3 at
// 700 W (data sheet: 3.35 TB/s, 989 TFLOP/s): kernel 9 at (1536, 197, 64),
// kv_len 197 (the int8 ViViT at token_pad=0): 4 products' worth of
// 2 * 197 * 197 * 64 per row pair = 15.3 GFLOP against 155 MB of q, k, v
// and o, so bytes bind it (0.046 ms at 3.35 TB/s); kernel 11 at
// (1536, 592, 64), kv_len 577 (ViViT at image 384): 134 GFLOP against
// 466 MB, bytes (0.139 ms) just above operations (0.136 ms).  Kernel 11
// also takes one exponential per score, 1536 x 592 x 640 ex2 at 16 a clock
// per SM: 0.14 to 0.16 ms at 1.98 to 1.75 GHz, level with both.  The
// times are in PERF.md.

#include "flash_fwd_sm90.cuh"

// dtype: 0 = float32, 1 = bfloat16; online: 0 for kernel 9 (Sq == Skv),
// 1 for kernel 11.  q (B, H, Sq, d), k and v (B, H, Skv, d) by strides:
// strides[0..2] q's (sequence, head, row) in elements, [3..5] k's, [6..8]
// v's; the rows contiguous and, in bfloat16, 16-byte aligned (the
// pointers, and the strides multiples of 8).  o (B, H, Sq, d) in that type
// and lse (B*H, Sq) f32, both contiguous.  The bfloat16 kernels are
// compiled for head dims 16, 32, 64, 128 and 256, the float kernels take
// any multiple of 4 up to about 400; kernel 9's bfloat16 shapes inside
// one_shot_on_wgmma and kernel 11's inside online_on_wgmma take the wgmma
// bodies, which first encode TMA maps of q, k and v on the host.  Returns
// the CUDA error of the launch (0 on success, invalid value for a shape
// that is not covered); the launch is asynchronous on `stream`.
extern "C" int devt_flash_fwd(int dtype, int online, const void* q,
                              const void* k, const void* v, void* o,
                              void* lse, int B, int H, int Sq, int Skv,
                              int d, int kv_len, const long long* strides,
                              float scale, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1 || kv_len < 1 || kv_len > Skv ||
      (!online && Sq != Skv))
    return cudaErrorInvalidValue;
  FlashFwd a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = static_cast<float*>(lse);
  const long long hs = static_cast<long long>(Sq) * d;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = i == 0 ? H * hs : i == 1 ? hs : d;          // contiguous
    a.ls[i] = i == 0 ? static_cast<long long>(H) * Sq : i == 1 ? Sq : 1;
  }
  a.H = H;
  a.Sq = Sq;
  a.Skv = Skv;
  a.kv_len = kv_len;
  a.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!online && one_shot_on_wgmma(dtype, d, kv_len))
    return launch_one_shot<false>(a, B, d, s);
  if (online && online_on_wgmma(dtype, d)) return launch_online(a, B, d, s);
  return online ? launch_flash<true, false>(dtype, a, B * H, d, s)
                : launch_flash<false, false>(dtype, a, B * H, d, s);
}

// 1 when a one-shot forward (kernel 9 or 14) of this dtype (0 float32,
// 1 bfloat16), head dim and live key count takes flash_fwd_sm90.cuh's body
extern "C" int devt_one_shot_route(int dtype, int d, int keys) {
  return one_shot_on_wgmma(dtype, d, keys) ? 1 : 0;
}

// 1 when an online forward (kernel 11) of this dtype and head dim takes
// flash_fwd_sm90.cuh's body
extern "C" int devt_online_route(int dtype, int d) {
  return online_on_wgmma(dtype, d) ? 1 : 0;
}

extern "C" const char* devt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
