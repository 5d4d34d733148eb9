// One hop of ring attention for Hopper (sm_90a): kernels 14 and 15 of the
// port, behind ring_step_fwd / ring_step_bwd (ops/flash_attention.py) and
// parallel/ring_attention.py.
//
// q (B, S, H*d) holds the local queries, kv (B, S, 2*H*d) the packed kv
// shard held now (head i's k at columns i*d, its v at (H + i)*d), mask (S)
// an additive f32 column bias: 0 for a key of the global sequence, -1e30
// for tile padding or global padding.  All contiguous.
//
//   forward  kernel 14, devt_tpu/ops/flash_attention.py:792
//            _ring_fwd_kernel: s = q k^T * scale + mask, the exact row
//            max, o = round(p / l) @ v in q's type (B, S, H*d) and
//            lse = m + log l f32 (B, S, H).  A shard whose columns are all
//            masked gives m = -1e30, p = 1, l = S, a finite o and
//            lse = -1e30 + log S, as the TPU kernel does, so the across-hop
//            combine gives it weight 0 and no NaN.
//   backward kernel 15, flash_attention.py:814 _ring_bwd_kernel: with the
//            GLOBAL lse (B, S, H) of the whole ring, o and do (B, S, H*d),
//            delta = rowsum(do * o) and p = exp(s - lse), the five
//            products of the flash backward; f32 partials dq (B, S, H*d)
//            and dkv (B, S, 2*H*d), which sum across hops.
//
// The TPU kernels hold G sequences' whole (S, S) score blocks in VMEM and
// write lse broadcast over 128 lanes; here lse is one value per (row,
// head).  The bodies are shared.  The forward in bfloat16 at head dim 16,
// 32 or 64 with S <= 256 (one_shot_on_wgmma: the bench shape and the
// hop-by-hop ring's shards) is kernel 9's wgmma body (flash_fwd_sm90.cuh:
// a CTA per two query tiles of a head, q and the shard's k and v loaded by TMA
// through maps over the packed layout, the whole score row in registers,
// the mask staged in shared memory and added to each score); other shapes
// and float take flash_fwd.cuh's streamed one-shot body.  The backward is
// kernel 4's (attention_bwd.cuh, FlashAttention-2's split, a delta launch
// first).  Both address the heads of the packed layout through strides.
// For a live column the mask adds 0, so s + 0 is s bit for bit.
//
// Bound on an NVIDIA H100 80GB HBM3 at 700 W (data sheet: 3.35 TB/s, 989
// TFLOP/s) at the sequence-parallel bench shape (bench.py:1086: 512
// sequences, S = 208 of which 197 live columns, 3 heads of 64, bf16):
// forward 4 * 512 * 3 * 208 * 197 * 64 = 15.1 GFLOP against q, kv, o and
// lse (165 MB): bytes, 0.049 ms at 3.35 TB/s; backward 10 * 512 * 3 *
// 208 * 197 * 64 = 37.8 GFLOP against q, kv, o, do and lse read and the
// f32 dq, dkv written (451 MB): bytes, 0.135 ms.  The backward computes
// each score tile in both block kinds (dq blocks and dk/dv blocks); the
// times are in PERF.md.

#include "attention_bwd.cuh"
#include "flash_fwd_sm90.cuh"

namespace {

bool ring_ok(int dtype, int B, int S, int H, int d) {
  if (B < 1 || S < 1 || H < 1 || dtype < 0 || dtype > 1) return false;
  return dtype == 0 ? d % 4 == 0
                    : d == 16 || d == 32 || d == 64 || d == 128 || d == 256;
}

}  // namespace

// Kernel 14.  dtype: 0 = float32, 1 = bfloat16.  q (B, S, H*d), kv
// (B, S, 2*H*d) and o (B, S, H*d) in that type, mask (S) and lse
// (B, S, H) f32, all contiguous (bfloat16: 16-byte aligned); bfloat16
// shapes inside one_shot_on_wgmma take the wgmma body.  Returns the
// CUDA error of the launch (0 on success, invalid value for a shape that
// is not covered); the launch is asynchronous on `stream`.
extern "C" int devt_ring_step_fwd(int dtype, const void* q, const void* kv,
                                  const float* mask, void* o, float* lse,
                                  int B, int S, int H, int d, float scale,
                                  void* stream) {
  if (!ring_ok(dtype, B, S, H, d)) return cudaErrorInvalidValue;
  const long long hd = static_cast<long long>(H) * d;
  const size_t item = dtype == 0 ? sizeof(float) : sizeof(bf16);
  FlashFwd a{};
  a.q = q;
  a.k = kv;
  a.v = static_cast<const char*>(kv) + hd * item;
  a.o = o;
  a.lse = lse;
  for (int i = 0; i < 3; ++i) {
    // (sequence, head, row) strides of the packed layouts
    a.qs[i] = a.os[i] = i == 0 ? S * hd : i == 1 ? d : hd;
    a.ks[i] = a.vs[i] = i == 0 ? 2 * S * hd : i == 1 ? d : 2 * hd;
    a.ls[i] = i == 0 ? static_cast<long long>(S) * H : i == 1 ? 1 : H;
  }
  a.H = H;
  a.Sq = a.Skv = a.kv_len = S;
  a.scale = scale;
  a.mask = mask;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (one_shot_on_wgmma(dtype, d, S))
    return launch_one_shot<true>(a, B, d, s);
  return launch_flash<false, true>(dtype, a, B * H, d, s);
}

// Kernel 15.  q, o, do (B, S, H*d) and kv (B, S, 2*H*d) in the type of
// dtype; mask (S), lse (B, S, H) f32; delta (B, S, H) f32 scratch that the
// first launch fills; dq (B, S, H*d) and dkv (B, S, 2*H*d) f32.  All
// contiguous.  Returns the CUDA error of the launches (0 on success,
// invalid value for a shape that is not covered); they are asynchronous
// on `stream`.
extern "C" int devt_ring_step_bwd(int dtype, const void* q, const void* kv,
                                  const float* mask, const void* o,
                                  const void* dout, const float* lse,
                                  float* delta, float* dq, float* dkv, int B,
                                  int S, int H, int d, float scale,
                                  void* stream) {
  if (!ring_ok(dtype, B, S, H, d)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long hd = static_cast<long long>(H) * d;
  const Strides s1{S * hd, d, hd}, s2{2 * S * hd, d, 2 * hd},
      sl{static_cast<long long>(S) * H, 1, H};
  const BwdShape sh{S, S, H, S, scale};
  const Drop none{};
  const int pairs = B * S * H;
  if (dtype == 0) {
    if (mha_bwd_smem_f32(sh, d) > kSmemPerBlock) return cudaErrorInvalidValue;
    const float* x = static_cast<const float*>(kv);
    const BwdOperands<float> a{static_cast<const float*>(q), x, x + hd,
                               static_cast<const float*>(dout), dq, dkv,
                               dkv + hd, lse, delta, s1, s2, s2, s1, s1, s2,
                               s2, sl, mask};
    DEVT_TRY(launch_delta<float>(o, dout, delta, pairs, d, s));
    return launch_bwd_f32<false, true>(a, B, d, sh, kBwdBoth, none, s);
  }
  const bf16* x = static_cast<const bf16*>(kv);
  const BwdOperands<bf16, float> a{static_cast<const bf16*>(q), x, x + hd,
                                   static_cast<const bf16*>(dout), dq, dkv,
                                   dkv + hd, lse, delta, s1, s2, s2, s1, s1,
                                   s2, s2, sl, mask};
  DEVT_TRY(launch_delta<bf16>(o, dout, delta, pairs, d, s));
  return launch_bwd_bf16_d<false, true>(a, B, d, sh, kBwdBoth, none, s);
}

extern "C" const char* devt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
