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
// and float take flash_fwd.cuh's streamed one-shot body.  The backward in
// bfloat16 at head dim 16, 32 or 64 (blocked_bwd_on_wgmma, exported as
// devt_ring_bwd_route: the bench shape and the hop-by-hop ring's shards)
// runs kernels 12's and 13's wgmma bodies (flash_bwd_sm90.cuh) with kRing,
// one launch each, Sq = Skv = kv_len = S: delta in the first launch's
// prologue, the column bias added to each scaled score before the
// exponent, p = exp(s - lse) subtracted in f32 as the plain version does,
// dq, dk and dv stored as f32 through the packed layouts' strides.  float
// and head dims 128, 256 take attention_bwd.cuh's streamed body
// (FlashAttention-2's split, a delta launch first).  All address the heads
// of the packed layout through strides.  For a live column the mask adds
// 0, so s + 0 is s bit for bit.
//
// Bound on an NVIDIA H100 80GB HBM3 at 700 W (data sheet: 3.35 TB/s, 989
// TFLOP/s) at the sequence-parallel bench shape (bench.py:1086: 512
// sequences, S = 208 of which 197 live columns, 3 heads of 64, bf16):
// forward 4 * 512 * 3 * 208 * 197 * 64 = 15.1 GFLOP against q, kv, o and
// lse (165 MB): bytes, 0.049 ms at 3.35 TB/s; backward 10 * 512 * 3 *
// 208 * 197 * 64 = 37.8 GFLOP against q, kv, o, do and lse read and the
// f32 dq, dkv written (451 MB): bytes, 0.135 ms.  The backward computes
// each score tile in both launches (dq tiles and dk/dv tiles); the times
// are in PERF.md.

#include "attention_bwd.cuh"
#include "flash_bwd_sm90.cuh"

namespace {

bool ring_ok(int dtype, int B, int S, int H, int d) {
  if (B < 1 || S < 1 || H < 1 || dtype < 0 || dtype > 1) return false;
  return dtype == 0 ? d % 4 == 0
                    : d == 16 || d == 32 || d == 64 || d == 128 || d == 256;
}

template <int HD>
cudaError_t launch_ring_bwd_d(int part, const CUtensorMap (&m)[4],
                              const RingBwd& a, int BH, cudaStream_t stream) {
  if (part == 1) {
    // kernel 12's tiles, and the column bias of every key tile
    const int ntiles = (a.kv_len + kBwdDqKeys - 1) / kBwdDqKeys;
    const size_t bytes = bwd_smem(HD, kBwdDqStages, kBwdDqKeys) +
                         static_cast<size_t>(ntiles) * kBwdDqKeys * 4;
    DEVT_TRY(set_smem(flash_bwd_dq_wgmma<HD, true>, bytes));
    flash_bwd_dq_wgmma<HD, true><<<BH * ((a.Sq + 63) / 64), kBwdThreads,
                                   bytes, stream>>>(m[0], m[1], m[2], m[3],
                                                    a);
  } else {
    constexpr size_t bytes = bwd_smem(HD, kBwdDkvStages, kBwdDkvQueries);
    DEVT_TRY(set_smem(flash_bwd_dkv_wgmma<HD, true>, bytes));
    flash_bwd_dkv_wgmma<HD, true><<<BH * ((a.Skv + 63) / 64), kBwdThreads,
                                    bytes, stream>>>(m[0], m[1], m[2], m[3],
                                                     a);
  }
  return cudaGetLastError();
}

// kernel 15, one ring hop's backward, on the two bodies with kRing: q, o,
// do (B, S, H*d) and the packed kv shard (B, S, 2*H*d) bf16 (k at column
// i*d, v at (H + i)*d; rows 16-byte aligned), Sq = Skv = kv_len = S; in `a`
// the strides, lse (B, S, H), the mask, the f32 outputs and the (B*H, S)
// delta scratch that the first launch fills.  Two launches: kernel 12's
// body (delta, dq), then kernel 13's (dk, dv).
cudaError_t launch_ring_bwd_wgmma(const RingBwd& a, const void* q,
                                  const void* kv, int B, int d,
                                  cudaStream_t stream) {
  if (!blocked_bwd_on_wgmma(1, d) || a.Sq != a.Skv || a.kv_len != a.Skv)
    return cudaErrorInvalidValue;
  const long long hd = static_cast<long long>(a.H) * d, S = a.Sq;
  const void* v = static_cast<const bf16*>(kv) + hd;
  for (int part = 1; part <= 2; ++part) {
    const int qbox = part == 1 ? 64 : kBwdDkvQueries;
    const int kbox = part == 1 ? kBwdDqKeys : 64;
    CUtensorMap m[4];
    DEVT_TRY(head_map(&m[0], q, d, a.Sq, a.H, B, hd, d, S * hd, qbox));
    DEVT_TRY(head_map(&m[1], kv, d, a.Skv, a.H, B, 2 * hd, d, 2 * S * hd,
                      kbox));
    DEVT_TRY(head_map(&m[2], v, d, a.Skv, a.H, B, 2 * hd, d, 2 * S * hd,
                      kbox));
    DEVT_TRY(head_map(&m[3], a.dout, d, a.Sq, a.H, B, hd, d, S * hd, qbox));
    switch (d) {
      case 16: DEVT_TRY(launch_ring_bwd_d<16>(part, m, a, B * a.H, stream));
               break;
      case 32: DEVT_TRY(launch_ring_bwd_d<32>(part, m, a, B * a.H, stream));
               break;
      case 64: DEVT_TRY(launch_ring_bwd_d<64>(part, m, a, B * a.H, stream));
               break;
    }
  }
  return cudaSuccess;
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
// dtype; mask (S), lse (B, S, H) f32; delta (B*S*H) f32 scratch that the
// first launch fills; dq (B, S, H*d) and dkv (B, S, 2*H*d) f32.  All
// contiguous (bfloat16: 16-byte aligned, which the wgmma bodies' TMA maps
// need).  Shapes inside blocked_bwd_on_wgmma launch kernels 12's and 13's
// bodies, one launch each; the others a delta launch, then the streamed
// body.  Returns the CUDA error of the launches (0 on success, invalid
// value for a shape that is not covered); they are asynchronous on
// `stream`.
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
  if (blocked_bwd_on_wgmma(dtype, d)) {
    RingBwd w{};
    w.o = static_cast<const bf16*>(o);
    w.dout = static_cast<const bf16*>(dout);
    w.lse = lse;
    w.delta = delta;
    w.H = H;
    w.Sq = w.Skv = w.kv_len = S;
    w.scale = scale;
    for (int i = 0; i < 3; ++i) {
      // (sequence, head, row) strides of the packed layouts
      w.qs[i] = i == 0 ? S * hd : i == 1 ? d : hd;
      w.ks[i] = i == 0 ? 2 * S * hd : i == 1 ? d : 2 * hd;
      w.ls[i] = i == 0 ? static_cast<long long>(S) * H : i == 1 ? 1 : H;
    }
    w.dqf = dq;
    w.dkf = dkv;
    w.dvf = dkv + hd;
    w.mask = mask;
    return launch_ring_bwd_wgmma(w, q, kv, B, d, s);
  }
  const bf16* x = static_cast<const bf16*>(kv);
  const BwdOperands<bf16, float> a{static_cast<const bf16*>(q), x, x + hd,
                                   static_cast<const bf16*>(dout), dq, dkv,
                                   dkv + hd, lse, delta, s1, s2, s2, s1, s1,
                                   s2, s2, sl, mask};
  DEVT_TRY(launch_delta<bf16>(o, dout, delta, pairs, d, s));
  return launch_bwd_bf16_d<false, true>(a, B, d, sh, kBwdBoth, none, s);
}

// 1 when a backward hop (kernel 15) of this dtype (0 float32, 1 bfloat16)
// and head dim takes kernels 12's and 13's wgmma bodies
extern "C" int devt_ring_bwd_route(int dtype, int d) {
  return blocked_bwd_on_wgmma(dtype, d) ? 1 : 0;
}

extern "C" const char* devt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
