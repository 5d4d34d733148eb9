// Attention backward on split q, k and v for Hopper (sm_90a): kernel 10 of
// the port, the backward of flash_attention's single-block path.
//
// Computes what devt_tpu/ops/flash_attention.py:413 _bwd_single_kernel
// computes (launched from _bwd_single, :484), for q, k, v (B, H, S, d)
// given by their element strides over (sequence, head, row) with the rows
// contiguous, the stored output o and its gradient do (B, H, S, d)
// contiguous in q's type, and lse (B*H, S) f32, per (sequence, head):
//
//   delta = rowsum(f32(do) * f32(o))
//   p     = exp(q k^T * scale - lse), keys at or past kv_len at 0
//   dv    = round(p)^T @ do;   dp = do @ v^T
//   ds    = p * (dp - delta) * scale
//   dq    = round(ds) @ k;     dk = round(ds)^T @ q
//
// every product summed in f32, round() the cast to the operand type;
// dq, dk, dv (B, H, S, d) contiguous in q's type.  The TPU kernel holds G
// whole (S, S) score blocks in VMEM and computes delta inside; here the
// body is attention_bwd.cuh's, which kernel 4 (mha_bwd.cu) shares on the
// packed layout: a launch writes delta (B*H, S), then FlashAttention-2's
// split, blocks that own 64 queries (dq) or 64 keys (dk, dv) and stream
// the other side's rows through a double-buffered cp.async ring, so shared
// memory does not grow with S; one owner per output, no atomics, two runs
// give the same bits.  No dropout: the TPU kernel has none.
//
// Bound at (1536, 197, 64), kv_len 197, bf16 (the backward of the int8
// block's attention shape): five products of 2 * 197 * 197 * 64 per
// (sequence, head), 38.2 GFLOP, against 310 MB (q, k, v, o, do read, dq,
// dk, dv written, lse): bytes bind it, 0.092 ms at 3.35 TB/s.  The times
// are in PERF.md.

#include "attention_bwd.cuh"

namespace {

template <typename T>
BwdOperands<T> split(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, void* delta,
                     void* dq, void* dk, void* dv, int H, int S, int d,
                     const long long* st) {
  const long long hs = static_cast<long long>(S) * d;
  const Strides c{H * hs, hs, d}, sl{static_cast<long long>(H) * S, S, 1};
  return {static_cast<const T*>(q),    static_cast<const T*>(k),
          static_cast<const T*>(v),    static_cast<const T*>(dout),
          static_cast<T*>(dq),         static_cast<T*>(dk),
          static_cast<T*>(dv),         static_cast<const float*>(lse),
          static_cast<float*>(delta),  Strides{st[0], st[1], st[2]},
          Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
          c, c, c, c, sl};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v (B, H, S, d) by strides:
// strides[0..2] q's (sequence, head, row) in elements, [3..5] k's, [6..8]
// v's, the rows contiguous and, in bfloat16, 16-byte aligned; o, do, dq,
// dk, dv (B, H, S, d) contiguous in that type; lse (B*H, S) f32; delta
// (B*H, S) f32 scratch that the first launch fills.  The bfloat16 kernel
// is compiled for head dims 16, 32, 64, 128 and 256, the float kernel
// takes any multiple of 4 whose 32-row tiles fit shared memory.  Returns
// the CUDA error of the launches (0 on success, invalid value for a shape
// that is not covered); they are asynchronous on `stream`.
extern "C" int devt_flash_bwd(int dtype, const void* q, const void* k,
                              const void* v, const void* o, const void* dout,
                              const void* lse, void* delta, void* dq,
                              void* dk, void* dv, int B, int H, int S, int d,
                              int kv_len, const long long* strides,
                              float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1 || kv_len < 1 || kv_len > S || dtype < 0 ||
      dtype > 1)
    return cudaErrorInvalidValue;
  const Drop none{};
  const int pairs = B * H * S;
  if (dtype == 0) {
    if (d % 4 || mha_bwd_smem_f32(round_up(S, 16), d) > kSmemPerBlock)
      return cudaErrorInvalidValue;
    const BwdOperands<float> a = split<float>(q, k, v, dout, lse, delta, dq,
                                              dk, dv, H, S, d, strides);
    DEVT_TRY(launch_delta<float>(o, dout, a.delta, pairs, d, s));
    return launch_bwd_f32<false>(a, B, S, H, d, kv_len, scale, none, s);
  }
  if (d != 16 && d != 32 && d != 64 && d != 128 && d != 256)
    return cudaErrorInvalidValue;
  const BwdOperands<bf16> a = split<bf16>(q, k, v, dout, lse, delta, dq, dk,
                                          dv, H, S, d, strides);
  DEVT_TRY(launch_delta<bf16>(o, dout, a.delta, pairs, d, s));
  return launch_bwd_bf16_d<false>(a, B, S, H, d, kv_len, scale, none, s);
}

extern "C" const char* devt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
