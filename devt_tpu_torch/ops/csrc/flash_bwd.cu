// Attention backward on split q, k and v for Hopper (sm_90a): kernels 10,
// 12 and 13 of the port, the backward of flash_attention.
//
// For q (B, H, Sq, d), k and v (B, H, Skv, d) given by their element
// strides over (sequence, head, row) with the rows contiguous, the stored
// output o and its gradient do (B, H, Sq, d) contiguous in q's type, and
// lse (B*H, Sq) f32, per (sequence, head):
//
//   delta = rowsum(f32(do) * f32(o))
//   p     = exp(q k^T * scale - lse), keys at or past kv_len at 0
//   dv    = round(p)^T @ do;   dp = do @ v^T
//   ds    = p * (dp - delta) * scale
//   dq    = round(ds) @ k;     dk = round(ds)^T @ q
//
// every product summed in f32, round() the cast to the operand type; dq
// (B, H, Sq, d), dk and dv (B, H, Skv, d) contiguous in q's type.
//
//   devt_flash_bwd          kernel 10, devt_tpu/ops/flash_attention.py:413
//                           _bwd_single_kernel (Sq == Skv <= 512): what
//                           kernels 12 and 13 compute at Sq == Skv, so
//                           the two parts below, one after the other
//   devt_flash_blocked_bwd  kernels 12 and 13, flash_attention.py:158
//                           _bwd_dq_kernel and :198 _bwd_dkv_kernel (any
//                           Sq, Skv: the blockwise path's backward), as two
//                           calls: part 1 writes delta and dq (kernel 12),
//                           part 2 dk and dv (kernel 13), reading the delta
//                           part 1 wrote
//
// Kernels 10, 12 and 13 in bfloat16 at head dim 16, 32 or 64
// (blocked_bwd_on_wgmma: every main-path shape) run flash_bwd_sm90.cuh's
// bodies: one launch each of kernel 12's and 13's (kernel 10 launches
// both, with Sq = Skv = S), delta computed in kernel 12's prologue, every
// product on wgmma, the streamed side's tiles through a TMA ring (the
// design and its numbers are there).  Every other shape, and the float
// route, runs what follows: for kernel 10 a delta launch, then one launch
// of dq and dk/dv blocks.
//
// The TPU kernels walk 128 x 128 blocks on a sequential grid, carrying dq
// (or dk, dv) in VMEM scratch from one kv (or q) block to the next and
// recomputing delta in each; here the body is attention_bwd.cuh's, which
// kernel 4 (mha_bwd.cu) and the ring hop (ring_step.cu) share:
// FlashAttention-2's split, blocks that own 64 queries (dq) or 64 keys
// (dk, dv) and stream the other side's rows, with the queries' lse and
// delta, through a double-buffered cp.async ring, so shared memory does
// not grow with Sq or Skv; query rows past Sq and keys past kv_len are
// masked in the kernel, nothing is padded in device memory.  One owner per
// output, no atomics: two runs give the same bits.  No dropout: the TPU
// kernels have none.
//
// Bounds (bf16): kernel 10 at (1536, 197, 64), kv_len 197 (the backward of
// the int8 block's attention shape): five products of 2 * 197 * 197 * 64
// per (sequence, head), 38.2 GFLOP, against 310 MB (q, k, v, o, do read,
// dq, dk, dv written, lse): bytes bind it, 0.092 ms at 3.35 TB/s.  On the
// wgmma bodies it computes 256 rows and keys of 197 (the bodies' 64-row
// tiles) and each score tile twice, once in each part.  At
// ViViT's image-384 shape (1536, 592, 64), kv_len 577: kernel 12 (delta
// included) three products, 6 * 1536 * 592 * 577 * 64 = 201 GFLOP, against
// q, k, v, o, do read, dq written, lse read and delta written (706 MB):
// bytes, 0.21 ms; kernel 13 four products, 269 GFLOP, against q, k, v, do,
// lse and delta read, dk and dv written (706 MB): operations, 0.27 ms.
// What the design
// leaves on the table: each score tile is computed twice (once in each
// kernel), and the streamed side is re-read per block of 64 (from L2).
// The times are in PERF.md.

#include "attention_bwd.cuh"
#include "flash_bwd_sm90.cuh"

namespace {

template <typename T>
BwdOperands<T> split(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, void* delta,
                     void* dq, void* dk, void* dv, int H, int Sq, int Skv,
                     int d, const long long* st) {
  const long long hq = static_cast<long long>(Sq) * d,
                  hk = static_cast<long long>(Skv) * d;
  const Strides cq{H * hq, hq, d}, ck{H * hk, hk, d},
      sl{static_cast<long long>(H) * Sq, Sq, 1};
  return {static_cast<const T*>(q),    static_cast<const T*>(k),
          static_cast<const T*>(v),    static_cast<const T*>(dout),
          static_cast<T*>(dq),         static_cast<T*>(dk),
          static_cast<T*>(dv),         static_cast<const float*>(lse),
          static_cast<float*>(delta),  Strides{st[0], st[1], st[2]},
          Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
          cq, cq, ck, ck, sl, nullptr};
}

// delta (with_delta) and the blocks of `part`
int run(int dtype, BwdPart part, bool with_delta, const void* q,
        const void* k, const void* v, const void* o, const void* dout,
        const void* lse, void* delta, void* dq, void* dk, void* dv, int B,
        const BwdShape& sh, int d, const long long* strides,
        cudaStream_t s) {
  const Drop none{};
  const int pairs = B * sh.H * sh.Sq;
  if (dtype == 0) {
    if (d % 4 || mha_bwd_smem_f32(sh, d) > kSmemPerBlock)
      return cudaErrorInvalidValue;
    const BwdOperands<float> a = split<float>(
        q, k, v, dout, lse, delta, dq, dk, dv, sh.H, sh.Sq, sh.Skv, d,
        strides);
    if (with_delta)
      DEVT_TRY(launch_delta<float>(o, dout, a.delta, pairs, d, s));
    return launch_bwd_f32<false, false>(a, B, d, sh, part, none, s);
  }
  if (dtype != 1 || (d != 16 && d != 32 && d != 64 && d != 128 && d != 256))
    return cudaErrorInvalidValue;
  const BwdOperands<bf16> a = split<bf16>(
      q, k, v, dout, lse, delta, dq, dk, dv, sh.H, sh.Sq, sh.Skv, d,
      strides);
  if (with_delta)
    DEVT_TRY(launch_delta<bf16>(o, dout, a.delta, pairs, d, s));
  return launch_bwd_bf16_d<false, false>(a, B, d, sh, part, none, s);
}

// the wgmma bodies' arguments (q, k, v go by strides to their TMA maps)
FlashBwd wgmma_args(const void* o, const void* dout, const void* lse,
                    void* delta, void* dq, void* dk, void* dv, int H, int Sq,
                    int Skv, int kv_len, float scale) {
  return {static_cast<const bf16*>(o),
          static_cast<const bf16*>(dout),
          static_cast<const float*>(lse),
          static_cast<float*>(delta),
          static_cast<bf16*>(dq),
          static_cast<bf16*>(dk),
          static_cast<bf16*>(dv),
          H,
          Sq,
          Skv,
          kv_len,
          scale};
}

}  // namespace

// Kernel 10.  dtype: 0 = float32, 1 = bfloat16.  q, k, v (B, H, S, d) by
// strides: strides[0..2] q's (sequence, head, row) in elements, [3..5]
// k's, [6..8] v's, the rows contiguous and, in bfloat16, 16-byte aligned;
// o, do, dq, dk, dv (B, H, S, d) contiguous in that type; lse (B*H, S)
// f32; delta (B*H, S) f32 scratch that the first launch fills.  The
// bfloat16 kernel is compiled for head dims 16, 32, 64, 128 and 256, the
// float kernel takes any multiple of 4 whose 32-row tiles fit shared
// memory.  Shapes inside blocked_bwd_on_wgmma (devt_blocked_bwd_route
// says which) launch kernel 12's body, then kernel 13's, which first
// encode TMA maps of q, k, v and do on the host; the others the streamed
// body.  Returns the CUDA error of the launches (0 on success, invalid
// value for a shape that is not covered); they are asynchronous on
// `stream`.
extern "C" int devt_flash_bwd(int dtype, const void* q, const void* k,
                              const void* v, const void* o, const void* dout,
                              const void* lse, void* delta, void* dq,
                              void* dk, void* dv, int B, int H, int S, int d,
                              int kv_len, const long long* strides,
                              float scale, void* stream) {
  if (B < 1 || S < 1 || H < 1 || kv_len < 1 || kv_len > S)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocked_bwd_on_wgmma(dtype, d)) {
    const FlashBwd a = wgmma_args(o, dout, lse, delta, dq, dk, dv, H, S, S,
                                  kv_len, scale);
    DEVT_TRY(launch_blocked_bwd_wgmma(1, a, q, k, v, B, d, strides, s));
    return launch_blocked_bwd_wgmma(2, a, q, k, v, B, d, strides, s);
  }
  return run(dtype, kBwdBoth, true, q, k, v, o, dout, lse, delta, dq, dk, dv,
             B, BwdShape{S, S, H, kv_len, scale}, d, strides, s);
}

// Kernels 12 (part 1: delta, then dq) and 13 (part 2: dk and dv, from the
// delta of part 1).  q (B, H, Sq, d), k and v (B, H, Skv, d) by strides as
// above; o, do and dq (B, H, Sq, d), dk and dv (B, H, Skv, d) contiguous
// (in bfloat16 16-byte aligned); lse and delta (B*H, Sq) f32.  Part 1
// writes dq and delta and reads neither dk nor dv; part 2 writes dk and dv
// and reads neither o nor dq.  Shapes inside blocked_bwd_on_wgmma take the
// wgmma bodies, which first encode TMA maps of q, k, v and do on the host.
extern "C" int devt_flash_blocked_bwd(int dtype, int part, const void* q,
                                      const void* k, const void* v,
                                      const void* o, const void* dout,
                                      const void* lse, void* delta, void* dq,
                                      void* dk, void* dv, int B, int H,
                                      int Sq, int Skv, int d, int kv_len,
                                      const long long* strides, float scale,
                                      void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1 || kv_len < 1 || kv_len > Skv ||
      (part != 1 && part != 2))
    return cudaErrorInvalidValue;
  if (blocked_bwd_on_wgmma(dtype, d))
    return launch_blocked_bwd_wgmma(
        part,
        wgmma_args(o, dout, lse, delta, dq, dk, dv, H, Sq, Skv, kv_len, scale),
        q, k, v, B, d, strides, static_cast<cudaStream_t>(stream));
  return run(dtype, part == 1 ? kBwdDq : kBwdDkv, part == 1, q, k, v, o,
             dout, lse, delta, dq, dk, dv, B,
             BwdShape{Sq, Skv, H, kv_len, scale}, d, strides,
             static_cast<cudaStream_t>(stream));
}

// 1 when a backward of kernel 10, or of kernels 12 and 13, of this dtype
// (0 float32, 1 bfloat16) and head dim takes flash_bwd_sm90.cuh's bodies
extern "C" int devt_blocked_bwd_route(int dtype, int d) {
  return blocked_bwd_on_wgmma(dtype, d) ? 1 : 0;
}

extern "C" const char* devt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
