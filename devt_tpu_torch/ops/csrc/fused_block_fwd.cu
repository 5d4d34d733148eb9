// Fused pre-norm ViT block forward for Hopper (sm_90a).
//
// Computes what devt_tpu/ops/fused_block.py:_fwd_kernel computes, for
// x (B, S, D) in bfloat16 or float:
//
//   a   = LN1(x)                                   (f32 statistics)
//   qkv = a @ Wqkv                                 (no bias; columns (3, H, d))
//   att = per head: softmax(q k^T * scale + mask) v, normalised after PV
//   u   = x + drop(att @ Wo + bo)
//   b   = LN2(u)
//   y   = u + drop(drop(gelu_tanh(b @ W1 + bb1)) @ W2 + bb2)
//   res = [lse (H), mu1, rstd1, mu2, rstd2, 0...]  per row, f32
//
// drop is the identity at rate 0; otherwise the Philox masks of
// fused_block_common.cuh at the three sites, which the backward kernel
// regenerates from the same seed.
//
// Every matrix operand is rounded to the type of x and every product
// accumulates in f32, as preferred_element_type=f32 does in the JAX
// kernel.  The mask is an additive -1e30 on key columns >= kv_len; pad
// query rows are computed like any other row.
//
// Design.  The TPU kernel keeps G = 8 whole sequences in up to 100 MB of
// VMEM per grid step.  A Hopper block has at most 227 KB of shared
// memory, and one sequence's f32 qkv alone (208 x 576 x 4 = 479 KB) does
// not fit, so the block is split into three launches that hand their
// intermediates over through global memory (mostly L2):
//
//   1. LN1 + qkv:   block_sm90.cuh's ln_qkv_sm90 per 128 rows: LN1 of the
//                   rows into shared memory in the wgmma swizzle, then
//                   qkv = a @ Wqkv on wgmma with the Wqkv boxes streamed
//                   by TMA; writes qkv in x's type (the rounding the TPU
//                   kernel applies before its attention products) and
//                   mu1, rstd1.
//   2. attention:   in bfloat16 with at most 256 live keys at head dim 16,
//                   32 or 64 (one_shot_on_wgmma with kv_len as the key
//                   count, as kernel 7's attention: every main-path
//                   shape), flash_fwd_sm90.cuh's one-shot wgmma body in
//                   its normalise-after instance (o = (round(p) @ v) / l)
//                   on the head views of the qkv scratch, a CTA per two
//                   64-query tiles of a (sequence, head); the other shapes
//                   (up to the 512 tokens the block takes) and the float
//                   route keep attention_fwd.cuh's body (per 64 queries,
//                   head, sequence; the scores recomputed per pass).
//                   Writes att in x's type and the lse.
//   3. out + FFN:   block_sm90.cuh's out_ffn_sm90 per 128 rows: att @ Wo +
//                   bo + x = u on wgmma (att by TMA), LN2 on the
//                   accumulators into shared memory, then the FFN 64
//                   hidden columns at a time: gelu of the W1 product in
//                   registers becomes the A fragments of the W2 product.
//                   Wo, W1 and W2 boxes stream through one TMA ring.
//                   Writes y, u, mu2, rstd2.
//
// The float route keeps plain FMA loops (exact f32, no TF32) and is not
// on the serving path.
//
// Bound at the main-path shape (B=512, S=208, D=192, H=3, MLP 768):
// 110-111 GFLOP per launch against about 127 MB of inputs and outputs,
// so the card is compute-bound (about 0.11 ms at 989 TFLOP/s bf16).  The
// times are in PERF.md.

#include "block_attention.cuh"
#include "block_sm90.cuh"

namespace {

// ===========================================================================
// float route: the same three stages with exact f32 FMA products (LN1 +
// qkv is fused_block_common.cuh's, the attention attention_fwd.cuh's)
// ===========================================================================

__host__ __device__ constexpr size_t f32_ffn_smem(int D, int F, int NT,
                                                  int KT) {
  const int ldb = pad_f32(D > NT ? D : NT);
  return 2 * align128(sizeof(float) * kF32Rows * pad_f32(D)) +
         align128(sizeof(float) * kF32Rows * pad_f32(F)) +
         align128(sizeof(float) * kF32Rows * pad_f32(NT)) +
         align128(sizeof(float) * KT * ldb);
}

__global__ void __launch_bounds__(kF32Threads)
    out_ffn_f32(const float* __restrict__ x, const float* __restrict__ att,
                const float* __restrict__ wo, const float* __restrict__ bo,
                const float* __restrict__ g2, const float* __restrict__ b2,
                const float* __restrict__ w1, const float* __restrict__ bb1,
                const float* __restrict__ w2, const float* __restrict__ bb2,
                float* __restrict__ y, float* __restrict__ u,
                float* __restrict__ res, int rows, int D, int F, int H,
                int lanes, int NT, int KT, Drop drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = pad_f32(D), ldh = pad_f32(F), ldc = pad_f32(NT);
  const int ldb = pad_f32(D > NT ? D : NT);
  float* As = reinterpret_cast<float*>(smem);  // att, then LN2(u)
  float* Us = As + align128(sizeof(float) * kF32Rows * lda) / sizeof(float);
  float* Hs = Us + align128(sizeof(float) * kF32Rows * lda) / sizeof(float);
  float* Cs = Hs + align128(sizeof(float) * kF32Rows * ldh) / sizeof(float);
  float* Bs = Cs + align128(sizeof(float) * kF32Rows * ldc) / sizeof(float);
  const int row0 = blockIdx.x * kF32Rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kF32Rows * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D, gr = row0 + r;
    As[r * lda + c] = gr < rows ? att[static_cast<size_t>(gr) * D + c] : 0.f;
  }
  for (int k0 = 0; k0 < D; k0 += KT) {  // Us = att @ Wo
    load_tile_f32(Bs, ldb, wo, D, k0, 0, KT, D);
    __syncthreads();
    block_gemm_f32<false>(As + k0, lda, Bs, ldb, Us, lda, kF32Rows, D, KT,
                          k0 > 0);
    __syncthreads();
  }
  // u = x + (Us + bo); LN2(u) → As; Us holds u
  for (int r = warp; r < kF32Rows; r += kF32Threads / 32) {
    const int gr = row0 + r;
    float* ur = Us + r * lda;
    float* ar = As + r * lda;
    if (gr < rows) {
      const size_t g = static_cast<size_t>(gr);
      for (int c = lane; c < D; c += 32) {
        ur[c] = x[g * D + c] +
                drop_one(drop, kSiteOut, g * D + c, ur[c] + bo[c]);
        u[g * D + c] = ur[c];
      }
      float mu, rstd;
      warp_row_stats(ur, D, mu, rstd);
      for (int c = lane; c < D; c += 32)
        ar[c] = (ur[c] - mu) * rstd * g2[c] + b2[c];
      if (lane == 0) {
        res[g * lanes + H + 2] = mu;
        res[g * lanes + H + 3] = rstd;
        for (int l = H + 4; l < lanes; ++l) res[g * lanes + l] = 0.f;
      }
    } else {
      for (int c = lane; c < D; c += 32) ar[c] = ur[c] = 0.f;
    }
  }
  for (int n0 = 0; n0 < F; n0 += NT) {  // Hs = gelu(As @ W1 + bb1)
    for (int k0 = 0; k0 < D; k0 += KT) {
      load_tile_f32(Bs, ldb, w1, F, k0, n0, KT, NT);
      __syncthreads();
      block_gemm_f32<false>(As + k0, lda, Bs, ldb, Cs, ldc, kF32Rows, NT, KT,
                            k0 > 0);
      __syncthreads();
    }
    for (int i = threadIdx.x; i < kF32Rows * NT; i += blockDim.x) {
      const int r = i / NT, j = i - r * NT;
      Hs[r * ldh + n0 + j] = drop_one(
          drop, kSiteHidden,
          static_cast<unsigned long long>(row0 + r) * F + n0 + j,
          gelu_tanh(Cs[r * ldc + j] + bb1[n0 + j]));
    }
  }
  // Cs-free accumulation of Hs @ W2 into As (LN2 output no longer needed)
  for (int k0 = 0; k0 < F; k0 += KT) {
    load_tile_f32(Bs, ldb, w2, D, k0, 0, KT, D);
    __syncthreads();
    block_gemm_f32<false>(Hs + k0, ldh, Bs, ldb, As, lda, kF32Rows, D, KT,
                          k0 > 0);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < kF32Rows * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D, gr = row0 + r;
    if (gr < rows) {
      const size_t g = static_cast<size_t>(gr) * D + c;
      y[g] = Us[r * lda + c] +
             drop_one(drop, kSiteFfnOut, g, As[r * lda + c] + bb2[c]);
    }
  }
}

// ===========================================================================
// launches
// ===========================================================================

struct Args {
  const void *x, *g1, *b1, *wqkv, *wo, *bo, *g2, *b2, *w1, *bb1, *w2, *bb2;
  void *y, *u, *res, *qkv, *att, *u32;
  int B, S, D, H, F, kv_len, lanes;
  float scale;
  Drop drop;
  cudaStream_t stream;
};

template <int D, int HD>
cudaError_t launch_bf16_shape(const Args& a) {
  const int rows = a.B * a.S;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  DEVT_TRY((launch_ln_qkv<D, false>(
      h(a.x), f(a.g1), f(a.b1), h(a.wqkv), static_cast<bf16*>(a.qkv),
      static_cast<float*>(a.res), nullptr, rows, a.H, a.lanes, a.stream)));
  // the attention into att and the lse lanes of res
  DEVT_TRY(block_attention_bf16<HD>(
      static_cast<const bf16*>(a.qkv), static_cast<bf16*>(a.att),
      static_cast<float*>(a.res), a.B, a.S, a.H, a.kv_len, a.lanes, a.scale,
      a.stream));
  return launch_out_ffn<D>(
      h(a.x), h(a.att), h(a.wo), f(a.bo), f(a.g2), f(a.b2), h(a.w1),
      f(a.bb1), h(a.w2), f(a.bb2), static_cast<bf16*>(a.y),
      static_cast<bf16*>(a.u), static_cast<float*>(a.u32),
      static_cast<float*>(a.res), rows, a.F, a.H, a.lanes, a.drop, a.stream);
}

// the bfloat16 kernels are compiled for these widths (dim, head dim)
cudaError_t launch_bf16(const Args& a) {
  const int hd = a.D / a.H;
  if (a.F % kHidden) return cudaErrorInvalidValue;
  if (a.D == 192 && hd == 64) return launch_bf16_shape<192, 64>(a);
  if (a.D == 64 && hd == 32) return launch_bf16_shape<64, 32>(a);
  return cudaErrorInvalidValue;
}

cudaError_t launch_f32(const Args& a) {
  const int d = a.D / a.H, rows = a.B * a.S, N3 = 3 * a.D;
  const int nt_qkv = pick_tile(64, N3, N3), nt_ffn = pick_tile(64, a.F, a.F);
  const int kt = pick_tile(32, a.D, a.F);
  if (!nt_qkv || !nt_ffn || !kt) return cudaErrorInvalidValue;
  const int row_blocks = (rows + kF32Rows - 1) / kF32Rows;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* qkv = static_cast<float*>(a.qkv);
  float* att = static_cast<float*>(a.att);
  float* res = static_cast<float*>(a.res);

  const size_t s1 = f32_qkv_smem(a.D, nt_qkv);
  DEVT_TRY(set_smem(ln_qkv_f32, s1));
  ln_qkv_f32<<<row_blocks, kF32Threads, s1, a.stream>>>(
      f(a.x), f(a.g1), f(a.b1), f(a.wqkv), qkv, res, rows, a.D, N3, a.H,
      a.lanes, nt_qkv);
  DEVT_TRY(cudaGetLastError());

  DEVT_TRY(launch_attention_f32<false>(qkv, att, res, a.B, a.S, a.H, d,
                                       a.kv_len, a.lanes, a.scale, a.stream));

  const size_t s3 = f32_ffn_smem(a.D, a.F, nt_ffn, kt);
  DEVT_TRY(set_smem(out_ffn_f32, s3));
  out_ffn_f32<<<row_blocks, kF32Threads, s3, a.stream>>>(
      f(a.x), att, f(a.wo), f(a.bo), f(a.g2), f(a.b2), f(a.w1), f(a.bb1),
      f(a.w2), f(a.bb2), static_cast<float*>(a.y), static_cast<float*>(a.u),
      res, rows, a.D, a.F, a.H, a.lanes, nt_ffn, kt, a.drop);
  return cudaGetLastError();
}

// keep masks (1 = kept) of the three dropout sites for `rows` rows, from
// the same device function the kernels draw from
__global__ void dropout_masks_kernel(uint8_t* keep_o, uint8_t* keep_h,
                                     uint8_t* keep_y, size_t n_d, size_t n_f,
                                     Drop drop) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_d || i < n_f; i += stride) {
    if (i < n_f) keep_h[i] = drop_keep(drop, kSiteHidden, i);
    if (i < n_d) {
      keep_o[i] = drop_keep(drop, kSiteOut, i);
      keep_y[i] = drop_keep(drop, kSiteFfnOut, i);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Weight matrices are in x's type and
// in the (K, N) layout of the JAX kernel; LN parameters and biases are
// f32.  qkv (B, S, 3D) and att (B, S, D) are scratch in x's type; u32
// (B, S, D) is f32 scratch for the bfloat16 route (u before rounding),
// unused by the float route.  In bfloat16, x, att, qkv and the weight
// matrices are 16-byte aligned (TMA reads them).  rate > 0 turns the
// dropout of the three sites on, drawn from `seed`.
// Returns the CUDA error of the launches (0 on success); the launches are
// asynchronous on `stream`.
extern "C" int devt_fused_block_fwd(
    int dtype, const void* x, const void* g1, const void* b1,
    const void* wqkv, const void* wo, const void* bo, const void* g2,
    const void* b2, const void* w1, const void* bb1, const void* w2,
    const void* bb2, void* y, void* u, void* res, void* qkv, void* att,
    void* u32, int B, int S, int D, int H, int F, int kv_len, int lanes,
    float scale, double rate, unsigned long long seed, void* stream) {
  if (rate < 0.0 || rate >= 1.0) return cudaErrorInvalidValue;
  const Args a{x,   g1,  b1,  wqkv, wo,  bo,  g2, b2, w1, bb1, w2,
               bb2, y,   u,   res,  qkv, att, u32, B, S, D,  H,  F,
               kv_len, lanes, scale, make_drop(rate, seed),
               static_cast<cudaStream_t>(stream)};
  if (D % H || (D / H) % 16 || D % 16 || F % 16 || kv_len < 1 ||
      kv_len > S || lanes < H + 4)
    return cudaErrorInvalidValue;
  if (dtype == 0) return launch_f32(a);
  if (dtype == 1) return launch_bf16(a);
  return cudaErrorInvalidValue;
}

// The keep masks (uint8, 1 = kept) that a call with this seed and rate
// applies: keep_o and keep_y (rows, D), keep_h (rows, F), rows = B * S.
extern "C" int devt_dropout_masks(void* keep_o, void* keep_h, void* keep_y,
                                  int rows, int D, int F, double rate,
                                  unsigned long long seed, void* stream) {
  if (rate <= 0.0 || rate >= 1.0) return cudaErrorInvalidValue;
  const size_t n_d = static_cast<size_t>(rows) * D;
  const size_t n_f = static_cast<size_t>(rows) * F;
  dropout_masks_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(keep_o), static_cast<uint8_t*>(keep_h),
      static_cast<uint8_t*>(keep_y), n_d, n_f, make_drop(rate, seed));
  return cudaGetLastError();
}

// 1 when kernel 1's attention launch of this dtype (0 float32, 1
// bfloat16), head dim and kv_len takes flash_fwd_sm90.cuh's one-shot body
extern "C" int devt_fused_block_route(int dtype, int d, int kv_len) {
  return one_shot_on_wgmma(dtype, d, kv_len) ? 1 : 0;
}

extern "C" const char* devt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
