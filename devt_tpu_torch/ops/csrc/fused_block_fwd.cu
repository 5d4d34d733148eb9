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
//   1. LN1 + qkv:   per 128 rows: LN1 of the rows into shared memory,
//                   then the qkv product 64 columns at a time with the
//                   next Wqkv slice loading (cp.async) meanwhile; writes
//                   qkv in x's type (the rounding the TPU kernel applies
//                   before its attention products) and mu1, rstd1.
//   2. attention:   (attention_fwd.cuh, shared with the int8 block and the
//                   packed-qkv attention)
//                   per (64 queries, head, sequence), 16 queries a warp:
//                   K and V in shared memory; a first pass over the keys
//                   takes the exact row max, a second recomputes the
//                   scores, exponentiates, sums l in f32 and multiplies
//                   the bf16 probabilities into V — the same arithmetic
//                   as the one-shot softmax of the TPU kernel.  Key blocks
//                   wholly past kv_len are skipped: their probabilities
//                   are exactly 0.  Writes att in x's type and the lse.
//   3. out + FFN:   per 128 rows, 16 warps: att @ Wo + bo + x = u in
//                   registers (and in f32 scratch for the last residual),
//                   LN2 with the row sums shared across warps, then the
//                   FFN over 64 hidden columns at a time.  Wo slices, then
//                   W1/W2 slices, stream through a two-stage cp.async
//                   ring; the hidden slice sits in shared memory and the
//                   W2 product accumulates in registers.  Writes y, u,
//                   mu2, rstd2.
//
// The bfloat16 products are warp-level mma.sync m16n8k16 tiles fed by
// ldmatrix from shared memory (CUDA C++ in this file; no library GEMM).
// The float route keeps plain FMA loops (exact f32, no TF32) and is not
// on the serving path.
//
// Bound at the main-path shape (B=512, S=208, D=192, H=3, MLP 768):
// 110-111 GFLOP per launch against about 127 MB of inputs and outputs,
// so the card is compute-bound (about 0.11 ms at 989 TFLOP/s bf16).
// mma.sync reaches a fraction of that peak, which only wgmma reaches;
// the times are in PERF.md.

#include "attention_fwd.cuh"

namespace {

// ---------------------------------------------------------------------------
// 3. out-projection, residual, LN2, FFN, residual
// ---------------------------------------------------------------------------

constexpr int kFfnRows = 128, kFfnHidden = 64, kFfnSlice = 64;
constexpr int kFfnThreads = 512;

struct FfnSmem {
  size_t off_h, off_red, off_ring, stage, bytes;
};

template <int D>
__host__ __device__ constexpr FfnSmem ffn_smem_bf16() {
  FfnSmem s{};
  s.off_h = align128(sizeof(bf16) * kFfnRows * (D + 8));
  s.off_red = s.off_h + align128(sizeof(bf16) * kFfnRows * (kFfnHidden + 8));
  s.off_ring = s.off_red + align128(sizeof(float) * 2 * kFfnRows * 4);
  // a stage holds W1[:, chunk] (D x 64) then W2[chunk, :] (64 x D); a
  // slice of 64 Wo rows (64 x D) fits in it as well
  s.stage = align128(sizeof(bf16) * D * (kFfnHidden + 8)) +
            align128(sizeof(bf16) * kFfnHidden * (D + 8));
  s.bytes = s.off_ring + 2 * s.stage;
  return s;
}

template <int D>
__device__ __forceinline__ bf16* ring_stage(unsigned char* ring, int s) {
  return reinterpret_cast<bf16*>(ring + (s & 1) * ffn_smem_bf16<D>().stage);
}

// W2[chunk, :] sits after W1[:, chunk] in a stage
template <int D>
__device__ __forceinline__ bf16* ring_w2(unsigned char* ring, int s) {
  return reinterpret_cast<bf16*>(
      reinterpret_cast<unsigned char*>(ring_stage<D>(ring, s)) +
      align128(sizeof(bf16) * D * (kFfnHidden + 8)));
}

template <int D>
__global__ void __launch_bounds__(kFfnThreads, 1)
    out_ffn_bf16(const bf16* __restrict__ x, const bf16* __restrict__ att,
                 const bf16* __restrict__ wo, const float* __restrict__ bo,
                 const float* __restrict__ g2, const float* __restrict__ b2,
                 const bf16* __restrict__ w1, const float* __restrict__ bb1,
                 const bf16* __restrict__ w2, const float* __restrict__ bb2,
                 bf16* __restrict__ y, bf16* __restrict__ u,
                 float* __restrict__ u32, float* __restrict__ res, int rows,
                 int F, int H, int lanes, Drop drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr FfnSmem L = ffn_smem_bf16<D>();
  constexpr int lda = D + 8, ldh = kFfnHidden + 8;
  constexpr int ldw1 = kFfnHidden + 8, ldw2 = D + 8;
  constexpr int NI = D / 32;  // warp tile 32 x D/4 → NI n8 blocks
  constexpr int slices = D / kFfnSlice;
  bf16* As = reinterpret_cast<bf16*>(smem);            // att, then LN2(u)
  bf16* Hs = reinterpret_cast<bf16*>(smem + L.off_h);  // GELU slice
  float* red = reinterpret_cast<float*>(smem + L.off_red);  // row partials
  unsigned char* ring = smem + L.off_ring;             // weight stages
  const int row0 = blockIdx.x * kFfnRows;
  const int valid = min(kFfnRows, rows - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3, wq = warp & 3;
  const int wm = (warp >> 2) * 32;  // 16 warps as 4 x 4
  const int wn = wq * (D / 4), wz = wq * 16;
  const int chunks = F / kFfnHidden;

  // Weight steps run through a two-stage ring: the Wo slices, then the
  // FFN chunks; each step loads the next while it computes.
  auto load_wo = [&](int s) {  // Wo rows 64s..64s+63
    cp_tile(ring_stage<D>(ring, s), ldw2,
            wo + static_cast<size_t>(s) * kFfnSlice * D, D, kFfnSlice, D,
            kFfnSlice);
  };
  auto load_ffn = [&](int step, int c) {
    cp_tile(ring_stage<D>(ring, step), ldw1, w1 + c * kFfnHidden, F, D,
            kFfnHidden, D);
    cp_tile(ring_w2<D>(ring, step), ldw2,
            w2 + static_cast<size_t>(c) * kFfnHidden * D, D, kFfnHidden, D,
            kFfnHidden);
  };

  cp_tile(As, lda, att + static_cast<size_t>(row0) * D, D, kFfnRows, D,
          valid);
  load_wo(0);
  cp_async_commit();

  float acc[2][NI][4] = {};
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices)
      load_wo(s + 1);
    else
      load_ffn(s + 1, 0);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // slice s (and the att tile) visible
    warp_mma_kn<2, NI>(acc, As + kFfnSlice * s, lda, wm,
                       ring_stage<D>(ring, s), ldw2, wn, kFfnSlice);
    __syncthreads();  // slice s free; As no longer read
  }

  // u = x + (att @ Wo + bo) into acc, to u (x's type) and u32 (f32, read
  // back for y); LN2 statistics across the 4 warps sharing each row
  float part[2][2] = {};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + 16 * i + gq + 8 * h, c = wn + 8 * j + 2 * tq;
        float u0 = 0.f, u1 = 0.f;
        if (r < valid) {
          const size_t g = static_cast<size_t>(row0 + r) * D + c;
          const __nv_bfloat162 xv =
              *reinterpret_cast<const __nv_bfloat162*>(x + g);
          float o0 = acc[i][j][2 * h] + bo[c];
          float o1 = acc[i][j][2 * h + 1] + bo[c + 1];
          drop_pair(drop, kSiteOut, g, o0, o1);
          u0 = __low2float(xv) + o0;
          u1 = __high2float(xv) + o1;
          *reinterpret_cast<uint32_t*>(u + g) = pack_bf16(u0, u1);
          *reinterpret_cast<float2*>(u32 + g) = make_float2(u0, u1);
        }
        acc[i][j][2 * h] = u0;
        acc[i][j][2 * h + 1] = u1;
        part[i][h] += u0 + u1;
      }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float p = quad_sum(part[i][h]);
      if (tq == 0) red[(wm + 16 * i + gq + 8 * h) * 4 + wq] = p;
    }
  __syncthreads();
  float mu[2][2], rstd[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* rr = red + (wm + 16 * i + gq + 8 * h) * 4;
      mu[i][h] = (rr[0] + rr[1] + rr[2] + rr[3]) / D;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const float d0 = acc[i][j][2 * h] - mu[i][h];
        const float d1 = acc[i][j][2 * h + 1] - mu[i][h];
        v += d0 * d0 + d1 * d1;
      }
      v = quad_sum(v);
      if (tq == 0) red[(kFfnRows + wm + 16 * i + gq + 8 * h) * 4 + wq] = v;
    }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + 16 * i + gq + 8 * h;
      const float* rr = red + (kFfnRows + r) * 4;
      rstd[i][h] = rsqrtf((rr[0] + rr[1] + rr[2] + rr[3]) / D + kLnEps);
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c = wn + 8 * j + 2 * tq;
        *reinterpret_cast<uint32_t*>(As + r * lda + c) = pack_bf16(
            (acc[i][j][2 * h] - mu[i][h]) * rstd[i][h] * g2[c] + b2[c],
            (acc[i][j][2 * h + 1] - mu[i][h]) * rstd[i][h] * g2[c + 1] +
                b2[c + 1]);
      }
      if (wq == 0 && tq == 0 && r < valid) {
        const size_t g = static_cast<size_t>(row0 + r) * lanes;
        res[g + H + 2] = mu[i][h];
        res[g + H + 3] = rstd[i][h];
        for (int l = H + 4; l < lanes; ++l) res[g + l] = 0.f;
      }
    }

  float yacc[2][NI][4] = {};
  for (int c = 0; c < chunks; ++c) {
    const int step = slices + c;
    if (c + 1 < chunks) {
      load_ffn(step + 1, c + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c and LN2(u) visible
    float z[2][2][4] = {};
    warp_mma_kn<2, 2>(z, As, lda, wm, ring_stage<D>(ring, step), ldw1, wz,
                      D);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm + 16 * i + gq + 8 * h, col = wz + 8 * j + 2 * tq;
          const int hc = c * kFfnHidden + col;
          float h0 = gelu_tanh(z[i][j][2 * h] + bb1[hc]);
          float h1 = gelu_tanh(z[i][j][2 * h + 1] + bb1[hc + 1]);
          drop_pair(drop, kSiteHidden,
                    static_cast<unsigned long long>(row0 + r) * F + hc, h0,
                    h1);
          *reinterpret_cast<uint32_t*>(Hs + r * ldh + col) = pack_bf16(h0, h1);
        }
    __syncthreads();  // GELU slice complete
    warp_mma_kn<2, NI>(yacc, Hs, ldh, wm, ring_w2<D>(ring, step), ldw2, wn,
                       kFfnHidden);
    __syncthreads();  // chunk c and Hs free for reuse
  }

  // y = u + (h @ W2 + bb2); each thread reads back the u32 it wrote
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + 16 * i + gq + 8 * h, c = wn + 8 * j + 2 * tq;
        if (r < valid) {
          const size_t g = static_cast<size_t>(row0 + r) * D + c;
          const float2 uv = *reinterpret_cast<const float2*>(u32 + g);
          float z0 = yacc[i][j][2 * h] + bb2[c];
          float z1 = yacc[i][j][2 * h + 1] + bb2[c + 1];
          drop_pair(drop, kSiteFfnOut, g, z0, z1);
          *reinterpret_cast<uint32_t*>(y + g) =
              pack_bf16(uv.x + z0, uv.y + z1);
        }
      }
}

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
  const int rows = a.B * a.S, N3 = 3 * D;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };

  const size_t s1 = qkv_smem_bf16(D);
  DEVT_TRY(set_smem(ln_qkv_bf16<false>, s1));
  ln_qkv_bf16<false><<<(rows + kQkvRows - 1) / kQkvRows, kQkvThreads, s1,
                       a.stream>>>(
      h(a.x), f(a.g1), f(a.b1), h(a.wqkv), static_cast<bf16*>(a.qkv),
      static_cast<float*>(a.res), nullptr, rows, D, N3, a.H, a.lanes);
  DEVT_TRY(cudaGetLastError());

  DEVT_TRY((launch_attention_bf16<HD, false>(
      h(a.qkv), static_cast<bf16*>(a.att), static_cast<float*>(a.res), a.B,
      a.S, a.H, a.kv_len, a.lanes, a.scale, a.stream)));

  constexpr size_t s3 = ffn_smem_bf16<D>().bytes;
  DEVT_TRY(set_smem(out_ffn_bf16<D>, s3));
  out_ffn_bf16<D><<<(rows + kFfnRows - 1) / kFfnRows, kFfnThreads, s3,
                    a.stream>>>(
      h(a.x), h(a.att), h(a.wo), f(a.bo), f(a.g2), f(a.b2), h(a.w1),
      f(a.bb1), h(a.w2), f(a.bb2), static_cast<bf16*>(a.y),
      static_cast<bf16*>(a.u), static_cast<float*>(a.u32),
      static_cast<float*>(a.res), rows, a.F, a.H, a.lanes, a.drop);
  return cudaGetLastError();
}

// the bfloat16 kernels are compiled for these widths (dim, head dim)
cudaError_t launch_bf16(const Args& a) {
  const int hd = a.D / a.H;
  if (a.F % kFfnHidden) return cudaErrorInvalidValue;
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
// unused by the float route.  rate > 0 turns the dropout of the three
// sites on, drawn from `seed`.
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

extern "C" const char* devt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
