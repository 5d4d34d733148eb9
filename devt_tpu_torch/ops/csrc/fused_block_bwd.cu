// Fused pre-norm ViT block backward for Hopper (sm_90a).
//
// Computes what devt_tpu/ops/fused_block.py:_bwd_kernel computes, from
// (x, the 11 parameters, the stored u and residual lanes, dy[, seed]):
// dx in x's type and the 11 parameter gradients, accumulated in f32 and
// cast to the parameter's type.
//
//   a    = LN1(x), b = LN2(u)            from the stored mu/rstd: no
//                                        re-reduction over the features
//   qkv  = a @ Wqkv,  z1 = b @ W1 + bb1,  h = drop(gelu(z1))
//   dz2  = drop(dy);  dh = drop(dz2 @ W2^T);  dz1 = dh * gelu'(z1)
//   db   = dz1 @ W1^T;  du = dy + LN2'(db);  doproj = drop(du)
//   datt = doproj @ Wo^T
//   att, dqkv = attention recompute and backward with p = exp(s - lse)
//   da   = dqkv @ Wqkv^T;  dx = du + LN1'(da)
//   dW2 = h^T dz2, dW1 = b^T dz1, dWo = att^T doproj, dWqkv = a^T dqkv
//   dbb2 = sum dz2, dbb1 = sum dz1, dbo = sum doproj,
//   dg2 = sum db * xhat2, db2 = sum db, dg1 = sum da * xhat1, db1 = sum da
//
// Every product's operands are rounded to x's type and accumulate in f32;
// the bias and LN-parameter sums take the unrounded f32 values.  The
// dropout masks are regenerated from the seed (fused_block_common.cuh).
//
// Design.  The TPU kernel walks its grid in order and accumulates the
// parameter gradients into output blocks that stay resident.  CUDA blocks
// run concurrently, so the reductions over all B*S rows are split in two:
//
//   * every row-tile kernel writes the column sums of its 128 rows to a
//     partial buffer [tile][column];
//   * the four weight gradients are split-K products over operands that
//     the row kernels leave in global memory in x's type (the roundings
//     the TPU kernel applies before those products), all four in one
//     launch: each CTA owns a 128-row output tile, wgrad_bn columns wide
//     (192, 128 or 64), and one split of the contraction's rows, the
//     splits as many as fill the SMs once (wgrad_split_rows), and writes
//     an f32 partial;
//   * one last kernel sums the partials of each gradient in index order
//     and casts.  No atomics: two runs give the same bits.
//
// The bfloat16 route is ten launches, the products on wgmma with TMA
// weight rings (block_sm90.cuh), the attention backward on wgmma too:
//   1. ln_qkv_sm90<D, true>   a, qkv                         per 128 rows
//   2. ffn_dual_sm90          b, h, dz1 (z1 and dh of one hidden slice
//                             stay in registers), dbb1, dbb2  per 128 rows
//   3. row_nk_sm90<kLn2>      db = dz1 @ W1^T, LN2 backward, du, doproj,
//                             dg2, db2, dbo                   per 128 rows
//   4. row_nk_sm90<kPlain>    datt = doproj @ Wo^T (f32)      per 128 rows
//   5. the attention backward (block_bwd_parts.cuh:
//                             block_attention_bwd_bf16), where
//                             block_bwd_on_wgmma says (every main-path
//                             shape) three launches: block_bwd_pre_sm90
//                             recomputes p from the stored lse on the
//                             one-shot wgmma body and writes att, do =
//                             round(datt) and delta from the f32 datt and
//                             o; block_bwd_dq_sm90 and block_bwd_dkv_sm90,
//                             kernels 12's and 13's wgmma bodies, read that
//                             delta and store dq, dk, dv into dqkv by
//                             strides.  Elsewhere attention_bwd_bf16 per
//                             (head, sequence) on mma.sync.  Keys past
//                             kv_len have p = 0 exactly: their dk, dv are
//                             written as 0.
//   6. row_nk_sm90<kLn1>      da = dqkv @ Wqkv^T, LN1 backward, dx, dg1,
//                             db1                             per 128 rows
//   7. wgrad_sm90             the four split-K weight gradients
//   8. reduce_parts           fixed-order sums and casts
// The float route (the tests' f32 runs, not on the training path) is the
// same arithmetic from a generic FMA product and elementwise kernels, with
// every intermediate in global memory.  Launches 1 and 3-8 are shared
// with the attention half's backward (kernel 8, attn_half.cu).
//
// Bound at the main-path shape (B=512, S=208, D=192, H=3, MLP 768, kv_len
// 197): 2*(11 D^2 + 5 D MLP + 6 kv_len D) operations per row, 291.7 GFLOP,
// against about 0.17 GB of inputs and outputs: compute-bound, about
// 0.295 ms at 989 TFLOP/s bf16.  The times are in PERF.md.

#include "block_bwd_parts.cuh"
#include "block_sm90.cuh"

namespace {

// ===========================================================================
// float route: elementwise kernels
// ===========================================================================

// z1 += bb1 in place; h = drop(gelu(z1))
__global__ void ffn_fwd_elem_f32(float* __restrict__ z1,
                                 const float* __restrict__ bb1,
                                 float* __restrict__ h, size_t n, int F,
                                 Drop drop) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float z = z1[i] + bb1[i % F];
    z1[i] = z;
    h[i] = drop_one(drop, kSiteHidden, i, gelu_tanh(z));
  }
}

// dz1 = drop(dh) * gelu'(z1), in place over dh
__global__ void ffn_bwd_elem_f32(float* __restrict__ dh,
                                 const float* __restrict__ z1, size_t n,
                                 Drop drop) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride)
    dh[i] = drop_one(drop, kSiteHidden, i, dh[i]) * dgelu_tanh(z1[i]);
}

// out = drop(in) at `site`
__global__ void drop_elem_f32(const float* __restrict__ in,
                              float* __restrict__ out, size_t n, uint32_t site,
                              Drop drop) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = drop_one(drop, site, i, in[i]);
}

// ===========================================================================
// scratch layout and launches
// ===========================================================================

struct Args {
  const void *x, *g1, *b1, *wqkv, *wo, *bo, *g2, *b2, *w1, *bb1, *w2, *bb2;
  const void *u, *res, *dy;
  void* dx;
  void* grads[kSegments];  // in the order of the parameters above
  unsigned char* scratch;
  int B, S, D, H, F, kv_len, lanes;
  float scale;
  Drop drop;
  cudaStream_t stream;
};

struct Plan {
  // in x's type: (rows, D) but qkv, dqkv (rows, 3D) and h, dz1 (rows, F)
  size_t a, qkv, b, h, dz1, dz2, doproj, att, dqkv;
  size_t du, datt;                                    // f32 (rows, D)
  size_t dout, delta;  // the attention's do (rows, D) bf16, delta (rows, H)
  size_t p_g1, p_b1, p_bo, p_g2, p_b2, p_bb1, p_bb2;  // f32 [tiles][n]
  size_t w_qkv, w_o, w_1, w_2;                        // f32 [splits][M*N]
  size_t xhat1, xhat2, tmp, z1, s, dp;                // float route only
  size_t bytes;
  int tiles, splits, split_rows;
};

Plan make_plan(int dtype, int B, int S, int D, int H, int F) {
  Plan p{};
  const size_t rows = static_cast<size_t>(B) * S;
  const size_t esz = dtype == 1 ? 2 : 4;
  // the bfloat16 route's tiles and splits are block_sm90.cuh's
  p.tiles = dtype == 1 ? blk_tiles(static_cast<int>(rows))
                       : static_cast<int>((rows + kTileRows - 1) / kTileRows);
  // the bfloat16 route's weight-gradient splits fill the card's SMs
  // (block_sm90.cuh); the float route's are kSplitRows rows
  if (dtype == 1) {
  const int wm[4] = {F, D, D, D}, wn[4] = {D, F, D, 3 * D};
  p.split_rows = wgrad_split_rows(static_cast<int>(rows), wm, wn, 4);
    if (p.split_rows == 0) return p;  // no card: bytes 0
  } else {
    p.split_rows = kSplitRows;
  }
  p.splits = static_cast<int>((rows + p.split_rows - 1) / p.split_rows);
  size_t at = 0;
  auto take = [&](size_t bytes) {
    const size_t o = at;
    at += (bytes + 255) & ~static_cast<size_t>(255);
    return o;
  };
  p.a = take(rows * D * esz);
  p.qkv = take(rows * 3 * D * esz);
  p.b = take(rows * D * esz);
  p.h = take(rows * F * esz);
  p.dz1 = take(rows * F * esz);
  p.dz2 = take(rows * D * esz);
  p.doproj = take(rows * D * esz);
  p.att = take(rows * D * esz);
  p.dqkv = take(rows * 3 * D * esz);
  p.du = take(rows * D * 4);
  p.datt = take(rows * D * 4);
  if (dtype == 1) {
    p.dout = take(rows * D * 2);
    p.delta = take(rows * H * 4);
  }
  const size_t t = p.tiles, sp = p.splits;
  p.p_g1 = take(t * D * 4);
  p.p_b1 = take(t * D * 4);
  p.p_bo = take(t * D * 4);
  p.p_g2 = take(t * D * 4);
  p.p_b2 = take(t * D * 4);
  p.p_bb1 = take(t * F * 4);
  p.p_bb2 = take(t * D * 4);
  p.w_qkv = take(sp * D * 3 * D * 4);
  p.w_o = take(sp * D * D * 4);
  p.w_1 = take(sp * D * F * 4);
  p.w_2 = take(sp * F * D * 4);
  if (dtype == 0) {
    p.xhat1 = take(rows * D * 4);
    p.xhat2 = take(rows * D * 4);
    p.tmp = take(rows * D * 4);
    p.z1 = take(rows * F * 4);
    p.s = take(static_cast<size_t>(B) * H * S * S * 4);
    p.dp = take(static_cast<size_t>(B) * H * S * S * 4);
  }
  p.bytes = at;
  return p;
}

// sums of all the partials into the 11 gradients
cudaError_t launch_reduce(const Args& a, const Plan& p, int mat_bf16) {
  const int D = a.D, F = a.F;
  auto f = [&](size_t off) {
    return reinterpret_cast<const float*>(a.scratch + off);
  };
  Segments segs{};
  // g1, b1, wqkv, wo, bo, g2, b2, w1, bb1, w2, bb2
  segs.s[0] = {f(p.p_g1), a.grads[0], D, p.tiles, 0};
  segs.s[1] = {f(p.p_b1), a.grads[1], D, p.tiles, 0};
  segs.s[2] = {f(p.w_qkv), a.grads[2], D * 3 * D, p.splits, mat_bf16};
  segs.s[3] = {f(p.w_o), a.grads[3], D * D, p.splits, mat_bf16};
  segs.s[4] = {f(p.p_bo), a.grads[4], D, p.tiles, 0};
  segs.s[5] = {f(p.p_g2), a.grads[5], D, p.tiles, 0};
  segs.s[6] = {f(p.p_b2), a.grads[6], D, p.tiles, 0};
  segs.s[7] = {f(p.w_1), a.grads[7], D * F, p.splits, mat_bf16};
  segs.s[8] = {f(p.p_bb1), a.grads[8], F, p.tiles, 0};
  segs.s[9] = {f(p.w_2), a.grads[9], F * D, p.splits, mat_bf16};
  segs.s[10] = {f(p.p_bb2), a.grads[10], D, p.tiles, 0};
  reduce_parts<<<dim3(256, kSegments), 256, 0, a.stream>>>(segs);
  return cudaGetLastError();
}

template <int D, int HD>
cudaError_t launch_bf16_shape(const Args& a, const Plan& p) {
  const int rows = a.B * a.S, N3 = 3 * D, F = a.F;
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  auto h = [](const void* q) { return static_cast<const bf16*>(q); };
  auto sb = [&](size_t off) { return reinterpret_cast<bf16*>(a.scratch + off); };
  auto sf = [&](size_t off) {
    return reinterpret_cast<float*>(a.scratch + off);
  };
  const float* res = f(a.res);
  const bf16* dz2 = a.drop.on ? sb(p.dz2) : h(a.dy);

  DEVT_TRY((launch_ln_qkv<D, true>(h(a.x), f(a.g1), f(a.b1), h(a.wqkv),
                                   sb(p.qkv), const_cast<float*>(res),
                                   sb(p.a), rows, a.H, a.lanes, a.stream)));
  DEVT_TRY(launch_ffn_dual<D>(h(a.u), h(a.dy), res, f(a.g2), f(a.b2),
                              h(a.w1), f(a.bb1), h(a.w2), sb(p.b), sb(p.h),
                              sb(p.dz1), sb(p.dz2), sf(p.p_bb1),
                              sf(p.p_bb2), rows, F, a.H, a.lanes, a.drop,
                              a.stream));

  RowEpi ln2{};
  ln2.out_f32 = sf(p.du);
  ln2.out_bf16 = sb(p.doproj);
  ln2.src = h(a.u);
  ln2.res = res;
  ln2.gamma = f(a.g2);
  ln2.resid_bf16 = h(a.dy);
  ln2.part_g = sf(p.p_g2);
  ln2.part_b = sf(p.p_b2);
  ln2.part_o = sf(p.p_bo);
  ln2.stat = a.H + 2;
  ln2.lanes = a.lanes;
  ln2.drop = a.drop;
  DEVT_TRY((launch_row_nk<D, kLn2>(sb(p.dz1), F, h(a.w1), ln2, rows,
                                   a.stream)));

  RowEpi plain{};
  plain.out_f32 = sf(p.datt);
  DEVT_TRY((launch_row_nk<D, kPlain>(sb(p.doproj), D, h(a.wo), plain, rows,
                                     a.stream)));

  DEVT_TRY(block_attention_bwd_bf16<HD>(
      sb(p.qkv), sf(p.datt), res, sb(p.att), sb(p.dqkv), sb(p.dout),
      sf(p.delta), a.B, a.S, a.H, a.kv_len, a.lanes, a.scale, a.stream));

  RowEpi ln1{};
  ln1.out_bf16 = static_cast<bf16*>(a.dx);
  ln1.src = h(a.x);
  ln1.res = res;
  ln1.gamma = f(a.g1);
  ln1.resid_f32 = sf(p.du);
  ln1.part_g = sf(p.p_g1);
  ln1.part_b = sf(p.p_b1);
  ln1.stat = a.H;
  ln1.lanes = a.lanes;
  DEVT_TRY((launch_row_nk<D, kLn1>(sb(p.dqkv), N3, h(a.wqkv), ln1, rows,
                                   a.stream)));

  const WgSpec specs[4] = {{sb(p.h), dz2, F, D, sf(p.w_2)},
                           {sb(p.b), sb(p.dz1), D, F, sf(p.w_1)},
                           {sb(p.att), sb(p.doproj), D, D, sf(p.w_o)},
                           {sb(p.a), sb(p.dqkv), D, N3, sf(p.w_qkv)}};
  DEVT_TRY(launch_wgrad(specs, 4, rows, p.split_rows, a.stream));
  return launch_reduce(a, p, 1);
}

// the bfloat16 kernels are compiled for these widths (dim, head dim)
cudaError_t launch_bf16(const Args& a, const Plan& p) {
  const int hd = a.D / a.H;
  if (a.F % kHidden || a.S % 16) return cudaErrorInvalidValue;
  if (a.D == 192 && hd == 64) return launch_bf16_shape<192, 64>(a, p);
  if (a.D == 64 && hd == 32) return launch_bf16_shape<64, 32>(a, p);
  return cudaErrorInvalidValue;
}

cudaError_t launch_f32(const Args& a, const Plan& p) {
  const int D = a.D, F = a.F, H = a.H, S = a.S, N3 = 3 * D;
  const int rows = a.B * S;
  const cudaStream_t st = a.stream;
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  auto sf = [&](size_t off) {
    return reinterpret_cast<float*>(a.scratch + off);
  };
  const float *x = f(a.x), *u = f(a.u), *dy = f(a.dy), *res = f(a.res);
  const float *wqkv = f(a.wqkv), *wo = f(a.wo), *w1 = f(a.w1), *w2 = f(a.w2);
  float *av = sf(p.a), *qkv = sf(p.qkv), *bv = sf(p.b), *hv = sf(p.h);
  float *dz1 = sf(p.dz1), *doproj = sf(p.doproj), *att = sf(p.att);
  float *dqkv = sf(p.dqkv), *du = sf(p.du), *datt = sf(p.datt);
  float *xhat1 = sf(p.xhat1), *xhat2 = sf(p.xhat2), *tmp = sf(p.tmp);
  float *z1 = sf(p.z1), *sbuf = sf(p.s), *dpbuf = sf(p.dp);
  const size_t n_d = static_cast<size_t>(rows) * D;
  const size_t n_f = static_cast<size_t>(rows) * F;
  const int row_blocks = (rows + 7) / 8;  // a warp per row, 8 warps a block
  const int elem_blocks = 2048;

  auto colsum = [&](const float* A, const float* Bm, size_t part, int n) {
    return colsum32(A, Bm, sf(part), rows, n, st);
  };

  // recompute: a, b, qkv, z1, h
  ln_apply_f32<<<row_blocks, 256, 0, st>>>(x, res, H, a.lanes, f(a.g1),
                                           f(a.b1), xhat1, av, rows, D);
  DEVT_TRY(cudaGetLastError());
  ln_apply_f32<<<row_blocks, 256, 0, st>>>(u, res, H + 2, a.lanes, f(a.g2),
                                           f(a.b2), xhat2, bv, rows, D);
  DEVT_TRY(cudaGetLastError());
  DEVT_TRY(gemm32(av, D, 0, wqkv, N3, 0, qkv, N3, rows, N3, D, st));
  DEVT_TRY(gemm32(bv, D, 0, w1, F, 0, z1, F, rows, F, D, st));
  ffn_fwd_elem_f32<<<elem_blocks, 256, 0, st>>>(z1, f(a.bb1), hv, n_f, F,
                                                a.drop);
  DEVT_TRY(cudaGetLastError());

  // FFN backward
  const float* dz2 = dy;
  if (a.drop.on) {
    drop_elem_f32<<<elem_blocks, 256, 0, st>>>(dy, sf(p.dz2), n_d,
                                               kSiteFfnOut, a.drop);
    DEVT_TRY(cudaGetLastError());
    dz2 = sf(p.dz2);
  }
  DEVT_TRY(gemm32(dz2, D, 0, w2, D, 1, dz1, F, rows, F, D, st));
  ffn_bwd_elem_f32<<<elem_blocks, 256, 0, st>>>(dz1, z1, n_f, a.drop);
  DEVT_TRY(cudaGetLastError());
  DEVT_TRY(gemm32(dz1, F, 0, w1, F, 1, tmp, D, rows, D, F, st));  // db
  DEVT_TRY(colsum(dz2, nullptr, p.p_bb2, D));
  DEVT_TRY(colsum(dz1, nullptr, p.p_bb1, F));
  DEVT_TRY(colsum(tmp, xhat2, p.p_g2, D));
  DEVT_TRY(colsum(tmp, nullptr, p.p_b2, D));
  ln_bwd_f32<<<row_blocks, 256, 0, st>>>(tmp, xhat2, res, H + 2, a.lanes,
                                         f(a.g2), dy, du, rows, D);
  DEVT_TRY(cudaGetLastError());
  drop_elem_f32<<<elem_blocks, 256, 0, st>>>(du, doproj, n_d, kSiteOut,
                                             a.drop);
  DEVT_TRY(cudaGetLastError());
  DEVT_TRY(colsum(doproj, nullptr, p.p_bo, D));
  DEVT_TRY(gemm32(doproj, D, 0, wo, D, 1, datt, D, rows, D, D, st));

  // attention, batched over (sequence, head)
  DEVT_TRY(attention_bwd_f32(qkv, datt, res, att, dqkv, sbuf, dpbuf, a.B, S,
                             D, H, a.kv_len, a.lanes, a.scale, st));

  // qkv projection and LN1 backward
  DEVT_TRY(gemm32(dqkv, N3, 0, wqkv, N3, 1, tmp, D, rows, D, N3, st));  // da
  DEVT_TRY(colsum(tmp, xhat1, p.p_g1, D));
  DEVT_TRY(colsum(tmp, nullptr, p.p_b1, D));
  ln_bwd_f32<<<row_blocks, 256, 0, st>>>(tmp, xhat1, res, H, a.lanes, f(a.g1),
                                         du, static_cast<float*>(a.dx), rows,
                                         D);
  DEVT_TRY(cudaGetLastError());

  // weight gradients, split over the rows
  auto wgrad = [&](const float* A, int M, const float* Bm, int N,
                   size_t part) {
    return wgrad32(A, M, Bm, N, sf(part), rows, st);
  };
  DEVT_TRY(wgrad(hv, F, dz2, D, p.w_2));
  DEVT_TRY(wgrad(bv, D, dz1, F, p.w_1));
  DEVT_TRY(wgrad(att, D, doproj, D, p.w_o));
  DEVT_TRY(wgrad(av, D, dqkv, N3, p.w_qkv));
  return launch_reduce(a, p, 0);
}

bool bad_shape(int B, int S, int D, int H, int F, int kv_len, int lanes) {
  return B < 1 || S < 1 || H < 1 || D % H || (D / H) % 16 || D % 16 ||
         F % 16 || kv_len < 1 || kv_len > S || lanes < H + 4;
}

}  // namespace

// Bytes of scratch a call of devt_fused_block_bwd needs at this shape
// (0 for a shape it does not take).
extern "C" unsigned long long devt_fused_block_bwd_scratch(int dtype, int B,
                                                           int S, int D,
                                                           int H, int F) {
  if ((dtype != 0 && dtype != 1) || bad_shape(B, S, D, H, F, 1, H + 4))
    return 0;
  return make_plan(dtype, B, S, D, H, F).bytes;
}

// dtype: 0 = float32, 1 = bfloat16.  x, u, dy, dx (B, S, D) and the weight
// matrices and their gradients are in x's type, matrices in the (K, N)
// layout of the JAX kernel; res (B, S, lanes), LN parameters, biases and
// their gradients are f32.  grads holds the 11 gradient pointers in the
// order g1, b1, wqkv, wo, bo, g2, b2, w1, bb1, w2, bb2.  scratch is a
// buffer of devt_fused_block_bwd_scratch bytes, 256-byte aligned.  In
// bfloat16, dy and the weight matrices are 16-byte aligned (TMA reads
// them).  rate > 0 regenerates the forward's dropout masks from `seed`.
// Returns the CUDA error of the launches (0 on success); the launches are
// asynchronous on `stream`.
extern "C" int devt_fused_block_bwd(
    int dtype, const void* x, const void* g1, const void* b1,
    const void* wqkv, const void* wo, const void* bo, const void* g2,
    const void* b2, const void* w1, const void* bb1, const void* w2,
    const void* bb2, const void* u, const void* res, const void* dy, void* dx,
    void* const* grads, void* scratch, int B, int S, int D, int H, int F,
    int kv_len, int lanes, float scale, double rate, unsigned long long seed,
    void* stream) {
  if ((dtype != 0 && dtype != 1) || bad_shape(B, S, D, H, F, kv_len, lanes) ||
      rate < 0.0 || rate >= 1.0)
    return cudaErrorInvalidValue;
  Args a{};
  a.x = x, a.g1 = g1, a.b1 = b1, a.wqkv = wqkv, a.wo = wo, a.bo = bo;
  a.g2 = g2, a.b2 = b2, a.w1 = w1, a.bb1 = bb1, a.w2 = w2, a.bb2 = bb2;
  a.u = u, a.res = res, a.dy = dy, a.dx = dx;
  for (int i = 0; i < kSegments; ++i) a.grads[i] = grads[i];
  a.scratch = static_cast<unsigned char*>(scratch);
  a.B = B, a.S = S, a.D = D, a.H = H, a.F = F, a.kv_len = kv_len;
  a.lanes = lanes, a.scale = scale;
  a.drop = make_drop(rate, seed);
  a.stream = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(dtype, B, S, D, H, F);
  if (p.bytes == 0) return cudaErrorInvalidValue;
  return dtype == 0 ? launch_f32(a, p) : launch_bf16(a, p);
}

// 1 when kernel 2's attention backward in this dtype (0 float32, 1
// bfloat16), head dim and kv_len takes the wgmma route of
// block_attention_bwd_bf16 (block_bwd_on_wgmma)
extern "C" int devt_fused_block_bwd_route(int dtype, int d, int kv_len) {
  return block_bwd_on_wgmma(dtype, d, kv_len) ? 1 : 0;
}

extern "C" const char* devt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
