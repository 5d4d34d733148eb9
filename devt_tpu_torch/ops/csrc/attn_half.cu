// The fused attention half of a pre-norm ViT block, forward and backward,
// for Hopper (sm_90a): the attention half of an MoE block, whose FFN is
// the routed switch MoE outside any kernel.
//
// Kernel 7 (forward) computes what devt_tpu/ops/fused_block.py:
// _attn_half_fwd_kernel computes, for x (B, S, D) in bfloat16 or float:
//
//   a   = LN1(x)                          (f32 statistics)
//   qkv = a @ Wqkv                        (no bias; columns (3, H, d))
//   att = per head: softmax(q k^T * scale + mask) v, normalised after PV
//   u   = x + (att @ Wo + bo)
//   res = [lse (H), mu1, rstd1, 0...]     per row, f32, round_up(H+2, 8)
//
// Kernel 8 (backward) computes what _attn_half_bwd_kernel computes, from
// (x, the 5 parameters, res, du): dx in x's type and dg1, db1, dWqkv, dWo,
// dbo summed in f32 and cast to each parameter's type:
//
//   a = LN1(x) from the stored mu1, rstd1;  qkv = a @ Wqkv
//   datt = du @ Wo^T
//   att, dqkv = attention recompute and backward with p = exp(s - lse)
//   da = dqkv @ Wqkv^T;  dx = du + LN1'(da * g1)
//   dWo = att^T du, dWqkv = a^T dqkv, dbo = sum du,
//   dg1 = sum da * xhat1, db1 = sum da
//
// There is no dropout: the MoE block takes the unfused attention when it
// trains with dropout.  Every product's operands are rounded to x's type
// and accumulate in f32, as preferred_element_type=f32 does in the JAX
// kernels.
//
// Design.  The two TPU kernels are the first halves of the fused block's
// (_fwd_kernel, _bwd_kernel), and so are these: the forward is launch 1 of
// fused_block_fwd.cu (LN1 + qkv per 128 rows), the attention, and a third
// launch, the out-projection per 64 rows with the Wo slices streamed
// through a two-stage cp.async ring and u written from the accumulators.
// The LN1 + qkv launch is the block forward's, block_sm90.cuh's
// ln_qkv_sm90 (wgmma, TMA).  The attention in bfloat16 with at most 256 live keys at head dim 16, 32
// or 64 (one_shot_on_wgmma, as kernel 9's: every main-path shape) runs
// flash_fwd_sm90.cuh's one-shot wgmma body in its normalise-after instance
// (o = (round(p) @ v) / l, as _mha_fwd): a CTA per two 64-query tiles of a
// (sequence, head), q, k and v loaded by TMA straight from the head views
// of the qkv scratch (row stride 3D, head stride d, offsets 0, D, 2D: no
// copy), the whole score row in wgmma accumulators, o into the att
// scratch and lse into the residual lanes through strides.  Other shapes
// (more live keys) and the float route keep the block forward's
// attention, attention_fwd.cuh's (per 64 queries, head, sequence; the
// scores recomputed per pass, mma.sync).  The out-projection stays on
// mma.sync m16n8k16 fed by ldmatrix.  The backward is fused_block_bwd.cu's
// launches without the FFN: from block_sm90.cuh (wgmma, TMA) the LN1 +
// qkv recompute, datt = du @ Wo^T per 128 rows, dqkv @ Wqkv^T with the LN1
// backward, which also takes the column partials of dg1, db1 and dbo, and
// the split-K weight gradients of Wqkv and Wo in one launch; from
// block_bwd_parts.cuh the attention recompute and backward (kernel 2's:
// where block_bwd_on_wgmma says, the recompute of att, do and delta from
// the stored lse on the one-shot wgmma body, then kernels 12's and 13's
// wgmma bodies, flash_bwd_sm90.cuh) and one fixed-order sum of all
// partials.  No atomics: two runs give the same bits.  The float route
// (the comparison with the plain version on the card) is FMA products and
// elementwise kernels.
//
// Bound at the main-path shape (B=512, S=208, D=192, H=3, kv_len 197):
// the forward does 2*(3 D^2 + 2 kv_len D + D^2) operations per row, 47.5
// GFLOP, against about 85 MB of inputs and outputs (x, u, res): compute-
// bound, about 0.048 ms at 989 TFLOP/s bf16.  The backward does 2*(11 D^2
// + 6 kv_len D) per row, 134.7 GFLOP: about 0.136 ms.  The times, and the
// forward's three launches apart, are in PERF.md.

#include "block_attention.cuh"
#include "block_bwd_parts.cuh"
#include "block_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// forward, launch 3: u = x + (att @ Wo + bo), per 64 rows
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr size_t out_proj_smem() {
  // the att tile and two stages of 64 Wo rows, all 64 x (D + 8)
  return 3 * align128(sizeof(bf16) * kTileRows * (D + 8));
}

template <int D>
__global__ void __launch_bounds__(kRowThreads)
    out_proj_bf16(const bf16* __restrict__ x, const bf16* __restrict__ att,
                  const bf16* __restrict__ wo, const float* __restrict__ bo,
                  bf16* __restrict__ u, float* __restrict__ res, int rows,
                  int H, int lanes) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = D + 8;
  constexpr int NI = D / 32;  // warp tile 32 x D/4
  constexpr int slices = D / kSlice;
  constexpr size_t tile = align128(sizeof(bf16) * kTileRows * ld);
  bf16* As = reinterpret_cast<bf16*>(smem);
  auto stage = [&](int s) {
    return reinterpret_cast<bf16*>(smem + (1 + (s & 1)) * tile);
  };
  const int row0 = blockIdx.x * kTileRows;
  const int valid = min(kTileRows, rows - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * (D / 4);

  cp_tile(As, ld, att + static_cast<size_t>(row0) * D, D, kTileRows, D,
          valid);
  cp_tile(stage(0), ld, wo, D, kSlice, D, kSlice);
  cp_async_commit();
  float acc[2][NI][4] = {};
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) {
      cp_tile(stage(s + 1), ld, wo + static_cast<size_t>(s + 1) * kSlice * D,
              D, kSlice, D, kSlice);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slice s (and the att tile) visible
    warp_mma_kn<2, NI>(acc, As + kSlice * s, ld, wm, stage(s), ld, wn,
                       kSlice);
    __syncthreads();  // slice s free for the load two steps on
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + 16 * i + gq + 8 * h, c = wn + 8 * j + 2 * tq;
        if (r < valid) {
          const size_t g = static_cast<size_t>(row0 + r) * D + c;
          const __nv_bfloat162 xv =
              *reinterpret_cast<const __nv_bfloat162*>(x + g);
          *reinterpret_cast<uint32_t*>(u + g) = pack_bf16(
              __low2float(xv) + (acc[i][j][2 * h] + bo[c]),
              __high2float(xv) + (acc[i][j][2 * h + 1] + bo[c + 1]));
        }
      }
  // the residual lanes past mu1, rstd1 are 0
  const int pad = lanes - H - 2;
  for (int i = threadIdx.x; i < valid * pad; i += blockDim.x)
    res[static_cast<size_t>(row0 + i / pad) * lanes + H + 2 + i % pad] = 0.f;
}

// float route, after u = att @ Wo: u = x + (u + bo), the pad lanes 0; a
// warp per row
__global__ void resid_bias_f32(const float* __restrict__ x,
                               const float* __restrict__ bo,
                               float* __restrict__ u, float* __restrict__ res,
                               int rows, int D, int H, int lanes) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const size_t r = static_cast<size_t>(row);
  for (int c = lane; c < D; c += 32)
    u[r * D + c] = x[r * D + c] + (u[r * D + c] + bo[c]);
  for (int l = H + 2 + lane; l < lanes; l += 32) res[r * lanes + l] = 0.f;
}

// ---------------------------------------------------------------------------
// forward launches
// ---------------------------------------------------------------------------

struct FwdArgs {
  const void *x, *g1, *b1, *wqkv, *wo, *bo;
  void *u, *res, *qkv, *att;
  int B, S, D, H, kv_len, lanes;
  float scale;
  cudaStream_t stream;
};

template <int D, int HD>
cudaError_t fwd_bf16_shape(const FwdArgs& a) {
  const int rows = a.B * a.S;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };

  DEVT_TRY((launch_ln_qkv<D, false>(
      h(a.x), f(a.g1), f(a.b1), h(a.wqkv), static_cast<bf16*>(a.qkv),
      static_cast<float*>(a.res), nullptr, rows, a.H, a.lanes, a.stream)));

  // launch 2: the attention into att and the lse lanes of res
  DEVT_TRY(block_attention_bf16<HD>(
      static_cast<const bf16*>(a.qkv), static_cast<bf16*>(a.att),
      static_cast<float*>(a.res), a.B, a.S, a.H, a.kv_len, a.lanes, a.scale,
      a.stream));

  constexpr size_t s3 = out_proj_smem<D>();
  DEVT_TRY(set_smem(out_proj_bf16<D>, s3));
  out_proj_bf16<D><<<(rows + kTileRows - 1) / kTileRows, kRowThreads, s3,
                     a.stream>>>(h(a.x), h(a.att), h(a.wo), f(a.bo),
                                 static_cast<bf16*>(a.u),
                                 static_cast<float*>(a.res), rows, a.H,
                                 a.lanes);
  return cudaGetLastError();
}

cudaError_t fwd_f32(const FwdArgs& a) {
  const int D = a.D, rows = a.B * a.S, N3 = 3 * D;
  const int nt = pick_tile(64, N3, N3);
  if (!nt) return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* qkv = static_cast<float*>(a.qkv);
  float* att = static_cast<float*>(a.att);
  float* u = static_cast<float*>(a.u);
  float* res = static_cast<float*>(a.res);

  const size_t s1 = f32_qkv_smem(D, nt);
  DEVT_TRY(set_smem(ln_qkv_f32, s1));
  ln_qkv_f32<<<(rows + kF32Rows - 1) / kF32Rows, kF32Threads, s1,
               a.stream>>>(f(a.x), f(a.g1), f(a.b1), f(a.wqkv), qkv, res,
                           rows, D, N3, a.H, a.lanes, nt);
  DEVT_TRY(cudaGetLastError());
  DEVT_TRY(launch_attention_f32<false>(qkv, att, res, a.B, a.S, a.H,
                                       D / a.H, a.kv_len, a.lanes, a.scale,
                                       a.stream));
  DEVT_TRY(gemm32(att, D, 0, f(a.wo), D, 0, u, D, rows, D, D, a.stream));
  resid_bias_f32<<<(rows + 7) / 8, 256, 0, a.stream>>>(f(a.x), f(a.bo), u,
                                                       res, rows, D, a.H,
                                                       a.lanes);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward: scratch layout and launches
// ---------------------------------------------------------------------------

constexpr int kHalfGrads = 5;  // g1, b1, wqkv, wo, bo

struct HalfBwdArgs {
  const void *x, *g1, *b1, *wqkv, *wo, *bo, *res, *du;
  void* dx;
  void* grads[kHalfGrads];
  unsigned char* scratch;
  int B, S, D, H, kv_len, lanes;
  float scale;
  cudaStream_t stream;
};

struct Plan {
  size_t a, qkv, att, dqkv;       // in x's type: (rows, D), qkv (rows, 3D)
  size_t datt;                    // f32 (rows, D)
  size_t dout, delta;             // bf16 (rows, D), f32 (rows, H)
  size_t p_g1, p_b1, p_bo;        // f32 [tiles][D]
  size_t w_qkv, w_o;              // f32 [splits][M * N]
  size_t xhat1, tmp, s, dp;       // float route only
  size_t bytes;
  int tiles, splits, split_rows;
};

Plan make_plan(int dtype, int B, int S, int D, int H) {
  Plan p{};
  const size_t rows = static_cast<size_t>(B) * S;
  const size_t esz = dtype == 1 ? 2 : 4;
  // the bfloat16 route's tiles and splits are block_sm90.cuh's
  p.tiles = dtype == 1 ? blk_tiles(static_cast<int>(rows))
                       : static_cast<int>((rows + kTileRows - 1) / kTileRows);
  // the bfloat16 route's weight-gradient splits fill the card's SMs
  // (block_sm90.cuh); the float route's are kSplitRows rows
  if (dtype == 1) {
  const int wm[2] = {D, D}, wn[2] = {D, 3 * D};
  p.split_rows = wgrad_split_rows(static_cast<int>(rows), wm, wn, 2);
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
  p.att = take(rows * D * esz);
  p.dqkv = take(rows * 3 * D * esz);
  p.datt = take(rows * D * 4);
  if (dtype == 1) {
    p.dout = take(rows * D * 2);
    p.delta = take(rows * H * 4);
  }
  const size_t t = p.tiles, sp = p.splits;
  p.p_g1 = take(t * D * 4);
  p.p_b1 = take(t * D * 4);
  p.p_bo = take(t * D * 4);
  p.w_qkv = take(sp * D * 3 * D * 4);
  p.w_o = take(sp * D * D * 4);
  if (dtype == 0) {
    p.xhat1 = take(rows * D * 4);
    p.tmp = take(rows * D * 4);
    p.s = take(static_cast<size_t>(B) * H * S * S * 4);
    p.dp = take(static_cast<size_t>(B) * H * S * S * 4);
  }
  p.bytes = at;
  return p;
}

// sums of all the partials into the 5 gradients
cudaError_t launch_reduce(const HalfBwdArgs& a, const Plan& p,
                          int mat_bf16) {
  const int D = a.D;
  auto f = [&](size_t off) {
    return reinterpret_cast<const float*>(a.scratch + off);
  };
  Segments segs{};
  segs.s[0] = {f(p.p_g1), a.grads[0], D, p.tiles, 0};
  segs.s[1] = {f(p.p_b1), a.grads[1], D, p.tiles, 0};
  segs.s[2] = {f(p.w_qkv), a.grads[2], D * 3 * D, p.splits, mat_bf16};
  segs.s[3] = {f(p.w_o), a.grads[3], D * D, p.splits, mat_bf16};
  segs.s[4] = {f(p.p_bo), a.grads[4], D, p.tiles, 0};
  reduce_parts<<<dim3(256, kHalfGrads), 256, 0, a.stream>>>(segs);
  return cudaGetLastError();
}

template <int D, int HD>
cudaError_t bwd_bf16_shape(const HalfBwdArgs& a, const Plan& p) {
  const int rows = a.B * a.S, N3 = 3 * D;
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  auto h = [](const void* q) { return static_cast<const bf16*>(q); };
  auto sb = [&](size_t off) { return reinterpret_cast<bf16*>(a.scratch + off); };
  auto sf = [&](size_t off) {
    return reinterpret_cast<float*>(a.scratch + off);
  };
  const float* res = f(a.res);
  const bf16* du = h(a.du);

  DEVT_TRY((launch_ln_qkv<D, true>(h(a.x), f(a.g1), f(a.b1), h(a.wqkv),
                                   sb(p.qkv), const_cast<float*>(res),
                                   sb(p.a), rows, a.H, a.lanes, a.stream)));

  RowEpi plain{};
  plain.out_f32 = sf(p.datt);
  DEVT_TRY((launch_row_nk<D, kPlain>(du, D, h(a.wo), plain, rows,
                                     a.stream)));

  DEVT_TRY(block_attention_bwd_bf16<HD>(
      sb(p.qkv), sf(p.datt), res, sb(p.att), sb(p.dqkv), sb(p.dout),
      sf(p.delta), a.B, a.S, a.H, a.kv_len, a.lanes, a.scale, a.stream));

  RowEpi ln1{};
  ln1.out_bf16 = static_cast<bf16*>(a.dx);
  ln1.src = h(a.x);
  ln1.res = res;
  ln1.gamma = f(a.g1);
  ln1.resid_bf16 = du;
  ln1.part_g = sf(p.p_g1);
  ln1.part_b = sf(p.p_b1);
  ln1.part_o = sf(p.p_bo);
  ln1.stat = a.H;
  ln1.lanes = a.lanes;
  DEVT_TRY((launch_row_nk<D, kLn1Du>(sb(p.dqkv), N3, h(a.wqkv), ln1, rows,
                                     a.stream)));

  const WgSpec specs[2] = {{sb(p.att), du, D, D, sf(p.w_o)},
                           {sb(p.a), sb(p.dqkv), D, N3, sf(p.w_qkv)}};
  DEVT_TRY(launch_wgrad(specs, 2, rows, p.split_rows, a.stream));
  return launch_reduce(a, p, 1);
}

cudaError_t bwd_f32(const HalfBwdArgs& a, const Plan& p) {
  const int D = a.D, H = a.H, N3 = 3 * D, rows = a.B * a.S;
  const cudaStream_t st = a.stream;
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  auto sf = [&](size_t off) {
    return reinterpret_cast<float*>(a.scratch + off);
  };
  const float *x = f(a.x), *res = f(a.res), *du = f(a.du);
  const float *wqkv = f(a.wqkv), *wo = f(a.wo);
  float *av = sf(p.a), *qkv = sf(p.qkv), *att = sf(p.att);
  float *dqkv = sf(p.dqkv), *datt = sf(p.datt), *xhat1 = sf(p.xhat1);
  float* da = sf(p.tmp);
  const int row_blocks = (rows + 7) / 8;  // a warp per row, 8 warps a block

  ln_apply_f32<<<row_blocks, 256, 0, st>>>(x, res, H, a.lanes, f(a.g1),
                                           f(a.b1), xhat1, av, rows, D);
  DEVT_TRY(cudaGetLastError());
  DEVT_TRY(gemm32(av, D, 0, wqkv, N3, 0, qkv, N3, rows, N3, D, st));
  DEVT_TRY(gemm32(du, D, 0, wo, D, 1, datt, D, rows, D, D, st));
  DEVT_TRY(colsum32(du, nullptr, sf(p.p_bo), rows, D, st));
  DEVT_TRY(attention_bwd_f32(qkv, datt, res, att, dqkv, sf(p.s), sf(p.dp),
                             a.B, a.S, D, H, a.kv_len, a.lanes, a.scale, st));
  DEVT_TRY(gemm32(dqkv, N3, 0, wqkv, N3, 1, da, D, rows, D, N3, st));
  DEVT_TRY(colsum32(da, xhat1, sf(p.p_g1), rows, D, st));
  DEVT_TRY(colsum32(da, nullptr, sf(p.p_b1), rows, D, st));
  ln_bwd_f32<<<row_blocks, 256, 0, st>>>(da, xhat1, res, H, a.lanes, f(a.g1),
                                         du, static_cast<float*>(a.dx), rows,
                                         D);
  DEVT_TRY(cudaGetLastError());
  DEVT_TRY(wgrad32(att, D, du, D, sf(p.w_o), rows, st));
  DEVT_TRY(wgrad32(av, D, dqkv, N3, sf(p.w_qkv), rows, st));
  return launch_reduce(a, p, 0);
}

bool bad_shape(int B, int S, int D, int H, int kv_len, int lanes) {
  return B < 1 || S < 1 || H < 1 || D % H || (D / H) % 16 || D % 16 ||
         kv_len < 1 || kv_len > S || lanes < H + 2;
}

}  // namespace

// Kernel 7.  dtype: 0 = float32, 1 = bfloat16.  Weight matrices are in
// x's type and in the (K, N) layout of the JAX kernel; g1, b1, bo are f32.
// u (B, S, D) in x's type; res (B, S, lanes) f32.  qkv (B, S, 3D) and att
// (B, S, D) are scratch in x's type, in bfloat16 16-byte aligned (TMA
// reads the head views of qkv).  The bfloat16 route is compiled for
// (D, D / H) = (192, 64) and (64, 32); its attention launch takes the
// one-shot wgmma body where devt_attn_half_route says.  Returns the CUDA
// error of the launches (0 on success); they are asynchronous on
// `stream`.
extern "C" int devt_attn_half_fwd(int dtype, const void* x, const void* g1,
                                  const void* b1, const void* wqkv,
                                  const void* wo, const void* bo, void* u,
                                  void* res, void* qkv, void* att, int B,
                                  int S, int D, int H, int kv_len, int lanes,
                                  float scale, void* stream) {
  if (bad_shape(B, S, D, H, kv_len, lanes)) return cudaErrorInvalidValue;
  const FwdArgs a{x, g1, b1, wqkv, wo, bo, u, res, qkv, att, B, S, D, H,
                  kv_len, lanes, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return fwd_f32(a);
  if (dtype != 1) return cudaErrorInvalidValue;
  if (D == 192 && D / H == 64) return fwd_bf16_shape<192, 64>(a);
  if (D == 64 && D / H == 32) return fwd_bf16_shape<64, 32>(a);
  return cudaErrorInvalidValue;
}

// 1 when kernel 7's attention launch of this dtype (0 float32, 1
// bfloat16), head dim and kv_len takes flash_fwd_sm90.cuh's one-shot body
extern "C" int devt_attn_half_route(int dtype, int d, int kv_len) {
  return one_shot_on_wgmma(dtype, d, kv_len) ? 1 : 0;
}

// 1 when the attention backward of kernel 8 (and of kernel 2) in this
// dtype, head dim and kv_len takes the wgmma route of
// block_attention_bwd_bf16 (block_bwd_on_wgmma)
extern "C" int devt_attn_half_bwd_route(int dtype, int d, int kv_len) {
  return block_bwd_on_wgmma(dtype, d, kv_len) ? 1 : 0;
}

// Bytes of scratch a call of devt_attn_half_bwd needs at this shape (0 for
// a shape it does not take).
extern "C" unsigned long long devt_attn_half_bwd_scratch(int dtype, int B,
                                                         int S, int D,
                                                         int H) {
  if ((dtype != 0 && dtype != 1) || bad_shape(B, S, D, H, 1, H + 2))
    return 0;
  return make_plan(dtype, B, S, D, H).bytes;
}

// Kernel 8.  dtype as above; x, du, dx and the weight matrices and their
// gradients are in x's type, res and g1, b1, bo and their gradients f32.
// grads holds the 5 gradient pointers in the order g1, b1, wqkv, wo, bo.
// scratch is a buffer of devt_attn_half_bwd_scratch bytes, 256-byte
// aligned.  The bfloat16 route needs S a multiple of 16 and one head's q,
// k, v and datt in a block's shared memory; x, du and the weight matrices
// 16-byte aligned (TMA reads them).
extern "C" int devt_attn_half_bwd(int dtype, const void* x, const void* g1,
                                  const void* b1, const void* wqkv,
                                  const void* wo, const void* bo,
                                  const void* res, const void* du, void* dx,
                                  void* const* grads, void* scratch, int B,
                                  int S, int D, int H, int kv_len, int lanes,
                                  float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || bad_shape(B, S, D, H, kv_len, lanes))
    return cudaErrorInvalidValue;
  HalfBwdArgs a{};
  a.x = x, a.g1 = g1, a.b1 = b1, a.wqkv = wqkv, a.wo = wo, a.bo = bo;
  a.res = res, a.du = du, a.dx = dx;
  for (int i = 0; i < kHalfGrads; ++i) a.grads[i] = grads[i];
  a.scratch = static_cast<unsigned char*>(scratch);
  a.B = B, a.S = S, a.D = D, a.H = H, a.kv_len = kv_len, a.lanes = lanes;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(dtype, B, S, D, H);
  if (p.bytes == 0) return cudaErrorInvalidValue;
  if (dtype == 0) return bwd_f32(a, p);
  if (S % 16) return cudaErrorInvalidValue;
  if (D == 192 && D / H == 64) return bwd_bf16_shape<192, 64>(a, p);
  if (D == 64 && D / H == 32) return bwd_bf16_shape<64, 32>(a, p);
  return cudaErrorInvalidValue;
}

extern "C" const char* devt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
