// The packed-qkv attention forward (kernel 3, mha_fwd.cu) on Hopper's wgmma
// and TMA, for short sequences at wide heads: several sequences of one head
// share a 64-row tile.
//
//   mha_fwd_packed<d>   devt_tpu/ops/flash_attention.py:558 _mha_fwd_kernel,
//                       grouped by _mha_group (:643) for the same reason:
//                       bf16, head dim 128 or 256, S <= 64, no dropout
//
// Per (sequence, head) what the TPU kernel computes: s = q k^T * scale in
// f32 with keys >= kv_len masked; m = max s, p = exp(s - m), l = sum p;
// o = round_bf16(p / l) @ v in f32, stored in bf16; lse = m + log l.  q, k
// and v are the (3, H, d) column blocks of qkv (B, S, 3*H*d); o is
// (B, S, H*d), lse (B, S, H).  p / l is the IEEE division the TPU kernel
// takes (not p times a reciprocal), so each probability rounds to bf16 from
// the same f32 value as in the plain version, up to the exponential's last
// bits (ex2.approx against the CPU's exp).
//
// The rule (mha_fwd_route, mirrored by ops/flash_attention.py
// mha_fwd_on_wgmma): bf16 at rate 0 takes this body for d in {128, 256} and
// S <= 64 (PTN's serving and training shapes, S = 14, 8 heads of 256), and
// kernel 9's one-shot instance (flash_fwd_sm90.cuh) for d in {16, 32, 64}
// with kv_len <= 256 (the blocks the fused kernels do not take, at the ViT
// shape); dropout, float and d in {128, 256} at S > 64 stay on
// attention_fwd.cuh's streamed body.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W): at PTN serving's
// (256, 14, 6144), 8 heads of 256, qkv in and o, lse out are 59 MB, 0.0176
// ms at 3.35 TB/s; the products are 0.4 GFLOP.  The streamed body took a
// block per 64 queries of one (sequence, head): at S = 14 one warp of four
// held rows, computed each score six times (a max pass, an l pass, four
// passes of 64 output columns), and waited for its whole load before its
// first product, so nothing overlapped the loads.
//
// Design.  A 64-row tile holds G = 64 / S whole sequences of one head: rows
// b0 S .. (b0 + G) S - 1 of the flattened (B S, 3 H d) view.  Key c is live
// for query r iff both lie in the same sequence (c / S == r / S) and
// c % S < kv_len: a block-diagonal mask, the same in every tile, so each
// thread computes its 32 bits of it once.  (A query of a sequence past B
// meets only keys of that absent sequence, and its row is not stored.)
// Rows G S .. 63 of a tile and rows past B S are loaded (TMA zero-fills the
// latter) and never stored.  The CTA is persistent: a consumer warpgroup
// and a producer warp walk the (group, head) tiles t = blockIdx.x, + grid,
// ..., head fastest.  One lane of the producer issues TMA loads from one
// 2-d map over the flattened view (boxes of 64 rows x 64 columns, 128-byte
// swizzle; q at column h d, k at (H + h) d, v at (2 H + h) d, d / 64 boxes
// each) into a ring of kMhaStages stages, Q and K on one full barrier and
// V on another, each handed back as soon as its products have read it, so
// the next tile's Q and K land while this tile's softmax and P V run.  Per
// tile, in the consumer:
//   1. S = Q K^T: one wgmma m64n64k16 per 16 of d (A = Q, B = K, K-major
//      boxes), the whole 64 x 64 score tile in 32 f32 registers a thread;
//      Q and K are handed back.
//   2. The mask, the exact row max and l in registers, p = 2^(s c - m c)
//      with c = scale log2 e, p / l packed to bf16 as wgmma A fragments.
//      Each score is computed and exponentiated once.
//   3. O = P V: per 64 output columns four m64n64k16 steps (A = P from
//      registers, B = a V box read MN-major), kMhaPvCols columns issued as
//      one group and stored before the next; V is handed back after the
//      last group.
//   4. o stored as bf16 pairs at column h d + col, lse by the quad's first
//      lane; rows past G S or past B S are not written.
// Shared memory: a stage is three tiles of 64 rows by d (96 KB at d = 256).
// One stage and 64-column P V groups (110 registers) let two CTAs share an
// SM at d = 256, whose loads and products interleave; in
// tools/wgmma_variants.py --kernels 3 that ran 0.032 ms at PTN serving's
// shape against 0.041 for two stages (one CTA an SM) with all 256 columns
// in one group (176 registers), and 0.104 for one sequence a tile (PERF.md,
// kernel 3's findings).

#pragma once

#include "flash_fwd_sm90.cuh"

namespace {

constexpr int kMhaStages = 1;           // stages of the TMA ring
constexpr int kMhaPvCols = 64;          // output columns of one P V group
constexpr int kMhaThreads = 128 + 32;   // a consumer warpgroup, a producer
constexpr int kMhaBox = 64 * 128;       // bytes of a 64 x 64 bf16 box

// which body kernel 3 runs: the rule, written once
enum MhaBody : int { kMhaStreamed = 0, kMhaPacked = 1, kMhaOneShot = 2 };

__host__ __device__ constexpr int mha_fwd_route(int dtype, int d, int s,
                                                int kv_len, bool drop) {
  return dtype != 1 || drop ? kMhaStreamed
         : (d == 128 || d == 256) && s >= 1 && s <= 64 ? kMhaPacked
         : one_shot_on_wgmma(1, d, kv_len) ? kMhaOneShot
                                           : kMhaStreamed;
}

// whole sequences of S tokens that one 64-row tile holds
__host__ __device__ constexpr int mha_pack(int s) { return 64 / s; }

// 1 KB of slack to align the dynamic base, then per stage Q, K and V tiles
// of 64 rows by d (each box 1024-byte aligned, the swizzle's period)
__host__ __device__ constexpr size_t mha_packed_smem(int hd) {
  return 1024 + static_cast<size_t>(kMhaStages) * 3 * 64 * hd * 2;
}

struct MhaPacked {
  bf16* o;      // (B, S, H*d)
  float* lse;   // (B, S, H)
  int B, S, H, kv_len;
  int pack;     // sequences a tile: mha_pack(S)
  int tiles;    // (group, head) tiles: ceil(B / pack) * H
  float scale;
};

// the registers of one CTA an SM are the cap; the grid takes as many CTAs
// an SM as fit (two at d = 256)
template <int HD>
__global__ void __launch_bounds__(kMhaThreads, 1)
    mha_fwd_packed(const __grid_constant__ CUtensorMap tm,
                   const MhaPacked a) {
  constexpr int kBoxes = HD / 64;            // boxes of an operand
  constexpr uint32_t kTile = kBoxes * kMhaBox;  // an operand's 64 rows
  constexpr int ST = kMhaStages;
  constexpr int PV = kMhaPvCols < HD ? kMhaPvCols : HD;
  extern __shared__ unsigned char smem_raw[];
  // per stage: Q and K full, V full, Q and K empty, V empty
  __shared__ __align__(8) uint64_t bars[4 * ST];
  uint64_t* const fullqk = bars;
  uint64_t* const fullv = bars + ST;
  uint64_t* const emptyqk = bars + 2 * ST;
  uint64_t* const emptyv = bars + 3 * ST;
  // stage st: Q, K, V
  unsigned char* ring =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int rows = a.pack * a.S;  // the rows of a tile that hold sequences

  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&fullqk[i], 1);
      mbar_init(&fullv[i], 1);
      mbar_init(&emptyqk[i], 4);
      mbar_init(&emptyv[i], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq4 = lane & 3;
  if (threadIdx.x >= 128) {
    // the producer: one lane issues every load
    if (lane == 0) {
      int i = 0;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++i) {
        const int st = i % ST;
        const uint32_t freed = ((i / ST) & 1) ^ 1;
        const int g = t / a.H, h = t - g * a.H, row0 = g * rows;
        unsigned char* Qs = ring + st * 3 * kTile;
        mbar_wait(&emptyqk[st], freed);
        mbar_expect_tx(&fullqk[st], 2 * kTile);
        for (int c = 0; c < kBoxes; ++c) {
          tma_load_2d(Qs + c * kMhaBox, &tm, &fullqk[st], h * HD + 64 * c,
                      row0);
          tma_load_2d(Qs + kTile + c * kMhaBox, &tm, &fullqk[st],
                      (a.H + h) * HD + 64 * c, row0);
        }
        mbar_wait(&emptyv[st], freed);
        mbar_expect_tx(&fullv[st], kTile);
        for (int c = 0; c < kBoxes; ++c)
          tma_load_2d(Qs + 2 * kTile + c * kMhaBox, &tm, &fullv[st],
                      (2 * a.H + h) * HD + 64 * c, row0);
      }
    }
    return;
  }

  // the live keys of this thread's scores, the same in every tile: bit
  // 4 j + e holds row 16 warp + gq + 8 (e / 2), key 8 j + 2 tq4 + e % 2
  uint32_t live = 0;
#pragma unroll 1
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * warp + gq + 8 * (e >> 1);
      const int c = 8 * j + 2 * tq4 + (e & 1);
      if (c / a.S == r / a.S && c % a.S < a.kv_len) live |= 1u << (4 * j + e);
    }
  const float cl = a.scale * kLog2e;
  const size_t ld = static_cast<size_t>(a.H) * HD;  // o's row, in elements
  const int total = a.B * a.S;

  int i = 0;
#pragma unroll 1
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++i) {
    const int st = i % ST;
    const uint32_t ph = (i / ST) & 1;
    const int g = t / a.H, h = t - g * a.H, row0 = g * rows;
    const unsigned char* Qs = ring + st * 3 * kTile;
    const uint64_t qdesc = smem_desc<64>(Qs);
    const uint64_t kdesc = smem_desc<64>(Qs + kTile);
    const uint64_t vdesc = smem_desc<64>(Qs + 2 * kTile);

    // 1. S = Q K^T, one m64n64k16 per 16 of d: step kk reads 32 bytes of
    // box kk / 4's swizzled rows
    float s[32];
    mbar_wait(&fullqk[st], ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint64_t off = (kk >> 2) * (kMhaBox >> 4) + 2 * (kk & 3);
      wgmma_ss_n64(s, qdesc + off, kdesc + off, kk);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int e = 0; e < 32; ++e) reg_fence(s[e]);
    if (lane == 0) mbar_arrive(&emptyqk[st]);  // Q and K read

    // 2. the mask and the row max (rows gq, gq + 8 of the warp's 16)
    float m[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      if (!((live >> e) & 1)) s[e] = neg_inf();
      m[(e >> 1) & 1] = fmaxf(m[(e >> 1) & 1], s[e]);
    }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
    const float mc[2] = {m[0] * cl, m[1] * cl};
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[e] = ex2(fmaf(s[e], cl, -mc[(e >> 1) & 1]));
      l[(e >> 1) & 1] += s[e];
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    // p / l in bf16: registers 8 kk .. 8 kk + 7 are the A fragment of the
    // 16 keys at 16 kk
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* p = s + 8 * kk;
      pa[kk][0] = pack_bf16(p[0] / l[0], p[1] / l[0]);
      pa[kk][1] = pack_bf16(p[2] / l[1], p[3] / l[1]);
      pa[kk][2] = pack_bf16(p[4] / l[0], p[5] / l[0]);
      pa[kk][3] = pack_bf16(p[6] / l[1], p[7] / l[1]);
    }

    // 3. and 4. O = P V, PV output columns a group, and their stores
    mbar_wait(&fullv[st], ph);
    bf16* O = a.o + static_cast<size_t>(row0) * ld + h * HD + 2 * tq4;
#pragma unroll
    for (int c0 = 0; c0 < HD; c0 += PV) {
      float o[PV / 2];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < PV / 64; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_n64(o + 32 * c, pa[kk],
                       vdesc + (((c0 / 64 + c) * kMhaBox) >> 4) +
                           ((16 * kk * 128) >> 4),
                       kk);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int e = 0; e < PV / 2; ++e) reg_fence(o[e]);
      if (c0 + PV == HD && lane == 0) mbar_arrive(&emptyv[st]);  // V read
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * warp + gq + 8 * hh;
        if (row >= rows || row0 + row >= total) continue;
        bf16* dst = O + row * ld + c0;
#pragma unroll
        for (int j = 0; j < PV / 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              pack_bf16(o[4 * j + 2 * hh], o[4 * j + 2 * hh + 1]);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 16 * warp + gq + 8 * hh;
      if (tq4 == 0 && row < rows && row0 + row < total)
        a.lse[static_cast<size_t>(row0 + row) * a.H + h] =
            m[hh] * a.scale + logf(l[hh]);
    }
  }
}

// a 2-d map over the flattened qkv (rows, cols) bf16, row stride `cols`
// elements: boxes of 64 rows x 64 columns in the 128-byte swizzle; rows
// past `rows` read as zeros
inline cudaError_t rows_map(CUtensorMap* map, const void* base, int rows,
                            long long cols) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) *
                                 sizeof(bf16)};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_mha_packed_d(const CUtensorMap& map, const MhaPacked& a,
                                cudaStream_t stream) {
  constexpr size_t bytes = mha_packed_smem(HD);
  DEVT_TRY(set_smem(mha_fwd_packed<HD>, bytes));
  // a persistent grid: as many CTAs as fit the card at once
  static int per_sm = 0;
  if (per_sm == 0)
    DEVT_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mha_fwd_packed<HD>, kMhaThreads, bytes));
  int dev = 0, sms = 0;
  DEVT_TRY(cudaGetDevice(&dev));
  DEVT_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  const int fit = (per_sm > 0 ? per_sm : 1) * sms;
  const int grid = a.tiles < fit ? a.tiles : fit;
  mha_fwd_packed<HD><<<grid, kMhaThreads, bytes, stream>>>(map, a);
  return cudaGetLastError();
}

// kernel 3 on the packed body, for a shape that mha_fwd_route sends here:
// qkv (B, S, 3*H*d) bf16 contiguous and 16-byte aligned, o (B, S, H*d),
// lse (B, S, H)
inline cudaError_t launch_mha_packed(const void* qkv, void* o, float* lse,
                                     int B, int S, int H, int d, int kv_len,
                                     float scale, cudaStream_t stream) {
  if (mha_fwd_route(1, d, S, kv_len, false) != kMhaPacked)
    return cudaErrorInvalidValue;
  CUtensorMap map;
  DEVT_TRY(rows_map(&map, qkv, B * S, 3ll * H * d));
  MhaPacked a{};
  a.o = static_cast<bf16*>(o);
  a.lse = lse;
  a.B = B;
  a.S = S;
  a.H = H;
  a.kv_len = kv_len;
  a.pack = mha_pack(S);
  a.tiles = (B + a.pack - 1) / a.pack * H;
  a.scale = scale;
  return d == 256 ? launch_mha_packed_d<256>(map, a, stream)
                  : launch_mha_packed_d<128>(map, a, stream);
}

}  // namespace
