// The packed-qkv attention backward (kernel 4, mha_bwd.cu) on Hopper's
// wgmma and TMA: two bodies, picked by one rule.
//
//   mha_bwd_packed<d, drop>    devt_tpu/ops/flash_attention.py:589
//                              _mha_bwd_kernel at head dim 128 or 256 and
//                              S <= 64 (PTN training): several whole
//                              sequences of one head to a 64-row tile, the
//                              backward of mha_fwd_packed
//                              (mha_fwd_sm90.cuh)
//   mha_bwd_dq_sm90<d, drop>   the same at head dim 16, 32 or 64 (the blocks
//   mha_bwd_dkv_sm90<d, drop>  the fused kernels do not take: MoE-ViViT at
//                              dropout, ViViT at dim 384): kernels 12's and
//                              13's bodies (flash_bwd_sm90.cuh) with kBwdMha
//
// What both compute is mha_bwd.cu's contract, per (sequence, head):
//
//   delta = rowsum(f32(do) * f32(o))
//   p     = exp(q k^T * scale - lse), keys at or past kv_len at 0
//   mask  = keep ? 1 / (1 - rate) : 0         (1 without dropout)
//   dv    = round(p * mask)^T @ do
//   ds    = p * ((do @ v^T) * mask - delta) * scale
//   dq    = round(ds) @ k;   dk = round(ds)^T @ q
//
// every sum in f32, round() the cast to bf16.  The keep bits are
// Philox4x32-10 of (kSiteAttn, flat index ((b H + h) S + q) S + k)
// (fused_block_common.cuh), the forward's mask bit for bit whatever the
// grids; both bodies draw a 64 x 64 score tile's bits once into shared
// memory, a thread a 32-key word (draw_keep_tile, keep_word), since one
// Philox draw gives 4 consecutive keys of one query and a thread's wgmma
// fragment holds keys of other queries.  One owner per output element, a
// fixed order: two runs give the same bits.  Keys past kv_len get exact
// zeros.
//
// The rule (mha_bwd_route, exported as devt_mha_bwd_route and mirrored by
// ops/flash_attention.py mha_bwd_on_wgmma): bf16 at head dim 128 or 256
// with S <= 64 takes the packed body, bf16 at head dim 16, 32 or 64 (any
// S the op takes, <= 512) kernels 12's and 13's bodies, at any rate; float
// and head dims 128, 256 at S > 64 stay on attention_bwd.cuh's streamed
// body.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W) at PTN
// training's (32, 14, 6144), 8 heads of 256, kv_len 14: qkv, o, do and
// lse read and dqkv written are 14.7 MB, 0.0044 ms at 3.35 TB/s, against
// 5 products of 2 S kv_len d a (sequence, head), 0.13 GFLOP: bytes.  The
// streamed body took two launches (delta, then FlashAttention-2's split
// with every score computed twice and, at head dim 256, once more for each
// 64-column chunk of the outputs), on mma.sync from ldmatrix, and at S =
// 14 held 14 live rows in each 16-row warp strip.
//
// The packed body.  A 64-row tile holds G = kMhaBwdRows / S whole sequences
// of one head (at least one): query and key rows b0 S .. (b0 + G) S - 1 of
// the flattened (B S, 3 H d) view, key c live for query r iff c / S == r / S
// and c % S < kv_len (block-diagonal).  The grid is a CTA a tile, or
// kMhaBwdSplit CTAs a tile that share its 64-column output groups, each
// computing the scores anew from L2 (mha_bwd_split).  At PTN's S = 14, G = 2
// (128 tiles for the 132 SMs) ran ahead of the forward's G = 4 (64 tiles)
// split across two CTAs, and of G = 1 and four CTAs a tile
// (tools/wgmma_variants.py --kernels 4; PERF.md).
// One producer warp: its first lane issues the TMA loads of Q and K, V and
// dO, and O (one 2-d map over the flattened qkv, two over (B S, H d);
// boxes of 64 rows x 64 columns in the 128-byte swizzle, rows past B S
// zero-filled), on three mbarriers, and its lanes stage the tile's lse
// (times log2 e; +inf past the tile's sequences, so p = 0 there).  The
// consumer warpgroup, key-major as kernel 13's body:
//   0. the keep bits (with dropout), while the loads land;
//   1. S^T = K Q^T and dP^T = V dO^T, two 64 x 64 f32 tiles, d / 16
//      m64n64k16 steps each (A and B K-major);
//   2. delta of the 64 query rows from the O and dO tiles in shared
//      memory, under those products (one launch, no delta scratch);
//   3. p^T = 2^(s scale log2 e - lse log2 e) under the block-diagonal
//      mask, ds^T = p^T (dP^T mask - delta) scale, p^T mask: bf16 A
//      fragments; ds^T also to shared memory in the 128-byte swizzle, once;
//   4. per 64-column group of the CTA: dV = (P mask)^T dO and dK = dS^T Q
//      (A from registers, B the dO and Q boxes MN-major through the
//      transpose bit) and dQ = dS K (A the ds^T tile read MN-major, B the
//      K box MN-major), 96 accumulator registers, stored before the next
//      group.
// Each score is computed once a CTA.  Shared memory: five tiles of 64 rows
// by d and the ds^T tile, 169 KB at d = 256 (one CTA an SM), 89 KB at 128.
// The times and the variants tools/wgmma_variants.py --kernels 4 measures
// (kMhaBwdRows, kMhaBwdSplit) are in PERF.md.

#pragma once

#include "flash_bwd_sm90.cuh"
#include "mha_fwd_sm90.cuh"

namespace {

constexpr int kMhaBwdRows = 32;   // rows of a tile filled by whole sequences
constexpr int kMhaBwdSplit = 1;   // CTAs that share a tile's column groups
constexpr int kMhaBwdThreads = 128 + 32;  // a consumer warpgroup, a producer

// which body kernel 4 runs: the rule, written once
enum MhaBwdBody : int {
  kMhaBwdStreamed = 0,
  kMhaBwdPacked = 1,
  kMhaBwdWgmma = 2
};

// (bf16: the packed body at head dim 128 or 256 up to one 64-row tile,
// kernels 12's and 13's bodies at 16, 32 and 64; every kv_len and rate)
__host__ __device__ constexpr int mha_bwd_route(int dtype, int d, int s,
                                                int kv_len, bool drop) {
  return dtype != 1 || s < 1 || kv_len < 1 ? kMhaBwdStreamed
         : (d == 128 || d == 256) && s <= 64 ? kMhaBwdPacked
         : blocked_bwd_on_wgmma(1, d)      ? kMhaBwdWgmma
                                           : kMhaBwdStreamed;
}

// whole sequences of S tokens a packed tile holds
__host__ __device__ constexpr int mha_bwd_pack(int s) {
  return kMhaBwdRows / s > 0 ? kMhaBwdRows / s : 1;
}

// CTAs a packed tile is split across (each a share of its 64-column
// output groups)
__host__ __device__ constexpr int mha_bwd_split(int hd) {
  return kMhaBwdSplit < hd / 64 ? kMhaBwdSplit : hd / 64;
}

// 1 KB of slack to align the dynamic base, the Q, K, V, dO and O tiles of
// 64 rows by d and the 64 x 64 bf16 ds^T tile (each 1024-byte aligned)
__host__ __device__ constexpr size_t mha_bwd_packed_smem(int hd) {
  return 1024 + 5 * static_cast<size_t>(64) * hd * 2 + 64 * 64 * 2;
}

struct MhaBwdPacked {
  const float* lse;  // (B, S, H)
  bf16* dqkv;        // (B, S, 3*H*d)
  int B, S, H, kv_len;
  int pack;   // sequences a tile: mha_bwd_pack(S)
  int tiles;  // (group, head) tiles: ceil(B / pack) * H
  float scale;
  Drop drop;
};

// d[0, 32) = (acc ? d : 0) + A (64 x 16, shared, MN-major) B (16 x 64,
// shared, MN-major): both through the transpose bit
__device__ __forceinline__ void wgmma_ss_n64_tt(float* d, uint64_t a,
                                                uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <int HD, bool kDrop>
__global__ void __launch_bounds__(kMhaBwdThreads, 1)
    mha_bwd_packed(const __grid_constant__ CUtensorMap tqkv,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap to,
                   const MhaBwdPacked a) {
  constexpr int kBoxes = HD / 64;               // boxes of an operand
  constexpr uint32_t kTile = kBoxes * kMhaBox;  // an operand's 64 rows
  constexpr int kSplit = mha_bwd_split(HD);
  constexpr int kGroups = kBoxes / kSplit;  // output column groups a CTA
  extern __shared__ unsigned char smem_raw[];
  // Q and K full, V and dO full, O full
  __shared__ __align__(8) uint64_t bars[3];
  // the tile's lse times log2 e and delta, by query row; the keep bits,
  // word [query row][key / 32]
  __shared__ __align__(8) float lsm[64], dsm[64];
  __shared__ uint32_t keep[kDrop ? 64 : 1][2];
  unsigned char* Qs =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = Qs + kTile;
  unsigned char* Vs = Ks + kTile;
  unsigned char* DOs = Vs + kTile;
  unsigned char* Os = DOs + kTile;
  unsigned char* DS = Os + kTile;
  const int t = blockIdx.x / kSplit, part = blockIdx.x - t * kSplit;
  const int g = t / a.H, h = t - g * a.H;
  const int rows = a.pack * a.S;  // the rows of a tile that hold sequences
  const int row0 = g * rows, total = a.B * a.S;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq4 = lane & 3;
  if (threadIdx.x >= 128) {
    // the producer: lane 0 issues every load, every lane stages lse
    if (lane == 0) {
      mbar_expect_tx(&bars[0], 2 * kTile);
      for (int c = 0; c < kBoxes; ++c) {
        tma_load_2d(Qs + c * kMhaBox, &tqkv, &bars[0], h * HD + 64 * c, row0);
        tma_load_2d(Ks + c * kMhaBox, &tqkv, &bars[0],
                    (a.H + h) * HD + 64 * c, row0);
      }
      mbar_expect_tx(&bars[1], 2 * kTile);
      for (int c = 0; c < kBoxes; ++c) {
        tma_load_2d(Vs + c * kMhaBox, &tqkv, &bars[1],
                    (2 * a.H + h) * HD + 64 * c, row0);
        tma_load_2d(DOs + c * kMhaBox, &tdo, &bars[1], h * HD + 64 * c, row0);
      }
      mbar_expect_tx(&bars[2], kTile);
      for (int c = 0; c < kBoxes; ++c)
        tma_load_2d(Os + c * kMhaBox, &to, &bars[2], h * HD + 64 * c, row0);
    }
    for (int r = lane; r < 64; r += 32) {
      const bool ok = r < rows && row0 + r < total;
      lsm[r] = ok ? a.lse[static_cast<size_t>(row0 + r) * a.H + h] * kLog2e
                  : pos_inf();
    }
    __syncwarp();
    asm volatile("bar.arrive 2, 160;\n" ::: "memory");
    return;
  }

  // the live scores of this thread, the same in every tile: bit 4 jj + e
  // holds key row 16 warp + gq + 8 (e / 2), query column 8 jj + 2 tq4 +
  // e % 2
  uint32_t live = 0;
#pragma unroll 1
  for (int jj = 0; jj < 8; ++jj)
    for (int e = 0; e < 4; ++e) {
      const int c = 16 * warp + gq + 8 * (e >> 1);
      const int r = 8 * jj + 2 * tq4 + (e & 1);
      if (c / a.S == r / a.S && c % a.S < a.kv_len)
        live |= 1u << (4 * jj + e);
    }

  // 0. the keep bits: word [r][w] holds keys 32 w .. 32 w + 31 of query r,
  // only those of r's sequence below kv_len drawn
  if constexpr (kDrop) {
    const int r = threadIdx.x >> 1, w = threadIdx.x & 1;
    const int j = r / a.S, b = g * a.pack + j;
    const int lo = max(32 * w, j * a.S);
    const int hi = min(32 * w + 32, j * a.S + a.kv_len);
    keep[r][w] =
        j < a.pack && b < a.B && lo < hi
            ? keep_word(a.drop,
                        ((static_cast<unsigned long long>(b) * a.H + h) * a.S +
                         (r - j * a.S)) * a.S + (lo - j * a.S),
                        hi - lo)
                  << (lo - 32 * w)
            : 0u;
  }

  // 1. S^T = K Q^T and dP^T = V dO^T: register 4 jj + e holds key row gq +
  // 8 (e / 2) of the warp's 16, query column 8 jj + 2 tq4 + e % 2; step kk
  // reads 32 bytes of box kk / 4's swizzled rows
  const uint64_t qdesc = smem_desc<64>(Qs), kdesc = smem_desc<64>(Ks);
  const uint64_t vdesc = smem_desc<64>(Vs), dodesc = smem_desc<64>(DOs);
  float st[32], dpt[32];
  mbar_wait(&bars[0], 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t off = (kk >> 2) * (kMhaBox >> 4) + 2 * (kk & 3);
    wgmma_ss_n64(st, kdesc + off, qdesc + off, kk);
  }
  wgmma_commit();
  mbar_wait(&bars[1], 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t off = (kk >> 2) * (kMhaBox >> 4) + 2 * (kk & 3);
    wgmma_ss_n64(dpt, vdesc + off, dodesc + off, kk);
  }
  wgmma_commit();

  // 2. delta of query row threadIdx.x / 2 from the O and dO tiles, half
  // of the row a thread, under the products
  mbar_wait(&bars[2], 0);
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < HD / 16; ++i) {
      const int cc = half * (HD / 16) + i;
      const int off =
          (cc >> 3) * kMhaBox + r * 128 + (((cc & 7) ^ (r & 7)) << 4);
      const uint4 x = *reinterpret_cast<const uint4*>(Os + off);
      const uint4 y = *reinterpret_cast<const uint4*>(DOs + off);
      const __nv_bfloat162* xo = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yo = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 u = __bfloat1622float2(xo[i]);
        const float2 v = __bfloat1622float2(yo[i]);
        acc += v.x * u.x;
        acc += v.y * u.y;
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (!half) dsm[r] = acc;
  }
  // lse (the producer's), delta and the keep bits visible to all
  asm volatile("bar.sync 2, 160;\n" ::: "memory");

  // 3. p^T, ds^T
  const float cl = a.scale * kLog2e;
  wgmma_wait<1>();  // S^T
  fence_all<32>(st);
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const float2 l = *reinterpret_cast<const float2*>(lsm + 8 * jj + 2 * tq4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = st[4 * jj + e];
      x = (live >> (4 * jj + e)) & 1 ? ex2(fmaf(x, cl, -(e & 1 ? l.y : l.x)))
                                     : 0.f;
    }
  }
  wgmma_wait_all();  // dP^T
  fence_all<32>(dpt);
  const int kw = warp >> 1, kb0 = (16 * warp + gq) & 31;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const float2 gd = *reinterpret_cast<const float2*>(dsm + 8 * jj + 2 * tq4);
    uint32_t w[2] = {0u, 0u};
    if constexpr (kDrop) {
      w[0] = keep[8 * jj + 2 * tq4][kw];
      w[1] = keep[8 * jj + 2 * tq4 + 1][kw];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = dpt[4 * jj + e];
      const float dl = e & 1 ? gd.y : gd.x;
      if constexpr (kDrop) {
        const float m =
            (w[e & 1] >> (kb0 + 8 * (e >> 1))) & 1 ? a.drop.scale : 0.f;
        x = st[4 * jj + e] * (x * m - dl) * a.scale;
        st[4 * jj + e] *= m;
      } else {
        x = st[4 * jj + e] * (x - dl) * a.scale;
      }
    }
  }
  uint32_t pf[4][4], df[4][4];
  to_frags<64>(pf, st);
  to_frags<64>(df, dpt);
  // ds^T to shared memory: row = key (128 bytes of queries), 16-byte chunk
  // jj at jj ^ (key % 8), the 128-byte swizzle a TMA box has
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = 16 * warp + gq + 8 * hh;
      *reinterpret_cast<uint32_t*>(DS + c * 128 + ((jj ^ (c & 7)) << 4) +
                                   4 * tq4) = df[jj >> 1][2 * (jj & 1) + hh];
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumer_sync();

  // 4. dV, dK and dQ a 64-column group at a time; rows past the tile's
  // sequences or past B S not stored, dk and dv of keys past kv_len zeros
  const uint64_t dsdesc = smem_desc<64>(DS);
  const size_t ld = 3 * static_cast<size_t>(a.H) * HD;  // a dqkv row
#pragma unroll 1
  for (int gi = 0; gi < kGroups; ++gi) {
    const int box = part * kGroups + gi;
    const uint64_t cb = (box * kMhaBox) >> 4;
    float dv[32], dk[32], dq[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n64(dv, pf[kk], dodesc + cb + ((16 * kk * 128) >> 4), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n64(dk, df[kk], qdesc + cb + ((16 * kk * 128) >> 4), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64_tt(dq, dsdesc + ((16 * kk * 128) >> 4),
                      kdesc + cb + ((16 * kk * 128) >> 4), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_all<32>(dv);
    fence_all<32>(dk);
    fence_all<32>(dq);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * warp + gq + 8 * hh;
      if (r >= rows || row0 + r >= total) continue;
      const bool on = r % a.S < a.kv_len;  // a select: NaN * 0 is NaN
      bf16* dst = a.dqkv + static_cast<size_t>(row0 + r) * ld + h * HD +
                  64 * box + 2 * tq4;
      const size_t hk = static_cast<size_t>(a.H) * HD;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * hh;
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(dq[i], dq[i + 1]);
        *reinterpret_cast<uint32_t*>(dst + hk + 8 * j) =
            pack_bf16(on ? dk[i] : 0.f, on ? dk[i + 1] : 0.f);
        *reinterpret_cast<uint32_t*>(dst + 2 * hk + 8 * j) =
            pack_bf16(on ? dv[i] : 0.f, on ? dv[i + 1] : 0.f);
      }
    }
  }
}

// kernels 12's and 13's bodies for kernel 4 (kBwdMha, with or without the
// dropout)
template <int HD, bool kDrop>
__global__ void __launch_bounds__(kBwdThreads, kBwdDqCTAs)
    mha_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const MhaBwd a) {
  dq_body<HD, kBwdMha, kDrop>(tq, tk, tv, tdo, a);
}

template <int HD, bool kDrop>
__global__ void __launch_bounds__(kBwdThreads, kBwdDkvCTAs)
    mha_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const MhaBwd a) {
  dkv_body<HD, kBwdMha, kDrop>(tq, tk, tv, tdo, a);
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

template <int HD, bool kDrop>
cudaError_t launch_mha_bwd_packed_d(const CUtensorMap (&m)[3],
                                    const MhaBwdPacked& a,
                                    cudaStream_t stream) {
  constexpr size_t bytes = mha_bwd_packed_smem(HD);
  DEVT_TRY(set_smem(mha_bwd_packed<HD, kDrop>, bytes));
  mha_bwd_packed<HD, kDrop>
      <<<a.tiles * mha_bwd_split(HD), kMhaBwdThreads, bytes, stream>>>(
          m[0], m[1], m[2], a);
  return cudaGetLastError();
}

// kernel 4 on the packed body, for a shape mha_bwd_route sends there: qkv
// and dqkv (B, S, 3*H*d) bf16, o and do (B, S, H*d), all contiguous and
// 16-byte aligned, lse (B, S, H) f32
inline cudaError_t launch_mha_bwd_packed(const void* qkv, const void* o,
                                         const void* dout, const float* lse,
                                         void* dqkv, int B, int S, int H,
                                         int d, int kv_len, float scale,
                                         const Drop& drop,
                                         cudaStream_t stream) {
  if (mha_bwd_route(1, d, S, kv_len, drop.on) != kMhaBwdPacked)
    return cudaErrorInvalidValue;
  CUtensorMap m[3];
  DEVT_TRY(rows_map(&m[0], qkv, B * S, 3ll * H * d));
  DEVT_TRY(rows_map(&m[1], dout, B * S, static_cast<long long>(H) * d));
  DEVT_TRY(rows_map(&m[2], o, B * S, static_cast<long long>(H) * d));
  MhaBwdPacked a{};
  a.lse = lse;
  a.dqkv = static_cast<bf16*>(dqkv);
  a.B = B;
  a.S = S;
  a.H = H;
  a.kv_len = kv_len;
  a.pack = mha_bwd_pack(S);
  a.tiles = (B + a.pack - 1) / a.pack * H;
  a.scale = scale;
  a.drop = drop;
  if (d == 256)
    return drop.on ? launch_mha_bwd_packed_d<256, true>(m, a, stream)
                   : launch_mha_bwd_packed_d<256, false>(m, a, stream);
  return drop.on ? launch_mha_bwd_packed_d<128, true>(m, a, stream)
                 : launch_mha_bwd_packed_d<128, false>(m, a, stream);
}

// kernel 4 on kernels 12's and 13's bodies, head dim HD: the dq launch
// (delta into the scratch, dq), then the dk/dv launch, q, k, v the head
// views of qkv and do read by strides through TMA maps
template <int HD, bool kDrop>
cudaError_t launch_mha_bwd_wgmma_d(const MhaBwd& a, const bf16* qkv, int B,
                                   cudaStream_t stream) {
  const int S = a.Sq, H = a.H;
  const long long hd = static_cast<long long>(H) * HD, rs = 3 * hd;
  const long long ss = S * rs;  // a sequence's elements in qkv, dqkv
  const bf16 *q = qkv, *k = qkv + hd, *v = qkv + 2 * hd;
  for (int part = 1; part <= 2; ++part) {
    const int qbox = part == 1 ? 64 : kBwdDkvQueries;
    const int kbox = part == 1 ? kBwdDqKeys : 64;
    CUtensorMap m[4];
    DEVT_TRY(head_map(&m[0], q, HD, S, H, B, rs, HD, ss, qbox));
    DEVT_TRY(head_map(&m[1], k, HD, S, H, B, rs, HD, ss, kbox));
    DEVT_TRY(head_map(&m[2], v, HD, S, H, B, rs, HD, ss, kbox));
    DEVT_TRY(head_map(&m[3], a.dout, HD, S, H, B, hd, HD, S * hd, qbox));
    const int grid = B * H * ((S + 63) / 64);
    if (part == 1) {
      constexpr size_t bytes = bwd_smem(HD, kBwdDqStages, kBwdDqKeys);
      DEVT_TRY(set_smem(mha_bwd_dq_sm90<HD, kDrop>, bytes));
      mha_bwd_dq_sm90<HD, kDrop><<<grid, kBwdThreads, bytes, stream>>>(
          m[0], m[1], m[2], m[3], a);
    } else {
      constexpr size_t bytes = bwd_smem(HD, kBwdDkvStages, kBwdDkvQueries);
      DEVT_TRY(set_smem(mha_bwd_dkv_sm90<HD, kDrop>, bytes));
      mha_bwd_dkv_sm90<HD, kDrop><<<grid, kBwdThreads, bytes, stream>>>(
          m[0], m[1], m[2], m[3], a);
    }
    DEVT_TRY(cudaGetLastError());
  }
  return cudaSuccess;
}

// kernel 4 on kernels 12's and 13's bodies, for a shape mha_bwd_route sends
// there: qkv and dqkv (B, S, 3*H*d) bf16, o and do (B, S, H*d), all
// 16-byte aligned, lse (B, S, H) f32, delta (B, S, H) f32 scratch
inline cudaError_t launch_mha_bwd_wgmma(const void* qkv, const void* o,
                                        const void* dout, const float* lse,
                                        float* delta, void* dqkv, int B,
                                        int S, int H, int d, int kv_len,
                                        float scale, const Drop& drop,
                                        cudaStream_t stream) {
  if (mha_bwd_route(1, d, S, kv_len, drop.on) != kMhaBwdWgmma)
    return cudaErrorInvalidValue;
  const long long hd = static_cast<long long>(H) * d;
  MhaBwd a{};
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = lse;
  a.delta = delta;
  a.dq = static_cast<bf16*>(dqkv);
  a.dk = a.dq + hd;
  a.dv = a.dq + 2 * hd;
  a.H = H;
  a.Sq = a.Skv = S;
  a.kv_len = kv_len;
  a.scale = scale;
  a.drop = drop;
  const long long os[3] = {S * hd, d, hd};
  const long long ls[3] = {static_cast<long long>(S) * H, 1, H};
  const long long gs[3] = {S * 3 * hd, d, 3 * hd};
  for (int i = 0; i < 3; ++i) a.os[i] = os[i], a.ls[i] = ls[i], a.gs[i] = gs[i];
  const bf16* x = static_cast<const bf16*>(qkv);
  switch (d) {
    case 16:
      return drop.on ? launch_mha_bwd_wgmma_d<16, true>(a, x, B, stream)
                     : launch_mha_bwd_wgmma_d<16, false>(a, x, B, stream);
    case 32:
      return drop.on ? launch_mha_bwd_wgmma_d<32, true>(a, x, B, stream)
                     : launch_mha_bwd_wgmma_d<32, false>(a, x, B, stream);
    case 64:
      return drop.on ? launch_mha_bwd_wgmma_d<64, true>(a, x, B, stream)
                     : launch_mha_bwd_wgmma_d<64, false>(a, x, B, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
