"""Attention kernels with their backwards, the CUDA kernels and their plain
versions: packed-qkv (kernels 3, 4), split-q/k/v (kernels 9-13) and one hop
of ring attention (kernels 14, 15).

Port of ``devt_tpu/ops/flash_attention.py``: its constants, and
``fused_mha`` — the packed-qkv single-block attention, forward
(``_mha_fwd_kernel``, ``:558``) and backward (``_mha_bwd_kernel``,
``:589``), wired together by the ``custom_vjp`` at ``:712-733``.  qkv is
(B, S, 3*H*D) with the last axis ordered (3, H, D); per head

    s   = q kᵀ · scale            (f32; key columns ≥ kv_len at -1e30)
    p   = exp(s - max s);  l = Σ p;  lse = max s + log l
    pn  = p / l, with dropout where(keep, pn / (1 - rate), 0)
    o   = (pn cast to v's dtype) @ v             (f32 accumulation)

o is (B, S, H*D) in qkv's dtype and lse (B, S, H) f32, taken before the
dropout mask.  The TPU kernels keep lse broadcast over 128 lanes per head,
a layout of that chip; here it is one value per row and head.  The
backward recomputes p = exp(s - lse) and returns the packed dqkv
(``fused_mha_bwd_plain`` lists its steps and roundings).

Kernels (CUDA C++ for sm_90a): the forward is ``csrc/mha_fwd.cu`` on three
bodies, by the rule ``mha_fwd_on_wgmma`` (the C entry's
``devt_mha_fwd_route``).  In bfloat16 without dropout: at head dim 128 or
256 and S ≤ 64 (PTN) the packed body of ``csrc/mha_fwd_sm90.cuh``, a
persistent CTA that puts 64 // S whole sequences of one head in a 64-row
tile (a block-diagonal mask), loads q, k and v by TMA (the next tile's q
and k while this tile's P·V runs; two CTAs an SM at head dim 256) and runs
Q·Kᵀ and P·V on ``wgmma`` with p / l in registers
(``mha_packed_tiling`` mirrors its tiling); at head dim 16, 32 or 64 with
kv_len ≤ 256 kernel 9's one-shot ``wgmma`` instance on the head views of
qkv.  Everything else (dropout, float, head dim 128 or 256 at S > 64,
FrameTransformer's head dims 224 and 448) runs the streamed bodies of
``csrc/attention_fwd.cuh``: in bfloat16 ``attention_bf16_tiled`` (a block
per (64 queries, head, sequence), K and V streamed in 32-key tiles,
``mma.sync`` bf16 tiles, the row statistics from an online pass, then
the scores recomputed per pass of output columns so that p is normalised
and rounded where the TPU kernel does it), in float the FMA body.  The
backward is ``csrc/mha_bwd.cu`` on three bodies, by the rule
``mha_bwd_on_wgmma`` (the C entry's ``devt_mha_bwd_route``), at every
dropout rate.  In bfloat16 at head dim 128 or 256 and S ≤ 64 (PTN
training) the packed body of ``csrc/mha_bwd_sm90.cuh``: one launch, a CTA
a 64-row tile of max(1, 32 // S) whole sequences of one head under a
block-diagonal mask (``mha_bwd_packed_tiling``), key-major products on
``wgmma`` with each score computed once and delta from the tile's o and
do rows.  In bfloat16 at head dim 16, 32 or 64 kernels 12's
and 13's ``wgmma`` bodies on the head views of qkv (the dq launch with
delta, then the dk/dv launch).  Float, head dim 128 or 256 at S > 64,
and head dims 224 and 448 run ``csrc/attention_bwd.cuh``: FlashAttention-2's split, a launch that
writes delta = rowsum(do · o), then one of blocks that own up to 64
queries of a head and sum their dq over the keys, and blocks that own up
to 64 keys and sum their dk and dv over the queries, each streaming the
other side's rows through shared memory, so that every single-kv-block
length fits.  Each output has one owner in every body (no atomics: two
runs give the same bits); the dropout mask is drawn inside each.
bfloat16 is compiled for head dims
16, 32, 64, 128, 224, 256 and 448, float (FMA products) for any multiple of
4; a shape whose rows do not fit a block's shared memory raises
``ValueError`` with the byte count, before the forward's work when the
input needs a gradient.  The bfloat16 forward takes every S (its shared
memory does not depend on S).  At head dims 224 and 448
(FrameTransformer's) the backward's blocks own and stream 32 rows at a
time, a warp to each 16-row strip and ``attn_out_cols`` column chunk (14
warps), so the backward takes every S there too.

Dropout runs inside both kernels: Philox4x32-10 keyed by the call's seed,
its counter (the attention site, flat index over (b, h, q, k)), so the
backward regenerates the forward's mask whatever the two launches' grids.
``mha_dropout_masks`` returns the masks a seed gives (on the card written
by the kernels' own generator, on the CPU drawn from a ``torch.Generator``)
so that the plain versions can be handed the same mask.

``fused_mha`` is a ``torch.autograd.Function``: CUDA tensors launch the
kernels (or raise), CPU tensors run the plain versions.
``fused_mha.launches`` and ``fused_mha.bwd_launches`` count kernel
calls; the forward's by body in ``fused_mha.packed_launches``,
``.one_shot_launches`` and ``.streamed_launches``, the backward's in
``.bwd_packed_launches``, ``.bwd_wgmma_launches`` and
``.bwd_streamed_launches``.

``flash_attention`` is the attention on split q, k, v (B, H, S, d) of the
JAX package's ``flash_attention`` (``:326``), with its rule (``:349``):

  * Sq == Skv <= 512 (``fits_single_block``): the single-block kernels,
    forward ``_fwd_single_kernel`` (``:390``, kernel 9) and backward
    ``_bwd_single_kernel`` (``:413``, kernel 10) under autograd; o =
    round(p / l) @ v after the exact row max, as kernel 3.
  * otherwise the blockwise online-softmax forward ``_fwd_kernel``
    (``:69``, kernel 11): per 128-key block the running max m, alpha =
    exp(m_old - m), acc = acc·alpha + round(p) @ v, l = l·alpha + Σp, and
    o = acc / l; its backward, ``_flash_padded``'s VJP
    (``:303-323``), is ``_bwd_dq_kernel`` (``:158``, kernel 12: delta and
    dq summed over the key blocks) and ``_bwd_dkv_kernel`` (``:198``,
    kernel 13: dk and dv summed over the query blocks),
    ``flash_blocked_bwd_plain`` lists their roundings.

Kernels: ``csrc/flash_fwd.cu`` (9 and 11) on two bodies.  Kernel 9 in
bfloat16 at head dim 16, 32 or 64 with at most 256 live keys
(``one_shot_on_wgmma``: every main-path shape) runs
``csrc/flash_fwd_sm90.cuh``'s one-shot body: a CTA per two query tiles of
a head, q, k, v loaded by TMA, the whole score row of 64 queries in
``wgmma`` accumulators, P·V on ``wgmma`` from registers.  Kernel 11 in
bfloat16 at head dim 16, 32 or 64 (``online_on_wgmma``: every main-path
shape) runs the same header's online body: 64 queries a CTA in one
consumer warpgroup, three CTAs an SM, K and V in 128-key tiles (the TPU
kernel's block_kv, so one rescale per 128 keys as the plain version's)
through a TMA ring that a producer warp keeps full, Q·Kᵀ and P·V on
``wgmma``.  Other shapes and float run ``csrc/flash_fwd.cuh`` (a block per
64 queries of a head, K and V streamed through shared memory in 64-key
tiles, so every length takes every head dim; its online branch rescales
per 32 keys, which moves a bf16 o by the rounding of p only).  The
backward is ``csrc/flash_bwd.cu``.  Kernels 12 and 13 in bfloat16 at head
dim 16, 32 or 64 (``blocked_bwd_on_wgmma``: every main-path shape) run
``csrc/flash_bwd_sm90.cuh``'s bodies, one launch each: kernel 12 a CTA per
64 queries that computes delta in its prologue and walks 64-key K and V
tiles through a TMA ring, kernel 13 a CTA per 64 keys that walks the
query tiles, every product on ``wgmma``.  Kernel 10 computes what they
compute at Sq == Skv, so under the same rule it launches both bodies, one
after the other.  Kernels 10, 12 and 13 in float or at head dims 128 and
256 run kernel 4's body on the split layout, ``csrc/attention_bwd.cuh``
(a delta launch, then kernel 10 as one launch, 12 and 13 as one each),
with separate query and key extents and the other side streamed, so
shared memory does not grow with either.  Every body reads
q, k, v through their strides, so the transposed head views that
``packed_mha`` cuts from a packed qkv are not copied; o is (B, H, Sq, d)
and lse (B·H, Sq) f32, contiguous, and nothing is padded in device memory (the TPU wrapper pads
to its tiles; here the kernels mask query rows past Sq and keys past
kv_len).  Counters: ``flash_attention.single_launches`` (kernel 9; of
them ``.single_wgmma_launches`` on the wgmma body and
``.single_streamed_launches`` on the streamed one),
``.single_bwd_launches`` (kernel 10, a call; of them
``.single_bwd_wgmma_launches`` on the two wgmma bodies and
``.single_bwd_streamed_launches``), ``.blocked_launches`` (kernel 11; of them
``.blocked_wgmma_launches`` and ``.blocked_streamed_launches`` by body),
``.blocked_dq_launches`` (kernel 12, a call: on the streamed body its
delta launch with it; of them ``.blocked_dq_wgmma_launches`` and
``.blocked_dq_streamed_launches``) and ``.blocked_dkv_launches`` (13; of
them ``.blocked_dkv_wgmma_launches`` and
``.blocked_dkv_streamed_launches``).

``ring_step_fwd`` and ``ring_step_bwd`` are one hop of ring attention
(``_ring_fwd_kernel``, ``:792``, kernel 14; ``_ring_bwd_kernel``,
``:814``, kernel 15), the building blocks of
``parallel/ring_attention.py``: the local q (B, S, H·D) against the packed
kv shard (B, S, 2·H·D) held now, with an additive f32 column mask (1, S)
in place of kv_len.  Kernel 14 is kernel 9's math (exact row max, o =
round(p / l) @ v); kernel 15 the flash backward against the global lse,
with f32 partials dq and dkv that sum across hops.  Kernels:
``csrc/ring_step.cu``, the heads addressed through strides on the packed
layout: kernel 14 on kernel 9's one-shot wgmma body under the same rule,
with the shard's S as its key count (else ``flash_fwd.cuh``'s), kernel 15
in bfloat16 at head dim 16, 32 or 64 (``blocked_bwd_on_wgmma``) on
kernels 12's and 13's wgmma bodies with the column bias and f32 outputs,
one launch each (else a delta launch and ``attention_bwd.cuh``'s body).
Counters: ``ring_step_fwd.launches`` and ``ring_step_bwd.launches`` (of
each, ``.wgmma_launches`` and ``.streamed_launches`` by body).
"""

from __future__ import annotations

import ctypes

import torch

from devt_tpu_torch.ops._library import kernel_op

# additive key-padding mask value: -1e30, not -inf, keeps a fully masked
# row NaN-free, and exp() turns it into an exact zero next to a real score
NEG_INF = -1e30
_LANES = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# head dims the bfloat16 kernels are instantiated for (csrc/flash_fwd.cu,
# csrc/flash_bwd.cu, csrc/ring_step.cu); kernels 3 and 4 (csrc/mha_fwd.cu,
# csrc/mha_bwd.cu) also take FrameTransformer's 224 and 448, on their
# streamed bodies
_BF16_HEAD_DIMS = (16, 32, 64, 128, 256)
_MHA_BF16_HEAD_DIMS = (16, 32, 64, 128, 224, 256, 448)
# warps of a block of the streamed backward (csrc/attention_bwd.cuh
# kBwdMaxWarps): one per (16-row strip, output-column chunk)
_BWD_MAX_WARPS = 16
# keys per block of the JAX package's blockwise kernel (block_kv)
_BLOCK_KV = 128
# rows of a float tile of the flash kernels (csrc/flash_fwd.cuh kF32Rows,
# kF32Keys)
_F32_ROWS = 32
# dynamic shared memory one block can have on sm_90 (227 KB)
_SMEM_PER_BLOCK = 232448
# the one-shot forward's wgmma body (csrc/flash_fwd_sm90.cuh
# one_shot_on_wgmma): bfloat16 head dims and the longest score row it holds
_WGMMA_HEAD_DIMS = (16, 32, 64)
_WGMMA_MAX_KEYS = 256
# rows of a wgmma tile: the packed forward's tile holds 64 // S sequences
_WGMMA_TILE = 64
# kernel 3's bodies by devt_mha_fwd_route's answer (csrc/mha_fwd_sm90.cuh
# MhaBody)
_MHA_BODIES = ("streamed", "packed", "one_shot")
# kernel 4's bodies by devt_mha_bwd_route's answer (csrc/mha_bwd_sm90.cuh
# MhaBwdBody); the packed body's rows filled by whole sequences and the
# CTAs a tile's output columns are split across (kMhaBwdRows,
# kMhaBwdSplit)
_MHA_BWD_BODIES = ("streamed", "packed", "wgmma")
_MHA_BWD_ROWS = 32
_MHA_BWD_SPLIT = 1


def one_shot_on_wgmma(dtype: torch.dtype, d: int, keys: int) -> bool:
    """Whether a one-shot forward (kernel 9 with ``keys`` = kv_len, kernel
    14 with ``keys`` = the shard's S) runs the wgmma body: the rule of the
    C entries, ``csrc/flash_fwd_sm90.cuh`` ``one_shot_on_wgmma``.  The
    others run the streamed body of ``csrc/flash_fwd.cuh``."""
    return (dtype == torch.bfloat16 and d in _WGMMA_HEAD_DIMS
            and 1 <= keys <= _WGMMA_MAX_KEYS)


def mha_fwd_on_wgmma(dtype: torch.dtype, d: int, s: int, kv_len: int,
                     rate: float) -> str:
    """The body a forward of kernel 3 (``fused_mha``) runs: the rule of the
    C entry, ``csrc/mha_fwd_sm90.cuh`` ``mha_fwd_route``.  ``"packed"``
    (bfloat16 without dropout at head dim 128 or 256 and S ≤ 64: several
    sequences to a wgmma tile), ``"one_shot"`` (bfloat16 without dropout at
    head dim 16, 32 or 64 with kv_len ≤ 256: kernel 9's wgmma instance) or
    ``"streamed"`` (``csrc/attention_fwd.cuh``: dropout, float, head dim 128
    or 256 at S > 64)."""
    if dtype != torch.bfloat16 or rate > 0.0:
        return "streamed"
    if d in (128, 256) and 1 <= s <= _WGMMA_TILE:
        return "packed"
    return "one_shot" if one_shot_on_wgmma(dtype, d, kv_len) else "streamed"


def mha_packed_tiling(b: int, s: int, heads: int, kv_len: int):
    """The packed body's tiling (``csrc/mha_fwd_sm90.cuh``): ``(g, tiles,
    live)`` with g = 64 // S whole sequences of a head to a 64-row tile,
    ``tiles`` the (group, head) tiles, ceil(b / g) · heads, and ``live`` the
    (64, 64) bool block-diagonal mask of a tile: key c is live for query r
    iff both lie in the same sequence and c % S < kv_len."""
    g = _WGMMA_TILE // s
    idx = torch.arange(_WGMMA_TILE)
    live = (idx[:, None] // s == idx[None, :] // s) & (idx[None, :] % s
                                                       < kv_len)
    return g, -(-b // g) * heads, live


def mha_bwd_on_wgmma(dtype: torch.dtype, d: int, s: int, kv_len: int,
                     rate: float) -> str:
    """The body a backward of kernel 4 (``fused_mha``) runs: the rule of
    the C entry, ``csrc/mha_bwd_sm90.cuh`` ``mha_bwd_route``, at every
    kv_len and dropout rate.  ``"packed"`` (bfloat16 at head dim 128 or 256
    and S ≤ 64: several sequences to a wgmma tile, one launch),
    ``"wgmma"`` (bfloat16 at head dim 16, 32 or 64: kernels 12's and 13's
    wgmma bodies, two launches) or ``"streamed"`` (``csrc/attention_bwd.cuh``:
    float, head dim 128 or 256 at S > 64)."""
    del rate  # every rate takes the route of its shape
    if dtype != torch.bfloat16 or s < 1 or kv_len < 1:
        return "streamed"
    if d in (128, 256) and s <= _WGMMA_TILE:
        return "packed"
    return "wgmma" if d in _WGMMA_HEAD_DIMS else "streamed"


def mha_bwd_packed_tiling(b: int, s: int, heads: int, kv_len: int):
    """The packed backward body's tiling (``csrc/mha_bwd_sm90.cuh``):
    ``(g, tiles, split, live)`` with g = max(1, 32 // S) whole sequences of
    a head to a 64-row tile (``kMhaBwdRows`` = 32 rows filled: two
    sequences at PTN's S = 14 ran ahead of the forward's four, PERF.md),
    ``tiles`` the (group, head) tiles, ceil(b / g) · heads, ``split`` the
    CTAs that share a tile's 64-column output groups (at most d / 64), and
    ``live`` the (64, 64) bool block-diagonal mask of a tile, [query r, key
    c]: key c is live for query r iff both lie in the same sequence and
    c % S < kv_len."""
    g = max(1, _MHA_BWD_ROWS // s)
    idx = torch.arange(_WGMMA_TILE)
    live = (idx[:, None] // s == idx[None, :] // s) & (idx[None, :] % s
                                                       < kv_len)
    return g, -(-b // g) * heads, _MHA_BWD_SPLIT, live


def _mha_bwd_wgmma_smem(body: str, d: int) -> int:
    """Dynamic shared memory of kernel 4's wgmma bodies: the packed one
    (csrc/mha_bwd_sm90.cuh mha_bwd_packed_smem: five tiles of 64 rows by d
    and the 64 × 64 bf16 dsᵀ tile), or the larger of kernels 12's and 13's
    (csrc/flash_bwd_sm90.cuh bwd_smem: the CTA's two 64-row tiles and two
    stages of two streamed 64-row tiles)."""
    if body == "packed":
        return 1024 + 5 * 64 * d * 2 + 64 * 64 * 2
    tile = _round_up(64 * d * 2, 1024)
    return 1024 + 2 * tile + 2 * 2 * tile


def online_on_wgmma(dtype: torch.dtype, d: int) -> bool:
    """Whether an online forward (kernel 11) runs the wgmma body: the rule
    of the C entry, ``csrc/flash_fwd_sm90.cuh`` ``online_on_wgmma``
    (bfloat16 at head dim 16, 32 or 64, any key count).  The others run
    the streamed body of ``csrc/flash_fwd.cuh``."""
    return dtype == torch.bfloat16 and d in _WGMMA_HEAD_DIMS


def blocked_bwd_on_wgmma(dtype: torch.dtype, d: int) -> bool:
    """Whether a backward of kernels 12 and 13, or of kernel 10 (the
    same at Sq == Skv), runs the wgmma bodies: the rule of the C entry,
    ``csrc/flash_bwd_sm90.cuh`` ``blocked_bwd_on_wgmma``: those whose
    forward (kernel 11) runs its wgmma body, ``online_on_wgmma``'s rule
    (bfloat16 at head dim 16, 32 or 64, any Sq, Skv and kv_len).  The
    others run the streamed body of ``csrc/attention_bwd.cuh``."""
    return online_on_wgmma(dtype, d)


def attn_out_cols(d: int) -> int:
    """Output columns of one product pass of the streamed forward, or of
    one warp's chunk of the streamed backward (csrc/attention_fwd.cuh
    ``attn_out_cols``): the whole head up to 64, else 64 where 64 divides
    it, else 32 (head dim 224: 7 passes that end at the head's last
    column)."""
    return d if d <= 64 else 64 if d % 64 == 0 else 32


def _bwd_rows(d: int) -> int:
    """Rows a block of the bfloat16 streamed backward owns and streams at
    once (csrc/attention_bwd.cuh ``bwd_rows``): 64, or as many 16-row
    strips as leave a warp to each (strip, chunk) pair within a block's
    warps (32 at head dims 224 and 448, 7 chunks)."""
    return min(64, _BWD_MAX_WARPS // (d // attn_out_cols(d)) * 16)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _align128(n: int) -> int:
    return _round_up(n, 128)


def _bwd_smem_bf16(sp: int, d: int) -> int:
    """Shared memory of a bfloat16 backward block (csrc/attention_bwd.cuh
    mha_bwd_smem_bf16) for sequences whose longer side rounds up to ``sp``
    rows: own rows and two buffers of streamed rows (up to ``_bwd_rows``
    rows, padded by 8), two tensors each; lse and delta of two buffers of
    queries.  It does not grow past ``_bwd_rows`` rows."""
    r = min(sp, _bwd_rows(d))
    return 6 * _align128(2 * r * (d + 8)) + 4 * _align128(4 * r)


def _fwd_smem_tiled(d: int) -> int:
    """Shared memory of a block of the streamed bfloat16 forward
    (csrc/attention_fwd.cuh attn_tiled_smem_bf16): 64 queries,
    two stages of a 32-key K tile and of V's ``attn_out_cols`` columns of
    it, rows padded by 8.  It does not depend on S."""
    return (_align128(2 * 64 * (d + 8)) + 2 * _align128(2 * 32 * (d + 8))
            + 2 * _align128(2 * 32 * (attn_out_cols(d) + 8)))


def _bwd_smem_f32(sp: int, d: int) -> int:
    """The same for a float backward block (mha_bwd_smem_f32): own rows,
    streamed rows and outputs (up to 32 rows, two tensors each), p and ds,
    lse and delta of the queries."""
    r = min(sp, _F32_ROWS)
    return (6 * _align128(4 * r * (d + 4)) + 2 * _align128(4 * r * (r + 4))
            + 2 * _align128(4 * r))


def _fwd_smem_f32(d: int) -> int:
    """Shared memory of a float block of the streamed forward
    (csrc/flash_fwd.cuh flash_smem_f32)."""
    return (4 * _align128(4 * _F32_ROWS * (d + 4))
            + _align128(4 * _F32_ROWS * (_F32_ROWS + 4))
            + _align128(4 * _F32_ROWS))


def fits_single_block(s: int) -> bool:
    """True when a sequence fits one kv block of the single-block
    kernels (the fused ViT block, ``fused_mha``): S rounded up to 128 is
    at most 512."""
    return _round_up(s, _LANES) <= 512


def dropout_cutoff(rate: float) -> int:
    """keep where the 32 random bits are >= this (the JAX kernels' rule,
    ``_dropout_cutoff``)."""
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def _heads(t: torch.Tensor, heads: int, d: int, part: int):
    """The per-head column slices of part ``part`` (0 q, 1 k, 2 v) of a
    packed (B, S, 3HD) tensor, or of a (B, S, HD) one with ``part`` 0."""
    return [t[..., (part * heads + i) * d:(part * heads + i + 1) * d]
            for i in range(heads)]


def mha_dropout_masks(seed: int, rate: float, b: int, s: int, heads: int,
                      device) -> torch.Tensor:
    """The keep mask (B, H, S, S) bool that ``fused_mha`` applies to the
    attention probabilities on ``device`` for this seed and rate (keep
    where the 32 random bits are ≥ ``dropout_cutoff(rate)``): on the card
    the kernels' Philox mask, written by the library's mask kernel; on the
    CPU a mask drawn from a ``torch.Generator`` seeded with ``seed``."""
    device = torch.device(device)
    shape = (b, heads, s, s)
    if device.type == "cpu":
        gen = torch.Generator().manual_seed(int(seed))
        return torch.randint(0, 1 << 32, shape, generator=gen) \
            >= dropout_cutoff(rate)
    from devt_tpu_torch.ops import _build

    lib = _build.load("mha_fwd", _declare_fwd)
    keep = torch.empty(shape, dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.devt_mha_dropout_masks(
            ctypes.c_void_p(keep.data_ptr()), b, heads, s,
            ctypes.c_double(rate), ctypes.c_ulonglong(int(seed)),
            ctypes.c_void_p(stream))
    _check_rc(lib, rc, "mha_dropout_masks")
    return keep.bool()


def fused_mha_plain(qkv: torch.Tensor, heads: int, scale: float,
                    kv_len: int, keep: torch.Tensor | None = None,
                    rate: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel, step by step with the
    TPU kernel's roundings: qkv (B, S, 3HD) → (o (B, S, HD) in qkv's
    dtype, lse (B, S, H) f32).  ``keep``: the (B, H, S, S) mask of a
    ``rate`` > 0, applied after the normalisation."""
    dtype = qkv.dtype
    d = qkv.shape[-1] // (3 * heads)
    col = torch.arange(qkv.shape[1], device=qkv.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=qkv.device)
    zero = torch.zeros((), dtype=torch.float32, device=qkv.device)
    outs, lses = [], []
    for i, (q, k, v) in enumerate(zip(*(_heads(qkv, heads, d, j)
                                        for j in range(3)))):
        s = (q.float() @ k.float().transpose(1, 2)) * scale
        s = torch.where(col < kv_len, s, neg)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        pn = p / l
        if keep is not None:
            pn = torch.where(keep[:, i], pn / (1.0 - rate), zero)
        outs.append((pn.to(dtype).float() @ v.float()).to(dtype))
        lses.append(m + torch.log(l))
    return torch.cat(outs, dim=-1), torch.cat(lses, dim=-1)


def fused_mha_bwd_plain(qkv: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, heads: int,
                        scale: float, kv_len: int,
                        keep: torch.Tensor | None = None,
                        rate: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel, the steps and
    roundings of ``_mha_bwd_kernel``: from qkv, the stored output o and its
    gradient do (qkv's dtype) and lse (B, S, H) f32, per head

        delta = rowsum(f32(do) · f32(o))
        p     = exp(s - lse);  mask = where(keep, 1/(1-rate), 0)
        dv    = (p · mask, cast to do's dtype)ᵀ @ do
        dp    = (do @ vᵀ) · mask;   ds = p · (dp - delta) · scale
        dq    = (ds cast to k's dtype) @ k;  dk = (ds cast to q's dtype)ᵀ @ q

    with every product summed in f32 → dqkv (B, S, 3HD) in qkv's dtype,
    columns ordered like qkv's.  Keys at or past kv_len get exact zeros."""
    dtype = qkv.dtype
    d = qkv.shape[-1] // (3 * heads)
    col = torch.arange(qkv.shape[1], device=qkv.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=qkv.device)
    inv = torch.full((), 1.0 / (1.0 - rate), dtype=torch.float32,
                     device=qkv.device)
    zero = torch.zeros((), dtype=torch.float32, device=qkv.device)
    dqs, dks, dvs = [], [], []
    for i, (q, k, v, oi, doi) in enumerate(zip(
            *(_heads(qkv, heads, d, j) for j in range(3)),
            _heads(o, heads, d, 0), _heads(do, heads, d, 0))):
        do32 = doi.float()
        delta = (do32 * oi.float()).sum(dim=-1, keepdim=True)
        s = (q.float() @ k.float().transpose(1, 2)) * scale
        s = torch.where(col < kv_len, s, neg)
        p = torch.exp(s - lse[..., i:i + 1])
        mask = torch.where(keep[:, i], inv, zero) if keep is not None \
            else None
        pm = p * mask if mask is not None else p
        dvs.append(pm.to(dtype).float().transpose(1, 2) @ do32)
        dp = do32 @ v.float().transpose(1, 2)
        if mask is not None:
            dp = dp * mask
        ds = (p * (dp - delta) * scale).to(dtype).float()
        dqs.append(ds @ k.float())
        dks.append(ds.transpose(1, 2) @ q.float())
    return torch.cat(dqs + dks + dvs, dim=-1).to(dtype)


def _check_mha_args(qkv: torch.Tensor, heads: int, kv_len: int,
                    backward: bool = False) -> int:
    """Raise on what the forward kernel (or, with ``backward``, the
    backward kernel) does not take; returns the head dim."""
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_mha takes float32 or bfloat16 qkv, got "
                        f"{qkv.dtype}")
    if qkv.dim() != 3 or not qkv.is_contiguous():
        raise ValueError(f"qkv must be a contiguous (B, S, 3*H*D) tensor, "
                         f"got shape {tuple(qkv.shape)}")
    _, s, f = qkv.shape
    d = f // (3 * heads)
    if 3 * heads * d != f:
        raise ValueError(f"qkv's last axis ({f}) is not 3 * heads ({heads}) "
                         f"* head dim")
    if not 1 <= kv_len <= s:
        raise ValueError(f"kv_len must be in [1, {s}], got {kv_len}")
    sp = _round_up(s, 16)
    if qkv.dtype == torch.bfloat16:
        if d not in _MHA_BF16_HEAD_DIMS:
            raise ValueError(f"the bfloat16 kernel is compiled for head dims "
                             f"{_MHA_BF16_HEAD_DIMS}, got {d}")
        if backward:
            # the shared memory of the body the shape takes
            body = mha_bwd_on_wgmma(qkv.dtype, d, s, kv_len, 0.0)
            need = _bwd_smem_bf16(sp, d) if body == "streamed" \
                else _mha_bwd_wgmma_smem(body, d)
        else:
            # K and V streamed in key tiles: any S
            need = _fwd_smem_tiled(d)
    else:
        if d % 4:
            raise ValueError(f"the float32 kernel needs a head dim that is a "
                             f"multiple of 4, got {d}")
        if backward:
            need = _bwd_smem_f32(sp, d)
        else:
            need = ((2 * 32 + 2 * sp) * (d + 4) + 32 * (sp + 4) + 64) * 4 \
                + 1024
    if need > _SMEM_PER_BLOCK:
        which = "backward" if backward else "forward"
        raise ValueError(
            f"the {which} kernel keeps a head's rows in shared memory: {s} "
            f"tokens (kv_len {kv_len}) of head dim {d} need {need} bytes, a "
            f"block has {_SMEM_PER_BLOCK}")
    return d


def _check_rc(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.devt_cuda_error_string(rc).decode()} ({rc})")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _require(device, *specs) -> None:
    """Raise unless each (name, tensor, shape, dtype) of ``specs`` is a
    contiguous tensor of that shape and dtype on ``device``."""
    for name, t, shape, dtype in specs:
        if t.dtype != dtype or tuple(t.shape) != shape \
                or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dtype} tensor of "
                             f"shape {shape} on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _mha_cuda(qkv, heads, scale, kv_len, rate=0.0, seed=0):
    """Kernel 3: o and lse, on the body the C entry's ``devt_mha_fwd_route``
    names, counted by body."""
    d = _check_mha_args(qkv, heads, kv_len)
    from devt_tpu_torch.ops import _build

    lib = _build.load("mha_fwd", _declare_fwd)
    qkv = _aligned(qkv)   # the wgmma bodies read it through TMA maps
    b, s, _ = qkv.shape
    o = torch.empty((b, s, heads * d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, s, heads), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.devt_mha_fwd(
            _DTYPE_CODE[qkv.dtype], _ptr(qkv), _ptr(o), _ptr(lse), b, s,
            heads, d, int(kv_len), ctypes.c_float(scale),
            ctypes.c_double(rate), ctypes.c_ulonglong(seed),
            ctypes.c_void_p(stream))
    _check_rc(lib, rc, "mha_fwd")
    fused_mha.launches += 1
    body = _MHA_BODIES[lib.devt_mha_fwd_route(
        _DTYPE_CODE[qkv.dtype], d, s, int(kv_len), ctypes.c_double(rate))]
    if body == "packed":
        fused_mha.packed_launches += 1
    elif body == "one_shot":
        fused_mha.one_shot_launches += 1
    else:
        fused_mha.streamed_launches += 1
    return o, lse


def _mha_bwd_cuda(qkv, o, lse, do, heads, scale, kv_len, rate=0.0, seed=0):
    """Kernel 4: dqkv, on the body the C entry's ``devt_mha_bwd_route``
    names, counted by body."""
    d = _check_mha_args(qkv, heads, kv_len, backward=True)
    b, s, _ = qkv.shape
    _require(qkv.device, ("o", o, (b, s, heads * d), qkv.dtype),
             ("do", do, (b, s, heads * d), qkv.dtype),
             ("lse", lse, (b, s, heads), torch.float32))
    from devt_tpu_torch.ops import _build

    lib = _build.load("mha_bwd", _declare_bwd)
    body = _MHA_BWD_BODIES[lib.devt_mha_bwd_route(
        _DTYPE_CODE[qkv.dtype], d, s, int(kv_len), ctypes.c_double(rate))]
    # the wgmma bodies read qkv, o and do through TMA maps
    qkv, o, do = (_aligned(t) for t in (qkv, o, do))
    dqkv = torch.empty_like(qkv)
    # the packed body takes delta from its tiles: no scratch
    delta = None if body == "packed" else torch.empty(
        (b, s, heads), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.devt_mha_bwd(
            _DTYPE_CODE[qkv.dtype], _ptr(qkv), _ptr(o), _ptr(do), _ptr(lse),
            ctypes.c_void_p(None if delta is None else delta.data_ptr()),
            _ptr(dqkv), b, s, heads, d, int(kv_len), ctypes.c_float(scale),
            ctypes.c_double(rate), ctypes.c_ulonglong(seed),
            ctypes.c_void_p(stream))
    _check_rc(lib, rc, "mha_bwd")
    fused_mha.bwd_launches += 1
    if body == "packed":
        fused_mha.bwd_packed_launches += 1
    elif body == "wgmma":
        fused_mha.bwd_wgmma_launches += 1
    else:
        fused_mha.bwd_streamed_launches += 1
    return dqkv


def _mha_impl(qkv, heads, scale, kv_len, rate, seed):
    if qkv.device.type == "cuda":
        return _mha_cuda(qkv, heads, scale, kv_len, rate, seed)
    keep = mha_dropout_masks(seed, rate, qkv.shape[0], qkv.shape[1], heads,
                             qkv.device) if rate > 0.0 else None
    return fused_mha_plain(qkv, heads, scale, kv_len, keep, rate)


def _mha_fake(qkv, heads, scale, kv_len, rate, seed):
    b, s, f = qkv.shape
    return (qkv.new_empty((b, s, f // 3)),
            qkv.new_empty((b, s, heads), dtype=torch.float32))


# kernel 3: (o, lse)
mha_fwd_op = kernel_op(
    "mha_fwd", "(Tensor qkv, int heads, float scale, int kv_len, float rate, "
    "int seed) -> (Tensor, Tensor)", _mha_impl, _mha_fake)


class FusedMHA(torch.autograd.Function):
    """The packed-qkv attention with its backward: the kernels for CUDA
    tensors, the plain versions for CPU tensors; the forward through the
    ``devt_tpu_torch::mha_fwd`` op (``ops/_library.py``).  Saves (qkv, o,
    lse) and the seed; the backward regenerates the dropout mask from the
    seed."""

    @staticmethod
    def forward(ctx, qkv, heads, scale, kv_len, rate, seed):
        if qkv.device.type == "cuda" and ctx.needs_input_grad[0]:
            # a shape the backward does not take fails before the work
            _check_mha_args(qkv, heads, kv_len, backward=True)
        o, lse = mha_fwd_op(qkv, heads, scale, kv_len, rate, seed)
        ctx.save_for_backward(qkv, o, lse)
        ctx.args = (heads, scale, kv_len, rate, seed)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        qkv, o, lse = ctx.saved_tensors
        heads, scale, kv_len, rate, seed = ctx.args
        # the gradient crosses the kernel boundary in qkv's dtype
        do = do.to(qkv.dtype).contiguous()
        if qkv.device.type == "cuda":
            dqkv = _mha_bwd_cuda(qkv, o, lse, do, heads, scale, kv_len, rate,
                                 seed)
        else:
            keep = mha_dropout_masks(seed, rate, qkv.shape[0], qkv.shape[1],
                                     heads, qkv.device) if rate > 0.0 \
                else None
            dqkv = fused_mha_bwd_plain(qkv, o, lse, do, heads, scale, kv_len,
                                       keep, rate)
        return dqkv, None, None, None, None, None


def fused_mha(qkv: torch.Tensor, *, heads: int, scale: float | None = None,
              kv_len: int | None = None, dropout_rate: float = 0.0,
              seed: int | None = None, return_lse: bool = False):
    """Packed-qkv attention, differentiable in qkv.  qkv (B, S, 3*H*D),
    last axis ordered (3, H, D) → (B, S, H*D); with ``return_lse`` also
    lse (B, S, H) f32 (not differentiable).  Single-kv-block sequences
    only (``fits_single_block``); the callers dispatch longer ones
    elsewhere.

    ``dropout_rate`` > 0 drops attention probabilities after the softmax
    (torch ``MultiheadAttention``'s dropout) and needs ``seed``, an int the
    caller draws once per call (the JAX wrapper draws ``randint(0,
    2**30)``); the backward applies the same mask.

    A CUDA tensor launches the kernels (raising on a shape they do not
    cover or a failed launch); a CPU tensor runs the plain versions."""
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (B, S, 3*H*D), got {tuple(qkv.shape)}")
    d = qkv.shape[-1] // (3 * heads)
    if scale is None:
        scale = d ** -0.5
    kv_len = qkv.shape[1] if kv_len is None else int(kv_len)
    rate = float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 needs a seed")
    o, lse = FusedMHA.apply(qkv, heads, float(scale), kv_len, rate,
                            int(seed) if rate > 0.0 else 0)
    return (o, lse) if return_lse else o


fused_mha.launches = 0
fused_mha.bwd_launches = 0
fused_mha.packed_launches = 0
fused_mha.one_shot_launches = 0
fused_mha.streamed_launches = 0
fused_mha.bwd_packed_launches = 0
fused_mha.bwd_wgmma_launches = 0
fused_mha.bwd_streamed_launches = 0


def _declare_fwd(lib: ctypes.CDLL) -> None:
    lib.devt_mha_fwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_double, ctypes.c_ulonglong,
           ctypes.c_void_p])
    lib.devt_mha_fwd.restype = ctypes.c_int
    lib.devt_mha_dropout_masks.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 3
        + [ctypes.c_double, ctypes.c_ulonglong, ctypes.c_void_p])
    lib.devt_mha_dropout_masks.restype = ctypes.c_int
    lib.devt_mha_fwd_route.argtypes = [ctypes.c_int] * 4 + [ctypes.c_double]
    lib.devt_mha_fwd_route.restype = ctypes.c_int
    lib.devt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.devt_cuda_error_string.restype = ctypes.c_char_p


def _declare_bwd(lib: ctypes.CDLL) -> None:
    lib.devt_mha_bwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_double, ctypes.c_ulonglong,
           ctypes.c_void_p])
    lib.devt_mha_bwd.restype = ctypes.c_int
    lib.devt_mha_bwd_route.argtypes = [ctypes.c_int] * 4 + [ctypes.c_double]
    lib.devt_mha_bwd_route.restype = ctypes.c_int
    lib.devt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.devt_cuda_error_string.restype = ctypes.c_char_p


# ---------------------------------------------------------------------------
# Attention on split q, k, v: kernels 9, 10 and 11
# ---------------------------------------------------------------------------

def _scores(q, k, scale, kv_len, k0=0):
    """f32 scores q kᵀ·scale of (…, Sq, d) and (…, n, d), key columns
    k0 + j at or past kv_len at -1e30."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    col = torch.arange(k0, k0 + k.shape[-2], device=q.device)
    return torch.where(col < kv_len, s,
                       torch.full((), NEG_INF, device=q.device))


def flash_single_fwd_plain(q, k, v, scale, kv_len):
    """Plain PyTorch version of kernel 9 (``_fwd_single_kernel``): q, k, v
    (B, H, S, d) → o (B, H, S, d) in q's dtype and lse (B·H, S) f32, with
    the exact row max and p / l rounded to v's dtype before the product."""
    s = _scores(q, k, scale, kv_len)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = ((p / l).to(v.dtype).float() @ v.float()).to(q.dtype)
    return o, (m + torch.log(l)).reshape(-1, q.shape[-2])


def flash_single_bwd_plain(q, k, v, o, lse, do, scale, kv_len):
    """Plain PyTorch version of kernel 10 (``_bwd_single_kernel``): from
    q, k, v, the stored o and its gradient do (B, H, S, d) and lse (B·H, S)
    f32 →

        delta = rowsum(f32(do) · f32(o));  p = exp(s - lse)
        dv = round(p)ᵀ @ do;  dp = do @ vᵀ;  ds = p · (dp - delta) · scale
        dq = round(ds) @ k;   dk = round(ds)ᵀ @ q

    every product summed in f32, round() the cast to the other operand's
    dtype; (dq, dk, dv) in the dtypes of (q, k, v)."""
    do32 = do.float()
    delta = (do32 * o.float()).sum(dim=-1, keepdim=True)
    p = torch.exp(_scores(q, k, scale, kv_len) - lse.reshape(
        *q.shape[:-1], 1))
    dv = p.to(do.dtype).float().transpose(-1, -2) @ do32
    dp = do32 @ v.float().transpose(-1, -2)
    ds = p * (dp - delta) * scale
    dq = ds.to(k.dtype).float() @ k.float()
    dk = ds.to(q.dtype).float().transpose(-1, -2) @ q.float()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_blocked_fwd_plain(q, k, v, scale, kv_len):
    """Plain PyTorch version of kernel 11 (``_fwd_kernel``), block by block
    as the TPU kernel runs: q (B, H, Sq, d), k and v (B, H, Skv, d) → o (B,
    H, Sq, d) in q's dtype and lse (B·H, Sq) f32.  Per 128-key block:
    m_new = max(m, max s), p = exp(s - m_new), alpha = exp(m - m_new),
    l = alpha·l + Σp, acc = acc·alpha + round(p) @ v (round: the cast to
    v's dtype); at the end o = acc / l, lse = m + log l."""
    shape = (*q.shape[:-1], 1)
    m = torch.full(shape, NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(shape, dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, k.shape[-2], _BLOCK_KV):
        kb, vb = k[..., k0:k0 + _BLOCK_KV, :], v[..., k0:k0 + _BLOCK_KV, :]
        s = _scores(q, kb, scale, kv_len, k0)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vb.float()
        m = m_new
    return (acc / l).to(q.dtype), (m + torch.log(l)).reshape(-1, q.shape[-2])


def flash_blocked_bwd_plain(q, k, v, o, lse, do, scale, kv_len):
    """Plain PyTorch version of kernels 12 and 13 (``_bwd_dq_kernel``,
    ``_bwd_dkv_kernel``), block by block as the TPU kernels run: from q
    (B, H, Sq, d), k and v (B, H, Skv, d), the stored o and its gradient do
    (B, H, Sq, d) and lse (B·H, Sq) f32, with delta = rowsum(f32(do) ·
    f32(o)) and, per block, p = exp(s - lse) and ds = p · (do vᵀ - delta) ·
    scale:

        dq = Σ over 128-key blocks    round(ds) @ k    (to k's dtype)
        dv = Σ over 128-query blocks  round(p)ᵀ @ do   (to do's dtype)
        dk = Σ over 128-query blocks  round(ds)ᵀ @ q   (to q's dtype)

    each product and each sum in f32; (dq, dk, dv) in the dtypes of (q, k,
    v).  Key columns at or past kv_len have p = 0.  The TPU wrapper pads Sq
    with zero rows, whose zero do makes their terms exact zeros; here the
    last query block is short instead."""
    do32 = do.float()
    delta = (do32 * o.float()).sum(dim=-1, keepdim=True)
    lse = lse.reshape(*q.shape[:-1], 1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, k.shape[-2], _BLOCK_KV):
        kb, vb = k[..., k0:k0 + _BLOCK_KV, :], v[..., k0:k0 + _BLOCK_KV, :]
        p = torch.exp(_scores(q, kb, scale, kv_len, k0) - lse)
        ds = p * (do32 @ vb.float().transpose(-1, -2) - delta) * scale
        dq += ds.to(k.dtype).float() @ kb.float()
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for q0 in range(0, q.shape[-2], _BLOCK_KV):
        rows = slice(q0, q0 + _BLOCK_KV)
        qb, dob = q[..., rows, :], do32[..., rows, :]
        p = torch.exp(_scores(qb, k, scale, kv_len) - lse[..., rows, :])
        dv += p.to(do.dtype).float().transpose(-1, -2) @ dob
        ds = p * (dob @ v.float().transpose(-1, -2)
                  - delta[..., rows, :]) * scale
        dk += ds.to(q.dtype).float().transpose(-1, -2) @ qb.float()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    return t.stride(0), t.stride(1), t.stride(2)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a contiguous copy when its rows are not contiguous or, in
    bfloat16, not 16-byte aligned or with an outer stride ((sequence, head,
    row), or (sequence, row) of a packed (B, S, H·d) tensor) that is no
    positive multiple of 8 elements: cp.async copies 16 bytes at a time,
    and a TMA map takes byte strides that are nonzero multiples of 16.  The
    head views of a packed qkv with d a multiple of 8 need no copy.  The
    copy is a fresh allocation (``contiguous()`` would hand back a
    contiguous tensor that starts off a 16-byte boundary as it is)."""
    ok = t.stride(-1) == 1
    if ok and t.dtype == torch.bfloat16:
        ok = t.data_ptr() % 16 == 0 and all(st > 0 and st % 8 == 0
                                            for st in t.stride()[:-1])
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _check_flash_args(q, k, v, kv_len, backward: bool = False) -> int:
    """Raise on what kernels 9 and 11 (with ``backward``, also kernel 10)
    do not take; returns d."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B, H, S, d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, _, d = q.shape
    skv = k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device \
                or tuple(t.shape) != (b, h, skv, d):
            raise ValueError(f"{name}: need a {q.dtype} tensor of shape "
                             f"{(b, h, skv, d)} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not 1 <= kv_len <= skv:
        raise ValueError(f"kv_len must be in [1, {skv}], got {kv_len}")
    if q.dtype == torch.bfloat16:
        if d not in _BF16_HEAD_DIMS:
            raise ValueError(f"the bfloat16 kernels are compiled for head "
                             f"dims {_BF16_HEAD_DIMS}, got {d}")
    else:
        # q, k, v and o tiles of 32 rows, the 32 x 32 score tile, a row's
        # alpha (csrc/flash_fwd.cuh flash_smem_f32); with ``backward``
        # also the backward's tiles
        need = _fwd_smem_f32(d)
        if backward:
            need = max(need, _bwd_smem_f32(_round_up(max(q.shape[2], skv),
                                                      16), d))
        if d % 4 or need > _SMEM_PER_BLOCK:
            raise ValueError(f"the float32 kernels need a head dim that is a "
                             f"multiple of 4 whose tiles fit a block's "
                             f"shared memory; got {d} ({need} bytes)")
    return d


def _flash_fwd_cuda(q, k, v, scale, kv_len, online):
    d = _check_flash_args(q, k, v, kv_len)
    from devt_tpu_torch.ops import _build

    lib = _build.load("flash_fwd", _declare_flash_fwd)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    b, h, sq, _ = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 9)(*_strides(q), *_strides(k),
                                      *_strides(v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.devt_flash_fwd(
            _DTYPE_CODE[q.dtype], int(online), _ptr(q), _ptr(k), _ptr(v),
            _ptr(o), _ptr(lse), b, h, sq, k.shape[2], d, int(kv_len),
            strides, ctypes.c_float(scale), ctypes.c_void_p(stream))
    _check_rc(lib, rc, "flash_fwd")
    if online:
        flash_attention.blocked_launches += 1
        if online_on_wgmma(q.dtype, d):
            flash_attention.blocked_wgmma_launches += 1
        else:
            flash_attention.blocked_streamed_launches += 1
    else:
        flash_attention.single_launches += 1
        if one_shot_on_wgmma(q.dtype, d, kv_len):
            flash_attention.single_wgmma_launches += 1
        else:
            flash_attention.single_streamed_launches += 1
    return o, lse


def _check_bwd_inputs(q, o, lse, do) -> None:
    """Raise unless o and do are contiguous (B, H, Sq, d) in q's dtype and
    lse a contiguous (B·H, Sq) f32 tensor, on q's device."""
    b, h, sq, d = q.shape
    _require(q.device, ("o", o, (b, h, sq, d), q.dtype),
             ("do", do, (b, h, sq, d), q.dtype),
             ("lse", lse, (b * h, sq), torch.float32))


def _flash_bwd_cuda(q, k, v, o, lse, do, scale, kv_len):
    """Kernel 10: dq, dk, dv at Sq == Skv; on the wgmma bodies where the
    C entry's ``devt_blocked_bwd_route`` says, counted by body."""
    d = _check_flash_args(q, k, v, kv_len, backward=True)
    _check_bwd_inputs(q, o, lse, do)
    from devt_tpu_torch.ops import _build

    lib = _build.load("flash_bwd", _declare_flash_bwd)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o, do = _aligned(o), _aligned(do)   # a TMA map reads do
    b, h, s, _ = q.shape
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    delta = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 9)(*_strides(q), *_strides(k),
                                      *_strides(v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.devt_flash_bwd(
            _DTYPE_CODE[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(o),
            _ptr(do), _ptr(lse), _ptr(delta), _ptr(dq), _ptr(dk), _ptr(dv),
            b, h, s, d, int(kv_len), strides, ctypes.c_float(scale),
            ctypes.c_void_p(stream))
    _check_rc(lib, rc, "flash_bwd")
    fa = flash_attention
    fa.single_bwd_launches += 1
    if lib.devt_blocked_bwd_route(_DTYPE_CODE[q.dtype], d):
        fa.single_bwd_wgmma_launches += 1
    else:
        fa.single_bwd_streamed_launches += 1
    return dq, dk, dv


def _flash_blocked_call(part, q, k, v, o, lse, do, delta, outs, scale,
                        kv_len):
    """One call of ``devt_flash_blocked_bwd``: part 1 writes delta and dq
    (outs[0]), part 2 dk and dv (outs[1], outs[2]) from that delta.
    Returns whether the entry took the wgmma body, as its
    ``devt_blocked_bwd_route`` says."""
    d = _check_flash_args(q, k, v, kv_len, backward=True)
    _check_bwd_inputs(q, o, lse, do)
    from devt_tpu_torch.ops import _build

    lib = _build.load("flash_bwd", _declare_flash_bwd)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o, do = _aligned(o), _aligned(do)   # a TMA map reads do
    b, h, sq, _ = q.shape
    strides = (ctypes.c_longlong * 9)(*_strides(q), *_strides(k),
                                      *_strides(v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.devt_flash_blocked_bwd(
            _DTYPE_CODE[q.dtype], part, _ptr(q), _ptr(k), _ptr(v), _ptr(o),
            _ptr(do), _ptr(lse), _ptr(delta), *(_ptr(t) for t in outs), b,
            h, sq, k.shape[2], d, int(kv_len), strides,
            ctypes.c_float(scale), ctypes.c_void_p(stream))
    _check_rc(lib, rc, f"flash_blocked_bwd part {part}")
    return bool(lib.devt_blocked_bwd_route(_DTYPE_CODE[q.dtype], d))


def _flash_blocked_dq_cuda(q, k, v, o, lse, do, scale, kv_len):
    """Kernel 12: delta = rowsum(do · o), then dq → (dq, delta)."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    wgmma = _flash_blocked_call(1, q, k, v, o, lse, do, delta, (dq, dq, dq),
                                scale, kv_len)
    fa = flash_attention
    fa.blocked_dq_launches += 1
    if wgmma:
        fa.blocked_dq_wgmma_launches += 1
    else:
        fa.blocked_dq_streamed_launches += 1
    return dq, delta


def _flash_blocked_dkv_cuda(q, k, v, o, lse, do, delta, scale, kv_len):
    """Kernel 13: dk and dv from the delta of kernel 12."""
    dk, dv = (torch.empty(k.shape, dtype=q.dtype, device=q.device)
              for _ in range(2))
    wgmma = _flash_blocked_call(2, q, k, v, o, lse, do, delta, (dk, dk, dv),
                                scale, kv_len)
    fa = flash_attention
    fa.blocked_dkv_launches += 1
    if wgmma:
        fa.blocked_dkv_wgmma_launches += 1
    else:
        fa.blocked_dkv_streamed_launches += 1
    return dk, dv


def _flash_blocked_bwd_cuda(q, k, v, o, lse, do, scale, kv_len):
    dq, delta = _flash_blocked_dq_cuda(q, k, v, o, lse, do, scale, kv_len)
    return (dq, *_flash_blocked_dkv_cuda(q, k, v, o, lse, do, delta, scale,
                                         kv_len))


def _flash_single_impl(q, k, v, scale, kv_len):
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, scale, kv_len, online=False)
    return flash_single_fwd_plain(q, k, v, scale, kv_len)


def _flash_blocked_impl(q, k, v, scale, kv_len):
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, scale, kv_len, online=True)
    return flash_blocked_fwd_plain(q, k, v, scale, kv_len)


def _flash_fake(q, k, v, scale, kv_len):
    b, h, sq, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b * h, sq), dtype=torch.float32))


_FLASH_SCHEMA = ("(Tensor q, Tensor k, Tensor v, float scale, int kv_len) -> "
                 "(Tensor, Tensor)")
# kernels 9 and 11: (o, lse)
flash_single_fwd_op = kernel_op("flash_single_fwd", _FLASH_SCHEMA,
                                _flash_single_impl, _flash_fake)
flash_blocked_fwd_op = kernel_op("flash_blocked_fwd", _FLASH_SCHEMA,
                                 _flash_blocked_impl, _flash_fake)


class _Flash(torch.autograd.Function):
    """The split-q/k/v attention with its backward, saving (q, k, v, o,
    lse) as the JAX ``custom_vjp``s do: kernels for CUDA tensors, the plain
    versions for CPU tensors; the forward through the op ``fwd_op``
    (``devt_tpu_torch::flash_single_fwd`` or ``::flash_blocked_fwd``).
    ``FlashSingle`` and ``FlashBlocked`` name the two pairs."""

    fwd_op = bwd_plain = bwd_cuda = None

    @classmethod
    def forward(cls, ctx, q, k, v, scale, kv_len):
        o, lse = cls.fwd_op(q, k, v, scale, kv_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (scale, kv_len)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @classmethod
    def backward(cls, ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        scale, kv_len = ctx.args
        # the gradient crosses the kernel boundary in q's dtype
        do = do.to(q.dtype).contiguous()
        run = cls.bwd_cuda if q.device.type == "cuda" else cls.bwd_plain
        dq, dk, dv = run(q, k, v, o, lse, do, scale, kv_len)
        return dq, dk, dv, None, None


class FlashSingle(_Flash):
    """Sq == Skv ≤ 512: kernels 9 and 10 (``_flash_single``'s VJP)."""

    fwd_op = staticmethod(flash_single_fwd_op)
    bwd_plain = staticmethod(flash_single_bwd_plain)
    bwd_cuda = staticmethod(_flash_bwd_cuda)


class FlashBlocked(_Flash):
    """Above one kv block: kernel 11 and kernels 12, 13 (``_flash_padded``'s
    VJP)."""

    fwd_op = staticmethod(flash_blocked_fwd_op)
    bwd_plain = staticmethod(flash_blocked_bwd_plain)
    bwd_cuda = staticmethod(_flash_blocked_bwd_cuda)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None, kv_len: int | None = None,
                    return_lse: bool = False):
    """Softmax attention on split heads, differentiable in q, k and v: q
    (B, H, Sq, d), k and v (B, H, Skv, d) → o (B, H, Sq, d) in q's dtype;
    with ``return_lse`` also lse (B·H, Sq) f32 (not differentiable).
    ``scale`` defaults to d^-0.5; ``kv_len`` masks key positions at and
    beyond it (default Skv).

    Sq == Skv ≤ 512 (the JAX rule, ``fits_single_block``) takes kernel 9,
    its backward kernel 10; anything else kernel 11, its backward kernels
    12 and 13.  An input that needs a gradient, on the card, is checked
    against the backward's limits before the forward runs.

    A CUDA tensor launches the kernels (raising on a shape they do not
    cover or a failed launch); a CPU tensor runs the plain versions."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, S, d), got {tuple(q.shape)}")
    sq, d = q.shape[2], q.shape[3]
    skv = k.shape[2]
    scale = float(d ** -0.5 if scale is None else scale)
    kv_len = skv if kv_len is None else int(kv_len)
    if q.device.type == "cuda" and torch.is_grad_enabled() \
            and any(t.requires_grad for t in (q, k, v)):
        # a shape the backward does not take fails before the work
        _check_flash_args(q, k, v, kv_len, backward=True)
    fn = FlashSingle if sq == skv and fits_single_block(sq) else FlashBlocked
    o, lse = fn.apply(q, k, v, scale, kv_len)
    return (o, lse) if return_lse else o


flash_attention.single_launches = 0
flash_attention.single_wgmma_launches = 0
flash_attention.single_streamed_launches = 0
flash_attention.single_bwd_launches = 0
flash_attention.single_bwd_wgmma_launches = 0
flash_attention.single_bwd_streamed_launches = 0
flash_attention.blocked_launches = 0
flash_attention.blocked_wgmma_launches = 0
flash_attention.blocked_streamed_launches = 0
flash_attention.blocked_dq_launches = 0
flash_attention.blocked_dq_wgmma_launches = 0
flash_attention.blocked_dq_streamed_launches = 0
flash_attention.blocked_dkv_launches = 0
flash_attention.blocked_dkv_wgmma_launches = 0
flash_attention.blocked_dkv_streamed_launches = 0


def _declare_flash_fwd(lib: ctypes.CDLL) -> None:
    lib.devt_flash_fwd.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
           ctypes.c_void_p])
    lib.devt_flash_fwd.restype = ctypes.c_int
    lib.devt_one_shot_route.argtypes = [ctypes.c_int] * 3
    lib.devt_one_shot_route.restype = ctypes.c_int
    lib.devt_online_route.argtypes = [ctypes.c_int] * 2
    lib.devt_online_route.restype = ctypes.c_int
    lib.devt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.devt_cuda_error_string.restype = ctypes.c_char_p


def _declare_flash_bwd(lib: ctypes.CDLL) -> None:
    lib.devt_flash_bwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
           ctypes.c_void_p])
    lib.devt_flash_bwd.restype = ctypes.c_int
    lib.devt_flash_blocked_bwd.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
           ctypes.c_void_p])
    lib.devt_flash_blocked_bwd.restype = ctypes.c_int
    lib.devt_blocked_bwd_route.argtypes = [ctypes.c_int] * 2
    lib.devt_blocked_bwd_route.restype = ctypes.c_int
    lib.devt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.devt_cuda_error_string.restype = ctypes.c_char_p


# ---------------------------------------------------------------------------
# One hop of ring attention: kernels 14 and 15
# ---------------------------------------------------------------------------

def _ring_heads(q, kv, heads: int):
    """Per head i: (q_i, k_i, v_i) column slices of q (B, S, H·D) and the
    packed kv (B, S, 2·H·D): k_i at columns i·D, v_i at (H + i)·D."""
    d = q.shape[-1] // heads
    return [(q[..., i * d:(i + 1) * d], kv[..., i * d:(i + 1) * d],
             kv[..., (heads + i) * d:(heads + i + 1) * d])
            for i in range(heads)]


def ring_step_fwd_plain(q, kv, mask, heads: int, scale: float):
    """Plain PyTorch version of kernel 14 (``_ring_fwd_kernel``): q
    (B, S, H·D) the local queries, kv (B, S, 2·H·D) the packed shard held
    now, mask (1, S) an additive f32 column bias (0 or -1e30) → o
    (B, S, H·D) in q's dtype and lse (B, S, H) f32, per head

        s = q kᵀ · scale + mask;  m = max s;  p = exp(s - m);  l = Σ p
        o = round(p / l) @ v (round: the cast to v's dtype);  lse = m + log l

    A shard whose columns are all masked gives p = 1, l = S, a finite o
    and lse = -1e30 + log S."""
    outs, lses = [], []
    bias = mask.reshape(1, 1, -1).float()
    for qi, ki, vi in _ring_heads(q, kv, heads):
        s = (qi.float() @ ki.float().transpose(1, 2)) * scale + bias
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        outs.append(((p / l).to(vi.dtype).float() @ vi.float()).to(q.dtype))
        lses.append(m + torch.log(l))
    return torch.cat(outs, dim=-1), torch.cat(lses, dim=-1)


def ring_step_bwd_plain(q, kv, mask, o, lse, do, heads: int, scale: float):
    """Plain PyTorch version of kernel 15 (``_ring_bwd_kernel``): with o and
    do (B, S, H·D) in q's dtype and ``lse`` (B, S, H) f32, the GLOBAL
    logsumexp of the whole ring, per head

        delta = rowsum(f32(do) · f32(o));  p = exp(q kᵀ · scale + mask - lse)
        dv = round(p)ᵀ @ do;   ds = p · (do vᵀ - delta) · scale
        dq = round(ds) @ k;    dk = round(ds)ᵀ @ q

    every product in f32, round() the cast to the other operand's dtype →
    f32 partials dq (B, S, H·D) and dkv (B, S, 2·H·D), packed like kv."""
    bias = mask.reshape(1, 1, -1).float()
    d = q.shape[-1] // heads
    dqs, dks, dvs = [], [], []
    for i, (qi, ki, vi) in enumerate(_ring_heads(q, kv, heads)):
        cols = slice(i * d, (i + 1) * d)
        do32 = do[..., cols].float()
        delta = (do32 * o[..., cols].float()).sum(dim=-1, keepdim=True)
        s = (qi.float() @ ki.float().transpose(1, 2)) * scale + bias
        p = torch.exp(s - lse[..., i:i + 1])
        dvs.append(p.to(do.dtype).float().transpose(1, 2) @ do32)
        ds = p * (do32 @ vi.float().transpose(1, 2) - delta) * scale
        dqs.append(ds.to(ki.dtype).float() @ ki.float())
        dks.append(ds.to(qi.dtype).float().transpose(1, 2) @ qi.float())
    return torch.cat(dqs, dim=-1), torch.cat(dks + dvs, dim=-1)


def _check_ring_args(q, kv, mask, heads: int, backward: bool = False) -> int:
    """Raise on what kernels 14 (with ``backward``, also 15) do not take;
    returns the head dim."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the ring step takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.dim() != 3 or q.shape[-1] % heads:
        raise ValueError(f"q must be (B, S, H*D) with H = {heads}, got "
                         f"{tuple(q.shape)}")
    b, s, hd = q.shape
    d = hd // heads
    _require(q.device, ("q", q, (b, s, hd), q.dtype),
             ("kv", kv, (b, s, 2 * hd), q.dtype),
             ("mask", mask, (1, s), torch.float32))
    if q.dtype == torch.bfloat16:
        if d not in _BF16_HEAD_DIMS:
            raise ValueError(f"the bfloat16 kernels are compiled for head "
                             f"dims {_BF16_HEAD_DIMS}, got {d}")
        if q.data_ptr() % 16 or kv.data_ptr() % 16:
            raise ValueError("bfloat16 q and kv must be 16-byte aligned")
    else:
        need = _fwd_smem_f32(d)
        if backward:
            need = max(need, _bwd_smem_f32(_round_up(s, 16), d))
        if d % 4 or need > _SMEM_PER_BLOCK:
            raise ValueError(f"the float32 kernels need a head dim that is a "
                             f"multiple of 4 whose tiles fit a block's "
                             f"shared memory; got {d} ({need} bytes)")
    return d


def ring_step_fwd(q: torch.Tensor, kv: torch.Tensor, mask: torch.Tensor, *,
                  heads: int, scale: float):
    """One forward ring hop (JAX's ``ring_step_fwd``): q (B, S, H·D) local
    queries, kv (B, S, 2·H·D) the packed shard held now, mask (1, S) the
    additive f32 column bias → per-head block-normalised o (B, S, H·D) in
    q's dtype and lse (B, S, H) f32.  The TPU kernel broadcasts lse over
    128 lanes per head, (B, S, H·128); here it is one value per row and
    head, what ``_lse_heads`` makes of the TPU layout.

    A CUDA tensor launches kernel 14 (or raises); a CPU tensor runs its
    plain version."""
    if q.device.type == "cpu":
        return ring_step_fwd_plain(q, kv, mask, heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"ring_step_fwd runs on cuda or cpu, not {q.device}")
    d = _check_ring_args(q, kv, mask, heads)
    from devt_tpu_torch.ops import _build

    lib = _build.load("ring_step", _declare_ring)
    b, s, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, s, heads), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.devt_ring_step_fwd(
            _DTYPE_CODE[q.dtype], _ptr(q), _ptr(kv), _ptr(mask), _ptr(o),
            _ptr(lse), b, s, heads, d, ctypes.c_float(scale),
            ctypes.c_void_p(stream))
    _check_rc(lib, rc, "ring_step_fwd")
    ring_step_fwd.launches += 1
    if one_shot_on_wgmma(q.dtype, d, s):
        ring_step_fwd.wgmma_launches += 1
    else:
        ring_step_fwd.streamed_launches += 1
    return o, lse


def ring_step_bwd(q: torch.Tensor, kv: torch.Tensor, mask: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                  heads: int, scale: float):
    """One backward ring hop (JAX's ``ring_step_bwd``): the gradients of the
    global attention output with respect to the local q and the shard kv,
    given the stored o, its gradient do (B, S, H·D) in q's dtype and the
    global lse (B, S, H) f32 → f32 partials dq (B, S, H·D) and dkv
    (B, S, 2·H·D), which sum across hops (in bf16 they would round n
    times).

    A CUDA tensor launches kernel 15 (or raises), on the wgmma bodies where
    the C entry's ``devt_ring_bwd_route`` says, counted by body; a CPU
    tensor runs its plain version."""
    if q.device.type == "cpu":
        return ring_step_bwd_plain(q, kv, mask, o, lse, do, heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"ring_step_bwd runs on cuda or cpu, not {q.device}")
    d = _check_ring_args(q, kv, mask, heads, backward=True)
    b, s, hd = q.shape
    _require(q.device, ("o", o, (b, s, hd), q.dtype),
             ("do", do, (b, s, hd), q.dtype),
             ("lse", lse, (b, s, heads), torch.float32))
    from devt_tpu_torch.ops import _build

    lib = _build.load("ring_step", _declare_ring)
    o, do = _aligned(o), _aligned(do)   # TMA maps read do
    dq = torch.empty((b, s, hd), dtype=torch.float32, device=q.device)
    dkv = torch.empty((b, s, 2 * hd), dtype=torch.float32, device=q.device)
    delta = torch.empty((b, s, heads), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.devt_ring_step_bwd(
            _DTYPE_CODE[q.dtype], _ptr(q), _ptr(kv), _ptr(mask), _ptr(o),
            _ptr(do), _ptr(lse), _ptr(delta), _ptr(dq), _ptr(dkv), b, s,
            heads, d, ctypes.c_float(scale), ctypes.c_void_p(stream))
    _check_rc(lib, rc, "ring_step_bwd")
    ring_step_bwd.launches += 1
    if lib.devt_ring_bwd_route(_DTYPE_CODE[q.dtype], d):
        ring_step_bwd.wgmma_launches += 1
    else:
        ring_step_bwd.streamed_launches += 1
    return dq, dkv


ring_step_fwd.launches = 0
ring_step_fwd.wgmma_launches = 0
ring_step_fwd.streamed_launches = 0
ring_step_bwd.launches = 0
ring_step_bwd.wgmma_launches = 0
ring_step_bwd.streamed_launches = 0


def _declare_ring(lib: ctypes.CDLL) -> None:
    lib.devt_ring_step_fwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p])
    lib.devt_ring_step_fwd.restype = ctypes.c_int
    lib.devt_ring_step_bwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p])
    lib.devt_ring_step_bwd.restype = ctypes.c_int
    lib.devt_ring_bwd_route.argtypes = [ctypes.c_int] * 2
    lib.devt_ring_bwd_route.restype = ctypes.c_int
    lib.devt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.devt_cuda_error_string.restype = ctypes.c_char_p
