"""Fused pre-norm ViT block: CUDA kernels for both passes, and their
plain versions.

Port of ``devt_tpu/ops/fused_block.py`` (``_fwd_kernel`` and
``_bwd_kernel``, the Pallas kernels that ``fused_vit_block`` launches
once per ViT block and pass: 4 forward and 4 backward launches per ViViT
training step):

    a   = LN1(x)                      (γ1, β1; f32 stats)
    qkv = a @ Wqkv                    (no bias; columns ordered (3, H, d))
    att = MHA(qkv)                    (per head, additive -1e30 key mask,
                                       softmax normalised after PV)
    u   = x + drop(att @ Wo + bo)
    b   = LN2(u)
    y   = u + drop(drop(gelu_tanh(b @ W1 + bb1)) @ W2 + bb2)

Outputs y and u in x's dtype, and the residual lanes (B, S, 8) f32
``[lse (H), mu1, rstd1, mu2, rstd2, 0…]`` that the backward reads.
Matrix operands are rounded to x's dtype and products accumulate in f32;
LN statistics and softmax are f32.  The backward recomputes the forward
from (x, u, res) and returns dx and the 11 parameter gradients; the bias
and LN-parameter gradients are sums of unrounded f32 values, and each
gradient is cast to the dtype of the parameter tensor it belongs to.

The forward kernel (``csrc/fused_block_fwd.cu``, CUDA C++ for sm_90a):
  * Replaces ``devt_tpu/ops/fused_block.py:177 _fwd_kernel``, launched
    from ``_fwd_call`` (``:414``).
  * Bound at the main-path shape (512, 208, 192, 3 heads, MLP 768): per
    launch 2·208·522,240·512 ≈ 111.2 GFLOP (110.3 with the keys past
    kv_len left out, which need no work) against about 127 MB read and
    written (x, y, u in bf16, res in f32, weights), so it is
    compute-bound: about 0.11 ms on an H100 SXM at 989 TFLOP/s bf16.
  * Design: the TPU kernel holds 8 whole sequences in up to 100 MB of
    VMEM; a Hopper block has 227 KB of shared memory, and one sequence's
    f32 qkv (479 KB) does not fit.  So one wrapper call is three launches
    with intermediates (qkv, att, in x's dtype — the same rounding the
    TPU kernel applies) in global memory, mostly L2: LN1+qkv per 128
    rows; the attention; out-projection+LN2+FFN per 128 rows.  The bf16
    products run ``csrc/block_sm90.cuh``'s wgmma body: two consumer
    warpgroups of 64 rows and a producer warpgroup (one lane of it
    works) that streams the weight boxes by TMA through a ring of
    stages, a CTA a 128-row tile, the weights read in their (K, N)
    layout (MN-major), the FFN's hidden slice passed from the W1
    product's accumulators to the W2 product in registers.  The
    attention in bfloat16 with at most 256 live keys at head dim 16, 32
    or 64 (``attn_half_on_wgmma``: every main-path shape) runs
    ``csrc/flash_fwd_sm90.cuh``'s one-shot wgmma body in its
    normalise-after instance, as kernel 7's does; the other shapes and
    f32 ``csrc/attention_fwd.cuh``'s body.  The f32 route uses FMA loops;
    no library GEMM.

The backward kernel (``csrc/fused_block_bwd.cu``):
  * Replaces ``devt_tpu/ops/fused_block.py:240 _bwd_kernel``, launched
    from ``_bwd_call`` (``:455``).
  * Bound at the same shape: 2·(11·D² + 5·D·MLP + 6·kv_len·D) operations
    per row, 291.7 GFLOP, against about 0.17 GB moved: compute-bound,
    about 0.295 ms at 989 TFLOP/s bf16.
  * Design: the TPU grid runs in order and accumulates the parameter
    gradients in resident output blocks; CUDA blocks run concurrently.
    Row-tile kernels on ``csrc/block_sm90.cuh``'s wgmma body (LN1+qkv
    recompute; FFN recompute and backward to dz1; dz1·W1ᵀ with the LN2
    backward; doproj·Woᵀ; dqkv·Wqkvᵀ with the LN1 backward, all per 128
    rows) and the attention recompute and backward (where
    ``block_bwd_on_wgmma`` says, every main-path shape: att, do and delta
    from the stored lse on the one-shot forward's wgmma body, then kernels
    12's and 13's wgmma bodies; elsewhere per (head, sequence) on
    mma.sync; counted in ``bwd_wgmma_launches`` and
    ``bwd_streamed_launches``) leave the operands of the four weight
    gradients in global memory in x's dtype — the roundings the TPU
    kernel applies before those products — and the column sums of their
    rows in a partial buffer.  The four weight gradients are one launch
    of split-K products (128-row output tiles, 192, 128 or 64 columns
    wide: the widest that divides every product's width) into f32
    partials, the rows split so that the splits times the output tiles
    fill the card's SMs once (``kWgWaves``; a multiple of 64 rows), and a
    last kernel sums all partials in index order.  No atomics: **two runs give the
    same bits**.

Dropout: counter-based Philox4x32-10 keyed by the call's seed, counter
(site, flat element index), so an element's mask depends on neither grid
nor launch and the backward regenerates the forward's masks.  The plain
versions take the three ``keep`` masks as an argument; ``dropout_masks``
returns the masks a call with a given seed applies (on the card from the
kernels' own device function, on the CPU from a seeded
``torch.Generator``).  The kernels' times are in PERF.md.

``fused_vit_block`` launches the kernels for CUDA tensors (or raises) and
runs the plain versions only for CPU tensors.  Its ``launches`` and
``bwd_launches`` attributes count forward and backward kernel launches
(one per call and pass on the card); ``wgmma_launches`` and
``streamed_launches`` count the forward calls by the body of their
attention launch.

The attention half (``fused_attn_half``, the MoE block's: u = x +
MHA(LN1(x)) @ Wo + bo, no dropout) has kernels of its own in
``csrc/attn_half.cu``:
  * Kernel 7 replaces ``devt_tpu/ops/fused_block.py:556
    _attn_half_fwd_kernel`` (launched at ``:643``): the block forward's
    LN1 + qkv launch, the attention, then the out-projection per 64 rows.
    The attention in bfloat16 with at most 256 live keys at head dim 16,
    32 or 64 (``attn_half_on_wgmma``, kernel 9's rule ``one_shot_on_wgmma``
    with kv_len as the key count: every main-path shape) runs
    ``csrc/flash_fwd_sm90.cuh``'s one-shot wgmma body in its
    normalise-after instance, on the head views of the qkv scratch; the
    other shapes and float the block forward's attention
    (``csrc/attention_fwd.cuh``).  Bound at the main-path shape: 2·(4·D²
    + 2·kv_len·D) operations per row, 47.5 GFLOP against about 85 MB:
    compute-bound, about 0.048 ms.
  * Kernel 8 replaces ``:578 _attn_half_bwd_kernel`` (launched at
    ``:667``): the block backward's launches without the FFN, sharing
    their device code (``csrc/block_sm90.cuh``, ``csrc/block_bwd_parts.cuh``);
    split-K weight gradients and one fixed-order sum, so two runs give the
    same bits.
    2·(11·D² + 6·kv_len·D) operations per row, 134.7 GFLOP: about 0.136 ms.
``fused_attn_half`` keeps ``launches`` and ``bwd_launches`` counters too,
and counts kernel 7's calls by the body of their attention launch in
``wgmma_launches`` and ``streamed_launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from devt_tpu_torch.ops._library import kernel_op
from devt_tpu_torch.ops.flash_attention import (NEG_INF, _round_up,
                                                blocked_bwd_on_wgmma,
                                                dropout_cutoff,
                                                one_shot_on_wgmma)

LN_EPS = 1e-5
_GELU_C = math.sqrt(2.0 / math.pi)
_GELU_K = 0.044715

PARAM_NAMES = ("g1", "b1", "wqkv", "wo", "bo", "g2", "b2", "w1", "bb1",
               "w2", "bb2")
_MATRICES = ("wqkv", "wo", "w1", "w2")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (dim, head dim) pairs the bfloat16 kernels are instantiated for
# (csrc/fused_block_fwd.cu:launch_bf16): ViViT's, and a small test width
_BF16_WIDTHS = ((192, 64), (64, 32))
# dynamic shared memory one block can have on sm_90 (227 KB)
_SMEM_PER_BLOCK = 232448


def _ln(x32, gamma, beta):
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + LN_EPS)
    xhat = (x32 - mu) * rstd
    return xhat * gamma + beta, xhat, mu, rstd


def _gelu(z32):
    """tanh-approximation GELU, the fused block's (the unfused layers use
    exact erf)."""
    t = torch.tanh(_GELU_C * (z32 + _GELU_K * z32 * z32 * z32))
    return 0.5 * z32 * (1.0 + t)


def _dgelu(z32):
    inner = _GELU_C * (z32 + _GELU_K * z32 * z32 * z32)
    t = torch.tanh(inner)
    dinner = _GELU_C * (1.0 + 3.0 * _GELU_K * z32 * z32)
    return 0.5 * (1.0 + t) + 0.5 * z32 * (1.0 - t * t) * dinner


def _ln_bwd(dy_hat, xhat, rstd):
    """d/dx of LN given the upstream gradient through the scale (dy·γ)."""
    m1 = dy_hat.mean(dim=-1, keepdim=True)
    m2 = (dy_hat * xhat).mean(dim=-1, keepdim=True)
    return rstd * (dy_hat - m1 - xhat * m2)


def _drop(t, keep, rate):
    """Dropout with a given keep mask: kept values scaled by 1/(1-rate)."""
    if keep is None:
        return t
    return torch.where(keep.bool(), t * (1.0 / (1.0 - rate)),
                       torch.zeros((), dtype=t.dtype, device=t.device))


def _mm(a, w, dtype):
    """``a @ w`` with both operands rounded to ``dtype`` and an f32 result
    (``preferred_element_type=f32``)."""
    return a.to(dtype).float() @ w.to(dtype).float()


def _mask_bias(s_len, kv_len, device):
    col = torch.arange(s_len, device=device)
    return torch.where(col < kv_len, 0.0, NEG_INF).to(torch.float32)


def _mha_fwd(qkv, heads, d, scale, kv_len, dtype):
    """qkv (B, S, 3HD) f32 → (att (B, S, HD) f32, lse (B, S, H) f32)."""
    bias = _mask_bias(qkv.shape[1], kv_len, qkv.device)
    outs, lses = [], []
    for i in range(heads):
        q = qkv[..., i * d:(i + 1) * d]
        k = qkv[..., (heads + i) * d:(heads + i + 1) * d]
        v = qkv[..., (2 * heads + i) * d:(2 * heads + i + 1) * d]
        s = _mm(q, k.transpose(1, 2), dtype) * scale + bias
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        outs.append(_mm(p, v, dtype) / l)     # normalised after PV
        lses.append(m + torch.log(l))
    return torch.cat(outs, dim=-1), torch.cat(lses, dim=-1)


def _mha_fwd_bwd(qkv, lse, datt, heads, d, scale, kv_len, dtype):
    """Attention recompute and backward in one pass, as the JAX kernel's
    ``_mha_fwd_bwd``: p = exp(s - lse) from the stored lse (no max pass),
    every product's operands rounded to ``dtype``.  Returns (att, dqkv),
    dqkv columns ordered like qkv's."""
    bias = _mask_bias(qkv.shape[1], kv_len, qkv.device)
    outs, dqs, dks, dvs = [], [], [], []
    for i in range(heads):
        q = qkv[..., i * d:(i + 1) * d]
        k = qkv[..., (heads + i) * d:(heads + i + 1) * d]
        v = qkv[..., (2 * heads + i) * d:(2 * heads + i + 1) * d]
        do = datt[..., i * d:(i + 1) * d]
        s = _mm(q, k.transpose(1, 2), dtype) * scale + bias
        p = torch.exp(s - lse[..., i:i + 1])
        o = _mm(p, v, dtype)
        delta = (do * o).sum(dim=-1, keepdim=True)
        dvs.append(_mm(p.transpose(1, 2), do, dtype))
        dp = _mm(do, v.transpose(1, 2), dtype)
        ds = p * (dp - delta) * scale
        dqs.append(_mm(ds, k, dtype))
        dks.append(_mm(ds.transpose(1, 2), q, dtype))
        outs.append(o)
    return torch.cat(outs, dim=-1), torch.cat(dqs + dks + dvs, dim=-1)


def fused_vit_block_fwd_plain(x, params, heads, scale, kv_len, keep=None,
                              dropout_rate=0.0):
    """Plain PyTorch version of the forward kernel: (y, u, res) as above.
    ``keep``: the three keep masks (out-projection (B, S, D), FFN hidden
    (B, S, MLP), FFN output (B, S, D)) for ``dropout_rate`` > 0."""
    dtype = x.dtype
    d = x.shape[-1] // heads
    keep_o, keep_h, keep_y = keep if keep is not None else (None,) * 3
    p = {k: params[k].float() for k in PARAM_NAMES}
    x32 = x.float()
    a, _, mu1, rstd1 = _ln(x32, p["g1"][0], p["b1"][0])
    qkv = _mm(a, params["wqkv"], dtype)
    att, lse = _mha_fwd(qkv, heads, d, scale, kv_len, dtype)
    u = x32 + _drop(_mm(att, params["wo"], dtype) + p["bo"][0], keep_o,
                    dropout_rate)
    b, _, mu2, rstd2 = _ln(u, p["g2"][0], p["b2"][0])
    h = _drop(_gelu(_mm(b, params["w1"], dtype) + p["bb1"][0]), keep_h,
              dropout_rate)
    y = u + _drop(_mm(h, params["w2"], dtype) + p["bb2"][0], keep_y,
                  dropout_rate)
    res = torch.cat([lse, mu1, rstd1, mu2, rstd2], dim=-1)
    res = F.pad(res, (0, _round_up(heads + 4, 8) - heads - 4))
    return y.to(dtype), u.to(dtype), res


def fused_vit_block_bwd_plain(x, params, u, res, dy, heads, scale, kv_len,
                              keep=None, dropout_rate=0.0):
    """Plain PyTorch version of the backward kernel, step by step with the
    JAX ``_bwd_kernel``'s roundings (not autograd of the forward): LN
    statistics and lse come from ``res``, ``u`` is the stored, rounded u,
    every product's operands are rounded to x's dtype with f32
    accumulation, and the bias and LN-parameter gradients are sums of the
    unrounded f32 values.  Returns (dx in x's dtype, {name: gradient in
    the dtype of ``params[name]``, rows shaped (1, N)})."""
    dtype = x.dtype
    dim = x.shape[-1]
    d = dim // heads
    keep_o, keep_h, keep_y = keep if keep is not None else (None,) * 3
    rate = dropout_rate
    p = {k: params[k].float() for k in PARAM_NAMES}
    x32, u32, dy32 = x.float(), u.float(), dy.float()
    lse = res[..., :heads]
    mu1, rstd1 = res[..., heads:heads + 1], res[..., heads + 1:heads + 2]
    mu2, rstd2 = res[..., heads + 2:heads + 3], res[..., heads + 3:heads + 4]
    g1, g2 = p["g1"][0], p["g2"][0]

    def flat(t):
        return t.reshape(-1, t.shape[-1])

    def rows(t):                       # sum over (B, S), keep (1, N)
        return flat(t).sum(dim=0, keepdim=True)

    # recompute the forward pieces
    xhat1 = (x32 - mu1) * rstd1
    a = xhat1 * g1 + p["b1"][0]
    qkv = _mm(a, params["wqkv"], dtype)
    xhat2 = (u32 - mu2) * rstd2
    b = xhat2 * g2 + p["b2"][0]
    z1 = _mm(b, params["w1"], dtype) + p["bb1"][0]
    h = _drop(_gelu(z1), keep_h, rate)

    grads = {}
    # FFN backward
    dz2 = _drop(dy32, keep_y, rate)
    dh = _mm(dz2, params["w2"].t(), dtype)
    grads["w2"] = _mm(flat(h).t(), flat(dz2), dtype)
    grads["bb2"] = rows(dz2)
    dz1 = _drop(dh, keep_h, rate) * _dgelu(z1)
    grads["w1"] = _mm(flat(b).t(), flat(dz1), dtype)
    grads["bb1"] = rows(dz1)
    db = _mm(dz1, params["w1"].t(), dtype)
    # LN2 backward
    grads["g2"] = rows(db * xhat2)
    grads["b2"] = rows(db)
    du = dy32 + _ln_bwd(db * g2, xhat2, rstd2)
    # attention out-projection and core backward
    doproj = _drop(du, keep_o, rate)
    datt = _mm(doproj, params["wo"].t(), dtype)
    att, dqkv = _mha_fwd_bwd(qkv, lse, datt, heads, d, scale, kv_len, dtype)
    grads["wo"] = _mm(flat(att).t(), flat(doproj), dtype)
    grads["bo"] = rows(doproj)
    # qkv projection and LN1 backward
    da = _mm(dqkv, params["wqkv"].t(), dtype)
    grads["wqkv"] = _mm(flat(a).t(), flat(dqkv), dtype)
    grads["g1"] = rows(da * xhat1)
    grads["b1"] = rows(da)
    dx = du + _ln_bwd(da * g1, xhat1, rstd1)
    return dx.to(dtype), {k: grads[k].to(params[k].dtype)
                          for k in PARAM_NAMES}


def reference_vit_block(x, params, heads, scale, kv_len):
    """Unfused all-f32 reference of the same block (no dtype rounding)."""
    p = {k: params[k].float() for k in PARAM_NAMES}
    x32 = x.float()
    a, _, _, _ = _ln(x32, p["g1"], p["b1"])
    att, _ = _mha_fwd(a @ p["wqkv"], heads, x.shape[-1] // heads, scale,
                      kv_len, torch.float32)
    u = x32 + att @ p["wo"] + p["bo"]
    b, _, _, _ = _ln(u, p["g2"], p["b2"])
    y = u + _gelu(b @ p["w1"] + p["bb1"]) @ p["w2"] + p["bb2"]
    return y.to(x.dtype)


def dropout_masks(seed: int, rate: float, bsz: int, s: int, dim: int,
                  mlp: int, device) -> tuple[torch.Tensor, ...]:
    """The three keep masks (bool: out-projection (B, S, D), FFN hidden
    (B, S, MLP), FFN output (B, S, D)) that ``fused_vit_block`` applies on
    ``device`` for this seed and rate: on the card the Philox masks of the
    kernels, written by the library's own mask kernel; on the CPU masks
    drawn from a ``torch.Generator`` seeded with ``seed``."""
    device = torch.device(device)
    shapes = ((bsz, s, dim), (bsz, s, mlp), (bsz, s, dim))
    if device.type == "cpu":
        gen = torch.Generator().manual_seed(seed)
        cutoff = dropout_cutoff(rate)
        return tuple(torch.randint(0, 1 << 32, shape, generator=gen) >= cutoff
                     for shape in shapes)
    from devt_tpu_torch.ops import _build

    lib = _build.load("fused_block_fwd", _declare_fwd)
    keep_o, keep_h, keep_y = (torch.empty(shape, dtype=torch.uint8,
                                          device=device) for shape in shapes)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.devt_dropout_masks(
            _ptr(keep_o), _ptr(keep_h), _ptr(keep_y), bsz * s, dim, mlp,
            ctypes.c_double(rate), ctypes.c_ulonglong(seed),
            ctypes.c_void_p(stream))
    _check(lib, rc, "dropout_masks")
    return keep_o.bool(), keep_h.bool(), keep_y.bool()


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _check(lib, rc, what):
    if rc != 0:
        msg = lib.devt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


def _check_cuda_args(x, params, heads, names=PARAM_NAMES):
    """Checks x and the parameters ``names`` of the fused kernels (the
    whole block's, or the attention half's)."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the fused kernels take float32 or bfloat16 x, "
                        f"got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, S, D) tensor, got "
                         f"shape {tuple(x.shape)}")
    dim = x.shape[-1]
    mlp = params["w1"].shape[-1] if "w1" in names else 64
    shapes = {"g1": (1, dim), "b1": (1, dim), "wqkv": (dim, 3 * dim),
              "wo": (dim, dim), "bo": (1, dim), "g2": (1, dim),
              "b2": (1, dim), "w1": (dim, mlp), "bb1": (1, mlp),
              "w2": (mlp, dim), "bb2": (1, dim)}
    for name in names:
        shape, t = shapes[name], params[name]
        want = x.dtype if name in _MATRICES else torch.float32
        if tuple(t.shape) != shape or t.dtype != want \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"param {name}: need a contiguous {want} tensor of shape "
                f"{shape} on {x.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    d = dim // heads
    if heads * d != dim or dim % 16 or d % 16 or mlp % 16:
        raise ValueError(f"the kernel needs dim = heads*d with dim, d and "
                         f"mlp multiples of 16; got dim={dim} heads={heads} "
                         f"mlp={mlp}")
    if not kernels_take_width(x.dtype, dim, d, mlp):
        raise ValueError(f"the bfloat16 kernel is compiled for (dim, head "
                         f"dim) in {_BF16_WIDTHS} with mlp a multiple of 64; "
                         f"got dim={dim} d={d} mlp={mlp}")


def _fwd_cuda(x, params, heads, scale, kv_len, rate, seed):
    _check_cuda_args(x, params, heads)
    from devt_tpu_torch.ops import _build

    lib = _build.load("fused_block_fwd", _declare_fwd)
    bsz, s, dim = x.shape
    lanes = _round_up(heads + 4, 8)
    y = torch.empty_like(x)
    u = torch.empty_like(x)
    res = torch.empty((bsz, s, lanes), dtype=torch.float32, device=x.device)
    qkv = torch.empty((bsz, s, 3 * dim), dtype=x.dtype, device=x.device)
    att = torch.empty_like(x)
    # u before its rounding to bf16, for the last residual add
    u32 = torch.empty(x.shape, dtype=torch.float32, device=x.device) \
        if x.dtype == torch.bfloat16 else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.devt_fused_block_fwd(
            _DTYPE_CODE[x.dtype], _ptr(x),
            *(_ptr(params[k]) for k in PARAM_NAMES),
            _ptr(y), _ptr(u), _ptr(res), _ptr(qkv), _ptr(att),
            _ptr(u32) if u32 is not None else None,
            bsz, s, dim, heads, params["w1"].shape[-1], int(kv_len), lanes,
            ctypes.c_float(scale), ctypes.c_double(rate),
            ctypes.c_ulonglong(seed), ctypes.c_void_p(stream))
    _check(lib, rc, "fused_block_fwd")
    fused_vit_block.launches += 1
    if attn_half_on_wgmma(x.dtype, dim // heads, kv_len):
        fused_vit_block.wgmma_launches += 1
    else:
        fused_vit_block.streamed_launches += 1
    return y, u, res


def _bwd_smem_bf16(s: int, head_dim: int) -> int:
    """Shared memory of the bfloat16 attention backward of kernels 2 and 8:
    q, k, v and datt of one head (rows padded by 8) plus lse and delta."""
    return 4 * s * (head_dim + 8) * 2 + 2 * s * 4 + 512


def kernels_take_width(dtype: torch.dtype, dim: int, head_dim: int,
                       mlp: int = 64) -> bool:
    """The widths the fused kernels (1, 2; 7, 8 with the default ``mlp``)
    are compiled for: dim, head dim and MLP multiples of 16, and in
    bfloat16 (dim, head dim) in ``_BF16_WIDTHS`` with an MLP a multiple
    of 64."""
    if dtype not in _DTYPE_CODE or dim % 16 or head_dim % 16 or mlp % 16:
        return False
    if dtype == torch.bfloat16:
        return (dim, head_dim) in _BF16_WIDTHS and mlp % 64 == 0
    return True


def bwd_takes_shape(dtype: torch.dtype, head_dim: int, s: int) -> bool:
    """The shapes the backward kernels (2 and 8) take: S a multiple of 16
    and, in bfloat16, one head's attention operands in a block's shared
    memory (up to 397 tokens at head dim 64)."""
    if s % 16:
        return False
    return dtype != torch.bfloat16 \
        or _bwd_smem_bf16(s, head_dim) <= _SMEM_PER_BLOCK


def fused_block_eligible(device_type: str, dtype: torch.dtype, dim: int,
                         head_dim: int, s: int, grad: bool,
                         mlp: int = 64) -> bool:
    """Whether the fused kernels take a block of S tokens: on CPU tensors
    always (the plain versions take every width); on the card the width
    table (``kernels_take_width``) and, when the forward will need a
    gradient, the backward's shape rule (``bwd_takes_shape``).  The
    models' eligibility checks read it, so a block the kernels do not take
    runs unfused, as the JAX package's runs wherever its fused path is not
    eligible."""
    if device_type != "cuda":
        return True
    return kernels_take_width(dtype, dim, head_dim, mlp) \
        and (not grad or bwd_takes_shape(dtype, head_dim, s))


def _check_bwd_shape(x, heads):
    """Raise on a shape the backward kernels (2 and 8) do not take."""
    s, dim = x.shape[1], x.shape[2]
    if s % 16:
        raise ValueError(f"the backward kernel needs a token count that is a "
                         f"multiple of 16, got {s}")
    if not bwd_takes_shape(x.dtype, dim // heads, s):
        raise ValueError(
            f"the bfloat16 backward keeps one head's q, k, v and datt in "
            f"shared memory: {s} tokens of head dim {dim // heads} need "
            f"{_bwd_smem_bf16(s, dim // heads)} bytes, a block has "
            f"{_SMEM_PER_BLOCK}")


def _refuse_untrainable(x, tensors, heads) -> None:
    """On the card, a call that will need a gradient (grad mode on and an
    input that requires one) and whose shape the backward kernel does not
    take is refused before the forward runs.  Asked here, outside the
    autograd Function, whose forward sees neither grad mode nor, under
    ``no_grad``, which inputs will really be differentiated."""
    if x.device.type == "cuda" and torch.is_grad_enabled() \
            and any(t.requires_grad for t in (x, *tensors)):
        _check_bwd_shape(x, heads)


def _bwd_cuda(x, params, u, res, dy, heads, scale, kv_len, rate, seed):
    _check_cuda_args(x, params, heads)
    bsz, s, dim = x.shape
    mlp = params["w1"].shape[-1]
    for name, t, shape in (("u", u, x.shape), ("dy", dy, x.shape)):
        if t.dtype != x.dtype or t.shape != shape or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {x.dtype} tensor of "
                             f"shape {tuple(shape)} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if res.dtype != torch.float32 or res.shape[:2] != x.shape[:2] \
            or res.shape[2] < heads + 4 or res.device != x.device \
            or not res.is_contiguous():
        raise ValueError(f"res: need the contiguous f32 (B, S, >= heads+4) "
                         f"residual lanes of the forward on {x.device}, got "
                         f"{res.dtype} {tuple(res.shape)} on {res.device}")
    _check_bwd_shape(x, heads)
    from devt_tpu_torch.ops import _build

    lib = _build.load("fused_block_bwd", _declare_bwd)
    code = _DTYPE_CODE[x.dtype]
    nbytes = lib.devt_fused_block_bwd_scratch(code, bsz, s, dim, heads, mlp)
    if nbytes == 0:
        raise RuntimeError(f"fused_block_bwd takes no shape "
                           f"{(bsz, s, dim, heads, mlp)}")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    grads = {k: torch.empty_like(params[k]) for k in PARAM_NAMES}
    grad_ptrs = (ctypes.c_void_p * len(PARAM_NAMES))(
        *(grads[k].data_ptr() for k in PARAM_NAMES))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.devt_fused_block_bwd(
            code, _ptr(x), *(_ptr(params[k]) for k in PARAM_NAMES),
            _ptr(u), _ptr(res), _ptr(dy), _ptr(dx), grad_ptrs, _ptr(scratch),
            bsz, s, dim, heads, mlp, int(kv_len), res.shape[2],
            ctypes.c_float(scale), ctypes.c_double(rate),
            ctypes.c_ulonglong(seed), ctypes.c_void_p(stream))
    _check(lib, rc, "fused_block_bwd")
    fused_vit_block.bwd_launches += 1
    if block_bwd_on_wgmma(x.dtype, dim // heads, kv_len):
        fused_vit_block.bwd_wgmma_launches += 1
    else:
        fused_vit_block.bwd_streamed_launches += 1
    return dx, grads


def _block_impl(x, tensors, heads, scale, kv_len, rate, seed):
    params = dict(zip(PARAM_NAMES, tensors))
    if x.device.type == "cuda":
        return _fwd_cuda(x, params, heads, scale, kv_len, rate, seed)
    keep = dropout_masks(seed, rate, *x.shape, params["w1"].shape[-1],
                         x.device) if rate > 0.0 else None
    return fused_vit_block_fwd_plain(x, params, heads, scale, kv_len, keep,
                                     rate)


def _block_fake(x, tensors, heads, scale, kv_len, rate, seed):
    lanes = _round_up(heads + 4, 8)
    return (x.new_empty(x.shape), x.new_empty(x.shape),
            x.new_empty((*x.shape[:2], lanes), dtype=torch.float32))


# kernel 1: (y, u, res), the parameters in PARAM_NAMES order
fused_block_fwd_op = kernel_op(
    "fused_block_fwd", "(Tensor x, Tensor[] params, int heads, float scale, "
    "int kv_len, float rate, int seed) -> (Tensor, Tensor, Tensor)",
    _block_impl, _block_fake)


class FusedViTBlock(torch.autograd.Function):
    """The fused block with its backward: the kernels for CUDA tensors, the
    plain versions for CPU tensors; the forward through the
    ``devt_tpu_torch::fused_block_fwd`` op (``ops/_library.py``).  Saves
    (x, params, u, res) and the seed; the backward regenerates the dropout
    masks from the seed."""

    @staticmethod
    def forward(ctx, x, heads, scale, kv_len, rate, seed, *tensors):
        y, u, res = fused_block_fwd_op(x, tensors, heads, scale, kv_len,
                                       rate, seed)
        ctx.save_for_backward(x, u, res, *tensors)
        ctx.args = (heads, scale, kv_len, rate, seed)
        ctx.mark_non_differentiable(u, res)
        return y, u, res

    @staticmethod
    def backward(ctx, dy, _du, _dres):
        x, u, res, *tensors = ctx.saved_tensors
        heads, scale, kv_len, rate, seed = ctx.args
        params = dict(zip(PARAM_NAMES, tensors))
        # the gradient crosses the kernel boundary in x's dtype
        dy = dy.to(x.dtype).contiguous()
        if x.device.type == "cuda":
            dx, grads = _bwd_cuda(x, params, u, res, dy, heads, scale,
                                  kv_len, rate, seed)
        else:
            keep = None
            if rate > 0.0:
                keep = dropout_masks(seed, rate, *x.shape,
                                     params["w1"].shape[-1], x.device)
            dx, grads = fused_vit_block_bwd_plain(
                x, params, u, res, dy, heads, scale, kv_len, keep, rate)
        return (dx, None, None, None, None, None,
                *(grads[k] for k in PARAM_NAMES))


def fused_vit_block(x, params, heads, scale, kv_len, dropout_rate=0.0,
                    seed=None):
    """One fused pre-norm ViT block → (y, u, res), differentiable in x and
    the 11 parameters.

    x (B, S, D); ``params`` holds g1/b1/wqkv/wo/bo/g2/b2/w1/bb1/w2/bb2 in
    the JAX kernel's layout: weight matrices (K, N) in x's dtype, LN
    parameters and biases (1, N) f32.  ``kv_len`` masks key padding.
    ``dropout_rate`` > 0 applies the three dropout sites inside the block
    and needs ``seed`` (an int the caller draws once per call; the JAX
    wrapper draws ``randint(0, 2**30)``); the backward uses the same seed.

    A CUDA tensor launches the kernels (raising if a launch fails); a CPU
    tensor runs the plain versions.  The JAX function returns only y
    because its custom_vjp keeps u and res to itself; here they are
    returned too (not differentiable)."""
    rate = float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 needs a seed")
    tensors = [params[k] for k in PARAM_NAMES]
    _refuse_untrainable(x, tensors, heads)
    return FusedViTBlock.apply(x, heads, float(scale), int(kv_len), rate,
                               int(seed) if rate > 0.0 else 0, *tensors)


fused_vit_block.launches = 0
fused_vit_block.wgmma_launches = 0
fused_vit_block.streamed_launches = 0
fused_vit_block.bwd_launches = 0
fused_vit_block.bwd_wgmma_launches = 0
fused_vit_block.bwd_streamed_launches = 0


# ---------------------------------------------------------------------------
# The attention half: kernels 7 and 8
# ---------------------------------------------------------------------------

HALF_NAMES = ("g1", "b1", "wqkv", "wo", "bo")


def attn_half_on_wgmma(dtype: torch.dtype, head_dim: int,
                       kv_len: int) -> bool:
    """Whether the attention launch of kernel 7 (and of kernel 1, the
    whole block's forward) runs the one-shot wgmma body
    (``csrc/flash_fwd_sm90.cuh``, normalising after P·V): kernel 9's rule,
    ``one_shot_on_wgmma``, with kv_len as the key count, as the C entries
    ``devt_attn_half_route`` and ``devt_fused_block_route`` say.  The
    others (f32, more than 256 live keys, other head dims) run
    ``csrc/attention_fwd.cuh``'s body."""
    return one_shot_on_wgmma(dtype, head_dim, kv_len)


def block_bwd_on_wgmma(dtype: torch.dtype, head_dim: int,
                       kv_len: int) -> bool:
    """Whether the attention backward of kernels 2 and 8 runs its wgmma
    route (``csrc/block_bwd_parts.cuh:block_attention_bwd_bf16``): the
    recompute of att, do and delta from the stored lse on the one-shot
    forward's wgmma body, then kernels 12's and 13's wgmma bodies
    (``csrc/flash_bwd_sm90.cuh``).  The C rule ``block_bwd_on_wgmma``, as
    ``devt_fused_block_bwd_route`` and ``devt_attn_half_bwd_route`` say:
    the forward's one-shot rule (bfloat16, head dim 16, 32 or 64, at most
    256 live keys) within the bodies' (``blocked_bwd_on_wgmma``).  Other
    bfloat16 shapes keep ``attention_bwd_bf16`` (mma.sync), f32
    ``attention_bwd_f32``."""
    return one_shot_on_wgmma(dtype, head_dim, kv_len) \
        and blocked_bwd_on_wgmma(dtype, head_dim)


def block_attention_bwd_plain(qkv, lse, datt, heads, d, scale, kv_len,
                              dtype):
    """Plain version of the wgmma route of the attention backward of
    kernels 2 and 8, launch by launch, with ``_mha_fwd_bwd``'s contract
    (qkv, lse (B, S, H), datt (B, S, H*d) f32 → (att f32, dqkv f32)):

    1. the recompute (``block_bwd_pre_sm90``) from the given lse, no max
       pass: p = exp(s·scale − lse) with keys past kv_len at 0, o =
       round(p) @ v in f32, att = o, do = round(datt), and delta =
       rowsum(datt · o) from the f32 datt and the f32 o;
    2. kernel 12's body with delta given: ds = p · (do @ vᵀ − delta) ·
       scale, dq = round(ds) @ k;
    3. kernel 13's: dv = round(p)ᵀ @ do, dk = round(ds)ᵀ @ q."""
    s_len = qkv.shape[1]
    live = torch.arange(s_len, device=qkv.device) < kv_len
    outs, dqs, dks, dvs = [], [], [], []
    for i in range(heads):
        q = qkv[..., i * d:(i + 1) * d]
        k = qkv[..., (heads + i) * d:(heads + i + 1) * d]
        v = qkv[..., (2 * heads + i) * d:(2 * heads + i + 1) * d]
        g = datt[..., i * d:(i + 1) * d]
        # 1. the recompute
        s = _mm(q, k.transpose(1, 2), dtype) * scale
        p = torch.where(live, torch.exp(s - lse[..., i:i + 1]),
                        torch.zeros((), device=qkv.device))
        o = _mm(p, v, dtype)
        delta = (g * o).sum(dim=-1, keepdim=True)
        do = g.to(dtype)
        outs.append(o)
        # 2. dq with delta given
        ds = p * (_mm(do, v.transpose(1, 2), dtype) - delta) * scale
        dqs.append(_mm(ds, k, dtype))
        # 3. dk and dv
        dvs.append(_mm(p.transpose(1, 2), do, dtype))
        dks.append(_mm(ds.transpose(1, 2), q, dtype))
    return torch.cat(outs, dim=-1), torch.cat(dqs + dks + dvs, dim=-1)


def fused_attn_half_fwd_plain(x, params, heads, scale, kv_len):
    """Plain PyTorch version of kernel 7: (u, res), u = x + MHA(LN1(x) @
    Wqkv) @ Wo + bo in x's dtype, res = [lse (H), mu1, rstd1, 0…] f32 in
    ``round_up(H + 2, 8)`` lanes (JAX's ``_attn_half_fwd_kernel``)."""
    dtype = x.dtype
    d = x.shape[-1] // heads
    p = {k: params[k].float() for k in HALF_NAMES}
    x32 = x.float()
    a, _, mu1, rstd1 = _ln(x32, p["g1"][0], p["b1"][0])
    qkv = _mm(a, params["wqkv"], dtype)
    att, lse = _mha_fwd(qkv, heads, d, scale, kv_len, dtype)
    u = x32 + (_mm(att, params["wo"], dtype) + p["bo"][0])
    res = torch.cat([lse, mu1, rstd1], dim=-1)
    res = F.pad(res, (0, _round_up(heads + 2, 8) - heads - 2))
    return u.to(dtype), res


def fused_attn_half_bwd_plain(x, params, res, du, heads, scale, kv_len):
    """Plain PyTorch version of kernel 8, step by step with the roundings
    of JAX's ``_attn_half_bwd_kernel``: LN1 statistics and lse from
    ``res``, every product's operands rounded to x's dtype with f32
    accumulation, the bias and LN-parameter gradients sums of unrounded f32
    values.  Returns (dx in x's dtype, {name: gradient in the dtype of
    ``params[name]``, rows shaped (1, N)})."""
    dtype = x.dtype
    d = x.shape[-1] // heads
    p = {k: params[k].float() for k in HALF_NAMES}
    x32, du32 = x.float(), du.float()
    lse = res[..., :heads]
    mu1, rstd1 = res[..., heads:heads + 1], res[..., heads + 1:heads + 2]
    g1 = p["g1"][0]

    def flat(t):
        return t.reshape(-1, t.shape[-1])

    def rows(t):                       # sum over (B, S), keep (1, N)
        return flat(t).sum(dim=0, keepdim=True)

    xhat1 = (x32 - mu1) * rstd1
    a = xhat1 * g1 + p["b1"][0]
    qkv = _mm(a, params["wqkv"], dtype)
    datt = _mm(du32, params["wo"].t(), dtype)
    att, dqkv = _mha_fwd_bwd(qkv, lse, datt, heads, d, scale, kv_len, dtype)
    grads = {"wo": _mm(flat(att).t(), flat(du32), dtype), "bo": rows(du32)}
    da = _mm(dqkv, params["wqkv"].t(), dtype)
    grads["wqkv"] = _mm(flat(a).t(), flat(dqkv), dtype)
    grads["g1"] = rows(da * xhat1)
    grads["b1"] = rows(da)
    dx = du32 + _ln_bwd(da * g1, xhat1, rstd1)
    return dx.to(dtype), {k: grads[k].to(params[k].dtype)
                          for k in HALF_NAMES}


def _half_fwd_cuda(x, params, heads, scale, kv_len):
    _check_cuda_args(x, params, heads, HALF_NAMES)
    from devt_tpu_torch.ops import _build

    lib = _build.load("attn_half", _declare_half)
    bsz, s, dim = x.shape
    lanes = _round_up(heads + 2, 8)
    u = torch.empty_like(x)
    res = torch.empty((bsz, s, lanes), dtype=torch.float32, device=x.device)
    qkv = torch.empty((bsz, s, 3 * dim), dtype=x.dtype, device=x.device)
    att = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.devt_attn_half_fwd(
            _DTYPE_CODE[x.dtype], _ptr(x),
            *(_ptr(params[k]) for k in HALF_NAMES), _ptr(u), _ptr(res),
            _ptr(qkv), _ptr(att), bsz, s, dim, heads, int(kv_len), lanes,
            ctypes.c_float(scale), ctypes.c_void_p(stream))
    _check(lib, rc, "attn_half_fwd")
    fused_attn_half.launches += 1
    if attn_half_on_wgmma(x.dtype, dim // heads, kv_len):
        fused_attn_half.wgmma_launches += 1
    else:
        fused_attn_half.streamed_launches += 1
    return u, res


def _half_bwd_cuda(x, params, res, du, heads, scale, kv_len):
    _check_cuda_args(x, params, heads, HALF_NAMES)
    bsz, s, dim = x.shape
    if du.dtype != x.dtype or du.shape != x.shape or du.device != x.device \
            or not du.is_contiguous():
        raise ValueError(f"du: need a contiguous {x.dtype} tensor of shape "
                         f"{tuple(x.shape)} on {x.device}, got {du.dtype} "
                         f"{tuple(du.shape)} on {du.device}")
    if res.dtype != torch.float32 or res.shape[:2] != x.shape[:2] \
            or res.shape[2] < heads + 2 or res.device != x.device \
            or not res.is_contiguous():
        raise ValueError(f"res: need the contiguous f32 (B, S, >= heads+2) "
                         f"residual lanes of the forward on {x.device}, got "
                         f"{res.dtype} {tuple(res.shape)} on {res.device}")
    _check_bwd_shape(x, heads)
    from devt_tpu_torch.ops import _build

    lib = _build.load("attn_half", _declare_half)
    code = _DTYPE_CODE[x.dtype]
    nbytes = lib.devt_attn_half_bwd_scratch(code, bsz, s, dim, heads)
    if nbytes == 0:
        raise RuntimeError(f"attn_half_bwd takes no shape "
                           f"{(bsz, s, dim, heads)}")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    grads = {k: torch.empty_like(params[k]) for k in HALF_NAMES}
    grad_ptrs = (ctypes.c_void_p * len(HALF_NAMES))(
        *(grads[k].data_ptr() for k in HALF_NAMES))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.devt_attn_half_bwd(
            code, _ptr(x), *(_ptr(params[k]) for k in HALF_NAMES),
            _ptr(res), _ptr(du), _ptr(dx), grad_ptrs, _ptr(scratch), bsz, s,
            dim, heads, int(kv_len), res.shape[2], ctypes.c_float(scale),
            ctypes.c_void_p(stream))
    _check(lib, rc, "attn_half_bwd")
    fused_attn_half.bwd_launches += 1
    if block_bwd_on_wgmma(x.dtype, dim // heads, kv_len):
        fused_attn_half.bwd_wgmma_launches += 1
    else:
        fused_attn_half.bwd_streamed_launches += 1
    return dx, grads


def _half_impl(x, tensors, heads, scale, kv_len):
    params = dict(zip(HALF_NAMES, tensors))
    if x.device.type == "cuda":
        return _half_fwd_cuda(x, params, heads, scale, kv_len)
    return fused_attn_half_fwd_plain(x, params, heads, scale, kv_len)


def _half_fake(x, tensors, heads, scale, kv_len):
    lanes = _round_up(heads + 2, 8)
    return (x.new_empty(x.shape),
            x.new_empty((*x.shape[:2], lanes), dtype=torch.float32))


# kernel 7: (u, res), the parameters in HALF_NAMES order
attn_half_fwd_op = kernel_op(
    "attn_half_fwd", "(Tensor x, Tensor[] params, int heads, float scale, "
    "int kv_len) -> (Tensor, Tensor)", _half_impl, _half_fake)


class FusedAttnHalf(torch.autograd.Function):
    """The attention half with its backward: kernels 7 and 8 for CUDA
    tensors, the plain versions for CPU tensors; the forward through the
    ``devt_tpu_torch::attn_half_fwd`` op.  Saves (x, params, res)."""

    @staticmethod
    def forward(ctx, x, heads, scale, kv_len, *tensors):
        u, res = attn_half_fwd_op(x, tensors, heads, scale, kv_len)
        ctx.save_for_backward(x, res, *tensors)
        ctx.args = (heads, scale, kv_len)
        ctx.mark_non_differentiable(res)
        return u, res

    @staticmethod
    def backward(ctx, du, _dres):
        x, res, *tensors = ctx.saved_tensors
        heads, scale, kv_len = ctx.args
        params = dict(zip(HALF_NAMES, tensors))
        # the gradient crosses the kernel boundary in x's dtype
        du = du.to(x.dtype).contiguous()
        if x.device.type == "cuda":
            dx, grads = _half_bwd_cuda(x, params, res, du, heads, scale,
                                       kv_len)
        else:
            dx, grads = fused_attn_half_bwd_plain(x, params, res, du, heads,
                                                  scale, kv_len)
        return (dx, None, None, None, *(grads[k] for k in HALF_NAMES))


def fused_attn_half(x, params, heads, scale, kv_len):
    """``x + attn(LN1(x))``: the attention half of a pre-norm ViT block →
    (u, res), differentiable in x and the 5 parameters.

    x (B, S, D); ``params`` holds g1/b1/wqkv/wo/bo in the layout of the
    whole block's kernel: Wqkv (D, 3D) and Wo (D, D) in x's dtype, the LN
    parameters and bo (1, D) f32.  ``kv_len`` masks key padding.  No
    dropout (callers gate: ``models/layers.py:MoEViTBlock``).

    A CUDA tensor launches kernel 7 forward and kernel 8 backward (raising
    if a launch fails); a CPU tensor runs the plain versions.  The JAX
    function returns only u because its custom_vjp keeps res to itself;
    here res is returned too (not differentiable)."""
    tensors = [params[k] for k in HALF_NAMES]
    _refuse_untrainable(x, tensors, heads)
    return FusedAttnHalf.apply(x, heads, float(scale), int(kv_len), *tensors)


fused_attn_half.launches = 0
fused_attn_half.wgmma_launches = 0
fused_attn_half.streamed_launches = 0
fused_attn_half.bwd_launches = 0
fused_attn_half.bwd_wgmma_launches = 0
fused_attn_half.bwd_streamed_launches = 0


def _declare_fwd(lib: ctypes.CDLL) -> None:
    lib.devt_fused_block_fwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 18 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_double, ctypes.c_ulonglong,
           ctypes.c_void_p])
    lib.devt_fused_block_fwd.restype = ctypes.c_int
    lib.devt_dropout_masks.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_double, ctypes.c_ulonglong, ctypes.c_void_p])
    lib.devt_dropout_masks.restype = ctypes.c_int
    lib.devt_fused_block_route.argtypes = [ctypes.c_int] * 3
    lib.devt_fused_block_route.restype = ctypes.c_int
    lib.devt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.devt_cuda_error_string.restype = ctypes.c_char_p


def _declare_bwd(lib: ctypes.CDLL) -> None:
    lib.devt_fused_block_bwd_scratch.argtypes = [ctypes.c_int] * 6
    lib.devt_fused_block_bwd_scratch.restype = ctypes.c_ulonglong
    lib.devt_fused_block_bwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 16
        + [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
        + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_double, ctypes.c_ulonglong,
           ctypes.c_void_p])
    lib.devt_fused_block_bwd.restype = ctypes.c_int
    lib.devt_fused_block_bwd_route.argtypes = [ctypes.c_int] * 3
    lib.devt_fused_block_bwd_route.restype = ctypes.c_int
    lib.devt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.devt_cuda_error_string.restype = ctypes.c_char_p


def _declare_half(lib: ctypes.CDLL) -> None:
    lib.devt_attn_half_fwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p])
    lib.devt_attn_half_fwd.restype = ctypes.c_int
    lib.devt_attn_half_route.argtypes = [ctypes.c_int] * 3
    lib.devt_attn_half_route.restype = ctypes.c_int
    lib.devt_attn_half_bwd_scratch.argtypes = [ctypes.c_int] * 5
    lib.devt_attn_half_bwd_scratch.restype = ctypes.c_ulonglong
    lib.devt_attn_half_bwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 9
        + [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
        + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    lib.devt_attn_half_bwd.restype = ctypes.c_int
    lib.devt_attn_half_bwd_route.argtypes = [ctypes.c_int] * 3
    lib.devt_attn_half_bwd_route.restype = ctypes.c_int
    lib.devt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.devt_cuda_error_string.restype = ctypes.c_char_p
