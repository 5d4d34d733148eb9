"""Int8 weight+activation quantization for the serving path.

Port of ``devt_tpu/ops/quant.py``.  The scheme:

  * weights: symmetric per-output-channel int8.  Each column of a
    ``(K, N)`` matrix gets its own f32 scale ``max|w|/127``.  Quantized
    once: ``serve.Predictor(quantize=True)`` collects every site's int8
    weights at construction (the site registry below) and hands them back
    to every forward; a Linear site's codes are stored (N, K), k
    contiguous, and handed out as their (K, N) view.
  * activations: symmetric per-row int8, scales computed from the live
    batch (``max|x|/127`` over the feature axis).
  * the contraction runs int8×int8 with an exact int32 sum, then
    dequantizes as ``acc · x_scale · w_scale``.

What is quantized:

  * ViT blocks on the fused path: Wqkv and W1 int8, Wo and W2 in the model
    dtype (``quant_fused_vit_block``, one call per block).  A block pinned
    to ``attention_impl="xla"`` takes the unfused ``quant_vit_block`` with
    all four products int8.
  * the Linear sites of the torch-semantics encoder (PTN): through
    ``int8_dot_general``, which takes ``int8_matmul_fused`` for wide
    contractions on the card and the unfused ``int8_matmul`` formulation
    elsewhere.

LayerNorm statistics, softmax, residuals and the attention core stay in
the model dtype and f32.

Two kernels (CUDA C++ for sm_90a, built by ``_build``), each with its
plain PyTorch version beside it; a wrapper launches its kernel for CUDA
tensors (or raises) and runs the plain version only for CPU tensors, and
counts its launches in ``.launches``:

``quant_fused_vit_block`` → ``csrc/quant_block_fwd.cu``
  * Replaces ``devt_tpu/ops/quant.py:275 _quant_fwd_kernel`` (launched from
    ``quant_fused_vit_block``, ``:329``).
  * The fused ViT block forward in eval mode with LN1's and LN2's outputs
    quantized per row inside the kernel (``round(x · 127/amax)``, half to
    even, no clip) and the Wqkv and W1 products run as int8 ``wgmma``
    s8×s8→s32 on the K-major weight codes that ``quant_block_params``
    stores, dequantized on the accumulators; Wo, GELU and W2 on bf16
    ``wgmma``, both row-tile launches on ``csrc/block_sm90.cuh``'s CTA
    shape (TMA weight rings); the attention is the bf16 block's launch
    (``csrc/block_attention.cuh``: the one-shot wgmma body where
    ``fused_block.attn_half_on_wgmma`` says, counted in
    ``.wgmma_launches`` and ``.streamed_launches``).
  * Bound at (512, 208, 192, 3 heads, MLP 768, kv_len 197): 110.3 GOP, of
    which 55.0 GOP at the int8 rate, against about 82 MB: operations.

``int8_matmul_fused`` → ``csrc/int8_matmul.cu``
  * Replaces ``devt_tpu/ops/quant.py:348 _int8_matmul_kernel`` (launched
    from ``int8_matmul_fused``, ``:376``).
  * Two launches: a row pass that reads x once and leaves int8 codes and
    row scales (the TPU kernel quantizes a row tile in VMEM against all N
    columns; tiling N across blocks as well would repeat that per column
    tile), then a tiled int8 product with the dequantizing epilogue.  The
    int32 sums are exact, so kernel and plain version agree bit for bit.
  * The product's body follows the weight codes' layout
    (``int8_matmul_on_wgmma``): K-major codes, which the site registry
    stores, run ``csrc/gemm_s8_sm90.cuh`` (TMA and int8 ``wgmma``, which
    reads 8-bit operands only K-major); row-major (K, N) codes run the
    ``mma.sync`` body of ``csrc/int8_common.cuh``.
  * Bound at (3584, 2048)·(2048, 6144): 90.2 GOP against 71 MB: operations.

The kernels' times on the card are in PERF.md.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from devt_tpu_torch.ops import fused_block as fb
from devt_tpu_torch.ops._library import kernel_op
from devt_tpu_torch.ops.attention import (quant_site_allowed,
                                          scaled_dot_product_attention)
from devt_tpu_torch.ops.flash_attention import fits_single_block

_EPS = 1e-8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# f32 sums of products of int8 codes are exact while K · 127² < 2²⁴
_EXACT_F32_K = 1040

QUANT_PARAM_NAMES = ("g1", "b1", "wqkv_q", "wqkv_s", "wo", "bo", "g2", "b2",
                     "w1_q", "w1_s", "bb1", "w2", "bb2")

# ---------------------------------------------------------------------------
# weight-quantization site registry.
#
# A quantized Predictor quantizes every weight once, at construction: an
# eager "collect" pass over a one-sample batch records what each site made
# (a Linear site its (w_q, w_scale) pair, a ViT block its whole
# ``quant_block_params`` tree) in call order, and every later forward runs
# under "provide", where the sites take the stored values back in the same
# order and quantize nothing.  Outside both modes a site quantizes on the
# spot.  JAX has two deliveries (constants folded into the program, or
# int8 arguments); an eager program has no such distinction, this registry
# is the only one.
# ---------------------------------------------------------------------------

_site_reg = threading.local()


@contextlib.contextmanager
def quant_sites_collect(store: list):
    """Every weight-quantization site appends what it made to ``store``,
    in call order."""
    prev = getattr(_site_reg, "mode", None), getattr(_site_reg, "store", None)
    _site_reg.mode, _site_reg.store = "collect", store
    try:
        yield store
    finally:
        _site_reg.mode, _site_reg.store = prev


@contextlib.contextmanager
def quant_sites_provide(store):
    """Sites consume ``store`` in the call order the collect pass recorded
    and quantize nothing.  Call order is the only identity a site has, so
    a forward that meets another kind of site than was recorded, more
    sites, or (checked on leaving) fewer, raises ``RuntimeError``."""
    prev = (getattr(_site_reg, "mode", None), getattr(_site_reg, "store", None),
            getattr(_site_reg, "idx", 0))
    _site_reg.mode, _site_reg.store, _site_reg.idx = "provide", store, 0
    try:
        yield
        if _site_reg.idx != len(store):
            raise RuntimeError(
                f"the forward met {_site_reg.idx} quantization sites, the "
                f"collect pass recorded {len(store)}: the forward differs "
                f"from the one the weights were collected on")
    finally:
        _site_reg.mode, _site_reg.store, _site_reg.idx = prev


def site_value(make, kind: type):
    """``make()`` through the site registry: the stored value under
    ``quant_sites_provide``, else a fresh one (recorded under
    ``quant_sites_collect``).  ``kind`` is the type of what this site
    makes (``dict`` for a block's parameter tree, ``tuple`` for a Linear's
    ``(w_q, w_scale)``): a stored value of another type belongs to another
    site."""
    mode = getattr(_site_reg, "mode", None)
    if mode == "provide":
        if _site_reg.idx >= len(_site_reg.store):
            raise RuntimeError(
                "more quantization sites than the collect pass recorded: the "
                "forward differs from the one the weights were collected on")
        value = _site_reg.store[_site_reg.idx]
        if not isinstance(value, kind):
            raise RuntimeError(
                f"quantization site {_site_reg.idx} wants a {kind.__name__}, "
                f"the collect pass recorded a {type(value).__name__} there: "
                f"the forward differs from the one the weights were "
                f"collected on")
        _site_reg.idx += 1
        return value
    value = make()
    if mode == "collect":
        _site_reg.store.append(value)
    return value


def quantize_weight(w: torch.Tensor, *, axis: int = 0):
    """Symmetric per-output-channel int8: returns ``(w_q, scale)``.

    ``axis`` is the contraction axis; the scale is taken per remaining
    (output) channel and keeps ``w``'s dims, so ``w_q.float() * scale ≈ w``
    broadcasts directly."""
    w32 = w.float()
    amax = w32.abs().amax(dim=axis, keepdim=True)
    scale = amax.clamp_min(_EPS) / 127.0
    w_q = torch.round(w32 / scale).clamp_(-127, 127).to(torch.int8)
    return w_q, scale


def quantize_activation(x: torch.Tensor):
    """Dynamic symmetric per-row int8 over the last axis: ``(x_q, scale)``
    with ``scale`` shaped ``x.shape[:-1] + (1,)``."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(_EPS) / 127.0
    x_q = torch.round(x32 / scale).clamp_(-127, 127).to(torch.int8)
    return x_q, scale


def _int_dot(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact integer product ``x_q (…, K) @ w_q (K, N)`` of int8 codes,
    as f32 (an int32 sum converted to f32).  JAX leaves this product to
    XLA, outside any Pallas kernel, so it is a library product here:
    in f32, whose sums of int8 products are exact up to K = 1040, and in
    f64 above that."""
    if x_q.shape[-1] <= _EXACT_F32_K:
        return x_q.float() @ w_q.float()
    return (x_q.double() @ w_q.double()).float()


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(w_q)`` with the contraction in int8.

    x: (..., K) float; w_q: (K, N) int8; w_scale: (1, N) f32.
    Returns f32 (..., N)."""
    x_q, x_scale = quantize_activation(x)
    return _int_dot(x_q, w_q) * x_scale * w_scale


def _fused_matmul_ok(m: int, k: int, n: int, on_cuda: bool) -> bool:
    """Whether a Linear site takes the fused int8 matmul kernel: wide
    contractions with enough rows, on CUDA tensors (the JAX package's rule
    with its TPU-backend gate)."""
    return on_cuda and k >= 512 and n >= 512 and m >= 64


def int8_dot_general(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``lhs (..., K) @ rhs (K, N)`` for a Linear site under
    ``quant_scope``: int8×int8→int32, weights quantized per output channel
    (once, through the site registry), activations per row; the result is
    cast back to ``lhs.dtype``.  ``rhs`` is the site's weight in any float
    dtype, for instance the ``weight.t()`` view of an ``nn.Linear``; it is
    cast to ``lhs.dtype`` before it is quantized, as the module's own
    product would cast it.

    A site the scope's ``site_pred`` rejects runs the plain product in
    ``lhs.dtype``.  An accepted site takes ``int8_matmul_fused`` (the CUDA
    kernel) when ``_fused_matmul_ok``, else the unfused quantize, exact
    integer product and dequantize."""
    k, n = rhs.shape
    if not quant_site_allowed(int(k), int(n)):
        return lhs @ rhs.to(lhs.dtype)
    def quantize():
        # the codes stored K-major, (N, K) k contiguous: the (K, N) view
        # with strides (1, K) that int8_matmul_fused's wgmma body reads
        # and the plain and unfused routes take as it is; one copy
        w_q, w_scale = quantize_weight(rhs.to(lhs.dtype), axis=0)
        return _kmajor(w_q), w_scale.contiguous()

    w_q, w_scale = site_value(quantize, tuple)
    if w_q.shape != rhs.shape:
        raise RuntimeError(
            f"the quantization site registry handed a {tuple(w_q.shape)} "
            f"weight to a {tuple(rhs.shape)} Linear site: the forward "
            f"differs from the one the weights were collected on")
    m = lhs.numel() // lhs.shape[-1]
    if _fused_matmul_ok(m, int(k), int(n), lhs.device.type == "cuda"):
        return int8_matmul_fused(lhs, w_q, w_scale)
    return int8_matmul(lhs, w_q, w_scale).to(lhs.dtype)


# the block's weight codes that kernel 5 reads on int8 wgmma: stored K-major
_KMAJOR_CODES = ("wqkv_q", "w1_q")


def _kmajor(w_q: torch.Tensor) -> torch.Tensor:
    """The (K, N) codes as the (K, N) view with strides (1, K) of (N, K)
    storage, k contiguous: the same values, one copy."""
    return w_q.t().contiguous().t()


def is_kmajor(w_q: torch.Tensor) -> bool:
    """Whether ``w_q`` is the (K, N) view with strides (1, K) of (N, K)
    storage (``int8_matmul_on_wgmma``'s rule)."""
    return w_q.dim() == 2 and w_q.stride() == (1, w_q.shape[0])


def quant_block_params(params: dict) -> dict:
    """Pre-quantize a fused-block param dict (``ops/fused_block.py`` layout:
    g1/b1/wqkv/wo/bo/g2/b2/w1/bb1/w2/bb2) into the tree the quantized
    blocks consume: all four matrices as ``<name>_q`` int8 and ``<name>_s``
    (1, N) f32, and ``wo``/``w2`` also passed through at full precision,
    because the fused kernel runs those two products in the model dtype.
    ``wqkv_q`` and ``w1_q``, the codes kernel 5 reads on int8 ``wgmma``
    (which reads 8-bit operands only K-major), are stored (N, K) and handed
    out as their (K, N) view with strides (1, K); the values are JAX's, and
    the plain and unfused routes read the view as it is."""
    out = {k: params[k] for k in
           ("g1", "b1", "bo", "g2", "b2", "bb1", "bb2", "wo", "w2")}
    for k in ("wqkv", "wo", "w1", "w2"):
        out[k + "_q"], out[k + "_s"] = quantize_weight(params[k])
    for k in _KMAJOR_CODES:
        out[k] = _kmajor(out[k])
    return out


def _quant_rows(x32: torch.Tensor):
    """The in-kernel dynamic per-row int8 of both kernels: the scheme of
    ``quantize_activation`` with a multiply by the reciprocal instead of a
    divide and without the clip (``|x|·127/amax ≤ 127`` by construction).
    Returns (codes as integer-valued f32, scale ``amax·(1/127)``)."""
    amax = x32.abs().amax(dim=-1, keepdim=True)
    # a true division: ``127.0 / tensor`` is a reciprocal and a product
    inv = torch.full_like(amax, 127.0) / amax.clamp_min(_EPS)
    return torch.round(x32 * inv), amax * (1.0 / 127.0)


def _int8_dot3(x_q, x_scale, w_q, w_scale):
    return _int_dot(x_q, w_q) * x_scale * w_scale.reshape(-1)


# ---------------------------------------------------------------------------
# fused int8 block
# ---------------------------------------------------------------------------


def quant_fused_vit_block_plain(x, qp, heads: int, scale: float,
                                kv_len: int) -> torch.Tensor:
    """Plain PyTorch version of the int8 fused block kernel, step by step
    with the TPU kernel's roundings: x (B, S, D) → y in x's dtype."""
    dtype = x.dtype
    d = x.shape[-1] // heads
    x32 = x.float()
    a, _, _, _ = fb._ln(x32, qp["g1"][0].float(), qp["b1"][0].float())
    a_q, a_s = _quant_rows(a)
    qkv = _int8_dot3(a_q, a_s, qp["wqkv_q"], qp["wqkv_s"])
    att, _ = fb._mha_fwd(qkv, heads, d, scale, kv_len, dtype)
    u = x32 + (fb._mm(att, qp["wo"], dtype) + qp["bo"][0].float())
    b, _, _, _ = fb._ln(u, qp["g2"][0].float(), qp["b2"][0].float())
    b_q, b_s = _quant_rows(b)
    z1 = _int8_dot3(b_q, b_s, qp["w1_q"], qp["w1_s"]) + qp["bb1"][0].float()
    z2 = fb._mm(fb._gelu(z1), qp["w2"], dtype) + qp["bb2"][0].float()
    return (u + z2).to(dtype)


def quant_kernel_takes_width(dtype: torch.dtype, dim: int, head_dim: int,
                             mlp: int) -> bool:
    """The widths kernel 5 is compiled for: head dim a multiple of 16, dim
    and MLP multiples of 64, and in bfloat16 (dim, head dim) in the fused
    block's table (``fused_block._BF16_WIDTHS``, whose attention launch it
    shares)."""
    if dtype not in _DTYPE_CODE or head_dim % 16 or dim % 64 or mlp % 64:
        return False
    return dtype != torch.bfloat16 or (dim, head_dim) in fb._BF16_WIDTHS


def quant_block_eligible(device_type: str, dtype: torch.dtype, dim: int,
                         head_dim: int, mlp: int) -> bool:
    """Whether the int8 fused block takes a block's widths: on CPU tensors
    always (its plain version takes every width), on the card what kernel 5
    is compiled for.  Serving only, so no gradient enters."""
    return device_type != "cuda" \
        or quant_kernel_takes_width(dtype, dim, head_dim, mlp)


def _check_quant_block_args(x, qp, heads: int) -> None:
    """Raise on what the int8 block kernel does not take."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"quant_fused_vit_block takes float32 or bfloat16 x, "
                        f"got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, S, D) tensor, got "
                         f"shape {tuple(x.shape)}")
    dim = x.shape[-1]
    mlp = qp["w1_q"].shape[-1]
    want = {"g1": ((1, dim), torch.float32), "b1": ((1, dim), torch.float32),
            "wqkv_q": ((dim, 3 * dim), torch.int8),
            "wqkv_s": ((1, 3 * dim), torch.float32),
            "wo": ((dim, dim), x.dtype), "bo": ((1, dim), torch.float32),
            "g2": ((1, dim), torch.float32), "b2": ((1, dim), torch.float32),
            "w1_q": ((dim, mlp), torch.int8),
            "w1_s": ((1, mlp), torch.float32),
            "bb1": ((1, mlp), torch.float32), "w2": ((mlp, dim), x.dtype),
            "bb2": ((1, dim), torch.float32)}
    for name, (shape, dtype) in want.items():
        t = qp[name]
        # Wqkv's and W1's codes K-major (the view quant_block_params makes),
        # 16-byte aligned: TMA reads them for the int8 wgmma
        layout_ok = (is_kmajor(t) and t.data_ptr() % 16 == 0
                     if name in _KMAJOR_CODES else t.is_contiguous())
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != x.device or not layout_ok:
            layout = ("the K-major (K, N) view with strides (1, K) of (N, K) "
                      "storage, 16-byte aligned" if name in _KMAJOR_CODES
                      else "contiguous")
            raise ValueError(
                f"param {name}: need a {dtype} tensor of shape {shape} on "
                f"{x.device}, {layout}; got {t.dtype} {tuple(t.shape)} "
                f"strides {t.stride()} on {t.device}")
    d = dim // heads
    if heads * d != dim or d % 16 or dim % 64 or mlp % 64:
        raise ValueError(f"the kernel needs dim = heads*d with d a multiple "
                         f"of 16 and dim and mlp multiples of 64; got "
                         f"dim={dim} heads={heads} mlp={mlp}")
    if not quant_kernel_takes_width(x.dtype, dim, d, mlp):
        raise ValueError(f"the bfloat16 kernel is compiled for (dim, head "
                         f"dim) in {fb._BF16_WIDTHS}; got dim={dim} d={d}")


def _quant_block_cuda(x, qp, heads, scale, kv_len):
    _check_quant_block_args(x, qp, heads)
    from devt_tpu_torch.ops import _build

    lib = _build.load("quant_block_fwd", _declare_block)
    bsz, s, dim = x.shape
    mlp = qp["w1_q"].shape[-1]
    dev = x.device

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    y = torch.empty_like(x)
    qkv = empty((bsz, s, 3 * dim), x.dtype)
    att = torch.empty_like(x)
    lse = empty((bsz, s, heads), torch.float32)
    u32 = codes = row_scale = z1 = None
    if x.dtype == torch.float32:     # the float route's global intermediates
        u32 = empty(x.shape, torch.float32)
        codes = empty((bsz * s, dim), torch.int8)
        row_scale = empty((bsz * s,), torch.float32)
        z1 = empty((bsz, s, mlp), torch.float32)

    def ptr(t):
        return None if t is None else ctypes.c_void_p(t.data_ptr())

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.devt_quant_block_fwd(
            _DTYPE_CODE[x.dtype], ptr(x),
            *(ptr(qp[k]) for k in QUANT_PARAM_NAMES),
            ptr(y), ptr(qkv), ptr(att), ptr(lse), ptr(u32), ptr(codes),
            ptr(row_scale), ptr(z1), bsz, s, dim, heads, mlp, int(kv_len),
            ctypes.c_float(scale), ctypes.c_void_p(stream))
    fb._check(lib, rc, "quant_block_fwd")
    quant_fused_vit_block.launches += 1
    if fb.attn_half_on_wgmma(x.dtype, dim // heads, kv_len):
        quant_fused_vit_block.wgmma_launches += 1
    else:
        quant_fused_vit_block.streamed_launches += 1
    return y


def _quant_block_impl(x, tensors, heads, scale, kv_len):
    qp = dict(zip(QUANT_PARAM_NAMES, tensors))
    if x.device.type == "cuda":
        return _quant_block_cuda(x, qp, heads, scale, kv_len)
    return quant_fused_vit_block_plain(x, qp, heads, scale, kv_len)


def _quant_block_fake(x, tensors, heads, scale, kv_len):
    return x.new_empty(x.shape)


# kernel 5: y, the int8 tree in QUANT_PARAM_NAMES order
quant_block_fwd_op = kernel_op(
    "quant_block_fwd", "(Tensor x, Tensor[] params, int heads, float scale, "
    "int kv_len) -> Tensor", _quant_block_impl, _quant_block_fake)


def quant_fused_vit_block(x, qp, heads: int, scale: float,
                          kv_len: int) -> torch.Tensor:
    """One fused mixed-precision int8 pre-norm ViT block forward, eval
    only.  ``qp`` is the :func:`quant_block_params` tree with ``wo`` and
    ``w2`` in x's dtype; Wqkv and W1 run int8, Wo and W2 in x's dtype.
    Same single-kv-block contract as ``fused_vit_block``.

    Through the ``devt_tpu_torch::quant_block_fwd`` op
    (``ops/_library.py``): a CUDA tensor launches the kernel (raising on a
    shape it does not cover or a failed launch); a CPU tensor runs the
    plain version."""
    return quant_block_fwd_op(x, [qp[k] for k in QUANT_PARAM_NAMES], heads,
                              float(scale), int(kv_len))


quant_fused_vit_block.launches = 0
quant_fused_vit_block.wgmma_launches = 0
quant_fused_vit_block.streamed_launches = 0


# ---------------------------------------------------------------------------
# fused int8 matmul
# ---------------------------------------------------------------------------


def int8_matmul_fused_plain(x, w_q, w_scale) -> torch.Tensor:
    """Plain PyTorch version of the fused int8 matmul kernel: x (..., K),
    w_q (K, N) int8, w_scale (1, N) f32 → (..., N) in x's dtype."""
    x_q, x_scale = _quant_rows(x.float())
    out = _int_dot(x_q, w_q) * x_scale * w_scale.float().reshape(-1)
    return out.to(x.dtype)


def int8_matmul_on_wgmma(w_q: torch.Tensor) -> bool:
    """Whether ``int8_matmul_fused`` runs its wgmma body on these weight
    codes: the rule of the C entry, ``csrc/gemm_s8_sm90.cuh``
    ``int8_gemm_on_wgmma``.  A (K, N) view with strides (1, K), K-major
    codes stored (N, K) as the site registry stores them, takes it; the
    row-major (K, N) codes of the JAX layout take the mma.sync body of
    ``csrc/int8_common.cuh`` (``gemm_s8``), whatever x's dtype."""
    return is_kmajor(w_q)


def _check_matmul_args(x, w_q, w_scale) -> None:
    """Raise on what the int8 matmul kernel does not take."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"int8_matmul_fused takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if x.dim() < 1 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (..., K) tensor, got shape "
                         f"{tuple(x.shape)}")
    k = x.shape[-1]
    if w_q.dim() != 2 or w_q.shape[0] != k or w_q.dtype != torch.int8 \
            or w_q.device != x.device \
            or not (w_q.is_contiguous() or int8_matmul_on_wgmma(w_q)):
        raise ValueError(f"w_q: need an int8 tensor of shape ({k}, N) on "
                         f"{x.device}, contiguous or the K-major view of an "
                         f"(N, {k}) one, got {w_q.dtype} "
                         f"{tuple(w_q.shape)} strides {w_q.stride()} on "
                         f"{w_q.device}")
    if int8_matmul_on_wgmma(w_q) and w_q.data_ptr() % 16:
        raise ValueError("K-major w_q must start 16-byte aligned (a TMA "
                         "map's base)")
    n = w_q.shape[1]
    if w_scale.numel() != n or w_scale.dtype != torch.float32 \
            or w_scale.device != x.device or not w_scale.is_contiguous():
        raise ValueError(f"w_scale: need a contiguous float32 tensor of {n} "
                         f"elements on {x.device}, got {w_scale.dtype} "
                         f"{tuple(w_scale.shape)} on {w_scale.device}")
    if k % 64 or n % 64 or x.numel() == 0:
        raise ValueError(f"the kernel needs K and N multiples of 64 and at "
                         f"least one row; got x {tuple(x.shape)}, N={n}")


def _matmul_cuda(x, w_q, w_scale):
    _check_matmul_args(x, w_q, w_scale)
    from devt_tpu_torch.ops import _build

    lib = _build.load("int8_matmul", _declare_matmul)
    k, n = w_q.shape
    m = x.numel() // k
    wgmma = int8_matmul_on_wgmma(w_q)
    out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    codes = torch.empty((m, k), dtype=torch.int8, device=x.device)
    row_scale = torch.empty((m,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.devt_int8_matmul(
            _DTYPE_CODE[x.dtype], int(wgmma), ctypes.c_void_p(x.data_ptr()),
            ctypes.c_void_p(w_q.data_ptr()),
            ctypes.c_void_p(w_scale.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(codes.data_ptr()),
            ctypes.c_void_p(row_scale.data_ptr()), m, k, n,
            ctypes.c_void_p(stream))
    fb._check(lib, rc, "int8_matmul")
    int8_matmul_fused.launches += 1
    if wgmma:
        int8_matmul_fused.wgmma_launches += 1
    else:
        int8_matmul_fused.mma_sync_launches += 1
    return out


def _matmul_impl(x, w_q, w_scale):
    if x.device.type == "cuda":
        return _matmul_cuda(x, w_q, w_scale)
    return int8_matmul_fused_plain(x, w_q, w_scale)


def _matmul_fake(x, w_q, w_scale):
    return x.new_empty((*x.shape[:-1], w_q.shape[1]))


# kernel 6: x @ dequant(w_q) in x's dtype
int8_matmul_op = kernel_op(
    "int8_matmul", "(Tensor x, Tensor w_q, Tensor w_scale) -> Tensor",
    _matmul_impl, _matmul_fake)


def int8_matmul_fused(x, w_q, w_scale) -> torch.Tensor:
    """``x @ dequant(w_q)`` with the row quantize, the int8 product and the
    dequantize in hand-written kernels.  x ``(..., K)`` float; w_q
    ``(K, N)`` int8, row-major or the K-major view of (N, K) storage (the
    site registry's layout; ``int8_matmul_on_wgmma`` names the body each
    takes, counted in ``.wgmma_launches`` and ``.mma_sync_launches``);
    w_scale ``(1, N)`` f32.  Returns ``x.dtype`` shaped ``(..., N)``.

    Through the ``devt_tpu_torch::int8_matmul`` op (``ops/_library.py``):
    a CUDA tensor launches the kernel (raising on a shape it does not
    cover or a failed launch); a CPU tensor runs the plain version."""
    return int8_matmul_op(x, w_q, w_scale)


int8_matmul_fused.launches = 0
int8_matmul_fused.wgmma_launches = 0
int8_matmul_fused.mma_sync_launches = 0


# ---------------------------------------------------------------------------
# the block's dispatch
# ---------------------------------------------------------------------------


def _fused_quant_ok(x, qp, heads: int) -> bool:
    """The JAX package's rule (``devt_tpu/ops/quant.py:404``), and on the
    card the widths kernel 5 is compiled for."""
    _, s, dim = x.shape
    inner = qp["wqkv_q"].shape[1] // 3
    return (inner == dim and dim % heads == 0
            and fits_single_block(s) and s % 16 == 0
            and quant_block_eligible(x.device.type, x.dtype, dim,
                                     dim // heads, qp["w1_q"].shape[-1]))


def quant_vit_block(x, qp, heads: int, scale: float, kv_len: int, *,
                    impl: str = "auto") -> torch.Tensor:
    """Pre-norm ViT block forward with the big products in int8 (eval
    only); ``qp`` is the :func:`quant_block_params` tree.

    ``impl`` is the block's ``attention_impl``.  Anything but ``"xla"``
    routes eligible shapes through :func:`quant_fused_vit_block`.  A block
    pinned to ``"xla"``, or an ineligible shape (a token count that is no
    multiple of 16, more than one kv block, a width kernel 5 is not compiled
    for), runs unfused: residual stream and LN in f32, all four products
    through ``int8_matmul``, the attention core in the model dtype through
    the dispatching attention (on the card kernel 9, or kernel 11 above one
    kv block; the plain attention for ``"xla"``), tanh GELU as on the fused
    path."""
    if impl != "xla" and _fused_quant_ok(x, qp, heads):
        return quant_fused_vit_block(x, qp, heads, scale, kv_len)

    b, s, _ = x.shape
    inner = qp["wqkv_q"].shape[1] // 3
    d = inner // heads
    x32 = x.float()
    a, _, _, _ = fb._ln(x32, qp["g1"].float(), qp["b1"].float())
    qkv = int8_matmul(a, qp["wqkv_q"], qp["wqkv_s"])
    # packed (3, H, d) column order, the fused layout
    qkv = qkv.reshape(b, s, 3, heads, d).permute(2, 0, 3, 1, 4).to(x.dtype)
    att = scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], scale=scale,
                                       kv_len=kv_len, impl=impl)
    att = att.transpose(1, 2).reshape(b, s, inner)
    u = x32 + int8_matmul(att, qp["wo_q"], qp["wo_s"]) + qp["bo"].float()
    h2, _, _, _ = fb._ln(u, qp["g2"].float(), qp["b2"].float())
    z1 = int8_matmul(h2, qp["w1_q"], qp["w1_s"]) + qp["bb1"].float()
    z2 = int8_matmul(fb._gelu(z1), qp["w2_q"], qp["w2_s"]) \
        + qp["bb2"].float()
    return (u + z2).to(x.dtype)


def _declare_block(lib: ctypes.CDLL) -> None:
    lib.devt_quant_block_fwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 22 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p])
    lib.devt_quant_block_fwd.restype = ctypes.c_int
    lib.devt_quant_block_route.argtypes = [ctypes.c_int] * 3
    lib.devt_quant_block_route.restype = ctypes.c_int
    lib.devt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.devt_cuda_error_string.restype = ctypes.c_char_p


def _declare_matmul(lib: ctypes.CDLL) -> None:
    lib.devt_int8_matmul.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
        + [ctypes.c_void_p])
    lib.devt_int8_matmul.restype = ctypes.c_int
    lib.devt_int8_matmul_route.argtypes = [ctypes.c_int]
    lib.devt_int8_matmul_route.restype = ctypes.c_int
    lib.devt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.devt_cuda_error_string.restype = ctypes.c_char_p
