"""Fused pre-norm ViT block forward: a CUDA kernel and its plain version.

Port of ``devt_tpu/ops/fused_block.py:_fwd_kernel`` (the Pallas kernel
that ``fused_vit_block`` launches once per ViT block, 4 times per ViViT
serving forward):

    a   = LN1(x)                      (γ1, β1; f32 stats)
    qkv = a @ Wqkv                    (no bias; columns ordered (3, H, d))
    att = MHA(qkv)                    (per head, additive -1e30 key mask,
                                       softmax normalised after PV)
    u   = x + att @ Wo + bo
    b   = LN2(u)
    y   = u + gelu_tanh(b @ W1 + bb1) @ W2 + bb2

Outputs y and u in x's dtype, and the residual lanes (B, S, 8) f32
``[lse (H), mu1, rstd1, mu2, rstd2, 0…]`` that the backward kernel of the
training slice reads.  Matrix operands are rounded to x's dtype and
products accumulate in f32; LN statistics and softmax are f32.

The kernel (``csrc/fused_block_fwd.cu``, CUDA C++ for sm_90a):
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
    rows; attention per (64 queries, head, sequence) with K/V in shared
    memory, in two passes over the keys so the softmax is the TPU
    kernel's one-shot softmax; out-projection+LN2+FFN per 128 rows with
    Wo, W1 and W2 slices double-buffered by cp.async.  The bf16 products are
    mma.sync m16n8k16 tiles fed by ldmatrix, accumulating in registers;
    the f32 route uses FMA loops; no library GEMM.  The kernel reaches
    about a tenth of the bound (mma.sync, not wgmma); its times are in
    PERF.md.

``fused_vit_block`` launches the kernel for CUDA tensors (or raises) and
runs ``fused_vit_block_fwd_plain`` only for CPU tensors.  Its ``launches``
attribute counts kernel launches (one per call on the card).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from devt_tpu_torch.ops.flash_attention import NEG_INF, _round_up

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


def _mm(a, w, dtype):
    """``a @ w`` with both operands rounded to ``dtype`` and an f32 result
    (``preferred_element_type=f32``)."""
    return a.to(dtype).float() @ w.to(dtype).float()


def _mha_fwd(qkv, heads, d, scale, kv_len, dtype):
    """qkv (B, S, 3HD) f32 → (att (B, S, HD) f32, lse (B, S, H) f32)."""
    s_len = qkv.shape[1]
    col = torch.arange(s_len, device=qkv.device)
    bias = torch.where(col < kv_len, 0.0, NEG_INF).to(torch.float32)
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


def fused_vit_block_fwd_plain(x, params, heads, scale, kv_len):
    """Plain PyTorch version of the kernel: (y, u, res) as above."""
    dtype = x.dtype
    d = x.shape[-1] // heads
    p = {k: params[k].float() for k in PARAM_NAMES}
    x32 = x.float()
    a, _, mu1, rstd1 = _ln(x32, p["g1"][0], p["b1"][0])
    qkv = _mm(a, params["wqkv"], dtype)
    att, lse = _mha_fwd(qkv, heads, d, scale, kv_len, dtype)
    u = x32 + (_mm(att, params["wo"], dtype) + p["bo"][0])
    b, _, mu2, rstd2 = _ln(u, p["g2"][0], p["b2"][0])
    h = _gelu(_mm(b, params["w1"], dtype) + p["bb1"][0])
    y = u + (_mm(h, params["w2"], dtype) + p["bb2"][0])
    res = torch.cat([lse, mu1, rstd1, mu2, rstd2], dim=-1)
    res = F.pad(res, (0, _round_up(heads + 4, 8) - heads - 4))
    return y.to(dtype), u.to(dtype), res


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


def _check_cuda_args(x, params, heads):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_vit_block takes float32 or bfloat16 x, "
                        f"got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, S, D) tensor, got "
                         f"shape {tuple(x.shape)}")
    dim = x.shape[-1]
    mlp = params["w1"].shape[-1]
    shapes = {"g1": (1, dim), "b1": (1, dim), "wqkv": (dim, 3 * dim),
              "wo": (dim, dim), "bo": (1, dim), "g2": (1, dim),
              "b2": (1, dim), "w1": (dim, mlp), "bb1": (1, mlp),
              "w2": (mlp, dim), "bb2": (1, dim)}
    for name, shape in shapes.items():
        t = params[name]
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
    if x.dtype == torch.bfloat16 and ((dim, d) not in _BF16_WIDTHS
                                      or mlp % 64):
        raise ValueError(f"the bfloat16 kernel is compiled for (dim, head "
                         f"dim) in {_BF16_WIDTHS} with mlp a multiple of 64; "
                         f"got dim={dim} d={d} mlp={mlp}")


def fused_vit_block(x, params, heads, scale, kv_len, dropout_rate=0.0):
    """One fused pre-norm ViT block forward → (y, u, res).

    x (B, S, D); ``params`` holds g1/b1/wqkv/wo/bo/g2/b2/w1/bb1/w2/bb2 in
    the JAX kernel's layout: weight matrices (K, N) in x's dtype, LN
    parameters and biases (1, N) f32.  ``kv_len`` masks key padding.

    A CUDA tensor launches the kernel (raising if the launch fails); a CPU
    tensor runs the plain version.  The JAX function returns only y
    because its custom_vjp keeps u and res for the backward; here they are
    returned for the training slice's backward kernel."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "in-kernel dropout (Philox) comes with the training slice — "
            "ROADMAP.md; serving runs with dropout_rate=0")
    if x.device.type == "cpu":
        return fused_vit_block_fwd_plain(x, params, heads, scale, kv_len)
    if x.device.type != "cuda":
        raise ValueError(f"fused_vit_block runs on cuda or cpu, not "
                         f"{x.device}")
    _check_cuda_args(x, params, heads)
    from devt_tpu_torch.ops import _build

    lib = _build.load("fused_block_fwd", _declare)
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
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.devt_fused_block_fwd(
            _DTYPE_CODE[x.dtype], ptr(x),
            *(ptr(params[k]) for k in PARAM_NAMES),
            ptr(y), ptr(u), ptr(res), ptr(qkv), ptr(att),
            ptr(u32) if u32 is not None else None,
            bsz, s, dim, heads, params["w1"].shape[-1], int(kv_len), lanes,
            ctypes.c_float(scale), ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.devt_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_block_fwd launch failed: {msg} ({rc})")
    fused_vit_block.launches += 1
    return y, u, res


fused_vit_block.launches = 0


def _declare(lib: ctypes.CDLL) -> None:
    lib.devt_fused_block_fwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 18 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_void_p])
    lib.devt_fused_block_fwd.restype = ctypes.c_int
    lib.devt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.devt_cuda_error_string.restype = ctypes.c_char_p
