"""Packed-qkv attention: the CUDA kernel and its plain version.

Port of ``devt_tpu/ops/flash_attention.py``: its constants, and
``fused_mha`` — the forward of the packed-qkv single-block attention
(``_mha_fwd_kernel``, ``:558``, launched from ``_mha_fwd``, ``:669``).
qkv is (B, S, 3*H*D) with the last axis ordered (3, H, D); per head

    s   = q kᵀ · scale            (f32; key columns ≥ kv_len at -1e30)
    p   = exp(s - max s);  l = Σ p
    o   = (p / l cast to v's dtype) @ v          (f32 accumulation)
    lse = max s + log l

o is (B, S, H*D) in qkv's dtype and lse (B, S, H) f32.  The TPU kernel
writes lse broadcast over 128 lanes per head, a layout of that chip; here
it is one value per row and head.

The kernel (``csrc/mha_fwd.cu`` with ``csrc/attention_fwd.cuh``, CUDA C++
for sm_90a) shares its body with the attention launch of the fused ViT
block: a block per (64 queries, head, sequence) with K and V in shared
memory, ``mma.sync`` bf16 tiles, the scores recomputed per pass (row max,
row sum, product) so that p is normalised and rounded where the TPU kernel
does it; head dims above 64 take the product 64 output columns at a time.
bfloat16 is compiled for head dims 16, 32, 64, 128 and 256, float (FMA
products) for any multiple of 4.  The kernel masks rows past S itself, so
the wrapper pads nothing (the TPU wrapper pads S to a multiple of 16).
At the serving shapes bytes bind it; its times are in PERF.md.

``fused_mha`` launches the kernel for CUDA tensors (or raises) and runs
``fused_mha_plain`` only for CPU tensors.  There is no backward yet: the
backward kernel (``_mha_bwd_kernel``, ROADMAP.md queue 2, kernel 4) and
the in-kernel attention-probability dropout come with the training slice
of the torch-semantics encoder, and until then a CUDA input that needs a
gradient, or ``dropout_rate > 0``, raises ``NotImplementedError``.
``fused_mha.launches`` counts kernel launches.

The blockwise flash kernels for S > 512 and the split-qkv single-block
kernels (ROADMAP.md queue 2, kernels 9-13) are not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

# additive key-padding mask value: -1e30, not -inf, keeps a fully masked
# row NaN-free, and exp() turns it into an exact zero next to a real score
NEG_INF = -1e30
_LANES = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# head dims the bfloat16 kernel is instantiated for (csrc/mha_fwd.cu)
_BF16_HEAD_DIMS = (16, 32, 64, 128, 256)
# dynamic shared memory one block can have on sm_90 (227 KB)
_SMEM_PER_BLOCK = 232448

_MHA_BWD_TODO = ("fused_mha has no backward yet: the packed-qkv attention "
                 "backward (devt_tpu/ops/flash_attention.py:_mha_bwd_kernel, "
                 "kernel 4) is not ported — ROADMAP.md queue 2; pin "
                 "attention_impl='xla' to train on the card until then")
_MHA_DROPOUT_TODO = ("fused_mha has no attention-probability dropout yet: it "
                     "comes with kernel 4 (ROADMAP.md queue 2); pin "
                     "attention_impl='xla' to train with dropout until then")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def fits_single_block(s: int) -> bool:
    """True when a sequence fits one kv block of the single-block
    kernels (the fused ViT block, ``fused_mha``): S rounded up to 128 is
    at most 512."""
    return _round_up(s, _LANES) <= 512


def fused_mha_plain(qkv: torch.Tensor, heads: int, scale: float,
                    kv_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, step by step with the TPU
    kernel's roundings: qkv (B, S, 3HD) → (o (B, S, HD) in qkv's dtype,
    lse (B, S, H) f32)."""
    dtype = qkv.dtype
    d = qkv.shape[-1] // (3 * heads)
    col = torch.arange(qkv.shape[1], device=qkv.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=qkv.device)
    outs, lses = [], []
    for i in range(heads):
        q = qkv[..., i * d:(i + 1) * d].float()
        k = qkv[..., (heads + i) * d:(heads + i + 1) * d].float()
        v = qkv[..., (2 * heads + i) * d:(2 * heads + i + 1) * d].float()
        s = (q @ k.transpose(1, 2)) * scale
        s = torch.where(col < kv_len, s, neg)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        pn = (p / l).to(dtype).float()
        outs.append((pn @ v).to(dtype))
        lses.append(m + torch.log(l))
    return torch.cat(outs, dim=-1), torch.cat(lses, dim=-1)


def _check_mha_args(qkv: torch.Tensor, heads: int, kv_len: int) -> int:
    """Raise on what the kernel does not take; returns the head dim."""
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
    if qkv.dtype == torch.bfloat16:
        if d not in _BF16_HEAD_DIMS:
            raise ValueError(f"the bfloat16 kernel is compiled for head dims "
                             f"{_BF16_HEAD_DIMS}, got {d}")
        # 64 queries, and K and V of kv_len rounded up to 32 rows, rows
        # padded by 8
        need = (64 + 2 * _round_up(kv_len, 32)) * (d + 8) * 2
    else:
        if d % 4:
            raise ValueError(f"the float32 kernel needs a head dim that is a "
                             f"multiple of 4, got {d}")
        sp = _round_up(s, 16)
        need = ((2 * 32 + 2 * sp) * (d + 4) + 32 * (sp + 4) + 64) * 4 + 1024
    if need > _SMEM_PER_BLOCK:
        raise ValueError(
            f"the kernel keeps one head's K and V in shared memory: {s} "
            f"tokens (kv_len {kv_len}) of head dim {d} need {need} bytes, a "
            f"block has {_SMEM_PER_BLOCK}")
    return d


def _mha_cuda(qkv, heads, scale, kv_len):
    d = _check_mha_args(qkv, heads, kv_len)
    from devt_tpu_torch.ops import _build

    lib = _build.load("mha_fwd", _declare)
    b, s, _ = qkv.shape
    o = torch.empty((b, s, heads * d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, s, heads), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.devt_mha_fwd(
            _DTYPE_CODE[qkv.dtype], ctypes.c_void_p(qkv.data_ptr()),
            ctypes.c_void_p(o.data_ptr()), ctypes.c_void_p(lse.data_ptr()),
            b, s, heads, d, int(kv_len), ctypes.c_float(scale),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"mha_fwd launch failed: "
                           f"{lib.devt_cuda_error_string(rc).decode()} ({rc})")
    fused_mha.launches += 1
    return o, lse


def fused_mha(qkv: torch.Tensor, *, heads: int, scale: float | None = None,
              kv_len: int | None = None, dropout_rate: float = 0.0,
              return_lse: bool = False):
    """Packed-qkv attention.  qkv (B, S, 3*H*D), last axis ordered
    (3, H, D) → (B, S, H*D); with ``return_lse`` also lse (B, S, H) f32.
    Single-kv-block sequences only (``fits_single_block``); the callers
    dispatch longer ones elsewhere.

    A CUDA tensor launches the kernel (raising on a shape it does not
    cover or a failed launch); a CPU tensor runs ``fused_mha_plain``.
    No backward and no dropout yet (module docstring): on the card an
    input that needs a gradient, and ``dropout_rate > 0`` anywhere, raise
    ``NotImplementedError``."""
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (B, S, 3*H*D), got {tuple(qkv.shape)}")
    d = qkv.shape[-1] // (3 * heads)
    if scale is None:
        scale = d ** -0.5
    kv_len = qkv.shape[1] if kv_len is None else int(kv_len)
    if float(dropout_rate) > 0.0:
        raise NotImplementedError(_MHA_DROPOUT_TODO)
    if qkv.device.type == "cuda":
        if torch.is_grad_enabled() and qkv.requires_grad:
            raise NotImplementedError(_MHA_BWD_TODO)
        o, lse = _mha_cuda(qkv, heads, float(scale), kv_len)
    elif qkv.device.type == "cpu":
        o, lse = fused_mha_plain(qkv, heads, float(scale), kv_len)
    else:
        raise ValueError(f"fused_mha runs on cuda or cpu, not {qkv.device}")
    return (o, lse) if return_lse else o


fused_mha.launches = 0


def _declare(lib: ctypes.CDLL) -> None:
    lib.devt_mha_fwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p])
    lib.devt_mha_fwd.restype = ctypes.c_int
    lib.devt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.devt_cuda_error_string.restype = ctypes.c_char_p
