"""Scaled-dot-product attention for the unfused path.

Port of ``devt_tpu/ops/attention.py:xla_attention`` and ``packed_mha``.
JAX computes this attention with XLA, outside any Pallas kernel, so the
port's version is plain PyTorch: scores in f32 whatever the input dtype,
an additive -1e30 key-padding mask, softmax, then P (cast to v's dtype)
times V.

``impl``: ``"xla"``, ``"auto"`` and ``"fused_interpret"`` run this plain
attention (``"auto"`` picks the packed-qkv kernel in JAX, which is not
ported yet); ``"pallas"`` would need ``fused_mha`` and raises.
"""

from __future__ import annotations

import torch

from devt_tpu_torch.ops.flash_attention import NEG_INF

_FUSED_MHA_TODO = ("the packed-qkv attention kernel (devt_tpu/ops/"
                   "flash_attention.py:_mha_fwd_kernel, fused_mha) is not "
                   "ported yet — ROADMAP.md queue 2, item 3; use "
                   "attention_impl='xla'")


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, kv_len: int | None = None) -> torch.Tensor:
    """Materialised softmax attention.  q, k, v: (B, H, S, D) → (B, H, S, D)
    in v's dtype.  ``kv_len`` masks key positions at and beyond it."""
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * scale
    if kv_len is not None and kv_len < k.shape[2]:
        keep = torch.arange(k.shape[2], device=s.device) < kv_len
        s = torch.where(keep[None, None, None, :], s,
                        torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhij,bhjd->bhid", p.to(v.dtype), v)


def packed_mha(qkv: torch.Tensor, *, heads: int, scale: float | None = None,
               impl: str = "auto", kv_len: int | None = None) -> torch.Tensor:
    """Attention on the packed qkv projection output:
    qkv (B, S, 3*H*D) with feature order (3, H, D) → (B, S, H*D)."""
    if impl == "pallas":
        raise NotImplementedError(_FUSED_MHA_TODO)
    if impl not in ("auto", "xla", "fused_interpret"):
        raise ValueError(f"unknown attention impl {impl!r}")
    b, s, f = qkv.shape
    d = f // (3 * heads)
    if scale is None:
        scale = d ** -0.5
    split = qkv.reshape(b, s, 3, heads, d)
    q, k, v = (split[:, :, i].transpose(1, 2) for i in range(3))
    out = xla_attention(q, k, v, scale=scale, kv_len=kv_len)
    return out.transpose(1, 2).reshape(b, s, heads * d)
