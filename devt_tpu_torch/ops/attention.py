"""Scaled-dot-product attention with dispatch, and the int8 serving scope.

Port of ``devt_tpu/ops/attention.py``.

``impl``:
  * ``"xla"``    — the materialised softmax attention (``xla_attention``).
                   JAX computes it with XLA, outside any Pallas kernel, so
                   here it is plain PyTorch: scores in f32 whatever the
                   input dtype, a -1e30 key-padding mask, softmax, optional
                   dropout on the probabilities, then P (cast to v's dtype)
                   times V.
  * ``"pallas"`` — the hand-written kernels.  ``packed_mha`` reaches
                   ``fused_mha`` (``ops/flash_attention.py``: the packed-qkv
                   CUDA kernels, forward and backward, with the
                   attention-probability dropout inside them) for
                   single-kv-block sequences; on CPU tensors ``fused_mha``
                   runs its plain versions.  The split-q/k/v kernels that
                   ``scaled_dot_product_attention`` would launch (kernels
                   9-13) are not ported, and it raises.
  * ``"auto"``   — in ``packed_mha``: ``"pallas"`` for CUDA tensors,
                   training and serving alike, the plain attention for CPU
                   tensors.  In ``scaled_dot_product_attention``: likewise
                   ``"pallas"`` for CUDA tensors (it raises until kernels
                   9-13 are ported), the plain attention for CPU tensors.
  * ``"fused_interpret"`` — the JAX package's CPU-interpreter switch for the
                   fused block; where it reaches this module it means the
                   plain attention.

``quant_scope`` marks a forward as int8 serving: ``models/layers.ViTBlock``
and the Linear sites of ``models/torch_encoder.py`` read it.  The scope is
a re-entrant, thread-local context manager; it works eagerly as JAX's does
at trace time.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from devt_tpu_torch.ops.flash_attention import (NEG_INF, fits_single_block,
                                                fused_mha)

_SDPA_KERNEL_TODO = ("the split-q/k/v attention kernels (devt_tpu/ops/"
                     "flash_attention.py:_fwd_single_kernel and _fwd_kernel, "
                     "kernels 9 and 11) are not ported yet — ROADMAP.md "
                     "queue 2; use attention_impl='xla' until then")

_gate = threading.local()


@contextlib.contextmanager
def quant_scope(site_pred=None):
    """Inside the scope, ViT blocks and the torch-semantics encoder's
    Linear sites in eval mode run their big products in int8
    (``ops/quant.py``); ``serve.Predictor(quantize=True)`` sets it around
    every forward.  Serving only: the quantized paths have no dropout and
    no backward.  Re-entrant, thread-local, bounded by the ``with``.

    ``site_pred``: optional ``(k, n) -> bool`` filter over Linear
    contraction shapes; the sites it rejects run the plain product in the
    module's own dtype."""
    prev = getattr(_gate, "quant", False)
    prev_pred = getattr(_gate, "quant_pred", None)
    _gate.quant = True
    _gate.quant_pred = site_pred
    try:
        yield
    finally:
        _gate.quant = prev
        _gate.quant_pred = prev_pred


def quant_active() -> bool:
    """True inside :func:`quant_scope`."""
    return bool(getattr(_gate, "quant", False))


def quant_site_allowed(k: int, n: int) -> bool:
    """Whether the active quant_scope wants the ``(…, k)·(k, n)`` Linear
    site quantized (True unless a ``site_pred`` rejects it)."""
    pred = getattr(_gate, "quant_pred", None)
    return True if pred is None else bool(pred(k, n))


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, kv_len: int | None = None,
                  dropout_rate: float = 0.0, rng=None) -> torch.Tensor:
    """Materialised softmax attention.  q, k, v: (B, H, S, D) → (B, H, S, D)
    in v's dtype.  ``kv_len`` masks key positions at and beyond it.
    ``dropout_rate`` > 0 with a ``rng`` (``models.layers.DropoutRng``)
    drops softmax probabilities, as torch's MultiheadAttention does."""
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * scale
    if kv_len is not None and kv_len < k.shape[2]:
        keep = torch.arange(k.shape[2], device=s.device) < kv_len
        s = torch.where(keep[None, None, None, :], s,
                        torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0 and rng is not None:
        p = torch.where(rng.keep(p, dropout_rate), p / (1.0 - dropout_rate),
                        torch.zeros((), dtype=p.dtype, device=p.device))
    return torch.einsum("bhij,bhjd->bhid", p.to(v.dtype), v)


def scaled_dot_product_attention(q, k, v, *, scale: float | None = None,
                                 impl: str = "auto",
                                 kv_len: int | None = None,
                                 dropout_rate: float = 0.0,
                                 rng=None) -> torch.Tensor:
    """Dispatching attention on split heads.  q, k, v: (B, H, S, D) →
    (B, H, Sq, D).  Until kernels 9-13 are ported ``"pallas"`` raises, and
    so does ``"auto"`` on CUDA tensors, where it means the kernel;
    ``"xla"``, and ``"auto"`` on CPU tensors, are the plain attention."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl not in ("auto", "xla", "pallas", "fused_interpret"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "pallas" or (impl == "auto" and q.device.type == "cuda"):
        raise NotImplementedError(_SDPA_KERNEL_TODO)
    return xla_attention(q, k, v, scale=scale, kv_len=kv_len,
                         dropout_rate=dropout_rate, rng=rng)


def packed_mha(qkv: torch.Tensor, *, heads: int, scale: float | None = None,
               impl: str = "auto", kv_len: int | None = None,
               dropout_rate: float = 0.0, rng=None) -> torch.Tensor:
    """Attention on the packed qkv projection output:
    qkv (B, S, 3*H*D) with feature order (3, H, D) → (B, S, H*D).

    On the card, ``"auto"`` and ``"pallas"`` feed single-kv-block
    sequences to ``fused_mha`` directly, with no head split or merge: its
    forward kernel, and for an input that needs a gradient its backward
    kernel, with the dropout inside both (the seed drawn from ``rng``).
    Nothing on the card gives way to the plain attention unasked.
    ``"pallas"`` on CPU tensors runs ``fused_mha``'s plain versions.
    ``"xla"``, and ``"auto"`` on CPU tensors, split the heads for the
    materialised attention.  ``dropout_rate > 0`` needs a ``rng``
    (``models.layers.DropoutRng``)."""
    if impl not in ("auto", "xla", "pallas", "fused_interpret"):
        raise ValueError(f"unknown attention impl {impl!r}")
    b, s, f = qkv.shape
    d = f // (3 * heads)
    if scale is None:
        scale = d ** -0.5
    if dropout_rate > 0.0 and rng is None:
        raise ValueError("dropout_rate > 0 needs rng=, a DropoutRng "
                         "(models/layers.py)")
    resolved = impl
    if impl == "auto":
        resolved = "pallas" if qkv.device.type == "cuda" else "xla"
    if resolved == "pallas" and fits_single_block(s):
        return fused_mha(qkv.contiguous(), heads=heads, scale=scale,
                         kv_len=kv_len, dropout_rate=dropout_rate,
                         seed=rng.block_seed() if dropout_rate > 0.0
                         else None)
    split = qkv.reshape(b, s, 3, heads, d)
    q, k, v = (split[:, :, i].transpose(1, 2) for i in range(3))
    out = scaled_dot_product_attention(
        q, k, v, scale=scale, impl=impl, kv_len=kv_len,
        dropout_rate=dropout_rate, rng=rng)
    return out.transpose(1, 2).reshape(b, s, heads * d)
