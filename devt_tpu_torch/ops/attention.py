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
                   ``fused_mha`` (the packed-qkv kernels 3 and 4, with the
                   attention-probability dropout inside them) for
                   single-kv-block sequences, and splits the heads for
                   ``scaled_dot_product_attention`` above one kv block.
                   ``scaled_dot_product_attention`` reaches
                   ``flash_attention`` (``ops/flash_attention.py``: kernels
                   9 and 10 for one kv block, kernel 11 beyond with kernels
                   12 and 13 for its backward); it has no dropout, and with
                   dropout it raises, as JAX's does.  CPU tensors run the
                   kernels' plain versions.
  * ``"auto"``   — in ``packed_mha``: ``"pallas"`` for CUDA tensors,
                   training and serving alike, the plain attention for CPU
                   tensors.  In ``scaled_dot_product_attention``: the
                   kernels for CUDA tensors without dropout; with dropout,
                   and for CPU tensors, the plain attention
                   (``devt_tpu/ops/attention.py:155-180``).
  * ``"fused_interpret"`` — the JAX package's CPU-interpreter switch for the
                   fused block; where it reaches this module it means the
                   plain attention.

``quant_scope`` marks a forward as int8 serving: ``models/layers.ViTBlock``
and the Linear sites of ``models/torch_encoder.py`` read it.
``tp_pallas_scope`` marks a forward as one rank's slice of a tensor-parallel
step: the transformer blocks read it (``active_tp_mesh``).  The scopes are
re-entrant, thread-local context managers; they work eagerly as JAX's do
at trace time.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from devt_tpu_torch.ops.flash_attention import (NEG_INF, fits_single_block,
                                                flash_attention, fused_mha)

_IMPLS = ("auto", "xla", "pallas", "fused_interpret")

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


@contextlib.contextmanager
def tp_pallas_scope(mesh):
    """Inside the scope, the transformer blocks run as one rank's slice of
    the Megatron layout over ``mesh``'s ``model`` axis: an eligible ViT
    block as ``parallel/tp_block.py``'s block (kernel 3 on the rank's local
    heads), the other blocks whose heads divide over the axis on
    column- and row-parallel products.  The tensor-parallel step executors
    (``parallel/train_step.py``, strategy ``gspmd``) set it around each step
    when the mesh has a model axis of more than one rank and
    ``attention_impl`` is ``"auto"``, as JAX's do around their trace.
    Re-entrant, thread-local, bounded by the ``with``."""
    prev = getattr(_gate, "tp_mesh", None)
    _gate.tp_mesh = mesh
    try:
        yield
    finally:
        _gate.tp_mesh = prev


def active_tp_mesh():
    """The mesh set by :func:`tp_pallas_scope`, or None."""
    return getattr(_gate, "tp_mesh", None)


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


def resolve_sdpa_impl(impl: str, device_type: str, dropout: bool) -> str:
    """What ``scaled_dot_product_attention`` runs: ``"kernels"`` (the
    flash kernels on CUDA tensors, their plain versions on CPU tensors) or
    ``"plain"`` (the materialised attention).  JAX's rule
    (``devt_tpu/ops/attention.py:164-172``), with "on the card" for its
    TPU gate: ``"auto"`` takes the kernels only on the card and without
    dropout; ``"pallas"`` with dropout raises ``NotImplementedError``."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "auto":
        impl = "pallas" if device_type == "cuda" and not dropout else "xla"
    if impl == "pallas":
        if dropout:
            raise NotImplementedError(
                "attention-weight dropout is served by the xla impl; use "
                "impl='xla' or 'auto' when training with attn dropout")
        return "kernels"
    return "plain"


def scaled_dot_product_attention(q, k, v, *, scale: float | None = None,
                                 impl: str = "auto",
                                 kv_len: int | None = None,
                                 dropout_rate: float = 0.0,
                                 rng=None) -> torch.Tensor:
    """Dispatching attention on split heads.  q, k, v: (B, H, S, D) →
    (B, H, Sq, D); ``resolve_sdpa_impl`` picks the path.  The kernels are
    ``flash_attention``'s; dropout (``dropout_rate > 0`` with a ``rng``)
    runs only on the plain attention."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    use_dropout = dropout_rate > 0.0 and rng is not None
    if resolve_sdpa_impl(impl, q.device.type, use_dropout) == "kernels":
        return flash_attention(q, k, v, scale=scale, kv_len=kv_len)
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
    Longer sequences, ``"xla"``, and ``"auto"`` on CPU tensors split the
    heads for ``scaled_dot_product_attention`` (on the card above one kv
    block: kernel 11, or with dropout the plain attention).
    ``dropout_rate > 0`` needs a ``rng`` (``models.layers.DropoutRng``)."""
    if impl not in _IMPLS:
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
