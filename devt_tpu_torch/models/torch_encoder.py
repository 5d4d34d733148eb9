"""Transformer encoder with torch ``nn.TransformerEncoder`` semantics.

Port of ``devt_tpu/models/torch_encoder.py``: post-norm residual blocks
with a ReLU feed-forward and attention-probability dropout, batch-major.

    x = norm1(x + dropout(self_attn(x)))       # attn-prob dropout inside
    x = norm2(x + dropout(linear2(dropout(relu(linear1(x))))))

The modules are written out (not ``nn.TransformerEncoderLayer``) because
the softmax runs through the port's dispatching attention (the packed-qkv
kernel on the card) and the four Linear sites run int8 under
``ops.attention.quant_scope`` in eval mode.  Module names follow the flax
tree (``self_attn.in_proj``, ``self_attn.out_proj``, ``linear1``,
``linear2``, ``norm1``, ``norm2``, ``layers.<i>`` for ``layer_<i>``), so
``utils/jax_bridge.py`` maps one onto the other by name.

Inside ``ops.attention.tp_pallas_scope`` (a tensor-parallel step) a layer
whose heads and feed-forward width divide over the model axis runs as
one rank's slice of the Megatron layout: ``in_proj`` and ``linear1``
column-parallel, ``out_proj`` and ``linear2`` row-parallel with an
all-reduce, the attention on the rank's heads through the same
dispatching attention, on the parts of the weights and of the
column-parallel biases that the step hands it
(``parallel.sharding.tp_parts``).
"""

from __future__ import annotations

import torch
from torch import nn

import torch.nn.functional as F

from devt_tpu_torch.models.layers import (LN_EPS, DropoutRng, dense, dropout,
                                          layer_norm, remat, row_parallel,
                                          tp_dropout_rng)
from devt_tpu_torch.ops.attention import (active_tp_mesh, packed_mha,
                                          quant_active, quant_site_allowed)
from devt_tpu_torch.ops.quant import int8_dot_general
from devt_tpu_torch.parallel.collectives import copy_to
from devt_tpu_torch.parallel.mesh import MODEL_AXIS


def site_dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype,
               quant: bool) -> torch.Tensor:
    """``dense`` for one of the four big Linear sites.  With ``quant``, a
    site the scope's ``site_pred`` accepts runs its product through
    ``int8_dot_general`` (same parameters, the weight quantized at the
    site) and adds the bias in ``dtype``; a rejected site is the plain
    ``dense``."""
    if not quant or not quant_site_allowed(lin.in_features, lin.out_features):
        return dense(lin, x, dtype)
    return int8_dot_general(x.to(dtype), lin.weight.t()) + lin.bias.to(dtype)


class TorchMultiheadAttention(nn.Module):
    """Self-attention matching ``torch.nn.MultiheadAttention``: packed qkv
    projection with bias (torch's ``in_proj_weight``, (3E, E)), scaled by
    1/sqrt(head_dim), dropout on the softmax probabilities, biased output
    projection."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 attention_impl: str = "auto",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout = dropout
        self.attention_impl = attention_impl
        self.dtype = dtype
        self.in_proj = nn.Linear(embed_dim, 3 * embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor,
                rng: DropoutRng | None = None) -> torch.Tensor:
        quant = not self.training and quant_active()
        qkv = site_dense(self.in_proj, x, self.dtype, quant)
        use_drop = self.dropout > 0.0 and self.training
        if use_drop and rng is None:
            raise ValueError("a training forward with dropout needs rng=, a "
                             "DropoutRng (models/layers.py)")
        head_dim = self.embed_dim // self.num_heads
        out = packed_mha(qkv, heads=self.num_heads, scale=head_dim ** -0.5,
                         impl=self.attention_impl,
                         dropout_rate=self.dropout if use_drop else 0.0,
                         rng=rng if use_drop else None)
        return site_dense(self.out_proj, out, self.dtype, quant)


class TorchEncoderLayer(nn.Module):
    """Post-norm encoder layer = torch ``TransformerEncoderLayer``."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, attention_impl: str = "auto",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.dtype = dtype
        self.self_attn = TorchMultiheadAttention(d_model, nhead, dropout,
                                                 attention_impl, dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def tp_splits(self, n: int) -> bool:
        """Whether the layer runs on its own slices over a model axis of
        ``n`` ranks: its heads and feed-forward width divide."""
        return (n > 1 and self.self_attn.num_heads % n == 0
                and self.linear1.out_features % n == 0)

    def forward(self, x: torch.Tensor,
                rng: DropoutRng | None = None) -> torch.Tensor:
        tpm = active_tp_mesh()
        if tpm is not None and self.tp_splits(tpm.shape[MODEL_AXIS]):
            return self._tp_forward(x, rng, tpm.shape[MODEL_AXIS])
        rate, training = self.dropout, self.training
        attn = dropout(self.self_attn(x, rng), rate, training, rng)
        x = layer_norm(self.norm1, x + attn, self.dtype)
        quant = not training and quant_active()
        h = torch.relu(site_dense(self.linear1, x, self.dtype, quant))
        h = dropout(h, rate, training, rng)
        h = dropout(site_dense(self.linear2, h, self.dtype, quant), rate,
                    training, rng)
        return layer_norm(self.norm2, x + h, self.dtype)

    def _tp_forward(self, x: torch.Tensor, rng: DropoutRng | None,
                    n: int) -> torch.Tensor:
        """One rank's slice of the layer over a model axis of ``n``."""
        rate, training, dtype = self.dropout, self.training, self.dtype
        mha = self.self_attn
        e, f = mha.embed_dim, self.linear1.out_features
        use_drop = rate > 0.0 and training
        if use_drop and rng is None:
            raise ValueError("a training forward with dropout needs rng=, a "
                             "DropoutRng (models/layers.py)")
        # the attention's probabilities and the FFN hidden are split by
        # head and column: their masks come from the rank's own stream
        local_rng = tp_dropout_rng(rng, rate, training)
        if mha.in_proj.bias.shape[0] * n != 3 * e \
                or self.linear1.bias.shape[0] * n != f:
            raise ValueError(
                f"a tensor-parallel layer over {n} ranks takes its parts "
                f"(the step hands them: parallel.sharding.tp_parts); got "
                f"qkv rows {mha.in_proj.bias.shape[0]} of {3 * e}")
        h = copy_to(x, MODEL_AXIS).to(dtype)
        qkv = F.linear(h, mha.in_proj.weight.to(dtype),
                       mha.in_proj.bias.to(dtype))
        out = packed_mha(qkv, heads=mha.num_heads // n,
                         scale=(e // mha.num_heads) ** -0.5,
                         impl=mha.attention_impl,
                         dropout_rate=rate if use_drop else 0.0,
                         rng=local_rng if use_drop else None)
        attn = row_parallel(out, mha.out_proj.weight, mha.out_proj.bias,
                            dtype)
        x = layer_norm(self.norm1, x + dropout(attn, rate, training, rng),
                       dtype)
        h = copy_to(x, MODEL_AXIS).to(dtype)
        h = torch.relu(F.linear(h, self.linear1.weight.to(dtype),
                                self.linear1.bias.to(dtype)))
        h = dropout(h, rate, training, local_rng)
        h = row_parallel(h, self.linear2.weight, self.linear2.bias, dtype)
        return layer_norm(self.norm2, x + dropout(h, rate, training, rng),
                          dtype)


class TorchTransformerEncoder(nn.Module):
    """Stack of ``TorchEncoderLayer`` (= torch ``TransformerEncoder``):
    independent weights per layer, no final norm.  Input and output are
    batch-major (B, S, D).  ``remat=True`` rematerialises each layer in a
    training forward that needs a gradient (``models.layers.remat``, which
    replays the layer's dropout draws), as the JAX module's ``nn.remat``
    does per layer."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 num_layers: int, dropout: float = 0.1,
                 attention_impl: str = "auto", remat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            TorchEncoderLayer(d_model, nhead, dim_feedforward, dropout,
                              attention_impl, dtype)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor,
                rng: DropoutRng | None = None) -> torch.Tensor:
        rematerialise = self.remat and self.training \
            and torch.is_grad_enabled()
        for layer in self.layers:
            if rematerialise:
                x = remat(layer, lambda h, r, first: (h, r), x, rng)
            else:
                x = layer(x, rng)
        return x
