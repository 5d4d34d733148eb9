"""Pyramid transformer network over multi-modal expert streams.

Port of ``devt_tpu/models/ptn.py`` (the reference's ``SimpleTransformer``,
models ``"ptn"`` and ``"ptn_shared"``):

  * input ``(batch, seq, experts, dim)``;
  * ``add_pos_cls``: CLS-token prepend → sinusoidal PE (base 1000.0) →
    LayerNorm, shared across experts;
  * ``ptn``: one torch-semantics transformer encoder per expert stream with
    separate weights, per-expert CLS extraction, CLS vectors summed across
    experts, LayerNorm + Linear head;
  * ``ptn_shared``: one shared encoder for all expert streams, then the
    stacked per-expert CLS sequence runs through the shared encoder again
    with its own CLS.

The CLS token is one ``(1, 1, dim)`` vector broadcast over the batch.
Module names follow the flax tree (``encoder_<i>`` / ``encoder_shared``,
``cls``, ``norm``, ``head_norm``, ``head``).
"""

from __future__ import annotations

import torch
from torch import nn

from devt_tpu_torch.models.layers import (LN_EPS, DropoutRng,
                                          PositionalEncoding, dense,
                                          init_weights, layer_norm)
from devt_tpu_torch.models.torch_encoder import TorchTransformerEncoder


class PTN(nn.Module):
    """Two-stage pyramid transformer (``model="ptn"`` / ``"ptn_shared"``)."""

    def __init__(self, input_dimension: int = 2048, nhead: int = 8,
                 nhid: int = 2048, nlayers: int = 8, num_experts: int = 3,
                 seq_len: int = 13, n_classes: int = 15, dropout: float = 0.5,
                 shared: bool = False, attention_impl: str = "auto",
                 remat: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = input_dimension
        self.num_experts, self.shared, self.dtype = num_experts, shared, dtype
        self.position_encoder = PositionalEncoding(d, dropout=dropout,
                                                   max_len=seq_len + 1)
        self.cls = nn.Parameter(torch.empty(1, 1, d))
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        names = (["encoder_shared"] if shared
                 else [f"encoder_{i}" for i in range(num_experts)])
        for name in names:
            setattr(self, name, TorchTransformerEncoder(
                d, nhead, nhid, nlayers, dropout=dropout,
                attention_impl=attention_impl, remat=remat, dtype=dtype))
        self.encoder_names = tuple(names)
        self.head_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.head = nn.Linear(d, n_classes)

    def init_weights(self, generator: torch.Generator) -> "PTN":
        """flax's initializers: lecun-normal kernels, zero biases, unit LN
        scales, the CLS token uniform in [0, 1)."""
        init_weights(self, generator)
        nn.init.uniform_(self.cls, 0.0, 1.0, generator=generator)
        return self

    def encoder(self, i: int) -> TorchTransformerEncoder:
        return getattr(self, self.encoder_names[0 if self.shared else i])

    def add_pos_cls(self, x: torch.Tensor,
                    rng: DropoutRng | None = None) -> torch.Tensor:
        """(B, S, D) → (B, S+1, D): CLS prepend, PE, LayerNorm."""
        cls = self.cls.to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
        x = self.position_encoder(torch.cat([cls, x], dim=1), rng)
        return layer_norm(self.norm, x, self.dtype)

    def forward(self, experts: torch.Tensor,
                rng: DropoutRng | None = None) -> torch.Tensor:
        """experts: (B, S, E, D) → (B, n_classes) logits."""
        e = experts.shape[2]
        if e != self.num_experts:
            raise ValueError(f"expected {self.num_experts} expert streams, "
                             f"got {e}")
        cls_list = []
        for i in range(e):
            h = self.add_pos_cls(experts[:, :, i, :], rng)
            cls_list.append(self.encoder(i)(h, rng)[:, 0])  # per-expert CLS
        stacked = torch.stack(cls_list, dim=1)              # (B, E, D)
        if self.shared:
            # second shared pass over the expert-CLS sequence
            h = self.add_pos_cls(stacked, rng)
            pooled = self.encoder(0)(h, rng)[:, 0]
        else:
            pooled = stacked.sum(dim=1)                     # sum expert CLS
        return dense(self.head, layer_norm(self.head_norm, pooled,
                                           self.dtype), self.dtype)
