"""The LSTM baseline over expert sequences: port of
``devt_tpu/models/lstm.py``.

A stack of LSTM layers (4608 → 512, four of them in the registry) with
dropout between layers, and a Linear(hidden, classes) head on the last
step's hidden state; the training step applies sigmoid and BCE.

Each layer is flax's ``OptimizedLSTMCell`` run over time, written out:
gates i, f, g, o from input kernels without bias and hidden kernels with
bias, zero initial carry.  The input projection of the whole sequence is
one product; each step then runs one (B, H) × (H, 4H) product and the
gates.  The dtype flow is flax's: the products and gates in ``dtype``, the
carry (c, h) in f32 (the parameters' type), since ``f * c`` and ``o *
tanh(c)`` promote, so in bf16 the layer's output sequence is f32 and is
cast to bf16 again at the next product.

Names: the layer ``cells.<i>`` holds ``weight_ih`` (4H, in) and
``weight_hh`` (4H, H), the gate kernels stacked in i, f, g, o order, and
``bias_hh`` (4H); ``utils/jax_bridge.py`` maps them onto flax's
``OptimizedLSTMCell_<i>`` with its ``ii``…``io`` and ``hi``…``ho`` leaves.
"""

from __future__ import annotations

import torch
from torch import nn

from devt_tpu_torch.models.layers import (DropoutRng, dense, dropout,
                                          init_weights, lecun_normal_)


class LSTMCell(nn.Module):
    """One layer: flax's ``OptimizedLSTMCell`` scanned over the sequence."""

    def __init__(self, input_size: int, hidden_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_size, self.dtype = hidden_size, dtype
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden_size,
                                                  input_size))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden_size,
                                                  hidden_size))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden_size))

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's: input kernels lecun-normal, each hidden gate kernel
        orthogonal, zero biases."""
        with torch.no_grad():
            lecun_normal_(self.weight_ih, self.weight_ih.shape[1], generator)
            for block in self.weight_hh.view(4, self.hidden_size, -1):
                nn.init.orthogonal_(block, generator=generator)
            nn.init.zeros_(self.bias_hh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, in) → (B, S, H), the hidden state of every step."""
        dt = self.dtype
        carry = torch.promote_types(dt, torch.float32)
        b, s = x.shape[:2]
        xi = torch.matmul(x.to(dt), self.weight_ih.to(dt).T)  # (B, S, 4H)
        wh = self.weight_hh.to(dt).T
        bh = self.bias_hh.to(dt)
        c = torch.zeros(b, self.hidden_size, dtype=carry, device=x.device)
        h = torch.zeros_like(c)
        out = []
        for t in range(s):
            # the hidden product and its bias, then the input's, each
            # rounded to dtype as flax adds them
            z = (torch.matmul(h.to(dt), wh) + bh) + xi[:, t]
            i, f, g, o = z.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, dim=1)


class LSTMRegressor(nn.Module):
    def __init__(self, n_features: int = 4608, hidden_size: int = 512,
                 num_layers: int = 4, n_classes: int = 15,
                 dropout: float = 0.2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout, self.dtype = dropout, dtype
        self.cells = nn.ModuleList(
            LSTMCell(n_features if i == 0 else hidden_size, hidden_size,
                     dtype) for i in range(num_layers))
        self.linear = nn.Linear(hidden_size, n_classes)

    def init_weights(self, generator: torch.Generator) -> "LSTMRegressor":
        init_weights(self, generator)
        for cell in self.cells:
            cell.init_weights(generator)
        return self

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: DropoutRng | None = None) -> torch.Tensor:
        """x: (B, S, n_features) → (B, n_classes) logits."""
        x = x.to(self.dtype)
        for i, cell in enumerate(self.cells):
            x = cell(x)
            # torch's nn.LSTM drops every layer's output but the last
            if i < len(self.cells) - 1:
                x = dropout(x, self.dropout, train, rng)
        return dense(self.linear, x[:, -1], self.dtype)
