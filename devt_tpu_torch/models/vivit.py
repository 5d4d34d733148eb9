"""ViViT — factorized space-time vision transformer.

Port of ``devt_tpu/models/vivit.py`` (reference: src/models/vit.py:79-128):
a linear patch embedding over per-frame patches, a per-frame space CLS
token and a learned (1, frames, patches+1, dim) position embedding, a
*space* transformer over each frame's tokens with the frames folded into
the batch (tokens padded to a multiple of ``token_pad``, the pad masked
out of attention by ``kv_len``), a *temporal* transformer over the
per-frame CLS outputs with a temporal CLS token, and 'cls' or 'mean'
pooling into a LayerNorm+Linear head.

The patch embedding is a reshape and one product with the (p*p*c, dim)
kernel, stored in Linear layout (dim, p*p*c); the JAX package leaves it
to XLA, outside any kernel, so here it is ``F.linear``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from devt_tpu_torch.models.layers import (LN_EPS, DropoutRng,
                                          ViTTransformer, dense, dropout,
                                          init_weights, layer_norm,
                                          lecun_normal_)


def _pad_tokens(x: torch.Tensor, mult: int) -> tuple[torch.Tensor, int]:
    """Zero-pad the token axis of (B, N, D) to a multiple of ``mult``;
    returns the padded tensor and the true length N."""
    n = x.shape[1]
    target = ((n + mult - 1) // mult) * mult
    if target == n:
        return x, n
    return F.pad(x, (0, 0, 0, target - n)), n


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, T, H, W, C) channels-last pixels → (B, T, N, p*p*c) tokens,
    feature order (p1, p2, c) — the layout ``PatchEmbed`` expects."""
    b, t, h, w, c = x.shape
    p = patch_size
    x = x.reshape(b, t, h // p, p, w // p, p, c).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, t, (h // p) * (w // p), p * p * c)


class PatchEmbed(nn.Module):
    """Linear patch embedding; weight (dim, p*p*c), features (p1, p2, c)."""

    def __init__(self, patch_size: int, in_channels: int, dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(dim, patch_size * patch_size * in_channels))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, tokens: bool = False) -> torch.Tensor:
        """(B, T, H, W, C) → (B, T, H/p·W/p, dim); with ``tokens=True``
        pre-patchified (..., N, p*p*c) → (..., N, dim)."""
        if not tokens:
            x = patchify(x, self.patch_size)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class ViViT(nn.Module):
    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 num_classes: int = 100, num_frames: int = 16,
                 dim: int = 192, depth: int = 4, heads: int = 3,
                 pool: str = "cls", in_channels: int = 3,
                 dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, scale_dim: int = 4,
                 attention_impl: str = "auto",
                 temporal_attention_impl: str | None = "xla",
                 token_pad: int = 16, channels_last: bool = False,
                 remat: bool = False, moe_experts: int = 0,
                 moe_every: int = 2, moe_capacity_factor: float = 1.25,
                 pipeline_stages: int = 0, pipeline_microbatches: int = 0,
                 sequence_parallel: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if pool not in ("cls", "mean"):
            raise ValueError("pool type must be either cls (cls token) or "
                             "mean (mean pooling)")
        if image_size % patch_size:
            raise ValueError("Image dimensions must be divisible by the "
                             "patch size.")
        num_patches = (image_size // patch_size) ** 2
        self.dim, self.pool = dim, pool
        self.token_pad = token_pad
        self.channels_last = channels_last
        self.dtype = dtype
        # moe_experts > 0: every moe_every-th SPACE block's FFN is a switch
        # MoE (models/layers.py:MoEViTBlock); the temporal transformer
        # stays dense, its token count being tiny
        self.moe_experts = moe_experts
        self.patch_embed = PatchEmbed(patch_size, in_channels, dim, dtype)
        self.pos_embedding = nn.Parameter(
            torch.empty(1, num_frames, num_patches + 1, dim))
        self.space_token = nn.Parameter(torch.empty(1, 1, dim))
        self.temporal_token = nn.Parameter(torch.empty(1, 1, dim))
        # pipeline_stages > 1 / sequence_parallel (config.pp, config.sp):
        # the space transformer's blocks take the stacked pb_* layout and
        # run pipelined or sequence-parallel on a pipe or seq mesh; the
        # temporal transformer keeps the per-block layout, sequential
        self.space_transformer = ViTTransformer(
            dim, depth, heads, dim_head, dim * scale_dim, dropout=dropout,
            attention_impl=attention_impl, remat=remat,
            moe_experts=moe_experts, moe_every=moe_every,
            moe_capacity_factor=moe_capacity_factor,
            pipeline_stages=pipeline_stages,
            pipeline_microbatches=pipeline_microbatches,
            sequence_parallel=sequence_parallel, dtype=dtype)
        t_impl = (attention_impl if temporal_attention_impl is None
                  else temporal_attention_impl)
        self.temporal_transformer = ViTTransformer(
            dim, depth, heads, dim_head, dim * scale_dim, dropout=dropout,
            attention_impl=t_impl, remat=remat, dtype=dtype)
        self.emb_dropout = emb_dropout
        self.head_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.head = nn.Linear(dim, num_classes)

    def init_weights(self, generator: torch.Generator) -> "ViViT":
        """flax's initializers: lecun-normal kernels, zero biases, unit LN
        scales, unit normal position embedding and CLS tokens."""
        init_weights(self, generator)
        w = self.patch_embed.weight
        lecun_normal_(w, w.shape[1], generator)
        nn.init.zeros_(self.patch_embed.bias)
        for p in (self.pos_embedding, self.space_token, self.temporal_token):
            nn.init.normal_(p, 0.0, 1.0, generator=generator)
        return self

    def forward(self, x: torch.Tensor, tokens_in: bool = False,
                rng: DropoutRng | None = None,
                losses: list | None = None) -> torch.Tensor:
        """x: (B, T, C, H, W) — or (B, T, H, W, C) with ``channels_last`` —
        → (B, num_classes) logits.  ``tokens_in=True``: x is pre-patchified
        (B, T, N, p*p*c) tokens (``patchify`` layout).  ``rng``: the
        dropout randomness of a training forward (needed only when a
        dropout rate is set).  ``losses``: a list the MoE blocks append
        their load-balance losses to (None: not collected)."""
        dtype = self.dtype
        if not tokens_in and not self.channels_last:
            x = x.permute(0, 1, 3, 4, 2)            # → (B, T, H, W, C)
        b, t = x.shape[:2]
        x = self.patch_embed(x, tokens=tokens_in)
        n, d = x.shape[2], x.shape[3]

        cls_space = self.space_token.to(dtype).expand(b, t, 1, d)
        x = torch.cat([cls_space, x], dim=2)      # (b, t, n+1, d)
        x = x + self.pos_embedding[:, :, :n + 1].to(dtype)
        x = dropout(x, self.emb_dropout, self.training, rng)

        # space attention, frames folded into the batch, tokens tile-padded
        x = x.reshape(b * t, n + 1, d)
        kv_len = None
        if self.token_pad:
            x, kv_len = _pad_tokens(x, self.token_pad)
        x = self.space_transformer(x, kv_len, rng, losses)
        x = x[:, 0].reshape(b, t, d)                # per-frame CLS

        cls_temporal = self.temporal_token.to(dtype).expand(b, 1, d)
        x = torch.cat([cls_temporal, x], dim=1)     # (b, t+1, d)
        kv_len = None
        if self.token_pad:
            x, kv_len = _pad_tokens(x, self.token_pad)
        x = self.temporal_transformer(x, kv_len, rng)
        x = x[:, :t + 1]                            # drop pad rows

        x = x.mean(dim=1) if self.pool == "mean" else x[:, 0]
        return dense(self.head, layer_norm(self.head_norm, x, dtype), dtype)
