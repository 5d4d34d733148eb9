"""Frame/clip transformer with multi-modal distillation: port of
``devt_tpu/models/frame_transformer.py``.

The reference's primary model, dispatching on the ``model`` string:

  * ``vid``: clips only.  R(2+1)D-18 per scene clip → ``vid_fc`` (896),
    a learned clip-shaped CLS clip prepended, sinusoidal PE, the 4-layer,
    2-head ``distil_transformer``, its CLS through the MLP head.
  * ``frame`` / ``frame_transformer``: frames only.  The frozen ResNet-18
    per frame → ``img_fc``, an image-shaped CLS image, PE, the 4-layer,
    4-head ``scene_transformer``, its CLS through the head.
  * ``distil``: the video CLS embedding appended as a token to the frame
    sequence; the student's distil-token logits train against the argmax
    of the teacher's (video) logits, beside BCE on the frame CLS logits.
  * ``sum``: frame CLS + distil token; ``post_sum``: frame CLS + video
    CLS; ``sum_residual``: each L2-normalised once, then summed; each
    through the head.
  * ``pre_modal``: per-clip video features added to the per-frame image
    features before the scene transformer.

Layouts are the JAX package's channels-last ``img (B, S, H, W, C)`` and
``vid (B, S, T, H, W, C)``.  The image backbone always runs its
BatchNorms on their running averages (``train=False``), and with
``freeze_img`` under ``no_grad``: its features, after ``img_fc``, carry no
gradient, as the JAX package's ``stop_gradient`` leaves them.  The video
backbone normalises by batch statistics when training and hands its new
running statistics to ``models.resnet.collect_batch_stats``.

The two encoders' attention is the port's packed-qkv attention: on the
card ``fused_mha`` (kernels 3 and 4) at head dim 448 (``distil_
transformer``, 896 / 2) and 224 (``scene_transformer``, 896 / 4), 14 or 15
tokens, with the attention-probability dropout inside the kernels.

A flax module creates a submodule's parameters only when a variant calls
it; the port builds exactly the modules of that variant's tree (``vid``
has no image backbone and no scene transformer, ``frame`` no video side,
``pre_modal`` no distil transformer), while ``vid_cls`` and ``img_cls``
exist in every variant, as ``setup`` creates them.  Names follow the flax
tree, for ``utils/jax_bridge.py``.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from devt_tpu_torch.models.layers import (DropoutRng, GeluMlp,
                                          PositionalEncoding, dense,
                                          init_weights)
from devt_tpu_torch.models.r2plus1d import r2plus1d_18
from devt_tpu_torch.models.resnet import resnet18
from devt_tpu_torch.models.torch_encoder import TorchTransformerEncoder

VARIANTS = ("vid", "frame", "distil", "sum", "post_sum", "sum_residual",
            "pre_modal", "frame_transformer")
_FRAME_ONLY = ("frame", "frame_transformer")


class FrameTransformer(nn.Module):
    def __init__(self, model: str = "vid", seq_len: int = 13,
                 frame_len: int = 12, n_classes: int = 19,
                 embed_dim: int = 896, use_cls: bool = True,
                 freeze_img: bool = True, img_size: int = 224,
                 vid_size: int = 112, dropout: float = 0.5,
                 attention_impl: str = "auto", remat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if model not in VARIANTS:
            raise ValueError(f"unknown variant {model!r}")
        self.model, self.use_cls, self.freeze_img = model, use_cls, freeze_img
        self.dtype = dtype
        e = embed_dim
        if model not in _FRAME_ONLY:                      # the video side
            self.vid_backbone = r2plus1d_18(output="features", dtype=dtype)
            self.vid_fc = nn.Linear(512, e)
        if model != "vid":                                # the image side
            self.img_backbone = resnet18(output="features", dtype=dtype)
            self.img_fc = nn.Linear(512, e)
        max_len = seq_len + (1 if use_cls else 0)
        # PositionalEncoding(896, 0.5, max_len=14), one more slot for the
        # trailing distil token
        self.position_encoder = PositionalEncoding(e, dropout=dropout,
                                                   max_len=max_len + 1)
        enc = dict(dropout=dropout, attention_impl=attention_impl,
                   remat=remat, dtype=dtype)
        if model not in _FRAME_ONLY + ("pre_modal",):
            self.distil_transformer = TorchTransformerEncoder(e, 2, 512, 4,
                                                              **enc)
        if model != "vid":
            self.scene_transformer = TorchTransformerEncoder(e, 4, 896, 4,
                                                             **enc)
        if use_cls:
            # learned clip-shaped and image-shaped CLS inputs, channels-last
            self.vid_cls = nn.Parameter(
                torch.empty(frame_len, vid_size, vid_size, 3))
            self.img_cls = nn.Parameter(torch.empty(img_size, img_size, 3))
        # 896 → 512 → 128 → n_classes with GELU
        self.img_mlp_head = GeluMlp(e, (512, 128, n_classes), dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> "FrameTransformer":
        """flax's initializers: lecun-normal Dense and Conv kernels, zero
        biases, unit LayerNorm and BatchNorm scales, running statistics
        (0, 1), the CLS inputs uniform in [0, 1)."""
        init_weights(self, generator)
        if self.use_cls:
            for p in (self.vid_cls, self.img_cls):
                nn.init.uniform_(p, 0.0, 1.0, generator=generator)
        return self

    # ------------------------------------------------------------------
    def _encode_clips(self, vid: torch.Tensor) -> torch.Tensor:
        """(B, S', T, H, W, C) → (B, S', 896) through the video backbone."""
        b, s = vid.shape[:2]
        flat = vid.reshape((b * s,) + tuple(vid.shape[2:]))
        feats = self.vid_backbone(flat.to(self.dtype), train=self.training)
        return dense(self.vid_fc, feats, self.dtype).reshape(b, s, -1)

    def _encode_frames(self, img: torch.Tensor) -> torch.Tensor:
        """(B, S', H, W, C) → (B, S', 896) through the image backbone, on
        its running statistics; with ``freeze_img`` without gradient."""
        b, s = img.shape[:2]
        flat = img.reshape((b * s,) + tuple(img.shape[2:]))
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.freeze_img):
            feats = self.img_backbone(flat.to(self.dtype), train=False)
            feats = dense(self.img_fc, feats, self.dtype)
        return feats.reshape(b, s, -1)

    def _prepend(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """``x`` with the CLS input ``name`` prepended (with ``use_cls``)."""
        if not self.use_cls:
            return x
        cls = getattr(self, name).to(x.dtype)
        cls = cls.expand((x.shape[0], 1) + tuple(cls.shape))
        return torch.cat([cls, x], dim=1)

    def vid_step(self, vid: torch.Tensor, rng: DropoutRng | None = None,
                 pooled: bool = True) -> torch.Tensor:
        """The video pathway: the video CLS embedding (B, 896), or with
        ``pooled=False`` the per-clip features before the transformer (the
        ``pre_modal`` tap)."""
        feats = self._encode_clips(self._prepend(vid, "vid_cls"))
        if not pooled:
            return feats
        h = self.position_encoder(feats, rng)
        return self.distil_transformer(h, rng)[:, 0]

    def img_step(self, img: torch.Tensor, inject: torch.Tensor | None = None,
                 rng: DropoutRng | None = None, inject_mode: str = "append"):
        """The image pathway: (CLS, tokens).  ``inject`` (B, 896) appended
        as a trailing token (``"append"``: distil, sum, post_sum), or
        (B, S', 896) added to the frame features (``"add"``: pre_modal)."""
        feats = self._encode_frames(self._prepend(img, "img_cls"))
        if inject is not None and inject_mode == "add":
            feats = feats + inject
        if inject is not None and inject_mode == "append":
            feats = torch.cat([feats, inject[:, None, :].to(feats.dtype)],
                              dim=1)
        h = self.position_encoder(feats, rng)
        h = self.scene_transformer(h, rng)
        return h[:, 0], h

    # ------------------------------------------------------------------
    def forward(self, img: torch.Tensor | None = None,
                vid: torch.Tensor | None = None,
                rng: DropoutRng | None = None) -> dict[str, Any]:
        """The variant's outputs: always ``logits`` and ``embedding``;
        ``distil`` adds ``distil_logits`` (student) and ``teacher_logits``.
        A training forward (``model.train()``) with dropout needs ``rng``."""
        m, head = self.model, self.img_mlp_head
        if m == "vid":
            vid_cls = self.vid_step(vid, rng)
            return {"logits": head(vid_cls), "embedding": vid_cls}
        if m in _FRAME_ONLY:
            cls, _ = self.img_step(img, rng=rng)
            return {"logits": head(cls), "embedding": cls}
        if m == "distil":
            vid_cls = self.vid_step(vid, rng)
            teacher_logits = head(vid_cls)
            cls, tokens = self.img_step(img, inject=vid_cls, rng=rng)
            return {"logits": head(cls), "distil_logits": head(tokens[:, -1]),
                    "teacher_logits": teacher_logits, "embedding": cls}
        if m == "sum":
            vid_cls = self.vid_step(vid, rng)
            cls, tokens = self.img_step(img, inject=vid_cls, rng=rng)
            embed = cls + tokens[:, -1]
            return {"logits": head(embed), "embedding": embed}
        if m == "post_sum":
            vid_cls = self.vid_step(vid, rng)
            cls, _ = self.img_step(img, inject=vid_cls, rng=rng)
            embed = cls + vid_cls
            return {"logits": head(embed), "embedding": embed}
        if m == "sum_residual":
            vid_cls = self.vid_step(vid, rng)
            cls, _ = self.img_step(img, rng=rng)

            def norm(x):
                return x / torch.clamp(
                    torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                    min=1e-8)

            embed = norm(cls) + norm(vid_cls)
            return {"logits": head(embed), "embedding": embed}
        # pre_modal
        clip_feats = self.vid_step(vid, rng, pooled=False)
        cls, _ = self.img_step(img, inject=clip_feats, rng=rng,
                               inject_mode="add")
        return {"logits": head(cls), "embedding": cls}
