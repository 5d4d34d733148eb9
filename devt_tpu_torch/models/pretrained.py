"""Frozen expert feature extractors for offline embedding extraction:
port of ``devt_tpu/models/pretrained.py``.

One frozen backbone a modality, its classifier removed:

  * ``image``    — ResNet-50 → 2048-d
  * ``video``    — R3D-18 → 512-d
  * ``location`` — ResNet-50 → 2048-d

Weights are drawn from a seeded ``torch.Generator`` with flax's
initializers (the reference downloads model-zoo weights; nothing here
does); ``load_torch_state_dict`` installs other weights, such as the
JAX package's carried over by ``utils.jax_bridge``.  The backbones run in
evaluation (BatchNorm on its running statistics) without gradient, on
the card unless ``device="cpu"`` is passed.  ``return_expert_for_key``
pools the per-frame or per-clip embeddings into one vector by adaptive
average pooling over the batch axis.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from devt_tpu_torch.models.contrastive import adaptive_avg_pool_1d
from devt_tpu_torch.models.layers import init_weights
from devt_tpu_torch.models.r2plus1d import r3d_18
from devt_tpu_torch.models.resnet import resnet50

EXPERT_DIMS = {"image": 2048, "video": 512, "location": 2048}


class EmbeddingExtractor:
    """The frozen expert models, by modality, on one device."""

    def __init__(self, seed: int | None = 0,
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device | None = None):
        """``seed``: the weights' generator seed; None leaves them
        undrawn, for a caller that loads its own."""
        from devt_tpu_torch.serve import resolve_device

        self.device = resolve_device(device)
        self.models = {
            "image": resnet50(output="features", dtype=dtype),
            "video": r3d_18(output="features", dtype=dtype),
            "location": resnet50(output="features", dtype=dtype),
        }
        if seed is not None:
            generator = torch.Generator().manual_seed(seed)
            for model in self.models.values():
                init_weights(model, generator)
        for model in self.models.values():
            model.to(self.device).eval().requires_grad_(False)

    def load_torch_state_dict(self, name: str,
                              state_dict: Mapping[str, torch.Tensor]
                              ) -> None:
        """Install one modality's weights (the port's names)."""
        self.models[name].load_state_dict(state_dict)

    def _run(self, name: str, x) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(self.device, torch.float32)
        with torch.inference_mode():
            return self.models[name](x, train=False)

    def forward_img(self, frames) -> torch.Tensor:
        """(N, 224, 224, 3) frames → (N, 2048)."""
        return self._run("image", frames)

    def forward_location(self, frames) -> torch.Tensor:
        return self._run("location", frames)

    def forward_video(self, clip) -> torch.Tensor:
        """(N, T, 112, 112, 3) clips → (N, 512)."""
        return self._run("video", clip)

    def return_expert_for_key(self, key: str, data) -> torch.Tensor:
        """Run the expert and pool its N frame- or clip-level embeddings
        into one vector (D,)."""
        if key in ("img-embeddings", "image", "location-embeddings",
                   "location"):
            fwd = self.forward_location if "location" in key else \
                self.forward_img
            emb = fwd(data)
        elif key in ("video-embeddings", "video"):
            emb = self.forward_video(data)
        else:
            raise KeyError(f"unknown expert key {key!r}")
        return adaptive_avg_pool_1d(emb.T, 1)[:, 0]
