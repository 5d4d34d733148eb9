"""Model construction by config string: port of ``devt_tpu/registry.py``.

Only ``vivit`` is ported; the other names of the model family raise
``NotImplementedError`` until their slice lands (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from devt_tpu_torch.config import Config
from devt_tpu_torch.models.vivit import ViViT


def model_dtype(config: Config) -> torch.dtype:
    return torch.bfloat16 if config.precision == "bf16" else torch.float32


def build_model(config: Config,
                generator: torch.Generator | None = None) -> nn.Module:
    """The model ``config.model`` names, on the CPU, with weights drawn
    from ``generator`` (default: one seeded with ``config.seed``)."""
    if config.model != "vivit":
        raise NotImplementedError(
            f"model {config.model!r} is not ported yet — ROADMAP.md queue 1 "
            f"(only 'vivit' is)")
    # channels-last is what the frame pipeline emits, as in the JAX registry
    model = ViViT(num_classes=config.n_classes,
                  num_frames=config.frame_len,
                  attention_impl=config.attention_impl,
                  channels_last=True,
                  moe_experts=config.moe_experts,
                  pipeline_stages=config.pp if config.pp > 1 else 0,
                  sequence_parallel=config.sp > 1,
                  remat=config.remat, dtype=model_dtype(config))
    if generator is None:
        generator = torch.Generator().manual_seed(config.seed)
    return model.init_weights(generator)


def example_batch(config: Config,
                  batch_size: int | None = None) -> dict[str, Any]:
    """Synthetic numpy batch with the right shapes for ``config.model``
    (channels-last), drawn like the JAX registry's."""
    if config.model != "vivit":
        raise NotImplementedError(
            f"model {config.model!r} is not ported yet — ROADMAP.md queue 1")
    rng = np.random.default_rng(config.seed)
    b = batch_size or config.batch_size
    f, n = config.frame_len, config.n_classes

    def multi_hot():
        lab = (rng.random((b, n)) < 0.2).astype(np.float32)
        lab[:, 5] = 1.0     # Drama fallback keeps rows non-empty
        return lab

    if config.wire_format == "u8_tokens":
        return {"vid_tokens": rng.integers(0, 256, (b, f, 196, 768),
                                           dtype=np.uint8),
                "label": multi_hot()}
    return {"vid": rng.standard_normal((b, f, 224, 224, 3),
                                       dtype=np.float32),
            "label": multi_hot()}
