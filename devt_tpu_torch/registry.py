"""Model construction by config string: port of ``devt_tpu/registry.py``.

Every name the JAX registry builds: ``ptn`` and ``ptn_shared``, ``lstm``
(with the reference's hard-coded sizes), the FrameTransformer variants
(``vid``, ``frame``, ``distil``, ``sum``, ``post_sum``, ``sum_residual``,
``pre_modal``, ``frame_transformer``), ``vivit``, ``tpn``, ``contrastive``
and ``basicmlp``, each with the JAX registry's arguments.  A name the JAX
registry does not know raises ``ValueError``, as there.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from devt_tpu_torch.config import Config
from devt_tpu_torch.models.basicmlp import BasicMLP
from devt_tpu_torch.models.contrastive import ContrastiveEncoder
from devt_tpu_torch.models.frame_transformer import VARIANTS as FT_VARIANTS
from devt_tpu_torch.models.frame_transformer import FrameTransformer
from devt_tpu_torch.models.lstm import LSTMRegressor
from devt_tpu_torch.models.ptn import PTN
from devt_tpu_torch.models.tpn import TPN
from devt_tpu_torch.models.vivit import ViViT

# every name the JAX registry builds (devt_tpu/registry.py build_model)
KNOWN_MODELS = ("ptn", "ptn_shared", "lstm") + FT_VARIANTS + (
    "vivit", "tpn", "contrastive", "basicmlp")
# TPN's frames a sample: its Reasoning's widths are built for this T
TPN_FRAMES = 20


def _check_known(name: str) -> None:
    if name not in KNOWN_MODELS:
        raise ValueError(f"unknown model {name!r}; expected one of "
                         f"{', '.join(KNOWN_MODELS)}")


def model_dtype(config: Config) -> torch.dtype:
    return torch.bfloat16 if config.precision == "bf16" else torch.float32


def build_model(config: Config,
                generator: torch.Generator | None = None) -> nn.Module:
    """The model ``config.model`` names, on the CPU, with weights drawn
    from ``generator`` (default: one seeded with ``config.seed``)."""
    _check_known(config.model)
    if generator is None:
        generator = torch.Generator().manual_seed(config.seed)
    dtype = model_dtype(config)
    if config.model == "lstm":
        # hard-coded at the reference's dispatch site, as in the JAX registry
        return LSTMRegressor(n_features=4608, hidden_size=512, num_layers=4,
                             n_classes=15, dropout=0.2,
                             dtype=dtype).init_weights(generator)
    if config.model == "tpn":
        return TPN(num_class=config.n_classes,
                   dtype=dtype).init_weights(generator)
    if config.model == "contrastive":
        return ContrastiveEncoder(input_shape=config.input_shape,
                                  hidden_layer=config.hidden_layer,
                                  projection_size=config.projection_size,
                                  output_shape=config.output_shape,
                                  dtype=dtype).init_weights(generator)
    if config.model == "basicmlp":
        return BasicMLP(input_shape=config.input_shape,
                        n_classes=config.token_embedding,
                        dtype=dtype).init_weights(generator)
    if config.model in ("ptn", "ptn_shared"):
        return PTN(input_dimension=config.input_dimension,
                   nhead=config.nhead, nhid=config.nhid,
                   nlayers=config.nlayers, num_experts=len(config.experts),
                   seq_len=config.seq_len, n_classes=config.n_classes,
                   dropout=config.dropout,
                   shared=config.model == "ptn_shared",
                   attention_impl=config.attention_impl, remat=config.remat,
                   dtype=dtype).init_weights(generator)
    if config.model in FT_VARIANTS:
        # dropout stays the model's 0.5, as the JAX registry passes none
        return FrameTransformer(model=config.model, seq_len=config.seq_len,
                                frame_len=config.frame_len,
                                n_classes=config.n_classes,
                                use_cls=bool(config.cls),
                                attention_impl=config.attention_impl,
                                remat=config.remat, dtype=dtype
                                ).init_weights(generator)
    # channels-last is what the frame pipeline emits, as in the JAX registry
    model = ViViT(num_classes=config.n_classes,
                  num_frames=config.frame_len,
                  attention_impl=config.attention_impl,
                  channels_last=True,
                  moe_experts=config.moe_experts,
                  moe_every=config.moe_every,
                  moe_capacity_factor=config.moe_capacity_factor,
                  pipeline_stages=config.pp if config.pp > 1 else 0,
                  pipeline_microbatches=config.pp_microbatches,
                  sequence_parallel=config.sp > 1,
                  remat=config.remat, dtype=dtype)
    return model.init_weights(generator)


def example_batch(config: Config,
                  batch_size: int | None = None) -> dict[str, Any]:
    """Synthetic numpy batch with the right shapes for ``config.model``
    (channels-last), drawn like the JAX registry's."""
    _check_known(config.model)
    rng = np.random.default_rng(config.seed)
    b = batch_size or config.batch_size
    s, f, n = config.seq_len, config.frame_len, config.n_classes

    def multi_hot():
        lab = (rng.random((b, n)) < 0.2).astype(np.float32)
        lab[:, 5] = 1.0     # Drama fallback keeps rows non-empty
        return lab

    name = config.model
    if name in ("ptn", "ptn_shared"):
        return {"experts": rng.standard_normal(
                    (b, config.seq_len, len(config.experts),
                     config.input_dimension), dtype=np.float32),
                "label": multi_hot()}
    if name == "lstm":
        return {"experts": rng.standard_normal((b, s, 4608),
                                               dtype=np.float32),
                "label": multi_hot()}
    if name == "tpn":
        return {"img": rng.standard_normal((b, TPN_FRAMES, 224, 224, 3),
                                           dtype=np.float32),
                "label": multi_hot()}
    if name == "contrastive":
        return {"x_i": rng.standard_normal((b, config.input_shape),
                                           dtype=np.float32),
                "x_j": rng.standard_normal((b, config.input_shape),
                                           dtype=np.float32),
                "label": multi_hot()}
    if name == "basicmlp":
        return {"experts": rng.standard_normal((b, config.input_shape),
                                               dtype=np.float32),
                "label": rng.integers(0, config.token_embedding, (b,))}
    if name in FT_VARIANTS:
        return {"img": rng.standard_normal((b, s, 224, 224, 3),
                                           dtype=np.float32),
                "vid": rng.standard_normal((b, s, f, 112, 112, 3),
                                           dtype=np.float32),
                "label": multi_hot()}
    if config.wire_format == "u8_tokens":
        return {"vid_tokens": rng.integers(0, 256, (b, f, 196, 768),
                                           dtype=np.uint8),
                "label": multi_hot()}
    return {"vid": rng.standard_normal((b, f, 224, 224, 3),
                                       dtype=np.float32),
            "label": multi_hot()}
