"""Import reference Lightning checkpoints: the port's own copy of
``devt_tpu/utils/lightning_import.py``.

The reference restores with ``load_from_checkpoint`` on wandb-run paths
(src/main.py:89,111); its ``.ckpt`` payload is a dict with a
``state_dict`` whose keys follow the module tree of each LightningModule.
These converters map that tree onto the JAX package's flax variable
layout (``utils/torch_port.py``), which ``utils/jax_bridge.py:
jax_to_state_dict`` carries onto the port's ``state_dict``, so a user of
the reference brings trained weights across by the same maps as into the
JAX package (``serve.Predictor.from_lightning_checkpoint``).

Key maps (reference module tree → flax-layout variables):

FrameTransformer (src/models/frame_transformer.py:83-121):
  vid_model.backbone.*            → vid_backbone (torchvision r2plus1d_18)
  vid_model.backbone.fc.0         → vid_fc       (the Linear(512, 896))
  img_model.backbone.*            → img_backbone (torchvision resnet18)
  img_model.backbone.fc.0         → img_fc
  distil_transformer.transformer.layers.* → distil_transformer
  scene_transformer.transformer.layers.*  → scene_transformer
  img_mlp_head.{0,2,4}            → img_mlp_head.fc{0,1,2}
  vid_cls (1,12,3,112,112)        → vid_cls (12,112,112,3)  [layout]
  img_cls (1,3,224,224)           → img_cls (224,224,3)

SimpleTransformer (src/models/transformer.py:28-57):
  transformer_encoder{i}.layers.* → encoder_{i}
  cls (1, batch, 2048)            → cls (1, 1, 2048)  [slot 0 — the
                                    reference learns one CLS per batch
                                    slot; see devt_tpu/models/ptn.py]
  mlp_head.{0,1}                  → head_norm / head
  norm                            → norm
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from devt_tpu_torch.utils import torch_port as tp


def _sub(sd: Mapping[str, Any], prefix: str) -> dict:
    plen = len(prefix) + 1
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def load_checkpoint_state_dict(path: str) -> dict:
    """Read a Lightning ``.ckpt`` (a torch pickle) and return state_dict.

    ``weights_only=False``, as the JAX package reads it: a Lightning
    payload holds hyper-parameter objects, which the restricted unpickler
    refuses.  Unpickling runs code, so read only checkpoints you trust.
    (The port's own checkpoints, ``train/checkpoint.py``, hold tensors
    only and load with ``weights_only=True``.)"""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    return payload.get("state_dict", payload)


def frame_transformer(sd: Mapping[str, Any], n_mlp_layers: int = 3) -> dict:
    """Reference FrameTransformer state_dict → FrameTransformer variables
    in the flax layout ({"params": ..., "batch_stats": ...}).  The tree
    holds every module the checkpoint has; a variant's model takes the
    part it builds."""
    params: dict = {}
    stats: dict = {}

    vid_sd = _sub(sd, "vid_model.backbone")
    vid_vars = tp.r2plus1d(vid_sd, with_fc=False)
    params["vid_backbone"] = vid_vars["params"]
    stats["vid_backbone"] = vid_vars["batch_stats"]
    params["vid_fc"] = tp.linear(vid_sd, "fc.0")

    if "img_model.backbone.conv1.weight" in sd:
        img_sd = _sub(sd, "img_model.backbone")
        img_vars = tp.resnet(img_sd, with_fc=False)
        params["img_backbone"] = img_vars["params"]
        stats["img_backbone"] = img_vars["batch_stats"]
        params["img_fc"] = tp.linear(img_sd, "fc.0")

    for name, layers in (("distil_transformer", 4), ("scene_transformer", 4)):
        enc_sd = _sub(sd, f"{name}.transformer")
        if enc_sd:
            params[name] = tp.transformer_encoder(enc_sd, layers)

    if "vid_cls" in sd:
        # (1, T, C, H, W) → (T, H, W, C)
        params["vid_cls"] = tp._np(sd["vid_cls"])[0].transpose(0, 2, 3, 1)
    if "img_cls" in sd:
        params["img_cls"] = tp._np(sd["img_cls"])[0].transpose(1, 2, 0)

    head = {}
    for i, torch_idx in enumerate(range(0, n_mlp_layers * 2, 2)):
        head[f"fc{i}"] = tp.linear(sd, f"img_mlp_head.{torch_idx}")
    params["img_mlp_head"] = head

    return {"params": params, "batch_stats": stats}


def simple_transformer(sd: Mapping[str, Any], nlayers: int,
                       num_experts: int = 2) -> dict:
    """Reference SimpleTransformer state_dict → PTN params in the flax
    layout ({"params": ...})."""
    params: dict = {}
    for i in range(num_experts):
        enc_sd = _sub(sd, f"transformer_encoder{i}")
        if enc_sd:
            params[f"encoder_{i}"] = tp.transformer_encoder(enc_sd, nlayers)
    if "cls" in sd:
        cls = tp._np(sd["cls"])          # (1, batch, d) — slot 0
        params["cls"] = cls[:, :1, :]
    params["norm"] = tp.layernorm(sd, "norm")
    params["head_norm"] = tp.layernorm(sd, "mlp_head.0")
    params["head"] = tp.linear(sd, "mlp_head.1")
    return {"params": params}
