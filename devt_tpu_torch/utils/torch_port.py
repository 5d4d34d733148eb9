"""torch (torchvision, Lightning) state_dicts → flax-layout variables.

The port's own copy of the map functions of ``devt_tpu/utils/torch_port.py``
(``:26-250``).  They map a state_dict of the reference's modules onto the
JAX package's variable trees, ``{"params": ..., "batch_stats": ...}`` of
numpy arrays; ``utils/jax_bridge.py:jax_to_state_dict`` carries such a tree
onto the port's ``state_dict`` by name.  So a reference checkpoint reaches
the port by the same maps that bring it into the JAX package, and the two
agree leaf for leaf.  Layout conventions:

  * ``torch.nn.Linear.weight`` is (out, in); flax ``Dense.kernel`` is
    (in, out).
  * ``torch.nn.MultiheadAttention`` packs q/k/v into ``in_proj_weight``
    (3E, E).
  * ``torch.nn.Conv2d.weight`` is (O, I, kH, kW) — flax ``Conv.kernel`` is
    (kH, kW, I, O); Conv3d (O, I, kT, kH, kW) → (kT, kH, kW, I, O).
  * BatchNorm running stats live in flax's ``batch_stats`` collection.

Every function takes a plain mapping of arrays or tensors (a torch
``state_dict()`` works directly).  The JAX module's command line and its
file tools (``_flatten_tree``, ``save_variables``, ``load_variables``,
``_load_state_dict``, ``_selfcheck``, ``main``) are not ported yet
(ROADMAP.md queue 1, item 8).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def linear(sd: Mapping[str, Any], prefix: str) -> dict:
    """torch Linear → flax Dense params."""
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def layernorm(sd: Mapping[str, Any], prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def conv2d(sd: Mapping[str, Any], prefix: str) -> dict:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def conv3d(sd: Mapping[str, Any], prefix: str) -> dict:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).transpose(2, 3, 4, 1, 0)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def batchnorm(sd: Mapping[str, Any], prefix: str) -> tuple[dict, dict]:
    """Returns (params, batch_stats) halves of a torch BatchNorm."""
    params = {"scale": _np(sd[f"{prefix}.weight"]),
              "bias": _np(sd[f"{prefix}.bias"])}
    stats = {"mean": _np(sd[f"{prefix}.running_mean"]),
             "var": _np(sd[f"{prefix}.running_var"])}
    return params, stats


def multihead_attention(sd: Mapping[str, Any], prefix: str) -> dict:
    """torch MultiheadAttention → TorchMultiheadAttention params."""
    return {
        "in_proj": {"kernel": _np(sd[f"{prefix}.in_proj_weight"]).T,
                    "bias": _np(sd[f"{prefix}.in_proj_bias"])},
        "out_proj": linear(sd, f"{prefix}.out_proj"),
    }


def transformer_encoder(sd: Mapping[str, Any], num_layers: int,
                        prefix: str = "layers") -> dict:
    """torch ``TransformerEncoder`` state_dict → ``TorchTransformerEncoder``
    params (devt_tpu/models/torch_encoder.py)."""
    params: dict = {}
    for i in range(num_layers):
        p = f"{prefix}.{i}"
        params[f"layer_{i}"] = {
            "self_attn": multihead_attention(sd, f"{p}.self_attn"),
            "linear1": linear(sd, f"{p}.linear1"),
            "linear2": linear(sd, f"{p}.linear2"),
            "norm1": layernorm(sd, f"{p}.norm1"),
            "norm2": layernorm(sd, f"{p}.norm2"),
        }
    return params


def vit_transformer(sd: Mapping[str, Any], depth: int,
                    prefix: str = "") -> dict:
    """Reference-style pre-norm ViT transformer (src/models/vit.py:60-75)
    state_dict → ``ViTTransformer`` params.

    Expects the reference naming: ``layers.{i}.0.norm / layers.{i}.0.fn.to_qkv
    / layers.{i}.0.fn.to_out.0`` for attention and ``layers.{i}.1.*`` with
    ``fn.net.0 / fn.net.3`` for the feed-forward, plus a trailing ``norm``.
    """
    p = prefix + "." if prefix else ""
    params: dict = {}
    for i in range(depth):
        attn = {"to_qkv": linear(sd, f"{p}layers.{i}.0.fn.to_qkv")}
        if f"{p}layers.{i}.0.fn.to_out.0.weight" in sd:
            attn["to_out"] = linear(sd, f"{p}layers.{i}.0.fn.to_out.0")
        params[f"block_{i}"] = {
            "attn_norm": layernorm(sd, f"{p}layers.{i}.0.norm"),
            "attn": attn,
            "ff_norm": layernorm(sd, f"{p}layers.{i}.1.norm"),
            "ff": {
                "fc1": linear(sd, f"{p}layers.{i}.1.fn.net.0"),
                "fc2": linear(sd, f"{p}layers.{i}.1.fn.net.3"),
            },
        }
    params["norm"] = layernorm(sd, f"{p}norm")
    return params


# ---------------------------------------------------------------------------
# Full-network converters (torchvision state_dict naming)
# ---------------------------------------------------------------------------


def _convbn(sd, conv_key: str, bn_key: str, three_d: bool = False):
    """(conv, bn) pair → ConvBN/ConvBN3d {params, batch_stats} halves."""
    conv_fn = conv3d if three_d else conv2d
    bn_params, bn_stats = batchnorm(sd, bn_key)
    return ({"conv": conv_fn(sd, conv_key), "bn": bn_params},
            {"bn": bn_stats})


def resnet(sd: Mapping[str, Any], layers: tuple = (2, 2, 2, 2),
           bottleneck: bool = False, with_fc: bool = True) -> dict:
    """torchvision ResNet state_dict → devt_tpu ResNet variables
    (``devt_tpu/models/resnet.py`` naming)."""
    params: dict = {}
    stats: dict = {}
    params["stem"], stats["stem"] = _convbn(sd, "conv1", "bn1")
    n_convs = 3 if bottleneck else 2
    for li, blocks in enumerate(layers):
        for bi in range(blocks):
            t = f"layer{li + 1}.{bi}"
            name = f"layer{li + 1}_{bi}"
            bp: dict = {}
            bs: dict = {}
            for ci in range(1, n_convs + 1):
                bp[f"conv{ci}"], bs[f"conv{ci}"] = _convbn(
                    sd, f"{t}.conv{ci}", f"{t}.bn{ci}")
            if f"{t}.downsample.0.weight" in sd:
                bp["downsample"], bs["downsample"] = _convbn(
                    sd, f"{t}.downsample.0", f"{t}.downsample.1")
            params[name] = bp
            stats[name] = bs
    if with_fc and "fc.weight" in sd:
        params["fc"] = linear(sd, "fc")
    return {"params": params, "batch_stats": stats}


def r2plus1d(sd: Mapping[str, Any], layers: tuple = (2, 2, 2, 2),
             with_fc: bool = True) -> dict:
    """torchvision ``r2plus1d_18`` state_dict → devt_tpu R2Plus1D variables.

    torchvision naming: stem.0/.1 (spatial conv+bn), stem.3/.4 (temporal),
    layer{l}.{b}.conv1.0.0 (spatial conv), .conv1.0.1 (mid bn), .conv1.0.3
    (temporal conv), .conv1.1 (outer bn1), same for conv2, downsample.0/.1.
    """
    params: dict = {}
    stats: dict = {}
    params["stem_spatial"], stats["stem_spatial"] = _convbn(
        sd, "stem.0", "stem.1", three_d=True)
    params["stem_temporal"], stats["stem_temporal"] = _convbn(
        sd, "stem.3", "stem.4", three_d=True)
    for li, blocks in enumerate(layers):
        for bi in range(blocks):
            t = f"layer{li + 1}.{bi}"
            name = f"layer{li + 1}_{bi}"
            bp: dict = {}
            bs: dict = {}
            for ci in (1, 2):
                spatial_p, spatial_s = _convbn(
                    sd, f"{t}.conv{ci}.0.0", f"{t}.conv{ci}.0.1",
                    three_d=True)
                bp[f"conv{ci}"] = {
                    "spatial": spatial_p,
                    "temporal": conv3d(sd, f"{t}.conv{ci}.0.3"),
                }
                bs[f"conv{ci}"] = {"spatial": spatial_s}
                bn_p, bn_s = batchnorm(sd, f"{t}.conv{ci}.1")
                bp[f"bn{ci}"] = bn_p
                bs[f"bn{ci}"] = bn_s
            if f"{t}.downsample.0.weight" in sd:
                bp["downsample"], bs["downsample"] = _convbn(
                    sd, f"{t}.downsample.0", f"{t}.downsample.1",
                    three_d=True)
            params[name] = bp
            stats[name] = bs
    if with_fc and "fc.weight" in sd:
        params["fc"] = linear(sd, "fc")
    return {"params": params, "batch_stats": stats}


def r3d(sd: Mapping[str, Any], layers: tuple = (2, 2, 2, 2),
        with_fc: bool = True) -> dict:
    """torchvision ``r3d_18`` state_dict → devt_tpu R3D variables."""
    params: dict = {}
    stats: dict = {}
    params["stem"], stats["stem"] = _convbn(sd, "stem.0", "stem.1",
                                            three_d=True)
    for li, blocks in enumerate(layers):
        for bi in range(blocks):
            t = f"layer{li + 1}.{bi}"
            name = f"layer{li + 1}_{bi}"
            bp: dict = {}
            bs: dict = {}
            for ci in (1, 2):
                bp[f"conv{ci}"], bs[f"conv{ci}"] = _convbn(
                    sd, f"{t}.conv{ci}.0", f"{t}.conv{ci}.1", three_d=True)
            if f"{t}.downsample.0.weight" in sd:
                bp["downsample"], bs["downsample"] = _convbn(
                    sd, f"{t}.downsample.0", f"{t}.downsample.1",
                    three_d=True)
            params[name] = bp
            stats[name] = bs
    if with_fc and "fc.weight" in sd:
        params["fc"] = linear(sd, "fc")
    return {"params": params, "batch_stats": stats}
