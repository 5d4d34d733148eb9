"""Weights carried between the JAX package and the port.

A JAX model's variables, given as a nested dict of numpy arrays (call
``np.asarray`` on each leaf first; this module imports no JAX), map onto
the port's ``state_dict`` by name:

  * path segments join with ``.``; ``block_<i>`` becomes ``blocks.<i>`` and
    ``layer_<i>`` becomes ``layers.<i>`` (the ``nn.ModuleList``s);
  * a flax Dense ``kernel`` (in, out) becomes a Linear ``weight`` (out, in);
  * a LayerNorm ``scale`` becomes ``weight``; ``bias`` and the other
    leaves (``pos_embedding``, ``space_token``, an MoE block's
    ``moe_router`` (D, E), ``moe_w1`` (E, D, F), ``moe_b1`` (E, F),
    ``moe_w2`` (E, F, D), ``moe_b2`` (E, D)…) keep their names and layout,
    untransposed both ways.

Names follow ``devt_tpu/models/layers.py:117-160`` (``attn_norm``,
``attn/to_qkv``, ``attn/to_out``, ``ff_norm``, ``ff/fc1``, ``ff/fc2``) for
ViViT and ``devt_tpu/models/ptn.py`` / ``torch_encoder.py`` for PTN
(``encoder_<i>/layer_<j>/self_attn/in_proj``, ``out_proj``, ``linear1``,
``linear2``, ``norm1``, ``norm2``; ``cls``, ``norm``, ``head_norm``,
``head``).

``jax_to_state_dict`` maps any tree shaped like the parameters, not only
weights: a gradient tree (``jax.grad`` of the loss) and optax's ``mu`` /
``nu`` moment trees come out keyed like ``named_parameters()``, each leaf
transposed as its parameter is.  The training tests compare gradients and
optimizer moments through it.
"""

from __future__ import annotations

import re
from typing import Any, Iterator, Mapping

import numpy as np
import torch

# flax names of numbered submodules → the port's ModuleList names
_LISTS = {"block": "blocks", "layer": "layers"}
_FLAX = {v: k for k, v in _LISTS.items()}


def _leaves(tree: Mapping[str, Any],
            prefix: tuple[str, ...] = ()) -> Iterator[tuple[tuple, Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def jax_to_state_dict(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX variables (``{"params": tree}`` or the tree) → port state_dict."""
    params = variables.get("params", variables)
    out = {}
    for path, leaf in _leaves(params):
        parts = []
        for seg in path[:-1]:
            m = re.fullmatch(r"(block|layer)_(\d+)", seg)
            parts += [_LISTS[m.group(1)], m.group(2)] if m else [seg]
        name = path[-1]
        arr = np.asarray(leaf, dtype=np.float32)
        if name == "kernel":
            arr = arr.T
        parts.append("weight" if name in ("kernel", "scale") else name)
        out[".".join(parts)] = torch.tensor(arr)
    return out


def state_dict_to_jax(state_dict: Mapping[str, torch.Tensor]
                      ) -> dict[str, Any]:
    """Port state_dict → ``{"params": tree}`` of f32 numpy arrays."""
    tree: dict[str, Any] = {}
    for name, tensor in state_dict.items():
        parts = name.split(".")
        arr = tensor.detach().cpu().float().numpy()
        leaf = parts[-1]
        if leaf == "weight":
            # 2-D weights are Linear (transposed back); 1-D are LN scales
            leaf = "kernel" if arr.ndim == 2 else "scale"
            arr = arr.T if arr.ndim == 2 else arr
        segs, i = [], 0
        while i < len(parts) - 1:
            if parts[i] in _FLAX:
                segs.append(f"{_FLAX[parts[i]]}_{parts[i + 1]}")
                i += 2
            else:
                segs.append(parts[i])
                i += 1
        node = tree
        for seg in segs:
            node = node.setdefault(seg, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": tree}
