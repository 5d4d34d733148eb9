"""Weights carried between the JAX package and the port.

A JAX model's variables, given as a nested dict of numpy arrays (call
``np.asarray`` on each leaf first; this module imports no JAX), map onto
the port's ``state_dict`` by name:

  * path segments join with ``.``; ``block_<i>`` becomes ``blocks.<i>`` and
    ``layer_<i>`` becomes ``layers.<i>`` (the ``nn.ModuleList``s);
  * a flax Dense ``kernel`` (in, out) becomes a Linear ``weight`` (out, in);
    a Conv ``kernel`` (kh, kw, cin, cout) a Conv2d ``weight`` (cout, cin,
    kh, kw), and a 3-D one (kt, kh, kw, cin, cout) a Conv3d ``weight``
    (cout, cin, kt, kh, kw): permuted, not transposed, which would swap kh
    and kw;
  * a LayerNorm's or BatchNorm's ``scale`` becomes ``weight``; a
    BatchNorm's ``batch_stats`` ``mean`` and ``var`` become the buffers
    ``running_mean`` and ``running_var`` (``models/resnet.py``);
  * ``bias`` and the other
    leaves (``pos_embedding``, ``space_token``, an MoE block's
    ``moe_router`` (D, E), ``moe_w1`` (E, D, F), ``moe_b1`` (E, F),
    ``moe_w2`` (E, F, D), ``moe_b2`` (E, D)…) keep their names and layout,
    untransposed both ways.

One tree is not mapped leaf by leaf: flax's ``OptimizedLSTMCell_<i>``
(``devt_tpu/models/lstm.py``) holds a kernel a gate, ``ii``, ``if``,
``ig``, ``io`` (in, H) without bias and ``hi``, ``hf``, ``hg``, ``ho``
(H, H) with biases, which the port's ``cells.<i>`` stacks in i, f, g, o
order into ``weight_ih`` (4H, in), ``weight_hh`` (4H, H) and ``bias_hh``
(4H) (``models/lstm.py``).

Names follow ``devt_tpu/models/layers.py:117-160`` (``attn_norm``,
``attn/to_qkv``, ``attn/to_out``, ``ff_norm``, ``ff/fc1``, ``ff/fc2``) for
ViViT and ``devt_tpu/models/ptn.py`` / ``torch_encoder.py`` for PTN
(``encoder_<i>/layer_<j>/self_attn/in_proj``, ``out_proj``, ``linear1``,
``linear2``, ``norm1``, ``norm2``; ``cls``, ``norm``, ``head_norm``,
``head``), and ``devt_tpu/models/{frame_transformer,resnet,r2plus1d}.py``
for FrameTransformer (``layer1_0`` and its kind keep their names: only
``block_<i>`` and ``layer_<i>`` are lists), and ``devt_tpu/models/{tpn,
contrastive,basicmlp,collab_gating}.py`` for the rest of the family
(``backbone``, ``low_reduce``, ``reason/scale<g>_fc<k>``, ``enc_fc1``,
``enc_bn``, ``fc1``, ``bn``, ``projection``, ``geu_fc``…).

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
# flax kernel → torch weight by the kernel's rank (Dense, Conv, 3-D Conv),
# and back
_TO_TORCH = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_TO_FLAX = {2: (1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}
# flax's LSTM cells and their gates, in the port's stacking order
_LSTM_CELL = re.compile(r"OptimizedLSTMCell_(\d+)")
_GATES = "ifgo"
# BatchNorm's batch_stats leaves → the port's buffers
_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_FLAX = {v: k for k, v in _STATS.items()}


def _leaves(tree: Mapping[str, Any],
            prefix: tuple[str, ...] = ()) -> Iterator[tuple[tuple, Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _torch_path(path: tuple) -> list[str]:
    parts = []
    for seg in path:
        m = re.fullmatch(r"(block|layer)_(\d+)", seg)
        parts += [_LISTS[m.group(1)], m.group(2)] if m else [seg]
    return parts


def _lstm_to_torch(cell: Mapping[str, Any], dtype) -> dict[str, np.ndarray]:
    """One ``OptimizedLSTMCell``'s leaves → ``weight_ih``, ``weight_hh``,
    ``bias_hh``, the gates stacked in i, f, g, o order."""
    def stack(kind, leaf):
        return np.concatenate([np.asarray(cell[f"{kind}{g}"][leaf], dtype)
                               for g in _GATES], axis=-1)
    return {"weight_ih": stack("i", "kernel").T,
            "weight_hh": stack("h", "kernel").T,
            "bias_hh": stack("h", "bias")}


def _lstm_to_flax(leaves: Mapping[str, np.ndarray]) -> dict[str, Any]:
    """The port's ``cells.<i>`` leaves → one ``OptimizedLSTMCell``'s."""
    cell = {}
    for kind, name in (("i", "weight_ih"), ("h", "weight_hh")):
        for g, w in zip(_GATES, np.split(leaves[name], 4, axis=0)):
            cell[f"{kind}{g}"] = {"kernel": np.ascontiguousarray(w.T)}
    for g, b in zip(_GATES, np.split(leaves["bias_hh"], 4)):
        cell[f"h{g}"]["bias"] = np.ascontiguousarray(b)
    return cell


def jax_to_state_dict(variables: Mapping[str, Any],
                      dtype=np.float32) -> dict[str, torch.Tensor]:
    """JAX variables (``{"params": tree, "batch_stats": tree}``, or the
    params tree alone) → port state_dict, every leaf as ``dtype``."""
    params = dict(variables.get("params", variables))
    out = {}
    for key in [k for k in params if _LSTM_CELL.fullmatch(k)]:
        cell = _LSTM_CELL.fullmatch(key).group(1)
        for name, arr in _lstm_to_torch(params.pop(key), dtype).items():
            out[f"cells.{cell}.{name}"] = torch.tensor(
                np.ascontiguousarray(arr))
    for path, leaf in _leaves(params):
        name = path[-1]
        arr = np.asarray(leaf, dtype=dtype)
        if name == "kernel":
            arr = arr.transpose(_TO_TORCH[arr.ndim])
        parts = _torch_path(path[:-1])
        parts.append("weight" if name in ("kernel", "scale") else name)
        out[".".join(parts)] = torch.tensor(np.ascontiguousarray(arr))
    if "params" in variables:
        for path, leaf in _leaves(variables.get("batch_stats", {})):
            parts = _torch_path(path[:-1]) + [_STATS[path[-1]]]
            out[".".join(parts)] = torch.tensor(np.asarray(leaf, dtype=dtype))
    return out


def state_dict_to_jax(state_dict: Mapping[str, torch.Tensor],
                      dtype=np.float32) -> dict[str, Any]:
    """Port state_dict → ``{"params": tree}`` of numpy arrays of ``dtype``,
    with ``"batch_stats": tree`` when it holds BatchNorm buffers."""
    trees: dict[str, dict] = {"params": {}}
    cells: dict[str, dict] = {}
    for name, tensor in state_dict.items():
        parts = name.split(".")
        arr = tensor.detach().cpu().numpy().astype(dtype)
        if parts[0] == "cells" and len(parts) == 3:
            cells.setdefault(parts[1], {})[parts[2]] = arr
            continue
        leaf, tree = parts[-1], trees["params"]
        if leaf == "weight":
            # Linear and Conv weights are kernels (permuted back); 1-D are
            # LayerNorm or BatchNorm scales
            leaf = "scale" if arr.ndim == 1 else "kernel"
            if arr.ndim > 1:
                arr = arr.transpose(_TO_FLAX[arr.ndim])
        elif leaf in _STATS_FLAX:
            leaf, tree = _STATS_FLAX[leaf], trees.setdefault(
                "batch_stats", {})
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
    for i, leaves in cells.items():
        trees["params"][f"OptimizedLSTMCell_{i}"] = _lstm_to_flax(leaves)
    return trees
