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
``state_dict()`` works directly).  The file tools and the command line
(``devt_tpu/utils/torch_port.py:251-418``) are here too: ``variables.npz``
keeps JAX's ``collection::path/to/leaf`` keys, so a file that either
package writes loads in the other, and ``--selfcheck`` runs the port's
backbone (through ``utils/jax_bridge.py``) on the card, or on the CPU
with ``--device cpu``:

    python -m devt_tpu_torch.utils.torch_port \
        --ckpt r2plus1d_18-91a641e6.pth --arch r2plus1d \
        --out params/r2plus1d --selfcheck
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


# ---------------------------------------------------------------------------
# file tools and the command line
# ---------------------------------------------------------------------------


def _flatten_tree(tree: Mapping, prefix: str = "") -> dict:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten_tree(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def _unflatten_tree(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_variables(variables: Mapping, out_dir: str) -> str:
    """Write ported variables as ``<out_dir>/variables.npz`` with
    ``collection::path/to/leaf`` keys (the JAX package's file)."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    flat = {}
    for coll, tree in variables.items():
        for k, v in _flatten_tree(tree).items():
            flat[f"{coll}::{k}"] = v
    path = os.path.join(out_dir, "variables.npz")
    np.savez(path, **flat)
    return path


def load_variables(path: str) -> dict:
    """Inverse of :func:`save_variables`: the nested variables, ready for
    ``utils/jax_bridge.py:jax_to_state_dict``."""
    z = np.load(path)
    colls: dict = {}
    for key in z.files:
        coll, flat_key = key.split("::", 1)
        colls.setdefault(coll, {})[flat_key] = z[key]
    return {coll: _unflatten_tree(flat) for coll, flat in colls.items()}


def _load_state_dict(path: str) -> dict:
    """torch ``.pth/.pt`` (plain state_dict), Lightning ``.ckpt`` (nested
    under ``state_dict``, ``model.`` prefixes stripped), or the repo's
    golden ``.npz`` layout (``sd::``-prefixed keys)."""
    if path.endswith(".npz"):
        z = np.load(path)
        return {k[4:]: z[k].astype(np.float32)
                for k in z.files if k.startswith("sd::")}
    import torch

    # a Lightning file pickles its hyper-parameters beside the tensors
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:     # Lightning
        obj = obj["state_dict"]
        obj = {(k[len("model."):] if k.startswith("model.") else k): v
               for k, v in obj.items()}
    return obj


_ARCHS = {
    "resnet18": (resnet, (2, 2, 2, 2)),
    "resnet34": (resnet, (3, 4, 6, 3)),
    "r2plus1d_18": (r2plus1d, (2, 2, 2, 2)),
    "r3d_18": (r3d, (2, 2, 2, 2)),
}
_ARCH_ALIASES = {"resnet": "resnet18", "r2plus1d": "r2plus1d_18",
                 "r3d": "r3d_18"}


def _selfcheck(arch: str, layers: tuple, variables: dict,
               fixture_path: str | None, device=None) -> np.ndarray:
    """Build the port's backbone on ``variables`` (through the bridge),
    run one forward on ``device`` (the card unless ``"cpu"``), check it
    is finite and, for a golden fixture with a reference output, within
    1e-3 of it relative to its largest element.  Returns the output."""
    import torch

    from devt_tpu_torch.serve import resolve_device
    from devt_tpu_torch.utils.jax_bridge import jax_to_state_dict

    device = resolve_device(device)
    n_classes = (variables["params"]["fc"]["kernel"].shape[1]
                 if "fc" in variables["params"] else 0)
    output = "logits" if n_classes else "features"
    if arch.startswith("resnet"):
        from devt_tpu_torch.models.resnet import BasicBlock, ResNet

        model = ResNet(block=BasicBlock, layers=layers,
                       num_classes=max(n_classes, 1), output=output)
        x = np.zeros((1, 64, 64, 3), np.float32)
    elif arch.startswith("r2plus1d"):
        from devt_tpu_torch.models.r2plus1d import R2Plus1D

        model = R2Plus1D(layers=layers, num_classes=max(n_classes, 1),
                         output=output)
        x = np.zeros((1, 4, 32, 32, 3), np.float32)
    else:
        from devt_tpu_torch.models.r2plus1d import R3D

        model = R3D(layers=layers, num_classes=max(n_classes, 1),
                    output=output)
        x = np.zeros((1, 4, 32, 32, 3), np.float32)
    model.load_state_dict(jax_to_state_dict(
        {c: variables[c] for c in ("params", "batch_stats")
         if c in variables}))
    model.to(device).eval()

    fixture = np.load(fixture_path) if fixture_path and \
        fixture_path.endswith(".npz") else None
    if fixture is not None and "input" in fixture.files:   # NC(T)HW
        xin = fixture["input"].astype(np.float32)
        x = (xin.transpose(0, 2, 3, 1) if xin.ndim == 4
             else xin.transpose(0, 2, 3, 4, 1))
    with torch.no_grad():
        out = model(torch.as_tensor(x, device=device), train=False)
    out = out.float().cpu().numpy()
    assert np.isfinite(out).all(), "non-finite forward output"
    msg = (f"selfcheck: forward OK on {device.type}, output shape "
           f"{out.shape}")
    if fixture is not None and "output" in fixture.files:
        ref = fixture["output"]
        rel = np.abs(out - ref) / (np.abs(ref).max() + 1e-8)
        assert rel.max() < 1e-3, \
            f"parity FAILED: max rel err {rel.max():.2e} (bound 1e-3)"
        msg += f", logit parity max rel err {rel.max():.2e} (≤1e-3)"
    print(msg)
    return out


def main(argv=None, device=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m devt_tpu_torch.utils.torch_port",
        description="Port a torchvision/Lightning checkpoint file to "
                    "flax-layout variables (variables.npz) and check the "
                    "port's backbone on them.")
    ap.add_argument("--ckpt", required=True,
                    help=".pth/.pt state_dict, Lightning .ckpt, or a "
                         "golden-layout .npz")
    ap.add_argument("--arch", required=True,
                    choices=sorted(_ARCHS) + sorted(_ARCH_ALIASES))
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--layers", default=None,
                    help="per-stage block counts, e.g. 2,2,2,2 "
                         "(default: the arch's torchvision counts)")
    ap.add_argument("--no-fc", action="store_true",
                    help="drop the classifier head (feature extractor)")
    ap.add_argument("--selfcheck", action="store_true",
                    help="build the port's backbone and run one forward; "
                         "with a golden fixture, assert ≤1e-3 parity")
    ap.add_argument("--device", default=None,
                    help="where --selfcheck runs (default: the card)")
    args = ap.parse_args(argv)

    arch = _ARCH_ALIASES.get(args.arch, args.arch)
    convert, layers = _ARCHS[arch]
    if args.layers:
        layers = tuple(int(x) for x in args.layers.split(","))
    sd = _load_state_dict(args.ckpt)
    variables = convert(sd, layers=layers, with_fc=not args.no_fc)
    path = save_variables(variables, args.out)
    n = sum(int(np.prod(v.shape)) for v in
            _flatten_tree(variables["params"]).values())
    print(f"ported {arch} (layers={layers}, {n / 1e6:.1f}M params) "
          f"-> {path}")
    if args.selfcheck:
        _selfcheck(arch, layers, variables, args.ckpt,
                   args.device if args.device is not None else device)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
