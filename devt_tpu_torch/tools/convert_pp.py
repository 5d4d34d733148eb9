"""Convert ViViT checkpoints between the standard and pipeline layouts.

The port of ``devt_tpu/tools/convert_pp.py`` on the port's names.
``config.pp > 1`` (or ``sp > 1``) declares the space transformer's blocks
STACKED, one ``(depth, ...)`` leaf per entry of the fused block's dict
(``pb_*``, ``models/layers.py:ViTTransformer``), so a state trained with
``pp=N`` does not load into a ``pp=1`` model or the other way round.  The
two layouts carry the same numbers; this module moves between them
losslessly (a torch ``Linear`` weight is (out, in), the stacked matrix
(in, out)):

  standard (per-block modules)                       stacked (pp)
  space_transformer.blocks.<i>.attn_norm.{weight,bias} (D,)   ↔ pb_g1 / pb_b1 (depth, 1, D)
  space_transformer.blocks.<i>.attn.to_qkv.weight (3I, D)     ↔ pb_wqkv      (depth, D, 3I)
  space_transformer.blocks.<i>.attn.to_out.{weight,bias}      ↔ pb_wo / pb_bo
  space_transformer.blocks.<i>.ff_norm.{weight,bias}          ↔ pb_g2 / pb_b2
  space_transformer.blocks.<i>.ff.fc1.{weight,bias}           ↔ pb_w1 / pb_bb1
  space_transformer.blocks.<i>.ff.fc2.{weight,bias}           ↔ pb_w2 / pb_bb2

The final ``norm`` and everything outside ``space_transformer`` pass
through untouched.  The optimizer's moments are lists in the order of the
parameters (``train/optimizers.py``), so ``convert_payload`` converts a
list that mirrors ``params`` through the same names, and the stacked
leaves take the place of the first block's entries (the order the
converted model declares its parameters in).

Command line (a ``train/checkpoint.py`` step directory → a converted one):

    python -m devt_tpu_torch.tools.convert_pp --src ck/step_100 --dst ck_pp \\
        [--to standard|stacked]
"""

from __future__ import annotations

import re

import torch

SPACE = "space_transformer."
# (stacked leaf, the standard leaf's name inside blocks.<i>, its kind: a
# LayerNorm or bias row stacked as (1, N), or a Linear weight transposed)
_LAYOUT = [
    ("pb_g1", "attn_norm.weight", "row"),
    ("pb_b1", "attn_norm.bias", "row"),
    ("pb_wqkv", "attn.to_qkv.weight", "matrix"),
    ("pb_wo", "attn.to_out.weight", "matrix"),
    ("pb_bo", "attn.to_out.bias", "row"),
    ("pb_g2", "ff_norm.weight", "row"),
    ("pb_b2", "ff_norm.bias", "row"),
    ("pb_w1", "ff.fc1.weight", "matrix"),
    ("pb_bb1", "ff.fc1.bias", "row"),
    ("pb_w2", "ff.fc2.weight", "matrix"),
    ("pb_bb2", "ff.fc2.bias", "row"),
]
_BLOCK = re.compile(r"blocks\.(\d+)\.")


def _spliced(space: dict, drop, new: dict) -> dict:
    """``space`` without the entries ``drop`` selects, ``new`` in the
    place of the first one."""
    out, placed = {}, False
    for k, v in space.items():
        if drop(k):
            if not placed:
                out.update(new)
                placed = True
        else:
            out[k] = v
    return out


def stack_block_params(space: dict) -> dict:
    """Standard ``blocks.<i>.*`` entries → stacked ``pb_*`` leaves.

    ``space`` maps the names inside ``space_transformer`` to tensors;
    returns a new mapping (``norm`` and any non-block entries carried
    over)."""
    depth = len({int(m.group(1)) for k in space
                 if (m := _BLOCK.match(k))})
    if not depth:
        raise ValueError("no blocks.<i> entries — already stacked?")
    stacked = {}
    for name, leaf, kind in _LAYOUT:
        parts = [space[f"blocks.{i}.{leaf}"] for i in range(depth)]
        parts = [p.reshape(1, -1) if kind == "row" else p.t()
                 for p in parts]
        stacked[name] = torch.stack(parts).contiguous()
    return _spliced(space, _BLOCK.match, stacked)


def unstack_block_params(space: dict) -> dict:
    """Stacked ``pb_*`` leaves → standard ``blocks.<i>.*`` entries."""
    if "pb_wqkv" not in space:
        raise ValueError("no pb_* leaves — already standard?")
    depth = space["pb_wqkv"].shape[0]
    blocks = {}
    for i in range(depth):
        for name, leaf, kind in _LAYOUT:
            v = space[name][i]
            blocks[f"blocks.{i}.{leaf}"] = (v.reshape(-1) if kind == "row"
                                            else v.t()).contiguous()
    return _spliced(space, lambda k: k.startswith("pb_"), blocks)


def convert_vivit_params(params: dict, to: str) -> dict:
    """Convert a ViViT's parameters (``state_dict`` names → tensors);
    ``to`` = "stacked" | "standard".  Returns the input unchanged when it
    is in the requested layout already."""
    space = {k[len(SPACE):]: v for k, v in params.items()
             if k.startswith(SPACE)}
    if not space:
        raise ValueError("not a ViViT's parameters (no space_transformer)")
    stacked_now = any(k.startswith("pb_") for k in space)
    if to == "stacked":
        if stacked_now:
            return params
        new_space = stack_block_params(space)
    elif to == "standard":
        if not stacked_now:
            return params
        new_space = unstack_block_params(space)
    else:
        raise ValueError(f"unknown layout {to!r}")
    return _spliced(params, lambda k: k.startswith(SPACE),
                    {SPACE + k: v for k, v in new_space.items()})


def _mirrors(obj, names: list[str], params: dict) -> bool:
    """Whether ``obj`` is a list of tensors in the order and shapes of
    ``params`` (an optimizer moment)."""
    return (isinstance(obj, (list, tuple)) and len(obj) == len(names)
            and all(isinstance(t, torch.Tensor) and t.shape == params[k].shape
                    for t, k in zip(obj, names)))


def convert_payload(obj, to: str, _params: dict | None = None):
    """Convert every ViViT-parameter-shaped part of a checkpoint payload:
    the parameters themselves AND the optimizer's moments (lists that
    mirror ``params``), so training continues exactly across layouts."""
    if isinstance(obj, dict):
        if any(isinstance(k, str) and k.startswith(SPACE) for k in obj):
            try:
                return convert_vivit_params(obj, to)
            except (ValueError, KeyError, TypeError):
                pass
        params = obj.get("params") if isinstance(obj.get("params"), dict) \
            else _params
        return {k: convert_payload(v, to, params) for k, v in obj.items()}
    if _params is not None:
        names = list(_params)
        if _mirrors(obj, names, _params):
            try:
                converted = convert_vivit_params(dict(zip(names, obj)), to)
            except (ValueError, KeyError, TypeError):
                return obj
            return type(obj)(converted.values())
    if isinstance(obj, (list, tuple)):
        return type(obj)(convert_payload(v, to, _params) for v in obj)
    return obj


def main(argv=None) -> int:
    import argparse
    import os
    import shutil

    from devt_tpu_torch.train import checkpoint

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True,
                    help="source checkpoint step dir (…/step_N)")
    ap.add_argument("--dst", required=True, help="destination dir")
    ap.add_argument("--to", choices=("standard", "stacked"),
                    default="stacked")
    args = ap.parse_args(argv)

    payload = convert_payload(checkpoint.load(os.path.abspath(args.src)),
                              args.to)
    step = int(payload.get("step", 0))
    dst = os.path.join(os.path.abspath(args.dst), f"step_{step}")
    os.makedirs(dst, exist_ok=True)
    torch.save(payload, os.path.join(dst, checkpoint.STATE_FILE))
    src_cfg = os.path.join(os.path.dirname(os.path.abspath(args.src)),
                           "config.yaml")
    if os.path.exists(src_cfg):
        shutil.copy(src_cfg, os.path.join(os.path.abspath(args.dst),
                                          "config.yaml"))
    print(f"wrote {args.to} layout checkpoint to {dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
