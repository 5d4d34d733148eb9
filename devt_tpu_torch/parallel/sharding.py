"""Tensor-parallel partition rules for the model family: port of
``devt_tpu/parallel/sharding.py``.

The rules match a parameter by its ``state_dict`` name, so they apply to
every transformer of the family (``TorchTransformerEncoder`` and
``ViTTransformer`` naming) and split the Megatron way over the ``model``
axis:

  * packed qkv projections (``in_proj``, ``to_qkv``) by their output rows,
    on head boundaries;
  * attention output projections (``out_proj``, ``to_out``) by their
    input columns (row-parallel);
  * FFN up-projections (``linear1``, ``fc1``) by output, FFN
    down-projections (``linear2``, ``fc2``) by input;
  * everything else (norms, embeddings, convolutions, heads, every leaf of
    fewer than two dims) whole.

Specs are given for torch's ``(out, in)`` weights: JAX's
``P(None, "model")`` on a flax ``(in, out)`` kernel is ``("model", None)``
here.  The step (``parallel/train_step.py``, strategy ``gspmd``) runs the
blocks whose heads and FFN divide over the axis on their own slices
(``parallel/tp_block.py``, ``models/layers.py``,
``models/torch_encoder.py``: two all-reduces a block), and gathers every
other sharded weight whole, so its values are those of the one-device
step, as GSPMD's are.

Two differences from JAX's layout, of layout only: a packed qkv splits
each of its q, k and v thirds on head boundaries, ``(3, H/n, d)`` a rank,
as ``tp_shard_block_params`` does, where GSPMD splits its columns
contiguously; and a leaf whose dim does not divide over the axis stays
whole, where GSPMD would pad it.  The switch-MoE experts (``moe_w1``,
``moe_b1``, ``moe_w2``, ``moe_b2``) split by expert over ``model``: they
stay split at rest and the step gathers them whole for their block (GSPMD
instead runs each shard's experts where they lie and sums at the
combine), so the values are the one-device step's either way.
"""

from __future__ import annotations

from typing import Any

from devt_tpu_torch.parallel import layout
from devt_tpu_torch.parallel.collectives import part
from devt_tpu_torch.parallel.mesh import MODEL_AXIS, PIPE_AXIS

_M = MODEL_AXIS

# (name substring, weight spec) — first match wins
_RULES: tuple[tuple[str, tuple], ...] = (
    ("in_proj.weight", (_M, None)),
    ("to_qkv.weight", (_M, None)),
    ("out_proj.weight", (None, _M)),
    ("to_out.weight", (None, _M)),
    ("linear1.weight", (_M, None)),
    ("linear2.weight", (None, _M)),
    ("fc1.weight", (_M, None)),      # ViT FeedForward up-projection
    ("fc2.weight", (None, _M)),      # ViT FeedForward down-projection
    # the switch-MoE experts, by expert
    ("moe_w1", (_M, None, None)),
    ("moe_b1", (_M, None)),
    ("moe_w2", (_M, None, None)),
    ("moe_b2", (_M, None)),
)

# the packed qkv projections: q, k and v each split by head
_QKV = ("in_proj.weight", "to_qkv.weight")


def _spec_for(name: str, ndim: int) -> tuple:
    if ndim < 2:
        return ()
    for key, spec in _RULES:
        if key in name:
            # rank guard: an optimizer leaf of fewer dims than the rule
            # (Adafactor's factored statistics) stays whole
            return spec if len(spec) <= ndim else ()
    return ()


def param_partition_specs(params: dict) -> dict[str, tuple]:
    """Each parameter's spec by the rules (a tuple, JAX's
    ``PartitionSpec``; ``()`` whole)."""
    return {k: _spec_for(k, p.dim()) for k, p in params.items()}


def _split(shapes: dict[str, tuple], n: int) -> dict[str, layout.Shard]:
    out = {}
    if n <= 1:
        return out
    for k, shape in shapes.items():
        spec = _spec_for(k, len(shape))
        if not spec:
            continue
        dim = spec.index(_M)
        groups = 3 if any(q in k for q in _QKV) else 1
        if shape[dim] % (groups * n) == 0:
            out[k] = layout.Shard(_M, dim, tuple(shape), groups)
    return out


def shards_of(params: dict, n: int) -> dict[str, layout.Shard]:
    """The ``layout.Shard`` of each parameter the rules split over a model
    axis of ``n`` ranks (a dim that does not divide keeps it whole)."""
    return _split({k: tuple(p.shape) for k, p in params.items()}, n)


# the biases of the column-parallel products: a rank adds its rows' part
_COLUMN_BIASES = ("in_proj.bias", "linear1.bias", "fc1.bias")


def tp_parts(model, shapes: dict[str, tuple], n: int
             ) -> dict[str, layout.Shard]:
    """What the modules that split over a model axis of ``n`` ranks
    (``tp_splits``: the eligible ViT blocks, the encoder layers) compute
    on: the ``layout.Shard`` of each of their weights the rules split, and
    of the biases of their column-parallel products, by parameter name.
    ``shapes``: every parameter's whole shape.  The step hands the modules
    these parts (``layout.forward_params``)."""
    if n <= 1:
        return {}
    prefixes = tuple(f"{name}." for name, m in model.named_modules()
                     if hasattr(m, "tp_splits") and m.tp_splits(n))
    mine = {k: s for k, s in shapes.items() if prefixes
            and k.startswith(prefixes)}
    out = _split(mine, n)
    for k, shape in mine.items():
        if k.endswith(_COLUMN_BIASES):
            groups = 3 if k.endswith("in_proj.bias") else 1
            out[k] = layout.Shard(_M, 0, tuple(shape), groups)
    return out


def _tp(mesh) -> int:
    """The model axis' size where the Megatron rules apply: 1 on a mesh
    with a ``pipe`` axis, whose step takes the state whole (JAX's)."""
    if PIPE_AXIS in mesh.shape:
        return 1
    return mesh.shape.get(_M, 1)


def shard_train_state(state, mesh):
    """Shard a whole ``TrainState`` in place under the rules: each rank
    keeps its slice of each split parameter and of the moments that mirror
    it (Adam's ``mu``/``nu`` on the same rows as their parameter), and
    return it.  On a mesh without a model axis of more than one rank, or
    with a ``pipe`` axis, nothing is split."""
    shards = shards_of(state.params, _tp(mesh))
    if shards:
        axes = mesh.axes()
        layout.shard_state(state, shards,
                           lambda a: (axes[a].size, axes[a].index))
    return state


def shard_variables(variables: dict, mesh) -> dict[str, Any]:
    """``variables`` (``{"params": {name: tensor}, **collections}``) with
    each rule-split parameter replaced by this rank's slice (a new tensor);
    the other collections as they are."""
    out = dict(variables)
    if "params" in out:
        params = dict(out["params"])
        shards = shards_of(params, _tp(mesh))
        if shards:
            ax = mesh.axes()[_M]
            for k, sh in shards.items():
                params[k] = part(params[k], sh.dim, ax.size, ax.index,
                                 sh.groups).contiguous()
        out["params"] = params
    return out
