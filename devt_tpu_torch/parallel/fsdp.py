"""Fully-sharded data parallelism (ZeRO-3) over the ``data`` mesh axis:
port of ``devt_tpu/parallel/fsdp.py``.

Every parameter and every optimizer moment that mirrors one lives sharded
over the data axis: each rank keeps one slice of it at rest.  The step
(``parallel/train_step.py``'s ``fsdp_shard_map`` executors) gathers the
parameters at the top of the loss (:func:`gather_params`: an
``all_gather`` along the sharded dim), runs the forward and backward on
the whole weights (the fused kernels 1 and 2 on the rank's rows), and
the gather's backward is the reduce-scatter of the gradients to their
owners; :func:`reduce_grads_to_shards` turns the sums into the
global-batch mean, and the optimizer then updates the local slices only.

The shape rule is JAX's: a leaf of two or more dims shards its largest
dim that the axis divides; smaller leaves (biases, norm scales, BatchNorm
statistics, scalars) stay whole.  The mesh's state lives as
``parallel.layout`` records it; optimizer leaves that do not mirror a
parameter (step counts, Adafactor's factored statistics) stay whole,
where JAX would shard a 2-D factored moment of a 3-D parameter by the
same shape rule: a difference of layout only.
"""

from __future__ import annotations

from typing import Any

import torch

from devt_tpu_torch.parallel import collectives, layout
from devt_tpu_torch.parallel.mesh import DATA_AXIS


def leaf_spec(shape, n_shards: int, axis: str = DATA_AXIS) -> tuple:
    """The partition spec (JAX's ``PartitionSpec`` as a tuple) sharding
    the largest dim divisible by ``n_shards``; ``()`` (whole) when none
    divides, for leaves of fewer than two dims, or for one shard."""
    shape = tuple(shape)
    if len(shape) < 2 or n_shards <= 1:
        return ()
    order = sorted(range(len(shape)), key=lambda i: shape[i], reverse=True)
    for i in order:
        if shape[i] >= n_shards and shape[i] % n_shards == 0:
            return tuple(axis if j == i else None for j in range(len(shape)))
    return ()


def state_partition_specs(tree, n_shards: int, axis: str = DATA_AXIS) -> Any:
    """Specs mirroring ``tree`` (dicts, lists and tensors) under the shape
    rule; non-tensor leaves get ``()``."""
    if isinstance(tree, torch.Tensor):
        return leaf_spec(tree.shape, n_shards, axis)
    if isinstance(tree, dict):
        return {k: state_partition_specs(v, n_shards, axis)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_partition_specs(v, n_shards, axis)
                          for v in tree)
    return ()


def train_state_specs(state, n_shards: int, axis: str = DATA_AXIS) -> dict:
    """The state's specs for the ``fsdp_shard_map`` strategy: parameters by
    the shape rule, the moments that mirror a parameter with it, the step
    counter, every other optimizer leaf and the model state (BatchNorm
    statistics, which the step averages) whole."""
    params = {k: leaf_spec(p.shape, n_shards, axis)
              for k, p in state.params.items()}
    return {"step": (), "params": params,
            "model_state": {k: () for k in state.model_state},
            "opt_state": _mirror_specs(state, params)}


def _mirror_specs(state, params: dict) -> Any:
    """The optimizer state's specs: a moment with its parameter's shape
    (``layout.mirrors``) takes the parameter's spec, every other leaf
    ``()``."""
    mirrored = {id(tree[i]): params[name]
                for tree, i, name in layout.mirrors(state)
                if layout.is_mirror(tree[i], state.params[name].shape)}

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return mirrored.get(id(tree), ())

    return walk(state.opt_state)


def shards_of(params: dict, n_shards: int,
              axis: str = DATA_AXIS) -> dict[str, layout.Shard]:
    """The ``layout.Shard`` of each parameter the shape rule shards."""
    out = {}
    for k, p in params.items():
        spec = leaf_spec(p.shape, n_shards, axis)
        if spec:
            out[k] = layout.Shard(axis, spec.index(axis), tuple(p.shape))
    return out


def gather_params(params: dict, shards: dict,
                  axis: str = DATA_AXIS) -> dict:
    """Each sharded parameter gathered whole (inside the axis'
    ``collectives.axis_scope``).  Differentiating through this IS the
    ZeRO-3 gradient reduce-scatter: the backward sums every rank's
    cotangent and keeps this rank's slice; finish with
    :func:`reduce_grads_to_shards`."""
    return layout.forward_params(
        params, {k: s for k, s in shards.items() if s.axis == axis})


def reduce_grads_to_shards(grads: dict, shards: dict, n_shards: int,
                           axis: str = DATA_AXIS) -> dict:
    """Global-batch-mean gradients on the local slices: the sharded leaves
    arrived as the reduce-scatter's SUM over the ranks, so they are divided
    by n; the whole leaves carry only this rank's gradient, so they take
    the mean over the axis (one coalesced all-reduce per dtype)."""
    out = dict(grads)
    whole = [k for k in grads
             if k not in shards or shards[k].axis != axis]
    for k in grads:
        if k not in whole:
            out[k] = grads[k] / n_shards
    for k, g in zip(whole, collectives.pmean([grads[k] for k in whole],
                                             axis)):
        out[k] = g
    return out


def shard_train_state(state, mesh, axis: str = DATA_AXIS):
    """Shard a whole ``TrainState`` over the mesh's ``axis`` in place (each
    rank keeps its slice of each sharded parameter and mirrored moment) and
    return it.  The ``fsdp_shard_map`` step then keeps it sharded end to
    end."""
    n = mesh.shape.get(axis, 1)
    axes = mesh.axes()
    layout.shard_state(state, shards_of(state.params, n, axis),
                       lambda a: (axes[a].size, axes[a].index))
    return state
