"""Meshes and the step executors: one device, or data parallel, FSDP,
tensor, pipeline, sequence and expert parallel over ``torch.distributed``
process groups (``mesh``, ``distributed``, ``collectives``,
``train_step``, ``fsdp``, ``sharding``, ``tp_block``, ``layout``,
``pipeline``, ``ring_attention``, ``moe``).

The exports resolve on first use: the models import
``parallel.collectives``, and the executors import the models.
"""

import importlib

_EXPORTS = {
    "make_mesh": "mesh", "batch_spec": "mesh", "replicated_spec": "mesh",
    "make_train_step": "train_step", "make_eval_step": "train_step",
    "param_partition_specs": "sharding", "shard_variables": "sharding",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
