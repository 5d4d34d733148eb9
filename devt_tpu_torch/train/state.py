"""Train state: port of ``devt_tpu/train/state.py``.

The step count, the model's parameters, its mutable collections (buffers
such as BatchNorm statistics; ViViT has none) and the optimizer state.

Unlike the JAX pytree, which every step replaces, the state here is
updated **in place**: ``params`` are the model's own ``nn.Parameter``s by
name (``dict(model.named_parameters())``), ``model_state`` its persistent
buffers by name (``model_buffers(model)``), and ``apply_gradients`` adds
the optimizer's updates to the parameters, copies the step's new model
state into the buffers, and returns a state that shares their storage.
``step`` is a host integer: folding it into the randomness of a step and
into the schedules costs no device synchronisation.

A state sharded over a mesh (``parallel/fsdp.py``, ``parallel/sharding.py``)
holds only this rank's part of each sharded parameter and of the moments
that mirror it; ``shards`` maps those parameters to their
``parallel.layout.Shard`` (empty: every leaf whole).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


def _map_tensors(tree: Any, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def model_buffers(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The model's persistent buffers by ``state_dict`` name (BatchNorm
    running statistics): its mutable state, the counterpart of flax's
    collections other than ``params``."""
    params = {k for k, _ in model.named_parameters()}
    return {k: v for k, v in model.state_dict(keep_vars=True).items()
            if k not in params}


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict[str, torch.Tensor]
    model_state: dict[str, torch.Tensor]   # e.g. BatchNorm buffers; {} if none
    opt_state: Any
    tx: Any                                # train.optimizers.Chain
    shards: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def create(cls, params: dict[str, torch.Tensor], tx,
               model_state: dict[str, torch.Tensor] | None = None
               ) -> "TrainState":
        params = dict(params)
        return cls(step=0, params=params, model_state=dict(model_state or {}),
                   opt_state=tx.init(list(params.values())), tx=tx)

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def to(self, device) -> "TrainState":
        """Move parameters (in place, keeping the model's ``Parameter``
        objects), model state and optimizer state to ``device``."""
        device = torch.device(device)
        with torch.no_grad():
            for p in self.params.values():
                p.data = p.data.to(device)
            for b in self.model_state.values():
                b.data = b.data.to(device)
        self.opt_state = _map_tensors(self.opt_state,
                                      lambda t: t.to(device))
        return self

    def apply_gradients(self, grads: dict[str, torch.Tensor],
                        new_model_state: dict | None = None) -> "TrainState":
        """One optimizer update, in place; ``grads`` by parameter name,
        ``new_model_state`` (the step's new buffers, keyed like
        ``model_state``) copied into the state's buffers.  A sharded state
        updates its parts, its transformations seeing the whole leaves
        (the ``shards`` of ``optimizers.Chain.update``, inside the mesh's
        axis scope)."""
        params = list(self.params.values())
        shards = [self.shards.get(k) for k in self.params] \
            if self.shards else None
        with torch.no_grad():
            updates = self.tx.update([grads[k] for k in self.params],
                                     self.opt_state, params, shards)
            torch._foreach_add_(params, updates)
            for k, v in (new_model_state or {}).items():
                if k not in self.model_state:
                    raise KeyError(
                        f"the step updated buffer {k!r}, which the state "
                        f"does not hold: create it with "
                        f"model_state=model_buffers(model)")
                if v is not self.model_state[k]:
                    self.model_state[k].copy_(v)
        return dataclasses.replace(self, step=self.step + 1)
