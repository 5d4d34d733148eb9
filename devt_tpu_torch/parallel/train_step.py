"""Train/eval step executors with grad accumulation, single device.

Port of ``devt_tpu/parallel/train_step.py`` for one device.  The JAX
executors are jitted XLA programs; PyTorch runs eagerly, so a step is a
Python function that enqueues its kernels and returns device tensors
without waiting for them:

  * ``make_train_step``: one full step, forward + backward + optimizer
    update, on the state's tensors **in place** (the JAX step donates its
    state; here the model's parameters and the moments are overwritten);
  * grad accumulation over ``config.accum_steps`` microbatches: grads
    summed in f32 and divided, the loss a microbatch mean;
  * ``make_multi_step``: ``n_steps`` full steps over a stacked batch, the
    metrics their mean, with no host synchronisation inside;
  * ``make_eval_step``: loss and aux without gradients.

Randomness: JAX folds ``state.step`` into the step's key, so a step's
dropout depends only on (rng, step).  Here ``rng`` is an integer seed and
every step (and microbatch) makes its ``DropoutRng`` from (seed, step,
microbatch), never from what earlier steps drew.

The executors run on ``cuda`` unless the caller passes ``device="cpu"``,
and raise when there is no card.  A ``mesh`` other than None raises: the
data-, tensor-, pipeline- and sequence-parallel strategies are queued
(ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch
from torch import nn

from devt_tpu_torch.config import Config
from devt_tpu_torch.models.layers import DropoutRng
from devt_tpu_torch.serve import resolve_device
from devt_tpu_torch.train.state import TrainState
from devt_tpu_torch.train.steps import forward_and_loss

_SCALAR_AUX = ("base_loss", "distil_loss", "cossim", "moe_aux")


def _split_microbatches(batch: Mapping[str, torch.Tensor], accum: int):
    def split(x):
        b = x.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by accum {accum}")
        return x.reshape((accum, b // accum) + tuple(x.shape[1:]))
    return {k: split(v) for k, v in batch.items()}


def step_seed(rng: int, step: int, microbatch: int = 0) -> int:
    """The seed of one step's (and microbatch's) randomness: a mix of the
    three integers (splitmix64's finalizer), below 2**63."""
    z = (int(rng) * 0x9E3779B97F4A7C15 + int(step) * 0xBF58476D1CE4E5B9
         + int(microbatch) * 0x94D049BB133111EB + 1) & (2 ** 64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2 ** 64 - 1)
    return (z ^ (z >> 31)) >> 1


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "step executors over a mesh (data, tensor, pipeline and "
            "sequence parallel) are not ported yet — ROADMAP.md queue 1, "
            "item 7; pass mesh=None")


def _to_device(batch: Mapping, device: torch.device) -> dict:
    def place(v):
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        return v.to(device, non_blocking=True)
    return {k: place(v) for k, v in batch.items()}


def _make_step_body(model: nn.Module, config: Config) -> Callable:
    """``(state, batch, rng) -> (state, metrics)``: one full forward +
    backward + update on device tensors.  Shared by the single-step and
    multi-step executors."""
    accum = max(config.accum_steps, 1)

    def grads_of(state: TrainState, model_state, batch, seed: int):
        names = list(state.params)
        leaves = [state.params[k] for k in names]
        for p in leaves:
            p.requires_grad_(True)
        variables = {"params": state.params, **model_state}
        loss, aux, new_ms = forward_and_loss(
            model, config, variables, batch, DropoutRng(seed), train=True)
        # a leaf the loss does not reach (FrameTransformer's frozen image
        # side, an unused CLS input) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), aux, new_ms, dict(zip(names, grads))

    def train_step(state: TrainState, batch, rng: int):
        if accum == 1:
            loss, aux, new_ms, grads = grads_of(
                state, state.model_state, batch, step_seed(rng, state.step))
            aux = {k: aux[k].detach() for k in _SCALAR_AUX if k in aux}
        else:
            micro = _split_microbatches(batch, accum)
            grads = {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in state.params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=state.device)
            stacked: dict[str, list] = {}
            # each microbatch sees the model state (BatchNorm statistics)
            # the one before it left, as the JAX scan carries it
            new_ms = state.model_state
            for i in range(accum):
                mb = {k: v[i] for k, v in micro.items()}
                l, a, new_ms, g = grads_of(
                    state, new_ms, mb, step_seed(rng, state.step, i + 1))
                torch._foreach_add_(list(grads.values()),
                                    [g[k] for k in grads])
                loss = loss + l
                for k in _SCALAR_AUX:
                    if k in a:
                        stacked.setdefault(k, []).append(a[k].detach())
            torch._foreach_div_(list(grads.values()), accum)
            loss = loss / accum
            # scalar diagnostics survive accumulation as the microbatch mean
            aux = {k: torch.stack(v).mean() for k, v in stacked.items()}
        new_state = state.apply_gradients(grads, new_ms)
        return new_state, {"loss": loss, **aux}

    return train_step


def _placed(model: nn.Module, state: TrainState, device: torch.device
            ) -> TrainState:
    """The state on the executor's device; the model follows, since the
    state's parameters are the model's."""
    def elsewhere(d: torch.device) -> bool:     # "cuda" is "cuda:0" here
        return d.type != device.type or (d.index or 0) != (device.index or 0)

    if elsewhere(state.device):
        state.to(device)
    first = next(model.parameters(), None)
    if first is not None and elsewhere(first.device):
        model.to(device)
    return state


def make_train_step(model: nn.Module, config: Config, mesh=None,
                    device: str | torch.device | None = None) -> Callable:
    """Returns ``train_step(state, batch, rng) -> (state, metrics)``.

    ``state``: a ``TrainState`` whose ``params`` are ``model``'s
    (``dict(model.named_parameters())``); it is moved to the device on the
    first call and updated in place.  ``batch``: tensors or numpy arrays
    with a leading batch axis.  ``rng``: an integer seed.  ``metrics`` are
    device scalars; reading one (``float(metrics["loss"])``) waits for the
    step."""
    _no_mesh(mesh)
    device = resolve_device(device)
    body = _make_step_body(model, config)

    def train_step(state: TrainState, batch, rng: int):
        state = _placed(model, state, device)
        return body(state, _to_device(batch, device), rng)

    return train_step


def make_multi_step(model: nn.Module, config: Config, n_steps: int,
                    mesh=None,
                    device: str | torch.device | None = None) -> Callable:
    """Returns ``multi_step(state, batches, rng) -> (state, metrics)``
    running ``n_steps`` full train steps.

    ``batches`` is a stacked batch with leading axis ``n_steps``.  Per-step
    randomness folds ``state.step`` into ``rng``, identical to ``n_steps``
    separate calls.  The returned metrics are the per-step values reduced
    to their mean, on the device: nothing inside waits for the card, so
    the host runs ahead of it by up to ``n_steps`` steps."""
    _no_mesh(mesh)
    device = resolve_device(device)
    body = _make_step_body(model, config)

    def multi_step(state: TrainState, batches, rng: int):
        state = _placed(model, state, device)
        batches = _to_device(batches, device)
        for v in batches.values():
            if v.shape[0] != n_steps:
                raise ValueError(f"stacked batch has {v.shape[0]} steps, "
                                 f"expected {n_steps}")
        stacked: dict[str, list] = {}
        for i in range(n_steps):
            state, metrics = body(
                state, {k: v[i] for k, v in batches.items()}, rng)
            for k, v in metrics.items():
                stacked.setdefault(k, []).append(v)
        return state, {k: torch.stack(v).mean(dim=0)
                       for k, v in stacked.items()}

    return multi_step


def make_eval_step(model: nn.Module, config: Config, mesh=None,
                   device: str | torch.device | None = None) -> Callable:
    """Returns ``eval_step(state, batch) -> (loss, aux)``, the
    validation/test step feeding the epoch-end evaluators."""
    _no_mesh(mesh)
    device = resolve_device(device)

    def eval_step(state: TrainState, batch):
        state = _placed(model, state, device)
        variables = {"params": state.params, **state.model_state}
        with torch.no_grad():
            loss, aux, _ = forward_and_loss(
                model, config, variables, _to_device(batch, device),
                rng=None, train=False)
        return loss, aux

    return eval_step
