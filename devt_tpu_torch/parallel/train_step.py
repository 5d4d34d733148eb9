"""Train/eval step executors with grad accumulation, one device or data
parallel: port of ``devt_tpu/parallel/train_step.py``.

The JAX executors are jitted XLA programs; PyTorch runs eagerly, so a
step is a Python function that enqueues its kernels and returns device
tensors without waiting for them:

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

Data parallelism (``mesh=``, ``parallel/mesh.py``).  JAX runs its DP step
as one program under ``shard_map`` over the ``data`` axis; here one
process runs each rank (``parallel/distributed.py``) and calls the same
executor.  Its batch is the rank's own rows of the global batch
(``mesh.shard_batch``).  Like JAX's body, the step folds the rank into its
seed (each rank draws its own dropout masks), runs its forward and
backward (the fused kernels on the rank's rows), and after accumulation
takes the mean over the ranks of the gradients, the loss, the scalar aux
and the float model state, in one coalesced all-reduce per dtype
(``parallel/collectives.py``), so that every rank applies the same
update to the same parameters.  The contrastive encoder's BatchNorm
statistics are synced across the ranks and its NT-Xent negatives
gathered from all of them (``_sync_bn``, ``train/steps.py``), so its DP
step is the single-device global-batch step; the conv backbones keep
per-rank batch statistics and average the running ones, as JAX does.
The eval step gathers the per-sample aux rows in rank order.  Explicit
collectives rather than ``DistributedDataParallel``: the body takes its
gradients with ``torch.autograd.grad``, which DDP's reducer does not see.

FSDP (``dp_mode="fsdp"``, strategy ``fsdp_shard_map``): the state lives
sharded over ``data`` (``parallel/fsdp.py``: each rank keeps a slice of
each parameter and moment).  The step gathers the parameters at the top
of the loss, runs the forward and backward on them (the fused kernels on
the rank's rows), and the gather's backward reduce-scatters the gradients;
the sharded leaves' sums are divided by the ranks, the whole leaves'
averaged, and the optimizer updates the local slices.

Tensor parallelism and the GSPMD formulations (strategy ``gspmd``: ``mp``
> 1, ``dp_mode`` ``"gspmd"`` or ``"fsdp_gspmd"``, or ``"fsdp"`` with
global-norm clipping or Adafactor).  JAX partitions one global program;
here every rank runs its part of the same step, with the values of the
one-device step on the global batch, as GSPMD's are: the batch's rows
over ``data`` (every BatchNorm synced over it, the contrastive negatives
gathered), the state as it was placed (``sharding.shard_train_state``'s
Megatron layout over ``model``, ``fsdp.shard_train_state``'s over
``data``).  With a model axis of more than one rank and ``attention_impl
"auto"`` the step runs inside ``ops.attention.tp_pallas_scope``: the
transformer blocks whose heads divide over the axis compute on their
slices (the eligible ViT blocks as ``parallel/tp_block.py``'s block,
kernel 3 on the rank's heads); every other sharded weight is gathered
whole for its module.  The gradients stay in the state's layout, the
clip's global norm and Adafactor's factored statistics are the whole
tree's (the optimizer is handed the state's ``shards``).

Expert parallelism (``config.moe_ep`` on a data-parallel mesh): the DP
step runs inside ``parallel.moe.moe_ep_scope`` over ``data``, so the MoE
blocks whose experts divide over the ranks compute E/n experts a rank
(``moe_ffn_ep_rows``, two ``all_to_all`` exchanges a block); a rank's
gradient of an expert leaf is zero outside its experts, and the DP mean
gives the dense update.  MoE blocks on a model axis (``gspmd``): the
expert leaves stay split over ``model`` at rest and are gathered whole for
their block.

Pipeline parallelism (``pp_shard_map``: a ``pipe`` axis, on a (data, pipe)
or the 3-D (data, pipe, model) mesh): the state is whole on every rank
and the batch is the rank's data rows, as JAX's shard_map places them;
the step runs inside ``parallel.pipeline.pipeline_scope``, so the stacked
ViViT stack runs the GPipe schedule over ``pipe`` (on a model axis each
stage as the tensor-parallel block).  After the data mean the gradients
are reduced as JAX's body reduces them: the ``pb_*`` leaves summed over
``pipe`` (each stage holds its own slice's), every other leaf averaged;
on a model axis the five leaves a rank cuts its slice of (``pb_wqkv``,
``pb_wo``, ``pb_w1``, ``pb_bb1``, ``pb_w2``) summed over ``model``,
every other leaf averaged.  Sequence parallelism (``sp_shard_map``: a
(data, seq) mesh): the step runs inside ``parallel.ring_attention.
sp_scope``, the stacked stack runs on the rank's chunk of the tokens with
the kv ring over ``seq``, and every gradient, the loss and the aux are
averaged over ``seq`` (exact: the stack's closing gather hands each rank
the sum of the ranks' cotangents of its chunk).

A mesh of one rank runs the single-device step, bit for bit.

The executors run on ``cuda`` unless the caller passes ``device="cpu"``,
and raise when there is no card.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Mapping

import numpy as np
import torch
from torch import nn

from devt_tpu_torch.config import Config
from devt_tpu_torch.models.layers import DropoutRng
from devt_tpu_torch.models.resnet import BatchNorm
from devt_tpu_torch.ops.attention import tp_pallas_scope
from devt_tpu_torch.parallel import collectives, fsdp, layout, sharding
from devt_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS,
                                          SEQ_AXIS)
from devt_tpu_torch.parallel.moe import moe_ep_scope
from devt_tpu_torch.parallel.pipeline import pipeline_scope
from devt_tpu_torch.parallel.ring_attention import sp_scope
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


# the rank's tag in ``step_seed``'s microbatch slot: above any microbatch
_RANK_TAG = 2 ** 32


def rank_seed(rng: int, index: int) -> int:
    """The seed of rank ``index``'s steps (JAX folds ``axis_index`` into
    the step's key): distinct dropout masks on every rank."""
    return step_seed(rng, index, _RANK_TAG)


def mesh_strategy(mesh, config: Config | None = None) -> str:
    """Execution strategy for a mesh, as JAX's picks it: ``single`` |
    ``dp_shard_map`` | ``fsdp_shard_map`` | ``pp_shard_map`` |
    ``sp_shard_map`` | ``gspmd``.  A mesh of one rank is ``single``."""
    if mesh is None or mesh.size == 1:
        return "single"
    shape = dict(mesh.shape)
    if shape.get(PIPE_AXIS, 1) > 1:
        return "pp_shard_map"
    if shape.get(SEQ_AXIS, 1) > 1:
        return "sp_shard_map"
    if shape.get(MODEL_AXIS, 1) > 1 or DATA_AXIS not in shape:
        return "gspmd"
    mode = getattr(config, "dp_mode", "auto") if config is not None \
        else "auto"
    if mode == "fsdp":
        clip = getattr(config, "grad_clip_norm", 0.0)
        # Adafactor's factored statistics and the clip's global norm are
        # the whole tree's: JAX leaves them to its gspmd trace
        adafactor = getattr(config, "opt", "adamW") == "adafactor"
        return ("gspmd" if (clip and clip > 0.0) or adafactor
                else "fsdp_shard_map")
    if mode in ("gspmd", "fsdp_gspmd"):
        return "gspmd"
    return "dp_shard_map"


# the stacked leaves a 3-D stage cuts its model-axis slice of
_TP_SLICED = frozenset({"pb_wqkv", "pb_wo", "pb_w1", "pb_bb1", "pb_w2"})


@dataclasses.dataclass(frozen=True)
class _Plan:
    """What a mesh's step does: ``strategy``; ``data``: it reduces over a
    data axis of more than one rank; ``tp``: the model axis' size when the
    step runs inside ``tp_pallas_scope`` (0: it does not); ``ep``: the
    data axis' size when the MoE blocks run expert-parallel over it (0:
    they do not); ``pipe_tp``: a pipeline step on a model axis of more
    than one rank (the 3-D mesh)."""
    strategy: str
    data: bool = False
    tp: int = 0
    ep: int = 0
    pipe_tp: bool = False


def _plan(mesh, config: Config) -> _Plan:
    """The mesh's plan."""
    strategy = mesh_strategy(mesh, config)
    if strategy == "single":
        return _Plan(strategy)
    shape = mesh.shape
    mp, dp = shape.get(MODEL_AXIS, 1), shape.get(DATA_AXIS, 1)
    tp = mp if (strategy == "gspmd" and mp > 1
                and getattr(config, "attention_impl", "auto") == "auto") \
        else 0
    ep = dp if (strategy == "dp_shard_map" and dp > 1
                and getattr(config, "moe_ep", False)) else 0
    return _Plan(strategy, data=dp > 1, tp=tp, ep=ep,
                 pipe_tp=strategy == "pp_shard_map" and mp > 1)


def _tp_parts(model: nn.Module, state: TrainState, tp: int) -> dict:
    """The parts the tensor-parallel modules compute on
    (``sharding.tp_parts``) over a model axis of ``tp`` ranks; none when
    the step runs outside ``tp_pallas_scope`` (``tp`` 0)."""
    if not tp:
        return {}
    shapes = {k: state.shards[k].shape if k in state.shards
              else tuple(p.shape) for k, p in state.params.items()}
    return sharding.tp_parts(model, shapes, tp)


@contextlib.contextmanager
def _sync_bn(model: nn.Module, every: bool = False):
    """Models exposing a ``bn_sync_axis`` knob (the contrastive encoder)
    get cross-replica synced BatchNorm inside the DP step, as JAX's
    ``_sync_bn`` clones them with ``bn_sync_axis=DATA_AXIS``: the
    global-negatives NT-Xent loss sees the activations of a single-device
    global-batch step.  Conv backbones keep per-replica batch statistics.
    ``every``: every BatchNorm synced (the gspmd step: GSPMD's batch
    statistics are the global batch's).  The knobs are set for the
    ``with`` and restored after it."""
    norms = [m for m in model.modules()
             if isinstance(m, BatchNorm) and m.axis_name is None] \
        if every else []
    knob = not every and getattr(model, "bn_sync_axis", "absent") is None
    for m in norms:
        m.axis_name = DATA_AXIS
    if knob:
        model.bn_sync_axis = DATA_AXIS
    try:
        yield
    finally:
        for m in norms:
            m.axis_name = None
        if knob:
            model.bn_sync_axis = None


def _pmean_step(grads: dict, loss, aux: dict, new_ms: dict,
                axis_name: str, shards: dict):
    """The DDP reduction, explicit: the gradients made the global batch's
    (``fsdp.reduce_grads_to_shards``: the mean over the axis, or for
    leaves sharded over it the reduce-scatter's sums divided by the
    ranks), then the mean of the loss, the scalar aux and the float model
    state in one coalesced all-reduce per dtype."""
    grads = fsdp.reduce_grads_to_shards(
        grads, shards, collectives.axis(axis_name).size, axis_name)
    parts = {"loss": {"": loss}, "aux": dict(aux),
             "ms": {k: v for k, v in new_ms.items()
                    if v.is_floating_point()}}
    keys = [(p, k) for p, d in parts.items() for k in d]
    means = collectives.pmean([parts[p][k] for p, k in keys], axis_name)
    for (p, k), m in zip(keys, means):
        parts[p][k] = m
    return grads, parts["loss"][""], parts["aux"], {**new_ms, **parts["ms"]}


def _reduce_axes(grads: dict, loss, aux: dict, new_ms: dict, plan: _Plan):
    """The pipe, model and seq reductions of JAX's step body, after the
    data mean.  ``pp_shard_map``: the ``pb_*`` gradients summed over
    ``pipe``, the others averaged, and on the 3-D mesh the leaves a stage
    cuts its model slice of summed over ``model``, the others averaged;
    ``sp_shard_map``: everything averaged over ``seq``.  The loss, the
    scalar aux and the float model state are averaged over the axes."""
    if plan.strategy == "pp_shard_map":
        rules = [(PIPE_AXIS, lambda k: any(
            seg.startswith("pb_") for seg in k.split(".")))]
        if plan.pipe_tp:
            rules.append((MODEL_AXIS, lambda k: any(
                seg in _TP_SLICED for seg in k.split("."))))
    elif plan.strategy == "sp_shard_map":
        rules = [(SEQ_AXIS, lambda k: False)]
    else:
        return grads, loss, aux, new_ms
    grads = dict(grads)
    for axis_name, summed in rules:
        for reduce, keys in ((collectives.psum, [k for k in grads
                                                 if summed(k)]),
                             (collectives.pmean, [k for k in grads
                                                  if not summed(k)])):
            for k, g in zip(keys, reduce([grads[k] for k in keys],
                                         axis_name)):
                grads[k] = g
        floats = {k: v for k, v in new_ms.items() if v.is_floating_point()}
        keys = list(aux)
        means = collectives.pmean(
            [loss, *(aux[k] for k in keys), *floats.values()], axis_name)
        loss = means[0]
        aux = dict(zip(keys, means[1:1 + len(keys)]))
        new_ms = {**new_ms, **dict(zip(floats, means[1 + len(keys):]))}
    return grads, loss, aux, new_ms


def _to_device(batch: Mapping, device: torch.device) -> dict:
    def place(v):
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        return v.to(device, non_blocking=True)
    return {k: place(v) for k, v in batch.items()}


def _make_step_body(model: nn.Module, config: Config,
                    plan: _Plan) -> Callable:
    """``(state, batch, rng) -> (state, metrics)``: one full forward +
    backward + update on device tensors.  Shared by the single-step and
    multi-step executors.

    Over a mesh (called inside the mesh's ``collectives.axis_scope``): the
    forward runs on ``layout.forward_params`` of the state (sharded leaves
    gathered, or the rank's slices for the blocks that split over the
    model axis); with ``plan.data`` the seed mixes in the rank's data
    index, and the gradients, loss, scalar aux and model state are the
    mean over the data axis before the update, so every rank applies the
    global-batch update to its parameters or its slices of them."""
    accum = max(config.accum_steps, 1)
    axis_name = DATA_AXIS if plan.data else None

    def grads_of(state: TrainState, model_state, batch, seed: int):
        names = list(state.params)
        leaves = [state.params[k] for k in names]
        for p in leaves:
            p.requires_grad_(True)
        tensors = layout.forward_params(
            state.params, state.shards,
            _tp_parts(model, state, plan.tp))
        variables = {"params": tensors, **model_state}
        loss, aux, new_ms = forward_and_loss(
            model, config, variables, batch, DropoutRng(seed), train=True,
            axis_name=axis_name)
        # a leaf the loss does not reach (FrameTransformer's frozen image
        # side, an unused CLS input) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), aux, new_ms, dict(zip(names, grads))

    def train_step(state: TrainState, batch, rng: int):
        if axis_name is not None:
            rng = rank_seed(rng, collectives.axis(axis_name).index)
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
        if axis_name is not None:
            grads, loss, aux, new_ms = _pmean_step(grads, loss, aux, new_ms,
                                                   axis_name, state.shards)
        grads, loss, aux, new_ms = _reduce_axes(grads, loss, aux, new_ms,
                                                plan)
        new_state = state.apply_gradients(grads, new_ms)
        return new_state, {"loss": loss, **aux}

    return train_step


def _placed(model: nn.Module, state: TrainState, device: torch.device
            ) -> TrainState:
    """The state on the executor's device; the model follows, since the
    state's parameters are the model's."""
    index = device.index
    if device.type == "cuda" and index is None:     # "cuda": the current
        index = torch.cuda.current_device()

    def elsewhere(d: torch.device) -> bool:
        return d.type != device.type or (d.index or 0) != (index or 0)

    if elsewhere(state.device):
        state.to(device)
    first = next(model.parameters(), None)
    if first is not None and elsewhere(first.device):
        model.to(device)
    return state


def _scope(model: nn.Module, mesh, plan: _Plan):
    """The context a mesh's step runs in: the mesh's axes bound by name;
    the contrastive encoder's BatchNorm synced under the DP and FSDP steps,
    every BatchNorm under the gspmd step over a data axis; the
    tensor-parallel, expert-parallel, pipeline or sequence-parallel scope.
    Nothing for one device."""
    if plan.strategy == "single":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(collectives.axis_scope(mesh.axes()))
    if plan.strategy in ("dp_shard_map", "fsdp_shard_map"):
        stack.enter_context(_sync_bn(model))
    elif plan.strategy == "gspmd" and plan.data:
        stack.enter_context(_sync_bn(model, every=True))
    if plan.tp:
        stack.enter_context(tp_pallas_scope(mesh))
    if plan.ep:
        stack.enter_context(moe_ep_scope(DATA_AXIS, plan.ep))
    if plan.strategy == "pp_shard_map":
        stack.enter_context(pipeline_scope(mesh))
    if plan.strategy == "sp_shard_map":
        stack.enter_context(sp_scope(mesh))
    return stack


def make_train_step(model: nn.Module, config: Config, mesh=None,
                    device: str | torch.device | None = None) -> Callable:
    """Returns ``train_step(state, batch, rng) -> (state, metrics)``.

    ``state``: a ``TrainState`` whose ``params`` are ``model``'s
    (``dict(model.named_parameters())``); it is moved to the device on the
    first call and updated in place.  ``batch``: tensors or numpy arrays
    with a leading batch axis; over a ``mesh``, this rank's rows of the
    global batch (``mesh.shard_batch``: the ranks of one data index share
    theirs), the state as ``Trainer`` places it (whole, or sharded by
    ``parallel/fsdp.py`` or ``parallel/sharding.py``), and every rank calls
    the step.  ``rng``: an integer seed.  ``metrics`` are device scalars;
    reading one (``float(metrics["loss"])``) waits for the step."""
    plan = _plan(mesh, config)
    device = resolve_device(device)
    body = _make_step_body(model, config, plan)

    def train_step(state: TrainState, batch, rng: int):
        state = _placed(model, state, device)
        with _scope(model, mesh, plan):
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
    the host runs ahead of it by up to ``n_steps`` steps.  Over a ``mesh``
    the batches are this rank's rows of each step's global batch (axis 1),
    and each step reduces over the ranks."""
    plan = _plan(mesh, config)
    device = resolve_device(device)
    body = _make_step_body(model, config, plan)

    def multi_step(state: TrainState, batches, rng: int):
        state = _placed(model, state, device)
        batches = _to_device(batches, device)
        for v in batches.values():
            if v.shape[0] != n_steps:
                raise ValueError(f"stacked batch has {v.shape[0]} steps, "
                                 f"expected {n_steps}")
        stacked: dict[str, list] = {}
        with _scope(model, mesh, plan):
            for i in range(n_steps):
                state, metrics = body(
                    state, {k: v[i] for k, v in batches.items()}, rng)
                for k, v in metrics.items():
                    stacked.setdefault(k, []).append(v)
        return state, {k: torch.stack(v).mean(dim=0)
                       for k, v in stacked.items()}

    return multi_step


def _replicate_aux(aux: dict, axis_name: str) -> dict:
    """The eval aux of the global batch: scalars the mean over the ranks,
    per-sample rows gathered in rank order (the global batch's order)."""
    out = {}
    for k, v in aux.items():
        if not isinstance(v, torch.Tensor):
            out[k] = v
        elif v.dim() == 0:
            out[k] = collectives.pmean([v], axis_name)[0]
        else:
            out[k] = collectives.all_gather_rows(v, axis_name)
    return out


def make_eval_step(model: nn.Module, config: Config, mesh=None,
                   device: str | torch.device | None = None) -> Callable:
    """Returns ``eval_step(state, batch) -> (loss, aux)``, the
    validation/test step feeding the epoch-end evaluators.

    Over a ``mesh`` ``batch`` is this rank's rows, the state is placed as
    for the train step (a sharded one's parameters gathered, or the rank's
    slices for the tensor-parallel blocks), and over a data axis the
    results are the global batch's on every rank: the loss and scalar aux
    the mean over the ranks, the per-sample aux rows (``probs``,
    ``label``, ``embedding``) gathered in rank order, and the contrastive
    loss scored against the negatives of every rank."""
    plan = _plan(mesh, config)
    device = resolve_device(device)
    axis_name = DATA_AXIS if plan.data else None

    def eval_step(state: TrainState, batch):
        state = _placed(model, state, device)
        with torch.no_grad(), _scope(model, mesh, plan):
            tensors = layout.forward_params(
                state.params, state.shards,
                _tp_parts(model, state, plan.tp))
            loss, aux, _ = forward_and_loss(
                model, config, {"params": tensors, **state.model_state},
                _to_device(batch, device), rng=None, train=False,
                axis_name=axis_name)
            if axis_name is None:
                return loss, aux
            loss = collectives.pmean([loss], axis_name)[0]
            # the pipeline's and the ring's outputs are the same on every
            # rank of pipe, model and seq: a mean there is a consistency
            # no-op, as in JAX's eval body
            for name in (PIPE_AXIS, MODEL_AXIS, SEQ_AXIS):
                if plan.strategy in ("pp_shard_map", "sp_shard_map") \
                        and mesh.shape.get(name, 1) > 1:
                    loss = collectives.pmean([loss], name)[0]
            return loss, _replicate_aux(aux, axis_name)

    return eval_step
