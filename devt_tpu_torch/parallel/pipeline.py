"""GPipe pipeline parallelism over the ``pipe`` mesh axis: port of
``devt_tpu/parallel/pipeline.py``.

A stack of identical blocks is cut into S stages, one a rank of the
``pipe`` axis, and microbatches stream through JAX's fill/drain schedule:

  * ``M + S - 1`` ticks; each tick every rank runs its stage once, stage 0
    on microbatch t of the input stream, every later stage on what its
    predecessor handed it at the end of the last tick;
  * bubble ticks (a stage with no microbatch yet, or none left) compute
    on zeros and their output is masked to zeros, so every rank runs the
    same program every tick;
  * the last stage banks microbatch ``t - (S - 1)``; every other stage
    banks zeros, and a closing sum over ``pipe`` puts the last stage's
    stream on every stage;
  * the handoff is ``collectives.shift``: every rank sends to the next
    index round the ring and receives from the one before, index 0
    zeroing what it receives, so all ranks post the same exchange every
    tick, forward and backward (Gloo matches sends and receives by peer
    and order: a rank that skipped one would hang the others).

JAX differentiates the schedule through ``shard_map``; here autograd
replays the ticks in reverse on every rank.  The selections that depend
on the stage (stage 0's input, the bubble masks, the last stage's bank)
are ``torch.where`` on the same operands on every rank, and the stage
runs every tick, so every rank's autograd graph has the same nodes in the
same order and replays the same exchanges.

The gradients, as ``parallel/train_step.py`` reduces them (``pb_*``
leaves summed over ``pipe``, every other leaf averaged):

  * the input stream enters through ``collectives.copy_to`` (the
    identity; its backward sums the cotangents over ``pipe``): only stage
    0 reads it, and the sum hands every stage stage 0's gradient, so the
    layers before the pipeline get the same gradient on every stage;
  * the closing sum is ``collectives.reduce_from`` (its backward the
    identity): every stage computes the same loss from the same output,
    and each stage's blocks get their own share of the gradient, zero on
    the other stages' slices of the stacked leaves, which the sum over
    ``pipe`` puts together.

JAX's ``psum`` transposes to a ``psum`` under ``check_vma=False``, which
hands its blocks S times their gradient (ROADMAP.md queue 3); the port's
pair gives the one-device step's.

Every tick's stage is rematerialised (JAX's default ``remat=True``, a
``jax.checkpoint`` of the stage, which no caller turns off): no
activation of a tick is kept for the backward, which runs the stage
again, with the mesh's axes bound as in the forward (for CUDA tensors
autograd runs the backward on a thread of its own).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from devt_tpu_torch.parallel import collectives

PIPE_AXIS = "pipe"

_pp_gate = threading.local()


@contextlib.contextmanager
def pipeline_scope(mesh):
    """Context in which ``ViTTransformer`` (``models/layers.py``) runs its
    stacked block stack through :func:`pipeline_apply` over ``mesh``'s
    ``pipe`` axis (the pp step factories set it around the step).
    Re-entrant, thread-local, bounded by the ``with``."""
    prev = getattr(_pp_gate, "mesh", None)
    _pp_gate.mesh = mesh
    try:
        yield
    finally:
        _pp_gate.mesh = prev


def active_pipe_mesh():
    """The mesh set by :func:`pipeline_scope`, or None."""
    return getattr(_pp_gate, "mesh", None)


def stage_params(stacked_local) -> Any:
    """This rank's stage of a ``(1, ...)``-stacked parameter dict: the
    leading stage axis stripped."""
    return {k: v[0] for k, v in stacked_local.items()}


def pipeline_apply(block_fn: Callable, params_local, x_micro: torch.Tensor,
                   *, axis_name: str = PIPE_AXIS,
                   n_stages: int) -> torch.Tensor:
    """The GPipe schedule on this rank (inside the axes'
    ``collectives.axis_scope``).

    ``block_fn(params, x) -> y``: one stage (same shape in and out).
    ``params_local``: this rank's stage parameters.  ``x_micro``: the
    microbatch stream ``(M, mb, ...)``, the same on every stage; stage 0
    consumes it.  Returns the ``(M, mb, ...)`` output stream, stage
    S - 1's, on every stage."""
    ax = collectives.axis(axis_name)
    if ax.size != n_stages:
        raise ValueError(f"{n_stages} stages over a {axis_name!r} axis of "
                         f"{ax.size} ranks")
    s_idx = ax.index
    n_micro = x_micro.shape[0]
    n_ticks = n_micro + n_stages - 1
    axes = collectives.bound_axes()

    def stage(p, h):
        # the backward replays the stage on autograd's thread (a CUDA
        # device's own), which does not see this thread's bindings
        with collectives.axis_scope(axes):
            return block_fn(p, h)

    def fn(p, h):
        return checkpoint(stage, p, h, use_reentrant=False,
                          preserve_rng_state=False)
    x_micro = collectives.copy_to(x_micro, axis_name)
    # the stage's selections, one host-to-device copy: is it stage 0, the
    # last stage, and does it hold a real microbatch at tick t
    flags = torch.tensor([s_idx == 0, s_idx == n_stages - 1]
                         + [s_idx <= t < s_idx + n_micro
                            for t in range(n_ticks)], device=x_micro.device)
    first, last = flags[0], flags[1]
    zeros = torch.zeros_like(x_micro[0])
    buf = zeros
    banks: list = [None] * n_micro
    for t in range(n_ticks):
        x_in = torch.where(first, x_micro[min(t, n_micro - 1)], buf)
        valid = flags[2 + t]
        x_in = torch.where(valid, x_in, zeros)
        y = torch.where(valid, fn(params_local, x_in), zeros)
        # the last stage banks microbatch t - (S - 1); the others zeros
        j = t - (n_stages - 1)
        if 0 <= j < n_micro:
            banks[j] = torch.where(last, y, zeros)
        if t < n_ticks - 1:
            buf = collectives.shift(y, axis_name)
    out = torch.stack(banks)
    # the last stage's stream on every stage
    return collectives.reduce_from(out, axis_name)


def pipelined_stack(mesh, block_fn: Callable, stacked_params: dict,
                    x: torch.Tensor, n_micro: int, *,
                    axis_name: str = PIPE_AXIS) -> torch.Tensor:
    """``S = mesh.shape[axis_name]`` pipelined stages applied to ``x``
    (batch-leading, the same on every rank of the axis), microbatched
    ``n_micro``-way.  ``stacked_params``: each leaf with a leading ``(S,
    ...)`` stage axis, whole on every rank; this rank runs its stage's
    slice (``collectives.axis_chunk``: its gradient is zero on the other
    stages' slices, to be summed over the axis).  Returns the output, the
    same on every rank."""
    n_stages = mesh.shape[axis_name]
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         f"microbatches")
    xm = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
    with collectives.axis_scope(mesh.axes()):
        local = {k: collectives.axis_chunk(v, axis_name, 0)
                 for k, v in stacked_params.items()}
        out = pipeline_apply(block_fn, stage_params(local), xm,
                             axis_name=axis_name, n_stages=n_stages)
    return out.reshape(x.shape)
