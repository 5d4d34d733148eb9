"""Where each leaf of a sharded ``TrainState`` lives, and the moves between
its parts and the whole.

JAX places a leaf with a ``NamedSharding`` and keeps one global array;
here each rank holds its own part of a sharded leaf, and the state
records how the parts make the whole: a :class:`Shard` per sharded
parameter (the mesh axis, the dim, the whole shape).  Optimizer moments
that mirror their parameter (Adam's ``mu`` and ``nu``, a momentum trace,
Adafactor's unfactored second moment) are split with it; every other
leaf of the optimizer state (step counts, Adafactor's factored row and
column statistics) stays whole on every rank.

  * :func:`shard_state` splits a whole state in place, by a map of
    parameter name to :class:`Shard` (``parallel/fsdp.py`` and
    ``parallel/sharding.py`` make the map);
  * :func:`forward_params` gives the step's forward its tensors: each
    part a tensor-parallel module computes on as that module's
    :class:`Shard` says (as the state holds it, or cut from the whole),
    every other sharded leaf gathered (over ``data``, FSDP's gather, whose
    backward is the gradients' reduce-scatter; over ``model``, a gather
    whose backward keeps this rank's part of the gradient every rank
    computed alike);
  * :func:`whole_state` gathers a sharded state on every rank into a new
    whole one (a checkpoint's payload).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from devt_tpu_torch.parallel import collectives
from devt_tpu_torch.parallel.mesh import DATA_AXIS


@dataclasses.dataclass(frozen=True)
class Shard:
    """A leaf split over mesh ``axis`` along ``dim`` into equal parts;
    ``groups`` > 1 splits each of that many blocks of the dim on its own
    (a packed qkv, split by head); ``shape``: the whole leaf's."""
    axis: str
    dim: int
    shape: tuple[int, ...]
    groups: int = 1


def mirrors(state) -> Iterator[tuple[list, int, str]]:
    """``(container, index, parameter name)`` for every optimizer-state
    leaf that mirrors a parameter: a list of one tensor a parameter, the
    tensor with the parameter's shape."""
    names = list(state.params)

    def walk(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from walk(v)
        elif isinstance(tree, list):
            if len(tree) == len(names) and all(
                    isinstance(t, torch.Tensor) for t in tree):
                for i, t in enumerate(tree):
                    yield tree, i, names[i]
            else:
                for v in tree:
                    yield from walk(v)

    yield from walk(state.opt_state)


def is_mirror(t: torch.Tensor, shape: tuple) -> bool:
    """Whether an optimizer leaf of :func:`mirrors` has its parameter's
    shape (Adafactor's factored statistics do not)."""
    return tuple(t.shape) == tuple(shape)


def shard_state(state, shards: dict[str, Shard], index_of) -> None:
    """Split ``state`` in place: each parameter of ``shards`` (and each
    moment mirroring it) keeps only this rank's part; ``index_of(axis)``
    gives the axis' size and this rank's index on it.  The map is recorded
    as ``state.shards``."""
    if state.shards:
        raise ValueError("the state is sharded already")
    with torch.no_grad():
        for name, sh in shards.items():
            p = state.params[name]
            if tuple(p.shape) != sh.shape:
                raise ValueError(f"{name}: shape {tuple(p.shape)}, the "
                                 f"shard expects {sh.shape}")
            n, j = index_of(sh.axis)
            p.data = collectives.part(p.data, sh.dim, n, j,
                                      sh.groups).contiguous()
        for tree, i, name in mirrors(state):
            sh = shards.get(name)
            if sh is not None and is_mirror(tree[i], sh.shape):
                n, j = index_of(sh.axis)
                tree[i] = collectives.part(tree[i], sh.dim, n, j,
                                           sh.groups).contiguous()
    state.shards = dict(shards)


def forward_params(params: dict[str, torch.Tensor],
                   shards: dict[str, Shard],
                   local: dict[str, Shard] | None = None) -> dict:
    """The tensors the forward runs with (inside the axes'
    ``collectives.axis_scope``).  ``local`` maps each parameter that a
    tensor-parallel module computes on its part of to that part's
    :class:`Shard`: the parameter is given as this rank's part, as it is
    when the state holds it so split, else cut from the whole
    (``collectives.local_slice``: its gradient comes back whole).  Every
    other sharded parameter is gathered whole; whole ones pass as they
    are."""
    local = local or {}
    out = {}
    for name, p in params.items():
        sh, want = shards.get(name), local.get(name)
        if want is not None and sh == want:
            out[name] = p
            continue
        if sh is not None and sh.axis == DATA_AXIS:
            p = collectives.all_gather(p, sh.axis, sh.dim, sh.groups)
        elif sh is not None:
            p = collectives.gather_replicated(p, sh.axis, sh.dim, sh.groups)
        if want is not None:
            p = collectives.local_slice(p, want.axis, want.dim, want.groups)
        out[name] = p
    return out


def _whole(t: torch.Tensor, sh: Shard) -> torch.Tensor:
    ax = collectives.axis(sh.axis)
    parts = [torch.empty_like(t) for _ in range(ax.size)]
    torch.distributed.all_gather(parts, t.detach().contiguous(),
                                 group=ax.group)
    return collectives.join(parts, sh.dim, sh.groups)


def whole_state(state):
    """A new whole state on every rank (inside the axes' ``axis_scope``):
    each sharded parameter and moment gathered; the whole leaves shared
    with ``state``.  A state that is not sharded is returned as is."""
    if not state.shards:
        return state
    with torch.no_grad():
        params = {k: _whole(p, state.shards[k]) if k in state.shards else p
                  for k, p in state.params.items()}
        opt_state = _copy_lists(state.opt_state)
        probe = dataclasses.replace(state, opt_state=opt_state)
        for tree, i, name in mirrors(probe):
            sh = state.shards.get(name)
            if sh is not None and is_mirror(tree[i],
                                              state.params[name].shape):
                tree[i] = _whole(tree[i], sh)
    return dataclasses.replace(state, params=params, opt_state=opt_state,
                               shards={})


def _copy_lists(tree):
    if isinstance(tree, dict):
        return {k: _copy_lists(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_lists(v) for v in tree]
    return tree

