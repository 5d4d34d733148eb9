"""The collectives of the data-parallel step: the port's ``lax.pmean`` and
``lax.all_gather(tiled=True)`` over a named mesh axis.

JAX names an axis inside ``shard_map`` and its collectives take that
name.  Here one process runs each rank, and :func:`axis_scope` binds an
axis name to an :class:`Axis` (a process group, its size and this rank's
index along it) for the duration of a ``with``: the DP executors bind the
mesh's ``data`` axis around each step, so that ``forward_and_loss``,
``nt_xent`` and a synced ``BatchNorm`` reach the group by the name JAX's
code uses.  An unbound name raises ``NameError``, as JAX's does outside
``shard_map``.

  * :func:`pmean`: the mean of a list of tensors over the axis, coalesced:
    the tensors of one dtype are flattened into one buffer and reduced by
    one ``all_reduce`` (Gloo has no ``ReduceOp.AVG``: a sum, then a
    division);
  * :func:`all_gather_rows`: the rows of every rank concatenated in rank
    order, differentiable.  Its backward is JAX's transpose of a tiled
    ``all_gather`` under ``check_vma=False``, a ``psum_scatter``: the
    cotangents of every rank summed, then this rank's rows.  Every rank
    scores the same gathered pool, so the sum holds n copies of the
    global cotangent, and the DP step's mean of the gradients divides
    the n back out.  (``torch.distributed.nn.functional.all_gather``'s
    backward goes through ``all_to_all``, which Gloo does not take on
    CUDA tensors.)
  * :func:`pmean_grad`: a differentiable mean, for the synced BatchNorm
    statistics; its backward is the mean of the cotangents (JAX's
    transpose of ``pmean`` under ``check_vma=False``).
  * :func:`broadcast`: the tensors of rank ``src`` to every rank, in
    place, coalesced by dtype.

Every collective runs whenever a process group exists, also over a group
of one rank; without ``torch.distributed`` initialised an axis has one
rank and each function returns its input.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Iterator, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a mesh as this rank sees it: ``group`` (None: the
    default group), ``size`` ranks, this rank at ``index``."""
    group: Any
    size: int
    index: int


_bound = threading.local()


@contextlib.contextmanager
def axis_scope(axes: dict[str, Axis]) -> Iterator[None]:
    """Bind axis names to axes inside the ``with`` (thread-local,
    re-entrant: an inner binding of a name hides the outer one)."""
    prev = getattr(_bound, "axes", {})
    _bound.axes = {**prev, **axes}
    try:
        yield
    finally:
        _bound.axes = prev


def axis(name: str) -> Axis:
    """The axis bound to ``name``; ``NameError`` when none is."""
    try:
        return getattr(_bound, "axes", {})[name]
    except KeyError:
        raise NameError(f"unbound axis name: {name} (collectives over a "
                        f"mesh axis run inside parallel.collectives."
                        f"axis_scope, which the DP executors enter)") \
            from None


def _live(ax: Axis) -> bool:
    if dist.is_available() and dist.is_initialized():
        return True
    if ax.size != 1:
        raise RuntimeError(f"an axis of {ax.size} ranks needs "
                           f"torch.distributed initialised")
    return False


def _buckets(tensors: Sequence[torch.Tensor]) -> dict:
    out: dict = {}
    for i, t in enumerate(tensors):
        out.setdefault((t.dtype, t.device), []).append(i)
    return out


def pmean(tensors: Sequence[torch.Tensor], axis_name: str
          ) -> list[torch.Tensor]:
    """The mean over the axis of each tensor (new tensors, not in place,
    no gradient): one ``all_reduce`` per dtype."""
    ax = axis(axis_name)
    tensors = [t.detach() for t in tensors]
    if not _live(ax):
        return list(tensors)
    out: list = [None] * len(tensors)
    for idx in _buckets(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=ax.group)
        flat /= ax.size
        start = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[start:start + n].view_as(tensors[i])
            start += n
    return out


def broadcast(tensors: Sequence[torch.Tensor], axis_name: str,
              src: int = 0) -> None:
    """Overwrite each tensor with rank ``src``'s (an index along the
    axis), one ``broadcast`` per dtype."""
    ax = axis(axis_name)
    if not _live(ax):
        return
    root = src if ax.group is None else dist.get_global_rank(ax.group, src)
    with torch.no_grad():
        for idx in _buckets(tensors).values():
            flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
            dist.broadcast(flat, root, group=ax.group)
            start = 0
            for i in idx:
                n = tensors[i].numel()
                tensors[i].copy_(flat[start:start + n].view_as(tensors[i]))
                start += n


def _sum(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=ax.group)
    return x


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, ax: Axis) -> torch.Tensor:
        ctx.ax, ctx.rows = ax, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(ax.size)]
        dist.all_gather(parts, x.contiguous(), group=ax.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        ax, rows = ctx.ax, ctx.rows
        g = _sum(g, ax)
        return g[ax.index * rows:(ax.index + 1) * rows], None


def all_gather_rows(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``lax.all_gather(x, axis_name, axis=0, tiled=True)``: every rank's
    ``x`` (the same shape on each) concatenated along the rows in rank
    order; differentiable (see the module's docstring)."""
    ax = axis(axis_name)
    if not _live(ax):
        return x
    return _GatherRows.apply(x, ax)


class _MeanGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, ax: Axis) -> torch.Tensor:
        ctx.ax = ax
        return _sum(x, ax) / ax.size

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _sum(g, ctx.ax) / ctx.ax.size, None


def pmean_grad(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``lax.pmean(x, axis_name)``, differentiable."""
    ax = axis(axis_name)
    if not _live(ax):
        return x
    return _MeanGrad.apply(x, ax)
