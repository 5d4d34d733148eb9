"""The collectives of the step executors: the port's ``lax.pmean``,
``lax.psum``, ``lax.all_gather(tiled=True)`` and ``lax.psum_scatter`` over
a named mesh axis.

JAX names an axis inside ``shard_map`` and its collectives take that
name.  Here one process runs each rank, and :func:`axis_scope` binds an
axis name to an :class:`Axis` (a process group, its size and this rank's
index along it) for the duration of a ``with``: the executors bind the
mesh's ``data`` and ``model`` axes around each step, so that
``forward_and_loss``, ``nt_xent`` and a synced ``BatchNorm`` reach the
group by the name JAX's code uses.  An unbound name raises ``NameError``, as JAX's does outside
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
    place, coalesced by dtype;
  * :func:`copy_to` and :func:`reduce_from`, Megatron's pair around a
    column-parallel then row-parallel product (``parallel/tp_block.py``):
    the identity forward with an all-reduce backward at the column-parallel
    input (each rank's input gradient covers only its columns), and an
    all-reduce forward with the identity backward after the row-parallel
    product (JAX's ``psum`` and the transposes of ``shard_map``);
  * :func:`all_gather`: every rank's tensor concatenated along any dim
    (``groups`` > 1: each of ``groups`` equal blocks of the dim gathered on
    its own, the layout of a packed qkv split by head), its backward a
    reduce-scatter: the ranks' cotangents summed, then this rank's part.
    Differentiating FSDP's gather (``parallel/fsdp.py``) is the ZeRO-3
    reduce-scatter of the gradients;
  * :func:`reduce_scatter`: the sum over the axis, this rank's part of it
    along a dim (``reduce_scatter_tensor`` on the parts moved to the front,
    any dim and any ``groups``; Gloo takes no reduce-scatter of CUDA
    tensors, so there an all-reduce, then the slice);
  * :func:`local_slice`: this rank's part of a tensor every rank holds
    whole, its backward an all-gather of the parts' cotangents (a
    replicated weight a tensor-parallel product uses only a slice of);
  * :func:`gather_replicated`: the whole tensor from every rank's part,
    its backward this rank's part of the cotangent, for a computation
    every rank of the axis repeats with the same values;
  * :func:`axis_chunk`: this rank's part along a dim (``lax.
    dynamic_slice_in_dim`` at the axis index), its backward the cotangent
    scattered into zeros, no communication (each rank's gradient of the
    whole is non-zero only on its part);
  * :func:`shift`: the pipe shift (``lax.ppermute`` to the next index),
    zeros on index 0, its backward the cotangent shifted the other way;
  * :func:`all_to_all`: ``lax.all_to_all(tiled=True)`` with
    ``split_axis`` and ``concat_axis``, its backward the inverse exchange;
  * :func:`sendrecv`: one point-to-point exchange in a group (send to one
    rank, receive from another), which the shift and the ring of
    ``parallel/ring_attention.py`` use.

Gloo takes neither point-to-point sends nor ``all_to_all`` of CUDA
tensors: under Gloo :func:`sendrecv` and :func:`all_to_all` stage a CUDA
tensor through the host (a copy to the CPU, the exchange, a copy back);
under NCCL they send it from the card.

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


def bound_axes() -> dict[str, Axis]:
    """The axes bound on this thread (for a computation that another
    thread replays: autograd runs a CUDA backward, and a rematerialised
    forward, on its device thread)."""
    return dict(getattr(_bound, "axes", {}))


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


def psum(tensors: Sequence[torch.Tensor], axis_name: str
         ) -> list[torch.Tensor]:
    """The sum over the axis of each tensor (new tensors, not in place, no
    gradient): one ``all_reduce`` per dtype."""
    return _reduce(tensors, axis_name, mean=False)


def pmean(tensors: Sequence[torch.Tensor], axis_name: str
          ) -> list[torch.Tensor]:
    """The mean over the axis of each tensor (new tensors, not in place,
    no gradient): one ``all_reduce`` per dtype."""
    return _reduce(tensors, axis_name, mean=True)


def _reduce(tensors: Sequence[torch.Tensor], axis_name: str,
            mean: bool) -> list[torch.Tensor]:
    ax = axis(axis_name)
    tensors = [t.detach() for t in tensors]
    if not _live(ax):
        return list(tensors)
    out: list = [None] * len(tensors)
    for idx in _buckets(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=ax.group)
        if mean:
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


def _gloo(ax: Axis) -> bool:
    return dist.get_backend(ax.group) == "gloo"


def _sum(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The sum over the axis, in ``x``'s dtype; under Gloo, which may not
    reduce a bf16 tensor, summed in at least f32."""
    if not _gloo(ax):
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ax.group)
        return out
    wide = x.detach().to(torch.promote_types(x.dtype, torch.float32),
                         copy=True).contiguous()
    dist.all_reduce(wide, group=ax.group)
    return wide.to(x.dtype)


def parts(x: torch.Tensor, dim: int, n: int, groups: int
           ) -> list[torch.Tensor]:
    """``x`` cut into ``n`` parts along ``dim``: with ``groups`` > 1 the dim
    is ``groups`` equal blocks, and part j is the j-th ``n``-th of each
    block, concatenated (the (3, H/n, d) slice of a packed qkv)."""
    size = x.shape[dim]
    if size % (groups * n):
        raise ValueError(f"dim {dim} of {size} does not split into {groups} "
                         f"blocks of {n} parts")
    blocks = x.chunk(groups, dim) if groups > 1 else (x,)
    cut = [b.chunk(n, dim) for b in blocks]
    return [torch.cat([c[j] for c in cut], dim) if groups > 1 else cut[0][j]
            for j in range(n)]


def part(x: torch.Tensor, dim: int, n: int, index: int,
         groups: int = 1) -> torch.Tensor:
    """Part ``index`` of ``n`` of ``x`` along ``dim`` (see :func:`parts`)."""
    return parts(x, dim, n, groups)[index]


def join(pieces, dim: int, groups: int = 1) -> torch.Tensor:
    """The inverse of :func:`parts`: the whole tensor from its parts."""
    if groups == 1:
        return torch.cat(list(pieces), dim)
    split = [p.chunk(groups, dim) for p in pieces]
    return torch.cat([b for g in range(groups) for b in
                      (s[g] for s in split)], dim)


def _gather(x: torch.Tensor, ax: Axis, dim: int, groups: int):
    pieces = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(pieces, x.contiguous(), group=ax.group)
    return join(pieces, dim, groups)


def parts_first(x: torch.Tensor, dim: int, n: int, groups: int
                ) -> torch.Tensor:
    """``x`` with ``dim`` moved to the front and its :func:`parts` laid out
    one after another along it (contiguous): the input of a
    reduce-scatter, whose rank j keeps the j-th ``n``-th."""
    x = x.movedim(dim, 0)
    size, rest = x.shape[0], tuple(x.shape[1:])
    x = x.reshape((groups, n, size // (groups * n)) + rest)
    return x.transpose(0, 1).reshape((size,) + rest).contiguous()


def _scatter(x: torch.Tensor, ax: Axis, dim: int, groups: int):
    """The sum over the axis, this rank's part along ``dim``:
    ``reduce_scatter_tensor`` on :func:`parts_first`'s layout, except
    under Gloo (no reduce-scatter of CUDA tensors), where it is an
    all-reduce, then the slice."""
    if _gloo(ax):
        return part(_sum(x, ax), dim, ax.size, ax.index, groups)
    src = parts_first(x.detach(), dim, ax.size, groups)
    out = src.new_empty((src.shape[0] // ax.size,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=ax.group)
    return out.movedim(0, dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax: Axis, dim: int, groups: int):
        ctx.args = ax, dim, groups
        return _gather(x, ax, dim, groups)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, *ctx.args), None, None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax: Axis, dim: int, groups: int):
        ctx.args = ax, dim, groups
        return _gather(x, ax, dim, groups)

    @staticmethod
    def backward(ctx, g):
        ax, dim, groups = ctx.args
        return part(g, dim, ax.size, ax.index, groups), None, None, None


class _LocalSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax: Axis, dim: int, groups: int):
        ctx.args = ax, dim, groups
        return part(x, dim, ax.size, ax.index, groups).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax: Axis):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.ax), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax: Axis):
        return _sum(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather(x: torch.Tensor, axis_name: str, dim: int = 0,
               groups: int = 1) -> torch.Tensor:
    """``lax.all_gather(x, axis_name, axis=dim, tiled=True)``: every rank's
    ``x`` (the same shape on each) concatenated along ``dim`` in rank order
    (with ``groups``, block by block); differentiable, its backward the
    reduce-scatter of the cotangents."""
    ax = axis(axis_name)
    if not _live(ax):
        return x
    return _Gather.apply(x, ax, dim, groups)


def all_gather_rows(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``lax.all_gather(x, axis_name, axis=0, tiled=True)``: the rows of
    every rank in rank order (see the module's docstring)."""
    return all_gather(x, axis_name, 0)


def reduce_scatter(x: torch.Tensor, axis_name: str, dim: int = 0,
                   groups: int = 1) -> torch.Tensor:
    """``lax.psum_scatter(x, axis_name, scatter_dimension=dim,
    tiled=True)``: the sum over the axis, this rank's part along ``dim``
    (no gradient)."""
    ax = axis(axis_name)
    if not _live(ax):
        return x
    return _scatter(x.detach(), ax, dim, groups)


def local_slice(x: torch.Tensor, axis_name: str, dim: int,
                groups: int = 1) -> torch.Tensor:
    """This rank's part along ``dim`` of ``x``, which every rank of the
    axis holds whole; the backward all-gathers the parts' cotangents, so
    every rank gets the whole gradient."""
    ax = axis(axis_name)
    if ax.size == 1:
        return x
    _live(ax)
    return _LocalSlice.apply(x, ax, dim, groups)


def gather_replicated(x: torch.Tensor, axis_name: str, dim: int,
                      groups: int = 1) -> torch.Tensor:
    """The whole tensor from every rank's part along ``dim``, for a
    computation that every rank of the axis repeats on the same values:
    the backward takes this rank's part of the (same) cotangent."""
    ax = axis(axis_name)
    if not _live(ax):
        return x
    return _GatherReplicated.apply(x, ax, dim, groups)


def copy_to(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Megatron's f: the identity forward, an all-reduce of the cotangent
    over the axis in the backward (at a column-parallel product's input)."""
    ax = axis(axis_name)
    if not _live(ax):
        return x
    return _CopyTo.apply(x, ax)


def reduce_from(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Megatron's g (``lax.psum`` in the forward): the sum over the axis of
    the ranks' partial products, the identity backward."""
    ax = axis(axis_name)
    if not _live(ax):
        return x
    return _ReduceFrom.apply(x, ax)


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


def staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` goes through the host for a point-to-point send or an
    ``all_to_all`` in ``group``: a CUDA tensor under Gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def sendrecv(t: torch.Tensor, group, to: int, frm: int) -> torch.Tensor:
    """Send ``t`` to index ``to`` of ``group`` (None: the default group)
    and return what index ``frm`` sends here (``t``'s shape and dtype).
    Every rank of the group posts its exchange at the same point."""
    def rank(i):
        return i if group is None else dist.get_global_rank(group, i)

    host = staged(t, group)
    src = (t.detach().cpu() if host else t.detach()).contiguous()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, rank(to), group),
           dist.P2POp(dist.irecv, out, rank(frm), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(t.device) if host else out


class _AxisChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax: Axis, dim: int, groups: int):
        ctx.args = ax, dim, groups
        return part(x, dim, ax.size, ax.index, groups).contiguous()

    @staticmethod
    def backward(ctx, g):
        ax, dim, groups = ctx.args
        zero = torch.zeros_like(g)
        pieces = [g if j == ax.index else zero for j in range(ax.size)]
        return join(pieces, dim, groups), None, None, None


def axis_chunk(x: torch.Tensor, axis_name: str, dim: int,
               groups: int = 1) -> torch.Tensor:
    """``lax.dynamic_slice_in_dim`` at this rank's index on the axis: its
    part of ``x`` along ``dim`` (with ``groups``, as :func:`parts` cuts
    it).  The backward scatters the cotangent into zeros (JAX's transpose
    of the slice): no communication, and the gradient of ``x`` is
    non-zero only on this rank's part."""
    ax = axis(axis_name)
    if ax.size == 1:
        return x
    return _AxisChunk.apply(x, ax, dim, groups)


def _shifted(t: torch.Tensor, ax: Axis, step: int) -> torch.Tensor:
    """``t`` sent ``step`` indices on around the axis, the tensor of the
    index ``step`` back received in its place."""
    return sendrecv(t, ax.group, (ax.index + step) % ax.size,
                    (ax.index - step) % ax.size)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax: Axis):
        ctx.ax = ax
        out = _shifted(x, ax, 1)
        if ax.index == 0:
            out.zero_()
        return out

    @staticmethod
    def backward(ctx, g):
        ax = ctx.ax
        # index 0 zeroed what it received: its cotangent goes back as zeros
        g = torch.zeros_like(g) if ax.index == 0 else g
        return _shifted(g, ax, -1), None


def shift(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``lax.ppermute(x, axis_name, [(i, i + 1) for i in range(n - 1)])``:
    index i + 1 receives index i's ``x``, index 0 receives zeros.  Every
    rank sends to the next index round the ring and receives from the one
    before (index 0 zeroes what it receives), so all post the same
    exchange; the backward shifts the cotangent the other way."""
    ax = axis(axis_name)
    if ax.size == 1:
        return torch.zeros_like(x)
    _live(ax)
    return _Shift.apply(x, ax)


def _exchange(x: torch.Tensor, ax: Axis, split_axis: int,
              concat_axis: int) -> torch.Tensor:
    src = torch.stack(x.chunk(ax.size, split_axis)).contiguous()
    host = staged(src, ax.group)
    if host:
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=ax.group)
    if host:
        out = out.to(x.device)
    return torch.cat(out.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax: Axis, split_axis: int, concat_axis: int):
        ctx.args = ax, split_axis, concat_axis
        return _exchange(x, ax, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        ax, split_axis, concat_axis = ctx.args
        return _exchange(g.contiguous(), ax, concat_axis, split_axis), \
            None, None, None


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis_name, split_axis, concat_axis,
    tiled=True)``: ``x`` cut into as many equal parts along
    ``split_axis`` as the axis has ranks, part j sent to index j, and the
    parts received concatenated along ``concat_axis`` in index order.
    Differentiable: the backward is the inverse exchange (the two axes
    swapped)."""
    ax = axis(axis_name)
    if ax.size == 1:
        return x
    _live(ax)
    if x.shape[split_axis] % ax.size:
        raise ValueError(f"dim {split_axis} of {x.shape[split_axis]} does "
                         f"not split over the {ax.size} ranks of "
                         f"{axis_name!r}")
    return _AllToAll.apply(x, ax, split_axis, concat_axis)
