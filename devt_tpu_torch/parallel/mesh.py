"""The device mesh: port of ``devt_tpu/parallel/mesh.py``.

JAX lays its devices out in a ``Mesh`` and one program drives all of
them.  Here one process runs each rank (``parallel/distributed.py``), and
:class:`Mesh` is the layout of the world's ranks on the same named axes
(``data``, ``model``, ``pipe``, ``seq``), with this rank's coordinates and
the process group of each axis it lies on.  ``make_mesh`` keeps the JAX
function's arguments, its checks and their words; ``shard_batch`` gives
this rank its rows of a global batch, which is what
``NamedSharding(mesh, P("data"))`` places on device r.

Which strategy a mesh runs is chosen by ``parallel/train_step.py:
mesh_strategy``; the port runs all of JAX's (``dp_shard_map``,
``fsdp_shard_map``, ``gspmd``, ``pp_shard_map``, ``sp_shard_map``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, NamedTuple, Sequence

import numpy as np
import torch.distributed as dist

from devt_tpu_torch.parallel.collectives import Axis

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
SEQ_AXIS = "seq"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Ranks on named axes.  ``ranks``: the grid of world ranks, one
    dimension an axis; ``rank``: this process's world rank; ``groups``:
    for each axis, the process group of the ranks that share this rank's
    coordinates on every other axis (None: the default group, or no group
    at all when ``torch.distributed`` is not initialised)."""
    axis_names: tuple[str, ...]
    ranks: np.ndarray
    rank: int
    groups: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def coords(self) -> dict[str, int] | None:
        """This rank's index on each axis; None when it is outside."""
        where = np.argwhere(self.ranks == self.rank)
        if not len(where):
            return None
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def axes(self) -> dict[str, Axis]:
        """Every axis as the collectives see it, by name."""
        coords = self.coords
        if coords is None:
            raise ValueError(f"rank {self.rank} is outside the mesh "
                             f"{self.shape} of ranks {self.ranks.tolist()}")
        return {name: Axis(self.groups.get(name), size, coords[name])
                for name, size in self.shape.items()}


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _layout(grid: np.ndarray, names: tuple[str, ...], rank: int,
            live: bool) -> Mesh:
    """The mesh, with the process groups of each axis: one a line of the
    grid along it, the axes in order.  Every rank of the world makes every
    group (a collective call), in the same order, and keeps its own.  An
    axis whose one line is the whole world uses the default group."""
    groups = {}
    world = dist.get_world_size() if live else 1
    for a, name in enumerate(names):
        if not live or grid.size == 1 or grid.shape[a] == world:
            continue
        lines = np.moveaxis(grid, a, -1).reshape(-1, grid.shape[a])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = g
    return Mesh(names, grid, rank, groups)


def make_mesh(dp: int = -1, mp: int = 1, pp: int = 1, sp: int = 1,
              devices: Sequence[int] | None = None) -> Mesh:
    """2-D ``(data, model)`` mesh — ``(data, pipe)`` when ``pp > 1`` —
    or the 3-D ``(data, pipe, model)`` mesh when both ``pp > 1`` and
    ``mp > 1``; ``(data, seq)`` when ``sp > 1``, which composes with dp
    only.  ``dp=-1`` uses all devices / (mp·pp).

    ``devices``: the world ranks to lay out, in order (default: every rank
    of the ``torch.distributed`` world, or the one process when there is
    none).  Under a world of more than one rank every rank calls this with
    the same arguments: it makes the axes' process groups."""
    rank, world = _world()
    live = world > 1
    devices = list(devices if devices is not None else range(world))
    if devices != sorted(devices):
        raise ValueError(f"ranks {devices} out of order: a mesh lays out "
                         f"ranks in increasing order")
    n = len(devices)
    if sp > 1:
        if mp != 1 or pp != 1:
            raise ValueError("sp composes with dp only (mp=pp=1); got "
                             f"mp={mp} pp={pp} sp={sp}")
        if dp == -1:
            if n % sp:
                raise ValueError(f"{n} devices not divisible by sp={sp}")
            dp = n // sp
        if dp * sp > n:
            raise ValueError(f"mesh {dp}x{sp} exceeds {n} devices")
        grid = np.asarray(devices[: dp * sp]).reshape(dp, sp)
        return _layout(grid, (DATA_AXIS, SEQ_AXIS), rank, live)
    if pp > 1:
        per = pp * mp
        if dp == -1:
            if n % per:
                raise ValueError(
                    f"{n} devices not divisible by pp*mp={per}")
            dp = n // per
        if dp * per > n:
            raise ValueError(f"mesh {dp}x{pp}x{mp} exceeds {n} devices")
        if mp > 1:
            grid = np.asarray(devices[: dp * pp * mp]).reshape(dp, pp, mp)
            return _layout(grid, (DATA_AXIS, PIPE_AXIS, MODEL_AXIS), rank,
                           live)
        grid = np.asarray(devices[: dp * pp]).reshape(dp, pp)
        return _layout(grid, (DATA_AXIS, PIPE_AXIS), rank, live)
    if dp == -1:
        if n % mp:
            raise ValueError(f"{n} devices not divisible by mp={mp}")
        dp = n // mp
    if dp * mp > n:
        raise ValueError(f"mesh {dp}x{mp} exceeds {n} devices")
    grid = np.asarray(devices[: dp * mp]).reshape(dp, mp)
    return _layout(grid, (DATA_AXIS, MODEL_AXIS), rank, live)


def batch_spec(ndim: int = 1) -> tuple:
    """Shard the leading (batch) axis over the data axis."""
    return (DATA_AXIS,) + (None,) * (ndim - 1)


def replicated_spec() -> tuple:
    return ()


class Sharding(NamedTuple):
    """``NamedSharding``'s counterpart: a mesh and a spec, one entry an
    array axis (the axis name it is split over, or None)."""
    mesh: Mesh
    spec: tuple


def batch_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, (DATA_AXIS,))


def _rows(x, index: int, n: int):
    b = len(x)
    if b % n:
        raise ValueError(f"batch of {b} rows does not divide over the data "
                         f"axis of {n}")
    return x[index * (b // n):(index + 1) * (b // n)]


def shard_batch(batch: Mapping[str, Any], mesh: Mesh) -> dict[str, Any]:
    """This rank's rows of a global batch: the ``index``-th of the data
    axis' equal contiguous blocks of every entry's leading axis (numpy
    arrays, tensors, or lists such as paths).  ``ValueError`` when the
    rows do not divide."""
    ax = mesh.axes()[DATA_AXIS]
    return {k: _rows(v, ax.index, ax.size) for k, v in batch.items()}

