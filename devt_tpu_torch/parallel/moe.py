"""Switch-style MoE feed-forward on one device: port of the single-device
half of ``devt_tpu/parallel/moe.py``.

Top-1 (switch) routing with a fixed per-expert capacity: every expert
computes exactly C token slots, tokens past an expert's capacity are
dropped (their MoE output is zero and the caller's residual carries them),
and empty slots compute on zeros, so every shape is static.  Dispatch and
combine are the (T, E, C) one-hot einsums of the Shazeer formulation, as
in the JAX package; they are plain products that JAX leaves to XLA outside
any kernel, so here they are ``torch.einsum``.  The router, its softmax and
the load-balance loss are f32; the expert FFNs run in the slot dtype.

Routing in groups (``group_size``) keeps the dispatch tensor linear in the
number of tokens: ``models/layers.py:MoEViTBlock`` routes each sequence
row on its own.  Here a group is a leading batch dimension of every
tensor (JAX maps a function over the groups with ``vmap``).

The expert-parallel half (``moe_ffn_local``, ``moe_ffn``,
``moe_ep_scope``, ``active_moe_ep``, ``moe_ffn_ep_rows``) runs the same
routing with each rank computing its ``E / n`` experts' FFNs: the slots
travel to their expert's rank and back in two ``collectives.all_to_all``
exchanges (staged through the host for CUDA tensors under Gloo), each the
other's transpose.  A rank's experts are its ``collectives.axis_chunk``
of the ``(E, ...)`` leaves, so its gradient of a whole expert leaf is
zero outside its own experts: the gradients summed (or, in the
data-parallel step, averaged) over the axis are the dense ones.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from devt_tpu_torch.parallel import collectives

EXPERT_AXIS = "expert"


def init_moe_params(generator: torch.Generator, n_experts: int,
                    d_model: int, d_hidden: int,
                    router_scale: float = 0.01) -> dict:
    """Param dict with a leading (E, ...) expert axis for the FFNs: the
    router normal(``router_scale``), w1 and w2 normal with std
    1/sqrt(fan in), zero biases (the distributions of the JAX
    ``init_moe_params``, from a ``torch.Generator``)."""
    def normal(*shape, std):
        return torch.randn(*shape, generator=generator) * std

    return {
        "router": normal(d_model, n_experts, std=router_scale),
        "w1": normal(n_experts, d_model, d_hidden, std=d_model ** -0.5),
        "b1": torch.zeros(n_experts, d_hidden),
        "w2": normal(n_experts, d_hidden, d_model, std=d_hidden ** -0.5),
        "b2": torch.zeros(n_experts, d_model),
    }


def switch_route(x: torch.Tensor, w_router: torch.Tensor, n_experts: int,
                 capacity: int, valid: torch.Tensor | None = None):
    """Top-1 routing with a fixed per-expert capacity.

    x (..., T, D): the tokens of each group along the second-to-last axis.
    Returns (dispatch (..., T, E, C) 0/1, combine (..., T, E, C) weighted
    by the gate, aux (...)).  Tokens past an expert's capacity get an
    all-zero dispatch row.  ``valid`` (optional (..., T) 0/1): tokens
    marked 0 never enter a queue and count in neither load-balance
    statistic.  The router product is f32 whatever x's dtype, as JAX
    promotes a bf16 x against the f32 router."""
    logits = x.float() @ w_router.float()                   # (..., T, E)
    probs = torch.softmax(logits, dim=-1)
    gate = probs.amax(dim=-1)                               # (..., T)
    expert = probs.argmax(dim=-1)         # the first of equal maxima
    onehot = F.one_hot(expert, n_experts).float()           # (..., T, E)
    if valid is not None:
        onehot = onehot * valid.float()[..., None]
    # position of each token within its expert's queue
    pos = torch.cumsum(onehot, dim=-2) * onehot - 1.0
    kept = (pos >= 0) & (pos < capacity)
    # only the chosen expert's column can be kept, so the sum picks out
    # the slot (dropped tokens land on slot 0, zeroed by onehot * kept)
    slot = torch.where(kept, pos, torch.zeros_like(pos)).sum(dim=-1)
    pos_oh = F.one_hot(slot.long(), capacity).float()       # (..., T, C)
    dispatch = (onehot * kept)[..., None] * pos_oh[..., None, :]
    combine = dispatch * gate[..., None, None]
    # switch load-balance loss E * sum_e f_e * p_e (1 at uniform), over
    # the valid tokens only
    if valid is None:
        f = onehot.mean(dim=-2)
        p = probs.mean(dim=-2)
    else:
        v = valid.float()
        denom = v.sum(dim=-1, keepdim=True).clamp(min=1.0)
        f = onehot.sum(dim=-2) / denom                      # onehot is masked
        p = (probs * v[..., None]).sum(dim=-2) / denom
    aux = n_experts * (f * p).sum(dim=-1)
    return dispatch, combine, aux


def _expert_ffn(params: dict, h: torch.Tensor) -> torch.Tensor:
    """(..., E, C, D) slots through each expert's FFN, in the slot dtype,
    with tanh GELU (JAX's ``gelu(approximate=True)``)."""
    dt = h.dtype
    h = torch.einsum("...ecd,edh->...ech", h, params["w1"].to(dt)) \
        + params["b1"].to(dt)[:, None, :]
    h = F.gelu(h, approximate="tanh")
    return torch.einsum("...ech,ehd->...ecd", h, params["w2"].to(dt)) \
        + params["b2"].to(dt)[:, None, :]


def _moe_groups(params: dict, x: torch.Tensor, capacity_factor: float,
                valid: torch.Tensor | None):
    """x (..., t, D), each leading index one group → (y, aux per group)."""
    n_experts = params["router"].shape[-1]
    t = x.shape[-2]
    capacity = max(int(t / n_experts * capacity_factor), 1)
    dispatch, combine, aux = switch_route(x, params["router"], n_experts,
                                          capacity, valid=valid)
    slots = torch.einsum("...tec,...td->...ecd", dispatch.to(x.dtype), x)
    out = _expert_ffn(params, slots)
    y = torch.einsum("...tec,...ecd->...td", combine.to(x.dtype), out)
    return y, aux


def moe_ffn_dense(params: dict, x: torch.Tensor,
                  capacity_factor: float = 1.25,
                  valid: torch.Tensor | None = None,
                  group_size: int | None = None):
    """Single-device execution, every expert materialised.

    x (T, D) → (y (T, D), aux scalar).  Dispatch, combine and the expert
    products run in x's dtype; the routing stays f32.  ``group_size``:
    route in independent groups of that many tokens (T must divide), each
    with its own capacity (counted with its pads); aux is the mean over the
    groups."""
    if group_size is not None and x.shape[0] != group_size:
        t, d = x.shape
        if t % group_size:
            raise ValueError(f"{t} tokens do not split into groups of "
                             f"{group_size}")
        g = t // group_size
        y, aux = _moe_groups(
            params, x.reshape(g, group_size, d), capacity_factor,
            None if valid is None else valid.reshape(g, group_size))
        return y.reshape(t, d), aux.mean()
    return _moe_groups(params, x, capacity_factor, valid)


_EXPERT_KEYS = ("w1", "b1", "w2", "b2")


def _local_experts(params: dict, axis_name: str) -> dict:
    """This rank's experts: the router whole, each ``(E, ...)`` leaf's
    ``collectives.axis_chunk`` (its gradient zero outside them)."""
    out = {"router": params["router"]}
    for k in _EXPERT_KEYS:
        out[k] = collectives.axis_chunk(params[k], axis_name, 0)
    return out


def _mean_over(aux: torch.Tensor, axis_name: str) -> torch.Tensor:
    """The mean of ``aux`` over the axis, its backward the cotangent over
    the ranks (each rank's share of the mean's gradient)."""
    n = collectives.axis(axis_name).size
    return collectives.reduce_from(aux, axis_name) / n


def _exchange(params_local: dict, slots: torch.Tensor,
              axis_name: str) -> torch.Tensor:
    """The slots for every expert, (E, C, D), through the experts' ranks:
    one ``all_to_all`` (split by expert, concatenated along the capacity
    axis in source order: (E/n, n·C, D)), this rank's experts, and the
    inverse exchange home."""
    recv = collectives.all_to_all(slots, axis_name, 0, 1)
    out = _expert_ffn(params_local, recv)
    return collectives.all_to_all(out, axis_name, 1, 0)


def moe_ffn_local(params_local: dict, x_local: torch.Tensor, *,
                  axis_name: str = EXPERT_AXIS, n_experts: int,
                  capacity_factor: float = 1.25,
                  valid_local: torch.Tensor | None = None):
    """The expert-parallel body on this rank (inside the axes'
    ``collectives.axis_scope``): ``x_local`` its (T/n, D) tokens,
    ``params_local`` the router whole and its ``E / n`` experts.  The
    slots for every expert go through the experts' ranks and back
    (:func:`_exchange`).  Semantics: ``moe_ffn_dense`` on each rank's tokens
    (capacity per token shard).  ``aux`` is the mean over the axis."""
    t = x_local.shape[0]
    capacity = max(int(t / n_experts * capacity_factor), 1)
    dispatch, combine, aux = switch_route(
        x_local, params_local["router"], n_experts, capacity,
        valid=valid_local)
    slots = torch.einsum("tec,td->ecd", dispatch.to(x_local.dtype), x_local)
    back = _exchange(params_local, slots, axis_name)
    y = torch.einsum("tec,ecd->td", combine.to(x_local.dtype), back)
    return y, _mean_over(aux, axis_name)


def moe_ffn(mesh, params: dict, x: torch.Tensor, *,
            axis_name: str = EXPERT_AXIS, capacity_factor: float = 1.25,
            valid: torch.Tensor | None = None):
    """Expert parallelism from the global view: ``x`` (T, D) and the
    parameters whole on every rank of ``mesh``; each rank routes its
    (T/n) tokens and runs its ``E / n`` experts (:func:`moe_ffn_local`).
    Returns (y (T, D), aux), the same on every rank.  Gradients: a rank's
    share, to be summed over the axis (its tokens' rows of ``x``, its
    experts' slices, its tokens' part of the router's)."""
    n_experts = params["router"].shape[-1]
    with collectives.axis_scope(mesh.axes()):
        n = collectives.axis(axis_name).size
        if n_experts % n:
            raise ValueError(f"{n_experts} experts do not split over {n} "
                             f"ranks")
        xs = collectives.axis_chunk(x, axis_name, 0)
        vs = None if valid is None else \
            collectives.axis_chunk(valid, axis_name, 0)
        y, aux = moe_ffn_local(_local_experts(params, axis_name), xs,
                               axis_name=axis_name, n_experts=n_experts,
                               capacity_factor=capacity_factor,
                               valid_local=vs)
        return collectives.gather_replicated(y, axis_name, 0), aux


# ---------------------------------------------------------------------------
# Expert-parallel training over the data axis (config.moe_ep)
# ---------------------------------------------------------------------------

_ep_gate = threading.local()


@contextlib.contextmanager
def moe_ep_scope(axis_name: str, n_shards: int):
    """Context in which ``MoEViTBlock`` (``models/layers.py``) routes its
    FFN through :func:`moe_ffn_ep_rows` over ``axis_name``'s ``n_shards``
    ranks (the data-parallel step sets it for ``config.moe_ep``).
    Re-entrant, thread-local, bounded by the ``with``."""
    prev = getattr(_ep_gate, "val", None)
    _ep_gate.val = (axis_name, int(n_shards))
    try:
        yield
    finally:
        _ep_gate.val = prev


def active_moe_ep():
    """The (axis_name, n_shards) set by :func:`moe_ep_scope`, or None."""
    return getattr(_ep_gate, "val", None)


def moe_ffn_ep_rows(params: dict, h: torch.Tensor, *, axis_name: str,
                    n_shards: int, capacity_factor: float = 1.25,
                    valid: torch.Tensor | None = None):
    """The per-row-routed MoE FFN with the experts spread over the ranks of
    ``axis_name`` (the data axis doubles as the expert axis, Switch's
    training layout).  ``h`` (G, S, D): this rank's sequence rows;
    ``params`` whole.  Routing, capacity and dispatch are
    ``moe_ffn_dense(group_size=S)``'s row by row, so every token goes
    where the dense path sends it; only the expert products move: every
    row's (E, C, D) slots travel to the experts' ranks in one
    ``all_to_all``, each rank runs its E/n experts on the slots of every
    rank, and a second ``all_to_all`` brings the outputs home.

    Gradients: the exchanges' transposes bring every rank's cotangents to
    the expert's rank, so a rank's gradient of an ``(E, ...)`` leaf is the
    sum over the ranks' rows on its own experts and zero elsewhere; the
    data-parallel step's mean over the axis then gives the dense update.
    ``aux`` is this rank's row mean, which the step averages."""
    g, s, d = h.shape
    n_experts = params["router"].shape[-1]
    if n_experts % n_shards:
        raise ValueError(f"{n_experts} experts do not split over "
                         f"{n_shards} ranks")
    capacity = max(int(s / n_experts * capacity_factor), 1)
    dispatch, combine, aux = switch_route(h, params["router"], n_experts,
                                          capacity, valid=valid)
    # per-row slots, then expert-major for the exchange: (E, G·C, D)
    slots = torch.einsum("gsec,gsd->gecd", dispatch.to(h.dtype), h)
    slots = slots.transpose(0, 1).reshape(n_experts, g * capacity, d)
    back = _exchange(_local_experts(params, axis_name), slots, axis_name)
    back = back.reshape(n_experts, g, capacity, d).transpose(0, 1)
    y = torch.einsum("gsec,gecd->gsd", combine.to(h.dtype), back)
    return y, aux.mean()
