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

The expert-parallel functions (``moe_ffn_local``, ``moe_ffn``,
``moe_ep_scope``, ``active_moe_ep``, ``moe_ffn_ep_rows``) wait for the
expert-parallel slice of the multi-device port (ROADMAP.md queue 1, item
7c).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
