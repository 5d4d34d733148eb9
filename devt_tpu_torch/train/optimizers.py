"""Optimizers and LR schedules: port of ``devt_tpu/train/optimizers.py``.

``build_optimizer(config)`` dispatches on ``config.opt`` like the JAX
package, which builds optax chains:

  * ``sgd``     — L2 decay added to the gradient, then momentum (trace).
  * ``adamW``   — Adam with decoupled weight decay.
  * ``adagrad`` — L2 decay, then root-of-sum-of-squares scaling
                  (accumulator starts at 0.1, ``eps`` 1e-7 inside the root).
  * ``adam``    — L2 decay, then Adam.
  * ``adafactor`` — factored second moments, block-RMS clipping, momentum
                  0.9 without debiasing, and the chained decoupled decay
                  ``-lr_t * wd * p`` (adamW's magnitude convention).
``config.moment_dtype="bf16"`` keeps Adam/AdamW first moments (and
Adafactor's momentum) in bfloat16; second moments stay f32.
``config.grad_clip_norm > 0`` puts global-norm clipping first.

These are written here, as chains of small transformations over lists of
tensors (``torch._foreach_*``: elementwise passes, which no Pallas kernel
of the JAX package computes), because ``torch.optim`` does not match
optax: its AdamW has no bf16 first moment, its Adagrad starts the
accumulator at 0 with ``eps`` outside the root, and it has no Adafactor
with these semantics.  A transformation is ``init(params) -> state`` and
``update(updates, state, params) -> updates``; unlike optax, ``update``
overwrites ``state`` in place (the moments are the largest tensors after
the parameters).  Step counts are host integers, so schedules and bias
corrections are host arithmetic and cost no device synchronisation.

Sharded leaves (``parallel/layout.py``): ``update``'s ``shards`` gives,
leaf by leaf, the ``Shard`` of which the leaf is this rank's part (None:
the leaf is whole), and the transformations that are not elementwise see
the whole leaves: the global norm of the clip sums every part's squares
over its axis (a whole leaf once), Adafactor's factored row and column
statistics are taken from the whole gradient (gathered), and the
block-RMS clip from the whole update's squares.  The collectives run
inside the mesh's ``collectives.axis_scope``; with no shards they are
not reached.  ``TrainState.apply_gradients`` passes the state's.

``linear_warmup_cosine``: linear warm-up from 0 to ``base_lr`` over
``warmup_epochs``, then cosine decay to ``eta_min`` at ``max_epochs``,
expressed per optimizer step via ``steps_per_epoch``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

from devt_tpu_torch.config import Config
from devt_tpu_torch.parallel import collectives

Tensors = Sequence[torch.Tensor]
Schedule = Callable[[int], float]


Shards = Sequence | None


def _each(shards: Shards, n: int) -> list:
    """A ``Shard`` or None for each of ``n`` leaves."""
    return [None] * n if shards is None else list(shards)


def _whole_sums(sums: Sequence[torch.Tensor], shards: list) -> list:
    """Each per-leaf sum made the whole leaf's: a sharded leaf's summed
    over its axis (one all-reduce an axis; none without shards)."""
    out = list(sums)
    by_axis: dict = {}
    for i, sh in enumerate(shards):
        if sh is not None:
            by_axis.setdefault(sh.axis, []).append(i)
    for name, idx in by_axis.items():
        for i, total in zip(idx, collectives.psum([out[i] for i in idx],
                                                  name)):
            out[i] = total
    return out


def _lr_at(lr, count: int) -> float:
    return lr(count) if callable(lr) else lr


def _decayed(moments: Tensors, decay: float, like: Tensors) -> list:
    """``decay * moment`` as optax's weak-typed product computes it for a
    moment stored in bf16: the factor rounded to the moment's dtype and the
    product rounded to it too; then cast to the dtype of ``like`` for the
    sum with the gradient term."""
    moments = list(moments)
    if moments and moments[0].dtype != like[0].dtype:
        decay = float(torch.tensor(decay, dtype=moments[0].dtype))
    return [m.to(g.dtype) for m, g in
            zip(torch._foreach_mul(moments, decay), like)]


class ClipByGlobalNorm:
    """Scale all updates by ``max_norm / norm`` when their global norm
    reaches ``max_norm``; decided on the device, without a sync."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def init(self, params: Tensors) -> dict:
        return {}

    def update(self, updates: Tensors, state: dict, params: Tensors,
               shards: Shards = None):
        norms = torch._foreach_norm(updates)
        # a sharded leaf's norm: the root of its parts' squares' sum
        shards = _each(shards, len(norms))
        norms = [n if sh is None else torch.sqrt(sq) for n, sq, sh in zip(
            norms, _whole_sums([n * n for n in norms], shards), shards)]
        g_norm = torch.linalg.vector_norm(torch.stack(norms))
        keep = g_norm < self.max_norm
        return [torch.where(keep, t, (t / g_norm.to(t.dtype)) * self.max_norm)
                for t in updates]


class AddDecayedWeights:
    """``g + wd * p``: L2 decay ahead of the optimizer, or adamW's
    decoupled decay after it."""

    def __init__(self, weight_decay: float):
        self.weight_decay = weight_decay

    def init(self, params: Tensors) -> dict:
        return {}

    def update(self, updates: Tensors, state: dict, params: Tensors,
               shards: Shards = None):
        return torch._foreach_add(updates, list(params),
                                  alpha=self.weight_decay)


class ScaleByAdam:
    """``mu_hat / (sqrt(nu_hat) + eps)`` with bias-corrected moments; the
    first moment is stored in ``mu_dtype``, the update uses it unrounded."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 mu_dtype: torch.dtype | None = None):
        self.b1, self.b2, self.eps, self.mu_dtype = b1, b2, eps, mu_dtype

    def init(self, params: Tensors) -> dict:
        return {"count": 0,
                "mu": [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                       for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(self, updates: Tensors, state: dict, params: Tensors,
               shards: Shards = None):
        b1, b2 = self.b1, self.b2
        updates = list(updates)
        mu = _decayed(state["mu"], b1, updates)
        torch._foreach_add_(mu, torch._foreach_mul(updates, 1 - b1))
        torch._foreach_mul_(state["nu"], b2)
        torch._foreach_add_(state["nu"], torch._foreach_mul(
            torch._foreach_mul(updates, updates), 1 - b2))
        state["count"] += 1
        # the bias corrections in f32, as optax computes them
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(state["count"]))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(state["count"]))
        denom = torch._foreach_div(state["nu"], bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        out = torch._foreach_div(mu, bc1)
        torch._foreach_div_(out, denom)
        if self.mu_dtype is None:
            state["mu"] = mu
        else:
            state["mu"] = [m.to(self.mu_dtype) for m in mu]
        return out


class ScaleByRss:
    """Adagrad: divide by the root of the sum of all squared gradients."""

    def __init__(self, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        self.initial, self.eps = initial_accumulator_value, eps

    def init(self, params: Tensors) -> dict:
        return {"sum_of_squares": [torch.full_like(p, self.initial)
                                   for p in params]}

    def update(self, updates: Tensors, state: dict, params: Tensors,
               shards: Shards = None):
        updates = list(updates)
        acc = state["sum_of_squares"]
        torch._foreach_add_(acc, torch._foreach_mul(updates, updates))
        inv = [torch.where(t > 0, torch.rsqrt(t + self.eps),
                           torch.zeros((), dtype=t.dtype, device=t.device))
               for t in acc]
        return torch._foreach_mul(inv, updates)


class Trace:
    """SGD momentum: ``trace = g + decay * trace``."""

    def __init__(self, decay: float):
        self.decay = decay

    def init(self, params: Tensors) -> dict:
        return {"trace": [torch.zeros_like(p) for p in params]}

    def update(self, updates: Tensors, state: dict, params: Tensors,
               shards: Shards = None):
        torch._foreach_mul_(state["trace"], self.decay)
        torch._foreach_add_(state["trace"], list(updates))
        return [t.clone() for t in state["trace"]]


class ScaleByLearningRate:
    """Multiply by ``-lr`` (``lr`` a float, or a schedule of the count of
    updates so far); ``flip_sign=False`` multiplies by ``+lr``."""

    def __init__(self, lr, flip_sign: bool = True):
        self.lr, self.sign = lr, -1.0 if flip_sign else 1.0

    def init(self, params: Tensors) -> dict:
        return {"count": 0}

    def update(self, updates: Tensors, state: dict, params: Tensors,
               shards: Shards = None):
        step = self.sign * _lr_at(self.lr, state["count"])
        state["count"] += 1
        return torch._foreach_mul(list(updates), step)


def _factored_dims(shape, min_dim_size_to_factor: int):
    """The two largest axes (second largest, largest) when both reach
    ``min_dim_size_to_factor``, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape, kind="stable")
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class ScaleByFactoredRms:
    """Adafactor's scaling by a factored estimate of the gradient RMS:
    leaves with two axes of at least ``min_dim_size_to_factor`` keep row
    and column means of the squared gradient, the rest a full second
    moment; decay ``1 - (step + 1)^-decay_rate``."""

    def __init__(self, decay_rate: float = 0.8,
                 min_dim_size_to_factor: int = 128, epsilon: float = 1e-30):
        self.decay_rate, self.min_dim = decay_rate, min_dim_size_to_factor
        self.epsilon = epsilon

    def init(self, params: Tensors) -> dict:
        v_row, v_col, v = [], [], []
        for p in params:
            dims = _factored_dims(p.shape, self.min_dim)
            one = torch.zeros((1,), dtype=p.dtype, device=p.device)
            if dims is None:
                v_row.append(one), v_col.append(one.clone())
                v.append(torch.zeros_like(p))
                continue
            d1, d0 = dims
            v_row.append(torch.zeros(np.delete(p.shape, d0).tolist(),
                                     dtype=p.dtype, device=p.device))
            v_col.append(torch.zeros(np.delete(p.shape, d1).tolist(),
                                     dtype=p.dtype, device=p.device))
            v.append(one)
        return {"count": 0, "v_row": v_row, "v_col": v_col, "v": v}

    def update(self, updates: Tensors, state: dict, params: Tensors,
               shards: Shards = None):
        beta = float(np.float32(1) - np.float32(state["count"] + 1)
                     ** np.float32(-self.decay_rate))
        out = []
        shards = _each(shards, len(params))
        for i, (g, p, sh) in enumerate(zip(updates, params, shards)):
            dims = _factored_dims(p.shape if sh is None else sh.shape,
                                  self.min_dim)
            if dims is None:
                sq = g * g + self.epsilon
                v = beta * state["v"][i] + (1.0 - beta) * sq
                state["v"][i] = v
                out.append(g * v ** -0.5)
                continue
            if sh is not None:
                # the factored statistics are the whole parameter's
                g = collectives.all_gather(g, sh.axis, sh.dim, sh.groups)
            sq = g * g + self.epsilon
            d1, d0 = dims
            v_row = beta * state["v_row"][i] + (1.0 - beta) * sq.mean(dim=d0)
            v_col = beta * state["v_col"][i] + (1.0 - beta) * sq.mean(dim=d1)
            state["v_row"][i], state["v_col"][i] = v_row, v_col
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) \
                ** -0.5
            col_factor = v_col ** -0.5
            u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            if sh is not None:
                ax = collectives.axis(sh.axis)
                u = collectives.part(u, sh.dim, ax.size, ax.index, sh.groups)
            out.append(u)
        state["count"] += 1
        return out


class ClipByBlockRms:
    """Divide each leaf by ``max(1, rms / threshold)``."""

    def __init__(self, threshold: float):
        self.threshold = threshold

    def init(self, params: Tensors) -> dict:
        return {}

    def update(self, updates: Tensors, state: dict, params: Tensors,
               shards: Shards = None):
        shards = _each(shards, len(updates))
        squares = _whole_sums([torch.sum(u * u) for u in updates], shards)
        means = [sq / (u.numel() if sh is None else math.prod(sh.shape))
                 for u, sq, sh in zip(updates, squares, shards)]
        return [u / torch.clamp(torch.sqrt(m) / self.threshold, min=1.0)
                for u, m in zip(updates, means)]


class Ema:
    """``ema = decay * ema + (1 - decay) * u`` without debiasing; stored in
    ``accumulator_dtype``, passed on unrounded."""

    def __init__(self, decay: float,
                 accumulator_dtype: torch.dtype | None = None):
        self.decay, self.dtype = decay, accumulator_dtype

    def init(self, params: Tensors) -> dict:
        return {"count": 0,
                "ema": [torch.zeros_like(p, dtype=self.dtype or p.dtype)
                        for p in params]}

    def update(self, updates: Tensors, state: dict, params: Tensors,
               shards: Shards = None):
        updates = list(updates)
        ema = _decayed(state["ema"], self.decay, updates)
        torch._foreach_add_(ema, torch._foreach_mul(updates, 1 - self.decay))
        state["count"] += 1
        state["ema"] = ema if self.dtype is None \
            else [e.to(self.dtype) for e in ema]
        return ema


class Scale:
    def __init__(self, factor: float):
        self.factor = factor

    def init(self, params: Tensors) -> dict:
        return {}

    def update(self, updates: Tensors, state: dict, params: Tensors,
               shards: Shards = None):
        return torch._foreach_mul(list(updates), self.factor)


class DecoupledDecay:
    """AdamW-semantics decay for optimizers whose updates are already final
    deltas (adafactor): adds ``-lr_t * wd * p`` to the update."""

    def __init__(self, weight_decay: float, lr):
        self.weight_decay, self.lr = weight_decay, lr

    def init(self, params: Tensors) -> dict:
        return {"count": 0}

    def update(self, updates: Tensors, state: dict, params: Tensors,
               shards: Shards = None):
        lr_t = _lr_at(self.lr, state["count"])
        state["count"] += 1
        return torch._foreach_add(list(updates), list(params),
                                  alpha=-(lr_t * self.weight_decay))


class Chain:
    """Transformations applied in order; the state is the list of theirs."""

    def __init__(self, *parts):
        self.parts = parts

    def init(self, params: Tensors) -> list:
        return [part.init(params) for part in self.parts]

    def update(self, updates: Tensors, state: list, params: Tensors,
               shards: Shards = None):
        for part, part_state in zip(self.parts, state):
            updates = part.update(updates, part_state, params, shards)
        return updates


def linear_warmup_cosine(base_lr: float, warmup_epochs: int,
                         max_epochs: int, steps_per_epoch: int = 1,
                         eta_min: float = 0.0) -> Schedule:
    warmup = max(warmup_epochs * steps_per_epoch, 1)
    total = max(max_epochs * steps_per_epoch, warmup + 1)
    decay_steps = total - warmup
    alpha = eta_min / base_lr if base_lr else 0.0

    def schedule(count: int) -> float:
        if count < warmup:
            return base_lr * count / warmup
        c = min(count - warmup, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def build_optimizer(config: Config, steps_per_epoch: int = 1) -> Chain:
    lr = config.learning_rate
    if config.scheduling and config.model == "contrastive":
        lr = linear_warmup_cosine(lr, config.epochs // 10, config.epochs,
                                  steps_per_epoch)
    wd = config.weight_decay
    opt = config.opt
    # bf16 first moments halve the momentum buffer; nu stays f32: it
    # accumulates squares, where 8 mantissa bits would bias the denominator
    mu_dtype = torch.bfloat16 if config.moment_dtype == "bf16" else None
    if opt == "sgd":
        parts = [AddDecayedWeights(wd), Trace(config.momentum),
                 ScaleByLearningRate(lr)]
    elif opt == "adamW":
        parts = [ScaleByAdam(mu_dtype=mu_dtype), AddDecayedWeights(wd),
                 ScaleByLearningRate(lr)]
    elif opt == "adagrad":
        parts = [AddDecayedWeights(wd), ScaleByRss(), ScaleByLearningRate(lr)]
    elif opt == "adam":
        parts = [AddDecayedWeights(wd), ScaleByAdam(mu_dtype=mu_dtype),
                 ScaleByLearningRate(lr)]
    elif opt == "adafactor":
        # "Adafactor as a drop-in AdamW": absolute step size (no scaling by
        # the parameter's RMS), momentum 0.9, and the decay chained as
        # DecoupledDecay so that every opt= choice keeps the same
        # weight-decay magnitude convention
        parts = [ScaleByFactoredRms(), ClipByBlockRms(1.0),
                 ScaleByLearningRate(lr, flip_sign=False),
                 Ema(0.9, accumulator_dtype=mu_dtype or torch.float32),
                 Scale(-1.0)]
        if wd > 0.0:
            parts.append(DecoupledDecay(wd, lr))
    else:
        raise ValueError(f"unknown optimiser {opt!r}")
    clip = getattr(config, "grad_clip_norm", 0.0)
    if clip and clip > 0.0:
        parts.insert(0, ClipByGlobalNorm(clip))
    return Chain(*parts)
