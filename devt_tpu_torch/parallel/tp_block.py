"""The Megatron tensor-parallel ViT block, kernels 3 and 4 on each rank's
heads: port of ``devt_tpu/parallel/tp_block.py``.

The layout is Megatron's (Shoeybi et al.): the qkv projection split by
head, the attention output projection by row, the FFN's first product by
column and its second by row.  JAX writes it inside ``jax.shard_map``;
here one process runs each rank of the ``model`` axis
(``parallel/mesh.py``) and the block runs on that rank's slice, with the
packed-qkv attention (``ops/flash_attention.fused_mha``: kernel 3, and
kernel 4 in the backward) on the rank's local heads.

Communication is Megatron's: two all-reduces in the forward (after the
out-projection's partial product and after the FFN's second product:
``collectives.reduce_from``, JAX's ``psum``), two in the backward (at the
inputs of the qkv and first FFN products: ``collectives.copy_to``, where
JAX's ``shard_map`` sums the cotangent of a replicated input).

Parameter layout: :func:`tp_shard_block_params` splits the fused block's
parameter dict (``ops/fused_block.py``: g1/b1/wqkv/wo/bo/g2/b2/w1/bb1/w2/
bb2) into

  * ``rep``: the LayerNorm scales and offsets and the biases added after
    an all-reduce (bo, bb2), whole on every rank;
  * ``shard``: the four matrices and the FFN hidden bias, stacked on a
    leading rank axis, each slice in the ``(3, H/n, d)`` column order the
    packed attention takes;

and :func:`tp_unshard_block_params` inverts the split (also for gradient
trees).

Dropout (the reference's three block sites) as JAX draws it: the
out-projection and FFN-output masks from the block's seed, equal on every
rank of the model axis (the tensors are whole there, after the
all-reduce), the FFN-hidden mask with the rank's model index folded in
(that activation is split by column), and the data index folded in when
the block also splits a batch (DP×TP).
"""

from __future__ import annotations

import torch

from devt_tpu_torch.ops.flash_attention import fused_mha
from devt_tpu_torch.ops.fused_block import _gelu, _ln
from devt_tpu_torch.parallel import collectives

TP_AXIS = "model"

REP_KEYS = ("g1", "b1", "g2", "b2", "bo", "bb2")
# the split leaves: (dim of the (K, N) matrix or row vector, blocks in it)
SPLITS = {"wqkv": (1, 3), "wo": (0, 1), "w1": (1, 1), "bb1": (1, 1),
          "w2": (0, 1)}


def tp_shard_block_params(params: dict, n: int) -> tuple[dict, dict]:
    """Split a fused-block parameter dict into ``(rep, shard)``: ``shard``'s
    tensors stacked on a leading axis of ``n`` slices.  ``wqkv``'s columns
    are packed ``(3, H, d)``; cutting each of the q, k, v thirds into ``n``
    lands on head boundaries when ``H % n == 0``."""
    shard = {k: torch.stack(collectives.parts(params[k], dim, n, groups))
             for k, (dim, groups) in SPLITS.items()}
    rep = {k: params[k] for k in REP_KEYS}
    return rep, shard


def tp_unshard_block_params(rep: dict, shard: dict) -> dict:
    """The inverse of :func:`tp_shard_block_params` (also maps gradient
    trees back to the whole layout)."""
    out = dict(rep)
    for k, (dim, groups) in SPLITS.items():
        out[k] = collectives.join(list(shard[k]), dim, groups)
    return out


def _keep(seed: int, shape, rate: float, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device) >= rate


def _drop(t: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    keep = _keep(seed, t.shape, rate, t.device)
    return torch.where(keep, t / (1.0 - rate),
                       torch.zeros((), dtype=t.dtype, device=t.device))


def fold_in(seed: int, index: int) -> int:
    """``jax.random.fold_in``'s role: a seed below 2**63 from ``seed`` and
    ``index`` (splitmix64's finalizer over their mix)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (int(index) + 1)
         * 0xD1B54A32D192ED03) & (2 ** 64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2 ** 64 - 1)
    return (z ^ (z >> 31)) >> 1


def _mm(a: torch.Tensor, w: torch.Tensor, dtype: torch.dtype
        ) -> torch.Tensor:
    """``a @ w`` on operands rounded to ``dtype``, the product in f32
    (``preferred_element_type=f32``; bf16 products accumulate in f32 and
    round to bf16 before the widening)."""
    return torch.matmul(a.to(dtype), w.to(dtype)).float()


def tp_block_local(x: torch.Tensor, rep: dict, w: dict, *,
                   heads_local: int, scale: float, kv_len: int,
                   axis_name: str = TP_AXIS, rate: float = 0.0,
                   seed: int = 0) -> torch.Tensor:
    """One rank's slice of the block (inside the axes'
    ``collectives.axis_scope``): ``x`` (B, S, D) whole on every rank of the
    model axis, ``w`` this rank's slices (``wqkv`` (D, 3·h·d), ``wo``
    (h·d, D), ``w1`` (D, F/n), ``bb1`` (1, F/n), ``w2`` (F/n, D)).  The
    attention is ``fused_mha`` on the ``heads_local`` heads; ``seed`` the
    block's dropout seed, the same on every rank of the axis."""
    dtype = x.dtype
    if rate > 0.0:
        ax = collectives.axis(axis_name)
        k1, k2, k3 = (fold_in(seed, i) for i in range(3))
        k2 = fold_in(k2, ax.index)
    x32 = x.float()
    a = _ln(x32, rep["g1"].float(), rep["b1"].float())[0]
    a = collectives.copy_to(a, axis_name)
    qkv = _mm(a, w["wqkv"], dtype)
    att = fused_mha(qkv.to(dtype).contiguous(), heads=heads_local,
                    scale=scale, kv_len=kv_len)
    part = _mm(att, w["wo"], dtype)
    oproj = collectives.reduce_from(part, axis_name) + rep["bo"].float()
    if rate > 0.0:
        oproj = _drop(oproj, k1, rate)
    u = x32 + oproj
    h2 = _ln(u, rep["g2"].float(), rep["b2"].float())[0]
    h2 = collectives.copy_to(h2, axis_name)
    h = _gelu(_mm(h2, w["w1"], dtype) + w["bb1"].float())
    if rate > 0.0:
        h = _drop(h, k2, rate)
    z2 = collectives.reduce_from(_mm(h, w["w2"], dtype), axis_name) \
        + rep["bb2"].float()
    if rate > 0.0:
        z2 = _drop(z2, k3, rate)
    return (u + z2).to(dtype)


def tp_vit_block_sharded(x: torch.Tensor, rep: dict, shard: dict, mesh, *,
                         heads: int, scale: float | None = None,
                         kv_len: int | None = None, axis: str = TP_AXIS,
                         batch_axis: str | None = None,
                         dropout_rate: float = 0.0,
                         dropout_seed: int | None = None) -> torch.Tensor:
    """The tensor-parallel block on pre-split parameters, called on every
    rank of ``mesh`` with the same arguments (JAX's global view): ``x`` the
    whole batch, ``rep`` whole, ``shard`` stacked; returns the whole
    output, and gradients flow back to ``x``, ``rep`` and ``shard`` whole
    on every rank (each rank's slice of ``shard`` is gathered in the
    backward, and the ranks' rows of a ``batch_axis`` summed into the
    parameters' gradients).

    ``batch_axis`` composes DP×TP on a 2-axis mesh: each rank runs its
    rows of the batch on its heads, and the all-reduces ride only the
    model axis.  ``dropout_seed``: an int, needed when ``dropout_rate`` >
    0."""
    n = mesh.shape[axis]
    b, s, dim = x.shape
    if heads % n:
        raise ValueError(f"{heads} heads do not split over {n} ranks")
    rate = float(dropout_rate)
    if rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 needs a dropout_seed")
    seed = int(dropout_seed or 0)
    with collectives.axis_scope(mesh.axes()):
        if batch_axis is not None:
            seed = fold_in(seed, collectives.axis(batch_axis).index)
            # the parameters are whole over the batch axis: their
            # cotangents are summed over its ranks' rows
            rep = {k: collectives.copy_to(v, batch_axis)
                   for k, v in rep.items()}
            shard = {k: collectives.copy_to(v, batch_axis)
                     for k, v in shard.items()}
            x = collectives.local_slice(x, batch_axis, 0)
        w = {k: collectives.local_slice(v, axis, 0)[0]
             for k, v in shard.items()}
        y = tp_block_local(
            x, rep, w, heads_local=heads // n,
            scale=(dim // heads) ** -0.5 if scale is None else scale,
            kv_len=s if kv_len is None else kv_len, axis_name=axis,
            rate=rate, seed=seed)
        if batch_axis is not None:
            y = collectives.gather_replicated(y, batch_axis, 0)
    return y


def tp_vit_block(x: torch.Tensor, params: dict, mesh, *, heads: int,
                 scale: float | None = None, kv_len: int | None = None,
                 axis: str = TP_AXIS, batch_axis: str | None = None,
                 dropout_rate: float = 0.0,
                 dropout_seed: int | None = None) -> torch.Tensor:
    """:func:`tp_vit_block_sharded` from the whole single-device parameter
    dict, split on every call."""
    rep, shard = tp_shard_block_params(params, mesh.shape[axis])
    return tp_vit_block_sharded(x, rep, shard, mesh, heads=heads,
                                scale=scale, kv_len=kv_len, axis=axis,
                                batch_axis=batch_axis,
                                dropout_rate=dropout_rate,
                                dropout_seed=dropout_seed)
