"""Ring / context-parallel attention over a sequence split across ranks.

Port of ``devt_tpu/parallel/ring_attention.py``.  K/V live split over the
ranks of a ``torch.distributed`` process group (JAX: a mesh axis); each
rank keeps its local q chunk, and the kv chunks rotate around the ring
(rank r sends to r + 1 and receives from r - 1, ``dist.batch_isend_irecv``
through ``collectives.sendrecv``: under Gloo a CUDA tensor is staged
through the host, under NCCL it is sent from the card) while the flash
combine (running
max, normaliser, unnormalised output) merges the per-chunk partials.
``group=None`` is a ring of one rank; otherwise n is the group's size.

Two tiers, as in JAX:

  * ``ring_attention_local`` (``_local_block`` per hop): plain PyTorch in
    f32, any shape, differentiable through autograd (the rotation's
    backward sends the gradient the other way round).  No Pallas kernel is
    involved there in JAX either.
  * ``ring_mha_split``: every hop in the ring-step kernels
    (``ops/flash_attention.ring_step_fwd`` / ``ring_step_bwd``, kernels 14
    and 15; their plain versions for CPU tensors), the whole ring one
    ``torch.autograd.Function`` whose backward re-rotates kv, sums dq on
    the rank and lets each chunk's dkv travel with it until it is home.

The kv chunk rotates only between hops, n - 1 times a pass, forward and
backward (JAX also sends it after the last hop, a send whose result is
unused); the dkv accumulator makes all n hops, the last one home.  The
results are the same.  ``ring_mha_split.kv_sends`` and ``.dkv_sends``
count the sends.

The shard_map-taking ``ring_attention`` and ``ring_vit_block`` take the
global tensors on every rank, run the rank's chunk and all-gather the
output, which is what ``shard_map``'s ``out_specs`` gives back.  Their
gradients reach the input whole on every rank; a replicated parameter's
gradient is the rank's share, to be summed over the group (``all_reduce``)
as a data-parallel step does.

Sequence parallelism (``config.sp``): the ``sp_shard_map`` executors
(``parallel/train_step.py``) set :func:`sp_scope` to the (data, seq)
mesh around the step, and ``models/layers.py:ViTTransformer(
sequence_parallel=True)`` then runs every block of its stacked layout as
:func:`_ring_block_local` over the ``seq`` axis' group
(:func:`sp_group`), on the rank's chunk of the tokens.  A hop's send goes
through ``parallel/collectives.sendrecv``: a CUDA tensor is staged
through the host under Gloo (which takes no point-to-point send from the
card) and sent from the card under NCCL.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist
import torch.nn.functional as F

from devt_tpu_torch.ops.flash_attention import (fits_single_block, fused_mha,
                                                ring_step_bwd, ring_step_fwd)
from devt_tpu_torch.ops.fused_block import _gelu, _ln
from devt_tpu_torch.parallel.collectives import sendrecv

NEG_INF = -1e30
SEQ_AXIS = "seq"

_sp_gate = threading.local()


@contextlib.contextmanager
def sp_scope(mesh):
    """Context in which a stack of ViT blocks runs sequence-parallel over
    ``mesh``'s ``seq`` axis (JAX: the mesh the ``sp_shard_map`` step
    factories set around their trace).  Re-entrant, thread-local, bounded
    by the ``with``."""
    prev = getattr(_sp_gate, "mesh", None)
    _sp_gate.mesh = mesh
    try:
        yield
    finally:
        _sp_gate.mesh = prev


def active_sp_mesh():
    """The mesh set by :func:`sp_scope`, or None."""
    return getattr(_sp_gate, "mesh", None)


def sp_group(mesh):
    """The process group of ``mesh``'s ``seq`` axis that this rank lies on
    (the default group when the axis is the whole world), and the axis'
    size."""
    ax = mesh.axes()[SEQ_AXIS]
    group = ax.group if ax.group is not None else dist.group.WORLD
    return group, ax.size


def _rank_and_size(group) -> tuple[int, int]:
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _rotate(t: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """t sent to the rank ``step`` places on around the ring, and the
    tensor of the rank ``step`` places back received in its place."""
    rank, n = _rank_and_size(group)
    return sendrecv(t, group, (rank + step) % n, (rank - step) % n)


class _Rotate(torch.autograd.Function):
    """One hop of the ring under autograd: the gradient goes back round."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _rotate(t, group)

    @staticmethod
    def backward(ctx, g):
        return _rotate(g, ctx.group, step=-1), None


class _Chunk(torch.autograd.Function):
    """This rank's chunk of a global tensor along ``dim``; the backward
    gathers every rank's chunk of the gradient, so the input's gradient is
    whole on every rank."""

    @staticmethod
    def forward(ctx, t, dim, group):
        rank, n = _rank_and_size(group)
        size = t.shape[dim] // n
        ctx.args = (dim, group)
        return t.narrow(dim, rank * size, size).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        dim, group = ctx.args
        return _all_gather(g, dim, group), None, None


class _Gather(torch.autograd.Function):
    """Every rank's chunk, concatenated along ``dim``; the backward hands
    the rank its own chunk of the gradient (the same on every rank, which
    computes the same loss from the same gathered tensor)."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.args = (dim, group, t.shape[dim])
        return _all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        dim, group, size = ctx.args
        rank, _ = _rank_and_size(group)
        return g.narrow(dim, rank * size, size).contiguous(), None, None


def _all_gather(t, dim, group):
    _, n = _rank_and_size(group)
    parts = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
             for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _local_block(q, k, v, *, scale: float, col_offset: int, kv_len: int):
    """One flash block: (unnormalised o, row max m, partial l), all f32.
    q (B, H, Sq, D); k, v (B, H, Skv, D) the chunk whose first row is
    global column ``col_offset``; columns at or past ``kv_len`` (the true
    global length) are padding."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    col = torch.arange(k.shape[2], device=q.device) + col_offset
    s = torch.where(col < kv_len, s, torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = p.to(v.dtype).float() @ v.float()
    return o, m, l


def ring_attention_local(q, k, v, *, group=None, scale: float | None = None,
                         kv_len: int | None = None):
    """Ring attention body on this rank's chunks q, k, v (B, H, S/n, D)
    (the sequence split over ``group``) → the local (B, H, S/n, D) output
    in q's dtype.  ``kv_len``: the true global kv length (default all)."""
    rank, n = _rank_and_size(group)
    chunk = k.shape[2]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if kv_len is None:
        kv_len = n * chunk
    q32 = q.float()
    acc = torch.zeros_like(q32)
    m = torch.full(q32.shape[:-1] + (1,), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    for t in range(n):
        # after t rotations this rank holds kv chunk (rank - t) mod n
        blk = (rank - t) % n
        o_u, m_blk, l_blk = _local_block(q32, k, v, scale=scale,
                                         col_offset=blk * chunk,
                                         kv_len=kv_len)
        m_new = torch.maximum(m, m_blk)
        a1, a2 = torch.exp(m - m_new), torch.exp(m_blk - m_new)
        acc = acc * a1 + o_u * a2
        l = l * a1 + l_blk * a2
        m = m_new
        if t < n - 1:
            k, v = _Rotate.apply(k, group), _Rotate.apply(v, group)
    return (acc / l).to(q.dtype)


def ring_attention(q, k, v, group=None, *, scale: float | None = None,
                   kv_len: int | None = None):
    """Context-parallel attention on global (B, H, S, D) q, k, v, the same
    on every rank of ``group``: the rank's chunk of S through
    :func:`ring_attention_local`, then every rank's output gathered.  S
    must divide by the group's size."""
    _, n = _rank_and_size(group)
    if q.shape[2] % n:
        raise ValueError(f"S = {q.shape[2]} does not divide over {n} ranks")
    if n == 1:
        return ring_attention_local(q, k, v, scale=scale, kv_len=kv_len)
    out = ring_attention_local(*(_Chunk.apply(t, 2, group) for t in (q, k, v)),
                               group=group, scale=scale, kv_len=kv_len)
    return _Gather.apply(out, 2, group)


# ---------------------------------------------------------------------------
# The kernel-backed ring: every hop in kernels 14 and 15
# ---------------------------------------------------------------------------

def _colmask(blk: int, s_chunk: int, s_p: int, kv_len: int,
             device) -> torch.Tensor:
    """(1, s_p) additive f32 mask for kv chunk ``blk``: local row j covers
    global column blk·s_chunk + j; rows past ``s_chunk`` are the chunk's
    tile padding, columns past ``kv_len`` global padding."""
    j = torch.arange(s_p, device=device)[None, :]
    valid = (j < s_chunk) & (blk * s_chunk + j < kv_len)
    return torch.where(valid, 0.0, NEG_INF).to(torch.float32)


def _combine(o, lse, o_i, lse_i, heads: int):
    """Flash combine of two per-head block-normalised partials: o (B, S,
    H·D) the f32 accumulator, o_i the hop's output, lse and lse_i (B, S, H)
    f32."""
    b, s, hd = o.shape
    oh = o.reshape(b, s, heads, hd // heads)
    oih = o_i.float().reshape(b, s, heads, hd // heads)
    mx = torch.maximum(lse, lse_i)
    w = torch.exp(lse - mx)[..., None]
    wi = torch.exp(lse_i - mx)[..., None]
    o_new = (oh * w + oih * wi) / (w + wi)
    lse_new = mx + torch.log(torch.exp(lse - mx) + torch.exp(lse_i - mx))
    return o_new.reshape(b, s, hd), lse_new


def _lse_heads(lse, heads: int):
    """A kernel's lse as (B, S, H): the TPU kernels' (B, S, H·128), one
    value broadcast over 128 lanes per head, or the port's compact
    (B, S, H), which passes unchanged."""
    b, s, _ = lse.shape
    return lse.reshape(b, s, heads, -1)[..., 0]


class _RingMHA(torch.autograd.Function):
    """The kernel ring as one Function (JAX: one ``custom_vjp``).  Forward:
    a hop per kv chunk through kernel 14, the flash combine in f32, o in
    q's dtype.  Backward: the hops again through kernel 15 against the
    global lse; dq sums on the rank, each chunk's dkv travels with it and
    comes home after n hops."""

    @staticmethod
    def forward(ctx, q, kv, heads, scale, kv_len, s_chunk, group):
        rank, n = _rank_and_size(group)
        b, s_p, hd = q.shape
        if n == 1:
            o, lse = ring_step_fwd(
                q, kv, _colmask(0, s_chunk, s_p, kv_len, q.device),
                heads=heads, scale=scale)
            lse = _lse_heads(lse, heads)
        else:
            o = torch.zeros((b, s_p, hd), dtype=torch.float32,
                            device=q.device)
            lse = torch.full((b, s_p, heads), NEG_INF, device=q.device)
            kv_cur = kv
            for t in range(n):
                blk = (rank - t) % n
                o_i, lse_i = ring_step_fwd(
                    q, kv_cur, _colmask(blk, s_chunk, s_p, kv_len, q.device),
                    heads=heads, scale=scale)
                o, lse = _combine(o, lse, o_i, _lse_heads(lse_i, heads),
                                  heads)
                if t < n - 1:
                    kv_cur = _rotate(kv_cur, group)
                    ring_mha_split.kv_sends += 1
            o = o.to(q.dtype)
        ctx.save_for_backward(q, kv, o, lse)
        ctx.args = (heads, scale, kv_len, s_chunk, group)
        return o

    @staticmethod
    def backward(ctx, do):
        q, kv, o, lse = ctx.saved_tensors
        heads, scale, kv_len, s_chunk, group = ctx.args
        rank, n = _rank_and_size(group)
        s_p = q.shape[1]
        do = do.to(q.dtype).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        kv_cur = kv
        for t in range(n):
            blk = (rank - t) % n
            dq_p, dkv_p = ring_step_bwd(
                q, kv_cur, _colmask(blk, s_chunk, s_p, kv_len, q.device), o,
                lse, do, heads=heads, scale=scale)
            dq = dq + dq_p
            dkv = dkv + dkv_p
            if n > 1:
                # the accumulator travels with its chunk: after n hops it
                # holds every rank's terms and is home
                if t < n - 1:
                    kv_cur = _rotate(kv_cur, group)
                    ring_mha_split.kv_sends += 1
                dkv = _rotate(dkv, group)
                ring_mha_split.dkv_sends += 1
        return dq.to(q.dtype), dkv.to(kv.dtype), None, None, None, None, None


def ring_mha_split(q, kv, *, heads: int, scale: float | None = None,
                   kv_len: int | None = None, group=None):
    """Ring attention on this rank's q (B, S/n, H·D) and packed kv
    (B, S/n, 2·H·D), k of head i at columns i·D and v at (H + i)·D, the
    sequence split over ``group`` (None: one rank).  ``kv_len`` is the
    true GLOBAL kv length (default all); tile padding beyond it is masked.
    The chunk pads to a multiple of 16 rows; every hop runs in kernels 14
    and 15 (their plain versions for CPU tensors)."""
    _, n = _rank_and_size(group)
    b, s_chunk, hd = q.shape
    if scale is None:
        scale = (hd // heads) ** -0.5
    if kv_len is None:
        kv_len = n * s_chunk
    s_p = -(-s_chunk // 16) * 16
    if s_p != s_chunk:
        q = F.pad(q, (0, 0, 0, s_p - s_chunk))
        kv = F.pad(kv, (0, 0, 0, s_p - s_chunk))
    o = _RingMHA.apply(q.contiguous(), kv.contiguous(), heads, float(scale),
                       int(kv_len), s_chunk, group)
    return o[:, :s_chunk]


ring_mha_split.kv_sends = 0
ring_mha_split.dkv_sends = 0


def ring_mha(qkv, *, heads: int, scale: float | None = None,
             kv_len: int | None = None, group=None):
    """Packed-qkv ring attention on this rank's qkv (B, S/n, 3·H·D) in
    fused_mha's (3, H, D) order → (B, S/n, H·D).  A ring of one rank is
    single-device attention, so it goes straight to ``fused_mha`` (kernel
    3); longer rings split once and rotate kv (:func:`ring_mha_split`)."""
    _, n = _rank_and_size(group)
    if n == 1:
        return fused_mha(qkv.contiguous(), heads=heads, scale=scale,
                         kv_len=kv_len)
    hd = qkv.shape[-1] // 3
    return ring_mha_split(qkv[..., :hd], qkv[..., hd:], heads=heads,
                          scale=scale, kv_len=kv_len, group=group)


# ---------------------------------------------------------------------------
# A sequence-parallel pre-norm ViT block: everything but attention is per
# token, so only the kv chunks ride the ring
# ---------------------------------------------------------------------------

def _dot(a, w, dtype):
    """a @ w on operands rounded to ``dtype``, summed in f32 (JAX's
    model-dtype matmul with an f32 result)."""
    return a.to(dtype).float() @ w.to(dtype).float()


def _ring_block_local(x, params, *, heads: int, scale: float, kv_len: int,
                      group=None, impl: str = "auto"):
    """This rank's chunk of a pre-norm ViT block, x (B, S/n, D); the math
    of ``ops/fused_block.reference_vit_block`` with the attention swapped
    for the ring.  ``params``: the fused block's dict (g1, b1, wqkv, wo,
    bo, g2, b2, w1, bb1, w2, bb2).

    ``impl``: ``"pallas"`` runs every hop in the ring kernels with
    model-dtype products around them (on CPU tensors the kernels' plain
    versions); ``"jnp"`` the f32 tier (:func:`ring_attention_local`);
    ``"auto"`` the kernels for CUDA tensors when the chunk fits one kv
    block (JAX: on the TPU), else the f32 tier."""
    if impl not in ("auto", "pallas", "jnp"):
        raise ValueError(f"unknown ring impl {impl!r}")
    f32 = torch.float32
    _, n = _rank_and_size(group)
    b, s_local, dim = x.shape
    d = dim // heads
    hd = heads * d
    use_kernel = impl == "pallas" or (
        impl == "auto" and fits_single_block(s_local)
        and x.device.type == "cuda")
    p = params
    x32 = x.float()
    a, _, _, _ = _ln(x32, p["g1"].float(), p["b1"].float())
    if use_kernel:
        dt = x.dtype
        if n == 1:
            att = ring_mha(_dot(a, p["wqkv"], dt).to(dt), heads=heads,
                           scale=scale, kv_len=kv_len)
        else:
            # q and the rotating kv as two products (no slice copies)
            att = ring_mha_split(
                _dot(a, p["wqkv"][:, :hd], dt).to(dt),
                _dot(a, p["wqkv"][:, hd:], dt).to(dt), heads=heads,
                scale=scale, kv_len=kv_len, group=group)
        u = x32 + _dot(att, p["wo"], dt) + p["bo"].float()
        h2, _, _, _ = _ln(u, p["g2"].float(), p["b2"].float())
        ff = _gelu(_dot(h2, p["w1"], dt) + p["bb1"].float())
        y = u + _dot(ff, p["w2"], dt) + p["bb2"].float()
        return y.to(x.dtype)

    qkv = a @ p["wqkv"].float()

    def split(t):  # heads are contiguous i·d slices (fused-block layout)
        return t.reshape(b, s_local, heads, d).transpose(1, 2)

    q, k, v = (split(qkv[..., i * hd:(i + 1) * hd]) for i in range(3))
    att = ring_attention_local(q, k, v, group=group, scale=scale,
                               kv_len=kv_len)
    att = att.transpose(1, 2).reshape(b, s_local, hd).float()
    u = x32 + att @ p["wo"].float() + p["bo"].float()
    h2, _, _, _ = _ln(u, p["g2"].float(), p["b2"].float())
    ff = _gelu(h2 @ p["w1"].float() + p["bb1"].float())
    y = u + ff @ p["w2"].float() + p["bb2"].float()
    return y.to(x.dtype)


def ring_vit_block(x, params, group=None, *, heads: int,
                   scale: float | None = None, kv_len: int | None = None,
                   impl: str = "auto"):
    """Context-parallel pre-norm ViT block: global x (B, S, D), the same on
    every rank of ``group``, S divisible by its size; ``params`` the fused
    block's dict, replicated.  Each rank runs its chunk of S
    (:func:`_ring_block_local`) and the chunks are gathered."""
    _, n = _rank_and_size(group)
    b, s, dim = x.shape
    if s % n:
        raise ValueError(f"S = {s} does not divide over {n} ranks")
    d = dim // heads
    kw = dict(heads=heads, scale=d ** -0.5 if scale is None else scale,
              kv_len=s if kv_len is None else kv_len, group=group, impl=impl)
    if n == 1:
        return _ring_block_local(x, params, **kw)
    y = _ring_block_local(_Chunk.apply(x, 1, group), params, **kw)
    return _Gather.apply(y, 1, group)
