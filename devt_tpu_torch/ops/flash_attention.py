"""Packed-qkv attention with its backward: the CUDA kernels and their plain
versions.

Port of ``devt_tpu/ops/flash_attention.py``: its constants, and
``fused_mha`` — the packed-qkv single-block attention, forward
(``_mha_fwd_kernel``, ``:558``) and backward (``_mha_bwd_kernel``,
``:589``), wired together by the ``custom_vjp`` at ``:712-733``.  qkv is
(B, S, 3*H*D) with the last axis ordered (3, H, D); per head

    s   = q kᵀ · scale            (f32; key columns ≥ kv_len at -1e30)
    p   = exp(s - max s);  l = Σ p;  lse = max s + log l
    pn  = p / l, with dropout where(keep, pn / (1 - rate), 0)
    o   = (pn cast to v's dtype) @ v             (f32 accumulation)

o is (B, S, H*D) in qkv's dtype and lse (B, S, H) f32, taken before the
dropout mask.  The TPU kernels keep lse broadcast over 128 lanes per head,
a layout of that chip; here it is one value per row and head.  The
backward recomputes p = exp(s - lse) and returns the packed dqkv
(``fused_mha_bwd_plain`` lists its steps and roundings).

Kernels (CUDA C++ for sm_90a): the forward is ``csrc/mha_fwd.cu`` on the
attention body of ``csrc/attention_fwd.cuh``, which it shares with the
fused ViT block (a block per (64 queries, head, sequence), K and V in
shared memory, ``mma.sync`` bf16 tiles, the scores recomputed per pass so
that p is normalised and rounded where the TPU kernel does it).  The
backward is ``csrc/mha_bwd.cu``, FlashAttention-2's split: a launch that
writes delta = rowsum(do · o), then one of blocks that own up to 64
queries of a head and sum their dq over the keys, and blocks that own up
to 64 keys and sum their dk and dv over the queries, each streaming the
other side's rows through shared memory, so that every single-kv-block
length fits; each output has one owner (no atomics: two runs give the
same bits).  bfloat16 is compiled for head dims
16, 32, 64, 128 and 256, float (FMA products) for any multiple of 4; a
shape whose rows do not fit a block's shared memory raises ``ValueError``
with the byte count, before the forward's work when the input needs a
gradient.

Dropout runs inside both kernels: Philox4x32-10 keyed by the call's seed,
its counter (the attention site, flat index over (b, h, q, k)), so the
backward regenerates the forward's mask whatever the two launches' grids.
``mha_dropout_masks`` returns the masks a seed gives (on the card written
by the kernels' own generator, on the CPU drawn from a ``torch.Generator``)
so that the plain versions can be handed the same mask.

``fused_mha`` is a ``torch.autograd.Function``: CUDA tensors launch the
kernels (or raise), CPU tensors run the plain versions.
``fused_mha.launches`` and ``fused_mha.bwd_launches`` count kernel
launches.  The blockwise flash kernels for S > 512 and the split-qkv
single-block kernels (ROADMAP.md queue 2, kernels 9-13) are not ported.
"""

from __future__ import annotations

import ctypes

import torch

# additive key-padding mask value: -1e30, not -inf, keeps a fully masked
# row NaN-free, and exp() turns it into an exact zero next to a real score
NEG_INF = -1e30
_LANES = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# head dims the bfloat16 kernels are instantiated for (csrc/mha_fwd.cu,
# csrc/mha_bwd.cu)
_BF16_HEAD_DIMS = (16, 32, 64, 128, 256)
# dynamic shared memory one block can have on sm_90 (227 KB)
_SMEM_PER_BLOCK = 232448


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _align128(n: int) -> int:
    return _round_up(n, 128)


def fits_single_block(s: int) -> bool:
    """True when a sequence fits one kv block of the single-block
    kernels (the fused ViT block, ``fused_mha``): S rounded up to 128 is
    at most 512."""
    return _round_up(s, _LANES) <= 512


def dropout_cutoff(rate: float) -> int:
    """keep where the 32 random bits are >= this (the JAX kernels' rule,
    ``_dropout_cutoff``)."""
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def _heads(t: torch.Tensor, heads: int, d: int, part: int):
    """The per-head column slices of part ``part`` (0 q, 1 k, 2 v) of a
    packed (B, S, 3HD) tensor, or of a (B, S, HD) one with ``part`` 0."""
    return [t[..., (part * heads + i) * d:(part * heads + i + 1) * d]
            for i in range(heads)]


def mha_dropout_masks(seed: int, rate: float, b: int, s: int, heads: int,
                      device) -> torch.Tensor:
    """The keep mask (B, H, S, S) bool that ``fused_mha`` applies to the
    attention probabilities on ``device`` for this seed and rate (keep
    where the 32 random bits are ≥ ``dropout_cutoff(rate)``): on the card
    the kernels' Philox mask, written by the library's mask kernel; on the
    CPU a mask drawn from a ``torch.Generator`` seeded with ``seed``."""
    device = torch.device(device)
    shape = (b, heads, s, s)
    if device.type == "cpu":
        gen = torch.Generator().manual_seed(int(seed))
        return torch.randint(0, 1 << 32, shape, generator=gen) \
            >= dropout_cutoff(rate)
    from devt_tpu_torch.ops import _build

    lib = _build.load("mha_fwd", _declare_fwd)
    keep = torch.empty(shape, dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.devt_mha_dropout_masks(
            ctypes.c_void_p(keep.data_ptr()), b, heads, s,
            ctypes.c_double(rate), ctypes.c_ulonglong(int(seed)),
            ctypes.c_void_p(stream))
    _check_rc(lib, rc, "mha_dropout_masks")
    return keep.bool()


def fused_mha_plain(qkv: torch.Tensor, heads: int, scale: float,
                    kv_len: int, keep: torch.Tensor | None = None,
                    rate: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel, step by step with the
    TPU kernel's roundings: qkv (B, S, 3HD) → (o (B, S, HD) in qkv's
    dtype, lse (B, S, H) f32).  ``keep``: the (B, H, S, S) mask of a
    ``rate`` > 0, applied after the normalisation."""
    dtype = qkv.dtype
    d = qkv.shape[-1] // (3 * heads)
    col = torch.arange(qkv.shape[1], device=qkv.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=qkv.device)
    zero = torch.zeros((), dtype=torch.float32, device=qkv.device)
    outs, lses = [], []
    for i, (q, k, v) in enumerate(zip(*(_heads(qkv, heads, d, j)
                                        for j in range(3)))):
        s = (q.float() @ k.float().transpose(1, 2)) * scale
        s = torch.where(col < kv_len, s, neg)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        pn = p / l
        if keep is not None:
            pn = torch.where(keep[:, i], pn / (1.0 - rate), zero)
        outs.append((pn.to(dtype).float() @ v.float()).to(dtype))
        lses.append(m + torch.log(l))
    return torch.cat(outs, dim=-1), torch.cat(lses, dim=-1)


def fused_mha_bwd_plain(qkv: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, heads: int,
                        scale: float, kv_len: int,
                        keep: torch.Tensor | None = None,
                        rate: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel, the steps and
    roundings of ``_mha_bwd_kernel``: from qkv, the stored output o and its
    gradient do (qkv's dtype) and lse (B, S, H) f32, per head

        delta = rowsum(f32(do) · f32(o))
        p     = exp(s - lse);  mask = where(keep, 1/(1-rate), 0)
        dv    = (p · mask, cast to do's dtype)ᵀ @ do
        dp    = (do @ vᵀ) · mask;   ds = p · (dp - delta) · scale
        dq    = (ds cast to k's dtype) @ k;  dk = (ds cast to q's dtype)ᵀ @ q

    with every product summed in f32 → dqkv (B, S, 3HD) in qkv's dtype,
    columns ordered like qkv's.  Keys at or past kv_len get exact zeros."""
    dtype = qkv.dtype
    d = qkv.shape[-1] // (3 * heads)
    col = torch.arange(qkv.shape[1], device=qkv.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=qkv.device)
    inv = torch.full((), 1.0 / (1.0 - rate), dtype=torch.float32,
                     device=qkv.device)
    zero = torch.zeros((), dtype=torch.float32, device=qkv.device)
    dqs, dks, dvs = [], [], []
    for i, (q, k, v, oi, doi) in enumerate(zip(
            *(_heads(qkv, heads, d, j) for j in range(3)),
            _heads(o, heads, d, 0), _heads(do, heads, d, 0))):
        do32 = doi.float()
        delta = (do32 * oi.float()).sum(dim=-1, keepdim=True)
        s = (q.float() @ k.float().transpose(1, 2)) * scale
        s = torch.where(col < kv_len, s, neg)
        p = torch.exp(s - lse[..., i:i + 1])
        mask = torch.where(keep[:, i], inv, zero) if keep is not None \
            else None
        pm = p * mask if mask is not None else p
        dvs.append(pm.to(dtype).float().transpose(1, 2) @ do32)
        dp = do32 @ v.float().transpose(1, 2)
        if mask is not None:
            dp = dp * mask
        ds = (p * (dp - delta) * scale).to(dtype).float()
        dqs.append(ds @ k.float())
        dks.append(ds.transpose(1, 2) @ q.float())
    return torch.cat(dqs + dks + dvs, dim=-1).to(dtype)


def _check_mha_args(qkv: torch.Tensor, heads: int, kv_len: int,
                    backward: bool = False) -> int:
    """Raise on what the forward kernel (or, with ``backward``, the
    backward kernel) does not take; returns the head dim."""
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_mha takes float32 or bfloat16 qkv, got "
                        f"{qkv.dtype}")
    if qkv.dim() != 3 or not qkv.is_contiguous():
        raise ValueError(f"qkv must be a contiguous (B, S, 3*H*D) tensor, "
                         f"got shape {tuple(qkv.shape)}")
    _, s, f = qkv.shape
    d = f // (3 * heads)
    if 3 * heads * d != f:
        raise ValueError(f"qkv's last axis ({f}) is not 3 * heads ({heads}) "
                         f"* head dim")
    if not 1 <= kv_len <= s:
        raise ValueError(f"kv_len must be in [1, {s}], got {kv_len}")
    sp = _round_up(s, 16)
    if qkv.dtype == torch.bfloat16:
        if d not in _BF16_HEAD_DIMS:
            raise ValueError(f"the bfloat16 kernel is compiled for head dims "
                             f"{_BF16_HEAD_DIMS}, got {d}")
        if backward:
            # own rows and two buffers of streamed rows (up to 64 rows,
            # padded by 8), two tensors each; lse and delta of the
            # queries, in whole tiles
            r = min(sp, 64)
            need = (6 * _align128(2 * r * (d + 8))
                    + 2 * _align128(4 * _round_up(sp, r)))
        else:
            # 64 queries, and K and V of kv_len rounded up to 32 rows,
            # rows padded by 8
            need = (64 + 2 * _round_up(kv_len, 32)) * (d + 8) * 2
    else:
        if d % 4:
            raise ValueError(f"the float32 kernel needs a head dim that is a "
                             f"multiple of 4, got {d}")
        if backward:
            # own rows, streamed rows and outputs (up to 32 rows, two
            # tensors each); p and ds; lse and delta of the queries
            r = min(sp, 32)
            need = (6 * _align128(4 * r * (d + 4))
                    + 2 * _align128(4 * r * (r + 4))
                    + 2 * _align128(4 * _round_up(sp, r)))
        else:
            need = ((2 * 32 + 2 * sp) * (d + 4) + 32 * (sp + 4) + 64) * 4 \
                + 1024
    if need > _SMEM_PER_BLOCK:
        which = "backward" if backward else "forward"
        raise ValueError(
            f"the {which} kernel keeps a head's rows in shared memory: {s} "
            f"tokens (kv_len {kv_len}) of head dim {d} need {need} bytes, a "
            f"block has {_SMEM_PER_BLOCK}")
    return d


def _check_rc(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.devt_cuda_error_string(rc).decode()} ({rc})")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _mha_cuda(qkv, heads, scale, kv_len, rate=0.0, seed=0):
    d = _check_mha_args(qkv, heads, kv_len)
    from devt_tpu_torch.ops import _build

    lib = _build.load("mha_fwd", _declare_fwd)
    b, s, _ = qkv.shape
    o = torch.empty((b, s, heads * d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, s, heads), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.devt_mha_fwd(
            _DTYPE_CODE[qkv.dtype], _ptr(qkv), _ptr(o), _ptr(lse), b, s,
            heads, d, int(kv_len), ctypes.c_float(scale),
            ctypes.c_double(rate), ctypes.c_ulonglong(seed),
            ctypes.c_void_p(stream))
    _check_rc(lib, rc, "mha_fwd")
    fused_mha.launches += 1
    return o, lse


def _mha_bwd_cuda(qkv, o, lse, do, heads, scale, kv_len, rate=0.0, seed=0):
    d = _check_mha_args(qkv, heads, kv_len, backward=True)
    b, s, _ = qkv.shape
    for name, t, shape, dtype in (
            ("o", o, (b, s, heads * d), qkv.dtype),
            ("do", do, (b, s, heads * d), qkv.dtype),
            ("lse", lse, (b, s, heads), torch.float32)):
        if t.dtype != dtype or tuple(t.shape) != shape \
                or t.device != qkv.device or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dtype} tensor of "
                             f"shape {shape} on {qkv.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    from devt_tpu_torch.ops import _build

    lib = _build.load("mha_bwd", _declare_bwd)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((b, s, heads), dtype=torch.float32,
                        device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.devt_mha_bwd(
            _DTYPE_CODE[qkv.dtype], _ptr(qkv), _ptr(o), _ptr(do), _ptr(lse),
            _ptr(delta), _ptr(dqkv), b, s, heads, d, int(kv_len),
            ctypes.c_float(scale),
            ctypes.c_double(rate), ctypes.c_ulonglong(seed),
            ctypes.c_void_p(stream))
    _check_rc(lib, rc, "mha_bwd")
    fused_mha.bwd_launches += 1
    return dqkv


class FusedMHA(torch.autograd.Function):
    """The packed-qkv attention with its backward: the kernels for CUDA
    tensors, the plain versions for CPU tensors.  Saves (qkv, o, lse) and
    the seed; the backward regenerates the dropout mask from the seed."""

    @staticmethod
    def forward(ctx, qkv, heads, scale, kv_len, rate, seed):
        if qkv.device.type == "cuda":
            if ctx.needs_input_grad[0]:
                # a shape the backward does not take fails before the work
                _check_mha_args(qkv, heads, kv_len, backward=True)
            o, lse = _mha_cuda(qkv, heads, scale, kv_len, rate, seed)
        elif qkv.device.type == "cpu":
            keep = mha_dropout_masks(seed, rate, qkv.shape[0], qkv.shape[1],
                                     heads, qkv.device) if rate > 0.0 \
                else None
            o, lse = fused_mha_plain(qkv, heads, scale, kv_len, keep, rate)
        else:
            raise ValueError(f"fused_mha runs on cuda or cpu, not "
                             f"{qkv.device}")
        ctx.save_for_backward(qkv, o, lse)
        ctx.args = (heads, scale, kv_len, rate, seed)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        qkv, o, lse = ctx.saved_tensors
        heads, scale, kv_len, rate, seed = ctx.args
        # the gradient crosses the kernel boundary in qkv's dtype
        do = do.to(qkv.dtype).contiguous()
        if qkv.device.type == "cuda":
            dqkv = _mha_bwd_cuda(qkv, o, lse, do, heads, scale, kv_len, rate,
                                 seed)
        else:
            keep = mha_dropout_masks(seed, rate, qkv.shape[0], qkv.shape[1],
                                     heads, qkv.device) if rate > 0.0 \
                else None
            dqkv = fused_mha_bwd_plain(qkv, o, lse, do, heads, scale, kv_len,
                                       keep, rate)
        return dqkv, None, None, None, None, None


def fused_mha(qkv: torch.Tensor, *, heads: int, scale: float | None = None,
              kv_len: int | None = None, dropout_rate: float = 0.0,
              seed: int | None = None, return_lse: bool = False):
    """Packed-qkv attention, differentiable in qkv.  qkv (B, S, 3*H*D),
    last axis ordered (3, H, D) → (B, S, H*D); with ``return_lse`` also
    lse (B, S, H) f32 (not differentiable).  Single-kv-block sequences
    only (``fits_single_block``); the callers dispatch longer ones
    elsewhere.

    ``dropout_rate`` > 0 drops attention probabilities after the softmax
    (torch ``MultiheadAttention``'s dropout) and needs ``seed``, an int the
    caller draws once per call (the JAX wrapper draws ``randint(0,
    2**30)``); the backward applies the same mask.

    A CUDA tensor launches the kernels (raising on a shape they do not
    cover or a failed launch); a CPU tensor runs the plain versions."""
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (B, S, 3*H*D), got {tuple(qkv.shape)}")
    d = qkv.shape[-1] // (3 * heads)
    if scale is None:
        scale = d ** -0.5
    kv_len = qkv.shape[1] if kv_len is None else int(kv_len)
    rate = float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 needs a seed")
    o, lse = FusedMHA.apply(qkv, heads, float(scale), kv_len, rate,
                            int(seed) if rate > 0.0 else 0)
    return (o, lse) if return_lse else o


fused_mha.launches = 0
fused_mha.bwd_launches = 0


def _declare_fwd(lib: ctypes.CDLL) -> None:
    lib.devt_mha_fwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_double, ctypes.c_ulonglong,
           ctypes.c_void_p])
    lib.devt_mha_fwd.restype = ctypes.c_int
    lib.devt_mha_dropout_masks.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 3
        + [ctypes.c_double, ctypes.c_ulonglong, ctypes.c_void_p])
    lib.devt_mha_dropout_masks.restype = ctypes.c_int
    lib.devt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.devt_cuda_error_string.restype = ctypes.c_char_p


def _declare_bwd(lib: ctypes.CDLL) -> None:
    lib.devt_mha_bwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_double, ctypes.c_ulonglong,
           ctypes.c_void_p])
    lib.devt_mha_bwd.restype = ctypes.c_int
    lib.devt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.devt_cuda_error_string.restype = ctypes.c_char_p
