"""Core transformer building blocks: port of ``devt_tpu/models/layers.py``.

Batch-major layouts ``(B, S, D)`` throughout, as in the JAX package.
Parameters stay f32; ``dtype`` is the compute type that activations and
weights are cast to at each product, as flax's ``dtype=`` does.  Module
and parameter names follow the flax tree (``attn_norm``, ``attn.to_qkv``,
``attn.to_out``, ``ff_norm``, ``ff.fc1``, ``ff.fc2``, ``blocks.<i>`` for
``block_<i>``, ``norm``; an MoE block's expert leaves ``moe_router``,
``moe_w1``, ``moe_b1``, ``moe_w2``, ``moe_b2`` in the flax layout), so
``utils/jax_bridge.py`` maps one onto the other by name.

Dropout is explicit, as flax's ``rngs={"dropout": key}`` is: a training
forward takes a ``DropoutRng`` and hands it down to every dropout site.
Nothing draws from PyTorch's global random state, so a step's masks
depend only on the seed the caller made the ``DropoutRng`` from.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from devt_tpu_torch.ops.attention import (active_tp_mesh, packed_mha,
                                          quant_active, tp_pallas_scope)
from devt_tpu_torch.ops.flash_attention import fits_single_block
from devt_tpu_torch.ops.fused_block import (fused_attn_half,
                                            fused_block_eligible,
                                            fused_vit_block,
                                            reference_vit_block)
from devt_tpu_torch.ops.quant import (quant_block_params, quant_vit_block,
                                      site_value)
from devt_tpu_torch.parallel import collectives, moe, tp_block
from devt_tpu_torch.parallel.collectives import axis, copy_to, reduce_from
from devt_tpu_torch.parallel.mesh import MODEL_AXIS, PIPE_AXIS, SEQ_AXIS
from devt_tpu_torch.parallel.moe import moe_ffn_dense
from devt_tpu_torch.parallel.pipeline import (active_pipe_mesh,
                                             pipelined_stack)
from devt_tpu_torch.parallel.ring_attention import (_ring_block_local,
                                                    active_sp_mesh, sp_group)

# torch's LayerNorm eps, which the reference uses everywhere
LN_EPS = 1e-5

_LECUN_TRUNC = 0.87962566103423978  # std of a unit normal truncated to ±2


class DropoutRng:
    """The randomness of one training forward.

    Seeds for the in-kernel dropout of the fused block and of the
    packed-qkv attention come from a host generator (one ``randint(0,
    2**30)`` per kernel call, as the JAX wrappers draw, with no device
    synchronisation); masks of the unfused sites come from a generator on
    the tensor's device.  Both are seeded from
    ``seed`` alone."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._host = torch.Generator().manual_seed(self.seed)
        self._device: dict[torch.device, torch.Generator] = {}

    def block_seed(self) -> int:
        return int(torch.randint(0, 1 << 30, (1,), generator=self._host))

    def split(self, n: int = 2) -> list["DropoutRng"]:
        """``n`` independent streams, seeded from this one's host
        generator (``jax.random.split``'s role)."""
        return [DropoutRng(int(torch.randint(0, 1 << 62, (1,),
                                             generator=self._host)))
                for _ in range(n)]

    def keep(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if x.device.type == "cpu":
            gen = self._host
        else:
            gen = self._device.get(x.device)
            if gen is None:
                gen = torch.Generator(device=x.device).manual_seed(self.seed)
                self._device[x.device] = gen
        return torch.rand(x.shape, generator=gen, device=x.device) >= rate

    def snapshot(self) -> "DropoutRng":
        """A copy that makes, from here on, the draws this one makes: the
        host generator's state and each device generator's.  Drawing from
        either leaves the other where it was."""
        copy = DropoutRng.__new__(DropoutRng)
        copy.seed = self.seed
        copy._host = torch.Generator()
        copy._host.set_state(self._host.get_state())
        copy._device = {}
        for device, gen in self._device.items():
            copy._device[device] = torch.Generator(device=device)
            copy._device[device].set_state(gen.get_state())
        return copy


def _thread_scopes():
    """A context manager that binds again the thread-local scopes a block
    reads, as they stand now."""
    axes, ep, tp_mesh = (collectives.bound_axes(), moe.active_moe_ep(),
                         active_tp_mesh())

    @contextlib.contextmanager
    def bind():
        with contextlib.ExitStack() as stack:
            stack.enter_context(collectives.axis_scope(axes))
            if ep is not None:
                stack.enter_context(moe.moe_ep_scope(*ep))
            if tp_mesh is not None:
                stack.enter_context(tp_pallas_scope(tp_mesh))
            yield

    return bind


def remat(module: nn.Module, args, x: torch.Tensor,
          rng: DropoutRng | None) -> torch.Tensor:
    """``module(*args(x, rng, True))`` with its activations
    rematerialised: ``torch.utils.checkpoint`` (non-reentrant) keeps none
    of the tensors it saves for the backward and runs the module again, on
    ``args(x, replay, False)``, when the backward needs them (the
    counterpart of flax's ``nn.remat``).

    The tensors the module runs with are checkpoint arguments: its
    parameters as they are bound now (inside a step's
    ``torch.func.functional_call``: a rank's gathered FSDP weights, the
    tensor-parallel parts of ``sharding.tp_parts``), bound again by
    ``torch.func.functional_call`` in the forward and in the replay.  The
    backward runs after the step's binding has put the module's own
    tensors back (a rank's slices), so the replay takes its tensors from
    the checkpoint's arguments and not from the module, as
    ``parallel/pipeline.py:pipeline_apply`` hands its stage its
    parameters.

    ``replay`` is a snapshot of ``rng`` taken before the forward, so the
    recompute draws the kernels' seeds and the unfused sites' masks that
    the forward drew, and ``rng`` stays where the forward left it; the
    global random state is not involved (``preserve_rng_state`` off).  The
    third argument of ``args`` tells whether this is the forward, so that
    a side effect (an MoE block's load-balance term appended to
    ``losses``) happens once.  The recompute's saved tensors come back in
    the order of the forward's; a kernel's forward (kernel 1's u and res,
    kernel 7's residuals) runs twice.

    The recompute runs inside the thread-local scopes the forward ran in
    (the mesh's bound axes, ``moe_ep_scope``, ``tp_pallas_scope``): for
    CUDA tensors autograd replays it on its device thread, which does not
    see the calling thread's."""
    start = rng.snapshot() if rng is not None else None
    scopes = _thread_scopes()
    bound = dict(module.named_parameters())
    names = list(bound)
    calls = 0

    def run(h: torch.Tensor, *tensors: torch.Tensor) -> torch.Tensor:
        nonlocal calls
        calls += 1
        r = rng if calls == 1 or start is None else start.snapshot()
        with scopes():
            return torch.func.functional_call(
                module, dict(zip(names, tensors)), args(h, r, calls == 1))

    return checkpoint(run, x, *bound.values(), use_reentrant=False,
                      preserve_rng_state=False)


def dropout(x: torch.Tensor, rate: float, training: bool,
            rng: DropoutRng | None) -> torch.Tensor:
    """Inverted dropout from an explicit ``DropoutRng``; the identity in
    evaluation or at rate 0."""
    if not training or rate == 0.0:
        return x
    if rng is None:
        raise ValueError("a training forward with dropout needs rng=, a "
                         "DropoutRng (models/layers.py)")
    return torch.where(rng.keep(x, rate), x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: truncated normal of variance 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / _LECUN_TRUNC
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default initializers over every Linear, convolution,
    LayerNorm and MoE block below ``module``: lecun-normal kernels, zero
    biases, unit LN scales; an MoE block's router normal(0.01) and its (E, ...) expert
    kernels lecun-normal with the expert axis counted in the fan-in, as
    flax's ``lecun_normal`` counts it; a stacked ``ViTTransformer``'s
    ``pb_*`` leaves as JAX's ``_stacked_block_params`` (matrices
    lecun-normal over their own fan-in, LN scales 1, the rest 0)."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.Conv2d, nn.Conv3d)):
            # flax's Conv: the fan-in is the receptive field times cin
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, MoEViTBlock):
            nn.init.normal_(m.moe_router, 0.0, 0.01, generator=generator)
            for w in (m.moe_w1, m.moe_w2):
                lecun_normal_(w, w.shape[0] * w.shape[1], generator)
            nn.init.zeros_(m.moe_b1)
            nn.init.zeros_(m.moe_b2)
        elif isinstance(m, ViTTransformer) and m.stacked:
            m.init_stacked(generator)


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in at least f32, the type the JAX package's sums and means of
    a bf16 tensor accumulate in before they round back."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """flax ``LayerNorm(dtype=...)``: f32 statistics, output in ``dtype``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(dtype)


def dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: input, kernel and bias cast to ``dtype``."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def kernel_matrix(lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """A Linear weight in the fused kernels' (K, N) layout and the compute
    dtype, transposed and cast in one copy (differentiable)."""
    w = lin.weight
    return torch.empty((w.shape[1], w.shape[0]), dtype=dtype,
                       device=w.device).copy_(w.t())


def tp_dropout_rng(rng: DropoutRng | None, rate: float,
                   training: bool) -> DropoutRng | None:
    """The stream of a dropout site whose activation a tensor-parallel
    block splits by column: the block's stream with the rank's model index
    folded in (the same draw from ``rng`` on every rank keeps the ranks'
    streams of the whole-tensor sites equal)."""
    if not training or rate == 0.0 or rng is None:
        return rng
    return DropoutRng(tp_block.fold_in(rng.block_seed(),
                                       axis(MODEL_AXIS).index))


def row_parallel(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """The row-parallel product of a tensor-parallel block: this rank's
    partial ``x @ wᵀ`` summed over the model axis in f32
    (``collectives.reduce_from``), then the bias, in ``dtype``."""
    part = F.linear(x.to(dtype), w.to(dtype)).float()
    return (reduce_from(part, MODEL_AXIS) + bias.float()).to(dtype)


def sinusoidal_positional_encoding(max_len: int, d_model: int,
                                   base: float = 1000.0) -> torch.Tensor:
    """``(max_len, d_model)`` f32 table: sin in the even columns, cos in
    the odd ones.  The default ``base=1000.0`` (not the usual 10000.0) is
    the reference's, kept for logit parity."""
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                         * (-math.log(base) / d_model))
    angles = position * div_term
    pe = torch.zeros(max_len, d_model, dtype=torch.float32)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles[:, : d_model // 2])
    return pe


class PositionalEncoding(nn.Module):
    """Add sinusoidal PE along the sequence axis, then dropout.  Input
    (B, S, D); the table is a constant (a non-persistent buffer), not a
    parameter, and is absent from the ``state_dict``."""

    def __init__(self, d_model: int, dropout: float = 0.1, max_len: int = 4,
                 base: float = 1000.0):
        super().__init__()
        self.dropout = dropout
        self.register_buffer(
            "pe", sinusoidal_positional_encoding(max_len, d_model, base),
            persistent=False)

    def forward(self, x: torch.Tensor,
                rng: DropoutRng | None = None) -> torch.Tensor:
        x = x + self.pe[: x.shape[1]].to(x.dtype)[None]
        return dropout(x, self.dropout, self.training, rng)


class GeluMlp(nn.Module):
    """Stack of Linear layers ``fc0``, ``fc1``, ... with exact-erf GELU
    between them (the reference's MLP heads, e.g. 896→512→128→19)."""

    def __init__(self, in_features: int, features: tuple[int, ...],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.n = len(features)
        for i, (k, f) in enumerate(zip((in_features,) + tuple(features),
                                       features)):
            setattr(self, f"fc{i}", nn.Linear(k, f))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = dense(getattr(self, f"fc{i}"), x, self.dtype)
            if i < self.n - 1:
                x = F.gelu(x)
        return x


class FeedForward(nn.Module):
    """Linear→GELU (exact erf)→Dropout→Linear→Dropout."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)
        self.dropout = dropout

    def forward(self, x: torch.Tensor,
                rng: DropoutRng | None = None) -> torch.Tensor:
        x = F.gelu(dense(self.fc1, x, self.dtype))
        x = dropout(x, self.dropout, self.training, rng)
        return dropout(dense(self.fc2, x, self.dtype), self.dropout,
                       self.training, rng)


class ViTAttention(nn.Module):
    """Multi-head attention, ViT flavour: one bias-free qkv projection, an
    output projection unless ``heads == 1 and dim_head == dim``."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0, attention_impl: str = "auto",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.attention_impl = attention_impl
        self.dtype = dtype
        self.project_out = not (heads == 1 and dim_head == dim)
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        if self.project_out:
            self.to_out = nn.Linear(inner, dim)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, kv_len: int | None = None,
                rng: DropoutRng | None = None) -> torch.Tensor:
        qkv = dense(self.to_qkv, x, self.dtype)
        out = packed_mha(qkv, heads=self.heads, scale=self.dim_head ** -0.5,
                         impl=self.attention_impl, kv_len=kv_len)
        if self.project_out:
            out = dropout(dense(self.to_out, out, self.dtype), self.dropout,
                          self.training, rng)
        return out


class ViTBlock(nn.Module):
    """One pre-norm layer: x += attn(norm(x)); x += ff(norm(x)).

    Where eligible the whole block is one call of ``fused_vit_block``
    (the CUDA kernel on the card, its plain version on the CPU), which
    uses tanh GELU like the JAX fused kernel; otherwise the unfused
    modules run, with exact-erf GELU.  The parameters are the same on
    both paths.  The fused call is differentiable: ``block_params``'
    transposes and casts carry the kernel's gradients back to the f32
    ``nn.Linear``/``nn.LayerNorm`` parameters by ordinary autograd.
    Training dropout runs inside the kernel, from a seed drawn from
    ``rng``.

    In eval mode inside ``ops.attention.quant_scope`` the block runs its
    big products in int8 (``ops/quant.py``) from the same parameters:
    ``quant_fused_vit_block`` where the shape is eligible, the unfused
    ``quant_vit_block`` when the block is pinned to
    ``attention_impl="xla"``.  The quantized parameter tree goes through
    the site registry, so a quantized ``Predictor`` builds it once.

    Inside ``ops.attention.tp_pallas_scope`` (a tensor-parallel step) a
    block whose heads and FFN hidden divide over the model axis runs as
    one rank's slice of the Megatron layout, on the rank's parts of its
    weights and of ``fc1``'s bias, which the step hands it
    (``parallel.sharding.tp_parts``):
    where ``tp_eligible``, ``parallel/tp_block.py``'s block (kernel 3 on
    the rank's heads, tanh GELU, the fused block's math); otherwise the
    unfused modules' math on column- and row-parallel products."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int,
                 dropout: float = 0.0, attention_impl: str = "auto",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.heads, self.dim_head = dim, heads, dim_head
        self.dropout = dropout
        self.attention_impl = attention_impl
        self.dtype = dtype
        self.attn_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = ViTAttention(dim, heads, dim_head, dropout,
                                 attention_impl, dtype)
        self.ff_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff = FeedForward(dim, mlp_dim, dropout, dtype)

    def fused_eligible(self, x: torch.Tensor) -> bool:
        """``devt_tpu/models/layers.py:ViTBlock._fused_eligible`` without
        its TPU and mesh gates, and on the card what kernels 1 and 2 take
        (``ops/fused_block.py:fused_block_eligible``): the widths they are
        compiled for, and kernel 2's shape rule when the forward will need
        a gradient.  Any other block runs unfused (kernels 3 and 4 up to
        512 tokens), as JAX's does wherever its fused path is not
        eligible."""
        if self.attention_impl == "xla":
            return False
        if self.heads * self.dim_head != self.dim:
            return False
        if self.heads == 1 and self.dim_head == self.dim:
            return False      # the fused path always applies to_out
        s = x.shape[1]
        if not fits_single_block(s) or s % 16:
            return False
        return fused_block_eligible(
            x.device.type, self.dtype, self.dim, self.dim_head, s,
            self.training and torch.is_grad_enabled(),
            self.ff.fc1.out_features)

    def tp_splits(self, n: int) -> bool:
        """Whether the block runs on its own slices over a model axis of
        ``n`` ranks: its heads and FFN hidden divide, and it has an
        out-projection."""
        return (n > 1 and self.attn.project_out and self.heads % n == 0
                and self.ff.fc1.out_features % n == 0)

    def tp_eligible(self, x: torch.Tensor, n: int) -> bool:
        """``devt_tpu/models/layers.py:ViTBlock._tp_eligible``: the
        Megatron block of ``parallel/tp_block.py`` over a model axis of
        ``n`` ranks."""
        if self.attention_impl == "xla":
            return False
        if self.heads * self.dim_head != self.dim:
            return False
        if self.heads == 1 and self.dim_head == self.dim:
            return False
        if n <= 1 or self.heads % n or self.ff.fc1.out_features % n:
            return False
        return fits_single_block(x.shape[1])

    def block_params(self) -> dict[str, torch.Tensor]:
        """The kernel's parameter dict: matrices (K, N) in the compute
        dtype, LN parameters and biases (1, N) f32."""
        def row(t):
            return t.float().reshape(1, -1)

        def mat(lin):
            return kernel_matrix(lin, self.dtype)

        return {
            "g1": row(self.attn_norm.weight), "b1": row(self.attn_norm.bias),
            "wqkv": mat(self.attn.to_qkv), "wo": mat(self.attn.to_out),
            "bo": row(self.attn.to_out.bias),
            "g2": row(self.ff_norm.weight), "b2": row(self.ff_norm.bias),
            "w1": mat(self.ff.fc1), "bb1": row(self.ff.fc1.bias),
            "w2": mat(self.ff.fc2), "bb2": row(self.ff.fc2.bias),
        }

    def forward(self, x: torch.Tensor, kv_len: int | None = None,
                rng: DropoutRng | None = None) -> torch.Tensor:
        if not self.training and quant_active() \
                and not (self.heads == 1 and self.dim_head == self.dim):
            qp = site_value(
                lambda: quant_block_params(self.block_params()), dict)
            # a block pinned to "xla" stays off the fused kernel here too
            impl = ("auto" if self.attention_impl == "fused_interpret"
                    else self.attention_impl)
            return quant_vit_block(
                x.to(self.dtype).contiguous(), qp, self.heads,
                self.dim_head ** -0.5,
                kv_len if kv_len is not None else x.shape[1], impl=impl)
        tpm = active_tp_mesh()
        if tpm is not None and self.tp_splits(tpm.shape[MODEL_AXIS]):
            return self._tp_forward(x, kv_len, rng, tpm.shape[MODEL_AXIS])
        if self.fused_eligible(x):
            rate = self.dropout if self.training else 0.0
            if rate > 0.0 and rng is None:
                raise ValueError("a training forward with dropout needs "
                                 "rng=, a DropoutRng (models/layers.py)")
            y, _, _ = fused_vit_block(
                x.to(self.dtype).contiguous(), self.block_params(),
                self.heads, self.dim_head ** -0.5,
                kv_len if kv_len is not None else x.shape[1],
                dropout_rate=rate,
                seed=rng.block_seed() if rate > 0.0 else None)
            return y
        h = layer_norm(self.attn_norm, x, self.dtype)
        x = x + self.attn(h, kv_len, rng)
        h = layer_norm(self.ff_norm, x, self.dtype)
        return x + self.ff(h, rng)

    def _tp_forward(self, x: torch.Tensor, kv_len: int | None,
                    rng: DropoutRng | None, n: int) -> torch.Tensor:
        """One rank's slice of the block over a model axis of ``n``."""
        attn, ff, dtype = self.attn, self.ff, self.dtype
        inner, mlp = self.heads * self.dim_head, ff.fc1.out_features
        wqkv, wo = attn.to_qkv.weight, attn.to_out.weight
        w1, b1, w2 = ff.fc1.weight, ff.fc1.bias, ff.fc2.weight
        if wqkv.shape[0] * n != 3 * inner or b1.shape[0] * n != mlp:
            raise ValueError(
                f"a tensor-parallel block over {n} ranks takes its parts "
                f"(the step hands them: parallel.sharding.tp_parts); got "
                f"qkv rows {wqkv.shape[0]} of {3 * inner}, FFN bias "
                f"{b1.shape[0]} of {mlp}")
        kv = kv_len if kv_len is not None else x.shape[1]
        rate = self.dropout if self.training else 0.0
        if rate > 0.0 and rng is None:
            raise ValueError("a training forward with dropout needs rng=, "
                             "a DropoutRng (models/layers.py)")
        if self.tp_eligible(x, n):
            def row(t):
                return t.float().reshape(1, -1)

            rep = {"g1": row(self.attn_norm.weight),
                   "b1": row(self.attn_norm.bias),
                   "bo": row(attn.to_out.bias),
                   "g2": row(self.ff_norm.weight),
                   "b2": row(self.ff_norm.bias), "bb2": row(ff.fc2.bias)}
            w = {"wqkv": wqkv.t().to(dtype), "wo": wo.t().to(dtype),
                 "w1": w1.t().to(dtype), "bb1": row(b1),
                 "w2": w2.t().to(dtype)}
            return tp_block.tp_block_local(
                x.to(dtype), rep, w, heads_local=self.heads // n,
                scale=self.dim_head ** -0.5, kv_len=kv, axis_name=MODEL_AXIS,
                rate=rate, seed=rng.block_seed() if rate > 0.0 else 0)
        # the unfused modules' math on column- and row-parallel products
        h = copy_to(layer_norm(self.attn_norm, x, dtype), MODEL_AXIS)
        qkv = F.linear(h.to(dtype), wqkv.to(dtype))
        out = packed_mha(qkv, heads=self.heads // n,
                         scale=self.dim_head ** -0.5,
                         impl=self.attention_impl, kv_len=kv_len)
        o = row_parallel(out, wo, attn.to_out.bias, dtype)
        x = x + dropout(o, rate, self.training, rng)
        h = copy_to(layer_norm(self.ff_norm, x, dtype), MODEL_AXIS)
        h = F.gelu(F.linear(h.to(dtype), w1.to(dtype), b1.to(dtype)))
        h = dropout(h, rate, self.training,
                    tp_dropout_rng(rng, rate, self.training))
        h = row_parallel(h, w2, ff.fc2.bias, dtype)
        return x + dropout(h, rate, self.training, rng)


class MoEViTBlock(nn.Module):
    """Pre-norm layer whose FFN is a top-1-routed switch MoE
    (``parallel/moe.py``): x += attn(norm(x)); x += moe(norm(x)).

    Where eligible the attention half is one call of ``fused_attn_half``
    (kernels 7 and 8 on the card, their plain versions on the CPU);
    otherwise LayerNorm, ``ViTAttention`` (dropout on ``to_out``) and the
    residual run unfused.  Both branches use the same parameters.  Each
    sequence row is routed on its own (``group_size=S``), the pad tokens
    past ``kv_len`` excluded; training uses ``capacity_factor``,
    evaluation ``max(capacity_factor, eval_capacity_factor)``.  The
    router's load-balance loss (the mean over the rows) is appended to
    ``losses`` when the caller passes a list: the counterpart of flax's
    ``"losses"`` collection, which ``train/steps.py`` weighs into the
    objective.  The expert parameters ``moe_router`` (D, E), ``moe_w1``
    (E, D, F), ``moe_b1`` (E, F), ``moe_w2`` (E, F, D), ``moe_b2`` (E, D)
    sit on the block with the names and layout of the flax tree.  There
    is no int8 branch, as in the JAX block.

    Inside ``parallel.moe.moe_ep_scope`` (``config.moe_ep`` on a
    data-parallel mesh) the FFN runs expert-parallel over the scope's axis
    (``moe_ffn_ep_rows``) when the experts divide over its ranks, and
    densely, every expert on every rank, when they do not."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int,
                 n_experts: int, capacity_factor: float = 1.25,
                 eval_capacity_factor: float = 2.0, dropout: float = 0.0,
                 attention_impl: str = "auto",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.heads, self.dim_head = dim, heads, dim_head
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.dropout = dropout
        self.attention_impl = attention_impl
        self.dtype = dtype
        self.attn_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = ViTAttention(dim, heads, dim_head, dropout,
                                 attention_impl, dtype)
        self.ff_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.moe_router = nn.Parameter(torch.empty(dim, n_experts))
        self.moe_w1 = nn.Parameter(torch.empty(n_experts, dim, mlp_dim))
        self.moe_b1 = nn.Parameter(torch.zeros(n_experts, mlp_dim))
        self.moe_w2 = nn.Parameter(torch.empty(n_experts, mlp_dim, dim))
        self.moe_b2 = nn.Parameter(torch.zeros(n_experts, dim))

    def fused_half_eligible(self, x: torch.Tensor) -> bool:
        """``devt_tpu/models/layers.py:MoEViTBlock._fused_half_eligible``
        without its TPU gate: the fused attention half has no dropout, so
        training with dropout keeps the unfused path.  On the card also
        what kernels 7 and 8 take (their widths, and kernel 8's shape rule
        when the forward will need a gradient)."""
        if self.attention_impl == "xla":
            return False
        if self.dropout > 0.0 and self.training:
            return False
        if self.heads * self.dim_head != self.dim:
            return False
        if self.heads == 1 and self.dim_head == self.dim:
            return False      # the fused path always applies to_out
        s = x.shape[1]
        if not fits_single_block(s) or s % 16:
            return False
        return fused_block_eligible(
            x.device.type, self.dtype, self.dim, self.dim_head, s,
            self.training and torch.is_grad_enabled())

    def half_params(self) -> dict[str, torch.Tensor]:
        """The attention half's parameter dict: matrices (K, N) in the
        compute dtype, LN parameters and bias (1, N) f32."""
        return {"g1": self.attn_norm.weight.float().reshape(1, -1),
                "b1": self.attn_norm.bias.float().reshape(1, -1),
                "wqkv": kernel_matrix(self.attn.to_qkv, self.dtype),
                "wo": kernel_matrix(self.attn.to_out, self.dtype),
                "bo": self.attn.to_out.bias.float().reshape(1, -1)}

    def forward(self, x: torch.Tensor, kv_len: int | None = None,
                rng: DropoutRng | None = None,
                losses: list | None = None) -> torch.Tensor:
        s = x.shape[1]
        if self.fused_half_eligible(x):
            x, _ = fused_attn_half(
                x.to(self.dtype).contiguous(), self.half_params(),
                self.heads, self.dim_head ** -0.5,
                kv_len if kv_len is not None else s)
        else:
            h = layer_norm(self.attn_norm, x, self.dtype)
            x = x + self.attn(h, kv_len, rng)
        h = layer_norm(self.ff_norm, x, self.dtype)
        # the tile-alignment pads (models/vivit.py:_pad_tokens) take no
        # expert capacity and no part in the load-balance statistics
        valid = None
        if kv_len is not None and kv_len != s:
            valid = (torch.arange(s, device=x.device) < kv_len).expand(
                x.shape[0], s).reshape(-1)
        cf = (self.capacity_factor if self.training
              else max(self.capacity_factor, self.eval_capacity_factor))
        params = {"router": self.moe_router, "w1": self.moe_w1,
                  "b1": self.moe_b1, "w2": self.moe_w2, "b2": self.moe_b2}
        ep = moe.active_moe_ep()
        if ep is not None and ep[1] > 1 \
                and self.moe_router.shape[1] % ep[1] == 0:
            # expert-parallel training (config.moe_ep): the same routing
            # row by row, each rank running its E/n experts on the slots
            # of every rank (two all_to_alls over the data axis)
            y, aux = moe.moe_ffn_ep_rows(
                params, h, axis_name=ep[0], n_shards=ep[1],
                capacity_factor=cf,
                valid=None if valid is None else valid.reshape(h.shape[:2]))
        else:
            y, aux = moe_ffn_dense(params, h.reshape(-1, self.dim),
                                   capacity_factor=cf, valid=valid,
                                   group_size=s)
        if losses is not None:
            losses.append(aux)
        y = dropout(y.reshape(h.shape), self.dropout, self.training, rng)
        return x + y


class ViTTransformer(nn.Module):
    """Pre-norm residual transformer with a trailing LayerNorm: ``depth``
    ViTBlocks, with every ``moe_every``-th an MoEViTBlock when
    ``moe_experts > 0`` (depth 4, moe_every 2: dense, MoE, dense, MoE).
    ``remat=True`` rematerialises each block in a training forward that
    needs a gradient (``remat``: the JAX module's ``nn.remat`` per block),
    with the same loss and gradients as without.

    ``pipeline_stages > 1`` or ``sequence_parallel``: the block stack's
    parameters are the JAX module's stacked layout, one ``(depth, ...)``
    leaf per entry of the fused block's dict, ``pb_g1 … pb_bb2`` (LN rows
    and biases ``(depth, 1, N)``, matrices ``(depth, K, N)``; a different
    tree from the per-block one, the same for pp and sp).  The matrices
    are cast to the model dtype at use, the rows stay f32 (JAX's
    ``_stacked_cast``).  Each block is the fused block's math
    (``_block_math``: kernels 1 and 2 where they take the block,
    ``reference_vit_block`` otherwise or under ``attention_impl="xla"``).
    Outside a pipe or seq mesh the stack runs sequentially; inside
    ``parallel.pipeline.pipeline_scope`` it runs the GPipe schedule over
    the ``pipe`` axis (``pipeline_microbatches``, default one a stage),
    each stage's blocks as ``parallel/tp_block.py``'s block over a
    ``model`` axis when the mesh has one; inside
    ``parallel.ring_attention.sp_scope`` every block runs on the rank's
    chunk of the tokens with the attention over the ``seq`` axis' kv ring.
    Both need dropout 0 and no MoE blocks, as in JAX."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, dropout: float = 0.0,
                 attention_impl: str = "auto", remat: bool = False,
                 moe_experts: int = 0, moe_every: int = 2,
                 moe_capacity_factor: float = 1.25,
                 pipeline_stages: int = 0, pipeline_microbatches: int = 0,
                 sequence_parallel: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.depth, self.heads = dim, depth, heads
        self.dim_head, self.mlp_dim = dim_head, mlp_dim
        self.attention_impl = attention_impl
        self.dtype = dtype
        self.remat = remat
        self.pipeline_stages = pipeline_stages
        self.pipeline_microbatches = pipeline_microbatches
        self.sequence_parallel = sequence_parallel
        self.stacked = pipeline_stages > 1 or sequence_parallel
        if self.stacked:
            if pipeline_stages > 1 and depth % pipeline_stages:
                raise ValueError(f"depth {depth} does not split into "
                                 f"{pipeline_stages} pipeline stages")
            if moe_experts > 0 or dropout != 0.0:
                raise ValueError("pp and sp compose with dense dropout-free "
                                 "stacks (config.py)")
            for k, shape in self._stacked_shapes().items():
                setattr(self, f"pb_{k}",
                        nn.Parameter(torch.empty((depth,) + shape)))
            self.init_stacked(None)
        else:
            def block(i):
                if moe_experts > 0 and i % moe_every == moe_every - 1:
                    return MoEViTBlock(dim, heads, dim_head, mlp_dim,
                                       n_experts=moe_experts,
                                       capacity_factor=moe_capacity_factor,
                                       dropout=dropout,
                                       attention_impl=attention_impl,
                                       dtype=dtype)
                return ViTBlock(dim, heads, dim_head, mlp_dim, dropout,
                                attention_impl, dtype)

            self.blocks = nn.ModuleList(block(i) for i in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def _stacked_shapes(self) -> dict[str, tuple[int, ...]]:
        d, m, inner = self.dim, self.mlp_dim, self.heads * self.dim_head
        return {"g1": (1, d), "b1": (1, d), "wqkv": (d, 3 * inner),
                "wo": (inner, d), "bo": (1, d), "g2": (1, d), "b2": (1, d),
                "w1": (d, m), "bb1": (1, m), "w2": (m, d), "bb2": (1, d)}

    def init_stacked(self, generator: torch.Generator | None) -> None:
        """JAX's ``_stacked_block_params`` initializers: LN scales 1,
        offsets and biases 0, matrices lecun-normal over their fan-in."""
        with torch.no_grad():
            for k, shape in self._stacked_shapes().items():
                p = getattr(self, f"pb_{k}")
                if k in ("g1", "g2"):
                    nn.init.ones_(p)
                elif shape[0] == 1:
                    nn.init.zeros_(p)
                else:
                    lecun_normal_(p, shape[0], generator)

    def stacked_params(self) -> dict[str, torch.Tensor]:
        """The ``pb_*`` leaves by the fused block's names, the matrices in
        the model dtype (JAX's ``_stacked_cast``)."""
        out = {}
        for k in self._stacked_shapes():
            v = getattr(self, f"pb_{k}")
            out[k] = v.to(self.dtype) if v.shape[-2] > 1 else v
        return out

    def _block_math(self, kv_len: int):
        """``(params, x) -> y`` for one block of the stacked layout: the
        fused block (kernels 1 and 2 on the card, their plain versions on
        the CPU) where it takes the block, ``reference_vit_block``
        otherwise (JAX: the fused kernel where eligible, the reference
        math elsewhere)."""
        heads, scale = self.heads, self.dim_head ** -0.5
        use_fused = self.attention_impl != "xla" \
            and heads * self.dim_head == self.dim

        def block(p, x):
            s = x.shape[1]
            if use_fused and s % 16 == 0 and fits_single_block(s) \
                    and fused_block_eligible(
                        x.device.type, self.dtype, self.dim, self.dim_head,
                        s, self.training and torch.is_grad_enabled(),
                        self.mlp_dim):
                return fused_vit_block(x.to(self.dtype).contiguous(), p,
                                       heads, scale, kv_len)[0]
            return reference_vit_block(x, p, heads, scale, kv_len)

        return block

    def _sequential(self, stacked: dict, x: torch.Tensor,
                    kv_len: int) -> torch.Tensor:
        block = self._block_math(kv_len)
        for i in range(self.depth):
            x = block({k: v[i] for k, v in stacked.items()}, x)
        return x

    def _sp_stack(self, x: torch.Tensor, kv_len: int) -> torch.Tensor:
        """The sequence-parallel stack: inside ``sp_scope`` each rank runs
        every block on its chunk of the tokens (``collectives.axis_chunk``,
        whose backward scatters into zeros) as the ring block, the kv
        chunks rotating over the ``seq`` axis (kernels 14 and 15 on the
        card), then the chunks are gathered along the tokens
        (``collectives.all_gather``, whose backward sums the ranks'
        cotangents: the n-fold factor that makes the step's uniform mean
        over ``seq`` exact, as JAX's tiled ``all_gather`` transposes to a
        ``psum_scatter``).  Without a seq axis: sequential."""
        stacked = self.stacked_params()
        mesh = active_sp_mesh()
        n = mesh.shape.get(SEQ_AXIS, 1) if mesh is not None else 1
        if n <= 1:
            return self._sequential(stacked, x, kv_len)
        if self.heads * self.dim_head != self.dim:
            raise ValueError(
                f"sequence-parallel blocks need heads*dim_head == dim; "
                f"got dim={self.dim} heads={self.heads} "
                f"dim_head={self.dim_head}")
        s = x.shape[1]
        if s % n:
            raise ValueError(
                f"sp needs the (padded) token count divisible by the seq "
                f"axis; got {s} tokens over sp={n}")
        group, _ = sp_group(mesh)
        impl = "pallas" if self.attention_impl == "fused_interpret" \
            else "auto"
        xs = collectives.axis_chunk(x, SEQ_AXIS, 1)
        for j in range(self.depth):
            xs = _ring_block_local(
                xs, {k: v[j] for k, v in stacked.items()}, heads=self.heads,
                scale=self.dim_head ** -0.5, kv_len=kv_len, group=group,
                impl=impl)
        return collectives.all_gather(xs, SEQ_AXIS, 1)

    def _pipelined_stack(self, x: torch.Tensor, kv_len: int) -> torch.Tensor:
        """The pipeline stack: inside ``pipeline_scope`` the stacked
        leaves, regrouped ``(stages, depth / stages, ...)``, go through
        ``parallel/pipeline.py:pipelined_stack``, which runs this rank's
        stage (its ``depth / stages`` blocks) in the GPipe schedule over
        ``pipe``; on a 3-D mesh the stage is ``_tp_stage_fn``.  Without a
        pipe axis: sequential."""
        stacked = self.stacked_params()
        mesh = active_pipe_mesh()
        if mesh is None or mesh.shape.get(PIPE_AXIS, 1) <= 1:
            return self._sequential(stacked, x, kv_len)
        n_stages = self.pipeline_stages
        if mesh.shape[PIPE_AXIS] != n_stages:
            raise ValueError(f"a stack of {n_stages} pipeline stages on a "
                             f"pipe axis of {mesh.shape[PIPE_AXIS]}")
        per = self.depth // n_stages
        block = self._block_math(kv_len)

        def stage_fn(p_stage, xs):
            for j in range(per):
                xs = block({k: v[j] for k, v in p_stage.items()}, xs)
            return xs

        tp = mesh.shape.get(MODEL_AXIS, 1)
        if tp > 1:
            # 3-D dp×pp×tp: each stage's blocks as the Megatron block over
            # the model axis, on slices cut here from the replicated stage
            # parameters (the step sums their gradients over the axis)
            stage_fn = self._tp_stage_fn(kv_len, tp, per)
        by_stage = {k: v.reshape((n_stages, per) + tuple(v.shape[1:]))
                    for k, v in stacked.items()}
        return pipelined_stack(mesh, stage_fn, by_stage, x,
                               self.pipeline_microbatches or n_stages)

    def _tp_stage_fn(self, kv_len: int, tp: int, per: int):
        """A pp×tp stage: ``per`` tensor-parallel blocks over the model
        axis (``parallel/tp_block.py:tp_block_local``, kernel 3 on the
        rank's heads and kernel 4 in the backward).  The stage parameters
        arrive whole on every rank of the axis; each rank cuts its head
        and FFN columns (``collectives.axis_chunk``, JAX's local dynamic
        index), so their gradients are zero outside the rank's slice and
        the step sums them over ``model``."""
        heads, scale = self.heads, self.dim_head ** -0.5
        if (self.heads * self.dim_head != self.dim or self.heads % tp
                or self.mlp_dim % tp):
            raise ValueError(
                f"pp x tp needs heads*dim_head == dim, heads % mp == 0 "
                f"and mlp_dim % mp == 0; got dim={self.dim} "
                f"heads={self.heads} dim_head={self.dim_head} "
                f"mlp_dim={self.mlp_dim} mp={tp}")
        if self.attention_impl == "xla":
            raise ValueError("pp x tp runs the fused packed-qkv attention "
                             "per rank: attention_impl='xla' cannot")

        def stage_fn(p_stage, xs):
            if xs.shape[1] % 16 or not fits_single_block(xs.shape[1]):
                raise ValueError(
                    f"pp x tp stage needs a fused-eligible token count "
                    f"(16-aligned); got {xs.shape[1]}")
            for j in range(per):
                p = {k: v[j] for k, v in p_stage.items()}
                rep = {k: p[k] for k in tp_block.REP_KEYS}
                w = {k: collectives.axis_chunk(p[k], MODEL_AXIS, dim, groups)
                     for k, (dim, groups) in tp_block.SPLITS.items()}
                xs = tp_block.tp_block_local(
                    xs.to(self.dtype), rep, w, heads_local=heads // tp,
                    scale=scale, kv_len=kv_len, axis_name=MODEL_AXIS)
            return xs

        return stage_fn

    def forward(self, x: torch.Tensor, kv_len: int | None = None,
                rng: DropoutRng | None = None,
                losses: list | None = None) -> torch.Tensor:
        """``losses``: a list that each MoE block appends its load-balance
        loss to (None: not collected)."""
        if self.stacked:
            kv = kv_len if kv_len is not None else x.shape[1]
            y = (self._pipelined_stack(x, kv) if self.pipeline_stages > 1
                 else self._sp_stack(x, kv))
            return layer_norm(self.norm, y, self.dtype)
        rematerialise = self.remat and self.training \
            and torch.is_grad_enabled()
        for block in self.blocks:
            moe_block = isinstance(block, MoEViTBlock)

            def args(h, r, first=True, moe_block=moe_block):
                if moe_block:
                    return h, kv_len, r, losses if first else None
                return h, kv_len, r

            x = (remat(block, args, x, rng) if rematerialise
                 else block(*args(x, rng)))
        return layer_norm(self.norm, x, self.dtype)
