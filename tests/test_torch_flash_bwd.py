"""The port's blockwise attention backward (kernels 12 and 13), and the
single-block backward (kernel 10) that runs on their bodies on the card,
against the JAX package's, on the CPU.

``flash_blocked_bwd_plain``, which CPU tensors run and the card holds the
CUDA kernels to, against JAX's ``_bwd`` (``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` in interpret mode) on the padded inputs JAX's wrapper
builds, from the same numpy arrays; then ``flash_attention`` under autograd
against ``jax.grad`` of JAX's through its interpreted kernels, and one
training step of a tiny ViViT whose 577 space tokens exceed one kv block,
both packages on the blockwise kernels' route.  Kernel 10's plain version
(``flash_single_bwd_plain``) against the blockwise one and both against
JAX's interpreted ``_bwd_single`` at Sq == Skv <= 512: kernel 10 computes
what kernels 12 and 13 compute at that shape, which is why the card runs
it on their wgmma bodies.

Tolerances.  f32: 2e-5, sums in other orders (JAX pads the queries to 128
and sums each block's product in its own order).  bf16: one bf16 ulp
(2^-8) of each tensor's largest element, the bound
``tests/test_torch_flash.py`` holds kernel 10's plain version to, where a
sum in another order moves a rounded ds or p across a rounding boundary.
The op and model gradients: ``tests/test_attention.py:61``'s (5e-5 /
5e-4) and the ViViT step's (``tests/test_torch_train_step.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu.config import Config as JConfig
from devt_tpu.models import vivit as jv
from devt_tpu.ops import attention as jatt
from devt_tpu.train import steps as jsteps
from devt_tpu_torch.config import Config as TConfig
from devt_tpu_torch.models import vivit as tv
from devt_tpu_torch.models.layers import DropoutRng
from devt_tpu_torch.ops import flash_attention as tfa
from devt_tpu_torch.train import steps as tsteps
from devt_tpu_torch.utils.jax_bridge import jax_to_state_dict

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

# ``devt_tpu.ops.flash_attention`` the attribute is a function of that name
jfa = importlib.import_module("devt_tpu.ops.flash_attention")

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)
# the tiny ViViT's loss and gradients (tests/test_torch_train_step.py)
FWD_TOL = dict(atol=2e-5, rtol=2e-4)
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pad(x, s_p):
    return np.pad(x, ((0, 0), (0, s_p - x.shape[1]), (0, 0)))


def _close(kind, got, want):
    """f32 at TOL; bf16 within one bf16 ulp of the largest element of
    ``want``."""
    got = got.float().numpy()
    want = np.asarray(want, dtype=np.float32)
    if kind == "f32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(want).max()


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("bh,sq,skv,d,kv_len", [(2, 600, 600, 64, 577),
                                                (3, 40, 300, 16, 290)])
def test_blocked_bwd_plain_matches_jax_kernels(kind, bh, sq, skv, d,
                                               kv_len):
    """Kernels 12 and 13's plain version on the forward's (o, lse): ViViT's
    577 tokens in (2, 600 → 640, 64), and Sq != Skv in (3, 40 → 128,
    300 → 384, 16).  JAX's zero query rows (zero do) add nothing; keys
    past kv_len get exact zeros in both."""
    q, k, v = (_rand((bh, s, d), i) for i, s in enumerate((sq, skv, skv)))
    do = _rand((bh, sq, d), 7)
    tq, tk, tv_, tdo = (torch.tensor(t)[None].to(TORCH[kind])
                        for t in (q, k, v, do))
    o, lse = tfa.flash_blocked_fwd_plain(tq, tk, tv_, d ** -0.5, kv_len)
    sq_p, skv_p = -(-sq // 128) * 128, -(-skv // 128) * 128
    jl = np.pad(lse.numpy(), ((0, 0), (0, sq_p - sq)))[..., None].repeat(
        128, axis=-1)
    bwd = jax.jit(lambda *a: jfa._bwd(
        *a, scale=d ** -0.5, kv_len=kv_len, block_q=128, block_kv=128,
        interpret=True))
    want = bwd(jnp.asarray(_pad(q, sq_p), JNP[kind]),
               *(jnp.asarray(_pad(t, skv_p), JNP[kind]) for t in (k, v)),
               jnp.asarray(_pad(o[0].float().numpy(), sq_p), JNP[kind]),
               jnp.asarray(jl), jnp.asarray(_pad(do, sq_p), JNP[kind]))
    got = tfa.flash_blocked_bwd_plain(tq, tk, tv_, o, lse, tdo, d ** -0.5,
                                      kv_len)
    for g, w, s in zip(got, want, (sq, skv, skv)):
        assert g.dtype == TORCH[kind] and g.shape == (1, bh, s, d)
        _close(kind, g[0], np.asarray(w, np.float32)[:, :s])
    for g in got[1:]:
        assert not g[:, :, kv_len:].any()


@pytest.mark.parametrize("b,h,sq,skv,d,kv_len", [(1, 2, 600, 600, 16, 577),
                                                 (2, 1, 40, 300, 16, 290)])
def test_op_gradients_match_jax_grad(b, h, sq, skv, d, kv_len):
    """``flash_attention`` above one kv block under autograd (kernels 11,
    12, 13's plain versions) against ``jax.grad`` of JAX's through its
    interpreted ``_flash_padded``."""
    q = _rand((b, h, sq, d), 0)
    k, v = _rand((b, h, skv, d), 1), _rand((b, h, skv, d), 2)
    w = _rand((b, h, sq, d), 3)

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, kv_len=kv_len,
                                           interpret=True) * w)

    jl, want = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    leaves = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    loss = (tfa.flash_attention(*leaves, kv_len=kv_len)
            * torch.tensor(w)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for leaf, g in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   **GRAD_TOL)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, True),          # ViViT at image 384's backward
    (torch.bfloat16, 16, True), (torch.bfloat16, 32, True),
    (torch.bfloat16, 128, False), (torch.bfloat16, 256, False),
    (torch.bfloat16, 48, False), (torch.bfloat16, 8, False),
    (torch.float32, 64, False), (torch.float32, 16, False)])
def test_blocked_bwd_route_predicate(dtype, d, want):
    """Kernels 12 and 13: bfloat16 at head dim 16, 32 or 64 takes the wgmma
    bodies whatever Sq, Skv and kv_len; float32 and head dims 128 and 256
    the streamed body (the card tests hold the C entry's rule to this
    predicate)."""
    assert tfa.blocked_bwd_on_wgmma(dtype, d) is want


def test_cpu_backward_counts_no_launch():
    """CPU tensors run the plain backward: the blockwise op under autograd,
    in bfloat16 at head dim 16 (inside the rule) and in float32 (outside
    it), counts no launch of kernel 12 or 13 on either body."""
    fa = tfa.flash_attention

    def counts():
        return (fa.blocked_dq_launches, fa.blocked_dq_wgmma_launches,
                fa.blocked_dq_streamed_launches, fa.blocked_dkv_launches,
                fa.blocked_dkv_wgmma_launches,
                fa.blocked_dkv_streamed_launches)

    before = counts()
    for dtype in (torch.bfloat16, torch.float32):
        leaves = [torch.tensor(_rand((1, 2, s, 16), i)).to(dtype)
                  .requires_grad_(True) for i, s in enumerate((5, 20, 20))]
        o = fa(*leaves, kv_len=17)              # Sq != Skv: blockwise
        o.float().sum().backward()
        assert all(leaf.grad is not None for leaf in leaves)
    assert counts() == before


# kernel 10's shapes, Sq == Skv == S with kv_len: one query, and lengths
# around the 64-row tiles of the wgmma bodies and the 128-row blocks of the
# plain blockwise version, up to the single-block limit of 512
SINGLE_BWD_SHAPES = [(1, 1), (63, 50), (197, 197), (256, 200), (333, 333),
                     (512, 500)]


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("s,kv_len", SINGLE_BWD_SHAPES)
def test_single_bwd_plain_is_the_blocked_backward_at_one_block(kind, s,
                                                               kv_len, d):
    """Kernel 10's plain version against kernels 12 and 13's at Sq == Skv,
    and both against JAX's interpreted ``_bwd_single`` (padded to its
    16-row tile, lse broadcast over its 128 lanes), on the forward's (o,
    lse): dq, dk, dv at TOL in f32, within one bf16 ulp of the largest
    element in bf16.  At kv_len = 1 (here S = 1) p = 1 and dp = delta, so
    dq and dk are zero in exact arithmetic: each side returns the rounding
    of two f32 sums of d products in its own order (JAX's may be exact
    zeros, whose ulp is no bound), so there they are held to those sums'
    error bound, as the card tests hold the wgmma bodies."""
    bh = 2
    q, k, v = (_rand((bh, s, d), i) for i in range(3))
    do = _rand((bh, s, d), 7)
    tq, tk, tv_, tdo = (torch.tensor(t)[None].to(TORCH[kind])
                        for t in (q, k, v, do))
    scale = d ** -0.5
    o, lse = tfa.flash_single_fwd_plain(tq, tk, tv_, scale, kv_len)
    single = tfa.flash_single_bwd_plain(tq, tk, tv_, o, lse, tdo, scale,
                                        kv_len)
    blocked = tfa.flash_blocked_bwd_plain(tq, tk, tv_, o, lse, tdo, scale,
                                          kv_len)
    s_p = -(-s // 16) * 16
    jl = np.pad(lse.numpy(), ((0, 0), (0, s_p - s)))[..., None].repeat(
        128, axis=-1)
    bwd = jax.jit(lambda *a: jfa._bwd_single(*a, scale=scale, kv_len=kv_len,
                                             interpret=True))
    want = bwd(*(jnp.asarray(_pad(t, s_p), JNP[kind]) for t in (q, k, v)),
               jnp.asarray(_pad(o[0].float().numpy(), s_p), JNP[kind]),
               jnp.asarray(jl), jnp.asarray(_pad(do, s_p), JNP[kind]))
    noise = _one_key_noise(q, k, v, do, scale) if kv_len == 1 else None
    for i, (g, b, w) in enumerate(zip(single, blocked, want)):
        assert g.dtype == b.dtype == TORCH[kind]
        assert g.shape == b.shape == (1, bh, s, d)
        w = np.asarray(w, np.float32)[:, :s]
        if noise is not None and i < 2:     # dq, dk: rounding noise
            for t in (g[0].float().numpy(), b[0].float().numpy(), w):
                assert np.abs(t).max() <= noise[i]
            continue
        _close(kind, g[0], w)
        _close(kind, b[0], w)
        _close(kind, g[0], b[0].float().numpy())
    for g in single[1:]:
        assert not g[:, :, kv_len:].any()


def _one_key_noise(q, k, v, do, scale):
    """At kv_len = 1: the f32 error bound of ds = p (dp - delta) scale,
    d ulps (2^-23) of sum |do_i v_i| per score (each of dp and delta), times
    scale, carried through k[0] into dq and through q into dk (the bound
    ``tests/test_torch_cuda.py`` holds the wgmma bodies to there)."""
    d = q.shape[-1]
    noise = scale * d * 2.0 ** -22 * (np.abs(do) @ np.abs(
        v[:, :1]).transpose(0, 2, 1))                  # (bh, S, 1)
    return ((noise * np.abs(k[:, :1])).max(),
            (noise.transpose(0, 2, 1) @ np.abs(q)).max())


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, True),          # the op at (1536, 197, 64)
    (torch.bfloat16, 16, True), (torch.bfloat16, 32, True),
    (torch.bfloat16, 128, False), (torch.bfloat16, 256, False),
    (torch.float32, 64, False), (torch.float32, 32, False)])
def test_single_bwd_route_predicate(dtype, d, want):
    """Kernel 10 runs kernels 12's and 13's wgmma bodies under their rule,
    ``blocked_bwd_on_wgmma``, whatever S <= 512 and kv_len; float32 and
    head dims 128 and 256 stay on the streamed body (the card tests hold
    the C entry's rule, which it shares with kernels 12 and 13, to this
    predicate)."""
    assert tfa.blocked_bwd_on_wgmma(dtype, d) is want


def test_cpu_single_backward_counts_no_launch():
    """CPU tensors run kernel 10's plain version: the single-block op under
    autograd, in bfloat16 at head dim 16 (inside the rule) and in float32
    (outside it), counts no launch of kernel 10 on either body."""
    fa = tfa.flash_attention

    def counts():
        return (fa.single_bwd_launches, fa.single_bwd_wgmma_launches,
                fa.single_bwd_streamed_launches)

    before = counts()
    for dtype in (torch.bfloat16, torch.float32):
        leaves = [torch.tensor(_rand((1, 2, 20, 16), i)).to(dtype)
                  .requires_grad_(True) for i in range(3)]
        o = fa(*leaves, kv_len=17)              # Sq == Skv <= 512: single
        o.float().sum().backward()
        assert all(leaf.grad is not None for leaf in leaves)
    assert counts() == before


# a ViViT whose space sequence exceeds one kv block: 24^2 + 1 = 577 tokens
# pad to 592 (tests/test_torch_flash.py's LONG)
LONG = dict(image_size=96, patch_size=4, num_classes=5, num_frames=2,
            dim=32, depth=2, heads=2, dim_head=16, channels_last=True)
CFG = dict(model="vivit", precision="f32", n_classes=5, frame_len=2)


def test_vivit_training_step_above_one_kv_block_matches_jax(monkeypatch):
    """One training step's loss and every gradient leaf of a tiny ViViT at
    577 space tokens: the port's ``"pallas"`` space blocks run kernels 11,
    12 and 13's plain versions under autograd; JAX's run its blockwise
    kernels in interpret mode (its dispatch reaches ``flash_attention``,
    forced to interpret on the CPU), as on the TPU."""
    real = jfa.flash_attention
    monkeypatch.setattr(jatt, "flash_attention",
                        lambda *a, interpret=False, **k: real(
                            *a, interpret=True, **k))
    rng = np.random.default_rng(0)
    batch = {"vid": rng.standard_normal((2, 2, 96, 96, 3)).astype(
        np.float32), "label": (rng.random((2, 5)) < 0.3).astype(np.float32)}
    jm = jv.ViViT(attention_impl="pallas", **LONG)
    v = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(batch["vid"]))

    def jloss(p):
        return jsteps.forward_and_loss(
            jm, JConfig(**CFG), {"params": p},
            {k: jnp.asarray(a) for k, a in batch.items()},
            jax.random.PRNGKey(0), train=True)[0]

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(v["params"])

    tm = tv.ViViT(attention_impl="pallas", **LONG)
    tm.load_state_dict(jax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                v)))
    assert not tm.space_transformer.blocks[0].fused_eligible(
        torch.zeros(4, 592, 32))
    params = dict(tm.named_parameters())
    before = tfa.flash_attention.blocked_dq_launches
    loss, _, _ = tsteps.forward_and_loss(
        tm, TConfig(**CFG), {"params": params},
        {k: torch.tensor(a) for k, a in batch.items()}, DropoutRng(0),
        train=True)
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    assert tfa.flash_attention.blocked_dq_launches == before  # plain: CPU
    np.testing.assert_allclose(loss.item(), float(jl), **FWD_TOL)
    want = jax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": jgrads}))
    assert set(want) == set(grads)
    for name, w in want.items():
        np.testing.assert_allclose(grads[name].numpy(), w.numpy(),
                                   err_msg=name, **GRAD_TOL)
