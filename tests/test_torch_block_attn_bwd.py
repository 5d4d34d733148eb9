"""The wgmma route of the attention backward that kernels 2 and 8 share,
against the JAX package, on the CPU.

On the card ``csrc/block_bwd_parts.cuh:block_attention_bwd_bf16`` runs, where
``block_bwd_on_wgmma`` says, three launches: the recompute from the stored
lse (att, do = round(datt), and delta from the f32 datt and the f32 o),
then kernel 12's body (dq) and kernel 13's (dk, dv) with that delta given.
``fused_block.block_attention_bwd_plain`` is that decomposition in the
launches' order; here it is held against JAX's ``_mha_fwd_bwd``
(``devt_tpu/ops/fused_block.py:119``, the function both JAX backward kernels
call) on the same numpy inputs, and the route's Python rule at its edges.
The kernels themselves are held against the plain versions on the card in
``tests/test_torch_cuda.py``.

Bound: the backward gate of the card tests, 4 bf16 ulps (2^-8 each) of
each tensor's largest element: both sides round the products' operands to
bf16 at the same places, and sum in f32 in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu.ops import fused_block as jfb
from devt_tpu_torch.ops import flash_attention as tfa
from devt_tpu_torch.ops import fused_block as tfb

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

BWD_ULPS, EPS = 4, 2.0 ** -8


def _inputs(b, s, heads, d, kv_len, seed):
    """qkv as the block's LN1 @ Wqkv gives it (f32 values rounded to bf16
    by the products), the forward's lse, and an f32 datt."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, s, 3 * heads * d)).astype(np.float32)
    datt = rng.standard_normal((b, s, heads * d)).astype(np.float32)
    _, lse = tfb._mha_fwd(torch.tensor(qkv), heads, d, d ** -0.5, kv_len,
                          torch.bfloat16)
    return qkv, lse.numpy(), datt


def _assert_gate(name, got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    bound = BWD_ULPS * EPS * np.abs(want).max()
    assert err <= bound, f"{name}: {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("b,s,heads,d,kv_len", [
    (2, 48, 2, 32, 1), (2, 48, 2, 32, 37), (2, 48, 2, 32, 48),
    (1, 208, 3, 64, 197), (1, 80, 3, 64, 1), (1, 80, 3, 64, 80)])
def test_decomposition_matches_jax_mha_fwd_bwd(b, s, heads, d, kv_len):
    """att and dqkv of the three launches' plain version against JAX's
    ``_mha_fwd_bwd`` in bf16 at one live key, fewer than S and all S, at
    both compiled head dims and the main path's S 208 / kv_len 197.  At one
    live key dq and dk are zero in exact arithmetic (dp = delta): there
    both sides' noise is held to the f32 error bound of those sums."""
    qkv, lse, datt = _inputs(b, s, heads, d, kv_len, seed=s + kv_len)
    scale = d ** -0.5
    fn = jax.jit(lambda a, l, g: jfb._mha_fwd_bwd(
        a, l, g, heads, d, scale, kv_len, jnp.bfloat16))
    want_att, want_dqkv = (np.asarray(t) for t in fn(
        jnp.asarray(qkv), jnp.asarray(lse), jnp.asarray(datt)))
    att, dqkv = tfb.block_attention_bwd_plain(
        torch.tensor(qkv), torch.tensor(lse), torch.tensor(datt), heads, d,
        scale, kv_len, torch.bfloat16)
    _assert_gate("att", att.numpy(), want_att)
    inner = heads * d
    for i, name in enumerate(("dq", "dk", "dv")):
        got = dqkv[..., i * inner:(i + 1) * inner].numpy()
        want = want_dqkv[..., i * inner:(i + 1) * inner]
        if kv_len == 1 and name != "dv":
            # sums of terms of size |p dp| that cancel to zero
            bound = 64 * 2.0 ** -23 * np.abs(datt).max() * np.abs(qkv).max() \
                * d
            assert np.abs(got - want).max() <= bound, name
        else:
            _assert_gate(name, got, want)


def test_decomposition_is_the_one_pass_plain_version():
    """The decomposition and the port's one-pass ``_mha_fwd_bwd`` (the
    plain backward's) compute the same values in f32: the keys past
    kv_len get p = 0 in the first, exp(-1e30) = 0 in the second."""
    qkv, lse, datt = _inputs(3, 32, 2, 16, 21, seed=5)
    args = (torch.tensor(qkv), torch.tensor(lse), torch.tensor(datt), 2, 16,
            0.25, 21, torch.float32)
    att, dqkv = tfb.block_attention_bwd_plain(*args)
    want_att, want_dqkv = tfb._mha_fwd_bwd(*args)
    torch.testing.assert_close(att, want_att, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(dqkv, want_dqkv, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("dtype,d,kv_len,want", [
    (torch.bfloat16, 64, 197, True), (torch.bfloat16, 32, 48, True),
    (torch.bfloat16, 16, 1, True), (torch.bfloat16, 64, 256, True),
    (torch.bfloat16, 64, 257, False), (torch.bfloat16, 64, 0, False),
    (torch.bfloat16, 48, 64, False), (torch.bfloat16, 128, 64, False),
    (torch.float32, 64, 197, False)])
def test_block_bwd_route_predicate(dtype, d, kv_len, want):
    """The route's Python rule at its edges: the forward's one-shot rule
    (bfloat16, head dim 16, 32 or 64, 1 to 256 live keys) within kernels
    12's and 13's (bfloat16 at those head dims).  The main path (197 live
    keys at head dim 64) takes it; the backward's longer sequences (up to
    397 tokens at head dim 64, bwd_takes_shape) keep attention_bwd_bf16
    past 256 live keys."""
    assert tfb.block_bwd_on_wgmma(dtype, d, kv_len) is want
    assert want == (tfa.one_shot_on_wgmma(dtype, d, kv_len)
                    and tfa.blocked_bwd_on_wgmma(dtype, d))


@pytest.mark.parametrize("kv_len", [1, 13, 16])
def test_cpu_backward_counts_no_body(kv_len):
    """On CPU tensors kernels 2 and 8 run their plain versions and count
    no launch on either body."""
    rng = np.random.default_rng(kv_len)
    dim, heads, mlp = 32, 2, 64
    x = torch.tensor(rng.standard_normal((2, 16, dim)).astype(np.float32))
    params = {"g1": torch.ones(1, dim), "b1": torch.zeros(1, dim),
              "wqkv": torch.tensor(rng.standard_normal((dim, 3 * dim))
                                   .astype(np.float32) * 0.1),
              "wo": torch.tensor(rng.standard_normal((dim, dim))
                                 .astype(np.float32) * 0.1),
              "bo": torch.zeros(1, dim), "g2": torch.ones(1, dim),
              "b2": torch.zeros(1, dim),
              "w1": torch.tensor(rng.standard_normal((dim, mlp))
                                 .astype(np.float32) * 0.1),
              "bb1": torch.zeros(1, mlp),
              "w2": torch.tensor(rng.standard_normal((mlp, dim))
                                 .astype(np.float32) * 0.1),
              "bb2": torch.zeros(1, dim)}
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    before = [(fn.bwd_wgmma_launches, fn.bwd_streamed_launches)
              for fn in (tfb.fused_vit_block, tfb.fused_attn_half)]
    y, _, _ = tfb.fused_vit_block(x, leaves, heads, 0.25, kv_len)
    u, _ = tfb.fused_attn_half(x, {k: leaves[k] for k in tfb.HALF_NAMES},
                               heads, 0.25, kv_len)
    (y.sum() + u.sum()).backward()
    assert all(leaves[k].grad is not None for k in tfb.PARAM_NAMES)
    assert [(fn.bwd_wgmma_launches, fn.bwd_streamed_launches)
            for fn in (tfb.fused_vit_block, tfb.fused_attn_half)] == before
