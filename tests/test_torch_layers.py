"""The port's transformer layers against the JAX package's, on the CPU.

Weights come from JAX ``init`` and cross over through
``devt_tpu_torch.utils.jax_bridge``; inputs are numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu.models import layers as jl
from devt_tpu.ops import attention as jatt
from devt_tpu_torch.models import layers as tl
from devt_tpu_torch.ops import attention as tatt
from devt_tpu_torch.utils.jax_bridge import (jax_to_state_dict,
                                             state_dict_to_jax)

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

DIM, HEADS, DIM_HEAD, MLP = 32, 2, 16, 64
# f32 on both sides; the sums run in other orders
TOL = dict(atol=2e-5, rtol=2e-4)


def _x(b=3, s=16, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, DIM)).astype(np.float32)


def _jax_vars(module, x, kv_len):
    v = module.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                    True, kv_len)
    return jax.tree_util.tree_map(np.asarray, v)


@pytest.mark.parametrize("kv_len", [None, 13])
def test_unfused_block_matches_jax(kv_len):
    """attention_impl='xla': LN, Linear, materialised attention, erf GELU."""
    x = _x()
    jm = jl.ViTBlock(DIM, HEADS, DIM_HEAD, MLP, attention_impl="xla")
    v = _jax_vars(jm, x, kv_len)
    want = np.asarray(jm.apply(v, jnp.asarray(x), True, kv_len))
    tm = tl.ViTBlock(DIM, HEADS, DIM_HEAD, MLP, attention_impl="xla").eval()
    tm.load_state_dict(jax_to_state_dict(v))
    assert not tm.fused_eligible(torch.tensor(x))
    got = tm(torch.tensor(x), kv_len).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("impl", ["xla", "fused_interpret"])
def test_transformer_matches_jax(impl):
    """A depth-2 stack with its final LN, unfused (erf) and fused (tanh)."""
    x = _x(seed=1)
    kv_len = 11
    jm = jl.ViTTransformer(DIM, 2, HEADS, DIM_HEAD, MLP, attention_impl=impl)
    v = _jax_vars(jm, x, kv_len)
    want = np.asarray(jm.apply(v, jnp.asarray(x), True, kv_len))
    tm = tl.ViTTransformer(DIM, 2, HEADS, DIM_HEAD, MLP,
                           attention_impl=impl).eval()
    tm.load_state_dict(jax_to_state_dict(v))
    assert tm.blocks[0].fused_eligible(torch.tensor(x)) == (impl != "xla")
    got = tm(torch.tensor(x), kv_len).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_fused_and_unfused_differ_by_gelu_form_only():
    """Same weights: the fused (tanh GELU) and unfused (erf) paths agree
    to the ~3e-4 gap between the two GELU forms, and no closer than
    float noise — so the test would notice the forms being swapped."""
    x = _x(seed=2)
    fused = tl.ViTBlock(DIM, HEADS, DIM_HEAD, MLP, attention_impl="auto")
    tl.init_weights(fused, torch.Generator().manual_seed(0))
    unfused = tl.ViTBlock(DIM, HEADS, DIM_HEAD, MLP, attention_impl="xla")
    unfused.load_state_dict(fused.state_dict())
    with torch.no_grad():
        gap = (fused(torch.tensor(x)) - unfused(torch.tensor(x))).abs().max()
    assert 1e-6 < gap.item() < 3e-3


@pytest.mark.parametrize("heads,dim_head,s", [(2, 8, 16), (1, 32, 16),
                                              (2, 16, 17)])
def test_fused_eligibility_rules(heads, dim_head, s):
    """heads*dim_head != dim, the single-head no-projection edge, and a
    token count that is not a multiple of 16 all take the unfused path,
    as in devt_tpu/models/layers.py:ViTBlock._fused_eligible."""
    block = tl.ViTBlock(DIM, heads, dim_head, MLP, attention_impl="auto")
    assert not block.fused_eligible(torch.zeros(1, s, DIM))


@pytest.mark.parametrize("kv_len", [None, 5])
def test_xla_attention_matches_jax(kv_len):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 3, 8, 4)).astype(np.float32)
               for _ in range(3))
    want = jatt.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              scale=0.5, kv_len=kv_len)
    got = tatt.xla_attention(torch.tensor(q), torch.tensor(k),
                             torch.tensor(v), scale=0.5, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_packed_mha_matches_jax():
    qkv = np.random.default_rng(4).standard_normal(
        (2, 9, 3 * DIM)).astype(np.float32)
    want = jatt.packed_mha(jnp.asarray(qkv), heads=HEADS, impl="xla",
                           kv_len=7)
    got = tatt.packed_mha(torch.tensor(qkv), heads=HEADS, impl="xla",
                          kv_len=7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_packed_mha_pallas_is_not_ported():
    """Single-block sequences reach the packed-qkv kernel's wrapper, longer
    ones the blockwise kernels (11, and 12 and 13 for the gradient; their
    plain versions on the CPU), which since the blockwise backward was
    ported give a long sequence its gradient, the materialised
    attention's."""
    qkv = torch.tensor(np.random.default_rng(6).standard_normal(
        (1, 520, 3 * DIM)).astype(np.float32))
    grads = []
    for impl in ("pallas", "xla"):
        leaf = qkv.clone().requires_grad_(True)
        out = tatt.packed_mha(leaf, heads=HEADS, impl=impl)
        assert out.shape == (1, 520, DIM)
        out.square().sum().backward()
        grads.append(leaf.grad)
    torch.testing.assert_close(*grads, atol=5e-5, rtol=5e-4)
    out = tatt.packed_mha(torch.zeros(1, 4, 3 * DIM), heads=HEADS,
                          impl="pallas")
    assert out.shape == (1, 4, DIM)


@pytest.mark.parametrize("kw", [dict(moe_experts=2, remat=True),
                                dict(pipeline_stages=2),
                                dict(sequence_parallel=True),
                                dict(remat=True)])
def test_unported_stack_variants_raise(kw):
    """Every variant of the stack is ported.  The pipeline and
    sequence-parallel stacks build JAX's stacked ``pb_*`` layout (the same
    names and shapes as its module's) and, outside a pipe or seq mesh, run
    it sequentially: the output and every gradient are JAX's module's on
    the same weights (tests/test_torch_sp_pp_ep.py runs them over ranks).
    ``remat`` builds, and a training forward at dropout 0.1 and its
    gradients equal the plain stack's (tests/test_torch_remat.py holds
    whole steps)."""
    if not kw.get("remat"):
        x = _x()
        jm = jl.ViTTransformer(DIM, 2, HEADS, DIM_HEAD, MLP, **kw)
        v = _jax_vars(jm, x, 13)
        sd = jax_to_state_dict(v)
        m = tl.ViTTransformer(DIM, 2, HEADS, DIM_HEAD, MLP, **kw).train()
        assert {k: tuple(t.shape) for k, t in m.state_dict().items()} == \
            {k: tuple(t.shape) for k, t in sd.items()}
        assert "pb_wqkv" in sd
        m.load_state_dict(sd)

        def loss(p, xx):
            y = jm.apply({"params": p}, xx, True, 13)
            return jnp.sum(y ** 2), y

        (_, want), (dp, dx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x))
        xt = torch.tensor(x).requires_grad_(True)
        y = m(xt, 13)
        y.square().sum().backward()
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx),
                                   rtol=1e-4, atol=1e-4)
        grads = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, dp))
        for k, p in m.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), grads[k].numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
        return
    remat = tl.ViTTransformer(DIM, 2, HEADS, DIM_HEAD, MLP, dropout=0.1,
                              **kw).train()
    tl.init_weights(remat, torch.Generator().manual_seed(0))
    plain = tl.ViTTransformer(DIM, 2, HEADS, DIM_HEAD, MLP, dropout=0.1,
                              **{**kw, "remat": False}).train()
    plain.load_state_dict(remat.state_dict())
    runs = []
    for m in (plain, remat):
        x = torch.tensor(_x()).requires_grad_(True)
        losses = []
        y = m(x, 13, tl.DropoutRng(4), losses)
        loss = y.square().sum() + sum(losses)
        runs.append((y.detach(), torch.autograd.grad(
            loss, [x, *m.parameters()]), len(losses)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert runs[0][2] == runs[1][2] == (1 if "moe_experts" in kw else 0)
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_bridge_round_trip():
    x = _x()
    jm = jl.ViTTransformer(DIM, 2, HEADS, DIM_HEAD, MLP, attention_impl="xla")
    v = _jax_vars(jm, x, None)
    sd = jax_to_state_dict(v)
    assert sd["blocks.1.attn.to_qkv.weight"].shape == (3 * DIM, DIM)
    np.testing.assert_array_equal(
        sd["blocks.0.ff.fc1.weight"].numpy(),
        v["params"]["block_0"]["ff"]["fc1"]["kernel"].T)
    back = state_dict_to_jax(sd)
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(flat_b)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(flat_b[path], leaf)
