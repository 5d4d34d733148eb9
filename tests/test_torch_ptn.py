"""The port's PTN and torch-semantics encoder against the JAX package's,
on the CPU.

Weights come from JAX ``init`` and cross over through
``devt_tpu_torch.utils.jax_bridge``; inputs are numpy from a seed.  f32 on
both sides with sums in other orders: the JAX package's own parity bound,
atol 2e-5 / rtol 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu.config import Config as JConfig
from devt_tpu.models import layers as jl
from devt_tpu.models import torch_encoder as jenc
from devt_tpu.registry import build_model as jbuild
from devt_tpu.registry import example_batch as jexample
from devt_tpu_torch import registry as treg
from devt_tpu_torch.config import Config
from devt_tpu_torch.models import layers as tl
from devt_tpu_torch.models import torch_encoder as tenc
from devt_tpu_torch.utils.jax_bridge import (jax_to_state_dict,
                                             state_dict_to_jax)

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-4)
NARROW = dict(seq_len=6, nlayers=2, nhid=64, input_dimension=64, nhead=4,
              dropout=0.0, precision="f32",
              experts=("video-embeddings", "audio-embeddings"))


def _np_tree(v):
    return jax.tree_util.tree_map(np.asarray, v)


@pytest.mark.parametrize("d_model,max_len,s", [(64, 14, 14), (10, 8, 5)])
def test_positional_encoding_matches_jax(d_model, max_len, s):
    x = np.random.default_rng(0).standard_normal((2, s, d_model)) \
        .astype(np.float32)
    want = jl.PositionalEncoding(d_model, dropout=0.5, max_len=max_len) \
        .apply({}, jnp.asarray(x))
    tm = tl.PositionalEncoding(d_model, dropout=0.5, max_len=max_len).eval()
    np.testing.assert_allclose(tm(torch.tensor(x)).numpy(), np.asarray(want),
                               atol=1e-6, rtol=1e-6)
    table = jl.sinusoidal_positional_encoding(max_len, d_model)
    np.testing.assert_allclose(
        tl.sinusoidal_positional_encoding(max_len, d_model).numpy(),
        np.asarray(table), atol=1e-6, rtol=1e-6)
    # a constant, not a parameter, and not part of the weights
    assert not list(tm.parameters()) and not tm.state_dict()


@pytest.mark.parametrize("impl", ["xla", "auto"])
def test_encoder_layer_matches_jax(impl):
    x = np.random.default_rng(1).standard_normal((3, 7, 64)) \
        .astype(np.float32)
    jm = jenc.TorchEncoderLayer(64, 4, dim_feedforward=96, dropout=0.0,
                                attention_impl="xla")
    v = _np_tree(jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x)))
    want = jm.apply(v, jnp.asarray(x))
    tm = tenc.TorchEncoderLayer(64, 4, dim_feedforward=96, dropout=0.0,
                                attention_impl=impl).eval()
    tm.load_state_dict(jax_to_state_dict(v))
    with torch.no_grad():
        got = tm(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encoder_stack_and_its_refusals():
    x = np.random.default_rng(2).standard_normal((2, 5, 32)) \
        .astype(np.float32)
    jm = jenc.TorchTransformerEncoder(32, 2, 48, 2, dropout=0.0,
                                      attention_impl="xla")
    v = _np_tree(jm.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x)))
    tm = tenc.TorchTransformerEncoder(32, 2, 48, 2, dropout=0.0).eval()
    tm.load_state_dict(jax_to_state_dict(v))
    with torch.no_grad():
        got = tm(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(
        v, jnp.asarray(x))), **TOL)
    # remat is ported: the same weights give the same output in eval,
    # where there is nothing to rematerialise, and in a training forward
    remat = tenc.TorchTransformerEncoder(32, 2, 48, 2, dropout=0.0,
                                         remat=True).eval()
    remat.load_state_dict(tm.state_dict())
    with torch.no_grad():
        assert torch.equal(remat(torch.tensor(x)), got)
    leaf = torch.tensor(x).requires_grad_(True)
    y = remat.train()(leaf)
    (grad,) = torch.autograd.grad(y.sum(), leaf)
    assert torch.isfinite(grad).all()
    np.testing.assert_allclose(y.detach().numpy(), got.numpy(), **TOL)
    # a training forward with dropout needs its randomness handed in
    drop = tenc.TorchTransformerEncoder(32, 2, 48, 1, dropout=0.1).train()
    with pytest.raises(ValueError, match="DropoutRng"):
        drop(torch.tensor(x))
    a = drop(torch.tensor(x), tl.DropoutRng(3))
    b = drop(torch.tensor(x), tl.DropoutRng(3))
    assert torch.equal(a, b) and torch.isfinite(a).all()


@pytest.fixture(scope="module", params=["ptn", "ptn_shared"])
def pair(request):
    kw = dict(model=request.param, **NARROW)
    jcfg = JConfig(**kw)
    batch = jexample(jcfg, batch_size=3)
    jm = jbuild(jcfg)
    v = _np_tree(jm.init({"params": jax.random.PRNGKey(0)},
                         jnp.asarray(batch["experts"])))
    tm = treg.build_model(Config(**kw)).eval()
    tm.load_state_dict(jax_to_state_dict(v))
    return jm, v, tm, batch


def test_ptn_matches_jax(pair):
    jm, v, tm, batch = pair
    want = jm.apply(v, jnp.asarray(batch["experts"]))
    with torch.no_grad():
        got = tm(torch.tensor(batch["experts"]))
    assert got.shape == (3, 15)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ptn_bridge_round_trip(pair):
    _, v, tm, _ = pair
    sd = tm.state_dict()
    assert set(jax_to_state_dict(v)) == set(sd)
    first = tm.encoder_names[0]
    assert sd[f"{first}.layers.1.self_attn.in_proj.weight"].shape == (192, 64)
    assert sd["cls"].shape == (1, 1, 64)
    back = state_dict_to_jax(sd)
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(flat_b)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_ptn_rejects_a_wrong_expert_count(pair):
    _, _, tm, batch = pair
    with pytest.raises(ValueError, match="expected 2 expert streams"):
        tm(torch.tensor(batch["experts"][:, :, :1]))


@pytest.mark.parametrize("name", ["ptn", "ptn_shared"])
def test_registry_builds_and_draws_like_jax(name):
    kw = dict(model=name, **NARROW)
    want = jexample(JConfig(**kw), batch_size=2)
    got = treg.example_batch(Config(**kw), batch_size=2)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    a = treg.build_model(Config(**kw)).state_dict()
    b = treg.build_model(Config(**kw)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    # flax's initializers: the CLS token uniform in [0, 1), unit LN scales
    assert 0.0 <= a["cls"].min() and a["cls"].max() < 1.0
    assert torch.all(a["head_norm.weight"] == 1)
    n_enc = 1 if name == "ptn_shared" else 2
    assert sum(k.endswith("layers.0.linear1.weight") for k in a) == n_enc
