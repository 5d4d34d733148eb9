"""The port's PTN training step against the JAX package's, on the CPU.

A narrow PTN (width 64, 2 heads of 32, 2 layers, 5 scenes + CLS, 2
experts, batch 3, f32) with the same weights in both packages
(``utils.jax_bridge``), for ``ptn`` and ``ptn_shared``.  JAX runs its
materialised attention (``"auto"`` on the CPU); the port runs ``"xla"``
(the same) and ``"pallas"``, which on CPU tensors is the packed-qkv
kernels' plain forward and backward behind ``FusedMHA``.  Tolerances: the
JAX package's f32 bounds, as in ``test_torch_train_step.py`` (forward atol
2e-5 / rtol 2e-4, gradients 5e-5 / 5e-4, parameters after 4 AdamW steps
2e-5 / 5e-4).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu.config import Config as JConfig
from devt_tpu.parallel import train_step as jts
from devt_tpu.registry import build_model as jbuild
from devt_tpu.registry import example_batch as jexample
from devt_tpu.train import optimizers as jopt
from devt_tpu.train import steps as jsteps
from devt_tpu.train.state import TrainState as JTrainState
from devt_tpu_torch import registry as treg
from devt_tpu_torch.config import Config as TConfig
from devt_tpu_torch.models.layers import DropoutRng
from devt_tpu_torch.ops import attention as tatt
from devt_tpu_torch.parallel import train_step as tts
from devt_tpu_torch.train import optimizers as topt
from devt_tpu_torch.train import steps as tsteps
from devt_tpu_torch.train.state import TrainState
from devt_tpu_torch.utils.jax_bridge import jax_to_state_dict

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

NARROW = dict(seq_len=5, nlayers=2, nhid=64, input_dimension=64, nhead=2,
              precision="f32", opt="adamW", learning_rate=1e-3,
              experts=("video-embeddings", "audio-embeddings"))
FWD_TOL = dict(atol=2e-5, rtol=2e-4)
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)
TRAJ_TOL = dict(atol=2e-5, rtol=5e-4)


def _batch(name, seed=0, labels="multi_hot", b=3):
    batch = jexample(JConfig(model=name, seed=seed, **NARROW), batch_size=b)
    if labels == "int":
        batch["label"] = np.random.default_rng(seed).integers(
            0, 15, b).astype(np.int32)
    return batch


def _pair(name, impl="pallas", dropout=0.0):
    """(jax model, jax params, jax config), (torch model, torch config)
    with the same weights."""
    kw = dict(model=name, dropout=dropout, **NARROW)
    jcfg = JConfig(**kw)
    jm = jbuild(jcfg)
    v = jm.init({"params": jax.random.PRNGKey(0)},
                jnp.asarray(_batch(name)["experts"]))
    tcfg = TConfig(attention_impl=impl, **kw)
    tm = treg.build_model(tcfg)
    tm.load_state_dict(jax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, v)))
    return (jm, v["params"], jcfg), (tm, tcfg)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tstate(tm, tcfg):
    return TrainState.create(dict(tm.named_parameters()),
                             topt.build_optimizer(tcfg))


def _assert_params(state, jparams, tol, steps, what=""):
    """Every parameter against JAX's, but for the key third of each
    ``in_proj.bias``: a bias on the keys adds a constant to a row of scores,
    so its exact gradient is 0 and both packages' gradients are rounding
    noise, which Adam scales to steps of up to ``learning_rate`` either
    way.  There both sides stay within that many steps of 0."""
    want = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(want) == set(state.params)
    e, lr = NARROW["input_dimension"], NARROW["learning_rate"]
    for k, w in want.items():
        got, w = state.params[k].detach().numpy(), w.numpy()
        if k.endswith("in_proj.bias"):
            for t in (got, w):
                assert np.abs(t[e:2 * e]).max() <= 1.01 * steps * lr, k
            got, w = np.delete(got, np.s_[e:2 * e]), np.delete(w, np.s_[e:2 * e])
        np.testing.assert_allclose(got, w, err_msg=f"{what} {k}", **tol)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("labels", ["multi_hot", "int"])
@pytest.mark.parametrize("name", ["ptn", "ptn_shared"])
def test_loss_probs_and_every_gradient_leaf_match_jax(name, labels, impl):
    """Multi-hot labels take BCE and sigmoid probabilities, single labels
    cross-entropy and softmax."""
    (jm, jparams, jcfg), (tm, tcfg) = _pair(name, impl)
    batch = _batch(name, labels=labels)

    def jloss(p):
        loss, aux, _ = jsteps.forward_and_loss(
            jm, jcfg, {"params": p}, _jbatch(batch), jax.random.PRNGKey(0),
            train=True)
        return loss, aux

    (jl, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    params = dict(tm.named_parameters())
    loss, aux, ms = tsteps.forward_and_loss(
        tm, tcfg, {"params": params},
        {k: torch.tensor(v) for k, v in batch.items()}, DropoutRng(0),
        train=True)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert ms == {} and set(aux) == {"probs", "label"}
    np.testing.assert_allclose(loss.item(), float(jl), **FWD_TOL)
    np.testing.assert_allclose(aux["probs"].detach().numpy(),
                               np.asarray(jaux["probs"]), **FWD_TOL)
    if labels == "int":
        np.testing.assert_allclose(aux["probs"].sum(-1).detach().numpy(), 1.0,
                                   rtol=1e-6)
    want = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(want) == set(params)          # every leaf
    for (k, _), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k,
                                   **GRAD_TOL)


@pytest.mark.parametrize("name", ["ptn", "ptn_shared"])
def test_four_step_adamw_trajectory_matches_jax(name):
    (jm, jparams, jcfg), (tm, tcfg) = _pair(name)
    jstate = JTrainState.create(jparams, jopt.build_optimizer(jcfg))
    jstep = jts.make_train_step(jm, jcfg)
    state = _tstate(tm, tcfg)
    step = tts.make_train_step(tm, tcfg, device="cpu")
    for i in range(4):
        batch = _batch(name, seed=10 + i)
        jstate, jmetrics = jstep(jstate, _jbatch(batch),
                                 jax.random.PRNGKey(1))
        state, metrics = step(state, batch, 1)
        np.testing.assert_allclose(metrics["loss"].item(),
                                   float(jmetrics["loss"]),
                                   err_msg=f"step {i}", **FWD_TOL)
        _assert_params(state, jstate.params, TRAJ_TOL, i + 1, f"step {i}")
    assert state.step == int(jstate.step) == 4


def test_multi_step_equals_single_steps():
    """``make_multi_step`` places a stacked ``experts`` batch and runs the
    very same arithmetic as single steps, dropout included."""
    (_, _, _), (tm, tcfg) = _pair("ptn", dropout=0.5)
    batches = [_batch("ptn", seed=20 + i) for i in range(3)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    single_model = copy.deepcopy(tm)
    single = _tstate(single_model, tcfg)
    step = tts.make_train_step(single_model, tcfg, device="cpu")
    losses = []
    for b in batches:
        single, m = step(single, b, 3)
        losses.append(m["loss"].item())
    state, metrics = tts.make_multi_step(tm, tcfg, 3, device="cpu")(
        _tstate(tm, tcfg), stacked, 3)
    assert state.step == 3
    assert metrics["loss"].item() == pytest.approx(np.mean(losses), rel=1e-6)
    for k in state.params:
        assert torch.equal(state.params[k], single.params[k]), k


@pytest.mark.parametrize("name", ["ptn", "ptn_shared"])
def test_eval_step_matches_jax(name):
    (jm, jparams, jcfg), (tm, tcfg) = _pair(name, dropout=0.5)
    batch = _batch(name, seed=40)
    jstate = JTrainState.create(jparams, jopt.build_optimizer(jcfg))
    jl, jaux = jts.make_eval_step(jm, jcfg)(jstate, _jbatch(batch))
    loss, aux = tts.make_eval_step(tm, tcfg, device="cpu")(
        _tstate(tm, tcfg), batch)
    assert not loss.requires_grad and not tm.training
    np.testing.assert_allclose(loss.item(), float(jl), **FWD_TOL)
    np.testing.assert_allclose(aux["probs"].numpy(),
                               np.asarray(jaux["probs"]), **FWD_TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_a_steps_dropout_depends_only_on_seed_and_step(impl):
    """Two runs from equal states draw equal masks (the positional
    encoding's, the encoder's Linear sites' and the attention
    probabilities'); another seed, and no dropout, differ."""
    def run(seed, steps, dropout=0.5):
        (_, _, _), (tm, tcfg) = _pair("ptn_shared", impl, dropout)
        state = _tstate(tm, tcfg)
        step = tts.make_train_step(tm, tcfg, device="cpu")
        out = []
        for _ in range(steps):
            state, m = step(state, _batch("ptn_shared", seed=50), seed)
            out.append(m["loss"].item())
        return out

    a, b, c = run(7, 2), run(7, 2), run(8, 1)
    assert a == b
    assert a[0] != c[0] and a[0] != a[1]
    assert a[0] != run(7, 1, dropout=0.0)[0]


def test_training_forward_takes_the_kernel_route_unquantized(monkeypatch):
    """With ``"pallas"`` every encoder layer's attention goes to
    ``fused_mha`` with the model's dropout rate and a seed drawn from the
    step's ``DropoutRng`` (4 calls for ``ptn``: 2 experts x 2 layers).  A
    training forward inside ``quant_scope`` stays unquantized: the four
    Linear sites take ``dense``."""
    (_, _, _), (tm, tcfg) = _pair("ptn", "pallas", dropout=0.5)
    calls = []
    real = tatt.fused_mha

    def spy(qkv, **kw):
        calls.append((kw["dropout_rate"], kw["seed"]))
        return real(qkv, **kw)

    monkeypatch.setattr(tatt, "fused_mha", spy)
    experts = torch.tensor(_batch("ptn")["experts"])
    tm.train()
    out = tm(experts, DropoutRng(4))
    assert len(calls) == 4 and all(r == 0.5 and isinstance(s, int)
                                   for r, s in calls)
    assert len({s for _, s in calls}) == 4
    with tatt.quant_scope():
        scoped = tm(experts, DropoutRng(4))
    assert torch.equal(out, scoped)
    tm.eval()
    with torch.no_grad():
        plain = tm(experts)
    assert [r for r, _ in calls[8:]] == [0.0] * 4
    assert not torch.equal(out.detach(), plain)
