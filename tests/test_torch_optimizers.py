"""The port's optimizers against the JAX package's optax chains.

Each ``config.opt`` choice runs 5 updates on the same small tree with the
same numpy gradients in both packages; parameters and moments are
compared after every update.  Leaves keep one layout on both sides (no
transposes), carried over by ``utils.jax_bridge.jax_to_state_dict`` with
leaf names that it passes through unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu.config import Config as JConfig
from devt_tpu.train import optimizers as jopt
from devt_tpu_torch.config import Config as TConfig
from devt_tpu_torch.train import optimizers as topt
from devt_tpu_torch.train.state import TrainState
from devt_tpu_torch.utils.jax_bridge import jax_to_state_dict

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

# f32 elementwise chains on values of order 1: the two differ in fused
# multiply-adds and in where the host rounds the bias corrections and
# schedule values to f32 (a few f32 ulps, 1.2e-7 each; absolute where a sum
# cancels)
TOL = dict(atol=1e-6, rtol=2e-5)
# a bf16-stored moment: one bf16 ulp (at most 2^-7 relative) where the two
# f32 values straddle a rounding boundary
BF16_TOL = dict(atol=1e-6, rtol=2.0 ** -7)
STEPS = 5
# one leaf with two axes >= 128 (adafactor factors it), small ones besides
SHAPES = {"wide": {"w": (130, 140)}, "lin": {"w": (6, 5), "b": (5,)},
          "pos": (1, 3, 4)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        return (rng.standard_normal(node) * scale).astype(np.float32)
    return make(SHAPES)


def _run(cfg_kw, grad_scale=1.0):
    """5 updates in both packages; yields per step (jax params, jax opt
    state, torch TrainState)."""
    kw = dict(model="vivit", learning_rate=1e-2, weight_decay=0.09,
              momentum=0.9, **cfg_kw)
    jtx = jopt.build_optimizer(JConfig(**kw))
    ttx = topt.build_optimizer(TConfig(**kw))
    jparams = jax.tree_util.tree_map(jnp.asarray, _tree(0))
    jstate = jtx.init(jparams)
    tparams = {k: v.clone() for k, v in jax_to_state_dict(_tree(0)).items()}
    state = TrainState.create(tparams, ttx)
    for i in range(STEPS):
        grads = _tree(10 + i, grad_scale)
        updates, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray,
                                                            grads),
                                     jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
        # JAX dispatches asynchronously: finish its update before the
        # port's runs, so that the two never compute side by side
        jax.block_until_ready((jparams, jstate))
        state = state.apply_gradients(jax_to_state_dict(grads))
        yield jparams, jstate, state


def _assert_tree(got: dict, want_tree, tol=TOL, what=""):
    want = jax_to_state_dict(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), want_tree))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(), want[k].numpy(),
                                   err_msg=f"{what} {k}", **tol)


def _named(state: TrainState, tensors):
    return dict(zip(state.params, tensors))


def _find(jstate, cls_name):
    """The first optax state of that class in a (nested) chain state."""
    if type(jstate).__name__ == cls_name:
        return jstate
    if isinstance(jstate, tuple):
        for s in jstate:
            found = _find(s, cls_name)
            if found is not None:
                return found
    return None


def _part(state: TrainState, cls):
    i = [type(p) for p in state.tx.parts].index(cls)
    return state.opt_state[i]


@pytest.mark.parametrize("clip", [0.0, 0.5])
@pytest.mark.parametrize("opt", ["adamW", "adam", "sgd", "adagrad",
                                 "adafactor"])
def test_params_follow_optax(opt, clip):
    """Every opt choice, without clipping and with a global-norm clip that
    bites (the gradients' norm is about 135)."""
    for step, (jparams, _, state) in enumerate(
            _run(dict(opt=opt, grad_clip_norm=clip))):
        _assert_tree(state.params, jparams, what=f"{opt} step {step}")
    assert state.step == STEPS


@pytest.mark.parametrize("opt", ["adamW", "adam"])
@pytest.mark.parametrize("moment_dtype", ["f32", "bf16"])
def test_adam_moments_follow_optax(opt, moment_dtype):
    for jparams, jstate, state in _run(dict(opt=opt,
                                            moment_dtype=moment_dtype)):
        adam = _find(jstate, "ScaleByAdamState")
        mine = _part(state, topt.ScaleByAdam)
        assert mine["count"] == int(adam.count)
        mu = _named(state, mine["mu"])
        if moment_dtype == "bf16":
            assert all(m.dtype == torch.bfloat16 for m in mu.values())
            assert all(m.dtype == jnp.bfloat16
                       for m in jax.tree_util.tree_leaves(adam.mu))
        _assert_tree(mu, adam.mu,
                     BF16_TOL if moment_dtype == "bf16" else TOL, "mu")
        assert all(n.dtype == torch.float32 for n in mine["nu"])
        _assert_tree(_named(state, mine["nu"]), adam.nu, what="nu")
        _assert_tree(state.params, jparams,
                     dict(atol=1e-6, rtol=1e-4) if moment_dtype == "bf16"
                     else TOL, "params")


def test_sgd_and_adagrad_accumulators_follow_optax():
    for _, jstate, state in _run(dict(opt="sgd")):
        _assert_tree(_named(state, _part(state, topt.Trace)["trace"]),
                     _find(jstate, "TraceState").trace, what="trace")
    for _, jstate, state in _run(dict(opt="adagrad")):
        acc = _part(state, topt.ScaleByRss)["sum_of_squares"]
        _assert_tree(_named(state, acc),
                     _find(jstate, "ScaleByRssState").sum_of_squares,
                     what="sum_of_squares")


@pytest.mark.parametrize("moment_dtype", ["f32", "bf16"])
def test_adafactor_state_and_decay_chain_follow_optax(moment_dtype):
    """Factored row/column moments for the wide leaf, full moments for the
    rest, the momentum in ``moment_dtype``, and the chained decoupled
    decay (``weight_decay`` > 0 adds the DecoupledDecay part)."""
    for jparams, jstate, state in _run(dict(opt="adafactor",
                                            moment_dtype=moment_dtype)):
        fact = _find(jstate, "FactoredState")
        mine = _part(state, topt.ScaleByFactoredRms)
        for field in ("v_row", "v_col", "v"):
            _assert_tree(_named(state, mine[field]), getattr(fact, field),
                         what=field)
        names = list(state.params)
        wide = names.index("wide.w")
        assert mine["v_row"][wide].shape == (130,)
        assert mine["v_col"][wide].shape == (140,)
        assert mine["v"][wide].shape == (1,)
        ema = _part(state, topt.Ema)["ema"]
        want_dtype = torch.bfloat16 if moment_dtype == "bf16" \
            else torch.float32
        assert all(e.dtype == want_dtype for e in ema)
        _assert_tree(_named(state, ema), _find(jstate, "EmaState").ema,
                     BF16_TOL if moment_dtype == "bf16" else TOL, "ema")
        _assert_tree(state.params, jparams,
                     dict(atol=1e-6, rtol=1e-4) if moment_dtype == "bf16"
                     else TOL, "params")
    assert any(isinstance(p, topt.DecoupledDecay) for p in state.tx.parts)
    no_decay = topt.build_optimizer(TConfig(model="vivit", opt="adafactor",
                                            weight_decay=0.0))
    assert not any(isinstance(p, topt.DecoupledDecay)
                   for p in no_decay.parts)


def test_clip_leaves_small_gradients_alone():
    """Below the threshold the clipped chain equals the unclipped one."""
    a = [s.params for *_, s in _run(dict(opt="sgd", grad_clip_norm=1e3),
                                    grad_scale=1e-2)][-1]
    b = [s.params for *_, s in _run(dict(opt="sgd"), grad_scale=1e-2)][-1]
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("steps_per_epoch", [1, 7])
def test_linear_warmup_cosine_matches_jax(steps_per_epoch):
    js = jopt.linear_warmup_cosine(3e-3, 5, 50, steps_per_epoch, 1e-5)
    ts = topt.linear_warmup_cosine(3e-3, 5, 50, steps_per_epoch, 1e-5)
    for count in (0, 1, 4 * steps_per_epoch, 5 * steps_per_epoch,
                  20 * steps_per_epoch, 50 * steps_per_epoch,
                  60 * steps_per_epoch):
        np.testing.assert_allclose(ts(count), float(js(count)), atol=1e-10,
                                   rtol=1e-5, err_msg=str(count))


def test_schedule_drives_the_contrastive_learning_rate():
    """``scheduling`` with the contrastive model puts the schedule into
    the chain, evaluated at the count of updates so far, as optax does."""
    kw = dict(model="contrastive", opt="adamW", scheduling=True, epochs=20,
              learning_rate=1e-2)
    jtx = jopt.build_optimizer(JConfig(**kw), steps_per_epoch=2)
    ttx = topt.build_optimizer(TConfig(**kw), steps_per_epoch=2)
    jparams = jax.tree_util.tree_map(jnp.asarray, _tree(0))
    jstate = jtx.init(jparams)
    state = TrainState.create(
        {k: v.clone() for k, v in jax_to_state_dict(_tree(0)).items()}, ttx)
    for i in range(STEPS):
        grads = _tree(30 + i)
        updates, jstate = jtx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
        # JAX dispatches asynchronously: finish its update before the
        # port's runs, so that the two never compute side by side
        jax.block_until_ready((jparams, jstate))
        state = state.apply_gradients(jax_to_state_dict(grads))
    _assert_tree(state.params, jparams)
    # the first update ran at lr(0) = 0: it must have moved nothing
    first = next(iter(_run(dict(opt="adamW"))))[2]
    assert first.step == 1


def test_unknown_optimiser_raises_like_jax():
    with pytest.raises(ValueError, match="unknown optimiser"):
        jopt.build_optimizer(JConfig(model="vivit", opt="lion"))
    with pytest.raises(ValueError, match="unknown optimiser"):
        topt.build_optimizer(TConfig(model="vivit", opt="lion"))
