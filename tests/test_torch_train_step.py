"""The port's ViViT training step against the JAX package's, on the CPU.

A tiny ViViT (image 32, patch 8, 4 frames, dim 32, 2 heads × 16, depth 2;
17 space tokens pad to 32, so the space blocks take the fused path) with
the same weights in both packages (``utils.jax_bridge``).  JAX runs with
``attention_impl="fused_interpret"`` — the Pallas kernels in interpret
mode — and the port with ``"auto"``, which on the CPU is the kernels'
plain versions behind ``FusedViTBlock``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu.config import Config as JConfig
from devt_tpu.models import vivit as jv
from devt_tpu.parallel import train_step as jts
from devt_tpu.train import optimizers as jopt
from devt_tpu.train import steps as jsteps
from devt_tpu.train.state import TrainState as JTrainState
from devt_tpu_torch.config import Config as TConfig
from devt_tpu_torch.models import vivit as tv
from devt_tpu_torch.models.layers import DropoutRng
from devt_tpu_torch.parallel import train_step as tts
from devt_tpu_torch.train import optimizers as topt
from devt_tpu_torch.train import steps as tsteps
from devt_tpu_torch.train.state import TrainState
from devt_tpu_torch.utils.jax_bridge import jax_to_state_dict

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

KW = dict(image_size=32, patch_size=8, num_classes=5, num_frames=4, dim=32,
          depth=2, heads=2, dim_head=16, channels_last=True)
CFG = dict(model="vivit", precision="f32", opt="adamW", learning_rate=1e-3,
           weight_decay=0.09, n_classes=5, frame_len=4)
# f32, 2 fused + 2 unfused blocks, sums in other orders: the JAX package's
# own forward bound, and its backward bound for gradients
FWD_TOL = dict(atol=2e-5, rtol=2e-4)
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)
# parameters after 4 AdamW steps of size 1e-3: Adam divides the gradient
# by its own magnitude, so a gradient off by GRAD_TOL moves a step by up
# to that share of 1e-3 where the gradient is small against its noise
TRAJ_TOL = dict(atol=2e-5, rtol=5e-4)


def _batch(b=4, seed=0, labels="multi_hot", wire="vid"):
    rng = np.random.default_rng(seed)
    if wire == "u8":
        batch = {"vid": rng.integers(0, 256, (b, 4, 32, 32, 3),
                                     dtype=np.uint8)}
    elif wire == "vid_tokens":
        batch = {"vid_tokens": rng.standard_normal((b, 4, 16, 192))
                 .astype(np.float32)}
    else:
        batch = {"vid": rng.standard_normal((b, 4, 32, 32, 3))
                 .astype(np.float32)}
    if labels == "multi_hot":
        batch["label"] = (rng.random((b, 5)) < 0.3).astype(np.float32)
    else:
        batch["label"] = rng.integers(0, 5, b).astype(np.int32)
    return batch


def _pair(dropout=0.0, **cfg_kw):
    """(jax model, jax params, jax config), (torch model, torch config)
    with the same weights."""
    jm = jv.ViViT(attention_impl="fused_interpret", dropout=dropout, **KW)
    v = jm.init({"params": jax.random.PRNGKey(0)},
                jnp.zeros((1, 4, 32, 32, 3)))
    tm = tv.ViViT(attention_impl="auto", dropout=dropout, **KW)
    tm.load_state_dict(jax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, v)))
    kw = {**CFG, **cfg_kw}
    return (jm, v["params"], JConfig(**kw)), (tm, TConfig(**kw))


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tstate(tm, tcfg):
    return TrainState.create(dict(tm.named_parameters()),
                             topt.build_optimizer(tcfg))


def _assert_params(state: TrainState, jparams, tol, what=""):
    want = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(want) == set(state.params)
    for k, w in want.items():
        np.testing.assert_allclose(state.params[k].detach().numpy(),
                                   w.numpy(), err_msg=f"{what} {k}", **tol)


@pytest.mark.parametrize("labels,wire", [("multi_hot", "vid"),
                                         ("int", "vid"),
                                         ("multi_hot", "vid_tokens"),
                                         ("multi_hot", "u8")])
def test_loss_probs_and_every_gradient_leaf_match_jax(labels, wire):
    (jm, jparams, jcfg), (tm, tcfg) = _pair()
    batch = _batch(labels=labels, wire=wire)

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
    np.testing.assert_array_equal(aux["label"].numpy(), batch["label"])
    want = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(want) == set(params)          # every leaf
    for (name, _), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_four_step_trajectory_matches_jax():
    (jm, jparams, jcfg), (tm, tcfg) = _pair()
    jstate = JTrainState.create(jparams, jopt.build_optimizer(jcfg))
    jstep = jts.make_train_step(jm, jcfg)
    state = _tstate(tm, tcfg)
    step = tts.make_train_step(tm, tcfg, device="cpu")
    for i in range(4):
        batch = _batch(seed=10 + i)
        jstate, jmetrics = jstep(jstate, _jbatch(batch),
                                 jax.random.PRNGKey(1))
        state, metrics = step(state, batch, 1)
        np.testing.assert_allclose(metrics["loss"].item(),
                                   float(jmetrics["loss"]),
                                   err_msg=f"step {i}", **FWD_TOL)
        _assert_params(state, jstate.params, TRAJ_TOL, f"step {i}")
    assert state.step == int(jstate.step) == 4
    # the optimizer's moments too, through the same bridge
    adam = jstate.opt_state[0]
    mine = state.opt_state[0]
    for field in ("mu", "nu"):
        want = jax_to_state_dict(jax.tree_util.tree_map(
            np.asarray, getattr(adam, field)))
        for name, t in zip(state.params, mine[field]):
            np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                       err_msg=f"{field} {name}",
                                       atol=5e-6, rtol=1e-3)


def test_multi_step_equals_single_steps_and_jax():
    (jm, jparams, jcfg), (tm, tcfg) = _pair()
    batches = [_batch(seed=20 + i) for i in range(4)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}

    single_model = copy.deepcopy(tm)
    single = _tstate(single_model, tcfg)
    step = tts.make_train_step(single_model, tcfg, device="cpu")
    losses = []
    for b in batches:
        single, m = step(single, b, 3)
        losses.append(m["loss"].item())

    state = _tstate(tm, tcfg)
    multi = tts.make_multi_step(tm, tcfg, 4, device="cpu")
    state, metrics = multi(state, stacked, 3)
    assert state.step == 4
    assert metrics["loss"].item() == pytest.approx(np.mean(losses), rel=1e-6)
    for k in state.params:                     # the very same arithmetic
        assert torch.equal(state.params[k], single.params[k]), k

    jstate = JTrainState.create(jparams, jopt.build_optimizer(jcfg))
    jstate, jmetrics = jts.make_multi_step(jm, jcfg, 4)(
        jstate, _jbatch(stacked), jax.random.PRNGKey(3))
    np.testing.assert_allclose(metrics["loss"].item(),
                               float(jmetrics["loss"]), **FWD_TOL)
    _assert_params(state, jstate.params, TRAJ_TOL)


def test_accumulation_matches_jax():
    (jm, jparams, jcfg), (tm, tcfg) = _pair(accum_steps=2)
    batch = _batch(b=4, seed=30)
    jstate = JTrainState.create(jparams, jopt.build_optimizer(jcfg))
    jstate, jmetrics = jts.make_train_step(jm, jcfg)(
        jstate, _jbatch(batch), jax.random.PRNGKey(1))
    state, metrics = tts.make_train_step(tm, tcfg, device="cpu")(
        _tstate(tm, tcfg), batch, 1)
    np.testing.assert_allclose(metrics["loss"].item(),
                               float(jmetrics["loss"]), **FWD_TOL)
    _assert_params(state, jstate.params, TRAJ_TOL)


def test_accumulated_gradient_is_the_mean_of_the_microbatches():
    """accum_steps=2 on 4 clips equals one step on their whole batch, up
    to summation order (BCE is a mean over samples, halves of equal size)."""
    (_, _, _), (tm, tcfg) = _pair(opt="sgd", momentum=0.0, weight_decay=0.0,
                                  learning_rate=1e-1)
    (_, _, _), (tm2, tcfg2) = _pair(opt="sgd", momentum=0.0,
                                    weight_decay=0.0, learning_rate=1e-1,
                                    accum_steps=2)
    batch = _batch(b=4, seed=31)
    whole, m1 = tts.make_train_step(tm, tcfg, device="cpu")(
        _tstate(tm, tcfg), batch, 1)
    accum, m2 = tts.make_train_step(tm2, tcfg2, device="cpu")(
        _tstate(tm2, tcfg2), batch, 1)
    assert m1["loss"].item() == pytest.approx(m2["loss"].item(), rel=1e-5)
    for k in whole.params:
        torch.testing.assert_close(whole.params[k], accum.params[k],
                                   atol=1e-6, rtol=1e-4, msg=k)


def test_split_microbatches():
    batch = {"vid": torch.arange(24.0).reshape(6, 4), "label": torch.ones(6)}
    micro = tts._split_microbatches(batch, 3)
    assert micro["vid"].shape == (3, 2, 4) and micro["label"].shape == (3, 2)
    assert torch.equal(micro["vid"][1], batch["vid"][2:4])
    with pytest.raises(ValueError, match="not divisible"):
        tts._split_microbatches(batch, 4)


@pytest.mark.parametrize("wire", ["vid", "u8"])
def test_eval_step_matches_jax(wire):
    (jm, jparams, jcfg), (tm, tcfg) = _pair()
    batch = _batch(seed=40, wire=wire)
    jstate = JTrainState.create(jparams, jopt.build_optimizer(jcfg))
    jl, jaux = jts.make_eval_step(jm, jcfg)(jstate, _jbatch(batch))
    loss, aux = tts.make_eval_step(tm, tcfg, device="cpu")(
        _tstate(tm, tcfg), batch)
    assert not loss.requires_grad and not tm.training
    np.testing.assert_allclose(loss.item(), float(jl), **FWD_TOL)
    np.testing.assert_allclose(aux["probs"].numpy(),
                               np.asarray(jaux["probs"]), **FWD_TOL)


def test_a_steps_dropout_depends_only_on_seed_and_step():
    """Two runs from equal states draw equal masks; the next step, another
    seed and the eval step (no dropout) all differ from it."""
    def run(seed, steps, dropout=0.25):
        (_, _, _), (tm, tcfg) = _pair(dropout=dropout)
        state = _tstate(tm, tcfg)
        step = tts.make_train_step(tm, tcfg, device="cpu")
        out = []
        for _ in range(steps):
            state, m = step(state, _batch(seed=50), seed)
            out.append(m["loss"].item())
        return out

    a, b, c = run(7, 2), run(7, 2), run(8, 1)
    assert a == b
    assert a[0] != c[0]
    assert a[0] != run(7, 1, dropout=0.0)[0]
    # (seed, step) alone: history is not consulted
    assert tts.step_seed(7, 1) == tts.step_seed(7, 1)
    assert len({tts.step_seed(7, 0), tts.step_seed(7, 1), tts.step_seed(8, 0),
                tts.step_seed(7, 0, 1)}) == 4


def test_dropout_training_runs_the_fused_path_and_needs_an_rng():
    (_, _, _), (tm, _) = _pair(dropout=0.25)
    tm.train()
    padded = torch.zeros(8, 32, 32)
    assert all(b.fused_eligible(padded) for b in tm.space_transformer.blocks)
    with pytest.raises(ValueError, match="DropoutRng"):
        tm(torch.tensor(_batch()["vid"]))
    out = tm(torch.tensor(_batch()["vid"]), rng=DropoutRng(1))
    same = tm(torch.tensor(_batch()["vid"]), rng=DropoutRng(1))
    other = tm(torch.tensor(_batch()["vid"]), rng=DropoutRng(2))
    assert torch.equal(out, same) and not torch.equal(out, other)


def test_state_create_and_apply_gradients():
    (_, _, _), (tm, tcfg) = _pair(opt="sgd", momentum=0.0, weight_decay=0.0,
                                  learning_rate=0.5)
    state = _tstate(tm, tcfg)
    assert state.step == 0 and state.model_state == {}
    before = {k: v.detach().clone() for k, v in state.params.items()}
    grads = {k: torch.ones_like(v) for k, v in state.params.items()}
    new = state.apply_gradients(grads)
    assert new.step == 1 and state.step == 0
    for k, p in tm.named_parameters():         # in place, on the model
        assert new.params[k] is p
        torch.testing.assert_close(p.detach(), before[k] - 0.5)


def test_other_models_and_meshes_raise():
    (_, _, _), (tm, tcfg) = _pair()
    with pytest.raises(ValueError, match="no step logic"):
        tsteps.forward_and_loss(tm, TConfig(model="resnet18"),
                                {"params": {}}, {}, None, train=False)
    # data, FSDP, tensor, pipeline, sequence and expert parallelism are
    # ported (tests/test_torch_dp.py, tests/test_torch_fsdp_tp.py,
    # tests/test_torch_sp_pp_ep.py): a (data, model) mesh, a (data, pipe)
    # mesh and MoE blocks on a model axis make their executors, with JAX's
    # strategy
    from devt_tpu.config import Config as JConfig
    from devt_tpu.parallel import mesh as jmesh
    from devt_tpu.parallel import train_step as jts
    from devt_tpu_torch.parallel.mesh import make_mesh

    square = make_mesh(dp=2, mp=2, devices=range(4))
    assert tts.mesh_strategy(square, tcfg) == "gspmd"
    for make in (tts.make_train_step, tts.make_eval_step):
        assert callable(make(tm, tcfg, mesh=square, device="cpu"))
    mesh = make_mesh(dp=2, pp=2, devices=range(4))
    jcfg = JConfig(**{k: getattr(tcfg, k) for k in ("model", "dropout")})
    assert tts.mesh_strategy(mesh, tcfg) == jts.mesh_strategy(
        jmesh.make_mesh(dp=2, pp=2, devices=jax.devices()[:4]), jcfg) \
        == "pp_shard_map"
    for make in (tts.make_train_step, tts.make_eval_step):
        assert callable(make(tm, tcfg, mesh=mesh, device="cpu"))
    assert callable(tts.make_multi_step(tm, tcfg, 2, mesh=mesh,
                                        device="cpu"))
    assert callable(tts.make_train_step(tm, tcfg.replace(moe_experts=2),
                                        mesh=square, device="cpu"))
    with pytest.raises(ValueError, match="expected 2"):
        tts.make_multi_step(tm, tcfg, 2, device="cpu")(
            _tstate(tm, tcfg), {"vid": np.zeros((3, 1, 4, 32, 32, 3),
                                                np.float32)}, 0)
