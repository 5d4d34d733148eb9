"""The port's single-device switch MoE against the JAX package's, on the CPU.

``parallel/moe.py`` (routing, the dense dispatch/combine execution with
pad masks and per-row groups), ``MoEViTBlock`` in both branches (the
fused attention half, which on the CPU is kernel 7's and 8's plain
versions, and the unfused one), a tiny MoE-ViViT's logits, the training
loss with the router's load-balance term and every gradient leaf, a
4-step AdamW trajectory, the Predictor in the model dtype and with int8
blocks, and the weight bridge's round trip of the expert leaves.  JAX runs
its Pallas kernels in interpret mode (``attention_impl="fused_interpret"``)
and the port the plain versions behind the same wrappers that launch the
CUDA kernels on the card (``"auto"``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu.config import Config as JConfig
from devt_tpu.models import layers as jl
from devt_tpu.models import vivit as jv
from devt_tpu.parallel import moe as jmoe
from devt_tpu.parallel import train_step as jts
from devt_tpu.serve import Predictor as JPredictor
from devt_tpu.train import optimizers as jopt
from devt_tpu.train import steps as jsteps
from devt_tpu.train.state import TrainState as JTrainState
from devt_tpu_torch.config import Config as TConfig
from devt_tpu_torch.models import layers as tl
from devt_tpu_torch.models import vivit as tv
from devt_tpu_torch.models.layers import DropoutRng
from devt_tpu_torch.parallel import moe as tmoe
from devt_tpu_torch.parallel import train_step as tts
from devt_tpu_torch.registry import build_model as tbuild
from devt_tpu_torch.serve import Predictor
from devt_tpu_torch.train import optimizers as topt
from devt_tpu_torch.train import steps as tsteps
from devt_tpu_torch.train.state import TrainState
from devt_tpu_torch.utils.jax_bridge import (jax_to_state_dict,
                                             state_dict_to_jax)

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

DIM, HEADS, DIM_HEAD, MLP, E = 32, 2, 16, 64, 4
S, KV_LEN = 16, 13
# f32: the JAX package's own forward and backward bounds
# (tests/test_fused_block.py), as in tests/test_torch_train_step.py
FWD_TOL = dict(atol=2e-5, rtol=2e-4)
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)
TRAJ_TOL = dict(atol=2e-5, rtol=5e-4)
AUX_TOL = dict(rtol=1e-5)
# the router's gate: the two libraries' f32 exp and sums may differ in the
# last bit, which the gate carries into combine
GATE_TOL = dict(atol=0, rtol=1e-6)
# bf16 expert products: both sides round the einsums' outputs to bf16, but
# sum in other orders (and XLA may keep an intermediate in f32), so an
# element next to a rounding boundary lands on either side; through the
# GELU and the second product that is a few bf16 ulps (2^-7 each) of the
# largest output
BF16_TOL = dict(atol=4 * 2.0 ** -7, rtol=2 * 2.0 ** -7)
# Predictor scores: f32 within the forward bound; int8 within the 2e-2 of
# tests/test_torch_serve_quant.py (an int8 code that flips between two
# summation orders)
INT8_TOL = dict(atol=2e-2, rtol=0)

VIVIT = dict(image_size=32, patch_size=8, num_classes=5, num_frames=4,
             dim=DIM, depth=2, heads=HEADS, dim_head=DIM_HEAD,
             channels_last=True, moe_experts=E)
CFG = dict(model="vivit", precision="f32", opt="adamW", learning_rate=1e-3,
           weight_decay=0.09, n_classes=5, frame_len=4, moe_experts=E)


def _np_tree(v):
    return jax.tree_util.tree_map(np.asarray, v)


def _tokens(t=24, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, DIM)) * scale).astype(np.float32)


def _moe_params(seed=1):
    """Expert params drawn with numpy; the router wide enough that the
    tokens spread over the experts and some queues overflow."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"router": t(DIM, E, scale=0.5), "w1": t(E, DIM, MLP, scale=0.2),
            "b1": t(E, MLP, scale=0.1), "w2": t(E, MLP, DIM, scale=0.2),
            "b2": t(E, DIM, scale=0.1)}


def _valid(t, group, kv_len):
    """(t,) bool: the first kv_len tokens of each group of ``group``."""
    return np.tile(np.arange(group) < kv_len, t // group)


@pytest.mark.parametrize("masked", [False, True])
def test_switch_route_matches_jax(masked):
    x = _tokens()
    p = _moe_params()
    valid = _valid(24, 24, 19) if masked else None
    capacity = 4                 # 24 tokens over 4 experts: some overflow
    jd, jc, jaux = jmoe.switch_route(
        jnp.asarray(x), jnp.asarray(p["router"]), E, capacity,
        valid=None if valid is None else jnp.asarray(valid))
    td, tc, taux = tmoe.switch_route(
        torch.tensor(x), torch.tensor(p["router"]), E, capacity,
        valid=None if valid is None else torch.tensor(valid))
    assert td.shape == (24, E, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **GATE_TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **AUX_TOL)
    # queues overflowed, and pads took no slot
    assert td.sum() < (24 if valid is None else valid.sum())
    if masked:
        assert td[~torch.tensor(valid)].sum() == 0


@pytest.mark.parametrize("valid,group", [(False, None), (True, None),
                                         (False, 8), (True, 8)])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_moe_ffn_dense_matches_jax(kind, valid, group):
    jdtype, tdtype = {"f32": (jnp.float32, torch.float32),
                      "bf16": (jnp.bfloat16, torch.bfloat16)}[kind]
    x = _tokens(seed=3)
    p = _moe_params(seed=4)
    v = _valid(24, group or 24, (group or 24) - 3) if valid else None
    jy, jaux = jmoe.moe_ffn_dense(
        {k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x, jdtype),
        capacity_factor=1.25,
        valid=None if v is None else jnp.asarray(v), group_size=group)
    ty, taux = tmoe.moe_ffn_dense(
        {k: torch.tensor(a) for k, a in p.items()},
        torch.tensor(x).to(tdtype), capacity_factor=1.25,
        valid=None if v is None else torch.tensor(v), group_size=group)
    assert ty.dtype == tdtype and ty.shape == (24, DIM)
    tol = FWD_TOL if kind == "f32" else BF16_TOL
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), **tol)
    np.testing.assert_allclose(taux.item(), float(jaux), **AUX_TOL)


def test_capacity_counts_the_pads():
    """Capacity is max(int(t / E * factor), 1) of the group size with its
    pads: 65 slots for ViViT's 208-token rows in training, 104 in eval."""
    x = torch.zeros(208, 8)
    router = torch.zeros(8, 4)
    for factor, slots in ((1.25, 65), (2.0, 104)):
        cap = max(int(208 / 4 * factor), 1)
        d, _, _ = tmoe.switch_route(x, router, 4, cap)
        assert d.shape == (208, 4, slots)


@functools.lru_cache(maxsize=None)
def _jax_block(impl, dropout):
    """The JAX block and its variables, made once per branch."""
    jb = jl.MoEViTBlock(attention_impl="fused_interpret"
                        if impl == "auto" else impl, **_block_kw(dropout))
    x = (np.random.default_rng(5).standard_normal((3, S, DIM)) * 0.5) \
        .astype(np.float32)
    v = jax.jit(jb.init)({"params": jax.random.PRNGKey(1)}, jnp.asarray(x))
    return jb, _np_tree(v), x


def _block_kw(dropout):
    return dict(dim=DIM, heads=HEADS, dim_head=DIM_HEAD, mlp_dim=MLP,
                n_experts=E, capacity_factor=1.25, dropout=dropout)


def _block_pair(impl, dropout=0.0):
    """The JAX block, its params, a fresh port block with the same
    weights, and an input."""
    jb, v, x = _jax_block(impl, dropout)
    tb = tl.MoEViTBlock(attention_impl=impl, **_block_kw(dropout))
    tb.load_state_dict(jax_to_state_dict(v))
    return jb, v["params"], tb, x


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_moe_block_matches_jax(impl, train):
    """Forward, the load-balance loss and every gradient of the block, in
    both branches: the fused attention half and the unfused modules."""
    jb, jparams, tb, x = _block_pair(impl)

    def jrun(params, xin):
        y, state = jb.apply({"params": params}, xin, not train, KV_LEN,
                            mutable=["losses"])
        aux = jax.tree_util.tree_leaves(state["losses"])
        return y, sum(aux)

    def jloss(params, xin):
        y, aux = jrun(params, xin)
        return jnp.sum(y[:, :KV_LEN] ** 2) + 0.01 * aux, (y, aux)

    (_, (jy, jaux)), (jg, jdx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jparams, jnp.asarray(x))

    tb.train(train)
    assert tb.fused_half_eligible(torch.tensor(x)) == (impl == "auto")
    tx = torch.tensor(x, requires_grad=True)
    losses: list = []
    y = tb(tx, KV_LEN, None, losses)
    assert len(losses) == 1
    (torch.sum(y[:, :KV_LEN] ** 2) + 0.01 * losses[0]).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **FWD_TOL)
    np.testing.assert_allclose(losses[0].item(), float(jaux), **AUX_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **GRAD_TOL)
    want = jax_to_state_dict(_np_tree(jg))
    params = dict(tb.named_parameters())
    assert set(want) == set(params)
    for name, t in params.items():
        np.testing.assert_allclose(t.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_moe_block_with_dropout_trains_unfused(monkeypatch):
    """The fused attention half has no dropout: a training forward at
    dropout > 0 takes the unfused branch, evaluation the fused one."""
    tb = tl.MoEViTBlock(**_block_kw(0.1))
    tl.init_weights(tb, torch.Generator().manual_seed(0))
    x = np.random.default_rng(5).standard_normal((3, S, DIM)) \
        .astype(np.float32)
    calls = []
    real = tl.fused_attn_half
    monkeypatch.setattr(tl, "fused_attn_half",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tb.train(True)
    tb(torch.tensor(x), KV_LEN, DropoutRng(0))
    assert calls == []
    tb.eval()
    tb(torch.tensor(x), KV_LEN)
    assert calls == [1]


@pytest.mark.parametrize("every,moe_at", [(2, [1, 3]), (3, [2]), (1, [0, 1, 2, 3])])
def test_transformer_interleaves_moe_blocks(every, moe_at):
    """Block i is an MoE block when i % moe_every == moe_every - 1, as
    devt_tpu/models/layers.py:744 lays them out."""
    m = tl.ViTTransformer(DIM, 4, HEADS, DIM_HEAD, MLP, moe_experts=E,
                          moe_every=every)
    got = [i for i, b in enumerate(m.blocks)
           if isinstance(b, tl.MoEViTBlock)]
    assert got == moe_at


def test_init_draws_flax_distributions():
    """Router normal(0.01); expert kernels lecun-normal with the expert
    axis in the fan-in (std 1/sqrt(D·E), as flax's lecun_normal on an
    (E, D, F) kernel); zero biases."""
    m = tv.ViViT(num_classes=19, num_frames=2, dim=192, depth=2, heads=3,
                 dim_head=64, channels_last=True, moe_experts=4) \
        .init_weights(torch.Generator().manual_seed(0))
    blk = m.space_transformer.blocks[1]
    assert isinstance(blk, tl.MoEViTBlock)
    assert not any(isinstance(b, tl.MoEViTBlock)
                   for b in m.temporal_transformer.blocks)
    np.testing.assert_allclose(blk.moe_w1.std().item(), (192 * 4) ** -0.5,
                               rtol=0.02)
    np.testing.assert_allclose(blk.moe_w2.std().item(), (768 * 4) ** -0.5,
                               rtol=0.02)
    np.testing.assert_allclose(blk.moe_router.std().item(), 0.01, rtol=0.1)
    assert blk.moe_b1.abs().max() == 0 and blk.moe_b2.abs().max() == 0


@pytest.fixture(scope="module")
def vivit():
    """The tiny MoE-ViViT in JAX (its variables) and a fresh port model
    with the same weights for each test."""
    jm = jv.ViViT(attention_impl="fused_interpret", **VIVIT)
    v = _np_tree(jax.jit(jm.init)({"params": jax.random.PRNGKey(0)},
                                  jnp.zeros((1, 4, 32, 32, 3))))

    def port():
        tm = tv.ViViT(attention_impl="auto", **VIVIT)
        tm.load_state_dict(jax_to_state_dict(v))
        return tm

    return jm, v["params"], port


def _batch(b=4, seed=0):
    rng = np.random.default_rng(seed)
    return {"vid": rng.standard_normal((b, 4, 32, 32, 3)).astype(np.float32),
            "label": (rng.random((b, 5)) < 0.3).astype(np.float32)}


def test_tiny_moe_vivit_logits_match_jax(vivit):
    jm, jparams, port = vivit
    x = _batch()["vid"]
    want = jax.jit(lambda p, xin: jm.apply({"params": p}, xin))(
        jparams, jnp.asarray(x))
    got = port().eval()(torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)


def test_loss_moe_aux_and_every_gradient_leaf_match_jax(vivit):
    jm, jparams, port = vivit
    tm = port()
    jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
    batch = _batch(seed=1)

    def jloss(p):
        loss, aux, _ = jsteps.forward_and_loss(
            jm, jcfg, {"params": p},
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0), train=True)
        return loss, aux

    (jl_, jaux), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jparams)
    params = dict(tm.named_parameters())
    loss, aux, _ = tsteps.forward_and_loss(
        tm, tcfg, {"params": params},
        {k: torch.tensor(v) for k, v in batch.items()}, DropoutRng(0),
        train=True)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert set(aux) == {"probs", "label", "moe_aux"}
    np.testing.assert_allclose(loss.item(), float(jl_), **FWD_TOL)
    np.testing.assert_allclose(aux["moe_aux"].item(), float(jaux["moe_aux"]),
                               **AUX_TOL)
    want = jax_to_state_dict(_np_tree(jgrads))
    assert set(want) == set(params)          # every leaf, the experts' too
    for (name, _), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    # the aux term is in the loss, weighted by moe_aux_weight
    plain, _, _ = tsteps.forward_and_loss(
        tm, TConfig(**{**CFG, "moe_aux_weight": 0.0}), {"params": params},
        {k: torch.tensor(v) for k, v in batch.items()}, DropoutRng(0),
        train=True)
    np.testing.assert_allclose(loss.item() - plain.item(),
                               0.01 * aux["moe_aux"].item(), rtol=1e-4)


def test_eval_reports_no_moe_aux(vivit):
    tm = vivit[2]()
    params = dict(tm.named_parameters())
    _, aux, _ = tsteps.forward_and_loss(
        tm, TConfig(**CFG), {"params": params},
        {k: torch.tensor(v) for k, v in _batch().items()}, None, train=False)
    assert set(aux) == {"probs", "label"}


def test_four_step_trajectory_matches_jax(vivit):
    jm, jparams, port = vivit
    tm = port()
    jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
    jstate = JTrainState.create(jparams, jopt.build_optimizer(jcfg))
    jstep = jts.make_train_step(jm, jcfg)
    state = TrainState.create(dict(tm.named_parameters()),
                              topt.build_optimizer(tcfg))
    step = tts.make_train_step(tm, tcfg, device="cpu")
    for i in range(4):
        batch = _batch(seed=10 + i)
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()},
                                 jax.random.PRNGKey(1))
        state, metrics = step(state, batch, 1)
        np.testing.assert_allclose(metrics["loss"].item(),
                                   float(jmetrics["loss"]), **FWD_TOL)
        np.testing.assert_allclose(metrics["moe_aux"].item(),
                                   float(jmetrics["moe_aux"]), **AUX_TOL)
    want = jax_to_state_dict(_np_tree(jstate.params))
    for k, w in want.items():
        np.testing.assert_allclose(state.params[k].detach().numpy(),
                                   w.numpy(), err_msg=k, **TRAJ_TOL)


@pytest.fixture(scope="module")
def served():
    """MoE-ViViT at registry width with 2 frames, the same weights in
    both packages (drawn by the port, carried over by the bridge)."""
    kw = dict(model="vivit", frame_len=2, n_classes=19, precision="f32",
              dropout=0.0, moe_experts=E, attention_impl="fused_interpret")
    tcfg = TConfig(**kw)
    sd = tbuild(tcfg, torch.Generator().manual_seed(0)).state_dict()
    clips = np.random.default_rng(0).integers(
        0, 256, (2, 2, 224, 224, 3), dtype=np.uint8)
    return JConfig(**kw), sd, tcfg, clips


@pytest.mark.parametrize("quantize", [False, True])
def test_predictor_scores_match_jax(served, quantize):
    """The dense blocks go int8 under quantize=True, the MoE blocks keep
    the attention half and the expert products in the model dtype."""
    jcfg, sd, tcfg, clips = served
    want = JPredictor(jcfg, state_dict_to_jax(sd), buckets=(2,),
                      quantize=quantize).predict({"vid": clips})["scores"]
    pred = Predictor(tcfg, sd, buckets=(2,), device="cpu", quantize=quantize)
    got = pred.predict({"vid": clips})["scores"]
    assert got.shape == (2, 19)
    np.testing.assert_allclose(got, want, **(INT8_TOL if quantize
                                             else FWD_TOL))


def test_bridge_round_trip_carries_the_expert_leaves(vivit):
    """moe_router (D, E), moe_w1 (E, D, F), moe_b1 (E, F), moe_w2 (E, F,
    D), moe_b2 (E, D): the same names and layout on both sides, not
    transposed, and back unchanged."""
    tree = {"params": vivit[1]}
    sd = jax_to_state_dict(tree)
    blk = tree["params"]["space_transformer"]["block_1"]
    for name, shape in (("moe_router", (DIM, E)), ("moe_w1", (E, DIM, 128)),
                        ("moe_b1", (E, 128)), ("moe_w2", (E, 128, DIM)),
                        ("moe_b2", (E, DIM))):
        got = sd[f"space_transformer.blocks.1.{name}"].numpy()
        assert got.shape == shape, name
        np.testing.assert_array_equal(got, blk[name])
    assert set(sd) == set(tv.ViViT(attention_impl="auto", **VIVIT)
                          .state_dict())
    back = state_dict_to_jax(sd)
    flat_in = dict(jax.tree_util.tree_leaves_with_path(tree))
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(flat_in) == set(flat_out)
    for path, leaf in flat_in.items():
        np.testing.assert_array_equal(flat_out[path], leaf)
