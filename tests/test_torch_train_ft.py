"""The port's FrameTransformer training step against the JAX package's, on
the CPU.

``distil`` (every module: both backbones, both encoders, the distil token
and the distillation loss) at the sizes of ``test_torch_frame_transformer
.py`` (``seq_len`` 3, ``frame_len`` 4, image 64, clip 4 x 32 x 32, batch
2), dropout 0, the same numpy-drawn weights and BatchNorm statistics in
both packages (``utils.jax_bridge``).  JAX's step is ``jax.grad`` of its
``forward_and_loss`` and optax's AdamW (weight decay 0.09); the port's is
``forward_and_loss`` with autograd, and ``make_train_step``.

In f32: the loss and aux, and the new BatchNorm statistics, atol 1e-4 /
rtol 1e-3 (the forward bound of ``test_torch_frame_transformer.py``);
every gradient leaf outside the video backbone's chain within 1e-3 of
its largest element.  The video backbone's gradients (and ``vid_cls``'s,
which passes through it) run back through its ReLUs, and there f32
rounding alone moves them: an input within rounding of 0 lands on the
other side of the kink, and that element passes or stops a whole
gradient term.  Against the same step in f64, JAX's f32 gradients differ
by up to 16 % of a leaf's largest element at these shapes, the port's by
up to 0.4 % (``chip_smoke.py`` holds its steps to the f64 step's ReLU
gates to compare them leaf by leaf).  So every leaf, and the parameters
after one AdamW step, are held in f64 on both sides (``jax.enable_x64``): gradients within 1e-5
of the leaf's largest element.  AdamW's step is held against optax given
the same parameters and gradients, every leaf within 1e-5 of the learning
rate (the port takes Adam's bias corrections in f32, as optax does in f32
and not under x64: 1 - 0.999 rounds 1.3e-5 low, which moves a step by
6.4e-6 of itself); its first step g / (|g| + eps) * lr amplifies the rounding of a
gradient within a few eps (1e-8) of 0 by lr / eps, so two packages'
gradients, f64 or not, move such an element by up to a few hundredths of
lr.  The frozen image side has exact-zero gradients in both, and AdamW
moves it by its weight decay alone.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from devt_tpu.config import Config as JConfig
from devt_tpu.models.frame_transformer import FrameTransformer as JFT
from devt_tpu.train import optimizers as jopt
from devt_tpu.train import steps as jsteps
from devt_tpu_torch.config import Config as TConfig
from devt_tpu_torch.models.layers import DropoutRng
from devt_tpu_torch.parallel import train_step as tts
from devt_tpu_torch.train import optimizers as topt
from devt_tpu_torch.train import steps as tsteps
from devt_tpu_torch.train.state import TrainState, model_buffers
from devt_tpu_torch.utils.jax_bridge import (jax_to_state_dict,
                                             state_dict_to_jax)
from test_torch_frame_transformer import SMALL, _inputs, port_model

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

FWD_TOL = dict(atol=1e-4, rtol=1e-3)
GRAD_RTOL = 1e-3
LR = 1e-3
CFG = dict(model="distil", seq_len=3, frame_len=4, n_classes=19,
           precision="f32", opt="adamW", learning_rate=LR, batch_size=2)


def _batch(seed=0, u8=False):
    img, vid = _inputs(seed)
    if u8:
        rng = np.random.default_rng(seed + 100)
        img = rng.integers(0, 256, img.shape, dtype=np.uint8)
        vid = rng.integers(0, 256, vid.shape, dtype=np.uint8)
    label = (np.random.default_rng(seed + 1).random((2, 19)) < 0.3).astype(
        np.float32)
    return {"img": img, "vid": vid, "label": label}


def _model(dtype=torch.float32):
    m = port_model("distil", dropout=0.0, dtype=dtype)
    return m.to(dtype)


def _jax_side(dtype=jnp.float32):
    jm = JFT(model="distil", dropout=0.0, attention_impl="xla", dtype=dtype,
             **SMALL)
    return jm, JConfig(**CFG)


def _variables(tm, dtype=np.float32):
    v = state_dict_to_jax(tm.state_dict())
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), v)


@functools.lru_cache(maxsize=None)
def _jax_step(x64=False):
    """JAX's loss, aux, new batch_stats, gradients and AdamW's parameters
    after one step, from the port's weights, in f32 or f64, keyed like the
    port's state_dict."""
    dt, npt = (jnp.float64, np.float64) if x64 else (jnp.float32, np.float32)
    with jax.enable_x64(x64):
        jm, jcfg = _jax_side(dt)
        v = _variables(_model(), npt)
        batch = {k: jnp.asarray(x, dt) for k, x in _batch().items()}

        def loss_fn(params, stats):
            loss, aux, mut = jsteps.forward_and_loss(
                jm, jcfg, {"params": params, "batch_stats": stats}, batch,
                jax.random.PRNGKey(0), train=True)
            return loss, (aux, mut)

        (loss, (aux, mut)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(v["params"],
                                                       v["batch_stats"])

        def sd(tree):
            return jax_to_state_dict(
                jax.tree_util.tree_map(np.asarray, tree), dtype=npt)

        return (float(loss), {k: np.asarray(x) for k, x in aux.items()},
                sd({"params": v["params"], "batch_stats": mut["batch_stats"]}),
                sd(grads))


def _optax_step(params, grads, jcfg):
    """optax's AdamW step (f64) from the port's parameters and gradients,
    keyed like the port's state_dict."""
    with jax.enable_x64(True):
        tree = functools.partial(state_dict_to_jax, dtype=np.float64)
        p, g = tree(params)["params"], tree(grads)["params"]
        tx = jopt.build_optimizer(jcfg)
        # one compiled update: optax leaf by leaf, eagerly, compiles an op
        # per leaf shape
        new = jax.jit(lambda g, p: optax.apply_updates(
            p, tx.update(g, tx.init(p), p)[0]))(g, p)
        return jax_to_state_dict(jax.tree_util.tree_map(np.asarray, new),
                                 dtype=np.float64)


def _tbatch(batch, dtype=torch.float32):
    return {k: torch.from_numpy(x).to(dtype) if x.dtype == np.float32
            else torch.from_numpy(x) for k, x in batch.items()}


def _frozen(name):
    return name.startswith(("img_backbone.", "img_fc.", "img_cls"))


def _port_grads(tm, tcfg, dtype=torch.float32):
    params = dict(tm.named_parameters())
    loss, aux, new_ms = tsteps.forward_and_loss(
        tm, tcfg, {"params": params, **model_buffers(tm)},
        _tbatch(_batch(), dtype), DropoutRng(0), train=True)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return loss, aux, new_ms, dict(zip(params, grads))


def _assert_grad(k, g, want, rtol):
    if _frozen(k):
        assert g is None and not want.any(), k   # jax.grad's zeros
        return
    err = np.abs(g.numpy() - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-6), (k, err)


def test_distil_step_loss_aux_stats_and_gradients_match_jax_f32():
    jl, jaux, jstate, jgrads = _jax_step()
    tm, tcfg = _model(), TConfig(**CFG)
    loss, aux, new_ms, grads = _port_grads(tm, tcfg)
    np.testing.assert_allclose(loss.item(), jl, **FWD_TOL)
    assert set(aux) == set(jaux) == {"probs", "label", "embedding",
                                     "base_loss", "distil_loss", "cossim"}
    for k in aux:
        np.testing.assert_allclose(aux[k].detach().numpy(), jaux[k],
                                   err_msg=k, **FWD_TOL)
    # the video backbone's statistics moved, the image backbone's did not
    assert set(new_ms) == set(model_buffers(tm))
    before = model_buffers(tm)
    for k, v in new_ms.items():
        np.testing.assert_allclose(v.numpy(), jstate[k].numpy(), err_msg=k,
                                   **FWD_TOL)
        moved = not torch.equal(v, before[k])
        assert moved == k.startswith("vid_backbone."), k
    assert set(jgrads) == set(grads)             # every leaf
    for k, g in grads.items():
        if not k.startswith(("vid_backbone.", "vid_cls")):
            _assert_grad(k, g, jgrads[k].numpy(), GRAD_RTOL)


def test_distil_step_every_gradient_leaf_matches_jax_f64():
    jl, _, _, jgrads = _jax_step(x64=True)
    tm = _model(torch.float64)
    loss, _, _, grads = _port_grads(tm, TConfig(**CFG), torch.float64)
    np.testing.assert_allclose(loss.item(), jl, rtol=1e-10)
    assert set(jgrads) == set(grads)
    for k, g in grads.items():
        _assert_grad(k, g, jgrads[k].numpy(), 1e-5)


def test_distil_adamw_step_matches_optax_on_every_leaf():
    """``make_train_step`` in f64 against optax's AdamW given the same
    parameters and gradients (the port's, which the f64 test holds against
    JAX's): every leaf, the frozen image leaves moved by the decay alone;
    and the BatchNorm buffers JAX's step leaves, carried into the state in
    place (the model's own)."""
    jl, _, jstate, _ = _jax_step(x64=True)
    tm, tcfg = _model(torch.float64), TConfig(**CFG)
    _, _, _, grads = _port_grads(tm, tcfg, torch.float64)
    old = {k: p.detach().clone() for k, p in tm.named_parameters()}
    want = _optax_step(old, {k: torch.zeros_like(old[k]) if g is None else g
                             for k, g in grads.items()}, JConfig(**CFG))
    buffers = model_buffers(tm)
    state = TrainState.create(dict(tm.named_parameters()),
                              topt.build_optimizer(tcfg),
                              model_state=buffers)
    state, metrics = tts.make_train_step(tm, tcfg, device="cpu")(
        state, _tbatch(_batch(), torch.float64), 0)
    np.testing.assert_allclose(metrics["loss"].item(), jl, rtol=1e-10)
    assert {"base_loss", "distil_loss", "cossim"} <= set(metrics)
    assert set(state.params) == set(want)
    for k, p in state.params.items():
        got = p.detach().numpy()
        if _frozen(k):
            np.testing.assert_allclose(got, old[k].numpy() * (1 - LR * 0.09),
                                       rtol=1e-12, err_msg=k)
        np.testing.assert_allclose(got, want[k].numpy(), atol=1e-5 * LR,
                                   rtol=0, err_msg=k)
    for k, b in state.model_state.items():
        assert b is buffers[k] and b is tm.state_dict(keep_vars=True)[k]
        np.testing.assert_allclose(b.numpy(), jstate[k].numpy(), rtol=1e-8,
                                   atol=1e-12, err_msg=k)


def test_u8_wire_matches_jax():
    """uint8 ``img`` and ``vid`` normalized on the device side of the step
    (ImageNet and Kinetics statistics), against JAX's evaluation step on
    the same bytes."""
    jm, jcfg = _jax_side()
    tm, tcfg = _model(), TConfig(**CFG)
    batch = _batch(seed=3, u8=True)
    jl, jaux, _ = jax.jit(lambda v, b: jsteps.forward_and_loss(
        jm, jcfg, v, b, None, train=False))(
        _variables(tm), {k: jnp.asarray(x) for k, x in batch.items()})
    with torch.no_grad():
        loss, aux, ms = tsteps.forward_and_loss(
            tm, tcfg, {"params": dict(tm.named_parameters()),
                       **model_buffers(tm)}, _tbatch(batch), None,
            train=False)
    np.testing.assert_allclose(loss.item(), float(jl), **FWD_TOL)
    np.testing.assert_allclose(aux["probs"].numpy(), np.asarray(jaux["probs"]),
                               **FWD_TOL)
    assert all(ms[k] is v for k, v in model_buffers(tm).items())


def test_accumulated_microbatches_carry_the_batch_statistics():
    """Under ``accum_steps`` 2 the second microbatch normalises its running
    averages from the first one's update, as the JAX scan carries them:
    the state ends where two chained ``forward_and_loss`` calls end.  A
    state created without the buffers refuses the step's update."""
    tm, tcfg = _model(), TConfig(**{**CFG, "accum_steps": 2})
    batch = _batch(seed=5)
    micro = [{k: torch.from_numpy(v[i:i + 1]) for k, v in batch.items()}
             for i in range(2)]
    ms = model_buffers(tm)
    params = dict(tm.named_parameters())
    with torch.no_grad():
        for mb in micro:
            _, _, ms = tsteps.forward_and_loss(
                tm, tcfg, {"params": params, **ms}, mb, DropoutRng(0),
                train=True)
    want = {k: v.clone() for k, v in ms.items()}
    state = TrainState.create(params, topt.build_optimizer(tcfg),
                              model_state=model_buffers(tm))
    state, _ = tts.make_train_step(tm, tcfg, device="cpu")(state, batch, 0)
    for k, v in want.items():
        torch.testing.assert_close(state.model_state[k], v, rtol=1e-6,
                                   atol=1e-7, msg=k)
    # a state made without the model's buffers cannot take their update
    bare = TrainState.create(params, topt.build_optimizer(tcfg))
    with pytest.raises(KeyError, match="model_buffers"):
        tts.make_train_step(tm, TConfig(**CFG), device="cpu")(
            bare, _batch(seed=6), 0)
