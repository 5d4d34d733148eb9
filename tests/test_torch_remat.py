"""``remat=True`` on the CPU: the rematerialised training step against the
plain one and against the JAX package's.

The port's counterpart of ``tests/test_training.py``'s remat test.  Each
ViT block (``ViTTransformer``) and encoder layer (``TorchTransformerEncoder``)
runs under ``models.layers.remat``: non-reentrant ``torch.utils.checkpoint``
that replays the forward's dropout draws from a snapshot of the
``DropoutRng``.  The recompute does the forward's arithmetic on the same
inputs, so the loss is the plain step's bit for bit; the gradients are the
same operations on the same tensors, held to rtol 1e-5, atol 1e-7 (JAX's
own remat test's bound).  Against JAX's remat step (``attention_impl=
"xla"`` on both sides, ViViT): f32 sums in other orders, 1e-5 on the
loss.
"""

import copy
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu.config import Config as JConfig
from devt_tpu.parallel.train_step import make_train_step as jmake_train_step
from devt_tpu.registry import build_model as jbuild
from devt_tpu.train.optimizers import build_optimizer as jbuild_optimizer
from devt_tpu.train.state import TrainState as JTrainState
from devt_tpu_torch import registry as treg
from devt_tpu_torch.config import Config
from devt_tpu_torch.models import layers as tl
from devt_tpu_torch.models import vivit as tv
from devt_tpu_torch.models.torch_encoder import TorchTransformerEncoder
from devt_tpu_torch.ops.attention import active_tp_mesh, tp_pallas_scope
from devt_tpu_torch.parallel import collectives, moe
from devt_tpu_torch.parallel.train_step import make_train_step
from devt_tpu_torch.train.optimizers import build_optimizer
from devt_tpu_torch.train.state import TrainState
from devt_tpu_torch.utils.jax_bridge import jax_to_state_dict

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

# tests/test_training.py:test_remat_step_matches_and_routes's model
VIVIT = dict(image_size=32, num_classes=5, num_frames=2, dim=16, depth=2,
             heads=2, dim_head=8, channels_last=True)
CFG = dict(model="vivit", batch_size=4, frame_len=2, n_classes=5,
           opt="adamW", learning_rate=1e-3, precision="f32")
PTN = dict(model="ptn", batch_size=3, seq_len=3, nlayers=2, nhid=64,
           input_dimension=64, nhead=4, n_classes=15, precision="f32",
           opt="adamW", learning_rate=1e-3, attention_impl="pallas",
           experts=("a", "b"))
PARAM_TOL = dict(rtol=1e-5, atol=1e-7)
JAX_LOSS_TOL = dict(rtol=0, atol=1e-5)


def _batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"vid": rng.standard_normal((4, 2, 32, 32, 3), dtype=np.float32),
            "label": (rng.random((4, 5)) < 0.4).astype(np.float32)}


def _vivit(remat: bool, weights: dict, **kw):
    model = tv.ViViT(remat=remat, **VIVIT, **kw)
    model.load_state_dict(weights)
    return model


def _steps(model, cfg, batches, seed=3):
    """Train steps from ``batches``; returns (losses, params, the space
    blocks' calls a step)."""
    calls = []
    hooks = [b.register_forward_pre_hook(lambda *_: calls.append(1))
             for b in model.space_transformer.blocks]
    state = TrainState.create(dict(model.named_parameters()),
                              build_optimizer(cfg))
    step = make_train_step(model, cfg, device="cpu")
    losses, per_step = [], []
    for batch in batches:
        calls.clear()
        state, metrics = step(state, batch, seed)
        losses.append(metrics["loss"].item())
        per_step.append(len(calls))
    for h in hooks:
        h.remove()
    return losses, {k: v.detach().clone() for k, v in state.params.items()}, \
        per_step


def _assert_same_step(plain, remat, depth):
    assert remat[0] == plain[0]                     # bit for bit
    for k, v in plain[1].items():
        np.testing.assert_allclose(remat[1][k].numpy(), v.numpy(),
                                   err_msg=k, **PARAM_TOL)
    assert plain[2] == [depth] * len(plain[0])
    assert remat[2] == [2 * depth] * len(remat[0])  # forward + recompute


@pytest.fixture(scope="module")
def jax_remat():
    """JAX's remat step on test_training.py's model: (weights, loss)."""
    cfg = JConfig(**CFG, dropout=0.0, attention_impl="xla", remat=True)
    model = jbuild(cfg).clone(image_size=32, dim=16, depth=2, heads=2,
                              dim_head=8)
    batch = _batch(2)
    v = jax.jit(model.init)({"params": jax.random.PRNGKey(0)},
                            jnp.asarray(batch["vid"]))
    # the step donates its state
    weights = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, v))
    state = JTrainState.create(v["params"], jbuild_optimizer(cfg))
    _, metrics = jmake_train_step(model, cfg)(
        state, {k: jnp.asarray(x) for k, x in batch.items()},
        jax.random.PRNGKey(3))
    return weights, float(metrics["loss"])


def test_remat_step_matches_jax(jax_remat):
    weights, jloss = jax_remat
    cfg = Config(**CFG, dropout=0.0, attention_impl="xla", remat=True)
    model = _vivit(True, weights, attention_impl="xla")
    losses, _, calls = _steps(model, cfg, [_batch(2)])
    np.testing.assert_allclose(losses[0], jloss, **JAX_LOSS_TOL)
    assert calls == [2 * VIVIT["depth"]]


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_remat_step_equals_the_plain_step(jax_remat, impl, rate):
    """Two steps with and without remat, on the fused blocks (kernel 1's
    plain version, its seeds drawn from the DropoutRng) and on the unfused
    ones (the masks drawn from it), at dropout 0 and 0.1."""
    weights, _ = jax_remat
    cfg = Config(**CFG, dropout=rate, attention_impl=impl)
    batches = [_batch(10), _batch(11)]
    plain = _steps(_vivit(False, weights, attention_impl=impl,
                          dropout=rate, emb_dropout=rate), cfg, batches)
    remat = _steps(_vivit(True, weights, attention_impl=impl, dropout=rate,
                          emb_dropout=rate), cfg, batches)
    _assert_same_step(plain, remat, VIVIT["depth"])


def test_moe_aux_term_counted_once():
    """An MoE block's load-balance term is appended in the forward only:
    the recompute does not append it again."""
    model = tv.ViViT(moe_experts=2, moe_every=2, dropout=0.1, **VIVIT)
    model.init_weights(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_batch(4)["vid"])
    results = []
    for remat in (False, True):
        twin = tv.ViViT(moe_experts=2, moe_every=2, dropout=0.1,
                        remat=remat, **VIVIT)
        twin.load_state_dict(model.state_dict())
        twin.train()
        losses = []
        out = twin(x, rng=tl.DropoutRng(5), losses=losses)
        loss = out.square().mean() + sum(losses)
        grads = torch.autograd.grad(loss, list(twin.parameters()))
        assert len(losses) == 1                  # after the backward too
        results.append((loss.item(), grads))
    assert results[0][0] == results[1][0]
    for a, b in zip(results[0][1], results[1][1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **PARAM_TOL)


def test_ptn_remat_step():
    """PTN's encoders (TorchTransformerEncoder, the packed attention's
    plain versions with their dropout): two steps against the plain ones
    at dropout 0 and 0.1."""
    batch = treg.example_batch(Config(**PTN), batch_size=3)
    weights = treg.build_model(Config(**PTN)).state_dict()
    for rate in (0.0, 0.1):
        runs = []
        for remat in (False, True):
            cfg = Config(**PTN, dropout=rate, remat=remat)
            model = treg.build_model(cfg)
            model.load_state_dict(weights)
            state = TrainState.create(dict(model.named_parameters()),
                                      build_optimizer(cfg))
            step = make_train_step(model, cfg, device="cpu")
            losses = []
            for seed in (1, 2):
                state, metrics = step(state, batch, seed)
                losses.append(metrics["loss"].item())
            runs.append((losses, state.params))
        (plain, p_params), (remat, r_params) = runs
        assert remat == plain
        for k, p in p_params.items():
            np.testing.assert_allclose(r_params[k].detach().numpy(),
                                       p.detach().numpy(), err_msg=k,
                                       **PARAM_TOL)


def test_frame_transformer_builds_with_remat():
    """``Config(model="vid", remat=True)`` builds through the registry
    (on the meta device: the names, not FrameTransformer's 80 M draws)
    with remat in its encoder, and an encoder of its distil transformer's
    shape (896 wide, 2 heads of 448, FFN 512, dropout 0.5) trains through
    remat with the plain stack's output and gradients."""
    with torch.device("meta"):
        model = treg.build_model(Config(model="vid", remat=True))
    assert isinstance(model.distil_transformer, TorchTransformerEncoder)
    assert model.distil_transformer.remat
    enc = TorchTransformerEncoder(896, 2, 512, 4, dropout=0.5, remat=True)
    plain = copy.deepcopy(enc)
    plain.remat = False
    x = torch.randn(1, 3, 896, generator=torch.Generator().manual_seed(0))
    outs = []
    for m in (plain.train(), enc.train()):
        leaf = x.clone().requires_grad_(True)
        y = m(leaf, tl.DropoutRng(7))
        (grad,) = torch.autograd.grad(y.square().sum(), leaf)
        outs.append((y.detach(), grad))
    assert torch.equal(outs[0][0], outs[1][0])
    np.testing.assert_allclose(outs[1][1].numpy(), outs[0][1].numpy(),
                               **PARAM_TOL)


def test_replay_on_another_thread_binds_the_forwards_scopes():
    """Autograd replays a CUDA block on its device thread, which does not
    see the calling thread's scopes; the recompute binds again the axes,
    ``moe_ep_scope`` and ``tp_pallas_scope`` the forward ran in (a
    backward started on a thread of its own stands in for the device
    thread here)."""
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, h):
            seen.append((collectives.bound_axes(), moe.active_moe_ep(),
                         active_tp_mesh()))
            return h.sin()

    x = torch.ones(3, requires_grad=True)
    axes = {"data": collectives.Axis(None, 1, 0)}
    mesh = object()
    with collectives.axis_scope(axes), moe.moe_ep_scope("data", 2), \
            tp_pallas_scope(mesh):
        y = tl.remat(Probe(), lambda h, r, first: (h,), x, None)
    grads = []
    worker = threading.Thread(
        target=lambda: grads.append(torch.autograd.grad(y.sum(), x)[0]))
    worker.start()
    worker.join()
    assert len(seen) == 2                       # forward + recompute
    assert seen[0] == seen[1] == (axes, ("data", 2), mesh)
    torch.testing.assert_close(grads[0], torch.ones(3).cos())
    assert collectives.bound_axes() == {} and moe.active_moe_ep() is None


def test_replay_runs_on_the_tensors_bound_at_the_forward():
    """A step binds the tensors a block computes on (a rank's gathered
    FSDP weights, its tensor-parallel parts) with ``functional_call`` and
    takes the backward after the binding has put the module's own back:
    the recompute runs on the forward's tensors, so the gradients are the
    plain block's on those tensors, and the module's own get none."""
    gen = torch.Generator().manual_seed(3)
    block = tl.ViTBlock(dim=16, heads=2, dim_head=8, mlp_dim=32,
                        attention_impl="xla").train()

    class Outer(torch.nn.Module):
        def __init__(self, rematerialise: bool):
            super().__init__()
            self.block, self.rematerialise = block, rematerialise

        def forward(self, h):
            if self.rematerialise:
                return tl.remat(self.block, lambda h, r, first: (h, None, r),
                                h, None)
            return self.block(h)

    bound = {f"block.{k}": (torch.randn(v.shape, generator=gen) * 0.2)
             .requires_grad_(True) for k, v in block.named_parameters()}
    x = torch.randn(2, 5, 16, generator=gen)
    grads = []
    for rematerialise in (False, True):
        leaf = x.clone().requires_grad_(True)
        y = torch.func.functional_call(Outer(rematerialise), bound, (leaf,))
        grads.append(torch.autograd.grad(y.square().sum(),
                                         [leaf, *bound.values()]))
    assert all(p.grad is None for p in block.parameters())
    for a, b in zip(*grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **PARAM_TOL)
