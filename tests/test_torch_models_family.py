"""The rest of the model family in the port against the JAX package's, on
the CPU: the contrastive losses and encoder, the expert pools, collaborative
gating, BasicMLP, the LSTM baseline, TPN and the expert extractor, their
registry, step and serving glue, and the bridge's trees.

Weights are drawn with numpy (``randomize`` of
``test_torch_frame_transformer.py``: BatchNorm scales, biases and running
statistics non-trivial) and carried into flax by ``utils.jax_bridge``; the
JAX side is jitted.  Tolerances, each stated where it is used:

  * f32 elementwise math and short sums: atol 1e-5 / rtol 1e-5 (``F32``);
  * f32 through a few products and a BatchNorm: 1e-4 (``DENSE``);
  * TPN in f32 (ResNet-34, then three MLPs): the backbones' bound of
    ``test_torch_backbones.py``, atol 1e-4 / rtol 1e-3;
  * bf16: each side rounds at the same places, but XLA keeps some
    intermediates of a fused chain in f32 where the port rounds them, so a
    few elements land an ulp apart, which the next products spread: the
    LSTM 2e-2 and TPN 4e-2 (through 36 convolutions) in absolute terms on
    outputs in [-1, 1] and [0, 1];
  * gradients: per leaf, |port - JAX| within the stated share of the
    leaf's largest element.  TPN's backbone trains on batch statistics
    through ReLUs, where two f32 roundings move an input near 0 across the
    kink and a whole gradient term with it (``test_torch_train_ft.py``),
    so its gradients are held in f64 on both sides (``jax.enable_x64``).
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu import registry as jreg
from devt_tpu.config import Config as JConfig
from devt_tpu.models import collab_gating as jcg
from devt_tpu.models import contrastive as jco
from devt_tpu.models import losses as jl
from devt_tpu.models.basicmlp import BasicMLP as JBasicMLP
from devt_tpu.models.lstm import LSTMRegressor as JLSTM
from devt_tpu.models.pretrained import EmbeddingExtractor as JExtractor
from devt_tpu.models.r2plus1d import r3d_18 as jr3d_18
from devt_tpu.models.resnet import resnet50 as jresnet50
from devt_tpu.models.tpn import TPN as JTPN
from devt_tpu.models.tpn import sum_group as jsum_group
from devt_tpu.train import steps as jsteps
from devt_tpu_torch import registry as treg
from devt_tpu_torch.config import Config as TConfig
from devt_tpu_torch.models import collab_gating as tcg
from devt_tpu_torch.models import contrastive as tco
from devt_tpu_torch.models import losses as tl
from devt_tpu_torch.models.basicmlp import BasicMLP
from devt_tpu_torch.models.layers import DropoutRng
from devt_tpu_torch.models.lstm import LSTMRegressor
from devt_tpu_torch.models.pretrained import EmbeddingExtractor
from devt_tpu_torch.models.resnet import collect_batch_stats
from devt_tpu_torch.models.tpn import TPN, sum_group
from devt_tpu_torch.parallel import train_step as tts
from devt_tpu_torch.serve import Predictor
from devt_tpu_torch.train import steps as tsteps
from devt_tpu_torch.train.optimizers import build_optimizer
from devt_tpu_torch.train.state import TrainState, model_buffers
from devt_tpu_torch.utils.jax_bridge import (jax_to_state_dict,
                                             state_dict_to_jax)
from test_torch_frame_transformer import randomize

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

F32 = dict(atol=1e-5, rtol=1e-5)
DENSE = dict(atol=1e-4, rtol=1e-4)
TPN_F32 = dict(atol=1e-4, rtol=1e-3)
LSTM_BF16, TPN_BF16 = 2e-2, 4e-2
# small sizes: widths of the encoder and MLP, the LSTM's, TPN's images
ENC = dict(input_shape=48, hidden_layer=40, projection_size=24,
           output_shape=16)
LSTM = dict(n_features=64, hidden_size=32, num_layers=2, n_classes=15)
TPN_IMAGE, TPN_T, TPN_CLASSES = 32, 20, 19


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _jvars(model, dtype=jnp.float32):
    v = state_dict_to_jax(model.state_dict())
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), v)


def _sd(tree, dtype=np.float32):
    return jax_to_state_dict(jax.tree_util.tree_map(np.asarray, tree),
                             dtype=dtype)


def _shapes(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(x.shape)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_leaves(got: dict, want: dict, rtol: float, floor: float = 1e-6):
    """Every leaf of ``got`` within ``rtol`` of ``want``'s largest
    element (or ``floor``), and the same leaves."""
    assert set(got) == set(want)
    for k, g in got.items():
        w = np.asarray(want[k], np.float64)
        g = g.detach().double().numpy() if isinstance(g, torch.Tensor) \
            else np.asarray(g, np.float64)
        err = np.abs(g - w).max()
        assert err <= rtol * max(np.abs(w).max(), floor), (k, err)


class _NoDropout(fnn.Module):
    """flax's Dropout at rate 0 whatever its rate: TPN's rates are fixed
    in the JAX package, so its training forward is compared without
    them."""
    rate: float = 0.0

    @fnn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


# --- losses -------------------------------------------------------------

@pytest.mark.parametrize("n,d,temperature", [(4, 16, 0.5), (7, 5, 0.1)])
def test_contrastive_losses_match_jax(n, d, temperature):
    """f32: similarities of normalised rows, exp and log, sums over 2n."""
    zi, zj = _np(0, (n, d)), _np(1, (n, d))
    for jfn, tfn in ((jl.nt_xent, tl.nt_xent),
                     (jl.contrastive_loss, tl.contrastive_loss)):
        want = jfn(jnp.asarray(zi), jnp.asarray(zj), temperature=temperature)
        got = tfn(torch.tensor(zi), torch.tensor(zj),
                  temperature=temperature)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # bf16 projections are scored in f32, as in the JAX package
    got = tl.nt_xent(torch.tensor(zi).bfloat16(), torch.tensor(zj).bfloat16())
    want = jl.nt_xent(jnp.asarray(zi, jnp.bfloat16),
                      jnp.asarray(zj, jnp.bfloat16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # the negatives gathered over a mesh axis (tests/test_torch_dp.py runs
    # two ranks): an axis of one rank is the local loss; an unbound name
    # raises, as JAX's does outside shard_map
    from devt_tpu_torch.parallel import collectives

    with pytest.raises(NameError, match="unbound axis name"):
        tl.nt_xent(torch.tensor(zi), torch.tensor(zj), axis_name="data")
    with collectives.axis_scope({"data": collectives.Axis(None, 1, 0)}):
        assert tl.nt_xent(torch.tensor(zi), torch.tensor(zj),
                          axis_name="data").equal(
            tl.nt_xent(torch.tensor(zi), torch.tensor(zj)))


# --- pools, aggregation, gating ------------------------------------------

@pytest.mark.parametrize("n,out", [(10, 4), (12, 12), (7, 3), (5, 8)])
def test_adaptive_pools_match_jax(n, out):
    """f32: the same bins; the average as differences of a cumulative sum
    on both sides."""
    x = _np(2, (3, 2, n))
    for jfn, tfn in ((jco.adaptive_avg_pool_1d, tco.adaptive_avg_pool_1d),
                     (jco.adaptive_max_pool_1d, tco.adaptive_max_pool_1d)):
        np.testing.assert_allclose(tfn(torch.tensor(x), out).numpy(),
                                   np.asarray(jfn(jnp.asarray(x), out)),
                                   **F32)


@pytest.mark.parametrize("mode", ["none", "concat", "avg_pool", "mean_pool",
                                  "collab_gate"])
def test_expert_aggregation_matches_jax(mode):
    experts = [_np(3, (2, 5, 6)), _np(4, (2, 5, 10))]
    want = jco.expert_aggregation([jnp.asarray(e) for e in experts], mode, 7)
    got = tco.expert_aggregation([torch.tensor(e) for e in experts], mode, 7)
    if mode == "collab_gate":       # passed through to the gating
        assert all(g.numpy().tolist() == np.asarray(w).tolist()
                   for g, w in zip(got, want))
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    with pytest.raises(ValueError, match="unknown aggregation"):
        tco.expert_aggregation(experts, "sum", 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_collaborative_gating_matches_jax(dtype):
    """(B, S, E, D) with D below proj_dim (nearest-neighbour resize), and
    experts of different widths given apart, each resized alone.  f32:
    two products of 32 terms, a sum over experts, a normalisation (F32 at
    1e-4 relative); bf16: outputs of unit rows within 2e-2."""
    tm = randomize(tcg.CollaborativeGating(32, 16,
                                           dtype=getattr(torch, dtype)))
    jm = jcg.CollaborativeGating(32, 16, dtype=getattr(jnp, dtype))
    v = _jvars(tm)
    x = _np(5, (2, 3, 4, 20))
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    got = tm(torch.tensor(x))
    tol = dict(atol=1e-5, rtol=1e-4) if dtype == "float32" else dict(
        atol=2e-2, rtol=0)
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), **tol)
    widths = [_np(6, (2, 3, 8)), _np(7, (2, 3, 32)), _np(8, (2, 3, 20))]
    stacked = np.stack([np.asarray(jcg.interpolate_nearest_1d(
        jnp.asarray(e), 32)) for e in widths], axis=-2)
    want = jax.jit(jm.apply)(v, jnp.asarray(stacked))
    got = tm([torch.tensor(e) for e in widths])
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), **tol)


# --- BasicMLP and the contrastive encoder ---------------------------------

def _encoder_pair(dtype="float32"):
    tm = randomize(tco.ContrastiveEncoder(**ENC, dropout=0.0,
                                          dtype=getattr(torch, dtype)))
    jm = jco.ContrastiveEncoder(**ENC, dropout=0.0, dtype=getattr(jnp, dtype))
    return tm, jm


def _mlp_pair():
    tm = randomize(BasicMLP(48, 24, 11))
    return tm, JBasicMLP(48, 24, 11)


def _stats_by_name(model, stats):
    path = {m: n for n, m in model.named_modules()}
    out = {}
    for m, (mean, var) in stats.items():
        out[f"{path[m]}.running_mean"] = mean
        out[f"{path[m]}.running_var"] = var
    return out


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("which", ["basicmlp", "contrastive"])
def test_mlp_and_encoder_match_jax(which, train):
    """Outputs (the embedding too), and in training the new batch_stats.
    f32 through four products and a BatchNorm: 1e-4."""
    tm, jm = _mlp_pair() if which == "basicmlp" else _encoder_pair()
    x = _np(9, (6, 48))
    v = _jvars(tm)
    kw = {"return_embedding": True} if which == "basicmlp" else {}
    if train:
        jout, jmut = jax.jit(lambda v, a: jm.apply(
            v, a, train=True, mutable=["batch_stats"], **kw))(v,
                                                              jnp.asarray(x))
    else:
        jout = jax.jit(lambda v, a: jm.apply(v, a, **kw))(v, jnp.asarray(x))
    with torch.no_grad(), collect_batch_stats() as stats:
        out = tm(torch.tensor(x), train=train, **kw)
    for got, want in zip(out, jout):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **DENSE)
    if train:
        want = _sd({"params": {}, "batch_stats": jmut["batch_stats"]})
        _close_leaves(_stats_by_name(tm, stats), want, 1e-5)
    else:
        assert not stats


def test_contrastive_two_pass_step_matches_jax():
    """The step's two passes at dropout 0: the loss, every gradient leaf
    within 1e-4 of its largest element, and the BatchNorm statistics
    after both passes (the momentum applied twice) within 1e-4."""
    tm, jm = _encoder_pair()
    batch = {"x_i": _np(10, (6, 48)), "x_j": _np(11, (6, 48)),
             "label": np.zeros((6, 3), np.float32)}
    jcfg, tcfg = JConfig(model="contrastive"), TConfig(model="contrastive")
    v = _jvars(tm)

    def loss_fn(params, stats):
        loss, aux, mut = jsteps.forward_and_loss(
            jm, jcfg, {"params": params, "batch_stats": stats},
            {k: jnp.asarray(a) for k, a in batch.items()},
            jax.random.PRNGKey(0), train=True)
        return loss, (aux, mut)

    (jloss, (jaux, jmut)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"], v["batch_stats"])
    params = dict(tm.named_parameters())
    loss, aux, new_ms = tsteps.forward_and_loss(
        tm, tcfg, {"params": params, **model_buffers(tm)},
        {k: torch.tensor(a) for k, a in batch.items()}, DropoutRng(0),
        train=True)
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    assert set(aux) == set(jaux) == {"embedding", "label", "probs"}
    np.testing.assert_allclose(aux["embedding"].detach().numpy(),
                               np.asarray(jaux["embedding"]), **DENSE)
    assert aux["probs"].shape == (6, 1) and not aux["probs"].any()
    _close_leaves(dict(zip(params, grads)), _sd(jgrads), 1e-4)
    want = _sd({"params": {}, "batch_stats": jmut["batch_stats"]})
    _close_leaves(new_ms, want, 1e-4)
    # twice: 0.81 of the old running mean is left, not 0.9
    once = 0.9 * tm.enc_bn.running_mean
    assert not torch.allclose(new_ms["enc_bn.running_mean"], once)


# --- LSTM ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lstm_case(dtype):
    tm = randomize(LSTMRegressor(**LSTM, dtype=getattr(torch, dtype)))
    jm = JLSTM(**LSTM, dtype=getattr(jnp, dtype))
    x = _np(12, (3, 5, 64))
    want = jax.jit(jm.apply)(_jvars(tm), jnp.asarray(x))
    return tm, jm, x, np.asarray(want, np.float32)


def test_lstm_tree_matches_flax():
    """flax names the cells OptimizedLSTMCell_<i> at the top level; the
    bridge maps the port's stacked gates onto them, shape for shape."""
    tm, jm, x, _ = _lstm_case("float32")
    want = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x)))
    assert _shapes(_jvars(tm)) == _shapes(dict(want))


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", LSTM_BF16)])
def test_lstm_matches_jax(dtype, atol):
    """Two layers, 64 → 32, 5 steps, eval: f32 within 1e-5; bf16 (the
    products and gates in bf16, the carry in f32, as flax's cell) within
    2e-2."""
    tm, _, x, want = _lstm_case(dtype)
    with torch.no_grad():
        got = tm(torch.tensor(x))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                               rtol=0)


# --- TPN ----------------------------------------------------------------

def test_sum_group_matches_jax():
    """Trailing frames that fill no group are dropped, as in JAX."""
    x = _np(13, (2, 7, 3))
    for g in (2, 3, 4):
        np.testing.assert_allclose(sum_group(torch.tensor(x), g).numpy(),
                                   np.asarray(jsum_group(jnp.asarray(x), g)),
                                   **F32)


@functools.lru_cache(maxsize=None)
def _tpn_model(dtype="float32"):
    return randomize(TPN(num_class=TPN_CLASSES, dropout=(0.0, 0.0),
                         dtype=getattr(torch, dtype))).eval()


def _tpn_images(seed=14, b=2):
    return _np(seed, (b, TPN_T, TPN_IMAGE, TPN_IMAGE, 3))


def test_tpn_tree_matches_flax():
    want = jax.eval_shape(lambda: JTPN(num_class=TPN_CLASSES).init(
        jax.random.PRNGKey(0), jnp.zeros((1, TPN_T, TPN_IMAGE, TPN_IMAGE,
                                          3))))
    assert _shapes(_jvars(_tpn_model())) == _shapes(dict(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tpn_matches_jax(dtype):
    """Eval at T = 20 on 32² images: f32 the backbones' bound; bf16 4e-2
    on probabilities."""
    tm = _tpn_model(dtype)
    jm = JTPN(num_class=TPN_CLASSES, dtype=getattr(jnp, dtype))
    x = _tpn_images()
    want = np.asarray(jax.jit(jm.apply)(_jvars(tm), jnp.asarray(x)),
                      np.float32)
    with torch.no_grad():
        got = tm(torch.tensor(x)).float().numpy()
    assert got.shape == (2, TPN_CLASSES) and ((got > 0) & (got < 1)).all()
    tol = TPN_F32 if dtype == "float32" else dict(atol=TPN_BF16, rtol=0)
    np.testing.assert_allclose(got, want, **tol)


def _tpn_step():
    """JAX's TPN step (dropout off) in f64 on the port's weights: loss,
    probs, new batch_stats and gradients, keyed like the port's
    state_dict."""
    with jax.enable_x64(True):
        jm = JTPN(num_class=TPN_CLASSES, dtype=jnp.float64)
        v = _jvars(_tpn_model(), jnp.float64)
        batch = {"img": jnp.asarray(_tpn_images(b=1), jnp.float64),
                 "label": jnp.asarray(_labels(15, 1, TPN_CLASSES))}

        def loss_fn(params, stats):
            loss, aux, mut = jsteps.forward_and_loss(
                jm, JConfig(model="tpn", n_classes=TPN_CLASSES),
                {"params": params, "batch_stats": stats}, batch,
                jax.random.PRNGKey(0), train=True)
            return loss, (aux, mut)

        (loss, (aux, mut)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v["params"], v["batch_stats"])
        return (float(loss), np.asarray(aux["probs"]),
                _sd({"params": {}, "batch_stats": mut["batch_stats"]},
                    np.float64), _sd(grads, np.float64))


def _labels(seed, b, n):
    return (np.random.default_rng(seed).random((b, n)) < 0.3).astype(
        np.float32)


def _port_step(model, cfg, batch, dtype=torch.float32):
    params = dict(model.named_parameters())
    loss, aux, new_ms = tsteps.forward_and_loss(
        model, cfg, {"params": params, **model_buffers(model)},
        {k: torch.from_numpy(a).to(dtype) if a.dtype == np.float32
         else torch.from_numpy(a) for k, a in batch.items()},
        DropoutRng(0), train=True)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss, aux, new_ms, dict(zip(params, grads))


def test_tpn_step_matches_jax(monkeypatch):
    """A training step on batch statistics (one sample of 20 frames),
    dropout off on both sides, in f64 on both: probabilities and the new statistics within 1e-10, every
    gradient leaf within 1e-5 of its largest element, the loss within
    1e-6 (BCE computes in f32 in both packages, whatever its input)."""
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    batch = {"img": _tpn_images(b=1), "label": _labels(15, 1, TPN_CLASSES)}
    cfg = TConfig(model="tpn", n_classes=TPN_CLASSES)
    jloss, jprobs, jstats, jgrads = _tpn_step()
    tm = TPN(num_class=TPN_CLASSES, dropout=(0.0, 0.0), dtype=torch.float64)
    tm.load_state_dict(_tpn_model().state_dict())
    tm.double()
    loss, aux, new_ms, grads = _port_step(tm, cfg, batch, torch.float64)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-6)
    np.testing.assert_allclose(aux["probs"].detach().numpy(), jprobs,
                               rtol=1e-10, atol=1e-12)
    assert set(new_ms) == set(model_buffers(tm))
    _close_leaves(new_ms, jstats, 1e-10)
    _close_leaves(grads, jgrads, 1e-5)


# --- the expert extractor -----------------------------------------------

@functools.lru_cache(maxsize=None)
def _extractors():
    """The port's extractor with numpy-drawn weights, and the JAX package's
    carrying them (built without its init at 224², which only draws
    weights)."""
    ext = EmbeddingExtractor(seed=None, device="cpu")
    jx = JExtractor.__new__(JExtractor)
    jx.models = {"image": jresnet50(output="features"),
                 "video": jr3d_18(output="features")}
    jx.models["location"] = jx.models["image"]
    jx.variables = {}
    for name in ("image", "video", "location"):
        sd = randomize(ext.models[name], seed=20 + len(name)).state_dict()
        ext.load_torch_state_dict(name, sd)
        jx.variables[name] = jax.tree_util.tree_map(jnp.asarray,
                                                    state_dict_to_jax(sd))
    apply = {k: jax.jit(lambda v, x, m=m: m.apply(v, x, train=False))
             for k, m in jx.models.items() if k != "location"}
    jx._apply = {**apply, "location": apply["image"]}
    return ext, jx


def test_embedding_extractor_matches_jax():
    """ResNet-50 on 32² frames and R3D-18 on 4 x 32² clips, eval, f32 at
    the backbones' bound; the pooled expert vector the mean over N."""
    ext, jx = _extractors()
    frames, clips = _np(16, (3, 32, 32, 3)), _np(17, (2, 4, 32, 32, 3))
    for key, data in (("img-embeddings", frames), ("location", frames),
                      ("video-embeddings", clips)):
        got = ext.return_expert_for_key(key, data)
        want = jx.return_expert_for_key(key, jnp.asarray(data))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TPN_F32)
    got = ext.forward_video(torch.tensor(clips))
    assert got.shape == (2, 512)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jx.forward_video(jnp.asarray(clips))),
        **TPN_F32)
    with pytest.raises(KeyError):
        ext.return_expert_for_key("audio", frames)


# --- registry, steps, serving, bridge -----------------------------------

def _small_models():
    """Each new name at a small size, in both packages (the JAX registry's
    sizes are fixed for lstm and tpn)."""
    return {
        "lstm": (randomize(LSTMRegressor(**LSTM, dropout=0.0)),
                 JLSTM(**LSTM, dropout=0.0)),
        "basicmlp": (randomize(BasicMLP(48, 24, 11)), JBasicMLP(48, 24, 11)),
        "contrastive": _encoder_pair(),
    }


def _small_batch(name, b=4):
    if name == "lstm":
        return {"experts": _np(18, (b, 5, 64)), "label": _labels(19, b, 15)}
    if name == "basicmlp":
        return {"experts": _np(18, (b, 48)),
                "label": np.random.default_rng(19).integers(0, 11, (b,))}
    return {"x_i": _np(18, (b, 48)), "x_j": _np(20, (b, 48)),
            "label": _labels(19, b, 3)}


@pytest.mark.parametrize("name", ["lstm", "basicmlp", "contrastive"])
def test_forward_and_loss_matches_jax(name):
    """Every name's branch, training, dropout off: f32 loss and probs at
    1e-4, every gradient leaf within 1e-4 of its largest element.  (TPN's:
    ``test_tpn_step_matches_jax``.)"""
    tm, jm = _small_models()[name]
    batch = _small_batch(name)
    jcfg, tcfg = JConfig(model=name), TConfig(model=name)
    v = _jvars(tm)

    def loss_fn(params, stats):
        loss, aux, mut = jsteps.forward_and_loss(
            jm, jcfg, {"params": params, **({"batch_stats": stats}
                                             if stats else {})},
            {k: jnp.asarray(a) for k, a in batch.items()},
            jax.random.PRNGKey(0), train=True)
        return loss, aux

    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"], v.get("batch_stats"))
    loss, aux, _, grads = _port_step(tm, tcfg, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(aux["probs"].detach().numpy(),
                               np.asarray(jaux["probs"]), **DENSE)
    _close_leaves(grads, _sd(jgrads), 1e-4)


@pytest.mark.parametrize("name", ["lstm", "basicmlp", "contrastive"])
def test_multi_step_trains_on_the_cpu(name):
    """``make_multi_step(2)`` through the executors on ``device="cpu"``:
    finite falling loss on a fixed batch, the BatchNorm statistics moved
    where the model has them (the contrastive step's twice a step).
    (TPN's step: ``test_tpn_step_matches_jax``, and on the card.)"""
    tm = _small_models()[name][0]
    batch = _small_batch(name)
    cfg = TConfig(model=name, n_classes=19, opt="adamW", learning_rate=1e-3)
    buffers = model_buffers(tm)
    before = {k: v.clone() for k, v in buffers.items()}
    state = TrainState.create(dict(tm.named_parameters()),
                              build_optimizer(cfg), model_state=buffers)
    evaluate = tts.make_eval_step(tm, cfg, device="cpu")
    loss0 = evaluate(state, batch)[0].item()
    stacked = {k: np.stack([a, a]) for k, a in batch.items()}
    state, metrics = tts.make_multi_step(tm, cfg, 2, device="cpu")(
        state, stacked, 0)
    assert state.step == 2 and np.isfinite(metrics["loss"].item())
    assert evaluate(state, batch)[0].item() < loss0
    moved = {k for k in buffers if not torch.equal(buffers[k], before[k])}
    assert moved == set(buffers)
    assert bool(buffers) == (name != "lstm")


def test_registry_builds_and_draws_like_jax():
    """``build_model`` builds every name the JAX registry does, with its
    trees' names and shapes; ``example_batch`` draws the JAX registry's
    arrays, value for value."""
    for name in ("lstm", "basicmlp", "contrastive"):
        cfg = dict(model=name, batch_size=2, seq_len=3)
        tm = treg.build_model(TConfig(**cfg))
        jm = jreg.build_model(JConfig(**cfg))
        batch = treg.example_batch(TConfig(**cfg))
        jbatch = jreg.example_batch(JConfig(**cfg))
        assert set(batch) == set(jbatch)
        for k in batch:
            assert batch[k].dtype == jbatch[k].dtype
            np.testing.assert_array_equal(batch[k], jbatch[k])
        args = [jnp.asarray(v) for k, v in jbatch.items()
                if k not in ("label", "x_j")]
        want = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))
        assert _shapes(_jvars(tm)) == _shapes(dict(want)), name


def test_bridge_round_trips_every_new_tree():
    """port → flax → port, and flax → port → flax, bit for bit, for the
    LSTM cells, TPN, the encoder's and the MLP's 1-D BatchNorms,
    collaborative gating and the extractor's three backbones."""
    models = [LSTMRegressor(**LSTM), TPN(num_class=19), _encoder_pair()[0],
              _mlp_pair()[0], randomize(tcg.CollaborativeGating(32, 16))]
    ext = _extractors()[0]
    models = [randomize(m, seed=3) for m in models] + [
        ext.models["image"], ext.models["video"]]
    for m in models:
        sd = m.state_dict()
        tree = state_dict_to_jax(sd)
        back = jax_to_state_dict(tree)
        assert set(back) == set(sd)
        for k, v in sd.items():
            assert torch.equal(back[k], v), k
        again = state_dict_to_jax(back)
        assert _shapes(again) == _shapes(tree)
        for a, b in zip(jax.tree_util.tree_leaves(again),
                        jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["lstm", "basicmlp", "tpn"])
def test_predictor_serves_like_jax(name):
    """``Predictor`` on the CPU: tpn's probabilities, lstm's sigmoid and
    basicmlp's softmax scores equal the model's own, padded into a bucket,
    and ``quantize=True`` changes none of them (no site of these models is
    quantized, in either package; TPN's collect pass runs a 224² request,
    so its quantized predictor is held on the card,
    ``tests/test_torch_cuda.py``)."""
    cfg = TConfig(model=name, n_classes=19, batch_size=3, seq_len=3,
                  input_shape=48, token_embedding=11, precision="f32")
    if name == "tpn":
        model = randomize(TPN(num_class=19))
        request = {"img": _tpn_images(b=3)}
    elif name == "lstm":
        model = randomize(LSTMRegressor())
        request = {"experts": _np(21, (3, 3, 4608))}
    else:
        model = randomize(BasicMLP(48, n_classes=11))
        request = {"experts": _np(21, (3, 48))}
    sd = model.state_dict()
    pred = Predictor(cfg, sd, buckets=(4,), device="cpu")
    scores = pred.predict(request)["scores"]
    with torch.no_grad():
        out = model.eval()(torch.tensor(next(iter(request.values()))))
    want = {"tpn": out, "lstm": torch.sigmoid(out),
            "basicmlp": torch.softmax(out, dim=-1)}[name].numpy()
    np.testing.assert_allclose(scores, want, **F32)
    if name == "basicmlp":
        np.testing.assert_allclose(scores.sum(-1), 1.0, rtol=1e-5)
    if name == "tpn":
        return
    quant = Predictor(cfg, sd, buckets=(4,), device="cpu", quantize=True)
    assert quant._qsites == []
    np.testing.assert_array_equal(quant.predict(request)["scores"], scores)


def test_contrastive_is_not_served():
    """An encoder of embeddings: the JAX predictor has no branch for it
    (it falls into FrameTransformer's call and fails); the port says so."""
    cfg = TConfig(model="contrastive", **ENC)
    with pytest.raises(ValueError, match="contrastive"):
        Predictor(cfg, {}, device="cpu")
