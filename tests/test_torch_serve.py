"""The port's Predictor against the JAX package's, on the CPU.

ViViT at registry width (224², patch 16, dim 192, depth 4, 3 heads) with
2 frames, f32.  JAX runs ``attention_impl="fused_interpret"``, the fused
block math the TPU serves; the port runs ``device="cpu"``, where the
fused block is the kernel's plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu.config import Config as JConfig
from devt_tpu.registry import build_model as jbuild
from devt_tpu.serve import Predictor as JPredictor
from devt_tpu_torch import registry as treg
from devt_tpu_torch.config import Config
from devt_tpu_torch.serve import Predictor
from devt_tpu_torch.utils.jax_bridge import jax_to_state_dict

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

CFG = dict(model="vivit", frame_len=2, n_classes=19, precision="f32",
           attention_impl="fused_interpret", dropout=0.0)
# f32 sigmoid scores after 8 blocks at width 192, sums in other orders
SCORE_TOL = dict(atol=2e-5, rtol=2e-4)


@pytest.fixture(scope="module")
def predictors():
    jcfg = JConfig(**CFG)
    v = jbuild(jcfg).init({"params": jax.random.PRNGKey(0)},
                          jnp.zeros((1, 2, 224, 224, 3)))
    jpred = JPredictor(jcfg, v, buckets=(2,))
    sd = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, v))
    tpred = Predictor(Config(**CFG), sd, buckets=(1, 2), device="cpu")
    return jpred, tpred


def _clips(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 2, 224, 224, 3), dtype=np.uint8)


def test_float_batch_matches_jax(predictors):
    jpred, tpred = predictors
    x = (_clips(3, 0).astype(np.float32) - 128.0) / 64.0
    want = jpred.predict({"vid": x})
    got = tpred.predict({"vid": x})
    assert got["scores"].shape == (3, 19)
    np.testing.assert_allclose(got["scores"], want["scores"], **SCORE_TOL)


def test_u8_batch_matches_jax(predictors):
    jpred, tpred = predictors
    x = _clips(3, 1)
    want = jpred.predict({"vid": x})
    got = tpred.predict({"vid": x})
    np.testing.assert_allclose(got["scores"], want["scores"], **SCORE_TOL)
    assert got["labels"] == want["labels"]


def test_padding_does_not_change_results(predictors):
    _, tpred = predictors
    x = _clips(3, 2)
    full = tpred.predict({"vid": x})["scores"]
    singles = np.concatenate([tpred.predict({"vid": x[i:i + 1]})["scores"]
                              for i in range(3)])
    np.testing.assert_allclose(full, singles, atol=1e-5)


def test_labels_follow_threshold(predictors):
    _, tpred = predictors
    out = tpred.predict({"vid": _clips(2, 3)})
    for row, labels in zip(out["scores"], out["labels"]):
        assert labels == [tpred.target_names[i]
                          for i in np.flatnonzero(row > 0.3)]


def test_default_device_is_the_card(monkeypatch):
    """No device argument and no CUDA: raise, never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(Config(**CFG), {})


@pytest.mark.parametrize("kw", [dict(quantize=True), dict()])
def test_unported_serving_options_raise(kw):
    """Data-parallel serving is ported (``tests/test_torch_dp.py`` serves
    over two ranks): a mesh of one rank serves as one device; a mesh of
    two rounds its buckets up to the data axis, and without a process
    group to gather its rows over, its predict raises.  A narrow PTN."""
    from devt_tpu_torch.parallel.mesh import make_mesh

    ptn = Config(model="ptn", seq_len=3, nlayers=1, input_dimension=32,
                 nhid=32, nhead=2, precision="f32", experts=("a", "b"))
    sd = treg.build_model(ptn).state_dict()
    one = Predictor(ptn, sd, buckets=(1, 2), mesh=make_mesh(),
                    device="cpu", **kw)
    assert one.mesh is None and one.buckets == [1, 2]
    two = Predictor(ptn, sd, buckets=(1, 3),
                    mesh=make_mesh(dp=2, devices=range(2)), device="cpu",
                    **kw)
    assert two.buckets == [2, 4]
    with pytest.raises(RuntimeError, match="torch.distributed"):
        two.predict({"experts": np.zeros((1, 3, 2, 32), np.float32)})
    # from_checkpoint and from_lightning_checkpoint are ported
    # (test_torch_harness.py, test_torch_lightning_import.py): a missing
    # checkpoint is a missing file
    with pytest.raises(FileNotFoundError):
        Predictor.from_lightning_checkpoint(Config(**CFG), "missing.ckpt",
                                            device="cpu")
    with pytest.raises(FileNotFoundError):
        Predictor.from_checkpoint(Config(**CFG), "missing.ckpt")


def test_other_models_are_not_ported():
    """The rest of the family is ported: ``contrastive``, ``lstm`` and
    ``tpn`` build from the registry and draw their batches (their numbers
    against JAX's: ``test_torch_models_family.py``)."""
    want = {"contrastive": {"x_i": (2, 2048), "x_j": (2, 2048),
                            "label": (2, 15)},
            "lstm": {"experts": (2, 13, 4608), "label": (2, 15)},
            "tpn": {"img": (2, 20, 224, 224, 3), "label": (2, 15)}}
    for name, shapes in want.items():
        model = treg.build_model(Config(model=name))
        assert next(model.parameters()).dtype == torch.float32
        batch = treg.example_batch(Config(model=name))
        assert {k: v.shape for k, v in batch.items()} == shapes, name


def test_unknown_model_name_raises():
    """A name the JAX registry does not build either is a ValueError, as
    there (``frame_transformer_vid`` is no variant: ``vid`` is)."""
    for name in ("frame_transformer_vid", "resnet18"):
        with pytest.raises(ValueError, match="unknown model"):
            treg.build_model(Config(model=name))
        with pytest.raises(ValueError, match="unknown model"):
            treg.example_batch(Config(model=name))
        with pytest.raises(ValueError):
            jbuild(JConfig(model=name))


FT_CFG = dict(model="distil", seq_len=1, frame_len=2, n_classes=19,
              precision="f32")


def test_frame_transformer_is_served_from_img_and_vid():
    """FrameTransformer builds from the registry, seeded (flax's BatchNorm
    and CLS initializers); ``distil`` behind ``Predictor`` (CPU, a bucket
    of 4 for 3 requests) gives the model's sigmoid logits, float or as u8
    pixels normalised on the device side, whatever the padding.  (The model's numbers against JAX's:
    ``test_torch_frame_transformer.py``.)"""
    from devt_tpu_torch.data.device_norm import maybe_dequantize_batch
    from devt_tpu_torch.models.frame_transformer import VARIANTS

    cfg = Config(**FT_CFG)
    model = treg.build_model(cfg)
    sd = model.state_dict()
    assert torch.all(sd["img_backbone.stem.bn.weight"] == 1)
    assert torch.all(sd["vid_backbone.layer1_0.bn1.running_var"] == 1)
    assert 0.0 <= sd["vid_cls"].min() and sd["vid_cls"].max() < 1.0
    assert set(treg.KNOWN_MODELS) >= set(VARIANTS)
    pred = Predictor(cfg, sd, buckets=(4,), device="cpu")
    batch = treg.example_batch(cfg, batch_size=3)
    assert batch["img"].shape == (3, 1, 224, 224, 3)
    assert batch["vid"].shape == (3, 1, 2, 112, 112, 3)
    rng = np.random.default_rng(4)
    u8 = {k: rng.integers(0, 256, batch[k].shape, dtype=np.uint8)
          for k in ("img", "vid")}
    for inputs in ({k: batch[k] for k in ("img", "vid")}, u8):
        out = pred.predict(inputs)
        assert out["scores"].shape == (3, 19)
        tensors = maybe_dequantize_batch(
            {k: torch.from_numpy(v) for k, v in inputs.items()},
            dtype=torch.float32)
        with torch.no_grad():
            want = torch.sigmoid(model.eval()(**tensors)["logits"])
        np.testing.assert_allclose(out["scores"], want.numpy(), atol=1e-5)


def test_seeded_build_is_deterministic():
    cfg = Config(**CFG)
    a = treg.build_model(cfg).state_dict()
    b = treg.build_model(cfg).state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    # flax's initializers: unit LN scales, zero biases, lecun kernels
    assert torch.all(a["head_norm.weight"] == 1)
    assert torch.all(a["head.bias"] == 0)
    w = a["space_transformer.blocks.0.ff.fc1.weight"]
    assert abs(w.std().item() - 192 ** -0.5) < 0.1 * 192 ** -0.5


@pytest.mark.parametrize("wire", ["f32", "u8_tokens"])
def test_example_batch_matches_jax(wire):
    from devt_tpu.registry import example_batch as jexample

    cfg = dict(model="vivit", frame_len=2, wire_format=wire)
    want = jexample(JConfig(**cfg), batch_size=2)
    got = treg.example_batch(Config(**cfg), batch_size=2)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
