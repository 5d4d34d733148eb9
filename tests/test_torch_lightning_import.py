"""``Predictor.from_lightning_checkpoint`` on the CPU, against the JAX
package's on the same file.

The port's counterpart of ``tests/test_lightning_import.py``.  The
checkpoints are written by ``data/synthetic.py:write_fake_lightning_
checkpoint`` (a pickle with hyper-parameters beside the ``state_dict``),
whose keys and shapes are held against that file's reference-shaped
state_dicts (``_frame_transformer_sd``, ``_encoder_sd``: torchvision's
names for R(2+1)D-18 and ResNet-18, the reference's encoders, CLS and
head); the FrameTransformer's CLS clip is written at 2 frames, so that it
is served at 2 frames.  Both packages serve each file.

Tolerance: f32 sums in other orders through a video backbone and four
encoder layers, 2e-5 on every score (the JAX package's bound between its
own serving paths, tests/test_torch_serve.py).
"""

import jax
import numpy as np
import pytest
import test_lightning_import as jtests
import torch

from devt_tpu.config import Config as JConfig
from devt_tpu.serve import Predictor as JPredictor
from devt_tpu_torch.config import Config
from devt_tpu_torch.data import synthetic
from devt_tpu_torch.serve import Predictor
from devt_tpu_torch.utils import lightning_import, torch_port

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

SCORE_TOL = dict(atol=2e-5, rtol=0)


def _serve_both(cfg_kw, path, batch):
    jpred = JPredictor.from_lightning_checkpoint(
        JConfig(**cfg_kw, attention_impl="xla"), path, buckets=(2,))
    tpred = Predictor.from_lightning_checkpoint(
        Config(**cfg_kw, attention_impl="pallas"), path, buckets=(2,),
        device="cpu")
    return jpred.predict(batch)["scores"], tpred


def test_frame_transformer_checkpoint_serves_like_jax(tmp_path):
    path = str(tmp_path / "ft.ckpt")
    sd = synthetic.write_fake_lightning_checkpoint(path, "frame_transformer",
                                                   frames=2)
    vid = np.random.default_rng(1).standard_normal(
        (2, 1, 2, 112, 112, 3), dtype=np.float32)
    want, tpred = _serve_both(dict(model="vid", seq_len=1, frame_len=2,
                                   n_classes=19, precision="f32"), path,
                              {"vid": vid})
    got = tpred.predict({"vid": vid})["scores"]
    assert got.shape == (2, 19)
    np.testing.assert_allclose(got, want, **SCORE_TOL)
    # every entry of the model filled from the file, laid out as JAX's
    weights = tpred.model.state_dict()
    tree = lightning_import.frame_transformer(sd)["params"]
    assert "img_backbone" in tree and not hasattr(tpred.model,
                                                   "img_backbone")
    np.testing.assert_array_equal(weights["vid_cls"].numpy(),
                                  sd["vid_cls"][0].transpose(0, 2, 3, 1))
    np.testing.assert_array_equal(
        weights["distil_transformer.layers.0.self_attn.in_proj.weight"]
        .numpy(), sd["distil_transformer.transformer.layers.0.self_attn"
                     ".in_proj_weight"])
    np.testing.assert_array_equal(
        weights["vid_backbone.stem_temporal.bn.running_var"].numpy(),
        sd["vid_model.backbone.stem.4.running_var"])
    np.testing.assert_array_equal(weights["img_mlp_head.fc2.weight"].numpy(),
                                  sd["img_mlp_head.4.weight"])


def test_simple_transformer_checkpoint_serves_like_jax(tmp_path):
    path = str(tmp_path / "ptn.ckpt")
    sd = synthetic.write_fake_lightning_checkpoint(
        path, "simple_transformer", d_model=64, ff=128, nlayers=2)
    x = np.random.default_rng(2).standard_normal((2, 3, 2, 64),
                                                 dtype=np.float32)
    want, tpred = _serve_both(dict(model="ptn", seq_len=3, nlayers=2,
                                   nhid=128, input_dimension=64, nhead=2,
                                   n_classes=15, dropout=0.0,
                                   precision="f32", experts=("a", "b")),
                              path, {"experts": x})
    np.testing.assert_allclose(tpred.predict({"experts": x})["scores"], want,
                               **SCORE_TOL)
    weights = tpred.model.state_dict()
    np.testing.assert_array_equal(weights["cls"].numpy(), sd["cls"][:, :1])
    np.testing.assert_array_equal(weights["head.weight"].numpy(),
                                  sd["mlp_head.1.weight"])


def test_missing_weights_and_files_raise(tmp_path):
    sd = synthetic.reference_state_dict("simple_transformer", d_model=64,
                                        ff=128, nlayers=2)
    del sd["transformer_encoder1.layers.1.linear2.bias"]
    path = str(tmp_path / "short.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in sd.items()}}, path)
    cfg = Config(model="ptn", seq_len=3, nlayers=2, nhid=128,
                 input_dimension=64, nhead=2, experts=("a", "b"))
    with pytest.raises(KeyError):
        Predictor.from_lightning_checkpoint(cfg, path, device="cpu")
    with pytest.raises(FileNotFoundError):
        Predictor.from_lightning_checkpoint(cfg, str(tmp_path / "none"),
                                            device="cpu")


def test_map_functions_match_jax():
    """The port's copy of the layout maps against the JAX package's on
    the reference FrameTransformer's backbones and an encoder."""
    from devt_tpu.utils import torch_port as jtp

    sd = synthetic.reference_state_dict("frame_transformer", seed=3)

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}

    r2, rn = sub("vid_model.backbone."), sub("img_model.backbone.")
    enc = sub("distil_transformer.transformer.")
    cases = [(torch_port.r2plus1d(r2, with_fc=False),
              jtp.r2plus1d(r2, with_fc=False)),
             (torch_port.resnet(rn), jtp.resnet(rn)),
             (torch_port.transformer_encoder(enc, 4),
              jtp.transformer_encoder(enc, 4)),
             (torch_port.conv3d(r2, "stem.0"), jtp.conv3d(r2, "stem.0"))]
    for got, want in cases:
        got_leaves = jax.tree_util.tree_leaves_with_path(got)
        want_leaves = dict(jax.tree_util.tree_leaves_with_path(want))
        assert len(got_leaves) == len(want_leaves)
        for path, leaf in got_leaves:
            np.testing.assert_array_equal(leaf, want_leaves[path])


def test_synthetic_checkpoints_are_reference_shaped(tmp_path, monkeypatch):
    """``data/synthetic.py``'s state_dicts have the keys and shapes of the
    JAX package's reference-shaped ones (its test helpers, their values
    zeroed to make them fast), and its ``.ckpt`` reads back."""
    monkeypatch.setattr(jtests, "_t",
                        lambda *shape: np.zeros(shape, np.float32))
    ptn = jtests._encoder_sd("transformer_encoder0", 64, 128, 2)
    ptn.update(jtests._encoder_sd("transformer_encoder1", 64, 128, 2))
    ptn.update({k: np.zeros(shape) for k, shape in (
        ("cls", (1, 2, 64)), ("norm.weight", (64,)), ("norm.bias", (64,)),
        ("mlp_head.0.weight", (64,)), ("mlp_head.0.bias", (64,)),
        ("mlp_head.1.weight", (15, 64)), ("mlp_head.1.bias", (15,)))})
    for kind, want, shape in (
            ("frame_transformer", jtests._frame_transformer_sd(), {}),
            ("simple_transformer", ptn,
             dict(d_model=64, ff=128, nlayers=2))):
        got = synthetic.reference_state_dict(kind, **shape)
        assert {k: np.shape(v) for k, v in got.items()} \
            == {k: np.shape(v) for k, v in want.items()}
    path = str(tmp_path / "ptn.ckpt")
    sd = synthetic.write_fake_lightning_checkpoint(
        path, "simple_transformer", d_model=64, ff=128, nlayers=2)
    assert set(lightning_import.load_checkpoint_state_dict(path)) == set(sd)
    with pytest.raises(ValueError, match="unknown reference module"):
        synthetic.reference_state_dict("resnet")
