"""The port's quantized Predictor against the JAX package's, on the CPU.

ViViT at registry width (224², patch 16, dim 192, depth 4, 3 heads) with 2
frames, and a narrow PTN with every Linear site quantized.  On the CPU the
JAX side runs the int8 fused block in interpret mode by itself and takes
the divide-and-clip ``quantize_activation`` at the PTN's Linear sites, and
so does the port (its fused matmul kernel is for CUDA tensors).

Tolerance.  Both sides quantize the same f32 values with the same
formulas, so the scores agree to f32 rounding unless a sum taken in another
order moves an activation across an int8 rounding boundary.  That happens
to a few of the 1.8 million activations a ViViT forward quantizes, and one
flipped code moves its row's product by a quantization step, which the
layers behind it carry to the scores: 9e-3 at most on the ViViT scores
here, under 1e-3 on the narrow PTN.  The bound is 2e-2 on every score, the
2 % that ``tests/test_quant.py`` allows two int8 paths of the JAX package
against each other, and inside the 5e-2 that int8 may cost against full
precision there.  What the blocks compute without such flips is held to
the f32 bound in ``tests/test_torch_quant.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu.config import Config as JConfig
from devt_tpu.registry import build_model as jbuild
from devt_tpu.registry import example_batch as jexample
from devt_tpu.serve import Predictor as JPredictor
from devt_tpu_torch.config import Config
from devt_tpu_torch.ops import quant as tq
from devt_tpu_torch.serve import Predictor
from devt_tpu_torch.utils.jax_bridge import jax_to_state_dict

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

VIVIT = dict(model="vivit", frame_len=2, n_classes=19, precision="f32",
             dropout=0.0)
PTN = dict(model="ptn", seq_len=6, nlayers=2, nhid=64, input_dimension=64,
           nhead=4, dropout=0.0, precision="f32",
           experts=("video-embeddings", "audio-embeddings"))
FLIP_TOL = dict(atol=2e-2, rtol=0)
ALL_SITES = lambda k, n: True     # noqa: E731


def _np_tree(v):
    return jax.tree_util.tree_map(np.asarray, v)


@pytest.fixture(scope="module")
def vivit():
    jcfg = JConfig(**VIVIT)
    v = _np_tree(jbuild(jcfg).init({"params": jax.random.PRNGKey(0)},
                                   jnp.zeros((1, 2, 224, 224, 3))))
    sd = jax_to_state_dict(v)
    return (JPredictor(jcfg, v, buckets=(2,), quantize=True),
            Predictor(Config(**VIVIT), sd, buckets=(1, 2), device="cpu",
                      quantize=True),
            Predictor(Config(**VIVIT), sd, buckets=(1, 2), device="cpu"))


@pytest.fixture(scope="module")
def ptn():
    jcfg = JConfig(**PTN)
    batch = jexample(jcfg, batch_size=5)
    v = _np_tree(jbuild(jcfg).init({"params": jax.random.PRNGKey(0)},
                                   jnp.asarray(batch["experts"])))
    return jcfg, v, jax_to_state_dict(v), {"experts": batch["experts"]}


def test_quantized_vivit_matches_jax(vivit):
    jpred, tpred, full = vivit
    clips = np.random.default_rng(0).integers(
        0, 256, (3, 2, 224, 224, 3), dtype=np.uint8)
    want = jpred.predict({"vid": clips})
    got = tpred.predict({"vid": clips})
    assert got["scores"].shape == (3, 19)
    np.testing.assert_allclose(got["scores"], want["scores"], **FLIP_TOL)
    # and it is the int8 path: close to full precision, not equal to it
    gap = np.abs(got["scores"] - full.predict({"vid": clips})["scores"]).max()
    assert 1e-6 < gap < 0.05


def test_quantized_vivit_sites(vivit):
    """One site per ViT block (4 fused space blocks, 4 unfused temporal
    blocks pinned to "xla"), each a quant_block_params tree with int8
    matrices, made once."""
    _, tpred, _ = vivit
    sites = tpred._qsites
    assert len(sites) == 8
    for qp in sites:
        assert {"wqkv_q", "wo_q", "w1_q", "w2_q"} <= set(qp)
        assert all(qp[k].dtype == torch.int8 for k in qp if k.endswith("_q"))
        assert qp["wqkv_s"].dtype == torch.float32


def test_second_predict_requantizes_nothing(vivit, monkeypatch):
    _, tpred, _ = vivit
    clips = np.random.default_rng(1).integers(
        0, 256, (2, 2, 224, 224, 3), dtype=np.uint8)
    first = tpred.predict({"vid": clips})["scores"]

    def boom(*a, **kw):
        raise AssertionError("a weight was quantized after construction")

    monkeypatch.setattr(tq, "quantize_weight", boom)
    ids = [id(s) for s in tpred._qsites]
    again = tpred.predict({"vid": clips})["scores"]
    np.testing.assert_array_equal(first, again)
    assert [id(s) for s in tpred._qsites] == ids
    # later writes to the model's weights do not reach the predictor
    with torch.no_grad():
        saved = tpred.model.space_transformer.blocks[0].ff.fc1.weight.clone()
        tpred.model.space_transformer.blocks[0].ff.fc1.weight.zero_()
        frozen = tpred.predict({"vid": clips})["scores"]
        tpred.model.space_transformer.blocks[0].ff.fc1.weight.copy_(saved)
    np.testing.assert_array_equal(first, frozen)


@pytest.mark.parametrize("name", ["ptn", "ptn_shared"])
def test_quantized_ptn_all_sites_matches_jax(ptn, name):
    jcfg, v, sd, req = ptn
    if name == "ptn_shared":
        jcfg = JConfig(**dict(PTN, model=name))
        v = _np_tree(jbuild(jcfg).init({"params": jax.random.PRNGKey(0)},
                                       jnp.asarray(req["experts"])))
        sd = jax_to_state_dict(v)
    want = JPredictor(jcfg, v, buckets=(4,), quantize=True,
                      quant_site_pred=ALL_SITES).predict(req)
    tpred = Predictor(Config(**dict(PTN, model=name)), sd, buckets=(4,),
                      device="cpu", quantize=True, quant_site_pred=ALL_SITES)
    got = tpred.predict(req)
    assert got["scores"].shape == (5, 15)
    np.testing.assert_allclose(got["scores"], want["scores"], **FLIP_TOL)
    assert got["labels"] == want["labels"]
    # 4 Linear sites per layer; the shared encoder runs three times
    runs = 3 if name == "ptn_shared" else 2
    assert len(tpred._qsites) == 4 * PTN["nlayers"] * runs
    assert all(w_q.dtype == torch.int8 and w_s.dtype == torch.float32
               for w_q, w_s in tpred._qsites)


def test_default_policy_and_full_precision_ptn_match_jax(ptn):
    """The default policy n >= 2k keeps the packed qkv projection only;
    ``quant_site_pred`` without ``quantize`` is ignored, as in JAX."""
    jcfg, v, sd, req = ptn
    cfg = Config(**PTN)
    want_q = JPredictor(jcfg, v, buckets=(4,), quantize=True).predict(req)
    tpred = Predictor(cfg, sd, buckets=(4,), device="cpu", quantize=True)
    np.testing.assert_allclose(tpred.predict(req)["scores"],
                               want_q["scores"], **FLIP_TOL)
    assert len(tpred._qsites) == PTN["nlayers"] * 2
    assert all(tuple(w_q.shape) == (64, 192) for w_q, _ in tpred._qsites)

    want = JPredictor(jcfg, v, buckets=(4,),
                      quant_site_pred=ALL_SITES).predict(req)
    full = Predictor(cfg, sd, buckets=(4,), device="cpu",
                     quant_site_pred=ALL_SITES)
    assert full._qsites is None and not full.quantize
    np.testing.assert_allclose(full.predict(req)["scores"], want["scores"],
                               atol=2e-5, rtol=2e-4)


def test_quantized_predictor_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(Config(**PTN), {}, quantize=True)


FT = dict(model="frame", seq_len=3, frame_len=2, n_classes=19, cls=0,
          precision="f32", dropout=0.0)
# card against CPU and the port against JAX, int8 serving (chip_smoke.py's
# QUANT_SCORE_ATOL): the flips above, through the ResNet-18 features and
# four encoder layers
FT_QUANT_TOL = dict(atol=4e-2, rtol=0)


def test_quantized_frame_transformer_matches_jax():
    """FrameTransformer's ``frame`` variant (no CLS inputs, so images of
    32²; 3 scenes) behind the quantized Predictor: the default policy
    quantizes the scene transformer's four qkv projections (896 → 2688),
    in both packages; the scores within the int8 serving gate of JAX's,
    and within it of the port's own full-precision scores."""
    from devt_tpu_torch.models.frame_transformer import FrameTransformer
    from devt_tpu_torch.utils.jax_bridge import state_dict_to_jax
    from test_torch_frame_transformer import randomize

    cfg = Config(**FT)
    model = randomize(FrameTransformer(model="frame", seq_len=3,
                                       frame_len=2, n_classes=19,
                                       use_cls=False))
    sd = model.state_dict()
    req = {"img": np.random.default_rng(7).standard_normal(
        (2, 3, 32, 32, 3)).astype(np.float32)}
    want = JPredictor(JConfig(**FT), _np_tree(state_dict_to_jax(sd)),
                      buckets=(2,), quantize=True).predict(req)["scores"]
    quant = Predictor(cfg, sd, buckets=(2,), device="cpu", quantize=True)
    assert len(quant._qsites) == 4
    assert all(tuple(w_q.shape) == (896, 2688) for w_q, _ in quant._qsites)
    got = quant.predict(req)["scores"]
    np.testing.assert_allclose(got, want, **FT_QUANT_TOL)
    full = Predictor(cfg, sd, buckets=(2,), device="cpu").predict(req)
    np.testing.assert_allclose(got, full["scores"], **FT_QUANT_TOL)
