"""The port's offline tools against the JAX package's, on the CPU.

Mirrors JAX's own cases: ``tests/test_aux.py`` (Grad-CAM),
``tests/test_offline_tooling.py`` (retrieval, the projector export,
``filter_manifest``), ``tests/test_harness_mesh.py`` (the tools' command
lines), ``tests/test_pipeline.py`` (the pp checkpoint converter) and the
checkpoint porter's file (``utils/torch_port.py``).  Tolerances:

  * Grad-CAM: both packages' maps, scaled to [0, 1], on the same numpy
    weights (``utils.jax_bridge``) and inputs, within atol 2e-5 (f32
    convolutions summed in other orders: 1.0e-6 of the map's largest
    value at ResNet-18; the ReLU over the weighted sum keeps the map
    continuous); the overlay byte for byte;
  * retrieval: the same neighbours, their distances within 1e-5 (f32);
    the projector's files and the command lines' output byte for byte;
  * the converter: lossless both ways, the stacked tree equal to
    ``jax_bridge`` of JAX's converted tree, and the stacked model's
    logits within 3e-3 of the per-block model's (JAX's bound: the stacked
    path runs the fused block's tanh GELU);
  * the porter: ``variables.npz`` identical to JAX's for the committed
    golden state_dict, and the self-check's logits within 1e-3 of the
    fixture's torch output.
"""

from __future__ import annotations

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu_torch.utils.jax_bridge import jax_to_state_dict

# six test workers share the host's cores: two threads a worker
torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
CAM = dict(atol=2e-5, rtol=0)


def _variables(model, example, seed):
    """A flax model's variables drawn with numpy on ``jax.eval_shape``'s
    tree: kernels at 1/sqrt(fan-in), LayerNorm/BatchNorm scales about 1,
    variances about 1, the rest at 0.05."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0)},
                            example)

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            return 1.0 + 0.1 * z
        if name == "var":
            return 1.0 + 0.1 * np.abs(z)
        if name == "kernel":
            return z * np.float32(np.prod(leaf.shape[:-1]) ** -0.5)
        return 0.05 * z

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


# ---------------------------------------------------------------------------
# Grad-CAM (tests/test_aux.py:40, :114)
# ---------------------------------------------------------------------------

def test_gradcam_resnet_matches_jax_and_overlay():
    from devt_tpu.models.resnet import resnet18 as jresnet18
    from devt_tpu.tools.gradcam import gradcam_resnet as jgradcam
    from devt_tpu.tools.gradcam import show_cam_on_image as jshow
    from devt_tpu_torch.models.resnet import resnet18
    from devt_tpu_torch.tools.gradcam import (gradcam_resnet,
                                              show_cam_on_image)

    x = np.random.default_rng(0).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    jmodel = jresnet18(output="logits", num_classes=5)
    variables = _variables(jmodel, jnp.asarray(x), 1)
    want = jgradcam(jmodel, variables, jnp.asarray(x), class_idx=1)
    model = resnet18(output="logits", num_classes=5)
    model.load_state_dict(jax_to_state_dict(variables))
    cam = gradcam_resnet(model, x, class_idx=1)
    assert cam.shape == (2, 2, 2) and cam.dtype == np.float32
    assert cam.min() >= 0.0 and cam.max() <= 1.0
    np.testing.assert_allclose(cam, np.asarray(want), **CAM)
    # a class per sample, and the model left as it was
    per = gradcam_resnet(model, x, class_idx=np.array([1, 3]))
    np.testing.assert_allclose(
        per, np.asarray(jgradcam(jmodel, variables, jnp.asarray(x),
                                 class_idx=jnp.array([1, 3]))), **CAM)
    assert model.output == "logits"

    img = np.random.default_rng(1).random((64, 64, 3)).astype(np.float32)
    overlay = show_cam_on_image(img, np.asarray(want)[0])
    assert overlay.shape == (64, 64, 3) and overlay.dtype == np.uint8
    np.testing.assert_array_equal(overlay, jshow(img, np.asarray(want)[0]))


def test_gradcam_r2plus1d_matches_jax():
    from devt_tpu.models.r2plus1d import r2plus1d_18 as jr2plus1d_18
    from devt_tpu.tools.gradcam import gradcam_r2plus1d as jgradcam
    from devt_tpu.tools.gradcam import show_cam_on_image as jshow
    from devt_tpu_torch.models.r2plus1d import r2plus1d_18
    from devt_tpu_torch.tools.gradcam import (gradcam_r2plus1d,
                                              show_cam_on_image)

    clip = np.random.default_rng(0).standard_normal(
        (1, 8, 32, 32, 3)).astype(np.float32)
    jmodel = jr2plus1d_18(output="logits", num_classes=5)
    variables = _variables(jmodel, jnp.asarray(clip), 2)
    want = np.asarray(jgradcam(jmodel, variables, jnp.asarray(clip),
                               class_idx=2))
    model = r2plus1d_18(output="logits", num_classes=5)
    model.load_state_dict(jax_to_state_dict(variables))
    cam = gradcam_r2plus1d(model, clip, class_idx=2)
    assert cam.shape == (1, 1, 2, 2)          # T 8/8, HW 32/16
    assert cam.min() >= 0.0 and cam.max() <= 1.0
    np.testing.assert_allclose(cam, want, **CAM)

    img = np.random.default_rng(1).random((32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(show_cam_on_image(img, want[0, 0]),
                                  jshow(img, want[0, 0]))


# ---------------------------------------------------------------------------
# retrieval, the projector, manifest admin (tests/test_offline_tooling.py,
# tests/test_harness_mesh.py)
# ---------------------------------------------------------------------------

def _embed_dict(path, n=30, dim=15, seed=2):
    rng = np.random.default_rng(seed)
    embed = {i: {"path": f"p{i}", "embedding": rng.standard_normal(
        dim).astype(np.float32), "predicted": ["Action"],
        "actual": ["Action"]} for i in range(n)}
    with open(path, "wb") as f:
        pickle.dump(embed, f)
    return str(path)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_retrieval_matches_jax(tmp_path, monkeypatch, route):
    from devt_tpu.tools.nearest_neighbour import RetrievalIndex as JIndex
    from devt_tpu_torch.data import native
    from devt_tpu_torch.tools.nearest_neighbour import RetrievalIndex

    path = _embed_dict(tmp_path / "embed_dict")
    if route == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip(f"native library unavailable: "
                    f"{native.unavailable_reason()}")
    index, jindex = RetrievalIndex(path), JIndex(path)
    assert index.route == route
    for q in (0, 7, 29):
        got, want = index.neighbours_of(q, k=5), jindex.neighbours_of(q, k=5)
        assert got[0][0] == q                 # self is nearest
        assert [r for r, _, _ in got] == [r for r, _, _ in want]
        np.testing.assert_allclose([d for _, d, _ in got],
                                   [d for _, d, _ in want], atol=1e-5)
        assert [d for _, d, _ in got] == sorted(d for _, d, _ in got)


def test_ann_index_save_load(tmp_path):
    from devt_tpu_torch.data import native

    if not native.available():
        pytest.skip(f"native library unavailable: "
                    f"{native.unavailable_reason()}")
    vecs = np.random.default_rng(4).standard_normal((20, 8)).astype(
        np.float32)
    index = native.AnnIndex(8)
    for i, v in enumerate(vecs):
        index.add_item(i, v)
    index.build(10)
    assert len(index) == 20
    ids, dists = index.get_nns_by_vector(vecs[3], 4, include_distances=True)
    d = np.linalg.norm(vecs - vecs[3], axis=1)
    assert ids == np.argsort(d)[:4].tolist()
    np.testing.assert_allclose(dists, np.sort(d)[:4], atol=1e-5)
    index.save(str(tmp_path / "index.bin"))
    again = native.AnnIndex.load(8, str(tmp_path / "index.bin"))
    assert again.get_nns_by_vector(vecs[3], 4) == ids
    with pytest.raises(ValueError):
        index.add_item(0, np.zeros(7))


def test_projector_export_matches_jax(tmp_path):
    from devt_tpu.tools.nearest_neighbour import RetrievalIndex as JIndex
    from devt_tpu.tools.nearest_neighbour import \
        export_projector as jexport
    from devt_tpu_torch.tools.nearest_neighbour import (RetrievalIndex,
                                                        export_projector)

    path = _embed_dict(tmp_path / "embed_dict", n=6, seed=3)
    out = export_projector(RetrievalIndex(path), str(tmp_path / "port"))
    jout = jexport(JIndex(path), str(tmp_path / "jax"))
    for name in ("vectors.tsv", "metadata.tsv", "projector_config.pbtxt"):
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(jout, name), "rb") as b:
            assert a.read() == b.read(), name
    assert open(os.path.join(out, "metadata.tsv")).read().splitlines() \
        == [f"p{i}" for i in range(6)]


def test_filter_manifest_matches_jax(tmp_path):
    from devt_tpu.data.manifests import stream_pickle as jstream
    from devt_tpu.tools.admin import filter_manifest as jfilter
    from devt_tpu_torch.data.manifests import append_pickle, stream_pickle
    from devt_tpu_torch.tools.admin import filter_manifest

    src = str(tmp_path / "in.pkl")
    for i in range(5):
        append_pickle(src, {"path": f"movie{i}", "x": i})
    keep = lambda r: "movie3" not in r["path"]  # noqa: E731
    got = filter_manifest(src, str(tmp_path / "out.pkl"), keep)
    want = jfilter(src, str(tmp_path / "jout.pkl"), keep)
    assert got == want == (4, 1)
    assert stream_pickle(str(tmp_path / "out.pkl")) \
        == jstream(str(tmp_path / "jout.pkl"))


def test_tools_cli_match_jax(tmp_path, capsys):
    from devt_tpu.tools import admin as jadmin
    from devt_tpu.tools import nearest_neighbour as jnn
    from devt_tpu_torch.data.manifests import append_pickle
    from devt_tpu_torch.tools import admin, nearest_neighbour

    src = str(tmp_path / "in.pkl")
    for i in range(4):
        append_pickle(src, {"path": f"m{i}"})
    outs = []
    for mod, dst in ((admin, "out.pkl"), (jadmin, "jout.pkl")):
        mod.main([src, str(tmp_path / dst), "--drop-path", "m2"])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "kept 3, dropped 1" in outs[0]

    ep = _embed_dict(tmp_path / "embed_dict", n=10, seed=0)
    outs = []
    for mod in (nearest_neighbour, jnn):
        mod.main([ep, "--query", "3", "--k", "4"])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "query #3" in outs[0]
    assert len([ln for ln in outs[0].splitlines()
                if ln.startswith("#")]) == 4
    for mod, d in ((nearest_neighbour, "proj"), (jnn, "jproj")):
        mod.main([ep, "--export-projector", str(tmp_path / d)])
    assert capsys.readouterr().out.count("projector export: ") == 2


# ---------------------------------------------------------------------------
# the pp checkpoint converter (tests/test_pipeline.py:368)
# ---------------------------------------------------------------------------

VIT_KW = dict(image_size=32, patch_size=16, num_classes=5, num_frames=2,
              dim=16, depth=4, heads=2, dim_head=8, channels_last=True)


def test_convert_pp_roundtrip_matches_jax_and_serves():
    from devt_tpu.models.vivit import ViViT as JViViT
    from devt_tpu.tools.convert_pp import \
        convert_vivit_params as jconvert
    from devt_tpu_torch.models.vivit import ViViT
    from devt_tpu_torch.tools.convert_pp import (convert_payload,
                                                 convert_vivit_params)

    x = np.random.default_rng(0).standard_normal(
        (2, 2, 32, 32, 3)).astype(np.float32)
    std_v = _variables(JViViT(**VIT_KW, attention_impl="xla"),
                       jnp.asarray(x), 5)
    std = jax_to_state_dict(std_v)
    stacked = convert_vivit_params(std, "stacked")
    want = jax_to_state_dict({"params": jconvert(
        dict(std_v["params"]), "stacked")})
    assert set(stacked) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(stacked[k].numpy(), v.numpy(), k)

    std_model = ViViT(**VIT_KW, attention_impl="xla").eval()
    std_model.load_state_dict(std)
    pp_model = ViViT(**VIT_KW, pipeline_stages=2).eval()
    # in a model's order, the stacked leaves where the stacked model
    # declares them (the optimizer's moment lists follow that order)
    assert list(convert_vivit_params(std_model.state_dict(), "stacked")) \
        == list(pp_model.state_dict())
    pp_model.load_state_dict(stacked)
    with torch.no_grad():
        y_std = std_model(torch.tensor(x))
        y_pp = pp_model(torch.tensor(x))
    np.testing.assert_allclose(y_pp.numpy(), y_std.numpy(), rtol=0,
                               atol=3e-3)

    back = convert_vivit_params(stacked, "standard")
    assert set(back) == set(std)
    ordered = std_model.state_dict()
    assert list(convert_vivit_params(convert_vivit_params(
        ordered, "stacked"), "standard")) == list(ordered)
    for k, v in std.items():
        assert torch.equal(back[k], v), k
    assert convert_vivit_params(stacked, "stacked") is stacked
    # the walker reaches parameters under wrappers, and moment lists that
    # mirror the parameters by position
    wrapped = {"params": std, "opt_state": [
        {"mu": list(std.values()), "count": torch.tensor(3)}],
        "step": 3}
    conv = convert_payload(wrapped, "stacked")
    assert list(conv["params"]) == list(stacked)
    for got, k in zip(conv["opt_state"][0]["mu"], stacked):
        assert torch.equal(got, stacked[k]), k
    assert int(conv["opt_state"][0]["count"]) == 3 and conv["step"] == 3


def test_convert_pp_cli_resumes_in_the_stacked_layout(tmp_path, capsys):
    """A standard ViViT trained one step and checkpointed
    (``train/checkpoint.py``) converts on the command line; the stacked
    model restores it (parameters and AdamW's moments) and the standard
    one restores the converse."""
    from devt_tpu_torch.config import Config
    from devt_tpu_torch.models.vivit import ViViT
    from devt_tpu_torch.parallel.train_step import make_train_step
    from devt_tpu_torch.tools import convert_pp
    from devt_tpu_torch.train import checkpoint
    from devt_tpu_torch.train.optimizers import build_optimizer
    from devt_tpu_torch.train.state import TrainState

    cfg = Config(model="vivit", batch_size=2, frame_len=2, n_classes=5,
                 precision="f32", dropout=0.0, opt="adamW",
                 learning_rate=1e-3)

    def fresh(**kw):
        model = ViViT(**VIT_KW, **kw).init_weights(
            torch.Generator().manual_seed(1))
        return model, TrainState.create(dict(model.named_parameters()),
                                        build_optimizer(cfg))

    model, state = fresh(attention_impl="xla")
    rng = np.random.default_rng(1)
    batch = {"vid": rng.standard_normal((2, 2, 32, 32, 3),
                                        dtype=np.float32),
             "label": (rng.random((2, 5)) < 0.4).astype(np.float32)}
    state, _ = make_train_step(model, cfg, device="cpu")(state, batch, 0)
    checkpoint.save(str(tmp_path / "ck"), state, cfg)
    convert_pp.main(["--src", str(tmp_path / "ck" / "step_1"),
                     "--dst", str(tmp_path / "pp")])
    assert "wrote stacked layout" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "pp")) == ["config.yaml", "step_1"]
    _, pp_state = fresh(pipeline_stages=2)
    checkpoint.restore(str(tmp_path / "pp" / "step_1"), pp_state)
    want = convert_pp.convert_payload(
        checkpoint.load(str(tmp_path / "ck" / "step_1")), "stacked")
    for k, v in want["params"].items():
        assert torch.equal(pp_state.params[k], v), k
    mu = [m for m in pp_state.opt_state if isinstance(m, dict)
          and "mu" in m][0]["mu"]
    assert [tuple(m.shape) for m in mu] == [tuple(p.shape) for p in
                                            pp_state.params.values()]
    convert_pp.main(["--src", str(tmp_path / "pp" / "step_1"), "--dst",
                     str(tmp_path / "back"), "--to", "standard"])
    back = checkpoint.load(str(tmp_path / "back" / "step_1"))
    for k, v in checkpoint.load(str(tmp_path / "ck" / "step_1"))[
            "params"].items():
        assert torch.equal(back["params"][k], v), k


# ---------------------------------------------------------------------------
# the checkpoint porter's file tools and command line
# ---------------------------------------------------------------------------

def test_torch_port_cli_writes_jax_file_and_selfchecks(tmp_path, capsys):
    from devt_tpu.utils import torch_port as jport
    from devt_tpu_torch.utils import torch_port

    ckpt = os.path.join(FIXTURES, "golden_resnet.npz")
    args = ["--ckpt", ckpt, "--arch", "resnet", "--layers", "1,1,1,1"]
    jport.main(args + ["--out", str(tmp_path / "jax")])
    torch_port.main(args + ["--out", str(tmp_path / "port"), "--selfcheck",
                            "--device", "cpu"])
    out = capsys.readouterr().out
    assert "selfcheck: forward OK on cpu, output shape (2, 16), logit " \
        "parity max rel err" in out
    a = np.load(tmp_path / "port" / "variables.npz")
    b = np.load(tmp_path / "jax" / "variables.npz")
    assert a.files == b.files
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], k)
    # either package's file loads in the other
    got = torch_port.load_variables(str(tmp_path / "jax" / "variables.npz"))
    want = jport.load_variables(str(tmp_path / "port" / "variables.npz"))
    flat_got, flat_want = (torch_port._flatten_tree(got["params"]),
                           jport._flatten_tree(want["params"]))
    assert flat_got.keys() == flat_want.keys()
    for k in flat_got:
        np.testing.assert_array_equal(flat_got[k], flat_want[k], k)
    assert torch_port._unflatten_tree(torch_port._flatten_tree(got)) \
        .keys() == got.keys()


def test_torch_port_selfcheck_on_r2plus1d_golden(capsys):
    from devt_tpu_torch.utils import torch_port

    ckpt = os.path.join(FIXTURES, "golden_r2plus1d.npz")
    sd = torch_port._load_state_dict(ckpt)
    variables = torch_port.r2plus1d(sd, layers=(1, 1, 1, 1))
    out = torch_port._selfcheck("r2plus1d_18", (1, 1, 1, 1), variables,
                                ckpt, device="cpu")
    assert out.shape == (1, 16)
    assert "logit parity" in capsys.readouterr().out
