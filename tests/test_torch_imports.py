"""The port stands alone: no JAX, no devt_tpu, no scikit-learn or pandas
(the card's machine has neither), its own config copy."""

import ast
import dataclasses
import pathlib

import pytest

from devt_tpu import config as jconfig
from devt_tpu_torch import config as tconfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "sklearn", "pandas")
PORT_FILES = sorted((ROOT / "devt_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    root = name.split(".")[0]
    return root in FORBIDDEN or root == "devt_tpu"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_no_devt_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_walk_covers_the_training_slice():
    """The walk globs the package, so new directories are picked up; pin
    the ones the training slice added."""
    walked = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for rel in ("devt_tpu_torch/train/steps.py",
                "devt_tpu_torch/train/optimizers.py",
                "devt_tpu_torch/train/state.py",
                "devt_tpu_torch/parallel/train_step.py",
                "devt_tpu_torch/models/losses.py",
                "devt_tpu_torch/ops/fused_block.py",
                "devt_tpu_torch/ops/_build.py", "chip_smoke.py",
                # the int8 serving slice
                "devt_tpu_torch/ops/quant.py",
                "devt_tpu_torch/ops/flash_attention.py",
                "devt_tpu_torch/ops/attention.py",
                "devt_tpu_torch/models/torch_encoder.py",
                "devt_tpu_torch/models/ptn.py",
                "devt_tpu_torch/serve.py", "devt_tpu_torch/registry.py",
                # the MoE slice
                "devt_tpu_torch/parallel/moe.py",
                # the ring attention slice
                "devt_tpu_torch/parallel/ring_attention.py",
                # the FrameTransformer slice
                "devt_tpu_torch/models/frame_transformer.py",
                "devt_tpu_torch/models/resnet.py",
                "devt_tpu_torch/models/r2plus1d.py",
                "devt_tpu_torch/models/contrastive.py",
                # the rest of the model family
                "devt_tpu_torch/models/tpn.py",
                "devt_tpu_torch/models/lstm.py",
                "devt_tpu_torch/models/basicmlp.py",
                "devt_tpu_torch/models/collab_gating.py",
                "devt_tpu_torch/models/pretrained.py",
                # the harness, the entry point and the host data
                "devt_tpu_torch/main.py",
                "devt_tpu_torch/train/harness.py",
                "devt_tpu_torch/train/checkpoint.py",
                "devt_tpu_torch/train/metrics.py",
                "devt_tpu_torch/train/callbacks.py",
                "devt_tpu_torch/train/loggers.py",
                "devt_tpu_torch/train/profiling.py",
                "devt_tpu_torch/data/pipeline.py",
                "devt_tpu_torch/data/manifests.py",
                "devt_tpu_torch/data/samplers.py",
                "devt_tpu_torch/data/synthetic.py",
                "devt_tpu_torch/data/mmx_temporal.py",
                "devt_tpu_torch/data/mit_temporal.py",
                "devt_tpu_torch/data/contrastive.py",
                "devt_tpu_torch/data/transforms.py"):
        assert rel in walked, rel


def test_kernel_sources_build_alone_with_a_plain_c_interface():
    """``_build`` makes one library per ``csrc/*.cu``: the kernels'
    sources, the MoE slice's attention half, the split-q/k/v attention
    (kernels 9 and 11; 10, 12 and 13) and the ring hop (kernels 14 and 15)
    among them, each with its ``extern "C"`` entry points and none with
    PyTorch's headers (which would make nvcc take minutes instead of
    seconds)."""
    from devt_tpu_torch.ops import _build

    stems = {p.stem for p in _build.sources()}
    assert stems == {"fused_block_fwd", "fused_block_bwd", "quant_block_fwd",
                     "int8_matmul", "mha_fwd", "mha_bwd", "attn_half",
                     "flash_fwd", "flash_bwd", "ring_step"}
    for path in _build.CSRC.iterdir():
        text = path.read_text()
        assert "torch/" not in text and "ATen" not in text, path.name
        if path.suffix == ".cu":
            assert 'extern "C"' in text and "sm_90a" in text, path.name


def test_step_executors_need_a_card_unless_the_cpu_is_asked_for():
    """``device=None`` means the card and raises without one;
    ``device="cpu"`` runs the plain path."""
    import numpy as np
    import torch

    from devt_tpu_torch.models.vivit import ViViT
    from devt_tpu_torch.parallel import train_step as tts
    from devt_tpu_torch.train.optimizers import build_optimizer
    from devt_tpu_torch.train.state import TrainState

    cfg = tconfig.Config(model="vivit", precision="f32", n_classes=3,
                         frame_len=2)
    model = ViViT(image_size=16, patch_size=8, num_classes=3, num_frames=2,
                  dim=32, depth=1, heads=2, dim_head=16, channels_last=True) \
        .init_weights(torch.Generator().manual_seed(0))
    if not torch.cuda.is_available():
        for make in (tts.make_train_step, tts.make_eval_step):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make(model, cfg, device=None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tts.make_multi_step(model, cfg, 2)
    state = TrainState.create(dict(model.named_parameters()),
                              build_optimizer(cfg))
    rng = np.random.default_rng(0)
    batch = {"vid": rng.standard_normal((2, 2, 16, 16, 3)).astype(np.float32),
             "label": np.eye(3, dtype=np.float32)[:2]}
    state, metrics = tts.make_train_step(model, cfg, device="cpu")(
        state, batch, 0)
    assert state.step == 1 and torch.isfinite(metrics["loss"])
    assert state.device.type == "cpu"


def test_forbidden_matcher():
    assert _forbidden("jax.numpy") and _forbidden("devt_tpu.ops")
    assert _forbidden("orbax.checkpoint") and _forbidden("devt_tpu")
    assert _forbidden("sklearn.metrics") and _forbidden("pandas")
    assert not _forbidden("devt_tpu_torch.ops") and not _forbidden("torch")


def test_config_copy_has_the_same_keys_and_defaults():
    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    assert fields(tconfig.Config) == fields(jconfig.Config)
    assert tconfig.MMX_GENRES_19 == jconfig.MMX_GENRES_19
    assert tconfig.MMX_GENRES_15 == jconfig.MMX_GENRES_15


def test_config_loads_the_repo_yaml_like_jax():
    path = str(ROOT / "config.yaml")
    assert tconfig.Config.from_yaml(path).to_dict() \
        == jconfig.Config.from_yaml(path).to_dict()


@pytest.mark.parametrize("bad", [dict(attention_impl="flash"),
                                 dict(precision="fp8"),
                                 dict(wire_format="u8_tokens", model="ptn")])
def test_config_validation_matches_jax(bad):
    with pytest.raises(ValueError):
        jconfig.Config(**bad)
    with pytest.raises(ValueError):
        tconfig.Config(**bad)
