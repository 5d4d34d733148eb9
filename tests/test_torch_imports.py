"""The port stands alone: no JAX, no devt_tpu, its own config copy."""

import ast
import dataclasses
import pathlib

import pytest

from devt_tpu import config as jconfig
from devt_tpu_torch import config as tconfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax")
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


def test_forbidden_matcher():
    assert _forbidden("jax.numpy") and _forbidden("devt_tpu.ops")
    assert _forbidden("orbax.checkpoint") and _forbidden("devt_tpu")
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
