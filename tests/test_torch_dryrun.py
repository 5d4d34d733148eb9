"""The port's dry run, entry point and example journeys, on the CPU.

``dryrun_multichip(4, device="cpu")`` starts four Gloo ranks of
``python -m devt_tpu_torch.dryrun`` (no JAX in them; a file rendezvous in
a temporary directory) and runs the eleven legs of JAX's
``__graft_entry__.dryrun_multichip`` through the port's executors; at
four ranks every leg has its axis (3-D 1x2x2, the sp trainer 1x4).  The
examples' training journeys hand ``devt_tpu_torch.main`` the arguments
that ``examples/*.py`` hand ``devt_tpu.main`` (read from their source),
and ``serve_from_checkpoint`` runs end to end: train, checkpoint, serve,
export, and the exported program's scores equal the live ones within
1e-5, JAX's example's bound.
"""

from __future__ import annotations

import ast
import importlib
import os
import pathlib
import py_compile

import numpy as np
import pytest
import torch

from devt_tpu_torch import dryrun

# six test workers share the host's cores: two threads a worker
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("train_vivit_synthetic", "train_ptn_experts",
            "contrastive_pretrain", "serve_from_checkpoint",
            "scale_parallelism")


def test_dryrun_multichip_runs_the_eleven_legs(capsys):
    summary = dryrun.dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out.splitlines()
    legs = [ln for ln in out if ln.startswith("[dryrun] leg")]
    assert [ln.split()[1] for ln in legs] == [f"leg{i}" for i in
                                              range(1, 12)]
    assert all(ln.split()[3] == "done" for ln in legs)
    assert out[-1] == summary and summary.endswith(" OK")
    assert summary.startswith("dryrun_multichip(4): mesh=(2,2) ")
    for part in ("dp_pp_tp_3d(1x2x2)", "sp_trainer(dp=1,sp=4)",
                 "pp_trainer(dp=2,pp=2)", "moe_ep_trainer(dp=4,E=4)"):
        assert part in summary
    losses = [float(w.split("=")[1]) for w in summary.split()
              if w.startswith("loss=")]
    assert len(losses) == 11 and np.isfinite(losses).all()
    # the ranks' kernels' launches, summed: none on the CPU, where the
    # wrappers run the plain versions
    assert dryrun.dryrun_multichip.launches == {
        f"k{i}": 0 for i in range(1, 16) if i != 6}


def test_entry_returns_the_vivit_forward():
    """``entry`` builds ViViT at 224², 16 frames, bf16, B = 2 (not run
    here: that is the card's size, which ``chip_smoke.py``'s phase 39
    runs); without a card it needs ``device="cpu"``."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.entry()
    fn, (params, clip) = dryrun.entry(device="cpu")
    assert callable(fn)
    assert clip.shape == (2, 16, 3, 224, 224)
    assert clip.dtype == torch.bfloat16
    assert params["pos_embedding"].shape[-1] == 192
    assert len([k for k in params if k.startswith(
        "space_transformer.blocks.")]) == 4 * 11


def _jax_example_args(name: str) -> list[str]:
    """The list ``examples/<name>.py`` hands ``main``."""
    tree = ast.parse((ROOT / "examples" / f"{name}.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") \
                == "main" and node.args:
            return ast.literal_eval(node.args[0])
    raise AssertionError(f"no main([...]) call in examples/{name}.py")


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_compile_and_import(name):
    path = ROOT / "devt_tpu_torch" / "examples" / f"{name}.py"
    py_compile.compile(str(path), doraise=True)
    mod = importlib.import_module(f"devt_tpu_torch.examples.{name}")
    assert callable(mod.main)


@pytest.mark.parametrize("name", ["train_vivit_synthetic",
                                  "train_ptn_experts",
                                  "contrastive_pretrain"])
def test_training_examples_take_jax_arguments(name, monkeypatch):
    from devt_tpu_torch import main as entry

    mod = importlib.import_module(f"devt_tpu_torch.examples.{name}")
    seen = []
    monkeypatch.setattr(entry, "main",
                        lambda argv, device=None: seen.append((argv, device)))
    mod.main(["--max_steps", "1"], device="cpu")
    (argv, device), = seen
    assert device == "cpu"
    want = _jax_example_args(name)
    i = want.index("--checkpoint_dir")
    assert argv[:i] == want[:i] + want[i + 2:]
    assert argv[i] == "--checkpoint_dir"
    assert argv[-2:] == ["--max_steps", "1"]


def test_scale_parallelism_runs_the_dryrun_at_eight(monkeypatch, capsys):
    from devt_tpu_torch.examples import scale_parallelism

    calls = []
    monkeypatch.setattr(dryrun, "dryrun_multichip",
                        lambda n, device=None: calls.append((n, device)))
    scale_parallelism.main(device="cpu")
    assert calls == [(8, "cpu")]
    assert "all eleven parallelism legs" in capsys.readouterr().out


def test_serve_from_checkpoint_end_to_end(tmp_path, monkeypatch, capsys):
    from devt_tpu_torch.examples import serve_from_checkpoint

    monkeypatch.chdir(tmp_path)
    live, aot = serve_from_checkpoint.main(
        ["--workdir", str(tmp_path / "w")], device="cpu")
    assert live.shape == (3, 15) and aot.shape == (4, 15)
    np.testing.assert_allclose(aot[:3], live, atol=1e-5)
    out = capsys.readouterr().out
    assert "the exported program reproduces the live scores" in out
    assert os.path.exists(tmp_path / "w" / "model.pt2")
