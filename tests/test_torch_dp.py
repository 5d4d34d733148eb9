"""The port's data parallelism against the JAX package's, on the CPU.

The port runs one process a rank: two ranks join a Gloo group through a
file in the test's temporary directory (``parallel.distributed.
initialize``) and run this file as their script (``python
tests/test_torch_dp.py <spawn> <rank> ...``, which imports no JAX), while
the test process computes the JAX package's ``dp_shard_map`` step on two
of the eight virtual CPU devices with the same weights
(``utils.jax_bridge``) and global batches.  The ranks are started twice in
the file: once for the step executors, once for serving, the data rows
and the entry point.

Cases, mirroring ``tests/test_training.py``'s ``test_dp_*`` and
``tests/test_serve.py``'s mesh test, and their tolerances:

  * PTN (width 64, f32, AdamW): the loss within rtol 1e-6 of JAX's, the
    parameters within rtol 5e-3 / atol 5e-5 (JAX's own bounds of its DP
    step against its one-device step: Adam's first step is about
    ``learning_rate`` times the gradient's sign, so gradients that differ
    by rounding move a parameter by up to that); the key third of each
    ``in_proj.bias`` has an exact gradient of 0 and is held within one
    step of 0 instead (``test_torch_train_ptn.py``); ``accum_steps=2``;
    ``make_multi_step(2)`` against two steps, within rtol 1e-6 / atol 1e-7
    (JAX's bound);
  * the contrastive encoder with global negatives and synced BatchNorm
    (SGD at rate 0.5, so that a gradient off by a factor of the world
    size shows in the parameters): the loss within rtol 1e-5, the
    parameters and the BatchNorm statistics within rtol 1e-5 / atol 1e-6,
    the eval loss within rtol 1e-5 and its gathered embeddings within
    rtol 1e-5 / atol 1e-6;
  * BasicMLP, whose BatchNorm keeps per-rank statistics and averages the
    running ones: loss within rtol 1e-6, statistics and parameters within
    rtol 1e-5 / atol 1e-6;
  * a tiny ViViT on the fused-block route (the kernels' plain versions):
    the train step's loss and the eval step's loss and gathered ``probs``
    within the port's ViViT bounds against JAX (atol 2e-5 / rtol 2e-4),
    the parameters after one AdamW step within atol 2e-5 / rtol 5e-4, the
    labels equal;
  * the ranks' parameters bit for bit equal after every step;
  * a mesh of one rank: the single-device step bit for bit, at dropout
    0.1;
  * ``Predictor(mesh)``: buckets rounded up to the data axis, f32 scores
    within JAX's atol 2e-5 / rtol 2e-4, int8 within 2e-2 of JAX's (the
    int8 flips of ``test_torch_serve_quant.py``) and equal to the port's
    one-process int8 predictor to 1e-6;
  * ``shard_batch`` and the ``Loader``'s per-rank rows: the ranks' rows
    concatenated are the one-process batch, over an epoch and a resume;
  * ``main --dp 2`` on ``synthetic``: rank 0 writes the checkpoint and the
    log, the run resumes from it, and ends on the one-process run's
    parameters (SGD) within rtol 1e-5 / atol 1e-7; the refusals of a
    world whose mesh cannot engage;
  * in the test process: ``make_mesh`` and ``mesh_strategy`` on every
    mesh shape against JAX's, the refusals of the strategies not ported
    (item 7c), the entry point's mesh rule.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

from devt_tpu_torch import registry as treg  # noqa: E402
from devt_tpu_torch.config import Config as TConfig  # noqa: E402
from devt_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from devt_tpu_torch.parallel import train_step as tts  # noqa: E402
from devt_tpu_torch.train import optimizers as topt  # noqa: E402
from devt_tpu_torch.train.state import TrainState, model_buffers  # noqa: E402

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

PTN = dict(model="ptn", seq_len=4, nlayers=1, input_dimension=64, nhid=64,
           nhead=2, dropout=0.0, n_classes=15, experts=("a", "b"),
           learning_rate=1e-3, opt="adamW", precision="f32",
           attention_impl="xla")
# scheduling off: the contrastive warmup's first rate is 0
CON = dict(model="contrastive", input_shape=16, hidden_layer=8,
           projection_size=8, output_shape=4, precision="f32", opt="sgd",
           learning_rate=0.5, dropout=0.0, scheduling=False)
CON_KW = dict(input_shape=16, hidden_layer=8, projection_size=8,
              output_shape=4, dropout=0.0)
MLP = dict(model="basicmlp", input_shape=48, token_embedding=11,
           precision="f32", opt="sgd", learning_rate=0.5)
VIVIT_KW = dict(image_size=32, patch_size=8, num_classes=5, num_frames=4,
                dim=32, depth=2, heads=2, dim_head=16, channels_last=True)
VIVIT = dict(model="vivit", precision="f32", opt="adamW", learning_rate=1e-3,
             weight_decay=0.09, n_classes=5, frame_len=4, dropout=0.0)
SERVE = dict(model="ptn", batch_size=2, seq_len=3, nlayers=1,
             input_dimension=32, nhid=32, nhead=2, n_classes=15, dropout=0.0,
             precision="f32", attention_impl="xla", experts=("a", "b"))
MAIN = ["--model", "ptn", "--data_set", "synthetic", "--batch_size", "4",
        "--seq_len", "3", "--nlayers", "1", "--input_dimension", "32",
        "--nhid", "32", "--nhead", "2", "--n_classes", "15", "--precision",
        "f32", "--experts", "a,b", "--attention_impl", "xla", "--dropout",
        "0.0", "--opt", "sgd", "--learning_rate", "0.1", "--log_every", "1",
        "--epochs", "1", "--save_path", "out"]
MOE_EP_MAIN = ["--dp", "2", "--moe_experts", "2", "--moe_ep", "true",
               "--max_steps", "1", "--name", "ep", "--checkpoint_dir",
               "ck_ep"]
LOADER_ROWS, LOADER_BATCH = 37, 8
SEED = 0

PTN_LOSS, PARAM_TOL = 1e-6, dict(rtol=5e-3, atol=5e-5)
SGD_TOL = dict(rtol=1e-5, atol=1e-6)
VIVIT_FWD, VIVIT_PARAMS = dict(atol=2e-5, rtol=2e-4), dict(atol=2e-5,
                                                           rtol=5e-4)
SCORE_TOL, FLIP_TOL = dict(atol=2e-5, rtol=2e-4), dict(atol=2e-2, rtol=0)


# ---------------------------------------------------------------------------
# the ranks (this file as their script: no JAX)
# ---------------------------------------------------------------------------

def _sd(a: dict, prefix: str) -> dict:
    return {k[len(prefix):]: torch.tensor(v) for k, v in a.items()
            if k.startswith(prefix)}


def _batch(a: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in a.items() if k.startswith(prefix)}


def _model(name: str, a: dict):
    from devt_tpu_torch.models.basicmlp import BasicMLP
    from devt_tpu_torch.models.contrastive import ContrastiveEncoder
    from devt_tpu_torch.models.vivit import ViViT

    if name == "ptn":
        model = treg.build_model(TConfig(**PTN))
    elif name == "con":
        model = ContrastiveEncoder(**CON_KW)
    elif name == "mlp":
        model = BasicMLP(48, 24, 11)
    else:
        model = ViViT(attention_impl="auto", **VIVIT_KW)
    model.load_state_dict(_sd(a, f"{name}::w::"))
    return model


def _state(model, cfg) -> TrainState:
    return TrainState.create(dict(model.named_parameters()),
                             topt.build_optimizer(cfg),
                             model_state=model_buffers(model))


def _record(out: dict, tag: str, state: TrainState, metrics=None) -> None:
    for k, v in {**state.params, **state.model_state}.items():
        out[f"{tag}::p::{k}"] = v.detach().numpy().copy()
    if metrics is not None:
        out[f"{tag}::loss"] = np.float32(metrics["loss"])


def _spawn_train(a: dict, rank: int) -> dict:
    from devt_tpu_torch.models import layers

    mesh = tmesh.make_mesh(dp=2)
    out = {}
    # PTN: a step, accumulation over 2 microbatches, 2 steps in one call
    for tag, accum in (("ptn", 1), ("ptn_accum", 2)):
        cfg = TConfig(**PTN, accum_steps=accum)
        model = _model("ptn", a)
        step = tts.make_train_step(model, cfg, mesh=mesh, device="cpu")
        state, metrics = step(_state(model, cfg), tmesh.shard_batch(
            _batch(a, f"{tag}::b::"), mesh), SEED)
        _record(out, tag, state, metrics)
    cfg = TConfig(**PTN)
    batches = _batch(a, "multi::b::")
    separate, fused = _model("ptn", a), _model("ptn", a)
    state = _state(separate, cfg)
    step = tts.make_train_step(separate, cfg, mesh=mesh, device="cpu")
    for i in range(2):
        state, _ = step(state, tmesh.shard_batch(
            {k: v[i] for k, v in batches.items()}, mesh), SEED)
    _record(out, "separate", state)
    multi = tts.make_multi_step(fused, cfg, 2, mesh=mesh, device="cpu")
    state, metrics = multi(_state(fused, cfg), {
        k: np.stack([tmesh.shard_batch({k: v[i]}, mesh)[k]
                     for i in range(2)]) for k, v in batches.items()}, SEED)
    _record(out, "multi", state, metrics)
    out["multi::step"] = np.int64(state.step)

    # the contrastive encoder: train, then eval on the initial weights
    cfg = TConfig(**CON)
    batch = tmesh.shard_batch(_batch(a, "con::b::"), mesh)
    model = _model("con", a)
    for k, v in model.state_dict().items():
        out[f"con::w0::{k}"] = v.numpy().copy()
    state, metrics = tts.make_train_step(model, cfg, mesh=mesh,
                                         device="cpu")(_state(model, cfg),
                                                       batch, SEED)
    _record(out, "con", state, metrics)
    out["con::sync_after"] = np.array(model.bn_sync_axis is None)
    model = _model("con", a)
    loss, aux = tts.make_eval_step(model, cfg, mesh=mesh, device="cpu")(
        _state(model, cfg), batch)
    out["con_eval::loss"] = loss.numpy()
    out["con_eval::embedding"] = aux["embedding"].numpy()
    out["con_eval::label"] = aux["label"].numpy()

    # BasicMLP: per-rank batch statistics, running ones averaged
    cfg = TConfig(**MLP)
    model = _model("mlp", a)
    state, metrics = tts.make_train_step(model, cfg, mesh=mesh,
                                         device="cpu")(
        _state(model, cfg), tmesh.shard_batch(_batch(a, "mlp::b::"), mesh),
        SEED)
    _record(out, "mlp", state, metrics)

    # ViViT on the fused block (its plain versions), counted by a spy
    calls = []
    real = layers.fused_vit_block

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    layers.fused_vit_block = spy
    try:
        cfg = TConfig(**VIVIT)
        batch = tmesh.shard_batch(_batch(a, "vivit::b::"), mesh)
        model = _model("vivit", a)
        state, metrics = tts.make_train_step(model, cfg, mesh=mesh,
                                             device="cpu")(
            _state(model, cfg), batch, SEED)
        _record(out, "vivit", state, metrics)
        model = _model("vivit", a)
        loss, aux = tts.make_eval_step(model, cfg, mesh=mesh, device="cpu")(
            _state(model, cfg), batch)
        out["vivit_eval::loss"] = loss.numpy()
        out["vivit_eval::probs"] = aux["probs"].numpy()
        out["vivit_eval::label"] = aux["label"].numpy()
    finally:
        layers.fused_vit_block = real
    out["vivit::fused_calls"] = np.int64(len(calls))

    # a mesh of one rank (rank 1 is outside it) runs the one-device step
    one = tmesh.make_mesh(dp=1)
    cfg = TConfig(**{**PTN, "dropout": 0.1})
    got = []
    for m in (one, None):
        model = treg.build_model(cfg)
        model.load_state_dict(_sd(a, "ptn::w::"))
        state, metrics = tts.make_train_step(model, cfg, mesh=m,
                                             device="cpu")(
            _state(model, cfg), _batch(a, "ptn::b::"), SEED)
        got.append([metrics["loss"], *state.params.values()])
    out["one::strategy"] = np.array(tts.mesh_strategy(one, cfg))
    out["one::equal"] = np.array(all(torch.equal(x, y)
                                     for x, y in zip(*got)))
    return out


class _Rows:
    """A dataset whose item is its index."""

    def __len__(self):
        return LOADER_ROWS

    def __getitem__(self, i):
        return {"i": np.int64(i), "x": np.float32(i) / 2}


def _loader_rows(index: int, count: int) -> dict:
    from devt_tpu_torch.data.pipeline import Loader

    out = {}
    for epoch, skip in ((0, 0), (2, 1)):
        loader = Loader(_Rows(), LOADER_BATCH, shuffle=True, seed=3,
                        num_workers=2)
        if count > 1:
            loader.shard_rows(index, count)
        loader.set_epoch(epoch, skip)
        out[f"rows::{epoch}"] = np.stack([b["i"] for b in loader])
    return out


def _spawn_serve(a: dict, rank: int, workdir: str) -> dict:
    from devt_tpu_torch import main as tmain
    from devt_tpu_torch.serve import Predictor

    mesh = tmesh.make_mesh(dp=2)
    out = {}
    sd, request = _sd(a, "serve::w::"), {"experts": a["serve::x"]}
    for tag, quantize in (("f32", False), ("int8", True)):
        pred = Predictor(TConfig(**SERVE), sd, buckets=(1, 4), mesh=mesh,
                         quantize=quantize, device="cpu")
        out[f"serve::{tag}::buckets"] = np.array(pred.buckets)
        out[f"serve::{tag}"] = pred.predict(request)["scores"]
        out[f"serve::{tag}::one"] = Predictor(
            TConfig(**SERVE), sd, buckets=(1, 4), quantize=quantize,
            device="cpu").predict(request)["scores"]

    ax = mesh.axes()[tmesh.DATA_AXIS]
    out.update(_loader_rows(ax.index, ax.size))
    shard = tmesh.shard_batch({"a": np.arange(12).reshape(6, 2),
                               "t": torch.arange(6),
                               "path": [f"p{i}" for i in range(6)]}, mesh)
    out["shard::a"], out["shard::t"] = shard["a"], shard["t"].numpy()
    out["shard::path"] = np.array(shard["path"])

    os.chdir(workdir)
    try:
        tmain.main(MAIN + ["--dp", "2", "--name", "bad", "--checkpoint_dir",
                           "ck_bad", "--batch_size", "3"], device="cpu")
    except ValueError as e:
        out["refused::ValueError"] = np.array(str(e))
    # expert parallelism is ported: --moe_ep on the data axis runs (PTN has
    # no MoE block, so the flags change nothing in its step)
    out["moe_ep::loss"] = np.array(tmain.main(MAIN + MOE_EP_MAIN,
                                              device="cpu")["test/loss"])
    first = tmain.main(MAIN + ["--dp", "2", "--max_steps", "2", "--name",
                               "dp", "--checkpoint_dir", "ck"], device="cpu")
    resumed = tmain.main(MAIN + ["--dp", "2", "--max_steps", "3", "--name",
                                 "dp2", "--checkpoint_dir", "ck2",
                                 "--resume", "ck/step_2"], device="cpu")
    out["main::loss"] = np.array([first["test/loss"], resumed["test/loss"]])
    return out


def _worker(spawn: str, rank: int, init: str, src: str, dst: str,
            workdir: str) -> None:
    import torch.distributed as dist

    from devt_tpu_torch.parallel import distributed

    # several test workers share the host's cores: one thread a rank
    torch.set_num_threads(1)
    assert distributed.initialize(f"file://{init}", 2, rank)
    a = dict(np.load(src))
    out = (_spawn_train(a, rank) if spawn == "train"
           else _spawn_serve(a, rank, workdir))
    out["runtime::backend"] = np.array(distributed.runtime_info()["backend"])
    np.savez(dst, **out)
    dist.barrier()          # neither rank leaves while the other still talks
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the test process: JAX's side, and the ranks started beside it
# ---------------------------------------------------------------------------

def _start(spawn: str, tmp: pathlib.Path, arrays: dict):
    np.savez(tmp / "in.npz", **arrays)
    (tmp / "work").mkdir(exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(key, None)
    return [subprocess.Popen(
        [sys.executable, __file__, spawn, str(r), str(tmp / "init"),
         str(tmp / "in.npz"), str(tmp / f"out{r}.npz"), str(tmp / "work")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]


def _finish(procs, tmp: pathlib.Path, timeout: float = 300.0) -> list[dict]:
    logs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(2)]


def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(prefix: str, variables) -> dict:
    from devt_tpu_torch.utils.jax_bridge import jax_to_state_dict
    return {prefix + k: v.numpy()
            for k, v in jax_to_state_dict(_np(variables)).items()}


def _jstate(params, cfg, model_state=None):
    from devt_tpu.train.optimizers import build_optimizer
    from devt_tpu.train.state import TrainState as JTrainState
    import jax
    # copies: the JAX step donates its state
    params, model_state = jax.tree_util.tree_map(
        lambda x: np.array(x), (params, model_state or {}))
    return JTrainState.create(params, build_optimizer(cfg),
                              model_state=model_state)


def _put(prefix: str, batch: dict) -> dict:
    return {prefix + k: v for k, v in batch.items()}


@pytest.fixture(scope="module")
def train_world(tmp_path_factory):
    """JAX's DP steps on two virtual devices, and both ranks' results."""
    import jax
    import jax.numpy as jnp

    from devt_tpu.config import Config as JConfig
    from devt_tpu.models.basicmlp import BasicMLP as JBasicMLP
    from devt_tpu.models.contrastive import ContrastiveEncoder as JEncoder
    from devt_tpu.models.vivit import ViViT as JViViT
    from devt_tpu.parallel import mesh as jmesh
    from devt_tpu.parallel import train_step as jts
    from devt_tpu.registry import build_model as jbuild

    tmp = tmp_path_factory.mktemp("dp_train")
    rng = np.random.default_rng(21)

    def ptn_batch(b):
        return {"experts": rng.standard_normal((b, 4, 2, 64),
                                               dtype=np.float32),
                "label": (rng.random((b, 15)) < 0.3).astype(np.float32)}

    # jitted inits: flax traces the interpreted kernels eagerly otherwise
    key = {"params": jax.random.PRNGKey(0)}
    jptn = jbuild(JConfig(**PTN))
    ptn_v = jax.jit(jptn.init)(key, jnp.zeros((1, 4, 2, 64)))
    jcon = JEncoder(**CON_KW)
    con_b = {"x_i": rng.standard_normal((8, 16), dtype=np.float32),
             "x_j": rng.standard_normal((8, 16), dtype=np.float32),
             "label": np.zeros((8, 1), np.float32)}
    con_v = dict(jax.jit(jcon.init, static_argnames="train")(
        key, jnp.asarray(con_b["x_i"]), train=False))
    jmlp = JBasicMLP(48, 24, 11)
    mlp_b = {"experts": rng.standard_normal((8, 48), dtype=np.float32),
             "label": rng.integers(0, 11, 8).astype(np.int32)}
    mlp_v = dict(jax.jit(jmlp.init)(key, jnp.asarray(mlp_b["experts"])))
    jvivit = JViViT(attention_impl="fused_interpret", **VIVIT_KW)
    vivit_v = jax.jit(jvivit.init)(key, jnp.zeros((1, 4, 32, 32, 3)))
    vivit_b = {"vid": rng.standard_normal((4, 4, 32, 32, 3),
                                          dtype=np.float32),
               "label": (rng.random((4, 5)) < 0.3).astype(np.float32)}
    batches = {"ptn": ptn_batch(8), "ptn_accum": ptn_batch(16)}
    multi = [ptn_batch(8) for _ in range(2)]
    multi_b = {k: np.stack([m[k] for m in multi]) for k in multi[0]}
    arrays = {**_flat("ptn::w::", ptn_v), **_flat("con::w::", con_v),
              **_flat("mlp::w::", mlp_v), **_flat("vivit::w::", vivit_v),
              **_put("ptn::b::", batches["ptn"]),
              **_put("ptn_accum::b::", batches["ptn_accum"]),
              **_put("multi::b::", multi_b), **_put("con::b::", con_b),
              **_put("mlp::b::", mlp_b), **_put("vivit::b::", vivit_b)}
    procs = _start("train", tmp, arrays)

    mesh = jmesh.make_mesh(dp=2, mp=1)
    key0 = jax.random.PRNGKey(SEED)
    want = {}

    def run(tag, model, cfg, variables, batch):
        variables = dict(variables)
        params = variables.pop("params")
        state, metrics = jts.make_train_step(model, cfg, mesh=mesh)(
            _jstate(params, cfg, variables), jmesh.shard_batch(batch, mesh),
            key0)
        want[tag] = (float(metrics["loss"]),
                     {**_flat("", {"params": state.params,
                                   **state.model_state})})

    for tag, accum in (("ptn", 1), ("ptn_accum", 2)):
        run(tag, jptn, JConfig(**PTN, accum_steps=accum), ptn_v,
            batches[tag])
    run("con", jcon, JConfig(**CON), con_v, con_b)
    run("mlp", jmlp, JConfig(**MLP), mlp_v, mlp_b)
    run("vivit", jvivit, JConfig(**VIVIT), vivit_v, vivit_b)
    for tag, model, cfg, v, b in (("con_eval", jcon, JConfig(**CON), con_v,
                                   con_b),
                                  ("vivit_eval", jvivit, JConfig(**VIVIT),
                                   vivit_v, vivit_b)):
        v = dict(v)
        loss, aux = jts.make_eval_step(model, cfg, mesh=mesh)(
            _jstate(v.pop("params"), cfg, v), jmesh.shard_batch(b, mesh))
        want[tag] = (float(loss), _np(aux))
    return want, _finish(procs, tmp)


def _assert_params(got: dict, tag: str, want: dict, tol: dict,
                   key_bias_steps: int = 0) -> None:
    """Every parameter and buffer of ``tag`` against JAX's.  With
    ``key_bias_steps``, the key third of each attention ``in_proj.bias``,
    whose exact gradient is 0 (a bias on the keys adds a constant to a row
    of scores), stays within that many Adam steps of 0 on both sides."""
    prefix = f"{tag}::p::"
    names = {k[len(prefix):] for k in got if k.startswith(prefix)}
    assert names == set(want), names ^ set(want)
    e, lr = PTN["input_dimension"], PTN["learning_rate"]
    for k, w in want.items():
        g = got[prefix + k]
        if key_bias_steps and k.endswith("in_proj.bias"):
            for t in (g, w):
                assert np.abs(t[e:2 * e]).max() <= 1.01 * key_bias_steps * lr
            g, w = np.delete(g, np.s_[e:2 * e]), np.delete(w, np.s_[e:2 * e])
        np.testing.assert_allclose(g, w, err_msg=f"{tag} {k}", **tol)


def _same_on_both_ranks(outs: list[dict], tag: str) -> None:
    for k in outs[0]:
        if k.startswith(f"{tag}::"):
            np.testing.assert_array_equal(outs[0][k], outs[1][k],
                                          err_msg=k)


@pytest.mark.parametrize("tag", ["ptn", "ptn_accum"])
def test_ptn_dp_step_matches_jax(train_world, tag):
    want, outs = train_world
    loss, params = want[tag]
    np.testing.assert_allclose(outs[0][f"{tag}::loss"], loss, rtol=PTN_LOSS)
    _assert_params(outs[0], tag, params, PARAM_TOL, key_bias_steps=1)
    _same_on_both_ranks(outs, tag)
    assert str(outs[0]["runtime::backend"]) == "gloo"


def test_multi_step_matches_separate_steps(train_world):
    _, outs = train_world
    for out in outs:
        assert int(out["multi::step"]) == 2
        assert np.isfinite(out["multi::loss"])
        for k in out:
            if k.startswith("multi::p::"):
                np.testing.assert_allclose(
                    out[k], out[k.replace("multi::", "separate::")],
                    rtol=1e-6, atol=1e-7, err_msg=k)
    _same_on_both_ranks(outs, "multi")


def test_contrastive_global_negatives_and_synced_batchnorm(train_world):
    """The loss, the SGD update (the gradient itself: a factor of the
    world size would show) and the synced running statistics equal JAX's
    DP step's, which equals its one-device global-batch step; the eval
    loss is scored against every rank's negatives and the embeddings are
    the global batch's."""
    want, outs = train_world
    loss, params = want["con"]
    np.testing.assert_allclose(outs[0]["con::loss"], loss, rtol=1e-5)
    _assert_params(outs[0], "con", params, SGD_TOL)
    moved = [np.abs(params[k] - outs[0][f"con::w0::{k}"]).max()
             for k in params]
    assert min(moved) > 1e-3          # every leaf took a step
    assert {"enc_bn.running_mean", "enc_bn.running_var"} <= set(params)
    _same_on_both_ranks(outs, "con")
    assert bool(outs[0]["con::sync_after"])       # the knob is restored
    loss, aux = want["con_eval"]
    for out in outs:
        np.testing.assert_allclose(out["con_eval::loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(out["con_eval::embedding"],
                                   aux["embedding"], rtol=1e-5, atol=1e-6)
        assert out["con_eval::embedding"].shape == (8, 8)


def test_per_rank_batchnorm_averages_running_statistics(train_world):
    want, outs = train_world
    loss, params = want["mlp"]
    np.testing.assert_allclose(outs[0]["mlp::loss"], loss, rtol=1e-6)
    _assert_params(outs[0], "mlp", params, SGD_TOL)
    _same_on_both_ranks(outs, "mlp")


def test_vivit_fused_route_train_and_eval(train_world):
    want, outs = train_world
    loss, params = want["vivit"]
    np.testing.assert_allclose(outs[0]["vivit::loss"], loss, **VIVIT_FWD)
    _assert_params(outs[0], "vivit", params, VIVIT_PARAMS)
    _same_on_both_ranks(outs, "vivit")
    loss, aux = want["vivit_eval"]
    for out in outs:
        # 2 blocks a forward: the train step's and the eval step's
        assert int(out["vivit::fused_calls"]) == 4
        np.testing.assert_allclose(out["vivit_eval::loss"], loss,
                                   **VIVIT_FWD)
        np.testing.assert_allclose(out["vivit_eval::probs"], aux["probs"],
                                   **VIVIT_FWD)
        np.testing.assert_array_equal(out["vivit_eval::label"],
                                      aux["label"])


def test_one_rank_mesh_is_the_single_device_step(train_world):
    _, outs = train_world
    for out in outs:
        assert str(out["one::strategy"]) == "single"
        assert bool(out["one::equal"])


@pytest.fixture(scope="module")
def serve_world(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from devt_tpu.config import Config as JConfig
    from devt_tpu.parallel.mesh import make_mesh as jmake_mesh
    from devt_tpu.registry import build_model as jbuild
    from devt_tpu.serve import Predictor as JPredictor

    tmp = tmp_path_factory.mktemp("dp_serve")
    cfg = JConfig(**SERVE)
    v = jax.jit(jbuild(cfg).init)({"params": jax.random.PRNGKey(0)},
                                  jnp.zeros((1, 3, 2, 32)))
    x = np.random.default_rng(3).standard_normal((11, 3, 2, 32)).astype(
        np.float32)
    procs = _start("serve", tmp, {**_flat("serve::w::", v), "serve::x": x})
    mesh = jmake_mesh(dp=2, mp=1)
    want = {}
    for tag, quantize in (("f32", False), ("int8", True)):
        pred = JPredictor(cfg, v, buckets=(1, 4), mesh=mesh,
                          quantize=quantize)
        want[tag] = pred.predict({"experts": x})["scores"]
        want[f"{tag}::buckets"] = pred.buckets
    want["loader"] = _loader_rows(0, 1)
    return want, _finish(procs, tmp), tmp / "work"


def test_predictor_over_a_mesh_matches_jax(serve_world):
    want, outs, _ = serve_world
    for out in outs:
        for tag in ("f32", "int8"):
            assert out[f"serve::{tag}::buckets"].tolist() \
                == want[f"{tag}::buckets"] == [2, 4]
            assert out[f"serve::{tag}"].shape == (11, 15)
        np.testing.assert_allclose(out["serve::f32"], want["f32"],
                                   **SCORE_TOL)
        np.testing.assert_allclose(out["serve::int8"], want["int8"],
                                   **FLIP_TOL)
        np.testing.assert_allclose(out["serve::int8"],
                                   out["serve::int8::one"], atol=1e-6)
        np.testing.assert_allclose(out["serve::f32"], out["serve::f32::one"],
                                   atol=1e-6)


def test_shard_batch_and_loader_rows_make_the_global_batch(serve_world):
    want, outs, _ = serve_world
    for epoch in (0, 2):
        rows = np.concatenate([outs[r][f"rows::{epoch}"] for r in (0, 1)],
                              axis=1)
        np.testing.assert_array_equal(rows, want["loader"][f"rows::{epoch}"])
    assert want["loader"]["rows::0"].shape == (4, 8)     # 37 // 8 batches
    assert want["loader"]["rows::2"].shape == (3, 8)     # one skipped
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["shard::a"],
                                      np.arange(12).reshape(6, 2)[3 * r:
                                                                  3 * r + 3])
        np.testing.assert_array_equal(out["shard::t"], np.arange(3 * r,
                                                                 3 * r + 3))
        assert out["shard::path"].tolist() == [f"p{i}" for i in
                                               range(3 * r, 3 * r + 3)]


def test_main_dp2_checkpoints_on_rank0_and_resumes(serve_world, tmp_path,
                                                   monkeypatch, recwarn):
    """``main --dp 2`` in a world of two ranks against the same runs in one
    process, where ``--dp 2`` trains on the one device without a
    warning."""
    from devt_tpu_torch import main as tmain
    from devt_tpu_torch.train import checkpoint as tckpt

    _, outs, work = serve_world
    for out in outs:
        assert "batch_size=3 does not divide over the data axis dp=2" in \
            str(out["refused::ValueError"])
        assert "fall back to one device" in str(out["refused::ValueError"])
        np.testing.assert_array_equal(out["main::loss"],
                                      outs[0]["main::loss"])
    monkeypatch.chdir(tmp_path)
    one = tmain.main(MAIN + MOE_EP_MAIN, device="cpu")["test/loss"]
    for out in outs:
        np.testing.assert_allclose(float(out["moe_ep::loss"]), one,
                                   rtol=1e-6)
    tmain.main(MAIN + ["--dp", "2", "--max_steps", "2", "--name", "one",
                       "--checkpoint_dir", "ck"], device="cpu")
    tmain.main(MAIN + ["--dp", "2", "--max_steps", "3", "--name", "one2",
                       "--checkpoint_dir", "ck2", "--resume", "ck/step_2"],
               device="cpu")
    assert not [w for w in recwarn if issubclass(w.category, RuntimeWarning)]
    # rank 0 wrote each run's checkpoint once, and logged each step once
    for ck, step in (("ck", 2), ("ck2", 3)):
        assert sorted(os.listdir(work / ck)) == ["config.yaml",
                                                  f"step_{step}"]
    with open(work / "runs" / "dp" / "metrics.jsonl") as f:
        assert sum('"train/loss"' in line for line in f) == 2
    got = tckpt.load(str(work / "ck2" / "step_3"))
    ref = tckpt.load("ck2/step_3")
    assert got["step"] == ref["step"] == 3
    for part in ("params", "model_state"):
        for k, v in ref[part].items():
            np.testing.assert_allclose(got[part][k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# in one process: the mesh's arithmetic, the strategies, the refusals
# ---------------------------------------------------------------------------

MESHES = [dict(dp=-1), dict(dp=4), dict(dp=2, mp=2), dict(dp=-1, mp=4),
          dict(dp=-1, pp=2), dict(dp=2, pp=2, mp=2), dict(dp=-1, sp=2),
          dict(dp=1), dict(dp=8, mp=1), dict(dp=3, mp=3), dict(mp=3),
          dict(dp=-1, pp=3), dict(sp=2, mp=2), dict(dp=5, sp=2)]
CONFIGS = [{}, dict(dp_mode="gspmd"), dict(dp_mode="fsdp"),
           dict(dp_mode="fsdp", grad_clip_norm=1.0)]


@pytest.mark.parametrize("kw", MESHES, ids=[str(m) for m in MESHES])
def test_make_mesh_and_strategy_match_jax(kw):
    import jax

    from devt_tpu.config import Config as JConfig
    from devt_tpu.parallel import mesh as jmesh
    from devt_tpu.parallel import train_step as jts

    try:
        want = jmesh.make_mesh(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as info:
            tmesh.make_mesh(devices=range(8), **kw)
        assert str(info.value) == str(e)     # JAX's words
        return
    got = tmesh.make_mesh(devices=range(8), **kw)
    assert got.shape == dict(want.shape) and got.size == want.size
    assert got.axis_names == tuple(want.axis_names)
    ids = {d: i for i, d in enumerate(jax.devices())}
    assert got.ranks.tolist() == np.vectorize(ids.get)(
        want.devices).tolist()
    assert got.coords == {n: 0 for n in got.axis_names}
    for extra in CONFIGS:
        assert tts.mesh_strategy(got, TConfig(**extra)) == \
            jts.mesh_strategy(want, JConfig(**extra))


@pytest.mark.parametrize("extra,item", [
    (dict(mp=2, moe_experts=2), "7c"),
    (dict(dp_mode="gspmd", mp=2, moe_experts=2), "7c"),
    (dict(dp_mode="fsdp", mp=2, moe_experts=2), "7c"), (dict(pp=2), "7c"),
    (dict(sp=2), "7c"),
    (dict(moe_ep=True, moe_experts=2), "7c")])
def test_strategies_not_ported_raise(extra, item):
    """The strategies of ROADMAP item 7c, which raised until it was
    ported (MoE on a model axis, pipeline, sequence and expert
    parallelism), have JAX's strategy and make their executors
    (tests/test_torch_sp_pp_ep.py runs their steps over ranks)."""
    import jax

    from devt_tpu.config import Config as JConfig
    from devt_tpu.parallel import mesh as jmesh
    from devt_tpu.parallel import train_step as jts

    assert item == "7c"
    mesh_kw = {k: extra[k] for k in ("mp", "pp", "sp") if k in extra}
    mesh = tmesh.make_mesh(dp=2, devices=range(8), **mesh_kw)
    cfg = TConfig(**{**VIVIT, **extra})
    want = jts.mesh_strategy(jmesh.make_mesh(dp=2, devices=jax.devices(),
                                             **mesh_kw),
                             JConfig(**{**VIVIT, **extra}))
    assert tts.mesh_strategy(mesh, cfg) == want
    model = torch.nn.Linear(1, 1)
    for make in (tts.make_train_step, tts.make_eval_step):
        assert callable(make(model, cfg, mesh=mesh, device="cpu"))
    assert callable(tts.make_multi_step(model, cfg, 2, mesh=mesh,
                                        device="cpu"))


@pytest.mark.parametrize("world,flags,engage", [
    (1, dict(dp=2), False), (1, dict(mp=2), False), (1, {}, False),
    (2, dict(dp=2), True), (2, dict(dp=-1), True), (2, dict(dp=2, mp=2), None),
    (2, dict(dp=2, batch_size=3), None), (4, dict(dp=2), None),
    (2, dict(dp=1), None)])
def test_main_mesh_rule(world, flags, engage):
    """JAX's rule in a world of one process (no warning, no mesh); a
    world of ranks whose mesh cannot engage, or leaves ranks out,
    raises."""
    from devt_tpu_torch import main as tmain

    cfg = TConfig(**{"batch_size": 4, **flags})
    if engage is None:
        with pytest.raises(ValueError, match="cannot fall back"):
            tmain.use_mesh(cfg, world)
    else:
        assert tmain.use_mesh(cfg, world) is engage


def test_one_process_runtime_and_one_rank_axis():
    """Without a world: ``initialize`` does nothing, ``runtime_info`` has
    JAX's keys, and the collectives over an axis of one rank return their
    input; an unbound axis name raises, as JAX's does."""
    from devt_tpu_torch.models import losses
    from devt_tpu_torch.parallel import collectives, distributed

    assert distributed.initialize() is False
    assert distributed.runtime_info() == {
        "process_index": 0, "process_count": 1, "local_devices": 1,
        "global_devices": 1, "backend": None}
    assert tmesh.make_mesh().size == 1
    assert tmesh.batch_spec(3) == ("data", None, None)
    assert tmesh.replicated_spec() == ()
    z = torch.tensor(np.random.default_rng(0).standard_normal((4, 5)),
                     dtype=torch.float32)
    with pytest.raises(NameError, match="unbound axis name"):
        collectives.pmean([z], "data")
    with collectives.axis_scope({"data": collectives.Axis(None, 1, 0)}):
        assert collectives.pmean([z], "data")[0].equal(z)
        assert collectives.all_gather_rows(z, "data") is z
        assert losses.nt_xent(z, 2 * z, axis_name="data").equal(
            losses.nt_xent(z, 2 * z))


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), *sys.argv[3:7])
