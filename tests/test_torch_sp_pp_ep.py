"""The port's sequence, pipeline and expert parallelism against the JAX
package's, on the CPU.

Four ranks join a Gloo group through a file in the test's temporary
directory and run this file as their script (``python
tests/test_torch_sp_pp_ep.py <rank> ...``, which imports no JAX), once for
the whole file, while the test process computes the JAX package's side on
the virtual CPU devices with the same weights (``utils.jax_bridge``) and
batches.  The ranks lay out a (data 2, seq 2), a (data 2, pipe 2), a
(data 1, pipe 2, model 2) and a (data 4) mesh in turn (and a (data 2,
model 2) one and a four-rank ``expert`` axis).

Cases, mirroring ``tests/test_pipeline.py``, ``test_sp_product.py``,
``test_three_d.py`` and ``test_moe.py``, and their tolerances:

  * the transposes of ``parallel/collectives.py`` on their own: the pipe
    shift, the tiled ``all_to_all`` and the chunk slice, forward and
    backward, against their definitions;
  * ``pipeline_apply`` (two stages of a residual MLP, 4 and 1
    microbatches) against JAX's ``pipelined_stack`` and its sequential
    stack: the output within rtol 2e-5 / atol 2e-6, the input's gradient
    and the stacked parameters' (summed over the stages) within 1e-4 /
    1e-6; every rank posts as many exchanges as the schedule has hops,
    forward and backward;
  * the pp, sp and 3-D trainers on a tiny stacked ViViT, SGD with the
    schedule off: the loss within JAX's bound of its mesh step against
    its one-device step (rtol 1e-4) of JAX's one-device step and of the
    mesh step (JAX's sp step; JAX's pp and 3-D steps), the new parameters
    within rtol 1e-5 / atol 1e-6 of the port's one-process step's and
    within rtol 1e-4 / atol 1e-6 of JAX's one-device step's (and of JAX's
    sp step's); the replicated leaves bit-equal on every rank; the eval
    loss and probabilities within JAX's eval bounds (rtol 1e-3; atol
    1e-3 / rtol 1e-2); ``make_multi_step(2)`` against two steps (rtol
    1e-5 / atol 1e-6).  JAX's pp and 3-D steps hand the ``pb_*`` leaves
    the stages' (and on 3-D the model axis') multiple of their gradient
    (ROADMAP.md queue 3): their updates are held to the port's times that
    factor;
  * MoE: ``moe_ffn`` on four ranks against JAX's, forward and gradients
    (atol 2e-5 / rtol 1e-4, JAX's); the ``moe_ep`` step on a data axis of
    4 against the dense DP step and JAX's ``moe_ep`` step (loss rtol
    1e-5, parameters rtol 1e-5 / atol 1e-6), and its eval; the same step
    with remat, its recompute routed as the forward was, against it (the
    loss bit for bit); experts that do not divide over the ranks run
    dense; MoE-ViViT on a (2, 2) mesh,
    its experts split over ``model`` at rest, against JAX's gspmd step;
  * ``main`` with ``--pp 2``, ``--sp 2`` and ``--moe_ep true`` in the
    world of four (a tiny ViViT in place of the registry's), each test
    loss within rtol 1e-5 of the same run in one process;
  * the ``pb_*`` leaves through the bridge both ways, and the stacked
    ViViT on one device against JAX's ``pp=2`` and ``sp`` models.

SGD with the schedule off, not Adam: Adam's update does not see a
gradient off by a constant factor, SGD's does.
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

from devt_tpu_torch.config import Config as TConfig  # noqa: E402
from devt_tpu_torch.models import layers as tlayers  # noqa: E402
from devt_tpu_torch.parallel import collectives as tcoll  # noqa: E402
from devt_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from devt_tpu_torch.parallel import moe as tmoe  # noqa: E402
from devt_tpu_torch.parallel import pipeline as tpipe  # noqa: E402
from devt_tpu_torch.parallel import sharding as tsharding  # noqa: E402
from devt_tpu_torch.parallel import tp_block as ttp  # noqa: E402
from devt_tpu_torch.parallel import train_step as tts  # noqa: E402
from devt_tpu_torch.train import optimizers as topt  # noqa: E402
from devt_tpu_torch.train.state import TrainState, model_buffers  # noqa: E402
from tests.test_torch_dp import _batch, _flat, _put, _sd  # noqa: E402

# six test workers share the host's cores: two threads a worker
torch.set_num_threads(2)

RANKS = 4
SEED = 0
SGD = dict(opt="sgd", learning_rate=0.5, momentum=0.0, weight_decay=0.0)
BASE = dict(model="vivit", batch_size=8, frame_len=2, n_classes=5,
            precision="f32", dropout=0.0, **SGD)
VIT = dict(image_size=32, patch_size=16, num_classes=5, num_frames=2,
           channels_last=True)
# (port config, JAX config, model widths, JAX's attention_impl): the pp
# ViViT of test_pipeline.py, the sp one of test_sp_product.py (the port's
# ring on the kernel tier's plain versions), the 3-D one of test_three_d.py
CASES = {
    "pp": (dict(BASE, attention_impl="auto", pp=2),
           dict(dim=16, depth=4, heads=2, dim_head=8, pipeline_stages=2),
           "auto"),
    "sp": (dict(BASE, attention_impl="fused_interpret", sp=2),
           dict(dim=32, depth=2, heads=2, dim_head=16, scale_dim=2,
                sequence_parallel=True), "xla"),
    "three": (dict(BASE, attention_impl="auto", pp=2, mp=2),
              dict(dim=32, depth=4, heads=2, dim_head=16, scale_dim=2,
                   pipeline_stages=2), "fused_interpret"),
}
MOE_KW = dict(VIT, dim=16, depth=2, heads=2, dim_head=8, moe_capacity_factor=2.0)
# the attention of JAX's test_moe.py (the fused half's plain version runs in
# main's moe_ep run below)
MOE = dict(BASE, attention_impl="xla", moe_capacity_factor=2.0)
# the dense DP step runs on the moe_ep step's batch
MOE_CASES = {"ep": (dict(MOE, moe_experts=8, moe_ep=True), 8),
             "ep_remat": (dict(MOE, moe_experts=8, moe_ep=True, remat=True),
                          8),
             "dense": (dict(MOE, moe_experts=8), 8),
             "indivisible": (dict(MOE, moe_experts=6, moe_ep=True), 6),
             "square": (dict(MOE, moe_experts=2, mp=2, batch_size=4), 2)}
MAIN = ["--model", "vivit", "--data_set", "synthetic", "--batch_size", "8",
        "--frame_len", "2", "--n_classes", "5", "--precision", "f32",
        "--dropout", "0.0", "--opt", "sgd", "--learning_rate", "0.1",
        "--log_every", "1", "--epochs", "1", "--max_steps", "2",
        "--save_path", "out"]
MAIN_RUNS = {"pp": ["--dp", "2", "--pp", "2"], "sp": ["--dp", "2", "--sp", "2"],
             "ep": ["--dp", "4", "--moe_experts", "8", "--moe_ep", "true"]}

PIPE_FWD, PIPE_BWD = dict(rtol=2e-5, atol=2e-6), dict(rtol=1e-4, atol=1e-6)
LOSS = 1e-4
PARAMS, JAX_PARAMS = dict(rtol=1e-5, atol=1e-6), dict(rtol=1e-4, atol=1e-6)
EVAL_LOSS, EVAL_PROBS = 1e-3, dict(atol=1e-3, rtol=1e-2)
MOE_GRADS = dict(atol=2e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# the ranks (this file as their script: no JAX)
# ---------------------------------------------------------------------------

def _state(model, cfg) -> TrainState:
    return TrainState.create(dict(model.named_parameters()),
                             topt.build_optimizer(cfg),
                             model_state=model_buffers(model))


def _vivit(a: dict, tag: str):
    from devt_tpu_torch.models.vivit import ViViT

    cfg_kw, widths, _ = CASES[tag]
    model = ViViT(attention_impl=cfg_kw["attention_impl"], **VIT, **widths)
    model.load_state_dict(_sd(a, f"{tag}::w::"))
    return model, TConfig(**cfg_kw)


def _moe_vivit(a: dict, tag: str):
    from devt_tpu_torch.models.vivit import ViViT

    kw, n_experts = MOE_CASES[tag]
    model = ViViT(attention_impl=kw["attention_impl"], moe_experts=n_experts,
                  remat=kw.get("remat", False), **MOE_KW)
    model.load_state_dict(_sd(a, f"moe{n_experts}::w::"))
    return model, TConfig(**kw)


def _moe_batch(tag: str) -> str:
    return f"moe_{'ep' if tag in ('dense', 'ep_remat') else tag}::b::"


def _params(state) -> dict:
    return {k: v.detach().numpy().copy() for k, v in state.params.items()}


def _record(out: dict, tag: str, state, metrics) -> None:
    for k, v in _params(state).items():
        out[f"{tag}::p::{k}"] = v
    out[f"{tag}::loss"] = np.float32(metrics["loss"])


def _transposes(pipe, data, seq) -> dict:
    """The pipe shift, the tiled all_to_all and the chunk slice, forward
    and backward, on this rank."""
    out = {}
    rank = pipe.rank
    with tcoll.axis_scope(pipe.axes()):
        x = torch.full((2, 3), rank + 1.0, requires_grad=True)
        y = tcoll.shift(x, "pipe")
        (y * 10.0 * (rank + 1)).sum().backward()
        out["shift::y"], out["shift::dx"] = y.detach().numpy(), x.grad.numpy()
    with tcoll.axis_scope(data.axes()):
        x = (100.0 * rank + torch.arange(24.0).reshape(4, 2, 3)
             ).requires_grad_(True)
        y = tcoll.all_to_all(x, "data", 0, 1)
        c = 1000.0 * rank + torch.arange(24.0).reshape(y.shape)
        (y * c).sum().backward()
        out["a2a::y"], out["a2a::dx"] = y.detach().numpy(), x.grad.numpy()
    with tcoll.axis_scope(seq.axes()):
        x = torch.arange(24.0).reshape(2, 12).requires_grad_(True)
        y = tcoll.axis_chunk(x, "seq", 1, groups=3)
        (y * (y + 1.0)).sum().backward()
        out["chunk::y"], out["chunk::dx"] = y.detach().numpy(), x.grad.numpy()
    return out


def _mlp_block(p, x):
    return x + torch.tanh(x @ p["w"] + p["b"]) @ p["v"]


def _axis_block(p, x):
    """The MLP stage, reading the pipe axis' binding (as a tensor-parallel
    stage reads the model axis')."""
    assert tcoll.axis("pipe").size == 2
    return _mlp_block(p, x)


def _pipeline(a: dict, pipe) -> dict:
    """``pipelined_stack`` over the pipe axis at 4 and 1 microbatches: the
    output, and at 4 the gradients (the stacked ones this rank's share)
    and the exchanges each pass posted; the gradients again with the
    backward on another thread, where the forward's axis bindings are not
    (autograd runs a CUDA backward on its device thread)."""
    import threading

    out = {}
    calls = []
    real = tcoll._shifted

    def spy(t, ax, step):
        calls.append(step)
        return real(t, ax, step)

    tcoll._shifted = spy
    try:
        for n_micro in (4, 1):
            stacked = {k: torch.tensor(a[f"mlp::{k}"]).requires_grad_(True)
                       for k in ("w", "b", "v")}
            x = torch.tensor(a["mlp::x"]).requires_grad_(True)
            y = tpipe.pipelined_stack(pipe, _mlp_block, stacked, x, n_micro)
            out[f"mlp{n_micro}::y"] = y.detach().numpy()
            if n_micro == 4:
                ((y - torch.tensor(a["mlp::tgt"])) ** 2).mean().backward()
                out["mlp::dx"] = x.grad.numpy()
                for k, v in stacked.items():
                    out[f"mlp::d{k}"] = v.grad.numpy()
                out["mlp::exchanges"] = np.array(calls)
    finally:
        tcoll._shifted = real
    stacked = {k: torch.tensor(a[f"mlp::{k}"]).requires_grad_(True)
               for k in ("w", "b", "v")}
    y = tpipe.pipelined_stack(pipe, _axis_block, stacked,
                              torch.tensor(a["mlp::x"]), 4)
    loss = ((y - torch.tensor(a["mlp::tgt"])) ** 2).mean()
    thread = threading.Thread(target=loss.backward)
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive()
    for k, v in stacked.items():
        out[f"mlp_thread::d{k}"] = v.grad.numpy()
    return out


def _spy(module, name: str, calls: list):
    real = getattr(module, name)

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    spy.__dict__.update(real.__dict__)      # the wrappers' counters
    setattr(module, name, spy)
    return real


def _steps(a: dict, tag: str, mesh) -> dict:
    """The mesh's train step, eval step and ``make_multi_step(2)`` for the
    case ``tag``, and the calls of the kernels' wrappers in the step."""
    from devt_tpu_torch.parallel import ring_attention as tra

    out = {}
    calls: list = []
    spied = {"pp": (tlayers, "fused_vit_block"),
             "sp": (tra, "ring_mha_split"),
             "three": (ttp, "fused_mha")}[tag]
    real = _spy(*spied, calls)
    try:
        model, cfg = _vivit(a, tag)
        state = tsharding.shard_train_state(_state(model, cfg), mesh)
        out[f"{tag}::strategy"] = np.array(tts.mesh_strategy(mesh, cfg))
        out[f"{tag}::shards"] = np.int64(len(state.shards))
        batch = tmesh.shard_batch(_batch(a, f"{tag}::b::"), mesh)
        state, metrics = tts.make_train_step(model, cfg, mesh=mesh,
                                             device="cpu")(state, batch, SEED)
        out[f"{tag}::calls"] = np.int64(len(calls))
    finally:
        setattr(*spied, real)
    _record(out, tag, state, metrics)
    model, cfg = _vivit(a, tag)
    loss, aux = tts.make_eval_step(model, cfg, mesh=mesh, device="cpu")(
        _state(model, cfg), batch)
    out[f"{tag}_eval::loss"] = loss.numpy()
    out[f"{tag}_eval::probs"] = aux["probs"].numpy()
    model, cfg = _vivit(a, tag)
    state = _state(model, cfg)
    step = tts.make_train_step(model, cfg, mesh=mesh, device="cpu")
    for _ in range(2):
        state, _ = step(state, batch, SEED)
    out.update({f"{tag}_separate::p::{k}": v
                for k, v in _params(state).items()})
    model, cfg = _vivit(a, tag)
    state, metrics = tts.make_multi_step(model, cfg, 2, mesh=mesh,
                                         device="cpu")(
        _state(model, cfg), {k: np.stack([v, v]) for k, v in batch.items()},
        SEED)
    _record(out, f"{tag}_multi", state, metrics)
    return out


def _moe(a: dict, expert, data, square) -> dict:
    """``moe_ffn`` over four ranks; the moe_ep, dense, indivisible and
    (2, 2) steps, and the moe_ep eval."""
    from devt_tpu_torch.parallel import layout

    out = {}
    params = {k: torch.tensor(a[f"ffn::{k}"]).requires_grad_(True)
              for k in ("router", "w1", "b1", "w2", "b2")}
    x = torch.tensor(a["ffn::x"]).requires_grad_(True)
    y, aux = tmoe.moe_ffn(expert, params, x)
    ((y ** 2).sum() + 0.01 * aux).backward()
    out["ffn::y"], out["ffn::aux"] = y.detach().numpy(), aux.detach().numpy()
    out["ffn::dx"] = x.grad.numpy()
    for k, v in params.items():
        out[f"ffn::d{k}"] = v.grad.numpy()
    for tag, mesh in (("ep", data), ("ep_remat", data), ("dense", data),
                      ("indivisible", data), ("square", square)):
        calls: list = []
        real = _spy(tmoe, "moe_ffn_ep_rows", calls)
        try:
            model, cfg = _moe_vivit(a, tag)
            state = tsharding.shard_train_state(_state(model, cfg), mesh)
            out[f"{tag}::split"] = np.array(sorted(state.shards))
            out[f"{tag}::strategy"] = np.array(tts.mesh_strategy(mesh, cfg))
            batch = tmesh.shard_batch(_batch(a, _moe_batch(tag)), mesh)
            state, metrics = tts.make_train_step(model, cfg, mesh=mesh,
                                                 device="cpu")(
                state, batch, SEED)
            out[f"{tag}::calls"] = np.int64(len(calls))
            out[f"{tag}::moe_aux"] = np.float32(metrics["moe_aux"])
            with tcoll.axis_scope(mesh.axes()):
                state = layout.whole_state(state)
            _record(out, tag, state, metrics)
            if tag in ("ep", "dense"):
                model, cfg = _moe_vivit(a, tag)
                loss, aux = tts.make_eval_step(model, cfg, mesh=mesh,
                                               device="cpu")(
                    _state(model, cfg), batch)
                out[f"{tag}_eval::loss"] = loss.numpy()
                out[f"{tag}_eval::probs"] = aux["probs"].numpy()
                out[f"{tag}_eval::calls"] = np.int64(len(calls))
        finally:
            tmoe.moe_ffn_ep_rows = real
    return out


def _tiny_main():
    """``main``'s model and synthetic batches at the tests' width: the
    registry's ViViT with image 32 and dim 16 (what it would build for the
    config otherwise at 224 and 192)."""
    from devt_tpu_torch import main as tmain
    from devt_tpu_torch.data import synthetic
    from devt_tpu_torch.models.vivit import ViViT

    def build(cfg):
        return ViViT(attention_impl=cfg.attention_impl,
                     moe_experts=cfg.moe_experts,
                     pipeline_stages=cfg.pp if cfg.pp > 1 else 0,
                     sequence_parallel=cfg.sp > 1,
                     **dict(MOE_KW, depth=4)).init_weights(
            torch.Generator().manual_seed(cfg.seed))

    def batch(cfg, batch_size=None):
        rng = np.random.default_rng(cfg.seed)
        b = batch_size or cfg.batch_size
        return {"vid": rng.standard_normal((b, 2, 32, 32, 3),
                                           dtype=np.float32),
                "label": (rng.random((b, 5)) < 0.4).astype(np.float32)}

    tmain.build_model = build
    synthetic.example_batch = batch
    return tmain


def _main_runs(workdir: str) -> dict:
    tmain = _tiny_main()
    os.chdir(workdir)
    out = {}
    for tag, flags in MAIN_RUNS.items():
        res = tmain.main(MAIN + flags + ["--name", tag, "--checkpoint_dir",
                                         f"ck_{tag}"], device="cpu")
        out[f"main::{tag}"] = np.float64(res["test/loss"])
    return out


def _one_process(a: dict) -> dict:
    """The port's one-process steps on the same weights and global
    batches (rank 0, after the meshes' runs)."""
    out = {}
    for tag in CASES:
        model, cfg = _vivit(a, tag)
        state, metrics = tts.make_train_step(model, cfg, device="cpu")(
            _state(model, cfg), _batch(a, f"{tag}::b::"), SEED)
        _record(out, f"one_{tag}", state, metrics)
        model, cfg = _vivit(a, tag)
        loss, aux = tts.make_eval_step(model, cfg, device="cpu")(
            _state(model, cfg), _batch(a, f"{tag}::b::"))
        out[f"one_{tag}_eval::loss"] = loss.numpy()
        out[f"one_{tag}_eval::probs"] = aux["probs"].numpy()
    for tag in MOE_CASES:
        model, cfg = _moe_vivit(a, tag)
        state, metrics = tts.make_train_step(model, cfg, device="cpu")(
            _state(model, cfg), _batch(a, _moe_batch(tag)), SEED)
        _record(out, f"one_{tag}", state, metrics)
    return out


def _worker(rank: int, init: str, src: str, dst: str, workdir: str) -> None:
    import torch.distributed as dist

    from devt_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    assert distributed.initialize(f"file://{init}", RANKS, rank)
    a = dict(np.load(src))
    # every rank makes every mesh's groups, in the same order
    seq = tmesh.make_mesh(dp=2, sp=2)
    pipe = tmesh.make_mesh(dp=2, pp=2)
    three = tmesh.make_mesh(dp=1, pp=2, mp=2)
    data = tmesh.make_mesh(dp=RANKS)
    square = tmesh.make_mesh(dp=2, mp=2)
    expert = tmesh.Mesh(("expert",), np.arange(RANKS), rank)
    out = _transposes(pipe, data, seq)
    out.update(_pipeline(a, pipe))
    for tag, mesh in (("pp", pipe), ("sp", seq), ("three", three)):
        out.update(_steps(a, tag, mesh))
    out.update(_moe(a, expert, data, square))
    out.update(_main_runs(workdir))
    if rank == 0:
        out.update(_one_process(a))
    out["coords"] = np.array([pipe.coords["pipe"], seq.coords["seq"],
                              three.coords["pipe"], three.coords["model"]])
    np.savez(dst, **out)
    dist.barrier()          # no rank leaves while another still talks
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the test process: JAX's side, and the ranks started beside it
# ---------------------------------------------------------------------------

def _start(tmp: pathlib.Path, arrays: dict):
    np.savez(tmp / "in.npz", **arrays)
    (tmp / "work").mkdir(exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(key, None)
    return [subprocess.Popen(
        [sys.executable, __file__, str(r), str(tmp / "init"),
         str(tmp / "in.npz"), str(tmp / f"out{r}.npz"), str(tmp / "work")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(RANKS)]


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
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(RANKS)]


def _numpy_variables(model, rng, example) -> dict:
    """A flax model's variables drawn with numpy on the tree
    ``jax.eval_shape`` gives (no compile): LayerNorm scales (and the
    stacked ``pb_g*`` rows) about 1, matrices at 1/sqrt(fan-in), the
    other leaves (biases, embeddings, routers) at 0.05."""
    import jax

    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0)},
                            example)

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("scale", "pb_g1", "pb_g2"):
            return 1.0 + 0.1 * z
        if len(leaf.shape) >= 2 and leaf.shape[-2] > 1 \
                and name not in ("moe_router",):
            return z * np.float32(leaf.shape[-2] ** -0.5)
        return 0.05 * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jstate(params, cfg):
    import jax

    from devt_tpu.train.optimizers import build_optimizer
    from devt_tpu.train.state import TrainState as JTrainState
    # copies: the JAX step donates its state
    return JTrainState.create(jax.tree_util.tree_map(np.array, params),
                              build_optimizer(cfg))


def _vivit_batch(rng, b):
    return {"vid": rng.standard_normal((b, 2, 32, 32, 3), dtype=np.float32),
            "label": (rng.random((b, 5)) < 0.4).astype(np.float32)}


def _jax_pipeline(a: dict) -> dict:
    """JAX's ``pipelined_stack`` on a 2-device pipe mesh and its
    sequential stack: outputs and gradients."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from devt_tpu.parallel.pipeline import pipelined_stack

    mesh = Mesh(np.array(jax.devices()[:2]), ("pipe",))

    def block(p, x):
        return x + jnp.tanh(x @ p["w"] + p["b"]) @ p["v"]

    def seq(p, x):
        for i in range(2):
            x = block({k: v[i] for k, v in p.items()}, x)
        return x

    stacked = {k: jnp.asarray(a[f"mlp::{k}"]) for k in ("w", "b", "v")}
    x, tgt = jnp.asarray(a["mlp::x"]), jnp.asarray(a["mlp::tgt"])

    def loss(p, xx):
        y = pipelined_stack(mesh, block, p, xx, n_micro=4)
        return jnp.mean((y - tgt) ** 2), y

    (_, y), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(stacked, x)
    want = {4: np.asarray(y), "grads": jax.tree_util.tree_map(np.asarray,
                                                              grads)}
    want["seq"] = np.asarray(seq(stacked, x))
    want["seq_grads"] = jax.tree_util.tree_map(np.asarray, jax.grad(
        lambda p, xx: jnp.mean((seq(p, xx) - tgt) ** 2),
        argnums=(0, 1))(stacked, x))
    return want


def _jax_moe_ffn(a: dict) -> dict:
    """JAX's ``moe_ffn`` on 4 virtual devices: output, aux, gradients."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from devt_tpu.parallel import moe as jmoe

    mesh = Mesh(np.array(jax.devices()[:RANKS]), (jmoe.EXPERT_AXIS,))
    params = {k: jnp.asarray(a[f"ffn::{k}"])
              for k in ("router", "w1", "b1", "w2", "b2")}
    x = jnp.asarray(a["ffn::x"])

    def loss(p, xx):
        y, aux = jmoe.moe_ffn(mesh, p, xx)
        return jnp.sum(y ** 2) + 0.01 * aux, (y, aux)

    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    return {"y": np.asarray(y), "aux": float(aux),
            "grads": jax.tree_util.tree_map(np.asarray, grads)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX's side on the virtual devices and every rank's results."""
    import jax
    import jax.numpy as jnp

    from devt_tpu.config import Config as JConfig
    from devt_tpu.models.vivit import ViViT as JViViT
    from devt_tpu.parallel import mesh as jmesh
    from devt_tpu.parallel import moe as jmoe
    from devt_tpu.parallel import sharding as jsharding
    from devt_tpu.parallel import train_step as jts

    tmp = tmp_path_factory.mktemp("sp_pp_ep")
    rng = np.random.default_rng(23)
    example = jnp.zeros((1, 2, 32, 32, 3))
    arrays, jmodels, jvars, batches = {}, {}, {}, {}
    for tag, (_, widths, impl) in CASES.items():
        jmodels[tag] = JViViT(attention_impl=impl, **VIT, **widths)
        jvars[tag] = _numpy_variables(jmodels[tag], rng, example)
        arrays.update(_flat(f"{tag}::w::", jvars[tag]))
        batches[tag] = _vivit_batch(rng, 8)
    for n_experts in (8, 6, 2):
        tag = f"moe{n_experts}"
        jmodels[tag] = JViViT(attention_impl=MOE["attention_impl"],
                              moe_experts=n_experts, **MOE_KW)
        jvars[tag] = _numpy_variables(jmodels[tag], rng, example)
        arrays.update(_flat(f"{tag}::w::", jvars[tag]))
    for tag, (kw, _) in MOE_CASES.items():
        if tag not in ("dense", "ep_remat"):
            batches[f"moe_{tag}"] = _vivit_batch(rng, kw["batch_size"])
    for tag, b in batches.items():
        arrays.update(_put(f"{tag}::b::", b))
    mlp = {"w": rng.standard_normal((2, 8, 16)) * 8 ** -0.5,
           "b": np.zeros((2, 16)),
           "v": rng.standard_normal((2, 16, 8)) * 16 ** -0.5,
           "x": rng.standard_normal((8, 3, 8)),
           "tgt": rng.standard_normal((8, 3, 8))}
    arrays.update({f"mlp::{k}": v.astype(np.float32) for k, v in mlp.items()})
    ffn = jmoe.init_moe_params(jax.random.PRNGKey(5), 8, 16, 32)
    arrays.update({f"ffn::{k}": np.asarray(v) for k, v in ffn.items()})
    arrays["ffn::x"] = rng.standard_normal((64, 16)).astype(np.float32)
    procs = _start(tmp, arrays)

    want = {"pipeline": _jax_pipeline(arrays), "ffn": _jax_moe_ffn(arrays)}
    key0 = jax.random.PRNGKey(SEED)
    devs = jax.devices()[:RANKS]

    def step(tag, model, v, cfg, mesh, batch, place=None):
        """JAX's step on ``mesh``: the loss and the new parameters by the
        port's names."""
        state = _jstate(v["params"], cfg)
        state = place(state, mesh) if place else state
        state, metrics = jts.make_train_step(model, cfg, mesh=mesh)(
            state, jmesh.shard_batch(batch, mesh), key0)
        return float(metrics["loss"]), _flat("", {"params": state.params})

    meshes = {"pp": dict(dp=2, pp=2), "sp": dict(dp=2, sp=2),
              "three": dict(dp=1, pp=2, mp=2)}
    for tag, (cfg_kw, _, impl) in CASES.items():
        cfg = JConfig(**{**cfg_kw, "attention_impl": impl})
        mesh = jmesh.make_mesh(devices=devs, **meshes[tag])
        want[tag] = step(tag, jmodels[tag], jvars[tag], cfg, mesh,
                         batches[tag])
        if tag == "sp":
            loss, aux = jts.make_eval_step(jmodels[tag], cfg, mesh)(
                _jstate(jvars[tag]["params"], cfg),
                jmesh.shard_batch(batches[tag], mesh))
            want["sp_eval"] = (float(loss), np.asarray(aux["probs"]))
    data = jmesh.make_mesh(dp=RANKS, devices=devs)
    square = jmesh.make_mesh(dp=2, mp=2, devices=devs)
    for tag, mesh, place in (("ep", data, None),
                             ("square", square, jsharding.shard_train_state)):
        kw, n_experts = MOE_CASES[tag]
        want[tag] = step(tag, jmodels[f"moe{n_experts}"],
                         jvars[f"moe{n_experts}"], JConfig(**kw), mesh,
                         _batch(arrays, _moe_batch(tag)), place)
    outs = _finish(procs, tmp)
    return want, outs, tmp


@pytest.fixture(scope="module")
def main_runs(world):
    """``main`` in this process: the ranks' runs on the one device."""
    _, _, tmp = world
    work = tmp / "one_process"
    work.mkdir()
    cwd = os.getcwd()
    os.chdir(work)
    saved = {}
    from devt_tpu_torch import main as tmain
    from devt_tpu_torch.data import synthetic
    saved = {"build": tmain.build_model, "batch": synthetic.example_batch}
    try:
        tmain = _tiny_main()
        return {tag: tmain.main(MAIN + flags + [
            "--name", tag, "--checkpoint_dir", f"ck_{tag}"],
            device="cpu")["test/loss"] for tag, flags in MAIN_RUNS.items()}
    finally:
        tmain.build_model = saved["build"]
        synthetic.example_batch = saved["batch"]
        os.chdir(cwd)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got, want, err_msg=msg, **tol)


def _names(out: dict, tag: str) -> set:
    prefix = f"{tag}::p::"
    return {k[len(prefix):] for k in out if k.startswith(prefix)}


def _close_params(out: dict, tag: str, want: dict, tol=PARAMS) -> None:
    assert _names(out, tag) == set(want), _names(out, tag) ^ set(want)
    for k, w in want.items():
        _close(out[f"{tag}::p::{k}"], w, tol, f"{tag} {k}")


def _one(outs: list, tag: str) -> dict:
    prefix = f"one_{tag}::p::"
    return {k[len(prefix):]: v for k, v in outs[0].items()
            if k.startswith(prefix)}


def _np_all_to_all(xs: list, split: int, concat: int) -> list:
    n = len(xs)
    return [np.concatenate([np.split(x, n, split)[r] for x in xs], concat)
            for r in range(n)]


def test_collective_transposes(world):
    """The pipe shift hands index i + 1 index i's tensor and index 0
    zeros, its backward the other way; the tiled all_to_all and its
    backward, the inverse exchange; the chunk slice's backward scatters
    into zeros."""
    _, outs, _ = world
    for r, out in enumerate(outs):
        p = out["coords"][0]
        line = [r - p + i for i in range(2)]      # the rank's pipe group
        y = 0.0 if p == 0 else line[p - 1] + 1.0
        g = 0.0 if p == 1 else 10.0 * (line[p + 1] + 1)
        np.testing.assert_array_equal(out["shift::y"], np.full((2, 3), y))
        np.testing.assert_array_equal(out["shift::dx"], np.full((2, 3), g))
    xs = [100.0 * r + np.arange(24.0).reshape(4, 2, 3) for r in range(RANKS)]
    ys = _np_all_to_all(xs, 0, 1)
    cs = [1000.0 * r + np.arange(24.0).reshape(ys[0].shape)
          for r in range(RANKS)]
    dxs = _np_all_to_all(cs, 1, 0)
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["a2a::y"], ys[r])
        np.testing.assert_array_equal(out["a2a::dx"], dxs[r])
        s = out["coords"][1]
        x = np.arange(24.0).reshape(2, 12)
        cols = np.concatenate([np.arange(4 * b + 2 * s, 4 * b + 2 * s + 2)
                               for b in range(3)])
        np.testing.assert_array_equal(out["chunk::y"], x[:, cols])
        dx = np.zeros_like(x)
        dx[:, cols] = 2 * x[:, cols] + 1
        np.testing.assert_array_equal(out["chunk::dx"], dx)


def test_pipeline_apply_matches_jax_and_sequential(world):
    want, outs, _ = world
    jw = want["pipeline"]
    for out in outs:
        _close(out["mlp4::y"], jw[4], PIPE_FWD, "n_micro 4")
        for n in (4, 1):
            _close(out[f"mlp{n}::y"], jw["seq"], PIPE_FWD, f"n_micro {n}")
        for ref in (jw["grads"], jw["seq_grads"]):
            _close(out["mlp::dx"], ref[1], PIPE_BWD, "dx")
        # the schedule's 4 + 2 - 1 ticks: 4 hops forward, 4 back
        assert out["mlp::exchanges"].tolist() == [1] * 4 + [-1] * 4
    for k in ("w", "b", "v"):
        for p in range(2):
            got = sum(o[f"mlp::d{k}"] for o in outs
                      if o["coords"][0] == p) / 2
            # each rank's gradient is its stage's slice, zero elsewhere
            others = [o[f"mlp::d{k}"][1 - p] for o in outs
                      if o["coords"][0] == p]
            assert all(not np.any(g) for g in others), k
            _close(got[p], jw["grads"][0][k][p], PIPE_BWD, k)
            _close(got[p], jw["seq_grads"][0][k][p], PIPE_BWD, k)
    # the backward on another thread, the stage replayed with the axes
    for out in outs:
        for k in ("w", "b", "v"):
            np.testing.assert_array_equal(out[f"mlp_thread::d{k}"],
                                          out[f"mlp::d{k}"], k)


@pytest.mark.parametrize("tag", list(CASES))
def test_mesh_step_matches_jax_and_one_process(world, tag):
    """The pp, sp and 3-D steps: the kernels' wrappers reached, the state
    whole on every rank, the loss and new parameters against the port's
    one-process step and JAX's mesh step, the replicated leaves bit-equal
    on every rank."""
    want, outs, _ = world
    jloss, jparams = want[tag]
    one = _one(outs, tag)
    jstrategy = {"sp": "sp_shard_map"}.get(tag, "pp_shard_map")
    for out in outs:
        assert str(out[f"{tag}::strategy"]) == jstrategy
        assert out[f"{tag}::shards"] == 0
        assert out[f"{tag}::calls"] > 0
        loss = float(out[f"{tag}::loss"])
        np.testing.assert_allclose(loss, float(outs[0][f"one_{tag}::loss"]),
                                   rtol=LOSS)
        np.testing.assert_allclose(loss, jloss, rtol=LOSS)
        _close_params(out, tag, one)
        for k, p in _params_of(out, tag).items():
            np.testing.assert_array_equal(p, _params_of(outs[0], tag)[k], k)
    # JAX's sp step is the one-device step's; its pp and 3-D steps hand
    # the pb_* leaves the stages' (and model axis') multiple of their
    # gradient: the port's updates times that factor are JAX's
    start = {k[len(f"{tag}::w::"):]: v for k, v in _arrays(world).items()
             if k.startswith(f"{tag}::w::")}
    assert set(jparams) == set(one)
    for k, w in jparams.items():
        factor = 1
        if tag != "sp" and ".pb_" in k:
            factor = 2 * (2 if tag == "three" and k.endswith(
                tuple(f".{n}" for n in tts._TP_SLICED)) else 1)
        got = start[k] + factor * (outs[0][f"{tag}::p::{k}"] - start[k])
        _close(got, w, JAX_PARAMS, f"{tag} {k} (x{factor})")


def _params_of(out: dict, tag: str) -> dict:
    prefix = f"{tag}::p::"
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


def _arrays(world) -> dict:
    _, _, tmp = world
    return dict(np.load(tmp / "in.npz"))


@pytest.mark.parametrize("tag", list(CASES))
def test_mesh_eval_matches_jax_and_one_process(world, tag):
    """The eval step on the mesh: the loss and the gathered probabilities
    of the one-process eval, and for sp within JAX's bounds of JAX's sp
    eval step."""
    want, outs, _ = world
    for out in outs:
        np.testing.assert_allclose(
            float(out[f"{tag}_eval::loss"]),
            float(outs[0][f"one_{tag}_eval::loss"]), rtol=1e-5)
        _close(out[f"{tag}_eval::probs"], outs[0][f"one_{tag}_eval::probs"],
               dict(atol=1e-6, rtol=1e-5), "probs")
        if tag == "sp":
            jloss, jprobs = want["sp_eval"]
            np.testing.assert_allclose(float(out["sp_eval::loss"]), jloss,
                                       rtol=EVAL_LOSS)
            _close(out["sp_eval::probs"], jprobs, EVAL_PROBS, "probs")


@pytest.mark.parametrize("tag", list(CASES))
def test_multi_step_matches_separate_steps(world, tag):
    _, outs, _ = world
    for out in outs:
        _close_params(out, f"{tag}_multi", _params_of(out, f"{tag}_separate"))
        assert np.isfinite(out[f"{tag}_multi::loss"])


def test_kernel_wrappers_on_the_mesh_paths(world):
    """The pp stages run the fused block (its wrapper every tick and
    block, twice with the stage's rematerialisation), the sp blocks the
    kernel ring, the 3-D stages kernel 3's wrapper on the rank's heads."""
    _, outs, _ = world
    # pp: 3 ticks x 2 blocks, forward and the backward's recompute
    # sp: 2 blocks; 3-D: 3 ticks x 2 blocks x (forward + recompute)
    for out in outs:
        assert out["pp::calls"] == 12
        assert out["sp::calls"] == 2
        assert out["three::calls"] == 12


def test_moe_ffn_matches_jax(world):
    """``moe_ffn`` over four ranks against JAX's on four virtual devices:
    the output and aux on every rank, the gradients summed over the
    ranks."""
    want, outs, _ = world
    jw = want["ffn"]
    for out in outs:
        _close(out["ffn::y"], jw["y"], dict(atol=1e-6, rtol=1e-6), "y")
        np.testing.assert_allclose(float(out["ffn::aux"]), jw["aux"],
                                   atol=1e-5)
    _close(sum(o["ffn::dx"] for o in outs), jw["grads"][1], MOE_GRADS, "dx")
    for k, g in jw["grads"][0].items():
        _close(sum(o[f"ffn::d{k}"] for o in outs), g, MOE_GRADS, k)


@pytest.mark.parametrize("tag", ["ep", "ep_remat", "indivisible", "square"])
def test_moe_steps_match_jax_and_one_process(world, tag):
    """moe_ep on a data axis of 4 (E = 8: through ``moe_ffn_ep_rows``, 2
    experts a rank) against the dense DP step, JAX's moe_ep step and the
    one-process step; with remat, the recompute routed as the forward was
    and the step the plain one's; E = 6 does not divide and runs dense, as
    the one-process step; MoE-ViViT on the (2, 2) mesh with its experts
    split over ``model`` at rest against JAX's gspmd step."""
    want, outs, _ = world
    one = _one(outs, tag)
    for out in outs:
        # the one MoE block: once in the step (and once more in its
        # recompute with remat), once more in the eval
        calls = {"ep": 1, "ep_remat": 2}.get(tag, 0)
        assert int(out[f"{tag}::calls"]) == calls
        if tag == "ep":
            assert int(out["ep_eval::calls"]) == 2
        loss = float(out[f"{tag}::loss"])
        np.testing.assert_allclose(loss, float(outs[0][f"one_{tag}::loss"]),
                                   rtol=1e-5)
        _close_params(out, tag, one)
        if tag in want:
            jloss, jparams = want[tag]
            np.testing.assert_allclose(loss, jloss, rtol=1e-5)
            _close_params(out, tag, jparams, JAX_PARAMS)
        if tag == "ep_remat":
            assert loss == float(out["ep::loss"])     # bit for bit
            _close_params(out, tag, _params_of(out, "ep"))
        if tag == "ep":
            _close_params(out, tag, _params_of(out, "dense"))
            np.testing.assert_allclose(float(out["ep::moe_aux"]),
                                       float(out["dense::moe_aux"]),
                                       rtol=1e-5)
            np.testing.assert_allclose(float(out["ep_eval::loss"]),
                                       float(out["dense_eval::loss"]),
                                       rtol=1e-5)
            _close(out["ep_eval::probs"], out["dense_eval::probs"],
                   dict(atol=1e-6, rtol=1e-5), "probs")
    split = outs[0]["square::split"].tolist()
    assert {"space_transformer.blocks.1.moe_w1",
            "space_transformer.blocks.1.moe_b2"} <= set(split)
    assert str(outs[0]["ep::strategy"]) == "dp_shard_map"
    assert str(outs[0]["square::strategy"]) == "gspmd"


@pytest.mark.parametrize("tag", list(MAIN_RUNS))
def test_main_on_the_meshes_matches_one_process(world, main_runs, tag):
    """``main`` with ``--pp 2``, ``--sp 2`` and ``--moe_ep true`` over the
    four ranks ends at the one-process run's test loss."""
    _, outs, _ = world
    for out in outs:
        np.testing.assert_allclose(float(out[f"main::{tag}"]),
                                   main_runs[tag], rtol=1e-5)


def test_stacked_layout_bridge_and_one_device_forward():
    """``ViTTransformer(pipeline_stages=2)`` and ``(sequence_parallel=
    True)`` declare JAX's stacked ``pb_*`` tree; the bridge carries it both
    ways; the stacked ViViT on one device gives JAX's pp=2 and sp logits,
    and its stack the same output as the per-block ViViT on the same
    blocks (tanh GELU against exact erf: JAX's bound)."""
    import jax
    import jax.numpy as jnp

    from devt_tpu.models.vivit import ViViT as JViViT
    from devt_tpu.tools.convert_pp import convert_vivit_params
    from devt_tpu_torch.models.vivit import ViViT
    from devt_tpu_torch.utils.jax_bridge import (jax_to_state_dict,
                                                 state_dict_to_jax)

    rng = np.random.default_rng(3)
    kw = dict(VIT, dim=16, depth=4, heads=2, dim_head=8)
    x = rng.standard_normal((2, 2, 32, 32, 3)).astype(np.float32)
    jmodel = JViViT(attention_impl="auto", pipeline_stages=2, **kw)
    v = _numpy_variables(jmodel, rng, jnp.zeros((1, 2, 32, 32, 3)))
    sd = jax_to_state_dict(v)
    want = np.asarray(jax.jit(jmodel.apply)(v, jnp.asarray(x)))
    for flag in (dict(pipeline_stages=2), dict(sequence_parallel=True)):
        model = ViViT(attention_impl="auto", **kw, **flag)
        assert set(dict(model.named_parameters())) == set(sd)
        for k, t in model.state_dict().items():
            assert t.shape == sd[k].shape, k
        model.load_state_dict(sd)
        back = state_dict_to_jax(model.state_dict())["params"]
        for path, leaf in jax.tree_util.tree_leaves_with_path(v["params"]):
            got = back
            for p in path:
                got = got[p.key]
            np.testing.assert_array_equal(got, np.asarray(leaf))
        with torch.no_grad():
            got = model.eval()(torch.tensor(x)).numpy()
        # pp and sp declare the same tree: JAX's pp=2 logits for both
        _close(got, want, dict(rtol=1e-4, atol=1e-5), str(flag))
    # the same blocks in the per-block layout (JAX's converter)
    std = JViViT(attention_impl="xla", **kw)
    sv = _numpy_variables(std, rng, jnp.zeros((1, 2, 32, 32, 3)))
    stacked = convert_vivit_params(dict(sv["params"]), "stacked")
    plain = ViViT(attention_impl="xla", **kw)
    plain.load_state_dict(jax_to_state_dict(sv))
    model = ViViT(attention_impl="auto", pipeline_stages=2, **kw)
    model.load_state_dict(jax_to_state_dict({"params": stacked}))
    with torch.no_grad():
        a = plain.eval()(torch.tensor(x)).numpy()
        b = model.eval()(torch.tensor(x)).numpy()
    _close(b, a, dict(rtol=0, atol=3e-3), "stacked vs per-block")


def test_stacked_stack_refusals():
    """pp and sp need dropout 0 and no MoE blocks, and a depth the stages
    divide (JAX's assertions, as ``ValueError``)."""
    for kw in (dict(pipeline_stages=2, dropout=0.1),
               dict(sequence_parallel=True, moe_experts=2),
               dict(pipeline_stages=3)):
        with pytest.raises(ValueError):
            tlayers.ViTTransformer(16, 4, 2, 8, 32, **kw)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), *sys.argv[2:6])
