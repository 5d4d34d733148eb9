"""The port's FSDP and tensor parallelism against the JAX package's, on the
CPU.

Four ranks join a Gloo group through a file in the test's temporary
directory and run this file as their script (``python
tests/test_torch_fsdp_tp.py <rank> ...``, which imports no JAX), once for
the whole file, while the test process computes the JAX package's side on
the virtual CPU devices with the same weights (``utils.jax_bridge``) and
batches.  The ranks lay out a (data 1, model 4), a (data 2, model 2) and
a (data 4) mesh in turn.

Cases, mirroring ``tests/test_tp_block.py`` and ``tests/test_fsdp.py``,
and their tolerances:

  * the Megatron block (width 64, 4 heads, MLP 128, f32) on a model axis
    of 4 against JAX's ``tp_vit_block`` on 4 virtual devices and against
    the one-device block: the output within atol 2e-5 / rtol 2e-4, ``dx``
    and every parameter gradient within 5e-5 / 5e-4; the same on the
    (2, 2) mesh with the batch split over ``data`` (JAX's at kv_len 13, as
    its own test); kernel 3's wrapper (``fused_mha``) reached on every
    rank, with the rank's heads;
  * the split and its inverse equal to JAX's on the same arrays; the
    partition rules and FSDP's shape rule on JAX's own cases;
  * the tensor-parallel step on the (2, 2) mesh: a tiny ViViT (its space
    block on the Megatron block, its temporal block on column- and
    row-parallel products) and PTN (column- and row-parallel encoder
    layers), SGD with the schedule off, against JAX's gspmd step on the
    same (2, 2) mesh of virtual devices (the state placed by its Megatron
    rules): the loss within JAX's bound of its TP step against its
    one-device step (rtol 2e-5), the parameters, put back whole, within
    rtol 1e-5 / atol 1e-6 of JAX's new parameters and of the port's
    one-process step's, the whole leaves equal on the ranks of the model
    axis, the eval loss and gathered probabilities within 2e-5 / 2e-4 of
    JAX's;
  * FSDP on a data axis of 4 (PTN, f32, SGD): the step and accumulation
    over 2 microbatches against JAX's FSDP steps on 4 virtual devices, the
    ``fsdp_gspmd`` formulations (global-norm clipping; Adafactor at width
    128, whose row and column statistics are factored) against JAX's
    fsdp_gspmd steps, the loss within rtol 1e-5 and the parameters within
    rtol 1e-5 / atol 1e-6 of JAX's new ones and of the port's one-process
    step's; the eval step against JAX's FSDP eval step;
    ``make_multi_step(2)`` against two steps; each matrix a quarter a rank
    at rest; the fused block reached on the FSDP route of a tiny ViViT;
  * ``remat=True`` on both meshes: ViViT (``ViTTransformer``'s blocks)
    and PTN (``TorchTransformerEncoder``'s layers) on the (2, 2) tensor-
    parallel mesh, PTN and ViViT (its blocks unfused, as JAX's run on the
    CPU) under FSDP on the data axis of 4; each
    step's loss equal to the same step's without remat bit for bit, its
    parameters within ``tests/test_torch_remat.py``'s rtol 1e-5 / atol
    1e-7 of that step's, and the loss and parameters against JAX's remat
    step on the same mesh within the bounds above;
  * ``main`` in the world of four: ``--dp_mode fsdp`` on a data axis of 4
    writes a checkpoint in the one-device format, and ``--dp 2 --mp 2``
    resumes from it (the state split again by the Megatron rules); both
    end on the one-process runs' parameters within rtol 1e-5 / atol 1e-7.

SGD with the schedule off, not Adam: Adam's update does not see a
gradient off by a constant factor (FSDP's division by the ranks), SGD's
does.
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
from devt_tpu_torch.parallel import fsdp as tfsdp  # noqa: E402
from devt_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from devt_tpu_torch.parallel import sharding as tsharding  # noqa: E402
from devt_tpu_torch.parallel import tp_block as ttp  # noqa: E402
from devt_tpu_torch.parallel import train_step as tts  # noqa: E402
from devt_tpu_torch.train import optimizers as topt  # noqa: E402
from devt_tpu_torch.train.state import TrainState, model_buffers  # noqa: E402
from tests.test_torch_dp import MAIN, _batch, _flat, _put, _sd  # noqa: E402

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

RANKS = 4
DIM, MLP, HEADS, B, S = 64, 128, 4, 2, 16
SCALE = (DIM // HEADS) ** -0.5
KV = 13
VIVIT_KW = dict(image_size=32, patch_size=16, num_classes=7, num_frames=2,
                dim=32, depth=1, heads=2, dim_head=16, channels_last=True)
SGD = dict(opt="sgd", learning_rate=0.5, momentum=0.0, weight_decay=0.0)
VIVIT = dict(model="vivit", batch_size=8, frame_len=2, n_classes=7,
             precision="f32", attention_impl="auto", dropout=0.0, **SGD)
PTN_KW = dict(model="ptn", seq_len=4, nlayers=1, input_dimension=64, nhid=64,
              nhead=2, dropout=0.0, n_classes=15, experts=("a", "b"),
              precision="f32", **SGD)
PTN_TP = dict(PTN_KW, attention_impl="auto", batch_size=8)
PTN_FSDP = dict(PTN_KW, attention_impl="xla", batch_size=8, dp_mode="fsdp")
PTN_WIDE = dict(PTN_FSDP, input_dimension=128, nhid=128)
CASES = {"fsdp": PTN_FSDP, "accum": dict(PTN_FSDP, accum_steps=2,
                                          batch_size=16),
         "clip": dict(PTN_FSDP, grad_clip_norm=0.01),
         "adafactor": dict(PTN_WIDE, opt="adafactor", learning_rate=1e-2)}
FSDP_VIVIT = dict(VIVIT, dp_mode="fsdp", batch_size=4)
# the remat steps and the step without remat each is held to; the FSDP
# ViViT on the unfused blocks (attention_impl "xla") on both sides, as
# JAX's runs them on the CPU
REMAT = {"vivit_remat": "vivit", "ptn_remat": "ptn", "fsdp_remat": "fsdp",
         "fvivit_remat": "fvivit_xla"}
BATCH_OF = {"vivit_remat": "vivit", "ptn_remat": "ptn", "fsdp_remat": "fsdp",
            "fvivit_remat": "fvivit", "fvivit_xla": "fvivit"}
TP_MAIN = ["--dp", "2", "--mp", "2", "--attention_impl", "auto"]
FSDP_MAIN = ["--dp", "4", "--dp_mode", "fsdp"]
SEED = 0

BLOCK_FWD, BLOCK_BWD = dict(atol=2e-5, rtol=2e-4), dict(atol=5e-5, rtol=5e-4)
REMAT_PARAMS = dict(rtol=1e-5, atol=1e-7)
TP_LOSS, FSDP_LOSS = 2e-5, 1e-5
PARAMS = dict(rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the ranks (this file as their script: no JAX)
# ---------------------------------------------------------------------------

def _block_params(a: dict) -> dict:
    return {k[len("blk::"):]: torch.tensor(v) for k, v in a.items()
            if k.startswith("blk::")}


def _tp_block(a: dict, mesh, batch_axis=None) -> dict:
    """The Megatron block's output at kv_len S and KV, and its gradients
    at KV, put back whole; kernel 3's wrapper counted by a spy."""
    calls = []
    real = ttp.fused_mha

    def spy(qkv, **kw):
        calls.append((kw["heads"], qkv.shape[-1]))
        return real(qkv, **kw)

    ttp.fused_mha = spy
    try:
        out = {}
        for kv in (S, KV):
            params = {k: v.requires_grad_(True)
                      for k, v in _block_params(a).items()}
            x = torch.tensor(a["x"]).requires_grad_(True)
            y = ttp.tp_vit_block(x, params, mesh, heads=HEADS, scale=SCALE,
                                 kv_len=kv, batch_axis=batch_axis)
            out[f"y{kv}"] = y.detach().numpy()
            if kv == KV:
                torch.sin(y).sum().backward()
                out["dx"] = x.grad.numpy()
                for k, p in params.items():
                    out[f"d::{k}"] = p.grad.numpy()
    finally:
        ttp.fused_mha = real
    out["calls"] = np.array(calls)
    return out


def _whole_params(state, mesh) -> dict:
    from devt_tpu_torch.parallel import collectives, layout

    with collectives.axis_scope(mesh.axes()):
        whole = layout.whole_state(state)
    return {k: v.detach().numpy().copy() for k, v in whole.params.items()}


def _record(out: dict, tag: str, state, mesh, metrics) -> None:
    for k, v in _whole_params(state, mesh).items():
        out[f"{tag}::p::{k}"] = v
    out[f"{tag}::loss"] = np.float32(metrics["loss"])


def _state(model, cfg) -> TrainState:
    return TrainState.create(dict(model.named_parameters()),
                             topt.build_optimizer(cfg),
                             model_state=model_buffers(model))


def _vivit(a: dict, remat: bool = False, attention_impl: str = "auto"):
    from devt_tpu_torch.models.vivit import ViViT

    model = ViViT(attention_impl=attention_impl, remat=remat, **VIVIT_KW)
    model.load_state_dict(_sd(a, "vivit::w::"))
    return model


def _ptn(a: dict, prefix: str, cfg: TConfig):
    model = treg.build_model(cfg)
    model.load_state_dict(_sd(a, prefix))
    return model


def _tp_steps(a: dict, mesh) -> dict:
    """The tensor-parallel train and eval steps of ViViT and PTN on the
    (2, 2) mesh, from states split by the Megatron rules."""
    out = {}
    calls = []
    real = ttp.fused_mha

    def spy(qkv, **kw):
        calls.append(kw["heads"])
        return real(qkv, **kw)

    ttp.fused_mha = spy
    try:
        for tag, cfg, model in (
                ("vivit", TConfig(**VIVIT), _vivit(a)),
                ("ptn", TConfig(**PTN_TP),
                 _ptn(a, "ptn::w::", TConfig(**PTN_TP)))):
            batch = tmesh.shard_batch(_batch(a, f"{tag}::b::"), mesh)
            placed = tsharding.shard_variables(
                {"params": {k: p.detach().clone()
                            for k, p in model.named_parameters()}},
                mesh)["params"]
            state = tsharding.shard_train_state(_state(model, cfg), mesh)
            out[f"{tag}::split"] = np.array(sorted(state.shards))
            out[f"{tag}::shard_variables"] = np.array(all(
                torch.equal(placed[k], p) for k, p in state.params.items()))
            state, metrics = tts.make_train_step(model, cfg, mesh=mesh,
                                                 device="cpu")(
                state, batch, SEED)
            _record(out, tag, state, mesh, metrics)
            out[f"{tag}::whole_leaves"] = np.concatenate([
                p.detach().reshape(-1).numpy() for k, p in
                state.params.items() if k not in state.shards])
            if tag == "vivit":
                out["tp_calls"] = np.array(calls)
                model = _vivit(a)
                state = tsharding.shard_train_state(_state(model, cfg), mesh)
                loss, aux = tts.make_eval_step(model, cfg, mesh=mesh,
                                               device="cpu")(state, batch)
                out["vivit_eval::loss"] = loss.numpy()
                out["vivit_eval::probs"] = aux["probs"].numpy()
    finally:
        ttp.fused_mha = real
    for tag, cfg, model in (
            ("vivit_remat", TConfig(**VIVIT, remat=True),
             _vivit(a, remat=True)),
            ("ptn_remat", TConfig(**PTN_TP, remat=True),
             _ptn(a, "ptn::w::", TConfig(**PTN_TP, remat=True)))):
        state = tsharding.shard_train_state(_state(model, cfg), mesh)
        batch = tmesh.shard_batch(_batch(a, f"{BATCH_OF[tag]}::b::"), mesh)
        state, metrics = tts.make_train_step(model, cfg, mesh=mesh,
                                             device="cpu")(
            state, batch, SEED)
        _record(out, tag, state, mesh, metrics)
    return out


def _fsdp_steps(a: dict, mesh) -> dict:
    """FSDP on a data axis of 4: the step, accumulation, the fsdp_gspmd
    formulations, the eval step, make_multi_step and the fused block."""
    from devt_tpu_torch.models import layers

    out = {}
    for tag, kw in CASES.items():
        cfg = TConfig(**kw)
        model = _ptn(a, "wide::w::" if tag == "adafactor" else "ptn::w::",
                     cfg)
        state = tfsdp.shard_train_state(_state(model, cfg), mesh)
        out[f"{tag}::strategy"] = np.array(tts.mesh_strategy(mesh, cfg))
        out[f"{tag}::local"] = np.array([
            [p.numel(), int(np.prod(state.shards[k].shape))]
            for k, p in state.params.items() if k in state.shards])
        state, metrics = tts.make_train_step(model, cfg, mesh=mesh,
                                             device="cpu")(
            state, tmesh.shard_batch(_batch(a, f"{tag}::b::"), mesh), SEED)
        _record(out, tag, state, mesh, metrics)
    cfg = TConfig(**PTN_FSDP)
    # gather_params gives the whole weights; reduce_scatter a rank's part
    # of the sum
    from devt_tpu_torch.parallel import collectives

    model = _ptn(a, "ptn::w::", cfg)
    state = tfsdp.shard_train_state(_state(model, cfg), mesh)
    x = torch.arange(48, dtype=torch.float32).reshape(8, 6)
    index = mesh.axes()["data"].index
    with collectives.axis_scope(mesh.axes()):
        whole = tfsdp.gather_params(state.params, state.shards)
        out["helpers::scatter"] = collectives.reduce_scatter(
            x * (index + 1), "data", 0).numpy()
        # along dim 1 in thirds (a packed qkv's layout): the all-reduce
        # Gloo takes, and the reduce_scatter_tensor route of the other
        # backends on the parts moved to the front (Gloo takes it on CPU)
        y = torch.arange(96, dtype=torch.float32).reshape(8, 12) * (index + 1)
        real = collectives._gloo
        for route, gloo in (("gloo", True), ("tensor", False)):
            collectives._gloo = lambda ax, gloo=gloo: gloo
            try:
                out[f"helpers::scatter_{route}"] = collectives.reduce_scatter(
                    y, "data", 1, 3).numpy()
            finally:
                collectives._gloo = real
    out.update({f"helpers::p::{k}": v.detach().numpy()
                for k, v in whole.items()})
    batch = tmesh.shard_batch(_batch(a, "fsdp::b::"), mesh)
    model = _ptn(a, "ptn::w::", cfg)
    loss, aux = tts.make_eval_step(model, cfg, mesh=mesh, device="cpu")(
        tfsdp.shard_train_state(_state(model, cfg), mesh), batch)
    out["fsdp_eval::loss"] = loss.numpy()
    out["fsdp_eval::probs"] = aux["probs"].numpy()
    separate, fused = _ptn(a, "ptn::w::", cfg), _ptn(a, "ptn::w::", cfg)
    state = tfsdp.shard_train_state(_state(separate, cfg), mesh)
    step = tts.make_train_step(separate, cfg, mesh=mesh, device="cpu")
    for _ in range(2):
        state, _ = step(state, batch, SEED)
    out.update({f"separate::p::{k}": v
                for k, v in _whole_params(state, mesh).items()})
    state, metrics = tts.make_multi_step(fused, cfg, 2, mesh=mesh,
                                         device="cpu")(
        tfsdp.shard_train_state(_state(fused, cfg), mesh),
        {k: np.stack([v, v]) for k, v in batch.items()}, SEED)
    _record(out, "multi", state, mesh, metrics)

    calls = []
    real = layers.fused_vit_block

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    layers.fused_vit_block = spy
    try:
        cfg = TConfig(**FSDP_VIVIT)
        model = _vivit(a)
        state = tfsdp.shard_train_state(_state(model, cfg), mesh)
        state, metrics = tts.make_train_step(model, cfg, mesh=mesh,
                                             device="cpu")(
            state, tmesh.shard_batch(_batch(a, "fvivit::b::"), mesh), SEED)
        _record(out, "fvivit", state, mesh, metrics)
    finally:
        layers.fused_vit_block = real
    out["fvivit::fused_calls"] = np.int64(len(calls))
    for tag, cfg, model in (
            ("fsdp_remat", TConfig(**PTN_FSDP, remat=True),
             _ptn(a, "ptn::w::", TConfig(**PTN_FSDP, remat=True))),
            ("fvivit_xla", TConfig(**FSDP_VIVIT),
             _vivit(a, attention_impl="xla")),
            ("fvivit_remat", TConfig(**FSDP_VIVIT, remat=True),
             _vivit(a, remat=True, attention_impl="xla"))):
        state = tfsdp.shard_train_state(_state(model, cfg), mesh)
        state, metrics = tts.make_train_step(model, cfg, mesh=mesh,
                                             device="cpu")(
            state, tmesh.shard_batch(_batch(a, f"{BATCH_OF[tag]}::b::"),
                                     mesh), SEED)
        _record(out, tag, state, mesh, metrics)
    return out


def _main_runs(workdir: str) -> dict:
    from devt_tpu_torch import main as tmain

    os.chdir(workdir)
    first = tmain.main(MAIN + FSDP_MAIN + [
        "--max_steps", "2", "--name", "f", "--checkpoint_dir", "ck_f"],
        device="cpu")
    second = tmain.main(MAIN + TP_MAIN + [
        "--max_steps", "3", "--name", "t", "--checkpoint_dir", "ck_t",
        "--resume", "ck_f/step_2"], device="cpu")
    return {"main::loss": np.array([first["test/loss"],
                                    second["test/loss"]])}


def _one_process(a: dict) -> dict:
    """The port's one-process steps on the same weights and global
    batches (rank 0, after the meshes' runs): the parameters after the
    step, and its loss."""
    out = {}
    for tag, kw in (("vivit", VIVIT), ("fvivit", FSDP_VIVIT),
                    ("ptn", PTN_TP), *CASES.items()):
        cfg = TConfig(**kw)
        model = _vivit(a) if "vivit" in tag else _ptn(
            a, "wide::w::" if tag == "adafactor" else "ptn::w::", cfg)
        state, metrics = tts.make_train_step(model, cfg, device="cpu")(
            _state(model, cfg), _batch(a, f"{tag}::b::"), SEED)
        out.update({f"one::{tag}::{k}": v.detach().numpy()
                    for k, v in state.params.items()})
        out[f"one::{tag}::loss"] = np.float32(metrics["loss"])
    return out


def _worker(rank: int, init: str, src: str, dst: str, workdir: str) -> None:
    import torch.distributed as dist

    from devt_tpu_torch.parallel import distributed

    # several test workers share the host's cores: one thread a rank
    torch.set_num_threads(1)
    assert distributed.initialize(f"file://{init}", RANKS, rank)
    a = dict(np.load(src))
    # every rank makes every mesh's groups, in the same order
    model_mesh = tmesh.make_mesh(dp=1, mp=RANKS)
    square = tmesh.make_mesh(dp=2, mp=2)
    data_mesh = tmesh.make_mesh(dp=RANKS)
    out = {f"mp4::{k}": v for k, v in _tp_block(a, model_mesh).items()}
    out.update({f"dp2mp2::{k}": v for k, v in
                _tp_block(a, square, batch_axis="data").items()})
    out.update(_tp_steps(a, square))
    out.update(_fsdp_steps(a, data_mesh))
    out.update(_main_runs(workdir))
    if rank == 0:
        out.update(_one_process(a))
    out["coords"] = np.array([square.coords["data"],
                              square.coords["model"]])
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


def _block_inputs(rng):
    def t(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = {"g1": np.ones((1, DIM), np.float32),
              "b1": np.zeros((1, DIM), np.float32),
              "wqkv": t(DIM, 3 * DIM), "wo": t(DIM, DIM),
              "bo": t(1, DIM, scale=0.01),
              "g2": np.ones((1, DIM), np.float32),
              "b2": np.zeros((1, DIM), np.float32),
              "w1": t(DIM, MLP), "bb1": t(1, MLP, scale=0.01),
              "w2": t(MLP, DIM), "bb2": t(1, DIM, scale=0.01)}
    return t(B, S, DIM, scale=1.0), params


def _jax_block(x, params) -> dict:
    """JAX's Megatron block on 4 virtual devices (model 4, and data 2 ×
    model 2) and the one-device block: outputs and gradients."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from devt_tpu.ops.fused_block import reference_vit_block
    from devt_tpu.parallel.tp_block import (tp_shard_block_params,
                                            tp_unshard_block_params,
                                            tp_vit_block_sharded)

    devs = np.asarray(jax.devices()[:RANKS])
    meshes = {"mp4": (Mesh(devs, ("model",)), None, RANKS),
              "dp2mp2": (Mesh(devs.reshape(2, 2), ("data", "model")),
                         "data", 2)}
    x = jnp.asarray(x)
    params = {k: jnp.asarray(v) for k, v in params.items()}
    want = {"ref": {kv: np.asarray(reference_vit_block(
        x, params, HEADS, SCALE, kv)) for kv in (S, KV)}}
    want["ref_grads"] = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(
        lambda x, p: jnp.sum(jnp.sin(reference_vit_block(
            x, p, HEADS, SCALE, KV))), argnums=(0, 1)))(x, params))
    for tag, (mesh, batch_axis, n) in meshes.items():
        rep, shard = tp_shard_block_params(params, n)

        def run(x, rep, shard, kv, mesh=mesh, batch_axis=batch_axis):
            return tp_vit_block_sharded(x, rep, shard, mesh, heads=HEADS,
                                        scale=SCALE, kv_len=kv,
                                        batch_axis=batch_axis,
                                        interpret=True)

        def with_grads(x, rep, shard, run=run):
            # the output at KV and d(sum(sin(y)))/d(x, rep, shard) in one
            # program: the cotangent of sum(sin(y)) is cos(y)
            y, pull = jax.vjp(lambda *a: run(*a, KV), x, rep, shard)
            return y, pull(jnp.cos(y))

        y, (dx, drep, dshard) = jax.jit(with_grads)(x, rep, shard)
        out = {KV: np.asarray(y)}
        if batch_axis is None:
            out[S] = np.asarray(jax.jit(run, static_argnums=3)(
                x, rep, shard, S))
        grads = {k: np.asarray(v) for k, v in
                 tp_unshard_block_params(drep, dshard).items()}
        want[tag] = (out, np.asarray(dx), grads)
    return want


def _numpy_variables(model, rng, example) -> dict:
    """A flax model's variables drawn with numpy on the tree
    ``jax.eval_shape`` gives (no compile): LayerNorm scales about 1,
    kernels at 1/sqrt(fan-in), the other leaves at 0.05."""
    import jax

    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0)},
                            example)

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            return 1.0 + 0.1 * z
        if len(leaf.shape) >= 2:
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


def _ptn_batch(rng, b, width=64):
    return {"experts": rng.standard_normal((b, 4, 2, width),
                                           dtype=np.float32),
            "label": (rng.random((b, 15)) < 0.3).astype(np.float32)}


def _vivit_batch(rng, b):
    return {"vid": rng.standard_normal((b, 2, 32, 32, 3), dtype=np.float32),
            "label": (rng.random((b, 7)) < 0.3).astype(np.float32)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX's side on the virtual devices and every rank's results; the
    port's one-process steps and ``main`` runs to hold them against."""
    import jax
    import jax.numpy as jnp

    from devt_tpu.config import Config as JConfig
    from devt_tpu.models.vivit import ViViT as JViViT
    from devt_tpu.parallel import fsdp as jfsdp
    from devt_tpu.parallel import mesh as jmesh
    from devt_tpu.parallel import sharding as jsharding
    from devt_tpu.parallel import train_step as jts
    from devt_tpu.registry import build_model as jbuild

    tmp = tmp_path_factory.mktemp("fsdp_tp")
    rng = np.random.default_rng(22)
    x, params = _block_inputs(rng)
    jvivit = JViViT(**VIVIT_KW)
    vivit_v = _numpy_variables(jvivit, rng, jnp.zeros((1, 2, 32, 32, 3)))
    jptn = jbuild(JConfig(**PTN_TP))
    ptn_v = _numpy_variables(jptn, rng, jnp.zeros((1, 4, 2, 64)))
    jwide = jbuild(JConfig(**CASES["adafactor"]))
    wide_v = _numpy_variables(jwide, rng, jnp.zeros((1, 4, 2, 128)))
    fsdp_batch = _ptn_batch(rng, 8)
    batches = {"vivit": _vivit_batch(rng, 8), "fvivit": _vivit_batch(rng, 4),
               "ptn": _ptn_batch(rng, 8), "fsdp": fsdp_batch,
               "accum": _ptn_batch(rng, 16), "clip": fsdp_batch,
               "adafactor": _ptn_batch(rng, 8, 128)}
    arrays = {"x": x, **{f"blk::{k}": v for k, v in params.items()},
              **_flat("vivit::w::", vivit_v), **_flat("ptn::w::", ptn_v),
              **_flat("wide::w::", wide_v)}
    for tag, b in batches.items():
        arrays.update(_put(f"{tag}::b::", b))
    procs = _start(tmp, arrays)

    want = {"block": _jax_block(x, params),
            "ptn_weights": {k[len("ptn::w::"):]: v for k, v in arrays.items()
                            if k.startswith("ptn::w::")}}
    key0 = jax.random.PRNGKey(SEED)
    devs = jax.devices()[:RANKS]
    data = jmesh.make_mesh(dp=RANKS, mp=1, devices=devs)
    square = jmesh.make_mesh(dp=2, mp=2, devices=devs)

    def step(tag, model, v, cfg, mesh, place):
        """JAX's step on ``mesh`` from the state as its trainer places it:
        the loss and the new parameters by the port's names."""
        state, metrics = jts.make_train_step(model, cfg, mesh=mesh)(
            place(_jstate(v["params"], cfg), mesh),
            jmesh.shard_batch(batches[BATCH_OF.get(tag, tag)], mesh), key0)
        want[tag] = (float(metrics["loss"]),
                     _flat("", {"params": state.params}))

    # the tensor-parallel steps (gspmd, the Megatron rules; ViViT's space
    # block on JAX's tp_vit_block) on the (2, 2) mesh
    for tag, model, v, kw in (("vivit", jvivit, vivit_v, VIVIT),
                              ("ptn", jptn, ptn_v, PTN_TP)):
        step(tag, model, v, JConfig(**kw), square,
             jsharding.shard_train_state)
    # FSDP on the data axis of 4: the shard_map step and accumulation, and
    # the fsdp_gspmd step with clipping or Adafactor
    for tag in CASES:
        model, v = (jwide, wide_v) if tag == "adafactor" else (jptn, ptn_v)
        step(tag, model, v, JConfig(**CASES[tag]), data,
             jfsdp.shard_train_state)
    # JAX's remat steps (nn.remat replays inside the traced step) on the
    # same meshes
    for tag, model, v, kw, mesh, place in (
            ("vivit_remat", JViViT(**VIVIT_KW, remat=True), vivit_v, VIVIT,
             square, jsharding.shard_train_state),
            ("ptn_remat", jbuild(JConfig(**PTN_TP, remat=True)), ptn_v,
             PTN_TP, square, jsharding.shard_train_state),
            ("fsdp_remat", jbuild(JConfig(**PTN_FSDP, remat=True)), ptn_v,
             PTN_FSDP, data, jfsdp.shard_train_state),
            ("fvivit_remat", JViViT(**VIVIT_KW, attention_impl="xla",
                                    remat=True), vivit_v,
             FSDP_VIVIT, data, jfsdp.shard_train_state)):
        step(tag, model, v, JConfig(**kw, remat=True), mesh, place)
    cfg = JConfig(**VIVIT)
    want["vivit_eval"] = jts.make_eval_step(jvivit, cfg)(
        _jstate(vivit_v["params"], cfg), batches["vivit"])
    cfg = JConfig(**PTN_FSDP)
    want["fsdp_eval"] = jts.make_eval_step(jptn, cfg, mesh=data)(
        jfsdp.shard_train_state(_jstate(ptn_v["params"], cfg), data),
        jmesh.shard_batch(batches["fsdp"], data))
    outs = _finish(procs, tmp)
    one = {}
    for k, v in outs[0].items():
        if k.startswith("one::"):
            tag, name = k[len("one::"):].split("::", 1)
            one.setdefault(tag, {})[name] = v
    for tag in list(one):
        one[f"{tag}::loss"] = float(one[tag].pop("loss"))
    return want, one, outs, tmp / "work"


@pytest.fixture(scope="module")
def main_runs(world, tmp_path_factory):
    """``main`` in this process, the runs the ranks made (``--dp``/``--mp``
    on the one device, as JAX's entry point on one device)."""
    from devt_tpu_torch import main as tmain
    from devt_tpu_torch.train import checkpoint as tckpt

    tmp = tmp_path_factory.mktemp("one_process_main")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        first = tmain.main(MAIN + FSDP_MAIN + [
            "--max_steps", "2", "--name", "f", "--checkpoint_dir", "ck_f"],
            device="cpu")
        second = tmain.main(MAIN + TP_MAIN + [
            "--max_steps", "3", "--name", "t", "--checkpoint_dir", "ck_t",
            "--resume", "ck_f/step_2"], device="cpu")
        ckpts = {c: tckpt.load(str(tmp / c / f"step_{n}"))
                 for c, n in (("ck_f", 2), ("ck_t", 3))}
    finally:
        os.chdir(cwd)
    return [first["test/loss"], second["test/loss"]], ckpts


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got, want, err_msg=msg, **tol)


def _close_params(out: dict, tag: str, want: dict) -> None:
    """Every parameter of ``tag``, put back whole, against ``want`` (JAX's
    step's, or the port's one-process step's).  The key third of an
    attention ``in_proj.bias`` has an exact gradient of 0 (a bias on the
    keys adds a constant to a row of scores): Adafactor's update of its
    rounding noise is a step of either sign, so that third is left out,
    as ``tests/test_torch_dp.py`` does for Adam."""
    prefix = f"{tag}::p::"
    names = {k[len(prefix):] for k in out if k.startswith(prefix)}
    assert names == set(want), names ^ set(want)
    for k, w in want.items():
        g = out[f"{tag}::p::{k}"]
        if k.endswith("in_proj.bias"):
            e = len(w) // 3
            g, w = np.delete(g, np.s_[e:2 * e]), np.delete(w, np.s_[e:2 * e])
        _close(g, w, PARAMS, f"{tag} {k}")


@pytest.mark.parametrize("mesh", ["mp4", "dp2mp2"])
def test_tp_block_matches_jax_and_the_one_device_block(world, mesh):
    want, _, outs, _ = world
    jout, jdx, jgrads = want["block"][mesh]
    for out in outs:
        for kv in (S, KV):
            y = out[f"{mesh}::y{kv}"]
            if kv in jout:          # the composition at KV, as JAX's test
                _close(y, jout[kv], BLOCK_FWD, f"kv {kv} vs tp_vit_block")
            _close(y, want["block"]["ref"][kv], BLOCK_FWD, f"kv {kv}")
        rdx, rgrads = want["block"]["ref_grads"]
        _close(out[f"{mesh}::dx"], jdx, BLOCK_BWD, "dx")
        _close(out[f"{mesh}::dx"], rdx, BLOCK_BWD, "dx vs the block")
        for k, g in jgrads.items():
            got = out[f"{mesh}::d::{k}"]
            _close(got, g.reshape(got.shape), BLOCK_BWD, k)
            _close(got, np.asarray(rgrads[k]).reshape(got.shape), BLOCK_BWD,
                   f"{k} vs the block")
        # kernel 3's wrapper on the rank's heads: 2 calls a kv_len, each
        # with the rank's share of the 8 heads
        n = 4 if mesh == "mp4" else 2
        assert out[f"{mesh}::calls"].tolist() == [
            [HEADS // n, 3 * DIM // n]] * 2


def test_split_and_unsplit_match_jax():
    from devt_tpu.parallel.tp_block import tp_shard_block_params

    _, params = _block_inputs(np.random.default_rng(5))
    for n in (2, 4, 8):
        jrep, jshard = tp_shard_block_params(params, n)
        rep, shard = ttp.tp_shard_block_params(
            {k: torch.tensor(v) for k, v in params.items()}, n)
        for k in jshard:
            np.testing.assert_array_equal(shard[k].numpy(),
                                          np.asarray(jshard[k]), k)
        for k in jrep:
            np.testing.assert_array_equal(rep[k].numpy(),
                                          np.asarray(jrep[k]), k)
        back = ttp.tp_unshard_block_params(rep, shard)
        for k, v in params.items():
            np.testing.assert_array_equal(back[k].numpy(), v, k)


LEAF_CASES = [((64, 192), 8), ((256, 48), 8), ((100, 64), 8), ((7, 13), 8),
              ((512,), 8), ((), 8), ((64, 64), 1), ((4, 6, 8), 2)]


def test_partition_rules_match_jax():
    """FSDP's shape rule on JAX's cases, and the Megatron rules on JAX's
    tiny PTN and ViViT: a torch (out, in) weight takes the reverse of its
    flax kernel's spec; the MoE experts split by expert, as JAX's."""
    from devt_tpu.parallel import fsdp as jfsdp

    for shape, n in LEAF_CASES:
        assert tfsdp.leaf_spec(shape, n) == tuple(jfsdp.leaf_spec(shape, n))
    ptn = treg.build_model(TConfig(**PTN_TP))
    specs = tsharding.param_partition_specs(dict(ptn.named_parameters()))
    layer = "encoder_0.layers.0."
    want = {"self_attn.in_proj.weight": ("model", None),
            "self_attn.out_proj.weight": (None, "model"),
            "linear1.weight": ("model", None),
            "linear2.weight": (None, "model"),
            "self_attn.in_proj.bias": (), "norm1.weight": ()}
    for k, spec in want.items():
        assert specs[layer + k] == spec, k
    from devt_tpu_torch.models.vivit import ViViT

    vivit = ViViT(**VIVIT_KW)
    specs = tsharding.param_partition_specs(dict(vivit.named_parameters()))
    for k, spec in specs.items():
        if k.endswith(("to_qkv.weight", "fc1.weight")):
            assert spec == ("model", None), k
        elif k.endswith(("to_out.weight", "fc2.weight")):
            assert spec == (None, "model"), k
        else:
            assert spec == (), k
    # the switch-MoE experts split by expert, the router whole: JAX's specs
    from devt_tpu.parallel import sharding as jsharding

    shapes = {"moe_router": (4, 2), "moe_w1": (2, 4, 8), "moe_b1": (2, 8),
              "moe_w2": (2, 8, 4), "moe_b2": (2, 4)}
    specs = tsharding.param_partition_specs(
        {f"b.{k}": torch.zeros(v) for k, v in shapes.items()})
    jspecs = jsharding.param_partition_specs(
        {"b": {k: np.zeros(v) for k, v in shapes.items()}})
    for k in shapes:
        assert specs[f"b.{k}"] == tuple(jspecs["b"][k]), k
    assert specs["b.moe_w1"] == ("model", None, None)


def test_fsdp_and_sharding_helpers(world):
    """``gather_params`` puts FSDP's slices back whole, ``reduce_scatter``
    gives each rank its part of the sum (rows; a column of each third, by
    both routes), ``shard_variables`` the slices
    ``shard_train_state`` keeps, and ``train_state_specs`` gives a moment
    its parameter's spec and the step counts none."""
    want, _, outs, _ = world
    x = np.arange(48, dtype=np.float32).reshape(8, 6)
    y = 10 * np.arange(96, dtype=np.float32).reshape(8, 12)
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["helpers::scatter"],
                                      10 * x[2 * r:2 * r + 2])
        for route in ("gloo", "tensor"):
            np.testing.assert_array_equal(out[f"helpers::scatter_{route}"],
                                          y[:, [r, 4 + r, 8 + r]], route)
        for tag in ("vivit", "ptn"):
            assert bool(out[f"{tag}::shard_variables"])
        for k, w in want["ptn_weights"].items():
            np.testing.assert_array_equal(out[f"helpers::p::{k}"], w, k)
    model = treg.build_model(TConfig(**PTN_FSDP))
    state = _state(model, TConfig(**dict(PTN_FSDP, opt="adamW")))
    specs = tfsdp.train_state_specs(state, RANKS)
    assert specs["step"] == ()
    for k, p in state.params.items():
        assert specs["params"][k] == tfsdp.leaf_spec(p.shape, RANKS), k
    adam = specs["opt_state"][0]
    names = list(state.params)
    for moment in ("mu", "nu"):
        assert [adam[moment][i] for i in range(len(names))] == [
            specs["params"][k] for k in names]
    assert adam["count"] == () and specs["opt_state"][2] == {"count": ()}


@pytest.mark.parametrize("tag", ["vivit", "ptn"])
def test_tp_step_on_a_2x2_mesh(world, tag):
    want, one, outs, _ = world
    loss, params = want[tag]
    for out in outs:
        np.testing.assert_allclose(out[f"{tag}::loss"], loss, rtol=TP_LOSS)
        _close_params(out, tag, params)
        _close_params(out, tag, one[tag])
        # qkv, out-projection and the two FFN products of every layer
        split = out[f"{tag}::split"]
        assert len(split) and len(split) % 4 == 0
        assert all(k.endswith(("in_proj.weight", "to_qkv.weight",
                               "out_proj.weight", "to_out.weight",
                               "linear1.weight", "linear2.weight",
                               "fc1.weight", "fc2.weight")) for k in split)
    # the whole leaves are equal on the ranks of a model axis; the ranks
    # of a data axis hold the same slices
    by = {tuple(o["coords"]): o for o in outs}
    for d in (0, 1):
        np.testing.assert_array_equal(by[(d, 0)][f"{tag}::whole_leaves"],
                                      by[(d, 1)][f"{tag}::whole_leaves"])
    if tag == "vivit":
        for out in outs:
            # the space block on kernel 3's wrapper, one of the 2 heads a
            # rank, forward only; the temporal block off it
            assert out["tp_calls"].tolist() == [1]
            loss, aux = want["vivit_eval"]
            np.testing.assert_allclose(out["vivit_eval::loss"], float(loss),
                                       **BLOCK_FWD)
            np.testing.assert_allclose(out["vivit_eval::probs"],
                                       np.asarray(aux["probs"]),
                                       **BLOCK_FWD)


@pytest.mark.parametrize("tag", list(CASES))
def test_fsdp_steps_match_jax(world, tag):
    want, one, outs, _ = world
    for out in outs:
        assert str(out[f"{tag}::strategy"]) == (
            "fsdp_shard_map" if tag in ("fsdp", "accum") else "gspmd")
        loss, params = want[tag]
        np.testing.assert_allclose(out[f"{tag}::loss"], loss,
                                   rtol=FSDP_LOSS)
        _close_params(out, tag, params)
        _close_params(out, tag, one[tag])
        local = out[f"{tag}::local"]
        assert len(local) and (local[:, 0] * RANKS == local[:, 1]).all()


def test_fsdp_eval_multi_step_and_fused_block(world):
    want, one, outs, _ = world
    loss, aux = want["fsdp_eval"]
    for out in outs:
        np.testing.assert_allclose(out["fsdp_eval::loss"], float(loss),
                                   rtol=FSDP_LOSS)
        np.testing.assert_allclose(out["fsdp_eval::probs"],
                                   np.asarray(aux["probs"]), atol=1e-5)
        for k in one["fsdp"]:
            np.testing.assert_allclose(out[f"multi::p::{k}"],
                                       out[f"separate::p::{k}"],
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        # the space block on the gathered weights (the temporal block is
        # pinned to "xla")
        assert int(out["fvivit::fused_calls"]) == 1
        np.testing.assert_allclose(out["fvivit::loss"], one["fvivit::loss"],
                                   rtol=FSDP_LOSS)
        for k, v in one["fvivit"].items():
            _close(out[f"fvivit::p::{k}"], v, PARAMS, k)


@pytest.mark.parametrize("tag", list(REMAT))
def test_remat_steps_match_no_remat_and_jax(world, tag):
    """``remat=True`` trains on the tensor-parallel (2, 2) mesh and under
    FSDP on the data axis of 4 (the replay binds the tensors the forward
    ran with: the rank's TP parts, its gathered FSDP weights): the loss
    is the same step's without remat bit for bit, the parameters within
    ``tests/test_torch_remat.py``'s bound of that step's, and both within
    this file's bounds of JAX's remat step on the same mesh."""
    want, _, outs, _ = world
    base = REMAT[tag]
    loss, params = want[tag]
    tol = FSDP_LOSS if tag.startswith("f") else TP_LOSS
    for out in outs:
        assert out[f"{tag}::loss"] == out[f"{base}::loss"]
        prefix = f"{base}::p::"
        for k in (k[len(prefix):] for k in out if k.startswith(prefix)):
            _close(out[f"{tag}::p::{k}"], out[prefix + k], REMAT_PARAMS,
                   f"{tag} {k} against {base}")
        np.testing.assert_allclose(out[f"{tag}::loss"], loss, rtol=tol)
        _close_params(out, tag, params)


def test_main_fsdp_checkpoint_resumes_on_a_tp_mesh(world, main_runs):
    """``main --dp 4 --dp_mode fsdp`` writes a whole checkpoint, and
    ``main --dp 2 --mp 2`` resumes from it on the Megatron layout: both
    runs end where the one-process runs do."""
    from devt_tpu_torch.train import checkpoint as tckpt

    _, _, outs, work = world
    losses, ckpts = main_runs
    for out in outs:
        np.testing.assert_allclose(out["main::loss"], losses, rtol=1e-5)
    for ck, step in (("ck_f", 2), ("ck_t", 3)):
        assert sorted(os.listdir(work / ck)) == ["config.yaml",
                                                  f"step_{step}"]
        got = tckpt.load(str(work / ck / f"step_{step}"))
        ref = ckpts[ck]
        assert got["step"] == ref["step"] == step
        for k, v in ref["params"].items():
            assert got["params"][k].shape == v.shape, k
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), *sys.argv[2:6])
