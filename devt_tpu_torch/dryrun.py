"""The dry-run entry points of the port: a one-card forward and a
dry run of every parallelism over ranks.  The port's counterpart of
``__graft_entry__.py``.

``entry(device=None)``            ``(fn, args)``: ViViT's forward at 224²,
                                  16 frames, bf16, B = 2 (on the card its
                                  space blocks run kernel 1).
``dryrun_multichip(n, device=None)``
                                  starts ``n`` ranks of one Gloo group on
                                  this host (sharing the card, or on the
                                  CPU with ``device="cpu"``) and runs the
                                  JAX dry run's eleven legs, one forward
                                  and backward each, through the port's
                                  executors: dp×tp, dp_shard_map, the sp
                                  kv ring (plain and kernel tiers), GPipe,
                                  expert-parallel MoE, FSDP, the Megatron
                                  block, the pp trainer, 3-D dp×pp×tp, the
                                  moe_ep trainer and the sp trainer.

Each rank is ``python -m devt_tpu_torch.dryrun --rank R --world N --init
URL``; rank 0 prints the ``[dryrun] legN … done`` lines and the closing
summary, which ``dryrun_multichip`` prints again, and every rank prints
its kernels' launches (``dryrun_multichip.launches`` sums them over the
ranks of the last run).  The legs whose JAX counterparts pin
``attention_impl="xla"`` only because a CPU mesh cannot run Pallas
natively run the port's default here (its kernels on the card, their
plain versions on the CPU), and the moe_ep trainer's ViViT is 32 wide
with heads of 16 (JAX's: 16 and 8), widths the fused attention half
(kernels 7 and 8) takes.  Where ``n`` does not allow a leg's mesh (pp
needs an even ``n``, 3-D and the sp trainer a multiple of 4) the leg is
skipped with a NaN loss, as JAX's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch


def entry(device=None):
    """Returns ``(fn, args)``: ``fn(params, clip)`` is ViViT's forward
    (no gradient), ``args`` its weights (seeded) and a zero clip (2, 16, 3,
    224, 224) in bf16, on ``device`` (the card unless ``"cpu"``)."""
    from devt_tpu_torch.models.vivit import ViViT
    from devt_tpu_torch.serve import resolve_device

    device = resolve_device(device)
    model = ViViT(image_size=224, patch_size=16, num_classes=19,
                  num_frames=16, dtype=torch.bfloat16).init_weights(
        torch.Generator().manual_seed(0)).to(device).eval()
    clip = torch.zeros((2, 16, 3, 224, 224), dtype=torch.bfloat16,
                       device=device)

    def fn(params, clip):
        with torch.no_grad():
            return torch.func.functional_call(model, params, (clip,))

    return fn, (dict(model.named_parameters()), clip)


def _finite(*tensors) -> bool:
    return all(bool(torch.isfinite(t.detach().float()).all())
               for t in tensors)


def _say(rank: int, text: str) -> None:
    if rank == 0:
        print(text, flush=True)


def _state(model, cfg):
    from devt_tpu_torch.train.optimizers import build_optimizer
    from devt_tpu_torch.train.state import TrainState, model_buffers

    return TrainState.create(dict(model.named_parameters()),
                             build_optimizer(cfg),
                             model_state=model_buffers(model))


def _step(model, cfg, mesh, batch, seed, device, place=None):
    """One step of the mesh's executor from a fresh state: (state,
    metrics)."""
    from devt_tpu_torch.parallel.mesh import shard_batch
    from devt_tpu_torch.parallel.train_step import make_train_step

    model.to(device)
    state = _state(model, cfg)
    if place is not None:
        state = place(state, mesh)
    step = make_train_step(model, cfg, mesh=mesh, device=device)
    return step(state, shard_batch(batch, mesh), seed)


def _clips(rng, b: int, classes: int = 7) -> dict:
    return {"vid": rng.standard_normal((b, 2, 32, 32, 3), dtype=np.float32),
            "label": (rng.random((b, classes)) < 0.3).astype(np.float32)}


def _vivit(**kw):
    from devt_tpu_torch.models.vivit import ViViT

    return ViViT(image_size=32, patch_size=16, num_classes=7, num_frames=2,
                 channels_last=True, **kw).init_weights(
        torch.Generator().manual_seed(kw.get("depth", 1)))


def _legs(n: int, device: torch.device) -> str:
    """The eleven legs on this rank of a world of ``n``; returns the
    summary line."""
    import torch.distributed as dist

    from devt_tpu_torch.config import Config
    from devt_tpu_torch.models.layers import ViTBlock, init_weights
    from devt_tpu_torch.parallel import collectives, fsdp, moe, sharding
    from devt_tpu_torch.parallel.mesh import Mesh, make_mesh
    from devt_tpu_torch.parallel.pipeline import PIPE_AXIS, pipelined_stack
    from devt_tpu_torch.parallel.ring_attention import ring_vit_block
    from devt_tpu_torch.parallel.tp_block import (tp_shard_block_params,
                                                  tp_vit_block_sharded)
    from devt_tpu_torch.parallel.train_step import mesh_strategy
    from devt_tpu_torch.registry import build_model

    rank = dist.get_rank()
    whole = np.arange(n)
    mp = 2 if n % 2 == 0 and n >= 4 else 1
    dp = n // mp
    pp_stages = 2 if n % 2 == 0 else 1
    # every rank makes every mesh's groups, in the same order
    mesh = make_mesh(dp=dp, mp=mp)
    data = make_mesh(dp=n, mp=1)
    pp_train = make_mesh(dp=n // pp_stages, pp=pp_stages) \
        if pp_stages > 1 else None
    d3 = make_mesh(dp=n // 4, mp=2, pp=2) if n % 4 == 0 else None
    sp_train = make_mesh(dp=n // 4, sp=4) if n % 4 == 0 else None
    rng = np.random.default_rng(0)

    # --- leg 1: dp x tp, PTN on the (data, model) mesh, the Megatron
    # rules, accumulation over 2 microbatches ---
    cfg = Config(model="ptn", batch_size=2 * dp, seq_len=4, nlayers=2,
                 input_dimension=128, nhid=256, nhead=2, dropout=0.1,
                 n_classes=15, experts=("img-embeddings", "video-embeddings"),
                 opt="adamW", learning_rate=1e-3, precision="f32",
                 attention_impl="xla", accum_steps=2)
    batch = {"experts": rng.standard_normal((2 * dp, 4, 2, 128),
                                            dtype=np.float32),
             "label": (rng.random((2 * dp, 15)) < 0.3).astype(np.float32)}
    state, metrics = _step(build_model(cfg), cfg, mesh, batch, 2, device,
                           sharding.shard_train_state)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"non-finite loss {loss}"
    assert int(state.step) == 1
    _say(rank, "[dryrun] leg1 dp_tp done")

    # --- leg 2: pure DP through the dp_shard_map executor, ViViT with
    # dropout and accumulation ---
    vcfg = Config(model="vivit", batch_size=2 * n, n_classes=7, opt="adamW",
                  learning_rate=1e-3, precision="f32", dropout=0.1,
                  accum_steps=2)
    assert mesh_strategy(data, vcfg) == "dp_shard_map"
    state, metrics = _step(
        _vivit(dim=32, depth=1, heads=2, dim_head=16, dropout=0.1), vcfg,
        data, _clips(rng, 2 * n), 5, device)
    dp_loss = float(metrics["loss"])
    assert np.isfinite(dp_loss), f"non-finite DP loss {dp_loss}"
    assert int(state.step) == 1
    _say(rank, "[dryrun] leg2 dp_shard_map done")

    # --- leg 3: a pre-norm ViT block sequence-parallel over all n ranks
    # (the kv ring), forward and backward, the plain and kernel tiers ---
    D, H, S = 64, 2, 4 * n
    pr = np.random.default_rng(1)

    def P_(*shape):
        return torch.tensor(pr.standard_normal(shape) * 0.1,
                            dtype=torch.float32, device=device)

    def block_params(d, mlp):
        return {"g1": torch.ones(1, d, device=device),
                "b1": torch.zeros(1, d, device=device),
                "wqkv": P_(d, 3 * d), "wo": P_(d, d),
                "bo": torch.zeros(1, d, device=device),
                "g2": torch.ones(1, d, device=device),
                "b2": torch.zeros(1, d, device=device),
                "w1": P_(d, mlp), "bb1": torch.zeros(1, mlp, device=device),
                "w2": P_(mlp, d), "bb2": torch.zeros(1, d, device=device)}

    bparams = block_params(D, 2 * D)
    xs = P_(2, S, D)
    sp_losses = []
    for impl in ("jnp", "pallas"):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in bparams.items()}
        y = ring_vit_block(xs, leaves, dist.group.WORLD, heads=H, impl=impl)
        sp_loss = (y ** 2).sum()
        grads = torch.autograd.grad(sp_loss, list(leaves.values()))
        assert _finite(sp_loss, *grads)
        sp_losses.append(sp_loss.item())
    np.testing.assert_allclose(sp_losses[1], sp_losses[0], rtol=2e-4)
    sp_loss = sp_losses[0]
    _say(rank, "[dryrun] leg3 sp_ring done (plain + kernel tiers)")

    # --- leg 4: an n-stage GPipe pipeline of ViT blocks over all ranks,
    # forward, backward and an SGD update of the stacked stages ---
    pipe = Mesh((PIPE_AXIS,), whole, rank)
    pblock = ViTBlock(dim=16, heads=2, dim_head=8, mlp_dim=32,
                      attention_impl="xla")
    stages = []
    for s in range(n):
        init_weights(pblock, torch.Generator().manual_seed(6 + s))
        stages.append({k: v.detach().clone()
                       for k, v in pblock.named_parameters()})
    pblock.to(device)
    pstacked = {k: torch.stack([st[k] for st in stages]).to(device)
                .requires_grad_(True) for k in stages[0]}
    px = torch.tensor(pr.standard_normal((4, 6, 16)), dtype=torch.float32,
                      device=device)
    out = pipelined_stack(
        pipe, lambda w, h: torch.func.functional_call(pblock, w, (h,)),
        pstacked, px, 2)
    pp_loss = (out ** 2).mean()
    grads = torch.autograd.grad(pp_loss, list(pstacked.values()))
    with collectives.axis_scope(pipe.axes()):
        # each rank holds its stage's share of the gradient: the sum
        grads = collectives.psum(list(grads), PIPE_AXIS)
    pstacked = {k: v.detach() - 0.01 * g
                for (k, v), g in zip(pstacked.items(), grads)}
    assert _finite(pp_loss, *pstacked.values())
    _say(rank, "[dryrun] leg4 pp_gpipe done")

    # --- leg 5: switch-MoE FFN expert-parallel over all ranks, tokens
    # exchanged by all_to_all, forward and backward ---
    expert = Mesh((moe.EXPERT_AXIS,), whole, rank)
    eparams = {k: v.to(device).requires_grad_(True) for k, v in
               moe.init_moe_params(torch.Generator().manual_seed(7),
                                   n_experts=2 * n, d_model=32,
                                   d_hidden=64).items()}
    ex = torch.tensor(pr.standard_normal((8 * n, 32)), dtype=torch.float32,
                      device=device)
    y, aux = moe.moe_ffn(expert, eparams, ex)
    ep_loss = ((ex + y) ** 2).mean() + 0.01 * aux
    grads = torch.autograd.grad(ep_loss, list(eparams.values()))
    assert _finite(ep_loss, *grads)
    _say(rank, "[dryrun] leg5 ep_moe done")

    # --- leg 6: FSDP (ZeRO-3) over all ranks: the state lives sharded
    # over the data axis and stays so after the step ---
    fcfg = cfg.replace(dp_mode="fsdp", batch_size=2 * n)
    fbatch = {"experts": rng.standard_normal((2 * n, 4, 2, 128),
                                             dtype=np.float32),
              "label": (rng.random((2 * n, 15)) < 0.3).astype(np.float32)}
    state, metrics = _step(build_model(fcfg), fcfg, data, fbatch, 8, device,
                           fsdp.shard_train_state)
    fsdp_loss = float(metrics["loss"])
    assert np.isfinite(fsdp_loss), f"non-finite FSDP loss {fsdp_loss}"
    name = "encoder_0.layers.0.linear1.weight"
    assert state.params[name].numel() * n == np.prod(
        state.shards[name].shape)
    _say(rank, "[dryrun] leg6 fsdp done")

    # --- leg 7: a Megatron-split ViT block over all ranks, every rank
    # running the packed-qkv attention (kernel 3) on its heads, two
    # all-reduces a block, forward and backward on the split layout ---
    model_axis = Mesh(("model",), whole, rank)
    tD, tH = 8 * n, n
    trep, tshard = tp_shard_block_params(block_params(tD, 2 * tD), n)
    trep = {k: v.requires_grad_(True) for k, v in trep.items()}
    tshard = {k: v.requires_grad_(True) for k, v in tshard.items()}
    y = tp_vit_block_sharded(P_(2, 16, tD), trep, tshard, model_axis,
                             heads=tH)
    tp_loss = (y ** 2).mean()
    leaves = list(trep.values()) + list(tshard.values())
    grads = dict(zip(list(trep) + list(tshard),
                     torch.autograd.grad(tp_loss, leaves)))
    assert _finite(tp_loss, *grads.values())
    assert grads["wqkv"].shape[0] == n     # the gradients in the TP layout
    _say(rank, "[dryrun] leg7 tp_megatron done")

    # --- leg 8: the pp trainer (config.pp: a (data, pipe) mesh, the
    # pp_shard_map executor), the stacked ViViT's GPipe schedule ---
    pp_train_loss = float("nan")
    if pp_train is not None:
        pcfg = Config(model="vivit", batch_size=2 * (n // pp_stages),
                      n_classes=7, opt="adamW", learning_rate=1e-3,
                      precision="f32", dropout=0.0, pp=pp_stages)
        assert mesh_strategy(pp_train, pcfg) == "pp_shard_map"
        state, metrics = _step(
            _vivit(dim=16, depth=4, heads=2, dim_head=8,
                   pipeline_stages=pp_stages), pcfg, pp_train,
            _clips(pr, pcfg.batch_size), 12, device)
        pp_train_loss = float(metrics["loss"])
        assert np.isfinite(pp_train_loss), \
            f"non-finite PP-trainer loss {pp_train_loss}"
        assert int(state.step) == 1
        _say(rank, "[dryrun] leg8 pp_trainer done")

    # --- leg 9: DP x PP x TP in one step: the (data, pipe, model) mesh,
    # every GPipe stage the Megatron block over the model axis ---
    d3_dp, d3_loss = 0, float("nan")
    if d3 is not None:
        d3_dp = n // 4
        d3cfg = Config(model="vivit", batch_size=4 * d3_dp, n_classes=7,
                       opt="adamW", learning_rate=1e-3, precision="f32",
                       dropout=0.0, pp=2, mp=2)
        assert d3.shape == {"data": d3_dp, "pipe": 2, "model": 2}
        assert mesh_strategy(d3, d3cfg) == "pp_shard_map"
        state, metrics = _step(
            _vivit(dim=32, depth=4, heads=2, dim_head=16, scale_dim=2,
                   pipeline_stages=2), d3cfg, d3,
            _clips(pr, d3cfg.batch_size), 22, device)
        d3_loss = float(metrics["loss"])
        assert np.isfinite(d3_loss), f"non-finite 3-D loss {d3_loss}"
        assert int(state.step) == 1
        _say(rank, "[dryrun] leg9 dp_pp_tp_3d done")

    # --- leg 10: the moe_ep trainer (config.moe_ep): MoE-ViViT on the
    # data axis, the experts E/n a rank, two all_to_alls a MoE block ---
    epcfg = Config(model="vivit", batch_size=2 * n, n_classes=7,
                   opt="adamW", learning_rate=1e-3, precision="f32",
                   dropout=0.0, moe_experts=n, moe_capacity_factor=2.0,
                   moe_ep=True)
    assert mesh_strategy(data, epcfg) == "dp_shard_map"
    state, metrics = _step(
        _vivit(dim=32, depth=2, heads=2, dim_head=16, moe_experts=n,
               moe_capacity_factor=2.0), epcfg, data,
        _clips(pr, epcfg.batch_size), 33, device)
    ep_train_loss = float(metrics["loss"])
    assert np.isfinite(ep_train_loss), \
        f"non-finite EP-trainer loss {ep_train_loss}"
    assert np.isfinite(float(metrics["moe_aux"]))
    _say(rank, "[dryrun] leg10 moe_ep_trainer done")

    # --- leg 11: the sp trainer (config.sp: a (data, seq) mesh, the
    # sp_shard_map executor), every space block on the kv ring ---
    sp_dp, sp_train_loss = 0, float("nan")
    if sp_train is not None:
        sp_dp = n // 4
        spcfg = Config(model="vivit", batch_size=2 * sp_dp, n_classes=7,
                       opt="adamW", learning_rate=1e-3, precision="f32",
                       dropout=0.0, sp=4)
        assert mesh_strategy(sp_train, spcfg) == "sp_shard_map"
        state, metrics = _step(
            _vivit(dim=16, depth=4, heads=2, dim_head=8,
                   sequence_parallel=True), spcfg, sp_train,
            _clips(pr, spcfg.batch_size), 42, device)
        sp_train_loss = float(metrics["loss"])
        assert np.isfinite(sp_train_loss), \
            f"non-finite SP-trainer loss {sp_train_loss}"
        assert int(state.step) == 1
        _say(rank, "[dryrun] leg11 sp_trainer done")

    return (f"dryrun_multichip({n}): mesh=({dp},{mp}) loss={loss:.4f} "
            f"dp_shard_map({n}) loss={dp_loss:.4f} "
            f"sp_ring(n={n}) loss={sp_loss:.2f} "
            f"pp_gpipe(n={n}) loss={pp_loss.item():.4f} "
            f"ep_moe(E={2 * n}) loss={ep_loss.item():.4f} "
            f"fsdp(n={n}) loss={fsdp_loss:.4f} "
            f"tp_megatron(n={n}) loss={tp_loss.item():.4f} "
            f"pp_trainer(dp={n // pp_stages},pp={pp_stages}) "
            f"loss={pp_train_loss:.4f} "
            f"dp_pp_tp_3d({d3_dp}x2x2) loss={d3_loss:.4f} "
            f"moe_ep_trainer(dp={n},E={n}) loss={ep_train_loss:.4f} "
            f"sp_trainer(dp={sp_dp},sp=4) loss={sp_train_loss:.4f} OK")


def launch_counts() -> dict:
    """The launches of kernels 1-15 this process has counted (the
    wrappers' counters), by kernel number."""
    from devt_tpu_torch.ops import flash_attention as tfa
    from devt_tpu_torch.ops import fused_block as fb
    from devt_tpu_torch.ops import quant as tq

    fa = tfa.flash_attention
    return {"k1": fb.fused_vit_block.launches,
            "k2": fb.fused_vit_block.bwd_launches,
            "k3": tfa.fused_mha.launches, "k4": tfa.fused_mha.bwd_launches,
            "k5": tq.quant_fused_vit_block.launches,
            "k7": fb.fused_attn_half.launches,
            "k8": fb.fused_attn_half.bwd_launches,
            "k9": fa.single_launches, "k10": fa.single_bwd_launches,
            "k11": fa.blocked_launches, "k12": fa.blocked_dq_launches,
            "k13": fa.blocked_dkv_launches,
            "k14": tfa.ring_step_fwd.launches,
            "k15": tfa.ring_step_bwd.launches}


def _rank_main(argv=None) -> int:
    import torch.distributed as dist

    from devt_tpu_torch.parallel import distributed

    ap = argparse.ArgumentParser(description="one rank of the dry run")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True, help="init_method URL")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)    # the ranks share the host's cores
    distributed.initialize(args.init, args.world, args.rank)
    device = (torch.device("cuda", torch.cuda.current_device())
              if args.device != "cpu" else torch.device("cpu"))
    try:
        summary = _legs(args.world, device)
        _say(args.rank, summary)
        print(f"[dryrun-launches] {json.dumps(launch_counts())}",
              flush=True)
        dist.barrier()         # no rank leaves while another still talks
    finally:
        dist.destroy_process_group()
    return 0


def dryrun_multichip(n_devices: int, device=None,
                     timeout: float = 900.0) -> str:
    """The eleven legs over ``n_devices`` ranks of one Gloo group on this
    host, on ``device`` (the card unless ``"cpu"``).  Prints rank 0's
    ``[dryrun]`` lines and summary, and returns the summary; raises
    ``RuntimeError`` with the ranks' output when one fails."""
    from devt_tpu_torch.serve import resolve_device

    dev = resolve_device(device)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
           "OMP_NUM_THREADS": "1"}
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(key, None)
    with tempfile.TemporaryDirectory(prefix="devt_dryrun_") as tmp:
        init = f"file://{os.path.join(tmp, 'init')}"
        procs = [subprocess.Popen(
            [sys.executable, "-m", "devt_tpu_torch.dryrun", "--rank", str(r),
             "--world", str(n_devices), "--init", init,
             "--device", dev.type],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for r in range(n_devices)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(
            f"dry run ranks {failed} failed:\n" + "\n".join(
                f"--- rank {r} ---\n{logs[r]}" for r in failed))
    lines = [ln for ln in logs[0].splitlines()
             if ln.startswith(("[dryrun]", "dryrun_multichip("))]
    for ln in lines:
        print(ln, flush=True)
    counts = [json.loads(ln.split(" ", 1)[1]) for log in logs
              for ln in log.splitlines()
              if ln.startswith("[dryrun-launches] ")]
    dryrun_multichip.launches = {k: sum(c[k] for c in counts)
                                 for k in counts[0]}
    return lines[-1]


dryrun_multichip.launches = {}


if __name__ == "__main__":
    sys.exit(_rank_main())
