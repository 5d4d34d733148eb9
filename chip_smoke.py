#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (devt_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing a line of its own; any failure exits non-zero:

  1. device  — the card's name, and its name and power limit from nvidia-smi.
  2. build   — compiles every kernel in devt_tpu_torch/ops/csrc with nvcc.
  3. kernel  — the fused ViT-block forward at the ViViT main-path shape
               (512 sequences, 208 tokens, dim 192, kv_len 197), bf16 and
               f32, held against its plain PyTorch version on the card;
               times of the kernel, the plain version and one
               nn.TransformerEncoderLayer (a yardstick only), and the bound.
  4. serve   — ViViT at full width (224², patch 16, 16 frames, dim 192,
               depth 4, 3 heads, MLP 768, 19 classes, bf16, seeded weights)
               behind Predictor(buckets=(1, 8, 32)) on 37 uint8 clips; checks
               the kernel launches (4 per bucket call), the scores, and the
               first clips against the same model run on the CPU.

The last lines are a JSON line of the kernels, the nvidia-smi line, and
{"ok": true, "device": {...}}.  With no CUDA device, or without the
package beside it, the script fails before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SEED = 1130
# main-path shape of the fused block: ViViT space transformer at bucket 32
B, S, D, HEADS, MLP, KV_LEN = 512, 208, 192, 3, 768, 197
# NVIDIA H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 FMA, HBM
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
# |kernel - plain| <= atol + rtol * |plain|.  f32: the two sum in other
# orders.  bf16: the same roundings, but a sum that lands on the other
# side of a bf16 rounding boundary moves one element by an ulp, and y, u
# are stored in bf16 (an ulp is 2^-7 relative at most).
TOL = {"f32": (1e-4, 1e-4), "bf16": (1e-2, 1.6e-2)}
# scores on the card against the same model on the CPU, both bf16
SCORE_ATOL = 2e-2


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_profile(fn, reps: int = 3) -> tuple[list, float, float]:
    """torch.profiler over ``reps`` calls of ``fn``: [(kernel, ms per call,
    launches per call)] by device time, the device-busy share of the wall
    time, and the wall ms per call.  Memory copies count as busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        name = ev.key.replace("(anonymous namespace)::", "")
        name = name.replace("void ", "").split("(")[0][:70]
        rows.append((name, ev.device_time_total / 1e3 / reps,
                     ev.count / reps))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) * reps / 1e3 / wall
    return rows, busy, wall * 1e3 / reps


def _print_profile(tag: str, rows, busy: float, wall_ms: float,
                   top: int) -> None:
    if not rows:
        print(f"[profile] {tag}: no device events traced (not measured)")
        return
    print(f"[profile] {tag}: wall {wall_ms:.3f} ms per call, device busy "
          f"{busy:.1%}")
    for name, ms, n in rows[:top]:
        print(f"[profile]   {ms:9.4f} ms  x{n:g}  {name}")


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _block_inputs(dtype, gen):
    """x with zero pad rows past KV_LEN (as the model pads), and block
    params in the kernel's layout, drawn on the CPU from ``gen``."""
    import torch

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    x = rnd(B, S, D)
    x[:, KV_LEN:] = 0.0
    rows = {"g1": 1.0 + rnd(1, D, scale=0.1), "b1": rnd(1, D, scale=0.1),
            "bo": rnd(1, D, scale=0.02), "g2": 1.0 + rnd(1, D, scale=0.1),
            "b2": rnd(1, D, scale=0.1), "bb1": rnd(1, MLP, scale=0.02),
            "bb2": rnd(1, D, scale=0.02)}
    mats = {"wqkv": rnd(D, 3 * D, scale=D ** -0.5),
            "wo": rnd(D, D, scale=D ** -0.5),
            "w1": rnd(D, MLP, scale=D ** -0.5),
            "w2": rnd(MLP, D, scale=MLP ** -0.5)}
    params = {k: v.cuda() for k, v in rows.items()}
    params.update({k: v.to(dtype).cuda() for k, v in mats.items()})
    return x.to(dtype).cuda(), params


def _bound_ms(itemsize: int, kind: str) -> tuple[float, str]:
    """Least time for one block forward: operations over the peak rate of
    their type against bytes (each input read once, each output written
    once) over the memory rate.  Keys past kv_len need no work."""
    rows = B * S
    flops = 2 * rows * (4 * D * D + 2 * KV_LEN * D + 2 * D * MLP)
    bytes_ = (3 * rows * D * itemsize + rows * 8 * 4
              + (4 * D * D + 2 * D * MLP) * itemsize + (6 * D + MLP) * 4)
    t_ops, t_bytes = flops / PEAK_FLOPS[kind], bytes_ / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _check_close(name, got, want, atol, rtol) -> None:
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    bad = (got - want).abs() > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements off by more than "
            f"atol={atol} rtol={rtol} (max abs err {_max_err(got, want):.3e})")


def phase_kernel(kind: str) -> dict:
    import torch
    import torch.nn.functional as F

    from devt_tpu_torch.ops.fused_block import (fused_vit_block,
                                                fused_vit_block_fwd_plain)

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[kind]
    x, params = _block_inputs(dtype, torch.Generator().manual_seed(SEED))
    scale = (D // HEADS) ** -0.5
    layer = torch.nn.TransformerEncoderLayer(
        D, HEADS, MLP, dropout=0.0, layer_norm_eps=1e-5,
        activation=lambda t: F.gelu(t, approximate="tanh"),
        batch_first=True, norm_first=True, device="cuda", dtype=dtype).eval()
    with torch.no_grad():
        layer.self_attn.in_proj_bias.zero_()     # Wqkv has no bias
    pad_mask = (torch.arange(S, device="cuda") >= KV_LEN).expand(B, S)
    with torch.inference_mode():
        got = fused_vit_block(x, params, HEADS, scale, KV_LEN)
        want = fused_vit_block_fwd_plain(x, params, HEADS, scale, KV_LEN)
        torch.cuda.synchronize()
        atol, rtol = TOL[kind]
        errs = {}
        for name, g, w in zip(("y", "u", "res"), got, want):
            _check_close(f"{kind} {name}", g, w, atol, rtol)
            errs[name] = _max_err(g, w)
        if got[2][..., HEADS + 4:].abs().max().item() != 0.0:
            raise AssertionError("residual lanes past heads+4 must be 0")

        kernel_ms = _time_ms(
            lambda: fused_vit_block(x, params, HEADS, scale, KV_LEN))
        plain_ms = _time_ms(
            lambda: fused_vit_block_fwd_plain(x, params, HEADS, scale,
                                              KV_LEN), iters=5)
        library_ms = _time_ms(lambda: layer(x, src_key_padding_mask=pad_mask))
        _print_profile(f"fused_vit_block {kind}", *_device_profile(
            lambda: fused_vit_block(x, params, HEADS, scale, KV_LEN)), top=4)
    bound_ms, bound_by = _bound_ms(x.element_size(), kind)
    out = {"dtype": kind, "max_abs_err": errs, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"[kernel] fused_vit_block_fwd {kind} ({B},{S},{D}) kv_len "
          f"{KV_LEN}: max_abs_err y={errs['y']:.3e} u={errs['u']:.3e} "
          f"res={errs['res']:.3e} (atol {atol}, rtol {rtol}) | kernel_ms="
          f"{kernel_ms:.4f} plain_ms={plain_ms:.4f} library_ms="
          f"{library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})",
          flush=True)
    return out


def phase_serve() -> dict:
    import numpy as np
    import torch

    from devt_tpu_torch.config import Config
    from devt_tpu_torch.ops.fused_block import fused_vit_block
    from devt_tpu_torch.registry import build_model
    from devt_tpu_torch.serve import Predictor

    cfg = Config(model="vivit", frame_len=16, n_classes=19, precision="bf16",
                 dropout=0.0)
    weights = build_model(cfg, torch.Generator().manual_seed(SEED)) \
        .state_dict()
    pred = Predictor(cfg, weights, buckets=(1, 8, 32))
    clips = np.random.default_rng(SEED).integers(
        0, 256, (37, cfg.frame_len, 224, 224, 3), dtype=np.uint8)
    depth = len(pred.model.space_transformer.blocks)

    fused_vit_block.launches = 0
    out = pred.predict({"vid": clips})
    launches = fused_vit_block.launches

    bucket_calls = 2                       # 37 clips = bucket 32 + bucket 8
    if launches != depth * bucket_calls:
        raise AssertionError(f"fused block launched {launches} times, "
                             f"expected {depth} per bucket call")
    scores = out["scores"]
    if scores.shape != (37, cfg.n_classes) or not np.isfinite(scores).all() \
            or scores.min() < 0.0 or scores.max() > 1.0:
        raise AssertionError(f"bad scores: shape {scores.shape}, range "
                             f"[{scores.min()}, {scores.max()}]")
    cpu = Predictor(cfg, weights, buckets=(2,), device="cpu")
    ref = cpu.predict({"vid": clips[:2]})["scores"]
    score_err = float(np.abs(scores[:2] - ref).max())
    if not score_err <= SCORE_ATOL:
        raise AssertionError(f"card vs CPU scores differ by {score_err:.3e} "
                             f"> {SCORE_ATOL}")

    batch = {"vid": clips[:32]}
    pred.predict(batch)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        pred.predict(batch)
    clips_per_s = 32 * reps / (time.perf_counter() - t0)
    _print_profile("predict, bucket 32", *_device_profile(
        lambda: pred.predict(batch)), top=10)
    print(f"[serve] ViViT bf16 Predictor(buckets=(1, 8, 32)) on 37 u8 clips: "
          f"fused block launches {launches} ({depth} per bucket call x "
          f"{bucket_calls}), scores finite in [{scores.min():.4f}, "
          f"{scores.max():.4f}], card vs CPU max abs err {score_err:.3e} "
          f"(atol {SCORE_ATOL}) | {clips_per_s:.2f} clips/s at bucket 32 "
          f"(host clock, u8 upload included)", flush=True)
    return {"launches": launches, "score_err": score_err,
            "clips_per_s": clips_per_s}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the port is imported only now: without the repo beside the script
    # this raises, before any result is printed
    from devt_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"[device] {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {len(libs)} kernel sources built in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{', '.join(p.name for p in libs.values())}", flush=True)
    for lib in libs.values():
        log = lib.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "Used" in line or "spill" in line:
                print(f"[build]   {line.strip()}")

    bf16 = phase_kernel("bf16")
    phase_kernel("f32")
    serve = phase_serve()

    kernels = [{
        "name": "fused_vit_block_fwd", "route": "cuda",
        "source": "devt_tpu_torch/ops/csrc/fused_block_fwd.cu",
        "replaces": "devt_tpu/ops/fused_block.py:177",
        "launches": serve["launches"],
        "max_abs_err": max(bf16["max_abs_err"].values()),
        "ms": bf16["kernel_ms"], "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"],
        "library_ms": bf16["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
