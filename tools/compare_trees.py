#!/usr/bin/env python3
"""Two checkouts of the repo on one card, in turns: the wgmma kernels and
the model paths that run them, and the paths that run neither.

    python tools/compare_trees.py PARENT CHANGE [--rounds 2]

PARENT and CHANGE are roots of two checkouts (for example the parent
commit unpacked with ``git archive`` under ``runs/``, and the repo
itself).  Each run is a subprocess in one tree, with that tree's kernel
build directory and its own ``chip_smoke.py``, in the order parent,
change, change, parent (``--rounds 2``).  A run measures, with the same
timer in both trees (CUDA graph replay of 20 calls, 5 replays):

  * kernel 9 at (1536, 197, 64), kv_len 197, q, k, v the head views of a
    packed qkv (the int8 ViViT at token_pad=0);
  * kernel 11 at (1536, 592, 64), kv_len 577 (ViViT at image 384), and
    F.scaled_dot_product_attention on the same live keys;
  * kernel 14 at q (512, 208, 192), kv (512, 208, 384), 197 live columns;
  * kernel 6 at (3584, 2048) x (2048, 6144) and x (2048, 2048), bf16, the
    weight codes in the layout the tree's site registry stores (K-major
    where ``int8_matmul_on_wgmma`` exists, else row-major), and F.linear
    in bf16 at both;
  * kernels 12 (delta and dq) and 13 (dk and dv) at kernel 11's shape on
    the forward's o and lse, and F.scaled_dot_product_attention's backward
    on the live keys (forward + backward through autograd less forward);
  * kernel 10 at (1536, 197, 64), kv_len 197, on the forward's o and lse,
    and SDPA's backward on the same live keys;
  * kernels 1 and 2 (the fused block, forward and backward) at (512, 208,
    192), kv_len 197, MLP 768, and the library's encoder layer (forward,
    and its autograd less the forward);
  * kernels 7 and 8 (the MoE block's attention half, forward and
    backward) at (512, 208, 192), kv_len 197, and the half composed of
    library calls (forward, and its autograd less the forward);
  * kernel 5 (the int8 block) on kernel 1's input, its weight codes as the
    tree's ``quant_block_params`` makes them; and each launch of kernels
    5, 2 and 8 by the profiler's device time;
  * kernel 3 at PTN's serving shape (256, 14, 6144), 8 heads of 256, at
    its training shape (32, 14, 6144), and at the ViT shape (512, 208,
    576), 3 heads of 64, kv_len 197, and F.scaled_dot_product_attention at
    the serving and ViT shapes;
  * kernel 4 (the packed-qkv attention backward) at PTN's training shape
    (32, 14, 6144) and at the ViT shape (512, 208, 576), kv_len 197, at
    dropout 0 and 0.5, on the kernel forward's (o, lse);

then calls the tree's chip_smoke phases 18 (kernel-flash at the kernel 9
shape, its checks), 4, 11 and 7 (ViViT serving in bf16 and int8, and
training at image 224: the int8 bucket-32 call's and a training step's
device ms from their profiles), 14
(PTN training at dropout 0 and 0.5: step ms and a profiled step's device
ms, and kernel 4's share of it), 12 (PTN serving: bf16, int8, int8 at
every site), 16 and 17 (MoE-ViViT serving, and training: step ms, the
host's enqueue ms and a profiled step's device ms; at dropout 0.5, where
its MoE blocks run kernels 3 and 4, step ms and, profiled by the same code
in both trees, a make_train_step step's device ms and kernel 4's share),
20 (eval at image 384), 21 (the int8 ViViT at
token_pad=0), 22 (training at image 384: step ms, the host's enqueue ms,
and from its printed line a profiled step's device ms and kernels 12 +
13's share of it) and 24 (the ring: kernels 14's and 15's times, and
SDPA's backward with the same additive mask) and records their throughputs
and step times.  Each run prints one ``RESULT {json}`` line; the end
prints, per metric, each tree's runs and the mean, and, for every wgmma
instance the two trees' builds share (every ``*_sm90``, ``flash_*``,
``gemm_s8*``, one-shot and packed instance), whether ptxas gave it the
same registers and cuobjdump the same SASS.  Needs one NVIDIA card; builds both
trees' kernels (one nvcc per source).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

CHILD = r'''
import hashlib, json, os, re, subprocess, sys, time
sys.path.insert(0, ".")
import torch
import torch.nn.functional as F
import chip_smoke as cs
from devt_tpu_torch.ops import _build
from devt_tpu_torch.ops import flash_attention as tfa
from devt_tpu_torch.ops import fused_block as fb
from devt_tpu_torch.ops import quant as tq

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def graph_ms(fn, n=20, replays=5):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * n)


t0 = time.perf_counter()
libs = _build.build_all()
res = {"build_s": time.perf_counter() - t0}
# every wgmma instance's registers (ptxas) and a hash of its SASS
# (cuobjdump), keyed by source and demangled name; a trailing template
# argument `false` is dropped, so an instance compiled without an option
# added since keeps its key
regs = {}
for stem, lib in libs.items():
    used, name = {}, None
    for line in lib.with_suffix(".log").read_text().splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            name = found.group(1)
        found = re.search(r"Used (\d+) registers", line)
        if found and name and re.search(r"wgmma|one_shot|packed|sm90|flash_|"
                                        r"gemm_s8", name):
            used[name] = int(found.group(1))
            name = None
    code, name = {}, None
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1) if found.group(1) in used else None
            if name:
                code[name] = hashlib.sha1()
        elif name:   # the instruction text; cuobjdump's padding varies
            code[name].update(" ".join(line.split()).encode())
    pretty = subprocess.run(["c++filt"], input="\n".join(used),
                            capture_output=True, text=True).stdout.split("\n")
    for mangled, shown in zip(used, pretty):
        shown = shown.replace("(anonymous namespace)::", "").split("(")[0]
        key = f"{stem}:" + re.sub(r", false>$", ">", shown.replace("void ", ""))
        regs[key] = [used[mangled], code[mangled].hexdigest()[:16]
                     if mangled in code else None]
print("[regs wgmma] " + json.dumps(regs), flush=True)
with torch.inference_mode():
    q, k, v = cs._packed_heads(512, 197, 3, 64, torch.bfloat16, 1)
    res["k9_ms"] = graph_ms(lambda: tfa.flash_attention(q, k, v,
                                                        return_lse=True))
    q, k, v = cs._packed_heads(512, 592, 3, 64, torch.bfloat16, 2)
    res["k11_ms"] = graph_ms(lambda: tfa.flash_attention(
        q, k, v, kv_len=577, return_lse=True))
    res["k11_sdpa_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
        q, k[:, :, :577], v[:, :, :577], scale=0.125))
    gen = torch.Generator().manual_seed(3)
    rq = torch.randn(512, 208, 192, generator=gen).to(torch.bfloat16).cuda()
    rkv = torch.randn(512, 208, 384, generator=gen).to(torch.bfloat16).cuda()
    col = torch.arange(208, device="cuda")[None]
    mask = torch.where(col < 197, 0.0, -1e30).float()
    res["k14_ms"] = graph_ms(lambda: tfa.ring_step_fwd(rq, rkv, mask,
                                                       heads=3, scale=0.125))
    del q, k, v, rq, rkv
    x = torch.randn(3584, 2048, generator=gen).to(torch.bfloat16).cuda()
    for n in (6144, 2048):
        w = (torch.randn(2048, n, generator=gen) * 2048 ** -0.5).cuda()
        w_q, w_s = tq.quantize_weight(w.to(torch.bfloat16))
        if hasattr(tq, "int8_matmul_on_wgmma"):
            w_q = w_q.t().contiguous().t()
        res[f"k6_n{n}_ms"] = graph_ms(lambda: tq.int8_matmul_fused(x, w_q,
                                                                   w_s))
        w_bf = w.to(torch.bfloat16).t().contiguous()
        res[f"k6_n{n}_linear_ms"] = graph_ms(lambda: F.linear(x, w_bf))
    del x
    q, k, v = cs._packed_heads(512, 592, 3, 64, torch.bfloat16, 2)
    do = torch.randn(512, 3, 592, 64, generator=gen).to(torch.bfloat16).cuda()
    o, lse = tfa.flash_attention(q, k, v, kv_len=577, return_lse=True)
    _, delta = tfa._flash_blocked_dq_cuda(q, k, v, o, lse, do, 0.125, 577)
    res["k12_ms"] = graph_ms(lambda: tfa._flash_blocked_dq_cuda(
        q, k, v, o, lse, do, 0.125, 577))
    res["k13_ms"] = graph_ms(lambda: tfa._flash_blocked_dkv_cuda(
        q, k, v, o, lse, do, delta, 0.125, 577))
    q10, k10, v10 = cs._packed_heads(512, 197, 3, 64, torch.bfloat16, 1)
    o, lse = tfa.flash_attention(q10, k10, v10, return_lse=True)
    do10 = torch.randn(512, 3, 197, 64, generator=gen).to(o.dtype).cuda()
    res["k10_ms"] = graph_ms(lambda: tfa._flash_bwd_cuda(
        q10, k10, v10, o, lse, do10, 0.125, 197))
    for tag, (b, s, heads, d, kv_len) in {
            "k3": (256, 14, 8, 256, 14), "k3_train": (32, 14, 8, 256, 14),
            "k3_vit": (512, 208, 3, 64, 197)}.items():
        qkv = torch.randn(b, s, 3 * heads * d, generator=gen).to(
            o.dtype).cuda()
        res[f"{tag}_ms"] = graph_ms(lambda: tfa.fused_mha(
            qkv, heads=heads, kv_len=kv_len, return_lse=True))
        if tag == "k3_train":
            continue
        split = qkv.reshape(b, s, 3, heads, d)
        hq, hk, hv = (split[:, :, i].transpose(1, 2) for i in range(3))
        res[f"{tag}_sdpa_ms"] = graph_ms(
            lambda: F.scaled_dot_product_attention(
                hq, hk[:, :, :kv_len], hv[:, :, :kv_len], scale=d ** -0.5))
    for tag, (b, s, heads, d, kv_len) in {
            "k4_ptn": (32, 14, 8, 256, 14),
            "k4_vit": (512, 208, 3, 64, 197)}.items():
        qkv = torch.randn(b, s, 3 * heads * d, generator=gen).to(
            o.dtype).cuda()
        do4 = torch.randn(b, s, heads * d, generator=gen).to(o.dtype).cuda()
        for rate in (0.0, 0.5):
            o4, lse4 = tfa.fused_mha(qkv, heads=heads, kv_len=kv_len,
                                     dropout_rate=rate, seed=7,
                                     return_lse=True)
            res[f"{tag}{'_drop' if rate else ''}_ms"] = graph_ms(
                lambda: tfa._mha_bwd_cuda(qkv, o4, lse4, do4, heads,
                                          d ** -0.5, kv_len, rate, 7))
    del q, k, v, o, lse, qkv, o4, lse4, do4
    # the fused block (kernels 1, 2) and the attention half (7, 8)
    x, full = cs._block_inputs(torch.bfloat16, torch.Generator()
                               .manual_seed(4))
    half = {name: full[name] for name in fb.HALF_NAMES}
    res["k1_ms"] = graph_ms(lambda: fb.fused_vit_block(x, full, 3, 0.125,
                                                       197))
    layer, pad = cs._library_layer(torch.bfloat16)
    res["k1_layer_ms"] = graph_ms(lambda: layer(x, src_key_padding_mask=pad))
    _, bu, bres = fb.fused_vit_block(x, full, 3, 0.125, 197)
    dy = torch.randn(x.shape, generator=gen).to(x.dtype).cuda()
    res["k2_ms"] = graph_ms(lambda: fb._bwd_cuda(x, full, bu, bres, dy, 3,
                                                 0.125, 197, 0.0, 0))
    res["k7_ms"] = graph_ms(lambda: fb.fused_attn_half(x, half, 3, 0.125,
                                                       197))
    _, hres = fb.fused_attn_half(x, half, 3, 0.125, 197)
    du = torch.randn(x.shape, generator=gen).to(x.dtype).cuda()
    res["k8_ms"] = graph_ms(lambda: fb._half_bwd_cuda(x, half, hres, du, 3,
                                                      0.125, 197))
    # kernel 5 on the same input, its codes as the tree's quant_block_params
    # makes them
    qp = tq.quant_block_params(full)
    res["k5_ms"] = graph_ms(lambda: tq.quant_fused_vit_block(x, qp, 3, 0.125,
                                                             197))
    # each launch of kernels 5, 2 and 8 by the profiler's device time (a
    # call's mean over 3 calls), keyed by kernel and launch name
    for tag, fn in (
            ("k5", lambda: tq.quant_fused_vit_block(x, qp, 3, 0.125, 197)),
            ("k2", lambda: fb._bwd_cuda(x, full, bu, bres, dy, 3, 0.125, 197,
                                        0.0, 0)),
            ("k8", lambda: fb._half_bwd_cuda(x, half, hres, du, 3, 0.125,
                                             197))):
        for name, ms, n in cs._device_profile(fn)[0]:
            res[f"{tag} launch {name} x{n:g}"] = ms
q, k, v = cs._packed_heads(512, 592, 3, 64, torch.bfloat16, 2)
res["k12_13_sdpa_bwd_ms"] = cs._sdpa_bwd_ms(q, k, v, do.clone(), 577,
                                           0.125)[0]
q10, k10, v10 = cs._packed_heads(512, 197, 3, 64, torch.bfloat16, 1)
res["k10_sdpa_bwd_ms"] = cs._sdpa_bwd_ms(q10, k10, v10, do10.clone(), 197,
                                        0.125)[0]
xc = x.clone()                 # outside inference mode, for autograd
compose, leaves = cs._composed_half(xc, {n: t.clone()
                                         for n, t in half.items()})
xr = xc.clone().requires_grad_(True)
with torch.no_grad():
    res["k7_composed_ms"] = graph_ms(lambda: compose(xc), n=5)
res["k8_composed_ms"] = graph_ms(lambda: torch.autograd.grad(
    compose(xr), (xr, *leaves), du.clone()), n=5) - res["k7_composed_ms"]
layer, pad = cs._library_layer(torch.bfloat16)   # outside inference mode
lx = x.clone().requires_grad_(True)
lleaves = (lx, *layer.parameters())
both = graph_ms(lambda: torch.autograd.grad(
    layer(lx, src_key_padding_mask=pad), lleaves, dy.clone()), n=5)
with torch.no_grad():
    res["k2_layer_ms"] = both - graph_ms(
        lambda: layer(lx, src_key_padding_mask=pad), n=5)
del q, k, v, do, q10, k10, v10, do10, x, xc, xr, full, half, hres, du
del lx, lleaves, layer, dy, bu, bres
cs.phase_flash("bf16", 512, 3, 197, 197, 64, 197)
serve = cs.phase_serve()
res["serve_clips_s"] = serve["clips_per_s"]
res["serve_int8_clips_s"] = cs.phase_serve_int8(serve)["clips_per_s"]
t = cs.phase_train()
res["train224_step_ms"] = t["step_ms"]
res["train224_clips_s"] = t["clips_per_s"]
for rate, pt in cs.phase_train_ptn().items():
    if isinstance(rate, float):
        res[f"ptn_train{rate}_step_ms"] = pt["step_ms"]
        res[f"ptn_train{rate}_device_ms"] = pt["device_ms"]
p = cs.phase_serve_ptn()
for tag in ("bf16", "int8", "int8_all_sites"):
    res[f"ptn_{tag}_rows_s"] = p[tag]["rows_per_s"]
    res[f"ptn_{tag}_forward_ms"] = p[tag]["forward_ms"]
    res[f"ptn_{tag}_device_ms"] = p[tag]["device_ms"]
res["moe_serve_clips_s"] = cs.phase_serve_moe()["clips_per_s"]
m = cs.phase_train_moe()
res["moe_train_step_ms"] = m["step_ms"]
res["moe_train_host_ms"] = m["host_ms"]
res["moe_train_device_ms"] = m["device_ms"]
# MoE-ViViT at dropout 0.5 (kernels 3 and 4 in its MoE blocks): a profiled
# make_train_step step, by the same code in both trees
from devt_tpu_torch.models.vivit import ViViT
from devt_tpu_torch.parallel.train_step import make_train_step
from devt_tpu_torch.train.optimizers import build_optimizer
from devt_tpu_torch.train.state import TrainState
mcfg = cs._moe_config()
dm = ViViT(num_classes=19, num_frames=16, channels_last=True,
           dropout=cs.MOE_DROPOUT, moe_experts=cs.MOE_EXPERTS,
           moe_every=cs.MOE_EVERY, dtype=torch.bfloat16).init_weights(
               torch.Generator().manual_seed(cs.SEED)).cuda()
dstate = TrainState.create(dict(dm.named_parameters()),
                           build_optimizer(mcfg))
dstep = make_train_step(dm, mcfg)
dbatch = cs._train_batch(cs.TRAIN_BATCH, cs.SEED + 4)
rows = cs._traced(lambda: dstep(dstate, dbatch, cs.SEED)[1]["loss"].item())[0]
res["moe_train_drop_device_ms"] = sum(ms for _, ms, _ in rows)
res["moe_train_drop_k4_ms"] = sum(ms for name, ms, _ in rows
                                  if name.startswith("mha_bwd_"))
del dm, dstate, dstep, dbatch
e = cs.phase_eval_long()
res["eval_bf16_step_ms"] = e["bf16"]["step_ms"]
res["eval_int8_step_ms"] = e["int8"]["step_ms"]
res["int8_unfused_clips_s"] = cs.phase_serve_int8_unfused()["clips_per_s"]
t = cs.phase_train_long()
res["train_step_ms"] = t["step_ms"]
res["train_host_ms"] = t["host_ms"]
res["train_clips_s"] = t["clips_per_s"]
r = cs.phase_ring("bf16")
res["ring_fwd_ms"] = r["fwd"]["kernel_ms"]
res["ring_bwd_ms"] = r["bwd"]["kernel_ms"]
res["ring_bwd_sdpa_ms"] = r["bwd"]["library_ms"]
res["regs"] = regs
print("RESULT " + json.dumps(res), flush=True)
'''


def run(tree: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    for line in proc.stdout.splitlines():
        if line.startswith("[") and ("wgmma" in line or "clips/s" in line
                                     or "rows/s" in line
                                     or "device_ms" in line):
            print(f"  {line[:400]}")
    if proc.returncode != 0:
        print(proc.stdout[-4000:])
        raise SystemExit(f"{tree}: exit {proc.returncode}")
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    res = json.loads(line[-1][len("RESULT "):])
    # a profiled step's device ms and kernels 12 + 13's share of it, from
    # phase 22's line (a parent's phase prints them without returning them)
    found = re.search(r"\[train-long\].*?device(?:_ms=| )([\d.]+).*?"
                      r"kernels 12 \+ 13(?: with delta)? ([\d.]+) ms",
                      proc.stdout)
    if found:
        res["train_device_ms"] = float(found.group(1))
        res["train_k12_k13_ms"] = float(found.group(2))
    # phase 7's profiled step (device ms, the fused block's forward and
    # backward share) and phase 11's profiled bucket-32 call (device ms =
    # wall x busy), from their printed lines, which both trees print
    found = re.search(r"device total ([\d.]+) ms per step: fused block "
                      r"forward ([\d.]+), fused block backward ([\d.]+)",
                      proc.stdout)
    if found:
        res["train224_device_ms"] = float(found.group(1))
        res["train224_k1_ms"] = float(found.group(2))
        res["train224_k2_ms"] = float(found.group(3))
    # MoE-ViViT's step at dropout 0.5 on the host clock, and kernel 4's
    # share of each profiled PTN step (dropout 0, then 0.5), from phases 17's
    # and 14's lines
    found = re.search(r"\[train-moe\] the same at dropout [\d.]+:.*?"
                      r"step_ms=([\d.]+)", proc.stdout)
    if found:
        res["moe_train_drop_step_ms"] = float(found.group(1))
    for rate, ms in zip((0.0, 0.5), re.findall(
            r"attention backward \(kernel 4\) ([\d.]+)", proc.stdout)):
        res[f"ptn_train{rate}_k4_ms"] = float(ms)
    found = re.search(r"int8 predict, bucket 32: wall ([\d.]+) ms per call, "
                      r"device busy ([\d.]+)%", proc.stdout)
    if found:
        res["serve_int8_device_ms"] = (float(found.group(1))
                                       * float(found.group(2)) / 100)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    trees = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    order = []
    for r in range(args.rounds):
        order += ["parent", "change"] if r % 2 == 0 else ["change", "parent"]
    runs = {"parent": [], "change": []}
    regs = {}
    for name in order:
        print(f"[{name}] {trees[name]}", flush=True)
        res = run(trees[name])
        regs[name] = res.pop("regs")
        print(f"RESULT {name} {json.dumps(res)}", flush=True)
        runs[name].append(res)
    print(f"card: {smi}; order {' '.join(order)}")
    # every metric of either tree (a launch that only one tree makes is
    # "-" in the other)
    keys = list(dict.fromkeys(k for name in ("parent", "change")
                              for r in runs[name] for k in r))
    for key in keys:
        cells = []
        for name in ("parent", "change"):
            vals = [r[key] for r in runs[name] if key in r]
            cells.append(f"{name} " + (" ".join(f"{v:.4f}" for v in vals)
                                       + f" (mean {sum(vals) / len(vals):.4f})"
                                       if vals else "-"))
        print(f"{key}: " + " | ".join(cells))
    par, cha = regs["parent"], regs["change"]
    shared = sorted(set(par) & set(cha))
    moved = [f"{k} {par[k][0]} -> {cha[k][0]} registers"
             for k in shared if par[k][0] != cha[k][0]]
    recoded = [k for k in shared if par[k][1] != cha[k][1]]
    print(f"wgmma instances in both trees: {len(shared)}; with other "
          f"registers: {len(moved)}; with other SASS: {len(recoded)}"
          + "".join(f"\n  {m}" for m in moved + recoded))
    print("  only in the change: " + ", ".join(
        f"{k} ({cha[k][0]} registers)" for k in sorted(set(cha) - set(par))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
