#!/usr/bin/env python3
"""Two checkouts' fused ViT block kernels (kernels 1 and 2, bf16) against
their plain versions and against an f64 reference, on the same inputs.

    python tools/block_rounding.py PARENT CHANGE

PARENT and CHANGE are roots of two checkouts (for example the parent
commit unpacked with ``git archive`` under ``runs/``, and the repo
itself).  Each tree runs in a subprocess of its own, with its own kernel
build.  The inputs are ``tests/test_torch_cuda.py``'s ``_block`` draws
at dim 192, 3 heads, MLP 768, s 208, at the four dim-192 shapes of
``BLOCK_SM90_SHAPES``, each drawn three ways: weights at 0.1 with the
rows past kv_len zero ("0.1, padded"), weights at 1 / sqrt(fan-in) on
every row ("fan-in"), and at fan-in with zero pad rows ("fan-in,
padded").

Per case and tree it prints:

  * the forward (y, u): the largest |kernel - plain| and how many
    elements lie outside the card tests' tolerance (atol 1e-2, rtol
    1.6e-2) around the plain version; then the kernel's and the plain
    version's distance from the f64 reference, as the largest |error|
    and the elements outside the same tolerance around the reference;
  * the backward (dx and the 11 gradients, the kernel's on its own u
    and res): the largest |kernel - plain| in bf16 ulps of each
    tensor's largest element (the card tests' gate is 4), and the
    kernel's and the plain version's largest distance from the f64
    reference's gradient in the same unit.

The f64 reference is the block's forward without any rounding to bf16
(the bf16 weights widened, LayerNorm, masked softmax attention, tanh
GELU, the exported dropout masks) and its gradients through autograd.
Needs one NVIDIA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r'''
import json, sys
sys.path.insert(0, ".")
import numpy as np
import torch
from devt_tpu_torch.ops import fused_block as fb

torch.backends.cuda.matmul.allow_tf32 = False
DIM, MLP, HEADS, S, SEED = 192, 768, 3, 208, 11
ATOL, RTOL, EPS = 1e-2, 1.6e-2, 2.0 ** -8


def block(b, kv_len, fan_in, pad, seed=4):
    """tests/test_torch_cuda.py's _block at (DIM, MLP, b, S)."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.1):
        return torch.tensor((rng.standard_normal(shape) * scale)
                            .astype(np.float32))

    rows = {"g1": 1.0 + t(1, DIM), "b1": t(1, DIM), "bo": t(1, DIM),
            "g2": 1.0 + t(1, DIM), "b2": t(1, DIM), "bb1": t(1, MLP),
            "bb2": t(1, DIM)}
    wd, wm = (DIM ** -0.5, MLP ** -0.5) if fan_in else (0.1, 0.1)
    mats = {"wqkv": t(DIM, 3 * DIM, scale=wd), "wo": t(DIM, DIM, scale=wd),
            "w1": t(DIM, MLP, scale=wd), "w2": t(MLP, DIM, scale=wm)}
    params = {k: v.cuda() for k, v in rows.items()}
    params.update({k: v.to(torch.bfloat16).cuda() for k, v in mats.items()})
    x = t(b, S, DIM, scale=1.0)
    if pad:
        x[:, kv_len:] = 0.0
    return x.to(torch.bfloat16).cuda(), params


def ref64(x, params, scale, kv_len, keep, rate, dy):
    """The block in f64 with no rounding to bf16, and its gradients."""
    x = x.double().requires_grad_(True)
    p = {k: params[k].double().requires_grad_(True) for k in fb.PARAM_NAMES}
    keep = keep if keep is not None else (None,) * 3

    def ln(v, g, b):
        mu = v.mean(-1, keepdim=True)
        var = ((v - mu) ** 2).mean(-1, keepdim=True)
        return (v - mu) * torch.rsqrt(var + fb.LN_EPS) * g[0] + b[0]

    def drop(v, k):
        return v if k is None else torch.where(k.bool(), v / (1.0 - rate),
                                               torch.zeros_like(v))

    d = DIM // HEADS
    col = torch.arange(S, device=x.device)
    bias = torch.where(col < kv_len, 0.0, float("-inf")).double()
    qkv = ln(x, p["g1"], p["b1"]) @ p["wqkv"]
    outs = []
    for i in range(HEADS):
        q = qkv[..., i * d:(i + 1) * d]
        k = qkv[..., (HEADS + i) * d:(HEADS + i + 1) * d]
        v = qkv[..., (2 * HEADS + i) * d:(2 * HEADS + i + 1) * d]
        outs.append(torch.softmax(q @ k.transpose(1, 2) * scale + bias, -1)
                    @ v)
    u = x + drop(torch.cat(outs, -1) @ p["wo"] + p["bo"][0], keep[0])
    h = drop(fb._gelu(ln(u, p["g2"], p["b2"]) @ p["w1"] + p["bb1"][0]),
             keep[1])
    y = u + drop(h @ p["w2"] + p["bb2"][0], keep[2])
    grads = torch.autograd.grad(y, [x] + [p[k] for k in fb.PARAM_NAMES],
                                dy.double())
    return y.detach(), u.detach(), grads


def outside(got, want):
    return int(((got - want).abs() > ATOL + RTOL * want.abs()).sum())


def ulps(got, want):
    return ((got.double() - want.double()).abs().max()
            / (EPS * want.double().abs().max())).item()


out = []
for b, kv_len, rate, draw in json.loads(sys.argv[1]):
    fan_in, pad = draw != "0.1, padded", draw != "fan-in"
    x, params = block(b, kv_len, fan_in, pad)
    scale = (DIM // HEADS) ** -0.5
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)) \
        .to(x.dtype).cuda()
    keep = fb.dropout_masks(SEED, rate, b, S, DIM, MLP, x.device) \
        if rate > 0.0 else None
    with torch.no_grad():
        y, u, res = fb.fused_vit_block(x, params, HEADS, scale, kv_len,
                                       dropout_rate=rate, seed=SEED)
    py, pu, _ = fb.fused_vit_block_fwd_plain(x, params, HEADS, scale,
                                             kv_len, keep, rate)
    dx, grads = fb._bwd_cuda(x, params, u, res, dy, HEADS, scale, kv_len,
                             rate, SEED)
    pdx, pgrads = fb.fused_vit_block_bwd_plain(x, params, u, res, dy, HEADS,
                                               scale, kv_len, keep, rate)
    ty, tu, tgrads = ref64(x, params, scale, kv_len, keep, rate, dy)
    torch.cuda.synchronize()
    row = {"case": f"b {b}, kv_len {kv_len}, rate {rate}, {draw}"}
    for name, k, p, t in (("y", y, py, ty), ("u", u, pu, tu)):
        k, p = k.double(), p.double()
        row[name] = {
            "kernel-plain max": (k - p).abs().max().item(),
            "kernel-plain outside": outside(k, p),
            "kernel-f64 max": (k - t).abs().max().item(),
            "kernel-f64 outside": outside(k, t),
            "plain-f64 max": (p - t).abs().max().item(),
            "plain-f64 outside": outside(p, t)}
    names = ["dx"] + list(fb.PARAM_NAMES)
    kern = [dx] + [grads[n] for n in fb.PARAM_NAMES]
    plain = [pdx] + [pgrads[n] for n in fb.PARAM_NAMES]
    bwd = {}
    for name, k, p, t in zip(names, kern, plain, tgrads):
        bwd[name] = [ulps(k, p), ulps(k, t.reshape(k.shape)),
                     ulps(p, t.reshape(p.shape))]
    row["bwd ulps (kernel-plain, kernel-f64, plain-f64)"] = bwd
    out.append(row)
print("RESULT " + json.dumps(out), flush=True)
'''

CASES = [[b, kv_len, rate, draw]
         for draw in ("0.1, padded", "fan-in", "fan-in, padded")
         for b, kv_len, rate in ((3, 197, 0.0), (3, 197, 0.1), (2, 1, 0.0),
                                 (2, 208, 0.0))]


def run(tree: str) -> list:
    proc = subprocess.run([sys.executable, "-c", CHILD, json.dumps(CASES)],
                          cwd=tree, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        print(proc.stdout[-4000:])
        raise SystemExit(f"{tree}: exit {proc.returncode}")
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    rows = {name: run(os.path.abspath(tree))
            for name, tree in (("parent", args.parent),
                               ("change", args.change))}
    for i, case in enumerate(rows["parent"]):
        print(f"\n== {case['case']}")
        for name in ("parent", "change"):
            r = rows[name][i]
            fwd = "; ".join(
                f"{t}: vs plain max {r[t]['kernel-plain max']:.4g}, "
                f"{r[t]['kernel-plain outside']} outside; vs f64 kernel "
                f"max {r[t]['kernel-f64 max']:.4g} "
                f"({r[t]['kernel-f64 outside']} outside), plain max "
                f"{r[t]['plain-f64 max']:.4g} "
                f"({r[t]['plain-f64 outside']} outside)" for t in ("y", "u"))
            bwd = r["bwd ulps (kernel-plain, kernel-f64, plain-f64)"]
            worst = max(bwd, key=lambda n: bwd[n][0])
            print(f"  {name} forward {fwd}")
            print(f"  {name} backward ulps of the largest element "
                  f"(kernel-plain, kernel-f64, plain-f64): dx "
                  + ", ".join(f"{v:.3f}" for v in bwd["dx"])
                  + f"; worst vs plain {worst} "
                  + ", ".join(f"{v:.3f}" for v in bwd[worst])
                  + "; largest vs f64: kernel "
                  + f"{max(v[1] for v in bwd.values()):.3f}, plain "
                  + f"{max(v[2] for v in bwd.values()):.3f}")
    print(f"\ncard: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
