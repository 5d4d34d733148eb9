#!/usr/bin/env python3
"""Variants of the wgmma one-shot attention forward, timed on one card.

    python tools/one_shot_variants.py

Copies ``devt_tpu_torch/ops/csrc`` once per variant under
``runs/one_shot_variants/`` (gitignored), edits the copy of
``flash_fwd_sm90.cuh`` as the variant says, builds ``flash_fwd.cu`` and
``ring_step.cu`` of every copy (one nvcc each, all at once, the flags of
``ops/_build.py``), and times kernel 9 at (1536, 197, 64), kv_len 197, q,
k, v the head views of a packed qkv, and kernel 14 at q (512, 208, 192),
kv (512, 208, 384), 197 live columns, by CUDA graph replay (20 calls, 5
replays), in two rounds, each against its plain version.  Beside them
F.scaled_dot_product_attention on the same inputs.

The variants: the body as built (two query tiles a CTA, three CTAs an
SM); a CTA per head holding all its query tiles (two CTAs an SM); one
tile a CTA; three ablations whose output is wrong on purpose (no
exponentials; no P V product; no Q K^T product), which say what each
part costs.  Prints ptxas' registers and spills per variant, the card's
name and power limit, and one line per variant and round.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "devt_tpu_torch" / "ops" / "csrc"
OUT = ROOT / "runs" / "one_shot_variants"
HEADER = "flash_fwd_sm90.cuh"

TILES = "  return sq > 64 ? 2 : 1;"
EXP = ("      v = kMask ? ex2((v - m[r]) * kLog2e) : "
       "ex2(fmaf(v, cl, -mc[r]));")
PV = "      wgmma_pv<HD>(o, pa[kk], vdesc + ((16 * kk * RB) >> 4), kk);"
QK = "      wgmma_qk<N>(s, qdesc + 2 * kk, kdesc + 2 * kk, kk);"
VARIANTS = {
    "as built": [],
    "all tiles a CTA": [
        (TILES, "  return (sq + 63) / 64;"),
        ("constexpr int kOneShotQTiles = 2;",
         "constexpr int kOneShotQTiles = 8;"),
        ("  return norm_after && hd == 64 && n == 256 ? 2 : 3;",
         "  return 2;")],
    "one tile a CTA": [
        (TILES, "  return 1;")],
    "no ex2": [(EXP, "      v = kMask ? (v - m[r]) * kLog2e : "
                     "fmaf(v, cl, -mc[r]);")],
    "no P V": [(PV, "      o[kk % (HD / 2)] += __uint_as_float(pa[kk][0]);")],
    "no Q K^T": [(QK, "      if (a.kv_len < 0) " + QK.strip())],
}


def build() -> dict:
    from devt_tpu_torch.ops import _build

    shutil.rmtree(OUT, ignore_errors=True)
    procs = []
    for i, (name, edits) in enumerate(VARIANTS.items()):
        d = OUT / str(i)
        shutil.copytree(CSRC, d)
        text = (d / HEADER).read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: the header has no {old!r}")
            text = text.replace(old, new)
        (d / HEADER).write_text(text)
        for stem in ("flash_fwd", "ring_step"):
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                   str(d / f"{stem}.so"), str(d / f"{stem}.cu")]
            procs.append((name, stem, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    logs = {}
    for name, stem, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name} {stem}: nvcc failed\n{log[-3000:]}")
        logs[(name, stem)] = log
    return logs


def ptxas(log: str) -> str:
    rows, name, spill = [], None, "?"
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            name = re.search(r"flash_one_shotILi(\d+)ELi(\d+)ELb(\d)E",
                             found.group(1))
            continue
        if name is None:
            continue
        found = re.search(r"(\d+) bytes spill stores", line)
        if found:
            spill = found.group(1)
        found = re.search(r"Used (\d+) registers", line)
        if found and name.group(1) == "64" and name.group(2) == "208":
            rows.append(f"<64,208,{name.group(3)}> {found.group(1)} regs "
                        f"{spill} spill bytes")
            name = None
    return "; ".join(rows) + f"; C7511 warnings {log.count('C7511')}"


def main() -> int:
    import torch
    import torch.nn.functional as F

    from chip_smoke import _graph_ms, _nvidia_smi, _packed_heads
    from devt_tpu_torch.ops import flash_attention as tfa

    if not torch.cuda.is_available():
        raise SystemExit("one_shot_variants: needs an NVIDIA card")
    print(f"card: {_nvidia_smi()}", flush=True)
    logs = build()
    for (name, stem), log in logs.items():
        print(f"[ptxas] {name} {stem}: {ptxas(log)}", flush=True)
    stream = lambda: ctypes.c_void_p(  # noqa: E731
        torch.cuda.current_stream().cuda_stream)
    q, k, v = _packed_heads(512, 197, 3, 64, torch.bfloat16, 1)
    gen = torch.Generator().manual_seed(3)
    rq = torch.randn(512, 208, 192, generator=gen).to(torch.bfloat16).cuda()
    rkv = torch.randn(512, 208, 384, generator=gen).to(torch.bfloat16).cuda()
    mask = torch.where(torch.arange(208, device="cuda")[None] < 197, 0.0,
                       -1e30).float()
    want9 = tfa.flash_single_fwd_plain(q, k, v, 0.125, 197)
    want14 = tfa.ring_step_fwd_plain(rq, rkv, mask, 3, 0.125)
    strides = (ctypes.c_longlong * 9)(
        *(t.stride(i) for t in (q, k, v) for i in range(3)))

    def k9(lib):
        o = torch.empty(q.shape, dtype=q.dtype, device="cuda")
        lse = torch.empty(1536, 197, device="cuda")
        rc = lib.devt_flash_fwd(1, 0, q.data_ptr(), k.data_ptr(),
                                v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                                512, 3, 197, 197, 64, 197, strides,
                                ctypes.c_float(0.125), stream())
        assert rc == 0, rc
        return o, lse

    def k14(lib):
        o = torch.empty_like(rq)
        lse = torch.empty(512, 208, 3, device="cuda")
        rc = lib.devt_ring_step_fwd(1, rq.data_ptr(), rkv.data_ptr(),
                                    mask.data_ptr(), o.data_ptr(),
                                    lse.data_ptr(), 512, 208, 3, 64,
                                    ctypes.c_float(0.125), stream())
        assert rc == 0, rc
        return o, lse

    def err(got, want):
        return max((g.float() - w.float()).abs().max().item()
                   for g, w in zip(got, want))

    heads = [t.reshape(512, 208, 3, 64).transpose(1, 2)
             for t in (rq, rkv[..., :192], rkv[..., 192:])]
    bias = mask.to(torch.bfloat16)[None, None]
    with torch.no_grad():
        sdpa9 = _graph_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        sdpa14 = _graph_ms(lambda: F.scaled_dot_product_attention(
            *heads, attn_mask=bias))
    print(f"F.scaled_dot_product_attention: kernel 9's shape {sdpa9:.4f} "
          f"ms, kernel 14's with the additive mask {sdpa14:.4f} ms "
          f"(CUDA graph)", flush=True)
    for rnd in range(2):
        for i, name in enumerate(VARIANTS):
            lib = ctypes.CDLL(str(OUT / str(i) / "flash_fwd.so"))
            tfa._declare_flash_fwd(lib)
            rlib = ctypes.CDLL(str(OUT / str(i) / "ring_step.so"))
            tfa._declare_ring(rlib)
            e9, e14 = err(k9(lib), want9), err(k14(rlib), want14)
            t9 = _graph_ms(lambda: k9(lib))
            t14 = _graph_ms(lambda: k14(rlib))
            print(f"[round {rnd}] {name}: kernel 9 {t9:.4f} ms (max abs err "
                  f"{e9:.3e}), kernel 14 {t14:.4f} ms (max abs err "
                  f"{e14:.3e})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
