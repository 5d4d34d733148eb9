#!/usr/bin/env python3
"""Kernel 4 (the packed-qkv attention backward) alone in one checkout of
the repo, on one card, and every wgmma instance's registers, spills and
SASS hash in that checkout's build:

    python tools/kernel4_times.py TREE [--no-time]

TREE is the root of a checkout (the repo, or a parent commit unpacked with
``git archive`` under ``runs/``); its own ``chip_smoke.py`` and build
directory are used.  Prints ``REGS {json}`` (by source and demangled
instance: registers, spill bytes, a hash of cuobjdump's SASS) and, unless
``--no-time``, ``RESULT {json}``: kernel 4 through ``_mha_bwd_cuda`` on
the forward's (o, lse), by CUDA graph replay (20 calls, 5 replays), at
PTN training's (32, 14, 6144), 8 heads of 256, at rates 0 and 0.5, the
ViT shape (512, 208, 576), 3 heads of 64, kv_len 197, at rates 0 and 0.5,
and (32, 160, 6144) at rate 0.
"""
import hashlib
import json
import os
import re
import subprocess
import sys


def main() -> int:
    tree = os.path.abspath(sys.argv[1])
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from devt_tpu_torch.ops import _build
    from devt_tpu_torch.ops import flash_attention as tfa

    libs = _build.build_all()
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    regs = {}
    for stem, lib in libs.items():
        log = lib.with_suffix(".log").read_text()
        used, name, spill = {}, None, "?"
        for line in log.splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                name = found.group(1)
            found = re.search(r"(\d+) bytes spill stores", line)
            if found:
                spill = found.group(1)
            found = re.search(r"Used (\d+) registers", line)
            if found and name and re.search(
                    r"wgmma|one_shot|packed|sm90|flash_|gemm_s8", name):
                used[name] = (int(found.group(1)), spill)
                name = None
        code, name = {}, None
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
        shown = subprocess.run(["c++filt"], input="\n".join(used),
                               capture_output=True, text=True).stdout
        for mangled, pretty in zip(used, shown.split("\n")):
            pretty = pretty.replace("(anonymous namespace)::", "")
            key = f"{stem}:" + pretty.split("(")[0].replace("void ", "")
            regs[key] = [*used[mangled], code[mangled].hexdigest()[:16]
                         if mangled in code else None]
        if stem == "mha_bwd":
            print(f"[mha_bwd log] C7511 {log.count('C7511')} C7512 "
                  f"{log.count('C7512')} C7515 {log.count('C7515')}")
    print("REGS " + json.dumps(regs), flush=True)
    if "--no-time" in sys.argv:
        return 0
    res = {}
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for tag, (b, s, heads, d, kv_len) in {
                "ptn": (32, 14, 8, 256, 14), "vit": (512, 208, 3, 64, 197),
                "s160": (32, 160, 8, 256, 160)}.items():
            qkv = torch.randn(b, s, 3 * heads * d, generator=gen).to(
                torch.bfloat16).cuda()
            do = torch.randn(b, s, heads * d, generator=gen).to(
                torch.bfloat16).cuda()
            for rate in (0.0, 0.5) if tag != "s160" else (0.0,):
                o, lse = tfa.fused_mha(qkv, heads=heads, kv_len=kv_len,
                                       dropout_rate=rate, seed=7,
                                       return_lse=True)
                res[f"k4_{tag}_r{rate}"] = cs._graph_ms(
                    lambda: tfa._mha_bwd_cuda(qkv, o, lse, do, heads,
                                              d ** -0.5, kv_len, rate, 7))
    print("RESULT " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
