#!/usr/bin/env python3
"""Kernel 3's streamed bfloat16 forward in two checkouts of the repo on one
card, in turns: parent, change, change, parent.

    python tools/mha_fwd_times.py PARENT CHANGE

PARENT and CHANGE are roots of two checkouts (for example one unpacked with
``git archive`` under ``runs/``, and the repo itself).  Each run is a
subprocess in one tree, with that tree's kernel build directory and its own
``chip_smoke.py``, whose phases time the kernel the same way in both trees
(CUDA graph replay of 20 calls, 5 replays) and hold it against its plain
version:

  * ``phase_mha_bwd`` at dropout 0.5 (kernel 3 on its streamed route):
    PTN's width (32, 14, 6144) at 8 heads of 256 and at 16 heads of 128,
    and the MoE blocks' (512, 208, 576), 3 heads of 64, kv_len 197;
  * ``phase_mha`` at rate 0 past S = 64: (32, 160, 6144), 8 heads of 256.

Each run prints ``[mha-fwd-times] <tree> <shape> <ms>`` lines.  Needs a
CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys

CHILD = r"""
import sys
import torch
import chip_smoke as cs

torch.backends.cuda.matmul.allow_tf32 = False
tree = sys.argv[1]
for args in ((cs.PTN_TRAIN_BATCH, cs.PTN_SEQ + 1, cs.PTN_HEADS,
              cs.PTN_WIDTH // cs.PTN_HEADS, cs.PTN_SEQ + 1),
             (cs.PTN_TRAIN_BATCH, cs.PTN_SEQ + 1, 2 * cs.PTN_HEADS,
              cs.PTN_WIDTH // (2 * cs.PTN_HEADS), cs.PTN_SEQ + 1),
             (cs.B, cs.S, cs.HEADS, cs.D // cs.HEADS, cs.KV_LEN)):
    r = cs.phase_mha_bwd("bf16", *args, dropout=True)
    print(f"[mha-fwd-times] {tree} {args} rate 0.5: kernel 3 "
          f"{r['fwd_drop_ms']:.4f} ms, kernel 4 {r['bwd_drop_ms']:.4f} ms",
          flush=True)
args = (cs.PTN_TRAIN_BATCH, 160, cs.PTN_HEADS, cs.PTN_WIDTH // cs.PTN_HEADS,
        160)
r = cs.phase_mha("bf16", *args)
print(f"[mha-fwd-times] {tree} {args} rate 0: kernel 3 "
      f"{r['kernel_ms']:.4f} ms, max_abs_err {r['max_abs_err']:.3e}",
      flush=True)
"""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": os.path.abspath(argv[0]),
             "change": os.path.abspath(argv[1])}
    for name in ("parent", "change", "change", "parent"):
        root = trees[name]
        env = {**os.environ, "PYTHONPATH": root}
        done = subprocess.run([sys.executable, "-c", CHILD, name], cwd=root,
                              env=env, capture_output=True, text=True)
        for line in done.stdout.splitlines():
            if line.startswith("[mha-fwd-times]"):
                print(line, flush=True)
        if done.returncode:
            print(done.stdout[-4000:], done.stderr[-4000:], file=sys.stderr)
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
