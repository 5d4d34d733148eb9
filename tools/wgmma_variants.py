#!/usr/bin/env python3
"""Variants of the wgmma bodies of kernels 11, 6, 12, 13, 7, 3, 4, 1 and
2, timed on one card.

    python tools/wgmma_variants.py [--rounds 2]
        [--kernels 11 6 12 13 7 3 4 1 2]

Copies ``devt_tpu_torch/ops/csrc`` once per variant under
``runs/wgmma_variants/`` (gitignored), edits the copy's constants as the
variant says, builds the one library the variant touches (``flash_fwd.cu``
for kernel 11, ``int8_matmul.cu`` for kernel 6, ``flash_bwd.cu`` for
kernels 12 and 13, ``attn_half.cu`` for kernel 7, ``mha_fwd.cu`` for
kernel 3, ``mha_bwd.cu`` for kernel 4, ``fused_block_fwd.cu`` and ``fused_block_bwd.cu`` for kernels 1
and 2; one nvcc each, all at once, the flags of
``ops/_build.py``), and times by CUDA graph replay (20 calls, 5 replays),
in ``--rounds`` rounds:

  * kernel 11 at (1536, 592, 64), kv_len 577, q, k, v the head views of a
    packed qkv (ViViT at image 384), against its plain version;
  * kernel 6 at (3584, 2048) x (2048, 6144) and x (2048, 2048), bf16, the
    weight codes K-major, bit for bit against its plain version; the
    row pass and the product together, as the wrapper launches them;
  * kernels 12 (delta and dq) and 13 (dk and dv) at kernel 11's shape, on
    the forward's o and lse, against the plain backward (the error in bf16
    ulps of each tensor's largest element);
  * kernel 7 (the MoE block's attention half forward, all three launches)
    at (512, 208, 192), kv_len 197, against its plain version;
  * kernel 3 (the packed-qkv attention forward) at PTN's serving shape
    (256, 14, 6144) and training shape (32, 14, 6144), 8 heads of 256,
    against its plain version;
  * kernel 4 (the packed-qkv attention backward) at PTN's training shape
    (32, 14, 6144), 8 heads of 256, and at the ViT shape (512, 208, 576),
    3 heads of 64, kv_len 197, at dropout 0 and 0.5, on the kernel
    forward's (o, lse), against its plain version given the exported
    mask (the error in bf16 ulps of each tensor's largest element);
  * kernels 1 and 2 (the fused block forward and backward, all their
    launches through the wrappers, the variant's library in place of the
    built one) at (512, 208, 192), kv_len 197, MLP 768, against their
    plain versions.

Kernel 11's variants: as built (one consumer warpgroup of 64 query rows
a CTA, three CTAs an SM, a two-stage ring); two CTAs an SM (the register
cap that three leave lifted); two and three consumer warpgroups a CTA
sharing each K and V tile (one CTA an SM); a CTA a head that holds its K
and V resident (five stages) and takes its query groups in turn, with two
or three warpgroups; O rescaled at the first tile too (where it is zero:
the body skips it, which leaves ptxas no spill); and two ablations whose
output is wrong on purpose: no V loads (half the bytes from L2) and no
exponentials.  Kernel 6's: as built (128 x 256 tiles, a CTA a tile) and a
persistent grid of one CTA an SM.  Kernel 12's: as built (64-key tiles,
three CTAs an SM, two stages), 128-key tiles at two CTAs an SM, and three
stages.  Kernel 13's: as built (64-query tiles, two CTAs an SM, two
stages), 32-query tiles at three CTAs an SM, and three stages.  Kernel
7's: as built (its attention on the one-shot body's normalise-after
instance, two CTAs an SM for the instance at head dim 64 and 256 keys),
three CTAs an SM for that instance too, lse and 1 / l taken before the
P V product, and its attention on attention_fwd.cuh's streamed body (the
route before the one-shot body took it).  Kernel 3's: as built (the packed
body: 64 / S sequences of a head to a tile, a one-stage ring, P V in
wgmma groups of 64 output columns, two CTAs an SM), P V in groups of 128
and in one of 256, two stages (one CTA an SM) with 64 and with 256, one
sequence a tile (the unpacked one-shot instance at head dim 256), and the
route before (attention_fwd.cuh's streamed body).  Kernel 4's: as built
(the packed body: 32 // S sequences of a head to a 64-row tile, a CTA a
tile; kernels 12's and 13's bodies with kBwdMha at head dim 64), the
forward's four sequences a tile (64 rows filled) split across two CTAs by
its 64-column output groups and in one CTA, two and four CTAs a tile, one
sequence a tile, kBwdMha's dq instance with dropout at two CTAs an SM
(three cap it at 128 registers), and the route before (attention_bwd.cuh's
streamed body at every shape).  Kernels 1's and 2's
(csrc/block_sm90.cuh): as built (128-row tiles of two consumer
warpgroups and a producer warp, four ring stages for LN1 + qkv, the row
products and the weight gradients, two for the forward's FFN and three
for the backward's, a CTA a tile, weight-gradient splits that fill the
SMs once, a producer warpgroup that hands its registers to the
consumers), two and three stages, splits for two waves, a producer warp
without setmaxnreg; and ablations whose output is wrong on
purpose: kernel 1 without its qkv stores, its gelu or its W2 product,
kernel 2 without its h and dz1 stores.  Prints the card's
name and power limit, ptxas' registers, spills and wgmma notes (C75xx)
per variant, one line per variant and round, and a line per sustained
run: the selected kernels as built and their library calls, each
replayed for about a second while nvidia-smi samples the SM clock and the
power draw.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "devt_tpu_torch" / "ops" / "csrc"
OUT = ROOT / "runs" / "wgmma_variants"

FLASH = "flash_fwd_sm90.cuh"
GEMM = "gemm_s8_sm90.cuh"
BWD = "flash_bwd_sm90.cuh"
WG = "constexpr int kOnlineWG = 1;"
STAGES = "constexpr int kOnlineStages = 2;"
GROUPS = "constexpr int kOnlineGroups = 1;"
CTAS = "constexpr int kOnlineCTAs = 3;"
VLOAD = ("          mbar_expect_tx(&fullv[st], kTile);\n"
         "          tma_load_4d(Ks + kTile, &tv, &fullv[st], 0, j * kOnlineKeys, h, b);")
EXP = "          s[i] = ex2(fmaf(s[i], c, -mc[(i >> 1) & 1]));"
RESCALE_EACH = (
    "        for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];\n")
RESCALE_FROM_TILE_2 = (
    "        if (j > 0) {  // O is zero before the first tile\n"
    "#pragma unroll\n  " + RESCALE_EACH + "        }\n")
PERSIST = "constexpr bool kS8Persistent = false;"
DQ_KEYS = "constexpr int kBwdDqKeys = 64;"
DQ_CTAS = "constexpr int kBwdDqCTAs = 3;"
DKV_QUERIES = "constexpr int kBwdDkvQueries = 64;"
DKV_CTAS = "constexpr int kBwdDkvCTAs = 2;"
DQ_STAGES = "constexpr int kBwdDqStages = 2;"
DKV_STAGES = "constexpr int kBwdDkvStages = 2;"
HALF = "attn_half.cu"
MHA = "mha_fwd_sm90.cuh"
MHA_STAGES = "constexpr int kMhaStages = 1;"
MHA_PV = "constexpr int kMhaPvCols = 64;"
MHA_PACK = "__host__ __device__ constexpr int mha_pack(int s) { return 64 / s; }"
MHA_ROUTE = "         : (d == 128 || d == 256) && s >= 1 && s <= 64 ? kMhaPacked"
HALF_ROUTE = "  if (!one_shot_on_wgmma(1, HD, a.kv_len))"
ONE_SHOT_CTAS = "  return norm_after && hd == 64 && n == 256 ? 2 : 3;"
PV_STEP = "    // 3. O = P V, one m64nHDk16 per 16 keys (16 rows of V)\n"
LSE_FIRST = (
    "    if constexpr (kNormAfter) {  // lse now; l becomes 1 / l\n"
    "#pragma unroll\n"
    "      for (int hh = 0; hh < 2; ++hh) {\n"
    "        const int row = 64 * t + 16 * warp + gq + 8 * hh;\n"
    "        if (row < a.Sq && tq4 == 0)\n"
    "          L[row * a.ls[2]] = m[hh] * a.scale + logf(l[hh]);\n"
    "        l[hh] = 1.f / l[hh];\n"
    "      }\n"
    "    }\n")
INV_AT_STORE = "        const float inv = 1.f / l[hh];"
LSE_STORE = "      if (tq4 == 0)\n        L[row * a.ls[2]] ="
MBWD = "mha_bwd_sm90.cuh"
MBWD_ROWS = "constexpr int kMhaBwdRows = 32;"
MBWD_SPLIT = "constexpr int kMhaBwdSplit = 1;"
BLK = "block_sm90.cuh"
BLK_STAGES = "constexpr int kBlkStages = 4;"
WG_WAVES = "constexpr int kWgWaves = 1;"
# (kernel, name): [(header, old, new), ...]
VARIANTS = {
    (11, "as built"): [],
    (11, "one consumer warpgroup, two CTAs an SM"): [
        (FLASH, CTAS, "constexpr int kOnlineCTAs = 2;")],
    (11, "two consumer warpgroups, one CTA an SM"): [
        (FLASH, WG, "constexpr int kOnlineWG = 2;"),
        (FLASH, CTAS, "constexpr int kOnlineCTAs = 1;")],
    (11, "three consumer warpgroups, one CTA an SM"): [
        (FLASH, WG, "constexpr int kOnlineWG = 3;"),
        (FLASH, CTAS, "constexpr int kOnlineCTAs = 1;")],
    (11, "K, V resident, a CTA a head (two warpgroups, five groups)"): [
        (FLASH, WG, "constexpr int kOnlineWG = 2;"),
        (FLASH, CTAS, "constexpr int kOnlineCTAs = 1;"),
        (FLASH, STAGES, "constexpr int kOnlineStages = 5;"),
        (FLASH, GROUPS, "constexpr int kOnlineGroups = 5;")],
    (11, "K, V resident, a CTA a head (three warpgroups, four groups)"): [
        (FLASH, WG, "constexpr int kOnlineWG = 3;"),
        (FLASH, CTAS, "constexpr int kOnlineCTAs = 1;"),
        (FLASH, STAGES, "constexpr int kOnlineStages = 5;"),
        (FLASH, GROUPS, "constexpr int kOnlineGroups = 4;")],
    (11, "O rescaled at every tile, the first too"): [
        (FLASH, RESCALE_FROM_TILE_2, "#pragma unroll\n" + RESCALE_EACH)],
    (11, "no V loads (wrong on purpose)"): [
        (FLASH, VLOAD, "          mbar_arrive(&fullv[st]);")],
    (11, "no ex2 (wrong on purpose)"): [
        (FLASH, EXP, "          s[i] = fmaf(s[i], c, -mc[(i >> 1) & 1]);")],
    (6, "as built"): [],
    (6, "persistent grid (one CTA an SM)"): [
        (GEMM, PERSIST, "constexpr bool kS8Persistent = true;")],
    (12, "as built"): [],
    (12, "128-key tiles, two CTAs an SM"): [
        (BWD, DQ_KEYS, "constexpr int kBwdDqKeys = 128;"),
        (BWD, DQ_CTAS, "constexpr int kBwdDqCTAs = 2;")],
    (12, "three stages"): [
        (BWD, DQ_STAGES, "constexpr int kBwdDqStages = 3;")],
    (13, "as built"): [],
    (13, "32-query tiles, three CTAs an SM"): [
        (BWD, DKV_QUERIES, "constexpr int kBwdDkvQueries = 32;"),
        (BWD, DKV_CTAS, "constexpr int kBwdDkvCTAs = 3;")],
    (13, "three stages"): [
        (BWD, DKV_STAGES, "constexpr int kBwdDkvStages = 3;")],
    (7, "as built"): [],
    (7, "three CTAs an SM for every one-shot instance"): [
        (FLASH, ONE_SHOT_CTAS, "  return 3;")],
    (7, "lse and 1 / l before P V"): [
        (FLASH, PV_STEP, LSE_FIRST + PV_STEP),
        (FLASH, INV_AT_STORE, "        const float inv = l[hh];"),
        (FLASH, LSE_STORE,
         "      if (!kNormAfter && tq4 == 0)\n        L[row * a.ls[2]] =")],
    (7, "attention on attention_fwd.cuh's streamed body"): [
        (HALF, HALF_ROUTE, "  if (true)")],
    (3, "as built"): [],
    (3, "P V in groups of 128 columns"): [
        (MHA, MHA_PV, "constexpr int kMhaPvCols = 128;")],
    (3, "P V in one group of 256 columns"): [
        (MHA, MHA_PV, "constexpr int kMhaPvCols = 256;")],
    (3, "two stages"): [(MHA, MHA_STAGES, "constexpr int kMhaStages = 2;")],
    (3, "two stages, P V in one group of 256 columns"): [
        (MHA, MHA_STAGES, "constexpr int kMhaStages = 2;"),
        (MHA, MHA_PV, "constexpr int kMhaPvCols = 256;")],
    (3, "one sequence a tile (unpacked one-shot instance)"): [
        (MHA, MHA_PACK, MHA_PACK.replace("64 / s", "1"))],
    (3, "streamed body (attention_fwd.cuh)"): [
        (MHA, MHA_ROUTE, "         : false ? kMhaPacked")],
    (4, "as built"): [],
    (4, "four sequences a tile, two CTAs"): [
        (MBWD, MBWD_ROWS, "constexpr int kMhaBwdRows = 64;"),
        (MBWD, MBWD_SPLIT, "constexpr int kMhaBwdSplit = 2;")],
    (4, "four sequences a tile"): [
        (MBWD, MBWD_ROWS, "constexpr int kMhaBwdRows = 64;")],
    (4, "two CTAs a tile"): [(MBWD, MBWD_SPLIT,
                              "constexpr int kMhaBwdSplit = 2;")],
    (4, "four CTAs a tile"): [(MBWD, MBWD_SPLIT,
                               "constexpr int kMhaBwdSplit = 4;")],
    (4, "one sequence a tile"): [
        (MBWD, MBWD_ROWS, "constexpr int kMhaBwdRows = 1;")],
    (4, "dq with dropout at two CTAs an SM"): [
        (MBWD, "__global__ void __launch_bounds__(kBwdThreads, kBwdDqCTAs)\n"
               "    mha_bwd_dq_sm90(",
         "__global__ void __launch_bounds__(kBwdThreads, kDrop ? 2 : "
         "kBwdDqCTAs)\n    mha_bwd_dq_sm90(")],
    (4, "the route before (streamed)"): [
        (MBWD, "         : (d == 128 || d == 256) && s <= 64 ? kMhaBwdPacked",
         "         : false ? kMhaBwdPacked"),
        (MBWD, "         : blocked_bwd_on_wgmma(1, d)      ? kMhaBwdWgmma",
         "         : false ? kMhaBwdWgmma")],
    (1, "as built"): [],
    (1, "two stages"): [(BLK, BLK_STAGES, "constexpr int kBlkStages = 2;")],
    (1, "no qkv stores (wrong on purpose)"): [
        (BLK, "    blk_store(&tqkv, stage, kQkvBN / 64, nc * kQkvBN, "
              "row0 + 64 * wg);", "    blk_bar(2 + wg, 128);")],
    (1, "no gelu (wrong on purpose)"): [
        (BLK, "gelu_tanh(z[4 * j + 2 * hh] + bb1[hc])",
         "(z[4 * j + 2 * hh] + bb1[hc])"),
        (BLK, "gelu_tanh(z[4 * j + 2 * hh + 1] + bb1[hc + 1])",
         "(z[4 * j + 2 * hh + 1] + bb1[hc + 1])")],
    (1, "no W2 product (wrong on purpose)"): [
        (BLK, "      blk_mma_rs<D, 1>(yacc,", "      if (c < 0) blk_mma_rs<D, 1>(yacc,")],
    (1, "a producer warp (no setmaxnreg)"): [
        (BLK, "constexpr int kBlkThreads = kBlkConsumers + 128;",
         "constexpr int kBlkThreads = kBlkConsumers + 32;"),
        (BLK, "  asm volatile(\"setmaxnreg.dec.sync.aligned.u32 %0;\\n\" ::\"n\"(kBlkProducerRegs));", ""),
        (BLK, "  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 %0;\\n\" ::\"n\"(kBlkConsumerRegs));", "")],
    (2, "as built"): [],
    (2, "two stages"): [(BLK, BLK_STAGES, "constexpr int kBlkStages = 2;")],
    (2, "three stages"): [(BLK, BLK_STAGES, "constexpr int kBlkStages = 3;")],
    (2, "no h, dz1 stores (wrong on purpose)"): [
        (BLK, "      tma_store_2d(&th, stage, kHidden * c, row0 + 64 * wg);\n"
              "      tma_store_2d(&tdz1, stage + kBlkBox, kHidden * c, "
              "row0 + 64 * wg);\n", "")],
    (2, "weight-gradient splits for two waves"): [
        (BLK, WG_WAVES, "constexpr int kWgWaves = 2;")],
    (2, "a producer warp (no setmaxnreg)"): [
        (BLK, "constexpr int kBlkThreads = kBlkConsumers + 128;",
         "constexpr int kBlkThreads = kBlkConsumers + 32;"),
        (BLK, "  asm volatile(\"setmaxnreg.dec.sync.aligned.u32 %0;\\n\" ::\"n\"(kBlkProducerRegs));", ""),
        (BLK, "  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 %0;\\n\" ::\"n\"(kBlkConsumerRegs));", "")],
}
STEM = {11: "flash_fwd", 6: "int8_matmul", 12: "flash_bwd", 13: "flash_bwd",
        7: "attn_half", 3: "mha_fwd", 4: "mha_bwd", 1: "fused_block_fwd",
        2: "fused_block_bwd"}
PTXAS = {11: r"flash_fwd_wgmmaILi(\d+)E", 6: r"gemm_s8_wgmmaI(\w+?)EEv",
         12: r"flash_bwd_dq_wgmmaILi(\d+)E",
         13: r"flash_bwd_dkv_wgmmaILi(\d+)E",
         7: r"flash_one_shotILi(\d+)ELi(\d+)ELb0ELb1E",
         3: r"mha_fwd_packedILi(\d+)E",
         4: r"mha_bwd_(packed|dq_sm90|dkv_sm90)ILi(\d+)ELb(\d)E",
         1: r"(ln_qkv_sm90|out_ffn_sm90)ILi(\d+)E",
         2: r"(ln_qkv_sm90|ffn_dual_sm90|row_nk_sm90|wgrad_sm90)ILi(\d+)E"}


def build(kernels) -> dict:
    from devt_tpu_torch.ops import _build

    shutil.rmtree(OUT, ignore_errors=True)
    procs = []
    for i, ((kernel, name), edits) in enumerate(VARIANTS.items()):
        if kernel not in kernels:
            continue
        d = OUT / str(i)
        shutil.copytree(CSRC, d)
        for header, old, new in edits:
            text = (d / header).read_text()
            if old not in text:
                raise SystemExit(f"{name}: {header} has no {old!r}")
            (d / header).write_text(text.replace(old, new))
        stem = STEM[kernel]
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / f"{stem}.so"),
               str(d / f"{stem}.cu")]
        procs.append(((kernel, name), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs = {}
    for key, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{key}: nvcc failed\n{log[-3000:]}")
        logs[key] = log
    return logs


def ptxas(log: str, pattern: str) -> str:
    rows, name, spill = [], None, "?"
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            name = re.search(pattern, found.group(1))
            continue
        if name is None:
            continue
        found = re.search(r"(\d+) bytes spill stores", line)
        if found:
            spill = found.group(1)
        found = re.search(r"Used (\d+) registers", line)
        if found:
            rows.append(f"<{','.join(name.groups())}> {found.group(1)} "
                        f"regs {spill} spill bytes")
            name = None
    codes = sorted(set(re.findall(r"C75\d\d", log)))
    return "; ".join(rows) + "; wgmma notes " + (
        ", ".join(f"{c} x{log.count(c)}" for c in codes) or "none")


def main() -> int:
    import torch

    from chip_smoke import _graph_ms, _nvidia_smi, _packed_heads
    from devt_tpu_torch.ops import flash_attention as tfa
    from devt_tpu_torch.ops import quant as tq

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--kernels", type=int, nargs="+",
                    default=[11, 6, 12, 13, 7, 3, 4, 1, 2],
                    choices=[11, 6, 12, 13, 7, 3, 4, 1, 2])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("wgmma_variants: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {_nvidia_smi()}", flush=True)
    logs = build(args.kernels)
    for (kernel, name), log in logs.items():
        print(f"[ptxas] kernel {kernel} {name}: "
              f"{ptxas(log, PTXAS[kernel])}", flush=True)
    stream = lambda: ctypes.c_void_p(  # noqa: E731
        torch.cuda.current_stream().cuda_stream)

    q, k, v = _packed_heads(512, 592, 3, 64, torch.bfloat16, 2)
    want11 = tfa.flash_blocked_fwd_plain(q, k, v, 0.125, 577)
    strides = (ctypes.c_longlong * 9)(
        *(t.stride(i) for t in (q, k, v) for i in range(3)))

    def k11(lib):
        o = torch.empty(q.shape, dtype=q.dtype, device="cuda")
        lse = torch.empty(1536, 592, device="cuda")
        rc = lib.devt_flash_fwd(1, 1, q.data_ptr(), k.data_ptr(),
                                v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                                512, 3, 592, 592, 64, 577, strides,
                                ctypes.c_float(0.125), stream())
        assert rc == 0, rc
        return o, lse

    gen = torch.Generator().manual_seed(6)
    x = torch.randn(3584, 2048, generator=gen).to(torch.bfloat16).cuda()
    weights = {}
    for n in (6144, 2048):
        w = (torch.randn(2048, n, generator=gen) * 2048 ** -0.5).cuda()
        w_q, w_s = tq.quantize_weight(w.to(torch.bfloat16))
        weights[n] = (w_q.t().contiguous().t(), w_s,
                      tq.int8_matmul_fused_plain(x, w_q, w_s))
    codes = torch.empty(3584, 2048, dtype=torch.int8, device="cuda")
    rows = torch.empty(3584, device="cuda")

    def k6(lib, n):
        w_q, w_s, _ = weights[n]
        out = torch.empty(3584, n, dtype=torch.bfloat16, device="cuda")
        rc = lib.devt_int8_matmul(1, 1, x.data_ptr(), w_q.data_ptr(),
                                  w_s.data_ptr(), out.data_ptr(),
                                  codes.data_ptr(), rows.data_ptr(), 3584,
                                  2048, n, stream())
        assert rc == 0, rc
        return out

    # kernels 12 and 13 on the forward's o and lse, against the plain
    # backward; 13 reads the delta that the as-built kernel 12 writes
    do = torch.randn(512, 3, 592, 64, generator=gen).to(torch.bfloat16).cuda()
    fo, flse = tfa.flash_attention(q, k, v, kv_len=577, return_lse=True)
    want_bwd = tfa.flash_blocked_bwd_plain(q, k, v, fo, flse, do, 0.125, 577)
    largest = [w.float().abs().max().item() for w in want_bwd]
    grads = {n: torch.empty(q.shape, dtype=q.dtype, device="cuda")
             for n in ("dq", "dk", "dv")}
    delta = torch.empty(1536, 592, device="cuda")

    def bwd(lib, part):
        rc = lib.devt_flash_blocked_bwd(
            1, part, q.data_ptr(), k.data_ptr(), v.data_ptr(), fo.data_ptr(),
            do.data_ptr(), flse.data_ptr(), delta.data_ptr(),
            grads["dq"].data_ptr(), grads["dk"].data_ptr(),
            grads["dv"].data_ptr(), 512, 3, 592, 592, 64, 577, strides,
            ctypes.c_float(0.125), stream())
        assert rc == 0, rc

    def ulps(names):
        cells = []
        for i, n in enumerate(("dq", "dk", "dv")):
            if n in names:
                err = (grads[n].float() - want_bwd[i].float()).abs().max()
                cells.append(f"{n} {err.item() / (2.0 ** -8 * largest[i]):.2f}")
        return ", ".join(cells)

    # kernel 7 at the MoE block's shape, its three launches as the wrapper
    # makes them
    from chip_smoke import _block_inputs
    from devt_tpu_torch.ops import fused_block as fb

    hx, full = _block_inputs(torch.bfloat16, torch.Generator().manual_seed(7))
    half = {n: full[n] for n in fb.HALF_NAMES}
    want7 = fb.fused_attn_half_fwd_plain(hx, half, 3, 0.125, 197)
    hu = torch.empty_like(hx)
    hres = torch.empty(512, 208, 8, device="cuda")
    hqkv = torch.empty(512, 208, 576, dtype=hx.dtype, device="cuda")
    hatt = torch.empty_like(hx)

    def k7(lib):
        rc = lib.devt_attn_half_fwd(
            1, hx.data_ptr(), *(half[n].data_ptr() for n in fb.HALF_NAMES),
            hu.data_ptr(), hres.data_ptr(), hqkv.data_ptr(), hatt.data_ptr(),
            512, 208, 192, 3, 197, 8, ctypes.c_float(0.125), stream())
        assert rc == 0, rc
        return hu, hres

    # kernel 3 at PTN's serving and training shapes
    mha = {}
    for b in (256, 32):
        qkv = torch.randn(b, 14, 6144, generator=gen).to(torch.bfloat16)
        qkv = qkv.cuda()
        mha[b] = (qkv, tfa.fused_mha_plain(qkv, 8, 256 ** -0.5, 14))

    def k3(lib, b):
        qkv = mha[b][0]
        o = torch.empty(b, 14, 2048, dtype=qkv.dtype, device="cuda")
        lse = torch.empty(b, 14, 8, device="cuda")
        rc = lib.devt_mha_fwd(1, qkv.data_ptr(), o.data_ptr(), lse.data_ptr(),
                              b, 14, 8, 256, 14, ctypes.c_float(256 ** -0.5),
                              ctypes.c_double(0.0), ctypes.c_ulonglong(0),
                              stream())
        assert rc == 0, rc
        return o, lse

    # kernel 4 at PTN's training shape and the ViT shape, rates 0 and 0.5,
    # on the kernel forward's (o, lse); the plain backward given the mask
    mha_bwd = {}
    for b, s, heads, d, kv_len in ((32, 14, 8, 256, 14),
                                   (512, 208, 3, 64, 197)):
        qkv = torch.randn(b, s, 3 * heads * d, generator=gen).to(
            torch.bfloat16).cuda()
        g4 = torch.randn(b, s, heads * d, generator=gen).to(qkv.dtype).cuda()
        for rate in (0.0, 0.5):
            keep = tfa.mha_dropout_masks(5, rate, b, s, heads, "cuda") \
                if rate > 0.0 else None
            with torch.no_grad():
                o4, lse4 = tfa.fused_mha(qkv, heads=heads, kv_len=kv_len,
                                         dropout_rate=rate, seed=5,
                                         return_lse=True)
            want = tfa.fused_mha_bwd_plain(qkv, o4, lse4, g4, heads,
                                           d ** -0.5, kv_len, keep, rate)
            mha_bwd[(b, s, heads, d, kv_len, rate)] = (qkv, o4, lse4, g4,
                                                       want)

    def k4(lib, key):
        b, s, heads, d, kv_len, rate = key
        qkv, o4, lse4, g4, _ = mha_bwd[key]
        dqkv = torch.empty_like(qkv)
        delta4 = torch.empty(b, s, heads, device="cuda")
        rc = lib.devt_mha_bwd(1, qkv.data_ptr(), o4.data_ptr(),
                              g4.data_ptr(), lse4.data_ptr(),
                              delta4.data_ptr(), dqkv.data_ptr(), b, s, heads,
                              d, kv_len, ctypes.c_float(d ** -0.5),
                              ctypes.c_double(rate), ctypes.c_ulonglong(5),
                              stream())
        assert rc == 0, rc
        return dqkv

    def k4_ulps(got, key):
        heads, d, want = key[2], key[3], mha_bwd[key][4]
        cells = []
        for i in range(3):
            cols = slice(i * heads * d, (i + 1) * heads * d)
            w = want[..., cols].float()
            err = (got[..., cols].float() - w).abs().max().item()
            cells.append(err / (2.0 ** -8 * w.abs().max().item()))
        return max(cells)

    # kernels 1 and 2 at the main path's shape, through the wrappers with
    # the variant's library in place of the built one
    from devt_tpu_torch.ops import _build

    dy = torch.randn(hx.shape, generator=gen).to(hx.dtype).cuda()
    want1 = fb.fused_vit_block_fwd_plain(hx, full, 3, 0.125, 197)
    with torch.no_grad():
        _, bu, bres = fb.fused_vit_block(hx, full, 3, 0.125, 197)
    want2 = fb.fused_vit_block_bwd_plain(hx, full, bu, bres, dy, 3, 0.125, 197)
    big2 = [w.float().abs().max().item()
            for w in (want2[0], *want2[1].values())]

    def k1(lib):
        _build._loaded["fused_block_fwd"] = lib
        with torch.no_grad():
            return fb.fused_vit_block(hx, full, 3, 0.125, 197)

    def k2(lib):
        _build._loaded["fused_block_bwd"] = lib
        return fb._bwd_cuda(hx, full, bu, bres, dy, 3, 0.125, 197, 0.0, 0)

    def lib_of(i, kernel):
        lib = ctypes.CDLL(str(OUT / str(i) / f"{STEM[kernel]}.so"))
        {11: tfa._declare_flash_fwd, 6: tq._declare_matmul,
         12: tfa._declare_flash_bwd, 13: tfa._declare_flash_bwd,
         7: fb._declare_half, 3: tfa._declare_fwd, 4: tfa._declare_bwd,
         1: fb._declare_fwd,
         2: fb._declare_bwd}[kernel](lib)
        return lib

    built = {kern: lib_of(i, kern) for i, (kern, name) in enumerate(VARIANTS)
             if name == "as built" and kern in args.kernels}
    if 13 in args.kernels:
        bwd(built.get(12) or built[13], 1)     # the delta kernel 13 reads
    for rnd in range(args.rounds):
        for i, (kernel, name) in enumerate(VARIANTS):
            if kernel not in args.kernels:
                continue
            lib = lib_of(i, kernel)
            if kernel == 3:
                cells = []
                for b in (256, 32):
                    o, lse = k3(lib, b)
                    torch.cuda.synchronize()
                    err = max((g.float() - w.float()).abs().max().item()
                              for g, w in zip((o, lse), mha[b][1]))
                    t = _graph_ms(lambda: k3(lib, b))
                    cells.append(f"({b}, 14, 6144) {t:.4f} ms (o and lse max "
                                 f"abs err {err:.3e})")
                print(f"[round {rnd}] kernel 3 {name}: " + ", ".join(cells),
                      flush=True)
            elif kernel == 4:
                cells = []
                for key in mha_bwd:
                    got = k4(lib, key)
                    torch.cuda.synchronize()
                    err = k4_ulps(got, key)
                    t = _graph_ms(lambda: k4(lib, key))
                    cells.append(f"({key[0]}, {key[1]}, "
                                 f"{3 * key[2] * key[3]}) rate {key[5]} "
                                 f"{t:.4f} ms ({err:.2f} ulps)")
                print(f"[round {rnd}] kernel 4 {name}: " + ", ".join(cells),
                      flush=True)
            elif kernel == 1:
                got = k1(lib)
                torch.cuda.synchronize()
                err = max((g.float() - w.float()).abs().max().item()
                          for g, w in zip(got, want1))
                t = _graph_ms(lambda: k1(lib))
                print(f"[round {rnd}] kernel 1 {name}: {t:.4f} ms (y, u and "
                      f"res max abs err {err:.3e})", flush=True)
            elif kernel == 2:
                dx, grads = k2(lib)
                torch.cuda.synchronize()
                err = max((g.float() - w.float()).abs().max().item() / (
                    2.0 ** -8 * big) for g, w, big in zip(
                        (dx, *grads.values()),
                        (want2[0], *want2[1].values()), big2))
                t = _graph_ms(lambda: k2(lib))
                print(f"[round {rnd}] kernel 2 {name}: {t:.4f} ms (dx and "
                      f"the 11 gradients within {err:.2f} bf16 ulps of "
                      f"their largest elements)", flush=True)
            elif kernel == 7:
                u, res = k7(lib)
                torch.cuda.synchronize()
                err = max((g.float() - w.float()).abs().max().item()
                          for g, w in zip((u, res), want7))
                t = _graph_ms(lambda: k7(lib))
                print(f"[round {rnd}] kernel 7 {name}: {t:.4f} ms (u and "
                      f"res max abs err {err:.3e})", flush=True)
            elif kernel == 11:
                o, lse = k11(lib)
                err = max((g.float() - w.float()).abs().max().item()
                          for g, w in zip((o, lse), want11))
                t = _graph_ms(lambda: k11(lib))
                print(f"[round {rnd}] kernel 11 {name}: {t:.4f} ms (max abs "
                      f"err {err:.3e})", flush=True)
            elif kernel == 6:
                cells = []
                for n in (6144, 2048):
                    same = torch.equal(k6(lib, n), weights[n][2])
                    t = _graph_ms(lambda: k6(lib, n))
                    cells.append(f"N={n} {t:.4f} ms "
                                 f"({'bit-equal' if same else 'DIFFERS'})")
                print(f"[round {rnd}] kernel 6 {name}: " + ", ".join(cells),
                      flush=True)
            else:
                part = 1 if kernel == 12 else 2
                bwd(lib, part)
                torch.cuda.synchronize()
                err = ulps(("dq",) if part == 1 else ("dk", "dv"))
                t = _graph_ms(lambda: bwd(lib, part))
                print(f"[round {rnd}] kernel {kernel} {name}: {t:.4f} ms "
                      f"(error in bf16 ulps of the largest element: {err})",
                      flush=True)

    # sustained: each as built and its library call replayed for about a
    # second while nvidia-smi samples the SM clock and the power draw
    import torch.nn.functional as F

    cases = []
    if 11 in args.kernels:
        cases += [("kernel 11", lambda: k11(built[11])),
                  ("SDPA at kernel 11's shape",
                   lambda: F.scaled_dot_product_attention(
                       q, k[:, :, :577], v[:, :, :577], scale=0.125))]
    if 6 in args.kernels:
        w_bf = (weights[6144][0].t().float()
                * weights[6144][1].reshape(-1, 1)).to(torch.bfloat16)  # (N, K)
        cases += [("kernel 6 at N=6144", lambda: k6(built[6], 6144)),
                  ("F.linear bf16 at N=6144", lambda: F.linear(x, w_bf))]
    if 7 in args.kernels:
        cases.append(("kernel 7", lambda: k7(built[7])))
    if 1 in args.kernels:
        cases.append(("kernel 1", lambda: k1(built[1])))
    if 2 in args.kernels:
        cases.append(("kernel 2", lambda: k2(built[2])))
    if 3 in args.kernels:
        qkv = mha[256][0]
        split = qkv.reshape(256, 14, 3, 8, 256)
        hq, hk, hv = (split[:, :, i].transpose(1, 2) for i in range(3))
        cases += [("kernel 3 at (256, 14, 6144)", lambda: k3(built[3], 256)),
                  ("SDPA at kernel 3's shape",
                   lambda: F.scaled_dot_product_attention(
                       hq, hk, hv, scale=256 ** -0.5))]
    if 4 in args.kernels:
        cases.append(("kernel 4 at (32, 14, 6144)",
                      lambda: k4(built[4], (32, 14, 8, 256, 14, 0.0))))
    if 12 in args.kernels:
        cases.append(("kernel 12", lambda: bwd(built[12], 1)))
    if 13 in args.kernels:
        cases.append(("kernel 13", lambda: bwd(built[13], 2)))
    if 12 in args.kernels or 13 in args.kernels:
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

        def sdpa_fwd_bwd():
            with torch.enable_grad():
                out = F.scaled_dot_product_attention(
                    leaves[0], leaves[1][:, :, :577], leaves[2][:, :, :577],
                    scale=0.125)
                torch.autograd.grad(out, leaves, do)

        cases.append(("SDPA forward + backward at kernel 12's shape",
                      sdpa_fwd_bwd))
    with torch.no_grad():
        for name, fn in cases:
            smi = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits", "-lms", "100"],
                stdout=subprocess.PIPE, text=True)
            replays = max(5, int(1000 / (20 * _graph_ms(fn))))  # ~1 s
            t = _graph_ms(fn, n=20, replays=replays)
            smi.terminate()
            out = smi.communicate()[0]
            samples = [line.split(",") for line in out.splitlines()
                       if line.count(",") == 1]
            clocks = sorted(float(c) for c, _ in samples)
            watts = sorted(float(w) for _, w in samples)
            mid = len(samples) // 2
            print(f"[sustained] {name}: {t:.4f} ms; during it (median of "
                  f"{len(samples)} samples at 100 ms) SM clock "
                  f"{clocks[mid] if samples else float('nan'):.0f} MHz, "
                  f"power {watts[mid] if samples else float('nan'):.1f} W",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
