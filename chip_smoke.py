#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (devt_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing a line of its own; any failure exits non-zero:

  1. device  — the card's name, and its name and power limit from nvidia-smi.
  2. build   — compiles every kernel in devt_tpu_torch/ops/csrc with nvcc,
               one nvcc per source, all started together.
  3. kernel  — the fused ViT-block forward at the ViViT main-path shape
               (512 sequences, 208 tokens, dim 192, kv_len 197), bf16 and
               f32, held against its plain PyTorch version on the card; the
               body of its attention launch (bf16: the one-shot wgmma
               instance, counted); times of the kernel and one
               nn.TransformerEncoderLayer (a yardstick only) by CUDA graph
               replay, of the plain version by CUDA events; the bound;
               ptxas' report of block_sm90.cuh's forward instances.
  4. serve   — ViViT at full width (224², patch 16, 16 frames, dim 192,
               depth 4, 3 heads, MLP 768, 19 classes, bf16, seeded weights)
               behind Predictor(buckets=(1, 8, 32)) on 37 uint8 clips; checks
               the kernel launches (4 per bucket call), the scores, and the
               first clips against the same model run on the CPU.
  5. kernel-bwd — the fused ViT-block backward at the same shape, bf16 and
               f32: dx and all 11 parameter gradients against the plain
               backward; two runs compared bit for bit; times of the kernel
               and of autograd through the library layer (its forward and
               backward less its forward) by CUDA graph replay, of the
               plain version by CUDA events; the bound, the sub-kernels'
               times and ptxas' report of block_sm90.cuh's backward
               instances.
  6. dropout — both kernels at rate 0.1 against the plain versions given
               the masks that the library exports for the seed; the dropped
               share at each of the three sites.
  7. train   — the same ViViT, batch 32, bf16, AdamW: one make_train_step
               step and make_multi_step(8) on a fixed synthetic batch;
               checks 4 forward and 4 backward launches per step, a finite
               loss that falls on the fixed batch, and one step's gradients
               on 2 clips against the CPU's plain path; clips/s as the best
               of 3 windows with the host's share of a step, and a profile
               of one step; then a few steps with dropout 0.1.
  8. kernel-quant — the int8 fused ViT block at the shape of phase 3, bf16
               and f32, against its plain version; times of the kernel, the
               bf16 fused block on the same input and the library layer by
               CUDA graph replay, of the plain version by CUDA events.
  9. kernel-int8-matmul — the fused int8 matmul at PTN's two Linear shapes,
               (3584, 2048) x (2048, 6144) and x (2048, 2048), bf16, the
               weight codes K-major as the site registry stores them (one
               launch on the wgmma body of gemm_s8_sm90.cuh, counted) and
               row-major (the mma.sync body), both bit for bit against the
               plain version; by CUDA graph replay the kernel, the mma.sync
               body, the plain version, F.linear in bf16 and torch._int_mm
               with its own quantize pass as yardsticks; the row pass's
               share and ptxas' report of the wgmma body.
 10. kernel-mha — the packed-qkv attention at PTN's serving shape
               (256, 14, 6144), 8 heads of 256, kv_len 14, at the TPU
               wrapper's padded (256, 16, 6144), and at the ViT shape
               (512, 208, 576), 3 heads of 64, kv_len 197, bf16 and f32: o
               and lse against the plain version; the body each launch ran
               (bf16 at PTN's shapes the packed wgmma body of
               mha_fwd_sm90.cuh, at the ViT shape kernel 9's one-shot
               instance, f32 the streamed body: mha_fwd_on_wgmma) with
               ptxas' report; the kernel's and
               F.scaled_dot_product_attention's times by CUDA graph
               replay, the plain version's by CUDA events.
 11. serve-int8 — the ViViT of phase 4 behind Predictor(quantize=True):
               4 int8-block launches per bucket call and none of the bf16
               block, scores against the same quantized model on the CPU
               and against phase 4's bf16 scores; clips/s and a profile.
 12. serve-ptn — PTN at full width (256 rows, 13 scenes, 2 experts, 2
               layers, width 2048, 8 heads, bf16) behind three Predictors:
               bf16, int8 with the default site policy, int8 at every site;
               4 attention launches per forward, every one on kernel 3's
               packed body, and 0 / 4 / 16 int8-matmul launches, every one
               on the wgmma body; the first rows
               against the CPU; rows/s of each.
 13. kernel-mha-bwd — the packed-qkv attention backward at PTN's training
               shape (32, 14, 6144), 8 heads of 256, bf16 (the packed
               wgmma body of mha_bwd_sm90.cuh) and f32, at the ViT shape
               (512, 208, 576), 3 heads of 64, kv_len 197 (kernels 12's and
               13's wgmma bodies), and at (32, 160, 6144), the longest the
               forward takes at head dim 256 (attention_bwd.cuh's streamed
               body): dq, dk, dv through fused_mha and autograd against the
               plain backward on the forward's (o, lse), the launch counted
               on the body mha_bwd_on_wgmma names; two runs bit for bit; at
               the two main-path shapes also dropout 0.5, both kernels
               against the plain versions given the masks the library
               exports for the seed, the dropped share, and kernel 4's time
               at that rate; ptxas' registers and spills of kernel 4's wgmma
               instances; the backward of F.scaled_dot_product_attention as
               a yardstick.
 14. train-ptn — PTN at full width (batch 32, 13 scenes, 2 experts, 2 layers,
               width 2048, 8 heads, bf16, AdamW 1e-4; bench.py's two-modality
               and dropout-training configurations) at dropout 0 and 0.5:
               one make_train_step step and make_multi_step(8), 4 launches of
               each attention kernel per step (kernel 3 on its packed body at
               dropout 0, streamed at 0.5; kernel 4 on its packed body at
               both), a falling loss at dropout 0,
               one step's gradients on 2 rows against the CPU's plain kernel
               path, in bf16 and in f32; samples/s as the best of 3 windows, the host's
               share and a profile of one step; then one ptn_shared step at
               dropout 0.5 (6 + 6 launches).
 15. kernel-attn-half — the attention half of the MoE block at the shape
               of phase 3, bf16 and f32: kernel 7 (u and the residual lanes)
               and kernel 8 (dx and the 5 gradients, two runs bit for bit)
               against their plain versions; the body of kernel 7's
               attention launch (bf16: the one-shot wgmma body of
               flash_fwd_sm90.cuh, normalising after P V, where
               attn_half_on_wgmma says; f32: attention_fwd.cuh's) and
               ptxas' report of its instances; times of the kernels and
               the half composed of library calls (forward, and its
               autograd: the kernels line carries them as composed_ms),
               all by CUDA graph, of the plain versions by CUDA events;
               kernel 7's three launches apart (profiler); the bounds.
 16. serve-moe — MoE-ViViT at full width (bench.py:1188: E=4, every second
               space block's FFN a switch MoE, bf16) behind
               Predictor(buckets=(1, 8, 32)) on 37 u8 clips: 2 launches of
               kernels 1 and 7 per bucket call, every kernel-7 launch on
               the wgmma body; 2 clips against the CPU in
               bf16 (scores, and the share of tokens routed apart) and f32
               (the same expert for every token); quantize=True (2 launches
               of kernels 5 and 7); clips/s and a profile.
 17. train-moe — the same MoE-ViViT, batch 32, bf16, AdamW 1e-4:
               make_train_step and make_multi_step(8) at dropout 0 (2
               launches each of kernels 1, 2, 7 and 8 per step, kernel 7's
               all on the wgmma body), a falling
               loss with the load-balance term in it, one f32 step's
               gradients on 2 clips against the CPU with identical routing;
               clips/s as the best of 3 windows, the host's share and a
               profile; then dropout 0.5 (kernels 3 and 4 in the MoE
               blocks, none of 7 and 8; kernel 4 on kernels 12's and 13's
               wgmma bodies): step ms, and a profiled call's device ms a
               step with kernel 4's share.

 18. kernel-flash — the split-q/k/v attention: kernel 9 at (1536, 197,
               64), kv_len 197 (the int8 ViViT at token_pad=0: 512
               sequences x 3 heads, the head views of a packed qkv) and
               kernel 11 at (1536, 592, 64), kv_len 577 (ViViT at image
               384), bf16 and f32, against their plain versions; then a
               ragged S with kv_len < S, head dim 256 at S = 512 (which
               kernel 3 cannot take) and Sq != Skv (blockwise however
               short); which body each launch ran (kernel 9: the wgmma
               one-shot body of flash_fwd_sm90.cuh where
               one_shot_on_wgmma says, kernel 11: its wgmma online body
               where online_on_wgmma says, else the streamed ones) and
               ptxas' registers and spills of the wgmma bodies; the
               kernels', the
               plain versions' and F.scaled_dot_product_attention's times,
               all by CUDA graph replay; the bounds.
 19. kernel-flash-bwd — kernel 10 at (1536, 197, 64) and (64, 512, 256),
               bf16 and f32, through flash_attention and autograd against
               the plain backward on the forward's (o, lse), two runs bit
               for bit; the public op forward and backward (one launch of
               kernels 9 and 10); which body kernel 10 ran (bf16 at head
               dim 64: kernels 12's and 13's wgmma bodies, flash_bwd_sm90.cuh,
               where blocked_bwd_on_wgmma says; f32 and head dim 256:
               attention_bwd.cuh's); the kernel's and SDPA's backward's
               times by CUDA graph, the plain version's by CUDA events.
 20. eval-long — ViViT at image 384 (577 space tokens; dim 192, depth 4,
               3 heads, bf16, seeded weights) through make_eval_step at
               batch 32: 4 launches of kernel 11 per step, all on its wgmma
               body, and nothing else, in bf16 and under quant_scope; 2
               clips against the CPU;
               clips/s and a profile.
 21. serve-int8-unfused — ViViT at token_pad=0 (197 tokens) under
               quant_scope at batch 32: 4 launches of kernel 9 per
               forward, 2 clips against the CPU; dim 384 with 6 heads of 64
               (no bf16 fused instance) served (kernel 3), trained one step
               (kernels 3 and 4, 4 on kernels 12's and 13's wgmma bodies)
               and served in int8 (kernel 9) without kernels 1, 2, 5; ViViT
               at image 320 (401 -> 416 tokens, more than kernel 2 holds)
               trained one step through kernels 3, 4 (4 on those bodies).
 22. train-long — the ViViT of phase 20 trained at batch 32 (dropout 0)
               through make_train_step and make_multi_step(8): 4 launches
               each of kernels 11, 12 and 13 per step, all on their wgmma
               bodies, and none of kernels 1-10, a falling loss, one step's
               gradients on 2 clips against the CPU; clips/s and step ms as
               the best of 3 windows, the host's enqueue ms, a profiled
               step's device ms, the peak device memory.
 23. kernel-flash-blocked-bwd — kernels 12 and 13 at (1536, 592, 64),
               kv_len 577 (the image-384 step's shape, head views of a
               packed qkv), bf16 and f32, through flash_attention and
               autograd against the plain backward, two runs bit for bit,
               launches by body (bf16 at head dim 64: the wgmma bodies of
               flash_bwd_sm90.cuh where blocked_bwd_on_wgmma says; f32 and
               head dims 128, 256: attention_bwd.cuh's streamed body);
               each kernel's time (CUDA graph), the plain version's, SDPA's
               backward as the yardstick, the bounds, ptxas' report of the
               wgmma bodies; untimed: Sq != Skv (40 x 300), head dim 256
               at S 600, head dim 128 at S 520.
 24. kernel-ring — kernels 14 and 15 at the sequence-parallel bench's
               shape (512 sequences of 208 tokens, 197 live, 3 heads of
               64), bf16 and f32, against their plain versions, two
               backward runs bit for bit; kernels 14's and 15's bodies
               (bf16: the one-shot wgmma body, and kernels 12's and 13's
               wgmma bodies with the column bias) and ptxas' reports;
               times (CUDA graph replay), bounds and
               F.scaled_dot_product_attention with the same additive mask;
               a 4-rank ring run hop by hop on the card (592 tokens in 4
               chunks of 148, kv_len 577) against flash_attention and its
               gradient; ring_mha_split at one rank under autograd.
 25. kernel-mha-ft — kernels 3 and 4 at FrameTransformer's head dims:
               (2, 14, 2688) with 2 heads of 448 (distil_transformer) and
               (2, 15, 2688) with 4 heads of 224 (scene_transformer), and
               the forward at the serving bucket (8, ·), bf16, on their
               streamed bodies: o, lse and dq, dk, dv against the plain
               versions, two runs bit for bit, dropout 0.5 against the
               exported masks and the dropped share; kernel, plain and
               SDPA times by CUDA graph, the bounds; which SDPA backends
               take the shape, each forced in turn; ptxas' report of the
               new instances.
 26. serve-ft — every FrameTransformer variant at full width (13 scenes,
               clips of 12 x 112², frames 224², bf16, seeded weights)
               behind Predictor(buckets=(8,)) on u8 frames and clips: kernel
               3's launches by head dim (4 at 448 with the distil
               transformer, 4 at 224 with the scene transformer), none of
               kernel 4; distil against the CPU at one request; ms a call
               and clips/s, a profile of distil; frame behind
               Predictor(quantize=True): the scene transformer's four qkv
               projections on kernel 6, card vs CPU at the int8 gate.
 27. train-ft — distil at batch 2, dropout 0.5, AdamW 1e-4 on a fixed u8
               batch: make_train_step and make_multi_step(8), 8 launches
               each of kernels 3 and 4 a step, a falling eval loss, the
               video backbone's BatchNorm statistics moving and no other;
               one step's gradients at dropout 0 and 4 scenes (bench.py:523)
               against the CPU, f32 and bf16; step ms, host enqueue ms,
               device ms, peak device memory.
 28. serve-family — TPN (bucket 8: 8 x 20 u8 frames of 224², ResNet-34,
               19 classes), the LSTM (bucket 32: 13 x 4608) and BasicMLP
               (bucket 32: 2048 → 305) behind Predictor in bf16, seeded
               weights: no kernel launch, the scores of their kind, card vs
               CPU on the same bucket; ms a call and requests/s through
               predict, device ms of a profiled forward.
 29. train-family — TPN at B=4, the LSTM and BasicMLP at B=32, the
               contrastive encoder at B=256 (2048 → 2048 → 305 → 128, 510
               negatives a row), bf16, AdamW: make_train_step and
               make_multi_step(8), a falling loss at dropout 0, the BatchNorm
               statistics moving; one step's gradients card vs CPU held to
               the f64 step's ReLU gates (f32 1e-3, bf16 5e-2 of a leaf;
               TPN's bf16 backbone against f64 as phase 27's chain), the
               f32 step's new statistics card vs CPU; samples/s, step ms,
               host enqueue ms, device ms, peak device memory.
 30. family-rest — the expert extractor (ResNet-50 on 32 frames of 224²,
               R3D-18 on 8 clips of 16 x 112²) and collaborative gating
               ((8, 13), experts of 512, 2048 and 2048, out 1024) in f32,
               card vs CPU; ms a call.
 31. entry — ``devt_tpu_torch.main.main`` on the card.  ViViT at phase 7's
               width (B=32, 16 x 224², bf16, AdamW 1e-4) on the synthetic
               dataset: 16 steps in 8 epochs through the pinned placer,
               validation and a checkpoint every 4 epochs, the profiler
               over train steps 3-8, then test; kernels 1 and 2 counted (4
               a step, and 4 forward a validation or test batch); the run
               resumed from its step-8 checkpoint ends on every parameter,
               buffer and moment of the unbroken run bit for bit (or, if
               not, within the spread of two unbroken runs); the
               window's host ms from one step's launches to the next's,
               split by the harness's spans (within an epoch, and at an
               epoch's first step), its device ms, StepTimer's mean over
               the run, numpy's draw of a batch timed apart, the
               checkpoint's snapshot and write.  PTN at phase 14's
               width on a fake MMX expert corpus (64 trailers of 13
               scenes, experts 512 and 2048 wide): kernels 3 and 4 on
               their packed bodies; Predictor.from_checkpoint's scores on
               the test rows equal to the trained state's.  Rows 1-4 of
               the kernels line carry these launches (entry_launches).

The last lines are a JSON line of the kernels (fifteen entries in kernel
order, each with its number), the nvidia-smi line, and
{"ok": true, "device": {...}}.  With no CUDA device, or without the
package beside it, the script fails before printing any result.
"""

from __future__ import annotations

import functools
import json
import math
import subprocess
import sys
import time

SEED = 1130
# main-path shape of the fused block: ViViT space transformer at bucket 32
B, S, D, HEADS, MLP, KV_LEN = 512, 208, 192, 3, 768, 197
# NVIDIA H100 SXM data-sheet peaks (dense): bf16 and int8 tensor cores, f32
# FMA, HBM
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12
# |kernel - plain| <= atol + rtol * |plain|.  f32: the two sum in other
# orders.  bf16: the same roundings, but a sum that lands on the other
# side of a bf16 rounding boundary moves one element by an ulp, and y, u
# are stored in bf16 (an ulp is 2^-7 relative at most).
TOL = {"f32": (1e-4, 1e-4), "bf16": (1e-2, 1.6e-2)}
# scores on the card against the same model on the CPU, both bf16
SCORE_ATOL = 2e-2
# Backward: per tensor, |kernel - plain| <= ulps * eps * max|plain|.  f32
# (eps 2^-23): the sums over the 106,496 rows run in other orders.  bf16
# (eps 2^-8): the same roundings, but an intermediate next to a rounding
# boundary may land on the other side and move what it feeds by an ulp,
# and dx and the weight gradients are stored in bf16.
BWD_ULPS = {"f32": 1024, "bf16": 4}
EPS = {"f32": 2.0 ** -23, "bf16": 2.0 ** -8}
DROPOUT = 0.1
# the fused block's sub-kernels as the profiler names them: the products on
# csrc/block_sm90.cuh's wgmma body, the forward's attention on the one-shot
# body's normalise-after instance (attention_bf16 outside its rule), the
# backward's attention on the recompute and kernels 12's and 13's wgmma
# bodies (attention_bwd_bf16 outside block_bwd_on_wgmma)
FWD_KERNELS = ("ln_qkv_sm90<192, false>", "flash_one_shot<64, 208, false, "
               "true>", "attention_bf16", "out_ffn_sm90")
BWD_ATTENTION = ("block_bwd_pre_sm90<64, 208>", "block_bwd_dq_sm90<64>",
                 "block_bwd_dkv_sm90<64>")
BWD_KERNELS = ("ln_qkv_sm90<192, true>", "ffn_dual_sm90", "row_nk_sm90",
               *BWD_ATTENTION, "attention_bwd_bf16", "wgrad_sm90",
               "reduce_parts")
# kernel 5's three launches: LN1 + qkv on int8 wgmma, the attention (the
# block forward's), out-projection + LN2 + FFN on int8 and bf16 wgmma
QUANT_KERNELS = ("ln_qkv_q8_sm90<192>", "flash_one_shot<64, 208, false, true>",
                 "out_ffn_q8_sm90<192>")
# training: the JAX bench's configuration (batch 32, multi-step of 8)
TRAIN_BATCH, MULTI_STEPS, TRAIN_ITERS, DROP_STEPS = 32, 8, 3, 4
# Gradients of one bf16 step on the card against the same step on the CPU
# (plain path), per leaf: max|card - cpu| <= GRAD_RTOL * max(max|cpu|,
# GRAD_FLOOR).  Both round to bf16 at the same places, but the library
# products of the unfused parts and the kernels' sums run in other orders,
# and a bf16 activation that lands on the other side of a rounding boundary
# moves everything behind it.
GRAD_RTOL, GRAD_FLOOR = 5e-2, 1e-6
# the measured drop share of a site must be within this of the rate (4
# standard deviations at the smallest site, 20.4 M elements, is 2.7e-4)
DROP_BAND = 1e-3


# The int8 block against its plain version: the two quantize the same
# LayerNorm outputs with the same formula, but an output within an ulp of a
# half-integer after scaling may round to the neighbouring int8 code in one
# of the two, which moves that row's qkv or hidden product by one
# quantization step (1/127 of the row's largest LayerNorm output times a
# weight) and, through the keys and values, the rows of its sequence a
# little.  So: kernel 1's tolerance (TOL) on all but this share of y, and
# this share of the largest |y| on every element.
QUANT_FLIP_SHARE, QUANT_MAX_REL = 2e-2, 5e-2
# lse of the attention kernel against the plain version (f32 sums in other
# orders; the scores of bf16 inputs are products of exact values)
LSE_TOL = (1e-4, 1e-4)
# int8 serving.  Card against the same quantized model on the CPU, both
# bf16: the bf16 bound of phase 4 plus the int8 codes that flip between two
# machines.  Int8 against bf16 scores: the limit tests/test_quant.py gives
# the JAX package's quantized Predictor against its full-precision one.
QUANT_SCORE_ATOL = 4e-2
INT8_VS_BF16_MAX_ERR = 8e-2
LABEL_THRESHOLD = 0.3
# PTN serving (bench.py's int8 serving configuration)
PTN_ROWS, PTN_SEQ, PTN_WIDTH, PTN_HEADS, PTN_LAYERS = 256, 13, 2048, 8, 2
PTN_EXPERTS = ("video-embeddings", "audio-embeddings")
# PTN training (bench.py:453 two-modality fusion, :473 dropout training):
# batch 32, attention-probability dropout 0.5 in the reference's regime
PTN_TRAIN_BATCH, PTN_DROPOUT = 32, 0.5
# PTN gradients of one f32 step on the card against the CPU's plain kernel
# path, per leaf: sums in other orders, amplified where a LayerNorm
# backward cancels.  (bf16: _ptn_grad_check.)
PTN_GRAD_RTOL = 1e-3
# MoE-ViViT (bench.py:1188): every second space block's FFN a switch MoE;
# its training also at dropout 0.5, config.yaml's rate
MOE_EXPERTS, MOE_EVERY, MOE_DROPOUT = 4, 2, 0.5
# FrameTransformer (the reference's primary model, Config's defaults): 13
# scenes + CLS (+ the distil token), clips of 12 x 112², images 224², 19
# classes, bf16, dropout 0.5; its encoders' attention: distil_transformer's
# 2 heads of 448 over 14 tokens, scene_transformer's 4 heads of 224 over 15
FT_SEQ, FT_FRAMES, FT_CLASSES, FT_DROPOUT = 13, 12, 19, 0.5
FT_BUCKET, FT_TRAIN_BATCH, FT_LAYERS = 8, 2, 4
FT_HEADS = {"distil_transformer": (2, 448, FT_SEQ + 1),
            "scene_transformer": (4, 224, FT_SEQ + 2)}
# the gradient check's sequence: bench.py:523's distillation row
FT_GRAD_SEQ = 4
# the rest of the family (phases 28-30): TPN over 20 frames a sample,
# served at bucket 8 and trained at B=4; the LSTM and BasicMLP at 32; the
# contrastive encoder at 256, so NT-Xent has 510 negatives a row; one
# step's gradients at the batches below
TPN_FRAMES, TPN_BUCKET, TPN_TRAIN_BATCH = 20, 8, 4
FAMILY_BUCKET, CONTRASTIVE_BATCH, FAMILY_LR = 32, 256, 1e-4
FAMILY_GRAD_BATCH = {"tpn": 1, "lstm": FAMILY_BUCKET,
                     "basicmlp": FAMILY_BUCKET,
                     "contrastive": CONTRASTIVE_BATCH}
# the fused blocks' and attention halves' sub-kernels, as the profiler
# names them (kernels 1 and 7, and 2 and 8, share most of their launches;
# their attention at the main-path shape is the one-shot body's
# normalise-after instance, which kernels 9 and 14 do not launch)
HALF_ATTENTION = "flash_one_shot<64, 208, false, true>"
BLOCK_KERNELS = FWD_KERNELS + BWD_KERNELS + ("out_proj_bf16",
                                             HALF_ATTENTION)


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


def _device_profile(fn, reps: int = 3, host: list | None = None
                    ) -> tuple[list, float, float]:
    """torch.profiler over ``reps`` calls of ``fn``: [(kernel, ms per call,
    launches per call)] by device time, the device-busy share of the wall
    time, and the wall ms per call.  Memory copies count as busy.  ``host``,
    when given, receives [(operator, self CPU ms per call, calls per call)]
    by the host's own time."""
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
            if host is not None:
                host.append((ev.key[:60], ev.self_cpu_time_total / 1e3 / reps,
                             ev.count / reps))
            continue
        name = ev.key.replace("(anonymous namespace)::", "")
        name = name.replace("void ", "").split("(")[0][:70]
        rows.append((name, ev.device_time_total / 1e3 / reps,
                     ev.count / reps))
    rows.sort(key=lambda r: -r[1])
    if host is not None:
        host.sort(key=lambda r: -r[1])
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


def _bound(ops_by_kind: dict, bytes_: float) -> tuple[float, str]:
    """Least time in ms for work of ``ops_by_kind`` operations (by the
    peak rate they run at) and ``bytes_`` bytes moved (each input read
    once, each output written once): the larger of the two times."""
    t_ops = sum(n / PEAK_FLOPS[k] for k, n in ops_by_kind.items())
    t_bytes = bytes_ / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _bound_ms(itemsize: int, kind: str) -> tuple[float, str]:
    """Least time for one block forward.  Keys past kv_len need no work."""
    rows = B * S
    flops = 2 * rows * (4 * D * D + 2 * KV_LEN * D + 2 * D * MLP)
    bytes_ = (3 * rows * D * itemsize + rows * 8 * 4
              + (4 * D * D + 2 * D * MLP) * itemsize + (6 * D + MLP) * 4)
    return _bound({kind: flops}, bytes_)


def _bound_bwd_ms(itemsize: int, kind: str) -> tuple[float, str]:
    """Least time for one block backward.  Operations per row: the qkv
    and z1 recompute, four data gradients and four weight gradients
    (11 D^2 + 5 D MLP multiply-adds) and six S x S products per head over
    the live keys.  Bytes: x, u, dy read and dx written, the residual
    lanes and the weights read, the 11 gradients written."""
    rows = B * S
    flops = 2 * rows * (11 * D * D + 5 * D * MLP + 6 * KV_LEN * D)
    weights = (4 * D * D + 2 * D * MLP) * itemsize + (6 * D + MLP) * 4
    bytes_ = 4 * rows * D * itemsize + rows * 8 * 4 + 2 * weights
    return _bound({kind: flops}, bytes_)


def _block_launch_work() -> dict:
    """Work of each bf16 launch of kernels 1, 2 and 5 (and so of 7 and 8,
    which share theirs) at the main-path shape, by the profiler's name:
    (operations by kind, bytes).  Bytes: each input read once and each
    output written once as the launch reads and writes them
    (csrc/block_sm90.cuh, the one-shot attention, the attention backward's
    recompute and bodies, quant_block_fwd.cu): the keys past kv_len are not
    read; u32 (the f32 u that out_ffn writes for its own residual add), du,
    datt, the attention backward's do and delta and the f32 partials count;
    LayerNorm parameters, biases and scales (under 8 KB) do not.  The
    weight gradients' splits as wgrad_split_rows sizes them on this
    card."""
    import torch

    rows, f, n3, d = B * S, MLP, 3 * D, D // HEADS
    act, act32 = rows * D * 2, rows * D * 4      # a (rows, D) tensor
    stats, lse = rows * 2 * 4, rows * HEADS * 4  # f32 lanes of res
    wqkv, wo, w1 = D * n3 * 2, D * D * 2, D * f * 2
    qkv, hid = rows * n3 * 2, rows * f * 2
    q_kv = act + 2 * B * KV_LEN * D * 2          # q, and k, v of live keys
    col = -(-rows // 128) * 4                    # a column's tile partials
    attn = 2 * B * HEADS * S * KV_LEN * d        # one S x kv_len x d product
    wg_tiles = sum(-(-m // 128) * (n // 192)
                   for m, n in ((f, D), (D, f), (D, D), (D, n3)))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wg_splits = max(1, sms // wg_tiles)
    split_rows = -(-(-(-rows // wg_splits)) // 64) * 64
    parts = -(-rows // split_rows) * (2 * D * f + D * D + D * n3) * 4
    bf = "bf16"
    return {
        "ln_qkv_sm90<192, false>": ({bf: 2 * rows * D * n3},
                                    act + wqkv + qkv + stats),
        "flash_one_shot<64, 208, false, true>": ({bf: 2 * attn},
                                                 q_kv + act + lse),
        "out_ffn_sm90<192>": ({bf: 2 * rows * (D * D + 2 * D * f)},
                              4 * act + act32 + wo + 2 * w1 + stats),
        "ln_qkv_sm90<192, true>": ({bf: 2 * rows * D * n3},
                                   2 * act + stats + wqkv + qkv),
        "ffn_dual_sm90<192>": ({bf: 4 * rows * D * f},
                               3 * act + stats + 2 * w1 + 2 * hid
                               + col * (f + D)),
        "row_nk_sm90<192, 1>": ({bf: 2 * rows * f * D},
                                hid + w1 + 3 * act + stats + act32
                                + 3 * col * D),
        "row_nk_sm90<192, 0>": ({bf: 2 * rows * D * D}, act + wo + act32),
        "attention_bwd_bf16<64>": ({bf: 6 * attn},
                                   q_kv + act32 + lse + act + qkv),
        # the attention backward on wgmma: S and O = P V; S, dP and dQ; S,
        # dP, dV and dK (q, k, v, do, lse and delta read, att, do, delta,
        # dq, dk and dv written)
        "block_bwd_pre_sm90<64, 208>": ({bf: 2 * attn},
                                        q_kv + act32 + lse + 2 * act
                                        + lse),
        "block_bwd_dq_sm90<64>": ({bf: 3 * attn},
                                  q_kv + act + 2 * lse + act),
        "block_bwd_dkv_sm90<64>": ({bf: 4 * attn},
                                   q_kv + act + 2 * lse + 2 * act),
        # kernel 5: the int8 products at the int8 rate, x, the codes, qkv,
        # att and y as stored
        "ln_qkv_q8_sm90<192>": ({"int8": 2 * rows * D * n3},
                                act + D * n3 + qkv),
        "out_ffn_q8_sm90<192>": ({bf: 2 * rows * (D * D + f * D),
                                  "int8": 2 * rows * D * f},
                                 3 * act + wo + D * f + w1),
        "row_nk_sm90<192, 2>": ({bf: 2 * rows * n3 * D},
                                qkv + wqkv + 2 * act + stats + act32
                                + 2 * col * D),
        "wgrad_sm90<192>": ({bf: 2 * rows * (2 * D * f + D * D + D * n3)},
                            2 * hid + 5 * act + qkv + parts),
        "reduce_parts": ({"f32": col // 4 * (6 * D + f) + parts // 4},
                         col * (6 * D + f) + parts + wqkv + wo + 2 * w1
                         + (6 * D + f) * 4),
    }


def _print_launch_bounds(rows) -> None:
    """Each profiled launch of _block_launch_work beside its bound: its
    time a launch (the profiler's time a call over the launches a call it
    traced, fewer than one where it dropped an event)."""
    work = _block_launch_work()
    for name, ms, n in rows:
        if name not in work or not n:
            continue
        ops, bytes_ = work[name]
        bound, by = _bound(ops, bytes_)
        per = ms / n
        print(f"[launch] {name}: {per:.4f} ms a launch, x{n:g} a call | "
              f"{sum(ops.values()) / 1e9:.2f} G operations, "
              f"{bytes_ / 1e6:.1f} MB | bound_ms={bound:.4f} ({by}), "
              f"{bound / per:.1%} of it", flush=True)


def _check_bwd_attention(tag: str, rows) -> None:
    """The attention backward of a profiled bf16 call of kernel 2 or 8 at
    the main-path shape: the three launches of the wgmma route, and no
    attention_bwd_bf16."""
    names = {name for name, _, _ in rows}
    if rows and (not set(BWD_ATTENTION) <= names
                 or any(n.startswith("attention_bwd_bf16") for n in names)):
        raise AssertionError(f"{tag}: launches {sorted(names)}, expected "
                             f"{BWD_ATTENTION} and no attention_bwd_bf16")


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


def _library_layer(dtype):
    """The library's pre-norm encoder layer at the block's shape, with its
    key-padding mask: the one PyTorch call that computes a ViT block."""
    import torch
    import torch.nn.functional as F

    layer = torch.nn.TransformerEncoderLayer(
        D, HEADS, MLP, dropout=0.0, layer_norm_eps=1e-5,
        activation=lambda t: F.gelu(t, approximate="tanh"),
        batch_first=True, norm_first=True, device="cuda", dtype=dtype).eval()
    with torch.no_grad():
        layer.self_attn.in_proj_bias.zero_()     # Wqkv has no bias
    pad_mask = (torch.arange(S, device="cuda") >= KV_LEN).expand(B, S)
    return layer, pad_mask


def phase_kernel(kind: str) -> dict:
    import torch

    from devt_tpu_torch.ops.fused_block import (fused_vit_block,
                                                fused_vit_block_fwd_plain)

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[kind]
    x, params = _block_inputs(dtype, torch.Generator().manual_seed(SEED))
    scale = (D // HEADS) ** -0.5
    layer, pad_mask = _library_layer(dtype)
    with torch.inference_mode():
        before = _body_counts()
        got = fused_vit_block(x, params, HEADS, scale, KV_LEN)
        body = {k: v - before[k] for k, v in _body_counts().items()}
        # the attention launch: the one-shot wgmma body in bf16 (197 live
        # keys at head dim 64), attention_fwd.cuh's in f32
        on_wgmma = kind == "bf16"
        if (body["k1_wgmma"], body["k1_streamed"]) != (int(on_wgmma),
                                                      int(not on_wgmma)):
            raise AssertionError(f"fused_vit_block {kind}: attention launches "
                                 f"by body {body}")
        want = fused_vit_block_fwd_plain(x, params, HEADS, scale, KV_LEN)
        torch.cuda.synchronize()
        atol, rtol = TOL[kind]
        errs = {}
        for name, g, w in zip(("y", "u", "res"), got, want):
            _check_close(f"{kind} {name}", g, w, atol, rtol)
            errs[name] = _max_err(g, w)
        if got[2][..., HEADS + 4:].abs().max().item() != 0.0:
            raise AssertionError("residual lanes past heads+4 must be 0")

        # kernel and library call alike: CUDA graph replay
        n = 20 if kind == "bf16" else 3
        kernel_ms = _graph_ms(
            lambda: fused_vit_block(x, params, HEADS, scale, KV_LEN), n=n)
        plain_ms = _time_ms(
            lambda: fused_vit_block_fwd_plain(x, params, HEADS, scale,
                                              KV_LEN), iters=5)
        library_ms = _graph_ms(
            lambda: layer(x, src_key_padding_mask=pad_mask), n=n)
        prof = _device_profile(
            lambda: fused_vit_block(x, params, HEADS, scale, KV_LEN))
        _print_profile(f"fused_vit_block {kind}", *prof, top=4)
        if kind == "bf16":
            _print_launch_bounds(prof[0])
    ptxas = (f" | {_ptxas('fused_block_fwd', 'ln_qkv_sm90<D, stored>')} | "
             f"{_ptxas('fused_block_fwd', 'out_ffn_sm90<D>')} | "
             f"{_ptxas('fused_block_fwd', ONE_SHOT)}" if kind == "bf16"
             else "")
    bound_ms, bound_by = _bound_ms(x.element_size(), kind)
    out = {"dtype": kind, "max_abs_err": errs, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"[kernel] fused_vit_block_fwd {kind} ({B},{S},{D}) kv_len "
          f"{KV_LEN}: max_abs_err y={errs['y']:.3e} u={errs['u']:.3e} "
          f"res={errs['res']:.3e} (atol {atol}, rtol {rtol}) | kernel_ms="
          f"{kernel_ms:.4f} plain_ms={plain_ms:.4f} library_ms="
          f"{library_ms:.4f} (kernel and library by CUDA graph) bound_ms="
          f"{bound_ms:.4f} ({bound_by}); attention launches by body "
          f"{body['k1_wgmma']} one-shot wgmma, {body['k1_streamed']} "
          f"attention_fwd.cuh{ptxas}", flush=True)
    return out


def _check_bwd(kind: str, tag: str, got, want,
               names=None) -> tuple[float, float]:
    """dx and the gradients ``names`` (default the block's 11) of the
    kernel against the plain version; returns the largest absolute error,
    and the largest error as a share of its tensor's largest element."""
    import torch

    from devt_tpu_torch.ops.fused_block import PARAM_NAMES

    worst = worst_rel = 0.0
    pairs = [("dx", got[0], want[0])] + [(k, got[1][k], want[1][k])
                                         for k in names or PARAM_NAMES]
    for name, g, w in pairs:
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{tag} {name}: {g.dtype} {tuple(g.shape)} "
                                 f"vs {w.dtype} {tuple(w.shape)}")
        if not torch.isfinite(g.float()).all():
            raise AssertionError(f"{tag} {name}: non-finite kernel output")
        err = _max_err(g, w)
        largest = w.float().abs().max().item()
        bound = BWD_ULPS[kind] * EPS[kind] * largest
        if not err <= bound:
            raise AssertionError(f"{tag} {name}: max abs err {err:.3e} > "
                                 f"{bound:.3e} ({BWD_ULPS[kind]} ulps of the "
                                 f"largest element)")
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / largest)
    return worst, worst_rel


def phase_kernel_bwd(kind: str) -> dict:
    import torch
    import torch.nn.functional as F

    from devt_tpu_torch.ops import fused_block as fb

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[kind]
    gen = torch.Generator().manual_seed(SEED + 1)
    x, params = _block_inputs(dtype, gen)
    dy = torch.randn(B, S, D, generator=gen).to(dtype).cuda()
    scale = (D // HEADS) ** -0.5
    with torch.no_grad():
        _, u, res = fb.fused_vit_block(x, params, HEADS, scale, KV_LEN)
        run = lambda: fb._bwd_cuda(x, params, u, res, dy, HEADS, scale,  # noqa: E731
                                   KV_LEN, 0.0, 0)
        before = _body_counts()
        got = run()
        body = {k: v - before[k] for k, v in _body_counts().items()}
        # the attention backward: the wgmma route in bf16 (197 live keys at
        # head dim 64), attention_bwd_f32 in f32
        on_wgmma = kind == "bf16"
        if (body["k2_wgmma"], body["k2_streamed"]) != (int(on_wgmma),
                                                      int(not on_wgmma)):
            raise AssertionError(f"bwd {kind}: attention backward launches "
                                 f"by body {body}")
        want = fb.fused_vit_block_bwd_plain(x, params, u, res, dy, HEADS,
                                            scale, KV_LEN)
        torch.cuda.synchronize()
        err, rel = _check_bwd(kind, f"bwd {kind}", got, want)
        again = run()
        torch.cuda.synchronize()
        same_bits = torch.equal(got[0], again[0]) and all(
            torch.equal(got[1][k], again[1][k]) for k in fb.PARAM_NAMES)
        if not same_bits:
            raise AssertionError(f"bwd {kind}: two runs differ in their bits")
        del want, again
        slow = kind == "f32"
        kernel_ms = _graph_ms(run, n=2 if slow else 20,
                              replays=2 if slow else 5)
        plain_ms = _time_ms(
            lambda: fb.fused_vit_block_bwd_plain(x, params, u, res, dy,
                                                 HEADS, scale, KV_LEN),
            iters=2, warmup=1)
        prof = _device_profile(run, reps=1 if slow else 3)
        _print_profile(f"fused_vit_block backward {kind}", *prof, top=12)
        if kind == "bf16":
            _check_bwd_attention("fused_vit_block backward", prof[0])
            _print_launch_bounds(prof[0])

    # the yardstick: autograd through one library encoder layer, by CUDA
    # graph: the forward and its backward, less the forward
    layer = torch.nn.TransformerEncoderLayer(
        D, HEADS, MLP, dropout=0.0, layer_norm_eps=1e-5,
        activation=lambda t: F.gelu(t, approximate="tanh"),
        batch_first=True, norm_first=True, device="cuda", dtype=dtype)
    pad_mask = (torch.arange(S, device="cuda") >= KV_LEN).expand(B, S)
    xr = x.clone().requires_grad_(True)
    leaves = (xr, *layer.parameters())
    n = 2 if slow else 5
    both_ms = _graph_ms(lambda: torch.autograd.grad(
        layer(xr, src_key_padding_mask=pad_mask), leaves, dy), n=n)
    with torch.no_grad():
        fwd_ms = _graph_ms(lambda: layer(xr, src_key_padding_mask=pad_mask),
                           n=n)
    library_ms = both_ms - fwd_ms
    ptxas = (" | " + " | ".join(
        _ptxas("fused_block_bwd", body) for body in (
            "ln_qkv_sm90<D, stored>", "ffn_dual_sm90<D>",
            "row_nk_sm90<D, mode>", "wgrad_sm90<BN>", BLOCK_PRE, BLOCK_DQ,
            BLOCK_DKV))
        if kind == "bf16" else "")

    bound_ms, bound_by = _bound_bwd_ms(x.element_size(), kind)
    print(f"[kernel-bwd] fused_vit_block_bwd {kind} ({B},{S},{D}) kv_len "
          f"{KV_LEN}: dx and 11 grads within {BWD_ULPS[kind]} ulps of the "
          f"largest element, max_abs_err={err:.3e} ({rel:.3e} of its tensor's "
          f"largest element) | two runs bit-equal: "
          f"{same_bits} | kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} (autograd of nn.TransformerEncoder"
          f"Layer; kernel and library by CUDA graph) bound_ms="
          f"{bound_ms:.4f} ({bound_by}){ptxas}", flush=True)
    return {"dtype": kind, "max_abs_err": err, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_dropout() -> dict:
    """Both kernels at rate 0.1 against the plain versions given the masks
    that the library exports for the seed; drop share per site."""
    import torch

    from devt_tpu_torch.ops import fused_block as fb

    kind, seed = "bf16", 20260
    gen = torch.Generator().manual_seed(SEED + 2)
    x, params = _block_inputs(torch.bfloat16, gen)
    dy = torch.randn(B, S, D, generator=gen).to(torch.bfloat16).cuda()
    scale = (D // HEADS) ** -0.5
    with torch.no_grad():
        keep = fb.dropout_masks(seed, DROPOUT, B, S, D, MLP, "cuda")
        shares = [1.0 - k.float().mean().item() for k in keep]
        for site, share in zip(("out-proj", "hidden", "ffn-out"), shares):
            if abs(share - DROPOUT) > DROP_BAND:
                raise AssertionError(f"dropout site {site}: dropped "
                                     f"{share:.5f}, rate {DROPOUT}")
        fwd = lambda: fb.fused_vit_block(x, params, HEADS, scale, KV_LEN,  # noqa: E731
                                         DROPOUT, seed)
        got = fwd()
        want = fb.fused_vit_block_fwd_plain(x, params, HEADS, scale, KV_LEN,
                                            keep, DROPOUT)
        torch.cuda.synchronize()
        atol, rtol = TOL[kind]
        fwd_err = 0.0
        for name, g, w in zip(("y", "u", "res"), got, want):
            _check_close(f"dropout {name}", g, w, atol, rtol)
            fwd_err = max(fwd_err, _max_err(g, w))
        _, u, res = got
        bwd = lambda: fb._bwd_cuda(x, params, u, res, dy, HEADS, scale,  # noqa: E731
                                   KV_LEN, DROPOUT, seed)
        bgot = bwd()
        bwant = fb.fused_vit_block_bwd_plain(x, params, u, res, dy, HEADS,
                                             scale, KV_LEN, keep, DROPOUT)
        torch.cuda.synchronize()
        bwd_err, bwd_rel = _check_bwd(kind, "dropout bwd", bgot, bwant)
        del want, bwant, keep
        fwd_ms, bwd_ms = _time_ms(fwd), _time_ms(bwd)
    print(f"[dropout] rate {DROPOUT} bf16: dropped share out-proj "
          f"{shares[0]:.5f} hidden {shares[1]:.5f} ffn-out {shares[2]:.5f} "
          f"(band {DROP_BAND}) | forward max_abs_err={fwd_err:.3e}, backward "
          f"max_abs_err={bwd_err:.3e} ({bwd_rel:.3e} of its tensor's largest "
          f"element) against the plain versions given the "
          f"exported masks | fwd_ms={fwd_ms:.4f} bwd_ms={bwd_ms:.4f}",
          flush=True)
    return {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "shares": shares}


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
            "clips_per_s": clips_per_s, "scores": scores}


def _train_batch(n: int, seed: int, image: int = 224):
    """A fixed synthetic batch as the JAX bench draws it: normal clips in
    bf16 (channels-last) and 19 multi-hot genre labels, on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    vid = torch.from_numpy(rng.standard_normal((n, 16, image, image, 3),
                                               dtype=np.float32))
    label = (rng.random((n, 19)) < 0.3).astype(np.float32)
    return {"vid": vid.cuda().to(torch.bfloat16),
            "label": torch.from_numpy(label).cuda()}


def phase_train() -> dict:
    import copy

    import torch

    from devt_tpu_torch.config import Config
    from devt_tpu_torch.models.layers import DropoutRng
    from devt_tpu_torch.models.vivit import ViViT
    from devt_tpu_torch.ops.fused_block import fused_vit_block
    from devt_tpu_torch.parallel.train_step import (make_eval_step,
                                                    make_multi_step,
                                                    make_train_step)
    from devt_tpu_torch.registry import build_model
    from devt_tpu_torch.train.optimizers import build_optimizer
    from devt_tpu_torch.train.state import TrainState
    from devt_tpu_torch.train.steps import forward_and_loss

    cfg = Config(model="vivit", batch_size=TRAIN_BATCH, frame_len=16,
                 n_classes=19, opt="adamW", learning_rate=1e-4,
                 precision="bf16", accum_steps=1)
    model = build_model(cfg, torch.Generator().manual_seed(SEED))
    depth = len(model.space_transformer.blocks)
    reference = copy.deepcopy(model)          # the same weights, for the CPU

    # gradients of one step on 2 clips: the card against the CPU's plain path
    small = _train_batch(2, SEED + 3)

    def step_grads(m, batch):
        params = dict(m.named_parameters())
        loss, _, _ = forward_and_loss(m, cfg, {"params": params}, batch,
                                      DropoutRng(0), train=True)
        return loss.item(), dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))

    model.cuda()
    card_loss, card = step_grads(model, small)
    cpu_loss, cpu = step_grads(reference, {k: v.cpu()
                                           for k, v in small.items()})
    worst, worst_leaf = 0.0, ""
    for name, want in cpu.items():
        got = card[name].cpu()
        if not torch.isfinite(got).all():
            raise AssertionError(f"train: non-finite gradient of {name}")
        ratio = (got - want).abs().max().item() / max(
            want.abs().max().item(), GRAD_FLOOR)
        if ratio > worst:
            worst, worst_leaf = ratio, name
    if not worst <= GRAD_RTOL or abs(card_loss - cpu_loss) > SCORE_ATOL:
        raise AssertionError(
            f"train: card vs CPU gradients differ by {worst:.3e} of the "
            f"leaf's largest element at {worst_leaf} (bound {GRAD_RTOL}); "
            f"loss {card_loss:.5f} vs {cpu_loss:.5f}")
    del reference, card, cpu

    # the main path: one step, then the multi-step executor
    batch = _train_batch(TRAIN_BATCH, SEED + 4)
    stacked = {k: v[None].expand(MULTI_STEPS, *v.shape)
               for k, v in batch.items()}
    state = TrainState.create(dict(model.named_parameters()),
                              build_optimizer(cfg))
    step = make_train_step(model, cfg)
    multi = make_multi_step(model, cfg, MULTI_STEPS)
    evaluate = make_eval_step(model, cfg)
    loss_before = evaluate(state, batch)[0].item()

    _zero_counts()
    state, first = step(state, batch, SEED)
    state, metrics = multi(state, stacked, SEED)
    torch.cuda.synchronize()
    fwd_launches = fused_vit_block.launches
    bwd_launches = fused_vit_block.bwd_launches

    steps = 1 + MULTI_STEPS
    if fwd_launches != depth * steps or bwd_launches != depth * steps \
            or fused_vit_block.wgmma_launches != fwd_launches \
            or fused_vit_block.bwd_wgmma_launches != bwd_launches:
        raise AssertionError(
            f"train: {fwd_launches} forward ({fused_vit_block.wgmma_launches}"
            f" with the one-shot attention) and {bwd_launches} backward "
            f"({fused_vit_block.bwd_wgmma_launches} with the wgmma attention "
            f"backward) launches in {steps} steps, expected {depth} of each "
            f"per step, every attention on the wgmma bodies")
    loss_after = evaluate(state, batch)[0].item()
    losses = (first["loss"].item(), metrics["loss"].item(), loss_after)
    if not all(map(math.isfinite, losses)) or not loss_after < loss_before \
            or state.step != steps:
        raise AssertionError(f"train: loss {loss_before:.5f} before, "
                             f"{losses} during and after {state.step} steps")

    # throughput: best of 3 windows of multi-step calls, host clock, one
    # read of the loss at the end of each window
    multi(state, stacked, SEED)[1]["loss"].item()
    windows, enqueue = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(TRAIN_ITERS):
            state, metrics = multi(state, stacked, SEED)
        enqueue.append(time.perf_counter() - t0)   # the host's share alone
        metrics["loss"].item()
        windows.append(time.perf_counter() - t0)
    n_steps = TRAIN_ITERS * MULTI_STEPS
    step_ms = min(windows) / n_steps * 1e3
    host_ms = enqueue[windows.index(min(windows))] / n_steps * 1e3
    clips_per_s = TRAIN_BATCH * n_steps / min(windows)
    host: list = []
    rows, busy, wall_ms = _device_profile(lambda: step(state, batch, SEED),
                                          host=host)
    _print_profile("train step, B=32", rows, busy, wall_ms, top=14)
    fwd_ms = sum(ms for name, ms, _ in rows if name.startswith(FWD_KERNELS))
    bwd_ms = sum(ms for name, ms, _ in rows if name.startswith(BWD_KERNELS))
    device_ms = sum(ms for _, ms, _ in rows)
    print(f"[profile]   device total {device_ms:.3f} ms per step: fused "
          f"block forward {fwd_ms:.3f}, fused block backward {bwd_ms:.3f}, "
          f"everything else {device_ms - fwd_ms - bwd_ms:.3f} "
          f"({sum(n for _, _, n in rows):.0f} launches)")
    print(f"[profile]   host, under the profiler: "
          f"{sum(ms for _, ms, _ in host):.3f} ms of its own time per step; "
          f"top operators: " + "; ".join(
              f"{name} {ms:.3f} ms x{n:g}" for name, ms, n in host[:8]))
    print(f"[train] ViViT bf16 AdamW B={TRAIN_BATCH}: {steps} steps (1 + "
          f"make_multi_step({MULTI_STEPS})), fused block launches "
          f"{fwd_launches} forward + {bwd_launches} backward ({depth} of "
          f"each per step); loss on the fixed batch {loss_before:.5f} -> "
          f"{loss_after:.5f}; card vs CPU gradients on 2 clips: worst "
          f"{worst:.3e} of the leaf's largest element at {worst_leaf} "
          f"(bound {GRAD_RTOL}), loss {card_loss:.5f} vs {cpu_loss:.5f} | "
          f"{clips_per_s:.2f} clips/s, step_ms={step_ms:.3f}, of which the "
          f"host needs {host_ms:.3f} ms to enqueue a step (best of 3 "
          f"windows of {n_steps} steps, host clock; windows "
          f"{', '.join(f'{TRAIN_BATCH * n_steps / w:.1f}' for w in windows)})",
          flush=True)

    # the second configuration of the path: dropout 0.1 in both kernels
    drop_model = ViViT(num_classes=19, num_frames=16, channels_last=True,
                       dropout=DROPOUT, dtype=torch.bfloat16).init_weights(
                           torch.Generator().manual_seed(SEED))
    drop_state = TrainState.create(dict(drop_model.named_parameters()),
                                   build_optimizer(cfg))
    drop_multi = make_multi_step(drop_model, cfg, DROP_STEPS)
    drop_stacked = {k: v[:DROP_STEPS] for k, v in stacked.items()}
    fused_vit_block.launches = fused_vit_block.bwd_launches = 0
    drop_state, drop_metrics = drop_multi(drop_state, drop_stacked, SEED)
    drop_loss = drop_metrics["loss"].item()
    drop_counts = (fused_vit_block.launches, fused_vit_block.bwd_launches)
    if drop_counts != (depth * DROP_STEPS,) * 2 \
            or not math.isfinite(drop_loss):
        raise AssertionError(f"train with dropout: launches {drop_counts} in "
                             f"{DROP_STEPS} steps, loss {drop_loss}")
    t0 = time.perf_counter()
    for _ in range(TRAIN_ITERS):
        drop_state, drop_metrics = drop_multi(drop_state, drop_stacked, SEED)
    drop_metrics["loss"].item()
    drop_ms = (time.perf_counter() - t0) / (TRAIN_ITERS * DROP_STEPS) * 1e3
    print(f"[train] the same with dropout {DROPOUT}: {DROP_STEPS} steps, "
          f"launches {drop_counts[0]} forward + {drop_counts[1]} backward, "
          f"mean loss {drop_loss:.5f} | step_ms={drop_ms:.3f} (one window "
          f"of {TRAIN_ITERS * DROP_STEPS} steps, host clock)", flush=True)
    return {"fwd_launches": fwd_launches, "bwd_launches": bwd_launches,
            "clips_per_s": clips_per_s, "step_ms": step_ms,
            "host_ms": host_ms}


def phase_kernel_quant(kind: str) -> dict:
    import torch

    from devt_tpu_torch.ops import quant as tq
    from devt_tpu_torch.ops.fused_block import fused_vit_block

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[kind]
    x, params = _block_inputs(dtype, torch.Generator().manual_seed(SEED + 5))
    qp = tq.quant_block_params(params)
    scale = (D // HEADS) ** -0.5
    # the library has no int8 block: its yardstick is the same block in
    # x's dtype, one call of the library layer on the same input
    layer, pad_mask = _library_layer(dtype)
    run = lambda: tq.quant_fused_vit_block(x, qp, HEADS, scale, KV_LEN)  # noqa: E731
    with torch.inference_mode():
        before = _body_counts()
        got = run()
        body = {k: v - before[k] for k, v in _body_counts().items()}
        # the attention launch: the one-shot wgmma body in bf16, the float
        # route's attention in f32
        on_wgmma = kind == "bf16"
        if (body["k5_wgmma"], body["k5_streamed"]) != (int(on_wgmma),
                                                      int(not on_wgmma)):
            raise AssertionError(f"quant {kind}: attention launches by body "
                                 f"{body}")
        want = tq.quant_fused_vit_block_plain(x, qp, HEADS, scale, KV_LEN)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"quant {kind}: non-finite kernel output")
        atol, rtol = TOL[kind]
        err = (got.float() - want.float()).abs()
        share = (err > atol + rtol * want.float().abs()).float().mean().item()
        max_err = err.max().item()
        largest = want.float().abs().max().item()
        if share > QUANT_FLIP_SHARE or max_err > QUANT_MAX_REL * largest:
            raise AssertionError(
                f"quant {kind}: {share:.3e} of y beyond atol={atol} "
                f"rtol={rtol} (limit {QUANT_FLIP_SHARE}), max abs err "
                f"{max_err:.3e} of largest |y| {largest:.3f} (limit "
                f"{QUANT_MAX_REL})")
        del want, err
        # kernel, control and library call alike: CUDA graph replay
        n = 20 if kind == "bf16" else 3
        kernel_ms = _graph_ms(run, n=n)
        plain_ms = _time_ms(
            lambda: tq.quant_fused_vit_block_plain(x, qp, HEADS, scale,
                                                   KV_LEN), iters=3, warmup=1)
        control_ms = _graph_ms(
            lambda: fused_vit_block(x, params, HEADS, scale, KV_LEN), n=n)
        library_ms = _graph_ms(
            lambda: layer(x, src_key_padding_mask=pad_mask), n=n)
        prof = _device_profile(run)
        _print_profile(f"quant_fused_vit_block {kind}", *prof, top=7)
        if kind == "bf16":
            # the three launches on wgmma, no mma.sync launch left
            names = {name for name, _, _ in prof[0]}
            if prof[0] and names != set(QUANT_KERNELS):
                raise AssertionError(f"quant bf16: launches {sorted(names)}, "
                                     f"expected {QUANT_KERNELS}")
            _print_launch_bounds(prof[0])
    rows, item = B * S, x.element_size()
    int8_ops = 2 * rows * (3 * D * D + D * MLP)
    other_ops = 2 * rows * (D * D + 2 * KV_LEN * D + D * MLP)
    bytes_ = (2 * rows * D * item + (3 * D * D + D * MLP)
              + (D * D + D * MLP) * item + (3 * D + MLP) * 4
              + (6 * D + MLP) * 4)
    bound_ms, bound_by = _bound({"int8": int8_ops, kind: other_ops}, bytes_)
    print(f"[kernel-quant] quant_fused_vit_block {kind} ({B},{S},{D}) kv_len "
          f"{KV_LEN}: {share:.3e} of y beyond the bf16 block's tolerance "
          f"(atol {atol}, rtol {rtol}; limit {QUANT_FLIP_SHARE}), "
          f"max_abs_err={max_err:.3e} of largest |y| {largest:.3f} | "
          f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
          f"bf16_block_ms={control_ms:.4f} (fused_vit_block on the same "
          f"input) library_ms={library_ms:.4f} (nn.TransformerEncoderLayer "
          f"{kind}, the unquantized block; all three by CUDA graph) "
          f"bound_ms={bound_ms:.4f} ({bound_by}); attention launches by body "
          f"{body['k5_wgmma']} one-shot wgmma, {body['k5_streamed']} other"
          + (f" | {_ptxas('quant_block_fwd', 'ln_qkv_q8_sm90<D>')} | "
             f"{_ptxas('quant_block_fwd', 'out_ffn_q8_sm90<D>')}"
             if kind == "bf16" else ""), flush=True)
    return {"dtype": kind, "max_abs_err": max_err, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_int8_matmul(n: int) -> dict:
    """(3584, 2048) bf16 x (2048, n) int8: the Linear sites of PTN at 256
    rows of 14 tokens.  The weight codes K-major, as the site registry
    stores them, take the wgmma body (one launch on it, counted); the same
    codes row-major (JAX's layout) the mma.sync body; both bit for bit
    against the plain version.  Times by CUDA graph replay: the kernel,
    the mma.sync body, the plain version, F.linear in bf16 and
    torch._int_mm with its own quantize and dequantize passes as
    yardsticks; the row pass's share from the profiler."""
    import torch
    import torch.nn.functional as F

    from devt_tpu_torch.ops import quant as tq

    m, k = PTN_ROWS * (PTN_SEQ + 1), PTN_WIDTH
    gen = torch.Generator().manual_seed(SEED + 6)
    x = torch.randn(m, k, generator=gen).to(torch.bfloat16).cuda()
    w = (torch.randn(k, n, generator=gen) * k ** -0.5).cuda()
    w_q, w_s = tq.quantize_weight(w.to(torch.bfloat16))
    kmajor = w_q.t().contiguous().t()                # the registry's layout
    run = lambda: tq.int8_matmul_fused(x, kmajor, w_s)  # noqa: E731
    tag = f"int8_matmul_fused bf16 ({m},{k})x({k},{n})"
    with torch.inference_mode():
        before = _body_counts()
        got = run()
        body = {key: v - before[key] for key, v in _body_counts().items()}
        if body != {**dict.fromkeys(body, 0), "k6_wgmma": 1}:
            raise AssertionError(f"{tag}: launches by body {body}, expected "
                                 f"one on the wgmma body")
        want = tq.int8_matmul_fused_plain(x, w_q, w_s)
        old = tq.int8_matmul_fused(x, w_q, w_s)      # the mma.sync body
        torch.cuda.synchronize()
        max_err = _max_err(got, want)
        for name, out in (("wgmma", got), ("mma.sync", old)):
            if not torch.isfinite(out.float()).all() \
                    or not torch.equal(out, want):
                raise AssertionError(
                    f"{tag}: the {name} body and the plain version differ "
                    f"in {int((out != want).sum())} elements, max abs err "
                    f"{_max_err(out, want):.3e}; the int32 sums are exact, "
                    f"they must agree bit for bit")
        del want, old, got
        kernel_ms = _graph_ms(run)
        mma_sync_ms = _graph_ms(lambda: tq.int8_matmul_fused(x, w_q, w_s))
        plain_ms = _graph_ms(
            lambda: tq.int8_matmul_fused_plain(x, kmajor, w_s), n=2,
            replays=2)
        w_bf = w.to(torch.bfloat16).t().contiguous()       # Linear layout
        linear_ms = _graph_ms(lambda: F.linear(x, w_bf))

        # not the kernels line's library_ms (that is F.linear, the one
        # call a user would make): the library's int8 product needs its
        # own quantize and dequantize passes
        def int_mm():
            x_q, x_s = tq.quantize_activation(x)
            return (torch._int_mm(x_q, w_q).float() * x_s * w_s).to(x.dtype)

        int_mm_ms = _graph_ms(int_mm)
        rows, busy, wall = _device_profile(run)
        _print_profile(f"int8_matmul_fused n={n}", rows, busy, wall, top=3)
    quant_ms = sum(ms for name, ms, _ in rows if "quant_rows" in name)
    bytes_ = m * k * 2 + k * n + n * 4 + m * n * 2
    bound_ms, bound_by = _bound({"int8": 2 * m * k * n}, bytes_)
    print(f"[kernel-int8-matmul] {tag}, K-major codes: wgmma body (one "
          f"launch), bit-equal to the plain version (max_abs_err="
          f"{max_err:.1e}), and so is the mma.sync body on row-major codes | "
          f"CUDA graph: kernel_ms={kernel_ms:.4f} (of which the row pass "
          f"{quant_ms:.4f} under the profiler) mma.sync body "
          f"{mma_sync_ms:.4f} plain_ms={plain_ms:.4f} library_ms="
          f"{linear_ms:.4f} (F.linear bf16); quantize + torch._int_mm + "
          f"dequantize {int_mm_ms:.4f} ms | bound_ms={bound_ms:.4f} "
          f"({bound_by}) | {_ptxas('int8_matmul', 'gemm_s8_wgmma<out>')}",
          flush=True)
    return {"max_abs_err": max_err, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": linear_ms,
            "int_mm_ms": int_mm_ms, "mma_sync_ms": mma_sync_ms,
            "quant_rows_ms": quant_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_mha(kind: str, b: int, s: int, heads: int, d: int,
              kv_len: int) -> dict:
    import torch
    import torch.nn.functional as F

    from devt_tpu_torch.ops import flash_attention as tfa

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[kind]
    gen = torch.Generator().manual_seed(SEED + 7)
    qkv = torch.randn(b, s, 3 * heads * d, generator=gen).to(dtype).cuda()
    scale = d ** -0.5
    run = lambda: tfa.fused_mha(qkv, heads=heads, kv_len=kv_len,  # noqa: E731
                                return_lse=True)
    route = tfa.mha_fwd_on_wgmma(dtype, d, s, kv_len, 0.0)
    with torch.inference_mode():
        before = _body_counts()
        o, lse = run()
        body = {k: v - before[k] for k, v in _body_counts().items()}
        if body != {**dict.fromkeys(body, 0), f"k3_{route}": 1}:
            raise AssertionError(f"kernel-mha {kind} ({b},{s}): launches by "
                                 f"body {body}, expected one on the {route} "
                                 f"body")
        want_o, want_lse = tfa.fused_mha_plain(qkv, heads, scale, kv_len)
        torch.cuda.synchronize()
        _check_close(f"mha {kind} o", o, want_o, *TOL[kind])
        _check_close(f"mha {kind} lse", lse, want_lse, *LSE_TOL)
        errs = (_max_err(o, want_o), _max_err(lse, want_lse))
        del want_o, want_lse
        # the kernel and SDPA by CUDA graph replay (at PTN's 256 rows a
        # launch takes about as long on the card as its wrapper on the
        # host); the plain version by events around eager calls
        kernel_ms = _graph_ms(run)
        plain_ms = _time_ms(
            lambda: tfa.fused_mha_plain(qkv, heads, scale, kv_len), iters=3,
            warmup=1)
        split = qkv.reshape(b, s, 3, heads, d)
        q, k, v = (split[:, :, i].transpose(1, 2) for i in range(3))

        def sdpa():     # the library's fused attention on the live keys
            out = F.scaled_dot_product_attention(
                q, k[:, :, :kv_len], v[:, :, :kv_len], scale=scale)
            return out.transpose(1, 2).reshape(b, s, heads * d)

        library_ms = _graph_ms(sdpa)
    item = qkv.element_size()
    flops = 4 * b * heads * s * kv_len * d
    bytes_ = qkv.numel() * item + b * s * heads * d * item + b * s * heads * 4
    bound_ms, bound_by = _bound({kind: flops}, bytes_)
    if route == "packed":
        g, tiles, _ = tfa.mha_packed_tiling(b, s, heads, kv_len)
        where = (f"the packed body (mha_fwd_sm90.cuh: {g} sequences a 64-row "
                 f"tile, {tiles} tiles) | "
                 f"{_ptxas('mha_fwd', 'mha_fwd_packed<d>')}")
    elif route == "one_shot":
        where = ("kernel 9's one-shot instance (flash_fwd_sm90.cuh) | "
                 f"{_ptxas('mha_fwd', ONE_SHOT)}")
    else:
        where = "the streamed body (attention_fwd.cuh)"
    print(f"[kernel-mha] fused_mha {kind} ({b},{s},{3 * heads * d}) "
          f"{heads} heads of {d}, kv_len {kv_len}, on {where}: "
          f"max_abs_err o="
          f"{errs[0]:.3e} (atol {TOL[kind][0]}, rtol {TOL[kind][1]}) lse="
          f"{errs[1]:.3e} (atol {LSE_TOL[0]}, rtol {LSE_TOL[1]}) | "
          f"kernel_ms={kernel_ms:.4f} library_ms={library_ms:.4f} "
          f"(F.scaled_dot_product_attention; both CUDA graph) plain_ms="
          f"{plain_ms:.4f} (CUDA events, eager) bound_ms={bound_ms:.4f} "
          f"({bound_by})", flush=True)
    return {"max_abs_err": max(errs), "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _agreement(a, b) -> tuple[float, float]:
    """Label agreement at the serving threshold and the largest score
    difference of two score arrays."""
    import numpy as np

    agree = float(np.mean((a > LABEL_THRESHOLD) == (b > LABEL_THRESHOLD)))
    return agree, float(np.abs(a - b).max())


def phase_serve_int8(bf16: dict) -> dict:
    import numpy as np
    import torch

    from devt_tpu_torch.config import Config
    from devt_tpu_torch.ops.fused_block import fused_vit_block
    from devt_tpu_torch.ops.quant import quant_fused_vit_block
    from devt_tpu_torch.registry import build_model
    from devt_tpu_torch.serve import Predictor

    cfg = Config(model="vivit", frame_len=16, n_classes=19, precision="bf16",
                 dropout=0.0)
    weights = build_model(cfg, torch.Generator().manual_seed(SEED)) \
        .state_dict()
    pred = Predictor(cfg, weights, buckets=(1, 8, 32), quantize=True)
    clips = np.random.default_rng(SEED).integers(
        0, 256, (37, cfg.frame_len, 224, 224, 3), dtype=np.uint8)
    depth = len(pred.model.space_transformer.blocks)
    sites = pred._qsites
    # every block's Wqkv and W1 codes K-major, as kernel 5's int8 wgmma
    # reads them
    if len(sites) != 2 * depth or not all(
            qp[k].dtype == torch.int8 and qp[k].is_cuda
            for qp in sites for k in ("wqkv_q", "wo_q", "w1_q", "w2_q")) \
            or not all(qp[k].stride() == (1, qp[k].shape[0])
                       for qp in sites for k in ("wqkv_q", "w1_q")):
        raise AssertionError("serve-int8: the quantized sites are not int8 "
                             "tensors on the card, or a block's Wqkv / W1 "
                             "codes are not K-major")

    _zero_counts()
    out = pred.predict({"vid": clips})
    launches = quant_fused_vit_block.launches
    bucket_calls = 2                       # 37 clips = bucket 32 + bucket 8
    if launches != depth * bucket_calls or fused_vit_block.launches != 0 \
            or quant_fused_vit_block.wgmma_launches != launches:
        raise AssertionError(
            f"serve-int8: {launches} int8-block ("
            f"{quant_fused_vit_block.wgmma_launches} with the one-shot "
            f"attention) and {fused_vit_block.launches} bf16-block launches, "
            f"expected {depth} per bucket call, all on the one-shot body, "
            f"and 0")
    scores = out["scores"]
    if scores.shape != (37, cfg.n_classes) or not np.isfinite(scores).all() \
            or scores.min() <= 0.0 or scores.max() >= 1.0:
        raise AssertionError(f"serve-int8: bad scores: shape {scores.shape}, "
                             f"range [{scores.min()}, {scores.max()}]")
    cpu = Predictor(cfg, weights, buckets=(2,), device="cpu", quantize=True)
    ref = cpu.predict({"vid": clips[:2]})["scores"]
    score_err = float(np.abs(scores[:2] - ref).max())
    agree, max_err = _agreement(bf16["scores"], scores)
    if not score_err <= QUANT_SCORE_ATOL or not max_err <= INT8_VS_BF16_MAX_ERR:
        raise AssertionError(
            f"serve-int8: card vs CPU scores differ by {score_err:.3e} "
            f"(limit {QUANT_SCORE_ATOL}); int8 vs bf16 scores by "
            f"{max_err:.3e} (limit {INT8_VS_BF16_MAX_ERR})")

    batch = {"vid": clips[:32]}
    pred.predict(batch)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        pred.predict(batch)
    clips_per_s = 32 * reps / (time.perf_counter() - t0)
    prof = _device_profile(lambda: pred.predict(batch))
    _print_profile("int8 predict, bucket 32", *prof, top=10)
    device_ms = sum(ms for _, ms, _ in prof[0])
    quant_ms = sum(ms for name, ms, _ in prof[0]
                   if name.startswith(QUANT_KERNELS))
    print(f"[profile]   device total {device_ms:.3f} ms per bucket-32 call: "
          f"kernel 5 {quant_ms:.3f}, everything else "
          f"{device_ms - quant_ms:.3f}")
    print(f"[serve-int8] ViViT Predictor(quantize=True, buckets=(1, 8, 32)) "
          f"on 37 u8 clips: int8 block launches {launches} ({depth} per "
          f"bucket call x {bucket_calls}), bf16 block launches 0, "
          f"{len(sites)} quantized sites made at construction; scores in "
          f"({scores.min():.4f}, {scores.max():.4f}); card vs CPU max abs "
          f"err {score_err:.3e} (limit {QUANT_SCORE_ATOL}); against the bf16 "
          f"scores of phase 4: label agreement at {LABEL_THRESHOLD} "
          f"{agree:.4f}, max score err {max_err:.3e} (limit "
          f"{INT8_VS_BF16_MAX_ERR}) | {clips_per_s:.2f} clips/s at bucket 32 "
          f"(host clock, u8 upload included) beside {bf16['clips_per_s']:.2f} "
          f"in bf16", flush=True)
    return {"launches": launches, "clips_per_s": clips_per_s,
            "device_ms": device_ms, "k5_device_ms": quant_ms}


def phase_serve_ptn() -> dict:
    import torch

    from devt_tpu_torch.config import Config
    from devt_tpu_torch.ops.flash_attention import fused_mha
    from devt_tpu_torch.ops.quant import int8_matmul_fused
    from devt_tpu_torch.registry import build_model
    from devt_tpu_torch.serve import Predictor

    cfg = Config(model="ptn", batch_size=PTN_ROWS, seq_len=PTN_SEQ,
                 nlayers=PTN_LAYERS, nhid=PTN_WIDTH,
                 input_dimension=PTN_WIDTH, nhead=PTN_HEADS, dropout=0.0,
                 precision="bf16", experts=PTN_EXPERTS)
    weights = build_model(cfg, torch.Generator().manual_seed(SEED)) \
        .state_dict()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    experts = torch.randn(PTN_ROWS, PTN_SEQ, len(PTN_EXPERTS), PTN_WIDTH,
                          generator=gen, device="cuda") * 0.5
    request = {"experts": experts.cpu().numpy()}
    encoders = len(PTN_EXPERTS) * PTN_LAYERS       # attention calls a forward
    variants = (("bf16", False, None, 0),
                ("int8", True, None, encoders),
                ("int8_all_sites", True, lambda k, n: True, 4 * encoders))
    out: dict = {"mha_launches": 0, "matmul_launches": 0}
    scores = {}
    for tag, quant, site_pred, want_matmuls in variants:
        pred = Predictor(cfg, weights, buckets=(PTN_ROWS,), quantize=quant,
                         quant_site_pred=site_pred)
        mm = int8_matmul_fused
        _zero_counts()
        got = pred.predict(request)["scores"]
        counts = (fused_mha.launches, mm.launches, mm.wgmma_launches,
                  fused_mha.packed_launches)
        if counts != (encoders, want_matmuls, want_matmuls, encoders):
            raise AssertionError(
                f"serve-ptn {tag}: {counts[0]} attention ({counts[3]} on the "
                f"packed body) and {counts[1]} int8-matmul launches "
                f"({counts[2]} on the wgmma body) in one forward, expected "
                f"{encoders} and {want_matmuls}, every attention launch on "
                f"the packed body and every int8-matmul launch on the wgmma "
                f"body (the site registry stores K-major codes)")
        out["mha_launches"] += counts[0]
        out["matmul_launches"] += counts[1]
        if got.shape != (PTN_ROWS, cfg.n_classes) \
                or not (got > 0.0).all() or not (got < 1.0).all():
            raise AssertionError(f"serve-ptn {tag}: bad scores, shape "
                                 f"{got.shape}")
        scores[tag] = got
        cpu = Predictor(cfg, weights, buckets=(4,), device="cpu",
                        quantize=quant, quant_site_pred=site_pred)
        ref = cpu.predict({"experts": request["experts"][:4]})["scores"]
        cpu_err = float(abs(got[:4] - ref).max())
        del cpu
        if not cpu_err <= QUANT_SCORE_ATOL:
            raise AssertionError(f"serve-ptn {tag}: card vs CPU scores "
                                 f"differ by {cpu_err:.3e} (limit "
                                 f"{QUANT_SCORE_ATOL})")
        # rows/s on device-resident input: best of 3 windows of 10 forwards,
        # one synchronisation a window
        batch = {"experts": experts}
        windows = []
        with torch.inference_mode():
            pred.forward(batch)
            torch.cuda.synchronize()
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(10):
                    pred.forward(batch)
                torch.cuda.synchronize()
                windows.append((time.perf_counter() - t0) / 10)
            profile = _device_profile(lambda: pred.forward(batch))
        _print_profile(f"PTN {tag} forward, {PTN_ROWS} rows", *profile, top=8)
        out[tag] = {"rows_per_s": PTN_ROWS / min(windows),
                    "forward_ms": min(windows) * 1e3, "cpu_err": cpu_err,
                    "device_ms": sum(ms for _, ms, _ in profile[0])}
        del pred
    for tag in ("int8", "int8_all_sites"):
        agree, max_err = _agreement(scores["bf16"], scores[tag])
        out[tag]["agree"], out[tag]["max_err"] = agree, max_err
        if not max_err <= INT8_VS_BF16_MAX_ERR:
            raise AssertionError(f"serve-ptn {tag}: scores differ from bf16 "
                                 f"by {max_err:.3e} (limit "
                                 f"{INT8_VS_BF16_MAX_ERR})")
    print(f"[serve-ptn] PTN bf16 ({PTN_ROWS} rows x {PTN_SEQ} scenes x "
          f"{len(PTN_EXPERTS)} experts x {PTN_WIDTH}, {PTN_LAYERS} layers, "
          f"{PTN_HEADS} heads) behind Predictor(buckets=({PTN_ROWS},)): "
          f"attention launches {encoders} a forward in each variant, all "
          f"on kernel 3's packed body, int8-matmul launches 0 / {encoders} / "
          f"{4 * encoders}, all on the wgmma body; " + "; ".join(
              f"{tag}: {v['rows_per_s']:.1f} rows/s, forward "
              f"{v['forward_ms']:.3f} ms (device {v['device_ms']:.3f} ms), "
              f"card vs CPU {v['cpu_err']:.3e}" + (
                  f", vs bf16 label agreement {v['agree']:.4f} max err "
                  f"{v['max_err']:.3e}" if "agree" in v else "")
              for tag, v in out.items() if isinstance(v, dict))
          + f" (limits {QUANT_SCORE_ATOL} and {INT8_VS_BF16_MAX_ERR}; best of "
          f"3 windows of 10 forwards on device-resident input, host clock)",
          flush=True)
    return out


def _traced(fn, reps: int = 3):
    """``_device_profile`` three times, keeping the reading with the most
    device time: the profiler can drop device events (phases 11 and 12
    have shown fractional launch counts), which only ever lowers a
    reading."""
    readings = [_device_profile(fn, reps=reps) for _ in range(3)]
    return max(readings, key=lambda r: sum(ms for _, ms, _ in r[0]))


def _graph_ms(fn, n: int = 20, replays: int = 5) -> float:
    """Device time per call of ``fn``: ``n`` calls captured in one CUDA
    graph, replayed and timed with CUDA events.  At PTN's 32 sequences a
    kernel takes less time on the card than its wrapper takes on the host,
    so events around back-to-back eager calls would time the host, and the
    profiler drops events now and then."""
    import torch

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


def _check_dqkv(kind, tag, got, want, heads, d) -> tuple[float, float]:
    """dq, dk and dv of the backward kernel against the plain version, per
    tensor within BWD_ULPS of its largest element; returns the largest
    absolute error and the largest as a share of its tensor's largest
    element."""
    import torch

    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{tag}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    worst = worst_rel = 0.0
    for i, name in enumerate(("dq", "dk", "dv")):
        cols = slice(i * heads * d, (i + 1) * heads * d)
        g, w = got[..., cols].float(), want[..., cols].float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{tag} {name}: non-finite kernel output")
        err = (g - w).abs().max().item()
        largest = w.abs().max().item()
        bound = BWD_ULPS[kind] * EPS[kind] * largest
        if not err <= bound:
            raise AssertionError(f"{tag} {name}: max abs err {err:.3e} > "
                                 f"{bound:.3e} ({BWD_ULPS[kind]} ulps of the "
                                 f"largest element)")
        worst, worst_rel = max(worst, err), max(worst_rel, err / largest)
    return worst, worst_rel


def phase_mha_bwd(kind: str, b: int, s: int, heads: int, d: int,
                  kv_len: int, dropout: bool = False,
                  ptxas: bool = False) -> dict:
    """Kernel 4, through ``fused_mha`` and autograd, against its plain
    backward on the forward's (o, lse), every launch on the body its rule
    (``mha_bwd_on_wgmma``) names; with ``dropout``, both attention kernels
    at rate PTN_DROPOUT against the plain versions given the exported
    masks, and kernel 4's time at that rate; with ``ptxas``, the registers
    and spills of kernel 4's wgmma instances."""
    import torch
    import torch.nn.functional as F

    from devt_tpu_torch.ops import flash_attention as tfa

    if ptxas:
        for name in ("mha_bwd_packed<d, drop>", "mha_bwd_dq_sm90<d, drop>",
                     "mha_bwd_dkv_sm90<d, drop>"):
            print(f"[kernel-mha-bwd] {_ptxas('mha_bwd', name)}", flush=True)
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[kind]
    body = tfa.mha_bwd_on_wgmma(dtype, d, s, kv_len, 0.0)
    gen = torch.Generator().manual_seed(SEED + 8)
    qkv = torch.randn(b, s, 3 * heads * d, generator=gen).to(dtype).cuda()
    do = torch.randn(b, s, heads * d, generator=gen).to(dtype).cuda()
    scale = d ** -0.5
    tag = f"mha-bwd {kind} ({b},{s},{3 * heads * d})"

    def through_autograd(rate=0.0, seed=0):
        """o, lse and dqkv through fused_mha and autograd, as a training
        step runs them: the wrapper's saved tensors, cast and seed."""
        leaf = qkv.detach().requires_grad_(True)
        with torch.enable_grad():
            out, lse_ = tfa.fused_mha(leaf, heads=heads, kv_len=kv_len,
                                      dropout_rate=rate, seed=seed,
                                      return_lse=True)
            dqkv, = torch.autograd.grad(out, leaf, do)
        return out.detach(), lse_, dqkv

    with torch.no_grad():
        _zero_counts()
        o, lse, got = through_autograd()
        if _body_counts()[f"k4_{body}"] != 1 or tfa.fused_mha.bwd_launches \
                != 1:
            raise AssertionError(f"{tag}: kernel 4 launches by body "
                                 f"{_body_counts()}, expected one on the "
                                 f"{body} body")
        want = tfa.fused_mha_bwd_plain(qkv, o, lse, do, heads, scale, kv_len)
        torch.cuda.synchronize()
        err, rel = _check_dqkv(kind, tag, got, want, heads, d)
        same_bits = torch.equal(got, through_autograd()[2])
        if not same_bits:
            raise AssertionError(f"{tag}: two runs differ in their bits")
        del want
        # the kernel alone, for its times
        run = lambda: tfa._mha_bwd_cuda(qkv, o, lse, do, heads, scale,  # noqa: E731
                                        kv_len)
        wall_ms = _time_ms(run)
        kernel_ms = _graph_ms(run)
        plain_ms = _time_ms(
            lambda: tfa.fused_mha_bwd_plain(qkv, o, lse, do, heads, scale,
                                            kv_len), iters=3, warmup=1)

    # the yardstick: the library's fused attention on the same split q, k,
    # v (live keys only) through autograd, forward + backward less forward
    split = qkv.reshape(b, s, 3, heads, d)
    q, k, v = (split[:, :, i].transpose(1, 2).detach().requires_grad_(True)
               for i in range(3))
    do_split = do.reshape(b, s, heads, d).transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(
            q, k[:, :, :kv_len], v[:, :, :kv_len], scale=scale)

    with torch.no_grad():
        sdpa_fwd_ms = _graph_ms(sdpa)
    sdpa_fwd_bwd_ms = _graph_ms(
        lambda: torch.autograd.grad(sdpa(), (q, k, v), do_split))
    library_ms = sdpa_fwd_bwd_ms - sdpa_fwd_ms

    item = qkv.element_size()
    flops = 5 * 2 * b * heads * s * kv_len * d
    bytes_ = 2 * qkv.numel() * item + 2 * o.numel() * item + lse.numel() * 4
    bound_ms, bound_by = _bound({kind: flops}, bytes_)
    out = {"dtype": kind, "max_abs_err": err, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "body": body}
    drop_text = ""
    if dropout:
        rate, seed = PTN_DROPOUT, 20261
        with torch.no_grad():
            keep = tfa.mha_dropout_masks(seed, rate, b, s, heads, "cuda")
            share = 1.0 - keep.float().mean().item()
            band = 4 * (rate * (1 - rate) / keep.numel()) ** 0.5
            other = tfa.mha_dropout_masks(seed + 1, rate, b, s, heads, "cuda")
            if abs(share - rate) > band or torch.equal(keep, other):
                raise AssertionError(f"{tag}: dropped share {share:.5f} "
                                     f"(rate {rate}, band {band:.2e}), or "
                                     f"another seed gave the same mask")
            del other
            _zero_counts()
            od, lsed, dgot = through_autograd(rate, seed)
            if _body_counts()[f"k4_{body}"] != 1:
                raise AssertionError(f"{tag} dropout: kernel 4 launches by "
                                     f"body {_body_counts()}, expected one "
                                     f"on the {body} body")
            wo, wlse = tfa.fused_mha_plain(qkv, heads, scale, kv_len, keep,
                                           rate)
            torch.cuda.synchronize()
            _check_close(f"{tag} dropout o", od, wo, *TOL[kind])
            _check_close(f"{tag} dropout lse", lsed, wlse, *LSE_TOL)
            fwd_err = _max_err(od, wo)
            dwant = tfa.fused_mha_bwd_plain(qkv, od, lsed, do, heads, scale,
                                            kv_len, keep, rate)
            torch.cuda.synchronize()
            derr, _ = _check_dqkv(kind, f"{tag} dropout", dgot, dwant, heads,
                                  d)
            if not torch.equal(dgot, through_autograd(rate, seed)[2]):
                raise AssertionError(f"{tag} dropout: two runs differ")
            fwd = lambda: tfa.fused_mha(qkv, heads=heads, kv_len=kv_len,  # noqa: E731
                                        dropout_rate=rate, seed=seed)
            bwd = lambda: tfa._mha_bwd_cuda(qkv, od, lsed, do, heads, scale,  # noqa: E731
                                            kv_len, rate, seed)
            del keep, wo, dwant
            fwd0_ms = _graph_ms(lambda: tfa.fused_mha(qkv, heads=heads,
                                                      kv_len=kv_len))
            fwd_drop_ms = _graph_ms(fwd)
            bwd_drop_ms = _graph_ms(bwd)
        out.update(fwd0_ms=fwd0_ms, fwd_drop_ms=fwd_drop_ms,
                   bwd_drop_ms=bwd_drop_ms, bwd_drop_max_abs_err=derr)
        drop_text = (
            f" | dropout {rate}: dropped share {share:.5f} (band {band:.1e}; "
            f"another seed, another mask), forward max_abs_err="
            f"{fwd_err:.3e} and backward {derr:.3e} against the plain "
            f"versions given the exported mask, two runs bit-equal; device "
            f"time of kernel 3 {fwd_drop_ms:.4f} ms at rate {rate} against "
            f"{fwd0_ms:.4f} at 0, of kernel 4 {bwd_drop_ms:.4f} ms against "
            f"{kernel_ms:.4f}")
    print(f"[kernel-mha-bwd] fused_mha backward {kind} ({b},{s},"
          f"{3 * heads * d}) {heads} heads of {d}, kv_len {kv_len}, on the "
          f"{body} body (mha_bwd_on_wgmma; one launch counted there), through "
          f"fused_mha and autograd against the plain backward on the "
          f"forward's (o, lse): dq, dk, dv within {BWD_ULPS[kind]} ulps of the largest element, "
          f"max_abs_err={err:.3e} ({rel:.3e} of its tensor's largest "
          f"element) | two runs bit-equal: {same_bits} | kernel_ms="
          f"{kernel_ms:.4f} (device time: 20 calls in a CUDA graph; CUDA "
          f"events over back-to-back eager calls {wall_ms:.4f}) plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} (device time, CUDA graph, of "
          f"F.scaled_dot_product_attention through autograd: forward + "
          f"backward {sdpa_fwd_bwd_ms:.4f} less forward {sdpa_fwd_ms:.4f}) "
          f"bound_ms={bound_ms:.4f} ({bound_by})"
          + drop_text, flush=True)
    return out


def _ptn_config(**kw):
    from devt_tpu_torch.config import Config

    base = dict(model="ptn", batch_size=PTN_TRAIN_BATCH, seq_len=PTN_SEQ,
                nlayers=PTN_LAYERS, nhid=PTN_WIDTH,
                input_dimension=PTN_WIDTH, nhead=PTN_HEADS,
                experts=PTN_EXPERTS, opt="adamW", learning_rate=1e-4,
                precision="bf16", dropout=0.0)
    return Config(**{**base, **kw})


def _ptn_batch(n: int, seed: int) -> dict:
    """Normal expert embeddings and 15 multi-hot genre labels, on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    experts = rng.standard_normal((n, PTN_SEQ, len(PTN_EXPERTS), PTN_WIDTH),
                                  dtype=np.float32)
    label = (rng.random((n, 15)) < 0.3).astype(np.float32)
    return {"experts": torch.from_numpy(experts).cuda(),
            "label": torch.from_numpy(label).cuda()}


def _ptn_grad_gaps(kind: str, impl: str) -> tuple[dict, float]:
    """One step's gradients on 2 rows in precision ``kind`` with attention
    ``impl``, the card against the CPU, the same weights: per leaf the
    largest difference as a share of the leaf's largest element, and the
    loss difference."""
    import torch

    from devt_tpu_torch.models.layers import DropoutRng
    from devt_tpu_torch.registry import build_model
    from devt_tpu_torch.train.steps import forward_and_loss

    cfg = _ptn_config(precision=kind, attention_impl=impl)
    small = _ptn_batch(2, SEED + 9)

    def grads(m, batch):
        params = dict(m.named_parameters())
        loss, _, _ = forward_and_loss(m, cfg, {"params": params}, batch,
                                      DropoutRng(0), train=True)
        return loss.item(), dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))

    cpu_loss, cpu = grads(build_model(cfg, torch.Generator().manual_seed(
        SEED)), {k: v.cpu() for k, v in small.items()})
    model = build_model(cfg, torch.Generator().manual_seed(SEED)).cuda()
    card_loss, card = grads(model, small)
    gaps = {}
    for name, want in cpu.items():
        got, want = card[name].cpu().float(), want.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"train-ptn: non-finite gradient of {name}")
        gaps[name] = (got - want).abs().max().item() / max(
            want.abs().max().item(), GRAD_FLOOR)
    return gaps, abs(card_loss - cpu_loss)


def _ptn_grad_check() -> str:
    """The card's PTN step against the CPU's plain kernel path
    (``attention_impl="pallas"``), per leaf.  f32: within PTN_GRAD_RTOL of
    each leaf's largest element.  bf16: the two machines' products round
    apart and a ReLU input near zero lands on either side, which moves a
    last-layer FFN gradient of 2 rows by up to half its largest element;
    the same step without the attention kernels (``"xla"``) shows the same
    gap, so the worst leaf with the kernels must be within phase 7's bound
    (GRAD_RTOL) of the worst leaf without them."""
    gaps, dloss = _ptn_grad_gaps("f32", "pallas")
    leaf = max(gaps, key=gaps.get)
    if not gaps[leaf] <= PTN_GRAD_RTOL or dloss > 1e-4:
        raise AssertionError(
            f"train-ptn: card vs CPU f32 gradients differ by "
            f"{gaps[leaf]:.3e} of the leaf's largest element at {leaf} "
            f"(bound {PTN_GRAD_RTOL}); loss by {dloss:.3e}")
    text = (f"card vs CPU gradients of one step on 2 rows, worst leaf as a "
            f"share of its largest element: f32 {gaps[leaf]:.3e} at {leaf} "
            f"(bound {PTN_GRAD_RTOL})")
    (kern, kloss), (lib, _) = (_ptn_grad_gaps("bf16", impl)
                               for impl in ("pallas", "xla"))
    kleaf, lleaf = max(kern, key=kern.get), max(lib, key=lib.get)
    attn = max((k for k in kern if "self_attn" in k), key=kern.get)
    if not kern[kleaf] <= lib[lleaf] + GRAD_RTOL or kloss > SCORE_ATOL:
        raise AssertionError(
            f"train-ptn: card vs CPU bf16 gradients differ by "
            f"{kern[kleaf]:.3e} at {kleaf} with the kernels, {lib[lleaf]:.3e} "
            f"at {lleaf} without them (bound: that + {GRAD_RTOL}); loss by "
            f"{kloss:.3e}")
    return (text + f"; bf16 {kern[kleaf]:.3e} at {kleaf} with the kernels "
            f"against {lib[lleaf]:.3e} at {lleaf} without them (bound: that "
            f"+ {GRAD_RTOL}), attention leaves {kern[attn]:.3e} at {attn}")


def phase_train_ptn() -> dict:
    import torch

    from devt_tpu_torch.ops.flash_attention import fused_mha
    from devt_tpu_torch.parallel.train_step import (make_eval_step,
                                                    make_multi_step,
                                                    make_train_step)
    from devt_tpu_torch.registry import build_model
    from devt_tpu_torch.train.optimizers import build_optimizer
    from devt_tpu_torch.train.state import TrainState

    grad_text = _ptn_grad_check()
    per_step = len(PTN_EXPERTS) * PTN_LAYERS     # attention calls a step
    batch = _ptn_batch(PTN_TRAIN_BATCH, SEED + 10)
    stacked = {k: v[None].expand(MULTI_STEPS, *v.shape)
               for k, v in batch.items()}
    out: dict = {"fwd_launches": 0, "bwd_launches": 0, "k4_packed": 0}
    for rate in (0.0, PTN_DROPOUT):
        cfg = _ptn_config(dropout=rate)
        model = build_model(cfg, torch.Generator().manual_seed(SEED)).cuda()
        state = TrainState.create(dict(model.named_parameters()),
                                  build_optimizer(cfg))
        step = make_train_step(model, cfg)
        multi = make_multi_step(model, cfg, MULTI_STEPS)
        evaluate = make_eval_step(model, cfg)
        loss_before = evaluate(state, batch)[0].item()

        _zero_counts()
        state, first = step(state, batch, SEED)
        state, metrics = multi(state, stacked, SEED)
        torch.cuda.synchronize()
        counts = (fused_mha.launches, fused_mha.bwd_launches)
        steps = 1 + MULTI_STEPS
        # kernel 3 on the packed body without dropout, streamed with it;
        # kernel 4 on the packed body at both
        body = "k3_packed" if rate == 0.0 else "k3_streamed"
        if counts != (per_step * steps,) * 2 \
                or _body_counts()[body] != counts[0] \
                or _body_counts()["k4_packed"] != counts[1]:
            raise AssertionError(
                f"train-ptn dropout {rate}: {counts[0]} forward and "
                f"{counts[1]} backward attention launches in {steps} steps, "
                f"by body {_body_counts()}, expected {per_step} of each per "
                f"step, every forward on the {body[3:]} body and every "
                f"backward on the packed body")
        out["fwd_launches"] += counts[0]
        out["bwd_launches"] += counts[1]
        out["k4_packed"] += _body_counts()["k4_packed"]
        loss_after = evaluate(state, batch)[0].item()
        losses = (first["loss"].item(), metrics["loss"].item(), loss_after)
        if not all(map(math.isfinite, losses)) or state.step != steps or (
                rate == 0.0 and not loss_after < loss_before):
            raise AssertionError(f"train-ptn dropout {rate}: loss "
                                 f"{loss_before:.5f} before, {losses} during "
                                 f"and after {state.step} steps")

        # throughput: best of 3 windows of multi-step calls, host clock
        multi(state, stacked, SEED)[1]["loss"].item()
        windows, enqueue = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(TRAIN_ITERS):
                state, metrics = multi(state, stacked, SEED)
            enqueue.append(time.perf_counter() - t0)
            metrics["loss"].item()
            windows.append(time.perf_counter() - t0)
        n_steps = TRAIN_ITERS * MULTI_STEPS
        best = min(windows)
        step_ms = best / n_steps * 1e3
        host_ms = enqueue[windows.index(best)] / n_steps * 1e3
        samples_per_s = PTN_TRAIN_BATCH * n_steps / best
        rows, busy, wall_ms = _traced(lambda: step(state, batch, SEED))
        _print_profile(f"PTN train step, dropout {rate}, B={PTN_TRAIN_BATCH}",
                       rows, busy, wall_ms, top=12)
        device_ms = sum(ms for _, ms, _ in rows)
        k3_ms = sum(ms for name, ms, _ in rows
                    if name.startswith(("attention_bf16<256, true",
                                        "mha_fwd_packed")))
        k4_ms = sum(ms for name, ms, _ in rows
                    if name.startswith(("mha_bwd_delta", "mha_bwd_bf16",
                                        "mha_bwd_packed")))
        print(f"[profile]   device total {device_ms:.3f} ms per step: "
              f"attention forward (kernel 3) {k3_ms:.3f}, attention "
              f"backward (kernel 4) {k4_ms:.3f}, everything else "
              f"{device_ms - k3_ms - k4_ms:.3f} "
              f"({sum(n for _, _, n in rows):.0f} launches)")
        tag = "bench.py:453" if rate == 0.0 else "bench.py:473"
        extra = f"; {grad_text}" if rate == 0.0 else ""
        print(f"[train-ptn] PTN bf16 AdamW B={PTN_TRAIN_BATCH} ({tag}) "
              f"dropout {rate}: {steps} steps (1 + make_multi_step("
              f"{MULTI_STEPS})), attention launches {counts[0]} forward (on "
              f"kernel 3's {body[3:]} body) + {counts[1]} backward (on "
              f"kernel 4's packed body; {per_step} of each per step); loss on "
              f"the fixed batch {loss_before:.5f} -> {loss_after:.5f}{extra} "
              f"| {samples_per_s:.2f} samples/s, step_ms={step_ms:.3f}, of "
              f"which the host needs {host_ms:.3f} ms to enqueue a step; "
              f"device {device_ms:.3f} ms a step, busy {busy:.1%} (best of 3 "
              f"windows of {n_steps} steps, host clock; windows "
              f"{', '.join(f'{PTN_TRAIN_BATCH * n_steps / w:.1f}' for w in windows)})",
              flush=True)
        out[rate] = {"samples_per_s": samples_per_s, "step_ms": step_ms,
                     "host_ms": host_ms, "device_ms": device_ms,
                     "busy": busy}
        del model, state, step, multi, evaluate

    # ptn_shared: one step at dropout 0.5
    cfg = _ptn_config(model="ptn_shared", dropout=PTN_DROPOUT)
    model = build_model(cfg, torch.Generator().manual_seed(SEED)).cuda()
    state = TrainState.create(dict(model.named_parameters()),
                              build_optimizer(cfg))
    _zero_counts()
    state, metrics = make_train_step(model, cfg)(state, batch, SEED)
    loss = metrics["loss"].item()
    counts = (fused_mha.launches, fused_mha.bwd_launches)
    shared = (len(PTN_EXPERTS) + 1) * PTN_LAYERS
    if counts != (shared, shared) or not math.isfinite(loss) \
            or fused_mha.streamed_launches != shared \
            or fused_mha.bwd_packed_launches != shared:
        raise AssertionError(f"train-ptn ptn_shared: launches {counts}, "
                             f"expected {shared} of each; loss {loss}")
    out["fwd_launches"] += counts[0]
    out["bwd_launches"] += counts[1]
    out["k4_packed"] += fused_mha.bwd_packed_launches
    print(f"[train-ptn] ptn_shared bf16 dropout {PTN_DROPOUT}: one step, "
          f"attention launches {counts[0]} forward + {counts[1]} backward "
          f"(on kernel 4's packed body), loss {loss:.5f}", flush=True)
    return out


def _half_bounds(itemsize: int, kind: str):
    """Least times of kernels 7 and 8 at the main-path shape.  Forward per
    row: the qkv product (3 D^2 multiply-adds), the scores and the
    probabilities times v over the live keys (2 kv_len D) and the
    out-projection (D^2); bytes: x read, u and the residual lanes written,
    the weights read.  Backward per row: the qkv recompute, datt, da and
    the two weight gradients (11 D^2) and six S x S products per head over
    the live keys (6 kv_len D); bytes: x, du and res read, dx written, the
    weights read and their gradients written."""
    rows = B * S
    weights = 4 * D * D * itemsize + 3 * D * 4
    fwd = _bound({kind: 2 * rows * (4 * D * D + 2 * KV_LEN * D)},
                 2 * rows * D * itemsize + rows * 8 * 4 + weights)
    bwd = _bound({kind: 2 * rows * (11 * D * D + 6 * KV_LEN * D)},
                 3 * rows * D * itemsize + rows * 8 * 4 + 2 * weights)
    return fwd, bwd


def _composed_half(x, params):
    """The attention half composed of library calls (F.layer_norm,
    F.linear, F.scaled_dot_product_attention over the live keys, F.linear
    and the residual) on the same input and weights, in x's dtype: no
    single PyTorch call computes it.  Returns (forward, the leaves)."""
    import torch
    import torch.nn.functional as F

    dt = x.dtype
    g1, b1, bo = (params[k][0].to(dt).detach().requires_grad_(True)
                  for k in ("g1", "b1", "bo"))
    wqkv = params["wqkv"].t().contiguous().requires_grad_(True)
    wo = params["wo"].t().contiguous().requires_grad_(True)
    d = D // HEADS

    def fwd(xin):
        a = F.layer_norm(xin, (D,), g1, b1, 1e-5)
        q, k, v = F.linear(a, wqkv).view(B, S, 3, HEADS, d) \
            .permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k[:, :, :KV_LEN],
                                           v[:, :, :KV_LEN], scale=d ** -0.5)
        return xin + F.linear(o.transpose(1, 2).reshape(B, S, D), wo, bo)

    return fwd, (g1, b1, wqkv, wo, bo)


def phase_kernel_attn_half(kind: str) -> tuple[dict, dict]:
    """Kernels 7 and 8 at the MoE block's main-path shape against their
    plain versions; their times beside the plain versions', the bound and
    the attention half composed of library calls."""
    import torch

    from devt_tpu_torch.ops import fused_block as fb

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[kind]
    gen = torch.Generator().manual_seed(SEED + 20)
    x, full = _block_inputs(dtype, gen)
    params = {k: full[k] for k in fb.HALF_NAMES}
    du = torch.randn(B, S, D, generator=gen).to(dtype).cuda()
    scale = (D // HEADS) ** -0.5
    slow = kind == "f32"
    tag = f"attn-half {kind} ({B},{S},{D})"
    with torch.no_grad():
        before = _body_counts()
        u, res = fb.fused_attn_half(x, params, HEADS, scale, KV_LEN)
        body = {k: n - before[k] for k, n in _body_counts().items()}
        want_wgmma = fb.attn_half_on_wgmma(dtype, D // HEADS, KV_LEN)
        if body != {**dict.fromkeys(body, 0), "k7_wgmma": int(want_wgmma),
                    "k7_streamed": int(not want_wgmma)}:
            raise AssertionError(f"{tag}: kernel 7 launches by body {body}")
        want_u, want_res = fb.fused_attn_half_fwd_plain(x, params, HEADS,
                                                        scale, KV_LEN)
        torch.cuda.synchronize()
        _check_close(f"{tag} u", u, want_u, *TOL[kind])
        _check_close(f"{tag} res", res, want_res, *TOL[kind])
        if res[..., HEADS + 2:].abs().max().item() != 0.0:
            raise AssertionError(f"{tag}: residual lanes past heads+2 "
                                 f"must be 0")
        fwd_err = max(_max_err(u, want_u), _max_err(res, want_res))
        del want_u, want_res
        run_bwd = lambda: fb._half_bwd_cuda(x, params, res, du, HEADS,  # noqa: E731
                                            scale, KV_LEN)
        before = _body_counts()
        got = run_bwd()
        body = {k: n - before[k] for k, n in _body_counts().items()}
        want_bwd = fb.block_bwd_on_wgmma(dtype, D // HEADS, KV_LEN)
        if body != {**dict.fromkeys(body, 0), "k8_wgmma": int(want_bwd),
                    "k8_streamed": int(not want_bwd)}:
            raise AssertionError(f"{tag}: kernel 8 launches by body {body}")
        want = fb.fused_attn_half_bwd_plain(x, params, res, du, HEADS, scale,
                                            KV_LEN)
        torch.cuda.synchronize()
        bwd_err, bwd_rel = _check_bwd(kind, f"{tag} bwd", got, want,
                                      fb.HALF_NAMES)
        again = run_bwd()
        torch.cuda.synchronize()
        same_bits = torch.equal(got[0], again[0]) and all(
            torch.equal(got[1][k], again[1][k]) for k in fb.HALF_NAMES)
        if not same_bits:
            raise AssertionError(f"{tag} bwd: two runs differ in their bits")
        del want, again

        run_fwd = lambda: fb.fused_attn_half(x, params, HEADS, scale,  # noqa: E731
                                             KV_LEN)
        # the kernels by CUDA graph replay, as their yardstick below; the
        # plain versions by events around eager calls
        fwd_ms = _graph_ms(run_fwd, n=5 if slow else 20)
        bwd_ms = _graph_ms(run_bwd, n=5 if slow else 20)
        fwd_plain_ms = _time_ms(
            lambda: fb.fused_attn_half_fwd_plain(x, params, HEADS, scale,
                                                 KV_LEN), iters=3, warmup=1)
        bwd_plain_ms = _time_ms(
            lambda: fb.fused_attn_half_bwd_plain(x, params, res, du, HEADS,
                                                 scale, KV_LEN),
            iters=2, warmup=1)
        if not slow:
            # kernel 7's three launches apart (the fullest of three
            # readings: the profiler drops events now and then)
            _print_profile(f"fused_attn_half forward {kind}",
                           *_traced(run_fwd), top=4)
            prof = _device_profile(run_bwd)
            _print_profile(f"fused_attn_half backward {kind}", *prof, top=8)
            _check_bwd_attention("fused_attn_half backward", prof[0])
            # the attention backward's launches do kernel 2's work; the
            # others' work differs from kernel 2's (two weight gradients)
            _print_launch_bounds([r for r in prof[0]
                                  if r[0] in BWD_ATTENTION])

    # the yardstick: the half composed of library calls, forward, and
    # forward + backward less forward through autograd, in CUDA graphs
    compose, leaves = _composed_half(x, params)
    xr = x.clone().requires_grad_(True)
    with torch.no_grad():
        lib_fwd_ms = _graph_ms(lambda: compose(x), n=5)
    lib_fwd_bwd_ms = _graph_ms(
        lambda: torch.autograd.grad(compose(xr), (xr, *leaves), du), n=5)
    lib_bwd_ms = lib_fwd_bwd_ms - lib_fwd_ms

    (fb_ms, fb_by), (bb_ms, bb_by) = _half_bounds(x.element_size(), kind)
    # no single PyTorch call computes the half: library_ms stays null, and
    # the composition's times are printed beside it
    fwd = {"dtype": kind, "max_abs_err": fwd_err, "kernel_ms": fwd_ms,
           "plain_ms": fwd_plain_ms, "library_ms": None,
           "composed_ms": lib_fwd_ms, "bound_ms": fb_ms, "bound_by": fb_by}
    bwd = {"dtype": kind, "max_abs_err": bwd_err, "kernel_ms": bwd_ms,
           "plain_ms": bwd_plain_ms, "library_ms": None,
           "composed_ms": lib_bwd_ms, "bound_ms": bb_ms, "bound_by": bb_by}
    where = ("the wgmma one-shot body (flash_fwd_sm90.cuh, normalising "
             "after P V)" if want_wgmma else "attention_fwd.cuh's body")
    ptxas = (f" | {_ptxas('attn_half', ONE_SHOT)} | "
             f"{_ptxas('attn_half', BLOCK_DQ)} | "
             f"{_ptxas('attn_half', BLOCK_DKV)}" if want_wgmma else "")
    print(f"[kernel-attn-half] fused_attn_half {kind} ({B},{S},{D}) kv_len "
          f"{KV_LEN}: kernel 7's attention launch on {where}; "
          f"kernel 7 u and res against the plain version, max abs "
          f"err {fwd_err:.3e} (atol {TOL[kind][0]} rtol {TOL[kind][1]}); "
          f"kernel 8 dx and 5 grads within "
          f"{BWD_ULPS[kind]} ulps of the largest element, max abs err "
          f"{bwd_err:.3e} ({bwd_rel:.3e} of its tensor's largest element), "
          f"two runs bit-equal: {same_bits} | forward kernel_ms={fwd_ms:.4f} "
          f"plain_ms={fwd_plain_ms:.4f} composed_ms={lib_fwd_ms:.4f} "
          f"bound_ms={fb_ms:.4f} ({fb_by}) | backward kernel_ms="
          f"{bwd_ms:.4f} plain_ms={bwd_plain_ms:.4f} composed_ms="
          f"{lib_bwd_ms:.4f} bound_ms={bb_ms:.4f} ({bb_by}) | kernels and "
          f"composed: device time in CUDA graphs, plain: CUDA events around "
          f"eager calls; composed: the half composed of library calls "
          f"(layer_norm, linear, scaled_dot_product_attention over the live "
          f"keys, linear, residual); backward = forward + backward "
          f"{lib_fwd_bwd_ms:.4f} less forward{ptxas}", flush=True)
    return fwd, bwd


class _Routing:
    """Records the top-1 expert of every token that each MoE call routes
    (the argmax of the router's f32 softmax), by wrapping
    parallel/moe.py:switch_route for the duration of a ``with``."""

    def __enter__(self):
        import torch

        from devt_tpu_torch.parallel import moe

        self.moe, self.real, self.experts = moe, moe.switch_route, []

        def record(x, w_router, *args, **kwargs):
            logits = x.float() @ w_router.float()
            self.experts.append(
                torch.softmax(logits, dim=-1).argmax(dim=-1).cpu())
            return self.real(x, w_router, *args, **kwargs)

        moe.switch_route = record
        return self

    def __exit__(self, *exc):
        self.moe.switch_route = self.real


def _routing_gap(card, cpu, rows: int) -> float:
    """Share of the live tokens of the first ``rows`` sequences whose
    expert differs between two recordings of the same forwards."""
    import torch

    if len(card) != len(cpu):
        raise AssertionError(f"{len(card)} and {len(cpu)} MoE calls")
    differ = total = 0
    for a, b in zip(card, cpu):
        a, b = a[:rows, :KV_LEN], b[:rows, :KV_LEN]
        differ += int((a != b).sum())
        total += a.numel()
    return differ / max(total, 1)


def _kernel_counts() -> dict:
    from devt_tpu_torch.ops import flash_attention as tfa
    from devt_tpu_torch.ops import fused_block as fb
    from devt_tpu_torch.ops import quant as tq

    return {"k1": fb.fused_vit_block.launches,
            "k2": fb.fused_vit_block.bwd_launches,
            "k3": tfa.fused_mha.launches, "k4": tfa.fused_mha.bwd_launches,
            "k5": tq.quant_fused_vit_block.launches,
            "k7": fb.fused_attn_half.launches,
            "k8": fb.fused_attn_half.bwd_launches,
            "k9": tfa.flash_attention.single_launches,
            "k10": tfa.flash_attention.single_bwd_launches,
            "k11": tfa.flash_attention.blocked_launches,
            "k12": tfa.flash_attention.blocked_dq_launches,
            "k13": tfa.flash_attention.blocked_dkv_launches,
            "k14": tfa.ring_step_fwd.launches,
            "k15": tfa.ring_step_bwd.launches}


def _expect(**counts) -> dict:
    """A launch count of every kernel: those named, and 0 for the rest."""
    return {k: counts.get(k, 0) for k in _kernel_counts()}


def _zero_counts() -> None:
    from devt_tpu_torch.ops import flash_attention as tfa
    from devt_tpu_torch.ops import fused_block as fb
    from devt_tpu_torch.ops import quant as tq

    for fn in (fb.fused_vit_block, tfa.fused_mha, fb.fused_attn_half):
        fn.launches = fn.bwd_launches = 0
    mha = tfa.fused_mha
    mha.packed_launches = mha.one_shot_launches = mha.streamed_launches = 0
    mha.bwd_packed_launches = mha.bwd_wgmma_launches = 0
    mha.bwd_streamed_launches = 0
    half = fb.fused_attn_half
    half.wgmma_launches = half.streamed_launches = 0
    block = fb.fused_vit_block
    block.wgmma_launches = block.streamed_launches = 0
    block.bwd_wgmma_launches = block.bwd_streamed_launches = 0
    half.bwd_wgmma_launches = half.bwd_streamed_launches = 0
    quant = tq.quant_fused_vit_block
    quant.launches = quant.wgmma_launches = quant.streamed_launches = 0
    fa = tfa.flash_attention
    fa.single_launches = fa.single_bwd_launches = fa.blocked_launches = 0
    fa.single_wgmma_launches = fa.single_streamed_launches = 0
    fa.single_bwd_wgmma_launches = fa.single_bwd_streamed_launches = 0
    fa.blocked_dq_launches = fa.blocked_dkv_launches = 0
    fa.blocked_dq_wgmma_launches = fa.blocked_dq_streamed_launches = 0
    fa.blocked_dkv_wgmma_launches = fa.blocked_dkv_streamed_launches = 0
    fa.blocked_wgmma_launches = fa.blocked_streamed_launches = 0
    tfa.ring_step_fwd.launches = tfa.ring_step_bwd.launches = 0
    for ring in (tfa.ring_step_fwd, tfa.ring_step_bwd):
        ring.wgmma_launches = ring.streamed_launches = 0
    mm = tq.int8_matmul_fused
    mm.launches = mm.wgmma_launches = mm.mma_sync_launches = 0


def _body_counts() -> dict:
    """Launches by body of the kernels that have more than one: 1 and 5
    (their attention launch on the one-shot body's normalise-after
    instance, or attention_fwd.cuh's), 2 and 8 (their attention backward
    on the recompute and kernels 12's and 13's wgmma bodies, or
    attention_bwd_bf16 / the float route's), 3 (the
    packed wgmma body of csrc/mha_fwd_sm90.cuh, kernel 9's one-shot
    instance, or attention_fwd.cuh's streamed body), 4 (the packed wgmma
    body of csrc/mha_bwd_sm90.cuh, kernels 12's and 13's wgmma bodies, or
    attention_bwd.cuh's streamed one), 9 and 14 (the wgmma
    one-shot body of csrc/flash_fwd_sm90.cuh, or the streamed one of
    csrc/flash_fwd.cuh), 7 (its attention launch on the one-shot body's
    normalise-after instance, or attention_fwd.cuh's), 11 (the wgmma
    online body of csrc/flash_fwd_sm90.cuh, or flash_fwd.cuh's), 12 and
    13 (the wgmma bodies of csrc/flash_bwd_sm90.cuh, or attention_bwd.cuh's
    streamed one), 10 and 15 (both of those wgmma bodies, or the streamed
    one) and 6 (the wgmma product of csrc/gemm_s8_sm90.cuh, or
    int8_common.cuh's mma.sync one)."""
    from devt_tpu_torch.ops import flash_attention as tfa
    from devt_tpu_torch.ops import fused_block as fb
    from devt_tpu_torch.ops import quant as tq

    fa, ring, mha = tfa.flash_attention, tfa.ring_step_fwd, tfa.fused_mha
    mm, half = tq.int8_matmul_fused, fb.fused_attn_half
    block, quant = fb.fused_vit_block, tq.quant_fused_vit_block
    return {"k1_wgmma": block.wgmma_launches,
            "k1_streamed": block.streamed_launches,
            "k2_wgmma": block.bwd_wgmma_launches,
            "k2_streamed": block.bwd_streamed_launches,
            "k5_wgmma": quant.wgmma_launches,
            "k5_streamed": quant.streamed_launches,
            "k8_wgmma": half.bwd_wgmma_launches,
            "k8_streamed": half.bwd_streamed_launches,
            "k3_packed": mha.packed_launches,
            "k3_one_shot": mha.one_shot_launches,
            "k3_streamed": mha.streamed_launches,
            "k4_packed": mha.bwd_packed_launches,
            "k4_wgmma": mha.bwd_wgmma_launches,
            "k4_streamed": mha.bwd_streamed_launches,
            "k7_wgmma": half.wgmma_launches,
            "k7_streamed": half.streamed_launches,
            "k9_wgmma": fa.single_wgmma_launches,
            "k9_streamed": fa.single_streamed_launches,
            "k10_wgmma": fa.single_bwd_wgmma_launches,
            "k10_streamed": fa.single_bwd_streamed_launches,
            "k11_wgmma": fa.blocked_wgmma_launches,
            "k11_streamed": fa.blocked_streamed_launches,
            "k12_wgmma": fa.blocked_dq_wgmma_launches,
            "k12_streamed": fa.blocked_dq_streamed_launches,
            "k13_wgmma": fa.blocked_dkv_wgmma_launches,
            "k13_streamed": fa.blocked_dkv_streamed_launches,
            "k14_wgmma": ring.wgmma_launches,
            "k14_streamed": ring.streamed_launches,
            "k15_wgmma": tfa.ring_step_bwd.wgmma_launches,
            "k15_streamed": tfa.ring_step_bwd.streamed_launches,
            "k6_wgmma": mm.wgmma_launches,
            "k6_mma_sync": mm.mma_sync_launches}


# the wgmma bodies as ptxas names them, with their template arguments
# (the one-shot body's last: normalise after P V, kernel 7's instances)
ONE_SHOT = "flash_one_shot<d, width, mask, norm_after>"
WGMMA_BODIES = {
    ONE_SHOT: r"flash_one_shotILi(\d+)ELi(\d+)ELb(\d)ELb(\d)E",
    "flash_fwd_wgmma<d>": r"flash_fwd_wgmmaILi(\d+)E",
    "flash_bwd_dq_wgmma<d, ring>": r"flash_bwd_dq_wgmmaILi(\d+)ELb(\d)E",
    "flash_bwd_dkv_wgmma<d, ring>": r"flash_bwd_dkv_wgmmaILi(\d+)ELb(\d)E",
    "mha_fwd_packed<d>": r"mha_fwd_packedILi(\d+)E",
    # kernel 4's bodies (csrc/mha_bwd_sm90.cuh): packed, and kernels 12's
    # and 13's bodies with kBwdMha; the last argument is the dropout
    "mha_bwd_packed<d, drop>": r"mha_bwd_packedILi(\d+)ELb(\d)E",
    "mha_bwd_dq_sm90<d, drop>": r"mha_bwd_dq_sm90ILi(\d+)ELb(\d)E",
    "mha_bwd_dkv_sm90<d, drop>": r"mha_bwd_dkv_sm90ILi(\d+)ELb(\d)E",
    "gemm_s8_wgmma<out>": r"gemm_s8_wgmmaI(\w+?)EEv",
    # csrc/block_sm90.cuh: the fused block's products (kernels 1, 2, 7, 8)
    "ln_qkv_sm90<D, stored>": r"ln_qkv_sm90ILi(\d+)ELb(\d)E",
    "out_ffn_sm90<D>": r"out_ffn_sm90ILi(\d+)E",
    "ffn_dual_sm90<D>": r"ffn_dual_sm90ILi(\d+)E",
    "row_nk_sm90<D, mode>": r"row_nk_sm90ILi(\d+)ELi(\d+)E",
    "wgrad_sm90<BN>": r"wgrad_sm90ILi(\d+)E",
    # kernel 5's row tiles on int8 and bf16 wgmma (csrc/quant_block_fwd.cu)
    "ln_qkv_q8_sm90<D>": r"ln_qkv_q8_sm90ILi(\d+)E",
    "out_ffn_q8_sm90<D>": r"out_ffn_q8_sm90ILi(\d+)E",
    # kernels 2's and 8's attention backward (csrc/flash_bwd_sm90.cuh)
    "block_bwd_pre_sm90<d, width>": r"block_bwd_pre_sm90ILi(\d+)ELi(\d+)E",
    "block_bwd_dq_sm90<d>": r"block_bwd_dq_sm90ILi(\d+)E",
    "block_bwd_dkv_sm90<d>": r"block_bwd_dkv_sm90ILi(\d+)E",
}
BLOCK_PRE, BLOCK_DQ, BLOCK_DKV = ("block_bwd_pre_sm90<d, width>",
                                  "block_bwd_dq_sm90<d>",
                                  "block_bwd_dkv_sm90<d>")


# registers of the wgmma instances that kernel 3's and 15's moves left as
# they were (ptxas on an NVIDIA H100's toolkit, before the kRing option):
# kernel 9's one-shot instances, and kernels 12's and 13's (10's) bodies
_DQ, _DKV = "flash_bwd_dq_wgmma<d, ring>", "flash_bwd_dkv_wgmma<d, ring>"
KEPT_REGS = {
    ("flash_fwd", ONE_SHOT): {"64,208,0,0": 141},
    ("ring_step", ONE_SHOT): {"64,208,1,0": 166},
    ("attn_half", ONE_SHOT): {"64,208,0,1": 146},
    # kernel 1's attention: the same instance as kernel 7's
    ("fused_block_fwd", ONE_SHOT): {"64,208,0,1": 146},
    **{(stem, _DQ): {"64,0": 123, "32,0": 107, "16,0": 98}
       for stem in ("flash_bwd", "ring_step")},
    **{(stem, _DKV): {"64,0": 168, "32,0": 152, "16,0": 130}
       for stem in ("flash_bwd", "ring_step")},
}


def _ptxas(stem: str, body: str) -> str:
    """ptxas' registers and spill bytes of each instance of the wgmma body
    ``body`` (a key of WGMMA_BODIES) in csrc/<stem>.cu, how many wgmma
    serialisation notes the build gave (C7511, C7512: for registers;
    C7515: a wgmma in flight across a loop's back edge), and whether the
    instances of KEPT_REGS kept their registers, from the build log
    (-Xptxas -v)."""
    import re

    from devt_tpu_torch.ops import _build

    log = _build.build_all()[stem].with_suffix(".log").read_text()
    rows, name, spill = [], None, "?"
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            name = re.search(WGMMA_BODIES[body], found.group(1))
            continue
        if name is None:
            continue
        found = re.search(r"(\d+) bytes spill stores", line)
        if found:
            spill = found.group(1)
        found = re.search(r"Used (\d+) registers", line)
        if found:
            args = ",".join(name.groups())
            kept = KEPT_REGS.get((stem, body), {}).get(args)
            rows.append(f"<{args}> {found.group(1)} regs {spill} spill bytes"
                        + ("" if kept is None else
                           " (unchanged)" if int(found.group(1)) == kept else
                           f" (CHANGED from {kept})"))
            name = None
    return (f"ptxas {body}: {'; '.join(rows)}; wgmma notes in {stem}.cu: "
            f"C7511 {log.count('C7511')}, C7512 {log.count('C7512')}, C7515 "
            f"{log.count('C7515')}")


def _vivit_cfg(**kw):
    from devt_tpu_torch.config import Config

    base = dict(model="vivit", batch_size=TRAIN_BATCH, frame_len=16,
                n_classes=19, opt="adamW", learning_rate=1e-4,
                precision="bf16", accum_steps=1)
    return Config(**{**base, **kw})


def _moe_config(**kw):
    return _vivit_cfg(**{"moe_experts": MOE_EXPERTS, "moe_every": MOE_EVERY,
                         **kw})


def phase_serve_moe() -> dict:
    """MoE-ViViT behind Predictor: bf16 and int8 launches per bucket call,
    scores and expert choices against the same model on the CPU (bf16, and
    f32 where the choices must agree), clips/s."""
    import numpy as np
    import torch

    from devt_tpu_torch.registry import build_model
    from devt_tpu_torch.serve import Predictor

    cfg = _moe_config()
    weights = build_model(cfg, torch.Generator().manual_seed(SEED)) \
        .state_dict()
    clips = np.random.default_rng(SEED).integers(
        0, 256, (37, cfg.frame_len, 224, 224, 3), dtype=np.uint8)
    pred = Predictor(cfg, weights, buckets=(1, 8, 32))
    n_moe = len(pred.model.space_transformer.blocks) // MOE_EVERY
    n_dense = len(pred.model.space_transformer.blocks) - n_moe

    bucket_calls = 2                       # 37 clips = bucket 32 + bucket 8
    _zero_counts()
    out = pred.predict({"vid": clips})
    counts, body = _kernel_counts(), _body_counts()
    expect = _expect(k1=n_dense * bucket_calls, k7=n_moe * bucket_calls)
    if counts != expect or body["k7_wgmma"] != expect["k7"] \
            or body["k7_streamed"]:
        raise AssertionError(f"serve-moe: launches {counts}, by body "
                             f"{body}, expected {expect}, every launch of "
                             f"kernel 7 on the wgmma body")
    scores = out["scores"]
    if scores.shape != (37, cfg.n_classes) or not np.isfinite(scores).all() \
            or scores.min() < 0.0 or scores.max() > 1.0:
        raise AssertionError(f"serve-moe: bad scores: shape {scores.shape}, "
                             f"range [{scores.min()}, {scores.max()}]")

    # the first 2 clips on the card and on the CPU, with their routing
    rows = 2 * cfg.frame_len
    cpu = Predictor(cfg, weights, buckets=(2,), device="cpu")
    with _Routing() as on_card:
        card2 = pred.predict({"vid": clips[:2]})["scores"]
    with _Routing() as on_cpu:
        ref = cpu.predict({"vid": clips[:2]})["scores"]
    score_err = float(np.abs(card2 - ref).max())
    bf16_gap = _routing_gap(on_card.experts, on_cpu.experts, rows)
    if not score_err <= SCORE_ATOL:
        raise AssertionError(f"serve-moe: card vs CPU scores differ by "
                             f"{score_err:.3e} > {SCORE_ATOL}")
    # in f32 the two machines must route every live token alike
    cfg32 = _moe_config(precision="f32")
    pred32 = Predictor(cfg32, weights, buckets=(2,))
    cpu32 = Predictor(cfg32, weights, buckets=(2,), device="cpu")
    with _Routing() as on_card32:
        s32 = pred32.predict({"vid": clips[:2]})["scores"]
    with _Routing() as on_cpu32:
        r32 = cpu32.predict({"vid": clips[:2]})["scores"]
    f32_gap = _routing_gap(on_card32.experts, on_cpu32.experts, rows)
    f32_err = float(np.abs(s32 - r32).max())
    if f32_gap != 0.0 or not f32_err <= TOL["f32"][0]:
        raise AssertionError(f"serve-moe f32: {f32_gap:.3e} of the live "
                             f"tokens routed apart, scores differ by "
                             f"{f32_err:.3e}")
    del pred32, cpu32, cpu

    batch = {"vid": clips[:32]}
    pred.predict(batch)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        pred.predict(batch)
    clips_per_s = 32 * reps / (time.perf_counter() - t0)
    _print_profile("MoE predict, bucket 32", *_traced(
        lambda: pred.predict(batch)), top=12)

    # int8: the dense blocks on kernel 5, the MoE blocks keep kernel 7
    qpred = Predictor(cfg, weights, buckets=(1, 8, 32), quantize=True)
    _zero_counts()
    qpred.predict(batch)
    qcounts, qbody = _kernel_counts(), _body_counts()
    qexpect = dict(expect, k1=0, k5=n_dense, k7=n_moe)
    if qcounts != qexpect or qbody["k7_wgmma"] != n_moe \
            or qbody["k7_streamed"]:
        raise AssertionError(f"serve-moe int8: launches {qcounts} in one "
                             f"bucket call, by body {qbody}, expected "
                             f"{qexpect}, kernel 7's on the wgmma body")
    qpred.predict(batch)
    t0 = time.perf_counter()
    for _ in range(reps):
        qscores = qpred.predict(batch)["scores"]
    q_clips_per_s = 32 * reps / (time.perf_counter() - t0)
    agree, q_err = _agreement(scores[:32], qscores)
    if not np.isfinite(qscores).all() or not q_err <= INT8_VS_BF16_MAX_ERR:
        raise AssertionError(f"serve-moe int8: scores differ from bf16 by "
                             f"{q_err:.3e} (limit {INT8_VS_BF16_MAX_ERR})")
    print(f"[serve-moe] MoE-ViViT (E={MOE_EXPERTS}, moe_every={MOE_EVERY}) "
          f"bf16 Predictor(buckets=(1, 8, 32)) on 37 u8 clips: launches "
          f"{counts['k1']} of kernel 1 and {counts['k7']} of kernel 7 "
          f"({n_dense} and {n_moe} per bucket call x {bucket_calls}; "
          f"{body['k7_wgmma']} of kernel 7 on the wgmma body), none "
          f"of kernels 3 or 8; card vs CPU on 2 clips: max abs score err "
          f"{score_err:.3e} (atol {SCORE_ATOL}), {bf16_gap:.4%} of the live "
          f"tokens routed to another expert in bf16; in f32 {f32_gap:.4%} "
          f"and max abs score err {f32_err:.3e} | {clips_per_s:.2f} clips/s "
          f"at bucket 32 | quantize=True: {qcounts['k5']} launches of kernel "
          f"5 and {qcounts['k7']} of kernel 7 per bucket call, against bf16 "
          f"label agreement {agree:.4f}, max score err {q_err:.3e} (limit "
          f"{INT8_VS_BF16_MAX_ERR}), {q_clips_per_s:.2f} clips/s (host clock, "
          f"u8 upload included)", flush=True)
    return {"counts": counts, "int8_counts": qcounts,
            "clips_per_s": clips_per_s, "int8_clips_per_s": q_clips_per_s}


def _moe_grad_check() -> str:
    """One f32 step's gradients on 2 clips, the card against the CPU's
    plain path, with the routing of both recorded; and the aux term's
    share of the loss."""
    import torch

    from devt_tpu_torch.models.layers import DropoutRng
    from devt_tpu_torch.registry import build_model
    from devt_tpu_torch.train.steps import forward_and_loss

    cfg = _moe_config(precision="f32")
    small = _train_batch(2, SEED + 3)
    small["vid"] = small["vid"].float()

    def grads(model, batch, config=cfg):
        params = dict(model.named_parameters())
        loss, aux, _ = forward_and_loss(model, config, {"params": params},
                                        batch, DropoutRng(0), train=True)
        return loss, aux, dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))

    card_model = build_model(cfg, torch.Generator().manual_seed(SEED)).cuda()
    with _Routing() as on_card:
        card_loss, card_aux, card = grads(card_model, small)
    with _Routing() as on_cpu:
        cpu_loss, cpu_aux, cpu = grads(
            build_model(cfg, torch.Generator().manual_seed(SEED)),
            {k: v.cpu() for k, v in small.items()})
    gap = _routing_gap(on_card.experts, on_cpu.experts, 2 * 16)
    worst, worst_leaf = 0.0, ""
    for name, want in cpu.items():
        got = card[name].cpu()
        if not torch.isfinite(got).all():
            raise AssertionError(f"train-moe: non-finite gradient of {name}")
        ratio = (got - want).abs().max().item() / max(
            want.abs().max().item(), GRAD_FLOOR)
        if ratio > worst:
            worst, worst_leaf = ratio, name
    # the load-balance term is in the loss: the same step without it
    plain_loss, _, _ = grads(card_model, small,
                             _moe_config(precision="f32", moe_aux_weight=0.0))
    in_loss = card_loss.item() - plain_loss.item()
    want_in = cfg.moe_aux_weight * card_aux["moe_aux"].item()
    if gap != 0.0 or not worst <= PTN_GRAD_RTOL \
            or abs(in_loss - want_in) > 1e-5 \
            or abs(card_aux["moe_aux"].item() - cpu_aux["moe_aux"].item()) \
            > 1e-5:
        raise AssertionError(
            f"train-moe f32 on 2 clips: {gap:.3e} of the live tokens routed "
            f"apart; worst gradient {worst:.3e} of the leaf's largest "
            f"element at {worst_leaf} (bound {PTN_GRAD_RTOL}); aux in the "
            f"loss {in_loss:.6f} against {want_in:.6f}; moe_aux "
            f"{card_aux['moe_aux'].item():.6f} vs "
            f"{cpu_aux['moe_aux'].item():.6f}")
    return (f"one f32 step on 2 clips, card vs CPU: the same expert for "
            f"every live token, worst gradient {worst:.3e} of the leaf's "
            f"largest element at {worst_leaf} (bound {PTN_GRAD_RTOL}), loss "
            f"{card_loss.item():.5f} vs {cpu_loss.item():.5f}, moe_aux "
            f"{card_aux['moe_aux'].item():.5f} of which "
            f"{cfg.moe_aux_weight} x is in the loss ({in_loss:.6f})")


def phase_train_moe() -> dict:
    import torch

    from devt_tpu_torch.models.vivit import ViViT
    from devt_tpu_torch.parallel.train_step import (make_eval_step,
                                                    make_multi_step,
                                                    make_train_step)
    from devt_tpu_torch.registry import build_model
    from devt_tpu_torch.train.optimizers import build_optimizer
    from devt_tpu_torch.train.state import TrainState

    grad_text = _moe_grad_check()
    cfg = _moe_config()
    # bench.py:1188 builds through the registry, which sets no dropout on
    # the ViViT: the MoE blocks train on the fused attention half
    model = build_model(cfg, torch.Generator().manual_seed(SEED)).cuda()
    n_moe = len(model.space_transformer.blocks) // MOE_EVERY
    n_dense = len(model.space_transformer.blocks) - n_moe
    batch = _train_batch(TRAIN_BATCH, SEED + 4)
    stacked = {k: v[None].expand(MULTI_STEPS, *v.shape)
               for k, v in batch.items()}
    state = TrainState.create(dict(model.named_parameters()),
                              build_optimizer(cfg))
    step = make_train_step(model, cfg)
    multi = make_multi_step(model, cfg, MULTI_STEPS)
    evaluate = make_eval_step(model, cfg)
    loss_before = evaluate(state, batch)[0].item()

    _zero_counts()
    state, first = step(state, batch, SEED)
    state, metrics = multi(state, stacked, SEED)
    torch.cuda.synchronize()
    counts, body = _kernel_counts(), _body_counts()
    steps = 1 + MULTI_STEPS
    expect = _expect(k1=n_dense * steps, k2=n_dense * steps,
                     k7=n_moe * steps, k8=n_moe * steps)
    if counts != expect or body["k7_wgmma"] != expect["k7"] \
            or body["k7_streamed"] or body["k2_wgmma"] != expect["k2"] \
            or body["k8_wgmma"] != expect["k8"]:
        raise AssertionError(f"train-moe: launches {counts} in {steps} "
                             f"steps, by body {body}, expected {expect}, "
                             f"every launch of kernel 7 and every attention "
                             f"backward of kernels 2 and 8 on the wgmma "
                             f"bodies")
    loss_after = evaluate(state, batch)[0].item()
    aux = (first["moe_aux"].item(), metrics["moe_aux"].item())
    losses = (first["loss"].item(), metrics["loss"].item(), loss_after)
    if not all(map(math.isfinite, losses + aux)) \
            or not loss_after < loss_before or state.step != steps:
        raise AssertionError(f"train-moe: loss {loss_before:.5f} before, "
                             f"{losses} during and after {state.step} steps; "
                             f"moe_aux {aux}")

    # throughput: best of 3 windows of multi-step calls, host clock
    multi(state, stacked, SEED)[1]["loss"].item()
    windows, enqueue = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(TRAIN_ITERS):
            state, metrics = multi(state, stacked, SEED)
        enqueue.append(time.perf_counter() - t0)
        metrics["loss"].item()
        windows.append(time.perf_counter() - t0)
    n_steps = TRAIN_ITERS * MULTI_STEPS
    best = min(windows)
    step_ms = best / n_steps * 1e3
    host_ms = enqueue[windows.index(best)] / n_steps * 1e3
    clips_per_s = TRAIN_BATCH * n_steps / best
    rows, busy, wall_ms = _traced(lambda: step(state, batch, SEED))
    _print_profile(f"MoE train step, B={TRAIN_BATCH}", rows, busy, wall_ms,
                   top=16)
    device_ms = sum(ms for _, ms, _ in rows)
    ours_ms = sum(ms for name, ms, _ in rows
                  if name.startswith(BLOCK_KERNELS))
    print(f"[profile]   device total {device_ms:.3f} ms per step "
          f"({sum(n for _, _, n in rows):.0f} launches): kernels 1, 2, 7 and "
          f"8 {ours_ms:.3f}, everything else (routing, expert products, "
          f"optimizer, casts: PyTorch's kernels) {device_ms - ours_ms:.3f}")
    print(f"[train-moe] MoE-ViViT bf16 AdamW B={TRAIN_BATCH} (bench.py:1188, "
          f"E={MOE_EXPERTS}, moe_every={MOE_EVERY}, dropout 0): {steps} steps "
          f"(1 + make_multi_step({MULTI_STEPS})), launches {counts} "
          f"({n_dense} of kernels 1 and 2 and {n_moe} of kernels 7 and 8 per "
          f"step; {body['k7_wgmma']} of kernel 7 on the wgmma body); loss "
          f"on the fixed batch {loss_before:.5f} -> "
          f"{loss_after:.5f}, moe_aux {aux[0]:.5f} -> {aux[1]:.5f}; "
          f"{grad_text} | {clips_per_s:.2f} clips/s, step_ms={step_ms:.3f}, "
          f"of which the host needs {host_ms:.3f} ms to enqueue a step; "
          f"device {device_ms:.3f} ms a step, busy {busy:.1%} (best of 3 "
          f"windows of {n_steps} steps, host clock; windows "
          f"{', '.join(f'{TRAIN_BATCH * n_steps / w:.1f}' for w in windows)})",
          flush=True)
    del model, state, step, multi, evaluate

    # dropout 0.5 (the Config default, which the registry does not pass to
    # the ViViT): the MoE blocks' attention runs unfused, on kernels 3 and 4
    drop_model = ViViT(num_classes=19, num_frames=16, channels_last=True,
                       dropout=MOE_DROPOUT, moe_experts=MOE_EXPERTS,
                       moe_every=MOE_EVERY, dtype=torch.bfloat16) \
        .init_weights(torch.Generator().manual_seed(SEED)).cuda()
    drop_state = TrainState.create(dict(drop_model.named_parameters()),
                                   build_optimizer(cfg))
    drop_multi = make_multi_step(drop_model, cfg, DROP_STEPS)
    drop_stacked = {k: v[:DROP_STEPS] for k, v in stacked.items()}
    _zero_counts()
    drop_state, drop_metrics = drop_multi(drop_state, drop_stacked, SEED)
    drop_loss = drop_metrics["loss"].item()
    drop_counts = _kernel_counts()
    drop_expect = _expect(k1=n_dense * DROP_STEPS, k2=n_dense * DROP_STEPS,
                          k3=n_moe * DROP_STEPS, k4=n_moe * DROP_STEPS)
    # kernel 4 at head dim 64 on kernels 12's and 13's wgmma bodies
    k4_wgmma = _body_counts()["k4_wgmma"]
    if drop_counts != drop_expect or not math.isfinite(drop_loss) \
            or not math.isfinite(drop_metrics["moe_aux"].item()) \
            or k4_wgmma != drop_counts["k4"]:
        raise AssertionError(f"train-moe dropout {MOE_DROPOUT}: launches "
                             f"{drop_counts}, expected {drop_expect}, kernel "
                             f"4 by body {_body_counts()}; loss {drop_loss}")
    t0 = time.perf_counter()
    for _ in range(TRAIN_ITERS):
        drop_state, drop_metrics = drop_multi(drop_state, drop_stacked, SEED)
    drop_metrics["loss"].item()
    drop_ms = (time.perf_counter() - t0) / (TRAIN_ITERS * DROP_STEPS) * 1e3
    # a profiled call of DROP_STEPS steps: device ms a step, kernel 4's
    rows, drop_busy, drop_wall = _traced(
        lambda: drop_multi(drop_state, drop_stacked, SEED)[1]["loss"].item())
    _print_profile(f"MoE-ViViT train, dropout {MOE_DROPOUT}, {DROP_STEPS} "
                   f"steps", rows, drop_busy, drop_wall, top=8)
    drop_device_ms = sum(ms for _, ms, _ in rows) / DROP_STEPS
    k4_ms = sum(ms for name, ms, _ in rows
                if name.startswith("mha_bwd_")) / DROP_STEPS
    print(f"[train-moe] the same at dropout {MOE_DROPOUT}: {DROP_STEPS} "
          f"steps, launches {drop_counts} ({n_moe} of kernels 3 and 4 and "
          f"none of 7 and 8 per step; kernel 4's {k4_wgmma} on kernels 12's "
          f"and 13's wgmma bodies), mean loss {drop_loss:.5f} | step_ms="
          f"{drop_ms:.3f}, {TRAIN_BATCH / drop_ms * 1e3:.2f} clips/s (one "
          f"window of {TRAIN_ITERS * DROP_STEPS} steps, host clock); device "
          f"{drop_device_ms:.3f} ms a step, kernel 4 {k4_ms:.3f} of it, busy "
          f"{drop_busy:.1%} (a profiled call)", flush=True)
    return {"counts": counts, "drop_counts": drop_counts,
            "clips_per_s": clips_per_s, "step_ms": step_ms,
            "host_ms": host_ms, "device_ms": device_ms, "busy": busy,
            "drop_step_ms": drop_ms, "drop_device_ms": drop_device_ms,
            "drop_k4_ms": k4_ms, "k4_wgmma": k4_wgmma}


# the split-q/k/v attention's main-path shapes: the int8 ViViT's unfused
# blocks at token_pad=0 (512 sequences x 3 heads, 197 tokens) for kernels 9
# and 10, ViViT at image 384 (577 tokens, padded to 592) for kernel 11
FLASH_SEQS, FLASH_S9, FLASH_S11, FLASH_KV11 = 512, 197, 592, 577
# ViViT at image 384: 24^2 + 1 = 577 space tokens
LONG_IMAGE = 384


def _packed_heads(b, s, heads, d, dtype, seed):
    """q, k, v as the (B, H, S, d) head views of one packed (B, S, 3, H, d)
    tensor on the card, the strided layout packed_mha and the int8 block
    hand to flash_attention."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, s, 3, heads, d, generator=gen).to(dtype).cuda()
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def _flash_bound(kind, bh, sq, skv, d, kv_len, backward=False):
    """Least time of kernel 9 or 11 (two products over the live keys; q, k,
    v read, o and lse written) or kernel 10 (five products; q, k, v, o, do
    and lse read, dq, dk, dv written)."""
    item = 4 if kind == "f32" else 2
    if backward:
        return _bound({kind: 10 * bh * sq * kv_len * d},
                      8 * bh * sq * d * item + 4 * bh * sq)
    return _bound({kind: 4 * bh * sq * kv_len * d},
                  (2 * sq + 2 * skv) * bh * d * item + 4 * bh * sq)


def phase_flash(kind: str, b: int, heads: int, sq: int, skv: int, d: int,
                kv_len: int, timed: bool = True) -> dict:
    """Kernel 9 (Sq == Skv <= 512) or 11 against its plain version: o at
    the forward gate, lse at LSE_TOL in f32 and at kernel 1's forward limit
    in bf16; the kernel's, the plain version's and SDPA's times."""
    import torch
    import torch.nn.functional as F

    from devt_tpu_torch.ops import flash_attention as tfa

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[kind]
    if sq == skv:
        q, k, v = _packed_heads(b, sq, heads, d, dtype, SEED + sq + d)
    else:
        gen = torch.Generator().manual_seed(SEED + sq)
        q = torch.randn(b, heads, sq, d, generator=gen).to(dtype).cuda()
        k, v = (torch.randn(b, heads, skv, d, generator=gen).to(dtype).cuda()
                for _ in range(2))
    single = sq == skv and tfa.fits_single_block(sq)
    name = "kernel 9" if single else "kernel 11"
    plain = tfa.flash_single_fwd_plain if single \
        else tfa.flash_blocked_fwd_plain
    scale = d ** -0.5
    run = lambda: tfa.flash_attention(q, k, v, kv_len=kv_len,  # noqa: E731
                                      return_lse=True)
    tag = f"flash {name} {kind} ({b * heads},{sq},{skv},{d}) kv_len {kv_len}"
    with torch.inference_mode():
        before = _body_counts()
        o, lse = run()
        body = {k: v - before[k] for k, v in _body_counts().items()}
        want_o, want_lse = plain(q, k, v, scale, kv_len)
        torch.cuda.synchronize()
        _check_close(f"{tag} o", o, want_o, *TOL[kind])
        lse_tol = LSE_TOL if kind == "f32" else TOL["bf16"]
        _check_close(f"{tag} lse", lse, want_lse, *lse_tol)
        errs = (_max_err(o, want_o), _max_err(lse, want_lse))
        del want_o, want_lse
        out = {"max_abs_err": max(errs)}
        if timed:
            # device time, every side by CUDA graph replay: a kernel of
            # 0.07 ms takes less time on the card than its wrapper on the
            # host
            out["kernel_ms"] = _graph_ms(run)
            out["plain_ms"] = _graph_ms(
                lambda: plain(q, k, v, scale, kv_len), n=2, replays=2)
            # the library's fused attention on the live keys
            out["library_ms"] = _graph_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k[:, :, :kv_len], v[:, :, :kv_len], scale=scale))
    out["bound_ms"], out["bound_by"] = _flash_bound(kind, b * heads, sq, skv,
                                                    d, kv_len)
    times = (f" | CUDA graph: kernel_ms={out['kernel_ms']:.4f} plain_ms="
             f"{out['plain_ms']:.4f} library_ms={out['library_ms']:.4f} "
             f"(F.scaled_dot_product_attention over the live keys)"
             if timed else "")
    # the body the rules name, and one launch on it
    if single:
        want_wgmma = tfa.one_shot_on_wgmma(dtype, d, kv_len)
        key = "k9"
        ptxas_body = ONE_SHOT if want_wgmma else None
    else:
        want_wgmma = tfa.online_on_wgmma(dtype, d)
        key = "k11"
        ptxas_body = "flash_fwd_wgmma<d>" if want_wgmma else None
    if body != {**dict.fromkeys(body, 0), f"{key}_wgmma": int(want_wgmma),
                f"{key}_streamed": int(not want_wgmma)}:
        raise AssertionError(f"{tag}: launches by body {body}")
    where = (("wgmma one-shot body" if single else "wgmma online body")
             + " (flash_fwd_sm90.cuh)" if want_wgmma else
             ("streamed one-shot body" if single else "streamed online body")
             + " (flash_fwd.cuh)")
    print(f"[kernel-flash] {tag}{' (head views of a packed qkv)' if sq == skv else ''}: "
          f"{where}; max_abs_err o={errs[0]:.3e} (atol {TOL[kind][0]}, rtol "
          f"{TOL[kind][1]}) lse={errs[1]:.3e} (atol {lse_tol[0]}, rtol "
          f"{lse_tol[1]}){times} bound_ms={out['bound_ms']:.4f} "
          f"({out['bound_by']})"
          + (f" | {_ptxas('flash_fwd', ptxas_body)}" if ptxas_body and timed
             else ""),
          flush=True)
    return out


def _sdpa_bwd_ms(q, k, v, do, kv_len, scale) -> tuple[float, float]:
    """Device time of F.scaled_dot_product_attention's backward on the live
    keys (CUDA graph): forward + backward through autograd less forward."""
    import torch
    import torch.nn.functional as F

    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(
            qs, ks[:, :, :kv_len], vs[:, :, :kv_len], scale=scale)

    with torch.no_grad():
        fwd_ms = _graph_ms(sdpa)
    both_ms = _graph_ms(lambda: torch.autograd.grad(sdpa(), (qs, ks, vs),
                                                    do))
    return both_ms - fwd_ms, both_ms


def phase_flash_bwd(kind: str, b: int, heads: int, s: int, d: int,
                    kv_len: int) -> dict:
    """Kernel 10 through flash_attention and autograd against the plain
    backward on the forward's (o, lse): dq, dk, dv within BWD_ULPS of
    their largest elements, two runs bit-equal; the launches of the public
    op (``ops.scaled_dot_product_attention``) forward and backward, as a
    caller that differentiates it runs them; SDPA's backward as the
    yardstick."""
    import torch

    from devt_tpu_torch.ops import flash_attention as tfa
    from devt_tpu_torch.ops.attention import scaled_dot_product_attention

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[kind]
    q, k, v = _packed_heads(b, s, heads, d, dtype, SEED + 9 + s)
    do = torch.randn(b, heads, s, d, generator=torch.Generator().manual_seed(
        SEED + 10)).to(dtype).cuda()
    scale = d ** -0.5
    tag = f"flash-bwd kernel 10 {kind} ({b * heads},{s},{d}) kv_len {kv_len}"

    def through_autograd():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        with torch.enable_grad():
            o, lse = tfa.flash_attention(*leaves, kv_len=kv_len,
                                         return_lse=True)
            grads = torch.autograd.grad(o, leaves, do)
        return o.detach(), lse, grads

    # the op as a caller runs it: counts set to 0 just before, read after
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    _zero_counts()
    with torch.enable_grad():
        out = scaled_dot_product_attention(*leaves, kv_len=kv_len)
        torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    counts, body = _kernel_counts(), _body_counts()
    if counts != _expect(k9=1, k10=1):
        raise AssertionError(f"{tag}: the op launched {counts}")
    # the bodies the rules name: kernel 10 on kernels 12's and 13's wgmma
    # bodies where blocked_bwd_on_wgmma says
    w9 = int(tfa.one_shot_on_wgmma(dtype, d, kv_len))
    w10 = int(tfa.blocked_bwd_on_wgmma(dtype, d))
    if body != {**dict.fromkeys(body, 0), "k9_wgmma": w9,
                "k9_streamed": 1 - w9, "k10_wgmma": w10,
                "k10_streamed": 1 - w10}:
        raise AssertionError(f"{tag}: launches by body {body}")
    del out, leaves

    with torch.no_grad():
        o, lse, got = through_autograd()
        want = tfa.flash_single_bwd_plain(q, k, v, o, lse, do, scale, kv_len)
        torch.cuda.synchronize()
        worst = worst_rel = 0.0
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            if not torch.isfinite(g.float()).all():
                raise AssertionError(f"{tag} {name}: non-finite output")
            err = _max_err(g, w)
            largest = w.float().abs().max().item()
            bound = BWD_ULPS[kind] * EPS[kind] * largest
            if not err <= bound:
                raise AssertionError(f"{tag} {name}: max abs err {err:.3e} > "
                                     f"{bound:.3e}")
            worst, worst_rel = max(worst, err), max(worst_rel, err / largest)
        again = through_autograd()[2]
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"{tag}: two runs differ in their bits")
        del want, again
        # the kernel by CUDA graph replay, as SDPA's backward below; the
        # plain version by events around eager calls
        kernel_ms = _graph_ms(lambda: tfa._flash_bwd_cuda(
            q, k, v, o, lse, do, scale, kv_len))
        plain_ms = _time_ms(lambda: tfa.flash_single_bwd_plain(
            q, k, v, o, lse, do, scale, kv_len), iters=3, warmup=1)
    # the yardstick: SDPA on the same views (live keys) through autograd,
    # forward + backward less forward
    library_ms, fwd_bwd_ms = _sdpa_bwd_ms(q, k, v, do, kv_len, scale)
    bound_ms, bound_by = _flash_bound(kind, b * heads, s, s, d, kv_len,
                                      backward=True)
    print(f"[kernel-flash-bwd] {tag} (head views of a packed qkv), through "
          f"flash_attention and autograd against the plain backward on the "
          f"forward's (o, lse): dq, dk, dv within {BWD_ULPS[kind]} ulps of "
          f"the largest element, max_abs_err={worst:.3e} ({worst_rel:.3e} "
          f"of its tensor's largest element), two runs bit-equal | the "
          f"public op forward and backward: launches {counts['k9']} of "
          f"kernel 9 and {counts['k10']} of kernel 10, kernel 10 on "
          + ("kernels 12's and 13's wgmma bodies (flash_bwd_sm90.cuh)"
             if w10 else "attention_bwd.cuh's streamed body")
          + f" | kernel_ms="
          f"{kernel_ms:.4f} (CUDA graph) plain_ms={plain_ms:.4f} (CUDA "
          f"events, eager) library_ms={library_ms:.4f} (device time, CUDA "
          f"graph, of "
          f"F.scaled_dot_product_attention through autograd: forward + "
          f"backward {fwd_bwd_ms:.4f} less forward "
          f"{fwd_bwd_ms - library_ms:.4f}) "
          f"bound_ms={bound_ms:.4f} ({bound_by})",
          flush=True)
    return {"max_abs_err": worst, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "launches": counts["k10"]}


def _vivit_model(**kw):
    """ViViT at the registry's widths (dim 192, depth 4, 3 heads of 64,
    MLP 768, 19 classes, 16 frames, bf16) unless ``kw`` says otherwise,
    seeded weights, on the CPU."""
    import torch

    from devt_tpu_torch.models.vivit import ViViT

    base = dict(num_classes=19, num_frames=16, channels_last=True,
                dtype=torch.bfloat16)
    return ViViT(**{**base, **kw}).init_weights(
        torch.Generator().manual_seed(SEED))


def _eval_on_card_and_cpu(model, cfg, image, scope, seed):
    """make_eval_step on 2 clips on the card and on the CPU (the same
    weights), inside ``scope``: the largest score difference."""
    import copy

    from devt_tpu_torch.parallel.train_step import make_eval_step
    from devt_tpu_torch.train.optimizers import build_optimizer
    from devt_tpu_torch.train.state import TrainState

    small = _train_batch(2, seed, image)
    cpu = copy.deepcopy(model).cpu()
    probs = []
    for m, device in ((model, "cuda"), (cpu, "cpu")):
        state = TrainState.create(dict(m.named_parameters()),
                                  build_optimizer(cfg))
        with scope():
            probs.append(make_eval_step(m, cfg, device=device)(
                state, small)[1]["probs"].float().cpu())
    return (probs[0] - probs[1]).abs().max().item()


def phase_eval_long() -> dict:
    """ViViT at image 384 (577 space tokens, over one kv block) through
    make_eval_step at batch 32: kernel 11 in every space block, in bf16 and
    under quant_scope; 2 clips against the CPU; clips/s.  (Its training
    step is phase train-long.)"""
    import contextlib

    import torch

    from devt_tpu_torch.ops.attention import quant_scope
    from devt_tpu_torch.parallel.train_step import make_eval_step
    from devt_tpu_torch.train.optimizers import build_optimizer
    from devt_tpu_torch.train.state import TrainState

    cfg = _vivit_cfg()
    model = _vivit_model(image_size=LONG_IMAGE)
    depth = len(model.space_transformer.blocks)
    errs = {"bf16": _eval_on_card_and_cpu(model.cuda(), cfg, LONG_IMAGE,
                                          contextlib.nullcontext, SEED + 5),
            "int8": _eval_on_card_and_cpu(model.cuda(), cfg, LONG_IMAGE,
                                          quant_scope, SEED + 5)}
    if not (errs["bf16"] <= SCORE_ATOL and errs["int8"] <= QUANT_SCORE_ATOL):
        raise AssertionError(f"eval-long: card vs CPU scores differ by "
                             f"{errs} (limits {SCORE_ATOL}, "
                             f"{QUANT_SCORE_ATOL})")
    batch = _train_batch(TRAIN_BATCH, SEED + 6, LONG_IMAGE)
    state = TrainState.create(dict(model.named_parameters()),
                              build_optimizer(cfg))
    evaluate = make_eval_step(model, cfg)
    out = {}
    for tag, scope in (("bf16", contextlib.nullcontext),
                       ("int8", quant_scope)):
        with scope():
            _zero_counts()
            loss, aux = evaluate(state, batch)
            torch.cuda.synchronize()
            counts = _kernel_counts()
            body = _body_counts()
            if counts != _expect(k11=depth) or body["k11_wgmma"] != depth \
                    or not torch.isfinite(aux["probs"].float()).all():
                raise AssertionError(f"eval-long {tag}: launches {counts}, "
                                     f"by body {body}, expected {depth} of "
                                     f"kernel 11 alone, all on the wgmma "
                                     f"body; loss {loss.item()}")
            evaluate(state, batch)[0].item()
            windows = []
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(3):
                    loss, _ = evaluate(state, batch)
                loss.item()
                windows.append((time.perf_counter() - t0) / 3)
            rows, busy, wall = _traced(lambda: evaluate(state, batch)[0]
                                       .item())
        _print_profile(f"eval-long {tag}, batch {TRAIN_BATCH}", rows, busy,
                       wall, top=8)
        flash_ms = sum(ms for n, ms, _ in rows if "flash_fwd" in n)
        out[tag] = {"counts": counts, "step_ms": min(windows) * 1e3,
                    "clips_per_s": TRAIN_BATCH / min(windows),
                    "flash_ms": flash_ms}
    print(f"[eval-long] ViViT image {LONG_IMAGE} (577 space tokens, padded "
          f"to 592; dim 192, depth {depth}, 3 heads of 64, bf16) through "
          f"make_eval_step at batch {TRAIN_BATCH}: launches "
          f"{out['bf16']['counts']['k11']} of kernel 11 (all on its wgmma "
          f"body) and none of kernels 1, 3, 9 per step; under quant_scope "
          f"{out['int8']['counts']['k11']} of kernel 11 and none of kernel 5 "
          f"| card vs CPU on 2 clips: max abs score err {errs['bf16']:.3e} "
          f"(atol {SCORE_ATOL}), int8 {errs['int8']:.3e} (atol "
          f"{QUANT_SCORE_ATOL}) | bf16 {out['bf16']['clips_per_s']:.2f} "
          f"clips/s ({out['bf16']['step_ms']:.3f} ms a step, kernel 11 "
          f"{out['bf16']['flash_ms']:.4f} ms of device time), int8 "
          f"{out['int8']['clips_per_s']:.2f} clips/s "
          f"({out['int8']['step_ms']:.3f} ms; best of 3 windows of 3 steps, "
          f"host clock)", flush=True)
    return {"launches": out["bf16"]["counts"]["k11"]
            + out["int8"]["counts"]["k11"], **out}


def phase_serve_int8_unfused() -> dict:
    """The int8 blocks off the fused path: ViViT at token_pad=0 (197
    tokens) under quant_scope launches kernel 9 in every space block; the
    repaired widths (dim 384, 6 heads of 64: no bf16 fused instance) serve,
    train one step and serve in int8 without kernels 1, 2 or 5; ViViT at
    image 320 (401 -> 416 tokens, more than kernel 2 holds) trains one step
    through kernels 3 and 4."""
    import contextlib

    import torch

    from devt_tpu_torch.ops.attention import quant_scope
    from devt_tpu_torch.parallel.train_step import (make_eval_step,
                                                    make_train_step)
    from devt_tpu_torch.train.optimizers import build_optimizer
    from devt_tpu_torch.train.state import TrainState

    cfg = _vivit_cfg()
    model = _vivit_model(token_pad=0).cuda()
    depth = len(model.space_transformer.blocks)
    err = _eval_on_card_and_cpu(model, cfg, 224, quant_scope, SEED + 7)
    if not err <= QUANT_SCORE_ATOL:
        raise AssertionError(f"serve-int8-unfused: card vs CPU scores "
                             f"differ by {err:.3e} > {QUANT_SCORE_ATOL}")
    batch = _train_batch(TRAIN_BATCH, SEED + 8)

    def fresh_state(m):
        return TrainState.create(dict(m.named_parameters()),
                                 build_optimizer(cfg))

    state = fresh_state(model)
    evaluate = make_eval_step(model, cfg)
    with quant_scope():
        _zero_counts()
        evaluate(state, batch)[0].item()
        counts = _kernel_counts()
        if counts != _expect(k9=depth):
            raise AssertionError(f"serve-int8-unfused: launches {counts}, "
                                 f"expected {depth} of kernel 9 alone")
        body = _body_counts()
        if body["k9_wgmma"] != depth:
            raise AssertionError(f"serve-int8-unfused: kernel 9 launches by "
                                 f"body {body}, expected {depth} on the "
                                 f"wgmma body")
        t0 = time.perf_counter()
        for _ in range(5):
            loss, _ = evaluate(state, batch)
        loss.item()
        clips_per_s = 5 * TRAIN_BATCH / (time.perf_counter() - t0)
        _print_profile(f"int8 ViViT token_pad=0, batch {TRAIN_BATCH}",
                       *_traced(lambda: evaluate(state, batch)[0].item()),
                       top=8)
    del model, state, evaluate

    # repair 1: a width the bf16 fused kernels are not compiled for
    wide = _vivit_model(dim=384, heads=6, dim_head=64).cuda()
    wstate = fresh_state(wide)
    runs = {}
    for tag, scope, fn in (
            ("serve", contextlib.nullcontext, make_eval_step(wide, cfg)),
            ("train", contextlib.nullcontext, make_train_step(wide, cfg)),
            ("int8", quant_scope, make_eval_step(wide, cfg))):
        with scope():
            _zero_counts()
            if tag == "train":
                wstate, metrics = fn(wstate, batch, SEED)
                loss = metrics["loss"]
            else:
                loss = fn(wstate, batch)[0]
            if not math.isfinite(loss.item()):
                raise AssertionError(f"serve-int8-unfused dim 384 {tag}: "
                                     f"loss {loss.item()}")
            runs[tag] = _kernel_counts()
            k4_wgmma = _body_counts()["k4_wgmma"]
            if k4_wgmma != runs[tag]["k4"]:
                raise AssertionError(f"serve-int8-unfused dim 384 {tag}: "
                                     f"kernel 4 by body {_body_counts()}, "
                                     f"expected every launch on kernels "
                                     f"12's and 13's wgmma bodies")
    want = {"serve": _expect(k3=depth), "int8": _expect(k9=depth),
            "train": _expect(k3=depth, k4=depth)}
    if runs != want:
        raise AssertionError(f"serve-int8-unfused dim 384: launches {runs}, "
                             f"expected {want}")
    del wide, wstate

    # repair 2: 416 tokens, over kernel 2's shared memory at head dim 64
    tall = _vivit_model(image_size=320).cuda()
    tbatch = _train_batch(TRAIN_BATCH, SEED + 9, 320)
    tstate = fresh_state(tall)
    _zero_counts()
    tstate, metrics = make_train_step(tall, cfg)(tstate, tbatch, SEED)
    tall_loss = metrics["loss"].item()
    tall_counts = _kernel_counts()
    if tall_counts != _expect(k3=depth, k4=depth) \
            or not math.isfinite(tall_loss) \
            or _body_counts()["k4_wgmma"] != depth:
        raise AssertionError(f"serve-int8-unfused image 320: launches "
                             f"{tall_counts}, kernel 4 by body "
                             f"{_body_counts()} (every launch on the wgmma "
                             f"bodies), loss {tall_loss}")
    print(f"[serve-int8-unfused] ViViT token_pad=0 (197 space tokens, no "
          f"multiple of 16) under quant_scope through make_eval_step at "
          f"batch {TRAIN_BATCH}: launches {counts['k9']} of kernel 9 "
          f"({body['k9_wgmma']} on the wgmma body) and "
          f"none of kernel 5 (the temporal blocks on their pinned 'xla'); "
          f"card vs CPU on 2 clips: max abs score err {err:.3e} (atol "
          f"{QUANT_SCORE_ATOL}); {clips_per_s:.2f} clips/s (one window of 5 "
          f"steps, host clock) | dim 384, 6 heads of 64 (no bf16 fused "
          f"instance): serving {runs['serve']['k3']} launches of kernel 3, "
          f"a training step {runs['train']['k3']} + {runs['train']['k4']} of "
          f"kernels 3 and 4 (4 on kernels 12's and 13's wgmma bodies), int8 "
          f"{runs['int8']['k9']} of kernel 9, none of kernels 1, 2, 5 | "
          f"image 320 (401 -> 416 tokens): a training step through "
          f"{tall_counts['k3']} + {tall_counts['k4']} launches of kernels 3 "
          f"and 4 (4 on the wgmma bodies), none of kernel 2, loss "
          f"{tall_loss:.5f}",
          flush=True)
    return {"launches": counts["k9"] + runs["int8"]["k9"],
            "counts": [counts, *runs.values(), tall_counts],
            "clips_per_s": clips_per_s,
            "k4_wgmma": runs["train"]["k4"] + tall_counts["k4"]}


def _blocked_bwd_bounds(kind, bh, sq, skv, d, kv_len):
    """Least times of kernel 12 (delta, then dq: three products over the
    live keys; q, o, do, k, v and lse read, dq and delta written) and
    kernel 13 (four products; q, do, k, v, lse and delta read, dk and dv
    written)."""
    item = 4 if kind == "f32" else 2
    work = bh * sq * kv_len * d
    dq = _bound({kind: 6 * work},
                (4 * sq + 2 * skv) * bh * d * item + 8 * bh * sq)
    dkv = _bound({kind: 8 * work},
                 (2 * sq + 4 * skv) * bh * d * item + 8 * bh * sq)
    return dq, dkv


def phase_flash_blocked_bwd(kind: str, b: int, heads: int, sq: int, skv: int,
                            d: int, kv_len: int, timed: bool = True) -> dict:
    """Kernels 12 and 13 through flash_attention and autograd against the
    plain backward on the forward's (o, lse): dq, dk, dv within BWD_ULPS of
    their largest elements, keys past kv_len exact zeros, two runs
    bit-equal, one launch of each on the body blocked_bwd_on_wgmma names;
    each kernel's time (CUDA graph), its bound, the plain version's, SDPA's
    backward as the yardstick of the pair, and the wgmma bodies' ptxas
    report."""
    import torch

    from devt_tpu_torch.ops import flash_attention as tfa

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[kind]
    if sq == skv:
        q, k, v = _packed_heads(b, sq, heads, d, dtype, SEED + 12 + sq + d)
    else:
        gen = torch.Generator().manual_seed(SEED + 12 + sq)
        q = torch.randn(b, heads, sq, d, generator=gen).to(dtype).cuda()
        k, v = (torch.randn(b, heads, skv, d, generator=gen).to(dtype).cuda()
                for _ in range(2))
    do = torch.randn(b, heads, sq, d, generator=torch.Generator().manual_seed(
        SEED + 13)).to(dtype).cuda()
    scale = d ** -0.5
    tag = (f"flash-blocked-bwd kernels 12, 13 {kind} ({b * heads},{sq},"
           f"{skv},{d}) kv_len {kv_len}")

    def through_autograd():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        with torch.enable_grad():
            o, lse = tfa.flash_attention(*leaves, kv_len=kv_len,
                                         return_lse=True)
            grads = torch.autograd.grad(o, leaves, do)
        return o.detach(), lse, grads

    with torch.no_grad():
        before = _body_counts()
        o, lse, got = through_autograd()
        body = {k_: n - before[k_] for k_, n in _body_counts().items()}
        wgmma = int(tfa.blocked_bwd_on_wgmma(dtype, d))
        if body != {**dict.fromkeys(body, 0), "k11_wgmma": body["k11_wgmma"],
                    "k11_streamed": body["k11_streamed"],
                    "k12_wgmma": wgmma, "k12_streamed": 1 - wgmma,
                    "k13_wgmma": wgmma, "k13_streamed": 1 - wgmma}:
            raise AssertionError(f"{tag}: launches by body {body}")
        want = tfa.flash_blocked_bwd_plain(q, k, v, o, lse, do, scale,
                                           kv_len)
        torch.cuda.synchronize()
        worst = worst_rel = 0.0
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            if not torch.isfinite(g.float()).all():
                raise AssertionError(f"{tag} {name}: non-finite output")
            err = _max_err(g, w)
            largest = w.float().abs().max().item()
            if not err <= BWD_ULPS[kind] * EPS[kind] * largest:
                raise AssertionError(f"{tag} {name}: max abs err {err:.3e} > "
                                     f"{BWD_ULPS[kind]} ulps of {largest:.3e}")
            worst, worst_rel = max(worst, err), max(worst_rel, err / largest)
        if any(g[:, :, kv_len:].any() for g in got[1:]):
            raise AssertionError(f"{tag}: dk or dv past kv_len not zero")
        again = through_autograd()[2]
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"{tag}: two runs differ in their bits")
        del want, again
        out = {"max_abs_err": worst, "wgmma_launches": wgmma,
               "streamed_launches": 1 - wgmma}
        if timed:
            # device time by CUDA graph replay, as kernels 9 and 11
            _, delta = tfa._flash_blocked_dq_cuda(q, k, v, o, lse, do, scale,
                                                  kv_len)
            out["dq_ms"] = _graph_ms(lambda: tfa._flash_blocked_dq_cuda(
                q, k, v, o, lse, do, scale, kv_len))
            out["dkv_ms"] = _graph_ms(lambda: tfa._flash_blocked_dkv_cuda(
                q, k, v, o, lse, do, delta, scale, kv_len))
            out["plain_ms"] = _time_ms(lambda: tfa.flash_blocked_bwd_plain(
                q, k, v, o, lse, do, scale, kv_len), iters=3, warmup=1)
    (out["dq_bound_ms"], out["dq_bound_by"]), \
        (out["dkv_bound_ms"], out["dkv_bound_by"]) = _blocked_bwd_bounds(
            kind, b * heads, sq, skv, d, kv_len)
    times = ""
    if timed:
        out["library_ms"], both_ms = _sdpa_bwd_ms(q, k, v, do, kv_len, scale)
        times = (f" | CUDA graph: kernel 12 {out['dq_ms']:.4f} ms (delta "
                 f"included), kernel 13 {out['dkv_ms']:.4f} ms, the pair "
                 f"{out['dq_ms'] + out['dkv_ms']:.4f}; plain (both) "
                 f"{out['plain_ms']:.4f} ms; library_ms="
                 f"{out['library_ms']:.4f} (device time, CUDA graph, of "
                 f"F.scaled_dot_product_attention's backward through "
                 f"autograd on the live keys: forward + backward "
                 f"{both_ms:.4f} less forward)")
    print(f"[kernel-flash-blocked-bwd] {tag}"
          f"{' (head views of a packed qkv)' if sq == skv else ''}, through "
          f"flash_attention and autograd against the plain backward on the "
          f"forward's (o, lse): dq, dk, dv within {BWD_ULPS[kind]} ulps of "
          f"the largest element, max_abs_err={worst:.3e} ({worst_rel:.3e} "
          f"of its tensor's largest element), dk and dv past kv_len zero, "
          f"two runs bit-equal; launches by body: kernel 12 "
          f"{body['k12_wgmma']} wgmma + {body['k12_streamed']} streamed, "
          f"kernel 13 {body['k13_wgmma']} wgmma + {body['k13_streamed']} "
          f"streamed "
          f"({'flash_bwd_sm90.cuh' if wgmma else 'attention_bwd.cuh'})"
          f"{times} | bound_ms kernel 12 "
          f"{out['dq_bound_ms']:.4f} ({out['dq_bound_by']}), kernel 13 "
          f"{out['dkv_bound_ms']:.4f} ({out['dkv_bound_by']})"
          + (f" | {_ptxas('flash_bwd', _DQ)} | {_ptxas('flash_bwd', _DKV)}"
             if wgmma and timed else ""), flush=True)
    return out


def phase_train_long() -> dict:
    """ViViT at image 384 (577 space tokens, padded to 592: every space
    block unfused, its attention kernel 11 and, backward, kernels 12 and
    13) trained at batch 32 through make_train_step and
    make_multi_step(8): 4 launches each of kernels 11, 12 and 13 a step and
    none of kernels 1-10; a falling loss; one step's gradients on 2 clips
    against the CPU's plain path; clips/s as the best of 3 windows, the
    host's share, a profile and the peak device memory."""
    import copy

    import torch

    from devt_tpu_torch.models.layers import DropoutRng
    from devt_tpu_torch.parallel.train_step import (make_eval_step,
                                                    make_multi_step,
                                                    make_train_step)
    from devt_tpu_torch.train.optimizers import build_optimizer
    from devt_tpu_torch.train.state import TrainState
    from devt_tpu_torch.train.steps import forward_and_loss

    cfg = _vivit_cfg()
    model = _vivit_model(image_size=LONG_IMAGE)
    depth = len(model.space_transformer.blocks)
    reference = copy.deepcopy(model)

    def step_grads(m, batch):
        params = dict(m.named_parameters())
        loss, _, _ = forward_and_loss(m, cfg, {"params": params}, batch,
                                      DropoutRng(0), train=True)
        return loss.item(), dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))

    small = _train_batch(2, SEED + 11, LONG_IMAGE)
    model.cuda()
    card_loss, card = step_grads(model, small)
    cpu_loss, cpu = step_grads(reference, {k: v.cpu()
                                           for k, v in small.items()})
    worst, worst_leaf = 0.0, ""
    for name, want in cpu.items():
        got = card[name].cpu()
        if not torch.isfinite(got).all():
            raise AssertionError(f"train-long: non-finite gradient of {name}")
        ratio = (got - want).abs().max().item() / max(
            want.abs().max().item(), GRAD_FLOOR)
        if ratio > worst:
            worst, worst_leaf = ratio, name
    if not worst <= GRAD_RTOL or abs(card_loss - cpu_loss) > SCORE_ATOL:
        raise AssertionError(
            f"train-long: card vs CPU gradients differ by {worst:.3e} of the "
            f"leaf's largest element at {worst_leaf} (bound {GRAD_RTOL}); "
            f"loss {card_loss:.5f} vs {cpu_loss:.5f}")
    del reference, card, cpu, small

    # the main path: one step, then the multi-step executor, the counts set
    # to 0 just before and read just after
    batch = _train_batch(TRAIN_BATCH, SEED + 12, LONG_IMAGE)
    stacked = {k: v[None].expand(MULTI_STEPS, *v.shape)
               for k, v in batch.items()}
    state = TrainState.create(dict(model.named_parameters()),
                              build_optimizer(cfg))
    step = make_train_step(model, cfg)
    multi = make_multi_step(model, cfg, MULTI_STEPS)
    evaluate = make_eval_step(model, cfg)
    loss_before = evaluate(state, batch)[0].item()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    state, first = step(state, batch, SEED)
    state, metrics = multi(state, stacked, SEED)
    torch.cuda.synchronize()
    counts = _kernel_counts()
    body = _body_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = 1 + MULTI_STEPS
    if counts != _expect(k11=depth * steps, k12=depth * steps,
                         k13=depth * steps) \
            or any(body[f"k{n}_wgmma"] != depth * steps
                   for n in (11, 12, 13)):
        raise AssertionError(f"train-long: launches {counts} in {steps} "
                             f"steps, by body {body}, expected {depth} each "
                             f"of kernels 11, 12, 13 per step, all on their "
                             f"wgmma bodies, and nothing else")
    loss_after = evaluate(state, batch)[0].item()
    losses = (first["loss"].item(), metrics["loss"].item(), loss_after)
    if not all(map(math.isfinite, losses)) or not loss_after < loss_before:
        raise AssertionError(f"train-long: loss {loss_before:.5f} before, "
                             f"{losses} during and after {steps} steps")

    multi(state, stacked, SEED)[1]["loss"].item()
    windows, enqueue = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(TRAIN_ITERS):
            state, metrics = multi(state, stacked, SEED)
        enqueue.append(time.perf_counter() - t0)
        metrics["loss"].item()
        windows.append(time.perf_counter() - t0)
    n_steps = TRAIN_ITERS * MULTI_STEPS
    step_ms = min(windows) / n_steps * 1e3
    host_ms = enqueue[windows.index(min(windows))] / n_steps * 1e3
    clips_per_s = TRAIN_BATCH * n_steps / min(windows)
    rows, busy, wall_ms = _traced(lambda: step(state, batch, SEED)[1]["loss"]
                                  .item())
    _print_profile(f"train-long step, B={TRAIN_BATCH}", rows, busy, wall_ms,
                   top=14)
    device_ms = sum(ms for _, ms, _ in rows)
    fwd_ms = sum(ms for n, ms, _ in rows if n.startswith("flash_fwd"))
    bwd_ms = sum(ms for n, ms, _ in rows
                 if n.startswith(("flash_bwd_", "mha_bwd")))
    print(f"[train-long] ViViT image {LONG_IMAGE} (577 space tokens, padded "
          f"to 592; dim 192, depth {depth}, 3 heads of 64, MLP 768, 16 "
          f"frames, bf16, AdamW) at B={TRAIN_BATCH}: {steps} steps (1 + "
          f"make_multi_step({MULTI_STEPS})), launches {counts['k11']} of "
          f"kernel 11, {counts['k12']} of kernel 12, {counts['k13']} of "
          f"kernel 13 ({depth} of each per step, all on their wgmma "
          f"bodies), none of kernels 1-10; "
          f"loss on the fixed batch {loss_before:.5f} -> {loss_after:.5f}; "
          f"card vs CPU gradients on 2 clips: worst {worst:.3e} of the "
          f"leaf's largest element at {worst_leaf} (bound {GRAD_RTOL}), "
          f"loss {card_loss:.5f} vs {cpu_loss:.5f} | {clips_per_s:.2f} "
          f"clips/s, step_ms={step_ms:.3f}, host enqueue ms={host_ms:.3f} "
          f"(best of 3 windows of {n_steps} steps, host clock; windows "
          f"{', '.join(f'{TRAIN_BATCH * n_steps / w:.1f}' for w in windows)})"
          f", device_ms={device_ms:.3f} (one step under the profiler, busy "
          f"{busy:.1%}; kernel 11 {fwd_ms:.3f} ms, kernels 12 + 13 "
          f"{bwd_ms:.3f} ms) | peak device memory {peak_gb:.2f} GiB "
          f"(torch.cuda.max_memory_allocated over the {steps} steps)",
          flush=True)
    return {"counts": counts, "clips_per_s": clips_per_s, "step_ms": step_ms,
            "host_ms": host_ms, "device_ms": device_ms,
            "bwd_ms": bwd_ms, "peak_gb": peak_gb}


# one ring hop at the sequence-parallel bench's shape (bench.py:1086): the
# ViT block's 512 sequences of 208 tokens, 197 of them live, 3 heads of 64
RING_SEQS, RING_S, RING_LIVE = 512, 208, 197
# the hop-by-hop ring: ViViT's 592 tokens (577 live) in 4 chunks of 148
HOP_SEQS, HOP_S, HOP_KV, HOP_SHARDS = 32, 592, 577, 4


def _ring_bounds(kind, b, s, heads, d, live):
    """Least times of kernel 14 (two products over the live columns; q, kv
    read, o written, lse and the mask) and kernel 15 (five products; q,
    kv, o, do read, the f32 dq and dkv written, lse and the mask)."""
    item = 4 if kind == "f32" else 2
    rows, work = b * s, b * heads * s * live * d
    hd = heads * d
    fwd = _bound({kind: 4 * work},
                 4 * rows * hd * item + 4 * rows * heads + 4 * s)
    bwd = _bound({kind: 10 * work}, 5 * rows * hd * item + 12 * rows * hd
                 + 4 * rows * heads + 4 * s)
    return fwd, bwd


def _hop_by_hop(kind) -> tuple[dict, dict]:
    """A 4-rank ring run on one card, hop by hop: each query chunk meets
    every kv chunk through ring_step_fwd and the flash combine, then
    ring_step_bwd with the global lse, dkv summed per chunk; held against
    flash_attention (kernel 11) and its gradient (kernels 12, 13) on the
    same tokens.  Returns the errors and the launches of kernels 14, 15."""
    import torch

    from devt_tpu_torch.ops import flash_attention as tfa
    from devt_tpu_torch.parallel.ring_attention import _colmask, _combine

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[kind]
    heads, d = HEADS, D // HEADS
    hd = heads * d
    gen = torch.Generator().manual_seed(SEED + 14)
    q = torch.randn(HOP_SEQS, HOP_S, hd, generator=gen).to(dtype).cuda()
    kv = torch.randn(HOP_SEQS, HOP_S, 2 * hd, generator=gen).to(dtype).cuda()
    do = torch.randn(HOP_SEQS, HOP_S, hd, generator=gen).to(dtype).cuda()
    chunk = HOP_S // HOP_SHARDS
    s_p = -(-chunk // 16) * 16
    scale = d ** -0.5

    def pad(t, i):
        part = t[:, i * chunk:(i + 1) * chunk]
        return torch.nn.functional.pad(part, (0, 0, 0, s_p - chunk))

    qs, kvs, dos = ([pad(t, i) for i in range(HOP_SHARDS)]
                    for t in (q, kv, do))
    masks = [_colmask(i, chunk, s_p, HOP_KV, "cuda")
             for i in range(HOP_SHARDS)]
    _zero_counts()
    outs, lses = [], []
    for r in range(HOP_SHARDS):
        o = torch.zeros(HOP_SEQS, s_p, hd, device="cuda")
        lse = torch.full((HOP_SEQS, s_p, heads), -1e30, device="cuda")
        for t in range(HOP_SHARDS):
            blk = (r - t) % HOP_SHARDS
            o_i, lse_i = tfa.ring_step_fwd(qs[r], kvs[blk], masks[blk],
                                           heads=heads, scale=scale)
            o, lse = _combine(o, lse, o_i, lse_i, heads)
        outs.append(o.to(dtype))
        lses.append(lse)
    dq = [torch.zeros(HOP_SEQS, s_p, hd, device="cuda")
          for _ in range(HOP_SHARDS)]
    dkv = [torch.zeros(HOP_SEQS, s_p, 2 * hd, device="cuda")
           for _ in range(HOP_SHARDS)]
    for r in range(HOP_SHARDS):
        for blk in range(HOP_SHARDS):
            dq_p, dkv_p = tfa.ring_step_bwd(qs[r], kvs[blk], masks[blk],
                                            outs[r], lses[r], dos[r],
                                            heads=heads, scale=scale)
            dq[r] += dq_p
            dkv[blk] += dkv_p
    torch.cuda.synchronize()
    counts = _kernel_counts()
    if counts != _expect(k14=HOP_SHARDS ** 2, k15=HOP_SHARDS ** 2):
        raise AssertionError(f"kernel-ring hop by hop: launches {counts}")
    wgmma = tfa.one_shot_on_wgmma(dtype, d, s_p)
    bwd_wgmma = tfa.blocked_bwd_on_wgmma(dtype, d)
    counts["k14_wgmma"] = _body_counts()["k14_wgmma"]
    counts["k15_wgmma"] = _body_counts()["k15_wgmma"]
    if counts["k14_wgmma"] != (HOP_SHARDS ** 2 if wgmma else 0) \
            or counts["k15_wgmma"] != (HOP_SHARDS ** 2 if bwd_wgmma else 0):
        raise AssertionError(f"kernel-ring hop by hop: {counts['k14_wgmma']} "
                             f"launches of kernel 14 and "
                             f"{counts['k15_wgmma']} of kernel 15 on the "
                             f"wgmma bodies")

    def cat(parts):
        return torch.cat([p[:, :chunk] for p in parts], dim=1)

    def heads_of(t, off=0):
        return t[..., off:off + hd].reshape(HOP_SEQS, HOP_S, heads, d) \
            .transpose(1, 2)

    leaves = [heads_of(q), heads_of(kv), heads_of(kv, hd)]
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        ref, ref_lse = tfa.flash_attention(*leaves, kv_len=HOP_KV,
                                           return_lse=True)
        ref_grads = torch.autograd.grad(ref, leaves, heads_of(do))
    got = {"o": heads_of(cat(outs)), "dq": heads_of(cat(dq)),
           "dk": heads_of(cat(dkv)), "dv": heads_of(cat(dkv), hd)}
    want = {"o": ref, "dq": ref_grads[0], "dk": ref_grads[1],
            "dv": ref_grads[2]}
    errs = {}
    # the ring rounds every hop's o to the model dtype before the combine,
    # the blockwise kernel once: in bf16 BWD_ULPS of headroom twice over
    ulps = 2 * BWD_ULPS[kind] if kind == "bf16" else BWD_ULPS[kind]
    for name, w in want.items():
        g = got[name].float()
        errs[name] = _max_err(g, w) / w.float().abs().max().item()
        if not errs[name] <= ulps * EPS[kind] or not torch.isfinite(g).all():
            raise AssertionError(f"kernel-ring hop by hop {kind} {name}: "
                                 f"{errs[name]:.3e} of the largest element "
                                 f"> {ulps} ulps")
    lse_ring = cat(lses).transpose(1, 2).reshape(-1, HOP_S)
    _check_close(f"kernel-ring hop by hop {kind} lse", lse_ring, ref_lse,
                 *(LSE_TOL if kind == "f32" else TOL["bf16"]))
    errs["lse"] = _max_err(lse_ring, ref_lse)
    return errs, counts


def phase_ring(kind: str) -> dict:
    """Kernels 14 and 15 at the sequence-parallel bench shape against their
    plain versions (o at the forward gate, lse at LSE_TOL / the forward
    gate; the f32 dq and dkv within BWD_ULPS; two runs bit-equal); their
    times, the plain versions' and F.scaled_dot_product_attention's with
    the same additive mask.  Then the ring hop by hop (a 4-rank ring on one
    card) against flash_attention and its gradient, and ring_mha_split
    with one rank under autograd, each with its launches counted."""
    import torch
    import torch.nn.functional as F

    from devt_tpu_torch.ops import flash_attention as tfa
    from devt_tpu_torch.parallel.ring_attention import ring_mha_split

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[kind]
    heads, d = HEADS, D // HEADS
    hd = heads * d
    gen = torch.Generator().manual_seed(SEED + 15)
    q = torch.randn(RING_SEQS, RING_S, hd, generator=gen).to(dtype).cuda()
    kv = torch.randn(RING_SEQS, RING_S, 2 * hd, generator=gen).to(
        dtype).cuda()
    do = torch.randn(RING_SEQS, RING_S, hd, generator=gen).to(dtype).cuda()
    col = torch.arange(RING_S, device="cuda")[None]
    mask = torch.where(col < RING_LIVE, 0.0, -1e30).float()
    scale = d ** -0.5
    tag = (f"ring kernels 14, 15 {kind} q ({RING_SEQS},{RING_S},{hd}) kv "
           f"({RING_SEQS},{RING_S},{2 * hd}) mask {RING_LIVE} live")
    fwd = lambda: tfa.ring_step_fwd(q, kv, mask, heads=heads,  # noqa: E731
                                    scale=scale)
    with torch.inference_mode():
        before = _body_counts()
        o, lse = fwd()
        body = {k: v - before[k] for k, v in _body_counts().items()}
        want_wgmma = tfa.one_shot_on_wgmma(dtype, d, RING_S)
        if body != {**dict.fromkeys(body, 0), "k14_wgmma": int(want_wgmma),
                    "k14_streamed": int(not want_wgmma)}:
            raise AssertionError(f"{tag}: kernel 14 launches by body {body}")
        wo, wlse = tfa.ring_step_fwd_plain(q, kv, mask, heads, scale)
        torch.cuda.synchronize()
        _check_close(f"{tag} o", o, wo, *TOL[kind])
        lse_tol = LSE_TOL if kind == "f32" else TOL["bf16"]
        _check_close(f"{tag} lse", lse, wlse, *lse_tol)
        fwd_err = max(_max_err(o, wo), _max_err(lse, wlse))
        bwd = lambda: tfa.ring_step_bwd(  # noqa: E731
            q, kv, mask, o, lse, do, heads=heads, scale=scale)
        before = _body_counts()
        got = bwd()
        body = {k: v - before[k] for k, v in _body_counts().items()}
        bwd_wgmma = tfa.blocked_bwd_on_wgmma(dtype, d)
        if body != {**dict.fromkeys(body, 0), "k15_wgmma": int(bwd_wgmma),
                    "k15_streamed": int(not bwd_wgmma)}:
            raise AssertionError(f"{tag}: kernel 15 launches by body {body}")
        want = tfa.ring_step_bwd_plain(q, kv, mask, o, lse, do, heads, scale)
        torch.cuda.synchronize()
        bwd_err = 0.0
        for name, g, w in zip(("dq", "dkv"), got, want):
            err, largest = _max_err(g, w), w.abs().max().item()
            if not torch.isfinite(g).all() \
                    or not err <= BWD_ULPS[kind] * EPS[kind] * largest:
                raise AssertionError(f"{tag} {name}: max abs err {err:.3e} > "
                                     f"{BWD_ULPS[kind]} ulps of "
                                     f"{largest:.3e}")
            bwd_err = max(bwd_err, err)
        if not all(torch.equal(a, c) for a, c in zip(got, bwd())):
            raise AssertionError(f"{tag}: two backward runs differ")
        del want
        # device time, every side by CUDA graph replay
        out = {"fwd": {"max_abs_err": fwd_err, "kernel_ms": _graph_ms(fwd),
                       "plain_ms": _graph_ms(lambda: tfa.ring_step_fwd_plain(
                           q, kv, mask, heads, scale), n=2, replays=2)},
               "bwd": {"max_abs_err": bwd_err, "kernel_ms": _graph_ms(bwd),
                       "plain_ms": _graph_ms(lambda: tfa.ring_step_bwd_plain(
                           q, kv, mask, o, lse, do, heads, scale), n=2,
                           replays=2)}}
    # the library: SDPA on the head views with the same additive mask
    qh, kh, vh = (t.reshape(RING_SEQS, RING_S, heads, d).transpose(1, 2)
                  for t in (q, kv[..., :hd], kv[..., hd:]))
    bias = mask.to(dtype)[None, None]

    def sdpa(a, b_, c):
        return F.scaled_dot_product_attention(a, b_, c, attn_mask=bias,
                                              scale=scale)

    with torch.no_grad():
        out["fwd"]["library_ms"] = _graph_ms(lambda: sdpa(qh, kh, vh))
    leaves = [t.detach().requires_grad_(True) for t in (qh, kh, vh)]
    doh = do.reshape(RING_SEQS, RING_S, heads, d).transpose(1, 2)
    both = _graph_ms(lambda: torch.autograd.grad(sdpa(*leaves), leaves, doh))
    out["bwd"]["library_ms"] = both - out["fwd"]["library_ms"]
    for part, (bound, by) in zip(("fwd", "bwd"), _ring_bounds(
            kind, RING_SEQS, RING_S, heads, d, RING_LIVE)):
        out[part]["bound_ms"], out[part]["bound_by"] = bound, by

    hop_errs, hop_counts = _hop_by_hop(kind)
    body14 = ("wgmma body (flash_fwd_sm90.cuh)" if want_wgmma
              else "streamed body (flash_fwd.cuh)")
    body15 = ("wgmma bodies of kernels 12 and 13 (flash_bwd_sm90.cuh, kRing: "
              "two launches)" if bwd_wgmma else
              "streamed body (attention_bwd.cuh, a delta launch first)")

    # the one-rank ring under autograd: one launch of each kernel
    small = [t[:8, :RING_LIVE].detach().requires_grad_(True) for t in (q, kv)]
    _zero_counts()
    with torch.enable_grad():
        o1 = ring_mha_split(*small, heads=heads)
        torch.autograd.grad(o1, small, do[:8, :RING_LIVE])
    torch.cuda.synchronize()
    one = _kernel_counts()
    if one != _expect(k14=1, k15=1) or not torch.isfinite(o1.float()).all():
        raise AssertionError(f"kernel-ring: ring_mha_split at one rank "
                             f"launched {one}")
    print(f"[kernel-ring] {tag}: kernel 14 max_abs_err o, lse={fwd_err:.3e} "
          f"(atol {TOL[kind][0]}, rtol {TOL[kind][1]}); kernel 15 f32 dq, "
          f"dkv within {BWD_ULPS[kind]} ulps, max_abs_err={bwd_err:.3e}, two "
          f"runs bit-equal | kernel 14 {out['fwd']['kernel_ms']:.4f} ms "
          f"(plain {out['fwd']['plain_ms']:.4f}, library_ms="
          f"{out['fwd']['library_ms']:.4f}: F.scaled_dot_product_attention "
          f"with the additive mask, CUDA graph; bound_ms="
          f"{out['fwd']['bound_ms']:.4f} ({out['fwd']['bound_by']})); kernel "
          f"15 {out['bwd']['kernel_ms']:.4f} ms (plain "
          f"{out['bwd']['plain_ms']:.4f}, library_ms="
          f"{out['bwd']['library_ms']:.4f}: its backward through autograd, "
          f"forward + backward {both:.4f} less forward; bound_ms="
          f"{out['bwd']['bound_ms']:.4f} ({out['bwd']['bound_by']})); kernel "
          f"14 ran the {body14}, kernel 15 the {body15}; every time by CUDA "
          f"graph replay"
          + (f"; {_ptxas('ring_step', ONE_SHOT)}"
             if want_wgmma else "")
          + (f"; {_ptxas('ring_step', _DQ)}; {_ptxas('ring_step', _DKV)}"
             if bwd_wgmma else "")
          + f" | hop "
          f"by hop, {HOP_SHARDS} chunks of {HOP_S // HOP_SHARDS} of a "
          f"{HOP_S}-token sequence (kv_len {HOP_KV}), {HOP_SEQS} sequences: "
          f"{hop_counts['k14']} + {hop_counts['k15']} launches "
          f"({hop_counts['k14_wgmma']} of kernel 14 and "
          f"{hop_counts['k15_wgmma']} of kernel 15 on the wgmma bodies); "
          f"against "
          f"flash_attention and its gradient (kernels 11-13), largest error "
          f"as a share of the tensor's largest element: "
          + ", ".join(f"{k} {v:.3e}" for k, v in hop_errs.items() if k != "lse")
          + f", lse max abs {hop_errs['lse']:.3e} | ring_mha_split at one "
          f"rank under autograd: {one['k14']} + {one['k15']} launches",
          flush=True)
    launches = {"k14": hop_counts["k14"] + one["k14"],
                "k15": hop_counts["k15"] + one["k15"]}
    return {**out, "launches": launches}


def _sdpa_backends(b: int, s: int, heads: int, d: int) -> dict:
    """Which of PyTorch's SDPA backends take this shape in bf16, each
    forced in turn: {backend: its CUDA-graph ms, or None where it refused
    the shape}.  A yardstick only; the port runs none of them."""
    import warnings

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    gen = torch.Generator().manual_seed(SEED + 16)
    q, k, v = (torch.randn(b, heads, s, d, generator=gen).to(
        torch.bfloat16).cuda() for _ in range(3))
    out = {}
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        with sdpa_kernel(backend), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                F.scaled_dot_product_attention(q, k, v)
                torch.cuda.synchronize()
            except RuntimeError:
                out[backend.name] = None
                continue
            out[backend.name] = _graph_ms(
                lambda: F.scaled_dot_product_attention(q, k, v))
    return out


def _ptxas_instances(stem: str, pattern: str) -> str:
    """ptxas' registers and spill bytes of every entry of csrc/<stem>.cu
    whose mangled name matches ``pattern``, from the build log."""
    import re

    from devt_tpu_torch.ops import _build

    log = _build.build_all()[stem].with_suffix(".log").read_text()
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
            rows.append(f"<{','.join(name.groups())}> {found.group(1)} regs "
                        f"{spill} spill bytes")
            name = None
    return "; ".join(rows)


def phase_mha_ft() -> dict:
    """Kernels 3 and 4 at FrameTransformer's two head dims, on their
    streamed bodies: the forward at the training batch and the serving
    bucket, the backward and both at dropout 0.5 at the training batch,
    against their plain versions (phase_mha, phase_mha_bwd); which SDPA
    backends take the shape; ptxas' report of the new instances."""
    print("[kernel-mha-ft] ptxas attention_bf16<d, norm_first, drop>: "
          + _ptxas_instances("mha_fwd", r"attention_bf16ILi(224|448)ELb(\d)"
                             r"ELb(\d)E")
          + " | mha_bwd_bf16<d, drop, mask>: "
          + _ptxas_instances("mha_bwd", r"mha_bwd_bf16ILi(224|448)ELb(\d)"
                             r"ELb(\d)E"), flush=True)
    out = {}
    for encoder, (heads, d, s) in FT_HEADS.items():
        fwd = {b: phase_mha("bf16", b, s, heads, d, s)
               for b in (FT_TRAIN_BATCH, FT_BUCKET)}
        bwd = phase_mha_bwd("bf16", FT_TRAIN_BATCH, s, heads, d, s,
                            dropout=True)
        backends = _sdpa_backends(FT_TRAIN_BATCH, s, heads, d)
        print(f"[kernel-mha-ft] {encoder}: ({FT_TRAIN_BATCH},{s},"
              f"{3 * heads * d}) {heads} heads of {d}: SDPA backends, each "
              f"forced in turn (CUDA graph ms, or refused): " + ", ".join(
                  f"{k} {'refused' if v is None else f'{v:.4f}'}"
                  for k, v in backends.items()), flush=True)
        if all(v is None for v in backends.values()):
            raise AssertionError(f"kernel-mha-ft {encoder}: no SDPA backend "
                                 f"took the shape")
        out[encoder] = {"heads": heads, "d": d, "s": s, "fwd": fwd,
                        "bwd": bwd, "sdpa_backends": backends}
    return out


class _HeadDims:
    """Records the head dim of every launch of kernels 3 ("fwd") and 4
    ("bwd") while active (wraps their launchers; the kernels' own counters
    are untouched)."""

    def __enter__(self):
        from devt_tpu_torch.ops import flash_attention as tfa

        self.seen: dict = {"fwd": [], "bwd": []}
        self._real = (tfa._mha_cuda, tfa._mha_bwd_cuda)

        def fwd(qkv, heads, *args):
            self.seen["fwd"].append(qkv.shape[-1] // (3 * heads))
            return self._real[0](qkv, heads, *args)

        def bwd(qkv, o, lse, do, heads, *args):
            self.seen["bwd"].append(qkv.shape[-1] // (3 * heads))
            return self._real[1](qkv, o, lse, do, heads, *args)

        tfa._mha_cuda, tfa._mha_bwd_cuda = fwd, bwd
        return self

    def __exit__(self, *exc):
        from devt_tpu_torch.ops import flash_attention as tfa

        tfa._mha_cuda, tfa._mha_bwd_cuda = self._real

    def by_dim(self, part: str = "fwd") -> dict:
        return {d: self.seen[part].count(d) for d in (224, 448)}


def _ft_config(model: str = "distil", **kw):
    from devt_tpu_torch.config import Config

    base = dict(model=model, seq_len=FT_SEQ, frame_len=FT_FRAMES,
                n_classes=FT_CLASSES, precision="bf16", opt="adamW",
                learning_rate=1e-4, batch_size=FT_TRAIN_BATCH)
    return Config(**{**base, **kw})


def _ft_request(n: int, seed: int, seq: int = FT_SEQ) -> dict:
    """u8 frames (n, seq, 224, 224, 3) and clips (n, seq, 12, 112, 112, 3),
    the serving wire, and 19 multi-hot labels, as numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"img": rng.integers(0, 256, (n, seq, 224, 224, 3),
                                dtype=np.uint8),
            "vid": rng.integers(0, 256, (n, seq, FT_FRAMES, 112, 112, 3),
                                dtype=np.uint8),
            "label": (rng.random((n, FT_CLASSES)) < 0.3).astype(np.float32)}


def phase_serve_ft() -> dict:
    """Every FrameTransformer variant at full width behind
    Predictor(buckets=(8,)) in bf16 on u8 frames and clips: kernel 3's
    launches by head dim (4 at 448 where the variant runs the distil
    transformer, 4 at 224 where it runs the scene transformer), none of
    kernel 4, finite scores; distil against the CPU at one request;
    clips/s and ms a call."""
    import torch

    from devt_tpu_torch.models.frame_transformer import (VARIANTS,
                                                         FrameTransformer)
    from devt_tpu_torch.registry import build_model
    from devt_tpu_torch.serve import Predictor

    weights = build_model(_ft_config(), torch.Generator().manual_seed(
        SEED)).state_dict()
    request = _ft_request(FT_BUCKET, SEED + 20)
    request.pop("label")
    out: dict = {"counts": _expect(), "variants": {}}
    for variant in VARIANTS:
        cfg = _ft_config(variant)
        # the variant's tree: a subset of distil's
        keys = FrameTransformer(model=variant).state_dict().keys()
        pred = Predictor(cfg, {k: weights[k] for k in keys},
                         buckets=(FT_BUCKET,))
        want = {448: FT_LAYERS if variant not in (
                    "frame", "frame_transformer", "pre_modal") else 0,
                224: FT_LAYERS if variant != "vid" else 0}
        _zero_counts()
        with _HeadDims() as dims:
            got = pred.predict(request)["scores"]
        counts = _kernel_counts()
        if dims.by_dim() != want or dims.seen["bwd"] \
                or counts != _expect(k3=sum(want.values())) \
                or _body_counts()["k3_streamed"] != counts["k3"]:
            raise AssertionError(
                f"serve-ft {variant}: kernel-3 launches by head dim "
                f"{dims.by_dim()}, expected {want}; launches {counts}, by "
                f"body {_body_counts()}")
        out["counts"] = {k: out["counts"][k] + counts[k] for k in counts}
        if got.shape != (FT_BUCKET, FT_CLASSES) or not (got > 0.0).all() \
                or not (got < 1.0).all():
            raise AssertionError(f"serve-ft {variant}: bad scores, shape "
                                 f"{got.shape}")
        tensors = {k: torch.from_numpy(v).cuda() for k, v in request.items()}
        windows = []
        with torch.inference_mode():
            pred.forward(tensors)
            torch.cuda.synchronize()
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(3):
                    pred.forward(tensors)
                torch.cuda.synchronize()
                windows.append((time.perf_counter() - t0) / 3)
        row = {"ms": min(windows) * 1e3,
               "clips_per_s": FT_BUCKET / min(windows),
               "heads": dims.by_dim()}
        if variant == "distil":
            with torch.inference_mode():
                rows, busy, wall = _traced(lambda: pred.forward(tensors))
            _print_profile(f"FrameTransformer distil forward, bucket "
                           f"{FT_BUCKET}", rows, busy, wall, top=10)
            row["device_ms"] = sum(ms for _, ms, _ in rows)
            row["busy"] = busy
            one = {k: v[:1] for k, v in request.items()}
            t0 = time.perf_counter()
            cpu = Predictor(cfg, {k: weights[k] for k in keys}, buckets=(1,),
                            device="cpu").predict(one)["scores"]
            cpu_s = time.perf_counter() - t0
            card = Predictor(cfg, {k: weights[k] for k in keys},
                             buckets=(1,)).predict(one)["scores"]
            row["cpu_err"] = float(abs(card - cpu).max())
            row["cpu_s"] = cpu_s
            if not row["cpu_err"] <= SCORE_ATOL:
                raise AssertionError(f"serve-ft distil: card vs CPU scores "
                                     f"differ by {row['cpu_err']:.3e} (limit "
                                     f"{SCORE_ATOL})")
        out["variants"][variant] = row
        del pred
    out["quant"] = _serve_ft_quant(weights, request)
    print(f"[serve-ft] FrameTransformer bf16 (u8 frames {FT_BUCKET} x "
          f"{FT_SEQ} x 224² and clips {FT_BUCKET} x {FT_SEQ} x {FT_FRAMES} x "
          f"112², seeded weights) behind Predictor(buckets=({FT_BUCKET},)): "
          f"kernel-3 launches a call by head dim, all on its streamed body, "
          f"none of kernel 4; " + "; ".join(
              f"{v}: {r['heads'][448]} at 448 + {r['heads'][224]} at 224, "
              f"{r['ms']:.2f} ms a call, {r['clips_per_s']:.1f} clips/s"
              for v, r in out["variants"].items())
          + f" (best of 3 windows of 3 calls on device-resident input, host "
          f"clock) | distil: device {out['variants']['distil']['device_ms']:.3f}"
          f" ms a call, busy {out['variants']['distil']['busy']:.1%}; card vs "
          f"CPU at one request {out['variants']['distil']['cpu_err']:.3e} "
          f"(limit {SCORE_ATOL}; the CPU took "
          f"{out['variants']['distil']['cpu_s']:.1f} s)", flush=True)
    return out


def _serve_ft_quant(weights: dict, request: dict) -> dict:
    """The ``frame`` variant behind Predictor(quantize=True) at bucket 8:
    the default policy quantizes the scene transformer's four qkv
    projections (896 → 2688), each on kernel 6's wgmma body, with kernel
    3's four launches beside them; the scores against the same quantized
    predictor on the CPU (unfused int8 products) at the int8 serving gate;
    ms a call against the bf16 predictor's."""
    import torch

    from devt_tpu_torch.models.frame_transformer import FrameTransformer
    from devt_tpu_torch.ops.quant import int8_matmul_fused
    from devt_tpu_torch.serve import Predictor

    cfg = _ft_config("frame")
    keys = FrameTransformer(model="frame").state_dict().keys()
    frame = {k: weights[k] for k in keys}
    img = {"img": request["img"]}
    preds = {q: Predictor(cfg, frame, buckets=(FT_BUCKET,), quantize=q)
             for q in (True, False)}
    mm = int8_matmul_fused
    _zero_counts()
    got = preds[True].predict(img)["scores"]
    counts = _kernel_counts()
    launches = mm.launches
    if (mm.launches, mm.wgmma_launches) != (FT_LAYERS, FT_LAYERS) \
            or counts != _expect(k3=FT_LAYERS):
        raise AssertionError(
            f"serve-ft int8 frame: {mm.launches} int8-matmul launches "
            f"({mm.wgmma_launches} on the wgmma body), kernel launches "
            f"{counts}; expected {FT_LAYERS} of kernel 6 on its wgmma body "
            f"and {FT_LAYERS} of kernel 3")
    t0 = time.perf_counter()
    cpu = Predictor(cfg, frame, buckets=(FT_BUCKET,), quantize=True,
                    device="cpu").predict(img)["scores"]
    cpu_s = time.perf_counter() - t0
    err = float(abs(got - cpu).max())
    if not err <= QUANT_SCORE_ATOL or got.shape != (FT_BUCKET, FT_CLASSES):
        raise AssertionError(f"serve-ft int8 frame: card vs CPU scores "
                             f"differ by {err:.3e} (limit {QUANT_SCORE_ATOL})"
                             f", shape {got.shape}")
    tensors = {"img": torch.from_numpy(request["img"]).cuda()}
    ms = {}
    with torch.inference_mode():
        for q, pred in preds.items():
            pred.forward(tensors)
            torch.cuda.synchronize()
            windows = []
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(3):
                    pred.forward(tensors)
                torch.cuda.synchronize()
                windows.append((time.perf_counter() - t0) / 3)
            ms[q] = min(windows) * 1e3
    print(f"[serve-ft] frame int8 (Predictor(quantize=True), bucket "
          f"{FT_BUCKET}): {launches} launches of kernel 6 a call, all on its "
          f"wgmma body, and {counts['k3']} of kernel 3; card vs CPU "
          f"{err:.3e} (limit {QUANT_SCORE_ATOL}; the CPU took {cpu_s:.1f} "
          f"s); {ms[True]:.2f} ms a call against {ms[False]:.2f} in bf16 "
          f"(best of 3 windows of 3 calls, device-resident u8 frames, host "
          f"clock)", flush=True)
    return {"matmul_launches": launches, "cpu_err": err, "ms": ms[True],
            "bf16_ms": ms[False]}


class _ReluPattern:
    """One step's ReLU gates, replayed in later steps.  ``record``: every
    ReLU call (``torch.relu``, ``F.relu``) keeps the sign pattern of its
    input, in call order.  ``replay``: every ReLU call is ``x * mask`` of
    the recorded pattern, so its gradient passes where the recorded
    step's did.  A ReLU's gradient jumps where its input crosses 0: two
    steps that round apart (f32 and f64, the card and the CPU) differ by
    whole gated elements wherever an input lies within rounding of 0, and
    with the gates held what is left between them is their arithmetic."""

    def __init__(self):
        self.masks: list = []
        self.mode, self.at = "record", 0

    def __call__(self, mode: str) -> "_ReluPattern":
        self.mode, self.at = mode, 0
        if mode == "record":
            self.masks = []
        return self

    def __enter__(self):
        import torch
        import torch.nn.functional as F

        self._real = (torch.relu, F.relu)

        def relu(x, inplace=False):
            if self.mode == "record":
                self.masks.append(x.detach() > 0)
                return self._real[0](x)
            mask = self.masks[self.at]
            self.at += 1
            if mask.shape != x.shape:
                raise AssertionError(f"ReLU {self.at - 1}: input "
                                     f"{tuple(x.shape)}, recorded "
                                     f"{tuple(mask.shape)}")
            return x * mask.to(x.device, x.dtype)

        torch.relu = F.relu = relu
        return self

    def __exit__(self, *exc):
        import torch
        import torch.nn.functional as F

        torch.relu, F.relu = self._real
        if exc[0] is None and self.mode == "replay" \
                and self.at != len(self.masks):
            raise AssertionError(f"{self.at} ReLU calls replayed, "
                                 f"{len(self.masks)} recorded")


class _DistilTarget:
    """Keeps the teacher's argmax of the distillation loss a step takes
    (``seen``) and, given ``target``, trains the student against that
    instead (wraps ``models.losses.distillation_loss``)."""

    def __init__(self, target=None):
        self.target, self.seen = target, None

    def __enter__(self):
        import torch

        from devt_tpu_torch.models import losses

        self._real = losses.distillation_loss

        def loss(student, teacher):
            self.seen = torch.argmax(teacher.detach(), dim=-1).cpu()
            if self.target is None:
                return self._real(student, teacher)
            return losses.cross_entropy(student,
                                        self.target.to(student.device))

        losses.distillation_loss = loss
        return self

    def __exit__(self, *exc):
        from devt_tpu_torch.models import losses

        losses.distillation_loss = self._real


def _ft_grads(kind: str, device: str, relu: _ReluPattern | None = None,
              target=None) -> tuple[float, dict, dict, list]:
    """One distil step's loss, gradients (f64, on the CPU), new model
    state (none is checked: {}) and teacher argmax at dropout 0,
    bench.py:523's shape (batch 2, 4 scenes), in precision ``kind``
    ("bf16", "f32" or "f64", the last on the plain attention) on
    ``device``, from seeded weights, through ``forward_and_loss``;
    ``relu`` records or replays the ReLU gates, ``target`` (a teacher
    argmax) fixes the distillation target."""
    import contextlib

    import torch

    from devt_tpu_torch.models.frame_transformer import FrameTransformer
    from devt_tpu_torch.models.layers import DropoutRng
    from devt_tpu_torch.train.state import model_buffers
    from devt_tpu_torch.train.steps import forward_and_loss

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32,
             "f64": torch.float64}[kind]
    cfg = _ft_config(precision="bf16" if kind == "bf16" else "f32",
                     seq_len=FT_GRAD_SEQ)
    request = _ft_request(FT_TRAIN_BATCH, SEED + 21, FT_GRAD_SEQ)
    m = FrameTransformer(model="distil", seq_len=FT_GRAD_SEQ,
                         frame_len=FT_FRAMES, n_classes=FT_CLASSES,
                         dropout=0.0,
                         attention_impl="xla" if kind == "f64" else "auto",
                         dtype=dtype
                         ).init_weights(torch.Generator().manual_seed(SEED))
    m = m.to(device, torch.float64 if kind == "f64" else torch.float32)
    params = dict(m.named_parameters())
    batch = {k: torch.from_numpy(v).to(device) for k, v in request.items()}
    fixed = None if target is None else torch.tensor(target)
    with _DistilTarget(fixed) as distil, \
            relu if relu is not None else contextlib.nullcontext():
        loss, _, _ = forward_and_loss(
            m, cfg, {"params": params, **model_buffers(m)}, batch,
            DropoutRng(0), train=True)
        g = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return (loss.item(), {k: v.double().cpu() for k, v in zip(params, g)
                          if v is not None}, {}, distil.seen.tolist())


def _grad_check(tag: str, grads, chain: tuple[str, ...] = ()
                ) -> tuple[dict, str]:
    """One training step's gradients on the card against the CPU and the
    f64 step (on the card), per leaf as a share of the leaf's largest
    element in the f64 step.  ``grads(kind, device, relu=, target=)``
    gives a step's (loss, gradients, new model state, target): ``kind``
    "f64", "f32" or "bf16"; ``relu`` records or replays the ReLU gates
    (_ReluPattern); ``target``, where the step has one (FrameTransformer's
    teacher argmax, _DistilTarget), fixes it to the f64 step's.

    The f32 and bf16 steps run free and held to the f64 step's gates and
    target; the gates are on the held steps.  f32: every leaf card vs CPU
    within PTN_GRAD_RTOL, the new model state within 1e-4 of its largest
    element.  bf16: every leaf card vs CPU within GRAD_RTOL, but in
    ``chain``, the leaves (by prefix) of a BatchNorm backbone trained on
    batch statistics, the card no farther from the f64 step than the CPU
    is, plus GRAD_RTOL, leaf by leaf.

    Free, the steps hold none of this: rounding moves the ReLU inputs that
    lie near 0 across it, and each such element passes or stops a whole
    gradient term.  Held, f32 agrees to about 1e-4 of a leaf; through a
    bf16 backbone on batch statistics, bf16's own rounding still leaves
    leaves tenths of a leaf off the f64 step, on the card and on the CPU
    alike, and two such steps differ leaf by leaf by up to 0.1, so the
    chain is held against f64 and not card vs CPU.
    tests/test_torch_bf16_chain.py holds the port's bf16 R(2+1)D-18
    gradient to JAX's own, leaf by leaf, and tests/test_torch_bf16_conv.py
    the CPU's bf16 convolutions to f64 (ROADMAP.md section 3).  The
    chain's distances are also printed as a share of the leaf's norm
    (root of the sum of squares), the first test's measure."""
    import torch

    pattern = _ReluPattern()
    ref_loss, ref, _, ref_target = grads("f64", "cuda",
                                         relu=pattern("record"))
    gaps, text, failed = {}, [], []
    for kind in ("f32", "bf16"):
        tol = PTN_GRAD_RTOL if kind == "f32" else GRAD_RTOL
        runs, seconds = {}, {}
        for mode in ("free", "held"):
            for device in ("cuda", "cpu"):
                t0 = time.perf_counter()
                runs[mode, device] = grads(
                    kind, device,
                    relu=pattern("replay") if mode == "held" else None,
                    target=ref_target if mode == "held" else None)
                seconds[mode, device] = time.perf_counter() - t0
        worst = {}
        for mode in ("free", "held"):
            card, cpu = runs[mode, "cuda"][1], runs[mode, "cpu"][1]
            if set(card) != set(ref) or set(cpu) != set(ref):
                raise AssertionError(f"{tag}: the card, the CPU and the f64 "
                                     f"step differ in which leaves have "
                                     f"gradients")
            rows, norms = [], []
            for name, want in ref.items():
                if not torch.isfinite(card[name]).all():
                    raise AssertionError(f"{tag}: non-finite {kind} "
                                         f"gradient of {name} ({mode})")
                scale = max(want.abs().max().item(), GRAD_FLOOR)

                def gap(a, b):
                    return (a - b).abs().max().item() / scale

                rows.append((gap(card[name], cpu[name]),
                             gap(card[name], want), gap(cpu[name], want),
                             name))
                if chain and name.startswith(chain):
                    norm = max(want.norm().item(), GRAD_FLOOR)
                    norms.append(((card[name] - want).norm().item() / norm,
                                  (cpu[name] - want).norm().item() / norm))
            rows.sort(reverse=True)
            in_chain = [r for r in rows if chain and r[3].startswith(chain)]
            rest = [r for r in rows if r not in in_chain]
            w = {"direct": rows[0][0], "direct_leaf": rows[0][3],
                 "card_f64": max(r[1] for r in rows),
                 "cpu_f64": max(r[2] for r in rows)}
            if in_chain:
                excess = max(in_chain, key=lambda r: r[1] - r[2])
                w.update(rest_direct=rest[0][0] if rest else 0.0,
                         rest_leaf=rest[0][3] if rest else "-",
                         chain_leaves=len(in_chain),
                         chain_direct=in_chain[0][0],
                         chain_card_f64=max(r[1] for r in in_chain),
                         chain_cpu_f64=max(r[2] for r in in_chain),
                         chain_excess=excess[1] - excess[2],
                         chain_excess_leaf=excess[3],
                         chain_past=sum(r[0] > tol for r in in_chain),
                         norm_card_f64=max(n[0] for n in norms),
                         norm_cpu_f64=max(n[1] for n in norms),
                         norm_card_mean=sum(n[0] for n in norms) / len(norms),
                         norm_cpu_mean=sum(n[1] for n in norms) / len(norms))
            worst[mode] = w
            if mode == "held":
                for d, c, u, n in rows:
                    held_to_f64 = kind == "bf16" and bool(chain) \
                        and n.startswith(chain)
                    if (c > u + tol) if held_to_f64 else (d > tol):
                        failed.append(f"{kind} {n}: card vs CPU {d:.3e}, "
                                      f"card vs f64 {c:.3e}, CPU vs f64 "
                                      f"{u:.3e}")
                print(f"[{tag}]   {kind} held, leaves farthest card vs CPU "
                      f"(card vs f64, CPU vs f64): " + "; ".join(
                          f"{n} {d:.3e} ({c:.3e}, {u:.3e})"
                          for d, c, u, n in rows[:4]), flush=True)
        if kind == "f32":
            card_state, cpu_state = runs["held", "cuda"][2], \
                runs["held", "cpu"][2]
            for k, v in cpu_state.items():
                err = (card_state[k] - v).abs().max().item()
                if not err <= 1e-4 * max(v.abs().max().item(), 1.0):
                    failed.append(f"f32 new model state {k}: card vs CPU "
                                  f"{err:.3e}")
        gaps[kind] = worst
        losses = {k: runs[k][0] for k in runs}

        def chain_text(w):
            if "chain_leaves" not in w:
                return ""
            return (f"; outside the chain card vs CPU {w['rest_direct']:.3e}"
                    f" at {w['rest_leaf']}; in the chain's "
                    f"{w['chain_leaves']} leaves card vs f64 "
                    f"{w['chain_card_f64']:.3e}, CPU vs "
                    f"f64 {w['chain_cpu_f64']:.3e}, card less CPU at most "
                    f"{w['chain_excess']:+.3e} at {w['chain_excess_leaf']}, "
                    f"{w['chain_past']} leaves past {tol} card vs CPU; as a "
                    f"share of the leaf's norm card vs f64 worst "
                    f"{w['norm_card_f64']:.3e} mean {w['norm_card_mean']:.3e}"
                    f", CPU vs f64 worst {w['norm_cpu_f64']:.3e} mean "
                    f"{w['norm_cpu_mean']:.3e}")

        text.append(
            f"{kind}: " + ", ".join(
                f"{mode} card vs CPU {w['direct']:.3e} at "
                f"{w['direct_leaf']}, card vs f64 {w['card_f64']:.3e}, CPU "
                f"vs f64 {w['cpu_f64']:.3e}{chain_text(w)}"
                for mode, w in worst.items())
            + (f"; target free card {runs['free', 'cuda'][3]} CPU "
               f"{runs['free', 'cpu'][3]}, f64 {ref_target}"
               if ref_target is not None else "")
            + f"; loss free card {losses['free', 'cuda']:.6f} CPU "
            f"{losses['free', 'cpu']:.6f}, held card "
            f"{losses['held', 'cuda']:.6f} CPU {losses['held', 'cpu']:.6f}, "
            f"f64 {ref_loss:.6f} (held: card {seconds['held', 'cuda']:.1f} "
            f"s, CPU {seconds['held', 'cpu']:.1f} s)")
    print(f"[{tag}]   gradients: {'; '.join(text)}", flush=True)
    if failed:
        raise AssertionError(f"{tag}: {len(failed)} gradient leaves outside "
                             f"the gates, held to the f64 step's ReLU gates"
                             f" and target: " + "; ".join(failed[:12]))
    return gaps, "; ".join(text) + f" ({len(pattern.masks)} ReLU gates)"


def phase_train_ft() -> dict:
    """FrameTransformer distil at full width, batch 2 (bench.py:523's
    batch at the model's 13 scenes), bf16, dropout 0.5, AdamW 1e-4:
    make_train_step and make_multi_step(8) on a fixed u8 batch; 8 launches
    each of kernels 3 and 4 a step (4 layers of each encoder), all on
    their streamed bodies; the eval loss falling on the fixed batch; the
    video backbone's BatchNorm statistics moving and the frozen image
    backbone's not; one step's gradients at dropout 0 and 4 scenes against
    the CPU in f32 and bf16; step ms, host enqueue ms, device ms, peak
    memory."""
    import torch

    from devt_tpu_torch.parallel.train_step import (make_eval_step,
                                                    make_multi_step,
                                                    make_train_step)
    from devt_tpu_torch.registry import build_model
    from devt_tpu_torch.train.optimizers import build_optimizer
    from devt_tpu_torch.train.state import TrainState, model_buffers

    cfg = _ft_config()
    model = build_model(cfg, torch.Generator().manual_seed(SEED)).cuda()
    buffers = model_buffers(model)
    state = TrainState.create(dict(model.named_parameters()),
                              build_optimizer(cfg), model_state=buffers)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _ft_request(FT_TRAIN_BATCH, SEED + 22).items()}
    stacked = {k: v[None].expand(MULTI_STEPS, *v.shape)
               for k, v in batch.items()}
    step = make_train_step(model, cfg)
    multi = make_multi_step(model, cfg, MULTI_STEPS)
    evaluate = make_eval_step(model, cfg)
    loss_before = evaluate(state, batch)[0].item()
    stats_before = {k: v.clone() for k, v in buffers.items()}

    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    with _HeadDims() as dims:
        state, first = step(state, batch, SEED)
        state, metrics = multi(state, stacked, SEED)
        torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = 1 + MULTI_STEPS
    counts = _kernel_counts()
    per_step = 2 * FT_LAYERS
    by_dim = {part: dims.by_dim(part) for part in ("fwd", "bwd")}
    want = {d: FT_LAYERS * steps for d in (224, 448)}
    if counts != _expect(k3=per_step * steps, k4=per_step * steps) \
            or by_dim != {"fwd": want, "bwd": want} \
            or _body_counts()["k3_streamed"] != counts["k3"] \
            or _body_counts()["k4_streamed"] != counts["k4"]:
        raise AssertionError(f"train-ft: launches {counts} in {steps} steps, "
                             f"by head dim {by_dim}, by body "
                             f"{_body_counts()}, expected {FT_LAYERS} of "
                             f"kernels 3 and 4 a step at each head dim on "
                             f"their streamed bodies")
    loss_after = evaluate(state, batch)[0].item()
    losses = (first["loss"].item(), metrics["loss"].item(), loss_after)
    if not all(map(math.isfinite, losses)) or state.step != steps \
            or not loss_after < loss_before:
        raise AssertionError(f"train-ft: eval loss {loss_before:.5f} before, "
                             f"{losses} during and after {state.step} steps")
    moved = {k for k, v in buffers.items() if not torch.equal(
        v, stats_before[k])}
    video = {k for k in buffers if k.startswith("vid_backbone.")}
    if moved != video or any(buffers[k] is not v
                             for k, v in state.model_state.items()):
        raise AssertionError(f"train-ft: BatchNorm statistics moved in "
                             f"{len(moved)} buffers, expected the video "
                             f"backbone's {len(video)} and no other")

    multi(state, stacked, SEED)[1]["loss"].item()
    windows, enqueue = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        state, metrics = multi(state, stacked, SEED)
        enqueue.append(time.perf_counter() - t0)
        metrics["loss"].item()
        windows.append(time.perf_counter() - t0)
    best = min(windows)
    step_ms = best / MULTI_STEPS * 1e3
    host_ms = enqueue[windows.index(best)] / MULTI_STEPS * 1e3
    rows, busy, wall_ms = _traced(lambda: step(state, batch, SEED))
    _print_profile(f"FrameTransformer distil train step, B={FT_TRAIN_BATCH}",
                   rows, busy, wall_ms, top=12)
    device_ms = sum(ms for _, ms, _ in rows)
    attn_ms = sum(ms for name, ms, _ in rows if name.startswith((
        "attention_bf16<224", "attention_bf16<448", "mha_bwd_delta",
        "mha_bwd_bf16<224", "mha_bwd_bf16<448")))
    print(f"[profile]   device total {device_ms:.3f} ms per step, of which "
          f"kernels 3 and 4 {attn_ms:.3f} "
          f"({sum(n for _, _, n in rows):.0f} launches)", flush=True)
    gaps, grad_text = _grad_check("train-ft", _ft_grads,
                                  ("vid_backbone.", "vid_cls"))
    print(f"[train-ft] FrameTransformer distil bf16 AdamW B={FT_TRAIN_BATCH}"
          f", {FT_SEQ} scenes, dropout {FT_DROPOUT}, u8 frames and clips: "
          f"{steps} steps (1 + make_multi_step({MULTI_STEPS})), kernel 3 "
          f"{counts['k3']} and kernel 4 {counts['k4']} launches, by head dim "
          f"{by_dim['fwd']} and {by_dim['bwd']} (all streamed); eval loss on "
          f"the fixed batch "
          f"{loss_before:.5f} -> {loss_after:.5f}; BatchNorm statistics "
          f"moved in the video backbone's {len(video)} buffers and no other; "
          f"gradients of one step at dropout 0 ({FT_GRAD_SEQ} scenes), "
          f"worst leaf as a share of its largest element in the f64 step, "
          f"free and held to the f64 step's ReLU gates and distillation "
          f"target (held: every leaf card vs CPU within {PTN_GRAD_RTOL} in "
          f"f32 and within {GRAD_RTOL} outside the video chain in bf16, "
          f"the chain's card vs f64 within CPU vs f64 + {GRAD_RTOL}): "
          f"{grad_text} | "
          f"{FT_TRAIN_BATCH / best * MULTI_STEPS:.2f} samples/s, step_ms="
          f"{step_ms:.3f}, host enqueue {host_ms:.3f} ms a step, device "
          f"{device_ms:.3f} ms a step (busy {busy:.1%}), peak device memory "
          f"{peak_gb:.2f} GiB (best of 3 windows of {MULTI_STEPS} steps, "
          f"host clock)", flush=True)
    return {"counts": counts, "by_dim": by_dim, "step_ms": step_ms,
            "host_ms": host_ms, "device_ms": device_ms, "peak_gb": peak_gb,
            "gaps": gaps}


def _family_config(name: str, **kw):
    """The rest of the family at Config's defaults: TPN with 19 classes,
    the LSTM's sizes fixed by the registry (13 scenes of 4608, 15
    classes), BasicMLP 2048 → 305, the contrastive encoder 2048 → 2048 →
    305 → 128; bf16, AdamW at FAMILY_LR."""
    from devt_tpu_torch.config import Config

    base = dict(model=name, seq_len=FT_SEQ, n_classes=FT_CLASSES,
                precision="bf16", opt="adamW", learning_rate=FAMILY_LR)
    return Config(**{**base, **kw})


def _family_request(name: str, n: int, seed: int) -> dict:
    """A batch of ``n`` as users send it, with labels: u8 frames for TPN
    (20 of 224² a sample), f32 expert rows for the others."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if name == "tpn":
        return {"img": rng.integers(0, 256, (n, TPN_FRAMES, 224, 224, 3),
                                    dtype=np.uint8),
                "label": (rng.random((n, FT_CLASSES)) < 0.3).astype(
                    np.float32)}
    if name == "lstm":
        return {"experts": rng.standard_normal((n, FT_SEQ, 4608),
                                               dtype=np.float32),
                "label": (rng.random((n, 15)) < 0.3).astype(np.float32)}
    if name == "basicmlp":
        return {"experts": rng.standard_normal((n, 2048), dtype=np.float32),
                "label": rng.integers(0, 305, (n,))}
    return {"x_i": rng.standard_normal((n, 2048), dtype=np.float32),
            "x_j": rng.standard_normal((n, 2048), dtype=np.float32),
            "label": np.zeros((n, 1), np.float32)}


def phase_serve_family() -> dict:
    """TPN (bucket 8: 8 x 20 u8 frames of 224²), the LSTM and BasicMLP
    (bucket 32) at full width behind Predictor in bf16, seeded weights: no
    kernel launch (cuDNN and cuBLAS only), the scores of their kind
    (probabilities, sigmoid, softmax), card vs CPU on the same bucket
    within SCORE_ATOL; requests/s and ms a call through predict (upload
    and download included), best of 3 windows of 3 calls; a profile of
    TPN's forward."""
    import numpy as np
    import torch

    from devt_tpu_torch.registry import build_model
    from devt_tpu_torch.serve import Predictor

    out = {}
    for name, bucket in (("tpn", TPN_BUCKET), ("lstm", FAMILY_BUCKET),
                         ("basicmlp", FAMILY_BUCKET)):
        cfg = _family_config(name)
        weights = build_model(cfg, torch.Generator().manual_seed(
            SEED)).state_dict()
        request = _family_request(name, bucket, SEED + 30)
        request.pop("label")
        pred = Predictor(cfg, weights, buckets=(bucket,))
        _zero_counts()
        got = pred.predict(request)["scores"]
        if _kernel_counts() != _expect():
            raise AssertionError(f"serve-family {name}: kernel launches "
                                 f"{_kernel_counts()}, expected none")
        classes = {"tpn": FT_CLASSES, "lstm": 15, "basicmlp": 305}[name]
        if got.shape != (bucket, classes) or not np.isfinite(got).all() \
                or not ((got > 0) & (got < 1)).all() or (
                    name == "basicmlp"
                    and not np.allclose(got.sum(-1), 1.0, atol=1e-2)):
            raise AssertionError(f"serve-family {name}: bad scores, shape "
                                 f"{got.shape}")
        windows = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(3):
                pred.predict(request)
            windows.append((time.perf_counter() - t0) / 3)
        t0 = time.perf_counter()
        cpu = Predictor(cfg, weights, buckets=(bucket,),
                        device="cpu").predict(request)["scores"]
        row = {"ms": min(windows) * 1e3,
               "requests_per_s": bucket / min(windows),
               "cpu_err": float(abs(got - cpu).max()),
               "cpu_s": time.perf_counter() - t0}
        if not row["cpu_err"] <= SCORE_ATOL:
            raise AssertionError(f"serve-family {name}: card vs CPU scores "
                                 f"differ by {row['cpu_err']:.3e} (limit "
                                 f"{SCORE_ATOL})")
        tensors = {k: torch.from_numpy(v).cuda() for k, v in request.items()}
        with torch.inference_mode():
            rows, busy, wall = _traced(lambda: pred.forward(tensors))
        row["device_ms"], row["busy"] = sum(ms for _, ms, _ in rows), busy
        if name == "tpn":
            _print_profile(f"TPN forward, bucket {bucket}", rows, busy, wall,
                           top=8)
        out[name] = row
        del pred
    print(f"[serve-family] bf16, seeded weights, behind Predictor (no kernel "
          f"of the port on these paths): " + "; ".join(
              f"{name} bucket {b}: {out[name]['ms']:.3f} ms a call, "
              f"{out[name]['requests_per_s']:.1f} requests/s, device "
              f"{out[name]['device_ms']:.3f} ms (busy {out[name]['busy']:.1%})"
              f", card vs CPU {out[name]['cpu_err']:.3e}"
              for name, b in (("tpn", TPN_BUCKET), ("lstm", FAMILY_BUCKET),
                              ("basicmlp", FAMILY_BUCKET)))
          + f" (limit {SCORE_ATOL}; predict on host arrays, TPN's as u8 "
          f"frames, best of 3 windows of 3 calls, host clock; device ms from "
          f"a profiled forward)", flush=True)
    return out


def _family_model(name: str, dtype):
    """The registry's model at dropout 0, in ``dtype``, from the seed: the
    gradient checks compare steps whose dropout masks would differ."""
    import torch

    from devt_tpu_torch.models.basicmlp import BasicMLP
    from devt_tpu_torch.models.contrastive import ContrastiveEncoder
    from devt_tpu_torch.models.lstm import LSTMRegressor
    from devt_tpu_torch.models.tpn import TPN

    model = {"tpn": lambda: TPN(num_class=FT_CLASSES, dropout=(0.0, 0.0),
                                dtype=dtype),
             "lstm": lambda: LSTMRegressor(dropout=0.0, dtype=dtype),
             "basicmlp": lambda: BasicMLP(dtype=dtype),
             "contrastive": lambda: ContrastiveEncoder(dropout=0.0,
                                                       dtype=dtype)}[name]()
    return model.init_weights(torch.Generator().manual_seed(SEED))


def _family_grads(name: str, kind: str, device: str,
                  relu: _ReluPattern | None = None, target=None):
    """One training step's loss, gradients and new model state (f64, on
    the CPU) at dropout 0, in precision ``kind`` on ``device``; ``relu``
    records or replays the ReLU gates.  These steps have no target to fix
    (``target`` is None, and so is the fourth item returned)."""
    import contextlib

    import torch

    from devt_tpu_torch.models.layers import DropoutRng
    from devt_tpu_torch.train.state import model_buffers
    from devt_tpu_torch.train.steps import forward_and_loss

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32,
             "f64": torch.float64}[kind]
    cfg = _family_config(name, precision="bf16" if kind == "bf16" else "f32")
    m = _family_model(name, dtype).to(
        device, torch.float64 if kind == "f64" else torch.float32)
    params = dict(m.named_parameters())
    batch = {k: torch.from_numpy(v).to(device) for k, v in _family_request(
        name, FAMILY_GRAD_BATCH[name], SEED + 31).items()}
    with relu if relu is not None else contextlib.nullcontext():
        loss, _, state = forward_and_loss(
            m, cfg, {"params": params, **model_buffers(m)}, batch,
            DropoutRng(0), train=True)
        g = torch.autograd.grad(loss, list(params.values()))
    return (loss.item(), {k: v.double().cpu() for k, v in zip(params, g)},
            {k: v.double().cpu() for k, v in state.items()}, None)


def _loss_at_dropout_0(model, cfg, state, batch) -> float:
    """The training forward's loss on ``batch`` (BatchNorm on the batch's
    statistics), nothing updated, through ``model``, the registry's model
    built at dropout 0 (_family_model), with the state's parameters and
    statistics: what the steps lower, without the masks' noise."""
    import torch

    from devt_tpu_torch.models.layers import DropoutRng
    from devt_tpu_torch.train.steps import forward_and_loss

    with torch.no_grad():
        loss = forward_and_loss(
            model, cfg, {"params": state.params, **state.model_state},
            batch, DropoutRng(0), train=True)[0]
    return loss.item()


def phase_train_family() -> dict:
    """TPN at B=4 (80 u8 frames of 224²), the LSTM and BasicMLP at B=32,
    the contrastive encoder at B=256 (510 negatives a row), bf16, AdamW at
    FAMILY_LR: make_train_step and make_multi_step(8) on a fixed batch, no
    kernel launch; the loss on the fixed batch falling over the 33 steps,
    read by _loss_at_dropout_0 on the same model built at dropout 0 (the
    training loss, at TPN's dropout 0.6 and 0.5, jumps from step to step
    too much to show it); the BatchNorm statistics moving in every buffer;
    one step's gradients card vs CPU (_grad_check, TPN's backbone as the
    chain); samples/s, step ms, host enqueue ms, device ms of a profiled
    step, peak device memory."""
    import torch

    from devt_tpu_torch.parallel.train_step import (make_multi_step,
                                                    make_train_step)
    from devt_tpu_torch.registry import build_model, model_dtype
    from devt_tpu_torch.train.optimizers import build_optimizer
    from devt_tpu_torch.train.state import TrainState, model_buffers

    out = {}
    for name, b in (("tpn", TPN_TRAIN_BATCH), ("lstm", FAMILY_BUCKET),
                    ("basicmlp", FAMILY_BUCKET),
                    ("contrastive", CONTRASTIVE_BATCH)):
        cfg = _family_config(name, batch_size=b)
        model = build_model(cfg, torch.Generator().manual_seed(SEED)).cuda()
        quiet = _family_model(name, model_dtype(cfg)).cuda()
        buffers = model_buffers(model)
        before = {k: v.clone() for k, v in buffers.items()}
        state = TrainState.create(dict(model.named_parameters()),
                                  build_optimizer(cfg), model_state=buffers)
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in _family_request(name, b, SEED + 32).items()}
        stacked = {k: v[None].expand(MULTI_STEPS, *v.shape)
                   for k, v in batch.items()}
        step = make_train_step(model, cfg)
        multi = make_multi_step(model, cfg, MULTI_STEPS)
        loss_before = _loss_at_dropout_0(quiet, cfg, state, batch)
        _zero_counts()
        torch.cuda.reset_peak_memory_stats()
        state, first = step(state, batch, SEED)
        state, metrics = multi(state, stacked, SEED)
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        if _kernel_counts() != _expect():
            raise AssertionError(f"train-family {name}: kernel launches "
                                 f"{_kernel_counts()}, expected none")
        windows, enqueue = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            state, metrics = multi(state, stacked, SEED)
            enqueue.append(time.perf_counter() - t0)
            metrics["loss"].item()
            windows.append(time.perf_counter() - t0)
        losses = (first["loss"].item(), metrics["loss"].item())
        loss_after = _loss_at_dropout_0(quiet, cfg, state, batch)
        if not all(map(math.isfinite, losses + (loss_after,))) \
                or not loss_after < loss_before \
                or state.step != 1 + 4 * MULTI_STEPS:
            raise AssertionError(f"train-family {name}: loss at dropout 0 "
                                 f"{loss_before:.5f} before, {loss_after:.5f}"
                                 f" after {state.step} steps; training loss "
                                 f"{losses[0]:.5f} at the first step, "
                                 f"{losses[1]:.5f} over the last "
                                 f"{MULTI_STEPS}")
        moved = {k for k, v in buffers.items() if not torch.equal(
            v, before[k])}
        if moved != set(buffers):
            raise AssertionError(f"train-family {name}: BatchNorm statistics "
                                 f"moved in {len(moved)} of {len(buffers)} "
                                 f"buffers")
        best = min(windows)
        rows, busy, wall = _traced(lambda: step(state, batch, SEED))
        _print_profile(f"{name} train step, B={b}", rows, busy, wall, top=6)
        gaps, grad_text = _grad_check(
            f"train-family {name}", functools.partial(_family_grads, name),
            ("backbone.",) if name == "tpn" else ())
        out[name] = {"batch": b, "samples_per_s": b * MULTI_STEPS / best,
                     "step_ms": best / MULTI_STEPS * 1e3,
                     "host_ms": enqueue[windows.index(best)] / MULTI_STEPS
                     * 1e3,
                     "device_ms": sum(ms for _, ms, _ in rows), "busy": busy,
                     "launches": sum(n for _, _, n in rows),
                     "peak_gb": peak_gb, "loss": losses,
                     "loss_at_dropout_0": (loss_before, loss_after),
                     "buffers": len(buffers), "gaps": gaps}
        r = out[name]
        print(f"[train-family] {name} bf16 AdamW B={b}: "
              f"{r['samples_per_s']:.1f} samples/s, step_ms="
              f"{r['step_ms']:.3f}, host enqueue {r['host_ms']:.3f} ms a "
              f"step, device {r['device_ms']:.3f} ms a step (busy "
              f"{busy:.1%}, {r['launches']:.0f} launches), peak device memory "
              f"{peak_gb:.2f} GiB (best of 3 windows of {MULTI_STEPS} steps, "
              f"host clock); loss on the fixed batch at dropout 0 "
              f"{loss_before:.5f} -> {loss_after:.5f} in {state.step} steps "
              f"(training loss "
              f"{losses[0]:.5f} at the first step, {losses[1]:.5f} over the "
              f"last {MULTI_STEPS}); "
              f"BatchNorm statistics moved in {len(moved)} of "
              f"{len(buffers)} buffers; gradients of one step at dropout 0 "
              f"(B={FAMILY_GRAD_BATCH[name]}), worst leaf as a share of its "
              f"largest element in the f64 step: {grad_text}", flush=True)
        del model, quiet, state, step, multi
    return out


def phase_family_rest() -> dict:
    """The expert extractor (ResNet-50 on 32 frames of 224², R3D-18 on 8
    clips of 16 x 112²) and collaborative gating ((8, 13) scenes of three
    experts, one 512 wide and two 2048, proj 2048, out 1024) at full width
    in f32, seeded weights, card vs CPU: the extractor within 1e-3 of the
    largest feature (sums in other orders through up to 50 convolutions),
    gating within 1e-4; ms a call by CUDA events."""
    import numpy as np
    import torch

    from devt_tpu_torch.models.collab_gating import CollaborativeGating
    from devt_tpu_torch.models.pretrained import EXPERT_DIMS, \
        EmbeddingExtractor

    rng = np.random.default_rng(SEED + 40)
    frames = rng.standard_normal((32, 224, 224, 3), dtype=np.float32)
    clips = rng.standard_normal((8, 16, 112, 112, 3), dtype=np.float32)
    cpu_ext = EmbeddingExtractor(seed=SEED, device="cpu")
    ext = EmbeddingExtractor(seed=None)
    for name, model in cpu_ext.models.items():
        ext.load_torch_state_dict(name, model.state_dict())
    out = {}
    for key, data, fwd in (("image", frames, "forward_img"),
                           ("location", frames, "forward_location"),
                           ("video", clips, "forward_video")):
        got = getattr(ext, fwd)(data)
        want = getattr(cpu_ext, fwd)(data)
        err = (got.cpu() - want).abs().max().item() / want.abs().max().item()
        pooled = ext.return_expert_for_key(key, data).cpu()
        if got.shape != (len(data), EXPERT_DIMS[key]) or not err <= 1e-3 \
                or not torch.allclose(pooled, got.cpu().mean(0), atol=1e-5,
                                      rtol=1e-4):
            raise AssertionError(f"family-rest extractor {key}: card vs CPU "
                                 f"{err:.3e} of the largest feature (limit "
                                 f"1e-3), shape {tuple(got.shape)}")
        x = torch.from_numpy(data).cuda()
        out[key] = {"err": err,
                    "ms": _time_ms(lambda: getattr(ext, fwd)(x), iters=5,
                                   warmup=1)}
    gen = torch.Generator().manual_seed(SEED)
    gating = CollaborativeGating(2048, 1024).init_weights(gen)
    experts = [torch.from_numpy(rng.standard_normal(
        (8, FT_SEQ, d), dtype=np.float32)) for d in (512, 2048, 2048)]
    want = gating(experts).detach()
    gating.cuda()
    cuda_experts = [e.cuda() for e in experts]
    with torch.no_grad():
        got = gating(cuda_experts)
        err = (got.cpu() - want).abs().max().item()
        ms = _time_ms(lambda: gating(cuda_experts))
    if got.shape != (8, FT_SEQ, 1024) or not err <= 1e-4:
        raise AssertionError(f"family-rest gating: card vs CPU {err:.3e} "
                             f"(limit 1e-4), shape {tuple(got.shape)}")
    out["gating"] = {"err": err, "ms": ms}
    print(f"[family-rest] f32, seeded weights, card vs CPU: extractor "
          + ", ".join(f"{k} {out[k]['err']:.3e} of the largest feature, "
                      f"{out[k]['ms']:.3f} ms a call" for k in EXPERT_DIMS)
          + f" (limit 1e-3; 32 frames of 224², 8 clips of 16 x 112²); "
          f"collaborative gating (8, {FT_SEQ}, 3 experts of 512, 2048, 2048 → "
          f"1024) {err:.3e} (limit 1e-4), {ms:.3f} ms a call (CUDA events)",
          flush=True)
    return out


# The entry phase: ViViT through devt_tpu_torch.main at run_bench's width
# (B=32, 16 x 224², bf16), 2 steps an epoch (SyntheticDataModule's 64
# samples), validation and a checkpoint every ENTRY_EVAL_EVERY epochs, the
# profiler over train steps 3-8; the resumed run starts from the first of
# those checkpoints.  PTN trains on a fake MMX expert corpus of
# ENTRY_MOVIES trailers (32 more to validate) at the reference's widths.
ENTRY_EPOCHS, ENTRY_EVAL_EVERY, ENTRY_PTN_EPOCHS, ENTRY_MOVIES = 8, 4, 2, 64


def _vivit_entry_args(name: str, **extra) -> list:
    args = {"model": "vivit", "data_set": "synthetic",
            "batch_size": TRAIN_BATCH, "frame_len": 16, "n_classes": 19,
            "opt": "adamW", "learning_rate": 1e-4, "precision": "bf16",
            "epochs": ENTRY_EPOCHS, "eval_every_epochs": ENTRY_EVAL_EVERY,
            "log_every": 2, "checkpoint_dir": f"ck_{name}",
            "save_path": "out", "name": name, "seed": SEED, **extra}
    return [t for k, v in args.items() for t in (f"--{k}", str(v))]


def _payload_tensors(path: str) -> dict:
    """Every tensor of a checkpoint: parameters, buffers and the
    optimizer's moments, by a name."""
    from devt_tpu_torch.train import checkpoint as ckpt

    payload = ckpt.load(path)
    out = {f"params/{k}": v for k, v in payload["params"].items()}
    out.update({f"model_state/{k}": v
                for k, v in payload["model_state"].items()})
    for i, part in enumerate(payload["opt_state"]):
        for key, val in part.items():
            if isinstance(val, list):
                out.update({f"opt/{i}/{key}/{j}": t
                            for j, t in enumerate(val)})
    return out


def _worst_gap(a: dict, b: dict) -> tuple[float, str]:
    if a.keys() != b.keys():
        raise AssertionError("entry: the checkpoints hold other tensors")
    gaps = {k: (a[k].float() - b[k].float()).abs().max().item() for k in a}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def _trace_window(path: str) -> dict:
    """The harness's profiled window, from its torch.profiler Chrome
    trace: device time (kernels, copies) and the window's wall span, in
    ms; and the host's time between one train step's launches and the
    next's, split by the harness's spans (``train/...``: the wait for a
    batch, the step's launches, the loss readback, an epoch's start) with
    the rest as ``other``, averaged apart over the intervals within an
    epoch and those that open one (they hold ``train/first_batch``)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    timed = [e for e in events if "ts" in e and "dur" in e]
    span = (max(float(e["ts"]) + float(e["dur"]) for e in timed)
            - min(float(e["ts"]) for e in timed)) / 1e3
    by_cat: dict = {}
    for e in timed:
        by_cat[e.get("cat")] = by_cat.get(e.get("cat"), 0.0) \
            + float(e["dur"]) / 1e3
    spans = sorted((float(e["ts"]), float(e["dur"]) / 1e3, e["name"])
                   for e in timed if e.get("cat") == "user_annotation"
                   and e["name"].startswith("train/"))
    starts = [ts for ts, _, name in spans if name == "train/step"]
    groups: dict = {"in_epoch": [], "epoch_first": []}
    for a, b in zip(starts, starts[1:]):
        row = {"interval": (b - a) / 1e3}
        for ts, dur, name in spans:
            if a <= ts < b:
                key = name.split("/", 1)[1]
                row[key] = row.get(key, 0.0) + dur
        row["other"] = row["interval"] - sum(
            v for k, v in row.items() if k != "interval")
        groups["epoch_first" if "first_batch" in row
               else "in_epoch"].append(row)
    means = {}
    for group, rows in groups.items():
        if not rows:
            raise AssertionError(f"entry: no {group} interval in {path}")
        keys = sorted({k for r in rows for k in r})
        means[group] = {k: sum(r.get(k, 0.0) for r in rows) / len(rows)
                        for k in keys}
        means[group]["n"] = len(rows)
    return {"kernel_ms": by_cat.get("kernel", 0.0),
            "copy_ms": by_cat.get("gpu_memcpy", 0.0)
            + by_cat.get("gpu_memset", 0.0), "span_ms": span,
            "steps": len(starts), **means}


def _split_text(row: dict) -> str:
    parts = ", ".join(f"{k} {row[k]:.3f}" for k in
                      ("epoch_start", "first_batch", "next_batch", "step",
                       "readback", "other") if k in row)
    return f"{row['interval']:.3f} ms ({row['n']} intervals: {parts})"


def _add_counts(*runs: dict) -> dict:
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def phase_entry() -> dict:
    """``devt_tpu_torch.main.main`` on the card: ViViT (synthetic) trained,
    validated, checkpointed and tested, then resumed from its middle
    checkpoint to the same end, bit for bit; PTN on a fake MMX expert
    corpus through the pinned placer, its checkpoint served by
    ``Predictor.from_checkpoint``.  Kernel launches of each run, the
    profiled window's host ms between steps by span and its device ms,
    StepTimer's mean, numpy's batch-assembly ms, the checkpoint snapshot
    and write ms."""
    import os
    import pickle
    import tempfile

    import numpy as np
    import torch

    from devt_tpu_torch import main as entry
    from devt_tpu_torch.config import MMX_GENRES_15
    from devt_tpu_torch.data import manifests
    from devt_tpu_torch.data.mmx_temporal import MMXTemporalDataset
    from devt_tpu_torch.data.synthetic import write_fake_expert_corpus
    from devt_tpu_torch.registry import build_model, example_batch
    from devt_tpu_torch.serve import Predictor
    from devt_tpu_torch.train import checkpoint as ckpt
    from devt_tpu_torch.train.optimizers import build_optimizer
    from devt_tpu_torch.train.state import TrainState, model_buffers

    cwd = os.getcwd()
    tmp = tempfile.TemporaryDirectory()
    os.chdir(tmp.name)
    try:
        steps = ENTRY_EPOCHS * 2
        depth = 4
        _zero_counts()
        t0 = time.perf_counter()
        results = entry.main(_vivit_entry_args("vivit_a",
                                               profile_dir="prof"))
        run_s = time.perf_counter() - t0
        counts_a, bodies_a = _kernel_counts(), _body_counts()
        # forward: the train steps, 2 validations and the test, a batch
        # each; backward: the train steps
        if counts_a["k2"] != depth * steps \
                or counts_a["k1"] != depth * (steps + ENTRY_EPOCHS
                                              // ENTRY_EVAL_EVERY + 1) \
                or bodies_a["k1_wgmma"] != counts_a["k1"] \
                or bodies_a["k2_wgmma"] != counts_a["k2"] \
                or any(v for k, v in counts_a.items() if k not in ("k1",
                                                                   "k2")):
            raise AssertionError(f"entry vivit: launches {counts_a}")
        if not math.isfinite(results["test/loss"]):
            raise AssertionError(f"entry vivit: test {results}")
        final_a = ckpt.latest_checkpoint("ck_vivit_a")
        middle = os.path.join("ck_vivit_a", f"step_{steps // 2}")
        names = sorted(os.listdir("ck_vivit_a"))
        if not final_a.endswith(f"step_{steps}") or not os.path.isdir(
                middle) or not os.path.exists("out/vivit_a/logits.pkl"):
            raise AssertionError(f"entry vivit: checkpoints {names}")
        with open("runs/vivit_a/metrics.jsonl") as f:
            records = [json.loads(line) for line in f]
        train = [r for r in records if "train/loss" in r]
        val = [r for r in records if "val/loss" in r]
        if len(train) != steps // 2 or len(val) != 2 or not all(
                math.isfinite(r["train/loss"]) for r in train):
            raise AssertionError(f"entry vivit: {len(train)} train and "
                                 f"{len(val)} validation records")
        # the mean of every step interval after 2 warm-up steps:
        # validation, checkpoints and the profiled window included
        host_ms = train[-1]["step_ms_mean"]
        trace = _trace_window(os.path.join("prof", "trace.json"))
        if trace["steps"] != 6:
            raise AssertionError(f"entry vivit: {trace['steps']} steps in "
                                 f"the profiled window")

        # the resumed run, from the middle checkpoint, to the same end
        _zero_counts()
        entry.main(_vivit_entry_args("vivit_b", resume=middle))
        counts_b = _kernel_counts()
        if counts_b["k2"] != depth * steps // 2:
            raise AssertionError(f"entry resumed: launches {counts_b}")
        a = _payload_tensors(final_a)
        b = _payload_tensors(ckpt.latest_checkpoint("ck_vivit_b"))
        gap, leaf = _worst_gap(a, b)
        spread = None
        if gap > 0.0:
            # not bit for bit: the resumed run must fall within the
            # spread of two unbroken runs
            entry.main(_vivit_entry_args("vivit_c"))
            spread, spread_leaf = _worst_gap(
                a, _payload_tensors(ckpt.latest_checkpoint("ck_vivit_c")))
            print(f"[entry] two unbroken runs differ by {spread:.3e} at "
                  f"{spread_leaf}", flush=True)
            if not gap <= spread:
                raise AssertionError(
                    f"entry resumed: {gap:.3e} from the unbroken run at "
                    f"{leaf}, beyond two unbroken runs' {spread:.3e}")

        # the loader's draw of one batch, and the checkpoint's snapshot
        # and write, on the final state
        cfg = entry.parse_args(_vivit_entry_args("vivit_a"))
        t0 = time.perf_counter()
        for i in range(2):
            example_batch(cfg.replace(seed=SEED + i))
        assembly_ms = (time.perf_counter() - t0) / 2 * 1e3
        model = build_model(cfg).cuda()
        state = TrainState.create(dict(model.named_parameters()),
                                  build_optimizer(cfg),
                                  model_state=model_buffers(model))
        ckpt.restore(final_a, state)
        saver = ckpt.AsyncSaver()
        t0 = time.perf_counter()
        saver.save("ck_timed", state, cfg)
        snapshot_ms = (time.perf_counter() - t0) * 1e3
        saver.close()
        write_ms = (time.perf_counter() - t0) * 1e3 - snapshot_ms
        ckpt_mb = os.path.getsize(os.path.join(
            ckpt.latest_checkpoint("ck_timed"), ckpt.STATE_FILE)) / 2 ** 20
        del model, state
        window_steps = trace["steps"]
        print(f"[entry] ViViT through devt_tpu_torch.main (B={TRAIN_BATCH}, "
              f"16 x 224², bf16, AdamW 1e-4, synthetic): {steps} steps in "
              f"{ENTRY_EPOCHS} epochs, validation + checkpoint every "
              f"{ENTRY_EVAL_EVERY}, then test: {run_s:.1f} s, test loss "
              f"{results['test/loss']:.5f}; launches kernel 1 "
              f"{counts_a['k1']}, kernel 2 {counts_a['k2']} | profiled "
              f"window (train steps 3-8), host ms from one step's launches "
              f"to the next's: within an epoch "
              f"{_split_text(trace['in_epoch'])}; an epoch's first step "
              f"{_split_text(trace['epoch_first'])} | StepTimer's mean at "
              f"the last log (every interval after 2 warm-up steps, "
              f"validation, checkpoints and the profiler included) "
              f"{host_ms:.3f} ms | numpy's draw of one batch, timed apart "
              f"from the harness, {assembly_ms:.3f} ms | profiled window: "
              f"device kernels "
              f"{trace['kernel_ms'] / window_steps:.3f} ms a step, copies "
              f"{trace['copy_ms'] / window_steps:.3f} ms a step, "
              f"{(trace['kernel_ms'] + trace['copy_ms']) / trace['span_ms']:.1%}"
              f" of the window's {trace['span_ms']:.1f} ms busy | "
              f"checkpoint {ckpt_mb:.1f} MiB: snapshot {snapshot_ms:.3f} "
              f"ms, write {write_ms:.3f} ms", flush=True)
        print(f"[entry] resumed from step {steps // 2} to step {steps}: "
              f"launches kernel 1 {counts_b['k1']}, kernel 2 "
              f"{counts_b['k2']}; every parameter, buffer and moment "
              + ("equal bit for bit to the unbroken run's" if gap == 0.0
                 else f"within {gap:.3e} of the unbroken run's at {leaf} "
                 f"(two unbroken runs: {spread:.3e})"), flush=True)

        # PTN on a fake MMX expert corpus at the reference's widths
        train_pkl, val_pkl = write_fake_expert_corpus(
            "mmx", n_movies=ENTRY_MOVIES, scenes_per_movie=PTN_SEQ,
            experts=PTN_EXPERTS, seed=SEED)
        ptn_args = {"model": "ptn", "data_set": "mmx",
                    "train_manifest": train_pkl, "val_manifest": val_pkl,
                    "batch_size": PTN_TRAIN_BATCH, "seq_len": PTN_SEQ,
                    "nlayers": PTN_LAYERS, "nhid": PTN_WIDTH,
                    "input_dimension": PTN_WIDTH, "nhead": PTN_HEADS,
                    "experts": ",".join(PTN_EXPERTS), "opt": "adamW",
                    "learning_rate": 1e-4, "precision": "bf16",
                    "dropout": 0.0, "epochs": ENTRY_PTN_EPOCHS,
                    "log_every": 1, "checkpoint_dir": "ck_ptn",
                    "save_path": "out", "name": "ptn", "seed": SEED}
        argv = [t for k, v in ptn_args.items() for t in (f"--{k}", str(v))]
        _zero_counts()
        t0 = time.perf_counter()
        ptn_results = entry.main(argv)
        ptn_s = time.perf_counter() - t0
        counts_ptn, bodies_ptn = _kernel_counts(), _body_counts()
        ptn_steps = ENTRY_PTN_EPOCHS * ENTRY_MOVIES // PTN_TRAIN_BATCH
        # dropout 0, bf16, head dim 256, 14 tokens: kernels 3's and 4's
        # packed bodies
        if counts_ptn["k4"] < ptn_steps or counts_ptn["k4"] % ptn_steps \
                or bodies_ptn["k4_packed"] != counts_ptn["k4"] \
                or bodies_ptn["k3_packed"] != counts_ptn["k3"] \
                or counts_ptn["k3"] <= counts_ptn["k4"] \
                or not math.isfinite(ptn_results["test/loss"]):
            raise AssertionError(f"entry ptn: launches {counts_ptn}, "
                                 f"{ptn_results}")
        # the checkpoint served: the trained state's test scores (the
        # TransformerEval pickle) from Predictor.from_checkpoint, equal
        pcfg = entry.parse_args(argv)
        table = manifests.clean_mmx_temporal(
            manifests.load_manifest(val_pkl), MMX_GENRES_15)
        ds = MMXTemporalDataset(table, pcfg, "test")
        n = len(ds) // PTN_TRAIN_BATCH * PTN_TRAIN_BATCH
        request = {"experts": np.stack([ds[i]["experts"] for i in range(n)])}
        with open("out/ptn/logits.pkl", "rb") as f:
            trained = pickle.load(f)
        served = Predictor.from_checkpoint(
            pcfg, ckpt.latest_checkpoint("ck_ptn"),
            buckets=(PTN_TRAIN_BATCH,)).predict(request)["scores"]
        if served.shape != trained.shape:
            raise AssertionError(f"entry ptn: Predictor.from_checkpoint "
                                 f"scores {served.shape}, the trained "
                                 f"state's {trained.shape}")
        if not np.array_equal(served, trained):
            raise AssertionError(
                f"entry ptn: Predictor.from_checkpoint's scores differ "
                f"from the trained state's by "
                f"{np.abs(served - trained).max():.3e}")
        print(f"[entry] PTN through devt_tpu_torch.main (mmx: {ENTRY_MOVIES} "
              f"fake trailers of {PTN_SEQ} scenes, experts "
              f"{', '.join(PTN_EXPERTS)} at widths 512 and 2048 padded to "
              f"2048, B={PTN_TRAIN_BATCH}, width {PTN_WIDTH}, {PTN_LAYERS} "
              f"layers, bf16, pinned placer): {ptn_steps} steps, test loss "
              f"{ptn_results['test/loss']:.5f}, {ptn_s:.1f} s; launches "
              f"kernel 3 {counts_ptn['k3']}, kernel 4 {counts_ptn['k4']}; "
              f"Predictor.from_checkpoint's scores on the {n} test rows "
              f"equal to the trained state's", flush=True)
    finally:
        os.chdir(cwd)
        tmp.cleanup()
    return {"counts": _add_counts(counts_a, counts_b, counts_ptn),
            "host_ms": host_ms, "assembly_ms": assembly_ms,
            "trace": trace, "snapshot_ms": snapshot_ms,
            "write_ms": write_ms, "resume_gap": gap,
            "k4_packed": bodies_ptn["k4_packed"]}


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

    fwd = phase_kernel("bf16")
    phase_kernel("f32")
    serve = phase_serve()
    bwd = phase_kernel_bwd("bf16")
    phase_kernel_bwd("f32")
    phase_dropout()
    train = phase_train()
    quant = phase_kernel_quant("bf16")
    phase_kernel_quant("f32")
    matmul = phase_int8_matmul(3 * PTN_WIDTH)
    phase_int8_matmul(PTN_WIDTH)
    # the shape the PTN serving path launches (S = 14, unpadded) gives the
    # kernels line its numbers; S = 16 is the TPU wrapper's padded shape
    mha = phase_mha("bf16", PTN_ROWS, PTN_SEQ + 1, PTN_HEADS,
                    PTN_WIDTH // PTN_HEADS, PTN_SEQ + 1)
    phase_mha("bf16", PTN_ROWS, 16, PTN_HEADS, PTN_WIDTH // PTN_HEADS,
              PTN_SEQ + 1)
    phase_mha("f32", PTN_ROWS, 16, PTN_HEADS, PTN_WIDTH // PTN_HEADS,
              PTN_SEQ + 1)
    phase_mha("bf16", B, S, HEADS, D // HEADS, KV_LEN)
    phase_mha("f32", B, S, HEADS, D // HEADS, KV_LEN)
    serve_int8 = phase_serve_int8(serve)
    ptn = phase_serve_ptn()
    # kernel 4 at the shape PTN training launches gives the kernels line
    # its numbers, with the dropout checks; then f32 and the ViT shape
    mha_bwd = phase_mha_bwd("bf16", PTN_TRAIN_BATCH, PTN_SEQ + 1, PTN_HEADS,
                            PTN_WIDTH // PTN_HEADS, PTN_SEQ + 1, dropout=True,
                            ptxas=True)
    phase_mha_bwd("f32", PTN_TRAIN_BATCH, PTN_SEQ + 1, PTN_HEADS,
                  PTN_WIDTH // PTN_HEADS, PTN_SEQ + 1)
    # the MoE blocks' shape at dropout, the other wgmma route
    mha_bwd_vit = phase_mha_bwd("bf16", B, S, HEADS, D // HEADS, KV_LEN,
                                dropout=True)
    # the longest sequence kernel 3 takes at PTN's head dim: several row
    # tiles and streamed chunks in kernel 4 (its streamed body)
    phase_mha_bwd("bf16", PTN_TRAIN_BATCH, 160, PTN_HEADS,
                  PTN_WIDTH // PTN_HEADS, 160)
    train_ptn = phase_train_ptn()
    half_fwd, half_bwd = phase_kernel_attn_half("bf16")
    phase_kernel_attn_half("f32")
    serve_moe = phase_serve_moe()
    train_moe = phase_train_moe()
    # kernels 9 and 11 at the main-path shapes give the kernels line its
    # numbers; then f32, and the shapes no earlier kernel takes
    flash9 = phase_flash("bf16", FLASH_SEQS, HEADS, FLASH_S9, FLASH_S9,
                         D // HEADS, FLASH_S9)
    phase_flash("f32", FLASH_SEQS, HEADS, FLASH_S9, FLASH_S9, D // HEADS,
                FLASH_S9)
    flash11 = phase_flash("bf16", FLASH_SEQS, HEADS, FLASH_S11, FLASH_S11,
                          D // HEADS, FLASH_KV11)
    phase_flash("f32", FLASH_SEQS, HEADS, FLASH_S11, FLASH_S11, D // HEADS,
                FLASH_KV11)
    for dtype in ("bf16", "f32"):
        phase_flash(dtype, 32, 3, 333, 333, 128, 320, timed=False)  # ragged
        phase_flash(dtype, 32, 2, 512, 512, 256, 500, timed=False)
        phase_flash(dtype, 32, 3, 40, 300, D // HEADS, 290, timed=False)
    flash10 = phase_flash_bwd("bf16", FLASH_SEQS, HEADS, FLASH_S9,
                              D // HEADS, FLASH_S9)
    phase_flash_bwd("f32", FLASH_SEQS, HEADS, FLASH_S9, D // HEADS, FLASH_S9)
    phase_flash_bwd("bf16", 32, 2, 512, 256, 500)
    phase_flash_bwd("f32", 32, 2, 512, 256, 500)
    eval_long = phase_eval_long()
    int8_unfused = phase_serve_int8_unfused()
    train_long = phase_train_long()
    # kernels 12 and 13 at the image-384 step's shape give the kernels line
    # its numbers; then f32, and ragged shapes
    flash_bwd = phase_flash_blocked_bwd("bf16", FLASH_SEQS, HEADS, FLASH_S11,
                                        FLASH_S11, D // HEADS, FLASH_KV11)
    phase_flash_blocked_bwd("f32", FLASH_SEQS, HEADS, FLASH_S11, FLASH_S11,
                            D // HEADS, FLASH_KV11)
    for dtype in ("bf16", "f32"):
        phase_flash_blocked_bwd(dtype, 32, 3, 40, 300, D // HEADS, 290,
                                timed=False)
        phase_flash_blocked_bwd(dtype, 8, 1, 600, 600, 256, 577, timed=False)
        phase_flash_blocked_bwd(dtype, 16, 2, 520, 520, 128, 519, timed=False)
    ring = phase_ring("bf16")
    phase_ring("f32")
    # FrameTransformer: kernels 3 and 4 at head dims 448 and 224, then the
    # model served (every variant) and trained (distil)
    mha_ft = phase_mha_ft()
    serve_ft = phase_serve_ft()
    train_ft = phase_train_ft()
    # the rest of the model family: no kernel of the port on its paths
    phase_serve_family()
    phase_train_family()
    phase_family_rest()
    # the entry point: the harness, checkpoints and resume, the host data
    entry_run = phase_entry()
    # the MoE and the later model paths' launches of the earlier kernels
    later_runs = (serve_moe["counts"], serve_moe["int8_counts"],
                  train_moe["counts"], train_moe["drop_counts"],
                  *int8_unfused["counts"], serve_ft["counts"],
                  train_ft["counts"], entry_run["counts"])

    def later(k):
        return sum(c[k] for c in later_runs)

    def entry(number, name, source, replaces, launches, m, **extra):
        return {"kernel": number, "name": name, "route": "cuda",
                "source": source, "replaces": replaces, "launches": launches,
                "max_abs_err": m["max_abs_err"], "ms": m["kernel_ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "library_ms": m["library_ms"],
                **extra}

    csrc = "devt_tpu_torch/ops/csrc/"

    def ft_rows(part):
        """Rows 3's and 4's FrameTransformer shapes (head dims 448 and
        224, the streamed bodies): each shape's numbers in the keys of the
        row, the SDPA backends that took it, and the launches at that head
        dim that the serving and training phases recorded (_HeadDims)."""
        rows = {}
        for encoder, m in mha_ft.items():
            shape = f"({FT_TRAIN_BATCH},{m['s']},{3 * m['heads'] * m['d']})"
            r = m["fwd"][FT_TRAIN_BATCH] if part == "fwd" else m["bwd"]
            serve = sum(v["heads"][m["d"]] for v in serve_ft["variants"]
                        .values())
            row = {k: r[k] for k in ("max_abs_err", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}
            row.update(shape=shape, heads=m["heads"], d=m["d"],
                       ms=r["kernel_ms"], sdpa_backends=m["sdpa_backends"],
                       launches=train_ft["by_dim"][part][m["d"]] + (
                           serve if part == "fwd" else 0))
            if part == "fwd":
                row["serve_bucket"] = {k: m["fwd"][FT_BUCKET][k] for k in (
                    "kernel_ms", "plain_ms", "bound_ms", "library_ms")}
            else:
                row["drop_ms"] = r["bwd_drop_ms"]
                row["fwd_drop_ms"] = r["fwd_drop_ms"]
            rows[encoder] = row
        return rows

    # in kernel order, 1 to 15, each with its number
    kernels = [
        # the products on block_sm90.cuh's wgmma body, the attention on
        # the one-shot body's normalise-after instance
        entry(1, "fused_vit_block_fwd", csrc + "block_sm90.cuh",
              "devt_tpu/ops/fused_block.py:177",
              serve["launches"] + train["fwd_launches"] + later("k1"),
              {**fwd, "max_abs_err": max(fwd["max_abs_err"].values())},
              entry_launches=entry_run["counts"]["k1"],
              launch_sources=[csrc + "fused_block_fwd.cu",
                              csrc + "block_sm90.cuh",
                              csrc + "flash_fwd_sm90.cuh"]),
        # the products on block_sm90.cuh's wgmma body, the attention
        # backward on the recompute and kernels 12's and 13's wgmma bodies
        entry(2, "fused_vit_block_bwd", csrc + "block_sm90.cuh",
              "devt_tpu/ops/fused_block.py:240",
              train["bwd_launches"] + later("k2"), bwd,
              entry_launches=entry_run["counts"]["k2"],
              launch_sources=[csrc + "fused_block_bwd.cu",
                              csrc + "block_sm90.cuh",
                              csrc + "block_bwd_parts.cuh",
                              csrc + "flash_bwd_sm90.cuh"]),
        # its main path (PTN) runs the packed wgmma body; the blocks the
        # fused kernels do not take at head dim 64, kernel 9's one-shot
        # instance; dropout, the streamed body
        entry(3, "fused_mha", csrc + "mha_fwd_sm90.cuh",
              "devt_tpu/ops/flash_attention.py:558",
              ptn["mha_launches"] + train_ptn["fwd_launches"] + later("k3"),
              mha, entry_launches=entry_run["counts"]["k3"],
              launch_sources=[csrc + "mha_fwd.cu",
                                   csrc + "mha_fwd_sm90.cuh",
                                   csrc + "flash_fwd_sm90.cuh",
                                   csrc + "attention_fwd.cuh"],
              frame_transformer=ft_rows("fwd")),
        # PTN training on the packed wgmma body; the MoE blocks at dropout
        # and the blocks the fused kernels do not take on kernels 12's and
        # 13's bodies; the ViT shape's reading beside the PTN one
        entry(4, "fused_mha_bwd", csrc + "mha_bwd_sm90.cuh",
              "devt_tpu/ops/flash_attention.py:589",
              train_ptn["bwd_launches"] + later("k4"), mha_bwd,
              bodies={"packed": train_ptn["k4_packed"]
                      + entry_run["k4_packed"],
                      "wgmma": train_moe["k4_wgmma"]
                      + int8_unfused["k4_wgmma"],
                      "streamed": train_ptn["bwd_launches"] + later("k4")
                      - train_ptn["k4_packed"] - entry_run["k4_packed"]
                      - train_moe["k4_wgmma"] - int8_unfused["k4_wgmma"]},
              drop_ms=mha_bwd["bwd_drop_ms"],
              entry_launches=entry_run["counts"]["k4"],
              vit={k: mha_bwd_vit[k] for k in (
                  "kernel_ms", "bwd_drop_ms", "plain_ms", "library_ms",
                  "bound_ms", "bound_by", "max_abs_err",
                  "bwd_drop_max_abs_err")},
              launch_sources=[csrc + "mha_bwd.cu", csrc + "mha_bwd_sm90.cuh",
                              csrc + "flash_bwd_sm90.cuh",
                              csrc + "attention_bwd.cuh"],
              frame_transformer=ft_rows("bwd")),
        # LN1 + qkv and out-projection + FFN on int8 and bf16 wgmma, the
        # attention on the one-shot body's normalise-after instance
        entry(5, "quant_fused_vit_block", csrc + "quant_block_fwd.cu",
              "devt_tpu/ops/quant.py:275",
              serve_int8["launches"] + later("k5"), quant,
              launch_sources=[csrc + "quant_block_fwd.cu",
                              csrc + "block_sm90.cuh",
                              csrc + "gemm_s8_sm90.cuh",
                              csrc + "block_attention.cuh",
                              csrc + "flash_fwd_sm90.cuh"]),
        # int_mm_ms: quantize + torch._int_mm + dequantize, a yardstick
        # beside F.linear's library_ms
        entry(6, "int8_matmul_fused", csrc + "gemm_s8_sm90.cuh",
              "devt_tpu/ops/quant.py:348",
              ptn["matmul_launches"] + serve_ft["quant"]["matmul_launches"],
              matmul,
              int_mm_ms=matmul["int_mm_ms"]),
        # composed_ms: the half composed of library calls (no one call
        # computes it, so library_ms stays null), by CUDA graph; its
        # attention launch runs the one-shot wgmma body, its other two
        # launches are attn_half.cu's
        entry(7, "fused_attn_half_fwd", csrc + "flash_fwd_sm90.cuh",
              "devt_tpu/ops/fused_block.py:556", later("k7"), half_fwd,
              composed_ms=half_fwd["composed_ms"],
              launch_sources=[csrc + "attn_half.cu",
                              csrc + "block_sm90.cuh",
                              csrc + "flash_fwd_sm90.cuh"]),
        entry(8, "fused_attn_half_bwd", csrc + "attn_half.cu",
              "devt_tpu/ops/fused_block.py:578", later("k8"), half_bwd,
              composed_ms=half_bwd["composed_ms"],
              launch_sources=[csrc + "attn_half.cu",
                              csrc + "block_sm90.cuh",
                              csrc + "block_bwd_parts.cuh",
                              csrc + "flash_bwd_sm90.cuh"]),
        entry(9, "flash_single_fwd", csrc + "flash_fwd_sm90.cuh",
              "devt_tpu/ops/flash_attention.py:390",
              int8_unfused["launches"], flash9),
        entry(10, "flash_single_bwd", csrc + "flash_bwd_sm90.cuh",
              "devt_tpu/ops/flash_attention.py:413", flash10["launches"],
              flash10),
        entry(11, "flash_fwd", csrc + "flash_fwd_sm90.cuh",
              "devt_tpu/ops/flash_attention.py:69",
              eval_long["launches"] + train_long["counts"]["k11"], flash11),
        entry(12, "flash_bwd_dq", csrc + "flash_bwd_sm90.cuh",
              "devt_tpu/ops/flash_attention.py:158",
              train_long["counts"]["k12"],
              {**flash_bwd, "kernel_ms": flash_bwd["dq_ms"],
               "bound_ms": flash_bwd["dq_bound_ms"],
               "bound_by": flash_bwd["dq_bound_by"]}),
        # SDPA's backward computes dq, dk and dv at once: it stands beside
        # kernel 12, which it is named with, and kernel 13 has none
        entry(13, "flash_bwd_dkv", csrc + "flash_bwd_sm90.cuh",
              "devt_tpu/ops/flash_attention.py:198",
              train_long["counts"]["k13"],
              {**flash_bwd, "kernel_ms": flash_bwd["dkv_ms"],
               "bound_ms": flash_bwd["dkv_bound_ms"],
               "bound_by": flash_bwd["dkv_bound_by"], "library_ms": None}),
        entry(14, "ring_step_fwd", csrc + "flash_fwd_sm90.cuh",
              "devt_tpu/ops/flash_attention.py:792", ring["launches"]["k14"],
              ring["fwd"]),
        # bf16 at head dims 16-64 on kernels 12's and 13's wgmma bodies
        entry(15, "ring_step_bwd", csrc + "flash_bwd_sm90.cuh",
              "devt_tpu/ops/flash_attention.py:814", ring["launches"]["k15"],
              ring["bwd"], launch_sources=[csrc + "ring_step.cu",
                                           csrc + "flash_bwd_sm90.cuh"])]
    for k in kernels:
        if k["launches"] < 1 or k.get("entry_launches", 1) < 1:
            raise AssertionError(f"{k['name']}: no launch on its path")
    print(json.dumps({"kernels": kernels}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
