"""Per-model forward + loss: port of ``devt_tpu/train/steps.py``.

One function dispatches on the model name and returns ``(loss, aux,
new_model_state)``.  ``aux`` carries ``probs`` (post-sigmoid/softmax
scores) and ``label`` for the epoch-end evaluators.  ``vivit``, ``ptn``,
``ptn_shared`` and the FrameTransformer variants are ported; the other
names raise until their models are (ROADMAP.md queue 1, item 5).  A
training forward of a ViViT with switch-MoE blocks adds their mean
load-balance loss, weighted by ``config.moe_aux_weight``, and reports it
as ``aux["moe_aux"]``.  FrameTransformer's loss is BCE on the logits, and
for ``distil`` plus the distillation loss (``aux``: ``base_loss``,
``distil_loss``, ``cossim``); a training forward returns its video
backbone's new BatchNorm statistics as ``new_model_state``.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from devt_tpu_torch.config import Config
from devt_tpu_torch.data.device_norm import maybe_dequantize_batch
from devt_tpu_torch.models import losses
from devt_tpu_torch.models.contrastive import l2_normalize
from devt_tpu_torch.models.frame_transformer import VARIANTS as FT_VARIANTS
from devt_tpu_torch.models.resnet import collect_batch_stats
from devt_tpu_torch.registry import PORTED_MODELS, model_dtype


def forward_and_loss(model: nn.Module, config: Config,
                     variables: Mapping[str, Any],
                     batch: Mapping[str, torch.Tensor], rng,
                     train: bool):
    """Returns (loss, aux, new_model_state).

    ``variables``: ``{"params": {name: tensor}, **model_state}`` — the
    tensors the forward runs with (``torch.func.functional_call``), so the
    loss is differentiable in ``variables["params"]``.  ``rng``: the
    forward's ``DropoutRng`` (``models/layers.py``) when training, else
    None.  u8 ``vid``/``img``/``vid_tokens`` batches are normalized here,
    on the device (``data/device_norm.py``).  ``ptn`` / ``ptn_shared`` take
    the ``experts`` (B, S, E, D) batch, FrameTransformer ``img`` (B, S, H,
    W, C) and ``vid`` (B, S, T, H, W, C), as its variant needs.

    ``model_state``, the items of ``variables`` other than ``params``, is
    keyed like ``state_dict`` (a BatchNorm's ``<path>.running_mean`` and
    ``.running_var``); the returned ``new_model_state`` has the same keys,
    with the statistics a training forward updated (detached)."""
    name = config.model
    if name not in PORTED_MODELS:
        raise NotImplementedError(
            f"no step logic for model {name!r} yet — ROADMAP.md queue 1, "
            f"item 5 (ported: {', '.join(PORTED_MODELS)})")
    batch = maybe_dequantize_batch(dict(batch), dtype=model_dtype(config))
    model_state = {k: v for k, v in variables.items() if k != "params"}
    tensors = {**variables["params"], **model_state}
    model.train(train)
    label = batch["label"]
    if name in FT_VARIANTS:
        return _frame_transformer_loss(model, name, tensors, model_state,
                                       batch, rng if train else None, train)
    if name in ("ptn", "ptn_shared"):
        args, kwargs = (batch["experts"],), {}
    # "vid_tokens": pre-patchified (B, T, N, p*p*c) clips, the layout the
    # native loader emits at decode time
    elif "vid_tokens" in batch:
        args, kwargs = (batch["vid_tokens"],), {"tokens_in": True}
    else:
        args, kwargs = (batch["vid"],), {}
    # the MoE blocks append their load-balance losses to this list, the
    # counterpart of flax's "losses" collection, collected when training
    moe_losses = None
    if name == "vivit":
        moe_losses = [] if train and getattr(model, "moe_experts", 0) else None
        kwargs["losses"] = moe_losses
    logits = torch.func.functional_call(
        model, tensors, args, {**kwargs, "rng": rng if train else None})
    if label.dim() == 1:       # single-label (MIT-style): CE, top-1
        loss = losses.cross_entropy(logits, label)
        probs = torch.softmax(logits, dim=-1)
    else:                      # multi-hot genres (MMX-style): BCE
        loss = losses.bce_with_logits(logits, label)
        probs = torch.sigmoid(logits)
    aux = {"probs": probs, "label": label}
    if moe_losses:
        # the mean of the per-layer losses, each the mean over row groups
        moe_aux = sum(moe_losses) / len(moe_losses)
        loss = loss + config.moe_aux_weight * moe_aux
        aux["moe_aux"] = moe_aux
    return loss, aux, model_state


def _frame_transformer_loss(model: nn.Module, name: str, tensors: dict,
                            model_state: dict, batch: Mapping, rng,
                            train: bool):
    """FrameTransformer's branch of ``forward_and_loss``: BCE-with-logits on
    the logits; ``distil`` adds the distillation loss of the distil-token
    logits against the teacher's argmax, and reports the cosine similarity
    of the student's and the teacher's logits."""
    with collect_batch_stats() as stats:
        out = torch.func.functional_call(
            model, tensors, (),
            {"img": batch.get("img"), "vid": batch.get("vid"), "rng": rng})
    label = batch["label"]
    loss = losses.bce_with_logits(out["logits"], label)
    aux = {"probs": torch.sigmoid(out["logits"]), "label": label,
           "embedding": out.get("embedding")}
    if name == "distil":
        dloss = losses.distillation_loss(out["distil_logits"],
                                         out["teacher_logits"])
        aux["base_loss"] = loss
        aux["distil_loss"] = dloss
        s = l2_normalize(out["logits"])
        t = l2_normalize(out["teacher_logits"])
        aux["cossim"] = (s * t).sum(dim=-1).mean()
        loss = loss + dloss
    new_state = dict(model_state)
    if stats:
        path = {m: n for n, m in model.named_modules()}
        for m, (mean, var) in stats.items():
            new_state[f"{path[m]}.running_mean"] = mean
            new_state[f"{path[m]}.running_var"] = var
    return loss, aux, new_state
