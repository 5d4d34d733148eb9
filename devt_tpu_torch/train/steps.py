"""Per-model forward + loss: port of ``devt_tpu/train/steps.py``.

One function dispatches on the model name and returns ``(loss, aux,
new_model_state)``.  ``aux`` carries ``probs`` (post-sigmoid/softmax
scores) and ``label`` for the epoch-end evaluators.  Every name the
registry builds has its branch:

  * ``vivit``, ``ptn``, ``ptn_shared``: cross-entropy and softmax on
    single labels, BCE-with-logits and sigmoid on multi-hot ones; a
    training forward of a ViViT with switch-MoE blocks adds their mean
    load-balance loss, weighted by ``config.moe_aux_weight``, and reports
    it as ``aux["moe_aux"]``;
  * the FrameTransformer variants: BCE on the logits, and for ``distil``
    the distillation loss too (``aux``: ``base_loss``, ``distil_loss``,
    ``cossim``);
  * ``lstm``: sigmoid, then BCE; ``tpn``: BCE on the probabilities it
    returns; ``basicmlp``: cross-entropy on integer labels;
  * ``contrastive``: two passes, one a view, each with its own dropout
    stream, the second on the BatchNorm statistics the first left; then
    ``contrastive_loss`` of the L2-normalised projections; with
    ``axis_name`` (the DP step) the projections of every rank, gathered,
    so that each rank scores its positives against the global pool.

A training forward of a model with BatchNorm returns its new statistics
as ``new_model_state``.
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
from devt_tpu_torch.parallel.collectives import all_gather_rows
from devt_tpu_torch.registry import KNOWN_MODELS, model_dtype


def forward_and_loss(model: nn.Module, config: Config,
                     variables: Mapping[str, Any],
                     batch: Mapping[str, torch.Tensor], rng,
                     train: bool, axis_name: str | None = None):
    """Returns (loss, aux, new_model_state).

    ``variables``: ``{"params": {name: tensor}, **model_state}`` — the
    tensors the forward runs with (``torch.func.functional_call``), so the
    loss is differentiable in ``variables["params"]``.  ``rng``: the
    forward's ``DropoutRng`` (``models/layers.py``) when training, else
    None.  u8 ``vid``/``img``/``vid_tokens`` batches are normalized here,
    on the device (``data/device_norm.py``).  ``ptn`` / ``ptn_shared`` take
    the ``experts`` (B, S, E, D) batch, FrameTransformer ``img`` (B, S, H,
    W, C) and ``vid`` (B, S, T, H, W, C), as its variant needs; ``lstm``
    ``experts`` (B, S, 4608), ``basicmlp`` ``experts`` (B, D) with integer
    labels, ``tpn`` ``img`` (B, 20, H, W, C), ``contrastive`` the two views
    ``x_i`` and ``x_j`` (B, D).

    ``model_state``, the items of ``variables`` other than ``params``, is
    keyed like ``state_dict`` (a BatchNorm's ``<path>.running_mean`` and
    ``.running_var``); the returned ``new_model_state`` has the same keys,
    with the statistics a training forward updated (detached).

    ``axis_name`` is set when the body runs as a replica of the DP step
    (inside ``parallel.collectives.axis_scope``); only the contrastive
    loss reads it."""
    name = config.model
    if name not in KNOWN_MODELS:
        raise ValueError(f"no step logic for model {name!r}")
    batch = maybe_dequantize_batch(dict(batch), dtype=model_dtype(config))
    model_state = {k: v for k, v in variables.items() if k != "params"}
    tensors = {**variables["params"], **model_state}
    model.train(train)
    label = batch["label"]
    rng = rng if train else None
    if name in FT_VARIANTS:
        return _frame_transformer_loss(model, name, tensors, model_state,
                                       batch, rng)
    if name == "contrastive":
        return _contrastive_loss(model, config, tensors, model_state, batch,
                                 rng, train, axis_name)
    if name in _FAMILY:
        return _FAMILY[name](model, config, tensors, model_state, batch,
                             rng, train)
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
    logits = torch.func.functional_call(model, tensors, args,
                                        {**kwargs, "rng": rng})
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


def _call(model: nn.Module, tensors: dict, model_state: dict, args: tuple,
          kwargs: dict):
    """``model`` on ``tensors``, and ``model_state`` with the BatchNorm
    statistics a training forward updated (by ``state_dict`` name)."""
    with collect_batch_stats() as stats:
        out = torch.func.functional_call(model, tensors, args, kwargs)
    new_state = dict(model_state)
    if stats:
        path = {m: n for n, m in model.named_modules()}
        for m, (mean, var) in stats.items():
            new_state[f"{path[m]}.running_mean"] = mean
            new_state[f"{path[m]}.running_var"] = var
    return out, new_state


def _frame_transformer_loss(model: nn.Module, name: str, tensors: dict,
                            model_state: dict, batch: Mapping, rng):
    """FrameTransformer's branch of ``forward_and_loss``: BCE-with-logits on
    the logits; ``distil`` adds the distillation loss of the distil-token
    logits against the teacher's argmax, and reports the cosine similarity
    of the student's and the teacher's logits."""
    out, new_state = _call(model, tensors, model_state, (),
                           {"img": batch.get("img"), "vid": batch.get("vid"),
                            "rng": rng})
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
    return loss, aux, new_state


def _lstm_loss(model, config, tensors, model_state, batch, rng, train):
    """Sigmoid, then BCE on the probabilities, as the reference does."""
    logits, new_state = _call(model, tensors, model_state,
                              (batch["experts"],),
                              {"train": train, "rng": rng})
    probs = torch.sigmoid(logits)
    loss = losses.bce(probs, batch["label"])
    return loss, {"probs": probs, "label": batch["label"]}, new_state


def _tpn_loss(model, config, tensors, model_state, batch, rng, train):
    """TPN returns probabilities averaged over its scales: BCE on them."""
    probs, new_state = _call(model, tensors, model_state, (batch["img"],),
                             {"train": train, "rng": rng})
    loss = losses.bce(probs, batch["label"])
    return loss, {"probs": probs, "label": batch["label"]}, new_state


def _basicmlp_loss(model, config, tensors, model_state, batch, rng, train):
    logits, new_state = _call(model, tensors, model_state,
                              (batch["experts"],), {"train": train})
    loss = losses.cross_entropy(logits, batch["label"])
    return loss, {"probs": torch.softmax(logits, dim=-1),
                  "label": batch["label"]}, new_state


def _contrastive_loss(model, config, tensors, model_state, batch, rng,
                      train, axis_name=None):
    """The reference's two passes: a dropout stream a view, and view j's
    pass on the BatchNorm statistics view i's left, so a training step's
    new statistics have the momentum applied twice.  With ``axis_name``
    the normalised projections are gathered across the ranks; with the DP
    step's mean of the gradients the parameter gradient is the
    single-device global-batch gradient (``all_gather_rows``' backward
    sums the ranks' cotangents of this rank's rows)."""
    rng_i, rng_j = rng.split() if rng is not None else (None, None)
    (emb_i, proj_i), state = _call(model, tensors, model_state,
                                   (batch["x_i"],),
                                   {"train": train, "rng": rng_i})
    (_, proj_j), state = _call(model, {**tensors, **state}, state,
                               (batch["x_j"],),
                               {"train": train, "rng": rng_j})
    z_i, z_j = l2_normalize(proj_i), l2_normalize(proj_j)
    if axis_name is not None:
        z_i = all_gather_rows(z_i, axis_name)
        z_j = all_gather_rows(z_j, axis_name)
    loss = losses.contrastive_loss(z_i, z_j, temperature=config.temperature)
    label = batch["label"]
    return loss, {"embedding": emb_i, "label": label,
                  "probs": torch.zeros((label.shape[0], 1),
                                       device=label.device)}, state


_FAMILY = {"lstm": _lstm_loss, "tpn": _tpn_loss,
           "basicmlp": _basicmlp_loss}
