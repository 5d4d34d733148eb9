"""Epoch-end evaluation callbacks: port of ``devt_tpu/train/callbacks.py``.

Functional twins of the reference's Lightning callbacks
(src/callbacks/callbacks.py), on the port's numpy metrics:

  * :class:`TransformerEval` — threshold-swept sample-F1, mAP (samples +
    weighted), per-class report at 0.3; on test, dumps labels/logits
    pickles (callbacks.py:27-82).
  * :class:`MITEval` — top-1 accuracy over the running buffers
    (callbacks.py:85-102).
  * :class:`DisplayResults` — exports ``{path, embedding, predicted,
    actual}`` per sample to an ``embed_dict`` pickle, feeding the retrieval
    tool (callbacks.py:105-144).
  * :class:`SSLOnlineEval` — online probe for the contrastive model: a
    small MLP trained with SGD on detached embeddings each train batch,
    evaluated with the F1/precision/recall/mAP sweep (callbacks.py:147-291).

Callbacks receive the host-side :class:`RunningBuffers` the harness fills
from eval-step aux.
"""

from __future__ import annotations

import os
import pickle
from typing import Sequence

import numpy as np
import torch

from devt_tpu_torch.config import MMX_GENRES_15, MMX_GENRES_19
from devt_tpu_torch.models import losses
from devt_tpu_torch.train import metrics as M


class Callback:
    def on_validation_epoch_end(self, buffers, logger, step): ...
    def on_test_epoch_end(self, buffers, logger, step): ...
    def on_train_batch_end(self, aux, logger, step): ...


class TransformerEval(Callback):
    def __init__(self, target_names: Sequence[str] = MMX_GENRES_19,
                 out_dir: str = "."):
        self.target_names = target_names
        self.out_dir = out_dir

    def on_validation_epoch_end(self, buffers, logger, step):
        if not len(buffers):
            return {}
        labels, probs = buffers.concatenated()
        scores = {f"val/online/{k}": v
                  for k, v in M.f1_threshold_sweep(labels, probs).items()}
        scores["sklearn apr"] = M.average_precision(labels, probs, "samples")
        scores["sklearn apr weighted"] = M.average_precision(
            labels, probs, "weighted")
        logger.log(scores, step)
        names = self.target_names[: labels.shape[1]]
        logger.log_text("val/report", M.genre_report(labels, probs, names),
                        step)
        buffers.reset()
        return scores

    def on_test_epoch_end(self, buffers, logger, step):
        if not len(buffers):
            return {}
        labels, probs = buffers.concatenated()
        # the reference pickles both buffers on test end (callbacks.py:76-79
        # — it writes labels twice; evident intent, labels + logits)
        os.makedirs(self.out_dir, exist_ok=True)
        with open(os.path.join(self.out_dir, "labels.pkl"), "wb") as fp:
            pickle.dump(labels, fp)
        with open(os.path.join(self.out_dir, "logits.pkl"), "wb") as fp:
            pickle.dump(probs, fp)
        names = self.target_names[: labels.shape[1]]
        report = M.genre_report(labels, probs, names)
        logger.log_text("test/report", report, step)
        buffers.reset()
        return report


class MITEval(Callback):
    def __init__(self):
        self.best_acc = 0.0

    def on_validation_epoch_end(self, buffers, logger, step):
        if not len(buffers):
            return {}
        labels, probs = buffers.concatenated()
        acc = M.top1_accuracy(labels, probs)
        logger.log({"val/accuracy/epoch": acc}, step)
        self.best_acc = max(self.best_acc, acc)
        buffers.reset()
        return {"val/accuracy/epoch": acc}


class DisplayResults(Callback):
    def __init__(self, target_names: Sequence[str] = MMX_GENRES_15,
                 out_path: str = "embed_dict.pkl", threshold: float = 0.3):
        self.target_names = target_names
        self.out_path = out_path
        self.threshold = threshold

    def n_to_labels(self, vector):
        return [self.target_names[i] for i, x in enumerate(vector) if x]

    def on_test_epoch_end(self, buffers, logger, step):
        labels, probs = buffers.concatenated()
        embeds = (np.concatenate(buffers.embeddings)
                  if buffers.embeddings else np.zeros((len(labels), 0)))
        paths = buffers.paths or list(range(len(labels)))
        preds = (probs > self.threshold).astype(int)
        cache = {
            i: {"path": paths[i], "embedding": embeds[i],
                "predicted": self.n_to_labels(preds[i]),
                "actual": self.n_to_labels(labels[i].astype(int))}
            for i in range(len(labels))
        }
        parent = os.path.dirname(self.out_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(self.out_path, "wb") as fp:
            pickle.dump(cache, fp)
        # the buffers are left for the callbacks after this one (the
        # entry point runs TransformerEval next, which empties them)
        return cache


class SSLOnlineEval(Callback):
    """Online probe on detached contrastive representations.

    The reference attaches an ``SSLEvaluator`` MLP and steps its own SGD
    on each train batch (callbacks.py:162-213).  Here the probe is a
    (z_dim → hidden → classes) MLP in f32 with ReLU, its weights drawn
    N(0, 2 / fan_in) and its biases zero, dropout ``drop_p`` on the hidden
    activations while it trains, plain SGD at ``lr`` on the BCE of its
    sigmoid scores.  Its randomness comes from a ``torch.Generator``
    seeded with ``seed`` (weights) and ``seed + 1`` (dropout masks); it
    lives on the device of the embeddings it is given.
    """

    def __init__(self, z_dim: int, num_classes: int, hidden: int = 512,
                 lr: float = 0.005, drop_p: float = 0.1, seed: int = 0,
                 target_names: Sequence[str] = MMX_GENRES_15):
        self.thresholds = (0.0, 0.1, 0.2, 0.3, 0.4, 0.5)
        self.target_names = target_names
        self.lr, self.drop_p = lr, drop_p
        gen = torch.Generator().manual_seed(seed)
        self.params = {
            "w1": torch.randn((z_dim, hidden), generator=gen)
            * (2.0 / z_dim) ** 0.5,
            "b1": torch.zeros((hidden,)),
            "w2": torch.randn((hidden, num_classes), generator=gen)
            * (2.0 / hidden) ** 0.5,
            "b2": torch.zeros((num_classes,)),
        }
        self._seed = seed + 1
        self._gen: torch.Generator | None = None

    def _on(self, device: torch.device) -> None:
        """Move the probe to ``device`` (once), with a dropout generator
        there."""
        if self._gen is not None and self.params["w1"].device == device:
            return
        self.params = {k: v.to(device) for k, v in self.params.items()}
        self._gen = torch.Generator(device=device).manual_seed(self._seed)

    def _logits(self, z: torch.Tensor, train: bool) -> torch.Tensor:
        p = self.params
        h = torch.relu(z @ p["w1"] + p["b1"])
        if train and self.drop_p > 0.0:
            keep = torch.rand(h.shape, generator=self._gen,
                              device=h.device) < 1.0 - self.drop_p
            h = torch.where(keep, h / (1.0 - self.drop_p), 0.0)
        return h @ p["w2"] + p["b2"]

    def on_train_batch_end(self, aux, logger, step):
        z = aux["embedding"].detach().float()
        y = aux["label"].detach().float()
        self._on(z.device)
        leaves = [v.requires_grad_(True) for v in self.params.values()]
        loss = losses.bce(torch.sigmoid(self._logits(z, train=True)), y)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            self.params = {k: (v - self.lr * g).detach()
                           for (k, v), g in zip(self.params.items(), grads)}
        logger.log({"train/online/loss": float(loss.detach())}, step)

    def eval_batch(self, aux, buffers):
        z = aux["embedding"].detach().float()
        self._on(z.device)
        with torch.no_grad():
            probs = torch.sigmoid(self._logits(z, train=False))
        buffers.append({"probs": probs, "label": aux["label"]})

    def on_validation_epoch_end(self, buffers, logger, step):
        labels, probs = buffers.concatenated()
        labels = labels.astype(int)
        out = {}
        for t in self.thresholds:
            preds = (probs > t).astype(int)
            p, r, f1, _ = M.precision_recall_f1(labels, preds, "weighted",
                                                zero_division=1)
            out[f"val/online/f1@{t}"] = f1
            out[f"val/online/recall@{t}"] = r
            out[f"val/online/precision@{t}"] = p
            out[f"val/online/avg_precision@{t}"] = M.average_precision(
                labels, preds, average="weighted")
        logger.log(out, step)
        # per-sample truth/guess table of the first 20 samples @0.3 — the
        # reference's wandb.Table (src/callbacks/callbacks.py:285-291)
        names = self.target_names[: labels.shape[1]]

        def translate(vec):
            return [names[i] for i, x in enumerate(vec) if x and i < len(names)]

        guesses = (probs > 0.3).astype(int)
        rows = [(translate(labels[i]), translate(guesses[i]))
                for i in range(min(20, len(labels)))]
        if hasattr(logger, "log_table"):
            logger.log_table("val/online/table", ["truth", "guess"], rows,
                             step)
        buffers.reset()
        return out
