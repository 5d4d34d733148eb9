"""Epoch-level evaluation metrics: port of ``devt_tpu/train/metrics.py``.

The reference's callback metrics (src/callbacks/callbacks.py): sample-
averaged F1 swept over thresholds (callbacks.py:36-44), average precision
with samples / weighted averaging (callbacks.py:49-55), the per-class
classification report (callbacks.py:59), and MIT top-1 accuracy
(callbacks.py:90-94).

The JAX package calls scikit-learn; the port computes the same numbers
with numpy and imports no scikit-learn, keeping its definitions:

  * precision, recall and F1 from each class's (or, for ``samples``, each
    row's) true-positive, predicted and true counts; a zero denominator
    gives ``zero_division``; ``weighted`` weighs classes by their support
    (the plain mean when no class has any), ``samples`` averages rows;
  * average precision is the step-wise sum ``Σ (R_n − R_{n−1}) P_n`` over
    the distinct scores, ties grouped into one threshold, not an
    interpolated AP; a class (or row) with no positive label scores 0;
    ``weighted`` returns 0 when no label is positive at all;
  * the report is scikit-learn's ``classification_report`` text for
    multi-label input, with its ``micro avg``, ``macro avg``, ``weighted
    avg`` and ``samples avg`` rows.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

F1_THRESHOLDS = (0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8)
REPORT_THRESHOLD = 0.3
AVERAGES = ("micro", "macro", "weighted", "samples")


def _indicator(x) -> np.ndarray:
    """A 2-D 0/1 label or prediction matrix (the multi-label form the
    genre heads produce), as int64."""
    x = np.asarray(x)
    if x.ndim != 2:
        raise ValueError(f"expected a 2-D multi-label indicator matrix, "
                         f"got shape {x.shape}")
    return x.astype(np.int64)


def _divide(num: np.ndarray, den: np.ndarray, zero_division: float
            ) -> np.ndarray:
    den = np.asarray(den, np.float64)
    out = np.asarray(num, np.float64) / np.where(den == 0, 1.0, den)
    return np.where(den == 0, float(zero_division), out)


def _average(score: np.ndarray, weights: np.ndarray | None) -> float:
    if weights is None:
        return float(np.nanmean(score))
    weights = np.asarray(weights, np.float64)
    if weights.sum() == 0:          # no class has support: the plain mean
        return float(np.mean(score))
    return float(np.sum(score * weights) / np.sum(weights))


def precision_recall_f1(labels, preds, average: str | None,
                        zero_division: float = 0.0):
    """``(precision, recall, f1, support)`` of multi-label predictions:
    per class when ``average`` is None (support per class), else averaged
    by ``micro``, ``macro``, ``weighted`` or ``samples`` (support None)."""
    y, p = _indicator(labels), _indicator(preds)
    axis = 1 if average == "samples" else 0
    tp = np.sum(y & p, axis=axis)
    pred = np.sum(p, axis=axis)
    true = np.sum(y, axis=axis)
    if average == "micro":
        tp, pred, true = (np.array([a.sum()]) for a in (tp, pred, true))
    precision = _divide(tp, pred, zero_division)
    recall = _divide(tp, true, zero_division)
    f1 = _divide(2.0 * tp, true + pred, zero_division)
    if average is None:
        return precision, recall, f1, true
    if average not in AVERAGES:
        raise ValueError(f"unknown average {average!r}")
    weights = true if average == "weighted" else None
    return (_average(precision, weights), _average(recall, weights),
            _average(f1, weights), None)


def f1_threshold_sweep(labels: np.ndarray, probs: np.ndarray,
                       thresholds: Sequence[float] = F1_THRESHOLDS,
                       average: str = "samples") -> dict[str, float]:
    """``{"f1@t": score}`` — callbacks.py:36-44 semantics
    (zero_division=0, sample averaging)."""
    out = {}
    for t in thresholds:
        preds = (np.asarray(probs) > t).astype(int)
        out[f"f1@{t}"] = precision_recall_f1(labels, preds, average,
                                             zero_division=0)[2]
    return out


def binary_average_precision(y: np.ndarray, score: np.ndarray) -> float:
    """AP of one binary column: precision at each distinct score
    (descending), weighted by the recall it adds."""
    order = np.argsort(score, kind="mergesort")[::-1]
    score, y = score[order], y[order]
    # the last index of every run of equal scores: ties form one threshold
    last = np.r_[np.nonzero(np.diff(score))[0], y.size - 1]
    tps = np.cumsum(y, dtype=np.float64)[last]
    fps = 1.0 + last - tps
    precision = tps / (tps + fps)
    if tps[-1] == 0:
        return 0.0
    recall = tps / tps[-1]
    # R_0 = 0 ahead of the first threshold
    return float(max(0.0, np.sum(np.diff(np.r_[0.0, recall]) * precision)))


def average_precision(labels: np.ndarray, probs: np.ndarray,
                      average: str = "samples") -> float:
    """Mean average precision over rows (``samples``), over classes
    (``macro``), or over classes weighted by support (``weighted``) —
    callbacks.py:49-55."""
    y = _indicator(labels)
    s = np.asarray(probs)
    if s.shape != y.shape:
        raise ValueError(f"labels {y.shape} and scores {s.shape} differ")
    if average == "samples":
        return float(np.mean([binary_average_precision(y[i], s[i])
                              for i in range(y.shape[0])]))
    if average not in ("macro", "weighted"):
        raise ValueError(f"unknown average {average!r}")
    weights = None
    if average == "weighted":
        weights = y.sum(axis=0)
        if weights.sum() == 0:
            return 0.0
    scores = np.array([binary_average_precision(y[:, c], s[:, c])
                       for c in range(y.shape[1])])
    return _average(scores, weights)


def classification_report(labels, preds, target_names: Sequence[str],
                          digits: int = 2, zero_division: float = 0.0
                          ) -> str:
    """Per-class precision, recall, F1 and support of multi-label
    predictions, then the four averages, as a text table."""
    y = _indicator(labels)
    names = list(target_names)
    if len(names) != y.shape[1]:
        raise ValueError(f"Number of classes, {y.shape[1]}, does not match "
                         f"size of target_names, {len(names)}")
    headers = ["precision", "recall", "f1-score", "support"]
    p, r, f1, s = precision_recall_f1(y, preds, None, zero_division)
    width = max(max(len(n) for n in names), len("weighted avg"), digits)
    report = ("{:>{width}s} " + " {:>9}" * len(headers)).format(
        "", *headers, width=width) + "\n\n"
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    for row in zip(names, p, r, f1, s):
        report += row_fmt.format(*row, width=width, digits=digits)
    report += "\n"
    for average in AVERAGES:
        ap, ar, af, _ = precision_recall_f1(y, preds, average, zero_division)
        report += row_fmt.format(f"{average} avg", ap, ar, af, int(s.sum()),
                                 width=width, digits=digits)
    return report


def genre_report(labels: np.ndarray, probs: np.ndarray,
                 target_names: Sequence[str],
                 threshold: float = REPORT_THRESHOLD) -> str:
    """Per-class precision/recall/F1 table at threshold 0.3 —
    callbacks.py:59,82."""
    preds = (np.asarray(probs) > threshold).astype(int)
    return classification_report(labels, preds, target_names,
                                 zero_division=0)


def top1_accuracy(labels: np.ndarray, probs: np.ndarray) -> float:
    """MIT single-label top-1 (callbacks.py:90-94): argmax over class
    scores."""
    labels = np.asarray(labels)
    preds = np.asarray(probs).argmax(axis=-1)
    if labels.ndim > 1:
        labels = labels.argmax(axis=-1)
    return float((preds == labels).mean())


def _host(x) -> np.ndarray:
    """An f32 numpy copy of a tensor on any device (bf16 widened) or of an
    array."""
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


class RunningBuffers:
    """The ``running_logits``/``running_labels`` accumulation pattern
    (src/models/transformer.py:50-51,154-158) as an explicit object."""

    def __init__(self):
        self.probs: list[np.ndarray] = []
        self.labels: list[np.ndarray] = []
        self.embeddings: list[np.ndarray] = []
        self.paths: list = []

    def append(self, aux: dict) -> None:
        # device tensors (bf16 too) arrive here as f32 numpy arrays, so
        # every downstream metric sees a plain float dtype
        self.probs.append(_host(aux["probs"]))
        self.labels.append(_host(aux["label"]))
        if aux.get("embedding") is not None:
            self.embeddings.append(_host(aux["embedding"]))
        if aux.get("path") is not None:
            self.paths.extend(list(aux["path"]))

    def concatenated(self) -> tuple[np.ndarray, np.ndarray]:
        return (np.concatenate(self.labels), np.concatenate(self.probs))

    def reset(self) -> None:
        self.probs.clear()
        self.labels.clear()
        self.embeddings.clear()
        self.paths.clear()

    def __len__(self) -> int:
        return len(self.probs)
