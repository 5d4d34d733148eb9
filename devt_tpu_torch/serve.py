"""Batch inference / serving: port of ``devt_tpu/serve.py:Predictor``.

  * requests are padded up to the nearest bucket, so every forward runs
    at one of a few batch shapes;
  * ``vid`` (or ``vid_tokens``) and ``img`` may arrive as raw uint8
    pixels and are normalized on the device (``data/device_norm.py``);
  * outputs are sigmoid scores plus the genre labels whose score passes
    the threshold (0.3, the reference's callback semantics).

``vivit`` (with switch-MoE blocks too, ``moe_experts > 0``), ``ptn`` and
``ptn_shared`` are served, in the model dtype or, with ``quantize=True``,
with the transformer hot path in int8 (``ops/quant.py``; an MoE block keeps
its attention half and expert products in the model dtype, as in the JAX
package).  The FrameTransformer variants are served from ``img`` and
``vid``, in the model dtype or with their encoders in int8.  ``tpn``
serves the probabilities it returns, ``lstm`` sigmoid and ``basicmlp``
softmax scores, from ``img`` and ``experts`` as the JAX predictor does;
``quantize=True`` leaves these three as they are, since no site of theirs
is quantized.  ``contrastive`` is an encoder, not a classifier, and is
not served.  The predictor runs on ``cuda`` unless the caller passes
``device="cpu"``; with no CUDA device and no explicit device it raises.
``from_checkpoint`` serves a checkpoint of ``train/checkpoint.py``.
Data-parallel meshes, export and Lightning checkpoints are not ported
yet.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from devt_tpu_torch.config import MMX_GENRES_15, MMX_GENRES_19, Config
from devt_tpu_torch.data.device_norm import maybe_dequantize_batch
from devt_tpu_torch.ops.attention import quant_scope
from devt_tpu_torch.ops.quant import quant_sites_collect, quant_sites_provide
from devt_tpu_torch.registry import FT_VARIANTS, build_model, example_batch


def _pad_to(x: np.ndarray, n: int) -> np.ndarray:
    if x.shape[0] == n:
        return x
    pad = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the card; there is no silent fallback to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return torch.device("cuda")


def _todo(what: str, item: int = 3) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet — ROADMAP.md "
                               f"queue 1, item {item}")


class Predictor:
    """Eager inference over bucketed batch sizes."""

    def __init__(self, config: Config,
                 state_dict: Mapping[str, torch.Tensor],
                 buckets: Sequence[int] = (1, 8, 32),
                 threshold: float = 0.3, mesh=None,
                 quantize: bool = False, quant_site_pred=None,
                 device: str | torch.device | None = None):
        """``state_dict``: the port model's weights (``build_model``'s
        names; ``utils.jax_bridge`` converts JAX variables).

        ``quantize=True`` serves the transformer hot path in int8
        (``ops/quant.py``): weights per output channel, activations
        dynamic per row.  Every weight is quantized once, here: an eager
        collect pass over a one-sample batch records each site's int8
        weights and f32 scales on the device (call order is the site's
        identity), and every forward takes them back from that list and
        quantizes no weight.  So later writes to ``self.model``'s weights
        do not reach a quantized predictor; build a new one instead.  (The
        JAX package chooses between folding the int8 weights into the
        compiled program and passing them as arguments by the size of the
        tree; an eager program has no such distinction, and this list is
        the only delivery.)

        ``quant_site_pred``: optional ``(k, n) -> bool`` filter over the
        Linear sites of the torch-semantics encoder
        (``ops.attention.quant_scope``).  None applies the JAX package's
        default policy ``n >= 2k``: a site is quantized only when its
        output is at least twice as wide as its input, which on PTN keeps
        the packed qkv projection and leaves the square sites in the model
        dtype.  Pass ``lambda k, n: True`` to quantize every site.
        Without ``quantize`` it is ignored."""
        if config.model == "contrastive":
            raise ValueError("the contrastive encoder returns embeddings, "
                             "not class scores: Predictor serves the "
                             "classifiers, and the JAX package's has no "
                             "branch for it either")
        if mesh is not None:
            raise _todo("Predictor(mesh=...), data-parallel serving", item=7)
        if quantize and quant_site_pred is None:
            quant_site_pred = lambda k, n: n >= 2 * k  # noqa: E731
        self.device = resolve_device(device)
        self.config = config
        self.model = build_model(config)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()
        self.threshold = threshold
        self.buckets = sorted(buckets)
        self.target_names = (MMX_GENRES_19 if config.n_classes == 19
                             else MMX_GENRES_15)
        self.quantize = quantize
        self._quant_site_pred = quant_site_pred
        self._qsites: list | None = None
        if quantize:
            tiny = {k: torch.from_numpy(v).to(self.device)
                    for k, v in example_batch(config, batch_size=1).items()
                    if k != "label"}
            sites: list = []
            with torch.inference_mode(), quant_scope(quant_site_pred), \
                    quant_sites_collect(sites):
                self._scores(tiny)
            self._qsites = sites

    @classmethod
    def from_checkpoint(cls, config: Config, ckpt_path: str,
                        **kw) -> "Predictor":
        """Serve the weights of a checkpoint that ``train/checkpoint.py``
        wrote (a ``step_<n>`` directory), read with
        ``torch.load(weights_only=True)``."""
        from devt_tpu_torch.train import checkpoint as ckpt_lib

        payload = ckpt_lib.load(ckpt_path)
        return cls(config, {**payload["params"], **payload["model_state"]},
                   **kw)

    @classmethod
    def from_lightning_checkpoint(cls, config: Config, ckpt_path: str,
                                  **kw) -> "Predictor":
        raise _todo("Predictor.from_lightning_checkpoint", item=8)

    def export(self, path: str, batch_size: int | None = None,
               platforms: Sequence[str] | None = None) -> None:
        raise _todo("Predictor.export")

    def _scores(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        batch = maybe_dequantize_batch(dict(batch), dtype=torch.float32)
        name = self.config.model
        if name == "tpn":
            return self.model(batch["img"])     # already probabilities
        if name == "basicmlp":
            return torch.softmax(self.model(batch["experts"]), dim=-1)
        if name in ("ptn", "ptn_shared", "lstm"):
            out = self.model(batch["experts"])
        elif name in FT_VARIANTS:
            out = self.model(img=batch.get("img"),
                             vid=batch.get("vid"))["logits"]
        elif "vid_tokens" in batch:
            out = self.model(batch["vid_tokens"], tokens_in=True)
        else:
            out = self.model(batch["vid"])
        return torch.sigmoid(out)

    def forward(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Scores for one already-padded batch of device tensors."""
        if not self.quantize:
            return self._scores(batch)
        with quant_scope(self._quant_site_pred), \
                quant_sites_provide(self._qsites):
            return self._scores(batch)

    def _invoke(self, chunk: Mapping[str, np.ndarray]) -> np.ndarray:
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                       self.device, non_blocking=True)
                   for k, v in chunk.items()}
        with torch.inference_mode():
            return self.forward(tensors).float().cpu().numpy()

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def predict(self, batch: Mapping[str, np.ndarray]) -> dict[str, Any]:
        """batch: model-keyed arrays with leading batch dim (any size).
        Returns {"scores": (N, C), "labels": [[genre, ...], ...]}."""
        n = next(iter(batch.values())).shape[0]
        scores = []
        start = 0
        while start < n:
            take = min(self._bucket(n - start), n - start)
            bucket = self._bucket(take)
            chunk = {k: _pad_to(np.asarray(v[start:start + take]), bucket)
                     for k, v in batch.items()}
            scores.append(self._invoke(chunk)[:take])
            start += take
        scores = np.concatenate(scores) if scores else np.zeros((0, 0))
        labels = [[self.target_names[i] for i, s in enumerate(row)
                   if s > self.threshold and i < len(self.target_names)]
                  for row in scores]
        return {"scores": scores, "labels": labels}
