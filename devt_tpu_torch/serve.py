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
``from_checkpoint`` serves a checkpoint of ``train/checkpoint.py``,
``from_lightning_checkpoint`` one of the reference's Lightning modules.
``export`` writes the forward as a ``torch.export`` program with the
weights inside, which ``load_exported`` serves without the model code.
With ``mesh=`` (``parallel/mesh.py``) the predictor serves data parallel:
every rank of the mesh calls ``predict`` with the same batch, runs its
rows of each padded chunk and gathers the scores of all ranks, so that
every rank returns the whole batch.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from devt_tpu_torch.config import MMX_GENRES_15, MMX_GENRES_19, Config
from devt_tpu_torch.data.device_norm import maybe_dequantize_batch
from devt_tpu_torch.ops.attention import quant_scope
from devt_tpu_torch.ops.quant import quant_sites_collect, quant_sites_provide
from devt_tpu_torch.parallel.collectives import all_gather_rows, axis_scope
from devt_tpu_torch.parallel.mesh import DATA_AXIS, shard_batch
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


# the devices an exported program may be asked to serve on, and where
# ``export`` writes which ones it was (with the batch's keys, in order)
PLATFORMS = ("cpu", "cuda")
_EXPORT_META = "devt_tpu_torch.json"


def _check_platforms(platforms: Sequence[str] | None,
                     device: torch.device) -> tuple[str, ...]:
    if platforms is None:
        return (device.type,)
    if isinstance(platforms, str):
        platforms = (platforms,)
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms:
        raise ValueError(f"unknown platforms {unknown or platforms}: an "
                         f"exported program serves on {PLATFORMS}")
    return tuple(platforms)


class _Forward(nn.Module):
    """``Predictor.forward`` as the module ``torch.export`` traces: the
    model's parameters and buffers become the program's, and the int8
    site list of a quantized predictor its constants."""

    def __init__(self, predictor: "Predictor"):
        super().__init__()
        self.model = predictor.model
        self.predictor = predictor

    def forward(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        return self.predictor.forward(batch)


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

        ``mesh``: serve data parallel over the mesh's ``data`` axis, as
        the JAX predictor's ``shard_map`` does.  Each bucket is rounded up
        to a multiple of the axis' size; every rank of the mesh calls
        :meth:`predict` with the same batch, computes its contiguous rows
        of each padded chunk (the fused kernels on the rank's rows) and
        gathers the scores, so every rank returns the whole batch.  The
        weights are each rank's own: load the same ``state_dict`` on
        every rank.

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
        if quantize and quant_site_pred is None:
            quant_site_pred = lambda k, n: n >= 2 * k  # noqa: E731
        self.device = resolve_device(device)
        self.config = config
        self.model = build_model(config)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()
        self.threshold = threshold
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None:
            # each bucket divides over the data axis
            n = self.mesh.shape[DATA_AXIS]
            self.buckets = sorted({-(-b // n) * n for b in buckets})
        else:
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
            # a block's tree passes some parameters through as they are:
            # the list holds values, not views that track gradients
            self._qsites = [
                {k: t.detach() for k, t in v.items()} if isinstance(v, dict)
                else tuple(t.detach() for t in v) for v in sites]

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
        """Serve the weights of a reference Lightning ``.ckpt``
        (``utils/lightning_import.py``): ``ptn`` and ``ptn_shared`` through
        the SimpleTransformer map, every other model through the
        FrameTransformer one, as the JAX package's
        ``Predictor.from_lightning_checkpoint`` maps them; then
        ``jax_to_state_dict``.  The model takes the modules it builds (a
        ``vid`` FrameTransformer has no image side) and raises ``KeyError``
        on a weight the checkpoint lacks."""
        from devt_tpu_torch.utils import lightning_import
        from devt_tpu_torch.utils.jax_bridge import jax_to_state_dict

        sd = lightning_import.load_checkpoint_state_dict(ckpt_path)
        if config.model in ("ptn", "ptn_shared"):
            variables = lightning_import.simple_transformer(
                sd, nlayers=config.nlayers,
                num_experts=len(config.experts))
        else:
            variables = lightning_import.frame_transformer(sd)
        weights = jax_to_state_dict(variables)
        with torch.device("meta"):          # the names, not the numbers
            names = build_model(config).state_dict().keys()
        missing = [k for k in names if k not in weights]
        if missing:
            raise KeyError(f"{ckpt_path} holds no weight for {len(missing)} "
                           f"of the {config.model} model's entries, "
                           f"{missing[:4]}...")
        return cls(config, {k: weights[k] for k in names}, **kw)

    def export(self, path: str, batch_size: int | None = None,
               platforms: Sequence[str] | None = None) -> None:
        """Write the forward as a ``torch.export`` program (one file,
        ``torch.export.save``), the weights inside it, and with
        ``quantize`` the int8 site list too: :func:`load_exported` serves
        it without the model code, the registry, the config or the
        checkpoint.

        It traces ``forward`` on one padded batch of ``batch_size`` rows
        (default the largest bucket), as ``example_batch`` draws it, with
        ``vid`` and ``img`` in uint8 when ``config.wire_format`` is
        ``"u8"``: callers pad requests to that size, as :meth:`predict`
        does, and send those dtypes.  Each hand-written kernel stays one
        node, a ``devt_tpu_torch::`` op whose CUDA implementation launches
        the kernel and whose CPU implementation is its plain version
        (``ops/_library.py``).  Unlike a StableHLO artifact of the JAX
        package, the program needs ``devt_tpu_torch.ops`` imported where it
        runs: that import registers the ops.

        ``platforms`` keeps the JAX package's meaning, the devices the
        artifact may serve on: any of ``("cpu", "cuda")``, None for the
        predictor's own; another name raises ``ValueError``.  One program
        serves on both, since every op has both implementations; the
        routes between kernels are the ones this predictor's device takes
        (on the card, the shapes the kernels are compiled for; the plain
        versions take every shape, so a program traced on the card runs on
        the CPU)."""
        platforms = _check_platforms(platforms, self.device)
        b = batch_size or self.buckets[-1]
        example = {}
        for key, value in sorted(example_batch(self.config,
                                               batch_size=b).items()):
            if key == "label":
                continue
            if self.config.wire_format == "u8" and key in ("vid", "img"):
                value = np.zeros(value.shape, np.uint8)
            example[key] = torch.from_numpy(value).to(self.device)
        with torch.inference_mode():
            program = torch.export.export(_Forward(self), (example,),
                                          strict=False)
        meta = {"platforms": list(platforms),
                "batch": {k: [list(v.shape), str(v.dtype)]
                          for k, v in example.items()}}
        torch.export.save(program, path,
                          extra_files={_EXPORT_META: json.dumps(meta)})

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
        if self.mesh is not None:
            chunk = shard_batch(chunk, self.mesh)
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                       self.device, non_blocking=True)
                   for k, v in chunk.items()}
        with torch.inference_mode():
            scores = self.forward(tensors)
            if self.mesh is not None:
                with axis_scope(self.mesh.axes()):
                    scores = all_gather_rows(scores, DATA_AXIS)
            return scores.float().cpu().numpy()

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


def load_exported(path: str, device: str | torch.device | None = None
                  ) -> Callable[[Mapping[str, np.ndarray]], np.ndarray]:
    """Load a program written by :meth:`Predictor.export` onto ``device``
    (None: the card, raising without CUDA, like every entry point of the
    port; the program's tensors are moved there).  Returns a callable that
    takes the model-keyed numpy batch dict, already padded to the exported
    batch size, and returns the score array, like the JAX package's
    ``exported.call``.  A device outside the export's ``platforms`` raises
    ``ValueError``.  This module imports ``devt_tpu_torch.ops``, which
    registers the program's ops; a kernel that fails inside the program
    raises."""
    from torch.export.passes import move_to_device_pass

    device = resolve_device(device)
    extra = {_EXPORT_META: ""}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[_EXPORT_META])
    if device.type not in meta["platforms"]:
        raise ValueError(f"{path} was exported for {meta['platforms']}, not "
                         f"{device.type}")
    module = move_to_device_pass(program, device).module()
    keys = list(meta["batch"])

    def call(batch: Mapping[str, np.ndarray]) -> np.ndarray:
        tensors = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(
                       device) for k in keys}
        with torch.inference_mode():
            return module(tensors).float().cpu().numpy()

    return call
