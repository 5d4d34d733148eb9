"""Contrastive pair pipelines (MMX + MIT): port of
``devt_tpu/data/contrastive.py``.

Capability twin of the contrastive loaders
(src/dataloaders/mmx/MMX_Contrastive_dl.py:18-261,
src/dataloaders/mit/MIT_Contrastive_dl.py:18-205):

  * positive pair = two random scenes/chunks of the same trailer/video
    (MMX_Contrastive_dl.py:242, MIT_Contrastive_dl.py:183-188);
  * trailers with <2 usable scenes mix up with a neighbour sample
    (MMX_Contrastive_dl.py:208-238): the second view is a scene drawn
    from the next row;
  * per-expert tensor load with a random choice among multiple stored
    tensors (MMX_Contrastive_dl.py:246-261), zeros for missing files;
  * expert aggregation to a fixed input width happens here (numpy) so
    batches are static-shape; modes mirror
    src/models/contrastivemodel.py:116-137.
"""

from __future__ import annotations

import random

import numpy as np

from devt_tpu_torch.config import Config
from devt_tpu_torch.data import manifests
from devt_tpu_torch.data.mmx_temporal import collect_labels_15
from devt_tpu_torch.data.pipeline import Loader


def _np_adaptive_avg(x: np.ndarray, out: int) -> np.ndarray:
    n = x.shape[-1]
    res = np.empty(x.shape[:-1] + (out,), x.dtype)
    for i in range(out):
        s, e = (i * n) // out, ((i + 1) * n + out - 1) // out
        res[..., i] = x[..., s:e].mean(-1)
    return res


def aggregate(experts: list[np.ndarray], mode: str, width: int) -> np.ndarray:
    if mode == "none":
        return experts[0]
    cat = np.concatenate(experts, axis=-1)
    if mode == "concat":
        return cat
    if mode == "avg_pool":
        return _np_adaptive_avg(cat, width)
    if mode == "mean_pool":
        n = cat.shape[-1]
        return np.max(cat.reshape(cat.shape[:-1] + (width, n // width)),
                      axis=-1) if n % width == 0 else _np_adaptive_avg(
                          cat, width)
    raise ValueError(f"unknown aggregation {mode!r}")


class ContrastivePairDataset:
    def __init__(self, table: manifests.Table, config: Config,
                 train: bool = True):
        self.table = table
        self.config = config
        self.train = train
        self.experts = list(config.experts)
        self.width = config.input_shape

    def __len__(self) -> int:
        return len(self.table)

    def _label(self, idx: int) -> np.ndarray:
        """Genre-string labels → 15-way multi-hot; numeric pass through;
        missing column → zeros (labels are unused by the contrastive loss —
        kept for the SSL online-probe callback)."""
        if "label" not in self.table.columns:
            return np.zeros((1,), np.float32)
        raw = self.table.row(idx).get("label")
        flat = raw
        while isinstance(flat, (list, tuple)) and flat \
                and isinstance(flat[0], (list, tuple)):
            flat = flat[0]
        if isinstance(flat, (list, tuple)) and flat \
                and isinstance(flat[0], str):
            return collect_labels_15(flat)
        if isinstance(flat, str):
            # MIT contrastive: label is one category string, resolved
            # through moments_categories.csv (MIT_Contrastive_dl.py keeps
            # the same lookup as the temporal loader)
            idx_ = manifests.load_moments_categories().get(flat, 0)
            return np.asarray(idx_, np.float32)[None]
        label = np.asarray(raw, np.float32)
        return label[None] if label.ndim == 0 else label

    def _scene_vector(self, scene: dict, rng: random.Random) -> np.ndarray:
        vecs = []
        for expert in self.experts:
            paths = None
            try:
                chunk = scene[list(scene.keys())[0]] \
                    if not any(e in scene for e in self.experts) else scene
                paths = chunk.get(expert)
            except (AttributeError, IndexError):
                paths = None
            if not paths:
                vecs.append(np.zeros((2048,), np.float32))
                continue
            if isinstance(paths, (list, tuple)):
                # random choice among stored tensors
                # (MMX_Contrastive_dl.py:246-261)
                path = paths[rng.randrange(len(paths))]
            else:
                path = paths
            vecs.append(manifests.load_tensor(path, width=2048)[0])
        return aggregate(vecs, self.config.aggregation, self.width)

    def _units(self, idx: int) -> list:
        """Pairable units of one row: MMX manifests call them ``scenes``,
        MIT contrastive manifests call them ``data`` (chunks —
        create_mit_contrastive.py:49)."""
        row = self.table.row(idx)
        col = row.get("scenes")
        if not isinstance(col, dict):
            col = row.get("data")
        return list(col.values())

    def __getitem__(self, idx: int):
        rng = random.Random(hash((self.config.seed, idx, self.train,
                                  random.random() if self.train else 0)))
        scenes = self._units(idx)
        label = self._label(idx)

        if len(scenes) >= 2:
            i, j = rng.sample(range(len(scenes)), 2)
            s_i, s_j = scenes[i], scenes[j]
        else:
            # neighbour mix-up (MMX_Contrastive_dl.py:208-238)
            nbr = self._units((idx + 1) % len(self.table))
            s_i = scenes[0]
            s_j = nbr[rng.randrange(len(nbr))]

        return {"x_i": self._scene_vector(s_i, rng),
                "x_j": self._scene_vector(s_j, rng),
                "label": label}


class ContrastiveDataModule:
    def __init__(self, train_manifest: str, val_manifest: str,
                 config: Config):
        self.train_manifest = train_manifest
        self.val_manifest = val_manifest
        self.config = config

    def setup(self):
        self.train_table = manifests.load_manifest(self.train_manifest)
        self.val_table = manifests.load_manifest(self.val_manifest)
        self.train_steps = len(self.train_table) // self.config.batch_size
        return self

    def train_batches(self):
        return Loader(ContrastivePairDataset(self.train_table, self.config,
                                             train=True),
                      self.config.batch_size, shuffle=True,
                      seed=self.config.seed)

    def val_batches(self):
        return Loader(ContrastivePairDataset(self.val_table, self.config,
                                             train=False),
                      self.config.batch_size)

    def test_batches(self):
        return Loader(ContrastivePairDataset(self.val_table, self.config,
                                             train=False),
                      self.config.batch_size)
