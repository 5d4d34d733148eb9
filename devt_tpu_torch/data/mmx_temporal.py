"""MMX temporal: port of ``devt_tpu/data/mmx_temporal.py``.

Expert-embedding sequences per trailer, the capability twin of
``MMXDataModule``/``MMXDataset`` (src/dataloaders/mmx/MMX_Temporal_dl.py):

  * streamed-pickle manifest → :class:`~devt_tpu_torch.data.manifests.Table`
    → ``clean_mmx_temporal`` (drop rows with out-of-set labels or <5
    scenes, :42-68);
  * per item: walk the scene dict in order, load each configured expert's
    tensor per scene up to ``seq_len`` (missing file/key → zeros,
    feature dim zero-padded to 2048, :155-174);
  * train-time embedding augmentation: p=.3 modality zero-out, p=.3
    additive noise (:176-181);
  * zero-pad the scene sequence to a fixed ``seq_len`` (:250-251);
  * 15-genre multi-hot labels with the Drama fallback (:118-132);
  * mixing methods: ``concat`` / ``concat-norm`` collapse experts into one
    wide vector, the others keep the expert axis (:189-210).

Emits fixed-shape items:
  expert-axis modes → ``experts (seq_len, E, 2048)``;
  concat modes      → ``experts (seq_len, 1, E*2048)``.
"""

from __future__ import annotations

import random
from typing import Any

import numpy as np

from devt_tpu_torch.config import MMX_GENRES_15, Config
from devt_tpu_torch.data import manifests, transforms
from devt_tpu_torch.data.pipeline import Loader


def collect_labels_15(label) -> np.ndarray:
    """15-genre multi-hot with Drama fallback (MMX_Temporal_dl.py:118-132)."""
    out = np.zeros(15, np.float32)
    for i, genre in enumerate(MMX_GENRES_15):
        if genre in label:
            out[i] = 1.0
    if out.sum() == 0:
        out[5] = 1.0        # Drama
    return out


class MMXTemporalDataset:
    def __init__(self, table: manifests.Table, config: Config,
                 state: str = "train"):
        self.table = table
        self.config = config
        self.state = state
        self.seq_len = config.seq_len
        self.experts = list(config.experts)
        self.mixing = config.mixing_method

    def __len__(self) -> int:
        return len(self.table)

    def _label(self, label) -> np.ndarray:
        # label may arrive as [genres, extra] (MMX_Temporal_dl.py:183-187)
        if len(label) == 2 and isinstance(label[0], (list, tuple)):
            return collect_labels_15(label[0])
        return collect_labels_15(label)

    def _expert_key(self, expert: str) -> str:
        # val/test corpora use "test-"-prefixed expert dirs
        # (MMX_Temporal_dl.py:138-141)
        return f"test-{expert}" if self.state != "train" else expert

    def _scene_tensor(self, scene: dict, expert: str,
                      rng: random.Random) -> np.ndarray:
        try:
            chunk = scene[list(scene.keys())[0]]
            paths = chunk.get(self._expert_key(expert)) or \
                chunk.get(expert)
        except (KeyError, IndexError, AttributeError):
            paths = None
        if not paths:
            t = np.zeros((1, 2048), np.float32)
        else:
            # img/location experts keep only the last tensor (:159-160)
            path = paths[-1] if isinstance(paths, (list, tuple)) else paths
            t = manifests.load_tensor(path, width=2048)[:1]
        if self.state == "train":
            t = transforms.expert_augment(t, rng)
        return t[0]

    def __getitem__(self, idx: int) -> dict[str, Any]:
        rng = random.Random(hash((self.config.seed, self.state, idx,
                                  random.random() if self.state == "train"
                                  else 0)))
        row = self.table.row(idx)
        scenes = row["scenes"]
        path = row.get("path", "")

        seq = np.zeros((self.seq_len, len(self.experts), 2048), np.float32)
        for si, scene in enumerate(scenes.values()):
            if si >= self.seq_len:
                break
            for ei, expert in enumerate(self.experts):
                seq[si, ei] = self._scene_tensor(scene, expert, rng)

        if self.mixing in ("concat", "concat-norm"):
            per_expert = [seq[:, e] for e in range(seq.shape[1])]
            if self.mixing == "concat-norm":
                per_expert = [
                    x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                                   1e-8) for x in per_expert]
            seq = np.concatenate(per_expert, axis=-1)[:, None, :]

        return {"label": self._label(row["label"]),
                "experts": seq, "path": path}


class MMXDataModule:
    """setup / train / val / test loaders (MMX_Temporal_dl.py:88-102)."""

    def __init__(self, train_manifest: str, val_manifest: str,
                 config: Config):
        self.train_manifest = train_manifest
        self.val_manifest = val_manifest
        self.config = config
        self.train_table = None
        self.val_table = None

    def setup(self):
        self.train_table = manifests.clean_mmx_temporal(
            manifests.load_manifest(self.train_manifest), MMX_GENRES_15)
        self.val_table = manifests.clean_mmx_temporal(
            manifests.load_manifest(self.val_manifest), MMX_GENRES_15)
        self.train_steps = len(self.train_table) // self.config.batch_size
        return self

    def train_batches(self):
        ds = MMXTemporalDataset(self.train_table, self.config, "train")
        return Loader(ds, self.config.batch_size, shuffle=True,
                      seed=self.config.seed)

    def val_batches(self):
        ds = MMXTemporalDataset(self.val_table, self.config, "val")
        return Loader(ds, self.config.batch_size)

    def test_batches(self):
        ds = MMXTemporalDataset(self.val_table, self.config, "test")
        return Loader(ds, self.config.batch_size)
