"""MIT temporal: port of ``devt_tpu/data/mit_temporal.py``.

305-class single-label expert sequences, the capability twin of
``MITDataModule``/``MITDataset`` (src/dataloaders/mit/MIT_Temporal_dl.py):

  * labels resolved through ``moments_categories.csv`` (:204-212; the
    copy under devt_tpu_torch/data/labels/);
  * class balancing via a WeightedRandomSampler built from inverse class
    counts (:144-161 → ``samplers.py``);
  * ``double_trans`` mixing (:235-267): per expert — optional random-CLS
    ``U[0,1)`` (1, 2048) prepend when ``cls`` is set, "test-" expert prefix
    at val, chunk paths sorted then truncated to ``target_len = 3``,
    repeat-padded with the first element when short;
  * tensors zero-padded to 2048 on load (:214-220);
  * ``load_data`` caps the manifest to the first 10k rows (:139-140),
    ``max_rows`` here.

Emits ``experts (target_len(+1), E, 2048)`` and integer ``label``.
"""

from __future__ import annotations

import random

import numpy as np

from devt_tpu_torch.config import Config
from devt_tpu_torch.data import manifests
from devt_tpu_torch.data.pipeline import Loader
from devt_tpu_torch.data.samplers import weighted_sampler


class MITTemporalDataset:
    TARGET_LEN = 3   # MIT_Temporal_dl.py:231

    def __init__(self, table: manifests.Table, config: Config,
                 train: bool = True, label_map: dict | None = None):
        self.table = table
        self.config = config
        self.train = train
        self.label_map = label_map or manifests.load_moments_categories()
        self.experts = list(config.experts)
        self.use_cls = bool(config.cls)

    def __len__(self) -> int:
        return len(self.table)

    def label_index(self, label) -> int:
        return int(self.label_map[label])

    def __getitem__(self, idx: int):
        rng = random.Random(hash((self.config.seed, idx, self.train,
                                  random.random() if self.train else 0)))
        row = self.table.row(idx)
        label = self.label_index(row["label"])
        data = row["data"]

        target_len = self.TARGET_LEN + (1 if self.use_cls else 0)
        out = np.zeros((target_len, len(self.experts), 2048), np.float32)

        for ei, expert in enumerate(self.experts):
            rows = []
            if self.use_cls:
                # random CLS vector prepend (MIT_Temporal_dl.py:240-241)
                rows.append(np.asarray(
                    np.random.default_rng(rng.randrange(2**31)).random(
                        (2048,)), np.float32))
            key = expert if self.train else f"test-{expert}"
            paths = []
            for chunk in data.values():
                try:
                    paths.append(chunk[key][0])
                except (KeyError, IndexError, TypeError):
                    continue
            paths = sorted(paths)[: self.TARGET_LEN]
            for p in paths:
                rows.append(manifests.load_tensor(p, width=2048)[0])
            while len(rows) < target_len:
                rows.append(rows[0])     # repeat-pad (:259-260)
            out[:, ei] = np.stack(rows[:target_len])

        return {"label": np.int32(label), "experts": out}


class MITDataModule:
    def __init__(self, train_manifest: str, val_manifest: str,
                 config: Config, max_rows: int = 10_000):
        self.train_manifest = train_manifest
        self.val_manifest = val_manifest
        self.config = config
        self.max_rows = max_rows

    def setup(self):
        self.train_table = manifests.load_manifest(
            self.train_manifest).head(self.max_rows)
        self.val_table = manifests.load_manifest(
            self.val_manifest).head(self.max_rows)
        label_map = manifests.load_moments_categories()
        self._train_ds = MITTemporalDataset(self.train_table, self.config,
                                            train=True, label_map=label_map)
        self._val_ds = MITTemporalDataset(self.val_table, self.config,
                                          train=False, label_map=label_map)
        train_labels = [self._train_ds.label_index(l)
                        for l in self.train_table.column("label")]
        self._sampler = weighted_sampler(train_labels)
        self.train_steps = len(self.train_table) // self.config.batch_size
        return self

    def train_batches(self):
        return Loader(self._train_ds, self.config.batch_size,
                      sampler=self._sampler, seed=self.config.seed)

    def val_batches(self):
        return Loader(self._val_ds, self.config.batch_size)

    def test_batches(self):
        return Loader(self._val_ds, self.config.batch_size)
