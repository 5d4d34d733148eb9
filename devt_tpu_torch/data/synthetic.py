"""Synthetic data: port of the embedding half of ``devt_tpu/data/synthetic.py``.

Deterministic, reference-shaped batches for every model family
(``SyntheticDataModule`` on ``registry.example_batch``), and the fake MMX
and MIT expert corpora (``.npy`` tensors and streamed-pickle manifests).
The frame, CSV and AVI writers are not ported yet (ROADMAP.md queue 1,
item 10).
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np

from devt_tpu_torch.config import MMX_GENRES_15, Config
from devt_tpu_torch.data.manifests import (append_pickle,
                                           load_moments_categories)
from devt_tpu_torch.registry import example_batch


class SyntheticDataModule:
    """Fixed-shape random batches shaped for ``config.model``."""

    def __init__(self, config: Config, train_size: int = 8,
                 val_size: int = 4, test_size: int = 4):
        self.config = config
        self.train_steps = max(train_size // config.batch_size, 1)
        self.val_steps = max(val_size // config.batch_size, 1)
        self.test_steps = max(test_size // config.batch_size, 1)

    def setup(self):
        return self

    def _batches(self, n, seed0):
        for i in range(n):
            cfg = self.config.replace(seed=seed0 + i)
            yield example_batch(cfg)

    def train_batches(self):
        return self._batches(self.train_steps, self.config.seed)

    def val_batches(self):
        return self._batches(self.val_steps, self.config.seed + 10_000)

    def test_batches(self):
        return self._batches(self.test_steps, self.config.seed + 20_000)


def write_fake_expert_corpus(root: str, n_movies: int = 8,
                             scenes_per_movie: int = 6,
                             experts=("img-embeddings", "location-embeddings",
                                      "video-embeddings"),
                             with_test_prefix: bool = True,
                             seed: int = 0) -> tuple[str, str]:
    """Synthetic MMX-temporal corpus: .npy expert tensors (width 512 for a
    video expert, 2048 for the others) + streamed-pickle train/val
    manifests with the reference's record structure (``{"label":
    [[genres]], "path": str, "scenes": {sid: {chunk: {expert: [paths]}}}}``
    — create_mmx_temporal.py:20-81)."""
    rng = np.random.default_rng(seed)
    tensor_dir = os.path.join(root, "tensors")
    os.makedirs(tensor_dir, exist_ok=True)

    def make_manifest(path: str, start: int, count: int):
        for m in range(start, start + count):
            genres = [MMX_GENRES_15[rng.integers(len(MMX_GENRES_15))],
                      MMX_GENRES_15[rng.integers(len(MMX_GENRES_15))]]
            scenes = OrderedDict()
            for s in range(scenes_per_movie):
                chunk = {}
                for e in experts:
                    dim = 2048 if "video" not in e else 512
                    t = rng.standard_normal((1, dim)).astype(np.float32)
                    tp = os.path.join(tensor_dir, f"m{m}_s{s}_{e}.npy")
                    np.save(tp, t)
                    chunk[e] = [tp]
                    if with_test_prefix:
                        chunk[f"test-{e}"] = [tp]
                scenes[f"{s:03d}"] = {"000": chunk}
            append_pickle(path, {"label": [genres],
                                 "path": f"movie{m}",
                                 "scenes": scenes})

    train = os.path.join(root, "train.pkl")
    val = os.path.join(root, "val.pkl")
    make_manifest(train, 0, n_movies)
    make_manifest(val, n_movies, max(n_movies // 2, 2))
    return train, val


def write_fake_mit_corpus(root: str, n_videos: int = 12,
                          chunks_per_video: int = 4,
                          experts=("img-embeddings", "location-embeddings"),
                          seed: int = 0) -> tuple[str, str]:
    """Synthetic MIT-temporal corpus (record = ``{"label": str, "path": str,
    "data": {cid: {expert: [paths]}}}`` — create_mit_temporal.py:26-64)."""
    rng = np.random.default_rng(seed)
    labels = list(load_moments_categories().keys())[:10]
    tensor_dir = os.path.join(root, "mit_tensors")
    os.makedirs(tensor_dir, exist_ok=True)

    def make(path: str, start: int, count: int):
        for v in range(start, start + count):
            data = {}
            for c in range(chunks_per_video):
                chunk = {}
                for e in experts:
                    t = rng.standard_normal((1, 2048)).astype(np.float32)
                    tp = os.path.join(tensor_dir, f"v{v}_c{c}_{e}.npy")
                    np.save(tp, t)
                    chunk[e] = [tp]
                    chunk[f"test-{e}"] = [tp]
                data[f"{c:03d}"] = chunk
            append_pickle(path, {"label": labels[v % len(labels)],
                                 "path": f"video{v}", "data": data})

    train = os.path.join(root, "mit_train.pkl")
    val = os.path.join(root, "mit_val.pkl")
    make(train, 0, n_videos)
    make(val, n_videos, max(n_videos // 2, 2))
    return train, val
