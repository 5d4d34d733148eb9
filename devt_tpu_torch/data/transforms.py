"""Host transforms: normalization constants and the embedding transforms.

Own copy of the parts of ``devt_tpu/data/transforms.py`` that the ported
paths use: ImageNet statistics for frames, Kinetics statistics for clips,
and the expert-embedding augmentation and padding of the MMX temporal
loader.  The PIL image and clip transform stacks are not ported yet
(ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

import random

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
KINETICS_MEAN = np.array([0.43216, 0.394666, 0.37645], np.float32)
KINETICS_STD = np.array([0.22803, 0.22145, 0.216989], np.float32)


def expert_augment(x: np.ndarray, rng: random.Random,
                   p_drop: float = 0.3, p_noise: float = 0.3) -> np.ndarray:
    """Embedding-level augmentation (MMX_Temporal_dl.py:176-181):
    p=0.3 modality zero-out, p=0.3 additive N(0, 0.1) noise."""
    if rng.random() < p_drop:
        x = np.zeros_like(x)
    if rng.random() < p_noise:
        noise = np.random.default_rng(rng.randrange(2**31)).standard_normal(
            x.shape).astype(x.dtype)
        x = x + (0.1 ** 0.5) * noise
    return x


def pad_to_width(x: np.ndarray, width: int = 2048) -> np.ndarray:
    """Zero-pad (or cut) the last dim to ``width``
    (MMX_Temporal_dl.py:167-169)."""
    if x.shape[-1] == width:
        return x
    if x.shape[-1] > width:
        return x[..., :width]
    pad = [(0, 0)] * (x.ndim - 1) + [(0, width - x.shape[-1])]
    return np.pad(x, pad)
