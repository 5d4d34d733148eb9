"""Index samplers: port of ``devt_tpu/data/samplers.py``.

``weighted_sampler`` is the torch ``WeightedRandomSampler`` built from
inverse class counts that the MIT loader uses to balance the 305-way head
(src/dataloaders/mit/MIT_Temporal_dl.py:144-161): weight(sample) =
1 / count(class(sample)), sampled with replacement to the dataset size.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


def inverse_class_weights(labels: Sequence[int]) -> np.ndarray:
    labels = np.asarray(labels)
    uniq, counts = np.unique(labels, return_counts=True)
    class_w = {int(u): 1.0 / c for u, c in zip(uniq, counts)}
    return np.asarray([class_w[int(l)] for l in labels], np.float64)


def weighted_sampler(labels: Sequence[int],
                     num_samples: int | None = None
                     ) -> Callable[[np.random.Generator], np.ndarray]:
    """Returns a sampler fn for ``pipeline.Loader``: draws ``num_samples``
    indices with replacement, probability ∝ inverse class frequency."""
    weights = inverse_class_weights(labels)
    probs = weights / weights.sum()
    n = num_samples or len(weights)

    def sample(rng: np.random.Generator) -> np.ndarray:
        return rng.choice(len(probs), size=n, replace=True, p=probs)

    return sample
