"""``torch.utils.data`` execution for the map-style datasets: the port's
counterpart of ``devt_tpu/data/grain_adapter.py``.

The port's own :class:`~devt_tpu_torch.data.pipeline.Loader` is the
default under every datamodule.  This adapter runs the same datasets
under a ``torch.utils.data.DataLoader``, for its worker processes: an
``IterableDataset`` yields whole batches (numpy, collated as the
``Loader`` collates them), and ``DataLoader(batch_size=None)`` hands them
on.

Sharding is the ``Loader``'s and Grain's ``ShardOptions(drop_remainder=
True)``: every process draws the same permutation of the epoch
(``default_rng(seed + epoch)``) and reads the ``process_index``-th of
``process_count`` contiguous slices of ``len(dataset) // process_count``
indices; a batch that would be short is dropped.  Worker ``w`` of ``k``
assembles the batches ``b`` with ``b % k == w``, which the DataLoader
returns in order.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from devt_tpu_torch.data.pipeline import MapDataset, _collate


class ShardedBatches(torch.utils.data.IterableDataset):
    """The batches of one process's shard, epoch after epoch."""

    def __init__(self, dataset: MapDataset, batch_size: int, *,
                 shuffle: bool = False, seed: int = 0, num_epochs: int = 1,
                 process_index: int = 0, process_count: int = 1):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process {process_index} of {process_count}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_epochs = num_epochs
        self.process_index = process_index
        self.process_count = process_count

    def shard(self, epoch: int) -> np.ndarray:
        """This process's indices of ``epoch``, in reading order."""
        n = len(self.dataset)
        idx = (np.random.default_rng(self.seed + epoch).permutation(n)
               if self.shuffle else np.arange(n))
        per = n // self.process_count
        return idx[self.process_index * per:(self.process_index + 1) * per]

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        info = torch.utils.data.get_worker_info()
        worker, workers = (info.id, info.num_workers) if info else (0, 1)
        for epoch in range(self.num_epochs):
            idx = self.shard(epoch)
            for b in range(worker, len(idx) // self.batch_size, workers):
                rows = idx[b * self.batch_size:(b + 1) * self.batch_size]
                yield _collate([self.dataset[int(i)] for i in rows])


def _as_is(batch):
    """The batch as the dataset collated it (numpy; the DataLoader's
    default would turn it into tensors)."""
    return batch


def make_torch_loader(dataset: MapDataset, batch_size: int, *,
                      shuffle: bool = False, seed: int = 0,
                      num_epochs: int = 1, num_workers: int = 0,
                      process_index: int = 0, process_count: int = 1
                      ) -> torch.utils.data.DataLoader:
    """A ``DataLoader`` yielding the collated numpy batches of
    ``dataset``'s shard for process ``process_index`` of
    ``process_count``.  Workers are spawned processes: ``dataset`` must
    pickle."""
    return torch.utils.data.DataLoader(
        ShardedBatches(dataset, batch_size, shuffle=shuffle, seed=seed,
                       num_epochs=num_epochs, process_index=process_index,
                       process_count=process_count),
        batch_size=None, num_workers=num_workers, collate_fn=_as_is,
        multiprocessing_context="spawn" if num_workers > 0 else None)
