"""Batching, shuffling, per-process sharding, worker threads, placement.

Port of ``devt_tpu/data/pipeline.py``, the execution layer under every
datamodule:

  * fixed-shape numpy batches (drop_last always, as the reference's
    loaders);
  * per-process sharding: process ``process_index`` of ``process_count``
    reads a contiguous slice of every epoch's index permutation;
  * per-rank rows (:meth:`Loader.shard_rows`, the data-parallel step): a
    rank assembles only its rows of each global batch, so that the rows
    of ranks 0..n-1 concatenated are the one-process batch;
  * thread-pool item assembly with a bounded queue of ready batches;
  * :func:`device_prefetch`, which places batches on the card ahead of the
    step that reads them: a copy into pinned host memory, then an
    asynchronous host-to-device copy on a side CUDA stream that the
    consumer's stream waits on.  A copy from pageable numpy memory with
    ``non_blocking=True`` is a synchronous one, so the pinned staging is
    what lets the copy of step N+1 overlap step N.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Mapping, Protocol, Sequence

import numpy as np
import torch


class MapDataset(Protocol):
    def __len__(self) -> int: ...
    def __getitem__(self, idx: int) -> dict[str, np.ndarray]: ...


def _collate(items: Sequence[dict]) -> dict[str, np.ndarray]:
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray) or (
                np.isscalar(vals[0]) and not isinstance(vals[0], str)):
            out[key] = np.stack(vals)
        else:
            out[key] = vals          # e.g. paths — kept as a list
    return out


def _put_unless(q: queue.Queue, item, done: threading.Event) -> bool:
    """Bounded put that gives up once ``done`` is set: a producer must
    never block forever on a full queue whose consumer has gone."""
    while not done.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


class Loader:
    """Epoch iterator over a map-style dataset."""

    def __init__(self, dataset: MapDataset, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 sampler: Callable[[np.random.Generator], np.ndarray] | None = None,
                 num_workers: int = 4, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.sampler = sampler
        # more assembly threads than cores measurably hurts: cap at the
        # host's core count
        self.num_workers = min(num_workers, os.cpu_count() or num_workers)
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count or 1
        self._rows = (0, 1)
        self._epoch = 0
        self._skip_batches = 0

    def __len__(self) -> int:
        per_host = len(self.dataset) // self.process_count
        return per_host // self.batch_size

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        """Position the stream: the next ``__iter__`` runs epoch ``epoch``'s
        permutation (``default_rng(seed + epoch)``, the torch
        ``DataLoader(shuffle=True)`` reshuffle-per-epoch contract), minus
        its first ``skip_batches`` batches (step-exact resume from a
        mid-epoch checkpoint).  The Trainer calls this every epoch; a
        fresh Loader otherwise replays epoch 0's order."""
        self._epoch = int(epoch)
        self._skip_batches = int(skip_batches)

    def shard_rows(self, index: int, count: int) -> None:
        """Assemble only rank ``index``'s rows of each batch: the
        ``index``-th of ``count`` equal contiguous blocks of its
        ``batch_size`` rows (``parallel.mesh.shard_batch`` of the batch a
        single process assembles, without assembling the others).  The
        number of batches, the order and the resume skip are the single
        process'.  ``ValueError`` when the rows do not divide."""
        if not 0 <= index < count or self.batch_size % count:
            raise ValueError(f"rank {index} of {count}: batch of "
                             f"{self.batch_size} rows does not divide")
        self._rows = (int(index), int(count))

    def _epoch_indices(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed + self._epoch)
        if self.sampler is not None:
            idx = self.sampler(rng)
        elif self.shuffle:
            idx = rng.permutation(len(self.dataset))
        else:
            idx = np.arange(len(self.dataset))
        # per-process shard: contiguous split of the shared-seed permutation
        per_host = len(idx) // self.process_count
        start = self.process_index * per_host
        return idx[start:start + per_host]

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        indices = self._epoch_indices()
        self._epoch += 1
        n_batches = len(indices) // self.batch_size
        if self._skip_batches:
            # step-exact resume: drop the consumed batches at the index
            # level, so nothing of them is assembled
            skip = min(self._skip_batches, n_batches)
            indices = indices[skip * self.batch_size:]
            n_batches -= skip
            self._skip_batches = 0
        if n_batches == 0:
            return

        # fill-into fast path: a dataset exposing ``item_spec`` (key ->
        # (shape, dtype)) and ``getitem_into(idx, out)`` writes each
        # sample directly into its slot of the preallocated batch
        fill = getattr(self.dataset, "getitem_into", None)
        spec = getattr(self.dataset, "item_spec", None)

        rank, ranks = self._rows
        rows = self.batch_size // ranks

        def assemble(b: int) -> dict[str, np.ndarray]:
            start = b * self.batch_size + rank * rows
            batch_idx = indices[start:start + rows]
            if fill is not None and spec is not None:
                out = {k: np.empty((len(batch_idx),) + tuple(s), d)
                       for k, (s, d) in spec.items()}
                for j, i in enumerate(batch_idx):
                    fill(int(i), {k: v[j] for k, v in out.items()})
                return out
            items = [self.dataset[int(i)] for i in batch_idx]
            return _collate(items)

        if self.num_workers <= 1:
            for b in range(n_batches):
                yield assemble(b)
            return

        # overlapped assembly: a bounded queue of ready batches.  A worker
        # exception is forwarded to the consumer; submission is windowed
        # (at most prefetch + num_workers batches in flight), and the
        # producer stops once the consumer has gone.
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = threading.Event()
        stop = object()
        window = self.prefetch + self.num_workers

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    inflight: deque = deque()
                    for b in range(min(window, n_batches)):
                        inflight.append(pool.submit(assemble, b))
                    next_b = len(inflight)
                    while inflight:
                        if not _put_unless(q, inflight.popleft().result(),
                                           done):
                            for f in inflight:
                                f.cancel()
                            return
                        if next_b < n_batches:
                            inflight.append(pool.submit(assemble, next_b))
                            next_b += 1
                _put_unless(q, stop, done)
            except BaseException as e:  # noqa: BLE001 — forwarded
                _put_unless(q, e, done)

        t = threading.Thread(target=producer, daemon=True,
                             name="devt-loader")
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            done.set()
        t.join()


def is_numeric(v) -> bool:
    """A numpy array of numbers: what goes to the device (paths and other
    host-only entries stay behind)."""
    return isinstance(v, np.ndarray) and v.dtype.kind in "biuf"


class PinnedPlacer:
    """Places numpy batches on a CUDA device through pinned staging
    buffers and a side stream.

    ``place(batch)`` (any thread) copies each numeric array into a pinned
    buffer of a ring of ``slots``, enqueues its host-to-device copy on the
    side stream and records an event after it.  It returns the device
    tensors and that event; :meth:`receive` (the consumer's thread) makes
    the consumer's current stream wait on the event and marks every
    tensor as used on that stream (``record_stream``), so the caching
    allocator does not hand the memory to the side stream again while a
    step may still read it.  A slot is refilled only after the event of
    its previous copy has completed.  Non-numeric entries (paths) are
    dropped: they stay on the host."""

    def __init__(self, device: torch.device, slots: int = 2):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"PinnedPlacer places on a CUDA device, not "
                             f"{self.device}")
        self.stream = torch.cuda.Stream(device=self.device)
        self._slots: list[dict[str, torch.Tensor]] = [
            {} for _ in range(max(slots, 2))]
        self._events: list[torch.cuda.Event | None] = [None] * len(
            self._slots)
        self._next = 0

    def _staging(self, slot: dict, key: str, arr: np.ndarray
                 ) -> torch.Tensor:
        buf = slot.get(key)
        want = torch.from_numpy(arr[:0]).dtype
        if buf is None or tuple(buf.shape) != arr.shape \
                or buf.dtype != want:
            buf = torch.empty(arr.shape, dtype=want, pin_memory=True)
            slot[key] = buf
        return buf

    def place(self, batch: Mapping) -> tuple[dict, torch.cuda.Event]:
        i = self._next
        self._next = (i + 1) % len(self._slots)
        if self._events[i] is not None:
            self._events[i].synchronize()    # the slot's last copy is done
        slot = self._slots[i]
        out = {}
        with torch.cuda.stream(self.stream):
            for k, v in batch.items():
                if not is_numeric(v):
                    continue
                buf = self._staging(slot, k, v)
                np.copyto(buf.numpy(), v, casting="no")
                out[k] = buf.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self._events[i] = event
        return out, event

    def receive(self, placed: tuple[dict, torch.cuda.Event]) -> dict:
        tensors, event = placed
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)
        for t in tensors.values():
            t.record_stream(current)
        return tensors


def _place_on_cpu(batch: Mapping) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items() if is_numeric(v)}


def device_prefetch(iterator, device: str | torch.device = "cuda",
                    depth: int = 2) -> Iterator[dict]:
    """Yield the batches of ``iterator`` as tensors on ``device``, placed
    up to ``depth`` batches ahead of consumption.

    A thread pulls host batches and places them: on a CUDA device through
    a :class:`PinnedPlacer` (pinned staging, a side stream, the consumer's
    stream waiting on the copy), on the CPU as tensors over the numpy
    memory, pinning nothing.  A worker exception is raised in the
    consumer; when the consumer stops early (``close()``), the thread
    stops too, before ``close()`` returns."""
    device = torch.device(device)
    if device.type == "cuda":
        placer = PinnedPlacer(device, slots=depth + 1)
        place, receive = placer.place, placer.receive
    else:
        place, receive = _place_on_cpu, (lambda placed: placed)
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = threading.Event()
    stop = object()

    def worker():
        it = iter(iterator)
        try:
            for item in it:
                if not _put_unless(q, place(item), done):
                    return
            _put_unless(q, stop, done)
        except BaseException as e:  # noqa: BLE001 — forwarded to consumer
            _put_unless(q, e, done)
        finally:
            # a consumer that left stops the source too (a Loader's own
            # assembly thread ends when its generator is closed)
            close = getattr(it, "close", None)
            if close is not None:
                close()

    t = threading.Thread(target=worker, daemon=True,
                         name="devt-device-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield receive(item)
    finally:
        done.set()
        # the worker sees ``done`` at its next put: one batch at most.  A
        # worker left running would hold its source (a rank's batches hold
        # the process group) past the interpreter's exit
        if threading.current_thread() is not t and not sys.is_finalizing():
            t.join()
