"""Manifest readers: port of ``devt_tpu/data/manifests.py``.

The reference's offline tooling dumps one pickled record at a time into an
open file (src/data_processing/temporal/create_mmx_temporal.py:199-207),
and the loaders re-read them in a loop until EOF
(src/dataloaders/mmx/MMX_Temporal_dl.py:70-86).  Records are dicts like
``{"label": [...], "path": str, "scenes": {scene_id: {expert: [paths]}}}``.

The JAX package holds the records in a pandas DataFrame; the port holds
them in a :class:`Table`, a list of record dicts with the few column
operations the datasets use, and imports no pandas.

The CSV corpus of the frame pipeline (``out.csv``) is read with the
standard library's :mod:`csv` into the same :class:`Table`.

Tensor payloads are ``.npy`` (numpy) or the reference's torch ``.pt``
files, read with ``torch.load(weights_only=True)``: tensors only, never
pickled code.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Iterable, Sequence

import numpy as np

from devt_tpu_torch.data.transforms import pad_to_width


class Table:
    """Records as rows, with the column operations of the datasets:
    ``len``, ``row(i)`` (a dict), ``column(name)`` (a list), ``columns``
    (every key some record has, in first-seen order), ``head(n)`` and
    ``take(indices)``.  A record lacking a column reads as None there, as
    a DataFrame built from the records reads NaN."""

    def __init__(self, records: Iterable[dict]):
        self.records = [dict(r) for r in records]
        cols: dict[str, None] = {}
        for r in self.records:
            cols.update(dict.fromkeys(r))
        self.columns = list(cols)

    def __len__(self) -> int:
        return len(self.records)

    def row(self, i: int) -> dict:
        return self.records[i]

    def column(self, name: str) -> list:
        return [r.get(name) for r in self.records]

    def head(self, n: int) -> "Table":
        return self.take(range(min(n, len(self))))

    def take(self, indices: Iterable[int]) -> "Table":
        return Table(self.records[i] for i in indices)


def stream_pickle(path: str) -> list[Any]:
    """Read every record from an append-streamed pickle file."""
    records = []
    with open(path, "rb") as f:
        while True:
            try:
                records.append(pickle.load(f))
            except EOFError:
                break
    return records


def append_pickle(path: str, record: Any) -> None:
    """Append one record (the writer half of the streamed format)."""
    with open(path, "ab") as f:
        pickle.dump(record, f)


def load_manifest(path: str) -> Table:
    """Streamed pickle → :class:`Table` (MMX_Temporal_dl.py:70-86)."""
    return Table(stream_pickle(path))


def load_tensor(path: str, width: int | None = 2048) -> np.ndarray:
    """Load one expert embedding: ``.npy`` with numpy, ``.pt`` with
    ``torch.load(weights_only=True)``.

    Returns shape (1, width) f32, zero-padded on the feature dim
    (MMX_Temporal_dl.py:155-174 semantics; missing file → zeros)."""
    try:
        if path.endswith(".npy"):
            arr = np.load(path)
        else:
            import torch

            arr = torch.load(path, map_location="cpu", weights_only=True)
            arr = (arr.detach().float().numpy()
                   if isinstance(arr, torch.Tensor) else np.asarray(arr))
    except (FileNotFoundError, OSError):
        return np.zeros((1, width or 2048), np.float32)
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 1:
        arr = arr[None, :]
    if width is not None:
        arr = pad_to_width(arr, width)
    return arr


def clean_mmx_temporal(table: Table, target_names: Sequence[str],
                       min_scenes: int = 5) -> Table:
    """Drop rows whose labels are all outside the genre set or with fewer
    than ``min_scenes`` scenes (MMX_Temporal_dl.py:42-68)."""
    keep = []
    for i in range(len(table)):
        row = table.row(i)
        label = row["label"]
        flat = label[0] if len(label) and isinstance(label[0],
                                                     (list, tuple)) else label
        bad = sum(1 for l in flat if l not in target_names)
        if bad == 6:
            continue
        if len(row["scenes"]) < min_scenes:
            continue
        keep.append(i)
    return table.take(keep)


def load_csv_manifest(path: str, shuffle_seed: int | None = 1130,
                      train_rows: int = 6047, val_rows: int = 653
                      ) -> tuple[Table, Table]:
    """CSV corpus (``out.csv`` with img_root + g1..g6 genre columns) with
    the reference's shuffle and fixed train/val split
    (MMX_Light_dl.py:133-141), read with :mod:`csv`.

    An empty cell is missing (None), as pandas reads it NaN; every other
    cell stays a string.  The shuffle is pandas' ``df.sample(frac=1.0,
    random_state=shuffle_seed)``: ``RandomState(shuffle_seed)``'s
    permutation of the rows; ``shuffle_seed=None`` keeps file order."""
    import csv

    with open(path, newline="") as f:
        rows = [{k: (v if v != "" else None) for k, v in r.items()}
                for r in csv.DictReader(f)]
    order = (np.random.RandomState(shuffle_seed).permutation(len(rows))
             if shuffle_seed is not None else np.arange(len(rows)))
    table = Table(rows[i] for i in order)
    return (table.head(train_rows),
            table.take(range(train_rows,
                             min(train_rows + val_rows, len(table)))))


def load_moments_categories(path: str | None = None) -> dict[str, int]:
    """MIT label → id map (src/data_processing/labels/moments_categories.csv,
    used at MIT_Temporal_dl.py:204-212).  Defaults to the copy bundled with
    this package."""
    if path is None:
        path = os.path.join(os.path.dirname(__file__), "labels",
                            "moments_categories.csv")
    import csv

    mapping: dict[str, int] = {}
    with open(path) as f:
        for row in csv.DictReader(f):
            mapping[row["label"]] = int(row["id"])
    return mapping
