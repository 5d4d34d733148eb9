"""Metric logging: port of ``devt_tpu/train/loggers.py``.

The default sink is a local JSONL file (works with zero egress); the wandb
adapter, the reference's logging surface (src/main.py:29-35), attaches
when the environment configures wandb.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping


class JsonlLogger:
    """Append-stream metrics to ``<dir>/metrics.jsonl``."""

    def __init__(self, log_dir: str = "runs", name: str = "run"):
        self.dir = os.path.join(log_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "metrics.jsonl")
        self._fh = open(self.path, "a", buffering=1)

    def log(self, metrics: Mapping[str, Any], step: int | None = None) -> None:
        rec = {"ts": time.time()}
        if step is not None:
            rec["step"] = int(step)
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")

    def log_text(self, key: str, text: str, step: int | None = None) -> None:
        self.log({key: text}, step)

    def log_table(self, key: str, columns, rows, step: int | None = None
                  ) -> None:
        """Tabular record (the reference's wandb.Table surface,
        src/callbacks/callbacks.py:285-291) as one JSONL entry."""
        self.log({key: {"columns": list(columns),
                        "data": [list(r) for r in rows]}}, step)

    def close(self) -> None:
        self._fh.close()


class NullLogger:
    """Logs nothing: the logger of every rank but rank 0 in a
    data-parallel run."""

    def log(self, metrics, step=None):
        pass

    def log_text(self, key, text, step=None):
        pass

    def log_table(self, key, columns, rows, step=None):
        pass

    def close(self):
        pass


class WandbLogger:
    """Thin adapter over wandb (optional dependency)."""

    def __init__(self, project: str, name: str, config: Mapping | None = None):
        import wandb  # noqa: deferred import; an optional dependency

        self._run = wandb.init(project=project, name=name,
                               config=dict(config or {}))

    def log(self, metrics, step=None):
        self._run.log(dict(metrics), step=step)

    def log_text(self, key, text, step=None):
        self._run.log({key: text}, step=step)

    def log_table(self, key, columns, rows, step=None):
        import wandb

        table = wandb.Table(columns=list(columns))
        for r in rows:
            table.add_data(*r)
        self._run.log({key: table}, step=step)

    def close(self):
        self._run.finish()


def build_logger(config, log_dir: str = "runs"):
    """wandb (the reference's logger, project ``config.logger``) when the
    environment configures it, JSONL under ``log_dir/config.name``
    otherwise or when wandb fails to start.  The JAX package tries wandb
    whenever it imports; an installed wandb that nothing configured would
    try to log in, so here it is not started then."""
    # an API key, or a mode (offline, disabled, ...) that needs none
    if os.environ.get("WANDB_API_KEY") or os.environ.get("WANDB_MODE"):
        try:
            return WandbLogger(project=config.logger, name=config.name,
                               config=config.to_dict())
        except Exception:   # noqa: BLE001 — JSONL, as the JAX package does
            pass
    return JsonlLogger(log_dir=log_dir, name=config.name)
