"""Checkpoints: port of ``devt_tpu/train/checkpoint.py``.

A checkpoint is the directory ``<ckpt_dir>/step_<n>`` holding
``state.pt``: a ``torch.save`` of ``{"step", "params", "model_state",
"opt_state"}``, the parameters and buffers keyed by their ``state_dict``
names and the optimizer state as the dicts and lists of tensors and
numbers that ``train/optimizers.py`` keeps, so ``torch.load(...,
weights_only=True)`` reads it back.  Beside the step directories,
``config.yaml`` snapshots the config that produced them, written without
PyYAML (flat keys, JSON scalars: a YAML reader and
``Config.from_yaml`` load it).

Saves are asynchronous (:class:`AsyncSaver`): ``save`` copies the state
to host memory before it returns, because the train step updates the
parameters and moments in place, then a thread writes the copy to a
temporary directory and renames it into place.  At most one write is
outstanding, and a crash mid-write leaves the previous checkpoints whole.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import torch

from devt_tpu_torch.config import Config
from devt_tpu_torch.train.state import TrainState, _map_tensors

STATE_FILE = "state.pt"


def _host_copy(tree: Any) -> Any:
    """A copy of every tensor of ``tree`` in host memory, owned by the
    copy (a CPU tensor is cloned, not shared)."""
    return _map_tensors(tree, lambda t: t.detach().to("cpu", copy=True))


def _payload(state: TrainState) -> dict[str, Any]:
    """ONE schema for every save — ``restore`` mirrors it."""
    return _host_copy({"step": int(state.step), "params": state.params,
                       "model_state": state.model_state,
                       "opt_state": state.opt_state})


def _yaml_scalar(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        text = repr(v)
        mantissa, e, exp = text.partition("e")
        if e and "." not in mantissa:    # YAML 1.1 floats need the dot
            text = f"{mantissa}.0e{exp}"
        return text
    return json.dumps(v)


def save_config(config: Config, path: str) -> None:
    """The flat config as YAML: one ``key: value`` line a field, strings
    quoted, sequences in flow style."""
    lines = []
    for k, v in config.to_dict().items():
        if isinstance(v, (list, tuple)):
            v = "[" + ", ".join(_yaml_scalar(x) for x in v) + "]"
        else:
            v = _yaml_scalar(v)
        lines.append(f"{k}: {v}")
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.replace(tmp, path)


def _write(path: str, payload: dict) -> None:
    """Write ``payload`` to the checkpoint directory ``path`` through a
    temporary directory beside it."""
    parent, name = os.path.split(path)
    tmp = os.path.join(parent, f".{name}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def save(ckpt_dir: str, state: TrainState, config: Config,
         step: int | None = None) -> str:
    """Synchronous save: an AsyncSaver whose write is awaited."""
    with AsyncSaver() as saver:
        return saver.save(ckpt_dir, state, config, step)


class AsyncSaver:
    """Checkpoint saves that overlap training.

    ``save`` takes the host copy of the state (waiting for the card to
    finish the step that produced it) and hands the file write to a
    thread; training resumes while the write runs.  The next ``save`` or
    ``close`` first waits for that write, and re-raises its error."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, ckpt_dir: str, state: TrainState, config: Config,
             step: int | None = None) -> str:
        ckpt_dir = os.path.abspath(ckpt_dir)
        step = int(state.step) if step is None else step
        path = os.path.join(ckpt_dir, f"step_{step}")
        payload = _payload(state)          # before the next step runs
        self.wait()                        # ≤1 write outstanding
        os.makedirs(ckpt_dir, exist_ok=True)

        def write():
            try:
                _write(path, payload)
            except BaseException as e:  # noqa: BLE001 — re-raised in wait
                self._error = e

        self._thread = threading.Thread(target=write, daemon=False,
                                        name="devt-checkpoint")
        self._thread.start()
        save_config(config, os.path.join(ckpt_dir, "config.yaml"))
        return path

    def wait(self) -> None:
        """Block until the in-flight write (if any) is finalized."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load(path: str) -> dict[str, Any]:
    """A checkpoint's payload, on the CPU, tensors only."""
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)


def restore(path: str, state: TrainState) -> TrainState:
    """Restore into ``state`` in place: the parameters and buffers are
    copied into the model's own tensors (names and shapes must match),
    the optimizer state is replaced, on the state's device."""
    payload = load(path)
    device = state.device
    with torch.no_grad():
        for kind in ("params", "model_state"):
            mine, saved = getattr(state, kind), payload[kind]
            if set(mine) != set(saved):
                raise KeyError(
                    f"{path}: {kind} differs from the model's: missing "
                    f"{sorted(set(mine) - set(saved))}, unexpected "
                    f"{sorted(set(saved) - set(mine))}")
            for k, t in mine.items():
                if t.shape != saved[k].shape:
                    raise ValueError(f"{path}: {k} has shape "
                                     f"{tuple(saved[k].shape)}, the model's "
                                     f"{tuple(t.shape)}")
                t.copy_(saved[k])
    state.opt_state = _map_tensors(payload["opt_state"],
                                   lambda t: t.to(device))
    state.step = int(payload["step"])
    return state


def _steps(ckpt_dir: str) -> list[tuple[int, str]]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                steps.append((int(name.split("_", 1)[1]), name))
            except ValueError:
                continue
    return sorted(steps)


def prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    """Retention policy: keep the ``keep`` highest-step ``step_*``
    checkpoints in ``ckpt_dir`` and delete the rest (used by the best-
    metric saver — the reference's ModelCheckpoint ``save_top_k`` intent,
    src/main.py:57-58)."""
    if keep < 1:
        return
    for _, name in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def latest_checkpoint(ckpt_dir: str) -> str | None:
    steps = _steps(ckpt_dir)
    return os.path.join(ckpt_dir, steps[-1][1]) if steps else None
