"""Tracing and profiling: port of ``devt_tpu/train/profiling.py``.

  * :class:`StepTimer` — wall-clock per-step timing with percentile
    summaries and a throughput readout.  CUDA launches return before the
    card has run them, so ``mark_step`` must be given a device scalar to
    read back (the loss): only that readback waits for the step.
  * :class:`Trace` / :func:`trace` — ``torch.profiler`` over CPU and CUDA
    activity, exported as a Chrome trace (``trace.json``, loadable in
    Perfetto or chrome://tracing).
  * :func:`annotate` — a named span in those traces
    (``torch.profiler.record_function``).
  * :func:`device_memory_stats` — bytes in use on each CUDA device.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any

import numpy as np
import torch


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: list[float] = []
        self._last: float | None = None
        self._seen = 0

    def mark_step(self, sync_value: Any = None) -> float | None:
        """Call once per step; returns the latest step time (seconds).

        ``sync_value``: a device scalar (e.g. the loss) — it is read back
        to the host so the timestamp reflects completed execution."""
        if sync_value is not None:
            float(sync_value)
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            self._seen += 1
            if self._seen > self.warmup:
                dt = now - self._last
                self.times.append(dt)
        self._last = now
        return dt

    def summary(self, items_per_step: int | None = None) -> dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        out = {
            "step_ms_p50": float(np.percentile(arr, 50) * 1e3),
            "step_ms_p90": float(np.percentile(arr, 90) * 1e3),
            "step_ms_mean": float(arr.mean() * 1e3),
            "steps_per_sec": float(1.0 / arr.mean()),
        }
        if items_per_step:
            out["items_per_sec"] = float(items_per_step / arr.mean())
        return out

    def reset(self) -> None:
        self.times.clear()
        self._last = None
        self._seen = 0


class Trace:
    """A ``torch.profiler`` session writing ``<log_dir>/trace.json``:
    CPU activity always, CUDA activity when a card is present."""

    def __init__(self, log_dir: str):
        self.path = os.path.join(log_dir, "trace.json")
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> str:
        """End the session (waiting for the card first) and export it;
        returns the trace's path."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        return self.path


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body into ``log_dir/trace.json``."""
    session = Trace(log_dir)
    session.start()
    try:
        yield session
    finally:
        session.stop()


def annotate(name: str):
    """Named span visible in profiler traces."""
    return torch.profiler.record_function(name)


def device_memory_stats() -> dict[str, int]:
    """Bytes in use on each CUDA device (empty without one)."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": int(torch.cuda.memory_stats(i).get(
                "allocated_bytes.all.current", 0))
            for i in range(torch.cuda.device_count())}
