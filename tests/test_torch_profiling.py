"""The port's ``train/profiling.py`` on the CPU: ``StepTimer`` against the
JAX package's on the same clock, the ``torch.profiler`` session and its
spans, and the spans the ``Trainer`` writes into a profiled fit."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from devt_tpu.train import profiling as jprof
from devt_tpu_torch.config import Config as TConfig
from devt_tpu_torch.data.pipeline import Loader as TLoader
from devt_tpu_torch.registry import build_model
from devt_tpu_torch.train import profiling as tprof
from devt_tpu_torch.train.harness import Trainer as TTrainer
from tests.test_torch_harness import PTN, _DM, _Log


def _clock(monkeypatch, module, ticks):
    it = iter(ticks)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(it))


@pytest.mark.parametrize("warmup", [0, 2])
def test_step_timer_matches_jax(monkeypatch, warmup):
    """The same clock readings give the JAX package's summary."""
    rng = np.random.default_rng(warmup)
    ticks = np.cumsum(rng.uniform(0.01, 0.2, 12)).tolist()
    summaries = []
    for module in (jprof, tprof):
        _clock(monkeypatch, module, ticks)
        timer = module.StepTimer(warmup=warmup)
        steps = [timer.mark_step() for _ in ticks]
        summaries.append((steps, timer.summary(items_per_step=32)))
    assert summaries[0] == summaries[1]
    # a device scalar given to mark_step is read back
    timer = tprof.StepTimer()
    _clock(monkeypatch, tprof, [0.0])
    timer.mark_step(torch.tensor(1.5))
    assert timer.summary() == {}


def _spans(path) -> list[tuple[str, float, float]]:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["name"], float(e["ts"]), float(e["dur"]))
                  for e in events if e.get("cat") == "user_annotation")


def test_trace_exports_annotated_spans(tmp_path):
    with tprof.trace(str(tmp_path)) as session:
        with tprof.annotate("outer"):
            torch.ones(4).add_(1)
            with tprof.annotate("inner"):
                torch.ones(4).mul_(2)
    assert session.path == str(tmp_path / "trace.json")
    spans = _spans(session.path)
    assert [s[0] for s in spans] == ["inner", "outer"]
    (_, t_in, d_in), (_, t_out, d_out) = spans
    assert t_out <= t_in and t_in + d_in <= t_out + d_out


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tprof.device_memory_stats() == {}


def test_profiled_fit_writes_step_spans(tmp_path):
    """A profiled fit traces train steps 3-8 with a span for each step's
    launches, each wait for a batch (an epoch's first apart), each loss
    readback and each epoch's start; validation, after epoch 2, stays
    outside."""
    cfg = TConfig(**dict(PTN, epochs=3, eval_every_epochs=3, log_every=2,
                         checkpoint_dir=str(tmp_path / "ck"),
                         profile_dir=str(tmp_path / "prof")))
    torch.manual_seed(0)
    trainer = TTrainer(cfg, logger=_Log(), device="cpu")
    trainer.fit(build_model(cfg), _DM(TLoader, cfg, n=16))
    spans = {}
    for name, _, _ in _spans(trainer.profile_path):
        spans[name] = spans.get(name, 0) + 1
    # 4 steps an epoch: steps 3-8 are epoch 0's last two and epoch 1.
    # The window opens on step 3's launches and closes after step 8's:
    # the waits for steps 4 and 6-8 and for epoch 0's end, the readbacks
    # of steps 4 and 6 (a log step every 2)
    assert spans == {"train/step": 6, "train/next_batch": 5,
                     "train/first_batch": 1, "train/epoch_start": 1,
                     "train/readback": 2}
