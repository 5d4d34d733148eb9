"""Training/eval harness: port of ``devt_tpu/train/harness.py``.

The ``pl.Trainer`` of this package (src/main.py:87-88), an explicit loop
around the step executors of ``parallel/train_step.py``:

  * the host pipeline yields fixed-shape numpy batches (``data/``);
  * ``data.pipeline.device_prefetch`` places them on the card ahead of the
    step that reads them (pinned staging, a side stream);
  * validation at epoch cadence fills RunningBuffers and fires the
    epoch-end callbacks (threshold-swept F1 / mAP / report);
  * an asynchronous checkpoint every ``eval_every_epochs`` epochs and at
    the end (the write runs while the next epoch trains), best-metric
    checkpoints with retention;
  * step-exact resume: a restored step maps back to (epoch, batch within
    the epoch), and since every step's dropout folds ``state.step`` into
    the seed, a resumed run repeats an unbroken one;
  * the loss is read back only on log steps, where a non-finite loss
    aborts the run;
  * with ``profile_dir`` set, ``torch.profiler`` traces train steps 3-8,
    with spans (``train/...``) for the wait for each batch, the step's
    launches, the loss readback, an epoch's start, validation and the
    checkpoint.

It runs on ``cuda`` unless the caller passes ``device="cpu"``, and raises
without a card.  Meshes are not ported yet (ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from devt_tpu_torch.config import Config
from devt_tpu_torch.data.pipeline import device_prefetch, is_numeric
from devt_tpu_torch.parallel.train_step import (_no_mesh, make_eval_step,
                                                make_multi_step,
                                                make_train_step)
from devt_tpu_torch.serve import resolve_device
from devt_tpu_torch.train import checkpoint as ckpt_lib
from devt_tpu_torch.train.callbacks import Callback
from devt_tpu_torch.train.loggers import JsonlLogger
from devt_tpu_torch.train.metrics import RunningBuffers
from devt_tpu_torch.train.optimizers import build_optimizer
from devt_tpu_torch.train.profiling import StepTimer, Trace, annotate
from devt_tpu_torch.train.state import TrainState, model_buffers


def _annotated(iterator):
    """``iterator``'s items, each wait for one a profiler span:
    ``train/first_batch`` for an epoch's first (its loader starts then,
    overlapping nothing), ``train/next_batch`` for the others."""
    it = iter(iterator)
    name = "train/first_batch"
    while True:
        with annotate(name):
            item = next(it, None)
        if item is None:
            return
        yield item
        name = "train/next_batch"


def _stacked(iterator, k: int):
    """Group k placed batches into one batch stacked on a new leading
    axis (drops a trailing partial group — the loader's drop_last)."""
    group = []
    for item in iterator:
        group.append(item)
        if len(group) == k:
            yield {key: torch.stack([g[key] for g in group])
                   for key in group[0]}
            group = []


class Trainer:
    def __init__(self, config: Config, callbacks: Sequence[Callback] = (),
                 logger=None, mesh=None, use_mesh: bool = False,
                 device: str | torch.device | None = None):
        # a mesh, or the JAX entry point's use_mesh, is not ported yet
        _no_mesh(mesh if mesh is not None else (use_mesh or None))
        self.config = config
        self.device = resolve_device(device)
        self.callbacks = list(callbacks)
        self.logger = logger or JsonlLogger(name=config.name)
        self.buffers = RunningBuffers()
        # the step executors' integer seed (JAX: PRNGKey(config.seed))
        self._rng = config.seed
        self.profile_path: str | None = None

    # ------------------------------------------------------------------
    def _init_state(self, model, steps_per_epoch: int) -> TrainState:
        """A state over the model's own parameters and buffers, on the
        trainer's device, restored from ``config.resume`` when set."""
        model.to(self.device)
        tx = build_optimizer(self.config, steps_per_epoch)
        state = TrainState.create(dict(model.named_parameters()), tx,
                                  model_state=model_buffers(model))
        if self.config.resume:
            state = ckpt_lib.restore(self.config.resume, state)
        return state

    @staticmethod
    def _split_host_only(batch):
        """Non-numeric entries (e.g. paths) stay on the host."""
        device = {k: v for k, v in batch.items() if is_numeric(v)}
        host = {k: v for k, v in batch.items() if k not in device}
        return device, host

    def _place(self, batch) -> dict:
        device, _ = self._split_host_only(batch)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in device.items()}

    # ------------------------------------------------------------------
    def fit(self, model, datamodule) -> TrainState:
        cfg = self.config
        datamodule.setup()
        # steps_per_epoch counts what the loop executes: a sized loader's
        # length, else the datamodule's declared count (synthetic
        # generators)
        steps_per_epoch = max(getattr(datamodule, "train_steps", 1), 1)
        try:
            steps_per_epoch = max(len(datamodule.train_batches()), 1)
        except TypeError:
            pass
        state = self._init_state(model, steps_per_epoch)
        self._saver = ckpt_lib.AsyncSaver()

        dev = self.device
        train_step = make_train_step(model, cfg, device=dev)
        eval_step = make_eval_step(model, cfg, device=dev)
        needs_train_aux = any(getattr(cb, "on_train_batch_end", None)
                              and type(cb).on_train_batch_end
                              is not Callback.on_train_batch_end
                              for cb in self.callbacks)
        unroll = max(cfg.unroll_steps, 1)
        multi_step = (make_multi_step(model, cfg, unroll, device=dev)
                      if unroll > 1 and not needs_train_aux else None)

        global_step = int(state.step)
        # step-exact resume: the restored step maps back to (epoch,
        # batch within the epoch).  With multi-step unrolling _stacked
        # drops the trailing partial group, so an epoch advances the step
        # by unroll * (spe // unroll): the inversion uses that count.
        epoch_steps = (unroll * (steps_per_epoch // unroll)
                       if multi_step is not None else steps_per_epoch)
        epoch_steps = max(epoch_steps, 1)
        start_epoch = global_step // epoch_steps
        resume_skip = global_step % epoch_steps
        timer = StepTimer()
        profiler: Trace | None = None
        run_steps = 0      # train steps run in THIS call (a multi-step
                           # launch counts as ``unroll``): the profiled
                           # window does not move when resuming
        try:
            for epoch in range(start_epoch, cfg.epochs):
                with annotate("train/epoch_start"):
                    loader = datamodule.train_batches()
                    if hasattr(loader, "set_epoch"):
                        # reshuffle per epoch + the mid-epoch resume skip
                        loader.set_epoch(
                            epoch, resume_skip if epoch == start_epoch else 0)
                # batches are placed ``host_batch_prefetch`` steps ahead
                # (paths and other host-only entries are dropped there)
                placed_iter = device_prefetch(
                    loader, device=dev,
                    depth=max(cfg.host_batch_prefetch, 1))
                if multi_step is not None:
                    placed_iter = _stacked(placed_iter, unroll)
                for placed in _annotated(placed_iter):
                    # trace the steady state: start once ≥2 train steps
                    # ran (past the first calls), stop once ≥8 have
                    if cfg.profile_dir and profiler is None \
                            and self.profile_path is None and run_steps >= 2:
                        profiler = Trace(cfg.profile_dir)
                        profiler.start()
                    with annotate("train/step"):
                        if multi_step is not None:
                            state, metrics = multi_step(state, placed,
                                                        self._rng)
                            global_step += unroll
                            run_steps += unroll
                        else:
                            state, metrics = train_step(state, placed,
                                                        self._rng)
                            global_step += 1
                            run_steps += 1
                    if profiler is not None and run_steps >= 8:
                        self.profile_path = profiler.stop()
                        profiler = None
                    if needs_train_aux:
                        _, aux = eval_step(state, placed)
                        for cb in self.callbacks:
                            cb.on_train_batch_end(aux, self.logger,
                                                  global_step)
                    log_hit = (global_step % cfg.log_every < unroll) \
                        if multi_step else global_step % cfg.log_every == 0
                    if log_hit:
                        # the loss readback is the sync point
                        with annotate("train/readback"):
                            timer.mark_step(metrics["loss"])
                        loss_val = float(metrics["loss"])
                        if not np.isfinite(loss_val):
                            self.logger.log({"train/loss": loss_val,
                                             "fatal": "non-finite loss"},
                                            global_step)
                            raise FloatingPointError(
                                f"non-finite loss {loss_val} at step "
                                f"{global_step}; last checkpoint in "
                                f"{cfg.checkpoint_dir!r}")
                        rec = {"train/loss": loss_val, "epoch": epoch}
                        rec.update(timer.summary(
                            items_per_step=cfg.batch_size * cfg.log_every))
                        self.logger.log(rec, global_step)
                    else:
                        timer.mark_step()
                    if 0 < cfg.max_steps <= global_step:
                        break

                if (epoch + 1) % cfg.eval_every_epochs == 0:
                    with annotate("train/validate"):
                        results = self.validate(model, datamodule, state,
                                                eval_step, global_step)
                    with annotate("train/checkpoint"):
                        self._maybe_save_best(results, state, global_step)
                        # async: the write runs while the next epoch
                        # trains
                        self._saver.save(cfg.checkpoint_dir, state, cfg)
                if 0 < cfg.max_steps <= global_step:
                    break

            self._saver.save(cfg.checkpoint_dir, state, cfg)
        finally:
            # always await the writer, even on the non-finite-loss abort
            if profiler is not None:
                self.profile_path = profiler.stop()
            self._saver.close()
        return state

    # ------------------------------------------------------------------
    def _maybe_save_best(self, results: dict, state, step: int) -> None:
        """Best-metric checkpointing: when ``config.best_metric`` improves,
        save to ``<checkpoint_dir>/best`` and keep the newest
        ``keep_best_k`` (src/main.py:57-58, callbacks.py:100-102)."""
        cfg = self.config
        key = cfg.best_metric
        if not key or key not in results:
            return
        value = float(results[key])
        best = getattr(self, "_best_value", None)
        improved = best is None or (
            value > best if cfg.best_mode == "max" else value < best)
        if not improved:
            return
        self._best_value = value
        best_dir = os.path.join(cfg.checkpoint_dir, "best")
        self._saver.save(best_dir, state, cfg, step=step)
        # best saves are rare: await the write so the retention pass sees
        # the finished directory
        self._saver.wait()
        ckpt_lib.prune_checkpoints(best_dir, max(cfg.keep_best_k, 1))
        self.logger.log({f"best/{key}": value}, step)

    # ------------------------------------------------------------------
    def validate(self, model, datamodule, state, eval_step=None,
                 step: int = 0) -> dict:
        eval_step = eval_step or make_eval_step(model, self.config,
                                                device=self.device)
        losses = []
        ssl_cbs = [cb for cb in self.callbacks
                   if hasattr(cb, "eval_batch")]
        for batch in datamodule.val_batches():
            loss, aux = eval_step(state, self._place(batch))
            losses.append(float(loss))
            _, host = self._split_host_only(batch)
            if ssl_cbs:
                for cb in ssl_cbs:
                    cb.eval_batch(aux, self.buffers)
            else:
                self.buffers.append({**aux, "path": host.get("path")})
        results = {"val/loss": float(np.mean(losses)) if losses else 0.0}
        self.logger.log(results, step)
        for cb in self.callbacks:
            out = cb.on_validation_epoch_end(self.buffers, self.logger, step)
            if isinstance(out, dict):
                results.update(out)
        return results

    # ------------------------------------------------------------------
    def test(self, model, datamodule, state=None, ckpt_path: str = "") -> dict:
        cfg = self.config
        datamodule.setup()
        if state is None:
            state = self._init_state(model, 1)
            path = ckpt_path or ckpt_lib.latest_checkpoint(cfg.checkpoint_dir)
            if path:
                state = ckpt_lib.restore(path, state)
        eval_step = make_eval_step(model, cfg, device=self.device)
        losses = []
        for batch in datamodule.test_batches():
            loss, aux = eval_step(state, self._place(batch))
            losses.append(float(loss))
            _, host = self._split_host_only(batch)
            self.buffers.append({**aux, "path": host.get("path")})
        results = {"test/loss": float(np.mean(losses)) if losses else 0.0}
        for cb in self.callbacks:
            out = cb.on_test_epoch_end(self.buffers, self.logger,
                                       int(state.step))
            if isinstance(out, dict):
                results.update(out)
        self.logger.log({"test/loss": results["test/loss"]}, int(state.step))
        return results
