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
without a card.

Over a mesh (``mesh=``, or ``use_mesh=True``: the mesh of ``config.dp``,
``mp``, ``pp`` and ``sp``, as the JAX trainer makes it) every rank runs
the loop: the state is broadcast from rank 0 and placed as JAX's trainer
places it (``dp_mode`` ``"fsdp"`` / ``"fsdp_gspmd"``: sharded over
``data`` by ``parallel/fsdp.py``; otherwise by the Megatron rules of
``parallel/sharding.py``, which split only over a model axis of more
than one rank and never on a mesh with a ``pipe`` axis: pipeline and
sequence-parallel meshes hold it whole on every rank), each rank assembles only its data index's rows of every
global batch (``Loader.shard_rows``; another iterable's batches are
sliced), the executors reduce over the ranks, and validation sees the
gathered aux, so the epoch metrics are the same on every rank.  Rank 0
alone logs, writes checkpoints and runs the test callbacks (they write
files); the others wait for its last write.  A checkpoint holds the
whole state in the one-device format (a sharded state is gathered on
every rank, then rank 0 writes it), and is read on every rank and split
again, so it moves between one card and a mesh.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from devt_tpu_torch.config import Config
from devt_tpu_torch.data.pipeline import device_prefetch, is_numeric
from devt_tpu_torch.parallel import collectives, fsdp, layout, sharding
from devt_tpu_torch.parallel.distributed import process_index
from devt_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS,
                                          SEQ_AXIS, make_mesh, shard_batch)
from devt_tpu_torch.parallel.train_step import (make_eval_step,
                                                make_multi_step,
                                                make_train_step)
from devt_tpu_torch.serve import resolve_device
from devt_tpu_torch.train import checkpoint as ckpt_lib
from devt_tpu_torch.train.callbacks import Callback
from devt_tpu_torch.train.loggers import JsonlLogger, NullLogger
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
        self.config = config
        self.device = resolve_device(device)
        self.callbacks = list(callbacks)
        self.mesh = mesh or (make_mesh(config.dp, config.mp, config.pp,
                                       config.sp) if use_mesh else None)
        # the data axis of a mesh of more than one rank (raising for a rank
        # outside the mesh), else None
        self._axis = (self.mesh.axes()[DATA_AXIS]
                      if self.mesh is not None and self.mesh.size > 1
                      else None)
        self._rank0 = process_index() == 0
        self.logger = ((logger or JsonlLogger(name=config.name))
                       if self._rank0 else NullLogger())
        self.buffers = RunningBuffers()
        # the step executors' integer seed (JAX: PRNGKey(config.seed))
        self._rng = config.seed
        self.profile_path: str | None = None

    # ------------------------------------------------------------------
    def _init_state(self, model, steps_per_epoch: int,
                    path: str | None = None) -> TrainState:
        """A state over the model's own parameters and buffers, on the
        trainer's device, restored from ``path`` (default
        ``config.resume``) when set, then broadcast and placed over the
        mesh."""
        model.to(self.device)
        tx = build_optimizer(self.config, steps_per_epoch)
        state = TrainState.create(dict(model.named_parameters()), tx,
                                  model_state=model_buffers(model))
        path = path or self.config.resume
        if path:
            state = ckpt_lib.restore(path, state)
        if self._axis is not None:
            axes = self.mesh.axes()
            # every rank starts from rank 0's parameters and buffers
            with collectives.axis_scope(axes):
                for name in (DATA_AXIS, PIPE_AXIS, SEQ_AXIS, MODEL_AXIS):
                    if name in axes:
                        collectives.broadcast(
                            [*state.params.values(),
                             *state.model_state.values()], name)
            if self.config.dp_mode in ("fsdp", "fsdp_gspmd"):
                fsdp.shard_train_state(state, self.mesh)
            else:
                sharding.shard_train_state(state, self.mesh)
        return state

    def _whole(self, state) -> TrainState:
        """The whole state (a sharded one gathered, on every rank)."""
        if not state.shards:
            return state
        with collectives.axis_scope(self.mesh.axes()):
            return layout.whole_state(state)

    def _local(self, batches):
        """This rank's rows of each batch of ``batches``: a ``Loader``
        assembles only them; another iterable's batches are sliced."""
        if self._axis is None:
            return batches
        if hasattr(batches, "shard_rows"):
            batches.shard_rows(self._axis.index, self._axis.size)
            return batches
        return (shard_batch(b, self.mesh) for b in batches)

    def _paths(self, host: dict):
        """The batch's host-only paths, every rank's in rank order."""
        paths = host.get("path")
        if self._axis is None or paths is None:
            return paths
        parts: list = [None] * self._axis.size
        dist.all_gather_object(parts, list(paths), group=self._axis.group)
        return [p for part in parts for p in part]

    def _save(self, ckpt_dir: str, state, step: int | None = None) -> None:
        whole = self._whole(state)
        if self._rank0:
            self._saver.save(ckpt_dir, whole, self.config, step=step)

    def _barrier(self) -> None:
        if self._axis is None:
            return
        # every rank of the mesh; the data axis' when the mesh leaves
        # ranks of the world out
        whole_world = self.mesh.size == dist.get_world_size()
        dist.barrier(group=None if whole_world else self._axis.group)

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
        # the executors first: they refuse a mesh whose strategy is not
        # ported before any work
        dev, mesh = self.device, self.mesh
        train_step = make_train_step(model, cfg, mesh=mesh, device=dev)
        eval_step = make_eval_step(model, cfg, mesh=mesh, device=dev)
        needs_train_aux = any(getattr(cb, "on_train_batch_end", None)
                              and type(cb).on_train_batch_end
                              is not Callback.on_train_batch_end
                              for cb in self.callbacks)
        unroll = max(cfg.unroll_steps, 1)
        multi_step = (make_multi_step(model, cfg, unroll, mesh=mesh,
                                      device=dev)
                      if unroll > 1 and not needs_train_aux else None)

        state = self._init_state(model, steps_per_epoch)
        self._saver = ckpt_lib.AsyncSaver()
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
        prefetch = None
        run_steps = 0      # train steps run in THIS call (a multi-step
                           # launch counts as ``unroll``): the profiled
                           # window does not move when resuming
        try:
            for epoch in range(start_epoch, cfg.epochs):
                with annotate("train/epoch_start"):
                    loader = self._local(datamodule.train_batches())
                    if hasattr(loader, "set_epoch"):
                        # reshuffle per epoch + the mid-epoch resume skip
                        loader.set_epoch(
                            epoch, resume_skip if epoch == start_epoch else 0)
                # batches are placed ``host_batch_prefetch`` steps ahead
                # (paths and other host-only entries are dropped there)
                prefetch = device_prefetch(
                    loader, device=dev,
                    depth=max(cfg.host_batch_prefetch, 1))
                placed_iter = prefetch if multi_step is None \
                    else _stacked(prefetch, unroll)
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
                # its thread stops now, not when the generator is collected
                prefetch.close()

                if (epoch + 1) % cfg.eval_every_epochs == 0:
                    with annotate("train/validate"):
                        results = self.validate(model, datamodule, state,
                                                eval_step, global_step)
                    with annotate("train/checkpoint"):
                        self._maybe_save_best(results, state, global_step)
                        # async: the write runs while the next epoch
                        # trains
                        self._save(cfg.checkpoint_dir, state)
                if 0 < cfg.max_steps <= global_step:
                    break

            self._save(cfg.checkpoint_dir, state)
        finally:
            if prefetch is not None:
                prefetch.close()
            # always await the writer, even on the non-finite-loss abort
            if profiler is not None:
                self.profile_path = profiler.stop()
            self._saver.close()
        # no rank reads the run's checkpoints before rank 0 wrote them
        self._barrier()
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
        self._save(best_dir, state, step)
        if self._rank0:
            # best saves are rare: await the write so the retention pass
            # sees the finished directory
            self._saver.wait()
            ckpt_lib.prune_checkpoints(best_dir, max(cfg.keep_best_k, 1))
        self.logger.log({f"best/{key}": value}, step)

    # ------------------------------------------------------------------
    def validate(self, model, datamodule, state, eval_step=None,
                 step: int = 0) -> dict:
        eval_step = eval_step or make_eval_step(
            model, self.config, mesh=self.mesh, device=self.device)
        losses = []
        ssl_cbs = [cb for cb in self.callbacks
                   if hasattr(cb, "eval_batch")]
        for batch in self._local(datamodule.val_batches()):
            loss, aux = eval_step(state, self._place(batch))
            losses.append(float(loss))
            _, host = self._split_host_only(batch)
            if ssl_cbs:
                for cb in ssl_cbs:
                    cb.eval_batch(aux, self.buffers)
            else:
                self.buffers.append({**aux, "path": self._paths(host)})
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
            state = self._init_state(
                model, 1,
                ckpt_path or ckpt_lib.latest_checkpoint(cfg.checkpoint_dir))
        eval_step = make_eval_step(model, cfg, mesh=self.mesh,
                                   device=self.device)
        losses = []
        for batch in self._local(datamodule.test_batches()):
            loss, aux = eval_step(state, self._place(batch))
            losses.append(float(loss))
            _, host = self._split_host_only(batch)
            self.buffers.append({**aux, "path": self._paths(host)})
        results = {"test/loss": float(np.mean(losses)) if losses else 0.0}
        # the test callbacks write files: rank 0 runs them
        for cb in self.callbacks if self._rank0 else ():
            out = cb.on_test_epoch_end(self.buffers, self.logger,
                                       int(state.step))
            if isinstance(out, dict):
                results.update(out)
        self.logger.log({"test/loss": results["test/loss"]}, int(state.step))
        return results
