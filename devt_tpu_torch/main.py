"""Entry point — config-driven model/dataset dispatch: port of
``devt_tpu/main.py``.

Loads an optional flat ``config.yaml``, applies ``--key value``
overrides, dispatches the model by ``config.model`` and the datamodule by
``config.data_set`` (src/main.py:37-71) with the matching eval callbacks,
builds the :class:`~devt_tpu_torch.train.harness.Trainer` and runs fit
then test (or test alone when ``config.test`` is set, from
``config.resume`` or the newest checkpoint).

Usage, on a CUDA card:
    python -m devt_tpu_torch.main [--config config.yaml] [--key value ...]

``--config`` needs PyYAML; the overrides alone need nothing beyond the
port's own dependencies.  Datasets: ``mmx-frame`` (the default: PNG
frames listed by the CSV at ``--csv_manifest``, decoded by the native
decoder where it builds, else by Pillow), ``synthetic``, ``mmx``,
``mit``, ``mmx-contrastive`` and ``mit-contrastive``.
``main(argv, device="cpu")`` runs on the CPU (the tests do); otherwise it
needs a card.

Data parallel, one process a rank (``parallel/distributed.py``):

    python -m torch.distributed.run --nproc_per_node 2 \
        -m devt_tpu_torch.main --dp 2 [--key value ...]

(``torchrun`` is the same launcher.)  ``--dp_mode fsdp`` shards the
state over the data axis (ZeRO-3), and ``--mp N`` lays out a (data, model)
mesh with tensor parallelism over N ranks:

    python -m torch.distributed.run --nproc_per_node 3 \
        -m devt_tpu_torch.main --model vivit --mp 3 [--key value ...]

Pipeline parallelism (``--pp``, ``--pp_microbatches``; with ``--mp`` the
3-D mesh), sequence parallelism (``--sp``) and expert-parallel MoE
(``--moe_experts E --moe_ep true`` on a data axis):

    python -m torch.distributed.run --nproc_per_node 2 \
        -m devt_tpu_torch.main --model vivit --dropout 0.0 --pp 2 ...
    python -m torch.distributed.run --nproc_per_node 2 \
        -m devt_tpu_torch.main --model vivit --dropout 0.0 --sp 2 ...

Ranks that share one card talk over Gloo; with a card each they use NCCL.
The mesh engages by the JAX entry point's rule, with the world's ranks in
place of its devices and every axis counted (dp·mp·pp·sp ranks).  In a world of one process ``--dp 2`` or ``--mp 2``
trains on the one card, as JAX does on one device.  In a world of more
than one rank a mesh that cannot engage raises ``ValueError`` with JAX's
reason: where JAX warns and falls back to one device, ranks cannot.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from devt_tpu_torch.config import Config
from devt_tpu_torch.parallel import distributed
from devt_tpu_torch.registry import build_model
from devt_tpu_torch.serve import resolve_device
from devt_tpu_torch.train.callbacks import (DisplayResults, MITEval,
                                            TransformerEval)
from devt_tpu_torch.train.harness import Trainer
from devt_tpu_torch.train.loggers import NullLogger, build_logger


def build_datamodule(config: Config):
    ds = config.data_set
    if ds == "mit":
        from devt_tpu_torch.data.mit_temporal import MITDataModule
        return MITDataModule(config.train_manifest, config.val_manifest,
                             config)
    if ds == "mmx":
        from devt_tpu_torch.data.mmx_temporal import MMXDataModule
        return MMXDataModule(config.train_manifest, config.val_manifest,
                             config)
    if ds == "mmx-frame":
        from devt_tpu_torch.data.mmx_frame import MMXLightDataModule
        return MMXLightDataModule(config.csv_manifest, config)
    if ds in ("mmx-contrastive", "mit-contrastive"):
        from devt_tpu_torch.data.contrastive import ContrastiveDataModule
        return ContrastiveDataModule(config.train_manifest,
                                     config.val_manifest, config)
    if ds == "synthetic":
        from devt_tpu_torch.data.synthetic import SyntheticDataModule
        return SyntheticDataModule(config, train_size=64, val_size=16,
                                   test_size=16)
    raise ValueError(
        "No dataset selected, please update the configuration: "
        "mit, mmx, mmx-frame, mmx-contrastive, mit-contrastive, synthetic")


def build_callbacks(config: Config):
    # dispatch mirrors src/main.py:46-68; the contrastive model gets the
    # online probe (callbacks.py:147-291)
    if config.model == "contrastive":
        from devt_tpu_torch.train.callbacks import SSLOnlineEval

        return [SSLOnlineEval(z_dim=config.projection_size,
                              num_classes=config.n_classes)]
    if config.data_set == "mit":
        return [MITEval()]
    # eval artifacts land in the run directory (save_path/name), never cwd
    run_dir = os.path.join(config.save_path, config.name)
    callbacks = [TransformerEval(out_dir=run_dir)]
    if config.test:
        # ahead of TransformerEval, which empties the buffers when it is
        # done (the JAX entry point's order hands DisplayResults nothing)
        callbacks.insert(0, DisplayResults(
            out_path=os.path.join(run_dir, "embed_dict.pkl")))
    return callbacks


def parse_args(argv=None) -> Config:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default=None,
                        help="path to a flat config.yaml (reference format; "
                             "needs PyYAML)")
    args, overrides = parser.parse_known_args(argv)

    config = Config.from_yaml(args.config) if args.config else Config()

    # --key value overrides for any flat config field
    it = iter(overrides)
    updates = {}
    for tok in it:
        if not tok.startswith("--"):
            raise SystemExit(f"unexpected argument {tok!r}")
        key = tok[2:]
        val = next(it, None)
        if val is None:
            raise SystemExit(f"missing value for --{key}")
        current = getattr(config, key)   # raises for unknown keys
        if isinstance(current, bool):
            updates[key] = val.lower() in ("1", "true", "yes")
        elif isinstance(current, int):
            updates[key] = int(val)
        elif isinstance(current, float):
            updates[key] = float(val)
        elif isinstance(current, (tuple, list)):
            updates[key] = tuple(val.split(","))
        else:
            updates[key] = val
    return config.replace(**updates)


def use_mesh(config: Config, world: int) -> bool:
    """The JAX entry point's rule with ``world`` ranks in place of its
    devices, each rank of the mesh counted: the mesh engages when
    dp·mp·pp·sp > 1, the global batch divides over the data axis and the
    world holds the mesh.  In a world of more than one rank a mesh that
    does not engage, or leaves ranks out, raises ``ValueError`` saying
    why: ranks cannot fall back to one device."""
    per = max(config.mp, 1) * max(config.pp, 1) * max(config.sp, 1)
    dp = config.dp if config.dp != -1 else max(world // per, 1)
    size = dp * per
    factors = (f"dp*mp*pp*sp = {dp}*{max(config.mp, 1)}*"
               f"{max(config.pp, 1)}*{max(config.sp, 1)}")
    engage = (size > 1 and config.batch_size % max(dp, 1) == 0
              and world >= size)
    if world > 1 and not (engage and world == size):
        if config.batch_size % max(dp, 1) != 0:
            why = (f"batch_size={config.batch_size} does not divide over "
                   f"the data axis dp={dp} — pick a batch size that is a "
                   f"multiple of {dp}, or set --dp explicitly")
        elif world < size:
            why = (f"{factors} = {size} exceeds the "
                   f"{world} ranks — lower --dp/--mp/--pp/--sp")
        elif size < world:
            why = (f"{factors} = {size} leaves ranks of the "
                   f"{world} out — launch {size} or raise --dp")
        else:
            why = f"{factors} <= 1 — set --dp/--mp to use the ranks"
        raise ValueError(f"devt_tpu_torch: {world} ranks but the device "
                         f"mesh is DISABLED ({why}); ranks cannot fall back "
                         f"to one device")
    return engage


def main(argv=None, device: str | torch.device | None = None):
    """Run the entry point on ``device`` (default: the card; without one
    it raises).  Returns the test results (on a rank other than 0 of a
    data-parallel run, the test loss alone)."""
    config = parse_args(argv)
    # a world of ranks (torchrun's environment) joins its process group;
    # one process is a no-op
    distributed.initialize()
    engage = use_mesh(config, distributed.process_count())
    # without a card this raises before anything is written
    device = resolve_device(device)
    dm = build_datamodule(config)
    logger = (build_logger(config) if distributed.process_index() == 0
              else NullLogger())
    try:
        trainer = Trainer(config, callbacks=build_callbacks(config),
                          logger=logger, use_mesh=engage, device=device)
        model = build_model(config)
        if config.test:
            return trainer.test(model, dm, ckpt_path=config.resume)
        state = trainer.fit(model, dm)
        return trainer.test(model, dm, state=state)
    finally:
        logger.close()


if __name__ == "__main__":
    main(sys.argv[1:])
