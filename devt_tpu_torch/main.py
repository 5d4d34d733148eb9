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
port's own dependencies.  Datasets: ``synthetic``, ``mmx``, ``mit``,
``mmx-contrastive`` and ``mit-contrastive``.  ``mmx-frame`` and meshes
(``dp`` or ``mp`` > 1) are not ported yet.  ``main(argv, device="cpu")``
runs on the CPU (the tests do); otherwise it needs a card.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from devt_tpu_torch.config import Config
from devt_tpu_torch.registry import build_model
from devt_tpu_torch.serve import resolve_device
from devt_tpu_torch.train.callbacks import (DisplayResults, MITEval,
                                            TransformerEval)
from devt_tpu_torch.train.harness import Trainer
from devt_tpu_torch.train.loggers import build_logger


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
        raise NotImplementedError(
            "the mmx-frame dataset (data/mmx_frame.py and the PIL "
            "transforms) is not ported yet — ROADMAP.md queue 1, item 10")
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


def main(argv=None, device: str | torch.device | None = None):
    """Run the entry point on ``device`` (default: the card; without one
    it raises).  Returns the test results."""
    config = parse_args(argv)
    if config.dp > 1 or config.mp > 1:
        raise NotImplementedError(
            f"dp={config.dp}, mp={config.mp}: training over a mesh is not "
            f"ported yet — ROADMAP.md queue 1, item 7; run with dp and mp "
            f"at 1 (or dp -1) on one card")
    # without a card this raises before anything is written
    device = resolve_device(device)
    dm = build_datamodule(config)
    logger = build_logger(config)
    try:
        trainer = Trainer(config, callbacks=build_callbacks(config),
                          logger=logger, device=device)
        model = build_model(config)
        if config.test:
            return trainer.test(model, dm, ckpt_path=config.resume)
        state = trainer.fit(model, dm)
        return trainer.test(model, dm, state=state)
    finally:
        logger.close()


if __name__ == "__main__":
    main(sys.argv[1:])
