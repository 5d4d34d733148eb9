"""devt_tpu_torch — the PyTorch/CUDA port of :mod:`devt_tpu`.

A second package beside the JAX one, with the same module names so each
counterpart is easy to find.  It imports ``torch`` and numpy, and nothing
of JAX or of ``devt_tpu``: host code it needs from there is copied.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Every Pallas kernel that a ported path runs is a hand-written Hopper
kernel here (``ops/csrc``), with a plain PyTorch version of the same
function beside it; a wrapper takes the plain version only for tensors
that lie on the CPU.

Ported so far (see ROADMAP.md for what is not):
  - :mod:`devt_tpu_torch.main`     — the entry point (``python -m
                                     devt_tpu_torch.main``)
  - :mod:`devt_tpu_torch.config`   — own copy of the typed config
  - :mod:`devt_tpu_torch.data`     — the embedding datasets' host pipeline,
                                     the pinned placer, u8 wire dequantize
  - :mod:`devt_tpu_torch.ops`      — fused ViT block, forward and backward
                                     (CUDA, in-kernel dropout), attention
  - :mod:`devt_tpu_torch.models`   — ViViT, its transformer layers, losses
  - :mod:`devt_tpu_torch.serve`    — bucketed ``Predictor``
  - :mod:`devt_tpu_torch.train`    — step logic, optimizers, ``TrainState``,
                                     the ``Trainer``, checkpoints, metrics
                                     and callbacks
  - :mod:`devt_tpu_torch.parallel` — train/multi/eval step executors,
                                     one device or a mesh of ranks
  - :mod:`devt_tpu_torch.utils`    — JAX-variables ↔ ``state_dict`` bridge,
                                     the checkpoint porter
  - :mod:`devt_tpu_torch.tools`    — manifest admin, retrieval, Grad-CAM,
                                     the pipeline-layout converter
  - :mod:`devt_tpu_torch.examples` — the five example journeys
  - :mod:`devt_tpu_torch.dryrun`   — ``entry()`` and
                                     ``dryrun_multichip(n)``
"""

from devt_tpu_torch.version import __version__

__all__ = ["__version__"]
