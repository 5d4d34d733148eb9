"""The forward kernels as ``torch.library`` custom ops.

A wrapper hands ``data_ptr()``s to a ``ctypes`` call, which nothing that
traces with fake tensors can follow: ``torch.export`` has no pointer to
hand over.  So each forward kernel that a serving path reaches is an op
of the ``devt_tpu_torch`` namespace with two implementations: one for
CUDA and CPU tensors, which launches the kernel for the one (and counts
the launch, so that the calls of an exported program count too) and runs
the plain PyTorch version for the other, and a fake one that gives the
outputs' shapes and dtypes.  An exported program keeps each call as one
node, so one artifact serves on either device; a CUDA tensor never
reaches the plain version, in it or out of it.

The autograd ``Function``s call the ops in their forwards (grad mode is
off there, so no op needs an autograd formula of its own) and keep their
backwards, which are still ``ctypes`` calls.  Importing ``devt_tpu_torch.
ops`` registers every op.
"""

from __future__ import annotations

from typing import Callable

import torch

NAMESPACE = "devt_tpu_torch"


def kernel_op(name: str, schema: str, impl: Callable, fake: Callable):
    """Register ``devt_tpu_torch::<name>`` with the given schema: ``impl``
    for CUDA and CPU tensors (the launch for the one, the plain version
    for the other, chosen by the device of its first tensor, as the
    wrappers always chose), ``fake`` for fake and meta tensors.  Returns
    the op (a ``CustomOpDef``; calling it calls the op)."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", impl,
                                 mutates_args=(),
                                 device_types=("cpu", "cuda"), schema=schema)
    op.register_fake(fake)
    return op
