"""Hopper kernels and compute primitives.

Each hand-written kernel has its CUDA source in ``csrc/``, a wrapper that
launches it for CUDA tensors, and a plain PyTorch version beside it that
the wrapper runs for CPU tensors.  ``_build`` compiles the sources with
``nvcc`` on first use.
"""

from devt_tpu_torch.ops.attention import packed_mha, xla_attention
from devt_tpu_torch.ops.fused_block import (FusedViTBlock, fused_vit_block,
                                            fused_vit_block_bwd_plain,
                                            fused_vit_block_fwd_plain,
                                            reference_vit_block)

__all__ = [
    "packed_mha",
    "xla_attention",
    "FusedViTBlock",
    "fused_vit_block",
    "fused_vit_block_bwd_plain",
    "fused_vit_block_fwd_plain",
    "reference_vit_block",
]
