"""Hopper kernels and compute primitives.

Each hand-written kernel has its CUDA source in ``csrc/``, a wrapper that
launches it for CUDA tensors, and a plain PyTorch version beside it that
the wrapper runs for CPU tensors.  ``_build`` compiles the sources with
``nvcc`` on first use.

``flash_attention`` the function is not re-exported here: the name is
its module's, ``ops.flash_attention``, which callers import as a module
(the JAX package's re-export hides its module the same way).  Call it as
``ops.flash_attention.flash_attention``, or through the dispatching
``scaled_dot_product_attention``.
"""

from devt_tpu_torch.ops.attention import (packed_mha, quant_scope,
                                          scaled_dot_product_attention,
                                          xla_attention)
from devt_tpu_torch.ops.flash_attention import (FlashBlocked, FlashSingle,
                                                FusedMHA,
                                                flash_blocked_bwd_plain,
                                                flash_blocked_fwd_plain,
                                                flash_single_bwd_plain,
                                                flash_single_fwd_plain,
                                                fused_mha,
                                                fused_mha_bwd_plain,
                                                fused_mha_plain,
                                                mha_dropout_masks,
                                                ring_step_bwd,
                                                ring_step_bwd_plain,
                                                ring_step_fwd,
                                                ring_step_fwd_plain)
from devt_tpu_torch.ops.fused_block import (FusedViTBlock, fused_vit_block,
                                            fused_vit_block_bwd_plain,
                                            fused_vit_block_fwd_plain,
                                            reference_vit_block)
from devt_tpu_torch.ops.quant import (int8_matmul_fused,
                                      int8_matmul_fused_plain,
                                      quant_fused_vit_block,
                                      quant_fused_vit_block_plain,
                                      quant_vit_block)

__all__ = [
    "packed_mha",
    "quant_scope",
    "scaled_dot_product_attention",
    "xla_attention",
    "FlashBlocked",
    "FlashSingle",
    "FusedMHA",
    "flash_blocked_bwd_plain",
    "flash_blocked_fwd_plain",
    "flash_single_bwd_plain",
    "flash_single_fwd_plain",
    "fused_mha",
    "fused_mha_bwd_plain",
    "fused_mha_plain",
    "mha_dropout_masks",
    "ring_step_bwd",
    "ring_step_bwd_plain",
    "ring_step_fwd",
    "ring_step_fwd_plain",
    "int8_matmul_fused",
    "int8_matmul_fused_plain",
    "quant_fused_vit_block",
    "quant_fused_vit_block_plain",
    "quant_vit_block",
    "FusedViTBlock",
    "fused_vit_block",
    "fused_vit_block_bwd_plain",
    "fused_vit_block_fwd_plain",
    "reference_vit_block",
]
