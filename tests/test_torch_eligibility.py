"""Which blocks the fused kernels take, on the card, asked on the CPU.

The bf16 fused kernels (1, 2, 5, 7, 8) are compiled for the (dim, head
dim) pairs of ``ops/fused_block.py:_BF16_WIDTHS``, and kernels 2 and 8 hold
one head's attention operands in shared memory.  The eligibility checks of
the blocks and of the int8 block read those rules
(``fused_block_eligible``, ``quant_block_eligible``), so a block the kernels
do not take runs unfused on the card, as the JAX package's block runs
unfused wherever its fused path is not eligible
(``devt_tpu/models/layers.py:181``), instead of raising.  The predicates
are functions of the device type, so they are asked here with ``"cuda"``;
CPU tensors keep every branch, whose plain versions take every width.
"""

import types

import pytest
import torch

from devt_tpu_torch.models import layers as tl
from devt_tpu_torch.ops import fused_block as tfb
from devt_tpu_torch.ops import quant as tq

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

BF16, F32 = torch.bfloat16, torch.float32

# (dtype, dim, head dim, S, gradient) → the fused kernels take it on the
# card; every row is True on the CPU
CASES = [
    (BF16, 384, 64, 208, False, False),   # no such bf16 instantiation
    (BF16, 256, 64, 208, True, False),
    (BF16, 192, 64, 208, False, True),    # ViViT's width
    (BF16, 192, 64, 208, True, True),
    (BF16, 64, 32, 48, True, True),
    (F32, 384, 64, 208, True, True),      # the float route takes any width
    (F32, 192, 64, 416, True, True),
    (BF16, 192, 64, 416, True, False),    # kernel 2's shared memory
    (BF16, 192, 64, 416, False, True),    # serving needs no kernel 2
    (BF16, 192, 64, 384, True, True),
    (BF16, 64, 32, 512, True, True),
    (torch.float16, 192, 64, 208, False, False),
]


@pytest.mark.parametrize("dtype,dim,hd,s,grad,on_card", CASES)
def test_fused_block_eligible(dtype, dim, hd, s, grad, on_card):
    assert tfb.fused_block_eligible("cuda", dtype, dim, hd, s, grad) \
        is on_card
    assert tfb.fused_block_eligible("cpu", dtype, dim, hd, s, grad)


@pytest.mark.parametrize("dtype,dim,hd,mlp,on_card", [
    (BF16, 384, 64, 1536, False), (BF16, 192, 64, 768, True),
    (BF16, 64, 32, 128, True), (F32, 384, 64, 1536, True),
    (F32, 96, 48, 384, False),            # dim no multiple of 64
    (F32, 192, 64, 96, False)])           # MLP no multiple of 64
def test_quant_block_eligible(dtype, dim, hd, mlp, on_card):
    assert tq.quant_block_eligible("cuda", dtype, dim, hd, mlp) is on_card
    assert tq.quant_block_eligible("cpu", dtype, dim, hd, mlp)


def _on(device, b, s, dim, dtype=BF16):
    """What the eligibility checks read of x: its device, shape, dtype."""
    return types.SimpleNamespace(device=torch.device(device),
                                 shape=(b, s, dim), dtype=dtype)


@pytest.mark.parametrize("dim,heads,s,train,grad,on_card", [
    (384, 6, 208, False, True, False),    # repair 1: the width
    (384, 6, 208, True, True, False),
    (192, 3, 208, True, True, True),
    (192, 3, 416, True, True, False),     # repair 2: kernel 2's shape
    (192, 3, 416, True, False, True),     # no_grad: no backward follows
    (192, 3, 416, False, True, True)])    # eval
def test_vit_block_reads_the_kernels_rules(dim, heads, s, train, grad,
                                           on_card):
    block = tl.ViTBlock(dim, heads, 64, 4 * dim, dtype=BF16).train(train)
    with torch.set_grad_enabled(grad):
        assert block.fused_eligible(_on("cuda", 2, s, dim)) is on_card
        assert block.fused_eligible(_on("cpu", 2, s, dim))


@pytest.mark.parametrize("dim,heads,s,train,on_card", [
    (384, 6, 208, False, False), (192, 3, 208, True, True),
    (192, 3, 416, True, False), (192, 3, 416, False, True)])
def test_moe_block_reads_the_kernels_rules(dim, heads, s, train, on_card):
    block = tl.MoEViTBlock(dim, heads, 64, 4 * dim, n_experts=2,
                           dtype=BF16).train(train)
    assert block.fused_half_eligible(_on("cuda", 2, s, dim)) is on_card
    assert block.fused_half_eligible(_on("cpu", 2, s, dim))


@pytest.mark.parametrize("dim,heads,on_card", [(384, 6, False),
                                               (192, 3, True)])
def test_int8_block_reads_kernel_5s_widths(dim, heads, on_card):
    block = tl.ViTBlock(dim, heads, dim // heads, 4 * dim)
    qp = tq.quant_block_params(block.block_params())
    assert tq._fused_quant_ok(_on("cuda", 2, 208, dim), qp, heads) \
        is on_card
    assert tq._fused_quant_ok(_on("cpu", 2, 208, dim), qp, heads)


def test_kernels_refuse_what_the_predicates_refuse():
    """The argument checks of the CUDA routes raise on exactly what the
    predicates refuse, before anything reaches a card."""
    x = torch.zeros(1, 416, 192, dtype=BF16)
    assert not tfb.bwd_takes_shape(BF16, 64, 416)
    with pytest.raises(ValueError, match="shared memory"):
        tfb._check_bwd_shape(x, 3)
    tfb._check_bwd_shape(x[:, :384], 3)
    assert tfb.kernels_take_width(BF16, 192, 64, 768)
    assert not tfb.kernels_take_width(BF16, 192, 64, 96)   # mlp % 64
    assert not tq.quant_kernel_takes_width(BF16, 384, 64, 1536)
