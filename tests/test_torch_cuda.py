"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without an NVIDIA card (a CUDA kernel has
no CPU mode).  This file imports no JAX, so it runs on the machine with
the card:  python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from devt_tpu_torch.ops import fused_block as tfb

# the same bounds as chip_smoke.py: f32 sums in other orders; bf16 one
# ulp where a sum lands on the other side of a rounding boundary
TOL = {"f32": dict(atol=1e-4, rtol=1e-4), "bf16": dict(atol=1e-2, rtol=1.6e-2)}


def _block(dtype, dim=64, mlp=128, b=6, s=48, kv_len=37, seed=4):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.1):
        return torch.tensor((rng.standard_normal(shape) * scale)
                            .astype(np.float32))

    rows = {"g1": 1.0 + t(1, dim), "b1": t(1, dim), "bo": t(1, dim),
            "g2": 1.0 + t(1, dim), "b2": t(1, dim), "bb1": t(1, mlp),
            "bb2": t(1, dim)}
    mats = {"wqkv": t(dim, 3 * dim), "wo": t(dim, dim), "w1": t(dim, mlp),
            "w2": t(mlp, dim)}
    params = {k: v.cuda() for k, v in rows.items()}
    params.update({k: v.to(dtype).cuda() for k, v in mats.items()})
    x = t(b, s, dim, scale=1.0)
    x[:, kv_len:] = 0.0
    return x.to(dtype).cuda(), params


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("heads,kv_len", [(2, 37), (2, 48)])
def test_fused_block_kernel_matches_plain(card, kind, heads, kv_len):
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[kind]
    x, params = _block(dtype, kv_len=kv_len)
    scale = (64 // heads) ** -0.5
    before = tfb.fused_vit_block.launches
    got = tfb.fused_vit_block(x, params, heads, scale, kv_len)
    want = tfb.fused_vit_block_fwd_plain(x, params, heads, scale, kv_len)
    torch.cuda.synchronize()
    assert tfb.fused_vit_block.launches == before + 1
    for name, g, w in zip(("y", "u", "res"), got, want):
        torch.testing.assert_close(g.float(), w.float(), msg=name,
                                   **TOL[kind])


@pytest.mark.cuda
def test_fused_block_kernel_rejects_bad_params(card):
    x, params = _block(torch.bfloat16)
    params["wo"] = params["wo"].float()
    with pytest.raises(ValueError, match="param wo"):
        tfb.fused_vit_block(x, params, 2, 0.25, 37)
