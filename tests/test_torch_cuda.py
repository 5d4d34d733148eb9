"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without an NVIDIA card (a CUDA kernel has
no CPU mode).  This file imports no JAX, so it runs on the machine with
the card:  python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from devt_tpu_torch.ops import fused_block as tfb

# the same bounds as chip_smoke.py: f32 sums in other orders; bf16 one
# ulp where a sum lands on the other side of a rounding boundary
TOL = {"f32": dict(atol=1e-4, rtol=1e-4), "bf16": dict(atol=1e-2, rtol=1.6e-2)}
DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}
# Backward: |kernel - plain| <= ulps * eps * max|plain| per tensor.  f32
# (eps 2^-23): sums over up to 2,400 rows in another order.  bf16 (eps
# 2^-8): the same roundings, but an intermediate next to a rounding
# boundary may land on the other side and move what it feeds by an ulp.
BWD_ULPS = {"f32": 256, "bf16": 4}
EPS = {"f32": 2.0 ** -23, "bf16": 2.0 ** -8}
RATE = 0.1


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
    x, params = _block(DTYPE[kind], kv_len=kv_len)
    scale = (64 // heads) ** -0.5
    before = tfb.fused_vit_block.launches
    with torch.no_grad():
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


def _assert_bwd_close(kind, got, want):
    (gdx, ggrads), (wdx, wgrads) = got, want
    for name, g, w in [("dx", gdx, wdx)] + [
            (k, ggrads[k], wgrads[k]) for k in tfb.PARAM_NAMES]:
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.isfinite(g.float()).all(), name
        err = (g.float() - w.float()).abs().max().item()
        bound = BWD_ULPS[kind] * EPS[kind] * w.float().abs().max().item()
        assert err <= bound, f"{kind} {name}: {err:.3e} > {bound:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("b,kv_len,rate", [(6, 37, 0.0), (6, 48, 0.0),
                                           (6, 20, 0.0), (50, 37, 0.0),
                                           (6, 37, RATE), (50, 33, RATE)])
def test_fused_block_backward_kernel_matches_plain(card, kind, b, kv_len,
                                                   rate):
    """Both widths' small instantiation, b=50 crossing a split of the
    weight gradients (2,400 rows > 2,048), kv_len=20 leaving the last 16
    keys wholly masked (their dk and dv must come out as written zeros);
    with dropout the plain version gets the masks the library exports for
    the seed."""
    heads, seed = 2, 77
    x, params = _block(DTYPE[kind], b=b, kv_len=kv_len)
    scale = (64 // heads) ** -0.5
    gen = torch.Generator().manual_seed(1)
    dy = torch.randn(x.shape, generator=gen).to(x.dtype).cuda()
    keep = None
    if rate > 0.0:
        keep = tfb.dropout_masks(seed, rate, *x.shape, 128, x.device)
    xr = x.clone().requires_grad_(True)
    pr = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    before = tfb.fused_vit_block.bwd_launches
    y, u, res = tfb.fused_vit_block(xr, pr, heads, scale, kv_len,
                                    dropout_rate=rate, seed=seed)
    y.backward(dy)
    torch.cuda.synchronize()
    assert tfb.fused_vit_block.bwd_launches == before + 1
    want_fwd = tfb.fused_vit_block_fwd_plain(x, params, heads, scale, kv_len,
                                             keep, rate)
    for name, g, w in zip(("y", "u", "res"), (y, u, res), want_fwd):
        torch.testing.assert_close(g.detach().float(), w.float(), msg=name,
                                   **TOL[kind])
    # the plain backward from the kernel's own (u, res), so that only the
    # backward is compared
    want = tfb.fused_vit_block_bwd_plain(x, params, u.detach(), res.detach(),
                                         dy, heads, scale, kv_len, keep, rate)
    got = (xr.grad, {k: pr[k].grad for k in tfb.PARAM_NAMES})
    _assert_bwd_close(kind, got, want)
    # pad rows reach dx only through dy: keys past kv_len get no gradient
    # from attention, whatever the scratch buffer held before
    again = tfb._bwd_cuda(x, params, u.detach(), res.detach(), dy, heads,
                          scale, kv_len, rate, seed)
    assert torch.equal(again[0], xr.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_fused_block_backward_is_deterministic(card, kind):
    """No atomics: two runs of the backward give the same bits."""
    x, params = _block(DTYPE[kind], b=50)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)) \
        .to(x.dtype).cuda()
    with torch.no_grad():
        _, u, res = tfb.fused_vit_block(x, params, 2, 0.25, 37,
                                        dropout_rate=RATE, seed=3)
    runs = [tfb._bwd_cuda(x, params, u, res, dy, 2, 0.25, 37, RATE, 3)
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    for k in tfb.PARAM_NAMES:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


@pytest.mark.cuda
def test_dropout_masks_on_the_card(card):
    """The exported Philox masks drop about the rate at each site (within
    4 standard deviations), repeat for a seed and differ between seeds."""
    keep = tfb.dropout_masks(5, RATE, 8, 48, 64, 128, "cuda")
    for k in keep:
        band = 4 * (RATE * (1 - RATE) / k.numel()) ** 0.5
        assert abs((~k).float().mean().item() - RATE) < band
    again = tfb.dropout_masks(5, RATE, 8, 48, 64, 128, "cuda")
    other = tfb.dropout_masks(6, RATE, 8, 48, 64, 128, "cuda")
    assert all(torch.equal(a, b) for a, b in zip(keep, again))
    assert not torch.equal(keep[1], other[1])
    assert not torch.equal(keep[0], keep[2])      # sites draw apart


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, RATE])
def test_vit_block_trains_through_the_kernels(card, rate):
    """``ViTBlock`` in training mode on the card: one forward and one
    backward launch, and the gradients reach the f32 ``nn.Linear`` and
    ``nn.LayerNorm`` parameters, equal to the CPU's plain path within the
    bf16 bound (without dropout; with it the card's Philox masks are not
    the CPU generator's, so only launches and finiteness are checked)."""
    import copy

    from devt_tpu_torch.models.layers import (DropoutRng, ViTBlock,
                                              init_weights)

    block = ViTBlock(64, 2, 32, 128, dropout=rate, dtype=torch.bfloat16)
    init_weights(block, torch.Generator().manual_seed(0))
    block.train()
    ref = copy.deepcopy(block)
    x = torch.randn(6, 48, 64, generator=torch.Generator().manual_seed(1))
    x[:, 37:] = 0.0
    before = (tfb.fused_vit_block.launches, tfb.fused_vit_block.bwd_launches)
    block.cuda()
    block(x.cuda(), 37, DropoutRng(3)).float().square().sum().backward()
    torch.cuda.synchronize()
    assert (tfb.fused_vit_block.launches,
            tfb.fused_vit_block.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    grads = {k: p.grad for k, p in block.named_parameters()}
    assert all(g is not None and g.dtype == torch.float32
               and torch.isfinite(g).all() for g in grads.values())
    if rate == 0.0:
        ref(x, 37).float().square().sum().backward()
        for k, p in ref.named_parameters():
            err = (grads[k].cpu() - p.grad).abs().max().item()
            bound = BWD_ULPS["bf16"] * EPS["bf16"] * p.grad.abs().max().item()
            assert err <= bound, f"{k}: {err:.3e} > {bound:.3e}"
