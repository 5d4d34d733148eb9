"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without an NVIDIA card (a CUDA kernel has
no CPU mode).  This file imports no JAX, so it runs on the machine with
the card:  python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import ctypes

import numpy as np
import pytest
import torch

from devt_tpu_torch.ops import _build
from devt_tpu_torch.ops import flash_attention as tfa
from devt_tpu_torch.ops import fused_block as tfb
from devt_tpu_torch.ops import quant as tq

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


def _block(dtype, dim=64, mlp=128, b=6, s=48, kv_len=37, seed=4,
           fan_in=False, pad=True):
    """x (its rows past kv_len zero, as the model pads, unless ``pad`` is
    False) and the block's parameters; the weight matrices at 0.1, or with
    ``fan_in`` at 1 / sqrt(fan-in) as chip_smoke.py's main path draws
    them."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.1):
        return torch.tensor((rng.standard_normal(shape) * scale)
                            .astype(np.float32))

    rows = {"g1": 1.0 + t(1, dim), "b1": t(1, dim), "bo": t(1, dim),
            "g2": 1.0 + t(1, dim), "b2": t(1, dim), "bb1": t(1, mlp),
            "bb2": t(1, dim)}
    wd, wm = (dim ** -0.5, mlp ** -0.5) if fan_in else (0.1, 0.1)
    mats = {"wqkv": t(dim, 3 * dim, scale=wd), "wo": t(dim, dim, scale=wd),
            "w1": t(dim, mlp, scale=wd), "w2": t(mlp, dim, scale=wm)}
    params = {k: v.cuda() for k, v in rows.items()}
    params.update({k: v.to(dtype).cuda() for k, v in mats.items()})
    x = t(b, s, dim, scale=1.0)
    if pad:
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


def _assert_bwd_close(kind, got, want, names=tfb.PARAM_NAMES):
    (gdx, ggrads), (wdx, wgrads) = got, want
    for name, g, w in [("dx", gdx, wdx)] + [
            (k, ggrads[k], wgrads[k]) for k in names]:
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
    """Both widths' small instantiation, b=50 crossing a split of the f32
    route's weight gradients (2,400 rows > 2,048; the bf16 route sizes
    its splits from the SM count, and test_fused_block_sm90_matches_plain
    crosses them), kv_len=20 leaving the last 16 keys wholly masked
    (their dk and dv must come out as written zeros);
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


# (dim, heads, b, s, kv_len, rate): kernels 1 and 2 on csrc/block_sm90.cuh's
# wgmma body at both bf16 widths (MLP 4 x dim): 3 x 208 = 624 rows (four
# 128-row tiles and a tail of 112) at the main path's kv_len, with and
# without dropout; one live key; every key live; 5 x 48 = 240 rows; 200 x
# 48 = 9,600 rows (the weight gradients in 13 splits of 768 rows on a
# 132-SM card); 260 live keys, past the one-shot attention's 256
BLOCK_SM90_SHAPES = [
    (192, 3, 3, 208, 197, 0.0), (192, 3, 3, 208, 197, RATE),
    (192, 3, 2, 208, 1, 0.0), (192, 3, 2, 208, 208, 0.0),
    (64, 2, 5, 48, 1, 0.0), (64, 2, 5, 48, 48, 0.0),
    (64, 2, 5, 48, 37, RATE), (64, 2, 200, 48, 37, 0.0),
    (64, 2, 2, 272, 260, 0.0)]


def _check_block_sm90(dim, heads, b, s, kv_len, rate, pad):
    """Kernels 1 and 2 in bf16 against their plain versions given the masks
    the library exports for the seed, so the forward and the backward see
    the same ones: y, u and the residual lanes at the forward tolerance,
    the pad lanes 0; dx and the 11 gradients within 4 ulps of each
    tensor's largest element; two backward runs bit-equal; the forward's
    attention launch counted on the body attn_half_on_wgmma names (the
    one-shot wgmma body for at most 256 live keys), the backward's on the
    route block_bwd_on_wgmma names (the recompute and kernels 12's and
    13's wgmma bodies for at most 256 live keys, attention_bwd_bf16
    above).  The weights at the
    main path's 1 / sqrt(fan-in), x zero past kv_len if ``pad``."""
    mlp, seed = 4 * dim, 11
    x, params = _block(torch.bfloat16, dim=dim, mlp=mlp, b=b, s=s,
                       kv_len=kv_len, fan_in=True, pad=pad)
    scale = (dim // heads) ** -0.5
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)) \
        .to(x.dtype).cuda()
    keep = tfb.dropout_masks(seed, rate, b, s, dim, mlp, x.device) \
        if rate > 0.0 else None
    wgmma = int(tfb.attn_half_on_wgmma(torch.bfloat16, dim // heads, kv_len))
    assert wgmma == (kv_len <= 256)
    block = tfb.fused_vit_block
    bodies = (block.wgmma_launches, block.streamed_launches)
    with torch.no_grad():
        y, u, res = tfb.fused_vit_block(x, params, heads, scale, kv_len,
                                        dropout_rate=rate, seed=seed)
    torch.cuda.synchronize()
    assert (block.wgmma_launches - bodies[0],
            block.streamed_launches - bodies[1]) == (wgmma, 1 - wgmma)
    want = tfb.fused_vit_block_fwd_plain(x, params, heads, scale, kv_len,
                                         keep, rate)
    for name, g, w in zip(("y", "u"), (y, u), want):
        torch.testing.assert_close(g.float(), w.float(),
                                   msg=lambda m, n=name: f"{n}: {m}",
                                   **TOL["bf16"])
    torch.testing.assert_close(res[..., :heads + 4], want[2][..., :heads + 4],
                               **TOL["bf16"])
    assert res[..., heads + 4:].abs().max().item() == 0.0
    bwd = tfb.block_bwd_on_wgmma(torch.bfloat16, dim // heads, kv_len)
    assert bwd == (kv_len <= 256)
    bodies = (block.bwd_wgmma_launches, block.bwd_streamed_launches)
    runs = [tfb._bwd_cuda(x, params, u, res, dy, heads, scale, kv_len, rate,
                          seed) for _ in range(2)]
    assert (block.bwd_wgmma_launches - bodies[0],
            block.bwd_streamed_launches - bodies[1]) == (2 * bwd,
                                                         2 * (1 - bwd))
    want = tfb.fused_vit_block_bwd_plain(x, params, u, res, dy, heads, scale,
                                         kv_len, keep, rate)
    _assert_bwd_close("bf16", runs[0], want)
    assert torch.equal(runs[0][0], runs[1][0])
    for k in tfb.PARAM_NAMES:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("dim,heads,b,s,kv_len,rate", BLOCK_SM90_SHAPES)
def test_fused_block_sm90_matches_plain(card, dim, heads, b, s, kv_len,
                                        rate):
    """_check_block_sm90 with x drawn on every row.  Not the 0.1-scale
    weights of _block's default: at dim 192 the activations grow until the
    bf16 roundings that every implementation makes, summed in its own
    order, move y by 4 ulps, and a zero row's LayerNorm (rstd = eps^-1/2,
    316) multiplies the rounding differences of its dx.
    tools/block_rounding.py shows both on an H100: on those inputs the
    mma.sync body this one replaced leaves the same gates (y off by up to
    0.0625 on up to 46 elements; dx at kv_len 1 at 14 ulps), and both
    bodies lie as close to an f64 reference as the plain version, which
    is itself up to 26 ulps from it."""
    _check_block_sm90(dim, heads, b, s, kv_len, rate, pad=False)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, RATE])
def test_fused_block_sm90_pad_rows(card, rate):
    """_check_block_sm90 on the main path's draw at dim 192: 1 / sqrt(fan-in)
    weights and x zero on the 11 pad rows past kv_len 197 of each 208-row
    sequence (3 sequences: four 128-row tiles and a tail of 112)."""
    _check_block_sm90(192, 3, 3, 208, 197, rate, pad=True)


def _device_kernels(fn, reps=3):
    """The names of the device kernels ``fn`` launches, as the profiler
    shows them (template arguments kept), over ``reps`` calls: the
    profiler drops a device event now and then."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {ev.key.replace("(anonymous namespace)::", "")
            .replace("void ", "").split("(")[0]
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA}


@pytest.mark.cuda
def test_block_launches_by_body(card):
    """At the ViViT shape in bf16 every product launch of kernels 1, 2, 7
    and 8 is csrc/block_sm90.cuh's wgmma body (the four weight gradients
    one launch), the forwards' attention the one-shot wgmma instance that
    normalises after P·V, the backwards' attention the recompute and
    kernels 12's and 13's wgmma bodies; kernel 5's two row-tile launches
    are its int8 and bf16 wgmma bodies beside the same attention launch.
    No mma.sync launch is left but kernel 7's out-projection."""
    x, params = _block(torch.bfloat16, dim=192, mlp=768, b=4, s=208,
                       kv_len=197, fan_in=True)
    half = {k: params[k] for k in tfb.HALF_NAMES}
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(6)) \
        .to(x.dtype).cuda()
    with torch.no_grad():
        _, u, res = tfb.fused_vit_block(x, params, 3, 0.125, 197)
        _, hres = tfb.fused_attn_half(x, half, 3, 0.125, 197)
        k1 = _device_kernels(lambda: tfb.fused_vit_block(x, params, 3, 0.125,
                                                         197))
        k2 = _device_kernels(lambda: tfb._bwd_cuda(
            x, params, u, res, dy, 3, 0.125, 197, 0.0, 0))
        k7 = _device_kernels(lambda: tfb.fused_attn_half(x, half, 3, 0.125,
                                                         197))
        k8 = _device_kernels(lambda: tfb._half_bwd_cuda(
            x, half, hres, dy, 3, 0.125, 197))
        qp = tq.quant_block_params(params)
        k5 = _device_kernels(lambda: tq.quant_fused_vit_block(x, qp, 3, 0.125,
                                                              197))
    one_shot = "flash_one_shot<64, 208, false, true>"
    attn_bwd = {"block_bwd_pre_sm90<64, 208>", "block_bwd_dq_sm90<64>",
                "block_bwd_dkv_sm90<64>"}
    assert k1 == {"ln_qkv_sm90<192, false>", one_shot, "out_ffn_sm90<192>"}
    assert k2 == {"ln_qkv_sm90<192, true>", "ffn_dual_sm90<192>",
                  "row_nk_sm90<192, 1>", "row_nk_sm90<192, 0>",
                  "row_nk_sm90<192, 2>", "wgrad_sm90<192>",
                  "reduce_parts"} | attn_bwd
    assert k7 == {"ln_qkv_sm90<192, false>", one_shot, "out_proj_bf16<192>"}
    assert k8 == {"ln_qkv_sm90<192, true>", "row_nk_sm90<192, 0>",
                  "row_nk_sm90<192, 3>", "wgrad_sm90<192>",
                  "reduce_parts"} | attn_bwd
    assert k5 == {"ln_qkv_q8_sm90<192>", one_shot, "out_ffn_q8_sm90<192>"}


@pytest.mark.cuda
def test_fused_block_route_matches_the_c_rule(card):
    """Kernel 1's C rule for its attention launch (devt_fused_block_route)
    is the Python predicate's, kernel 7's."""
    lib = _build.load("fused_block_fwd", tfb._declare_fwd)
    for dtype, code in tfb._DTYPE_CODE.items():
        for d in (8, 16, 32, 48, 64, 128, 256):
            for kv_len in (0, 1, 17, 197, 256, 257, 512):
                assert bool(lib.devt_fused_block_route(code, d, kv_len)) == \
                    tfb.attn_half_on_wgmma(dtype, d, kv_len), (dtype, d,
                                                               kv_len)


@pytest.mark.cuda
def test_block_bwd_route_matches_the_c_rule(card):
    """The attention backward's C rule (block_bwd_on_wgmma, exported by
    kernel 2's library as devt_fused_block_bwd_route and by kernel 8's as
    devt_attn_half_bwd_route) is the Python predicate's; kernel 5's
    attention launch (devt_quant_block_route) follows kernels 1's and 7's
    rule."""
    bwd = _build.load("fused_block_bwd", tfb._declare_bwd)
    half = _build.load("attn_half", tfb._declare_half)
    quant = _build.load("quant_block_fwd", tq._declare_block)
    for dtype, code in tfb._DTYPE_CODE.items():
        for d in (8, 16, 32, 48, 64, 128, 256):
            for kv_len in (0, 1, 17, 197, 256, 257, 512):
                want = tfb.block_bwd_on_wgmma(dtype, d, kv_len)
                case = (dtype, d, kv_len)
                got = (bwd.devt_fused_block_bwd_route(code, d, kv_len),
                       half.devt_attn_half_bwd_route(code, d, kv_len))
                assert got == (int(want), int(want)), case
                assert bool(quant.devt_quant_block_route(code, d, kv_len)) \
                    == tfb.attn_half_on_wgmma(dtype, d, kv_len), case


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


# --- the int8 block, the fused int8 matmul and the packed-qkv attention ---

def _quant_block(dtype, heads, **kw):
    x, params = _block(dtype, **kw)
    qp = tq.quant_block_params(params)
    return x, params, qp


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("b,kv_len", [(6, 37), (6, 48), (50, 20)])
def test_quant_block_kernel_matches_plain(card, kind, b, kv_len):
    """The int8 fused block against its plain version.  Bound: kernel 1's,
    on all but a small share of y: an LN output within an ulp of a
    half-integer after scaling may round to the neighbouring int8 code in
    one of the two, which moves that row's product by one quantization
    step (1/127 of the row's largest LN output times a weight)."""
    heads = 2
    x, _, qp = _quant_block(DTYPE[kind], heads, b=b, kv_len=kv_len)
    scale = (64 // heads) ** -0.5
    before = tq.quant_fused_vit_block.launches
    with torch.no_grad():
        got = tq.quant_fused_vit_block(x, qp, heads, scale, kv_len)
    want = tq.quant_fused_vit_block_plain(x, qp, heads, scale, kv_len)
    torch.cuda.synchronize()
    assert tq.quant_fused_vit_block.launches == before + 1
    _assert_quant_close(kind, got, want)
    with torch.no_grad():
        again = tq.quant_fused_vit_block(x, qp, heads, scale, kv_len)
    assert torch.equal(got, again)


def _assert_quant_close(kind, got, want):
    """Kernel 1's tolerance on all but 5e-3 of y, 0.05 of the largest |y|
    on every element."""
    assert got.dtype == want.dtype and torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs()
    tol = TOL[kind]["atol"] + TOL[kind]["rtol"] * want.float().abs()
    assert (err > tol).float().mean().item() < 5e-3, err.max().item()
    assert err.max().item() < 0.05 * want.float().abs().max().item()


# (dim, heads, b, s, kv_len): kernel 5 on its wgmma bodies at both compiled
# widths (MLP 4 x dim): the ViViT shape and the main path's kv_len with
# three 128-row tiles and a tail; one live key; every key live; 200 x 48
# rows; 260 live keys (the attention on attention_fwd.cuh's body); the
# main path itself, (512, 208, 192)
# (bf16 only: the float route, on no serving path, at the others)
QUANT_SM90_SHAPES = [
    (192, 3, 3, 208, 197), (192, 3, 2, 208, 1), (192, 3, 2, 208, 208),
    (64, 2, 5, 48, 1), (64, 2, 200, 48, 37), (64, 2, 2, 272, 260)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dim,heads,b,s,kv_len", [
    (kind, *shape) for kind in ("f32", "bf16") for shape in QUANT_SM90_SHAPES
] + [("bf16", 192, 3, 512, 208, 197)])
def test_quant_block_sm90_matches_plain(card, kind, dim, heads, b, s,
                                        kv_len):
    """Kernel 5 against its plain version under the card gates, the weights
    at 1 / sqrt(fan-in) as the main path draws them, x zero past kv_len;
    in bf16 its attention launch counted on the body attn_half_on_wgmma
    names; two runs bit-equal."""
    x, _, qp = _quant_block(DTYPE[kind], heads, dim=dim, mlp=4 * dim, b=b,
                            s=s, kv_len=kv_len, fan_in=True)
    assert all(tq.is_kmajor(qp[k]) for k in ("wqkv_q", "w1_q"))
    scale = (dim // heads) ** -0.5
    fn = tq.quant_fused_vit_block
    wgmma = int(kind == "bf16"
                and tfb.attn_half_on_wgmma(torch.bfloat16, dim // heads,
                                           kv_len))
    bodies = (fn.wgmma_launches, fn.streamed_launches)
    with torch.no_grad():
        got = fn(x, qp, heads, scale, kv_len)
        again = fn(x, qp, heads, scale, kv_len)
    want = tq.quant_fused_vit_block_plain(x, qp, heads, scale, kv_len)
    torch.cuda.synchronize()
    assert (fn.wgmma_launches - bodies[0],
            fn.streamed_launches - bodies[1]) == (2 * wgmma, 2 * (1 - wgmma))
    _assert_quant_close(kind, got, want)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["wqkv_q", "w1_q"])
def test_quant_block_refuses_codes_that_are_not_kmajor(card, name):
    """Kernel 5 reads Wqkv's and W1's codes K-major by TMA: the row-major
    (K, N) codes of the JAX layout, or a K-major view off a 16-byte
    boundary, are refused with the parameter's name before any launch."""
    x, _, qp = _quant_block(torch.bfloat16, 2)
    before = tq.quant_fused_vit_block.launches
    row_major = dict(qp, **{name: qp[name].contiguous()})
    with pytest.raises(ValueError, match=f"param {name}"):
        tq.quant_fused_vit_block(x, row_major, 2, 0.25, 37)
    k, n = qp[name].shape
    store = torch.zeros(n * k + 16, dtype=torch.int8, device="cuda")
    off = 1 if store.data_ptr() % 16 == 0 else 0
    view = store[off:off + n * k].view(n, k)
    view.copy_(qp[name].t())
    with pytest.raises(ValueError, match=f"param {name}"):
        tq.quant_fused_vit_block(x, dict(qp, **{name: view.t()}), 2, 0.25,
                                 37)
    assert tq.quant_fused_vit_block.launches == before


@pytest.mark.cuda
def test_quant_block_kernel_rejects_unsupported_shapes(card):
    x, _, qp = _quant_block(torch.bfloat16, 2)
    with pytest.raises(ValueError, match="compiled for"):
        tq.quant_fused_vit_block(x, qp, 4, 0.25, 37)     # head dim 16
    qp["wqkv_q"] = qp["wqkv_q"].float()
    with pytest.raises(ValueError, match="param wqkv_q"):
        tq.quant_fused_vit_block(x, qp, 2, 0.25, 37)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(256, 512, 512), (100, 512, 768),
                                   (300, 2048, 640), (64, 64, 64)])
def test_int8_matmul_kernel_matches_plain_bit_for_bit(card, kind, m, k, n):
    """The int32 sums are exact and the formula is the same, so on bf16
    inputs (exact in f32) the two agree in every bit; f32 inputs too."""
    rng = np.random.default_rng(m + k + n)
    x = torch.tensor(rng.standard_normal((m, k)).astype(np.float32)) \
        .to(DTYPE[kind]).cuda()
    x[3] = 0.0                                     # an all-zero row
    w = torch.tensor((rng.standard_normal((k, n)) * 0.05).astype(np.float32))
    w_q, w_s = tq.quantize_weight(w.cuda())
    before = tq.int8_matmul_fused.launches
    got = tq.int8_matmul_fused(x, w_q, w_s)
    want = tq.int8_matmul_fused_plain(x, w_q, w_s)
    torch.cuda.synchronize()
    assert tq.int8_matmul_fused.launches == before + 1
    assert got.dtype == x.dtype and got.shape == (m, n)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


@pytest.mark.cuda
def test_int8_matmul_kernel_rejects_unsupported_shapes(card):
    x = torch.zeros(64, 96, device="cuda")
    w_q = torch.zeros(96, 64, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="multiples of 64"):
        tq.int8_matmul_fused(x, w_q, torch.ones(1, 64, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,s,heads,d,kv_len", [
    (kind, *shape) for kind in ("f32", "bf16") for shape in (
        (3, 14, 2, 256, 14), (3, 16, 2, 256, 14), (4, 48, 2, 32, 37),
        (2, 208, 3, 64, 197), (2, 75, 2, 128, 75), (5, 3, 2, 256, 3),
        (3, 40, 4, 16, 33))
] + [("bf16", 1, 512, 1, 64, 500), ("f32", 1, 304, 1, 64, 300)])
def test_mha_kernel_matches_plain(card, kind, b, s, heads, d, kv_len):
    """o and lse of the packed-qkv attention against the plain version:
    f32 sums in other orders; bf16 one ulp of o where a probability or a
    sum lands on the other side of a rounding boundary.  The last two are
    the longest sequences a block's shared memory takes at head dim 64
    (the float route keeps K, V and the score tile in f32)."""
    rng = np.random.default_rng(s + d)
    qkv = torch.tensor(rng.standard_normal((b, s, 3 * heads * d))
                       .astype(np.float32)).to(DTYPE[kind]).cuda()
    before = tfa.fused_mha.launches
    o, lse = tfa.fused_mha(qkv, heads=heads, kv_len=kv_len, return_lse=True)
    wo, wlse = tfa.fused_mha_plain(qkv, heads, d ** -0.5, kv_len)
    torch.cuda.synchronize()
    assert tfa.fused_mha.launches == before + 1
    assert o.dtype == qkv.dtype and o.shape == (b, s, heads * d)
    assert lse.dtype == torch.float32 and lse.shape == (b, s, heads)
    torch.testing.assert_close(o.float(), wo.float(), **TOL[kind])
    torch.testing.assert_close(lse, wlse, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_mha_kernel_refuses_gradients_dropout_and_shapes(card):
    """Gradients and dropout are taken; what the kernels do not cover
    raises: a head dim with no bfloat16 instance, and a head whose
    rows do not fit a block's shared memory in the backward (float at head
    dim 384: 16 tokens, where the forward takes 32), before the forward
    launches when the input needs a gradient."""
    with pytest.raises(ValueError, match="head dims"):
        tfa.fused_mha(torch.zeros(2, 16, 3 * 2 * 48, device="cuda",
                                  dtype=torch.bfloat16), heads=2)
    wide = torch.zeros(1, 32, 3 * 384, device="cuda", requires_grad=True)
    before = tfa.fused_mha.launches
    with pytest.raises(ValueError, match="backward kernel.*shared memory"):
        tfa.fused_mha(wide, heads=1)
    assert tfa.fused_mha.launches == before
    assert tfa.fused_mha(wide.detach(), heads=1).shape == (1, 32, 384)
    with pytest.raises(ValueError, match="seed"):
        tfa.fused_mha(wide.detach(), heads=1, dropout_rate=0.1)


# the packed-qkv attention backward (kernel 4) and the dropout of both
# kernels; short shapes, then the longest the forward takes: several
# tiles of rows and streamed chunks in the backward
MHA_BWD_SHAPES = [(kind, *shape) for kind in ("f32", "bf16") for shape in (
    (3, 14, 2, 256, 14), (4, 48, 2, 32, 37), (5, 3, 2, 256, 3),
    (3, 40, 4, 16, 33), (2, 30, 2, 128, 23))] + [
    ("f32", 1, 256, 2, 64, 250), ("bf16", 2, 208, 3, 64, 197),
    ("bf16", 1, 160, 2, 256, 150), ("bf16", 1, 512, 2, 64, 509)]
MHA_RATE = 0.5


def _mha_inputs(kind, b, s, heads, d, seed):
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, s, 3 * heads * d, generator=gen)
    do = torch.randn(b, s, heads * d, generator=gen)
    return qkv.to(DTYPE[kind]).cuda(), do.to(DTYPE[kind]).cuda()


def _assert_dqkv_close(kind, got, want, heads, d):
    """Per tensor (dq, dk, dv): the backward bound of the fused block."""
    assert got.dtype == want.dtype and got.shape == want.shape
    for i, name in enumerate(("dq", "dk", "dv")):
        g = got[..., i * heads * d:(i + 1) * heads * d].float()
        w = want[..., i * heads * d:(i + 1) * heads * d].float()
        assert torch.isfinite(g).all(), name
        err = (g - w).abs().max().item()
        bound = BWD_ULPS[kind] * EPS[kind] * w.abs().max().item()
        assert err <= bound, f"{kind} {name}: {err:.3e} > {bound:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, MHA_RATE])
@pytest.mark.parametrize("kind,b,s,heads,d,kv_len", MHA_BWD_SHAPES)
def test_mha_bwd_kernel_matches_plain(card, kind, b, s, heads, d, kv_len,
                                      rate):
    """Autograd through ``fused_mha`` on the card: one launch of each
    kernel; o against the plain forward and dqkv against the plain
    backward from the kernel's own (o, lse), both given the mask the
    library exports for the seed.  Keys past kv_len get exact zeros."""
    seed = 4242
    qkv, do = _mha_inputs(kind, b, s, heads, d, s + d)
    keep = tfa.mha_dropout_masks(seed, rate, b, s, heads, "cuda") \
        if rate > 0.0 else None
    leaf = qkv.clone().requires_grad_(True)
    before = (tfa.fused_mha.launches, tfa.fused_mha.bwd_launches)
    o, lse = tfa.fused_mha(leaf, heads=heads, kv_len=kv_len,
                           dropout_rate=rate, seed=seed, return_lse=True)
    o.backward(do)
    torch.cuda.synchronize()
    assert (tfa.fused_mha.launches, tfa.fused_mha.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    scale = d ** -0.5
    wo, wlse = tfa.fused_mha_plain(qkv, heads, scale, kv_len, keep, rate)
    torch.testing.assert_close(o.detach().float(), wo.float(), **TOL[kind])
    torch.testing.assert_close(lse, wlse, atol=1e-4, rtol=1e-4)
    want = tfa.fused_mha_bwd_plain(qkv, o.detach(), lse, do, heads, scale,
                                   kv_len, keep, rate)
    _assert_dqkv_close(kind, leaf.grad, want, heads, d)
    dead = leaf.grad.reshape(b, s, 3, heads * d)[:, kv_len:, 1:]
    assert torch.equal(dead, torch.zeros_like(dead))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, MHA_RATE])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_mha_bwd_kernel_takes_every_single_block_length(card, kind, rate):
    """S = 512 at head dim 256 (past what the forward kernel takes), the
    longest sequence of a single kv block: the backward kernel from the
    plain forward's (o, lse) against the plain backward."""
    b, s, heads, d, kv_len, seed = 1, 512, 2, 256, 500, 77
    qkv, do = _mha_inputs(kind, b, s, heads, d, 3)
    keep = tfa.mha_dropout_masks(seed, rate, b, s, heads, "cuda") \
        if rate > 0.0 else None
    scale = d ** -0.5
    o, lse = tfa.fused_mha_plain(qkv, heads, scale, kv_len, keep, rate)
    got = tfa._mha_bwd_cuda(qkv, o, lse, do, heads, scale, kv_len, rate, seed)
    want = tfa.fused_mha_bwd_plain(qkv, o, lse, do, heads, scale, kv_len,
                                   keep, rate)
    _assert_dqkv_close(kind, got, want, heads, d)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_mha_bwd_kernel_is_deterministic(card, kind):
    """No atomics: two runs of the backward give the same bits."""
    qkv, do = _mha_inputs(kind, 6, 14, 2, 256, 5)
    with torch.no_grad():
        o, lse = tfa.fused_mha(qkv, heads=2, kv_len=12,
                               dropout_rate=MHA_RATE, seed=9,
                               return_lse=True)
    runs = [tfa._mha_bwd_cuda(qkv, o, lse, do, 2, 256 ** -0.5, 12,
                              MHA_RATE, 9) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
def test_mha_dropout_masks_on_the_card(card):
    """The attention mask drops about the rate (within 4 standard
    deviations), repeats for a seed, differs between seeds, and is the
    mask the forward kernel applies: with v the identity's rows, o shows
    which probabilities were kept."""
    b, s, heads = 4, 14, 2
    keep = tfa.mha_dropout_masks(11, MHA_RATE, b, s, heads, "cuda")
    band = 4 * (MHA_RATE * (1 - MHA_RATE) / keep.numel()) ** 0.5
    assert keep.shape == (b, heads, s, s)
    assert abs((~keep).float().mean().item() - MHA_RATE) < band
    assert torch.equal(keep, tfa.mha_dropout_masks(11, MHA_RATE, b, s, heads,
                                                   "cuda"))
    assert not torch.equal(keep, tfa.mha_dropout_masks(12, MHA_RATE, b, s,
                                                       heads, "cuda"))
    d = 16
    qkv = torch.zeros(b, s, 3, heads, d)
    qkv[:, :, 2, :, :s] = torch.eye(s)[None, :, None, :]   # v = I
    with torch.no_grad():
        o = tfa.fused_mha(qkv.reshape(b, s, -1).cuda(), heads=heads,
                          dropout_rate=MHA_RATE, seed=11)
    kept = o.reshape(b, s, heads, d)[..., :s].permute(0, 2, 1, 3) != 0
    assert torch.equal(kept, keep)


@pytest.mark.cuda
@pytest.mark.parametrize("name,site_pred,matmuls", [
    ("ptn", None, 4), ("ptn_shared", lambda k, n: True, 24)])
def test_quantized_ptn_serves_through_the_kernels(card, name, site_pred,
                                                  matmuls):
    """A PTN wide enough for the fused int8 matmul (512) behind
    Predictor(quantize=True) on the card: the attention and int8-matmul
    launch counts of one forward (32 rows, so that the shared model's
    second pass over 3 tokens a row still has the 64 rows the fused matmul
    asks for), and the scores against the same quantized model on the CPU
    (both bf16; a flipped int8 code or a bf16 rounding moves a score by up
    to a few 1e-3)."""
    from devt_tpu_torch.config import Config
    from devt_tpu_torch.registry import build_model, example_batch
    from devt_tpu_torch.serve import Predictor

    cfg = Config(model=name, seq_len=13, nlayers=2, nhid=512,
                 input_dimension=512, nhead=8, dropout=0.0, precision="bf16",
                 experts=("video-embeddings", "audio-embeddings"))
    weights = build_model(cfg).state_dict()
    request = {"experts": example_batch(cfg, 32)["experts"]}
    kw = dict(buckets=(32,), quantize=True, quant_site_pred=site_pred)
    pred = Predictor(cfg, weights, **kw)
    tfa.fused_mha.launches = tq.int8_matmul_fused.launches = 0
    got = pred.predict(request)["scores"]
    passes = 3 if name == "ptn_shared" else 2
    assert tfa.fused_mha.launches == 2 * passes
    assert tq.int8_matmul_fused.launches == matmuls
    want = Predictor(cfg, weights, device="cpu", **kw).predict(request)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want["scores"], atol=2e-2, rtol=0)


# PTN gradients of one step on the card against the CPU, per leaf, as a
# share of the leaf's largest element.  f32, with the kernels against the
# CPU's plain kernel path: sums in other orders, amplified where a
# LayerNorm backward cancels.  bf16: the two machines' products round
# apart and a ReLU input near zero lands on either side, which moves a
# last-layer FFN gradient of a few rows by a tenth of its largest element
# and more; the same step without the attention kernels shows the same
# gap, so the worst leaf with the kernels must be within the bound of
# chip_smoke.py's phase 7 (GRAD_RTOL) of the worst leaf without them.
PTN_F32_GRAD_RTOL, GRAD_RTOL = 1e-3, 5e-2


def _ptn_grad_gaps(name, kind, impl, rate, launches):
    """One PTN training step (width 512, 2 layers, 2 experts, 4 rows) on
    the card and on the CPU from the same weights: the attention kernels'
    launches on the card, and per leaf the largest difference as a share
    of the leaf's largest element."""
    from devt_tpu_torch.config import Config
    from devt_tpu_torch.models.layers import DropoutRng
    from devt_tpu_torch.registry import build_model, example_batch
    from devt_tpu_torch.train.steps import forward_and_loss

    cfg = Config(model=name, seq_len=13, nlayers=2, nhid=512,
                 input_dimension=512, nhead=8, dropout=rate, precision=kind,
                 attention_impl=impl,
                 experts=("video-embeddings", "audio-embeddings"))
    batch = {k: torch.as_tensor(v) for k, v in example_batch(cfg, 4).items()}

    def grads(m, b):
        params = dict(m.named_parameters())
        loss, _, _ = forward_and_loss(m, cfg, {"params": params}, b,
                                      DropoutRng(5), train=True)
        return loss, dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))

    tfa.fused_mha.launches = tfa.fused_mha.bwd_launches = 0
    loss, got = grads(build_model(cfg).cuda(),
                      {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    assert (tfa.fused_mha.launches, tfa.fused_mha.bwd_launches) == (
        launches, launches)
    assert torch.isfinite(loss) and all(
        torch.isfinite(g).all() for g in got.values())
    if rate > 0.0:      # the card's dropout mask is not the CPU's
        return {}
    _, want = grads(build_model(cfg), batch)
    return {k: (got[k].cpu().float() - w.float()).abs().max().item()
            / max(w.float().abs().max().item(), 1e-6)
            for k, w in want.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name,launches", [("ptn", 4), ("ptn_shared", 6)])
@pytest.mark.parametrize("kind,rate", [("f32", 0.0), ("bf16", 0.0),
                                       ("bf16", MHA_RATE)])
def test_ptn_trains_through_the_kernels(card, name, launches, kind, rate):
    """One PTN training step on the card through the attention kernels
    (``attention_impl="pallas"``): they launch once per encoder layer and
    pass in each direction, the loss and the gradients are finite, and
    without dropout the gradients match the CPU's plain kernel path within
    the bound of their precision."""
    gaps = _ptn_grad_gaps(name, kind, "pallas", rate, launches)
    if rate > 0.0:
        return
    worst = max(gaps, key=gaps.get)
    if kind == "f32":
        assert gaps[worst] <= PTN_F32_GRAD_RTOL, f"{gaps[worst]:.3e} at {worst}"
        return
    floor = _ptn_grad_gaps(name, kind, "xla", rate, 0)
    lib = max(floor, key=floor.get)
    assert gaps[worst] <= floor[lib] + GRAD_RTOL, (
        f"{gaps[worst]:.3e} at {worst} with the kernels, {floor[lib]:.3e} at "
        f"{lib} without them")


# --- the attention half (kernels 7 and 8) and the MoE ViViT ---------------

def _half(dtype, **kw):
    x, params = _block(dtype, **kw)
    return x, {k: params[k] for k in tfb.HALF_NAMES}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("dim,heads,b,kv_len", [(64, 2, 6, 37), (64, 2, 6, 48),
                                                (64, 2, 6, 20),
                                                (64, 2, 50, 37),
                                                (192, 3, 4, 197)])
def test_attn_half_kernels_match_plain(card, kind, dim, heads, b, kv_len):
    """Kernel 7 (u and the residual lanes) and kernel 8 (dx and the 5
    gradients, through FusedAttnHalf and autograd) against the plain
    versions; both bf16 widths, b=50 crossing a split of the weight
    gradients, kv_len=20 leaving the last 16 keys wholly masked."""
    s = 208 if dim == 192 else 48
    x, params = _half(DTYPE[kind], dim=dim, b=b, s=s, kv_len=kv_len)
    scale = (dim // heads) ** -0.5
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)) \
        .to(x.dtype).cuda()
    xr = x.clone().requires_grad_(True)
    pr = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    before = (tfb.fused_attn_half.launches, tfb.fused_attn_half.bwd_launches)
    u, res = tfb.fused_attn_half(xr, pr, heads, scale, kv_len)
    u.backward(dy)
    torch.cuda.synchronize()
    assert (tfb.fused_attn_half.launches,
            tfb.fused_attn_half.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    want_u, want_res = tfb.fused_attn_half_fwd_plain(x, params, heads, scale,
                                                     kv_len)
    torch.testing.assert_close(u.detach().float(), want_u.float(),
                               **TOL[kind])
    torch.testing.assert_close(res, want_res, atol=1e-4, rtol=1e-4)
    assert res[..., heads + 2:].abs().max().item() == 0.0
    want = tfb.fused_attn_half_bwd_plain(x, params, res, dy, heads, scale,
                                         kv_len)
    _assert_bwd_close(kind, (xr.grad, {k: pr[k].grad
                                       for k in tfb.HALF_NAMES}), want,
                      tfb.HALF_NAMES)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_attn_half_backward_is_deterministic(card, kind):
    """No atomics: two runs of kernel 8 give the same bits."""
    x, params = _half(DTYPE[kind], b=50)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)) \
        .to(x.dtype).cuda()
    with torch.no_grad():
        _, res = tfb.fused_attn_half(x, params, 2, 0.25, 37)
    runs = [tfb._half_bwd_cuda(x, params, res, dy, 2, 0.25, 37)
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    for k in tfb.HALF_NAMES:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


# (dim, heads, b, s, kv_len): kernel 7's attention launch on the one-shot
# wgmma body at the MoE main path (512, 208, 192), kv_len 197, and around
# it: one token, 65 tokens (two query tiles, the second of one row) with 1
# or 65 live keys, 256 live keys (the widest score row), at both bf16
# widths; 257 live keys take the streamed body
HALF_WGMMA_SHAPES = [
    (192, 3, 512, 208, 197), (192, 3, 4, 1, 1), (192, 3, 4, 65, 1),
    (192, 3, 4, 65, 65), (192, 3, 4, 256, 256), (192, 3, 4, 272, 257),
    (64, 2, 6, 1, 1), (64, 2, 6, 65, 1), (64, 2, 6, 208, 197),
    (64, 2, 6, 256, 256), (64, 2, 6, 272, 257)]


@pytest.mark.cuda
@pytest.mark.parametrize("dim,heads,b,s,kv_len", HALF_WGMMA_SHAPES)
def test_attn_half_wgmma_matches_plain(card, dim, heads, b, s, kv_len):
    """Kernel 7 in bf16 against its plain version, its attention launch on
    the body ``attn_half_on_wgmma`` names (the one-shot wgmma body,
    normalising after P·V, for at most 256 live keys; attention_fwd.cuh's
    above): u and the residual lanes (lse, mu1, rstd1) at the forward
    tolerance, the pad lanes 0, one launch counted on that body, two runs
    bit-equal.  Every query row < S is written, those past kv_len too."""
    x, params = _half(torch.bfloat16, dim=dim, b=b, s=s, kv_len=kv_len)
    scale = (dim // heads) ** -0.5
    wgmma = int(tfb.attn_half_on_wgmma(torch.bfloat16, dim // heads, kv_len))
    assert wgmma == (kv_len <= 256)
    bodies = _half_bodies()
    with torch.no_grad():
        u, res = tfb.fused_attn_half(x, params, heads, scale, kv_len)
        u2, res2 = tfb.fused_attn_half(x, params, heads, scale, kv_len)
    want_u, want_res = tfb.fused_attn_half_fwd_plain(x, params, heads, scale,
                                                     kv_len)
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(_half_bodies(), bodies)] == \
        [2 * wgmma, 2 * (1 - wgmma)]
    torch.testing.assert_close(u.float(), want_u.float(), **TOL["bf16"])
    torch.testing.assert_close(res[..., :heads + 2], want_res[..., :heads + 2],
                               **TOL["bf16"])
    assert res[..., heads + 2:].abs().max().item() == 0.0
    assert torch.equal(u, u2) and torch.equal(res, res2)


# (dim, heads, b, s, kv_len): kernel 8's attention backward on the wgmma
# route at the MoE main path's kv_len and around it: one live key, every
# key live, 65 keys (the dk/dv body's second key tile), 256 live keys (the
# recompute's widest score row), at both bf16 widths; 257 live keys keep
# attention_bwd_bf16
HALF_BWD_SHAPES = [
    (192, 3, 4, 208, 197), (192, 3, 4, 208, 1), (192, 3, 4, 208, 208),
    (192, 3, 2, 272, 256), (192, 3, 2, 272, 257), (64, 2, 6, 48, 1),
    (64, 2, 6, 80, 65), (64, 2, 6, 48, 48), (64, 2, 50, 48, 37)]


@pytest.mark.cuda
@pytest.mark.parametrize("dim,heads,b,s,kv_len", HALF_BWD_SHAPES)
def test_attn_half_bwd_wgmma_matches_plain(card, dim, heads, b, s, kv_len):
    """Kernel 8 in bf16 against its plain version, its attention backward
    on the route ``block_bwd_on_wgmma`` names: dx and the 5 gradients
    within 4 ulps of each tensor's largest element, one launch counted on
    that route, two runs bit-equal.  The weights at 1 / sqrt(fan-in), x
    drawn on every row (as test_fused_block_sm90_matches_plain draws it:
    a zero row's LayerNorm multiplies rounding differences by 316)."""
    x, params = _block(torch.bfloat16, dim=dim, b=b, s=s, kv_len=kv_len,
                       fan_in=True, pad=False)
    half = {k: params[k] for k in tfb.HALF_NAMES}
    scale = (dim // heads) ** -0.5
    du = torch.randn(x.shape, generator=torch.Generator().manual_seed(8)) \
        .to(x.dtype).cuda()
    wgmma = int(tfb.block_bwd_on_wgmma(torch.bfloat16, dim // heads, kv_len))
    assert wgmma == (kv_len <= 256)
    fn = tfb.fused_attn_half
    with torch.no_grad():
        _, res = tfb.fused_attn_half(x, half, heads, scale, kv_len)
    bodies = (fn.bwd_wgmma_launches, fn.bwd_streamed_launches)
    runs = [tfb._half_bwd_cuda(x, half, res, du, heads, scale, kv_len)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert (fn.bwd_wgmma_launches - bodies[0],
            fn.bwd_streamed_launches - bodies[1]) == (2 * wgmma,
                                                      2 * (1 - wgmma))
    want = tfb.fused_attn_half_bwd_plain(x, half, res, du, heads, scale,
                                         kv_len)
    _assert_bwd_close("bf16", runs[0], want, tfb.HALF_NAMES)
    assert torch.equal(runs[0][0], runs[1][0])
    for k in tfb.HALF_NAMES:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


@pytest.mark.cuda
def test_attn_half_route_matches_the_c_rule(card):
    """The C entry's rule (devt_attn_half_route) is the Python
    predicate's, kernel 9's rule with kv_len as the key count."""
    lib = _build.load("attn_half", tfb._declare_half)
    for dtype, code in tfb._DTYPE_CODE.items():
        for d in (8, 16, 32, 48, 64, 128, 256):
            for kv_len in (0, 1, 17, 197, 256, 257, 512):
                assert bool(lib.devt_attn_half_route(code, d, kv_len)) == \
                    tfb.attn_half_on_wgmma(dtype, d, kv_len), (dtype, d,
                                                               kv_len)


@pytest.mark.cuda
def test_attn_half_refuses_what_the_kernels_do_not_take(card):
    x, params = _half(torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16 kernel is compiled"):
        tfb.fused_attn_half(x, params, 4, 0.25, 37)      # head dim 16
    params["wo"] = params["wo"].float()
    with pytest.raises(ValueError, match="param wo"):
        tfb.fused_attn_half(x, params, 2, 0.25, 37)
    # a backward that would not fit is refused before the forward runs
    # (400 tokens of head dim 64: q, k, v and datt of a head need more
    # than a block's shared memory)
    x, params = _half(torch.bfloat16, dim=192, s=400, kv_len=400)
    before = tfb.fused_attn_half.launches
    with pytest.raises(ValueError, match="shared memory"):
        tfb.fused_attn_half(x.requires_grad_(True), params, 3, 0.125, 400)
    assert tfb.fused_attn_half.launches == before


def _moe_vivit(kind, dropout=0.0):
    from devt_tpu_torch.models.vivit import ViViT

    return ViViT(image_size=32, patch_size=8, num_classes=5, num_frames=2,
                 dim=64, depth=4, heads=2, dim_head=32, channels_last=True,
                 moe_experts=4, dropout=dropout, dtype=DTYPE[kind]) \
        .init_weights(torch.Generator().manual_seed(0))


def _half_bodies():
    """Launches of kernel 7 by the body of its attention launch: (wgmma,
    streamed)."""
    half = tfb.fused_attn_half
    return (half.wgmma_launches, half.streamed_launches)


def _moe_counts():
    return (tfb.fused_vit_block.launches, tfb.fused_vit_block.bwd_launches,
            tfb.fused_attn_half.launches, tfb.fused_attn_half.bwd_launches,
            tfa.fused_mha.launches, tfa.fused_mha.bwd_launches)


@pytest.mark.cuda
def test_moe_vivit_forward_launches(card):
    """An eval forward of a depth-4 MoE-ViViT (blocks dense, MoE, dense,
    MoE) launches kernel 1 twice and kernel 7 twice, nothing backward;
    both of kernel 7's attention launches run the one-shot wgmma body."""
    model = _moe_vivit("bf16").cuda().eval()
    x = torch.randn(2, 2, 32, 32, 3, generator=torch.Generator()
                    .manual_seed(1)).cuda()
    before, bodies = _moe_counts(), _half_bodies()
    with torch.no_grad():
        out = model(x)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_moe_counts(), before)] == [2, 0, 2, 0,
                                                              0, 0]
    assert [a - b for a, b in zip(_half_bodies(), bodies)] == [2, 0]
    assert torch.isfinite(out.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dropout,counts", [
    ("f32", 0.0, [2, 2, 2, 2, 0, 0]), ("bf16", 0.0, [2, 2, 2, 2, 0, 0]),
    ("bf16", 0.5, [2, 2, 0, 0, 2, 2])])
def test_moe_vivit_step_launches_and_gradients(card, kind, dropout, counts):
    """One training step of the MoE-ViViT: at dropout 0 kernels 1, 2, 7
    and 8 twice each; at dropout 0.5 the MoE blocks' attention runs
    unfused, through kernels 3 and 4.  In f32 the gradients match the
    CPU's plain path (the same routing) within 1e-3 of each leaf's largest
    element; the load-balance loss is finite and in the loss."""
    from devt_tpu_torch.config import Config
    from devt_tpu_torch.models.layers import DropoutRng
    from devt_tpu_torch.train.steps import forward_and_loss

    cfg = Config(model="vivit", precision=kind, n_classes=5, frame_len=2,
                 moe_experts=4, dropout=dropout)
    rng = np.random.default_rng(3)
    batch = {"vid": torch.tensor(rng.standard_normal((2, 2, 32, 32, 3))
                                 .astype(np.float32)),
             "label": torch.tensor((rng.random((2, 5)) < 0.3)
                                   .astype(np.float32))}

    def grads(model, b):
        params = dict(model.named_parameters())
        loss, aux, _ = forward_and_loss(model, cfg, {"params": params}, b,
                                        DropoutRng(5), train=True)
        return loss, aux, dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))

    before, bodies = _moe_counts(), _half_bodies()
    loss, aux, got = grads(_moe_vivit(kind, dropout).cuda(),
                           {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_moe_counts(), before)] == counts
    # kernel 7's attention: bf16 on the wgmma body, f32 on the streamed one
    wgmma = int(tfb.attn_half_on_wgmma(DTYPE[kind], 32, 17))
    assert [a - b for a, b in zip(_half_bodies(), bodies)] == \
        [wgmma * counts[2], (1 - wgmma) * counts[2]]
    assert torch.isfinite(loss) and torch.isfinite(aux["moe_aux"])
    assert all(torch.isfinite(g).all() for g in got.values())
    if kind != "f32":
        return
    want_loss, want_aux, want = grads(_moe_vivit(kind, dropout), batch)
    assert abs(aux["moe_aux"].item() - want_aux["moe_aux"].item()) < 1e-5
    for k, w in want.items():
        gap = (got[k].cpu() - w).abs().max().item() / max(
            w.abs().max().item(), 1e-6)
        assert gap <= PTN_F32_GRAD_RTOL, f"{k}: {gap:.3e}"


# ---------------------------------------------------------------------------
# the split-q/k/v attention: kernels 9 and 10 (one kv block) and 11
# ---------------------------------------------------------------------------

# (b, h, sq, skv, d, kv_len, strided): head dims 16-256, ragged S, kv_len
# < S, the transposed head views of a packed qkv, S = 512 at head dim 256
# (which kernel 3 cannot take), Sq != Skv (blockwise however short)
FLASH_SHAPES = [
    (2, 3, 197, 197, 64, 197, True), (1, 2, 512, 512, 256, 500, False),
    (2, 2, 45, 45, 16, 40, True), (1, 2, 75, 75, 128, 70, False),
    (1, 2, 14, 14, 32, 14, True), (1, 3, 592, 592, 64, 577, True),
    (1, 2, 40, 300, 32, 290, False), (1, 1, 600, 600, 256, 577, False),
    (2, 2, 520, 520, 128, 519, True)]


def _flash_inputs(kind, b, h, sq, skv, d, strided, seed=0):
    """q, k, v on the card; ``strided``: the (B, H, S, d) head views of one
    packed (B, S, 3, H, d) tensor, as packed_mha cuts them."""
    gen = torch.Generator().manual_seed(seed)
    if strided:
        assert sq == skv
        qkv = torch.randn(b, sq, 3, h, d, generator=gen).to(
            DTYPE[kind]).cuda()
        return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))
    return (torch.randn(b, h, sq, d, generator=gen).to(DTYPE[kind]).cuda(),
            *(torch.randn(b, h, skv, d, generator=gen).to(DTYPE[kind]).cuda()
              for _ in range(2)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,sq,skv,d,kv_len,strided", FLASH_SHAPES)
def test_flash_kernels_match_plain(card, kind, b, h, sq, skv, d, kv_len,
                                   strided):
    """Kernel 9 (Sq == Skv <= 512) or 11 against its plain version: o at
    the forward gate, lse at 1e-4 in f32 and at kernel 1's forward limit in
    bf16 (q and k rounded to bf16 before sums in another order)."""
    q, k, v = _flash_inputs(kind, b, h, sq, skv, d, strided, sq + d)
    single = sq == skv and tfa.fits_single_block(sq)
    before = (tfa.flash_attention.single_launches,
              tfa.flash_attention.blocked_launches)
    with torch.no_grad():
        o, lse = tfa.flash_attention(q, k, v, kv_len=kv_len, return_lse=True)
    plain = tfa.flash_single_fwd_plain if single \
        else tfa.flash_blocked_fwd_plain
    wo, wlse = plain(q, k, v, d ** -0.5, kv_len)
    torch.cuda.synchronize()
    assert (tfa.flash_attention.single_launches,
            tfa.flash_attention.blocked_launches) == (
        before[0] + single, before[1] + (not single))
    assert o.shape == (b, h, sq, d) and o.is_contiguous()
    assert lse.shape == (b * h, sq) and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), wo.float(), **TOL[kind])
    lse_tol = dict(atol=1e-4, rtol=1e-4) if kind == "f32" else TOL["bf16"]
    torch.testing.assert_close(lse, wlse, **lse_tol)


FLASH_BWD_SHAPES = [(2, 3, 197, 64, 197, True), (1, 2, 512, 256, 500, False),
                    (2, 2, 45, 16, 40, True), (1, 2, 75, 128, 70, False),
                    (1, 1, 14, 32, 14, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,s,d,kv_len,strided", FLASH_BWD_SHAPES)
def test_flash_bwd_kernel_matches_plain(card, kind, b, h, s, d, kv_len,
                                        strided):
    """Kernel 10 through ``flash_attention`` and autograd, one launch on
    the body ``blocked_bwd_on_wgmma`` names (bf16 at head dim 16, 32 or
    64: kernels 12's and 13's wgmma bodies; f32 and head dims 128 and 256:
    the streamed one): dq, dk, dv against the plain backward on the
    forward's (o, lse), per tensor within the backward bound; keys past
    kv_len get exact zeros; two runs give the same bits."""
    q, k, v = _flash_inputs(kind, b, h, s, s, d, strided, s + d)
    do = torch.randn(b, h, s, d, generator=torch.Generator().manual_seed(
        9)).to(DTYPE[kind]).cuda()

    def run():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o, lse = tfa.flash_attention(*leaves, kv_len=kv_len,
                                     return_lse=True)
        return (o.detach(), lse, *torch.autograd.grad(o, leaves, do))

    before, bodies = (tfa.flash_attention.single_bwd_launches,
                      _single_bwd_bodies())
    o, lse, *got = run()
    torch.cuda.synchronize()
    assert tfa.flash_attention.single_bwd_launches == before + 1
    wgmma = int(tfa.blocked_bwd_on_wgmma(DTYPE[kind], d))
    assert [a - b_ for a, b_ in zip(_single_bwd_bodies(), bodies)] == \
        [wgmma, 1 - wgmma]
    want = tfa.flash_single_bwd_plain(q, k, v, o, lse, do, d ** -0.5,
                                      kv_len)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs().max().item()
        bound = BWD_ULPS[kind] * EPS[kind] * w.float().abs().max().item()
        assert err <= bound, f"{kind} {name}: {err:.3e} > {bound:.3e}"
    for g in got[1:]:
        assert torch.equal(g[:, :, kv_len:], torch.zeros_like(
            g[:, :, kv_len:]))
    again = run()[2:]
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


def _single_bwd_bodies():
    """Launches of kernel 10 by body: (wgmma, streamed)."""
    fa = tfa.flash_attention
    return (fa.single_bwd_wgmma_launches, fa.single_bwd_streamed_launches)


@pytest.mark.cuda
def test_flash_refusals_and_dispatch(card):
    """No bf16 instance at head dim 48; a blockwise gradient whose float
    tiles the backward cannot hold (head dim 288) is refused before any
    launch; ``"pallas"`` with dropout raises as JAX's does, and ``"auto"``
    with dropout runs the plain attention (no launch)."""
    from devt_tpu_torch.models.layers import DropoutRng
    from devt_tpu_torch.ops import attention as tatt

    with pytest.raises(ValueError, match="head dims"):
        z = torch.zeros(1, 2, 16, 48, device="cuda", dtype=torch.bfloat16)
        tfa.flash_attention(z, z, z)
    q = torch.zeros(1, 1, 520, 288, device="cuda", requires_grad=True)
    counts = (tfa.flash_attention.single_launches,
              tfa.flash_attention.blocked_launches,
              tfa.flash_attention.single_bwd_launches)
    with pytest.raises(ValueError, match="shared memory"):
        tfa.flash_attention(q, q, q)
    with torch.no_grad():  # the forward alone takes it
        assert tfa.flash_attention(q, q, q).shape == q.shape
    counts = (counts[0], counts[1] + 1, counts[2])
    x = torch.randn(2, 2, 40, 32, device="cuda")
    with pytest.raises(NotImplementedError, match="dropout"):
        tatt.scaled_dot_product_attention(x, x, x, impl="pallas",
                                          dropout_rate=0.1, rng=DropoutRng(0))
    out = tatt.scaled_dot_product_attention(x, x, x, impl="auto",
                                            dropout_rate=0.1,
                                            rng=DropoutRng(0))
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert (tfa.flash_attention.single_launches,
            tfa.flash_attention.blocked_launches,
            tfa.flash_attention.single_bwd_launches) == counts
    tatt.scaled_dot_product_attention(x, x, x)
    assert tfa.flash_attention.single_launches == counts[0] + 1


def _flash_counts():
    return (tfb.fused_vit_block.launches, tfb.fused_vit_block.bwd_launches,
            tfa.fused_mha.launches, tfa.fused_mha.bwd_launches,
            tq.quant_fused_vit_block.launches,
            tfa.flash_attention.single_launches,
            tfa.flash_attention.single_bwd_launches,
            tfa.flash_attention.blocked_launches)


def _vivit_step(model, kind, image, n_classes=5):
    """One forward and backward of the ViViT's training loss on the card."""
    from devt_tpu_torch.config import Config
    from devt_tpu_torch.models.layers import DropoutRng
    from devt_tpu_torch.train.steps import forward_and_loss

    cfg = Config(model="vivit", precision=kind, n_classes=n_classes,
                 frame_len=2)
    rng = np.random.default_rng(4)
    batch = {"vid": torch.tensor(rng.standard_normal(
        (2, 2, image, image, 3)).astype(np.float32)).cuda(),
        "label": torch.tensor((rng.random((2, n_classes)) < 0.3).astype(
            np.float32)).cuda()}
    params = dict(model.named_parameters())
    loss, _, _ = forward_and_loss(model, cfg, {"params": params}, batch,
                                  DropoutRng(5), train=True)
    grads = torch.autograd.grad(loss, list(params.values()))
    torch.cuda.synchronize()
    assert torch.isfinite(loss) and all(torch.isfinite(g).all()
                                        for g in grads)


def _vivit(kind, **kw):
    from devt_tpu_torch.models.vivit import ViViT

    base = dict(image_size=32, patch_size=8, num_classes=5, num_frames=2,
                depth=2, channels_last=True, dtype=DTYPE[kind])
    return ViViT(**{**base, **kw}).init_weights(
        torch.Generator().manual_seed(0)).cuda()


def _delta(before):
    return [a - b for a, b in zip(_flash_counts(), before)]


@pytest.mark.cuda
def test_vivit_at_an_uncompiled_width_serves_and_trains(card):
    """Repair 1: a bf16 ViViT at dim 384, 6 heads of 64 (no bf16 fused
    instance) runs its space blocks unfused instead of raising: serving
    through kernel 3, a training step through kernels 3 and 4, int8
    serving through kernel 9; none of kernels 1, 2, 5."""
    from devt_tpu_torch.ops.attention import quant_scope

    model = _vivit("bf16", dim=384, heads=6, dim_head=64)
    x = torch.randn(2, 2, 32, 32, 3, device="cuda")
    before = _flash_counts()
    with torch.no_grad():
        assert torch.isfinite(model.eval()(x).float()).all()
    assert _delta(before) == [0, 0, 2, 0, 0, 0, 0, 0]
    before = _flash_counts()
    _vivit_step(model.train(), "bf16", 32)
    assert _delta(before) == [0, 0, 2, 2, 0, 0, 0, 0]
    before = _flash_counts()
    with torch.no_grad(), quant_scope():
        assert torch.isfinite(model.eval()(x).float()).all()
    assert _delta(before) == [0, 0, 0, 0, 0, 2, 0, 0]


@pytest.mark.cuda
def test_vivit_at_416_tokens_trains_through_kernels_3_and_4(card):
    """Repair 2: 401 space tokens pad to 416, more than kernel 2 holds at
    head dim 64: a training step takes the unfused block (kernels 3 and 4)
    instead of raising after kernel 1's forward; serving keeps kernel 1."""
    model = _vivit("bf16", image_size=320, patch_size=16, depth=1)
    before = _flash_counts()
    _vivit_step(model.train(), "bf16", 320)
    assert _delta(before)[:4] == [0, 0, 1, 1]
    before = _flash_counts()
    with torch.no_grad():
        model.eval()(torch.randn(2, 2, 320, 320, 3, device="cuda"))
    assert _delta(before)[:4] == [1, 0, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_vivit_above_one_kv_block_evaluates_and_refuses_training(card, kind):
    """577 space tokens (pad 592): each space block's attention is one
    launch of kernel 11 in evaluation, in the model dtype and in int8;
    the scores agree with the CPU's plain path within chip_smoke's limits
    (f32 1e-4; bf16 2e-2; int8 4e-2, where an activation next to a
    rounding boundary takes the other int8 code on one machine).  A
    training step, refused before kernels 12 and 13 were ported, now runs
    each space block through kernel 11 and its backward, kernels 12 and
    13, and no kernel 1-10."""
    from devt_tpu_torch.ops.attention import quant_scope

    model = _vivit(kind, image_size=96, patch_size=4, dim=64, heads=2,
                   dim_head=32).eval()
    x = torch.randn(2, 2, 96, 96, 3, generator=torch.Generator()
                    .manual_seed(2))
    cpu = _vivit(kind, image_size=96, patch_size=4, dim=64, heads=2,
                 dim_head=32).cpu().eval()
    for scope, atol in ((torch.no_grad, 2e-2 if kind == "bf16" else 1e-4),
                        (quant_scope, 4e-2)):
        before = _flash_counts()
        with torch.no_grad(), scope():
            got = torch.sigmoid(model(x.cuda()).float()).cpu()
            want = torch.sigmoid(cpu(x).float())
        assert _delta(before) == [0, 0, 0, 0, 0, 0, 0, 2]
        torch.testing.assert_close(got, want, atol=atol, rtol=0)
    before, blocked = _flash_counts(), _blocked_bwd_counts()
    _vivit_step(model.train(), kind, 96)
    assert _delta(before) == [0] * 7 + [2]
    assert [a - b for a, b in zip(_blocked_bwd_counts(), blocked)] == [2, 2]


# ---------------------------------------------------------------------------
# the blockwise backward (kernels 12 and 13) and the ring hop (14 and 15)
# ---------------------------------------------------------------------------

def _blocked_bwd_counts():
    return (tfa.flash_attention.blocked_dq_launches,
            tfa.flash_attention.blocked_dkv_launches)


def _blocked_bwd_bodies():
    """Launches of kernels 12 and 13 by body: (12 wgmma, 12 streamed, 13
    wgmma, 13 streamed)."""
    fa = tfa.flash_attention
    return (fa.blocked_dq_wgmma_launches, fa.blocked_dq_streamed_launches,
            fa.blocked_dkv_wgmma_launches, fa.blocked_dkv_streamed_launches)


def _bwd_within(kind, tag, got, want):
    """Each gradient within BWD_ULPS of its plain version's largest
    element."""
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        err = (g.float() - w.float()).abs().max().item()
        bound = BWD_ULPS[kind] * EPS[kind] * w.float().abs().max().item()
        assert err <= bound, f"{kind} {tag} {name}: {err:.3e} > {bound:.3e}"


# (b, h, sq, skv, d, kv_len, strided): ViViT's 592 tokens as head views of
# a packed qkv, Sq != Skv, head dims 256 and 128 above one kv block
FLASH_BLOCKED_SHAPES = [
    (2, 3, 592, 592, 64, 577, True), (1, 2, 40, 300, 32, 290, False),
    (1, 1, 600, 600, 256, 577, False), (2, 2, 520, 520, 128, 519, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,sq,skv,d,kv_len,strided", FLASH_BLOCKED_SHAPES)
def test_flash_blocked_bwd_kernels_match_plain(card, kind, b, h, sq, skv, d,
                                               kv_len, strided):
    """Kernels 12 and 13 through ``flash_attention`` and autograd, one
    launch each, on the body ``blocked_bwd_on_wgmma`` names (bf16 at head
    dim 32 or 64 the wgmma bodies, f32 and head dims 128 and 256 the
    streamed one): dq, dk, dv against the plain backward on the forward's
    (o, lse) within the backward bound; keys past kv_len get exact zeros;
    two runs give the same bits."""
    q, k, v = _flash_inputs(kind, b, h, sq, skv, d, strided, sq + skv + d)
    do = torch.randn(b, h, sq, d, generator=torch.Generator().manual_seed(
        11)).to(DTYPE[kind]).cuda()

    def run():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o, lse = tfa.flash_attention(*leaves, kv_len=kv_len,
                                     return_lse=True)
        return (o.detach(), lse, *torch.autograd.grad(o, leaves, do))

    before, bodies = _blocked_bwd_counts(), _blocked_bwd_bodies()
    o, lse, *got = run()
    torch.cuda.synchronize()
    assert [a - b_ for a, b_ in zip(_blocked_bwd_counts(), before)] == [1, 1]
    wgmma = int(tfa.blocked_bwd_on_wgmma(DTYPE[kind], d))
    assert [a - b_ for a, b_ in zip(_blocked_bwd_bodies(), bodies)] == \
        [wgmma, 1 - wgmma] * 2
    want = tfa.flash_blocked_bwd_plain(q, k, v, o, lse, do, d ** -0.5,
                                       kv_len)
    _bwd_within(kind, f"({b},{h},{sq},{skv},{d})", got, want)
    for g in got[1:]:
        assert not g[:, :, kv_len:].any()
    again = run()[2:]
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


# (b, s, heads, d, live columns of the shard): the sequence-parallel
# bench's shape with its 197 live of 208, a partial and a wholly masked
# small shard, head dim 256
RING_SHAPES = [(4, 208, 3, 64, 197), (2, 48, 2, 16, 30), (2, 48, 2, 16, 0),
               (1, 160, 1, 256, 150)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,heads,d,live", RING_SHAPES)
def test_ring_step_kernels_match_plain(card, kind, b, s, heads, d, live):
    """Kernel 14 against its plain version (o at the forward gate, lse at
    1e-4 in f32 and the forward gate in bf16; a masked shard's o finite,
    its lse -1e30 + log S), and kernel 15 against its plain version on the
    global lse (the unmasked shard's): f32 dq and dkv within the backward
    bound, exact zeros for a masked shard, two runs bit-equal."""
    gen = torch.Generator().manual_seed(s + d + live)
    q = torch.randn(b, s, heads * d, generator=gen).to(DTYPE[kind]).cuda()
    kv = torch.randn(b, s, 2 * heads * d, generator=gen).to(
        DTYPE[kind]).cuda()
    do = torch.randn(b, s, heads * d, generator=gen).to(DTYPE[kind]).cuda()
    col = torch.arange(s, device="cuda")[None]
    mask = torch.where(col < live, 0.0, tfa.NEG_INF).float()
    full = torch.zeros(1, s, device="cuda")
    scale = d ** -0.5
    before = (tfa.ring_step_fwd.launches, tfa.ring_step_bwd.launches)
    o, lse = tfa.ring_step_fwd(q, kv, mask, heads=heads, scale=scale)
    wo, wlse = tfa.ring_step_fwd_plain(q, kv, mask, heads, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all()
    torch.testing.assert_close(o.float(), wo.float(), **TOL[kind])
    lse_tol = dict(atol=1e-4, rtol=1e-4) if kind == "f32" else TOL["bf16"]
    torch.testing.assert_close(lse, wlse, **lse_tol)
    og, lse_g = tfa.ring_step_fwd(q, kv, full, heads=heads, scale=scale)

    def bwd():
        return tfa.ring_step_bwd(q, kv, mask, og, lse_g, do, heads=heads,
                                 scale=scale)

    got = bwd()
    want = tfa.ring_step_bwd_plain(q, kv, mask, og, lse_g, do, heads, scale)
    torch.cuda.synchronize()
    assert (tfa.ring_step_fwd.launches, tfa.ring_step_bwd.launches) == (
        before[0] + 2, before[1] + 1)
    for name, g, w in zip(("dq", "dkv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        err = (g - w).abs().max().item()
        bound = BWD_ULPS[kind] * EPS[kind] * w.abs().max().item()
        assert err <= bound, f"{kind} {name}: {err:.3e} > {bound:.3e}"
    if live == 0:
        assert not got[0].any() and not got[1].any()
    assert all(torch.equal(a, b_) for a, b_ in zip(got, bwd()))


@pytest.mark.cuda
def test_one_rank_ring_runs_kernels_14_and_15(card):
    """``ring_mha_split`` with ``group=None`` under autograd: one launch of
    kernel 14 and one of kernel 15, and the CPU's plain path's output and
    gradients (f32: sums in other orders)."""
    from devt_tpu_torch.parallel.ring_attention import ring_mha_split

    gen = torch.Generator().manual_seed(3)
    q = torch.randn(2, 197, 3 * 64, generator=gen)
    kv = torch.randn(2, 197, 6 * 64, generator=gen)
    w = torch.randn(2, 197, 3 * 64, generator=gen)
    out = []
    for device in ("cuda", "cpu"):
        leaves = [t.to(device).requires_grad_(True) for t in (q, kv)]
        before = (tfa.ring_step_fwd.launches, tfa.ring_step_bwd.launches)
        o = ring_mha_split(*leaves, heads=3, kv_len=190)
        (o * w.to(device)).sum().backward()
        counts = (tfa.ring_step_fwd.launches - before[0],
                  tfa.ring_step_bwd.launches - before[1])
        assert counts == ((1, 1) if device == "cuda" else (0, 0))
        out.append([o.detach().cpu(), *(t.grad.cpu() for t in leaves)])
    for g, c in zip(*out):
        torch.testing.assert_close(g, c, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_vivit_at_image_384_trains_through_kernels_11_12_13(card):
    """ViViT at image 384 (577 space tokens; dim 192, depth 4, 3 heads of
    64, bf16; 2 frames) through make_train_step: 4 launches each of
    kernels 11, 12 and 13 and none of kernels 1-10; the gradients on 2
    clips against the CPU's plain path within chip_smoke's bf16 limit
    (5e-2 of each leaf's largest element)."""
    from devt_tpu_torch.config import Config
    from devt_tpu_torch.models.layers import DropoutRng
    from devt_tpu_torch.models.vivit import ViViT
    from devt_tpu_torch.parallel.train_step import make_train_step
    from devt_tpu_torch.train.optimizers import build_optimizer
    from devt_tpu_torch.train.state import TrainState
    from devt_tpu_torch.train.steps import forward_and_loss

    def vivit():
        return ViViT(image_size=384, patch_size=16, num_classes=19,
                     num_frames=2, dim=192, depth=4, heads=3, dim_head=64,
                     channels_last=True, dtype=torch.bfloat16).init_weights(
            torch.Generator().manual_seed(0))

    cfg = Config(model="vivit", precision="bf16", n_classes=19, frame_len=2)
    rng = np.random.default_rng(7)
    batch = {"vid": rng.standard_normal((2, 2, 384, 384, 3)).astype(
        np.float32), "label": (rng.random((2, 19)) < 0.3).astype(np.float32)}
    model = vivit().cuda()
    state = TrainState.create(dict(model.named_parameters()),
                              build_optimizer(cfg))
    before, blocked = _flash_counts(), _blocked_bwd_counts()
    bodies = _blocked_bwd_bodies()
    state, metrics = make_train_step(model, cfg)(state, batch, 0)
    torch.cuda.synchronize()
    assert _delta(before) == [0] * 7 + [4]
    assert [a - b for a, b in zip(_blocked_bwd_counts(), blocked)] == [4, 4]
    assert [a - b for a, b in zip(_blocked_bwd_bodies(), bodies)] == \
        [4, 0, 4, 0]
    assert torch.isfinite(metrics["loss"])

    grads = []
    for m, device in ((vivit().cuda(), "cuda"), (vivit(), "cpu")):
        params = dict(m.named_parameters())
        loss, _, _ = forward_and_loss(
            m, cfg, {"params": params},
            {k: torch.tensor(v, device=device) for k, v in batch.items()},
            DropoutRng(0), train=True)
        grads.append(dict(zip(params, torch.autograd.grad(
            loss, list(params.values())))))
    for name, c in grads[1].items():
        gap = (grads[0][name].float().cpu() - c.float()).abs().max().item()
        assert gap <= GRAD_RTOL * max(c.float().abs().max().item(), 1e-6), \
            f"{name}: {gap:.3e}"


# ---------------------------------------------------------------------------
# the one-shot forward on wgmma (csrc/flash_fwd_sm90.cuh): kernels 9, 14
# ---------------------------------------------------------------------------

# (live keys, S): kernel 9's kv_len and Sq = Skv, so the key counts around
# each compiled width (64, 128, 160, 208, 256) and its 16-key steps, S no
# multiple of 64, kv_len < Skv (16 of 40, 63 of 100, 255 of 300)
ONE_SHOT_KEYS = [(1, 1), (15, 15), (16, 40), (17, 17), (63, 100), (64, 64),
                 (65, 65), (197, 197), (208, 208), (255, 300), (256, 256)]


def _one_shot_counts():
    return (tfa.flash_attention.single_launches,
            tfa.flash_attention.single_wgmma_launches,
            tfa.flash_attention.single_streamed_launches,
            tfa.ring_step_fwd.launches, tfa.ring_step_fwd.wgmma_launches,
            tfa.ring_step_fwd.streamed_launches)


def _one_shot_delta(before):
    return [a - b for a, b in zip(_one_shot_counts(), before)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("keys,s", ONE_SHOT_KEYS)
def test_flash_one_shot_wgmma_matches_plain(card, keys, s, d):
    """Kernel 9 on the wgmma body, q, k, v the head views of one packed
    qkv: o at the bf16 forward gate and lse at the same limit against the
    plain version, one launch on that body, two runs bit-equal."""
    q, k, v = _flash_inputs("bf16", 2, 3, s, s, d, True, keys + d)
    assert tfa.one_shot_on_wgmma(torch.bfloat16, d, keys)
    before = _one_shot_counts()
    with torch.no_grad():
        o, lse = tfa.flash_attention(q, k, v, kv_len=keys, return_lse=True)
        o2, lse2 = tfa.flash_attention(q, k, v, kv_len=keys, return_lse=True)
    wo, wlse = tfa.flash_single_fwd_plain(q, k, v, d ** -0.5, keys)
    torch.cuda.synchronize()
    assert _one_shot_delta(before) == [2, 2, 0, 0, 0, 0]
    torch.testing.assert_close(o.float(), wo.float(), **TOL["bf16"])
    torch.testing.assert_close(lse, wlse, **TOL["bf16"])
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def _ring_mask(kind, s, seed):
    """(1, S) f32 column bias: 'partial' the first 3/4 live, 'masked' no
    live column, 'ragged' a random half live (not a prefix)."""
    col = torch.arange(s)[None]
    if kind == "partial":
        live = col < max(1, 3 * s // 4)
    elif kind == "masked":
        live = torch.zeros(1, s, dtype=torch.bool)
    else:
        live = torch.rand(1, s, generator=torch.Generator().manual_seed(
            seed)) < 0.5
    return torch.where(live, 0.0, tfa.NEG_INF).float().cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("d,mask_kind", [(64, "partial"), (64, "masked"),
                                         (64, "ragged"), (32, "ragged"),
                                         (16, "partial")])
@pytest.mark.parametrize("s", [keys for keys, _ in ONE_SHOT_KEYS])
def test_ring_one_shot_wgmma_matches_plain(card, s, d, mask_kind):
    """Kernel 14 on the wgmma body (the shard's S as its key count) with a
    partial, a wholly masked and a ragged mask: o finite and at the bf16
    forward gate, lse at the same limit (a masked shard's lse -1e30 +
    log S), one launch on that body, two runs bit-equal."""
    heads = 2
    gen = torch.Generator().manual_seed(s + d)
    q = torch.randn(2, s, heads * d, generator=gen).to(torch.bfloat16).cuda()
    kv = torch.randn(2, s, 2 * heads * d, generator=gen).to(
        torch.bfloat16).cuda()
    mask = _ring_mask(mask_kind, s, s + d)
    before = _one_shot_counts()
    o, lse = tfa.ring_step_fwd(q, kv, mask, heads=heads, scale=d ** -0.5)
    o2, lse2 = tfa.ring_step_fwd(q, kv, mask, heads=heads, scale=d ** -0.5)
    wo, wlse = tfa.ring_step_fwd_plain(q, kv, mask, heads, d ** -0.5)
    torch.cuda.synchronize()
    assert _one_shot_delta(before) == [0, 0, 0, 2, 2, 0]
    assert torch.isfinite(o.float()).all()
    torch.testing.assert_close(o.float(), wo.float(), **TOL["bf16"])
    torch.testing.assert_close(lse, wlse, **TOL["bf16"])
    if mask_kind == "masked":
        assert torch.equal(lse, torch.full_like(lse, tfa.NEG_INF)
                           + torch.log(torch.tensor(float(s))))
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["flash", "ring"])
def test_one_shot_writes_no_row_past_sq(card, which):
    """The wgmma body writes o and lse for rows < Sq only: canaries after
    the last sequence's last row stay as they were (S = 197: the last
    query tile holds 5 rows, 59 past the end)."""
    lib_name, declare = (("flash_fwd", tfa._declare_flash_fwd)
                         if which == "flash" else
                         ("ring_step", tfa._declare_ring))
    lib = _build.load(lib_name, declare)
    b, h, s, d = 2, 3, 197, 64
    gen = torch.Generator().manual_seed(5)
    spare = 64 * h * d
    o_buf = torch.full((b * s * h * d + spare,), 7.0,
                       dtype=torch.bfloat16, device="cuda")
    l_buf = torch.full((b * h * s + 64 * h,), 7.0, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    if which == "flash":
        q, k, v = _flash_inputs("bf16", b, h, s, s, d, True, 11)
        strides = (ctypes.c_longlong * 9)(
            *(t.stride(i) for t in (q, k, v) for i in range(3)))
        rc = lib.devt_flash_fwd(1, 0, q.data_ptr(), k.data_ptr(),
                                v.data_ptr(), o_buf.data_ptr(),
                                l_buf.data_ptr(), b, h, s, s, d, s, strides,
                                ctypes.c_float(d ** -0.5),
                                ctypes.c_void_p(stream))
        want_o, want_l = tfa.flash_single_fwd_plain(q, k, v, d ** -0.5, s)
        got_o = o_buf[:b * h * s * d].view(b, h, s, d)
        got_l = l_buf[:b * h * s].view(b * h, s)
    else:
        q = torch.randn(b, s, h * d, generator=gen).to(torch.bfloat16).cuda()
        kv = torch.randn(b, s, 2 * h * d, generator=gen).to(
            torch.bfloat16).cuda()
        mask = torch.zeros(1, s, device="cuda")
        rc = lib.devt_ring_step_fwd(1, q.data_ptr(), kv.data_ptr(),
                                    mask.data_ptr(), o_buf.data_ptr(),
                                    l_buf.data_ptr(), b, s, h, d,
                                    ctypes.c_float(d ** -0.5),
                                    ctypes.c_void_p(stream))
        want_o, want_l = tfa.ring_step_fwd_plain(q, kv, mask, h, d ** -0.5)
        got_o = o_buf[:b * s * h * d].view(b, s, h * d)
        got_l = l_buf[:b * s * h].view(b, s, h)
    torch.cuda.synchronize()
    assert rc == 0
    assert tfa.one_shot_on_wgmma(torch.bfloat16, d, s)
    torch.testing.assert_close(got_o.float(), want_o.float(), **TOL["bf16"])
    torch.testing.assert_close(got_l, want_l, **TOL["bf16"])
    assert torch.equal(o_buf[b * s * h * d:],
                       torch.full((spare,), 7.0, dtype=torch.bfloat16,
                                  device="cuda"))
    assert torch.equal(l_buf[b * h * s:], torch.full((64 * h,), 7.0,
                                                     device="cuda"))


@pytest.mark.cuda
def test_every_flash_and_ring_shape_takes_the_routed_body(card):
    """The C entries' rule (devt_one_shot_route) is the Python predicate's
    over every head dim and key count; each single-block shape of
    FLASH_SHAPES and each of RING_SHAPES, in both dtypes, launches the body
    that one_shot_on_wgmma names, counted per body."""
    lib = _build.load("flash_fwd", tfa._declare_flash_fwd)
    for dtype, code in tfa._DTYPE_CODE.items():
        for d in (8, 16, 32, 48, 64, 128, 256):
            for keys in (0, 1, 16, 100, 208, 256, 257, 512):
                assert bool(lib.devt_one_shot_route(code, d, keys)) == \
                    tfa.one_shot_on_wgmma(dtype, d, keys), (dtype, d, keys)
    for kind in ("f32", "bf16"):
        for b, h, sq, skv, d, kv_len, strided in FLASH_SHAPES:
            if not (sq == skv and tfa.fits_single_block(sq)):
                continue
            q, k, v = _flash_inputs(kind, b, h, sq, skv, d, strided)
            wgmma = tfa.one_shot_on_wgmma(DTYPE[kind], d, kv_len)
            before = _one_shot_counts()
            with torch.no_grad():
                tfa.flash_attention(q, k, v, kv_len=kv_len)
            assert _one_shot_delta(before) == [1, int(wgmma),
                                               int(not wgmma), 0, 0, 0]
        for b, s, heads, d, live in RING_SHAPES:
            q = torch.randn(b, s, heads * d, device="cuda").to(DTYPE[kind])
            kv = torch.randn(b, s, 2 * heads * d, device="cuda").to(
                DTYPE[kind])
            mask = torch.zeros(1, s, device="cuda")
            wgmma = tfa.one_shot_on_wgmma(DTYPE[kind], d, s)
            before = _one_shot_counts()
            tfa.ring_step_fwd(q, kv, mask, heads=heads, scale=d ** -0.5)
            assert _one_shot_delta(before) == [0, 0, 0, 1, int(wgmma),
                                               int(not wgmma)]
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the online forward on wgmma (csrc/flash_fwd_sm90.cuh): kernel 11
# ---------------------------------------------------------------------------

# (b, h, sq, skv, d, kv_len, strided): the image-384 shape on the head
# views of a packed qkv (592 tokens, 577 live), kv_len at and around the
# 128-key tile (1, 128, 129) above one kv block, Sq != Skv (40 queries
# against 300 keys), a single query, head dims 16 and 32
ONLINE_SHAPES = [
    (2, 3, 592, 592, 64, 577, True), (1, 2, 600, 600, 64, 1, False),
    (1, 2, 600, 600, 64, 128, True), (1, 2, 600, 600, 64, 129, False),
    (2, 3, 40, 300, 64, 290, False), (2, 2, 1, 300, 64, 300, False),
    (1, 2, 530, 530, 32, 530, True), (2, 1, 70, 257, 16, 200, False)]


def _online_counts():
    fa = tfa.flash_attention
    return (fa.blocked_launches, fa.blocked_wgmma_launches,
            fa.blocked_streamed_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,skv,d,kv_len,strided", ONLINE_SHAPES)
def test_flash_online_wgmma_matches_plain(card, b, h, sq, skv, d, kv_len,
                                          strided):
    """Kernel 11 on the wgmma body: o at the bf16 forward gate and lse at
    1e-4 against the plain version (the same 128-key blocks), one launch
    on that body, two runs bit-equal."""
    q, k, v = _flash_inputs("bf16", b, h, sq, skv, d, strided, sq + kv_len)
    assert tfa.online_on_wgmma(torch.bfloat16, d)
    assert not (sq == skv and tfa.fits_single_block(sq))
    before = _online_counts()
    with torch.no_grad():
        o, lse = tfa.flash_attention(q, k, v, kv_len=kv_len, return_lse=True)
        o2, lse2 = tfa.flash_attention(q, k, v, kv_len=kv_len,
                                       return_lse=True)
    wo, wlse = tfa.flash_blocked_fwd_plain(q, k, v, d ** -0.5, kv_len)
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(_online_counts(), before)] == [2, 2, 0]
    assert o.shape == (b, h, sq, d) and torch.isfinite(o.float()).all()
    torch.testing.assert_close(o.float(), wo.float(), **TOL["bf16"])
    torch.testing.assert_close(lse, wlse, atol=1e-4, rtol=1e-4)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
def test_online_wgmma_writes_no_row_past_sq(card):
    """The online body writes o and lse for rows < Sq only (Sq = 530: the
    last query tile holds 18 rows, 46 past the end): canaries after the
    last sequence's last row stay as they were."""
    lib = _build.load("flash_fwd", tfa._declare_flash_fwd)
    b, h, sq, skv, d = 2, 2, 530, 600, 64
    q, k, v = _flash_inputs("bf16", b, h, sq, skv, d, False, 12)
    spare = 128 * d
    o_buf = torch.full((b * h * sq * d + spare,), 7.0, dtype=torch.bfloat16,
                       device="cuda")
    l_buf = torch.full((b * h * sq + 128,), 7.0, device="cuda")
    strides = (ctypes.c_longlong * 9)(
        *(t.stride(i) for t in (q, k, v) for i in range(3)))
    rc = lib.devt_flash_fwd(1, 1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o_buf.data_ptr(), l_buf.data_ptr(), b, h, sq,
                            skv, d, 580, strides, ctypes.c_float(d ** -0.5),
                            ctypes.c_void_p(
                                torch.cuda.current_stream().cuda_stream))
    want_o, want_l = tfa.flash_blocked_fwd_plain(q, k, v, d ** -0.5, 580)
    torch.cuda.synchronize()
    assert rc == 0
    torch.testing.assert_close(
        o_buf[:b * h * sq * d].view(b, h, sq, d).float(), want_o.float(),
        **TOL["bf16"])
    torch.testing.assert_close(l_buf[:b * h * sq].view(b * h, sq), want_l,
                               atol=1e-4, rtol=1e-4)
    assert torch.equal(o_buf[b * h * sq * d:],
                       torch.full((spare,), 7.0, dtype=torch.bfloat16,
                                  device="cuda"))
    assert torch.equal(l_buf[b * h * sq:], torch.full((128,), 7.0,
                                                      device="cuda"))


# ---------------------------------------------------------------------------
# the fused int8 matmul on int8 wgmma (csrc/gemm_s8_sm90.cuh): kernel 6
# ---------------------------------------------------------------------------


def _int8_operands(kind, m, k, n, seed):
    """x (M, K) on the card with an all-zero row, and the weight codes of
    a (K, N) weight both ways: K-major (the site registry's layout) and
    row-major."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(m, k, generator=gen)).to(DTYPE[kind]).cuda()
    x[min(3, m - 1)] = 0.0
    w = (torch.randn(k, n, generator=gen) * k ** -0.5).cuda()
    w_q, w_s = tq.quantize_weight(w.to(DTYPE[kind]))
    return x, w_q.t().contiguous().t(), w_q.contiguous(), w_s


@pytest.mark.cuda
@pytest.mark.parametrize("kind,m,k,n", [
    ("bf16", 3584, 2048, 6144), ("bf16", 3584, 2048, 2048),
    ("bf16", 1, 2048, 2048), ("bf16", 65, 2048, 2048),
    ("bf16", 3585, 2048, 2048), ("bf16", 300, 2048, 640),
    ("bf16", 100, 576, 192), ("f32", 257, 512, 768)])
def test_int8_matmul_wgmma_bit_equal_to_plain(card, kind, m, k, n):
    """K-major codes take the wgmma body and row-major ones the mma.sync
    body; both are bit-equal to the plain version (exact int32 sums, the
    same dequantize), ragged M, K not a multiple of the 128-byte k step,
    and N not a multiple of the 256-column tile included."""
    x, kmajor, rowmajor, w_s = _int8_operands(kind, m, k, n, m + n)
    assert tq.int8_matmul_on_wgmma(kmajor)
    assert not tq.int8_matmul_on_wgmma(rowmajor)
    f = tq.int8_matmul_fused
    before = (f.launches, f.wgmma_launches, f.mma_sync_launches)
    got = f(x, kmajor, w_s)
    again = f(x, kmajor, w_s)
    old = f(x, rowmajor, w_s)
    want = tq.int8_matmul_fused_plain(x, rowmajor, w_s)
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(
        (f.launches, f.wgmma_launches, f.mma_sync_launches), before)] == [
        3, 2, 1]
    assert got.dtype == x.dtype and got.shape == (m, n)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()
    assert torch.equal(got, again) and torch.equal(old, want)
    assert torch.equal(tq.int8_matmul_fused_plain(x, kmajor, w_s), want)


@pytest.mark.cuda
def test_int8_and_online_routes_match_the_c_rules(card):
    """The C entries' rules (devt_int8_matmul_route, devt_online_route) are
    the Python predicates'."""
    lib = _build.load("int8_matmul", tq._declare_matmul)
    w = torch.zeros(128, 64, dtype=torch.int8)
    for codes in (w, w.t().contiguous().t()):
        kmajor = tq.int8_matmul_on_wgmma(codes)
        assert bool(lib.devt_int8_matmul_route(int(kmajor))) == kmajor
    flib = _build.load("flash_fwd", tfa._declare_flash_fwd)
    for dtype, code in tfa._DTYPE_CODE.items():
        for d in (8, 16, 32, 48, 64, 128, 256):
            assert bool(flib.devt_online_route(code, d)) == \
                tfa.online_on_wgmma(dtype, d), (dtype, d)


# ---------------------------------------------------------------------------
# the blockwise backward on wgmma (csrc/flash_bwd_sm90.cuh): kernels 12, 13
# ---------------------------------------------------------------------------

# (b, h, sq, skv, kv_len, strided) at each head dim of the rule: ViViT at
# image 384 on the head views of a packed qkv (1536 sequences at head dim
# 64, the main path's shape), Sq != Skv ragged, Sq shorter than one query
# tile (20, and a single query), kv_len = 1
BLOCKED_WGMMA_SHAPES = [
    (512, 3, 592, 592, 577, True), (2, 3, 40, 300, 290, False),
    (2, 2, 20, 300, 250, False), (1, 2, 1, 130, 130, False),
    (1, 2, 600, 600, 1, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("b,h,sq,skv,kv_len,strided", BLOCKED_WGMMA_SHAPES)
def test_flash_blocked_bwd_wgmma_matches_plain(card, b, h, sq, skv, kv_len,
                                               strided, d):
    """Kernels 12 and 13 on their wgmma bodies, through
    ``flash_attention`` and autograd: one launch of each on that body; dq,
    dk, dv within 4 bf16 ulps of the plain backward's largest element on
    the forward's (o, lse); dk and dv past kv_len exact zeros; two runs
    bit-equal."""
    if not strided or d != 64:
        b = min(b, 2)
    q, k, v = _flash_inputs("bf16", b, h, sq, skv, d, strided, sq + kv_len)
    do = torch.randn(b, h, sq, d, generator=torch.Generator().manual_seed(
        13)).to(torch.bfloat16).cuda()
    assert tfa.blocked_bwd_on_wgmma(torch.bfloat16, d)
    assert not (sq == skv and tfa.fits_single_block(sq))

    def run():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o, lse = tfa.flash_attention(*leaves, kv_len=kv_len,
                                     return_lse=True)
        return (o.detach(), lse, *torch.autograd.grad(o, leaves, do))

    bodies = _blocked_bwd_bodies()
    o, lse, *got = run()
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(_blocked_bwd_bodies(), bodies)] == \
        [1, 0, 1, 0]
    want = tfa.flash_blocked_bwd_plain(q, k, v, o, lse, do, d ** -0.5,
                                       kv_len)
    for g in got:
        assert torch.isfinite(g.float()).all()
    tag = f"({b},{h},{sq},{skv},{d}) kv_len {kv_len}"
    if kv_len == 1:
        _one_key_noise(tag, q, k, v, do, d ** -0.5, got, want)
    else:
        _bwd_within("bf16", tag, got, want)
    for g in got[1:]:
        assert not g[:, :, kv_len:].any()
    again = run()[2:]
    assert all(torch.equal(a, c) for a, c in zip(got, again))


def _one_key_noise(tag, q, k, v, do, scale, got, want):
    """kv_len = 1: p = 1, o = v[0] and dp = delta = do . v[0], so ds, dq
    and dk are zero in exact arithmetic, and what both the kernel and the
    plain version give is the rounding of two f32 sums of d products each,
    in different orders (the plain version's own largest dq is that
    noise, so 4 ulps of it is no bound).  dv = the sum of do over the
    queries is held to the gate; dq and dk to the f32 error bound of those
    sums, d ulps (2^-23) of sum |do_i v_i| per score, times scale, carried
    through k[0] into dq and through q into dk."""
    d = q.shape[-1]
    v0, k0 = v[:, :, :1].float().abs(), k[:, :, :1].float().abs()
    noise = scale * d * 2.0 ** -22 * (do.float().abs() @ v0.transpose(-1, -2))
    bounds = ((noise * k0).amax().item(),
              (noise.transpose(-1, -2) @ q.float().abs()).amax().item())
    for name, g, bound in zip(("dq", "dk"), got[:2], bounds):
        err = g.float().abs().max().item()
        assert err <= bound, f"bf16 {tag} {name}: {err:.3e} > {bound:.3e}"
    g, w = got[2].float(), want[2].float()
    err = (g - w).abs().max().item()
    bound = BWD_ULPS["bf16"] * EPS["bf16"] * w.abs().max().item()
    assert err <= bound, f"bf16 {tag} dv: {err:.3e} > {bound:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64])
def test_blocked_bwd_wgmma_writes_no_row_past_the_end(card, d):
    """The wgmma bodies write dq for rows < Sq and dk, dv for rows < Skv
    only (Sq = 530: the last 64-query block holds 18 rows; Skv = 600: the
    last 64-key block 24): canaries after the last sequence's last row of
    larger output buffers stay as they were, and delta is written for
    every query row."""
    lib = _build.load("flash_bwd", tfa._declare_flash_bwd)
    b, h, sq, skv, kv_len = 2, 2, 530, 600, 580
    q, k, v = _flash_inputs("bf16", b, h, sq, skv, d, False, 21)
    do = torch.randn(b, h, sq, d, generator=torch.Generator().manual_seed(
        22)).to(torch.bfloat16).cuda()
    scale = d ** -0.5
    with torch.no_grad():
        o, lse = tfa.flash_attention(q, k, v, kv_len=kv_len, return_lse=True)
    spare = 128 * d
    seven = torch.full((spare,), 7.0, dtype=torch.bfloat16, device="cuda")
    bufs = {name: torch.full((b * h * n * d + spare,), 7.0,
                             dtype=torch.bfloat16, device="cuda")
            for name, n in (("dq", sq), ("dk", skv), ("dv", skv))}
    delta = torch.full((b * h * sq + 128,), 7.0, device="cuda")
    strides = (ctypes.c_longlong * 9)(
        *(t.stride(i) for t in (q, k, v) for i in range(3)))
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for part in (1, 2):
        rc = lib.devt_flash_blocked_bwd(
            1, part, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            bufs["dq"].data_ptr(), bufs["dk"].data_ptr(),
            bufs["dv"].data_ptr(), b, h, sq, skv, d, kv_len, strides,
            ctypes.c_float(scale), stream)
        assert rc == 0, rc
    want = tfa.flash_blocked_bwd_plain(q, k, v, o, lse, do, scale, kv_len)
    torch.cuda.synchronize()
    got = [bufs[name][:b * h * n * d].view(b, h, n, d)
           for name, n in (("dq", sq), ("dk", skv), ("dv", skv))]
    _bwd_within("bf16", f"canaries d={d}", got, want)
    for name in bufs:
        assert torch.equal(bufs[name][-spare:], seven), name
    torch.testing.assert_close(
        delta[:b * h * sq].view(b * h, sq),
        (do.float() * o.float()).sum(-1).view(b * h, sq), atol=1e-4,
        rtol=1e-4)
    assert torch.equal(delta[b * h * sq:], torch.full((128,), 7.0,
                                                      device="cuda"))


# (b, h, s, kv_len, strided): kernel 10 on the wgmma bodies at Sq == Skv:
# the main path's (1536, 197, 64) on the head views of a packed qkv, one
# query (kv_len 1), lengths around the 64-row tiles, up to 512
SINGLE_BWD_WGMMA_SHAPES = [
    (512, 3, 197, 197, True), (2, 2, 1, 1, False), (2, 3, 63, 50, True),
    (2, 2, 256, 200, False), (2, 3, 333, 333, True), (1, 2, 512, 500, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("b,h,s,kv_len,strided", SINGLE_BWD_WGMMA_SHAPES)
def test_flash_single_bwd_wgmma_matches_plain(card, b, h, s, kv_len,
                                              strided, d):
    """Kernel 10 on kernels 12's and 13's wgmma bodies, through
    ``flash_attention`` and autograd: one launch counted on that body and
    none of kernels 12 and 13; dq, dk, dv within 4 bf16 ulps of the plain
    single backward's largest element on the forward's (o, lse) (at
    kv_len = 1, dq and dk to the f32 error bound of the sums that cancel
    there); dk and dv past kv_len exact zeros; two runs bit-equal."""
    if not strided or d != 64:
        b = min(b, 2)
    q, k, v = _flash_inputs("bf16", b, h, s, s, d, strided, s + kv_len + d)
    do = torch.randn(b, h, s, d, generator=torch.Generator().manual_seed(
        17)).to(torch.bfloat16).cuda()
    assert tfa.blocked_bwd_on_wgmma(torch.bfloat16, d)
    assert tfa.fits_single_block(s)

    def run():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o, lse = tfa.flash_attention(*leaves, kv_len=kv_len,
                                     return_lse=True)
        return (o.detach(), lse, *torch.autograd.grad(o, leaves, do))

    bodies, blocked = _single_bwd_bodies(), _blocked_bwd_counts()
    o, lse, *got = run()
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(_single_bwd_bodies(), bodies)] == [1, 0]
    assert _blocked_bwd_counts() == blocked
    want = tfa.flash_single_bwd_plain(q, k, v, o, lse, do, d ** -0.5, kv_len)
    for g in got:
        assert torch.isfinite(g.float()).all()
    tag = f"kernel 10 ({b},{h},{s},{d}) kv_len {kv_len}"
    if kv_len == 1:
        _one_key_noise(tag, q, k, v, do, d ** -0.5, got, want)
    else:
        _bwd_within("bf16", tag, got, want)
    for g in got[1:]:
        assert not g[:, :, kv_len:].any()
    again = run()[2:]
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.cuda
def test_blocked_bwd_route_matches_the_c_rule(card):
    """The C entry's rule (devt_blocked_bwd_route) is the Python
    predicate's."""
    lib = _build.load("flash_bwd", tfa._declare_flash_bwd)
    for dtype, code in tfa._DTYPE_CODE.items():
        for d in (8, 16, 32, 48, 64, 128, 256):
            assert bool(lib.devt_blocked_bwd_route(code, d)) == \
                tfa.blocked_bwd_on_wgmma(dtype, d), (dtype, d)


# ---------------------------------------------------------------------------
# kernel 3 on wgmma (csrc/mha_fwd_sm90.cuh, and kernel 9's one-shot
# instance) and kernel 15 on kernels 12's and 13's wgmma bodies
# ---------------------------------------------------------------------------

def _mha_bodies():
    m = tfa.fused_mha
    return (m.packed_launches, m.one_shot_launches, m.streamed_launches)


def _mha_qkv(b, s, heads, d, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(b, s, 3 * heads * d, generator=gen).to(
        torch.bfloat16).cuda()


def _mha_on_its_body(b, s, heads, d, kv_len, body):
    """fused_mha forward at (b, s, heads, d) bf16: one launch on ``body``;
    o within the forward gate and lse within 1e-4 of the plain version; a
    rerun bit-equal."""
    assert tfa.mha_fwd_on_wgmma(torch.bfloat16, d, s, kv_len, 0.0) == body
    qkv = _mha_qkv(b, s, heads, d, b + s + d + kv_len)
    before, bodies = tfa.fused_mha.launches, _mha_bodies()
    with torch.no_grad():
        o, lse = tfa.fused_mha(qkv, heads=heads, kv_len=kv_len,
                               return_lse=True)
        again = tfa.fused_mha(qkv, heads=heads, kv_len=kv_len,
                              return_lse=True)
    wo, wlse = tfa.fused_mha_plain(qkv, heads, d ** -0.5, kv_len)
    torch.cuda.synchronize()
    want = {"packed": (2, 0, 0), "one_shot": (0, 2, 0)}[body]
    assert tfa.fused_mha.launches == before + 2
    assert tuple(a - c for a, c in zip(_mha_bodies(), bodies)) == want
    assert o.shape == (b, s, heads * d) and lse.shape == (b, s, heads)
    torch.testing.assert_close(o.float(), wo.float(), **TOL["bf16"])
    torch.testing.assert_close(lse, wlse, atol=1e-4, rtol=1e-4)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


# (b, s, heads, d, kv_len): PTN serving (S = 14 unpadded, the padded 16),
# kv_len < S, a partial last group (255 = 63 * 4 + 3), S = 1 (64
# sequences a tile), 33 and 64 (one a tile), head dim 128
MHA_PACKED_SHAPES = [
    (256, 14, 8, 256, 14), (256, 14, 8, 256, 13), (256, 16, 8, 256, 14),
    (255, 14, 8, 256, 14), (130, 1, 2, 256, 1), (7, 33, 2, 256, 30),
    (5, 64, 2, 256, 64), (9, 14, 4, 128, 14), (3, 64, 2, 128, 50)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,heads,d,kv_len", MHA_PACKED_SHAPES)
def test_mha_packed_wgmma_matches_plain(card, b, s, heads, d, kv_len):
    """Kernel 3 on the packed body (64 // S sequences of a head to a
    tile): o and lse against the plain version, a rerun bit-equal, one
    launch on that body."""
    _mha_on_its_body(b, s, heads, d, kv_len, "packed")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,heads,d,kv_len", [
    (512, 208, 3, 64, 197), (6, 48, 2, 16, 37), (5, 100, 3, 32, 100),
    (2, 300, 2, 64, 256)])
def test_mha_one_shot_route_matches_plain(card, b, s, heads, d, kv_len):
    """Kernel 3 at head dims 16-64 with at most 256 live keys on kernel 9's
    one-shot wgmma instance (the ViT shape first)."""
    _mha_on_its_body(b, s, heads, d, kv_len, "one_shot")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,heads,d", [(255, 14, 8, 256), (3, 33, 2, 128),
                                         (2, 208, 3, 64)])
def test_mha_wgmma_routes_write_only_their_rows(card, b, s, heads, d):
    """The C entry on buffers with canaries past B S rows of o and lse (a
    partial last group of the packed body; a 33-token tile; the one-shot
    route): every row of o and lse written with the plain version's
    values, every canary untouched."""
    lib = _build.load("mha_fwd", tfa._declare_fwd)
    qkv = _mha_qkv(b, s, heads, d, 21)
    hd, spare = heads * d, 64
    o_buf = torch.full(((b * s + spare) * hd,), float("nan"),
                       dtype=torch.bfloat16, device="cuda")
    l_buf = torch.full(((b * s + spare) * heads,), float("nan"),
                       device="cuda")
    rc = lib.devt_mha_fwd(1, qkv.data_ptr(), o_buf.data_ptr(),
                          l_buf.data_ptr(), b, s, heads, d, s,
                          ctypes.c_float(d ** -0.5), ctypes.c_double(0.0),
                          ctypes.c_ulonglong(0),
                          ctypes.c_void_p(torch.cuda.current_stream()
                                          .cuda_stream))
    torch.cuda.synchronize()
    assert rc == 0
    wo, wlse = tfa.fused_mha_plain(qkv, heads, d ** -0.5, s)
    got_o = o_buf[:b * s * hd].view(b, s, hd)
    got_l = l_buf[:b * s * heads].view(b, s, heads)
    torch.testing.assert_close(got_o.float(), wo.float(), **TOL["bf16"])
    torch.testing.assert_close(got_l, wlse, atol=1e-4, rtol=1e-4)
    assert o_buf[b * s * hd:].isnan().all()
    assert l_buf[b * s * heads:].isnan().all()


@pytest.mark.cuda
def test_mha_dropout_and_f32_stay_streamed(card):
    """At PTN's shape, dropout and float run the streamed body, counted."""
    qkv = _mha_qkv(4, 14, 2, 256, 3)
    bodies = _mha_bodies()
    with torch.no_grad():
        tfa.fused_mha(qkv, heads=2, dropout_rate=0.5, seed=7)
        tfa.fused_mha(qkv.float(), heads=2)
    torch.cuda.synchronize()
    assert tuple(a - c for a, c in zip(_mha_bodies(), bodies)) == (0, 0, 2)


# (b, s, heads, d, live columns of the shard): the sequence-parallel
# bench's shape with 197 live of 208 (fewer sequences), a wholly masked
# shard, S = 1, S = 100 (no multiple of the 64-row tiles), head dims 16, 32
RING_WGMMA_SHAPES = [(64, 208, 3, 64, 197), (4, 208, 3, 64, 0),
                     (8, 1, 2, 64, 1), (3, 100, 2, 64, 90),
                     (3, 100, 2, 16, 100), (3, 160, 2, 32, 150)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,heads,d,live", RING_WGMMA_SHAPES)
def test_ring_bwd_wgmma_matches_plain(card, b, s, heads, d, live):
    """Kernel 15 in bf16 at head dims 16-64 on kernels 12's and 13's wgmma
    bodies (two launches, counted as one call on that body): f32 dq and
    dkv within 4 bf16 ulps of the plain version's largest element on the
    global lse of the full shard (at S = 1 a single key makes dq and dk
    zero in exact arithmetic: they are held to the f32 error bound of the
    cancelling sums, as at kv_len 1 above, and dv to the 4 ulps); a wholly
    masked shard's exact zeros; two runs bit-equal."""
    gen = torch.Generator().manual_seed(s + d + live)
    q, do = (torch.randn(b, s, heads * d, generator=gen).to(
        torch.bfloat16).cuda() for _ in range(2))
    kv = torch.randn(b, s, 2 * heads * d, generator=gen).to(
        torch.bfloat16).cuda()
    col = torch.arange(s, device="cuda")[None]
    mask = torch.where(col < live, 0.0, tfa.NEG_INF).float()
    scale = d ** -0.5
    o, lse = tfa.ring_step_fwd(q, kv, torch.zeros(1, s, device="cuda"),
                               heads=heads, scale=scale)
    assert tfa.blocked_bwd_on_wgmma(torch.bfloat16, d)
    r = tfa.ring_step_bwd
    before = (r.launches, r.wgmma_launches, r.streamed_launches)

    def bwd():
        return tfa.ring_step_bwd(q, kv, mask, o, lse, do, heads=heads,
                                 scale=scale)

    got = bwd()
    want = tfa.ring_step_bwd_plain(q, kv, mask, o, lse, do, heads, scale)
    torch.cuda.synchronize()
    assert (r.launches - before[0], r.wgmma_launches - before[1],
            r.streamed_launches - before[2]) == (1, 1, 0)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.isfinite(g).all()
    if s == 1:
        # one key: dq and dk are the noise of cancelling sums on both sides
        hd = heads * d

        def split(t, off=0):
            return t[..., off:off + hd].reshape(b, s, heads, d).transpose(1, 2)

        _one_key_noise(f"ring ({b},{s},{heads},{d})", split(q), split(kv),
                       split(kv, hd), split(do), scale,
                       [split(got[0]), split(got[1]), split(got[1], hd)],
                       [None, None, split(want[1], hd)])
    else:
        for name, g, w in zip(("dq", "dkv"), got, want):
            err = (g - w).abs().max().item()
            bound = BWD_ULPS["bf16"] * EPS["bf16"] * w.abs().max().item()
            assert err <= bound, f"{name}: {err:.3e} > {bound:.3e}"
    if live == 0:
        assert not got[0].any() and not got[1].any()
    assert all(torch.equal(a, c) for a, c in zip(got, bwd()))


@pytest.mark.cuda
def test_mha_and_ring_bwd_routes_match_the_c_rules(card):
    """The C entries' rules (devt_mha_fwd_route, devt_ring_bwd_route) are
    the Python mirrors'."""
    lib = _build.load("mha_fwd", tfa._declare_fwd)
    rlib = _build.load("ring_step", tfa._declare_ring)
    for dtype, code in tfa._DTYPE_CODE.items():
        for d in (8, 16, 32, 48, 64, 128, 256):
            assert bool(rlib.devt_ring_bwd_route(code, d)) == \
                tfa.blocked_bwd_on_wgmma(dtype, d), (dtype, d)
            for s in (1, 14, 16, 33, 64, 65, 208, 257, 512):
                for kv_len in sorted({1, min(s, 197), min(s, 256), s}):
                    for rate in (0.0, 0.5):
                        got = tfa._MHA_BODIES[lib.devt_mha_fwd_route(
                            code, d, s, kv_len, ctypes.c_double(rate))]
                        assert got == tfa.mha_fwd_on_wgmma(
                            dtype, d, s, kv_len, rate), (dtype, d, s, kv_len,
                                                         rate)


# kernel 4 on its wgmma routes: the packed body (bf16, head dim 128 / 256,
# S <= 64) at PTN training's shape and the packing's edges (S = 1, 13, 14,
# 16, 33, 64; B no multiple of the sequences a tile; kv_len < S), kernels
# 12's and 13's bodies (bf16, head dim 16-64) at the MoE blocks' shape and
# lengths past one 64-row tile
MHA_BWD_WGMMA_SHAPES = [
    ("packed", 32, 14, 8, 256, 14), ("packed", 7, 14, 2, 256, 11),
    ("packed", 5, 1, 2, 128, 1), ("packed", 130, 1, 1, 256, 1),
    ("packed", 9, 13, 2, 128, 13), ("packed", 6, 16, 2, 256, 9),
    ("packed", 5, 33, 2, 128, 30), ("packed", 3, 64, 2, 256, 64),
    ("packed", 2, 64, 1, 128, 40),
    ("wgmma", 512, 208, 3, 64, 197), ("wgmma", 3, 65, 2, 32, 65),
    ("wgmma", 2, 100, 2, 16, 77), ("wgmma", 4, 14, 2, 64, 14),
    ("wgmma", 2, 512, 1, 64, 509)]


def _mha_bwd_bodies():
    """Kernel 4's calls, then its calls by body in _MHA_BWD_BODIES' order."""
    m = tfa.fused_mha
    return (m.bwd_launches,
            *(getattr(m, f"bwd_{body}_launches")
              for body in tfa._MHA_BWD_BODIES))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, MHA_RATE])
@pytest.mark.parametrize("body,b,s,heads,d,kv_len", MHA_BWD_WGMMA_SHAPES)
def test_mha_bwd_wgmma_routes_match_plain(card, body, b, s, heads, d, kv_len,
                                          rate):
    """Kernel 4 on the body its rule names, from the kernel forward's (o,
    lse), against the plain backward given the mask the library exports:
    one call counted on that body, dq, dk, dv within 4 bf16 ulps of each
    tensor's largest element, keys past kv_len exact zeros, two runs
    bit-equal."""
    seed = 515
    assert tfa.mha_bwd_on_wgmma(torch.bfloat16, d, s, kv_len, rate) == body
    qkv, do = _mha_inputs("bf16", b, s, heads, d, b + s + d)
    keep = tfa.mha_dropout_masks(seed, rate, b, s, heads, "cuda") \
        if rate > 0.0 else None
    scale = d ** -0.5
    with torch.no_grad():
        o, lse = tfa.fused_mha(qkv, heads=heads, kv_len=kv_len,
                               dropout_rate=rate, seed=seed, return_lse=True)
    before = _mha_bwd_bodies()
    got = tfa._mha_bwd_cuda(qkv, o, lse, do, heads, scale, kv_len, rate, seed)
    torch.cuda.synchronize()
    after = _mha_bwd_bodies()
    assert after[0] - before[0] == 1
    assert after[1 + tfa._MHA_BWD_BODIES.index(body)] - \
        before[1 + tfa._MHA_BWD_BODIES.index(body)] == 1
    want = tfa.fused_mha_bwd_plain(qkv, o, lse, do, heads, scale, kv_len,
                                   keep, rate)
    if kv_len == 1:
        # one key: dq and dk are the noise of cancelling sums on both sides
        # (dp and delta scaled alike by the kept probabilities' 1 / (1 -
        # rate), which the bound takes through do)

        def split(t, part):
            return t[..., part * heads * d:(part + 1) * heads * d].reshape(
                b, s, heads, d).transpose(1, 2)

        _one_key_noise(f"mha ({b},{s},{heads},{d})", split(qkv, 0),
                       split(qkv, 1), split(qkv, 2),
                       split(do, 0) / (1.0 - rate), scale,
                       [split(got, i) for i in range(3)],
                       [None, None, split(want, 2)])
    else:
        _assert_dqkv_close("bf16", got, want, heads, d)
    dead = got.reshape(b, s, 3, heads * d)[:, kv_len:, 1:]
    assert torch.equal(dead, torch.zeros_like(dead))
    assert torch.equal(got, tfa._mha_bwd_cuda(qkv, o, lse, do, heads, scale,
                                              kv_len, rate, seed))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,heads,d,kv_len", [(32, 14, 8, 256, 14),
                                                (64, 208, 3, 64, 197)])
def test_mha_dropout_pair_on_the_new_backward(card, b, s, heads, d, kv_len):
    """The streamed forward at dropout followed by the new backward,
    through autograd, against the plain pair given the exported mask: the
    two kernels' masks agree bit for bit with it (o within the forward's
    bound, dqkv within the backward's)."""
    seed, rate = 99, MHA_RATE
    qkv, do = _mha_inputs("bf16", b, s, heads, d, 17)
    keep = tfa.mha_dropout_masks(seed, rate, b, s, heads, "cuda")
    leaf = qkv.clone().requires_grad_(True)
    before = _mha_bwd_bodies()
    o, lse = tfa.fused_mha(leaf, heads=heads, kv_len=kv_len,
                           dropout_rate=rate, seed=seed, return_lse=True)
    o.backward(do)
    torch.cuda.synchronize()
    body = tfa.mha_bwd_on_wgmma(torch.bfloat16, d, s, kv_len, rate)
    assert body != "streamed"
    assert _mha_bwd_bodies()[1 + tfa._MHA_BWD_BODIES.index(body)] == \
        before[1 + tfa._MHA_BWD_BODIES.index(body)] + 1
    wo, wlse = tfa.fused_mha_plain(qkv, heads, d ** -0.5, kv_len, keep, rate)
    torch.testing.assert_close(o.detach().float(), wo.float(), **TOL["bf16"])
    torch.testing.assert_close(lse, wlse, atol=1e-4, rtol=1e-4)
    want = tfa.fused_mha_bwd_plain(qkv, wo, wlse, do, heads, d ** -0.5,
                                   kv_len, keep, rate)
    _assert_dqkv_close("bf16", leaf.grad, want, heads, d)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,s,heads,d,kv_len", [
    ("f32", 32, 14, 8, 256, 14), ("f32", 4, 208, 3, 64, 197),
    ("bf16", 32, 160, 8, 256, 160)])
def test_mha_bwd_streamed_shapes_stay_streamed(card, kind, b, s, heads, d,
                                               kv_len):
    """f32, and head dim 256 past one 64-row tile, run attention_bwd.cuh's
    streamed body, counted there."""
    qkv, do = _mha_inputs(kind, b, s, heads, d, 23)
    assert tfa.mha_bwd_on_wgmma(DTYPE[kind], d, s, kv_len, 0.0) == "streamed"
    with torch.no_grad():
        o, lse = tfa.fused_mha(qkv, heads=heads, kv_len=kv_len,
                               return_lse=True)
    before = _mha_bwd_bodies()
    got = tfa._mha_bwd_cuda(qkv, o, lse, do, heads, d ** -0.5, kv_len)
    torch.cuda.synchronize()
    after = _mha_bwd_bodies()
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 0, 0)
    want = tfa.fused_mha_bwd_plain(qkv, o, lse, do, heads, d ** -0.5, kv_len)
    _assert_dqkv_close(kind, got, want, heads, d)


@pytest.mark.cuda
def test_mha_bwd_route_matches_the_c_rule(card):
    """The C entry's rule (devt_mha_bwd_route) is the Python mirror's."""
    lib = _build.load("mha_bwd", tfa._declare_bwd)
    for dtype, code in tfa._DTYPE_CODE.items():
        for d in (16, 32, 64, 128, 256):
            for s in (1, 13, 14, 16, 33, 64, 65, 160, 208, 512):
                for kv_len in sorted({1, min(s, 197), s}):
                    for rate in (0.0, 0.5):
                        got = tfa._MHA_BWD_BODIES[lib.devt_mha_bwd_route(
                            code, d, s, kv_len, ctypes.c_double(rate))]
                        assert got == tfa.mha_bwd_on_wgmma(
                            dtype, d, s, kv_len, rate), (dtype, d, s, kv_len,
                                                         rate)


# FrameTransformer's encoders: distil_transformer's 2 heads of 448 over 14
# tokens and scene_transformer's 4 heads of 224 over 15, at its training
# batch (2) and serving bucket (8), kv_len S and below it
FT_MHA_SHAPES = [(b, 14, 2, 448, kv) for b in (2, 8) for kv in (14, 11)] \
    + [(b, 15, 4, 224, kv) for b in (2, 8) for kv in (15, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, MHA_RATE])
@pytest.mark.parametrize("b,s,heads,d,kv_len", FT_MHA_SHAPES)
def test_mha_kernels_at_frame_transformer_head_dims(card, b, s, heads, d,
                                                    kv_len, rate):
    """Kernels 3 and 4 in bf16 at head dims 448 and 224 on their streamed
    bodies (attn_out_cols: 7 passes of 64 or 32 columns that end at the
    head's last column): o and lse against the plain forward, dqkv against
    the plain backward on the kernel's (o, lse), both given the exported
    mask (a pass that ran into the next head's columns would fail both);
    two runs bit-equal."""
    seed = 2026
    qkv, do = _mha_inputs("bf16", b, s, heads, d, s * d + b)
    keep = tfa.mha_dropout_masks(seed, rate, b, s, heads, "cuda") \
        if rate > 0.0 else None
    assert tfa.mha_fwd_on_wgmma(torch.bfloat16, d, s, kv_len, rate) \
        == "streamed"
    assert tfa.mha_bwd_on_wgmma(torch.bfloat16, d, s, kv_len, rate) \
        == "streamed"

    def run():
        leaf = qkv.clone().requires_grad_(True)
        o, lse = tfa.fused_mha(leaf, heads=heads, kv_len=kv_len,
                               dropout_rate=rate, seed=seed, return_lse=True)
        o.backward(do)
        return o.detach(), lse, leaf.grad

    fwd0, bwd0 = _mha_bodies(), _mha_bwd_bodies()
    o, lse, dqkv = run()
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_mha_bodies(), fwd0)) == (0, 0, 1)
    assert tuple(a - b for a, b in zip(_mha_bwd_bodies(), bwd0)) \
        == (1, 1, 0, 0)
    scale = d ** -0.5
    wo, wlse = tfa.fused_mha_plain(qkv, heads, scale, kv_len, keep, rate)
    torch.testing.assert_close(o.float(), wo.float(), **TOL["bf16"])
    torch.testing.assert_close(lse, wlse, atol=1e-4, rtol=1e-4)
    want = tfa.fused_mha_bwd_plain(qkv, o, lse, do, heads, scale, kv_len,
                                   keep, rate)
    _assert_dqkv_close("bf16", dqkv, want, heads, d)
    again = run()
    assert all(torch.equal(x, y) for x, y in zip((o, lse, dqkv), again))


@pytest.mark.cuda
def test_mha_routes_and_limits_at_frame_transformer_head_dims(card):
    """The C rules send head dims 224 and 448 to the streamed bodies, as
    the Python mirrors do; past S = 32 the backward refuses before the
    forward launches, and past kv_len 64 the forward at 448 refuses."""
    fwd = _build.load("mha_fwd", tfa._declare_fwd)
    bwd = _build.load("mha_bwd", tfa._declare_bwd)
    for d in (224, 448):
        for s in (1, 14, 15, 32, 64):
            for rate in (0.0, 0.5):
                assert tfa._MHA_BODIES[fwd.devt_mha_fwd_route(
                    1, d, s, s, ctypes.c_double(rate))] == "streamed"
                assert tfa._MHA_BWD_BODIES[bwd.devt_mha_bwd_route(
                    1, d, s, s, ctypes.c_double(rate))] == "streamed"
    for d, heads in ((448, 2), (224, 4)):
        leaf = torch.zeros(1, 33, 3 * heads * d, dtype=torch.bfloat16,
                           device="cuda", requires_grad=True)
        before = tfa.fused_mha.launches
        with pytest.raises(ValueError, match="backward kernel.*warps"):
            tfa.fused_mha(leaf, heads=heads)
        assert tfa.fused_mha.launches == before
    with pytest.raises(ValueError, match="forward kernel.*bytes"):
        tfa.fused_mha(torch.zeros(1, 65, 3 * 2 * 448, dtype=torch.bfloat16,
                                  device="cuda"), heads=2)


@pytest.mark.cuda
def test_frame_transformer_distil_served_card_vs_cpu(card):
    """``distil`` (both backbones, both encoders, the distil token) at
    full width and a shorter sequence (seq_len 3, frame_len 4) behind
    Predictor in bf16 on the card: four launches of kernel 3 at each head
    dim (448 in distil_transformer, 224 in scene_transformer), none of
    kernel 4, and the scores against the same model on the CPU (both bf16:
    the two round apart through the two convolution stacks, within a few
    1e-3 of a score)."""
    from devt_tpu_torch.config import Config
    from devt_tpu_torch.registry import build_model, example_batch
    from devt_tpu_torch.serve import Predictor

    cfg = Config(model="distil", seq_len=3, frame_len=4, n_classes=19,
                 precision="bf16")
    weights = build_model(cfg).state_dict()
    batch = example_batch(cfg, 1)
    request = {k: batch[k] for k in ("img", "vid")}
    pred = Predictor(cfg, weights, buckets=(1,))
    heads = []
    real = tfa._mha_cuda

    def count(qkv, h, *args):
        heads.append((h, qkv.shape[-1] // (3 * h)))
        return real(qkv, h, *args)

    tfa.fused_mha.bwd_launches = 0
    try:
        tfa._mha_cuda = count
        got = pred.predict(request)["scores"]
    finally:
        tfa._mha_cuda = real
    assert sorted(heads) == [(2, 448)] * 4 + [(4, 224)] * 4
    assert tfa.fused_mha.bwd_launches == 0
    want = Predictor(cfg, weights, buckets=(1,), device="cpu").predict(
        request)["scores"]
    assert np.isfinite(got).all() and got.shape == (1, 19)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


# the rest of the model family: no kernel of its own, cuDNN convolutions
# and plain products on the card, held against the same model on the CPU
FAMILY_CFG = dict(n_classes=19, batch_size=2, seq_len=5, input_shape=256,
                  hidden_layer=256, projection_size=64, output_shape=32,
                  token_embedding=23)


def _family_request(name, n, seed=3):
    rng = np.random.default_rng(seed)
    if name == "tpn":
        return {"img": rng.standard_normal((n, 20, 64, 64, 3),
                                           dtype=np.float32)}
    if name == "lstm":
        return {"experts": rng.standard_normal((n, 5, 4608),
                                               dtype=np.float32)}
    return {"experts": rng.standard_normal((n, 256), dtype=np.float32)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tpn", "lstm", "basicmlp"])
def test_family_served_card_vs_cpu(card, name):
    """tpn (64² frames), lstm and basicmlp behind Predictor in bf16 on the
    card: the scores against the same model on the CPU within the serving
    gate (2e-2, both bf16), and ``quantize=True`` equal to the unquantized
    scores on the card (no site of these models is quantized)."""
    from devt_tpu_torch.config import Config
    from devt_tpu_torch.registry import build_model
    from devt_tpu_torch.serve import Predictor

    cfg = Config(model=name, precision="bf16", **FAMILY_CFG)
    weights = build_model(cfg).state_dict()
    request = _family_request(name, 3)
    got = Predictor(cfg, weights, buckets=(4,)).predict(request)["scores"]
    want = Predictor(cfg, weights, buckets=(4,), device="cpu").predict(
        request)["scores"]
    assert np.isfinite(got).all() and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    quant = Predictor(cfg, weights, buckets=(4,), quantize=True)
    assert quant._qsites == []
    np.testing.assert_array_equal(quant.predict(request)["scores"], got)


def _family_batch(name, b, seed=4):
    rng = np.random.default_rng(seed)
    # the registry's LSTM has the reference's 15 classes
    label = (rng.random((b, 15 if name == "lstm" else 19)) < 0.3).astype(
        np.float32)
    if name == "contrastive":
        return {"x_i": rng.standard_normal((b, 256), dtype=np.float32),
                "x_j": rng.standard_normal((b, 256), dtype=np.float32),
                "label": label}
    if name == "basicmlp":
        return {**_family_request(name, b, seed),
                "label": rng.integers(0, 23, (b,))}
    return {**_family_request(name, b, seed), "label": label}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tpn", "lstm", "basicmlp", "contrastive"])
def test_family_trains_card_vs_cpu(card, name):
    """One f32 step at dropout 0 (the card's masks come from another
    generator than the CPU's): the loss and the new BatchNorm statistics
    on the card against the CPU (sums in other orders: 1e-4 of the
    largest, as chip_smoke.py's phase 29 holds them), every
    gradient leaf within 1e-3 of its largest element; of TPN only its
    output layers' leaves, whose gradients pass no ReLU (behind its
    backbone's ReLUs two roundings flip gates and move whole terms;
    chip_smoke.py holds those steps to one step's gates); then
    make_multi_step(4) in bf16 on the card at lr 1e-4: a finite loss, and
    the loss at dropout 0 falling on the fixed batch."""
    from devt_tpu_torch.config import Config
    from devt_tpu_torch.models.layers import DropoutRng
    from devt_tpu_torch.parallel.train_step import make_multi_step
    from devt_tpu_torch.registry import build_model
    from devt_tpu_torch.train.optimizers import build_optimizer
    from devt_tpu_torch.train.state import TrainState, model_buffers
    from devt_tpu_torch.train.steps import forward_and_loss

    # f32 convolutions in f32, not TF32, as chip_smoke.py runs them
    torch.backends.cudnn.allow_tf32 = False
    batch = _family_batch(name, 4)
    runs = {}
    for device in ("cuda", "cpu"):
        cfg = Config(model=name, precision="f32", **FAMILY_CFG)
        model = build_model(cfg).to(device)
        if name == "tpn":
            model.reason.dropout = (0.0, 0.0)
        elif name in ("lstm", "contrastive"):
            model.dropout = 0.0
        params = dict(model.named_parameters())
        loss, _, new_ms = forward_and_loss(
            model, cfg, {"params": params, **model_buffers(model)},
            {k: torch.from_numpy(v).to(device) for k, v in batch.items()},
            DropoutRng(0), train=True)
        grads = torch.autograd.grad(loss, list(params.values()))
        runs[device] = (loss.item(), {k: v.cpu() for k, v in new_ms.items()},
                        {k: g.cpu() for k, g in zip(params, grads)})
    (lc, sc, gc), (lp, sp, gp) = runs["cuda"], runs["cpu"]
    assert abs(lc - lp) <= 1e-4 * max(abs(lp), 1.0)
    for k in sp:
        scale = max(sp[k].abs().max().item(), 1.0)
        assert (sc[k] - sp[k]).abs().max() <= 1e-4 * scale, k
    for k, g in gp.items():
        if name == "tpn" and "_fc3." not in k:
            continue
        assert (gc[k] - g).abs().max() <= 1e-3 * max(g.abs().max(), 1e-6), k

    cfg = Config(model=name, precision="bf16", opt="adamW",
                 learning_rate=1e-4, **FAMILY_CFG)
    model = build_model(cfg).cuda()
    state = TrainState.create(dict(model.named_parameters()),
                              build_optimizer(cfg),
                              model_state=model_buffers(model))
    cuda_batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}

    def loss_at_dropout_0():
        # the training forward on the batch's statistics, no dropout,
        # nothing updated: what the steps lower, without the masks' noise
        holder = getattr(model, "reason", model)
        rate = getattr(holder, "dropout", 0.0)
        holder.dropout = (0.0, 0.0) if isinstance(rate, tuple) else 0.0
        with torch.no_grad():
            loss = forward_and_loss(
                model, cfg, {"params": state.params, **state.model_state},
                cuda_batch, DropoutRng(0), train=True)[0].item()
        holder.dropout = rate
        return loss

    before = loss_at_dropout_0()
    stacked = {k: np.stack([v] * 4) for k, v in batch.items()}
    state, metrics = make_multi_step(model, cfg, 4)(state, stacked, 0)
    assert np.isfinite(metrics["loss"].item()) and state.step == 4
    assert loss_at_dropout_0() < before


@pytest.mark.cuda
def test_embedding_extractor_and_gating_card_vs_cpu(card):
    """The expert extractor (ResNet-50 on 64² frames, R3D-18 on 8 x 64²
    clips) and collaborative gating (three experts, one narrower) in f32 on
    the card against the CPU: sums in other orders through up to 50
    convolutions, 1e-3 of the largest feature."""
    from devt_tpu_torch.models.collab_gating import CollaborativeGating
    from devt_tpu_torch.models.pretrained import EmbeddingExtractor

    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(5)
    frames = rng.standard_normal((4, 64, 64, 3), dtype=np.float32)
    clips = rng.standard_normal((2, 8, 64, 64, 3), dtype=np.float32)
    card_ext = EmbeddingExtractor(seed=1)
    cpu_ext = EmbeddingExtractor(seed=1, device="cpu")
    for key, data in (("image", frames), ("location", frames),
                      ("video", clips)):
        got = card_ext.return_expert_for_key(key, data).cpu()
        want = cpu_ext.return_expert_for_key(key, data)
        assert (got - want).abs().max() <= 1e-3 * want.abs().max(), key
    gating = CollaborativeGating(256, 64).init_weights(
        torch.Generator().manual_seed(2))
    experts = [torch.from_numpy(rng.standard_normal((2, 5, d),
                                                    dtype=np.float32))
               for d in (128, 256, 256)]
    want = gating(experts)
    got = gating.cuda()([e.cuda() for e in experts]).cpu()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


class _ClipArrays:
    """Tiny channels-last clips with multi-hot labels, for the Trainer."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.vid = rng.standard_normal((n, 2, 32, 32, 3), dtype=np.float32)
        self.label = (rng.random((n, 5)) < 0.4).astype(np.float32)

    def __len__(self):
        return len(self.vid)

    def __getitem__(self, i):
        return {"vid": self.vid[i], "label": self.label[i]}


class _ClipModule:
    def __init__(self, cfg):
        self.cfg = cfg

    def setup(self):
        return self

    def _loader(self, n, data_seed, **kw):
        from devt_tpu_torch.data.pipeline import Loader

        return Loader(_ClipArrays(n, data_seed), self.cfg.batch_size,
                      num_workers=2, **kw)

    def train_batches(self):
        return self._loader(16, 0, shuffle=True, seed=self.cfg.seed)

    def val_batches(self):
        return self._loader(8, 1)

    test_batches = val_batches


@pytest.mark.cuda
def test_trainer_fit_on_the_card_matches_the_cpu(card, tmp_path):
    """A ViViT at dim 192 (one block, 32² frames of 2) fitted by the
    Trainer for 2 epochs of 4 steps in f32, on the card (through the
    pinned placer and kernels 1 and 2) and on the CPU from the same
    weights: every logged loss within 1e-3 relative."""
    from devt_tpu_torch.config import Config
    from devt_tpu_torch.models.vivit import ViViT
    from devt_tpu_torch.train.harness import Trainer

    class Log:
        def __init__(self):
            self.rows = []

        def log(self, metrics, step=None):
            self.rows += [(k, step, v) for k, v in metrics.items()
                          if k in ("train/loss", "val/loss")]

        log_text = log_table = close = lambda self, *a, **k: None

    cfg = Config(model="vivit", batch_size=4, n_classes=5, frame_len=2,
                 precision="f32", opt="adamW", learning_rate=1e-3,
                 epochs=2, log_every=1, seed=3)
    logs = {}
    tfb.fused_vit_block.launches = tfb.fused_vit_block.bwd_launches = 0
    for device in ("cuda", "cpu"):
        model = ViViT(image_size=32, patch_size=16, num_classes=5,
                      num_frames=2, depth=1, channels_last=True) \
            .init_weights(torch.Generator().manual_seed(1))
        logs[device] = Log()
        Trainer(cfg.replace(checkpoint_dir=str(tmp_path / device)),
                logger=logs[device], device=device).fit(
                    model, _ClipModule(cfg))
    assert tfb.fused_vit_block.launches >= 8
    assert tfb.fused_vit_block.bwd_launches == 8
    card_rows, cpu_rows = logs["cuda"].rows, logs["cpu"].rows
    assert [r[:2] for r in card_rows] == [r[:2] for r in cpu_rows]
    assert len(card_rows) == 10
    for (key, step, got), (_, _, want) in zip(card_rows, cpu_rows):
        assert abs(got - want) <= 1e-3 * abs(want), (key, step, got, want)


@pytest.mark.cuda
def test_pinned_placer_tensors_equal_the_host_batch(card):
    """device_prefetch on the card: pinned staging, a side stream, every
    tensor on the card equal to its host array, the consumer's stream
    waiting on the copy; the paths stay on the host."""
    from devt_tpu_torch.data.pipeline import device_prefetch

    rng = np.random.default_rng(0)
    batches = [{"x": rng.standard_normal((64, 300), dtype=np.float32),
                "y": rng.integers(0, 9, (64,)).astype(np.int32),
                "u8": rng.integers(0, 255, (64, 7), dtype=np.uint8),
                "path": [f"p{i}" for i in range(64)]} for _ in range(7)]
    placed = []
    for got in device_prefetch(iter(batches), device="cuda", depth=2):
        assert set(got) == {"x", "y", "u8"}
        # work on the consumer's stream right away, as a step would
        placed.append({k: (v * 1).cpu() for k, v in got.items()})
    assert len(placed) == len(batches)
    for got, want in zip(placed, batches):
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
