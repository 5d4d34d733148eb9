"""The port's packed-qkv attention against the JAX package's, on the CPU.

``fused_mha_plain`` (o and lse) against ``fused_mha(interpret=True)`` and
against ``xla_attention``, from the same numpy arrays.  Tolerance: f32 on
both sides with sums in other orders, the parity bound of the other port
tests (atol 2e-5 / rtol 2e-4); in bf16 one ulp of o (2^-8 relative) where a
probability or a sum lands on the other side of a rounding boundary.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu.ops import attention as jatt
from devt_tpu_torch.ops import attention as tatt
from devt_tpu_torch.ops import flash_attention as tfa

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

# ``devt_tpu.ops.flash_attention`` the attribute is a function of that name
jfa = importlib.import_module("devt_tpu.ops.flash_attention")

TOL = dict(atol=2e-5, rtol=2e-4)
BF16_TOL = dict(atol=1e-2, rtol=1.6e-2)


def _qkv(b, s, heads, d, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, 3 * heads * d)).astype(np.float32)


# FrameTransformer's encoders: distil_transformer's 2 heads of 448 over 14
# tokens, scene_transformer's 4 heads of 224 over 15 (with the distil
# token), each at kv_len S and below it
FT_SHAPES = [(2, 14, 2, 448, None), (2, 14, 2, 448, 11),
             (2, 15, 4, 224, None), (2, 15, 4, 224, 12)]


@pytest.mark.parametrize("b,s,heads,d,kv_len", [
    (2, 32, 2, 32, 27), (2, 14, 2, 256, None), (3, 23, 3, 64, 19),
    (1, 208, 3, 64, 197)] + FT_SHAPES)
def test_plain_matches_jax_interpret(b, s, heads, d, kv_len):
    """d = 32, 64, 224, 256 and 448, S not a multiple of 16 (the TPU
    wrapper pads it, the port's needs no padding), kv_len < S."""
    qkv = _qkv(b, s, heads, d)
    want = jfa.fused_mha(jnp.asarray(qkv), heads=heads, kv_len=kv_len,
                         interpret=True)
    o, lse = tfa.fused_mha(torch.tensor(qkv), heads=heads, kv_len=kv_len,
                           return_lse=True)
    assert o.shape == (b, s, heads * d) and lse.shape == (b, s, heads)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), **TOL)
    # lse against the TPU kernel's own output (its wrapper drops it): the
    # 128-lane broadcast of each head's value
    s_p = -(-s // 16) * 16
    padded = np.pad(qkv, ((0, 0), (0, s_p - s), (0, 0)))
    _, jlse = jfa._mha_fwd(jnp.asarray(padded), jnp.zeros((1,), jnp.int32),
                           heads=heads, d=d, scale=d ** -0.5,
                           kv_len=kv_len if kv_len is not None else s,
                           rate=0.0, interpret=True)
    jlse = np.asarray(jlse).reshape(b, s_p, heads, 128)
    assert (jlse == jlse[..., :1]).all()
    np.testing.assert_allclose(lse.numpy(), jlse[:, :s, :, 0], **TOL)


@pytest.mark.parametrize("kv_len", [None, 11])
def test_plain_matches_xla_attention(kv_len):
    b, s, heads, d = 2, 16, 4, 16
    qkv = _qkv(b, s, heads, d, seed=1)
    split = qkv.reshape(b, s, 3, heads, d)
    q, k, v = (jnp.asarray(split[:, :, i].transpose(0, 2, 1, 3))
               for i in range(3))
    want = jatt.xla_attention(q, k, v, scale=d ** -0.5, kv_len=kv_len)
    want = np.asarray(want).transpose(0, 2, 1, 3).reshape(b, s, heads * d)
    got = tfa.fused_mha(torch.tensor(qkv), heads=heads, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # and the port's two attention routes against each other
    both = tatt.packed_mha(torch.tensor(qkv), heads=heads, impl="xla",
                           kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), both.numpy(), **TOL)


def test_plain_bf16_rounds_like_jax():
    qkv = _qkv(2, 16, 2, 64, seed=2)
    want = jfa.fused_mha(jnp.asarray(qkv, jnp.bfloat16), heads=2, kv_len=14,
                         interpret=True)
    got = tfa.fused_mha(torch.tensor(qkv).to(torch.bfloat16), heads=2,
                        kv_len=14)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


@pytest.mark.parametrize("b,s,heads,d,kv_len", FT_SHAPES)
def test_plain_bf16_rounds_like_jax_at_frame_transformer_head_dims(
        b, s, heads, d, kv_len):
    qkv = _qkv(b, s, heads, d, seed=6)
    want = jfa.fused_mha(jnp.asarray(qkv, jnp.bfloat16), heads=heads,
                         kv_len=kv_len, interpret=True)
    got = tfa.fused_mha(torch.tensor(qkv).to(torch.bfloat16), heads=heads,
                        kv_len=kv_len)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, heads * d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


def test_fully_masked_tail_rows_stay_finite():
    """Pad rows past kv_len are queries like any other; keys past kv_len
    get probability exactly 0."""
    qkv = torch.tensor(_qkv(1, 16, 1, 32, seed=3))
    o, lse = tfa.fused_mha(qkv, heads=1, kv_len=5, return_lse=True)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    changed = qkv.clone()
    changed[:, 5:, 32:] = 7.0                 # k and v of the masked keys
    again = tfa.fused_mha(changed, heads=1, kv_len=5)
    assert torch.equal(o, again)


@pytest.mark.parametrize("impl", ["pallas", "auto", "xla", "fused_interpret"])
def test_packed_mha_dispatch_matches_jax(impl):
    """Every impl gives the same attention on the CPU: "pallas" through
    the wrapper's plain version, the others through the materialised
    softmax."""
    qkv = _qkv(2, 9, 2, 16, seed=4)
    want = jatt.packed_mha(jnp.asarray(qkv), heads=2, impl="xla", kv_len=7)
    calls = tfa.fused_mha.launches
    got = tatt.packed_mha(torch.tensor(qkv), heads=2, impl=impl, kv_len=7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tfa.fused_mha.launches == calls      # no kernel on the CPU


def test_packed_mha_kernel_route_refuses_gradients_and_dropout(monkeypatch):
    """On the card "pallas" and "auto" alike take the kernels now, for an
    input that needs a gradient and with attention dropout (a seed drawn
    from the ``DropoutRng``): the forward and the backward launcher are
    seen to launch, and nothing gives way to the plain attention while the
    tensors are on the card.  Checked here by letting the tensors claim to
    be CUDA tensors up to the point where a kernel would launch.  Dropout
    without a ``rng`` is still refused.  On CPU tensors "auto" is the plain
    attention, differentiable and with dropout."""
    from devt_tpu_torch.models.layers import DropoutRng

    qkv = torch.tensor(_qkv(1, 8, 2, 16, seed=5), requires_grad=True)
    fwd, bwd = [], []

    def plain(t):
        return t.as_subclass(torch.Tensor)

    def fake_fwd(q, heads, scale, kv_len, rate=0.0, seed=0):
        fwd.append((rate, seed))
        keep = tfa.mha_dropout_masks(seed, rate, q.shape[0], q.shape[1],
                                     heads, "cpu") if rate > 0.0 else None
        return tfa.fused_mha_plain(plain(q), heads, scale, kv_len, keep, rate)

    def fake_bwd(q, o, lse, do, heads, scale, kv_len, rate=0.0, seed=0):
        bwd.append((rate, seed))
        keep = tfa.mha_dropout_masks(seed, rate, q.shape[0], q.shape[1],
                                     heads, "cpu") if rate > 0.0 else None
        return tfa.fused_mha_bwd_plain(plain(q), o, lse, do, heads, scale,
                                       kv_len, keep, rate)

    monkeypatch.setattr(tfa, "_mha_cuda", fake_fwd)
    monkeypatch.setattr(tfa, "_mha_bwd_cuda", fake_bwd)

    class OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    card = qkv.detach().as_subclass(OnCard).requires_grad_(True)
    want = tatt.packed_mha(qkv, heads=2, impl="xla")
    (want_grad,) = torch.autograd.grad(want.square().sum(), qkv)
    for impl in ("pallas", "auto"):
        out = tatt.packed_mha(card, heads=2, impl=impl)
        (grad,) = torch.autograd.grad(out.square().sum(), card)
        np.testing.assert_allclose(plain(out).detach().numpy(),
                                   want.detach().numpy(), **TOL)
        np.testing.assert_allclose(plain(grad).numpy(), want_grad.numpy(),
                                   **TOL)
        rng = DropoutRng(0)
        seed = DropoutRng(0).block_seed()
        dropped = tatt.packed_mha(card, heads=2, impl=impl, dropout_rate=0.1,
                                  rng=rng)
        torch.autograd.grad(dropped.sum(), card)
        assert fwd[-1] == bwd[-1] == (0.1, seed)
        with pytest.raises(ValueError, match="rng"):
            tatt.packed_mha(card, heads=2, impl=impl, dropout_rate=0.1)
    assert [r for r, _ in fwd] == [0.0, 0.1] * 2 and len(bwd) == 4
    # CPU tensors: "auto" is the plain attention
    out = tatt.packed_mha(qkv, heads=2, impl="auto")
    out.sum().backward()
    assert qkv.grad is not None and torch.isfinite(qkv.grad).all()
    dropped = tatt.packed_mha(qkv.detach(), heads=2, impl="auto",
                              dropout_rate=0.5, rng=DropoutRng(0))
    assert not torch.equal(dropped, out.detach())
    assert len(fwd) == 4


def test_long_sequences_and_unknown_impls_raise():
    """``"pallas"`` above 512 tokens runs the blockwise forward (kernel
    11's plain version on CPU tensors) and its gradient (kernels 12 and
    13's), which match the materialised attention's; an unknown impl is
    refused."""
    long = torch.tensor(np.random.default_rng(5).standard_normal(
        (1, 520, 3 * 16)).astype(np.float32))
    assert not tfa.fits_single_block(520) and tfa.fits_single_block(512)
    out = tatt.packed_mha(long, heads=1, impl="pallas")
    assert out.shape == (1, 520, 16) and torch.isfinite(out).all()
    grads = []
    for impl in ("pallas", "xla"):
        leaf = long.clone().requires_grad_(True)
        tatt.packed_mha(leaf, heads=1, impl=impl, kv_len=509).square() \
            .sum().backward()
        grads.append(leaf.grad)
    torch.testing.assert_close(*grads, atol=5e-5, rtol=5e-4)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tatt.packed_mha(long, heads=1, impl="flash")
    with pytest.raises(ValueError, match="unknown attention impl"):
        tatt.scaled_dot_product_attention(*(torch.zeros(1, 1, 4, 8),) * 3,
                                          impl="flash")


def test_cuda_argument_check_raises_on_unsupported_shapes():
    """The argument check of the CUDA route needs no card."""
    ok = torch.zeros(2, 16, 3 * 2 * 64, dtype=torch.bfloat16)
    assert tfa._check_mha_args(ok, 2, 14) == 64
    with pytest.raises(ValueError, match="head dims"):
        tfa._check_mha_args(torch.zeros(2, 16, 3 * 2 * 48,
                                        dtype=torch.bfloat16), 2, 16)
    # the bfloat16 forward streams K and V in key tiles: any S; the float
    # one keeps a head's K and V whole
    assert tfa._check_mha_args(torch.zeros(1, 512, 3 * 256,
                                           dtype=torch.bfloat16), 1, 512) \
        == 256
    with pytest.raises(ValueError, match="shared memory"):
        tfa._check_mha_args(torch.zeros(1, 512, 3 * 256), 1, 512)
    with pytest.raises(ValueError, match="kv_len"):
        tfa._check_mha_args(ok, 2, 17)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa._check_mha_args(ok.half(), 2, 14)
    with pytest.raises(ValueError, match="contiguous"):
        tfa._check_mha_args(ok.transpose(0, 1), 2, 14)
