"""The port's fused ViT-block backward against the JAX Pallas kernel.

``fused_vit_block_bwd_plain`` (the plain PyTorch version of the CUDA
backward kernel) is held against ``devt_tpu.ops.fused_block._bwd_call``
run in interpret mode on the CPU, on the same numpy (x, params, u, res,
dy); ``FusedViTBlock`` (the autograd Function, which on the CPU runs the
plain versions) against ``jax.grad`` of the JAX ``fused_vit_block``.  The
dropout of the plain path is checked for its rate, for rate → 0, and for
forward and backward seeing the same masks.  The CUDA kernel itself is
held against the plain version on the card in ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu.ops import fused_block as jfb
from devt_tpu_torch.ops import fused_block as tfb

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

DIM, MLP, HEADS = 32, 64, 2
SCALE = (DIM // HEADS) ** -0.5
# f32: the JAX package's own backward bound (tests/test_fused_block.py:52)
F32_TOL = dict(atol=5e-5, rtol=5e-4)
# bf16: both sides round at the same places, but their f32 sums run in
# other orders, so a value next to a rounding boundary can land on either
# side.  The bound is one bf16 ulp (2^-8 relative) of the largest element
# of each tensor; on these inputs the two agree to 1e-4 of that.
BF16_ULPS = 1


def _make(dim=DIM, mlp=MLP, b=4, s=16, kv_len=16, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = {
        "g1": 1.0 + t(1, dim), "b1": t(1, dim),
        "wqkv": t(dim, 3 * dim), "wo": t(dim, dim),
        "bo": t(1, dim, scale=0.01),
        "g2": 1.0 + t(1, dim), "b2": t(1, dim),
        "w1": t(dim, mlp), "bb1": t(1, mlp, scale=0.01),
        "w2": t(mlp, dim), "bb2": t(1, dim, scale=0.01),
    }
    x = t(b, s, dim, scale=1.0)
    x[:, kv_len:] = 0.0          # pad rows as the model pads them
    dy = t(b, s, dim, scale=1.0)
    return x, params, dy


def _jax_params(params, dtype):
    return {k: jnp.asarray(v, dtype if k in tfb._MATRICES else jnp.float32)
            for k, v in params.items()}


def _torch_params(params, dtype, requires_grad=False):
    return {k: torch.tensor(v).to(dtype if k in tfb._MATRICES
                                  else torch.float32)
            .requires_grad_(requires_grad) for k, v in params.items()}


def _both_backwards(kv_len, jdtype, tdtype, seed):
    """(dx, grads) of the JAX kernel (interpret) and of the plain version
    on the same inputs, the forward's (u, res) taken from the JAX kernel."""
    x, params, dy = _make(kv_len=kv_len, seed=seed)
    jp = _jax_params(params, jdtype)
    zero = jnp.zeros((1,), jnp.int32)
    kw = dict(heads=HEADS, scale=SCALE, kv_len=kv_len, rate=0.0,
              interpret=True)
    jx = jnp.asarray(x, jdtype)
    jdy = jnp.asarray(dy, jdtype)
    _, ju, jres = jfb._fwd_call(jx, jp, zero, **kw)
    jdx, jgrads = jfb._bwd_call(jx, jp, zero, ju, jres, jdy, **kw)

    def to_t(a):
        return torch.tensor(np.asarray(a, np.float32))

    tp = _torch_params(params, tdtype)
    tdx, tgrads = tfb.fused_vit_block_bwd_plain(
        to_t(jx).to(tdtype), tp, to_t(ju).to(tdtype), to_t(jres),
        to_t(jdy).to(tdtype), HEADS, SCALE, kv_len)
    return (jdx, jgrads), (tdx, tgrads), tp


@pytest.mark.parametrize("kv_len", [16, 13])
def test_plain_backward_matches_jax_kernel_f32(kv_len):
    (jdx, jgrads), (tdx, tgrads), _ = _both_backwards(
        kv_len, jnp.float32, torch.float32, seed=1)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), **F32_TOL)
    for name in tfb.PARAM_NAMES:
        want = np.asarray(jgrads[name])
        got = tgrads[name].numpy()
        assert got.shape == (1, want.shape[-1]) if want.ndim == 1 \
            else got.shape == want.shape, name
        np.testing.assert_allclose(got.reshape(want.shape), want,
                                   err_msg=name, **F32_TOL)


@pytest.mark.parametrize("kv_len", [16, 13])
def test_plain_backward_matches_jax_kernel_bf16(kv_len):
    (jdx, jgrads), (tdx, tgrads), tp = _both_backwards(
        kv_len, jnp.bfloat16, torch.bfloat16, seed=2)

    def close(got, want, name):
        got = got.float().numpy().reshape(want.shape)
        bound = BF16_ULPS * 2.0 ** -8 * np.abs(want).max()
        assert np.abs(got - want).max() <= bound, \
            f"{name}: {np.abs(got - want).max()} > {bound}"

    assert tdx.dtype == torch.bfloat16
    close(tdx, np.asarray(jdx, np.float32), "dx")
    for name in tfb.PARAM_NAMES:
        # each gradient in the dtype of the parameter tensor passed in:
        # matrices bf16, LN parameters and biases f32
        assert tgrads[name].dtype == tp[name].dtype, name
        assert str(jgrads[name].dtype) == str(tp[name].dtype) \
            .replace("torch.", ""), name
        close(tgrads[name], np.asarray(jgrads[name], np.float32), name)


@pytest.mark.parametrize("kv_len", [16, 13])
def test_function_matches_jax_grad(kv_len):
    """FusedViTBlock end to end (forward and backward through autograd)
    against jax.grad of the JAX fused block, dx and all 11 grads."""
    x, params, _ = _make(kv_len=kv_len, seed=3)
    jp = _jax_params(params, jnp.float32)

    def jloss(xj, pj):
        return jnp.sum(jnp.sin(jfb.fused_vit_block(
            xj, pj, HEADS, SCALE, kv_len, True)))

    jdx, jgrads = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jp)

    tx = torch.tensor(x, requires_grad=True)
    tp = _torch_params(params, torch.float32, requires_grad=True)
    y, _, _ = tfb.fused_vit_block(tx, tp, HEADS, SCALE, kv_len)
    torch.sin(y).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **F32_TOL)
    for name in tfb.PARAM_NAMES:
        assert tp[name].grad.dtype == tp[name].dtype
        np.testing.assert_allclose(
            tp[name].grad.numpy(),
            np.asarray(jgrads[name]).reshape(tp[name].shape),
            err_msg=name, **F32_TOL)


def test_weight_grads_sum_over_the_whole_batch():
    """Doubling the batch doubles dW (tests/test_fused_block.py:59-71)."""
    x, params, _ = _make(seed=4)

    def dw(xin):
        tp = _torch_params(params, torch.float32, requires_grad=True)
        y, _, _ = tfb.fused_vit_block(torch.tensor(xin), tp, HEADS, SCALE, 16)
        y.sum().backward()
        return tp["wqkv"].grad.numpy()

    np.testing.assert_allclose(dw(np.concatenate([x, x])), 2 * dw(x),
                               atol=1e-4, rtol=1e-4)


# --- dropout on the plain path --------------------------------------------

RATE = 0.25


def test_dropout_masks_drop_about_the_rate():
    """Each site's dropped share within 4 standard deviations of the rate
    (sqrt(rate (1 - rate) / n) each), and masks differ between seeds."""
    keep = tfb.dropout_masks(7, RATE, 8, 48, DIM, MLP, "cpu")
    assert [tuple(k.shape) for k in keep] == [(8, 48, DIM), (8, 48, MLP),
                                              (8, 48, DIM)]
    for k in keep:
        band = 4 * (RATE * (1 - RATE) / k.numel()) ** 0.5
        assert abs((~k).float().mean().item() - RATE) < band
    again = tfb.dropout_masks(7, RATE, 8, 48, DIM, MLP, "cpu")
    other = tfb.dropout_masks(8, RATE, 8, 48, DIM, MLP, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(keep, again))
    assert not torch.equal(keep[1], other[1])


def test_dropout_cutoff_rule():
    assert tfb.dropout_cutoff(0.5) == 1 << 31
    assert tfb.dropout_cutoff(0.0) == 0
    assert tfb.dropout_cutoff(1.0) == (1 << 32) - 1


def test_dropout_rate_to_zero_reproduces_no_dropout():
    x, params, _ = _make(kv_len=13, seed=5)
    tx, tp = torch.tensor(x), _torch_params(params, torch.float32)
    want = tfb.fused_vit_block(tx, tp, HEADS, SCALE, 13)
    got = tfb.fused_vit_block(tx, tp, HEADS, SCALE, 13, dropout_rate=1e-12,
                              seed=3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6, rtol=1e-6)


def _unfused_block_with_masks(x, p, keep, rate, kv_len):
    """An unfused torch block given the same three masks, f32, all ops
    differentiable by autograd."""
    keep_o, keep_h, keep_y = keep
    ik = 1.0 / (1.0 - rate)
    a = torch.nn.functional.layer_norm(x, (DIM,), p["g1"][0], p["b1"][0], 1e-5)
    qkv = a @ p["wqkv"]
    b, s, _ = x.shape
    q, k, v = (t.reshape(b, s, HEADS, DIM // HEADS).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    sc = q @ k.transpose(-1, -2) * SCALE
    sc = sc.masked_fill(torch.arange(s) >= kv_len, float("-inf"))
    att = (sc.softmax(dim=-1) @ v).transpose(1, 2).reshape(b, s, DIM)
    u = x + (att @ p["wo"] + p["bo"][0]) * keep_o * ik
    bb = torch.nn.functional.layer_norm(u, (DIM,), p["g2"][0], p["b2"][0],
                                        1e-5)
    h = torch.nn.functional.gelu(bb @ p["w1"] + p["bb1"][0],
                                 approximate="tanh") * keep_h * ik
    return u + (h @ p["w2"] + p["bb2"][0]) * keep_y * ik


@pytest.mark.parametrize("kv_len", [16, 13])
def test_dropout_forward_and_backward_see_the_same_masks(kv_len):
    """With the masks fixed the block is differentiable, so the fused
    forward+backward under a seed must equal autograd of an unfused block
    given the masks of that seed — in value, dx and all 11 grads.  A
    backward that drew other masks than the forward would miss this."""
    seed = 11
    x, params, _ = _make(kv_len=kv_len, seed=6)
    keep = tfb.dropout_masks(seed, RATE, *x.shape, MLP, "cpu")

    tx = torch.tensor(x, requires_grad=True)
    tp = _torch_params(params, torch.float32, requires_grad=True)
    y, _, _ = tfb.fused_vit_block(tx, tp, HEADS, SCALE, kv_len,
                                  dropout_rate=RATE, seed=seed)
    torch.sin(y).sum().backward()

    rx = torch.tensor(x, requires_grad=True)
    rp = _torch_params(params, torch.float32, requires_grad=True)
    ry = _unfused_block_with_masks(rx, rp, keep, RATE, kv_len)
    torch.sin(ry).sum().backward()

    np.testing.assert_allclose(y.detach().numpy(), ry.detach().numpy(),
                               atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(tx.grad.numpy(), rx.grad.numpy(), **F32_TOL)
    for name in tfb.PARAM_NAMES:
        np.testing.assert_allclose(tp[name].grad.numpy(),
                                   rp[name].grad.numpy(), err_msg=name,
                                   **F32_TOL)
    # the masks did drop something at every site
    dropped = tfb.fused_vit_block(torch.tensor(x),
                                  _torch_params(params, torch.float32),
                                  HEADS, SCALE, kv_len)[0]
    assert not torch.allclose(dropped, y.detach())


def test_plain_backward_takes_the_masks_as_an_argument():
    """The plain backward given the masks equals the Function's backward
    under the seed that draws them (what the card comparison relies on)."""
    seed, kv_len = 5, 13
    x, params, dy = _make(kv_len=kv_len, seed=7)
    keep = tfb.dropout_masks(seed, RATE, *x.shape, MLP, "cpu")
    tx = torch.tensor(x, requires_grad=True)
    tp = _torch_params(params, torch.float32, requires_grad=True)
    y, u, res = tfb.fused_vit_block(tx, tp, HEADS, SCALE, kv_len,
                                    dropout_rate=RATE, seed=seed)
    y.backward(torch.tensor(dy))
    py, pu, pres = tfb.fused_vit_block_fwd_plain(
        tx.detach(), tp, HEADS, SCALE, kv_len, keep, RATE)
    assert torch.equal(py, y.detach()) and torch.equal(pu, u)
    dx, grads = tfb.fused_vit_block_bwd_plain(
        tx.detach(), {k: v.detach() for k, v in tp.items()}, u, res,
        torch.tensor(dy), HEADS, SCALE, kv_len, keep, RATE)
    assert torch.equal(dx, tx.grad)
    for name in tfb.PARAM_NAMES:
        assert torch.equal(grads[name], tp[name].grad), name
