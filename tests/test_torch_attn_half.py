"""The port's fused attention half (kernels 7 and 8) against the JAX
Pallas kernels.

``fused_attn_half_fwd_plain`` and ``fused_attn_half_bwd_plain`` (the plain
PyTorch versions of the CUDA kernels) are held against
``devt_tpu.ops.fused_block._attn_half_fwd_call`` / ``_attn_half_bwd_call``
run in interpret mode on the CPU, on the same numpy inputs; the autograd
Function (which on the CPU runs the plain versions) against ``jax.grad``
of the JAX ``fused_attn_half``.  The CUDA kernels themselves are held
against the plain versions on the card in ``tests/test_torch_cuda.py``.
On the card kernel 7's attention launch runs the one-shot wgmma body where
``attn_half_on_wgmma`` says, in an instance that normalises after P·V as
the JAX kernel does; the route and that rounding are checked here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu.ops import fused_block as jfb
from devt_tpu_torch.ops import flash_attention as tfa
from devt_tpu_torch.ops import fused_block as tfb

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

DIM, HEADS = 32, 2
SCALE = (DIM // HEADS) ** -0.5
MATRICES = ("wqkv", "wo")
# f32: the JAX package's own bounds (tests/test_fused_block.py)
FWD_TOL = dict(atol=2e-5, rtol=2e-4)
BWD_TOL = dict(atol=5e-5, rtol=5e-4)
# bf16: both round at the same places, but their f32 sums run in other
# orders, so a value next to a rounding boundary lands on either side: one
# bf16 ulp of the largest element of each tensor (8 significant bits, so
# 2^-7 of it at most)
BF16_ULP = 2.0 ** -7
BF16_RES_TOL = dict(atol=1e-3, rtol=1e-3)


def _make(b=4, s=16, kv_len=13, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = {"g1": 1.0 + t(1, DIM), "b1": t(1, DIM),
              "wqkv": t(DIM, 3 * DIM), "wo": t(DIM, DIM),
              "bo": t(1, DIM, scale=0.01)}
    x = t(b, s, DIM, scale=1.0)
    x[:, kv_len:] = 0.0          # pad rows as the model pads them
    du = t(b, s, DIM, scale=1.0)
    return x, params, du


def _jax_params(params, dtype):
    return {k: jnp.asarray(v, dtype if k in MATRICES else jnp.float32)
            for k, v in params.items()}


def _torch_params(params, dtype, requires_grad=False):
    return {k: torch.tensor(v).to(dtype if k in MATRICES else torch.float32)
            .requires_grad_(requires_grad) for k, v in params.items()}


def _to_t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _ulps_close(got, want, name):
    got = got.float().numpy().reshape(want.shape)
    bound = BF16_ULP * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound, f"{name}: {err} > {bound}"


@pytest.mark.parametrize("kv_len", [16, 13])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_plain_forward_matches_jax_kernel(kind, kv_len):
    jdtype, tdtype = {"f32": (jnp.float32, torch.float32),
                      "bf16": (jnp.bfloat16, torch.bfloat16)}[kind]
    x, params, _ = _make(kv_len=kv_len, seed=1)
    ju, jres = jfb._attn_half_fwd_call(
        jnp.asarray(x, jdtype), _jax_params(params, jdtype), heads=HEADS,
        scale=SCALE, kv_len=kv_len, interpret=True)
    u, res = tfb.fused_attn_half_fwd_plain(
        torch.tensor(x).to(tdtype), _torch_params(params, tdtype), HEADS,
        SCALE, kv_len)
    assert u.dtype == tdtype and res.dtype == torch.float32
    assert res.shape == jres.shape == (4, 16, 8)
    if kind == "f32":
        np.testing.assert_allclose(u.numpy(), np.asarray(ju), **FWD_TOL)
        np.testing.assert_allclose(res.numpy(), np.asarray(jres), **FWD_TOL)
    else:
        _ulps_close(u, np.asarray(ju, np.float32), "u")
        np.testing.assert_allclose(res.numpy(), np.asarray(jres),
                                   **BF16_RES_TOL)


def test_residual_lanes_layout():
    """[lse (H), mu1, rstd1] then zeros to 8 lanes; the zero pad rows give
    rstd1 = 1/sqrt(eps) and stay finite."""
    kv_len = 13
    x, params, _ = _make(kv_len=kv_len)
    u, res = tfb.fused_attn_half_fwd_plain(
        torch.tensor(x), _torch_params(params, torch.float32), HEADS, SCALE,
        kv_len)
    assert torch.all(res[..., HEADS + 2:] == 0)
    np.testing.assert_allclose(res[:, kv_len:, HEADS + 1].numpy(),
                               1e-5 ** -0.5, rtol=1e-6)
    assert torch.isfinite(u).all()


@pytest.mark.parametrize("kv_len", [16, 13])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_plain_backward_matches_jax_kernel(kind, kv_len):
    """dx and the 5 gradients of the plain backward against the
    interpreted JAX backward kernel, from the JAX forward's res."""
    jdtype, tdtype = {"f32": (jnp.float32, torch.float32),
                      "bf16": (jnp.bfloat16, torch.bfloat16)}[kind]
    x, params, du = _make(kv_len=kv_len, seed=2)
    jp = _jax_params(params, jdtype)
    jx, jdu = jnp.asarray(x, jdtype), jnp.asarray(du, jdtype)
    kw = dict(heads=HEADS, scale=SCALE, kv_len=kv_len, interpret=True)
    _, jres = jfb._attn_half_fwd_call(jx, jp, **kw)
    jdx, jgrads = jfb._attn_half_bwd_call(jx, jp, jres, jdu, **kw)
    tp = _torch_params(params, tdtype)
    tdx, tgrads = tfb.fused_attn_half_bwd_plain(
        _to_t(jx).to(tdtype), tp, _to_t(jres), _to_t(jdu).to(tdtype), HEADS,
        SCALE, kv_len)
    assert tdx.dtype == tdtype
    for name, got, want in [("dx", tdx, jdx)] + [
            (k, tgrads[k], jgrads[k]) for k in tfb.HALF_NAMES]:
        want = np.asarray(want, np.float32)
        if name != "dx":
            # each gradient in the dtype of its parameter tensor, rows (1, N)
            assert got.dtype == tp[name].dtype, name
            assert tuple(got.shape) == tuple(tp[name].shape), name
        if kind == "f32":
            np.testing.assert_allclose(got.numpy().reshape(want.shape), want,
                                       err_msg=name, **BWD_TOL)
        else:
            _ulps_close(got, want, name)


@pytest.mark.parametrize("kv_len", [16, 13])
def test_function_matches_jax_grad(kv_len):
    """FusedAttnHalf end to end (forward and backward through autograd)
    against jax.grad of the JAX fused_attn_half, dx and all 5 grads."""
    x, params, _ = _make(kv_len=kv_len, seed=3)
    jp = _jax_params(params, jnp.float32)

    def jloss(xj, pj):
        return jnp.sum(jnp.sin(jfb.fused_attn_half(xj, pj, HEADS, SCALE,
                                                   kv_len, interpret=True)))

    ju = jfb.fused_attn_half(jnp.asarray(x), jp, HEADS, SCALE, kv_len,
                             interpret=True)
    jdx, jgrads = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jp)

    tx = torch.tensor(x, requires_grad=True)
    tp = _torch_params(params, torch.float32, requires_grad=True)
    before = (tfb.fused_attn_half.launches, tfb.fused_attn_half.bwd_launches)
    u, res = tfb.fused_attn_half(tx, tp, HEADS, SCALE, kv_len)
    assert not res.requires_grad
    torch.sin(u).sum().backward()
    # CPU tensors run the plain versions: no kernel was launched
    assert (tfb.fused_attn_half.launches,
            tfb.fused_attn_half.bwd_launches) == before
    np.testing.assert_allclose(u.detach().numpy(), np.asarray(ju), **FWD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **BWD_TOL)
    for name in tfb.HALF_NAMES:
        assert tp[name].grad.dtype == tp[name].dtype
        np.testing.assert_allclose(
            tp[name].grad.numpy(),
            np.asarray(jgrads[name]).reshape(tp[name].shape),
            err_msg=name, **BWD_TOL)


def test_half_is_the_first_half_of_the_block():
    """u of the attention half equals the u the whole fused block keeps,
    and its residual lanes the block's first H + 2 lanes."""
    x, params, _ = _make(kv_len=13, seed=4)
    rng = np.random.default_rng(5)
    full = dict(params, g2=np.ones((1, DIM), np.float32),
                b2=np.zeros((1, DIM), np.float32),
                w1=(rng.standard_normal((DIM, 64)) * 0.1).astype(np.float32),
                bb1=np.zeros((1, 64), np.float32),
                w2=(rng.standard_normal((64, DIM)) * 0.1).astype(np.float32),
                bb2=np.zeros((1, DIM), np.float32))
    tfull = {k: torch.tensor(v) for k, v in full.items()}
    _, u_block, res_block = tfb.fused_vit_block_fwd_plain(
        torch.tensor(x), tfull, HEADS, SCALE, 13)
    u, res = tfb.fused_attn_half_fwd_plain(
        torch.tensor(x), _torch_params(params, torch.float32), HEADS, SCALE,
        13)
    assert torch.equal(u, u_block)
    assert torch.equal(res[..., :HEADS + 2], res_block[..., :HEADS + 2])


# --- kernel 7's attention on the one-shot wgmma body ------------------------

@pytest.mark.parametrize("dtype,d,kv_len,want", [
    (torch.bfloat16, 64, 197, True),     # the MoE main path (512, 208, 192)
    (torch.bfloat16, 32, 37, True),      # the (64, 32) width
    (torch.bfloat16, 64, 1, True), (torch.bfloat16, 16, 64, True),
    (torch.bfloat16, 64, 256, True), (torch.bfloat16, 64, 257, False),
    (torch.bfloat16, 32, 400, False), (torch.bfloat16, 128, 100, False),
    (torch.bfloat16, 48, 64, False), (torch.float32, 64, 197, False),
    (torch.float32, 32, 37, False)])
def test_attn_half_route_predicate(dtype, d, kv_len, want):
    """bfloat16 at head dim 16, 32 or 64 with at most 256 live keys: the
    one-shot wgmma body (kernel 9's rule with kv_len as the key count);
    more keys and float32 the streamed body of ``attention_fwd.cuh`` (the
    card tests hold the C entry's ``devt_attn_half_route`` to this)."""
    assert tfb.attn_half_on_wgmma(dtype, d, kv_len) is want
    assert want == tfa.one_shot_on_wgmma(dtype, d, kv_len)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_normalising_after_pv_is_what_the_jax_kernel_computes(kind):
    """At the MoE block's shape (S = 208, kv_len 197, 3 heads of 64, two
    sequences): the plain version, which normalises after P·V as the
    wgmma instance kernel 7 runs does, against the interpreted
    ``_attn_half_fwd_kernel`` (u, res), and its attention against JAX's
    ``_mha_fwd`` (what that kernel runs) on the same bf16 qkv.  In bf16
    the two round p at the same place and differ only where an f32 sum in
    another order crosses a rounding boundary (under 1 % of the elements),
    while normalising before P·V, kernel 9's rounding, moves a large share
    of them (40 % at this seed)."""
    dim, heads, s, kv_len, b = 192, 3, 208, 197, 2
    d = dim // heads
    scale = d ** -0.5
    jdtype, tdtype = {"f32": (jnp.float32, torch.float32),
                      "bf16": (jnp.bfloat16, torch.bfloat16)}[kind]
    rng = np.random.default_rng(7)

    def t(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = {"g1": 1.0 + t(1, dim), "b1": t(1, dim),
              "wqkv": t(dim, 3 * dim), "wo": t(dim, dim),
              "bo": t(1, dim, scale=0.01)}
    x = t(b, s, dim, scale=1.0)
    x[:, kv_len:] = 0.0
    fwd = jax.jit(lambda xx, pp: jfb._attn_half_fwd_call(
        xx, pp, heads=heads, scale=scale, kv_len=kv_len, interpret=True))
    ju, jres = fwd(jnp.asarray(x, jdtype), _jax_params(params, jdtype))
    tp = _torch_params(params, tdtype)
    u, res = tfb.fused_attn_half_fwd_plain(torch.tensor(x).to(tdtype), tp,
                                           heads, scale, kv_len)
    ju, jres = np.asarray(ju, np.float32), np.asarray(jres)
    if kind == "f32":
        np.testing.assert_allclose(u.numpy(), ju, **FWD_TOL)
        np.testing.assert_allclose(res.numpy(), jres, **FWD_TOL)
    else:
        _ulps_close(u, ju, "u")
        np.testing.assert_allclose(res.numpy(), jres, **BF16_RES_TOL)

    # the attention alone, on the port's qkv
    a = tfb._ln(torch.tensor(x).to(tdtype).float(), tp["g1"][0],
                tp["b1"][0])[0]
    qkv = tfb._mm(a, tp["wqkv"], tdtype)
    after, lse = tfb._mha_fwd(qkv, heads, d, scale, kv_len, tdtype)
    jatt, jlse = jfb._mha_fwd(jnp.asarray(qkv.numpy()), heads, d, scale,
                              kv_len, jdtype)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD_TOL)
    split = qkv.to(tdtype).view(b, s, 3, heads, d)
    q, k, v = (split[:, :, i].transpose(1, 2) for i in range(3))
    before = tfa.flash_single_fwd_plain(q, k, v, scale, kv_len)[0]
    before = before.transpose(1, 2).reshape(b, s, dim)
    if kind == "f32":
        np.testing.assert_allclose(after.numpy(), np.asarray(jatt),
                                   **FWD_TOL)
        return
    # att is stored in x's dtype: compare the bf16 values
    want = torch.tensor(np.asarray(jatt, np.float32)).to(tdtype)
    after = after.to(tdtype)
    _ulps_close(after, want.float().numpy(), "att")
    assert (after != want).float().mean().item() < 0.01
    assert (before != want).float().mean().item() > 0.1


def test_cpu_attn_half_counts_no_launch():
    """CPU tensors run kernel 7's plain version: no launch is counted, on
    either body of its attention launch, in bfloat16 (inside the rule) or
    float32."""
    half = tfb.fused_attn_half

    def counts():
        return (half.launches, half.wgmma_launches, half.streamed_launches,
                half.bwd_launches)

    before = counts()
    for tdtype in (torch.bfloat16, torch.float32):
        x, params, _ = _make(kv_len=13, seed=6)
        half(torch.tensor(x).to(tdtype), _torch_params(params, tdtype),
             HEADS, SCALE, 13)
    assert counts() == before
