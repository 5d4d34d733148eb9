"""The fused ViT block where the card's wgmma body (``csrc/block_sm90.cuh``)
has its edges, on the CPU.

The block's bf16 products run in 128-row tiles (two warpgroups of 64 rows)
and the forward's attention takes the one-shot wgmma body up to 256 live
keys.  Here, with no card: the Python mirror of that attention route at
its edges, and the plain forward and backward (what the kernels are held
to on the card, ``tests/test_torch_cuda.py``) against the JAX Pallas
kernels in interpret mode where the tiles have edges: B·S not a multiple
of 128, one live key, every key live, both bf16 widths the kernels are
compiled for.
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

# the forward gate of tests/test_torch_fused_block.py: both round at the
# same places, a sum on the other side of a bf16 boundary moves an ulp
BF16_TOL = dict(atol=1e-2, rtol=1.6e-2)
BF16_RES_TOL = dict(atol=1e-3, rtol=1e-3)
# the backward gate the kernels are held to on the card (chip_smoke.py,
# tests/test_torch_cuda.py): 4 x 2^-8 of each tensor's largest element.
# Both sides round at the same places but sum in other orders, and at dim
# 192 dx reaches 12.8, where one bf16 ulp (2^-4) is 1.25 x 2^-8 of it.
BF16_ULPS = 4
# (dim, heads, B, S, kv_len): 3 x 48 = 144 and 5 x 32 = 160 rows, one
# 128-row tile and a partial one; one live key and every key live; the
# widths of _BF16_WIDTHS, (192, 64) and (64, 32)
EDGES = [(64, 2, 3, 48, 1), (64, 2, 3, 48, 48), (64, 2, 5, 32, 17),
         (192, 3, 3, 48, 1), (192, 3, 3, 48, 48)]
MLP = 128

_kw = ("heads", "scale", "kv_len", "rate", "interpret")
_jax_fwd = jax.jit(jfb._fwd_call, static_argnames=_kw)
_jax_bwd = jax.jit(jfb._bwd_call, static_argnames=_kw)


def _make(dim, b, s, kv_len, seed):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = {
        "g1": 1.0 + t(1, dim), "b1": t(1, dim),
        "wqkv": t(dim, 3 * dim), "wo": t(dim, dim),
        "bo": t(1, dim, scale=0.01),
        "g2": 1.0 + t(1, dim), "b2": t(1, dim),
        "w1": t(dim, MLP), "bb1": t(1, MLP, scale=0.01),
        "w2": t(MLP, dim), "bb2": t(1, dim, scale=0.01),
    }
    x = t(b, s, dim, scale=1.0)
    x[:, kv_len:] = 0.0          # pad rows as the model pads them
    dy = t(b, s, dim, scale=1.0)
    return x, params, dy


def _jax_params(params):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in tfb._MATRICES
                           else jnp.float32) for k, v in params.items()}


def _torch_params(params):
    return {k: torch.tensor(v).to(torch.bfloat16 if k in tfb._MATRICES
                                  else torch.float32)
            for k, v in params.items()}


def _to_t(a):
    return torch.tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("dtype,head_dim,kv_len,want", [
    (torch.bfloat16, 64, 256, True), (torch.bfloat16, 64, 257, False),
    (torch.bfloat16, 32, 256, True), (torch.bfloat16, 32, 257, False),
    (torch.bfloat16, 64, 1, True), (torch.float32, 64, 197, False),
    (torch.float32, 32, 256, False), (torch.bfloat16, 128, 197, False)])
def test_block_attention_route_at_its_edges(dtype, head_dim, kv_len, want):
    """Kernel 1's attention launch takes the one-shot wgmma body in bf16
    at head dims 16-64 with at most 256 live keys (kernel 9's rule with
    kv_len as the key count, as kernel 7's), else attention_fwd.cuh's."""
    assert tfb.attn_half_on_wgmma(dtype, head_dim, kv_len) is want


@pytest.mark.parametrize("dim,heads,b,s,kv_len", EDGES)
def test_plain_forward_matches_jax_at_tile_edges(dim, heads, b, s, kv_len):
    x, params, _ = _make(dim, b, s, kv_len, seed=b * s + kv_len)
    scale = (dim // heads) ** -0.5
    want = _jax_fwd(jnp.asarray(x, jnp.bfloat16), _jax_params(params),
                    jnp.zeros((1,), jnp.int32), heads=heads, scale=scale,
                    kv_len=kv_len, rate=0.0, interpret=True)
    got = tfb.fused_vit_block_fwd_plain(
        torch.tensor(x).to(torch.bfloat16), _torch_params(params), heads,
        scale, kv_len)
    for name, g, w in zip(("y", "u"), got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), err_msg=name,
                                   **BF16_TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               **BF16_RES_TOL)


@pytest.mark.parametrize("dim,heads,b,s,kv_len", EDGES)
def test_plain_backward_matches_jax_at_tile_edges(dim, heads, b, s, kv_len):
    """The plain backward from the JAX forward's (u, res) against the JAX
    backward kernel: dx and the 11 gradients, each within BF16_ULPS x
    2^-8 of its largest element."""
    x, params, dy = _make(dim, b, s, kv_len, seed=7 * b + kv_len)
    scale = (dim // heads) ** -0.5
    kw = dict(heads=heads, scale=scale, kv_len=kv_len, rate=0.0,
              interpret=True)
    jp, zero = _jax_params(params), jnp.zeros((1,), jnp.int32)
    jx, jdy = jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16)
    _, ju, jres = _jax_fwd(jx, jp, zero, **kw)
    jdx, jgrads = _jax_bwd(jx, jp, zero, ju, jres, jdy, **kw)
    tdx, tgrads = tfb.fused_vit_block_bwd_plain(
        _to_t(jx).to(torch.bfloat16), _torch_params(params),
        _to_t(ju).to(torch.bfloat16), _to_t(jres),
        _to_t(jdy).to(torch.bfloat16), heads, scale, kv_len)
    pairs = [("dx", tdx, jdx)] + [(k, tgrads[k], jgrads[k])
                                  for k in tfb.PARAM_NAMES]
    for name, got, want in pairs:
        want = np.asarray(want, np.float32)
        got = got.float().numpy().reshape(want.shape)
        bound = BF16_ULPS * 2.0 ** -8 * np.abs(want).max()
        assert np.abs(got - want).max() <= bound, \
            f"{name}: {np.abs(got - want).max()} > {bound}"
