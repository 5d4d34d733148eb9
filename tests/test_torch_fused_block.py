"""The port's fused ViT-block forward against the JAX Pallas kernel.

``fused_vit_block_fwd_plain`` (the plain PyTorch version of the CUDA
kernel) is held against ``devt_tpu.ops.fused_block._fwd_call`` run in
interpret mode on the CPU, on the same numpy inputs: all three outputs
(y, u and the residual lanes).  The CUDA kernel itself is held against the
plain version on the card in ``tests/test_torch_cuda.py``.
"""

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
# f32: the JAX package's own forward bound (tests/test_fused_block.py)
F32_TOL = dict(atol=2e-5, rtol=2e-4)
# bf16: both round at the same places; a sum that lands on the other side
# of a bf16 rounding boundary moves one stored element by an ulp (2^-8
# relative), which y and u then carry
BF16_TOL = dict(atol=1e-2, rtol=1.6e-2)
BF16_RES_TOL = dict(atol=1e-3, rtol=1e-3)


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
    return x, params


def _jax_fwd(x, params, kv_len, dtype):
    jp = {k: jnp.asarray(v, dtype if k in tfb._MATRICES else jnp.float32)
          for k, v in params.items()}
    out = jfb._fwd_call(jnp.asarray(x, dtype), jp, jnp.zeros((1,), jnp.int32),
                        heads=HEADS, scale=SCALE, kv_len=kv_len, rate=0.0,
                        interpret=True)
    return [np.asarray(o, np.float32) for o in out]


def _torch_params(params, dtype):
    return {k: torch.tensor(v).to(dtype if k in tfb._MATRICES
                                  else torch.float32)
            for k, v in params.items()}


@pytest.mark.parametrize("kv_len", [16, 13])
def test_plain_matches_jax_kernel_f32(kv_len):
    x, params = _make(kv_len=kv_len)
    want = _jax_fwd(x, params, kv_len, jnp.float32)
    got = tfb.fused_vit_block_fwd_plain(
        torch.tensor(x), _torch_params(params, torch.float32), HEADS, SCALE,
        kv_len)
    for name, g, w in zip(("y", "u", "res"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **F32_TOL)


@pytest.mark.parametrize("kv_len", [16, 13])
def test_plain_matches_jax_kernel_bf16(kv_len):
    x, params = _make(kv_len=kv_len, seed=1)
    want = _jax_fwd(x, params, kv_len, jnp.bfloat16)
    got = tfb.fused_vit_block_fwd_plain(
        torch.tensor(x).to(torch.bfloat16),
        _torch_params(params, torch.bfloat16), HEADS, SCALE, kv_len)
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    assert got[2].dtype == torch.float32
    for name, g, w in zip(("y", "u"), got, want):
        np.testing.assert_allclose(g.float().numpy(), w, err_msg=name,
                                   **BF16_TOL)
    np.testing.assert_allclose(got[2].numpy(), want[2], **BF16_RES_TOL)


def test_residual_lanes_layout():
    """[lse (H), mu1, rstd1, mu2, rstd2] then zeros to 8 lanes; zero pad
    rows give rstd1 = 1/sqrt(eps) and stay finite."""
    kv_len = 13
    x, params = _make(kv_len=kv_len)
    y, u, res = tfb.fused_vit_block_fwd_plain(
        torch.tensor(x), _torch_params(params, torch.float32), HEADS, SCALE,
        kv_len)
    assert res.shape == (4, 16, 8)
    assert torch.all(res[..., HEADS + 4:] == 0)
    np.testing.assert_allclose(res[:, kv_len:, HEADS + 1].numpy(),
                               1e-5 ** -0.5, rtol=1e-6)
    assert torch.isfinite(y).all() and torch.isfinite(u).all()


def test_reference_block_matches_jax():
    x, params = _make(kv_len=13, seed=2)
    want = jfb.reference_vit_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()},
        HEADS, SCALE, 13)
    got = tfb.reference_vit_block(torch.tensor(x),
                                  _torch_params(params, torch.float32),
                                  HEADS, SCALE, 13)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_wrapper_runs_plain_version_for_cpu_tensors():
    x, params = _make(kv_len=13, seed=3)
    tx, tp = torch.tensor(x), _torch_params(params, torch.float32)
    before = tfb.fused_vit_block.launches
    got = tfb.fused_vit_block(tx, tp, HEADS, SCALE, 13)
    want = tfb.fused_vit_block_fwd_plain(tx, tp, HEADS, SCALE, 13)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tfb.fused_vit_block.launches == before   # no kernel launched


def test_wrapper_refuses_dropout():
    """Dropout without a seed is refused: the caller draws the seed, so
    that the forward and the backward of one call share it."""
    x, params = _make()
    with pytest.raises(ValueError, match="needs a seed"):
        tfb.fused_vit_block(torch.tensor(x),
                            _torch_params(params, torch.float32), HEADS,
                            SCALE, 16, dropout_rate=0.1)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        tfb.fused_vit_block(torch.tensor(x),
                            _torch_params(params, torch.float32), HEADS,
                            SCALE, 16, dropout_rate=1.0, seed=1)
