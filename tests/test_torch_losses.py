"""The port's losses against the JAX package's, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu.models import losses as jl
from devt_tpu_torch.models import losses as tl

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

# f32 elementwise math and one mean over at most 152 terms
TOL = dict(atol=1e-6, rtol=1e-5)


def _logits(seed, shape=(8, 19), scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _multi_hot(seed, shape=(8, 19)):
    return (np.random.default_rng(seed).random(shape) < 0.3).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bce_with_logits_matches_jax(dtype):
    x, t = _logits(0), _multi_hot(1)
    want = jl.bce_with_logits(jnp.asarray(x, dtype), jnp.asarray(t))
    got = tl.bce_with_logits(torch.tensor(x).to(getattr(torch, dtype)),
                             torch.tensor(t))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bce_with_logits_is_stable_at_large_logits():
    x = np.array([[80.0, -80.0, 0.0]], np.float32)
    t = np.array([[1.0, 0.0, 1.0]], np.float32)
    want = jl.bce_with_logits(jnp.asarray(x), jnp.asarray(t))
    got = tl.bce_with_logits(torch.tensor(x), torch.tensor(t))
    assert torch.isfinite(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bce_matches_jax_and_clips():
    p = 1.0 / (1.0 + np.exp(-_logits(2)))
    p[0, :2] = [0.0, 1.0]                      # clipped to [eps, 1 - eps]
    t = _multi_hot(3)
    want = jl.bce(jnp.asarray(p), jnp.asarray(t))
    got = tl.bce(torch.tensor(p), torch.tensor(t))
    assert torch.isfinite(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_jax(dtype):
    x = _logits(4)
    y = np.random.default_rng(5).integers(0, 19, 8).astype(np.int32)
    want = jl.cross_entropy(jnp.asarray(x, dtype), jnp.asarray(y))
    got = tl.cross_entropy(torch.tensor(x).to(getattr(torch, dtype)),
                           torch.tensor(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_loss_gradients_match_jax():
    import jax

    x, t = _logits(6), _multi_hot(7)
    y = np.random.default_rng(8).integers(0, 19, 8).astype(np.int32)
    tx = torch.tensor(x, requires_grad=True)
    tl.bce_with_logits(tx, torch.tensor(t)).backward()
    want = jax.grad(lambda v: jl.bce_with_logits(v, jnp.asarray(t)))(
        jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), **TOL)
    tx = torch.tensor(x, requires_grad=True)
    tl.cross_entropy(tx, torch.tensor(y)).backward()
    want = jax.grad(lambda v: jl.cross_entropy(v, jnp.asarray(y)))(
        jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), **TOL)
