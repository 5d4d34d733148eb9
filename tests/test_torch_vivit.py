"""The port's whole ViViT against the JAX package's, on the CPU.

A tiny model (image 32, patch 8, 4 frames, dim 32, 2 heads × 16, depth 2):
17 space tokens pad to 32, so the space blocks take the fused path.  JAX
runs with ``attention_impl="fused_interpret"`` — the fused (tanh GELU)
math the TPU runs; on the CPU ``"auto"`` would take the erf path — and
the port with ``"auto"``, which on the CPU is the kernel's plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu.data import device_norm as jnorm
from devt_tpu.models import vivit as jv
from devt_tpu_torch.data import device_norm as tnorm
from devt_tpu_torch.models import vivit as tv
from devt_tpu_torch.utils.jax_bridge import jax_to_state_dict

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

KW = dict(image_size=32, patch_size=8, num_classes=5, num_frames=4, dim=32,
          depth=2, heads=2, dim_head=16)
# f32 logits after 2 fused + 2 unfused blocks, sums in other orders
LOGIT_TOL = dict(atol=2e-5, rtol=2e-4)


def _clip(channels_last, b=2, seed=0):
    shape = (b, 4, 32, 32, 3) if channels_last else (b, 4, 3, 32, 32)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(channels_last, pool="cls", example=None):
    jm = jv.ViViT(attention_impl="fused_interpret",
                  channels_last=channels_last, pool=pool, **KW)
    x = example if example is not None else _clip(channels_last)
    v = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))
    v = jax.tree_util.tree_map(np.asarray, v)
    tm = tv.ViViT(attention_impl="auto", channels_last=channels_last,
                  pool=pool, **KW).eval()
    tm.load_state_dict(jax_to_state_dict(v))
    return jm, v, tm


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_pixel_path_matches_jax(channels_last, pool):
    jm, v, tm = _pair(channels_last, pool)
    x = _clip(channels_last, seed=1)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


def test_tokens_path_matches_jax():
    tokens = jv.patchify(jnp.asarray(_clip(True, seed=2)), 8)
    jm, v, tm = _pair(True)
    want = np.asarray(jm.apply(v, tokens, tokens_in=True))
    with torch.no_grad():
        got = tm(torch.tensor(np.asarray(tokens)), tokens_in=True).numpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


def test_tokens_path_equals_pixel_path():
    _, _, tm = _pair(True)
    x = torch.tensor(_clip(True, seed=3))
    with torch.no_grad():
        a = tm(x)
        b = tm(tv.patchify(x, 8), tokens_in=True)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_space_blocks_run_fused_path():
    _, _, tm = _pair(True)
    padded = torch.zeros(8, 32, 32)          # 17 tokens padded to 32
    assert all(b.fused_eligible(padded) for b in tm.space_transformer.blocks)
    assert tm.temporal_transformer.blocks[0].attention_impl == "xla"


def test_patchify_matches_jax():
    x = _clip(True, seed=4)
    np.testing.assert_array_equal(
        tv.patchify(torch.tensor(x), 8).numpy(),
        np.asarray(jv.patchify(jnp.asarray(x), 8)))


@pytest.mark.parametrize("n,mult,want", [(17, 16, 32), (32, 16, 32),
                                         (197, 16, 208)])
def test_pad_tokens(n, mult, want):
    x = torch.ones(2, n, 4)
    padded, kv_len = tv._pad_tokens(x, mult)
    assert padded.shape == (2, want, 4) and kv_len == n
    assert torch.all(padded[:, n:] == 0)


@pytest.mark.parametrize("key,shape", [("vid", (2, 3, 4, 4, 3)),
                                       ("img", (2, 4, 4, 3)),
                                       ("vid_tokens", (2, 3, 5, 48))])
def test_dequantize_matches_jax(key, shape):
    u8 = np.random.default_rng(5).integers(0, 256, shape, dtype=np.uint8)
    want = jnorm.maybe_dequantize_batch({key: jnp.asarray(u8)},
                                        dtype=jnp.float32)[key]
    got = tnorm.maybe_dequantize_batch({key: torch.tensor(u8)},
                                       dtype=torch.float32)[key]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_float_batches_pass_through():
    x = torch.randn(2, 3)
    assert tnorm.maybe_dequantize_batch({"vid": x})["vid"] is x
