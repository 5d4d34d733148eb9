"""Kernel 3's routes and packed tiling, and kernel 15's plain version at the
wgmma bodies' head dims, on the CPU.

``mha_fwd_on_wgmma`` against hand values at every head dim and the
lengths around its edges; ``mha_packed_tiling`` against hand values and,
through a plain block-diagonal reference that computes kernel 3 tile by
tile as the packed body does, against ``fused_mha_plain``; CPU calls of
``fused_mha`` and ``ring_step_bwd`` counting no launch on any body; the
plain versions against JAX's interpreted kernels at the packing's edge
shapes (B not a multiple of the sequences a tile, kv_len < S, S = 1) and
``ring_step_bwd`` with a wholly masked shard at head dims 32 and 64.

Tolerances: f32 against JAX the parity bound of ``tests/test_torch_mha.py``
(atol 2e-5 / rtol 2e-4, sums in other orders); the packed reference
against the plain version in f32 atol 1e-6 / rtol 1e-5 (the same
products, summed over 64 keys of which the masked ones add exact zeros,
against S keys) and in bf16 one bf16 ulp of o (2^-8 relative: a sum in
another order can move a rounded probability across a rounding boundary);
the ring's f32 gradients those of ``tests/test_torch_ring.py`` (5e-5), and
a wholly masked shard's exactly zero.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu_torch.ops import flash_attention as tfa

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

# ``devt_tpu.ops.flash_attention`` the attribute is a function of that name
jfa = importlib.import_module("devt_tpu.ops.flash_attention")

TOL = dict(atol=2e-5, rtol=2e-4)
GRAD_TOL = dict(atol=5e-5, rtol=1e-4)
HEAD_DIMS = (16, 32, 64, 128, 256)
LENGTHS = (1, 14, 16, 33, 64, 65, 208, 257)
# bf16 at rate 0: the lengths each head dim's wgmma route takes (kv_len =
# S); the packed body at head dims 128 and 256 up to one 64-row tile, the
# one-shot instance at 16-64 up to 256 live keys
PACKED_LENGTHS = (1, 14, 16, 33, 64)
ONE_SHOT_LENGTHS = (1, 14, 16, 33, 64, 65, 208)


def _qkv(b, s, heads, d, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, 3 * heads * d)).astype(np.float32)


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_mha_fwd_route(d, s):
    """bf16 without dropout: packed at head dims 128, 256 and S <= 64,
    one-shot at 16-64 with at most 256 live keys, else streamed; dropout and
    f32 always streamed."""
    bf16 = tfa.mha_fwd_on_wgmma(torch.bfloat16, d, s, s, 0.0)
    if d >= 128:
        assert bf16 == ("packed" if s in PACKED_LENGTHS else "streamed")
    else:
        assert bf16 == ("one_shot" if s in ONE_SHOT_LENGTHS else "streamed")
    assert tfa.mha_fwd_on_wgmma(torch.bfloat16, d, s, s, 0.5) == "streamed"
    assert tfa.mha_fwd_on_wgmma(torch.float32, d, s, s, 0.0) == "streamed"
    if s == 257 and d <= 64:   # the live keys decide, not S
        assert tfa.mha_fwd_on_wgmma(torch.bfloat16, d, s, 256, 0.0) == \
            "one_shot"


@pytest.mark.parametrize("b,s,heads,g,tiles", [
    (256, 14, 8, 4, 512), (256, 16, 8, 4, 512), (255, 14, 8, 4, 512),
    (7, 14, 2, 4, 4), (32, 14, 8, 4, 64), (3, 1, 2, 64, 2), (64, 1, 1, 64, 1),
    (5, 33, 2, 1, 10), (3, 64, 2, 1, 6), (5, 32, 3, 2, 9)])
def test_packed_tiling_hand_values(b, s, heads, g, tiles):
    got_g, got_tiles, live = tfa.mha_packed_tiling(b, s, heads, s)
    assert (got_g, got_tiles) == (g, tiles)
    assert live.shape == (64, 64) and live.dtype == torch.bool
    # every query row of the G sequences sees exactly its sequence's keys
    assert all(int(live[r].sum()) == s for r in range(g * s))


def test_packed_live_keys_hand_values():
    """S = 14, kv_len 13: four sequences a tile; a query sees the first 13
    keys of its own sequence and nothing else."""
    _, _, live = tfa.mha_packed_tiling(256, 14, 8, 13)
    assert live[0, :13].all() and not live[0, 13:].any()
    assert live[13, 0] and not live[13, 13] and not live[13, 14]
    assert live[14, 14:27].all() and not live[14, 27] and not live[14, :14].any()
    assert live[55, 42:55].all() and not live[55, 55]
    assert int(live[:56].sum()) == 56 * 13


def _packed_reference(qkv, heads, scale, kv_len):
    """Kernel 3 as the packed body computes it, tile by tile on the CPU:
    64-row tiles of 64 // S whole sequences of one head, scores over the
    tile's 64 keys under the block-diagonal mask, p / l rounded to qkv's
    dtype, P V; rows past the tile's sequences or past B S not stored."""
    b, s, f = qkv.shape
    d = f // (3 * heads)
    g, tiles, live = tfa.mha_packed_tiling(b, s, heads, kv_len)
    flat = torch.cat([qkv.reshape(b * s, f),
                      torch.zeros(64, f, dtype=qkv.dtype)])
    o = torch.zeros(b * s, heads * d, dtype=qkv.dtype)
    lse = torch.zeros(b * s, heads)
    for t in range(tiles):
        grp, h = divmod(t, heads)
        r0 = grp * g * s
        q, k, v = (flat[r0:r0 + 64, (j * heads + h) * d:(j * heads + h + 1)
                        * d].float() for j in range(3))
        sc = torch.where(live, q @ k.T * scale, torch.tensor(-torch.inf))
        m = sc.amax(-1, keepdim=True)
        p = torch.exp(sc - m)
        l = p.sum(-1, keepdim=True)
        out = (p / l).to(qkv.dtype).float() @ v
        n = min(g * s, b * s - r0)
        o[r0:r0 + n, h * d:(h + 1) * d] = out[:n].to(qkv.dtype)
        lse[r0:r0 + n, h] = (m + torch.log(l))[:n, 0]
    return o.reshape(b, s, heads * d), lse.reshape(b, s, heads)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,heads,d,kv_len", [
    (7, 14, 2, 128, 14), (7, 14, 2, 128, 11), (4, 16, 2, 256, 14),
    (3, 1, 2, 128, 1), (5, 33, 2, 128, 30), (2, 64, 1, 128, 64)])
def test_packed_reference_matches_plain(kind, b, s, heads, d, kv_len):
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[kind]
    qkv = torch.tensor(_qkv(b, s, heads, d, seed=b + s)).to(dtype)
    scale = d ** -0.5
    o, lse = _packed_reference(qkv, heads, scale, kv_len)
    want_o, want_lse = tfa.fused_mha_plain(qkv, heads, scale, kv_len)
    tol = dict(atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(lse, want_lse, **tol)
    if kind == "f32":
        torch.testing.assert_close(o, want_o, **tol)
    else:
        err = (o.float() - want_o.float()).abs().max().item()
        assert err <= 2.0 ** -8 * want_o.float().abs().max().item()


def _counts():
    m, r = tfa.fused_mha, tfa.ring_step_bwd
    return (m.launches, m.bwd_launches, m.packed_launches,
            m.one_shot_launches, m.streamed_launches, r.launches,
            r.wgmma_launches, r.streamed_launches,
            tfa.ring_step_fwd.launches)


def test_cpu_calls_count_no_launch():
    """fused_mha forward and backward on every route's shape, and one ring
    hop forward and backward: the plain versions, no launch counted."""
    before = _counts()
    for b, s, heads, d in ((5, 14, 2, 128), (2, 20, 2, 64), (2, 70, 1, 128)):
        qkv = torch.tensor(_qkv(b, s, heads, d)).to(torch.bfloat16)
        qkv.requires_grad_(True)
        tfa.fused_mha(qkv, heads=heads).float().sum().backward()
    q = torch.randn(2, 20, 64)
    kv = torch.randn(2, 20, 128)
    mask = torch.zeros(1, 20)
    o, lse = tfa.ring_step_fwd(q, kv, mask, heads=1, scale=0.125)
    tfa.ring_step_bwd(q, kv, mask, o, lse, torch.randn(2, 20, 64), heads=1,
                      scale=0.125)
    assert _counts() == before


@pytest.mark.parametrize("b,s,heads,d,kv_len", [
    (7, 14, 2, 256, 14), (7, 14, 2, 128, 11), (4, 1, 2, 128, 1),
    (3, 16, 2, 256, 13)])
def test_plain_matches_jax_at_packing_edges(b, s, heads, d, kv_len):
    """B = 7 leaves the last tile of four sequences short; kv_len < S; S = 1
    is 64 sequences a tile."""
    qkv = _qkv(b, s, heads, d, seed=s + d)
    want = jfa.fused_mha(jnp.asarray(qkv), heads=heads, kv_len=kv_len,
                         interpret=True)
    got = tfa.fused_mha(torch.tensor(qkv), heads=heads, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("live", [0, 70])
def test_ring_step_bwd_plain_matches_jax_at_wgmma_head_dims(d, live):
    """Kernel 15's plain version at the wgmma bodies' head dims, S = 100 (no
    multiple of their 64-row tiles), against the global lse of the full
    shard: a partial shard, and a wholly masked one whose f32 partials are
    exact zeros on both sides."""
    b, s, heads = 2, 100, 2
    rng = np.random.default_rng(d + live)
    q, do = (rng.standard_normal((b, s, heads * d)).astype(np.float32)
             for _ in range(2))
    kv = rng.standard_normal((b, s, 2 * heads * d)).astype(np.float32)
    tq, tkv, tdo = (torch.tensor(t) for t in (q, kv, do))
    o, lse = tfa.ring_step_fwd_plain(tq, tkv, torch.zeros(1, s), heads,
                                     d ** -0.5)
    mask = np.where(np.arange(s) < live, 0.0, jfa.NEG_INF).astype(
        np.float32)[None]
    lanes = np.repeat(lse.numpy()[..., None], 128, -1).reshape(b, s, -1)
    jdq, jdkv = jfa.ring_step_bwd(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(mask),
        jnp.asarray(o.numpy()), jnp.asarray(lanes), jnp.asarray(do),
        heads=heads, scale=d ** -0.5, interpret=True)
    dq, dkv = tfa.ring_step_bwd(tq, tkv, torch.tensor(mask), o, lse, tdo,
                                heads=heads, scale=d ** -0.5)
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), **GRAD_TOL)
    np.testing.assert_allclose(dkv.numpy(), np.asarray(jdkv), **GRAD_TOL)
    if live == 0:
        assert not dq.any() and not dkv.any()
        assert not np.asarray(jdq).any() and not np.asarray(jdkv).any()
