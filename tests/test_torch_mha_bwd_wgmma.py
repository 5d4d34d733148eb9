"""Kernel 4's routes and the packed backward body's tiling, on the CPU.

``mha_bwd_on_wgmma`` against hand values at the edges of its rule; a plain
tile-by-tile decomposition of what the packed body computes (64-row tiles
of max(1, 32 // S) whole sequences of one head, the block-diagonal mask,
the
key-major products Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, delta from the tile's o and
do rows, the output column groups of each CTA of a split tile, keep bits
gathered by (b0 + r // S, h, r % S, c % S) from a given mask) against
``fused_mha_bwd_plain`` and against JAX's ``_mha_bwd_call(interpret=True)``
at the packing's edges (S = 1, 13, 14, 16, 33, 64; B no multiple of the
sequences a tile; kv_len < S) at head dims 128 and 256; CPU calls counting
no launch on any body.

Tolerances: f32 sums in other orders, the parity bound of the other port
tests (atol 2e-5 / rtol 2e-4); bf16 4 ulps (2^-8 each) of the largest
element per tensor, the backward bound of ``tests/test_torch_mha_bwd.py``
and the card tests: the same roundings, where an f32 sum next to a bf16
rounding boundary lands on its other side and moves what it feeds by an
ulp.  JAX's in-kernel dropout has no CPU lowering, so at rate 0.5 the
decomposition is held to the plain version given the same mask.
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
BF16_ULPS, BF16_EPS = 4, 2.0 ** -8
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# (b, s, heads, d, kv_len): S = 1 (32 sequences a tile, B = 70 past two
# tiles), 13 and 14 (2 a tile, B = 7 and 9 leave the last tile short), 16
# with kv_len < S, 33 (one a tile, 31 rows unused), 64 (one a tile, full)
EDGES = [(70, 1, 1, 128, 1), (7, 13, 2, 128, 13), (9, 14, 2, 256, 11),
         (5, 16, 2, 128, 9), (3, 33, 2, 256, 30), (2, 64, 1, 128, 64),
         (2, 64, 1, 256, 50)]


def _arrays(b, s, heads, d, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, s, 3 * heads * d)).astype(np.float32)
    do = rng.standard_normal((b, s, heads * d)).astype(np.float32)
    return qkv, do


def _close(kind, got, want, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if kind == "f32":
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)
        return
    err = np.abs(got - want).max()
    bound = BF16_ULPS * BF16_EPS * np.abs(want).max()
    assert err <= bound, f"{what}: {err:.3e} > {bound:.3e}"


def _dqkv_close(kind, got, want, heads, d):
    for i, name in enumerate(("dq", "dk", "dv")):
        cols = slice(i * heads * d, (i + 1) * heads * d)
        _close(kind, got[..., cols], want[..., cols], name)


@pytest.mark.parametrize("dtype,d,s,kv_len,rate,body", [
    (torch.bfloat16, 256, 1, 1, 0.0, "packed"),
    (torch.bfloat16, 256, 64, 64, 0.5, "packed"),
    (torch.bfloat16, 256, 65, 65, 0.0, "streamed"),
    (torch.bfloat16, 128, 1, 1, 0.5, "packed"),
    (torch.bfloat16, 128, 64, 33, 0.0, "packed"),
    (torch.bfloat16, 128, 65, 60, 0.5, "streamed"),
    (torch.bfloat16, 64, 1, 1, 0.0, "wgmma"),
    (torch.bfloat16, 64, 65, 65, 0.5, "wgmma"),
    (torch.bfloat16, 64, 208, 197, 0.5, "wgmma"),
    (torch.bfloat16, 32, 64, 64, 0.0, "wgmma"),
    (torch.bfloat16, 32, 512, 509, 0.5, "wgmma"),
    (torch.bfloat16, 16, 14, 14, 0.0, "wgmma"),
    (torch.float32, 256, 14, 14, 0.0, "streamed"),
    (torch.float32, 64, 208, 197, 0.5, "streamed"),
    (torch.float32, 128, 64, 64, 0.5, "streamed")])
def test_mha_bwd_route(dtype, d, s, kv_len, rate, body):
    """bf16: the packed body at head dims 128 and 256 up to S = 64, kernels
    12's and 13's bodies at 16-64 at every length, at every rate; f32 and
    the wide heads past one tile stay streamed."""
    assert tfa.mha_bwd_on_wgmma(dtype, d, s, kv_len, rate) == body


@pytest.mark.parametrize("b,s,heads,g,tiles", [
    (32, 14, 8, 2, 128), (7, 14, 2, 2, 8), (9, 13, 2, 2, 10),
    (70, 1, 1, 32, 3), (3, 33, 2, 1, 6), (2, 64, 1, 1, 2), (5, 32, 3, 1, 15),
    (5, 16, 2, 2, 6)])
def test_packed_bwd_tiling_hand_values(b, s, heads, g, tiles):
    got_g, got_tiles, split, live = tfa.mha_bwd_packed_tiling(b, s, heads, s)
    assert (got_g, got_tiles) == (g, tiles)
    assert split >= 1 and live.shape == (64, 64) and live.dtype == torch.bool
    # the forward's tiling: every query of the G sequences sees its own
    # sequence's keys, and the mask is the forward's
    assert all(int(live[r].sum()) == s for r in range(g * s))
    assert torch.equal(live, tfa.mha_packed_tiling(b, s, heads, s)[2])


def _packed_bwd_reference(qkv, o, lse, do, heads, scale, kv_len, keep=None,
                          rate=0.0):
    """Kernel 4 as the packed body computes it, tile by tile: per (group,
    head) tile the 64 query and key rows of G whole sequences, delta from
    the tile's o and do rows, key-major Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, pᵀ =
    exp(sᵀ - lse) under the block-diagonal mask (lse +inf past the tile's
    sequences), the keep bits of (b0 + r // S, h, r % S, c % S), dsᵀ =
    pᵀ (dPᵀ mask - delta) scale, pᵀ mask and dsᵀ rounded to qkv's dtype,
    then per 64-column group of each CTA of the split tile dV = (P mask)ᵀ
    dO, dK = dSᵀ Q, dQ = dS K; rows past the tile's sequences or past B S
    not stored, dk and dv of keys past kv_len zeros."""
    b, s, f = qkv.shape
    d = f // (3 * heads)
    dtype = qkv.dtype
    g, tiles, split, live = tfa.mha_bwd_packed_tiling(b, s, heads, kv_len)
    split = min(split, d // 64)
    pad = lambda t: torch.cat([t.reshape(b * s, -1),  # noqa: E731
                               torch.zeros(64, t.shape[-1], dtype=t.dtype)])
    fq, fo, fdo = pad(qkv), pad(o), pad(do)
    flse = torch.cat([lse.reshape(b * s, heads),
                      torch.zeros(64, heads)])
    out = torch.zeros(b * s, f, dtype=dtype)
    idx = torch.arange(64)
    for t in range(tiles):
        grp, h = divmod(t, heads)
        r0 = grp * g * s
        n = min(g * s, b * s - r0)        # the tile's stored rows
        q, k, v = (fq[r0:r0 + 64, (j * heads + h) * d:(j * heads + h + 1)
                      * d].float() for j in range(3))
        ot, dot = (x[r0:r0 + 64, h * d:(h + 1) * d].float()
                   for x in (fo, fdo))
        lq = torch.where(idx < n, flse[r0:r0 + 64, h], torch.inf)
        delta = (dot * ot).sum(-1)
        lt = live.T                                   # [key c, query r]
        pt = torch.where(lt, torch.exp(k @ q.T * scale - lq[None]), 0.0)
        dpt = v @ dot.T
        if keep is not None:
            # keep bit of (query r, key c): sequence b0 + r // S of the tile
            seq = (grp * g + idx // s).clamp(max=b - 1)
            bits = keep[seq[None, :], h, (idx % s)[None, :],
                        (idx % s)[:, None]]
            m = torch.where(lt & bits, 1.0 / (1.0 - rate), 0.0)
            dst = pt * (dpt * m - delta[None]) * scale
            pt = pt * m
        else:
            dst = pt * (dpt - delta[None]) * scale
        pm = pt.to(dtype).float()
        ds = dst.to(dtype).float()
        on = (idx % s < kv_len)[:n, None]
        for part in range(split):
            for box in range(part * (d // 64) // split,
                             (part + 1) * (d // 64) // split):
                cols = slice(64 * box, 64 * box + 64)
                dv = pm @ dot[:, cols]
                dk = ds @ q[:, cols]
                dq = ds.T @ k[:, cols]
                for j, x in ((0, dq), (1, torch.where(on, dk[:n], 0.0)),
                             (2, torch.where(on, dv[:n], 0.0))):
                    c0 = (j * heads + h) * d + 64 * box
                    out[r0:r0 + n, c0:c0 + 64] = x[:n].to(dtype)
    return out.reshape(b, s, f)


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,heads,d,kv_len", EDGES)
def test_packed_decomposition_matches_plain(kind, b, s, heads, d, kv_len,
                                            rate):
    """The tile-by-tile decomposition against ``fused_mha_bwd_plain`` from
    the plain forward's (o, lse), the same mask given to both."""
    dtype = DTYPES[kind]
    qkv, do = (torch.tensor(x).to(dtype)
               for x in _arrays(b, s, heads, d, seed=b + s + d))
    keep = tfa.mha_dropout_masks(31, rate, b, s, heads, "cpu") \
        if rate > 0.0 else None
    scale = d ** -0.5
    o, lse = tfa.fused_mha_plain(qkv, heads, scale, kv_len, keep, rate)
    got = _packed_bwd_reference(qkv, o, lse, do, heads, scale, kv_len, keep,
                                rate)
    want = tfa.fused_mha_bwd_plain(qkv, o, lse, do, heads, scale, kv_len,
                                   keep, rate)
    _dqkv_close(kind, got.float().numpy(), want.float().numpy(), heads, d)
    dead = got.reshape(b, s, 3, heads * d)[:, kv_len:, 1:]
    assert torch.equal(dead, torch.zeros_like(dead))


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,heads,d,kv_len", [
    (7, 14, 2, 256, 11), (70, 1, 1, 128, 1), (7, 13, 2, 128, 13),
    (5, 16, 2, 128, 9), (3, 33, 2, 256, 30), (2, 64, 1, 256, 50)])
def test_packed_decomposition_matches_jax_kernel_interpret(kind, b, s, heads,
                                                           d, kv_len):
    """The decomposition from JAX's own (o, lse) against JAX's interpreted
    backward kernel (S padded to 16, as its wrapper pads)."""
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[kind]
    qkv, do = _arrays(b, s, heads, d, seed=s + d)
    s_p = -(-s // 16) * 16
    padw = ((0, 0), (0, s_p - s), (0, 0))
    jq = jnp.asarray(np.pad(qkv, padw), jdt)
    jdo = jnp.asarray(np.pad(do, padw), jdt)
    seed = jnp.zeros((1,), jnp.int32)
    kw = dict(heads=heads, d=d, scale=d ** -0.5, kv_len=kv_len, rate=0.0,
              interpret=True)
    jo, jlse = jfa._mha_fwd(jq, seed, **kw)
    want = np.asarray(jfa._mha_bwd_call(jq, seed, jo, jlse, jdo, **kw)[:, :s],
                      np.float32)
    dtype = DTYPES[kind]
    o = torch.tensor(np.asarray(jo[:, :s], np.float32)).to(dtype)
    lse = torch.tensor(np.asarray(jlse).reshape(b, s_p, heads, 128)
                       [:, :s, :, 0].copy())
    got = _packed_bwd_reference(torch.tensor(qkv).to(dtype), o, lse,
                                torch.tensor(do).to(dtype), heads, d ** -0.5,
                                kv_len).float().numpy()
    if s > 1:
        _dqkv_close(kind, got, want, heads, d)
        return
    # one key: p = 1 and o = v, so ds = dp - delta is 0 in exact arithmetic
    # and dq, dk are the noise of two f32 sums of d terms, on both sides;
    # they are held to that bound (d ulps of f32 at the largest term, twice,
    # through scale and the largest q or k), dv to the 4 ulps
    hd = heads * d
    _close(kind, got[..., 2 * hd:], want[..., 2 * hd:], "dv")
    noise = (2 * d * 2.0 ** -24 * np.abs(do).max() * np.abs(qkv).max() ** 2
             * d ** -0.5)
    assert np.abs(got[..., :2 * hd] - want[..., :2 * hd]).max() <= noise


def _bwd_counts():
    m = tfa.fused_mha
    return (m.bwd_launches, m.bwd_packed_launches, m.bwd_wgmma_launches,
            m.bwd_streamed_launches, m.launches)


def test_cpu_backward_counts_no_launch():
    """fused_mha through autograd on a shape of each backward route, with
    and without dropout: the plain versions, no launch counted on any
    body."""
    before = _bwd_counts()
    for b, s, heads, d in ((5, 14, 2, 128), (2, 20, 2, 64), (2, 70, 1, 128)):
        for rate in (0.0, 0.5):
            qkv = torch.tensor(_arrays(b, s, heads, d)[0]).to(torch.bfloat16)
            qkv.requires_grad_(True)
            tfa.fused_mha(qkv, heads=heads, dropout_rate=rate,
                          seed=3).float().sum().backward()
            assert qkv.grad is not None and torch.isfinite(
                qkv.grad.float()).all()
    assert _bwd_counts() == before


def test_backward_check_takes_the_routes_shared_memory():
    """The argument check counts the shared memory of the route a shape
    takes: the packed body's five 64-row tiles at head dim 256 fit a
    block, and the streamed body's rows are still checked past S = 64."""
    packed = torch.zeros(32, 14, 3 * 8 * 256, dtype=torch.bfloat16)
    assert tfa._check_mha_args(packed, 8, 14, backward=True) == 256
    assert tfa._mha_bwd_wgmma_smem("packed", 256) <= tfa._SMEM_PER_BLOCK
    assert tfa._mha_bwd_wgmma_smem("wgmma", 64) <= tfa._SMEM_PER_BLOCK
    vit = torch.zeros(2, 208, 3 * 3 * 64, dtype=torch.bfloat16)
    assert tfa._check_mha_args(vit, 3, 197, backward=True) == 64
    longest = torch.zeros(1, 512, 3 * 256, dtype=torch.bfloat16)
    assert tfa._check_mha_args(longest, 1, 512, backward=True) == 256
