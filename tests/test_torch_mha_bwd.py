"""The port's packed-qkv attention backward and its dropout against the
JAX package's, on the CPU.

``fused_mha_bwd_plain`` against ``_mha_bwd_call(interpret=True)`` (the
Pallas backward kernel in interpret mode) given the same (qkv, o, lse, do),
and autograd through ``FusedMHA`` against ``jax.vjp`` / ``jax.grad`` of
``fused_mha(interpret=True)``, from the same numpy arrays.  Tolerances: f32
sums in other orders, the parity bound of the other port tests (atol 2e-5 /
rtol 2e-4); bf16 with the same roundings, where an f32 sum next to a bf16
rounding boundary lands on its other side and moves what it feeds by an
ulp: 4 ulps (2^-8 each) of the largest element per tensor, the backward
bound of the card tests.

JAX's in-kernel dropout cannot run on the CPU (the TPU PRNG has no CPU
lowering), so the dropout path is held against a jnp reference in this
file that applies the same supplied mask.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu_torch.ops import flash_attention as tfa
from devt_tpu_torch.ops import fused_block as tfb

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

# ``devt_tpu.ops.flash_attention`` the attribute is a function of that name
jfa = importlib.import_module("devt_tpu.ops.flash_attention")

TOL = dict(atol=2e-5, rtol=2e-4)
BF16_ULPS, BF16_EPS = 4, 2.0 ** -8
# (b, s, heads, d, kv_len): kv_len < S, S no multiple of 16, d 32 and 64;
# the packed backward body's head dims 128 and 256 at PTN's S = 14;
# FrameTransformer's 2 heads of 448 over 14 tokens and 4 of 224 over 15
SHAPES = [(2, 14, 2, 32, 11), (2, 23, 3, 64, 19), (3, 16, 2, 64, 16),
          (2, 14, 2, 128, 14), (3, 14, 1, 256, 12),
          (2, 14, 2, 448, 14), (2, 14, 2, 448, 11), (2, 15, 4, 224, 15),
          (2, 15, 4, 224, 12)]


def _arrays(b, s, heads, d, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, s, 3 * heads * d)).astype(np.float32)
    do = rng.standard_normal((b, s, heads * d)).astype(np.float32)
    return qkv, do


def _jax_fwd_bwd(qkv, do, heads, d, kv_len, dtype):
    """JAX's interpreted kernels on S padded to 16, as its wrapper pads:
    (o, lse (B, S, H) from lane 0, dqkv), unpadded, as numpy f32."""
    b, s, _ = qkv.shape
    s_p = -(-s // 16) * 16
    pad = ((0, 0), (0, s_p - s), (0, 0))
    jq = jnp.asarray(np.pad(qkv, pad), dtype)
    jdo = jnp.asarray(np.pad(do, pad), dtype)
    seed = jnp.zeros((1,), jnp.int32)
    kw = dict(heads=heads, d=d, scale=d ** -0.5, kv_len=kv_len, rate=0.0,
              interpret=True)
    o, lse = jfa._mha_fwd(jq, seed, **kw)
    dqkv = jfa._mha_bwd_call(jq, seed, o, lse, jdo, **kw)
    lse = np.asarray(lse).reshape(b, s_p, heads, 128)[:, :s, :, 0]
    return (np.asarray(o[:, :s], np.float32), lse,
            np.asarray(dqkv[:, :s], np.float32))


def _close(kind, got, want, err_msg=""):
    """f32: TOL; bf16: 4 ulps of the largest element per tensor."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if kind == "f32":
        np.testing.assert_allclose(got, want, err_msg=err_msg, **TOL)
        return
    err = np.abs(got - want).max()
    bound = BF16_ULPS * BF16_EPS * np.abs(want).max()
    assert err <= bound, f"{err_msg}: {err:.3e} > {bound:.3e}"


def _dqkv_close(kind, got, want, heads, d):
    for i, name in enumerate(("dq", "dk", "dv")):
        cols = slice(i * heads * d, (i + 1) * heads * d)
        _close(kind, got[..., cols], want[..., cols], name)


DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,heads,d,kv_len", SHAPES)
def test_bwd_plain_matches_jax_kernel_interpret(kind, b, s, heads, d,
                                                kv_len):
    """The plain backward from JAX's own (o, lse): only the backward is
    compared.  Keys at or past kv_len get exact zeros."""
    jdt, tdt = DTYPES[kind]
    qkv, do = _arrays(b, s, heads, d)
    o, lse, want = _jax_fwd_bwd(qkv, do, heads, d, kv_len, jdt)
    got = tfa.fused_mha_bwd_plain(
        torch.tensor(qkv).to(tdt), torch.tensor(o).to(tdt),
        torch.tensor(lse), torch.tensor(do).to(tdt), heads, d ** -0.5,
        kv_len)
    assert got.dtype == tdt and got.shape == qkv.shape
    _dqkv_close(kind, got.float().numpy(), want, heads, d)
    dead = got.reshape(b, s, 3, heads * d)[:, kv_len:, 1:]
    assert torch.equal(dead, torch.zeros_like(dead))


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,heads,d,kv_len", SHAPES[:2])
def test_autograd_matches_jax_vjp(kind, b, s, heads, d, kv_len):
    """``torch.autograd`` through ``FusedMHA`` (the plain forward and
    backward on CPU tensors) against ``jax.vjp`` of the JAX wrapper."""
    jdt, tdt = DTYPES[kind]
    qkv, do = _arrays(b, s, heads, d, seed=1)
    out, vjp = jax.vjp(
        lambda x: jfa.fused_mha(x, heads=heads, kv_len=kv_len,
                                interpret=True), jnp.asarray(qkv, jdt))
    (want,) = vjp(jnp.asarray(do, jdt))
    leaf = torch.tensor(qkv).to(tdt).requires_grad_(True)
    got_o = tfa.fused_mha(leaf, heads=heads, kv_len=kv_len)
    (got,) = torch.autograd.grad(got_o, leaf, torch.tensor(do).to(tdt))
    _close(kind, got_o.detach().float().numpy(), np.asarray(out, np.float32),
           "o")
    _dqkv_close(kind, got.float().numpy(), np.asarray(want, np.float32),
                heads, d)


def test_autograd_matches_jax_grad_of_a_loss():
    """A scalar loss through the packed attention: ``jax.grad`` against
    ``torch.autograd.grad``, f32."""
    b, s, heads, d, kv_len = 2, 14, 2, 32, 12
    qkv, w = _arrays(b, s, heads, d, seed=2)

    def jloss(x):
        o = jfa.fused_mha(x, heads=heads, kv_len=kv_len, interpret=True)
        return jnp.sum(jnp.tanh(o) * w)

    want = jax.grad(jloss)(jnp.asarray(qkv))
    leaf = torch.tensor(qkv, requires_grad=True)
    loss = (torch.tanh(tfa.fused_mha(leaf, heads=heads, kv_len=kv_len))
            * torch.tensor(w)).sum()
    (got,) = torch.autograd.grad(loss, leaf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --- dropout: a jnp reference that takes the mask ---------------------------

def _jnp_fwd(qkv, keep, rate, heads, d, kv_len):
    """``_mha_fwd_kernel``'s body with a supplied keep mask (B, H, S, S)."""
    s = qkv.shape[1]
    col = jnp.arange(s)
    outs = []
    for i in range(heads):
        q = qkv[:, :, i * d:(i + 1) * d]
        k = qkv[:, :, (heads + i) * d:(heads + i + 1) * d]
        v = qkv[:, :, (2 * heads + i) * d:(2 * heads + i + 1) * d]
        sc = jnp.einsum("bqd,bkd->bqk", q, k,
                        preferred_element_type=jnp.float32) * d ** -0.5
        sc = jnp.where(col < kv_len, sc, jfa.NEG_INF)
        p = jnp.exp(sc - sc.max(-1, keepdims=True))
        pn = p / p.sum(-1, keepdims=True)
        pn = jnp.where(keep[:, i], pn / (1.0 - rate), 0.0)
        outs.append(jnp.einsum("bqk,bkd->bqd", pn.astype(v.dtype), v,
                               preferred_element_type=jnp.float32)
                    .astype(qkv.dtype))
    return jnp.concatenate(outs, axis=-1)


def _jnp_bwd(qkv, o, lse, do, keep, rate, heads, d, kv_len):
    """``_mha_bwd_kernel``'s body with a supplied keep mask; lse (B, S, H)."""
    s = qkv.shape[1]
    col = jnp.arange(s)
    f32 = jnp.float32
    mm = dict(preferred_element_type=f32)
    dqs, dks, dvs = [], [], []
    for i in range(heads):
        q = qkv[:, :, i * d:(i + 1) * d]
        k = qkv[:, :, (heads + i) * d:(heads + i + 1) * d]
        v = qkv[:, :, (2 * heads + i) * d:(2 * heads + i + 1) * d]
        doi, oi = do[:, :, i * d:(i + 1) * d], o[:, :, i * d:(i + 1) * d]
        delta = jnp.sum(doi.astype(f32) * oi.astype(f32), -1, keepdims=True)
        sc = jnp.einsum("bqd,bkd->bqk", q, k, **mm) * d ** -0.5
        sc = jnp.where(col < kv_len, sc, jfa.NEG_INF)
        p = jnp.exp(sc - lse[:, :, i:i + 1])
        mask = jnp.where(keep[:, i], 1.0 / (1.0 - rate), 0.0)
        dvs.append(jnp.einsum("bqk,bqd->bkd", (p * mask).astype(do.dtype),
                              doi, **mm))
        dp = jnp.einsum("bqd,bkd->bqk", doi, v, **mm) * mask
        ds = p * (dp - delta) * d ** -0.5
        dqs.append(jnp.einsum("bqk,bkd->bqd", ds.astype(k.dtype), k, **mm))
        dks.append(jnp.einsum("bqk,bqd->bkd", ds.astype(q.dtype), q, **mm))
    return jnp.concatenate(dqs + dks + dvs, axis=-1).astype(qkv.dtype)


@pytest.mark.parametrize("kind,kv_len", [("f32", 14), ("f32", 9),
                                         ("bf16", 11)])
def test_dropout_plain_matches_jnp_with_the_same_mask(kind, kv_len):
    """Forward and backward plain versions with a mask from
    ``mha_dropout_masks`` against the jnp reference given that mask."""
    jdt, tdt = DTYPES[kind]
    b, s, heads, d, rate = 2, 14, 2, 32, 0.5
    qkv, do = _arrays(b, s, heads, d, seed=3)
    keep = tfa.mha_dropout_masks(21, rate, b, s, heads, "cpu")
    o, lse = tfa.fused_mha_plain(torch.tensor(qkv).to(tdt), heads,
                                 d ** -0.5, kv_len, keep, rate)
    want_o = _jnp_fwd(jnp.asarray(qkv, jdt), keep.numpy(), rate, heads, d,
                      kv_len)
    _close(kind, o.float().numpy(), np.asarray(want_o, np.float32), "o")
    got = tfa.fused_mha_bwd_plain(torch.tensor(qkv).to(tdt), o, lse,
                                  torch.tensor(do).to(tdt), heads, d ** -0.5,
                                  kv_len, keep, rate)
    want = _jnp_bwd(jnp.asarray(qkv, jdt), jnp.asarray(o.float().numpy(),
                                                        jdt),
                    jnp.asarray(lse.numpy()), jnp.asarray(do, jdt),
                    keep.numpy(), rate, heads, d, kv_len)
    _dqkv_close(kind, got.float().numpy(), np.asarray(want, np.float32),
                heads, d)


@pytest.mark.parametrize("kv_len", [14, 10])
def test_dropout_autograd_matches_jax_vjp_of_the_masked_attention(kv_len):
    """``FusedMHA`` with dropout on CPU tensors (mask from the seed)
    against ``jax.vjp`` of the jnp forward given the same mask, f32."""
    b, s, heads, d, rate, seed = 2, 14, 2, 32, 0.5, 8
    qkv, do = _arrays(b, s, heads, d, seed=4)
    keep = tfa.mha_dropout_masks(seed, rate, b, s, heads, "cpu").numpy()
    out, vjp = jax.vjp(lambda x: _jnp_fwd(x, keep, rate, heads, d, kv_len),
                       jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(do))
    leaf = torch.tensor(qkv, requires_grad=True)
    o = tfa.fused_mha(leaf, heads=heads, kv_len=kv_len, dropout_rate=rate,
                      seed=seed)
    (got,) = torch.autograd.grad(o, leaf, torch.tensor(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_dropout_mask_rule(rate):
    """keep where the 32 bits are ≥ the JAX kernels' cutoff; the dropped
    share within 4 standard deviations of the rate."""
    assert tfa.dropout_cutoff(rate) == int(jfa._dropout_cutoff(rate))
    assert tfb.dropout_cutoff is tfa.dropout_cutoff
    keep = tfa.mha_dropout_masks(3, rate, 4, 30, 3, "cpu")
    assert keep.dtype == torch.bool and keep.shape == (4, 3, 30, 30)
    band = 4 * (rate * (1 - rate) / keep.numel()) ** 0.5
    assert abs((~keep).float().mean().item() - rate) < band


def test_dropout_masks_follow_the_seed():
    """One seed, one mask; another seed, another mask; so the training
    forward with dropout differs from the one without, and repeats."""
    a = tfa.mha_dropout_masks(5, 0.5, 2, 14, 2, "cpu")
    assert torch.equal(a, tfa.mha_dropout_masks(5, 0.5, 2, 14, 2, "cpu"))
    assert not torch.equal(a, tfa.mha_dropout_masks(6, 0.5, 2, 14, 2, "cpu"))
    qkv = torch.tensor(_arrays(2, 14, 2, 32, seed=5)[0])
    plain = tfa.fused_mha(qkv, heads=2)
    dropped = tfa.fused_mha(qkv, heads=2, dropout_rate=0.5, seed=5)
    assert not torch.equal(plain, dropped)
    assert torch.equal(dropped, tfa.fused_mha(qkv, heads=2, dropout_rate=0.5,
                                              seed=5))
    with pytest.raises(ValueError, match="seed"):
        tfa.fused_mha(qkv, heads=2, dropout_rate=0.5)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        tfa.fused_mha(qkv, heads=2, dropout_rate=1.0, seed=1)


def test_backward_argument_check_needs_no_card():
    """The backward kernel streams a head's rows through shared memory, so
    its bfloat16 route takes every single-kv-block length (512) at head
    dim 256, as the forward (K and V streamed in key tiles) does; the
    float route keeps 32 rows of six tensors, so at head dim 384 it takes
    16 tokens where the forward takes 32, and its forward keeps a head's
    K and V whole."""
    longest = torch.zeros(1, 512, 3 * 256, dtype=torch.bfloat16)
    assert tfa._check_mha_args(longest, 1, 512, backward=True) == 256
    assert tfa._check_mha_args(longest, 1, 512) == 256
    with pytest.raises(ValueError, match="forward kernel.*bytes"):
        tfa._check_mha_args(longest.float(), 1, 512)
    assert tfa._check_mha_args(torch.zeros(1, 512, 3 * 256), 1, 500,
                               backward=True) == 256
    assert tfa._check_mha_args(torch.zeros(2, 208, 3 * 3 * 64), 3, 197,
                               backward=True) == 64
    wide = torch.zeros(1, 32, 3 * 384)
    assert tfa._check_mha_args(wide, 1, 32) == 384
    with pytest.raises(ValueError, match="backward kernel.*bytes"):
        tfa._check_mha_args(wide, 1, 32, backward=True)
    assert tfa._check_mha_args(wide[:, :16].contiguous(), 1, 16,
                               backward=True) == 384
    o = torch.zeros(2, 14, 64)
    with pytest.raises(ValueError, match="do: need"):
        tfa._mha_bwd_cuda(torch.zeros(2, 14, 192), o, torch.zeros(2, 14, 2),
                          o[:, :, :32], 2, 0.1, 14)


def test_argument_check_takes_frame_transformer_head_dims():
    """bfloat16 head dims 224 and 448 (FrameTransformer's encoders) pass
    at their S of 14 and 15, forward and backward, and at every S the JAX
    kernel takes (``_round_up(s, 128) <= 512``): the forward streams K and
    V in 32-key tiles (its shared memory does not depend on S), and the
    backward's blocks own and stream 32 rows at a time, a warp to each
    16-row strip and output-column chunk (7 at either head dim,
    ``attn_out_cols`` 32 and 64: 14 warps).  A head dim the kernels are
    not compiled for, such as 96, is refused."""
    bf = torch.bfloat16
    for d, heads in ((448, 2), (224, 4)):
        assert tfa.attn_out_cols(d) * 7 == d
        # a warp to each (16-row strip, column chunk) of a block
        assert tfa._bwd_rows(d) == 32
        assert tfa._bwd_rows(d) // 16 * 7 <= tfa._BWD_MAX_WARPS
        for s in (14, 15, 32, 33, 41, 64, 65, 129, 193, 512):
            qkv = torch.zeros(2, s, 3 * heads * d, dtype=bf)
            for kv in {s, max(1, s - 20)}:
                assert tfa._check_mha_args(qkv, heads, kv) == d
                assert tfa._check_mha_args(qkv, heads, kv,
                                           backward=True) == d
            assert tfa._bwd_smem_bf16(_round16(s), d) <= tfa._SMEM_PER_BLOCK
        assert tfa._fwd_smem_tiled(d) <= tfa._SMEM_PER_BLOCK
    # the other head dims keep their 64-row blocks and their limits
    assert [tfa._bwd_rows(d) for d in (16, 32, 64, 128, 256)] == [64] * 5
    for backward in (False, True):
        with pytest.raises(ValueError, match="head dims"):
            tfa._check_mha_args(torch.zeros(2, 14, 3 * 2 * 96, dtype=bf), 2,
                                14, backward=backward)
    # the streamed bodies' chunks end at the head's last column
    assert [tfa.attn_out_cols(d) for d in (16, 64, 128, 224, 256, 448)] \
        == [16, 64, 64, 32, 64, 64]


def test_float_limits_at_frame_transformer_head_dims():
    """float32 at head dims 448 and 224 keeps its shared-memory limits
    (ROADMAP queue 3, Open 1): the forward keeps a head's K and V whole,
    S <= 16 at 448 and <= 80 at 224; the backward keeps 32 rows of six
    tensors, S <= 16 at 448 and every S at 224.  ``--seq_len 40`` (41
    tokens) is refused in float at 448."""
    for d, heads, fwd_max, bwd_max in ((448, 2, 16, 16), (224, 4, 80, 512)):
        for backward, last in ((False, fwd_max), (True, bwd_max)):
            ok = torch.zeros(2, last, 3 * heads * d)
            assert tfa._check_mha_args(ok, heads, last,
                                       backward=backward) == d
            if last < 512:
                with pytest.raises(ValueError, match="shared memory"):
                    tfa._check_mha_args(torch.zeros(2, last + 1,
                                                    3 * heads * d), heads,
                                        last + 1, backward=backward)
    with pytest.raises(ValueError, match="shared memory"):
        tfa._check_mha_args(torch.zeros(2, 41, 2688), 2, 41)


def _round16(s: int) -> int:
    return -(-s // 16) * 16


@pytest.mark.parametrize("s", [41, 512])
@pytest.mark.parametrize("heads", [2, 4])
def test_argument_check_takes_frame_transformer_shapes_up_to_512(s, heads):
    """(2, S, 2688) in bfloat16 at 2 heads of 448 and 4 of 224, S 41 (the
    token count of ``--seq_len 40``) and 512 (the longest single kv block
    of JAX's kernel): the forward and the backward take them."""
    d = 2688 // (3 * heads)
    qkv = torch.zeros(2, s, 2688, dtype=torch.bfloat16)
    assert tfa.fits_single_block(s)
    assert tfa._check_mha_args(qkv, heads, s) == d
    assert tfa._check_mha_args(qkv, heads, s, backward=True) == d
