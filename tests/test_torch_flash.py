"""The port's split-q/k/v attention (kernels 9, 10 and 11) against the JAX
package's, on the CPU.

The plain versions that CPU tensors run, and that the card holds the CUDA
kernels to, against the Pallas kernels in interpret mode, from the same
numpy arrays: ``_fwd_single`` (kernel 9), ``_bwd_single`` (10) and
``_fwd`` (11), which take q, k, v padded to their tiles; the port's take
them unpadded and mask.  Then the op under autograd against ``jax.grad``,
the dispatch against JAX's, and a tiny ViViT whose 577 space tokens exceed
one kv block, in the model dtype and in int8.

Tolerances.  f32: the JAX package's own bound for its kernels against the
materialised attention (``tests/test_attention.py:40``, 2e-5), sums in
other orders; gradients ``tests/test_attention.py:61``'s (5e-5 / 5e-4).
bf16: one bf16 ulp (2^-8) of each tensor's largest element, where a sum
in another order moves a probability across a rounding boundary.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu.models import vivit as jv
from devt_tpu.ops import attention as jatt
from devt_tpu_torch.models import vivit as tv
from devt_tpu_torch.ops import attention as tatt
from devt_tpu_torch.ops import flash_attention as tfa
from devt_tpu_torch.utils.jax_bridge import (jax_to_state_dict,
                                             state_dict_to_jax)

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

# ``devt_tpu.ops.flash_attention`` the attribute is a function of that name
jfa = importlib.import_module("devt_tpu.ops.flash_attention")

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)
# f32 logits of a tiny ViViT against JAX's, the port's ViViT parity bound
# (tests/test_torch_vivit.py)
LOGIT_TOL = dict(atol=2e-5, rtol=2e-4)
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _qkv(bh, sq, skv, d, seed=0):
    return (_rand((bh, sq, d), seed), _rand((bh, skv, d), seed + 1),
            _rand((bh, skv, d), seed + 2))


def _pad(x, s_p):
    return np.pad(x, ((0, 0), (0, s_p - x.shape[1]), (0, 0)))


def _close(kind, got, want, **tol):
    """f32 at ``tol`` (default TOL); bf16 within one bf16 ulp of the
    largest element of ``want``."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    if kind == "f32":
        np.testing.assert_allclose(got, want, **(tol or TOL))
    else:
        bound = 2.0 ** -8 * np.abs(want).max()
        assert np.abs(got - want).max() <= bound


def _port(arrs, kind):
    """(BH, S, d) numpy arrays → (1, BH, S, d) tensors in the dtype."""
    return [torch.tensor(a)[None].to(TORCH[kind]) for a in arrs]


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("bh,s,d,kv_len", [(6, 197, 64, 197),
                                           (2, 14, 256, 14),
                                           (3, 40, 32, 29)])
def test_single_fwd_plain_matches_jax_kernel(kind, bh, s, d, kv_len):
    """Kernel 9's plain version: (6, 197 → 208, 64) at kv_len 197, the int8
    ViViT's shape at token_pad=0, and (2, 14 → 16, 256), PTN's head dim."""
    q, k, v = _qkv(bh, s, s, d)
    s_p = -(-s // 16) * 16
    jo, jlse = jfa._fwd_single(
        *(jnp.asarray(_pad(t, s_p), JNP[kind]) for t in (q, k, v)),
        scale=d ** -0.5, kv_len=kv_len, interpret=True)
    o, lse = tfa.flash_single_fwd_plain(*_port((q, k, v), kind), d ** -0.5,
                                        kv_len)
    assert o.shape == (1, bh, s, d) and o.dtype == TORCH[kind]
    assert lse.shape == (bh, s) and lse.dtype == torch.float32
    _close(kind, o[0], np.asarray(jo, np.float32)[:, :s])
    _close(kind, lse, np.asarray(jlse)[:, :s, 0])


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("bh,sq,skv,d,kv_len", [(2, 600, 600, 64, 577),
                                                (2, 40, 300, 32, 290)])
def test_blocked_fwd_plain_matches_jax_kernel(kind, bh, sq, skv, d, kv_len):
    """Kernel 11's plain version, 128-key blocks as the TPU kernel's:
    ViViT's 577 tokens in (2, 600 → 640, 64), and Sq != Skv."""
    q, k, v = _qkv(bh, sq, skv, d, seed=3)
    sq_p, skv_p = -(-sq // 128) * 128, -(-skv // 128) * 128
    jo, jlse = jfa._fwd(
        jnp.asarray(_pad(q, sq_p), JNP[kind]),
        *(jnp.asarray(_pad(t, skv_p), JNP[kind]) for t in (k, v)),
        scale=d ** -0.5, kv_len=kv_len, block_q=128, block_kv=128,
        interpret=True)
    o, lse = tfa.flash_blocked_fwd_plain(*_port((q, k, v), kind),
                                         d ** -0.5, kv_len)
    assert o.shape == (1, bh, sq, d) and lse.shape == (bh, sq)
    _close(kind, o[0], np.asarray(jo, np.float32)[:, :sq])
    _close(kind, lse, np.asarray(jlse)[:, :sq, 0])


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_single_bwd_plain_matches_jax_kernel(kind):
    """Kernel 10's plain version on the forward's (o, lse), S = 45 → 48,
    kv_len 40."""
    bh, s, d, kv_len = 4, 45, 32, 40
    q, k, v = _qkv(bh, s, s, d, seed=5)
    do = _rand((bh, s, d), 9)
    tq, tk, tv_, tdo = _port((q, k, v, do), kind)
    o, lse = tfa.flash_single_fwd_plain(tq, tk, tv_, d ** -0.5, kv_len)
    # JAX's kernel on the same (o, lse), padded to its tile
    s_p = 48
    jl = np.pad(lse.numpy(), ((0, 0), (0, s_p - s)))[..., None].repeat(
        128, axis=-1)
    want = jfa._bwd_single(
        *(jnp.asarray(_pad(t, s_p), JNP[kind]) for t in (q, k, v)),
        jnp.asarray(_pad(o[0].float().numpy(), s_p), JNP[kind]),
        jnp.asarray(jl), jnp.asarray(_pad(do, s_p), JNP[kind]),
        scale=d ** -0.5, kv_len=kv_len, interpret=True)
    got = tfa.flash_single_bwd_plain(tq, tk, tv_, o, lse, tdo, d ** -0.5,
                                     kv_len)
    for g, w in zip(got, want):
        assert g.dtype == TORCH[kind]
        _close(kind, g[0], np.asarray(w, np.float32)[:, :s], **GRAD_TOL)


@pytest.mark.parametrize("b,h,s,d,kv_len", [(2, 3, 45, 32, 40),
                                            (1, 2, 16, 64, None)])
def test_op_gradients_match_jax_grad(b, h, s, d, kv_len):
    """``flash_attention`` under autograd (kernels 9 and 10's plain
    versions) against ``jax.grad`` of JAX's through its interpreted
    kernels."""
    q, k, v = (_rand((b, h, s, d), i) for i in range(3))
    w = _rand((b, h, s, d), 7)

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, kv_len=kv_len,
                                           interpret=True) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    out = tfa.flash_attention(*leaves, kv_len=kv_len)
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, k, v)),
                                       kv_len=kv_len, interpret=True)),
        **TOL)
    for leaf, g in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   **GRAD_TOL)


def test_blocked_gradient_raises_before_the_forward():
    """Above one kv block the gradient (kernels 12 and 13, here their plain
    versions) is computed, where it was refused before the forward until
    they were ported: S = 520 and Sq != Skv, against autograd through the
    materialised attention; evaluation runs as before."""
    for sq, skv, kv_len in ((520, 520, 517), (8, 20, 20)):
        q, k, v = (torch.tensor(_rand((1, 2, s, 16), i))
                   for i, s in enumerate((sq, skv, skv)))
        w = torch.tensor(_rand((1, 2, sq, 16), 3))
        grads = []
        for attend in (tfa.flash_attention, functools.partial(
                tatt.xla_attention, scale=0.25)):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            (attend(*leaves, kv_len=kv_len) * w).sum().backward()
            grads.append([t.grad for t in leaves])
        for got, want in zip(*grads):
            torch.testing.assert_close(got, want, atol=5e-5, rtol=5e-4)
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v).shape == (1, 2, 8, 16)


# (impl, on the accelerator, dropout)
ROWS = [(impl, accel, drop) for impl in ("auto", "pallas", "xla")
        for accel in (True, False) for drop in (True, False)]


@pytest.mark.parametrize("impl,accel,drop", ROWS)
def test_dispatch_matches_jax(monkeypatch, impl, accel, drop):
    """Every row of the split-head dispatch against JAX's
    ``scaled_dot_product_attention`` with its TPU gate set to ``accel``:
    which attention it calls, or that both raise."""
    called = []
    monkeypatch.setattr(jatt, "_auto_pallas_ok", lambda: accel)
    monkeypatch.setattr(jatt, "flash_attention",
                        lambda *a, **k: called.append("kernels"))
    monkeypatch.setattr(jatt, "xla_attention",
                        lambda *a, **k: called.append("plain"))
    x = jnp.zeros((1, 1, 4, 8))
    rng = jax.random.PRNGKey(0) if drop else None
    try:
        jatt.scaled_dot_product_attention(x, x, x, impl=impl,
                                          dropout_rate=0.1, dropout_rng=rng)
        want = called[0]
    except NotImplementedError:
        want = "raises"
    device = "cuda" if accel else "cpu"
    try:
        got = tatt.resolve_sdpa_impl(impl, device, drop)
    except NotImplementedError as e:
        assert "dropout" in str(e)
        got = "raises"
    assert got == want


@pytest.mark.parametrize("impl,drop", [("auto", False), ("auto", True),
                                       ("pallas", False), ("xla", False),
                                       ("xla", True)])
def test_cpu_dispatch_runs_what_it_resolves_to(impl, drop):
    """On CPU tensors ``"pallas"`` runs the kernels' plain versions, the
    rest the materialised attention; the outputs agree."""
    from devt_tpu_torch.models.layers import DropoutRng

    q, k, v = (torch.tensor(_rand((1, 2, 20, 16), i)) for i in range(3))
    rate = 0.1 if drop else 0.0
    rng = DropoutRng(0) if drop else None
    before = tfa.flash_attention.single_launches
    got = tatt.scaled_dot_product_attention(q, k, v, impl=impl, kv_len=17,
                                            dropout_rate=rate, rng=rng)
    assert tfa.flash_attention.single_launches == before  # no kernel
    want = tatt.xla_attention(q, k, v, scale=0.25, kv_len=17,
                              dropout_rate=rate, rng=DropoutRng(0)
                              if drop else None)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=2e-5)
    with pytest.raises(NotImplementedError, match="dropout"):
        tatt.scaled_dot_product_attention(q, k, v, impl="pallas",
                                          dropout_rate=0.1,
                                          rng=DropoutRng(0))


# a ViViT whose space sequence exceeds one kv block: 24^2 + 1 = 577 tokens
# pad to 592
LONG = dict(image_size=96, patch_size=4, num_classes=5, num_frames=2,
            dim=32, depth=2, heads=2, dim_head=16)


def _clip(seed, image=96):
    return _rand((2, 2, image, image, 3), seed)


@pytest.fixture(scope="module")
def long_vivit():
    x = _clip(1)
    jm = jv.ViViT(channels_last=True, **LONG)
    v = jax.tree_util.tree_map(
        np.asarray, jm.init({"params": jax.random.PRNGKey(0)},
                            jnp.asarray(x)))
    return x, v


def test_vivit_above_one_kv_block_matches_jax(long_vivit):
    """The port's ``"pallas"`` path (kernel 11's plain version in every
    space block) against JAX's ViViT, which on the CPU resolves ``"auto"``
    to the materialised attention."""
    x, v = long_vivit
    want = jv.ViViT(channels_last=True, **LONG).apply(v, jnp.asarray(x))
    tm = tv.ViViT(attention_impl="pallas", channels_last=True,
                  **LONG).eval()
    tm.load_state_dict(jax_to_state_dict(v))
    assert not tm.space_transformer.blocks[0].fused_eligible(
        torch.zeros(4, 592, 32))
    before = tfa.flash_attention.blocked_launches
    with torch.no_grad():
        got = tm(torch.tensor(x))
    assert tfa.flash_attention.blocked_launches == before  # plain on CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("kw,clip", [
    (LONG, 1),
    # token_pad=0: 17 tokens, no multiple of 16, so the int8 block runs
    # unfused on one kv block (kernel 9)
    (dict(image_size=32, patch_size=8, num_classes=5, num_frames=2, dim=64,
          depth=2, heads=2, dim_head=32, token_pad=0), 2)])
def test_int8_unfused_vivit_matches_jax(long_vivit, kw, clip):
    """Under the int8 scope the space blocks take ``quant_vit_block``'s
    unfused body: JAX's (``"fused_interpret"``) reaches its flash kernels
    in interpret mode (11 above one kv block, 9 at token_pad=0), the
    port's (``"pallas"``) their plain versions.  Inside the port the
    kernels' path and the materialised attention (``"xla"``) agree to f32
    rounding; against JAX the bound is the int8 one of
    ``tests/test_torch_serve_quant.py`` (2e-2): both packages quantize the
    same values with the same formula, but a sum taken in another order
    can move an activation across an int8 rounding boundary, and one such
    flip moves the first clip's logits here by 1.1e-2 whichever attention
    either package runs."""
    if kw is LONG:
        x, v = long_vivit
    else:
        x = _clip(clip, kw["image_size"])
        v = jax.tree_util.tree_map(np.asarray, jv.ViViT(
            channels_last=True, **kw).init(
                {"params": jax.random.PRNGKey(3)}, jnp.asarray(x)))
    with jatt.quant_scope():
        want = jv.ViViT(attention_impl="fused_interpret", channels_last=True,
                        **kw).apply(v, jnp.asarray(x))
    got = {}
    for impl in ("pallas", "xla"):
        tm = tv.ViViT(attention_impl=impl, channels_last=True, **kw).eval()
        tm.load_state_dict(jax_to_state_dict(v))
        with torch.no_grad(), tatt.quant_scope():
            got[impl] = tm(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got["pallas"], got["xla"], **LOGIT_TOL)
    np.testing.assert_allclose(got["pallas"], np.asarray(want), atol=2e-2,
                               rtol=0)


def test_bridge_round_trip_at_image_384():
    """The bridge carries the larger position embedding of a ViViT at image
    384 (1, frames, 577, dim) both ways, and the port loads it strictly."""
    kw = dict(image_size=384, patch_size=16, num_classes=19, num_frames=2,
              dim=32, depth=1, heads=2, dim_head=16)
    shapes = jax.eval_shape(
        lambda x: jv.ViViT(channels_last=True, **kw).init(
            {"params": jax.random.PRNGKey(0)}, x),
        jax.ShapeDtypeStruct((1, 2, 384, 384, 3), jnp.float32))
    rng = np.random.default_rng(0)
    v = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    sd = jax_to_state_dict(v)
    assert sd["pos_embedding"].shape == (1, 2, 577, 32)
    tm = tv.ViViT(channels_last=True, **kw)
    tm.load_state_dict(sd)                    # strict: every leaf matched
    back = state_dict_to_jax(tm.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    leaves = jax.tree_util.tree_leaves_with_path(v)
    assert len(leaves) == len(flat)
    for path, leaf in leaves:
        np.testing.assert_array_equal(flat[path], leaf)


def test_ops_package_keeps_the_module_name():
    """``devt_tpu_torch.ops.flash_attention`` stays the module that callers
    import by that name; the package does not re-export the function over
    it."""
    import types

    from devt_tpu_torch import ops
    from devt_tpu_torch.ops import flash_attention as mod

    assert isinstance(mod, types.ModuleType)
    assert callable(mod.flash_attention) and ops.FlashSingle is \
        mod.FlashSingle


# the one-shot forward's two bodies on the card: the rule that picks the
# wgmma body (csrc/flash_fwd_sm90.cuh), and what the wrappers hand it

@pytest.mark.parametrize("dtype,d,keys,want", [
    (torch.bfloat16, 64, 197, True),     # kernel 9's main path (kv_len)
    (torch.bfloat16, 64, 208, True),     # kernel 14's bench shard (S)
    (torch.bfloat16, 64, 160, True),     # the hop-by-hop ring's shards
    (torch.bfloat16, 16, 1, True), (torch.bfloat16, 32, 256, True),
    (torch.bfloat16, 64, 257, False), (torch.bfloat16, 64, 0, False),
    (torch.bfloat16, 128, 100, False), (torch.bfloat16, 256, 64, False),
    (torch.bfloat16, 48, 64, False), (torch.float32, 64, 197, False)])
def test_one_shot_route_predicate(dtype, d, keys, want):
    """bfloat16, head dim 16, 32 or 64, 1..256 live keys: the wgmma body;
    anything else the streamed body (the card tests hold the C entries'
    rule to this predicate)."""
    assert tfa.one_shot_on_wgmma(dtype, d, keys) is want


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, True),          # kernel 11's main path
    (torch.bfloat16, 16, True), (torch.bfloat16, 32, True),
    (torch.bfloat16, 128, False), (torch.bfloat16, 256, False),
    (torch.bfloat16, 48, False), (torch.bfloat16, 8, False),
    (torch.float32, 64, False), (torch.float32, 32, False)])
def test_online_route_predicate(dtype, d, want):
    """Kernel 11: bfloat16 at head dim 16, 32 or 64 takes the wgmma online
    body whatever the key count and Sq; anything else the streamed body
    (the card tests hold the C entry's rule to this predicate)."""
    assert tfa.online_on_wgmma(dtype, d) is want


def test_aligned_keeps_tma_readable_views_and_copies_the_rest():
    """``_aligned`` passes what both bodies read in place (the head views
    of a packed qkv: 16-byte aligned, strides positive multiples of 8
    elements) and copies what a TMA map cannot describe: a 2-byte offset,
    a row stride of 68 elements, a zero (expanded) stride."""
    qkv = torch.zeros(2, 37, 3, 3, 64, dtype=torch.bfloat16)
    q = qkv[:, :, 0].transpose(1, 2)
    assert tfa._aligned(q) is q
    flat = torch.arange(2 * 3 * 37 * 64 + 1).to(torch.bfloat16)
    shifted = flat[1:].view(2, 3, 37, 64)
    odd = torch.zeros(2, 3, 37, 68, dtype=torch.bfloat16)[..., :64]
    expanded = torch.ones(1, 1, 37, 64, dtype=torch.bfloat16).expand(
        2, 3, 37, 64)
    assert shifted.data_ptr() % 16 and odd.stride(2) % 8 \
        and expanded.stride(0) == 0
    for t in (shifted, odd, expanded):
        got = tfa._aligned(t)
        assert got is not t and torch.equal(got, t)
        assert got.data_ptr() % 16 == 0 and all(
            st > 0 and st % 8 == 0 for st in got.stride()[:3])
    f32 = torch.zeros(2, 3, 37, 12)
    assert tfa._aligned(f32) is f32      # float: rows contiguous suffice


def test_ring_args_refuse_a_misaligned_bf16_shard():
    """Kernel 14's wrapper takes contiguous q, kv and mask, and in bfloat16
    16-byte aligned q and kv (TMA reads the shard where it lies)."""
    q = torch.zeros(2, 48, 32, dtype=torch.bfloat16)
    mask = torch.zeros(1, 48)
    kv = torch.zeros(2, 48, 64, dtype=torch.bfloat16)
    assert tfa._check_ring_args(q, kv, mask, 2) == 16
    shifted = torch.zeros(2 * 48 * 64 + 1, dtype=torch.bfloat16)[1:].view(
        2, 48, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._check_ring_args(q, shifted, mask, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tfa._check_ring_args(q, kv.transpose(0, 1).contiguous()
                             .transpose(0, 1), mask, 2)


def test_cpu_calls_count_no_launch():
    """CPU tensors run the plain versions: no kernel launch is counted on
    either body."""
    fa, ring = tfa.flash_attention, tfa.ring_step_fwd
    def counts():
        return (fa.single_launches, fa.single_wgmma_launches,
                fa.single_streamed_launches, fa.blocked_launches,
                fa.blocked_wgmma_launches, fa.blocked_streamed_launches,
                ring.launches, ring.wgmma_launches, ring.streamed_launches)

    before = counts()
    x = torch.randn(1, 2, 20, 16).to(torch.bfloat16)
    fa(x, x, x)
    fa(x[:, :, :5], x, x)                       # Sq != Skv: blockwise
    q = torch.randn(1, 20, 32).to(torch.bfloat16)
    kv = torch.randn(1, 20, 64).to(torch.bfloat16)
    ring(q, kv, torch.zeros(1, 20), heads=2, scale=0.25)
    assert counts() == before
