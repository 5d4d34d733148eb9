"""The port's int8 path (ops/quant.py) against the JAX package's, on the CPU.

The same numpy arrays go through the JAX function and its counterpart.
Where the JAX function reaches a Pallas kernel it runs in interpret mode,
as ``tests/test_quant.py`` runs it.

Tolerances.  Weight and activation quantizers: the int8 codes are equal
and the scales agree to f32 rounding.  The two kernels' plain versions
against the interpreted kernels: both quantize with the same formula on
the same f32 values, so the codes can differ only where a sum taken in
another order moves an LN output across a rounding boundary; one such flip
moves one row's product by a quantization step.  So the bound is the f32
parity bound of the other port tests (atol 2e-5 / rtol 2e-4) on all but a
small share of the elements, and 2 % of the largest element on every one
(the bound ``tests/test_quant.py`` gives the JAX kernels against each
other).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu.models import layers as jl
from devt_tpu.ops import attention as jatt
from devt_tpu.ops import quant as jq
from devt_tpu_torch.models import layers as tl
from devt_tpu_torch.ops import attention as tatt
from devt_tpu_torch.ops import quant as tq
from devt_tpu_torch.utils.jax_bridge import jax_to_state_dict

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-4)
FLIP_SHARE = 5e-3      # share of elements a flipped int8 code may move
FLIP_BOUND = 0.02      # of the largest element


def _params(rng, dim, heads, dim_head, mlp):
    inner = heads * dim_head

    def p(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"g1": 1.0 + p(1, dim), "b1": p(1, dim),
            "wqkv": p(dim, 3 * inner), "wo": p(inner, dim), "bo": p(1, dim),
            "g2": 1.0 + p(1, dim), "b2": p(1, dim),
            "w1": p(dim, mlp), "bb1": p(1, mlp),
            "w2": p(mlp, dim), "bb2": p(1, dim)}


def _both(params):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: torch.tensor(v) for k, v in params.items()})


def _assert_close_but_for_flips(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    off = err > TOL["atol"] + TOL["rtol"] * np.abs(want)
    assert off.mean() <= FLIP_SHARE, (off.mean(), err.max())
    assert err.max() <= FLIP_BOUND * np.abs(want).max(), err.max()


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_weight_matches_jax(axis):
    w = (np.random.default_rng(0).standard_normal((192, 576)) * 0.07) \
        .astype(np.float32)
    w[:, 3] = 0.0                                   # an all-zero channel
    wq, ws = jq.quantize_weight(jnp.asarray(w), axis=axis)
    tq_, ts = tq.quantize_weight(torch.tensor(w), axis=axis)
    assert tq_.dtype == torch.int8 and ts.shape == ws.shape
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(wq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(ws), rtol=1e-6, atol=0)


def test_quantize_activation_matches_jax():
    x = np.random.default_rng(1).standard_normal((4, 7, 64)).astype(np.float32)
    x[0, 0] = 0.0                                   # an all-zero row
    xq, xs = jq.quantize_activation(jnp.asarray(x))
    tq_, ts = tq.quantize_activation(torch.tensor(x))
    assert tq_.dtype == torch.int8 and ts.shape == (4, 7, 1)
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(xq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(xs), rtol=1e-6, atol=0)


@pytest.mark.parametrize("k", [192, 2048])
def test_int8_matmul_matches_jax(k):
    """K = 2048 is past the width where f32 sums of int8 products are
    exact, so the port's exact product takes its f64 branch."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 17, k)).astype(np.float32)
    w = (rng.standard_normal((k, 96)) * 0.05).astype(np.float32)
    wq, ws = jq.quantize_weight(jnp.asarray(w))
    want = jq.int8_matmul(jnp.asarray(x), wq, ws)
    got = tq.int8_matmul(torch.tensor(x), torch.tensor(np.asarray(wq)),
                         torch.tensor(np.asarray(ws)))
    assert got.dtype == torch.float32
    # the same codes and an exact integer sum: only the two f32 scale
    # products round, in the same order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_quant_block_params_matches_jax():
    params = _params(np.random.default_rng(3), 64, 2, 32, 128)
    jp, tp = _both(params)
    want, got = jq.quant_block_params(jp), tq.quant_block_params(tp)
    assert set(want) == set(got)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        if k.endswith("_q"):
            assert got[k].dtype == torch.int8
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=0)
    # wo and w2 also pass through at full precision
    assert got["wo"] is tp["wo"] and got["w2"] is tp["w2"]


@pytest.mark.parametrize("b,s,dim,heads,mlp,kv_len", [
    (4, 32, 64, 2, 128, 27), (2, 208, 192, 3, 768, 197)])
def test_quant_fused_block_plain_matches_jax_interpret(b, s, dim, heads, mlp,
                                                       kv_len):
    rng = np.random.default_rng(4)
    params = _params(rng, dim, heads, dim // heads, mlp)
    x = (rng.standard_normal((b, s, dim)) * 0.5).astype(np.float32)
    x[:, kv_len:] = 0.0
    jp, tp = _both(params)
    scale = (dim // heads) ** -0.5
    jqp, tqp = jq.quant_block_params(jp), tq.quant_block_params(tp)
    assert jq._fused_quant_ok(jnp.asarray(x), jqp, heads)
    assert tq._fused_quant_ok(torch.tensor(x), tqp, heads)
    want = jq.quant_fused_vit_block(jnp.asarray(x), jqp, heads, scale, kv_len,
                                    interpret=True)
    got = tq.quant_fused_vit_block_plain(torch.tensor(x), tqp, heads, scale,
                                         kv_len)
    assert got.dtype == torch.float32
    _assert_close_but_for_flips(got.numpy(), want)
    # the wrapper runs the plain version for a CPU tensor, and counts no
    # kernel launch
    before = tq.quant_fused_vit_block.launches
    again = tq.quant_fused_vit_block(torch.tensor(x), tqp, heads, scale,
                                     kv_len)
    assert torch.equal(again, got)
    assert tq.quant_fused_vit_block.launches == before


def test_quant_fused_block_plain_bf16_rounds_like_jax():
    """bf16 in, bf16 out: the plain version rounds q, k, v, p, att and h
    to bf16 where the interpreted TPU kernel does.  Bound: a bf16 ulp of
    y (2^-8 relative) on top of the code flips."""
    rng = np.random.default_rng(5)
    params = _params(rng, 64, 2, 32, 128)
    x = (rng.standard_normal((4, 32, 64)) * 0.5).astype(np.float32)
    jp, tp = _both(params)
    for k in ("wqkv", "wo", "w1", "w2"):
        jp[k] = jp[k].astype(jnp.bfloat16)
        tp[k] = tp[k].to(torch.bfloat16)
    want = jq.quant_fused_vit_block(
        jnp.asarray(x, jnp.bfloat16), jq.quant_block_params(jp), 2, 32 ** -0.5,
        27, interpret=True)
    got = tq.quant_fused_vit_block_plain(
        torch.tensor(x).to(torch.bfloat16), tq.quant_block_params(tp), 2,
        32 ** -0.5, 27)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("m,k,n", [(256, 512, 512), (100, 512, 768),
                                   (7, 64, 64)])
def test_int8_matmul_fused_plain_matches_jax_interpret(m, k, n):
    """Including row counts that are no multiple of the TPU kernel's
    128-row tile (its padding path)."""
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[2] = 0.0
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    wq, ws = jq.quantize_weight(jnp.asarray(w))
    want = jq.int8_matmul_fused(jnp.asarray(x), wq, ws, interpret=True)
    args = (torch.tensor(x), torch.tensor(np.asarray(wq)),
            torch.tensor(np.asarray(ws)))
    got = tq.int8_matmul_fused_plain(*args)
    assert got.shape == (m, n) and got.dtype == torch.float32
    # same formula on the same f32 inputs, exact integer sums
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    before = tq.int8_matmul_fused.launches
    assert torch.equal(tq.int8_matmul_fused(*args), got)
    assert tq.int8_matmul_fused.launches == before


def test_int8_matmul_fused_plain_bf16_and_leading_dims():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 128)).astype(np.float32)
    w = (rng.standard_normal((128, 64)) * 0.05).astype(np.float32)
    wq, ws = jq.quantize_weight(jnp.asarray(w))
    want = jq.int8_matmul_fused(jnp.asarray(x, jnp.bfloat16), wq, ws,
                                interpret=True)
    got = tq.int8_matmul_fused_plain(
        torch.tensor(x).to(torch.bfloat16), torch.tensor(np.asarray(wq)),
        torch.tensor(np.asarray(ws)))
    assert got.dtype == torch.bfloat16 and got.shape == (3, 5, 64)
    # bf16 inputs are exact in f32, so the two agree in every bit
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dim,heads,dim_head,mlp,s", [(64, 2, 32, 128, 32),
                                                      (96, 4, 48, 256, 24)])
def test_unfused_quant_vit_block_matches_jax(dim, heads, dim_head, mlp, s):
    """impl="xla": all four products through int8_matmul, including an
    inner width that differs from dim."""
    rng = np.random.default_rng(7)
    params = _params(rng, dim, heads, dim_head, mlp)
    x = (rng.standard_normal((2, s, dim)) * 0.5).astype(np.float32)
    jp, tp = _both(params)
    scale = dim_head ** -0.5
    want = jq.quant_vit_block(jnp.asarray(x), jq.quant_block_params(jp),
                              heads, scale, s - 3, impl="xla")
    got = tq.quant_vit_block(torch.tensor(x), tq.quant_block_params(tp),
                             heads, scale, s - 3, impl="xla")
    _assert_close_but_for_flips(got.numpy(), want)


def test_quant_vit_block_routes_to_the_fused_wrapper(monkeypatch):
    calls = []
    real = tq.quant_fused_vit_block
    monkeypatch.setattr(tq, "quant_fused_vit_block",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    rng = np.random.default_rng(8)
    _, tp = _both(_params(rng, 64, 2, 32, 128))
    qp = tq.quant_block_params(tp)
    x = torch.tensor(rng.standard_normal((2, 32, 64)).astype(np.float32))
    tq.quant_vit_block(x, qp, 2, 0.25, 32)
    assert calls == [1]
    tq.quant_vit_block(x, qp, 2, 0.25, 32, impl="xla")
    assert calls == [1]
    tq.quant_vit_block(x[:, :24], qp, 2, 0.25, 24)     # S % 16 != 0
    assert calls == [1]


def test_fused_matmul_rule_matches_jax(monkeypatch):
    """The JAX gate is "on a TPU"; the port's is "CUDA tensors".  The shape
    rule is the same."""
    monkeypatch.setattr("jax.default_backend", lambda: "tpu")
    for m, k, n in [(4096, 2048, 2048), (3584, 2048, 6144), (4096, 192, 576),
                    (16, 2048, 2048), (64, 512, 512), (64, 512, 511)]:
        assert tq._fused_matmul_ok(m, k, n, True) \
            == jq._fused_matmul_ok(m, k, n), (m, k, n)
        assert not tq._fused_matmul_ok(m, k, n, False)


def test_quant_scope_and_site_pred_match_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    w_sq = rng.standard_normal((32, 32)).astype(np.float32)
    w_wide = rng.standard_normal((32, 64)).astype(np.float32)
    dn = (((1,), (0,)), ((), ()))
    policy = lambda k, n: n >= 2 * k            # noqa: E731
    assert not tatt.quant_active()
    with jatt.quant_scope(policy), tatt.quant_scope(policy):
        assert tatt.quant_active()
        assert tatt.quant_site_allowed(32, 64)
        assert not tatt.quant_site_allowed(32, 32)
        with tatt.quant_scope():                # re-entrant
            assert tatt.quant_site_allowed(32, 32)
        assert not tatt.quant_site_allowed(32, 32)
        want_sq = jq.int8_dot_general(jnp.asarray(x), jnp.asarray(w_sq), dn)
        want_wide = jq.int8_dot_general(jnp.asarray(x), jnp.asarray(w_wide),
                                        dn)
        got_sq = tq.int8_dot_general(torch.tensor(x), torch.tensor(w_sq))
        got_wide = tq.int8_dot_general(torch.tensor(x), torch.tensor(w_wide))
    assert not tatt.quant_active()
    # the rejected site is the plain product; the accepted one is int8
    assert torch.equal(got_sq, torch.tensor(x) @ torch.tensor(w_sq))
    np.testing.assert_allclose(got_sq.numpy(), np.asarray(want_sq), **TOL)
    np.testing.assert_allclose(got_wide.numpy(), np.asarray(want_wide),
                               rtol=1e-6, atol=1e-6)
    assert np.abs(got_wide.numpy() - x @ w_wide).max() > 0


@pytest.mark.parametrize("layout,want", [
    ("k_major", True),          # the site registry's codes: (N, K) storage
    ("row_major", False),       # JAX's (K, N) layout
    ("strided", False)])        # neither: every other column of a (K, 2N)
def test_int8_matmul_route_predicate(layout, want):
    """Kernel 6's body follows the weight codes' layout: the K-major view
    (strides (1, K)) takes the wgmma body, row-major codes the mma.sync
    body (the card tests hold the C entry's rule to this predicate)."""
    k, n = 128, 64
    codes = {"k_major": torch.zeros(n, k, dtype=torch.int8).t(),
             "row_major": torch.zeros(k, n, dtype=torch.int8),
             "strided": torch.zeros(k, 2 * n, dtype=torch.int8)[:, ::2]}
    assert tuple(codes[layout].shape) == (k, n)
    assert tq.int8_matmul_on_wgmma(codes[layout]) is want


@pytest.mark.parametrize("m,k,n", [(4, 32, 64), (37, 1152, 192)])
def test_site_registry_stores_k_major_codes(m, k, n):
    """A Linear site's codes are stored (N, K), k contiguous, and handed
    out as their (K, N) view: the layout of kernel 6's wgmma body, with
    one copy of the weights.  The view gives bit for bit what the row-major
    codes give, through the unfused product, the fused kernel's plain
    version and the site itself, and the same values as JAX's
    int8_dot_general (K = 1152 takes the f64 product)."""
    rng = np.random.default_rng(m + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    sites = []
    with tatt.quant_scope(), tq.quant_sites_collect(sites):
        got = tq.int8_dot_general(torch.tensor(x), torch.tensor(w))
    (w_q, w_s), = sites
    assert tuple(w_q.shape) == (k, n) and w_q.stride() == (1, k)
    assert w_q.t().is_contiguous() and tq.int8_matmul_on_wgmma(w_q)
    row = w_q.contiguous()
    assert torch.equal(row, tq.quantize_weight(torch.tensor(w))[0])
    xt = torch.tensor(x)
    assert torch.equal(tq.int8_matmul(xt, w_q, w_s),
                       tq.int8_matmul(xt, row, w_s))
    assert torch.equal(got, tq.int8_matmul(xt, row, w_s))
    for dtype in (torch.float32, torch.bfloat16):
        xd = xt.to(dtype)
        assert torch.equal(tq.int8_matmul_fused_plain(xd, w_q, w_s),
                           tq.int8_matmul_fused_plain(xd, row, w_s))
    with jatt.quant_scope():
        want = jq.int8_dot_general(jnp.asarray(x), jnp.asarray(w),
                                   (((1,), (0,)), ((), ())))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_site_registry_quantizes_once():
    """collect records each site's int8 pair in call order; provide hands
    them back and quantizes nothing (the weight is not even read)."""
    w = torch.tensor(np.random.default_rng(10).standard_normal((32, 64))
                     .astype(np.float32))
    x = torch.ones(2, 32)
    sites = []
    with tatt.quant_scope(), tq.quant_sites_collect(sites):
        first = tq.int8_dot_general(x, w)
    assert len(sites) == 1 and sites[0][0].dtype == torch.int8
    poisoned = torch.full_like(w, float("nan"))
    with tatt.quant_scope(), tq.quant_sites_provide(sites):
        again = tq.int8_dot_general(x, poisoned)
        with pytest.raises(RuntimeError, match="more quantization sites"):
            tq.int8_dot_general(x, poisoned)
    assert torch.equal(first, again)


def test_site_registry_refuses_a_forward_that_differs():
    """Call order is a site's only identity: a provide pass that meets
    fewer sites than were collected, a site of another shape or a site of
    another kind raises instead of pairing weights with the wrong
    module."""
    rng = np.random.default_rng(11)
    w = torch.tensor(rng.standard_normal((32, 64)).astype(np.float32))
    x = torch.ones(2, 32)
    sites = []
    with tatt.quant_scope(), tq.quant_sites_collect(sites):
        tq.int8_dot_general(x, w)
        tq.int8_dot_general(x, w)
    with pytest.raises(RuntimeError, match="met 1 quantization sites.*2"):
        with tatt.quant_scope(), tq.quant_sites_provide(sites):
            tq.int8_dot_general(x, w)
    with pytest.raises(RuntimeError, match=r"\(32, 64\) weight to a "
                                           r"\(32, 16\) Linear site"):
        with tatt.quant_scope(), tq.quant_sites_provide(sites):
            tq.int8_dot_general(x, w[:, :16])
    with pytest.raises(RuntimeError, match="wants a dict.*recorded a tuple"):
        with tq.quant_sites_provide(sites):
            tq.site_value(dict, dict)
    # an error inside the forward is not masked by the count check
    with pytest.raises(ZeroDivisionError):
        with tq.quant_sites_provide(sites):
            1 / 0


@pytest.mark.parametrize("impl", ["fused_interpret", "xla"])
def test_vit_block_quant_branch_matches_jax(impl, monkeypatch):
    """models/layers.ViTBlock inside quant_scope, eval mode: the fused int8
    block, or, pinned to "xla", the unfused one, which must never reach
    the fused wrapper."""
    calls = []
    real = tq.quant_fused_vit_block
    monkeypatch.setattr(tq, "quant_fused_vit_block",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x = np.random.default_rng(11).standard_normal((2, 16, 64)) \
        .astype(np.float32)
    jm = jl.ViTBlock(64, 2, 32, 128, attention_impl=impl)
    v = jax.tree_util.tree_map(np.asarray, jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x), True, 13))
    tm = tl.ViTBlock(64, 2, 32, 128, attention_impl=impl).eval()
    tm.load_state_dict(jax_to_state_dict(v))
    with jatt.quant_scope():
        want = jm.apply(v, jnp.asarray(x), True, 13)
    with tatt.quant_scope(), torch.no_grad():
        got = tm(torch.tensor(x), 13)
    _assert_close_but_for_flips(got.numpy(), want)
    assert calls == ([1] if impl == "fused_interpret" else [])
    # training mode never quantizes
    with tatt.quant_scope(), torch.no_grad():
        tm.train()
        train = tm(torch.tensor(x), 13)
        tm.eval()
    with torch.no_grad():
        plain = tm(torch.tensor(x), 13)
    assert torch.equal(train, plain)


def test_cuda_wrappers_raise_on_unsupported_shapes():
    """The argument checks of the CUDA routes, which need no card: an
    unsupported shape is an error, never a reason to run the plain
    version."""
    _, tp = _both(_params(np.random.default_rng(12), 96, 2, 48, 256))
    for k in ("wqkv", "wo", "w1", "w2"):
        tp[k] = tp[k].to(torch.bfloat16)
    qp = tq.quant_block_params(tp)
    x = torch.zeros(2, 32, 96, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 64"):
        tq._check_quant_block_args(x, qp, 2)
    _, tp = _both(_params(np.random.default_rng(12), 128, 2, 64, 256))
    qp = tq.quant_block_params({k: v.to(torch.bfloat16) if v.shape[0] > 1
                                else v for k, v in tp.items()})
    x = torch.zeros(2, 32, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="compiled for"):
        tq._check_quant_block_args(x, qp, 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tq._check_quant_block_args(x.half(), qp, 2)
    w_q = torch.zeros(96, 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiples of 64"):
        tq._check_matmul_args(torch.zeros(8, 96), w_q, torch.ones(1, 64))
    with pytest.raises(ValueError, match="w_q"):
        tq._check_matmul_args(torch.zeros(8, 64), w_q, torch.ones(1, 64))
    tq._check_matmul_args(torch.zeros(8, 128),
                          torch.zeros(128, 64, dtype=torch.int8),
                          torch.ones(1, 64))
