"""Kernel 5's K-major weight codes against the JAX package, on the CPU.

On the card kernel 5 (``csrc/quant_block_fwd.cu``) runs its Wqkv and W1
products on int8 ``wgmma``, which reads 8-bit operands only K-major, so
``quant_block_params`` stores those two code matrices (N, K), k
contiguous, and hands out their (K, N) view with strides (1, K).  Here:
the view holds JAX's codes; the plain version and the unfused block read
it as it is and match the interpreted TPU kernel at both compiled widths;
the card wrapper's argument check takes exactly that view.  The kernel
itself is held against the plain version on the card in
``tests/test_torch_cuda.py``.

Bounds as ``tests/test_torch_quant.py``: the f32 parity bound on all but
the share of elements a flipped int8 code may move, 2 % of the largest
element on every one; bf16 two bf16 ulps more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu.ops import quant as jq
from devt_tpu_torch.ops import quant as tq

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-4)
FLIP_SHARE, FLIP_BOUND = 5e-3, 0.02
WIDTHS = [(64, 2, 128), (192, 3, 768)]   # (dim, heads, mlp): both compiled


def _params(rng, dim, mlp):
    def p(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"g1": 1.0 + p(1, dim), "b1": p(1, dim), "wqkv": p(dim, 3 * dim),
            "wo": p(dim, dim), "bo": p(1, dim), "g2": 1.0 + p(1, dim),
            "b2": p(1, dim), "w1": p(dim, mlp), "bb1": p(1, mlp),
            "w2": p(mlp, dim), "bb2": p(1, dim)}


def _trees(dim, mlp, seed, dtype=torch.float32):
    params = _params(np.random.default_rng(seed), dim, mlp)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    if dtype == torch.bfloat16:
        for k in ("wqkv", "wo", "w1", "w2"):
            jp[k] = jp[k].astype(jnp.bfloat16)
            tp[k] = tp[k].to(torch.bfloat16)
    return jq.quant_block_params(jp), tq.quant_block_params(tp)


@pytest.mark.parametrize("dim,heads,mlp", WIDTHS)
def test_wqkv_and_w1_codes_are_kmajor_with_jax_values(dim, heads, mlp):
    """wqkv_q and w1_q: the (K, N) view with strides (1, K) of (N, K)
    storage, JAX's codes; wo_q and w2_q stay row-major (only the unfused
    block reads them)."""
    jqp, tqp = _trees(dim, mlp, seed=dim)
    for name, k, n in (("wqkv_q", dim, 3 * dim), ("w1_q", dim, mlp)):
        t = tqp[name]
        assert t.shape == (k, n) and t.stride() == (1, k), name
        assert tq.is_kmajor(t) and t.t().is_contiguous(), name
        np.testing.assert_array_equal(t.numpy(), np.asarray(jqp[name]))
    for name in ("wo_q", "w2_q"):
        assert tqp[name].is_contiguous() and not tq.is_kmajor(tqp[name])
        np.testing.assert_array_equal(tqp[name].numpy(),
                                      np.asarray(jqp[name]))


@pytest.mark.parametrize("dim,heads,mlp", WIDTHS)
def test_plain_version_reads_the_view_as_it_is(dim, heads, mlp):
    """The plain version on the K-major tree and on a row-major copy of it
    give the same bits: the layout changes no value."""
    _, tqp = _trees(dim, mlp, seed=dim + 1)
    rows = {k: (v.contiguous() if k in ("wqkv_q", "w1_q") else v)
            for k, v in tqp.items()}
    x = torch.tensor(np.random.default_rng(2).standard_normal(
        (2, 32, dim)).astype(np.float32))
    scale = (dim // heads) ** -0.5
    got = tq.quant_fused_vit_block_plain(x, tqp, heads, scale, 27)
    want = tq.quant_fused_vit_block_plain(x, rows, heads, scale, 27)
    assert torch.equal(got, want)
    got = tq.quant_vit_block(x, tqp, heads, scale, 27, impl="xla")
    want = tq.quant_vit_block(x, rows, heads, scale, 27, impl="xla")
    assert torch.equal(got, want)


@pytest.mark.parametrize("dim,heads,mlp,b,s,kv_len,dtype", [
    (64, 2, 128, 3, 48, 37, torch.float32),
    (64, 2, 128, 3, 48, 48, torch.bfloat16),
    (192, 3, 768, 1, 208, 197, torch.bfloat16)])
def test_plain_version_on_kmajor_codes_matches_jax_interpret(
        dim, heads, mlp, b, s, kv_len, dtype):
    """``quant_fused_vit_block_plain`` on the K-major tree against JAX's
    interpreted ``_quant_fwd_kernel`` (through ``quant_fused_vit_block``),
    at both compiled widths, in f32 and in bf16 (the main path's shape)."""
    jqp, tqp = _trees(dim, mlp, seed=s + kv_len, dtype=dtype)
    rng = np.random.default_rng(s)
    x = (rng.standard_normal((b, s, dim)) * 0.5).astype(np.float32)
    x[:, kv_len:] = 0.0
    scale = (dim // heads) ** -0.5
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(jq.quant_fused_vit_block(
        jnp.asarray(x, jdt), jqp, heads, scale, kv_len, interpret=True),
        np.float32)
    got = tq.quant_fused_vit_block_plain(torch.tensor(x).to(dtype), tqp,
                                         heads, scale, kv_len)
    assert got.dtype == dtype
    got = got.float().numpy()
    err = np.abs(got - want)
    if dtype == torch.bfloat16:
        # a bf16 ulp of y (2^-8 relative) on top of the code flips
        tol = 2e-2 + 2e-2 * np.abs(want)
    else:
        tol = TOL["atol"] + TOL["rtol"] * np.abs(want)
    assert (err > tol).mean() <= FLIP_SHARE, ((err > tol).mean(), err.max())
    assert err.max() <= FLIP_BOUND * np.abs(want).max() + (
        2e-2 if dtype == torch.bfloat16 else 0.0), err.max()


def _arg_tree(dim=64, heads=2, mlp=128):
    _, tqp = _trees(dim, mlp, seed=7, dtype=torch.bfloat16)
    x = torch.zeros(2, 48, dim, dtype=torch.bfloat16)
    return x, tqp, heads


def test_argument_check_takes_the_kmajor_view():
    x, qp, heads = _arg_tree()
    tq._check_quant_block_args(x, qp, heads)


@pytest.mark.parametrize("name", ["wqkv_q", "w1_q"])
@pytest.mark.parametrize("layout", ["row_major", "misaligned", "strided"])
def test_argument_check_refuses_other_code_layouts(name, layout):
    """Anything but the K-major view, 16-byte aligned, is refused with the
    parameter's name: the row-major (K, N) codes, a K-major view whose
    storage starts off a 16-byte boundary, a view with gaps."""
    x, qp, heads = _arg_tree()
    t = qp[name]
    k, n = t.shape
    if layout == "row_major":
        qp[name] = t.contiguous()
    elif layout == "misaligned":
        store = torch.zeros(n * k + 1, dtype=torch.int8)
        base = 1 if store.data_ptr() % 16 == 0 else 0
        view = store[base:base + n * k].view(n, k)
        view.copy_(t.t())
        qp[name] = view.t()
        assert tq.is_kmajor(qp[name]) and qp[name].data_ptr() % 16
    else:
        wide = torch.zeros(n, 2 * k, dtype=torch.int8)
        wide[:, :k] = t.t()
        qp[name] = wide[:, :k].t()
        assert not tq.is_kmajor(qp[name])
    with pytest.raises(ValueError, match=f"param {name}"):
        tq._check_quant_block_args(x, qp, heads)


@pytest.mark.parametrize("name", ["wo", "w2"])
def test_argument_check_keeps_the_other_weights_contiguous(name):
    """The bf16 weights Wo and W2 stay contiguous (K, N), as before: their
    K-major view is refused."""
    x, qp, heads = _arg_tree()
    qp[name] = qp[name].t().contiguous().t()
    with pytest.raises(ValueError, match=f"param {name}"):
        tq._check_quant_block_args(x, qp, heads)


def test_cpu_call_counts_no_launch():
    """On CPU tensors the wrapper runs the plain version on the K-major
    tree and counts no launch on either attention body."""
    x, qp, heads = _arg_tree()
    fn = tq.quant_fused_vit_block
    before = (fn.launches, fn.wgmma_launches, fn.streamed_launches)
    y = fn(x, qp, heads, 0.25, 37)
    assert y.shape == x.shape and torch.isfinite(y.float()).all()
    assert (fn.launches, fn.wgmma_launches, fn.streamed_launches) == before
