"""``Predictor.export`` and ``load_exported`` on the CPU, against the live
predictor and the JAX package's.

The port's counterpart of ``tests/test_serve.py``'s export tests.  The
forward kernels are ``torch.library`` ops (``devt_tpu_torch/ops/
_library.py``): an exported program keeps each call as one
``devt_tpu_torch::`` node, and on CPU tensors runs its plain version.  A
narrow PTN (``attention_impl="pallas"``, so that CPU tensors reach kernel
3's op) in f32 and quantized, and a tiny ViViT on the u8 wire (kernel 1's
op), each exported at batch 4 and loaded with ``device="cpu"``.

Tolerances.  The program runs the live predictor's operations on the same
inputs: 1e-6 on every score.  Against JAX (``"xla"`` attention for PTN,
its interpreted fused kernel for ViViT): f32 sums in other orders, 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu.config import Config as JConfig
from devt_tpu.data.device_norm import maybe_dequantize_batch as jdequantize
from devt_tpu.models import vivit as jv
from devt_tpu.registry import build_model as jbuild
from devt_tpu.registry import example_batch as jexample
from devt_tpu.serve import Predictor as JPredictor
from devt_tpu_torch import serve as tserve
from devt_tpu_torch.config import Config
from devt_tpu_torch.models import vivit as tv
from devt_tpu_torch.ops import flash_attention as tfa
from devt_tpu_torch.ops import fused_block as tfb
from devt_tpu_torch.ops import quant as tq
from devt_tpu_torch.serve import Predictor, load_exported
from devt_tpu_torch.utils.jax_bridge import jax_to_state_dict

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

PTN = dict(model="ptn", seq_len=3, nlayers=2, nhid=64, input_dimension=64,
           nhead=4, n_classes=15, dropout=0.0, precision="f32",
           experts=("a", "b"))
VIVIT = dict(image_size=32, patch_size=8, num_classes=5, num_frames=2,
             dim=32, depth=1, heads=2, dim_head=16, channels_last=True)
LIVE_TOL = dict(atol=1e-6, rtol=0)
JAX_TOL = dict(atol=2e-5, rtol=0)


def _np_tree(v):
    return jax.tree_util.tree_map(np.asarray, v)


def _ops_in(path) -> set:
    program = torch.export.load(str(path))
    return {str(n.target).split(".")[1] for n in program.graph.nodes
            if str(n.target).startswith("devt_tpu_torch.")}


@pytest.fixture(scope="module")
def ptn():
    jcfg = JConfig(**PTN, attention_impl="xla")
    x = jexample(jcfg, batch_size=1)["experts"]
    v = _np_tree(jax.jit(jbuild(jcfg).init)(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x)))
    batch = {"experts": np.random.default_rng(7).standard_normal(
        (4, 3, 2, 64)).astype(np.float32)}
    return jcfg, v, jax_to_state_dict(v), batch


@pytest.mark.parametrize("quantize", [False, True])
def test_exported_ptn_matches_live_and_jax(ptn, tmp_path, quantize):
    jcfg, v, sd, batch = ptn
    cfg = Config(**PTN, attention_impl="pallas")
    pred = Predictor(cfg, sd, buckets=(1, 4), device="cpu",
                     quantize=quantize)
    path = tmp_path / "ptn.pt2"
    pred.export(str(path))                    # the largest bucket, 4
    assert path.stat().st_size > 0
    assert _ops_in(path) == {"mha_fwd"}
    call = load_exported(str(path), device="cpu")
    launches = tfa.fused_mha.launches
    got = call(batch)
    assert tfa.fused_mha.launches == launches      # no kernel on the CPU
    assert got.shape == (4, 15) and got.dtype == np.float32
    np.testing.assert_allclose(got, pred.predict(batch)["scores"],
                               **LIVE_TOL)
    want = JPredictor(jcfg, v, buckets=(4,),
                      quantize=quantize).predict(batch)["scores"]
    np.testing.assert_allclose(got, want, **JAX_TOL)


def test_exported_vivit_on_the_u8_wire(tmp_path, monkeypatch):
    """A tiny ViViT (the registry builds ViViT only at its published
    width, so the predictor's model and example batch are swapped for the
    tiny one's): the program takes uint8 clips, normalises them on the
    device and runs kernel 1's op in its space block."""
    jm = jv.ViViT(attention_impl="fused_interpret", **VIVIT)
    v = _np_tree(jax.jit(jm.init)({"params": jax.random.PRNGKey(0)},
                                  jnp.zeros((1, 2, 32, 32, 3))))
    monkeypatch.setattr(tserve, "build_model",
                        lambda cfg: tv.ViViT(attention_impl="auto", **VIVIT))
    monkeypatch.setattr(tserve, "example_batch", lambda cfg, batch_size: {
        "vid": np.zeros((batch_size, 2, 32, 32, 3), np.float32)})
    cfg = Config(model="vivit", frame_len=2, n_classes=5, precision="f32",
                 dropout=0.0, wire_format="u8")
    pred = Predictor(cfg, jax_to_state_dict(v), buckets=(4,), device="cpu")
    path = tmp_path / "vivit.pt2"
    pred.export(str(path), batch_size=4, platforms=("cpu", "cuda"))
    assert _ops_in(path) == {"fused_block_fwd"}
    call = load_exported(str(path), device="cpu")
    clips = np.random.default_rng(3).integers(0, 256, (4, 2, 32, 32, 3),
                                              dtype=np.uint8)
    got = call({"vid": clips})
    np.testing.assert_allclose(got, pred.predict({"vid": clips})["scores"],
                               **LIVE_TOL)
    x = jdequantize({"vid": jnp.asarray(clips)}, dtype=jnp.float32)["vid"]
    want = np.asarray(jax.nn.sigmoid(jax.jit(jm.apply)(v, x)))
    np.testing.assert_allclose(got, want, **JAX_TOL)


def test_platforms_are_checked(ptn, tmp_path):
    _, _, sd, batch = ptn
    pred = Predictor(Config(**PTN, attention_impl="pallas"), sd,
                     buckets=(2,), device="cpu")
    with pytest.raises(ValueError, match="unknown platforms"):
        pred.export(str(tmp_path / "a.pt2"), platforms=("cpu", "tpu"))
    # the predictor's own device, by default: a program for the CPU only
    path = tmp_path / "cpu.pt2"
    pred.export(str(path), batch_size=1)
    with pytest.raises(ValueError, match="exported for"):
        load_exported(str(path), device="cuda")
    out = load_exported(str(path), device="cpu")(
        {"experts": batch["experts"][:1]})
    assert out.shape == (1, 15)


def test_load_exported_needs_a_card_by_default(monkeypatch):
    """No device argument and no CUDA: raise, never fall back to the
    CPU (before the file is read)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_exported("missing.pt2")


OPS = ("mha_fwd", "mha_fwd_dropout", "flash_single_fwd", "flash_blocked_fwd",
       "fused_block_fwd", "attn_half_fwd", "quant_block_fwd", "int8_matmul")


def _r(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen).to(dtype)


def _op_cases():
    gen = torch.Generator().manual_seed(0)
    b, s, dim, heads, mlp = 2, 16, 32, 2, 64
    shapes = {"g1": (1, dim), "b1": (1, dim), "wqkv": (dim, 3 * dim),
              "wo": (dim, dim), "bo": (1, dim), "g2": (1, dim),
              "b2": (1, dim), "w1": (dim, mlp), "bb1": (1, mlp),
              "w2": (mlp, dim), "bb2": (1, dim)}
    params = {k: _r(gen, *shape) for k, shape in shapes.items()}
    qp = tq.quant_block_params(params)
    x = _r(gen, b, s, dim)
    w_q, w_scale = tq.quantize_weight(_r(gen, 64, 64))

    def qkv():
        return _r(gen, b, s, 3 * dim)

    def heads_of(n):
        return _r(gen, b, heads, n, 16)

    return {
        "mha_fwd": (tfa.mha_fwd_op, (qkv(), heads, 0.25, 13, 0.0, 0)),
        "mha_fwd_dropout": (tfa.mha_fwd_op, (qkv(), heads, 0.25, 13, 0.1,
                                             7)),
        "flash_single_fwd": (tfa.flash_single_fwd_op,
                             (heads_of(s), heads_of(s), heads_of(s), 0.25,
                              13)),
        "flash_blocked_fwd": (tfa.flash_blocked_fwd_op,
                              (heads_of(s), heads_of(140), heads_of(140),
                               0.25, 133)),
        "fused_block_fwd": (tfb.fused_block_fwd_op,
                            (x, [params[k] for k in tfb.PARAM_NAMES], heads,
                             0.25, 13, 0.1, 5)),
        "attn_half_fwd": (tfb.attn_half_fwd_op,
                          (x, [params[k] for k in tfb.HALF_NAMES], heads,
                           0.25, 13)),
        "quant_block_fwd": (tq.quant_block_fwd_op,
                            (x, [qp[k] for k in tq.QUANT_PARAM_NAMES], heads,
                             0.25, 13)),
        "int8_matmul": (tq.int8_matmul_op,
                        (_r(gen, b, s, 64), tq._kmajor(w_q), w_scale)),
    }


@pytest.mark.parametrize("name", OPS)
def test_opcheck(name):
    """``torch.library.opcheck`` on each op at small CPU shapes: its
    schema, its fake implementation against the real one, and its tracing
    (kernels 3, 9, 11, 1, 7, 5 and 6)."""
    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)
