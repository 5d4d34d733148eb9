"""How far one bf16 training gradient of R(2+1)D-18 lands from the f64
one, in the port and in the JAX package, on the CPU.

FrameTransformer's bf16 gradients through its video backbone cannot be
held card vs CPU (``chip_smoke.py``, ``_grad_check``): through a backbone
whose BatchNorms train on batch statistics, bf16's rounding leaves leaves
tenths of a leaf off the f64 step.  Whether the port's bf16 path loses
precision that JAX keeps is settled here against JAX's own bf16 step: the
same numpy weights (``randomize``), the same batch, the BatchNorms on
batch statistics as in training, the loss a fixed random projection of the
pooled features, three ways:

  * the port in f64, the reference, which records every ReLU's gate;
  * the port's plain CPU path in bf16;
  * JAX in bf16 (``devt_tpu.models.r2plus1d.r2plus1d_18``, jitted).

Both bf16 steps are held to the f64 step's ReLU gates (each ReLU is
``x * mask`` of the recorded sign): free, an input within rounding of 0
flips its gate and passes or stops a whole gradient term, and two sound
bf16 steps each land close to a whole leaf from f64 on the mean over the
leaves, as far as a gradient of zeros, so nothing can be told apart.
Held, they land 0.17 of a leaf off on the mean at this clip (8 x 4 x
48², 72 values a channel at layer4's BatchNorms).

Per leaf the distance is |bf16 - f64| as a share of the f64 leaf, both
in the root of the sum of squares.  The largest element's distance, which
``chip_smoke.py`` reads, is printed too; between two sound bf16 steps it
differs by ±0.05-0.1 of a leaf from leaf to leaf, where the share of the
norm differs by ±0.02.

XLA on the CPU may keep f32 between operations whose type is bf16
(``xla_allow_excess_precision``, on by default), where the port's eager
operations round each result to bf16.  Against that default the port is
farther from f64 on nearly every leaf.  So the gate compiles JAX's
step with the flag off, the program's own roundings: on every leaf the
port within JAX's distance + 5e-2.  Two broken bf16 steps fail it: a
gradient of zeros, and BatchNorm with its statistics in bf16 where flax
computes them in f32.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from devt_tpu.models import r2plus1d as jr2
from devt_tpu_torch.models import r2plus1d as tr2
from devt_tpu_torch.models.resnet import (BN_EPS, BatchNorm,
                                          collect_batch_stats)
from devt_tpu_torch.utils.jax_bridge import (jax_to_state_dict,
                                             state_dict_to_jax)
from test_torch_frame_transformer import randomize

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

CLIP = (8, 4, 48, 48, 3)
TOL = 5e-2


class _Gates:
    """Inside, ``F.relu`` records its input's sign (``record``) or is
    ``x * mask`` of the recorded sign, in call order (``replay``)."""

    def __init__(self):
        self.masks, self.mode = [], "record"

    def __call__(self, mode):
        self.mode, self.at = mode, 0
        return self

    def __enter__(self):
        self.real = F.relu

        def relu(x, inplace=False):
            if self.mode == "record":
                self.masks.append(x.detach() > 0)
                return self.real(x)
            self.at += 1
            return x * self.masks[self.at - 1].to(x.dtype)

        F.relu = relu
        return self

    def __exit__(self, *exc):
        F.relu = self.real


def _bf16_statistics(self, x, train=False):
    """BatchNorm's training forward with its statistics in the input's
    type (bf16), not promoted to f32: a port that lost precision."""
    axes = (0,) + tuple(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean = x.mean(axes)
    var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + BN_EPS) * self.weight.to(x.dtype)
    return ((x - mean.view(shape)) * mul.view(shape)
            + self.bias.to(x.dtype).view(shape)).to(self.dtype)


def _port_grads(sd, dtype, x, w, gates):
    model = tr2.r2plus1d_18(output="features", dtype=dtype)
    model.load_state_dict(sd)
    wide = torch.float64 if dtype == torch.float64 else torch.float32
    model.to(wide)
    params = dict(model.named_parameters())
    with collect_batch_stats(), gates:
        out = model(torch.from_numpy(x).to(wide), train=True)
    loss = (out.to(wide) * torch.from_numpy(w).to(wide)).sum()
    grads = torch.autograd.grad(loss, list(params.values()))
    return {k: g.double().numpy() for k, g in zip(params, grads)}


def _jax_grads(chain, excess_precision):
    """JAX's bf16 gradient, every ReLU (``flax.linen.relu``, as the JAX
    model calls it) ``x * mask`` of the port's recorded gates in flax's
    (N, T, H, W, C) layout."""
    jm = jr2.r2plus1d_18(output="features", dtype=jnp.bfloat16)

    def loss(params, stats, x, w, masks):
        gates = iter(masks)
        real = flax.linen.relu
        flax.linen.relu = lambda v: v * next(gates).astype(v.dtype)
        try:
            out, _ = jm.apply({"params": params, "batch_stats": stats}, x,
                              train=True, mutable=["batch_stats"])
        finally:
            flax.linen.relu = real
        return jnp.sum(out.astype(jnp.float32) * w)

    v = chain["variables"]
    args = (v["params"], v["batch_stats"], jnp.asarray(chain["x"]),
            jnp.asarray(chain["w"]), chain["masks"])
    step = jax.jit(jax.grad(loss)).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": excess_precision})
    return jax_to_state_dict(jax.tree_util.tree_map(np.asarray, step(*args)),
                             dtype=np.float64)


def _distance(grads, f64, norm=True):
    """Per leaf, |grads - f64| as a share of the f64 leaf: in the root of
    the sum of squares, or (``norm=False``) in the largest element."""
    measure = np.linalg.norm if norm else (lambda a: np.abs(a).max())
    return np.array([measure(np.asarray(grads[k]) - v) / measure(v)
                     for k, v in f64.items()])


def _past_gate(port, jax_):
    """The leaves on which the port is farther from f64 than JAX + TOL."""
    return np.flatnonzero(port > jax_ + TOL)


@pytest.fixture(scope="module")
def chain():
    sd = randomize(tr2.r2plus1d_18(output="features")).state_dict()
    x = np.random.default_rng(0).standard_normal(CLIP).astype(np.float32)
    w = np.random.default_rng(100).standard_normal((CLIP[0], 512)).astype(
        np.float32)
    gates = _Gates()
    f64 = _port_grads(sd, torch.float64, x, w, gates("record"))
    out = {"sd": sd, "x": x, "w": w, "gates": gates, "f64": f64,
           "variables": jax.tree_util.tree_map(jnp.asarray,
                                               state_dict_to_jax(sd)),
           "masks": [jnp.asarray(m.permute(0, 2, 3, 4, 1).numpy())
                     for m in gates.masks]}
    out["port"] = _port_grads(sd, torch.bfloat16, x, w, gates("replay"))
    out["jax"] = _jax_grads(out, excess_precision=False)
    assert set(out["jax"]) == set(out["port"]) == set(f64)
    return out


def test_port_bf16_chain_is_as_far_from_f64_as_jax(chain):
    f64 = chain["f64"]
    port, ref = _distance(chain["port"], f64), _distance(chain["jax"], f64)
    top_port = _distance(chain["port"], f64, norm=False)
    top_ref = _distance(chain["jax"], f64, norm=False)
    assert all(np.isfinite(g).all() for g in chain["port"].values())
    worst = int(np.argmax(port - ref))
    print(f"bf16 held to the f64 step's ReLU gates, {len(f64)} leaves, "
          f"distance from f64 as a share of the leaf's norm: port mean "
          f"{port.mean():.4f} worst {port.max():.4f}, JAX mean "
          f"{ref.mean():.4f} worst {ref.max():.4f}; port less JAX from "
          f"{(port - ref).min():+.4f} to {(port - ref).max():+.4f} (at "
          f"{list(f64)[worst]}), port farther on {(port > ref).mean():.0%}"
          f"; of the largest element: port mean {top_port.mean():.4f} worst "
          f"{top_port.max():.4f}, JAX mean {top_ref.mean():.4f} worst "
          f"{top_ref.max():.4f}, port less JAX from "
          f"{(top_port - top_ref).min():+.4f} to "
          f"{(top_port - top_ref).max():+.4f}")
    assert not len(_past_gate(port, ref)), [
        (list(f64)[i], port[i], ref[i]) for i in _past_gate(port, ref)]


@pytest.mark.parametrize("broken", ["zero", "bf16_statistics"])
def test_gate_refuses_a_broken_bf16_chain(chain, broken, monkeypatch):
    f64 = chain["f64"]
    if broken == "zero":
        grads = {k: np.zeros_like(v) for k, v in f64.items()}
    else:
        monkeypatch.setattr(BatchNorm, "forward", _bf16_statistics)
        grads = _port_grads(chain["sd"], torch.bfloat16, chain["x"],
                            chain["w"], chain["gates"]("replay"))
    got, ref = _distance(grads, f64), _distance(chain["jax"], f64)
    past = _past_gate(got, ref)
    print(f"{broken}: farther than JAX + {TOL} on {len(past)} of {len(f64)} "
          f"leaves, by up to {(got - ref).max() - TOL:.4f} more; mean "
          f"{got.mean():.4f} against JAX's {ref.mean():.4f}")
    assert len(past) > 0


def test_jax_default_keeps_f32_between_bf16_ops(chain):
    """JAX's default compile lands nearer f64 than its program's own
    roundings: the share by which the port is farther than it."""
    f64 = chain["f64"]
    default = _distance(_jax_grads(chain, excess_precision=True), f64)
    rounded = _distance(chain["jax"], f64)
    port = _distance(chain["port"], f64)
    print(f"JAX default mean {default.mean():.4f}, with every bf16 result "
          f"rounded {rounded.mean():.4f}, the port {port.mean():.4f}; the "
          f"port farther than JAX's default on {(port > default).mean():.0%}"
          f" of the leaves, than JAX rounded on {(port > rounded).mean():.0%}")
    assert default.mean() < rounded.mean()
