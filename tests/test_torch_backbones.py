"""The port's convolutional backbones and the bridge's conv and BatchNorm
leaves against the JAX package's, on the CPU.

ResNet-18 (image 48), ResNet-50 (image 32, the Bottleneck block, its
``stages`` output), R(2+1)D-18 and R3D-18 (clips of 4 x 32 x 32), batch 2,
f32, with the port's weights drawn from numpy (``randomize`` of
``test_torch_frame_transformer.py``: non-trivial BatchNorm scales, biases
and running statistics) and carried into flax by ``utils.jax_bridge``:

  * eval: the outputs, normalised by the running statistics;
  * training: the outputs, normalised by the batch statistics, and the
    new running statistics (flax's ``batch_stats`` after ``mutable``; the
    port's through ``collect_batch_stats``).

Tolerance: f32 on both sides with sums in other orders, through up to 18
convolutions and BatchNorms: atol 1e-4 / rtol 1e-3, and the statistics
the same.

The bridge: a JAX → port → JAX round trip of a FrameTransformer tree with
``params`` and ``batch_stats`` gives back every leaf bit for bit, and a
non-square kernel (a Conv of (3, 5), the (1, 7, 7) and (3, 1, 1) 3-D
kernels) computes in torch what it computes in flax, so a kernel whose kh
and kw were swapped fails.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from devt_tpu.models import r2plus1d as jr2
from devt_tpu.models import resnet as jres
from devt_tpu.models.frame_transformer import FrameTransformer as JFT
from devt_tpu_torch.models import r2plus1d as tr2
from devt_tpu_torch.models import resnet as tres
from devt_tpu_torch.models.frame_transformer import FrameTransformer
from devt_tpu_torch.utils.jax_bridge import (jax_to_state_dict,
                                             state_dict_to_jax)
from test_torch_frame_transformer import jax_variables, randomize

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-3)

CASES = {
    "resnet18": (jres.resnet18, tres.resnet18, dict(output="features"),
                 (2, 48, 48, 3)),
    "resnet50": (jres.resnet50, tres.resnet50, dict(output="stages"),
                 (2, 32, 32, 3)),
    "r2plus1d_18": (jr2.r2plus1d_18, tr2.r2plus1d_18,
                    dict(output="features"), (2, 4, 32, 32, 3)),
    "r3d_18": (jr2.r3d_18, tr2.r3d_18, dict(output="logits",
                                            num_classes=10),
               (2, 4, 32, 32, 3)),
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(dict(v), f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("name,train", [
    ("resnet18", False), ("resnet18", True), ("resnet50", False),
    ("r2plus1d_18", False), ("r2plus1d_18", True), ("r3d_18", False)])
def test_backbone_matches_flax(name, train):
    """Training is held on the two backbones FrameTransformer runs."""
    jfn, tfn, kw, shape = CASES[name]
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    tm = randomize(tfn(**kw))
    jm = jfn(**kw)
    variables = jax_variables(tm)
    if train:
        jout, jmut = jax.jit(lambda v, a: jm.apply(
            v, a, train=True, mutable=["batch_stats"]))(variables,
                                                         jnp.asarray(x))
    else:
        jout = jax.jit(lambda v, a: jm.apply(v, a))(variables, jnp.asarray(x))
    with torch.no_grad(), tres.collect_batch_stats() as stats:
        out = tm(torch.from_numpy(x), train=train)
    outs = out if isinstance(out, tuple) else (out,)
    jouts = jout if isinstance(jout, tuple) else (jout,)
    for got, want in zip(outs, jouts):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if not train:
        assert not stats
        return
    path = {m: n for n, m in tm.named_modules()}
    new = {}
    for m, (mean, var) in stats.items():
        new[f"{path[m]}.running_mean"], new[f"{path[m]}.running_var"] = \
            mean, var
    want = _flat(state_dict_to_jax(new)["batch_stats"])
    got = _flat(dict(jmut["batch_stats"]))
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(want[k], got[k], err_msg=k, **TOL)
    # a training forward outside a collector has nowhere to put them
    with pytest.raises(RuntimeError, match="collect_batch_stats"), \
            torch.no_grad():
        tm(torch.from_numpy(x), train=True)


def test_batchnorm_keeps_flax_statistics_in_bf16():
    """Statistics and the normalisation in f32 on a bf16 input, the biased
    variance in the running update; the output in the compute type."""
    bn = tres.BatchNorm(3, dtype=torch.bfloat16)
    x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    with tres.collect_batch_stats() as stats:
        y = bn(x.bfloat16(), train=True)
    xf = x.bfloat16().float()
    mean, var = stats[bn]
    torch.testing.assert_close(mean, 0.1 * xf.mean((0, 2, 3)))
    torch.testing.assert_close(
        var, 0.9 + 0.1 * xf.var((0, 2, 3), unbiased=False),
        atol=1e-6, rtol=1e-5)
    assert y.dtype == torch.bfloat16
    assert torch.equal(bn.running_mean, torch.zeros(3))


@pytest.mark.parametrize("kernel", [(3, 5), (1, 7, 7), (3, 1, 1)])
def test_bridge_maps_non_square_conv_kernels(kernel):
    """A flax Conv kernel carried over computes the same convolution in
    torch; ``.T`` would reverse kh and kw (and reverse every axis of a 3-D
    kernel)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2,) + (9,) * len(kernel) + (3,)).astype(
        np.float32)
    conv = fnn.Conv(4, kernel, padding="VALID", use_bias=False)
    params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(conv.apply({"params": params}, jnp.asarray(x)))
    w = jax_to_state_dict({"c": {"kernel": np.asarray(params["kernel"])}})[
        "c.weight"]
    assert tuple(w.shape) == (4, 3) + kernel
    fn = F.conv2d if len(kernel) == 2 else F.conv3d
    got = fn(torch.from_numpy(np.moveaxis(x, -1, 1)), w)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want,
                               atol=1e-5, rtol=1e-5)
    back = state_dict_to_jax({"c.weight": w})["params"]["c"]["kernel"]
    np.testing.assert_array_equal(back, np.asarray(params["kernel"]))


def test_bridge_round_trips_a_frame_transformer_tree():
    """JAX variables of the distil variant (``params`` and
    ``batch_stats``, drawn leaf by leaf from numpy in eval_shape's
    shapes) → the port's state_dict, loaded strictly → JAX again: every
    leaf back bit for bit, the BatchNorm buffers from ``batch_stats``, no
    ``num_batches_tracked``."""
    small = dict(seq_len=3, frame_len=4, img_size=64, vid_size=32)
    jm = JFT(model="distil", attention_impl="xla", **small)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, img=jnp.zeros((1, 3, 64, 64, 3)),
        vid=jnp.zeros((1, 3, 4, 32, 32, 3))))
    rng = np.random.default_rng(7)
    variables = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        {k: dict(v) for k, v in dict(shapes).items()})
    sd = jax_to_state_dict(variables)
    assert not any(k.endswith("num_batches_tracked") for k in sd)
    tm = FrameTransformer(model="distil", **small)
    tm.load_state_dict(sd)      # strict: the same keys and shapes
    stem = variables["params"]["vid_backbone"]["stem_temporal"]["conv"][
        "kernel"]                                    # (3, 1, 1, 45, 64)
    np.testing.assert_array_equal(
        tm.vid_backbone.stem_temporal.conv.weight.detach().numpy(),
        stem.transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(
        tm.img_backbone.layer1_0.conv1.bn.running_var.numpy(),
        variables["batch_stats"]["img_backbone"]["layer1_0"]["conv1"]["bn"][
            "var"])
    back = state_dict_to_jax(tm.state_dict())
    assert set(back) == {"params", "batch_stats"}
    want, got = _flat(variables), _flat(back)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
