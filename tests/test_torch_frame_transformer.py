"""The port's FrameTransformer against the JAX package's, on the CPU.

Every variant at the sizes ``tests/test_models.py`` uses (``seq_len`` 3,
``frame_len`` 4, image 64, clip 4 x 32 x 32, batch 2, f32), with the
port's weights (drawn from a seed, BatchNorm statistics and biases made
non-trivial) carried into the JAX model by ``utils.jax_bridge``.  The
JAX side runs its materialised attention (``"xla"``), the port ``"xla"``
and ``"pallas"`` (on CPU tensors the packed-qkv kernels' plain forward).

  * the state_dict, mapped to the flax tree, has the keys and shapes of
    ``jax.eval_shape(model.init, ...)`` for that variant: no module the
    variant does not call, none missing;
  * the outputs (``logits``, ``embedding`` and distil's
    ``distil_logits``, ``teacher_logits``) in eval, f32 on both sides with
    sums in other orders: atol 1e-4 / rtol 1e-3, the backbones' bound
    (``test_torch_backbones.py``), since the features pass through two
    18-layer convolution stacks before the transformers;
  * the same without the CLS inputs (``use_cls=False``, ``Config.cls`` 0)
    for ``vid``, ``distil`` and ``pre_modal``, at the same bound.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devt_tpu.models.frame_transformer import FrameTransformer as JFT
from devt_tpu.models.frame_transformer import VARIANTS
from devt_tpu_torch.models.frame_transformer import FrameTransformer
from devt_tpu_torch.models.resnet import collect_batch_stats
from devt_tpu_torch.utils.jax_bridge import state_dict_to_jax

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

SMALL = dict(seq_len=3, frame_len=4, n_classes=19, img_size=64, vid_size=32)
TOL = dict(atol=1e-4, rtol=1e-3)


def _inputs(seed=0, b=2):
    rng = np.random.default_rng(seed)
    s, f = SMALL["seq_len"], SMALL["frame_len"]
    img = rng.standard_normal((b, s, 64, 64, 3)).astype(np.float32)
    vid = rng.standard_normal((b, s, f, 32, 32, 3)).astype(np.float32)
    return img, vid


def randomize(model: torch.nn.Module, seed: int = 1) -> torch.nn.Module:
    """Every parameter and buffer of the state_dict drawn from numpy:
    kernels normal with variance 1 / fan-in, biases and running means
    0.1-scaled normals, BatchNorm scales and running variances uniform in
    [0.5, 1.5), the CLS inputs uniform in [0, 1)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in model.state_dict(keep_vars=True).items():
            shape = tuple(t.shape)
            if name.endswith(("running_var", "bn.weight", "bn1.weight",
                              "bn2.weight")):
                a = rng.uniform(0.5, 1.5, shape)
            elif name.endswith(("running_mean", ".bias")):
                a = 0.1 * rng.standard_normal(shape, dtype=np.float32)
            elif name.endswith("_cls"):
                a = rng.random(shape, dtype=np.float32)
            elif name.endswith("norm1.weight") or name.endswith(
                    "norm2.weight"):
                a = rng.uniform(0.5, 1.5, shape)
            else:
                a = rng.standard_normal(shape, dtype=np.float32) \
                    * (shape[0] / t.numel()) ** 0.5
            t.copy_(torch.from_numpy(np.asarray(a, dtype=np.float32)))
    return model


def port_model(variant, **kw):
    """The port's model with numpy-drawn weights (``randomize``): the
    flax initializers' draws are ``build_model``'s business, and
    ``test_torch_serve.py`` holds them."""
    return randomize(FrameTransformer(model=variant, **{**SMALL, **kw}))


def jax_variables(model: torch.nn.Module) -> dict:
    return jax.tree_util.tree_map(jnp.asarray,
                                  state_dict_to_jax(model.state_dict()))


def _shapes(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(x.shape)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _jax_case(variant, use_cls=True):
    """The variant's flax tree (keys and shapes, from ``eval_shape`` of its
    init) and its outputs on the port's weights, once per variant."""
    img, vid = _inputs()
    jm = JFT(model=variant, attention_impl="xla", use_cls=use_cls, **SMALL)
    want = jax.eval_shape(
        lambda: jm.init({"params": jax.random.PRNGKey(0)},
                        img=jnp.asarray(img), vid=jnp.asarray(vid)))
    variables = jax_variables(_cached_port_model(variant, use_cls))
    jout = jax.jit(lambda v, i, c: jm.apply(v, img=i, vid=c))(
        variables, jnp.asarray(img), jnp.asarray(vid))
    return (_shapes(dict(want)), _shapes(variables),
            {k: np.asarray(v) for k, v in jout.items()})


@functools.lru_cache(maxsize=None)
def _cached_port_model(variant, use_cls=True):
    return port_model(variant, use_cls=use_cls).eval()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_tree_and_outputs_match_jax(variant, impl):
    img, vid = _inputs()
    tm = _cached_port_model(variant)
    for m in tm.modules():       # the encoders' attention route
        if hasattr(m, "attention_impl"):
            m.attention_impl = impl
    want_tree, tree, jout = _jax_case(variant)
    assert tree == want_tree
    with torch.no_grad():
        out = tm(img=torch.from_numpy(img), vid=torch.from_numpy(vid))
    assert set(out) == set(jout)
    for k in out:
        assert out[k].shape == jout[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), jout[k],
                                   err_msg=k, **TOL)



@pytest.mark.parametrize("variant", ["vid", "distil", "pre_modal"])
def test_variant_without_cls_matches_jax(variant):
    """``use_cls=False`` (``Config.cls`` 0): no CLS inputs in the tree, the
    first scene's token pooled; the tree and the outputs as JAX's."""
    img, vid = _inputs()
    tm = _cached_port_model(variant, False)
    want_tree, tree, jout = _jax_case(variant, False)
    assert tree == want_tree
    assert not {"vid_cls", "img_cls"} & {k.split(".")[0] for k in
                                         tm.state_dict()}
    with torch.no_grad():
        out = tm(img=torch.from_numpy(img), vid=torch.from_numpy(vid))
    assert set(out) == set(jout)
    for k in out:
        np.testing.assert_allclose(out[k].numpy(), jout[k],
                                   err_msg=k, **TOL)

def test_variants_build_what_they_call():
    """``vid`` builds no image side and no scene transformer, ``frame`` no
    video side, ``pre_modal`` no distil transformer; both CLS inputs
    exist in every variant, as flax's ``setup`` creates them."""
    names = {v: {k.split(".")[0] for k in
                 FrameTransformer(model=v, **SMALL).state_dict()}
             for v in ("vid", "frame", "pre_modal", "distil")}
    common = {"vid_cls", "img_cls", "img_mlp_head"}
    assert names["vid"] == common | {"vid_backbone", "vid_fc",
                                     "distil_transformer"}
    assert names["frame"] == common | {"img_backbone", "img_fc",
                                       "scene_transformer"}
    assert names["pre_modal"] == names["distil"] - {"distil_transformer"}
    with pytest.raises(ValueError, match="unknown variant"):
        FrameTransformer(model="frame_transformer_vid")


def test_frozen_image_side_carries_no_gradient():
    """``freeze_img``: the image backbone and ``img_fc`` take no part in
    the gradient; the video side and the scene transformer do."""
    img, vid = _inputs(b=1)
    tm = port_model("distil", dropout=0.0).train()
    with collect_batch_stats():
        out = tm(img=torch.from_numpy(img), vid=torch.from_numpy(vid))
    out["logits"].sum().backward()
    for name, p in tm.named_parameters():
        frozen = name.startswith(("img_backbone.", "img_fc.", "img_cls"))
        assert (p.grad is None) == frozen, name
