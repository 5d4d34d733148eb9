"""The port's PIL transforms against the JAX package's, bit for bit.

Every AutoAugment op (the 35 (op, bin, sign) cases of the golden set) on
``tests/fixtures/transform_fixture.png`` against ``devt_tpu.data.
transforms`` and on the golden fixture against the committed
``transform_golden.npz``; both full stacks against the goldens and
against JAX under the same ``random.Random`` seeds; each of the 25
IMAGENET sub-policies, picked in turn, under several seeds;
RandomResizedCrop's draws and its fallback at either aspect clamp; the
geometry helpers; the erasing family in f32 and u8, per frame and
vectorised over a clip; the clip stack with and without erasing.
"""

import os
import random
import sys

import numpy as np
import pytest
from PIL import Image

from devt_tpu.data import transforms as J
from devt_tpu_torch.data import transforms as T

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
sys.path.insert(0, FIXTURES)
import gen_transform_golden as gen  # noqa: E402
import oracle_torchvision as tv  # noqa: E402

GOLDEN = np.load(os.path.join(FIXTURES, "transform_golden.npz"))
SEEDS = (0, 1, 2, 3, 7, 11)


def _fixture() -> Image.Image:
    return Image.open(os.path.join(FIXTURES, "transform_fixture.png")) \
        .convert("RGB")


def _big() -> Image.Image:
    return tv.fixture_image(w=283, h=311, seed=9)


class _SignRng:
    """Drives ``_aa_magnitude``'s sign flip: random() above or below 0.5."""

    def __init__(self, sign):
        self._r = 0.9 if sign >= 0 else 0.1

    def random(self):
        return self._r


def _op(module, img, op, bin_idx, sign):
    fn, _ = module._AA_OPS[op]
    return np.asarray(fn(img, module._aa_magnitude(op, bin_idx,
                                                   _SignRng(sign))),
                      np.uint8)


@pytest.mark.parametrize("case", gen.CASES,
                         ids=[gen.case_key(*c) for c in gen.CASES])
def test_every_op_equals_jax_and_the_golden(case):
    img = _fixture()
    np.testing.assert_array_equal(_op(T, img, *case), _op(J, img, *case))
    golden = Image.fromarray(GOLDEN["fixture"], "RGB")
    np.testing.assert_array_equal(_op(T, golden, *case),
                                  GOLDEN[gen.case_key(*case)])


def test_stacks_equal_the_goldens_and_jax():
    big = _big()
    np.testing.assert_array_equal(T.val_image_transform(big),
                                  GOLDEN["stack_val"])
    for seed in (0, 1, 2, 3):
        np.testing.assert_array_equal(
            T.train_image_transform(big, random.Random(seed), size=64),
            GOLDEN[f"stack_train_s{seed}"])
    img = _fixture()
    for seed in SEEDS:
        np.testing.assert_array_equal(
            T.train_image_transform(img, random.Random(seed), size=48),
            J.train_image_transform(img, random.Random(seed), size=48))
        rng_t, rng_j = random.Random(seed), random.Random(seed)
        T.train_image_transform(big, rng_t)
        J.train_image_transform(big, rng_j)
        assert rng_t.random() == rng_j.random()     # the same draws
    np.testing.assert_array_equal(T.val_image_transform(img, 48, 52),
                                  J.val_image_transform(img, 48, 52))


class _Policy(random.Random):
    """A ``random.Random`` whose one ``randrange`` (the sub-policy pick)
    returns ``index``."""

    def __init__(self, index, seed):
        super().__init__(seed)
        self.index = index

    def randrange(self, *args, **kwargs):
        return self.index


@pytest.mark.parametrize("index", range(len(J._IMAGENET_POLICY)))
def test_each_sub_policy_equals_jax(index):
    assert T._IMAGENET_POLICY == J._IMAGENET_POLICY
    img = _fixture()
    for seed in SEEDS:
        rng_t, rng_j = _Policy(index, seed), _Policy(index, seed)
        np.testing.assert_array_equal(
            np.asarray(T.autoaugment(img, rng_t)),
            np.asarray(J.autoaugment(img, rng_j)), err_msg=f"seed {seed}")
        assert rng_t.random() == rng_j.random()


def test_magnitudes_equal_jax():
    for op in J._AA_OPS:
        for b in (None, *range(10)):
            if b is None and op not in ("AutoContrast", "Equalize",
                                        "Invert"):
                continue
            if b is not None and op in ("AutoContrast", "Equalize",
                                        "Invert"):
                continue
            for sign in (1, -1):
                assert T._aa_magnitude(op, b, _SignRng(sign)) \
                    == J._aa_magnitude(op, b, _SignRng(sign)), (op, b, sign)


@pytest.mark.parametrize("size", [(40, 300), (300, 40), (120, 100)],
                         ids=["tall", "wide", "within"])
def test_random_resized_crop_and_its_fallback(size):
    rng = np.random.default_rng(3)
    img = Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3),
                                       dtype=np.uint8))
    # scale above 1: no try fits, the centre fallback at clamped aspect
    for scale in ((1.5, 2.0), (0.08, 1.0)):
        for seed in SEEDS:
            np.testing.assert_array_equal(
                np.asarray(T.random_resized_crop(img, 32, random.Random(seed),
                                                 scale=scale)),
                np.asarray(J.random_resized_crop(img, 32, random.Random(seed),
                                                 scale=scale)))


def test_geometry_helpers_equal_jax():
    img = _big()
    for size in (1, 60, 230):
        np.testing.assert_array_equal(np.asarray(T.resize_shorter(img, size)),
                                      np.asarray(J.resize_shorter(img, size)))
    for size in (10, 61):
        np.testing.assert_array_equal(np.asarray(T.center_crop(img, size)),
                                      np.asarray(J.center_crop(img, size)))


def test_clip_stack_equals_jax():
    img = _big()
    np.testing.assert_array_equal(T.clip_frame_transform(img),
                                  J.clip_frame_transform(img))
    for seed in SEEDS:
        np.testing.assert_array_equal(
            T.clip_frame_transform(img, random.Random(seed), train=True,
                                   erase=True, size=64, resize=70),
            J.clip_frame_transform(img, random.Random(seed), train=True,
                                   erase=True, size=64, resize=70))


@pytest.mark.parametrize("value", [0.0, "random"])
def test_random_erasing_f32_equals_jax(value):
    arr = np.random.default_rng(0).standard_normal((40, 30, 3)) \
        .astype(np.float32)
    erased = 0
    for seed in range(12):
        got = T.random_erasing(arr, random.Random(seed), value=value)
        want = J.random_erasing(arr, random.Random(seed), value=value)
        np.testing.assert_array_equal(got, want)
        erased += not np.array_equal(got, arr)
    assert erased > 0


def test_random_erasing_u8_equals_jax():
    arr = np.random.default_rng(1).integers(0, 256, (40, 30, 3),
                                            dtype=np.uint8)
    for seed in range(12):
        for mean in (None, (0.1, 0.5, 0.9)):
            np.testing.assert_array_equal(
                T.random_erasing_u8(arr, random.Random(seed), mean=mean),
                J.random_erasing_u8(arr, random.Random(seed), mean=mean))
    # boxes that never fit: the draw gives up after 10 tries
    tiny = arr[:2, :2]
    np.testing.assert_array_equal(
        T.random_erasing_u8(tiny, random.Random(0), p=1.0),
        J.random_erasing_u8(tiny, random.Random(0), p=1.0))


@pytest.mark.parametrize("kind", ["f32", "u8"])
def test_vectorised_clip_erasing_equals_jax(kind):
    rng = np.random.default_rng(2)
    if kind == "u8":
        clip = rng.integers(0, 256, (12, 28, 20, 3), dtype=np.uint8)
        fns = (T.random_erasing_clip_u8, J.random_erasing_clip_u8)
    else:
        clip = rng.standard_normal((12, 28, 20, 3)).astype(np.float32)
        fns = (T.random_erasing_clip, J.random_erasing_clip)
    for seed in range(6):
        got, want = clip.copy(), clip.copy()
        assert fns[0](got, random.Random(seed)) is got     # in place
        fns[1](want, random.Random(seed))
        np.testing.assert_array_equal(got, want)
    g_t, g_j = np.random.default_rng(5), np.random.default_rng(5)
    for a, b in zip(T._erase_boxes(9, 28, 20, g_t, (0.02, 0.33), (0.3, 3.3)),
                    J._erase_boxes(9, 28, 20, g_j, (0.02, 0.33), (0.3, 3.3))):
        np.testing.assert_array_equal(a, b)


def test_constants_equal_jax():
    for name in ("IMAGENET_MEAN", "IMAGENET_STD", "KINETICS_MEAN",
                 "KINETICS_STD"):
        np.testing.assert_array_equal(getattr(T, name), getattr(J, name))
