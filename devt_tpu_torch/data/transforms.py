"""Image, clip and expert-embedding transforms (host side, numpy + PIL):
port of ``devt_tpu/data/transforms.py``.

Reference transform stacks:
  * train images — RandomResizedCrop(224) → HFlip(p=.3) → VFlip(p=.3) →
    AutoAugment(IMAGENET) → normalize(ImageNet stats)
    (src/dataloaders/mmx/MMX_Frame_dl.py:63-71, MMX_Light_dl.py:183-191)
  * val images  — Resize(230) → CenterCrop(224) → normalize
    (MMX_Frame_dl.py:73-79)
  * clips       — Resize(120) → CenterCrop(112) → normalize(Kinetics stats)
    (+ RandomErasing at train in the frame loader, MMX_Frame_dl.py:81-96)
  * expert embeddings — p=0.3 zero-out (modality dropout) and p=0.3
    additive N(0, 0.1) noise at train (MMX_Temporal_dl.py:176-181)

Outputs are channels-last float32 numpy (HWC / THWC).  The image ops make
the same PIL calls and the same draws from the same ``random.Random`` as
the JAX package's, so their outputs are equal bit for bit.  PIL is
imported where an image op runs, never at import: the package imports on
a host without Pillow, where only the native decoder
(``data/native.py``) and the embedding transforms work.
"""

from __future__ import annotations

import math
import random

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
KINETICS_MEAN = np.array([0.43216, 0.394666, 0.37645], np.float32)
KINETICS_STD = np.array([0.22803, 0.22145, 0.216989], np.float32)


def _pil():
    """PIL's Image, ImageEnhance and ImageOps, imported on first use."""
    from PIL import Image, ImageEnhance, ImageOps

    return Image, ImageEnhance, ImageOps


# ---------------------------------------------------------------------------
# PIL geometry helpers (torchvision semantics)
# ---------------------------------------------------------------------------


def resize_shorter(img, size: int):
    """torchvision ``Resize(int)``: shorter side → size, keep aspect; the
    long side truncates (``int(size * long / short)``), as torchvision's."""
    Image = _pil()[0]
    w, h = img.size
    if w <= h:
        nw, nh = size, max(int(size * h / w), 1)
    else:
        nw, nh = max(int(size * w / h), 1), size
    return img.resize((nw, nh), Image.BILINEAR)


def center_crop(img, size: int):
    w, h = img.size
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img.crop((left, top, left + size, top + size))


def random_resized_crop(img, size: int, rng: random.Random,
                        scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """torchvision ``RandomResizedCrop`` sampling (10 tries, then the
    centre fallback); crop, then resize, as torchvision's resized_crop
    (PIL's ``resize(box=)`` samples outside the box at the borders)."""
    Image = _pil()[0]
    w, h = img.size
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = rng.randint(0, w - cw)
            top = rng.randint(0, h - ch)
            return img.crop((left, top, left + cw, top + ch)).resize(
                (size, size), Image.BILINEAR)
    # fallback: center crop at clamped aspect
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    left, top = (w - cw) // 2, (h - ch) // 2
    return img.crop((left, top, left + cw, top + ch)).resize(
        (size, size), Image.BILINEAR)


# ---------------------------------------------------------------------------
# AutoAugment (IMAGENET policy)
# ---------------------------------------------------------------------------

# torchvision transforms.AutoAugment() defaults, what the reference builds
# (MMX_Frame_dl.py:67): NEAREST interpolation, black fill.  Shear is
# F.affine about [0, 0] with angle atan(mag), whose inverse matrix is
# (1, ±mag, 0, 0, 1, 0); translates truncate to whole pixels with the
# inverse matrix's sign.
_FILL = (0, 0, 0)


def _affine(img, matrix):
    Image = _pil()[0]
    return img.transform(img.size, Image.AFFINE, matrix, Image.NEAREST,
                         fillcolor=_FILL)


def _shear_x(img, mag):
    return _affine(img, (1, mag, 0, 0, 1, 0))


def _shear_y(img, mag):
    return _affine(img, (1, 0, 0, mag, 1, 0))


def _translate_x(img, mag):
    return _affine(img, (1, 0, -int(mag * img.size[0]), 0, 1, 0))


def _translate_y(img, mag):
    return _affine(img, (1, 0, 0, 0, 1, -int(mag * img.size[1])))


def _rotate(img, mag):
    return img.rotate(mag, fillcolor=_FILL)


def _enhance(name):
    def op(img, mag):
        return getattr(_pil()[1], name)(img).enhance(1.0 + mag)
    return op


def _imageops(name, *, bits=False):
    def op(img, mag):
        fn = getattr(_pil()[2], name)
        return fn(img, int(mag)) if bits else fn(img)
    return op


_AA_OPS = {
    "ShearX": (_shear_x, 0.3),
    "ShearY": (_shear_y, 0.3),
    "TranslateX": (_translate_x, 150.0 / 331.0),
    "TranslateY": (_translate_y, 150.0 / 331.0),
    "Rotate": (_rotate, 30.0),
    "Color": (_enhance("Color"), 0.9),
    "Contrast": (_enhance("Contrast"), 0.9),
    "Brightness": (_enhance("Brightness"), 0.9),
    "Sharpness": (_enhance("Sharpness"), 0.9),
    "Posterize": (_imageops("posterize", bits=True), None),
    "Solarize": (_imageops("solarize", bits=True), None),
    "AutoContrast": (_imageops("autocontrast"), None),
    "Equalize": (_imageops("equalize"), None),
    "Invert": (_imageops("invert"), None),
}

# torchvision AutoAugmentPolicy.IMAGENET: 25 (op, p, magnitude-bin) pairs;
# magnitude bins are 0..9 over the op's range; signed ops flip randomly.
_IMAGENET_POLICY = [
    (("Posterize", 0.4, 8), ("Rotate", 0.6, 9)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, None)),
    (("Equalize", 0.8, None), ("Equalize", 0.6, None)),
    (("Posterize", 0.6, 7), ("Posterize", 0.6, 6)),
    (("Equalize", 0.4, None), ("Solarize", 0.2, 4)),
    (("Equalize", 0.4, None), ("Rotate", 0.8, 8)),
    (("Solarize", 0.6, 3), ("Equalize", 0.6, None)),
    (("Posterize", 0.8, 5), ("Equalize", 1.0, None)),
    (("Rotate", 0.2, 3), ("Solarize", 0.6, 8)),
    (("Equalize", 0.6, None), ("Posterize", 0.4, 6)),
    (("Rotate", 0.8, 8), ("Color", 0.4, 0)),
    (("Rotate", 0.4, 9), ("Equalize", 0.6, None)),
    (("Equalize", 0.0, None), ("Equalize", 0.8, None)),
    (("Invert", 0.6, None), ("Equalize", 1.0, None)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Rotate", 0.8, 8), ("Color", 1.0, 2)),
    (("Color", 0.8, 8), ("Solarize", 0.8, 7)),
    (("Sharpness", 0.4, 7), ("Invert", 0.6, None)),
    (("ShearX", 0.6, 5), ("Equalize", 1.0, None)),
    (("Color", 0.4, 0), ("Equalize", 0.6, None)),
    (("Equalize", 0.4, None), ("Solarize", 0.2, 4)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, None)),
    (("Invert", 0.6, None), ("Equalize", 1.0, None)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Equalize", 0.8, None), ("Equalize", 0.6, None)),
]

_SIGNED_SPANS = {
    "ShearX": 0.3, "ShearY": 0.3, "TranslateX": 150.0 / 331.0,
    "TranslateY": 150.0 / 331.0, "Rotate": 30.0, "Color": 0.9,
    "Contrast": 0.9, "Brightness": 0.9, "Sharpness": 0.9,
}


def _aa_magnitude(op: str, bin_idx, rng: random.Random):
    if bin_idx is None:
        return 0.0
    if op == "Posterize":
        # torchvision: 8 - (arange(10) / (9 / 4)).round() → 8..4 bits
        return 8 - int(np.round(bin_idx * 4.0 / 9.0))
    if op == "Solarize":
        # torchvision's float threshold linspace(255, 0, 10)[bin]; this
        # integer form keeps the same pixel partition for every bin
        return 255 - int(bin_idx / 9 * 255)
    span = _SIGNED_SPANS.get(op)
    mag = (span if span is not None else 0.0) * bin_idx / 9.0
    if span is not None and rng.random() < 0.5:
        mag = -mag
    return mag


def autoaugment(img, rng: random.Random):
    """Apply one random IMAGENET sub-policy (two chained probabilistic ops)."""
    pair = _IMAGENET_POLICY[rng.randrange(len(_IMAGENET_POLICY))]
    for op, p, bin_idx in pair:
        if rng.random() <= p:
            fn, _ = _AA_OPS[op]
            img = fn(img, _aa_magnitude(op, bin_idx, rng))
    return img


# ---------------------------------------------------------------------------
# Full stacks
# ---------------------------------------------------------------------------


def _normalize(arr: np.ndarray, mean, std) -> np.ndarray:
    return ((arr.astype(np.float32) / 255.0) - mean) / std


def train_image_transform(img, rng: random.Random,
                          size: int = 224) -> np.ndarray:
    """RandomResizedCrop → flips(p=.3) → AutoAugment → normalize → HWC f32."""
    Image = _pil()[0]
    img = random_resized_crop(img, size, rng)
    if rng.random() < 0.3:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    if rng.random() < 0.3:
        img = img.transpose(Image.FLIP_TOP_BOTTOM)
    img = autoaugment(img, rng)
    return _normalize(np.asarray(img, np.uint8), IMAGENET_MEAN, IMAGENET_STD)


def val_image_transform(img, size: int = 224,
                        resize: int = 230) -> np.ndarray:
    img = center_crop(resize_shorter(img, resize), size)
    return _normalize(np.asarray(img, np.uint8), IMAGENET_MEAN, IMAGENET_STD)


def _erase_box(h: int, w: int, rng: random.Random, scale, ratio):
    """One torchvision-RandomErasing box draw (≤10 attempts) or None."""
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
        eh = int(round(math.sqrt(target * aspect)))
        ew = int(round(math.sqrt(target / aspect)))
        if eh < h and ew < w:
            return rng.randint(0, h - eh), rng.randint(0, w - ew), eh, ew
    return None


def random_erasing(arr: np.ndarray, rng: random.Random, p: float = 0.5,
                   scale=(0.02, 0.33), ratio=(0.3, 3.3),
                   value: str | float = 0.0) -> np.ndarray:
    """torchvision ``RandomErasing`` on an HWC float array (train clips,
    MMX_Frame_dl.py:87): the default erases to ``value=0`` (zeros in
    normalized space); ``value="random"`` fills with gaussian noise."""
    if rng.random() >= p:
        return arr
    box = _erase_box(arr.shape[0], arr.shape[1], rng, scale, ratio)
    if box is None:
        return arr
    top, left, eh, ew = box
    arr = arr.copy()
    if value == "random":
        arr[top:top + eh, left:left + ew] = np.random.default_rng(
            rng.randrange(2**31)).standard_normal(
                (eh, ew, arr.shape[2])).astype(arr.dtype)
    else:
        arr[top:top + eh, left:left + ew] = arr.dtype.type(value)
    return arr


def random_erasing_u8(arr: np.ndarray, rng: random.Random,
                      mean=None, p: float = 0.5,
                      scale=(0.02, 0.33), ratio=(0.3, 3.3)) -> np.ndarray:
    """RandomErasing for the uint8 wire format: fills the box with
    ``round(mean·255)`` per channel, which the on-device normalize
    (``data/device_norm.py``) maps to ~0, the f32 path's fill within u8
    quantization (≤0.5/255/std ≈ 0.009)."""
    if rng.random() >= p:
        return arr
    box = _erase_box(arr.shape[0], arr.shape[1], rng, scale, ratio)
    if box is None:
        return arr
    top, left, eh, ew = box
    mean = KINETICS_MEAN if mean is None else np.asarray(mean, np.float32)
    arr = arr.copy()
    arr[top:top + eh, left:left + ew] = np.round(
        mean * 255.0).astype(np.uint8)
    return arr


def _erase_boxes(n: int, h: int, w: int, g: np.random.Generator,
                 scale, ratio):
    """Vectorized box draws: ``n`` frames × ≤10 attempts each (the
    accept-reject geometry of :func:`_erase_box`, batched)."""
    target = (h * w) * g.uniform(scale[0], scale[1], (n, 10))
    aspect = np.exp(g.uniform(np.log(ratio[0]), np.log(ratio[1]), (n, 10)))
    eh = np.rint(np.sqrt(target * aspect)).astype(np.int64)
    ew = np.rint(np.sqrt(target / aspect)).astype(np.int64)
    valid = (eh < h) & (ew < w)
    first = valid.argmax(axis=1)
    idx = np.arange(n)
    eh, ew = eh[idx, first], ew[idx, first]
    top = (g.random(n) * (h - eh + 1)).astype(np.int64)
    left = (g.random(n) * (w - ew + 1)).astype(np.int64)
    return valid.any(axis=1), top, left, eh, ew


def _erase_clip(clip: np.ndarray, rng: random.Random, fill, p, scale,
                ratio) -> np.ndarray:
    f, h, w, _ = clip.shape
    g = np.random.default_rng(rng.randrange(2**63))
    do = g.random(f) < p
    ok, top, left, eh, ew = _erase_boxes(f, h, w, g, scale, ratio)
    for i in np.nonzero(do & ok)[0]:
        clip[i, top[i]:top[i] + eh[i], left[i]:left[i] + ew[i]] = fill
    return clip


def random_erasing_clip_u8(clip: np.ndarray, rng: random.Random,
                           mean=None, p: float = 0.5,
                           scale=(0.02, 0.33), ratio=(0.3, 3.3)
                           ) -> np.ndarray:
    """Vectorized :func:`random_erasing_u8` over a whole (F, H, W, C) u8
    clip, IN PLACE: one numpy draw for every frame's coin flip and box
    geometry (its own numpy stream seeded from ``rng``), then the fills.
    The distribution is the per-frame function's; the sequence is not."""
    mean = KINETICS_MEAN if mean is None else np.asarray(mean, np.float32)
    return _erase_clip(clip, rng, np.round(mean * 255.0).astype(np.uint8),
                       p, scale, ratio)


def random_erasing_clip(clip: np.ndarray, rng: random.Random,
                        p: float = 0.5, scale=(0.02, 0.33),
                        ratio=(0.3, 3.3)) -> np.ndarray:
    """Vectorized :func:`random_erasing` (value=0, the torchvision
    default) over a whole (F, H, W, C) float clip, IN PLACE."""
    return _erase_clip(clip, rng, 0.0, p, scale, ratio)


def clip_frame_transform(img, rng: random.Random | None = None,
                         train: bool = False, size: int = 112,
                         resize: int = 120, erase: bool = False
                         ) -> np.ndarray:
    """Resize(120) → CenterCrop(112) → normalize(Kinetics) [→ RandomErasing]."""
    img = center_crop(resize_shorter(img, resize), size)
    arr = _normalize(np.asarray(img, np.uint8), KINETICS_MEAN, KINETICS_STD)
    if train and erase and rng is not None:
        arr = random_erasing(arr, rng)
    return arr


def expert_augment(x: np.ndarray, rng: random.Random,
                   p_drop: float = 0.3, p_noise: float = 0.3) -> np.ndarray:
    """Embedding-level augmentation (MMX_Temporal_dl.py:176-181):
    p=0.3 modality zero-out, p=0.3 additive N(0, 0.1) noise."""
    if rng.random() < p_drop:
        x = np.zeros_like(x)
    if rng.random() < p_noise:
        noise = np.random.default_rng(rng.randrange(2**31)).standard_normal(
            x.shape).astype(x.dtype)
        x = x + (0.1 ** 0.5) * noise
    return x


def pad_to_width(x: np.ndarray, width: int = 2048) -> np.ndarray:
    """Zero-pad (or cut) the last dim to ``width``
    (MMX_Temporal_dl.py:167-169)."""
    if x.shape[-1] == width:
        return x
    if x.shape[-1] > width:
        return x[..., :width]
    pad = [(0, 0)] * (x.ndim - 1) + [(0, width - x.shape[-1])]
    return np.pad(x, pad)
