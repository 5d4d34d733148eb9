"""Synthetic data: port of ``devt_tpu/data/synthetic.py``.

Deterministic, reference-shaped batches for every model family
(``SyntheticDataModule`` on ``registry.example_batch``), the fake MMX and
MIT expert corpora (``.npy`` tensors and streamed-pickle manifests), and
the fake frame corpora: PNG frame trees, the light corpus with its
``out.csv``, and an MJPEG AVI; and Lightning checkpoints shaped like
the reference's (``write_fake_lightning_checkpoint``).  The pixels are the JAX package's writers'
draws from the same seed.  PNGs are written by :func:`write_png` (zlib and
struct from the standard library), so a host without Pillow writes them
too; the AVI's JPEG frames need PIL.
"""

from __future__ import annotations

import csv
import os
import struct
import zlib
from collections import OrderedDict

import numpy as np

from devt_tpu_torch.config import MMX_GENRES_15, MMX_GENRES_19, Config
from devt_tpu_torch.data.manifests import (append_pickle,
                                           load_moments_categories)
from devt_tpu_torch.models.r2plus1d import _midplanes
from devt_tpu_torch.registry import example_batch


class SyntheticDataModule:
    """Fixed-shape random batches shaped for ``config.model``."""

    def __init__(self, config: Config, train_size: int = 8,
                 val_size: int = 4, test_size: int = 4):
        self.config = config
        self.train_steps = max(train_size // config.batch_size, 1)
        self.val_steps = max(val_size // config.batch_size, 1)
        self.test_steps = max(test_size // config.batch_size, 1)

    def setup(self):
        return self

    def _batches(self, n, seed0):
        for i in range(n):
            cfg = self.config.replace(seed=seed0 + i)
            yield example_batch(cfg)

    def train_batches(self):
        return self._batches(self.train_steps, self.config.seed)

    def val_batches(self):
        return self._batches(self.val_steps, self.config.seed + 10_000)

    def test_batches(self):
        return self._batches(self.test_steps, self.config.seed + 20_000)


def write_fake_expert_corpus(root: str, n_movies: int = 8,
                             scenes_per_movie: int = 6,
                             experts=("img-embeddings", "location-embeddings",
                                      "video-embeddings"),
                             with_test_prefix: bool = True,
                             seed: int = 0) -> tuple[str, str]:
    """Synthetic MMX-temporal corpus: .npy expert tensors (width 512 for a
    video expert, 2048 for the others) + streamed-pickle train/val
    manifests with the reference's record structure (``{"label":
    [[genres]], "path": str, "scenes": {sid: {chunk: {expert: [paths]}}}}``
    — create_mmx_temporal.py:20-81)."""
    rng = np.random.default_rng(seed)
    tensor_dir = os.path.join(root, "tensors")
    os.makedirs(tensor_dir, exist_ok=True)

    def make_manifest(path: str, start: int, count: int):
        for m in range(start, start + count):
            genres = [MMX_GENRES_15[rng.integers(len(MMX_GENRES_15))],
                      MMX_GENRES_15[rng.integers(len(MMX_GENRES_15))]]
            scenes = OrderedDict()
            for s in range(scenes_per_movie):
                chunk = {}
                for e in experts:
                    dim = 2048 if "video" not in e else 512
                    t = rng.standard_normal((1, dim)).astype(np.float32)
                    tp = os.path.join(tensor_dir, f"m{m}_s{s}_{e}.npy")
                    np.save(tp, t)
                    chunk[e] = [tp]
                    if with_test_prefix:
                        chunk[f"test-{e}"] = [tp]
                scenes[f"{s:03d}"] = {"000": chunk}
            append_pickle(path, {"label": [genres],
                                 "path": f"movie{m}",
                                 "scenes": scenes})

    train = os.path.join(root, "train.pkl")
    val = os.path.join(root, "val.pkl")
    make_manifest(train, 0, n_movies)
    make_manifest(val, n_movies, max(n_movies // 2, 2))
    return train, val


def write_fake_mit_corpus(root: str, n_videos: int = 12,
                          chunks_per_video: int = 4,
                          experts=("img-embeddings", "location-embeddings"),
                          seed: int = 0) -> tuple[str, str]:
    """Synthetic MIT-temporal corpus (record = ``{"label": str, "path": str,
    "data": {cid: {expert: [paths]}}}`` — create_mit_temporal.py:26-64)."""
    rng = np.random.default_rng(seed)
    labels = list(load_moments_categories().keys())[:10]
    tensor_dir = os.path.join(root, "mit_tensors")
    os.makedirs(tensor_dir, exist_ok=True)

    def make(path: str, start: int, count: int):
        for v in range(start, start + count):
            data = {}
            for c in range(chunks_per_video):
                chunk = {}
                for e in experts:
                    t = rng.standard_normal((1, 2048)).astype(np.float32)
                    tp = os.path.join(tensor_dir, f"v{v}_c{c}_{e}.npy")
                    np.save(tp, t)
                    chunk[e] = [tp]
                    chunk[f"test-{e}"] = [tp]
                data[f"{c:03d}"] = chunk
            append_pickle(path, {"label": labels[v % len(labels)],
                                 "path": f"video{v}", "data": data})

    train = os.path.join(root, "mit_train.pkl")
    val = os.path.join(root, "mit_val.pkl")
    make(train, 0, n_videos)
    make(val, n_videos, max(n_videos // 2, 2))
    return train, val


def write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG of ``rgb`` (H, W, 3) uint8: one IDAT of the rows,
    each with filter 0, deflated at zlib's level 6 (PIL's default).  Any
    PNG decoder reads back exactly these pixels."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, not {rgb.shape}")
    h, w, _ = rgb.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = rgb.reshape(h, 3 * w)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def write_fake_frame_corpus(root: str, n_movies: int = 3,
                            scenes_per_movie: int = 4,
                            frames_per_scene: int = 12,
                            size: int = 64, seed: int = 0) -> str:
    """Directory tree of PNG frames in the reference corpus' layout
    (``<genre>/<movie>/<scene>/imgs/frame-*.png``,
    src/data_processing/temporal/create_mmx_frames.py:86-95), for pipeline
    tests without real data."""
    rng = np.random.default_rng(seed)
    genres = ["Action", "Comedy", "Drama"]
    for m in range(n_movies):
        genre = genres[m % len(genres)]
        for s in range(scenes_per_movie):
            d = os.path.join(root, genre, f"movie{m}", f"scene{s:03d}",
                             "imgs")
            os.makedirs(d, exist_ok=True)
            for f in range(frames_per_scene):
                arr = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
                write_png(os.path.join(d, f"frame-{f:04d}.png"), arr)
    return root


def write_fake_light_csv(root: str, n_movies: int = 4,
                         scenes_per_movie: int = 3,
                         frames_per_scene: int = 6,
                         size: int = 64, seed: int = 0) -> str:
    """Frame corpus + the ``out.csv`` (img_root, g1..g6) the MMX light
    loader reads (MMX_Light_dl.py:133-141,254-264), in the light corpus'
    layout: ``<img_root>/<scene>/<frame>.png``.  Each trailer has two
    genres and four empty genre cells."""
    rng = np.random.default_rng(seed)
    csv_path = os.path.join(root, "out.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["img_root"] + [f"g{i}" for i in range(1, 7)])
        for m in range(n_movies):
            movie_root = os.path.join(root, "light", f"movie{m}")
            for s in range(scenes_per_movie):
                d = os.path.join(movie_root, f"scene{s:03d}")
                os.makedirs(d, exist_ok=True)
                for fi in range(frames_per_scene):
                    arr = rng.integers(0, 255, (size, size, 3),
                                       dtype=np.uint8)
                    write_png(os.path.join(d, f"frame-{fi:04d}.png"), arr)
            gs = [MMX_GENRES_19[rng.integers(len(MMX_GENRES_19))]
                  for _ in range(2)] + [""] * 4
            w.writerow([movie_root] + gs)
    return csv_path


def write_fake_mjpeg_avi(path: str, n_shots: int = 3,
                         frames_per_shot: int = 16, size: int = 96,
                         seed: int = 0) -> str:
    """Minimal MJPG-in-AVI fixture: ``n_shots`` visually distinct shots of
    ``frames_per_shot`` JPEG frames each (the mp4 fixture the reference's
    test lacks, src/tests/test_transforms.py:11-21), decodable by the
    native MJPEG path.  The JPEG frames are PIL's (quality 85)."""
    import io

    from PIL import Image

    rng = np.random.default_rng(seed)
    jpegs = []
    for s in range(n_shots):
        base = rng.integers(0, 255, (3,))
        for f in range(frames_per_shot):
            arr = np.clip(base[None, None]
                          + rng.normal(0, 12, (size, size, 3)), 0,
                          255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG", quality=85)
            jpegs.append(buf.getvalue())

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        pad = b"\0" if len(payload) % 2 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    def lst(subtype: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", subtype + payload)

    n = len(jpegs)
    avih = struct.pack("<14I", 66666, 0, 0, 0x10, n, 0, 1, 0, size, size,
                       0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"MJPG", 0, 0, 0,
                       0, 1, 15, 0, n, 0, 0xFFFFFFFF, 0, 0, 0, size, size)
    strf = struct.pack("<IiiHH4sIiiII", 40, size, size, 1, 24, b"MJPG",
                       size * size * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi = lst(b"movi", b"".join(chunk(b"00dc", j) for j in jpegs))
    body = b"AVI " + hdrl + movi
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


# --------------------------------------------------------------------------
# reference-shaped Lightning checkpoints
# --------------------------------------------------------------------------


def reference_state_dict(kind: str, seed: int = 0, frames: int = 12,
                         d_model: int = 2048, ff: int = 2048,
                         nlayers: int = 2) -> dict[str, np.ndarray]:
    """The state_dict of one of the reference's LightningModules, with its
    key names and shapes and normal(0, 0.02) values from ``seed``:

      * ``"frame_transformer"`` (``src/models/frame_transformer.py:83-121``):
        torchvision's R(2+1)D-18 and ResNet-18 under ``vid_model.backbone``
        and ``img_model.backbone`` (each with its ``fc.0`` Linear(512, 896)),
        the two 4-layer encoders at 896 (FFN 512 and 896), ``vid_cls``
        (1, frames, 3, 112, 112), ``img_cls`` (1, 3, 224, 224) and the
        896-512-128-19 ``img_mlp_head``;
      * ``"simple_transformer"`` (``src/models/transformer.py:28-57``): two
        expert encoders of ``nlayers`` at ``d_model`` (FFN ``ff``), the CLS
        learned per batch slot (2 slots), ``norm``, ``mlp_head`` to 15.

    BatchNorm layers carry running statistics and ``num_batches_tracked``;
    LayerNorms are (1, 0)."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * 0.02

    sd: dict[str, np.ndarray] = {}

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = np.ones(c, np.float32)
        sd[f"{prefix}.bias"] = np.zeros(c, np.float32)
        sd[f"{prefix}.running_mean"] = t(c)
        sd[f"{prefix}.running_var"] = np.abs(t(c)) + 1.0
        sd[f"{prefix}.num_batches_tracked"] = np.array(1, np.int64)

    def encoder(prefix, d, hidden, layers):
        for i in range(layers):
            p = f"{prefix}.layers.{i}"
            sd[f"{p}.self_attn.in_proj_weight"] = t(3 * d, d)
            sd[f"{p}.self_attn.in_proj_bias"] = t(3 * d)
            sd[f"{p}.self_attn.out_proj.weight"] = t(d, d)
            sd[f"{p}.self_attn.out_proj.bias"] = t(d)
            sd[f"{p}.linear1.weight"] = t(hidden, d)
            sd[f"{p}.linear1.bias"] = t(hidden)
            sd[f"{p}.linear2.weight"] = t(d, hidden)
            sd[f"{p}.linear2.bias"] = t(d)
            for norm in ("norm1", "norm2"):
                sd[f"{p}.{norm}.weight"] = np.ones(d, np.float32)
                sd[f"{p}.{norm}.bias"] = np.zeros(d, np.float32)

    if kind == "simple_transformer":
        for i in range(2):
            encoder(f"transformer_encoder{i}", d_model, ff, nlayers)
        sd["cls"] = t(1, 2, d_model)
        sd["norm.weight"] = np.ones(d_model, np.float32)
        sd["norm.bias"] = np.zeros(d_model, np.float32)
        sd["mlp_head.0.weight"] = np.ones(d_model, np.float32)
        sd["mlp_head.0.bias"] = np.zeros(d_model, np.float32)
        sd["mlp_head.1.weight"] = t(15, d_model)
        sd["mlp_head.1.bias"] = t(15)
        return sd
    if kind != "frame_transformer":
        raise ValueError(f"unknown reference module {kind!r}")
    v = "vid_model.backbone"
    sd[f"{v}.stem.0.weight"] = t(45, 3, 1, 7, 7)
    bn(f"{v}.stem.1", 45)
    sd[f"{v}.stem.3.weight"] = t(64, 45, 3, 1, 1)
    bn(f"{v}.stem.4", 64)
    inplanes = 64
    for li, planes in enumerate((64, 128, 256, 512)):
        for bi in range(2):
            p = f"{v}.layer{li + 1}.{bi}"
            inp = inplanes if bi == 0 else planes
            mid = _midplanes(inp, planes)
            for ci, cin in ((1, inp), (2, planes)):
                sd[f"{p}.conv{ci}.0.0.weight"] = t(mid, cin, 1, 3, 3)
                bn(f"{p}.conv{ci}.0.1", mid)
                sd[f"{p}.conv{ci}.0.3.weight"] = t(planes, mid, 3, 1, 1)
                bn(f"{p}.conv{ci}.1", planes)
            if bi == 0 and (li > 0 or inplanes != planes):
                sd[f"{p}.downsample.0.weight"] = t(planes, inp, 1, 1, 1)
                bn(f"{p}.downsample.1", planes)
        inplanes = planes
    i = "img_model.backbone"
    sd[f"{i}.conv1.weight"] = t(64, 3, 7, 7)
    bn(f"{i}.bn1", 64)
    inplanes = 64
    for li, planes in enumerate((64, 128, 256, 512)):
        for bi in range(2):
            p = f"{i}.layer{li + 1}.{bi}"
            inp = inplanes if bi == 0 else planes
            sd[f"{p}.conv1.weight"] = t(planes, inp, 3, 3)
            bn(f"{p}.bn1", planes)
            sd[f"{p}.conv2.weight"] = t(planes, planes, 3, 3)
            bn(f"{p}.bn2", planes)
            if bi == 0 and li > 0:
                sd[f"{p}.downsample.0.weight"] = t(planes, inp, 1, 1)
                bn(f"{p}.downsample.1", planes)
        inplanes = planes
    for backbone in (v, i):
        sd[f"{backbone}.fc.0.weight"] = t(896, 512)
        sd[f"{backbone}.fc.0.bias"] = t(896)
    encoder("distil_transformer.transformer", 896, 512, 4)
    encoder("scene_transformer.transformer", 896, 896, 4)
    sd["vid_cls"] = t(1, frames, 3, 112, 112)
    sd["img_cls"] = t(1, 3, 224, 224)
    for n, (out, k) in enumerate(((512, 896), (128, 512), (19, 128))):
        sd[f"img_mlp_head.{2 * n}.weight"] = t(out, k)
        sd[f"img_mlp_head.{2 * n}.bias"] = t(out)
    return sd


def write_fake_lightning_checkpoint(path: str, kind: str, seed: int = 0,
                                    **shape) -> dict[str, np.ndarray]:
    """Write ``reference_state_dict(kind, seed, **shape)`` as a Lightning
    ``.ckpt``: a pickle with the ``state_dict`` beside hyper-parameters and
    the trainer's counters, which only the full unpickler reads.  Returns
    the state_dict."""
    import torch

    sd = reference_state_dict(kind, seed, **shape)
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                "hyper_parameters": {"model": kind, "lr": 1e-4},
                "epoch": 3, "global_step": 120}, path)
    return sd
