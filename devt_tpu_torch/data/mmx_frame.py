"""MMX frame pipelines, raw images and clips per scene: port of
``devt_tpu/data/mmx_frame.py``.

Two loaders share the packing logic:

  * :class:`MMXFrameDataModule` — streamed-pickle manifest of per-scene
    frame paths (src/dataloaders/mmx/MMX_Frame_dl.py:11-164): per scene a
    random 12-frame temporal slice at train / the first 12 at val
    (:144-150), one random frame per scene for the image stream (:154),
    zero-filled fixed tensors when scenes run out (:125-128).
  * :class:`MMXLightDataModule` — CSV corpus (``out.csv`` with ``img_root``
    and ``g1..g6`` genre columns, src/dataloaders/mmx/MMX_Light_dl.py:
    123-286): scenes/frames discovered by glob, filled by cycling frames
    and scenes modulo their counts (:254-286 — including the quirk that
    the reference cycles *scene* index ``i`` through both the scene list
    and the output slot, so short trailers repeat scenes).  19-genre
    multi-hot labels with Drama fallback at index 6 (:235-245).

Layouts are channels-last: ``img (S, 224, 224, 3)``,
``vid (S, 12, 112, 112, 3)`` float32 (or uint8 on the u8 wire).

Decode runs on the host: the native C++ decoder (``data/native.py``) when
it builds, PIL otherwise, as in the JAX package; augmented train images
always go through PIL (AutoAugment is PIL's).  Manifests are the port's
:class:`~devt_tpu_torch.data.manifests.Table`, batches the port's
:class:`~devt_tpu_torch.data.pipeline.Loader`.  PIL is imported where a
frame is decoded with it: a dataset whose model needs training images
(every model but ``vid`` and ``vivit``) raises ``ImportError`` at
construction on a host without Pillow.
"""

from __future__ import annotations

import glob
import os
import random

import numpy as np

from devt_tpu_torch.config import MMX_GENRES_19, Config
from devt_tpu_torch.data import manifests, native, transforms
from devt_tpu_torch.data.pipeline import Loader


def collect_labels_19(labels) -> np.ndarray:
    """19-genre multi-hot, Drama fallback index 6 (MMX_Light_dl.py:235-245)."""
    out = np.zeros(19, np.float32)
    for i, genre in enumerate(MMX_GENRES_19):
        if genre in labels:
            out[i] = 1.0
    if out.sum() == 0:
        out[6] = 1.0
    return out


def _have_pil() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def _pil_load(path: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"decoding {path} needs Pillow, and the native decoder is "
            f"unavailable: {native.unavailable_reason()}") from e
    return Image.open(path).convert("RGB")


def _decoder():
    """The native decoder module when it builds here, else None (PIL)."""
    return native if native.available() else None


class _FrameClipPacker:
    """Fixed-shape packing for both frame loaders: the per-frame
    decode + resize + normalize loop, on the native batch decoder when it
    builds, on PIL otherwise and for augmented train images."""

    def __init__(self, config: Config, state: str):
        self.config = config
        self.state = state
        self.seq_len = config.seq_len
        self.frame_len = config.frame_len
        variants_with_vid = ("sum", "distil", "vid", "pre_modal",
                             "sum_residual", "post_sum")
        self.need_vid = config.model in variants_with_vid
        self.need_img = config.model != "vid"
        if self.need_img and not _have_pil():
            raise ImportError(
                f"model {config.model!r} reads frames as images, which "
                f"the frame pipeline decodes and augments with Pillow; "
                f"install Pillow or train 'vid' / 'vivit'")
        self.native = _decoder()
        # u8 wire (config.wire_format): decoded pixels cross to the card
        # as uint8 and are normalized there (data/device_norm.py);
        # RandomErasing has a u8 twin that fills round(mean*255)
        self.vid_u8 = (config.wire_format == "u8"
                       and self.native is not None and self.need_vid)
        # the u8 padding, round(mean*255), normalizes to ~0: the f32
        # wire's zeros for empty and missing slots
        self._u8_fill = np.round(
            transforms.KINETICS_MEAN * 255.0).astype(np.uint8)

    def empty(self):
        img = np.zeros((self.seq_len, 224, 224, 3), np.float32)
        if self.vid_u8:
            vid = np.broadcast_to(
                self._u8_fill,
                (self.seq_len, self.frame_len, 112, 112, 3)).copy()
        else:
            vid = np.zeros((self.seq_len, self.frame_len, 112, 112, 3),
                           np.float32)
        return img, vid

    def sample_dict(self, label, img, vid) -> dict:
        """Only the modalities the model reads: an unused all-zeros
        tensor would still cross to the card."""
        out = {"label": label}
        if self.need_img:
            out["img"] = img
        if self.need_vid:
            out["vid"] = vid
        return out

    def item_spec(self) -> dict:
        """Per-sample (shape, dtype): the Loader's fill-into contract
        (data/pipeline.py), samples packed straight into their batch
        slot."""
        spec = {"label": ((19,), np.float32)}
        if self.need_img:
            spec["img"] = ((self.seq_len, 224, 224, 3), np.float32)
        if self.need_vid:
            spec["vid"] = ((self.seq_len, self.frame_len, 112, 112, 3),
                           np.uint8 if self.vid_u8 else np.float32)
        return spec

    def init_into(self, out: dict) -> None:
        """A batch slot initialised as :meth:`empty` (zeros / u8 mean
        fill) before the scene loop packs into it."""
        if "img" in out:
            out["img"][...] = 0.0
        if "vid" in out:
            out["vid"][...] = self._u8_fill if self.vid_u8 else 0.0

    def pack_scene(self, img, vid, slot: int, frame_paths: list[str],
                   rng: random.Random, cycle: bool):
        train = self.state == "train"
        n = len(frame_paths)
        if n == 0:
            return
        if self.need_vid:
            if cycle:
                # MMX_Light cycles k through the frame list (:268-276)
                idxs = [k % n for k in range(self.frame_len)]
            elif train and n > self.frame_len:
                start = rng.randint(0, n - self.frame_len - 1) \
                    if n > self.frame_len + 1 else 0
                idxs = list(range(start, start + self.frame_len))
            else:
                idxs = [min(k, n - 1) for k in range(self.frame_len)]
            erase = train and not cycle
            if self.vid_u8:
                # decode straight into the slot (the native out= contract)
                frames, status = self.native.load_batch_u8(
                    [frame_paths[fi] for fi in idxs], 120, 112,
                    out=vid[slot])
                if np.any(status):
                    # failed decodes: the mean fill (≈0 once normalized),
                    # the f32 wire's zero fill
                    frames[status != 0] = self._u8_fill
                if erase:
                    transforms.random_erasing_clip_u8(frames, rng)
            elif self.native is not None:
                frames, _ = self.native.load_batch_f32(
                    [frame_paths[fi] for fi in idxs], 120, 112,
                    transforms.KINETICS_MEAN, transforms.KINETICS_STD,
                    out=vid[slot])
                if erase:
                    transforms.random_erasing_clip(frames, rng)
            else:
                for k, fi in enumerate(idxs):
                    vid[slot, k] = transforms.clip_frame_transform(
                        _pil_load(frame_paths[fi]), rng, train=train,
                        erase=erase)
        if self.need_img:
            pick = frame_paths[rng.randint(0, n - 1)] if train \
                else frame_paths[0]
            if train:
                img[slot] = transforms.train_image_transform(
                    _pil_load(pick), rng)
            elif self.native is not None:
                out = self.native.load_image_f32(
                    pick, 230, 224, transforms.IMAGENET_MEAN,
                    transforms.IMAGENET_STD)
                if out is not None:
                    img[slot] = out
            else:
                img[slot] = transforms.val_image_transform(_pil_load(pick))


class _WholeClipPacker:
    """ViViT whole-clip samples from a frame corpus: one
    ``frame_len``-frame 224² clip per trailer, frames drawn across its
    scenes in order (a random contiguous window at train, evenly spaced at
    val and test).

    Wire formats (config.wire_format): ``"f32"`` normalized pixels,
    ``"u8"`` raw pixels normalized on the card, or ``"u8_tokens"``, the
    ViT tokens the native decoder emits at decode time
    (native/devt_host.cpp:devt_load_batch_u8_patches), so the step skips
    the patch embed's relayout.  Without the native decoder both u8
    wires fall back to f32 pixels through PIL."""

    RESIZE, CROP, PATCH = 240, 224, 16

    def __init__(self, config: Config, state: str):
        self.config = config
        self.state = state
        self.frame_len = config.frame_len
        self.native = _decoder()
        self.wire = (config.wire_format if self.native is not None
                     else "f32")
        self._u8_fill = np.round(
            transforms.KINETICS_MEAN * 255.0).astype(np.uint8)

    def _clip_paths(self, frame_paths: list[str],
                    rng: random.Random) -> list[str]:
        t, n = self.frame_len, len(frame_paths)
        if self.state == "train" and n > t:
            start = rng.randint(0, n - t)
            return frame_paths[start:start + t]
        # evenly spaced, deterministic (repeats frames when n < t)
        return [frame_paths[min(k * n // t, n - 1)] for k in range(t)]

    def _token_fill(self) -> np.ndarray:
        return np.tile(self._u8_fill, self.PATCH * self.PATCH)

    def sample(self, frame_paths: list[str], label: np.ndarray,
               rng: random.Random) -> dict:
        t, g = self.frame_len, self.CROP // self.PATCH
        if not frame_paths:
            if self.wire == "u8_tokens":
                vid = np.broadcast_to(
                    self._token_fill(),
                    (t, g * g, self.PATCH * self.PATCH * 3)).copy()
                return {"vid_tokens": vid, "label": label}
            if self.wire == "u8":
                vid = np.broadcast_to(
                    self._u8_fill, (t, self.CROP, self.CROP, 3)).copy()
                return {"vid": vid, "label": label}
            return {"vid": np.zeros((t, self.CROP, self.CROP, 3),
                                    np.float32), "label": label}
        paths = self._clip_paths(frame_paths, rng)
        if self.wire == "u8_tokens":
            tok, status = self.native.load_batch_u8_patches(
                paths, self.RESIZE, self.CROP, self.PATCH)
            if np.any(status):
                tok[status != 0] = self._token_fill()
            return {"vid_tokens": tok, "label": label}
        if self.wire == "u8":
            pix, status = self.native.load_batch_u8(
                paths, self.RESIZE, self.CROP)
            if np.any(status):
                pix[status != 0] = self._u8_fill
            return {"vid": pix, "label": label}
        if self.native is not None:
            pix, _ = self.native.load_batch_f32(
                paths, self.RESIZE, self.CROP,
                transforms.KINETICS_MEAN, transforms.KINETICS_STD)
            return {"vid": pix, "label": label}
        vid = np.stack([
            transforms.clip_frame_transform(_pil_load(p), rng,
                                            size=self.CROP,
                                            resize=self.RESIZE)
            for p in paths])
        return {"vid": vid, "label": label}

    def item_spec(self) -> dict:
        """Loader fill-into contract (data/pipeline.py)."""
        t, g = self.frame_len, self.CROP // self.PATCH
        spec = {"label": ((19,), np.float32)}
        if self.wire == "u8_tokens":
            spec["vid_tokens"] = ((t, g * g, self.PATCH * self.PATCH * 3),
                                  np.uint8)
        else:
            spec["vid"] = ((t, self.CROP, self.CROP, 3),
                           np.uint8 if self.wire == "u8" else np.float32)
        return spec

    def sample_into(self, frame_paths: list[str], label: np.ndarray,
                    rng: random.Random, out: dict) -> None:
        """:meth:`sample`, with the native decoder writing the clip
        straight into the batch slot."""
        out["label"][...] = label
        if not frame_paths or self.native is None:
            for k, v in self.sample(frame_paths, label, rng).items():
                out[k][...] = v
            return
        paths = self._clip_paths(frame_paths, rng)
        if self.wire == "u8_tokens":
            tok, status = self.native.load_batch_u8_patches(
                paths, self.RESIZE, self.CROP, self.PATCH,
                out=out["vid_tokens"])
            if np.any(status):
                tok[status != 0] = self._token_fill()
        elif self.wire == "u8":
            pix, status = self.native.load_batch_u8(
                paths, self.RESIZE, self.CROP, out=out["vid"])
            if np.any(status):
                pix[status != 0] = self._u8_fill
        else:
            self.native.load_batch_f32(
                paths, self.RESIZE, self.CROP, transforms.KINETICS_MEAN,
                transforms.KINETICS_STD, out=out["vid"])


def _scene_frames(scene):
    """A pickle-manifest scene's frame list, under key 0, "000" or "0"."""
    for key in (0, "000", "0"):
        try:
            return scene[key]
        except (KeyError, TypeError, IndexError):
            continue
    return None


def _dir_frames(scene_dir: str) -> list[str]:
    return (sorted(glob.glob(os.path.join(scene_dir, "*.png")))
            or sorted(glob.glob(os.path.join(scene_dir, "*"))))


class _FrameDataset:
    """What both datasets share: the packer, the per-item rng, the
    fill-into contract.  Subclasses give ``_item(idx)``: the label and
    either the scene frame lists to pack or the trailer's whole frame
    list, and ``_pack_scenes``."""

    def __init__(self, table: manifests.Table, config: Config,
                 state: str = "train"):
        self.table = table
        self.config = config
        self.state = state
        self.whole_clip = config.model == "vivit"
        self.packer = (_WholeClipPacker(config, state) if self.whole_clip
                       else _FrameClipPacker(config, state))

    def __len__(self) -> int:
        return len(self.table)

    def _rng(self, idx: int) -> random.Random:
        return random.Random(hash((self.config.seed, self.state, idx,
                                   random.random()
                                   if self.state == "train" else 0)))

    @property
    def item_spec(self):
        """Loader fill-into contract (data/pipeline.py)."""
        return self.packer.item_spec()

    def getitem_into(self, idx: int, out: dict) -> None:
        rng = self._rng(idx)
        label, scenes = self._item(idx)
        if self.whole_clip:
            self.packer.sample_into(self._whole_clip_frames(scenes),
                                    label, rng, out)
            return
        self.packer.init_into(out)
        self._pack_scenes(scenes, out.get("img"), out.get("vid"), rng)
        out["label"][...] = label

    def __getitem__(self, idx: int):
        rng = self._rng(idx)
        label, scenes = self._item(idx)
        if self.whole_clip:
            return self.packer.sample(self._whole_clip_frames(scenes),
                                      label, rng)
        img, vid = self.packer.empty()
        self._pack_scenes(scenes, img, vid, rng)
        return self.packer.sample_dict(label, img, vid)


class MMXFrameDataset(_FrameDataset):
    """Pickle-manifest variant (MMX_Frame_dl.py:53-164)."""

    def _item(self, idx: int):
        row = self.table.row(idx)
        return collect_labels_19(row["label"]), row["scenes"]

    def _pack_scenes(self, scenes, img, vid, rng) -> None:
        slot = 0
        for scene in scenes.values():
            if slot >= self.config.seq_len:
                break
            clip = _scene_frames(scene)
            if not clip:
                continue
            self.packer.pack_scene(img, vid, slot, list(clip), rng,
                                   cycle=False)
            slot += 1

    def _whole_clip_frames(self, scenes) -> list:
        frames = []
        for scene in scenes.values():
            clip = _scene_frames(scene)
            if clip is not None:
                frames.extend(clip)
        return frames


class MMXLightDataset(_FrameDataset):
    """CSV/glob variant (MMX_Light_dl.py:174-286)."""

    def _item(self, idx: int):
        row = self.table.row(idx)
        # g1..g5 only, as the reference reads them; an empty cell is None
        labels = [row[f"g{i}"] for i in range(1, 6) if f"g{i}" in row]
        target = collect_labels_19([l for l in labels if isinstance(l, str)])
        scenes = sorted(glob.glob(os.path.join(str(row["img_root"]), "*")))
        return target, scenes

    def _pack_scenes(self, scenes, img, vid, rng) -> None:
        if not scenes:
            return
        frame_lists = [_dir_frames(s) for s in scenes]
        for slot in range(self.config.seq_len):
            frames = frame_lists[slot % len(scenes)]
            self.packer.pack_scene(img, vid, slot, frames, rng, cycle=True)

    def _whole_clip_frames(self, scenes) -> list:
        return [p for s in scenes for p in _dir_frames(s)]


class _FrameDataModule:
    dataset: type

    def train_batches(self):
        return Loader(self.dataset(self.train_table, self.config, "train"),
                      self.config.batch_size, shuffle=True,
                      seed=self.config.seed)

    def val_batches(self):
        return Loader(self.dataset(self.val_table, self.config, "val"),
                      self.config.batch_size)


class MMXFrameDataModule(_FrameDataModule):
    dataset = MMXFrameDataset

    def __init__(self, train_manifest: str, val_manifest: str,
                 config: Config):
        self.train_manifest = train_manifest
        self.val_manifest = val_manifest
        self.config = config

    def setup(self):
        self.train_table = manifests.load_manifest(self.train_manifest)
        self.val_table = manifests.load_manifest(self.val_manifest)
        self.train_steps = len(self.train_table) // self.config.batch_size
        return self

    def test_batches(self):
        return Loader(MMXFrameDataset(self.val_table, self.config, "test"),
                      self.config.batch_size)


class MMXLightDataModule(_FrameDataModule):
    dataset = MMXLightDataset

    def __init__(self, csv_path: str, config: Config):
        self.csv_path = csv_path
        self.config = config

    def setup(self):
        self.train_table, self.val_table = manifests.load_csv_manifest(
            self.csv_path, shuffle_seed=self.config.seed)
        self.train_steps = len(self.train_table) // self.config.batch_size
        return self

    def test_batches(self):
        # the light loader tests on its validation split in "val" state
        return self.val_batches()
