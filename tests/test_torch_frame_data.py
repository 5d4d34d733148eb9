"""The port's frame pipeline against the JAX package's, on the CPU.

  * ``load_csv_manifest``: JAX's rows (pandas) in JAX's order at seeds 0,
    1130 and None, empty genre cells read as missing;
  * the writers: the port's PNGs decode under PIL to JAX's pixels, its
    CSV is JAX's text, its AVI JAX's bytes;
  * the native loader (``data/native.py``): every bound entry point equal
    to ``devt_tpu.native``'s, on PNG and JPEG frames, a missing file and
    the MJPEG AVI; the library built into the port's ignored directory,
    concurrently, and a failed build's message kept;
  * ``MMXLightDataset`` and ``MMXFrameDataset`` items equal to JAX's bit
    for bit, on corpora JAX's writers and ``build_mmx_frames`` wrote, with
    either decoder (native, or PIL with the native one switched off in
    both packages), at val and at train (``random.random`` pinned so that
    both packages' per-item rngs draw alike); ``getitem_into`` equal to
    ``__getitem__``;
  * the ``torch.utils.data`` adapter: the ``Loader``'s batches, shards
    disjoint and covering the ``Loader``'s, workers splitting in order;
  * the slice: the first validation batch of ``MMXLightDataModule`` equal
    to JAX's, and FrameTransformer ``vid`` (JAX's weights through
    ``utils.jax_bridge``) giving JAX's eval loss on it within
    ``test_torch_frame_transformer.py``'s bound; ``main`` on ``mmx-frame``
    fitting, validating and testing on the CPU.
"""

import csv
import os
import random
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from devt_tpu import native as jnative
from devt_tpu.config import Config as JConfig
from devt_tpu.data import manifests as jmanifests
from devt_tpu.data import mmx_frame as jframe
from devt_tpu.data import synthetic as jsynth
from devt_tpu.data.pipeline import Loader as JLoader
from devt_tpu.data_processing import builders
from devt_tpu.models.frame_transformer import FrameTransformer as JFT
from devt_tpu.train import steps as jsteps
from devt_tpu_torch import main as tmain
from devt_tpu_torch.config import Config as TConfig
from devt_tpu_torch.data import loader_adapter
from devt_tpu_torch.data import manifests as tmanifests
from devt_tpu_torch.data import mmx_frame as tframe
from devt_tpu_torch.data import native as tnative
from devt_tpu_torch.data import synthetic as tsynth
from devt_tpu_torch.data.pipeline import Loader as TLoader
from devt_tpu_torch.models.frame_transformer import FrameTransformer
from devt_tpu_torch.train import steps as tsteps
from devt_tpu_torch.train.state import model_buffers
from devt_tpu_torch.utils.jax_bridge import state_dict_to_jax
from test_torch_frame_transformer import TOL, randomize

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

STATS = (np.array([0.4, 0.5, 0.6], np.float32),
         np.array([0.2, 0.25, 0.3], np.float32))


def _missing(v):
    return v is None or (isinstance(v, float) and np.isnan(v))


def _assert_rows_equal(table, df):
    assert len(table) == len(df)
    for i in range(len(df)):
        want = df.iloc[i]
        got = table.row(i)
        assert list(got) == list(want.index)
        for key in want.index:
            if _missing(want[key]):
                assert got[key] is None, (i, key, got[key])
            else:
                assert got[key] == want[key], (i, key)


@pytest.fixture(scope="module")
def genre_csv(tmp_path_factory):
    """23 trailers with genre cells empty at random, g1 included."""
    path = str(tmp_path_factory.mktemp("csv") / "out.csv")
    rng = np.random.default_rng(4)
    genres = ("Action", "Drama", "Science Fiction", "TVMovie", "War")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["img_root"] + [f"g{i}" for i in range(1, 7)])
        for m in range(23):
            w.writerow([f"/data/light/movie{m}"] + [
                genres[rng.integers(len(genres))] if rng.random() < 0.5
                else "" for _ in range(6)])
    return path


@pytest.mark.parametrize("seed", [0, 1130, None])
def test_csv_manifest_equals_pandas(genre_csv, seed):
    for rows in ((15, 5), (20, 10), (6047, 653)):
        train, val = tmanifests.load_csv_manifest(
            genre_csv, shuffle_seed=seed, train_rows=rows[0],
            val_rows=rows[1])
        jtrain, jval = jmanifests.load_csv_manifest(
            genre_csv, shuffle_seed=seed, train_rows=rows[0],
            val_rows=rows[1])
        _assert_rows_equal(train, jtrain)
        _assert_rows_equal(val, jval)
    # the labels the light dataset reads from each row
    cfg = TConfig(model="vid", seq_len=1, frame_len=1)
    ds_t = tframe.MMXLightDataset(train, cfg, "val")
    ds_j = jframe.MMXLightDataset(jtrain, JConfig(model="vid", seq_len=1,
                                                  frame_len=1), "val")
    for i in range(len(ds_t)):
        np.testing.assert_array_equal(ds_t._item(i)[0],
                                      ds_j._row_target_scenes(i)[0])


def _pngs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f.endswith(".png"))


def _assert_same_pixels(a_root, b_root):
    names = _pngs(a_root)
    assert names == _pngs(b_root) and names
    for name in names:
        a = np.asarray(Image.open(os.path.join(a_root, name)).convert("RGB"))
        b = np.asarray(Image.open(os.path.join(b_root, name)).convert("RGB"))
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_writers_equal_jax(tmp_path):
    kw = dict(n_movies=2, scenes_per_movie=2, frames_per_scene=3, size=24,
              seed=5)
    tsynth.write_fake_frame_corpus(str(tmp_path / "t"), **kw)
    jsynth.write_fake_frame_corpus(str(tmp_path / "j"), **kw)
    _assert_same_pixels(str(tmp_path / "t"), str(tmp_path / "j"))

    (tmp_path / "tl").mkdir()
    (tmp_path / "jl").mkdir()
    tcsv = tsynth.write_fake_light_csv(str(tmp_path / "tl"), **kw)
    jcsv = jsynth.write_fake_light_csv(str(tmp_path / "jl"), **kw)
    with open(tcsv) as a, open(jcsv) as b:
        assert a.read().replace(str(tmp_path / "tl"), "R") \
            == b.read().replace(str(tmp_path / "jl"), "R")
    _assert_same_pixels(str(tmp_path / "tl"), str(tmp_path / "jl"))

    ta = tsynth.write_fake_mjpeg_avi(str(tmp_path / "t.avi"), n_shots=2,
                                     frames_per_shot=3, size=32, seed=2)
    ja = jsynth.write_fake_mjpeg_avi(str(tmp_path / "j.avi"), n_shots=2,
                                     frames_per_shot=3, size=32, seed=2)
    with open(ta, "rb") as a, open(ja, "rb") as b:
        assert a.read() == b.read()


def test_png_writer_round_trips():
    rng = np.random.default_rng(0)
    for shape in ((1, 1, 3), (5, 9, 3), (33, 17, 3)):
        arr = rng.integers(0, 256, shape, dtype=np.uint8)
        path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                            f"rt_{os.getpid()}_{shape[0]}.png")
        try:
            tsynth.write_png(path, arr)
            img = Image.open(path)
            assert img.mode == "RGB"
            np.testing.assert_array_equal(np.asarray(img), arr)
        finally:
            os.remove(path)
    with pytest.raises(ValueError):
        tsynth.write_png("unused.png", np.zeros((4, 4), np.uint8))


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """PNG frames of two sizes, a JPEG, a missing path, an MJPEG AVI."""
    if not (tnative.available() and jnative.available()):
        pytest.skip(f"no native decoder here: {tnative.unavailable_reason()}")
    root = tmp_path_factory.mktemp("media")
    rng = np.random.default_rng(6)
    paths = []
    for i, (h, w) in enumerate(((50, 70), (90, 64), (64, 64))):
        p = str(root / f"f{i}.png")
        tsynth.write_png(p, rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        paths.append(p)
    jpg = str(root / "f.jpg")
    Image.fromarray(rng.integers(0, 256, (72, 80, 3), dtype=np.uint8)).save(
        jpg, quality=90)
    paths += [jpg, str(root / "missing.png")]
    avi = tsynth.write_fake_mjpeg_avi(str(root / "v.avi"), n_shots=2,
                                      frames_per_shot=3, size=48, seed=1)
    return types.SimpleNamespace(paths=paths, avi=avi)


def _pair(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _pair(x, y)
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


ENTRY_POINTS = {
    "load_image_f32": lambda m, x: tuple(
        m.load_image_f32(p, 70, 64, *STATS) for p in x.paths),
    "load_batch_f32": lambda m, x: m.load_batch_f32(x.paths, 70, 64, *STATS,
                                                    nthreads=2),
    "load_batch_u8": lambda m, x: m.load_batch_u8(x.paths, 70, 64),
    "load_batch_u8_patches": lambda m, x: m.load_batch_u8_patches(
        x.paths, 70, 64, 16),
    "video_info": lambda m, x: (m.video_info(x.avi),
                                m.video_info(x.paths[0])),
    "load_video_rgb8": lambda m, x: (m.load_video_rgb8(x.avi),
                                     m.load_video_rgb8(x.avi, max_frames=2)),
    "load_video_f32": lambda m, x: m.load_video_f32(x.avi, 40, 32, *STATS),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_native_entry_point_equals_jax(media, entry):
    got = ENTRY_POINTS[entry](tnative, media)
    _pair(got, ENTRY_POINTS[entry](jnative, media))
    if entry.startswith("load_batch"):
        assert list(got[1] != 0) == [False] * 4 + [True]   # the missing one


def test_native_image_dims_and_out_buffers(media):
    lib = jnative._load()
    for p in media.paths:
        w, h = jnative.ctypes.c_int(), jnative.ctypes.c_int()
        rc = lib.devt_image_dims(p.encode(), jnative.ctypes.byref(w),
                                 jnative.ctypes.byref(h))
        assert tnative.image_dims(p) == ((w.value, h.value) if rc == 0
                                         else None)
    # out=: the decode lands in the caller's slot, which is zeroed first
    out = np.full((2, 5, 64, 64, 3), 7, np.uint8)
    frames, status = tnative.load_batch_u8(media.paths, 70, 64, out=out[1])
    assert frames.base is not None and np.shares_memory(frames, out)
    np.testing.assert_array_equal(out[1], jnative.load_batch_u8(
        media.paths, 70, 64)[0])
    assert (out[0] == 7).all() and (out[1][4] == 0).all()
    with pytest.raises(ValueError):
        tnative.load_batch_u8(media.paths, 70, 64, out=out[0, :4])
    with pytest.raises(ValueError):
        tnative.load_batch_u8_patches(media.paths, 70, 64, 24)


def test_native_build_is_the_ports_own(tmp_path, monkeypatch):
    """The library lies in the port's ignored build directory, named by a
    hash of source and flags; two builds at once both end with it whole;
    a failed build keeps the compiler's message."""
    import shutil
    import subprocess

    if shutil.which("g++") is None:
        pytest.skip("no g++ here")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lib = tnative.library_path()
    assert lib.parent == tnative.BUILD_DIR
    assert "native/build" not in str(lib.relative_to(root))
    ignored = subprocess.run(["git", "check-ignore", "-q", str(lib)],
                             cwd=root).returncode
    assert ignored == 0

    src = tmp_path / "host.cpp"
    src.write_text('extern "C" int devt_probe() { return 7; }\n')
    monkeypatch.setattr(tnative, "SOURCE", src)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "LIBS", ())
    built = []
    threads = [threading.Thread(target=lambda: built.append(tnative.build()))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert len(built) == 2 and built[0] == built[1] == tnative.library_path()
    assert tnative.ctypes.CDLL(str(built[0])).devt_probe() == 7
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) \
        == [built[0].name]

    src.write_text("#include <no_such_header_here.h>\n")
    with pytest.raises(RuntimeError, match="no_such_header_here"):
        tnative.build()
    monkeypatch.setattr(tnative, "_State", type("S", (), {"lib": None,
                                                         "reason": None}))
    assert not tnative.available()
    assert "no_such_header_here" in tnative.unavailable_reason()


# --------------------------------------------------------------------------
# the datasets
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def light(tmp_path_factory):
    """JAX's light corpus: 3 trailers of 3, 3 and 3 scenes, 5 frames of
    64² each, with both packages' tables."""
    root = str(tmp_path_factory.mktemp("light"))
    path = jsynth.write_fake_light_csv(root, n_movies=3, scenes_per_movie=3,
                                       frames_per_scene=5, size=64, seed=2)
    # one trailer with fewer scenes: slots cycle over them
    last = os.path.join(root, "light", "movie2", "scene002")
    for f in os.listdir(last):
        os.remove(os.path.join(last, f))
    os.rmdir(last)
    t, _ = tmanifests.load_csv_manifest(path, shuffle_seed=0, train_rows=3)
    j, _ = jmanifests.load_csv_manifest(path, shuffle_seed=0, train_rows=3)
    return t, j


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """JAX's frame corpus through ``build_mmx_frames``: pickle manifests of
    scenes padded to 16 frame paths."""
    root = tmp_path_factory.mktemp("frames")
    corpus = jsynth.write_fake_frame_corpus(str(root / "c"), n_movies=3,
                                            scenes_per_movie=3,
                                            frames_per_scene=13, size=64,
                                            seed=3)
    train, val = str(root / "train.pkl"), str(root / "val.pkl")
    builders.build_mmx_frames(corpus, train, val, min_frames=10, pad_to=16,
                              split=0.7, workers=1)
    return tmanifests.load_manifest(train), jmanifests.load_manifest(train)


def _decoders(monkeypatch, decoder):
    if decoder == "pil":
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    elif not (tnative.available() and jnative.available()):
        pytest.skip(f"no native decoder here: {tnative.unavailable_reason()}")


def _assert_items_equal(tds, jds):
    assert tds.item_spec == jds.item_spec
    for i in range(len(tds)):
        got, want = tds[i], jds[i]
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        into = {k: np.full(s, 3, d) for k, (s, d) in tds.item_spec.items()}
        tds.getitem_into(i, into)
        for k in into:
            np.testing.assert_array_equal(into[k], got[k], err_msg=k)


CASES = [("vid", "f32"), ("vid", "u8"), ("distil", "f32"), ("sum", "u8"),
         ("frame", "f32"), ("vivit", "f32"), ("vivit", "u8"),
         ("vivit", "u8_tokens")]


def _configs(model, wire):
    kw = dict(model=model, wire_format=wire, batch_size=2, seq_len=4,
              frame_len=3, n_classes=19, seed=9)
    return TConfig(**kw), JConfig(**kw)


@pytest.mark.parametrize("decoder", ["native", "pil"])
@pytest.mark.parametrize("model,wire", CASES,
                         ids=[f"{m}-{w}" for m, w in CASES])
def test_light_items_equal_jax(light, monkeypatch, decoder, model, wire):
    _decoders(monkeypatch, decoder)
    monkeypatch.setattr(random, "random", lambda: 0.375)
    tcfg, jcfg = _configs(model, wire)
    for state in ("val", "train"):
        _assert_items_equal(tframe.MMXLightDataset(light[0], tcfg, state),
                            jframe.MMXLightDataset(light[1], jcfg, state))


@pytest.mark.parametrize("decoder", ["native", "pil"])
@pytest.mark.parametrize("model,wire", [("vid", "f32"), ("vid", "u8"),
                                        ("distil", "f32"), ("vivit", "u8")],
                         ids=["vid-f32", "vid-u8", "distil-f32", "vivit-u8"])
def test_frame_items_equal_jax(frames, monkeypatch, decoder, model, wire):
    """Train items take a random 3-frame slice of 16 and erase frames."""
    _decoders(monkeypatch, decoder)
    monkeypatch.setattr(random, "random", lambda: 0.625)
    tcfg, jcfg = _configs(model, wire)
    for state in ("val", "train"):
        _assert_items_equal(tframe.MMXFrameDataset(frames[0], tcfg, state),
                            jframe.MMXFrameDataset(frames[1], jcfg, state))


def test_image_models_need_pil(light, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        tframe.MMXLightDataset(light[0], _configs("distil", "f32")[0])
    for model in ("vid", "vivit"):
        tframe.MMXLightDataset(light[0], _configs(model, "f32")[0])
    monkeypatch.setattr(tnative, "available", lambda: False)
    ds = tframe.MMXLightDataset(light[0], _configs("vid", "f32")[0], "val")
    with pytest.raises(ImportError, match="Pillow"):
        ds[0]


# --------------------------------------------------------------------------
# the torch.utils.data adapter
# --------------------------------------------------------------------------


class _Rows:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2,), i, np.int64),
                "label": np.float32(i % 3)}


def _ids(batches):
    return [b["x"][:, 0].tolist() for b in batches]


@pytest.mark.parametrize("shuffle", [False, True])
def test_adapter_batches_and_shards(shuffle):
    ds = _Rows(23)
    for count in (1, 3):
        shards = []
        for index in range(count):
            got = _ids(loader_adapter.make_torch_loader(
                ds, 3, shuffle=shuffle, seed=4, num_epochs=2,
                process_index=index, process_count=count))
            want = []
            loader = TLoader(ds, 3, shuffle=shuffle, seed=4, num_workers=1,
                             process_index=index, process_count=count)
            for epoch in range(2):
                loader.set_epoch(epoch)
                want += _ids(loader)
            assert got == want
            shards.append({i for b in got[:len(got) // 2] for i in b})
        for a in range(count):
            for b in range(a + 1, count):
                assert not shards[a] & shards[b]
        covered = set().union(*shards)
        assert len(covered) == count * (23 // count // 3 * 3)


def test_adapter_workers_split_batches_in_order(monkeypatch):
    ds = _Rows(20)
    whole = _ids(loader_adapter.ShardedBatches(ds, 3, shuffle=True, seed=1))
    parts = []
    for w in range(2):
        monkeypatch.setattr(torch.utils.data, "get_worker_info",
                            lambda w=w: types.SimpleNamespace(
                                id=w, num_workers=2))
        parts.append(_ids(loader_adapter.ShardedBatches(ds, 3, shuffle=True,
                                                        seed=1)))
    merged = [b for pair in zip(parts[0], parts[1]) for b in pair]
    assert merged == whole[:len(merged)] and len(whole) == 6
    with pytest.raises(ValueError):
        loader_adapter.ShardedBatches(ds, 3, process_index=2,
                                      process_count=2)


# --------------------------------------------------------------------------
# the slice: the datamodule, FrameTransformer vid on it, main
# --------------------------------------------------------------------------

TRAIN_ROWS = 6047


def _reference_split_csv(root, extra_rows, size=64):
    """JAX's light corpus, its rows repeated to the reference split's 6,047
    training rows and ``extra_rows`` more."""
    path = jsynth.write_fake_light_csv(root, n_movies=3, scenes_per_movie=2,
                                       frames_per_scene=4, size=size, seed=7)
    with open(path) as f:
        header, *rows = list(csv.reader(f))
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for i in range(TRAIN_ROWS + extra_rows):
            w.writerow(rows[i % len(rows)])
    return path


def test_first_validation_batch_and_vid_eval_loss(tmp_path):
    path = _reference_split_csv(str(tmp_path), 2)
    kw = dict(model="vid", data_set="mmx-frame", csv_manifest=path,
              batch_size=2, seq_len=2, frame_len=4, n_classes=19,
              precision="f32", attention_impl="xla")
    tdm = tmain.build_datamodule(TConfig(**kw)).setup()
    jdm = jframe.MMXLightDataModule(path, JConfig(**kw)).setup()
    assert len(tdm.val_table) == 2 and tdm.train_steps == TRAIN_ROWS // 2
    batch = next(iter(tdm.val_batches()))
    jbatch = next(iter(jdm.val_batches()))
    assert sorted(batch) == sorted(jbatch) == ["label", "vid"]
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)

    model = randomize(FrameTransformer(model="vid", seq_len=2, frame_len=4,
                                       n_classes=19,
                                       attention_impl="xla")).eval()
    variables = jax.tree_util.tree_map(
        jnp.asarray, state_dict_to_jax(model.state_dict()))
    jm = JFT(model="vid", seq_len=2, frame_len=4, n_classes=19,
             attention_impl="xla")
    jloss, jaux, _ = jax.jit(lambda v, b: jsteps.forward_and_loss(
        jm, JConfig(**kw), v, b, None, train=False))(
        variables, {k: jnp.asarray(v) for k, v in jbatch.items()})
    with torch.no_grad():
        loss, aux, _ = tsteps.forward_and_loss(
            model, TConfig(**kw), {"params": dict(model.named_parameters()),
                                   **model_buffers(model)},
            {k: torch.from_numpy(v) for k, v in batch.items()}, None,
            train=False)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    np.testing.assert_allclose(aux["probs"].numpy(), np.asarray(jaux["probs"]),
                               **TOL)


def test_main_on_mmx_frame(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = _reference_split_csv(str(tmp_path), 2)
    results = tmain.main(
        ["--data_set", "mmx-frame", "--csv_manifest", path, "--n_classes",
         "19", "--seq_len", "2", "--frame_len", "4", "--precision", "f32",
         "--max_steps", "2", "--epochs", "1", "--log_every", "1",
         "--checkpoint_dir", "ck", "--save_path", "out", "--name", "frame"],
        device="cpu")
    assert np.isfinite(results["test/loss"])
    with open("runs/frame/metrics.jsonl") as f:
        text = f.read()
    assert text.count('"train/loss"') == 2 and '"val/loss"' in text
    assert os.path.isdir(os.path.join("ck", "step_2"))
