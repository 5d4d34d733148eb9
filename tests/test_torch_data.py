"""The port's host data pipeline against the JAX package's.

  * ``Loader``: the same batches in the same order, equal exactly, with
    shuffle or a weighted sampler, ``set_epoch`` with a skip, two
    processes, the ``getitem_into`` path, and 0 or 4 worker threads;
  * on corpora written by JAX's ``write_fake_expert_corpus`` and
    ``write_fake_mit_corpus``: the port's manifests, ``clean_mmx_temporal``
    and the MMX, MIT and contrastive datasets equal JAX's item by item
    (the train-time draws seeded alike through Python's ``random``);
  * the port's writers produce corpora that JAX's readers load equal to
    JAX's own;
  * ``device_prefetch`` on the CPU: tensors equal to the host batch, a
    worker's exception raised in the consumer, its thread stopped when the
    consumer leaves.
"""

import os
import random
import threading
import time

import numpy as np
import pytest
import torch

from devt_tpu.config import Config as JConfig
from devt_tpu.data import contrastive as jcon
from devt_tpu.data import manifests as jman
from devt_tpu.data import mit_temporal as jmit
from devt_tpu.data import mmx_temporal as jmmx
from devt_tpu.data import pipeline as jpipe
from devt_tpu.data import samplers as jsamp
from devt_tpu.data import synthetic as jsyn
from devt_tpu.data import transforms as jtr
from devt_tpu_torch.config import Config as TConfig
from devt_tpu_torch.data import contrastive as tcon
from devt_tpu_torch.data import manifests as tman
from devt_tpu_torch.data import mit_temporal as tmit
from devt_tpu_torch.data import mmx_temporal as tmmx
from devt_tpu_torch.data import pipeline as tpipe
from devt_tpu_torch.data import samplers as tsamp
from devt_tpu_torch.data import synthetic as tsyn
from devt_tpu_torch.data import transforms as ttr


class _Items:
    """A map-style dataset of fixed arrays; with ``fill`` it also offers
    the ``item_spec`` / ``getitem_into`` fast path."""

    def __init__(self, n=30, fill=False):
        rng = np.random.default_rng(11)
        self.x = rng.standard_normal((n, 3, 5)).astype(np.float32)
        self.y = rng.integers(0, 4, (n, 1)).astype(np.int32)
        if fill:
            self.item_spec = {"x": ((3, 5), np.float32), "y": ((1,), np.int32)}

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {"x": self.x[i], "y": self.y[i], "path": f"item{i}"}

    def getitem_into(self, i, out):
        out["x"][...] = self.x[i]
        out["y"][...] = self.y[i]


def _drain(loader):
    return [{k: (v.copy() if isinstance(v, np.ndarray) else list(v))
             for k, v in b.items()} for b in loader]


def _same_batches(a, b):
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], np.ndarray):
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])
            else:
                assert x[k] == y[k]


@pytest.mark.parametrize("workers", [0, 4])
@pytest.mark.parametrize("order", ["sequential", "shuffle", "sampler"])
@pytest.mark.parametrize("fill", [False, True])
def test_loader_yields_jax_loaders_batches(workers, order, fill):
    ds = _Items(fill=fill)
    kw = dict(batch_size=4, seed=5, num_workers=workers)
    if order == "shuffle":
        kw["shuffle"] = True
    elif order == "sampler":
        kw["sampler"] = jsamp.weighted_sampler(ds.y[:, 0])
    for index in (0, 1):
        j = jpipe.Loader(ds, process_index=index, process_count=2, **kw)
        t = tpipe.Loader(ds, process_index=index, process_count=2, **kw)
        assert len(t) == len(j) == 3
        for epoch, skip in ((0, 0), (3, 1), (3, 0), (1, 3)):
            j.set_epoch(epoch, skip)
            t.set_epoch(epoch, skip)
            want = _drain(j)
            if skip >= len(j):
                assert _drain(t) == want == []
                continue
            _same_batches(_drain(t), want)
    single = tpipe.Loader(ds, **kw)
    assert (single.process_index, single.process_count) == (0, 1)
    assert len(single) == len(ds) // 4


def test_loader_forwards_a_worker_error_and_stops_when_left():
    class Bad(_Items):
        def __getitem__(self, i):
            if i == 9:
                raise KeyError("item 9")
            return super().__getitem__(i)

    with pytest.raises(KeyError, match="item 9"):
        _drain(tpipe.Loader(Bad(), batch_size=2, num_workers=4))
    before = {t for t in threading.enumerate() if t.name == "devt-loader"}
    it = iter(tpipe.Loader(_Items(n=200), batch_size=2, num_workers=4,
                           prefetch=1))
    next(it)
    it.close()
    deadline = time.time() + 10
    while time.time() < deadline and {
            t for t in threading.enumerate()
            if t.name == "devt-loader"} - before:
        time.sleep(0.05)
    assert not {t for t in threading.enumerate()
                if t.name == "devt-loader"} - before


def test_samplers_and_transforms_match_jax():
    labels = [3, 1, 1, 2, 3, 3, 0]
    np.testing.assert_array_equal(tsamp.inverse_class_weights(labels),
                                  jsamp.inverse_class_weights(labels))
    np.testing.assert_array_equal(
        tsamp.weighted_sampler(labels, 20)(np.random.default_rng(4)),
        jsamp.weighted_sampler(labels, 20)(np.random.default_rng(4)))
    x = np.random.default_rng(0).standard_normal((1, 300)).astype(np.float32)
    for width in (300, 128, 2048):
        np.testing.assert_array_equal(ttr.pad_to_width(x, width),
                                      jtr.pad_to_width(x, width))
    for seed in range(12):
        np.testing.assert_array_equal(
            ttr.expert_augment(x, random.Random(seed)),
            jtr.expert_augment(x, random.Random(seed)))


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_corpus")
    mmx = jsyn.write_fake_expert_corpus(str(root / "mmx"), n_movies=6,
                                        scenes_per_movie=6)
    mit = jsyn.write_fake_mit_corpus(str(root / "mit"), n_videos=6,
                                     chunks_per_video=4)
    # one short row (3 scenes: dropped by the cleaner, paired with its
    # neighbour by the contrastive loader) and one out-of-set row
    short = str(root / "mmx_short.pkl")
    for rec in jman.stream_pickle(mmx[1]):
        jman.append_pickle(short, rec)
    scenes = jman.stream_pickle(mmx[0])[0]["scenes"]
    jman.append_pickle(short, {"label": [["Western"] * 6], "path": "odd",
                               "scenes": scenes})
    jman.append_pickle(short, {"label": [["Action"]], "path": "short",
                               "scenes": dict(list(scenes.items())[:1])})
    return {"mmx": mmx, "mit": mit, "short": short}


def _records_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x == y


def test_manifests_match_jax(corpora, tmp_path):
    for path in (*corpora["mmx"], *corpora["mit"], corpora["short"]):
        table = tman.load_manifest(path)
        df = jman.load_manifest(path)
        assert len(table) == len(df) and table.columns == list(df.columns)
        _records_equal(table.records, df.to_dict("records"))
        _records_equal(
            tman.clean_mmx_temporal(table, jmmx.MMX_GENRES_15).records
            if "scenes" in table.columns else [],
            jman.clean_mmx_temporal(df, jmmx.MMX_GENRES_15)
            .to_dict("records") if "scenes" in df.columns else [])
    assert len(tman.clean_mmx_temporal(
        tman.load_manifest(corpora["short"]), jmmx.MMX_GENRES_15)) == 3
    assert tman.load_moments_categories() == jman.load_moments_categories()
    # tensors: .npy, a .pt of tensors (weights_only), a missing file
    t = np.arange(700, dtype=np.float32)
    torch.save(torch.from_numpy(t), tmp_path / "e.pt")
    np.save(tmp_path / "e.npy", t[None])
    for name in ("e.pt", "e.npy", "missing.npy"):
        for width in (2048, 512):
            np.testing.assert_array_equal(
                tman.load_tensor(str(tmp_path / name), width),
                jman.load_tensor(str(tmp_path / name), width))


def _items_equal(jds, tds, seeded=True):
    assert len(jds) == len(tds)
    for i in range(len(jds)):
        random.seed(i)
        want = jds[i]
        random.seed(i)
        got = tds[i]
        assert got.keys() == want.keys()
        for k in want:
            if isinstance(want[k], np.ndarray):
                assert np.asarray(got[k]).dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k])
            else:
                assert got[k] == want[k], k


@pytest.mark.parametrize("state", ["train", "val"])
@pytest.mark.parametrize("mixing", ["double_trans", "concat-norm"])
def test_mmx_dataset_matches_jax(corpora, state, mixing):
    kw = dict(seq_len=5, mixing_method=mixing,
              experts=("img-embeddings", "video-embeddings",
                       "audio-embeddings"))
    path = corpora["mmx"][0 if state == "train" else 1]
    jds = jmmx.MMXTemporalDataset(
        jman.clean_mmx_temporal(jman.load_manifest(path),
                                jmmx.MMX_GENRES_15), JConfig(**kw), state)
    tds = tmmx.MMXTemporalDataset(
        tman.clean_mmx_temporal(tman.load_manifest(path),
                                tmmx.MMX_GENRES_15), TConfig(**kw), state)
    _items_equal(jds, tds)


def test_mmx_datamodule_matches_jax(corpora):
    kw = dict(batch_size=2, seq_len=4, experts=("img-embeddings",
                                                "video-embeddings"))
    jdm = jmmx.MMXDataModule(*corpora["mmx"], JConfig(**kw)).setup()
    tdm = tmmx.MMXDataModule(*corpora["mmx"], TConfig(**kw)).setup()
    assert tdm.train_steps == jdm.train_steps
    for split in ("val_batches", "test_batches"):
        j, t = getattr(jdm, split)(), getattr(tdm, split)()
        j.process_index = 0
        _same_batches(_drain(t), _drain(j))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("cls", [0, 1])
def test_mit_dataset_and_sampler_match_jax(corpora, train, cls):
    kw = dict(batch_size=2, cls=cls,
              experts=("img-embeddings", "location-embeddings"))
    jdm = jmit.MITDataModule(*corpora["mit"], JConfig(**kw)).setup()
    tdm = tmit.MITDataModule(*corpora["mit"], TConfig(**kw)).setup()
    name = "_train_ds" if train else "_val_ds"
    _items_equal(getattr(jdm, name), getattr(tdm, name))
    rng = np.random.default_rng(9)
    np.testing.assert_array_equal(tdm._sampler(np.random.default_rng(9)),
                                  jdm._sampler(rng))
    assert tdm.train_steps == jdm.train_steps


@pytest.mark.parametrize("source", ["mmx", "mit", "short"])
@pytest.mark.parametrize("aggregation", ["none", "avg_pool", "mean_pool"])
@pytest.mark.parametrize("train", [True, False])
def test_contrastive_dataset_matches_jax(corpora, source, aggregation,
                                         train):
    kw = dict(aggregation=aggregation, input_shape=1024,
              experts=("img-embeddings", "location-embeddings"))
    path = corpora[source][0] if source != "short" else corpora["short"]
    jds = jcon.ContrastivePairDataset(jman.load_manifest(path),
                                      JConfig(**kw), train=train)
    tds = tcon.ContrastivePairDataset(tman.load_manifest(path),
                                      TConfig(**kw), train=train)
    _items_equal(jds, tds)
    x = [np.random.default_rng(1).standard_normal((4, 2048))
         .astype(np.float32) for _ in range(2)]
    for mode in ("none", "concat", "avg_pool", "mean_pool"):
        np.testing.assert_array_equal(tcon.aggregate(x, mode, 1024),
                                      jcon.aggregate(x, mode, 1024))


def _relative(records, root):
    """Records with the corpus root taken out of every path."""
    def strip(v):
        if isinstance(v, str):
            return v.replace(root, "<root>")
        if isinstance(v, dict):
            return {k: strip(x) for k, x in v.items()}
        if isinstance(v, list):
            return [strip(x) for x in v]
        return v
    return [strip(r) for r in records]


@pytest.mark.parametrize("kind", ["mmx", "mit"])
def test_port_writers_match_jax_writers(tmp_path, kind):
    write = {"mmx": (jsyn.write_fake_expert_corpus,
                     tsyn.write_fake_expert_corpus),
             "mit": (jsyn.write_fake_mit_corpus,
                     tsyn.write_fake_mit_corpus)}[kind]
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    jpaths = write[0](jroot, seed=3)
    tpaths = write[1](troot, seed=3)
    for jp, tp in zip(jpaths, tpaths):
        assert os.path.basename(jp) == os.path.basename(tp)
        jrec = jman.stream_pickle(jp)
        trec = jman.stream_pickle(tp)      # read by JAX's reader
        assert _relative(trec, troot) == _relative(jrec, jroot)
    subs = [s for s in os.listdir(jroot)
            if os.path.isdir(os.path.join(jroot, s))]
    assert len(subs) == 1
    for sub in subs:
        d = os.path.join(jroot, sub)
        names = sorted(os.listdir(d))
        assert names
        assert names == sorted(os.listdir(os.path.join(troot, sub)))
        for name in names:
            np.testing.assert_array_equal(
                jman.load_tensor(os.path.join(troot, sub, name), None),
                jman.load_tensor(os.path.join(d, name), None))


def test_synthetic_datamodule_matches_jax():
    kw = dict(model="ptn", batch_size=2, seq_len=3, input_dimension=16,
              experts=("a", "b"), seed=4)
    jdm = jsyn.SyntheticDataModule(JConfig(**kw), train_size=6)
    tdm = tsyn.SyntheticDataModule(TConfig(**kw), train_size=6)
    assert tdm.train_steps == jdm.train_steps == 3
    for split in ("train_batches", "val_batches", "test_batches"):
        _same_batches(list(getattr(tdm, split)()),
                      list(getattr(jdm, split)()))


def test_device_prefetch_on_the_cpu():
    ds = _Items()
    batches = _drain(tpipe.Loader(ds, batch_size=4, num_workers=0))
    placed = list(tpipe.device_prefetch(iter(batches), device="cpu"))
    assert len(placed) == len(batches)
    for got, want in zip(placed, batches):
        assert set(got) == {"x", "y"}          # the paths stay on the host
        for k in got:
            assert got[k].device.type == "cpu" and not got[k].is_pinned()
            np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_device_prefetch_forwards_an_error_and_stops_when_left():
    def broken():
        yield {"x": np.zeros(3, np.float32)}
        raise OSError("disk gone")

    it = tpipe.device_prefetch(broken(), device="cpu")
    next(it)
    with pytest.raises(OSError, match="disk gone"):
        next(it)

    closed = threading.Event()

    def endless():
        try:
            while True:
                yield {"x": np.ones(4, np.float32)}
        finally:
            closed.set()

    before = {t for t in threading.enumerate()
              if t.name == "devt-device-prefetch"}
    it = tpipe.device_prefetch(endless(), device="cpu", depth=2)
    next(it)
    it.close()                    # the consumer leaves
    assert closed.wait(10), "the source was not closed"
    deadline = time.time() + 10
    while time.time() < deadline and {
            t for t in threading.enumerate()
            if t.name == "devt-device-prefetch"} - before:
        time.sleep(0.05)
    assert not {t for t in threading.enumerate()
                if t.name == "devt-device-prefetch"} - before


def test_pinned_placer_needs_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA"):
        tpipe.PinnedPlacer(torch.device("cpu"))
