"""The port's training harness and entry point against the JAX package's.

  * fit: a tiny f32 PTN at dropout 0, run by JAX's ``Trainer.fit`` and by
    the port's (device ``"cpu"``) from the same initial weights
    (``utils.jax_bridge``), two epochs with validation: the logged
    ``train/loss``, ``val/loss`` and ``TransformerEval``'s results agree
    within 1e-5 relative;
  * resume: a fit resumed from a checkpoint (at an epoch's end and mid
    epoch, with the multi-step unroll's dropped tail, at dropout 0.1)
    equals an unbroken one bit for bit;
  * checkpoints: best-k retention, ``latest_checkpoint``, the config
    snapshot, a write that fails;
  * a non-finite loss raises ``FloatingPointError`` and the pending
    checkpoint write is awaited;
  * ``main()`` on ``synthetic``, ``mmx`` and ``mmx-contrastive``, and its
    refusals (``mmx-frame``, a mesh);
  * ``Predictor.from_checkpoint`` against JAX's on the same weights.
"""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from devt_tpu.config import Config as JConfig
from devt_tpu.data.pipeline import Loader as JLoader
from devt_tpu.registry import build_model as jbuild
from devt_tpu.serve import Predictor as JPredictor
from devt_tpu.train import callbacks as jcb
from devt_tpu.train import checkpoint as jckpt
from devt_tpu.train.harness import Trainer as JTrainer
from devt_tpu_torch import main as tmain
from devt_tpu_torch.config import Config as TConfig
from devt_tpu_torch.data.pipeline import Loader as TLoader
from devt_tpu_torch.data.synthetic import write_fake_expert_corpus
from devt_tpu_torch.registry import build_model as tbuild
from devt_tpu_torch.serve import Predictor as TPredictor
from devt_tpu_torch.train import callbacks as tcb
from devt_tpu_torch.train import checkpoint as tckpt
from devt_tpu_torch.train.harness import Trainer as TTrainer
from devt_tpu_torch.train.optimizers import build_optimizer
from devt_tpu_torch.train.state import TrainState
from devt_tpu_torch.utils.jax_bridge import jax_to_state_dict

PTN = dict(model="ptn", batch_size=4, seq_len=4, nlayers=1,
           input_dimension=64, nhid=64, nhead=2, dropout=0.0, n_classes=15,
           experts=("a", "b"), learning_rate=1e-3, opt="adamW",
           precision="f32", attention_impl="xla", log_every=1)
RTOL = 1e-5


class _Log:
    def __init__(self):
        self.records = []

    def log(self, metrics, step=None):
        self.records.append((dict(metrics), step))

    def log_text(self, key, text, step=None):
        self.log({key: text}, step)

    def log_table(self, key, columns, rows, step=None):
        self.log({key: (list(columns), list(rows))}, step)

    def close(self):
        pass

    def values(self, key):
        return [(step, m[key]) for m, step in self.records if key in m]


class _Arrays:
    def __init__(self, n, seed=3):
        rng = np.random.default_rng(seed)
        self.experts = rng.standard_normal((n, 4, 2, 64)).astype(np.float32)
        self.label = (rng.random((n, 15)) < 0.3).astype(np.float32)
        self.label[:, 5] = 1.0

    def __len__(self):
        return len(self.experts)

    def __getitem__(self, i):
        return {"experts": self.experts[i], "label": self.label[i]}


class _DM:
    """A Loader of either package over the same arrays (one thread)."""

    def __init__(self, loader_cls, cfg, n=16, seed=3):
        self.loader_cls, self.cfg = loader_cls, cfg
        self.ds = _Arrays(n, seed)
        self.val = _Arrays(8, seed + 1)
        self.train_steps = n // cfg.batch_size

    def setup(self):
        return self

    def _loader(self, ds, **kw):
        return self.loader_cls(ds, self.cfg.batch_size, num_workers=1,
                               process_index=0, process_count=1, **kw)

    def train_batches(self):
        return self._loader(self.ds, shuffle=True, seed=self.cfg.seed)

    def val_batches(self):
        return self._loader(self.val)

    test_batches = val_batches


def _jax_init(jcfg, n_experts=2):
    model = jbuild(jcfg)
    example = jnp.zeros((jcfg.batch_size, jcfg.seq_len, n_experts,
                         jcfg.input_dimension), jnp.float32)
    variables = model.init({"params": jax.random.PRNGKey(jcfg.seed),
                            "dropout": jax.random.PRNGKey(jcfg.seed + 1)},
                           experts=example)
    return model, jax.tree_util.tree_map(np.asarray, variables)


def _port_model(tcfg, variables):
    model = tbuild(tcfg)
    model.load_state_dict(jax_to_state_dict(variables))
    return model


def _close(got, want, what):
    assert [s for s, _ in got] == [s for s, _ in want], what
    for (_, g), (_, w) in zip(got, want):
        assert abs(g - w) <= RTOL * max(abs(w), 1e-12), (what, g, w)


def test_fit_matches_jax_fit(tmp_path):
    kw = dict(PTN, epochs=2, eval_every_epochs=1, seed=11)
    jcfg = JConfig(checkpoint_dir=str(tmp_path / "j"), **kw)
    tcfg = TConfig(checkpoint_dir=str(tmp_path / "t"), **kw)
    jmodel, variables = _jax_init(jcfg)
    jlog, tlog = _Log(), _Log()
    JTrainer(jcfg, callbacks=[jcb.TransformerEval(out_dir=str(tmp_path))],
             logger=jlog).fit(jmodel, _DM(JLoader, jcfg))
    state = TTrainer(tcfg, callbacks=[tcb.TransformerEval(
        out_dir=str(tmp_path))], logger=tlog, device="cpu").fit(
        _port_model(tcfg, variables), _DM(TLoader, tcfg))
    assert state.step == 8
    assert len(jlog.values("train/loss")) == 8
    keys = ["train/loss", "val/loss", "sklearn apr", "sklearn apr weighted"]
    keys += [k for k in (jlog.records[-2][0]) if k.startswith("val/online/")]
    assert len(keys) == 13
    for key in keys:
        _close(tlog.values(key), jlog.values(key), key)
    assert tlog.values("val/report") == jlog.values("val/report")


def _fit(cfg, variables, n=20, logger=None):
    model = _port_model(cfg, variables)
    state = TTrainer(cfg, logger=logger or _Log(), device="cpu").fit(
        model, _DM(TLoader, cfg, n=n))
    return state


@pytest.mark.parametrize("unroll", [1, 2])
def test_resumed_fit_equals_an_unbroken_one(tmp_path, unroll):
    """20 samples at batch 4: 5 steps an epoch, 4 with the 2-step unroll
    (the tail dropped).  Resume from an epoch's end and from mid epoch;
    dropout 0.1, whose masks fold the step into the seed."""
    kw = dict(PTN, dropout=0.1, epochs=3, eval_every_epochs=1,
              unroll_steps=unroll, log_every=2, seed=5)
    _, variables = _jax_init(JConfig(**kw))
    other = jax.tree_util.tree_map(lambda v: v + 1.0, variables)
    spe = 5 if unroll == 1 else 4
    a = _fit(TConfig(checkpoint_dir=str(tmp_path / "a"), **kw), variables)
    assert a.step == 3 * spe
    for stop in (spe, spe + 2):       # an epoch's end, then mid epoch
        first = TConfig(checkpoint_dir=str(tmp_path / f"b{stop}"),
                        **dict(kw, max_steps=stop))
        _fit(first, variables)
        mid = tckpt.latest_checkpoint(first.checkpoint_dir)
        assert mid.endswith(f"step_{stop}")
        # the resumed run's model starts from other weights: the
        # checkpoint's win
        b = _fit(TConfig(checkpoint_dir=str(tmp_path / f"c{stop}"),
                         resume=mid, **kw), other)
        assert b.step == a.step
        for k in a.params:
            torch.testing.assert_close(b.params[k], a.params[k], rtol=0,
                                       atol=0, msg=k)
        for sa, sb in zip(a.opt_state, b.opt_state):
            for key in sa:
                va, vb = sa[key], sb[key]
                if isinstance(va, list):
                    for x, y in zip(va, vb):
                        torch.testing.assert_close(y, x, rtol=0, atol=0)
                else:
                    assert va == vb


def test_checkpoints_best_k_latest_and_snapshot(tmp_path):
    kw = dict(PTN, epochs=5, eval_every_epochs=1, best_metric="val/loss",
              best_mode="min", keep_best_k=2, seed=2)
    cfg = TConfig(checkpoint_dir=str(tmp_path / "ck"), **kw)
    _, variables = _jax_init(JConfig(**kw))
    log = _Log()
    state = _fit(cfg, variables, n=16, logger=log)
    ck = cfg.checkpoint_dir
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(ck)
                   if n.startswith("step_"))
    assert steps == [4, 8, 12, 16, 20]
    assert tckpt.latest_checkpoint(ck) == os.path.join(ck, "step_20")
    assert not [n for n in os.listdir(ck) if n.endswith(".tmp")]
    # best: a checkpoint at every improvement, the newest 2 kept
    improved = [s for s, _ in log.values("best/val/loss")]
    val = log.values("val/loss")
    best, want = None, []
    for s, v in val:
        if best is None or v < best:
            best = v
            want.append(s)
    assert improved == want
    best_dir = os.path.join(ck, "best")
    assert sorted(int(n.split("_")[1]) for n in os.listdir(best_dir)
                  if n.startswith("step_")) == want[-2:]
    # the snapshot is YAML that both configs load back to this config
    snap = os.path.join(ck, "config.yaml")
    assert TConfig.from_yaml(snap) == cfg
    assert JConfig.from_yaml(snap).to_dict() == cfg.to_dict()
    assert yaml.safe_load(open(snap))["learning_rate"] == 1e-3
    # the payload reads with weights_only and restores into a new state
    payload = tckpt.load(tckpt.latest_checkpoint(ck))
    assert payload["step"] == 20 == state.step
    fresh = tbuild(cfg)
    other = TrainState.create(dict(fresh.named_parameters()),
                              build_optimizer(cfg))
    tckpt.restore(tckpt.latest_checkpoint(ck), other)
    assert other.step == 20
    for k, v in state.params.items():
        torch.testing.assert_close(other.params[k], v, rtol=0, atol=0)
    tckpt.prune_checkpoints(ck, 2)
    assert sorted(n for n in os.listdir(ck) if n.startswith("step_")) \
        == ["step_16", "step_20"]
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None


def test_async_saver_snapshots_before_returning_and_reraises(tmp_path,
                                                             monkeypatch):
    cfg = TConfig(**PTN)
    model = tbuild(cfg)
    state = TrainState.create(dict(model.named_parameters()),
                              build_optimizer(cfg))
    before = {k: v.detach().clone() for k, v in state.params.items()}
    real = tckpt._write

    def slow(path, payload):
        time.sleep(0.3)
        real(path, payload)

    monkeypatch.setattr(tckpt, "_write", slow)
    saver = tckpt.AsyncSaver()
    path = saver.save(str(tmp_path), state, cfg)
    with torch.no_grad():            # the next step, while the write runs
        for p in state.params.values():
            p.add_(1.0)
    saver.wait()
    saved = tckpt.load(path)["params"]
    for k, v in before.items():
        torch.testing.assert_close(saved[k], v, rtol=0, atol=0)

    def broken(path, payload):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt, "_write", broken)
    saver.save(str(tmp_path), state, cfg, step=9)
    with pytest.raises(OSError, match="disk full"):
        saver.close()


def test_non_finite_loss_raises_and_awaits_the_writer(tmp_path,
                                                      monkeypatch):
    """Epoch 0 ends with a checkpoint whose write is slow; epoch 1's data
    is NaN.  The run raises at the first NaN step's log, and the write of
    step 4 has finished by then."""
    kw = dict(PTN, epochs=3, eval_every_epochs=1, seed=4)
    cfg = TConfig(checkpoint_dir=str(tmp_path / "ck"), **kw)
    _, variables = _jax_init(JConfig(**kw))
    done = threading.Event()
    real = tckpt._write

    def slow(path, payload):
        time.sleep(0.5)
        real(path, payload)
        done.set()

    monkeypatch.setattr(tckpt, "_write", slow)

    class Poisoned(_DM):
        calls = 0

        def train_batches(self):
            self.calls += 1
            if self.calls == 3:              # epoch 1 (call 1: the length)
                self.ds.experts[:] = np.nan
            return super().train_batches()

    log = _Log()
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        TTrainer(cfg, logger=log, device="cpu").fit(
            _port_model(cfg, variables), Poisoned(TLoader, cfg))
    assert done.is_set()
    assert os.path.exists(os.path.join(cfg.checkpoint_dir, "step_4",
                                       tckpt.STATE_FILE))
    fatal = [m for m, s in log.records if "fatal" in m]
    assert len(fatal) == 1 and not np.isfinite(fatal[0]["train/loss"])


TINY_MAIN = ["--model", "ptn", "--batch_size", "32", "--seq_len", "4",
             "--nlayers", "1", "--input_dimension", "64", "--nhid", "64",
             "--nhead", "2", "--precision", "f32", "--experts", "a,b",
             "--dropout", "0.0", "--log_every", "1"]


def test_main_on_synthetic_then_test_from_the_checkpoint(tmp_path,
                                                         monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = TINY_MAIN + ["--data_set", "synthetic", "--epochs", "2",
                        "--checkpoint_dir", "ck", "--save_path", "out",
                        "--name", "tiny"]
    results = tmain.main(argv, device="cpu")
    assert np.isfinite(results["test/loss"])
    assert tckpt.latest_checkpoint("ck").endswith("step_4")   # 2 steps/epoch
    assert os.path.exists("out/tiny/labels.pkl")
    assert os.path.exists("runs/tiny/metrics.jsonl")
    # test alone from the newest checkpoint: the same loss, the embeddings
    again = tmain.main(argv + ["--test", "true"], device="cpu")
    assert again["test/loss"] == results["test/loss"]
    assert os.path.exists("out/tiny/embed_dict.pkl")
    cfg = tmain.parse_args(argv + ["--learning_rate", "0.5"])
    assert cfg.experts == ("a", "b") and cfg.learning_rate == 0.5
    with pytest.raises(AttributeError):
        tmain.parse_args(["--no_such_key", "1"])


def test_main_on_the_embedding_datasets(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    train, val = write_fake_expert_corpus(
        str(tmp_path / "mmx"), n_movies=8, scenes_per_movie=5,
        experts=("video-embeddings", "audio-embeddings"))
    common = ["--train_manifest", train, "--val_manifest", val,
              "--epochs", "1", "--batch_size", "4", "--precision", "f32",
              "--experts", "video-embeddings,audio-embeddings",
              "--checkpoint_dir", "ck", "--save_path", "out"]
    r = tmain.main(common + ["--model", "ptn", "--data_set", "mmx",
                             "--seq_len", "5", "--nlayers", "1",
                             "--nhid", "32", "--nhead", "2",
                             "--dropout", "0.0", "--name", "mmx"],
                   device="cpu")
    assert np.isfinite(r["test/loss"])
    r = tmain.main(common + ["--model", "contrastive",
                             "--data_set", "mmx-contrastive",
                             "--hidden_layer", "32", "--projection_size",
                             "16", "--output_shape", "8", "--checkpoint_dir",
                             "ck2", "--name", "con"], device="cpu")
    assert np.isfinite(r["test/loss"])
    with open("runs/con/metrics.jsonl") as f:
        text = f.read()
    assert "train/online/loss" in text and "val/online/f1@0.3" in text


def test_main_and_trainer_refusals(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="item 10"):
        tmain.main(["--data_set", "mmx-frame"], device="cpu")
    for flag in ("--dp", "--mp"):
        with pytest.raises(NotImplementedError, match="item 7"):
            tmain.main(TINY_MAIN + ["--data_set", "synthetic", flag, "2"],
                       device="cpu")
    cfg = TConfig(**PTN)
    with pytest.raises(NotImplementedError, match="item 7"):
        TTrainer(cfg, logger=_Log(), mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        TTrainer(cfg, logger=_Log(), use_mesh=True, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTrainer(cfg, logger=_Log())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(TINY_MAIN + ["--data_set", "synthetic"])
    # the refusals come before the logger writes anything
    assert os.listdir(tmp_path) == []


def test_from_checkpoint_matches_jax(tmp_path):
    """JAX saves an Orbax checkpoint of a PTN state and serves it; its
    restored numpy tree becomes a port checkpoint (through the bridge),
    which the port's ``Predictor.from_checkpoint`` serves."""
    import orbax.checkpoint as ocp

    from devt_tpu.train.optimizers import build_optimizer as jopt
    from devt_tpu.train.state import TrainState as JState

    kw = dict(PTN, seed=8)
    jcfg = JConfig(**kw)
    _, variables = _jax_init(jcfg)
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map(
        lambda v: v + 0.01 * rng.standard_normal(v.shape).astype(v.dtype),
        variables)             # not the init a fresh model would draw
    jstate = JState.create(jax.tree_util.tree_map(jnp.asarray,
                                                  variables["params"]),
                           jopt(jcfg))
    jpath = jckpt.save(str(tmp_path / "j"), jstate, jcfg)
    restored = ocp.StandardCheckpointer().restore(jpath)
    tree = jax.tree_util.tree_map(np.asarray, restored["params"])

    tcfg = TConfig(**kw)
    model = tbuild(tcfg)
    model.load_state_dict(jax_to_state_dict({"params": tree}))
    tstate = TrainState.create(dict(model.named_parameters()),
                               build_optimizer(tcfg))
    tpath = tckpt.save(str(tmp_path / "t"), tstate, tcfg, step=3)

    request = {"experts": rng.standard_normal((5, 4, 2, 64))
               .astype(np.float32)}
    want = JPredictor.from_checkpoint(jcfg, jpath, buckets=(8,)) \
        .predict(request)
    got = TPredictor.from_checkpoint(tcfg, tpath, buckets=(8,),
                                     device="cpu").predict(request)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5,
                               atol=1e-6)
    assert got["labels"] == want["labels"]


def test_build_logger_never_starts_wandb_unasked(tmp_path, monkeypatch):
    """An installed wandb without credentials or network would try to log
    in: the port's entry point logs to JSONL unless the environment
    configures wandb; a configured wandb that fails to start falls back to
    JSONL, as the JAX package's does."""
    import sys
    import types

    from devt_tpu_torch.train import loggers

    calls = []
    fake = types.ModuleType("wandb")

    class _Run:
        def finish(self):
            calls.append("finish")

    def init(**kw):
        calls.append(kw["name"])
        if kw["name"] == "broken":
            raise RuntimeError("api_key not configured (no-tty)")
        return _Run()

    fake.init = init
    monkeypatch.setitem(sys.modules, "wandb", fake)
    monkeypatch.delenv("WANDB_API_KEY", raising=False)
    monkeypatch.delenv("WANDB_MODE", raising=False)
    log = loggers.build_logger(TConfig(name="quiet"), log_dir=str(tmp_path))
    assert isinstance(log, loggers.JsonlLogger) and calls == []
    log.log({"a": 1.5, "b": "text"}, step=3)
    log.close()
    with open(tmp_path / "quiet" / "metrics.jsonl") as f:
        rec = json.loads(f.readline())
    assert rec["step"] == 3 and rec["a"] == 1.5 and rec["b"] == "text"
    monkeypatch.setenv("WANDB_MODE", "offline")
    log = loggers.build_logger(TConfig(name="wb"), log_dir=str(tmp_path))
    assert isinstance(log, loggers.WandbLogger) and calls == ["wb"]
    log.close()
    log = loggers.build_logger(TConfig(name="broken"), log_dir=str(tmp_path))
    assert isinstance(log, loggers.JsonlLogger)
    assert calls == ["wb", "finish", "broken"]
    log.close()
