"""The port's numpy metrics against the JAX package's, which call
scikit-learn (``devt_tpu/train/metrics.py``, ``SSLOnlineEval``'s epoch
end in ``devt_tpu/train/callbacks.py``).

Inputs are drawn with numpy from a seed: random multi-hot labels and f32
scores, plus the edge cases (a sample with no positive label, a class
with no positive, tied scores, no score above the threshold, every label
negative).  Scores agree within 1e-12; the report text is equal.
"""

import numpy as np
import pytest
import torch

from devt_tpu.train import callbacks as jcb
from devt_tpu.train import metrics as jm
from devt_tpu_torch.config import MMX_GENRES_15, MMX_GENRES_19
from devt_tpu_torch.train import callbacks as tcb
from devt_tpu_torch.train import metrics as tm

TOL = 1e-12


class _Log:
    def __init__(self):
        self.records, self.texts, self.tables = [], [], []

    def log(self, metrics, step=None):
        self.records.append((dict(metrics), step))

    def log_text(self, key, text, step=None):
        self.texts.append((key, text, step))

    def log_table(self, key, columns, rows, step=None):
        self.tables.append((key, list(columns), list(rows), step))


def _case(name, seed=0, n=37, c=15):
    rng = np.random.default_rng(seed)
    labels = (rng.random((n, c)) < 0.25).astype(np.float32)
    probs = rng.random((n, c)).astype(np.float32)
    if name == "no_positive_sample":
        labels[[0, 5, 11]] = 0.0
    elif name == "no_positive_class":
        labels[:, [2, 9]] = 0.0
    elif name == "ties":
        probs = (np.round(probs * 4) / 4).astype(np.float32)
        labels[3] = 0.0
    elif name == "nothing_above":
        probs = (probs * 0.05).astype(np.float32)
    elif name == "all_negative":
        labels[:] = 0.0
    elif name == "binary_scores":
        probs = (probs > 0.6).astype(np.float32)
    return labels, probs


CASES = ["random", "no_positive_sample", "no_positive_class", "ties",
         "nothing_above", "all_negative", "binary_scores"]


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("case", CASES)
def test_f1_sweep_and_average_precision_match_sklearn(case):
    labels, probs = _case(case)
    got = tm.f1_threshold_sweep(labels, probs)
    want = jm.f1_threshold_sweep(labels, probs)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])
    for average in ("samples", "weighted"):
        g = tm.average_precision(labels, probs, average)
        w = jm.average_precision(labels, probs, average)
        assert abs(g - w) <= TOL, (average, g, w)


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("names", [MMX_GENRES_15, MMX_GENRES_19[:15]])
def test_genre_report_text_is_sklearns(case, names):
    labels, probs = _case(case, seed=1)
    assert tm.genre_report(labels, probs, names) \
        == jm.genre_report(labels, probs, names)


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("zero_division", [0, 1])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted",
                                     "samples"])
@pytest.mark.parametrize("case", CASES)
def test_precision_recall_f1_match_sklearn(case, average, zero_division):
    from sklearn.metrics import precision_recall_fscore_support

    labels, probs = _case(case, seed=2)
    preds = (probs > 0.3).astype(int)
    got = tm.precision_recall_f1(labels, preds, average, zero_division)
    want = precision_recall_fscore_support(
        labels.astype(int), preds, average=average,
        zero_division=zero_division)
    for g, w in zip(got[:3], want[:3]):
        assert abs(g - w) <= TOL, (g, w)


def test_report_refuses_a_wrong_name_count():
    labels, probs = _case("random")
    with pytest.raises(ValueError, match="target_names"):
        tm.genre_report(labels, probs, MMX_GENRES_19)


def test_top1_accuracy_and_running_buffers():
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 10, 50)
    probs = rng.random((50, 10))
    assert tm.top1_accuracy(labels, probs) == jm.top1_accuracy(labels, probs)
    onehot = np.eye(10)[labels]
    assert tm.top1_accuracy(onehot, probs) == jm.top1_accuracy(onehot, probs)

    buf = tm.RunningBuffers()
    buf.append({"probs": torch.tensor(probs[:20], dtype=torch.bfloat16),
                "label": torch.tensor(onehot[:20]), "path": ["a"] * 20})
    buf.append({"probs": probs[20:], "label": onehot[20:],
                "embedding": np.ones((30, 4))})
    lab, pr = buf.concatenated()
    assert lab.dtype == pr.dtype == np.float32 and pr.shape == (50, 10)
    np.testing.assert_array_equal(lab, onehot.astype(np.float32))
    assert len(buf) == 2 and len(buf.paths) == 20
    buf.reset()
    assert len(buf) == 0 and not buf.paths and not buf.embeddings


def _buffers(mod, labels, probs):
    buf = mod.RunningBuffers()
    for i in range(0, len(labels), 8):
        buf.append({"probs": probs[i:i + 8], "label": labels[i:i + 8],
                    "path": [f"p{j}" for j in range(i, i + 8)]})
    return buf


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("case", CASES)
def test_transformer_eval_matches_jax(case, tmp_path):
    labels, probs = _case(case, seed=4, n=40)
    names = MMX_GENRES_19
    jlog, tlog = _Log(), _Log()
    want = jcb.TransformerEval(names, out_dir=str(tmp_path / "j")) \
        .on_validation_epoch_end(_buffers(jm, labels, probs), jlog, 3)
    got = tcb.TransformerEval(names, out_dir=str(tmp_path / "t")) \
        .on_validation_epoch_end(_buffers(tm, labels, probs), tlog, 3)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= TOL, k
    assert tlog.texts == jlog.texts
    jt = jcb.TransformerEval(names, out_dir=str(tmp_path / "j")) \
        .on_test_epoch_end(_buffers(jm, labels, probs), jlog, 4)
    tt = tcb.TransformerEval(names, out_dir=str(tmp_path / "t")) \
        .on_test_epoch_end(_buffers(tm, labels, probs), tlog, 4)
    assert tt == jt
    for f in ("labels.pkl", "logits.pkl"):
        assert (tmp_path / "t" / f).read_bytes() \
            == (tmp_path / "j" / f).read_bytes()


def test_mit_eval_and_display_results_match_jax(tmp_path):
    import pickle

    rng = np.random.default_rng(5)
    labels = np.eye(15, dtype=np.float32)[rng.integers(0, 15, 24)]
    probs = rng.random((24, 15)).astype(np.float32)
    assert tcb.MITEval().on_validation_epoch_end(
        _buffers(tm, labels, probs), _Log(), 1) \
        == jcb.MITEval().on_validation_epoch_end(
            _buffers(jm, labels, probs), _Log(), 1)
    paths = {}
    for name, cb, mod in (("j", jcb, jm), ("t", tcb, tm)):
        out = str(tmp_path / name / "embed.pkl")
        buf = _buffers(mod, labels, probs)
        buf.embeddings.append(np.arange(24 * 3, dtype=np.float32)
                              .reshape(24, 3))
        cb.DisplayResults(out_path=out).on_test_epoch_end(buf, _Log(), 2)
        with open(out, "rb") as f:
            paths[name] = pickle.load(f)
    assert paths["t"].keys() == paths["j"].keys()
    for i, rec in paths["j"].items():
        got = paths["t"][i]
        assert (got["path"], got["predicted"], got["actual"]) \
            == (rec["path"], rec["predicted"], rec["actual"])
        np.testing.assert_array_equal(got["embedding"], rec["embedding"])


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("case", CASES)
def test_ssl_online_eval_epoch_end_matches_jax(case):
    """The probe's epoch end: weighted F1, recall, precision (zero
    division 1) and AP of the thresholded scores, and the truth/guess
    table, against the JAX callback's sklearn calls."""
    labels, probs = _case(case, seed=6, n=30)
    jlog, tlog = _Log(), _Log()
    jcb_ = jcb.SSLOnlineEval(z_dim=8, num_classes=15)
    tcb_ = tcb.SSLOnlineEval(z_dim=8, num_classes=15)
    want = jcb_.on_validation_epoch_end(_buffers(jm, labels, probs), jlog, 7)
    got = tcb_.on_validation_epoch_end(_buffers(tm, labels, probs), tlog, 7)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])
    assert tlog.tables == jlog.tables


def test_ssl_probe_trains_and_scores():
    """The torch probe: the JAX probe's init scale (N(0, 2 / fan_in)),
    seeded draws, a falling BCE on a fixed batch, scores in (0, 1)."""
    rng = np.random.default_rng(7)
    z = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    y = torch.from_numpy((rng.random((64, 5)) < 0.3).astype(np.float32))
    probe = tcb.SSLOnlineEval(z_dim=16, num_classes=5, hidden=256, lr=0.5)
    again = tcb.SSLOnlineEval(z_dim=16, num_classes=5, hidden=256, lr=0.5)
    for k in probe.params:
        torch.testing.assert_close(probe.params[k], again.params[k],
                                   rtol=0, atol=0)
    w1 = probe.params["w1"]
    assert abs(w1.std().item() / (2.0 / 16) ** 0.5 - 1.0) < 0.05
    log = _Log()
    for step in range(30):
        probe.on_train_batch_end({"embedding": z, "label": y}, log, step)
    losses = [r[0]["train/online/loss"] for r in log.records]
    assert losses[-1] < losses[0]
    buf = tm.RunningBuffers()
    probe.eval_batch({"embedding": z, "label": y}, buf)
    _, probs = buf.concatenated()
    assert probs.shape == (64, 5) and ((probs > 0) & (probs < 1)).all()
