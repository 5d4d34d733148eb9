"""Train briefly, checkpoint (asynchronously), then serve predictions
with the bucketed ``Predictor``: the reference main.py's
test-from-checkpoint behaviour (src/main.py:89,111) as a serving flow,
the port of ``examples/serve_from_checkpoint.py``.

Then the deployment artifact: ``Predictor.export`` writes one
``torch.export`` program with the weights inside, and ``load_exported``
serves it without the model code or the checkpoint, reproducing the live
scores.
"""

import argparse
import os
import tempfile

import numpy as np

from devt_tpu_torch.config import Config
from devt_tpu_torch.main import build_datamodule
from devt_tpu_torch.registry import build_model
from devt_tpu_torch.serve import Predictor, load_exported
from devt_tpu_torch.train import checkpoint as ckpt_lib
from devt_tpu_torch.train.harness import Trainer


def main(argv=None, device=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "devt_torch_example_serve"))
    args = parser.parse_args(argv)
    cfg = Config(model="ptn", data_set="synthetic", batch_size=4,
                 seq_len=4, nlayers=1, input_dimension=64, nhid=64,
                 nhead=2, n_classes=15, epochs=1, max_steps=8,
                 experts=("img-embeddings", "video-embeddings"),
                 precision="f32", attention_impl="xla", dropout=0.0,
                 checkpoint_dir=os.path.join(args.workdir, "ck"))
    model = build_model(cfg)
    Trainer(cfg, device=device).fit(model, build_datamodule(cfg))

    path = ckpt_lib.latest_checkpoint(cfg.checkpoint_dir)
    pred = Predictor.from_checkpoint(cfg, path, buckets=(1, 4),
                                     device=device)
    x = np.random.default_rng(0).standard_normal(
        (3, 4, 2, 64)).astype(np.float32)
    out = pred.predict({"experts": x})
    print("scores", out["scores"].shape, "labels:", out["labels"][0])

    program = os.path.join(args.workdir, "model.pt2")
    pred.export(program, batch_size=4)
    call = load_exported(program, device=device)
    aot = np.asarray(call({"experts": np.concatenate([x, x[:1]])}))
    assert np.allclose(aot[:3], out["scores"], atol=1e-5)
    print("the exported program reproduces the live scores")
    return out["scores"], aot


if __name__ == "__main__":
    main()
