"""Multi-modal contrastive pretraining (SimCLR-style, NT-Xent) with the
SSL online linear probe evaluating the representations during training:
the reference's contrastivemodel.py and SSLOnlineEval path, the port of
``examples/contrastive_pretrain.py``.

Over a data axis the negatives are global across the ranks (the loss
gathers the projections, ``models/losses.py:nt_xent``).  No kernel of the
port runs here.
"""

import os
import tempfile

from devt_tpu_torch import main as entry

ARGS = ["--model", "contrastive", "--data_set", "synthetic",
        "--batch_size", "8", "--input_dimension", "128",
        "--hidden_layer", "64", "--projection_size", "32",
        "--epochs", "2", "--max_steps", "40", "--log_every", "10"]


def main(argv=None, device=None):
    ckpt = os.path.join(tempfile.gettempdir(),
                        "devt_torch_example_contrastive")
    return entry.main(ARGS + ["--checkpoint_dir", ckpt] + list(argv or []),
                      device=device)


if __name__ == "__main__":
    main()
