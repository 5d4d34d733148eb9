"""The reference's primary training path: the pyramid transformer (PTN,
src/models/transformer.py) over per-scene expert-embedding sequences,
with the TransformerEval callbacks (threshold-swept F1, mAP,
classification report) at each validation epoch: the port of
``examples/train_ptn_experts.py``.  On the card its encoder layers run
kernels 3 and 4 (dropout 0.1 inside them).
"""

import os
import tempfile

from devt_tpu_torch import main as entry

ARGS = ["--model", "ptn", "--data_set", "synthetic",
        "--batch_size", "4", "--seq_len", "13", "--nlayers", "2",
        "--input_dimension", "2048", "--nhid", "2048", "--nhead", "8",
        "--n_classes", "15", "--dropout", "0.1",
        "--epochs", "2", "--max_steps", "20", "--log_every", "10"]


def main(argv=None, device=None):
    ckpt = os.path.join(tempfile.gettempdir(), "devt_torch_example_ptn")
    return entry.main(ARGS + ["--checkpoint_dir", ckpt] + list(argv or []),
                      device=device)


if __name__ == "__main__":
    main()
