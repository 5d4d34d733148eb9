"""Train the flagship ViViT (factorized space-time transformer) on
synthetic clips, the model of the north-star bench: the port of
``examples/train_vivit_synthetic.py``.

The reference's ``python src/main.py`` flow (config-driven model and
dataset dispatch), the synthetic dataset standing in for the corpus.  On
the card the space blocks run kernels 1 and 2.
"""

import os
import tempfile

from devt_tpu_torch import main as entry

ARGS = ["--model", "vivit", "--data_set", "synthetic",
        "--batch_size", "8", "--frame_len", "8", "--n_classes", "19",
        "--epochs", "2", "--max_steps", "40", "--log_every", "5",
        "--opt", "adamW", "--learning_rate", "1e-4"]


def main(argv=None, device=None):
    ckpt = os.path.join(tempfile.gettempdir(), "devt_torch_example_vivit")
    return entry.main(ARGS + ["--checkpoint_dir", ckpt] + list(argv or []),
                      device=device)


if __name__ == "__main__":
    main()
