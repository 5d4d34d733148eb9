"""Normalization constants of the host transform stacks.

Own copy of the constants in ``devt_tpu/data/transforms.py``: ImageNet
statistics for frames, Kinetics statistics for clips.  The PIL transform
stacks themselves are not ported.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
KINETICS_MEAN = np.array([0.43216, 0.394666, 0.37645], np.float32)
KINETICS_STD = np.array([0.22803, 0.22145, 0.216989], np.float32)
