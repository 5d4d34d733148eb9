"""On-device dequantize + normalize for the uint8 wire format.

Port of ``devt_tpu/data/device_norm.py``: decoded pixels cross the
host→device link as uint8 (4x fewer bytes than f32) and ``(v/255 -
mean)/std`` runs on the device as one multiply-add.  ``vid`` uses the
Kinetics statistics, ``img`` the ImageNet ones, and the pre-patchified
``vid_tokens`` wire (..., N, p*p*c) tiles the per-channel constants to a
per-lane vector.
"""

from __future__ import annotations

import numpy as np
import torch

from devt_tpu_torch.data import transforms

_NORM_BY_KEY = {
    "vid": (transforms.KINETICS_MEAN, transforms.KINETICS_STD),
    "img": (transforms.IMAGENET_MEAN, transforms.IMAGENET_STD),
}


def dequantize(x: torch.Tensor, mean: np.ndarray, std: np.ndarray,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 HWC pixels → normalized ``dtype``:
    ``x * (1/(255*std)) + (-mean/std)``, algebraically the host path's
    ``(x/255 - mean)/std``."""
    scale = torch.as_tensor((1.0 / (255.0 * std)).astype(np.float32))
    bias = torch.as_tensor((-mean / std).astype(np.float32))
    return x.to(dtype) * scale.to(x.device, dtype) \
        + bias.to(x.device, dtype)


def maybe_dequantize_batch(batch: dict, dtype: torch.dtype = torch.bfloat16
                           ) -> dict:
    """Return ``batch`` with any uint8 ``vid``/``img``/``vid_tokens``
    tensors normalized; float tensors pass through untouched."""
    out = dict(batch)
    for key, (mean, std) in _NORM_BY_KEY.items():
        v = out.get(key)
        if v is not None and v.dtype == torch.uint8:
            out[key] = dequantize(v, mean, std, dtype=dtype)
    tok = out.get("vid_tokens")
    if tok is not None and tok.dtype == torch.uint8:
        mean, std = _NORM_BY_KEY["vid"]
        reps = tok.shape[-1] // mean.shape[-1]
        out["vid_tokens"] = dequantize(tok, np.tile(mean, reps),
                                       np.tile(std, reps), dtype=dtype)
    return out
