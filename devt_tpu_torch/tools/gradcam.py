"""Grad-CAM for the conv backbones.

The port of ``devt_tpu/tools/gradcam.py``: the reference imports
``pytorch_grad_cam`` (src/main.py:20-22) and carries a commented
visualisation of ``vid_model.backbone.layer4[-1]`` (src/main.py:95-108).

As in the JAX package, with no hooks and no graph surgery: the trunk runs
once (``output="stages"``, without a graph), and the gradient of the
picked class score with respect to layer4's activation comes from one
``torch.autograd.grad`` through a function that runs the head from that
activation (JAX's ``head_from_act``).  Everything runs on the model's
device; no kernel of the port is involved.

``gradcam_resnet`` targets layer4 of the 2-D ResNet, ``gradcam_r2plus1d``
layer4 of R(2+1)D; ``show_cam_on_image`` is the overlay helper.
"""

from __future__ import annotations

import copy

import numpy as np
import torch


def _stages(model):
    """The same modules and weights, returning the stage maps."""
    stages = copy.copy(model)
    stages.output = "stages"
    return stages


def _cam(model, high: torch.Tensor, class_idx, head_fn, dims) -> np.ndarray:
    """The CAM of layer4's activation ``high`` (B, …, C): the class score's
    gradient averaged over ``dims``, weighting the channels, ReLU, scaled
    to [0, 1] per sample."""
    high = high.detach().requires_grad_(True)
    pooled = high.mean(dim=dims)
    if head_fn is not None:
        logits = head_fn(pooled)
    else:
        # pooled @ kernel + bias on the f32 parameters, as JAX's promotes
        logits = pooled.float() @ model.fc.weight.float().t() \
            + model.fc.bias.float()
    idx = torch.as_tensor(class_idx, device=high.device).broadcast_to(
        (high.shape[0],))
    picked = logits.gather(1, idx[:, None].long()).sum()
    (grads,) = torch.autograd.grad(picked, high)
    weights = grads.mean(dim=dims, keepdim=True)
    cam = torch.relu((weights * high).sum(dim=-1)).detach()
    cam_max = cam.amax(dim=tuple(range(1, cam.dim())), keepdim=True)
    return (cam / cam_max.clamp_min(1e-8)).float().cpu().numpy()


def _device(model) -> torch.device:
    return next(model.parameters()).device


def gradcam_resnet(model, images, class_idx, head_fn=None) -> np.ndarray:
    """CAM heatmaps for a port ResNet (``models/resnet.py``).

    images: (B, H, W, C); class_idx: int or (B,).  ``head_fn(pooled)``
    maps pooled features to logits; by default the model's own ``fc``
    (a model built with ``output="logits"``).

    Returns (B, H/32, W/32) heatmaps in [0, 1], f32 numpy."""
    x = torch.as_tensor(np.asarray(images, np.float32), device=_device(model))
    with torch.no_grad():
        *_, high = _stages(model)(x, train=False)
    return _cam(model, high, class_idx, head_fn, (1, 2))


def gradcam_r2plus1d(model, clips, class_idx, head_fn=None) -> np.ndarray:
    """CAM heatmaps for the R(2+1)D video backbone
    (``models/r2plus1d.py``), the reference's commented target
    ``vid_model.backbone.layer4[-1]``.

    clips: (B, T, H, W, C); class_idx: int or (B,).  ``head_fn(pooled)``
    maps the pooled 512-d features to logits (by default the model's fc).

    Returns (B, T/8, H/16, W/16) heatmaps in [0, 1], f32 numpy: one
    spatial CAM per temporal super-frame."""
    x = torch.as_tensor(np.asarray(clips, np.float32), device=_device(model))
    with torch.no_grad():
        high = _stages(model)(x, train=False)
    return _cam(model, high, class_idx, head_fn, (1, 2, 3))


def show_cam_on_image(image: np.ndarray, cam: np.ndarray,
                      alpha: float = 0.5) -> np.ndarray:
    """Overlay a [0, 1] heatmap on an HWC [0, 1] image (the reference's
    ``show_cam_on_image``).  Returns uint8 HWC."""
    from PIL import Image

    h, w = image.shape[:2]
    heat = np.asarray(Image.fromarray(
        (cam * 255).astype(np.uint8)).resize((w, h), Image.BILINEAR),
        np.float32) / 255.0
    # a jet-style colormap: blue → green → red
    r = np.clip(1.5 * heat - 0.5, 0, 1)
    g = 1.0 - np.abs(2.0 * heat - 1.0)
    b = np.clip(1.0 - 1.5 * heat, 0, 1)
    colored = np.stack([r, g, b], axis=-1)
    out = (1 - alpha) * image + alpha * colored
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)
