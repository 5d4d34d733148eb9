#!/usr/bin/env python3
"""bf16 convolutions on the CPU (and on the card, where there is one)
against f64 on the same bf16-rounded operands.

    python tools/bf16_conv_cpu.py

For each shape below, one convolution's forward, input gradient and
weight gradient, three ways where a card is present, two without:

  * ``torch``: PyTorch's own bf16 ``F.conv2d`` / ``F.conv3d`` on the CPU;
  * ``port``: ``devt_tpu_torch.models.resnet.conv`` in bf16 on the CPU,
    the port's plain path;
  * ``card``: the same ``conv`` on the card (cuDNN's bf16 convolution).

Each is held against the f64 convolution of the same bf16-rounded input,
kernel and output gradient, as the largest |error| over the largest
element of the f64 result: a sound bf16 convolution, which accumulates in
f32 and rounds its result once, lands within about 2^-8 (4e-3).  The
shapes are R(2+1)D-18's temporal (3, 1, 1) convolutions of layer 4 at
FrameTransformer's clip (8 clips of 12 x 112²), one of layer 3, one at a
smaller clip, and a 3 x 3 of ResNet-34's layer 4.  Prints the host's
PyTorch, the card's name and power limit, one line a shape and a JSON
line of every reading; exits 1 if the port's path lands past 1e-2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch import nn  # noqa: E402

from devt_tpu_torch.models.resnet import conv  # noqa: E402

# (batch, in channels, frames or None for 2-D, height, out channels,
# kernel, stride)
SHAPES = [(8, 1152, 2, 7, 512, (3, 1, 1), (1, 1, 1)),
          (8, 1152, 4, 7, 512, (3, 1, 1), (2, 1, 1)),
          (8, 576, 3, 14, 256, (3, 1, 1), (1, 1, 1)),
          (4, 128, 8, 28, 128, (3, 1, 1), (1, 1, 1)),
          (20, 512, None, 7, 512, (3, 3), (1, 1))]
LIMIT = 1e-2


def _operands(n, cin, t, h, cout, kernel, stride):
    g = torch.Generator().manual_seed(0)
    spatial = (h, h) if t is None else (t, h, h)
    pad = tuple(k // 2 for k in kernel)
    m = (nn.Conv2d if t is None else nn.Conv3d)(cin, cout, kernel, stride,
                                                pad, bias=False)
    fan_in = cin * m.weight[0, 0].numel()
    with torch.no_grad():
        m.weight.copy_((torch.randn(m.weight.shape, generator=g)
                        / fan_in ** 0.5).bfloat16().float())
    x = torch.randn((n, cin) + spatial, generator=g).bfloat16()
    fmt = torch.channels_last if t is None else torch.channels_last_3d
    x = x.to(memory_format=fmt)
    with torch.no_grad():
        out = F.conv2d if t is None else F.conv3d
        shape = out(x[:1].float(), m.weight, None, stride, pad).shape[1:]
    go = torch.randn((n,) + tuple(shape), generator=g).bfloat16().to(
        memory_format=fmt)
    return m, x, go


def _grads(fn, x, w, go):
    x, w = x.detach().requires_grad_(), w.detach().requires_grad_()
    y = fn(x, w)
    gx, gw = torch.autograd.grad(y, (x, w), go.to(y.dtype))
    return y, gx, gw


def _reading(got, want):
    return [((a.double().cpu() - b).abs().max() / b.abs().max()).item()
            for a, b in zip(got, want)]


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() if torch.cuda.is_available(
                         ) else "no card"
    print(f"torch {torch.__version__}, CPU capability "
          f"{torch.backends.cpu.get_cpu_capability()}; {smi}", flush=True)
    rows, worst = [], 0.0
    for shape in SHAPES:
        m, x, go = _operands(*shape)
        stride, pad = m.stride, m.padding
        raw = F.conv2d if x.dim() == 4 else F.conv3d
        want = _grads(lambda a, b: raw(a, b, None, stride, pad), x.double(),
                      m.weight.double(), go.double())

        def port(a, b):
            return conv(SimpleNamespace(weight=b, stride=stride,
                                        padding=pad), a, torch.bfloat16)

        fmt = torch.channels_last if x.dim() == 4 else \
            torch.channels_last_3d
        w = m.weight.detach()
        row = {"shape": shape,
               "torch": _reading(_grads(lambda a, b: raw(
                   a, b.to(torch.bfloat16, memory_format=fmt), None, stride,
                   pad), x, w, go), want),
               "port": _reading(_grads(port, x, w, go), want)}
        if torch.cuda.is_available():
            row["card"] = _reading(_grads(port, x.cuda(), w.cuda(),
                                          go.cuda()), want)
        worst = max(worst, *row["port"])
        rows.append(row)
        print(f"{shape}: " + "; ".join(
            f"{k} forward {v[0]:.3e}, input gradient {v[1]:.3e}, weight "
            f"gradient {v[2]:.3e}" for k, v in row.items() if k != "shape"),
            flush=True)
    print(json.dumps({"torch": torch.__version__, "device": smi,
                      "rows": rows}))
    return 0 if worst <= LIMIT else 1


if __name__ == "__main__":
    sys.exit(main())
