"""Parameter initializers matching PyTorch's defaults, drawn from an explicit
``torch.Generator`` (counterpart of ``ecs_yolo_tpu/nn/initializers.py``).

A conv weight and its bias both draw from ``U(-1/sqrt(fan_in),
1/sqrt(fan_in))``: ``kaiming_uniform_(a=sqrt(5))`` gives that bound for the
weight.  Values are drawn on the CPU and copied, so one seed gives the same
weights on every device.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def _uniform_(p: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    v = torch.empty(p.shape, dtype=torch.float32)
    v.uniform_(-bound, bound, generator=generator)
    p.copy_(v)


@torch.no_grad()
def torch_conv_init_(conv: nn.modules.conv._ConvNd,
                     generator: torch.Generator) -> None:
    """Weight and bias of a Conv{2,3}d, torch-default distributions."""
    w = conv.weight
    fan_in = w.shape[1] * math.prod(w.shape[2:])
    bound = 1.0 / math.sqrt(fan_in)
    _uniform_(w, bound, generator)
    if conv.bias is not None:
        _uniform_(conv.bias, bound, generator)
