"""Parameter initializers matching PyTorch's defaults, drawn from an explicit
``torch.Generator`` (counterpart of ``ecs_yolo_tpu/nn/initializers.py``).

A conv weight and its bias both draw from ``U(-1/sqrt(fan_in),
1/sqrt(fan_in))``: ``kaiming_uniform_(a=sqrt(5))`` gives that bound for the
weight.  A linear layer takes flax's ``Dense`` defaults, the JAX package's
initializer for its transformer layers: ``lecun_normal`` (a normal of
variance ``1 / fan_in`` truncated at two standard deviations) for the
weight, zeros for the bias.  Values are drawn on the CPU and copied, so one
seed gives the same weights on every device.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def _uniform_(p: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    if p.is_meta:           # holds no values: nothing to draw
        return
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


@torch.no_grad()
def lecun_linear_init_(linear: nn.Linear, generator: torch.Generator) -> None:
    """Weight and bias of an ``nn.Linear`` as flax ``Dense`` initialises
    them: truncated-normal ``lecun_normal`` weight, zero bias."""
    w = linear.weight
    if w.is_meta:           # holds no values: nothing to draw
        return
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978   # flax's truncation factor
    v = torch.empty(w.shape, dtype=torch.float32)
    nn.init.trunc_normal_(v, 0.0, std, -2 * std, 2 * std, generator=generator)
    w.copy_(v)
    if linear.bias is not None:
        linear.bias.zero_()
