"""Parameter initializers matching PyTorch's defaults, drawn from an explicit
``torch.Generator`` (counterpart of ``ecs_yolo_tpu/nn/initializers.py``).

A conv weight and its bias both draw from ``U(-1/sqrt(fan_in),
1/sqrt(fan_in))``: ``kaiming_uniform_(a=sqrt(5))`` gives that bound for the
weight.  A linear layer and a 1-D conv take flax's ``Dense`` / ``Conv``
defaults, the JAX package's initializer for its transformer layers and
``ELA``: ``lecun_normal`` (a normal of variance ``1 / fan_in`` truncated at
two standard deviations) for the weight, zeros for the bias.  ``normal_init_``
is flax's ``normal(std)``, ``trunc_normal_init_`` its ``truncated_normal(std)``
(a normal of ``std`` cut at two of them, not rescaled) and
``uniform_init_`` a ``U(-bound, bound)`` (flax's ``variance_scaling(s,
"fan_in", "uniform")`` has the bound ``sqrt(3 s / fan_in)``).  Values are
drawn on the CPU and copied, so one seed gives the same weights on every
device.
"""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def uniform_init_(p: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    """``p`` from ``U(-bound, bound)``."""
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
    uniform_init_(w, bound, generator)
    if conv.bias is not None:
        uniform_init_(conv.bias, bound, generator)


@torch.no_grad()
def normal_init_(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """``p`` from a normal of mean 0 and ``std`` (flax ``normal(std)``)."""
    if p.is_meta:           # holds no values: nothing to draw
        return
    v = torch.empty(p.shape, dtype=torch.float32)
    v.normal_(0.0, std, generator=generator)
    p.copy_(v)


@torch.no_grad()
def trunc_normal_init_(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """``p`` from a normal of mean 0 and ``std`` cut at ``+-2 std`` (flax
    ``truncated_normal(std)``)."""
    if p.is_meta:           # holds no values: nothing to draw
        return
    v = torch.empty(p.shape, dtype=torch.float32)
    nn.init.trunc_normal_(v, 0.0, std, -2 * std, 2 * std, generator=generator)
    p.copy_(v)


@torch.no_grad()
def lecun_normal_init_(layer: nn.Module, generator: torch.Generator) -> None:
    """Weight and bias of an ``nn.Linear`` or ``nn.Conv1d`` as flax ``Dense``
    / ``Conv`` initialise them by default: a truncated-normal
    ``lecun_normal`` weight (fan-in: every weight dim but the output's),
    zero bias."""
    w = layer.weight
    if w.is_meta:           # holds no values: nothing to draw
        return
    fan_in = math.prod(w.shape[1:])
    trunc_normal_init_(w, math.sqrt(1.0 / fan_in) / 0.87962566103423978,  # flax's factor
                       generator)
    if layer.bias is not None:
        layer.bias.zero_()
