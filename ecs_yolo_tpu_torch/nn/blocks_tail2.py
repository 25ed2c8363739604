"""The ResNet stage of the last tail slice (counterpart of
``ecs_yolo_tpu/nn/blocks_tail2.py``): ``ResNetLayerBasic``.
``BasicBlock_ms1`` of that file lives in ``nn/blocks_tail.py``; the rest is
not ported yet (ROADMAP Queue 1 item 11g-3).  Features are ``[T, N, H, W,
C]``; children carry the JAX module names (``stem``, ``b0``, ...)."""

from __future__ import annotations

from torch import nn

from ..config import DEFAULT_SNN, SNNConfig
from .blocks import Conv_1
from .blocks_ext import GhostBottleneck


class ResNetLayerBasic(nn.Module):
    """ResNet stage (reference ResNetLayerBasic): with ``is_first`` the
    ``stem`` (``Conv_1`` 7x7, stride 2, padding 3; k and s unused), else
    ``b0 ... b{n-1}`` (``GhostBottleneck`` k, the stride on ``b0``)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, is_first: bool = False,
                 n: int = 1, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.n = 0 if is_first else n
        self.stem = Conv_1(c1, c2, 7, 2, 3, snn=snn) if is_first else None
        for j in range(self.n):
            self.add_module(f"b{j}", GhostBottleneck(c1 if j == 0 else c2, c2, k,
                                                     s if j == 0 else 1, snn=snn))

    def forward(self, x):
        if self.stem is not None:
            return self.stem(x)
        for j in range(self.n):
            x = getattr(self, f"b{j}")(x)
        return x
