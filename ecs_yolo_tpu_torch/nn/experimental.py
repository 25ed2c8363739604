"""The experimental blocks (counterpart of ``ecs_yolo_tpu/nn/experimental.py``):
``CrossConv``, ``Sum`` and ``MixConv2d``.  Features are ``[T, N, H, W, C]``;
children carry the JAX module names (``cv1``, ``cv2``, ``m0``, ``bn``), and
``Sum``'s optional weight is the parameter ``w``, as in JAX."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import DEFAULT_SNN, SNNConfig
from .blocks import Conv, SnnConv, TBatchNorm


class CrossConv(nn.Module):
    """Cross-convolution (reference CrossConv): ``cv1`` (``Conv`` (1, k),
    stride (1, s), to ``c2 * e``) then ``cv2`` (``Conv`` (k, 1), stride (s,
    1), g groups), plus the input when ``shortcut`` and ``c1 == c2``."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1,
                 e: float = 1.0, shortcut: bool = False, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c_ = int(c2 * e)
        self.add = bool(shortcut) and c1 == c2
        self.cv1 = Conv(c1, c_, (1, k), (1, s), snn=snn)
        self.cv2 = Conv(c_, c2, (k, 1), (s, 1), g=g, snn=snn)

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class Sum(nn.Module):
    """The sum of ``n`` inputs (reference Sum); with ``weight`` each input
    after the first is scaled by ``2 * sigmoid(w[i])``, ``w`` initialised to
    ``-arange(1, n) / 2`` (``models/yolo.init_weights``).  No ``snn``, as
    in JAX."""

    def __init__(self, n: int, weight: bool = False):
        super().__init__()
        self.n = n
        self.w = nn.Parameter(-torch.arange(1.0, n) / 2) if weight else None

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        y = xs[0]
        gains = None if self.w is None else torch.sigmoid(self.w) * 2
        for i in range(self.n - 1):
            y = y + (xs[i + 1] if gains is None else xs[i + 1] * gains[i].to(y.dtype))
        return y


class MixConv2d(nn.Module):
    """Mixed-kernel convolution (reference MixConv2d, equal-channels
    strategy): output channel j goes to group ``floor(linspace(0, n - 1e-6,
    c2))[j]`` of the ``n`` kernel sizes; group i is ``m{i}``, a k_i x k_i
    conv (stride s, padding k_i // 2) of the whole input to its ``cg``
    channels in ``gcd(c1, cg)`` groups (an empty group is skipped and keeps
    its index); the groups concatenated, then ``bn`` and SiLU."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (1, 3), s: int = 1,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        k = tuple(k)
        idx = np.floor(np.linspace(0, len(k) - 1e-6, c2)).astype(int)
        self.groups = []
        for gi, kk in enumerate(k):
            cg = int((idx == gi).sum())
            if cg:
                self.add_module(f"m{gi}", SnnConv(c1, cg, kk, s, kk // 2,
                                                  g=math.gcd(c1, cg)))
                self.groups.append(f"m{gi}")
        self.bn = TBatchNorm(c2, 1.0, snn)

    def forward(self, x):
        y = torch.cat([getattr(self, g)(x) for g in self.groups], dim=-1)
        return F.silu(self.bn(y))
