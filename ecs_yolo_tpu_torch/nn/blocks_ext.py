"""The part of the extended block library the ASFF heads use (counterpart of
``ecs_yolo_tpu/nn/blocks_ext.py``: ``interpolate_nearest``, ``GSConv``,
``ASFF2``).  The rest of that file is not ported yet (ROADMAP Queue 1 item
11).  Features are ``[T, N, H, W, C]``; the channel axis is the last.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..config import DEFAULT_SNN, SNNConfig
from .blocks import Conv_3, Conv_4, SnnConv


def interpolate_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsample of the two spatial axes by ``factor``."""
    return x.repeat_interleave(factor, dim=-3).repeat_interleave(factor, dim=-2)


class GSConv(nn.Module):
    """Half-channel conv + depthwise 5x5 with a channel shuffle (reference
    GSConv at the 1x1, stride 1 that ASFF2 builds): ``cv1`` (Conv_3 to
    ``c2 // 2``), ``cv2`` (Conv_4 5x5, one group a channel), concatenated,
    then the even channels before the odd ones."""

    def __init__(self, c1: int, c2: int, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv_3(c1, c_, 1, 1, snn=snn)
        self.cv2 = Conv_4(c_, c_, 5, 1, g=c_, snn=snn)

    def forward(self, x):
        y1 = self.cv1(x)
        y = torch.cat([y1, self.cv2(y1)], dim=-1)
        return torch.cat([y[..., 0::2], y[..., 1::2]], dim=-1)


class ASFF2(nn.Module):
    """Adaptive fusion of two pyramid levels (reference ASFF2).  The input is
    ``[x0, x1]``, x0 the deeper (smaller, ``c0`` channels), x1 the shallower
    (twice the side, ``c1`` channels); ``level`` 0 fuses at x0's resolution
    and width, 1 at x1's.  Per-pixel weights of the two come from a softmax
    over a 1x1 conv of two ``GSConv`` summaries."""

    def __init__(self, level: int, c0: int, c1: int, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.level = level
        inter = c0 if level == 0 else c1
        if level == 0:
            self.stride1 = Conv_3(c1, inter, 3, 2, snn=snn)
        else:
            self.compress0 = Conv_3(c0, inter, 1, 1, snn=snn)
        cc = 16
        self.w0 = GSConv(inter, cc, snn=snn)
        self.w1 = GSConv(inter, cc, snn=snn)
        self.wl = SnnConv(2 * cc, 2, 1, bias=True)
        self.expand = Conv_4(inter, inter, 3, 1, snn=snn)

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        x0, x1 = xs
        if self.level == 0:
            r0, r1 = x0, self.stride1(x1)
        else:
            r0, r1 = interpolate_nearest(self.compress0(x0), 2), x1
        wts = self.wl(torch.cat([self.w0(r0), self.w1(r1)], dim=-1))
        wts = torch.softmax(wts, dim=-1)
        return self.expand(r0 * wts[..., 0:1] + r1 * wts[..., 1:2])
