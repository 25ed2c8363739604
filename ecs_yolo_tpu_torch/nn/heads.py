"""The v1 anchor-based detection head (counterpart of
``ecs_yolo_tpu/nn/heads.py:Detect``)."""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from ..config import DEFAULT_SNN, SNNConfig
from ..ops.anchors import make_grid_v1
from .blocks import Conv_7, SnnConv


class Detect(nn.Module):
    """Per level: 1x1 SnnConv -> Conv_7 (learned T-collapse) -> reshape to
    [N, na, ny, nx, no].  Inference decode:
      xy = (sig*2 - 0.5 + grid) * stride ;  wh = (sig*2)^2 * anchor * stride.

    ``anchors`` are in grid units (divided by the stride at build time).
    In training mode the forward returns the per-level raw maps; in eval it
    returns ``(decoded [N, A, no], raw maps)``.
    """

    def __init__(self, nc: int, anchors: Sequence[Sequence[float]],
                 strides: Sequence[float], ch: Sequence[int],
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.nc = nc
        self.no = nc + 5
        self.nl = len(anchors)
        self.na = len(anchors[0]) // 2
        self.anchors = [list(map(float, a)) for a in anchors]
        self.strides = [float(s) for s in strides]
        self.m = nn.ModuleList(
            SnnConv(c, self.no * self.na, 1, bias=True) for c in ch)
        self.w = nn.ModuleList(Conv_7(snn.time_window) for _ in ch)

    def forward(self, xs: Sequence[torch.Tensor]):
        na, no = self.na, self.no
        feats: List[torch.Tensor] = []
        for i, x in enumerate(xs):
            y = self.w[i](self.m[i](x))               # [N, ny, nx, na*no]
            n, ny, nx, _ = y.shape
            # channel index = a*no + o (reference view(bs, na, no, ny, nx))
            feats.append(y.reshape(n, ny, nx, na, no).permute(0, 3, 1, 2, 4))
        if self.training:
            return feats

        z = []
        for i, y in enumerate(feats):
            n, _, ny, nx, _ = y.shape
            stride = self.strides[i]
            grid = make_grid_v1(nx, ny, na, y.dtype, y.device)
            anchor_grid = (torch.tensor(self.anchors[i], device=y.device)
                           * stride).reshape(1, na, 1, 1, 2).to(y.dtype)
            sig = torch.sigmoid(y)
            xy = (sig[..., 0:2] * 2 - 0.5 + grid) * stride
            wh = (sig[..., 2:4] * 2) ** 2 * anchor_grid
            out = torch.cat([xy, wh, sig[..., 4:]], dim=-1)
            z.append(out.reshape(n, -1, no))
        return torch.cat(z, dim=1), feats
