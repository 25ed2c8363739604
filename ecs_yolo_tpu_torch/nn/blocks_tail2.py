"""The ResNet stage and the deformable conv of the last tail slice
(counterpart of ``ecs_yolo_tpu/nn/blocks_tail2.py``): ``ResNetLayerBasic``
and ``AKConv``.  ``BasicBlock_ms1`` of that file lives in
``nn/blocks_tail.py``; the rest is not ported yet (ROADMAP Queue 1 item
11g-3).  Features are ``[T, N, H, W, C]``; children carry the JAX module
names (``stem``, ``b0``, ``p_conv``, ...)."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..config import DEFAULT_SNN, SNNConfig
from .blocks import Conv_1, MemUpdate, SnnConv, TBatchNorm
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


class OffsetConv(SnnConv):
    """``AKConv``'s offset predictor: an ``SnnConv`` whose weight starts at
    zero (JAX's ``kernel_init=zeros``; ``models/yolo.init_weights`` zeroes
    it after drawing the bias)."""


def _clip(v: torch.Tensor, hi: int) -> torch.Tensor:
    """``jnp.clip(v, 0, hi)`` with JAX's gradient: ``maximum`` / ``minimum``
    against a tensor bound split a tie's gradient in two (``torch.clamp``
    would pass all of it), so a position on a bound gets half."""
    return torch.minimum(torch.maximum(v, v.new_zeros(())), v.new_full((), hi))


class AKConv(nn.Module):
    """Arbitrary-kernel deformable conv (reference AKConv): ``p_conv`` (3x3,
    stride s, bias, zero weight at init) predicts a (y, x) offset for each
    of ``num_param`` sampling points, whose base pattern is row-major in
    rows of ``round(sqrt(num_param))`` (point i at ``(i // base, i %
    base)``); the offsets' gradient is scaled by 0.1 (``0.1 * o + 0.9 *
    o.detach()``, as JAX).  Each point, at its output pixel times s plus
    its base plus its offset, clipped to the map (``_clip``), is sampled
    bilinearly from the input by four gathers over ``[T, N, H*W, C]``
    around its floor (of the detached position; on the card the gathers'
    backward is a scatter-add in no fixed order).  The samples, stacked
    along H into ``[T, N, Ho * num_param, Wo, C]``, go through ``m`` (a
    neuron site of ``Ho * num_param`` rows), ``conv`` (``(num_param, 1)``
    kernel and stride) and ``bn``.

    Positions are float32 at least (float64 in float64), as JAX's float32
    grid promotes them; the samples are cast back to the input's dtype
    before the neuron."""

    def __init__(self, c1: int, c2: int, num_param: int = 5, s: int = 1,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.num_param, self.s = num_param, s
        self.p_conv = OffsetConv(c1, 2 * num_param, 3, s, 1, bias=True)
        self.m = MemUpdate(c1, snn=snn)
        self.conv = SnnConv(c1, c2, (num_param, 1), (num_param, 1), 0)
        self.bn = TBatchNorm(c2, 1.0, snn)

    def forward(self, x):
        t, n, h, w, c1 = x.shape
        np_, s = self.num_param, self.s
        offset = self.p_conv(x)                                  # [t, n, ho, wo, 2 np]
        ho, wo = offset.shape[2], offset.shape[3]
        off_y, off_x = offset[..., :np_], offset[..., np_:]
        off_y = 0.1 * off_y + 0.9 * off_y.detach()
        off_x = 0.1 * off_x + 0.9 * off_x.detach()

        f32 = torch.float32
        i = torch.arange(np_, device=x.device)
        base = round(math.sqrt(np_))
        gy = torch.arange(ho, dtype=f32, device=x.device)[:, None, None] * s
        gx = torch.arange(wo, dtype=f32, device=x.device)[None, :, None] * s
        py = _clip(gy + (i // base).to(f32) + off_y, h - 1)     # [t, n, ho, wo, np]
        px = _clip(gx + (i % base).to(f32) + off_x, w - 1)

        y0, x0 = torch.floor(py.detach()), torch.floor(px.detach())
        y0c, y1c = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
        x0c, x1c = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
        flat = x.reshape(t, n, h * w, c1)

        def gather(yy, xx):
            idx = (yy * w + xx).long().reshape(t, n, -1, 1).expand(-1, -1, -1, c1)
            return torch.gather(flat, 2, idx).reshape(t, n, ho, wo, np_, c1)

        g_lt = (1 + (y0c - py)) * (1 + (x0c - px))
        g_rb = (1 - (y1c - py)) * (1 - (x1c - px))
        g_lb = (1 + (y0c - py)) * (1 - (x1c - px))
        g_rt = (1 - (y1c - py)) * (1 + (x0c - px))
        samp = (g_lt[..., None] * gather(y0c, x0c) + g_rb[..., None] * gather(y1c, x1c)
                + g_lb[..., None] * gather(y0c, x1c) + g_rt[..., None] * gather(y1c, x0c))
        samp = samp.permute(0, 1, 2, 4, 3, 5).reshape(t, n, ho * np_, wo, c1)
        return self.bn(self.conv(self.m(samp.to(x.dtype))))
