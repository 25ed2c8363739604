"""The EE residuals, the context-guided fusion and the HGNet stage of the
long-tail block library (counterpart of ``ecs_yolo_tpu/nn/blocks_tail.py``:
``BasicBlock_ms``, ``ConcatBlock_ms``, ``ELA``, ``ContextGuideFusionModule``,
``HGBlock``; and of ``nn/blocks_tail2.py``: ``BasicBlock_ms1``).  The rest
of those files is not ported yet (ROADMAP Queue 1 items 11g-2 and 11g-3).

Features are ``[T, N, H, W, C]``.  The JAX blocks build their stacks with
``_Seq`` rows named ``0``, ``1``, ...; here they are an ``nn.Sequential``,
whose children carry the same names, so the JAX leaf
``res/3/spread_dw_kernel`` is the torch ``res.3.spread.0.weight`` and
``models/convert.py`` maps the tree path for path.  ``ELA``'s flax 1-D conv
is an ``nn.Conv1d`` (``se.conv1d``), whose ``[k, 1, C]`` kernel the
converter turns into ``[C, 1, k]``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..config import DEFAULT_SNN, SNNConfig
from .blocks import Conv_3, Conv_4, MemUpdate, SnnConv, TBatchNorm, max_pool_t
from .blocks_ext import DWConv, LightConv


def _mcb(c1: int, c2: int, k: int = 3, s: int = 1, bn_scale: float = 1.0,
         snn: SNNConfig = DEFAULT_SNN):
    """mem_update -> conv (padding 1 for a 3x3, else 0) -> BN (gamma
    ``bn_scale * thresh``): three rows of a JAX ``_Seq``."""
    pad = 1 if k == 3 else 0
    return [MemUpdate(c1, snn=snn), SnnConv(c1, c2, k, s, pad),
            TBatchNorm(c2, bn_scale, snn)]


def _ms_residual(c1: int, c2: int, k: int, s: int, e: float,
                 snn: SNNConfig) -> nn.Sequential:
    c_ = int(c2 * e)
    return nn.Sequential(*_mcb(c1, c_, k, s, snn=snn),
                         *_mcb(c_, c2, k, 1, bn_scale=0.2, snn=snn))


class BasicBlock_ms(nn.Module):
    """Half-width hidden residual (reference BasicBlock_ms): ``res`` =
    (mem_update -> conv -> BN) to ``c2 * e`` channels at stride s, then to
    c2 (gamma 0.2 * thresh); shortcut = identity, or MaxPool(1,s,s) ->
    ``sc_conv`` (1x1) -> ``sc_bn`` when ``s != 1`` or ``c1 != c2`` (no
    neuron in the shortcut)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, e: float = 0.5,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.s = s
        self.res = _ms_residual(c1, c2, k, s, e, snn)
        self.sc_conv = self.sc_bn = None
        if s != 1 or c1 != c2:
            self.sc_conv = SnnConv(c1, c2, 1, 1)
            self.sc_bn = TBatchNorm(c2, 1.0, snn)

    def forward(self, x):
        y = self.res(x)
        if self.sc_conv is None:
            return y + x
        return y + self.sc_bn(self.sc_conv(max_pool_t(x, self.s)))


class ConcatBlock_ms(nn.Module):
    """``BasicBlock_ms``'s residual with a concatenating shortcut (reference
    ConcatBlock_ms): the shortcut is ``x``, or ``cat([sc(x), x])`` when
    ``c1 < c2`` (``sc`` = mem_update -> 1x1 conv to ``c2 - c1`` -> BN),
    max-pooled by s and added to the residual.  It has no shortcut conv of
    its own."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, e: float = 0.5,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.s = s
        self.res = _ms_residual(c1, c2, k, s, e, snn)
        self.sc = nn.Sequential(*_mcb(c1, c2 - c1, 1, 1, snn=snn)) if c1 < c2 else None

    def forward(self, x):
        y = self.res(x)
        sc = x if self.sc is None else torch.cat([self.sc(x), x], dim=-1)
        return y + max_pool_t(sc, self.s)


class BasicBlock_ms1(BasicBlock_ms):
    """Alias of BasicBlock_ms.  The reference declares BasicBlock_ms1 as an
    EMPTY stub (models/common.py:2598-2600), so res18-eebk.yaml cannot build
    there; aliasing the working _ms block makes the config functional here
    (documented deviation, as in ``ecs_yolo_tpu/nn/blocks_tail2.py``)."""


class ELA(nn.Module):
    """Efficient local attention (reference ELA): the input's H profile (mean
    over W) and W profile (mean over H), each through the one depthwise 1-D
    ``conv1d`` (k, padding k // 2, no bias) and the one group norm
    (``min(16, C)`` groups of contiguous channels, population variance, eps
    1e-5, ``gn_scale`` / ``gn_bias``), a sigmoid each; the input times both
    gates.  The arithmetic runs in the input's dtype, as in JAX."""

    def __init__(self, c: int, k: int = 7):
        super().__init__()
        self.conv1d = nn.Conv1d(c, c, k, padding=k // 2, groups=c, bias=False)
        self.gn_scale = nn.Parameter(torch.ones(c))
        self.gn_bias = nn.Parameter(torch.zeros(c))

    def _attend(self, p: torch.Tensor) -> torch.Tensor:
        """``[B, L, C]`` profile -> ``[B, L, C]`` gate."""
        b, length, c = p.shape
        y = self.conv1d(p.transpose(1, 2)).transpose(1, 2)
        groups = min(16, c)
        yg = y.reshape(b, length, groups, c // groups)
        mean = yg.mean(dim=(1, 3), keepdim=True)
        var = yg.var(dim=(1, 3), unbiased=False, keepdim=True)
        yg = (yg - mean) / torch.sqrt(var + 1e-5)
        y = yg.reshape(b, length, c) * self.gn_scale.to(y.dtype) + self.gn_bias.to(y.dtype)
        return torch.sigmoid(y)

    def forward(self, x):
        t, n, h, w, c = x.shape
        x_h = self._attend(x.mean(dim=3).reshape(t * n, h, c)).reshape(t, n, h, 1, c)
        x_w = self._attend(x.mean(dim=2).reshape(t * n, w, c)).reshape(t, n, 1, w, c)
        return x * x_h * x_w


class ContextGuideFusionModule(nn.Module):
    """Cross-gated fusion of two inputs (reference
    ContextGuideFusionModule): ``x0`` through ``adjust`` (1x1 with bias)
    when its width differs from ``x1``'s; ``se`` (``ELA``) of ``cat([x0,
    x1])`` is the reweighted pair ``(w0, w1)``, not a gate; the output is
    ``cat([x0 + x1 * w1, x1 + x0 * w0])``.  ``c1`` is the two inputs'
    widths; ``dim`` is the JAX block's positional YAML slot, unused."""

    def __init__(self, c1: Sequence[int], dim=None, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c0, c = c1
        self.adjust = SnnConv(c0, c, 1, bias=True) if c0 != c else None
        self.se = ELA(2 * c)

    def forward(self, xs):
        x0, x1 = xs
        if self.adjust is not None:
            x0 = self.adjust(x0)
        w0, w1 = self.se(torch.cat([x0, x1], dim=-1)).chunk(2, dim=-1)
        return torch.cat([x0 + x1 * w1, x1 + x0 * w0], dim=-1)


class HGBlock(nn.Module):
    """HGNetV2 stage (reference HGBlock): at ``s == 2`` a ``DWConv`` ``dw``
    (k, stride 2, keeping the width) first; ``m0 ... m{n-1}`` (``LightConv``
    with ``lightconv``, else ``Conv_3``; k, to ``cm``) chained, the input
    and every stage concatenated; ``sc`` (1x1 ``Conv_3`` to ``c2 // 2``) ->
    ``ec`` (1x1 ``Conv_4`` to c2), plus the input with ``shortcut`` when the
    widths agree.  ``parse_model`` passes ``cm`` and ``c2`` unscaled and
    puts a YAML repeat count at ``n``."""

    def __init__(self, c1: int, cm: int, c2: int, k: int = 3, n: int = 6, s: int = 1,
                 lightconv: bool = False, shortcut: bool = False,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.n = n
        self.dw = DWConv(c1, c1, k, 2, snn=snn) if s == 2 else None
        for i in range(n):
            ci = c1 if i == 0 else cm
            self.add_module(f"m{i}", LightConv(ci, cm, k, snn=snn) if lightconv
                            else Conv_3(ci, cm, k, 1, snn=snn))
        self.sc = Conv_3(c1 + n * cm, c2 // 2, 1, 1, snn=snn)
        self.ec = Conv_4(c2 // 2, c2, 1, 1, snn=snn)
        self.add = bool(shortcut) and c1 == c2

    def forward(self, x):
        if self.dw is not None:
            x = self.dw(x)
        ys = [x]
        for i in range(self.n):
            ys.append(getattr(self, f"m{i}")(ys[-1]))
        y = self.ec(self.sc(torch.cat(ys, dim=-1)))
        return y + x if self.add else y
