"""The EE residuals of the long-tail block library (counterpart of
``ecs_yolo_tpu/nn/blocks_tail.py``: ``BasicBlock_ms``, ``ConcatBlock_ms``;
and of ``nn/blocks_tail2.py``: ``BasicBlock_ms1``).  The rest of those files
is not ported yet (ROADMAP Queue 1 item 11).

Features are ``[T, N, H, W, C]``.  The JAX blocks build their stacks with
``_Seq`` rows named ``0``, ``1``, ...; here they are an ``nn.Sequential``,
whose children carry the same names, so the JAX leaf
``res/3/spread_dw_kernel`` is the torch ``res.3.spread.0.weight`` and
``models/convert.py`` maps the tree path for path.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import DEFAULT_SNN, SNNConfig
from .blocks import MemUpdate, SnnConv, TBatchNorm, max_pool_t


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
