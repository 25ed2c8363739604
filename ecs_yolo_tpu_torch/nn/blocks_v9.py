"""The CSP hybrids of the EMS residuals (counterpart of
``ecs_yolo_tpu/nn/blocks_v9.py``): ``BasicBlock_2C3``, ``BasicBlock_1C3``
and ``Concat_res2C3``.  The RepN / ELAN blocks of that file are not ported
yet (ROADMAP Queue 1 item 11g).

Features are ``[T, N, H, W, C]``.  The inner blocks ``m0``, ``m1``, ... are
the port's ``BasicBlock_2`` / ``BasicBlock_1`` / ``Concat_res2``, whose
children carry the reference's names (``residual_function.N``,
``shortcut.N``); ``models/convert.py`` maps a JAX leaf
``m0/conv1/conv/kernel`` through that block's own name map.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import DEFAULT_SNN, SNNConfig
from .blocks import (BasicBlock_1, BasicBlock_2, Concat_res2, Conv_3, Conv_4, MemUpdate,
                     SnnConv, TBatchNorm)


class _CSP(nn.Module):
    """``cv1`` -> ``m0 ... m{n-1}``, beside ``cv2`` of the input,
    concatenated, then ``cv3``."""

    def forward(self, x):
        y1 = self.cv1(x)
        for i in range(self.n):
            y1 = getattr(self, f"m{i}")(y1)
        return self.cv3(torch.cat([y1, self.cv2(x)], dim=-1))


class BasicBlock_2C3(_CSP):
    """CSP over ``BasicBlock_2`` (reference BasicBlock_2C3): at ``s == 2``
    ``dw_act`` -> ``dw_conv`` (k, stride 2, padding 1, keeping the width; a
    dense conv, despite its name) -> ``dw_bn`` first; ``cv1`` / ``cv2`` (1x1
    ``Conv_3`` to ``c2 * e``), ``m{i}`` ``BasicBlock_2(k, 1)``, ``cv3``
    (1x1 ``Conv_4``).  The YAML's repeat count is ``n``."""

    def __init__(self, c1: int, c2: int, n: int = 1, k: int = 3, s: int = 1,
                 e: float = 0.5, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        self.dw_act = self.dw_conv = self.dw_bn = None
        if s == 2:
            self.dw_act = MemUpdate(c1, snn=snn)
            self.dw_conv = SnnConv(c1, c1, k, s, 1)
            self.dw_bn = TBatchNorm(c1, 1.0, snn)
        self.cv1 = Conv_3(c1, c_, 1, 1, snn=snn)
        for i in range(n):
            self.add_module(f"m{i}", BasicBlock_2(c_, c_, k, 1, snn=snn))
        self.cv2 = Conv_3(c1, c_, 1, 1, snn=snn)
        self.cv3 = Conv_4(2 * c_, c2, 1, snn=snn)

    def forward(self, x):
        if self.dw_act is not None:
            x = self.dw_bn(self.dw_conv(self.dw_act(x)))
        return super().forward(x)


class BasicBlock_1C3(_CSP):
    """CSP over ``BasicBlock_1`` (reference BasicBlock_1C3): ``cv1`` (1x1
    ``Conv_3`` to ``c2 * e``) -> ``m{i}`` ``BasicBlock_1(s)``, beside
    ``cv2`` (1x1 ``Conv_3``, stride s: it carries the stride), then ``cv3``
    (1x1 ``Conv_3``).  The YAML's repeat count is ``n``."""

    def __init__(self, c1: int, c2: int, n: int = 1, s: int = 1, e: float = 0.5,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        self.cv1 = Conv_3(c1, c_, 1, 1, snn=snn)
        for i in range(n):
            self.add_module(f"m{i}", BasicBlock_1(c_, c_, s, snn=snn))
        self.cv2 = Conv_3(c1, c_, 1, s, snn=snn)
        self.cv3 = Conv_3(2 * c_, c2, 1, 1, snn=snn)


class Concat_res2C3(_CSP):
    """CSP over ``Concat_res2`` (reference Concat_res2C3): ``cv1`` (1x1
    ``Conv_3`` to ``int(int(c2 * e) * e)``) -> ``m{i}`` ``Concat_res2(c2 *
    e, k, s)``, beside ``cv2`` (1x1 ``Conv_3`` to ``c2 * e``, stride s),
    then ``cv3`` (1x1 ``Conv_3``).  The YAML's repeat count is ``n``."""

    def __init__(self, c1: int, c2: int, n: int = 1, k: int = 3, s: int = 1,
                 e: float = 0.5, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        self.cv1 = Conv_3(c1, int(c_ * e), 1, 1, snn=snn)
        for i in range(n):
            self.add_module(f"m{i}", Concat_res2(int(c_ * e) if i == 0 else c_, c_, k, s,
                                                 snn=snn))
        self.cv2 = Conv_3(c1, c_, 1, s, snn=snn)
        self.cv3 = Conv_3(2 * c_, c2, 1, 1, snn=snn)
