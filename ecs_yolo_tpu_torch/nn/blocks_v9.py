"""The YOLOv9 GELAN blocks and the CSP hybrids of the EMS residuals
(counterpart of ``ecs_yolo_tpu/nn/blocks_v9.py``): ``RepConvN``,
``RepNBottleneck``, ``RepNCSP``, ``RepNCSPELAN4``; ``BasicBlock_2C3``,
``BasicBlock_1C3`` and ``Concat_res2C3``.

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


class RepConvN(nn.Module):
    """Rep-style double branch with a spiking pre-activation (reference
    RepConvN): the neuron ``m``, then ``conv1`` (3x3, stride s, g groups)
    -> ``bn1`` plus ``conv2`` (1x1, stride s, g groups) -> ``bn2``.  ``k``
    is the JAX block's field, unused there too."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.m = MemUpdate(c1, snn=snn)
        self.conv1 = SnnConv(c1, c2, 3, s, 1, g=g)
        self.bn1 = TBatchNorm(c2, 1.0, snn)
        self.conv2 = SnnConv(c1, c2, 1, s, 0, g=g)
        self.bn2 = TBatchNorm(c2, 1.0, snn)

    def forward(self, x):
        y = self.m(x)
        return self.bn1(self.conv1(y)) + self.bn2(self.conv2(y))


class RepNBottleneck(nn.Module):
    """``cv1`` (``RepConvN`` to ``c2 * e``) -> ``cv2`` (3x3 ``Conv_3``, g
    groups), plus the input when ``shortcut`` and ``c1 == c2`` (reference
    RepNBottleneck)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, e: float = 0.5,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c_ = int(c2 * e)
        self.add = bool(shortcut) and c1 == c2
        self.cv1 = RepConvN(c1, c_, 3, 1, snn=snn)
        self.cv2 = Conv_3(c_, c2, 3, 1, g=g, snn=snn)

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class RepNCSP(nn.Module):
    """CSP over ``RepNBottleneck`` (reference RepNCSP): ``cv1`` (1x1
    ``Conv_3`` to ``c2 * e``) -> ``m0 ... m{n-1}`` (``e=1``), beside ``cv2``
    (1x1 ``Conv_3``); concatenated, then ``cv3_act`` -> ``cv3_conv`` (1x1
    with bias) -> ``cv3_bn``.  The YAML's repeat count is ``n``."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        self.cv1 = Conv_3(c1, c_, 1, 1, snn=snn)
        for i in range(n):
            self.add_module(f"m{i}", RepNBottleneck(c_, c_, shortcut, g, 1.0, snn=snn))
        self.cv2 = Conv_3(c1, c_, 1, 1, snn=snn)
        self.cv3_act = MemUpdate(2 * c_, snn=snn)
        self.cv3_conv = SnnConv(2 * c_, c2, 1, bias=True)
        self.cv3_bn = TBatchNorm(c2, 1.0, snn)

    def forward(self, x):
        y1 = self.cv1(x)
        for i in range(self.n):
            y1 = getattr(self, f"m{i}")(y1)
        y = torch.cat([y1, self.cv2(x)], dim=-1)
        return self.cv3_bn(self.cv3_conv(self.cv3_act(y)))


class RepNCSPELAN4(nn.Module):
    """YOLOv9 GELAN block (reference RepNCSPELAN4): ``cv1`` (1x1 ``Conv_3``
    to c3) split in halves; ``csp0`` (``RepNCSP`` to c4, ``c5`` inners) ->
    ``conv0`` (3x3 ``Conv_3``) on the second half, ``csp1`` -> ``conv1`` on
    that; the four pieces concatenated, then ``cv4`` (1x1 ``Conv_3`` to
    c2).  As in ``C2f``, ``csp0`` takes a dense copy of the second half,
    whose strided view the tensor-core kernel's layout check would send to
    ``ecs_lif_fused_rows``; the concat reads ``cv1``'s output whole in place
    of its two halves."""

    def __init__(self, c1: int, c2: int, c3: int = 128, c4: int = 64, c5: int = 1,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.half = c3 // 2
        self.cv1 = Conv_3(c1, c3, 1, 1, snn=snn)
        self.csp0 = RepNCSP(c3 - self.half, c4, c5, snn=snn)
        self.conv0 = Conv_3(c4, c4, 3, 1, snn=snn)
        self.csp1 = RepNCSP(c4, c4, c5, snn=snn)
        self.conv1 = Conv_3(c4, c4, 3, 1, snn=snn)
        self.cv4 = Conv_3(c3 + 2 * c4, c2, 1, 1, snn=snn)

    def forward(self, x):
        y = self.cv1(x)
        b0 = self.conv0(self.csp0(y[..., self.half:].contiguous()))
        b1 = self.conv1(self.csp1(b0))
        return self.cv4(torch.cat([y, b0, b1], dim=-1))


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
