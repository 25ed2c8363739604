"""The StarNet blocks (counterpart of ``ecs_yolo_tpu/nn/blocks_star.py``,
every block of it): ``StarBlock``, ``StarBlock_1s``, ``StarBlock_1``,
``StarBlock_3``, ``ClippedTPReLU``, ``StarBlock_4``, ``StarBlock_5``,
``StarSConv``, ``MStarBlock``, ``MStarBlock_2`` and ``StarBlock_2C2f``.
``StarBlock_2`` and ``DropPath`` live in ``nn/blocks_ext.py``, as in JAX.

Features are ``[T, N, H, W, C]``.  Children carry the JAX module names
(``f1_act``, ``f1_conv``, ``dw2_bn``, ``act``, ``cv``, ``m0``, ...), so
``models/convert.py`` maps the tree path for path.  ``F.relu6`` is a
hardtanh, whose gradient is 0 at 0 and 6, as ``jax.nn.relu6``'s.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DEFAULT_SNN, SNNConfig
from .blocks import (Conv_1, Conv_3, Conv_4, DepthWiseConv, MemUpdate, Shortcut, SnnConv,
                     TBatchNorm, max_pool_t)
from .blocks_ext import DropPath, StarBlock_2, _C2fFrame
from .blocks_tail2 import TPReLU


def _add_tag(block: nn.Module, tag: str, c1: int, c2: int, k, s: int, p, g: int,
             gamma: float, snn: SNNConfig, bias: bool = False) -> None:
    """The children ``{tag}_act`` (mem_update), ``{tag}_conv`` and
    ``{tag}_bn`` (gamma ``gamma * thresh``) of ``block``."""
    block.add_module(f"{tag}_act", MemUpdate(c1, snn=snn))
    block.add_module(f"{tag}_conv", SnnConv(c1, c2, k, s, p, g, bias=bias))
    block.add_module(f"{tag}_bn", TBatchNorm(c2, gamma, snn))


def _run_tag(block: nn.Module, tag: str, x):
    """``{tag}_bn({tag}_conv({tag}_act(x)))``."""
    for suffix in ("act", "conv", "bn"):
        x = getattr(block, f"{tag}_{suffix}")(x)
    return x


class _Shortcuts:
    """The star blocks' two residuals, both on the children ``sc_act`` ->
    ``sc_conv`` (1x1) -> ``sc_bn``: the pooled one (the input, or at a
    stride or width change MaxPool(1,s,s) then the 1x1 to c2, with a bias
    where the block's has one) and the concat one (``cat([t, x])`` when
    ``c1 < c2``, t the 1x1 to the ``c2 - c1`` new channels, else x;
    max-pooled by s after the concat)."""

    def _init_pooled(self, c1: int, c2: int, s: int, snn: SNNConfig, bias: bool = False):
        self.s, self.has_sc = s, s != 1 or c1 != c2
        if self.has_sc:
            _add_tag(self, "sc", c1, c2, 1, 1, 0, 1, 1.0, snn, bias)

    def pooled(self, x):
        return _run_tag(self, "sc", max_pool_t(x, self.s)) if self.has_sc else x

    def _init_concat(self, c1: int, c2: int, s: int, snn: SNNConfig):
        self.s, self.has_sc = s, c1 < c2
        if self.has_sc:
            _add_tag(self, "sc", c1, c2 - c1, 1, 1, 0, 1, 1.0, snn)

    def concat(self, x):
        sc = torch.cat([_run_tag(self, "sc", x), x], dim=-1) if self.has_sc else x
        return max_pool_t(sc, self.s)


class StarBlock(nn.Module):
    """Plain StarNet block (reference StarBlock): ``dw`` (``Conv_3`` k,
    stride s, to c2), then on that ``dwconv`` (``Conv_1`` 7x7 depthwise),
    ``f1`` / ``f2`` (``Conv_1`` 1x1 to ``mlp_ratio * c2``), ``relu6(f1) *
    f2``, ``g`` (``Conv_1`` 1x1 to c2), ``dwconv2`` (``Conv_1`` 7x7
    depthwise) and ``drop``, plus ``dw``'s output."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, mlp_ratio: int = 3,
                 drop_path: float = 0.0, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.dw = Conv_3(c1, c2, k, s, snn=snn)
        self.dwconv = Conv_1(c2, c2, 7, 1, 3, g=c2, snn=snn)
        self.f1 = Conv_1(c2, mlp_ratio * c2, 1, 1, snn=snn)
        self.f2 = Conv_1(c2, mlp_ratio * c2, 1, 1, snn=snn)
        self.g = Conv_1(mlp_ratio * c2, c2, 1, 1, snn=snn)
        self.dwconv2 = Conv_1(c2, c2, 7, 1, 3, g=c2, snn=snn)
        self.drop = DropPath(drop_path)

    def forward(self, x):
        inp = self.dw(x)
        y = self.dwconv(inp)
        y = self.g(F.relu6(self.f1(y)) * self.f2(y))
        return inp + self.drop(self.dwconv2(y))


class StarBlock_1s(_Shortcuts, nn.Module):
    """1x1-expand-first gated block (reference StarBlock_1s): ``dw`` (1x1
    to ``mlp_ratio * c2``, BN), two depthwise k x k / stride s branches
    ``f1`` (BN gamma thresh) and ``f2`` (0.2 * thresh) of it, ``relu6(f1)
    * f2``; ``dw2_act`` -> ``dw2_conv1`` (1x1 to c2, bias) -> ``dw2_conv2``
    (depthwise k) -> ``dw2_bn`` -> ``drop``; plus the pooled shortcut.
    ``add`` is the JAX block's positional YAML slot, unused there too."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, mlp_ratio: int = 3,
                 drop_path: float = 0.0, add: bool = True, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        ch, pad = mlp_ratio * c2, (k - 1) // 2
        _add_tag(self, "dw", c1, ch, 1, 1, 0, 1, 1.0, snn)
        _add_tag(self, "f1", ch, ch, k, s, pad, ch, 1.0, snn)
        _add_tag(self, "f2", ch, ch, k, s, pad, ch, 0.2, snn)
        self.dw2_act = MemUpdate(ch, snn=snn)
        self.dw2_conv1 = SnnConv(ch, c2, 1, 1, bias=True)
        self.dw2_conv2 = SnnConv(c2, c2, k, 1, pad, g=c2)
        self.dw2_bn = TBatchNorm(c2, 1.0, snn)
        self.drop = DropPath(drop_path)
        self._init_pooled(c1, c2, s, snn)

    def forward(self, x):
        y = _run_tag(self, "dw", x)
        y = F.relu6(_run_tag(self, "f1", y)) * _run_tag(self, "f2", y)
        y = self.dw2_bn(self.dw2_conv2(self.dw2_conv1(self.dw2_act(y))))
        return self.pooled(x) + self.drop(y)


class _GatedPair(_Shortcuts, nn.Module):
    """``f1`` and ``f2`` (mem_update -> k x k conv, stride s, ``g`` groups ->
    BN, gammas thresh and 0.2 * thresh) of the input, ``gate(f1) * f2``,
    then ``dw2`` (mem_update -> k x k conv to c2 -> BN 0.2 * thresh) and
    ``drop``; padding 1 for a 3x3, else 0.  The frame of ``StarBlock_1``
    (``relu6``, 1024 hidden, 2 groups) and ``StarBlock_4`` / ``_5``
    (``act``, a ``ClippedTPReLU``)."""

    def __init__(self, c1: int, c2: int, ch: int, k: int, s: int, g: int,
                 drop_path: float, snn: SNNConfig):
        super().__init__()
        pad = 1 if k == 3 else 0
        _add_tag(self, "f1", c1, ch, k, s, pad, g, 1.0, snn)
        _add_tag(self, "f2", c1, ch, k, s, pad, g, 0.2, snn)
        _add_tag(self, "dw2", ch, c2, k, 1, pad, 1, 0.2, snn)
        self.drop = DropPath(drop_path)

    def gate(self, x1):
        return F.relu6(x1)

    def branches(self, x):
        y = self.gate(_run_tag(self, "f1", x)) * _run_tag(self, "f2", x)
        return self.drop(_run_tag(self, "dw2", y))


class StarBlock_1(_GatedPair):
    """1024-hidden gated block (reference StarBlock_1): ``_GatedPair`` at
    1024 channels in 2 groups, ``relu6`` gate, plus the pooled shortcut."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, drop_path: float = 0.0,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__(c1, c2, 1024, k, s, 2, drop_path, snn)
        self._init_pooled(c1, c2, s, snn)

    def forward(self, x):
        return self.branches(x) + self.pooled(x)


class StarBlock_3(_Shortcuts, nn.Module):
    """``StarBlock_2`` with the concat shortcut (reference StarBlock_3):
    ``dw_act`` -> ``dw`` (depthwise k, stride s) -> ``dw_bn``; ``f1`` /
    ``f2`` (1x1 ``Conv_3`` to ``mlp_ratio * c1``), ``relu6(f1) * f2``;
    ``g`` (1x1 ``Conv_4`` to c2) -> ``dw2_act`` -> ``dw2``
    (``DepthWiseConv`` k) -> ``dw2_bn`` (0.2 * thresh) -> ``drop``; plus the
    concat shortcut."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, mlp_ratio: int = 3,
                 drop_path: float = 0.0, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        p = (k - 1) // 2
        self.dw_act = MemUpdate(c1, snn=snn)
        self.dw = SnnConv(c1, c1, k, s, p, g=c1)
        self.dw_bn = TBatchNorm(c1, 1.0, snn)
        self.f1 = Conv_3(c1, mlp_ratio * c1, 1, 1, snn=snn)
        self.f2 = Conv_3(c1, mlp_ratio * c1, 1, 1, snn=snn)
        self.g = Conv_4(mlp_ratio * c1, c2, 1, 1, snn=snn)
        self.dw2_act = MemUpdate(c2, snn=snn)
        self.dw2 = DepthWiseConv(c2, c2, k, 1, p)
        self.dw2_bn = TBatchNorm(c2, 0.2, snn)
        self.drop = DropPath(drop_path)
        self._init_concat(c1, c2, s, snn)

    def forward(self, x):
        y = self.dw_bn(self.dw(self.dw_act(x)))
        y = self.g(F.relu6(self.f1(y)) * self.f2(y))
        return self.drop(self.dw2_bn(self.dw2(self.dw2_act(y)))) + self.concat(x)


class ClippedTPReLU(TPReLU):
    """``TPReLU`` clipped at 6 (reference ClippedTPReLU): ``minimum(.,
    6)`` of it.  ``torch.minimum`` splits a tie's gradient in halves, as
    ``lax.min`` does; the bound 6 is made on the input's device (a fill,
    no host-to-device copy, so a training step under
    ``set_sync_debug_mode("error")`` passes)."""

    def forward(self, x):
        y = super().forward(x)
        return torch.minimum(y, y.new_full((), 6.0))


class _ClippedPair(_GatedPair):
    """``_GatedPair`` at c2 channels, one group, gated by ``act``
    (``ClippedTPReLU``): the branches of ``StarBlock_4`` / ``_5``.
    ``mlp_ratio`` is the JAX blocks' field, unused there too."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, mlp_ratio: int = 3,
                 drop_path: float = 0.0, snn: SNNConfig = DEFAULT_SNN):
        super().__init__(c1, c2, c2, k, s, 1, drop_path, snn)
        self.act = ClippedTPReLU(c2)

    def gate(self, x1):
        return self.act(x1)


class StarBlock_4(_ClippedPair):
    """Dual-branch star block with the ``ClippedTPReLU`` gate (reference
    StarBlock_4), plus the pooled shortcut (no bias)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, mlp_ratio: int = 3,
                 drop_path: float = 0.0, snn: SNNConfig = DEFAULT_SNN):
        super().__init__(c1, c2, k, s, mlp_ratio, drop_path, snn)
        self._init_pooled(c1, c2, s, snn)

    def forward(self, x):
        return self.pooled(x) + self.branches(x)


class StarBlock_5(_ClippedPair):
    """``StarBlock_4``'s branches with the concat shortcut (reference
    StarBlock_5)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, mlp_ratio: int = 3,
                 drop_path: float = 0.0, snn: SNNConfig = DEFAULT_SNN):
        super().__init__(c1, c2, k, s, mlp_ratio, drop_path, snn)
        self._init_concat(c1, c2, s, snn)

    def forward(self, x):
        return self.concat(x) + self.branches(x)


class StarSConv(_Shortcuts, nn.Module):
    """Separable star conv (reference StarSConv): ``dw`` (1x1 to ``e * c2``,
    BN), two depthwise k x k / stride s branches ``f1`` / ``f2`` (gammas
    thresh and 0.2 * thresh) of it, ``relu6(f1) * f2``; ``dw2_act`` ->
    ``dw2_pw`` (1x1 to c2, bias) -> ``dw2_dw`` (depthwise k) -> ``dw2_bn``
    -> ``drop``; plus the pooled shortcut, its 1x1 with a bias.  Padding 1
    for a 3x3, else 0."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, e: int = 2,
                 drop_path: float = 0.0, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        ce, pad = c2 * e, (1 if k == 3 else 0)
        _add_tag(self, "dw", c1, ce, 1, 1, 0, 1, 1.0, snn)
        _add_tag(self, "f1", ce, ce, k, s, pad, ce, 1.0, snn)
        _add_tag(self, "f2", ce, ce, k, s, pad, ce, 0.2, snn)
        self.dw2_act = MemUpdate(ce, snn=snn)
        self.dw2_pw = SnnConv(ce, c2, 1, 1, bias=True)
        self.dw2_dw = SnnConv(c2, c2, k, 1, pad, g=c2)
        self.dw2_bn = TBatchNorm(c2, 1.0, snn)
        self.drop = DropPath(drop_path)
        self._init_pooled(c1, c2, s, snn, bias=True)

    def forward(self, x):
        y = _run_tag(self, "dw", x)
        y = F.relu6(_run_tag(self, "f1", y)) * _run_tag(self, "f2", y)
        y = self.dw2_bn(self.dw2_dw(self.dw2_pw(self.dw2_act(y))))
        return self.pooled(x) + self.drop(y)


class _MStar(nn.Module):
    """The MobileNet-style star blocks' frame: ``shortcut`` (``Shortcut``
    to c2, stride s) at a stride or width change, else the identity (the
    reference calls a shortcut it builds only at a change; JAX's NOTE), and
    ``conv`` (``StarSConv(c1, c1, k, s)``, its own ``e``) first."""

    def __init__(self, c1: int, c2: int, k: int, s: int, snn: SNNConfig):
        super().__init__()
        self.shortcut = Shortcut(c1, c2, s, snn=snn) if s != 1 or c1 != c2 else None
        self.conv = StarSConv(c1, c1, k, s, snn=snn)

    def residual(self, x):
        return x if self.shortcut is None else self.shortcut(x)


class MStarBlock(_MStar):
    """MobileNet-style star block (reference MStarBlock): ``conv``
    (``StarSConv``) -> ``conv2`` (``Conv_3`` k to ``c1 * mlp_ratio``) ->
    ``conv3`` (``Conv_4`` k to c2), plus the residual (``_MStar``).  ``e``
    is the JAX block's field, unused there too."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, mlp_ratio: int = 3,
                 e: int = 2, snn: SNNConfig = DEFAULT_SNN):
        super().__init__(c1, c2, k, s, snn)
        self.conv2 = Conv_3(c1, c1 * mlp_ratio, k, 1, snn=snn)
        self.conv3 = Conv_4(c1 * mlp_ratio, c2, k, 1, snn=snn)

    def forward(self, x):
        return self.conv3(self.conv2(self.conv(x))) + self.residual(x)


class MStarBlock_2(_MStar):
    """``MStarBlock`` with two inverted-bottleneck 1x1 stages (reference
    MStarBlock_2): after ``conv``, ``conv2`` (to c1) and ``conv3`` (to c2),
    each ``{tag}_act`` -> ``{tag}_up`` (1x1 to ``c1 * mlp_ratio``) ->
    ``{tag}_dw`` (1x1 depthwise) -> ``{tag}_down`` (1x1), all with bias,
    -> ``{tag}_bn``; plus the residual."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, mlp_ratio: int = 3,
                 e: int = 2, snn: SNNConfig = DEFAULT_SNN):
        super().__init__(c1, c2, k, s, snn)
        cm = c1 * mlp_ratio
        for tag, cout in (("conv2", c1), ("conv3", c2)):
            self.add_module(f"{tag}_act", MemUpdate(c1, snn=snn))
            self.add_module(f"{tag}_up", SnnConv(c1, cm, 1, 1, bias=True))
            self.add_module(f"{tag}_dw", SnnConv(cm, cm, 1, 1, g=cm, bias=True))
            self.add_module(f"{tag}_down", SnnConv(cm, cout, 1, 1, bias=True))
            self.add_module(f"{tag}_bn", TBatchNorm(cout, 1.0, snn))

    def forward(self, x):
        y = self.conv(x)
        for tag in ("conv2", "conv3"):
            for suffix in ("act", "up", "dw", "down", "bn"):
                y = getattr(self, f"{tag}_{suffix}")(y)
        return y + self.residual(x)


class StarBlock_2C2f(_C2fFrame):
    """C2f over ``StarBlock_2`` stages (reference StarBlock_2C2f): the C2f
    frame (``_C2fFrame``, ``c = c2 * e``) with a ``cv`` pre-stride at ``s ==
    2``, ``m0 ... m{n-1}`` ``StarBlock_2(c, c, k, 1, mlp_ratio)``
    (``drop_path`` does not reach them, as in JAX) and a ``Conv_4`` merge.
    The YAML passes ``n`` itself (``parse_model`` inserts nothing)."""

    def __init__(self, c1: int, c2: int, n: int = 1, k: int = 3, s: int = 1,
                 mlp_ratio: int = 3, drop_path: float = 0.0, e: float = 0.5,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__(c1, c2, n, lambda c: StarBlock_2(c, c, k, 1, mlp_ratio, snn=snn),
                         snn, e, pre_stride=s == 2)
