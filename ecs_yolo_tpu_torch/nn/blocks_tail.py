"""The long-tail block library (counterpart of
``ecs_yolo_tpu/nn/blocks_tail.py``, all of it, and of ``nn/blocks_tail2.py``'s
``BasicBlock_ms1``): the residual variants ``Bottleneck_1``-``_4``,
``BasicBlock_3``-``_5``, ``BasicBlock_ms`` / ``ConcatBlock_ms``,
``Concat_res3``-``_6`` (``_5`` with ``nn/blocks_tail2.AKConv``),
``PartialConv`` / ``FasterNetBlock``, ``ScConv``, ``CoT``, ``DualConv``,
``MobileNetV3``, ``ELA`` and the two context-guided fusions, ``HGBlock``,
and ``TransformerBlock`` / ``C3TR``.

Features are ``[T, N, H, W, C]``.  The JAX blocks build their stacks with
``_Seq`` rows named ``0``, ``1``, ...; here they are an ``nn.Sequential``,
whose children carry the same names, so the JAX leaf
``res/3/spread_dw_kernel`` is the torch ``res.3.spread.0.weight`` and
``models/convert.py`` maps the tree path for path.  ``ELA``'s flax 1-D conv
is an ``nn.Conv1d`` (``se.conv1d``), whose ``[k, 1, C]`` kernel the
converter turns into ``[C, 1, k]``; the flax ``Dense`` layers are
``nn.Linear``.

A JAX block reads its input width from the tensor; here it is the
constructor's ``c1``, which ``models/yolo.py`` takes from the tensors of a
shape pass.  That matters for ``Bottleneck_2``, whose output has ``c2 * e``
channels where JAX's parser records c2.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..config import DEFAULT_SNN, SNNConfig
from .blocks import Conv_3, Conv_4, MemUpdate, SnnConv, TBatchNorm, max_pool_t
from .blocks_ext import (DWConv, EMAAttention, LightConv, RepConv, SELayer, TokenLIF,
                         _MultiHeadAttention)
from .blocks_tail2 import AKConv


def _mcb(c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1, bn_scale: float = 1.0,
         snn: SNNConfig = DEFAULT_SNN):
    """mem_update -> conv (``g`` groups; padding 1 for a 3x3, else 0) -> BN
    (gamma ``bn_scale * thresh``): three rows of a JAX ``_Seq``."""
    pad = 1 if k == 3 else 0
    return [MemUpdate(c1, snn=snn), SnnConv(c1, c2, k, s, pad, g),
            TBatchNorm(c2, bn_scale, snn)]


def _ms_residual(c1: int, c2: int, k: int, s: int, e: float,
                 snn: SNNConfig) -> nn.Sequential:
    c_ = int(c2 * e)
    return nn.Sequential(*_mcb(c1, c_, k, s, snn=snn),
                         *_mcb(c_, c2, k, 1, bn_scale=0.2, snn=snn))


def _pool_sc(c1: int, c2: int, s: int, snn: SNNConfig) -> Optional[nn.Sequential]:
    """The pooled shortcut ``sc`` (mem_update -> 1x1 to c2 -> BN, after a
    max pool by s) when ``s != 1`` or ``c1 != c2``, else None (identity)."""
    return nn.Sequential(*_mcb(c1, c2, 1, 1, snn=snn)) if s != 1 or c1 != c2 else None


def _pooled(sc: Optional[nn.Module], x: torch.Tensor, s: int) -> torch.Tensor:
    return x if sc is None else sc(max_pool_t(x, s))


def _cat_sc(c1: int, c2: int, snn: SNNConfig) -> Optional[nn.Sequential]:
    """The concatenating shortcut's ``sc`` (mem_update -> 1x1 to ``c2 - c1``
    -> BN) when ``c1 < c2``, else None."""
    return nn.Sequential(*_mcb(c1, c2 - c1, 1, 1, snn=snn)) if c1 < c2 else None


def _concat(sc: Optional[nn.Module], x: torch.Tensor) -> torch.Tensor:
    """``cat([sc(x), x])``, or x when there is no ``sc``."""
    return x if sc is None else torch.cat([sc(x), x], dim=-1)


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
        self.sc = _cat_sc(c1, c2, snn)

    def forward(self, x):
        return self.res(x) + max_pool_t(_concat(self.sc, x), self.s)


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


# --- the residual variants (reference :902-1348, :1491-1617) ------------------------


class Bottleneck_1(nn.Module):
    """``res``: 1x1 to 1024 (gamma 0.2) -> depthwise 3x3 at stride s (1024
    groups) -> 1x1 to c2 (gamma 0.2), each row mem_update -> conv -> BN;
    plus the pooled shortcut (``_pool_sc``).  The hidden width is 1024
    whatever the input, as in JAX; ``e`` is unused there too."""

    def __init__(self, c1: int, c2: int, s: int = 1, e: float = 4.0,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c_ = 1024
        self.s = s
        self.res = nn.Sequential(*_mcb(c1, c_, 1, 1, bn_scale=0.2, snn=snn),
                                 *_mcb(c_, c_, 3, s, g=c_, snn=snn),
                                 *_mcb(c_, c2, 1, 1, bn_scale=0.2, snn=snn))
        self.sc = _pool_sc(c1, c2, s, snn)

    def forward(self, x):
        return self.res(x) + _pooled(self.sc, x, self.s)


class Bottleneck_2(nn.Module):
    """``res``: 1x1 to c2 (gamma 0.2) -> kxk at stride s -> 1x1 to ``width =
    int(c2 * e)`` (gamma 0.2); the pooled shortcut to ``width``.  The
    output has ``width`` channels, not the c2 that ``parse_model`` records
    (JAX's too); at ``s == 1`` and ``c1 == c2`` the identity shortcut has
    c2 channels, which do not add to ``width`` unless e is 1 (JAX fails
    there as well)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, e: float = 4.0,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        width = int(c2 * e)
        self.s = s
        self.res = nn.Sequential(*_mcb(c1, c2, 1, 1, bn_scale=0.2, snn=snn),
                                 *_mcb(c2, c2, k, s, snn=snn),
                                 *_mcb(c2, width, 1, 1, bn_scale=0.2, snn=snn))
        self.sc = (nn.Sequential(*_mcb(c1, width, 1, 1, snn=snn))
                   if s != 1 or c1 != c2 else None)

    def forward(self, x):
        return self.res(x) + _pooled(self.sc, x, self.s)


def _inverted_residual(c1: int, c2: int, k: int, s: int, e: float,
                       snn: SNNConfig) -> nn.Sequential:
    """1x1 to ``width = int(c1 * e)`` (gamma 0.2) -> depthwise kxk at stride
    s -> 1x1 to c2 (gamma 0.2)."""
    width = int(c1 * e)
    return nn.Sequential(*_mcb(c1, width, 1, 1, bn_scale=0.2, snn=snn),
                         *_mcb(width, width, k, s, g=width, snn=snn),
                         *_mcb(width, c2, 1, 1, bn_scale=0.2, snn=snn))


class Bottleneck_3(nn.Module):
    """Inverted bottleneck: ``res`` (``_inverted_residual``, hidden ``c1 *
    e``) plus the pooled shortcut."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, e: float = 6.0,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.s = s
        self.res = _inverted_residual(c1, c2, k, s, e, snn)
        self.sc = _pool_sc(c1, c2, s, snn)

    def forward(self, x):
        return self.res(x) + _pooled(self.sc, x, self.s)


class Bottleneck_4(nn.Module):
    """``Bottleneck_3``'s residual plus the concatenating shortcut (``x``, or
    ``cat([sc(x), x])`` when ``c1 < c2``) max-pooled by s."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, e: float = 6.0,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.s = s
        self.res = _inverted_residual(c1, c2, k, s, e, snn)
        self.sc = _cat_sc(c1, c2, snn)

    def forward(self, x):
        return self.res(x) + max_pool_t(_concat(self.sc, x), self.s)


class _PreNormResidual(nn.Module):
    """The pre-norm residual of ``BasicBlock_3`` and ``Concat_res4``:
    ``bn0`` -> ``act1`` -> ``conv1`` (k, stride s) -> ``bn1`` (gamma 0.2)
    -> ``act2`` -> ``conv2`` (k), padding 1 for a 3x3, else 0; and the
    shortcut's ``sc_bn`` -> ``sc_act`` -> ``sc_conv`` (1x1 to ``c_sc``
    channels) when ``c_sc`` is not 0."""

    def __init__(self, c1: int, c2: int, k: int, s: int, c_sc: int, snn: SNNConfig):
        super().__init__()
        pad = 1 if k == 3 else 0
        self.s = s
        self.bn0 = TBatchNorm(c1, 1.0, snn)
        self.act1 = MemUpdate(c1, snn=snn)
        self.conv1 = SnnConv(c1, c2, k, s, pad)
        self.bn1 = TBatchNorm(c2, 0.2, snn)
        self.act2 = MemUpdate(c2, snn=snn)
        self.conv2 = SnnConv(c2, c2, k, 1, pad)
        self.sc_bn = self.sc_act = self.sc_conv = None
        if c_sc:
            self.sc_bn = TBatchNorm(c1, 1.0, snn)
            self.sc_act = MemUpdate(c1, snn=snn)
            self.sc_conv = SnnConv(c1, c_sc, 1, 1)

    def residual(self, x):
        return self.conv2(self.act2(self.bn1(self.conv1(self.act1(self.bn0(x))))))

    def shortcut(self, x):
        return self.sc_conv(self.sc_act(self.sc_bn(x)))


class BasicBlock_3(_PreNormResidual):
    """Pre-norm residual (``_PreNormResidual``); shortcut = identity, or max
    pool by s -> ``sc_bn`` -> ``sc_act`` -> ``sc_conv`` (1x1 to c2) when
    ``s != 1`` or ``c1 != c2``."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__(c1, c2, k, s, c2 if s != 1 or c1 != c2 else 0, snn)

    def forward(self, x):
        if self.sc_conv is None:
            return self.residual(x) + x
        return self.residual(x) + self.shortcut(max_pool_t(x, self.s))


class BasicBlock_4(nn.Module):
    """``rep`` (``RepConv``, k, stride s) -> ``act`` -> ``conv`` (k) ->
    ``bn`` (gamma 0.2), plus the pooled shortcut."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.s = s
        self.rep = RepConv(c1, c2, k, s, snn=snn)
        self.act = MemUpdate(c2, snn=snn)
        self.conv = SnnConv(c2, c2, k, 1, 1 if k == 3 else 0)
        self.bn = TBatchNorm(c2, 0.2, snn)
        self.sc = _pool_sc(c1, c2, s, snn)

    def forward(self, x):
        return self.bn(self.conv(self.act(self.rep(x)))) + _pooled(self.sc, x, self.s)


class PartialConv(nn.Module):
    """``pconv`` (k, dilation d, padding d, no bias) on the first ``c //
    n_div`` channels; the rest passed as they are.  No neuron: it takes its
    input as it comes."""

    def __init__(self, c1: int, n_div: int = 4, k: int = 3, dilation: int = 1):
        super().__init__()
        self.cp = c1 // n_div
        self.pconv = SnnConv(self.cp, self.cp, k, 1, dilation, dilation=dilation)

    def forward(self, x):
        return torch.cat([self.pconv(x[..., :self.cp]), x[..., self.cp:]], dim=-1)


class FasterNetBlock(nn.Module):
    """``pconv`` (``PartialConv``) -> ``conv1`` (1x1 to ``c * expand_ratio``,
    with bias) -> ``bn`` (gamma 0.2) -> ``act`` -> ``conv2`` (1x1 back to
    c, with bias), plus the input."""

    def __init__(self, c1: int, expand_ratio: int = 2, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        ce = c1 * expand_ratio
        self.pconv = PartialConv(c1)
        self.conv1 = SnnConv(c1, ce, 1, bias=True)
        self.bn = TBatchNorm(ce, 0.2, snn)
        self.act = MemUpdate(ce, snn=snn)
        self.conv2 = SnnConv(ce, c1, 1, bias=True)

    def forward(self, x):
        return self.conv2(self.act(self.bn(self.conv1(self.pconv(x))))) + x


class BasicBlock_5(nn.Module):
    """``act1`` -> ``conv1`` (k, stride s) -> ``bn1`` -> ``act2`` -> ``pconv``
    (``PartialConv`` with ``dilation``) -> ``bn2`` (gamma 0.2), plus the
    pooled shortcut."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, dilation: int = 1,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.s = s
        self.act1 = MemUpdate(c1, snn=snn)
        self.conv1 = SnnConv(c1, c2, k, s, 1 if k == 3 else 0)
        self.bn1 = TBatchNorm(c2, 1.0, snn)
        self.act2 = MemUpdate(c2, snn=snn)
        self.pconv = PartialConv(c2, dilation=dilation)
        self.bn2 = TBatchNorm(c2, 0.2, snn)
        self.sc = _pool_sc(c1, c2, s, snn)

    def forward(self, x):
        y = self.bn2(self.pconv(self.act2(self.bn1(self.conv1(self.act1(x))))))
        return y + _pooled(self.sc, x, self.s)


class SELayerInner(nn.Module):
    """The SE excitation of ``Concat_res3``: the mean over H x W, ``fc1``
    (to ``C // reduction``, no bias), ReLU, ``fc2`` (to C, no bias),
    sigmoid, as ``[T, N, 1, 1, C]`` (the gate, not the gated input)."""

    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(c, c // reduction, bias=False)
        self.fc2 = nn.Linear(c // reduction, c, bias=False)

    def forward(self, x):
        s = torch.sigmoid(self.fc2(torch.relu(self.fc1(x.mean(dim=(2, 3))))))
        return s[:, :, None, None, :]


class Concat_res3(nn.Module):
    """``res`` (mem_update -> conv (k, stride s) -> BN, then to c2 again,
    gamma 0.2) gated by its ``se`` (``SELayerInner``), plus the
    concatenating shortcut max-pooled by s.  ``e`` is unused, as in JAX."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, e: float = 0.5,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.s = s
        self.res = _ms_residual(c1, c2, k, s, 1.0, snn)
        self.sc = _cat_sc(c1, c2, snn)
        self.se = SELayerInner(c2)

    def forward(self, x):
        y = self.res(x)
        return y * self.se(y) + max_pool_t(_concat(self.sc, x), self.s)


class Concat_res4(_PreNormResidual):
    """Pre-norm residual (``_PreNormResidual``) with the concatenating
    shortcut (``sc_bn`` -> ``sc_act`` -> ``sc_conv`` to ``c2 - c1``, when
    ``c1 < c2``) max-pooled by s.  ``e`` is unused, as in JAX."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, e: float = 0.5,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__(c1, c2, k, s, max(c2 - c1, 0), snn)

    def forward(self, x):
        sc = x if self.sc_conv is None else torch.cat([self.shortcut(x), x], dim=-1)
        return self.residual(x) + max_pool_t(sc, self.s)


class Concat_res5(nn.Module):
    """``act1`` -> ``conv1`` (k, stride s) -> ``bn1`` -> ``act2`` -> ``conv2``
    (``AKConv`` with k sampling points, stride 1, its own BN), plus the
    concatenating shortcut max-pooled by s."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, e: float = 0.5,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.s = s
        self.act1 = MemUpdate(c1, snn=snn)
        self.conv1 = SnnConv(c1, c2, k, s, 1 if k == 3 else 0)
        self.bn1 = TBatchNorm(c2, 1.0, snn)
        self.act2 = MemUpdate(c2, snn=snn)
        self.conv2 = AKConv(c2, c2, num_param=k, s=1, snn=snn)
        self.sc = _cat_sc(c1, c2, snn)

    def forward(self, x):
        y = self.conv2(self.act2(self.bn1(self.conv1(self.act1(x)))))
        return y + max_pool_t(_concat(self.sc, x), self.s)


class ScConv(nn.Module):
    """Spatial then channel reconstruction (reference ScConv).

    SRU: the input regrouped as JAX regroups it, a raw reshape of the
    channel-last ``[T, N, H, W, C]`` to ``[T, N, g, -1]`` (g = ``min(16,
    C)``, so a group runs over flattened H x W x C, not a channel group),
    normalised by its mean and population standard deviation (``/ (std +
    1e-10)``, as JAX), then ``* gn_gamma + gn_beta``; the gate ``sigmoid(gn
    * gn_gamma / sum(gn_gamma)) >= gate_threshold`` splits the input into
    the informative and the rest, whose halves are crossed and summed.  The
    gate is a comparison, so ``gn_gamma`` / ``gn_beta`` get no gradient (in
    JAX neither).

    CRU: the first ``alpha * C`` channels through ``squeeze1`` (1x1, /
    ``squeeze_radio``), then ``gwc`` (3x3, ``group_size`` groups, bias) plus
    ``pwc1`` (1x1); the rest through ``squeeze2``, then ``cat([pwc2(low),
    low])``; the two concatenated, weighted by a softmax over the channels
    of their spatial means, and the halves summed."""

    def __init__(self, c1: int, group_num: int = 16, gate_threshold: float = 0.5,
                 alpha: float = 0.5, squeeze_radio: int = 2, group_size: int = 2,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c = c1
        self.group_num, self.gate_threshold = group_num, gate_threshold
        self.gn_gamma = nn.Parameter(torch.ones(c))
        self.gn_beta = nn.Parameter(torch.zeros(c))
        self.up_c = up_c = int(alpha * c)
        low_c = c - up_c
        up_s, low_s = up_c // squeeze_radio, low_c // squeeze_radio
        self.squeeze1 = SnnConv(up_c, up_s, 1)
        self.squeeze2 = SnnConv(low_c, low_s, 1)
        self.gwc = SnnConv(up_s, c, 3, 1, 1, g=group_size, bias=True)
        self.pwc1 = SnnConv(up_s, c, 1)
        self.pwc2 = SnnConv(low_s, c - low_s, 1)

    def forward(self, x):
        t, n, h, w, c = x.shape
        g = min(self.group_num, c)
        gamma, beta = self.gn_gamma.to(x.dtype), self.gn_beta.to(x.dtype)
        xr = x.reshape(t, n, g, -1)
        mean = xr.mean(-1, keepdim=True)
        std = xr.std(-1, correction=0, keepdim=True)
        gn = ((xr - mean) / (std + 1e-10)).reshape(t, n, h, w, c) * gamma + beta
        rw = torch.sigmoid(gn * (gamma / gamma.sum()))
        info = (rw >= self.gate_threshold).to(x.dtype) * x
        noninfo = (rw < self.gate_threshold).to(x.dtype) * x
        h1, h2 = info.chunk(2, dim=-1)
        l1, l2 = noninfo.chunk(2, dim=-1)
        y = torch.cat([h1 + l2, h2 + l1], dim=-1)
        up = self.squeeze1(y[..., :self.up_c])
        low = self.squeeze2(y[..., self.up_c:])
        out = torch.cat([self.gwc(up) + self.pwc1(up),
                         torch.cat([self.pwc2(low), low], dim=-1)], dim=-1)
        out = torch.softmax(out.mean(dim=(2, 3), keepdim=True), dim=-1) * out
        o1, o2 = out.chunk(2, dim=-1)
        return o1 + o2


class Concat_res6(nn.Module):
    """``act1`` -> ``pconv`` (``PartialConv``) -> ``act2`` -> ``conv`` (k,
    stride s) -> ``bn1`` -> ``act3`` -> ``scconv`` (``ScConv``) -> ``bn2``
    (gamma 0.2), plus the concatenating shortcut max-pooled by s."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, e: float = 2.0,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.s = s
        self.act1 = MemUpdate(c1, snn=snn)
        self.pconv = PartialConv(c1)
        self.act2 = MemUpdate(c1, snn=snn)
        self.conv = SnnConv(c1, c2, k, s, 1 if k == 3 else 0)
        self.bn1 = TBatchNorm(c2, 1.0, snn)
        self.act3 = MemUpdate(c2, snn=snn)
        self.scconv = ScConv(c2, snn=snn)
        self.bn2 = TBatchNorm(c2, 0.2, snn)
        self.sc = _cat_sc(c1, c2, snn)

    def forward(self, x):
        y = self.bn1(self.conv(self.act2(self.pconv(self.act1(x)))))
        y = self.bn2(self.scconv(self.act3(y)))
        return y + max_pool_t(_concat(self.sc, x), self.s)


# --- attention, grouped and mobile blocks (reference :3049-3090, :4005-4226) ---------


class CoT(nn.Module):
    """Contextual transformer (reference CoT): ``head`` (neuron) on the
    input; keys ``key_conv`` (k, 4 groups) -> ``key_bn``; values
    ``val_conv`` (1x1) -> ``val_bn``; the attention ``att_act1`` ->
    ``att_conv1`` (1x1 to ``2C / 4``) -> ``att_bn`` -> ``att_act2`` ->
    ``att_conv2`` (1x1 to ``k * k * C``, bias) over ``cat([keys, spikes])``,
    reshaped to ``[..., C, k * k]`` (channel ``c * k * k + j`` in group c)
    and averaged; the output is ``keys + attention * values``."""

    def __init__(self, c1: int, k: int = 3, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c, ca = c1, 2 * c1 // 4
        self.k = k
        self.head = MemUpdate(c, snn=snn)
        self.key_conv = SnnConv(c, c, k, 1, k // 2, g=4)
        self.key_bn = TBatchNorm(c, 1.0, snn)
        self.val_conv = SnnConv(c, c, 1)
        self.val_bn = TBatchNorm(c, 1.0, snn)
        self.att_act1 = MemUpdate(2 * c, snn=snn)
        self.att_conv1 = SnnConv(2 * c, ca, 1)
        self.att_bn = TBatchNorm(ca, 1.0, snn)
        self.att_act2 = MemUpdate(ca, snn=snn)
        self.att_conv2 = SnnConv(ca, k * k * c, 1, bias=True)

    def forward(self, x):
        t, n, h, w, c = x.shape
        x = self.head(x)
        k1 = self.key_bn(self.key_conv(x))
        v = self.val_bn(self.val_conv(x))
        a = self.att_bn(self.att_conv1(self.att_act1(torch.cat([k1, x], dim=-1))))
        a = self.att_conv2(self.att_act2(a))
        a = a.reshape(t, n, h, w, c, self.k * self.k).mean(-1)
        return k1 + a * v


class DualConv(nn.Module):
    """``gc`` (3x3, stride s, g groups) plus ``pwc`` (1x1, stride s), no
    neuron and no BN."""

    def __init__(self, c1: int, c2: int, s: int = 1, g: int = 4,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.gc = SnnConv(c1, c2, 3, s, 1, g=g)
        self.pwc = SnnConv(c1, c2, 1, s)

    def forward(self, x):
        return self.gc(x) + self.pwc(x)


class MobileNetV3(nn.Module):
    """Inverted residual with SE: ``expand`` (1x1 to ``hidden``, ``4 * c1``
    when 0) -> ``dw`` (depthwise k at stride s) -> ``se`` (``SELayer``,
    reduction 4, with ``use_se``) -> ``project`` (1x1 to c2, gamma 0.2),
    each mem_update -> conv -> BN rows; plus the input when ``s == 1`` and
    ``c1 == c2``."""

    def __init__(self, c1: int, c2: int, hidden: int = 0, k: int = 3, s: int = 1,
                 use_se: bool = True, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        hid = hidden or c1 * 4
        self.expand = nn.Sequential(*_mcb(c1, hid, 1, 1, snn=snn))
        self.dw = nn.Sequential(*_mcb(hid, hid, k, s, g=hid, snn=snn))
        self.se = SELayer(hid, 4, snn=snn) if use_se else None
        self.project = nn.Sequential(*_mcb(hid, c2, 1, 1, bn_scale=0.2, snn=snn))
        self.add = s == 1 and c1 == c2

    def forward(self, x):
        y = self.dw(self.expand(x))
        if self.se is not None:
            y = self.se(y)
        y = self.project(y)
        return y + x if self.add else y


class ContextGuideFusionModulev2(nn.Module):
    """Cross-gated fusion, v2 (reference ContextGuideFusionModulev2):
    ``x0`` through ``adjust`` (1x1 with bias) when its width differs from
    ``x1``'s; ``se`` (``EMA``) of ``cat([x0, x1])`` gives the pair ``(w0,
    w1)``; one ``convs`` (3x3 with bias) applied to each, ``ans =
    convs(w0) * convs(w1)``; the output is ``cat([x0 + x1 * w1 + ans, x1 +
    x0 * w0 + ans])``.  ``c1`` is the two inputs' widths; ``dim`` is
    unused."""

    def __init__(self, c1: Sequence[int], dim=None, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c0, c = c1
        self.adjust = SnnConv(c0, c, 1, bias=True) if c0 != c else None
        self.se = EMAAttention(2 * c, snn=snn)
        self.convs = SnnConv(c, c, 3, 1, 1, bias=True)

    def forward(self, xs):
        x0, x1 = xs
        if self.adjust is not None:
            x0 = self.adjust(x0)
        w0, w1 = self.se(torch.cat([x0, x1], dim=-1)).chunk(2, dim=-1)
        ans = self.convs(w0) * self.convs(w1)
        return torch.cat([x0 + x1 * w1 + ans, x1 + x0 * w0 + ans], dim=-1)


# --- the ViT block (reference :2482-2552) --------------------------------------------


class TransformerBlock(nn.Module):
    """ViT-style stack on the H*W tokens: ``conv`` (1x1 to c2) when the
    width differs; the learned position table ``pos`` ``[1, 1, H*W, c2]``
    added; then n times ``lif{i}`` (``TokenLIF``: K6 in eval) ->
    ``ma{i}`` (flax's multi-head attention, self-attention on the spikes)
    added to the tokens, and ``fc1_{i}`` -> SiLU -> ``fc2_{i}`` (``Dense``
    with bias) added.

    ``pos`` is sized by the map the block is built for (``hw``, from the
    model's shape pass at its image size, as JAX's ``init`` sizes it); a
    map of another token count raises ``ValueError`` (JAX fails there on
    the broadcast)."""

    def __init__(self, c1: int, c2: int, num_heads: int = 4, n: int = 1,
                 snn: SNNConfig = DEFAULT_SNN, *, hw: Tuple[int, int]):
        super().__init__()
        self.n, self.hw = n, tuple(hw)
        self.conv = SnnConv(c1, c2, 1) if c1 != c2 else None
        self.pos = nn.Parameter(torch.zeros(1, 1, hw[0] * hw[1], c2))
        for i in range(n):
            self.add_module(f"lif{i}", TokenLIF(snn))
            self.add_module(f"ma{i}", _MultiHeadAttention(c2, num_heads))
            self.add_module(f"fc1_{i}", nn.Linear(c2, c2))
            self.add_module(f"fc2_{i}", nn.Linear(c2, c2))

    def forward(self, x):
        t, n, h, w, _ = x.shape
        if h * w != self.pos.shape[2]:
            raise ValueError(f"TransformerBlock built for {self.hw[0]}x{self.hw[1]} maps "
                             f"got a {h}x{w} map: build the model at this image size")
        if self.conv is not None:
            x = self.conv(x)
        c = x.shape[-1]
        tokens = x.reshape(t, n, h * w, c) + self.pos.to(x.dtype)
        for i in range(self.n):
            a = getattr(self, f"lif{i}")(tokens).reshape(t * n, h * w, c)
            tokens = tokens + getattr(self, f"ma{i}")(a, a, a).reshape(t, n, h * w, c)
            f = torch.nn.functional.silu(getattr(self, f"fc1_{i}")(tokens))
            tokens = tokens + getattr(self, f"fc2_{i}")(f)
        return tokens.reshape(t, n, h, w, c)


class C3TR(nn.Module):
    """C3 with a ``TransformerBlock`` inside: ``cv1`` (``Conv_3`` 1x1 to
    ``c_ = c2 * e``) -> ``m`` (``TransformerBlock`` c_, 4 heads, n layers),
    beside ``cv2`` (``Conv_3`` 1x1 to c_), concatenated, ``cv3`` (``Conv_4``
    1x1 to c2).  ``hw`` is the input map's size (``m`` sees the same)."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5,
                 snn: SNNConfig = DEFAULT_SNN, *, hw: Tuple[int, int]):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv_3(c1, c_, 1, 1, snn=snn)
        self.m = TransformerBlock(c_, c_, 4, n, snn=snn, hw=hw)
        self.cv2 = Conv_3(c1, c_, 1, 1, snn=snn)
        self.cv3 = Conv_4(2 * c_, c2, 1, 1, snn=snn)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=-1))
