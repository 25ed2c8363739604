"""The extended block library (counterpart of
``ecs_yolo_tpu/nn/blocks_ext.py``, every registry row of it): the YOLOv5 /
v8 CSP family (``spatial_max_pool_same``, ``DWConv``, ``LightConv``,
``Bottleneck``, ``C3``, ``BottleneckCSP``, ``C2f``, ``SPPF``, ``SPP``,
``C3SPP``, ``Focus``, ``Contract``, ``Expand``, ``GhostConv``,
``GhostBottleneck``, ``C3Ghost``); the slim-neck family (``GSConv``,
``BasicBlock_6``, ``BasicBlock_1s``) and ``DropPath`` / ``StarBlock_2``;
``interpolate_nearest``, ``ASFF2`` and ``ASFF3``; ``Silence``,
``CBLinear`` and ``CBFuse`` for the v9 wiring; ``EMAAttention`` (registry
name ``EMA``); ``RepConv``, ``RepC3``, ``TokenLIF``,
``sincos_pos_embed_2d`` and ``AIFI`` for the RT-DETR neck; ``SELayer``,
the BoTNet blocks (``MHSA``, ``BottleneckTransformer``, ``BoT3``) and
``DSSA``.  Features are ``[T, N, H, W, C]``; the channel axis is the last.

Child modules carry the JAX module names (``cv1``, ``m0``, ``conv1x1``,
``ma.query``, ``norm1``, ``fc1``, ``dw_act``, ``sc_dw``, ...), so
``models/convert.py`` maps the JAX tree path for path; flax ``Dense`` /
``DenseGeneral`` kernels become ``nn.Linear`` weights there.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DEFAULT_SNN, SNNConfig
from ..parallel import mesh
from ..snn.fused import lif_fused
from ..snn.neuron import lif_scan
from .blocks import (Conv, Conv_2, Conv_3, Conv_4, Conv_5, Conv_6, DepthWiseConv, MemUpdate,
                     Shortcut, SnnConv, TBatchNorm, _nchw, _nhwc, fold_t, max_pool_t,
                     recomputing, unfold_t)
from .segment import resize_nearest


def spatial_max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """Per-step spatial max pool of ``[T, N, H, W, C]``, stride 1, padding
    ``k // 2`` (``F.max_pool2d`` pads with -inf, as flax's ``max_pool``)."""
    y, t = fold_t(x)
    return unfold_t(_nhwc(F.max_pool2d(_nchw(y), k, 1, k // 2)), t)


def interpolate_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsample of the two spatial axes by ``factor``."""
    return x.repeat_interleave(factor, dim=-3).repeat_interleave(factor, dim=-2)


# --- CSP family (reference :2143-2500) ---------------------------------------------


class DWConv(nn.Module):
    """``Conv_3`` with ``gcd(c1, c2)`` groups (reference DWConv)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.conv = Conv_3(c1, c2, k, s, g=math.gcd(c1, c2), snn=snn)

    def forward(self, x):
        return self.conv(x)


class LightConv(nn.Module):
    """1x1 ``Conv_3`` (``conv1``) then a k x k ``DWConv`` (``conv2``)
    (reference LightConv)."""

    def __init__(self, c1: int, c2: int, k: int = 1, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.conv1 = Conv_3(c1, c2, 1, snn=snn)
        self.conv2 = DWConv(c2, c2, k, snn=snn)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class Bottleneck(nn.Module):
    """``Conv_3`` (``k[0]``, to ``c2 * e``) -> ``Conv_4`` (``k[1]``, ``g``
    groups), plus the input when ``shortcut`` and ``c1 == c2`` (reference
    Bottleneck)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 k: Tuple[int, int] = (3, 3), e: float = 0.5, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c_ = int(c2 * e)
        self.add = bool(shortcut) and c1 == c2
        self.cv1 = Conv_3(c1, c_, k[0], 1, snn=snn)
        self.cv2 = Conv_4(c_, c2, k[1], 1, g=g, snn=snn)

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP with three convs (reference C3): ``cv1`` (1x1 to ``c2 * e``) ->
    ``m0 ... m{n-1}`` (``Bottleneck`` at ``k=(1, 3)``, ``e=1``), beside
    ``cv2`` (1x1 of the input), concatenated, then ``cv3`` (1x1,
    ``Conv_4``).  The YAML's repeat count is ``n``."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        self.cv1 = Conv_3(c1, c_, 1, 1, snn=snn)
        for i in range(n):
            self.add_module(f"m{i}", self._inner(c_, shortcut, g, snn))
        self.cv2 = Conv_3(c1, c_, 1, 1, snn=snn)
        self.cv3 = Conv_4(2 * c_, c2, 1, snn=snn)

    @staticmethod
    def _inner(c_: int, shortcut: bool, g: int, snn: SNNConfig) -> nn.Module:
        return Bottleneck(c_, c_, shortcut, g, k=(1, 3), e=1.0, snn=snn)

    def forward(self, x):
        y1 = self.cv1(x)
        for i in range(self.n):
            y1 = getattr(self, f"m{i}")(y1)
        return self.cv3(torch.cat([y1, self.cv2(x)], dim=-1))


class BottleneckCSP(nn.Module):
    """CSP bottleneck (reference BottleneckCSP): ``cv1`` (1x1 ``Conv_3`` to
    ``c2 * e``) -> ``m0 ... m{n-1}`` (``Bottleneck`` 3x3, ``e=1``) -> ``cv3``
    (a bare 1x1 conv), beside ``cv2`` (a bare 1x1 conv of the input);
    concatenated, ``bn`` and SiLU, then ``cv4`` (1x1 ``Conv_3``).  The
    YAML's repeat count is ``n``."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        self.cv1 = Conv_3(c1, c_, 1, 1, snn=snn)
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(c_, c_, shortcut, g, e=1.0, snn=snn))
        self.cv3 = SnnConv(c_, c_, 1, 1)
        self.cv2 = SnnConv(c1, c_, 1, 1)
        self.bn = TBatchNorm(2 * c_, 1.0, snn)
        self.cv4 = Conv_3(2 * c_, c2, 1, 1, snn=snn)

    def forward(self, x):
        y1 = self.cv1(x)
        for i in range(self.n):
            y1 = getattr(self, f"m{i}")(y1)
        y = torch.cat([self.cv3(y1), self.cv2(x)], dim=-1)
        return self.cv4(F.silu(self.bn(y)))


class _C2fFrame(nn.Module):
    """The C2f walk (reference C2f, and the frame of ``StarBlock_2C2f`` and
    the C2f hybrids of ``nn/blocks_tail2.py``): at ``pre_stride`` a ``cv``
    (``Conv_3`` 3x3, stride 2, keeping the width) first; ``cv1`` (1x1
    ``Conv_3`` to ``2c``, ``c = int(c2 * e)``) split in halves, ``m0 ...
    m{n-1}`` (``inner(c)``) chained on the second half, every piece
    concatenated, then ``cv2`` (1x1 ``merge``).  The first inner block takes
    a dense copy of the second half: the slice is a strided view, whose
    neuron site the tensor-core kernel would refuse (``nn/blocks.MemUpdate``);
    the concat reads ``cv1``'s output whole in place of its two halves."""

    def __init__(self, c1: int, c2: int, n: int, inner, snn: SNNConfig, e: float = 0.5,
                 pre_stride: bool = False, merge=Conv_4):
        super().__init__()
        self.c = c = int(c2 * e)
        self.n = n
        self.cv = Conv_3(c1, c1, 3, 2, snn=snn) if pre_stride else None
        self.cv1 = Conv_3(c1, 2 * c, 1, 1, snn=snn)
        for i in range(n):
            self.add_module(f"m{i}", inner(c))
        self.cv2 = merge((2 + n) * c, c2, 1, snn=snn)

    def forward(self, x):
        if self.cv is not None:
            x = self.cv(x)
        y = self.cv1(x)
        ys, h = [y], y[..., self.c:].contiguous()
        for i in range(self.n):
            h = getattr(self, f"m{i}")(h)
            ys.append(h)
        return self.cv2(torch.cat(ys, dim=-1))


class C2f(_C2fFrame):
    """Fast CSP with two convs (reference C2f): the C2f frame
    (``_C2fFrame``) over ``Bottleneck`` stages at 3x3, ``e=1``, a ``Conv_4``
    merge.  The YAML's repeat count is ``n``."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1,
                 e: float = 0.5, snn: SNNConfig = DEFAULT_SNN):
        super().__init__(c1, c2, n, lambda c: Bottleneck(c, c, shortcut, g, k=(3, 3), e=1.0,
                                                         snn=snn), snn, e)


class SPPF(nn.Module):
    """Fast spatial pyramid pooling (reference SPPF): ``cv1`` (1x1 to half
    the input's channels), three chained k x k stride-1 max pools, the four
    concatenated, then ``cv2`` (1x1, ``Conv_4``)."""

    def __init__(self, c1: int, c2: int, k: int = 5, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c_ = c1 // 2
        self.k = k
        self.cv1 = Conv_3(c1, c_, 1, 1, snn=snn)
        self.cv2 = Conv_4(4 * c_, c2, 1, snn=snn)

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(spatial_max_pool_same(ys[-1], self.k))
        return self.cv2(torch.cat(ys, dim=-1))


class SPP(nn.Module):
    """Spatial pyramid pooling (reference SPP): ``cv1`` (1x1 ``Conv_3`` to
    half the input's channels), beside it its k x k stride-1 max pools for
    each k (``spatial_max_pool_same``: spatial only, as JAX), concatenated,
    then ``cv2`` (1x1 ``Conv_3``)."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (5, 9, 13),
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = Conv_3(c1, c_, 1, 1, snn=snn)
        self.cv2 = Conv_3(c_ * (len(self.k) + 1), c2, 1, 1, snn=snn)

    def forward(self, x):
        y = self.cv1(x)
        return self.cv2(torch.cat([y] + [spatial_max_pool_same(y, k) for k in self.k],
                                  dim=-1))


class C3SPP(nn.Module):
    """``C3`` whose inner stack is one ``SPP`` (reference C3SPP): ``cv1`` /
    ``cv2`` (1x1 ``Conv_3`` to ``c2 * e``), ``m`` (``SPP`` of ``cv1``'s
    output, pools ``k``), concatenated, then ``cv3`` (1x1 ``Conv_4``).  Its
    YAML args are ``(c2, k)``, so the parser inserts no repeat count, as
    JAX's does not; ``n``, ``shortcut`` and ``g`` are unused there too."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (5, 9, 13), n: int = 1,
                 shortcut: bool = True, g: int = 1, e: float = 0.5,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv_3(c1, c_, 1, 1, snn=snn)
        self.m = SPP(c_, c_, k, snn=snn)
        self.cv2 = Conv_3(c1, c_, 1, 1, snn=snn)
        self.cv3 = Conv_4(2 * c_, c2, 1, snn=snn)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=-1))


class Focus(nn.Module):
    """Space to channels (reference Focus): the four stride-2 samplings of
    the input in JAX's order (even rows and columns, odd rows, odd columns,
    both odd), concatenated, then ``conv`` (``Conv``, k, s, to c2)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.conv = Conv(4 * c1, c2, k, s, snn=snn)

    def forward(self, x):
        return self.conv(torch.cat([x[..., ::2, ::2, :], x[..., 1::2, ::2, :],
                                    x[..., ::2, 1::2, :], x[..., 1::2, 1::2, :]], dim=-1))


class Contract(nn.Module):
    """Space to depth (reference Contract): ``[T, N, H, W, C]`` ->
    ``[T, N, H/g, W/g, C*g*g]``, the channel index ``(dy * g + dx) * C +
    c`` as JAX's channel-last reshape and transpose give it."""

    def __init__(self, gain: int = 2):
        super().__init__()
        self.gain = gain

    def forward(self, x):
        g = self.gain
        t, n, h, w, c = x.shape
        x = x.reshape(t, n, h // g, g, w // g, g, c).permute(0, 1, 2, 4, 3, 5, 6)
        return x.reshape(t, n, h // g, w // g, c * g * g)


class Expand(nn.Module):
    """Depth to space (reference Expand), the inverse of ``Contract``:
    ``[T, N, H, W, C]`` -> ``[T, N, H*g, W*g, C/(g*g)]``."""

    def __init__(self, gain: int = 2):
        super().__init__()
        self.gain = gain

    def forward(self, x):
        g = self.gain
        t, n, h, w, c = x.shape
        x = x.reshape(t, n, h, w, g, g, c // (g * g)).permute(0, 1, 2, 4, 3, 5, 6)
        return x.reshape(t, n, h * g, w * g, c // (g * g))


class GhostConv(nn.Module):
    """Ghost conv (reference GhostConv): ``cv1`` (``Conv_3`` to half of c2,
    k, s, g groups) and its cheap depthwise 5x5 ``cv2`` (``Conv_4``),
    concatenated."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv_3(c1, c_, k, s, g=g, snn=snn)
        self.cv2 = Conv_4(c_, c_, 5, 1, g=c_, snn=snn)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], dim=-1)


class GhostBottleneck(nn.Module):
    """Ghost bottleneck (reference GhostBottleneck): ``pw`` (``GhostConv`` to
    half of c2), at ``s == 2`` a ``DWConv`` ``dw`` (k, stride 2), ``pw2``
    (``GhostConv`` to c2); the shortcut is ``sc_dw`` (``DWConv`` k, stride
    2) -> ``sc_pw`` (1x1 ``Conv_3``) at ``s == 2``, else a 1x1 conv ``sc``
    when the widths differ, else the input."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c_ = c2 // 2
        self.s2 = s == 2
        self.pw = GhostConv(c1, c_, 1, 1, snn=snn)
        self.dw = DWConv(c_, c_, k, s, snn=snn) if self.s2 else None
        self.pw2 = GhostConv(c_, c2, 1, 1, snn=snn)
        self.sc_dw = self.sc_pw = self.sc = None
        if self.s2:
            self.sc_dw = DWConv(c1, c1, k, s, snn=snn)
            self.sc_pw = Conv_3(c1, c2, 1, 1, snn=snn)
        elif c1 != c2:
            self.sc = SnnConv(c1, c2, 1)

    def forward(self, x):
        y = self.pw(x)
        if self.dw is not None:
            y = self.dw(y)
        y = self.pw2(y)
        if self.s2:
            sc = self.sc_pw(self.sc_dw(x))
        else:
            sc = x if self.sc is None else self.sc(x)
        return y + sc


class C3Ghost(C3):
    """``C3`` with ``GhostBottleneck`` inners (reference C3Ghost); the
    YAML's repeat count is ``n``."""

    @staticmethod
    def _inner(c_: int, shortcut: bool, g: int, snn: SNNConfig) -> nn.Module:
        return GhostBottleneck(c_, c_, snn=snn)


# --- slim-neck GSConv family (reference :4228, :1392, :1144) ------------------------


class GSConv(nn.Module):
    """Half-channel conv + depthwise 5x5 with a channel shuffle (reference
    GSConv): ``cv1`` (``Conv_3`` to ``c2 // 2``, k, s, g groups), ``cv2``
    (``Conv_4`` 5x5, one group a channel), concatenated, then the even
    channels before the odd ones.  ``ASFF2`` builds it at 1x1, stride 1."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv_3(c1, c_, k, s, g=g, snn=snn)
        self.cv2 = Conv_4(c_, c_, 5, 1, g=c_, snn=snn)

    def forward(self, x):
        y1 = self.cv1(x)
        y = torch.cat([y1, self.cv2(y1)], dim=-1)
        return torch.cat([y[..., 0::2], y[..., 1::2]], dim=-1)


class _GSResidual(nn.Module):
    """``conv2(conv1(x))`` (two ``GSConv``) plus the ``Shortcut`` of x when
    the stride or the width changes, else x."""

    def __init__(self, c1: int, c2: int, s: int, conv1: nn.Module, conv2: nn.Module,
                 snn: SNNConfig):
        super().__init__()
        self.shortcut = Shortcut(c1, c2, s, snn=snn) if s != 1 or c1 != c2 else None
        self.conv1, self.conv2 = conv1, conv2

    def forward(self, x):
        sc = x if self.shortcut is None else self.shortcut(x)
        return self.conv2(self.conv1(x)) + sc


class BasicBlock_6(_GSResidual):
    """GSConv residual block (reference BasicBlock_6): ``conv1`` (k, s) and
    ``conv2`` (k, 1), both ``GSConv`` to c2.  ``e`` is the JAX block's
    field, unused there too."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, e: float = 2.0,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__(c1, c2, s, GSConv(c1, c2, k, s, snn=snn),
                         GSConv(c2, c2, k, 1, snn=snn), snn)


class BasicBlock_1s(_GSResidual):
    """GSConv residual with a fixed 1024 hidden width (reference
    BasicBlock_1s): ``conv1`` (``GSConv`` 3x3, stride s, to 1024) and
    ``conv2`` (``GSConv`` 3x3 to c2).  ``e`` is unused, as in JAX."""

    def __init__(self, c1: int, c2: int, s: int = 1, e: float = 0.5,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__(c1, c2, s, GSConv(c1, 1024, 3, s, snn=snn),
                         GSConv(1024, c2, 3, 1, snn=snn), snn)


# --- StarNet (reference :4437-4492, :4772) ------------------------------------------


class DropPath(nn.Module):
    """Stochastic depth (reference DropPath): the identity unless ``rate >
    0``, the module is training and a ``generator`` has been set on it (JAX
    draws only when a ``dropout`` rng is given).  Then each index of the
    leading axis (T, as in JAX) is kept with probability ``1 - rate`` and
    scaled by its inverse; the mask is drawn on the generator's device."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if self.rate == 0.0 or not self.training or self.generator is None:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        u = torch.rand(shape, generator=self.generator, device=self.generator.device)
        return x * (u < keep).to(x.device, x.dtype) / keep


class StarBlock_2(nn.Module):
    """StarNet element-wise product block on spiking convs (reference
    StarBlock_2): ``dw_act`` -> ``dw`` (``DepthWiseConv`` k, stride s, no
    bias) -> ``dw_bn``; ``f1`` and ``f2`` (1x1 ``Conv_3`` to ``mlp_ratio *
    c1``) of that, ``relu6(f1) * f2``; ``g`` (1x1 ``Conv_4`` to c2) ->
    ``dw2_act`` -> ``dw2`` (``DepthWiseConv`` k) -> ``dw2_bn`` (gamma 0.2 *
    thresh) -> ``drop``; plus the input, or at a stride or width change
    MaxPool(1,s,s) -> ``sc_act`` -> ``sc_conv`` (1x1 with bias) ->
    ``sc_bn``.  ``F.relu6`` is a hardtanh, whose gradient is 0 at 0 and 6
    as ``jax.nn.relu6``'s."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, mlp_ratio: int = 3,
                 drop_path: float = 0.0, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.s = s
        p = (k - 1) // 2
        self.dw_act = MemUpdate(c1, snn=snn)
        self.dw = DepthWiseConv(c1, c1, k, s, p)
        self.dw_bn = TBatchNorm(c1, 1.0, snn)
        self.f1 = Conv_3(c1, mlp_ratio * c1, 1, 1, snn=snn)
        self.f2 = Conv_3(c1, mlp_ratio * c1, 1, 1, snn=snn)
        self.g = Conv_4(mlp_ratio * c1, c2, 1, 1, snn=snn)
        self.dw2_act = MemUpdate(c2, snn=snn)
        self.dw2 = DepthWiseConv(c2, c2, k, 1, p)
        self.dw2_bn = TBatchNorm(c2, 0.2, snn)
        self.drop = DropPath(drop_path)
        self.sc_act = self.sc_conv = self.sc_bn = None
        if s != 1 or c1 != c2:
            self.sc_act = MemUpdate(c1, snn=snn)
            self.sc_conv = SnnConv(c1, c2, 1, 1, 0, bias=True)
            self.sc_bn = TBatchNorm(c2, 1.0, snn)

    def forward(self, x):
        y = self.dw_bn(self.dw(self.dw_act(x)))
        y = self.g(F.relu6(self.f1(y)) * self.f2(y))
        y = self.drop(self.dw2_bn(self.dw2(self.dw2_act(y))))
        if self.sc_act is None:
            return x + y
        return self.sc_bn(self.sc_conv(self.sc_act(max_pool_t(x, self.s)))) + y


# --- ASFF fusion (reference :5051-5100) --------------------------------------------


class ASFF2(nn.Module):
    """Adaptive fusion of two pyramid levels (reference ASFF2).  The input is
    ``[x0, x1]``, x0 the deeper (smaller, ``c0`` channels), x1 the shallower
    (twice the side, ``c1`` channels); ``level`` 0 fuses at x0's resolution
    and width, 1 at x1's.  Per-pixel weights of the two come from a softmax
    over a 1x1 conv of two ``GSConv`` summaries (16 channels each, 8 with
    ``rfb``).  As a YAML row (registry ``ASFF2``) its args are ``[level,
    rfb]`` and its output has the fused level's width."""

    def __init__(self, level: int, c0: int, c1: int, rfb: bool = False,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.level = level
        inter = c0 if level == 0 else c1
        if level == 0:
            self.stride1 = Conv_3(c1, inter, 3, 2, snn=snn)
        else:
            self.compress0 = Conv_3(c0, inter, 1, 1, snn=snn)
        cc = 8 if rfb else 16
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


class ASFF3(nn.Module):
    """Adaptive fusion of three pyramid levels (reference ASFF3).  The input
    is ``[x0, x1, x2]``, deepest first (``c0``, ``c1``, ``c2`` channels,
    each level twice the side of the one before); ``level`` picks the
    output's resolution and width ``inter``.  The other two levels are
    brought there by ``Conv_5`` rows: at level 0 ``s1`` (3x3, stride 2) of
    x1 and ``s2`` (3x3, stride 2) of x2 max-pooled by 2; at level 1 ``c0``
    (1x1) of x0 upsampled 2x and ``s2`` of x2; at level 2 ``c0`` upsampled
    4x and ``c1`` (1x1) of x1 upsampled 2x.  ``w0`` / ``w1`` / ``w2``
    (``Conv_5`` 1x1 to 16 channels, 8 with ``rfb``) and ``wl`` (a 1x1 conv
    with bias to 3) give per-pixel softmax weights of the three; the sum
    goes through ``expand`` (``Conv_6`` 3x3).  As a YAML row its args are
    ``[level, rfb]``."""

    def __init__(self, level: int, c0: int, c1: int, c2: int, rfb: bool = False,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.level = level
        inter = (c0, c1, c2)[level]
        if level == 0:
            self.s1 = Conv_5(c1, inter, 3, 2, snn=snn)
        else:
            self.c0 = Conv_5(c0, inter, 1, 1, snn=snn)
        if level == 2:
            self.c1 = Conv_5(c1, inter, 1, 1, snn=snn)
        else:
            self.s2 = Conv_5(c2, inter, 3, 2, snn=snn)
        cc = 8 if rfb else 16
        self.w0, self.w1, self.w2 = (Conv_5(inter, cc, 1, 1, snn=snn) for _ in range(3))
        self.wl = SnnConv(3 * cc, 3, 1, bias=True)
        self.expand = Conv_6(inter, inter, 3, 1, snn=snn)

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        x0, x1, x2 = xs
        if self.level == 0:
            r = [x0, self.s1(x1), self.s2(max_pool_t(x2, 2))]
        elif self.level == 1:
            r = [interpolate_nearest(self.c0(x0), 2), x1, self.s2(x2)]
        else:
            r = [interpolate_nearest(self.c0(x0), 4), interpolate_nearest(self.c1(x1), 2), x2]
        wts = self.wl(torch.cat([self.w0(r[0]), self.w1(r[1]), self.w2(r[2])], dim=-1))
        wts = torch.softmax(wts, dim=-1)
        return self.expand(r[0] * wts[..., 0:1] + r[1] * wts[..., 1:2] + r[2] * wts[..., 2:3])


# --- YOLOv9 wiring (reference :327-345, :3678) ------------------------------------


class Silence(nn.Module):
    """Identity (reference Silence, used by the YOLOv9 graphs)."""

    def forward(self, x):
        return x


class CBLinear(nn.Module):
    """A conv with bias (k x k, stride s) to ``sum(c2s)`` channels, split into
    a list of channel groups of ``c2s`` (reference CBLinear)."""

    def __init__(self, c1: int, c2s: Sequence[int], k: int = 1, s: int = 1,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.c2s = tuple(c2s)
        self.conv = SnnConv(c1, sum(self.c2s), k, s, bias=True)

    def forward(self, x):
        return list(torch.split(self.conv(x), self.c2s, dim=-1))


class CBFuse(nn.Module):
    """Fuse ``CBLinear`` outputs (reference CBFuse): from each earlier input
    (a list) its group ``idx[i]``, resized to the last input's H x W by
    nearest neighbour as ``jax.image.resize`` indexes (half-pixel centres,
    ``nn/segment.resize_nearest``; ``F.interpolate`` picks other pixels when
    the ratio is not whole), summed, plus the last input."""

    def __init__(self, idx: Sequence[int] = ()):
        super().__init__()
        self.idx = tuple(idx)

    def forward(self, xs):
        target = xs[-1]
        hw = tuple(target.shape[2:4])
        outs = []
        for i, x in enumerate(xs[:-1]):
            sel = x[self.idx[i]] if isinstance(x, (list, tuple)) else x
            if tuple(sel.shape[2:4]) != hw:
                sel = resize_nearest(sel, hw, axes=(-3, -2))
            outs.append(sel)
        return sum(outs) + target


# --- EMA multi-scale attention (reference :3124-3156) -----------------------------


class EMAAttention(nn.Module):
    """Efficient multi-scale attention over ``factor`` groups (reference EMA;
    registry name ``EMA``).  As the JAX block, the groups are a plain
    reshape of ``[N, H, W, C]`` to ``[N * factor, H, W, C / factor]``; means
    over W and over H through the shared ``conv1x1``, sigmoid gates, a
    per-(sample, channel) norm over H x W (population variance, eps 1e-5,
    ``gn_scale`` / ``gn_bias``), ``conv3x3``, and two softmax-weighted
    sums over the channels give a per-pixel sigmoid gate on the input."""

    def __init__(self, c1: int, factor: int = 8, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.factor = factor
        cg = c1 // factor
        self.conv1x1 = SnnConv(cg, cg, 1)
        self.conv3x3 = SnnConv(cg, cg, 3, 1, 1)
        self.gn_scale = nn.Parameter(torch.ones(cg))
        self.gn_bias = nn.Parameter(torch.zeros(cg))

    def forward(self, x):
        t, b, h, w, c = x.shape
        g = self.factor
        cg = c // g
        gx = x.reshape(t, b * g, h, w, cg)
        x_h = gx.mean(dim=3, keepdim=True)                    # [t, bg, h, 1, cg]
        x_w = gx.mean(dim=2, keepdim=True).transpose(2, 3)    # [t, bg, w, 1, cg]
        hw = self.conv1x1(torch.cat([x_h, x_w], dim=2))
        x_h2, x_w2 = hw[:, :, :h], hw[:, :, h:].transpose(2, 3)
        x1 = gx * torch.sigmoid(x_h2) * torch.sigmoid(x_w2)
        mean = x1.mean(dim=(2, 3), keepdim=True)
        var = x1.var(dim=(2, 3), unbiased=False, keepdim=True)
        x1 = (x1 - mean) / torch.sqrt(var + 1e-5) * self.gn_scale.to(x1.dtype) \
            + self.gn_bias.to(x1.dtype)
        x2 = self.conv3x3(gx)
        x11 = torch.softmax(x1.mean(dim=(2, 3)), dim=-1)     # [t, bg, cg]
        x12 = x2.reshape(t, b * g, h * w, cg)
        x21 = torch.softmax(x2.mean(dim=(2, 3)), dim=-1)
        x22 = x1.reshape(t, b * g, h * w, cg)
        weights = (torch.einsum("tgc,tgnc->tgn", x11, x12)
                   + torch.einsum("tgc,tgnc->tgn", x21, x22)).reshape(t, b * g, h, w, 1)
        return (gx * torch.sigmoid(weights)).reshape(t, b, h, w, c)


# --- RepVGG / RT-DETR neck (reference common2.py:335-560) --------------------------


class RepConv(nn.Module):
    """Rep-style double branch (reference RepConv): one ``act`` neuron, then
    ``conv1`` (3x3, stride s) -> ``bn1`` plus ``conv2`` (1x1, stride s) ->
    ``bn2``, plus ``id_bn`` of the input when ``use_id_bn`` is set and
    ``c1 == c2``, ``s == 1``.  ``k`` is the JAX block's field, unused
    there too (the branches are 3x3 and 1x1)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, use_id_bn: bool = False,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.id_bn = (TBatchNorm(c1, 1.0, snn) if use_id_bn and c1 == c2 and s == 1
                      else None)
        self.act = MemUpdate(c1, snn=snn)
        self.conv1 = SnnConv(c1, c2, 3, s, 1)
        self.bn1 = TBatchNorm(c2, 1.0, snn)
        self.conv2 = SnnConv(c1, c2, 1, s, 0)
        self.bn2 = TBatchNorm(c2, 1.0, snn)

    def forward(self, x):
        id_out = None if self.id_bn is None else self.id_bn(x)
        y = self.act(x)
        out = self.bn1(self.conv1(y)) + self.bn2(self.conv2(y))
        return out if id_out is None else out + id_out


class RepC3(nn.Module):
    """Rep CSP block of the RT-DETR neck (reference RepC3): ``cv1``
    (``Conv_2`` 1x1 to c2) -> n ``RepConv`` (``m0`` ...), plus ``cv2``
    (``Conv_2`` 1x1 of the input), and ``cv3`` (``Conv_2`` 1x1) only when
    ``c2 * e != c2``.  The YAML's repeat count is ``n`` (``parse_model``
    inserts it, as JAX's does)."""

    def __init__(self, c1: int, c2: int, n: int = 3, e: float = 1.0,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        self.cv1 = Conv_2(c1, c2, 1, 1, snn=snn)
        for i in range(n):
            self.add_module(f"m{i}", RepConv(c2 if i == 0 else c_, c_, snn=snn))
        self.cv2 = Conv_2(c1, c2, 1, 1, snn=snn)
        self.cv3 = Conv_2(c2, c2, 1, 1, snn=snn) if c_ != c2 else None

    def forward(self, x):
        y1 = self.cv1(x)
        for i in range(self.n):
            y1 = getattr(self, f"m{i}")(y1)
        y = y1 + self.cv2(x)
        return y if self.cv3 is None else self.cv3(y)


class TokenLIF(nn.Module):
    """Plain-LIF activation for token tensors ``[T, N, L, C]`` (JAX
    ``TokenLIF``: always ``lif_scan(act=False)``, whatever ``snn.ecs``
    says).  Eval without autograd takes ``snn/fused.lif_fused`` (any dense
    shape behind T), training or autograd on ``lif_scan``.  No parameters
    and no state across calls: one module serves several sites."""

    def __init__(self, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.snn = snn

    def forward(self, x):
        if x.device.type == "meta":
            return torch.empty(x.shape, dtype=x.dtype, device=x.device)
        if not self.training and not torch.is_grad_enabled():
            return lif_fused(x.contiguous(), self.snn, False)
        return lif_scan(x, self.snn, False)


def sincos_pos_embed_2d(w: int, h: int, dim: int, temperature: float = 10000.0,
                        device=None) -> torch.Tensor:
    """2-D sine-cosine position embedding ``[1, w * h, dim]`` in float32
    (reference common2.py:545-560).  The grid is ``meshgrid(w, h,
    indexing="ij")``, so the rows run w-major, as in JAX."""
    if dim % 4:
        raise ValueError(f"sincos_pos_embed_2d: dim must be a multiple of 4, got {dim}")
    f32 = torch.float32
    gw, gh = torch.meshgrid(torch.arange(w, dtype=f32, device=device),
                            torch.arange(h, dtype=f32, device=device), indexing="ij")
    pos_dim = dim // 4
    omega = torch.arange(pos_dim, dtype=f32, device=device) / pos_dim
    omega = 1.0 / (temperature ** omega)
    out_w = gw.reshape(-1)[:, None] * omega[None]
    out_h = gh.reshape(-1)[:, None] * omega[None]
    return torch.cat([torch.sin(out_w), torch.cos(out_w), torch.sin(out_h),
                      torch.cos(out_h)], dim=1)[None]


class _MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` with its defaults: ``query``,
    ``key``, ``value`` and ``out`` projections with bias (flax kernels
    ``[C, heads, head_dim]`` and ``[heads, head_dim, C]``, here
    ``nn.Linear``), the query divided by ``sqrt(head_dim)`` before the
    product, softmax over the keys in the input's dtype.  JAX computes this
    outside any Pallas kernel; here it is ``torch.matmul`` and ``softmax``."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        if c % num_heads:
            raise ValueError(f"{c} channels do not split into {num_heads} heads")
        self.h = num_heads
        self.query, self.key, self.value, self.out = (nn.Linear(c, c) for _ in range(4))

    def forward(self, q_in, k_in, v_in):
        b, length, c = q_in.shape
        h, d = self.h, c // self.h
        q = self.query(q_in).view(b, length, h, d).transpose(1, 2)
        k = self.key(k_in).view(b, length, h, d).transpose(1, 2)
        v = self.value(v_in).view(b, length, h, d).transpose(1, 2)
        w = torch.softmax(torch.matmul(q / math.sqrt(d), k.transpose(-1, -2)), dim=-1)
        return self.out(torch.matmul(w, v).transpose(1, 2).reshape(b, length, c))


class _LayerNorm(nn.Module):
    """flax ``LayerNorm`` with its defaults: eps 1e-6, statistics in at least
    float32 with the fast variance ``max(0, E[x^2] - E[x]^2)``; the result
    in the input's dtype.  In float64 everything stays float64."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        dt = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(dt)
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp(min=0)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(dt)
        return ((xf - mean) * mul + self.bias.to(dt)).to(x.dtype)


class AIFI(nn.Module):
    """RT-DETR intra-scale transformer encoder (reference AIFI): a spiking
    encoder layer over the H*W tokens with the 2-D sin-cos position
    embedding.  The neuron (one ``TokenLIF``, ``act``, applied at six
    points) runs over the true T axis (the reference flattens t into the
    batch; JAX does not).  As in JAX, the embedding's rows are w-major and
    the tokens ``x.reshape(t, n, h * w, c)`` h-major; they are added as they
    are.  ``cm`` is the feed-forward width."""

    def __init__(self, c1: int, cm: int = 2048, num_heads: int = 8,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.act = TokenLIF(snn)
        self.ma = _MultiHeadAttention(c1, num_heads)
        self.norm1 = _LayerNorm(c1)
        self.norm2 = _LayerNorm(c1)
        self.fc1 = nn.Linear(c1, cm)
        self.fc2 = nn.Linear(cm, c1)

    def forward(self, x):
        t, n, h, w, c = x.shape
        pos = sincos_pos_embed_2d(w, h, c, device=x.device)
        act = self.act
        src = act(x.reshape(t, n, h * w, c))
        q = src + pos[None].expand(t, n, h * w, c).to(src.dtype)
        attn = self.ma(q.reshape(t * n, h * w, c), q.reshape(t * n, h * w, c),
                       src.reshape(t * n, h * w, c)).reshape(t, n, h * w, c)
        src = src + act(attn)
        src = act(self.norm1(act(src)))
        y = act(self.fc2(act(self.fc1(src))))
        src = self.norm2(src + y)
        return src.reshape(t, n, h, w, c)


# --- squeeze-excitation, BoTNet and DSSA attention (reference :2603-2759, :3329-3406, :3984)


class SELayer(nn.Module):
    """Squeeze-and-excitation (reference SELayer): the mean over H x W,
    ``fc1`` (to ``C // reduction``, no bias), ReLU, ``fc2`` (to C, no bias),
    sigmoid, times the input.  The flax ``Dense`` kernels ``[in, out]`` are
    ``nn.Linear`` weights (``models/convert.py``)."""

    def __init__(self, c1: int, reduction: int = 16, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.fc1 = nn.Linear(c1, c1 // reduction, bias=False)
        self.fc2 = nn.Linear(c1 // reduction, c1, bias=False)

    def forward(self, x):
        s = torch.sigmoid(self.fc2(torch.relu(self.fc1(x.mean(dim=(2, 3))))))
        return x * s[:, :, None, None, :]


class MHSA(nn.Module):
    """Spiking multi-head self-attention (reference MHSA): the input through
    the neuron ``m``; q, k and v each ``{q,k,v}_conv`` (1x1 to c2) ->
    ``_bn`` -> ``_act`` (an ECS neuron, so its spikes are K1's in eval);
    per head of ``c2 / num_heads`` channels the linear attention ``q (kᵀ v)
    * 0.125`` over the H*W tokens; ``attn_act`` (``TokenLIF``: K6 in eval)
    on the ``[T, N, H*W, c2]`` output; ``proj_conv`` (1x1 with bias) ->
    ``proj_bn``."""

    def __init__(self, c1: int, c2: int, num_heads: int = 8, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.nh = num_heads
        self.m = MemUpdate(c1, snn=snn)
        for name in "qkv":
            self.add_module(f"{name}_conv", SnnConv(c1, c2, 1))
            self.add_module(f"{name}_bn", TBatchNorm(c2, 1.0, snn))
            self.add_module(f"{name}_act", MemUpdate(c2, snn=snn))
        self.attn_act = TokenLIF(snn)
        self.proj_conv = SnnConv(c2, c2, 1, bias=True)
        self.proj_bn = TBatchNorm(c2, 1.0, snn)

    def forward(self, x):
        t, b, h, w, _ = x.shape
        c2 = self.proj_conv.out_channels
        s = self.m(x)

        def heads(name):        # [T, N, heads, H*W, d]
            y = getattr(self, f"{name}_act")(getattr(self, f"{name}_bn")(
                getattr(self, f"{name}_conv")(s)))
            return y.reshape(t, b, h * w, self.nh, c2 // self.nh).transpose(2, 3)

        q, k, v = heads("q"), heads("k"), heads("v")
        kv = torch.einsum("tbhnd,tbhne->tbhde", k, v)
        out = torch.einsum("tbhnd,tbhde->tbhne", q, kv) * 0.125
        out = self.attn_act(out.transpose(2, 3).reshape(t, b, h * w, c2))
        return self.proj_bn(self.proj_conv(out.reshape(t, b, h, w, c2)))


class BottleneckTransformer(nn.Module):
    """MHSA bottleneck (reference BottleneckTransformer): ``cv1_act`` ->
    ``cv1_conv`` (1x1 to ``c2 * expansion``) -> ``cv1_bn`` -> ``mhsa``
    (``heads`` heads, to c2), average-pooled 2x2 per step at ``s == 2``;
    plus the input when ``c1 == c2`` and ``s == 1``."""

    def __init__(self, c1: int, c2: int, s: int = 1, heads: int = 4,
                 expansion: float = 1.0, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c_ = int(c2 * expansion)
        self.s = s
        self.add = c1 == c2 and s == 1
        self.cv1_act = MemUpdate(c1, snn=snn)
        self.cv1_conv = SnnConv(c1, c_, 1, 1)
        self.cv1_bn = TBatchNorm(c_, 1.0, snn)
        self.mhsa = MHSA(c_, c2, heads, snn=snn)

    def forward(self, x):
        y = self.mhsa(self.cv1_bn(self.cv1_conv(self.cv1_act(x))))
        if self.s == 2:
            f, t = fold_t(y)
            y = unfold_t(_nhwc(F.avg_pool2d(_nchw(f), 2, 2)), t)
        return x + y if self.add else y


class BoT3(nn.Module):
    """CSP block with transformer inners (reference BoT3): ``cv1`` (the
    ``cv1_act`` -> ``cv1_conv`` 1x1 to ``c2 * e`` -> ``cv1_bn`` branch) ->
    ``m0 ... m{n-1}`` (``BottleneckTransformer``, 4 heads, expansion
    ``e2``), beside the same ``cv2`` branch of the input; concatenated, then
    ``cv3_act`` -> ``cv3_conv`` (1x1 to c2) -> ``cv3_bn``.  ``w`` and ``h``
    are accepted and unused, as in JAX; the YAML's repeat count is ``n``."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5, e2: float = 1.0,
                 w: int = 20, h: int = 20, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        for name, ci, co in (("cv1", c1, c_), ("cv2", c1, c_), ("cv3", 2 * c_, c2)):
            self.add_module(f"{name}_act", MemUpdate(ci, snn=snn))
            self.add_module(f"{name}_conv", SnnConv(ci, co, 1, 1))
            self.add_module(f"{name}_bn", TBatchNorm(co, 1.0, snn))
        for i in range(n):
            self.add_module(f"m{i}", BottleneckTransformer(c_, c_, 1, 4, e2, snn=snn))

    def _branch(self, name: str, x):
        return getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(
            getattr(self, f"{name}_act")(x)))

    def forward(self, x):
        y1 = self._branch("cv1", x)
        for i in range(self.n):
            y1 = getattr(self, f"m{i}")(y1)
        return self._branch("cv3", torch.cat([y1, self._branch("cv2", x)], dim=-1))


class DSSA(nn.Module):
    """Dual spike-driven self-attention (reference DSSA) over the H*W = n
    tokens of ``[T, N, H, W, C]``, ``num_heads`` heads of d = C / heads
    channels.  ``act_in`` spikes the input (s); ``W`` (3x3 to 2C) -> ``norm``
    gives per head y1 and y2 (d channels each); the attention ``y1 sᵀ`` per
    head, scaled by ``rsqrt(max(firing_rate_x * d, 1e-6))``, goes through
    ``act_attn`` (``TokenLIF`` on ``[T, N, n * heads, n]``: K6 in eval);
    times y2, scaled by ``rsqrt(max(firing_rate_attn, 1e-6))``; then
    ``act_out`` -> ``Wproj`` (1x1 with bias) -> ``norm_proj``, plus the
    input.  The attention is n², so only a P5-sized site is realistic.

    ``firing_rate_x`` and ``firing_rate_attn`` (per head, initialised to
    0.01) are buffers, JAX's ``batch_stats``: in training each moves toward
    the step's mean spike rate with ``momentum`` before it scales, once a
    step (not while ``nn/blocks.checkpointed`` recomputes the forward, as
    ``_BN``'s statistics); in eval they stay.  The scales are cast to the
    input's dtype, so a bf16 forward stays bf16."""

    def __init__(self, c1: int, num_heads: int = 8, momentum: float = 0.999,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.nh, self.momentum = num_heads, momentum
        self.act_in = MemUpdate(c1, snn=snn)
        self.W = SnnConv(c1, 2 * c1, 3, 1, 1)
        self.norm = TBatchNorm(2 * c1, 1.0, snn)
        self.act_attn = TokenLIF(snn)
        self.act_out = MemUpdate(c1, snn=snn)
        self.Wproj = SnnConv(c1, c1, 1, bias=True)
        self.norm_proj = TBatchNorm(c1, 1.0, snn)
        self.register_buffer("firing_rate_x", torch.full((num_heads,), 0.01))
        self.register_buffer("firing_rate_attn", torch.full((num_heads,), 0.01))

    def _rate(self, buf: torch.Tensor, spikes: torch.Tensor) -> torch.Tensor:
        """``buf`` moved toward the per-head mean of ``spikes`` ``[T, N, n,
        heads, m]`` when it moves (see the class), then returned."""
        if self.training and not recomputing():
            with torch.no_grad():
                dims = (0, 1, 2, 4)     # the global batch's mean (mesh.data_parallel)
                cnt = spikes.numel() // spikes.shape[3] * mesh.data_size()
                cur = (spikes.mean(dim=dims) if mesh.data_size() == 1 else
                       mesh.data_sum(spikes.sum(dim=dims)) / cnt).to(buf.dtype)
                buf.copy_(buf * self.momentum + cur * (1 - self.momentum))
        return buf

    def forward(self, x):
        t, b, h, w, c = x.shape
        nh, n = self.nh, h * w
        d = c // nh
        s = self.act_in(x)
        y = self.norm(self.W(s)).reshape(t, b, n, nh, 2 * d)
        y1, y2 = y[..., :d], y[..., d:]
        st = s.reshape(t, b, n, nh, d)
        fr_x = self._rate(self.firing_rate_x, st)
        scale1 = torch.rsqrt((fr_x * d).clamp(min=1e-6)).to(x.dtype)
        attn = torch.einsum("tbnhd,tbmhd->tbnhm", y1, st) * scale1[:, None]
        attn = self.act_attn(attn.reshape(t, b, n * nh, n)).reshape(t, b, n, nh, n)
        fr_attn = self._rate(self.firing_rate_attn, attn)
        scale2 = torch.rsqrt(fr_attn.clamp(min=1e-6)).to(x.dtype)
        out = torch.einsum("tbnhm,tbmhd->tbnhd", attn, y2) * scale2[:, None]
        out = self.act_out(out.reshape(t, b, h, w, c).contiguous())
        return self.norm_proj(self.Wproj(out)) + x
