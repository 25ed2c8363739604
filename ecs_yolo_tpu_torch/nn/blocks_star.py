"""The StarNet variants of the YAML zoo (counterpart of
``ecs_yolo_tpu/nn/blocks_star.py``): ``ClippedTPReLU``, ``StarBlock_4``,
``StarBlock_5`` and ``StarBlock_2C2f``.  ``StarBlock_2`` and ``DropPath``
live in ``nn/blocks_ext.py``, as in JAX; the other star blocks of that file
are not ported yet (ROADMAP Queue 1 item 11g-3).

Features are ``[T, N, H, W, C]``.  Children carry the JAX module names
(``f1_act``, ``f1_conv``, ``dw2_bn``, ``act``, ``cv``, ``m0``, ...), so
``models/convert.py`` maps the tree path for path.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import DEFAULT_SNN, SNNConfig
from .blocks import Conv_3, Conv_4, MemUpdate, SnnConv, TBatchNorm, max_pool_t
from .blocks_ext import DropPath, StarBlock_2, _split_inner


class ClippedTPReLU(nn.Module):
    """Per-channel PReLU clipped at 6 (reference ClippedTPReLU): ``weight``
    ``[C]`` (init 0.25), ``where(x >= 0, x, weight * x)`` then ``minimum(.,
    6)``.  ``torch.minimum`` splits a tie's gradient in halves, as
    ``lax.min`` does; the bound 6 is made on the input's device (a fill,
    no host-to-device copy, so a training step under
    ``set_sync_debug_mode("error")`` passes).  The reference loops over T;
    the op is the same at every step."""

    def __init__(self, c: int, init: float = 0.25):
        super().__init__()
        self.init = init
        self.weight = nn.Parameter(torch.full((c,), float(init)))

    def forward(self, x):
        y = torch.where(x >= 0, x, self.weight.to(x.dtype) * x)
        return torch.minimum(y, y.new_full((), 6.0))


class _StarBranches(nn.Module):
    """The two gated branches of ``StarBlock_4`` / ``_5``: ``f1`` and ``f2``
    (mem_update -> conv k, stride s -> BN, gammas thresh and 0.2 * thresh)
    of the input, ``act(f1) * f2`` (``ClippedTPReLU``), then ``dw2``
    (mem_update -> conv k -> BN 0.2 * thresh) and ``drop``.  Padding 1 for
    a 3x3, else 0."""

    def __init__(self, c1: int, c2: int, k: int, s: int, drop_path: float,
                 snn: SNNConfig):
        super().__init__()
        self.s = s
        pad = 1 if k == 3 else 0
        for tag, gamma in (("f1", 1.0), ("f2", 0.2)):
            setattr(self, f"{tag}_act", MemUpdate(c1, snn=snn))
            setattr(self, f"{tag}_conv", SnnConv(c1, c2, k, s, pad))
            setattr(self, f"{tag}_bn", TBatchNorm(c2, gamma, snn))
        self.act = ClippedTPReLU(c2)
        self.dw2_act = MemUpdate(c2, snn=snn)
        self.dw2_conv = SnnConv(c2, c2, k, 1, pad)
        self.dw2_bn = TBatchNorm(c2, 0.2, snn)
        self.drop = DropPath(drop_path)

    def branches(self, x):
        x1 = self.f1_bn(self.f1_conv(self.f1_act(x)))
        x2 = self.f2_bn(self.f2_conv(self.f2_act(x)))
        y = self.act(x1) * x2
        return self.drop(self.dw2_bn(self.dw2_conv(self.dw2_act(y))))


class StarBlock_4(_StarBranches):
    """Dual-branch star block with the ``ClippedTPReLU`` gate (reference
    StarBlock_4), plus the input, or at a stride or width change
    MaxPool(1,s,s) -> ``sc_act`` -> ``sc_conv`` (1x1, no bias) -> ``sc_bn``.
    ``mlp_ratio`` is the JAX block's field, unused there too."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, mlp_ratio: int = 3,
                 drop_path: float = 0.0, snn: SNNConfig = DEFAULT_SNN):
        super().__init__(c1, c2, k, s, drop_path, snn)
        self.sc_act = self.sc_conv = self.sc_bn = None
        if s != 1 or c1 != c2:
            self.sc_act = MemUpdate(c1, snn=snn)
            self.sc_conv = SnnConv(c1, c2, 1, 1, 0)
            self.sc_bn = TBatchNorm(c2, 1.0, snn)

    def forward(self, x):
        y = self.branches(x)
        if self.sc_act is None:
            return x + y
        return self.sc_bn(self.sc_conv(self.sc_act(max_pool_t(x, self.s)))) + y


class StarBlock_5(_StarBranches):
    """``StarBlock_4``'s branches with the EMS concat shortcut (reference
    StarBlock_5): ``cat([t, x])`` when ``c1 < c2``, ``t`` = ``sc_act`` ->
    ``sc_conv`` (1x1 to the ``c2 - c1`` new channels) -> ``sc_bn`` first,
    else x; max-pooled by s after the concat, then added."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, mlp_ratio: int = 3,
                 drop_path: float = 0.0, snn: SNNConfig = DEFAULT_SNN):
        super().__init__(c1, c2, k, s, drop_path, snn)
        self.sc_act = self.sc_conv = self.sc_bn = None
        if c1 < c2:
            self.sc_act = MemUpdate(c1, snn=snn)
            self.sc_conv = SnnConv(c1, c2 - c1, 1, 1, 0)
            self.sc_bn = TBatchNorm(c2 - c1, 1.0, snn)

    def forward(self, x):
        y = self.branches(x)
        sc = x
        if self.sc_act is not None:
            sc = torch.cat([self.sc_bn(self.sc_conv(self.sc_act(x))), x], dim=-1)
        return max_pool_t(sc, self.s) + y


class StarBlock_2C2f(nn.Module):
    """C2f over ``StarBlock_2`` stages (reference StarBlock_2C2f): at ``s ==
    2`` a ``cv`` (``Conv_3`` 3x3, stride 2, keeping the width) first;
    ``cv1`` (1x1 to ``2c``, ``c = c2 * e``) split in halves, ``m0 ...
    m{n-1}`` (``StarBlock_2(c, c, k, 1, mlp_ratio)``; ``drop_path`` does not
    reach them, as in JAX) chained on the second half, every piece
    concatenated, then ``cv2`` (1x1 ``Conv_4``).  The YAML passes ``n``
    itself (``parse_model`` inserts nothing)."""

    def __init__(self, c1: int, c2: int, n: int = 1, k: int = 3, s: int = 1,
                 mlp_ratio: int = 3, drop_path: float = 0.0, e: float = 0.5,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.c = c = int(c2 * e)
        self.n = n
        self.cv = Conv_3(c1, c1, 3, 2, snn=snn) if s == 2 else None
        self.cv1 = Conv_3(c1, 2 * c, 1, 1, snn=snn)
        for j in range(n):
            self.add_module(f"m{j}", StarBlock_2(c, c, k, 1, mlp_ratio, snn=snn))
        self.cv2 = Conv_4((2 + n) * c, c2, 1, snn=snn)

    def forward(self, x):
        if self.cv is not None:
            x = self.cv(x)
        return self.cv2(_split_inner(self, self.cv1(x), self.c))
