"""Detection heads (counterpart of ``ecs_yolo_tpu/nn/heads.py``).

* ``Detect``: the v1 anchor head with its learned Conv_7 T-collapse.
* ``DDetect``: the anchor-free DFL head with spiking ``Conv_B`` towers and a
  mean over T; ``DualDDetect`` / ``TripleDDetect`` its deep-supervision
  forms (two / three branches over 2 / 3 groups of input levels);
  ``DualDetect`` / ``TripleDetect`` the same with plain ``Conv`` towers.
* ``v10Detect``: the NMS-free head, a one2many branch and a one2one branch
  fed by detached features.
* ``ASFF_DDetect`` / ``ASFF_v10Detect``: the input pyramid fused level by
  level (``nn/blocks_ext.ASFF2``) before ``DDetect`` / ``v10Detect``.

Every head takes a list of ``[T, N, H, W, C]`` maps.  The anchor-free heads
return, in training mode, per-level ``[N, no, h, w]`` maps (``no = nc + 4 *
reg_max``; a tuple of such lists for the dual and triple heads, a
``V10Output`` for v10); in eval ``(y, maps)`` with ``y`` ``[N, 4+nc, A]``
decoded xywh boxes in input pixels and class probabilities (v10:
``V10Output(one2many=maps, one2one=(y, maps))``).  Module names are the
JAX package's (``cv2_0``, ``a_cv3_1``, ``one2one_cv2_0``, ``asff0``,
``det``), so ``models/convert.py`` maps the JAX tree onto them path for path.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any, List, NamedTuple, Sequence

import torch
from torch import nn

from ..config import DEFAULT_SNN, SNNConfig
from ..ops.anchors import dist2bbox, make_anchors, make_grid_v1
from .blocks import DFL, Conv, Conv_7, Conv_B, SnnConv


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


def make_divisible(x, divisor: int) -> int:
    return math.ceil(x / divisor) * divisor


def _mean_t(x: torch.Tensor) -> torch.Tensor:
    """Rate-code collapse: the mean over T."""
    return x.mean(0)


def _dfl_tower(c1: int, c2: int, reg_max: int, snn: SNNConfig) -> nn.Sequential:
    """Box tower: Conv_B -> Conv_B (4 groups) -> 1x1 SnnConv(4 * reg_max, 4
    groups)."""
    return nn.Sequential(Conv_B(c1, c2, 3, snn=snn), Conv_B(c2, c2, 3, g=4, snn=snn),
                         SnnConv(c2, 4 * reg_max, 1, g=4, bias=True))


def _cls_tower(c1: int, c3: int, nc: int, snn: SNNConfig) -> nn.Sequential:
    """Class tower: Conv_B -> Conv_B -> 1x1 SnnConv(nc)."""
    return nn.Sequential(Conv_B(c1, c3, 3, snn=snn), Conv_B(c3, c3, 3, snn=snn),
                         SnnConv(c3, nc, 1, bias=True))


def _v10_cls_tower(c1: int, c3: int, nc: int, snn: SNNConfig) -> nn.Sequential:
    """v10's light class tower: (depthwise 3x3 Conv_B -> 1x1 Conv_B) x2 ->
    1x1 SnnConv(nc)."""
    return nn.Sequential(OrderedDict([
        ("0_0", Conv_B(c1, c1, 3, g=c1, snn=snn)), ("0_1", Conv_B(c1, c3, 1, snn=snn)),
        ("1_0", Conv_B(c3, c3, 3, g=c3, snn=snn)), ("1_1", Conv_B(c3, c3, 1, snn=snn)),
        ("2", SnnConv(c3, nc, 1, bias=True))]))


def _dfl_tower_plain(c1: int, c2: int, reg_max: int, snn: SNNConfig) -> nn.Sequential:
    """Plain box tower: Conv -> Conv -> 1x1 SnnConv(4 * reg_max)."""
    return nn.Sequential(Conv(c1, c2, 3, snn=snn), Conv(c2, c2, 3, snn=snn),
                         SnnConv(c2, 4 * reg_max, 1, bias=True))


def _cls_tower_plain(c1: int, c3: int, nc: int, snn: SNNConfig) -> nn.Sequential:
    """Plain class tower: Conv -> Conv -> 1x1 SnnConv(nc)."""
    return nn.Sequential(Conv(c1, c3, 3, snn=snn), Conv(c3, c3, 3, snn=snn),
                         SnnConv(c3, nc, 1, bias=True))


def _add_branch(head: nn.Module, ch: Sequence[int], tag: str, nc: int, reg_max: int,
                snn: SNNConfig, plain: bool = False) -> None:
    """The towers ``{tag}cv2_i`` (box) and ``{tag}cv3_i`` (class) of one
    branch over the input channels ``ch``; the tower widths come from
    ``ch[0]``."""
    ch0 = ch[0]
    c3 = max(ch0, min(nc * 2, 128))
    if plain:
        c2 = max(ch0 // 4, reg_max * 4, 16)
        box, cls = _dfl_tower_plain, _cls_tower_plain
    else:
        c2 = make_divisible(max(ch0 // 4, reg_max * 4, 16), 4)
        box, cls = _dfl_tower, _cls_tower
    for i, c in enumerate(ch):
        head.add_module(f"{tag}cv2_{i}", box(c, c2, reg_max, snn))
        head.add_module(f"{tag}cv3_{i}", cls(c, c3, nc, snn))


def _run_branch(head: nn.Module, xs: Sequence[torch.Tensor], tag: str) -> List[torch.Tensor]:
    """Per level: both towers, each collapsed over T, concatenated to
    ``[N, no, h, w]``."""
    out = []
    for i, x in enumerate(xs):
        box = _mean_t(getattr(head, f"{tag}cv2_{i}")(x))
        cls = _mean_t(getattr(head, f"{tag}cv3_{i}")(x))
        out.append(torch.cat([box, cls], dim=-1).permute(0, 3, 1, 2))
    return out


def _decode_dfl(feats: Sequence[torch.Tensor], nc: int, reg_max: int,
                strides: Sequence[float], dfl: DFL) -> torch.Tensor:
    """Per-level ``[N, no, h, w]`` maps -> ``[N, 4+nc, A]``: DFL boxes as xywh
    in input pixels, then the class probabilities."""
    shapes = [(f.shape[2], f.shape[3]) for f in feats]
    n = feats[0].shape[0]
    no = nc + reg_max * 4
    flat = torch.cat([f.reshape(n, no, -1) for f in feats], dim=2)
    box, cls = flat[:, : reg_max * 4], flat[:, reg_max * 4:]
    anchor_points, stride_tensor = make_anchors(shapes, strides, 0.5, flat.dtype,
                                                flat.device)
    dbox = dist2bbox(dfl(box), anchor_points.T[None], xywh=True, dim=1)
    return torch.cat([dbox * stride_tensor.T[None], torch.sigmoid(cls)], dim=1)


class _DFLHead(nn.Module):
    """What the DFL heads share: their arguments ``(nc, reg_max, strides,
    ch)`` and the decode."""

    def __init__(self, nc: int, reg_max: int, strides: Sequence[float]):
        super().__init__()
        self.nc, self.reg_max = nc, reg_max
        self.no = nc + 4 * reg_max
        self.strides = [float(s) for s in strides]

    def decode(self, feats, dfl: DFL) -> torch.Tensor:
        return _decode_dfl(feats, self.nc, self.reg_max, self.strides, dfl)


class DDetect(_DFLHead):
    """Anchor-free DFL head: per level a box and a class tower of spiking
    ``Conv_B``, each collapsed over T."""

    def __init__(self, nc: int, reg_max: int, strides: Sequence[float],
                 ch: Sequence[int], snn: SNNConfig = DEFAULT_SNN):
        super().__init__(nc, reg_max, strides)
        _add_branch(self, ch, "", nc, reg_max, snn)
        self.dfl = DFL(reg_max)

    def forward(self, xs):
        feats = _run_branch(self, xs, "")
        if self.training:
            return feats
        return self.decode(feats, self.dfl), feats


class _MultiBranch(_DFLHead):
    """Deep supervision: ``len(tags)`` branches over as many groups of the
    input levels; eval decodes the last branch."""

    tags = ("a_", "b_")
    plain = False

    def __init__(self, nc: int, reg_max: int, strides: Sequence[float],
                 ch: Sequence[int], snn: SNNConfig = DEFAULT_SNN):
        super().__init__(nc, reg_max, strides)
        nl = len(ch) // len(self.tags)
        for k, tag in enumerate(self.tags):
            _add_branch(self, ch[k * nl:(k + 1) * nl], tag, nc, reg_max, snn, self.plain)
        self.add_module(f"dfl{len(self.tags)}", DFL(reg_max))

    def forward(self, xs):
        nl = len(xs) // len(self.tags)
        ds = tuple(_run_branch(self, xs[k * nl:(k + 1) * nl], tag)
                   for k, tag in enumerate(self.tags))
        if self.training:
            return ds
        return self.decode(ds[-1], getattr(self, f"dfl{len(self.tags)}")), ds


class DualDDetect(_MultiBranch):
    """Two DFL branches (aux over the first half of the inputs, main over the
    second); training ``(d1, d2)``, eval ``(y of d2, (d1, d2))``."""


class TripleDDetect(_MultiBranch):
    """Three DFL branches; eval decodes the last."""

    tags = ("a_", "b_", "c_")


class DualDetect(_MultiBranch):
    """``DualDDetect`` with plain ``Conv`` towers (SiLU neurons), each
    collapsed over T as the JAX head does."""

    plain = True


class TripleDetect(_MultiBranch):
    """``TripleDDetect`` with plain ``Conv`` towers."""

    tags = ("a_", "b_", "c_")
    plain = True


class V10Output(NamedTuple):
    """Output of the NMS-free heads."""

    one2many: Any
    one2one: Any


class v10Detect(_DFLHead):
    """NMS-free head: one2many towers (``cv2_i``, ``cv3_i``) and one2one
    towers (``one2one_cv2_i``, ``one2one_cv3_i``) fed by the detached
    inputs (JAX's ``stop_gradient``); both class towers are v10's light
    ones.  Eval decodes the one2one branch."""

    def __init__(self, nc: int, reg_max: int, strides: Sequence[float],
                 ch: Sequence[int], snn: SNNConfig = DEFAULT_SNN):
        super().__init__(nc, reg_max, strides)
        ch0 = ch[0]
        c2 = make_divisible(max(ch0 // 4, reg_max * 4, 16), 4)
        c3 = max(ch0, min(nc, 100))
        for tag in ("", "one2one_"):
            for i, c in enumerate(ch):
                self.add_module(f"{tag}cv2_{i}", _dfl_tower(c, c2, reg_max, snn))
                self.add_module(f"{tag}cv3_{i}", _v10_cls_tower(c, c3, nc, snn))
        self.dfl = DFL(reg_max)

    def forward(self, xs):
        one2many = _run_branch(self, xs, "")
        one2one = _run_branch(self, [x.detach() for x in xs], "one2one_")
        if self.training:
            return V10Output(one2many, one2one)
        return V10Output(one2many, (self.decode(one2one, self.dfl), one2one))


class _ASFFHead(nn.Module):
    """The input pyramid reversed (deepest first) and fused level by level
    by ``ASFF2`` (each level sees the levels fused before it), then the
    detection head ``det`` on the fused maps in the input order."""

    def __init__(self, ch: Sequence[int], snn: SNNConfig):
        from .blocks_ext import ASFF2

        super().__init__()
        rev = list(ch)[::-1]
        self.nl = len(rev)
        for i in range(self.nl):
            self.add_module(f"asff{i}", ASFF2(i, rev[0], rev[1], snn=snn))

    def forward(self, xs):
        xs = list(xs)[::-1]
        for i in range(self.nl):
            xs[i] = getattr(self, f"asff{i}")(xs)
        return self.det(xs[::-1])


class ASFF_DDetect(_ASFFHead):
    """``DDetect`` behind ASFF fusion."""

    def __init__(self, nc: int, reg_max: int, strides: Sequence[float],
                 ch: Sequence[int], snn: SNNConfig = DEFAULT_SNN):
        super().__init__(ch, snn)
        self.det = DDetect(nc, reg_max, strides, ch, snn)


class ASFF_v10Detect(_ASFFHead):
    """``v10Detect`` behind ASFF fusion."""

    def __init__(self, nc: int, reg_max: int, strides: Sequence[float],
                 ch: Sequence[int], snn: SNNConfig = DEFAULT_SNN):
        super().__init__(ch, snn)
        self.det = v10Detect(nc, reg_max, strides, ch, snn)
