"""The last slice of the block library (counterpart of
``ecs_yolo_tpu/nn/blocks_tail2.py``, every block of it): the residual
variants ``BasicBlock_1n`` / ``BasicBlock_1m``, ``GN``, ``TPReLU``, the C2f
hybrids ``BasicBlock_2C2f`` / ``BasicBlock_1C2f`` / ``Concat_res2C2f``, the
attention tail ``Attention`` / ``OSRAAttention`` / ``DynamicConv2d`` /
``TransxnetHybridTokenMixer`` with ``adaptive_avg_pool_hw``, ``HetConv``,
``AKConv`` and the ResNet stages ``ResNetBlock`` / ``ResNetLayerBasic`` /
``ResNetLayerBo``.  ``BasicBlock_ms1`` of that file lives in
``nn/blocks_tail.py``.

Features are ``[T, N, H, W, C]``; children carry the JAX module names
(``bn0``, ``rep``, ``cv1``, ``m0``, ``conv0_1``, ``project_out``,
``sr_c1``, ``proj_c2``, ``local``, ``p_c3``, ``stem``, ``c3``, ...), so
``models/convert.py`` maps the tree path for path.  The neurons the JAX
blocks apply to token-shaped tensors (``lif_scan`` on ``OSRAAttention``'s
queries and attention map, ``DynamicConv2d``'s kernel and bias mixing
weights) are ``nn/blocks_ext.TokenLIF`` here: K6 in eval, as the ``AIFI`` /
``MHSA`` / ``DSSA`` token sites.  A channel half handed to a block is a
dense copy, so that its first neuron site takes the tensor-core kernel's
layout (``nn/blocks.MemUpdate``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DEFAULT_SNN, SNNConfig
from .blocks import (BasicBlock_1, BasicBlock_2, Concat_res2, Conv, Conv_1, Conv_3, MemUpdate,
                     SnnConv, TBatchNorm, _nchw, _nhwc, fold_t, max_pool_t, unfold_t)
from .blocks_ext import C3, GhostBottleneck, RepConv, TokenLIF, _C2fFrame


class BasicBlock_1n(nn.Module):
    """MS residual with a pre-BN entry and 1024 hidden channels (reference
    BasicBlock_1n): ``bn0`` -> ``act1`` -> ``conv1`` (3x3 to 1024, stride
    s) -> ``bn1`` (0.2 * thresh) -> ``act2`` -> ``conv2`` (3x3 to c2), no
    final BN; plus the input, or at a stride or width change MaxPool(1,s,s)
    -> ``sc_bn`` -> ``sc_act`` -> ``sc_conv`` (1x1), no final BN either.
    ``e`` is the JAX block's positional YAML slot, unused there too."""

    def __init__(self, c1: int, c2: int, s: int = 1, e: float = 0.5,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.s = s
        self.bn0 = TBatchNorm(c1, 1.0, snn)
        self.act1 = MemUpdate(c1, snn=snn)
        self.conv1 = SnnConv(c1, 1024, 3, s, 1)
        self.bn1 = TBatchNorm(1024, 0.2, snn)
        self.act2 = MemUpdate(1024, snn=snn)
        self.conv2 = SnnConv(1024, c2, 3, 1, 1)
        self.has_sc = s != 1 or c1 != c2
        if self.has_sc:
            self.sc_bn = TBatchNorm(c1, 1.0, snn)
            self.sc_act = MemUpdate(c1, snn=snn)
            self.sc_conv = SnnConv(c1, c2, 1, 1, 0)

    def forward(self, x):
        y = self.conv2(self.act2(self.bn1(self.conv1(self.act1(self.bn0(x))))))
        if not self.has_sc:
            return y + x
        return y + self.sc_conv(self.sc_act(self.sc_bn(max_pool_t(x, self.s))))


class BasicBlock_1m(nn.Module):
    """MS residual with a ``RepConv`` entry (reference BasicBlock_1m):
    ``rep`` (``RepConv`` to 1024, stride s) -> ``act2`` -> ``conv2`` (3x3
    to c2) -> ``bn2`` (0.2 * thresh); plus the input, or at a stride or
    width change MaxPool(1,s,s) -> ``sc_act`` -> ``sc_conv`` (1x1) ->
    ``sc_bn``.  ``e`` is the JAX block's positional YAML slot."""

    def __init__(self, c1: int, c2: int, s: int = 1, e: float = 0.5,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.s = s
        self.rep = RepConv(c1, 1024, 3, s, snn=snn)
        self.act2 = MemUpdate(1024, snn=snn)
        self.conv2 = SnnConv(1024, c2, 3, 1, 1)
        self.bn2 = TBatchNorm(c2, 0.2, snn)
        self.has_sc = s != 1 or c1 != c2
        if self.has_sc:
            self.sc_act = MemUpdate(c1, snn=snn)
            self.sc_conv = SnnConv(c1, c2, 1, 1, 0)
            self.sc_bn = TBatchNorm(c2, 1.0, snn)

    def forward(self, x):
        y = self.bn2(self.conv2(self.act2(self.rep(x))))
        if not self.has_sc:
            return y + x
        return y + self.sc_bn(self.sc_conv(self.sc_act(max_pool_t(x, self.s))))


class _GroupNorm(nn.Module):
    """flax ``GroupNorm`` over ``[B, H, W, C]``: ``num_groups`` groups of
    contiguous channels, each normalised over (H, W, its channels) with the
    population variance and eps 1e-6; statistics in at least float32,
    ``weight`` / ``bias`` (flax's ``scale`` / ``bias``) per channel, the
    result cast back to the input's dtype."""

    def __init__(self, c: int, num_groups: int, eps: float = 1e-6):
        super().__init__()
        if c % num_groups:
            raise ValueError(f"GN: {num_groups} groups do not divide {c} channels")
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        dt = torch.promote_types(x.dtype, torch.float32)
        b, h, w, c = x.shape
        xg = x.to(dt).reshape(b, h, w, self.num_groups, c // self.num_groups)
        mean = xg.mean(dim=(1, 2, 4), keepdim=True)
        var = (xg * xg).mean(dim=(1, 2, 4), keepdim=True) - mean * mean
        y = ((xg - mean) * torch.rsqrt(var.clamp(min=0) + self.eps)).reshape(b, h, w, c)
        return (y * self.weight.to(dt) + self.bias.to(dt)).to(x.dtype)


class GN(nn.Module):
    """GroupNorm over the channel axis of ``[T, N, H, W, C]`` (reference
    GN): ``gn`` (``_GroupNorm``, ``num_groups`` 16) with T folded into the
    batch.  ``nn.GroupNorm``'s eps would be 1e-5; flax's is 1e-6."""

    def __init__(self, c1: int, num_groups: int = 16):
        super().__init__()
        self.gn = _GroupNorm(c1, num_groups)

    def forward(self, x):
        y, t = fold_t(x)
        return unfold_t(self.gn(y), t)


class TPReLU(nn.Module):
    """Per-channel PReLU over ``[T, N, H, W, C]`` (reference TPReLU):
    ``weight`` ``[C]`` (init 0.25), ``where(x >= 0, x, weight * x)``.  The
    reference loops over T; the op is the same at every step."""

    def __init__(self, c: int, init: float = 0.25):
        super().__init__()
        self.init = init
        self.weight = nn.Parameter(torch.full((c,), float(init)))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


# --- C2f hybrids (reference :3168-3263) ---------------------------------------------


class BasicBlock_2C2f(_C2fFrame):
    """C2f over ``BasicBlock_2(c, c, k)`` stages (reference BasicBlock_2C2f):
    the C2f frame (``_C2fFrame``, ``c = c2 // 2``) with a ``cv`` pre-stride
    at ``s == 2`` and a ``Conv_4`` merge.  ``add`` is the JAX block's field,
    unused there too."""

    def __init__(self, c1: int, c2: int, n: int = 1, add=True, k: int = 3, s: int = 1,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__(c1, c2, n, lambda c: BasicBlock_2(c, c, k, 1, snn=snn), snn,
                         pre_stride=s == 2)


class BasicBlock_1C2f(_C2fFrame):
    """C2f over ``BasicBlock_1(c, c)`` stages (1024 hidden), a pre-stride at
    ``s == 2`` and a ``Conv_3`` merge (reference BasicBlock_1C2f)."""

    def __init__(self, c1: int, c2: int, n: int = 1, s: int = 1,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__(c1, c2, n, lambda c: BasicBlock_1(c, c, 1, snn=snn), snn,
                         pre_stride=s == 2, merge=Conv_3)


class Concat_res2C2f(_C2fFrame):
    """C2f over ``Concat_res2(c, c, k)`` stages, a ``Conv_3`` merge and no
    pre-stride (reference Concat_res2C2f).  The reference's ``s=2`` cannot
    run (its strided stages no longer concatenate with the halves; JAX
    asserts ``s == 1``): ``s != 1`` raises ``ValueError``."""

    def __init__(self, c1: int, c2: int, n: int = 1, k: int = 3, s: int = 1,
                 snn: SNNConfig = DEFAULT_SNN):
        if s != 1:
            raise ValueError(f"Concat_res2C2f: the reference defines s=1 only, got s={s}")
        super().__init__(c1, c2, n, lambda c: Concat_res2(c, c, k, 1, snn=snn), snn,
                         merge=Conv_3)


# --- the attention tail (reference :3264-3577) --------------------------------------


class Attention(nn.Module):
    """Dual-axis strip-conv attention (reference Attention): x = ``m_in``'s
    spikes; of ``norm1(x)``, three pairs of depthwise strips ``conv{j}_1``
    (1 x k) and ``conv{j}_2`` (k x 1) at k = 7, 11, 21, each followed by
    its neuron (``conv{j}_1m`` / ``conv{j}_2m``); ``project_out`` (1x1 with
    bias, one conv applied four times) of the row strips' sum -> ``m1`` and
    of the column strips' sum -> ``m2``; per head, row attention ``q1 k1^T
    v1 + q1`` (q from ``m2``, k and v from ``m1``, over H with W folded
    into the features) and column attention (q from ``m1``, k and v from
    ``m2``, over W), no softmax; ``project_out`` of each, summed, plus the
    spikes x (JAX rebinds x to ``m_in``'s output)."""

    KS = (7, 11, 21)

    def __init__(self, c1: int, num_heads: int = 8, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        if c1 % num_heads:
            raise ValueError(f"Attention: {num_heads} heads do not divide {c1} channels")
        self.hd = num_heads
        self.m_in = MemUpdate(c1, snn=snn)
        self.norm1 = TBatchNorm(c1, 1.0, snn)
        for j, k in enumerate(self.KS):
            self.add_module(f"conv{j}_1", SnnConv(c1, c1, (1, k), 1, (0, k // 2), g=c1))
            self.add_module(f"conv{j}_1m", MemUpdate(c1, snn=snn))
            self.add_module(f"conv{j}_2", SnnConv(c1, c1, (k, 1), 1, (k // 2, 0), g=c1))
            self.add_module(f"conv{j}_2m", MemUpdate(c1, snn=snn))
        self.project_out = SnnConv(c1, c1, 1, 1, bias=True)
        self.m1 = MemUpdate(c1, snn=snn)
        self.m2 = MemUpdate(c1, snn=snn)

    def forward(self, x):
        t, n, h, w, c = x.shape
        hd = self.hd
        x = self.m_in(x)
        x1 = self.norm1(x)
        rows = sum(getattr(self, f"conv{j}_1m")(getattr(self, f"conv{j}_1")(x1))
                   for j in range(len(self.KS)))
        cols = sum(getattr(self, f"conv{j}_2m")(getattr(self, f"conv{j}_2")(x1))
                   for j in range(len(self.KS)))
        out1 = self.m1(self.project_out(rows))
        out2 = self.m2(self.project_out(cols))

        def heads_h(z):         # t n h w (hd c) -> t n hd h (w c)
            return z.reshape(t, n, h, w, hd, c // hd).permute(0, 1, 4, 2, 3, 5).reshape(
                t, n, hd, h, -1)

        def heads_w(z):         # t n h w (hd c) -> t n hd w (h c)
            return z.reshape(t, n, h, w, hd, c // hd).permute(0, 1, 4, 3, 2, 5).reshape(
                t, n, hd, w, -1)

        q1, kv1 = heads_h(out2), heads_h(out1)
        q2, kv2 = heads_w(out1), heads_w(out2)
        out3 = (q1 @ kv1.transpose(-1, -2)) @ kv1 + q1
        out4 = (q2 @ kv2.transpose(-1, -2)) @ kv2 + q2
        out3 = out3.reshape(t, n, hd, h, w, c // hd).permute(0, 1, 3, 4, 2, 5).reshape(
            t, n, h, w, c)
        out4 = out4.reshape(t, n, hd, w, h, c // hd).permute(0, 1, 4, 3, 2, 5).reshape(
            t, n, h, w, c)
        return self.project_out(out3) + self.project_out(out4) + x


class OSRAAttention(nn.Module):
    """Overlapping spatial-reduction attention (reference OSRA): x =
    ``m_in``'s spikes; queries ``q`` (1x1 with bias) per head, a dense
    ``[T, N, heads, H*W, head_dim]`` copy, through ``q_act`` (``TokenLIF``);
    keys and values from x, at ``sr_ratio > 1``
    first reduced by ``sr_m1`` -> ``sr_c1`` (depthwise ``sr_ratio + 3``
    wide, stride ``sr_ratio``) -> ``sr_bn1`` -> ``sr_m2`` -> ``sr_c2`` (1x1
    depthwise) -> ``sr_bn2`` (0.2 * thresh); then ``m_kv`` ->
    ``local_conv`` (3x3 depthwise with bias) plus its input -> ``m_kv2`` ->
    ``kv`` (1x1 to 2C with bias), split into k and v; the attention map ``q
    k^T * head_dim^-0.5`` through ``attn_act`` (``TokenLIF``), times v."""

    def __init__(self, c1: int, num_heads: int = 1, sr_ratio: int = 1,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.hd, self.sr = num_heads, sr_ratio
        self.scale = (c1 // num_heads) ** -0.5
        self.m_in = MemUpdate(c1, snn=snn)
        self.q = SnnConv(c1, c1, 1, 1, bias=True)
        self.q_act = TokenLIF(snn)
        if sr_ratio > 1:
            k = sr_ratio + 3
            self.sr_m1 = MemUpdate(c1, snn=snn)
            self.sr_c1 = SnnConv(c1, c1, k, sr_ratio, k // 2, g=c1)
            self.sr_bn1 = TBatchNorm(c1, 1.0, snn)
            self.sr_m2 = MemUpdate(c1, snn=snn)
            self.sr_c2 = SnnConv(c1, c1, 1, 1, g=c1)
            self.sr_bn2 = TBatchNorm(c1, 0.2, snn)
        self.m_kv = MemUpdate(c1, snn=snn)
        self.local_conv = SnnConv(c1, c1, 3, 1, 1, g=c1, bias=True)
        self.m_kv2 = MemUpdate(c1, snn=snn)
        self.kv = SnnConv(c1, 2 * c1, 1, 1, bias=True)
        self.attn_act = TokenLIF(snn)

    def forward(self, x):
        t, n, h, w, c = x.shape
        hd, dh = self.hd, c // self.hd
        x = self.m_in(x)
        q = self.q(x).reshape(t, n, h * w, hd, dh).permute(0, 1, 3, 2, 4)   # [t,n,hd,HW,dh]
        q = self.q_act(q.contiguous())
        kv = x
        if self.sr > 1:
            kv = self.sr_bn1(self.sr_c1(self.sr_m1(kv)))
            kv = self.sr_bn2(self.sr_c2(self.sr_m2(kv)))
        kv = self.m_kv(kv)
        kv = self.kv(self.m_kv2(self.local_conv(kv) + kv))
        hw2 = kv.shape[2] * kv.shape[3]
        k = kv[..., :c].reshape(t, n, hw2, hd, dh).permute(0, 1, 3, 4, 2)   # [t,n,hd,dh,HW']
        v = kv[..., c:].reshape(t, n, hw2, hd, dh).permute(0, 1, 3, 2, 4)   # [t,n,hd,HW',dh]
        attn = self.attn_act((q @ k) * self.scale)
        return (attn @ v).permute(0, 1, 3, 2, 4).reshape(t, n, h, w, c)


def adaptive_avg_pool_hw(x: torch.Tensor, out: int) -> torch.Tensor:
    """``AdaptiveAvgPool2d(out)`` over the H, W of ``[..., H, W, C]``: window
    i spans ``[floor(i * H / out), ceil((i + 1) * H / out))``, as torch's
    and JAX's ``adaptive_avg_pool_hw``; one mean a window, concatenated."""

    def pool_axis(z, size, dim):
        return torch.cat([z.narrow(dim, (i * size) // out,
                                   -(-((i + 1) * size) // out) - (i * size) // out)
                          .mean(dim, keepdim=True) for i in range(out)], dim=dim)

    return pool_axis(pool_axis(x, x.shape[-3], x.dim() - 3), x.shape[-2], x.dim() - 2)


def _same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one axis: ``ceil(size / s)`` outputs, the
    padding split with the odd pixel after (at stride 2 on an even map,
    (0, 1) for a 3x3, where ``padding=1`` would give (1, 1))."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class DynamicConv2d(nn.Module):
    """Input-conditioned depthwise conv, IDConv (reference DynamicConv2d):
    x = ``m_in``'s spikes; ``num_groups`` kernel banks ``weight`` ``[g,
    kk, kk, C]`` mixed by a gating branch on x's ``kk x kk`` adaptive
    average (``proj_m1`` -> ``proj_c1`` (1x1 to C / reduction, bias) ->
    ``proj_bn`` -> ``proj_m2`` -> ``proj_c2`` (1x1 to C * g, bias) ->
    ``scale_act`` (``TokenLIF``)), one kernel per (t, n, channel); at
    ``use_bias`` the bias banks ``bias`` ``[g, C]`` mixed the same way on
    x's mean (the ``projb_*`` branch, ``bias_act``).  The per-sample
    depthwise conv runs as one grouped conv of ``T * N * C`` groups, "SAME"
    padded (``_same_pad``), its output made ``[T, N, H, W, C]``-dense for
    the neuron sites behind it.  ``weight`` and ``bias`` start as flax's
    ``truncated_normal(0.02)`` (``models/yolo.init_weights``)."""

    def __init__(self, c1: int, kernel_size: int = 3, reduction_ratio: int = 4,
                 num_groups: int = 2, use_bias: bool = True, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.kk, self.g = kernel_size, num_groups
        cr = c1 // reduction_ratio
        self.weight = nn.Parameter(torch.zeros(num_groups, kernel_size, kernel_size, c1))
        self.m_in = MemUpdate(c1, snn=snn)
        for tag in ("proj", "projb") if use_bias else ("proj",):
            self.add_module(f"{tag}_m1", MemUpdate(c1, snn=snn))
            self.add_module(f"{tag}_c1", SnnConv(c1, cr, 1, 1, bias=True))
            self.add_module(f"{tag}_bn", TBatchNorm(cr, 1.0, snn))
            self.add_module(f"{tag}_m2", MemUpdate(cr, snn=snn))
            self.add_module(f"{tag}_c2", SnnConv(cr, c1 * num_groups, 1, 1, bias=True))
        self.scale_act = TokenLIF(snn)
        self.bias = nn.Parameter(torch.zeros(num_groups, c1)) if use_bias else None
        self.bias_act = TokenLIF(snn) if use_bias else None

    def _gating(self, z, tag: str):
        for suffix in ("m1", "c1", "bn", "m2", "c2"):
            z = getattr(self, f"{tag}_{suffix}")(z)
        return z

    def forward(self, x):
        t, n, h, w, c = x.shape
        kk, g = self.kk, self.g
        x = self.m_in(x)
        scale = self.scale_act(self._gating(adaptive_avg_pool_hw(x, kk), "proj"))
        weight = torch.einsum("tnxyge,gxye->tnxye", scale.reshape(t, n, kk, kk, g, c),
                              self.weight.to(x.dtype))                   # [t,n,kk,kk,c]
        xi = x.permute(0, 1, 4, 2, 3).reshape(1, t * n * c, h, w)
        wi = weight.permute(0, 1, 4, 2, 3).reshape(t * n * c, 1, kk, kk)
        (pt, pb), (pl, pr) = _same_pad(h, kk, 1), _same_pad(w, kk, 1)
        y = F.conv2d(F.pad(xi, (pl, pr, pt, pb)), wi, groups=t * n * c)
        y = y.reshape(t, n, c, h, w).permute(0, 1, 3, 4, 2).contiguous()
        if self.bias is None:
            return y
        bs = self.bias_act(self._gating(x.mean(dim=(2, 3), keepdim=True), "projb"))
        bias = torch.einsum("tnge,ge->tne", bs.reshape(t, n, g, c), self.bias.to(x.dtype))
        return y + bias[:, :, None, None, :]


class TransxnetHybridTokenMixer(nn.Module):
    """D-Mixer (reference TransxnetHybridTokenMixer): ``local``
    (``DynamicConv2d`` at reduction 4) of a dense copy of the first channel
    half and ``global`` (``OSRAAttention``) of the second, concatenated (y);
    then ``p_m1`` -> ``p_c1`` (3x3 depthwise, bias) -> ``p_bn1`` -> ``p_m2``
    -> ``p_c2`` (1x1 to ``max(16, C // reduction_ratio)``, bias) -> ``p_bn2``
    -> ``p_m3`` -> ``p_c3`` (1x1 back to C, bias) -> ``p_bn3`` (0.2 *
    thresh), plus y."""

    def __init__(self, c1: int, kernel_size: int = 3, num_groups: int = 2,
                 num_heads: int = 1, sr_ratio: int = 1, reduction_ratio: int = 8,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        if c1 % 2:
            raise ValueError(f"TransxnetHybridTokenMixer: C must be even, got {c1}")
        half, inner = c1 // 2, max(16, c1 // reduction_ratio)
        self.local = DynamicConv2d(half, kernel_size, 4, num_groups, snn=snn)
        self.add_module("global", OSRAAttention(half, num_heads, sr_ratio, snn=snn))
        self.p_m1 = MemUpdate(c1, snn=snn)
        self.p_c1 = SnnConv(c1, c1, 3, 1, 1, g=c1, bias=True)
        self.p_bn1 = TBatchNorm(c1, 1.0, snn)
        self.p_m2 = MemUpdate(c1, snn=snn)
        self.p_c2 = SnnConv(c1, inner, 1, 1, bias=True)
        self.p_bn2 = TBatchNorm(inner, 1.0, snn)
        self.p_m3 = MemUpdate(inner, snn=snn)
        self.p_c3 = SnnConv(inner, c1, 1, 1, bias=True)
        self.p_bn3 = TBatchNorm(c1, 0.2, snn)

    def forward(self, x):
        half = x.shape[-1] // 2
        y = torch.cat([self.local(x[..., :half].contiguous()),
                       getattr(self, "global")(x[..., half:].contiguous())], dim=-1)
        z = y
        for name in ("p_m1", "p_c1", "p_bn1", "p_m2", "p_c2", "p_bn2", "p_m3", "p_c3",
                     "p_bn3"):
            z = getattr(self, name)(z)
        return z + y


# --- HetConv, AKConv and the ResNet stages -------------------------------------------


def hetconv_mask(c1: int, c2: int, p: int) -> torch.Tensor:
    """The reference's cyclic 3x3 / 1x1 pattern ``[c2, c1]`` (1 = a 3x3
    pair, JAX ``_hetconv_mask``): row k is the base pattern rotated right k
    times; the base has a 3x3 every ``1 + (c1 - c1 // p) // max(c1 // p,
    1)`` inputs, ``c1 // p`` of them."""
    num_k3 = c1 // p
    interval = (c1 - num_k3) // max(num_k3, 1)
    base = torch.zeros(c1)
    base[[j * (1 + interval) for j in range(num_k3) if j * (1 + interval) < c1]] = 1.0
    return torch.stack([base.roll(k) for k in range(c2)])


class HetConv(nn.Module):
    """Heterogeneous conv (reference HetConv): each (out, in) pair a 3x3 or
    a 1x1 kernel in ``hetconv_mask``'s cyclic pattern, computed as one 3x3
    conv (``[c2, c1, 3, 3]``) whose off-centre taps are zero for the
    1x1 pairs (``weight`` here, JAX's ``w3``), plus ``bias``; stride s with
    XLA's "SAME" padding (``_same_pad``).  The tap mask ``taps`` is a
    buffer made once (not in
    the state dict; ``models/yolo.init_weights`` makes it again after a
    build on the meta device), so a forward copies nothing from the host."""

    def __init__(self, c1: int, c2: int, s: int = 1, p: int = 4,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.c1, self.c2, self.s, self.p = c1, c2, s, p
        self.weight = nn.Parameter(torch.zeros(c2, c1, 3, 3))
        self.bias = nn.Parameter(torch.zeros(c2))
        self.register_buffer("taps", self.make_taps(), persistent=False)

    def make_taps(self) -> torch.Tensor:
        """``[c2, c1, 3, 3]``: 1 at every tap of a 3x3 pair, the centre alone
        of a 1x1 pair."""
        m = hetconv_mask(self.c1, self.c2, self.p)[:, :, None, None]
        centre = torch.zeros(3, 3)
        centre[1, 1] = 1.0
        return m + (1.0 - m) * centre

    def forward(self, x):
        y, t = fold_t(x)
        (pt, pb), (pl, pr) = _same_pad(y.shape[1], 3, self.s), _same_pad(y.shape[2], 3, self.s)
        w = (self.weight * self.taps).to(y.dtype)
        y = F.conv2d(_nchw(F.pad(y, (0, 0, pl, pr, pt, pb))), w, self.bias.to(y.dtype), self.s)
        return unfold_t(_nhwc(y), t)


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


class ResNetLayerBo(nn.Module):
    """ResNet stage with a C3 body (reference ResNetLayerBo): with
    ``is_first`` the ``stem`` (``Conv_1`` 7x7, stride 2, padding 3) and a
    2x2 max pool, else ``c3`` (``C3(c1, c2, n)``); k, s and e unused, as in
    JAX."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, is_first: bool = False,
                 n: int = 1, e: int = 4, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.stem = Conv_1(c1, c2, 7, 2, 3, snn=snn) if is_first else None
        self.c3 = None if is_first else C3(c1, c2, n, snn=snn)

    def forward(self, x):
        if self.stem is not None:
            return max_pool_t(self.stem(x), 2)
        return self.c3(x)


class ResNetBlock(nn.Module):
    """Bottleneck ResNet block (reference ResNetBlock): ``cv1`` (``Conv``
    1x1 to c2) -> ``cv2`` (``Conv`` 3x3, stride s) -> ``cv3`` (``Conv_1``
    1x1 to ``e * c2``), plus the input, or at a stride or width change
    ``shortcut`` (``Conv_1`` 1x1, stride s); a ReLU of the sum.  The output
    is ``e * c2`` wide where the parser records c2 (``build_layers`` builds
    the next layer from the tensor)."""

    def __init__(self, c1: int, c2: int, s: int = 1, e: int = 4,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c3 = e * c2
        self.cv1 = Conv(c1, c2, 1, 1, snn=snn)
        self.cv2 = Conv(c2, c2, 3, s, 1, snn=snn)
        self.cv3 = Conv_1(c2, c3, 1, snn=snn)
        self.shortcut = Conv_1(c1, c3, 1, s, snn=snn) if s != 1 or c1 != c3 else None

    def forward(self, x):
        y = self.cv3(self.cv2(self.cv1(x)))
        return F.relu(y + (x if self.shortcut is None else self.shortcut(x)))


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
