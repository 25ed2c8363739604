"""Plain PyTorch reference of the EMS-ResNet detectors the benchmark runs.

Written from the published description (EMS-YOLO, ICCV 2023, as forked in
ECS-YOLO: ``models/common.py`` ``mem_update``, ``Snn_Conv2d``,
``BatchNorm3d1/2``, ``BasicBlock_1/2``, ``Concat_res2``, ``Sample``,
``models/yolo.py`` ``Detect``), in float32, one time step at a time where
the recurrence needs it, with no kernel, no cache and no batching trick.  It
imports nothing of the program under test.

Layout: features are ``[T, N, C, H, W]``.  A convolution, a norm and a pool
act on every step alike, so they run over the T*N images of a map at once
(the same arithmetic as a loop over T).  The stem sees the same image at
every step, so it runs once and its output is repeated over T: exact.

Parameter and buffer names are those of the published modules
(``residual_function.N``, ``shortcut.N``, ``spread.0/1``, ``bn.bn``,
``m.i`` / ``w.i`` of the head), so one state dict made by the benchmark
loads into this model and into the program alike.

``quant`` (optional) is applied to every convolution's input and weight and
to each neuron's input and state: the precision control puts an fp8
rounding there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

#: the neuron kind the reference implements, and the keys of its constants
#: in a configuration's ``neuron`` (threshold, surrogate half-width, decay,
#: ECS gain alpha, feedback gain beta, ECS time constant)
KIND = "ECS-LIF"
CONSTANTS = ("thresh", "lens", "decay", "alpha", "beta", "ecs_tau")

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Neuron:
    thresh: float
    lens: float
    decay: float
    alpha: float
    beta: float
    ecs_tau: float


def neuron(spec: Dict) -> Neuron:
    """The constants of a configuration's ``neuron``; any other kind than
    ECS-LIF is refused, since the reference implements no other."""
    if spec.get("kind") != KIND:
        raise ValueError(f"the reference implements the {KIND} neuron only, "
                         f"not {spec.get('kind')!r}")
    missing = [k for k in CONSTANTS if k not in spec]
    if missing:
        raise ValueError(f"the neuron lacks {missing}")
    return Neuron(*(float(spec[k]) for k in CONSTANTS))


class _Spike(torch.autograd.Function):
    """Heaviside ``u > thresh`` with the rectangular surrogate gradient
    ``1[|u - thresh| < lens] / (2 lens)``; with ``spikes`` given, those
    spikes (another run's) with this run's surrogate: teacher forcing."""

    @staticmethod
    def forward(ctx, u, thresh, lens, spikes=None):
        ctx.save_for_backward((u - thresh).abs() < lens)
        ctx.lens = lens
        return (u > thresh).to(u.dtype) if spikes is None else spikes.to(u.dtype)

    @staticmethod
    def backward(ctx, g):
        (window,) = ctx.saved_tensors
        return g * window.to(g.dtype) / (2.0 * ctx.lens), None, None, None


def _conv(x, weight, bias, stride=1, padding=0, groups=1, quant: Quant = None):
    if quant is not None:
        x, weight = quant(x), quant(weight)
    return F.conv2d(x, weight, bias, stride, padding, 1, groups)


def _per_step(fn, x):
    """``fn`` over the T*N images of ``[T, N, C, H, W]``."""
    t, n = x.shape[:2]
    y = fn(x.reshape((t * n,) + tuple(x.shape[2:])))
    return y.reshape((t, n) + tuple(y.shape[1:]))


class Conv(nn.Module):
    """``Snn_Conv2d``: a 2-D convolution applied at every step."""

    def __init__(self, c1, c2, k, s=1, p=0, bias=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c2, c1, k, k))
        self.bias = nn.Parameter(torch.empty(c2)) if bias else None
        self.s, self.p = s, p

    def forward(self, x, quant: Quant = None):
        return _per_step(lambda y: _conv(y, self.weight, self.bias, self.s, self.p,
                                         quant=quant), x)


class _BN(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))


class TBN(nn.Module):
    """``BatchNorm3d1/2``: statistics per channel over (T, N, H, W), the
    biased variance; in training the running statistics move by
    ``momentum`` toward the batch's."""

    eps = 1e-5

    def __init__(self, c):
        super().__init__()
        self.bn = _BN(c)
        self.momentum = 0.1

    def forward(self, x, quant: Quant = None):
        b = self.bn
        dims = (0, 1, 3, 4)
        if self.training:
            m = x.mean(dims)
            v = (x * x).mean(dims) - m * m
            with torch.no_grad():
                b.running_mean.mul_(1 - self.momentum).add_(self.momentum * m)
                b.running_var.mul_(1 - self.momentum).add_(self.momentum * v)
        else:
            m, v = b.running_mean, b.running_var
        shape = (1, 1, -1, 1, 1)
        mul = torch.rsqrt(v + self.eps) * b.weight
        return (x - m.view(shape)) * mul.view(shape) + b.bias.view(shape)


class MemUpdate(nn.Module):
    """The ECS-LIF neuron (``mem_update``): per step i,

        mem_i   = mem_{i-1} * decay * (1 - spike_{i-1}) + x_i + beta * tanh(ecs_{i-1})
        spike_i = mem_i > thresh
        ecs_i   = alpha * pw1x1(dw3x3(spike_i)) + (1 - 1/tau) * ecs_{i-1}

    with the reset gate's spike detached.  ``spread.0`` is the depthwise
    3x3 and ``spread.1`` the pointwise 1x1, both with bias.

    Teacher forcing: with ``forced`` set (spikes ``[T, N, C, H, W]`` of the
    run being followed) the site emits those spikes, and its surrogate
    gradient is taken at its own membrane; with ``seen`` a list, each input
    is appended to it."""

    def __init__(self, c, nrn: Neuron):
        super().__init__()
        self.spread = nn.ModuleList([nn.Conv2d(c, c, 3, 1, 1, groups=c), nn.Conv2d(c, c, 1)])
        self.c, self.nrn = c, nrn
        self.forced: Optional[torch.Tensor] = None
        self.seen: Optional[List[torch.Tensor]] = None

    def forward(self, x, quant: Quant = None):
        if self.seen is not None:
            self.seen.append(x.detach())
        if self.forced is not None and self.forced.shape != x.shape:
            raise ValueError(f"forced spikes {tuple(self.forced.shape)} for an input "
                             f"{tuple(x.shape)}")
        if self.forced is not None and not torch.is_grad_enabled():
            return self.forced.to(x.dtype)
        if quant is not None:
            x = quant(x)
        dw, pw = self.spread

        def spread(s):
            d = _conv(s, dw.weight, dw.bias, 1, 1, self.c, quant)
            return _conv(d, pw.weight, pw.bias, quant=quant)

        nrn = self.nrn
        leak = 1.0 - 1.0 / nrn.ecs_tau
        mem = spike = ecs = torch.zeros_like(x[0])
        out = []
        q = quant or (lambda v: v)
        for t in range(x.shape[0]):
            mem = q(mem * nrn.decay * (1.0 - spike.detach()) + x[t] + nrn.beta * torch.tanh(ecs))
            spike = _Spike.apply(mem, nrn.thresh, nrn.lens,
                                 None if self.forced is None else self.forced[t])
            out.append(spike)
            if t < x.shape[0] - 1:
                ecs = q(nrn.alpha * spread(spike) + leak * ecs)
        return torch.stack(out)


class _MaxPool(nn.Module):
    def __init__(self, s):
        super().__init__()
        self.s = s

    def forward(self, x, quant: Quant = None):
        return x if self.s == 1 else _per_step(lambda y: F.max_pool2d(y, self.s, self.s), x)


def _chain(mods, x, quant):
    for m in mods:
        x = m(x, quant)
    return x


def _residual(c1, c2, k, s, c_mid, nrn):
    pad = 1 if k == 3 else 0
    return nn.ModuleList([MemUpdate(c1, nrn), Conv(c1, c_mid, k, s, pad), TBN(c_mid),
                          MemUpdate(c_mid, nrn), Conv(c_mid, c2, k, 1, pad), TBN(c2)])


def _shortcut(c1, c2, s, nrn):
    return nn.ModuleList([_MaxPool(s), MemUpdate(c1, nrn), Conv(c1, c2, 1), TBN(c2)])


class BasicBlock_2(nn.Module):
    """The MS block: (neuron -> conv -> BN) twice; shortcut identity or
    max-pool -> neuron -> 1x1 conv -> BN."""

    def __init__(self, c1, c2, k=3, s=1, c_mid=None, *, nrn: Neuron):
        super().__init__()
        self.residual_function = _residual(c1, c2, k, s, c_mid or c2, nrn)
        self.shortcut = _shortcut(c1, c2, s, nrn) if (s != 1 or c1 != c2) else None

    def forward(self, x, quant: Quant = None):
        y = _chain(self.residual_function, x, quant)
        return y + (x if self.shortcut is None else _chain(self.shortcut, x, quant))


class BasicBlock_1(BasicBlock_2):
    """The MS block with a 1024-wide middle (the detector's neck)."""

    def __init__(self, c1, c2, s=1, *, nrn: Neuron):
        super().__init__(c1, c2, 3, s, c_mid=1024, nrn=nrn)


class Concat_res2(nn.Module):
    """The EMS block: the MS residual plus
    ``maxpool(cat([BN(1x1 conv(neuron(x))), x]))`` as the shortcut."""

    def __init__(self, c1, c2, k=3, s=1, *, nrn: Neuron):
        super().__init__()
        self.s = s
        self.residual_function = _residual(c1, c2, k, s, c2, nrn)
        self.shortcut = (nn.ModuleList([MemUpdate(c1, nrn), Conv(c1, c2 - c1, 1), TBN(c2 - c1)])
                         if c1 < c2 else None)

    def forward(self, x, quant: Quant = None):
        y = _chain(self.residual_function, x, quant)
        if self.shortcut is not None:
            x = torch.cat([_chain(self.shortcut, x, quant), x], dim=2)
        return y + _MaxPool(self.s)(x)


class Conv_1(nn.Module):
    """The stem: conv -> BN, no neuron."""

    def __init__(self, c1, c2, k=1, s=1, *, nrn: Neuron = None):
        super().__init__()
        self.conv = Conv(c1, c2, k, s, k // 2)
        self.bn = TBN(c2)

    def forward(self, x, quant: Quant = None):
        return self.bn(self.conv(x, quant))


class Sample(nn.Module):
    def __init__(self, size=None, scale=2, mode="nearest"):
        super().__init__()
        self.scale = int(scale)

    def forward(self, x, quant: Quant = None):
        return _per_step(lambda y: F.interpolate(y, scale_factor=self.scale, mode="nearest"), x)


class Cat(nn.Module):
    def forward(self, xs, quant: Quant = None):
        return torch.cat(list(xs), dim=2)


class _Collapse(nn.Module):
    """The head's learned collapse over T (a ``Conv3d(T, 1, 1)``)."""

    def __init__(self, t):
        super().__init__()
        self.conv = nn.Module()
        self.conv.weight = nn.Parameter(torch.empty(1, t, 1, 1, 1))

    def forward(self, x):
        return torch.einsum("t,tnchw->nchw", self.conv.weight.reshape(-1), x)


class Detect(nn.Module):
    """v1 anchor head: per level a 1x1 conv at every step, the learned
    collapse over T, then ``[N, na, ny, nx, 5 + nc]`` raw maps (training) or
    the decode ``xy = (2 sig - 0.5 + grid) * stride``, ``wh = (2 sig)^2 *
    anchor``, scores ``sig`` as ``[N, A, 5 + nc]`` (eval)."""

    def __init__(self, nc, anchors_px, ch, t):
        super().__init__()
        self.nc, self.no, self.na = nc, nc + 5, len(anchors_px[0]) // 2
        self.anchors_px = [[float(v) for v in a] for a in anchors_px]
        self.strides: List[float] = []
        self.m = nn.ModuleList(Conv(c, self.no * self.na, 1, bias=True) for c in ch)
        self.w = nn.ModuleList(_Collapse(t) for _ in ch)

    def maps(self, xs, quant: Quant = None):
        out = []
        for i, x in enumerate(xs):
            y = self.w[i](self.m[i](x, quant))
            n, _, ny, nx = y.shape
            out.append(y.view(n, self.na, self.no, ny, nx).permute(0, 1, 3, 4, 2))
        return out

    def forward(self, xs, quant: Quant = None):
        maps = self.maps(xs, quant)
        if self.training:
            return maps
        z = []
        for i, y in enumerate(maps):
            n, na, ny, nx, no = y.shape
            s = self.strides[i]
            gy, gx = torch.meshgrid(torch.arange(ny, dtype=y.dtype, device=y.device),
                                    torch.arange(nx, dtype=y.dtype, device=y.device),
                                    indexing="ij")
            grid = torch.stack([gx, gy], -1)[None, None]
            anchor = torch.tensor(self.anchors_px[i], dtype=y.dtype,
                                  device=y.device).view(1, na, 1, 1, 2)
            sig = torch.sigmoid(y)
            xy = (sig[..., :2] * 2 - 0.5 + grid) * s
            wh = (sig[..., 2:4] * 2) ** 2 * anchor
            z.append(torch.cat([xy, wh, sig[..., 4:]], -1).reshape(n, -1, no))
        return torch.cat(z, 1)


BLOCKS = {"Conv_1": Conv_1, "BasicBlock_1": BasicBlock_1, "BasicBlock_2": BasicBlock_2,
          "Concat_res2": Concat_res2, "Sample": Sample}


def _make_divisible(x, d=8):
    return math.ceil(x / d) * d


class RefDetector(nn.Module):
    """The detector of a model dict (the YAML's ``nc``, ``depth_multiple``,
    ``width_multiple``, ``anchors``, ``backbone`` and ``head`` rows) at
    ``T`` steps, with the neuron of a configuration's ``neuron``."""

    def __init__(self, d: Dict, t: int, nrn: Dict):
        super().__init__()
        nrn = neuron(nrn)
        self.nrn = nrn
        gd, gw = d.get("depth_multiple", 1.0), d.get("width_multiple", 1.0)
        self.t = t
        chs: List[int] = []
        strides: List[float] = []
        self.rows = []
        layers = []
        for i, (f, n, name, args) in enumerate(d["backbone"] + d["head"]):
            args = [d["nc"] if a == "nc" else d["anchors"] if a == "anchors" else a
                    for a in args]
            n = max(round(n * gd), 1) if n > 1 else n
            c_in = 3 if i == 0 else (chs[f] if isinstance(f, int) else None)
            stride = 1.0 if i == 0 else strides[f if isinstance(f, int) else f[0]]
            if name == "Concat":
                c2 = sum(chs[x] for x in f)
                layer = Cat()
            elif name == "Detect":
                c2 = 0
                layer = Detect(args[0], args[1], [chs[x] for x in f], t)
                layer.strides = [strides[x] for x in f]
            elif name == "Sample":
                c2 = c_in
                layer = Sample(*args)
                stride /= layer.scale
            else:
                # the stride is the row's last positional argument for the
                # stem and the MS / EMS blocks (BasicBlock_1's only one)
                stride *= args[-1]
                c2 = _make_divisible(args[0] * gw, 8)
                copies = []
                for _ in range(n):
                    copies.append(BLOCKS[name](c_in, c2, *args[1:], nrn=nrn))
                    c_in = c2
                layer = copies[0] if n == 1 else nn.Sequential(*copies)
            layers.append(layer)
            self.rows.append((f, name))
            chs.append(c2)
            strides.append(stride)
        self.model = nn.ModuleList(layers)
        self.save = sorted({x % i for i, (f, _) in enumerate(self.rows)
                            for x in ([f] if isinstance(f, int) else f) if x != -1})
        self.remat = False

    def _call(self, layer, x, quant):
        if self.remat and torch.is_grad_enabled() and isinstance(x, torch.Tensor):
            # recomputed in the backward pass, so that a training forward of
            # a large batch fits; the BN running statistics then move twice,
            # which no comparison reads
            return checkpoint(layer, x, quant, use_reentrant=False)
        return layer(x, quant)

    def _walk(self, img, quant):
        x = self._call(self.model[0], img[None], quant)   # the stem once, then over T
        x = x.expand((self.t,) + tuple(x.shape[1:]))
        cache = {0: x} if 0 in self.save else {}
        for i in range(1, len(self.model)):
            f, name = self.rows[i]
            if f != -1:
                x = cache[f % i] if isinstance(f, int) else [x if j == -1 else cache[j % i]
                                                            for j in f]
            layer = self.model[i]
            for blk in (layer if isinstance(layer, nn.Sequential) else [layer]):
                x = self._call(blk, x, quant)
            if i in self.save:
                cache[i] = x
        return x

    def forward(self, img: torch.Tensor, quant: Quant = None):
        """``img`` ``[N, 3, H, W]`` in 0-1; eval: decoded ``[N, A, 5+nc]``,
        training: the raw maps per level."""
        return self._walk(img, quant)


def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    scale = torch.finfo(dtype).max / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    """Per-tensor scaled rounding to float8: e4m3 on the way forward, e5m2
    for the gradient on the way back (the usual split of fp8 training)."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """What computing in fp8 does to an operand: every convolution's input
    and weight, a neuron's input and its state after each step."""
    return _Fp8.apply(x)
