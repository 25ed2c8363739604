"""Spiking blocks of the EMS-ResNet detect path (counterpart of
``ecs_yolo_tpu/nn/blocks.py``).

Features are ``[T, N, H, W, C]`` tensors, contiguous in that order.  Every
convolution, norm and pool folds T into the batch and runs once over
``[T*N, H, W, C]``: the NHWC memory is handed to the convolution as an NCHW
view in ``torch.channels_last`` format, so nothing is transposed in memory.
Only the membrane recurrence (``MemUpdate``) runs over T.

Parameter names follow the reference's torch modules
(``residual_function.N``, ``shortcut.N``, ``spread.0/1``, ``bn.bn``), so a
state_dict carries the reference names; ``models/convert.py`` maps the JAX
package's parameter tree onto them.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import DEFAULT_SNN, SNNConfig, autopad
from ..parallel import mesh
from ..snn.ecs_lif import ecs_lif_fused, layout_refusal
from ..snn.fused import ecs_lif_fused_rows, lif_fused
from ..snn.neuron import ecs_lif_scan, firing_rate, lif_scan, make_spread
from ..snn.spread import make_kernel_spread


def fold_t(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """[T,N,H,W,C] -> [T*N,H,W,C]."""
    t = x.shape[0]
    return x.reshape((t * x.shape[1],) + tuple(x.shape[2:])), t


def unfold_t(x: torch.Tensor, t: int) -> torch.Tensor:
    return x.reshape((t, x.shape[0] // t) + tuple(x.shape[1:]))


_RECOMPUTE = threading.local()


def recomputing() -> bool:
    """True while ``checkpointed`` recomputes a forward in the backward pass
    (on the thread that recomputes it)."""
    return getattr(_RECOMPUTE, "on", False)


@contextlib.contextmanager
def _recompute_scope():
    prev = recomputing()
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = prev


def _checkpoint_contexts():
    return contextlib.nullcontext(), _recompute_scope()


def checkpointed(fn: Callable, *args):
    """``fn(*args)`` whose activations are recomputed in the backward pass
    instead of kept (``torch.utils.checkpoint``, non-reentrant): the JAX
    package's ``jax.checkpoint`` / ``nn.remat``.

    JAX's recompute is functional, so the BN running statistics move once a
    step.  Here the forward is run a second time, and while it runs
    (``recomputing()``) every ``_BN`` leaves its running statistics alone and
    ``MemUpdate`` its ``firing_rate``: the first forward moved and set them.
    A kernel wrapper called in the recompute launches its kernel again and
    counts that launch too."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=_checkpoint_contexts)


def _nchw(y: torch.Tensor) -> torch.Tensor:
    """NHWC memory viewed as a channels_last NCHW tensor."""
    return y.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


class SnnConv(nn.Conv2d):
    """Conv2d over ``[T,N,H,W,C]`` (or ``[N,H,W,C]``) with T folded into the
    batch; the reference ``Snn_Conv2d`` without its per-step loop."""

    def __init__(self, c1: int, c2: int, k=1, s=1, p=None, g: int = 1,
                 bias: bool = False, dilation: int = 1):
        super().__init__(c1, c2, k, s, autopad(k, p), dilation, g, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 5:
            y, t = fold_t(x)
            return unfold_t(_nhwc(super().forward(_nchw(y))), t)
        return _nhwc(super().forward(_nchw(x)))


class _BN(nn.Module):
    """Per-channel batch norm with the reference's state names
    (``weight``, ``bias``, ``running_mean``, ``running_var``).  In training
    mode the running statistics move once a forward, and not while
    ``checkpointed`` recomputes it.

    Inside ``parallel/mesh.data_parallel`` over more than one data rank the
    training moments are the global batch's, as JAX's mesh-global
    ``_DetBN`` takes them: the local sum and sum of squares go through an
    all-reduce that carries the gradient (its backward sums the upstream
    gradient over the ranks), divided by the global count.  A recompute
    runs the same all-reduce again on every rank."""

    def __init__(self, c: int, gamma0: float, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.gamma0, self.eps, self.momentum = gamma0, eps, momentum
        self.weight = nn.Parameter(torch.full((c,), float(gamma0)))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x is channels-last; statistics and normalisation run in at least
        f32 and the result is cast back to x's dtype."""
        dt = torch.promote_types(x.dtype, torch.float32)
        if self.training:
            xf = x.to(dt)
            dims = tuple(range(x.dim() - 1))
            if mesh.data_size() > 1:
                cnt = xf.numel() // xf.shape[-1] * mesh.data_size()
                s = mesh.data_sum_grad(torch.stack([xf.sum(dims), (xf * xf).sum(dims)]))
                m = s[0] / cnt
                v = s[1] / cnt - m * m
            else:
                m = xf.mean(dims)
                v = (xf * xf).mean(dims) - m * m      # biased, as the JAX BN
            if not recomputing():
                with torch.no_grad():
                    self.running_mean.mul_(1 - self.momentum).add_(
                        self.momentum * m.to(self.running_mean.dtype))
                    self.running_var.mul_(1 - self.momentum).add_(
                        self.momentum * v.to(self.running_var.dtype))
        else:
            m, v = self.running_mean.to(dt), self.running_var.to(dt)
        mul = torch.rsqrt(v + self.eps) * self.weight.to(dt)
        # x - m promotes x to dt inside the subtraction (no separate cast pass)
        return ((x - m) * mul + self.bias.to(dt)).to(x.dtype)


class TBatchNorm(nn.Module):
    """Spatio-temporal BN: statistics over (T, N, H, W) per channel.

    ``gamma_scale`` 1.0 initialises gamma to ``thresh``, 0.2 to
    ``0.2 * thresh`` (the reference's BatchNorm3d1 / BatchNorm3d2).
    """

    def __init__(self, c: int, gamma_scale: float = 1.0,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.bn = _BN(c, gamma_scale * snn.thresh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x)


class MemUpdate(nn.Module):
    """The neuron activation (reference ``mem_update``): the ECS-LIF
    recurrence over T, owning the spread's depthwise 3x3 (``spread.0``) and
    pointwise 1x1 (``spread.1``) convolutions, both with bias; or, with
    ``snn.ecs=False``, the plain LIF recurrence without parameters.

    Eval without autograd takes one fused forward kernel per site:

    * ``snn.ecs=False``: ``snn/fused.lif_fused``;
    * ``snn.ecs=True``: ``snn/ecs_lif.ecs_lif_fused`` (tensor cores; wants
      ``C % 8 == 0`` and a dense, 16-byte aligned input), or
      ``snn/fused.ecs_lif_fused_rows`` (any shape and strides) when
      ``snn.fused_inference`` is set or the first refuses the input's layout
      (``snn/ecs_lif.layout_refusal``).

    Training mode, or autograd on, takes the T-loops of ``snn/neuron.py``:
    ``lif_scan``, or ``ecs_lif_scan`` whose spread runs on the spread kernels
    (``snn/spread.py``; an ``act=True`` site's SiLU output is not binary, so
    its spread is the library's convolutions).  No fused kernel has a
    backward.  On a CPU tensor every wrapper takes its plain version.

    The routes of the block library's sites: the SiLU sites of ``Conv`` and
    ``BasicBlock`` (``resnet18``, ``res18-sew``) take the tensor-core kernel
    in its ``act`` mode; the 3-channel site on the raw image at the head of
    ``res10-ee`` / ``res18-ee`` / ``res18-eebk`` (``Conv_2`` as the first
    row: x is the image broadcast over T, stride 0) takes
    ``ecs_lif_fused_rows``, which the tensor-core kernel's layout check
    sends it to, and in training the depthwise spread kernel on its channels
    zero-padded to 8; every other site of ``BasicBlock_ms``, ``ConcatBlock_ms``,
    ``RepConv``, ``RepC3`` and the v9 / EMA models has ``C % 8 == 0`` and
    takes the tensor-core kernel.  So does every site of the star, GSConv,
    context-guide, CSP, HG and Ghost blocks (``starnet*``, ``ceshi``,
    ``resnet_v8``, ``yolov5s``, ``yolov8s``, ``cspresnet10``, ``HGresnet``,
    ``test``: widths that are multiples of 8, up to 1024 at 20x20); there
    ``C2f`` and ``StarBlock_2C2f`` hand their first inner block a dense copy
    of the second half of ``cv1``'s output, because a channel slice is a
    strided view, which the tensor-core kernel's layout check would send to
    ``ecs_lif_fused_rows``; ``RepNCSPELAN4`` does the same for its ``csp0``,
    so every site of the registry rows without a YAML (``chip_smoke``'s
    two probe models) takes the tensor-core kernel too.  The token sites of
    ``AIFI``, ``MHSA`` and ``DSSA`` are not ``MemUpdate`` sites:
    ``nn/blocks_ext.TokenLIF`` sends them to ``lif_fused``.

    In training mode an ``act=False`` ECS-LIF site keeps its mean spike
    density in ``firing_rate``, a 0-d tensor on the device that costs no
    host sync until it is read.  With ``snn.remat_neuron`` the T-loop runs
    under ``checkpointed``: its activations are recomputed in the backward
    pass.
    """

    def __init__(self, c: int, act: bool = False, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.act, self.snn = act, snn
        self.firing_rate: Optional[torch.Tensor] = None
        # plain LIF (snn.ecs False) has no spread, as in the JAX module
        self.spread = nn.ModuleList([
            nn.Conv2d(c, c, 3, 1, 1, groups=c),
            nn.Conv2d(c, c, 1),
        ]) if snn.ecs else None

    def spread_params(self):
        """The spread parameters in the JAX shapes ([3,3,1,C], [C],
        [1,1,C,C], [C])."""
        dw, pw = self.spread
        return (dw.weight.permute(2, 3, 1, 0), dw.bias,
                pw.weight.permute(2, 3, 1, 0), pw.bias)

    def _eval_forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "meta":
            # the build's shape probe: a site's spikes have its input's shape
            return torch.empty(x.shape, dtype=x.dtype, device=x.device)
        if not self.snn.ecs:
            return lif_fused(x, self.snn, self.act)
        if self.snn.fused_inference or layout_refusal(x) is not None:
            fwd = ecs_lif_fused_rows
        else:
            fwd = ecs_lif_fused
        return fwd(x, *self.spread_params(), self.snn, self.act)

    def _lif(self, x: torch.Tensor) -> torch.Tensor:
        return lif_scan(x, self.snn, self.act)

    def _ecs_lif(self, x: torch.Tensor, *params: torch.Tensor) -> torch.Tensor:
        spread = make_spread(*params) if self.act else make_kernel_spread(*params)
        return ecs_lif_scan(x, spread, self.snn, self.act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training and not torch.is_grad_enabled():
            return self._eval_forward(x)
        # snn.remat_neuron: the recurrence is recomputed in the backward pass
        # (JAX wraps both scans in jax.checkpoint); the spread parameters are
        # cast outside it, so the recompute reads the tensors this forward read
        run = checkpointed if self.snn.remat_neuron else (lambda f, *a: f(*a))
        if not self.snn.ecs:
            return run(self._lif, x)
        spikes = run(self._ecs_lif, x, *(p.to(x.dtype) for p in self.spread_params()))
        if self.training and not self.act and not recomputing():
            self.firing_rate = firing_rate(spikes)
        return spikes


def max_pool_t(x: torch.Tensor, s: int) -> torch.Tensor:
    """MaxPool3d((1,s,s), stride (1,s,s)) on [T,N,H,W,C]: the EMS shortcut
    downsampler."""
    if s == 1:
        return x
    y, t = fold_t(x)
    return unfold_t(_nhwc(F.max_pool2d(_nchw(y), s, s)), t)


class _MaxPoolT(nn.Module):
    """``max_pool_t`` as a module, holding index 0 of a shortcut so the
    parameter indices after it match the reference's ``nn.Sequential``."""

    def __init__(self, s: int):
        super().__init__()
        self.s = s

    def forward(self, x):
        return max_pool_t(x, self.s)


class Sample(nn.Module):
    """Nearest-neighbour upsample per step. YAML args: [size, scale_factor,
    mode]."""

    def __init__(self, size: Optional[int] = None, scale_factor: int = 2,
                 mode: str = "nearest"):
        super().__init__()
        if mode != "nearest":
            raise NotImplementedError(f"Sample mode {mode!r}")
        self.f = int(scale_factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.repeat_interleave(self.f, dim=-3).repeat_interleave(self.f, dim=-2)


class Pools(nn.Module):
    """Per-step max pool (reference Pools): window k, stride s, padding p
    on both spatial axes (``F.max_pool2d`` pads with -inf, as flax's
    ``max_pool``).  YAML args: [k, s, p]."""

    def __init__(self, k: int, s: int, p: int = 0):
        super().__init__()
        self.k, self.s, self.p = k, s, p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, t = fold_t(x)
        return unfold_t(_nhwc(F.max_pool2d(_nchw(y), self.k, self.s, self.p)), t)


class ZeroPad(nn.Module):
    """Per-step zero padding (reference ``zeropad``); ``padding`` is (left,
    right, top, bottom), as in JAX."""

    def __init__(self, padding: Sequence[int]):
        super().__init__()
        self.padding = tuple(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        l, r, top, bottom = self.padding
        return F.pad(x, (0, 0, l, r, top, bottom))


class Concat(nn.Module):
    """Concatenate along channels (the reference's dim 2 of [T,N,C,H,W])."""

    def __init__(self, dimension: int = 2):
        super().__init__()

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat(list(xs), dim=-1)


class Conv_1(nn.Module):
    """conv -> BN, no activation: the stem of every EMS yaml."""

    def __init__(self, c1: int, c2: int, k=1, s=1, p=None, g: int = 1,
                 act_flag=None, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.conv = SnnConv(c1, c2, k, s, p, g)
        self.bn = TBatchNorm(c2, 1.0, snn)

    def forward(self, x):
        return self.bn(self.conv(x))


class Conv_A(nn.Module):
    """conv -> BN -> SiLU, no neuron (reference Conv_A).  ``act_flag`` is
    the JAX block's positional YAML slot, accepted and unused."""

    def __init__(self, c1: int, c2: int, k=1, s=1, p=None, g: int = 1,
                 act_flag=None, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.conv = SnnConv(c1, c2, k, s, p, g)
        self.bn = TBatchNorm(c2, 1.0, snn)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Conv_7(nn.Module):
    """Learned temporal collapse T -> 1: the reference's Conv3d(T, 1, 1), a
    weighted sum over T shared across (H, W, C).  Output [N,H,W,C]."""

    def __init__(self, t: int):
        super().__init__()
        self.conv = nn.Conv3d(t, 1, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.weight.reshape(-1).to(x.dtype)
        return torch.einsum("t,tnhwc->nhwc", w, x)


def _ems_residual(c1: int, c2: int, k: int, s: int, c_mid: int,
                  snn: SNNConfig) -> nn.ModuleList:
    """(mem_update -> conv -> BN) x2, BN gammas thresh then 0.2*thresh."""
    pad = 1 if k == 3 else 0
    return nn.ModuleList([
        MemUpdate(c1, snn=snn),
        SnnConv(c1, c_mid, k, s, pad),
        TBatchNorm(c_mid, 1.0, snn),
        MemUpdate(c_mid, snn=snn),
        SnnConv(c_mid, c2, k, 1, pad),
        TBatchNorm(c2, 0.2, snn),
    ])


def _run(seq, x):
    for m in seq:
        x = m(x)
    return x


class BasicBlock_1(nn.Module):
    """MS pre-act residual with a fixed 1024 hidden width; shortcut =
    identity, or MaxPool(1,s,s) -> mem_update -> 1x1 conv -> BN."""

    def __init__(self, c1: int, c2: int, s: int = 1,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.residual_function = _ems_residual(c1, c2, 3, s, 1024, snn)
        self.shortcut = None
        if s != 1 or c1 != c2:
            self.shortcut = nn.ModuleList([
                _MaxPoolT(s), MemUpdate(c1, snn=snn),
                SnnConv(c1, c2, 1, 1, 0), TBatchNorm(c2, 1.0, snn),
            ])

    def forward(self, x):
        y = _run(self.residual_function, x)
        return y + (x if self.shortcut is None else _run(self.shortcut, x))


class BasicBlock_2(nn.Module):
    """The EMS 'MS' block: (mem_update -> conv -> BN) x2; shortcut =
    identity, or MaxPool(1,s,s) -> mem_update -> 1x1 conv -> BN."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, add=True,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.residual_function = _ems_residual(c1, c2, k, s, c2, snn)
        self.shortcut = None
        if s != 1 or c1 != c2:
            self.shortcut = nn.ModuleList([
                _MaxPoolT(s), MemUpdate(c1, snn=snn),
                SnnConv(c1, c2, 1, 1, 0), TBatchNorm(c2, 1.0, snn),
            ])

    def forward(self, x):
        y = _run(self.residual_function, x)
        return y + (x if self.shortcut is None else _run(self.shortcut, x))


class Concat_res2(nn.Module):
    """The EMS 'EMS' block: the BasicBlock_2 residual plus a channel-expanding
    spike shortcut ``maxpool(cat([BN(1x1conv(mem_update(x))), x]))``."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.s = s
        self.residual_function = _ems_residual(c1, c2, k, s, c2, snn)
        self.shortcut = None
        if c1 < c2:
            self.shortcut = nn.ModuleList([
                MemUpdate(c1, snn=snn), SnnConv(c1, c2 - c1, 1, 1, 0),
                TBatchNorm(c2 - c1, 1.0, snn),
            ])

    def forward(self, x):
        y = _run(self.residual_function, x)
        if self.shortcut is not None:
            x = torch.cat([_run(self.shortcut, x), x], dim=-1)
        return y + max_pool_t(x, self.s)


class Conv(nn.Module):
    """conv -> BN -> mem_update(act=True), the SiLU neuron (reference Conv):
    the towers of the plain-``Conv`` dual and triple heads, and a YAML row
    (``resnet18``, ``res18-sew``).  ``ecs_flag`` is the JAX block's
    positional YAML slot, accepted and unused."""

    def __init__(self, c1: int, c2: int, k=1, s=1, p=None, g: int = 1,
                 ecs_flag=None, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.conv = SnnConv(c1, c2, k, s, p, g)
        self.bn = TBatchNorm(c2, 1.0, snn)
        self.act = MemUpdate(c2, act=True, snn=snn)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class _PreAct(nn.Module):
    """mem_update -> conv -> BN (gamma ``gamma_scale * thresh``).
    ``act_flag`` is the JAX blocks' positional YAML slot (``resnet_rtdetr``
    passes ``Conv_2`` six arguments), accepted and unused."""

    gamma_scale = 1.0

    def __init__(self, c1: int, c2: int, k=1, s=1, p=None, g: int = 1,
                 act_flag=None, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.act = MemUpdate(c1, snn=snn)
        self.conv = SnnConv(c1, c2, k, s, p, g)
        self.bn = TBatchNorm(c2, self.gamma_scale, snn)

    def forward(self, x):
        return self.bn(self.conv(self.act(x)))


class Conv_B(_PreAct):
    """mem_update -> conv -> BN: the towers of the DFL heads."""


class Conv_2(_PreAct):
    """mem_update -> conv -> BN (reference Conv_2)."""


class Conv_3(_PreAct):
    """Conv_2 under another name (reference Conv_3)."""


class Conv_4(_PreAct):
    """mem_update -> conv -> BN with gamma 0.2 * thresh (reference Conv_4)."""

    gamma_scale = 0.2


class BasicBlock(nn.Module):
    """The SEW post-act residual (reference BasicBlock): ``cv1`` (``Conv``,
    ``c2 * e`` channels, k, s) and ``cv2`` (``Conv`` 3x3), both SiLU
    neurons; shortcut = identity, or ``shortcut_conv`` (1x1, stride s) ->
    ``shortcut_bn`` when ``s != 1`` or ``c1 != c2``."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, e: float = 0.5,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k, s, snn=snn)
        self.cv2 = Conv(c_, c2, 3, 1, snn=snn)
        self.shortcut_conv = self.shortcut_bn = None
        if s != 1 or c1 != c2:
            self.shortcut_conv = SnnConv(c1, c2, 1, s)
            self.shortcut_bn = TBatchNorm(c2, 1.0, snn)

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        if self.shortcut_conv is None:
            return y + x
        return y + self.shortcut_bn(self.shortcut_conv(x))


class DepthWiseConv(nn.Module):
    """Depthwise k x k (``depth``, one group a channel, padding ``p``) then
    pointwise 1x1 (``point``), both with bias when ``use_bias`` (reference
    DepthWiseConv); no neuron and no norm of its own.  ``snn`` is the JAX
    block's field, unused there too."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int = 0,
                 use_bias: bool = False, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.depth = SnnConv(c1, c1, k, s, p, g=c1, bias=use_bias)
        self.point = SnnConv(c1, c2, 1, 1, 0, bias=use_bias)

    def forward(self, x):
        return self.point(self.depth(x))


class Conv_5(nn.Module):
    """mem_update -> ``DepthWiseConv`` (k x k depthwise, stride s, padding
    ``autopad(k, p)``, then 1x1 to c2; no bias) -> BN (reference Conv_5).
    ``g`` is the JAX block's field, unused there too."""

    gamma_scale = 1.0

    def __init__(self, c1: int, c2: int, k=1, s=1, p=None, g: int = 1,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.act = MemUpdate(c1, snn=snn)
        self.conv = DepthWiseConv(c1, c2, k, s, autopad(k, p))
        self.bn = TBatchNorm(c2, self.gamma_scale, snn)

    def forward(self, x):
        return self.bn(self.conv(self.act(x)))


class Conv_6(Conv_5):
    """``Conv_5`` with BN gamma 0.2 * thresh (reference Conv_6)."""

    gamma_scale = 0.2


class Shortcut(nn.Module):
    """MaxPool(1,s,s) -> mem_update -> 1x1 conv -> BN (reference
    ``shortcut``)."""

    def __init__(self, c1: int, c2: int, s: int = 1, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.s = s
        self.act = MemUpdate(c1, snn=snn)
        self.conv = SnnConv(c1, c2, 1, 1, 0)
        self.bn = TBatchNorm(c2, 1.0, snn)

    def forward(self, x):
        return self.bn(self.conv(self.act(max_pool_t(x, self.s))))


class DFL(nn.Module):
    """Distribution focal decode: softmax over ``c1`` bins, then the
    expectation over 0..c1-1, both in the input's dtype.  ``[N, 4*c1, A]``
    -> ``[N, 4, A]``; no parameters."""

    def __init__(self, c1: int = 16):
        super().__init__()
        self.c1 = c1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, _, a = x.shape
        proj = torch.arange(self.c1, dtype=x.dtype, device=x.device)
        x = torch.softmax(x.reshape(n, 4, self.c1, a), dim=2)
        return torch.einsum("nkca,c->nka", x, proj)
