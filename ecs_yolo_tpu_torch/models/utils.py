"""Model utilities: conv + BN folding, parameter count, FLOPs (counterpart of
``ecs_yolo_tpu/models/utils.py``: ``fuse_conv_bn``, ``count_params``,
``model_info``).

``fuse_conv_bn`` folds exactly the pairs the JAX function folds: a module
whose children are named ``conv`` (a convolution) and ``bn`` (a
``TBatchNorm``), per output channel, ``g = gamma / sqrt(var + eps)``.  In the
EMS models that is the ``Conv_1`` stem; the residual and shortcut pairs are
named ``conv1``/``bn1``, ``sc_conv``/``sc_bn`` in the JAX tree and are left
as they are on both sides.

The port's form of the fold is PyTorch's: the scale goes into the conv's
weight, the shift ``beta - mean * g`` into the conv's bias, and the BN module
is replaced by ``nn.Identity``, so the BN pass is gone.  The JAX function
keeps an identity-statistics BN whose bias carries the shift; the numbers
are the same.

``model_info`` counts FLOPs with ``torch.utils.flop_counter`` over one eval
forward under ``plain_kernels()`` (the counter sees PyTorch operators, not
the hand-written kernels), where the JAX function asks XLA's cost analysis.

``autobatch`` picks the largest power-of-2 batch whose footprint fits a
share of the device's memory: the JAX function reads XLA's memory analysis
of each compiled batch, the port measures the peak allocated memory of one
eval forward a batch on the card (``torch.cuda.max_memory_allocated``:
weights, input, temporaries and output, the terms JAX sums).
``forward_augment`` is the v1 test-time augmentation, scales (1, 0.83,
0.67) x flips (none, lr, none); its shrink is JAX's ``jax.image.resize``
``"bilinear"``, which antialiases when it shrinks: ``F.interpolate``'s
bilinear with ``antialias=True`` (half-pixel centres) computes that
function.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import TBatchNorm


def _pairs(model: nn.Module):
    for name, m in model.named_modules():
        conv, bn = getattr(m, "conv", None), getattr(m, "bn", None)
        if isinstance(conv, nn.Conv2d) and isinstance(bn, TBatchNorm):
            yield name, m


@torch.no_grad()
def fuse_conv_bn(model: nn.Module) -> List[str]:
    """Fold every sibling ``conv``/``bn`` pair of ``model`` in place (the
    running statistics, so an eval-mode fold).  Returns the names of the
    modules whose pair was folded.  The arithmetic runs in at least float32
    and the results are cast to the conv weight's dtype."""
    folded = []
    for name, m in list(_pairs(model)):
        conv, bn = m.conv, m.bn.bn
        w = conv.weight
        dt = torch.promote_types(w.dtype, torch.float32)
        g = bn.weight.to(dt) / torch.sqrt(bn.running_var.to(dt) + bn.eps)
        shift = bn.bias.to(dt) - bn.running_mean.to(dt) * g
        b = shift if conv.bias is None else conv.bias.to(dt) * g + shift
        # elementwise ops keep w's memory format (channels_last from build_model)
        conv.weight = nn.Parameter((w.to(dt) * g.view(-1, 1, 1, 1)).to(w.dtype))
        conv.bias = nn.Parameter(b.to(w.dtype))
        m.bn = nn.Identity()
        folded.append(name)
    return folded


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def model_info(model: nn.Module, imgsz: int = 640, batch: int = 1) -> Dict:
    """Parameter count and the FLOPs of one eval forward of a ``[batch,
    imgsz, imgsz, 3]`` image on the model's device."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..snn.route import plain_kernels

    p = next(model.parameters())
    x = torch.zeros((batch, imgsz, imgsz, 3), dtype=p.dtype, device=p.device)
    was_training = model.training
    model.eval()
    counter = FlopCounterMode(display=False)
    try:
        with torch.no_grad(), plain_kernels(), counter:
            model(x)
    finally:
        model.train(was_training)
    return {"params": count_params(model),
            "gflops": counter.get_total_flops() / 1e9}


BATCHES = (1, 2, 4, 8, 16, 32, 64)


@torch.no_grad()
def forward_footprint(model: nn.Module, batch: int, imgsz: int) -> Optional[int]:
    """Peak bytes allocated on the card over one eval forward of a ``[batch,
    imgsz, imgsz, 3]`` image (the resident weights included); None off the
    card.  Out of memory raises ``torch.cuda.OutOfMemoryError``."""
    p = next(model.parameters())
    if p.device.type != "cuda":
        return None
    torch.cuda.synchronize(p.device)
    torch.cuda.reset_peak_memory_stats(p.device)
    x = torch.zeros((batch, imgsz, imgsz, 3), dtype=torch.float32, device=p.device)
    model.eval()
    out = model(x)
    torch.cuda.synchronize(p.device)
    del out, x
    return torch.cuda.max_memory_allocated(p.device)


def autobatch(model: nn.Module, imgsz: int = 640, fraction: float = 0.8,
              device_bytes: Optional[int] = None,
              footprint: Optional[Callable[[int], Optional[int]]] = None) -> int:
    """The largest batch of 1, 2, 4, ... 64 whose footprint fits
    ``fraction`` of ``device_bytes`` (the card's memory when None), walking
    up until one does not (reference utils/autobatch.py).  ``footprint(b)``
    gives a batch's bytes, by default :func:`forward_footprint`; a
    footprint of None (no card) or out of memory ends the walk."""
    p = next(model.parameters())
    if device_bytes is None:
        device_bytes = (torch.cuda.get_device_properties(p.device).total_memory
                        if p.device.type == "cuda" else 16 * 2 ** 30)
    footprint = footprint or (lambda b: forward_footprint(model, b, imgsz))
    best = 1
    for b in BATCHES:
        try:
            fp = footprint(b)
        except torch.cuda.OutOfMemoryError:
            break
        if fp is None or fp > device_bytes * fraction:
            break
        best = b
    if p.device.type == "cuda":
        torch.cuda.empty_cache()
    return best


def _scale_img(x: torch.Tensor, ratio: float, gs: int = 32) -> torch.Tensor:
    """``[N, H, W, C]`` resized by ``ratio`` (antialiased bilinear, as
    ``jax.image.resize``) and padded at the bottom and right with 0.447 to a
    ``gs`` multiple (reference utils/torch_utils scale_img)."""
    if ratio == 1.0:
        return x
    _, h, w, _ = x.shape
    nh, nw = int(h * ratio), int(w * ratio)
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(nh, nw), mode="bilinear",
                      align_corners=False, antialias=True)
    ph = int(np.ceil(h * ratio / gs) * gs) - nh
    pw = int(np.ceil(w * ratio / gs) * gs) - nw
    return F.pad(y, (0, pw, 0, ph), value=0.447).permute(0, 2, 3, 1)


@torch.no_grad()
def forward_augment(model: nn.Module, x: torch.Tensor, gs: int = 32) -> torch.Tensor:
    """Test-time augmentation of a v1-head model (reference
    models/yolo.py:262-312, ``_descale_pred``, ``_clip_augmented``): eval
    forwards of ``x`` ``[N, H, W, 3]`` at scales (1, 0.83, 0.67) with
    flips (none, lr, none), each prediction de-scaled (and un-flipped), the
    large-object tail of the first and the small-object head of the last
    dropped; returns ``[N, A', no]``."""
    model.eval()
    x = x.to(next(model.parameters()).device, torch.float32)
    img_w = x.shape[2]
    outs = []
    for s, flip in zip((1.0, 0.83, 0.67), (False, True, False)):
        xi = _scale_img(x.flip(2) if flip else x, s, gs)
        z = model(xi)[0].float()
        xy, wh = z[..., 0:2] / s, z[..., 2:4] / s
        if flip:
            xy = torch.cat([img_w - xy[..., 0:1], xy[..., 1:2]], -1)
        outs.append(torch.cat([xy, wh, z[..., 4:]], -1))
    nl = len(model.head_info["strides"])
    g = sum(4 ** k for k in range(nl))
    i0 = outs[0].shape[1] // g
    outs[0] = outs[0][:, :outs[0].shape[1] - i0]
    i2 = (outs[-1].shape[1] // g) * 4 ** (nl - 1)
    outs[-1] = outs[-1][:, i2:]
    return torch.cat(outs, 1)
