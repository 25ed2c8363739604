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
Not ported: ``autobatch`` and ``forward_augment`` (test-time augmentation).
"""

from __future__ import annotations

from typing import Dict, List

import torch
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
