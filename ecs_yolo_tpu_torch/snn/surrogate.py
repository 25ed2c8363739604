"""Spike functions (counterpart of ``ecs_yolo_tpu/snn/surrogate.py``).

The Heaviside spike ``(u > thresh)`` with the rectangular surrogate gradient
``grad * 1[|u - thresh| < lens] / (2 * lens)``, and SiLU for the ``act=True``
sites.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class _Heaviside(torch.autograd.Function):
    """Forward ``(u > thresh)``; backward the rectangular window.  Only the
    boolean window is saved, not the membrane: nothing else in the backward
    reads it (the reset gate is detached, the ECS recurrence reads spikes)."""

    @staticmethod
    def forward(ctx, u, thresh, lens):
        uf = u.to(torch.promote_types(u.dtype, torch.float32))
        ctx.save_for_backward((uf - thresh).abs() < lens)
        ctx.lens = lens
        return (uf > thresh).to(u.dtype)

    @staticmethod
    def backward(ctx, g):
        (window,) = ctx.saved_tensors
        return g * window.to(g.dtype) / (2.0 * ctx.lens), None, None


def heaviside(u: torch.Tensor, thresh: float = 0.5, lens: float = 0.5) -> torch.Tensor:
    """Spike = 1 where the membrane potential exceeds ``thresh``, else 0.

    The comparison and the surrogate window run in at least float32 (a bf16
    membrane is compared in float32, as the JAX kernels do).
    """
    return _Heaviside.apply(u, thresh, lens)


def spike_fn(u: torch.Tensor, thresh: float, lens: float, act: bool) -> torch.Tensor:
    """Activation inside the membrane recurrence: Heaviside with the
    surrogate gradient, or SiLU when ``act`` (the reference's
    ``mem_update(act=True)``)."""
    if act:
        return F.silu(u)
    return heaviside(u, thresh, lens)
