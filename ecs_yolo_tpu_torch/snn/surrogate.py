"""Spike functions (counterpart of ``ecs_yolo_tpu/snn/surrogate.py``).

Forward only: the Heaviside spike ``(u > thresh)`` and SiLU for the
``act=True`` sites.  The rectangular surrogate backward
(``grad * 1[|u - thresh| < lens] / (2 * lens)``) is not ported yet: under
autograd the spike carries no gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def heaviside(u: torch.Tensor, thresh: float = 0.5) -> torch.Tensor:
    """Spike = 1 where the membrane potential exceeds ``thresh``, else 0.

    The comparison runs in at least float32 (a bf16 membrane is compared
    in float32, as the JAX kernels do).
    """
    return (u.to(torch.promote_types(u.dtype, torch.float32)) > thresh).to(u.dtype)


def spike_fn(u: torch.Tensor, thresh: float, act: bool) -> torch.Tensor:
    """Activation inside the membrane recurrence: Heaviside, or SiLU when
    ``act`` (the reference's ``mem_update(act=True)``)."""
    if act:
        return F.silu(u)
    return heaviside(u, thresh)
