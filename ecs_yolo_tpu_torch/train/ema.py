"""Model EMA (counterpart of ``ecs_yolo_tpu/train/ema.py``; reference
utils/torch_utils.py:286 ``ModelEMA``).

decay(t) = d * (1 - exp(-t / tau)) with d=0.9999, tau=2000, so early updates
average aggressively.
"""

from __future__ import annotations

from typing import Mapping

import torch


def ema_decay(updates, decay: float = 0.9999, tau: float = 2000.0) -> torch.Tensor:
    """0-d float32 decay after ``updates`` steps (a number or a 0-d tensor;
    the result lies on the tensor's device)."""
    u = updates.to(torch.float32) if isinstance(updates, torch.Tensor) \
        else torch.tensor(float(updates), dtype=torch.float32)
    return decay * (1.0 - torch.exp(-u / tau))


@torch.no_grad()
def ema_update(ema_params: Mapping[str, torch.Tensor],
               params: Mapping[str, torch.Tensor], updates,
               decay: float = 0.9999, tau: float = 2000.0) -> None:
    """``e <- e * d + (1 - d) * p`` for every parameter, in place on
    ``ema_params``."""
    d = ema_decay(updates, decay, tau)
    es = list(ema_params.values())
    ps = [params[k].to(e.dtype) for k, e in ema_params.items()]
    torch._foreach_mul_(es, d)
    torch._foreach_add_(es, torch._foreach_mul(ps, 1.0 - d))
