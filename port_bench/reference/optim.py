"""The SGD apply and the EMA of the training driver, written out plainly.

Three groups: BN scales (``g0``, no decay), the other weights of two or more
dimensions (``g1``, weight decay), biases and 1-D leftovers (``g2``).  At
apply count ``n`` the target learning rate is ``lr0 * lf(floor(n / spe))``
with the cosine factor ``lf(e) = (1 - cos(e pi / epochs)) / 2 * (lrf - 1) +
1`` and ``spe`` the applies an epoch; over the warm-up (``nw = max(3 epochs,
1000 micro-steps) / accumulate`` applies) it rises linearly from 0 (from
``warmup_bias_lr`` for ``g2``) and the momentum from ``warmup_momentum``.
Nesterov momentum ``m`` with the buffer ``b``: ``g' = g + wd p`` (``wd`` on
``g1`` only), ``b <- m b + g'``, ``p -= lr (m b + g')``, where ``g`` is the
mean of the window's micro-gradients.  The EMA of the parameters moves
after each apply: ``e <- d e + (1 - d) p`` with ``d = 0.9999 (1 - exp(-u /
2000))`` at the ``u``-th apply of the run.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch


def group(name: str, p: torch.Tensor) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias":
        return "g2"
    if leaf == "weight" and ".bn." in f".{name}":
        return "g0"
    return "g2" if p.dim() <= 1 else "g1"


def learning_rate(count: int, sched: Dict, bias: bool) -> float:
    spe = sched["steps_per_epoch"] / sched["accumulate"]
    warm = max(sched["warmup_epochs"] * spe, sched["warmup_floor"] / sched["accumulate"])
    epoch = math.floor(count / spe)
    lf = (1 - math.cos(epoch * math.pi / sched["epochs"])) / 2 * (sched["lrf"] - 1) + 1
    target = sched["lr0"] * lf
    if count >= warm:
        return target
    start = sched["warmup_bias_lr"] if bias else 0.0
    return start + count / warm * (target - start)


def momentum(count: int, sched: Dict) -> float:
    spe = sched["steps_per_epoch"] / sched["accumulate"]
    warm = max(sched["warmup_epochs"] * spe, sched["warmup_floor"] / sched["accumulate"])
    frac = min(count / warm, 1.0)
    return sched["warmup_momentum"] + frac * (sched["momentum"] - sched["warmup_momentum"])


@torch.no_grad()
def sgd_apply(params: Dict[str, torch.Tensor], grad: Dict[str, torch.Tensor],
              buf: Optional[Dict[str, torch.Tensor]], count: int, sched: Dict,
              fault: Optional[str] = None) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """``(change, buffer)``: every parameter's change by the apply at
    ``count`` and the momentum buffer after it (``buf`` None: a zero
    buffer).  ``fault`` plants a fault for the tests and the readings of a
    limit: ``"no_weight_decay"`` leaves the decay out, ``"no_momentum"``
    steps the weights (``g0``, ``g1``) by plain SGD, ``-lr g'``."""
    m = momentum(count, sched)
    change, out = {}, {}
    for k, p in params.items():
        kind = group(k, p)
        g = grad[k]
        if kind == "g1" and fault != "no_weight_decay":
            g = g + sched["weight_decay"] * p
        b = g if buf is None else m * buf[k] + g
        out[k] = b
        step = g if fault == "no_momentum" and kind != "g2" else m * b + g
        change[k] = -learning_rate(count, sched, kind == "g2") * step
    return change, out


def ema_decay(updates: int, decay: float = 0.9999, tau: float = 2000.0) -> float:
    return decay * (1.0 - math.exp(-updates / tau))


@torch.no_grad()
def ema_apply(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
              updates: int) -> None:
    """``e <- d e + (1 - d) p`` in place, at the ``updates``-th apply."""
    d = ema_decay(updates)
    for k, e in ema.items():
        e.mul_(d).add_(params[k].detach(), alpha=1.0 - d)
