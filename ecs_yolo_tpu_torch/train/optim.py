"""Optimizers and learning-rate schedules (counterpart of
``ecs_yolo_tpu/train/optim.py``).

Three parameter groups: g0 norm scales (no weight decay), g1 kernels (weight
decay), g2 biases and 1-D leftovers (no decay, warm-up from
``warmup_bias_lr``).  SGD with Nesterov momentum, Adam or AdamW; linear or
one-cycle learning rate; the warm-up interpolates both the learning rate and
the SGD momentum.

The update is written out here rather than handed to ``torch.optim``: the
schedules change the learning rate and the momentum per step and per group,
a step whose gradients are not finite is skipped, and both are decided on
the device from 0-d tensors, so a step never waits for the device.  The
schedules are evaluated in float32 at the count of applied steps before the
current one, in the JAX package's order of operations.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional

import torch

GROUPS = ("g0", "g1", "g2")


def one_cycle(y1: float = 1.0, y2: float = 0.01, steps: int = 100):
    """Sinusoidal ramp y1->y2 (reference utils/general.py:476)."""
    return lambda x: ((1 - math.cos(x * math.pi / steps)) / 2) * (y2 - y1) + y1


def linear_lf(lrf: float, epochs: int):
    return lambda x: (1 - x / epochs) * (1.0 - lrf) + lrf


def _as_step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def _lf(epoch: torch.Tensor, lrf: float, epochs: int, cos_lr: bool) -> torch.Tensor:
    if cos_lr:
        return ((1 - torch.cos(epoch * math.pi / epochs)) / 2) * (lrf - 1) + 1
    return (1 - epoch / epochs) * (1.0 - lrf) + lrf


def make_lr_fn(lr0: float, lrf: float, epochs: int, steps_per_epoch: float,
               cos_lr: bool = True, warmup_epochs: float = 3.0,
               warmup_bias_lr: float = 0.1, is_bias: bool = False,
               min_warmup_steps: float = 1000.0):
    """Per-step learning rate: warm-up interpolation, then the epoch-wise
    decay factor evaluated on integer epochs (reference train.py:524-540).
    ``lr_fn(step)`` takes a number or a 0-d tensor and returns a 0-d float32
    tensor on the step's device."""
    nw = max(warmup_epochs * steps_per_epoch, min_warmup_steps)
    start = warmup_bias_lr if is_bias else 0.0

    def lr_fn(step):
        step = _as_step(step)
        epoch = torch.floor(step / steps_per_epoch)
        target = lr0 * _lf(epoch, lrf, epochs, cos_lr)
        frac = (step / nw).clamp(0.0, 1.0)
        warm = start + frac * (target - start)
        return torch.where(step < nw, warm, target)

    return lr_fn


def make_momentum_fn(momentum: float, warmup_momentum: float, nw: float):
    """SGD momentum ``warmup_momentum -> momentum`` over the warm-up window
    (reference train.py:538-540)."""

    def mom_fn(step):
        frac = (_as_step(step) / nw).clamp(0.0, 1.0)
        return warmup_momentum + frac * (momentum - warmup_momentum)

    return mom_fn


def param_group_label(name: str, param: torch.Tensor) -> str:
    """g0 (norm scales), g1 (kernels) or g2 (biases, 1-D leftovers) of a
    parameter under its torch name: the group the JAX package's
    ``param_group_label`` gives the same leaf."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias":
        return "g2"
    if leaf == "weight" and ".bn." in f".{name}":
        return "g0"
    if param.dim() <= 1:
        return "g2"
    return "g1"


@dataclasses.dataclass
class OptState:
    """count: steps applied so far (0-d int64); mu: momentum / first moment
    per parameter; nu: Adam's second moment (None for SGD)."""

    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Optional[Dict[str, torch.Tensor]]


class Optimizer:
    """The three-group optimizer.  ``init`` makes the state for a dict of
    parameters; ``apply`` updates parameters and state in place."""

    def __init__(self, labels: Mapping[str, str], name: str, lr_fns, mom_fn,
                 momentum: float, weight_decay: float):
        self.labels = dict(labels)
        self.name = name
        self.lr_fns = lr_fns            # group -> lr_fn
        self.mom_fn = mom_fn            # SGD only
        self.momentum = momentum        # Adam's b1
        self.decay = {"g0": 0.0, "g1": weight_decay, "g2": 0.0}

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        if set(params) != set(self.labels):
            raise KeyError("the optimizer was built for other parameters")
        dev = next(iter(params.values())).device
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        return OptState(torch.zeros((), dtype=torch.int64, device=dev), zeros(),
                        None if self.name == "sgd" else zeros())

    @torch.no_grad()
    def apply(self, params: Mapping[str, torch.Tensor],
              grads: Mapping[str, torch.Tensor], state: OptState) -> torch.Tensor:
        """One step in place.  Returns the 0-d bool ``applied``: False when a
        gradient was not finite, and then nothing changed (the reference's
        GradScaler drops such steps, train.py:571-576).

        The groups are updated with ``torch._foreach`` operations (a handful
        of launches for all parameters).  A skipped step is decided on the
        device: the gradients are zeroed under the flag, the learning rate
        is multiplied by it, and each moment keeps ``old * (1 - flag) + new *
        flag``, which is exact for a flag of 0 or 1.
        """
        names = list(params)
        flat = torch.cat([grads[k].reshape(-1).to(params[k].dtype) for k in names])
        finite = torch.isfinite(flat).all()
        flat = torch.where(finite, flat, torch.zeros_like(flat))
        clean = dict(zip(names, (g.view_as(params[k]) for k, g in zip(
            names, flat.split([params[k].numel() for k in names])))))
        on = finite.to(torch.float32)
        off = 1.0 - on
        count = state.count
        if self.name == "sgd":
            mom = self.mom_fn(count)
        else:
            b1, b2, eps = self.momentum, 0.999, 1e-8
            t = (count + 1).to(torch.float64)   # bias corrections in full precision
            c1, c2 = 1 - b1 ** t, 1 - b2 ** t

        def keep(old, new):     # old where the step is skipped, else new
            torch._foreach_mul_(old, off)
            torch._foreach_add_(old, torch._foreach_mul(new, on))

        for group in GROUPS:
            ks = [k for k in names if self.labels[k] == group]
            if not ks:
                continue
            ps, gs = [params[k] for k in ks], [clean[k] for k in ks]
            mus = [state.mu[k] for k in ks]
            lr, decay = self.lr_fns[group](count) * on, self.decay[group]
            if self.name == "sgd":
                if decay:
                    gs = torch._foreach_add(gs, ps, alpha=decay)
                mu = torch._foreach_add(torch._foreach_mul(mus, mom), gs)
                u = torch._foreach_add(torch._foreach_mul(mu, mom), gs)
            else:
                nus = [state.nu[k] for k in ks]
                if decay and self.name == "adam":
                    gs = torch._foreach_add(gs, ps, alpha=decay)
                mu = torch._foreach_add(torch._foreach_mul(mus, b1),
                                        torch._foreach_mul(gs, 1 - b1))
                nu = torch._foreach_add(
                    torch._foreach_mul(nus, b2),
                    torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - b2))
                den = torch._foreach_sqrt(torch._foreach_div(nu, c2))
                torch._foreach_add_(den, eps)
                u = torch._foreach_div(torch._foreach_div(mu, c1), den)
                if decay and self.name == "adamw":
                    u = torch._foreach_add(u, ps, alpha=decay)
                keep(nus, nu)
            keep(mus, mu)
            torch._foreach_add_(ps, torch._foreach_mul(u, -lr))
        count.add_(finite.to(count.dtype))
        return finite


def build_optimizer(
    params: Mapping[str, torch.Tensor],
    name: str = "SGD",
    lr0: float = 0.01,
    lrf: float = 0.01,
    momentum: float = 0.937,
    weight_decay: float = 5e-4,
    epochs: int = 300,
    steps_per_epoch: int = 1000,
    cos_lr: bool = True,
    warmup_epochs: float = 3.0,
    warmup_momentum: float = 0.8,
    warmup_bias_lr: float = 0.1,
    accumulate: int = 1,
    warmup_floor: float = 1000.0,
) -> Optimizer:
    """The three-group optimizer with its warm-up schedules.  ``params``
    (torch name -> tensor) only labels the groups."""
    if accumulate != 1:
        raise NotImplementedError("gradient accumulation (accumulate > 1) is "
                                  "not ported yet")
    kind = name.lower()
    if kind == "lion":
        raise NotImplementedError("the Lion optimizer is not ported yet")
    if kind not in ("sgd", "adam", "adamw"):
        raise KeyError(f"unknown optimizer {name!r}")
    lr_fns = {
        g: make_lr_fn(lr0, lrf, epochs, steps_per_epoch, cos_lr, warmup_epochs,
                      warmup_bias_lr, is_bias=(g == "g2"),
                      min_warmup_steps=warmup_floor)
        for g in GROUPS}
    nw = max(warmup_epochs * steps_per_epoch, warmup_floor)
    labels = {k: param_group_label(k, p) for k, p in params.items()}
    return Optimizer(labels, kind, lr_fns,
                     make_momentum_fn(momentum, warmup_momentum, nw),
                     momentum, weight_decay)
