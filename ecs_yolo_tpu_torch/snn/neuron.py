"""Membrane recurrences as eager T-loops (counterpart of
``ecs_yolo_tpu/snn/neuron.py``).

They are differentiable: the spike carries the rectangular surrogate
gradient (``snn/surrogate.py``) and the reset gate is detached where the
reference detaches it.  ``ecs_lif_scan`` is the training path (its ``spread``
comes from ``snn/spread.py``, whose kernels run the spread on the card), the
CPU path, and the oracle the fused CUDA kernel (``snn/ecs_lif.py``) is held
against.  All take ``x`` shaped ``[T, N, H, W, C]`` and return the spike
train in the same shape and dtype.

Every step rounds to ``x``'s dtype after each operation, and the scalar
constants are rounded to that dtype first, as the JAX scan does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..config import SNNConfig
from .surrogate import heaviside, spike_fn


def _const(v: float, like: torch.Tensor) -> float:
    """A scalar rounded to ``like``'s dtype (JAX weak-type semantics), as a
    Python float: rounded on the host, so no copy to the device (which would
    make the host wait for the stream at every site)."""
    return float(torch.tensor(v, dtype=like.dtype, device="cpu"))


def lif_scan(x: torch.Tensor, cfg: SNNConfig, act: bool = False) -> torch.Tensor:
    """Plain LIF recurrence (reference models/common2.py:75-106).

    mem_i = mem_{i-1} * decay * (1 - detach(spike_{i-1})) + x_i
    spike_i = Heaviside(mem_i)  (or SiLU when act=True)
    """
    decay = _const(cfg.decay, x)
    mem = torch.zeros_like(x[0])
    spike = torch.zeros_like(x[0])
    out = []
    for t in range(x.shape[0]):
        mem = mem * decay * (1.0 - spike.detach()) + x[t]
        spike = spike_fn(mem, cfg.thresh, cfg.lens, act)
        out.append(spike)
    return torch.stack(out)


def ecs_lif_scan(
    x: torch.Tensor,
    spread: Callable[[torch.Tensor], torch.Tensor],
    cfg: SNNConfig,
    act: bool = False,
) -> torch.Tensor:
    """ECS-LIF recurrence (reference models/common.py:236-309 ``mem_update``).

    Per step i (fecs_0 = 0):
      mem_i   = mem_{i-1} * decay * (1 - detach(spike_{i-1})) + x_i + fecs_{i-1}
      spike_i = Heaviside(mem_i)            (SiLU when act=True)
      ecs_i   = alpha * spread(spike_i) + (1 - 1/ecs_tau) * ecs_{i-1}
      fecs_i  = beta * tanh(ecs_i)

    ``spread`` maps ``[N, H, W, C]`` spikes to the depthwise3x3 + pointwise1x1
    field (see :func:`make_spread`).  The last step's ``ecs`` update cannot be
    observed and is skipped.
    """
    decay = _const(cfg.decay, x)
    alpha = _const(cfg.alpha, x)
    beta = _const(cfg.beta, x)
    leak = _const(1.0 - 1.0 / cfg.ecs_tau, x)
    T = x.shape[0]
    mem = torch.zeros_like(x[0])
    spike = torch.zeros_like(x[0])
    ecs = torch.zeros_like(x[0])
    out = []
    for t in range(T):
        fecs = beta * torch.tanh(ecs)
        mem = mem * decay * (1.0 - spike.detach()) + x[t] + fecs
        spike = spike_fn(mem, cfg.thresh, cfg.lens, act)
        out.append(spike)
        if t < T - 1:
            ecs = alpha * spread(spike) + leak * ecs
    return torch.stack(out)


def make_spread(
    dw_kernel: torch.Tensor,  # [3, 3, 1, C] (JAX HWIO depthwise)
    dw_bias: torch.Tensor,    # [C]
    pw_kernel: torch.Tensor,  # [1, 1, C, C] (JAX HWIO pointwise)
    pw_bias: torch.Tensor,    # [C]
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The ECS spread ``pw1x1(dw3x3(s) + dwb) + pwb`` over NHWC spikes.

    Takes the JAX parameter shapes, casts nothing (the caller casts to the
    compute dtype), adds each bias after its convolution, and pads SAME with
    zeros.
    """
    c = dw_kernel.shape[-1]
    dw = dw_kernel.permute(3, 2, 0, 1).contiguous()          # [C, 1, 3, 3]
    pw = pw_kernel.reshape(c, c)                             # [Cin, Cout]

    def spread(s: torch.Tensor) -> torch.Tensor:
        s_nchw = s.permute(0, 3, 1, 2)                       # channels_last view
        d = F.conv2d(s_nchw, dw, None, 1, 1, 1, c).permute(0, 2, 3, 1) + dw_bias
        return torch.matmul(d, pw) + pw_bias

    return spread


def mem_update(
    x: torch.Tensor,
    spread: Optional[Callable[[torch.Tensor], torch.Tensor]],
    cfg: SNNConfig,
    act: bool = False,
) -> torch.Tensor:
    """Dispatch between ECS-LIF (default) and plain LIF."""
    if cfg.ecs:
        if spread is None:
            raise ValueError("ECS mode requires spread conv parameters")
        return ecs_lif_scan(x, spread, cfg, act)
    return lif_scan(x, cfg, act)


def lif_node_scan(x: torch.Tensor, tau: float, v_th: float,
                  cfg: SNNConfig) -> torch.Tensor:
    """``LIFNode`` recurrence (reference models/common.py:126-147).

    u_i = tau * u_{i-1} * (1 - spike_{i-1}) + x_i
    spike_i = Heaviside(u_i - v_th)

    Unlike ``mem_update`` the reset gate is NOT detached: the gradient flows
    through the previous spike's surrogate.
    """
    tau = _const(tau, x)
    v_th = _const(v_th, x)
    u = torch.zeros_like(x[0])
    spike = torch.zeros_like(x[0])
    out = []
    for t in range(x.shape[0]):
        u = tau * u * (1.0 - spike) + x[t]
        spike = heaviside(u - v_th, cfg.thresh, cfg.lens)
        out.append(spike)
    return torch.stack(out)


def firing_rate(spikes: torch.Tensor) -> torch.Tensor:
    """Mean spike density as a 0-d float32 tensor on the spikes' device
    (no host sync; read it with ``float()`` when needed)."""
    return spikes.detach().float().mean()
