"""The eval kernels as operators the dispatcher knows: K1, K2 and K6 as
``torch.library`` custom ops in the namespace ``ecs_yolo_torch``.

============================================  ====================  ============================
op                                            implementation        wrapper
============================================  ====================  ============================
``torch.ops.ecs_yolo_torch.ecs_lif``          ``ecs_lif.run_k1``    ``ecs_lif.ecs_lif_fused``
``torch.ops.ecs_yolo_torch.ecs_lif_rows``     ``fused.run_k2``      ``fused.ecs_lif_fused_rows``
``torch.ops.ecs_yolo_torch.lif``              ``fused.run_k6``      ``fused.lif_fused``
============================================  ====================  ============================

A wrapper called from Python reaches its kernel through the op, so an
eager forward, a ``torch.jit.trace`` of it and a ``torch.export`` of it
take one route: the graph holds one op node a neuron site, and running the
graph runs the op.

* On a CUDA tensor the op launches the hand-written kernel, with
  everything the launch needs made inside it: the parameters cast to x's
  dtype, the plan, the workspace, the per-stream barrier buffer, the error
  check and the wrapper's ``launches`` count.  Nothing of a launch is made
  outside the op, so a traced graph bakes in no buffer.  Inside
  ``route.plain_kernels()`` it takes the plain version instead.
* On a CPU tensor the op is the plain version.
* The fake (meta) implementation gives the output's shape and dtype: a
  dense tensor of x's shape, as both the kernels and the plain versions
  return.

The ``SNNConfig`` scalars the recurrence reads are op arguments (the
threshold, the surrogate's half-width, the leak, the ECS gains and time
constant) and so is ``act``; ``cfg_args`` gives them in the op's order.
No op has an autograd formula: training takes the T-loops of
``snn/neuron.py``, as the TPU kernels are forward-only too.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from ..config import SNNConfig

NAMESPACE = "ecs_yolo_torch"
_DEVICES = ("cpu", "cuda")


def cfg_args(cfg: SNNConfig) -> Tuple[float, ...]:
    """``cfg``'s scalars in the ops' argument order."""
    return (float(cfg.thresh), float(cfg.lens), float(cfg.decay), float(cfg.alpha),
            float(cfg.beta), float(cfg.ecs_tau))


def _cfg(thresh: float, lens: float, decay: float, alpha: float, beta: float,
         ecs_tau: float) -> SNNConfig:
    return SNNConfig(thresh=thresh, lens=lens, decay=decay, alpha=alpha, beta=beta,
                     ecs_tau=ecs_tau)


def _dense_like(x: Tensor) -> Tensor:
    return x.new_empty(x.shape)


@torch.library.custom_op(f"{NAMESPACE}::ecs_lif", mutates_args=(), device_types=_DEVICES)
def ecs_lif(x: Tensor, dw_kernel: Tensor, dw_bias: Tensor, pw_kernel: Tensor,
            pw_bias: Tensor, thresh: float, lens: float, decay: float, alpha: float,
            beta: float, ecs_tau: float, act: bool) -> Tensor:
    """K1 (``csrc/ecs_lif.cu``): ECS-LIF spikes of ``x`` ``[T, N, H, W, C]``."""
    from .ecs_lif import run_k1

    return run_k1(x, dw_kernel, dw_bias, pw_kernel, pw_bias,
                  _cfg(thresh, lens, decay, alpha, beta, ecs_tau), act)


@torch.library.custom_op(f"{NAMESPACE}::ecs_lif_rows", mutates_args=(),
                         device_types=_DEVICES)
def ecs_lif_rows(x: Tensor, dw_kernel: Tensor, dw_bias: Tensor, pw_kernel: Tensor,
                 pw_bias: Tensor, thresh: float, lens: float, decay: float, alpha: float,
                 beta: float, ecs_tau: float, act: bool) -> Tensor:
    """K2 (``csrc/ecs_lif_rows.cu``): K1's function for any shape and strides,
    with the TPU kernel's rounding."""
    from .fused import run_k2

    return run_k2(x, dw_kernel, dw_bias, pw_kernel, pw_bias,
                  _cfg(thresh, lens, decay, alpha, beta, ecs_tau), act)


@torch.library.custom_op(f"{NAMESPACE}::lif", mutates_args=(), device_types=_DEVICES)
def lif(x: Tensor, thresh: float, lens: float, decay: float, alpha: float, beta: float,
        ecs_tau: float, act: bool) -> Tensor:
    """K6 (``csrc/lif_fused.cu``): plain-LIF spikes of ``x`` ``[T, ...]``."""
    from .fused import run_k6

    return run_k6(x, _cfg(thresh, lens, decay, alpha, beta, ecs_tau), act)


@ecs_lif.register_fake
def _ecs_lif_fake(x, dw_kernel, dw_bias, pw_kernel, pw_bias, thresh, lens, decay, alpha,
                  beta, ecs_tau, act):
    return _dense_like(x)


@ecs_lif_rows.register_fake
def _ecs_lif_rows_fake(x, dw_kernel, dw_bias, pw_kernel, pw_bias, thresh, lens, decay,
                       alpha, beta, ecs_tau, act):
    return _dense_like(x)


@lif.register_fake
def _lif_fake(x, thresh, lens, decay, alpha, beta, ecs_tau, act):
    return _dense_like(x)
