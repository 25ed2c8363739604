"""Global spiking-neuron configuration (counterpart of ``ecs_yolo_tpu/config.py``).

The fields and defaults are those of the JAX package, so one set of
hyper-parameters describes a model in both.  The port runs the canonical
``[T, N, H, W, C]`` layout only: the TPU layout and kernel switches below are
accepted so that a configuration carries across unchanged, and they change
nothing here (fp32 eval is bit-identical across those layouts in the JAX
package).
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class SNNConfig:
    """Spiking neuron hyper-parameters.

    Attributes:
      thresh: firing threshold of the Heaviside spike function.
      lens: half-width of the rectangular surrogate-gradient window.
      decay: membrane leak factor applied between timesteps.
      time_window: number of timesteps T every feature map carries.
      ecs: enable the ECS-LIF extracellular field (plain LIF when False).
      alpha: ECS spread gain.
      beta: ECS feedback gain (through tanh).
      ecs_tau: ECS field time constant.
      fused_inference: which fused kernel an ECS-LIF site takes in eval
        (``torch.no_grad()``, module in eval mode) on a CUDA tensor.  False:
        the tensor-core kernel of ``snn/ecs_lif.py``, and the general-shape
        kernel of ``snn/fused.py`` (``ecs_lif_fused_rows``) only for a site
        whose layout the first refuses (``C % 8 != 0``, a non-dense or
        unaligned input).  True: ``ecs_lif_fused_rows`` at every site, the
        counterpart of the JAX ``pallas_kernels.ecs_lif_fused`` this flag
        was reserved for; its spread rounds tap by tap, so its spikes may
        differ from the default route's near the threshold.  With
        ``ecs=False`` every eval site takes ``snn/fused.lif_fused``.
        Training mode or autograd on takes the T-loop, whose spread on a
        CUDA tensor runs on the spread kernels (``snn/spread.py``): the
        fused dw+pw product at C <= 64 sites, the binary depthwise kernel
        plus a library 1x1 product at wider ones.  On the CPU every wrapper
        takes its plain version.
      stem_dedup: run the T-invariant stem once at T=1 for a static image and
        broadcast the result over T (exact; see ``models/yolo.py``).
      remat_neuron: recompute every neuron recurrence (the training T-loop)
        in the backward pass instead of keeping its activations
        (``nn/blocks.checkpointed``), as the JAX package's
        ``jax.checkpoint`` of its scans does; the BN running statistics still
        move once a step.
      packed_spread, packed_c64, bn_custom_vjp, int8_spike_transport,
      int8_reset_gate, pallas_dw_spread, pallas_packed_spread:
        TPU layout, residual and kernel switches of the JAX package.
        Accepted and ignored: the port runs the canonical layout, chooses
        its spread kernel by the site's width, and always saves the
        surrogate window and the spread's spikes as bool/int8.
    """

    thresh: float = 0.5
    lens: float = 0.5
    decay: float = 0.25
    time_window: int = 4
    ecs: bool = True
    alpha: float = 0.75
    beta: float = 0.25
    ecs_tau: float = 5.0
    fused_inference: bool = False
    packed_spread: bool = False
    packed_c64: bool = True
    stem_dedup: bool = True
    bn_custom_vjp: bool = True
    int8_spike_transport: bool = True
    int8_reset_gate: bool = False
    pallas_dw_spread: bool = False
    pallas_packed_spread: bool = False
    remat_neuron: bool = False

    def replace(self, **kw: Any) -> "SNNConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_SNN = SNNConfig()


def autopad(k, p=None):
    """'same' padding from kernel size (reference models/common.py:47-52)."""
    if p is None:
        p = k // 2 if isinstance(k, int) else [x // 2 for x in k]
    return p
