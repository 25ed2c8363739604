"""PyTorch + CUDA port of the spiking-YOLO framework, for one NVIDIA H100.

Mirrors the module layout of the JAX package ``ecs_yolo_tpu`` so that each
module has an obvious counterpart.  Public functions keep the JAX layouts:
features are ``[T, N, H, W, C]``, images ``[N, H, W, 3]``.  Entry points run
on the CUDA device unless the caller passes ``device="cpu"``.

Every neuron site runs on one of five hand-written CUDA kernels (listed in
``snn/__init__.py``), built from ``csrc/`` at first use.

The port imports ``torch`` only: nothing of JAX and nothing of the JAX
package.
"""

from .config import DEFAULT_SNN, SNNConfig, autopad
from .device import resolve_device

__all__ = ["SNNConfig", "DEFAULT_SNN", "autopad", "resolve_device"]
