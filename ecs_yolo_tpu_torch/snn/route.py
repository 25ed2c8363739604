"""The switch that sends every kernel wrapper to its plain version.

``plain_kernels()`` exists for comparisons: ``chip_smoke.py`` and the tests
run a model once on the kernel route and once under it.  Nothing on a main
path enters it, and it is not a fallback: outside it a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import contextlib
import threading

_state = threading.local()


def plain_route() -> bool:
    """True inside ``plain_kernels()`` (on this thread)."""
    return getattr(_state, "depth", 0) > 0


def use_kernel(x) -> bool:
    """Whether a wrapper given ``x`` launches its kernel: a CUDA tensor does,
    unless ``plain_kernels()`` is active; a CPU tensor takes the plain
    version; any other device is refused."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"the kernels run on CUDA or CPU tensors, not {x.device}")
    return not plain_route()


@contextlib.contextmanager
def plain_kernels():
    """Inside, every kernel wrapper of the port takes its plain PyTorch
    version, on any device."""
    _state.depth = getattr(_state, "depth", 0) + 1
    try:
        yield
    finally:
        _state.depth -= 1
