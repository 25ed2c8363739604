"""The import check: the program is measured without JAX.  Module names are
compared by their top-level part, whole (``ecs_yolo_tpu_torch`` is not
``ecs_yolo_tpu``)."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax", "ecs_yolo_tpu"})


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (``sys.modules`` by
    default)."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
