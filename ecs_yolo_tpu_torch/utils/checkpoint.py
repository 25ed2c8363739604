"""Checkpoint save/load in the port's own format.

One file written by ``torch.save``: ``{"model": state_dict, "ema":
state_dict of the EMA parameters or None, "meta": {...}}``.  ``model`` holds
every parameter and buffer under the torch names of
``models/yolo.DetectionModel``; ``ema`` holds the parameters only (the
buffers are shared).  It is read back with ``weights_only=True``, so a file
can hold tensors and plain Python containers and nothing else.

Import of an orbax checkpoint of the JAX package is not ported yet (ROADMAP
Queue 1 item 8); ``models/convert.py`` carries a JAX tree across in memory.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch


def _cpu(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in sd.items()}


def save_checkpoint(path: Union[str, Path], model: Mapping[str, torch.Tensor],
                    ema: Optional[Mapping[str, torch.Tensor]] = None,
                    meta: Optional[Mapping[str, Any]] = None) -> Path:
    """Write ``model`` (a ``state_dict``), the EMA parameters and ``meta``
    (plain values: epoch, fitness, ...) to ``path``; the file appears whole
    or not at all."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
    torch.save({"model": _cpu(model), "ema": None if ema is None else _cpu(ema),
                "meta": dict(meta or {})}, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: Union[str, Path]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``({"model": ..., "ema": ... or None}, meta)`` of a file written by
    :func:`save_checkpoint`, tensors on the CPU; any other file raises."""
    obj = torch.load(Path(path), map_location="cpu", weights_only=True)
    if not (isinstance(obj, dict) and isinstance(obj.get("model"), dict)):
        raise ValueError(f"{path}: not a checkpoint of this package")
    return ({"model": obj["model"], "ema": obj.get("ema")},
            dict(obj.get("meta") or {}))


def eval_state_dict(tree: Mapping[str, Any], use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` to evaluate: the model's, with the EMA parameters
    in place of the raw ones when the checkpoint has them and ``use_ema``."""
    sd = dict(tree["model"])
    if use_ema and tree.get("ema"):
        sd.update(tree["ema"])
    return sd
