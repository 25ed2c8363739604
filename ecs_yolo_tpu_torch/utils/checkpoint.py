"""Checkpoint save/load in the port's own format.

One file written by ``torch.save``: ``{"model": state_dict, "ema":
state_dict of the EMA parameters or None, "meta": {...}}``, and for a
training checkpoint also ``"opt_state"`` (``train/optim.OptState.tensors()``:
the momentum buffers, the accumulation window, the error count) and
``"step"``; ``meta`` then holds ``epoch`` and ``best_fitness``.  ``model``
holds every parameter and buffer under the torch names of
``models/yolo.DetectionModel``; ``ema`` holds the parameters only (the
buffers are shared).  It is read back with ``weights_only=True``, so a file
can hold tensors and plain Python containers and nothing else.  Files
without the training keys (written before they existed, or by
``strip_optimizer``) load the same way.

A checkpoint directory of the JAX package becomes such a file through the
root script ``import_orbax.py`` (no optimizer state: not a resume point);
``models/convert.py`` carries a JAX tree across in memory.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch


def _cpu(tree):
    """Tensors of a nested dict/list moved to the CPU, the rest kept."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: Union[str, Path], model: Mapping[str, torch.Tensor],
                    ema: Optional[Mapping[str, torch.Tensor]] = None,
                    meta: Optional[Mapping[str, Any]] = None,
                    opt_state: Optional[Mapping[str, Any]] = None,
                    step: Optional[int] = None) -> Path:
    """Write ``model`` (a ``state_dict``), the EMA parameters and ``meta``
    (plain values: epoch, fitness, ...) to ``path``, with the optimizer state
    and the step count when given; the file appears whole or not at all."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
    obj = {"model": _cpu(model), "ema": None if ema is None else _cpu(ema),
           "meta": dict(meta or {})}
    if opt_state is not None:
        obj["opt_state"] = _cpu(opt_state)
    if step is not None:
        obj["step"] = int(step)
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: Union[str, Path]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``({"model", "ema", "opt_state", "step"}, meta)`` of a file written by
    :func:`save_checkpoint`, tensors on the CPU (``ema``, ``opt_state`` and
    ``step`` None where the file has none); any other file raises."""
    obj = torch.load(Path(path), map_location="cpu", weights_only=True)
    if not (isinstance(obj, dict) and isinstance(obj.get("model"), dict)):
        raise ValueError(f"{path}: not a checkpoint of this package")
    return ({"model": obj["model"], "ema": obj.get("ema"),
             "opt_state": obj.get("opt_state"), "step": obj.get("step")},
            dict(obj.get("meta") or {}))


def strip_optimizer(src: Union[str, Path], dst: Union[str, Path]) -> Path:
    """The final artifact: the EMA parameters (the raw ones where there is
    no EMA) with the buffers, no optimizer state (JAX
    ``utils/checkpoint.strip_optimizer``)."""
    tree, meta = load_checkpoint(src)
    return save_checkpoint(dst, eval_state_dict(tree), None,
                           {**meta, "stripped": True})


def eval_state_dict(tree: Mapping[str, Any], use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` to evaluate: the model's, with the EMA parameters
    in place of the raw ones when the checkpoint has them and ``use_ema``."""
    sd = dict(tree["model"])
    if use_ema and tree.get("ema"):
        sd.update(tree["ema"])
    return sd
