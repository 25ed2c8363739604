"""Weights carried across: the JAX package's parameter tree -> the port's
``state_dict``.

The inverse of the name map in ``ecs_yolo_tpu/models/torch_import.py``: the
port's modules carry the reference's torch names, the JAX tree its flax
names (``layers_{i}/act1/spread_dw_kernel``, ``.../conv1/conv/kernel``,
``.../bn1/bn/scale``; batch statistics ``.../bn1/bn/mean``).  Layout
transforms: conv HWIO -> OIHW, depthwise ``[3,3,1,C]`` -> ``[C,1,3,3]``,
pointwise ``[1,1,Cin,Cout]`` -> ``[Cout,Cin,1,1]``, Conv_7 ``[1,1,T,1]`` ->
``[1,T,1,1,1]``, BN scale/bias/mean/var -> weight/bias/running_mean/
running_var.

Every leaf of the JAX tree is mapped or the conversion raises, and
``load_state_dict(strict=True)`` on the port's model checks the other
direction.

Any tree with the parameters' structure converts the same way (gradients,
updated parameters, an EMA copy: pass it as ``params`` with ``batch_stats``
None), so both sides can be compared under the torch names.
``convert_labels`` carries a tree of per-leaf labels (the optimizer groups)
across without touching the leaves.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

# JAX child module -> torch sub-module, per block
_RESIDUAL = {"act1": "residual_function.0", "conv1": "residual_function.1",
             "bn1": "residual_function.2", "act2": "residual_function.3",
             "conv2": "residual_function.4", "bn2": "residual_function.5"}
_MODULES = {
    "Conv_1": {"conv": "conv", "bn": "bn"},
    # downsampling shortcut: MaxPool3d (no params) at shortcut.0
    "BasicBlock_1": {**_RESIDUAL, "sc_act": "shortcut.1",
                     "sc_conv": "shortcut.2", "sc_bn": "shortcut.3"},
    "BasicBlock_2": {**_RESIDUAL, "sc_act": "shortcut.1",
                     "sc_conv": "shortcut.2", "sc_bn": "shortcut.3"},
    "Concat_res2": {**_RESIDUAL, "sc_act": "shortcut.0",
                    "sc_conv": "shortcut.1", "sc_bn": "shortcut.2"},
}
# leaf path inside a MemUpdate / SnnConv / TBatchNorm -> torch leaf name
_LEAVES = {
    "spread_dw_kernel": "spread.0.weight", "spread_dw_bias": "spread.0.bias",
    "spread_pw_kernel": "spread.1.weight", "spread_pw_bias": "spread.1.bias",
    "conv/kernel": "weight", "conv/bias": "bias",
    "bn/scale": "bn.weight", "bn/bias": "bn.bias",
    "bn/mean": "bn.running_mean", "bn/var": "bn.running_var",
}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def _torch_name(block: str, path: str) -> str:
    """Torch name (relative to the block) of a JAX leaf path."""
    if block == "Detect":
        m = re.fullmatch(r"m(\d+)/conv/(kernel|bias)", path)
        if m:
            return f"m.{m[1]}." + ("weight" if m[2] == "kernel" else "bias")
        m = re.fullmatch(r"w(\d+)/w", path)
        if m:
            return f"w.{m[1]}.conv.weight"
        raise KeyError(f"Detect: no torch name for {path!r}")
    child, _, leaf = path.partition("/")
    try:
        return f"{_MODULES[block][child]}.{_LEAVES[leaf]}"
    except KeyError:
        raise KeyError(f"{block}: no torch name for {path!r}") from None


def _layout(block: str, path: str, w: np.ndarray) -> np.ndarray:
    if block == "Detect" and re.fullmatch(r"w\d+/w", path):
        return w.reshape(1, w.shape[2], 1, 1, 1)      # Conv_7 [1,1,T,1]
    if w.ndim == 4:
        return np.transpose(w, (3, 2, 0, 1))          # HWIO -> OIHW
    return w


def _to_tensor(block: str, path: str, w) -> torch.Tensor:
    return torch.from_numpy(np.array(_layout(block, path, np.asarray(w))))


def convert_block(block: str, params: Mapping, batch_stats: Mapping = None,
                  leaf=_to_tensor) -> Dict[str, Any]:
    """State dict (names relative to the block) of one JAX block's
    ``params`` and ``batch_stats``; ``leaf(block, path, value)`` makes each
    entry (by default the tensor in the torch layout)."""
    flat = _flatten(params)
    flat.update(_flatten(batch_stats or {}))
    return {_torch_name(block, path): leaf(block, path, w)
            for path, w in flat.items()}


def convert_labels(labels: Mapping, spec: Tuple) -> Dict[str, Any]:
    """A tree of per-leaf labels with the parameters' structure (e.g. the JAX
    optimizer's group of each leaf) under the torch names."""
    return convert(labels, None, spec, leaf=lambda block, path, v: v)


def convert(params: Mapping, batch_stats: Mapping, spec: Tuple,
            leaf=_to_tensor) -> Dict[str, Any]:
    """The port's ``state_dict`` for the JAX ``variables`` of a model built
    from ``spec`` (``layers_{i}`` -> ``model.{i}``; a repeated row's copies
    ``layers_{i}/{j}`` -> ``model.{i}.{j}``)."""
    sd = {}
    stats = batch_stats or {}
    for key in params:
        if not re.fullmatch(r"layers_\d+", key):
            raise KeyError(f"unexpected top-level parameter scope {key!r}")
    for i, (_f, n, name, _args) in enumerate(spec):
        p, s = params.get(f"layers_{i}", {}), stats.get(f"layers_{i}", {})
        if n > 1:
            for j in range(n):
                for k, v in convert_block(name, p[str(j)], s.get(str(j)), leaf).items():
                    sd[f"model.{i}.{j}.{k}"] = v
        else:
            for k, v in convert_block(name, p, s, leaf).items():
                sd[f"model.{i}.{k}"] = v
    return sd
