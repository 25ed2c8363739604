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

The blocks and heads ported since (``Conv``, ``Conv_B``, ``Conv_2/3/4``, the
anchor-free heads with their towers, ``ASFF2``, ``GSConv``, ``Segment`` and
``Panoptic`` with ``Proto`` and ``UConv``) carry the JAX module names as
torch module names, so their leaves map path for path:
``layers_11/det/cv2_0/1/act/spread_dw_kernel`` ->
``model.11.det.cv2_0.1.act.spread.0.weight``, ``a_cv3_1/2/conv/bias`` ->
``a_cv3_1.2.bias``, ``one2one_cv2_0/0/bn/bn/mean`` ->
``one2one_cv2_0.0.bn.bn.running_mean``, ``seg/proto/cv1/conv/conv/kernel``
-> ``seg.proto.cv1.conv.weight``, ``cv4_1_2/conv/bias`` -> ``cv4_1_2.bias``,
``uconv/cv2/conv/kernel`` -> ``uconv.cv2.weight``; grouped kernels HWIO ->
OIHW as any conv.

The residual, v9, attention and encoder blocks map path for path too: ``BasicBlock``
(``cv1/conv/conv/kernel`` -> ``cv1.conv.weight``, ``shortcut_bn/bn/scale``
-> ``shortcut_bn.bn.weight``), the ``_Seq`` rows of ``BasicBlock_ms`` /
``ConcatBlock_ms`` (``res/3/spread_dw_kernel`` -> ``res.3.spread.0.weight``,
``sc/1/conv/kernel`` -> ``sc.1.weight``), ``RepC3`` (``m0/conv1/conv/kernel``
-> ``m0.conv1.weight``, ``cv1/act/...``), ``CBLinear`` (``conv/conv/bias`` ->
``conv.bias``), ``EMA`` (``conv1x1/conv/kernel``, ``gn_scale`` as is) and
``AIFI``, whose flax ``Dense`` and ``LayerNorm`` leaves become ``nn.Linear``
and the port's layer norm: ``fc1/kernel`` ``[in, out]`` -> ``fc1.weight``
``[out, in]``, ``norm1/scale`` -> ``norm1.weight``, the attention's
``ma/query/kernel`` ``[C, heads, head_dim]`` -> ``ma.query.weight`` ``[heads
* head_dim, C]`` (its bias ``[heads, head_dim]`` flattened) and
``ma/out/kernel`` ``[heads, head_dim, C]`` -> ``ma.out.weight`` ``[C, heads *
head_dim]``.

The star, GSConv, context-guide, CSP, HG and Ghost blocks map path for
path as well (``dw/depth/conv/kernel`` -> ``dw.depth.weight``,
``shortcut/act/spread_dw_kernel`` -> ``shortcut.act.spread.0.weight``,
``m0/cv1/conv/conv/kernel`` -> ``m0.cv1.conv.weight``,
``b0/sc_dw/conv/bn/bn/scale`` -> ``b0.sc_dw.conv.bn.bn.weight``),
``ClippedTPReLU``'s slope ``act/weight`` as it is, and ``ELA``'s flax 1-D
conv kernel ``se/conv1d/kernel`` ``[k, 1, C]`` -> ``se.conv1d.weight``
``[C, 1, k]``.  So do the blocks of ``nn/blocks_tail.py`` and ``AKConv``:
``res/4/conv/kernel`` -> ``res.4.weight``, ``sc_conv/conv/kernel`` ->
``sc_conv.weight``, ``conv2/p_conv/conv/bias`` -> ``conv2.p_conv.bias``,
``scconv/gn_gamma`` as it is, ``se/fc1/kernel`` (``SELayerInner``) ->
``se.fc1.weight``, and ``TransformerBlock``'s ``pos`` ``[1, 1, H*W, C]`` as
it is, its ``ma0/query/kernel`` as ``AIFI``'s and its ``fc1_0/kernel`` ->
``fc1_0.weight``.  The inner blocks ``m{i}`` of ``BasicBlock_2C3``,
``BasicBlock_1C3`` and ``Concat_res2C3`` (and of the C2f hybrids
``BasicBlock_2C2f``, ``BasicBlock_1C2f`` and ``Concat_res2C2f``) are the
port's ``BasicBlock_2``, ``BasicBlock_1`` and ``Concat_res2``, whose leaves
take those blocks' own map: ``m0/conv1/conv/kernel`` ->
``m0.residual_function.1.weight``.

The star blocks and the rest of ``nn/blocks_tail2.py`` map path for path
too (``f1_conv/conv/kernel`` -> ``f1_conv.weight``,
``global/sr_c1/conv/kernel`` -> ``global.sr_c1.weight``,
``c3/m0/cv1/act/spread_dw_kernel`` -> ``c3.m0.cv1.act.spread.0.weight``):
``GN``'s flax group norm ``gn/scale`` / ``gn/bias`` -> ``gn.weight`` /
``gn.bias``, ``HetConv``'s ``w3`` HWIO -> ``weight`` OIHW and its ``bias``
as it is,
``DynamicConv2d``'s banks ``weight`` ``[g, k, k, C]`` and ``bias`` ``[g, C]``
as they are (a leaf named ``weight`` keeps its layout: those banks and the
``TPReLU`` slopes).

The registry rows of the rest of ``nn/blocks.py``, ``nn/blocks_ext.py``,
``nn/experimental.py`` and ``nn/blocks_v9.py`` map path for path too:
``MixConv2d``'s grouped kernels ``m{i}/conv/kernel`` HWIO -> ``m{i}.weight``
OIHW, ``SELayer``'s ``Dense`` kernels ``fc1/kernel`` -> ``fc1.weight``
(transposed), ``Sum``'s weight ``w`` as it is, ``DSSA``'s batch statistics
``firing_rate_x`` / ``firing_rate_attn`` -> the buffers of the same names,
``Conv_5``'s ``conv/depth/conv/kernel`` -> ``conv.depth.weight``, and a
``Conv_7`` row's ``w`` -> ``conv.weight`` as in ``Detect``.

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
# blocks whose inner blocks m{i} take another block's map
_NESTED = {"BasicBlock_2C3": "BasicBlock_2", "BasicBlock_1C3": "BasicBlock_1",
           "Concat_res2C3": "Concat_res2", "BasicBlock_2C2f": "BasicBlock_2",
           "BasicBlock_1C2f": "BasicBlock_1", "Concat_res2C2f": "Concat_res2"}
# leaf path inside a MemUpdate / SnnConv / TBatchNorm -> torch leaf name
_LEAVES = {
    "spread_dw_kernel": "spread.0.weight", "spread_dw_bias": "spread.0.bias",
    "spread_pw_kernel": "spread.1.weight", "spread_pw_bias": "spread.1.bias",
    "conv/kernel": "weight", "conv/bias": "bias",
    "bn/scale": "bn.weight", "bn/bias": "bn.bias",
    "bn/mean": "bn.running_mean", "bn/var": "bn.running_var",
    "gn_scale": "gn_scale", "gn_bias": "gn_bias",
    "conv1d/kernel": "conv1d.weight", "weight": "weight", "w": "w",
    "firing_rate_x": "firing_rate_x", "firing_rate_attn": "firing_rate_attn",
    "gn_gamma": "gn_gamma", "gn_beta": "gn_beta", "pos": "pos",
    "gn/scale": "gn.weight", "gn/bias": "gn.bias", "w3": "weight", "bias": "bias",
}
# flax Dense / DenseGeneral / LayerNorm modules (AIFI, TransformerBlock's
# fc1_{i} / fc2_{i}) -> nn.Linear / layer norm
_DENSE = re.compile(r"query|key|value|out|fc[12](_\d+)?|norm[12]")
_DENSE_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _dense(module: str) -> bool:
    return _DENSE.fullmatch(module) is not None


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def _path_name(block: str, path: str) -> str:
    """Torch name of a leaf of a block named path for path: the module path
    joined by dots, then the leaf's torch name."""
    parts = path.split("/")
    if len(parts) > 1 and _dense(parts[-2]) and parts[-1] in _DENSE_LEAVES:
        return ".".join(parts[:-1] + [_DENSE_LEAVES[parts[-1]]])
    for n in (2, 1):
        leaf = "/".join(parts[-n:])
        if len(parts) >= n and leaf in _LEAVES:
            return ".".join(parts[:-n] + [_LEAVES[leaf]])
    raise KeyError(f"{block}: no torch name for {path!r}")


def _torch_name(block: str, path: str) -> str:
    """Torch name (relative to the block) of a JAX leaf path."""
    inner = re.fullmatch(r"(m\d+)/(.+)", path) if block in _NESTED else None
    if inner:
        return f"{inner[1]}.{_torch_name(_NESTED[block], inner[2])}"
    if block == "Conv_7" and path == "w":
        return "conv.weight"
    if block not in _MODULES and block != "Detect":
        return _path_name(block, path)
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
    if (block == "Detect" and re.fullmatch(r"w\d+/w", path)) or (
            block == "Conv_7" and path == "w"):
        return w.reshape(1, w.shape[2], 1, 1, 1)      # Conv_7 [1,1,T,1]
    parts = path.split("/")
    if parts[-1] in ("pos", "weight"):
        return w                                      # [1, 1, H*W, C]; banks, slopes
    if w.ndim == 4:
        return np.transpose(w, (3, 2, 0, 1))          # HWIO -> OIHW
    if w.ndim == 3 and parts[-1] == "kernel" and not _dense(parts[-2]):
        return np.transpose(w, (2, 1, 0))             # 1-D conv [k, I, O] -> [O, I, k]
    if len(parts) > 1 and _dense(parts[-2]):
        if parts[-1] == "bias":
            return w.reshape(-1)                      # [heads, head_dim] -> [C]
        if parts[-1] == "kernel" and parts[-2] == "out" and w.ndim == 3:
            return w.reshape(-1, w.shape[-1]).T       # [heads, head_dim, C] -> [C, C]
        if parts[-1] == "kernel":
            return w.reshape(w.shape[0], -1).T        # [in, (heads,) out] -> [out, in]
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
