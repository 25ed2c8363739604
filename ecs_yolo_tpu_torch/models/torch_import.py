"""Reference checkpoints: a reference ``.pt`` state_dict -> the port's model
(the port's copy of the name map of ``ecs_yolo_tpu/models/torch_import.py``).

The reference pickles whole ``nn.Module``s (reference train.py:657-668).
Its torch names ``model.{i}.*`` map onto the JAX tree's ``layers_{i}/...``
paths by the table below (the JAX package's ``_seq_names`` and
``build_mapping``, copied), and a JAX path maps onto the port's name by
``models/convert.py``; for most rows the two ends are the same name, since
the port's modules carry the reference's names, and for ``DDetect`` the
towers ``cv2.{l}.{j}`` become ``cv2_{l}.{j}``.  As in the JAX importer a
key is copied where both sides have it and the element counts agree
(reshaped where only the shape differs, cast to the port's dtype); the rest
is reported, and ``strict`` raises on it.  The port's weights share the
reference's OIHW layout, so no transpose is needed.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import convert as CV


def _seq_names(block: str) -> List[Tuple[str, str]]:
    """(reference sub-path, JAX sub-path) pairs of a block's parameters."""
    def mem(t, o):
        return [(f"{t}.spread.0.weight", f"{o}/spread_dw_kernel"),
                (f"{t}.spread.0.bias", f"{o}/spread_dw_bias"),
                (f"{t}.spread.1.weight", f"{o}/spread_pw_kernel"),
                (f"{t}.spread.1.bias", f"{o}/spread_pw_bias")]

    def conv(t, o):
        return [(f"{t}.weight", f"{o}/conv/kernel")]

    def bn(t, o):
        return [(f"{t}.bn.weight", f"{o}/bn/scale"), (f"{t}.bn.bias", f"{o}/bn/bias"),
                (f"{t}.bn.running_mean", f"{o}/bn/mean"),
                (f"{t}.bn.running_var", f"{o}/bn/var")]

    if block in ("Conv_1", "Conv_A"):
        return conv("conv", "conv") + bn("bn", "bn")
    if block == "Conv":
        return conv("conv", "conv") + bn("bn", "bn") + mem("act", "act")
    if block in ("Conv_2", "Conv_3", "Conv_4", "Conv_B"):
        return mem("act", "act") + conv("conv", "conv") + bn("bn", "bn")
    if block in ("BasicBlock_1", "BasicBlock_2", "Concat_res2"):
        rows = (mem("residual_function.0", "act1") + conv("residual_function.1", "conv1")
                + bn("residual_function.2", "bn1") + mem("residual_function.3", "act2")
                + conv("residual_function.4", "conv2") + bn("residual_function.5", "bn2"))
        # Concat_res2's shortcut has no MaxPool3d at index 0
        k = 0 if block == "Concat_res2" else 1
        return rows + (mem(f"shortcut.{k}", "sc_act") + conv(f"shortcut.{k + 1}", "sc_conv")
                       + bn(f"shortcut.{k + 2}", "sc_bn"))
    if block == "BasicBlock":
        rows = []
        for name in ("cv1", "cv2"):
            rows += (conv(f"{name}.conv", f"{name}/conv") + bn(f"{name}.bn", f"{name}/bn")
                     + mem(f"{name}.act", f"{name}/act"))
        return rows + conv("shortcut.0", "shortcut_conv") + bn("shortcut.1", "shortcut_bn")
    return []


def _ddetect(i: int, nl: int) -> List[Tuple[str, str]]:
    """(reference name, JAX sub-path) pairs of a ``DDetect`` row: two
    ``Conv_B`` and a conv per tower (reference models/yolo_snn.py:83-139)."""
    rows = []
    for li in range(nl):
        for br in ("cv2", "cv3"):
            for j in (0, 1):
                t, o = f"model.{i}.{br}.{li}.{j}", f"{br}_{li}/{j}"
                rows += [(f"{t}.act.spread.0.weight", f"{o}/act/spread_dw_kernel"),
                         (f"{t}.act.spread.0.bias", f"{o}/act/spread_dw_bias"),
                         (f"{t}.act.spread.1.weight", f"{o}/act/spread_pw_kernel"),
                         (f"{t}.act.spread.1.bias", f"{o}/act/spread_pw_bias"),
                         (f"{t}.conv.weight", f"{o}/conv/conv/kernel"),
                         (f"{t}.bn.bn.weight", f"{o}/bn/bn/scale"),
                         (f"{t}.bn.bn.bias", f"{o}/bn/bn/bias"),
                         (f"{t}.bn.bn.running_mean", f"{o}/bn/bn/mean"),
                         (f"{t}.bn.bn.running_var", f"{o}/bn/bn/var")]
            rows += [(f"model.{i}.{br}.{li}.2.weight", f"{br}_{li}/2/conv/kernel"),
                     (f"model.{i}.{br}.{li}.2.bias", f"{br}_{li}/2/conv/bias")]
    return rows


def build_mapping(spec) -> Dict[str, str]:
    """Reference torch name -> the port's name, for a parsed spec (the keys
    are those of the JAX ``build_mapping``)."""
    mapping: Dict[str, str] = {}
    for i, (f, _n, name, args) in enumerate(spec):
        if name == "Detect":
            for li in range(len(args[1])):
                for ref, sub in ((f"m.{li}.weight", f"m{li}/conv/kernel"),
                                 (f"m.{li}.bias", f"m{li}/conv/bias"),
                                 (f"w.{li}.conv.weight", f"w{li}/w")):
                    mapping[f"model.{i}.{ref}"] = f"model.{i}.{CV._torch_name(name, sub)}"
            continue
        if name == "DDetect":
            nl = len(f) if isinstance(f, (list, tuple)) else 1
            for ref, sub in _ddetect(i, nl):
                mapping[ref] = f"model.{i}.{CV._torch_name(name, sub)}"
            continue
        for ref, sub in _seq_names(name):
            mapping[f"model.{i}.{ref}"] = f"model.{i}.{CV._torch_name(name, sub)}"
    return mapping


def load_torch_checkpoint(path) -> Dict[str, torch.Tensor]:
    """The (EMA-preferred) state_dict of a reference ``.pt`` as float32 CPU
    tensors (reference attempt_load prefers ``ckpt['ema']``,
    models/experimental.py:93-95).  The reference pickles modules, so the
    file is unpickled in full: load only files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    model = (ckpt.get("ema") or ckpt.get("model") or ckpt) if isinstance(ckpt, dict) else ckpt
    sd = model.state_dict() if hasattr(model, "state_dict") else model
    return {k: torch.as_tensor(v).detach().float() for k, v in sd.items()}


@torch.no_grad()
def import_state_dict(state_dict: Dict[str, torch.Tensor], model,
                      strict: bool = False) -> Dict[str, List[str]]:
    """Copy the matching reference weights into ``model`` in place.  Returns
    ``{"matched": [...], "missed": [...]}`` of reference names."""
    own = model.state_dict()
    matched, missed = [], []
    for ref, name in build_mapping(model.spec).items():
        if ref not in state_dict or name not in own:
            missed.append(ref)
            continue
        w, want = state_dict[ref], own[name]
        if tuple(w.shape) != tuple(want.shape):
            if w.numel() != want.numel():
                missed.append(ref)
                continue
            w = w.reshape(want.shape)
        want.copy_(w.to(want.dtype))
        matched.append(ref)
    if strict and missed:
        raise KeyError(f"unmatched torch keys: {missed[:10]} (+{len(missed) - 10})")
    return {"matched": matched, "missed": missed}
