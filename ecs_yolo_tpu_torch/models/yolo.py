"""Model assembly: YAML -> ``nn.Module`` graph (counterpart of
``ecs_yolo_tpu/models/yolo.py``).

Covers the rows of ``resnet10.yaml`` and ``resnet34.yaml``: ``Conv_1``,
``BasicBlock_1``, ``BasicBlock_2``, ``Concat_res2``, ``Sample``, ``Concat``
(repeated rows as ``nn.Sequential``) and the v1 ``Detect`` head.  Layers are
``model.{i}``, so parameter names are the reference's torch names.

``build_model`` parses the YAML, probes the head strides with a forward on
the ``meta`` device (shapes only, like ``jax.eval_shape``), builds the final
module on the ``meta`` device, moves it to the target device and draws every
parameter from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import yaml
from torch import nn

from ..config import DEFAULT_SNN, SNNConfig
from ..device import resolve_device
from ..nn import blocks as B
from ..nn.heads import Detect
from ..nn.initializers import torch_conv_init_

YAML_DIR = Path(__file__).parent / "yaml"

# blocks whose first YAML arg is the output-channel count (width-scaled)
C2_BLOCKS = {
    "Conv_1": B.Conv_1,
    "BasicBlock_1": B.BasicBlock_1,
    "BasicBlock_2": B.BasicBlock_2,
    "Concat_res2": B.Concat_res2,
}
# blocks that keep the input channel count; args passed through verbatim
PASS_BLOCKS = {"Sample": B.Sample}
HEADS = {"Detect": Detect}

# layers whose output on a T-replicated input is itself T-replicated (no
# neuron recurrence, nothing across T): the T-invariant stem prefix
_T_INVARIANT = {"Conv_1", "Sample"}
_PROBE = 256  # image side of the shape-only stride probe


def make_divisible(x, divisor: int = 8):
    return math.ceil(x / divisor) * divisor


def _freeze(v):
    """Deep-convert lists to tuples (hashable, comparable specs)."""
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


def _resolve_arg(a, d):
    """Safe replacement for the reference's eval() of YAML arg strings."""
    if isinstance(a, str):
        if a == "nc":
            return d["nc"]
        if a == "anchors":
            return d.get("anchors")
        if a == "None":
            return None
    return a


def load_cfg(cfg: Union[str, Path, Dict]) -> Dict:
    """A model dict from a dict, a YAML path, or a YAML name in the port's
    own ``models/yaml/``."""
    if isinstance(cfg, dict):
        return dict(cfg)
    p = Path(cfg)
    if not p.exists():
        p = YAML_DIR / Path(cfg).name
    with open(p) as fh:
        return yaml.safe_load(fh)


def parse_model(d: Dict[str, Any], ch: int):
    """Parse a model dict into ``(spec, save, chs, head_info)``, the same
    values as the JAX ``parse_model``: spec rows are ``(f, n, name, args)``,
    ``chs[i]`` is layer i's output channel count."""
    anchors, nc = d.get("anchors"), d["nc"]
    gd, gw = d.get("depth_multiple", 1.0), d.get("width_multiple", 1.0)
    na = (len(anchors[0]) // 2) if isinstance(anchors, list) else (anchors or 0)
    no = na * (nc + 5)

    rows = []
    save: List[int] = []
    chs = [ch]
    head_info: Dict[str, Any] = {}
    for i, (f, n, name, args) in enumerate(d["backbone"] + d["head"]):
        args = [_resolve_arg(a, d) for a in args]
        n = max(round(n * gd), 1) if n > 1 else n
        if name in C2_BLOCKS:
            c2 = args[0]
            if c2 != no:
                c2 = make_divisible(c2 * gw, 8)
            args = [c2, *args[1:]]
        elif name == "Concat":
            c2 = sum(chs[x] for x in f)
        elif name in HEADS:
            c2 = chs[f if isinstance(f, int) else f[0]]
            head_info = {"name": name, "f": f, "index": i, "nc": args[0],
                         "extra": tuple(args[1:])}
            a = args[1]
            if isinstance(a, int):  # e.g. `anchors: 2` anchor-free count
                a = [list(range(a * 2))] * len(f)
            head_info["anchors_px"] = a
        elif name in PASS_BLOCKS:
            c2 = chs[f if isinstance(f, int) else f[0]]
        else:
            raise KeyError(f"block {name!r} at layer {i} is not ported yet")
        rows.append((_freeze(f), n, name, _freeze(args)))
        save.extend(x % i for x in ([f] if isinstance(f, int) else f) if x != -1)
        if i == 0:
            chs = []
        chs.append(c2)
    return tuple(rows), tuple(sorted(set(save))), chs, head_info


def _t_invariant_prefix(rows, save) -> int:
    """Longest leading chain of T-invariant, linearly-fed, unsaved layers.

    For a static image these layers run once at T=1 and the result is
    broadcast over T (``SNNConfig.stem_dedup``): exact, since every copy
    would compute the same value (eval BN uses running statistics).
    """
    n = 0
    for i, (f, _, name, _args) in enumerate(rows):
        if name not in _T_INVARIANT or f != -1 or i in save:
            break
        n = i + 1
    return n


def check_anchor_order(anchors: List[List[float]], strides: Sequence[float]):
    """Reverse anchors if their area order disagrees with the stride order
    (reference utils/autoanchor.py:18-25)."""
    areas = [sum(a[i] * a[i + 1] for i in range(0, len(a), 2)) for a in anchors]
    da = areas[-1] - areas[0]
    ds = strides[-1] - strides[0]
    if (da < 0) != (ds < 0) and da != 0:
        return anchors[::-1]
    return anchors


def _c_in(f, i: int, ch: int, chs: Sequence[int]):
    """Input channels of layer i fed from ``f``, as the JAX parser sees
    them (negative froms index the layers before i)."""
    if i == 0:
        return ch
    pick = lambda x: chs[i + x] if x < 0 else chs[x]
    return pick(f) if isinstance(f, int) else [pick(x) for x in f]


def _construct(name: str, c1, args: Tuple, snn: SNNConfig) -> nn.Module:
    if name in C2_BLOCKS:
        return C2_BLOCKS[name](c1, *args, snn=snn)
    if name in PASS_BLOCKS:
        return PASS_BLOCKS[name](*args)
    if name == "Concat":
        return B.Concat(*args)
    nc, anchors, strides = args
    return Detect(nc, anchors, strides, c1, snn)


class DetectionModel(nn.Module):
    """Graph-walking detection model (reference ``Model._forward_once``)."""

    def __init__(self, spec, save, chs, ch: int, snn: SNNConfig,
                 tinv_prefix: int = 0):
        super().__init__()
        self.spec, self.save, self.snn = spec, save, snn
        self.tinv_prefix = tinv_prefix
        layers = []
        for i, (f, n, name, args) in enumerate(spec):
            c1 = _c_in(f, i, ch, chs)
            if n > 1:
                c2 = chs[i]
                layers.append(nn.Sequential(*(
                    _construct(name, c1 if j == 0 else c2, args, snn)
                    for j in range(n))))
            else:
                layers.append(_construct(name, c1, args, snn))
        self.model = nn.ModuleList(layers)

    def prepare_input(self, x: torch.Tensor) -> torch.Tensor:
        """Static image [N,H,W,C] -> replicated T times; event batch
        [N,T,H,W,C] -> [T,N,H,W,C]."""
        if x.dim() == 4:
            return x[None].expand((self.snn.time_window,) + tuple(x.shape))
        if x.dim() == 5:
            return x.permute(1, 0, 2, 3, 4).contiguous()
        raise ValueError(f"expected 4-D or 5-D input, got {tuple(x.shape)}")

    def forward(self, x: torch.Tensor):
        x = x.to(next(self.parameters()).dtype)
        start = 0
        if x.dim() == 4 and self.tinv_prefix > 0:
            # static image: the T-invariant stem once at T=1, then a
            # broadcast over T (stride 0; the fused neuron kernel reads it)
            x = x[None]
            for i in range(self.tinv_prefix):
                x = self.model[i](x)
            x = x.expand((self.snn.time_window,) + tuple(x.shape[1:]))
            start = self.tinv_prefix
        else:
            x = self.prepare_input(x)
        cache: Dict[int, torch.Tensor] = {}
        for i in range(start, len(self.spec)):
            f = self.spec[i][0]
            if f != -1:
                x = (cache[f % i] if isinstance(f, int)
                     else [x if j == -1 else cache[j % i] for j in f])
            x = self.model[i](x)
            if i in self.save:
                cache[i] = x
        return x


def _head_args(head_info, strides, probe: bool = False):
    a_grid = [[v / s for v in level]
              for level, s in zip(head_info["anchors_px"], strides)]
    if not probe:
        a_grid = check_anchor_order(a_grid, strides)
    return (head_info["nc"], _freeze(a_grid), tuple(strides))


def _with_head(spec, head_info, strides, probe=False):
    rows = list(spec)
    f, n, name, _ = rows[head_info["index"]]
    rows[head_info["index"]] = (f, n, name, _head_args(head_info, strides, probe))
    return tuple(rows)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Every parameter and buffer from ``generator``: torch-default conv
    inits, BN gamma = gamma0, beta 0, running mean 0 and variance 1."""
    for m in model.modules():
        if isinstance(m, nn.modules.conv._ConvNd):
            torch_conv_init_(m, generator)
        elif isinstance(m, B._BN):
            m.weight.fill_(m.gamma0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)


@torch.no_grad()
def init_head_biases(model: "DetectionModel") -> None:
    """v1 prior bias init (reference models/yolo.py:363-371): per level, obj
    bias += log(8/(640/s)^2), cls biases += log(0.6/(nc-0.999999))."""
    head = model.model[-1]
    for conv, s in zip(head.m, head.strides):
        b = conv.bias.view(head.na, head.no)
        b[:, 4] += math.log(8 / (640 / s) ** 2)
        b[:, 5:] += math.log(0.6 / (head.nc - 0.999999))


def build_model(
    cfg: Union[str, Path, Dict],
    nc: Optional[int] = None,
    snn: Optional[SNNConfig] = None,
    device: Optional[Union[str, torch.device]] = None,
    generator: Optional[torch.Generator] = None,
    ch: int = 3,
) -> DetectionModel:
    """Parse -> stride probe on ``meta`` -> final model on ``device`` (the
    CUDA card unless ``device="cpu"``), weights drawn from ``generator``
    (seed 0 when None).  The model is returned in eval mode, float32."""
    dev = resolve_device(device)
    d = load_cfg(cfg)
    if nc is not None:
        d["nc"] = nc
    snn = snn or DEFAULT_SNN
    spec, save, chs, head_info = parse_model(d, ch)
    if head_info.get("name") != "Detect":
        raise NotImplementedError("only the v1 Detect head is ported yet")
    tinv = _t_invariant_prefix(spec, save) if snn.stem_dedup else 0

    nl = len(head_info["anchors_px"])
    with torch.device("meta"):
        placeholder = [float(2 ** (3 + i)) for i in range(nl)]
        probe_model = DetectionModel(
            _with_head(spec, head_info, placeholder, probe=True), save, chs,
            ch, snn, tinv).eval()
        with torch.no_grad():
            _, feats = probe_model(torch.zeros(1, _PROBE, _PROBE, ch))
        strides = tuple(float(_PROBE // f.shape[2]) for f in feats)
        head_info["strides"] = strides
        model = DetectionModel(_with_head(spec, head_info, strides), save, chs,
                               ch, snn, tinv)
    model.head_info = head_info
    model.to_empty(device=dev)
    init_weights(model, generator or torch.Generator().manual_seed(0))
    init_head_biases(model)
    for m in model.modules():  # NHWC weights for the NHWC convolutions
        if isinstance(m, nn.Conv2d):
            m.weight.data = m.weight.data.contiguous(
                memory_format=torch.channels_last)
    return model.eval()


def cast_params(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Serving precision: parameters in ``dtype``, buffers (BN running
    statistics) kept in float32, as the JAX bench casts its params."""
    for p in model.parameters():
        p.data = p.data.to(dtype)
    return model
