"""Model assembly: YAML -> ``nn.Module`` graph (counterpart of
``ecs_yolo_tpu/models/yolo.py``).

Covers every row of the 33 YAMLs in ``models/yaml/`` (all of the JAX
package's) and every name of JAX's registry: the rows of ``nn/blocks.py``,
``nn/blocks_ext.py``, ``nn/experimental.py``, ``nn/blocks_v9.py``,
``nn/blocks_tail.py``, ``nn/blocks_tail2.py`` and ``nn/blocks_star.py``.
The tables below name each block and its module (``C2_BLOCKS``,
width-scaled output channels; ``PASS_BLOCKS``, the input's channels;
``EXTRA_BLOCKS``, a channel rule of their own), the nine detection heads
of ``nn/heads.py`` and ``Segment`` / ``Panoptic`` of ``nn/segment.py``;
they hold exactly JAX's names, and a name outside them raises
``KeyError``, as in JAX; repeated rows become ``nn.Sequential``.  Layers
are ``model.{i}``.
A ``CBLinear`` row's output is a list of tensors (its ``chs`` entry a
tuple), which the forward caches like any other output for the ``CBFuse``
rows.

A static image ``[N, H, W, C]`` is replicated over the model's T; an event
batch ``[N, T, H, W, C]`` (``data/events.EventDataset``) is event mode: its
T steps run through every layer, the stem included, so the model is built
with ``SNNConfig(time_window=T)`` of the data.

``build_model`` parses the YAML and builds the layers one by one on the
``meta`` device, each fed the shapes-only output of the layers before it
(``build_layers``, like flax's shape inference in ``init``): a layer's
input width is the tensor's, not the parser's record (they differ after a
``Bottleneck_2`` or ``ResNetBlock`` row), and a block sized by its map
(``TransformerBlock``'s position table, also inside ``C3TR``) takes the map
it is fed.  It does so
once at 256 px with placeholder strides to probe the head strides from the
eval output (JAX probes the training output, whose maps have the same
shapes), then at the image size (``imgsz``, 640 as JAX's ``init``) with
those strides; it moves the model to the target device and draws every
parameter from a ``torch.Generator``.  ``remat=True``
recomputes every non-head layer in the backward pass (the JAX ``nn.remat``
of each layer).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import yaml
from torch import nn
from torch.func import functional_call

from ..config import DEFAULT_SNN, SNNConfig
from ..device import resolve_device
from ..nn import blocks as B
from ..nn import blocks_ext as BX
from ..nn import blocks_star as BS
from ..nn import blocks_tail as BT
from ..nn import blocks_tail2 as BT2
from ..nn import blocks_v9 as BV
from ..nn import experimental as BE
from ..nn import heads as H
from ..nn import segment as SEG
from ..nn.initializers import (lecun_normal_init_, normal_init_, torch_conv_init_,
                               trunc_normal_init_, uniform_init_)

YAML_DIR = Path(__file__).parent / "yaml"

# blocks whose first YAML arg is the output-channel count (width-scaled)
C2_BLOCKS = {
    "Conv": B.Conv,
    "Conv_A": B.Conv_A,
    "Conv_B": B.Conv_B,
    "Conv_1": B.Conv_1,
    "Conv_2": B.Conv_2,
    "Conv_3": B.Conv_3,
    "Conv_4": B.Conv_4,
    "Conv_5": B.Conv_5,
    "Conv_6": B.Conv_6,
    "BasicBlock": B.BasicBlock,
    "BasicBlock_1": B.BasicBlock_1,
    "BasicBlock_2": B.BasicBlock_2,
    "Concat_res2": B.Concat_res2,
    "shortcut": B.Shortcut,
    "DepthWiseConv": B.DepthWiseConv,
    "DWConv": BX.DWConv,
    "LightConv": BX.LightConv,
    "Bottleneck": BX.Bottleneck,
    "BottleneckCSP": BX.BottleneckCSP,
    "C3": BX.C3,
    "C3Ghost": BX.C3Ghost,
    "C3SPP": BX.C3SPP,
    "C2f": BX.C2f,
    "SPP": BX.SPP,
    "SPPF": BX.SPPF,
    "Focus": BX.Focus,
    "GhostConv": BX.GhostConv,
    "GhostBottleneck": BX.GhostBottleneck,
    "GSConv": BX.GSConv,
    "BasicBlock_6": BX.BasicBlock_6,
    "BasicBlock_1s": BX.BasicBlock_1s,
    "StarBlock_2": BX.StarBlock_2,
    "RepConv": BX.RepConv,
    "RepC3": BX.RepC3,
    "MHSA": BX.MHSA,
    "BottleneckTransformer": BX.BottleneckTransformer,
    "BoT3": BX.BoT3,
    "Bottleneck_1": BT.Bottleneck_1,
    "Bottleneck_2": BT.Bottleneck_2,
    "Bottleneck_3": BT.Bottleneck_3,
    "Bottleneck_4": BT.Bottleneck_4,
    "BasicBlock_3": BT.BasicBlock_3,
    "BasicBlock_4": BT.BasicBlock_4,
    "BasicBlock_5": BT.BasicBlock_5,
    "BasicBlock_ms": BT.BasicBlock_ms,
    "ConcatBlock_ms": BT.ConcatBlock_ms,
    "BasicBlock_ms1": BT.BasicBlock_ms1,
    "Concat_res3": BT.Concat_res3,
    "Concat_res4": BT.Concat_res4,
    "Concat_res5": BT.Concat_res5,
    "Concat_res6": BT.Concat_res6,
    "DualConv": BT.DualConv,
    "MobileNetV3": BT.MobileNetV3,
    "C3TR": BT.C3TR,
    "TransformerBlock": BT.TransformerBlock,
    "CrossConv": BE.CrossConv,
    "MixConv2d": BE.MixConv2d,
    "RepConvN": BV.RepConvN,
    "RepNBottleneck": BV.RepNBottleneck,
    "RepNCSP": BV.RepNCSP,
    "RepNCSPELAN4": BV.RepNCSPELAN4,
    "StarBlock": BS.StarBlock,
    "StarBlock_1": BS.StarBlock_1,
    "StarBlock_1s": BS.StarBlock_1s,
    "StarBlock_3": BS.StarBlock_3,
    "StarBlock_4": BS.StarBlock_4,
    "StarBlock_5": BS.StarBlock_5,
    "StarSConv": BS.StarSConv,
    "MStarBlock": BS.MStarBlock,
    "MStarBlock_2": BS.MStarBlock_2,
    "StarBlock_2C2f": BS.StarBlock_2C2f,
    "BasicBlock_2C3": BV.BasicBlock_2C3,
    "BasicBlock_1C3": BV.BasicBlock_1C3,
    "Concat_res2C3": BV.Concat_res2C3,
    "BasicBlock_2C2f": BT2.BasicBlock_2C2f,
    "BasicBlock_1C2f": BT2.BasicBlock_1C2f,
    "Concat_res2C2f": BT2.Concat_res2C2f,
    "HetConv": BT2.HetConv,
    "AKConv": BT2.AKConv,
    "ResNetBlock": BT2.ResNetBlock,
    "ResNetLayerBasic": BT2.ResNetLayerBasic,
    "ResNetLayerBo": BT2.ResNetLayerBo,
    "BasicBlock_1n": BT2.BasicBlock_1n,
    "BasicBlock_1m": BT2.BasicBlock_1m,
}
# blocks that repeat n times by inserting the count as the arg after c2
# (``StarBlock_2C2f`` is not one: its YAML passes n itself, as in JAX;
# nor ``C3SPP``, whose YAML args are ``(c2, k)``)
CSP_N_BLOCKS = {"BottleneckCSP", "C3", "C3Ghost", "C2f", "RepC3", "BoT3", "C3TR",
                "RepNCSP", "BasicBlock_2C3", "BasicBlock_1C3", "Concat_res2C3",
                "BasicBlock_2C2f", "BasicBlock_1C2f", "Concat_res2C2f"}
# blocks that keep the input channel count; args passed through verbatim
PASS_BLOCKS = {
    "Sample": B.Sample,
    "Pools": B.Pools,
    "zeropad": B.ZeroPad,
    "mem_update": B.MemUpdate,
    "Conv_7": B.Conv_7,
    "AIFI": BX.AIFI,
    "EMA": BX.EMAAttention,
    "DSSA": BX.DSSA,
    "SELayer": BX.SELayer,
    "Silence": BX.Silence,
    "FasterNetBlock": BT.FasterNetBlock,
    "ELA": BT.ELA,
    "CoT": BT.CoT,
    "ScConv": BT.ScConv,
    "PartialConv": BT.PartialConv,
    "GN": BT2.GN,
    "TPReLU": BT2.TPReLU,
    "ClippedTPReLU": BS.ClippedTPReLU,
    "Attention": BT2.Attention,
    "OSRAAttention": BT2.OSRAAttention,
    "DynamicConv2d": BT2.DynamicConv2d,
    "TransxnetHybridTokenMixer": BT2.TransxnetHybridTokenMixer,
}
# blocks with a channel rule of their own (``parse_model``)
EXTRA_BLOCKS = {
    "Contract": BX.Contract,
    "Expand": BX.Expand,
    "CBLinear": BX.CBLinear,
    "CBFuse": BX.CBFuse,
    "ASFF2": BX.ASFF2,
    "ASFF3": BX.ASFF3,
    "ContextGuideFusionModule": BT.ContextGuideFusionModule,
    "ContextGuideFusionModulev2": BT.ContextGuideFusionModulev2,
    "HGBlock": BT.HGBlock,
    "Sum": BE.Sum,
}
# the blocks built with the input channel count first (a list for a
# multi-input row; the ASFF rows spread it after ``level``): every block
# with parameters sized by it; those built with ``snn`` (not ``PartialConv``,
# ``GN``, ``TPReLU``, ``ClippedTPReLU``, as in JAX); and those built with the
# (H, W) of the map they are fed
_ATTENTION = {"Attention", "OSRAAttention", "DynamicConv2d", "TransxnetHybridTokenMixer"}
C1_FIRST = set(C2_BLOCKS) | _ATTENTION | {
    "mem_update", "AIFI", "EMA", "DSSA", "SELayer", "ELA", "ClippedTPReLU", "GN", "TPReLU",
    "CBLinear", "ASFF2", "ASFF3", "ContextGuideFusionModule", "ContextGuideFusionModulev2",
    "HGBlock", "FasterNetBlock", "CoT", "ScConv", "PartialConv"}
SNN_AWARE = set(C2_BLOCKS) | _ATTENTION | {
    "mem_update", "AIFI", "EMA", "DSSA", "SELayer", "CBLinear", "ASFF2", "ASFF3",
    "ContextGuideFusionModule", "ContextGuideFusionModulev2", "HGBlock", "FasterNetBlock",
    "CoT", "ScConv"}
SIZE_BOUND = {"TransformerBlock", "C3TR"}
HEADS = {
    "Detect": H.Detect,
    "DDetect": H.DDetect,
    "DualDetect": H.DualDetect,
    "DualDDetect": H.DualDDetect,
    "TripleDetect": H.TripleDetect,
    "TripleDDetect": H.TripleDDetect,
    "v10Detect": H.v10Detect,
    "ASFF_DDetect": H.ASFF_DDetect,
    "ASFF_v10Detect": H.ASFF_v10Detect,
    "Segment": SEG.Segment,
    "Panoptic": SEG.Panoptic,
}
#: heads whose served output is the one2one branch (``V10Output``)
V10_HEADS = ("v10Detect", "ASFF_v10Detect")
#: heads whose decoded output carries mask coefficients behind the classes
SEGMENT_HEADS = ("Segment", "Panoptic")

# layers whose output on a T-replicated input is itself T-replicated (no
# neuron recurrence, nothing across T): the T-invariant stem prefix
_T_INVARIANT = {"Conv_1", "Conv_A", "Pools", "zeropad", "Sample"}
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
            if name in CSP_N_BLOCKS:
                args.insert(1, n)  # the repeat count is the block's own
                n = 1
        elif name == "Contract":
            c2 = chs[f] * args[0] ** 2
        elif name == "Expand":
            c2 = chs[f] // args[0] ** 2
        elif name == "CBLinear":
            c2 = tuple(args[0])
            args = [tuple(args[0]), *args[1:]]
        elif name == "CBFuse":
            c2 = chs[f[-1]]
            args = [tuple(args[0]) if args else ()]
        elif name in ("ASFF2", "ASFF3"):
            c2 = chs[f[args[0]]] if isinstance(f, (list, tuple)) else chs[f]
        elif name in ("ContextGuideFusionModule", "ContextGuideFusionModulev2"):
            c2 = 2 * chs[f[1]]
        elif name == "Sum":
            c2 = chs[f[0]]
        elif name == "HGBlock":
            # [cm, c2, k, ...], neither width-scaled; a repeat count goes in
            # at index 3 (the block's n), as JAX's parser puts it
            c2 = args[1]
            if n > 1:
                args.insert(3, n)
                n = 1
        elif name == "Concat":
            c2 = sum(chs[x] for x in f)
        elif name in HEADS:
            c2 = chs[f if isinstance(f, int) else f[0]]
            head_info = {"name": name, "f": f, "index": i, "nc": args[0],
                         "extra": tuple(args[1:])}
            if name == "Detect":
                a = args[1]
                if isinstance(a, int):  # e.g. `anchors: 2` anchor-free count
                    a = [list(range(a * 2))] * len(f)
                head_info["anchors_px"] = a
        elif name in PASS_BLOCKS:
            c2 = chs[f if isinstance(f, int) else f[0]]
        else:
            raise KeyError(f"unknown block {name!r} at layer {i}: not in the registry")
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
    """Input channels of layer i fed from ``f``, out of the widths ``chs``
    of the layers before it (negative froms index back from i)."""
    if i == 0:
        return ch
    pick = lambda x: chs[i + x] if x < 0 else chs[x]
    return pick(f) if isinstance(f, int) else [pick(x) for x in f]


def _construct(name: str, c1, args: Tuple, snn: SNNConfig,
               hw: Optional[Tuple[int, int]] = None) -> nn.Module:
    """Block ``name`` for input width(s) ``c1`` with the row's ``args``;
    ``hw`` is the input map's (H, W), which the ``SIZE_BOUND`` blocks
    take."""
    if name == "Concat":
        return B.Concat(*args)
    if name in HEADS:
        return HEADS[name](*args, ch=c1, snn=snn)
    if name == "Conv_7":            # its size is T, not a channel count
        return B.Conv_7(snn.time_window)
    cls = C2_BLOCKS.get(name) or PASS_BLOCKS.get(name) or EXTRA_BLOCKS[name]
    if name in ("ASFF2", "ASFF3"):  # [level, rfb] around the levels' widths
        args = (args[0], *c1, *args[1:])
    elif name in C1_FIRST:
        args = (c1, *args)
    kw = {"snn": snn} if name in SNN_AWARE else {}
    if name in SIZE_BOUND:
        kw["hw"] = hw
    return cls(*args, **kw)


def _width(x):
    """The channel count of a layer output (a tuple for a list of tensors)."""
    return tuple(_width(v) for v in x) if isinstance(x, (list, tuple)) else x.shape[-1]


@torch.no_grad()
def build_layers(spec, save, ch: int, snn: SNNConfig, imgsz: int):
    """The layers of ``spec`` on the meta device, each built for the
    tensors it is fed: a shape pass over a ``[T, 1, imgsz, imgsz, ch]``
    input in which layer i is constructed with its inputs' widths (and the
    map's (H, W), for the ``SIZE_BOUND`` blocks) and then run in eval mode
    on them, as flax's ``init`` infers each width from the tensor.  A
    repeated row's copies are built the same way, one after another.
    Returns the layers and the last layer's output (the head's, for the
    stride probe)."""
    with torch.device("meta"):
        x = torch.zeros(snn.time_window, 1, imgsz, imgsz, ch)
        layers, widths, cache = [], [], {}
        for i, (f, n, name, args) in enumerate(spec):
            if f != -1:
                x = (cache[f % i] if isinstance(f, int)
                     else [x if j == -1 else cache[j % i] for j in f])
            c1 = _c_in(f, i, ch, widths)
            copies = []
            for _ in range(n):
                hw = tuple(x.shape[2:4]) if isinstance(x, torch.Tensor) else None
                copies.append(_construct(name, c1, args, snn, hw).eval())
                x = copies[-1](x)
                c1 = _width(x) if name not in HEADS else None
            layers.append(copies[0] if n == 1 else nn.Sequential(*copies))
            widths.append(c1)
            if i in save:
                cache[i] = x
    return layers, x


def _remat_call(layer: nn.Module, x):
    """``layer(x)`` recomputed in the backward pass.  The recompute runs
    after any ``functional_call`` around the model has put the module's own
    parameters back, so it binds the tensors this forward read (the bf16
    casts of a bf16 step) again."""
    bound = dict(layer.named_parameters())
    return B.checkpointed(lambda x_: functional_call(layer, bound, (x_,)), x)


class DetectionModel(nn.Module):
    """Graph-walking detection model (reference ``Model._forward_once``)
    over ``layers`` (``build_layers``).  With ``remat`` a layer other than
    the head runs under ``nn/blocks.checkpointed`` while autograd is on."""

    def __init__(self, spec, save, layers: Sequence[nn.Module], snn: SNNConfig,
                 tinv_prefix: int = 0, remat: bool = False):
        super().__init__()
        self.spec, self.save, self.snn = spec, save, snn
        self.tinv_prefix = tinv_prefix
        self.remat = remat
        self.model = nn.ModuleList(layers)

    def prepare_input(self, x: torch.Tensor) -> torch.Tensor:
        """Static image [N,H,W,C] -> replicated T times; event batch
        [N,T,H,W,C] -> [T,N,H,W,C]."""
        if x.dim() == 4:
            return x[None].expand((self.snn.time_window,) + tuple(x.shape))
        if x.dim() == 5:
            return x.permute(1, 0, 2, 3, 4).contiguous()
        raise ValueError(f"expected 4-D or 5-D input, got {tuple(x.shape)}")

    def _layer(self, i: int, x):
        layer = self.model[i]
        if self.remat and self.spec[i][2] not in HEADS and torch.is_grad_enabled():
            return _remat_call(layer, x)
        return layer(x)

    def forward(self, x: torch.Tensor):
        x = x.to(next(self.parameters()).dtype)
        start = 0
        if x.dim() == 4 and self.tinv_prefix > 0:
            # static image: the T-invariant stem once at T=1, then a
            # broadcast over T (stride 0; the fused neuron kernel reads it)
            x = x[None]
            for i in range(self.tinv_prefix):
                x = self._layer(i, x)
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
            x = self._layer(i, x)
            if i in self.save:
                cache[i] = x
        return x


def _head_args(head_info, strides, probe: bool = False):
    """The head's arguments: ``(nc, anchors in grid units, strides)`` for
    ``Detect``; ``(nc, nm, npr, 16, strides)`` for ``Segment`` and ``(nc,
    sem_nc, nm, npr, 16, strides)`` for ``Panoptic`` (the YAML's extra
    arguments, else nm 32, npr 256, sem_nc 93, as JAX's
    ``_with_head_args``); ``(nc, reg_max 16, strides)`` for the other
    anchor-free heads."""
    name, extra = head_info["name"], tuple(head_info.get("extra", ()))
    if name == "Segment":
        nm, npr = (extra + (32, 256)[len(extra):])[:2]
        return (head_info["nc"], nm, npr, 16, tuple(strides))
    if name == "Panoptic":
        sem_nc, nm, npr = (extra + (93, 32, 256)[len(extra):])[:3]
        return (head_info["nc"], sem_nc, nm, npr, 16, tuple(strides))
    if name != "Detect":
        return (head_info["nc"], 16, tuple(strides))
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


def head_feats(name: str, out) -> List[torch.Tensor]:
    """The per-level maps of a head's eval output whose shapes give the
    strides (JAX ``_head_feat_shapes``): the main branch of the dual heads,
    the last of the triple ones, one2many of the v10 heads, the detection
    maps of the segment heads."""
    if name in V10_HEADS:
        return out.one2many
    feats = out[1]
    if name in SEGMENT_HEADS:
        return feats[0]
    if name in ("DualDetect", "DualDDetect"):
        return feats[1]
    if name in ("TripleDetect", "TripleDDetect"):
        return feats[-1]
    return feats


def head_predictions(name: str, out, nc: int) -> torch.Tensor:
    """What NMS takes from a head's eval output: the decoded one2one branch
    of the v10 heads, else ``out[0]``, of which the segment heads' first
    ``4 + nc`` rows (their mask coefficients dropped; JAX ``val.py``)."""
    if name in V10_HEADS:
        return out.one2one[0]
    if name in SEGMENT_HEADS:
        return out[0][:, :4 + nc]
    return out[0]


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Every parameter and buffer from ``generator``: torch-default conv
    inits, BN gamma = gamma0, beta 0, running mean 0 and variance 1; flax's
    defaults for the transformer and attention layers (``lecun_normal``
    linear weights and ``ELA``'s 1-D conv kernel, zero biases, layer-norm
    and the ``EMA`` / ``ELA`` / ``GN`` group-norm scales 1 and shifts 0);
    the ``TPReLU`` and ``ClippedTPReLU`` slopes at their init (0.25);
    ``Sum``'s weight at ``-arange(1, n) / 2`` and ``DSSA``'s firing-rate
    buffers at 0.01, as JAX's; ``AKConv``'s offset conv with a zero weight,
    ``ScConv``'s ``gn_gamma`` normal (std 1) and ``gn_beta`` 0,
    ``TransformerBlock``'s ``pos`` normal (std 0.02), ``HetConv``'s weight
    uniform over ``+-1 / sqrt(9 c1)`` (JAX's ``variance_scaling(1/3,
    "fan_in", "uniform")``) with a zero bias and its tap mask made again,
    ``DynamicConv2d``'s kernel and bias banks truncated normal (std 0.02),
    as JAX's.  Raises on a parameter no rule covers (the model is built on
    the ``meta`` device, so one would hold garbage)."""
    done = set()
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            lecun_normal_init_(m, generator)
        elif isinstance(m, nn.modules.conv._ConvNd):
            torch_conv_init_(m, generator)
            if isinstance(m, BT2.OffsetConv):
                m.weight.zero_()
        elif isinstance(m, BT.ScConv):
            normal_init_(m.gn_gamma, 1.0, generator)
            m.gn_beta.zero_()
        elif isinstance(m, BT.TransformerBlock):
            normal_init_(m.pos, 0.02, generator)
        elif isinstance(m, B._BN):
            m.weight.fill_(m.gamma0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, BX._LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, (BX.EMAAttention, BT.ELA)):
            m.gn_scale.fill_(1.0)
            m.gn_bias.zero_()
        elif isinstance(m, BT2.TPReLU):
            m.weight.fill_(m.init)
        elif isinstance(m, BT2.HetConv):
            uniform_init_(m.weight, 1.0 / math.sqrt(9 * m.c1), generator)
            m.bias.zero_()
            if not m.taps.is_meta:
                m.taps.copy_(m.make_taps())
        elif isinstance(m, BT2.DynamicConv2d):
            trunc_normal_init_(m.weight, 0.02, generator)
            if m.bias is not None:
                trunc_normal_init_(m.bias, 0.02, generator)
        elif isinstance(m, BT2._GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, BE.Sum):
            if m.w is not None:
                m.w.copy_(-torch.arange(1.0, m.n) / 2)
        elif isinstance(m, BX.DSSA):
            m.firing_rate_x.fill_(0.01)
            m.firing_rate_attn.fill_(0.01)
        else:
            continue
        done.update(map(id, m.parameters(recurse=False)))
    missed = [k for k, p in model.named_parameters() if id(p) not in done]
    if missed:
        raise RuntimeError(f"init_weights: no initializer for {missed[:4]}")


#: the (box, class) tower prefixes of each DFL head (JAX ``init_head_biases``)
_DFL_PREFIXES = {
    "DDetect": [("cv2_", "cv3_")],
    "DualDetect": [("a_cv2_", "a_cv3_"), ("b_cv2_", "b_cv3_")],
    "DualDDetect": [("a_cv2_", "a_cv3_"), ("b_cv2_", "b_cv3_")],
    "TripleDetect": [("a_cv2_", "a_cv3_"), ("b_cv2_", "b_cv3_"), ("c_cv2_", "c_cv3_")],
    "TripleDDetect": [("a_cv2_", "a_cv3_"), ("b_cv2_", "b_cv3_"), ("c_cv2_", "c_cv3_")],
    "v10Detect": [("cv2_", "cv3_"), ("one2one_cv2_", "one2one_cv3_")],
    "Segment": [("cv2_", "cv3_")],
}


@torch.no_grad()
def init_head_biases(model: "DetectionModel") -> None:
    """Prior bias init.  v1 (reference models/yolo.py:363-371): per level,
    obj bias += log(8/(640/s)^2), cls biases += log(0.6/(nc-0.999999)).
    DFL heads (reference models/yolo_snn.py:133-139): the box tower's last
    bias = 1.0, the class tower's ``[:nc]`` = log(5 / nc / (640/s)^2), for
    every branch; the ASFF heads' inner head, ``Panoptic``'s ``Segment``."""
    head, name = model.model[-1], model.head_info["name"]
    if name == "Detect":
        for conv, s in zip(head.m, head.strides):
            b = conv.bias.view(head.na, head.no)
            b[:, 4] += math.log(8 / (640 / s) ** 2)
            b[:, 5:] += math.log(0.6 / (head.nc - 0.999999))
        return
    if name.startswith("ASFF_"):
        head, name = head.det, name[len("ASFF_"):]
    if name == "Panoptic":
        head, name = head.seg, "Segment"
    for box_p, cls_p in _DFL_PREFIXES[name]:
        for i, s in enumerate(head.strides):
            getattr(head, f"{box_p}{i}")[-1].bias.fill_(1.0)
            getattr(head, f"{cls_p}{i}")[-1].bias[:head.nc] = \
                math.log(5 / head.nc / (640 / s) ** 2)


def build_model(
    cfg: Union[str, Path, Dict],
    nc: Optional[int] = None,
    snn: Optional[SNNConfig] = None,
    device: Optional[Union[str, torch.device]] = None,
    generator: Optional[torch.Generator] = None,
    ch: int = 3,
    remat: bool = False,
    imgsz: int = 640,
) -> DetectionModel:
    """Parse -> stride probe on ``meta`` -> final model on ``device`` (the
    CUDA card unless ``device="cpu"``), weights drawn from ``generator``
    (seed 0 when None).  The model is returned in eval mode, float32.
    ``remat`` recomputes every non-head layer in the backward pass.
    ``imgsz`` is the image side the layers are built for: only a
    ``TransformerBlock`` (also inside ``C3TR``) depends on it, and serves
    no other size."""
    dev = resolve_device(device)
    d = load_cfg(cfg)
    if nc is not None:
        d["nc"] = nc
    snn = snn or DEFAULT_SNN
    spec, save, _, head_info = parse_model(d, ch)
    if not head_info:
        raise ValueError("model YAML has no detection head")
    tinv = _t_invariant_prefix(spec, save) if snn.stem_dedup else 0

    f = head_info["f"]
    nl = len(f) if isinstance(f, (list, tuple)) else 1
    placeholder = [float(2 ** (3 + i)) for i in range(nl)]
    _, out = build_layers(_with_head(spec, head_info, placeholder, probe=True), save, ch,
                          snn, _PROBE)
    strides = tuple(float(_PROBE // f.shape[2]) for f in head_feats(head_info["name"], out))
    head_info["strides"] = strides
    spec = _with_head(spec, head_info, strides)
    layers, _ = build_layers(spec, save, ch, snn, imgsz)
    model = DetectionModel(spec, save, layers, snn, tinv, remat)
    model.head_info = head_info
    model.to_empty(device=dev)
    init_weights(model, generator or torch.Generator().manual_seed(0))
    init_head_biases(model)
    for m in model.modules():  # NHWC weights for the NHWC convolutions
        if isinstance(m, nn.Conv2d):
            m.weight.data = m.weight.data.contiguous(
                memory_format=torch.channels_last)
    return model.eval()


def checkpoint_imgsz(cfg: Union[str, Path, Dict], state_dict: Dict[str, torch.Tensor],
                     meta: Optional[Dict] = None, imgsz: int = 640,
                     nc: Optional[int] = None, snn: Optional[SNNConfig] = None) -> int:
    """The image side to build a checkpoint's model at: the ``imgsz`` the
    train driver records in ``meta``, else the side a ``TransformerBlock``'s
    position table implies (``pos`` ``[1, 1, h*w, C]``: ``sqrt(h*w)`` times
    the block's stride, read from a meta build at ``imgsz``; an imported
    JAX checkpoint's table is 256 px's), else ``imgsz``."""
    if meta and meta.get("imgsz"):
        return int(meta["imgsz"])
    if not any(k.endswith(".pos") for k in state_dict):
        return imgsz
    probe = build_model(cfg, nc=nc, snn=snn, device="meta", imgsz=imgsz)
    for name, m in probe.named_modules():
        if isinstance(m, BT.TransformerBlock) and f"{name}.pos" in state_dict:
            side = math.isqrt(state_dict[f"{name}.pos"].shape[2])
            return int(round(side * imgsz / m.hw[0]))
    return imgsz


def cast_params(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Serving precision: parameters in ``dtype``, buffers (BN running
    statistics) kept in float32, as the JAX bench casts its params."""
    for p in model.parameters():
        p.data = p.data.to(dtype)
    return model
