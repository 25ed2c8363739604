"""The work a step does, counted from the configuration's shapes, and the
card's peaks: the yardstick of the roofline and mfu metrics.

Every count here comes from the layer shapes of the configuration (walked
once through the plain reference on the ``meta`` device, where nothing is
computed) and from the formulas below, so it is the same whatever kernel or
library call implements a layer.

* A convolution: ``2 k^2 (Cin/g) Cout Hout Wout`` operations an image and
  step, at every step it runs (the stem once, at T=1); the head's collapse
  over T ``2 T`` an output.
* A neuron site ``[H, W, C]`` (ECS-LIF): ``(T-1) H W (2 C^2 + 18 C)`` an
  image, the spread's 1x1 product and 3x3 taps over the T-1 steps that
  spread (the formula of the fused neuron kernel, K1).
* K1 (``csrc/ecs_lif.cu``, the eval neuron kernel) at a site: bytes
  ``((1 or T) + T) N H W C + 11 C + C^2`` elements (x read once, one plane
  where it is a broadcast over T; spikes written once; the weights), the
  operations above.
* K4 (``csrc/spread_dw3.cu``, the depthwise spread of the training loop, at
  the sites the fused product does not take) a launch: bytes ``P (2 s + 1) +
  10 C s`` (the float plane read, the output and the int8 plane written, the
  weights; ``P = N H W C``, ``s`` the dtype's size), ``18 P`` operations.
* K5 (``csrc/spread_gemm.cu``, the fused dw+pw spread at ``C <= 64``, ``C %
  16 == 0``, even W) a launch: bytes ``P (1 + s) + 9 C^2 s + 4 C``,
  operations ``2 * 9 C^2 N H W``.
* K4 / K5 launch ``T - 1`` times a site and training forward.

A bound is the larger of bytes over the HBM rate and operations over the
peak (NVIDIA H100 SXM data sheet, dense, 700 W).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..reference.model import Conv, MemUpdate, RefDetector, _Collapse

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def model_shapes(config: Dict, imgsz: int) -> Dict:
    """Per image and forward: ``conv_flops``, ``site_flops`` and the
    neuron sites as ``(H, W, C, broadcast)``."""
    t = config["T"]
    with torch.device("meta"):
        ref = RefDetector(config["model"], t, config["neuron"]).eval()
        conv, sites = [0.0], []

        def on_conv(m, inp, out):
            x = inp[0]
            k2 = m.weight.shape[2] * m.weight.shape[3]
            conv[0] += 2 * k2 * m.weight.shape[1] * out.shape[2] * out.shape[3] * out.shape[4] \
                * out.shape[0]

        def on_collapse(m, inp, out):
            conv[0] += 2 * t * out.shape[1] * out.shape[2] * out.shape[3]

        def on_site(m, inp):
            x = inp[0]
            sites.append((x.shape[3], x.shape[4], x.shape[2], x.stride(0) == 0))

        hooks = []
        for m in ref.modules():
            if isinstance(m, Conv):
                hooks.append(m.register_forward_hook(on_conv))
            elif isinstance(m, _Collapse):
                hooks.append(m.register_forward_hook(on_collapse))
            elif isinstance(m, MemUpdate):
                hooks.append(m.register_forward_pre_hook(on_site))
        with torch.no_grad():
            ref(torch.zeros(1, 3, imgsz, imgsz))
        for h in hooks:
            h.remove()
    site_flops = sum((t - 1) * h * w * (2 * c * c + 18 * c) for h, w, c, _ in sites)
    return {"conv_flops": conv[0], "site_flops": site_flops, "sites": sites}


def forward_flops(shapes: Dict) -> float:
    """Operations of one image's forward."""
    return shapes["conv_flops"] + shapes["site_flops"]


def k1_bound_s(shapes: Dict, t: int, batch: int, dtype: str) -> float:
    """K1's bound over one batch's forward (every site on K1)."""
    s = ITEMSIZE[dtype]
    total = 0.0
    for h, w, c, bcast in shapes["sites"]:
        planes = (1 if bcast else t) + t
        nbytes = (planes * batch * h * w * c + 11 * c + c * c) * s
        total += bound_s(nbytes, (t - 1) * batch * h * w * (2 * c * c + 18 * c), dtype)
    return total


def spread_route(c: int, w: int) -> str:
    return "k5" if c <= 64 and c % 16 == 0 and w % 2 == 0 else "k4"


def spread_bounds(shapes: Dict, t: int, batch: int, dtype: str) -> Dict[str, Dict[str, float]]:
    """K4's and K5's launches and bound over one training forward."""
    s = ITEMSIZE[dtype]
    out = {"k4": {"launches": 0, "bound_s": 0.0}, "k5": {"launches": 0, "bound_s": 0.0}}
    for h, w, c, _ in shapes["sites"]:
        p = batch * h * w * c
        if spread_route(c, w) == "k5":
            b = bound_s(p * (1 + s) + 9 * c * c * s + 4 * c, 2 * 9 * c * c * batch * h * w, dtype)
        else:
            b = bound_s(p * (2 * s + 1) + 10 * c * s, 18 * p, dtype)
        k = out[spread_route(c, w)]
        k["launches"] += t - 1
        k["bound_s"] += (t - 1) * b
    return out


def site_table(shapes: Dict) -> List[List]:
    """``[[H, W, C, broadcast, count], ...]`` of the sites, largest map first."""
    counts: Dict = {}
    for s in shapes["sites"]:
        counts[s] = counts.get(s, 0) + 1
    return [[*k, v] for k, v in sorted(counts.items(), reverse=True)]
