"""Fused ECS-LIF forward: the CUDA kernel ``csrc/ecs_lif.cu`` and its wrapper.

Counterpart of ``ecs_yolo_tpu/snn/pallas_ecs_v3.py:ecs_lif_pallas``: the
whole T-step ECS-LIF recurrence of one site, the depthwise-3x3 + pointwise
1x1 spread included, in one launch.  Eval of an ECS-LIF site on a CUDA tensor
takes this kernel by default (``nn/blocks.MemUpdate``); a site whose layout
it refuses (:func:`layout_refusal`), or any site under
``SNNConfig.fused_inference``, takes the general-shape kernel of
``snn/fused.py`` instead.

The wrapper takes the plain loop (``snn/neuron.ecs_lif_scan``) for a tensor
on the CPU or inside ``route.plain_kernels()``, and only then.  For a CUDA
tensor it launches the kernel or raises.  ``ecs_lif_fused.launches`` counts
the launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..config import SNNConfig
from .neuron import ecs_lif_scan, make_spread
from .route import use_kernel

#: dtype codes of the kernels' C interfaces
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: blocks resident on one SM (``__launch_bounds__(kThreads, 2)`` in the source)
BLOCKS_PER_SM = 2


def plan_rows(n: int, h: int, t: int, num_sms: int) -> int:
    """Rows per tile for a site.

    A block computes its tile on a window of up to ``rb + 2*(t-1)`` rows
    (clipped to the image), so a small tile recomputes much of its halo while
    a large one leaves SMs idle.  A block's time is bound by latency more than
    by its SM's throughput, so count the blocks that fit on the card at once:
    minimise ``ceil(blocks / (num_sms * BLOCKS_PER_SM)) * window``; on a tie
    take the larger tile (less work and workspace in all).
    """
    halo = t - 1
    best, best_cost = h, None
    for rb in range(1, h + 1):
        blocks = n * math.ceil(h / rb)
        cost = (math.ceil(blocks / (num_sms * BLOCKS_PER_SM))
                * min(h, rb + 2 * halo))
        if best_cost is None or cost <= best_cost:
            best, best_cost = rb, cost
    return best


def ecs_lif_reference(x, dw_kernel, dw_bias, pw_kernel, pw_bias, cfg: SNNConfig,
                      act: bool = False) -> torch.Tensor:
    """The plain version: the eager T-loop with the parameters cast to x's
    dtype, the same function the kernel computes."""
    dt = x.dtype
    spread = make_spread(dw_kernel.to(dt), dw_bias.to(dt), pw_kernel.to(dt),
                         pw_bias.to(dt))
    return ecs_lif_scan(x, spread, cfg, act)


def check_params(x, dw_kernel, dw_bias, pw_kernel, pw_bias,
                 who: str = "ecs_lif_fused") -> None:
    """What every fused ECS-LIF kernel demands: x ``[T, N, H, W, C]`` of a
    dtype it takes, the spread parameters in the JAX shapes on x's device,
    and one image small enough for 32-bit offsets."""
    if x.dim() != 5:
        raise ValueError(f"x must be [T, N, H, W, C], got {tuple(x.shape)}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{who} takes float32 or bfloat16, not {x.dtype}")
    t, n, h, w, c = x.shape
    want = {"dw_kernel": (3, 3, 1, c), "dw_bias": (c,),
            "pw_kernel": (1, 1, c, c), "pw_bias": (c,)}
    for name, p in zip(want, (dw_kernel, dw_bias, pw_kernel, pw_bias)):
        if tuple(p.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(p.shape)}")
        if p.device != x.device:
            raise ValueError(f"{name} is on {p.device}, x on {x.device}")
    if h * w * c >= 2 ** 31:
        raise ValueError("one image of x must hold fewer than 2^31 elements")


def layout_refusal(x: torch.Tensor) -> Optional[str]:
    """Why this kernel does not take the layout of ``x`` ``[T, N, H, W, C]``,
    or None when it does.  It reads 16-byte groups of eight channels, so it
    wants the four inner dims dense, T dense or a broadcast (stride 0),
    ``C % 8 == 0`` and a 16-byte aligned start.  ``nn/blocks.MemUpdate``
    sends a refused site to the general-shape kernel (``snn/fused.py``)."""
    t, n, h, w, c = x.shape
    if tuple(x.stride()[1:]) != (h * w * c, w * c, c, 1):
        return f"x's [N, H, W, C] dims must be contiguous, strides {x.stride()}"
    if t > 1 and x.stride(0) not in (0, n * h * w * c):
        return f"x's T stride must be 0 or N*H*W*C, got {x.stride(0)}"
    if c % 8:
        return f"the kernel takes C % 8 == 0, got C={c}"
    if x.device.type == "cuda" and x.data_ptr() % 16:
        return "x must start on a 16-byte boundary"
    return None


def _check(x, dw_kernel, dw_bias, pw_kernel, pw_bias):
    check_params(x, dw_kernel, dw_bias, pw_kernel, pw_bias)
    reason = layout_refusal(x)
    if reason:
        raise ValueError(reason)


def ecs_lif_fused(x, dw_kernel, dw_bias, pw_kernel, pw_bias, cfg: SNNConfig,
                  act: bool = False) -> torch.Tensor:
    """ECS-LIF spikes of ``x`` ``[T, N, H, W, C]`` (float32 or bfloat16).

    The spread parameters have the JAX shapes: ``dw_kernel`` ``[3, 3, 1, C]``,
    ``dw_bias`` ``[C]``, ``pw_kernel`` ``[1, 1, C, C]``, ``pw_bias`` ``[C]``;
    they are cast to x's dtype.  x's T axis may be a broadcast (stride 0).
    """
    if not use_kernel(x):
        return ecs_lif_reference(x, dw_kernel, dw_bias, pw_kernel, pw_bias,
                                 cfg, act)
    _check(x, dw_kernel, dw_bias, pw_kernel, pw_bias)
    from .. import _build

    lib = _build.load("ecs_lif")
    fn = lib.ecs_lif_fwd
    vp, ll, ci, cf = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ci, vp, ll, vp, vp, vp, vp, vp, vp, ll, ci, ci, ci, ci, ci,
                   ci, ci, cf, cf, cf, cf, cf, ci, vp]
    fn.restype = ci
    lib.ecs_lif_error_string.argtypes = [ci]
    lib.ecs_lif_error_string.restype = ctypes.c_char_p

    t, n, h, w, c = x.shape
    dt = x.dtype
    dw = dw_kernel.to(dt).contiguous()
    dwb = dw_bias.to(dt).contiguous()
    pwt = pw_kernel.to(dt).reshape(c, c).t().contiguous()   # [Cout, Cin]
    pwb = pw_bias.to(dt).contiguous()
    halo = t - 1
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    rb = plan_rows(n, h, t, sms)
    ws_cap = min(h, rb + 2 * halo) * w * c
    blocks = n * math.ceil(h / rb)
    ws = torch.empty(blocks * 4 * ws_cap, dtype=dt, device=x.device)
    out = torch.empty((t, n, h, w, c), dtype=dt, device=x.device)

    def rounded(v: float) -> float:
        return float(torch.tensor(v, dtype=dt))

    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(DTYPE_CODES[dt], x.data_ptr(), x.stride(0), out.data_ptr(),
             dw.data_ptr(), dwb.data_ptr(), pwt.data_ptr(), pwb.data_ptr(),
             ws.data_ptr(), ws_cap, t, n, h, w, c, rb, halo,
             float(cfg.thresh), rounded(cfg.decay), rounded(cfg.alpha),
             rounded(cfg.beta), rounded(1.0 - 1.0 / cfg.ecs_tau), int(act),
             stream)
    if err != 0:
        raise RuntimeError("ecs_lif kernel launch failed: "
                           + lib.ecs_lif_error_string(err).decode())
    ecs_lif_fused.launches += 1
    return out


ecs_lif_fused.launches = 0
