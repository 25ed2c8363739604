"""Fused membrane recurrences for any shape: the CUDA kernels
``csrc/lif_fused.cu`` and ``csrc/ecs_lif_rows.cu`` and their wrappers.

Counterpart of ``ecs_yolo_tpu/snn/pallas_kernels.py``:

* :func:`lif_fused` is ``pallas_kernels.lif_fused``: the plain-LIF recurrence
  (``SNNConfig.ecs=False``) of one site in one launch.  Every eval neuron site
  of a plain-LIF model on a CUDA tensor takes it (``nn/blocks.MemUpdate``).
* :func:`ecs_lif_fused_rows` is ``pallas_kernels.ecs_lif_fused``: the ECS-LIF
  recurrence with the spread inside, for any ``[T, N, H, W, C]`` and any
  strides.  Eval takes it when ``SNNConfig.fused_inference`` is set, or for a
  site whose layout the tensor-core kernel (``snn/ecs_lif.py``) refuses.

Both are forward-only, as their TPU kernels: training and autograd keep the
T-loops of ``snn/neuron.py``.

Each wrapper takes its plain version for a tensor on the CPU or inside
``route.plain_kernels()``, and only then.  For a CUDA tensor it launches its
kernel or raises.  ``lif_fused.launches`` and ``ecs_lif_fused_rows.launches``
count the launches.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..config import SNNConfig
from .ecs_lif import DTYPE_CODES, check_params, plan_rows
from .neuron import _const, lif_scan
from .route import use_kernel
from .surrogate import spike_fn


# --- plain LIF -----------------------------------------------------------------


@torch.no_grad()
def lif_reference(x: torch.Tensor, cfg: SNNConfig, act: bool = False) -> torch.Tensor:
    """The plain version of :func:`lif_fused`: the eager T-loop
    ``snn/neuron.lif_scan`` without autograd."""
    return lif_scan(x, cfg, act)


def lif_fused(x: torch.Tensor, cfg: SNNConfig, act: bool = False) -> torch.Tensor:
    """Plain-LIF spikes of ``x`` ``[T, ...]`` (float32 or bfloat16), any
    shape behind T.  The dims behind T must be dense; the T axis may be a
    broadcast (stride 0)."""
    if not use_kernel(x):
        return lif_reference(x, cfg, act)
    if x.dim() < 2:
        raise ValueError(f"x must be [T, ...], got {tuple(x.shape)}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"lif_fused takes float32 or bfloat16, not {x.dtype}")
    t = x.shape[0]
    m = math.prod(x.shape[1:])
    if m and not x[0].is_contiguous():
        raise ValueError(f"x's dims behind T must be contiguous, strides "
                         f"{x.stride()}")
    if t > 1 and x.stride(0) not in (0, m):
        raise ValueError(f"x's T stride must be 0 or {m}, got {x.stride(0)}")
    if m > (2 ** 31 - 1) * 256:
        raise ValueError(f"one step of x holds {m} elements, more than one "
                         "grid of 256-thread blocks covers")
    from .. import _build

    lib = _build.load("lif_fused")
    fn = lib.lif_fused_fwd
    vp, ll, ci, cf = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ci, vp, ll, vp, ll, ci, cf, cf, ci, vp]
    fn.restype = ci
    lib.lif_fused_error_string.argtypes = [ci]
    lib.lif_fused_error_string.restype = ctypes.c_char_p

    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(DTYPE_CODES[x.dtype], x.data_ptr(), x.stride(0) if t > 1 else 0,
             out.data_ptr(), m, t, float(cfg.thresh), _const(cfg.decay, x),
             int(act), stream)
    if err != 0:
        raise RuntimeError("lif_fused kernel launch failed: "
                           + lib.lif_fused_error_string(err).decode())
    lif_fused.launches += 1
    return out


lif_fused.launches = 0


# --- ECS-LIF, any shape ----------------------------------------------------------


@torch.no_grad()
def ecs_lif_rows_reference(x, dw_kernel, dw_bias, pw_kernel, pw_bias,
                           cfg: SNNConfig, act: bool = False) -> torch.Tensor:
    """The plain version of :func:`ecs_lif_fused_rows`: the arithmetic of the
    JAX ``pallas_kernels._ecs_kernel`` step by step with tensor operations.

    It differs from ``snn/ecs_lif.ecs_lif_reference`` in the spread's
    rounding: the depthwise 3x3 is summed tap by tap in x's dtype from zero
    (row-major taps, SAME zero padding), and the 1x1 is an explicit float32
    sum over the input channels in index order, rounded once to the dtype
    before its bias.  The kernel sums in the same order, so the two agree
    bit for bit up to ``tanh``/``exp``.
    """
    dt = x.dtype
    t_steps, n, h, w, c = x.shape
    dw = dw_kernel.to(dt).reshape(3, 3, c)
    dwb = dw_bias.to(dt)
    pw = pw_kernel.to(dt).reshape(c, c).float()
    pwb = pw_bias.to(dt)
    decay, alpha, beta = (_const(v, x) for v in (cfg.decay, cfg.alpha, cfg.beta))
    leak = _const(1.0 - 1.0 / cfg.ecs_tau, x)
    mem = torch.zeros_like(x[0])
    spike = torch.zeros_like(x[0])
    ecs = torch.zeros_like(x[0])
    out = []
    for t in range(t_steps):
        fecs = beta * torch.tanh(ecs)
        mem = mem * decay * (1.0 - spike) + x[t] + fecs
        spike = spike_fn(mem, cfg.thresh, cfg.lens, act)
        out.append(spike)
        if t == t_steps - 1:
            break
        sp = F.pad(spike, (0, 0, 1, 1, 1, 1))
        d = torch.zeros_like(spike)
        for dy in range(3):
            for dx in range(3):
                d = d + sp[:, dy:dy + h, dx:dx + w] * dw[dy, dx]
        d = (d + dwb).float()
        acc = torch.zeros_like(d)
        for ci in range(c):
            acc = acc + d[..., ci:ci + 1] * pw[ci]
        ecs = alpha * (acc.to(dt) + pwb) + leak * ecs
    return torch.stack(out)


def ecs_lif_fused_rows(x, dw_kernel, dw_bias, pw_kernel, pw_bias,
                       cfg: SNNConfig, act: bool = False) -> torch.Tensor:
    """ECS-LIF spikes of ``x`` ``[T, N, H, W, C]`` (float32 or bfloat16) for
    any H, W, C and any strides of ``x``.

    The spread parameters have the JAX shapes (``dw_kernel`` ``[3, 3, 1, C]``,
    ``dw_bias`` ``[C]``, ``pw_kernel`` ``[1, 1, C, C]``, ``pw_bias`` ``[C]``)
    and are cast to x's dtype.  The update of ``ecs`` after the last step,
    which the TPU kernel computes and nobody observes, is skipped.
    """
    if not use_kernel(x):
        return ecs_lif_rows_reference(x, dw_kernel, dw_bias, pw_kernel,
                                      pw_bias, cfg, act)
    check_params(x, dw_kernel, dw_bias, pw_kernel, pw_bias, "ecs_lif_fused_rows")
    from .. import _build

    lib = _build.load("ecs_lif_rows")
    fn = lib.ecs_lif_rows_fwd
    vp, ll, ci, cf = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ci, vp, ll, ll, ll, ll, ll, vp, vp, vp, vp, vp, vp, ll,
                   ci, ci, ci, ci, ci, ci, ci, cf, cf, cf, cf, cf, ci, vp]
    fn.restype = ci
    lib.ecs_lif_rows_error_string.argtypes = [ci]
    lib.ecs_lif_rows_error_string.restype = ctypes.c_char_p

    t, n, h, w, c = x.shape
    if n > 65535:
        raise ValueError(f"N = {n} exceeds the 65535 images one launch takes "
                         "(the grid's y extent)")
    dt = x.dtype
    out = torch.empty((t, n, h, w, c), dtype=dt, device=x.device)
    if out.numel() == 0:
        return out
    dw = dw_kernel.to(dt).contiguous()
    dwb = dw_bias.to(dt).contiguous()
    pw = pw_kernel.to(dt).reshape(c, c).contiguous()        # [Cin, Cout]
    pwb = pw_bias.to(dt).contiguous()
    halo = t - 1
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    rb = plan_rows(n, h, t, sms)
    ws_cap = min(h, rb + 2 * halo) * w * c
    blocks = n * math.ceil(h / rb)
    ws = torch.empty(blocks * 3 * ws_cap, dtype=dt, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(DTYPE_CODES[dt], x.data_ptr(), *x.stride(), out.data_ptr(),
             dw.data_ptr(), dwb.data_ptr(), pw.data_ptr(), pwb.data_ptr(),
             ws.data_ptr(), ws_cap, t, n, h, w, c, rb, halo,
             float(cfg.thresh), _const(cfg.decay, x), _const(cfg.alpha, x),
             _const(cfg.beta, x), _const(1.0 - 1.0 / cfg.ecs_tau, x),
             int(act), stream)
    if err != 0:
        raise RuntimeError("ecs_lif_rows kernel launch failed: "
                           + lib.ecs_lif_rows_error_string(err).decode())
    ecs_lif_fused_rows.launches += 1
    return out


ecs_lif_fused_rows.launches = 0
