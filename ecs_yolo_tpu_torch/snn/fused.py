"""Fused membrane recurrences for any shape: the CUDA kernels
``csrc/lif_fused.cu``, ``csrc/ecs_lif_rows.cu`` and ``csrc/ecs_lif_v2.cu``
and their wrappers.

Counterpart of ``ecs_yolo_tpu/snn/pallas_kernels.py``:

* :func:`lif_fused` is ``pallas_kernels.lif_fused``: the plain-LIF recurrence
  (``SNNConfig.ecs=False``) of one site in one launch.  Every eval neuron site
  of a plain-LIF model on a CUDA tensor takes it (``nn/blocks.MemUpdate``).
* :func:`ecs_lif_fused_rows` is ``pallas_kernels.ecs_lif_fused``: the ECS-LIF
  recurrence with the spread inside, for any ``[T, N, H, W, C]`` and any
  strides.  Eval takes it when ``SNNConfig.fused_inference`` is set, or for a
  site whose layout the tensor-core kernel (``snn/ecs_lif.py``) refuses.
* :func:`ecs_lif_fused_v2` is ``pallas_kernels.ecs_lif_fused_v2``: the same
  function with the state held in shared memory, tiles in rows and width,
  and C split across a thread-block cluster where one block cannot hold a
  useful tile.  As in the JAX package no model route takes it: its entry
  point is the function itself, with a caller-set ``block_rows``.

All are forward-only, as their TPU kernels: training and autograd keep the
T-loops of ``snn/neuron.py``.

Each wrapper takes its plain version for a tensor on the CPU or inside
``route.plain_kernels()``, and only then.  For a CUDA tensor it launches its
kernel or raises.  ``lif_fused.launches``, ``ecs_lif_fused_rows.launches``
and ``ecs_lif_fused_v2.launches`` count the launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

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


# --- ECS-LIF with its state in shared memory -------------------------------------

#: dynamic shared memory one block may hold on sm_90 (227 KB)
SMEM_PER_BLOCK = 232448
#: the largest thread-block cluster the kernel launches (the portable size)
MAX_CLUSTER = 8
#: channels one block of a cluster aims to own: its state planes then leave
#: room for a window of some 24 x 24 pixels (bf16) or 16 x 16 (f32)
TARGET_CHANNELS = {2: 64, 4: 32}


def split_channels(c: int, itemsize: int) -> Tuple[int, int, int]:
    """``(cluster, channels, pitch)``: how many blocks of a thread-block
    cluster share a tile's C channels, how many each owns, and the row pitch
    (elements) of its state planes in shared memory.

    The cluster doubles while a block would own more than
    ``TARGET_CHANNELS`` channels and the split stays a multiple of 16 (the
    product's K step).  Unsplit, the channels are padded to a multiple of 16
    with zeros.  The pitch pads each pixel's row by 16 bytes, so that the
    rows of a product tile fall on different banks.
    """
    cs = 1
    while (cs < MAX_CLUSTER and c // cs > TARGET_CHANNELS[itemsize]
           and c % (2 * cs) == 0 and (c // (2 * cs)) % 16 == 0):
        cs *= 2
    cl = c // cs if cs > 1 else -(-c // 16) * 16
    return cs, cl, cl + 16 // itemsize


def _window(n: int, tile: int, halo: int) -> int:
    """Pixels (along one axis) of the largest window a tile needs."""
    return min(n, tile + 2 * halo)


def max_block_rows(shape, itemsize: int) -> int:
    """The largest ``block_rows`` whose tile fits one block's shared memory
    on the card (with one-column tiles), for ``x`` of ``shape`` ``[T, N, H,
    W, C]``; 0 when not even one row fits."""
    t, _, h, w, c = shape
    halo = t - 1
    _, _, pitch = split_channels(c, itemsize)
    rows = SMEM_PER_BLOCK // (3 * pitch * itemsize) // _window(w, 1, halo)
    return h if rows >= h else max(0, rows - 2 * halo)


@functools.lru_cache(maxsize=256)
def plan_v2(shape, itemsize: int, block_rows: int, sms: int) -> Tuple[int, ...]:
    """``(cluster, channels, pitch, rows, cols)`` of a launch of
    :func:`ecs_lif_fused_v2` for ``x`` of ``shape`` ``[T, N, H, W, C]``.

    A tile of ``rows x cols`` output pixels is computed on its window grown
    by T-1 pixels on each side and clipped to the image, whose state planes
    (mem, ecs and the depthwise sum d, ``pitch`` elements a pixel) must fit
    ``SMEM_PER_BLOCK``.  ``block_rows`` > 0 fixes the rows (clipped to H)
    and takes the columns that cost least; 0 searches both.  The cost of a
    tiling is the waves of blocks the card runs (one block an SM) times the
    window a block computes; on a tie the larger tile wins (less work in
    all).  Raises ``ValueError`` where no tile fits.
    """
    t, n, h, w, c = shape
    halo = t - 1
    cs, cl, pitch = split_channels(c, itemsize)
    px = SMEM_PER_BLOCK // (3 * pitch * itemsize)
    if block_rows:
        br = min(block_rows, h)
        if _window(h, br, halo) * _window(w, 1, halo) > px:
            most = max_block_rows(shape, itemsize)
            raise ValueError(
                f"block_rows={block_rows} does not fit: a window of "
                f"{_window(h, br, halo)} rows x {_window(w, 1, halo)} columns "
                f"x {cl} channels needs more than the {SMEM_PER_BLOCK} bytes of "
                f"shared memory a block has; the largest block_rows that fits "
                f"is {most}")
        rows = [br]
    else:
        rows = range(1, h + 1)
    best, best_key = None, None
    for br in rows:
        wr = _window(h, br, halo)
        for bc in range(1, w + 1):
            win = wr * _window(w, bc, halo)
            if win > px:
                break
            blocks = n * math.ceil(h / br) * math.ceil(w / bc) * cs
            key = (math.ceil(blocks / sms) * win, blocks * win)
            if best_key is None or key <= best_key:
                best, best_key = (br, bc), key
    if best is None:
        raise ValueError(
            f"no tile of a {h}x{w}x{c} site fits one block's {SMEM_PER_BLOCK} "
            f"bytes of shared memory (a {_window(h, 1, halo)}x"
            f"{_window(w, 1, halo)} window of {cl} channels is too large)")
    return (cs, cl, pitch) + best


def ecs_lif_fused_v2(x, dw_kernel, dw_bias, pw_kernel, pw_bias, cfg: SNNConfig,
                     act: bool = False, block_rows: int = 0) -> torch.Tensor:
    """ECS-LIF spikes of ``x`` ``[T, N, H, W, C]`` (float32 or bfloat16), any
    shape and strides, with the recurrence's state held in shared memory
    (``csrc/ecs_lif_v2.cu``; the counterpart of the JAX
    ``pallas_kernels.ecs_lif_fused_v2``).

    It computes :func:`ecs_lif_fused_rows`'s function, and its plain version
    is :func:`ecs_lif_rows_reference`.  ``block_rows`` > 0 sets the rows of
    a tile's interior (clipped to H), as the JAX ``block_rows``; 0 lets
    :func:`plan_v2` choose rows and columns for the card.  The result does
    not depend on the tiling.  A ``block_rows`` whose tile does not fit a
    block's shared memory raises ``ValueError`` naming the largest that fits
    (:func:`max_block_rows`); on the CPU every ``block_rows`` >= 0 is taken.
    """
    if isinstance(block_rows, bool) or not isinstance(block_rows, int) or block_rows < 0:
        raise ValueError(f"block_rows must be an int >= 0, got {block_rows!r}")
    if not use_kernel(x):
        return ecs_lif_rows_reference(x, dw_kernel, dw_bias, pw_kernel,
                                      pw_bias, cfg, act)
    check_params(x, dw_kernel, dw_bias, pw_kernel, pw_bias, "ecs_lif_fused_v2")
    t, n, h, w, c = x.shape
    if n > 65535:
        raise ValueError(f"N = {n} exceeds the 65535 images one launch takes "
                         "(the grid's z extent)")
    dt = x.dtype
    out = torch.empty((t, n, h, w, c), dtype=dt, device=x.device)
    if out.numel() == 0:
        return out
    item = x.element_size()
    plan_v2(tuple(x.shape), item, block_rows, 1)      # a tile that cannot fit raises here
    from .. import _build

    lib = _build.load("ecs_lif_v2")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    cs, cl, pitch, br, bc = plan_v2(tuple(x.shape), item, block_rows, sms)
    if math.ceil(h / br) > 65535 or math.ceil(w / bc) * cs > 2 ** 31 - 1:
        raise ValueError(f"{math.ceil(h / br)} x {math.ceil(w / bc)} tiles exceed "
                         "the grid's extents")
    fn = lib.ecs_lif_v2_fwd
    vp, ll, ci, cf = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ci, vp, ll, ll, ll, ll, ll, vp, vp, vp, vp, vp, ci, ci, ci, ci,
                   ci, ci, ci, ci, ci, ci, ci, cf, cf, cf, cf, cf, ci, ci, vp]
    fn.restype = ci
    lib.ecs_lif_v2_error_string.argtypes = [ci]
    lib.ecs_lif_v2_error_string.restype = ctypes.c_char_p

    cp = cs * cl                              # channels, padded to the split
    dw = dw_kernel.to(dt).contiguous()
    dwb = dw_bias.to(dt).contiguous()
    pwb = pw_bias.to(dt).contiguous()
    pw = pw_kernel.to(dt).reshape(c, c)       # [Cin, Cout]
    if dt == torch.bfloat16:
        pw = pw.t()                           # tensor-core B operand: [Cout, Cin]
    pwp = torch.zeros((cp, cp), dtype=dt, device=x.device)
    pwp[:c, :c] = pw
    smem = 3 * _window(h, br, t - 1) * _window(w, bc, t - 1) * pitch * item
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(DTYPE_CODES[dt], x.data_ptr(), *x.stride(), out.data_ptr(),
             dw.data_ptr(), dwb.data_ptr(), pwp.data_ptr(), pwb.data_ptr(),
             t, n, h, w, c, cs, cl, pitch, br, bc, t - 1,
             float(cfg.thresh), _const(cfg.decay, x), _const(cfg.alpha, x),
             _const(cfg.beta, x), _const(1.0 - 1.0 / cfg.ecs_tau, x),
             int(act), smem, stream)
    if err != 0:
        raise RuntimeError("ecs_lif_v2 kernel launch failed: "
                           + lib.ecs_lif_v2_error_string(err).decode())
    ecs_lif_fused_v2.launches += 1
    return out


ecs_lif_fused_v2.launches = 0
