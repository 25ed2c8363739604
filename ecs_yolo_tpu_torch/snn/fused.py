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

import array
import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import SNNConfig
from .ecs_lif import (DTYPE_CODES, K1_TILE, _barrier, _consts, _fail_on, _occupancy,
                      _pw_vec, check_params, k1_block_items, k1_window)
from .neuron import _const, lif_scan
from .route import use_kernel
from .spread import _entry, _sms, _stream
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


# --- ECS-LIF, any shape: K2's plan ------------------------------------------------

#: pixels of a work item of K2: K1's tiles of the flat N*H*W plane, with K1's
#: windows (``k2_window``) and K1's rule of which block owns which item
#: (``k2_block_items``)
K2_TILE = K1_TILE
k2_window = k1_window
k2_block_items = k1_block_items
#: input channels of a K-chunk
K2_CHUNK = 32
#: output channels of a work item, the one slice the kernel is built for: a
#: thread's accumulators (8 x 4) and the tail's loads stay within 128
#: registers, so that two blocks share an SM; channels past C are masked
K2_SLICE = 64
#: blocks of K2 an SM holds off the card (at most 128 registers a thread of
#: 256: two); on the card the wrapper asks the occupancy query
K2_BLOCKS_PER_SM = 2


class K2Plan(NamedTuple):
    """A launch of K2: items of ``tile`` pixels x ``slice`` output channels
    (``slices`` of them cover C; ``tiles`` tiles cover the N*H*W pixels),
    K-chunks of ``chunk`` input channels, ``grid`` blocks (a multiple of
    ``slices``: block b owns slice ``b % slices``), windows of ``window``
    pixel slots, ``smem`` bytes of dynamic shared memory a block."""
    tile: int
    slice: int
    slices: int
    chunk: int
    tiles: int
    items: int
    grid: int
    window: int
    smem: int


def k2_smem(itemsize: int, w: int) -> int:
    """Dynamic shared memory of a block (``csrc/ecs_lif_rows.cu``'s layout):
    two window stages of one chunk's channels a slot, each also large enough
    for the eight warps' staged outputs (32 pixels x slice/2 channels a warp,
    rows padded by 16 bytes), the float32 d tile ``[32][128]``, two stages
    of the float32 pw tile ``[32][slice]`` and of the chunk's depthwise
    weights and bias (``10 * 32`` elements), the slice's pw bias, and one
    window slot of zeros."""
    stage = max(k2_window(w) * K2_CHUNK * itemsize,
                8 * 32 * (K2_SLICE // 2 * itemsize + 16))
    return (2 * stage + K2_CHUNK * K2_TILE * 4 + 2 * K2_CHUNK * K2_SLICE * 4
            + (2 * 10 * K2_CHUNK + K2_SLICE + K2_CHUNK) * itemsize)


@functools.lru_cache(maxsize=256)
def plan_k2(n: int, h: int, w: int, c: int, sms: int = 132,
            dtype: torch.dtype = torch.bfloat16,
            blocks_per_sm: Optional[int] = None) -> K2Plan:
    """K2's plan for ``[n, h, w, c]`` sites on a card of ``sms`` SMs.

    Items are ``K2_SLICE`` output channels wide: the product's parallelism
    comes from items, never from splitting a sum.  The grid is every block
    the card holds at once (``blocks_per_sm`` from the occupancy query, else an estimate),
    rounded down to a multiple of the slices and no more than the items: a
    cooperative launch needs every block resident.  Any C > 0 is taken.
    """
    if min(n, h, w, c) <= 0:
        raise ValueError(f"plan_k2: empty site {n}x{h}x{w}x{c}")
    itemsize = torch.tensor([], dtype=dtype).element_size()
    slices = math.ceil(c / K2_SLICE)
    tiles = math.ceil(n * h * w / K2_TILE)
    per_sm = K2_BLOCKS_PER_SM if blocks_per_sm is None else blocks_per_sm
    resident = per_sm * sms // slices * slices
    if resident < slices:
        raise ValueError(f"plan_k2: {per_sm} blocks an SM on {sms} SMs hold fewer "
                         f"than the {slices} slices of C={c}")
    grid = max(slices, min(resident, tiles * slices))
    return K2Plan(K2_TILE, K2_SLICE, slices, K2_CHUNK, tiles, tiles * slices, grid,
                  k2_window(w), k2_smem(itemsize, w))


# --- ECS-LIF, any shape: the plain versions ---------------------------------------


def _rows_params(x, dw_kernel, dw_bias, pw_kernel, pw_bias, cfg: SNNConfig):
    """The spread parameters in x's dtype (pw as float32 ``[Cin, Cout]``) and
    the constants rounded to it, as the plain versions use them."""
    dt = x.dtype
    c = x.shape[-1]
    decay, alpha, beta = (_const(v, x) for v in (cfg.decay, cfg.alpha, cfg.beta))
    return (dw_kernel.to(dt).reshape(3, 3, c), dw_bias.to(dt),
            pw_kernel.to(dt).reshape(c, c).float(), pw_bias.to(dt),
            decay, alpha, beta, _const(1.0 - 1.0 / cfg.ecs_tau, x))


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
    t_steps, n, h, w, c = x.shape
    dw, dwb, pw, pwb, decay, alpha, beta, leak = _rows_params(
        x, dw_kernel, dw_bias, pw_kernel, pw_bias, cfg)
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
        ecs = alpha * (acc.to(x.dtype) + pwb) + leak * ecs
    return torch.stack(out)


@torch.no_grad()
def k2_grid_walk_reference(x, dw_kernel, dw_bias, pw_kernel, pw_bias,
                           cfg: SNNConfig, act: bool = False,
                           plan: Optional[K2Plan] = None) -> torch.Tensor:
    """K2's walk in plain PyTorch, for the CPU tests of the plan.

    Step 0 fires x_0.  At every later step each block of the plan takes its
    items in order; an item computes, K-chunk by K-chunk, the depthwise 3x3
    of the previous step's spikes over its pixels (tap by tap in the dtype,
    + dwb) and adds the chunk's products with its slice of pw into a float32
    sum, one input channel at a time in index order; its epilogue rounds the
    sum, adds pwb and updates ecs, mem and the spike in the kernel's order,
    with mem and ecs kept in a ``[2, P, C]`` workspace.  Every operation is
    the plain version's, so the two are bit-equal.
    """
    dt = x.dtype
    t_steps, n, h, w, c = x.shape
    if plan is None:
        plan = plan_k2(n, h, w, c, 132, dt)
    p_all = n * h * w
    xf = x.reshape(t_steps, p_all, c)
    dw, dwb, pw, pwb, decay, alpha, beta, leak = _rows_params(
        x, dw_kernel, dw_bias, pw_kernel, pw_bias, cfg)
    dw = dw.reshape(9, c)
    out = torch.full((t_steps, p_all, c), float("nan"), dtype=dt)
    out[0] = spike_fn(xf[0], cfg.thresh, cfg.lens, act)
    ws = torch.zeros((2, p_all, c), dtype=dt)
    pix = torch.arange(p_all)
    hh, ww = (pix // w) % h, pix % w
    for t in range(1, t_steps):
        prev = F.pad(out[t - 1].reshape(n, h, w, c), (0, 0, 1, 1, 1, 1))
        for b in range(plan.grid):
            for tile, sl in k2_block_items(plan, b):
                px = pix[tile * plan.tile:(tile + 1) * plan.tile]
                cs = slice(sl * plan.slice, min(c, (sl + 1) * plan.slice))
                i_n, i_h, i_w = px // (h * w), hh[px], ww[px]
                acc = torch.zeros((len(px), cs.stop - cs.start))
                for k0 in range(0, c, plan.chunk):
                    ks = slice(k0, min(c, k0 + plan.chunk))
                    d = torch.zeros((len(px), ks.stop - ks.start), dtype=dt)
                    for tap in range(9):
                        d = d + prev[i_n, i_h + tap // 3, i_w + tap % 3, ks] * dw[tap, ks]
                    d = (d + dwb[ks]).float()
                    for ci in range(ks.start, ks.stop):
                        acc = acc + d[:, ci - k0:ci - k0 + 1] * pw[ci, cs]
                e = acc.to(dt) + pwb[cs]
                if t == 1:
                    mem, ecs = xf[0][px, cs], torch.zeros_like(e)
                else:
                    mem, ecs = ws[0][px, cs], ws[1][px, cs]
                ecs = alpha * e + leak * ecs
                fecs = beta * torch.tanh(ecs)
                spk = out[t - 1][px, cs]
                mem = mem * decay * (1.0 - spk) + xf[t][px, cs] + fecs
                out[t][px, cs] = spike_fn(mem, cfg.thresh, cfg.lens, act)
                ws[0][px, cs], ws[1][px, cs] = mem, ecs
    return out.reshape(t_steps, n, h, w, c)


# --- ECS-LIF, any shape: the launch ------------------------------------------------

_K2_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p]


def k2_launch_plan(x: torch.Tensor) -> K2Plan:
    """The plan a launch of K2 on ``x`` ``[T, N, H, W, C]`` takes."""
    t, n, h, w, c = x.shape
    sms = _sms(x.device)
    occ = _occupancy("ecs_lif_rows", x.device, x.dtype, K2_SLICE,
                     k2_smem(x.element_size(), w), K2_BLOCKS_PER_SM)
    return plan_k2(n, h, w, c, sms, x.dtype, occ)


def _x_vec(x: torch.Tensor) -> int:
    """1 where the kernel may read x in runs of up to 8 channels: unit
    channel stride, the other strides multiples of 8 and a 16-byte aligned
    start (a broadcast T axis has stride 0)."""
    return int(x.stride(4) == 1 and all(s % 8 == 0 for s in x.stride()[:4])
               and x.data_ptr() % 16 == 0)


def ecs_lif_fused_rows(x, dw_kernel, dw_bias, pw_kernel, pw_bias,
                       cfg: SNNConfig, act: bool = False) -> torch.Tensor:
    """ECS-LIF spikes of ``x`` ``[T, N, H, W, C]`` (float32 or bfloat16) for
    any H, W, C and any strides of ``x``.

    The spread parameters have the JAX shapes (``dw_kernel`` ``[3, 3, 1, C]``,
    ``dw_bias`` ``[C]``, ``pw_kernel`` ``[1, 1, C, C]``, ``pw_bias`` ``[C]``);
    they are cast to x's dtype (no copy where they have it) and read through
    their strides.  The update of ``ecs`` after the last step, which the TPU
    kernel computes and nobody observes, is skipped.
    """
    if not use_kernel(x):
        return ecs_lif_rows_reference(x, dw_kernel, dw_bias, pw_kernel,
                                      pw_bias, cfg, act)
    check_params(x, dw_kernel, dw_bias, pw_kernel, pw_bias, "ecs_lif_fused_rows")
    dt = x.dtype
    dw, dwb, pw, pwb = (p if p.dtype == dt else p.to(dt)
                        for p in (dw_kernel, dw_bias, pw_kernel, pw_bias))
    t, n, h, w, c = x.shape
    out = torch.empty((t, n, h, w, c), dtype=dt, device=x.device)
    if out.numel() == 0:
        return out
    fn = _entry("ecs_lif_rows", "ecs_lif_rows_fwd", _K2_ARGTYPES)   # built and bound first
    plan = k2_launch_plan(x)
    stream = _stream(x)
    ws = torch.empty((2, n * h * w * c) if t > 2 else (0,), dtype=dt, device=x.device)
    args = array.array("q", (
        DTYPE_CODES[dt], plan.slice, x.data_ptr(), *x.stride(), _x_vec(x),
        out.data_ptr(), dw.data_ptr(), dw.stride(0), dw.stride(1), dw.stride(3),
        dwb.data_ptr(), dwb.stride(0), pw.data_ptr(), pw.stride(2), pw.stride(3),
        _pw_vec(pw) if c % 8 == 0 else 0, pwb.data_ptr(), pwb.stride(0), ws.data_ptr(),
        _barrier(x, stream).data_ptr(), t, n, h, w, c, plan.slices, plan.tiles,
        plan.grid, plan.smem, int(act), stream))
    consts = _consts(dt, cfg.thresh, cfg.decay, cfg.alpha, cfg.beta, cfg.ecs_tau)
    _fail_on(fn(args.buffer_info()[0], consts), "launch", "ecs_lif_rows")
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
