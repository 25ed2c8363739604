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
  function in K1's launch design (one cooperative launch a site over (tile
  x Cout slice) items, the 1x1 on the tensor cores in bf16), with the
  recurrence's state held in the block's shared memory where it fits
  (float32).  As in the JAX package no model route takes it: its entry
  point is the function itself, with a caller-set ``block_rows``.

All are forward-only, as their TPU kernels: training and autograd keep the
T-loops of ``snn/neuron.py``.

``lif_fused`` and ``ecs_lif_fused_rows`` call their ops
(``torch.ops.ecs_yolo_torch.lif`` and ``.ecs_lif_rows``, ``snn/ops.py``),
whose implementations are :func:`run_k6` and :func:`run_k2`; K3 is called
directly.  Each takes its plain version for a tensor on the CPU or inside
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
from .ecs_lif import (DTYPE_CODES, K1_SLICES, K1_TILE, SMEM_PER_BLOCK, _barrier, _consts,
                      _fail_on, _occupancy, _pw_vec, check_params, k1_block_items,
                      k1_smem, k1_window)
from . import ops
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


#: the argument types of ``lif_fused_fwd``: one int64 block, the constants
_LIF_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p]


@functools.lru_cache(maxsize=64)
def _lif_consts(dtype: torch.dtype, thresh: float, decay: float):
    """K6's constants, the decay rounded to the dtype once (the threshold is
    compared in float32): a ctypes float[2]."""
    return (ctypes.c_float * 2)(float(thresh), _const(decay, torch.empty(0, dtype=dtype)))


def lif_fused(x: torch.Tensor, cfg: SNNConfig, act: bool = False) -> torch.Tensor:
    """Plain-LIF spikes of ``x`` ``[T, ...]`` (float32 or bfloat16), any
    shape behind T.  The dims behind T must be dense; the T axis may be a
    broadcast (stride 0).  The call goes through the op
    ``torch.ops.ecs_yolo_torch.lif`` (``snn/ops.py``), whose implementation
    is :func:`run_k6`."""
    use_kernel(x)
    return ops.lif(x, *ops.cfg_args(cfg), act)


def run_k6(x: torch.Tensor, cfg: SNNConfig, act: bool = False) -> torch.Tensor:
    """The op's implementation: the plain version for a CPU tensor or inside
    ``plain_kernels()``, else K6's launch, counted in
    ``lif_fused.launches``."""
    if not use_kernel(x):
        return lif_reference(x, cfg, act)
    if x.dim() < 2:
        raise ValueError(f"x must be [T, ...], got {tuple(x.shape)}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"lif_fused takes float32 or bfloat16, not {x.dtype}")
    t = x.shape[0]
    m = math.prod(x.shape[1:])
    if not x.is_contiguous():
        if m and not x[0].is_contiguous():
            raise ValueError(f"x's dims behind T must be contiguous, strides "
                             f"{x.stride()}")
        if t > 1 and x.stride(0) not in (0, m):
            raise ValueError(f"x's T stride must be 0 or {m}, got {x.stride(0)}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _entry("lif_fused", "lif_fused_fwd", _LIF_ARGTYPES)     # built and bound first
    args = array.array("q", (DTYPE_CODES[x.dtype], x.data_ptr(),
                             x.stride(0) if t > 1 else 0, out.data_ptr(), m, t,
                             int(act), _stream(x)))
    _fail_on(fn(args.buffer_info()[0], _lif_consts(x.dtype, cfg.thresh, cfg.decay)),
             "launch", "lif_fused")
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

    The call goes through the op ``torch.ops.ecs_yolo_torch.ecs_lif_rows``
    (``snn/ops.py``), whose implementation is :func:`run_k2`.
    """
    use_kernel(x)
    return ops.ecs_lif_rows(x, dw_kernel, dw_bias, pw_kernel, pw_bias,
                            *ops.cfg_args(cfg), act)


def run_k2(x, dw_kernel, dw_bias, pw_kernel, pw_bias, cfg: SNNConfig,
           act: bool = False) -> torch.Tensor:
    """The op's implementation: the plain version for a CPU tensor or inside
    ``plain_kernels()``, else K2's launch, counted in
    ``ecs_lif_fused_rows.launches``."""
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


# --- ECS-LIF with its state on chip: K3's plan ------------------------------------

#: pixels of a run: the product's M granularity (two warpgroups of 64 rows)
K3_RUN = K1_TILE
#: shared memory of one SM (H100: 228 KB), of which each resident block
#: takes its dynamic shared memory and 1 KB of its own
SMEM_PER_SM = 233472
#: blocks of K3 an SM holds off the card (as K1: one); on the card the
#: wrapper asks the occupancy query
K3_BLOCKS_PER_SM = 1


class K3Plan(NamedTuple):
    """A launch of K3: items of ``tile`` pixels (``sub`` runs of 128) x
    ``slice`` output channels (``slices`` of them cover C; ``tiles`` tiles
    cover the N*H*W pixels), K-chunks of ``chunk`` input channels, ``grid``
    blocks (a multiple of ``slices``: block b owns slice ``b % slices``),
    windows of ``window`` pixel slots, ``smem`` bytes of dynamic shared
    memory a block, the recurrence's state in ``state``: ``"shared"`` (the
    block's shared memory) or ``"workspace"`` (device memory)."""
    tile: int
    sub: int
    slice: int
    slices: int
    chunk: int
    tiles: int
    items: int
    grid: int
    window: int
    smem: int
    state: str


def k3_smem(itemsize: int, c: int, w: int, n_slice: int, state_items: int = 0,
            sub: int = 1) -> int:
    """Dynamic shared memory of a block (``csrc/ecs_lif_v2.cu``'s layout):
    K1's (:func:`k1_smem`), one window slot of zeros in f32, and the mem and
    ecs of ``state_items`` items of ``sub`` runs x ``n_slice`` channels where
    the state is held there."""
    state = 2 * state_items * sub * K3_RUN * n_slice * itemsize
    return k1_smem(itemsize, c, w, n_slice) + (128 if itemsize == 4 else 0) + state


def k3_state_fits(smem: int, blocks_per_sm: int) -> bool:
    """Whether blocks of ``smem`` bytes (the state in shared memory) still
    fit ``blocks_per_sm`` to an SM."""
    return smem <= SMEM_PER_BLOCK and blocks_per_sm * (smem + 1024) <= SMEM_PER_SM


def _k3_slices(c: int) -> List[int]:
    """The Cout slices K3 may take at C, widest first (no wider than C
    rounded up to 32)."""
    return [n for n in K1_SLICES if n <= 32 * math.ceil(c / 32)]


@functools.lru_cache(maxsize=1024)
def _k3_item_slice(c: int, w: int, itemsize: int, sub: int) -> Optional[int]:
    """The widest Cout slice whose block holds one item of ``sub`` runs with
    its state, or None."""
    for n_slice in _k3_slices(c):
        if k3_smem(itemsize, c, w, n_slice, 1, sub) <= SMEM_PER_BLOCK:
            return n_slice
    return None


def _k3_sub(rows: int, w: int) -> int:
    """Runs of an item of ``rows`` image rows: rows * W pixels rounded up to
    the product's M granularity."""
    return math.ceil(rows * w / K3_RUN)


@functools.lru_cache(maxsize=256)
def max_block_rows(shape, itemsize: int) -> int:
    """The largest ``block_rows`` whose item fits, for ``x`` of ``shape``
    ``[T, N, H, W, C]``: a block's shared memory holds one item's mem and
    ecs beside its B slice and windows (the TPU kernel's scratch), at some
    Cout slice.  H where the whole height fits (any larger block_rows is
    H); 0 when not even one row does."""
    _, _, h, w, c = shape
    lo, hi = 0, h                    # fits(lo) (or lo = 0), the answer is in [lo, hi]
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if _k3_item_slice(c, w, itemsize, _k3_sub(mid, w)) is not None:
            lo = mid
        else:
            hi = mid - 1
    return lo


@functools.lru_cache(maxsize=256)
def plan_k3(n: int, h: int, w: int, c: int, sms: int = 132,
            dtype: torch.dtype = torch.bfloat16, block_rows: int = 0,
            blocks_per_sm: Optional[int] = None) -> K3Plan:
    """K3's plan for ``[n, h, w, c]`` sites on a card of ``sms`` SMs.

    ``block_rows`` > 0 sets the rows of an item (clipped to H): its tile is
    block_rows * W pixels rounded up to 128, and its slice the widest whose
    block holds one item's state beside B and the windows; a block_rows
    whose item fits no slice raises ``ValueError`` naming the largest that
    fits (:func:`max_block_rows`).  0: items of one run at K1's slice (the
    widest whose B and windows fit).  The grid is every block the card holds
    at once (``blocks_per_sm`` from the occupancy query, else an estimate),
    rounded down to a multiple of the slices and no more than the items.
    The state is held in shared memory in float32 where the busiest block's
    items fit there without lowering the blocks an SM holds, else in the
    workspace (bf16's state reads no faster from shared memory than
    through L2 where it fits, f32's 3-7 % faster; PERF.md §6).
    """
    if min(n, h, w, c) <= 0:
        raise ValueError(f"plan_k3: empty site {n}x{h}x{w}x{c}")
    itemsize = torch.tensor([], dtype=dtype).element_size()
    if block_rows:
        sub = _k3_sub(min(block_rows, h), w)
        n_slice = _k3_item_slice(c, w, itemsize, sub)
        if n_slice is None:
            most = max_block_rows((0, n, h, w, c), itemsize)
            raise ValueError(
                f"block_rows={block_rows} does not fit: an item of {sub * K3_RUN} pixels "
                f"holds its mem and ecs in no block's {SMEM_PER_BLOCK} bytes of shared "
                f"memory beside its Cout slice of pw and its windows at C={c}, W={w}; "
                f"the largest block_rows that fits is {most}")
    else:
        sub = 1
        n_slice = next((s for s in _k3_slices(c)
                        if k3_smem(itemsize, c, w, s) <= SMEM_PER_BLOCK), None)
        if n_slice is None:
            raise ValueError(f"ecs_lif_fused_v2: no Cout slice fits the shared memory at "
                             f"C={c}, W={w}")
    slices = math.ceil(c / n_slice)
    tile = sub * K3_RUN
    tiles = math.ceil(n * h * w / tile)
    per_sm = K3_BLOCKS_PER_SM if blocks_per_sm is None else blocks_per_sm
    resident = per_sm * sms // slices * slices
    if resident < slices:
        raise ValueError(f"plan_k3: {per_sm} blocks an SM on {sms} SMs hold fewer "
                         f"than the {slices} slices of C={c}")
    grid = max(slices, min(resident, tiles * slices))
    most = math.ceil(tiles / (grid // slices))
    smem = k3_smem(itemsize, c, w, n_slice, most, sub)
    state = "shared"
    if itemsize == 2 or not k3_state_fits(smem, per_sm):
        smem, state = k3_smem(itemsize, c, w, n_slice, 0, sub), "workspace"
    return K3Plan(tile, sub, n_slice, slices, 128 // itemsize, tiles, tiles * slices, grid,
                  k1_window(w), smem, state)


#: the ``(tile, slice)`` items block ``b`` owns, K1's rule
k3_block_items = k1_block_items


@torch.no_grad()
def k3_grid_walk_reference(x, dw_kernel, dw_bias, pw_kernel, pw_bias,
                           cfg: SNNConfig, act: bool = False,
                           plan: Optional[K3Plan] = None) -> torch.Tensor:
    """K3's walk in plain PyTorch, for the CPU tests of the plan.

    Step 0 fires x_0.  At every later step each block of the plan takes its
    items in order and each item its 128-pixel runs in order; a run
    computes, K-chunk by K-chunk, the depthwise 3x3 of the previous step's
    spikes over its pixels (tap by tap in the dtype, + dwb) and adds the
    chunk's products with its slice of pw into a float32 sum, one input
    channel at a time in index order; its epilogue rounds the sum, adds pwb
    and updates ecs, mem and the spike in the kernel's order, with the
    block's state kept per run (the plan's ``state`` decides only where the
    kernel keeps it).  Every operation is the plain version's, so on data
    whose products and sums are exact (dyadic) the two are bit-equal; the
    kernel's bf16 product sums on the tensor cores in another order.
    """
    dt = x.dtype
    t_steps, n, h, w, c = x.shape
    if plan is None:
        plan = plan_k3(n, h, w, c, 132, dt)
    p_all = n * h * w
    xf = x.reshape(t_steps, p_all, c)
    dw, dwb, pw, pwb, decay, alpha, beta, leak = _rows_params(
        x, dw_kernel, dw_bias, pw_kernel, pw_bias, cfg)
    dw = dw.reshape(9, c)
    out = torch.full((t_steps, p_all, c), float("nan"), dtype=dt)
    out[0] = spike_fn(xf[0], cfg.thresh, cfg.lens, act)
    state = {}                       # (block, run) -> (mem, ecs) of the run's slice
    pix = torch.arange(p_all)
    hh, ww = (pix // w) % h, pix % w
    for t in range(1, t_steps):
        prev = F.pad(out[t - 1].reshape(n, h, w, c), (0, 0, 1, 1, 1, 1))
        for b in range(plan.grid):
            runs = [(tile * plan.sub + u, sl) for tile, sl in k3_block_items(plan, b)
                    for u in range(plan.sub)]
            for r, (run, sl) in enumerate(runs):
                px = pix[run * K3_RUN:(run + 1) * K3_RUN]
                if len(px) == 0:
                    continue
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
                    mem, ecs = state[b, r]
                ecs = alpha * e + leak * ecs
                fecs = beta * torch.tanh(ecs)
                spk = out[t - 1][px, cs]
                mem = mem * decay * (1.0 - spk) + xf[t][px, cs] + fecs
                out[t][px, cs] = spike_fn(mem, cfg.thresh, cfg.lens, act)
                state[b, r] = (mem, ecs)
    return out.reshape(t_steps, n, h, w, c)


# --- ECS-LIF with its state on chip: the launch -------------------------------------

_K3_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p]


def k3_launch_plan(x: torch.Tensor, block_rows: int = 0) -> K3Plan:
    """The plan a launch of K3 on ``x`` ``[T, N, H, W, C]`` takes (the
    occupancy asked at the plan's slice and its shared memory without the
    state; the state is taken into shared memory only where it keeps that
    occupancy)."""
    t, n, h, w, c = x.shape
    probe = plan_k3(n, h, w, c, 132, x.dtype, block_rows, K3_BLOCKS_PER_SM)
    occ = _occupancy("ecs_lif_v2", x.device, x.dtype, probe.slice,
                     k3_smem(x.element_size(), c, w, probe.slice, 0, probe.sub),
                     K3_BLOCKS_PER_SM)
    return plan_k3(n, h, w, c, _sms(x.device), x.dtype, block_rows, occ)


def _launch_k3(x, dw, dwb, pw, pwb, cfg: SNNConfig, act: bool, plan: K3Plan) -> torch.Tensor:
    """One launch of K3 on ``plan``: the parameters in x's dtype, read
    through their strides."""
    t, n, h, w, c = x.shape
    out = torch.empty((t, n, h, w, c), dtype=x.dtype, device=x.device)
    fn = _entry("ecs_lif_v2", "ecs_lif_v2_fwd", _K3_ARGTYPES)
    stream = _stream(x)
    ws = torch.empty((2, n * h * w * c) if t > 2 and plan.state == "workspace" else (0,),
                     dtype=x.dtype, device=x.device)
    args = array.array("q", (
        DTYPE_CODES[x.dtype], plan.slice, x.data_ptr(), *x.stride(), _x_vec(x),
        out.data_ptr(), dw.data_ptr(), dw.stride(0), dw.stride(1), dw.stride(3),
        dwb.data_ptr(), dwb.stride(0), pw.data_ptr(), pw.stride(2), pw.stride(3),
        _pw_vec(pw) if c % 8 == 0 else 0, pwb.data_ptr(), pwb.stride(0), ws.data_ptr(),
        _barrier(x, stream).data_ptr(), t, n, h, w, c, plan.slices, plan.tiles, plan.sub,
        int(plan.state == "shared"), plan.grid, plan.smem, int(act), stream))
    consts = _consts(x.dtype, cfg.thresh, cfg.decay, cfg.alpha, cfg.beta, cfg.ecs_tau)
    _fail_on(fn(args.buffer_info()[0], consts), "launch", "ecs_lif_v2")
    ecs_lif_fused_v2.launches += 1
    return out


def ecs_lif_fused_v2(x, dw_kernel, dw_bias, pw_kernel, pw_bias, cfg: SNNConfig,
                     act: bool = False, block_rows: int = 0) -> torch.Tensor:
    """ECS-LIF spikes of ``x`` ``[T, N, H, W, C]`` (float32 or bfloat16), any
    shape and strides, with the recurrence's state held on chip where it
    fits (``csrc/ecs_lif_v2.cu``; the counterpart of the JAX
    ``pallas_kernels.ecs_lif_fused_v2``).

    It computes :func:`ecs_lif_fused_rows`'s function, and its plain version
    is :func:`ecs_lif_rows_reference`.  ``block_rows`` > 0 sets the rows of
    an item (clipped to H), as the JAX ``block_rows``; 0 lets
    :func:`plan_k3` choose.  The result does not depend on the tiling.  A
    ``block_rows`` whose item does not fit a block's shared memory raises
    ``ValueError`` naming the largest that fits (:func:`max_block_rows`);
    on the CPU every ``block_rows`` >= 0 is taken.  The spread parameters
    have the JAX shapes and are cast to x's dtype (no copy where they have
    it) and read through their strides.
    """
    if isinstance(block_rows, bool) or not isinstance(block_rows, int) or block_rows < 0:
        raise ValueError(f"block_rows must be an int >= 0, got {block_rows!r}")
    if not use_kernel(x):
        return ecs_lif_rows_reference(x, dw_kernel, dw_bias, pw_kernel,
                                      pw_bias, cfg, act)
    check_params(x, dw_kernel, dw_bias, pw_kernel, pw_bias, "ecs_lif_fused_v2")
    t, n, h, w, c = x.shape
    if x.numel() == 0:
        return torch.empty((t, n, h, w, c), dtype=x.dtype, device=x.device)
    plan_k3(n, h, w, c, 132, x.dtype, block_rows)   # an item that cannot fit raises here
    dt = x.dtype
    dw, dwb, pw, pwb = (p if p.dtype == dt else p.to(dt)
                        for p in (dw_kernel, dw_bias, pw_kernel, pw_bias))
    _entry("ecs_lif_v2", "ecs_lif_v2_fwd", _K3_ARGTYPES)            # built and bound first
    return _launch_k3(x, dw, dwb, pw, pwb, cfg, act, k3_launch_plan(x, block_rows))


ecs_lif_fused_v2.launches = 0
