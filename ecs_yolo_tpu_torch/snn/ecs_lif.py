"""Fused ECS-LIF forward: the CUDA kernel ``csrc/ecs_lif.cu`` and its wrapper.

Counterpart of ``ecs_yolo_tpu/snn/pallas_ecs_v3.py:ecs_lif_pallas``: the
whole T-step ECS-LIF recurrence of one site, the depthwise-3x3 + pointwise
1x1 spread included, in one launch.  Eval of an ECS-LIF site on a CUDA tensor
takes this kernel by default (``nn/blocks.MemUpdate``); a site whose layout
it refuses (:func:`layout_refusal`), or any site under
``SNNConfig.fused_inference``, takes the general-shape kernel of
``snn/fused.py`` instead.

The kernel is one cooperative launch that runs every step, with one
grid-wide barrier between steps.  Its work items are (128-pixel tile x Cout
slice) pairs over the flattened ``N*H*W`` plane; :func:`plan_grid` decides
the slice, the grid and the shared memory, and each block owns a fixed list
of items for the whole launch (:func:`k1_block_items`).
:func:`k1_grid_walk_reference` walks a plan in plain PyTorch, step by step,
item by item and K-chunk by K-chunk, for the CPU tests.

The wrapper calls the op ``torch.ops.ecs_yolo_torch.ecs_lif``
(``snn/ops.py``), whose implementation (:func:`run_k1`) takes the plain loop
(``snn/neuron.ecs_lif_scan``) for a tensor on the CPU or inside
``route.plain_kernels()``, and only then.  For a CUDA tensor it launches the
kernel or raises.  Its ctypes entry is bound once,
the plan, the occupancy and the rounded constants are cached, and no
parameter is copied where its dtype matches x's: the kernel reads the
weights through their strides.  ``ecs_lif_fused.launches`` counts the
launches.
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
from . import ops
from .neuron import _const, ecs_lif_scan, make_spread
from .route import use_kernel
from .spread import _entry, _sms, _stream
from .surrogate import spike_fn

#: dtype codes of the kernels' C interfaces
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: pixels of a work item of K1 (two warpgroups of 64 rows)
K1_TILE = 128
#: H100 SXM: the most dynamic shared memory one block may take
SMEM_PER_BLOCK = 232448
#: the Cout slices (``wgmma`` widths) the kernel is built for
K1_SLICES = (128, 64, 32)
#: blocks of K1 an SM holds off the card (144-255 registers a thread of 256:
#: one); on the card the wrapper asks the occupancy query
K1_BLOCKS_PER_SM = 1


# --- K1's plan -----------------------------------------------------------------


class K1Plan(NamedTuple):
    """A launch of K1: items of ``tile`` pixels x ``slice`` output channels
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


def k1_window(w: int) -> int:
    """Pixel slots of a window: the tile's three row runs of 130 pixels, or
    one run of ``2W + 130`` where they overlap (``csrc/ecs_lif.cu``:
    ``load_window``)."""
    run = K1_TILE + 2
    return 2 * min(w, run) + run


def k1_smem(itemsize: int, c: int, w: int, n_slice: int) -> int:
    """Dynamic shared memory of a block (``csrc/ecs_lif.cu``'s layout): 1024
    bytes of slack to align B, the resident B of the slice (bf16: one
    ``[N][128 bytes]`` tile per 64-channel chunk), two window stages of 128
    bytes a slot, the float32 d and pw chunk tiles (f32 only), and the
    depthwise weights and both biases (``11 * Cpad`` elements)."""
    chunk = 128 // itemsize
    nk = math.ceil(c / chunk)
    cp = nk * chunk
    wins = 2 * k1_window(w) * 128
    if itemsize == 2:
        return 1024 + nk * n_slice * 128 + wins + 11 * cp * 2
    return 1024 + wins + chunk * K1_TILE * 4 + chunk * n_slice * 4 + 11 * cp * 4


@functools.lru_cache(maxsize=256)
def k1_slice(c: int, w: int, itemsize: int) -> Tuple[int, int]:
    """``(N, smem)``: the Cout slice of an item, the widest of 128, 64, 32
    (no wider than C rounded up to 32) whose block fits the shared memory,
    and that block's shared memory.  Raises where none fits (C of some
    thousands at a wide W)."""
    for n_slice in K1_SLICES:
        if n_slice > 32 * math.ceil(c / 32):
            continue
        smem = k1_smem(itemsize, c, w, n_slice)
        if smem <= SMEM_PER_BLOCK:
            return n_slice, smem
    raise ValueError(f"ecs_lif_fused: no Cout slice fits the shared memory at "
                     f"C={c}, W={w}")


@functools.lru_cache(maxsize=256)
def plan_grid(n: int, h: int, w: int, c: int, sms: int = 132,
              dtype: torch.dtype = torch.bfloat16,
              blocks_per_sm: Optional[int] = None) -> K1Plan:
    """K1's plan for ``[n, h, w, c]`` sites on a card of ``sms`` SMs.

    The slice is :func:`k1_slice`'s: all of Cout at C <= 128 (one item a
    tile), 128 channels a slice above, 64 where a 128-wide resident B does
    not fit (C = 1024).  The grid is every block the card holds at once
    (``blocks_per_sm`` from the occupancy query, else an estimate), rounded
    down to a multiple of the slices and no more than the items: a
    cooperative launch needs every block resident.
    """
    if c <= 0 or c % 8:
        raise ValueError(f"plan_grid: C must be a positive multiple of 8, got {c}")
    itemsize = torch.tensor([], dtype=dtype).element_size()
    n_slice, smem = k1_slice(c, w, itemsize)
    slices = math.ceil(c / n_slice)
    tiles = math.ceil(n * h * w / K1_TILE)
    per_sm = K1_BLOCKS_PER_SM if blocks_per_sm is None else blocks_per_sm
    resident = per_sm * sms // slices * slices
    if resident < slices:
        raise ValueError(f"plan_grid: {per_sm} blocks an SM on {sms} SMs hold "
                         f"fewer than the {slices} slices of C={c}")
    grid = max(slices, min(resident, tiles * slices))
    return K1Plan(K1_TILE, n_slice, slices, 128 // itemsize, tiles, tiles * slices,
                  grid, k1_window(w), smem)


def k1_block_items(plan: K1Plan, b: int) -> List[Tuple[int, int]]:
    """The ``(tile, slice)`` items block ``b`` owns, in its order: slice
    ``b % slices``, every ``grid / slices``-th tile from ``b // slices``."""
    per = plan.grid // plan.slices
    return [(j, b % plan.slices) for j in range(b // plan.slices, plan.tiles, per)]


# --- the plain versions ----------------------------------------------------------


def ecs_lif_reference(x, dw_kernel, dw_bias, pw_kernel, pw_bias, cfg: SNNConfig,
                      act: bool = False) -> torch.Tensor:
    """The plain version: the eager T-loop with the parameters cast to x's
    dtype, the same function the kernel computes."""
    dt = x.dtype
    spread = make_spread(dw_kernel.to(dt), dw_bias.to(dt), pw_kernel.to(dt),
                         pw_bias.to(dt))
    return ecs_lif_scan(x, spread, cfg, act)


@torch.no_grad()
def k1_grid_walk_reference(x, dw_kernel, dw_bias, pw_kernel, pw_bias,
                           cfg: SNNConfig, act: bool = False,
                           plan: Optional[K1Plan] = None) -> torch.Tensor:
    """K1's walk in plain PyTorch, for the CPU tests of the plan.

    Step 0 fires x_0.  At every later step each block of the plan takes its
    items in order; an item computes, K-chunk by K-chunk, the depthwise 3x3
    of the previous step's spikes over its pixels (taps summed in float32 in
    (dy, dx) order, rounded once, + dwb in the dtype) and accumulates the
    chunk's product with the slice of pw in float32; its epilogue rounds the
    sum, adds pwb and updates ecs, mem and the spike in the kernel's order,
    with mem and ecs kept in a ``[2, P, C]`` workspace.  Products and sums
    round apart here (the kernel fuses the taps), so on exact (dyadic) data
    the walk is bit-equal to :func:`ecs_lif_reference`.
    """
    dt = x.dtype
    t_steps, n, h, w, c = x.shape
    if plan is None:
        plan = plan_grid(n, h, w, c, 132, dt)
    p_all = n * h * w
    xf = x.reshape(t_steps, p_all, c)
    dw = dw_kernel.to(dt).reshape(9, c).float()
    dwb, pwb = dw_bias.to(dt), pw_bias.to(dt)
    pw = pw_kernel.to(dt).reshape(c, c).float()
    decay, alpha, beta = (_const(v, x) for v in (cfg.decay, cfg.alpha, cfg.beta))
    leak = _const(1.0 - 1.0 / cfg.ecs_tau, x)
    out = torch.full((t_steps, p_all, c), float("nan"), dtype=dt)
    out[0] = spike_fn(xf[0], cfg.thresh, cfg.lens, act)
    ws = torch.zeros((2, p_all, c), dtype=dt)
    pix = torch.arange(p_all)
    hh, ww = (pix // w) % h, pix % w
    for t in range(1, t_steps):
        prev = F.pad(out[t - 1].reshape(n, h, w, c).float(), (0, 0, 1, 1, 1, 1))
        for b in range(plan.grid):
            for tile, sl in k1_block_items(plan, b):
                px = pix[tile * plan.tile:(tile + 1) * plan.tile]
                cs = slice(sl * plan.slice, min(c, (sl + 1) * plan.slice))
                i_n, i_h, i_w = px // (h * w), hh[px], ww[px]
                acc = torch.zeros((len(px), cs.stop - cs.start))
                for k0 in range(0, c, plan.chunk):
                    ks = slice(k0, min(c, k0 + plan.chunk))
                    dsum = torch.zeros((len(px), ks.stop - ks.start))
                    for tap in range(9):
                        s = prev[i_n, i_h + tap // 3, i_w + tap % 3, ks]
                        dsum = dsum + s * dw[tap, ks]
                    d = (dsum.to(dt) + dwb[ks]).float()
                    acc = acc + d @ pw[ks, cs]
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


# --- checks --------------------------------------------------------------------


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


def _start_address(x: torch.Tensor) -> int:
    """Where x starts: its address, or for a tensor without storage (an
    exporter's fake tensor) its offset into a storage the allocator aligns."""
    try:
        return x.data_ptr()
    except RuntimeError:
        return x.storage_offset() * x.element_size()


def layout_refusal(x: torch.Tensor) -> Optional[str]:
    """Why this kernel does not take the layout of ``x`` ``[T, N, H, W, C]``,
    or None when it does.  It reads 16-byte groups of eight channels, so it
    wants the four inner dims dense, T dense or a broadcast (stride 0),
    ``C % 8 == 0`` and a 16-byte aligned start; and a block's shared memory
    must hold a slice of the weights with its window (:func:`k1_slice`:
    every C up to some thousands).  ``nn/blocks.MemUpdate`` sends a refused
    site to the general-shape kernel (``snn/fused.py``)."""
    t, n, h, w, c = x.shape
    if tuple(x.stride()[1:]) != (h * w * c, w * c, c, 1):
        return f"x's [N, H, W, C] dims must be contiguous, strides {x.stride()}"
    if t > 1 and x.stride(0) not in (0, n * h * w * c):
        return f"x's T stride must be 0 or N*H*W*C, got {x.stride(0)}"
    if c % 8:
        return f"the kernel takes C % 8 == 0, got C={c}"
    if x.device.type == "cuda" and _start_address(x) % 16:
        return "x must start on a 16-byte boundary"
    if x.dtype in DTYPE_CODES:
        try:
            k1_slice(c, w, x.element_size())
        except ValueError as e:
            return str(e)
    return None


def _check(x, dw_kernel, dw_bias, pw_kernel, pw_bias):
    check_params(x, dw_kernel, dw_bias, pw_kernel, pw_bias)
    reason = layout_refusal(x)
    if reason:
        raise ValueError(reason)


# --- the launch ------------------------------------------------------------------

_FWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p]


def _fail_on(err: int, what: str, lib: str = "ecs_lif") -> None:
    """Raises with the CUDA error's text when a call into ``csrc/<lib>.cu``
    (K1's, or K2's ``ecs_lif_rows``) returned one."""
    if err != 0:
        msg = _entry(lib, f"{lib}_error_string", [ctypes.c_int])
        msg.restype = ctypes.c_char_p
        raise RuntimeError(f"{lib} kernel {what} failed: {msg(err).decode()}")


@functools.lru_cache(maxsize=256)
def _occupancy(lib: str, device: torch.device, dtype: torch.dtype, n_slice: int, smem: int,
               off_card: int) -> int:
    """Blocks of the (dtype, slice) instance of ``csrc/<lib>.cu`` an SM of
    ``device`` holds at ``smem`` bytes, from the CUDA occupancy query
    (``off_card`` off the card)."""
    if device.type != "cuda":
        return off_card
    blocks = _entry(lib, f"{lib}_occupancy", [ctypes.c_int] * 3)(
        DTYPE_CODES[dtype], n_slice, smem)
    if blocks < 0:
        _fail_on(-blocks, "occupancy query", lib)
    if blocks == 0:
        raise RuntimeError(f"{lib} kernel: no block of {smem} bytes fits an SM")
    return blocks


def launch_plan(x: torch.Tensor) -> K1Plan:
    """The plan a launch on ``x`` ``[T, N, H, W, C]`` takes."""
    t, n, h, w, c = x.shape
    n_slice, smem = k1_slice(c, w, x.element_size())
    occ = _occupancy("ecs_lif", x.device, x.dtype, n_slice, smem, K1_BLOCKS_PER_SM)
    return plan_grid(n, h, w, c, _sms(x.device), x.dtype, occ)


@functools.lru_cache(maxsize=64)
def _consts(dtype: torch.dtype, thresh: float, decay: float, alpha: float,
            beta: float, tau: float):
    """The kernel's constants, rounded to the dtype once (the threshold is
    compared in float32): a ctypes float[5]."""
    like = torch.empty(0, dtype=dtype)
    return (ctypes.c_float * 5)(float(thresh), _const(decay, like), _const(alpha, like),
                                _const(beta, like), _const(1.0 - 1.0 / tau, like))


#: the barrier buffer of each (device, stream): [arrivals, generation], left
#: ready by every launch
_barriers: dict = {}


def _barrier(x: torch.Tensor, stream: int) -> torch.Tensor:
    key = (x.device, stream)
    bar = _barriers.get(key)
    if bar is None:
        bar = _barriers[key] = torch.zeros(2, dtype=torch.int32, device=x.device)
    return bar


def _pw_vec(pw: torch.Tensor) -> int:
    """How the kernel reads ``pw`` ``[1, 1, Cin, Cout]``: 1 in 16-byte runs
    of input channels (``[Cout][Cin]`` memory, the model's view of its conv
    weight), 2 in runs of output channels (a contiguous JAX-shaped kernel),
    0 one element at a time."""
    s_ci, s_co = pw.stride(2), pw.stride(3)
    if pw.data_ptr() % 16 == 0:
        if s_ci == 1 and s_co % 8 == 0:
            return 1
        if s_co == 1 and s_ci % 8 == 0:
            return 2
    return 0


def ecs_lif_fused(x, dw_kernel, dw_bias, pw_kernel, pw_bias, cfg: SNNConfig,
                  act: bool = False) -> torch.Tensor:
    """ECS-LIF spikes of ``x`` ``[T, N, H, W, C]`` (float32 or bfloat16).

    The spread parameters have the JAX shapes: ``dw_kernel`` ``[3, 3, 1, C]``,
    ``dw_bias`` ``[C]``, ``pw_kernel`` ``[1, 1, C, C]``, ``pw_bias`` ``[C]``;
    they are cast to x's dtype (no copy where they have it) and read through
    their strides.  x's T axis may be a broadcast (stride 0).

    The call goes through the op ``torch.ops.ecs_yolo_torch.ecs_lif``
    (``snn/ops.py``), whose implementation is :func:`run_k1`; a tensor on
    another device than CUDA or the CPU is refused here.
    """
    use_kernel(x)
    return ops.ecs_lif(x, dw_kernel, dw_bias, pw_kernel, pw_bias, *ops.cfg_args(cfg), act)


def run_k1(x, dw_kernel, dw_bias, pw_kernel, pw_bias, cfg: SNNConfig,
           act: bool = False) -> torch.Tensor:
    """The op's implementation: the plain version for a CPU tensor or inside
    ``plain_kernels()``, else K1's launch, counted in
    ``ecs_lif_fused.launches``."""
    if not use_kernel(x):
        return ecs_lif_reference(x, dw_kernel, dw_bias, pw_kernel, pw_bias,
                                 cfg, act)
    _check(x, dw_kernel, dw_bias, pw_kernel, pw_bias)
    dt = x.dtype
    dw, dwb, pw, pwb = (p if p.dtype == dt else p.to(dt)
                        for p in (dw_kernel, dw_bias, pw_kernel, pw_bias))
    t, n, h, w, c = x.shape
    out = torch.empty((t, n, h, w, c), dtype=dt, device=x.device)
    if out.numel() == 0:
        return out
    fn = _entry("ecs_lif", "ecs_lif_fwd", _FWD_ARGTYPES)     # built and bound first
    plan = launch_plan(x)
    stream = _stream(x)
    ws = torch.empty((2, n * h * w * c) if t > 2 else (0,), dtype=dt, device=x.device)
    args = array.array("q", (
        DTYPE_CODES[dt], plan.slice, x.data_ptr(), x.stride(0) if t > 1 else 0,
        out.data_ptr(), dw.data_ptr(), dw.stride(0), dw.stride(1), dw.stride(3),
        dwb.data_ptr(), dwb.stride(0), pw.data_ptr(), pw.stride(2), pw.stride(3),
        _pw_vec(pw), pwb.data_ptr(), pwb.stride(0), ws.data_ptr(),
        _barrier(x, stream).data_ptr(), t, n, h, w, c, plan.slices, plan.tiles,
        plan.grid, plan.smem, int(act), stream))
    consts = _consts(dt, cfg.thresh, cfg.decay, cfg.alpha, cfg.beta, cfg.ecs_tau)
    _fail_on(fn(args.buffer_info()[0], consts), "launch")
    ecs_lif_fused.launches += 1
    return out


ecs_lif_fused.launches = 0
