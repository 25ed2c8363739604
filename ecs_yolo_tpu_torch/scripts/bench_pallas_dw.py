"""The int8-input spread convolutions on the card, against the library:
the port of ``scripts/bench_pallas_dw.py``.

    python -m ecs_yolo_tpu_torch.scripts.bench_pallas_dw [site ...] [--device cpu] [--iters N]

Two kernels, each under its JAX name so that a reader finds the counterpart:

* :func:`pallas_dw3`: depthwise 3x3 SAME convolution plus bias over an int8
  plane, summed in f32 from the bias, written in ``out_dtype``.  It launches
  K4's kernel (``csrc/spread_dw3.cu``), which takes any int8 and sets its
  output dtype apart from the weights'.
* :func:`pallas_dense3`: dense 3x3 SAME convolution over an int8 plane as
  one implicit product ``patches[pos, 9C] @ bf16(k9c)[9C, C]``, f32
  accumulation, f32 bias, ``out_dtype`` out (``csrc/dense3.cu``).  The plan
  is Python (:func:`plan_dense3`): the persistent ``wgmma`` kernel with a
  resident weight slice where the slice fits (C <= 64, C = 128, 192, 256),
  else the flattened ``mma.sync`` kernel; :func:`dense3_tile_walk_reference`
  walks a plan in plain PyTorch for the CPU tests.

Each takes its plain version for a CPU tensor or inside
``route.plain_kernels()``; on a CUDA tensor it launches its kernel or raises.
``pallas_dw3.launches`` and ``pallas_dense3.launches`` count the launches
(``pallas_dense3.mma_launches`` those of the ``mma.sync`` route).
:func:`xla_dw3` and :func:`xla_dense3` are the library's convolutions the
JAX script compared against.

Sites: ``SITES`` (the unpacked C >= 128 ECS sites of res10@640 at batch 16,
and the two dense-composite sites of the C = 64 stage); ``spread_act1``,
``spread_act2``, ``spread_act1b8`` run :func:`bench_phase_spread` (K5
against the composite dense convolution).  Times are CUDA events over
``--iters`` calls after one warm-up, L2 not flushed; the bound is the H100's
(3.35 TB/s, 989 TFLOP/s bf16).  ``--device cpu`` runs the parity check only:
a CPU run measures no card.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import math
import sys
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..snn import spread as S
from ..snn.route import use_kernel

SITES = {
    "c128": (16, 80, 80, 128),
    "c256": (16, 40, 40, 256),
    "c512": (16, 20, 20, 512),
    # the dense composite spread of the C <= 64 stage, on its width-packed
    # layout: one dense 3x3 128 -> 128 convolution replaces dw + pw there
    "act1": (16, 320, 160, 128),
    "act2": (16, 160, 80, 128),
}
#: packed sites of bench_phase_spread, [N, H, W/2, 2C] as the JAX script names them
PHASE_SITES = {
    "spread_act1": (16, 320, 160, 128),
    "spread_act2": (16, 160, 80, 128),
    "spread_act1b8": (8, 320, 160, 128),
}
#: H100 SXM: HBM bytes/s, dense bf16 tensor-core and f32 CUDA-core FLOP/s
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
_CODES = S._DTYPES


def _out_code(out_dtype) -> int:
    if out_dtype not in _CODES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, not {out_dtype}")
    return _CODES[out_dtype]


def _int8_plane(name: str, s8: torch.Tensor) -> None:
    if s8.dtype != torch.int8:
        raise TypeError(f"{name}: s8 must be int8, not {s8.dtype}")


# --- K7: depthwise 3x3 -------------------------------------------------------------


def pallas_dw3_reference(s8, k33c, bias, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain version of :func:`pallas_dw3`: the depthwise convolution in
    float32 from the bias (weights widened to f32), cast once."""
    c = s8.shape[-1]
    y = F.conv2d(s8.float().permute(0, 3, 1, 2), k33c.float().permute(2, 0, 1)[:, None],
                 bias.float(), padding=1, groups=c)
    return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()


def pallas_dw3(s8, k33c, bias, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Depthwise 3x3 SAME convolution plus bias: ``s8`` ``[N, H, W, C]`` int8
    (any values), ``k33c`` ``[3, 3, C]``, ``bias`` ``[C]`` (float32 or
    bfloat16 each), result in ``out_dtype``.  The kernel is K4's
    (``csrc/spread_dw3.cu``) in its int8-in mode, on K4's plan
    (``snn.spread.plan_dw3``): it widens the weights to f32, sums the taps in
    row-major order from the bias and rounds once; C % 8 == 0."""
    _out_code(out_dtype)
    if not use_kernel(s8):
        return pallas_dw3_reference(s8, k33c, bias, out_dtype)
    _int8_plane("pallas_dw3", s8)
    n, h, w, c = s8.shape
    S._check("pallas_dw3", s8, 8, k33c=(k33c, (3, 3, c)), bias=(bias, (c,)))
    if k33c.dtype not in _CODES or bias.dtype not in _CODES:
        raise TypeError(f"pallas_dw3 takes float32 or bfloat16 weights, not "
                        f"{k33c.dtype}/{bias.dtype}")
    if k33c.dtype != bias.dtype:      # exact: the kernel widens both to f32
        k33c, bias = k33c.float(), bias.float()
    k33c, bias = S._aligned(k33c), S._aligned(bias)
    plan = S.plan_dw3(n, h, w, c, S._sms(s8.device), 1, k33c.element_size())
    out = torch.empty((n, h, w, c), dtype=out_dtype, device=s8.device)
    if plan.grid:
        S.dw3_launch(s8, k33c, bias, out, None, plan)
        pallas_dw3.launches += 1
    return out


pallas_dw3.launches = 0


# --- K8: dense 3x3 as an implicit product ----------------------------------------


def _check_bh(h: int, bh: int) -> None:
    if bh <= 0 or h % bh:
        raise ValueError(f"H % bh must be 0 (the TPU kernel's row blocks), got "
                         f"H={h}, bh={bh}")


def pallas_dense3_reference(s8, k9c, bias, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain version of :func:`pallas_dense3`: im2col patches in (dy, dx,
    ci) order times the bf16-rounded weights in float32, plus the float32
    bias, cast once."""
    acc = torch.matmul(S._patches(s8.float()), k9c.to(torch.bfloat16).float())
    return (acc + bias.float()).to(out_dtype)


class Dense3Plan(NamedTuple):
    """A launch of K8.  Route ``"wgmma"``: ``grid`` persistent blocks, each
    holding one Cout slice of ``bn`` channels of the weights (in chunks of
    ``cw`` input channels) and walking every ``grid``-th of ``tiles x
    slices`` (tile, slice) pairs; a tile is ``th x tw`` output pixels of one
    image, read through a window of ``(th+2) x (tw+2)`` pixels; ``smem``
    bytes of shared memory a block.  Route ``"mma"``: one block for each of
    ``tiles`` runs of 128 flattened pixels and each of ``slices`` 64-channel
    slices, ``smem`` bytes of static shared memory."""
    route: str
    th: int
    tw: int
    bn: int
    cw: int
    tiles: int
    slices: int
    grid: int
    smem: int


#: the "wgmma" route's tile (rows, columns): each warpgroup's 8 x 8 pixels
#: are 8 core-matrix rows of its A operand
DENSE3_TILE = (16, 8)
#: (cw, bn, chunks) of the "wgmma" kernel's instances (csrc/dense3.cu:
#: dispatch_wgmma): every plan of that route takes one of them
DENSE3_INSTANCES = frozenset({(16, 16, 1), (32, 32, 1), (48, 48, 1), (64, 64, 1),
                              (64, 64, 2), (64, 32, 3), (64, 16, 4)})
#: static shared memory of a block of the "mma" route: a [128][72] and a
#: [64][72] bf16 tile
DENSE3_MMA_SMEM = (128 + 64) * 72 * 2


def dense3_smem(c: int, bn: int, cw: int) -> int:
    """Shared memory of a block of the "wgmma" route: 1024 bytes of slack to
    align the weights to the swizzle's 1024-byte atom, the weight slice (9
    taps x C / cw chunks of ``bn`` rows of 128 bytes), the window in bf16
    chunk planes (C / 8 planes of 181 16-byte rows: the window's 180 pixels
    and one), the int8 window, the slice's bias in f32 and an mbarrier."""
    th, tw = DENSE3_TILE
    px = (th + 2) * (tw + 2)
    return 1024 + 9 * (c // cw) * bn * 128 + (c // 8) * (px | 1) * 16 + px * c + 4 * bn + 8


@functools.lru_cache(maxsize=64)
def plan_dense3(n: int, h: int, w: int, c: int, sms: int = 132) -> Dense3Plan:
    """K8's plan for an ``[n, h, w, c]`` plane on a card of ``sms`` SMs.

    The "wgmma" route takes every C <= 64 (one slice, ``bn = C``) and every
    C % 64 == 0 whose slice fits one block beside the windows: ``bn`` the
    widest of 64, 32, 16 that fits (C = 128, 192, 256).  Its tile is
    ``DENSE3_TILE``, 16 x 8 pixels; one block an SM; the grid is a multiple
    of the slice count, so each block keeps its slice.  Every other
    C % 16 == 0 (C > 64 and not a multiple of 64, or C >= 320) takes the
    "mma" route, the flattened ``mma.sync`` kernel.
    """
    if c <= 0 or c % 16:
        raise ValueError(f"plan_dense3: C must be a positive multiple of 16, got {c}")
    cw = min(c, 64)
    th, tw = DENSE3_TILE
    tiles = n * math.ceil(h / th) * math.ceil(w / tw)
    for bn in ((c,) if c <= 64 else (64, 32, 16)):
        smem = dense3_smem(c, bn, cw)
        if (c % cw == 0 and (cw, bn, c // cw) in DENSE3_INSTANCES
                and smem <= S.SMEM_PER_BLOCK):
            slices = c // bn
            grid = max(slices, min(tiles * slices, sms) // slices * slices)
            return Dense3Plan("wgmma", th, tw, bn, cw, tiles, slices, grid, smem)
    return plan_dense3_mma(n, h, w, c)


def plan_dense3_mma(n: int, h: int, w: int, c: int) -> Dense3Plan:
    """The "mma" route's plan: one block per 128 flattened pixels and 64
    output channels."""
    tiles, slices = math.ceil(n * h * w / 128), math.ceil(c / 64)
    return Dense3Plan("mma", 0, 0, 64, 64, tiles, slices, tiles * slices, DENSE3_MMA_SMEM)


def dense3_items(plan: Dense3Plan) -> np.ndarray:
    """``[block, tile, slice]`` of every item the plan's blocks take, in the
    order a block walks them: on the "wgmma" route block ``b`` takes items
    ``b, b + grid, ...`` with item = tile * slices + slice; on the "mma"
    route block ``tile * slices + slice`` takes that one item."""
    items = np.arange(plan.tiles * plan.slices)
    block = items % plan.grid if plan.route == "wgmma" else items
    order = np.lexsort((items, block))
    return np.stack([block, items // plan.slices, items % plan.slices], 1)[order]


def dense3_tile_walk_reference(s8, k9c, bias, out_dtype, plan: Dense3Plan) -> torch.Tensor:
    """K8's walk over its plan in plain PyTorch: each item multiplies the
    patches of its tile (a window of the "wgmma" route, zeros outside the
    image; a run of flattened pixels of the "mma" route) with its slice of
    the bf16-rounded weights in float32, adds the bias in float32, rounds
    once and writes the pixels that exist (the rest of ``out`` stays NaN).
    For the CPU tests of the plan."""
    n, h, w, c = s8.shape
    wk, b = k9c.to(torch.bfloat16).float(), bias.float()
    out = torch.full((n, h, w, c), float("nan"), dtype=out_dtype)
    if plan.route == "mma":
        pat, flat = S._patches(s8.float()).reshape(-1, 9 * c), out.view(-1, c)
        for _, t, sl in dense3_items(plan):
            rows, cols = slice(t * 128, (t + 1) * 128), slice(sl * 64, (sl + 1) * 64)
            flat[rows, cols] = (pat[rows] @ wk[:, cols] + b[cols]).to(out_dtype)
        return out
    th, tw = plan.th, plan.tw
    hp, wp = math.ceil(h / th) * th, math.ceil(w / tw) * tw
    sp = F.pad(s8.float(), (0, 0, 1, 1 + wp - w, 1, 1 + hp - h))
    for _, t, sl in dense3_items(plan):
        i, h0, w0 = S.gemm_tile_origin(plan, h, w, int(t))
        cols = slice(sl * plan.bn, (sl + 1) * plan.bn)
        win = sp[i, h0:h0 + th + 2, w0:w0 + tw + 2]
        y = torch.cat([win[dy:dy + th, dx:dx + tw] for dy in range(3)
                       for dx in range(3)], -1) @ wk[:, cols] + b[cols]
        y = y.to(out_dtype)[:h - h0, :w - w0]
        out[i, h0:h0 + y.shape[0], w0:w0 + y.shape[1], cols] = y
    return out


def _sms(device) -> int:
    return (torch.cuda.get_device_properties(device).multi_processor_count
            if torch.device(device).type == "cuda" else 132)


def dense3_launch(s8, k9c, bias, out, plan: Dense3Plan) -> None:
    """Launches K8 on the plan's route, writing ``out``; no checks (that is
    :func:`pallas_dense3`'s work): the kernel alone, for timing.  The
    "wgmma" route reads ``k9c`` and ``bias`` in place in float32 or bfloat16;
    the "mma" route takes the weights transposed to ``[C, 9C]`` bf16 and the
    bias in float32."""
    from .. import _build

    lib = _build.load("dense3")
    n, h, w, c = s8.shape
    vp, ci = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream(s8.device).cuda_stream
    if plan.route == "wgmma":
        fn = lib.dense3_wgmma_fwd
        fn.argtypes = [ci, ci, ci, vp, vp, vp, vp] + [ci] * 12 + [vp]
        args = (_CODES[out.dtype], _CODES[k9c.dtype], _CODES[bias.dtype], s8.data_ptr(),
                k9c.data_ptr(), bias.data_ptr(), out.data_ptr(), n, h, w, c,
                *(getattr(plan, f) for f in Dense3Plan._fields[1:]), stream)
    else:
        kt = k9c.to(torch.bfloat16).t().contiguous()      # [Cout, 9C]
        b32 = bias.float().contiguous()
        fn = lib.dense3_mma_fwd
        fn.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci, ci, vp]
        args = (_CODES[out.dtype], s8.data_ptr(), kt.data_ptr(), b32.data_ptr(),
                out.data_ptr(), n, h, w, c, stream)
    fn.restype = ci
    err = fn(*args)
    if err != 0:
        lib.dense3_error_string.argtypes = [ci]
        lib.dense3_error_string.restype = ctypes.c_char_p
        raise RuntimeError(f"dense3 kernel launch failed ({plan.route} route): "
                           + lib.dense3_error_string(err).decode())
    pallas_dense3.launches += 1
    if plan.route == "mma":
        pallas_dense3.mma_launches += 1


def pallas_dense3(s8, k9c, bias, out_dtype=torch.bfloat16, bh: int = 16) -> torch.Tensor:
    """Dense 3x3 SAME convolution: ``s8`` ``[N, H, W, C]`` int8 (any values),
    ``k9c`` ``[9C, C]`` with rows in (dy, dx, ci) order, ``bias`` ``[C]``.
    The weights are rounded to bf16 whatever ``out_dtype`` is, as the TPU
    kernel does; the product accumulates in f32.  ``H % bh`` must be 0, as
    the TPU kernel demands; ``bh`` changes nothing else.  The kernel
    (``csrc/dense3.cu``) takes C % 16 == 0, on the route
    :func:`plan_dense3` names; float32 and bfloat16 weights and bias are read
    in place."""
    code = _out_code(out_dtype)
    _check_bh(s8.shape[1], bh)
    if not use_kernel(s8):
        return pallas_dense3_reference(s8, k9c, bias, out_dtype)
    _int8_plane("pallas_dense3", s8)
    n, h, w, c = s8.shape
    S._check("pallas_dense3", s8, 16, k9c=(k9c, (9 * c, c)), bias=(bias, (c,)))
    if k9c.dtype not in _CODES:                   # the one rounding the kernel makes
        k9c = k9c.to(torch.bfloat16)
    if bias.dtype not in _CODES:
        bias = bias.float()
    k9c, bias = k9c.contiguous(), bias.contiguous()
    if k9c.data_ptr() % 16:                       # read in 16-byte pieces
        k9c = k9c.clone()
    plan = plan_dense3(n, h, w, c, _sms(s8.device))
    out = torch.empty((n, h, w, c), dtype=out_dtype, device=s8.device)
    dense3_launch(s8, k9c, bias, out, plan)
    return out


pallas_dense3.launches = 0
#: of them, launches of the "mma" route
pallas_dense3.mma_launches = 0


# --- the library's convolutions ------------------------------------------------------


def xla_dw3(s8, k, bias, dtype=torch.bfloat16) -> torch.Tensor:
    """The library's depthwise convolution in ``dtype`` (``k`` ``[3, 3, 1,
    C]``), then the bias in ``dtype``, as the JAX script's ``xla_dw3``."""
    c = s8.shape[-1]
    y = F.conv2d(s8.to(dtype).permute(0, 3, 1, 2), k.to(dtype).permute(3, 2, 0, 1),
                 padding=1, groups=c)
    return y.permute(0, 2, 3, 1) + bias.to(dtype)


def xla_dense3(s8, k, bias, dtype=torch.bfloat16) -> torch.Tensor:
    """The library's dense 3x3 convolution in ``dtype`` (``k`` ``[3, 3, C,
    C]``), then the bias in ``dtype``, as the JAX script's ``xla_dense3``."""
    y = F.conv2d(s8.to(dtype).permute(0, 3, 1, 2), k.to(dtype).permute(3, 2, 0, 1),
                 padding=1)
    return y.permute(0, 2, 3, 1) + bias.to(dtype)


def library_call(dense: bool, s8, k, bias, dtype) -> Callable[[], torch.Tensor]:
    """One PyTorch call computing the kernel's function, for timing: a
    channels_last ``F.conv2d`` with its bias on the plane already in
    ``dtype`` (``k`` ``[3, 3, C, C]`` dense, ``[3, 3, 1, C]`` depthwise)."""
    c = s8.shape[-1]
    x = s8.to(dtype).permute(0, 3, 1, 2)
    kw = k.to(dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    b = bias.to(dtype)
    groups = 1 if dense else c
    return lambda: F.conv2d(x, kw, b, padding=1, groups=groups)


def bound_ms(dense: bool, shape, out_dtype, weight_item: int = 2) -> tuple:
    """The least time the H100 takes for the function: ``(ms, "bytes" or
    "operations")``.  Bytes: the int8 plane read once, the output written
    once, the weights (``weight_item`` bytes each) and bias; operations: 18
    per output element on the f32 CUDA cores (depthwise) or 2 * 9 * C per
    output element on the bf16 tensor cores (dense)."""
    n, h, w, c = shape
    pos = n * h * w * c
    out_item = torch.tensor([], dtype=out_dtype).element_size()
    if dense:
        nbytes = pos * (1 + out_item) + 9 * c * c * 2 + 4 * c
        ms_f = 2 * 9 * c * pos / BF16_FLOPS * 1e3
    else:
        nbytes = pos * (1 + out_item) + 10 * c * weight_item
        ms_f = 18 * pos / F32_FLOPS * 1e3
    ms_b = nbytes / HBM_BPS * 1e3
    return (ms_b, "bytes") if ms_b >= ms_f else (ms_f, "operations")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up (CUDA
    events, L2 not flushed)."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _need_card(device) -> None:
    if torch.device(device).type != "cuda":
        raise RuntimeError("times are taken on the card only; a CPU run measures "
                           "no card (use parity_check there)")


# --- the script ------------------------------------------------------------------------


def parity_check(shape, device=None) -> Dict[str, float]:
    """Both kernels on the JAX script's parity inputs (int8 0/1 plane, f32
    weights, f32 out): on the CPU the wrappers' plain versions against the
    library's convolutions, on the card the kernels against their plain
    versions.  ``device`` None is the card (``device.resolve_device``).
    Returns the worst absolute differences; asserts < 1e-4."""
    from ..device import resolve_device

    device = resolve_device(device)
    rng = np.random.RandomState(0)
    n, h, w, c = shape
    s = torch.from_numpy((rng.rand(n, h, w, c) > 0.7).astype(np.int8)).to(device)
    k = torch.from_numpy(((rng.rand(3, 3, 1, c) - 0.5) * 0.2).astype(np.float32)).to(device)
    kd = torch.from_numpy(((rng.rand(3, 3, c, c) - 0.5) * 0.05).astype(np.float32)).to(device)
    b = torch.from_numpy(((rng.rand(c) - 0.5) * 0.1).astype(np.float32)).to(device)
    kd16 = kd.to(torch.bfloat16).float()
    with torch.no_grad():
        if torch.device(device).type == "cpu":
            dw_want = xla_dw3(s, k, b, torch.float32)
            dense_want = xla_dense3(s, kd16, b, torch.float32)
        else:
            dw_want = pallas_dw3_reference(s, k.reshape(3, 3, c), b, torch.float32)
            dense_want = pallas_dense3_reference(s, kd.reshape(9 * c, c), b, torch.float32)
        dw_got = pallas_dw3(s, k.reshape(3, 3, c), b, torch.float32)
        dense_got = pallas_dense3(s, kd.reshape(9 * c, c), b, torch.float32)
    errs = {"pallas_dw3": float((dw_got - dw_want).abs().max()),
            "pallas_dense3": float((dense_got - dense_want).abs().max())}
    for name, err in errs.items():
        print(f"parity {name} {tuple(shape)}: max abs err {err:.2e}", flush=True)
        assert err < 1e-4, (name, err)
    return errs


def site_inputs(shape, dense: bool, device):
    """The JAX script's bench inputs: an int8 0/1 plane at rate 0.3, bf16
    weights and bias (``k`` dense ``[3, 3, C, C]`` or depthwise ``[3, 3, 1, C]``)."""
    rng = np.random.RandomState(0)
    n, h, w, c = shape
    s8 = torch.from_numpy((rng.rand(n, h, w, c) > 0.7).astype(np.int8)).to(device)
    if dense:
        k = torch.from_numpy((rng.rand(3, 3, c, c) - 0.5) * 0.05)
    else:
        k = torch.from_numpy((rng.rand(3, 3, 1, c) - 0.5) * 0.2)
    b = torch.from_numpy((rng.rand(c) - 0.5) * 0.1)
    return s8, k.to(device, torch.bfloat16), b.to(device, torch.bfloat16)


def bench(shape, name, device="cuda", iters: int = 100) -> dict:
    """Kernel against the library's convolution at one site, bf16 out."""
    _need_card(device)
    c = shape[-1]
    dense = name.startswith("act")
    s8, k, b = site_inputs(shape, dense, device)
    if dense:
        kern = lambda: pallas_dense3(s8, k.reshape(9 * c, c), b)
    else:
        kern = lambda: pallas_dw3(s8, k.reshape(3, 3, c), b)
    lib = library_call(dense, s8, k, b, torch.bfloat16)
    with torch.no_grad():
        ms, lib_ms = cuda_ms(kern, iters), cuda_ms(lib, iters)
    bms, by = bound_ms(dense, shape, torch.bfloat16)
    print(f"{name} {tuple(shape)}: library {lib_ms:.4f} ms vs "
          f"{'pallas_dense3' if dense else 'pallas_dw3'} {ms:.4f} ms "
          f"({lib_ms / ms:.2f}x); H100 bound {bms:.4f} ms ({by})", flush=True)
    return {"site": name, "shape": list(shape), "ms": ms, "library_ms": lib_ms,
            "bound_ms": bms, "bound_by": by}


def bench_phase_spread(shape, name, device="cuda", iters: int = 100) -> dict:
    """K5 (``snn.spread.packed_spread``) against the composite dense
    convolution on the canonical layout of a packed site: ``[N, H, W/2, 2C]``
    packed is ``[N, H, W, C]`` canonical.  bf16, binary plane at rate 0.3."""
    _need_card(device)
    n, h, wp, c2 = shape
    c = c2 // 2
    rng = np.random.RandomState(0)
    s = torch.from_numpy((rng.rand(n, h, 2 * wp, c) > 0.7).astype(np.float32))
    s = s.to(device, torch.bfloat16)
    dw, dwb, pw, pwb = (torch.from_numpy(a).to(device, torch.bfloat16) for a in (
        (rng.rand(3, 3, 1, c) - 0.5) * 0.2, (rng.rand(c) - 0.5) * 0.1,
        (rng.rand(1, 1, c, c) - 0.5) * 0.05, (rng.rand(c) - 0.5) * 0.1))
    m, const = S.compose_m(dw, dwb, pw, pwb)
    kc = m.reshape(3, 3, c, c).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    s_n, cb = s.permute(0, 3, 1, 2), const.to(torch.bfloat16)
    with torch.no_grad():
        ms = cuda_ms(lambda: S.packed_spread(s, dw, dwb, pw, pwb), iters)
        comp_ms = cuda_ms(lambda: F.conv2d(s_n, kc, cb, padding=1), iters)
    print(f"{name} {tuple(shape)} (canonical {(n, h, 2 * wp, c)}): composite "
          f"{comp_ms:.4f} ms vs packed_spread {ms:.4f} ms ({comp_ms / ms:.2f}x)",
          flush=True)
    return {"site": name, "canonical_shape": [n, h, 2 * wp, c], "ms": ms,
            "composite_ms": comp_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sites", nargs="*", help=f"of {sorted(SITES) + sorted(PHASE_SITES)}")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--iters", type=int, default=100, help="timed calls a site")
    opt = ap.parse_args(argv)
    from ..device import resolve_device

    device = resolve_device(opt.device)
    names = opt.sites or list(SITES)
    for nm in names:
        if nm not in SITES and nm not in PHASE_SITES:
            ap.error(f"unknown site {nm!r}")
    # float32 comparisons in full float32 on both sides
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cpu":
        parity_check((2, 16, 16, 128), "cpu")
        print("times: not measured (no card)")
        return 0
    print(torch.cuda.get_device_name(device), flush=True)
    for nm in names:
        if nm in PHASE_SITES:
            bench_phase_spread(PHASE_SITES[nm], nm, device, opt.iters)
        else:
            bench(SITES[nm], nm, device, opt.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
