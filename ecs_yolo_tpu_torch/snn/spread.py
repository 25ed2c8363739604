"""The ECS spread of the training path: two CUDA kernels, their wrappers,
plain versions and gradients (counterpart of ``ecs_yolo_tpu/snn/pallas_dw.py``).

* ``binary_dw3_conv`` replaces ``pallas_dw.binary_dw3_conv``: depthwise 3x3
  SAME convolution plus bias over a binary ``[N, H, W, C]`` spike plane, read
  as int8, summed in float32 from the bias, rounded once.  Kernel
  ``csrc/spread_dw3.cu``.
* ``packed_spread`` replaces ``pallas_dw.packed_spread_pallas``: the whole
  spread ``pw1x1(dw3x3(s) + dwb) + pwb`` as one implicit product
  ``patches[pos, 9C] @ M[9C, C] + const`` over int8 spikes, with ``M`` and
  ``const`` composed outside the kernel (``compose_m``).  Kernel
  ``csrc/spread_gemm.cu``.  The TPU kernel works on a width-packed
  ``[N, H, W/2, 2C]`` layout with two width phases; here the layout is the
  canonical one and the phases collapse into one product.

Each wrapper is a ``torch.autograd.Function``: the forward launches the
kernel on a CUDA tensor (or raises) and takes the plain version on a CPU
tensor or inside ``route.plain_kernels()``; it saves the spikes as int8 with
the weights.  The backward is the gradient of the plain convolution from the
saved int8 input, through the library's convolution gradients, as the JAX
``custom_vjp``s compute theirs outside any kernel.  ``*.launches`` count the
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

from .route import use_kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: widest site the fused dw+pw product takes (the C=64 stage of the EMS nets)
GEMM_MAX_C = 64


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: float32, or the dtype itself when wider."""
    return torch.promote_types(dtype, torch.float32)


def _nchw(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def _dw_oihw(k: torch.Tensor) -> torch.Tensor:
    """Depthwise kernel [3, 3, 1, C] (HWIO) -> [C, 1, 3, 3]."""
    return k.permute(3, 2, 0, 1)


def _check(name: str, s8: torch.Tensor, c_mult: int, **params) -> None:
    """What the kernels take: a dense int8 ``[N, H, W, C]`` plane, parameters
    of the stated shapes on the same device."""
    if s8.dim() != 4:
        raise ValueError(f"{name}: spikes must be [N, H, W, C], got {tuple(s8.shape)}")
    n, h, w, c = s8.shape
    if not s8.is_contiguous():
        raise ValueError(f"{name}: spikes must be contiguous, strides {s8.stride()}")
    if c % c_mult:
        raise ValueError(f"{name}: the kernel takes C % {c_mult} == 0, got C={c}")
    if n * h * w >= 2 ** 31:
        raise ValueError(f"{name}: N*H*W must be below 2^31")
    if s8.data_ptr() % 16:
        raise ValueError(f"{name}: spikes must start on a 16-byte boundary")
    for pname, (p, shape) in params.items():
        if tuple(p.shape) != shape:
            raise ValueError(f"{name}: {pname} must be {shape}, got {tuple(p.shape)}")
        if p.device != s8.device:
            raise ValueError(f"{name}: {pname} is on {p.device}, spikes on {s8.device}")


def _launch(lib_name: str, fn_name: str, argtypes, args) -> None:
    from .. import _build

    lib = _build.load(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        lib.spread_error_string.argtypes = [ctypes.c_int]
        lib.spread_error_string.restype = ctypes.c_char_p
        raise RuntimeError(f"{fn_name} launch failed: "
                           + lib.spread_error_string(err).decode())


# --- K4: binary depthwise 3x3 ----------------------------------------------


def binary_dw3_conv_reference(s: torch.Tensor, k: torch.Tensor,
                              b: torch.Tensor) -> torch.Tensor:
    """The plain version: depthwise ``F.conv2d`` with bias in at least
    float32, rounded once to ``s``'s dtype.  ``s`` may be int8 or floating;
    with an int8 ``s`` the result has ``k``'s dtype."""
    out = k.dtype if s.dtype == torch.int8 else s.dtype
    acc = _acc_dtype(out)
    c = s.shape[-1]
    y = F.conv2d(_nchw(s.to(acc)), _dw_oihw(k.to(acc)), b.to(acc), 1, 1, 1, c)
    return _nhwc(y).to(out).contiguous()


def _dw3_forward(s8: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 spikes -> ``k.dtype`` output: the kernel on the card."""
    if not use_kernel(s8):
        return binary_dw3_conv_reference(s8, k, b)
    n, h, w, c = s8.shape
    _check("binary_dw3_conv", s8, 8, k=(k, (3, 3, 1, c)), b=(b, (c,)))
    if k.dtype not in _DTYPES or b.dtype != k.dtype:
        raise TypeError(f"binary_dw3_conv takes float32 or bfloat16 parameters "
                        f"of one dtype, not {k.dtype}/{b.dtype}")
    k, b = k.contiguous(), b.contiguous()
    out = torch.empty((n, h, w, c), dtype=k.dtype, device=s8.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    _launch("spread_dw3", "spread_dw3_fwd", [ci, vp, vp, vp, vp, ci, ci, ci, ci, vp],
            (_DTYPES[k.dtype], s8.data_ptr(), k.data_ptr(), b.data_ptr(),
             out.data_ptr(), n, h, w, c,
             torch.cuda.current_stream(s8.device).cuda_stream))
    binary_dw3_conv.launches += 1
    return out


class _BinaryDw3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, k, b):
        s8 = s.to(torch.int8)                       # exact: s in {0, 1}
        ctx.save_for_backward(s8, k)
        return _dw3_forward(s8, k, b)

    @staticmethod
    def backward(ctx, dy):
        s8, k = ctx.saved_tensors
        c = s8.shape[-1]
        dy_n = _nchw(dy)
        ds = dk = db = None
        if ctx.needs_input_grad[0]:
            ds = _nhwc(conv2d_input(_nchw(s8).shape, _dw_oihw(k), dy_n,
                                    padding=1, groups=c))
        if ctx.needs_input_grad[1]:
            dk = conv2d_weight(_nchw(s8.to(dy.dtype)), (c, 1, 3, 3), dy_n,
                               padding=1, groups=c).permute(2, 3, 1, 0)
        if ctx.needs_input_grad[2]:
            db = dy.to(_acc_dtype(dy.dtype)).sum((0, 1, 2)).to(dy.dtype)
        return ds, dk, db


def binary_dw3_conv(s: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 SAME convolution plus bias over a BINARY ``[N, H, W, C]``
    plane ``s`` (values 0 or 1, float32 or bfloat16).

    ``k`` is the canonical ``[3, 3, 1, C]`` depthwise kernel, ``b`` the ``[C]``
    bias; both are cast to ``s``'s dtype.  The kernel reads the plane as int8
    (the cast is made here and kept for the backward) and writes ``s``'s
    dtype.
    """
    return _BinaryDw3.apply(s, k.to(s.dtype), b.to(s.dtype))


binary_dw3_conv.launches = 0


# --- K5: fused dw+pw spread product -----------------------------------------


def compose_m(dw: torch.Tensor, dwb: torch.Tensor, pw: torch.Tensor,
              pwb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``M [9C, C]`` with ``M[(dy, dx, ci), co] = dw[dy, dx, ci] * pw[ci, co]``
    in the parameters' dtype, and ``const [C] = dwb @ pw + pwb`` computed in
    that dtype and widened to the accumulation dtype (as
    ``pallas_dw._compose_m`` and its caller)."""
    c = dw.shape[-1]
    d9 = dw[:, :, 0, :].reshape(9, c)
    p = pw[0, 0]
    m = (d9[:, :, None] * p[None]).reshape(9 * c, c)
    const = torch.matmul(dwb, p) + pwb
    return m, const.to(_acc_dtype(const.dtype))


def _patches(s: torch.Tensor) -> torch.Tensor:
    """im2col of a SAME 3x3 window: [N, H, W, C] -> [N, H, W, 9C], taps in
    (dy, dx) order, zeros outside the image."""
    n, h, w, c = s.shape
    sp = F.pad(s, (0, 0, 1, 1, 1, 1))
    return torch.cat([sp[:, dy:dy + h, dx:dx + w] for dy in range(3)
                      for dx in range(3)], dim=-1)


def _gemm_reference(s: torch.Tensor, m: torch.Tensor, const: torch.Tensor) -> torch.Tensor:
    acc = const.dtype
    return (torch.matmul(_patches(s.to(acc)), m.to(acc)) + const).to(m.dtype)


def packed_spread_reference(s, dw, dwb, pw, pwb) -> torch.Tensor:
    """The plain version: ``patches @ M + const`` with ``M`` rounded to the
    dtype, the product and ``const`` in at least float32, rounded once."""
    dt = s.dtype
    m, const = compose_m(dw.to(dt), dwb.to(dt), pw.to(dt), pwb.to(dt))
    return _gemm_reference(s, m, const)


def _gemm_forward(s8: torch.Tensor, m: torch.Tensor, const: torch.Tensor) -> torch.Tensor:
    """int8 spikes, ``M [9C, C]``, float32 ``const`` -> ``m.dtype`` output."""
    if not use_kernel(s8):
        return _gemm_reference(s8, m, const)
    n, h, w, c = s8.shape
    _check("packed_spread", s8, 16, m=(m, (9 * c, c)), const=(const, (c,)))
    if c > GEMM_MAX_C:
        raise ValueError(f"packed_spread: the kernel takes C <= {GEMM_MAX_C}, got {c}")
    if m.dtype not in _DTYPES or const.dtype != torch.float32:
        raise TypeError(f"packed_spread takes float32 or bfloat16 M and float32 "
                        f"const, not {m.dtype}/{const.dtype}")
    if m.dtype == torch.bfloat16:
        # tensor-core B operand: per tap [Cout, Cin]
        m = m.reshape(9, c, c).transpose(1, 2)
    m, const = m.contiguous(), const.contiguous()
    out = torch.empty((n, h, w, c), dtype=m.dtype, device=s8.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    _launch("spread_gemm", "spread_gemm_fwd", [ci, vp, vp, vp, vp, ci, ci, ci, ci, vp],
            (_DTYPES[m.dtype], s8.data_ptr(), m.data_ptr(), const.data_ptr(),
             out.data_ptr(), n, h, w, c,
             torch.cuda.current_stream(s8.device).cuda_stream))
    packed_spread.launches += 1
    return out


class _PackedSpread(torch.autograd.Function):
    """``patches(s) @ m + const`` over binary ``s``; the gradient reaches the
    four canonical parameters through ``compose_m``, which autograd traces
    outside (tiny operations, made once per site and forward)."""

    @staticmethod
    def forward(ctx, s, m, const):
        s8 = s.to(torch.int8)                       # exact: s in {0, 1}
        ctx.save_for_backward(s8, m)
        ctx.const_dtype = const.dtype
        return _gemm_forward(s8, m, const)

    @staticmethod
    def backward(ctx, dy):
        s8, m = ctx.saved_tensors
        c = s8.shape[-1]
        dy_n = _nchw(dy)
        # the composite dense 3x3 kernel [Cout, Cin, 3, 3] of M
        kc = m.reshape(3, 3, c, c).permute(3, 2, 0, 1)
        ds = dm = dconst = None
        if ctx.needs_input_grad[0]:
            ds = _nhwc(conv2d_input(_nchw(s8).shape, kc, dy_n, padding=1))
        if ctx.needs_input_grad[1]:
            dkc = conv2d_weight(_nchw(s8.to(dy.dtype)), kc.shape, dy_n, padding=1)
            dm = dkc.permute(2, 3, 1, 0).reshape(9 * c, c)
        if ctx.needs_input_grad[2]:
            dconst = dy.to(ctx.const_dtype).sum((0, 1, 2))
        return ds, dm, dconst


def packed_spread(s, dw, dwb, pw, pwb) -> torch.Tensor:
    """The whole ECS spread ``pw1x1(dw3x3(s) + dwb) + pwb`` over a BINARY
    ``[N, H, W, C]`` plane ``s`` (float32 or bfloat16), as one product.

    ``dw [3, 3, 1, C]``, ``dwb [C]``, ``pw [1, 1, C, C]``, ``pwb [C]`` are the
    canonical parameters, cast to ``s``'s dtype.  ``M`` is rounded to that
    dtype once, so in bfloat16 the result differs in rounding from the
    depthwise-then-pointwise order.
    """
    dt = s.dtype
    return _PackedSpread.apply(
        s, *compose_m(dw.to(dt), dwb.to(dt), pw.to(dt), pwb.to(dt)))


packed_spread.launches = 0


# --- the spread closure of the training path ---------------------------------


def spread_route(c: int, w: int) -> str:
    """Which kernel a site of ``c`` channels and width ``w`` takes: the fused
    product for the narrow stage (C <= 64, even W: the sites the JAX package
    width-packs), else the depthwise kernel followed by a library 1x1
    product, which the JAX package also computes outside its kernel."""
    return "gemm" if c <= GEMM_MAX_C and c % 16 == 0 and w % 2 == 0 else "dw3"


def make_kernel_spread(dw, dwb, pw, pwb) -> Callable[[torch.Tensor], torch.Tensor]:
    """``spread`` for ``neuron.ecs_lif_scan`` over binary spikes, built from
    the two kernels.  The parameters have the JAX shapes and the compute
    dtype."""
    c = dw.shape[-1]
    pw2 = pw.reshape(c, c)
    composed = []       # M and const, composed at the first step, shared by all

    def spread(s: torch.Tensor) -> torch.Tensor:
        if spread_route(c, s.shape[2]) == "gemm":
            if not composed:
                composed.extend(compose_m(dw, dwb, pw, pwb))
            return _PackedSpread.apply(s, *composed)
        return torch.matmul(binary_dw3_conv(s, dw, dwb), pw2) + pwb

    return spread
