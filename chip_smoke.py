"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's seven CUDA kernel sources from the checkout
(``ecs_yolo_tpu_torch/csrc/``: the fused ECS-LIF forward, the binary depthwise
3x3, the fused dw+pw spread product, the fused plain-LIF forward, the
general-shape fused ECS-LIF forward, the ECS-LIF forward with its state in
shared memory, the dense 3x3 product), which serve eight functions (the
depthwise kernel also serves the bench's ``pallas_dw3``), takes the
EMS-ResNet10@640 neuron-site shapes from the model itself, holds every kernel
against its plain PyTorch version at those shapes (and the two spread
kernels' gradients against autograd through the plain version; the fused
spread product and the dense 3x3 product timed alone and as their callers
call them; the ``-Xptxas -v`` report of every source, with no spill allowed
in the two ``wgmma`` sources, ``spread_gemm`` and ``dense3``, nor in the
depthwise ``spread_dw3``), and drives
the port's paths at full width with random weights from a seed:

* serving: ``ecs_yolo_tpu_torch.detect.run`` on synthetic images (bf16), with
  every neuron site checked against the plain version on its real input, and
  a timed batched forward;
* training: one float32 step on the kernel route against the same step under
  ``plain_kernels()``, then a few bf16 steps of
  ``ecs_yolo_tpu_torch.train.trainer.make_train_step`` with SGD;
* validation: ``ecs_yolo_tpu_torch.val.run`` over a synthetic val split of 32
  images written from ``--seed`` (bf16, batch 8), three times: the ECS-LIF
  model on its default route, the same model with ``fused_inference=True``,
  and the plain-LIF model (``ecs=False``); the first and the last again under
  ``plain_kernels()``, which must give the same detections and metrics; and
  the metric half alone on a perfect detector;
* the shared-memory ECS-LIF kernel's own entry point,
  ``snn.fused.ecs_lif_fused_v2``, at the 24 site shapes of one res10@640
  forward (bf16, N=8), after its checks at every site shape against the
  general-shape kernel's plain version, beside the other two ECS-LIF
  kernels, and its tilings held equal bit for bit;
* the kernel benches: ``ecs_yolo_tpu_torch.scripts.bench_pallas_dw`` at its
  b16 sites (``pallas_dw3``, ``pallas_dense3``, each first checked against
  its plain version in both output dtypes; ``pallas_dense3`` also at six
  more shapes on both of its routes, full-range int8 planes with dyadic
  weights held bit for bit; the depthwise kernel at four more shapes in
  both of its modes, bit for bit, its int8 plane equal to the cast's) and
  one call each of its
  ``bench_phase_spread`` and of ``scripts.bench_pallas_v3.compare``.

The depthwise kernel (``binary_dw3_conv``, ``pallas_dw3``) is timed alone
as the device time of calls replayed in a CUDA graph, beside the same calls
eager (the host's issue rate in them) and the library call both ways; in
the ``kernels`` line its ``library_ms`` is the library call replayed, as
its ``ms`` is (``library_eager_ms`` beside it).  The graph and profiler
timing helpers are ``ecs_yolo_tpu_torch.scripts.bench_spread``'s.

The launch counters are set to 0 just before each main path and read just
after.  Each phase prints one JSON line (``--out PATH`` also writes them all
to one JSON file).  The last lines are the card's ``nvidia-smi`` name and
power limit, the ``{"kernels": ...}`` summary and ``{"ok": true, "device":
...}``.  Any failure exits non-zero.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

T, N, IMGSZ, NC = 4, 8, 640, 13
TRAIN_BOXES, TRAIN_STEPS = 8, 5
# share of spikes allowed to differ from the plain version (a kernel's
# product sums in another order than the library's; a membrane within an ulp
# of the threshold may flip)
SPIKE_BOUND = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SILU_ATOL = 2e-4           # act=True (SiLU) sites, float32
# spread kernels against their plain versions: float32 to 1e-5 * (1 + |want|);
# bfloat16 at most 1 ulp of the output on at most 1e-2 of the elements (the
# sum is taken in another order before the one rounding).  Where a sum
# cancels to near zero its bfloat16 ulp is smaller than the float32 sums'
# own difference, so there the float32 bound holds instead.
SPREAD_RTOL_F32 = 1e-5
SPREAD_ULP_SHARE_BF16 = 1e-2
GRAD_RTOL = 1e-4           # spread gradients against autograd, float32
# the plain-LIF kernel repeats the plain loop's roundings one by one, so its
# spikes must be equal; its SiLU goes through expf: float32 atol, bf16 ulps
LIF_SILU_ATOL_F32, LIF_SILU_ULPS_BF16 = 2e-4, 2.0
# the general-shape ECS-LIF kernel against the tensor-core one (another
# rounding of the spread): recorded, with the JAX test's 2 % as the ceiling
ROWS_VS_TENSOR_CORE_CEILING = 0.02
VAL_IMAGES = 32
VAL_SIZES = [(480, 640), (375, 500), (640, 640), (720, 1280)]
# H100 SXM: HBM 3.35 TB/s; dense fp32 (CUDA cores) 67 TFLOP/s, bf16 989
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
SMS = 132                  # streaming multiprocessors of the H100 SXM (read in main)
BENCH_ITERS, V3_ITERS = 20, 4   # timed calls a site of the two kernel benches
#: sources whose -Xptxas -v report must show no spill (the wgmma kernels and
#: the depthwise kernel, whose weights live in registers)
NO_SPILL = ("spread_gemm", "dense3", "spread_dw3")
#: per-shape keys summed beside ms in the kernels line, where a row has them
EXTRA_SUMS = ("wrapper_ms", "library_graph_ms")


def emit(record: dict, log: dict) -> None:
    log.setdefault(record["phase"], []).append(record)
    print(json.dumps(record), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def dname(dtype) -> str:
    return str(dtype).replace("torch.", "")


def itemsize(dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def bound(nbytes: float, flops: float, dtype) -> tuple:
    ms_b, ms_f = nbytes / HBM_BPS * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(ms_b, ms_f), "bytes" if ms_b >= ms_f else "operations"


class Agg:
    """Sums of a kernel's per-shape readings weighted by launches per pass
    of the main path (the served / trained dtype only)."""

    def __init__(self):
        self.ms = self.plain_ms = self.bound_ms = self.library_ms = 0.0
        self.extra = {}             # the EXTRA_SUMS keys the rows carry
        self.max_abs_err = 0.0
        self.by = {"bytes": 0.0, "operations": 0.0}

    def add(self, rec: dict, weight: int) -> None:
        self.ms += weight * rec["ms"]
        self.plain_ms += weight * rec["plain_ms"]
        self.bound_ms += weight * rec["bound_ms"]
        self.by[rec["bound_by"]] += weight * rec["bound_ms"]
        if rec.get("library_ms") is not None:
            self.library_ms += weight * rec["library_ms"]
        for key in EXTRA_SUMS:
            if key in rec:
                self.extra[key] = self.extra.get(key, 0.0) + weight * rec[key]

    def entry(self, graph_library: bool = False, **kw) -> dict:
        """The kernels line's entry; ``graph_library``: ``ms`` is a
        graph-replayed time, so ``library_ms`` is the library call replayed
        too and the eager one goes beside it as ``library_eager_ms``."""
        extra, library = dict(self.extra), {"library_ms": self.library_ms or None}
        if graph_library:
            library = {"library_ms": extra.pop("library_graph_ms"),
                       "library_eager_ms": self.library_ms}
        return {**kw, "max_abs_err": self.max_abs_err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
                "bound_by": max(self.by, key=self.by.get), **library, **extra}


def site_shapes(model, memupdate_cls, x1, broadcast: set = None) -> Counter:
    """[H, W, C] of every neuron site, counted, from one hooked forward;
    the shapes whose input is a broadcast over T are added to ``broadcast``."""
    sites = [m for m in model.modules() if isinstance(m, memupdate_cls)]
    seen = []

    def hook(m, i, o):
        seen.append(tuple(i[0].shape[2:]))
        if broadcast is not None and i[0].stride(0) == 0:
            broadcast.add(tuple(i[0].shape[2:]))

    hooks = [m.register_forward_hook(hook) for m in sites]
    with torch.no_grad():
        model(x1)
    for h in hooks:
        h.remove()
    counts = Counter(seen)
    if sum(counts.values()) != len(sites):
        raise AssertionError(f"{sum(counts.values())} site inputs seen for "
                             f"{len(sites)} neuron sites")
    return counts


def rand_fn(seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return lambda *s: torch.rand(*s, generator=g, device="cuda")


def site_inputs(shape, dtype, seed):
    """x = rand*2-0.5 and spread weights scaled as the JAX package's fused
    kernel tests (tests/test_pallas_kernels.py:TestEcsV3)."""
    c = shape[-1]
    r = rand_fn(seed)
    args = (r(*shape) * 2 - 0.5, (r(3, 3, 1, c) - 0.5) * 0.4,
            (r(c) - 0.5) * 0.2, (r(1, 1, c, c) - 0.5) * 0.2, (r(c) - 0.5) * 0.2)
    return [a.to(dtype) for a in args]


def spread_inputs(shape, dtype, seed):
    """A binary plane at firing rate 0.3 and the four spread parameters."""
    c = shape[-1]
    r = rand_fn(seed)
    args = ((r(*shape) < 0.3).float(), (r(3, 3, 1, c) - 0.5) * 0.4,
            (r(c) - 0.5) * 0.2, (r(1, 1, c, c) - 0.5) * 0.2, (r(c) - 0.5) * 0.2)
    return [a.to(dtype) for a in args]


def phase_k1(K, cfg_cls, sites: Counter, broadcast: set, log) -> Agg:
    """K1 against its plain version at every res10 site shape, N=8, T=4, x
    dense, and x a broadcast over T where the model hands the site one."""
    agg = Agg()
    cfg = cfg_cls(time_window=T)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        for i, ((h, w, c), count) in enumerate(sorted(sites.items(), reverse=True)):
            shape = (T, N, h, w, c)
            dense, *params = site_inputs(shape, dtype, seed=i)
            for bcast in (False, True) if (h, w, c) in broadcast else (False,):
                args = [dense[:1].expand(*shape) if bcast else dense, *params]
                got = K.ecs_lif_fused(*args, cfg)
                want = K.ecs_lif_reference(*args, cfg)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                share = float((diff > 0).float().mean())
                reps = max(3, min(10, int(1e9 // (math.prod(shape) * c))))
                ms = cuda_ms(lambda: K.ecs_lif_fused(*args, cfg), reps)
                plain_ms = cuda_ms(lambda: K.ecs_lif_reference(*args, cfg), reps)
                item = itemsize(dtype)
                # x read once (one plane when it is a broadcast), spikes
                # written once, weights; the spread's FLOPs (1x1 product + 3x3
                # taps) over T-1 steps
                planes = (1 if bcast else T) + T
                bms, by = bound((planes * N * h * w * c + 11 * c + c * c) * item,
                                (T - 1) * N * h * w * (2 * c * c + 18 * c), dtype)
                rec = {"phase": "kernel_check", "kernel": "ecs_lif_fused",
                       "dtype": dname(dtype), "act": False, "shape": list(shape),
                       "sites": count, "x_broadcast_over_t": bcast,
                       "rows_per_tile": K.plan_rows(N, h, T, sms),
                       "mismatch_share": share, "bound_share": SPIKE_BOUND[dtype],
                       "max_abs_err": float(diff.max()),
                       "firing_rate": float(want.float().mean()),
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                       "bound_by": by, "library_ms": None}
                emit(rec, log)
                if share > SPIKE_BOUND[dtype]:
                    raise AssertionError(f"ecs_lif_fused disagrees at {rec}")
                # one served forward: the site behind the stem reads a broadcast
                if dtype == torch.bfloat16 and bcast == ((h, w, c) in broadcast):
                    agg.add(rec, count)
                agg.max_abs_err = max(agg.max_abs_err, float(diff.max()))
                del args, got, want, diff
            del dense, params
    # act=True (SiLU) at one small shape, float32
    shape = (T, 2, 40, 40, 64)
    args = site_inputs(shape, torch.float32, seed=99)
    err = float((K.ecs_lif_fused(*args, cfg, True)
                 - K.ecs_lif_reference(*args, cfg, True)).abs().max())
    emit({"phase": "kernel_check", "kernel": "ecs_lif_fused", "dtype":
          "float32", "act": True, "shape": list(shape), "max_abs_err": err,
          "atol": SILU_ATOL}, log)
    if err > SILU_ATOL:
        raise AssertionError(f"ecs_lif_fused(act=True) max abs err {err}")
    return agg


def check_spread(name, got, want, dtype) -> dict:
    """The stated bound of a spread kernel against its plain version."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    out = {"max_abs_err": float(diff.max()),
           "differing_share": float((diff > 0).float().mean())}
    if dtype == torch.float32:
        out["worst_vs_bound"] = float((diff / (SPREAD_RTOL_F32 * (1 + w.abs()))).max())
        ok = out["worst_vs_bound"] <= 1.0
    else:
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=1e-30))) - 7)
        ulp = torch.maximum(ulp, SPREAD_RTOL_F32 * (1 + w.abs()))
        out["max_ulps"] = float((diff / ulp).max())
        ok = (out["max_ulps"] <= 1.0
              and out["differing_share"] <= SPREAD_ULP_SHARE_BF16)
    if not ok or not torch.isfinite(g).all():
        raise AssertionError(f"{name} disagrees with its plain version: {out}")
    return out


def phase_spread(S, BS, plain_kernels, sites: Counter, log) -> dict:
    """K4 at the C >= 128 site shapes, K5 at the C <= 64 ones, N=8, against
    the plain versions; one library call timed beside each.  K5's ``ms`` is
    the kernel alone (``_gemm_forward`` on the int8 plane, ``M`` composed
    once), as the library call is timed; ``wrapper_ms`` is the
    ``autograd.Function`` as the train path calls it (the int8 cast and the
    kernel; the path composes ``M`` once a forward).  K4's ``ms`` is the
    device time of ``binary_dw3_conv`` (one launch a call) from calls
    replayed in a CUDA graph; ``wrapper_ms`` the same calls eager, back to
    back (the host's issue rate in it); ``library_ms`` / ``library_graph_ms``
    the library call eager and replayed; the bound of the float-in
    function, with the int8-in function's and the old cast-plus-kernel
    pair's beside it; at 80x80x128 bf16 the profiler's kernel time as a
    cross-check.  ``BS`` is ``scripts.bench_spread`` (the timing helpers)."""
    import torch.nn.functional as F

    aggs = {"binary_dw3_conv": Agg(), "packed_spread": Agg()}
    for dtype in (torch.float32, torch.bfloat16):
        item = itemsize(dtype)
        for i, ((h, w, c), count) in enumerate(sorted(sites.items(), reverse=True)):
            shape = (N, h, w, c)
            pos = math.prod(shape)
            s, dw, dwb, pw, pwb = spread_inputs(shape, dtype, seed=100 + i)
            s_n = s.permute(0, 3, 1, 2)                 # channels_last view
            if S.spread_route(c, w) == "gemm":
                name, args = "packed_spread", (s, dw, dwb, pw, pwb)
                fn = S.packed_spread
                m, const = S.compose_m(dw, dwb, pw, pwb)
                s8 = s.to(torch.int8)
                kernel = lambda: S._gemm_forward(s8, m, const)
                wrapper = lambda: S._PackedSpread.apply(s, m, const)
                kc = m.reshape(3, 3, c, c).permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                cb = const.to(dtype)
                lib = lambda: F.conv2d(s_n, kc, cb, padding=1)
                bms, by = bound(pos * (1 + item) + 9 * c * c * item + 4 * c,
                                2 * 9 * c * c * N * h * w, dtype)
            else:
                name, args = "binary_dw3_conv", (s, dw, dwb)
                fn = S.binary_dw3_conv
                kernel = wrapper = None
                kd = dw.permute(3, 2, 0, 1).contiguous()
                lib = lambda: F.conv2d(s_n, kd, dwb, padding=1, groups=c)
                # the float plane read once, the output and the int8 plane
                # written once, the weights
                bms, by = bound(pos * (2 * item + 1) + 10 * c * item, 18 * pos, dtype)
            with torch.no_grad():
                got = fn(*args)
                with plain_kernels():
                    want = fn(*args)
                    torch.cuda.synchronize()
                    reps = max(3, min(10, int(4e8 // pos)))
                    plain_ms = cuda_ms(lambda: fn(*args), reps)
                if kernel is None:
                    call = lambda: fn(*args)
                    ms = BS.graph_ms(call)
                    timed = {
                        "wrapper_ms": cuda_ms(call, reps), "library_graph_ms": BS.graph_ms(lib),
                        "bound_int8_in_ms": bound(pos * (1 + item) + 10 * c * item,
                                                  18 * pos, dtype)[0],
                        "bound_cast_pair_ms": bound(2 * pos * (1 + item) + 10 * c * item,
                                                    18 * pos, dtype)[0],
                        "plan": S.plan_dw3(N, h, w, c, SMS, item, item)._asdict()}
                    if (h, w, c) == (80, 80, 128) and dtype == torch.bfloat16:
                        timed["profiler_kernel_ms"] = BS.profiled_ms(call, "spread_dw3_kernel")
                else:
                    ms = cuda_ms(kernel, reps)
                    timed = {"wrapper_ms": cuda_ms(wrapper, reps)}
                library_ms = cuda_ms(lib, reps)
            rec = {"phase": "kernel_check", "kernel": name, "dtype": dname(dtype),
                   "shape": list(shape), "sites": count,
                   "firing_rate": float(s.float().mean()),
                   **check_spread(name, got, want, dtype),
                   "ms": ms, **timed, "plain_ms": plain_ms, "bound_ms": bms,
                   "bound_by": by, "library_ms": library_ms}
            emit(rec, log)
            agg = aggs[name]
            if dtype == torch.bfloat16:      # the trained dtype: one forward
                agg.add(rec, count * (T - 1))
            agg.max_abs_err = max(agg.max_abs_err, rec["max_abs_err"])
            del s, s_n, got, want, args, kernel, wrapper
    return aggs


def phase_spread_grads(S, log) -> None:
    """Each spread kernel's autograd.Function against autograd through its
    plain version, float32, one main-path shape each."""
    for name, fn, ref, shape, nparam in (
            ("binary_dw3_conv", S.binary_dw3_conv, S.binary_dw3_conv_reference,
             (N, 40, 40, 256), 2),
            ("packed_spread", S.packed_spread, S.packed_spread_reference,
             (N, 160, 160, 64), 4)):
        args = spread_inputs(shape, torch.float32, seed=7)[:1 + nparam]
        gy = rand_fn(8)(*shape) - 0.5
        worst = {}
        grads = []
        for f in (fn, ref):
            leaves = [a.clone().requires_grad_(True) for a in args]
            grads.append(torch.autograd.grad(f(*leaves), leaves, gy))
        for gname, a, b in zip(("ds", "dw", "dwb", "dpw", "dpwb"), *grads):
            worst[gname] = float(((a - b).abs() / (GRAD_RTOL * (b.abs().max() + b.abs()))).max())
        emit({"phase": "kernel_grad", "kernel": name, "shape": list(shape),
              "dtype": "float32", "rtol": GRAD_RTOL, "worst_vs_bound": worst}, log)
        if max(worst.values()) > 1.0 or len(worst) != 1 + nparam:
            raise AssertionError(f"{name}: gradients disagree: {worst}")


def phase_k6(FZ, cfg_cls, sites: Counter, broadcast: set, log) -> Agg:
    """The plain-LIF kernel against its plain version at every res10 site
    shape, N=8, T=4, x dense and x a broadcast over T, plus one ragged shape
    (odd element count: the scalar variant)."""
    agg = Agg()
    cfg = cfg_cls(time_window=T, ecs=False)
    shapes = [((T, N, h, w, c), n) for (h, w, c), n in sorted(sites.items(), reverse=True)]
    shapes.append(((4, 3, 5, 7, 3), 0))
    for dtype in (torch.float32, torch.bfloat16):
        item = itemsize(dtype)
        for i, (shape, count) in enumerate(shapes):
            dense = (rand_fn(200 + i)(*shape) * 3 - 1).to(dtype)
            for bcast in (False, True):
                x = dense[:1].expand(*shape) if bcast else dense
                got, want = FZ.lif_fused(x, cfg), FZ.lif_reference(x, cfg)
                silu = (FZ.lif_fused(x, cfg, True).float()
                        - FZ.lif_reference(x, cfg, True).float()).abs()
                ref = FZ.lif_reference(x, cfg, True).float().abs()
                torch.cuda.synchronize()
                share = float((got != want).float().mean())
                if dtype == torch.float32:
                    silu_err, silu_ok = float(silu.max()), float(silu.max()) <= LIF_SILU_ATOL_F32
                else:
                    ulp = torch.exp2(torch.floor(torch.log2(ref.clamp(min=1e-30))) - 7)
                    silu_err = float((silu / ulp).max())
                    silu_ok = silu_err <= LIF_SILU_ULPS_BF16
                m = math.prod(shape[1:])
                reps = max(3, min(10, int(4e8 // math.prod(shape))))
                ms = cuda_ms(lambda: FZ.lif_fused(x, cfg), reps)
                plain_ms = cuda_ms(lambda: FZ.lif_reference(x, cfg), reps)
                # x read once (one plane when it is a broadcast), spikes
                # written once; five operations an element and step
                bms, by = bound(((1 if bcast else shape[0]) + shape[0]) * m * item,
                                5 * math.prod(shape), torch.float32)
                rec = {"phase": "kernel_check", "kernel": "lif_fused",
                       "dtype": dname(dtype), "shape": list(shape), "sites": count,
                       "x_broadcast_over_t": bcast, "mismatch_share": share,
                       "bound_share": 0.0, "max_abs_err": float((got.float() - want.float()).abs().max()),
                       "silu_err": silu_err, "silu_err_unit":
                       "abs" if dtype == torch.float32 else "bf16 ulps",
                       "firing_rate": float(want.float().mean()), "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                       "library_ms": None}
                emit(rec, log)
                if share > 0.0 or not silu_ok:
                    raise AssertionError(f"lif_fused disagrees at {rec}")
                # one val forward: the site behind the stem reads a broadcast
                if dtype == torch.bfloat16 and count and bcast == (shape[2:] in broadcast):
                    agg.add(rec, count)
                agg.max_abs_err = max(agg.max_abs_err, rec["max_abs_err"])
            del dense, x, got, want, silu, ref
    return agg


def phase_k2(FZ, K, cfg_cls, sites: Counter, broadcast: set, log) -> tuple:
    """The general-shape ECS-LIF kernel (K2) against its own plain version at
    every res10 site shape (x dense, and x a broadcast over T where the model
    hands the site one) and at two shapes the tensor-core kernel (K1)
    refuses; beside it K1 on the same inputs (another rounding of the
    spread: recorded, ceiling 2 %).  On the same inputs the shared-memory
    kernel (K3), held to the same plain output with K1's gates, timed beside
    K1 and K2.  Returns the Aggs of K2 and K3."""
    agg, agg3 = Agg(), Agg()
    cfg = cfg_cls(time_window=T)
    shapes = [((T, N, h, w, c), n) for (h, w, c), n in sorted(sites.items(), reverse=True)]
    shapes += [((T, 2, 29, 6, 4), 0), ((T, 2, 20, 20, 12), 0)]
    for dtype in (torch.float32, torch.bfloat16):
        item = itemsize(dtype)
        for i, (shape, count) in enumerate(shapes):
            _, n, h, w, c = shape
            dense, *params = site_inputs(shape, dtype, seed=300 + i)
            for bcast in (False, True) if shape[2:] in broadcast else (False,):
                args = [dense[:1].expand(*shape) if bcast else dense, *params]
                got = FZ.ecs_lif_fused_rows(*args, cfg)
                want = FZ.ecs_lif_rows_reference(*args, cfg)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                share = float((diff > 0).float().mean())
                reps = 3
                ms = cuda_ms(lambda: FZ.ecs_lif_fused_rows(*args, cfg), reps)
                plain_ms = cuda_ms(lambda: FZ.ecs_lif_rows_reference(*args, cfg), 1)
                # the function's bound, not this version's: x read once (one
                # plane when it is a broadcast), spikes written once, weights;
                # the spread's operations over T-1 steps against the peak for
                # x's dtype, as for the tensor-core kernel
                planes = (1 if bcast else T) + T
                bms, by = bound((planes * n * h * w * c + 11 * c + c * c) * item,
                                (T - 1) * n * h * w * (2 * c * c + 18 * c), dtype)
                rec = {"phase": "kernel_check", "kernel": "ecs_lif_fused_rows",
                       "dtype": dname(dtype), "act": False, "shape": list(shape),
                       "sites": count, "x_broadcast_over_t": bcast,
                       "mismatch_share": share,
                       "bound_share": SPIKE_BOUND[dtype], "max_abs_err": float(diff.max()),
                       "firing_rate": float(want.float().mean()), "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                       "library_ms": None}
                if K.layout_refusal(args[0]) is None:
                    k1 = K.ecs_lif_fused(*args, cfg)
                    rec["share_differing_from_tensor_core_kernel"] = float(
                        (k1 != got).float().mean())
                    rec["tensor_core_kernel_ms"] = cuda_ms(
                        lambda: K.ecs_lif_fused(*args, cfg), reps)
                else:
                    rec["tensor_core_kernel_refuses"] = K.layout_refusal(args[0])
                emit(rec, log)
                if (share > SPIKE_BOUND[dtype] or rec.get(
                        "share_differing_from_tensor_core_kernel", 0.0) > ROWS_VS_TENSOR_CORE_CEILING):
                    raise AssertionError(f"ecs_lif_fused_rows disagrees at {rec}")
                # K3 against the same plain output
                got3 = FZ.ecs_lif_fused_v2(*args, cfg)
                torch.cuda.synchronize()
                diff3 = (got3.float() - want.float()).abs()
                cs, cl, _, br, bc = FZ.plan_v2(tuple(shape), item, 0, SMS)
                rec3 = {**rec, "kernel": "ecs_lif_fused_v2",
                        "mismatch_share": float((diff3 > 0).float().mean()),
                        "max_abs_err": float(diff3.max()),
                        "share_differing_from_ecs_lif_fused_rows": float((got3 != got).float().mean()),
                        "ms": cuda_ms(lambda: FZ.ecs_lif_fused_v2(*args, cfg), reps),
                        "ecs_lif_fused_rows_ms": ms, "cluster": cs, "channels_per_block": cl,
                        "tile_rows": br, "tile_cols": bc}
                rec3.pop("share_differing_from_tensor_core_kernel", None)
                emit(rec3, log)
                if rec3["mismatch_share"] > SPIKE_BOUND[dtype]:
                    raise AssertionError(f"ecs_lif_fused_v2 disagrees at {rec3}")
                # one val forward: the site behind the stem reads a broadcast
                if dtype == torch.bfloat16 and count and bcast == (shape[2:] in broadcast):
                    agg.add(rec, count)
                    agg3.add(rec3, count)
                agg.max_abs_err = max(agg.max_abs_err, float(diff.max()))
                agg3.max_abs_err = max(agg3.max_abs_err, rec3["max_abs_err"])
                del args, got, want, diff, got3, diff3
            del dense, params
    # act=True (SiLU) at one small shape K1 refuses, float32; strided inputs
    shape = (T, 2, 29, 6, 12)
    args = site_inputs(shape, torch.float32, seed=98)
    want = FZ.ecs_lif_rows_reference(*args, cfg, True)
    xt = args[0].transpose(2, 3)
    want_t = FZ.ecs_lif_rows_reference(xt.contiguous(), *args[1:], cfg)
    for name in ("ecs_lif_fused_rows", "ecs_lif_fused_v2"):
        fn = getattr(FZ, name)
        err = float((fn(*args, cfg, True) - want).abs().max())
        strided = float((fn(xt, *args[1:], cfg) != want_t).float().mean())
        emit({"phase": "kernel_check", "kernel": name, "dtype": "float32",
              "act": True, "shape": list(shape), "max_abs_err": err,
              "atol": SILU_ATOL, "transposed_input_mismatch_share": strided}, log)
        if err > SILU_ATOL or strided > SPIKE_BOUND[torch.float32]:
            raise AssertionError(f"{name}(act=True) max abs err {err}, "
                                 f"transposed input share {strided}")
    return agg, agg3


def phase_k3_tilings(FZ, cfg_cls, log) -> None:
    """K3's result does not depend on its tiling: at one site shape of each
    regime of the channel split (no cluster, a cluster of 8 blocks with 48
    and with 128 channels each), both dtypes, ``block_rows`` = 0 (the
    wrapper's plan), 7 (no divisor of H) and the largest that fits, bit for
    bit; one more row than the largest raises, naming it."""
    cfg = cfg_cls(time_window=T)
    for dtype in (torch.bfloat16, torch.float32):
        item = itemsize(dtype)
        for i, (h, w, c) in enumerate(((160, 160, 64), (40, 40, 384), (20, 20, 1024))):
            shape = (T, N, h, w, c)
            args = site_inputs(shape, dtype, seed=400 + i)
            most = FZ.max_block_rows(shape, item)
            outs = {b: FZ.ecs_lif_fused_v2(*args, cfg, block_rows=b) for b in (0, 7, most)}
            equal = all(torch.equal(outs[0], o) for o in outs.values())
            named = None
            if most < h:
                try:
                    FZ.ecs_lif_fused_v2(*args, cfg, block_rows=most + 1)
                except ValueError as e:
                    named = str(e).endswith(f"fits is {most}")
            emit({"phase": "k3_tilings", "dtype": dname(dtype), "shape": list(shape),
                  "cluster": FZ.split_channels(c, item)[0],
                  "block_rows": sorted(outs), "plans": {
                      b: list(FZ.plan_v2(shape, item, b, SMS)) for b in sorted(outs)},
                  "bit_equal": equal, "one_more_row_raises_naming_the_largest": named},
                 log)
            if not equal or named is False:
                raise AssertionError(f"ecs_lif_fused_v2 tilings disagree at {shape} {dtype}")
            del args, outs


def phase_k3_path(FZ, cfg_cls, sites: Counter, broadcast: set, counters: dict,
                  log) -> int:
    """K3's main path, its own entry point: ``ecs_lif_fused_v2`` at the 24
    site shapes of one res10@640 forward, N=8, T=4, bf16 (the site behind
    the stem on a broadcast x), counts set to 0 just before and read after."""
    cfg = cfg_cls(time_window=T)
    inputs = []
    for i, ((h, w, c), count) in enumerate(sorted(sites.items(), reverse=True)):
        x, *params = site_inputs((T, N, h, w, c), torch.bfloat16, seed=500 + i)
        if (h, w, c) in broadcast:
            x = x[:1].expand(T, -1, -1, -1, -1)
        inputs.append((count, [x, *params]))
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    rates = []
    for count, args in inputs:
        for _ in range(count):
            y = FZ.ecs_lif_fused_v2(*args, cfg)
        rates.append(float(y.float().mean()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: f.launches for k, f in counters.items()}
    rec = {"phase": "k3_path", "what": "ecs_lif_fused_v2 at the 24 site shapes of one "
           f"res10@640 forward, N={N}, T={T}, bf16", "wall_seconds": wall,
           "launches": counts, "firing_rates": rates}
    emit(rec, log)
    if (counts["ecs_lif_fused_v2"] != sum(sites.values()) or any(
            v for k, v in counts.items() if k != "ecs_lif_fused_v2")
            or not all(0.0 < r < 1.0 for r in rates)):
        raise AssertionError(f"K3 path failed its checks: {rec}")
    del inputs
    return counts["ecs_lif_fused_v2"]


def phase_k7_k8(BD, BS, log) -> dict:
    """The bench kernels against their plain versions at the bench's b16
    sites (``BD.SITES``), both output dtypes, the bench's bf16 weights; the
    plane is int8 0/1 at rate 0.3, and -2..2 at c128.  Gates: K4's for
    ``pallas_dw3`` (the same kernel), K5's for ``pallas_dense3``; one library
    convolution timed beside each.  K8's ``ms`` is the kernel alone
    (``dense3_launch`` on its plan), ``wrapper_ms`` ``pallas_dense3`` as the
    bench calls it, ``mma_route_ms`` the flattened ``mma.sync`` kernel (the
    "mma" route) on the same inputs.  K7's ``ms`` is the
    device time of ``pallas_dw3`` from calls replayed in a CUDA graph,
    ``wrapper_ms`` the same calls eager, ``library_graph_ms`` the library
    call replayed (``BS``: ``scripts.bench_spread``, the timing helpers)."""
    aggs = {"pallas_dw3": Agg(), "pallas_dense3": Agg()}
    for name, shape in BD.SITES.items():
        dense = name.startswith("act")
        kname = "pallas_dense3" if dense else "pallas_dw3"
        s8, k, b = BD.site_inputs(shape, dense, "cuda")
        if name == "c128":
            s8 = torch.from_numpy(np.random.RandomState(600).randint(
                -2, 3, shape).astype(np.int8)).to(s8.device)
        c = shape[-1]
        kk = k.reshape(9 * c, c) if dense else k.reshape(3, 3, c)
        kernel = BD.pallas_dense3 if dense else BD.pallas_dw3
        plain = BD.pallas_dense3_reference if dense else BD.pallas_dw3_reference
        pos = math.prod(shape)
        for out_dtype in (torch.bfloat16, torch.float32):
            fn = lambda: kernel(s8, kk, b, out_dtype)
            with torch.no_grad():
                got, want = fn(), plain(s8, kk, b, out_dtype)
                torch.cuda.synchronize()
                res = check_spread(kname, got, want, out_dtype)
                reps = max(3, min(10, int(4e8 // pos)))
                timed = {}
                if dense:
                    plan = BD.plan_dense3(*shape, SMS)
                    out = torch.empty_like(got)
                    ms = cuda_ms(lambda: BD.dense3_launch(s8, kk, b, out, plan), reps)
                    timed = {"wrapper_ms": cuda_ms(fn, reps), "mma_route_ms": cuda_ms(
                        lambda: BD.dense3_launch(s8, kk, b, out, BD.plan_dense3_mma(*shape)),
                        reps), "plan": plan._asdict()}
                    del out
                else:
                    ms = BS.graph_ms(fn)
                    timed = {"wrapper_ms": cuda_ms(fn, reps), "library_graph_ms": BS.graph_ms(
                        BD.library_call(dense, s8, k, b, out_dtype)),
                        "plan": BD.S.plan_dw3(*shape, SMS, 1, kk.element_size())._asdict()}
                plain_ms = cuda_ms(lambda: plain(s8, kk, b, out_dtype), reps)
                library_ms = cuda_ms(BD.library_call(dense, s8, k, b, out_dtype), reps)
            bms, by = BD.bound_ms(dense, shape, out_dtype)
            rec = {"phase": "kernel_check", "kernel": kname, "site": name,
                   "shape": list(shape), "out_dtype": dname(out_dtype),
                   "weight_dtype": "bfloat16", "int8_values": sorted(
                       int(v) for v in torch.unique(s8).tolist()), **res,
                   "ms": ms, **timed, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                   "library_ms": library_ms}
            emit(rec, log)
            if out_dtype == torch.bfloat16:        # the bench's dtype: one call a site
                aggs[kname].add(rec, 1)
            aggs[kname].max_abs_err = max(aggs[kname].max_abs_err, rec["max_abs_err"])
            del got, want
        del s8, k, b, kk
    return aggs


# K8 beyond the bench sites: (shape, bh, plane, weights) on both routes -- a
# ragged 128-channel plane, C = 48 (one slice), C = 256 (16-channel slices),
# and the "mma" route at C = 512 and C = 80.  "full": int8 -128..127 with
# dyadic weights and bias (multiples of 1/64, |k| <= 1/4), so every sum is
# exact in float32 and kernel and plain version must agree bit for bit;
# "binary": a 0/1 plane at rate 0.3 with float32 weights and bias, which the
# kernel rounds to bf16 itself.
K8_SHAPES = [((2, 36, 44, 128), 4, "full"), ((2, 36, 44, 128), 4, "binary"),
             ((1, 16, 24, 48), 16, "full"), ((1, 8, 40, 256), 8, "full"),
             ((2, 20, 24, 512), 4, "full"), ((1, 16, 16, 80), 16, "full")]


def phase_k8_shapes(BD, log) -> None:
    """K8 against its plain version at ``K8_SHAPES``, both output dtypes
    and, on the full-range planes, both weight dtypes; K5's gates, and bit
    equality on the exact (dyadic) data.  The "mma" shapes must launch that
    route."""
    for i, (shape, bh, kind) in enumerate(K8_SHAPES):
        c = shape[-1]
        rng = np.random.RandomState(700 + i)
        if kind == "full":
            s8 = rng.randint(-128, 128, shape).astype(np.int8)
            k = rng.randint(-16, 17, (9 * c, c)).astype(np.float32) / 64
            b = rng.randint(-64, 65, c).astype(np.float32) / 64
            wdts = (torch.float32, torch.bfloat16)
        else:
            s8 = (rng.rand(*shape) > 0.7).astype(np.int8)
            k = ((rng.rand(9 * c, c) - 0.5) * 0.05).astype(np.float32)
            b = ((rng.rand(c) - 0.5) * 0.1).astype(np.float32)
            wdts = (torch.float32,)
        s8, k, b = (torch.from_numpy(a).cuda() for a in (s8, k, b))
        plan = BD.plan_dense3(*shape, SMS)
        for wdt in wdts:
            for out_dtype in (torch.bfloat16, torch.float32):
                before = BD.pallas_dense3.mma_launches
                with torch.no_grad():
                    got = BD.pallas_dense3(s8, k.to(wdt), b.to(wdt), out_dtype, bh=bh)
                    want = BD.pallas_dense3_reference(s8, k.to(wdt), b.to(wdt), out_dtype)
                    torch.cuda.synchronize()
                res = check_spread("pallas_dense3", got, want, out_dtype)
                rec = {"phase": "k8_shape", "shape": list(shape), "bh": bh, "data": kind,
                       "route": plan.route, "plan": plan._asdict(),
                       "weight_dtype": dname(wdt), "out_dtype": dname(out_dtype),
                       "int8_range": [int(s8.min()), int(s8.max())],
                       "bit_equal": bool(torch.equal(got, want)), **res}
                emit(rec, log)
                mma = BD.pallas_dense3.mma_launches - before
                if ((kind == "full" and not rec["bit_equal"])
                        or mma != (plan.route == "mma")):
                    raise AssertionError(f"pallas_dense3 failed at {shape}: {rec}, "
                                         f"{mma} mma launches")
        del s8, k, b, got, want


# K4/K7's kernel at shapes its plan cuts raggedly: C = 8 and 24 (one channel
# group a block, 128 columns), a 20-wide plane at C = 1024, a full 80x80x128
K4_SHAPES = [(1, 7, 9, 8), (2, 13, 21, 24), (3, 20, 20, 1024), (1, 80, 80, 128)]


def phase_k4_shapes(S, BD, log) -> None:
    """The depthwise kernel through its wrappers against its plain versions
    at ``K4_SHAPES``, with dyadic weights and bias (multiples of 1/64, |k|
    <= 1/4, so every sum is exact in float32 and the results must agree bit
    for bit): the int8-in mode (K7) on full-range int8 planes, both weight
    and both output dtypes; the float-in mode (K4) on binary planes and on
    planes of any value in [-128, 127], both dtypes, where the int8 plane
    the kernel writes must also equal ``s.to(torch.int8)`` byte for byte
    (its taps use that int8 value)."""
    for i, shape in enumerate(K4_SHAPES):
        n, h, w, c = shape
        rng = np.random.RandomState(800 + i)
        s8 = torch.from_numpy(rng.randint(-128, 128, shape).astype(np.int8)).cuda()
        planes = {"binary": torch.from_numpy((rng.rand(*shape) < 0.3).astype(np.float32)),
                  "range": torch.from_numpy(rng.uniform(-128, 127, shape).astype(np.float32))}
        k = torch.from_numpy(rng.randint(-16, 17, (3, 3, 1, c)).astype(np.float32) / 64).cuda()
        b = torch.from_numpy(rng.randint(-64, 65, c).astype(np.float32) / 64).cuda()
        for wdt in (torch.float32, torch.bfloat16):
            k3, bw = k.reshape(3, 3, c).to(wdt), b.to(wdt)
            plan = S.plan_dw3(n, h, w, c, SMS, 1, itemsize(wdt))
            for odt in (torch.bfloat16, torch.float32):
                with torch.no_grad():
                    got = BD.pallas_dw3(s8, k3, bw, odt)
                    want = BD.pallas_dw3_reference(s8, k3, bw, odt)
                    torch.cuda.synchronize()
                rec = {"phase": "k4_shape", "mode": "int8_in", "shape": list(shape),
                       "plan": plan._asdict(), "weight_dtype": dname(wdt),
                       "out_dtype": dname(odt), "data": "full",
                       "int8_range": [int(s8.min()), int(s8.max())],
                       "bit_equal": bool(torch.equal(got, want)),
                       **check_spread("pallas_dw3", got, want, odt)}
                emit(rec, log)
                if not rec["bit_equal"]:
                    raise AssertionError(f"pallas_dw3 failed at {shape}: {rec}")
        for kind, plane in planes.items():
            for dt in (torch.float32, torch.bfloat16):
                sf, kf, bf = plane.cuda().to(dt), k.to(dt), b.to(dt)
                plan = S.plan_dw3(n, h, w, c, SMS, itemsize(dt), itemsize(dt))
                with torch.no_grad():
                    got, g8 = S._dw3_kernel(sf, kf, bf)
                    want8 = sf.to(torch.int8)
                    want = S.binary_dw3_conv_reference(want8, kf, bf)
                    torch.cuda.synchronize()
                rec = {"phase": "k4_shape", "mode": "float_in", "shape": list(shape),
                       "plan": plan._asdict(), "dtype": dname(dt), "data": kind,
                       "bit_equal": bool(torch.equal(got, want)),
                       "int8_plane_equal": bool(torch.equal(g8, want8)),
                       **check_spread("binary_dw3_conv", got, want, dt)}
                emit(rec, log)
                if not (rec["bit_equal"] and rec["int8_plane_equal"]):
                    raise AssertionError(f"binary_dw3_conv failed at {shape}: {rec}")
        del s8, planes, k, b, got, want


def phase_bench_path(BD, BV3, counters: dict, log) -> dict:
    """The kernel benches' main path: ``bench_pallas_dw.bench`` at every
    b16 site, one ``bench_phase_spread`` (K5 against the composite dense
    convolution) and one ``bench_pallas_v3.compare`` (K1 against the eager
    scan), counts set to 0 just before and read after."""
    for f in counters.values():
        f.launches = 0
    BD.pallas_dense3.mma_launches = 0
    t0 = time.perf_counter()
    sites = [BD.bench(shape, name, "cuda", BENCH_ITERS) for name, shape in BD.SITES.items()]
    spread = BD.bench_phase_spread(BD.PHASE_SITES["spread_act1"], "spread_act1", "cuda",
                                   BENCH_ITERS)
    v3 = BV3.compare(BV3.SHAPE, "cuda", V3_ITERS)
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in counters.items()}
    mma = BD.pallas_dense3.mma_launches         # the bench sites take the wgmma route
    rec = {"phase": "bench_path", "iters": BENCH_ITERS, "sites": sites,
           "phase_spread": spread, "v3": v3, "launches": counts,
           "pallas_dense3_mma_launches": mma, "wall_seconds": time.perf_counter() - t0}
    emit(rec, log)
    calls = BENCH_ITERS + 1                  # the warm-up and the timed calls
    dense = sum(1 for name in BD.SITES if name.startswith("act"))
    want = {"pallas_dw3": (len(BD.SITES) - dense) * calls, "pallas_dense3": dense * calls,
            "packed_spread": calls, "ecs_lif_fused": V3_ITERS + 2}
    if (any(counts[k] != want.get(k, 0) for k in counts) or mma
            or v3["spike_mismatch"] > SPIKE_BOUND[torch.bfloat16]
            or not all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in sites)):
        raise AssertionError(f"bench path failed its checks: {rec}, want launches {want}")
    return counts


def write_val_set(root: Path, seed: int) -> Path:
    """A synthetic val split from ``seed``: ``VAL_IMAGES`` images of mixed
    native sizes (noise with flat boxes), 1-12 labelled boxes of ``NC``
    classes each, numeric file stems.  Returns the image directory."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir(parents=True)
    for i in range(VAL_IMAGES):
        h, w = VAL_SIZES[i % len(VAL_SIZES)]
        im = (rng.rand(h, w, 3) * 96 + 64).astype(np.uint8)
        rows = []
        for _ in range(rng.randint(1, 13)):
            bw, bh = rng.uniform(0.05, 0.4, 2)
            cx, cy = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(bh / 2, 1 - bh / 2)
            x0, x1 = int((cx - bw / 2) * w), int((cx + bw / 2) * w)
            y0, y1 = int((cy - bh / 2) * h), int((cy + bh / 2) * h)
            im[y0:y1, x0:x1] = rng.randint(0, 255, 3)
            rows.append(f"{rng.randint(0, NC)} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}")
        Image.fromarray(im).save(root / "images" / f"{1000 + i}.jpg", quality=90)
        (root / "labels" / f"{1000 + i}.txt").write_text("\n".join(rows) + "\n")
    return root / "images"


def recorded_nms(val_mod, run):
    """``run()`` with every NMS output of ``val_mod`` kept (the padded
    ``[B, max_det, 6]`` tensors and their masks, on the host)."""
    real, outs = val_mod.non_max_suppression, []

    def nms(*a, **k):
        out, valid = real(*a, **k)
        outs.append((out.cpu(), valid.cpu()))
        return out, valid

    val_mod.non_max_suppression = nms
    try:
        return run(), outs
    finally:
        val_mod.non_max_suppression = real


def phase_val(seed: int, log) -> dict:
    """The validation main path: res10 full width, nc 13, 640 px, T=4, batch
    8, bf16, over the synthetic split; ECS-LIF on its default route, ECS-LIF
    with ``fused_inference``, and plain LIF."""
    from ecs_yolo_tpu_torch import val as val_mod
    from ecs_yolo_tpu_torch.config import SNNConfig
    from ecs_yolo_tpu_torch.data.dataset import Dataset
    from ecs_yolo_tpu_torch.models.yolo import build_model, cast_params
    from ecs_yolo_tpu_torch.nn.blocks import MemUpdate, _BN
    from ecs_yolo_tpu_torch.ops.cocoeval import dataset_to_coco_gt, evaluate_json
    from ecs_yolo_tpu_torch.snn import ecs_lif as K
    from ecs_yolo_tpu_torch.snn import fused as FZ
    from ecs_yolo_tpu_torch.snn.route import plain_kernels

    counters = {"ecs_lif_fused": K.ecs_lif_fused, "ecs_lif_fused_rows":
                FZ.ecs_lif_fused_rows, "lif_fused": FZ.lif_fused}
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        src = write_val_set(tmp / "val", seed)
        ds = Dataset(src, img_size=IMGSZ, augment=False, uint8_out=True)
        anno = tmp / "gt.json"
        anno.write_text(json.dumps(dataset_to_coco_gt(
            ds, class_names=[str(c) for c in range(NC)])))
        t1 = time.perf_counter()
        items = [ds[i] for i in range(len(ds))]
        decode_ms = (time.perf_counter() - t1) * 1e3 / len(ds)
        t2 = time.perf_counter()
        for _ in ds.batches(N, drop_last=False, yield_idx=True, workers=4):
            pass
        emit({"phase": "val_set", "images": len(ds), "labels":
              int(sum(len(lb) for lb in ds.labels)), "classes": NC,
              "native_sizes": [list(s) for s in VAL_SIZES],
              "write_seconds": t1 - t0,
              "host_decode_letterbox_ms_per_image_one_thread": decode_ms,
              "loader_alone_seconds_4_threads": time.perf_counter() - t2}, log)

        # the metric half on a perfect detector: the labels, through the
        # letterbox to the canvas, handed in as detections
        acc = val_mod.MetricAccumulator(ds)
        for i, (_, labels, mask) in enumerate(items):
            gt = labels[mask]
            h, w = ds.meta(i)["canvas_hw"]
            boxes = val_mod.xywh2xyxy_np(gt[:, 1:5]) * [w, h, w, h]
            acc.add(i, labels, mask, np.concatenate(
                [boxes, np.full((len(gt), 1), 0.9), gt[:, :1]], 1).astype(np.float32))
        sane = acc.summary([0.0, 0.0, 0.0])
        emit({"phase": "val_sanity", "seen": acc.seen, "map50": sane["map50"],
              "map": sane["map"], "mp": sane["mp"], "mr": sane["mr"]}, log)
        if acc.seen != VAL_IMAGES or sane["map50"] < 0.99:
            raise AssertionError(f"val_sanity: a perfect detector scores {sane}")

        calib = torch.from_numpy(np.stack([it[0] for it in items[:N]])).cuda().float() / 255.0
        del items

        def make(snn, state=None):
            model = build_model("resnet10.yaml", nc=NC, snn=snn,
                                generator=torch.Generator().manual_seed(seed + 3))
            if state is None:
                calibrate_bn(model, calib, _BN)
            else:
                model.load_state_dict(state, strict=True)
            return model

        def one_pass(model, name):
            return val_mod.run(model, str(src), imgsz=IMGSZ, batch_size=N,
                               dataset=ds, save_json=str(tmp / f"{name}.json"),
                               anno_json=str(anno))

        def val_pass(name, model, want_kernel, check_plain, ref_fn):
            sites = [m for m in model.modules() if isinstance(m, MemUpdate)]
            for f in counters.values():
                f.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res, outs = recorded_nms(val_mod, lambda: one_pass(model, name))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: f.launches for k, f in counters.items()}
            forwards = len(outs)
            t0 = time.perf_counter()
            evaluate_json(str(anno), str(tmp / f"{name}.json"))
            coco_seconds = time.perf_counter() - t0
            rec = {"phase": "val", "variant": name, "batch": N, "imgsz": IMGSZ,
                   "T": T, "dtype": "bfloat16", "forwards": forwards,
                   **{k: res[k] for k in ("mp", "mr", "map50", "map", "fitness")},
                   "speed_ms_per_image_pre_inference_nms": list(res["speed"]),
                   "seen": res["seen"],
                   "wall_seconds": wall, "images_per_s": VAL_IMAGES / wall,
                   "of_which_cocoeval_seconds": coco_seconds,
                   "launches": counts, "launches_per_forward":
                   {k: v / forwards for k, v in counts.items()},
                   "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "detections": len(json.loads((tmp / f"{name}.json").read_text())),
                   "coco": res.get("coco")}
            launches[want_kernel] = counts[want_kernel]
            ok = (forwards == VAL_IMAGES // N and res["seen"] == VAL_IMAGES
                  and all(counts[k] == (len(sites) * forwards if k == want_kernel else 0)
                          for k in counts)
                  and all(math.isfinite(res[k]) and 0 <= res[k] <= 1
                          for k in ("mp", "mr", "map50", "map", "fitness"))
                  and all(math.isfinite(v) for v in res["coco"].values()))
            if check_plain:
                with plain_kernels():
                    res_p, outs_p = recorded_nms(val_mod, lambda: one_pass(model, name + "_plain"))
                rows = sum(o.shape[0] * o.shape[1] for o, _ in outs)
                worst, off, masks_equal = 0.0, 0, True
                for (o, v), (op, vp) in zip(outs, outs_p):
                    d = (o - op).abs().amax(-1)
                    worst, off = max(worst, float(d.max())), off + int((d > 0).sum())
                    masks_equal &= bool((v == vp).all())
                metric_diff = max(abs(res[k] - res_p[k])
                                  for k in ("mp", "mr", "map50", "map", "fitness"))
                rec.update(nms_output_max_abs_diff_vs_plain_kernels=worst,
                           nms_rows_differing_share=off / rows,
                           nms_valid_masks_equal=masks_equal,
                           metrics_max_abs_diff_vs_plain_kernels=metric_diff)
                ok &= (worst <= 1e-3 and off / rows <= 1e-3 and metric_diff <= 1e-6
                       and (masks_equal or off > 0) and sum(
                           f.launches for f in counters.values()) == sum(counts.values()))
            # every real neuron site of one batch against the plain version
            # of its kernel, on the site's own input
            x = torch.from_numpy(np.stack([ds[i][0] for i in range(N)])).cuda().float() / 255.0
            with torch.inference_mode():
                _, seen = hooked_sites(sites, lambda: model(x))
                shares = [float((ref_fn(m, xin).to(torch.uint8) != spikes).float().mean())
                          for m, xin, spikes in seen]
            del seen
            rec["worst_site_mismatch_share"] = max(shares)
            rec["site_firing_rates_checked"] = len(shares)
            ok &= len(shares) == len(sites) and max(shares) <= (
                0.0 if want_kernel == "lif_fused" else SPIKE_BOUND[torch.bfloat16])
            rec.update(profile_step(lambda: one_pass(model, name + "_prof")))
            emit(rec, log)
            if not ok:
                raise AssertionError(f"val pass {name} failed its checks: {rec}")
            return res, outs

        ecs_ref = lambda fn: lambda m, xin: fn(xin, *m.spread_params(), m.snn, m.act)
        model = cast_params(make(SNNConfig(time_window=T)), torch.bfloat16)
        res_a, outs_a = val_pass("ecs_lif", model, "ecs_lif_fused", True,
                         ecs_ref(K.ecs_lif_reference))
        state = model.state_dict()
        del model
        model = cast_params(make(SNNConfig(time_window=T, fused_inference=True), state),
                            torch.bfloat16)
        res_b, outs_b = val_pass("ecs_lif_fused_inference", model, "ecs_lif_fused_rows",
                         False, ecs_ref(FZ.ecs_lif_rows_reference))
        del model, state
        rows_differing = sum(int(((a - b).abs().amax(-1) > 0).sum())
                             for (a, _), (b, _) in zip(outs_a, outs_b))
        emit({"phase": "val_routes", "what": "fused_inference against the default "
              "route, same weights (another rounding of the spread; recorded only)",
              "nms_rows_differing_share": rows_differing / sum(
                  a.shape[0] * a.shape[1] for a, _ in outs_a),
              "nms_output_max_abs_diff": max(
                  float((a - b).abs().max()) for (a, _), (b, _) in zip(outs_a, outs_b)),
              **{f"{k}_abs_diff": abs(res_a[k] - res_b[k])
                 for k in ("mp", "mr", "map50", "map", "fitness")}}, log)
        model = cast_params(make(SNNConfig(time_window=T, ecs=False)), torch.bfloat16)
        val_pass("plain_lif", model, "lif_fused", True,
                 lambda m, xin: FZ.lif_reference(xin, m.snn, m.act))
        del model
    return launches


def write_images(d: Path, seed: int = 0):
    from PIL import Image

    rng = np.random.RandomState(seed)
    for i, (h, w) in enumerate([(480, 640), (720, 1280), (640, 640), (375, 500)]):
        im = (rng.rand(h, w, 3) * 96 + 64).astype(np.uint8)
        for _ in range(6):   # a few flat boxes over the noise
            y0, x0 = rng.randint(0, h - 40), rng.randint(0, w - 40)
            im[y0:y0 + rng.randint(20, h // 2), x0:x0 + rng.randint(20, w // 2)] \
                = rng.randint(0, 255, 3)
        Image.fromarray(im).save(d / f"synthetic_{i}.png")


def train_batch(seed: int):
    """Images [N,640,640,3] in 0-1 with a few flat boxes, targets [N,M,5]
    (cls, x, y, w, h normalised) for those boxes, and their mask."""
    rng = np.random.RandomState(seed)
    ims = rng.rand(N, IMGSZ, IMGSZ, 3).astype(np.float32) * 0.4 + 0.2
    targets = np.zeros((N, TRAIN_BOXES, 5), np.float32)
    for n in range(N):
        for j in range(TRAIN_BOXES):
            bw, bh = rng.rand(2) * 0.3 + 0.04
            cx, cy = rng.rand() * (1 - bw) + bw / 2, rng.rand() * (1 - bh) + bh / 2
            x0, x1 = int((cx - bw / 2) * IMGSZ), int((cx + bw / 2) * IMGSZ)
            y0, y1 = int((cy - bh / 2) * IMGSZ), int((cy + bh / 2) * IMGSZ)
            ims[n, y0:y1, x0:x1] = rng.rand(3)
            targets[n, j] = [rng.randint(0, NC), cx, cy, bw, bh]
    mask = np.ones((N, TRAIN_BOXES), bool)
    return (torch.from_numpy(ims).cuda(), torch.from_numpy(targets).cuda(),
            torch.from_numpy(mask).cuda())


def hooked_sites(sites, run):
    """Run ``run()`` with every site's input and output (as uint8) kept."""
    seen = []
    hooks = [m.register_forward_hook(
        lambda m, i, o: seen.append((m, i[0].detach(), o.detach().to(torch.uint8))))
        for m in sites]
    try:
        out = run()
    finally:
        for h in hooks:
            h.remove()
    return out, seen


def phase_train(log) -> dict:
    """The training main path: res10 full width, 640 px, T=4, batch 8."""
    from ecs_yolo_tpu_torch.data.hyps import HYP_SCRATCH
    from ecs_yolo_tpu_torch.models.yolo import build_model
    from ecs_yolo_tpu_torch.nn.blocks import MemUpdate
    from ecs_yolo_tpu_torch.snn import ecs_lif as K1
    from ecs_yolo_tpu_torch.snn import spread as S
    from ecs_yolo_tpu_torch.snn.route import plain_kernels
    from ecs_yolo_tpu_torch.train.optim import build_optimizer
    from ecs_yolo_tpu_torch.train.trainer import (create_train_state,
                                                  make_grad_fn, make_train_step)

    model = build_model("resnet10.yaml", nc=NC,
                        generator=torch.Generator().manual_seed(1))
    sites = [m for m in model.modules() if isinstance(m, MemUpdate)]
    hyp = HYP_SCRATCH
    names = dict(model.named_parameters())
    tx = build_optimizer(
        names, name="SGD", lr0=hyp["lr0"], lrf=hyp["lrf"],
        momentum=hyp["momentum"], weight_decay=hyp["weight_decay"], epochs=300,
        steps_per_epoch=1000, warmup_epochs=hyp["warmup_epochs"],
        warmup_momentum=hyp["warmup_momentum"],
        warmup_bias_lr=hyp["warmup_bias_lr"])
    state = create_train_state(model, tx)
    batch = train_batch(seed=2)
    counters = (K1.ecs_lif_fused, S.binary_dw3_conv, S.packed_spread)

    # one float32 step's loss and gradients: kernel route against plain route,
    # from the same state (the BN running statistics are put back between).
    # Each site is held to its plain version on its own real input; end to
    # end one flipped spike near a threshold spreads through the 3x3
    # convolutions and batch statistics behind it, so the share of spikes
    # that differ between the two whole runs is recorded, not bounded.
    stats0 = {k: v.clone() for k, v in state.batch_stats.items()}
    grad_fn = make_grad_fn(model, hyp)
    (loss_k, _, grads_k), seen_k = hooked_sites(
        sites, lambda: grad_fn(state, *batch))
    flips = []
    with plain_kernels(), torch.no_grad():
        for m, xin, spikes in seen_k:
            flips.append(float((m(xin).to(torch.uint8) != spikes).float().mean()))
    for k, v in stats0.items():
        state.batch_stats[k].copy_(v)
    with plain_kernels():
        (loss_p, _, grads_p), seen_p = hooked_sites(
            sites, lambda: grad_fn(state, *batch))
    for k, v in stats0.items():
        state.batch_stats[k].copy_(v)
    cascade = [float((a[2] != b[2]).float().mean()) for a, b in zip(seen_k, seen_p)]
    rates = [float(a[2].float().mean()) for a in seen_k]
    del seen_k, seen_p
    norm = lambda g: float(torch.sqrt(sum((v.double() ** 2).sum() for v in g.values())))
    rec = {"phase": "train_step_fp32", "batch": N, "loss_kernel": float(loss_k),
           "loss_plain": float(loss_p),
           "loss_rel_err": abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)),
           "worst_site_mismatch_share": max(flips),
           "site_mismatch_shares_whole_run": cascade,
           "site_firing_rates": rates,
           "grads_finite": all(bool(torch.isfinite(g).all()) for g in grads_k.values()),
           "grad_norm_kernel": norm(grads_k), "grad_norm_plain": norm(grads_p)}
    rec["grad_norm_rel_err"] = (abs(rec["grad_norm_kernel"] - rec["grad_norm_plain"])
                                / rec["grad_norm_plain"])
    emit(rec, log)
    if (len(flips) != len(sites) or rec["loss_rel_err"] > 1e-3
            or rec["worst_site_mismatch_share"] > SPIKE_BOUND[torch.float32]
            or not rec["grads_finite"] or rec["grad_norm_rel_err"] > 1e-2):
        raise AssertionError(f"float32 train step: kernel route disagrees: {rec}")
    del grads_k, grads_p

    # the main path: bf16 compute on float32 masters, a few SGD steps
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, tx, hyp, compute_dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    for f in counters:
        f.launches = 0
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_STEPS + 1)]
    losses = []
    events[0].record()
    for i in range(TRAIN_STEPS):
        state, metrics = step(state, *batch)
        events[i + 1].record()
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    launches = [f.launches for f in counters]
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(TRAIN_STEPS)]
    ms = sum(step_ms[-3:]) / 3
    losses = [float(v) for v in losses]
    sd = model.state_dict()
    moved = lambda k, now: float((now.float() - before[k].float()).abs().max()) > 0
    groups_moved = {g: any(moved(k, sd[k]) for k, lab in tx.labels.items() if lab == g)
                    for g in sorted(set(tx.labels.values()))}
    applied = int(state.opt_state.count)
    prof = profile_step(lambda: step(state, *batch))
    rec = {"phase": "train_step", "batch": N, "imgsz": IMGSZ, "T": T,
           "dtype": "bfloat16", "steps": TRAIN_STEPS, "losses": losses,
           "step_ms": step_ms, "ms_per_step": ms, "images_per_s": N / ms * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_per_step": {"ecs_lif_fused": launches[0] / TRAIN_STEPS,
                                 "binary_dw3_conv": launches[1] / TRAIN_STEPS,
                                 "packed_spread": launches[2] / TRAIN_STEPS},
           "groups_moved": groups_moved,
           "ema_moved": any(moved(k, e) for k, e in state.ema_params.items()),
           "bn_stats_moved": all(moved(k, sd[k]) for k in state.batch_stats
                                 if sd[k].is_floating_point()),
           "applied_steps": applied,
           "site_firing_rates": [float(m.firing_rate) for m in sites], **prof}
    emit(rec, log)
    if (not all(math.isfinite(v) for v in losses) or not all(groups_moved.values())
            or len(groups_moved) != 3 or not rec["ema_moved"]
            or not rec["bn_stats_moved"] or rec["applied_steps"] != TRAIN_STEPS
            or launches != [0, 57 * TRAIN_STEPS, 15 * TRAIN_STEPS]):
        raise AssertionError(f"bf16 train steps failed their checks: {rec}")
    return {"binary_dw3_conv": launches[1], "packed_spread": launches[2]}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="port smoke test on one card")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every phase's record to this JSON file")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic val split and the val models")
    opt = ap.parse_args(argv)
    out_path = opt.out
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port, imported from this checkout only once a card is known
    from ecs_yolo_tpu_torch import _build
    from ecs_yolo_tpu_torch import detect as detect_mod
    from ecs_yolo_tpu_torch.config import SNNConfig
    from ecs_yolo_tpu_torch.data.loaders import LoadImages
    from ecs_yolo_tpu_torch.models.yolo import build_model, cast_params
    from ecs_yolo_tpu_torch.nn.blocks import MemUpdate, _BN
    from ecs_yolo_tpu_torch.snn import ecs_lif as K
    from ecs_yolo_tpu_torch.snn import fused as FZ
    from ecs_yolo_tpu_torch.snn import spread as S
    from ecs_yolo_tpu_torch.snn.route import plain_kernels
    from ecs_yolo_tpu_torch.scripts import bench_pallas_dw as BD
    from ecs_yolo_tpu_torch.scripts import bench_pallas_v3 as BV3
    from ecs_yolo_tpu_torch.scripts import bench_spread as BS

    global SMS
    SMS = torch.cuda.get_device_properties(0).multi_processor_count
    every_kernel = {"ecs_lif_fused": K.ecs_lif_fused, "binary_dw3_conv": S.binary_dw3_conv,
                    "packed_spread": S.packed_spread, "lif_fused": FZ.lif_fused,
                    "ecs_lif_fused_rows": FZ.ecs_lif_fused_rows,
                    "ecs_lif_fused_v2": FZ.ecs_lif_fused_v2,
                    "pallas_dw3": BD.pallas_dw3, "pallas_dense3": BD.pallas_dense3}
    log: dict = {}
    card = smi()
    emit({"phase": "environment", "nvidia_smi": card,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "allow_tf32_matmul_default": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn_default": torch.backends.cudnn.allow_tf32}, log)
    # float32 checks compare full float32 arithmetic on both sides
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    sources = ["ecs_lif", "spread_dw3", "spread_gemm", "lif_fused", "ecs_lif_rows",
               "ecs_lif_v2", "dense3"]
    _build.build(sources)            # one nvcc per source, all started together
    for name in sources:
        _build.load(name)
        nvcc_s = _build.build_info.get(name, (None, ""))[0]   # None: built earlier
        ptxas = [ln.split("info    : ")[-1].strip()
                 for ln in _build.nvcc_log(name).splitlines()
                 if any(k in ln for k in ("registers", "spill", "Compiling entry",
                                          "arning"))]
        emit({"phase": "build", "kernel": name, "seconds":
              time.perf_counter() - t0, "nvcc_seconds": nvcc_s, "ptxas": ptxas}, log)
        spill = [ln for ln in ptxas if "spill" in ln]
        if name in NO_SPILL and (not spill or any(
                not ln.startswith("0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                                  "spill loads") for ln in spill)):
            raise AssertionError(f"{name}: spills, or no -Xptxas -v report: {ptxas}")

    # --- the model, and its neuron sites ---------------------------------------
    gen = torch.Generator().manual_seed(0)
    model = build_model("resnet10.yaml", nc=NC, generator=gen)
    sites = [m for m in model.modules() if isinstance(m, MemUpdate)]
    with tempfile.TemporaryDirectory() as tmp:
        write_images(Path(tmp))
        ims = [im for _, im, _ in LoadImages(tmp, IMGSZ)]
        x1 = torch.from_numpy(ims[0]).cuda()
        broadcast: set = set()
        shapes = site_shapes(model, MemUpdate, x1, broadcast)
        emit({"phase": "sites", "count": len(sites), "shapes":
              [[list(k), v] for k, v in sorted(shapes.items(), reverse=True)],
              "input_broadcast_over_t": sorted(map(list, broadcast))}, log)
        if len(sites) != 24:
            raise AssertionError(f"res10 has {len(sites)} neuron sites, want 24")

        agg1 = phase_k1(K, SNNConfig, shapes, broadcast, log)
        aggs = phase_spread(S, BS, plain_kernels, shapes, log)
        phase_spread_grads(S, log)
        agg6 = phase_k6(FZ, SNNConfig, shapes, broadcast, log)
        agg2, agg3 = phase_k2(FZ, K, SNNConfig, shapes, broadcast, log)
        phase_k3_tilings(FZ, SNNConfig, log)

        # --- the detect path at full width -------------------------------------
        calibrate_bn(model, torch.from_numpy(np.concatenate(ims)).cuda(), _BN)

        # end to end in float32: kernel route against the plain route
        with torch.no_grad():
            z_k = model(x1)[0].float()
            with plain_kernels():
                z_p = model(x1)[0].float()
        d = (z_k - z_p).abs()
        rel = float((d > 1e-3 * (1 + z_p.abs())).float().mean())
        emit({"phase": "model_fp32", "shape": list(z_k.shape),
              "finite": bool(torch.isfinite(z_k).all()), "max_abs_err":
              float(d.max()), "share_off_by_1e-3_rel": rel}, log)
        if not torch.isfinite(z_k).all() or rel > 1e-3:
            raise AssertionError("float32 model: kernel route disagrees")

        cast_params(model, torch.bfloat16)
        # one hooked forward: every site's real input and the kernel output
        seen = []
        hooks = [m.register_forward_hook(
            lambda m, i, o: seen.append((m, i[0], o))) for m in sites]
        with torch.no_grad():
            model(x1)
        for h in hooks:
            h.remove()
        worst = 0.0
        for j, (m, xin, spikes) in enumerate(seen):
            ref = K.ecs_lif_reference(xin, *m.spread_params(), m.snn, m.act)
            share = float((ref != spikes).float().mean())
            worst = max(worst, share)
            emit({"phase": "site", "site": j, "shape": list(xin.shape),
                  "firing_rate": float(spikes.float().mean()),
                  "mismatch_share": share}, log)
        del seen
        if worst > SPIKE_BOUND[torch.bfloat16]:
            raise AssertionError(f"a site disagrees: share {worst}")

        # the serving main path: detect.run over the images, counts read around it
        K.ecs_lif_fused.launches = 0
        t0 = time.perf_counter()
        results = detect_mod.run(model, tmp, imgsz=IMGSZ)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1_launches = K.ecs_lif_fused.launches
        for path, dets in results:
            emit({"phase": "detect", "image": Path(path).name,
                  "detections": int(len(dets)),
                  "finite": bool(np.isfinite(dets).all())}, log)
        emit({"phase": "detect_run", "images": len(results), "seconds": wall,
              "ecs_lif_launches": k1_launches}, log)
        if k1_launches != len(sites) * len(results) or len(results) != 4:
            raise AssertionError(f"{k1_launches} K1 launches for {len(results)} "
                                 f"forwards, want {len(sites)} each")

        # --- throughput: batched bf16 forward, N=8 -----------------------------
        xb = torch.from_numpy(np.concatenate(ims * 2)).cuda()
        with torch.no_grad():
            ms = cuda_ms(lambda: model(xb), reps=10)
            prof = profile_step(lambda: model(xb))
    emit({"phase": "throughput", "batch": int(xb.shape[0]), "imgsz": IMGSZ,
          "T": T, "dtype": "bfloat16", "ms_per_forward": ms,
          "images_per_s": xb.shape[0] / ms * 1e3, **prof}, log)
    del model, xb, x1

    # --- the training main path ------------------------------------------------
    spread_launches = phase_train(log)

    # --- the validation main path ----------------------------------------------
    val_launches = phase_val(opt.seed, log)

    # --- K3's entry point, and the kernel benches ------------------------------
    k3_launches = phase_k3_path(FZ, SNNConfig, shapes, broadcast, every_kernel, log)
    aggs78 = phase_k7_k8(BD, BS, log)
    phase_k8_shapes(BD, log)
    phase_k4_shapes(S, BD, log)
    bench_launches = phase_bench_path(BD, BV3, every_kernel, log)

    csrc = "ecs_yolo_tpu_torch/csrc/"
    fwd = f"one res10@640 training forward, N={N}, T={T}, bf16"
    kernels = {"kernels": [
        agg1.entry(
            name="ecs_lif_fused", route="cuda", source=csrc + "ecs_lif.cu",
            replaces="ecs_yolo_tpu/snn/pallas_ecs_v3.py:172", launches=k1_launches,
            work=f"the 24 neuron sites of one res10@640 forward, N={N}, T={T}, "
                 "bf16; launches over the 4 detect forwards (the val pass on "
                 f"the default route adds {val_launches['ecs_lif_fused']})",
            library_note="no single PyTorch call computes the ECS-LIF recurrence"),
        aggs["binary_dw3_conv"].entry(
            name="binary_dw3_conv", route="cuda", source=csrc + "spread_dw3.cu",
            replaces="ecs_yolo_tpu/snn/pallas_dw.py:73",
            launches=spread_launches["binary_dw3_conv"],
            work=f"the 57 launches (19 sites x {T - 1} steps) of {fwd}; launches "
                 f"over the {TRAIN_STEPS} train steps; ms is the device time of "
                 "binary_dw3_conv (one launch a call) from calls replayed in a CUDA "
                 "graph, wrapper_ms the same calls eager; the bound is the float-in "
                 "function's (the plane read, the output and the int8 plane written)",
            library_note="F.conv2d(groups=C) with bias, channels_last, replayed in a "
                         "CUDA graph as ms is; library_eager_ms the same call eager",
            graph_library=True),
        aggs["packed_spread"].entry(
            name="packed_spread", route="cuda", source=csrc + "spread_gemm.cu",
            replaces="ecs_yolo_tpu/snn/pallas_dw.py:218",
            launches=spread_launches["packed_spread"],
            work=f"the 15 launches (5 sites x {T - 1} steps) of {fwd}; launches "
                 f"over the {TRAIN_STEPS} train steps; ms is the kernel alone, "
                 "wrapper_ms the autograd.Function as the train path calls it",
            library_note="dense F.conv2d with the composed [C,C,3,3] kernel and "
                         "bias const, channels_last"),
        agg6.entry(
            name="lif_fused", route="cuda", source=csrc + "lif_fused.cu",
            replaces="ecs_yolo_tpu/snn/pallas_kernels.py:57",
            launches=val_launches["lif_fused"],
            work=f"the 24 neuron sites of one plain-LIF res10@640 forward, N={N}, "
                 f"T={T}, bf16 (the site behind the stem reads a broadcast x); "
                 f"launches over the {VAL_IMAGES // N} forwards of the val pass",
            library_note="no single PyTorch call computes the LIF recurrence"),
        agg2.entry(
            name="ecs_lif_fused_rows", route="cuda", source=csrc + "ecs_lif_rows.cu",
            replaces="ecs_yolo_tpu/snn/pallas_kernels.py:326",
            launches=val_launches["ecs_lif_fused_rows"],
            work=f"the 24 neuron sites of one res10@640 forward under "
                 f"fused_inference, N={N}, T={T}, bf16 (the site behind the stem "
                 "reads a broadcast x); launches over the "
                 f"{VAL_IMAGES // N} forwards of the val pass",
            note="this version runs the 1x1 product on CUDA cores; the bound "
                 "is the function's, against the peak for x's dtype",
            library_note="no single PyTorch call computes the ECS-LIF recurrence"),
        agg3.entry(
            name="ecs_lif_fused_v2", route="cuda", source=csrc + "ecs_lif_v2.cu",
            replaces="ecs_yolo_tpu/snn/pallas_kernels.py:243", launches=k3_launches,
            work=f"its own entry point at the 24 neuron-site shapes of one res10@640 "
                 f"forward, N={N}, T={T}, bf16 (the site behind the stem on a "
                 "broadcast x); no model route takes it, as in the JAX package",
            note="state in shared memory, tiles in rows and width, C split "
                 "over a cluster of up to 8 blocks; the bound is K2's",
            library_note="no single PyTorch call computes the ECS-LIF recurrence"),
        aggs78["pallas_dw3"].entry(
            name="pallas_dw3", route="cuda", source=csrc + "spread_dw3.cu",
            replaces="scripts/bench_pallas_dw.py:72",
            launches=bench_launches["pallas_dw3"],
            work="ecs_yolo_tpu_torch.scripts.bench_pallas_dw at its three "
                 "depthwise b16 sites, bf16 out, one call each; launches over "
                 f"the bench's warm-up and {BENCH_ITERS} timed calls a site; ms is "
                 "the device time of pallas_dw3 from calls replayed in a CUDA "
                 "graph, wrapper_ms the same calls eager",
            library_note="F.conv2d(groups=C) with bias, channels_last, replayed in a "
                         "CUDA graph as ms is; library_eager_ms the same call eager",
            graph_library=True),
        aggs78["pallas_dense3"].entry(
            name="pallas_dense3", route="cuda", source=csrc + "dense3.cu",
            replaces="scripts/bench_pallas_dw.py:127",
            launches=bench_launches["pallas_dense3"],
            work="ecs_yolo_tpu_torch.scripts.bench_pallas_dw at its two dense "
                 "b16 sites, bf16 out, one call each; launches over the bench's "
                 f"warm-up and {BENCH_ITERS} timed calls a site; ms is the kernel "
                 "alone, wrapper_ms pallas_dense3 as the bench calls it",
            library_note="dense F.conv2d with bias, channels_last"),
    ]}
    if out_path is not None:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps({"log": log, **kernels}, indent=1))
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def calibrate_bn(model, x, bn_cls) -> None:
    """BN running statistics from one batch (momentum 1): with random
    weights and the init's mean 0 / variance 1, nearly every site after the
    stem stays silent; calibrated, every site fires, so the checks below see
    real spike traffic."""
    bns = [m for m in model.modules() if isinstance(m, bn_cls)]
    for b in bns:
        b.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(x)
    model.eval()
    for b in bns:
        b.momentum = 0.1


def profile_step(run) -> dict:
    """Device time by kernel over one call of ``run`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []   # kernels only: an operator's row repeats its kernels' time
    for e in p.key_averages():
        if str(e.device_type).endswith("CUDA"):
            rows.append((e.self_device_time_total / 1e3, e.key, e.count))
    if not rows:
        return {"profile": "not measured: no device time in the trace"}
    total = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    own = {name: sum(r[0] for r in rows if tag in r[1]) for name, tag in (
        ("ecs_lif_device_ms", "ecs_lif_kernel"),
        ("ecs_lif_rows_device_ms", "ecs_lif_rows_kernel"),
        ("lif_fused_device_ms", "lif_fused_"),
        ("spread_dw3_device_ms", "spread_dw3_kernel"),
        ("spread_gemm_device_ms", "spread_gemm_"))}
    return {"profiled_wall_ms": wall_ms, "device_ms": total,
            "kernel_calls": sum(r[2] for r in rows), **own,
            "idle_share": max(0.0, 1 - total / wall_ms),
            "top_kernels": [{"name": k[:90], "ms": ms, "calls": c}
                            for ms, k, c in rows[:12]]}


if __name__ == "__main__":
    sys.exit(main())
