"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's seven CUDA kernel sources from the checkout
(``ecs_yolo_tpu_torch/csrc/``: the fused ECS-LIF forward, the binary depthwise
3x3, the fused dw+pw spread product, the fused plain-LIF forward, the
general-shape fused ECS-LIF forward, the ECS-LIF forward with its state on
chip, the dense 3x3 product), which serve eight functions (the
depthwise kernel also serves the bench's ``pallas_dw3``), takes the
EMS-ResNet10@640 neuron-site shapes from the model itself, holds every kernel
against its plain PyTorch version at those shapes (the fused ECS-LIF forward
also at six shapes the forward does not give it, ``k1_shape``, each record
with the launch's plan: items, grid, Cout slice; and the two spread
kernels' gradients against autograd through the plain version; the fused
spread product and the dense 3x3 product timed alone and as their callers
call them; the ``-Xptxas -v`` report of every source, with no spill allowed
in the four ``wgmma`` sources, ``ecs_lif``, ``ecs_lif_v2``, ``spread_gemm``
and ``dense3``, nor in the depthwise ``spread_dw3`` or the plain-LIF
``lif_fused``), and drives
the port's paths at full width with random weights from a seed:

* serving: ``ecs_yolo_tpu_torch.detect.run`` on synthetic images (bf16), with
  every neuron site checked against the plain version on its real input, and
  a timed batched forward;
* serving with the conv/bn pairs folded (``models/utils.fuse_conv_bn``,
  phase ``fuse``): the calibrated model fused and unfused in float32 and
  bf16, ms and kernels a b8 forward, the elementwise device time left, the
  share of spikes the fold flips per site (gated by the kernel gates'
  bounds), and the folded-pair count held to the JAX function's;
* training: one float32 step on the kernel route against the same step under
  ``plain_kernels()``, then a few bf16 steps of
  ``ecs_yolo_tpu_torch.train.trainer.make_train_step`` with SGD; then
  (phase ``train_run``) ``ecs_yolo_tpu_torch.train.driver.train`` itself:
  64 synthetic images from ``--seed``, mosaic on, nbs 64 (accumulate 8),
  autoanchor, bf16, two epochs with a val pass each on the EMA copy, then a
  resume from ``last.pt`` for a third, whose restored state is held bit for
  bit to the file; per epoch the loop, val and checkpoint seconds, loop
  img/s with the loader in it and its wait share, launches per micro-step
  (57 binary_dw3_conv + 15 packed_spread, no eval kernel) and per val
  forward (24 ecs_lif_fused), applies and EMA updates (every 8th
  micro-step), and the second loop's device time and idle share; then
  (phase ``train_opts``) the driver's options: one step each with ``remat``
  and ``remat_neuron`` held to the plain step (parameters, EMA, BN
  statistics; peak memory, time and launches of each, the recompute's
  launches counted), a batch augmented on the card (``device_augment``)
  held to the CPU on the same draws on both routes and timed, one 64-image
  epoch of ``train.driver.train(device_augment=True)`` beside the host
  mosaic's, ``train.driver.dispatch`` of 4 batches under
  ``torch.cuda.set_sync_debug_mode("error")`` held to 4 single steps and
  timed against them, and three Lion steps with the ``sr`` term held to the
  same update on the CPU;
* the anchor-free heads (phase ``heads``, after ``train_opts``):
  ``res10v8.yaml`` (ASFF_DDetect with the TAL loss) at b8, bf16: every
  neuron site of a forward against the plain version of its kernel on its
  real input, ``detect.run``, a timed and profiled forward with K1's time at
  the head's sites, one float32 step against its ``plain_kernels()`` rerun
  with every site teacher-forced (each parameter's gradient; a planted wrong
  K4 int8 plane must fail that gate), three timed bf16 steps (K4 / K5
  launches, peak memory, the TAL assigner's device time) and one more under
  ``torch.cuda.set_sync_debug_mode("error")``, one 64-image epoch of ``train.driver.train`` whose val pass
  on the EMA copy must give ``plain_kernels()``'s detections; the K1, K4 and
  K5 shapes the heads add (C = 8; K5 at 40x40x64 and 20x20x64) in their own
  kernel_check records; the other four anchor-free YAMLs at b2 (a checked
  detect batch, ``detect.run``, a float32 step; ``res10v10`` one
  ``val.run``);
* validation: ``ecs_yolo_tpu_torch.val.run`` over a synthetic val split of 32
  images written from ``--seed`` (bf16, batch 8), three times: the ECS-LIF
  model on its default route, the same model with ``fused_inference=True``,
  and the plain-LIF model (``ecs=False``); each again under
  ``plain_kernels()``, which must give the same detections and metrics, and
  each model's batch-8 forward timed alone and profiled; the ECS-LIF
  pass again with its weights folded (``--fuse``, phase ``val_fuse``),
  recorded beside the unfused one; and the metric half alone on a perfect
  detector;
* the shared-state ECS-LIF kernel's own entry point,
  ``snn.fused.ecs_lif_fused_v2``, at the 24 site shapes of one res10@640
  forward (bf16, N=8), after its checks at every site shape against the
  general-shape kernel's plain version, beside the other two ECS-LIF
  kernels (each record with its plan: items, grid, Cout slice, where the
  state lies; where it fits in shared memory, the same launch with its
  state there and in the workspace timed in turns), and its tilings held
  equal bit for bit across ``block_rows``;
* the kernel benches: ``ecs_yolo_tpu_torch.scripts.bench_pallas_dw`` at its
  b16 sites (``pallas_dw3``, ``pallas_dense3``, each first checked against
  its plain version in both output dtypes; ``pallas_dense3`` also at six
  more shapes on both of its routes, full-range int8 planes with dyadic
  weights held bit for bit; the depthwise kernel at four more shapes in
  both of its modes, bit for bit, its int8 plane equal to the cast's) and
  one call each of its
  ``bench_phase_spread`` and of ``scripts.bench_pallas_v3.compare``.

The depthwise kernel (``binary_dw3_conv``, ``pallas_dw3``) and the
plain-LIF kernel (``lif_fused``) are timed alone as the device time of calls
replayed in a CUDA graph, beside the same calls eager (the host's issue rate
in them; for the plain-LIF kernel also their difference, the host's issue a
call), the depthwise kernel also beside the library call both ways; in
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
TRAIN_IMAGES, TRAIN_EPOCHS, NBS = 64, 2, 64   # the train_run phase: 2 epochs + 1 resumed
PROFILED_STEPS = 4         # train_run: micro-steps profiled at the end of the second epoch
#: conv/bn pairs the JAX ``fuse_conv_bn`` folds in res10 (the Conv_1 stem;
#: counted against JAX in tests/test_torch_port_fuse.py)
FOLDED_PAIRS = 1
VAL_SIZES = [(480, 640), (375, 500), (640, 640), (720, 1280)]
# H100 SXM: HBM 3.35 TB/s; dense fp32 (CUDA cores) 67 TFLOP/s, bf16 989
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# CUDA-core instructions a second (one FFMA counts two of the 67 TFLOP/s)
CUDA_CORE_IPS = 33.5e12
# instructions a multiply-add of a sum in channel order takes on CUDA cores:
# one fmaf in bf16 (a bf16 x bf16 product is exact in f32), a separate
# multiply and add in f32; two bf16 elements an elementwise instruction
MAC_INSTRUCTIONS = {torch.bfloat16: 1, torch.float32: 2}
ELEMENTWISE_LANES = {torch.bfloat16: 2, torch.float32: 1}
SMS = 132                  # streaming multiprocessors of the H100 SXM (read in main)
BENCH_ITERS, V3_ITERS = 20, 4   # timed calls a site of the two kernel benches
#: sources whose -Xptxas -v report must show no spill (the wgmma kernels and
#: the depthwise kernel, whose weights live in registers)
NO_SPILL = ("ecs_lif", "spread_gemm", "dense3", "spread_dw3", "lif_fused", "ecs_lif_v2")
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


def rows_bound(shape, bcast: bool, dtype) -> dict:
    """The bounds of the ECS-LIF function K2 and K3 compute, at ``shape``
    [T, N, H, W, C]: ``bound_ms`` and ``bound_by``, the function's (K1's
    formula: x read once, one plane when it is a broadcast, spikes written
    once, the weights; the spread's operations over T-1 steps against the
    peak for x's dtype, the 1x1 on tensor cores as the TPU kernel runs it on
    its matrix unit); ``bytes_bound_ms``, the bytes alone; and
    ``cuda_core_floor_ms``, the floor of this port's design, which keeps
    the plain version's channel-order 1x1 sum and so runs it on CUDA cores
    (MAC_INSTRUCTIONS a multiply-add, 18*C elementwise operations an
    element and step on ELEMENTWISE_LANES elements an instruction, against
    CUDA_CORE_IPS)."""
    t, n, h, w, c = shape
    nbytes = (((1 if bcast else t) + t) * n * h * w * c + 11 * c + c * c) * itemsize(dtype)
    bms, by = bound(nbytes, (t - 1) * n * h * w * (2 * c * c + 18 * c), dtype)
    ops = (t - 1) * n * h * w * (MAC_INSTRUCTIONS[dtype] * c * c
                                 + 18 * c / ELEMENTWISE_LANES[dtype])
    bytes_ms = nbytes / HBM_BPS * 1e3
    return {"bound_ms": bms, "bound_by": by, "bytes_bound_ms": bytes_ms,
            "cuda_core_floor_ms": max(bytes_ms, ops / CUDA_CORE_IPS * 1e3)}


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
    dense, and x a broadcast over T where the model hands the site one.
    Each record carries the launch's plan: its (tile x Cout slice) items, the
    grid of resident blocks and the slice."""
    agg = Agg()
    cfg = cfg_cls(time_window=T)
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
                       **k1_plan_fields(K, args[0]),
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


def k1_plan_fields(K, x) -> dict:
    plan = K.launch_plan(x)
    return {"items": plan.items, "grid": plan.grid, "slice": plan.slice,
            "slices": plan.slices}


def k3_states(FZ, args, cfg, got, reps) -> dict:
    """Where K3's state fits in shared memory, the same launch with its
    state there and in the workspace, in turns (shared, workspace, shared,
    workspace), each held equal to the wrapper's output ``got``."""
    x = args[0]
    plan = FZ.k3_launch_plan(x)
    _, _, _, w, c = x.shape
    most = -(-plan.tiles // (plan.grid // plan.slices))
    shared = FZ.k3_smem(x.element_size(), c, w, plan.slice, most, plan.sub)
    if not FZ.k3_state_fits(shared, 1):
        return {}
    calls = {state: (lambda p=plan._replace(state=state, smem=smem):
                     FZ._launch_k3(*args, cfg, False, p))
             for state, smem in (("shared", shared), ("workspace", FZ.k3_smem(
                 x.element_size(), c, w, plan.slice, 0, plan.sub)))}
    out = {"states_equal": all(torch.equal(f(), got) for f in calls.values())}
    for i in range(2):
        for state, f in calls.items():
            out.setdefault(f"{state}_state_ms", []).append(cuda_ms(f, reps))
    return out


def k3_plan_fields(FZ, x, block_rows: int = 0) -> dict:
    plan = FZ.k3_launch_plan(x, block_rows)
    return {"items": plan.items, "grid": plan.grid, "slice": plan.slice,
            "slices": plan.slices, "tile": plan.tile, "state": plan.state,
            "smem": plan.smem}


#: K1 at shapes the res10 forward does not give it: ([T, N, H, W, C], x a
#: broadcast over T): one image (the detect path) at the widest site, a
#: ragged C and pixel count with H != W, T of 1, 2 and 5, a broadcast x
K1_SHAPES = (((4, 1, 20, 20, 1024), False), ((4, 2, 7, 9, 24), False),
             ((1, 8, 20, 20, 128), False), ((2, 8, 20, 20, 128), False),
             ((5, 8, 20, 20, 128), False), ((4, 8, 40, 40, 64), True))


def phase_k1_shapes(K, cfg_cls, log) -> None:
    """K1 against its plain version at ``K1_SHAPES`` in both dtypes, with
    ``phase_k1``'s gates (``act=True`` at the ragged C in float32)."""
    for i, (shape, bcast) in enumerate(K1_SHAPES):
        cfg = cfg_cls(time_window=shape[0])
        for dtype in (torch.float32, torch.bfloat16):
            x, *params = site_inputs(shape, dtype, seed=200 + i)
            if bcast:
                x = x[:1].expand(*shape)
            got = K.ecs_lif_fused(x, *params, cfg)
            want = K.ecs_lif_reference(x, *params, cfg)
            share = float((got != want).float().mean())
            rec = {"phase": "k1_shape", "dtype": dname(dtype), "shape": list(shape),
                   "x_broadcast_over_t": bcast, **k1_plan_fields(K, x),
                   "mismatch_share": share, "bound_share": SPIKE_BOUND[dtype],
                   "finite": bool(torch.isfinite(got.float()).all())}
            if shape[-1] == 24 and dtype == torch.float32:
                rec["act_max_abs_err"] = float((K.ecs_lif_fused(x, *params, cfg, True) -
                                                K.ecs_lif_reference(x, *params, cfg, True)
                                                ).abs().max())
            emit(rec, log)
            if (share > SPIKE_BOUND[dtype] or not rec["finite"]
                    or rec.get("act_max_abs_err", 0.0) > SILU_ATOL):
                raise AssertionError(f"ecs_lif_fused disagrees at {rec}")


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
                    timed = {"wrapper_ms": cuda_ms(wrapper, reps),
                             "plan": S.plan_gemm(N, h, w, c, SMS)._asdict()}
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


def phase_spread_grads(S, log, shapes=((N, 40, 40, 256), (N, 160, 160, 64))) -> None:
    """Each spread kernel's autograd.Function against autograd through its
    plain version, float32, at ``shapes`` (by default one main-path shape
    each; ``spread_route`` picks the kernel of a shape)."""
    for shape in shapes:
        if S.spread_route(shape[-1], shape[2]) == "dw3":
            name, fn, ref, nparam = ("binary_dw3_conv", S.binary_dw3_conv,
                                     S.binary_dw3_conv_reference, 2)
        else:
            name, fn, ref, nparam = ("packed_spread", S.packed_spread,
                                     S.packed_spread_reference, 4)
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


def phase_k6(FZ, BS, cfg_cls, sites: Counter, broadcast: set, log) -> Agg:
    """The plain-LIF kernel against its plain version at every res10 site
    shape, N=8, T=4, x dense and x a broadcast over T, plus one ragged shape
    (odd element count: the scalar variant).  ``ms`` is the kernel alone:
    the device time of one call from 20 calls captured in one CUDA graph and
    replayed (``BS.graph_ms``); ``wrapper_ms`` the same calls eager, back to
    back; ``host_issue_ms`` their difference, what the host adds a call."""
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
                call = lambda: FZ.lif_fused(x, cfg)
                ms = BS.graph_ms(call)
                wrapper_ms = cuda_ms(call, BS.GRAPH_REPS)
                reps = max(3, min(10, int(4e8 // math.prod(shape))))
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
                       "wrapper_ms": wrapper_ms, "host_issue_ms": wrapper_ms - ms,
                       "plain_ms": plain_ms, "bound_ms": bms,
                       "bound_by": by, "ms_over_bound": ms / bms, "library_ms": None}
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
    hands the site one) and at three shapes the tensor-core kernel (K1)
    refuses; beside it K1 on the same inputs (another rounding of the
    spread: recorded, ceiling 2 %).  Each K2 record carries its launch's
    plan (items, grid, Cout slice), the function's bound and, beside it,
    the bytes alone and the CUDA-core floor of this design
    (``rows_bound``).  On the same inputs the shared-memory kernel (K3),
    held to the same plain output with K1's gates, timed beside K1 and K2.
    Returns the Aggs of K2 and K3."""
    agg, agg3 = Agg(), Agg()
    cfg = cfg_cls(time_window=T)
    shapes = [((T, N, h, w, c), n) for (h, w, c), n in sorted(sites.items(), reverse=True)]
    shapes += [((T, 2, 29, 6, 4), 0), ((T, 2, 20, 20, 12), 0), ((T, 2, 29, 6, 12), 0)]
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
                # the function's bound, not this version's
                bounds = rows_bound(shape, bcast, dtype)
                plan = FZ.k2_launch_plan(args[0])
                rec = {"phase": "kernel_check", "kernel": "ecs_lif_fused_rows",
                       "dtype": dname(dtype), "act": False, "shape": list(shape),
                       "sites": count, "x_broadcast_over_t": bcast,
                       "items": plan.items, "grid": plan.grid, "slice": plan.slice,
                       "slices": plan.slices, "mismatch_share": share,
                       "bound_share": SPIKE_BOUND[dtype], "max_abs_err": float(diff.max()),
                       "firing_rate": float(want.float().mean()), "ms": ms,
                       "plain_ms": plain_ms, **bounds,
                       "ms_over_bound": ms / bounds["bound_ms"],
                       "ms_over_cuda_core_floor": ms / bounds["cuda_core_floor_ms"],
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
                rec3 = {**rec, "kernel": "ecs_lif_fused_v2",
                        "mismatch_share": float((diff3 > 0).float().mean()),
                        "max_abs_err": float(diff3.max()),
                        "share_differing_from_ecs_lif_fused_rows": float((got3 != got).float().mean()),
                        "ms": cuda_ms(lambda: FZ.ecs_lif_fused_v2(*args, cfg), reps),
                        "ecs_lif_fused_rows_ms": ms, **k3_plan_fields(FZ, args[0])}
                rec3["ms_over_bound"] = rec3["ms"] / bounds["bound_ms"]
                rec3["ms_over_cuda_core_floor"] = rec3["ms"] / bounds["cuda_core_floor_ms"]
                rec3.update(k3_states(FZ, args, cfg, got3, reps))
                rec3.pop("share_differing_from_tensor_core_kernel", None)
                emit(rec3, log)
                if (rec3["mismatch_share"] > SPIKE_BOUND[dtype]
                        or not rec3.get("states_equal", True)):
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
    """K3's result does not depend on its tiling: at three site shapes, both
    dtypes, ``block_rows`` = 0 (the wrapper's plan), 7 (no divisor of H) and
    the largest whose item fits (``FZ.max_block_rows``), bit for bit; one
    more row than the largest raises, naming it."""
    cfg = cfg_cls(time_window=T)
    for dtype in (torch.bfloat16, torch.float32):
        item = itemsize(dtype)
        for i, (h, w, c) in enumerate(((40, 40, 384), (20, 20, 1024), (40, 40, 256))):
            shape = (T, N, h, w, c)
            args = site_inputs(shape, dtype, seed=400 + i)
            most = FZ.max_block_rows(shape, item)
            outs = {b: FZ.ecs_lif_fused_v2(*args, cfg, block_rows=b) for b in (0, 7, most)}
            equal = all(torch.equal(outs[0], o) for o in outs.values())
            named = None
            if most < h:
                try:
                    FZ.ecs_lif_fused_v2(*args, cfg, block_rows=most + 1)
                    named = False
                except ValueError as e:
                    named = str(e).endswith(f"fits is {most}")
            emit({"phase": "k3_tilings", "dtype": dname(dtype), "shape": list(shape),
                  "block_rows": sorted(outs), "largest_block_rows": most,
                  "plans": {b: k3_plan_fields(FZ, args[0], b) for b in sorted(outs)},
                  "bit_equal": equal, "one_more_row_raises_naming_the_largest": named},
                 log)
            if not equal or named is False or most < 7:
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


def write_val_set(root: Path, seed: int, images: int = VAL_IMAGES) -> Path:
    """A synthetic labelled split from ``seed``: ``images`` images of mixed
    native sizes (noise with flat boxes), 1-12 labelled boxes of ``NC``
    classes each, numeric file stems.  Returns the image directory."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir(parents=True)
    for i in range(images):
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
    from ecs_yolo_tpu_torch.models.utils import fuse_conv_bn
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
            with torch.inference_mode():
                # one batch's forward alone, and where it spends the device time
                rec["forward_ms"] = cuda_ms(lambda: model(x), 10)
                rec.update({"forward_" + k: v
                            for k, v in profile_step(lambda: model(x)).items()})
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
        model = make(SNNConfig(time_window=T))
        state32 = {k: v.detach().clone() for k, v in model.state_dict().items()}
        model = cast_params(model, torch.bfloat16)
        res_a, outs_a = val_pass("ecs_lif", model, "ecs_lif_fused", True,
                         ecs_ref(K.ecs_lif_reference))
        state = model.state_dict()
        del model

        # val (a) again, its float32 weights folded before the cast (--fuse);
        # recorded beside the unfused pass, whose NMS gates stay as they are
        model = make(SNNConfig(time_window=T), state32)
        folded = fuse_conv_bn(model)
        cast_params(model, torch.bfloat16)
        K.ecs_lif_fused.launches = 0
        t0 = time.perf_counter()
        res_f, outs_f = recorded_nms(val_mod, lambda: one_pass(model, "ecs_lif_fuse"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1 = K.ecs_lif_fused.launches
        rec = {"phase": "val_fuse", "folded_pairs": len(folded), "forwards": len(outs_f),
               "seen": res_f["seen"], "seen_unfused": res_a["seen"],
               "map50": res_f["map50"], "map50_unfused": res_a["map50"],
               "map": res_f["map"], "map_unfused": res_a["map"],
               "wall_seconds": wall, "images_per_s": VAL_IMAGES / wall,
               "ecs_lif_launches_per_forward": k1 / max(len(outs_f), 1),
               "nms_rows_differing_share_vs_unfused": sum(
                   int(((a - b).abs().amax(-1) > 0).sum())
                   for (a, _), (b, _) in zip(outs_f, outs_a)) / sum(
                   a.shape[0] * a.shape[1] for a, _ in outs_a)}
        emit(rec, log)
        if (res_f["seen"] != VAL_IMAGES or len(folded) != FOLDED_PAIRS
                or k1 != 24 * len(outs_f) or len(outs_f) != VAL_IMAGES // N
                or not all(math.isfinite(res_f[k]) for k in ("map50", "map", "fitness"))):
            raise AssertionError(f"val pass with --fuse failed its checks: {rec}")
        del model, state32
        model = cast_params(make(SNNConfig(time_window=T, fused_inference=True), state),
                            torch.bfloat16)
        res_b, outs_b = val_pass("ecs_lif_fused_inference", model, "ecs_lif_fused_rows",
                         True, ecs_ref(FZ.ecs_lif_rows_reference))
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


def phase_fuse(state32: dict, xb: torch.Tensor, log) -> dict:
    """Serving with the conv/bn pairs folded (``models/utils.fuse_conv_bn``)
    against the same calibrated weights unfused: res10@640, b8, T=4, in
    float32 and bfloat16 (folded in float32, then cast).  Per dtype: ms a
    forward (unfused, fused, fused, unfused, averaged), kernels and
    elementwise device ms a forward from the profiler, and the share of
    spikes that differ per site.

    The sites that read a folded pair's output directly (the stem's, through
    the first block's residual and its max-pool shortcut) are held to the
    kernel gates' bounds: there the fold's rounding meets a threshold.  A
    spike flipped there changes the convolutions behind it, and the flips
    multiply down the net, so the whole-run shares of the later sites are
    recorded, not bounded (as in ``phase_train``)."""
    from ecs_yolo_tpu_torch.models.utils import fuse_conv_bn
    from ecs_yolo_tpu_torch.models.yolo import build_model, cast_params
    from ecs_yolo_tpu_torch.nn.blocks import MemUpdate

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        models = []
        for fold in (False, True):
            m = build_model("resnet10.yaml", nc=NC)
            m.load_state_dict(state32, strict=True)
            folded = fuse_conv_bn(m) if fold else []
            models.append((cast_params(m, dtype), folded))
        (plain, _), (fused, folded) = models
        spikes = []
        for m, _ in models:
            sites = [s for s in m.modules() if isinstance(s, MemUpdate)]
            with torch.no_grad():
                _, seen = hooked_sites(sites, lambda: m(xb))
            names = {id(mod): n for n, mod in m.named_modules()}
            spikes.append([(names[id(mod)], o) for mod, _, o in seen])
        shares = [float((a != b).float().mean()) for (_, a), (_, b) in zip(*spikes)]
        # the sites fed by the folded stem: the first block's own inputs
        direct = [sh for (name, _), sh in zip(spikes[0], shares)
                  if name in ("model.1.residual_function.0", "model.1.shortcut.1")]
        del spikes
        with torch.no_grad():
            times = {"unfused": [], "fused": []}
            for name in ("unfused", "fused", "fused", "unfused"):
                m = plain if name == "unfused" else fused
                times[name].append(cuda_ms(lambda: m(xb), reps=10))
            prof = {name: profile_step(lambda: m(xb))
                    for name, m in (("unfused", plain), ("fused", fused))}
        ms = {k: sum(v) / len(v) for k, v in times.items()}
        rec = {"phase": "fuse", "dtype": dname(dtype), "batch": int(xb.shape[0]),
               "imgsz": IMGSZ, "T": T, "folded_pairs": len(folded), "folded": folded,
               "ms_per_forward_unfused": ms["unfused"], "ms_per_forward_fused": ms["fused"],
               "ms_runs": times,
               "images_per_s_unfused": xb.shape[0] / ms["unfused"] * 1e3,
               "images_per_s_fused": xb.shape[0] / ms["fused"] * 1e3,
               "direct_site_spike_flip_shares": direct,
               "site_spike_flip_shares_whole_run": shares,
               **{f"{k}_{name}": p.get(k) for name, p in prof.items()
                  for k in ("kernel_calls", "device_ms", "elementwise_device_ms",
                            "idle_share")},
               "top_kernels_fused": prof["fused"].get("top_kernels")}
        emit(rec, log)
        out[dname(dtype)] = rec
        if (len(folded) != FOLDED_PAIRS or len(shares) != 24 or len(direct) != 2
                or max(direct) > SPIKE_BOUND[dtype]):
            raise AssertionError(f"fused model ({dname(dtype)}) failed its checks: {rec}")
        del models, plain, fused
    return out


def phase_train_run(seed: int, train_src: Path, log) -> tuple:
    """The training main path: ``train.driver.train`` at full width, res10,
    nc 13, 640 px, T=4, batch 8, bf16, HYP_SCRATCH (mosaic 1.0), nbs 64
    (accumulate 8), autoanchor on, 4 loader threads, over ``TRAIN_IMAGES``
    synthetic images with the 32-image val split validated every epoch;
    ``TRAIN_EPOCHS`` epochs, then a resume from ``last.pt`` for one more.
    The launch counters are set to 0 at each epoch's start and read at its
    end (the loop) and around each val pass; the second epoch's last
    ``PROFILED_STEPS`` micro-steps are profiled.  Both runs load on 4
    threads.  ``train_src``: the train set (``write_val_set`` from ``seed +
    100``), shared with ``phase_train_opts``."""
    from torch.profiler import ProfilerActivity, profile

    from ecs_yolo_tpu_torch.snn import ecs_lif as K
    from ecs_yolo_tpu_torch.snn import fused as FZ
    from ecs_yolo_tpu_torch.snn import spread as S
    from ecs_yolo_tpu_torch.train import driver, trainer
    from ecs_yolo_tpu_torch.utils.checkpoint import load_checkpoint
    from ecs_yolo_tpu_torch.utils.general import Callbacks
    from ecs_yolo_tpu_torch.utils.loggers import LOG_KEYS

    counters = {"binary_dw3_conv": S.binary_dw3_conv, "packed_spread": S.packed_spread,
                "ecs_lif_fused": K.ecs_lif_fused, "ecs_lif_fused_rows": FZ.ecs_lif_fused_rows,
                "lif_fused": FZ.lif_fused}
    loops, vals, ema_calls, checks = [], [], [0], []
    prof = {}

    def reset():
        for f in counters.values():
            f.launches = 0

    def read():
        return {k: f.launches for k, f in counters.items()}

    def epoch_start(epoch):
        reset()
        prof["epoch"] = epoch

    def batch_end(nb):
        # the second epoch's last PROFILED_STEPS micro-steps, loader running
        if prof["epoch"] == 1 and nb == TRAIN_IMAGES // N - PROFILED_STEPS:
            torch.cuda.synchronize()
            prof["p"] = profile(activities=[ProfilerActivity.CUDA])
            prof["p"].__enter__()
            prof["t0"] = time.perf_counter()

    def epoch_end(epoch):
        loops.append(dict(epoch=epoch, launches=read()))
        if "p" in prof:
            torch.cuda.synchronize()
            wall = (time.perf_counter() - prof["t0"]) * 1e3
            prof["p"].__exit__(None, None, None)
            rows = [(e.self_device_time_total / 1e3, e.key) for e in prof["p"].key_averages()
                    if str(e.device_type).endswith("CUDA")]
            dev_ms = sum(r[0] for r in rows)
            prof["rec"] = {"epoch": 1, "micro_steps": PROFILED_STEPS,
                           "profiled_wall_ms": wall, "device_ms": dev_ms,
                           "idle_share": max(0.0, 1 - dev_ms / wall) if rows else None,
                           "top_kernels": [{"name": k[:90], "ms": v}
                                           for v, k in sorted(rows, reverse=True)[:8]]}
            del prof["p"]

    def val_end(results):
        vals.append(dict(launches=read(), seen=results["seen"]))

    real_ema = trainer.ema_update

    def counted_ema(*a, **k):
        ema_calls[0] += 1
        return real_ema(*a, **k)

    def callbacks():
        cb = Callbacks()
        cb.register_action("on_train_epoch_start", callback=epoch_start)
        cb.register_action("on_train_batch_end", callback=batch_end)
        cb.register_action("on_train_epoch_end", callback=epoch_end)
        cb.register_action("on_val_start", callback=reset)
        cb.register_action("on_val_end", callback=val_end)
        return cb

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        val_src = write_val_set(tmp / "val", seed)
        write_s = time.perf_counter() - t0
        kw = dict(cfg="resnet10.yaml", train_path=str(train_src), val_path=str(val_src),
                  nc=NC, batch_size=N, imgsz=IMGSZ, nbs=NBS, bf16=True,
                  autoanchor=True, seed=seed, loggers_include=("csv",))
        trainer.ema_update = counted_ema
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, best, hist = driver.train(epochs=TRAIN_EPOCHS, callbacks=callbacks(),
                                             save_dir=str(tmp / "run"), workers=4, **kw)
            run_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 1e9
            steps, ema_first = int(state.step), ema_calls[0]
            w = tmp / "run" / "weights"
            files = sorted(p.name for p in w.iterdir())
            header = (tmp / "run" / "results.csv").read_text().splitlines()[0].split(",")
            saved, meta = load_checkpoint(w / "last.pt")
            del state

            def restored(st):
                same = lambda a, b: torch.equal(a.detach().cpu(), b)
                o, so = st.opt_state.tensors(), saved["opt_state"]
                checks.append({
                    "step": int(st.step) == saved["step"],
                    "params": all(same(v, saved["model"][k]) for k, v in st.params.items()),
                    "buffers": all(same(v, saved["model"][k])
                                   for k, v in st.batch_stats.items()),
                    "ema": all(same(v, saved["ema"][k]) for k, v in st.ema_params.items()),
                    "opt_state": (all(same(v, so["mu"][k]) for k, v in o["mu"].items())
                                  and all(same(v, so["acc"][k]) for k, v in o["acc"].items())
                                  and same(o["count"], so["count"])
                                  and same(o["errors"], so["errors"])
                                  and o["mini_step"] == so["mini_step"]
                                  and o["nu"] is None and so["nu"] is None)})

            cb = callbacks()
            cb.register_action("on_train_start", callback=restored)
            t0 = time.perf_counter()
            state2, _, hist2 = driver.train(epochs=TRAIN_EPOCHS + 1, callbacks=cb,
                                            resume=str(w / "last.pt"), workers=4,
                                            save_dir=str(tmp / "run2"), **kw)
            resume_s = time.perf_counter() - t0
            steps2 = int(state2.step)
            del state2
        finally:
            trainer.ema_update = real_ema

    hists = hist + hist2
    per_epoch = []
    for h, loop, v in zip(hists, loops, vals):
        n_img = h["micro_steps"] * N
        per_epoch.append({
            "epoch": h["epoch"], "epoch_s": h["epoch_s"], "train_loop_s": h["train_s"],
            "val_s": h["val_s"], "checkpoint_s": h["ckpt_s"],
            "workers": 4,
            "loader_wait_s": h["wait_s"], "loader_wait_share": h["wait_s"] / h["train_s"],
            "step_issue_s": h["step_s"], "step_issue_ms_per_micro_step":
            h["step_s"] / h["micro_steps"] * 1e3,
            "train_images_per_s": n_img / h["train_s"], "micro_steps": h["micro_steps"],
            "applies": h["applies"], "applied": h["applied"], "mloss": h["mloss"],
            "loss_finite": h["loss_finite"], "map50": h["map50"], "fitness": h["fitness"],
            "seen": h["seen"], "profiled_last_micro_steps": PROFILED_STEPS
            if h["epoch"] == 1 else 0, "loop_launches": loop["launches"],
            "loop_launches_per_micro_step": {k: c / h["micro_steps"]
                                             for k, c in loop["launches"].items()},
            "val_launches": v["launches"]})
    applies = sum(h["applies"] for h in hists)
    rec = {"phase": "train_run", "cfg": "resnet10.yaml", "nc": NC, "imgsz": IMGSZ,
           "T": T, "batch": N, "nbs": NBS, "accumulate": NBS // N, "dtype": "bfloat16",
           "train_images": TRAIN_IMAGES, "val_images": VAL_IMAGES,
           "write_val_set_s": write_s, "run_s": run_s, "resume_run_s": resume_s,
           "peak_memory_gb": peak, "micro_steps": steps2, "applies": applies,
           "ema_updates": ema_calls[0], "best_fitness": best, "files": files,
           "results_csv_header": header, "resume_checks": checks,
           "epochs": per_epoch, "profiled_loop": prof.get("rec")}
    emit(rec, log)
    per_forward = [v["launches"]["ecs_lif_fused"] / math.ceil(VAL_IMAGES / N) for v in vals]
    ok = (len(hists) == TRAIN_EPOCHS + 1 and [h["epoch"] for h in hist2] == [TRAIN_EPOCHS]
          and all(h["loss_finite"] for h in hists)
          and applies == steps2 // (NBS // N) and steps == TRAIN_EPOCHS * TRAIN_IMAGES // N
          and ema_first == steps // (NBS // N) and ema_calls[0] == applies
          and all(e["loop_launches_per_micro_step"] == {
              "binary_dw3_conv": 57, "packed_spread": 15, "ecs_lif_fused": 0,
              "ecs_lif_fused_rows": 0, "lif_fused": 0} for e in per_epoch)
          and all(p == 24 for p in per_forward)
          and all(v["launches"]["binary_dw3_conv"] == v["launches"]["packed_spread"] == 0
                  for v in vals)
          and all(h["seen"] == VAL_IMAGES for h in hists)
          and {"best.pt", "last.pt"} <= set(files)
          and set(LOG_KEYS) <= set(header) and len(checks) == 1 and all(checks[0].values()))
    if not ok:
        raise AssertionError(f"train_run failed its checks: {rec}")
    return {"binary_dw3_conv": sum(e["loop_launches"]["binary_dw3_conv"] for e in per_epoch),
            "packed_spread": sum(e["loop_launches"]["packed_spread"] for e in per_epoch),
            "ecs_lif_fused": sum(v["launches"]["ecs_lif_fused"] for v in vals)}, rec


def host_batches(k: int, seed: int):
    """``k`` host batches as the loader yields them: uint8 images
    [N,640,640,3] (``train_batch``'s, scaled), targets [N,M,5], masks."""
    out = []
    for j in range(k):
        ims, tg, mk = train_batch(seed + j)
        out.append(((ims * 255).round().to(torch.uint8).cpu().numpy(),
                    tg.cpu().numpy(), mk.cpu().numpy()))
    return out


def max_diff(a: dict, b: dict) -> float:
    """Largest elementwise difference between two dicts of tensors."""
    return max(float((a[k].double() - b[k].double()).abs().max()) if a[k].numel() else 0.0
               for k in a)


def phase_train_opts(seed: int, train_src: Path, run_rec: dict, log) -> dict:
    """The options of the training main path at res10@640, b8, bf16, T=4
    (``HYP_SCRATCH``; cuDNN in its deterministic mode, so that two runs of
    the same step can be held to each other):

    * ``remat`` / ``remat_neuron``: one step each from the same state and
      batch as a plain step (an SGD state past its warm-up, so that every
      group moves), after a first plain step kept apart (``warmup``), and
      the plain step once more for the run-to-run floor;
      parameters, BN statistics and EMA held to the plain step's (equal,
      or within twice the floor if the plain step does not repeat itself
      bit for bit), the BN statistics exactly (the forward repeats itself);
      peak memory, step time and launches of each (a recompute launches the
      spread kernels again: those counts include it);
    * ``device_augment``: a batch augmented on the card against the same
      functions on the CPU given the same draws, on the fast route (b8) and
      the generic one (b2), and its time a batch; then one epoch of
      ``train_run``'s train set through ``train.driver.train(device_augment=
      True)`` (4 loader threads, no val, the YAML's anchors, which
      ``train_run``'s autoanchor keeps) beside ``train_run``'s epochs with the
      host mosaic;
    * ``steps_per_call = 4``: ``train.driver.dispatch`` of 4 batches (with
      the device augmentation) under ``torch.cuda.set_sync_debug_mode("error")``
      from the same state as 4 single dispatches (run twice, for the floor),
      state equal; host and wall time a step both ways;
    * Lion with ``sr``: three steps of ``make_train_step(sr=...)`` on the
      card, every step's gradients (before the term) taken to the CPU, where
      the same term and Lion update run on CPU copies of the state.
    """
    from ecs_yolo_tpu_torch.data import device_augment as DA
    from ecs_yolo_tpu_torch.data.hyps import HYP_SCRATCH
    from ecs_yolo_tpu_torch.models.yolo import build_model
    from ecs_yolo_tpu_torch.nn.blocks import MemUpdate
    from ecs_yolo_tpu_torch.snn import spread as S
    from ecs_yolo_tpu_torch.train import driver, trainer
    from ecs_yolo_tpu_torch.train.optim import build_optimizer
    from ecs_yolo_tpu_torch.train.sparsity import sparsity_rate
    from ecs_yolo_tpu_torch.train.trainer import create_train_state, make_train_step

    hyp = dict(HYP_SCRATCH)
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    counters = {"binary_dw3_conv": S.binary_dw3_conv, "packed_spread": S.packed_spread}
    model = build_model("resnet10.yaml", nc=NC, generator=torch.Generator().manual_seed(5))
    sites = [m for m in model.modules() if isinstance(m, MemUpdate)]
    sd0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt_kw = dict(lr0=hyp["lr0"], lrf=hyp["lrf"], momentum=hyp["momentum"],
                  weight_decay=hyp["weight_decay"], epochs=300, steps_per_epoch=1000,
                  warmup_epochs=hyp["warmup_epochs"], warmup_momentum=hyp["warmup_momentum"],
                  warmup_bias_lr=hyp["warmup_bias_lr"])
    PAST_WARMUP = 4000          # applied steps: the schedules past their warm-up

    def fresh(tx):
        model.load_state_dict(sd0)
        state = create_train_state(model, tx)
        state.opt_state.count.fill_(PAST_WARMUP)
        return state

    def snapshot(state) -> dict:
        return {**{f"sd.{k}": v.detach().clone() for k, v in model.state_dict().items()},
                **{f"ema.{k}": v.detach().clone() for k, v in state.ema_params.items()}}

    def configure(remat: bool, remat_neuron: bool) -> None:
        model.remat = remat
        for m in sites:
            m.snn = m.snn.replace(remat_neuron=remat_neuron)

    rec = {"phase": "train_opts", "cfg": "resnet10.yaml", "batch": N, "imgsz": IMGSZ,
           "T": T, "dtype": "bfloat16", "cudnn_deterministic": True}
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # --- remat / remat_neuron against the plain step -----------------------
        batch = train_batch(seed=7)
        tx = build_optimizer(dict(model.named_parameters()), name="SGD", **opt_kw)
        runs, snaps = {}, {}
        # a first plain step (cuDNN's deterministic plans, first calls) is
        # kept apart as "warmup"
        for name, remat, rn in (("warmup", False, False), ("plain", False, False),
                                ("remat", True, False), ("remat_neuron", False, True),
                                ("plain_again", False, False)):
            configure(remat, rn)
            state = fresh(tx)
            step = make_train_step(model, tx, hyp, compute_dtype=bf16)
            for f in counters.values():
                f.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            t0 = time.perf_counter()
            state, metrics = step(state, *batch)
            host_ms = (time.perf_counter() - t0) * 1e3
            e1.record()
            torch.cuda.synchronize()
            runs[name] = {"step_ms": e0.elapsed_time(e1), "host_ms": host_ms,
                          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                          "loss": float(metrics["loss"]),
                          "launches": {k: f.launches for k, f in counters.items()}}
            snaps[name] = snapshot(state)
            del state, step, metrics
        configure(False, False)
        start = {f"sd.{k}": v for k, v in sd0.items()}
        stats = [k for k in snaps["plain"] if k.endswith(("running_mean", "running_var"))]
        floor = max_diff(snaps["plain_again"], snaps["plain"])
        for name in ("remat", "remat_neuron"):
            runs[name]["max_abs_diff_to_plain"] = max_diff(snaps[name], snaps["plain"])
            runs[name]["bn_stats_equal_to_plain"] = all(
                torch.equal(snaps[name][k], snaps["plain"][k]) for k in stats)
        runs["plain_again"]["max_abs_diff_to_plain"] = floor
        runs["warmup"]["max_abs_diff_to_plain"] = max_diff(snaps["warmup"], snaps["plain"])
        moved = all(not torch.equal(snaps["plain"][k], start[k]) for k in stats)
        rec["remat"] = runs
        rec["remat_bound"] = 2 * floor
        rec["bn_stats_moved"] = moved
        del snaps

        # --- device_augment: the card against the CPU on the same draws ---------
        hb = host_batches(4, seed=11)
        gen = torch.Generator(device=dev)
        u8, tg, mk = (torch.from_numpy(a).to(dev) for a in hb[0])
        aug = []
        for route, h, b in (("fast", hyp, N), ("generic", dict(hyp, degrees=5.0, shear=2.0), 2)):
            gen.manual_seed(seed + 123)
            im = u8[:b].to(torch.float32) / 255.0
            draws = DA.draw_augment(b, (IMGSZ, IMGSZ), gen, h, dev)
            got = DA.apply_augment(im, tg[:b], mk[:b], draws, h)
            want = DA.apply_augment(im.cpu(), tg[:b].cpu(), mk[:b].cpu(),
                                    {k: v.cpu() for k, v in draws.items()}, h)
            err = (got[0].cpu() - want[0]).abs()
            both = got[2].cpu() & want[2]
            aug.append({
                "route": route, "batch": b, "rows": int(got[1].shape[1]),
                "kept_rows": int(want[2].sum()),
                "pixel_max_abs_err": float(err.max()),
                "pixel_share_over_1e-4": float((err > 1e-4).float().mean()),
                "mask_mismatch_share": float((got[2].cpu() != want[2]).float().mean()),
                "label_max_abs_err": float((got[1].cpu() - want[1])[both].abs().max())
                if bool(both.any()) else 0.0,
                "ms_per_batch": cuda_ms(lambda: DA.augment_batch(im, tg[:b], mk[:b], gen, h),
                                        reps=10)})
        rec["device_augment_check"] = aug
        del u8, tg, mk, got, want, err

        # --- steps_per_call = 4: one sync-free chunk against 4 single steps -----
        tx = build_optimizer(dict(model.named_parameters()), name="SGD", **opt_kw)
        step = make_train_step(model, tx, hyp, compute_dtype=bf16)

        def augment(n, im, tg, mk):
            gen.manual_seed(driver._augment_seed(seed, 0, n))
            return DA.augment_batch(im.to(torch.float32) / 255.0, tg, mk, gen, hyp)

        state = fresh(tx)
        state, _ = driver.dispatch(state, step, hb[:1], dev, augment)  # warm caches
        chunk = {}
        for name in ("chunk", "single", "single_again"):
            state = fresh(tx)
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            t0 = time.perf_counter()
            if name == "chunk":
                torch.cuda.set_sync_debug_mode("error")
                try:
                    state, ms = driver.dispatch(state, step, hb, dev, augment)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            else:
                for j in range(len(hb)):
                    state, ms = driver.dispatch(state, step, hb[j:j + 1], dev, augment,
                                                first=j)
            host_ms = (time.perf_counter() - t0) * 1e3
            e1.record()
            torch.cuda.synchronize()
            chunk[name] = {"host_ms_per_step": host_ms / len(hb),
                           "wall_ms_per_step": e0.elapsed_time(e1) / len(hb),
                           "snap": snapshot(state), "step": int(state.step)}
        spc_floor = max_diff(chunk["single_again"]["snap"], chunk["single"]["snap"])
        spc_diff = max_diff(chunk["chunk"]["snap"], chunk["single"]["snap"])
        rec["steps_per_call"] = {
            "k": len(hb), "sync_debug_mode": "error", "max_abs_diff_to_single": spc_diff,
            "single_floor": spc_floor,
            **{name: {k: v for k, v in c.items() if k != "snap"} for name, c in chunk.items()}}
        del chunk, state

        # --- Lion with sr: the card against the CPU's arithmetic ----------------
        sr, total = 1e-3, 30
        lion_kw = dict(opt_kw, lr0=1e-4)
        tx = build_optimizer(dict(model.named_parameters()), name="Lion", **lion_kw)
        state = fresh(tx)
        cpu_p = {k: v.detach().cpu().clone() for k, v in state.params.items()}
        ctx = build_optimizer(cpu_p, name="Lion", **lion_kw)
        cst = ctx.init(cpu_p)
        cst.count.fill_(PAST_WARMUP)
        seen = []
        real_term = trainer.add_l1_subgradient

        def spy(grads, params, srtmp, sr_):
            seen.append(({k: g.detach().cpu() for k, g in grads.items()}, srtmp.cpu()))
            return real_term(grads, params, srtmp, sr_)

        step = make_train_step(model, tx, hyp, compute_dtype=bf16, sr=sr,
                               sr_total_steps=total)
        trainer.add_l1_subgradient = spy
        losses = []
        try:
            for j in range(3):
                state, m = step(state, *train_batch(seed=20 + j))
                losses.append(float(m["loss"]))
        finally:
            trainer.add_l1_subgradient = real_term
        srtmp_ok = True
        for j, (g, srtmp) in enumerate(seen):
            want_srtmp = sparsity_rate(sr, torch.tensor(j, dtype=torch.float32) / total)
            srtmp_ok &= bool(torch.equal(srtmp, want_srtmp))
            ctx.update(cpu_p, real_term(g, cpu_p, want_srtmp, sr), cst)
        err = {k: (state.params[k].detach().cpu() - v).abs() for k, v in cpu_p.items()}
        n_el = sum(e.numel() for e in err.values())
        rec["lion_sr"] = {
            "steps": len(seen), "sr": sr, "sr_total_steps": total, "lr0": lion_kw["lr0"],
            "losses": losses, "srtmp_equal": srtmp_ok,
            "params_finite": all(bool(torch.isfinite(v).all()) for v in state.params.values()),
            "max_abs_err": max(float(e.max()) for e in err.values()),
            "share_over_1e-6": sum(int((e > 1e-6).sum()) for e in err.values()) / n_el,
            "applied": int(state.opt_state.count) - PAST_WARMUP}
        del state, seen, err
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
        configure(False, False)
    del model

    # --- one train_run-sized epoch with the device augmentation -------------------
    reset = lambda: [setattr(f, "launches", 0) for f in counters.values()]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        reset()
        torch.cuda.reset_peak_memory_stats()
        _, _, hist = driver.train(
            cfg="resnet10.yaml", train_path=str(train_src), val_path=None, nc=NC,
            batch_size=N, imgsz=IMGSZ, nbs=NBS, bf16=True, autoanchor=False, seed=seed,
            loggers_include=("csv",), epochs=1, workers=4, device_augment=True,
            save_dir=str(tmp / "run"))
        launches = {k: f.launches for k, f in counters.items()}
    h = hist[0]
    rec["device_augment_epoch"] = {
        "micro_steps": h["micro_steps"], "loss_finite": h["loss_finite"],
        "mloss": h["mloss"], "train_loop_s": h["train_s"],
        "train_images_per_s": h["micro_steps"] * N / h["train_s"],
        "loader_wait_share": h["wait_s"] / h["train_s"],
        "step_issue_ms_per_micro_step": h["step_s"] / h["micro_steps"] * 1e3,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches_per_micro_step": {k: c / max(h["micro_steps"], 1)
                                    for k, c in launches.items()},
        "host_mosaic_epochs": [{k: e[k] for k in (
            "epoch", "train_images_per_s", "loader_wait_share",
            "step_issue_ms_per_micro_step")} for e in run_rec["epochs"]]}
    emit(rec, log)

    r, spc, ls = rec["remat"], rec["steps_per_call"], rec["lion_sr"]
    exact = rec["remat_bound"] == 0.0
    ok = (all(math.isfinite(v["loss"]) for v in r.values()) and rec["bn_stats_moved"]
          and all(r[n]["bn_stats_equal_to_plain"] for n in ("remat", "remat_neuron"))
          and all(r[n]["max_abs_diff_to_plain"] <= rec["remat_bound"]
                  for n in ("remat", "remat_neuron"))
          and r["plain"]["launches"] == {"binary_dw3_conv": 57, "packed_spread": 15}
          and all(r[n]["launches"]["binary_dw3_conv"] >= 57
                  and r[n]["launches"]["packed_spread"] >= 15 for n in ("remat", "remat_neuron")))
    ok &= all(a["mask_mismatch_share"] <= 1e-2 and a["pixel_share_over_1e-4"] <= 1e-4
              and a["pixel_max_abs_err"] <= 0.1 and a["label_max_abs_err"] <= 1e-3
              and a["kept_rows"] > 0 for a in rec["device_augment_check"])
    ok &= (spc["chunk"]["step"] == spc["single"]["step"] == 4
           and (spc["max_abs_diff_to_single"] == 0.0 if spc["single_floor"] == 0.0
                else spc["max_abs_diff_to_single"] <= 2 * spc["single_floor"]))
    ok &= (ls["steps"] == 3 and ls["applied"] == 3 and ls["srtmp_equal"] and ls["params_finite"]
           and all(math.isfinite(v) for v in ls["losses"]) and ls["share_over_1e-6"] <= 1e-4
           and ls["max_abs_err"] <= 2 * 3 * ls["lr0"] + 1e-5)
    e = rec["device_augment_epoch"]
    ok &= (e["micro_steps"] == TRAIN_IMAGES // N and e["loss_finite"]
           and e["launches_per_micro_step"] == {"binary_dw3_conv": 57, "packed_spread": 15})
    if not ok:
        raise AssertionError(f"train_opts failed its checks (remat exact: {exact}): {rec}")
    return {k: {n: r[n]["launches"][k] for n in ("plain", "remat", "remat_neuron")}
            for k in counters}


#: the anchor-free YAMLs of the ``heads`` phase, and per YAML its neuron
#: sites and the launches of the fused spread product and of the depthwise
#: kernel in a T=4 training forward (tests/test_torch_port_spread.py holds
#: this table against the models' hooks on the CPU)
HEAD_CFG = "res10v8.yaml"
HEAD_OTHERS = ("res10v10.yaml", "res10-dual.yaml", "res10-triple.yaml",
               "res10-dualplain.yaml")
HEAD_SITES = {"res10v8.yaml": (44, 21, 111), "res10v10.yaml": (60, 27, 153),
              "res10-dual.yaml": (44, 27, 105), "res10-triple.yaml": (52, 33, 123),
              "res10-dualplain.yaml": (40, 15, 57)}
HEAD_OTHER_BATCH = 2       # the four other YAMLs: one detect batch, one step at b2
HEAD_STEPS = 3             # timed bf16 steps of res10v8
HEAD_VAL_IMAGES = 16
#: the float32 step of a head model: the kernel run against a plain rerun in
#: which every site hands on the kernel run's output (teacher forcing), so
#: that one spike flipped near a threshold does not cascade through the
#: layers behind it and move the TAL assignment; each parameter's gradient
#: is held to its plain value, relative.  Read on res10v8 b8: 3.9e-4 (one
#: spike in 6.5e6 flips inside a plain site, where forcing cannot reach),
#: the planted fault below 9.9e2 (PERF.md, Findings)
HEAD_PARAM_GRAD_RTOL = 1e-2
#: the planted fault that gate must see: K4 writing every PLANT_STRIDE-th
#: element of the int8 spike plane its backward reads flipped
PLANT_STRIDE = 997


def captured_sites(sites, run):
    """``run()`` with every site's input and output kept (raw)."""
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append((m, i[0].detach(),
                                                                  o.detach())))
             for m in sites]
    try:
        out = run()
    finally:
        for h in hooks:
            h.remove()
    return out, seen


def silu_err(got, want, xin) -> float:
    """A SiLU site's largest error: float32 in absolute value, bfloat16 in
    ulps of the larger of the plain output and the site's input (the
    membrane sums the input: where it cancels to near zero, the input's
    ulp is the rounding the sum carries)."""
    diff = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        return float(diff.max())
    scale = torch.maximum(want.float().abs(), xin.float().abs()).clamp(min=1e-30)
    return float((diff / torch.exp2(torch.floor(torch.log2(scale)) - 7)).max())


def site_errors(seen, plain_kernels) -> tuple:
    """Per site, its kernel output against the plain version of its kernel
    on the same input: for a spiking site the share of spikes that differ
    (held to ``SPIKE_BOUND``), for a SiLU site (``act``) ``silu_err`` (held
    to ``SILU_ATOL`` in float32, ``LIF_SILU_ULPS_BF16`` in bfloat16, every
    element).  Returns (spike shares, SiLU errors)."""
    shares, silu = [], []
    with plain_kernels(), torch.no_grad():
        for m, xin, out in seen:
            want = m(xin)
            if m.act:
                silu.append(silu_err(out, want, xin))
            else:
                shares.append(float((out != want).float().mean()))
    return shares, silu


def sites_ok(shares, silu, dtype) -> bool:
    gate = SILU_ATOL if dtype == torch.float32 else LIF_SILU_ULPS_BF16
    return max(shares, default=0.0) <= SPIKE_BOUND[dtype] and max(silu, default=0.0) <= gate


def head_model(cfg: str, seed: int, xb: torch.Tensor, bn_cls):
    """``cfg`` at full width, nc 13, random weights from ``seed``, its BN
    statistics calibrated on ``xb`` in float32 (see ``calibrate_bn``)."""
    from ecs_yolo_tpu_torch.models.yolo import build_model

    model = build_model(cfg, nc=NC, generator=torch.Generator().manual_seed(seed))
    calibrate_bn(model, xb, bn_cls)
    return model


def f32_step_check(model, batch, sites, plain_kernels, hyp, plant=False) -> tuple:
    """One float32 training step's loss and gradients on the kernel route
    against the same step under ``plain_kernels()`` from the same state, each
    site of the plain rerun handing on the kernel run's output (its gradient
    still flows through the site's own plain forward); each site's output
    against its plain version on its real input.  With ``plant`` the kernel
    step is run again with K4 writing a wrong int8 plane (``PLANT_STRIDE``),
    which leaves the forward as it is and must move a gradient past
    ``HEAD_PARAM_GRAD_RTOL``."""
    from ecs_yolo_tpu_torch.snn import spread as S
    from ecs_yolo_tpu_torch.train.optim import build_optimizer
    from ecs_yolo_tpu_torch.train.trainer import create_train_state, make_grad_fn

    tx = build_optimizer(dict(model.named_parameters()), name="SGD", lr0=hyp["lr0"],
                         lrf=hyp["lrf"], momentum=hyp["momentum"],
                         weight_decay=hyp["weight_decay"], epochs=300, steps_per_epoch=1000,
                         warmup_epochs=hyp["warmup_epochs"],
                         warmup_momentum=hyp["warmup_momentum"],
                         warmup_bias_lr=hyp["warmup_bias_lr"], warmup_floor=100.0)
    state = create_train_state(model, tx)
    stats0 = {k: v.clone() for k, v in state.batch_stats.items()}
    grad_fn = make_grad_fn(model, hyp)

    def step():
        for k, v in stats0.items():
            state.batch_stats[k].copy_(v)
        return grad_fn(state, *batch)

    (loss_k, items_k, grads_k), seen = captured_sites(sites, step)
    shares, silu = site_errors(seen, plain_kernels)
    kept = iter(seen)
    input_diff = []

    def force(m, i, o):
        _, xin, out = next(kept)
        input_diff.append(float((i[0].detach() - xin).abs().max()))
        return out + (o - o.detach())

    hooks = [m.register_forward_hook(force) for m in sites]
    try:
        with plain_kernels():
            loss_p, items_p, grads_p = step()
    finally:
        for h in hooks:
            h.remove()
    del seen, kept

    def rel(grads):
        return {k: float((grads[k] - grads_p[k]).norm() / grads_p[k].norm().clamp(min=1e-30))
                for k in grads}

    err = rel(grads_k)
    rec = {"loss_kernel": float(loss_k), "loss_plain": float(loss_p),
           "loss_rel_err": abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)),
           "items": items_k.tolist(), "items_plain": items_p.tolist(),
           "sites_checked": len(shares) + len(silu),
           "worst_site_mismatch_share": max(shares, default=0.0),
           "worst_site_silu_err": max(silu, default=0.0),
           "forced_sites": len(input_diff),
           "site_input_max_abs_diff_forced": max(input_diff, default=0.0),
           "grads_finite": all(bool(torch.isfinite(g).all()) for g in grads_k.values()),
           "param_grad_rel_err_max": max(err.values()),
           "worst_param_grad_rel_err": sorted(err.items(), key=lambda kv: -kv[1])[:6],
           "param_grad_rtol": HEAD_PARAM_GRAD_RTOL}
    ok = (len(shares) + len(silu) == len(input_diff) == len(sites)
          and sites_ok(shares, silu, torch.float32) and rec["grads_finite"]
          and rec["loss_rel_err"] <= HEAD_PARAM_GRAD_RTOL
          and rec["param_grad_rel_err_max"] <= HEAD_PARAM_GRAD_RTOL)
    if plant:
        real = S._dw3_kernel

        def planted(s, k, b):
            out, s8 = real(s, k, b)
            flat = s8.view(-1)[::PLANT_STRIDE]
            flat.copy_(1 - flat)
            return out, s8

        S._dw3_kernel = planted
        try:
            loss_b, _, grads_b = step()
        finally:
            S._dw3_kernel = real
        bad = rel(grads_b)
        rec["planted"] = {"fault": f"K4's int8 plane, one element in {PLANT_STRIDE} flipped",
                          "loss_equal": float(loss_b) == float(loss_k),
                          "param_grad_rel_err_max": max(bad.values()),
                          "params_over_rtol": sum(v > HEAD_PARAM_GRAD_RTOL
                                                  for v in bad.values()),
                          "worst_param_grad_rel_err": sorted(
                              bad.items(), key=lambda kv: -kv[1])[:6]}
        ok &= (rec["planted"]["loss_equal"]
               and rec["planted"]["param_grad_rel_err_max"] > HEAD_PARAM_GRAD_RTOL)
    rec["ok"] = ok
    return rec, tx, state


def phase_heads(seed: int, train_src: Path, val_root: Path, log) -> dict:
    """The anchor-free heads' main paths on the card, bf16, T=4, nc 13, 640 px.

    ``res10v8`` (ASFF_DDetect, the TAL loss) at b8: a forward with every
    neuron site held to the plain version of its kernel on its real input;
    ``detect.run`` over the synthetic images (K1 launches counted); a timed
    and profiled b8 forward, with K1's device time at the head's own sites;
    one float32 train step on the kernel route against the same step under
    ``plain_kernels()`` (``f32_step_check``); ``HEAD_STEPS`` bf16 steps of
    ``make_train_step`` timed (K4 / K5 launches a step, peak memory, the TAL
    assigner's device time a step), and one more that must make no host
    sync; one epoch of ``train.driver.train`` over the 64-image
    train set with its val pass on the EMA copy, whose NMS output is held to
    the same pass under ``plain_kernels()``.  Each of the four other
    anchor-free YAMLs at b2: a detect batch with every site checked,
    ``detect.run``, one float32 step against its plain rerun; ``res10v10``
    also one ``val.run``.  The K1 sites the heads add (C = 8 among them) and
    the K4 / K5 training sites (K5 at 40x40x64 and 20x20x64) get their own
    kernel_check records."""
    from ecs_yolo_tpu_torch import detect as detect_mod
    from ecs_yolo_tpu_torch import val as val_mod
    from ecs_yolo_tpu_torch.config import SNNConfig
    from ecs_yolo_tpu_torch.data.hyps import HYP_SCRATCH
    from ecs_yolo_tpu_torch.data.loaders import LoadImages
    from ecs_yolo_tpu_torch.models.yolo import cast_params, head_predictions
    from ecs_yolo_tpu_torch.nn.blocks import MemUpdate, _BN
    from ecs_yolo_tpu_torch.scripts import bench_spread as BS
    from ecs_yolo_tpu_torch.snn import ecs_lif as K
    from ecs_yolo_tpu_torch.snn import fused as FZ
    from ecs_yolo_tpu_torch.snn import spread as S
    from ecs_yolo_tpu_torch.snn.route import plain_kernels
    from ecs_yolo_tpu_torch.train import driver, loss_tal
    from ecs_yolo_tpu_torch.train.trainer import make_train_step
    from ecs_yolo_tpu_torch.utils.general import Callbacks

    t_phase = time.perf_counter()
    hyp = dict(HYP_SCRATCH)
    counters = {"ecs_lif_fused": K.ecs_lif_fused, "ecs_lif_fused_rows": FZ.ecs_lif_fused_rows,
                "lif_fused": FZ.lif_fused, "binary_dw3_conv": S.binary_dw3_conv,
                "packed_spread": S.packed_spread}

    def reset():
        for f in counters.values():
            f.launches = 0

    def read():
        return {k: f.launches for k, f in counters.items()}

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_images(Path(tmp))
        ims = [im for _, im, _ in LoadImages(tmp, IMGSZ)]
        xb = torch.from_numpy(np.concatenate(ims * 2)).cuda().float() / 255.0
        batch = train_batch(seed=3)

        # --- res10v8: serving ---------------------------------------------------
        model = head_model(HEAD_CFG, seed, xb, _BN)
        sites = [m for m in model.modules() if isinstance(m, MemUpdate)]
        head_sites = set(m for m in model.model[-1].modules() if isinstance(m, MemUpdate))
        n_sites, gemm_step, dw3_step = HEAD_SITES[HEAD_CFG]
        state32 = {k: v.detach().clone() for k, v in model.state_dict().items()}
        cast_params(model, torch.bfloat16)
        reset()
        with torch.no_grad():
            _, seen = captured_sites(sites, lambda: model(xb))
        fwd_launches = read()
        shares, silu = site_errors(seen, plain_kernels)
        head_inputs = [(m, xin) for m, xin, _ in seen if m in head_sites]
        shapes = Counter(tuple(xin.shape[2:]) for _, xin, _ in seen)
        del seen
        rec = {"phase": "heads_sites", "cfg": HEAD_CFG, "batch": N, "dtype": "bfloat16",
               "sites": len(shares) + len(silu), "head_sites": len(head_inputs),
               "shapes": [[list(k), v] for k, v in sorted(shapes.items(), reverse=True)],
               "launches_per_forward": fwd_launches, "worst_site_mismatch_share":
               max(shares), "site_mismatch_shares": shares}
        emit(rec, log)
        if (len(shares) + len(silu) != n_sites or not sites_ok(shares, silu, torch.bfloat16)
                or fwd_launches["ecs_lif_fused"] != n_sites
                or sum(fwd_launches.values()) != n_sites):
            raise AssertionError(f"res10v8: a site disagrees or left K1: {rec}")

        reset()
        t0 = time.perf_counter()
        results = detect_mod.run(model, tmp, imgsz=IMGSZ)
        torch.cuda.synchronize()
        detect_s = time.perf_counter() - t0
        dets = [d for _, d in results]
        rec = {"phase": "heads_detect", "cfg": HEAD_CFG, "images": len(results),
               "seconds": detect_s, "detections": [int(len(d)) for d in dets],
               "finite": all(bool(np.isfinite(d).all()) for d in dets), "launches": read()}
        emit(rec, log)
        out["detect_launches"] = rec["launches"]["ecs_lif_fused"]
        if (not rec["finite"] or len(results) != 4
                or rec["launches"]["ecs_lif_fused"] != n_sites * 4):
            raise AssertionError(f"res10v8 detect.run failed its checks: {rec}")

        with torch.no_grad():
            ms = cuda_ms(lambda: model(xb), reps=10)
            prof = profile_step(lambda: model(xb))
            k1_head = [(m, xin, cuda_ms(lambda: K.ecs_lif_fused(
                xin, *m.spread_params(), m.snn, m.act), reps=5)) for m, xin in head_inputs]
        k1_rows = Counter()
        for m, xin, t in k1_head:
            k1_rows[tuple(xin.shape[2:])] += t
        rec = {"phase": "heads_throughput", "cfg": HEAD_CFG, "batch": N, "imgsz": IMGSZ,
               "T": T, "dtype": "bfloat16", "ms_per_forward": ms,
               "images_per_s": N / ms * 1e3, "k1_launches_per_forward":
               fwd_launches["ecs_lif_fused"], "k2_launches_per_forward":
               fwd_launches["ecs_lif_fused_rows"],
               "k1_head_sites": len(k1_head), "k1_head_sites_ms": sum(t for *_, t in k1_head),
               "k1_head_ms_by_shape": [[list(k), v] for k, v in sorted(k1_rows.items())],
               **prof}
        emit(rec, log)
        out["forward_ms"] = ms
        del head_inputs, k1_head

        # --- the K1 / K4 / K5 shapes the heads add, their own records -----------
        res10 = {(320, 320, 64), (160, 160, 64), (80, 80, 128), (40, 40, 384),
                 (40, 40, 256), (20, 20, 1024), (20, 20, 512), (20, 20, 256),
                 (20, 20, 128)}
        new = Counter({k: v for k, v in shapes.items() if k not in res10})
        new[(40, 40, 512)] = 2             # res10-triple's and res10-dualplain's
        phase_k1(K, SNNConfig, new, set(), log)
        phase_spread(S, BS, plain_kernels, new, log)
        phase_spread_grads(S, log, [(N,) + k for k in sorted(new)])

        # --- res10v8: training --------------------------------------------------
        for p in model.parameters():
            p.data = p.data.float()
        model.load_state_dict(state32)
        rec, tx, state = f32_step_check(model, batch, sites, plain_kernels, hyp, plant=True)
        emit({"phase": "heads_train_step_fp32", "cfg": HEAD_CFG, "batch": N, **rec}, log)
        if not rec["ok"]:
            raise AssertionError(f"res10v8 float32 step: kernel route disagrees: {rec}")

        step = make_train_step(model, tx, hyp, compute_dtype=torch.bfloat16)
        state, _ = step(state, *batch)                 # first call, kept apart
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(HEAD_STEPS + 1)]
        losses = []
        events[0].record()
        for i in range(HEAD_STEPS):
            state, metrics = step(state, *batch)
            events[i + 1].record()
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        launches = read()
        step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(HEAD_STEPS)]
        # one more step must make no host sync (the TAL assigner and losses
        # keep static shapes): a sync raises here and fails the phase
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, _ = step(state, *batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        prof = profile_step(lambda: step(state, *batch))
        # the assigner's device time: the step's own calls recorded, replayed
        calls = []
        real = loss_tal.task_aligned_assigner
        loss_tal.task_aligned_assigner = lambda *a, **k: (calls.append((a, k)), real(*a, **k))[1]
        try:
            step(state, *batch)
        finally:
            loss_tal.task_aligned_assigner = real
        assigner_ms = sum(cuda_ms(lambda: real(*a, **k), reps=5) for a, k in calls)
        rec = {"phase": "heads_train_step", "cfg": HEAD_CFG, "batch": N, "imgsz": IMGSZ,
               "T": T, "dtype": "bfloat16", "steps": HEAD_STEPS,
               "losses": [float(v) for v in losses], "step_ms": step_ms,
               "ms_per_step": sum(step_ms) / HEAD_STEPS,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches_per_step": {k: v / HEAD_STEPS for k, v in launches.items()},
               "assigner_calls_per_step": len(calls), "assigner_ms_per_step": assigner_ms,
               "sync_free_step": "torch.cuda.set_sync_debug_mode('error')",
               **prof}
        emit(rec, log)
        out["step"] = rec
        if (not all(math.isfinite(v) for v in rec["losses"]) or len(calls) != 1
                or launches["binary_dw3_conv"] != dw3_step * HEAD_STEPS
                or launches["packed_spread"] != gemm_step * HEAD_STEPS
                or launches["ecs_lif_fused"] or launches["lif_fused"]):
            raise AssertionError(f"res10v8 bf16 steps failed their checks: {rec}")
        del model, state, step, tx, calls

        # --- res10v8: an epoch of train.driver.train, val on the EMA copy --------
        val_src = write_val_set(val_root, seed + 200, HEAD_VAL_IMAGES)
        passes = []
        real_run = val_mod.run

        def run(model, *a, **k):
            res, outs = recorded_nms(val_mod, lambda: real_run(model, *a, **k))
            passes.append((model, a, k, res, outs))
            return res

        cb = Callbacks()
        epoch_launches = {}
        cb.register_action("on_train_epoch_start", callback=lambda e: reset())
        cb.register_action("on_train_epoch_end", callback=lambda e: epoch_launches.update(read()))
        driver.val_mod.run = run
        try:
            t0 = time.perf_counter()
            _, _, hist = driver.train(
                HEAD_CFG, train_src, val_src, nc=NC, epochs=1, batch_size=N, imgsz=IMGSZ,
                bf16=True, seed=seed, workers=4, save_dir=str(val_root.parent / "heads_run"),
                loggers_include=("csv",),
                callbacks=cb)
            train_s = time.perf_counter() - t0
        finally:
            driver.val_mod.run = real_run
        (vmodel, va, vk, res, outs), = passes
        with plain_kernels():
            res_p, outs_p = recorded_nms(val_mod, lambda: real_run(vmodel, *va, **vk))
        rows = sum(o.shape[0] * o.shape[1] for o, _ in outs)
        worst, off, masks_equal = 0.0, 0, True
        for (o, v), (op, vp) in zip(outs, outs_p):
            d = (o - op).abs().amax(-1)
            worst, off = max(worst, float(d.max())), off + int((d > 0).sum())
            masks_equal &= bool((v == vp).all())
        metric_diff = max(abs(res[k] - res_p[k]) for k in ("mp", "mr", "map50", "map",
                                                          "fitness"))
        h = hist[0]
        rec = {"phase": "heads_train_run", "cfg": HEAD_CFG, "images": TRAIN_IMAGES,
               "batch": N, "accumulate": max(round(NBS / N), 1), "seconds": train_s,
               "loop_s": h["train_s"], "wait_s": h["wait_s"], "val_s": h["val_s"],
               "ckpt_s": h["ckpt_s"], "images_per_s": TRAIN_IMAGES / h["train_s"],
               "micro_steps": h["micro_steps"], "applies": h["applies"],
               "mloss": h["mloss"], "loss_finite": h["loss_finite"],
               "launches": epoch_launches, "val_seen": res["seen"],
               "val_forwards": len(outs),
               "nms_output_max_abs_diff_vs_plain_kernels": worst,
               "nms_rows_differing_share": off / max(rows, 1),
               "nms_valid_masks_equal": masks_equal,
               "metrics_max_abs_diff_vs_plain_kernels": metric_diff}
        emit(rec, log)
        out["train_run"] = rec
        if (not h["loss_finite"] or h["micro_steps"] != TRAIN_IMAGES // N
                or res["seen"] != HEAD_VAL_IMAGES or worst > 1e-3
                or off / max(rows, 1) > 1e-3 or metric_diff > 1e-6
                or epoch_launches["binary_dw3_conv"] != dw3_step * h["micro_steps"]
                or epoch_launches["packed_spread"] != gemm_step * h["micro_steps"]):
            raise AssertionError(f"res10v8 train() epoch failed its checks: {rec}")
        del passes, vmodel

        # --- the four other anchor-free YAMLs at b2 ------------------------------
        b = HEAD_OTHER_BATCH
        for j, cfg in enumerate(HEAD_OTHERS):
            t0 = time.perf_counter()
            n_sites, gemm_step, dw3_step = HEAD_SITES[cfg]
            model = head_model(cfg, seed + 1 + j, xb[:b], _BN)
            sites = [m for m in model.modules() if isinstance(m, MemUpdate)]
            small = tuple(t[:b] for t in batch)
            rec, _, _ = f32_step_check(model, small, sites, plain_kernels, hyp)
            model.eval()
            cast_params(model, torch.bfloat16)
            reset()
            with torch.no_grad():
                pred_out, seen = captured_sites(sites, lambda: model(xb[:b]))
            fwd = read()
            shares, silu = site_errors(seen, plain_kernels)
            del seen
            pred = head_predictions(model.head_info["name"], pred_out)
            reset()
            results = detect_mod.run(model, tmp, imgsz=IMGSZ)
            det_launches = read()
            rec = {"phase": "heads_other", "cfg": cfg, "head": model.head_info["name"],
                   "batch": b, "sites": len(shares) + len(silu),
                   "worst_site_mismatch_share": max(shares, default=0.0),
                   "silu_sites": len(silu), "worst_site_silu_err": max(silu, default=0.0),
                   "silu_err_unit": "bf16 ulps", "silu_ulps_bound": LIF_SILU_ULPS_BF16,
                   "launches_per_forward": fwd, "prediction_shape": list(pred.shape),
                   "prediction_finite": bool(torch.isfinite(pred).all()),
                   "detect_images": len(results), "detect_launches": det_launches,
                   "detect_finite": all(bool(np.isfinite(d).all()) for _, d in results),
                   "train_step_fp32": rec}
            ok = (len(shares) + len(silu) == n_sites and sites_ok(shares, silu, torch.bfloat16)
                  and fwd["ecs_lif_fused"] == n_sites and sum(fwd.values()) == n_sites
                  and rec["prediction_finite"] and rec["detect_finite"]
                  and det_launches["ecs_lif_fused"] == n_sites * len(results)
                  and rec["train_step_fp32"]["ok"])
            if cfg == "res10v10.yaml":
                reset()
                res = val_mod.run(model, str(val_src), imgsz=IMGSZ, batch_size=N,
                                  workers=4)
                vl = read()
                rec["val"] = {k: res[k] for k in ("mp", "mr", "map50", "map", "fitness",
                                                  "seen")}
                rec["val"]["launches"] = vl
                ok &= (res["seen"] == HEAD_VAL_IMAGES and vl["ecs_lif_fused"]
                       == n_sites * -(-HEAD_VAL_IMAGES // N))
            rec["seconds"] = time.perf_counter() - t0
            emit(rec, log)
            if not ok:
                raise AssertionError(f"{cfg}: failed its checks: {rec}")
            del model, sites
    emit({"phase": "heads_seconds", "seconds": time.perf_counter() - t_phase}, log)
    return out


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
        phase_k1_shapes(K, SNNConfig, log)
        aggs = phase_spread(S, BS, plain_kernels, shapes, log)
        phase_spread_grads(S, log)
        agg6 = phase_k6(FZ, BS, SNNConfig, shapes, broadcast, log)
        agg2, agg3 = phase_k2(FZ, K, SNNConfig, shapes, broadcast, log)
        phase_k3_tilings(FZ, SNNConfig, log)

        # --- the detect path at full width -------------------------------------
        calibrate_bn(model, torch.from_numpy(np.concatenate(ims)).cuda(), _BN)
        state32 = {k: v.detach().clone() for k, v in model.state_dict().items()}

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
        del model, x1

        # --- serving with the conv/bn pairs folded, same weights ---------------
        phase_fuse(state32, xb, log)
    del xb, state32

    # --- the training main paths: train steps, then train() with resume -------
    spread_launches = phase_train(log)
    with tempfile.TemporaryDirectory() as sets:
        t0 = time.perf_counter()
        train_src = write_val_set(Path(sets) / "train", opt.seed + 100, TRAIN_IMAGES)
        emit({"phase": "train_set", "images": TRAIN_IMAGES,
              "seconds": time.perf_counter() - t0}, log)
        t0 = time.perf_counter()
        run_launches, run_rec = phase_train_run(opt.seed, train_src, log)
        t1 = time.perf_counter()
        opts_launches = phase_train_opts(opt.seed, train_src, run_rec, log)
        t2 = time.perf_counter()
        heads = phase_heads(opt.seed, train_src, Path(sets) / "heads_val", log)
        emit({"phase": "train_seconds", "train_run": t1 - t0,
              "train_opts": t2 - t1, "heads": time.perf_counter() - t2}, log)

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
            library_note="no single PyTorch call computes the ECS-LIF recurrence",
            train_run_launches=run_launches["ecs_lif_fused"],
            heads_detect_launches=heads["detect_launches"],
            heads_note="heads_detect_launches: detect.run of res10v8 (ASFF_DDetect, 44 "
                       "sites) over the 4 synthetic images; the phase heads holds every "
                       "site of the five anchor-free YAMLs to the plain version"),
        aggs["binary_dw3_conv"].entry(
            name="binary_dw3_conv", route="cuda", source=csrc + "spread_dw3.cu",
            replaces="ecs_yolo_tpu/snn/pallas_dw.py:73",
            launches=spread_launches["binary_dw3_conv"],
            train_run_launches=run_launches["binary_dw3_conv"],
            train_opts_launches_per_step=opts_launches["binary_dw3_conv"],
            heads_launches_per_step=heads["step"]["launches_per_step"]["binary_dw3_conv"],
            recompute_note="train_opts_launches_per_step: one step each, plain / remat / "
                           "remat_neuron; the remat counts include the launches of the "
                           "backward pass's recompute; launches and train_run_launches "
                           "run no recompute",
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
            train_run_launches=run_launches["packed_spread"],
            train_opts_launches_per_step=opts_launches["packed_spread"],
            heads_launches_per_step=heads["step"]["launches_per_step"]["packed_spread"],
            recompute_note="train_opts_launches_per_step: one step each, plain / remat / "
                           "remat_neuron; the remat counts include the launches of the "
                           "backward pass's recompute; launches and train_run_launches "
                           "run no recompute",
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
                 f"launches over the {VAL_IMAGES // N} forwards of the val pass; ms "
                 "is the device time of lif_fused from calls replayed in a CUDA "
                 "graph, wrapper_ms the same calls eager",
            library_note="no single PyTorch call computes the LIF recurrence"),
        agg2.entry(
            name="ecs_lif_fused_rows", route="cuda", source=csrc + "ecs_lif_rows.cu",
            replaces="ecs_yolo_tpu/snn/pallas_kernels.py:326",
            launches=val_launches["ecs_lif_fused_rows"],
            work=f"the 24 neuron sites of one res10@640 forward under "
                 f"fused_inference, N={N}, T={T}, bf16 (the site behind the stem "
                 "reads a broadcast x); launches over the "
                 f"{VAL_IMAGES // N} forwards of the val pass",
            note="one cooperative launch a site (T-1 grid barriers, no halo "
                 "recompute), the 1x1 as a register-tiled FFMA product in channel "
                 "order, as the plain version sums it; the bound is the function's "
                 "(the 1x1 at the tensor-core peak, as K1's); each shape's record "
                 "also gives cuda_core_floor_ms, the floor of this channel-order "
                 "design on CUDA cores",
            library_note="no single PyTorch call computes the ECS-LIF recurrence"),
        agg3.entry(
            name="ecs_lif_fused_v2", route="cuda", source=csrc + "ecs_lif_v2.cu",
            replaces="ecs_yolo_tpu/snn/pallas_kernels.py:243", launches=k3_launches,
            work=f"its own entry point at the 24 neuron-site shapes of one res10@640 "
                 f"forward, N={N}, T={T}, bf16 (the site behind the stem on a "
                 "broadcast x); no model route takes it, as in the JAX package",
            note="K1's launch design (one cooperative launch a site, T-1 grid "
                 "barriers, no halo recompute, (tile x Cout slice) items owned by one "
                 "block, the 1x1 on wgmma in bf16) with K2's depthwise rounding; the "
                 "state in the block's shared memory where it fits in f32, else in "
                 "the workspace; the bound is K2's",
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
            "elementwise_device_ms": sum(r[0] for r in rows if "elementwise" in r[1]),
            "idle_share": max(0.0, 1 - total / wall_ms),
            "top_kernels": [{"name": k[:90], "ms": ms, "calls": c}
                            for ms, k, c in rows[:12]]}


if __name__ == "__main__":
    sys.exit(main())
