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
* event mode (phase ``events``, after ``heads``): two synthetic Gen1
  streams (``.dat`` + ``boxes.npy``) through ``data/events.build_dataset``;
  res10 ECS-LIF, nc 2, 320 px, T=5, b8, bf16 on an ``EventDataset`` batch:
  every neuron site of a forward held to its plain version (K1, 24 launches,
  the stem at every step, no broadcast input), ms, img/s and profile, K1 at
  the 24 site shapes at T=5 (``event_kernel_check``); the plain-LIF model on
  K6 the same; one float32 step teacher-forced against its plain rerun with
  the planted K4 fault that must fail it; bf16 steps (76 K4 + 20 K5
  launches a step, peak memory, profile) and one under sync-debug "error";
  one ``train.driver.train(events=True)`` epoch whose EMA val pass (no
  ``meta``) must give ``plain_kernels()``'s NMS output;
* the segment heads (phase ``segment``): ``res10-seg.yaml`` at b8 and
  ``res10-panoptic.yaml`` at b2, 640 px, bf16, on a synthetic polygon set
  with ``stuff/`` polygons (``SegmentDataset`` batches with instance masks
  and the semantic id map): every site held to its plain version (SiLU
  sites elementwise), all on K1; one float32 step with the masks (and the
  id map) teacher-forced; bf16 steps with peak memory and profile, one
  under sync-debug "error"; ``detect.run`` of res10-seg; one
  ``train.driver.train`` epoch of res10-seg whose val pass must give
  ``plain_kernels()``'s NMS output; K1 and K4 at the shapes the heads add
  (80x80x32, 20x20x768) in ``kernel_check`` records;
* the block library (phase ``zoo``, after ``segment``): the 24 YAMLs of
  ``ZOO_SITES`` (the EE / SEW residuals, the v9 ``CBLinear`` / ``CBFuse``
  wiring, ``EMA``, the ``AIFI`` encoder with ``RepC3``, and ``resnet18``,
  ``resnet34-cat``, ``botnet10``, ``resnet-test``, ``resnet10heads``; the
  star / GSConv / context-guide family, ``starnet``, ``starnet2``,
  ``starnet4``, ``ceshi``, ``resnet_v8``; the CSP / HG / Ghost family,
  ``yolov5s``, ``yolov8s``, ``cspresnet10``, ``HGresnet``, ``test``) at
  640 px, nc 13, T=4, bf16: each built on the card, one b2 eval forward
  (b8 for ``ZOO_TIMED``, then timed and profiled) with every neuron site
  held to its plain version (K1 / K2 spike share, SiLU sites in ulps, the
  ``AIFI`` token sites on K6 equal) and its K1 / K2 / K6 launches equal to
  the table, one b2 bf16 train step (K4 / K5 launches, peak memory); K2 at
  ``res10-ee``'s stem site (the raw image, broadcast over T, C = 3) and K6
  at ``resnetaifi``'s token sites timed beside their bounds;
  the float32 step of ``resnet10-v9`` and of ``ceshi`` teacher-forced
  with the planted K4 fault; one ``train.driver.train`` epoch of
  ``resnet10-v9`` and one of ``yolov8s``, whose val pass must give
  ``plain_kernels()``'s NMS output; the bf16 step of ``resnet_rtdetr`` and
  of ``HGresnet`` under sync-debug "error"; ``detect.run`` of
  ``resnetaifi`` and of ``starnet4``; then the five probe models of
  ``PROBES`` (the registry rows no YAML names, each set into one of the
  port's YAMLs) the same way, each also timed at b8, stepped under
  sync-debug "error" and (but probe-v5) in float32 with the planted fault;
* the RT-DETR loss and the NMS variants (phase ``rtdetr_nms``, after
  ``zoo``): ``train/rtdetr.rtdetr_loss`` forward and backward at b8, 300
  queries, 13 classes, up to 50 padded ground truths, against the port's
  CPU run (assignment, items, gradients), its ms and its host solver's
  share; the five ``ops/nms_variants`` functions on a 1000-box pool against
  their CPU runs, ``cluster_nms``'s keep set against ``ops/nms.py``'s
  greedy walk, each one's ms an image;
* the process-group paths (phase ``parallel``, after ``rtdetr_nms``): an
  NCCL group of world 1 in this process (``file://`` store); the res10 b8
  bf16 step under it (``make_train_step(layout=)``, the gradients in one
  all-reduce) bit-equal to the plain step (loss, items, parameters,
  momentum, EMA, BN statistics; cuDNN deterministic), also through
  ``shard_state`` / ``gather_state`` at ``model_parallel = 1``, both
  timed with their launches (57 K4 + 15 K5), peak memory, a step under
  sync-debug "error" and the all-reduce's device ms; one
  ``train.driver.train`` epoch under the group (16 images) whose sharded
  val pass equals ``val.run`` of its checkpoint without the group; and
  ``val.run`` under the group equal to the pass without it (NMS outputs,
  metrics, K1 at all 24 sites);
* validation: ``ecs_yolo_tpu_torch.val.run`` over a synthetic val split of 32
  images written from ``--seed`` (bf16, batch 8), three times: the ECS-LIF
  model on its default route, the same model with ``fused_inference=True``,
  and the plain-LIF model (``ecs=False``); each again under
  ``plain_kernels()``, which must give the same detections and metrics, and
  each model's batch-8 forward timed alone and profiled; the ECS-LIF
  pass again with its weights folded (``--fuse``, phase ``val_fuse``),
  recorded beside the unfused one; and the metric half alone on a perfect
  detector;
* export and the tools (phase ``tooling``): res10, plain-LIF res10
  and res10-ee (b8 bf16) exported to TorchScript and ``torch.export``, each
  artifact loaded back through ``backends.DetectMultiBackend`` bit-equal
  to the eager model, its K1 / K6 / K2 launches counted through the
  kernels' ``torch.library`` ops, every site held to its plain version on
  its own input; eager / TorchScript / pt2 ms (TorchScript also under the
  JIT's default fuser), the dispatcher's cost a call; ``hub.create(
  autoshape=True)`` against ``detect.run``; ``val.run`` on the pt2 backend
  against the native pass; firing rates, a profiler trace, ``autobatch``,
  ``forward_augment``; two ``evolve`` generations; ``python -m
  ecs_yolo_tpu_torch.tools export`` and ``firing-rate``;
* video frames (phase ``loaders``): two synthetic 640 x 480 GIFs of 8
  frames through ``data/loaders.py``'s ``LoadVideo`` (b1) and
  ``LoadStreams`` (both clips, b2), res10 at 640 px, bf16, on K1 and (plain
  LIF, ``LoadVideo``) on K6, each batch through ``detect.predictor`` /
  ``detect.frame_detections``: every site held to its plain version, the
  detections equal to the ``plain_kernels()`` rerun, 24 launches a forward;
  ms a frame and the loader's share timed with ``utils/general.Profile``,
  the idle share of the b1 pass; ``select_device("")`` and the decoder
  taken (imageio, else Pillow);
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
to one JSON file).  ``--phases serve,parallel,...`` runs a subset (the
kernel build always; ``PHASES`` names them) and prints no kernels line; with
no arguments every phase runs.  The last lines are the card's ``nvidia-smi`` name and
power limit, the ``{"kernels": ...}`` summary and ``{"ok": true, "device":
...}``.  Any failure exits non-zero.
"""

from __future__ import annotations

import copy
import functools
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


def phase_k1(K, cfg_cls, sites: Counter, broadcast: set, log, t: int = T,
             dtypes=(torch.float32, torch.bfloat16), tag: str = "kernel_check") -> Agg:
    """K1 against its plain version at every res10 site shape, N=8, T=4 (or
    ``t``), x dense, and x a broadcast over T where the model hands the site
    one.  Each record carries the launch's plan: its (tile x Cout slice)
    items, the grid of resident blocks and the slice."""
    agg = Agg()
    T = t                                   # noqa: N806 (the time steps here)
    cfg = cfg_cls(time_window=T)
    for dtype in dtypes:
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
                rec = {"phase": tag, "kernel": "ecs_lif_fused",
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


def phase_k6(FZ, BS, cfg_cls, sites: Counter, broadcast: set, log, t: int = T,
             dtypes=(torch.float32, torch.bfloat16), tag: str = "kernel_check") -> Agg:
    """The plain-LIF kernel against its plain version at every res10 site
    shape, N=8, T=4 (or ``t``), x dense and x a broadcast over T, plus one
    ragged shape (odd element count: the scalar variant).  ``ms`` is the kernel alone:
    the device time of one call from 20 calls captured in one CUDA graph and
    replayed (``BS.graph_ms``); ``wrapper_ms`` the same calls eager, back to
    back; ``host_issue_ms`` their difference, what the host adds a call."""
    agg = Agg()
    T = t                                   # noqa: N806 (the time steps here)
    cfg = cfg_cls(time_window=T, ecs=False)
    shapes = [((T, N, h, w, c), n) for (h, w, c), n in sorted(sites.items(), reverse=True)]
    shapes.append(((T, 3, 5, 7, 3), 0))
    for dtype in dtypes:
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
                rec = {"phase": tag, "kernel": "lif_fused",
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
#: the YAMLs of the ``zoo`` phase at 640 px, T=4, nc 13: (neuron sites, K1,
#: K2 and K6 launches of one eval forward, K5 and K4 launches of one
#: training forward); tests/test_torch_port_blocks_ext.py holds this table
#: against the models' hooks on the CPU
ZOO_SITES = {"resnet18.yaml": (35, 35, 0, 0, 27, 72),
             "resnet34-cat.yaml": (44, 44, 0, 0, 27, 99),
             "res10-ee.yaml": (22, 21, 1, 0, 21, 45),
             "res18-ee.yaml": (30, 29, 1, 0, 30, 60),
             "res18-eebk.yaml": (30, 29, 1, 0, 30, 60),
             "res18-sew.yaml": (25, 25, 0, 0, 0, 0),
             "resnet10-v9.yaml": (66, 66, 0, 0, 51, 147),
             "tal.yaml": (118, 118, 0, 0, 72, 282),
             "resnet10ema.yaml": (24, 24, 0, 0, 15, 57),
             "resnetaifi.yaml": (30, 24, 0, 6, 15, 57),
             "resnet_rtdetr.yaml": (55, 49, 0, 6, 24, 123),
             "botnet10.yaml": (24, 24, 0, 0, 15, 57),
             "resnet-test.yaml": (34, 34, 0, 0, 15, 87),
             "resnet10heads.yaml": (30, 30, 0, 0, 18, 72),
             # the star / GSConv / context-guide family and the CSP / HG /
             # Ghost family: every site on K1, none on K2
             "starnet.yaml": (62, 62, 0, 0, 42, 144),
             "starnet2.yaml": (74, 74, 0, 0, 51, 171),
             "starnet4.yaml": (28, 28, 0, 0, 21, 63),
             "ceshi.yaml": (106, 106, 0, 0, 69, 249),
             "resnet_v8.yaml": (46, 46, 0, 0, 24, 114),
             "yolov5s.yaml": (68, 68, 0, 0, 48, 156),
             "yolov8s.yaml": (56, 56, 0, 0, 93, 75),
             "cspresnet10.yaml": (44, 44, 0, 0, 45, 87),
             "HGresnet.yaml": (48, 48, 0, 0, 21, 123),
             "test.yaml": (66, 66, 0, 0, 69, 129)}
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
#: the probes' float32 step holds a bias's gradient error relative to the
#: larger of its own plain gradient and its module's weight's: a bias whose
#: gradient is a sum that cancels (zero in exact arithmetic behind a
#: training-mode BN: DSSA's ``Wproj``, MHSA's ``proj_conv``, RepNCSP's
#: ``cv3_conv``; near zero beside its weight's in ASFF2's ``w0`` / ``w1`` /
#: ``wl``) keeps the spread kernels' float32 rounding as a large share of a
#: tiny value
LAYER_SCALED_NOTE = ("a bias's error over the larger of its plain gradient norm and its "
                     "module weight's")


def launch_counters() -> tuple:
    """``(reset, read)`` of the launch counters of the five kernels a model
    path runs (K1, K2, K6 in eval; K4, K5 in training)."""
    from ecs_yolo_tpu_torch.snn import ecs_lif as K
    from ecs_yolo_tpu_torch.snn import fused as FZ
    from ecs_yolo_tpu_torch.snn import spread as S

    counters = {"ecs_lif_fused": K.ecs_lif_fused, "ecs_lif_fused_rows": FZ.ecs_lif_fused_rows,
                "lif_fused": FZ.lif_fused, "binary_dw3_conv": S.binary_dw3_conv,
                "packed_spread": S.packed_spread}

    def reset():
        for f in counters.values():
            f.launches = 0

    def read():
        return {k: f.launches for k, f in counters.items()}

    return reset, read


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


def f32_step_check(model, batch, sites, plain_kernels, hyp, plant=False,
                   layer_scaled=False) -> tuple:
    """One float32 training step's loss and gradients on the kernel route
    against the same step under ``plain_kernels()`` from the same state, each
    site of the plain rerun handing on the kernel run's output (its gradient
    still flows through the site's own plain forward); each site's output
    against its plain version on its real input.  With ``plant`` the kernel
    step is run again with K4 writing a wrong int8 plane (``PLANT_STRIDE``),
    which leaves the forward as it is and must move a gradient past
    ``HEAD_PARAM_GRAD_RTOL``.  Each gradient's error is relative to its
    plain value; with ``layer_scaled`` a bias's error is relative to the
    larger of its plain gradient and the plain gradient of its module's
    weight (``LAYER_SCALED_NOTE``)."""
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

    def scale(k):
        n, w = grads_p[k].norm(), k[:-len("bias")] + "weight"
        if layer_scaled and k.endswith(".bias") and w in grads_p:
            n = torch.maximum(n, grads_p[w].norm())
        return n.clamp(min=1e-30)

    def rel(grads):
        return {k: float((grads[k] - grads_p[k]).norm() / scale(k)) for k in grads}

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
    if layer_scaled:        # also each parameter against its own plain gradient
        raw = {k: float((grads_k[k] - grads_p[k]).norm() / grads_p[k].norm().clamp(min=1e-30))
               for k in grads_k}
        weight_of = lambda k: k[:-len("bias")] + "weight"
        rec["bias_grad_err"] = LAYER_SCALED_NOTE
        rec["param_grad_rel_err_max_unscaled"] = max(raw.values())
        rec["worst_unscaled"] = [   # name, error, plain gradient norm, its module weight's
            [k, v, float(grads_p[k].norm()),
             float(grads_p[weight_of(k)].norm()) if weight_of(k) in grads_p else None]
            for k, v in sorted(raw.items(), key=lambda kv: -kv[1])[:8]]
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
    from ecs_yolo_tpu_torch.snn import spread as S
    from ecs_yolo_tpu_torch.snn.route import plain_kernels
    from ecs_yolo_tpu_torch.train import driver, loss_tal
    from ecs_yolo_tpu_torch.train.trainer import make_train_step

    t_phase = time.perf_counter()
    hyp = dict(HYP_SCRATCH)
    reset, read = launch_counters()

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_images(Path(tmp))
        ims = [im for _, im, _ in LoadImages(tmp, IMGSZ)]     # already in 0-1
        xb = torch.from_numpy(np.concatenate(ims * 2)).cuda()
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
        # the last step must make no host sync (the TAL assigner and losses
        # keep static shapes): a sync raises there and fails the phase
        state, steps = timed_steps(step, state, batch, HEAD_STEPS, read, reset)
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
               "T": T, "dtype": "bfloat16", **steps,
               "assigner_calls_per_step": len(calls), "assigner_ms_per_step": assigner_ms}
        emit(rec, log)
        out["step"] = rec
        per = rec["launches_per_step"]
        if (not all(math.isfinite(v) for v in rec["losses"]) or len(calls) != 1
                or per["binary_dw3_conv"] != dw3_step or per["packed_spread"] != gemm_step
                or per["ecs_lif_fused"] or per["lif_fused"]):
            raise AssertionError(f"res10v8 bf16 steps failed their checks: {rec}")
        del model, state, step, tx, calls

        # --- res10v8: an epoch of train.driver.train, val on the EMA copy --------
        val_src = write_val_set(val_root, seed + 200, HEAD_VAL_IMAGES)
        h, epoch_launches, res, cmp, forwards = epoch_with_val(
            driver, val_mod, plain_kernels, reset, read, cfg=HEAD_CFG,
            train_path=train_src, val_path=val_src, nc=NC, batch_size=N, imgsz=IMGSZ,
            bf16=True, seed=seed, workers=4, save_dir=str(val_root.parent / "heads_run"))
        rec = {"phase": "heads_train_run", "cfg": HEAD_CFG, "images": TRAIN_IMAGES,
               "batch": N, "accumulate": max(round(NBS / N), 1),
               "loop_s": h["train_s"], "wait_s": h["wait_s"], "val_s": h["val_s"],
               "ckpt_s": h["ckpt_s"], "images_per_s": TRAIN_IMAGES / h["train_s"],
               "micro_steps": h["micro_steps"], "applies": h["applies"],
               "mloss": h["mloss"], "loss_finite": h["loss_finite"],
               "launches": epoch_launches, "val_seen": res["seen"],
               "val_forwards": forwards, **cmp}
        emit(rec, log)
        out["train_run"] = rec
        if (not h["loss_finite"] or h["micro_steps"] != TRAIN_IMAGES // N
                or res["seen"] != HEAD_VAL_IMAGES or not cmp["val_equal"]
                or epoch_launches["binary_dw3_conv"] != dw3_step * h["micro_steps"]
                or epoch_launches["packed_spread"] != gemm_step * h["micro_steps"]):
            raise AssertionError(f"res10v8 train() epoch failed its checks: {rec}")

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
            pred = head_predictions(model.head_info["name"], pred_out, NC)
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


def epoch_with_val(driver, val_mod, plain_kernels, reset, read, record=None,
                   **train_kw) -> tuple:
    """One ``train.driver.train`` epoch (``train_kw``) with the launch counts
    of its loop read around it, its val pass on the EMA copy recorded and run
    again under ``plain_kernels()``.  Returns (the epoch's history row, the
    loop's launches, the val result, the fields that compare the two passes'
    NMS outputs and metrics, the val pass's forwards); ``record``, a list,
    also gets the val pass's ``(model, args, kwargs, result, NMS outputs)``."""
    from ecs_yolo_tpu_torch.utils.general import Callbacks

    passes, real_run = [], val_mod.run

    def run(model, *a, **k):
        res, outs = recorded_nms(val_mod, lambda: real_run(model, *a, **k))
        passes.append((model, a, k, res, outs))
        return res

    cb, launches = Callbacks(), {}
    cb.register_action("on_train_epoch_start", callback=lambda e: reset())
    cb.register_action("on_train_epoch_end", callback=lambda e: launches.update(read()))
    driver.val_mod.run = run
    try:
        t0 = time.perf_counter()
        _, _, hist = driver.train(epochs=1, loggers_include=("csv",), callbacks=cb,
                                  **train_kw)
        seconds = time.perf_counter() - t0
    finally:
        driver.val_mod.run = real_run
    (vmodel, va, vk, res, outs), = passes
    if record is not None:
        record.extend(passes)
    with plain_kernels():
        res_p, outs_p = recorded_nms(val_mod, lambda: real_run(vmodel, *va, **vk))
    rows = sum(o.shape[0] * o.shape[1] for o, _ in outs)
    worst, off, masks_equal = 0.0, 0, True
    for (o, v), (op, vp) in zip(outs, outs_p):
        d = (o - op).abs().amax(-1)
        worst, off = max(worst, float(d.max())), off + int((d > 0).sum())
        masks_equal &= bool((v == vp).all())
    cmp = {"seconds": seconds, "nms_output_max_abs_diff_vs_plain_kernels": worst,
           "nms_rows_differing_share": off / max(rows, 1),
           "nms_valid_masks_equal": masks_equal,
           "metrics_max_abs_diff_vs_plain_kernels": max(
               abs(res[k] - res_p[k]) for k in ("mp", "mr", "map50", "map", "fitness"))}
    cmp["val_equal"] = (worst <= 1e-3 and off / max(rows, 1) <= 1e-3
                        and cmp["metrics_max_abs_diff_vs_plain_kernels"] <= 1e-6)
    return hist[0], launches, res, cmp, len(outs)


def timed_steps(step, state, batch, n: int, read, reset) -> tuple:
    """``n`` steps after a first one kept apart, timed by events; their
    launches and peak memory; one more under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync raises); one
    profiled (device time by kernel, idle share)."""
    state, _ = step(state, *batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    losses = []
    events[0].record()
    for i in range(n):
        state, metrics = step(state, *batch)
        events[i + 1].record()
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    launches = read()
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(n)]
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = step(state, *batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    prof = profile_step(lambda: step(state, *batch))
    return state, {"steps": n, "losses": [float(v) for v in losses], "step_ms": step_ms,
                   "ms_per_step": sum(step_ms) / n, "peak_memory_gb": peak,
                   "launches_per_step": {k: v / n for k, v in launches.items()},
                   "sync_free_step": "torch.cuda.set_sync_debug_mode('error')", **prof}


#: event mode (Gen1: T=5, nc 2, 240x304 frames resized to 320 px; the
#: reference's data/gen1.yaml): res10's neuron sites, the fused spread
#: product's and the depthwise kernel's launches in a training forward
#: (T-1 = 4 a site), and the samples of the synthetic streams
EVENT_T, EVENT_IMGSZ, EVENT_NC = 5, 320, 2
EVENT_SITES = (24, 20, 76)
EVENT_TRAIN, EVENT_VAL = 16, 8
#: the segment heads at 640 px, nc 13, T=4: (sites, K5, K4 launches a
#: training step), as HEAD_SITES (tests/test_torch_port_segment.py holds
#: this table against the models' hooks on the CPU); the images of the
#: synthetic polygon set, and the batch of the panoptic model's checks
SEG_CFG, PAN_CFG = "res10-seg.yaml", "res10-panoptic.yaml"
SEG_SITES = {SEG_CFG: (39, 21, 75), PAN_CFG: (40, 21, 75)}
SEG_IMAGES, SEG_VAL_IMAGES, SEG_MAX_LABELS, PAN_BATCH = 16, 8, 32, 2
SEG_STEPS = 2


def write_gen1(root: Path, seed: int, samples: int) -> tuple:
    """A synthetic Prophesee Gen1 stream, as ``tests/test_events.py`` writes
    one: a ``.dat`` (240x304, '%' header, event type and size bytes, then
    ``(t u4, x | y << 14 | p << 28 u4)`` records; one event every 5 us at
    random pixels and polarities) and its ``boxes.npy`` (1-4 boxes of 2
    classes at each of ``samples`` timestamps 100 ms apart, after the first
    250 ms window).  Returns (dat, boxes) paths."""
    from ecs_yolo_tpu_torch.data.events import BBOX_DTYPE, GEN1_SHAPE

    rng = np.random.RandomState(seed)
    h, w = GEN1_SHAPE
    dur = 300_000 + samples * 100_000
    n = dur // 5
    rec = np.empty(n, np.dtype([("t", "<u4"), ("w", "<u4")]))
    rec["t"] = np.sort(rng.randint(0, dur, n))
    rec["w"] = (rng.randint(0, w, n) | (rng.randint(0, h, n) << 14)
                | (rng.randint(0, 2, n) << 28))
    root.mkdir(parents=True, exist_ok=True)
    dat = root / "stream_td.dat"
    with open(dat, "wb") as fh:
        fh.write(b"% synthetic Gen1 stream\n% height 240\n% width 304\n")
        fh.write(bytes([0x0C, 8]))
        fh.write(rec.tobytes())
    rows = []
    for k in range(samples):
        for tr in range(rng.randint(1, 5)):
            bw, bh = rng.uniform(20, 120), rng.uniform(20, 90)
            rows.append((300_000 + 100_000 * k, rng.uniform(0, w - bw), rng.uniform(0, h - bh),
                         bw, bh, rng.randint(0, 2), 1.0, tr))
    lbl = root / "boxes.npy"
    np.save(lbl, np.array(rows, dtype=BBOX_DTYPE))
    return dat, lbl


def phase_events(seed: int, root: Path, log) -> dict:
    """Event mode on the card: res10 ECS, nc 2, 320 px, T=5, b8, bf16.

    Two synthetic Gen1 streams through ``data/events.build_dataset`` (train
    and val); a calibrated model's forward on an ``EventDataset`` batch
    ``[8, 5, 320, 320, 3]`` with every neuron site held to the plain version
    of its kernel on its real input (the stem runs at each step: no site
    reads a broadcast), K1 24 launches a forward, ms and img/s, profiled;
    K1 at those 9 shapes at T=5 against its plain version and bound
    (``event_kernel_check``); the plain-LIF model (``ecs=False``) the same
    on K6; one float32 step teacher-forced against its ``plain_kernels()``
    rerun with the planted K4 fault that must fail it; bf16 steps (K4 76,
    K5 20 launches a step, peak memory) and one under sync-debug "error";
    one ``train.driver.train(events=True)`` epoch whose EMA val pass must
    give ``plain_kernels()``'s NMS output."""
    from ecs_yolo_tpu_torch import val as val_mod
    from ecs_yolo_tpu_torch.config import SNNConfig
    from ecs_yolo_tpu_torch.data.events import EventDataset, build_dataset
    from ecs_yolo_tpu_torch.data.hyps import HYP_SCRATCH
    from ecs_yolo_tpu_torch.models.yolo import build_model, cast_params
    from ecs_yolo_tpu_torch.nn.blocks import MemUpdate, _BN
    from ecs_yolo_tpu_torch.scripts import bench_spread as BS
    from ecs_yolo_tpu_torch.snn import ecs_lif as K
    from ecs_yolo_tpu_torch.snn import fused as FZ
    from ecs_yolo_tpu_torch.snn import spread as S
    from ecs_yolo_tpu_torch.snn.route import plain_kernels
    from ecs_yolo_tpu_torch.train import driver
    from ecs_yolo_tpu_torch.train.trainer import make_train_step

    t_phase = time.perf_counter()
    hyp = dict(HYP_SCRATCH)
    reset, read = launch_counters()

    n_sites, gemm_step, dw3_step = EVENT_SITES
    out = {}
    t0 = time.perf_counter()
    splits = {}
    for split, k, n in (("train", 0, EVENT_TRAIN), ("val", 1, EVENT_VAL)):
        dat, lbl = write_gen1(root / f"{split}_stream", seed + 300 + k, n)
        got = build_dataset([(str(dat), str(lbl))], root / split, t_bins=EVENT_T,
                            split=split)
        splits[split] = root / split / f"{split}.txt"
        if got != n:
            raise AssertionError(f"build_dataset wrote {got} {split} samples, want {n}")
    ds = EventDataset(splits["train"], img_size=EVENT_IMGSZ, max_labels=TRAIN_BOXES)
    ims, lbs, ms_ = next(ds.batches(N))
    xb = torch.from_numpy(ims).cuda()
    batch = (xb, torch.from_numpy(lbs).cuda(), torch.from_numpy(ms_).cuda())
    emit({"phase": "events_data", "seconds": time.perf_counter() - t0,
          "train_samples": EVENT_TRAIN, "val_samples": EVENT_VAL,
          "batch_shape": list(ims.shape), "event_share": float((ims != 127 / 255).mean()),
          "labels": int(ms_.sum())}, log)
    if ims.shape != (N, EVENT_T, EVENT_IMGSZ, EVENT_IMGSZ, 3):
        raise AssertionError(f"event batch {ims.shape}")

    # --- ECS-LIF: serving ------------------------------------------------------------
    snn = SNNConfig(time_window=EVENT_T)
    model = build_model("resnet10.yaml", nc=EVENT_NC, snn=snn,
                        generator=torch.Generator().manual_seed(seed + 30))
    calibrate_bn(model, xb, _BN)
    sites = [m for m in model.modules() if isinstance(m, MemUpdate)]
    state32 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    cast_params(model, torch.bfloat16)
    broadcast: set = set()
    shapes = site_shapes(model, MemUpdate, xb, broadcast)
    reset()
    with torch.no_grad():
        _, seen = captured_sites(sites, lambda: model(xb))
    fwd = read()
    shares, silu = site_errors(seen, plain_kernels)
    del seen
    with torch.no_grad():
        ms = cuda_ms(lambda: model(xb), reps=10)
        prof = profile_step(lambda: model(xb))
    rec = {"phase": "events_forward", "batch": N, "T": EVENT_T, "imgsz": EVENT_IMGSZ,
           "nc": EVENT_NC, "dtype": "bfloat16", "sites": len(shares) + len(silu),
           "shapes": [[list(k), v] for k, v in sorted(shapes.items(), reverse=True)],
           "input_broadcast_over_t": sorted(map(list, broadcast)),
           "launches_per_forward": fwd, "worst_site_mismatch_share": max(shares),
           "site_mismatch_shares": shares, "ms_per_forward": ms,
           "images_per_s": N / ms * 1e3, **prof}
    emit(rec, log)
    out["forward"] = {"ms": ms, "k1_launches": fwd["ecs_lif_fused"]}
    if (len(shares) + len(silu) != n_sites or broadcast
            or not sites_ok(shares, silu, torch.bfloat16)
            or fwd["ecs_lif_fused"] != n_sites or sum(fwd.values()) != n_sites):
        raise AssertionError(f"event model: a site disagrees or left K1: {rec}")
    out["k1"] = phase_k1(K, SNNConfig, shapes, set(), log, t=EVENT_T,
                         dtypes=(torch.bfloat16,), tag="event_kernel_check")

    # --- ECS-LIF: training -----------------------------------------------------------
    for p in model.parameters():
        p.data = p.data.float()
    model.load_state_dict(state32)
    rec, tx, state = f32_step_check(model, batch, sites, plain_kernels, hyp, plant=True)
    emit({"phase": "events_train_step_fp32", "batch": N, "T": EVENT_T, **rec}, log)
    if not rec["ok"]:
        raise AssertionError(f"event model float32 step: kernel route disagrees: {rec}")
    step = make_train_step(model, tx, hyp, compute_dtype=torch.bfloat16)
    state, rec = timed_steps(step, state, batch, HEAD_STEPS, read, reset)
    emit({"phase": "events_train_step", "batch": N, "T": EVENT_T, "imgsz": EVENT_IMGSZ,
          "dtype": "bfloat16", **rec}, log)
    out["step"] = rec
    per = rec["launches_per_step"]
    if (not all(math.isfinite(v) for v in rec["losses"])
            or per["binary_dw3_conv"] != dw3_step or per["packed_spread"] != gemm_step
            or per["ecs_lif_fused"] or per["lif_fused"]):
        raise AssertionError(f"event model bf16 steps failed their checks: {rec}")
    del model, state, step, tx, state32

    # --- plain LIF (ecs=False): serving on K6 --------------------------------------------
    model = build_model("resnet10.yaml", nc=EVENT_NC, snn=snn.replace(ecs=False),
                        generator=torch.Generator().manual_seed(seed + 31))
    calibrate_bn(model, xb, _BN)
    cast_params(model, torch.bfloat16)
    sites = [m for m in model.modules() if isinstance(m, MemUpdate)]
    reset()
    with torch.no_grad():
        _, seen = captured_sites(sites, lambda: model(xb))
    fwd = read()
    shares, silu = site_errors(seen, plain_kernels)
    del seen
    with torch.no_grad():
        ms = cuda_ms(lambda: model(xb), reps=10)
    rec = {"phase": "events_forward_plain_lif", "batch": N, "T": EVENT_T,
           "dtype": "bfloat16", "sites": len(shares), "launches_per_forward": fwd,
           "worst_site_mismatch_share": max(shares), "ms_per_forward": ms,
           "images_per_s": N / ms * 1e3}
    emit(rec, log)
    out["forward_plain_lif"] = {"ms": ms, "k6_launches": fwd["lif_fused"]}
    if (len(shares) != n_sites or max(shares) > 0.0 or fwd["lif_fused"] != n_sites
            or sum(fwd.values()) != n_sites):
        raise AssertionError(f"plain-LIF event model: a site disagrees or left K6: {rec}")
    out["k6"] = phase_k6(FZ, BS, SNNConfig, shapes, set(), log, t=EVENT_T,
                         dtypes=(torch.bfloat16,), tag="event_kernel_check")
    del model, sites, xb, batch

    # --- train.driver.train(events=True): an epoch, val on the EMA copy ------------------
    h, launches, res, cmp, forwards = epoch_with_val(
        driver, val_mod, plain_kernels, reset, read, cfg="resnet10.yaml",
        train_path=str(splits["train"]), val_path=str(splits["val"]), nc=EVENT_NC,
        batch_size=N, imgsz=EVENT_IMGSZ, nbs=N, bf16=True, seed=seed, workers=4,
        events=True, save_dir=str(root / "run"))
    rec = {"phase": "events_train_run", "samples": EVENT_TRAIN, "batch": N,
           "loop_s": h["train_s"], "wait_s": h["wait_s"], "val_s": h["val_s"],
           "ckpt_s": h["ckpt_s"], "samples_per_s": EVENT_TRAIN / h["train_s"],
           "micro_steps": h["micro_steps"], "applies": h["applies"], "mloss": h["mloss"],
           "loss_finite": h["loss_finite"], "launches": launches, "val_seen": res["seen"],
           "val_forwards": forwards, **cmp}
    emit(rec, log)
    out["train_run"] = rec
    if (not h["loss_finite"] or h["micro_steps"] != EVENT_TRAIN // N
            or h["applies"] != EVENT_TRAIN // N or not cmp["val_equal"]
            or res["seen"] != EVENT_VAL or forwards != EVENT_VAL // N
            or launches["binary_dw3_conv"] != dw3_step * h["micro_steps"]
            or launches["packed_spread"] != gemm_step * h["micro_steps"]):
        raise AssertionError(f"train(events=True) epoch failed its checks: {rec}")
    emit({"phase": "events_seconds", "seconds": time.perf_counter() - t_phase}, log)
    return out


def write_seg_set(root: Path, seed: int, images: int) -> Path:
    """A synthetic YOLO-seg split from ``seed``: ``images`` images of mixed
    native sizes (noise), each with 1-6 filled polygons (3-8 points) of
    ``NC`` classes drawn in and labelled (``labels/``), and 1-2 stuff
    polygons of classes ``NC..NC+19`` (``stuff/``, the panoptic head's
    ``sem_nc`` of 20).  Returns the image directory."""
    from PIL import Image, ImageDraw

    rng = np.random.RandomState(seed)
    for sub in ("images", "labels", "stuff"):
        (root / sub).mkdir(parents=True)

    def poly():
        k = rng.randint(3, 9)
        c = rng.uniform(0.2, 0.8, 2)
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        r = rng.uniform(0.04, 0.2, k)
        return np.clip(c + np.stack([np.cos(ang), np.sin(ang)], 1) * r[:, None], 0, 1)

    for i in range(images):
        h, w = VAL_SIZES[i % len(VAL_SIZES)]
        im = Image.fromarray((rng.rand(h, w, 3) * 96 + 64).astype(np.uint8))
        draw = ImageDraw.Draw(im)
        rows, stuff = [], []
        for _ in range(rng.randint(1, 7)):
            pts = poly()
            draw.polygon([(x * w, y * h) for x, y in pts], fill=tuple(rng.randint(0, 255, 3)))
            rows.append(" ".join([str(rng.randint(0, NC))] + [f"{v:.5f}" for v in pts.ravel()]))
        for _ in range(rng.randint(1, 3)):
            stuff.append(" ".join([str(NC + rng.randint(0, 20))]
                                  + [f"{v:.5f}" for v in poly().ravel()]))
        im.save(root / "images" / f"{2000 + i}.jpg", quality=90)
        (root / "labels" / f"{2000 + i}.txt").write_text("\n".join(rows) + "\n")
        (root / "stuff" / f"{2000 + i}.txt").write_text("\n".join(stuff) + "\n")
    return root / "images"


def phase_segment(seed: int, root: Path, log) -> dict:
    """The Segment / Panoptic heads on the card: ``res10-seg.yaml`` at b8
    and ``res10-panoptic.yaml`` at b``PAN_BATCH``, nc 13, 640 px, T=4, bf16.

    Per model: a forward on a ``SegmentDataset`` batch with every neuron site
    held to the plain version of its kernel (the SiLU sites of the mask
    towers, ``Proto`` and ``UConv`` elementwise), all on K1, ms, img/s and
    profile; one float32 step with the instance masks (and, panoptic, the
    semantic id map) teacher-forced against its ``plain_kernels()`` rerun;
    bf16 steps (K4 / K5 launches, peak memory) and one under sync-debug
    "error".  ``res10-seg``: ``detect.run`` over 4 synthetic images, and
    one ``train.driver.train`` epoch over a synthetic polygon set whose EMA
    val pass must give ``plain_kernels()``'s NMS output.  K1 and K4 at the
    shapes the heads add (80x80x32, 20x20x768) in their own kernel_check
    records."""
    from ecs_yolo_tpu_torch import detect as detect_mod
    from ecs_yolo_tpu_torch import val as val_mod
    from ecs_yolo_tpu_torch.config import SNNConfig
    from ecs_yolo_tpu_torch.data.dataset import SegmentDataset
    from ecs_yolo_tpu_torch.data.hyps import HYP_SCRATCH
    from ecs_yolo_tpu_torch.models.yolo import cast_params, head_predictions
    from ecs_yolo_tpu_torch.nn.blocks import MemUpdate, _BN
    from ecs_yolo_tpu_torch.scripts import bench_spread as BS
    from ecs_yolo_tpu_torch.snn import ecs_lif as K
    from ecs_yolo_tpu_torch.snn import spread as S
    from ecs_yolo_tpu_torch.snn.route import plain_kernels
    from ecs_yolo_tpu_torch.train import driver
    from ecs_yolo_tpu_torch.train.trainer import make_train_step

    t_phase = time.perf_counter()
    hyp = dict(HYP_SCRATCH)
    reset, read = launch_counters()

    t0 = time.perf_counter()
    train_src = write_seg_set(root / "train", seed + 400, SEG_IMAGES)
    val_src = write_seg_set(root / "val", seed + 401, SEG_VAL_IMAGES)
    ds = SegmentDataset(train_src, img_size=IMGSZ, augment=False, max_labels=SEG_MAX_LABELS,
                        uint8_out=True, semantic=True)
    host = next(ds.batches(N))
    emit({"phase": "segment_data", "seconds": time.perf_counter() - t0,
          "train_images": SEG_IMAGES, "val_images": SEG_VAL_IMAGES,
          "shapes": [list(a.shape) for a in host], "instances": int(host[2].sum()),
          "mask_pixels_share": float(host[3].mean()),
          "semantic_labelled_share": float((host[4] >= 0).mean())}, log)
    full = [torch.from_numpy(a).cuda() for a in host]
    full[0] = full[0].float() / 255.0
    out = {"models": {}}
    new_shapes = Counter()
    for cfg in (SEG_CFG, PAN_CFG):
        t0 = time.perf_counter()
        n_sites, gemm_step, dw3_step = SEG_SITES[cfg]
        b = N if cfg == SEG_CFG else PAN_BATCH
        batch = tuple(a[:b] for a in (full if cfg == PAN_CFG else full[:4]))
        model = head_model(cfg, seed + 40, batch[0], _BN)
        sites = [m for m in model.modules() if isinstance(m, MemUpdate)]
        state32 = {k: v.detach().clone() for k, v in model.state_dict().items()}
        cast_params(model, torch.bfloat16)
        reset()
        with torch.no_grad():
            pred_out, seen = captured_sites(sites, lambda: model(batch[0]))
        fwd = read()
        shares, silu = site_errors(seen, plain_kernels)
        shapes = Counter(tuple(xin.shape[2:]) for _, xin, _ in seen)
        del seen
        pred = head_predictions(model.head_info["name"], pred_out, NC)
        with torch.no_grad():
            ms = cuda_ms(lambda: model(batch[0]), reps=5)
            prof = profile_step(lambda: model(batch[0]))
        rec = {"phase": "segment_forward", "cfg": cfg, "batch": b, "dtype": "bfloat16",
               "sites": len(shares) + len(silu), "silu_sites": len(silu),
               "shapes": [[list(k), v] for k, v in sorted(shapes.items(), reverse=True)],
               "launches_per_forward": fwd, "worst_site_mismatch_share": max(shares),
               "worst_site_silu_err": max(silu), "silu_err_unit": "bf16 ulps",
               "prediction_shape": list(pred.shape), "decoded_with_coefficients": list(
                   pred_out[0].shape), "protos": list(pred_out[1][2].shape),
               "ms_per_forward": ms, "images_per_s": b / ms * 1e3, **prof}
        emit(rec, log)
        if (len(shares) + len(silu) != n_sites or not sites_ok(shares, silu, torch.bfloat16)
                or fwd["ecs_lif_fused"] != n_sites or sum(fwd.values()) != n_sites
                or pred.shape[1] != 4 + NC or not bool(torch.isfinite(pred).all())):
            raise AssertionError(f"{cfg}: a site disagrees or left K1: {rec}")
        new_shapes.update({k: v for k, v in shapes.items()
                           if k in ((80, 80, 32), (20, 20, 768))})
        mrec = {"forward_ms": ms, "k1_launches": fwd["ecs_lif_fused"], "batch": b}
        if cfg == SEG_CFG:
            (root / "detect").mkdir()
            write_images(root / "detect")
            reset()
            results = detect_mod.run(model, root / "detect", imgsz=IMGSZ)
            det = read()
            rec = {"phase": "segment_detect", "cfg": cfg, "images": len(results),
                   "detections": [int(len(d)) for _, d in results], "launches": det,
                   "finite": all(bool(np.isfinite(d).all()) for _, d in results)}
            emit(rec, log)
            mrec["detect_launches"] = det["ecs_lif_fused"]
            if (not rec["finite"] or len(results) != 4
                    or det["ecs_lif_fused"] != n_sites * 4):
                raise AssertionError(f"{cfg} detect.run failed its checks: {rec}")
        for p in model.parameters():
            p.data = p.data.float()
        model.load_state_dict(state32)
        rec, tx, state = f32_step_check(model, batch, sites, plain_kernels, hyp)
        emit({"phase": "segment_train_step_fp32", "cfg": cfg, "batch": b,
              "with_semantic": len(batch) == 5, **rec}, log)
        if not rec["ok"] or len(rec["items"]) != (6 if cfg == PAN_CFG else 4):
            raise AssertionError(f"{cfg} float32 step: kernel route disagrees: {rec}")
        step = make_train_step(model, tx, hyp, compute_dtype=torch.bfloat16,
                               with_masks=True, with_semantic=cfg == PAN_CFG)
        state, rec = timed_steps(step, state, batch, SEG_STEPS, read, reset)
        emit({"phase": "segment_train_step", "cfg": cfg, "batch": b, "dtype": "bfloat16",
              **rec}, log)
        mrec["step"] = rec
        per = rec["launches_per_step"]
        if (not all(math.isfinite(v) for v in rec["losses"])
                or per["binary_dw3_conv"] != dw3_step or per["packed_spread"] != gemm_step
                or per["ecs_lif_fused"] or per["lif_fused"]):
            raise AssertionError(f"{cfg} bf16 steps failed their checks: {rec}")
        out["models"][cfg] = mrec
        emit({"phase": "segment_model_seconds", "cfg": cfg,
              "seconds": time.perf_counter() - t0}, log)
        del model, state, step, tx, state32, sites, batch
    del full

    # --- the K1 / K4 shapes the segment heads add, their own records -----------------------
    phase_k1(K, SNNConfig, new_shapes, set(), log)
    phase_spread(S, BS, plain_kernels, Counter({(20, 20, 768): new_shapes[(20, 20, 768)]}),
                 log)

    # --- res10-seg: an epoch of train.driver.train, val on the EMA copy ----------------------
    h, launches, res, cmp, forwards = epoch_with_val(
        driver, val_mod, plain_kernels, reset, read, cfg=SEG_CFG, train_path=train_src,
        val_path=val_src, nc=NC, batch_size=N, imgsz=IMGSZ, nbs=N, bf16=True, seed=seed,
        workers=4, max_labels=SEG_MAX_LABELS, save_dir=str(root / "run"))
    n_sites, gemm_step, dw3_step = SEG_SITES[SEG_CFG]
    rec = {"phase": "segment_train_run", "cfg": SEG_CFG, "images": SEG_IMAGES, "batch": N,
           "loop_s": h["train_s"], "wait_s": h["wait_s"], "val_s": h["val_s"],
           "ckpt_s": h["ckpt_s"], "images_per_s": SEG_IMAGES / h["train_s"],
           "micro_steps": h["micro_steps"], "applies": h["applies"],
           "mloss_box_mask_cls": h["mloss"], "loss_finite": h["loss_finite"],
           "launches": launches, "val_seen": res["seen"], "val_forwards": forwards, **cmp}
    emit(rec, log)
    out["train_run"] = rec
    if (not h["loss_finite"] or h["micro_steps"] != SEG_IMAGES // N or not cmp["val_equal"]
            or res["seen"] != SEG_VAL_IMAGES or h["mloss"][1] <= 0
            or launches["binary_dw3_conv"] != dw3_step * h["micro_steps"]
            or launches["packed_spread"] != gemm_step * h["micro_steps"]):
        raise AssertionError(f"{SEG_CFG} train() epoch failed its checks: {rec}")
    emit({"phase": "segment_seconds", "seconds": time.perf_counter() - t_phase}, log)
    return out


#: the ``zoo`` phase: b2 forwards and steps, b8 for the timed YAMLs (a
#: probe's checked forward is b2, its timed one b8); the float32 step
#: (with the planted fault) of ``ZOO_STEP_CFGS``, the
#: ``train()`` epoch of ``ZOO_EPOCH_CFGS``, sync-debug "error" on the step
#: of ``ZOO_SYNC_CFGS``, ``detect.run`` of ``ZOO_DETECT_CFGS``; the epoch's
#: image counts
ZOO_BATCH = 2
ZOO_TIMED = ("resnet10-v9.yaml", "resnetaifi.yaml", "res10-ee.yaml", "yolov8s.yaml",
             "ceshi.yaml", "probe-v5", "probe-gelan", "probe-tail", "probe-star",
             "probe-mixer")
ZOO_STEP_CFGS = ("resnet10-v9.yaml", "ceshi.yaml", "probe-gelan", "probe-tail",
                 "probe-star", "probe-mixer")
ZOO_EPOCH_CFGS = ("resnet10-v9.yaml", "yolov8s.yaml")
ZOO_SYNC_CFGS = ("resnet_rtdetr.yaml", "HGresnet.yaml", "probe-v5", "probe-gelan",
                 "probe-tail", "probe-star", "probe-mixer")
ZOO_DETECT_CFGS = ("resnetaifi.yaml", "starnet4.yaml", "probe-v5")
#: a float32 step's gate tighter than ``HEAD_PARAM_GRAD_RTOL``, per YAML
ZOO_F32_RTOL = {"ceshi.yaml": 1e-3}
ZOO_TRAIN_IMAGES, ZOO_VAL_IMAGES = 16, 8


#: the five probe models of the zoo phase: the registry rows no YAML of
#: the JAX package names (ROADMAP Queue 1 items 11g-1 to 11g-3), each set
#: into one of the port's YAMLs at that YAML's own nc, depth, width and anchors (its
#: backbone and head replaced): name -> (base YAML, backbone, head).
#: probe-v5 is yolov5s with Ultralytics' v5.0 and ghost rows (a Focus stem,
#: BottleneckCSP / C3Ghost / GhostConv, BoT3 at P5, SPP for SPPF, C3SPP /
#: CrossConv / MixConv2d in the neck, a strided BottleneckTransformer from
#: P4 to P5); probe-gelan is resnet10 with a
#: Conv_A + zeropad + Pools stem (T-invariant: it runs once at T=1), DSSA /
#: MHSA / SELayer at P5, ASFF3 / ASFF2 fusion, the RepN rows and
#: RepNCSPELAN4 in place of the head's BasicBlock_2 rows, Conv_5 / Conv_6,
#: Contract / Expand.  Its Sum rows add a healthy map to the outputs that
#: are near-constant at init (MHSA's saturated attention behind a BN; the
#: 0.2-gamma BNs closing ASFF3 and ASFF2), so that no neuron behind them
#: stays silent and the float32 step's gradient stays finite (a silent
#: chain of zero-variance BNs overflows it, as in the CPU tests' yolov8s).
#: probe-tail is resnet10 with every row of nn/blocks_tail.py's rest and
#: AKConv: the residual variants down to P5 (Concat_res5's AKConv at P4),
#: C3TR / TransformerBlock at 20 x 20 (their position tables sized at 640
#: px), Bottleneck_1 / BasicBlock_4 / MobileNetV3 / CoT / ScConv /
#: PartialConv at P5, a Bottleneck_2 whose 512-wide output (128 in the
#: parser's record) feeds the Concat back to P4, and a P4 neck of
#: BasicBlock_5 / DualConv / Bottleneck_4 / AKConv fused with P4 by
#: ContextGuideFusionModulev2.  ScConv's output is its input times a
#: softmax over 1024 channels (about 1e-3), so behind it alone
#: Bottleneck_2's four sites stay silent (0.0 on the card), their checks
#: against the plain versions vacuous and their zero-variance BNs blowing
#: the planted fault up to 1e32: a Sum row adds TransformerBlock's map.
#: C3TR closes with a 0.2-gamma BN (Conv_4), so Bottleneck_1's first site
#: behind it fired 5e-6 at b2 and none in the float32 step's batch (the
#: planted fault at 1.8e33): a Sum row adds Concat_res6's map.
#: The pre-norm blocks (BasicBlock_3, Concat_res4) start with training-mode
#: BNs, so right behind the stem's BN they would leave its scale and shift
#: no gradient in exact arithmetic (a BN of a BN), only rounding noise
#: (2.4-2.9 % of a tiny gradient on the card, over the f32 gate):
#: FasterNetBlock (a residual sum) runs between them.
#: probe-star is starnet with the star rows no YAML names (StarBlock,
#: StarBlock_1s / _1 / _3, StarSConv, MStarBlock / _2) down to P5, a
#: TPReLU at P5 and GN at P4, and the C2f hybrids of nn/blocks_tail2.py in
#: the neck (BasicBlock_1C2f's 1024 hidden at P3).  probe-mixer is resnet10
#: with the rest of nn/blocks_tail2.py: the ResNetLayerBo stem, a
#: ResNetBlock whose 256-wide output (64 in the parser's record) feeds
#: HetConv at stride 2 on an even map, BasicBlock_1n / the C3 form of
#: ResNetLayerBo / BasicBlock_1m down to P5, and the attention tail at P5:
#: DynamicConv2d (its gating sites on 3 x 3 and 1 x 1 maps),
#: TransxnetHybridTokenMixer and OSRAAttention (keys on 10 x 10) side by
#: side on Attention's map, summed with it.  In a chain the card showed
#: them silent: a sr 2 OSRAAttention's attention map does not fire at init
#: (its keys come through a 0.2-gamma BN), so the chain behind it saw
#: zeros, and DynamicConv2d's gating neurons fire only on a map whose
#: channels are mostly spiking (Attention's, without a softmax, is one);
#: a silent gate left its BNs zero-variance and the float32 step's biases
#: no gradient
PROBES = {
    "probe-v5": ("yolov5s.yaml", [
        [-1, 1, "Focus", [64, 3]],                    # 0 P1/2
        [-1, 1, "GhostConv", [128, 3, 2]],            # 1 P2/4
        [-1, 3, "BottleneckCSP", [128]],              # 2
        [-1, 1, "Conv_3", [256, 3, 2]],               # 3 P3/8
        [-1, 6, "C3Ghost", [256]],                    # 4
        [-1, 1, "GhostConv", [512, 3, 2]],            # 5 P4/16
        [-1, 9, "BottleneckCSP", [512]],              # 6
        [-1, 1, "Conv_3", [1024, 3, 2]],              # 7 P5/32
        [-1, 3, "BoT3", [1024]],                      # 8
        [-1, 1, "SPP", [1024, [5, 9, 13]]],           # 9
    ], [
        [-1, 1, "DWConv", [512, 3, 1]],               # 10
        [-1, 1, "Sample", ["None", 2, "nearest"]],    # 11
        [[-1, 6], 1, "Concat", [2]],                  # 12
        [-1, 1, "C3SPP", [512, [5, 9, 13]]],          # 13
        [-1, 1, "LightConv", [256, 3]],               # 14
        [-1, 1, "Sample", ["None", 2, "nearest"]],    # 15
        [[-1, 4], 1, "Concat", [2]],                  # 16
        [-1, 1, "CrossConv", [256, 3, 1]],            # 17 P3/8
        [-1, 1, "MixConv2d", [256, [1, 3], 2]],       # 18
        [[-1, 14], 1, "Concat", [2]],                 # 19
        [-1, 1, "GhostBottleneck", [512, 3, 1]],      # 20
        [-1, 1, "ELA", [7]],                          # 21 P4/16
        [-1, 1, "BottleneckTransformer", [512, 2, 4]],  # 22 2x2 average pool
        [[-1, 10], 1, "Concat", [2]],                 # 23
        [-1, 1, "GSConv", [1024, 3, 1]],              # 24
        [-1, 1, "Bottleneck", [1024]],                # 25
        [-1, 1, "ClippedTPReLU", []],                 # 26 P5/32
        [[17, 21, 26], 1, "DDetect", ["nc"]],         # 27
    ]),
    "probe-gelan": ("resnet10.yaml", [
        [-1, 1, "Conv_A", [64, 7, 2]],                # 0 P1/2
        [-1, 1, "zeropad", [[1, 1, 1, 1]]],           # 1
        [-1, 1, "Pools", [3, 2]],                     # 2 P2/4
        [-1, 1, "BasicBlock_2", [64, 3, 1]],          # 3
        [-1, 1, "Concat_res2", [128, 3, 2]],          # 4 P3/8
        [-1, 1, "Concat_res2", [256, 3, 2]],          # 5 P4/16
        [-1, 1, "Concat_res2", [512, 3, 2]],          # 6 P5/32
    ], [
        [-1, 1, "DSSA", [8]],                         # 7
        [-1, 1, "MHSA", [512, 8]],                    # 8
        [[-1, 7], 1, "Sum", [2, True]],               # 9
        [-1, 1, "SELayer", [16]],                     # 10
        [[-1, 5, 4], 1, "ASFF3", [0]],                # 11 P5, with P4 and P3
        [[-1, 10], 1, "Sum", [2]],                    # 12
        [-1, 1, "RepConvN", [512, 3, 1]],             # 13
        [-1, 1, "RepNBottleneck", [512]],             # 14
        [-1, 1, "RepConv", [512]],                    # 15
        [[-1, 5], 1, "ASFF2", [1]],                   # 16 P4, with P5
        [[-1, 5], 1, "Sum", [2]],                     # 17
        [-1, 2, "RepNCSP", [256]],                    # 18
        [-1, 1, "RepNCSPELAN4", [256, 256, 128, 1]],  # 19
        [15, 1, "Expand", [2]],                       # 20 P5 -> P4
        [-1, 1, "Conv_5", [256, 3, 1]],               # 21
        [[19, 21], 1, "Sum", [2]],                    # 22
        [-1, 1, "Conv_B", [256, 3, 1]],               # 23
        [-1, 1, "Conv_6", [256, 3, 1]],               # 24
        [-1, 1, "DepthWiseConv", [256, 3, 1, 1]],     # 25 P4/16
        [5, 1, "Contract", [2]],                      # 26 P4 -> P5
        [-1, 1, "shortcut", [512, 1]],                # 27
        [[-1, 15], 1, "Concat", [2]],                 # 28
        [-1, 1, "RepNCSPELAN4", [512, 512, 256, 1]],  # 29 P5/32
        [[25, 29], 1, "Detect", ["nc", "anchors"]],   # 30
    ]),
    "probe-tail": ("resnet10.yaml", [
        [-1, 1, "Conv_1", [64, 7, 2]],                # 0 P1/2
        [-1, 1, "FasterNetBlock", [2]],               # 1
        [-1, 1, "BasicBlock_3", [64, 3, 2]],          # 2 P2/4
        [-1, 1, "Bottleneck_3", [128, 3, 2]],         # 3 P3/8
        [-1, 1, "Concat_res3", [128, 3, 1]],          # 4
        [-1, 1, "Concat_res4", [256, 3, 2]],          # 5 P4/16
        [-1, 1, "Concat_res5", [256, 3, 1]],          # 6 AKConv, 3 points
        [-1, 1, "Concat_res6", [512, 3, 2]],          # 7 P5/32
        [-1, 1, "C3TR", [512]],                       # 8
    ], [
        [[-1, 7], 1, "Sum", [2]],                     # 9
        [-1, 1, "Bottleneck_1", [512, 1]],            # 10
        [-1, 1, "BasicBlock_4", [512, 3, 1]],         # 11
        [-1, 1, "MobileNetV3", [512, 1024, 3, 1]],    # 12
        [-1, 1, "CoT", [3]],                          # 13
        [-1, 1, "TransformerBlock", [512, 4, 1]],     # 14
        [-1, 1, "ScConv", []],                        # 15
        [[-1, 14], 1, "Sum", [2]],                    # 16
        [-1, 1, "PartialConv", [4, 3, 2]],            # 17 P5/32
        [-1, 1, "Bottleneck_2", [128, 1, 1]],         # 18 512 wide (c2 * e)
        [-1, 1, "Sample", ["None", 2, "nearest"]],    # 19
        [[-1, 6], 1, "Concat", [2]],                  # 20
        [-1, 1, "BasicBlock_5", [256, 3, 1]],         # 21
        [-1, 1, "DualConv", [192, 1, 4]],             # 22
        [-1, 1, "Bottleneck_4", [256, 3, 1]],         # 23
        [-1, 1, "AKConv", [256, 5, 1]],               # 24
        [[-1, 5], 1, "ContextGuideFusionModulev2", [1]],  # 25 P4/16
        [[25, 17], 1, "Detect", ["nc", "anchors"]],   # 26
    ]),
    "probe-star": ("starnet.yaml", [
        [-1, 1, "Conv_1", [64, 7, 2]],                # 0 P1/2
        [-1, 1, "StarSConv", [64, 3, 2]],             # 1 P2/4, pooled shortcut
        [-1, 1, "StarBlock_1s", [128, 3, 2]],         # 2 P3/8, pooled shortcut
        [-1, 1, "StarBlock_3", [256, 3, 2]],          # 3 P4/16, concat shortcut
        [-1, 1, "StarBlock", [256, 3, 1]],            # 4 Conv_3 entry
        [-1, 1, "StarBlock_1", [512, 3, 2]],          # 5 P5/32, 1024 hidden, g=2
    ], [
        [-1, 1, "MStarBlock", [512, 3, 1]],           # 6 identity residual
        [-1, 1, "MStarBlock_2", [256, 3, 1]],         # 7 Shortcut residual
        [-1, 1, "TPReLU", []],                        # 8 P5
        [-1, 1, "Sample", ["None", 2, "nearest"]],    # 9
        [[-1, 4], 1, "Concat", [2]],                  # 10
        [-1, 1, "BasicBlock_2C2f", [256]],            # 11
        [-1, 1, "GN", [16]],                          # 12 P4
        [-1, 1, "Sample", ["None", 2, "nearest"]],    # 13
        [[-1, 2], 1, "Concat", [2]],                  # 14
        [-1, 1, "BasicBlock_1C2f", [128]],            # 15
        [-1, 1, "Concat_res2C2f", [128]],             # 16 P3
        [[16, 12, 8], 1, "Detect", ["nc", "anchors"]],  # 17
    ]),
    "probe-mixer": ("resnet10.yaml", [
        [-1, 1, "ResNetLayerBo", [64, 1, 1, True]],   # 0 7x7/2 stem + 2x2 pool: P2/4
        [-1, 1, "ResNetBlock", [64, 2]],              # 1 P3/8, 256 wide (e=4)
        [-1, 1, "HetConv", [256, 2, 4]],              # 2 P4/16, SAME at stride 2
        [-1, 1, "BasicBlock_1n", [256, 1]],           # 3 1024 hidden, no final BN
        [-1, 1, "ResNetLayerBo", [512, 1, 1, False, 1]],  # 4 the C3 form
        [-1, 1, "BasicBlock_1m", [512, 2]],           # 5 P5/32, RepConv entry
    ], [
        [-1, 1, "Attention", [8]],                    # 6
        [6, 1, "DynamicConv2d", [3, 4, 2]],           # 7
        [6, 1, "TransxnetHybridTokenMixer", [3, 2, 2, 1]],  # 8
        [6, 1, "OSRAAttention", [2, 2]],              # 9 sr 2: kv on 10x10
        [[7, 8, 9, 6], 1, "Sum", [4]],                # 10 P5
        [-1, 1, "Sample", ["None", 2, "nearest"]],    # 11
        [[-1, 4], 1, "Concat", [2]],                  # 12
        [-1, 1, "BasicBlock_2", [256, 3, 1]],         # 13 P4
        [[13, 10], 1, "Detect", ["nc", "anchors"]],   # 14
    ]),
}


#: the probes at 640 px, T=4, nc 13, as ``ZOO_SITES``: (neuron sites, K1,
#: K2 and K6 launches of one eval forward, K5 and K4 launches of one
#: training forward); no site on K2 (``RepNCSPELAN4`` hands ``csp0`` a
#: dense copy, the C2f hybrids and ``TransxnetHybridTokenMixer`` their
#: channel halves; ``AKConv``'s samples are a dense plane); K6 at the
#: ``MHSA`` / ``DSSA`` / ``TransformerBlock`` token sites and
#: ``OSRAAttention``'s / ``DynamicConv2d``'s (also inside the mixer);
#: tests/test_torch_port_blocks_reg.py holds it against the models' hooks
PROBE_SITES = {"probe-v5": (77, 75, 0, 2, 57, 159), "probe-gelan": (74, 72, 0, 2, 24, 192),
               "probe-tail": (48, 46, 0, 2, 15, 123), "probe-star": (46, 46, 0, 0, 21, 117),
               "probe-mixer": (53, 45, 0, 8, 3, 126)}


def probe_cfg(name: str) -> dict:
    """The model dict of probe ``name``: its base YAML (the port's copy)
    with (a copy of) the probe's backbone and head."""
    from ecs_yolo_tpu_torch.models.yolo import load_cfg

    base, backbone, head = copy.deepcopy(PROBES[name])
    return {**load_cfg(base), "backbone": backbone, "head": head}


def cold_graph_ms(fn, x: torch.Tensor, replays: int = 3) -> float:
    """Device time of one call ``fn(x)``, its input read from memory and not
    from L2: ``fn`` over copies of ``x`` (together thrice the L2 cache, at
    least two) captured in one CUDA graph, each output kept until the graph
    ends, and the graph replayed ``replays`` times after a warm-up
    replay."""
    l2 = getattr(torch.cuda.get_device_properties(x.device), "L2_cache_size", 50 << 20)
    copies = [x.clone() for _ in range(max(2, math.ceil(3 * l2 / (x.numel() * x.element_size()))))]
    fn(copies[0])
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = [fn(c) for c in copies]
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(replays):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    del g, outs
    return t0.elapsed_time(t1) / (len(copies) * replays)


def zoo_site_check(FZ, BS, m, xin, plain_kernels, kind: str, log) -> dict:
    """One site of a timed zoo forward (b8) timed alone on its real input
    beside its plain version and the function's bound: K2 at ``res10-ee``'s
    stem (``rows_bound``, x a broadcast; events over 5 calls, as
    ``phase_k2``), K6 at an ``AIFI`` token site (x read once, spikes written
    once, five operations an element and step; ``ms`` the device time of
    calls replayed in a CUDA graph over copies of x that each call reads
    from memory, ``cold_graph_ms``; ``l2_warm_ms`` the same calls on one x,
    which stays in L2 between them; ``wrapper_ms`` the calls eager)."""
    shape = tuple(xin.shape)
    bcast = xin.stride(0) == 0
    item = itemsize(xin.dtype)
    if kind == "ecs_lif_fused_rows":
        args = (xin, *m.spread_params(), m.snn, m.act)
        call, plain = (lambda: FZ.ecs_lif_fused_rows(*args),
                       lambda: FZ.ecs_lif_rows_reference(*args))
        bounds = rows_bound(shape, bcast, xin.dtype)
    else:
        call, plain = (lambda: FZ.lif_fused(xin, m.snn)), (lambda: FZ.lif_reference(xin, m.snn))
        n = math.prod(shape[1:])
        bms, by = bound(((1 if bcast else shape[0]) + shape[0]) * n * item,
                        5 * math.prod(shape), torch.float32)
        bounds = {"bound_ms": bms, "bound_by": by}
    with torch.no_grad():
        got = call()
        with plain_kernels():
            want = plain()
        ms = cuda_ms(call, 5)
        plain_ms = cuda_ms(plain, 2)
        extra = {}
        if kind == "lif_fused":
            extra = {"wrapper_ms": ms, "l2_warm_ms": BS.graph_ms(call)}
            ms = cold_graph_ms(lambda x: FZ.lif_fused(x, m.snn), xin)
    rec = {"phase": "zoo_kernel_check", "kernel": kind, "dtype": dname(xin.dtype),
           "shape": list(shape), "x_broadcast_over_t": bcast,
           "mismatch_share": float((got != want).float().mean()),
           "max_abs_err": float((got.float() - want.float()).abs().max()),
           "firing_rate": float(want.float().mean()), "ms": ms, "plain_ms": plain_ms,
           **extra, **bounds, "ms_over_bound": ms / bounds["bound_ms"], "library_ms": None}
    emit(rec, log)
    bar = SPIKE_BOUND[xin.dtype] if kind == "ecs_lif_fused_rows" else 0.0
    if rec["mismatch_share"] > bar:
        raise AssertionError(f"{kind} disagrees at a zoo site: {rec}")
    return rec


def zoo_narrow_spread(S, BS, log) -> dict:
    """K4 at the training spread of the 3-channel site on the raw image
    (``res10-ee``'s stem, C % 8 != 0: the wrapper zero-pads the channels to
    8): one step's b``ZOO_BATCH`` bf16 plane at 640 px against the plain
    version (``check_spread``), timed beside it and the function's bound
    (the C = 3 plane read, its output and int8 plane written; 18 operations
    an element), and the gradients in float32 (``phase_spread_grads``).
    ``ms``: the wrapper's calls (pads and launch) replayed in a CUDA graph;
    ``padded_launch_ms`` the launch alone on planes padded beforehand;
    ``wrapper_ms`` the calls eager; ``library_ms`` / ``library_eager_ms``
    the library's depthwise conv of the same C = 3 plane (``F.conv2d(groups
    = 3)`` with bias, channels_last, as ``phase_spread`` times it at the
    other K4 sites) replayed and eager."""
    import torch.nn.functional as F

    shape = (ZOO_BATCH, IMGSZ, IMGSZ, 3)
    s, dw, dwb = spread_inputs(shape, torch.bfloat16, seed=9)[:3]
    padded = [F.pad(t, (0, 5)) for t in (s, dw, dwb)]
    call, plain = (lambda: S.binary_dw3_conv(s, dw, dwb),
                   lambda: S.binary_dw3_conv_reference(s, dw, dwb))
    s_n, kd = s.permute(0, 3, 1, 2), dw.permute(3, 2, 0, 1).contiguous()
    lib = lambda: F.conv2d(s_n, kd, dwb, padding=1, groups=3)
    with torch.no_grad():
        got, want = call(), plain()
        ms, wrapper_ms, plain_ms = BS.graph_ms(call), cuda_ms(call, 5), cuda_ms(plain, 5)
        launch_ms = BS.graph_ms(lambda: S._dw3_kernel(*padded))
        library_ms, library_eager_ms = BS.graph_ms(lib), cuda_ms(lib, 5)
    n = math.prod(shape)
    bms, by = bound(n * (2 + 2 + 1), 18 * n, torch.bfloat16)
    rec = {"phase": "zoo_kernel_check", "kernel": "binary_dw3_conv", "shape": list(shape),
           "dtype": "bfloat16", "channels_padded_to": 8,
           **check_spread("binary_dw3_conv", got, want, torch.bfloat16),
           "ms": ms, "padded_launch_ms": launch_ms, "wrapper_ms": wrapper_ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "library_eager_ms": library_eager_ms,
           "bound_ms": bms, "bound_by": by, "ms_over_bound": ms / bms}
    emit(rec, log)
    phase_spread_grads(S, log, [shape])
    return rec


def zoo_launches(zoo: dict, kernel: str) -> dict:
    """Per zoo YAML, ``kernel``'s launches in one eval forward."""
    return {c: m["launches_per_forward"][kernel] for c, m in zoo["models"].items()}


def zoo_sites_sum(recs) -> dict:
    """The shape, and the device (and eager ``wrapper_ms``, where timed),
    plain and bound ms summed, of ``zoo_site_check`` records."""
    out = {"shape": recs[0]["shape"], "sites": len(recs),
           "x_broadcast_over_t": recs[0]["x_broadcast_over_t"],
           "mismatch_share": max(r["mismatch_share"] for r in recs),
           "bound_by": recs[0]["bound_by"]}
    for key in ("ms", "l2_warm_ms", "wrapper_ms", "plain_ms", "bound_ms"):
        if key in recs[0]:
            out[key] = sum(r[key] for r in recs)
    return out


def phase_zoo(seed: int, root: Path, log) -> dict:
    """The block library's YAMLs on the card (``ZOO_SITES``) and the five
    probe models of the registry rows no YAML names (``PROBES``,
    ``PROBE_SITES``), 640 px, nc 13, T=4, bf16 parameters with float32 BN
    statistics, random weights from ``seed``, BN calibrated on the batch.

    Each model: one eval forward (b``ZOO_BATCH``; b8 for the YAMLs of
    ``ZOO_TIMED``) with every neuron site held to the plain version of its
    kernel on its real input (K1 and K2 spike shares within
    ``SPIKE_BOUND``, SiLU sites within ``LIF_SILU_ULPS_BF16``, the
    ``TokenLIF`` sites on K6 equal) and its K1 / K2 / K6 launches equal to
    the table; one b``ZOO_BATCH`` bf16
    train step, its K4 / K5 launches equal to the table and its peak
    memory.  ``ZOO_TIMED``: the b8 forward timed and profiled;
    ``res10-ee``'s K2 stem site and the K6 token sites of ``resnetaifi``
    and of the probes' ``MHSA`` / ``DSSA`` / ``TransformerBlock`` timed
    beside their plain versions and bounds (``zoo_site_check``; a probe's at the b2 check's
    inputs).
    ``ZOO_DETECT_CFGS``: ``detect.run`` over 4 synthetic images.
    ``ZOO_STEP_CFGS``: the float32 step teacher-forced against its
    ``plain_kernels()`` rerun with the planted K4 fault
    (``f32_step_check``; ``ZOO_F32_RTOL`` gates some tighter).
    ``ZOO_EPOCH_CFGS``: one ``train.driver.train`` epoch whose EMA val pass
    must give ``plain_kernels()``'s NMS output.  ``ZOO_SYNC_CFGS``: the bf16
    step through ``timed_steps`` (one step under
    ``torch.cuda.set_sync_debug_mode("error")``)."""
    from ecs_yolo_tpu_torch import detect as detect_mod
    from ecs_yolo_tpu_torch import val as val_mod
    from ecs_yolo_tpu_torch.data.hyps import HYP_SCRATCH
    from ecs_yolo_tpu_torch.data.loaders import LoadImages
    from ecs_yolo_tpu_torch.models.yolo import cast_params, head_predictions
    from ecs_yolo_tpu_torch.nn.blocks import MemUpdate, _BN
    from ecs_yolo_tpu_torch.nn.blocks_ext import TokenLIF
    from ecs_yolo_tpu_torch.scripts import bench_spread as BS
    from ecs_yolo_tpu_torch.snn import fused as FZ
    from ecs_yolo_tpu_torch.snn import spread as S
    from ecs_yolo_tpu_torch.snn.route import plain_kernels
    from ecs_yolo_tpu_torch.train import driver
    from ecs_yolo_tpu_torch.train.optim import build_optimizer
    from ecs_yolo_tpu_torch.train.trainer import create_train_state, make_train_step

    t_phase = time.perf_counter()
    hyp = dict(HYP_SCRATCH)
    reset, read = launch_counters()
    (root / "detect").mkdir(parents=True)
    write_images(root / "detect")
    ims = [im for _, im, _ in LoadImages(str(root / "detect"), IMGSZ)]    # already in 0-1
    xb = torch.from_numpy(np.concatenate(ims * 2)).cuda()
    batch = train_batch(seed=5)
    out = {"models": {}, "stem": None, "tokens": [], "probe_tokens": {c: [] for c in PROBES}}
    out["k4_narrow"] = zoo_narrow_spread(S, BS, log)
    t_probes = None
    for j, (cfg, (n_sites, k1, k2, k6, gemm, dw3)) in enumerate(
            {**ZOO_SITES, **PROBE_SITES}.items()):
        t0 = time.perf_counter()
        if cfg in PROBES and t_probes is None:
            t_probes = t0
        b = N if cfg in ZOO_TIMED and cfg not in PROBES else ZOO_BATCH
        model = head_model(probe_cfg(cfg) if cfg in PROBES else cfg, seed + 60 + j,
                           xb[:ZOO_BATCH], _BN)
        sites = [m for m in model.modules() if isinstance(m, (MemUpdate, TokenLIF))]
        mem_sites = [m for m in sites if isinstance(m, MemUpdate)]
        state32 = ({k: v.detach().clone() for k, v in model.state_dict().items()}
                   if cfg in ZOO_STEP_CFGS else None)
        cast_params(model, torch.bfloat16)
        reset()
        with torch.no_grad():
            pred_out, seen = captured_sites(sites, lambda: model(xb[:b]))
        fwd = read()
        mem = [r for r in seen if isinstance(r[0], MemUpdate)]
        tok = [r for r in seen if isinstance(r[0], TokenLIF)]
        shares, silu = site_errors(mem, plain_kernels)
        with plain_kernels(), torch.no_grad():
            tok_shares = [float((o != m(xin)).float().mean()) for m, xin, o in tok]
        pred = head_predictions(model.head_info["name"], pred_out, NC)
        rec = {"phase": "zoo_forward", "cfg": cfg, "head": model.head_info["name"],
               "batch": b, "dtype": "bfloat16", "sites": len(seen), "silu_sites": len(silu),
               "token_sites": len(tok), "launches_per_forward": fwd,
               "worst_site_mismatch_share": max(shares, default=0.0),
               "worst_site_silu_err": max(silu, default=0.0), "silu_err_unit": "bf16 ulps",
               "worst_token_site_mismatch_share": max(tok_shares, default=0.0),
               "shapes": [[list(k), v] for k, v in sorted(Counter(
                   tuple(xin.shape[2:]) for _, xin, _ in seen).items(), reverse=True)],
               "prediction_shape": list(pred.shape),
               "prediction_finite": bool(torch.isfinite(pred).all())}
        if cfg in PROBES:       # what each site of the new rows fires
            names = {id(m): n for n, m in model.named_modules()}
            rec["site_firing_rates"] = [[names[id(m)], float(o.float().mean())]
                                        for m, _, o in seen]
        want = {"ecs_lif_fused": k1, "ecs_lif_fused_rows": k2, "lif_fused": k6,
                "binary_dw3_conv": 0, "packed_spread": 0}
        ok = (len(seen) == n_sites and sites_ok(shares, silu, torch.bfloat16)
              and max(tok_shares, default=0.0) == 0.0 and fwd == want
              and rec["prediction_finite"])
        mrec = {"launches_per_forward": fwd, "batch": b}
        if cfg in ZOO_TIMED:
            with torch.no_grad():
                ms = cuda_ms(lambda: model(xb), reps=5)
                prof = profile_step(lambda: model(xb))
            rec.update({"ms_per_forward": ms, "images_per_s": N / ms * 1e3, **prof})
            mrec.update(forward_ms=ms, images_per_s=N / ms * 1e3,
                        idle_share=prof.get("idle_share"))
            for m, xin, _ in seen:
                if isinstance(m, MemUpdate) and xin.shape[-1] % 8:
                    out["stem"] = zoo_site_check(FZ, BS, m, xin, plain_kernels,
                                                 "ecs_lif_fused_rows", log)
                    rec["k2_stem_ms"] = out["stem"]["ms"]
                    rec["k2_stem_bound_ms"] = out["stem"]["bound_ms"]
                elif isinstance(m, TokenLIF):
                    tokens = out["probe_tokens"][cfg] if cfg in PROBES else out["tokens"]
                    tokens.append(zoo_site_check(FZ, BS, m, xin, plain_kernels,
                                                 "lif_fused", log))
        del seen, mem, tok
        emit(rec, log)
        if not ok:
            raise AssertionError(f"{cfg}: a site disagrees or a launch count is off: {rec}")

        if cfg in ZOO_DETECT_CFGS:
            reset()
            results = detect_mod.run(model, root / "detect", imgsz=IMGSZ)
            det = read()
            rec = {"phase": "zoo_detect", "cfg": cfg, "images": len(results),
                   "detections": [int(len(d)) for _, d in results], "launches": det,
                   "finite": all(bool(np.isfinite(d).all()) for _, d in results)}
            emit(rec, log)
            mrec["detect_launches"] = det
            if (not rec["finite"] or len(results) != 4
                    or det != {k: v * 4 for k, v in want.items()}):
                raise AssertionError(f"{cfg} detect.run failed its checks: {rec}")

        # --- training: master parameters back in float32 --------------------------
        for p in model.parameters():
            p.data = p.data.float()
        small = tuple(t[:ZOO_BATCH] for t in batch)
        if cfg in ZOO_STEP_CFGS:
            model.load_state_dict(state32)
            rec, tx, state = f32_step_check(model, small, mem_sites, plain_kernels, hyp,
                                            plant=True, layer_scaled=cfg in PROBES)
            rtol = ZOO_F32_RTOL.get(cfg, HEAD_PARAM_GRAD_RTOL)
            rec["zoo_param_grad_rtol"] = rtol
            emit({"phase": "zoo_train_step_fp32", "cfg": cfg, "batch": ZOO_BATCH, **rec}, log)
            if not rec["ok"] or rec["param_grad_rel_err_max"] > rtol:
                raise AssertionError(f"{cfg} float32 step: kernel route disagrees: {rec}")
            del state32
        else:
            tx = build_optimizer(dict(model.named_parameters()), lr0=hyp["lr0"],
                                 momentum=hyp["momentum"], weight_decay=hyp["weight_decay"])
            state = create_train_state(model, tx)
        step = make_train_step(model, tx, hyp, compute_dtype=torch.bfloat16)
        if cfg in ZOO_SYNC_CFGS:
            state, srec = timed_steps(step, state, small, 1, read, reset)
            per, peak, losses = srec["launches_per_step"], srec["peak_memory_gb"], srec["losses"]
        else:       # the first step: its launches, and its peak with cuDNN's workspaces
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset()
            state, metrics = step(state, *small)
            torch.cuda.synchronize()
            per, peak = read(), torch.cuda.max_memory_allocated() / 1e9
            losses, srec = [float(metrics["loss"])], {}
        rec = {"phase": "zoo_train_step", "cfg": cfg, "batch": ZOO_BATCH, "dtype": "bfloat16",
               "launches_per_step": per, "peak_memory_gb": peak, "losses": losses,
               **{k: v for k, v in srec.items() if k not in ("launches_per_step",
                                                           "peak_memory_gb", "losses")}}
        emit(rec, log)
        mrec["step"] = rec
        if (not all(math.isfinite(v) for v in losses) or per["binary_dw3_conv"] != dw3
                or per["packed_spread"] != gemm or per["ecs_lif_fused"]
                or per["ecs_lif_fused_rows"] or per["lif_fused"]):
            raise AssertionError(f"{cfg} bf16 step failed its checks: {rec}")
        mrec["seconds"] = time.perf_counter() - t0
        out["models"][cfg] = mrec
        emit({"phase": "zoo_model_seconds", "cfg": cfg, "seconds": mrec["seconds"]}, log)
        del model, state, step, tx, sites, mem_sites, pred_out, pred
        torch.cuda.empty_cache()
    del xb, batch
    out["probes_seconds"] = time.perf_counter() - t_probes
    emit({"phase": "zoo_probes_seconds", "seconds": out["probes_seconds"]}, log)

    # --- an epoch of train.driver.train each, val on the EMA copy ---------------------
    train_src = write_val_set(root / "train", seed + 500, ZOO_TRAIN_IMAGES)
    val_src = write_val_set(root / "val", seed + 501, ZOO_VAL_IMAGES)
    out["train_run"] = {}
    for j, cfg in enumerate(ZOO_EPOCH_CFGS):
        h, launches, res, cmp, forwards = epoch_with_val(
            driver, val_mod, plain_kernels, reset, read, cfg=cfg, train_path=train_src,
            val_path=val_src, nc=NC, batch_size=N, imgsz=IMGSZ, nbs=N, bf16=True, seed=seed,
            workers=4, save_dir=str(root / f"run{j}"))
        _, _, _, _, gemm, dw3 = ZOO_SITES[cfg]
        rec = {"phase": "zoo_train_run", "cfg": cfg, "images": ZOO_TRAIN_IMAGES,
               "batch": N, "loop_s": h["train_s"], "val_s": h["val_s"],
               "images_per_s": ZOO_TRAIN_IMAGES / h["train_s"],
               "micro_steps": h["micro_steps"], "mloss": h["mloss"],
               "loss_finite": h["loss_finite"], "launches": launches,
               "val_seen": res["seen"], "val_forwards": forwards, **cmp}
        emit(rec, log)
        out["train_run"][cfg] = rec
        if (not h["loss_finite"] or h["micro_steps"] != ZOO_TRAIN_IMAGES // N
                or res["seen"] != ZOO_VAL_IMAGES or not cmp["val_equal"]
                or launches["binary_dw3_conv"] != dw3 * h["micro_steps"]
                or launches["packed_spread"] != gemm * h["micro_steps"]):
            raise AssertionError(f"{cfg} train() epoch failed its checks: {rec}")
    if (out["stem"] is None or len(out["tokens"]) != ZOO_SITES["resnetaifi.yaml"][3]
            or any(len(out["probe_tokens"][c]) != PROBE_SITES[c][3] for c in PROBES)):
        raise AssertionError("zoo: the K2 stem site or the K6 token sites were not timed")
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "zoo_seconds", "seconds": out["seconds"]}, log)
    return out


#: the RT-DETR loss and NMS variants phase: batch, queries, classes, the most
#: ground truths an image (padded to it); the NMS candidate pool
RTDETR_B, RTDETR_Q, RTDETR_M, NMS_POOL = 8, 300, 50, 1000


def wall_ms(fn, reps: int) -> float:
    """Mean wall time of ``fn`` (which may wait on the host) over ``reps``
    calls after one warm-up, the card synchronised around them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_rtdetr_nms(seed: int, log) -> dict:
    """ROADMAP item 11g-4 on the card: ``train/rtdetr.rtdetr_loss`` on
    random logits ``[8, 300, 13]`` and boxes with 5 to 50 ground truths an
    image (padded to 50), forward and backward, against the port's own CPU
    run of the same inputs (the assignment equal, each loss item within
    1e-5 relative, each gradient within 1e-4 of its norm), its wall ms a
    call and the share of it the host's assignment solver takes; the five
    ``ops/nms_variants`` functions on one 1000-box pool with tied scores,
    each against its CPU run (order and keep mask equal, soft-NMS's picks
    equal and scores within 1e-5 relative), ``cluster_nms``'s keep set
    against ``ops/nms.py``'s greedy walk over the same sorted pool at the
    same threshold, and each variant's wall ms an image."""
    from ecs_yolo_tpu_torch.ops import nms as NMS
    from ecs_yolo_tpu_torch.ops import nms_variants as NV
    from ecs_yolo_tpu_torch.train import rtdetr as RT

    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(seed + 700)
    b, q, m, nc = RTDETR_B, RTDETR_Q, RTDETR_M, NC
    logits = torch.randn(b, q, nc, generator=g)
    xy = torch.rand(b, q, 2, generator=g) * 0.6 + 0.2
    boxes = torch.cat([xy, torch.rand(b, q, 2, generator=g) * 0.25 + 0.05], -1)
    counts = torch.randint(5, m + 1, (b,), generator=g)
    mask = torch.arange(m)[None] < counts[:, None]
    labels = torch.where(mask, torch.randint(0, nc, (b, m), generator=g), -1).float()
    gxy = torch.rand(b, m, 2, generator=g) * 0.6 + 0.2
    gt = torch.cat([gxy, torch.rand(b, m, 2, generator=g) * 0.25 + 0.05], -1) * mask[..., None]

    def run(dev):
        s = logits.to(dev, copy=True).requires_grad_(True)
        bx = boxes.to(dev, copy=True).requires_grad_(True)
        total, items = RT.rtdetr_loss(s, bx, labels.to(dev), gt.to(dev), mask.to(dev), nc)
        total.backward()
        return total, items, s.grad, bx.grad

    want = run("cpu")
    got = run("cuda")
    with torch.no_grad():
        rows_c, match_c = RT.hungarian_match(torch.sigmoid(logits), boxes, labels, gt, mask)
        rows_g, match_g = RT.hungarian_match(torch.sigmoid(logits).cuda(), boxes.cuda(),
                                             labels.cuda(), gt.cuda(), mask.cuda())
    solver_s = [0.0]
    real = RT._lsa_host

    def timed_lsa(cost):
        t0 = time.perf_counter()
        out = real(cost)
        solver_s[0] += time.perf_counter() - t0
        return out

    RT._lsa_host = timed_lsa
    try:
        reps = 5
        ms = wall_ms(lambda: run("cuda"), reps)
    finally:
        RT._lsa_host = real
    solver_ms = solver_s[0] * 1e3 / (reps + 1)
    item_err = ((got[1].cpu() - want[1]).abs() / want[1].abs()).tolist()
    grad_err = [float((a.cpu() - w).norm() / w.norm()) for a, w in zip(got[2:], want[2:])]
    rec = {"phase": "rtdetr_loss", "batch": b, "queries": q, "classes": nc,
           "ground_truths": counts.tolist(), "dtype": "float32",
           "assignment_equal": bool(torch.equal(rows_g.cpu(), rows_c)
                                    and torch.equal(match_g.cpu(), match_c)),
           "matches": int(match_c.sum()), "items": got[1].tolist(),
           "items_cpu": want[1].tolist(), "item_rel_err": item_err,
           "grad_rel_err": grad_err, "ms_per_call": ms, "solver_ms_per_call": solver_ms,
           "host_solver_share": solver_ms / ms,
           "note": "ms: wall of rtdetr_loss forward and backward at b8, the costs' one copy "
                   "to the host and the assignment's back included; host_solver_share: "
                   "scipy's linear_sum_assignment over the 8 cost matrices"}
    emit(rec, log)
    if (not rec["assignment_equal"] or max(item_err) > 1e-5 or max(grad_err) > 1e-4
            or not math.isfinite(got[0].item())):
        raise AssertionError(f"rtdetr_loss on the card disagrees with the CPU: {rec}")

    # --- the NMS variants on one candidate pool ----------------------------------------
    n = NMS_POOL
    centres = torch.rand(40, 2, generator=g) * 560
    cxy = centres[torch.randint(0, 40, (n,), generator=g)] + torch.randn(n, 2, generator=g) * 15
    pool = torch.cat([cxy, cxy + torch.rand(n, 2, generator=g) * 100 + 20], -1)
    scores = torch.round(torch.rand(n, generator=g) * 100) / 100        # ties
    pool_g, scores_g = pool.cuda(), scores.cuda()
    out = {"rtdetr_loss": rec, "nms": {}}
    for name in ("cluster_nms", "cluster_diou_nms", "cluster_spm_nms", "cluster_spm_dist_nms",
                 "soft_nms"):
        fn = getattr(NV, name)
        first, second = fn(pool_g, scores_g)
        first_c, second_c = fn(pool, scores)
        if name == "soft_nms":
            ok = (torch.equal(first.cpu(), first_c)
                  and torch.allclose(second.cpu(), second_c, rtol=1e-5, atol=1e-7))
        else:
            ok = torch.equal(first.cpu(), first_c) and torch.equal(second.cpu(), second_c)
        r = {"phase": "nms_variant", "name": name, "boxes": n, "cpu_equal": bool(ok),
             "kept": int((second > 0).sum()),
             "ms_per_image": wall_ms(lambda: fn(pool_g, scores_g), 3)}
        if name == "cluster_nms":
            pos = first[scores_g[first] > 0]
            supp = (NMS._pair_iou(pool_g[pos], pool_g[pos]) > 0.5).cpu().numpy()
            greedy = pos[NMS._greedy(supp, len(pos))]
            r["greedy_equal"] = bool(torch.equal(first[second], greedy))
            ok &= r["greedy_equal"]
        emit(r, log)
        out["nms"][name] = r
        if not ok:
            raise AssertionError(f"{name} on the card disagrees: {r}")
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "rtdetr_nms_seconds", "seconds": out["seconds"]}, log)
    return out


#: the parallel phase: images of the grouped train() epoch's set and of its
#: val split, timed steps a route
PAR_IMAGES, PAR_STEPS = 16, 3


def phase_parallel(seed: int, root: Path, log) -> dict:
    """The process-group paths (``ecs_yolo_tpu_torch/parallel``) on the one
    card: an NCCL group of world 1 joined in this process through a
    ``file://`` store (``parallel/multihost.initialize``), destroyed at the
    end whatever happens.

    * the res10 b8 bf16 SGD step under the group (``make_train_step(
      layout=)``: the gradients in one flat all-reduce over the data group,
      the loss and items in another) from the same state and batch as the
      plain step (cuDNN deterministic, a first plain step kept apart, a last
      one for the run-to-run floor): loss, items, every parameter, the
      momentum (the step's gradient plus the weight decay, at the first
      step), EMA and BN statistics bit-equal; the same under
      ``model_parallel = 1`` through ``shard_state`` / ``gather_state``;
      both steps timed in turns, plain, grouped, grouped, plain
      (``timed_steps``: ms, 57 K4 + 15 K5 launches a step as the plain
      step, peak memory, one step under ``set_sync_debug_mode("error")``,
      profiled: the NCCL kernels' device ms, none where a one-rank
      all-reduce in place launches none); the gradient bytes a step;
    * one ``train.driver.train`` epoch under the group (``epoch_with_val``,
      ``PAR_IMAGES`` images, b8, bf16): one run directory with its
      checkpoint; its sharded val pass on the EMA copy held to ``val.run``
      of the checkpoint's EMA parameters without the group;
    * ``val.run`` of that model under the group on the ``PAR_IMAGES``-image
      split against the same pass without it: NMS outputs and metrics
      equal, K1 at all 24 sites of every forward."""
    import torch.distributed as dist

    from ecs_yolo_tpu_torch import val as val_mod
    from ecs_yolo_tpu_torch.data.hyps import HYP_SCRATCH
    from ecs_yolo_tpu_torch.models.yolo import build_model
    from ecs_yolo_tpu_torch.parallel import mesh, multihost
    from ecs_yolo_tpu_torch.snn.route import plain_kernels
    from ecs_yolo_tpu_torch.train import driver
    from ecs_yolo_tpu_torch.train.optim import build_optimizer
    from ecs_yolo_tpu_torch.train.trainer import create_train_state, make_train_step
    from ecs_yolo_tpu_torch.utils.checkpoint import eval_state_dict, load_checkpoint

    t_phase = time.perf_counter()
    reset, read = launch_counters()
    hyp, bf16 = dict(HYP_SCRATCH), torch.bfloat16
    root.mkdir(parents=True, exist_ok=True)
    out = {}
    multihost.initialize(init_method=f"file://{root}/store", world_size=1, rank=0,
                         device="cuda")
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        layout = mesh.make_layout(1)
        model = build_model("resnet10.yaml", nc=NC,
                            generator=torch.Generator().manual_seed(seed + 41))
        sd0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
        tx = build_optimizer(
            dict(model.named_parameters()), name="SGD", lr0=hyp["lr0"], lrf=hyp["lrf"],
            momentum=hyp["momentum"], weight_decay=hyp["weight_decay"], epochs=300,
            steps_per_epoch=1000, warmup_epochs=hyp["warmup_epochs"],
            warmup_momentum=hyp["warmup_momentum"], warmup_bias_lr=hyp["warmup_bias_lr"])
        batch = train_batch(seed=seed + 42)
        routes = {"plain": {}, "grouped": dict(layout=layout),
                  "model_parallel_1": dict(layout=layout, plan=mesh.shard_plan(model, 1))}

        def fresh(kw):
            model.load_state_dict(sd0)
            state = mesh.shard_state(create_train_state(model, tx), kw.get("plan", {}),
                                     kw.get("layout"))
            return state, make_train_step(model, tx, hyp, compute_dtype=bf16, **kw)

        def one(kw) -> dict:
            state, step = fresh(kw)
            state, m = step(state, *batch)
            state = mesh.gather_state(state, kw.get("plan", {}), kw.get("layout"))
            torch.cuda.synchronize()
            snap = {"loss": m["loss"].clone(), "items": m["items"].clone()}
            for tag, tree in (("sd", model.state_dict()), ("ema", state.ema_params),
                              ("mu", state.opt_state.mu)):
                snap.update({f"{tag}.{k}": v.detach().clone() for k, v in tree.items()})
            return snap

        snaps = {"warmup": one({})}
        for name, kw in routes.items():
            snaps[name] = one(kw)
        snaps["plain_again"] = one({})
        rec = {"phase": "parallel_step", "backend": dist.get_backend(),
               "world": dist.get_world_size(), "cfg": "resnet10.yaml", "batch": N,
               "imgsz": IMGSZ, "T": T, "dtype": "bfloat16", "cudnn_deterministic": True,
               "grad_bytes_per_step": sum(p.numel() * 4 for p in model.parameters()),
               "grad_all_reduces_per_step": 1,
               "plain_repeats_bit_for_bit": max_diff(snaps["plain_again"], snaps["plain"]) == 0,
               "compared": len(snaps["plain"])}
        for name in ("grouped", "model_parallel_1"):
            rec[f"{name}_bit_equal_to_plain"] = all(
                torch.equal(v, snaps[name][k]) for k, v in snaps["plain"].items())
            rec[f"{name}_max_abs_diff_to_plain"] = max_diff(snaps[name], snaps["plain"])
        del snaps
        turns = []      # in turns, the host's pace drifts between calls
        for name in ("plain", "grouped", "grouped", "plain"):
            state, step = fresh(routes[name])
            _, rec[name] = timed_steps(step, state, batch, PAR_STEPS, read, reset)
            turns.append([name, rec[name]["ms_per_step"], rec[name]["device_ms"]])
            del state, step
        rec["turns_ms_per_step_and_device_ms"] = turns
        emit(rec, log)
        want = {"ecs_lif_fused": 0, "ecs_lif_fused_rows": 0, "lif_fused": 0,
                "binary_dw3_conv": 57, "packed_spread": 15}
        if (not rec["grouped_bit_equal_to_plain"]
                or not rec["model_parallel_1_bit_equal_to_plain"]
                or rec["plain"]["launches_per_step"] != want
                or rec["grouped"]["launches_per_step"] != want
                or rec["world"] != 1 or rec["backend"] != "nccl"):
            raise AssertionError(f"parallel: the grouped step is not the plain step: {rec}")
        out["step"] = rec
        del model

        # --- one train() epoch under the group ---------------------------------
        train_src = write_val_set(root / "train", seed + 200, PAR_IMAGES)
        val_src = write_val_set(root / "val", seed + 300, PAR_IMAGES)
        passes = []
        h, launches, res, cmp, forwards = epoch_with_val(
            driver, val_mod, plain_kernels, reset, read, record=passes, cfg="resnet10.yaml",
            train_path=str(train_src), val_path=str(val_src), nc=NC, batch_size=N,
            imgsz=IMGSZ, nbs=N, bf16=True, seed=seed, workers=4,
            save_dir=str(root / "run" / "exp"))
        runs = sorted(p.name for p in (root / "run").iterdir())
        weights = sorted(p.name for p in (root / "run" / "exp" / "weights").iterdir())
        tree, meta = load_checkpoint(root / "run" / "exp" / "weights" / "last.pt")
        served = build_model("resnet10.yaml", nc=NC)
        served.load_state_dict(eval_state_dict(tree), strict=True)

        def val_run():
            return val_mod.run(served, str(val_src), imgsz=IMGSZ, batch_size=N, dtype=bf16)

        reset()
        res_g, outs_g = recorded_nms(val_mod, val_run)
        torch.cuda.synchronize()
        k1_g = read()["ecs_lif_fused"]
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
        dist.destroy_process_group()
    res_u, outs_u = recorded_nms(val_mod, val_run)
    metrics = ("mp", "mr", "map50", "map", "fitness", "seen")

    def same(r, outs, ref, ref_outs) -> bool:
        return (all(r[k] == ref[k] for k in metrics) and len(outs) == len(ref_outs)
                and all(torch.equal(a, c) and torch.equal(b, d)
                        for (a, b), (c, d) in zip(outs, ref_outs)))

    epoch_res, epoch_outs = passes[0][3], passes[0][4]
    rec = {"phase": "parallel_train_run", "images": PAR_IMAGES, "batch": N,
           "loop_s": h["train_s"], "val_s": h["val_s"], "ckpt_s": h["ckpt_s"],
           "micro_steps": h["micro_steps"], "applies": h["applies"],
           "loop_launches": launches, "run_dirs": runs, "weights": weights,
           "ckpt_meta_imgsz": meta.get("imgsz"),
           "val": {k: res[k] for k in metrics}, "val_forwards": forwards, **cmp,
           "epoch_val_equal_to_val_without_group": same(epoch_res, epoch_outs, res_u, outs_u)}
    emit(rec, log)
    if (runs != ["exp"] or "last.pt" not in weights or not rec["val_equal"]
            or not rec["epoch_val_equal_to_val_without_group"]
            or launches["binary_dw3_conv"] != 57 * h["micro_steps"]):
        raise AssertionError(f"parallel: the grouped train() epoch failed its checks: {rec}")
    out["train_run"] = rec
    rec = {"phase": "parallel_val", "images": PAR_IMAGES, "batch": N, "dtype": "bfloat16",
           "grouped": {k: res_g[k] for k in metrics},
           "without_group": {k: res_u[k] for k in metrics},
           "forwards": len(outs_g), "k1_launches": k1_g,
           "equal": same(res_g, outs_g, res_u, outs_u),
           "seconds": time.perf_counter() - t_phase}
    emit(rec, log)
    if not rec["equal"] or k1_g != 24 * len(outs_g) or not outs_g:
        raise AssertionError(f"parallel: grouped val.run differs from the plain pass: {rec}")
    out["val"] = rec
    return out


#: the tooling phase: (YAML, SNNConfig fields, the kernel counted, its
#: launches a forward) of each exported model; res10-ee's stem site is K2's
#: (ZOO_SITES), its other 21 sites K1's
TOOL_MODELS = (("resnet10.yaml", {}, "ecs_lif_fused", 24),
               ("resnet10.yaml", {"ecs": False}, "lif_fused", 24),
               ("res10-ee.yaml", {}, "ecs_lif_fused_rows", 1))
TOOL_IMAGES, TOOL_FORMATS, TOOL_WARM_CALLS = 16, ("torchscript", "pt2"), 3


TOOLING_NOTE = ("tooling_launches_per_forward: one b8 bf16 forward at 640 px of each model of "
                "the tooling phase (res10, plain-LIF res10, res10-ee) exported to TorchScript "
                "and torch.export and loaded back through backends.DetectMultiBackend: the "
                "kernel's launches through its torch.library op")


def tooling_launches(tool: dict, kernel: str) -> dict:
    """The launches of ``kernel`` in one forward of each exported artifact
    of the tooling phase."""
    return {tag: {fmt: tool[tag][fmt]["launches"][kernel] for fmt in TOOL_FORMATS}
            for tag in ("resnet10", "resnet10-lif", "res10-ee")}


def default_fuser_run(path, xb, want) -> dict:
    """A TorchScript artifact loaded with ``torch.jit.load`` and run under
    the JIT's default fuser (its elementwise chains fused after the profiled
    runs; ``backends.DetectMultiBackend`` turns the fuser off): ms a forward
    and its distance to the eager prediction ``want``."""
    fused = torch.jit.load(str(path), map_location="cuda")
    with torch.inference_mode():
        for _ in range(TOOL_WARM_CALLS + 1):
            got = fused(xb)
        ms = cuda_ms(lambda: fused(xb), reps=5)
    d = (got.float() - want.float()).abs()
    return {"ms": ms, "bit_equal_to_eager": torch.equal(got, want),
            "max_abs_diff_to_eager": float(d.max()),
            "share_off_by_1e-2_rel": float((d > 1e-2 * (1 + want.float().abs())).float().mean())}


def recorded_sites(K, FZ, plain_kernels, run):
    """``run()`` with every kernel op's call held to its plain version on
    the same input, whatever graph calls the op (eager, TorchScript,
    ``torch.export``): the ops' implementations (``snn/ops.py`` looks them
    up at each call) are wrapped for the call.  Returns (result, per site:
    (implementation, act, spike mismatch share or SiLU error))."""
    sites, real = [], {"run_k1": K.run_k1, "run_k2": FZ.run_k2, "run_k6": FZ.run_k6}

    def wrap(name, mod):
        impl = real[name]

        def wrapped(x, *a):
            out = impl(x, *a)
            with plain_kernels():
                want = impl(x, *a)
            act = a[-1]
            err = silu_err(out, want, x) if act else float((out != want).float().mean())
            sites.append((name, act, err))
            return out
        setattr(mod, name, wrapped)

    wrap("run_k1", K)
    wrap("run_k2", FZ)
    wrap("run_k6", FZ)
    try:
        return run(), sites
    finally:
        K.run_k1, FZ.run_k2, FZ.run_k6 = real["run_k1"], real["run_k2"], real["run_k6"]


def phase_tooling(seed: int, root: Path, log) -> dict:
    """Export, load-back and the observability tools (``export``,
    ``backends``, ``hub``, ``autoshape``, ``observe``, ``utils/profiling``,
    ``models/utils.autobatch`` / ``forward_augment``, ``train/evolve``,
    ``tools``) at full width, 640 px, T=4:

    * each model of ``TOOL_MODELS`` (BN calibrated, bf16, b8) exported to
      TorchScript and ``torch.export``, loaded back through
      ``DetectMultiBackend``: its prediction bit-equal to the eager
      model's, its kernel's launches a forward from the op's counter, every
      site held to its plain version on its own input (``recorded_sites``)
      against the kernel gates; eager / TorchScript / pt2 ms a forward, and
      a kernel op's call through the dispatcher against its implementation
      called directly (host us a call);
    * ``hub.create(autoshape=True)`` from a checkpoint: ``Detections`` on
      each of four 640 x 640 synthetic images equal to ``detect.run``'s;
    * ``val.run`` on the pt2 backend equal to the native pass (NMS outputs,
      metrics);
    * ``calculate_fr`` on the kernel route against the plain route, a
      ``profiling.trace`` file naming K1's kernel (its events counted: the
      profiler may drop a few of a forward's 24), ``autobatch`` at 640 and
      a forward at its batch, ``forward_augment`` (float32) against the
      plain route;
    * two ``evolve`` generations of one epoch on ``TOOL_IMAGES`` images,
      with their K4 / K5 launches;
    * ``python -m ecs_yolo_tpu_torch.tools export`` and ``firing-rate``,
      both at once."""
    from PIL import Image

    from ecs_yolo_tpu_torch import backends, detect as detect_mod, export, hub, observe
    from ecs_yolo_tpu_torch import val as val_mod
    from ecs_yolo_tpu_torch.config import SNNConfig
    from ecs_yolo_tpu_torch.data.hyps import HYP_SCRATCH
    from ecs_yolo_tpu_torch.models.utils import autobatch, forward_augment
    from ecs_yolo_tpu_torch.models.yolo import build_model, cast_params
    from ecs_yolo_tpu_torch.nn.blocks import _BN
    from ecs_yolo_tpu_torch.snn import ecs_lif as K
    from ecs_yolo_tpu_torch.snn import fused as FZ
    from ecs_yolo_tpu_torch.snn import ops
    from ecs_yolo_tpu_torch.snn.route import plain_kernels
    from ecs_yolo_tpu_torch.train import driver
    from ecs_yolo_tpu_torch.train.evolve import evolve
    from ecs_yolo_tpu_torch.utils import profiling
    from ecs_yolo_tpu_torch.utils.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    reset, read = launch_counters()
    root.mkdir(parents=True, exist_ok=True)
    imgs = root / "images"
    imgs.mkdir()
    rng = np.random.RandomState(seed + 500)
    for i in range(4):
        Image.fromarray((rng.rand(IMGSZ, IMGSZ, 3) * 255).astype(np.uint8)).save(
            imgs / f"{i}.png")
    val_src = write_val_set(root / "val", seed + 501, TOOL_IMAGES)
    xb = torch.from_numpy(np.concatenate(
        [im for _, im, _ in detect_mod.LoadImages(str(imgs), IMGSZ)] * 2)).cuda()
    out, gates = {}, []

    # --- export and load back ---------------------------------------------------
    for j, (cfg, fields, kernel, per_forward) in enumerate(TOOL_MODELS):
        tag = cfg.split(".")[0] + ("-lif" if fields else "")
        model = build_model(cfg, nc=NC, snn=SNNConfig(**fields),
                            generator=torch.Generator().manual_seed(seed + 510 + j))
        calibrate_bn(model, xb, _BN)
        state32 = {k: v.detach().clone() for k, v in model.state_dict().items()}
        cast_params(model, torch.bfloat16)
        fwd = export.ExportForward(model).eval()
        t0 = time.perf_counter()
        paths = export.run(model, TOOL_FORMATS, root / tag, imgsz=IMGSZ, batch=N)
        rec = {"phase": "tooling_export", "model": tag, "export_seconds":
               time.perf_counter() - t0, "kernel": kernel}
        with torch.no_grad():
            reset()
            want = fwd(xb)
            torch.cuda.synchronize()
            rec["eager_launches"] = read()
            rec["eager_ms"] = cuda_ms(lambda: fwd(xb), reps=5)
        for fmt in TOOL_FORMATS:
            b = backends.DetectMultiBackend(paths[fmt])
            first = b.forward(xb)
            for _ in range(TOOL_WARM_CALLS):    # TorchScript optimises after its profiled runs
                b.forward(xb)
            reset()
            got = b.forward(xb)
            torch.cuda.synchronize()
            launches = read()
            _, sites = recorded_sites(K, FZ, plain_kernels, lambda: b.forward(xb))
            spikes = [e for _, act, e in sites if not act]
            silu = [e for _, act, e in sites if act]
            rec[fmt] = {"bit_equal_to_eager": torch.equal(got, want),
                        "first_call_bit_equal_to_eager": torch.equal(first, want),
                        "launches": launches, "op_calls": len(sites),
                        "worst_site_mismatch_share": max(spikes, default=0.0),
                        "worst_silu_err": max(silu, default=0.0),
                        "ms": cuda_ms(lambda: b.forward(xb), reps=5)}
            # a pure op called twice on the same arguments may run once: TorchScript's
            # common-subexpression pass merges the plain-LIF sites that share an input
            # (no spread parameters tell them apart); every other artifact launches
            # what the eager forward launches
            merged = fmt == "torchscript" and not fields.get("ecs", True)
            count_ok = (0 < launches[kernel] <= per_forward if merged else
                        launches == rec["eager_launches"] and launches[kernel] == per_forward)
            if fmt == "torchscript" and j == 0:    # the artifact under the JIT's default fuser
                rec["torchscript_default_fuser"] = default_fuser_run(paths[fmt], xb, want)
            gates.append((tag, fmt, rec[fmt]["bit_equal_to_eager"]
                          and rec[fmt]["first_call_bit_equal_to_eager"] and count_ok
                          and sum(launches.values()) == len(sites)
                          and all(launches[k] <= v for k, v in rec["eager_launches"].items())
                          and sites_ok(spikes, silu, torch.bfloat16)))
        emit(rec, log)
        out[tag] = rec
        if j == 0:
            res10 = (model, state32, paths)
        else:
            del model
    failed = [g[:2] for g in gates if not g[2]]
    if failed:
        raise AssertionError(f"tooling: exported artifacts failed their checks: {failed}")
    model, state32, paths = res10

    # the dispatcher's cost: one site's op call against its implementation
    x = torch.zeros((T, 1, 8, 8, 64), dtype=torch.bfloat16, device="cuda")
    params = [torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
              for shape in ((3, 3, 1, 64), (64,), (1, 1, 64, 64), (64,))]
    cfg_args = ops.cfg_args(SNNConfig())
    via_op = functools.partial(ops.ecs_lif, x, *params, *cfg_args, False)
    direct = functools.partial(K.run_k1, x, *params, SNNConfig(), False)
    turns = []
    with torch.no_grad():
        for name, call in (("op", via_op), ("direct", direct), ("direct", direct),
                           ("op", via_op)):
            turns.append((name, wall_ms(call, 400) * 1e3))
    op_us = sum(t for n, t in turns if n == "op") / 2
    direct_us = sum(t for n, t in turns if n == "direct") / 2
    rec = {"phase": "tooling_dispatch", "site": list(x.shape), "turns_us_per_call": turns,
           "op_us_per_call": op_us, "direct_us_per_call": direct_us,
           "dispatcher_us_per_call": op_us - direct_us,
           "dispatcher_us_per_res10_forward": 24 * (op_us - direct_us),
           "res10_eager_ms": out["resnet10"]["eager_ms"],
           "res10_images_per_s": N / out["resnet10"]["eager_ms"] * 1e3}
    emit(rec, log)
    out["dispatch"] = rec

    ckpt = save_checkpoint(root / "res10.pt", state32, None, {"imgsz": IMGSZ})
    # --- hub / AutoShape against detect.run ------------------------------------
    shaped = hub.create("resnet10.yaml", str(ckpt), nc=NC, autoshape=True, imgsz=IMGSZ)
    cast_params(shaped.model, torch.bfloat16)
    reset()
    dets = [shaped(str(p)) for p in sorted(imgs.glob("*.png"))]
    k1_auto = read()["ecs_lif_fused"]
    ref = detect_mod.run(shaped.model, str(imgs), imgsz=IMGSZ)
    rec = {"phase": "tooling_autoshape", "images": len(dets),
           "detections": [len(d.pred[0]) for d in dets], "k1_launches": k1_auto,
           "equal_to_detect_run": len(dets) == len(ref) == 4 and all(
               np.array_equal(d.pred[0], r[1]) for d, r in zip(dets, ref))}
    emit(rec, log)
    out["autoshape"] = rec
    if not rec["equal_to_detect_run"] or k1_auto != 24 * 4:
        raise AssertionError(f"tooling: AutoShape differs from detect.run: {rec}")

    # --- val.run on the pt2 backend against the native pass ---------------------
    metrics = ("mp", "mr", "map50", "map", "fitness", "seen")
    res_n, outs_n = recorded_nms(val_mod, lambda: val_mod.run(
        model, str(val_src), imgsz=IMGSZ, batch_size=N))
    reset()
    res_b, outs_b = recorded_nms(val_mod, lambda: val_mod.run(
        backends.DetectMultiBackend(paths["pt2"]), str(val_src), imgsz=IMGSZ, batch_size=N))
    k1_val = read()["ecs_lif_fused"]
    rec = {"phase": "tooling_val", "images": TOOL_IMAGES, "native": {k: res_n[k] for k in metrics},
           "pt2": {k: res_b[k] for k in metrics}, "forwards": len(outs_b), "k1_launches": k1_val,
           "equal": all(res_n[k] == res_b[k] for k in metrics) and len(outs_n) == len(outs_b)
           and all(torch.equal(a, c) and torch.equal(b, d)
                   for (a, b), (c, d) in zip(outs_n, outs_b))}
    emit(rec, log)
    out["val"] = rec
    if not rec["equal"] or k1_val != 24 * len(outs_b):
        raise AssertionError(f"tooling: val.run on the pt2 backend differs: {rec}")

    # --- observability -----------------------------------------------------------
    batches = [(xb[:4].cpu().numpy(),), (xb[4:].cpu().numpy(),)]
    reset()
    rates = observe.calculate_fr(model, batches)
    k1_fr = read()["ecs_lif_fused"]
    with plain_kernels():
        rates_p = observe.calculate_fr(model, batches)
    with profiling.trace(root / "trace") as trace_path, torch.no_grad():
        model(xb)
    events = json.loads(trace_path.read_text()).get("traceEvents", [])
    k1_events = sum(1 for e in events if "ecs_lif_kernel" in str(e.get("name", "")))
    t0 = time.perf_counter()
    best = autobatch(model, imgsz=IMGSZ)
    with torch.no_grad():
        z = model(torch.zeros((best, IMGSZ, IMGSZ, 3), device="cuda"))[0]
    autobatch_s = time.perf_counter() - t0
    cast_params(model, torch.float32)
    model.load_state_dict(state32)
    xa = xb[:2].float()
    za = forward_augment(model, xa)
    with plain_kernels():
        za_p = forward_augment(model, xa)
    d = (za - za_p).abs()
    rec = {"phase": "tooling_observe", "rate_sites": len(rates), "k1_launches": k1_fr,
           "rates_max_abs_diff_vs_plain": max(abs(rates[k] - rates_p[k]) for k in rates),
           "rates_keys_equal": sorted(rates) == sorted(rates_p),
           "mean_rate": float(np.mean(list(rates.values()))),
           "trace_file": trace_path.name, "trace_k1_events": k1_events,
           "autobatch": best, "autobatch_forward_finite": bool(torch.isfinite(z).all()),
           "autobatch_seconds": autobatch_s,
           "forward_augment_shape": list(za.shape),
           "forward_augment_share_off_by_1e-3_rel": float(
               (d > 1e-3 * (1 + za_p.abs())).float().mean()),
           "forward_augment_max_abs_err": float(d.max())}
    emit(rec, log)
    out["observe"] = rec
    if (not rec["rates_keys_equal"] or len(rates) != 24 or k1_fr != 48
            or rec["rates_max_abs_diff_vs_plain"] > SPIKE_BOUND[torch.bfloat16]
            or not k1_events or best < 1 or not rec["autobatch_forward_finite"]
            or not torch.isfinite(za).all()
            or rec["forward_augment_share_off_by_1e-3_rel"] > 1e-3):
        raise AssertionError(f"tooling: the observability checks failed: {rec}")
    del model, res10, xb

    # --- two evolve generations -----------------------------------------------------
    gens = []

    def train_fn(h):
        reset()
        t0 = time.perf_counter()
        _, best_fit, hist = driver.train(
            "resnet10.yaml", str(val_src), str(val_src), nc=NC, hyp=h, epochs=1,
            batch_size=N, imgsz=IMGSZ, nbs=N, bf16=True, seed=seed, workers=4,
            autoanchor=False, loggers_include=("csv",),
            save_dir=str(root / "evolve" / f"gen{len(gens)}"))
        torch.cuda.synchronize()
        gens.append({"fitness": best_fit, "micro_steps": hist[-1]["micro_steps"],
                     "seconds": time.perf_counter() - t0, "launches": read()})
        return best_fit

    best_hyp = evolve(train_fn, dict(HYP_SCRATCH), generations=2, save_dir=root / "evolve",
                      seed=seed)
    rows = [r.split(",") for r in (root / "evolve" / "evolve.csv").read_text().splitlines()]
    rec = {"phase": "tooling_evolve", "generations": gens, "csv_rows": len(rows) - 1,
           "mutated_in_generation_1": sorted(k for k, a, b in zip(rows[0], rows[1], rows[2])
                                             if k != "fitness" and a != b),
           "best_fitness": max(g["fitness"] for g in gens), "best_hyp_is_base":
           best_hyp == dict(HYP_SCRATCH)}
    emit(rec, log)
    out["evolve"] = rec
    if len(rows) != 3 or not rec["mutated_in_generation_1"] or any(
            g["launches"]["binary_dw3_conv"] != 57 * g["micro_steps"]
            or g["launches"]["packed_spread"] != 15 * g["micro_steps"] for g in gens):
        raise AssertionError(f"tooling: evolve failed its checks: {rec}")

    # --- the tools CLI, both commands at once -------------------------------------
    t_cli = time.perf_counter()
    repo = Path(__file__).resolve().parent
    cli = [sys.executable, "-m", "ecs_yolo_tpu_torch.tools"]
    cmds = {"export": cli + ["export", "--cfg", "resnet10.yaml", "--nc", str(NC), "--imgsz",
                             str(IMGSZ), "--include", "torchscript", "--out",
                             str(root / "cli_export")],
            "firing-rate": cli + ["firing-rate", "--weights", str(ckpt), "--cfg",
                                  "resnet10.yaml", "--nc", str(NC), "--data",
                                  str(val_src), "--imgsz", str(IMGSZ), "--batches", "2",
                                  "--out", str(root / "cli_fr")]}
    procs = {k: subprocess.Popen(c, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True) for k, c in cmds.items()}
    try:
        done = {}
        for k, p in procs.items():
            o, e = p.communicate(timeout=300)
            done[k] = {"rc": p.returncode, "stdout_tail": o[-300:], "stderr_tail": e[-300:]}
    finally:        # whatever failed, no command outlives the phase
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    rec = {"phase": "tooling_cli", "commands": done, "seconds": time.perf_counter() - t_cli,
           "exported": (root / "cli_export" / "model.torchscript").is_file(),
           "rates_saved": (root / "cli_fr" / "fr_firerate.npy").is_file(),
           "phase_seconds": time.perf_counter() - t_phase}
    emit(rec, log)
    out["cli"] = rec
    if any(v["rc"] != 0 for v in done.values()) or not rec["exported"] or not rec["rates_saved"]:
        raise AssertionError(f"tooling: the tools CLI failed: {rec}")
    return out


#: the loaders phase: two clips of LOADER_FRAMES frames, H x W; res10 on each route
LOADER_FRAMES, LOADER_HW = 8, (480, 640)
LOADER_MODELS = (("resnet10", {}, "ecs_lif_fused"), ("resnet10-lif", {"ecs": False}, "lif_fused"))
LOADER_SITES = 24
LOADERS_NOTE = ("loaders_launches_per_forward: res10 (bf16, 640 px) serving the frames of "
                f"two synthetic {LOADER_HW[1]}x{LOADER_HW[0]} GIFs through data/loaders: "
                "LoadVideo at b1 and LoadStreams over both clips at b2, each forward, NMS and "
                "rescale as detect.run does them")


def write_clips(root: Path, seed: int) -> list:
    """Two animated GIFs of ``LOADER_FRAMES`` frames (``LOADER_HW``), written
    with PIL as palette images (no quantizing): seeded noise of 192 colours
    with four filled rectangles of four more colours moving across it."""
    from PIL import Image

    root.mkdir(parents=True, exist_ok=True)
    h, w = LOADER_HW
    paths = []
    for c in range(2):
        rng = np.random.RandomState(seed + 600 + c)
        palette = np.concatenate([rng.randint(64, 160, (192, 3)), rng.randint(0, 256, (64, 3))])
        bg = rng.randint(0, 192, (h, w)).astype(np.uint8)
        boxes = [(rng.randint(0, h // 2), rng.randint(0, w // 2), rng.randint(40, h // 2),
                  rng.randint(40, w // 2), rng.randint(-24, 25, 2)) for _ in range(4)]
        ims = []
        for f in range(LOADER_FRAMES):
            idx = bg.copy()
            for k, (y, x, bh, bw, (dy, dx)) in enumerate(boxes):
                y0, x0 = (y + f * dy) % (h - bh), (x + f * dx) % (w - bw)
                idx[y0:y0 + bh, x0:x0 + bw] = 192 + k
            im = Image.fromarray(idx, mode="P")
            im.putpalette(palette.astype(np.uint8).tobytes())
            ims.append(im)
        path = root / f"clip{c}.gif"
        ims[0].save(path, save_all=True, append_images=ims[1:], duration=40, loop=0)
        paths.append(str(path))
    return paths


def loader_batches(loader):
    """``(im, [original, ...])`` of each batch of ``loader``; a stream's
    readers closed at the end."""
    try:
        for _, im, ims0 in loader:
            yield im, ims0 if isinstance(ims0, list) else [ims0]
    finally:
        if hasattr(loader, "close"):
            loader.close()


def phase_loaders(seed: int, root: Path, log) -> dict:
    """Serving video frames through ``data/loaders.py`` (phase ``loaders``):
    two synthetic clips (``write_clips``) read by ``LoadVideo`` (b1, the
    first clip) and by ``LoadStreams`` (both clips, one reader thread each,
    b2); res10 at full width, nc 13, 640 px, T=4, BN calibrated on the
    first clip's frames, bf16, on K1 (ECS-LIF) and on K6 (plain LIF, over
    ``LoadVideo``).  Each frame batch goes through ``detect.predictor`` and
    ``detect.frame_detections`` (the forward, NMS and the rescale to the
    original frame of ``detect.run``).

    A checked pass first: every forward's sites held to the plain version
    of their kernel on their own input (K1 within ``SPIKE_BOUND``, K6
    equal), its detections equal to its ``plain_kernels()`` rerun, 24
    launches of the route's kernel a forward and none of another.  Then the
    timed pass, the main path, with the counters set to 0 just before it and
    read just after: ``utils/general.Profile`` around the loader's ``next``
    and around the forward, NMS and rescale (synchronized inside the block):
    ms a frame and the loader's share; the first clip's ``LoadVideo`` pass
    again under the profiler for the card's idle share.  Also:
    ``select_device("")`` returns the card; which decoder the loaders took
    (imageio where it imports, else Pillow)."""
    from ecs_yolo_tpu_torch import detect as detect_mod
    from ecs_yolo_tpu_torch.config import SNNConfig
    from ecs_yolo_tpu_torch.data import loaders
    from ecs_yolo_tpu_torch.models.yolo import build_model, cast_params
    from ecs_yolo_tpu_torch.nn.blocks import MemUpdate, _BN
    from ecs_yolo_tpu_torch.snn.route import plain_kernels
    from ecs_yolo_tpu_torch.utils.general import Profile, select_device

    t_phase = time.perf_counter()
    reset, read = launch_counters()
    devs = select_device("")
    try:
        import imageio  # noqa: F401
        decoder = "imageio"
    except ImportError:
        decoder = "pillow"
    clips = write_clips(root, seed)
    frames = [[f for _, _, f in loaders.LoadVideo(c, IMGSZ)] for c in clips]
    xb = torch.from_numpy(np.concatenate([im for _, im, _ in loaders.LoadVideo(clips[0], IMGSZ)])
                          ).cuda()
    rec = {"phase": "loaders", "select_device": [str(d) for d in devs], "decoder": decoder,
           "imageio_importable": decoder == "imageio", "frames_per_clip": LOADER_FRAMES,
           "frame_hw": list(LOADER_HW), "clip_seconds": time.perf_counter() - t_phase}
    ok = [("select_device", devs == [torch.device("cuda", i)
                                     for i in range(torch.cuda.device_count())]),
          ("frames", [len(f) for f in frames] == [LOADER_FRAMES] * 2
           and frames[0][0].shape == (*LOADER_HW, 3))]
    out = {}
    for j, (tag, fields, kernel) in enumerate(LOADER_MODELS):
        model = build_model("resnet10.yaml", nc=NC, snn=SNNConfig(**fields),
                            generator=torch.Generator().manual_seed(seed + 700 + j))
        calibrate_bn(model, xb, _BN)
        cast_params(model, torch.bfloat16)
        sites = [m for m in model.modules() if isinstance(m, MemUpdate)]
        device, head, predict = detect_mod.predictor(model)
        feeds = {"video_b1": lambda: loaders.LoadVideo(clips[0], IMGSZ)}
        if j == 0:
            feeds["streams_b2"] = lambda: loaders.LoadStreams(clips, IMGSZ)
        out[tag] = {}
        for feed, make in feeds.items():
            # the checked pass: sites against their plain versions, NMS against the rerun
            shares, silu, equal, batches, last = [], [], [], 0, None
            reset()
            with torch.no_grad():
                for im, ims0 in loader_batches(make()):
                    x = torch.from_numpy(im).to(device)
                    pred, seen = captured_sites(sites, lambda: predict(x))
                    dets = detect_mod.frame_detections(pred, head, im.shape[1:3], ims0)
                    with plain_kernels():
                        want = detect_mod.frame_detections(predict(x), head, im.shape[1:3],
                                                           ims0)
                    s, e = site_errors(seen, plain_kernels)
                    shares += s
                    silu += e
                    equal.append(all(np.array_equal(a, b) for a, b in zip(dets, want)))
                    batches, last = batches + 1, ims0
                    del seen
            checked = read()
            # the main path, timed: counts set to 0 just before, read just after
            p_load, p_fwd, n_frames, n_batches = Profile(), Profile(), 0, 0
            reset()
            with torch.no_grad():
                it = loader_batches(make())
                while True:
                    with p_load:
                        item = next(it, None)
                    if item is None:
                        break
                    im, ims0 = item
                    with p_fwd:
                        pred = predict(torch.from_numpy(im).to(device))
                        detect_mod.frame_detections(pred, head, im.shape[1:3], ims0)
                        torch.cuda.synchronize()
                    n_frames, n_batches = n_frames + len(ims0), n_batches + 1
            launches = read()
            r = {"batches_checked": batches, "batches_timed": n_batches,
                 "frames_timed": n_frames, "launches": launches, "checked_launches": checked,
                 "launches_per_forward": launches[kernel] / max(n_batches, 1),
                 "worst_site_mismatch_share": max(shares, default=0.0),
                 "worst_silu_err": max(silu, default=0.0), "sites_checked": len(shares) + len(silu),
                 "nms_equal_to_plain": all(equal), "ms_per_frame": (p_load.t + p_fwd.t)
                 / max(n_frames, 1) * 1e3, "forward_nms_ms_per_frame": p_fwd.t
                 / max(n_frames, 1) * 1e3, "loader_share": p_load.t / max(p_load.t + p_fwd.t,
                                                                          1e-9)}
            if feed == "streams_b2":
                r["last_batch_is_each_clip_last_frame"] = last is not None and all(
                    np.array_equal(a, f[-1]) for a, f in zip(last, frames))
                ok.append((f"{tag}/{feed}/last", r["last_batch_is_each_clip_last_frame"]))
            if feed == "video_b1" and j == 0:
                def video_pass():
                    for im, ims0 in loader_batches(make()):
                        pred = predict(torch.from_numpy(im).to(device))
                        detect_mod.frame_detections(pred, head, im.shape[1:3], ims0)
                with torch.no_grad():
                    r["profile"] = profile_step(video_pass)
            gate = (max(shares, default=0.0) == 0.0 if kernel == "lif_fused"
                    else max(shares, default=0.0) <= SPIKE_BOUND[torch.bfloat16])
            frames_ok = n_frames == (LOADER_FRAMES if feed == "video_b1" else 2 * n_batches)
            ok.append((f"{tag}/{feed}", gate and all(equal) and frames_ok
                       and max(silu, default=0.0) <= LIF_SILU_ULPS_BF16
                       and len(shares) + len(silu) == LOADER_SITES * batches
                       and checked[kernel] == LOADER_SITES * batches
                       and launches[kernel] == LOADER_SITES * n_batches > 0
                       and sum(launches.values()) == launches[kernel]
                       and sum(checked.values()) == checked[kernel]))
            emit({"phase": "loaders_serve", "model": tag, "feed": feed, "kernel": kernel, **r},
                 log)
            out[tag][feed] = r
        del model
    rec["phase_seconds"] = time.perf_counter() - t_phase
    rec["failed"] = [name for name, good in ok if not good]
    emit(rec, log)
    if rec["failed"]:
        raise AssertionError(f"loaders: failed checks {rec['failed']}")
    return out


def loaders_launches(rec: dict, kernel: str) -> dict:
    """Launches of ``kernel`` a forward in each feed of the loaders phase."""
    return {f"{tag}/{feed}": r["launches_per_forward"] for tag, feeds in rec.items()
            for feed, r in feeds.items() if r["launches"][kernel]}


#: the phases in their order; those of SET_PHASES share the synthetic sets
SET_PHASES = ("train_run", "train_opts", "heads", "events", "segment", "zoo", "rtdetr_nms",
              "parallel", "tooling", "loaders")
PHASES = ("serve", "train", *SET_PHASES, "val", "k3_path", "bench")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="port smoke test on one card")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every phase's record to this JSON file")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic val split and the val models")
    ap.add_argument("--phases", default=None,
                    help="comma-separated subset of " + ",".join(PHASES) + " (every "
                         "phase when omitted; the kernels line only then; "
                         "k3_path needs serve, train_opts needs train_run)")
    opt = ap.parse_args(argv)
    out_path = opt.out
    sel = set(PHASES) if opt.phases is None else set(opt.phases.split(","))
    if sel - set(PHASES):
        ap.error(f"unknown phases {sorted(sel - set(PHASES))}")
    sel |= {"serve"} if "k3_path" in sel else set()
    sel |= {"train_run"} if "train_opts" in sel else set()
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

    if "serve" in sel:      # the kernel checks at the model's site shapes, serving
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
    if "train" in sel:
        spread_launches = phase_train(log)
    if sel & set(SET_PHASES):
        with tempfile.TemporaryDirectory() as sets:
            seconds = {}
            if sel & {"train_run", "train_opts", "heads"}:
                t0 = time.perf_counter()
                train_src = write_val_set(Path(sets) / "train", opt.seed + 100,
                                          TRAIN_IMAGES)
                emit({"phase": "train_set", "images": TRAIN_IMAGES,
                      "seconds": time.perf_counter() - t0}, log)
            runs = {
                "train_run": lambda: phase_train_run(opt.seed, train_src, log),
                "train_opts": lambda: phase_train_opts(opt.seed, train_src,
                                                       done["train_run"][1], log),
                "heads": lambda: phase_heads(opt.seed, train_src,
                                             Path(sets) / "heads_val", log),
                "events": lambda: phase_events(opt.seed, Path(sets) / "events", log),
                "segment": lambda: phase_segment(opt.seed, Path(sets) / "segment", log),
                "zoo": lambda: phase_zoo(opt.seed, Path(sets) / "zoo", log),
                "rtdetr_nms": lambda: phase_rtdetr_nms(opt.seed, log),
                "parallel": lambda: phase_parallel(opt.seed, Path(sets) / "parallel", log),
                "tooling": lambda: phase_tooling(opt.seed, Path(sets) / "tooling", log),
                "loaders": lambda: phase_loaders(opt.seed, Path(sets) / "loaders", log)}
            done = {}
            for name in SET_PHASES:
                if name in sel:
                    t0 = time.perf_counter()
                    done[name] = runs[name]()
                    seconds[name] = time.perf_counter() - t0
            emit({"phase": "train_seconds", **seconds}, log)

    # --- the validation main path ----------------------------------------------
    if "val" in sel:
        val_launches = phase_val(opt.seed, log)

    # --- K3's entry point, and the kernel benches ------------------------------
    if "k3_path" in sel:
        k3_launches = phase_k3_path(FZ, SNNConfig, shapes, broadcast, every_kernel, log)
    if "bench" in sel:
        aggs78 = phase_k7_k8(BD, BS, log)
        phase_k8_shapes(BD, log)
        phase_k4_shapes(S, BD, log)
        bench_launches = phase_bench_path(BD, BV3, every_kernel, log)

    if sel != set(PHASES):      # a subset: no kernels line
        if out_path is not None:
            out_path.parent.mkdir(parents=True, exist_ok=True)
            out_path.write_text(json.dumps({"log": log}, indent=1))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    run_launches, _ = done["train_run"]
    opts_launches, heads, events = done["train_opts"], done["heads"], done["events"]
    seg, zoo = done["segment"], done["zoo"]

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
                       "site of the five anchor-free YAMLs to the plain version",
            events_launches_per_forward=events["forward"]["k1_launches"],
            events_ms=events["k1"].ms, events_plain_ms=events["k1"].plain_ms,
            events_bound_ms=events["k1"].bound_ms,
            segment_launches_per_forward={c: m["k1_launches"]
                                          for c, m in seg["models"].items()},
            segment_detect_launches=seg["models"][SEG_CFG]["detect_launches"],
            zoo_launches_per_forward=zoo_launches(zoo, "ecs_lif_fused"),
            zoo_detect_launches={c: zoo["models"][c]["detect_launches"]["ecs_lif_fused"]
                                 for c in ZOO_DETECT_CFGS},
            parallel_val_launches=done["parallel"]["val"]["k1_launches"],
            tooling_launches_per_forward=tooling_launches(done["tooling"], "ecs_lif_fused"),
            tooling_note=TOOLING_NOTE,
            loaders_launches_per_forward=loaders_launches(done["loaders"], "ecs_lif_fused"),
            loaders_note=LOADERS_NOTE,
            zoo_note=f"zoo_*: the {len(ZOO_SITES)} YAMLs and the {len(PROBES)} probe models "
                     f"({', '.join(PROBES)}) of the zoo phase at 640 px, one forward each "
                     f"(b{N} for the YAMLs of {', '.join(ZOO_TIMED)}, else b{ZOO_BATCH}), "
                     f"and detect.run of {', '.join(ZOO_DETECT_CFGS)} over 4 images each",
            events_note=f"events_*: event mode, res10 nc {EVENT_NC} at {EVENT_IMGSZ} px, "
                        f"T={EVENT_T}, N={N}, bf16: K1's launches in one forward and its "
                        "device, plain and bound ms summed over the forward's 24 sites "
                        "(event_kernel_check); segment_*: res10-seg (b8) and "
                        f"res10-panoptic (b{PAN_BATCH}) at 640 px, one forward each, and "
                        "detect.run of res10-seg over 4 images"),
        aggs["binary_dw3_conv"].entry(
            name="binary_dw3_conv", route="cuda", source=csrc + "spread_dw3.cu",
            replaces="ecs_yolo_tpu/snn/pallas_dw.py:73",
            launches=spread_launches["binary_dw3_conv"],
            train_run_launches=run_launches["binary_dw3_conv"],
            train_opts_launches_per_step=opts_launches["binary_dw3_conv"],
            heads_launches_per_step=heads["step"]["launches_per_step"]["binary_dw3_conv"],
            events_launches_per_step=events["step"]["launches_per_step"]["binary_dw3_conv"],
            segment_launches_per_step={c: m["step"]["launches_per_step"]["binary_dw3_conv"]
                                       for c, m in seg["models"].items()},
            zoo_launches_per_step={c: m["step"]["launches_per_step"]["binary_dw3_conv"]
                                   for c, m in zoo["models"].items()},
            parallel_launches_per_step=done["parallel"]["step"]["grouped"][
                "launches_per_step"]["binary_dw3_conv"],
            zoo_narrow_site=zoo["k4_narrow"],
            zoo_narrow_note="zoo_narrow_site: the training spread of the 3-channel site on "
                            "the raw image at the head of res10-ee / res18-ee / res18-eebk "
                            f"(b{ZOO_BATCH}, bf16, one step's plane), which binary_dw3_conv "
                            "zero-pads to 8 channels: ms the wrapper's calls (pads and "
                            "launch) replayed in a CUDA graph, padded_launch_ms the launch "
                            "alone, wrapper_ms eager, plain ms and the bound of the "
                            "function at C = 3",
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
            events_launches_per_step=events["step"]["launches_per_step"]["packed_spread"],
            segment_launches_per_step={c: m["step"]["launches_per_step"]["packed_spread"]
                                       for c, m in seg["models"].items()},
            zoo_launches_per_step={c: m["step"]["launches_per_step"]["packed_spread"]
                                   for c, m in zoo["models"].items()},
            parallel_launches_per_step=done["parallel"]["step"]["grouped"][
                "launches_per_step"]["packed_spread"],
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
            tooling_launches_per_forward=tooling_launches(done["tooling"], "lif_fused"),
            tooling_note=TOOLING_NOTE,
            loaders_launches_per_forward=loaders_launches(done["loaders"], "lif_fused"),
            loaders_note=LOADERS_NOTE,
            events_launches_per_forward=events["forward_plain_lif"]["k6_launches"],
            events_ms=events["k6"].ms, events_plain_ms=events["k6"].plain_ms,
            events_bound_ms=events["k6"].bound_ms,
            zoo_launches_per_forward=zoo_launches(zoo, "lif_fused"),
            zoo_token_sites=zoo_sites_sum(zoo["tokens"]),
            zoo_probe_token_sites={c: zoo_sites_sum(r) for c, r in zoo["probe_tokens"].items()
                                   if r},
            zoo_probe_note="zoo_probe_token_sites: per probe model with token sites, its MHSA "
                           "attention outputs and TransformerBlock tokens ([T, N, H*W, C]), "
                           "DSSA attention maps ([T, N, H*W*heads, H*W]), OSRAAttention's "
                           "queries and attention maps ([T, N, heads, H*W, ...]) and "
                           "DynamicConv2d's kernel and bias mixing weights ([T, N, 3, 3, "
                           f"2C], [T, N, 1, 1, 2C]) at b{ZOO_BATCH}, summed as zoo_token_sites",
            zoo_note="zoo_*: the AIFI encoder's token sites ([T, N, H*W, C], the one "
                     "TokenLIF applied six times a forward; K6 whatever snn.ecs says), "
                     "launches per forward of each zoo YAML; zoo_token_sites sums the "
                     "six sites of one resnetaifi forward at b8: device ms replayed in "
                     "a CUDA graph over copies of each site's input that together "
                     "exceed L2 thrice (each call reads its input from memory), "
                     "l2_warm_ms the same calls on one input (L2-resident), "
                     "wrapper_ms eager, plain and bound ms",
            events_note=f"events_*: the plain-LIF event model, res10 at {EVENT_IMGSZ} px, "
                        f"T={EVENT_T}, N={N}, bf16, x dense at every site: K6's launches "
                        "in one forward and its replayed, plain and bound ms summed over "
                        "the 24 sites (event_kernel_check)",
            library_note="no single PyTorch call computes the LIF recurrence"),
        agg2.entry(
            name="ecs_lif_fused_rows", route="cuda", source=csrc + "ecs_lif_rows.cu",
            replaces="ecs_yolo_tpu/snn/pallas_kernels.py:326",
            launches=val_launches["ecs_lif_fused_rows"],
            work=f"the 24 neuron sites of one res10@640 forward under "
                 f"fused_inference, N={N}, T={T}, bf16 (the site behind the stem "
                 "reads a broadcast x); launches over the "
                 f"{VAL_IMAGES // N} forwards of the val pass",
            tooling_launches_per_forward=tooling_launches(done["tooling"], "ecs_lif_fused_rows"),
            tooling_note=TOOLING_NOTE,
            zoo_launches_per_forward=zoo_launches(zoo, "ecs_lif_fused_rows"),
            zoo_stem_site=zoo_sites_sum([zoo["stem"]]),
            zoo_note="zoo_*: the first K2 site on a model path, the neuron on the raw "
                     "image at the head of res10-ee / res18-ee / res18-eebk (C = 3, "
                     "which K1 refuses; x broadcast over T), launches per forward of "
                     "each zoo YAML; zoo_stem_site: that site at b8, its device, plain "
                     "and bound ms (bound_by, the function's bound as in kernel_check)",
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
        ("spread_gemm_device_ms", "spread_gemm_"), ("nccl_device_ms", "nccl"))}
    return {"profiled_wall_ms": wall_ms, "device_ms": total,
            "kernel_calls": sum(r[2] for r in rows), **own,
            "elementwise_device_ms": sum(r[0] for r in rows if "elementwise" in r[1]),
            "idle_share": max(0.0, 1 - total / wall_ms),
            "top_kernels": [{"name": k[:90], "ms": ms, "calls": c}
                            for ms, k, c in rows[:12]]}


if __name__ == "__main__":
    sys.exit(main())
