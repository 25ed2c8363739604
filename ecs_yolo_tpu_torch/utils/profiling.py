"""Profiling (counterpart of ``ecs_yolo_tpu/utils/profiling.py``):

* ``time_sync``      reference utils/torch_utils.py:88, a wall clock read
  after the card's queue has drained;
* ``benchmark_fn``   reference utils/torch_utils.py:95 ``profile()``, ms a
  call;
* ``trace``          a ``torch.profiler`` Chrome trace of the block (CPU and
  CUDA activity), where the JAX package writes a ``jax.profiler`` trace;
* ``profile_layers`` reference models/yolo.py:349 ``_profile_one_layer``:
  ms of each top-level layer of a forward, one row a layer as JAX's rows,
  read through forward hooks on the real forward, so each layer sees its
  true inputs (the stem broadcast over T included).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable, Dict, List

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_sync() -> float:
    """Wall clock after the card's queue has drained (reference time_sync)."""
    _sync()
    return time.perf_counter()


def benchmark_fn(fn: Callable, *args, iters: int = 10, warmup: int = 3) -> float:
    """ms a call of ``fn(*args)`` over ``iters`` calls after ``warmup``."""
    for _ in range(warmup):
        fn(*args)
    t0 = time_sync()
    for _ in range(iters):
        fn(*args)
    return 1000.0 * (time_sync() - t0) / iters


@contextlib.contextmanager
def trace(logdir="runs/trace"):
    """``torch.profiler`` over the block; on exit its Chrome trace is
    written to ``logdir/trace.json`` (view in Perfetto or chrome://tracing).
    Yields the trace file's path."""
    from torch.profiler import ProfilerActivity, profile

    path = Path(logdir) / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield path
        _sync()
    prof.export_chrome_trace(str(path))


def _shapes(out):
    if isinstance(out, torch.Tensor):
        return tuple(out.shape)
    leaves = [o for o in (out if isinstance(out, (list, tuple)) else [])
              if isinstance(o, torch.Tensor)]
    return [tuple(o.shape) for o in leaves][:4]


@torch.no_grad()
def profile_layers(model, imgsz: int = 256, batch: int = 1, iters: int = 3) -> List[Dict]:
    """ms of each top-level layer of an eval forward of a ``[batch, imgsz,
    imgsz, 3]`` zero image, averaged over ``iters`` forwards after one
    warm-up: ``{"index", "name", "ms", "out_shape"}`` a layer."""
    model.eval()
    p = next(model.parameters())
    x = torch.zeros((batch, imgsz, imgsz, 3), dtype=torch.float32, device=p.device)
    spent = [0.0] * len(model.model)
    shapes: Dict[int, object] = {}
    started: Dict[int, float] = {}

    def before(i):
        def hook(module, args):
            started[i] = time_sync()
        return hook

    def after(i):
        def hook(module, args, out):
            spent[i] += time_sync() - started[i]
            shapes[i] = _shapes(out)
        return hook

    hooks = [h for i, layer in enumerate(model.model)
             for h in (layer.register_forward_pre_hook(before(i)),
                       layer.register_forward_hook(after(i)))]
    try:
        model(x)                # warm-up (kernel builds, caches), not timed
        spent[:] = [0.0] * len(model.model)
        for _ in range(iters):
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return [{"index": i, "name": row[2], "ms": round(1000.0 * spent[i] / iters, 3),
             "out_shape": shapes.get(i)} for i, row in enumerate(model.spec)]
