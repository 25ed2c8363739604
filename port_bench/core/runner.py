"""One run of one cell: set-up, the timed window, the check, the result line.

The order inside a run:

1. the cell's files (``core/spec``), the card (a run that finds too few
   fails), the cache directories inside the checkout;
2. the traffic's ``setup``: build, weights, inputs, warm-up (``setup_s``
   runs from the process's start to here);
3. the window: ``measure`` for ``--seconds``, with the memory peak counted
   from its start; in a traced run the profiler covers a sub-window;
4. ``release`` frees the program's state, then the import check;
5. ``check``: the reference, run after the window and outside ``setup_s``;
6. the per-layer readers (``metrics/<name>.py``) in a traced run, and the
   result line: each compared number beside its limit on standard error,
   and the JSON object as the last line of standard output.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from . import card, compare, guard, spec
from .trace import Recorder

#: process start, as near as the harness can take it (set by run.py)
STARTED = time.perf_counter()


@dataclasses.dataclass
class Context:
    seed: int
    seconds: float
    device: torch.device
    config: Dict
    mix: Dict
    workload: Dict
    recorder: Recorder
    chips: int


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    program's own nvcc products go to ``ecs_yolo_tpu_torch/_build``)."""
    base = root / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ.setdefault(var, str(base / sub))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def context(name: str, seed: int, seconds: float, trace: bool, root: Path,
            device: Optional[torch.device], overrides: Optional[Dict] = None) -> Context:
    bench = spec.benchmark(root)
    c = spec.cell(bench, name, root)
    for part, values in (overrides or {}).items():
        c[part] = {**c[part], **values}
    chips = c["entry"]["chips"]
    dev = card.require(chips) if device is None else device
    return Context(seed, seconds, dev, c["config"], c["mix"], c["workload"],
                   Recorder(trace), chips)


def _clean(v):
    """A number for the JSON line: infinity (nothing could be read) as 1e300."""
    return v if not isinstance(v, float) or math.isfinite(v) else 1e300


def run(name: str, seed: int, seconds: float, trace: bool, root: Path = spec.ROOT,
        device: Optional[torch.device] = None, overrides: Optional[Dict] = None,
        out=None) -> int:
    """One run; returns the exit code.  ``device`` given skips the look for a
    card (the CPU tests); ``overrides`` replace entries of the cell's
    ``config`` / ``mix`` / ``workload`` files (the tests' tiny sizes)."""
    out = out or sys.stdout
    cache_dirs(root)
    bench = spec.benchmark(root)
    try:
        ctx = context(name, seed, seconds, trace, root, device, overrides)
    except card.NoCard as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    traffic = spec.load_module("traffic", ctx.mix["kind"], root)
    st = traffic.setup(ctx)
    setup_s = time.perf_counter() - STARTED
    cuda = ctx.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)
    gc.collect()
    gc.freeze()         # the set-up's objects are not scanned again in the window
    result = traffic.measure(ctx, st)
    ctx.recorder.stop()
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    result["record"]["peak_bytes"] = peak
    traffic.release(ctx, st)
    gc.collect()
    found = guard.forbidden_loaded()
    if found:
        print(f"port_bench: modules that must not load were loaded: {found}", file=sys.stderr)
        return 3
    t_check = time.perf_counter()
    numbers = traffic.check(ctx, st)
    numbers["check_s"] = time.perf_counter() - t_check
    checked = compare.judge(numbers, ctx.workload["limits"])
    correct = compare.passed(checked)
    device_rec = {**card.describe(ctx.device, ctx.chips), "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"]}
    if trace:
        metrics = {}
        for m in spec.per_layer(bench, name):
            v = spec.load_module("metrics", m["name"], root).read(result["record"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        tr = result["record"].get("trace")
        if tr:
            device_rec.update({"busy_s": tr["busy_s"], "window_s": tr["window_s"]})
            line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    else:
        values = {**result["e2e"], "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end(bench, name) if m["name"] in values}
    line.update({"metrics": metrics, "device": device_rec})
    # the numbers beside their limits: a key of its own, last in the line
    line["check"] = {k: {"value": _clean(c["value"]), "limit": c["limit"]}
                     for k, c in checked.items()}
    found = guard.forbidden_loaded()
    if found:
        print(f"port_bench: modules that must not load were loaded: {found}", file=sys.stderr)
        return 3
    print(f"port_bench: {name} seed {seed}: extra readings "
          + json.dumps({k: _clean(v) for k, v in numbers.items() if k not in checked}),
          file=sys.stderr)
    compare.print_check(checked)
    print(json.dumps(line), file=out, flush=True)
    return 0
