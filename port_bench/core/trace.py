"""Spans of the benchmark's own files, and the profiler's trace of a traced
run reduced to what the per-layer metrics read.

A span is a named host interval around a call into one layer of the
program (the batch's copy to the card, the forward, NMS, a training
micro-step).  With tracing off a span costs one generator frame and records
nothing.  With tracing on it is a ``record_function`` range, so the trace
can say what the host was doing while the card sat idle.

The profiler runs over a sub-window of a traced run (``start`` ..
``stop``): the window itself is as long as an untraced run's, and the
trace's size stays bounded.  ``reduce`` takes the union of the device's
operation intervals inside the traced sub-window (so work on several streams
is counted once), the idle gaps between them labelled by the innermost span
the host was in, and the device time by operation name.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PREFIX = "bench."
WINDOW = PREFIX + "window"


class Recorder:
    def __init__(self, traced: bool):
        self.traced = traced
        self._prof = None
        self._window = None
        self.profiled = False

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.traced:
            yield
            return
        from torch.autograd.profiler import record_function

        with record_function(PREFIX + name):
            yield

    def start(self) -> None:
        """Start the profiler's sub-window (a traced run only)."""
        if not self.traced or self._prof is not None:
            return
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self._window = record_function(WINDOW)
        self._window.__enter__()

    def stop(self) -> None:
        """Close the sub-window; the device has finished its work (the caller
        synchronises first)."""
        if self._prof is None or self.profiled:
            return
        self._window.__exit__(None, None, None)
        self._prof.stop()
        self.profiled = True

    def reduce(self, top: int = 10) -> Optional[Dict]:
        """``window_s``, ``busy_s``, ``device_s`` (seconds by operation
        name), ``device_ops`` and ``idle_gaps`` (the ``top`` largest, as
        ``[name, seconds]``); None without a finished profile."""
        if not self.profiled:
            return None
        return reduce_events(self._prof.events(), top)


def _is_device(e) -> bool:
    return "CUDA" in str(e.device_type) and not e.name.startswith(PREFIX) \
        and not e.name.startswith("ProfilerStep")


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce_events(events, top: int = 10) -> Optional[Dict]:
    cpu = [e for e in events if "CPU" in str(e.device_type)]
    win = [e for e in cpu if e.name == WINDOW]
    if not win:
        return None
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    spans = [(e.time_range.start, e.time_range.end, e.name[len(PREFIX):]) for e in cpu
             if e.name.startswith(PREFIX) and e.name != WINDOW]
    dev, by_name = [], defaultdict(float)
    for e in events:
        if not _is_device(e):
            continue
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t > s:
            dev.append((s, t))
            by_name[e.name] += (t - s) * 1e-6
    busy = union(dev)
    gaps, prev = [], w0
    for s, t in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    idle = defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        inside = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        # the innermost span: the one that started last
        label = max(inside, key=lambda sp: sp[0])[2] if inside else "between spans"
        idle[label] += (g1 - g0) * 1e-6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": sum(t - s for s, t in busy) * 1e-6,
            "device_s": dict(by_name), "device_ops": rank(by_name), "idle_gaps": rank(idle)}
