"""What the per-layer readers (``metrics/<name>.py``) share.  A reader gets
the run's record and returns a number, or None where the run holds nothing
to read (no trace, no launch of the kernel, a launch count other than the
configuration's): the harness then leaves the metric out of the line."""

from __future__ import annotations

import statistics
from typing import Dict, Optional

from ..counts import PEAK_FLOPS


def device_s(rec: Dict, tag: str) -> float:
    tr = rec.get("trace") or {}
    return sum(v for k, v in tr.get("device_s", {}).items() if tag in k)


def roofline(rec: Dict, key: str, tag: str) -> Optional[float]:
    """100 x the kernel's bound over its device time in the traced steps,
    when its launches there are the ones the configuration implies."""
    k = rec.get(key)
    t = device_s(rec, tag)
    if not k or not k["expected"] or k["launches"] != k["expected"] or t <= 0:
        return None
    return 100.0 * k["bound_s"] / t


def mfu(rec: Dict, dtype: str = "bfloat16") -> Optional[float]:
    """Counted operations over the traced sub-window's length, in % of the
    peak."""
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * rec["flops_traced"] / (tr["window_s"] * PEAK_FLOPS[dtype])


def mfu_untraced(rec: Dict, dtype: str = "bfloat16") -> Optional[float]:
    """Counted operations over the part of the window the profiler did not
    cover, by the host's clock, in % of the peak."""
    u = rec.get("untraced")
    if not u or u["seconds"] <= 0 or u["flops"] <= 0:
        return None
    return 100.0 * u["flops"] / (u["seconds"] * PEAK_FLOPS[dtype])


def idle_share(rec: Dict) -> Optional[float]:
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def idle_share_untraced(rec: Dict) -> Optional[float]:
    """100 x (1 - the device's busy seconds a step in the traced sub-window
    over the wall seconds a step in the rest of the window): the idle share
    of a step as it runs when the profiler is off, in %."""
    tr, u = rec.get("trace"), rec.get("untraced")
    if not tr or not u or tr["busy_s"] <= 0 or not rec.get("steps_traced") \
            or u["steps"] <= 0 or u["seconds"] <= 0:
        return None
    busy = tr["busy_s"] / rec["steps_traced"]
    return 100.0 * (1.0 - busy / (u["seconds"] / u["steps"]))


def mean_ms(values, scale: float = 1.0) -> Optional[float]:
    return statistics.fmean(values) * scale if values else None


def median_ms(values, scale: float = 1.0) -> Optional[float]:
    return statistics.median(values) * scale if values else None
