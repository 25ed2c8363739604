"""The numbers that decide ``correct``, and their printing.

Each compares what the program produced with what the reference gives for
the same inputs and weights (``reference/``), and reads as a share: 0 is
equal.  A number the run could not read (a missing output, a shape that
differs, a value that is not finite) reads as infinity, which no limit
passes.
"""

from __future__ import annotations

import contextlib
import math
import sys
from typing import Dict, List, Sequence

import numpy as np
import torch


@contextlib.contextmanager
def exact_float32():
    """float32 products without TF32 (the reference's precision)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    if got is None or tuple(got.shape) != tuple(want.shape):
        return math.inf
    got, want = got.double(), want.double()
    v = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want).clamp(min=1e-30))
    return v if math.isfinite(v) else math.inf


def head_gap(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]) -> float:
    """The larger of the relative L2 gaps of the decoded boxes (cx, cy, w, h)
    and of the scores (objectness and classes) over all the sampled batches'
    head predictions ``[B, A, 5 + nc]``."""
    if len(got) != len(want) or any(g is None or g.shape != w.shape for g, w in zip(got, want)):
        return math.inf
    g = torch.cat([x.float().reshape(-1, x.shape[-1]) for x in got])
    w = torch.cat([x.float().reshape(-1, x.shape[-1]) for x in want])
    return max(rel_l2(g[:, :4], w[:, :4]), rel_l2(g[:, 4:], w[:, 4:]))


def _box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    # boxes grown by 1 px a side: a box clipped flat against the frame's
    # edge still overlaps its copy
    a = a + np.array([-1.0, -1.0, 1.0, 1.0])
    b = b + np.array([-1.0, -1.0, 1.0, 1.0])
    area = lambda x: np.clip(x[:, 2] - x[:, 0], 0, None) * np.clip(x[:, 3] - x[:, 1], 0, None)
    iw = np.clip(np.minimum(a[:, None, 2], b[None, :, 2]) - np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    ih = np.clip(np.minimum(a[:, None, 3], b[None, :, 3]) - np.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = iw * ih
    return inter / (area(a)[:, None] + area(b)[None, :] - inter + 1e-9)


def unmatched(got: np.ndarray, want: np.ndarray, iou: float = 0.5) -> int:
    """Detections of either list with no partner in the other: the wanted
    ones, best score first, each take the unclaimed got detection of their
    class that overlaps them most, by ``iou`` at least."""
    got = np.asarray(got, dtype=np.float64).reshape(-1, 6)
    want = np.asarray(want, dtype=np.float64).reshape(-1, 6)
    if not len(got) or not len(want):
        return len(got) + len(want)
    ious = _box_iou(want[:, :4], got[:, :4])
    ious[want[:, 5][:, None] != got[:, 5][None, :]] = -1
    free = np.ones(len(got), bool)
    matched = 0
    for i in np.argsort(-want[:, 4], kind="stable"):
        cand = np.where(free, ious[i], -1)
        j = int(cand.argmax())
        if cand[j] >= iou:
            free[j] = False
            matched += 1
    return len(got) + len(want) - 2 * matched


def det_gap(got: List[np.ndarray], want: List[np.ndarray]) -> float:
    """The worst image's share of detections without a partner: unmatched
    / (got + wanted), over the images of the sample."""
    if len(got) != len(want) or any(g is None for g in got):
        return math.inf
    worst = 0.0
    for g, w in zip(got, want):
        n = len(np.asarray(g).reshape(-1, 6)) + len(np.asarray(w).reshape(-1, 6))
        worst = max(worst, unmatched(g, w) / max(n, 1))
    return worst


def norm_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             leaves: Sequence[str]) -> Dict[str, float]:
    """Per leaf, the gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf: ``worst`` (the largest), ``leaf`` (its name), ``median`` and
    ``mean``."""
    if any(k not in got or got[k] is None for k in leaves):
        return {"worst": math.inf, "leaf": "missing", "median": math.inf, "mean": math.inf}
    ng = {k: float(torch.linalg.vector_norm(got[k].double())) for k in leaves}
    nw = {k: float(torch.linalg.vector_norm(want[k].double())) for k in leaves}
    med = float(np.median([nw[k] for k in leaves]))
    gaps = {k: abs(ng[k] - nw[k]) / max(nw[k], med, 1e-30) for k in leaves}
    gaps = {k: (v if math.isfinite(v) else math.inf) for k, v in gaps.items()}
    leaf = max(gaps, key=gaps.get)
    return {"worst": gaps[leaf], "leaf": leaf, "median": float(np.median(list(gaps.values()))),
            "mean": float(np.mean(list(gaps.values())))}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """``{name: {"value", "limit"}}`` for every limited number."""
    return {k: {"value": float(numbers.get(k, math.inf)), "limit": limits[k]} for k in limits}


def passed(checked: Dict[str, Dict]) -> bool:
    return bool(checked) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checked.values())


def print_check(checked: Dict[str, Dict]) -> None:
    """Each number beside its limit, as the last lines on standard error."""
    for k, c in checked.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()

