"""Anchor quality check and k-means/genetic anchor evolution (counterpart
of ``ecs_yolo_tpu/utils/autoanchor.py``; reference utils/autoanchor.py):
``check_anchors`` (the best-possible-recall gate at 0.98) and
``kmean_anchors`` (k-means on the box sizes, then genetic mutation under the
fitness metric, from ``np.random.RandomState(seed)``).  numpy on the host,
once before training.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .general import LOGGER


def _wh_metric(wh: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """ratio metric r = min(w/aw, aw/w) * min(h/ah, ah/h) -> best per box."""
    r = wh[:, None] / anchors[None]  # [n, k, 2]
    x = np.minimum(r, 1.0 / r).min(2)  # [n, k]
    return x


def anchor_fitness(wh: np.ndarray, anchors: np.ndarray, thr: float = 0.25):
    x = _wh_metric(wh, anchors)
    best = x.max(1)
    return (best * (best > thr)).mean()


def best_possible_recall(wh: np.ndarray, anchors: np.ndarray, thr: float = 4.0):
    x = _wh_metric(wh, anchors)
    best = x.max(1)
    return (best > 1.0 / thr).mean()


def kmean_anchors(
    wh: np.ndarray,
    n: int = 9,
    img_size: int = 640,
    thr: float = 4.0,
    gen: int = 1000,
    seed: int = 0,
    verbose: bool = False,
) -> np.ndarray:
    """K-means anchors + genetic evolution (reference utils/autoanchor.py:65).

    Args:
      wh: [m, 2] box sizes in pixels (already scaled to img_size).
    Returns anchors [n, 2] sorted by area.
    """
    thr_m = 1.0 / thr
    rng = np.random.RandomState(seed)
    wh = wh[(wh >= 2.0).any(1)]  # filter tiny boxes (reference filters < 2px)

    # k-means (Lloyd's, kmeans++-style seeding on the ratio metric)
    idx = rng.choice(len(wh), size=n, replace=False)
    k = wh[idx].astype(np.float64)
    for _ in range(30):
        d = _wh_metric(wh, k)  # similarity [m, n]
        assign = d.argmax(1)
        for j in range(n):
            sel = wh[assign == j]
            if len(sel):
                k[j] = sel.mean(0)

    # genetic evolution on fitness
    f = anchor_fitness(wh, k, thr_m)
    shape = k.shape
    mp, s = 0.9, 0.1  # mutation probability, sigma
    for _ in range(gen):
        v = np.ones(shape)
        while (v == 1).all():
            v = (
                (rng.random(shape) < mp) * rng.random() * rng.randn(*shape) * s
                + 1
            ).clip(0.3, 3.0)
        kg = (k * v).clip(2.0, img_size)
        fg = anchor_fitness(wh, kg, thr_m)
        if fg > f:
            f, k = fg, kg.copy()
    k = k[np.argsort(k.prod(1))]
    if verbose:
        LOGGER.info(
            f"autoanchor: n={n}, fitness={f:.4f}, "
            f"bpr={best_possible_recall(wh, k, thr):.4f}"
        )
    return k.astype(np.float32)


def dataset_wh(labels: Sequence[np.ndarray], shapes_hw, img_size: int = 640):
    """Collect label wh in pixels at train scale (reference check_anchors)."""
    whs = []
    for lb, (h, w) in zip(labels, shapes_hw):
        if len(lb):
            scale = img_size / max(h, w)
            whs.append(lb[:, 3:5] * [w * scale, h * scale])
    return np.concatenate(whs, 0) if whs else np.zeros((0, 2))


def check_anchors(
    labels,
    shapes_hw,
    anchors_px: np.ndarray,
    thr: float = 4.0,
    imgsz: int = 640,
) -> Tuple[np.ndarray, bool]:
    """BPR gate: if best-possible-recall < 0.98, recompute anchors
    (reference utils/autoanchor.py:28-62).  Returns (anchors, recomputed)."""
    wh = dataset_wh(labels, shapes_hw, imgsz)
    if len(wh) == 0:
        return anchors_px, False
    # reference jitters wh by ~±10% image-scale noise before checking
    bpr = best_possible_recall(wh, anchors_px.reshape(-1, 2), thr)
    LOGGER.info(f"autoanchor: BPR = {bpr:.4f}")
    if bpr > 0.98:
        return anchors_px, False
    n = anchors_px.reshape(-1, 2).shape[0]
    new = kmean_anchors(wh, n=n, img_size=imgsz, thr=thr)
    new_bpr = best_possible_recall(wh, new, thr)
    if new_bpr > bpr:
        LOGGER.info(f"autoanchor: improved BPR {bpr:.4f} -> {new_bpr:.4f}")
        return new.reshape(anchors_px.shape), True
    return anchors_px, False
