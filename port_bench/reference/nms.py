"""Plain greedy non-maximum suppression and the letterbox's inverse.

Per image: a candidate is an anchor whose best class score ``obj * cls``
exceeds ``conf``; candidates are taken by score, highest first (ties by
anchor index), at most ``max_nms`` of them; a candidate is kept unless a
kept candidate of its class overlaps it by more than ``iou`` (IoU of xyxy
boxes, areas clamped at zero); at most ``max_det`` are kept.  Boxes are
then mapped from the letterboxed frame to the native one and clipped to it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _iou(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    area = lambda b: np.clip(b[..., 2] - b[..., 0], 0, None) * np.clip(b[..., 3] - b[..., 1], 0, None)
    iw = np.clip(np.minimum(box[2], boxes[:, 2]) - np.maximum(box[0], boxes[:, 0]), 0, None)
    ih = np.clip(np.minimum(box[3], boxes[:, 3]) - np.maximum(box[1], boxes[:, 1]), 0, None)
    inter = iw * ih
    return inter / (area(box) + area(boxes) - inter + 1e-7)


def nms(pred: np.ndarray, conf: float, iou: float, max_det: int,
        max_nms: int = 4096) -> np.ndarray:
    """``pred`` ``[A, 5 + nc]`` (cx, cy, w, h, obj, cls...) of one image, as
    float; returns ``[n, 6]`` (x1, y1, x2, y2, score, cls) in the input's
    pixels, highest score first."""
    pred = pred.astype(np.float64)
    cls_scores = pred[:, 5:] * pred[:, 4:5]
    cls = cls_scores.argmax(1)
    score = cls_scores[np.arange(len(pred)), cls]
    order = np.argsort(-score, kind="stable")[:max_nms]
    order = order[score[order] > conf]
    xy, half = pred[order, :2], pred[order, 2:4] / 2
    boxes = np.concatenate([xy - half, xy + half], 1)
    c = cls[order]
    alive = np.ones(len(order), bool)
    keep = []
    for i in range(len(order)):
        if not alive[i]:
            continue
        keep.append(i)
        if len(keep) == max_det:
            break
        rest = np.nonzero(alive[i + 1:] & (c[i + 1:] == c[i]))[0] + i + 1
        alive[rest[_iou(boxes[i], boxes[rest]) > iou]] = False
    keep = np.array(keep, dtype=np.int64)
    return np.concatenate([boxes[keep], score[order][keep, None],
                           c[keep, None].astype(np.float64)], 1)


def to_native(dets: np.ndarray, lb_hw: Tuple[int, int], native_hw: Tuple[int, int]) -> np.ndarray:
    gain = min(lb_hw[0] / native_hw[0], lb_hw[1] / native_hw[1])
    pad_w = (lb_hw[1] - native_hw[1] * gain) / 2
    pad_h = (lb_hw[0] - native_hw[0] * gain) / 2
    out = dets.copy()
    out[:, [0, 2]] = ((out[:, [0, 2]] - pad_w) / gain).clip(0, native_hw[1])
    out[:, [1, 3]] = ((out[:, [1, 3]] - pad_h) / gain).clip(0, native_hw[0])
    return out
