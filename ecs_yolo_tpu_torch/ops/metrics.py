"""Host-side (numpy) detection metrics (counterpart of
``ecs_yolo_tpu/ops/metrics.py``, the same numpy code kept as the port's own
copy).

Equivalents of reference utils/metrics.py (ap_per_class:21, compute_ap,
ConfusionMatrix:114, fitness:15) and val.py:80-126 (process_batch).  They
consume NMS outputs already copied to the host, so plain numpy is the right
tool (the reference likewise runs them on CPU tensors).
"""

from __future__ import annotations

from typing import List

import numpy as np


# numpy 2 renamed trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def fitness(x: np.ndarray) -> np.ndarray:
    """Weighted fitness of [P, R, mAP@.5, mAP@.5:.95] — reference
    utils/metrics.py:15-18 (0.1*mAP50 + 0.9*mAP)."""
    w = np.array([0.0, 0.0, 0.1, 0.9])
    return (x[:, :4] * w).sum(1)


def box_iou_np(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7):
    """Pairwise IoU [N,M] of xyxy boxes."""
    a1 = box1[:, None, :2]
    a2 = box1[:, None, 2:4]
    b1 = box2[None, :, :2]
    b2 = box2[None, :, 2:4]
    inter = np.clip(np.minimum(a2, b2) - np.maximum(a1, b1), 0, None).prod(-1)
    area1 = (box1[:, 2] - box1[:, 0]) * (box1[:, 3] - box1[:, 1])
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    return inter / (area1[:, None] + area2[None, :] - inter + eps)


def process_batch(
    detections: np.ndarray, labels: np.ndarray, iouv: np.ndarray
) -> np.ndarray:
    """TP matrix [n_det, n_iou_thresholds] (reference val.py:80-126):
    greedy unique matching at each IoU threshold with class agreement.

    detections: [N, 6] x1 y1 x2 y2 conf cls ;  labels: [M, 5] cls x1 y1 x2 y2.
    """
    correct = np.zeros((detections.shape[0], iouv.shape[0]), dtype=bool)
    if labels.shape[0] == 0 or detections.shape[0] == 0:
        return correct
    iou = box_iou_np(labels[:, 1:], detections[:, :4])
    correct_class = labels[:, 0:1] == detections[:, 5][None]
    for i, t in enumerate(iouv):
        cand = np.nonzero((iou >= t) & correct_class)  # (label_i, det_i)
        if cand[0].shape[0]:
            m = np.stack(
                [cand[0], cand[1], iou[cand[0], cand[1]]], axis=1
            )
            if cand[0].shape[0] > 1:
                m = m[m[:, 2].argsort()[::-1]]
                m = m[np.unique(m[:, 1], return_index=True)[1]]
                m = m[np.unique(m[:, 0], return_index=True)[1]]
            correct[m[:, 1].astype(int), i] = True
    return correct


def compute_ap(recall: np.ndarray, precision: np.ndarray):
    """101-point interpolated AP from PR points (reference metrics.py)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = _trapezoid(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def ap_per_class(
    tp: np.ndarray,
    conf: np.ndarray,
    pred_cls: np.ndarray,
    target_cls: np.ndarray,
    eps: float = 1e-16,
):
    """Per-class P/R/AP (reference utils/metrics.py:21-111).

    Returns (tp_count, fp_count, p, r, f1, ap[nc, n_iou], unique_classes)
    where p, r, f1 are at the F1-optimal confidence.
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]

    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        i = pred_cls == c
        n_l = nt[ci]
        n_p = i.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[i]).cumsum(0)
        tpc = tp[i].cumsum(0)
        recall = tpc / (n_l + eps)
        precision = tpc / (tpc + fpc)
        r_curve[ci] = np.interp(-px, -conf[i], recall[:, 0], left=0)
        p_curve[ci] = np.interp(-px, -conf[i], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], _, _ = compute_ap(recall[:, j], precision[:, j])

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i = f1_curve.mean(0).argmax()
    p, r, f1 = p_curve[:, i], r_curve[:, i], f1_curve[:, i]
    tp_count = (r * nt).round()
    fp_count = (tp_count / (p + eps) - tp_count).round()
    return tp_count, fp_count, p, r, f1, ap, unique_classes.astype(int)


class ConfusionMatrix:
    """Per-class confusion with background FP/FN rows
    (reference utils/metrics.py:114-189)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections: np.ndarray, labels: np.ndarray):
        if detections is None or detections.shape[0] == 0:
            for gc in labels[:, 0].astype(int):
                self.matrix[self.nc, gc] += 1  # background FN
            return
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int)
        det_classes = detections[:, 5].astype(int)
        if labels.shape[0]:
            iou = box_iou_np(labels[:, 1:], detections[:, :4])
            x = np.nonzero(iou > self.iou_thres)
            if x[0].shape[0]:
                m = np.stack([x[0], x[1], iou[x[0], x[1]]], 1)
                if x[0].shape[0] > 1:
                    m = m[m[:, 2].argsort()[::-1]]
                    m = m[np.unique(m[:, 1], return_index=True)[1]]
                    m = m[m[:, 2].argsort()[::-1]]
                    m = m[np.unique(m[:, 0], return_index=True)[1]]
            else:
                m = np.zeros((0, 3))
        else:
            m = np.zeros((0, 3))

        matched = m.shape[0] > 0
        m0, m1 = m[:, 0].astype(int), m[:, 1].astype(int)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if matched and j.sum() == 1:
                self.matrix[det_classes[m1[j][0]], gc] += 1  # correct/confused
            else:
                self.matrix[self.nc, gc] += 1  # background FN
        for i, dc in enumerate(det_classes):
            if not matched or not (m1 == i).any():
                self.matrix[dc, self.nc] += 1  # background FP

    def tp_fp(self):
        tp = self.matrix.diagonal()
        fp = self.matrix.sum(1) - tp
        return tp[:-1], fp[:-1]


def coco80_to_coco91_class() -> List[int]:
    """COCO paper 91-class index for each of the 80 detection classes
    (reference utils/general.py:533)."""
    return [
        1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20,
        21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
        41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
        59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79,
        80, 81, 82, 84, 85, 86, 87, 88, 89, 90,
    ]
