"""Alternative NMS algorithms (counterpart of
``ecs_yolo_tpu/ops/nms_variants.py``): Gaussian soft-NMS, cluster-NMS, its
DIoU criterion, and the score-penalty (SPM) variants, on one image's
candidate pool ``boxes [n, 4]`` (xyxy) and ``scores [n]``.

Plain tensor code on the pool's device, as the JAX functions run outside
any kernel.  The cluster variants sort with a stable ``argsort(-scores)``
(equal scores keep their index order, as ``jnp.argsort``) and return
``(order, keep)`` over the sorted pool; ``cluster_nms``'s fixed point is
greedy NMS's keep set.  ``soft_nms`` runs its ``max_det`` picks on the
device with no host sync (``argmax`` takes the first of equal scores, as
``jnp.argmax``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .boxes import box_iou

NEG_INF = -1e9


def _triu(n: int, device) -> torch.Tensor:
    return torch.ones(n, n, dtype=torch.bool, device=device).triu(1)


def _iou_upper(boxes: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """IoU of each box with every later (lower-scored) one, 0 elsewhere."""
    iou = box_iou(boxes, boxes, eps)
    return torch.where(_triu(boxes.shape[0], boxes.device), iou, 0.0)


def _diou_penalty(boxes: torch.Tensor) -> torch.Tensor:
    """DIoU's centre-distance term: squared centre distance over the
    squared diagonal of the enclosing box."""
    cx = (boxes[:, 0] + boxes[:, 2]) / 2
    cy = (boxes[:, 1] + boxes[:, 3]) / 2
    rho2 = (cx[None] - cx[:, None]) ** 2 + (cy[None] - cy[:, None]) ** 2
    x1 = torch.minimum(boxes[:, None, 0], boxes[None, :, 0])
    y1 = torch.minimum(boxes[:, None, 1], boxes[None, :, 1])
    x2 = torch.maximum(boxes[:, None, 2], boxes[None, :, 2])
    y2 = torch.maximum(boxes[:, None, 3], boxes[None, :, 3])
    return rho2 / ((x2 - x1) ** 2 + (y2 - y1) ** 2 + 1e-7)


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float = 0.3,
             sigma: float = 0.5, score_thres: float = 0.25,
             max_det: int = 300) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaussian soft-NMS: ``max_det`` times, pick the highest live score,
    decay every score by ``exp(-iou^2 / sigma)`` of its IoU with the pick,
    and retire the pick (``NEG_INF``, decayed like the rest afterwards, as
    in JAX).  Returns the picks ``[max_det]`` and their scores, 0 where a
    score is not above ``score_thres``.  ``iou_thres`` is JAX's unused
    field."""
    area = (boxes[:, 2] - boxes[:, 0]).clamp(min=0) * (boxes[:, 3] - boxes[:, 1]).clamp(min=0)
    live = scores.clone()
    picks, kept = [], []
    for _ in range(max_det):
        i = live.argmax().reshape(1)        # a tensor index: no host sync a pick
        b = boxes.index_select(0, i)[0]
        inter = ((torch.minimum(boxes[:, 2], b[2]) - torch.maximum(boxes[:, 0], b[0])).clamp(min=0)
                 * (torch.minimum(boxes[:, 3], b[3]) - torch.maximum(boxes[:, 1], b[1])).clamp(min=0))
        iou = inter / (area + area.index_select(0, i) - inter + 1e-7)
        picks.append(i)
        kept.append(live.index_select(0, i))
        live = (live * torch.exp(-(iou ** 2) / sigma)).index_fill(0, i, NEG_INF)
    idx, kept = torch.cat(picks), torch.cat(kept)
    return idx, torch.where(kept > score_thres, kept, 0.0)


def _cluster(iou: torch.Tensor, iou_thres: float, iterations: int) -> torch.Tensor:
    """The fixed point of ``keep <- max_i(iou[i, j] * keep[i]) <= thr`` from
    all-kept, after at most ``iterations`` updates (JAX's ``while_loop``)."""
    keep = torch.ones(iou.shape[0], dtype=torch.bool, device=iou.device)
    for _ in range(iterations):
        new = (iou * keep[:, None]).max(0).values <= iou_thres
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def cluster_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float = 0.5,
                iterations: int = 200) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster-NMS: ``(order, keep)``; ``order[keep]`` is the greedy keep
    set at ``iou_thres`` among the positive scores."""
    order = torch.argsort(-scores, stable=True)
    keep = _cluster(_iou_upper(boxes[order]), iou_thres, iterations)
    return order, keep & (scores[order] > 0)


def cluster_diou_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float = 0.5,
                     iterations: int = 200) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster-NMS on DIoU (IoU less the centre-distance term)."""
    order = torch.argsort(-scores, stable=True)
    bs = boxes[order]
    diou = _iou_upper(bs) - torch.where(_triu(bs.shape[0], bs.device), _diou_penalty(bs), 0.0)
    return order, _cluster(diou, iou_thres, iterations) & (scores[order] > 0)


def _spm(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float, iterations: int,
         score_thres: float, dist: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    order = torch.argsort(-scores, stable=True)
    bs = boxes[order]
    iou = _iou_upper(bs)
    b = iou
    for _ in range(iterations):
        b = iou * (b.max(0).values <= iou_thres).to(boxes.dtype)[:, None]
    if dist:
        d = torch.where(_triu(bs.shape[0], bs.device), _diou_penalty(bs), 0.0)
        penalty = torch.prod(torch.clamp(1.0 - b + d, max=1.0), 0)
    else:
        penalty = torch.prod(1.0 - b, 0)
    return order, scores[order] * penalty > score_thres


def cluster_spm_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float = 0.5,
                    iterations: int = 3, score_thres: float = 0.25):
    """Cluster-SPM: each score times ``prod(1 - iou)`` over the boxes kept
    above it after ``iterations`` rounds; ``(order, new score >
    score_thres)``."""
    return _spm(boxes, scores, iou_thres, iterations, score_thres, dist=False)


def cluster_spm_dist_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float = 0.5,
                         iterations: int = 3, score_thres: float = 0.25):
    """Cluster-SPM with the distance term: ``prod(min(1 - iou + d, 1))``."""
    return _spm(boxes, scores, iou_thres, iterations, score_thres, dist=True)
