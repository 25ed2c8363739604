"""Exact greedy non-maximum suppression (counterpart of
``ecs_yolo_tpu/ops/nms.py:non_max_suppression``).

Same semantics as the JAX function: ``obj * cls`` scores for the v1 head, a
static top-``max_nms`` candidate pool per image (ties broken by index, as
``lax.top_k`` does), class separation by offsetting boxes with
``cls * MAX_WH``, greedy pick-and-suppress capped at ``max_det``, and a
``[B, max_det, 6]`` output (x1, y1, x2, y2, conf, cls) zero-padded with a
``valid`` mask.  ``multi_label`` scores every (anchor, class) pair as its own
candidate; ``merge`` replaces each kept box by the score-weighted mean of
the candidates that overlap it, and with ``redundant`` drops a kept box no
other candidate supports (its row stays in place, zeroed and invalid, as in
the JAX output).  The JAX version runs a fixed ``max_det`` steps; this one
stops once no live candidate scores above ``conf_thres``, which gives the
same result.  The candidates' IoU matrix is computed on the device; the
greedy walk over it runs on the host.  Scores and boxes are taken in float32
whatever the prediction's dtype (a bf16 ``cls * MAX_WH`` offset would lose
the box coordinates).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .boxes import xywh2xyxy

MAX_WH = 4096.0


def _greedy(supp: np.ndarray, max_det: int) -> list:
    """Indices kept by greedy NMS over candidates sorted by score, given
    ``supp[i, j]`` = candidate i suppresses candidate j."""
    keep = []
    removed = np.zeros(supp.shape[0], dtype=bool)
    for i in range(supp.shape[0]):
        if removed[i]:
            continue
        keep.append(i)
        if len(keep) == max_det:
            break
        removed |= supp[i]
    return keep


def _pair_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU ``[len(a), len(b)]`` of xyxy boxes, areas clamped at zero."""
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0) * (a[:, 3] - a[:, 1]).clamp(min=0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(min=0)
    iw = (torch.minimum(a[:, None, 2], b[None, :, 2])
          - torch.maximum(a[:, None, 0], b[None, :, 0])).clamp(min=0)
    ih = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 1], b[None, :, 1])).clamp(min=0)
    inter = iw * ih
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-7)


def non_max_suppression(
    prediction: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    multi_label: bool = False,
    agnostic: bool = False,
    max_det: int = 300,
    max_nms: int = 4096,
    has_obj: bool = True,
    merge: bool = False,
    redundant: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy NMS.

    Args:
      prediction: v1 layout ``[B, A, 5+nc]`` (xywh, obj, cls...) when
        ``has_obj``; DFL layout ``[B, 4+nc, A]`` when not.
      multi_label: every (anchor, class) score is a candidate (the flat
        ``A*nc`` scores, top ``max_nms``); with one class it is the
        single-label path.
      merge: each kept box becomes the score-weighted mean of the
        conf-passing candidates of its class that overlap it by more than
        ``iou_thres``; with ``redundant`` a kept box needs at least one
        such candidate besides itself or it is dropped.

    Returns:
      out ``[B, max_det, 6]`` float32 and valid ``[B, max_det]`` bool, on
      the prediction's device.
    """
    pred = prediction.float()
    if not has_obj:
        pred = pred.transpose(1, 2)
        cls_scores = pred[..., 4:]
    else:
        cls_scores = pred[..., 5:] * pred[..., 4:5]
    boxes = xywh2xyxy(pred[..., :4])
    bsz, _, nc = cls_scores.shape
    out = torch.zeros(bsz, max_det, 6, device=pred.device)
    valid = torch.zeros(bsz, max_det, dtype=torch.bool, device=pred.device)
    offset = 0.0 if agnostic else MAX_WH

    for b in range(bsz):
        if multi_label and nc > 1:
            scores = cls_scores[b].reshape(-1)
        else:
            cls_best = cls_scores[b].argmax(-1)
            scores = cls_scores[b].gather(-1, cls_best[:, None])[:, 0]
        order = torch.sort(scores, descending=True, stable=True).indices
        order = order[: min(max_nms, order.shape[0])]
        top = scores[order]
        n = int((top > conf_thres).sum())
        if n == 0:
            continue
        order, top = order[:n], top[:n]
        if multi_label and nc > 1:
            anchor, cls = order // nc, order % nc
        else:
            anchor, cls = order, cls_best[order]
        cand = boxes[b][anchor]
        c = cls.float()
        off = cand + (c * offset)[:, None]
        over = _pair_iou(off, off) > iou_thres
        keep = _greedy(over.cpu().numpy(), max_det)
        k = torch.tensor(keep, device=pred.device)
        kept, ok = cand[k], torch.ones(len(keep), dtype=torch.bool,
                                       device=pred.device)
        if merge:
            w = over[k].float() * top.clamp(min=0)[None]
            kept = (w @ cand) / w.sum(-1, keepdim=True).clamp(min=1e-9)
            if redundant:
                ok = over[k].sum(-1) > 1
        rows = torch.cat([kept, top[k, None], c[k, None]], dim=-1)
        out[b, : len(keep)] = torch.where(ok[:, None], rows, 0.0)
        valid[b, : len(keep)] = ok
    return out, valid


def v10_postprocess(prediction: torch.Tensor,
                    max_det: int = 300) -> Tuple[torch.Tensor, torch.Tensor]:
    """NMS-free top-k of a v10 head (JAX ``ops/nms.py:v10_postprocess``):
    every (anchor, class) score of an image ranked together and the
    ``max_det`` best kept.  ``prediction`` ``[B, 4+nc, A]`` decoded xywh +
    class scores; returns ``[B, max_det, 6]`` (x1, y1, x2, y2, conf, cls)
    and a ``valid`` mask (score > 0).  Equal scores keep the lower flat
    index first, as ``lax.top_k`` does (a stable descending sort)."""
    pred = prediction.transpose(1, 2)
    boxes = xywh2xyxy(pred[..., :4])
    scores = pred[..., 4:]
    b, a, nc = scores.shape
    flat = scores.reshape(b, a * nc)
    top, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    top, idx = top[:, :max_det], idx[:, :max_det]
    a_idx = torch.div(idx, nc, rounding_mode="floor")
    c_idx = (idx % nc).to(prediction.dtype)
    bx = boxes.gather(1, a_idx[..., None].expand(-1, -1, 4))
    out = torch.cat([bx, top[..., None], c_idx[..., None]], dim=-1)
    return out, top > 0
