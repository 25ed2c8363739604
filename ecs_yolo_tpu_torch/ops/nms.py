"""Exact greedy non-maximum suppression (counterpart of
``ecs_yolo_tpu/ops/nms.py:non_max_suppression``).

Same semantics as the JAX function: ``obj * cls`` scores for the v1 head, a
static top-``max_nms`` candidate pool per image (ties broken by index, as
``lax.top_k`` does), class separation by offsetting boxes with
``cls * MAX_WH``, greedy pick-and-suppress capped at ``max_det``, and a
``[B, max_det, 6]`` output (x1, y1, x2, y2, conf, cls) zero-padded with a
``valid`` mask.  The JAX version runs a fixed ``max_det`` steps; this one
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy NMS.

    Args:
      prediction: v1 layout ``[B, A, 5+nc]`` (xywh, obj, cls...) when
        ``has_obj``; DFL layout ``[B, 4+nc, A]`` when not.

    Returns:
      out ``[B, max_det, 6]`` float32 and valid ``[B, max_det]`` bool, on
      the prediction's device.
    """
    if multi_label:
        raise NotImplementedError("multi_label NMS is not ported yet")
    if merge:
        raise NotImplementedError("merge NMS is not ported yet")
    pred = prediction.float()
    if not has_obj:
        pred = pred.transpose(1, 2)
        cls_scores = pred[..., 4:]
    else:
        cls_scores = pred[..., 5:] * pred[..., 4:5]
    boxes = xywh2xyxy(pred[..., :4])
    bsz = pred.shape[0]
    out = torch.zeros(bsz, max_det, 6, device=pred.device)
    valid = torch.zeros(bsz, max_det, dtype=torch.bool, device=pred.device)
    offset = 0.0 if agnostic else MAX_WH

    for b in range(bsz):
        cls = cls_scores[b].argmax(-1)
        best = cls_scores[b].gather(-1, cls[:, None])[:, 0]
        order = torch.sort(best, descending=True, stable=True).indices
        order = order[: min(max_nms, order.shape[0])]
        top = best[order]
        n = int((top > conf_thres).sum())
        if n == 0:
            continue
        order, top = order[:n], top[:n]
        cand = boxes[b][order]
        c = cls[order].float()
        off = cand + (c * offset)[:, None]
        area = ((off[:, 2] - off[:, 0]).clamp(min=0)
                * (off[:, 3] - off[:, 1]).clamp(min=0))
        iw = (torch.minimum(off[:, None, 2], off[None, :, 2])
              - torch.maximum(off[:, None, 0], off[None, :, 0])).clamp(min=0)
        ih = (torch.minimum(off[:, None, 3], off[None, :, 3])
              - torch.maximum(off[:, None, 1], off[None, :, 1])).clamp(min=0)
        inter = iw * ih
        iou = inter / (area[None, :] + area[:, None] - inter + 1e-7)
        keep = _greedy((iou > iou_thres).cpu().numpy(), max_det)
        k = torch.tensor(keep, device=pred.device)
        out[b, : len(keep)] = torch.cat(
            [cand[k], top[k, None], c[k, None]], dim=-1)
        valid[b, : len(keep)] = True
    return out, valid
