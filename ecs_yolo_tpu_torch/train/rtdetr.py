"""RT-DETR training ops (counterpart of ``ecs_yolo_tpu/train/rtdetr.py``):
the Hungarian matching, contrastive denoising groups and the
set-prediction loss.

The assignment runs on the host (scipy's ``linear_sum_assignment``, as
JAX's ``pure_callback``): a call copies its batch's stacked cost matrices
``[B, Q, M]`` to the host once and the assignment back once.  Ground truths
are padded to M with a mask; a padded one costs ``BIG`` and is never
matched.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.boxes import bbox_iou, xywh2xyxy

BIG = 1e6


def _lsa_host(cost: np.ndarray) -> np.ndarray:
    """The column assigned to each row of one ``[Q, M]`` cost (-1: none)."""
    from scipy.optimize import linear_sum_assignment

    out = np.full(cost.shape[0], -1, np.int32)
    r, c = linear_sum_assignment(cost)
    out[r] = c
    return out


def _match_cost(pred_scores, pred_bboxes, gt_labels, gt_bboxes, gt_mask,
               cost_gain: Optional[Dict[str, float]] = None, use_fl: bool = True,
               alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """The matching cost ``[..., Q, M]`` of queries (``pred_scores [..., Q,
    nc]`` after the sigmoid, ``pred_bboxes [..., Q, 4]`` normalised xywh)
    against ground truths (``gt_labels [..., M]``, ``gt_bboxes [..., M,
    4]``, ``gt_mask [..., M]``): the focal class cost (or ``-score``), L1
    and ``1 - GIoU`` weighted by ``cost_gain`` (class 1, bbox 5, giou 2);
    ``BIG`` where a ground truth is padded and in place of NaN / inf."""
    g = {"class": 1.0, "bbox": 5.0, "giou": 2.0, **(cost_gain or {})}
    q = pred_scores.shape[-2]
    labels = gt_labels.long().clamp(min=0)
    scores = torch.gather(pred_scores, -1,
                          labels[..., None, :].expand(*labels.shape[:-1], q, labels.shape[-1]))
    if use_fl:
        neg = (1 - alpha) * scores ** gamma * (-torch.log1p(-scores + 1e-8))
        pos = alpha * (1 - scores) ** gamma * (-torch.log(scores + 1e-8))
        cost_class = pos - neg
    else:
        cost_class = -scores
    l1 = (pred_bboxes[..., :, None, :] - gt_bboxes[..., None, :, :]).abs().sum(-1)
    giou = bbox_iou(xywh2xyxy(pred_bboxes)[..., :, None, :],
                    xywh2xyxy(gt_bboxes)[..., None, :, :], xywh=False, GIoU=True)
    cost = g["class"] * cost_class + g["bbox"] * l1 + g["giou"] * (1.0 - giou)
    cost = torch.where(gt_mask[..., None, :], cost, BIG)
    return torch.nan_to_num(cost, nan=BIG, posinf=BIG, neginf=-BIG)


@torch.no_grad()
def hungarian_match(pred_scores, pred_bboxes, gt_labels, gt_bboxes, gt_mask,
                    cost_gain: Optional[Dict[str, float]] = None, use_fl: bool = True,
                    alpha: float = 0.25, gamma: float = 2.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hungarian matching of one image (``[Q, nc]``, ...) or of a batch
    (``[B, Q, nc]``, ...): ``(row_to_gt [..., Q] int32, matched [..., Q])``,
    the ground truth each query takes (-1: none) and whether that is a real
    match (not padded, not a ``BIG`` cost).  The costs go to the host in one
    copy and the assignment comes back in one; no gradient."""
    cost = _match_cost(pred_scores, pred_bboxes, gt_labels, gt_bboxes, gt_mask, cost_gain,
                      use_fl, alpha, gamma)
    host = cost.cpu().numpy()
    flat = host.reshape((-1,) + host.shape[-2:])
    rows = np.stack([_lsa_host(c) for c in flat]).reshape(host.shape[:-1])
    row_to_gt = torch.from_numpy(rows).to(cost.device)
    m = gt_mask.shape[-1]
    idx = row_to_gt.long().clamp(0, m - 1)
    chosen = torch.gather(cost, -1, idx[..., None])[..., 0]
    matched = (row_to_gt >= 0) & torch.gather(gt_mask, -1, idx) & (chosen < BIG / 2)
    return row_to_gt, matched


def cdn_draws(batch: int, m: int, num_classes: int, generator: torch.Generator,
              device=None) -> Dict[str, torch.Tensor]:
    """The random draws of ``get_cdn_group``, on ``device`` from
    ``generator`` (which lives there): ``flip_u [B, M]`` (uniform: a label
    flips below ``cls_noise_ratio / 2``), ``rand_cls [B, M]`` (the flipped
    labels), ``signs [B, M, 4]`` (+-1, one draw for both halves, as JAX's
    one ``k_sign`` key), ``u_pos`` / ``u_neg [B, M, 4]`` (uniform box
    noise)."""
    kw = {"generator": generator, "device": device}
    return {"flip_u": torch.rand(batch, m, **kw),
            "rand_cls": torch.randint(0, num_classes, (batch, m), **kw),
            "signs": torch.randint(0, 2, (batch, m, 4), **kw) * 2 - 1,
            "u_pos": torch.rand(batch, m, 4, **kw), "u_neg": torch.rand(batch, m, 4, **kw)}


def cdn_group(gt_labels, gt_bboxes, gt_mask, num_classes: int, draws: Dict[str, torch.Tensor],
              cls_noise_ratio: float = 0.5, box_noise_scale: float = 1.0):
    """Contrastive denoising groups from ``draws`` (``cdn_draws``): each
    ground truth twice, a positive with its label flipped where ``flip_u <
    cls_noise_ratio / 2`` and its xyxy corners moved by ``u_pos * signs``
    times half its size (``box_noise_scale``), and a negative labelled
    ``num_classes`` (background) moved by ``(1 + u_neg) * signs``, both
    clipped to the image.  Returns ``dn_labels [B, 2M]``, ``dn_bboxes [B,
    2M, 4]`` (xywh) and ``dn_mask [B, 2M]``."""
    flip = draws["flip_u"] < cls_noise_ratio * 0.5
    noisy = torch.where(flip, draws["rand_cls"].to(torch.int32), gt_labels.to(torch.int32))
    wh = gt_bboxes[..., 2:4]
    diff = torch.cat([wh, wh], -1) * 0.5 * box_noise_scale
    signs = draws["signs"].to(gt_bboxes.dtype)

    def jitter(u):
        xyxy = (xywh2xyxy(gt_bboxes) + u.to(gt_bboxes.dtype) * signs * diff).clamp(0.0, 1.0)
        return torch.cat([(xyxy[..., :2] + xyxy[..., 2:]) / 2, xyxy[..., 2:] - xyxy[..., :2]], -1)

    dn_labels = torch.cat([noisy, torch.full_like(noisy, num_classes)], 1)
    dn_bboxes = torch.cat([jitter(draws["u_pos"]), jitter(draws["u_neg"] + 1.0)], 1)
    return dn_labels, dn_bboxes, torch.cat([gt_mask, gt_mask], 1)


def get_cdn_group(gt_labels, gt_bboxes, gt_mask, num_classes: int, num_queries: int,
                  generator: torch.Generator, num_dn: int = 100,
                  cls_noise_ratio: float = 0.5, box_noise_scale: float = 1.0):
    """``cdn_group`` on fresh draws from ``generator`` (``cdn_draws``).
    ``num_queries`` and ``num_dn`` are JAX's unused arguments: every image
    gets exactly ``2 M`` denoising queries, ``M`` the padded count."""
    b, m = gt_labels.shape
    draws = cdn_draws(b, m, num_classes, generator, gt_bboxes.device)
    return cdn_group(gt_labels, gt_bboxes, gt_mask, num_classes, draws, cls_noise_ratio,
                     box_noise_scale)


def rtdetr_loss(pred_scores, pred_bboxes, gt_labels, gt_bboxes, gt_mask, nc: int,
                gains: Optional[Dict[str, float]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Set-prediction loss (JAX ``rtdetr_loss``): the Hungarian assignment
    of the sigmoid scores (``pred_scores [B, Q, nc]`` logits) and boxes,
    taken without gradient; a focal-weighted BCE over every query and class
    (weights 0.75 / 0.25, modulated by ``|target - p|^2``), L1 and ``1 -
    GIoU`` over the matches, each over the match count (at least 1).
    Returns ``(total, items)``, items ``[cls, bbox, giou]`` detached."""
    g = {"class": 1.0, "bbox": 5.0, "giou": 2.0, **(gains or {})}
    p = torch.sigmoid(pred_scores)
    row_to_gt, matched = hungarian_match(p.detach(), pred_bboxes.detach(), gt_labels,
                                         gt_bboxes, gt_mask)
    idx = row_to_gt.long().clamp(0, gt_labels.shape[1] - 1)
    tgt_labels = torch.gather(gt_labels.long(), 1, idx)
    tgt_boxes = torch.gather(gt_bboxes, 1, idx[..., None].expand(-1, -1, 4))
    classes = torch.arange(nc, device=p.device)
    one_hot = (tgt_labels[..., None] == classes).to(p.dtype) * matched[..., None]
    ce = -(one_hot * torch.log(p + 1e-8) + (1 - one_hot) * torch.log1p(-p + 1e-8))
    w = one_hot * 0.75 + (1 - one_hot) * 0.25
    n_match = matched.sum().clamp(min=1)
    loss_cls = (ce * w * (one_hot - p).abs() ** 2.0).sum() / n_match
    l1 = (pred_bboxes - tgt_boxes).abs().sum(-1)
    giou = bbox_iou(xywh2xyxy(pred_bboxes), xywh2xyxy(tgt_boxes), xywh=False, GIoU=True)
    loss_bbox = torch.where(matched, l1, 0.0).sum() / n_match
    loss_giou = torch.where(matched, 1.0 - giou, 0.0).sum() / n_match
    total = g["class"] * loss_cls + g["bbox"] * loss_bbox + g["giou"] * loss_giou
    return total, torch.stack([loss_cls, loss_bbox, loss_giou]).detach()
