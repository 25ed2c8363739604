"""The TAL/DFL anchor-free losses (counterpart of
``ecs_yolo_tpu/train/loss_tal.py``; reference utils/loss_tal.py:106-342 and
utils/loss_tal_dual.py).

Static shapes: targets arrive padded ``[B, M, 5]`` with a mask, and the
reference's ``if fg_mask.sum()`` branch is a masked sum, where JAX masks it.
``compute_loss_tal`` (topk 10; the v10 one2one branch's topk 1),
``compute_loss_v10`` (one2many + one2one), ``compute_loss_dual`` and
``compute_loss_triple`` (deep supervision, the auxiliary branches' class
gain scaled by 0.25).  Each returns ``(total * B, items)``, ``items`` the
detached (box, cls, dfl) terms of every branch in order: 3, 6 or 9 values.

Inside ``parallel/mesh.data_parallel`` each loss is this rank's part of the
global batch's: ``target_scores_sum`` is summed over the data ranks
(detached, as the assigner's scores are) and ``B`` is the global batch.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.anchors import bbox2dist, dist2bbox, make_anchors
from ..ops.boxes import bbox_iou, xywh2xyxy
from ..parallel import mesh
from .loss_v1 import bce_logits
from .tal import task_aligned_assigner


def _df_loss(pred_dist: torch.Tensor, target: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Distribution-focal cross-entropy between the two integer bins round
    each target (reference loss_tal.py:94-104).  ``pred_dist`` ``[N, 4,
    reg_max+1]``, ``target`` ``[N, 4]``; returns ``[N, 1]``."""
    tl = target.to(torch.int64)
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    logp = F.log_softmax(pred_dist, dim=-1)
    ce_l = -logp.gather(-1, tl[..., None])[..., 0]
    ce_r = -logp.gather(-1, tr.clamp(0, reg_max)[..., None])[..., 0]
    return (ce_l * wl + ce_r * wr).mean(-1, keepdim=True)


def bbox_decode(anchor_points: torch.Tensor, pred_dist: torch.Tensor,
                reg_max: int) -> torch.Tensor:
    """DFL expectation of ``pred_dist`` ``[B, A, 4*reg_max]`` -> xyxy boxes in
    grid units (reference loss_tal.py:158-164)."""
    b, a, c = pred_dist.shape
    proj = torch.arange(reg_max, dtype=pred_dist.dtype, device=pred_dist.device)
    p = torch.softmax(pred_dist.reshape(b, a, 4, c // 4), dim=-1) @ proj
    return dist2bbox(p, anchor_points, xywh=False)


def compute_loss_tal(feats: Sequence[torch.Tensor], targets: torch.Tensor,
                     t_mask: torch.Tensor, strides: Sequence[float], nc: int,
                     reg_max: int = 16,
                     gains: Tuple[float, float, float] = (7.5, 0.5, 1.5),
                     topk: int = 10, alpha: float = 0.5, beta: float = 6.0,
                     cls_pw: float = 1.0, return_assign: bool = False):
    """``(total * B, (box, cls, dfl))`` of per-level maps ``[B, no, h, w]``
    against ``targets`` ``[B, M, 5]`` (class, x, y, w, h normalised) with
    ``t_mask`` ``[B, M]`` (reference loss_tal.py:166-216).  The assigner sees
    detached predictions.

    With ``return_assign`` a third value, the assignment the segment heads'
    mask loss reads (reference utils/segment/loss_tal.py:198): ``fg_mask``
    and ``target_gt_idx`` ``[B, A]``, ``target_bboxes_px`` ``[B, A, 4]``
    (xyxy in input pixels), ``target_scores_sum`` and ``img_hw`` (the input
    size the strides give, Python floats)."""
    no = nc + reg_max * 4
    b = feats[0].shape[0]
    t_mask = t_mask.bool()
    flat = torch.cat([f.reshape(b, no, -1) for f in feats], dim=2)
    pred_distri = flat[:, : reg_max * 4].permute(0, 2, 1)        # [B, A, 4*reg_max]
    pred_scores = flat[:, reg_max * 4:].permute(0, 2, 1)         # [B, A, nc]

    shapes = [(f.shape[2], f.shape[3]) for f in feats]
    anchor_points, stride_tensor = make_anchors(shapes, strides, 0.5, pred_scores.dtype,
                                                pred_scores.device)
    img_h = shapes[0][0] * strides[0]
    img_w = shapes[0][1] * strides[0]

    gt_labels = targets[..., 0]
    # made on the device: a host tensor copied there would sync the step
    scale = torch.full((4,), img_w, dtype=targets.dtype, device=targets.device)
    scale[1::2] = img_h
    gt_bboxes = xywh2xyxy(targets[..., 1:5] * scale)
    gt_bboxes = torch.where(t_mask[..., None], gt_bboxes, 0.0)
    mask_gt = t_mask & (targets[..., 3] > 0)

    pred_bboxes = bbox_decode(anchor_points, pred_distri, reg_max)    # grid units
    assign = task_aligned_assigner(
        torch.sigmoid(pred_scores.detach()), pred_bboxes.detach() * stride_tensor,
        anchor_points * stride_tensor, gt_labels, gt_bboxes, mask_gt,
        topk=topk, num_classes=nc, alpha=alpha, beta=beta)
    target_bboxes = assign.target_bboxes / stride_tensor
    target_scores = assign.target_scores
    fg = assign.fg_mask
    target_scores_sum = mesh.data_sum(target_scores.sum()).clamp(min=1.0)

    loss_cls = bce_logits(pred_scores, target_scores.to(pred_scores.dtype),
                          cls_pw).sum() / target_scores_sum

    # box and dfl, masked (reference BboxLoss, loss_tal.py:62-92)
    weight = target_scores.sum(-1)
    iou = bbox_iou(pred_bboxes, target_bboxes, xywh=False, SIoU=True)
    loss_iou = torch.where(fg, (1.0 - iou) * weight, 0.0).sum() / target_scores_sum

    target_ltrb = bbox2dist(anchor_points, target_bboxes, reg_max - 1)
    dfl = _df_loss(pred_distri.reshape(-1, 4, reg_max), target_ltrb.reshape(-1, 4),
                   reg_max - 1).reshape(b, -1)
    loss_dfl = torch.where(fg, dfl * weight, 0.0).sum() / target_scores_sum

    box_g, cls_g, dfl_g = gains
    loss = torch.stack([loss_iou * box_g, loss_cls * cls_g, loss_dfl * dfl_g])
    b = mesh.global_batch(b)
    if return_assign:
        return loss.sum() * b, loss.detach(), dict(
            fg_mask=fg, target_gt_idx=assign.target_gt_idx,
            target_bboxes_px=assign.target_bboxes,
            target_scores_sum=target_scores_sum, img_hw=(img_h, img_w))
    return loss.sum() * b, loss.detach()


def compute_loss_v10(out, targets, t_mask, strides, nc: int, reg_max: int = 16):
    """one2many (topk 10) + one2one (topk 1) of a ``V10Output`` (reference
    v10DetectLoss, loss_tal.py:330-342)."""
    many, items_m = compute_loss_tal(out.one2many, targets, t_mask, strides, nc,
                                     reg_max, topk=10)
    one, items_o = compute_loss_tal(out.one2one, targets, t_mask, strides, nc,
                                    reg_max, topk=1)
    return many + one, torch.cat([items_m, items_o])


def compute_loss_dual(d1, d2, targets, t_mask, strides, nc: int, reg_max: int = 16,
                      aux_cls_gain: float = 0.25):
    """The auxiliary branch ``d1`` with its class gain scaled by
    ``aux_cls_gain``, plus the main branch ``d2`` (reference
    utils/loss_tal_dual.py)."""
    aux, items_a = compute_loss_tal(d1, targets, t_mask, strides, nc, reg_max,
                                    gains=(7.5, 0.5 * aux_cls_gain, 1.5))
    main, items_m = compute_loss_tal(d2, targets, t_mask, strides, nc, reg_max)
    return aux + main, torch.cat([items_a, items_m])


def compute_loss_triple(ds, targets, t_mask, strides, nc: int, reg_max: int = 16,
                        aux_cls_gain: float = 0.25):
    """Two auxiliary branches with the scaled class gain, plus the main
    (last) branch."""
    total, items = 0.0, []
    for k, d in enumerate(ds):
        gains = (7.5, 0.5 * (aux_cls_gain if k < len(ds) - 1 else 1.0), 1.5)
        li, it = compute_loss_tal(d, targets, t_mask, strides, nc, reg_max, gains=gains)
        total = total + li
        items.append(it)
    return total, torch.cat(items)
