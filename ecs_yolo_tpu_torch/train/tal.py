"""Task-aligned assigner (counterpart of ``ecs_yolo_tpu/train/tal.py``;
reference utils/tal/assigner.py:51-179).

Static shapes throughout, as the JAX function has them: the targets arrive
padded to ``[B, M, ...]`` with a validity mask, and every data-dependent
branch of the reference is a masked computation.  There is no ``nonzero``,
no boolean indexing and no host read, so a train step that calls it keeps
the host from waiting for the device.

Ties: ``jax.lax.top_k`` puts the lower index first among equal values, and
``torch.topk`` promises no order.  At initialisation most in-box anchors
have an align metric of exactly 0 (a predicted box that misses its target),
so the order of ties decides ``mask_pos`` and with it the targets.
:func:`select_topk_candidates` therefore takes a stable descending sort and
keeps its first ``topk`` entries.  ``torch.argmax`` takes the first
maximum, as ``jnp.argmax`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.boxes import bbox_iou


class AssignResult(NamedTuple):
    target_labels: torch.Tensor   # [B, A]
    target_bboxes: torch.Tensor   # [B, A, 4]
    target_scores: torch.Tensor   # [B, A, nc]
    fg_mask: torch.Tensor         # [B, A] bool
    target_gt_idx: torch.Tensor   # [B, A] the gt row assigned to each anchor


def select_candidates_in_gts(xy_centers: torch.Tensor, gt_bboxes: torch.Tensor,
                             eps: float = 1e-9) -> torch.Tensor:
    """``[A, 2]`` x ``[B, M, 4]`` -> ``[B, M, A]`` bool: the anchor centre
    lies strictly inside the gt box."""
    lt = gt_bboxes[..., None, :2]
    rb = gt_bboxes[..., None, 2:]
    c = xy_centers[None, None]
    deltas = torch.cat([c - lt, rb - c], dim=-1)
    return deltas.amin(-1) > eps


def select_highest_overlaps(mask_pos: torch.Tensor, overlaps: torch.Tensor,
                            n_max_boxes: int):
    """An anchor assigned to several gts keeps the one of highest IoU
    (reference assigner.py:25-49).  Returns ``(target_gt_idx, fg_mask,
    mask_pos)``."""
    fg_mask = mask_pos.sum(-2)
    mask_multi = fg_mask[:, None, :] > 1
    max_idx = overlaps.argmax(-2)
    is_max = F.one_hot(max_idx, n_max_boxes).to(mask_pos.dtype).permute(0, 2, 1)
    mask_pos = torch.where(mask_multi, is_max, mask_pos)
    fg_mask = mask_pos.sum(-2)
    return mask_pos.argmax(-2), fg_mask, mask_pos


def topk_lower_index_first(metrics: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest along the last axis, equal
    values in index order (``jax.lax.top_k``'s rule)."""
    values, idx = torch.sort(metrics, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def select_topk_candidates(metrics: torch.Tensor, topk: int,
                           topk_mask: torch.Tensor) -> torch.Tensor:
    """The top-``topk`` mask of each gt ``[B, M, A]`` (reference
    assigner.py:137-159): a masked gt's candidates all point at anchor 0,
    which then counts more than once and is dropped."""
    _, idx = topk_lower_index_first(metrics, topk)
    idx = torch.where(topk_mask, idx, torch.zeros_like(idx))
    counts = torch.zeros(metrics.shape, dtype=torch.int32, device=metrics.device)
    counts.scatter_add_(-1, idx, torch.ones(idx.shape, dtype=torch.int32,
                                            device=metrics.device))
    return torch.where(counts > 1, 0, counts).to(metrics.dtype)


@torch.no_grad()
def task_aligned_assigner(pd_scores: torch.Tensor, pd_bboxes: torch.Tensor,
                          anc_points: torch.Tensor, gt_labels: torch.Tensor,
                          gt_bboxes: torch.Tensor, mask_gt: torch.Tensor,
                          topk: int = 10, num_classes: int = 80,
                          alpha: float = 0.5, beta: float = 6.0,
                          eps: float = 1e-9) -> AssignResult:
    """Targets of every anchor.  ``pd_scores`` ``[B, A, nc]`` (after the
    sigmoid), ``pd_bboxes`` ``[B, A, 4]`` xyxy and ``anc_points`` ``[A, 2]``
    in image units, ``gt_labels`` ``[B, M]``, ``gt_bboxes`` ``[B, M, 4]`` xyxy,
    ``mask_gt`` ``[B, M]`` bool.  No gradient flows through it."""
    b, m = gt_labels.shape

    # the align metric (assigner.py:124-135)
    gt_l = gt_labels.to(torch.int64).clamp(0, num_classes - 1)
    bbox_scores = pd_scores.gather(-1, gt_l[:, None, :].expand(-1, pd_scores.shape[1], -1))
    bbox_scores = bbox_scores.permute(0, 2, 1)                        # [B, M, A]
    overlaps = bbox_iou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :],
                        xywh=False, CIoU=True).clamp(min=0.0)       # [B, M, A]
    align_metric = bbox_scores ** alpha * overlaps ** beta

    mask_in_gts = select_candidates_in_gts(anc_points, gt_bboxes, eps)
    topk_mask = mask_gt[..., None].expand(b, m, topk)
    mask_topk = select_topk_candidates(align_metric * mask_in_gts, topk, topk_mask)
    mask_pos = mask_topk * mask_in_gts * mask_gt[..., None]

    target_gt_idx, fg_mask, mask_pos = select_highest_overlaps(mask_pos, overlaps, m)

    # the targets (assigner.py:161-179)
    target_labels = gt_l.gather(1, target_gt_idx)
    target_bboxes = gt_bboxes.gather(1, target_gt_idx[..., None].expand(-1, -1, 4))
    target_scores = F.one_hot(target_labels, num_classes).to(pd_scores.dtype)
    target_scores = torch.where(fg_mask[..., None] > 0, target_scores, 0.0)

    # normalisation (assigner.py:96-102)
    align_metric = align_metric * mask_pos
    pos_align = align_metric.amax(-1, keepdim=True)
    pos_overlaps = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm = (align_metric * pos_overlaps / (pos_align + eps)).amax(-2)[..., None]
    return AssignResult(target_labels, target_bboxes, target_scores * norm,
                        fg_mask > 0, target_gt_idx)
