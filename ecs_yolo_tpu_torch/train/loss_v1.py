"""v1 anchor-based YOLO loss (counterpart of ``ecs_yolo_tpu/train/loss_v1.py``).

Static shapes throughout: targets arrive padded as ``[B, M, 5]`` (cls, x, y,
w, h, normalised) with a validity mask, and the 3-neighbour-cell /
anchor-ratio assignment is a boolean mask over the dense candidate grid
``[5 offsets, B, M, na]``.  Nothing depends on how many candidates are valid,
so the step never waits for the device.  Every reduction is a masked mean.

Inside ``parallel/mesh.data_parallel`` the loss is this rank's part of the
global batch's: each mean's numerator is local and its denominator the
global count (``mesh.data_sum``, detached), ``bs`` is the global batch,
and the slide loss's mean IoU is the global one (``mesh.data_sum_grad``);
summed over the data ranks, the losses and their gradients are JAX's.

The objectness target is a scatter-max of the detached IoU (the highest IoU
wins a cell), deterministic where the reference's last write wins.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.boxes import bbox_iou
from ..parallel import mesh

# center, j, k, l, m  (reference utils/loss.py:257-261)
OFFSETS = ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (-1.0, 0.0), (0.0, -1.0))


def smooth_bce(eps: float = 0.1) -> Tuple[float, float]:
    return 1.0 - 0.5 * eps, 0.5 * eps


def bce_logits(pred, target, pos_weight: float = 1.0):
    """Elementwise binary cross-entropy with logits + pos_weight."""
    log_p = F.logsigmoid(pred)
    log_not_p = F.logsigmoid(-pred)
    return -(pos_weight * target * log_p + (1.0 - target) * log_not_p)


def focal_weight(pred, target, gamma: float = 1.5, alpha: float = 0.25):
    """Focal-loss modulation (reference FocalLoss, utils/loss.py:76-103)."""
    p = torch.sigmoid(pred)
    p_t = target * p + (1 - target) * (1 - p)
    alpha_factor = target * alpha + (1 - target) * (1 - alpha)
    return alpha_factor * (1.0 - p_t) ** gamma


def qfocal_weight(pred, target, gamma: float = 1.5, alpha: float = 0.25):
    """Quality-focal modulation (reference QFocalLoss, utils/loss.py:105)."""
    p = torch.sigmoid(pred)
    alpha_factor = target * alpha + (1 - target) * (1 - alpha)
    return alpha_factor * (target - p).abs() ** gamma


def slide_weight(target, auto_iou):
    """Slide-loss modulation (reference SlideLoss, utils/loss.py:38-72), with
    ``auto_iou`` used directly (clamped at 0.2) as in the JAX package."""
    mu = auto_iou.clamp(min=0.2)
    b1 = target <= mu - 0.1
    b2 = (target > mu - 0.1) & (target < mu)
    b3 = target >= mu
    dt = target.dtype
    return (b1.to(dt) + torch.exp(1.0 - mu) * b2.to(dt)
            + torch.exp(-(target - 1.0)) * b3.to(dt))


def _masked_mean(x, mask):
    m = mask.to(x.dtype)
    return (x * m).sum() / mesh.data_sum(m.sum()).clamp(min=1.0)


@functools.lru_cache(maxsize=64)
def _level_consts(ny: int, nx: int, dtype: torch.dtype, device: torch.device):
    """The grid gain [nx, ny, nx, ny] and the five cell offsets of a level,
    made once per level: a fresh host-to-device copy in every step would make
    the host wait for the stream."""
    return (torch.tensor([nx, ny, nx, ny], dtype=dtype, device=device),
            torch.tensor(OFFSETS, dtype=dtype, device=device))


def build_targets_level(
    targets: torch.Tensor,   # [B, M, 5] cls,x,y,w,h (normalised)
    t_mask: torch.Tensor,    # [B, M] bool
    anchors: torch.Tensor,   # [na, 2] grid units
    grid_hw: Tuple[int, int],
    anchor_t: float,
):
    """Dense candidate assignment for one pyramid level.

    Returns flattened candidate tensors of length 5*B*M*na:
      (b, a, gj, gi, tcls, tbox[4], anch[2], valid).
    """
    ny, nx = grid_hw
    B, M, _ = targets.shape
    na = anchors.shape[0]
    g = 0.5
    dt, dev = targets.dtype, targets.device

    gain, offs = _level_consts(ny, nx, dt, dev)
    txywh = targets[..., 1:5] * gain                       # grid units
    tcls = targets[..., 0]

    r = txywh[..., None, 2:4] / anchors[None, None]        # [B,M,na,2]
    anchor_ok = torch.maximum(r, 1.0 / r).amax(-1) < anchor_t

    gxy = txywh[..., 0:2]
    gxi = gain[:2] - gxy
    jk = (torch.remainder(gxy, 1.0) < g) & (gxy > 1.0)
    lm = (torch.remainder(gxi, 1.0) < g) & (gxi > 1.0)
    off_ok = torch.stack([torch.ones_like(jk[..., 0]), jk[..., 0], jk[..., 1],
                          lm[..., 0], lm[..., 1]], dim=0)   # [5, B, M]

    valid = (t_mask[None, :, :, None].bool() & anchor_ok[None]
             & off_ok[..., None])                          # [5, B, M, na]

    gij = torch.floor(gxy[None] - offs[:, None, None] * g)  # [5,B,M,2]
    gi = gij[..., 0].clamp(0, nx - 1).long()
    gj = gij[..., 1].clamp(0, ny - 1).long()

    shape = (5, B, M, na)
    b_idx = torch.arange(B, device=dev)[None, :, None, None].expand(shape)
    a_idx = torch.arange(na, device=dev)[None, None, None, :].expand(shape)
    gi_b = gi[..., None].expand(shape)
    gj_b = gj[..., None].expand(shape)
    tcls_b = tcls[None, :, :, None].expand(shape)
    # tbox: xy offset within the cell, wh in grid units
    txy = gxy[None] - torch.stack([gi.to(dt), gj.to(dt)], -1)
    tbox = torch.cat([txy[..., None, :].expand(shape + (2,)),
                      txywh[None, :, :, None, 2:4].expand(shape + (2,))], dim=-1)
    anch = anchors[None, None, None].expand(shape + (2,))

    flat = lambda x: x.reshape((-1,) + tuple(x.shape[4:]))
    return (flat(b_idx), flat(a_idx), flat(gj_b), flat(gi_b),
            flat(tcls_b).long(), flat(tbox), flat(anch), flat(valid))


def compute_loss_v1(
    preds: Sequence[torch.Tensor],   # per level [B, na, ny, nx, no]
    targets: torch.Tensor,           # [B, M, 5]
    t_mask: torch.Tensor,            # [B, M]
    anchors: torch.Tensor,           # [nl, na, 2] grid units
    hyp: Dict[str, float],
    nc: int,
):
    """Anchor-based detection loss.  Returns (total*bs, (lbox, lobj, lcls))."""
    balance = {2: [4.0, 1.0], 3: [4.0, 1.0, 0.4]}.get(
        len(preds), [4.0, 1.0, 0.25, 0.06, 0.02])
    cp, cn = smooth_bce(hyp.get("label_smoothing", 0.0))
    slide_ratio = hyp.get("slide_ratio", 0.0)
    fl_gamma = hyp.get("fl_gamma", 0.0)
    gr = 1.0

    lbox = preds[0].new_zeros(())
    lobj = preds[0].new_zeros(())
    lcls = preds[0].new_zeros(())
    bs = mesh.global_batch(preds[0].shape[0])

    for i, pi in enumerate(preds):
        _, na, ny, nx, _ = pi.shape
        b, a, gj, gi, tcls, tbox, anch, valid = build_targets_level(
            targets, t_mask, anchors[i], (ny, nx), hyp["anchor_t"])
        ps = pi[b, a, gj, gi]                              # [N, no]

        pxy = torch.sigmoid(ps[:, :2]) * 2 - 0.5
        pwh = (torch.sigmoid(ps[:, 2:4]) * 2) ** 2 * anch
        pbox = torch.cat([pxy, pwh], dim=-1)
        iou = bbox_iou(pbox, tbox, xywh=True, SIoU=True)
        lbox = lbox + _masked_mean(1.0 - iou, valid)
        auto_iou = _masked_mean(iou, valid)
        if slide_ratio > 0:
            auto_iou = mesh.data_sum_grad(auto_iou)

        # objectness target: scatter-max of the detached IoU over the cells
        score_iou = iou.detach().clamp(min=0.0)
        score_iou = torch.where(valid, (1.0 - gr) + gr * score_iou,
                                torch.zeros_like(score_iou))
        cell = ((b * na + a) * ny + gj) * nx + gi
        tobj = pi.new_zeros(pi.shape[:4]).view(-1).scatter_reduce_(
            0, cell, score_iou.to(pi.dtype), "amax", include_self=True
        ).view(pi.shape[:4])

        obj_l = bce_logits(pi[..., 4], tobj, hyp.get("obj_pw", 1.0))
        if fl_gamma > 0:
            obj_l = obj_l * focal_weight(pi[..., 4], tobj, fl_gamma)
        elif slide_ratio > 0:
            obj_l = obj_l * slide_weight(tobj, auto_iou)
        lobj = lobj + mesh.global_mean(obj_l) * balance[i]

        if nc > 1:
            # a class id outside [0, nc) would fault the device; such a row
            # is a data error, not a case the loss defines
            t = torch.full((ps.shape[0], nc), cn, dtype=ps.dtype, device=ps.device)
            t.scatter_(1, tcls.clamp(0, nc - 1)[:, None], cp)
            cls_l = bce_logits(ps[:, 5:], t, hyp.get("cls_pw", 1.0))
            if fl_gamma > 0:
                cls_l = cls_l * focal_weight(ps[:, 5:], t, fl_gamma)
            elif slide_ratio > 0:
                cls_l = cls_l * slide_weight(t, auto_iou)
            lcls = lcls + _masked_mean(cls_l, valid[:, None].expand(cls_l.shape))

    lbox = lbox * hyp["box"]
    lobj = lobj * hyp["obj"]
    lcls = lcls * hyp["cls"]
    total = (lbox + lobj + lcls) * bs
    items = torch.stack([lbox, lobj, lcls]).detach()
    return total, items
