"""Box format conversions and the IoU family (counterpart of
``ecs_yolo_tpu/ops/boxes.py``: ``xywh2xyxy``, ``xyxy2xywh``, ``box_iou``,
``bbox_iou``, ``clip_coords``, ``scale_coords``)."""

from __future__ import annotations

import math

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    xy, wh = x[..., :2], x[..., 2:4]
    half = wh / 2
    return torch.cat([xy - half, xy + half, x[..., 4:]], dim=-1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    x1y1, x2y2 = x[..., :2], x[..., 2:4]
    return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1, x[..., 4:]], dim=-1)


def box_iou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU matrix [N, M] for xyxy boxes [N,4] x [M,4]."""
    a1, a2 = box1[:, None, :].chunk(2, dim=-1)
    b1, b2 = box2[None, :, :].chunk(2, dim=-1)
    inter = (torch.minimum(a2, b2) - torch.maximum(a1, b1)).clamp(min=0).prod(-1)
    area1 = (box1[:, 2] - box1[:, 0]) * (box1[:, 3] - box1[:, 1])
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    return inter / (area1[:, None] + area2[None, :] - inter + eps)


def bbox_iou(box1, box2, xywh: bool = True, GIoU: bool = False,
             DIoU: bool = False, CIoU: bool = False, SIoU: bool = False,
             EIoU: bool = False, Focal: bool = False, alpha: float = 1.0,
             gamma: float = 0.5, ciou_pow: bool = False, eps: float = 1e-7):
    """Elementwise IoU (broadcasting) with the reference's variant switch.

    Boxes are ``[..., 4]``; with ``xywh=True`` they are (cx, cy, w, h).
    ``Focal=True`` also returns the focal weight ``(inter/union)**gamma``.
    ``alpha`` is the alpha-IoU exponent on the penalty terms; ``ciou_pow``
    selects the reference's shadowed-pow CIoU penalty.  Expression for
    expression the JAX package's ``bbox_iou``.
    """
    if xywh:
        x1, y1, w1, h1 = box1.chunk(4, dim=-1)
        x2, y2, w2, h2 = box2.chunk(4, dim=-1)
        b1_x1, b1_x2 = x1 - w1 / 2, x1 + w1 / 2
        b1_y1, b1_y2 = y1 - h1 / 2, y1 + h1 / 2
        b2_x1, b2_x2 = x2 - w2 / 2, x2 + w2 / 2
        b2_y1, b2_y2 = y2 - h2 / 2, y2 + h2 / 2
    else:
        b1_x1, b1_y1, b1_x2, b1_y2 = box1.chunk(4, dim=-1)
        b2_x1, b2_y1, b2_x2, b2_y2 = box2.chunk(4, dim=-1)

    inter = ((torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0)
             * (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0))
    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    def _ret(val):
        val = val.squeeze(-1)
        if Focal:
            return val, ((inter / union) ** gamma).squeeze(-1)
        return val

    if not (GIoU or DIoU or CIoU or SIoU or EIoU):
        return _ret(iou)

    def _pow(x):
        return x if alpha == 1 else x ** alpha

    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    if GIoU:
        c_area = cw * ch + eps
        return _ret(iou - _pow((c_area - union) / c_area + eps))

    c2 = _pow(cw ** 2 + ch ** 2) + eps
    rho2 = _pow(((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2
                 + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4)
    if DIoU:
        return _ret(iou - rho2 / c2)
    if CIoU:
        v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
        a_ciou = (v / (v - iou + (1 + eps))).detach()
        if ciou_pow:
            return _ret(iou - (rho2 / c2 + (v * a_ciou + eps) ** a_ciou))
        return _ret(iou - (rho2 / c2 + v * a_ciou))
    if EIoU:
        rho_w2 = (w2 - w1) ** 2
        rho_h2 = ((b2_y2 - b2_y1) - (b1_y2 - b1_y1)) ** 2
        return _ret(iou - (rho2 / c2 + rho_w2 / _pow(cw ** 2 + eps)
                           + rho_h2 / _pow(ch ** 2 + eps)))
    # SIoU
    s_cw = (b2_x1 + b2_x2 - b1_x1 - b1_x2) * 0.5 + eps
    s_ch = (b2_y1 + b2_y2 - b1_y1 - b1_y2) * 0.5 + eps
    sigma = torch.sqrt(s_cw ** 2 + s_ch ** 2)
    sin_a1 = s_cw.abs() / sigma
    sin_a2 = s_ch.abs() / sigma
    threshold = math.sqrt(2) / 2
    sin_a = torch.where(sin_a1 > threshold, sin_a2, sin_a1)
    angle_cost = torch.cos(torch.asin(sin_a.clamp(-1, 1)) * 2 - math.pi / 2)
    rho_x = (s_cw / cw) ** 2
    rho_y = (s_ch / ch) ** 2
    g = angle_cost - 2
    distance_cost = 2 - torch.exp(g * rho_x) - torch.exp(g * rho_y)
    omiga_w = (w1 - w2).abs() / torch.maximum(w1, w2)
    omiga_h = (h1 - h2).abs() / torch.maximum(h1, h2)
    shape_cost = (1 - torch.exp(-omiga_w)) ** 4 + (1 - torch.exp(-omiga_h)) ** 4
    return _ret(iou - _pow(0.5 * (distance_cost + shape_cost) + eps))


def clip_coords(boxes: torch.Tensor, shape) -> torch.Tensor:
    """Clip xyxy boxes to image shape (h, w)."""
    h, w = shape
    return torch.cat([
        boxes[..., 0:1].clamp(0, w), boxes[..., 1:2].clamp(0, h),
        boxes[..., 2:3].clamp(0, w), boxes[..., 3:4].clamp(0, h),
    ], dim=-1)


def scale_coords(img1_shape, coords: torch.Tensor, img0_shape,
                 ratio_pad=None) -> torch.Tensor:
    """Map letterboxed-image xyxy coords back to the native image
    (reference utils/general.py:621-647)."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = ((img1_shape[1] - img0_shape[1] * gain) / 2,
               (img1_shape[0] - img0_shape[0] * gain) / 2)
    else:
        gain = ratio_pad[0][0]
        pad = ratio_pad[1]
    coords = coords - torch.tensor([pad[0], pad[1], pad[0], pad[1]],
                                   dtype=coords.dtype, device=coords.device)
    return clip_coords(coords / gain, img0_shape)
