"""Box format conversions (counterpart of ``ecs_yolo_tpu/ops/boxes.py``:
``xywh2xyxy``, ``clip_coords``, ``scale_coords``)."""

from __future__ import annotations

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    xy, wh = x[..., :2], x[..., 2:4]
    half = wh / 2
    return torch.cat([xy - half, xy + half, x[..., 4:]], dim=-1)


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
