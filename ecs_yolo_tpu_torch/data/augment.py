"""Host-side image preprocessing (counterpart of
``ecs_yolo_tpu/data/augment.py``; ``letterbox`` only so far)."""

from __future__ import annotations

import numpy as np
from PIL import Image


def letterbox(
    im: np.ndarray,
    new_shape=(640, 640),
    color=(114, 114, 114),
    auto: bool = True,
    scale_fill: bool = False,
    scaleup: bool = True,
    stride: int = 32,
):
    """Resize + pad to `new_shape` keeping aspect ratio.

    Returns (image, ratio (rw, rh), (dw, dh)) like the reference.
    """
    shape = im.shape[:2]  # h, w
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)

    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)

    ratio = (r, r)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))  # w, h
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:
        dw, dh = dw % stride, dh % stride
    elif scale_fill:
        dw, dh = 0, 0
        new_unpad = (new_shape[1], new_shape[0])
        ratio = (new_shape[1] / shape[1], new_shape[0] / shape[0])

    dw /= 2
    dh /= 2

    if shape[::-1] != new_unpad:
        im = np.asarray(Image.fromarray(im).resize(new_unpad, Image.BILINEAR))
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    out = np.full(
        (im.shape[0] + top + bottom, im.shape[1] + left + right, 3),
        color,
        dtype=im.dtype,
    )
    out[top : top + im.shape[0], left : left + im.shape[1]] = im
    return out, ratio, (dw, dh)
