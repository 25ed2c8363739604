"""Host-side image preprocessing and augmentation (counterpart of
``ecs_yolo_tpu/data/augment.py``): ``letterbox``, ``augment_hsv``,
``random_perspective`` with ``box_candidates``, ``mixup``, the flips and the
gated ``Albumentations`` hook.

Every random function takes its ``rng`` (a ``random.Random``) explicitly and
draws from it in the JAX package's order, so that the same generator gives
the same image bit for bit.  ``random_perspective`` warps through the port's
own native library (``native/``) unless the caller passes ``native=False``,
which takes PIL's transform; a failed native build raises, where the JAX
function quietly drops to PIL.
"""

from __future__ import annotations

import math
from typing import Tuple

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


# --- HSV jitter --------------------------------------------------------------


def _rgb_to_hsv_u8(img: np.ndarray):
    """Vectorised uint8 RGB -> HSV with OpenCV's conventions (H in [0,180))."""
    f = img.astype(np.float32) / 255.0
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    maxc = f.max(-1)
    minc = f.min(-1)
    v = maxc
    d = maxc - minc
    s = np.where(maxc > 0, d / (maxc + 1e-12), 0.0)
    d_safe = np.where(d == 0, 1.0, d)
    h = np.where(
        maxc == r,
        (g - b) / d_safe % 6.0,
        np.where(maxc == g, (b - r) / d_safe + 2.0, (r - g) / d_safe + 4.0),
    )
    h = np.where(d == 0, 0.0, h) * 30.0  # 0..180
    return (
        h.astype(np.uint8),
        (s * 255).astype(np.uint8),
        (v * 255).astype(np.uint8),
    )


def _hsv_to_rgb_u8(h: np.ndarray, s: np.ndarray, v: np.ndarray):
    hf = h.astype(np.float32) / 30.0  # 0..6
    sf = s.astype(np.float32) / 255.0
    vf = v.astype(np.float32) / 255.0
    i = np.floor(hf).astype(np.int32) % 6
    f = hf - np.floor(hf)
    p = vf * (1 - sf)
    q = vf * (1 - sf * f)
    t = vf * (1 - sf * (1 - f))
    r = np.choose(i, [vf, q, p, p, t, vf])
    g = np.choose(i, [t, vf, vf, q, p, p])
    b = np.choose(i, [p, p, t, vf, vf, q])
    out = np.stack([r, g, b], -1)
    return (out * 255).astype(np.uint8)


def augment_hsv(im: np.ndarray, hgain=0.015, sgain=0.7, vgain=0.4, *, rng):
    """Random HSV gains (reference utils/augmentations.py:47-62)."""
    r = (
        np.array([rng.uniform(-1, 1) for _ in range(3)])
        * [hgain, sgain, vgain]
        + 1
    )
    h, s, v = _rgb_to_hsv_u8(im)
    h = ((h.astype(np.float32) * r[0]) % 180).astype(np.uint8)
    s = np.clip(s.astype(np.float32) * r[1], 0, 255).astype(np.uint8)
    v = np.clip(v.astype(np.float32) * r[2], 0, 255).astype(np.uint8)
    return _hsv_to_rgb_u8(h, s, v)


# --- geometric ----------------------------------------------------------------


def random_perspective(
    im: np.ndarray,
    targets: np.ndarray = None,
    degrees: float = 10,
    translate: float = 0.1,
    scale: float = 0.1,
    shear: float = 10,
    perspective: float = 0.0,
    border: Tuple[int, int] = (0, 0),
    *,
    rng,
    native: bool = True,
):
    """Random affine/perspective warp with the labels (cls, x1, y1, x2, y2 in
    pixels) carried along (reference utils/augmentations.py:124-203)."""
    targets = np.zeros((0, 5), np.float32) if targets is None else targets

    height = im.shape[0] + border[0] * 2
    width = im.shape[1] + border[1] * 2

    # center
    C = np.eye(3)
    C[0, 2] = -im.shape[1] / 2
    C[1, 2] = -im.shape[0] / 2
    # perspective
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    # rotation + scale
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    ca, sa = s * math.cos(math.radians(a)), s * math.sin(math.radians(a))
    R[:2, :2] = [[ca, sa], [-sa, ca]]
    # shear
    S = np.eye(3)
    S[0, 1] = math.tan(math.radians(rng.uniform(-shear, shear)))
    S[1, 0] = math.tan(math.radians(rng.uniform(-shear, shear)))
    # translation
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height

    M = T @ S @ R @ P @ C
    changed = (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any()
    if changed:
        # the warp maps OUTPUT coordinates to INPUT ones: M^-1
        Minv = np.linalg.inv(M)
        if native:
            from .. import native as _native

            im = _native.warp_perspective(im, Minv, (height, width))
        else:
            pil = Image.fromarray(im)
            if perspective:
                coeffs = (Minv / Minv[2, 2]).reshape(-1)[:8]
                pil = pil.transform(
                    (width, height), Image.PERSPECTIVE, tuple(coeffs),
                    resample=Image.BILINEAR, fillcolor=(114, 114, 114),
                )
            else:
                coeffs = Minv[:2].reshape(-1)
                pil = pil.transform(
                    (width, height), Image.AFFINE, tuple(coeffs),
                    resample=Image.BILINEAR, fillcolor=(114, 114, 114),
                )
            im = np.asarray(pil)

    n = len(targets)
    if n:
        xy = np.ones((n * 4, 3))
        xy[:, :2] = targets[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
        xy = xy @ M.T
        xy = (
            (xy[:, :2] / xy[:, 2:3]) if perspective else xy[:, :2]
        ).reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.stack(
            [x.min(1), y.min(1), x.max(1), y.max(1)], axis=1
        )
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        keep = box_candidates(targets[:, 1:5].T * s, new.T)
        targets = targets[keep]
        targets[:, 1:5] = new[keep]
    return im, targets


def box_candidates(box1, box2, wh_thr=2, ar_thr=20, area_thr=0.1, eps=1e-16):
    """Boxes that survive a warp: wide and tall enough, enough of their area
    left, not too thin (reference augmentations.py)."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (
        (w2 > wh_thr)
        & (h2 > wh_thr)
        & (w2 * h2 / (w1 * h1 + eps) > area_thr)
        & (ar < ar_thr)
    )


def mixup(im1, labels1, im2, labels2, *, rng):
    """Image mixup with ratio beta(32, 32) drawn from ``rng`` (reference
    augmentations.py:206-212)."""
    r = rng.betavariate(32.0, 32.0)
    im = (im1.astype(np.float32) * r + im2.astype(np.float32) * (1 - r)).astype(
        np.uint8
    )
    return im, np.concatenate([labels1, labels2], 0)


def flip_lr(im, labels):
    im = np.ascontiguousarray(im[:, ::-1])
    if len(labels):
        labels = labels.copy()
        labels[:, 1] = 1 - labels[:, 1]
    return im, labels


def flip_ud(im, labels):
    im = np.ascontiguousarray(im[::-1])
    if len(labels):
        labels = labels.copy()
        labels[:, 2] = 1 - labels[:, 2]
    return im, labels


class Albumentations:
    """Optional albumentations pipeline (reference
    utils/augmentations.py:16-45): Blur / MedianBlur / ToGray / CLAHE each at
    p=0.01, built only when the package imports; the identity otherwise."""

    def __init__(self, p: float = 1.0):
        self.p = p
        self.transform = None
        try:
            import albumentations as A

            self.transform = A.Compose(
                [
                    A.Blur(p=0.01),
                    A.MedianBlur(p=0.01),
                    A.ToGray(p=0.01),
                    A.CLAHE(p=0.01),
                    A.RandomBrightnessContrast(p=0.0),
                    A.RandomGamma(p=0.0),
                    A.ImageCompression(quality_lower=75, p=0.0),
                ],
                bbox_params=A.BboxParams(
                    format="yolo", label_fields=["class_labels"]
                ),
            )
        except ImportError:
            pass

    def __call__(self, im, labels, rng=None):
        """im uint8 HWC, labels [n,5] (cls, xywh normalised)."""
        if self.transform is None or not len(labels):
            return im, labels
        if rng is not None and rng.random() > self.p:
            return im, labels
        new = self.transform(
            image=im, bboxes=labels[:, 1:], class_labels=labels[:, 0]
        )
        im = new["image"]
        if len(new["bboxes"]):
            labels = np.array(
                [[c, *b] for c, b in zip(new["class_labels"], new["bboxes"])],
                np.float32,
            )
        else:
            labels = np.zeros((0, 5), np.float32)
        return im, labels
