"""End-user inference (counterpart of ``ecs_yolo_tpu/autoshape.py``;
reference ``AutoShape`` / ``Detections``, models/common.py:1957-2142).

``AutoShape`` takes paths, PIL images or numpy arrays (HWC or CHW, one or a
list), letterboxes them to one common stride-divisible shape, runs one
batched forward on the model's device (every neuron site one fused kernel
on the card), the port's greedy NMS, and scales the boxes back to each
native image.  ``Detections`` holds the result with ``xyxy`` / ``xywh``
views and their normalised forms, ``print`` / ``show`` / ``save`` /
``crop`` / ``render`` / ``pandas`` / ``tolist``.  No URL is fetched: paths
are local.  Drawing uses PIL.  The class filter is applied on the host
after NMS, as in the JAX package.  ``crop(save=True)`` writes no file for a
box narrower or lower than a pixel (the JAX function fails on its empty
crop).  NMS reads what ``val`` and ``detect``
read (``models/yolo.head_predictions``): the one2one branch of both v10
heads, where the JAX ``AutoShape`` tests for ``v10Detect`` alone.
"""

from __future__ import annotations

import copy
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image, ImageDraw, ImageOps

from .data.augment import letterbox
from .detect import _PALETTE, scale_to_native
from .models.yolo import head_predictions
from .ops.nms import non_max_suppression
from .utils.general import LOGGER, increment_path


def _to_numpy_image(im, i: int):
    """One input as (HWC RGB numpy, file name)."""
    f = f"image{i}"
    if isinstance(im, (str, Path)):
        f = str(im)
        im = np.asarray(ImageOps.exif_transpose(Image.open(im)))
    elif isinstance(im, Image.Image):
        f = getattr(im, "filename", "") or f
        im = np.asarray(ImageOps.exif_transpose(im))
    else:
        im = np.asarray(im)
    if im.ndim == 3 and im.shape[0] < 5:  # CHW -> HWC
        im = im.transpose(1, 2, 0)
    if im.ndim == 2:
        im = np.tile(im[..., None], 3)
    im = im[..., :3]
    return np.ascontiguousarray(im), Path(f).with_suffix(".jpg").name


def xyxy2xywh(x: np.ndarray) -> np.ndarray:
    y = x.copy()
    y[:, 0] = (x[:, 0] + x[:, 2]) / 2
    y[:, 1] = (x[:, 1] + x[:, 3]) / 2
    y[:, 2] = x[:, 2] - x[:, 0]
    y[:, 3] = x[:, 3] - x[:, 1]
    return y


class AutoShape:
    """Input-robust inference around a built model (reference AutoShape).

    >>> m = hub.create("resnet10.yaml", autoshape=True, names=["thing"])
    >>> results = m(["a.jpg", np.zeros((480, 640, 3), np.uint8)])
    >>> results.print(); results.pandas().xyxy[0]
    """

    conf = 0.25       # NMS confidence threshold
    iou = 0.45        # NMS IoU threshold
    classes: Optional[Sequence[int]] = None  # class-id filter
    multi_label = False
    agnostic = False
    max_det = 1000

    def __init__(self, model: torch.nn.Module, names=None, size: int = 640,
                 stride: int = 32):
        self.model = model.eval()
        info = model.head_info
        self.head_name, self.nc = info["name"], info["nc"]
        self.names = list(names) if names else [str(i) for i in range(self.nc)]
        self.size = size
        self.stride = stride

    @torch.inference_mode()
    def __call__(self, imgs, size: Optional[int] = None) -> "Detections":
        size = size or self.size
        t0 = time.perf_counter()
        batch = imgs if isinstance(imgs, (list, tuple)) else [imgs]
        ims, files, shape0 = [], [], []
        for i, im in enumerate(batch):
            a, f = _to_numpy_image(im, i)
            ims.append(a)
            files.append(f)
            shape0.append(a.shape[:2])
        # one letterbox shape for the batch: the largest native dims scaled
        # to `size`, rounded up to the stride
        g = [size / max(s) for s in shape0]
        shape1 = np.stack([np.array(s) * gi for s, gi in zip(shape0, g)]).max(0)
        shape1 = tuple(int(np.ceil(v / self.stride) * self.stride) for v in shape1)
        x = np.stack([letterbox(im, shape1, auto=False)[0] for im in ims]
                     ).astype(np.float32) / 255.0
        dev = next(self.model.parameters()).device
        t1 = time.perf_counter()

        pred = head_predictions(self.head_name, self.model(torch.from_numpy(x).to(dev)),
                                self.nc)
        out, valid = non_max_suppression(
            pred, conf_thres=self.conf, iou_thres=self.iou, multi_label=self.multi_label,
            agnostic=self.agnostic, max_det=min(self.max_det, 300),
            has_obj=self.head_name == "Detect")
        out, valid = out.float().cpu().numpy(), valid.cpu().numpy()
        t2 = time.perf_counter()

        dets = []
        for i in range(len(ims)):
            d = out[i][valid[i]]
            if self.classes is not None and len(d):
                d = d[np.isin(d[:, 5].astype(int), list(self.classes))]
            if len(d):
                d[:, :4] = scale_to_native(d[:, :4], shape1, shape0[i])
            dets.append(d)
        t3 = time.perf_counter()
        return Detections(ims, dets, files, times=(t0, t1, t2, t3), names=self.names,
                          shape=(len(ims), shape1[0], shape1[1], 3))


class Detections:
    """Inference results (reference Detections, models/common.py:2044-2142)."""

    def __init__(self, imgs, pred, files, times=None, names=None, shape=None):
        self.imgs = imgs                      # list of native HWC arrays
        self.pred = pred                      # list of [n, 6] xyxy/conf/cls
        self.names = names or []
        self.files = files
        gn = [np.array([im.shape[1], im.shape[0]] * 2 + [1, 1], np.float32)
              for im in imgs]
        self.xyxy = pred
        self.xywh = [np.concatenate([xyxy2xywh(p[:, :4]), p[:, 4:]], 1) for p in pred]
        self.xyxyn = [p / g for p, g in zip(self.xyxy, gn)]
        self.xywhn = [p / g for p, g in zip(self.xywh, gn)]
        self.n = len(pred)
        times = times or (0.0,) * 4
        self.t = tuple((times[i + 1] - times[i]) * 1000 / max(self.n, 1) for i in range(3))
        self.s = shape

    def _name(self, c: int) -> str:
        return self.names[c] if c < len(self.names) else str(c)

    def _display(self, pprint=False, show=False, save=False, crop=False, render=False,
                 save_dir=Path("")):
        crops = []
        for i, (im, pred) in enumerate(zip(self.imgs, self.pred)):
            s = f"image {i + 1}/{self.n}: {im.shape[0]}x{im.shape[1]} "
            if len(pred):
                for c in np.unique(pred[:, 5]).astype(int):
                    n = int((pred[:, 5] == c).sum())
                    s += f"{n} {self._name(c)}{'s' * (n > 1)}, "
            else:
                s += "(no detections)"
            img = Image.fromarray(np.asarray(im).astype(np.uint8))
            if show or save or render or crop:
                draw = ImageDraw.Draw(img)
                for x1, y1, x2, y2, conf, cls in pred:
                    c = int(cls)
                    label = f"{self._name(c)} {conf:.2f}"
                    if crop:
                        piece = np.asarray(im)[int(max(y1, 0)):int(y2), int(max(x1, 0)):int(x2)]
                        if save and piece.size:     # a box under a pixel crops nothing
                            d = Path(save_dir) / "crops" / self._name(c)
                            d.mkdir(parents=True, exist_ok=True)
                            Image.fromarray(piece).save(d / self.files[i])
                        crops.append({"box": np.array([x1, y1, x2, y2]), "conf": conf,
                                      "cls": cls, "label": label, "im": piece})
                    else:
                        color = _PALETTE[c % len(_PALETTE)]
                        draw.rectangle([x1, y1, x2, y2], outline=color, width=2)
                        draw.text((x1 + 2, max(y1 - 12, 0)), label, fill=color)
            if pprint:
                LOGGER.info(s.rstrip(", "))
            if show:
                img.show(self.files[i])
            if save and not crop:
                Path(save_dir).mkdir(parents=True, exist_ok=True)
                img.save(Path(save_dir) / self.files[i])
            if render:
                self.imgs[i] = np.asarray(img)
        return crops if crop else None

    def print(self):
        self._display(pprint=True)
        LOGGER.info("Speed: %.1fms pre-process, %.1fms inference, %.1fms NMS per image "
                    "at shape %s" % (*self.t, tuple(self.s)))

    def show(self):
        self._display(show=True)

    def save(self, save_dir="runs/detect/exp"):
        save_dir = increment_path(save_dir, mkdir=True)
        self._display(save=True, save_dir=save_dir)
        return save_dir

    def crop(self, save=True, save_dir="runs/detect/exp"):
        save_dir = increment_path(save_dir, mkdir=True) if save else Path("")
        return self._display(crop=True, save=save, save_dir=save_dir)

    def render(self):
        self._display(render=True)
        return self.imgs

    def pandas(self):
        """The views as pandas DataFrames (reference :2123-2131)."""
        import pandas as pd

        new = copy.copy(self)
        ca = "xmin", "ymin", "xmax", "ymax", "confidence", "class", "name"
        cb = "xcenter", "ycenter", "width", "height", "confidence", "class", "name"
        for k, c in zip(["xyxy", "xyxyn", "xywh", "xywhn"], [ca, ca, cb, cb]):
            rows = [[[*p[:5], int(p[5]), self._name(int(p[5]))] for p in x]
                    for x in getattr(self, k)]
            setattr(new, k, [pd.DataFrame(r, columns=c) for r in rows])
        return new

    def tolist(self):
        """One Detections per image (reference :2133-2139)."""
        out = []
        for i in range(self.n):
            d = Detections([self.imgs[i]], [self.pred[i]], [self.files[i]],
                           names=self.names, shape=self.s)
            for k in ("imgs", "pred", "xyxy", "xyxyn", "xywh", "xywhn", "files"):
                setattr(d, k, getattr(d, k)[0])
            out.append(d)
        return out

    def __len__(self):
        return self.n
