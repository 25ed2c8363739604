"""Inference input loader (counterpart of ``ecs_yolo_tpu/data/loaders.py``;
``LoadImages`` only so far)."""

from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np
from PIL import Image

from .augment import letterbox

IMG_FORMATS = {"bmp", "jpeg", "jpg", "png", "tif", "tiff", "webp"}


class LoadImages:
    """File/dir/glob image iterator with letterbox preprocessing.  Yields
    ``(path, [1, H, W, 3] float32 in [0, 1], original uint8 image)``."""

    def __init__(self, path, img_size: int = 640, stride: int = 32,
                 auto: bool = False):
        p = str(Path(path).resolve())
        if "*" in p:
            files = sorted(glob.glob(p, recursive=True))
        elif os.path.isdir(p):
            files = sorted(glob.glob(os.path.join(p, "*.*")))
        elif os.path.isfile(p):
            files = [p]
        else:
            raise FileNotFoundError(f"{p} does not exist")
        self.files = [f for f in files
                      if f.rsplit(".", 1)[-1].lower() in IMG_FORMATS]
        if not self.files:
            raise FileNotFoundError(f"no images found in {path}")
        self.img_size = img_size
        self.stride = stride
        self.auto = auto

    def __len__(self):
        return len(self.files)

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray, np.ndarray]]:
        for path in self.files:
            im0 = np.asarray(Image.open(path).convert("RGB"))
            im, _, _ = letterbox(im0, self.img_size, stride=self.stride,
                                 auto=self.auto)
            yield path, (im.astype(np.float32) / 255.0)[None], im0
