"""Training and validation dataset: images + YOLO-format txt labels
(counterpart of ``ecs_yolo_tpu/data/dataset.py``).

Label discovery through the images -> labels path convention, letterbox to a
square canvas (or to a few aspect-ratio buckets in ``rect`` mode), labels
padded to ``max_labels`` with a validity mask, static-shape batches with the
last one zero-padded, and the per-image ``meta`` that maps the canvas back to
the native image.  Images come out channels-last, uint8 (``uint8_out``, divide
on the device) or float32 in [0, 1].

The train half (``augment=True``): 4-image mosaic with a random perspective
warp, mixup, Albumentations (the identity without the package), HSV jitter
and flips, with ``hyp`` copied per instance (so ``close_mosaic`` can switch
mosaic off on one dataset), ``mosaic_border`` and ``indices`` (resampled for
image weights); decoded images cached in RAM or on disk (``cache_images``).

Deviation: each sample's ``random.Random`` is drawn from ``(seed, epoch,
index)`` (``sample_rng``; the trainer sets ``epoch``), so an epoch's
augmentation can be reproduced.  The JAX package seeds it from the process id
and the global ``random`` state, which cannot be.

``SegmentDataset`` adds the instance masks (and, for ``Panoptic``, a
semantic class-id map) rasterised from YOLO-seg polygon labels.
``batches(host_shard=(rank, world))`` is one rank's contiguous rows of each
full global batch (the DistributedSampler equivalent of multi-GPU
training).
"""

from __future__ import annotations

import hashlib
import os
import queue
import random
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from ..parallel.multihost import local_batch_slice
from ..utils.general import LOGGER
from .augment import (Albumentations, augment_hsv, flip_lr, flip_ud, letterbox,
                      mixup, random_perspective)

IMG_FORMATS = {"bmp", "jpeg", "jpg", "png", "tif", "tiff", "webp"}


def img2label_path(p: str) -> str:
    """images/xxx.jpg -> labels/xxx.txt (reference utils/datasets.py:371)."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return sb.join(p.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt"


def img2stuff_path(p: str) -> str:
    """images/xxx.jpg -> stuff/xxx.txt: the stuff-class polygons of panoptic
    training (reference utils/panoptic/dataloaders.py:85-88)."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}stuff{os.sep}"
    return sb.join(p.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt"


def find_images(path) -> List[str]:
    """Resolve a dir / txt list / image file (or a list of them) into a
    sorted image list."""
    files: List[str] = []
    for p in path if isinstance(path, (list, tuple)) else [path]:
        p = Path(p)
        if p.is_dir():
            files += [str(f) for f in sorted(p.rglob("*.*"))]
        elif p.is_file() and p.suffix == ".txt":
            root = p.parent
            with open(p) as fh:
                for line in fh.read().strip().splitlines():
                    line = line.strip()
                    f = (root / line).resolve() if line.startswith("./") else Path(line)
                    files.append(str(f))
        elif p.is_file():
            files.append(str(p))
        else:
            raise FileNotFoundError(f"{p} does not exist")
    return sorted(
        f for f in files if f.rsplit(".", 1)[-1].lower() in IMG_FORMATS
    )


def _paths_hash(paths: Sequence[str]) -> str:
    """A key over the files' names, sizes and modification times (a missing
    file keys as missing), so that an edited file changes the key."""
    h = hashlib.md5()
    for p in paths:
        h.update(p.encode())
        try:
            st = os.stat(p)
            h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
        except OSError:
            h.update(b"-")
    return h.hexdigest()


def load_label_file(path: str) -> np.ndarray:
    """Read one YOLO txt -> [n, 5] (cls, x, y, w, h), validated, duplicate
    rows dropped."""
    if not os.path.isfile(path):
        return np.zeros((0, 5), np.float32)
    with open(path) as fh:
        rows = [l.split() for l in fh.read().strip().splitlines() if l]
    if not rows:
        return np.zeros((0, 5), np.float32)
    lb = np.array(rows, dtype=np.float32)
    if lb.shape[1] != 5:
        raise ValueError(f"labels require 5 columns, got {lb.shape[1]}: {path}")
    if not (lb >= 0).all():
        raise ValueError(f"negative label values: {path}")
    if not (lb[:, 1:] <= 1).all():
        raise ValueError(f"non-normalized coordinates: {path}")
    _, idx = np.unique(lb, axis=0, return_index=True)
    return lb[np.sort(idx)]


def _save_replace(path: Path, a: np.ndarray) -> None:
    """``np.save`` to a temporary name beside ``path``, then an atomic rename
    into place: a reader sees the whole file or none."""
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        with open(tmp, "wb") as fh:
            np.save(fh, a)
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()


class Dataset:
    """Image+label dataset with cached labels and the YOLO augmentations."""

    def __init__(
        self,
        path,
        img_size: int = 640,
        augment: bool = False,
        hyp: Optional[Dict] = None,
        stride: int = 32,
        max_labels: int = 300,
        cache_dir: Optional[str] = None,
        single_cls: bool = False,
        rect: bool = False,
        rect_buckets: int = 4,
        cache_images: Optional[str] = None,
        uint8_out: bool = False,
        seed: int = 0,
    ):
        self.img_files = find_images(path)
        if not self.img_files:
            raise FileNotFoundError(f"no images found in {path}")
        self.label_files = [img2label_path(p) for p in self.img_files]
        self.img_size = img_size
        self.augment = augment
        self.hyp = dict(hyp or {})
        self.stride = stride
        self.max_labels = max_labels
        self.single_cls = single_cls
        self.uint8_out = uint8_out
        self.seed, self.epoch = seed, 0
        self.labels = self._load_labels(cache_dir)
        self.albumentations = Albumentations() if augment else None
        self.n = len(self.img_files)
        self.indices = np.arange(self.n)
        self.mosaic_border = [-img_size // 2, -img_size // 2]

        # decoded-image cache (reference --cache ram|disk): holds what
        # load_image returns (decoded and resized to img_size).  'ram' fills
        # on first access, unless the estimated footprint exceeds 80 % of the
        # available memory; 'disk' writes .npy files on first miss.
        self.cache_images = cache_images
        self.ims: Optional[list] = None
        self._im_hw0: Optional[list] = None
        if cache_images == "ram":
            if not self._cache_ram_ok():
                LOGGER.warning("image RAM cache would exceed 80% of available "
                               "memory; loading uncached")
                self.cache_images = None
            else:
                self.ims = [None] * self.n
                self._im_hw0 = [None] * self.n
        elif cache_images == "disk":
            base = Path(cache_dir) if cache_dir else (
                Path(self.img_files[0]).parent.parent / ".npy_cache")
            base.mkdir(parents=True, exist_ok=True)
            self._npy_dir = base
        elif cache_images is not None:
            raise ValueError(f"cache_images must be ram|disk, got {cache_images}")

        # rect mode: aspect ratios quantize into a few letterbox buckets, so
        # that a val pass sees a few static batch shapes
        self.rect = rect
        self.batch_shape = None  # per-image [h, w] when rect
        if rect:
            shapes = np.array([self._image_hw(p) for p in self.img_files])
            ar = shapes[:, 0] / shapes[:, 1]  # h / w
            qs = np.quantile(ar, np.linspace(0, 1, rect_buckets + 1))
            bucket_of = np.clip(np.searchsorted(qs, ar, "right") - 1, 0,
                                rect_buckets - 1)
            self.batch_shape = np.zeros((self.n, 2), int)
            for b in range(rect_buckets):
                sel = bucket_of == b
                if not sel.any():
                    continue
                a = np.median(ar[sel])
                if a < 1:  # wide
                    hw = (max(int(np.ceil(img_size * a / stride)) * stride,
                              stride), img_size)
                else:  # tall
                    hw = (img_size, max(int(np.ceil(img_size / a / stride))
                                        * stride, stride))
                self.batch_shape[sel] = hw
            self._bucket_of = bucket_of

    # -- labels ---------------------------------------------------------------

    def _load_labels(self, cache_dir):
        """The label arrays, through a hash-keyed ``.npz`` cache when
        ``cache_dir`` is given (plain arrays only: nothing is unpickled).

        The key covers the label files as well as the images, and the cache
        holds the rows as read, before ``single_cls`` zeroes the classes.
        The JAX package's ``LoadImagesAndLabels._load_labels`` keys on the
        images alone and caches after ``single_cls``, so there a
        ``single_cls`` run poisons a later multi-class one and an edited
        label file is never re-read; the port deviates to repair that.
        """
        labels = None
        cache_path = None
        key = _paths_hash(self.img_files + self.label_files)
        if cache_dir:
            cache_path = Path(cache_dir) / f"labels_{key}.npz"
            if cache_path.exists():
                z = np.load(cache_path)
                if str(z["hash"]) == key:
                    labels = np.split(z["rows"], np.cumsum(z["counts"])[:-1])
        if labels is None:
            labels = [load_label_file(p) for p in self.label_files]
            if cache_path:
                cache_path.parent.mkdir(parents=True, exist_ok=True)
                np.savez(cache_path, hash=key, rows=np.concatenate(labels),
                         counts=np.array([len(lb) for lb in labels]))
        if self.single_cls:
            for lb in labels:
                lb[:, 0] = 0
        return labels

    # -- image access ---------------------------------------------------------

    @staticmethod
    def _image_hw(path: str):
        with Image.open(path) as im:
            return im.height, im.width

    def meta(self, i: int) -> Dict:
        """Per-image eval metadata (reference ``shapes`` in
        utils/datasets.py __getitem__ + image ids in val.py:56-60): COCO
        image id (numeric filename stem, else the stem string), native
        (h0, w0) and the letterbox ``ratio_pad`` ((gain_y, gain_x), (pad_w,
        pad_h)) that maps the val canvas back to native space."""
        p = Path(self.img_files[i])
        img_id = int(p.stem) if p.stem.isnumeric() else p.stem
        h0, w0 = self._image_hw(self.img_files[i])
        r0 = self.img_size / max(h0, w0)
        h, w = (int(h0 * r0), int(w0 * r0)) if r0 != 1 else (h0, w0)
        shape = tuple(self.batch_shape[i]) if self.rect else (
            self.img_size, self.img_size)
        r = min(shape[0] / h, shape[1] / w, 1.0)  # letterbox scaleup=False
        new_unpad = (int(round(w * r)), int(round(h * r)))
        pad = ((shape[1] - new_unpad[0]) / 2, (shape[0] - new_unpad[1]) / 2)
        return dict(
            id=img_id,
            path=self.img_files[i],
            native_hw=(h0, w0),
            canvas_hw=shape,
            ratio_pad=((h / h0 * r, w / w0 * r), pad),
        )

    def _cache_ram_ok(self, frac: float = 0.8) -> bool:
        """The RAM cache's footprint, estimated from one image, against
        MemAvailable (reference check_cache_ram).

        Deviation: each image counts as ``r ** 2 * h0 * w0`` pixels, the size
        ``_decode_resize`` leaves it at, also when it upscales (``r > 1``);
        the JAX package (``ecs_yolo_tpu/data/dataset.py``) estimates
        ``min(1, r) ** 2 * h0 * w0`` and so passes a cache of images smaller
        than ``img_size`` that can exceed ``frac`` of MemAvailable."""
        try:
            h0, w0 = self._image_hw(self.img_files[0])
            r = self.img_size / max(h0, w0)
            need = self.n * 3 * r ** 2 * h0 * w0
            with open("/proc/meminfo") as f:
                avail = next(int(ln.split()[1]) * 1024 for ln in f
                             if ln.startswith("MemAvailable"))
            return need < frac * avail
        except (OSError, StopIteration):
            return True  # no meminfo: trust the caller

    def _decode_resize(self, i: int):
        with Image.open(self.img_files[i]) as fh:
            im = np.asarray(fh.convert("RGB"))
        h0, w0 = im.shape[:2]
        r = self.img_size / max(h0, w0)
        if r != 1:
            im = np.asarray(
                Image.fromarray(im).resize(
                    (int(w0 * r), int(h0 * r)), Image.BILINEAR
                )
            )
        return im, (h0, w0)

    def load_image(self, i: int):
        """Decode + resize the longest side to img_size (keeps the ratio).
        Returns (image uint8, native (h0, w0), resized (h, w)).  Served from
        the RAM/disk cache when one is on; an entry cached at another
        img_size (multi-scale epochs) is decoded afresh, not served stale.

        Deviation (disk cache): the ``.hw0.npy`` sidecar and the image
        ``.npy`` are each written to a temporary name and renamed into place,
        the sidecar first, and an image without its sidecar is decoded
        afresh.  The JAX package (``ecs_yolo_tpu/data/dataset.py``) writes the
        image first and, when the sidecar is missing (a run stopped between
        the two writes), takes the resized shape as the native size, which
        moves every box val rescales to native space."""
        if self.ims is not None:
            hit = self.ims[i]
            # _decode_resize leaves max(shape) == img_size, so a mismatch
            # means the entry was cached for another scale
            if hit is not None and max(hit.shape[:2]) == self.img_size:
                return hit, self._im_hw0[i], hit.shape[:2]
            im, hw0 = self._decode_resize(i)
            # one-element list writes are atomic under the interpreter lock:
            # safe from the loader threads of batches()
            self.ims[i], self._im_hw0[i] = im, hw0
            return im, hw0, im.shape[:2]
        if self.cache_images == "disk":
            p = self._npy_dir / f"{Path(self.img_files[i]).stem}_{i}_{self.img_size}.npy"
            hw_p = p.with_suffix(".hw0.npy")
            if p.exists() and hw_p.exists():
                im = np.load(p)
                return im, tuple(int(v) for v in np.load(hw_p)), im.shape[:2]
            im, hw0 = self._decode_resize(i)
            try:
                _save_replace(hw_p, np.asarray(hw0))
                _save_replace(p, im)
            except OSError:
                pass  # disk full: keep training uncached
            return im, hw0, im.shape[:2]
        im, hw0 = self._decode_resize(i)
        return im, hw0, im.shape[:2]

    def __len__(self):
        return self.n

    # -- augmentation ---------------------------------------------------------

    def sample_rng(self, index: int) -> random.Random:
        """The generator of one sample's augmentation, from (seed, epoch,
        index)."""
        state = np.random.SeedSequence([self.seed, self.epoch, index])
        return random.Random(int(state.generate_state(1, np.uint64)[0]))

    def load_mosaic(self, index: int, rng) -> Tuple[np.ndarray, np.ndarray]:
        """4-image mosaic (reference utils/datasets.py:681-750), then the
        random perspective warp back to img_size.  Labels come out as (cls,
        x1, y1, x2, y2) in pixels."""
        s = self.img_size
        yc = int(rng.uniform(-self.mosaic_border[0], 2 * s + self.mosaic_border[0]))
        xc = int(rng.uniform(-self.mosaic_border[1], 2 * s + self.mosaic_border[1]))
        idxs = [index] + [int(rng.choice(self.indices)) for _ in range(3)]
        img4 = np.full((s * 2, s * 2, 3), 114, dtype=np.uint8)
        labels4 = []
        for i, idx in enumerate(idxs):
            img, _, (h, w) = self.load_image(idx)
            if i == 0:  # top-left
                x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
                x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
                x2b, y2b = w, h
            elif i == 1:  # top-right
                x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
                x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
            elif i == 2:  # bottom-left
                x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
                x1b, y1b = w - (x2a - x1a), 0
                x2b, y2b = w, min(y2a - y1a, h)
            else:  # bottom-right
                x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
                x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
            img4[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
            padw, padh = x1a - x1b, y1a - y1b
            lb = self.labels[idx].copy()
            if len(lb):
                # normalised xywh -> mosaic-canvas xyxy
                xy = lb[:, 1:5].copy()
                lb[:, 1] = w * (xy[:, 0] - xy[:, 2] / 2) + padw
                lb[:, 2] = h * (xy[:, 1] - xy[:, 3] / 2) + padh
                lb[:, 3] = w * (xy[:, 0] + xy[:, 2] / 2) + padw
                lb[:, 4] = h * (xy[:, 1] + xy[:, 3] / 2) + padh
            labels4.append(lb)
        labels4 = np.concatenate(labels4, 0)
        labels4[:, 1:] = labels4[:, 1:].clip(0, 2 * s)

        hyp = self.hyp
        return random_perspective(
            img4,
            labels4,
            degrees=hyp.get("degrees", 0.0),
            translate=hyp.get("translate", 0.1),
            scale=hyp.get("scale", 0.5),
            shear=hyp.get("shear", 0.0),
            perspective=hyp.get("perspective", 0.0),
            border=self.mosaic_border,
            rng=rng,
        )

    def _augmented(self, index: int):
        """Image and normalised labels of one augmented sample (reference
        utils/datasets.py:553-624; the JAX ``__getitem__``'s train branch)."""
        hyp = self.hyp
        rng = self.sample_rng(index)
        if rng.random() < hyp.get("mosaic", 1.0):
            img, labels_xyxy = self.load_mosaic(index, rng)
            if rng.random() < hyp.get("mixup", 0.0):
                img2, labels2 = self.load_mosaic(int(rng.choice(self.indices)), rng)
                img, labels_xyxy = mixup(img, labels_xyxy, img2, labels2, rng=rng)
            h = w = img.shape[0]
            labels = labels_xyxy.copy()
            if len(labels):
                labels[:, 1] = ((labels_xyxy[:, 1] + labels_xyxy[:, 3]) / 2) / w
                labels[:, 2] = ((labels_xyxy[:, 2] + labels_xyxy[:, 4]) / 2) / h
                labels[:, 3] = (labels_xyxy[:, 3] - labels_xyxy[:, 1]) / w
                labels[:, 4] = (labels_xyxy[:, 4] - labels_xyxy[:, 2]) / h
        else:
            img, labels = self._letterboxed(index, scaleup=True)
        img, labels = self.albumentations(img, labels, rng=rng)
        img = augment_hsv(img, hyp.get("hsv_h", 0.015), hyp.get("hsv_s", 0.7),
                          hyp.get("hsv_v", 0.4), rng=rng)
        if rng.random() < hyp.get("flipud", 0.0):
            img, labels = flip_ud(img, labels)
        if rng.random() < hyp.get("fliplr", 0.5):
            img, labels = flip_lr(img, labels)
        return img, labels

    def _letterboxed(self, index: int, scaleup: bool):
        img, _, (h, w) = self.load_image(index)
        shape = tuple(self.batch_shape[index]) if self.rect else self.img_size
        img, ratio, pad = letterbox(img, shape, auto=False, scaleup=scaleup)
        labels = self.labels[index].copy()
        if len(labels):
            # renormalize to the letterboxed canvas
            nh, nw = img.shape[:2]
            labels[:, 1] = (labels[:, 1] * w * ratio[0] + pad[0]) / nw
            labels[:, 2] = (labels[:, 2] * h * ratio[1] + pad[1]) / nh
            labels[:, 3] = labels[:, 3] * w * ratio[0] / nw
            labels[:, 4] = labels[:, 4] * h * ratio[1] / nh
        return img, labels

    def __getitem__(self, index: int):
        """Returns (image [H,W,3], labels [max_labels,5] normalised to the
        canvas, mask [max_labels])."""
        if self.augment:
            img, labels = self._augmented(index)
        else:
            img, labels = self._letterboxed(index, scaleup=False)
        out_l = np.zeros((self.max_labels, 5), np.float32)
        mask = np.zeros((self.max_labels,), bool)
        n = min(len(labels), self.max_labels)
        if n:
            out_l[:n] = labels[:n]
            mask[:n] = True
        if self.uint8_out:
            # uint8 to the device, divided there: a quarter of the traffic
            return np.ascontiguousarray(img), out_l, mask
        return img.astype(np.float32) / 255.0, out_l, mask

    # -- batching -------------------------------------------------------------

    def _batch_plan(self, batch_size: int, shuffle: bool, seed: int,
                    drop_last: bool) -> List[np.ndarray]:
        """The ordered list of per-batch index groups (rect buckets kept
        contiguous so each batch has one shape)."""
        order = np.array(self.indices)
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        if self.rect:
            groups = [
                order[self._bucket_of[order] == b]
                for b in np.unique(self._bucket_of)
            ]
        else:
            groups = [order]
        plan: List[np.ndarray] = []
        for grp in groups:
            n = len(grp)
            if n == 0:
                continue
            end = n - (n % batch_size) if drop_last else n
            if end == 0:
                end = n
            plan += [grp[i : i + batch_size] for i in range(0, end, batch_size)]
        return plan

    def _collate(self, idxs, items, batch_size: int, drop_last: bool,
                 yield_count: bool, yield_idx: bool):
        ims, lbs, ms = zip(*items)
        ims = np.stack(ims)
        if len(idxs) < batch_size and not drop_last:
            padn = batch_size - len(idxs)
            ims = np.concatenate(
                [ims, np.zeros((padn,) + ims.shape[1:], ims.dtype)]
            )
            lbs = list(lbs) + [np.zeros_like(lbs[0])] * padn
            ms = list(ms) + [np.zeros_like(ms[0])] * padn
        if yield_idx:
            return (ims, np.stack(lbs), np.stack(ms), len(idxs),
                    [int(j) for j in idxs])
        if yield_count:
            return ims, np.stack(lbs), np.stack(ms), len(idxs)
        return ims, np.stack(lbs), np.stack(ms)

    @staticmethod
    def _quadify(ims, lbs, ms):
        """Quad collate (reference ``--quad``, utils/datasets.py:659
        collate_fn4, as the JAX package tiles it): every 4 samples become one
        2x canvas, a quarter of the batch at twice the side; the labels shift
        and halve into their quadrant.  The tiling is deterministic (the
        reference's random upscaled tile is not taken over, as in JAX)."""
        b, h, w, c = ims.shape
        q = ims.reshape(b // 4, 2, 2, h, w, c)
        q = q.transpose(0, 1, 3, 2, 4, 5).reshape(b // 4, 2 * h, 2 * w, c)
        lbs = lbs.reshape(b // 4, 4, *lbs.shape[1:]).copy()
        col = np.array([0, 1, 0, 1], np.float32)[None, :, None]
        row = np.array([0, 0, 1, 1], np.float32)[None, :, None]
        lbs[..., 1] = (lbs[..., 1] + col) / 2
        lbs[..., 2] = (lbs[..., 2] + row) / 2
        lbs[..., 3:5] /= 2
        return q, lbs.reshape(b // 4, -1, 5), ms.reshape(b // 4, -1)

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0,
                drop_last: bool = True, yield_count: bool = False,
                yield_idx: bool = False, workers: int = 0, prefetch: int = 2,
                host_shard=None, quad: bool = False):
        """Yield (images [B,H,W,3], labels [B,M,5], masks [B,M]) batches.
        In rect mode, batches group by aspect-ratio bucket.  With
        ``yield_count`` each batch also carries the number of real
        (non-padded) rows, so eval loops can skip the zero-padded tail of
        the last partial batch.  With ``yield_idx`` it additionally carries
        the dataset indices of the real rows, so eval loops can fetch
        per-image ``meta``.

        ``workers > 0`` decodes on a thread pool (PIL releases the
        interpreter lock while it decodes and resizes) and keeps
        ``prefetch`` assembled batches ahead of the consumer, so the card
        does not wait for the host's image decode.

        ``quad`` yields the quad collate of full batches (``batch_size % 4 ==
        0``; train-time only, so no ``yield_count``/``yield_idx``).

        ``host_shard=(rank, world)``: every rank walks the same seeded plan
        over the global ``batch_size`` and takes rows ``[rank * per, (rank +
        1) * per)`` of each full batch (``per = batch_size / world``; a
        partial batch is dropped), as JAX's ``batches`` does; with ``quad``
        each rank tiles its own rows."""
        if quad:
            if yield_count or yield_idx:
                raise ValueError("quad collate carries no eval metadata")
            if batch_size % 4:
                raise ValueError(f"quad needs batch % 4 == 0, got {batch_size}")
            for ims, lbs, ms in self.batches(
                    batch_size, shuffle=shuffle, seed=seed, drop_last=True,
                    workers=workers, prefetch=prefetch, host_shard=host_shard):
                yield self._quadify(ims, lbs, ms)
            return
        plan = self._batch_plan(batch_size, shuffle, seed, drop_last)
        if host_shard is not None:
            rows = local_batch_slice(batch_size, *host_shard)
            plan = [idxs[rows] for idxs in plan if len(idxs) == batch_size]  # full only
            batch_size = rows.stop - rows.start
        if workers <= 0:
            for idxs in plan:
                yield self._collate(
                    idxs, [self[int(j)] for j in idxs],
                    batch_size, drop_last, yield_count, yield_idx,
                )
            return

        q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        stop = threading.Event()
        failure = object()          # tags an exception sent to the consumer

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def _produce():
            try:
                with ThreadPoolExecutor(max_workers=workers) as ex:
                    inflight = deque()
                    it = iter(plan)

                    def _submit():
                        idxs = next(it, None)
                        if idxs is not None:
                            inflight.append(
                                (idxs,
                                 [ex.submit(self.__getitem__, int(j))
                                  for j in idxs])
                            )

                    for _ in range(max(prefetch, 1) + 1):
                        _submit()
                    while inflight and not stop.is_set():
                        idxs, futs = inflight.popleft()
                        batch = self._collate(
                            idxs, [f.result() for f in futs],
                            batch_size, drop_last, yield_count, yield_idx,
                        )
                        if not _put(batch):
                            return
                        _submit()
            except Exception as e:  # handed to the consumer, raised there
                _put((failure, e))
                return
            _put(None)

        thread = threading.Thread(target=_produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, tuple) and item[0] is failure:
                    raise item[1]
                yield item
        finally:
            stop.set()
            thread.join(timeout=10)


def load_segment_label_file(path: str):
    """One YOLO-seg txt -> ``(labels [n, 5], segments: list of [k, 2])``
    (reference utils/segment/dataloaders.py): rows ``cls x1 y1 x2 y2 ...``,
    a normalised polygon of at least 3 points (shorter rows are skipped);
    the box is the polygon's extent."""
    if not os.path.isfile(path):
        return np.zeros((0, 5), np.float32), []
    labels, segments = [], []
    with open(path) as fh:
        for line in fh.read().strip().splitlines():
            parts = line.split()
            if len(parts) < 7:
                continue
            pts = np.array(parts[1:], np.float32).reshape(-1, 2)
            x1, y1 = pts.min(0)
            x2, y2 = pts.max(0)
            labels.append([float(parts[0]), (x1 + x2) / 2, (y1 + y2) / 2,
                           x2 - x1, y2 - y1])
            segments.append(pts)
    if not labels:
        return np.zeros((0, 5), np.float32), []
    return np.array(labels, np.float32), segments


class SegmentDataset(Dataset):
    """``Dataset`` plus per-instance masks for ``Segment`` / ``Panoptic``
    training (reference utils/segment/dataloaders.py), from polygon labels.

    A sample is ``(image, labels, mask, masks [M, h/r, w/r] float32)`` with
    each instance's polygon rasterised by PIL at 1/``mask_ratio`` of the
    letterbox canvas (the reference's downsample 4); with ``semantic``
    (``Panoptic``) also an int32 class-id map at that size: the stuff
    polygons of ``stuff/<stem>.txt`` drawn first, then the instances
    (their class ids), background -1.  ``include_masks=False`` (the val
    loop) yields plain detection samples.  Mosaic, mixup and the flips are
    off (boxes and polygons would need the same transform); letterbox and
    HSV apply.  The collate pads masks with 0 and id maps with -1.  The
    ``quad`` collate is refused for mask batches."""

    def __init__(self, *args, mask_ratio: int = 4, include_masks: bool = True,
                 semantic: bool = False, **kw):
        kw.setdefault("hyp", {})
        super().__init__(*args, **kw)
        self.mask_ratio = mask_ratio
        self.include_masks = include_masks
        self.semantic = semantic and include_masks
        for k in ("mosaic", "mixup", "fliplr", "flipud"):
            self.hyp[k] = 0.0

    def _load_labels(self, cache_dir):
        self.segments = []
        labels = []
        for p in self.label_files:
            lb, segs = load_segment_label_file(p)
            labels.append(lb)
            self.segments.append(segs)
        if self.single_cls:
            for lb in labels:
                if len(lb):
                    lb[:, 0] = 0
        return labels

    def _polygon(self, pts: np.ndarray, meta: Dict):
        """A normalised native polygon in mask pixels of the canvas."""
        (gy, gx), (pw, ph) = meta["ratio_pad"]
        h0, w0 = meta["native_hw"]
        px = pts[:, 0] * w0 * gx + pw
        py = pts[:, 1] * h0 * gy + ph
        return [(x / self.mask_ratio, y / self.mask_ratio) for x, y in zip(px, py)]

    def __getitem__(self, index: int):
        from PIL import ImageDraw

        if not self.include_masks:
            return super().__getitem__(index)
        img, labels, valid = super().__getitem__(index)
        h, w = img.shape[:2]
        mh, mw = h // self.mask_ratio, w // self.mask_ratio
        masks = np.zeros((self.max_labels, mh, mw), np.float32)
        meta = self.meta(index)
        segs = self.segments[index]
        for i in range(min(len(segs), self.max_labels)):
            im = Image.new("F", (mw, mh), 0.0)
            ImageDraw.Draw(im).polygon(self._polygon(segs[i], meta), fill=1.0)
            masks[i] = np.asarray(im)
        if not self.semantic:
            return img, labels, valid, masks
        sem = Image.new("I", (mw, mh), -1)
        draw = ImageDraw.Draw(sem)
        stuff_lb, stuff_segs = load_segment_label_file(img2stuff_path(self.img_files[index]))
        for row, pts in zip(stuff_lb, stuff_segs):
            draw.polygon(self._polygon(pts, meta), fill=int(row[0]))
        raw = self.labels[index]
        for i in range(min(len(segs), len(raw))):
            draw.polygon(self._polygon(segs[i], meta), fill=int(raw[i, 0]))
        return img, labels, valid, masks, np.asarray(sem, np.int32)

    def _collate(self, idxs, items, batch_size, drop_last, yield_count, yield_idx):
        if not self.include_masks:
            return super()._collate(idxs, items, batch_size, drop_last, yield_count,
                                    yield_idx)
        cols = list(zip(*items))
        base = super()._collate(idxs, list(zip(*cols[:3])), batch_size, drop_last,
                                yield_count, yield_idx)
        extra = []
        for col in cols[3:]:        # instance masks, then the id map
            arr = np.stack(col)
            if len(idxs) < batch_size and not drop_last:
                fill = -1 if np.issubdtype(arr.dtype, np.integer) else 0
                arr = np.concatenate([arr, np.full((batch_size - len(idxs),)
                                                   + arr.shape[1:], fill, arr.dtype)])
            extra.append(arr)
        return (*base, *extra)

    def batches(self, batch_size: int, *args, quad: bool = False, **kw):
        """``Dataset.batches``; each batch also carries the masks (and the
        id map) after the three detection arrays."""
        if quad and self.include_masks:
            raise ValueError("the quad collate does not tile instance masks")
        return super().batches(batch_size, *args, quad=quad, **kw)
