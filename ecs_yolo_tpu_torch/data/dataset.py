"""Validation dataset: images + YOLO-format txt labels (counterpart of
``ecs_yolo_tpu/data/dataset.py``, the val half).

Label discovery through the images -> labels path convention, letterbox to a
square canvas (or to a few aspect-ratio buckets in ``rect`` mode), labels
padded to ``max_labels`` with a validity mask, static-shape batches with the
last one zero-padded, and the per-image ``meta`` that maps the canvas back to
the native image.  Images come out channels-last, uint8 (``uint8_out``, divide
on the device) or float32 in [0, 1].

The train half (``augment=True``: mosaic, perspective, HSV, flips; the image
caches; ``quad`` collate; ``host_shard``; ``SegmentDataset``) is not ported
yet (ROADMAP Queue 1 item 7) and raises ``NotImplementedError``.
"""

from __future__ import annotations

import hashlib
import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from .augment import letterbox

IMG_FORMATS = {"bmp", "jpeg", "jpg", "png", "tif", "tiff", "webp"}
_TRAIN_HALF = "is part of the train data path, not ported yet (ROADMAP Queue 1 item 7)"


def img2label_path(p: str) -> str:
    """images/xxx.jpg -> labels/xxx.txt (reference utils/datasets.py:371)."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
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
    h = hashlib.md5()
    for p in paths:
        h.update(p.encode())
        try:
            h.update(str(os.path.getsize(p)).encode())
        except OSError:
            pass
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


class Dataset:
    """Image+label dataset for evaluation (``augment=False``)."""

    def __init__(
        self,
        path,
        img_size: int = 640,
        augment: bool = False,
        stride: int = 32,
        max_labels: int = 300,
        cache_dir: Optional[str] = None,
        single_cls: bool = False,
        rect: bool = False,
        rect_buckets: int = 4,
        cache_images: Optional[str] = None,
        uint8_out: bool = False,
    ):
        if augment:
            raise NotImplementedError(f"augment=True {_TRAIN_HALF}")
        if cache_images is not None:
            raise NotImplementedError(f"cache_images {_TRAIN_HALF}")
        self.img_files = find_images(path)
        if not self.img_files:
            raise FileNotFoundError(f"no images found in {path}")
        self.label_files = [img2label_path(p) for p in self.img_files]
        self.img_size = img_size
        self.augment = False
        self.stride = stride
        self.max_labels = max_labels
        self.single_cls = single_cls
        self.uint8_out = uint8_out
        self.labels = self._load_labels(cache_dir)
        self.n = len(self.img_files)
        self.indices = np.arange(self.n)

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
        ``cache_dir`` is given (plain arrays only: nothing is unpickled)."""
        cache_path = None
        key = _paths_hash(self.img_files)
        if cache_dir:
            cache_path = Path(cache_dir) / f"labels_{key}.npz"
            if cache_path.exists():
                z = np.load(cache_path)
                if str(z["hash"]) == key:
                    return np.split(z["rows"], np.cumsum(z["counts"])[:-1])
        labels = [load_label_file(p) for p in self.label_files]
        if self.single_cls:
            for lb in labels:
                lb[:, 0] = 0
        if cache_path:
            cache_path.parent.mkdir(parents=True, exist_ok=True)
            np.savez(cache_path, hash=key, rows=np.concatenate(labels),
                     counts=np.array([len(lb) for lb in labels]))
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

    def load_image(self, i: int):
        """Decode + resize the longest side to img_size (keeps the ratio).
        Returns (image uint8, native (h0, w0), resized (h, w))."""
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
        return im, (h0, w0), im.shape[:2]

    def __len__(self):
        return self.n

    def __getitem__(self, index: int):
        """Returns (image [H,W,3], labels [max_labels,5] normalised to the
        canvas, mask [max_labels])."""
        img, _, (h, w) = self.load_image(index)
        shape = tuple(self.batch_shape[index]) if self.rect else self.img_size
        img, ratio, pad = letterbox(img, shape, auto=False, scaleup=False)
        labels = self.labels[index].copy()
        if len(labels):
            # renormalize to the letterboxed canvas
            nh, nw = img.shape[:2]
            labels[:, 1] = (labels[:, 1] * w * ratio[0] + pad[0]) / nw
            labels[:, 2] = (labels[:, 2] * h * ratio[1] + pad[1]) / nh
            labels[:, 3] = labels[:, 3] * w * ratio[0] / nw
            labels[:, 4] = labels[:, 4] * h * ratio[1] / nh

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
        does not wait for the host's image decode."""
        if quad:
            raise NotImplementedError(f"quad collate {_TRAIN_HALF}")
        if host_shard is not None:
            raise NotImplementedError(f"host_shard {_TRAIN_HALF}")
        plan = self._batch_plan(batch_size, shuffle, seed, drop_last)
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


class SegmentDataset:
    """Instance-mask dataset of the JAX package: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"SegmentDataset {_TRAIN_HALF}")
