"""Inference input loaders (counterpart of ``ecs_yolo_tpu/data/loaders.py``):
image files (``LoadImages``), video files (``LoadVideo``), several live or
finite sources read by threads (``LoadStreams``), screen capture
(``LoadScreenshots``) and an ImageFolder-style classification set
(``ClassificationDataset``).

Each detection loader yields ``(name, [B, H, W, 3] float32 in [0, 1],
original uint8 frame(s))``, letterboxed as the JAX loaders letterbox.

Frames of a video come through ``imageio.v3`` where it imports, as in the JAX
package.  Where it does not, the formats Pillow decodes (``gif``, animated
``webp``) are read frame by frame through ``PIL.ImageSequence``, and any
other source raises ``ImportError`` naming imageio when the loader is built.
"""

from __future__ import annotations

import glob
import os
import threading
import time
from pathlib import Path
from typing import Callable, Iterator, Tuple

import numpy as np
from PIL import Image, ImageSequence

from .augment import letterbox
from .dataset import IMG_FORMATS

VID_FORMATS = {"mp4", "avi", "mov", "mkv", "gif", "webm"}
#: video formats Pillow decodes, read through it when imageio is absent
PIL_VID_FORMATS = {"gif", "webp"}


def frame_reader(source) -> Callable[[], Iterator[np.ndarray]]:
    """A function that iterates the RGB ``uint8`` frames of ``source`` (a
    file, URL or camera name imageio reads).  Raises ``ImportError`` now when
    imageio is absent and Pillow cannot decode ``source``."""
    source = str(source)
    try:
        import imageio.v3 as iio
    except ImportError:
        iio = None
    if iio is not None:
        return lambda: (np.asarray(f)[..., :3] for f in iio.imiter(source))
    if source.rsplit(".", 1)[-1].lower() not in PIL_VID_FORMATS or not os.path.isfile(source):
        raise ImportError(f"reading {source} needs imageio (`pip install imageio`); "
                          f"without it only local {sorted(PIL_VID_FORMATS)} files are "
                          "read, through Pillow")

    def frames():
        with Image.open(source) as im:
            for frame in ImageSequence.Iterator(im):
                yield np.asarray(frame.convert("RGB"))
    return frames


def _to_input(im0: np.ndarray, img_size: int, stride: int, auto: bool = False) -> np.ndarray:
    im, _, _ = letterbox(im0, img_size, stride=stride, auto=auto)
    return im.astype(np.float32) / 255.0


class LoadVideo:
    """Frames of one video file (reference LoadImages' video branch,
    utils/datasets.py:226-270), every ``vid_stride``-th, as ``(f"{path}#{i}",
    [1, H, W, 3], frame)``."""

    def __init__(self, path, img_size: int = 640, stride: int = 32,
                 vid_stride: int = 1):
        self.path = str(path)
        self._frames = frame_reader(self.path)
        self.img_size = img_size
        self.stride = stride
        self.vid_stride = vid_stride

    def __iter__(self):
        for i, im0 in enumerate(self._frames()):
            if i % self.vid_stride:
                continue
            yield f"{self.path}#{i}", _to_input(im0, self.img_size, self.stride)[None], im0


class LoadStreams:
    """Threaded multi-source reader (reference LoadStreams,
    utils/datasets.py:283-368): one daemon thread a source keeps its latest
    frame; iteration yields ``(sources, [B, H, W, 3], [frame, ...])`` once
    every source has a frame.  A finite source (a file) ends the iteration
    after its readers have drained, the last frames delivered once; a live
    one is read until ``close()``.

    ``sources`` is a list, one source, or a ``.txt`` file of them, one a
    line."""

    def __init__(self, sources, img_size: int = 640, stride: int = 32):
        if isinstance(sources, (str, Path)):
            p = Path(sources)
            sources = (p.read_text().strip().splitlines()
                       if p.is_file() and p.suffix == ".txt" else [str(sources)])
        self.sources = list(sources)
        self.img_size = img_size
        self.stride = stride
        self.frames = [None] * len(self.sources)
        self.running = True
        readers = [frame_reader(src) for src in self.sources]   # a missing decoder raises here
        self.threads = [threading.Thread(target=self._read, args=(i, r), daemon=True)
                        for i, r in enumerate(readers)]
        for t in self.threads:
            t.start()

    def _read(self, i: int, frames) -> None:
        try:
            for frame in frames():
                if not self.running:
                    return
                self.frames[i] = frame
        except Exception as e:      # a live stream's end is an exception of its reader
            from ..utils.general import LOGGER

            LOGGER.info(f"stream {self.sources[i]} ended: {e}")

    def __iter__(self):
        while self.running:
            alive = any(t.is_alive() for t in self.threads)
            if any(f is None for f in self.frames):
                if not alive:
                    return          # a source ended before its first frame
                time.sleep(0.01)
                continue
            ims0 = [f.copy() for f in self.frames]
            ims = np.stack([_to_input(f, self.img_size, self.stride) for f in ims0])
            yield self.sources, ims, ims0
            if not alive:           # finite sources drained: the last frames went out once
                return

    def close(self) -> None:
        """Stop the readers (each leaves at its next frame) and wait up to a
        second for each (a live source may block longer in its read)."""
        self.running = False
        for t in self.threads:
            t.join(1.0)


class ClassificationDataset:
    """ImageFolder-style classification set (reference
    utils/dataloaders.py:1159): ``root/<class name>/<image>``, classes in
    name order, items ``([S, S, 3] float32 in [0, 1], class index)`` resized
    with PIL's bilinear filter.  Data only: neither package has a
    classification model."""

    def __init__(self, root, img_size: int = 224):
        root = Path(root)
        self.classes = sorted(d.name for d in root.iterdir() if d.is_dir())
        self.samples = [(str(f), ci) for ci, cname in enumerate(self.classes)
                        for f in sorted((root / cname).glob("*.*"))
                        if f.suffix[1:].lower() in IMG_FORMATS]
        if not self.samples:
            raise FileNotFoundError(f"no classified images under {root}")
        self.img_size = img_size

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        path, ci = self.samples[i]
        with Image.open(path) as im:
            im = im.convert("RGB").resize((self.img_size, self.img_size), Image.BILINEAR)
        return np.asarray(im).astype(np.float32) / 255.0, ci

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0):
        """Full batches ``([B, S, S, 3], [B] class indices)``; with
        ``shuffle`` the order of ``np.random.RandomState(seed)``."""
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        for i in range(0, len(self) - batch_size + 1, batch_size):
            ims, cls = zip(*(self[int(j)] for j in order[i:i + batch_size]))
            yield np.stack(ims), np.array(cls)


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
            yield path, _to_input(im0, self.img_size, self.stride, self.auto)[None], im0


class LoadScreenshots:
    """Screen capture (reference utils/dataloaders.py:188): a ``screen
    [left top width height]`` source, one letterboxed grab an iteration
    through ``mss``.  Without ``mss`` construction raises its install hint;
    ``parse_source`` works without it."""

    @staticmethod
    def parse_source(source: str):
        """``'screen 0 100 200 512 256'`` -> ``(screen, left, top, width,
        height)``; ``None`` where the source leaves a value to the monitor."""
        parts = str(source).split()[1:]        # drop the 'screen' keyword
        screen, left, top, width, height = 0, None, None, None, None
        if len(parts) == 1:
            screen = int(parts[0])
        elif len(parts) == 4:
            left, top, width, height = (int(x) for x in parts)
        elif len(parts) == 5:
            screen, left, top, width, height = (int(x) for x in parts)
        return screen, left, top, width, height

    def __init__(self, source: str, img_size: int = 640, stride: int = 32,
                 auto: bool = False):
        try:
            import mss
        except ImportError as e:
            raise ImportError("LoadScreenshots requires `pip install mss` (not available "
                              "in this image)") from e
        self.screen, left, top, width, height = self.parse_source(source)
        self.img_size, self.stride, self.auto = img_size, stride, auto
        self.sct = mss.mss()
        mon = self.sct.monitors[self.screen]
        self.monitor = {
            "left": mon["left"] if left is None else mon["left"] + left,
            "top": mon["top"] if top is None else mon["top"] + top,
            "width": width or mon["width"],
            "height": height or mon["height"],
        }
        self.frame = 0

    def __iter__(self):
        return self

    def __next__(self):
        im0 = np.ascontiguousarray(np.asarray(self.sct.grab(self.monitor))[:, :, :3][:, :, ::-1])
        self.frame += 1
        return (f"screen{self.screen}_{self.frame}",
                _to_input(im0, self.img_size, self.stride, self.auto)[None], im0)
