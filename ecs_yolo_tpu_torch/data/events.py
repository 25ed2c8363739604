"""Gen1 event-camera pipeline (counterpart of ``ecs_yolo_tpu/data/events.py``):
the Prophesee ``.dat`` reader, the offline voxelizer, and the
``[B, T, H, W, C]`` event dataset.

* ``DatReader``: Prophesee GEN1 streams read as the reference's
  ``PSEELoader`` reads them (``seek_time`` + ``load_delta_t``);
* ``build_dataset``: for each labelled timestamp, ``sample_size`` µs of
  history split into T slices, each painted on a grey-127 canvas with 255/0
  by event polarity, saved as ``img``/``label`` ``.npy`` pairs plus a split
  list;
* ``EventDataset``: the T frames resized, the labels padded to
  ``max_labels`` with a validity mask, batches collated to ``[B, T, H, W, C]``
  float32 in [0, 1].

Event batches feed the same models as images: a 5-D input puts
``models/yolo.DetectionModel`` in event mode (the stem runs at every step;
size the model to the data's T with ``SNNConfig(time_window=T)``, as
``train/driver.py`` does).  numpy and PIL only; ``paint_events`` stays numpy,
as in the JAX package (``native.paint_events`` is the same painter in C++).
An event batch has no per-image letterbox ``meta``: ``val.run`` evaluates it
in canvas space with image ids counted from 1.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np
from PIL import Image

GEN1_SHAPE = (240, 304)  # h, w

BBOX_DTYPE = np.dtype(
    [
        ("ts", "<u8"),
        ("x", "<f4"),
        ("y", "<f4"),
        ("w", "<f4"),
        ("h", "<f4"),
        ("class_id", "<u4"),
        ("confidence", "<f4"),
        ("track_id", "<u4"),
    ]
)


class DatReader:
    """Prophesee GEN1 ``.dat`` event stream reader (PSEELoader equivalent).

    Format: '%'-prefixed ASCII header lines, then one byte event type + one
    byte event size, then little-endian records of
    ``(timestamp: u4, word: u4)`` with x = word & 0x3FFF,
    y = (word >> 14) & 0x3FFF, polarity = (word >> 28) & 0xF.
    """

    def __init__(self, path):
        self.path = str(path)
        with open(self.path, "rb") as fh:
            while True:
                pos = fh.tell()
                line = fh.readline()
                if not line.startswith(b"%"):
                    fh.seek(pos)
                    break
            self._ev_type = fh.read(1)
            self._ev_size = int.from_bytes(fh.read(1), "little") or 8
            self._data_start = fh.tell()
        size_bytes = os.path.getsize(self.path) - self._data_start
        self.n_events = size_bytes // self._ev_size
        self._cursor = 0  # event index
        self._ts_cache = None

    def _read_raw(self, start: int, count: int) -> np.ndarray:
        count = max(0, min(count, self.n_events - start))
        if count == 0:
            return np.zeros(0, dtype=np.uint64).view(
                np.dtype([("t", "<u4"), ("w", "<u4")])
            )
        with open(self.path, "rb") as fh:
            fh.seek(self._data_start + start * self._ev_size)
            raw = np.fromfile(fh, dtype=np.dtype([("t", "<u4"), ("w", "<u4")]), count=count)
        return raw

    def _timestamps(self) -> np.ndarray:
        if self._ts_cache is None:
            raw = self._read_raw(0, self.n_events)
            self._ts_cache = raw["t"].astype(np.int64)
        return self._ts_cache

    def seek_time(self, ts: int):
        """Position the cursor at the first event with timestamp >= ts."""
        self._cursor = int(np.searchsorted(self._timestamps(), ts, "left"))

    def load_delta_t(self, delta_t: int) -> np.ndarray:
        """Read all events in the next `delta_t` µs from the cursor.

        Returns a structured array with fields t, x, y, p.
        """
        ts = self._timestamps()
        if self._cursor >= self.n_events:
            end = self._cursor
        else:
            t0 = ts[self._cursor]
            end = int(np.searchsorted(ts, t0 + delta_t, "left"))
        raw = self._read_raw(self._cursor, end - self._cursor)
        self._cursor = end
        out = np.zeros(
            len(raw),
            dtype=np.dtype(
                [("t", "<i8"), ("x", "<i4"), ("y", "<i4"), ("p", "<i4")]
            ),
        )
        out["t"] = raw["t"]
        out["x"] = raw["w"] & 0x3FFF
        out["y"] = (raw["w"] >> 14) & 0x3FFF
        out["p"] = (raw["w"] >> 28) & 0xF
        return out


def paint_events(events: np.ndarray, shape=GEN1_SHAPE) -> np.ndarray:
    """Grey-127 canvas, 255 where positive polarity, 0 where negative
    (reference create_data, give_g1_data.py:550-566)."""
    h, w = shape
    canvas = np.full((h, w, 3), 127, dtype=np.uint8)
    if len(events):
        x = np.clip(events["x"], 0, w - 1)
        y = np.clip(events["y"], 0, h - 1)
        val = np.where(events["p"] > 0, 255, 0).astype(np.uint8)
        canvas[y, x] = val[:, None]
    return canvas


def voxelize_sample(
    reader: DatReader,
    ts: int,
    sample_size: int = 250_000,
    t_bins: int = 5,
    shape=GEN1_SHAPE,
) -> np.ndarray:
    """[T, H, W, 3] uint8 voxel grid of the `sample_size` µs before `ts`
    (reference create_sample, give_g1_data.py:493-511)."""
    reader.seek_time(ts - sample_size)
    frames = []
    for _ in range(t_bins):
        ev = reader.load_delta_t(sample_size // t_bins)
        frames.append(paint_events(ev, shape))
    return np.stack(frames)


def normalize_boxes(
    boxes: np.ndarray, shape=GEN1_SHAPE
) -> np.ndarray:
    """Prophesee bbox records -> deduped [n, 5] (cls, cx, cy, w, h) normalized
    (reference create_targets, give_g1_data.py:513-548): keep the last record
    per track_id, clamp to frame, normalize to frame size."""
    h, w = shape
    if len(boxes) == 0:
        return np.zeros((0, 5), np.float32)
    # dedupe by track id, keep last occurrence
    _, last_idx = np.unique(boxes["track_id"][::-1], return_index=True)
    keep = len(boxes) - 1 - last_idx
    b = boxes[np.sort(keep)]
    x1 = np.clip(b["x"], 0, w - 1)
    y1 = np.clip(b["y"], 0, h - 1)
    x2 = np.clip(b["x"] + b["w"], 0, w - 1)
    y2 = np.clip(b["y"] + b["h"], 0, h - 1)
    ok = (x2 > x1) & (y2 > y1)
    out = np.stack(
        [
            b["class_id"].astype(np.float32),
            ((x1 + x2) / 2) / w,
            ((y1 + y2) / 2) / h,
            (x2 - x1) / w,
            (y2 - y1) / h,
        ],
        axis=1,
    ).astype(np.float32)
    return out[ok]


def build_dataset(
    dat_label_pairs: Sequence[Tuple[str, str]],
    out_dir,
    sample_size: int = 250_000,
    t_bins: int = 5,
    shape=GEN1_SHAPE,
    split: str = "train",
):
    """Offline converter: (events.dat, boxes.npy) pairs -> img_*.npy +
    label_*.npy + split list (reference build_dataset, give_g1_data.py:439).
    """
    out_dir = Path(out_dir)
    (out_dir / "images").mkdir(parents=True, exist_ok=True)
    (out_dir / "labels").mkdir(parents=True, exist_ok=True)
    index = []
    n = 0
    for dat_path, label_path in dat_label_pairs:
        reader = DatReader(dat_path)
        boxes = np.load(label_path)
        for ts in np.unique(boxes["ts"]):
            if ts < sample_size:
                continue
            sample = voxelize_sample(reader, int(ts), sample_size, t_bins, shape)
            labels = normalize_boxes(boxes[boxes["ts"] == ts], shape)
            if len(labels) == 0:
                continue
            img_p = out_dir / "images" / f"ev_{n:07d}.npy"
            lbl_p = out_dir / "labels" / f"ev_{n:07d}.npy"
            np.save(img_p, sample)
            np.save(lbl_p, labels)
            index.append(str(img_p))
            n += 1
    with open(out_dir / f"{split}.txt", "w") as fh:
        fh.write("\n".join(index))
    return n


class EventDataset:
    """Pre-voxelized event dataset -> [B, T, H, W, C] float batches
    (reference utils/datasets_g1T.py:106-545)."""

    def __init__(
        self,
        path,
        img_size: int = 320,
        max_labels: int = 100,
    ):
        p = Path(path)
        if p.is_file() and p.suffix == ".txt":
            self.files = [l for l in p.read_text().strip().splitlines() if l]
        else:
            self.files = sorted(str(f) for f in Path(p).rglob("ev_*.npy"))
        assert self.files, f"no event samples under {path}"
        self.img_size = img_size
        self.max_labels = max_labels

    def __len__(self):
        return len(self.files)

    def _label_path(self, img_path: str) -> str:
        return img_path.replace(
            f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
        )

    def __getitem__(self, i: int):
        sample = np.load(self.files[i])  # [T, H, W, 3] uint8
        t = sample.shape[0]
        s = self.img_size
        if sample.shape[1] != s or sample.shape[2] != s:
            frames = [
                np.asarray(
                    Image.fromarray(f).resize((s, s), Image.BILINEAR)
                )
                for f in sample
            ]
            sample = np.stack(frames)
        img = sample.astype(np.float32) / 255.0  # [T, s, s, 3]
        labels = np.load(self._label_path(self.files[i]))
        out_l = np.zeros((self.max_labels, 5), np.float32)
        mask = np.zeros((self.max_labels,), bool)
        n = min(len(labels), self.max_labels)
        if n:
            out_l[:n] = labels[:n]
            mask[:n] = True
        return img, out_l, mask

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0,
                drop_last: bool = True, yield_count: bool = False,
                workers: int = 0, prefetch: int = 2, host_shard=None,
                quad: bool = False):
        """Yield ``(images [B, T, s, s, 3], labels [B, M, 5], masks [B, M])``,
        with ``yield_count`` also the number of real rows (the last batch of
        ``drop_last=False`` is zero-padded to ``batch_size``).  ``host_shard
        = (rank, world)`` keeps this host's slice of each full batch.
        ``workers`` and ``prefetch`` are taken for ``Dataset``'s signature:
        a sample is one ``.npy`` load.  ``quad`` is refused: the quad tiling
        does not apply to fixed-grid event frames (JAX asserts)."""
        if quad:
            raise ValueError("quad collate is not supported for event batches")
        del workers, prefetch
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        end = len(self) - (len(self) % batch_size) if drop_last else len(self)
        if end == 0:
            end = len(self)
        for i in range(0, end, batch_size):
            idxs = order[i : i + batch_size]
            if host_shard is not None:
                # per-host slice of the global batch (see Dataset.batches)
                rank, world = host_shard
                if len(idxs) < batch_size:
                    continue
                per = batch_size // world
                idxs = idxs[rank * per : (rank + 1) * per]
            ims, lbs, ms = zip(*(self[int(j)] for j in idxs))
            ims, lbs, ms = np.stack(ims), np.stack(lbs), np.stack(ms)
            if len(idxs) < batch_size and not drop_last:
                padn = batch_size - len(idxs)
                ims = np.concatenate(
                    [ims, np.zeros((padn,) + ims.shape[1:], ims.dtype)]
                )
                lbs = np.concatenate(
                    [lbs, np.zeros((padn,) + lbs.shape[1:], lbs.dtype)]
                )
                ms = np.concatenate(
                    [ms, np.zeros((padn,) + ms.shape[1:], ms.dtype)]
                )
            if yield_count:
                yield ims, lbs, ms, len(idxs)
            else:
                yield ims, lbs, ms
