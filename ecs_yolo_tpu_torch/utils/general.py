"""General utilities: the logger, run directories, early stopping, the
callback bus, image-size and dataset checks (counterpart of
``ecs_yolo_tpu/utils/general.py``).

The JAX ``select_device`` pins the JAX platform; its place here is
``device.resolve_device``, which picks the CUDA card unless the caller asks
for the CPU.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable, Dict, List, Optional

LOGGER = logging.getLogger("ecs_yolo_tpu_torch")
if not LOGGER.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(message)s"))
    LOGGER.addHandler(_h)
    LOGGER.setLevel(logging.INFO)
    LOGGER.propagate = False  # no double lines when the root logger has a handler


def increment_path(path, exist_ok: bool = False, sep: str = "", mkdir: bool = False):
    """runs/exp -> runs/exp2, exp3, ... (reference utils/general.py)."""
    path = Path(path)
    if path.exists() and not exist_ok:
        suffix = path.suffix
        stem = path.with_suffix("")
        for n in range(2, 9999):
            p = Path(f"{stem}{sep}{n}{suffix}")
            if not p.exists():
                path = p
                break
    if mkdir:
        path.mkdir(parents=True, exist_ok=True)
    return path


class EarlyStopping:
    """Stop after ``patience`` epochs without a fitness improvement
    (reference utils/torch_utils.py:263)."""

    def __init__(self, patience: int = 100):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch: int, fitness: float) -> bool:
        if fitness >= self.best_fitness:
            self.best_epoch = epoch
            self.best_fitness = fitness
        stop = (epoch - self.best_epoch) >= self.patience
        if stop:
            LOGGER.info(
                f"EarlyStopping: no improvement in last {self.patience} epochs "
                f"(best epoch {self.best_epoch}). Stopping."
            )
        return stop


HOOK_NAMES = (
    "on_pretrain_routine_start", "on_pretrain_routine_end",
    "on_train_start", "on_train_epoch_start", "on_train_batch_start",
    "optimizer_step", "on_before_zero_grad", "on_train_batch_end",
    "on_train_epoch_end", "on_val_start", "on_val_batch_start",
    "on_val_image_end", "on_val_batch_end", "on_val_end",
    "on_fit_epoch_end", "on_model_save", "on_train_end",
    "on_params_update", "teardown",
)


class Callbacks:
    """Named hook bus (reference utils/callbacks.py:13-35)."""

    def __init__(self):
        self._callbacks: Dict[str, List[Callable]] = {k: [] for k in HOOK_NAMES}

    def register_action(self, hook: str, name: str = "", callback=None):
        if hook not in self._callbacks:
            raise KeyError(f"unknown hook {hook}")
        if not callable(callback):
            raise TypeError(f"callback {callback!r} is not callable")
        self._callbacks[hook].append(callback)

    def get_registered_actions(self, hook: Optional[str] = None):
        return self._callbacks[hook] if hook else self._callbacks

    def run(self, hook: str, *args, **kwargs):
        for cb in self._callbacks.get(hook, []):
            cb(*args, **kwargs)


def check_img_size(imgsz: int, stride: int = 32, floor: int = 0) -> int:
    """Round an image size to a stride multiple (reference check_img_size)."""
    new = max(int(round(imgsz / stride) * stride), floor or stride)
    if new != imgsz:
        LOGGER.info(f"img size {imgsz} adjusted to {new} (stride {stride})")
    return new


def check_dataset(data: dict) -> dict:
    """Validate a dataset yaml dict (reference check_dataset, without its
    download step); a ValueError names what is wrong (the JAX function
    asserts)."""
    for k in ("nc", "train"):
        if k not in data:
            raise ValueError(f"dataset yaml missing key {k!r}")
    names = data.get("names")
    if names is not None and len(names) != data["nc"]:
        raise ValueError(f"names ({len(names)}) != nc ({data['nc']})")
    root = Path(data.get("path", "."))
    for split in ("train", "val"):
        if split in data and not (root / data[split]).exists():
            LOGGER.info(f"dataset split missing on disk: {root / data[split]}")
    return data
