"""General utilities: the logger, device selection, run directories, timers,
early stopping, the callback bus, image-size and dataset checks, ANSI colours
(counterpart of ``ecs_yolo_tpu/utils/general.py``).

``select_device`` is a thin layer over ``device.resolve_device``: the empty
string means the CUDA card and raises without one; the port never falls back
to the CPU unless the caller asks for it.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

LOGGER = logging.getLogger("ecs_yolo_tpu_torch")
if not LOGGER.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(message)s"))
    LOGGER.addHandler(_h)
    LOGGER.setLevel(logging.INFO)
    LOGGER.propagate = False  # no double lines when the root logger has a handler


def select_device(device: str = "") -> List:
    """The devices a CLI run uses (reference utils/torch_utils.py:110
    ``select_device``, the ``--device`` flag); logs ``devices: Nx <type>``
    as the JAX function does.

    ``""`` means every CUDA card (JAX's ``""`` keeps the ambient platform)
    and raises without one; ``"cpu"`` means the CPU; ``"0"`` or ``"cuda:0"``
    names a card.
    """
    import torch

    from ..device import resolve_device

    spec = str(device).strip().lower()
    if not spec:
        resolve_device(None)                    # raises without a card
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(f"cuda:{spec}" if spec.isdigit() else spec)]
    LOGGER.info(f"devices: {len(devs)}x {devs[0].type}")
    return devs


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


class Profile:
    """Accumulating host wall-clock timer usable as a context manager
    (reference utils/general.py:65): ``dt`` the last block's seconds, ``t``
    their sum.  CUDA work runs after the host enqueues it, so a caller that
    times the card calls ``torch.cuda.synchronize()`` inside the block."""

    def __init__(self):
        self.t = 0.0
        self.dt = 0.0

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.dt = time.perf_counter() - self._start
        self.t += self.dt


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


class Timeout:
    """Timeout context manager (reference utils/general.py:74) by SIGALRM:
    a ``TimeoutError`` after ``seconds`` whole seconds, swallowed on exit with
    ``suppress``.  A no-op where the alarm cannot be set: off the main
    thread, or on a platform without SIGALRM."""

    def __init__(self, seconds: float, timeout_msg: str = "", suppress: bool = True):
        self.seconds = int(seconds)
        self.msg = timeout_msg
        self.suppress = suppress

    def _handler(self, signum, frame):
        raise TimeoutError(self.msg)

    def __enter__(self):
        import signal

        try:
            signal.signal(signal.SIGALRM, self._handler)
            signal.alarm(self.seconds)
        except (ValueError, AttributeError):    # not the main thread; no SIGALRM
            pass
        return self

    def __exit__(self, exc_type, exc, tb):
        import signal

        try:
            signal.alarm(0)
        except (ValueError, AttributeError):
            pass
        return self.suppress and exc_type is TimeoutError


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


_COLORS = {
    "black": "\033[30m", "red": "\033[31m", "green": "\033[32m",
    "yellow": "\033[33m", "blue": "\033[34m", "magenta": "\033[35m",
    "cyan": "\033[36m", "white": "\033[37m", "bold": "\033[1m",
    "end": "\033[0m",
}


def colorstr(*args) -> str:
    """ANSI colour helper (reference utils/general.py): ``colorstr("blue",
    "bold", "x")``; one argument is bold.  Unknown names add nothing."""
    *prefix, string = args if len(args) > 1 else ("bold", args[0])
    return "".join(_COLORS.get(p, "") for p in prefix) + str(string) + _COLORS["end"]
