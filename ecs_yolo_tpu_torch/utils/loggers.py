"""Experiment loggers: CSV always, TensorBoard and W&B where their packages
import (counterpart of ``ecs_yolo_tpu/utils/loggers.py``).

``log_metrics`` fans one scalar dict out: a row of ``results.csv`` (header
from the sorted keys on first write), TensorBoard scalars, a W&B log.  The
trainer logs the reference's 13 fixed keys (``LOG_KEYS``) and ``fitness``.
ClearML and Comet are not ported.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict

from .general import LOGGER

LOG_KEYS = [
    "train/box_loss", "train/obj_loss", "train/cls_loss",
    "metrics/precision", "metrics/recall",
    "metrics/mAP_0.5", "metrics/mAP_0.5:0.95",
    "val/box_loss", "val/obj_loss", "val/cls_loss",
    "x/lr0", "x/lr1", "x/lr2",
]


class Loggers:
    def __init__(self, save_dir, include=("csv", "tb")):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.csv_path = self.save_dir / "results.csv"
        self.tb = None
        self.wandb = None
        if "tb" in include:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(str(self.save_dir))
            except ImportError as e:  # tensorboard is optional
                LOGGER.info(f"TensorBoard unavailable: {e}")
        if "wandb" in include:
            try:
                import wandb

                self.wandb = wandb.init(project="ecs_yolo_tpu_torch",
                                        dir=str(self.save_dir))
            except ImportError:
                LOGGER.info("W&B not installed; skipping")

    def log_metrics(self, metrics: Dict[str, float], step: int):
        """Fan out one scalar dict (on_fit_epoch_end)."""
        write_header = not self.csv_path.exists()
        keys = sorted(metrics)
        with open(self.csv_path, "a", newline="") as fh:
            w = csv.writer(fh)
            if write_header:
                w.writerow(["step", *keys])
            w.writerow([step, *(metrics[k] for k in keys)])
        if self.tb:
            for k, v in metrics.items():
                self.tb.add_scalar(k, v, step)
        if self.wandb:
            self.wandb.log(metrics, step=step)

    def close(self):
        if self.tb:
            self.tb.close()
        if self.wandb:
            self.wandb.finish()
