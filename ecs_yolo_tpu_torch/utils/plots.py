"""Plots (counterpart of ``ecs_yolo_tpu/utils/plots.py``; reference
utils/plots.py): ``plot_pr_curve`` (utils/metrics.py:387-425),
``plot_results`` (:401, the results.csv curves), ``plot_labels`` (class and
box statistics) and ``plot_evolve`` (the evolve.csv scatter).  Headless
matplotlib, imported at the first plot.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_pr_curve(px, py, ap, save_path="pr_curve.png", names=()):
    """Per-class PR curves + mean (reference utils/metrics.py:387)."""
    plt = _plt()
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    py = np.atleast_2d(py)
    for i, y in enumerate(py):
        label = f"{names[i]}" if i < len(names) else f"class {i}"
        ax.plot(px, y, linewidth=1, label=f"{label} {ap[i]:.3f}" if len(ap) > i else label)
    ax.plot(px, py.mean(0), linewidth=3, color="blue",
            label=f"all classes {np.mean(ap):.3f} mAP@0.5" if len(ap) else "all")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(loc="lower left", fontsize="small")
    fig.savefig(save_path, dpi=200)
    plt.close(fig)


def plot_results(csv_path, save_path: Optional[str] = None):
    """Training curves from results.csv (reference utils/plots.py:401)."""
    import csv as csv_mod

    csv_path = Path(csv_path)
    with open(csv_path) as fh:
        rows = list(csv_mod.reader(fh))
    header, data = rows[0], np.array(
        [[float(v) for v in r] for r in rows[1:]]
    )
    n = len(header) - 1
    plt = _plt()
    fig, axes = plt.subplots(2, (n + 1) // 2, figsize=(3 * n, 6), tight_layout=True)
    axes = np.array(axes).reshape(-1)
    for i, name in enumerate(header[1:]):
        axes[i].plot(data[:, 0], data[:, i + 1], marker=".")
        axes[i].set_title(name, fontsize=9)
    out = save_path or csv_path.with_name("results.png")
    fig.savefig(out, dpi=200)
    plt.close(fig)
    return out


def plot_labels(labels: np.ndarray, save_dir=".", names=()):
    """Class/box statistics histogram (reference utils/plots.py)."""
    c = labels[:, 0]
    boxes = labels[:, 1:5]
    plt = _plt()
    fig, axes = plt.subplots(1, 3, figsize=(12, 4), tight_layout=True)
    axes[0].hist(c, bins=max(int(c.max()) + 1, 1))
    axes[0].set_title("classes")
    axes[1].scatter(boxes[:, 0], boxes[:, 1], s=2, alpha=0.3)
    axes[1].set_title("xy centers")
    axes[2].scatter(boxes[:, 2], boxes[:, 3], s=2, alpha=0.3)
    axes[2].set_title("wh")
    out = Path(save_dir) / "labels.png"
    fig.savefig(out, dpi=200)
    plt.close(fig)
    return out


def plot_evolve(csv_path, save_path: Optional[str] = None):
    """Fitness-vs-hyp scatter matrix (reference plot_evolve)."""
    import csv as csv_mod

    csv_path = Path(csv_path)
    with open(csv_path) as fh:
        rows = list(csv_mod.reader(fh))
    header = rows[0]
    data = np.array([[float(v) if v else np.nan for v in r] for r in rows[1:]])
    fit = data[:, 0]
    n = len(header) - 1
    cols = 5
    rows_n = (n + cols - 1) // cols
    plt = _plt()
    fig, axes = plt.subplots(rows_n, cols, figsize=(3 * cols, 2.5 * rows_n),
                             tight_layout=True)
    axes = np.array(axes).reshape(-1)
    for i, name in enumerate(header[1:]):
        axes[i].scatter(data[:, i + 1], fit, s=6, alpha=0.6)
        axes[i].set_title(name, fontsize=8)
    out = save_path or csv_path.with_name("evolve.png")
    fig.savefig(out, dpi=200)
    plt.close(fig)
    return out
