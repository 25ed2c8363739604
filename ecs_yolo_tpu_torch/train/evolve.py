"""Hyper-parameter evolution, a genetic algorithm (counterpart of
``ecs_yolo_tpu/train/evolve.py``; reference train.py:797, meta-bounds table
train.py:949): each generation picks a parent from the top 5 by fitness,
mutates about 80 % of the hyps with sigma 0.2 under per-hyp (gain, min,
max) bounds, trains, and appends to ``evolve.csv``.

The draws are the JAX function's, from explicit generators: the mutation's
from a ``random.Random``, the parent's from an ``np.random.RandomState``
where the JAX ``mutate`` draws it with the global ``np.random.choice``.  So
seeding JAX's global numpy state and this ``RandomState`` with one seed
gives the same parent.
"""

from __future__ import annotations

import csv
import random
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..utils.general import LOGGER

# (mutation gain, min, max) per hyp — reference train.py:949 meta table
META: Dict[str, Tuple[float, float, float]] = {
    "lr0": (1, 1e-5, 0.1),
    "lrf": (1, 0.01, 1.0),
    "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1, 0.0, 0.001),
    "warmup_epochs": (1, 0.0, 5.0),
    "warmup_momentum": (1, 0.0, 0.95),
    "warmup_bias_lr": (1, 0.0, 0.2),
    "box": (1, 0.02, 0.2),
    "cls": (1, 0.2, 4.0),
    "cls_pw": (1, 0.5, 2.0),
    "obj": (1, 0.2, 4.0),
    "obj_pw": (1, 0.5, 2.0),
    "iou_t": (0, 0.1, 0.7),
    "anchor_t": (1, 2.0, 8.0),
    "fl_gamma": (0, 0.0, 2.0),
    "hsv_h": (1, 0.0, 0.1),
    "hsv_s": (1, 0.0, 0.9),
    "hsv_v": (1, 0.0, 0.9),
    "degrees": (1, 0.0, 45.0),
    "translate": (1, 0.0, 0.9),
    "scale": (1, 0.0, 0.9),
    "shear": (1, 0.0, 10.0),
    "perspective": (0, 0.0, 0.001),
    "flipud": (1, 0.0, 1.0),
    "fliplr": (0, 0.0, 1.0),
    "mosaic": (1, 0.0, 1.0),
    "mixup": (1, 0.0, 1.0),
    "copy_paste": (1, 0.0, 1.0),
}


def mutate(hyp: Dict[str, float], history: List[Tuple[float, Dict[str, float]]],
           rng: Optional[random.Random] = None, mp: float = 0.8, sigma: float = 0.2,
           parent_rng: Optional[np.random.RandomState] = None) -> Dict[str, float]:
    """One GA mutation step (reference train.py evolve block): with a
    history, the parent is drawn from its top 5 with weights their fitness
    (``parent_rng``), then every evolvable hyp mutates with probability
    ``mp`` (``rng``), until at least one has."""
    rng = rng or random.Random()
    keys = [k for k in hyp if k in META and META[k][0] > 0]
    if history:
        parent_rng = parent_rng or np.random.RandomState()
        top = sorted(history, key=lambda t: -t[0])[:5]
        weights = np.array([max(t[0], 1e-6) for t in top])
        parent = top[int(parent_rng.choice(len(top), p=weights / weights.sum()))][1]
        hyp = dict(parent)
    out = dict(hyp)
    while True:
        changed = False
        for k in keys:
            if rng.random() < mp:
                gain = META[k][0]
                v = out[k] * (1 + rng.gauss(0, 1) * sigma * gain)
                out[k] = float(np.clip(v, META[k][1], META[k][2]))
                changed = True
        if changed:
            return out


def evolve(train_fn: Callable[[Dict[str, float]], float], base_hyp: Dict[str, float],
           generations: int = 300, save_dir="runs/evolve", seed: int = 0) -> Dict[str, float]:
    """Run the GA: ``train_fn(hyp) -> fitness`` once a generation (the
    first on ``base_hyp`` itself).  Rows append to ``save_dir/evolve.csv``;
    returns the best hyp dict."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    csv_path = save_dir / "evolve.csv"
    rng, parent_rng = random.Random(seed), np.random.RandomState(seed)
    history: List[Tuple[float, Dict[str, float]]] = []
    keys = sorted(k for k in base_hyp if k in META)
    for gen in range(generations):
        hyp = mutate(base_hyp, history, rng, parent_rng=parent_rng) if gen else dict(base_hyp)
        fit = float(train_fn(hyp))
        history.append((fit, hyp))
        write_header = not csv_path.exists()
        with open(csv_path, "a", newline="") as fh:
            w = csv.writer(fh)
            if write_header:
                w.writerow(["fitness", *keys])
            w.writerow([fit, *(hyp.get(k, "") for k in keys)])
        LOGGER.info(f"evolve gen {gen}: fitness={fit:.5f}")
    best = max(history, key=lambda t: t[0])
    LOGGER.info(f"evolve done: best fitness {best[0]:.5f}")
    return best[1]
