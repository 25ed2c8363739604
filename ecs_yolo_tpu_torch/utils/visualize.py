"""Spike maps and noise robustness (counterpart of
``ecs_yolo_tpu/utils/visualize.py``):

* ``spike_heatmap``         reference visi_img.py:27+: each neuron site's
  mean spike map over T and channels, overlaid on the input image (forward
  hooks where JAX captures the ``MemUpdate`` intermediates; the keys are
  JAX's, ``<module path>/__call__``);
* ``noise_sweep``           mAP@0.5 of the port's ``val.run`` under additive
  Gaussian input noise;
* ``plot_noise_robustness`` reference huatu.py:8-15, mAP@0.5 against the
  noise for LIF and ECS-LIF.

The JAX ``noise_sweep`` wraps its dataset in a class without ``meta`` whose
``batches`` yields three items, while ``val.run`` asks a dataset without
``meta`` for four (``yield_count``); the port's wrapper passes the
dataset's ``meta`` and every item of a batch through, so the sweep is
scored in native image space as a plain ``val.run`` is.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from ..nn.blocks import MemUpdate
from .plots import _plt


@torch.no_grad()
def spike_heatmap(model, image: np.ndarray, layer_filter: str = "",
                  save_path: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Mean spike maps ``[h, w]`` (over T, batch and channels) of every
    neuron site for ``image`` ``[H, W, 3]`` float in [0, 1], keyed
    ``{JAX module path}/__call__``; optionally a figure of them over the
    image."""
    from ..observe import jax_site_path

    model.eval()
    maps: Dict[str, np.ndarray] = {}

    def record(name):
        def hook(module, args, out):
            key = f"{jax_site_path(name, model.spec)}/__call__"
            if out.dim() == 5 and (not layer_filter or layer_filter in key):
                maps[key] = out.float().mean(dim=(0, 1, 4)).cpu().numpy()
        return hook

    hooks = [m.register_forward_hook(record(n)) for n, m in model.named_modules()
             if isinstance(m, MemUpdate)]
    try:
        p = next(model.parameters())
        model(torch.as_tensor(np.asarray(image, np.float32))[None].to(p.device))
    finally:
        for h in hooks:
            h.remove()

    if save_path and maps:
        plt = _plt()
        n = len(maps)
        cols = min(4, n)
        rows = (n + cols - 1) // cols
        fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows))
        axes = np.array(axes).reshape(-1)
        for ax, (k, m) in zip(axes, maps.items()):
            hm = np.asarray(Image.fromarray(
                (255 * (m - m.min()) / (np.ptp(m) + 1e-9)).astype(np.uint8)
            ).resize((image.shape[1], image.shape[0])))
            ax.imshow(image)
            ax.imshow(hm, alpha=0.5, cmap="jet")
            ax.set_title(k.split("/")[-2][:30], fontsize=7)
            ax.axis("off")
        for ax in axes[len(maps):]:
            ax.axis("off")
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return maps


class NoisyDataset:
    """``dataset`` whose batches carry additive Gaussian noise of ``sigma``
    (images to float in [0, 1] first), clipped to [0, 1]; the noise is drawn
    from a ``RandomState(seed)`` made anew each pass."""

    def __init__(self, dataset, sigma: float, seed: int = 0):
        self.ds, self.sigma, self.seed = dataset, sigma, seed
        if hasattr(dataset, "meta"):
            self.meta = dataset.meta

    def batches(self, *a, **k):
        rng = np.random.RandomState(self.seed)
        for ims, *rest in self.ds.batches(*a, **k):
            if ims.dtype == np.uint8:
                ims = ims.astype(np.float32) / 255.0
            noisy = np.clip(ims + rng.randn(*ims.shape).astype(np.float32) * self.sigma,
                            0.0, 1.0)
            yield (noisy, *rest)


def noise_sweep(model, dataset, noise_levels: Sequence[float] = (0.0, 0.05, 0.1, 0.2, 0.3),
                imgsz: int = 640, batch_size: int = 4, seed: int = 0) -> Dict[float, float]:
    """mAP@0.5 of ``model`` on ``dataset`` at each noise level (huatu.py's
    x-axis)."""
    from .. import val as val_mod

    return {sigma: val_mod.run(model, None, imgsz=imgsz, batch_size=batch_size,
                               dataset=NoisyDataset(dataset, sigma, seed))["map50"]
            for sigma in noise_levels}


def plot_noise_robustness(curves: Dict[str, Dict[float, float]],
                          save_path="noise_robustness.png"):
    """LIF vs ECS-LIF mAP@0.5 against the noise (reference huatu.py:8-15)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4), tight_layout=True)
    for label, curve in curves.items():
        xs = sorted(curve)
        ax.plot(xs, [curve[x] for x in xs], marker="o", label=label)
    ax.set_xlabel("noise intensity")
    ax.set_ylabel("mAP@0.5")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.savefig(save_path, dpi=200)
    plt.close(fig)
    return save_path
