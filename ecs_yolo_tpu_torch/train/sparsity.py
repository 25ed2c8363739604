"""Network-slimming sparsity and structured BN-gamma pruning (counterpart of
``ecs_yolo_tpu/train/sparsity.py``).

* ``bn_l1_grads``: the L1 subgradient of the reference's sparsity training
  (train_sparsity.py:570-581), ``srtmp * sign(gamma)`` on every
  spatio-temporal BN scale and ``10 * sr * sign(beta)`` on its bias, with
  ``srtmp = sr * (1 - 0.9 * epoch / epochs)``.  The train step applies the
  same term with the fraction taken from its step count
  (``train/trainer.make_train_step(sr=...)``).
* ``prune_by_bn_gamma``: a global magnitude threshold over the BN gammas
  (the reference's prune.py MagnitudePruner, p=1, ratio 0.5, the head
  ignored) applied as channel masks on the BN scales and biases.
* ``bn_gamma_sparsity``: the share of near-zero gammas.

Parameters are named as the port's modules name them: a BN's scale is
``....bn.weight`` and its bias ``....bn.bias`` (``nn/blocks._BN`` inside
``TBatchNorm``), where the JAX tree has ``.../bn/scale`` and ``.../bn/bias``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

#: torch spellings of the JAX function's head scopes (``m0``, ``w0``, ...),
#: whose BNs the pruning leaves alone
HEAD_SUBSTRINGS = (".m.0.", ".m.1.", ".w.0.", ".w.1.", ".cv2_", ".cv3_")


def is_bn_scale(name: str) -> bool:
    return name.endswith(".bn.weight")


def is_bn_bias(name: str) -> bool:
    return name.endswith(".bn.bias")


def sparsity_rate(sr: float, frac) -> torch.Tensor:
    """``srtmp = sr * (1 - 0.9 * clip(frac, 0, 1))``; ``frac`` a number or a
    0-d tensor (the result lies on its device)."""
    frac = frac if isinstance(frac, torch.Tensor) else torch.tensor(float(frac))
    return sr * (1.0 - 0.9 * frac.to(torch.float32).clamp(0.0, 1.0))


@torch.no_grad()
def add_l1_subgradient(grads: Dict[str, torch.Tensor],
                       params: Mapping[str, torch.Tensor], srtmp, sr: float
                       ) -> Dict[str, torch.Tensor]:
    """``grads`` with ``srtmp * sign(p)`` added on the BN scales and
    ``10 * sr * sign(p)`` on the BN biases (a new dict; the other entries
    are the same tensors)."""
    out = dict(grads)
    for k, g in grads.items():
        if is_bn_scale(k):
            out[k] = g + srtmp * torch.sign(params[k])
        elif is_bn_bias(k):
            out[k] = g + 10.0 * sr * torch.sign(params[k])
    return out


def bn_l1_grads(grads: Dict[str, torch.Tensor], params: Mapping[str, torch.Tensor],
                sr: float, epoch: int = 0, epochs: int = 300
                ) -> Dict[str, torch.Tensor]:
    """The reference's per-epoch form (train_sparsity.py:570-581)."""
    srtmp = sr * (1.0 - 0.9 * epoch / max(epochs, 1))
    return add_l1_subgradient(grads, params, srtmp, sr)


def collect_bn_gammas(params: Mapping[str, torch.Tensor]
                      ) -> List[Tuple[str, np.ndarray]]:
    """``(name, gamma)`` of every BN scale, gamma as a numpy array."""
    return [(k, v.detach().float().cpu().numpy()) for k, v in params.items()
            if is_bn_scale(k)]


def prune_by_bn_gamma(state: Mapping[str, torch.Tensor], ratio: float = 0.5,
                      ignore_substrings: Tuple[str, ...] = HEAD_SUBSTRINGS):
    """Zero the lowest-|gamma| ``ratio`` of the BN channels over the whole
    model (scale and bias), never a whole layer.  ``state`` is a
    ``state_dict`` (or the parameters alone); BNs whose name holds one of
    ``ignore_substrings`` are kept.  Returns ``(pruned copy, report)``."""
    eligible = [(k, g) for k, g in collect_bn_gammas(state)
                if not any(s in k for s in ignore_substrings)]
    if not eligible:
        return dict(state), {"pruned_channels": 0, "total_channels": 0}
    all_mags = np.concatenate([np.abs(g) for _, g in eligible])
    k = int(len(all_mags) * ratio)
    if k == 0:
        return dict(state), {"pruned_channels": 0, "total_channels": len(all_mags)}
    threshold = np.partition(all_mags, k)[k]
    masks: Dict[str, np.ndarray] = {}
    for name, g in eligible:
        keep = np.abs(g) >= threshold
        if keep.sum() == 0:         # never kill a whole layer
            keep[np.argmax(np.abs(g))] = True
        masks[name] = keep
    out = dict(state)
    for name, keep in masks.items():
        for leaf in (name, name[: -len("weight")] + "bias"):
            v = state[leaf]
            out[leaf] = v * torch.from_numpy(keep).to(v.device, v.dtype)
    pruned = int(sum((~m).sum() for m in masks.values()))
    total = int(sum(m.size for m in masks.values()))
    return out, {"pruned_channels": pruned, "total_channels": total,
                 "sparsity": pruned / max(total, 1), "threshold": float(threshold)}


def bn_gamma_sparsity(params: Mapping[str, torch.Tensor], eps: float = 1e-4) -> float:
    """Share of BN gammas with ``|gamma| < eps`` (the slimming's progress)."""
    gammas = collect_bn_gammas(params)
    if not gammas:
        return 0.0
    mags = np.concatenate([np.abs(g) for _, g in gammas])
    return float((mags < eps).mean())
