"""Firing rates (counterpart of ``ecs_yolo_tpu/observe.py``; reference
g1-resnet/calculate_fr.py:234-256, firerate*.npy / size*.npy).

The JAX package sows the mean spike rate of every ECS-LIF ``MemUpdate``
with ``act=False`` into its ``spike_stats`` collection; here a forward hook
on those sites reads the same mean from the site's output, on whatever
route the site took (one fused kernel a site in eval on the card).  The
keys are JAX's: the site's flax module path, then ``firing_rate/<call>``
(``_flatten_sown`` of ``spike_stats``), so rates saved by either package
compare key for key.  ``jax_site_path`` maps a port module name onto that
path through the converter's table (``models/convert.py``).
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .models import convert as CV
from .nn.blocks import MemUpdate


def _block_path(block: str, parts) -> str:
    if parts and block in CV._NESTED and re.fullmatch(r"m\d+", parts[0]):
        return f"{parts[0]}/{_block_path(CV._NESTED[block], parts[1:])}"
    if block in CV._MODULES:
        inverse = {v: k for k, v in CV._MODULES[block].items()}
        return inverse[".".join(parts)]
    return "/".join(parts)


def jax_site_path(name: str, spec) -> str:
    """The JAX module path of the port module ``name`` (``model.{i}...``) in
    a model built from ``spec``: ``model.3.residual_function.0`` of a
    ``BasicBlock_2`` row -> ``layers_3/act1``; a repeated row's copy
    ``model.{i}.{j}`` -> ``layers_{i}/{j}``."""
    parts = name.split(".")
    if parts[0] != "model":
        raise ValueError(f"not a layer of a DetectionModel: {name!r}")
    i, rest = int(parts[1]), parts[2:]
    prefix = f"layers_{i}"
    if spec[i][1] > 1:
        prefix, rest = f"{prefix}/{rest[0]}", rest[1:]
    return f"{prefix}/{_block_path(spec[i][2], rest)}"


def rate_sites(model: nn.Module):
    """``(name, module)`` of the sites the JAX package sows a rate for:
    ECS-LIF ``MemUpdate`` with ``act=False``."""
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, MemUpdate) and m.snn.ecs and not m.act]


@contextlib.contextmanager
def _hooked(sites, record):
    hooks = [m.register_forward_hook(lambda m, i, o, n=n: record(n, o)) for n, m in sites]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


@torch.no_grad()
def forward_with_firing_rates(model: nn.Module, x: torch.Tensor
                              ) -> Tuple[object, Dict[str, float]]:
    """An eval forward of ``x`` and ``{JAX layer path: firing rate}`` in call
    order (a site called twice gives ``.../firing_rate/0`` and ``/1``)."""
    model.eval()
    calls: Dict[str, int] = {}
    means = []

    def record(name, spikes):
        k = calls.get(name, 0)
        calls[name] = k + 1
        means.append((f"{jax_site_path(name, model.spec)}/firing_rate/{k}",
                      spikes.float().mean()))

    with _hooked(rate_sites(model), record):
        out = model(x.to(next(model.parameters()).device))
    return out, {k: float(v) for k, v in means}


def calculate_fr(model: nn.Module, batches: Iterable, max_batches: Optional[int] = None,
                 save_prefix: Optional[str] = None) -> Dict[str, float]:
    """Per-layer firing rates averaged over ``batches`` (each ``(images,
    ...)``, images float in [0, 1] or uint8), as the JAX function; with
    ``save_prefix`` also ``{prefix}_firerate.npy`` / ``{prefix}_layers.npy``
    (the rates and their keys, keys sorted)."""
    acc: Dict[str, float] = {}
    n = 0
    for i, (ims, *_rest) in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        x = torch.as_tensor(np.asarray(ims))
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        _, rates = forward_with_firing_rates(model, x)
        for k, v in rates.items():
            acc[k] = acc.get(k, 0.0) + v
        n += 1
    rates = {k: v / max(n, 1) for k, v in acc.items()}
    if save_prefix:
        keys = sorted(rates)
        np.save(f"{save_prefix}_firerate.npy", np.array([rates[k] for k in keys]))
        np.save(f"{save_prefix}_layers.npy", np.array(keys))
    return rates
