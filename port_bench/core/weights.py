"""Seeded weights of a configuration, made on the card in one draw, and the
program and the reference built to the configuration.

The names and shapes are the reference model's (``reference/model.py``),
which are also the program's; ``make`` hands the same tensors to both.
Every parameter comes from one uniform draw of a ``torch.Generator`` on the
card, cut into the leaves and scaled: a convolution's weight and bias to
``+-1/sqrt(fan_in)`` (PyTorch's default range), each BN scale to the
published init (``thresh``, and ``0.2 * thresh`` for the second BN of a
residual), BN shifts 0, running statistics mean 0 and variance 1.  The same
seed gives the same tensors.

A served model's head (``head``, the configuration's ``served_head`` with
its calibrated objectness bias, see ``traffic/serve``) is shaped as a
trained head is: its collapse over T the mean (``collapse: mean``), its 1x1
weights scaled by ``head_gain`` so that the scores spread, its objectness
biases shifted by ``obj_bias``.  A training run starts from the plain init.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..reference.model import RefDetector


def _gamma(name: str, thresh: float) -> float:
    return 0.2 * thresh if ".residual_function.5.bn." in name else thresh


def reference(config: Dict, device=None) -> RefDetector:
    """The plain reference of ``config``, its parameters not yet set."""
    if device is not None and torch.device(device).type == "meta":
        with torch.device("meta"):
            return RefDetector(config["model"], config["T"], config["neuron"])
    return RefDetector(config["model"], config["T"], config["neuron"]).to(device)


def make(config: Dict, seed: int, device, head: Dict = None) -> Dict[str, torch.Tensor]:
    """float32 state dict of ``config["model"]`` at ``config["T"]`` steps;
    ``head`` shapes a served head, see the module's text."""
    ref = reference(config, "meta")
    shapes = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    params = [k for k, _ in ref.named_parameters()]
    total = sum(math.prod(shapes[k]) for k in params)
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(total, generator=g, device=device).mul_(2).sub_(1)
    out, at = {}, 0
    weights = {k.rsplit(".", 1)[0]: shapes[k] for k in params if k.endswith("weight")}
    thresh = ref.nrn.thresh
    for k in params:
        n = math.prod(shapes[k])
        v = flat[at:at + n].view(shapes[k])
        at += n
        owner = k.rsplit(".", 1)[0]
        if owner.endswith(".bn"):
            v = (torch.full_like(v, _gamma(k, thresh)) if k.endswith("weight")
                 else torch.zeros_like(v))
        else:
            w = weights[owner]
            v = v / math.sqrt(math.prod(w[1:]))
        out[k] = v
    for k, shape in shapes.items():
        if k.endswith("running_mean"):
            out[k] = torch.zeros(shape, device=device)
        elif k.endswith("running_var"):
            out[k] = torch.ones(shape, device=device)
    if head:
        det = ref.model[-1]
        last = len(ref.model) - 1
        for i in range(len(det.m)):
            if head.get("collapse") == "mean":
                out[f"model.{last}.w.{i}.conv.weight"].fill_(1.0 / config["T"])
            key = f"model.{last}.m.{i}"
            out[f"{key}.weight"] = out[f"{key}.weight"] * head.get("head_gain", 1.0)
            out[f"{key}.bias"].view(det.na, det.no)[:, 4] += head.get("obj_bias", 0.0)
    return {k: out[k] for k in shapes}


def program(config: Dict, size: int, device, state: Dict[str, torch.Tensor]):
    """The program's ``DetectionModel`` of ``config`` with its neuron, built
    for ``size`` px, holding ``state``."""
    from ecs_yolo_tpu_torch.config import DEFAULT_SNN
    from ecs_yolo_tpu_torch.models.yolo import build_model

    nrn = reference(config, "meta").nrn
    snn = DEFAULT_SNN.replace(time_window=config["T"], ecs=True, thresh=nrn.thresh,
                              lens=nrn.lens, decay=nrn.decay, alpha=nrn.alpha,
                              beta=nrn.beta, ecs_tau=nrn.ecs_tau)
    model = build_model(config["model"], nc=config["nc"], snn=snn, device="meta", imgsz=size)
    model.to_empty(device=device)
    model.load_state_dict(state)
    return model
