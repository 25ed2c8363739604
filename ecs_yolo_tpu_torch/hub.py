"""Model-hub loading (counterpart of ``ecs_yolo_tpu/hub.py``; reference
hubconf.py:13-35 ``_create`` and models/experimental.py:87-127
``attempt_load`` / ``Ensemble``).

``create`` returns the built model with its weights (the JAX function
returns ``(model, variables)``): a checkpoint of this package
(``utils/checkpoint``, EMA parameters preferred) loads directly, any other
``.pt`` is read as a reference checkpoint through ``models/torch_import``.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Optional, Sequence, Union

import torch
from torch import nn

from .config import SNNConfig
from .models.yolo import build_model, checkpoint_imgsz


def _port_checkpoint(path: Path):
    """``(tree, meta)`` of a checkpoint of this package, or None for any
    other file."""
    from .utils.checkpoint import load_checkpoint

    try:
        return load_checkpoint(path)
    except (ValueError, pickle.UnpicklingError):    # a reference pickle
        return None


def create(cfg="resnet10.yaml", weights: Optional[str] = None, nc: Optional[int] = None,
           snn: Optional[SNNConfig] = None, use_ema: bool = True, seed: int = 0,
           autoshape: bool = False, names: Optional[Sequence[str]] = None,
           imgsz: int = 640, device: Optional[Union[str, torch.device]] = None):
    """Build ``cfg`` (a seeded init) on ``device`` (the card unless
    ``device="cpu"``) and load ``weights`` when given; a reference
    checkpoint's matched and missed names are kept in the model's
    ``import_report``.  With ``autoshape`` the model comes wrapped in
    :class:`~ecs_yolo_tpu_torch.autoshape.AutoShape` (reference
    hubconf.py:29), serving ``imgsz``."""
    from .utils.checkpoint import eval_state_dict

    gen = torch.Generator().manual_seed(seed)
    sd, build_sz = None, imgsz
    ckpt = _port_checkpoint(Path(weights)) if weights else None
    if ckpt is not None:
        tree, meta = ckpt
        sd = eval_state_dict(tree, use_ema)
        build_sz = checkpoint_imgsz(cfg, sd, meta, imgsz, nc, snn)
    model = build_model(cfg, nc=nc, snn=snn, device=device, generator=gen, imgsz=build_sz)
    if sd is not None:
        model.load_state_dict(sd, strict=True)
    elif weights:
        from .models.torch_import import import_state_dict, load_torch_checkpoint

        model.import_report = import_state_dict(load_torch_checkpoint(weights), model)
    if autoshape:
        from .autoshape import AutoShape

        return AutoShape(model, names=names, size=imgsz)
    return model


def attempt_load(weights, cfg, nc: Optional[int] = None, use_ema: bool = True,
                 snn: Optional[SNNConfig] = None, device=None):
    """One checkpoint, or an :class:`Ensemble` of several (reference
    models/experimental.py:87: EMA preferred, an ensemble for a list)."""
    if isinstance(weights, (list, tuple)) and len(weights) > 1:
        return Ensemble([create(cfg, w, nc=nc, snn=snn, use_ema=use_ema, device=device)
                         for w in weights])
    w = weights[0] if isinstance(weights, (list, tuple)) else weights
    return create(cfg, w, nc=nc, snn=snn, use_ema=use_ema, device=device)


class Ensemble(nn.Module):
    """Prediction ensemble: the members' decoded outputs concatenated along
    the candidate axis (reference Ensemble.forward, experimental.py:110-127,
    'nms ensemble': NMS then fuses the union)."""

    def __init__(self, members: Sequence[nn.Module]):
        super().__init__()
        assert members, "empty ensemble"
        self.members = nn.ModuleList(members)
        self.head_name = members[0].head_info["name"]
        self.head_info = members[0].head_info

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from .export import decoded

        outs = [decoded(self.head_name, m(x)) for m in self.members]
        return torch.cat(outs, dim=1 if self.head_name == "Detect" else 2)
