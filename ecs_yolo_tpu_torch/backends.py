"""Format-dispatching inference backend (counterpart of
``ecs_yolo_tpu/backends.py``; reference ``DetectMultiBackend``,
models/common.py:2010+).

| weights                  | backend                                          |
|--------------------------|--------------------------------------------------|
| ``.torchscript``         | ``torch.jit.load``                               |
| ``.pt2``                 | ``torch.export.load(...).module()``              |
| any other (``.pt``)      | ``hub.create`` with the model YAML (``cfg``)     |

The graph artifacts carry the kernel ops of ``snn/ops.py``; importing this
module registers them (through ``hub`` -> ``models`` -> ``snn``), so a
process that loads an artifact through it runs the same kernels as the
eager model.  The TensorFlow formats of the JAX package (TFLite,
SavedModel) have no runtime here; ``export.py`` says why.  Artifacts carry
``metadata.json`` (``export.run``) beside them: head name, nc, names,
imgsz.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from .config import SNNConfig
from .device import resolve_device
from .models.yolo import SEGMENT_HEADS


def _load_metadata(path: Path) -> dict:
    for cand in (path.parent / "metadata.json", path / "metadata.json"):
        if cand.is_file():
            return json.loads(cand.read_text())
    return {}


class DetectMultiBackend:
    """Inference from a checkpoint of this package or an exported artifact.

    ``predict(images)`` takes float32 ``[B, H, W, 3]`` in [0, 1] (numpy or a
    tensor) and returns the head's decoded prediction as numpy float32, as
    the JAX backend does; ``forward(x)`` is the same on a tensor, returning
    the tensor on ``device`` in the model's dtype (what ``val`` and
    ``detect`` feed to NMS).  ``head_name`` / ``nc`` / ``names`` / ``imgsz``
    come from the metadata, or from the model for a checkpoint, which is
    built from ``cfg`` with ``snn`` (the default config when None).  A graph
    artifact serves the batch and size it was exported at, on the device
    it was exported on.  A TorchScript artifact runs with the JIT's fuser
    off, so that it gives the eager model's numbers bit for bit (its
    common-subexpression pass still runs a pure op once where two sites
    call it on the same arguments: the plain-LIF sites that share an
    input).
    """

    def __init__(self, weights, cfg: Optional[str] = None, nc: Optional[int] = None,
                 names=None, device: Optional[Union[str, torch.device]] = None,
                 snn: Optional[SNNConfig] = None):
        w = Path(weights)
        meta = _load_metadata(w)
        self.device = resolve_device(device)
        self.head_name = meta.get("head_name", "Detect")
        self.nc = nc or meta.get("nc")
        self.names = names or meta.get("names")
        self.imgsz = meta.get("imgsz")
        self.format = {".torchscript": "torchscript", ".pt2": "pt2"}.get(w.suffix, "native")
        if self.format == "torchscript":
            self.model = torch.jit.load(str(w), map_location=self.device)
        elif self.format == "pt2":
            self.model = torch.export.load(str(w)).module()
        else:
            from .export import ExportForward
            from .hub import create

            if cfg is None:
                raise ValueError("native checkpoints need the model cfg YAML")
            model = create(cfg, str(w), nc=self.nc, snn=snn, device=self.device)
            self.head_name, self.nc = model.head_info["name"], model.head_info["nc"]
            self.model = ExportForward(model).eval()

    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.format == "torchscript":
            # TorchScript's optimised runs fuse the elementwise chains (BN, casts)
            # into kernels that round otherwise than the eager operators; with
            # the fuser off the artifact computes what the eager model does
            with torch.jit.fuser("none"):
                return self.model(x.to(self.device))
        return self.model(x.to(self.device))

    def predict(self, images) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images, np.float32))
        return self.forward(x).float().cpu().numpy()

    __call__ = predict


def backend_predictions(backend: DetectMultiBackend, x: torch.Tensor) -> torch.Tensor:
    """What NMS takes from a backend: its prediction, of which only the
    ``4 + nc`` box and class rows for the segment heads (JAX ``val.py``)."""
    pred = backend.forward(x)
    if backend.head_name in SEGMENT_HEADS:
        pred = pred[:, :4 + backend.nc]
    return pred
