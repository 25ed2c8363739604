"""Model export (counterpart of ``ecs_yolo_tpu/export.py``; reference
export.py / export2.py).

Format matrix:

| reference format | JAX package                   | here                                      |
|------------------|-------------------------------|-------------------------------------------|
| torchscript      | StableHLO text                | ``torch.jit.trace`` -> ``model.torchscript`` |
| (none)           | (none)                        | ``torch.export`` -> ``model.pt2``          |
| native           | orbax checkpoint              | ``utils/checkpoint`` file -> ``model.pt``  |
| TF SavedModel    | jax2tf -> tf.saved_model      | not ported: needs TensorFlow              |
| TFLite (+int8)   | jax2tf + TFLiteConverter      | not ported: needs TensorFlow              |
| ONNX             | gated on ``onnx``             | not ported: ``onnx`` is absent            |

Both graph formats record the model's eval forward with autograd off, so
every neuron site is one node of the port's kernel ops (``snn/ops.py``:
``ecs_yolo_torch::ecs_lif``, ``::ecs_lif_rows``, ``::lif``).  Loaded
back, the graph launches the same hand-written kernels as the eager model
on a CUDA tensor and takes their plain versions on a CPU tensor, so a
process that loads an artifact imports this package first (``backends.py``
does).  A graph is fixed-shape, ``batch`` x ``imgsz``, as the JAX export
is, and runs on the device and in the dtype it was recorded with: the
model's.

``run`` writes the JAX package's ``metadata.json`` beside the artifacts
(``head_name``, ``nc``, ``imgsz``, ``batch``, ``strides``, ``names``), which
``backends.DetectMultiBackend`` reads.
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .models.yolo import V10_HEADS


def export_formats() -> Dict[str, str]:
    """The formats ``run`` writes (JAX ``export_formats``)."""
    return {
        "torchscript": "TorchScript (torch.jit.trace), model.torchscript",
        "pt2": "torch.export ExportedProgram, model.pt2",
        "native": "checkpoint of this package (utils/checkpoint), model.pt",
    }


def decoded(head_name: str, out) -> torch.Tensor:
    """The decoded prediction of a head's eval output: the one2one branch's
    for the v10 heads, else the head's first output."""
    return out.one2one[0] if head_name in V10_HEADS else out[0]


class ExportForward(nn.Module):
    """What an artifact computes (JAX ``_forward_fn``): float32 images
    ``[B, H, W, 3]`` in [0, 1] -> the head's decoded prediction, the one2one
    branch's for the v10 heads, else the head's first output (the mask
    coefficients of the segment heads included)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model
        self.head_name = model.head_info["name"]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return decoded(self.head_name, self.model(images))


def _example(model: nn.Module, imgsz: int, batch: int) -> torch.Tensor:
    dev = next(model.parameters()).device
    return torch.zeros((batch, imgsz, imgsz, 3), dtype=torch.float32, device=dev)


def export_torchscript(model: nn.Module, path, imgsz: int = 640, batch: int = 1) -> Path:
    """``torch.jit.trace`` of the eval forward, saved with ``torch.jit.save``."""
    fwd = ExportForward(model).eval()
    with torch.no_grad(), warnings.catch_warnings():
        # shape arithmetic of the route checks is constant at a fixed shape
        warnings.simplefilter("ignore", torch.jit.TracerWarning)
        traced = torch.jit.trace(fwd, _example(model, imgsz, batch), check_trace=False)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.jit.save(traced, str(path))
    return path


def export_pt2(model: nn.Module, path, imgsz: int = 640, batch: int = 1) -> Path:
    """``torch.export.export`` of the eval forward, saved with
    ``torch.export.save``."""
    fwd = ExportForward(model).eval()
    with torch.no_grad():
        program = torch.export.export(fwd, (_example(model, imgsz, batch),))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, str(path))
    return path


def export_native(model: nn.Module, path, meta: Optional[Dict] = None) -> Path:
    """The model's ``state_dict`` as a checkpoint of this package (the JAX
    package's orbax row)."""
    from .utils.checkpoint import save_checkpoint

    return save_checkpoint(path, model.state_dict(), None, meta)


def metadata(model: nn.Module, imgsz: int, batch: int, names=None) -> Dict:
    """The ``metadata.json`` fields of JAX ``export.run``."""
    info = model.head_info
    return {"head_name": info["name"], "nc": int(info["nc"]), "imgsz": int(imgsz),
            "batch": int(batch), "strides": [float(s) for s in info["strides"]],
            "names": names}


def run(model: nn.Module, include: Sequence[str] = ("torchscript",),
        out_dir="runs/export", imgsz: int = 640, batch: int = 1,
        names=None) -> Dict[str, Path]:
    """Export ``model`` (built, weights loaded; on the device and in the
    dtype it is to serve in) to each format of ``include`` under
    ``out_dir``, with ``metadata.json`` beside them.  An unknown format
    raises ``KeyError`` naming the ones this package writes; the
    TensorFlow and ONNX formats of the JAX package are among them."""
    for fmt in include:
        if fmt not in export_formats():
            raise KeyError(f"unknown export format {fmt!r}; "
                           f"supported: {list(export_formats())}")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    meta = metadata(model, imgsz, batch, names)
    (out_dir / "metadata.json").write_text(json.dumps(meta, indent=1))
    was_training = model.training
    model.eval()
    results = {}
    try:
        for fmt in include:
            if fmt == "torchscript":
                results[fmt] = export_torchscript(model, out_dir / "model.torchscript",
                                                  imgsz, batch)
            elif fmt == "pt2":
                results[fmt] = export_pt2(model, out_dir / "model.pt2", imgsz, batch)
            else:
                results[fmt] = export_native(model, out_dir / "model.pt", meta)
    finally:
        model.train(was_training)
    return results
