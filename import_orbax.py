"""Import a checkpoint of the JAX package into the PyTorch port's format.

    python import_orbax.py runs/train/exp/weights/best out.pt [--cfg res10v8.yaml]

Reads a directory written by ``ecs_yolo_tpu/utils/checkpoint.py``
(``save_checkpoint`` or ``strip_optimizer``): its orbax ``tree/`` of
``params``, ``batch_stats`` and, in a training checkpoint, ``ema_params``,
and its ``meta.json`` with ``model_cfg``, ``epoch`` and ``best_fitness``.  The
port's layer spec comes from ``model_cfg`` (or ``--cfg`` where the meta has
none) through the port's own ``parse_model``; the trees cross through
``ecs_yolo_tpu_torch/models/convert.convert``, which raises on any leaf it
cannot place.  One file is written with the port's
``utils/checkpoint.save_checkpoint``: ``model`` (the parameters and the BN
statistics), ``ema`` (the EMA parameters, where the directory has them) and
``meta`` (``epoch``, ``best_fitness``, ``model_cfg``, ``imported_from``).

The JAX optimizer state (``opt_state``, optax's trees) is not carried
across, and the file holds no ``opt_state``: it loads in the port's
``detect`` and ``val`` (``load_checkpoint`` + ``eval_state_dict``), and it is
not a point to resume training from, as a ``strip_optimizer`` file is not.

This script lives outside the port's package because it imports ``orbax``
(and with it JAX); the package imports neither.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import numpy as np


def read_orbax(src) -> tuple:
    """``(tree, meta)`` of a JAX checkpoint directory, leaves as numpy."""
    import orbax.checkpoint as ocp

    src = Path(src).resolve()
    with ocp.PyTreeCheckpointer() as ckptr:
        tree = ckptr.restore(src / "tree")
    meta_path = src / "meta.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return tree, meta


def import_checkpoint(src, dst, cfg: Optional[str] = None) -> Path:
    """Convert the JAX checkpoint directory ``src`` into the port file
    ``dst``; ``cfg`` (a YAML path or name) stands in for a missing
    ``model_cfg``.  Returns ``dst``."""
    from ecs_yolo_tpu_torch.models.convert import convert
    from ecs_yolo_tpu_torch.models.yolo import load_cfg, parse_model
    from ecs_yolo_tpu_torch.utils.checkpoint import save_checkpoint

    tree, meta = read_orbax(src)
    model_cfg = meta.get("model_cfg") or (load_cfg(cfg) if cfg else None)
    if not isinstance(model_cfg, dict):
        raise ValueError(f"{src}: meta.json has no model_cfg; pass --cfg")
    spec = parse_model(model_cfg, 3)[0]
    host = lambda t: {k: host(v) if isinstance(v, dict) else np.asarray(v)
                      for k, v in t.items()}
    model = convert(host(tree["params"]), host(tree.get("batch_stats") or {}), spec)
    ema = None
    if tree.get("ema_params") is not None:
        ema = convert(host(tree["ema_params"]), None, spec)
    return save_checkpoint(dst, model, ema, {
        "epoch": meta.get("epoch", -1),
        "best_fitness": float(meta.get("best_fitness", 0.0)),
        "model_cfg": model_cfg,
        "imported_from": str(Path(src).resolve()),
    })


def main(argv=None) -> Path:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="checkpoint directory written by the JAX package")
    p.add_argument("dst", help="the port's checkpoint file to write")
    p.add_argument("--cfg", default=None,
                   help="model yaml, where the directory's meta.json has no model_cfg")
    opt = p.parse_args(argv)
    out = import_checkpoint(opt.src, opt.dst, opt.cfg)
    print(f"{opt.src} -> {out} (no optimizer state: not a resume point)")
    return out


if __name__ == "__main__":
    main()
