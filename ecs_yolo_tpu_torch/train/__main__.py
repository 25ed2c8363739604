"""Training CLI (counterpart of the JAX package's root ``train.py``)::

    python -m ecs_yolo_tpu_torch.train --cfg resnet10.yaml --data data.yaml \\
        --hyp hyp.yaml --epochs 300 --batch-size 8 --bf16 [--device cpu]

``--cfg`` takes any YAML the port builds: ``resnet10.yaml`` and
``resnet34.yaml`` (the v1 ``Detect`` head) and the anchor-free
``res10v8.yaml``, ``res10v10.yaml``, ``res10-dual.yaml``,
``res10-triple.yaml``, ``res10-dualplain.yaml`` (the TAL, v10, dual and
triple losses).  The flags are ``train.py``'s; the data and hyp YAMLs are read the same way
(``path``/``train``/``val``/``nc``; ``close_mosaic`` popped from the hyp).
``--device`` names a torch device and defaults to the CUDA card.
``--single-cls`` also reaches the datasets (see ``train/driver.py``).  Flags
of features not ported yet (``--events``, ``--evolve``, ``--model-parallel``)
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import yaml


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cfg", default="resnet10.yaml", help="model yaml")
    p.add_argument("--data", default="data/kitti.yaml", help="dataset yaml")
    p.add_argument("--hyp", default="data/hyps/hyp.scratch.yaml")
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--optimizer", default="SGD",
                   choices=["SGD", "Adam", "AdamW", "Lion"])
    p.add_argument("--linear-lr", action="store_true", help="linear LR (default one-cycle)")
    p.add_argument("--patience", type=int, default=100)
    p.add_argument("--project", default="runs/train")
    p.add_argument("--name", default="exp")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-labels", type=int, default=300)
    p.add_argument("--save-period", type=int, default=-1)
    p.add_argument("--noval", action="store_true")
    p.add_argument("--single-cls", action="store_true")
    p.add_argument("--remat", action="store_true",
                   help="recompute every layer's activations in the backward pass")
    p.add_argument("--remat-neuron", action="store_true",
                   help="recompute only the neuron recurrences in the backward pass")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute with float32 master parameters and "
                        "BN statistics")
    p.add_argument("--workers", type=int, default=4,
                   help="loader threads (0 = synchronous)")
    p.add_argument("--quad", action="store_true",
                   help="quad collate: every 4 samples tiled into one 2x canvas")
    p.add_argument("--cache", choices=["ram", "disk"], default=None,
                   help="cache decoded + resized images")
    p.add_argument("--device-augment", action="store_true",
                   help="mosaic, scale/translate, HSV and flips on the card; the "
                        "host only decodes and letterboxes")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="move K batches to the card in one copy and issue their "
                        "K steps back to back")
    p.add_argument("--model-parallel", type=int, default=1, help="not ported yet (> 1)")
    p.add_argument("--multi-scale", action="store_true",
                   help="vary the train image size 0.5-1.5x per epoch")
    p.add_argument("--image-weights", action="store_true",
                   help="class-aware image resampling")
    p.add_argument("--resume", default=None,
                   help="checkpoint file to resume from (weights/last.pt)")
    p.add_argument("--sr", type=float, default=0.0,
                   help="BN-L1 sparsity rate (network slimming; 0 disables)")
    p.add_argument("--nbs", type=int, default=64,
                   help="nominal batch size for gradient accumulation")
    p.add_argument("--device", default=None,
                   help="torch device; the CUDA card when omitted")
    p.add_argument("--evolve", type=int, nargs="?", const=300, default=0,
                   help="not ported yet")
    p.add_argument("--events", action="store_true", help="not ported yet")
    p.add_argument("--noautoanchor", action="store_true")
    return p.parse_args(argv)


def main(opt):
    from ..utils.general import LOGGER
    from .driver import train

    if opt.evolve:
        raise NotImplementedError("--evolve (train/evolve.py) is not ported yet "
                                  "(ROADMAP Queue 1 item 13)")
    with open(opt.data) as fh:
        data = yaml.safe_load(fh)
    root = Path(data.get("path", "."))
    train_path = root / data["train"]
    val_path = None if opt.noval else root / data.get("val", data["train"])
    hyp = {}
    if opt.hyp and Path(opt.hyp).exists():
        with open(opt.hyp) as fh:
            hyp = yaml.safe_load(fh)
    close_mosaic = int(hyp.pop("close_mosaic", 0)) if hyp else 0
    LOGGER.info(f"train: cfg={opt.cfg} data={opt.data} nc={data['nc']}")
    return train(
        cfg=opt.cfg,
        train_path=str(train_path),
        val_path=str(val_path) if val_path else None,
        nc=1 if opt.single_cls else data["nc"],
        hyp=hyp,
        epochs=opt.epochs,
        batch_size=opt.batch_size,
        imgsz=opt.imgsz,
        optimizer=opt.optimizer,
        cos_lr=not opt.linear_lr,
        patience=opt.patience,
        save_dir=f"{opt.project}/{opt.name}",
        max_labels=opt.max_labels,
        close_mosaic=close_mosaic,
        seed=opt.seed,
        save_period=opt.save_period,
        remat=opt.remat,
        remat_neuron=opt.remat_neuron,
        bf16=opt.bf16,
        model_parallel=opt.model_parallel,
        quad=opt.quad,
        workers=opt.workers,
        multi_scale=opt.multi_scale,
        image_weights=opt.image_weights,
        resume=opt.resume,
        sr=opt.sr,
        nbs=opt.nbs,
        events=opt.events,
        autoanchor=not opt.noautoanchor,
        cache=opt.cache,
        device_augment=opt.device_augment,
        steps_per_call=opt.steps_per_call,
        single_cls=opt.single_cls,
        device=opt.device,
    )


if __name__ == "__main__":
    main(parse_opt())
