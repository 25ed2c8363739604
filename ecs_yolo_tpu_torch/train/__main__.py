"""Training CLI (counterpart of the JAX package's root ``train.py``)::

    python -m ecs_yolo_tpu_torch.train --cfg resnet10.yaml --data data.yaml \\
        --hyp hyp.yaml --epochs 300 --batch-size 8 --bf16 [--device cpu]

``--cfg`` takes any YAML the port builds: ``resnet10.yaml`` and
``resnet34.yaml`` (the v1 ``Detect`` head), the anchor-free
``res10v8.yaml``, ``res10v10.yaml``, ``res10-dual.yaml``,
``res10-triple.yaml``, ``res10-dualplain.yaml`` (the TAL, v10, dual and
triple losses) and ``res10-seg.yaml`` / ``res10-panoptic.yaml`` (the
segment and panoptic losses over YOLO-seg polygon labels; the panoptic
head also reads ``stuff/<stem>.txt`` polygons beside ``labels/``).
``--events`` trains from voxelized event samples (``data/gen1.yaml``: the
split lists ``data/events.build_dataset`` writes), T taken from the data::

    python -m ecs_yolo_tpu_torch.train --events --cfg resnet10.yaml \
        --data data/gen1.yaml --imgsz 320 --batch-size 8 --bf16

The flags are ``train.py``'s; the data and hyp YAMLs are read the same way
(``path``/``train``/``val``/``nc``; ``close_mosaic`` popped from the hyp).
``--device`` names a torch device and defaults to the CUDA card.
``--single-cls`` also reaches the datasets (see ``train/driver.py``).
``--evolve N`` runs the hyp GA of ``train/evolve.py`` for N generations,
one ``train()`` run each with val on (the train split where ``--noval``),
its fitness the run's best val fitness; the best hyps go to
``{project}/{name}/hyp_evolve.yaml``.

On several GPUs, one process each, launched by torchrun (its ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` join the
NCCL group; ``--batch-size`` is the global batch)::

    python -m torch.distributed.run --nproc_per_node=8 -m ecs_yolo_tpu_torch.train \
        --cfg resnet10.yaml --data data.yaml --batch-size 64 --bf16 [--model-parallel 2]

``--device cpu`` under torchrun makes a gloo group of CPU processes.
"""

from __future__ import annotations

import argparse
import os
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
    p.add_argument("--model-parallel", type=int, default=1,
                   help="ranks on the model axis: the weights, optimizer state and "
                        "EMA sharded over them")
    p.add_argument("--local-rank", "--local_rank", type=int, default=None,
                   help="this process's GPU (torchrun sets LOCAL_RANK)")
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
                   help="evolve the hyps for N generations (train/evolve.py)")
    p.add_argument("--events", action="store_true",
                   help="train from pre-voxelized event samples "
                        "(reference g1-resnet/train_g1.py)")
    p.add_argument("--noautoanchor", action="store_true")
    return p.parse_args(argv)


def main(opt):
    from ..parallel import multihost
    from ..utils.general import LOGGER
    from .driver import train

    if opt.local_rank is not None:
        os.environ.setdefault("LOCAL_RANK", str(opt.local_rank))
    device = opt.device
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        device = multihost.initialize(device=device)
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
    kwargs = dict(
        cfg=opt.cfg,
        train_path=str(train_path),
        val_path=str(val_path) if val_path else None,
        nc=1 if opt.single_cls else data["nc"],
        epochs=opt.epochs,
        batch_size=opt.batch_size,
        imgsz=opt.imgsz,
        optimizer=opt.optimizer,
        cos_lr=not opt.linear_lr,
        patience=opt.patience,
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
        device=device,
    )
    if opt.evolve:
        # the GA over the hyp space (reference train.py --evolve): the
        # fitness of a generation is its run's best val fitness
        from ..data.hyps import HYP_SCRATCH
        from .evolve import evolve

        if kwargs["val_path"] is None:
            kwargs["val_path"] = kwargs["train_path"]

        def train_fn(h):
            return train(hyp=h, save_dir=f"{opt.project}/{opt.name}/gen", **kwargs)[1]

        best = evolve(train_fn, {**HYP_SCRATCH, **hyp}, generations=opt.evolve,
                      save_dir=f"{opt.project}/{opt.name}", seed=opt.seed)
        with open(Path(opt.project) / opt.name / "hyp_evolve.yaml", "w") as fh:
            yaml.safe_dump(best, fh)
        return best
    return train(hyp=hyp, save_dir=f"{opt.project}/{opt.name}", **kwargs)


if __name__ == "__main__":
    main(parse_opt())
