"""The training loop (counterpart of ``ecs_yolo_tpu/train/driver.py``;
reference train.py:73-760), for a v1 ``Detect`` head on one device.

Epochs of augmented batches (mosaic, perspective, HSV, flips, mixup) from a
thread-pool loader, every batch a micro-step of ``train/trainer``'s step
(the training-mode forward runs the spread kernels on the card), the
optimizer applying every ``accumulate`` micro-steps with the EMA beside it;
after each epoch a val pass (``val.run``) on an eval copy of the model with
the EMA parameters loaded, the reference's 13 log keys with ``fitness``, and
the best/last/periodic checkpoints; ``EarlyStopping``; ``resume``; the best
checkpoint stripped of its optimizer at the end.

Host and device: a batch goes to the device as uint8 from pinned memory and
is divided there; the step's metrics stay on the device, and the loop reads
them once an epoch, so the host never waits for the device inside an epoch.

Deviations from the JAX driver:

* ``single_cls`` reaches the datasets (the labels' classes become 0).  The
  JAX CLI turns ``--single-cls`` into ``nc=1`` only, and its driver builds
  the datasets without it, so multi-class labels index past ``nc``.
* The anchors autoanchor chose are kept in the checkpoint's ``meta`` and a
  resumed run builds its model with them; the JAX driver skips autoanchor on
  resume and builds the model with the YAML's anchors.
* ``close_mosaic`` holds from its epoch on (``>=``), so a run resumed after
  that epoch trains without mosaic too; the JAX driver switches it off at
  the one epoch (``==``).
* The ``x/lr*`` log keys read the optimizer's own schedules at ``step //
  accumulate``.  The JAX driver evaluates a copy whose warm-up floor is
  ``100 / accumulate``, where the optimizer it built uses ``1000 /
  accumulate`` for ``Detect``.
* Each sample's augmentation is drawn from ``(seed, epoch, index)``
  (``data/dataset.Dataset.sample_rng``).

Not ported (each raises ``NotImplementedError`` naming its ROADMAP Queue 1
item): ``events`` (10), segment heads (11), other heads (9),
``model_parallel > 1`` and multi-host (12), ``steps_per_call > 1`` (8, a
CUDA graph of the step on the GPU), ``remat``, ``remat_neuron``, ``sr`` and
Lion (8), ``device_augment`` and ``quad`` (7).
"""

from __future__ import annotations

import copy
import time
from datetime import datetime, timezone
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from .. import val as val_mod
from ..config import SNNConfig
from ..data.dataset import Dataset
from ..data.hyps import HYP_SCRATCH
from ..device import resolve_device
from ..models.yolo import build_model, load_cfg, parse_model
from ..utils.checkpoint import load_checkpoint, save_checkpoint, strip_optimizer
from ..utils.general import LOGGER, Callbacks, EarlyStopping, increment_path
from ..utils.loggers import Loggers
from .optim import build_optimizer
from .trainer import create_train_state, make_train_step


def _unported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 {item})")


def _check_ported(cfg, head: str, events, sr, remat, remat_neuron, model_parallel,
                  quad, device_augment, steps_per_call, optimizer) -> None:
    if events:
        _unported("event mode (events=True)", "item 10")
    if head in ("Segment", "Panoptic"):
        _unported(f"the {head} head", "item 11")
    if head != "Detect":
        _unported(f"training the {head} head of {cfg}", "item 9")
    if model_parallel > 1 or (torch.distributed.is_available()
                              and torch.distributed.is_initialized()):
        _unported("model_parallel > 1 and multi-host training", "item 12")
    if steps_per_call > 1:
        _unported("steps_per_call > 1 (a CUDA graph of the step)", "item 8")
    if remat or remat_neuron:
        _unported("remat / remat_neuron", "item 8")
    if sr > 0:
        _unported("the sr BN-L1 sparsity term", "item 8")
    if str(optimizer).lower() == "lion":
        _unported("the Lion optimizer", "item 8")
    if device_augment:
        _unported("device_augment", "item 7")
    if quad:
        _unported("the quad collate", "item 7")


def _autoanchor(d: Dict, train_ds: Dataset, imgsz: int, thr: float):
    """New anchors (pixels, per level) when the best possible recall of the
    YAML's is below 0.98 and k-means finds better ones, else None
    (reference train.py:239)."""
    from ..utils.autoanchor import check_anchors

    _, _, _, head_info = parse_model(d, 3)
    anchors_px = np.array(head_info["anchors_px"], np.float64)
    shapes = np.full((len(train_ds), 2), imgsz, np.float64)
    new_a, changed = check_anchors(train_ds.labels, shapes, anchors_px, thr=thr,
                                   imgsz=imgsz)
    if not changed:
        return None
    return [[float(v) for v in level]
            for level in np.asarray(new_a).reshape(anchors_px.shape)]


def _image_weights(train_ds: Dataset, nc: int, history, rng_seed: int) -> None:
    """Class-aware resampling of ``train_ds.indices`` (reference train.py
    image_weights): images of classes with a low mAP@0.5 come more often."""
    cw = np.ones(nc)
    if history and history[-1].get("per_class"):
        for c, (_, _, a5, _) in history[-1]["per_class"].items():
            cw[int(c)] = (1 - a5) ** 2
    iw = np.array([cw[lb[:, 0].astype(int)].sum() if len(lb) else 0.1
                   for lb in train_ds.labels])
    train_ds.indices = np.random.RandomState(rng_seed).choice(
        train_ds.n, size=train_ds.n, p=iw / iw.sum())


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(a)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def train(
    cfg: Union[str, Path, Dict] = "resnet10.yaml",
    train_path=None,
    val_path=None,
    nc: Optional[int] = None,
    hyp: Optional[Dict] = None,
    epochs: int = 300,
    batch_size: int = 8,
    imgsz: int = 640,
    optimizer: str = "SGD",
    cos_lr: bool = True,
    nbs: int = 64,
    ema_decay: float = 0.9999,
    patience: int = 100,
    save_dir: str = "runs/train/exp",
    max_labels: int = 300,
    close_mosaic: int = 0,
    val_every: int = 1,
    seed: int = 0,
    callbacks: Optional[Callbacks] = None,
    save_period: int = -1,
    multi_scale: bool = False,
    sr: float = 0.0,
    resume: Optional[Union[str, Path]] = None,
    image_weights: bool = False,
    remat: bool = False,
    events: bool = False,
    autoanchor: bool = True,
    loggers_include=("csv", "tb"),
    workers: int = 4,
    bf16: bool = False,
    remat_neuron: bool = False,
    model_parallel: int = 1,
    quad: bool = False,
    cache: Optional[str] = None,
    device_augment: bool = False,
    steps_per_call: int = 1,
    single_cls: bool = False,
    snn: Optional[SNNConfig] = None,
    device: Optional[Union[str, torch.device]] = None,
):
    """Train; returns ``(state, best_fitness, history)``.

    ``history`` holds one dict an epoch: the val results (``mp``, ``mr``,
    ``map50``, ``map``, ``fitness``, ``per_class``, ...), ``epoch``, the
    mean losses ``mloss``, ``loss_finite`` (every micro-step's loss),
    ``micro_steps``, ``applies`` (windows closed) and ``applied`` (of
    those, applied with finite gradients) of the epoch,
    ``img_size``, and its wall times in seconds: ``train_s`` (the loop,
    closed by a device sync), ``wait_s`` (the part of it spent waiting for
    the loader), ``step_s`` (the part spent issuing the steps, the batch's
    copy to the device included), ``val_s``, ``ckpt_s``, ``epoch_s``.  Runs on the CUDA card
    unless ``device="cpu"``.
    """
    dev = resolve_device(device)
    hyp = {**HYP_SCRATCH, **(hyp or {})}
    d = load_cfg(cfg)
    if nc is not None:
        d["nc"] = nc
    head = d["head"][-1][2] if d.get("head") else ""
    _check_ported(cfg, head, events, sr, remat, remat_neuron, model_parallel, quad,
                  device_augment, steps_per_call, optimizer)
    tree = meta = None
    if resume:
        tree, meta = load_checkpoint(resume)
        if tree["opt_state"] is None or tree["step"] is None:
            raise ValueError(f"{resume}: no optimizer state to resume from")
    callbacks = callbacks or Callbacks()
    save_dir = increment_path(save_dir, mkdir=True)
    w = Path(save_dir) / "weights"
    w.mkdir(parents=True, exist_ok=True)

    train_ds = Dataset(train_path, img_size=imgsz, augment=True, hyp=hyp,
                       max_labels=max_labels, cache_images=cache, uint8_out=True,
                       single_cls=single_cls, seed=seed)
    val_ds = (Dataset(val_path, img_size=imgsz, augment=False,
                      max_labels=max_labels, cache_images=cache, uint8_out=True,
                      single_cls=single_cls) if val_path else None)

    anchors = None
    if resume:
        anchors = meta.get("anchors")
    elif autoanchor:
        anchors = _autoanchor(d, train_ds, imgsz, hyp.get("anchor_t", 4.0))
        if anchors is not None:
            LOGGER.info(f"autoanchor: new anchors {anchors}")
    if anchors is not None:
        d["anchors"] = anchors

    model = build_model(d, snn=snn, device=dev,
                        generator=torch.Generator().manual_seed(seed))
    model_nc = model.head_info["nc"]
    steps_per_epoch = max(len(train_ds) // batch_size, 1)
    accumulate = max(round(nbs / batch_size), 1)
    params = dict(model.named_parameters())
    tx = build_optimizer(
        params, name=optimizer, lr0=hyp["lr0"], lrf=hyp["lrf"],
        momentum=hyp["momentum"],
        weight_decay=hyp["weight_decay"] * batch_size * accumulate / nbs,
        epochs=epochs, steps_per_epoch=steps_per_epoch, cos_lr=cos_lr,
        warmup_epochs=hyp["warmup_epochs"],
        warmup_momentum=hyp["warmup_momentum"],
        warmup_bias_lr=hyp["warmup_bias_lr"], accumulate=accumulate,
        # the v1 anchor trainer's warm-up floor (reference train.py:452)
        warmup_floor=1000.0)
    state = create_train_state(model, tx, device=dev)
    step_fn = make_train_step(model, tx, hyp, ema_decay=ema_decay,
                              compute_dtype=torch.bfloat16 if bf16 else torch.float32,
                              accumulate=accumulate, device=dev)
    # the val pass's model: a copy in eval mode that takes the EMA parameters
    # and the BN statistics each epoch; the training module is never cast
    eval_model = copy.deepcopy(model).eval() if val_ds is not None else None

    gs = int(max(model.head_info["strides"]))
    if multi_scale:
        # per-epoch size buckets in /gs steps over 0.5-1.5x imgsz (the
        # reference resizes per batch, train.py:544-551)
        lo, hi = (int(imgsz * 0.5) // gs) * gs, (int(imgsz * 1.5) // gs) * gs
        size_buckets = list(range(lo, hi + 1, gs))

    stopper = EarlyStopping(patience)
    best_fitness, start_epoch = 0.0, 0
    history = []
    loggers = Loggers(save_dir, include=loggers_include)
    if resume:
        # reference --resume (train.py:876-886): parameters, buffers,
        # optimizer, EMA and counters
        model.load_state_dict(tree["model"], strict=True)
        with torch.no_grad():
            for k, e in state.ema_params.items():
                e.copy_(tree["ema"][k])
            state.step.fill_(int(tree["step"]))
        state.opt_state.load(tree["opt_state"])
        start_epoch = int(meta.get("epoch", -1)) + 1
        best_fitness = float(meta.get("best_fitness", 0.0))
        stopper.best_fitness = best_fitness
        stopper.best_epoch = start_epoch - 1
        LOGGER.info(f"resumed from {resume} at epoch {start_epoch}")
    LOGGER.info(f"training {cfg if isinstance(cfg, (str, Path)) else 'a model dict'} "
                f"(head {head}) for {epochs} epochs, bs={batch_size}, "
                f"accumulate={accumulate}, imgsz={imgsz}, {len(train_ds)} images "
                f"on {dev}")
    ckpt_meta = dict(cfg=str(cfg) if isinstance(cfg, (str, Path)) else "dict",
                     nc=model_nc, anchors=anchors, accumulate=accumulate)
    callbacks.run("on_train_start", state)

    for epoch in range(start_epoch, epochs):
        t_epoch = time.perf_counter()
        callbacks.run("on_train_epoch_start", epoch)
        if image_weights:
            _image_weights(train_ds, model_nc, history, seed + epoch)
        if close_mosaic and epoch >= epochs - close_mosaic and train_ds.hyp["mosaic"]:
            train_ds.hyp["mosaic"] = 0.0
            LOGGER.info("closing mosaic augmentation")
        if multi_scale:
            sz = size_buckets[np.random.RandomState(seed + epoch).randint(len(size_buckets))]
            train_ds.img_size = sz
            train_ds.mosaic_border = [-sz // 2, -sz // 2]
        train_ds.epoch = epoch

        items_sum = torch.zeros(3, dtype=torch.float32, device=dev)
        losses, nb, applies, wait, step_s = [], 0, 0, 0.0, 0.0
        count0 = int(state.opt_state.count)
        batches = train_ds.batches(batch_size, shuffle=True, seed=seed + epoch,
                                   workers=workers)
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            wait += time.perf_counter() - t_wait
            if batch is None:
                break
            t_step = time.perf_counter()
            images, targets, t_mask = (_to_device(a, dev) for a in batch)
            state, metrics = step_fn(state, images, targets, t_mask)
            step_s += time.perf_counter() - t_step
            items_sum += metrics["items"][:3].float()
            losses.append(metrics["loss"])
            nb += 1
            applies += int(metrics["boundary"])
            callbacks.run("on_train_batch_end", nb)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        train_s = time.perf_counter() - t_epoch
        mloss = (items_sum / max(nb, 1)).cpu().numpy()
        loss_finite = bool(torch.isfinite(torch.stack(losses)).all()) if losses else True
        callbacks.run("on_train_epoch_end", epoch)

        t_val = time.perf_counter()
        results = dict(mp=0.0, mr=0.0, map50=0.0, map=0.0, fitness=0.0)
        if val_ds is not None and (epoch + 1) % val_every == 0:
            callbacks.run("on_val_start")
            eval_model.load_state_dict({**dict(model.named_buffers()),
                                        **state.ema_params}, strict=True)
            results = val_mod.run(eval_model, None, imgsz=imgsz,
                                  batch_size=batch_size, dataset=val_ds,
                                  workers=workers,
                                  dtype=torch.bfloat16 if bf16 else None)
            callbacks.run("on_val_end", results)
        val_s = time.perf_counter() - t_val
        fit = float(results["fitness"])
        callbacks.run("on_fit_epoch_end")

        # the reference's 13 log keys (utils/loggers/__init__.py:47-50); the
        # val pass computes no losses, logged as 0 as the JAX driver does
        n_applies = int(state.step) // accumulate
        lr = {g: float(tx.lr_fns[g](n_applies)) for g in ("g0", "g1", "g2")}
        loggers.log_metrics({
            "train/box_loss": float(mloss[0]),
            "train/obj_loss": float(mloss[1]),
            "train/cls_loss": float(mloss[2]),
            "metrics/precision": results["mp"],
            "metrics/recall": results["mr"],
            "metrics/mAP_0.5": results["map50"],
            "metrics/mAP_0.5:0.95": results["map"],
            "val/box_loss": 0.0, "val/obj_loss": 0.0, "val/cls_loss": 0.0,
            "x/lr0": lr["g0"], "x/lr1": lr["g1"], "x/lr2": lr["g2"],
            "fitness": fit,
        }, step=epoch)

        t_ckpt = time.perf_counter()
        is_best = fit >= best_fitness
        if is_best:
            best_fitness = fit
        ck = dict(model=model.state_dict(), ema=state.ema_params,
                  opt_state=state.opt_state.tensors(), step=int(state.step),
                  meta=dict(ckpt_meta, epoch=epoch, best_fitness=best_fitness,
                            date=datetime.now(timezone.utc).isoformat()))
        if is_best:
            save_checkpoint(w / "best.pt", **ck)
        save_checkpoint(w / "last.pt", **ck)
        if save_period > 0 and epoch % save_period == 0:
            save_checkpoint(w / f"epoch{epoch}.pt", **ck)
        ckpt_s = time.perf_counter() - t_ckpt
        callbacks.run("on_model_save", w / "last.pt")
        history.append(dict(
            results, epoch=epoch, mloss=[float(v) for v in mloss],
            loss_finite=loss_finite, micro_steps=nb, applies=applies,
            applied=int(state.opt_state.count) - count0, img_size=train_ds.img_size,
            train_s=train_s, wait_s=wait, step_s=step_s, val_s=val_s, ckpt_s=ckpt_s,
            epoch_s=time.perf_counter() - t_epoch))
        LOGGER.info(f"epoch {epoch}: loss={np.round(mloss, 4).tolist()} "
                    f"mAP50={results['map50']:.4f} fitness={fit:.4f} "
                    f"({history[-1]['epoch_s']:.1f}s)")
        if stopper(epoch, fit):
            break

    if (w / "best.pt").exists():
        strip_optimizer(w / "best.pt", w / "best_stripped.pt")
    callbacks.run("on_train_end")
    loggers.close()
    return state, best_fitness, history
