"""The training loop (counterpart of ``ecs_yolo_tpu/train/driver.py``;
reference train.py:73-760), for every detection head of
``models/yolo.HEADS`` on one device.

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

Heads, as the JAX driver treats them: autoanchor runs for the v1 ``Detect``
head only; the optimizer's warm-up floor is 1000 iterations for ``Detect``
(reference train.py:452) and 100 for the anchor-free heads (train2.py:238);
the logged losses are the first three items of the step (the auxiliary
branch's, for the dual and triple heads).  Under the default hyp
(``HYP_SCRATCH``, box gain 0.05) a ``DDetect`` / ``ASFF_DDetect`` model
trains with a TAL box gain of 0.05, as the JAX driver's does; the dual,
triple and v10 losses fix theirs at 7.5.

Options, as the JAX driver has them:

* ``device_augment``: the train set is only decoded and letterboxed on the
  host (``augment=False``); each batch is augmented on the device
  (``data/device_augment.augment_batch``: mosaic, scale/translate or the
  affine, HSV, flips) before its step, from a ``torch.Generator`` on the
  device seeded from ``(seed, epoch, batches dispatched)``.  With ``quad``
  it falls back to the host's augmentation with a warning, as JAX does
  (and with events or a segment head, neither ported yet); ``flipud``,
  ``mixup`` or ``copy_paste`` above 0 raise ``ValueError`` (the JAX module
  drops them without a word).
* ``steps_per_call=K``: K host batches are stacked and moved to the device
  in one pinned, non-blocking copy, then their K steps (and augmentations)
  are issued back to back; nothing in between reads the device.  An epoch's
  tail shorter than K goes step by step.  The state after an epoch is the
  same as with ``K=1``.
* ``remat`` / ``remat_neuron``: the model recomputes its layers / its
  neuron recurrences in the backward pass (``nn/blocks.checkpointed``);
  the BN running statistics still move once a step.
* ``sr``: the network-slimming L1 term in the step, decaying over
  ``epochs * steps_per_epoch`` steps.
* ``optimizer="Lion"``; ``quad``: the quad collate (``batch_size % 4 ==
  0``; the step sees ``batch_size / 4`` images at twice the side).

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
  (``data/dataset.Dataset.sample_rng``); each device-augmented batch's from
  ``(seed, epoch, batches dispatched)`` by a ``torch.Generator``, where JAX
  folds ``epoch * steps_per_epoch + batches dispatched`` into its key.

Not ported (each raises ``NotImplementedError`` naming its ROADMAP Queue 1
item): ``events`` (10), segment heads (11), ``model_parallel > 1`` and
multi-host (12).
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
from ..data.device_augment import augment_batch, check_hyp
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


def _check_ported(head: str, events, model_parallel) -> None:
    if events:
        _unported("event mode (events=True)", "item 10")
    if head in ("Segment", "Panoptic"):
        _unported(f"the {head} head", "item 11")
    if model_parallel > 1 or (torch.distributed.is_available()
                              and torch.distributed.is_initialized()):
        _unported("model_parallel > 1 and multi-host training", "item 12")


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


def _to_device(arrays, dev: torch.device):
    """The host arrays as tensors on ``dev``: on a CUDA device packed into
    one pinned buffer (each array at a 16-byte aligned offset) and moved in
    one non-blocking copy, then viewed back in their dtypes and shapes."""
    ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if dev.type != "cuda":
        return ts
    offs, n = [], 0
    for t in ts:
        offs.append(n)
        n += -(-t.numel() * t.element_size() // 16) * 16
    buf = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    for t, o in zip(ts, offs):
        nb = t.numel() * t.element_size()
        buf[o:o + nb] = t.reshape(-1).view(torch.uint8)
    dbuf = buf.to(dev, non_blocking=True)
    return [dbuf[o:o + t.numel() * t.element_size()].view(t.dtype).view(t.shape)
            for t, o in zip(ts, offs)]


def dispatch(state, step_fn, batches, dev: torch.device, augment=None, first: int = 0):
    """Issue the steps of ``batches`` (host ``(images, targets, t_mask)``
    tuples of one shape) back to back: stacked and moved to ``dev`` in one
    copy, each augmented on the device first when ``augment(n, images,
    targets, t_mask)`` is given (``n`` counts from ``first``).  Nothing here
    reads a device value, so the host does not wait for the device between
    the steps.  Returns ``(state, [metrics of each step])``."""
    stacked = [np.stack(a) if len(a) > 1 else a[0][None] for a in zip(*batches)]
    images, targets, t_mask = _to_device(stacked, dev)
    out = []
    for j in range(images.shape[0]):
        batch = (images[j], targets[j], t_mask[j])
        if augment is not None:
            batch = augment(first + j, *batch)
        state, metrics = step_fn(state, *batch)
        out.append(metrics)
    return state, out


def _augment_seed(seed: int, epoch: int, n: int) -> int:
    """Seed of the device augmentation of batch ``n`` of ``epoch``."""
    return int(np.random.SeedSequence([seed, epoch, n]).generate_state(1)[0])


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
    _check_ported(head, events, model_parallel)
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    if quad and batch_size % 4:
        raise ValueError(f"quad needs batch % 4 == 0, got {batch_size}")
    if device_augment and quad:
        LOGGER.warning("device_augment supports the plain detection pipeline only "
                       "- falling back to host augmentation")
        device_augment = False
    if device_augment:
        check_hyp(hyp)
    tree = meta = None
    if resume:
        tree, meta = load_checkpoint(resume)
        if tree["opt_state"] is None or tree["step"] is None:
            raise ValueError(f"{resume}: no optimizer state to resume from")
    callbacks = callbacks or Callbacks()
    save_dir = increment_path(save_dir, mkdir=True)
    w = Path(save_dir) / "weights"
    w.mkdir(parents=True, exist_ok=True)

    train_ds = Dataset(train_path, img_size=imgsz, augment=not device_augment, hyp=hyp,
                       max_labels=max_labels, cache_images=cache, uint8_out=True,
                       single_cls=single_cls, seed=seed)
    val_ds = (Dataset(val_path, img_size=imgsz, augment=False,
                      max_labels=max_labels, cache_images=cache, uint8_out=True,
                      single_cls=single_cls) if val_path else None)

    anchors = None
    if resume:
        anchors = meta.get("anchors")
    elif autoanchor and head == "Detect":
        anchors = _autoanchor(d, train_ds, imgsz, hyp.get("anchor_t", 4.0))
        if anchors is not None:
            LOGGER.info(f"autoanchor: new anchors {anchors}")
    if anchors is not None:
        d["anchors"] = anchors

    if remat_neuron:
        snn = (snn or SNNConfig()).replace(remat_neuron=True)
    model = build_model(d, snn=snn, device=dev, remat=remat,
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
        # the warm-up floor of the v1 anchor trainer (reference train.py:452),
        # and of the TAL/v10/dual generation (train2.py:238)
        warmup_floor=1000.0 if head == "Detect" else 100.0)
    state = create_train_state(model, tx, device=dev)
    step_fn = make_train_step(model, tx, hyp, ema_decay=ema_decay,
                              compute_dtype=torch.bfloat16 if bf16 else torch.float32,
                              sr=sr, sr_total_steps=epochs * steps_per_epoch,
                              accumulate=accumulate, device=dev)
    aug_gen = torch.Generator(device=dev) if device_augment else None
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
        aug_hyp = dict(hyp, mosaic=train_ds.hyp.get("mosaic", 1.0))

        def augment(n, im, tg, mk):
            aug_gen.manual_seed(_augment_seed(seed, epoch, n))
            return augment_batch(im.to(torch.float32) / 255.0, tg, mk, aug_gen, aug_hyp)

        def issue(chunk):
            nonlocal state, nb, applies, items_sum, step_s
            t_step = time.perf_counter()
            state, ms = dispatch(state, step_fn, chunk, dev,
                                 augment if aug_gen is not None else None, first=nb)
            for metrics in ms:
                items_sum += metrics["items"][:3].float()
                losses.append(metrics["loss"])
                nb += 1
                applies += int(metrics["boundary"])
                callbacks.run("on_train_batch_end", nb)
            step_s += time.perf_counter() - t_step

        batches = train_ds.batches(batch_size, shuffle=True, seed=seed + epoch,
                                   workers=workers, quad=quad)
        chunk = []
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            wait += time.perf_counter() - t_wait
            if batch is None:
                break
            chunk.append(batch)
            if len(chunk) == steps_per_call:
                issue(chunk)
                chunk = []
        for batch in chunk:         # an epoch's tail shorter than K, step by step
            issue([batch])
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
