"""The training loop (counterpart of ``ecs_yolo_tpu/train/driver.py``;
reference train.py:73-760), for every head of ``models/yolo.HEADS`` on one
device, from images or (``events=True``) from event samples.

Epochs of augmented batches (mosaic, perspective, HSV, flips, mixup) from a
thread-pool loader, every batch a micro-step of ``train/trainer``'s step
(the training-mode forward runs the spread kernels on the card), the
optimizer applying every ``accumulate`` micro-steps with the EMA beside it;
after each epoch a val pass (``val.run``) on an eval copy of the model with
the EMA parameters loaded, the reference's 13 log keys with ``fitness``, and
the best/last/periodic checkpoints; ``EarlyStopping``; ``resume``; the best
checkpoint stripped of its optimizer at the end.

The model is built for ``min(imgsz, 256)`` px, the size JAX's driver
inits at, and the checkpoints' ``meta`` records it (``imgsz``): a model
with a ``TransformerBlock`` (or ``C3TR``) serves only that size, in JAX
too, and the val and detect CLIs build at it.

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
triple and v10 losses fix theirs at 7.5.  So do the ``Segment`` and
``Panoptic`` losses: their TAL terms take (7.5, 0.5, 1.5) whatever the hyp
says (JAX's ``compute_loss_segment`` calls the TAL loss without gains), the
mask term ``hyp.get("mask", 2.5)``; the logged losses are then (box, mask,
cls).

Event mode (``events=True``; reference g1-resnet/train_g1.py): both sets
are ``data/events.EventDataset`` directories or split lists of voxelized
samples (``data/events.build_dataset``), batches ``[B, T, H, W, C]``
float32; the model is built with the data's T (``SNNConfig(time_window=T)``
from the first sample) and runs its stem at every step; multi-scale, image
weights, ``close_mosaic`` and autoanchor are off; the val pass evaluates
in canvas space (``val.run`` without ``meta``).

Segment heads (a ``Segment`` / ``Panoptic`` YAML, e.g. ``res10-seg.yaml``,
``res10-panoptic.yaml``): the train set is a ``data/dataset.SegmentDataset``
of YOLO-seg polygon labels (instance masks at a quarter of the canvas, and
for ``Panoptic`` the semantic id map with ``stuff/`` polygons), mosaic,
mixup and flips off; the step takes the masks (``make_train_step(
with_masks=True[, with_semantic=True])``); the val set is read without
masks (detection metrics); multi-scale, image weights and ``close_mosaic``
are off.

Options, as the JAX driver has them:

* ``device_augment``: the train set is only decoded and letterboxed on the
  host (``augment=False``); each batch is augmented on the device
  (``data/device_augment.augment_batch``: mosaic, scale/translate or the
  affine, HSV, flips) before its step, from a ``torch.Generator`` on the
  device seeded from ``(seed, epoch, batches dispatched)``.  With ``quad``,
  events or a segment head it falls back to the host's augmentation with a
  warning, as JAX does; ``flipud``,
  ``mixup`` or ``copy_paste`` above 0 raise ``ValueError`` (the JAX module
  drops them without a word).
* ``steps_per_call=K``: K host batches are stacked and moved to the device
  in one pinned, non-blocking copy, then their K steps (and augmentations)
  are issued back to back; nothing in between reads the device.  An epoch's
  tail shorter than K goes step by step.  The state after an epoch is the
  same as with ``K=1``.  With events or a segment head it falls back to one
  step a call with a warning, as JAX does.
* ``remat`` / ``remat_neuron``: the model recomputes its layers / its
  neuron recurrences in the backward pass (``nn/blocks.checkpointed``);
  the BN running statistics still move once a step.
* ``sr``: the network-slimming L1 term in the step, decaying over
  ``epochs * steps_per_epoch`` steps.
* ``optimizer="Lion"``; ``quad``: the quad collate (``batch_size % 4 ==
  0``; the step sees ``batch_size / 4`` images at twice the side).  With
  events or a segment head it is off with a warning (JAX drops it without
  one).

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

Under an initialised process group (``parallel/multihost.initialize``;
``python -m torch.distributed.run --nproc_per_node=N -m
ecs_yolo_tpu_torch.train ...``) the JAX driver's layout holds:
``batch_size`` is the global batch (the quad collate's step batch a
quarter of it), the ranks form a ``(data, model)`` layout with
``model_parallel`` ranks on the model axis (``parallel/mesh``), and a world
that does not divide the step batch or ``model_parallel`` is refused with
JAX's messages.  Each rank loads its rows of every global batch
(``host_shard``; the model ranks of one data rank the same rows) and runs
the step on them (``make_train_step(layout=)``: global BN moments and loss
denominators, the gradients summed over the data group; under
``model_parallel > 1`` the parameters, optimizer state and EMA sliced over
the model ranks).  ``weight_decay`` and ``accumulate`` follow the global
batch.  Rank 0 chooses the run directory and the autoanchor anchors and
reads a resumed checkpoint, and every rank takes them from it; rank 0
alone writes checkpoints and logs.  The per-epoch val pass is sharded over
the data ranks (``val.run(host_shard=)``), and its fitness is broadcast
from rank 0 so every rank stops early together.  Each rank's device
augmentation draws from its own seed (the data index folded in); JAX draws
the global batch's from one key.
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
from ..data.dataset import Dataset, SegmentDataset
from ..data.events import EventDataset
from ..data.device_augment import augment_batch, check_hyp
from ..data.hyps import HYP_SCRATCH
from ..device import resolve_device
from ..models.yolo import SEGMENT_HEADS, build_model, load_cfg, parse_model
from ..parallel import mesh, multihost
from ..utils.checkpoint import load_checkpoint, save_checkpoint, strip_optimizer
from ..utils.general import LOGGER, Callbacks, EarlyStopping, increment_path
from ..utils.loggers import Loggers
from .optim import build_optimizer
from .trainer import create_train_state, make_train_step


#: the side the model is built for, as JAX's ``model.init(imgsz=min(imgsz,
#: 256))``: a ``TransformerBlock`` / ``C3TR`` model serves only that size
BUILD_IMGSZ = 256


def _layout(model_parallel: int, batch_size: int, quad: bool):
    """The ``(data, model)`` layout of the process group (None without one),
    refused with the JAX driver's messages where the world does not divide
    the step batch or ``model_parallel``."""
    _, world = multihost.rank_world()
    mp = max(model_parallel, 1)
    step_batch = batch_size // 4 if quad else batch_size
    if world < mp:
        raise ValueError(
            f"model_parallel={mp} needs at least {mp} devices whose "
            f"data-axis extent divides the step batch {step_batch}; "
            f"have {world} device(s)")
    if world % mp or step_batch % (world // mp):
        raise ValueError(f"multi-host training needs batch {batch_size} divisible by "
                         f"all {world} devices")
    return mesh.make_layout(mp)


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
    tuples of one shape, a segment batch's masks and id map behind them)
    back to back: stacked and moved to ``dev`` in one copy, each augmented
    on the device first when ``augment(n, images, targets, t_mask)`` is
    given (``n`` counts from ``first``).  Nothing here reads a device
    value, so the host does not wait for the device between the steps.
    Returns ``(state, [metrics of each step])``."""
    stacked = [np.stack(a) if len(a) > 1 else a[0][None] for a in zip(*batches)]
    arrays = _to_device(stacked, dev)
    out = []
    for j in range(arrays[0].shape[0]):
        batch = tuple(a[j] for a in arrays)
        if augment is not None:
            batch = augment(first + j, *batch)
        state, metrics = step_fn(state, *batch)
        out.append(metrics)
    return state, out


def _augment_seed(seed: int, epoch: int, n: int, host_shard=None) -> int:
    """Seed of the device augmentation of batch ``n`` of ``epoch`` (of this
    rank's rows of it, under a ``host_shard`` of more than one rank)."""
    key = [seed, epoch, n] + ([host_shard[0]] if host_shard and host_shard[1] > 1 else [])
    return int(np.random.SeedSequence(key).generate_state(1)[0])


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
    # masks ride in the step unless event batches (no masks) feed the head
    seg_mode = head in SEGMENT_HEADS and not events
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    if quad and (events or seg_mode):
        LOGGER.warning("the quad collate supports the plain detection pipeline "
                       "only - off")
        quad = False
    if quad and batch_size % 4:
        raise ValueError(f"quad needs batch % 4 == 0, got {batch_size}")
    layout = _layout(model_parallel, batch_size, quad)
    main = multihost.is_main()
    host_shard = layout.host_shard if layout is not None else None
    if device_augment and (quad or events or seg_mode):
        LOGGER.warning("device_augment supports the plain detection pipeline only "
                       "- falling back to host augmentation")
        device_augment = False
    if steps_per_call > 1 and (events or seg_mode):
        LOGGER.warning("steps_per_call supports the plain detection pipeline only "
                       "- one step per call")
        steps_per_call = 1
    if device_augment:
        check_hyp(hyp)
    tree = meta = None
    if resume:
        # rank 0 reads the file, every rank takes its tensors
        tree, meta = multihost.broadcast_object(load_checkpoint(resume) if main
                                                else None)
        if tree["opt_state"] is None or tree["step"] is None:
            raise ValueError(f"{resume}: no optimizer state to resume from")
    callbacks = callbacks or Callbacks()
    save_dir = multihost.broadcast_object(increment_path(save_dir, mkdir=True)
                                          if main else None)
    w = Path(save_dir) / "weights"
    if main:
        w.mkdir(parents=True, exist_ok=True)

    if events:
        train_ds = EventDataset(train_path, img_size=imgsz, max_labels=max_labels)
        val_ds = (EventDataset(val_path, img_size=imgsz, max_labels=max_labels)
                  if val_path else None)
        image_weights = multi_scale = False
        close_mosaic = 0
        # the time window is the event stream's (T=5 for Gen1, reference
        # g1-resnet/train_g1.py:488): the model is sized to it
        t_data = train_ds[0][0].shape[0]
        snn = (snn or SNNConfig()).replace(time_window=t_data)
        LOGGER.info(f"event mode: T={t_data} from data")
    elif seg_mode:
        train_ds = SegmentDataset(train_path, img_size=imgsz, augment=True, hyp=hyp,
                                  max_labels=max_labels, cache_images=cache,
                                  uint8_out=True, single_cls=single_cls, seed=seed,
                                  semantic=head == "Panoptic")
        val_ds = (SegmentDataset(val_path, img_size=imgsz, augment=False,
                                 max_labels=max_labels, cache_images=cache,
                                 uint8_out=True, single_cls=single_cls,
                                 include_masks=False) if val_path else None)
        image_weights = multi_scale = False
        close_mosaic = 0
        LOGGER.info("segmentation mode: polygon labels + instance masks")
    else:
        train_ds = Dataset(train_path, img_size=imgsz, augment=not device_augment,
                           hyp=hyp, max_labels=max_labels, cache_images=cache,
                           uint8_out=True, single_cls=single_cls, seed=seed)
        val_ds = (Dataset(val_path, img_size=imgsz, augment=False,
                          max_labels=max_labels, cache_images=cache, uint8_out=True,
                          single_cls=single_cls) if val_path else None)

    anchors = None
    if resume:
        anchors = meta.get("anchors")
    elif autoanchor and head == "Detect" and not events:
        anchors = multihost.broadcast_object(
            _autoanchor(d, train_ds, imgsz, hyp.get("anchor_t", 4.0)) if main else None)
        if anchors is not None:
            LOGGER.info(f"autoanchor: new anchors {anchors}")
    if anchors is not None:
        d["anchors"] = anchors

    if remat_neuron:
        snn = (snn or SNNConfig()).replace(remat_neuron=True)
    build_imgsz = min(imgsz, BUILD_IMGSZ)
    model = build_model(d, snn=snn, device=dev, remat=remat, imgsz=build_imgsz,
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
    plan = mesh.shard_plan(model, layout.mp) if layout is not None else {}
    step_fn = make_train_step(model, tx, hyp, ema_decay=ema_decay,
                              compute_dtype=torch.bfloat16 if bf16 else torch.float32,
                              sr=sr, sr_total_steps=epochs * steps_per_epoch,
                              accumulate=accumulate, with_masks=seg_mode,
                              with_semantic=seg_mode and head == "Panoptic", device=dev,
                              layout=layout, plan=plan)
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
    loggers = Loggers(save_dir, include=loggers_include) if main else None
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
    # the model ranks' slices of the sharded leaves (resumed whole, then cut)
    state = mesh.shard_state(state, plan, layout)
    LOGGER.info(f"training {cfg if isinstance(cfg, (str, Path)) else 'a model dict'} "
                f"(head {head}) for {epochs} epochs, bs={batch_size}, "
                f"accumulate={accumulate}, imgsz={imgsz}, {len(train_ds)} images "
                f"on {dev}")
    ckpt_meta = dict(cfg=str(cfg) if isinstance(cfg, (str, Path)) else "dict",
                     nc=model_nc, anchors=anchors, accumulate=accumulate,
                     imgsz=build_imgsz)
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
        if aug_gen is not None:
            aug_hyp = dict(hyp, mosaic=train_ds.hyp.get("mosaic", 1.0))

        def augment(n, im, tg, mk):
            aug_gen.manual_seed(_augment_seed(seed, epoch, n, host_shard))
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
                                   workers=workers, quad=quad, host_shard=host_shard)
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
        whole = mesh.gather_state(state, plan, layout)   # every model rank gathers
        results = dict(mp=0.0, mr=0.0, map50=0.0, map=0.0, fitness=0.0)
        if val_ds is not None and (epoch + 1) % val_every == 0:
            callbacks.run("on_val_start")
            eval_model.load_state_dict({**dict(model.named_buffers()),
                                        **whole.ema_params}, strict=True)
            results = val_mod.run(eval_model, None, imgsz=imgsz,
                                  batch_size=batch_size, dataset=val_ds,
                                  workers=workers,
                                  dtype=torch.bfloat16 if bf16 else None,
                                  host_shard=host_shard)
            callbacks.run("on_val_end", results)
        val_s = time.perf_counter() - t_val
        fit = multihost.broadcast_scalar(float(results["fitness"]))
        callbacks.run("on_fit_epoch_end")

        # the reference's 13 log keys (utils/loggers/__init__.py:47-50); the
        # val pass computes no losses, logged as 0 as the JAX driver does
        n_applies = int(state.step) // accumulate
        lr = {g: float(tx.lr_fns[g](n_applies)) for g in ("g0", "g1", "g2")}
        log_row = {
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
        }
        if main:
            loggers.log_metrics(log_row, step=epoch)

        t_ckpt = time.perf_counter()
        is_best = fit >= best_fitness
        if is_best:
            best_fitness = fit
        ck = dict(model={**model.state_dict(), **whole.params}, ema=whole.ema_params,
                  opt_state=whole.opt_state.tensors(), step=int(state.step),
                  meta=dict(ckpt_meta, epoch=epoch, best_fitness=best_fitness,
                            date=datetime.now(timezone.utc).isoformat()))
        del whole
        if main:
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

    if main and (w / "best.pt").exists():
        strip_optimizer(w / "best.pt", w / "best_stripped.pt")
    callbacks.run("on_train_end")
    if main:
        loggers.close()
    return state, best_fitness, history
