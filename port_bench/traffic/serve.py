"""Closed-loop batched serving of dashcam frames (mix kind ``serve``).

One client sends a batch, waits for its detections and sends the next.  A
step is what a serving user runs for a batch: the pinned uint8 batch copied
to the card and scaled to 0-1 (``h2d``), ``detect.predictor``'s ``predict``
(the forward and the head's decode, ``forward``), and
``detect.frame_detections`` (NMS, the boxes to the host, mapped back to the
native frame, ``nms``).  The step ends with the detections on the host.

Set-up, outside the window: ``pool`` frames made from the seed on the card
(``core/scenes``), letterboxed, cut into batches in a seeded order and kept
in pinned host memory; the served head's objectness bias (``served_head``)
set so that the reference's forward of the pool passes
``candidates_per_image`` boxes an image through ``conf``, so that every
seed gives NMS the same load; the model built by the program with the
seeded weights (``core/weights``), its BN statistics calibrated on the
first batch in float32 (training-mode forward, momentum 1), cast to the
served dtype; three warm-up steps.  The window cycles the batches.

Nothing in the window waits for the card but the program's own copies to
the host.  In a traced run CUDA events at the step's start and around the
forward give the forward's device time and the wall time a batch spends
after its forward ended (``nms``: NMS, the copies, the rescale), with no
synchronisation added; the profiler covers a sub-window, and the serving
step's share of the peak (``mfu.serve``) is taken over the rest.

The check takes ``check_batches`` of the window's steps, drawn from the seed
among its first ``check_from``.  A spiking network with random weights is
chaotic: one spike flipped by rounding near the threshold changes the
spikes after it, so a float32 reference run freely from the image ends far
from any bf16 run.  The reference therefore follows the program step by
step from the program's own state (teacher forcing): for every neuron site
the program's input ``x`` and spikes of the sampled step are kept (and the
spikes of its calibration forward).  Four numbers, each the worst over the
sites, images or batches:

* ``site_gap``: the share of spikes, over all the sites, that differ between
  the program's and the reference's neuron (ECS-LIF over T) on the
  program's input;
* ``edge_gap``: the relative L2 gap between the program's input at each
  site and the reference's, computed from the image by the reference's
  convolutions, BNs, pools, concatenations and residual sums with every
  neuron emitting the program's spikes (its BN statistics calibrated the
  same way, on the program's calibration spikes) -- this covers the stem,
  the start of the walk;
* ``head_gap``: the relative L2 gap of the decoded head predictions
  (boxes, and scores) of that forced walk against the program's;
* ``det_gap``: the worst image's share of unpartnered detections between
  the program's NMS and rescale and the reference's, both on the program's
  head predictions (the stage by itself: NMS's greedy choices are as
  chaotic as the spikes, so it takes the stage before it as given).
"""

from __future__ import annotations

import math
import random
import statistics
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench.core import compare, scenes, weights
from port_bench.counts import forward_flops, k1_bound_s, model_shapes
from port_bench.reference import nms as ref_nms
from port_bench.reference.model import TBN, MemUpdate, fp8_quant


class State:
    pass


def _calibrate(model, bn_cls, x, *args) -> None:
    """BN running statistics from one batch (momentum 1)."""
    bns = [m for m in model.modules() if isinstance(m, bn_cls)]
    for b in bns:
        b.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(x, *args)
    model.eval()
    for b in bns:
        b.momentum = 0.1


def _nchw(ctx, hb: torch.Tensor) -> torch.Tensor:
    return hb.to(ctx.device).permute(0, 3, 1, 2).float() / 255.0


def served_head(ctx, batches: List[torch.Tensor]) -> Dict:
    """The configuration's ``served_head`` with its objectness bias.  The
    reference (float32), its BN statistics calibrated on the first batch as
    the program's are, runs every batch of the pool in eval mode with the
    bias at 0; an anchor passes ``conf`` once the bias exceeds ``logit(conf
    / best class score) - objectness logit``, and the bias is set midway
    between the k-th and the (k+1)-th of those over the pool, k =
    ``candidates_per_image`` x the pool's images."""
    cfg, conf = ctx.config, ctx.mix["conf"]
    head = {k: v for k, v in cfg["served_head"].items() if k in ("collapse", "head_gain")}
    ref = weights.reference(cfg, ctx.device)
    ref.load_state_dict(weights.make(cfg, ctx.seed, ctx.device, head))
    det = ref.model[-1]
    seen = []
    with compare.exact_float32():
        _calibrate(ref, TBN, _nchw(ctx, batches[0]))
        hook = det.register_forward_hook(lambda m, i, o: seen.append(m.maps(i[0])))
        with torch.no_grad():
            for hb in batches:
                ref(_nchw(ctx, hb))
    hook.remove()
    rows = torch.cat([m.reshape(-1, m.shape[-1]) for maps in seen for m in maps]).double()
    cls = torch.sigmoid(rows[:, 5:]).amax(-1)
    need = (torch.logit(conf / cls[cls > conf]) - rows[cls > conf, 4]).sort().values
    k = int(round(cfg["served_head"]["candidates_per_image"] * sum(len(hb) for hb in batches)))
    del ref, seen, rows
    if need.numel() <= k:
        raise ValueError(f"only {need.numel()} anchors can pass conf {conf}; {k} are asked for")
    return {**head, "obj_bias": float((need[k - 1] + need[k]) / 2)}


def setup(ctx) -> State:
    from ecs_yolo_tpu_torch.detect import frame_detections, predictor
    from ecs_yolo_tpu_torch.models.yolo import cast_params
    from ecs_yolo_tpu_torch.nn.blocks import _BN

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    st = State()
    st.b, st.size = mix["batch"], cfg["imgsz"]
    st.native = tuple(mix["native_hw"])
    frames = scenes.make_frames(mix["pool"], ctx.seed, dev, st.native, st.size)
    order = torch.randperm(mix["pool"], generator=torch.Generator().manual_seed(ctx.seed))
    pin = (lambda t: t.pin_memory()) if dev.type == "cuda" else (lambda t: t)
    st.batches = [pin(frames[order[i:i + st.b].to(dev)].cpu())
                  for i in range(0, mix["pool"] - st.b + 1, st.b)]
    del frames
    st.head_init = served_head(ctx, st.batches)
    model = weights.program(cfg, st.size, dev, weights.make(cfg, ctx.seed, dev, st.head_init))
    st.calib = {}
    hooks = _site_hooks(model, st.calib, calib=True)
    _calibrate(model, _BN, st.batches[0].to(dev).float() / 255.0)
    for h in hooks:
        h.remove()
    cast_params(model, getattr(torch, cfg["dtypes"]["serve_params"]))
    _, st.head, st.predict = predictor(model)
    st.model = model
    st.frame_detections = frame_detections
    st.natives = [np.broadcast_to(np.zeros((), np.uint8), st.native + (3,))] * st.b
    rng = random.Random(ctx.seed)
    st.sample = sorted(rng.sample(range(mix["check_from"]), mix["check_batches"]))
    st.kept_pred: Dict[int, torch.Tensor] = {}
    st.kept_dets: Dict[int, List[np.ndarray]] = {}
    st.kept_sites: Dict[int, Dict] = {}
    with torch.inference_mode():
        for i in range(3):
            _step(ctx, st, i, keep=False)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return st


def _site_hooks(model, store: Dict, calib: bool):
    """Forward hooks on the program's neuron sites: the calibration's spikes
    (as uint8, moved to the host), or a served step's input and spikes
    (kept as they are, on the card)."""
    from ecs_yolo_tpu_torch.nn.blocks import MemUpdate

    def keep(name):
        if calib:
            return lambda m, i, o: store.__setitem__(name, o.detach().to(torch.uint8).cpu())
        return lambda m, i, o: store.__setitem__(name, (i[0], o))

    return [m.register_forward_hook(keep(n)) for n, m in model.named_modules()
            if isinstance(m, MemUpdate)]


def _step(ctx, st, i: int, keep: bool, events=None):
    """One batch; ``events`` (start, forward start, forward end) are
    recorded on the card's stream where given."""
    rec, mix = ctx.recorder, ctx.mix
    hb = st.batches[i % len(st.batches)]
    hooks = []
    if keep and i in st.sample:
        st.kept_sites[i] = {}
        hooks = _site_hooks(st.model, st.kept_sites[i], calib=False)
    if events is not None:
        events[0].record()
    with rec.span("h2d"):
        x = hb.to(ctx.device, non_blocking=True).float() / 255.0
    with rec.span("forward"):
        if events is not None:
            events[1].record()
        pred = st.predict(x)
        if events is not None:
            events[2].record()
    with rec.span("nms"):
        dets = st.frame_detections(pred, st.head, (st.size, st.size), st.natives,
                                   mix["conf"], mix["iou"], mix["max_det"])
    if keep and i in st.sample:
        for h in hooks:
            h.remove()
        st.kept_pred[i] = pred
        st.kept_dets[i] = dets
    return dets


def measure(ctx, st) -> Dict:
    from ecs_yolo_tpu_torch.snn import ecs_lif

    rec, mix = ctx.recorder, ctx.mix
    timed = ctx.device.type == "cuda" and rec.traced
    fwd_ms, after_ms, lat = [], [], []
    traced_steps, traced_s, k1_at = 0, 0.0, None
    i = 0
    with torch.inference_mode():
        t0 = time.perf_counter()
        while True:
            if rec.traced and i == mix["trace_from"]:
                tp = time.perf_counter()
                rec.start()
                k1_at = ecs_lif.ecs_lif_fused.launches
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if timed else None
            ts = time.perf_counter()
            _step(ctx, st, i, keep=True, events=ev)
            te = time.perf_counter()
            lat.append(te - ts)
            if ev is not None:      # the program's copies to the host have ended the step
                fwd_ms.append(ev[1].elapsed_time(ev[2]))
                after_ms.append((te - ts) * 1e3 - ev[0].elapsed_time(ev[2]))
            i += 1
            if rec.traced and not rec.profiled and i == mix["trace_from"] + mix["trace_steps"]:
                k1 = ecs_lif.ecs_lif_fused.launches - k1_at
                traced_steps = mix["trace_steps"]
                rec.stop()
                traced_s = time.perf_counter() - tp
            if te - t0 >= ctx.seconds:
                break
    elapsed = te - t0
    shapes = model_shapes(ctx.config, st.size)
    e2e = {"serve_img_s": st.b * i / elapsed,
           "serve_p95_ms": statistics.quantiles(lat, n=20, method="inclusive")[-1] * 1e3
           if len(lat) > 1 else lat[0] * 1e3}
    record = {"steps": i, "images_per_step": st.b, "window_s": elapsed,
              "forward_device_ms": fwd_ms, "after_forward_ms": after_ms}
    if rec.profiled:
        dtype = ctx.config["dtypes"]["serve_params"]
        flops = forward_flops(shapes) * st.b
        record.update({
            "trace": rec.reduce(), "steps_traced": traced_steps,
            "flops_traced": flops * traced_steps,
            "untraced": {"flops": flops * (i - traced_steps), "steps": i - traced_steps,
                         "seconds": elapsed - traced_s},
            "k1": {"launches": k1, "expected": len(shapes["sites"]) * traced_steps,
                   "bound_s": k1_bound_s(shapes, ctx.config["T"], st.b, dtype) * traced_steps}})
    return {"e2e": e2e, "attempted": st.b * i, "failed": 0, "record": record}


def release(ctx, st) -> None:
    """Free the program's state; the batches and the kept outputs stay."""
    scores = [(p[..., 5:].float().amax(-1) * p[..., 4].float() > ctx.mix["conf"]).sum(-1)
              for p in st.kept_pred.values()]
    st.candidates = float(torch.cat(scores).float().mean()) if scores else 0.0
    del st.model, st.predict
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def _cl(t: torch.Tensor) -> torch.Tensor:
    """``[T, N, H, W, C]`` (the program's layout) as ``[T, N, C, H, W]``."""
    return t.permute(0, 1, 4, 2, 3)


def _detections(ctx, st, pred: torch.Tensor) -> List[np.ndarray]:
    """The reference's NMS and rescale of a batch's predictions."""
    mix = ctx.mix
    return [ref_nms.to_native(ref_nms.nms(row, mix["conf"], mix["iou"], mix["max_det"]),
                              (st.size, st.size), st.native)
            for row in pred.double().cpu().numpy()]


def _follow(ctx, st, j: int, quant=None) -> Dict:
    """The reference (or, with ``quant``, the control) following the
    program's spikes on sampled step ``j``: its input at every site, its
    spikes at every site on the program's input, its head predictions."""
    cfg, dev = ctx.config, ctx.device
    ref = weights.reference(cfg, dev)
    ref.load_state_dict(weights.make(cfg, ctx.seed, dev, st.head_init))
    sites = {n: m for n, m in ref.named_modules() if isinstance(m, MemUpdate)}
    prog = st.kept_sites.get(j, {})
    if set(sites) != set(st.calib) or set(sites) != set(prog):
        return {}
    for n, m in sites.items():
        m.forced = _cl(st.calib[n].to(dev)).float()
    _calibrate(ref, TBN, _nchw(ctx, st.batches[0]), quant)
    for n, m in sites.items():
        m.forced, m.seen = _cl(prog[n][1]).float(), []
    with torch.no_grad():
        pred = ref(_nchw(ctx, st.batches[j % len(st.batches)]), quant)
        xs = {n: m.seen[0] for n, m in sites.items()}
        spikes = {}
        for n, m in sites.items():
            m.forced = m.seen = None
            spikes[n] = m(_cl(prog[n][0]).float(), quant).to(torch.uint8)
    return {"x": xs, "spikes": spikes, "pred": pred}


def _numbers(got: Dict, want: Dict) -> Dict[str, float]:
    if not got or not want:
        return {"site_gap": math.inf, "edge_gap": math.inf, "head_gap": math.inf,
                "det_gap": math.inf}
    flipped = sum(float((got["spikes"][n] != s).sum()) for n, s in want["spikes"].items())
    total = sum(s.numel() for s in want["spikes"].values())
    return {
        "site_gap": flipped / total,
        "edge_gap": max(compare.rel_l2(got["x"][n], x) for n, x in want["x"].items()),
        "head_gap": compare.head_gap([got["pred"]], [want["pred"]]),
        "det_gap": compare.det_gap(got["dets"], want["dets"])}


def _program(st, j: int) -> Dict:
    prog = st.kept_sites.get(j)
    if not prog or j not in st.kept_pred:
        return {}
    return {"x": {n: _cl(x).float() for n, (x, _) in prog.items()},
            "spikes": {n: _cl(s).to(torch.uint8) for n, (_, s) in prog.items()},
            "pred": st.kept_pred[j], "dets": st.kept_dets[j]}


def _worst(rows):
    return {k: max(r[k] for r in rows) for k in rows[0]}


def _reference(ctx, st, j: int) -> Dict:
    try:
        want = _follow(ctx, st, j)
    except ValueError as e:     # the program's spikes do not fit its batch
        print(f"serve check: {e}", file=sys.stderr)
        return {}
    if j in st.kept_pred:
        want["dets"] = _detections(ctx, st, st.kept_pred[j])
    return want


def check(ctx, st) -> Dict[str, float]:
    """The program's sampled steps against the reference that follows them."""
    with compare.exact_float32():
        rows = [_numbers(_program(st, j), _reference(ctx, st, j)) for j in st.sample]
        out = _worst(rows)
    out["candidates_per_image"] = st.candidates
    out["obj_bias"] = st.head_init["obj_bias"]
    return out


def control(ctx, st, faults: bool = True) -> Dict[str, Dict[str, float]]:
    """The readings that bound the limits (``control``): the reference
    computed in fp8 put in the program's place, under the same teacher
    forcing; its NMS stage on fp8-rounded predictions.  No fault is planted
    here (``faults`` is for the training traffic's)."""
    rows = []
    with compare.exact_float32():
        for j in st.sample:
            got = _follow(ctx, st, j, fp8_quant) if j in st.kept_pred else {}
            if got:
                got["dets"] = _detections(ctx, st, fp8_quant(st.kept_pred[j].float()))
            rows.append(_numbers(got, _reference(ctx, st, j)))
    return {"control": _worst(rows)}
