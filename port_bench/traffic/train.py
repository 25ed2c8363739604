"""Training on pre-staged batches (mix kind ``train``).

A step is one micro-step of ``train/trainer.make_train_step``: the training
forward in the compute dtype on float32 masters, the v1 loss, the
gradients, the accumulation window's running mean and, every
``accumulate``-th micro-step, the SGD apply and the EMA.  Nothing in it
waits for the card, so the window issues micro-steps back to back and ends
with one synchronisation; its rate counts all the images over all the time.

Set-up, outside the window: ``batches`` distinct micro-batches made from the
seed on the card (uint8 frames with 1 to ``max_boxes`` boxes an image over
the configuration's classes, painted into the frames), the model built by
the program with the seeded weights, the driver's optimizer (SGD at its
defaults, weight decay scaled to the nominal batch) at the apply count of
``schedule.start_epoch`` (inside the warm-up, where every group has a
learning rate: the weights' rises from 0, the biases' falls from
``warmup_bias_lr``), and the step.  The first ``check_steps`` micro-steps
are the check's and the warm-up: batches 0, 1, ... (every row differs), an
apply at every ``accumulate``-th, so the second apply starts from the
momentum buffer of the first.  The window goes on from the next batch with
the same step and state.

The check follows those steps with the plain reference from the same
weights: each step's loss, the first micro-gradient as the optimizer holds
it after step 1 (the window's running mean), the parameters' change and the
EMA's after the last check step, each compared leaf by leaf as the gap of
norms over the larger of the reference's leaf norm and its median leaf's.
A spiking network with random weights is chaotic (one spike flipped by
rounding changes those after it), so the reference follows the program's
own spikes: every neuron site of its forward emits the spikes the
program's emitted at that step (kept from the check steps), with the
surrogate gradient taken at the reference's own membrane.
"""

from __future__ import annotations

import statistics
import sys
import time
from typing import Dict

import torch

from port_bench.core import compare, weights
from port_bench.counts import forward_flops, model_shapes, spread_bounds
from port_bench.reference.loss import v1_loss
from port_bench.reference.model import MemUpdate, fp8_quant
from port_bench.reference.optim import ema_apply, sgd_apply

#: the faults planted in the reference put in the program's place, whose
#: readings bound the limits (``control.py``)
FAULTS = ("no_momentum", "no_weight_decay")


class State:
    pass


def make_batches(n: int, b: int, size: int, nc: int, max_boxes: int, seed: int, device):
    """``n`` micro-batches ``(uint8 [b, size, size, 3], targets [b, M, 5],
    mask [b, M])``: a noisy background and each valid box painted in a
    random colour; classes uniform over ``nc``."""
    g = torch.Generator(device=device).manual_seed(int(seed) + 1)
    r = lambda *s: torch.rand(*s, generator=g, device=device)
    yy = torch.arange(size, device=device).view(1, size, 1, 1)
    xx = torch.arange(size, device=device).view(1, 1, size, 1)
    out = []
    for _ in range(n):
        count = 1 + (r(b) * max_boxes).long().clamp(max=max_boxes - 1)
        mask = torch.arange(max_boxes, device=device)[None] < count[:, None]
        wh = 0.03 + 0.4 * r(b, max_boxes, 2)
        cxy = wh / 2 + r(b, max_boxes, 2) * (1 - wh)
        cls = (r(b, max_boxes) * nc).floor().clamp(max=nc - 1)
        targets = torch.cat([cls[..., None], cxy, wh], -1) * mask[..., None]
        img = 80 + 60 * r(b, 1, 1, 3) + 20 * r(b, size, size, 1)
        lo = ((cxy - wh / 2) * size).round().long()
        hi = ((cxy + wh / 2) * size).round().long()
        for j in range(max_boxes):
            on = ((xx >= lo[:, j, 0].view(b, 1, 1, 1)) & (xx < hi[:, j, 0].view(b, 1, 1, 1))
                  & (yy >= lo[:, j, 1].view(b, 1, 1, 1)) & (yy < hi[:, j, 1].view(b, 1, 1, 1))
                  & mask[:, j].view(b, 1, 1, 1))
            img = torch.where(on, 255 * r(b, 1, 1, 3), img)
        out.append((img.clamp(0, 255).to(torch.uint8), targets, mask))
    return out


def _schedule(ctx) -> Dict:
    from ecs_yolo_tpu_torch.data.hyps import HYP_SCRATCH

    mix = ctx.mix
    hyp = dict(HYP_SCRATCH)
    sch = mix["schedule"]
    return {"hyp": hyp, "epochs": sch["epochs"], "steps_per_epoch": sch["steps_per_epoch"],
            "accumulate": mix["accumulate"], "lr0": hyp["lr0"], "lrf": hyp["lrf"],
            "momentum": hyp["momentum"], "warmup_epochs": hyp["warmup_epochs"],
            "warmup_momentum": hyp["warmup_momentum"],
            "warmup_bias_lr": hyp["warmup_bias_lr"], "warmup_floor": 1000.0,
            "weight_decay": hyp["weight_decay"] * mix["batch"] * mix["accumulate"] / sch["nbs"],
            "start": int(sch["start_epoch"] * sch["steps_per_epoch"] / mix["accumulate"])}


def setup(ctx) -> State:
    from ecs_yolo_tpu_torch.train import trainer
    from ecs_yolo_tpu_torch.train.optim import build_optimizer

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    st = State()
    st.b, st.size = mix["batch"], cfg["imgsz"]
    st.sched = sch = _schedule(ctx)
    hyp = sch["hyp"]
    st.batches = make_batches(mix["batches"], st.b, st.size, cfg["nc"], mix["max_boxes"],
                              ctx.seed, dev)
    model = weights.program(cfg, st.size, dev, weights.make(cfg, ctx.seed, dev))
    tx = build_optimizer(
        dict(model.named_parameters()), name="SGD", lr0=hyp["lr0"], lrf=hyp["lrf"],
        momentum=hyp["momentum"], weight_decay=sch["weight_decay"], epochs=sch["epochs"],
        steps_per_epoch=sch["steps_per_epoch"], cos_lr=True,
        warmup_epochs=hyp["warmup_epochs"], warmup_momentum=hyp["warmup_momentum"],
        warmup_bias_lr=hyp["warmup_bias_lr"], accumulate=mix["accumulate"],
        warmup_floor=sch["warmup_floor"])
    state = trainer.create_train_state(model, tx, device=dev)
    state.opt_state.count.fill_(sch["start"])
    state.step.fill_(sch["start"] * mix["accumulate"])
    st.step = trainer.make_train_step(model, tx, hyp, compute_dtype=getattr(
        torch, cfg["dtypes"]["train_compute"]), accumulate=mix["accumulate"], device=dev)
    st.model, st.state = model, state
    # the check's micro-steps, which are also the warm-up; the spikes of
    # every neuron site kept on the host for the reference to follow
    st.losses, st.spikes = [], []
    sites = [(n, m) for n, m in model.named_modules() if type(m).__name__ == "MemUpdate"]
    for i in range(mix["check_steps"]):
        seen = {}
        hooks = [m.register_forward_hook(
            lambda mod, inp, out, n=n: seen.__setitem__(n, out.detach().to(torch.uint8).cpu()))
            for n, m in sites]
        st.state, m = st.step(st.state, *st.batches[i])
        for h in hooks:
            h.remove()
        st.spikes.append(seen)
        st.losses.append(m["loss"].detach().clone())
        if i == 0:
            st.grad1 = {k: v.detach().clone() for k, v in st.state.opt_state.acc.items()}
    st.after = {"params": {k: v.detach().clone() for k, v in st.state.params.items()},
                "ema": {k: v.detach().clone() for k, v in st.state.ema_params.items()}}
    st.errors0 = int(st.state.opt_state.errors)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return st


def measure(ctx, st) -> Dict:
    from ecs_yolo_tpu_torch.snn import spread as S

    rec, mix, dev = ctx.recorder, ctx.mix, ctx.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    end_trace = mix["trace_from"] + mix["trace_steps"]
    issue, n, at = [], 0, None
    t0 = time.perf_counter()
    while True:
        if rec.traced and n == mix["trace_from"]:
            sync()
            rec.start()
            at = (S.binary_dw3_conv.launches, S.packed_spread.launches)
        after_trace = rec.traced and rec.profiled
        if after_trace:                 # the host's issue from an idle card
            sync()
        ts = time.perf_counter()
        with rec.span("step"):
            st.state, _ = st.step(st.state, *st.batches[(mix["check_steps"] + n)
                                                        % len(st.batches)])
        if after_trace:
            issue.append(time.perf_counter() - ts)
        n += 1
        if rec.traced and not rec.profiled and n == end_trace:
            with rec.span("sync"):
                sync()
            launches = (S.binary_dw3_conv.launches - at[0], S.packed_spread.launches - at[1])
            rec.stop()
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    with rec.span("sync"):
        sync()
    elapsed = time.perf_counter() - t0
    failed = int(st.state.opt_state.errors) - st.errors0
    record = {"steps": n, "images_per_step": st.b, "window_s": elapsed,
              "host_issue_s": issue}
    if rec.profiled:
        shapes = model_shapes(ctx.config, st.size)
        steps = mix["trace_steps"]
        bounds = spread_bounds(shapes, ctx.config["T"], st.b, ctx.config["dtypes"]["train_compute"])
        record.update({
            "trace": rec.reduce(), "steps_traced": steps,
            "flops_traced": 3 * forward_flops(shapes) * st.b * steps,
            "k4": {"launches": launches[0], "expected": bounds["k4"]["launches"] * steps,
                   "bound_s": bounds["k4"]["bound_s"] * steps},
            "k5": {"launches": launches[1], "expected": bounds["k5"]["launches"] * steps,
                   "bound_s": bounds["k5"]["bound_s"] * steps}})
    return {"e2e": {"train_img_s": st.b * n / elapsed}, "attempted": n, "failed": failed,
            "record": record}


def release(ctx, st) -> None:
    del st.model, st.state, st.step
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def _reference_steps(ctx, st, quant=None, fault=None) -> Dict:
    """The check's micro-steps from the seeded weights: each step's loss,
    the first micro-gradient, the parameters' and the EMA's change after
    the last step, and each leaf's largest applied mean gradient norm.
    ``quant`` computes the forward and backward in lower precision (the
    control), ``fault`` plants a fault in the optimizer (``sgd_apply``)."""
    cfg, dev, acc = ctx.config, ctx.device, ctx.mix["accumulate"]
    ref = weights.reference(cfg, dev)
    ref.load_state_dict(weights.make(cfg, ctx.seed, dev))
    ref.train()
    ref.remat = ctx.mix.get("reference_remat", True)
    head = ref.model[-1]
    params = dict(ref.named_parameters())
    names = list(params)
    p0 = {k: p.detach().clone() for k, p in params.items()}
    ema = {k: p.detach().clone() for k, p in params.items()}

    sites = {n: m for n, m in ref.named_modules() if isinstance(m, MemUpdate)}

    def loss_of(i):
        imgs, targets, mask = st.batches[i]
        if set(st.spikes[i]) != set(sites):
            return float("inf"), None
        for n, m in sites.items():
            m.forced = st.spikes[i][n].to(dev).permute(0, 1, 4, 2, 3)
        x = imgs.permute(0, 3, 1, 2).float() / 255.0
        maps = ref(x, quant)
        total, _ = v1_loss(maps, targets, mask, head.anchors_px, head.strides,
                           st.sched["hyp"], cfg["nc"])
        # the forced spikes stay set: the backward recomputes the walk
        gs = dict(zip(names, torch.autograd.grad(
            total, [params[k] for k in names], allow_unused=True, materialize_grads=True)))
        for m in sites.values():
            m.forced = None
        return float(total.detach()), gs

    losses, window, buf, grad1 = [], [], None, None
    gnorm = {k: 0.0 for k in names}
    for i in range(len(st.spikes)):
        loss, g = loss_of(i)
        if g is None:
            return {}
        losses.append(loss)
        grad1 = g if grad1 is None else grad1
        window.append(g)
        if len(window) < acc:
            continue
        count = st.sched["start"] + (i + 1) // acc - 1
        gmean = {k: sum(w[k] for w in window) / acc for k in names}
        change, buf = sgd_apply({k: p.detach() for k, p in params.items()}, gmean, buf,
                                count, st.sched, fault)
        with torch.no_grad():
            for k, p in params.items():
                p.add_(change[k])
        ema_apply(ema, params, count + 1)
        for k, v in gmean.items():
            gnorm[k] = max(gnorm[k], float(torch.linalg.vector_norm(v)))
        window = []
    out = {"losses": losses, "grad1": grad1, "gnorm": gnorm,
           "change": {k: params[k].detach() - p0[k] for k in names},
           "ema": {k: ema[k] - p0[k] for k in names}}
    del ref
    return out


def _moved(gnorm: Dict[str, float]):
    """Leaves whose largest applied reference gradient is more than a
    thousandth of the median leaf's: the others move by round-off alone."""
    med = statistics.median(gnorm.values())
    return [k for k, v in gnorm.items() if v > 1e-3 * med]


def _numbers(got: Dict, want: Dict) -> Dict[str, float]:
    if not got or not want:
        return {k: float("inf") for k in ("loss_gap", "grad_gap", "grad_gap_median",
                                          "change_gap", "change_gap_median", "ema_gap")}
    leaves = list(want["grad1"])
    moved = _moved(want["gnorm"])
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["losses"], want["losses"]))
    g = compare.norm_gap(got["grad1"], want["grad1"], leaves)
    c = compare.norm_gap(got["change"], want["change"], moved)
    e = compare.norm_gap(got["ema"], want["ema"], moved)
    return {"loss_gap": loss if loss == loss else float("inf"), "grad_gap": g["worst"],
            "grad_gap_median": g["median"], "change_gap": c["worst"],
            "change_gap_median": c["median"], "grad_gap_mean": g["mean"],
            "change_gap_mean": c["mean"], "ema_gap": e["worst"],
            "ema_gap_median": e["median"], "grad_gap_leaf": g["leaf"],
            "change_gap_leaf": c["leaf"], "ema_gap_leaf": e["leaf"]}


def _want(ctx, st) -> Dict:
    try:
        return _reference_steps(ctx, st)
    except ValueError as e:     # the program's spikes do not fit its batch
        print(f"train check: {e}", file=sys.stderr)
        return {}


def check(ctx, st) -> Dict[str, float]:
    with compare.exact_float32():
        want = _want(ctx, st)
        p0 = weights.make(ctx.config, ctx.seed, ctx.device)
    got = {"losses": [float(v) for v in st.losses], "grad1": st.grad1,
           "change": {k: v - p0[k] for k, v in st.after["params"].items()},
           "ema": {k: v - p0[k] for k, v in st.after["ema"].items()}}
    return _numbers(got, want)


def control(ctx, st, faults: bool = True) -> Dict[str, Dict[str, float]]:
    """The readings that bound the limits: the reference in fp8 in the
    program's place (``control``), and (``faults``) the reference with each
    fault of ``FAULTS`` planted in its optimizer."""
    with compare.exact_float32():
        want = _want(ctx, st)
        out = {"control": _numbers(_reference_steps(ctx, st, fp8_quant), want)}
        for f in FAULTS if faults else ():
            out[f"fault.{f}"] = _numbers(_reference_steps(ctx, st, fault=f), want)
    return out
