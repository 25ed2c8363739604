"""The training step (counterpart of ``ecs_yolo_tpu/train/trainer.py``).

One step: forward in training mode, the head's loss, gradients onto the
float32 master parameters, the three-group optimizer update, the EMA.  BN
runs with whole-batch statistics.  The state is updated in place (parameters
are the model's own tensors): PyTorch has no donation to ask for.

bf16 compute keeps float32 masters as the JAX step does: every float32
parameter is cast to the compute dtype at the apply boundary (the model is
called through ``torch.func.functional_call`` on the cast copies, so the
gradients flow back through the casts onto the masters), the image is cast,
BN keeps float32 statistics inside ``_BN``, and the head outputs return to
float32 before the loss.  ``torch.autocast`` is not used: its per-operation
policy is a different function.

A parameter that takes no part in the loss gets a zero gradient, as under
``jax.value_and_grad``: at ``time_window=1`` no step reads a spike of the
step before, so the spread parameters of every ECS-LIF site are unused.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Union

import torch
from torch.func import functional_call

from ..device import resolve_device
from ..models.yolo import DetectionModel
from .ema import ema_update
from .loss_tal import (compute_loss_dual, compute_loss_tal, compute_loss_triple,
                       compute_loss_v10)
from .loss_v1 import compute_loss_v1
from .optim import OptState, Optimizer
from .sparsity import add_l1_subgradient, sparsity_rate


@dataclasses.dataclass
class TrainState:
    """params: torch name -> float32 master parameter (the model's own
    tensors); batch_stats: name -> BN running statistic (the model's own
    buffers); opt_state; ema_params: name -> EMA copy; step: 0-d int64 count
    of steps taken."""

    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: OptState
    ema_params: Dict[str, torch.Tensor]
    step: torch.Tensor


def _check_device(model: DetectionModel,
                  device: Optional[Union[str, torch.device]]) -> torch.device:
    dev = resolve_device(device)
    at = next(model.parameters()).device
    if at.type != dev.type:
        raise ValueError(f"the model lies on {at}, the step was asked for {dev}")
    return at


def create_train_state(model: DetectionModel, tx: Optimizer,
                       device: Optional[Union[str, torch.device]] = None) -> TrainState:
    """The state of a model about to train, on the CUDA card unless
    ``device="cpu"`` (the model must already lie there)."""
    dev = _check_device(model, device)
    params = dict(model.named_parameters())
    return TrainState(
        params=params,
        batch_stats=dict(model.named_buffers()),
        opt_state=tx.init(params),
        ema_params={k: p.detach().clone() for k, p in params.items()},
        step=torch.zeros((), dtype=torch.int64, device=dev),
    )


def make_loss_fn(model: DetectionModel, hyp: Mapping[str, float]) -> Callable:
    """Head-appropriate loss closure ``loss(out, targets, t_mask) -> (total,
    items)``, dispatched on the head name as JAX's: the v1 loss, the TAL loss
    (``DDetect`` / ``ASFF_DDetect``, with the hyp's box/cls/dfl gains), the
    v10 loss, the dual and the triple losses (their gains fixed, as JAX
    has them)."""
    head = model.head_info["name"]
    nc = model.head_info["nc"]
    strides = model.head_info["strides"]
    if head == "Detect":
        det = model.model[-1]
        anchors = {}    # per (dtype, device): made once, not copied over per step

        def loss(out, targets, t_mask):
            key = (out[0].dtype, out[0].device)
            if key not in anchors:
                anchors[key] = torch.tensor(det.anchors, dtype=key[0],
                                            device=key[1]).reshape(det.nl, -1, 2)
            return compute_loss_v1(out, targets, t_mask, anchors[key], hyp, nc)

    elif head in ("DDetect", "ASFF_DDetect"):
        gains = (hyp.get("box", 7.5), hyp.get("cls", 0.5), hyp.get("dfl", 1.5))

        def loss(out, targets, t_mask):
            return compute_loss_tal(out, targets, t_mask, strides, nc, gains=gains)

    elif head in ("v10Detect", "ASFF_v10Detect"):

        def loss(out, targets, t_mask):
            return compute_loss_v10(out, targets, t_mask, strides, nc)

    elif head in ("DualDetect", "DualDDetect"):

        def loss(out, targets, t_mask):
            return compute_loss_dual(out[0], out[1], targets, t_mask, strides, nc)

    elif head in ("TripleDetect", "TripleDDetect"):

        def loss(out, targets, t_mask):
            return compute_loss_triple(out, targets, t_mask, strides, nc)

    else:
        raise KeyError(f"{head}: its loss is not ported yet (ROADMAP Queue 1 item 11)")
    return loss


def _tree_map(fn, tree):
    """``fn`` on every tensor of a head output: nested lists, tuples and
    named tuples (``V10Output``) keep their types."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def make_grad_fn(model: DetectionModel, hyp: Mapping[str, float],
                 compute_dtype: torch.dtype = torch.float32):
    """``grad_fn(state, images, targets, t_mask) -> (total, items, grads)``:
    the training-mode forward (BN running statistics move), the loss and its
    gradients onto the master parameters, by torch name."""
    loss_fn = make_loss_fn(model, hyp)
    f32 = torch.float32

    def grad_fn(state: TrainState, images, targets, t_mask):
        if images.dtype == torch.uint8:
            images = images.to(f32) / 255.0
        apply_params = state.params
        if compute_dtype != f32:
            apply_params = {k: v.to(compute_dtype) if v.dtype == f32 else v
                            for k, v in state.params.items()}
        model.train()
        with torch.enable_grad():
            out = functional_call(model, apply_params,
                                  (images.to(compute_dtype),))
            if compute_dtype != f32:
                out = _tree_map(lambda o: o.to(f32) if o.dtype == compute_dtype else o,
                                out)
            total, items = loss_fn(out, targets, t_mask)
            total = total.to(f32)
            names = list(state.params)
            grads = torch.autograd.grad(total, [state.params[k] for k in names],
                                        allow_unused=True, materialize_grads=True)
        return total.detach(), items, dict(zip(names, grads))

    return grad_fn


def make_train_step(
    model: DetectionModel,
    tx: Optimizer,
    hyp: Mapping[str, float],
    ema_decay: float = 0.9999,
    compute_dtype: torch.dtype = torch.float32,
    sr: float = 0.0,
    sr_total_steps: int = 1,
    accumulate: int = 1,
    with_masks: bool = False,
    with_semantic: bool = False,
    device: Optional[Union[str, torch.device]] = None,
):
    """Build the train step ``step(state, images, targets, t_mask) ->
    (state, {"loss", "items", "applied", "boundary"})``.

    Batch: images ``[B,H,W,C]`` float 0-1 or uint8 (divided by 255 on the
    device), or an event batch ``[B,T,H,W,C]``; targets ``[B,M,5]`` (cls, x,
    y, w, h normalised); t_mask ``[B,M]``.  The metrics are tensors on the
    device; nothing in the step waits for it.

    ``accumulate=k`` must be the optimizer's: every call is a micro-step
    (the BN running statistics move on each), the optimizer applies on every
    k-th (``boundary`` True, ``applied`` its 0-d flag; else None), and the
    EMA moves only there, with ``step // k`` applies as its decay ramp
    counter (reference ModelEMA updates once per optimizer step).

    ``sr > 0`` adds the network-slimming L1 subgradient to every
    micro-gradient before the optimizer (``train/sparsity.py``): ``srtmp *
    sign(p)`` on the BN scales, ``srtmp = sr * (1 - 0.9 * clip(step /
    sr_total_steps, 0, 1))`` from the device ``step``, and ``10 * sr *
    sign(p)`` on the BN biases.
    """
    if with_masks or with_semantic:
        raise NotImplementedError("instance masks and semantic maps are not "
                                  "ported yet (ROADMAP Queue 1 item 11)")
    if accumulate != tx.accumulate:
        raise ValueError(f"accumulate={accumulate}, but the optimizer was built "
                         f"with accumulate={tx.accumulate}")
    _check_device(model, device)
    grad_fn = make_grad_fn(model, hyp, compute_dtype)

    def step_fn(state: TrainState, images, targets, t_mask):
        total, items, grads = grad_fn(state, images, targets, t_mask)
        if sr > 0:
            srtmp = sparsity_rate(sr, state.step.to(torch.float32)
                                  / max(sr_total_steps, 1))
            grads = add_l1_subgradient(grads, state.params, srtmp, sr)
        applied, boundary = tx.update(state.params, grads, state.opt_state)
        state.step += 1
        if boundary:
            applies = torch.div(state.step, accumulate, rounding_mode="floor")
            ema_update(state.ema_params, state.params, applies, decay=ema_decay)
        return state, {"loss": total, "items": items, "applied": applied,
                       "boundary": boundary}

    return step_fn
