"""The ``(data, model)`` layout of a process group and the sharding of the
train state over it (counterpart of ``ecs_yolo_tpu/parallel/mesh.py``).

JAX puts one program over a device mesh and lets XLA insert the
collectives.  Here one process drives one GPU, and the collectives are
written out:

* ``Layout``: rank ``r`` sits at ``data = r // mp``, ``model = r % mp``,
  as ``make_mesh_2d``'s ``reshape(-1, mp)`` puts it.  The ranks of one
  model index form a data group (they hold different rows of the global
  batch); the ranks of one data index form a model group (they hold the
  same rows, and each a slice of the sharded leaves).
* ``data_parallel(layout)``: while the step computes its loss, the batch
  statistics (``nn/blocks._BN``, ``DSSA``'s firing rates) and the losses'
  denominators reduce over the data group (``data_sum``, ``global_mean``,
  ``global_batch``), so every rank's loss is its part of the global-batch
  loss and the data group's summed gradient is JAX's gradient of that
  loss.  Outside it, or over one data rank, each helper is the identity
  and the step is the one-process step, bit for bit.
* ``shard_rule`` / ``shard_plan``: JAX's ``shard_params`` rule (rank >= 2,
  the output-channel dim divides by ``mp`` and is >= ``max(mp,
  min_last)``), applied to each parameter in the JAX layout the
  converter's ``_layout`` maps from (a conv's or linear's output channel is
  the port's dim 0, JAX's trailing dim).  ``shard_state`` keeps each
  model rank's slice of those leaves in the parameters, the optimizer
  state and the EMA (JAX's ZeRO-3-style placement); ``gather_params`` /
  ``gather_state`` all-gather them back.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from .multihost import initialized


@dataclasses.dataclass(frozen=True)
class Layout:
    """A ``(data, model)`` layout of the initialised process group."""

    world: int
    rank: int
    mp: int
    data_group: object          # this rank's data group (WORLD when mp == 1)
    model_group: object         # this rank's model group (None when mp == 1)

    @property
    def data_index(self) -> int:
        return self.rank // self.mp

    @property
    def model_index(self) -> int:
        return self.rank % self.mp

    @property
    def data_size(self) -> int:
        return self.world // self.mp

    @property
    def host_shard(self) -> Tuple[int, int]:
        """``(data index, data extent)``: this rank's rows of every batch."""
        return self.data_index, self.data_size


def make_layout(model_parallel: int = 1) -> Optional[Layout]:
    """The layout of the initialised group with ``model_parallel`` ranks on
    the model axis; None without a group (and ``model_parallel`` 1).  Every
    rank must call it, in the same order as its other group calls: the
    subgroups are made collectively."""
    mp = max(int(model_parallel), 1)
    if not initialized():
        if mp > 1:
            raise ValueError(f"model_parallel={mp} needs an initialised process "
                             "group of a multiple of that many ranks")
        return None
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % mp:
        raise ValueError(f"{world} ranks not divisible by model_parallel={mp}")
    if mp == 1:
        return Layout(world, rank, 1, dist.group.WORLD, None)
    data_group = model_group = None
    for m in range(mp):                       # every rank makes every group
        g = dist.new_group([d * mp + m for d in range(world // mp)])
        if rank % mp == m:
            data_group = g
    for d in range(world // mp):
        g = dist.new_group([d * mp + m for m in range(mp)])
        if rank // mp == d:
            model_group = g
    return Layout(world, rank, mp, data_group, model_group)


# -- the data axis of the step being computed ----------------------------------

_ACTIVE: Optional[Layout] = None


@contextlib.contextmanager
def data_parallel(layout: Optional[Layout]):
    """Within: the batch statistics and loss denominators reduce over
    ``layout``'s data group.  A module global, not thread-local: the
    backward pass (and a ``checkpointed`` recompute in it) may run on
    another thread."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, layout
    try:
        yield
    finally:
        _ACTIVE = prev


def data_size() -> int:
    """Data ranks of the step being computed (1 outside ``data_parallel``)."""
    return 1 if _ACTIVE is None else _ACTIVE.data_size


def data_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data ranks, detached (a denominator); ``t``
    itself over one."""
    if data_size() == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=_ACTIVE.data_group)
    return t


def data_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data ranks, with a backward that sums the
    upstream gradient over them (``torch.distributed.nn.functional
    .all_reduce``): for a term that enters every rank's part of the loss
    (the BN moments, the slide loss's mean IoU, the dice sums)."""
    if data_size() == 1:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=_ACTIVE.data_group)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's part of the mean of ``x`` over the global batch (equal
    shards): ``x.sum() / (x.numel() * data ranks)``; ``x.mean()`` over one."""
    n = data_size()
    return x.mean() if n == 1 else x.sum() / (x.numel() * n)


def global_batch(b: int) -> int:
    """The global batch of a local batch of ``b`` rows."""
    return b * data_size()


# -- the model axis: JAX's shard_params rule on the port's parameters ----------

def jax_layouts(model: torch.nn.Module) -> Dict[str, Tuple[int, int, int]]:
    """Per parameter name ``(rank, trailing extent, dim)``: the rank and the
    trailing (output-channel) extent of the leaf in the JAX layout, and the
    port dim that trailing dim becomes (``models/convert._layout``): a conv
    kernel (HWIO -> OIHW; 1-D ``[k, I, O]`` -> ``[O, I, k]``; ``HetConv``'s
    ``w3``) and a ``Dense`` kernel (``[in, out]`` -> ``[out, in]``) put it at
    dim 0; an attention's query / key / value kernel ``[C, heads,
    head_dim]`` and bias ``[heads, head_dim]`` become ``[C, C]`` and ``[C]``
    with ``head_dim`` the trailing extent (dim 0, whole heads per slice);
    a leaf kept as it is (``pos``, ``DynamicConv2d``'s banks, slopes, BN
    vectors) keeps its last dim."""
    from torch.nn.modules.conv import _ConvNd

    from ..nn.blocks_ext import _MultiHeadAttention
    from ..nn.blocks_tail2 import HetConv

    heads = {}
    for name, m in model.named_modules():
        if isinstance(m, _MultiHeadAttention):
            for proj in ("query", "key", "value"):
                heads[f"{name}.{proj}" if name else proj] = m.h
    out = {}
    for mname, m in model.named_modules():
        for leaf, p in m.named_parameters(recurse=False):
            name = f"{mname}.{leaf}" if mname else leaf
            s = tuple(p.shape)
            if mname in heads:
                h = heads[mname]
                out[name] = (p.dim() + 1, s[0] // h, 0)
            elif leaf == "weight" and isinstance(m, (_ConvNd, HetConv, torch.nn.Linear)):
                # Detect's w{i} [1,1,T,1] -> [1,T,1,1,1]: the trailing 1 at dim 0
                out[name] = (4 if p.dim() == 5 else p.dim(), s[0], 0)
            else:
                out[name] = (p.dim(), s[-1] if s else 1, max(p.dim() - 1, 0))
    return out


def shard_rule(name: str, shape, mp: int, min_last: int = 0,
               layout: Optional[Tuple[int, int, int]] = None) -> Optional[int]:
    """The dim of parameter ``name`` (port ``shape``) that JAX's
    ``shard_params`` shards over ``mp`` model ranks, or None (replicated).
    ``layout`` is its ``jax_layouts`` entry; without it the leaf is taken
    as out-first (a conv or linear weight: JAX's trailing dim is dim 0, the
    rank kept).  JAX's rule: rank >= 2 and the trailing extent divides by
    ``mp`` and is at least ``max(mp, min_last)``."""
    shape = tuple(shape)
    rank, extent, dim = layout or (len(shape), shape[0] if shape else 1, 0)
    if rank >= 2 and extent % mp == 0 and extent >= max(mp, min_last):
        return dim
    return None


def shard_plan(model: torch.nn.Module, mp: int, min_last: int = 0) -> Dict[str, int]:
    """``{name: dim}`` of the parameters sharded over ``mp`` model ranks."""
    if mp <= 1:
        return {}
    lay = jax_layouts(model)
    plan = {}
    for name, p in model.named_parameters():
        d = shard_rule(name, p.shape, mp, min_last, lay[name])
        if d is not None:
            plan[name] = d
    return plan


def _slice(t: torch.Tensor, dim: int, layout: Layout) -> torch.Tensor:
    return t.detach().chunk(layout.mp, dim)[layout.model_index].contiguous().clone()


def shard_tree(tree: Optional[Mapping[str, torch.Tensor]], plan: Mapping[str, int],
               layout: Optional[Layout]):
    """This model rank's slices of the planned leaves of ``tree``; the other
    leaves as they are."""
    if tree is None or layout is None or layout.mp == 1:
        return tree
    return {k: _slice(v, plan[k], layout) if k in plan else v for k, v in tree.items()}


def gather_tree(tree: Optional[Mapping[str, torch.Tensor]], plan: Mapping[str, int],
                layout: Optional[Layout]):
    """The whole leaves of a sharded ``tree``: one all-gather over the model
    group of all planned slices, flat in one buffer; every model rank calls
    it."""
    if tree is None or layout is None or layout.mp == 1:
        return tree
    names = [k for k in tree if k in plan]
    if not names:
        return dict(tree)
    flat = torch.cat([tree[k].reshape(-1) for k in names])
    parts = [torch.empty_like(flat) for _ in range(layout.mp)]
    dist.all_gather(parts, flat, group=layout.model_group)
    sizes = [tree[k].numel() for k in names]
    pieces = [p.split(sizes) for p in parts]
    out = dict(tree)
    for j, k in enumerate(names):
        out[k] = torch.cat([pc[j].view_as(tree[k]) for pc in pieces], dim=plan[k])
    return out


def shard_state(state, plan: Mapping[str, int], layout: Optional[Layout]):
    """A ``train/trainer.TrainState`` whose parameters, optimizer moments,
    accumulation window and EMA hold this model rank's slices of the
    planned leaves (new tensors; the replicated leaves are the state's)."""
    if layout is None or layout.mp == 1:
        return state
    opt = state.opt_state
    return dataclasses.replace(
        state, params=shard_tree(state.params, plan, layout),
        ema_params=shard_tree(state.ema_params, plan, layout),
        opt_state=dataclasses.replace(
            opt, mu=shard_tree(opt.mu, plan, layout), nu=shard_tree(opt.nu, plan, layout),
            acc=shard_tree(opt.acc, plan, layout)))


def gather_state(state, plan: Mapping[str, int], layout: Optional[Layout]):
    """The whole ``TrainState`` of a sharded one (new tensors where
    gathered): what a checkpoint holds and the val pass loads."""
    if layout is None or layout.mp == 1:
        return state
    opt = state.opt_state
    return dataclasses.replace(
        state, params=gather_tree(state.params, plan, layout),
        ema_params=gather_tree(state.ema_params, plan, layout),
        opt_state=dataclasses.replace(
            opt, mu=gather_tree(opt.mu, plan, layout), nu=gather_tree(opt.nu, plan, layout),
            acc=gather_tree(opt.acc, plan, layout)))
