"""Multi-process (multi-GPU, multi-host) training (counterpart of
``ecs_yolo_tpu/parallel/multihost.py``; reference ``torch.distributed.run``
env probing train.py:58-60, the NCCL/Gloo process group train.py:927, the
DistributedSampler utils/datasets.py:95-156, rank-0-only checkpoints and
logs train.py:630-676, and the v2 early-stop broadcast train2.py:391-394).

One process drives one GPU.  ``initialize`` joins the process group (NCCL
on the card, gloo on the CPU) from explicit arguments or torchrun's
environment, and binds ``cuda:LOCAL_RANK``; ``local_batch_slice`` is this
rank's contiguous rows of every global batch (every rank walks the same
seeded batch plan, ``data/dataset.Dataset.batches(host_shard=)``);
``is_main`` gates checkpoints and logs; ``broadcast_scalar`` sends rank 0's
value to every rank.

Without an initialised group each function is the one-process answer, so
the train driver has one code path.  JAX's ``to_global`` (host rows -> one
globally sharded array) has no counterpart: each process already holds its
local rows, and the step all-reduces over them (``parallel/mesh``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None,
               device: Optional[str] = None,
               timeout: Optional[datetime.timedelta] = None) -> torch.device:
    """Join the process group; returns this rank's device.

    The arguments default to torchrun's ``RANK`` / ``WORLD_SIZE``, and
    ``init_method`` to ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``); a
    ``file://`` or ``tcp://`` method may be given.  ``device`` is
    ``"cuda"`` unless given (``"cpu"`` for a CPU group): on the card the
    group is NCCL and the rank binds ``cuda:LOCAL_RANK``; on the CPU it is
    gloo.  ``timeout`` bounds each collective (the backend's default when
    None).  A second call in a process whose group is up returns the
    device and joins nothing."""
    dev_type = torch.device(device).type if device is not None else "cuda"
    local = int(os.environ.get("LOCAL_RANK", 0))
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA process group was asked for, but CUDA is "
                               "not available; pass device='cpu' for gloo")
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    else:
        dev = torch.device(dev_type)
    if initialized():
        return dev
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if init_method is None:
        init_method = "env://"
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, **kw)
    return dev


def rank_world() -> tuple:
    """``(rank, world size)``; ``(0, 1)`` without a group."""
    if not initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_main() -> bool:
    """Rank-0 guard of checkpoints, logs and the val metrics (reference
    ``RANK in {-1, 0}``)."""
    return rank_world()[0] == 0


def local_batch_slice(global_batch: int, rank: Optional[int] = None,
                      world: Optional[int] = None) -> slice:
    """This rank's contiguous rows of every global batch (the
    DistributedSampler equivalent: each rank sees 1/world of the data);
    raises where the world does not divide the batch."""
    r, w = rank_world()
    rank = r if rank is None else rank
    world = w if world is None else world
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by {world} hosts")
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)


def broadcast_scalar(value: float) -> float:
    """Rank 0's ``value`` on every rank (the reference's early-stop
    broadcast, train2.py:391-394), through ``dist.broadcast`` of a float64
    tensor on the group's device; ``value`` itself without a group."""
    if not initialized():
        return value
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([float(value)], dtype=torch.float64, device=dev)
    dist.broadcast(t, src=0)
    return float(t.item())


def broadcast_object(obj):
    """Rank 0's ``obj`` (any picklable value: a path, the anchors, a
    checkpoint's tensors) on every rank (``dist.broadcast_object_list``);
    ``obj`` itself without a group."""
    if not initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
