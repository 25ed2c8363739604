"""The plain-LIF kernel (K6) and the shared-state ECS-LIF kernel (K3) on one
card at the EMS-ResNet10@640 neuron-site shapes, per shape and summed over
one forward.

    python ecs_yolo_tpu_torch/scripts/bench_lif.py {lif,k3} [--root TREE]

Run as a file, not with ``-m``: ``--root`` names the checkout whose
``ecs_yolo_tpu_torch`` is imported (this one by default), so that two
versions of a kernel can be timed in one run on one card, each from its own
tree, in turns.  The timing helpers are ``bench_spread.py``'s.  Sites are
N=8, T=4; the site behind the stem reads x broadcast over T, as on the
model path.  One JSON line, with the card's ``nvidia-smi`` name and power
limit.  Needs a card.

``lif`` (``snn.fused.lif_fused``): per shape, both dtypes, x dense and x a
broadcast: ``graph_ms``, the device time of one call from 20 calls captured
in one CUDA graph and replayed; ``eager_ms``, the same calls eager, back to
back; ``host_issue_ms``, their difference; the bound (x read once, one
plane for a broadcast, spikes written once, over 3.35 TB/s); the share of
spikes differing from ``lif_reference``.  Then the sums over one plain-LIF
forward (bf16, 24 launches).  Exits 1 where a spike differs.

``k3`` (``snn.fused.ecs_lif_fused_v2``): per shape, both dtypes, ``ms`` (CUDA
events around 3 eager calls after a warm-up) and the share of spikes
differing from ``ecs_lif_rows_reference``; the sum over one forward's 24
site shapes (bf16).  Exits 1 beyond a share of 1e-4 (f32) / 1e-2 (bf16).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import torch

try:
    from . import bench_spread as BS
except ImportError:          # run as a file
    import bench_spread as BS

T, N = 4, 8
#: [H, W, C] of the res10@640 neuron sites and their count in one forward
SITES = {(320, 320, 64): 1, (160, 160, 64): 4, (80, 80, 128): 3, (40, 40, 384): 2,
         (40, 40, 256): 4, (20, 20, 1024): 1, (20, 20, 512): 4, (20, 20, 256): 4,
         (20, 20, 128): 1}
#: the site whose input is a broadcast over T (behind the stem)
BROADCAST = (320, 320, 64)
SPIKE_BOUND = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def bench_lif(FZ, cfg) -> tuple:
    rows, ok = [], True
    for dtype in (torch.float32, torch.bfloat16):
        item = torch.tensor([], dtype=dtype).element_size()
        for i, ((h, w, c), count) in enumerate(SITES.items()):
            shape = (T, N, h, w, c)
            dense = (BS.rand_fn(200 + i)(*shape) * 3 - 1).to(dtype)
            for bcast in (False, True):
                x = dense[:1].expand(*shape) if bcast else dense
                call = lambda: FZ.lif_fused(x, cfg)
                share = float((call() != FZ.lif_reference(x, cfg)).float().mean())
                graph, eager = BS.graph_ms(call), BS.cuda_ms(call, BS.GRAPH_REPS)
                m = math.prod(shape[1:])
                bound = ((1 if bcast else T) + T) * m * item / BS.HBM_BPS * 1e3
                rows.append({"dtype": str(dtype)[6:], "shape": list(shape),
                             "x_broadcast_over_t": bcast, "sites": count,
                             "mismatch_share": share, "graph_ms": graph, "eager_ms": eager,
                             "host_issue_ms": eager - graph, "bound_ms": bound})
                ok &= share == 0.0
            del dense, x
    forward = [r for r in rows if r["dtype"] == "bfloat16"
               and r["x_broadcast_over_t"] == (tuple(r["shape"][2:]) == BROADCAST)]
    return {"sites": rows, "plain_lif_forward": BS.sums(
        forward, [r["sites"] for r in forward],
        ("graph_ms", "eager_ms", "host_issue_ms", "bound_ms"))}, ok


def bench_k3(FZ, cfg) -> tuple:
    rows, ok = [], True
    for dtype in (torch.float32, torch.bfloat16):
        for i, ((h, w, c), count) in enumerate(SITES.items()):
            shape = (T, N, h, w, c)
            r = BS.rand_fn(500 + i)
            x, *params = [a.to(dtype) for a in (
                r(*shape) * 2 - 0.5, (r(3, 3, 1, c) - 0.5) * 0.4, (r(c) - 0.5) * 0.2,
                (r(1, 1, c, c) - 0.5) * 0.2, (r(c) - 0.5) * 0.2)]
            if (h, w, c) == BROADCAST:
                x = x[:1].expand(*shape)
            call = lambda: FZ.ecs_lif_fused_v2(x, *params, cfg)
            share = float((call() != FZ.ecs_lif_rows_reference(x, *params, cfg))
                          .float().mean())
            rows.append({"dtype": str(dtype)[6:], "shape": list(shape), "sites": count,
                         "mismatch_share": share, "ms": BS.cuda_ms(call, 3)})
            ok &= share <= SPIKE_BOUND[dtype]
            del x, params
    forward = [r for r in rows if r["dtype"] == "bfloat16"]
    return {"sites": rows, "forward_24_sites": BS.sums(
        forward, [r["sites"] for r in forward], ("ms",))}, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=("lif", "k3"))
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                    help="checkout whose ecs_yolo_tpu_torch is timed")
    opt = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_lif: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(opt.root.resolve()))
    from ecs_yolo_tpu_torch.config import SNNConfig
    from ecs_yolo_tpu_torch.snn import fused as FZ

    with torch.no_grad():
        if opt.kernel == "lif":
            res, ok = bench_lif(FZ, SNNConfig(time_window=T, ecs=False))
        else:
            res, ok = bench_k3(FZ, SNNConfig(time_window=T))
    print(json.dumps({"kernel": opt.kernel, "root": str(opt.root), "module": FZ.__file__,
                      "nvidia_smi": BS.smi(), **res}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
