"""The serving forward of one checkout on one card: EMS-ResNet10@640, T=4,
b8, bf16 parameters (BN statistics float32), random weights from a seed
with the BN statistics calibrated on one batch, every neuron site on the
fused ECS-LIF kernel (K1).

    python ecs_yolo_tpu_torch/scripts/bench_serve.py [--root TREE] [--iters N]

Run as a file, not with ``-m``: ``--root`` names the checkout whose
``ecs_yolo_tpu_torch`` is imported (this one by default), so that two
versions of the serving path can be timed on one card, each from its own
tree, in turns.  Prints one JSON line: the device ms of a forward over
``--iters`` forwards after a warm-up (CUDA events) and its img/s, the
median wall ms of one forward's issue from the host on an idle card,
K1's launches a forward, and the card's ``nvidia-smi`` name and power
limit.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

T, N, IMGSZ, NC = 4, 8, 640, 13


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                    help="checkout whose ecs_yolo_tpu_torch is timed")
    ap.add_argument("--iters", type=int, default=20)
    opt = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_serve: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(opt.root.resolve()))
    from ecs_yolo_tpu_torch import _build
    from ecs_yolo_tpu_torch.models.yolo import build_model, cast_params
    from ecs_yolo_tpu_torch.nn.blocks import _BN
    from ecs_yolo_tpu_torch.snn import ecs_lif as K

    _build.build(["ecs_lif"])
    model = build_model("resnet10.yaml", nc=NC, generator=torch.Generator().manual_seed(0))
    x = torch.rand((N, IMGSZ, IMGSZ, 3), generator=torch.Generator().manual_seed(1)).cuda()
    bns = [m for m in model.modules() if isinstance(m, _BN)]
    for b in bns:           # BN statistics from the batch, so that every site fires
        b.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(x)
    model.eval()
    cast_params(model, torch.bfloat16)
    with torch.no_grad():
        model(x)
        torch.cuda.synchronize()
        K.ecs_lif_fused.launches = 0
        model(x)
        torch.cuda.synchronize()
        launches = K.ecs_lif_fused.launches
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(opt.iters):
            model(x)
        t1.record()
        torch.cuda.synchronize()
        ms = t0.elapsed_time(t1) / opt.iters
        # the host's issue of one forward on an idle card (nothing waits on it)
        host = []
        for _ in range(opt.iters):
            torch.cuda.synchronize()
            w = time.perf_counter()
            model(x)
            host.append((time.perf_counter() - w) * 1e3)
        torch.cuda.synchronize()
    print(json.dumps({"root": str(opt.root), "module": K.__file__, "nvidia_smi": smi(),
                      "cfg": "resnet10.yaml", "batch": N, "imgsz": IMGSZ, "T": T,
                      "dtype": "bfloat16", "iters": opt.iters, "ms_per_forward": ms,
                      "images_per_s": N / ms * 1e3, "host_issue_ms_per_forward":
                      sorted(host)[len(host) // 2], "k1_launches_per_forward": launches}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
