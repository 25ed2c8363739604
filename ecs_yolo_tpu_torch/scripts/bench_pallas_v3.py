"""The fused ECS-LIF kernel against the eager T-loop: the port of
``scripts/bench_pallas_v3.py`` (its ``compare`` mode).

    python -m ecs_yolo_tpu_torch.scripts.bench_pallas_v3 [--device cpu] [--iters N] [--shape T N H W C]

At the script's stem-sized site ``[4, 16, 320, 320, 64]`` in bf16, with
inputs from numpy seed 0 as the JAX script makes them, it prints the share of
spikes on which K1 (``snn/ecs_lif.ecs_lif_fused``, ``csrc/ecs_lif.cu``) and
the eager ``snn/neuron.ecs_lif_scan`` with the library's convolutions
disagree, then both times (CUDA events over ``--iters`` calls after one
warm-up).  ``--device cpu`` compares only: there K1's wrapper takes its plain
version, and a CPU run measures no card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..config import SNNConfig
from ..snn.ecs_lif import ecs_lif_fused
from ..snn.neuron import ecs_lif_scan, make_spread
from .bench_pallas_dw import cuda_ms

SHAPE = (4, 16, 320, 320, 64)


def site_inputs(shape, device, dtype=torch.bfloat16):
    """x and the four spread parameters, as the JAX script draws them."""
    t, n, h, w, c = shape
    rng = np.random.RandomState(0)
    arrays = (rng.rand(t, n, h, w, c), (rng.rand(3, 3, 1, c) - 0.5) * 0.2,
              (rng.rand(c) - 0.5) * 0.1, (rng.rand(1, 1, c, c) - 0.5) * 0.05,
              (rng.rand(c) - 0.5) * 0.1)
    return [torch.from_numpy(a).to(device, dtype) for a in arrays]


def compare(shape=SHAPE, device="cuda", iters: int = 8) -> dict:
    """K1 against the eager scan on the same inputs; times on the card only."""
    x, *params = site_inputs(shape, device)
    cfg = SNNConfig(time_window=shape[0])
    spread = make_spread(*params)
    scan = lambda: ecs_lif_scan(x, spread, cfg)
    kernel = lambda: ecs_lif_fused(x, *params, cfg)
    with torch.no_grad():
        mismatch = float((scan() != kernel()).float().mean())
        print(f"spike mismatch: {mismatch:.6f}", flush=True)
        rec = {"shape": list(shape), "dtype": "bfloat16", "spike_mismatch": mismatch}
        if torch.device(device).type != "cuda":
            print("times: not measured (no card)")
            return rec
        scan_ms, k1_ms = cuda_ms(scan, iters), cuda_ms(kernel, iters)
    print(f"eager scan:    {scan_ms:.2f} ms")
    print(f"ecs_lif_fused: {k1_ms:.2f} ms   ({scan_ms / k1_ms:.2f}x)", flush=True)
    return {**rec, "scan_ms": scan_ms, "ms": k1_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--iters", type=int, default=8, help="timed calls of each")
    ap.add_argument("--shape", type=int, nargs=5, default=list(SHAPE),
                    metavar=("T", "N", "H", "W", "C"))
    opt = ap.parse_args(argv)
    from ..device import resolve_device

    device = resolve_device(opt.device)
    if device.type == "cuda":
        print(torch.cuda.get_device_name(device), flush=True)
    compare(tuple(opt.shape), device, opt.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
