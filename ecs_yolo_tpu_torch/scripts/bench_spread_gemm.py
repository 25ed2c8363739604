"""The fused dw+pw spread product (K5, ``csrc/spread_gemm.cu``) at the
EMS-ResNet10@640 training sites, bf16, N=8: the kernel alone, the wrapper as
the train path calls it, the library call and the bound.

    python ecs_yolo_tpu_torch/scripts/bench_spread_gemm.py [--root TREE] [--iters N]

Run as a file, not with ``-m``: ``--root`` names the checkout whose
``ecs_yolo_tpu_torch`` is imported (this one by default), so that two
versions of the kernel can be timed in one run on one card, each from
its own tree, in turns.  Per site shape it prints the kernel alone
(``_gemm_forward`` on the int8 plane with ``M`` composed once), the
``autograd.Function`` as the train path calls it (the int8 cast and the
kernel), one dense ``F.conv2d`` with the composed kernel and bias on
channels_last (the library call), the bound (bytes over 3.35 TB/s against
operations over 989 TFLOP/s), and the worst difference from the plain
version in bf16 ulps; then the sums over one training forward (3 launches at
320 x 320 and 12 at 160 x 160: 5 sites x 3 steps of T=4).  Times are CUDA
events over ``--iters`` calls after one warm-up; the inputs (13-52 MB) stay
in the 50 MB L2 between calls as they partly do on the path.  One JSON line,
with the card's ``nvidia-smi`` name and power limit.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

#: (shape, launches per training forward)
SITES = (((8, 320, 320, 64), 3), ((8, 160, 160, 64), 12))
HBM_BPS, BF16_FLOPS = 3.35e12, 989e12


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def site(S, shape, iters: int, seed: int) -> dict:
    n, h, w, c = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.rand(*s, generator=g, device="cuda")
    s = (r(*shape) < 0.3).to(torch.bfloat16)
    dw, dwb = (r(3, 3, 1, c) - 0.5) * 0.4, (r(c) - 0.5) * 0.2
    pw, pwb = (r(1, 1, c, c) - 0.5) * 0.2, (r(c) - 0.5) * 0.2
    m, const = S.compose_m(*(a.to(torch.bfloat16) for a in (dw, dwb, pw, pwb)))
    s8 = s.to(torch.int8)
    kc = m.reshape(3, 3, c, c).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    s_n, cb = s.permute(0, 3, 1, 2), const.to(torch.bfloat16)
    with torch.no_grad():
        got = S._gemm_forward(s8, m, const).float()
        want = S._gemm_reference(s8, m, const).float()
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
        ulp = torch.maximum(ulp, 1e-5 * (1 + want.abs()))
        rec = {"shape": list(shape),
               "max_ulps": float(((got - want).abs() / ulp).max()),
               "differing_share": float((got != want).float().mean()),
               "kernel_ms": cuda_ms(lambda: S._gemm_forward(s8, m, const), iters),
               "wrapper_ms": cuda_ms(lambda: S._PackedSpread.apply(s, m, const), iters),
               "library_ms": cuda_ms(lambda: F.conv2d(s_n, kc, cb, padding=1), iters)}
    px = n * h * w
    ms_b = (px * c * (1 + 2) + 9 * c * c * 2 + 4 * c) / HBM_BPS * 1e3
    ms_f = 2 * 9 * c * c * px / BF16_FLOPS * 1e3
    rec.update(bound_ms=max(ms_b, ms_f), bound_by="bytes" if ms_b >= ms_f else "operations")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                    help="checkout whose ecs_yolo_tpu_torch is timed")
    ap.add_argument("--iters", type=int, default=50)
    opt = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_spread_gemm: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(opt.root.resolve()))
    from ecs_yolo_tpu_torch.snn import spread as S

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sites = [site(S, shape, opt.iters, seed=100 + i) for i, (shape, _) in enumerate(SITES)]
    per_forward = {k: sum(r[k] * k_ for r, (_, k_) in zip(sites, SITES))
                   for k in ("kernel_ms", "wrapper_ms", "library_ms", "bound_ms")}
    print(json.dumps({"root": str(opt.root), "module": S.__file__, "nvidia_smi": card,
                      "sites": sites, "per_train_forward": per_forward}), flush=True)
    ok = all(r["max_ulps"] <= 1 and r["differing_share"] <= 1e-2 for r in sites)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
