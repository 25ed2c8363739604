"""The spread kernels on one card against the library and their bounds: K5
(``packed_spread``, ``csrc/spread_gemm.cu``) at the EMS-ResNet10@640 training
sites, and K4 (``binary_dw3_conv``) and K7 (``pallas_dw3``), both on
``csrc/spread_dw3.cu``, at the training sites and the bench's b16 sites.

    python ecs_yolo_tpu_torch/scripts/bench_spread.py {gemm,dw3} [--root TREE] [--iters N]

Run as a file, not with ``-m``: ``--root`` names the checkout whose
``ecs_yolo_tpu_torch`` is imported (this one by default), so that two
versions of a kernel can be timed in one run on one card, each from its own
tree, in turns.  The timing helpers here (``cuda_ms``, ``graph_ms``,
``profiled_ms``) are also ``chip_smoke.py``'s.  The training sites are bf16,
N=8; the inputs stay in the 50 MB L2 between calls as they partly do on the
path.  One JSON line, with the card's ``nvidia-smi`` name and power limit.
Needs a card.

``gemm`` (K5, ``--iters`` 50): per site the kernel alone (``_gemm_forward``
on the int8 plane with ``M`` composed once), the ``autograd.Function`` as the
train path calls it (the int8 cast and the kernel), one dense ``F.conv2d``
with the composed kernel and bias on channels_last (the library call), all
eager, the bound (bytes over 3.35 TB/s against operations over 989 TFLOP/s)
and the worst difference from the plain version in bf16 ulps; then the sums
over one training forward (3 launches at 320 x 320 and 12 at 160 x 160: 5
sites x 3 steps of T=4).  Exits 1 beyond 1 ulp or 1 % of values differing.

``dw3`` (K4 and K7, ``--iters`` 20): per shape ``graph_ms``, the device time
of one call from ``--iters`` calls captured in one CUDA graph and replayed
(the host's issue rate is not in it; for a tree whose K4 casts the plane to
int8 first, the cast is); ``eager_ms``, the same calls eager, back to back
(where the host issues slower than the card runs, this is the host's rate);
``library_ms`` / ``library_graph_ms``, one ``F.conv2d(groups=C)`` with bias
on channels_last, eager and replayed; ``kernels_per_call``, the device
kernels the profiler sees per eager call; the bound, bytes over 3.35 TB/s
(K4: the float plane read once, the output and the int8 plane written once,
the weights, with the int8-in function's and the cast-plus-kernel pair's
beside it; K7: the int8 plane, the output, the weights); then the sums over
one training forward (57 K4 calls: 19 sites x 3 steps) and over the bench's
three sites (one call each).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

HBM_BPS, BF16_FLOPS = 3.35e12, 989e12
GRAPH_REPS = 20            # calls captured in one CUDA graph for a device-only time
#: K5's training sites: (shape, launches per training forward)
GEMM_SITES = (((8, 320, 320, 64), 3), ((8, 160, 160, 64), 12))
#: K4's training sites: (shape, calls per training forward), the 19 C >= 128
#: sites x 3 steps
DW3_SITES = (((8, 80, 80, 128), 9), ((8, 40, 40, 384), 6), ((8, 40, 40, 256), 12),
             ((8, 20, 20, 1024), 3), ((8, 20, 20, 512), 12), ((8, 20, 20, 256), 12),
             ((8, 20, 20, 128), 3))
DW3_SUMMED = ("kernels_per_call", "graph_ms", "eager_ms", "library_ms", "library_graph_ms",
              "bound_ms", "bound_int8_in_ms", "bound_cast_pair_ms")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` eager calls after one
    warm-up (CUDA events around them)."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps: int = GRAPH_REPS, replays: int = 3) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph and replayed ``replays`` times (after a warm-up call and a
    warm-up replay), so that the host's issue rate is not in it."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(replays):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    del g
    return t0.elapsed_time(t1) / (reps * replays)


def profiled(fn, calls: int = GRAPH_REPS) -> list:
    """The profiler's ``key_averages()`` over ``calls`` eager calls of
    ``fn`` (after one warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return list(p.key_averages())


def profiled_ms(fn, tag: str, calls: int = GRAPH_REPS) -> float:
    """Device time of the kernels whose name holds ``tag``, per call of
    ``fn``, from the profiler over ``calls`` eager calls."""
    return sum(e.self_device_time_total for e in profiled(fn, calls)
               if tag in e.key) / 1e3 / calls


def kernels_per_call(fn, calls: int = 10) -> float:
    """Device kernels the profiler sees per eager call of ``fn``."""
    return sum(e.count for e in profiled(fn, calls)
               if str(e.device_type).endswith("CUDA")) / calls


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sums(rows, weights, keys) -> dict:
    return {key: sum(w * r[key] for r, w in zip(rows, weights))
            for key in keys if all(key in r for r in rows)}


def rand_fn(seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return lambda *sz: torch.rand(*sz, generator=g, device="cuda")


# --- K5 ------------------------------------------------------------------------

def gemm_site(S, shape, iters: int, seed: int) -> dict:
    n, h, w, c = shape
    r = rand_fn(seed)
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


def bench_gemm(S, iters: int) -> tuple:
    sites = [gemm_site(S, shape, iters, seed=100 + i) for i, (shape, _) in enumerate(GEMM_SITES)]
    ok = all(r["max_ulps"] <= 1 and r["differing_share"] <= 1e-2 for r in sites)
    return {"sites": sites, "per_train_forward": sums(
        sites, [k for _, k in GEMM_SITES],
        ("kernel_ms", "wrapper_ms", "library_ms", "bound_ms"))}, ok


# --- K4 and K7 -------------------------------------------------------------------

def timed(call, lib, iters: int) -> dict:
    return {"kernels_per_call": kernels_per_call(call),
            "graph_ms": graph_ms(call, iters), "eager_ms": cuda_ms(call, iters),
            "library_ms": cuda_ms(lib, iters), "library_graph_ms": graph_ms(lib, iters)}


def k4_site(S, shape, iters: int, seed: int) -> dict:
    n, h, w, c = shape
    r = rand_fn(seed)
    s = (r(*shape) < 0.3).to(torch.bfloat16)
    dw = ((r(3, 3, 1, c) - 0.5) * 0.4).to(torch.bfloat16)
    dwb = ((r(c) - 0.5) * 0.2).to(torch.bfloat16)
    s_n, kd = s.permute(0, 3, 1, 2), dw.permute(3, 2, 0, 1).contiguous()
    call = lambda: S.binary_dw3_conv(s, dw, dwb)
    lib = lambda: F.conv2d(s_n, kd, dwb, padding=1, groups=c)
    with torch.no_grad():
        diff = (call().float() - S.binary_dw3_conv_reference(s, dw, dwb).float()).abs()
        rec = {"shape": list(shape), "max_abs_err": float(diff.max()),
               **timed(call, lib, iters)}
    pos, wb = n * h * w * c, 10 * c * 2
    rec.update(bound_ms=(pos * 5 + wb) / HBM_BPS * 1e3,
               bound_int8_in_ms=(pos * 3 + wb) / HBM_BPS * 1e3,
               bound_cast_pair_ms=(pos * 6 + wb) / HBM_BPS * 1e3)
    return rec


def k7_site(BD, name, iters: int) -> dict:
    shape = BD.SITES[name]
    c = shape[-1]
    s8, k, b = BD.site_inputs(shape, False, "cuda")
    k3 = k.reshape(3, 3, c)
    call = lambda: BD.pallas_dw3(s8, k3, b)
    with torch.no_grad():
        diff = (call().float() - BD.pallas_dw3_reference(s8, k3, b).float()).abs()
        rec = {"site": name, "shape": list(shape), "max_abs_err": float(diff.max()),
               **timed(call, BD.library_call(False, s8, k, b, torch.bfloat16), iters)}
    rec["bound_ms"] = BD.bound_ms(False, shape, torch.bfloat16)[0]
    return rec


def bench_dw3(S, BD, iters: int) -> tuple:
    k4 = [k4_site(S, shape, iters, seed=i) for i, (shape, _) in enumerate(DW3_SITES)]
    k7 = [k7_site(BD, name, iters) for name in ("c128", "c256", "c512")]
    return {"k4_sites": k4, "k4_train_forward": sums(k4, [n for _, n in DW3_SITES], DW3_SUMMED),
            "k7_sites": k7, "k7_three_sites": sums(k7, [1, 1, 1], DW3_SUMMED)}, True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=("gemm", "dw3"))
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                    help="checkout whose ecs_yolo_tpu_torch is timed")
    ap.add_argument("--iters", type=int, help="calls a shape (gemm 50, dw3 20)")
    opt = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_spread: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(opt.root.resolve()))
    from ecs_yolo_tpu_torch.scripts import bench_pallas_dw as BD
    from ecs_yolo_tpu_torch.snn import spread as S

    torch.backends.cudnn.allow_tf32 = False
    if opt.kernel == "gemm":
        iters = opt.iters or 50
        res, ok = bench_gemm(S, iters)
    else:
        iters = opt.iters or 20
        res, ok = bench_dw3(S, BD, iters)
    print(json.dumps({"kernel": opt.kernel, "root": str(opt.root), "module": S.__file__,
                      "nvidia_smi": smi(), "iters": iters, **res}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
