"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the fused ECS-LIF kernel (``ecs_yolo_tpu_torch/csrc/ecs_lif.cu``) from
the checkout, holds it against its plain PyTorch version at every distinct
EMS-ResNet10@640 neuron-site shape, drives the port's detect path
(``ecs_yolo_tpu_torch.detect.run``) on synthetic images with a full-width
res10 (random weights from a seed, bf16), checks that every neuron site of
that run went through the kernel and agrees with the plain version on its
real input, and times a batched forward.  Each phase prints one JSON line
(``--out PATH`` also writes them all to one JSON file).  The last lines are the
card's ``nvidia-smi`` name and power limit, the ``{"kernels": ...}`` summary
and ``{"ok": true, "device": ...}``.  Any failure exits non-zero.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

T, N, IMGSZ, NC = 4, 8, 640, 13
# distinct [H, W, C] of the 24 MemUpdate sites of res10 at 640 px, with the
# number of sites of each shape
SITES = [((320, 320, 64), 1), ((160, 160, 64), 3), ((80, 80, 128), 3),
         ((40, 40, 256), 3), ((20, 20, 512), 3), ((20, 20, 1024), 1),
         ((20, 20, 256), 6), ((20, 20, 128), 1), ((40, 40, 384), 2)]
# share of spikes allowed to differ from the plain version (the kernel's
# 1x1 product sums in another order than the library's; a membrane within
# an ulp of the threshold may flip)
SPIKE_BOUND = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SILU_ATOL = 2e-4           # act=True (SiLU) sites, float32
# H100 SXM: HBM 3.35 TB/s; dense fp32 (CUDA cores) 67 TFLOP/s, bf16 989
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def emit(record: dict, log: dict) -> None:
    log.setdefault(record["phase"], []).append(record)
    print(json.dumps(record), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def site_inputs(shape, dtype, seed):
    """x = rand*2-0.5 and spread weights scaled as the JAX package's fused
    kernel tests (tests/test_pallas_kernels.py:TestEcsV3)."""
    c = shape[-1]
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.rand(*s, generator=g, device="cuda")
    args = (r(*shape) * 2 - 0.5, (r(3, 3, 1, c) - 0.5) * 0.4,
            (r(c) - 0.5) * 0.2, (r(1, 1, c, c) - 0.5) * 0.2, (r(c) - 0.5) * 0.2)
    return [a.to(dtype) for a in args]


def bound_ms(shape, dtype) -> tuple:
    """Least time for the function: each input read once, each output written
    once, and the spread's FLOPs (1x1 product + 3x3 taps, T-1 steps)."""
    t, n, h, w, c = shape
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * t * n * h * w * c + 11 * c + c * c) * item
    flops = (t - 1) * n * h * w * (2 * c * c + 18 * c)
    ms_b, ms_f = nbytes / HBM_BPS * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(ms_b, ms_f), "bytes" if ms_b >= ms_f else "operations"


def phase_kernels(K, cfg_cls, log):
    """K1 against its plain version at every res10 site shape, N=8, T=4."""
    agg = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
           "by": {"bytes": 0.0, "operations": 0.0}}
    cfg = cfg_cls(time_window=T)
    for dtype in (torch.float32, torch.bfloat16):
        for i, ((h, w, c), count) in enumerate(SITES):
            shape = (T, N, h, w, c)
            args = site_inputs(shape, dtype, seed=i)
            got = K.ecs_lif_fused(*args, cfg)
            want = K.ecs_lif_reference(*args, cfg)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            share = float((diff > 0).float().mean())
            reps = max(3, min(20, int(2e9 // (math.prod(shape) * c))))
            ms = cuda_ms(lambda: K.ecs_lif_fused(*args, cfg), reps)
            plain_ms = cuda_ms(lambda: K.ecs_lif_reference(*args, cfg), reps)
            bms, by = bound_ms(shape, dtype)
            rec = {"phase": "kernel_check", "kernel": "ecs_lif_fused",
                   "dtype": str(dtype).replace("torch.", ""), "act": False,
                   "shape": list(shape), "sites": count, "rows_per_tile":
                   K.plan_rows(N, h, T, torch.cuda.get_device_properties(0)
                               .multi_processor_count),
                   "mismatch_share": share, "bound_share": SPIKE_BOUND[dtype],
                   "max_abs_err": float(diff.max()),
                   "firing_rate": float(want.float().mean()),
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                   "bound_by": by, "library_ms": None}
            emit(rec, log)
            if share > SPIKE_BOUND[dtype]:
                raise AssertionError(f"ecs_lif_fused disagrees at {rec}")
            if dtype == torch.bfloat16:      # the served dtype: one forward
                agg["ms"] += count * ms
                agg["plain_ms"] += count * plain_ms
                agg["bound_ms"] += count * bms
                agg["by"][by] += count * bms
            agg["max_abs_err"] = max(agg["max_abs_err"], float(diff.max()))
            del args, got, want, diff
    # act=True (SiLU) at one small shape, float32
    shape = (T, 2, 40, 40, 64)
    args = site_inputs(shape, torch.float32, seed=99)
    err = float((K.ecs_lif_fused(*args, cfg, True)
                 - K.ecs_lif_reference(*args, cfg, True)).abs().max())
    emit({"phase": "kernel_check", "kernel": "ecs_lif_fused", "dtype":
          "float32", "act": True, "shape": list(shape), "max_abs_err": err,
          "atol": SILU_ATOL}, log)
    if err > SILU_ATOL:
        raise AssertionError(f"ecs_lif_fused(act=True) max abs err {err}")
    return agg


def write_images(d: Path, seed: int = 0):
    from PIL import Image

    rng = np.random.RandomState(seed)
    for i, (h, w) in enumerate([(480, 640), (720, 1280), (640, 640), (375, 500)]):
        im = (rng.rand(h, w, 3) * 96 + 64).astype(np.uint8)
        for _ in range(6):   # a few flat boxes over the noise
            y0, x0 = rng.randint(0, h - 40), rng.randint(0, w - 40)
            im[y0:y0 + rng.randint(20, h // 2), x0:x0 + rng.randint(20, w // 2)] \
                = rng.randint(0, 255, 3)
        Image.fromarray(im).save(d / f"synthetic_{i}.png")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="port smoke test on one card")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every phase's record to this JSON file")
    out_path = ap.parse_args(argv).out
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port, imported from this checkout only once a card is known
    from ecs_yolo_tpu_torch import _build
    from ecs_yolo_tpu_torch import detect as detect_mod
    from ecs_yolo_tpu_torch.config import SNNConfig
    from ecs_yolo_tpu_torch.data.loaders import LoadImages
    from ecs_yolo_tpu_torch.models.yolo import build_model, cast_params
    from ecs_yolo_tpu_torch.nn.blocks import MemUpdate, _BN
    from ecs_yolo_tpu_torch.snn import ecs_lif as K

    log: dict = {}
    card = smi()
    emit({"phase": "environment", "nvidia_smi": card,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "allow_tf32_matmul_default": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn_default": torch.backends.cudnn.allow_tf32}, log)
    # float32 checks compare full float32 arithmetic on both sides
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.load("ecs_lif")
    nvcc_s, nvcc_log = _build.build_info.get("ecs_lif", (None, ""))
    emit({"phase": "build", "kernel": "ecs_lif", "seconds":
          time.perf_counter() - t0, "nvcc_seconds": nvcc_s, "ptxas": [
              ln.split("info    : ")[-1] for ln in nvcc_log.splitlines()
              if "registers" in ln or "spill" in ln]}, log)

    agg = phase_kernels(K, SNNConfig, log)

    # --- the detect path at full width ------------------------------------
    gen = torch.Generator().manual_seed(0)
    model = build_model("resnet10.yaml", nc=NC, generator=gen)
    sites = [m for m in model.modules() if isinstance(m, MemUpdate)]
    if len(sites) != 24:
        raise AssertionError(f"res10 has {len(sites)} neuron sites, want 24")
    with tempfile.TemporaryDirectory() as tmp:
        write_images(Path(tmp))
        ims = [im for _, im, _ in LoadImages(tmp, IMGSZ)]
        x1 = torch.from_numpy(ims[0]).cuda()
        calibrate_bn(model, torch.from_numpy(np.concatenate(ims)).cuda(), _BN)

        # end to end in float32: kernel route (eval, no autograd) against
        # the plain route (autograd on takes the eager loop at every site)
        with torch.no_grad():
            z_k = model(x1)[0].float()
        with torch.enable_grad():
            z_p = model(x1)[0].detach().float()
        d = (z_k - z_p).abs()
        rel = float((d > 1e-3 * (1 + z_p.abs())).float().mean())
        emit({"phase": "model_fp32", "shape": list(z_k.shape),
              "finite": bool(torch.isfinite(z_k).all()), "max_abs_err":
              float(d.max()), "share_off_by_1e-3_rel": rel}, log)
        if not torch.isfinite(z_k).all() or rel > 1e-3:
            raise AssertionError("float32 model: kernel route disagrees")

        cast_params(model, torch.bfloat16)
        # one hooked forward: every site's real input and the kernel output
        seen = []
        hooks = [m.register_forward_hook(
            lambda m, i, o: seen.append((m, i[0], o))) for m in sites]
        with torch.no_grad():
            model(x1)
        for h in hooks:
            h.remove()
        worst = 0.0
        for j, (m, xin, spikes) in enumerate(seen):
            ref = K.ecs_lif_reference(xin, *m.spread_params(), m.snn, m.act)
            share = float((ref != spikes).float().mean())
            worst = max(worst, share)
            emit({"phase": "site", "site": j, "shape": list(xin.shape),
                  "firing_rate": float(spikes.float().mean()),
                  "mismatch_share": share}, log)
        del seen
        if worst > SPIKE_BOUND[torch.bfloat16]:
            raise AssertionError(f"a site disagrees: share {worst}")

        # the main path: detect.run over the images, counts read around it
        K.ecs_lif_fused.launches = 0
        t0 = time.perf_counter()
        results = detect_mod.run(model, tmp, imgsz=IMGSZ)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = K.ecs_lif_fused.launches
        for path, dets in results:
            emit({"phase": "detect", "image": Path(path).name,
                  "detections": int(len(dets)),
                  "finite": bool(np.isfinite(dets).all())}, log)
        emit({"phase": "detect_run", "images": len(results), "seconds": wall,
              "ecs_lif_launches": launches}, log)
        if launches != 24 * len(results) or len(results) != 4:
            raise AssertionError(f"{launches} K1 launches for {len(results)} "
                                 "forwards, want 24 each")

        # --- throughput: batched bf16 forward, N=8 ------------------------
        xb = torch.from_numpy(np.concatenate(ims * 2)).cuda()
        with torch.no_grad():
            ms = cuda_ms(lambda: model(xb), reps=10)
            prof = profile_forward(model, xb)
    emit({"phase": "throughput", "batch": int(xb.shape[0]), "imgsz": IMGSZ,
          "T": T, "dtype": "bfloat16", "ms_per_forward": ms,
          "images_per_s": xb.shape[0] / ms * 1e3, **prof}, log)

    kernels = {"kernels": [{
        "name": "ecs_lif_fused", "route": "cuda",
        "source": "ecs_yolo_tpu_torch/csrc/ecs_lif.cu",
        "replaces": "ecs_yolo_tpu/snn/pallas_ecs_v3.py:172",
        "launches": launches, "max_abs_err": agg["max_abs_err"],
        "ms": agg["ms"], "plain_ms": agg["plain_ms"],
        "bound_ms": agg["bound_ms"],
        "bound_by": max(agg["by"], key=agg["by"].get),
        "library_ms": None,
        "work": "the 24 neuron sites of one res10@640 forward, N=8, T=4, bf16",
        "library_note": "no single PyTorch call computes the ECS-LIF "
                        "recurrence",
    }]}
    if out_path is not None:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps({"log": log, **kernels}, indent=1))
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def calibrate_bn(model, x, bn_cls) -> None:
    """BN running statistics from one batch (momentum 1): with random
    weights and the init's mean 0 / variance 1, nearly every site after the
    stem stays silent; calibrated, every site fires, so the checks below see
    real spike traffic."""
    bns = [m for m in model.modules() if isinstance(m, bn_cls)]
    for b in bns:
        b.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(x)
    model.eval()
    for b in bns:
        b.momentum = 0.1


def profile_forward(model, xb) -> dict:
    """Device time by kernel over one forward (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    model(xb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        model(xb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []   # kernels only: an operator's row repeats its kernels' time
    for e in p.key_averages():
        if str(e.device_type).endswith("CUDA"):
            rows.append((e.self_device_time_total / 1e3, e.key, e.count))
    if not rows:
        return {"profile": "not measured: no device time in the trace"}
    total = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    k1 = sum(r[0] for r in rows if "ecs_lif_kernel" in r[1])
    return {"profiled_wall_ms": wall_ms, "device_ms": total,
            "ecs_lif_device_ms": k1, "idle_share": max(0.0, 1 - total / wall_ms),
            "top_kernels": [{"name": k[:90], "ms": ms, "calls": c}
                            for ms, k, c in rows[:8]]}


if __name__ == "__main__":
    sys.exit(main())
