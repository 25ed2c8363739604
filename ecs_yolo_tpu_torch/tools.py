"""Analysis and compression CLI (counterpart of the root ``tools.py``): the
reference's prune.py, g1-resnet/calculate_fr.py, export.py / export2.py
and exportfiletxt.py, with the root script's flags::

    python -m ecs_yolo_tpu_torch.tools prune       --weights CKPT --cfg YAML --ratio 0.5 --out DIR
    python -m ecs_yolo_tpu_torch.tools firing-rate --weights CKPT --cfg YAML --data DIR
    python -m ecs_yolo_tpu_torch.tools export      --weights CKPT --cfg YAML --include torchscript pt2
    python -m ecs_yolo_tpu_torch.tools profile     --cfg YAML [--weights CKPT]
    python -m ecs_yolo_tpu_torch.tools voxelize    --dat F.dat --labels F.npy --out DIR
    python -m ecs_yolo_tpu_torch.tools image-list  --root DIR --out list.txt

The model commands run on the CUDA card unless ``--device cpu`` (and
``export`` in ``--dtype``, bf16 by default).  ``export --int8`` (the
TFLite quantizer's flag) is refused: no TensorFlow format is ported
(``export.py``).  ``prune`` writes ``{out}/pruned.pt``, a checkpoint of this
package with the pruning report in its meta.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    def model_cmd(name, weights_required=True):
        sp = sub.add_parser(name)
        sp.add_argument("--weights", required=weights_required, default=None)
        sp.add_argument("--cfg", default="resnet10.yaml")
        sp.add_argument("--nc", type=int, default=None)
        sp.add_argument("--device", default=None,
                        help="torch device; the CUDA card when omitted")
        return sp

    pr = model_cmd("prune")
    pr.add_argument("--ratio", type=float, default=0.5)
    pr.add_argument("--out", default="runs/prune")

    fr = model_cmd("firing-rate")
    fr.add_argument("--data", required=True)
    fr.add_argument("--imgsz", type=int, default=640)
    fr.add_argument("--batches", type=int, default=8)
    fr.add_argument("--out", default="runs/fr/exp")

    ex = model_cmd("export", weights_required=False)
    ex.add_argument("--imgsz", type=int, default=640)
    ex.add_argument("--batch", type=int, default=1)
    ex.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ex.add_argument("--include", nargs="+", default=["torchscript"])
    ex.add_argument("--out", default="runs/export")
    ex.add_argument("--int8", action="store_true",
                    help="int8 post-training quantization (TFLite; not ported)")
    ex.add_argument("--calib-data", default=None,
                    help="calibration image dir/glob for --int8")

    pf = model_cmd("profile", weights_required=False)
    pf.add_argument("--imgsz", type=int, default=256)

    vx = sub.add_parser("voxelize")
    vx.add_argument("--dat", required=True, nargs="+")
    vx.add_argument("--labels", required=True, nargs="+")
    vx.add_argument("--out", required=True)
    vx.add_argument("--sample-size", type=int, default=250_000)
    vx.add_argument("--t-bins", type=int, default=5)

    il = sub.add_parser("image-list")
    il.add_argument("--root", required=True)
    il.add_argument("--out", required=True)

    opt = p.parse_args(argv)
    if opt.cmd == "export" and opt.int8:
        p.error("--int8 quantizes a TFLite export, which this package does not write")
    return opt


def _model(opt):
    from .hub import create

    return create(opt.cfg, opt.weights, nc=opt.nc, device=opt.device)


def main(opt):
    if opt.cmd == "prune":
        from .train.sparsity import prune_by_bn_gamma
        from .utils.checkpoint import save_checkpoint

        model = _model(opt)
        pruned, report = prune_by_bn_gamma(model.state_dict(), ratio=opt.ratio)
        print(json.dumps(report))
        path = save_checkpoint(Path(opt.out) / "pruned.pt", pruned, None,
                               {"pruned": report})
        print(f"pruned checkpoint -> {path}")
        return report

    if opt.cmd == "firing-rate":
        from .data.dataset import Dataset
        from .observe import calculate_fr

        model = _model(opt)
        ds = Dataset(opt.data, img_size=opt.imgsz, augment=False)
        Path(opt.out).mkdir(parents=True, exist_ok=True)
        rates = calculate_fr(model, ds.batches(1), max_batches=opt.batches,
                             save_prefix=str(Path(opt.out) / "fr"))
        print(json.dumps({k: round(v, 4) for k, v in rates.items()}, indent=1))
        return rates

    if opt.cmd == "export":
        from . import export as export_mod
        from .models.yolo import cast_params

        model = _model(opt)
        cast_params(model, DTYPES[opt.dtype])
        out = export_mod.run(model, include=opt.include, out_dir=opt.out,
                             imgsz=opt.imgsz, batch=opt.batch)
        print(json.dumps({k: str(v) for k, v in out.items()}))
        return out

    if opt.cmd == "profile":
        from .models.utils import model_info
        from .utils.profiling import profile_layers

        model = _model(opt)
        info = model_info(model, imgsz=opt.imgsz)
        print(json.dumps(info))
        rows = profile_layers(model, imgsz=opt.imgsz)
        for row in rows:
            print(f"{row['index']:>3} {row['name']:<20} {row['ms']:>8.2f} ms")
        return info, rows

    if opt.cmd == "voxelize":
        from .data.events import build_dataset

        n = build_dataset(list(zip(opt.dat, opt.labels)), opt.out,
                          sample_size=opt.sample_size, t_bins=opt.t_bins)
        print(f"wrote {n} samples -> {opt.out}")
        return n

    # image-list (reference exportfiletxt.py): the image files of a split dir
    from .data.dataset import find_images

    files = find_images(opt.root)
    Path(opt.out).parent.mkdir(parents=True, exist_ok=True)
    Path(opt.out).write_text("\n".join(files))
    print(f"{len(files)} images -> {opt.out}")
    return files


if __name__ == "__main__":
    main(parse_opt())
