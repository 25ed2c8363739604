"""Inference driver: images -> detections -> annotated outputs / txt
(counterpart of ``ecs_yolo_tpu/detect.py``).

LoadImages -> letterbox -> forward (eval, no autograd; on the card every
neuron site runs the fused ECS-LIF kernel) -> greedy NMS -> boxes scaled back
to the native image -> drawn / saved.

CLI::

    python -m ecs_yolo_tpu_torch.detect --cfg resnet10.yaml --source imgs/ \
        [--weights model.pt] [--device cuda|cpu] [--dtype bf16|fp32]

Without ``--weights`` the model is a seeded random init (``--seed``).
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
from PIL import Image, ImageDraw

from .data.loaders import LoadImages
from .ops.nms import non_max_suppression

_PALETTE = [
    (255, 56, 56), (255, 157, 151), (255, 112, 31), (255, 178, 29),
    (207, 210, 49), (72, 249, 10), (146, 204, 23), (61, 219, 134),
    (26, 147, 52), (0, 212, 187), (44, 153, 168), (0, 194, 255),
    (52, 69, 147), (100, 115, 255), (0, 24, 236), (132, 56, 255),
]
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def scale_to_native(boxes: np.ndarray, lb_shape, native_shape):
    """Invert the letterbox mapping (reference utils/general.py:621-647)."""
    gain = min(lb_shape[0] / native_shape[0], lb_shape[1] / native_shape[1])
    pad_w = (lb_shape[1] - native_shape[1] * gain) / 2
    pad_h = (lb_shape[0] - native_shape[0] * gain) / 2
    out = boxes.copy()
    out[:, [0, 2]] = (out[:, [0, 2]] - pad_w) / gain
    out[:, [1, 3]] = (out[:, [1, 3]] - pad_h) / gain
    out[:, [0, 2]] = out[:, [0, 2]].clip(0, native_shape[1])
    out[:, [1, 3]] = out[:, [1, 3]].clip(0, native_shape[0])
    return out


def _save(path, im0, dets, save_dir: Path, save_txt: bool, names):
    img = Image.fromarray(im0)
    draw = ImageDraw.Draw(img)
    for x1, y1, x2, y2, conf, cls in dets:
        c = int(cls)
        color = _PALETTE[c % len(_PALETTE)]
        draw.rectangle([x1, y1, x2, y2], outline=color, width=2)
        label = names[c] if names and c < len(names) else str(c)
        draw.text((x1 + 2, max(y1 - 12, 0)), f"{label} {conf:.2f}", fill=color)
    img.save(save_dir / Path(path).name)
    if save_txt:
        h, w = im0.shape[:2]
        with open(save_dir / (Path(path).stem + ".txt"), "w") as fh:
            for x1, y1, x2, y2, conf, cls in dets:
                xc, yc = (x1 + x2) / 2 / w, (y1 + y2) / 2 / h
                bw, bh = (x2 - x1) / w, (y2 - y1) / h
                fh.write(f"{int(cls)} {xc:.6f} {yc:.6f} {bw:.6f} {bh:.6f} "
                         f"{conf:.4f}\n")


@torch.no_grad()
def run(
    model: torch.nn.Module,
    source,
    imgsz: int = 640,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    save_dir: Optional[str] = None,
    save_txt: bool = False,
    names: Optional[List[str]] = None,
):
    """Returns ``[(path, detections [n, 6] native xyxy/conf/cls)]``, one per
    image.  ``model`` is a built ``DetectionModel``; it runs in eval mode on
    its own device and dtype."""
    model.eval()
    device = next(model.parameters()).device
    if save_dir:
        Path(save_dir).mkdir(parents=True, exist_ok=True)
    results = []
    for path, im, im0 in LoadImages(source, img_size=imgsz):
        pred = model(torch.from_numpy(im).to(device))[0]
        out, valid = non_max_suppression(
            pred, conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det)
        dets = out[0][valid[0]].cpu().numpy()
        if len(dets):
            dets[:, :4] = scale_to_native(dets[:, :4], im.shape[1:3],
                                          im0.shape[:2])
        results.append((path, dets))
        if save_dir:
            _save(path, im0, dets, Path(save_dir), save_txt, names)
    return results


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--weights", default=None,
                   help="torch state_dict (.pt) written by the port; a "
                        "seeded random init when omitted")
    p.add_argument("--cfg", default="resnet10.yaml")
    p.add_argument("--source", required=True, help="image file/dir/glob")
    p.add_argument("--data", default=None, help="dataset yaml (class names)")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--nc", type=int, default=None)
    p.add_argument("--save-dir", default="runs/detect/exp")
    p.add_argument("--save-txt", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device; the CUDA card when omitted")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bf16",
                   help="parameter/compute dtype (BN statistics stay fp32)")
    p.add_argument("--seed", type=int, default=0, help="init seed")
    return p.parse_args(argv)


def main(opt):
    import yaml

    from .models.yolo import build_model, cast_params

    names, nc = None, opt.nc
    if opt.data:
        with open(opt.data) as fh:
            d = yaml.safe_load(fh)
        names, nc = d.get("names"), d["nc"]
    model = build_model(opt.cfg, nc=nc, device=opt.device,
                        generator=torch.Generator().manual_seed(opt.seed))
    if opt.weights:
        sd = torch.load(opt.weights, map_location="cpu", weights_only=True)
        model.load_state_dict(sd, strict=True)
    cast_params(model, DTYPES[opt.dtype])
    results = run(model, opt.source, imgsz=opt.imgsz,
                  conf_thres=opt.conf_thres, iou_thres=opt.iou_thres,
                  max_det=opt.max_det, save_dir=opt.save_dir,
                  save_txt=opt.save_txt, names=names)
    n = sum(len(d) for _, d in results)
    print(f"{len(results)} images, {n} detections -> {opt.save_dir}")
    return results


if __name__ == "__main__":
    main(parse_opt())
