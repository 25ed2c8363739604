"""Validation pass: dataset -> forward -> NMS -> mAP (counterpart of
``ecs_yolo_tpu/val.py``).

Equivalent of reference val.py:134-513 ``run()``: conf 0.001 / IoU 0.6 /
multi-label NMS, TP matrix over 10 IoU thresholds, ``ap_per_class`` summary
and the speed breakdown (pre-process / inference / NMS ms per image).
Predictions and labels are mapped back to native resolution before the TP
matrix, and ``save_json`` writes COCO-format records keyed by the real image
ids with native-space boxes, evaluated by ``ops/cocoeval``.

The pass streams batch by batch: uint8 batch -> pinned host memory -> device
-> ``/255`` on the device -> forward under ``torch.inference_mode()`` (every
neuron site one fused kernel, see ``nn/blocks.MemUpdate``) -> NMS -> host ->
native-space rescale -> ``process_batch``.  Nothing of the whole set is held
but the per-image statistics.

CLI::

    python -m ecs_yolo_tpu_torch.val --weights last.pt --cfg resnet10.yaml \
        --data data/kitti.yaml [--no-ecs] [--fused-inference] \
        [--device cuda|cpu] [--dtype bf16|fp32] [--fuse]

Not carried over from the JAX ``run``: ``mesh``, ``fuse_post``,
``chain_batches`` and ``jit_cache`` (devices of the TPU's dispatch), and the
exported-backend branch (``variables is None``).

Every detection head is served as the JAX ``run`` serves it: NMS takes the
decoded one2one branch of ``v10Detect`` and ``ASFF_v10Detect``, else the
head's first output; scores carry an objectness only for ``Detect``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from .data.dataset import Dataset
from .ops.metrics import (ap_per_class, coco80_to_coco91_class, fitness,
                          process_batch)
from .ops.nms import non_max_suppression

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
_EMPTY = dict(mp=0, mr=0, map50=0, map=0, fitness=0, speed=(0, 0, 0))


def xywh2xyxy_np(b: np.ndarray) -> np.ndarray:
    """Centre boxes ``[n, 4]`` (x, y, w, h) to corners, in b's dtype."""
    out = np.empty_like(b)
    out[:, 0] = b[:, 0] - b[:, 2] / 2
    out[:, 1] = b[:, 1] - b[:, 3] / 2
    out[:, 2] = b[:, 0] + b[:, 2] / 2
    out[:, 3] = b[:, 1] + b[:, 3] / 2
    return out


def to_native(xyxy: np.ndarray, meta: Dict) -> np.ndarray:
    """Canvas-pixel corner boxes (columns 0-3 of ``xyxy``, changed in place)
    back to the native image through ``meta``'s letterbox ``ratio_pad``,
    clipped to the image (reference val.py:309 ``scale_coords``)."""
    h0, w0 = meta["native_hw"]
    (gy, gx), (pad_w, pad_h) = meta["ratio_pad"]
    xyxy[:, [0, 2]] = ((xyxy[:, [0, 2]] - pad_w) / gx).clip(0, w0)
    xyxy[:, [1, 3]] = ((xyxy[:, [1, 3]] - pad_h) / gy).clip(0, h0)
    return xyxy


class MetricAccumulator:
    """The host half of a val pass: per image, labels and detections to
    native space, the TP matrix, the COCO records; at the end the summary."""

    def __init__(self, ds: Dataset, save_json: Optional[str] = None,
                 coco91: bool = False):
        self.ds = ds
        self.iouv = np.linspace(0.5, 0.95, 10)
        self.stats = []
        self.seen = 0
        self.json_dets = [] if save_json is not None else None
        self.cmap = coco80_to_coco91_class() if coco91 else None

    def add(self, index: int, labels: np.ndarray, mask: np.ndarray,
            dets: np.ndarray) -> None:
        """One real image: ``labels`` ``[M, 5]`` canvas-normalised with
        ``mask``, ``dets`` ``[n, 6]`` canvas-pixel xyxy/conf/cls."""
        if not mask.any() and not len(dets):
            return
        self.seen += 1
        meta = self.ds.meta(index)
        gt = labels[mask]
        h, w = meta["canvas_hw"]
        gt_xyxy = to_native(xywh2xyxy_np(gt[:, 1:5]) * [w, h, w, h], meta)
        gt5 = np.concatenate([gt[:, 0:1], gt_xyxy], axis=1)
        dets = to_native(dets.copy(), meta)
        self.stats.append((process_batch(dets, gt5, self.iouv), dets[:, 4],
                           dets[:, 5], gt[:, 0]))
        if self.json_dets is not None:
            # COCO records (reference save_one_json, val.py:56-78): real
            # image ids, native-space corner-xywh boxes
            for x1, y1, x2, y2, conf, cls in dets:
                self.json_dets.append(dict(
                    image_id=meta["id"],
                    category_id=self.cmap[int(cls)] if self.cmap else int(cls),
                    bbox=[round(float(v), 3) for v in (x1, y1, x2 - x1, y2 - y1)],
                    score=round(float(conf), 5)))

    def summary(self, dt) -> Dict:
        """The JAX ``run``'s result dict from the accumulated statistics and
        the three summed phase times ``dt`` (seconds)."""
        if not self.stats:
            return dict(_EMPTY)
        tp = np.concatenate([s[0] for s in self.stats])
        conf = np.concatenate([s[1] for s in self.stats])
        pred_cls = np.concatenate([s[2] for s in self.stats])
        target_cls = np.concatenate([s[3] for s in self.stats])
        if tp.shape[0]:
            _, _, p, r, _, ap, cls_ids = ap_per_class(tp, conf, pred_cls, target_cls)
            ap50, ap_all = ap[:, 0], ap.mean(1)
            mp, mr, map50, map_ = p.mean(), r.mean(), ap50.mean(), ap_all.mean()
        else:
            mp = mr = map50 = map_ = 0.0
            cls_ids, p, r, ap50, ap_all = [], [], [], [], []
        n_img = max(self.seen, 1)
        return dict(
            mp=float(mp), mr=float(mr), map50=float(map50), map=float(map_),
            fitness=float(fitness(np.array([[mp, mr, map50, map_]]))[0]),
            speed=tuple(1000.0 * t / n_img for t in dt),
            seen=self.seen,
            per_class={int(c): (float(pp), float(rr), float(a5), float(aa))
                       for c, pp, rr, a5, aa in zip(cls_ids, p, r, ap50, ap_all)},
        )


def run(
    model: torch.nn.Module,
    data_path,
    imgsz: int = 640,
    batch_size: int = 8,
    conf_thres: float = 0.001,
    iou_thres: float = 0.6,
    max_det: int = 300,
    max_labels: int = 300,
    verbose: bool = False,
    dataset: Optional[Dataset] = None,
    save_json: Optional[str] = None,
    anno_json: Optional[str] = None,
    coco91: bool = False,
    workers: int = 4,
    device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
) -> Dict:
    """Returns {mp, mr, map50, map, fitness, speed, per_class} as the JAX
    ``run`` and ``seen``, the number of images that had a label or a
    detection; with ``save_json`` + ``anno_json`` also a ``coco`` sub-dict
    from COCOeval.

    ``model`` is a built ``DetectionModel`` with its weights loaded; it runs
    in eval mode where it lies.  ``device`` and ``dtype``, when given, move
    it there and cast its parameters first (BN statistics stay float32).
    ``speed`` is (pre-process, inference, NMS) in ms per image seen, each
    phase closed by a ``torch.cuda.synchronize()`` on the card."""
    from .models.yolo import cast_params, head_predictions

    if device is not None:
        model.to(torch.device(device))
    if dtype is not None:
        cast_params(model, dtype)
    model.eval()
    dev = next(model.parameters()).device
    ds = dataset or Dataset(data_path, img_size=imgsz, augment=False,
                            max_labels=max_labels, uint8_out=True)
    head = model.head_info["name"]
    has_obj = head == "Detect"
    acc = MetricAccumulator(ds, save_json, coco91)
    dt = [0.0, 0.0, 0.0]
    on_card = dev.type == "cuda"

    def clock() -> float:
        if on_card:
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    with torch.inference_mode():
        for ims, labels, masks, n_real, idxs in ds.batches(
                batch_size, drop_last=False, yield_idx=True, workers=workers):
            t0 = clock()
            x = torch.from_numpy(ims)
            if on_card:
                x = x.pin_memory().to(dev, non_blocking=True)
            if x.dtype == torch.uint8:
                x = x.float() / 255.0
            t1 = clock()
            pred = head_predictions(head, model(x))
            t2 = clock()
            out, valid = non_max_suppression(
                pred, conf_thres=conf_thres, iou_thres=iou_thres,
                multi_label=True, max_det=max_det, has_obj=has_obj)
            out, valid = out.cpu().numpy(), valid.cpu().numpy()
            t3 = time.perf_counter()
            dt[0] += t1 - t0
            dt[1] += t2 - t1
            dt[2] += t3 - t2
            # only the first n_real rows are real images; the zero-padded
            # tail must not add detections (false positives) to the metrics
            for si in range(n_real):
                acc.add(idxs[si], labels[si], masks[si], out[si][valid[si]])

    coco_res = None
    if save_json is not None:
        Path(save_json).parent.mkdir(parents=True, exist_ok=True)
        with open(save_json, "w") as fh:
            json.dump(acc.json_dets, fh)
        if anno_json is not None:
            from .ops.cocoeval import evaluate_json

            coco_res = evaluate_json(anno_json, save_json)

    result = acc.summary(dt)
    if not acc.stats:
        return result
    if coco_res is not None:
        result["coco"] = coco_res
    if verbose:
        s = result["speed"]
        print(f"P={result['mp']:.3f} R={result['mr']:.3f} "
              f"mAP50={result['map50']:.3f} mAP={result['map']:.3f} "
              f"speed pre/inf/nms = {s[0]:.1f}/{s[1]:.1f}/{s[2]:.1f} ms")
    return result


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--weights", required=True,
                   help="checkpoint written by utils/checkpoint.save_checkpoint")
    p.add_argument("--cfg", default="resnet10.yaml")
    p.add_argument("--data", required=True, help="dataset yaml (path, val, nc)")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--conf-thres", type=float, default=0.001)
    p.add_argument("--iou-thres", type=float, default=0.6)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--task", default="val", choices=["val", "test", "speed"])
    p.add_argument("--save-json", default=None,
                   help="write COCO-format detections to this json path")
    p.add_argument("--anno-json", default=None,
                   help="COCO ground-truth json; with --save-json runs COCOeval")
    p.add_argument("--coco91", action="store_true",
                   help="map 80-class ids to COCO-91 ids in the json")
    p.add_argument("--no-ema", dest="use_ema", action="store_false",
                   help="evaluate the raw parameters, not the EMA copy")
    p.add_argument("--no-ecs", dest="ecs", action="store_false",
                   help="the plain-LIF model (SNNConfig.ecs=False)")
    p.add_argument("--fused-inference", action="store_true",
                   help="every ECS-LIF site on the general-shape fused kernel "
                        "(SNNConfig.fused_inference)")
    p.add_argument("--time-window", type=int, default=4, help="time steps T")
    p.add_argument("--workers", type=int, default=4, help="image decode threads")
    p.add_argument("--device", default=None,
                   help="torch device; the CUDA card when omitted")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bf16",
                   help="parameter/compute dtype (BN statistics stay fp32)")
    p.add_argument("--fuse", action="store_true",
                   help="fold the conv/bn pairs before eval "
                        "(models/utils.fuse_conv_bn)")
    return p.parse_args(argv)


def main(opt) -> Dict:
    import yaml

    from .config import SNNConfig
    from .models.utils import fuse_conv_bn
    from .models.yolo import build_model
    from .utils.checkpoint import eval_state_dict, load_checkpoint

    with open(opt.data) as fh:
        data = yaml.safe_load(fh)
    root = Path(data.get("path", "."))
    split = data.get(opt.task if opt.task != "speed" else "val", data["val"])
    snn = SNNConfig(time_window=opt.time_window, ecs=opt.ecs,
                    fused_inference=opt.fused_inference)
    model = build_model(opt.cfg, nc=data["nc"], snn=snn, device=opt.device)
    tree, _ = load_checkpoint(opt.weights)
    model.load_state_dict(eval_state_dict(tree, opt.use_ema), strict=True)
    if opt.fuse:
        fuse_conv_bn(model)
    results = run(
        model, str(root / split), imgsz=opt.imgsz, batch_size=opt.batch_size,
        conf_thres=opt.conf_thres, iou_thres=opt.iou_thres,
        max_det=opt.max_det, verbose=True, save_json=opt.save_json,
        anno_json=opt.anno_json, coco91=opt.coco91, workers=opt.workers,
        dtype=DTYPES[opt.dtype])
    print(json.dumps({k: v for k, v in results.items() if k != "per_class"}))
    return results


if __name__ == "__main__":
    main(parse_opt())
