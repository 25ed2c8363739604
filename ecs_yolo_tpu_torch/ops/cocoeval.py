"""Pure-numpy COCO bbox evaluation (counterpart of
``ecs_yolo_tpu/ops/cocoeval.py``, the same numpy code kept as the port's own
copy).

The reference's ``--save-json`` path feeds predictions to pycocotools'
COCOeval (reference val.py bottom, save_one_json at val.py:56-78).  This
module implements the bbox protocol from the COCO spec: greedy
score-ordered matching per (image, category) with crowd/ignore semantics,
10 IoU thresholds, 101-point precision interpolation, area ranges and
maxDets: the standard AP/AP50/AP75/APs/APm/APl/AR numbers from (gt json,
det json) pairs.

The port always evaluates with this module, whether or not pycocotools is
installed, so that its numbers are the same on every machine.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _xywh_to_xyxy(b: np.ndarray) -> np.ndarray:
    out = b.copy()
    out[:, 2:] = b[:, :2] + b[:, 2:]
    return out


def box_iou_crowd(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray):
    """IoU of det xyxy vs gt xyxy; for crowd GT the denominator is the det
    area only (pycocotools ``iou`` semantics)."""
    lt = np.maximum(dt[:, None, :2], gt[None, :, :2])
    rb = np.minimum(dt[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = (dt[:, 2] - dt[:, 0]) * (dt[:, 3] - dt[:, 1])
    area_g = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(iscrowd[None, :], area_d[:, None], union)
    return inter / np.maximum(union, 1e-9)


class COCOeval:
    """Minimal COCO bbox evaluator over parsed GT/DT json dicts."""

    def __init__(self, gt: Dict, dt: Sequence[Dict]):
        self.cat_ids = sorted(
            {c["id"] for c in gt.get("categories", [])}
            or {a["category_id"] for a in gt["annotations"]}
        )
        self.img_ids = sorted({im["id"] for im in gt.get("images", [])}
                              or {a["image_id"] for a in gt["annotations"]})
        self._gt = {}
        for a in gt["annotations"]:
            self._gt.setdefault(
                (a["image_id"], a["category_id"]), []
            ).append(a)
        self._dt = {}
        for d in dt:
            self._dt.setdefault(
                (d["image_id"], d["category_id"]), []
            ).append(d)

    # -- per-(image, category) matching ------------------------------------

    def _match(self, img_id, cat_id, area_rng, max_det):
        gts = self._gt.get((img_id, cat_id), [])
        dts = self._dt.get((img_id, cat_id), [])
        if not gts and not dts:
            return None
        g_ign = np.array(
            [
                bool(g.get("iscrowd", 0))
                or not (area_rng[0] <= g.get(
                    "area", g["bbox"][2] * g["bbox"][3]) <= area_rng[1])
                for g in gts
            ],
            bool,
        )
        # gt order: real first, ignored last (pycocotools gtind sort)
        order_g = np.argsort(g_ign, kind="stable")
        gts = [gts[i] for i in order_g]
        g_ign = g_ign[order_g]
        crowd = np.array([bool(g.get("iscrowd", 0)) for g in gts], bool)

        scores = np.array([d["score"] for d in dts], np.float64)
        order_d = np.argsort(-scores, kind="stable")[:max_det]
        dts = [dts[i] for i in order_d]
        scores = scores[order_d]

        nd, ng = len(dts), len(gts)
        dt_m = -np.ones((len(IOU_THRS), nd), np.int64)   # matched gt index
        gt_m = -np.ones((len(IOU_THRS), ng), np.int64)
        dt_ign = np.zeros((len(IOU_THRS), nd), bool)
        if nd and ng:
            dbox = _xywh_to_xyxy(
                np.array([d["bbox"] for d in dts], np.float64))
            gbox = _xywh_to_xyxy(
                np.array([g["bbox"] for g in gts], np.float64))
            ious = box_iou_crowd(dbox, gbox, crowd)
            for ti, thr in enumerate(IOU_THRS):
                for di in range(nd):
                    best, best_iou = -1, min(thr, 1 - 1e-10)
                    for gi in range(ng):
                        if gt_m[ti, gi] >= 0 and not crowd[gi]:
                            continue
                        # real matches found, now into ignored gt: stop
                        if best > -1 and not g_ign[best] and g_ign[gi]:
                            break
                        if ious[di, gi] < best_iou:
                            continue
                        best_iou = ious[di, gi]
                        best = gi
                    if best == -1:
                        continue
                    dt_m[ti, di] = best
                    gt_m[ti, best] = di
                    dt_ign[ti, di] = g_ign[best]
        # unmatched dets outside the area range are ignored
        d_area = np.array(
            [d["bbox"][2] * d["bbox"][3] for d in dts], np.float64
        ) if nd else np.zeros(0)
        out_rng = (d_area < area_rng[0]) | (d_area > area_rng[1])
        dt_ign = dt_ign | ((dt_m < 0) & out_rng[None, :])
        return dict(
            scores=scores, dt_m=dt_m, dt_ign=dt_ign, g_ign=g_ign
        )

    # -- accumulate + summarize ---------------------------------------------

    def evaluate(self) -> Dict[str, float]:
        T, R = len(IOU_THRS), len(REC_THRS)
        K = len(self.cat_ids)
        A, M = len(AREA_RNG), len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        for ki, cat in enumerate(self.cat_ids):
            for ai, rng in enumerate(AREA_RNG.values()):
                for mi, max_det in enumerate(MAX_DETS):
                    per_img = [
                        e
                        for img in self.img_ids
                        if (e := self._match(img, cat, rng, max_det))
                        is not None
                    ]
                    if not per_img:
                        continue
                    scores = np.concatenate([e["scores"] for e in per_img])
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate(
                        [e["dt_m"] for e in per_img], axis=1)[:, order]
                    dti = np.concatenate(
                        [e["dt_ign"] for e in per_img], axis=1)[:, order]
                    npig = int(sum((~e["g_ign"]).sum() for e in per_img))
                    if npig == 0:
                        continue
                    tps = (dtm >= 0) & ~dti
                    fps = (dtm < 0) & ~dti
                    tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
                    for ti in range(T):
                        tp, fp = tp_cum[ti], fp_cum[ti]
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, 1e-12)
                        recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0
                        # monotone-from-right precision envelope
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(R)
                        ok = inds < len(pr)
                        q[ok] = pr[inds[ok]]
                        precision[ti, :, ki, ai, mi] = q

        def _ap(t=None, area="all", max_det=100):
            ai = list(AREA_RNG).index(area)
            mi = MAX_DETS.index(max_det)
            s = precision[:, :, :, ai, mi]
            if t is not None:
                s = s[[int(np.where(np.isclose(IOU_THRS, t))[0][0])]]
            s = s[s > -1]
            return float(s.mean()) if s.size else -1.0

        def _ar(area="all", max_det=100):
            ai = list(AREA_RNG).index(area)
            mi = MAX_DETS.index(max_det)
            s = recall[:, :, ai, mi]
            s = s[s > -1]
            return float(s.mean()) if s.size else -1.0

        return dict(
            map=_ap(), map50=_ap(t=0.5), map75=_ap(t=0.75),
            maps=_ap(area="small"), mapm=_ap(area="medium"),
            mapl=_ap(area="large"),
            ar1=_ar(max_det=1), ar10=_ar(max_det=10), ar100=_ar(),
            ars=_ar(area="small"), arm=_ar(area="medium"),
            arl=_ar(area="large"),
        )


def evaluate_json(anno_json: str, det_json: str) -> Dict[str, float]:
    """COCO bbox eval of a detections json against an annotations json
    (reference val.py COCOeval block), with :class:`COCOeval`."""
    with open(anno_json) as fh:
        gt = json.load(fh)
    with open(det_json) as fh:
        dt = json.load(fh)
    return COCOeval(gt, dt).evaluate()


def dataset_to_coco_gt(
    ds, class_names: Optional[Sequence[str]] = None, coco91: bool = False
) -> Dict:
    """Build a COCO-format GT dict from a ``data.dataset.Dataset`` — labels
    are YOLO txts normalized to the NATIVE image, so the GT boxes here are
    native-space, matching what val.run's scale-to-native json emits."""
    from .metrics import coco80_to_coco91_class

    cmap = coco80_to_coco91_class() if coco91 else None
    images, annos = [], []
    cats = set()
    aid = 1
    for i in range(len(ds)):
        meta = ds.meta(i)
        h0, w0 = meta["native_hw"]
        images.append(dict(id=meta["id"], width=w0, height=h0,
                           file_name=meta["path"]))
        for cls, x, y, w, h in ds.labels[i]:
            cid = cmap[int(cls)] if cmap else int(cls)
            cats.add(cid)
            bw, bh = float(w * w0), float(h * h0)
            annos.append(dict(
                id=aid, image_id=meta["id"], category_id=cid,
                bbox=[float(x * w0) - bw / 2, float(y * h0) - bh / 2, bw, bh],
                area=bw * bh, iscrowd=0,
            ))
            aid += 1
    if class_names is not None and not coco91:
        cats |= set(range(len(class_names)))
    categories = [
        dict(id=c, name=str(class_names[c]) if class_names is not None
             and not coco91 and c < len(class_names) else str(c))
        for c in sorted(cats)
    ]
    return dict(images=images, annotations=annos, categories=categories)
