"""The port's val/mAP path against the JAX package (CPU): the numpy metrics
and COCO evaluator, the val half of ``Dataset``, the checkpoint file, and
``val.run`` end to end on a narrowed EMS-ResNet10 with weights carried
across, for the ECS-LIF and the plain-LIF model; plus the CLI.

Tolerances: the metric and COCO modules are numpy on both sides and must
agree to 1e-12.  ``Dataset`` output is equal for uint8 and within 1 ulp for
float32.  The whole pass runs in float32: the two frameworks' convolutions
sum in different orders, so boxes agree to ~1e-4 relative (see
test_torch_port_model.py); metrics are held to 1e-5, COCO boxes to 1e-2 px
and scores to 1e-4, COCOeval numbers to 1e-6.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from ecs_yolo_tpu import val as jax_val
from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu.data import dataset as JD
from ecs_yolo_tpu.models import yolo as jax_yolo
from ecs_yolo_tpu.ops import cocoeval as JC
from ecs_yolo_tpu.ops import metrics as JM
from ecs_yolo_tpu_torch import val as port_val
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.data import dataset as PD
from ecs_yolo_tpu_torch.models import convert as CV
from ecs_yolo_tpu_torch.models import yolo as port_yolo
from ecs_yolo_tpu_torch.ops import cocoeval as PC
from ecs_yolo_tpu_torch.ops import metrics as PM
from ecs_yolo_tpu_torch.utils import checkpoint as CK
from tests.test_torch_port_model import _random_variables

torch.set_num_threads(2)

SIZES = [(48, 80), (64, 64), (100, 37), (30, 45), (64, 50), (90, 120)]


def write_split(root: Path, sizes=SIZES, seed=0, nc=3, empty=()):
    """``root/images/<n>.png`` + ``root/labels/<n>.txt`` from a seed: noise
    images of mixed native sizes, 1-5 boxes each (none for the indices in
    ``empty``), numeric stems (COCO image ids)."""
    rng = np.random.RandomState(seed)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir(parents=True)
    for i, (h, w) in enumerate(sizes):
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            root / "images" / f"{i + 11}.png")
        rows = []
        for _ in range(0 if i in empty else rng.randint(1, 6)):
            bw, bh = rng.uniform(0.1, 0.5, 2)
            cx, cy = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(bh / 2, 1 - bh / 2)
            rows.append(f"{rng.randint(0, nc)} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}")
        (root / "labels" / f"{i + 11}.txt").write_text("\n".join(rows) + "\n")
    return root / "images"


# --- ops/metrics.py ----------------------------------------------------------------


def _dets_and_labels(seed, n_det=40, n_gt=12, nc=3):
    rng = np.random.RandomState(seed)
    gxy = rng.rand(n_gt, 2) * 200
    gt = np.concatenate([rng.randint(0, nc, (n_gt, 1)), gxy,
                         gxy + 10 + rng.rand(n_gt, 2) * 60], 1)
    pick = rng.randint(0, n_gt, n_det)
    boxes = gt[pick, 1:] + rng.randn(n_det, 4) * 4
    cls = np.where(rng.rand(n_det) < 0.8, gt[pick, 0], rng.randint(0, nc, n_det))
    dets = np.concatenate([boxes, rng.rand(n_det, 1), cls[:, None]], 1)
    return dets, gt


def _metric_cases():
    iouv = np.linspace(0.5, 0.95, 10)
    labels2 = np.array([[0, 10, 10, 50, 50], [1, 60, 60, 90, 90]], float)
    dets2 = np.array([[10, 10, 50, 50, 0.9, 0], [60, 60, 90, 90, 0.8, 1]], float)
    one_gt = np.array([[0, 10, 10, 50, 50]], float)
    rng = np.random.RandomState(5)
    tp = rng.rand(200, 10) < np.linspace(0.7, 0.1, 10)
    conf, pcls, tcls = rng.rand(200), rng.randint(0, 4, 200), rng.randint(0, 5, 90)
    cases = {
        # the hand-made cases of tests/test_metrics.py
        "process_batch_perfect": ("process_batch", (dets2, labels2, iouv)),
        "process_batch_wrong_class": (
            "process_batch", (np.array([[10, 10, 50, 50, 0.9, 1]], float), one_gt,
                              np.array([0.5]))),
        "process_batch_one_gt_once": (
            "process_batch", (np.array([[10, 10, 50, 50, 0.6, 0],
                                        [12, 12, 52, 52, 0.9, 0]], float), one_gt,
                              np.array([0.5]))),
        "process_batch_iou_threshold": (
            "process_batch", (np.array([[0, 0, 100, 60, 0.9, 0]], float),
                              np.array([[0, 0, 0, 100, 100]], float),
                              np.array([0.5, 0.55, 0.6, 0.65]))),
        "process_batch_no_labels": ("process_batch", (dets2, np.zeros((0, 5)), iouv)),
        "process_batch_no_dets": ("process_batch", (np.zeros((0, 6)), labels2, iouv)),
        "process_batch_random": ("process_batch", (*_dets_and_labels(1), iouv)),
        "box_iou_np": ("box_iou_np", (
            np.array([[0, 0, 10, 10]], float),
            np.array([[0, 0, 10, 10], [5, 5, 15, 15], [20, 20, 30, 30]], float))),
        "box_iou_np_random": ("box_iou_np", (_dets_and_labels(2)[0][:, :4],
                                             _dets_and_labels(2)[1][:, 1:])),
        "compute_ap": ("compute_ap", (np.array([0.2, 0.4, 0.8]),
                                      np.array([1.0, 0.6, 0.8]))),
        "ap_per_class_perfect": ("ap_per_class", (
            np.ones((20, 1), bool), np.linspace(0.9, 0.1, 20), np.zeros(20),
            np.zeros(20))),
        "ap_per_class_half": ("ap_per_class", (
            np.array([[True, False] * 10]).reshape(-1, 1),
            np.linspace(0.9, 0.1, 20), np.zeros(20), np.zeros(10))),
        "ap_per_class_random": ("ap_per_class", (tp, conf, pcls, tcls)),
        "fitness": ("fitness", (np.array([[0.5, 0.5, 0.6, 0.4], [1, 0, 0.2, 0.1]]),)),
        "coco80_to_coco91_class": ("coco80_to_coco91_class", ()),
    }
    return cases


def _assert_same(got, want):
    if isinstance(want, (tuple, list)) and not np.isscalar(want):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k])
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g.astype(float), w.astype(float), atol=1e-12, rtol=0)


@pytest.mark.parametrize("case", sorted(_metric_cases()))
def test_metrics_match_jax(case):
    fn, args = _metric_cases()[case]
    got, want = getattr(PM, fn)(*args), getattr(JM, fn)(*args)
    _assert_same(got, want)
    if case == "process_batch_perfect":
        assert np.asarray(got).all()
    if case == "process_batch_iou_threshold":
        np.testing.assert_array_equal(got[0], [True, True, False, False])
    if case == "ap_per_class_perfect":
        assert got[5][0, 0] == pytest.approx(1.0, abs=1e-2)


@pytest.mark.parametrize("case", ["hand_made", "missed_gt", "random"])
def test_confusion_matrix_matches_jax(case):
    if case == "hand_made":
        batches = [(np.array([[10, 10, 50, 50, 0.9, 0], [200, 200, 240, 240, 0.8, 1]],
                             float), np.array([[0, 10, 10, 50, 50]], float))]
    elif case == "missed_gt":
        batches = [(np.zeros((0, 6)), np.array([[1, 10, 10, 50, 50]], float))]
    else:
        batches = [_dets_and_labels(s) for s in (3, 4, 5)]
    nc = 3 if case == "random" else 2
    got, want = PM.ConfusionMatrix(nc), JM.ConfusionMatrix(nc)
    for dets, labels in batches:
        got.process_batch(dets, labels)
        want.process_batch(dets, labels)
    _assert_same(got.matrix, want.matrix)
    _assert_same(got.tp_fp(), want.tp_fp())
    assert got.matrix.sum() > 0


# --- ops/cocoeval.py ---------------------------------------------------------------


def _coco_pair(seed, n_img=5, nc=3):
    """A seeded COCO gt dict and detection list with crowd boxes, a spread
    of areas over the small/medium/large ranges, misses and false hits."""
    rng = np.random.RandomState(seed)
    images = [dict(id=100 + i, width=400, height=300) for i in range(n_img)]
    annos, dets = [], []
    for im in images:
        for _ in range(rng.randint(1, 7)):
            w, h = rng.choice([12.0, 50.0, 150.0]) * rng.uniform(0.8, 1.2, 2)
            x, y = rng.uniform(0, 400 - w), rng.uniform(0, 300 - h)
            cat = int(rng.randint(0, nc))
            annos.append(dict(id=len(annos) + 1, image_id=im["id"], category_id=cat,
                              bbox=[float(x), float(y), float(w), float(h)],
                              area=float(w * h), iscrowd=int(rng.rand() < 0.15)))
            for _ in range(rng.randint(0, 3)):
                jit = rng.randn(4) * rng.choice([1.0, 8.0])
                dets.append(dict(
                    image_id=im["id"],
                    category_id=cat if rng.rand() < 0.85 else int(rng.randint(0, nc)),
                    bbox=[float(x + jit[0]), float(y + jit[1]),
                          float(max(w + jit[2], 1)), float(max(h + jit[3], 1))],
                    score=round(float(rng.rand()), 5)))
    gt = dict(images=images, annotations=annos,
              categories=[dict(id=c, name=str(c)) for c in range(nc)])
    return gt, dets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cocoeval_matches_jax(seed, tmp_path):
    gt, dets = _coco_pair(seed)
    want = JC.COCOeval(gt, dets).evaluate()
    got = PC.COCOeval(gt, dets).evaluate()
    _assert_same(got, want)
    assert 0 < got["map50"] <= 1
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    (tmp_path / "dt.json").write_text(json.dumps(dets))
    _assert_same(PC.evaluate_json(str(tmp_path / "gt.json"), str(tmp_path / "dt.json")),
                 JC.evaluate_json(str(tmp_path / "gt.json"), str(tmp_path / "dt.json")))


def test_cocoeval_known_ap_and_crowd():
    """The hand-computed cases of tests/test_val_coco.py."""
    gt = dict(images=[dict(id=7, width=100, height=100)], annotations=[
        dict(id=1, image_id=7, category_id=0, bbox=[10, 10, 20, 20], area=400, iscrowd=0),
        dict(id=2, image_id=7, category_id=0, bbox=[50, 50, 20, 20], area=400, iscrowd=0),
    ], categories=[dict(id=0, name="a")])
    dt = [dict(image_id=7, category_id=0, bbox=[10, 10, 20, 20], score=0.9),
          dict(image_id=7, category_id=0, bbox=[80, 80, 10, 10], score=0.8)]
    res = PC.COCOeval(gt, dt).evaluate()
    assert res["map50"] == pytest.approx(51 / 101, abs=1e-6)
    assert res["ar100"] == pytest.approx(0.5, abs=1e-6)
    rng = np.random.RandomState(0)
    d, g = rng.rand(6, 4) * 50, rng.rand(4, 4) * 50
    d[:, 2:] += d[:, :2]
    g[:, 2:] += g[:, :2]
    crowd = np.array([True, False, False, True])
    _assert_same(PC.box_iou_crowd(d, g, crowd), JC.box_iou_crowd(d, g, crowd))


# --- data/dataset.py, the val half -------------------------------------------------


def test_path_helpers_and_label_files_match_jax(tmp_path):
    src = write_split(tmp_path / "s", empty=(3,))
    assert PD.find_images(src) == JD.find_images(src)
    assert PD.find_images([str(src)]) == JD.find_images([str(src)])
    files = PD.find_images(src)
    assert [PD.img2label_path(f) for f in files] == [JD.img2label_path(f) for f in files]
    for f in files + [str(tmp_path / "images" / "none.png")]:
        _assert_same(PD.load_label_file(PD.img2label_path(f)),
                     JD.load_label_file(JD.img2label_path(f)))
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(files[:3]) + "\n")
    assert PD.find_images(lst) == JD.find_images(lst)
    bad = tmp_path / "bad.txt"
    bad.write_text("0 0.5 0.5 1.5 0.2\n")
    with pytest.raises(ValueError, match="non-normalized"):
        PD.load_label_file(str(bad))
    with pytest.raises(FileNotFoundError):
        PD.find_images(tmp_path / "missing")


DATASET_MODES = {
    "uint8": dict(uint8_out=True, max_labels=8),
    "float32": dict(max_labels=8),
    "truncated_labels": dict(uint8_out=True, max_labels=2),
    "single_cls": dict(uint8_out=True, max_labels=8, single_cls=True),
    "rect": dict(uint8_out=True, max_labels=8, rect=True, rect_buckets=2, stride=16),
}


@pytest.mark.parametrize("mode", sorted(DATASET_MODES))
def test_dataset_items_and_meta_match_jax(mode, tmp_path):
    src = write_split(tmp_path / "s", empty=(3,))
    kw = dict(img_size=64, augment=False, **DATASET_MODES[mode])
    pd_, jd = PD.Dataset(src, **kw), JD.Dataset(src, **kw)
    assert len(pd_) == len(jd) == len(SIZES)
    for i in range(len(jd)):
        (pi, pl, pm), (ji, jl, jm) = pd_[i], jd[i]
        assert pi.dtype == ji.dtype and pi.shape == ji.shape
        if pi.dtype == np.uint8:
            np.testing.assert_array_equal(pi, ji)
        else:
            np.testing.assert_allclose(pi, ji, rtol=1.2e-7, atol=0)
        np.testing.assert_allclose(pl, jl, rtol=1.2e-7, atol=0)
        np.testing.assert_array_equal(pm, jm)
        assert pd_.meta(i) == jd.meta(i)
    assert pd_.meta(0)["id"] == 11


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("rect", [False, True])
def test_dataset_batches_match_jax(workers, rect, tmp_path):
    src = write_split(tmp_path / "s")
    kw = dict(img_size=64, max_labels=8, uint8_out=True, rect=rect,
              rect_buckets=2, stride=16)
    pd_, jd = PD.Dataset(src, **kw), JD.Dataset(src, **kw)
    for args in ((4, False, 0, False), (4, True, 3, True), (4, True, 3, False)):
        got, want = pd_._batch_plan(*args), jd._batch_plan(*args)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
    bkw = dict(drop_last=False, yield_idx=True, workers=workers, prefetch=1)
    got, want = list(pd_.batches(4, **bkw)), list(jd.batches(4, **bkw))
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        for a, b in zip(g[:3], w[:3]):
            assert a.shape[0] == 4          # the last batch is padded
            np.testing.assert_array_equal(a, b)
        assert g[3:] == w[3:]
    assert sum(g[3] for g in got) == len(SIZES)
    counted = list(pd_.batches(4, drop_last=False, yield_count=True, workers=workers))
    assert [len(b) for b in counted] == [4] * len(counted)
    assert [len(b) for b in pd_.batches(4, drop_last=True, workers=workers)] == [3] * (
        len(list(jd.batches(4, drop_last=True))))


def test_dataset_worker_errors_reach_the_consumer(tmp_path):
    src = write_split(tmp_path / "s")
    ds = PD.Dataset(src, img_size=64, max_labels=8)
    Path(ds.img_files[4]).write_bytes(b"not an image")
    with pytest.raises(Exception, match="cannot identify image"):
        list(ds.batches(2, drop_last=False, workers=2))


def test_dataset_label_cache_round_trip(tmp_path):
    src = write_split(tmp_path / "s", empty=(1,))
    first = PD.Dataset(src, img_size=64, cache_dir=str(tmp_path / "cache"))
    assert list((tmp_path / "cache").glob("labels_*.npz"))
    again = PD.Dataset(src, img_size=64, cache_dir=str(tmp_path / "cache"))
    for a, b in zip(first.labels, again.labels):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("what", ["quad", "host_shard", "SegmentDataset"])
def test_train_half_of_the_dataset_is_refused(what, tmp_path):
    """What the port's dataset does not take: a ``host_shard`` world that does
    not divide the batch (JAX's message; the shards themselves are held in
    test_torch_port_parallel.py), a quad collate of a batch not divisible by 4 (refused as JAX refuses it;
    the collate itself is held to JAX's in test_torch_port_augment.py), and
    the quad collate of ``SegmentDataset``'s mask batches (the dataset
    itself is held to JAX's in test_torch_port_segment.py)."""
    src = write_split(tmp_path / "s", sizes=SIZES[:2])
    if what == "quad":
        with pytest.raises(ValueError, match="quad"):
            next(PD.Dataset(src, img_size=64).batches(3, quad=True))
    elif what == "host_shard":
        with pytest.raises(ValueError, match="global batch 3 not divisible by 2 hosts"):
            next(PD.Dataset(src, img_size=64).batches(3, host_shard=(0, 2)))
    else:
        with pytest.raises(ValueError, match="quad"):
            next(PD.SegmentDataset(src, img_size=64).batches(4, quad=True))


def test_dataset_to_coco_gt_matches_jax(tmp_path):
    src = write_split(tmp_path / "s", empty=(2,))
    pd_, jd = PD.Dataset(src, img_size=64), JD.Dataset(src, img_size=64)
    for kw in ({}, {"class_names": ["a", "b", "c", "d"]}, {"coco91": True}):
        assert PC.dataset_to_coco_gt(pd_, **kw) == JC.dataset_to_coco_gt(jd, **kw)


# --- the metric half of val.run ------------------------------------------------------


def test_a_perfect_detector_scores_full_marks(tmp_path):
    """Detections made from the labels through the letterbox: the rescale to
    native space and the matching must bring them back onto the labels."""
    src = write_split(tmp_path / "s", empty=(3,))
    ds = PD.Dataset(src, img_size=64, max_labels=8, uint8_out=True)
    acc = port_val.MetricAccumulator(ds, save_json=str(tmp_path / "d.json"))
    for i in range(len(ds)):
        _, labels, mask = ds[i]
        gt = labels[mask]
        h, w = ds.meta(i)["canvas_hw"]
        boxes = port_val.xywh2xyxy_np(gt[:, 1:5]) * [w, h, w, h]
        dets = np.concatenate([boxes, np.full((len(gt), 1), 0.9), gt[:, :1]], 1)
        acc.add(i, labels, mask, dets.astype(np.float32))
    res = acc.summary([0.0, 0.0, 0.0])
    assert acc.seen == len(SIZES) - 1
    assert res["map50"] >= 0.99 and res["map"] >= 0.99 and res["mr"] >= 0.99
    assert len(acc.json_dets) == sum(len(lb) for lb in ds.labels)


# --- the slice as a whole ----------------------------------------------------------

T = 2


def _narrow_res10():
    d = port_yolo.load_cfg("resnet10.yaml")
    d["width_multiple"] = 0.25
    return d


@functools.lru_cache(maxsize=None)
def _jax_model(ecs: bool, nc: int):
    """The JAX model and its variables' abstract shapes: one ``jax.eval_shape``
    for every test of this file that builds it."""
    jm = jax_yolo.build_model(_narrow_res10(), nc=nc,
                              snn=JaxSNNConfig(time_window=T, ecs=ecs))
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    return jm, jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0), x,
                                                     training=False))


def _model_pair(ecs: bool, seed: int, nc: int = 3):
    """(jax model, its variables, the port's model with the same weights)."""
    d = _narrow_res10()
    jm, shapes = _jax_model(ecs, nc)
    v = _random_variables(None, seed, shapes)
    pm = port_yolo.build_model(d, nc=nc, snn=SNNConfig(time_window=T, ecs=ecs),
                               device="cpu")
    pm.load_state_dict(CV.convert(v["params"], v["batch_stats"], pm.spec), strict=True)
    return jm, v, pm


def test_plain_lif_tree_converts_without_spread_parameters():
    """A JAX tree built with ``SNNConfig(ecs=False)`` holds no spread
    parameters and converts onto the port's plain-LIF model as it is."""
    jm, v, pm = _model_pair(ecs=False, seed=5)
    flat = jax.tree_util.tree_flatten_with_path(v["params"])[0]
    assert not any("spread" in str(path) for path, _ in flat)
    sd = pm.state_dict()
    assert sd and not any("spread" in k for k in sd)
    assert len(sd) == len(flat) + len(jax.tree_util.tree_leaves(v["batch_stats"]))
    ecs_model = port_yolo.build_model(_narrow_res10(), nc=3, snn=SNNConfig(time_window=T),
                                      device="cpu")
    assert any("spread" in k for k in ecs_model.state_dict())


def _labels_from_detections(src: Path, det_json: Path, seed: int, empty=()):
    """Rewrite the split's labels from a run's own detections (each image's
    best few boxes, jittered), so that random weights score well above zero
    and every part of the matching does work."""
    rng = np.random.RandomState(seed)
    dets = json.loads(det_json.read_text())
    for i, (h, w) in enumerate(SIZES):
        mine = sorted((d for d in dets if d["image_id"] == i + 11),
                      key=lambda d: -d["score"])
        rows = []
        for d in mine[:: max(len(mine) // 4, 1)][:4]:
            x, y, bw, bh = np.asarray(d["bbox"]) * rng.uniform(0.93, 1.07, 4)
            x0, y0 = max(x, 0.0), max(y, 0.0)
            x1, y1 = min(x + bw, w), min(y + bh, h)
            if i in empty or x1 - x0 < 2 or y1 - y0 < 2:
                continue
            rows.append(f"{d['category_id']} {(x0 + x1) / 2 / w:.6f} "
                        f"{(y0 + y1) / 2 / h:.6f} {(x1 - x0) / w:.6f} {(y1 - y0) / h:.6f}")
        (src.parent / "labels" / f"{i + 11}.txt").write_text("\n".join(rows) + "\n")


@pytest.mark.parametrize("variant", ["ecs_lif", "plain_lif"])
def test_val_run_matches_jax(variant, tmp_path):
    jm, v, pm = _model_pair(ecs=variant == "ecs_lif", seed=7)
    src = write_split(tmp_path / "s", empty=(3,))
    port_val.run(pm, str(src), imgsz=64, batch_size=4, max_labels=8, workers=0,
                 save_json=str(tmp_path / "first.json"))
    _labels_from_detections(src, tmp_path / "first.json", seed=1, empty=(3,))
    anno = tmp_path / "gt.json"
    anno.write_text(json.dumps(PC.dataset_to_coco_gt(
        PD.Dataset(src, img_size=64), class_names=["a", "b", "c"])))
    kw = dict(imgsz=64, batch_size=4, max_labels=8, workers=0,
              anno_json=str(anno))
    want = jax_val.run(jm, v, str(src), save_json=str(tmp_path / "j.json"), **kw)
    got = port_val.run(pm, str(src), save_json=str(tmp_path / "p.json"), **kw)
    assert set(got) - {"seen"} == set(want)
    assert got["seen"] == len(SIZES)    # the unlabelled image has detections
    for k in ("mp", "mr", "map50", "map", "fitness"):
        assert got[k] == pytest.approx(want[k], abs=1e-5), k
    assert got["map50"] > 0.05 and got["map"] > 0.01      # not a match of zeros
    assert got["per_class"].keys() == want["per_class"].keys()
    for c, row in want["per_class"].items():
        np.testing.assert_allclose(got["per_class"][c], row, atol=1e-5, rtol=0)
    assert len(got["speed"]) == 3 and all(s >= 0 for s in got["speed"])
    jd = json.loads((tmp_path / "j.json").read_text())
    pd_ = json.loads((tmp_path / "p.json").read_text())
    assert len(pd_) == len(jd) > 50
    for a, b in zip(pd_, jd):
        assert (a["image_id"], a["category_id"]) == (b["image_id"], b["category_id"])
        np.testing.assert_allclose(a["bbox"], b["bbox"], atol=1e-2, rtol=0)
        assert a["score"] == pytest.approx(b["score"], abs=1e-4)
    assert got["coco"].keys() == want["coco"].keys()
    for k, val in want["coco"].items():
        assert got["coco"][k] == pytest.approx(val, abs=1e-6), k


def test_val_run_on_a_split_without_labels_or_detections(tmp_path):
    """The early return: nothing seen gives the zero result of the JAX run."""
    _, _, pm = _model_pair(ecs=False, seed=5)
    src = write_split(tmp_path / "s", sizes=SIZES[:2], empty=(0, 1))
    got = port_val.run(pm, str(src), imgsz=64, batch_size=2, max_labels=8,
                       conf_thres=0.999999, workers=0,
                       save_json=str(tmp_path / "d.json"))
    assert got == dict(mp=0, mr=0, map50=0, map=0, fitness=0, speed=(0, 0, 0))
    assert json.loads((tmp_path / "d.json").read_text()) == []


def test_val_run_fused_inference_route_runs_on_the_cpu(tmp_path):
    """``fused_inference=True`` sends every ECS site to the general-shape
    wrapper (its plain version here); the pass completes with finite
    metrics.  Its spikes may differ from the default route's near the
    threshold, so nothing is compared."""
    d = _narrow_res10()
    pm = port_yolo.build_model(
        d, nc=3, snn=SNNConfig(time_window=T, fused_inference=True), device="cpu",
        generator=torch.Generator().manual_seed(3))
    src = write_split(tmp_path / "s", sizes=SIZES[:3])
    got = port_val.run(pm, str(src), imgsz=64, batch_size=2, max_labels=8, workers=2)
    assert all(np.isfinite(got[k]) and 0 <= got[k] <= 1
               for k in ("mp", "mr", "map50", "map", "fitness"))


# --- checkpoint file and CLI ---------------------------------------------------------


def test_checkpoint_round_trip(tmp_path):
    pm = port_yolo.build_model(_narrow_res10(), nc=2, device="cpu",
                               generator=torch.Generator().manual_seed(1))
    sd = pm.state_dict()
    ema = {k: p.detach() * 0.5 for k, p in pm.named_parameters()}
    path = CK.save_checkpoint(tmp_path / "w" / "last.pt", sd, ema,
                              {"epoch": 3, "fitness": 0.25})
    assert not list(path.parent.glob("*.tmp"))
    tree, meta = CK.load_checkpoint(path)
    assert meta == {"epoch": 3, "fitness": 0.25}
    assert tree["model"].keys() == sd.keys() and tree["ema"].keys() == ema.keys()
    for k, t in sd.items():
        assert torch.equal(tree["model"][k], t)
    raw, smooth = CK.eval_state_dict(tree, use_ema=False), CK.eval_state_dict(tree)
    name = next(iter(ema))
    assert torch.equal(raw[name], sd[name]) and torch.equal(smooth[name], ema[name])
    buf = next(k for k in sd if k.endswith("running_mean"))
    assert torch.equal(smooth[buf], sd[buf])
    pm.load_state_dict(smooth, strict=True)
    # any other file is refused, a bare state_dict included
    torch.save(sd, tmp_path / "bare.pt")
    torch.save([1, 2], tmp_path / "list.pt")
    for name in ("bare.pt", "list.pt"):
        with pytest.raises(ValueError, match="not a checkpoint"):
            CK.load_checkpoint(tmp_path / name)


@pytest.mark.parametrize("variant", ["ecs_lif", "plain_lif"])
def test_val_cli_on_the_cpu(variant, tmp_path, capsys):
    cfg = tmp_path / "res10n.yaml"
    cfg.write_text(yaml.safe_dump(_narrow_res10()))
    ecs = variant == "ecs_lif"
    pm = port_yolo.build_model(cfg, nc=3, snn=SNNConfig(time_window=T, ecs=ecs),
                               device="cpu", generator=torch.Generator().manual_seed(1))
    CK.save_checkpoint(tmp_path / "last.pt", pm.state_dict(),
                       dict(pm.named_parameters()), {"epoch": 0})
    write_split(tmp_path / "val", sizes=SIZES[:3])
    data = tmp_path / "data.yaml"
    data.write_text(yaml.safe_dump(dict(path=str(tmp_path), val="val/images", nc=3)))
    argv = ["--weights", str(tmp_path / "last.pt"), "--cfg", str(cfg), "--data",
            str(data), "--imgsz", "64", "--batch-size", "2", "--time-window", str(T),
            "--device", "cpu", "--dtype", "fp32", "--workers", "0",
            "--save-json", str(tmp_path / "dets.json")] + ([] if ecs else ["--no-ecs"])
    opt = port_val.parse_opt(argv)
    assert opt.ecs is ecs and opt.use_ema and opt.conf_thres == 0.001
    res = port_val.main(opt)
    out = capsys.readouterr().out
    assert "mAP50=" in out and json.loads(out.strip().splitlines()[-1])["map"] == res["map"]
    assert (tmp_path / "dets.json").is_file()
    fused = port_val.main(port_val.parse_opt(argv + ["--fuse"]))
    assert fused["seen"] == res["seen"] and np.isfinite(fused["map"])


def test_val_cli_needs_a_card_unless_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = tmp_path / "data.yaml"
    data.write_text(yaml.safe_dump(dict(path=str(tmp_path), val="val/images", nc=3)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_val.main(port_val.parse_opt(
            ["--weights", "none.pt", "--data", str(data)]))
