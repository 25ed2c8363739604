"""The port's loading and serving API against the JAX package (CPU):
``hub.create`` / ``attempt_load`` / ``Ensemble``, the reference ``.pt``
import (``models/torch_import.py``), ``AutoShape`` -> ``Detections``, and
``val.run`` / ``detect.run`` on a ``backends.DetectMultiBackend``.

A narrowed res10 (width 0.25, T=2, 64 px) with random weights, lively BN
statistics included, written as a reference checkpoint (a pickled module
tree, as the reference's ``.pt`` files are): JAX's ``hub.create`` imports it
through its torch importer, the port's through its copy of the name map.
JAX's ``create`` starts from ``BuiltModel.init``, an eager flax init of the
whole model that costs about a minute on this CPU; the test puts the
abstract init of ``jax.eval_shape`` with random values in its place (every
value is then overwritten by the import).  The one JAX compile is the JAX
``AutoShape``'s jitted forward, in one test; the others use the port
alone.

Tolerances: the imported weights are equal (float32, exact); the
detections agree to atol/rtol 1e-4 in float32, as the whole models of
``tests/test_torch_port_model.py`` do (the two frameworks' convolutions sum
in different orders).  A backend's predictions, NMS outputs and metrics
equal the eager port's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from ecs_yolo_tpu import hub as jax_hub
from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu.models import torch_import as jax_import
from ecs_yolo_tpu.models import yolo as jax_yolo
from ecs_yolo_tpu_torch import backends, detect as port_detect, export, hub
from ecs_yolo_tpu_torch import val as port_val
from ecs_yolo_tpu_torch.autoshape import Detections
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.models import convert as CV
from ecs_yolo_tpu_torch.models import torch_import as port_import
from ecs_yolo_tpu_torch.models import yolo as port_yolo
from tests.test_torch_port_export import _lively
from tests.test_torch_port_model import _random_variables
from tests.test_torch_port_val import write_split

torch.set_num_threads(2)

T, NC, NAMES = 2, 2, ["car", "person"]
CFG = SNNConfig(time_window=T)
IMAGE_SIZES = [(64, 64), (48, 80), (70, 50)]


def _narrow_res10():
    d = port_yolo.load_cfg("resnet10.yaml")
    d["width_multiple"] = 0.25
    return d


def _reference_pickle(state_dict, path):
    """A reference-style checkpoint: ``{"model": module, ...}`` whose module
    tree holds ``state_dict``'s tensors under their names."""
    root = nn.Module()
    for name, t in state_dict.items():
        *parents, leaf = name.split(".")
        node = root
        for p in parents:
            if not hasattr(node, p):
                node.add_module(p, nn.Module())
            node = getattr(node, p)
        node.register_buffer(leaf, t.clone())
    torch.save({"model": root, "epoch": 3}, path)
    return path


def _images():
    rng = np.random.RandomState(3)
    return [(rng.rand(h, w, 3) * 255).astype(np.uint8) for h, w in IMAGE_SIZES]


def test_reference_import_and_autoshape_match_jax(tmp_path):
    """JAX's and the port's ``hub.create(autoshape=True)`` on one reference
    checkpoint: the imported weights, then ``Detections`` with and without
    a class filter.  One test, so that the JAX compile runs once."""
    d = _narrow_res10()
    jm = jax_yolo.build_model(d, nc=NC, snn=JaxSNNConfig(time_window=T))
    shapes = jax.eval_shape(lambda: jm.module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), training=False))
    v = _random_variables(None, 7, shapes)
    sd = CV.convert(v["params"], v["batch_stats"], jm.spec)
    ref = _reference_pickle(sd, tmp_path / "reference.pt")
    with pytest.MonkeyPatch.context() as mp:
        # the values of a seeded abstract init, every one overwritten by the import
        mp.setattr(jax_yolo.BuiltModel, "init",
                   lambda self, key, **kw: _random_variables(None, 1, shapes))
        mp.setattr(jax_hub, "build_model", lambda *a, **k: jm)     # built above
        jas = jax_hub.create(d, str(ref), nc=NC, snn=JaxSNNConfig(time_window=T),
                             autoshape=True, names=NAMES, imgsz=64)
    pas = hub.create(d, str(ref), nc=NC, snn=CFG, autoshape=True, names=NAMES, imgsz=64,
                     device="cpu")

    got = pas.model.state_dict()
    want = CV.convert(jas.variables["params"], jas.variables["batch_stats"], pas.model.spec)
    assert set(got) == set(want) == set(sd)
    for k in want:
        assert torch.equal(got[k], want[k].to(got[k].dtype)), k
    report = pas.model.import_report
    assert not report["missed"] and sorted(report["matched"]) == sorted(sd)
    mapping = port_import.build_mapping(pas.model.spec)
    assert set(mapping) == set(jax_import.build_mapping(pas.model.spec))
    assert set(mapping.values()) == set(got)

    for classes in (None, [1]):
        for m in (jas, pas):
            m.conf, m.classes = 0.05, classes
        want, got = jas(_images()), pas(_images())
        assert isinstance(got, Detections) and len(got) == len(want) == 3
        assert sum(len(p) for p in want.pred) > 3
        for view in ("pred", "xyxy", "xywh", "xyxyn", "xywhn"):
            for a, b in zip(getattr(got, view), getattr(want, view)):
                assert a.shape == b.shape, view
                np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=view)
        if classes:
            assert all(set(p[:, 5].astype(int)) <= {1} for p in got.pred)
        assert got.s == want.s and got.files == want.files and got.names == NAMES


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(the port's AutoShape from ``hub.create`` on a reference checkpoint,
    that file): random weights with lively BN statistics from a seed."""
    tmp = tmp_path_factory.mktemp("hub")
    model = _lively(port_yolo.build_model(_narrow_res10(), nc=NC, snn=CFG, device="cpu",
                                          imgsz=64), seed=7)
    ref = _reference_pickle(model.state_dict(), tmp / "reference.pt")
    pas = hub.create(_narrow_res10(), str(ref), nc=NC, snn=CFG, autoshape=True, names=NAMES,
                     imgsz=64, device="cpu")
    return pas, ref


def test_detections_views_frames_and_files(served, tmp_path):
    pas, _ = served
    pas.conf, pas.classes = 0.05, None
    det = pas(_images())
    frames = det.pandas()
    for k in ("xyxy", "xyxyn", "xywh", "xywhn"):
        df = getattr(frames, k)[0]
        assert len(df) == len(det.pred[0])
        assert list(df["name"]) == [NAMES[int(c)] for c in det.pred[0][:, 5]]
    assert list(frames.xyxy[0].columns) == ["xmin", "ymin", "xmax", "ymax", "confidence",
                                            "class", "name"]
    parts = det.tolist()
    assert len(parts) == 3 and np.array_equal(parts[1].pred, det.pred[1])
    det.print()
    crops = det.crop(save=True, save_dir=tmp_path / "crop")
    assert len(crops) == sum(len(p) for p in det.pred)
    saved = list((tmp_path / "crop").rglob("*.jpg"))
    assert 0 < len(saved) <= len(crops)
    out = det.save(save_dir=tmp_path / "saved")
    assert sorted(p.name for p in out.iterdir()) == sorted(det.files)
    rendered = det.render()
    assert rendered[0].shape == _images()[0].shape


def test_backends_val_and_detect_equal_the_eager_model(served, tmp_path):
    """``DetectMultiBackend`` over the pt2 artifact and over the checkpoint:
    ``predict`` (numpy), ``val.run`` (NMS outputs, metrics) and
    ``detect.run`` equal the eager model's."""
    pas, _ = served
    model = pas.model
    src = write_split(tmp_path / "s", sizes=IMAGE_SIZES + [(40, 60)], nc=NC)
    paths = export.run(model, ("pt2", "native"), tmp_path / "ex", imgsz=64, batch=2,
                       names=NAMES)
    pt2 = backends.DetectMultiBackend(paths["pt2"], device="cpu")
    ckpt = backends.DetectMultiBackend(paths["native"], cfg=_narrow_res10(), device="cpu",
                                       snn=CFG)
    assert (pt2.head_name, pt2.nc, pt2.names, pt2.imgsz) == ("Detect", NC, NAMES, 64)
    x = np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(x))[0].numpy()
    for b in (pt2, ckpt):
        assert np.array_equal(b.predict(x), want)
    real, seen = port_val.non_max_suppression, []

    def nms(*a, **k):
        out = real(*a, **k)
        seen.append(out)
        return out

    port_val.non_max_suppression = nms
    try:
        kw = dict(imgsz=64, batch_size=2, workers=0, conf_thres=0.05)
        r_eager = port_val.run(model, str(src), **kw)
        r_pt2 = port_val.run(pt2, str(src), **kw)
    finally:
        port_val.non_max_suppression = real
    assert r_eager["seen"] == r_pt2["seen"] == 4
    for k in ("mp", "mr", "map50", "map", "fitness"):
        assert r_eager[k] == r_pt2[k], k
    half = len(seen) // 2
    assert half == 2 and all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                             for a, b in zip(seen[:half], seen[half:]))
    d_eager = port_detect.run(model, str(src), imgsz=64, conf_thres=0.05)
    d_ckpt = port_detect.run(ckpt, str(src), imgsz=64, conf_thres=0.05)
    assert [p for p, _ in d_eager] == [p for p, _ in d_ckpt]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(d_eager, d_ckpt))
    assert sum(len(a) for _, a in d_eager) > 0


def test_attempt_load_and_ensemble(served, tmp_path):
    pas, ref = served
    from ecs_yolo_tpu_torch.utils.checkpoint import save_checkpoint

    ckpt = save_checkpoint(tmp_path / "port.pt", pas.model.state_dict(), None, {})
    one = hub.attempt_load(str(ckpt), _narrow_res10(), nc=NC, snn=CFG, device="cpu")
    assert isinstance(one, port_yolo.DetectionModel)
    ens = hub.attempt_load([str(ckpt), str(ref)], _narrow_res10(), nc=NC, snn=CFG,
                           device="cpu")
    assert isinstance(ens, hub.Ensemble) and len(ens.members) == 2
    x = torch.from_numpy(np.random.RandomState(5).rand(1, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        z = ens(x)
        parts = [m(x)[0] for m in ens.members]
    assert torch.equal(z, torch.cat(parts, 1))
    assert torch.equal(parts[0], parts[1])      # both files hold the same weights
