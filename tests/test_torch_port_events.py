"""Event mode against the JAX package (CPU): the Gen1 pipeline of
``data/events.py`` (the ``.dat`` reader, the painter, the voxelizer, the box
normaliser, ``build_dataset``'s files and ``EventDataset``'s items and
batches), the native painter, a narrowed EMS-ResNet10 at T=5 on a 5-D
batch, ``val.run`` over an ``EventDataset`` (JAX's branch without ``meta``)
and an event-mode epoch of the driver (``--events`` from the CLI).

Tolerances: the pipeline is numpy and PIL on both sides and must be equal.
The model runs in float64 on both sides (eval, where the port's neuron
sites take their kernels' plain versions, and training mode) and agrees to
1e-9.  ``val.run``: JAX's pass is fed the port's predictions (its
exported-model branch), so the metrics must be equal.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ecs_yolo_tpu import native as jax_native
from ecs_yolo_tpu import val as jax_val
from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu.data import events as JE
from ecs_yolo_tpu.models import yolo as jax_yolo
from ecs_yolo_tpu_torch import native as port_native
from ecs_yolo_tpu_torch import val as port_val
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.data import events as PE
from ecs_yolo_tpu_torch.models import convert as CV
from ecs_yolo_tpu_torch.models import yolo as port_yolo
from ecs_yolo_tpu_torch.train import __main__ as port_cli
from ecs_yolo_tpu_torch.train import driver as PDR
from test_torch_port_heads import _FAST, _assert_tree_close
from test_torch_port_model import _random_variables

torch.set_num_threads(2)

T = 5


def write_dat(path, t, x, y, p):
    """A Prophesee GEN1 ``.dat``: '%' header lines, event type and size
    bytes, then ``(timestamp u4, word u4)`` records."""
    rec = np.empty(len(t), np.dtype([("t", "<u4"), ("w", "<u4")]))
    rec["t"] = t
    rec["w"] = (x & 0x3FFF) | ((y & 0x3FFF) << 14) | ((p & 0xF) << 28)
    with open(path, "wb") as fh:
        fh.write(b"% Test stream\n% height 240\n% width 304\n")
        fh.write(bytes([0x0C, 8]))
        fh.write(rec.tobytes())


def write_stream(root, seed=0, n_ts=4):
    """A 0.9 s stream of random events and its box records at ``n_ts``
    labelled timestamps: two tracks a timestamp, one repeated (the last
    record kept), one box partly off the frame, one timestamp before the
    first full window (skipped) and one with only a degenerate box
    (dropped)."""
    rng = np.random.RandomState(seed)
    t = np.arange(0, 900_000, 60, dtype=np.int64)
    x, y = rng.randint(-3, 310, len(t)), rng.randint(-3, 245, len(t))
    p = rng.randint(0, 2, len(t))
    dat = root / "stream_td.dat"
    write_dat(dat, t, x, y, p)
    rows = []
    for k, ts in enumerate([100_000] + [300_000 + 150_000 * i for i in range(n_ts)]):
        for tr in range(3):
            rows.append((ts, rng.uniform(-20, 280), rng.uniform(-20, 220),
                         rng.uniform(10, 90), rng.uniform(10, 70), tr % 2, 1.0, tr % 2))
    rows.append((800_000, 10.0, 10.0, 0.0, 5.0, 0, 1.0, 9))
    boxes = np.array(rows, dtype=JE.BBOX_DTYPE)
    lbl = root / "boxes.npy"
    np.save(lbl, boxes)
    return dat, lbl, boxes


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen1")
    dat, lbl, boxes = write_stream(root)
    n = {}
    for name, mod in (("jax", JE), ("port", PE)):
        n[name] = mod.build_dataset([(str(dat), str(lbl))], root / name, t_bins=T)
    return root, dat, lbl, boxes, n


def test_reader_painter_voxelizer_and_boxes_match_jax(stream):
    _, dat, _, boxes, _ = stream
    jr, pr = JE.DatReader(dat), PE.DatReader(dat)
    assert pr.n_events == jr.n_events == 15_000
    for ts, dt in ((0, 30_000), (123_456, 77_000), (880_000, 90_000), (950_000, 10)):
        jr.seek_time(ts)
        pr.seek_time(ts)
        je, pe = jr.load_delta_t(dt), pr.load_delta_t(dt)
        assert pe.dtype == je.dtype
        np.testing.assert_array_equal(pe, je)
        np.testing.assert_array_equal(PE.paint_events(pe), JE.paint_events(je))
    for ts in (250_000, 600_000):
        np.testing.assert_array_equal(
            PE.voxelize_sample(PE.DatReader(dat), ts, t_bins=T),
            JE.voxelize_sample(JE.DatReader(dat), ts, t_bins=T))
    for ts in np.unique(boxes["ts"]):
        got = PE.normalize_boxes(boxes[boxes["ts"] == ts])
        np.testing.assert_array_equal(got, JE.normalize_boxes(boxes[boxes["ts"] == ts]))
    assert PE.normalize_boxes(boxes[:0]).shape == (0, 5)


def test_native_painter_matches_jax_native():
    rng = np.random.RandomState(3)
    n = 20_000
    xs, ys = rng.randint(-5, 310, n), rng.randint(-5, 250, n)
    ps = rng.randint(-1, 3, n)
    want = jax_native.paint_events(xs, ys, ps, np.full((240, 304, 3), 127, np.uint8))
    got = port_native.paint_events(xs, ys, ps, np.full((240, 304, 3), 127, np.uint8))
    np.testing.assert_array_equal(got, want)
    ev = np.zeros(n, [("t", "<i8"), ("x", "<i4"), ("y", "<i4"), ("p", "<i4")])
    ev["x"], ev["y"], ev["p"] = xs, ys, ps
    np.testing.assert_array_equal(got, PE.paint_events(ev))
    with pytest.raises(ValueError, match="length"):
        port_native.paint_events(xs, ys[:-1], ps, got)


def test_build_dataset_files_match_jax(stream):
    root, _, _, _, n = stream
    assert n["port"] == n["jax"] == 4
    jfiles = (root / "jax" / "train.txt").read_text().splitlines()
    pfiles = (root / "port" / "train.txt").read_text().splitlines()
    assert [f.replace("/jax/", "/port/") for f in jfiles] == pfiles
    for jf, pf in zip(jfiles, pfiles):
        for a, b in ((jf, pf), (jf.replace("/images/", "/labels/"),
                                pf.replace("/images/", "/labels/"))):
            ja, pa = np.load(a), np.load(b)
            assert pa.dtype == ja.dtype and pa.shape == ja.shape
            np.testing.assert_array_equal(pa, ja)
    assert np.load(pfiles[0]).shape == (T, 240, 304, 3)


BATCHES = {
    "plain": dict(batch_size=2),
    "shuffle_tail_padded": dict(batch_size=3, shuffle=True, seed=4, drop_last=False,
                                yield_count=True),
    "host_shard": dict(batch_size=2, host_shard=(1, 2)),
    "larger_than_the_set": dict(batch_size=5, yield_count=True),
}


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_event_dataset_items_and_batches_match_jax(stream, case):
    root, *_ = stream
    kw = BATCHES[case]
    jd = JE.EventDataset(root / "jax" / "train.txt", img_size=64, max_labels=4)
    pd = PE.EventDataset(root / "port" / "train.txt", img_size=64, max_labels=4)
    assert len(pd) == len(jd) == 4
    for a, b in zip(pd[1], jd[1]):
        np.testing.assert_array_equal(a, b)
    got, want = list(pd.batches(**kw)), list(jd.batches(**kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert got[0][0].shape[1:] == (T, 64, 64, 3) and got[0][0].dtype == np.float32
    with pytest.raises(ValueError, match="quad"):
        next(pd.batches(2, quad=True))


def _narrow(cfg="resnet10.yaml"):
    d = port_yolo.load_cfg(cfg)
    d["width_multiple"] = 0.25
    return d


def test_event_model_matches_jax_f64_in_eval_and_training():
    """A narrowed res10 built for T=5 on a ``[N, T, H, W, C]`` batch whose
    five steps differ (the stem runs at each: no T=1 broadcast), in both
    packages with every weight converted: the eval output, the training
    output and the moved BN statistics in float64 to 1e-9."""
    d = _narrow()
    pm = port_yolo.build_model(d, nc=2, snn=SNNConfig(time_window=T), device="cpu")
    snn = JaxSNNConfig(time_window=T)
    spec, save, chs, head = jax_yolo.parse_model(dict(d, nc=2), 3)
    head["strides"] = pm.head_info["strides"]
    module = jax_yolo.DetectionModel(
        spec=jax_yolo._with_head_args(spec, head["index"], head["name"], head,
                                      head["strides"]),
        save=save, snn=snn, packing=jax_yolo._plan_packing(spec, chs, snn.packed_c64),
        tinv_prefix=jax_yolo._t_invariant_prefix(spec, save))
    assert pm.spec == module.spec and pm.tinv_prefix == module.tinv_prefix > 0
    v = _random_variables(lambda: module.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 64, 64, 3)), training=False), 5)
    # 32 px: XLA's cheap compile runs the float64 graph slowly, by pixel
    x = np.random.RandomState(2).rand(2, T, 32, 32, 3)

    def run(v_, x_):
        out = module.apply(v_, x_, training=False)
        return out, module.apply(v_, x_, training=True, mutable=["batch_stats"])

    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        want, (want_t, upd) = jax.jit(run, compiler_options=_FAST)(v64, x)
    pm.load_state_dict(CV.convert(v["params"], v["batch_stats"], pm.spec), strict=True)
    pm = pm.double()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = pm.eval()(xt)
    got_t = pm.train()(xt)
    _assert_tree_close(got, want)
    _assert_tree_close(got_t, want_t)
    sd = pm.state_dict()
    for k, w in CV.convert({}, upd["batch_stats"], pm.spec).items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-12, rtol=0, err_msg=k)


def test_val_run_on_events_matches_jax_without_meta(stream, monkeypatch):
    """``val.run`` over an ``EventDataset`` (batch 3 over 4 samples: a
    padded tail): its NMS inputs recorded, JAX's ``val.run`` handed the same
    predictions through its exported-model branch (``variables=None``, a
    model with ``predict``) must give the same metrics and ``seen``."""
    root, *_ = stream
    pm = port_yolo.build_model(_narrow(), nc=2, snn=SNNConfig(time_window=T), device="cpu")
    preds = []
    real = port_val.non_max_suppression
    monkeypatch.setattr(port_val, "non_max_suppression",
                        lambda pred, **kw: (preds.append(pred.numpy().copy()),
                                            real(pred, **kw))[1])
    kw = dict(batch_size=3, conf_thres=0.2, iou_thres=0.5, max_det=50)
    got = port_val.run(pm, None, dataset=PE.EventDataset(root / "port" / "train.txt",
                                                         img_size=64, max_labels=4), **kw)
    assert len(preds) == 2 and got["seen"] > 0
    fed = iter(preds)
    fake = types.SimpleNamespace(head_name="Detect", nc=2,
                                 predict=lambda images: next(fed))
    want = jax_val.run(fake, None, None, dataset=JE.EventDataset(
        root / "jax" / "train.txt", img_size=64, max_labels=4), **kw)
    for k in ("mp", "mr", "map50", "map", "fitness"):
        assert got[k] == pytest.approx(want[k], abs=1e-12), k


def test_train_events_runs_an_epoch_with_t_from_the_data(stream, tmp_path, monkeypatch):
    """``train(events=True)`` on the CPU: one epoch of a narrowed res10 on
    the 4 event samples (batch 2, accumulate 1), the model built at the
    data's T=5, the options event mode refuses turned off, the val pass
    over the event split; and ``--events`` reaching ``train`` from the
    CLI."""
    root, *_ = stream
    split = str(root / "port" / "train.txt")
    built = []
    real = port_yolo.build_model
    monkeypatch.setattr(PDR, "build_model",
                        lambda *a, **k: (built.append(k["snn"]), real(*a, **k))[1])
    state, _, hist = PDR.train(
        _narrow(), split, split, nc=2, epochs=1, batch_size=2, imgsz=64, nbs=2,
        workers=0, quad=True, device_augment=True, steps_per_call=2, multi_scale=True,
        loggers_include=("csv",), device="cpu", save_dir=str(tmp_path / "r"),
        events=True)
    assert [s.time_window for s in built] == [T]
    h = hist[0]
    assert h["micro_steps"] == 2 and h["applies"] == 2 and h["loss_finite"]
    assert h["img_size"] == 64 and h["seen"] == 4
    assert (tmp_path / "r" / "weights" / "last.pt").exists()

    data = tmp_path / "gen1.yaml"
    data.write_text(yaml.safe_dump(dict(path=str(root / "port"), train="train.txt",
                                        val="train.txt", nc=2)))
    seen = {}
    monkeypatch.setattr(PDR, "train", lambda **kw: seen.update(kw))
    port_cli.main(port_cli.parse_opt(["--events", "--data", str(data)]))
    assert seen["events"] and seen["train_path"] == split
