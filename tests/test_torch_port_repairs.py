"""Repaired faults of the port (CPU, no JAX): the val dataset's label
cache, which must key on the label files and hold the rows before
``single_cls``; the detect CLI, which must read the port's own checkpoint
format with its EMA parameters; the disk image cache, which must not hand
out the resized shape as the native size when an image's ``.hw0.npy``
sidecar is missing; the RAM-cache guard, which must count images
smaller than ``img_size`` at the size they are upscaled to; and the model
size of a ``TransformerBlock`` model, which the driver and the val and
detect CLIs must take from ``imgsz`` and the checkpoint, not fix at 640 px.
"""

import builtins
import io
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from ecs_yolo_tpu_torch import detect as port_detect
from ecs_yolo_tpu_torch.data import dataset as PD
from ecs_yolo_tpu_torch.models import yolo as port_yolo
from ecs_yolo_tpu_torch.utils.checkpoint import save_checkpoint
from tests.test_torch_port_val import write_split

torch.set_num_threads(2)

SIZES = [(40, 56), (64, 48), (32, 32)]


def test_single_cls_cache_does_not_poison_a_multi_class_run(tmp_path):
    src = write_split(tmp_path / "s", sizes=SIZES, nc=3)
    cache = str(tmp_path / "cache")
    single = PD.Dataset(src, img_size=64, cache_dir=cache, single_cls=True)
    assert all((lb[:, 0] == 0).all() for lb in single.labels)
    multi = PD.Dataset(src, img_size=64, cache_dir=cache, single_cls=False)
    want = [PD.load_label_file(p) for p in multi.label_files]
    assert any((w[:, 0] > 0).any() for w in want)
    for got, w in zip(multi.labels, want):
        np.testing.assert_array_equal(got, w)


def test_edited_label_file_is_read_again(tmp_path):
    src = write_split(tmp_path / "s", sizes=SIZES, nc=3)
    cache = str(tmp_path / "cache")
    first = PD.Dataset(src, img_size=64, cache_dir=cache)
    path = Path(first.label_files[1])
    path.write_text("2 0.5 0.5 0.25 0.25\n1 0.25 0.25 0.125 0.125\n")
    st = os.stat(path)        # a later mtime, whatever the clock's grain
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    again = PD.Dataset(src, img_size=64, cache_dir=cache)
    np.testing.assert_array_equal(
        again.labels[1], np.array([[2, .5, .5, .25, .25], [1, .25, .25, .125, .125]],
                                  np.float32))
    for i in (0, 2):
        np.testing.assert_array_equal(again.labels[i], first.labels[i])


def _disk_cached(src, cache):
    """A val dataset over ``src`` with the disk image cache, every image
    loaded once (cached)."""
    ds = PD.Dataset(src, img_size=64, cache_images="disk", cache_dir=cache,
                    augment=False, uint8_out=True)
    for i in range(ds.n):
        ds.load_image(i)
    return ds


def test_disk_cache_without_its_sidecar_decodes_the_native_size_again(tmp_path):
    src = write_split(tmp_path / "s", sizes=SIZES, nc=3)
    cache = tmp_path / "npy"
    ds = _disk_cached(src, cache)
    sidecars = sorted(cache.glob("*.hw0.npy"))
    assert len(sidecars) == len(SIZES) and not list(cache.glob("*.tmp"))
    for p in sidecars:          # a run stopped between its two writes
        p.unlink()
    again = PD.Dataset(src, img_size=64, cache_images="disk", cache_dir=cache,
                       augment=False, uint8_out=True)
    for i, (h0, w0) in enumerate(SIZES):
        im, hw0, hw = again.load_image(i)
        assert hw0 == (h0, w0) and hw == im.shape[:2]
        assert max(hw) == 64
    assert len(list(cache.glob("*.hw0.npy"))) == len(SIZES)
    assert not list(cache.glob("*.tmp"))
    for i, (h0, w0) in enumerate(SIZES):    # now served from the cache, sidecar read
        assert again.load_image(i)[1] == (h0, w0)


def test_val_pass_over_a_cache_without_sidecars_keeps_native_boxes(monkeypatch, tmp_path,
                                                                     narrow_model):
    from ecs_yolo_tpu_torch import val as port_val

    src = write_split(tmp_path / "s", sizes=SIZES, nc=3)
    native = []
    real = port_val.to_native
    monkeypatch.setattr(port_val, "to_native",
                        lambda xyxy, meta: native.append(real(xyxy, meta)) or native[-1])

    def boxes(ds):
        del native[:]
        port_val.run(narrow_model, str(src), imgsz=64, batch_size=2, dataset=ds,
                     conf_thres=0.0, device="cpu", workers=1)
        return [b.copy() for b in native]

    plain = boxes(None)
    ds = _disk_cached(src, tmp_path / "npy")
    for p in (tmp_path / "npy").glob("*.hw0.npy"):
        p.unlink()
    cached = boxes(ds)
    assert len(plain) == len(cached) == 2 * len(SIZES)      # labels and detections
    assert sum(len(b) for b in plain) > len(SIZES)
    for a, b in zip(plain, cached):
        np.testing.assert_array_equal(a, b)


def _meminfo(kb):
    """``open`` for the dataset module with ``/proc/meminfo`` reading
    ``MemAvailable: kb``."""
    def fake(path, *a, **k):
        if str(path) == "/proc/meminfo":
            return io.StringIO(f"MemTotal: 999999 kB\nMemAvailable: {kb} kB\n")
        return builtins.open(path, *a, **k)
    return fake


@pytest.mark.parametrize("kb,cached", [(20, False), (50, True)])
def test_ram_cache_guard_counts_small_images_at_their_upscaled_size(monkeypatch, tmp_path,
                                                                   kb, cached):
    """Three 32x32 images at img_size 64 take 3 * 3 * 64 * 64 = 36864 bytes
    once upscaled; the old estimate, 3 * 3 * 32 * 32 = 9216, passed 80 % of
    20 kB (16384 bytes), which the cache exceeds."""
    src = write_split(tmp_path / "s", sizes=[(32, 32)] * 3, nc=3)
    monkeypatch.setattr(PD, "open", _meminfo(kb), raising=False)
    ds = PD.Dataset(src, img_size=64, cache_images="ram", augment=False)
    assert (ds.cache_images == "ram") is cached
    if cached:
        for i in range(ds.n):
            ds.load_image(i)
        assert sum(im.nbytes for im in ds.ims) == 3 * 3 * 64 * 64 < 0.8 * kb * 1024


@pytest.fixture(scope="module")
def narrow_cfg(tmp_path_factory):
    d = port_yolo.load_cfg("resnet10.yaml")
    d["width_multiple"] = 0.25
    path = tmp_path_factory.mktemp("cfg") / "res10n.yaml"
    path.write_text(yaml.safe_dump(d))
    return path


@pytest.fixture(scope="module")
def narrow_model(narrow_cfg):
    return port_yolo.build_model(narrow_cfg, nc=2, device="cpu",
                                 generator=torch.Generator().manual_seed(1))


def _main(monkeypatch, cfg, weights, src, *extra):
    """``detect.main`` on ``weights``; returns the model it would run."""
    seen = []
    monkeypatch.setattr(port_detect, "run",
                        lambda model, *a, **k: seen.append(model) or [])
    port_detect.main(port_detect.parse_opt([
        "--cfg", str(cfg), "--nc", "2", "--source", str(src), "--imgsz", "64",
        "--weights", str(weights), "--device", "cpu", "--dtype", "fp32", *extra]))
    return seen[0]


@pytest.mark.parametrize("use_ema", [True, False])
def test_detect_reads_a_saved_checkpoint_and_its_ema(monkeypatch, tmp_path, narrow_cfg,
                                                      narrow_model, use_ema):
    pm = narrow_model
    ema = {k: v + 1.0 for k, v in pm.named_parameters()}
    weights = save_checkpoint(tmp_path / "last.pt", pm.state_dict(), ema, {"epoch": 3})
    model = _main(monkeypatch, narrow_cfg, weights, tmp_path,
                  *([] if use_ema else ["--no-ema"]))
    got = model.state_dict()
    want = dict(pm.state_dict(), **ema) if use_ema else pm.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_detect_refuses_a_bare_state_dict(monkeypatch, tmp_path, narrow_cfg,
                                          narrow_model):
    torch.save(narrow_model.state_dict(), tmp_path / "bare.pt")
    with pytest.raises(ValueError, match="not a checkpoint of this package"):
        _main(monkeypatch, narrow_cfg, tmp_path / "bare.pt", tmp_path)


def _c3tr_cfg():
    """A tiny v1 model with a ``C3TR`` (a ``TransformerBlock``, whose
    position table serves one image size) at stride 32."""
    return {"nc": 2, "depth_multiple": 1.0, "width_multiple": 1.0,
            "anchors": [[10, 14, 23, 27, 37, 58], [81, 82, 135, 169, 344, 319]],
            "backbone": [[-1, 1, "Conv_1", [8, 3, 4]], [-1, 1, "BasicBlock_2", [16, 3, 4]],
                         [-1, 1, "BasicBlock_2", [16, 3, 2]]],
            "head": [[-1, 1, "C3TR", [16]], [[1, 3], 1, "Detect", ["nc", "anchors"]]]}


def test_a_transformer_model_trains_at_64_px_and_both_clis_serve_it(tmp_path):
    """The driver builds at ``min(imgsz, 256)`` (JAX's ``init`` size) and
    records it; the val and detect CLIs build at the checkpoint's size.
    Built at 640 px whatever ``imgsz`` said, the model raised at its first
    64 px forward."""
    from ecs_yolo_tpu_torch import val as port_val
    from ecs_yolo_tpu_torch.train import driver as PDR
    from ecs_yolo_tpu_torch.utils.checkpoint import load_checkpoint

    src = write_split(tmp_path / "s", sizes=[(64, 64), (48, 64)], nc=2)
    cfg = tmp_path / "c3tr.yaml"
    cfg.write_text(yaml.safe_dump(_c3tr_cfg()))
    PDR.train(str(cfg), str(src), str(src), nc=2, epochs=1, batch_size=2, imgsz=64,
              nbs=2, workers=0, save_dir=str(tmp_path / "run"), loggers_include=("csv",),
              autoanchor=False, device="cpu")
    weights = tmp_path / "run" / "weights" / "last.pt"
    tree, meta = load_checkpoint(weights)
    assert meta["imgsz"] == 64 and tree["model"]["model.3.m.pos"].shape == (1, 1, 4, 8)
    data = tmp_path / "data.yaml"
    data.write_text(yaml.safe_dump(dict(path=str(tmp_path / "s"), val="images", nc=2)))
    res = port_val.main(port_val.parse_opt([
        "--weights", str(weights), "--cfg", str(cfg), "--data", str(data), "--imgsz", "64",
        "--batch-size", "2", "--workers", "0", "--device", "cpu", "--dtype", "fp32"]))
    assert "map50" in res
    out = port_detect.main(port_detect.parse_opt([
        "--cfg", str(cfg), "--nc", "2", "--source", str(src), "--imgsz", "64",
        "--weights", str(weights), "--device", "cpu", "--dtype", "fp32",
        "--save-dir", str(tmp_path / "det")]))
    assert len(out) == 2
