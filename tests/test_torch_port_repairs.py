"""Two repaired faults of the port (CPU, no JAX): the val dataset's label
cache, which must key on the label files and hold the rows before
``single_cls``, and the detect CLI, which must read the port's own
checkpoint format with its EMA parameters.
"""

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
