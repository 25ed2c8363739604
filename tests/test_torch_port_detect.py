"""The port's detect path against the JAX package (CPU): letterbox, the image
loader, box mapping, and ``detect.run`` end to end on a narrowed EMS-ResNet10
with weights carried across; plus the CLI, and the rule that the port and
``chip_smoke.py`` import nothing of JAX or of the JAX package.

Detections are compared in native-image pixels: atol 2e-3 px (the model's
float32 outputs agree to ~1e-4 relative, see test_torch_port_model.py, and
the letterbox gain scales them up by at most 3x here).
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from ecs_yolo_tpu import detect as jax_detect
from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu.data.augment import letterbox as jax_letterbox
from ecs_yolo_tpu.data.loaders import LoadImages as JaxLoadImages
from ecs_yolo_tpu.models import yolo as jax_yolo
from ecs_yolo_tpu.ops import boxes as JBX
from ecs_yolo_tpu_torch import detect as port_detect
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.data.augment import letterbox
from ecs_yolo_tpu_torch.data.loaders import LoadImages
from ecs_yolo_tpu_torch.models import convert as CV
from ecs_yolo_tpu_torch.models import yolo as port_yolo
from ecs_yolo_tpu_torch.ops import boxes as PBX
from tests.test_torch_port_model import _random_variables

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _images(tmp_path, shapes, seed=0):
    rng = np.random.RandomState(seed)
    for i, (h, w) in enumerate(shapes):
        im = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        Image.fromarray(im).save(tmp_path / f"im{i}.png")
    return tmp_path


@pytest.mark.parametrize("shape", [(48, 80), (100, 37), (64, 64)])
@pytest.mark.parametrize("auto", [False, True])
def test_letterbox_matches_jax(shape, auto):
    im = (np.random.RandomState(1).rand(*shape, 3) * 255).astype(np.uint8)
    got, want = letterbox(im, 64, auto=auto), jax_letterbox(im, 64, auto=auto)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_load_images_matches_jax(tmp_path):
    src = _images(tmp_path, [(48, 80), (90, 60)])
    for (pp, pim, pim0), (jp, jim, jim0) in zip(LoadImages(src, 64),
                                                JaxLoadImages(src, 64)):
        assert pp == jp
        np.testing.assert_array_equal(pim, jim)
        np.testing.assert_array_equal(pim0, jim0)


def test_box_ops_match_jax():
    rng = np.random.RandomState(2)
    b = (rng.rand(20, 6) * 120 - 20).astype(np.float32)
    np.testing.assert_allclose(PBX.xywh2xyxy(torch.from_numpy(b)).numpy(),
                               np.asarray(JBX.xywh2xyxy(jnp.asarray(b))))
    np.testing.assert_allclose(
        PBX.clip_coords(torch.from_numpy(b[:, :4]), (50, 70)).numpy(),
        np.asarray(JBX.clip_coords(jnp.asarray(b[:, :4]), (50, 70))))
    np.testing.assert_allclose(
        PBX.scale_coords((64, 64), torch.from_numpy(b[:, :4]), (48, 80)).numpy(),
        np.asarray(JBX.scale_coords((64, 64), jnp.asarray(b[:, :4]), (48, 80))),
        rtol=1e-6, atol=1e-5)


def _narrow_res10():
    d = port_yolo.load_cfg("resnet10.yaml")
    d["width_multiple"] = 0.25
    return d


@pytest.fixture(scope="module")
def models():
    d = _narrow_res10()
    jm = jax_yolo.build_model(d, nc=2, snn=JaxSNNConfig(time_window=2))
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    v = _random_variables(
        lambda: jm.module.init(jax.random.PRNGKey(0), x, training=False), 3)
    pm = port_yolo.build_model(d, nc=2, snn=SNNConfig(time_window=2),
                               device="cpu")
    pm.load_state_dict(CV.convert(v["params"], v["batch_stats"], pm.spec),
                       strict=True)
    return jm, v, pm


def test_detect_run_matches_jax(models, tmp_path):
    jm, v, pm = models
    src = tmp_path / "in"
    src.mkdir()
    _images(src, [(48, 80), (64, 64), (100, 37)], seed=4)
    kw = dict(imgsz=64, conf_thres=0.05, iou_thres=0.45, max_det=40)
    want = jax_detect.run(jm, v, src, **kw)
    got = port_detect.run(pm, src, save_dir=str(tmp_path / "out"),
                          save_txt=True, **kw)
    assert sum(len(d) for _, d in want) > 0
    for (gp, gd), (wp, wd) in zip(got, want):
        assert gp == wp
        assert gd.shape == wd.shape
        np.testing.assert_allclose(gd, wd, atol=2e-3, rtol=1e-5)
    for p, _ in got:
        assert (tmp_path / "out" / Path(p).name).is_file()
        assert (tmp_path / "out" / (Path(p).stem + ".txt")).is_file()


def test_cli_runs_with_saved_weights(tmp_path, capsys):
    cfg = tmp_path / "res10n.yaml"
    cfg.write_text(yaml.safe_dump(_narrow_res10()))
    weights = tmp_path / "w.pt"
    pm = port_yolo.build_model(cfg, nc=2, device="cpu",
                               generator=torch.Generator().manual_seed(1))
    torch.save(pm.state_dict(), weights)
    src = _images(tmp_path, [(64, 64)], seed=5)
    opt = port_detect.parse_opt([
        "--cfg", str(cfg), "--nc", "2", "--source", str(src), "--imgsz", "64",
        "--weights", str(weights), "--device", "cpu", "--dtype", "fp32",
        "--conf-thres", "0.05", "--save-dir", str(tmp_path / "o")])
    assert opt.dtype == "fp32"
    results = port_detect.main(opt)
    assert len(results) == 1
    assert "1 images" in capsys.readouterr().out


def _port_sources():
    pkg = REPO / "ecs_yolo_tpu_torch"
    return sorted(p for p in pkg.rglob("*.py")
                  if "_build" not in p.relative_to(pkg).parts) + [
        REPO / "chip_smoke.py"]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    banned = ("jax", "flax", "ecs_yolo_tpu")
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in banned, f"{path}: imports {m}"
