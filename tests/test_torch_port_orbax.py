"""``import_orbax.py``: a checkpoint directory of the JAX package into the
port's checkpoint file (CPU).

The JAX package's own ``save_checkpoint`` and ``strip_optimizer`` write the
directories; the imported file, loaded as ``detect`` and ``val`` load one
(``load_checkpoint`` + ``eval_state_dict``), must give the port's model the
very tensors an in-memory ``models/convert.convert`` gives it, so its
outputs are equal bit for bit.  The file holds no optimizer state, and the
driver's ``resume`` refuses it.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import import_orbax
from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu.models import yolo as jax_yolo
from ecs_yolo_tpu.utils import checkpoint as JCK
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.models import convert as CV
from ecs_yolo_tpu_torch.models import yolo as port_yolo
from ecs_yolo_tpu_torch.train import driver as PDR
from ecs_yolo_tpu_torch.utils import checkpoint as CK
from test_torch_port_model import _random_variables
from test_torch_port_tal import TINY

torch.set_num_threads(2)

T = 2


@pytest.fixture(scope="module")
def jax_dirs(tmp_path_factory):
    """A training checkpoint and its stripped artifact, written by the JAX
    package from seeded parameters, EMA parameters and BN statistics."""
    jm = jax_yolo.build_model(TINY, snn=JaxSNNConfig(time_window=T))
    v = _random_variables(lambda: jm.module.init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 64, 64, 3)), training=False), 1)
    e = {"params": jax.tree_util.tree_map(lambda a: a * 0.5 + 0.01, v["params"])}
    state = types.SimpleNamespace(params=v["params"], batch_stats=v["batch_stats"],
                                  ema_params=e["params"], step=7,
                                  opt_state={"mu": e["params"], "count": np.int32(7)})
    root = tmp_path_factory.mktemp("jax")
    JCK.save_checkpoint(root / "last", state, jm.cfg, epoch=3, best_fitness=0.25)
    JCK.strip_optimizer(root / "last", root / "best")
    return root, v, e


def _served(sd):
    model = port_yolo.build_model(TINY, snn=SNNConfig(time_window=T), device="cpu")
    model.load_state_dict(sd, strict=True)
    x = torch.from_numpy(np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        return model(x)[0]


def test_import_loads_as_the_in_memory_conversion(jax_dirs, tmp_path):
    """Both directories: the served parameters are the EMA ones (the
    training file's ``ema``; the stripped file's ``params``, where JAX
    writes the EMA)."""
    root, v, e = jax_dirs
    for which in ("last", "best"):
        out = import_orbax.main([str(root / which), str(tmp_path / f"{which}.pt")])
        tree, meta = CK.load_checkpoint(out)
        assert tree["opt_state"] is None and tree["step"] is None
        assert meta["epoch"] == 3 and meta["best_fitness"] == 0.25
        assert meta["model_cfg"]["head"] == TINY["head"]
        assert meta["imported_from"] == str((root / which).resolve())
        spec = port_yolo.parse_model(meta["model_cfg"], 3)[0]
        want = CV.convert(e["params"], v["batch_stats"], spec)
        if which == "last":
            assert set(tree["ema"]) == set(CV.convert(e["params"], None, spec))
            assert all(torch.equal(tree["model"][k], t)
                       for k, t in CV.convert(v["params"], v["batch_stats"], spec).items())
        else:
            assert tree["ema"] is None
        sd = CK.eval_state_dict(tree)
        assert sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in sd)
        assert torch.equal(_served(sd), _served(want))


def test_an_imported_file_is_not_a_resume_point(jax_dirs, tmp_path):
    root, _, _ = jax_dirs
    out = import_orbax.import_checkpoint(root / "last", tmp_path / "w.pt")
    with pytest.raises(ValueError, match="no optimizer state"):
        PDR.train(TINY, tmp_path, resume=out, device="cpu", save_dir=str(tmp_path / "r"))


def test_a_256_px_transformer_checkpoint_loads_strictly_in_the_clis(tmp_path, monkeypatch):
    """A JAX checkpoint of a ``C3TR`` model holds the 256 px position table
    JAX's driver builds (``init(imgsz=min(imgsz, 256))``); imported, the
    detect CLI builds the port's model at the size the table implies and
    loads it with ``strict=True`` (a 640 px build cannot)."""
    import yaml

    from ecs_yolo_tpu_torch import detect as port_detect
    from test_torch_port_repairs import _c3tr_cfg

    jm = jax_yolo.build_model(_c3tr_cfg(), nc=2, snn=JaxSNNConfig())
    v = _random_variables(lambda: jm.module.init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 256, 256, 3)), training=False), 4)
    # the directory's tree as orbax reads it back (its disk round trip is held
    # by the tests above)
    monkeypatch.setattr(import_orbax, "read_orbax", lambda src: (
        {"params": v["params"], "batch_stats": v["batch_stats"], "ema_params": v["params"]},
        {"model_cfg": jm.cfg, "epoch": 0}))
    out = import_orbax.main([str(tmp_path / "jax"), str(tmp_path / "c3tr.pt")])
    tree, meta = CK.load_checkpoint(out)
    sd = CK.eval_state_dict(tree)
    assert sd["model.3.m.pos"].shape == (1, 1, 64, 8) and "imgsz" not in meta
    assert port_yolo.checkpoint_imgsz(meta["model_cfg"], sd, meta, 640) == 256
    with pytest.raises(RuntimeError, match="pos"):
        port_yolo.build_model(meta["model_cfg"], device="meta").load_state_dict(sd)
    cfg = tmp_path / "c3tr.yaml"
    cfg.write_text(yaml.safe_dump(meta["model_cfg"]))
    seen = []
    monkeypatch.setattr(port_detect, "run", lambda model, *a, **k: seen.append(model) or [])
    port_detect.main(port_detect.parse_opt([
        "--cfg", str(cfg), "--source", str(tmp_path), "--weights", str(out),
        "--device", "cpu", "--dtype", "fp32"]))
    assert seen[0].model[3].m.hw == (8, 8)
    assert all(torch.equal(seen[0].state_dict()[k], t) for k, t in sd.items())
