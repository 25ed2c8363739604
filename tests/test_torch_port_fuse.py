"""The port's conv + BN fold (``ecs_yolo_tpu_torch/models/utils.py``) against
the JAX package's ``fuse_conv_bn`` (CPU), on the narrowed EMS-ResNet10 of
test_torch_port_model.py with random BN affines and running statistics; and
the ``--fuse`` flag of the port's val and detect CLIs.

Tolerances: the folded parameters are float64 on both sides (JAX inside
``jax.enable_x64()``, no compile) and agree to 1e-12; the fused eval forward
against the unfused one in float64 gives equal spikes at every neuron site
and head outputs to 1e-9.  ``count_params`` is an integer and must be equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu.models import utils as JU
from ecs_yolo_tpu.models import yolo as jax_yolo
from ecs_yolo_tpu_torch import detect as port_detect
from ecs_yolo_tpu_torch import val as port_val
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.models import convert as CV
from ecs_yolo_tpu_torch.models import utils as PU
from ecs_yolo_tpu_torch.models import yolo as port_yolo
from ecs_yolo_tpu_torch.nn.blocks import MemUpdate
from ecs_yolo_tpu_torch.utils import checkpoint as CK
from test_torch_port_model import _narrow, _random_variables
from test_torch_port_val import write_split

torch.set_num_threads(2)

T = 2


@pytest.fixture(scope="module")
def pair():
    """(numpy variables of the narrowed res10, JAX fused variables in
    float64, the port's unfused float64 model with the same weights)."""
    d = _narrow("resnet10.yaml")
    jm = jax_yolo.build_model(d, nc=2, snn=JaxSNNConfig(time_window=T))
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    v = _random_variables(
        lambda: jm.module.init(jax.random.PRNGKey(0), x, training=False), 31)
    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        fused = jax.tree_util.tree_map(np.asarray, JU.fuse_conv_bn(v64))
    pm = port_yolo.build_model(d, nc=2, snn=SNNConfig(time_window=T),
                               device="cpu").double()
    pm.load_state_dict({k: t.double() for k, t in CV.convert(
        v["params"], v["batch_stats"], pm.spec).items()}, strict=True)
    return v, fused, pm


def _fused_copy(pm):
    import copy

    fm = copy.deepcopy(pm)
    return fm, PU.fuse_conv_bn(fm)


def test_fused_parameters_match_jax_fuse_conv_bn_f64(pair):
    """The port folds into the conv (weight, new bias) and drops the BN; JAX
    keeps an identity-statistics BN whose bias carries the shift."""
    _, fused, pm = pair
    want = CV.convert(fused["params"], fused["batch_stats"], pm.spec)
    fm, folded = _fused_copy(pm)
    got = fm.state_dict()
    assert folded
    for name in folded:
        w = f"{name}.conv.weight"
        np.testing.assert_allclose(got[w].numpy(), want[w].numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=w)
        np.testing.assert_allclose(got[f"{name}.conv.bias"].numpy(),
                                   want[f"{name}.bn.bn.bias"].numpy(),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
        np.testing.assert_array_equal(want[f"{name}.bn.bn.weight"].numpy(), 1.0)
        assert not any(k.startswith(f"{name}.bn.") for k in got)
    # every other entry is untouched, on both sides
    orig = pm.state_dict()
    for k, t in got.items():
        if not any(k.startswith(f"{n}.") for n in folded):
            assert torch.equal(t, orig[k]), k
            np.testing.assert_array_equal(want[k].numpy(), orig[k].numpy(), err_msg=k)


def test_folded_pair_count_matches_jax(pair):
    """JAX folds a pair by setting its BN scale to ones (the random init
    never has ones), so the count of such scales is JAX's count."""
    v, fused, pm = pair
    flat = lambda tree: jax.tree_util.tree_flatten_with_path(tree)[0]
    before = {jax.tree_util.keystr(p): a for p, a in flat(v["params"])}
    jax_count = sum(1 for p, a in flat(fused["params"])
                    if jax.tree_util.keystr(p).endswith("['bn']['bn']['scale']")
                    and np.all(a == 1.0)
                    and not np.all(before[jax.tree_util.keystr(p)] == 1.0))
    _, folded = _fused_copy(pm)
    assert len(folded) == jax_count == 1       # the Conv_1 stem
    assert folded == ["model.0"]


def test_fused_forward_spikes_equal_the_unfused_f64(pair):
    _, _, pm = pair
    fm, _ = _fused_copy(pm)
    x = torch.from_numpy(np.random.RandomState(5).rand(2, 64, 64, 3))
    outs = []
    for m in (pm, fm):
        seen = []
        hooks = [s.register_forward_hook(lambda mod, i, o: seen.append(o.clone()))
                 for s in m.modules() if isinstance(s, MemUpdate)]
        with torch.no_grad():
            z, feats = m.eval()(x)
        for h in hooks:
            h.remove()
        outs.append((z, feats, seen))
    (z0, f0, s0), (z1, f1, s1) = outs
    assert len(s0) == len(s1) > 0
    for a, b in zip(s0, s1):
        assert torch.equal(a, b)
    assert sum(float(a.mean()) for a in s0) > 0          # the sites fire
    np.testing.assert_allclose(z1.numpy(), z0.numpy(), rtol=1e-9, atol=1e-9)
    for a, b in zip(f1, f0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-9)


def test_count_params_matches_jax_and_model_info_counts_flops(pair):
    v, _, pm = pair
    assert PU.count_params(pm) == JU.count_params(v["params"])
    fm, folded = _fused_copy(pm)
    c = fm.model[0].conv.out_channels
    # the fold drops gamma and beta and adds a conv bias
    assert PU.count_params(fm) == PU.count_params(pm) - c * len(folded)
    info = PU.model_info(fm, imgsz=64)
    assert info["params"] == PU.count_params(fm) and info["gflops"] > 0
    assert not fm.training


def test_val_and_detect_clis_fuse(tmp_path, capsys):
    cfg = tmp_path / "res10n.yaml"
    cfg.write_text(yaml.safe_dump(_narrow("resnet10.yaml")))
    pm = port_yolo.build_model(cfg, nc=3, snn=SNNConfig(time_window=4), device="cpu",
                               generator=torch.Generator().manual_seed(1))
    CK.save_checkpoint(tmp_path / "last.pt", pm.state_dict(),
                       dict(pm.named_parameters()), {"epoch": 0})
    images = write_split(tmp_path / "val", sizes=[(48, 80), (64, 64)])
    data = tmp_path / "data.yaml"
    data.write_text(yaml.safe_dump(dict(path=str(tmp_path), val="val/images", nc=3)))
    argv = ["--weights", str(tmp_path / "last.pt"), "--cfg", str(cfg), "--data",
            str(data), "--imgsz", "64", "--batch-size", "2", "--device", "cpu",
            "--dtype", "fp32", "--workers", "0", "--fuse"]
    opt = port_val.parse_opt(argv)
    assert opt.fuse
    res = port_val.main(opt)
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1])["map"] == res["map"]
    assert all(np.isfinite(res[k]) for k in ("mp", "mr", "map50", "map", "fitness"))
    dopt = port_detect.parse_opt(
        ["--weights", str(tmp_path / "last.pt"), "--cfg", str(cfg), "--source",
         str(images), "--nc", "3", "--imgsz", "64", "--device", "cpu", "--dtype",
         "fp32", "--save-dir", str(tmp_path / "det"), "--fuse", "--conf-thres",
         "0.001"])
    assert dopt.fuse
    results = port_detect.main(dopt)
    assert len(results) == 2
    assert all(np.isfinite(d).all() for _, d in results)
