"""The port's model zoo against the JAX package's YAMLs, with no JAX trace
(the counterpart of ``tests/test_model_zoo.py``): per YAML of the JAX
package, the port's parse (``rows``, ``save``, ``chs``, ``head_info``)
equals JAX's ``parse_model`` (pure Python; ``HGresnet``'s repeat count
inserted at ``HGBlock``'s ``n``), the port builds it on the ``meta`` device
from its own copy of the YAML with its probed strides; the port carries all
33 (``STILL_REFUSED`` is empty: the change that ported the last of them
emptied it), and a registry name that no YAML uses parses and builds as
JAX's, while a name in neither registry raises ``KeyError`` in both
parsers.  Each YAML of Queue 1 items 11a-11f (and three
that built before them) also serves a CPU forward, narrowed, at 64 px (the
TAL assigner wants 10 anchors), and one YAML a new block family trains a
CPU step.  The five probe models of ``chip_smoke.PROBES`` (the registry
rows of items 11g-1 to 11g-3, which no YAML names) parse as JAX's, build
on the meta device, and serve a CPU forward and train a CPU step
narrowed."""

import copy
import functools
from pathlib import Path

import chip_smoke
import numpy as np
import pytest
import torch
import yaml

from ecs_yolo_tpu.models import yolo as jax_yolo
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.data.hyps import HYP_SCRATCH
from ecs_yolo_tpu_torch.models import yolo as port_yolo
from ecs_yolo_tpu_torch.train.optim import build_optimizer
from ecs_yolo_tpu_torch.train.trainer import create_train_state, make_train_step

torch.set_num_threads(2)

ALL_YAMLS = sorted(p.name for p in Path(jax_yolo.YAML_DIR).glob("*.yaml"))
#: the JAX package's YAMLs the port does not build yet: none since items 11e-11f
STILL_REFUSED = set()
#: the YAMLs of ROADMAP Queue 1 items 11a-11d, and three that built before
#: them without a copy of their own
NEW_YAMLS = ["botnet10.yaml", "res10-ee.yaml", "res18-ee.yaml", "res18-eebk.yaml",
             "res18-sew.yaml", "resnet-test.yaml", "resnet10-v9.yaml", "resnet10ema.yaml",
             "resnet10heads.yaml", "resnet18.yaml", "resnet34-cat.yaml", "resnet_rtdetr.yaml",
             "resnetaifi.yaml", "tal.yaml"]
#: the YAMLs of items 11e (the star / GSConv / context-guide family) and 11f
#: (the CSP / HG / Ghost family)
STAR_CSP_YAMLS = ["ceshi.yaml", "resnet_v8.yaml", "starnet.yaml", "starnet2.yaml",
                  "starnet4.yaml", "HGresnet.yaml", "cspresnet10.yaml", "test.yaml",
                  "yolov5s.yaml", "yolov8s.yaml"]
#: levels a head's strides cover: its inputs over its branches
_BRANCHES = {"DualDDetect": 2, "DualDetect": 2, "TripleDDetect": 3, "TripleDetect": 3}


@functools.lru_cache(maxsize=None)
def meta_model(name):
    """The port's model of ``name`` on the meta device, built once a process
    (also for ``test_torch_port_blocks_ext``'s site table)."""
    return port_yolo.build_model(name, device="meta")


def test_port_copies_are_the_yamls_it_builds():
    """The port builds exactly the YAMLs it carries a copy of: all 33."""
    own = sorted(p.name for p in port_yolo.YAML_DIR.glob("*.yaml"))
    assert sorted(set(ALL_YAMLS) - STILL_REFUSED) == own
    assert len(own) == 33 and len(ALL_YAMLS) == 33 and not STILL_REFUSED
    assert set(NEW_YAMLS + STAR_CSP_YAMLS) <= set(own)


@pytest.mark.parametrize("block", ["HetConv", "StarBlock"])
def test_unported_registry_name_raises_keyerror(block):
    """Since item 11g-3 a name of JAX's registry that no YAML uses
    (``nn/blocks_tail2.py``'s ``HetConv``, ``nn/blocks_star.py``'s
    ``StarBlock``) parses as JAX's and builds; a name in neither registry
    raises ``KeyError`` in both parsers."""
    d = port_yolo.load_cfg("yolov8s.yaml")
    d["head"][2] = [-1, 1, block, [128]]
    assert port_yolo.parse_model(copy.deepcopy(d), 3) == jax_yolo.parse_model(
        copy.deepcopy(d), 3)
    model = port_yolo.build_model(d, device="meta")
    assert type(model.model[len(d["backbone"]) + 2]) is port_yolo.C2_BLOCKS[block]
    d["head"][2] = [-1, 1, block + "_unknown", [128]]
    for parse in (port_yolo.parse_model, jax_yolo.parse_model):
        with pytest.raises(KeyError, match=block + "_unknown"):
            parse(copy.deepcopy(d), 3)


def test_hgblock_takes_the_repeat_count_as_its_n():
    """``HGresnet``'s ``[-1, 2, HGBlock, [48, 64, 3, 2]]``: ``cm`` and
    ``c2`` unscaled, the count 2 at index 3 (``n``, two stages), stride 2;
    the stage built from the row has ``dw`` and ``m0``, ``m1``."""
    rows = port_yolo.parse_model(port_yolo.load_cfg("HGresnet.yaml"), 3)[0]
    assert [r[3] for r in rows[1:5]] == [(48, 64, 3, 2, 2), (96, 128, 3, 2, 2, True),
                                          (192, 256, 3, 2, 2, True), (384, 512, 3, 2, 2, True)]
    assert all(r[1] == 1 for r in rows[1:5])
    with torch.device("meta"):
        stage = port_yolo._construct("HGBlock", 64, rows[1][3], SNNConfig())
    assert (stage.n, stage.dw is not None, hasattr(stage, "m2")) == (2, True, False)


@pytest.mark.parametrize("name", ALL_YAMLS)
def test_yaml_parses_as_jax_and_builds(name):
    d = jax_yolo.load_cfg(name)
    if name in STILL_REFUSED:
        with pytest.raises(KeyError, match="item 11"):
            port_yolo.parse_model(dict(d), 3)
        return
    with open(port_yolo.YAML_DIR / name) as fh:
        assert yaml.safe_load(fh) == d
    rows, save, chs, head_info = port_yolo.parse_model(port_yolo.load_cfg(name), 3)
    j_rows, j_save, j_chs, j_head = jax_yolo.parse_model(dict(d), 3)
    assert (rows, save, chs, head_info) == (j_rows, j_save, j_chs, j_head)

    model = meta_model(name)
    strides = model.head_info["strides"]
    f = head_info["f"]
    levels = (len(f) if isinstance(f, (list, tuple)) else 1) // _BRANCHES.get(
        head_info["name"], 1)
    assert len(strides) == levels >= 2
    assert list(strides) == sorted(strides) and set(strides) <= {8.0, 16.0, 32.0}
    assert model.spec == port_yolo._with_head(rows, head_info, strides)


def _narrow(name):
    """``name`` at width 1/8; ``CBLinear`` groups, which the YAML gives
    unscaled, narrowed by the same factor so the ``CBFuse`` sums still match
    their targets."""
    d = port_yolo.load_cfg(name)
    d["width_multiple"] = 0.125
    for row in d["head"]:
        if row[2] == "CBLinear":
            row[3] = [[c // 8 for c in row[3][0]]]
    return d


@functools.lru_cache(maxsize=None)
def _cpu_model(name, t=2):
    """``name`` narrowed, nc 3, T=``t``, on the CPU (built once a process: a
    test that trains it takes a copy), and a 64 px batch of 2."""
    model = port_yolo.build_model(_narrow(name), nc=3, snn=SNNConfig(time_window=t),
                                  device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32))
    return model, x


@pytest.mark.parametrize("name", NEW_YAMLS + STAR_CSP_YAMLS)
def test_new_yaml_serves_a_cpu_forward(name):
    """Narrowed, T=2, 64 px: a finite eval forward with one row a class
    more than the box terms."""
    model, x = _cpu_model(name)
    with torch.no_grad():
        pred = port_yolo.head_predictions(model.head_info["name"], model(x), 3)
    assert torch.isfinite(pred).all()
    assert pred.shape[-1 if model.head_info["name"] == "Detect" else 1] == \
        3 + (5 if model.head_info["name"] == "Detect" else 4)


#: one YAML a new block and head: Conv / DDetect, the ms residuals with the
#: 3-channel site on the raw image, BasicBlock, the v9 wiring with
#: DualDDetect, EMA, AIFI / RepC3; and one a family of items 11e-11f:
#: StarBlock_2C2f / GSConv / the context-guided fusion with v10Detect,
#: StarBlock_4 / _5 with a two-level Detect, C2f / SPPF, HGBlock
STEP_YAMLS = ["resnet18.yaml", "res18-eebk.yaml", "res18-sew.yaml", "resnet10-v9.yaml",
              "resnet10ema.yaml", "resnet_rtdetr.yaml", "ceshi.yaml", "starnet4.yaml",
              "yolov8s.yaml", "HGresnet.yaml"]


#: the YAMLs whose step runs at the zoo's T=4: at T=2 narrowed yolov8s's
#: sites behind its Conv_4 rows (BN gamma 0.2 * thresh) stay silent at
#: init, and the gradient overflows float32 through the chain of
#: zero-variance BNs (each multiplies it by gamma / sqrt(eps)), in the JAX
#: package as in the port, so the step skips its update
STEP_T = {"yolov8s.yaml": 4}


@pytest.mark.parametrize("name", STEP_YAMLS)
def test_new_block_trains_a_cpu_step(name):
    """One training step of the narrowed model: a finite loss that moves
    the parameters."""
    model, x = _cpu_model(name, STEP_T.get(name, 2))
    model = copy.deepcopy(model)
    targets = torch.tensor([[[0, 0.5, 0.5, 0.4, 0.4], [2, 0.3, 0.3, 0.2, 0.3]]] * 2)
    tx = build_optimizer(dict(model.named_parameters()))
    state = create_train_state(model, tx, device="cpu")
    before = {k: p.detach().clone() for k, p in state.params.items()}
    step = make_train_step(model, tx, dict(HYP_SCRATCH), device="cpu")
    state, metrics = step(state, x, targets, torch.ones(2, 2, dtype=torch.bool))
    assert np.isfinite(float(metrics["loss"]))
    assert any(not torch.equal(p, before[k]) for k, p in state.params.items())


# --- the probe models of the registry rows no YAML names (items 11g-1 to 11g-3) -------


@pytest.mark.parametrize("probe", sorted(chip_smoke.PROBES))
def test_probe_parses_as_jax_and_builds(probe):
    """The probe's spec equals JAX's ``parse_model``; it keeps its base
    YAML's nc, depth, width and anchors; it builds on the meta device with
    one stride a level of its head."""
    d = chip_smoke.probe_cfg(probe)
    base = port_yolo.load_cfg(chip_smoke.PROBES[probe][0])
    assert {k: v for k, v in d.items() if k not in ("backbone", "head")} == \
        {k: v for k, v in base.items() if k not in ("backbone", "head")}
    rows, save, chs, head_info = port_yolo.parse_model(copy.deepcopy(d), 3)
    assert (rows, save, chs, head_info) == jax_yolo.parse_model(copy.deepcopy(d), 3)
    model = port_yolo.build_model(d, device="meta")
    want = (8.0, 16.0, 32.0) if probe in ("probe-v5", "probe-star") else (16.0, 32.0)
    assert model.head_info["strides"] == want
    assert model.spec == port_yolo._with_head(rows, head_info, want)


def _narrow_probe(probe):
    """The probe at an eighth of its width; ``RepNCSPELAN4``'s inner widths
    (c3, c4), which the YAML gives unscaled, narrowed by the same factor."""
    d = chip_smoke.probe_cfg(probe)
    d["width_multiple"] *= 0.125
    for row in d["head"]:
        if row[2] == "RepNCSPELAN4":
            row[3] = [row[3][0], row[3][1] // 8, row[3][2] // 8, *row[3][3:]]
    return d


@functools.lru_cache(maxsize=None)
def _probe_model(probe):
    """The narrowed probe, nc 3, T=4 (at T=2 probe-gelan's narrowed net is
    silent at init and its gradient overflows float32 through the
    zero-variance BN chain, as yolov8s's), on the CPU, built for and fed a
    64 px batch of 2 (probe-tail's ``TransformerBlock``s serve one size)."""
    model = port_yolo.build_model(_narrow_probe(probe), nc=3, snn=SNNConfig(time_window=4),
                                  device="cpu", imgsz=64)
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32))
    return model, x


@pytest.mark.parametrize("probe", sorted(chip_smoke.PROBES))
def test_probe_serves_a_cpu_forward(probe):
    model, x = _probe_model(probe)
    with torch.no_grad():
        pred = port_yolo.head_predictions(model.head_info["name"], model(x), 3)
    assert torch.isfinite(pred).all()
    assert pred.shape[-1 if model.head_info["name"] == "Detect" else 1] == \
        3 + (5 if model.head_info["name"] == "Detect" else 4)


@pytest.mark.parametrize("probe", sorted(chip_smoke.PROBES))
def test_probe_trains_a_cpu_step(probe):
    """One training step: a finite loss that moves the parameters, and
    ``DSSA``'s firing rates."""
    model, x = _probe_model(probe)
    model = copy.deepcopy(model)
    targets = torch.tensor([[[0, 0.5, 0.5, 0.4, 0.4], [2, 0.3, 0.3, 0.2, 0.3]]] * 2)
    tx = build_optimizer(dict(model.named_parameters()))
    state = create_train_state(model, tx, device="cpu")
    before = {k: p.detach().clone() for k, p in state.params.items()}
    rates = {k: v.clone() for k, v in state.batch_stats.items() if "firing_rate" in k}
    step = make_train_step(model, tx, dict(HYP_SCRATCH), device="cpu")
    state, metrics = step(state, x, targets, torch.ones(2, 2, dtype=torch.bool))
    assert np.isfinite(float(metrics["loss"]))
    assert any(not torch.equal(p, before[k]) for k, p in state.params.items())
    assert len(rates) == (2 if probe == "probe-gelan" else 0)
    assert all(not torch.equal(state.batch_stats[k], v) for k, v in rates.items())
