"""The port's hyp evolution (``train/evolve.py``, ``--evolve``) and its tools
CLI (``python -m ecs_yolo_tpu_torch.tools``) against the JAX package (CPU).

* ``mutate`` equals JAX's at one seed: the mutation draws come from the same
  ``random.Random`` seed, the parent draw from an ``np.random.RandomState``
  where JAX draws it with the global ``np.random`` (seeded with the same
  seed here), so the hyps are equal to the bit.
* ``evolve`` over four generations with a deterministic fitness writes
  JAX's ``evolve.csv`` and returns JAX's best hyps; ``--evolve 2`` runs
  through the train CLI on a narrowed model.
* each ``tools`` subcommand runs once on the CPU: ``voxelize`` and
  ``image-list`` write what the JAX package's functions write; ``prune``,
  ``firing-rate``, ``export`` and ``profile`` on a narrowed res10.
"""

import functools
import json
import random

import numpy as np
import pytest
import torch
import yaml

from ecs_yolo_tpu.data import events as JE
from ecs_yolo_tpu.data.dataset import find_images as jax_find_images
from ecs_yolo_tpu.train import evolve as jax_evolve
from ecs_yolo_tpu_torch import tools
from ecs_yolo_tpu_torch.data.hyps import HYP_SCRATCH
from ecs_yolo_tpu_torch.models import yolo as port_yolo
from ecs_yolo_tpu_torch.train import __main__ as train_cli
from ecs_yolo_tpu_torch.train import driver
from ecs_yolo_tpu_torch.train import evolve
from ecs_yolo_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tests.test_torch_port_events import write_stream
from tests.test_torch_port_export import _lively
from tests.test_torch_port_val import write_split

torch.set_num_threads(2)


def _history(seed):
    rng = np.random.RandomState(seed)
    return [(float(f), {k: v * (1 + 0.1 * rng.randn()) for k, v in HYP_SCRATCH.items()})
            for f in rng.rand(7)]


@pytest.mark.parametrize("with_history", [False, True])
@pytest.mark.parametrize("seed", [0, 5])
def test_mutate_equals_jax_at_one_seed(seed, with_history):
    history = _history(seed) if with_history else []
    assert evolve.META == jax_evolve.META
    np.random.seed(seed)        # JAX's parent draw reads the global state
    want = jax_evolve.mutate(dict(HYP_SCRATCH), history, random.Random(seed))
    got = evolve.mutate(dict(HYP_SCRATCH), history, random.Random(seed),
                        parent_rng=np.random.RandomState(seed))
    assert got == want
    assert got != dict(HYP_SCRATCH)
    for k, (gain, lo, hi) in evolve.META.items():
        if k in got:
            assert lo <= got[k] <= hi


def test_evolve_writes_jax_csv_and_best_hyps(tmp_path):
    def fitness(h):      # a fitness the hyps decide alone
        return h["lr0"] * 10 + h["momentum"] - h["box"]

    np.random.seed(3)
    want = jax_evolve.evolve(fitness, dict(HYP_SCRATCH), generations=4,
                             save_dir=tmp_path / "jax", seed=3)
    got = evolve.evolve(fitness, dict(HYP_SCRATCH), generations=4,
                        save_dir=tmp_path / "port", seed=3)
    assert got == want
    assert ((tmp_path / "port" / "evolve.csv").read_text()
            == (tmp_path / "jax" / "evolve.csv").read_text())


def _narrow_yaml(tmp_path):
    d = port_yolo.load_cfg("resnet10.yaml")
    d["width_multiple"] = 0.25
    path = tmp_path / "res10-narrow.yaml"
    path.write_text(yaml.safe_dump(d))
    return path


def test_train_cli_evolves_two_generations(tmp_path, monkeypatch):
    # the csv logger alone: the TensorBoard writer imports TensorFlow here
    monkeypatch.setattr(driver, "train", functools.partial(driver.train,
                                                           loggers_include=("csv",)))
    src = write_split(tmp_path / "d", sizes=[(64, 64), (48, 80), (70, 50), (40, 60)], nc=2)
    data = tmp_path / "data.yaml"
    data.write_text(yaml.safe_dump({"path": str(tmp_path / "d"), "train": "images",
                                    "nc": 2}))
    assert src.is_dir()
    best = train_cli.main(train_cli.parse_opt([
        "--evolve", "2", "--cfg", str(_narrow_yaml(tmp_path)), "--data", str(data),
        "--hyp", "", "--epochs", "1", "--batch-size", "2", "--nbs", "2", "--imgsz", "32",
        "--workers", "0", "--noautoanchor", "--device", "cpu", "--noval",
        "--project", str(tmp_path / "runs"), "--name", "ev"]))
    run = tmp_path / "runs" / "ev"
    rows = (run / "evolve.csv").read_text().splitlines()
    assert len(rows) == 3 and rows[0].startswith("fitness,")
    assert yaml.safe_load((run / "hyp_evolve.yaml").read_text()) == best
    assert set(best) >= set(evolve.META) & set(HYP_SCRATCH)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A narrowed res10 (T=4, the CLI's default) as a checkpoint of the port,
    with the YAML it was built from."""
    tmp = tmp_path_factory.mktemp("tools")
    cfg = _narrow_yaml(tmp)
    model = _lively(port_yolo.build_model(str(cfg), nc=2, device="cpu", imgsz=64), seed=2)
    return cfg, save_checkpoint(tmp / "w.pt", model.state_dict(), None, {"imgsz": 64})


def _run(argv, capsys):
    out = tools.main(tools.parse_opt(argv))
    return out, capsys.readouterr().out


def test_tools_prune(checkpoint, tmp_path, capsys):
    cfg, w = checkpoint
    report, text = _run(["prune", "--weights", str(w), "--cfg", str(cfg), "--nc", "2",
                         "--ratio", "0.5", "--out", str(tmp_path), "--device", "cpu"], capsys)
    assert json.loads(text.splitlines()[0]) == report
    assert 0 < report["pruned_channels"] < report["total_channels"]
    tree, meta = load_checkpoint(tmp_path / "pruned.pt")
    assert meta["pruned"] == report
    zeros = sum(int((v == 0).sum()) for k, v in tree["model"].items()
                if k.endswith("bn.weight"))
    assert zeros >= report["pruned_channels"]


def test_tools_firing_rate(checkpoint, tmp_path, capsys):
    cfg, w = checkpoint
    src = write_split(tmp_path / "d", sizes=[(64, 64), (48, 80), (70, 50)], nc=2)
    rates, text = _run(["firing-rate", "--weights", str(w), "--cfg", str(cfg), "--nc", "2",
                        "--data", str(src), "--imgsz", "64", "--batches", "2",
                        "--out", str(tmp_path / "fr"), "--device", "cpu"], capsys)
    assert len(rates) == 24 and all(k.endswith("/firing_rate/0") for k in rates)
    assert json.loads(text) == {k: round(v, 4) for k, v in rates.items()}
    layers = np.load(tmp_path / "fr" / "fr_layers.npy")
    assert layers.tolist() == sorted(rates)
    np.testing.assert_allclose(np.load(tmp_path / "fr" / "fr_firerate.npy"),
                               [rates[k] for k in sorted(rates)])


def test_tools_export_and_profile(checkpoint, tmp_path, capsys):
    cfg, w = checkpoint
    out, text = _run(["export", "--weights", str(w), "--cfg", str(cfg), "--nc", "2",
                      "--imgsz", "64", "--dtype", "fp32", "--include", "torchscript",
                      "--out", str(tmp_path / "ex"), "--device", "cpu"], capsys)
    assert json.loads(text) == {"torchscript": str(tmp_path / "ex" / "model.torchscript")}
    assert json.loads((tmp_path / "ex" / "metadata.json").read_text())["imgsz"] == 64
    with pytest.raises(SystemExit):
        tools.parse_opt(["export", "--int8"])
    (info, rows), text = _run(["profile", "--cfg", str(cfg), "--nc", "2", "--imgsz", "64",
                               "--device", "cpu"], capsys)
    assert info["params"] > 0 and info["gflops"] > 0
    assert len(rows) == len(text.splitlines()) - 1 and rows[-1]["name"] == "Detect"


def test_tools_voxelize_and_image_list_write_what_jax_writes(tmp_path, capsys):
    dat, lbl, _ = write_stream(tmp_path)
    n, text = _run(["voxelize", "--dat", str(dat), "--labels", str(lbl), "--out",
                    str(tmp_path / "port"), "--t-bins", "2"], capsys)
    want = JE.build_dataset([(str(dat), str(lbl))], tmp_path / "jax", t_bins=2)
    assert n == want == 4 and text.startswith(f"wrote {n} samples")
    port_list = (tmp_path / "port" / "train.txt").read_text().splitlines()
    jax_list = (tmp_path / "jax" / "train.txt").read_text().splitlines()
    assert port_list == [f.replace("/jax/", "/port/") for f in jax_list]
    np.testing.assert_array_equal(np.load(port_list[0]), np.load(jax_list[0]))
    src = write_split(tmp_path / "s", sizes=[(20, 30), (30, 20)], nc=2)
    files, _ = _run(["image-list", "--root", str(src), "--out", str(tmp_path / "l.txt")],
                    capsys)
    assert files == jax_find_images(str(src))
    assert (tmp_path / "l.txt").read_text().splitlines() == files
