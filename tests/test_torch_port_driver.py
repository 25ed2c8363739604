"""The port's training driver and what it stands on (``ecs_yolo_tpu_torch/
train/{optim,trainer,driver,__main__}.py``, ``utils/{checkpoint,general,
loggers}.py``) against the JAX package (CPU).

* Gradient accumulation: the port's optimizer against the JAX package's
  ``build_optimizer(accumulate=k)`` (``optax.MultiSteps(apply_if_finite)``)
  in float64 at every micro-step, to 1e-11 (the float32 schedules are
  bit-equal, the rest reassociates).
* The accumulating train step is held against the port's own float64
  arithmetic (two gradient passes, their running mean, one apply of the
  non-accumulating optimizer with the schedules counted in applies, one EMA
  update), exactly: a JAX compile of the step would take longer than this
  file's time budget; the non-accumulating step is held against JAX's in
  test_torch_port_train.py.
* ``general`` and ``loggers`` against the JAX copies; the CLI's flags
  against root ``train.py``'s; ``train()`` end to end on a narrowed res10 at
  64 px with val every epoch, resume and early stopping.
"""

import copy
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from ecs_yolo_tpu.train import optim as JO
from ecs_yolo_tpu.utils import general as JG
from ecs_yolo_tpu.utils import loggers as JLG
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.data.hyps import HYP_SCRATCH
from ecs_yolo_tpu_torch.models import yolo as port_yolo
from ecs_yolo_tpu_torch.train import __main__ as PCLI
from ecs_yolo_tpu_torch.train import driver as PDR
from ecs_yolo_tpu_torch.train import ema as PE
from ecs_yolo_tpu_torch.train import optim as PO
from ecs_yolo_tpu_torch.train import trainer as PT
from ecs_yolo_tpu_torch.utils import checkpoint as CK
from ecs_yolo_tpu_torch.utils import general as PG
from ecs_yolo_tpu_torch.utils import loggers as PLG
from test_torch_port_model import _narrow
from test_torch_port_train import _targets
from test_torch_port_val import write_split

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
T = 2


def _t64(a):
    return torch.from_numpy(np.array(a, np.float64))


# --- gradient accumulation -------------------------------------------------------


@pytest.mark.parametrize("name", ["SGD", "AdamW"])
@pytest.mark.parametrize("k", [2, 4])
def test_accumulating_optimizer_matches_multisteps_f64(k, name):
    """Three windows of k micro-gradients, one of them not finite (in the
    last window): parameters equal at every micro-step (they move only at
    apply boundaries), the poisoned window skipped and counted on both
    sides.  Then one more window: the port applies it (its mean was reset),
    while ``MultiSteps`` keeps the NaN in its mean (``0 * NaN``) and skips
    it too (the deviation named in the port's ``train/optim.py``)."""
    rng = np.random.RandomState(7 + k)
    shapes = {"conv/kernel": (3, 3, 2, 4), "conv/bias": (4,), "bn/scale": (4,)}
    names = {"conv/kernel": "m.0.weight", "conv/bias": "m.0.bias",
             "bn/scale": "m.1.bn.weight"}
    p0 = {key: rng.randn(*s) for key, s in shapes.items()}
    gs = [{key: rng.randn(*s) for key, s in shapes.items()} for _ in range(4 * k)]
    gs[2 * k + 1]["conv/kernel"][0, 0, 1, 2] = np.inf
    kw = dict(name=name, lr0=0.02, lrf=0.1, momentum=0.9, weight_decay=0.01,
              epochs=3, steps_per_epoch=2 * k, warmup_epochs=1.0,
              warmup_floor=3.0 * k, accumulate=k)
    tree = lambda d: {"conv": {"kernel": d["conv/kernel"], "bias": d["conv/bias"]},
                      "bn": {"scale": d["bn/scale"]}}
    pp = {names[key]: _t64(v) for key, v in p0.items()}
    ptx = PO.build_optimizer(pp, **kw)
    pst = ptx.init(pp)
    boundaries = []
    with jax.enable_x64():
        jp = jax.tree_util.tree_map(jnp.asarray, tree(p0))
        tx = JO.build_optimizer(jp, **kw)
        st = tx.init(jp)
        update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
            *tx.update(g, s, p)))
        for i, g in enumerate(gs):
            jp, st = update(jax.tree_util.tree_map(jnp.asarray, tree(g)), st, jp)
            applied, boundary = ptx.update(pp, {names[key]: _t64(v)
                                                for key, v in g.items()}, pst)
            boundaries.append(boundary)
            assert boundary == ((i + 1) % k == 0) and (applied is None) != boundary
            errors = int(st.inner_opt_state.total_notfinite)
            if i < 3 * k:
                assert int(pst.errors) == errors
                for key, v in (("conv/kernel", jp["conv"]["kernel"]),
                               ("conv/bias", jp["conv"]["bias"]),
                               ("bn/scale", jp["bn"]["scale"])):
                    np.testing.assert_allclose(pp[names[key]].numpy(), np.asarray(v),
                                               atol=1e-11, rtol=1e-11,
                                               err_msg=f"{key} micro-step {i}")
            if boundary and i < 3 * k:
                assert bool(applied) == (i != 3 * k - 1)
        want_last = {key: np.asarray(v) for key, v in (
            ("conv/kernel", jp["conv"]["kernel"]), ("conv/bias", jp["conv"]["bias"]),
            ("bn/scale", jp["bn"]["scale"]))}
    assert sum(boundaries) == 4 and int(pst.count) == 3 and int(pst.errors) == 1
    assert errors == 2                      # MultiSteps stays poisoned
    assert bool(applied)
    moved = [np.abs(pp[names[key]].numpy() - want_last[key]).max() for key in want_last]
    assert min(moved) > 0 and all(torch.isfinite(t).all() for t in pp.values())
    assert pst.mini_step == 0 and all(not a.any() for a in pst.acc.values())


@pytest.fixture(scope="module")
def narrow_model():
    pm = port_yolo.build_model(_narrow("resnet10.yaml"), nc=2, snn=SNNConfig(
        time_window=T), device="cpu", generator=torch.Generator().manual_seed(3))
    return pm.double()


def _micro_batches():
    rng = np.random.RandomState(12)
    out = []
    for seed in (13, 14):
        t, mask = _targets(2, 4, 2, seed=seed, n_valid=3)
        out.append((torch.from_numpy(rng.rand(2, 64, 64, 3)), _t64(t),
                    torch.from_numpy(mask)))
    return out


def test_accumulated_step_and_ema_on_apply_boundaries_f64(narrow_model):
    """``make_train_step(accumulate=2)`` over two micro-batches: after the
    first, parameters and EMA unchanged, BN statistics moved; after the
    second, parameters equal one apply of the mean gradient and the EMA one
    update with 1 apply, exactly."""
    hyp = dict(HYP_SCRATCH)
    kw = dict(lr0=hyp["lr0"], lrf=hyp["lrf"], momentum=hyp["momentum"],
              weight_decay=hyp["weight_decay"], epochs=2, steps_per_epoch=4,
              warmup_epochs=1.0, warmup_floor=4.0)
    pm = copy.deepcopy(narrow_model)
    ref = copy.deepcopy(narrow_model)
    tx = PO.build_optimizer(dict(pm.named_parameters()), accumulate=2, **kw)
    state = PT.create_train_state(pm, tx, device="cpu")
    step = PT.make_train_step(pm, tx, hyp, accumulate=2, device="cpu")
    batches = _micro_batches()
    p0 = {k: v.clone() for k, v in state.params.items()}
    b0 = {k: v.clone() for k, v in state.batch_stats.items()}

    state, m = step(state, *batches[0])
    assert m["boundary"] is False and m["applied"] is None and int(state.step) == 1
    for k, v in state.params.items():
        assert torch.equal(v, p0[k]) and torch.equal(state.ema_params[k], p0[k])
    assert any(not torch.equal(v, b0[k]) for k, v in state.batch_stats.items()
               if v.is_floating_point())
    state, m = step(state, *batches[1])
    assert m["boundary"] is True and bool(m["applied"]) and int(state.step) == 2

    # the same arithmetic, spelled out with the port's pieces
    rtx = PO.build_optimizer(dict(ref.named_parameters()), accumulate=1,
                             **dict(kw, steps_per_epoch=2, warmup_floor=2.0))
    rstate = PT.create_train_state(ref, rtx, device="cpu")
    grad_fn = PT.make_grad_fn(ref, hyp)
    g1 = grad_fn(rstate, *batches[0])[2]
    g2 = grad_fn(rstate, *batches[1])[2]
    mean = {k: g1[k] + (g2[k] - g1[k]) / 2.0 for k in g1}
    assert bool(rtx.apply(rstate.params, mean, rstate.opt_state))
    PE.ema_update(rstate.ema_params, rstate.params, 1)
    # the first apply's learning rate is warmup_bias_lr for biases, 0 else
    assert all(not torch.equal(v, p0[k]) for k, v in state.params.items()
               if k.endswith(".bias"))
    for k, v in state.params.items():
        assert torch.equal(v, rstate.params[k]), k
        assert torch.equal(state.ema_params[k], rstate.ema_params[k]), k
    for k, v in state.batch_stats.items():
        assert torch.equal(v, rstate.batch_stats[k]), k
    with pytest.raises(ValueError, match="accumulate"):
        PT.make_train_step(pm, tx, hyp, accumulate=3, device="cpu")


# --- checkpoint ------------------------------------------------------------------


def test_training_checkpoint_round_trip_and_older_files(narrow_model, tmp_path):
    pm = copy.deepcopy(narrow_model)
    tx = PO.build_optimizer(dict(pm.named_parameters()), accumulate=2, name="Adam")
    state = PT.create_train_state(pm, tx, device="cpu")
    for s, t in zip((state.opt_state.mu, state.opt_state.nu, state.opt_state.acc),
                    (1.0, 2.0, 3.0)):
        for v in s.values():
            v.fill_(t)
    state.opt_state.count.fill_(5)
    state.opt_state.errors.fill_(2)
    state.opt_state.mini_step = 1
    path = CK.save_checkpoint(tmp_path / "last.pt", pm.state_dict(), state.ema_params,
                              {"epoch": 4, "best_fitness": 0.5},
                              opt_state=state.opt_state.tensors(), step=11)
    tree, meta = CK.load_checkpoint(path)
    assert meta == {"epoch": 4, "best_fitness": 0.5} and tree["step"] == 11
    fresh = tx.init(dict(pm.named_parameters()))
    fresh.load(tree["opt_state"])
    assert fresh.mini_step == 1 and int(fresh.count) == 5 and int(fresh.errors) == 2
    for a, b in ((fresh.mu, state.opt_state.mu), (fresh.nu, state.opt_state.nu),
                 (fresh.acc, state.opt_state.acc)):
        assert all(torch.equal(a[k], b[k]) for k in b)
    with pytest.raises(ValueError, match="another optimizer"):
        PO.build_optimizer(dict(pm.named_parameters())).init(
            dict(pm.named_parameters())).load(tree["opt_state"])
    # a file of the earlier format (model, EMA, meta) loads the same way
    old = CK.save_checkpoint(tmp_path / "old.pt", pm.state_dict(), state.ema_params,
                             {"epoch": 0})
    otree, ometa = CK.load_checkpoint(old)
    assert otree["opt_state"] is None and otree["step"] is None and ometa == {"epoch": 0}
    pm.load_state_dict(CK.eval_state_dict(otree), strict=True)
    with pytest.raises(ValueError, match="no optimizer state"):
        PDR.train(_narrow("resnet10.yaml"), tmp_path, resume=old, device="cpu",
                  save_dir=str(tmp_path / "r"))
    # the stripped artifact: EMA parameters and buffers, no optimizer
    CK.strip_optimizer(path, tmp_path / "best_stripped.pt")
    stree, smeta = CK.load_checkpoint(tmp_path / "best_stripped.pt")
    assert smeta["stripped"] and stree["opt_state"] is None and stree["ema"] is None
    assert all(torch.equal(stree["model"][k], v) for k, v in state.ema_params.items())


# --- general and loggers ---------------------------------------------------------


def test_general_matches_jax(tmp_path):
    for mod, d in ((PG, tmp_path / "p"), (JG, tmp_path / "j")):
        assert mod.increment_path(d / "exp", mkdir=True) == d / "exp"
    (tmp_path / "exp").mkdir()
    (tmp_path / "exp2").mkdir()
    assert PG.increment_path(tmp_path / "exp") == JG.increment_path(tmp_path / "exp")
    assert PG.increment_path(tmp_path / "exp", exist_ok=True) == tmp_path / "exp"
    fits = [0.1, 0.3, 0.2, 0.3, 0.25, 0.2, 0.1, 0.05]
    for patience in (0, 1, 2, 3):
        ps, js = PG.EarlyStopping(patience), JG.EarlyStopping(patience)
        assert [ps(e, f) for e, f in enumerate(fits)] == \
            [js(e, f) for e, f in enumerate(fits)]
        assert (ps.best_epoch, ps.best_fitness) == (js.best_epoch, js.best_fitness)
    pc, jc = PG.Callbacks(), JG.Callbacks()
    assert set(pc.get_registered_actions()) == set(jc.get_registered_actions())
    seen = []
    pc.register_action("on_train_end", callback=lambda *a: seen.append(a))
    pc.run("on_train_end", 1, 2)
    assert seen == [(1, 2)]
    with pytest.raises(KeyError):
        pc.register_action("no_such_hook", callback=print)
    with pytest.raises(AssertionError):
        jc.register_action("no_such_hook", callback=print)
    for size in (30, 64, 100, 641):
        assert PG.check_img_size(size) == JG.check_img_size(size)
        assert PG.check_img_size(size, 64, 128) == JG.check_img_size(size, 64, 128)
    data = {"nc": 2, "train": "t", "names": ["a", "b"], "path": str(tmp_path)}
    assert PG.check_dataset(dict(data)) == JG.check_dataset(dict(data))
    for bad in ({"nc": 2}, dict(data, names=["a"])):     # the port raises, JAX asserts
        with pytest.raises(ValueError):
            PG.check_dataset(bad)
        with pytest.raises(AssertionError):
            JG.check_dataset(bad)


def test_loggers_write_the_jax_csv(tmp_path):
    rng = np.random.RandomState(0)
    rows = [dict({k: float(rng.rand()) for k in PLG.LOG_KEYS}, fitness=float(rng.rand()))
            for _ in range(3)]
    assert PLG.LOG_KEYS == JLG.LOG_KEYS and len(PLG.LOG_KEYS) == 13
    for mod, d in ((PLG, tmp_path / "p"), (JLG, tmp_path / "j")):
        lg = mod.Loggers(d, include=("csv",))
        for e, r in enumerate(rows):
            lg.log_metrics(r, step=e)
        lg.close()
    assert (tmp_path / "p" / "results.csv").read_text() == \
        (tmp_path / "j" / "results.csv").read_text()


# --- train() end to end, the CLI -------------------------------------------------


def test_train_end_to_end_on_the_cpu(tmp_path):
    """Narrowed res10, 64 px, T=2, 6 images, batch 2, nbs 4 (accumulate 2),
    2 epochs with val each, image weights and multi-scale epochs; then
    resume from last for a third with patience 1, its restored state equal
    to the saved one bit for bit, and its early stop as the JAX
    ``EarlyStopping`` decides on the same fitness."""
    tr = write_split(tmp_path / "tr", sizes=[(48, 80), (64, 64), (100, 37),
                                             (30, 45), (64, 50), (90, 120)], nc=3)
    va = write_split(tmp_path / "va", sizes=[(48, 80), (64, 64)], seed=1, nc=3)
    kw = dict(nc=3, batch_size=2, imgsz=64, nbs=4, snn=SNNConfig(time_window=T),
              loggers_include=("csv",), device="cpu")
    d = _narrow("resnet10.yaml")
    state, best, hist = PDR.train(d, tr, va, epochs=2, workers=2, image_weights=True,
                                  multi_scale=True, save_dir=str(tmp_path / "run"), **kw)
    assert all(h["img_size"] % 32 == 0 and 32 <= h["img_size"] <= 96 for h in hist)
    w = tmp_path / "run" / "weights"
    assert {p.name for p in w.iterdir()} == {"best.pt", "last.pt", "best_stripped.pt"}
    assert [h["epoch"] for h in hist] == [0, 1]
    assert all(h["loss_finite"] and h["micro_steps"] == 3 and h["seen"] == 2
               for h in hist)
    assert sum(h["applies"] for h in hist) == int(state.step) // 2 == 3
    assert int(state.opt_state.count) == sum(h["applied"] for h in hist)
    csv = (tmp_path / "run" / "results.csv").read_text().splitlines()
    assert len(csv) == 3 and set(csv[0].split(",")) == {"step", "fitness", *PLG.LOG_KEYS}
    assert best == max(h["fitness"] for h in hist)

    saved, meta = CK.load_checkpoint(w / "last.pt")
    checked = []

    def restored(st):
        assert int(st.step) == saved["step"] == 6
        assert all(torch.equal(st.params[k], saved["model"][k]) for k in st.params)
        assert all(torch.equal(st.ema_params[k], saved["ema"][k]) for k in st.ema_params)
        got = st.opt_state.tensors()
        assert got["mini_step"] == saved["opt_state"]["mini_step"] == 0
        for key in ("mu", "acc"):
            assert all(torch.equal(v, saved["opt_state"][key][k])
                       for k, v in got[key].items())
        checked.append(True)

    cb = PG.Callbacks()
    cb.register_action("on_train_start", callback=restored)
    _, best2, hist2 = PDR.train(d, tr, va, epochs=4, workers=0, patience=1,
                                resume=w / "last.pt", callbacks=cb,
                                save_dir=str(tmp_path / "run2"), **kw)
    assert checked and hist2[0]["epoch"] == 2
    stopper = JG.EarlyStopping(1)
    stopper.best_fitness, stopper.best_epoch = meta["best_fitness"], 1
    want = []
    for e in range(2, 4):
        want.append(e)
        if stopper(e, hist2[e - 2]["fitness"]):
            break
    assert [h["epoch"] for h in hist2] == want


def test_train_an_anchor_free_head_on_the_cpu(tmp_path, monkeypatch):
    """A narrowed res10v8 (ASFF_DDetect, the TAL loss), one epoch of 4
    images with val on the EMA copy, as the JAX driver trains it: no
    autoanchor, a warm-up floor of 100, the first three step items logged
    (box, cls, dfl), the box gain of ``HYP_SCRATCH`` in the loss."""
    tr = write_split(tmp_path / "tr", sizes=[(48, 80), (64, 64), (100, 37), (64, 50)],
                     nc=3)
    va = write_split(tmp_path / "va", sizes=[(64, 64)], seed=1, nc=3)
    seen = {}

    def no_autoanchor(*a, **k):
        raise AssertionError("autoanchor runs for the Detect head only")

    def build_optimizer(*a, **k):
        seen["warmup_floor"] = k["warmup_floor"]
        return PO.build_optimizer(*a, **k)

    val_run = PDR.val_mod.run

    def run(model, *a, **k):
        seen["val_params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
        return val_run(model, *a, **k)

    def step_fn(*a, **k):
        step = make_train_step(*a, **k)
        seen["hyp_box"] = a[2]["box"]

        def wrapped(state, *batch):
            state, m = step(state, *batch)
            seen.setdefault("items", []).append(m["items"].clone())
            return state, m
        return wrapped

    make_train_step = PDR.make_train_step
    monkeypatch.setattr(PDR, "_autoanchor", no_autoanchor)
    monkeypatch.setattr(PDR, "build_optimizer", build_optimizer)
    monkeypatch.setattr(PDR.val_mod, "run", run)
    monkeypatch.setattr(PDR, "make_train_step", step_fn)
    state, _, hist = PDR.train(_narrow("res10v8.yaml"), tr, va, nc=3, epochs=1,
                               batch_size=2, imgsz=64, nbs=4, workers=0,
                               snn=SNNConfig(time_window=T), loggers_include=("csv",),
                               save_dir=str(tmp_path / "run"), device="cpu")
    assert seen["warmup_floor"] == 100.0 and seen["hyp_box"] == HYP_SCRATCH["box"]
    assert [tuple(i.shape) for i in seen["items"]] == [(3,), (3,)]
    mean = torch.stack(seen["items"]).mean(0)
    np.testing.assert_allclose(hist[0]["mloss"], mean.numpy(), rtol=1e-6)
    assert hist[0]["micro_steps"] == 2 and hist[0]["applies"] == 1 and hist[0]["loss_finite"]
    assert all(torch.equal(seen["val_params"][k], state.ema_params[k])
               for k in state.ema_params)
    assert hist[0]["seen"] == 1
    _, meta = CK.load_checkpoint(tmp_path / "run" / "weights" / "last.pt")
    assert meta["anchors"] is None


def _root_train_parse(argv, monkeypatch):
    spec = importlib.util.spec_from_file_location("root_train", REPO / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    return vars(mod.parse_opt())


@pytest.mark.parametrize("argv", [[], ["--epochs", "3", "--batch-size", "4", "--bf16",
                                       "--single-cls", "--cache", "ram", "--nbs", "32",
                                       "--linear-lr", "--noautoanchor", "--resume",
                                       "w.pt", "--multi-scale", "--image-weights"],
                                  ["--device-augment", "--steps-per-call", "4", "--remat",
                                   "--remat-neuron", "--sr", "0.01", "--optimizer", "Lion",
                                   "--quad"]],
                         ids=["defaults", "flags", "options"])
def test_cli_flags_match_root_train_py(argv, monkeypatch):
    want = _root_train_parse(argv, monkeypatch)
    got = vars(PCLI.parse_opt(argv))
    assert got.pop("local_rank") is None       # the port's torchrun flag
    assert set(got) == set(want)
    assert want.pop("device") == "" and got.pop("device") is None   # the card
    assert got == want


def test_cli_passes_single_cls_to_the_datasets(tmp_path, monkeypatch):
    data = tmp_path / "data.yaml"
    data.write_text(yaml.safe_dump(dict(path=str(tmp_path), train="tr", val="va", nc=5)))
    hyp = tmp_path / "hyp.yaml"
    hyp.write_text(yaml.safe_dump(dict(lr0=0.02, close_mosaic=3)))
    seen = {}
    monkeypatch.setattr(PDR, "train", lambda **kw: seen.update(kw))
    PCLI.main(PCLI.parse_opt(["--data", str(data), "--hyp", str(hyp), "--single-cls",
                              "--device", "cpu", "--device-augment", "--steps-per-call",
                              "3", "--remat-neuron", "--sr", "0.02", "--optimizer", "Lion"]))
    assert seen["single_cls"] and seen["nc"] == 1 and seen["device"] == "cpu"
    assert seen["device_augment"] and seen["steps_per_call"] == 3 and seen["sr"] == 0.02
    assert seen["remat_neuron"] and not seen["remat"] and seen["optimizer"] == "Lion"
    assert seen["hyp"] == {"lr0": 0.02} and seen["close_mosaic"] == 3
    assert seen["val_path"] == str(tmp_path / "va")


def test_train_builds_its_datasets_with_single_cls(monkeypatch, tmp_path):
    """The deviation from the JAX driver, which leaves ``single_cls`` off its
    datasets (``ecs_yolo_tpu/train/driver.py:163-173``)."""
    seen = []

    class Stop(Exception):
        pass

    def dataset(path, **kw):
        seen.append(kw)
        if len(seen) == 2:
            raise Stop
        return object()

    monkeypatch.setattr(PDR, "Dataset", dataset)
    with pytest.raises(Stop):
        PDR.train(_narrow("resnet10.yaml"), "tr", "va", nc=1, single_cls=True,
                  device="cpu", save_dir=str(tmp_path / "r"))
    assert [kw["single_cls"] for kw in seen] == [True, True]
    assert seen[0]["augment"] and not seen[1]["augment"]


def _head(name):
    d = _narrow("resnet10.yaml")
    d["head"][-1] = d["head"][-1][:2] + [name] + d["head"][-1][3:]
    return d


# model_parallel > 1 in one process: more model ranks than the world holds,
# refused with the JAX driver's message before anything is written (the
# layouts a group allows: test_torch_port_parallel.py)
UNPORTED = [("events", dict(events=True, model_parallel=2), "model_parallel=2 needs at least 2"),
            ("model_parallel", dict(model_parallel=2), "model_parallel=2 needs at least 2"),
            ("segment_head", dict(cfg=_head("Segment"), model_parallel=2),
             "model_parallel=2 needs at least 2"),
            ("panoptic_head", dict(cfg=_head("Panoptic"), model_parallel=4),
             "model_parallel=4 needs at least 4")]


@pytest.mark.parametrize("kw,item", [u[1:] for u in UNPORTED],
                         ids=[u[0] for u in UNPORTED])
def test_unported_features_raise_naming_their_item(kw, item, tmp_path):
    with pytest.raises(ValueError, match=item):
        PDR.train(**{"cfg": _narrow("resnet10.yaml"), **kw}, train_path=tmp_path,
                  device="cpu", save_dir=str(tmp_path / "r"))
    assert not (tmp_path / "r").exists()


REFUSED = [("flipud", dict(device_augment=True, hyp=dict(flipud=0.5)), "flipud"),
           ("mixup", dict(device_augment=True, hyp=dict(mixup=0.1)), "mixup"),
           ("copy_paste", dict(device_augment=True, hyp=dict(copy_paste=0.3)), "copy_paste"),
           ("steps_per_call_0", dict(steps_per_call=0), "steps_per_call"),
           ("quad_batch_6", dict(quad=True, batch_size=6), "quad")]


@pytest.mark.parametrize("kw,what", [u[1:] for u in REFUSED], ids=[u[0] for u in REFUSED])
def test_refused_options_raise_before_anything_is_written(kw, what, tmp_path):
    """The hyps the device pipeline lacks (the JAX module drops them without
    a word), a step count under 1, a quad batch not divisible by 4."""
    with pytest.raises(ValueError, match=what):
        PDR.train(_narrow("resnet10.yaml"), tmp_path, device="cpu",
                  save_dir=str(tmp_path / "r"), **kw)
    assert not (tmp_path / "r").exists()


def _state(st):
    o = st.opt_state.tensors()
    return dict(params=st.params, stats=st.batch_stats, ema=st.ema_params, mu=o["mu"],
                acc=o["acc"], scalars=dict(step=st.step, count=o["count"],
                                           errors=o["errors"]))


@pytest.fixture(scope="module")
def k2_run(tmp_path_factory):
    """``train()`` with ``device_augment`` and ``steps_per_call=2`` over 3
    micro-batches of a narrowed res10 at 32 px, batch 1, on one thread (the
    CPU convolutions' weight gradients are not bit-reproducible across
    thread schedules): its state, history, each ``dispatch`` call's host
    batches, the initial state and the arguments of the step's pieces."""
    tmp = tmp_path_factory.mktemp("k2")
    tr = write_split(tmp / "tr", sizes=[(48, 80), (64, 64), (100, 37)], nc=3)
    seen = {"dispatch": [], "built": []}
    real = {k: getattr(PDR, k) for k in ("dispatch", "Dataset", "build_model",
                                          "build_optimizer", "make_train_step")}

    def dispatch(state, fn, batches, *a, **k):
        seen["dispatch"].append([tuple(np.copy(x) for x in b) for b in batches])
        return real["dispatch"](state, fn, batches, *a, **k)

    def keep(name):
        def wrapped(*a, **k):
            seen[name] = (a, k)
            out = real[name](*a, **k)
            if name == "build_model":
                seen["model"] = out
            return out
        return wrapped

    patch = pytest.MonkeyPatch()
    patch.setattr(PDR, "dispatch", dispatch)
    patch.setattr(PDR, "Dataset", lambda *a, **k: seen["built"].append(k["augment"])
                  or real["Dataset"](*a, **k))
    for name in ("build_model", "build_optimizer", "make_train_step"):
        patch.setattr(PDR, name, keep(name))
    cb = PG.Callbacks()
    cb.register_action("on_train_start", callback=lambda st: seen.update(start={
        k: v.detach().clone() for k, v in seen["model"].state_dict().items()}))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state, _, hist = PDR.train(
            _narrow("resnet10.yaml"), tr, None, nc=3, batch_size=1, imgsz=32, nbs=2,
            epochs=1, workers=0, autoanchor=False, device_augment=True, steps_per_call=2,
            snn=SNNConfig(time_window=T), loggers_include=("csv",), device="cpu",
            save_dir=str(tmp / "k2"), callbacks=cb)
    finally:
        torch.set_num_threads(threads)
        patch.undo()
    seen.update(real=real, hist=hist, state={
        n: {k: v.clone() for k, v in part.items()} for n, part in _state(state).items()})
    return seen


def test_steps_per_call_dispatches_chunks_then_the_tail(k2_run):
    """Three micro-batches at ``steps_per_call=2``: one dispatch of 2, then
    the tail of 1; the train set built without host augmentation; every
    batch's augmentation drawn from its own seed."""
    assert [len(c) for c in k2_run["dispatch"]] == [2, 1]
    assert k2_run["built"] == [False] and k2_run["hist"][0]["micro_steps"] == 3
    assert int(k2_run["state"]["scalars"]["step"]) == 3 and k2_run["hist"][0]["loss_finite"]
    assert len({PDR._augment_seed(0, e, n) for e in (0, 1) for n in range(3)}) == 6


def test_steps_per_call_leaves_the_state_of_single_steps(k2_run):
    """The state ``train()`` left at ``steps_per_call=2`` against the same
    batches dispatched one at a time from the same initial state, as
    ``steps_per_call=1`` dispatches them (``driver.dispatch``, each batch
    augmented from its own draws): parameters, BN statistics, EMA,
    optimizer state and step count bit-equal (one thread)."""
    seen, real = k2_run, k2_run["real"]
    model = seen["model"]
    model.load_state_dict(seen["start"])
    tx = real["build_optimizer"](*seen["build_optimizer"][0], **seen["build_optimizer"][1])
    one = PT.create_train_state(model, tx, device="cpu")
    step = real["make_train_step"](model, tx, *seen["make_train_step"][0][2:],
                                   **seen["make_train_step"][1])
    gen = torch.Generator()
    hyp = dict(HYP_SCRATCH)

    def augment(n, im, tg, mk):
        gen.manual_seed(PDR._augment_seed(0, 0, n))
        return PDR.augment_batch(im.to(torch.float32) / 255.0, tg, mk, gen, hyp)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for n, batch in enumerate(b for c in seen["dispatch"] for b in c):
            one, _ = real["dispatch"](one, step, [batch], torch.device("cpu"), augment,
                                      first=n)
    finally:
        torch.set_num_threads(threads)
    got, want = seen["state"], _state(one)
    for part in want:
        assert set(got[part]) == set(want[part])
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (part, k)
    assert any(not torch.equal(seen["start"][k], v) for k, v in want["params"].items())


def test_options_reach_the_model_step_optimizer_and_dataset(tmp_path, monkeypatch):
    """``remat``, ``remat_neuron``, ``sr``, Lion and ``quad`` through
    ``train()``: one quad batch of 4 (one 64 px canvas) takes a step."""
    tr = write_split(tmp_path / "tr", sizes=[(48, 80), (64, 64), (100, 37), (30, 45)],
                     nc=3)
    seen = {}

    def spy(name, fn):
        def wrapped(*a, **k):
            seen[name] = k
            return fn(*a, **k)
        monkeypatch.setattr(PDR, name, wrapped)

    for name in ("build_model", "build_optimizer", "make_train_step"):
        spy(name, getattr(PDR, name))
    shapes = []
    real_dispatch = PDR.dispatch
    monkeypatch.setattr(PDR, "dispatch", lambda st, fn, batches, *a, **k: shapes.append(
        batches[0][0].shape) or real_dispatch(st, fn, batches, *a, **k))
    state, _, hist = PDR.train(
        _narrow("resnet10.yaml"), tr, None, nc=3, batch_size=4, imgsz=32, nbs=4,
        epochs=1, workers=0, autoanchor=False, remat=True, remat_neuron=True, sr=0.01,
        optimizer="Lion", quad=True, snn=SNNConfig(time_window=T),
        loggers_include=("csv",), device="cpu", save_dir=str(tmp_path / "r"))
    assert seen["build_model"]["remat"] and seen["build_model"]["snn"].remat_neuron
    assert seen["build_optimizer"]["name"] == "Lion"
    assert seen["make_train_step"]["sr"] == 0.01
    assert seen["make_train_step"]["sr_total_steps"] == 1 * 1
    assert shapes == [(1, 64, 64, 3)] and int(state.step) == 1
    assert state.opt_state.nu is None and all(h["loss_finite"] for h in hist)


def test_training_needs_a_card_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PDR.train(_narrow("resnet10.yaml"), tmp_path, save_dir=str(tmp_path / "r"))
    # the GA's generations train too
    data = tmp_path / "data.yaml"
    data.write_text(f"path: {tmp_path}\ntrain: images\nnc: 2\n")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PCLI.main(PCLI.parse_opt(["--evolve", "3", "--data", str(data), "--hyp", ""]))
