"""The port's v1 training step (``ecs_yolo_tpu_torch/train/``) against the
JAX package's (``ecs_yolo_tpu/train/``), on the CPU, same numpy inputs and
identical weights (carried across by ``models/convert.py``).

Losses, schedules and the whole step run in float64 on both sides (JAX
inside ``jax.enable_x64()``), so no spike flips and the two agree to
reassociation: rtol 1e-9 for the loss functions, rtol 1e-8 for the step's
loss, atol 1e-8 for parameters, EMA and BN statistics after 3 steps.  The
schedules themselves are float32 on both sides and must agree to float32
rounding (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu.models import yolo as jax_yolo
from ecs_yolo_tpu.ops import boxes as JBX
from ecs_yolo_tpu.train import ema as JE
from ecs_yolo_tpu.train import loss_v1 as JL
from ecs_yolo_tpu.train import optim as JO
from ecs_yolo_tpu.train import trainer as JT
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.data.hyps import HYP_SCRATCH, HYP_SCRATCH_HIGH
from ecs_yolo_tpu_torch.models import convert as CV
from ecs_yolo_tpu_torch.models import yolo as port_yolo
from ecs_yolo_tpu_torch.ops import boxes as PBX
from ecs_yolo_tpu_torch.train import ema as PE
from ecs_yolo_tpu_torch.train import loss_v1 as PL
from ecs_yolo_tpu_torch.train import optim as PO
from ecs_yolo_tpu_torch.train import trainer as PT
from test_torch_port_model import _narrow, _random_variables

torch.set_num_threads(2)

T = 2


def _t64(a, grad=False):
    return torch.from_numpy(np.array(a, np.float64)).requires_grad_(grad)


# --- (e) boxes and the loss -------------------------------------------------

IOU_MODES = [{}, {"GIoU": True}, {"DIoU": True}, {"CIoU": True},
             {"CIoU": True, "ciou_pow": True}, {"SIoU": True}, {"EIoU": True},
             {"SIoU": True, "alpha": 3.0}, {"GIoU": True, "alpha": 3.0},
             {"EIoU": True, "Focal": True}, {"CIoU": True, "xywh": False}]


@pytest.mark.parametrize("mode", IOU_MODES,
                         ids=["-".join(f"{k}{v}" for k, v in m.items()) or "IoU"
                              for m in IOU_MODES])
def test_bbox_iou_matches_jax_f64(mode):
    rng = np.random.RandomState(1)
    b1 = np.concatenate([rng.rand(40, 2) * 8, rng.rand(40, 2) * 4 + 0.5], -1)
    b2 = np.concatenate([b1[:, :2] + rng.randn(40, 2), rng.rand(40, 2) * 4 + 0.5], -1)
    if not mode.get("xywh", True):
        b1, b2 = (np.concatenate([b[:, :2] - b[:, 2:] / 2, b[:, :2] + b[:, 2:] / 2],
                                 -1) for b in (b1, b2))
    first = (lambda r: r[0]) if mode.get("Focal") else (lambda r: r)
    with jax.enable_x64():
        f = lambda a: JBX.bbox_iou(a, jnp.asarray(b2), **mode)
        want, want_g = jax.jit(lambda a: (f(a), jax.grad(
            lambda a_: jnp.sum(first(f(a_))))(a)))(jnp.asarray(b1))
    t1 = _t64(b1, grad=True)
    got = PBX.bbox_iou(t1, _t64(b2), **mode)
    (got_g,) = torch.autograd.grad(first(got).sum(), t1)
    for a, b in zip(got if mode.get("Focal") else [got],
                    want if mode.get("Focal") else [want]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-12)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-8,
                               atol=1e-10)


def test_box_iou_and_xyxy2xywh_match_jax():
    rng = np.random.RandomState(2)
    a = np.sort(rng.rand(7, 4).astype(np.float32) * 50, -1)[:, [0, 1, 2, 3]]
    b = np.sort(rng.rand(5, 4).astype(np.float32) * 50, -1)
    np.testing.assert_allclose(
        PBX.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(JBX.box_iou(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    x = rng.rand(6, 6).astype(np.float32)
    np.testing.assert_allclose(PBX.xyxy2xywh(torch.from_numpy(x)).numpy(),
                               np.asarray(JBX.xyxy2xywh(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(
        PBX.xywh2xyxy(PBX.xyxy2xywh(torch.from_numpy(x))).numpy(), x, atol=1e-6)


def _targets(b, m, nc, seed, n_valid=3):
    rng = np.random.RandomState(seed)
    t = np.zeros((b, m, 5), np.float32)
    mask = np.zeros((b, m), bool)
    for i in range(b):
        k = n_valid if i % 2 == 0 else max(1, n_valid - 1)
        t[i, :k, 0] = rng.randint(0, nc, k)
        t[i, :k, 1:3] = rng.rand(k, 2) * 0.8 + 0.1
        t[i, :k, 3:5] = rng.rand(k, 2) * 0.4 + 0.05
        mask[i, :k] = True
    return t, mask


ANCHORS = np.array([[[1.25, 1.625], [2.0, 3.75], [4.125, 2.875]],
                    [[1.875, 3.8125], [3.875, 2.8125], [3.6875, 7.4375]],
                    [[3.625, 2.8125], [4.875, 6.1875], [11.65625, 10.1875]]],
                   np.float32)


def test_build_targets_level_matches_jax():
    t, mask = _targets(3, 6, 4, seed=3, n_valid=5)
    for lvl, hw in enumerate([(8, 8), (4, 6)]):
        want = jax.jit(lambda t_, m_, a_: JL.build_targets_level(
            t_, m_, a_, hw, 4.0))(jnp.asarray(t), jnp.asarray(mask),
                                  jnp.asarray(ANCHORS[lvl]))
        got = PL.build_targets_level(torch.from_numpy(t), torch.from_numpy(mask),
                                     torch.from_numpy(ANCHORS[lvl]), hw, 4.0)
        assert np.asarray(want[-1]).sum() > 0
        for a, b in zip(got, want):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("fl_gamma,smooth,slide", [(0.0, 0.0, 0.0), (1.5, 0.1, 0.0),
                                                   (0.0, 0.1, 0.5)],
                         ids=["plain", "focal-smooth", "slide-smooth"])
def test_compute_loss_v1_value_items_and_grad_match_jax_f64(fl_gamma, smooth, slide):
    nc, B = 4, 3
    rng = np.random.RandomState(4)
    preds = [rng.randn(B, 3, h, w, nc + 5) for h, w in ((8, 8), (4, 4), (2, 2))]
    t, mask = _targets(B, 6, nc, seed=5, n_valid=5)
    hyp = dict(HYP_SCRATCH, fl_gamma=fl_gamma, label_smoothing=smooth,
               slide_ratio=slide, cls_pw=0.9, obj_pw=1.1)
    with jax.enable_x64():
        jargs = (jnp.asarray(t, jnp.float64), jnp.asarray(mask),
                 jnp.asarray(ANCHORS, jnp.float64), hyp, nc)
        (want, want_items), want_g = jax.jit(jax.value_and_grad(
            lambda p: JL.compute_loss_v1(p, *jargs), has_aux=True))(
                [jnp.asarray(p) for p in preds])
    tp = [_t64(p, grad=True) for p in preds]
    got, items = PL.compute_loss_v1(tp, _t64(t), torch.from_numpy(mask),
                                    _t64(ANCHORS), hyp, nc)
    got_g = torch.autograd.grad(got, tp)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-9)
    np.testing.assert_allclose(items.numpy(), np.asarray(want_items), rtol=1e-9)
    assert not items.requires_grad
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8, atol=1e-12)


def test_loss_helpers_match_jax():
    rng = np.random.RandomState(6)
    p, t = rng.randn(50).astype(np.float32), rng.rand(50).astype(np.float32)
    for name, args in (("bce_logits", (1.3,)), ("focal_weight", (1.5, 0.25)),
                       ("qfocal_weight", (1.5, 0.25))):
        np.testing.assert_allclose(
            getattr(PL, name)(torch.from_numpy(p), torch.from_numpy(t), *args).numpy(),
            np.asarray(getattr(JL, name)(jnp.asarray(p), jnp.asarray(t), *args)),
            rtol=2e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(
        PL.slide_weight(torch.from_numpy(t), torch.tensor(0.45)).numpy(),
        np.asarray(JL.slide_weight(jnp.asarray(t), jnp.asarray(0.45))), rtol=1e-6)
    assert PL.smooth_bce(0.1) == JL.smooth_bce(0.1)
    assert HYP_SCRATCH["lrf"] == 0.1 and HYP_SCRATCH_HIGH["box"] == 7.5


# --- (f) schedules, groups, optimizer, EMA ----------------------------------


@pytest.mark.parametrize("cos_lr", [True, False], ids=["cos", "linear"])
@pytest.mark.parametrize("spe,floor", [(500, 1000.0), (40, 100.0)])
def test_lr_and_momentum_schedules_match_jax(spe, floor, cos_lr):
    kw = dict(lr0=0.01, lrf=0.1, epochs=30, steps_per_epoch=spe, cos_lr=cos_lr,
              warmup_epochs=3.0, warmup_bias_lr=0.1, min_warmup_steps=floor)
    nw = int(max(3.0 * spe, floor))
    steps = [0, 1, nw - 1, nw, nw + spe, 7 * spe + 3]
    for is_bias in (False, True):       # g0/g1 share a schedule, g2 is the bias one
        jf = JO.make_lr_fn(is_bias=is_bias, **kw)
        pf = PO.make_lr_fn(is_bias=is_bias, **kw)
        for s in steps:
            got = pf(torch.tensor(s))
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(float(got), float(jf(s)), rtol=1e-6,
                                       err_msg=f"step {s} bias {is_bias}")
    assert float(PO.make_lr_fn(is_bias=False, **kw)(0)) == 0.0
    assert float(PO.make_lr_fn(is_bias=True, **kw)(0)) == pytest.approx(0.1)
    mom = PO.make_momentum_fn(0.937, 0.8, float(nw))
    for s in steps:
        want = np.float32(0.8) + np.clip(np.float32(s) / np.float32(nw), 0, 1) \
            * np.float32(0.937 - 0.8)
        np.testing.assert_allclose(float(mom(s)), want, rtol=1e-6)
    np.testing.assert_allclose(PO.one_cycle(1, 0.1, 30)(7), JO.one_cycle(1, 0.1, 30)(7))
    np.testing.assert_allclose(PO.linear_lf(0.1, 30)(7), JO.linear_lf(0.1, 30)(7))


@pytest.mark.parametrize("name", ["SGD", "Adam", "AdamW"])
def test_optimizer_updates_match_optax_f64(name):
    """Five steps on a toy tree with one parameter in each group, the third
    step's gradient not finite (skipped on both sides): float64, to 1e-11
    (the float32 schedules are bit-equal, the rest reassociates)."""
    rng = np.random.RandomState(7)
    shapes = {"conv/kernel": (3, 3, 2, 4), "conv/bias": (4,), "bn/scale": (4,)}
    names = {"conv/kernel": "m.0.weight", "conv/bias": "m.0.bias",
             "bn/scale": "m.1.bn.weight"}
    p0 = {k: rng.randn(*s) for k, s in shapes.items()}
    gs = [{k: rng.randn(*s) for k, s in shapes.items()} for _ in range(5)]
    gs[2]["conv/bias"][1] = np.nan
    kw = dict(name=name, lr0=0.02, lrf=0.1, momentum=0.9, weight_decay=0.01,
              epochs=3, steps_per_epoch=2, warmup_epochs=1.0, warmup_floor=3.0)
    tree = lambda d: {"conv": {"kernel": d["conv/kernel"], "bias": d["conv/bias"]},
                      "bn": {"scale": d["bn/scale"]}}
    with jax.enable_x64():
        jp = jax.tree_util.tree_map(jnp.asarray, tree(p0))
        tx = JO.build_optimizer(jp, **kw)
        st = tx.init(jp)
        for g in gs:
            up, st = tx.update(jax.tree_util.tree_map(jnp.asarray, tree(g)), st, jp)
            jp = optax.apply_updates(jp, up)
        want = {"conv/kernel": jp["conv"]["kernel"], "conv/bias": jp["conv"]["bias"],
                "bn/scale": jp["bn"]["scale"]}
        want = {k: np.asarray(v) for k, v in want.items()}
    pp = {names[k]: _t64(v) for k, v in p0.items()}
    ptx = PO.build_optimizer(pp, **kw)
    assert ptx.labels == {"m.0.weight": "g1", "m.0.bias": "g2", "m.1.bn.weight": "g0"}
    pst = ptx.init(pp)
    applied = [bool(ptx.apply(pp, {names[k]: _t64(v) for k, v in g.items()}, pst))
               for g in gs]
    assert applied == [True, True, False, True, True] and int(pst.count) == 4
    tol = 1e-11
    for k, v in want.items():
        assert np.abs(v - p0[k]).max() > 1e-4
        np.testing.assert_allclose(pp[names[k]].numpy(), v, atol=tol, rtol=tol,
                                   err_msg=k)


def test_unported_optimizer_options_raise():
    """Lion is ported (held against optax in test_torch_port_train_opts.py);
    an optimizer neither package has raises."""
    p = {"m.0.weight": torch.zeros(2, 2)}
    assert PO.build_optimizer(p, name="Lion").name == "lion"
    with pytest.raises(KeyError):
        PO.build_optimizer(p, name="rmsprop")


def test_ema_update_matches_jax():
    rng = np.random.RandomState(8)
    e, p = rng.randn(5, 3), rng.randn(5, 3)
    for step in (1, 50, 4000):
        with jax.enable_x64():
            want = JE.ema_update({"a": jnp.asarray(e)}, {"a": jnp.asarray(p)},
                                 jnp.asarray(step, jnp.int32))["a"]
        got = {"a": _t64(e)}
        PE.ema_update(got, {"a": _t64(p)}, torch.tensor(step))
        np.testing.assert_allclose(got["a"].numpy(), np.asarray(want), atol=1e-12)
        np.testing.assert_allclose(float(PE.ema_decay(step)),
                                   float(JE.ema_decay(step)), rtol=1e-6)


# --- (g) the slice as a whole -----------------------------------------------

HYP = dict(HYP_SCRATCH)
OPT = dict(name="SGD", lr0=HYP["lr0"], lrf=HYP["lrf"], momentum=HYP["momentum"],
           weight_decay=HYP["weight_decay"], epochs=2, steps_per_epoch=6,
           warmup_epochs=HYP["warmup_epochs"],
           warmup_momentum=HYP["warmup_momentum"],
           warmup_bias_lr=HYP["warmup_bias_lr"])


def _batch():
    rng = np.random.RandomState(12)
    ims = rng.rand(2, 64, 64, 3).astype(np.float32)
    t, mask = _targets(2, 4, 2, seed=13, n_valid=3)
    return ims, t, mask


@pytest.fixture(scope="module")
def pair():
    """(jax model, numpy variables, port model with the same weights) of the
    narrowed res10 at T=2.  The JAX model runs the canonical layout
    (``packed_c64=False``), the layout the port runs: with the width-packed
    C=64 stage its float64 gradients carry a relative error near 1e-6 against
    its own canonical graph, which would hide what this file checks."""
    d = _narrow("resnet10.yaml")
    jm = jax_yolo.build_model(d, nc=2, snn=JaxSNNConfig(time_window=T,
                                                        packed_c64=False))
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    v = _random_variables(
        lambda: jm.module.init(jax.random.PRNGKey(0), x, training=False), 21)
    pm = port_yolo.build_model(d, nc=2, snn=SNNConfig(time_window=T),
                               device="cpu").double()
    pm.load_state_dict({k: t.double() for k, t in CV.convert(
        v["params"], v["batch_stats"], pm.spec).items()}, strict=True)
    return jm, v, pm


def test_every_res10_parameter_lands_in_its_jax_group(pair):
    jm, v, pm = pair
    labels = jax.tree_util.tree_map_with_path(JO.param_group_label, v["params"])
    want = CV.convert_labels(labels, pm.spec)
    got = PO.build_optimizer(dict(pm.named_parameters())).labels
    assert got == want
    assert {g: sum(x == g for x in got.values()) for g in PO.GROUPS} == {
        g: sum(x == g for x in want.values()) for g in PO.GROUPS}
    assert set(got.values()) == set(PO.GROUPS)


def test_train_step_matches_jax_f64(pair):
    """Step-1 loss and items to rtol 1e-8; parameters, EMA and BN running
    statistics after 3 SGD steps (warm-up, Nesterov, weight decay) to atol
    1e-8; every parameter group, the EMA and the BN statistics moved."""
    jm, v, pm = pair
    ims, t, mask = _batch()
    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        tx = JO.build_optimizer(v64["params"], **OPT)
        jstate = jax.jit(lambda v_: JT.create_train_state(v_, tx))(v64)
        jstep = JT.make_train_step(jm, tx, HYP)
        jmetrics = []
        for _ in range(3):
            jstate, m = jstep(jstate, jnp.asarray(ims), jnp.asarray(t),
                              jnp.asarray(mask))
            jmetrics.append((float(m["loss"]), np.asarray(m["items"])))
        want_p = CV.convert(jstate.params, jstate.batch_stats, pm.spec)
        want_e = CV.convert(jstate.ema_params, None, pm.spec)

    before = {k: p.detach().clone() for k, p in pm.state_dict().items()}
    ptx = PO.build_optimizer(dict(pm.named_parameters()), **OPT)
    state = PT.create_train_state(pm, ptx, device="cpu")
    step = PT.make_train_step(pm, ptx, HYP, device="cpu")
    batch = (torch.from_numpy(ims), torch.from_numpy(t), torch.from_numpy(mask))
    for i in range(3):
        state, m = step(state, *batch)
        assert bool(m["applied"]) and m["loss"].dtype == torch.float32
        if i == 0:
            np.testing.assert_allclose(float(m["loss"]), jmetrics[0][0], rtol=1e-8)
            np.testing.assert_allclose(m["items"].numpy(), jmetrics[0][1], rtol=1e-8)
    np.testing.assert_allclose(m["items"].numpy(), jmetrics[2][1], rtol=1e-7)
    assert int(state.step) == 3 and int(state.opt_state.count) == 3

    sd = pm.state_dict()
    assert set(sd) == set(want_p)
    for k, w in want_p.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-8, err_msg=k)
    for k, w in want_e.items():
        np.testing.assert_allclose(state.ema_params[k].numpy(), w.numpy(),
                                   atol=1e-8, err_msg=f"ema {k}")
    moved = lambda k, now: float((now - before[k]).abs().max()) > 0
    for g in PO.GROUPS:
        assert any(moved(k, sd[k]) for k, lab in ptx.labels.items() if lab == g), g
    assert any(moved(k, e) for k, e in state.ema_params.items())
    assert all(moved(k, sd[k]) for k in state.batch_stats)
    # restore the shared model for the tests after this one
    pm.load_state_dict(before)


@pytest.fixture(scope="module")
def port_model():
    """The narrowed res10 of the port alone, float64, its own seeded init
    (cheap: no JAX model behind it)."""
    return port_yolo.build_model(
        _narrow("resnet10.yaml"), nc=2, snn=SNNConfig(time_window=T),
        device="cpu", generator=torch.Generator().manual_seed(3)).double()


def test_event_batch_and_uint8_take_a_step(port_model):
    """A 5-D event batch [B,T,H,W,C] bypasses the static-image stem
    de-duplication: made of T copies of a static batch it gives the static
    batch's loss (float64: atol 1e-9).  uint8 images are scaled on the way
    in."""
    pm = port_model
    before = {k: p.detach().clone() for k, p in pm.state_dict().items()}
    ims, t, mask = _batch()
    u8 = (ims * 255).astype(np.uint8)
    tx = PO.build_optimizer(dict(pm.named_parameters()), **OPT)
    grad_fn = PT.make_grad_fn(pm, HYP)
    tb = (torch.from_numpy(t), torch.from_numpy(mask))
    losses = {}
    for name, x in (("static", torch.from_numpy(u8.astype(np.float32) / 255.0)),
                    ("uint8", torch.from_numpy(u8)),
                    ("event", torch.from_numpy(
                        np.repeat((u8.astype(np.float32) / 255.0)[:, None], T, 1)))):
        state = PT.create_train_state(pm, tx, device="cpu")
        total, items, grads = grad_fn(state, x, *tb)
        assert all(torch.isfinite(g).all() for g in grads.values())
        losses[name] = items.numpy()
        pm.load_state_dict(before)
    np.testing.assert_allclose(losses["event"], losses["static"], atol=1e-9)
    np.testing.assert_allclose(losses["uint8"], losses["static"], atol=1e-6)
    state = PT.create_train_state(pm, tx, device="cpu")
    step = PT.make_train_step(pm, tx, HYP, device="cpu",
                              compute_dtype=torch.bfloat16)
    state, m = step(state, torch.from_numpy(np.repeat(ims[:, None], T, 1)), *tb)
    assert torch.isfinite(m["loss"]) and int(state.step) == 1
    assert all(p.dtype == torch.float64 for p in state.params.values())
    pm.load_state_dict(before)


# --- (h) what raises -----------------------------------------------------------


def test_training_needs_a_card_unless_cpu_is_asked(port_model, monkeypatch):
    pm = port_model
    tx = PO.build_optimizer(dict(pm.named_parameters()), **OPT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PT.create_train_state(pm, tx)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PT.make_train_step(pm, tx, HYP)
    # masks and id maps ride only with a segment head (test_torch_port_segment)
    for kw in ({"with_masks": True}, {"with_semantic": True}):
        with pytest.raises(ValueError, match="with_"):
            PT.make_train_step(pm, tx, HYP, device="cpu", **kw)
    pm.head_info["name"] = "RTDETRDecoder"    # a head whose loss is not ported
    try:
        with pytest.raises(KeyError, match="RTDETRDecoder"):
            PT.make_loss_fn(pm, HYP)
    finally:
        pm.head_info["name"] = "Detect"
