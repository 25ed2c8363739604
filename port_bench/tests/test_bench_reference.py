"""The plain reference against the program at a tiny size on the CPU (the
program takes its plain routes there, as under ``plain_kernels()``), and
the reference's imports."""

import ast
import json

import pytest
import torch

from port_bench.core import guard, scenes, weights
from port_bench.reference import loss as ref_loss
from port_bench.reference import optim as ref_optim
from port_bench.reference.model import TBN, MemUpdate
from port_bench.tests.conftest import ROOT

SIZE = 64


@pytest.fixture(scope="module")
def cfg():
    return json.loads((ROOT / "port_bench/configs/ems-res10-ecs.json").read_text())


def _models(cfg, seed=3):
    sd = weights.make(cfg, seed, "cpu")
    prog = weights.program(cfg, SIZE, "cpu", sd)
    ref = weights.reference(cfg, "cpu")
    ref.load_state_dict(sd)
    return prog, ref


def _calibrate(model, bn_cls, x):
    for m in model.modules():
        if isinstance(m, bn_cls):
            m.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(x)
    model.eval()


def test_reference_imports_nothing_of_the_program_or_jax():
    for path in (ROOT / "port_bench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names.add(node.module)
        tops = {n.split(".")[0] for n in names}
        assert not guard.forbidden_loaded(tops), path
        assert "ecs_yolo_tpu_torch" not in tops, path


@pytest.mark.parametrize("names,found", [
    (["ecs_yolo_tpu_torch", "ecs_yolo_tpu_torch.nn"], []),
    (["ecs_yolo_tpu.nn", "torch"], ["ecs_yolo_tpu"]),
    (["jaxlib.xla_client", "flax", "optax", "orbax.checkpoint", "jax"],
     ["flax", "jax", "jaxlib", "optax", "orbax"])])
def test_import_check_compares_whole_top_level_names(names, found):
    assert guard.forbidden_loaded(names) == found


@pytest.mark.parametrize("kind", ["LIF", None])
def test_a_neuron_the_reference_does_not_implement_is_refused(cfg, kind):
    nrn = {k: v for k, v in cfg["neuron"].items() if k != "kind"}
    if kind:
        nrn["kind"] = kind
    with pytest.raises(ValueError, match="ECS-LIF"):
        weights.make({**cfg, "neuron": nrn}, 1, "cpu")


def test_same_names_and_shapes(cfg):
    prog, ref = _models(cfg)
    assert {k: v.shape for k, v in prog.state_dict().items()} == \
        {k: v.shape for k, v in ref.state_dict().items()}


@pytest.mark.parametrize("thresh", [0.5, 0.35])    # the configuration's, and another
def test_serving_forward_against_the_program(cfg, thresh):
    """Both sides build to the configuration's neuron."""
    from ecs_yolo_tpu_torch.models.yolo import head_predictions
    from ecs_yolo_tpu_torch.nn.blocks import _BN
    from ecs_yolo_tpu_torch.snn.route import plain_kernels

    prog, ref = _models({**cfg, "neuron": {**cfg["neuron"], "thresh": thresh}})
    frames = scenes.make_frames(2, 5, "cpu", (72, 128), SIZE)
    x = frames.float() / 255.0
    with plain_kernels():
        _calibrate(prog, _BN, x)
        with torch.no_grad():
            got = head_predictions("Detect", prog(x), cfg["nc"])
    _calibrate(ref, TBN, x.permute(0, 3, 1, 2))
    with torch.no_grad():
        want = ref(x.permute(0, 3, 1, 2))
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_training_gradients_against_the_program(cfg):
    from ecs_yolo_tpu_torch.data.hyps import HYP_SCRATCH
    from ecs_yolo_tpu_torch.train.optim import build_optimizer
    from ecs_yolo_tpu_torch.train.trainer import create_train_state, make_grad_fn
    from port_bench.traffic import train as T

    prog, ref = _models(cfg)
    imgs, targets, mask = T.make_batches(1, 2, SIZE, cfg["nc"], 4, 9, "cpu")[0]
    tx = build_optimizer(dict(prog.named_parameters()))
    state = create_train_state(prog, tx, device="cpu")
    loss_p, _, g_p = make_grad_fn(prog, HYP_SCRATCH)(state, imgs, targets, mask)
    ref.train()
    head = ref.model[-1]
    total, _ = ref_loss.v1_loss(ref(imgs.permute(0, 3, 1, 2).float() / 255.0), targets, mask,
                                head.anchors_px, head.strides, HYP_SCRATCH, cfg["nc"])
    names = [k for k, _ in ref.named_parameters()]
    g_r = dict(zip(names, torch.autograd.grad(total, [p for _, p in ref.named_parameters()],
                                              allow_unused=True, materialize_grads=True)))
    assert float(total.detach()) == pytest.approx(float(loss_p), rel=1e-5)
    # float32 in both, summed in other orders: leaf norms of the difference
    # stay at rounding's size (a surrogate window may open at one element
    # in one run and not the other)
    gaps = {k: float((g_p[k] - g_r[k]).norm() / g_r[k].norm().clamp(min=1e-12)) for k in names}
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] < 1e-2, (worst, gaps[worst])
    assert sorted(gaps.values())[len(gaps) // 2] < 1e-4


def test_loss_against_the_program():
    from ecs_yolo_tpu_torch.data.hyps import HYP_SCRATCH
    from ecs_yolo_tpu_torch.train.loss_v1 import compute_loss_v1

    g = torch.Generator().manual_seed(0)
    maps = [torch.randn(3, 3, 8, 8, 18, generator=g, dtype=torch.float64),
            torch.randn(3, 3, 4, 4, 18, generator=g, dtype=torch.float64)]
    wh = 0.05 + 0.4 * torch.rand(3, 6, 2, generator=g, dtype=torch.float64)
    xy = wh / 2 + torch.rand(3, 6, 2, generator=g, dtype=torch.float64) * (1 - wh)
    cls = torch.randint(0, 13, (3, 6, 1), generator=g).double()
    targets = torch.cat([cls, xy, wh], -1)
    mask = torch.rand(3, 6, generator=g) < 0.7
    anchors_px = [[10, 14, 23, 27, 37, 58], [81, 82, 135, 169, 344, 319]]
    strides = [16.0, 32.0]
    anchors = torch.tensor(anchors_px, dtype=torch.float64).view(2, 3, 2) \
        / torch.tensor(strides, dtype=torch.float64).view(2, 1, 1)
    want, items_w = compute_loss_v1(maps, targets, mask, anchors, HYP_SCRATCH, 13)
    got, items_g = ref_loss.v1_loss(maps, targets, mask, anchors_px, strides, HYP_SCRATCH, 13)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(items_g, items_w, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("start", [0, 37, 10915])   # in, late in, and past the warm-up
def test_sgd_apply_against_the_program(start):
    """Two applies of two micro-steps each: the second starts from the
    momentum buffer of the first."""
    from ecs_yolo_tpu_torch.train.optim import build_optimizer

    g = torch.Generator().manual_seed(1)
    f64 = torch.float64         # the change is read as a difference of parameters
    params = {"m.conv.weight": torch.randn(4, 3, 3, 3, generator=g, dtype=f64),
              "m.bn.bn.weight": torch.rand(4, generator=g, dtype=f64),
              "m.conv.bias": torch.randn(4, generator=g, dtype=f64)}
    sched = {"epochs": 300, "steps_per_epoch": 2183, "accumulate": 2, "lr0": 0.01,
             "lrf": 0.1, "momentum": 0.937, "warmup_epochs": 3.0, "warmup_floor": 1000.0,
             "warmup_momentum": 0.8, "warmup_bias_lr": 0.1, "weight_decay": 5e-4}
    tx = build_optimizer(params, "SGD", lr0=0.01, lrf=0.1, momentum=0.937, weight_decay=5e-4,
                         epochs=300, steps_per_epoch=2183, accumulate=2)
    p = {k: v.clone() for k, v in params.items()}
    st = tx.init(p)
    st.count.fill_(start)
    buf = None
    for apply in range(2):
        before = {k: v.clone() for k, v in p.items()}
        g1 = {k: torch.randn(v.shape, generator=g, dtype=f64) for k, v in p.items()}
        g2 = {k: torch.randn(v.shape, generator=g, dtype=f64) for k, v in p.items()}
        tx.update(p, g1, st)
        tx.update(p, g2, st)
        change, buf = ref_optim.sgd_apply(before, {k: (g1[k] + g2[k]) / 2 for k in p}, buf,
                                          start + apply, sched)
        for k in p:
            # the program evaluates its schedule in float32, and the
            # buffer's and the gradient's terms may cancel in an element:
            # rounding at float32's size of the leaf's largest change
            scale = float(change[k].abs().max())
            torch.testing.assert_close(p[k] - before[k], change[k], rtol=1e-6,
                                       atol=1e-6 * scale)
            torch.testing.assert_close(st.mu[k], buf[k], rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("fault", ["no_momentum", "no_weight_decay"])
def test_sgd_apply_faults_move_the_weights_otherwise(fault):
    g = torch.Generator().manual_seed(2)
    params = {"m.conv.weight": torch.randn(4, 3, 3, 3, generator=g, dtype=torch.float64),
              "m.conv.bias": torch.randn(4, generator=g, dtype=torch.float64)}
    grad = {k: 1e-3 * torch.randn(v.shape, generator=g, dtype=torch.float64)
            for k, v in params.items()}
    sched = {"epochs": 300, "steps_per_epoch": 2183, "accumulate": 2, "lr0": 0.01,
             "lrf": 0.1, "momentum": 0.937, "warmup_epochs": 3.0, "warmup_floor": 1000.0,
             "warmup_momentum": 0.8, "warmup_bias_lr": 0.1, "weight_decay": 5e-4}
    sound, _ = ref_optim.sgd_apply(params, grad, None, 272, sched)
    bad, _ = ref_optim.sgd_apply(params, grad, None, 272, sched, fault)
    assert not torch.allclose(bad["m.conv.weight"], sound["m.conv.weight"], rtol=1e-3)
    torch.testing.assert_close(bad["m.conv.bias"], sound["m.conv.bias"], rtol=0, atol=0)


def test_ema_against_the_program():
    from ecs_yolo_tpu_torch.train.ema import ema_update

    g = torch.Generator().manual_seed(4)
    ema = {"a": torch.randn(5, generator=g, dtype=torch.float64)}
    params = {"a": torch.randn(5, generator=g, dtype=torch.float64)}
    got = {"a": ema["a"].clone()}
    ema_update(got, params, 273)
    ref_optim.ema_apply(ema, params, 273)
    # the program takes its decay in float32
    torch.testing.assert_close(got["a"], ema["a"], rtol=1e-6, atol=1e-9)


def test_teacher_forcing_follows_the_given_spikes(cfg):
    """With every site forced to the spikes of another run, the reference's
    walk gives that run's outputs."""
    _, ref = _models(cfg)
    x = scenes.make_frames(1, 2, "cpu", (72, 128), SIZE).permute(0, 3, 1, 2).float() / 255.0
    _calibrate(ref, TBN, x)
    sites = [m for m in ref.modules() if isinstance(m, MemUpdate)]
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append(o)) for m in sites]
    with torch.no_grad():
        want = ref(x)
    for h in hooks:
        h.remove()
    for m, s in zip(sites, seen):
        m.forced = s.to(torch.uint8)
    with torch.no_grad():
        got = ref(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
