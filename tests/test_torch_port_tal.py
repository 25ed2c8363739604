"""The task-aligned assigner, the TAL/DFL losses and their training step
against the JAX package (CPU).

The assigner's output must equal JAX's: labels, gt indices and foreground
exactly, boxes and scores to 1e-12.  Its batches include padded gt rows, an
image with no targets and anchors whose align metric is exactly 0 (a
predicted box that misses its target), where the order of equal values in
the top-k decides the targets: ``jax.lax.top_k`` puts the lower index first,
bare ``torch.topk`` does not.  The four losses and their gradients with
respect to the head outputs run in float64 against ``jax.value_and_grad``:
1e-10 relative.  ``make_loss_fn`` is held to JAX's for every anchor-free
head name under ``HYP_SCRATCH`` (its box gain 0.05 reaches ``DDetect`` and
``ASFF_DDetect`` only).  A whole SGD step at ``time_window=1`` on a small
``DDetect`` model, where no spread parameter takes part, is held to JAX's in
float64: the spread parameters get zero gradients.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu.models import yolo as jax_yolo
from ecs_yolo_tpu.nn import heads as JH
from ecs_yolo_tpu.train import loss_tal as JL
from ecs_yolo_tpu.train import optim as JO
from ecs_yolo_tpu.train import tal as JTAL
from ecs_yolo_tpu.train import trainer as JT
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.data.hyps import HYP_SCRATCH
from ecs_yolo_tpu_torch.models import convert as CV
from ecs_yolo_tpu_torch.models import yolo as port_yolo
from ecs_yolo_tpu_torch.nn import heads as PH
from ecs_yolo_tpu_torch.train import loss_tal as PL
from ecs_yolo_tpu_torch.train import optim as PO
from ecs_yolo_tpu_torch.train import tal as PTAL
from ecs_yolo_tpu_torch.train import trainer as PT
from test_torch_port_model import _random_variables

torch.set_num_threads(2)

#: XLA's cheap compile: these graphs run once
_FAST = dict(xla_backend_optimization_level=0, xla_llvm_disable_expensive_passes=True)
NC, REG = 3, 16
STRIDES = (16.0, 32.0)
LEVELS = [(4, 4), (2, 2)]        # a 64 px image


def _targets(b, m, seed, n_valid, empty_image=None):
    """``[B, M, 5]`` targets (class, normalised xywh) and the mask: the first
    ``n_valid`` rows of each image real, the rest zero padding; one image
    may have none."""
    rng = np.random.RandomState(seed)
    wh = rng.uniform(0.15, 0.6, (b, m, 2))
    xy = wh / 2 + rng.rand(b, m, 2) * (1 - wh)
    t = np.concatenate([rng.randint(0, NC, (b, m, 1)), xy, wh], -1)
    mask = np.zeros((b, m), bool)
    mask[:, :n_valid] = True
    if empty_image is not None:
        mask[empty_image] = False
    t[~mask] = 0.0
    return t, mask


def _feats(b, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, NC + 4 * REG, h, w) * scale for h, w in LEVELS]


# --- the assigner ------------------------------------------------------------------


def _assign_inputs(seed, zero_metric):
    """Inputs of the assigner in image units.  With ``zero_metric`` the
    predicted boxes sit in a corner, so most in-box anchors score 0."""
    rng = np.random.RandomState(seed)
    b, m = 3, 5
    pts = np.concatenate([np.stack(np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5),
                                   -1).reshape(-1, 2) * s
                          for (h, w), s in zip(LEVELS, STRIDES)])
    a = len(pts)
    scores = rng.rand(b, a, NC)
    if zero_metric:
        boxes = np.tile([0.0, 0.0, 3.0, 3.0], (b, a, 1)) + rng.rand(b, a, 4)
        boxes[:, ::7] = np.concatenate([pts[::7] - 9, pts[::7] + 9], -1)
    else:
        c = pts[None] + rng.randn(b, a, 2) * 6
        half = rng.uniform(5, 20, (b, a, 2))
        boxes = np.concatenate([c - half, c + half], -1)
    t, mask = _targets(b, m, seed + 1, n_valid=3, empty_image=2)
    gt = t[..., 1:] * 64
    gt = np.concatenate([gt[..., :2] - gt[..., 2:] / 2, gt[..., :2] + gt[..., 2:] / 2], -1)
    return scores, boxes, pts, t[..., 0], gt * mask[..., None], mask


@pytest.mark.parametrize("topk", [10, 1])
@pytest.mark.parametrize("zero_metric", [True, False])
def test_assigner_matches_jax(zero_metric, topk):
    args = _assign_inputs(seed=3 if zero_metric else 4, zero_metric=zero_metric)
    with jax.enable_x64():
        want = jax.jit(lambda *a: JTAL.task_aligned_assigner(*a, topk=topk, num_classes=NC),
                       compiler_options=_FAST)(*(jnp.asarray(a) for a in args))
        want = [np.asarray(w) for w in want]
    got = PTAL.task_aligned_assigner(*(torch.from_numpy(a) for a in args), topk=topk,
                                     num_classes=NC)
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=1e-12, rtol=0)
    fg = got.fg_mask.numpy()
    assert fg.any() and not fg[2].any()          # the image without targets
    if zero_metric and topk == 10:
        # the metric the top-k ranks: zero at most in-box anchors, where bare
        # torch.topk picks other anchors than lax.top_k
        from ecs_yolo_tpu_torch.ops.boxes import bbox_iou

        scores, boxes, pts, labels, gt, _ = (torch.from_numpy(a) for a in args)
        lab = labels.long()[:, None, :].expand(-1, scores.shape[1], -1)
        s = scores.gather(-1, lab).permute(0, 2, 1)
        iou = bbox_iou(gt[:, :, None], boxes[:, None], xywh=False, CIoU=True).clamp(min=0)
        metric = s ** 0.5 * iou ** 6 * PTAL.select_candidates_in_gts(pts, gt)
        lax_idx = np.asarray(jax.lax.top_k(jnp.asarray(metric.numpy()), topk)[1])
        top = np.take_along_axis(metric.numpy(), lax_idx, -1)
        assert (top[:2, :3] == 0).any()                # ties at zero among real gts
        assert np.array_equal(PTAL.topk_lower_index_first(metric, topk)[1].numpy(), lax_idx)
        assert not np.array_equal(torch.topk(metric, topk).indices.numpy(), lax_idx)


def test_topk_candidates_drop_masked_rows_as_jax():
    rng = np.random.RandomState(5)
    metrics = np.round(rng.rand(2, 4, 20), 1)          # many equal values
    mask = np.ones((2, 4, 10), bool)
    mask[1, 2:] = False
    want = np.asarray(JTAL.select_topk_candidates(jnp.asarray(metrics), 10,
                                                  jnp.asarray(mask)))
    got = PTAL.select_topk_candidates(torch.from_numpy(metrics), 10, torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


# --- the losses --------------------------------------------------------------------


def _batch(b=3):
    t, mask = _targets(b, 6, seed=7, n_valid=4, empty_image=1)
    return t, mask


def _jax_loss(kind, feats, t, mask):
    """JAX's (total, items) of a loss kind on per-branch lists of maps."""
    args = (jnp.asarray(t), jnp.asarray(mask), STRIDES, NC)
    if kind == "tal":
        return JL.compute_loss_tal(feats[0], *args, gains=(0.05, 0.5, 1.5))
    if kind == "v10":
        return JL.compute_loss_v10(JH.V10Output(feats[0], feats[1]), *args)
    if kind == "dual":
        return JL.compute_loss_dual(feats[0], feats[1], *args)
    return JL.compute_loss_triple(tuple(feats), *args)


def _port_loss(kind, feats, t, mask):
    args = (torch.from_numpy(t), torch.from_numpy(mask), STRIDES, NC)
    if kind == "tal":
        return PL.compute_loss_tal(feats[0], *args, gains=(0.05, 0.5, 1.5))
    if kind == "v10":
        return PL.compute_loss_v10(PH.V10Output(feats[0], feats[1]), *args)
    if kind == "dual":
        return PL.compute_loss_dual(feats[0], feats[1], *args)
    return PL.compute_loss_triple(tuple(feats), *args)


BRANCHES = {"tal": 1, "v10": 2, "dual": 2, "triple": 3}


@pytest.mark.parametrize("kind", sorted(BRANCHES))
def test_loss_and_gradients_match_jax_f64(kind):
    t, mask = _batch()
    feats = [_feats(3, seed=20 + k) for k in range(BRANCHES[kind])]
    with jax.enable_x64():
        def total(fs):
            return _jax_loss(kind, fs, t, mask)[0]
        jf = [[jnp.asarray(f) for f in br] for br in feats]
        (want, want_g), want_items = jax.jit(
            lambda fs: (jax.value_and_grad(total)(fs), _jax_loss(kind, fs, t, mask)[1]),
            compiler_options=_FAST)(jf)
        want_items = np.asarray(want_items)
    pf = [[torch.from_numpy(f).requires_grad_() for f in br] for br in feats]
    got, items = _port_loss(kind, pf, t, mask)
    grads = torch.autograd.grad(got, [f for br in pf for f in br])
    assert items.shape == (3 * BRANCHES[kind],) and not items.requires_grad
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-10)
    np.testing.assert_allclose(items.numpy(), want_items, rtol=1e-10, atol=1e-14)
    for g, w in zip(grads, [w for br in want_g for w in br]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-13)
    assert all(float(g.abs().sum()) > 0 for g in grads)


def _stand_ins(name):
    """The head metadata each side's ``make_loss_fn`` reads."""
    jm = types.SimpleNamespace(head_name=name, nc=NC, strides=STRIDES, head={})
    pm = types.SimpleNamespace(head_info={"name": name, "nc": NC, "strides": STRIDES})
    return jm, pm


LOSSES = ("compute_loss_tal", "compute_loss_v10", "compute_loss_dual", "compute_loss_triple")


def _recorded_calls(module, monkeypatch):
    """Each loss of ``module`` replaced by a recorder of its call: which
    loss, the head output's structure, the keyword arguments."""
    calls = []
    for fn in LOSSES:
        monkeypatch.setattr(module, fn, lambda *a, _fn=fn, **k: calls.append(
            (_fn, type(a[0]).__name__, len(a), a[-2:], k)) or (0.0, None))
    return calls


@pytest.mark.parametrize("name", ["DDetect", "ASFF_DDetect", "v10Detect", "ASFF_v10Detect",
                                  "DualDetect", "DualDDetect", "TripleDetect",
                                  "TripleDDetect"])
def test_make_loss_fn_dispatches_as_jax_under_hyp_scratch(name, monkeypatch):
    """The loss, the way the head output is handed to it and the gains, for
    every anchor-free head name: ``DDetect``/``ASFF_DDetect`` take the hyp's
    box gain (0.05 in ``HYP_SCRATCH``), the other heads their losses' fixed
    7.5 (the losses' values against JAX's are the tests above)."""
    jcalls, pcalls = _recorded_calls(JT, monkeypatch), _recorded_calls(PT, monkeypatch)
    jm, pm = _stand_ins(name)
    out = ((0, 1), (2, 3)) if "Dual" in name else ((0, 1), (2, 3), (4, 5)) \
        if "Triple" in name else JH.V10Output(0, 1) if "v10" in name else [0, 1]
    pout = PH.V10Output(0, 1) if "v10" in name else out
    JT.make_loss_fn(jm, dict(HYP_SCRATCH))(out, "targets", "mask")
    PT.make_loss_fn(pm, dict(HYP_SCRATCH))(pout, "targets", "mask")
    assert len(jcalls) == len(pcalls) == 1
    (jfn, jkind, jn, jtail, jkw), (pfn, pkind, pn, ptail, pkw) = jcalls[0], pcalls[0]
    assert (pfn, pkind, pn, ptail) == (jfn, jkind, jn, jtail)
    assert pkw == jkw
    if name in ("DDetect", "ASFF_DDetect"):
        assert pkw["gains"] == (0.05, 0.5, 1.5)


# --- a whole step at T = 1 -----------------------------------------------------------

TINY = {
    "nc": NC, "depth_multiple": 1.0, "width_multiple": 1.0, "anchors": 2,
    "backbone": [[-1, 1, "Conv_1", [8, 3, 4]],
                 [-1, 1, "BasicBlock_2", [16, 3, 4]]],
    "head": [[-1, 1, "BasicBlock_2", [16, 3, 2]],
             [[1, 2], 1, "DDetect", ["nc"]]],
}


def test_a_time_window_1_step_matches_jax_f64():
    """At T = 1 no step reads the spikes of a step before, so the spread
    parameters take no part in the loss: JAX's gradient for them is zero,
    and the port's step gives the same (it raised before).  Loss, items and
    every parameter after one SGD step to 1e-10."""
    hyp = dict(HYP_SCRATCH)
    opt = dict(name="SGD", lr0=hyp["lr0"], lrf=hyp["lrf"], momentum=hyp["momentum"],
               weight_decay=hyp["weight_decay"], epochs=2, steps_per_epoch=4,
               warmup_epochs=hyp["warmup_epochs"], warmup_momentum=hyp["warmup_momentum"],
               warmup_bias_lr=hyp["warmup_bias_lr"])
    jm = jax_yolo.build_model(TINY, snn=JaxSNNConfig(time_window=1, packed_c64=False))
    v = _random_variables(lambda: jm.module.init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 64, 64, 3)),
                                                 training=False), 3)
    t, mask = _targets(2, 4, seed=8, n_valid=3)
    ims = np.random.RandomState(9).rand(2, 64, 64, 3)
    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        tx = JO.build_optimizer(v64["params"], warmup_floor=100.0, **opt)
        state = JT.create_train_state(v64, tx)
        step = jax.jit(JT.make_train_step(jm, tx, hyp, jit=False), compiler_options=_FAST)
        state, m = step(state, jnp.asarray(ims), jnp.asarray(t), jnp.asarray(mask))
        want_p = CV.convert(state.params, state.batch_stats, jm.spec)
        want_loss, want_items = float(m["loss"]), np.asarray(m["items"])

    pm = port_yolo.build_model(TINY, snn=SNNConfig(time_window=1), device="cpu")
    pm.load_state_dict(CV.convert(v["params"], v["batch_stats"], pm.spec), strict=True)
    pm = pm.double()
    tx = PO.build_optimizer(dict(pm.named_parameters()), warmup_floor=100.0, **opt)
    pstate = PT.create_train_state(pm, tx, device="cpu")
    batch = (torch.from_numpy(ims), torch.from_numpy(t), torch.from_numpy(mask))
    bufs = {k: b.clone() for k, b in pm.named_buffers()}
    _, _, grads = PT.make_grad_fn(pm, hyp)(pstate, *batch)
    with torch.no_grad():               # the step below moves the statistics again
        for k, b in pm.named_buffers():
            b.copy_(bufs[k])
    spread = [k for k in grads if ".spread." in k]
    assert spread and all(not grads[k].any() for k in spread)
    assert all(grads[k].any() for k in grads if ".conv." in k)
    pstate, pmet = PT.make_train_step(pm, tx, hyp, device="cpu")(pstate, *batch)
    np.testing.assert_allclose(float(pmet["loss"]), want_loss, rtol=1e-10)
    np.testing.assert_allclose(pmet["items"].numpy(), want_items, rtol=1e-10, atol=1e-14)
    sd = pm.state_dict()
    for k, w in want_p.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=1e-10, atol=1e-12,
                                   err_msg=k)
