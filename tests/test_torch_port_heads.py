"""The anchor-free heads against the JAX package (CPU): the blocks they are
made of (``Conv_B``, ``Conv``, ``GSConv``, ``ASFF2``), the heads
(``DualDDetect``, ``TripleDetect``, ``ASFF_DDetect``, ``ASFF_v10Detect``;
``DDetect`` and ``v10Detect`` run inside the last two as their ``det``,
``TripleDDetect`` and ``DualDetect`` are the first two's classes with three
and two branches), the
five anchor-free YAMLs (spec and strides, head bias init, the optimizer
groups and the ``sr`` predicates of every parameter, the folded conv/bn
pairs), whole models in eval and training (``res10-dualplain``,
``res10v10``, ``res10-dual``, ``res10-triple``, ``res10-panoptic``,
``resnet10-v9``),
``v10_postprocess``, and ``val.run`` / ``detect.run`` on a v10 and a dual
model handing NMS what the JAX ``val.run`` hands it.

Weights cross by ``models/convert.py`` with ``load_state_dict(strict=True)``.
Tolerances: the blocks and heads run in float64 on both sides (eval, where
the port's neuron sites take their kernels' plain versions, and training
mode); no membrane then lands within rounding of the threshold and the
outputs agree to 1e-9.  The served passes run in float32: boxes to 1e-3
absolute, scores to 1e-5, the same detections kept.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu.models import utils as JMU
from ecs_yolo_tpu.models import yolo as jax_yolo
from ecs_yolo_tpu.nn import blocks as JB
from ecs_yolo_tpu.nn import blocks_ext as JBX
from ecs_yolo_tpu.nn import heads as JH
from ecs_yolo_tpu.ops import nms as JN
from ecs_yolo_tpu.train import optim as JO
from ecs_yolo_tpu.train import sparsity as JSP
from ecs_yolo_tpu_torch import detect as port_detect
from ecs_yolo_tpu_torch import val as port_val
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.models import convert as CV
from ecs_yolo_tpu_torch.models import utils as PMU
from ecs_yolo_tpu_torch.models import yolo as port_yolo
from ecs_yolo_tpu_torch.nn import blocks as PB
from ecs_yolo_tpu_torch.nn import blocks_ext as PBX
from ecs_yolo_tpu_torch.nn import heads as PH
from ecs_yolo_tpu_torch.ops import nms as PN
from ecs_yolo_tpu_torch.train import optim as PO
from ecs_yolo_tpu_torch.train import sparsity as PSP
from test_torch_port_model import _port_block_f64, _random_variables, _x
from test_torch_port_val import write_split

torch.set_num_threads(2)

T = 2
YAMLS = ["res10v8.yaml", "res10v10.yaml", "res10-dual.yaml", "res10-triple.yaml",
         "res10-dualplain.yaml"]
STRIDES = (16.0, 32.0)


def _leaves(tree):
    """The tensors of a head output, depth first (lists, tuples, V10Output)."""
    if isinstance(tree, (torch.Tensor, np.ndarray, jax.Array)):
        return [tree]
    return [leaf for v in tree for leaf in _leaves(v)]


def _assert_tree_close(got, want, tol=1e-9):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        assert a.shape == np.shape(b)
        np.testing.assert_allclose(a, np.asarray(b), atol=tol, rtol=tol)


#: XLA's cheap compile: these graphs run once
_FAST = dict(xla_backend_optimization_level=0, xla_llvm_disable_expensive_passes=True)


def _jax_f64(module, xs, seed, training=False, compiler_options=_FAST):
    """Seeded variables for ``module`` on ``xs`` (an array or a list), and
    in float64 its eval output, or with ``training`` its eval output, its
    training output and its updated BN statistics (one jit, with XLA's
    cheap compile unless ``compiler_options`` says otherwise)."""
    as_list = isinstance(xs, list)
    x32 = [jnp.asarray(a) for a in xs] if as_list else jnp.asarray(xs)
    v = _random_variables(lambda: module.init(jax.random.PRNGKey(0), x32), seed)

    def run(v_, x_):
        out = module.apply(v_, x_, training=False)
        if not training:
            return out
        return out, module.apply(v_, x_, training=True, mutable=["batch_stats"])

    with jax.enable_x64():
        # numpy casts: a jnp cast compiles one small program a leaf shape
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        x64 = ([np.asarray(a, np.float64) for a in xs] if as_list
               else np.asarray(xs, np.float64))
        return v, jax.jit(run, compiler_options=compiler_options)(v64, x64)


# --- blocks ------------------------------------------------------------------------

BLOCKS = {
    "Conv_B": (lambda: JB.Conv_B(16, 3, g=4), lambda: PB.Conv_B(8, 16, 3, g=4),
               (T, 2, 6, 6, 8)),
    "Conv": (lambda: JB.Conv(8, 3), lambda: PB.Conv(8, 8, 3), (T, 2, 6, 6, 8)),
    "GSConv": (lambda: JBX.GSConv(16), lambda: PBX.GSConv(24, 16), (T, 2, 6, 6, 24)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax_f64(name):
    jax_mod, port_mod, shape = BLOCKS[name]
    x = _x(shape, seed=3)
    v, want = _jax_f64(jax_mod(), x, seed=4)
    got = _port_block_f64(port_mod(), name, v, x).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-9, rtol=1e-9)


@pytest.mark.parametrize("level", [0, 1])
def test_asff2_matches_jax_f64(level):
    xs = [_x((T, 2, 3, 3, 32), 5), _x((T, 2, 6, 6, 16), 6)]
    v, want = _jax_f64(JBX.ASFF2(level=level), xs, seed=7)
    got = _port_block_f64(PBX.ASFF2(level, 32, 16), "ASFF2", v, xs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9, rtol=1e-9)


def test_dfl_and_anchor_ops_match_jax():
    from ecs_yolo_tpu.ops import anchors as JA
    from ecs_yolo_tpu_torch.ops import anchors as PA

    x = np.random.RandomState(0).randn(2, 64, 10)
    want = np.asarray(JB.DFL(16).apply({}, jnp.asarray(x, jnp.float32)))
    got = PB.DFL(16)(torch.from_numpy(x).float()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        pa, ps = PA.make_anchors([(4, 5), (2, 3)], STRIDES, 0.5, dtype)
        ja, js = JA.make_anchors([(4, 5), (2, 3)], STRIDES, 0.5, jdt)
        np.testing.assert_array_equal(pa.float().numpy(), np.asarray(ja, np.float32))
        np.testing.assert_array_equal(ps.float().numpy(), np.asarray(js, np.float32))
    d = np.abs(np.random.RandomState(1).randn(3, 7, 4)) * 3
    pts = np.random.RandomState(2).rand(7, 2) * 10
    for xywh in (True, False):
        np.testing.assert_allclose(
            PA.dist2bbox(torch.from_numpy(d), torch.from_numpy(pts), xywh).numpy(),
            np.asarray(JA.dist2bbox(jnp.asarray(d), jnp.asarray(pts), xywh)), atol=1e-6)
    box = PA.dist2bbox(torch.from_numpy(d), torch.from_numpy(pts), False)
    np.testing.assert_allclose(
        PA.bbox2dist(torch.from_numpy(pts), box, 2.5).numpy(),
        np.asarray(JA.bbox2dist(jnp.asarray(pts), jnp.asarray(box.numpy()), 2.5)),
        atol=1e-6)


# --- heads -------------------------------------------------------------------------

# name -> (jax head, port head, groups of two input levels).  ``DDetect`` and
# ``v10Detect`` run inside the ASFF heads (their ``det``, fed the fused maps);
# ``TripleDDetect`` is ``DualDDetect``'s class with three branches and
# ``DualDetect`` ``TripleDetect``'s with two: those are held to JAX there,
# which keeps the suite inside its time budget
HEADS = {
    "DualDDetect": (JH.DualDDetect, PH.DualDDetect, 2),
    "TripleDetect": (JH.TripleDetect, PH.TripleDetect, 3),
    "ASFF_DDetect": (JH.ASFF_DDetect, PH.ASFF_DDetect, 1),
    "ASFF_v10Detect": (JH.ASFF_v10Detect, PH.ASFF_v10Detect, 1),
}


def _head_inputs(groups, seed):
    """Two levels a group: 4x4 at 16 channels, 2x2 at 32."""
    xs, ch = [], []
    for g in range(groups):
        xs += [_x((T, 2, 4, 4, 16), seed + 2 * g), _x((T, 2, 2, 2, 32), seed + 2 * g + 1)]
        ch += [16, 32]
    return xs, ch


@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_matches_jax_f64_in_eval_and_training(name):
    """The eval output (the decode included), then the training output and
    the moved BN statistics, in float64."""
    jcls, pcls, groups = HEADS[name]
    xs, ch = _head_inputs(groups, seed=11)
    jmod = jcls(nc=3, reg_max=16, strides=STRIDES, snn=JaxSNNConfig(time_window=T))
    v, (want, (want_t, upd)) = _jax_f64(jmod, xs, 12, training=True)
    head = pcls(3, 16, STRIDES, ch, snn=SNNConfig(time_window=T)).double()
    head.load_state_dict({k: t.double() for k, t in CV.convert_block(
        name, v["params"], v["batch_stats"]).items()}, strict=True)
    x = [torch.from_numpy(a).double() for a in xs]
    with torch.no_grad():
        got = head.eval()(x)
    got_t = head.train()(x)
    for g, w in ((got, want), (got_t, want_t)):
        assert type(g).__name__ == type(w).__name__
        _assert_tree_close(g, w)
    if name in port_yolo.V10_HEADS:
        assert got.one2one[0].shape == (2, 7, 20)
        assert got_t.one2one[0].shape == (2, 67, 4, 4)
    sd = head.state_dict()
    for k, w in CV.convert_block(name, {}, upd["batch_stats"]).items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-12, rtol=0)


def test_v10_one2one_branch_takes_no_gradient_into_its_input():
    xs, ch = _head_inputs(1, seed=3)
    head = PH.v10Detect(3, 16, STRIDES, ch, snn=SNNConfig(time_window=T)).double().train()
    x = [torch.from_numpy(a).double().requires_grad_() for a in xs]
    out = head(x)
    g = torch.autograd.grad(sum(o.sum() for o in out.one2one), x, allow_unused=True)
    assert all(a is None for a in g)
    g = torch.autograd.grad(sum(o.sum() for o in head(x).one2many), x)
    assert all(float(a.abs().sum()) > 0 for a in g)


def test_v10_postprocess_matches_jax_with_ties():
    rng = np.random.RandomState(4)
    pred = np.concatenate([rng.rand(2, 2, 60) * 60 + 2, rng.rand(2, 2, 60) * 20 + 1,
                           rng.rand(2, 3, 60)], axis=1).astype(np.float32)
    pred[:, 4:, 10:20] = 0.5                  # equal scores across anchors and classes
    pred[1, 4:, 30:] = 0.0                    # an image with few positive scores
    for max_det in (5, 40, 100):
        jo, jv = JN.v10_postprocess(jnp.asarray(pred), max_det)
        po, pv = PN.v10_postprocess(torch.from_numpy(pred), max_det)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-5)


# --- the five YAMLs ----------------------------------------------------------------


def _narrow(cfg):
    d = port_yolo.load_cfg(cfg)
    d["width_multiple"] = 0.25
    return d


def _jax_head(d, probe):
    """JAX's parse of ``d``, and JAX's head traced once at its inputs'
    shapes in the 256 px stride probe (``probe``: the port's model of ``d``
    on the meta device, its backbone held to JAX's block by block in
    test_torch_port_model): the head's seeded variables and JAX's strides
    from ``_head_feat_shapes`` of its training output, as JAX's
    ``build_model`` probes them.  Returns (JAX's built-model metadata, the
    head's variables under ``layers_{i}``)."""
    snn = JaxSNNConfig(time_window=T)
    d = dict(d, nc=3)
    spec, save, _, head_info = jax_yolo.parse_model(d, 3)
    name, idx = head_info["name"], head_info["index"]
    shapes = []
    hook = probe.model[idx].register_forward_pre_hook(
        lambda m, a: shapes.extend(tuple(x.shape) for x in a[0]))
    with torch.no_grad():
        probe(torch.zeros(1, 256, 256, 3, device="meta"))
    hook.remove()
    head = jax_yolo.HEADS[name](3, 16, tuple(2.0 ** (3 + i) for i in range(2)), snn=snn)
    out = {}

    def init():
        o, variables = head.init_with_output(jax.random.PRNGKey(0),
                                             [jnp.zeros(s) for s in shapes], training=True)
        out["o"] = o
        return variables

    v = _random_variables(init, 9)
    strides = tuple(float(256 // h) for h, _ in jax_yolo._head_feat_shapes(out["o"], name))
    head_info["strides"] = strides
    final = jax_yolo._with_head_args(spec, idx, name, head_info, strides)
    jm = jax_yolo.BuiltModel(None, d, final, save, head_info, strides, snn)
    layer = f"layers_{idx}"
    return jm, {"params": {layer: v["params"]}, "batch_stats": {layer: v["batch_stats"]}}


@pytest.mark.parametrize("cfg", YAMLS)
def test_yaml_matches_jax(cfg):
    """A narrowed YAML in both packages, the head's weights converted
    (strict load): the parsed spec, the head and the probed strides; the
    head bias prior on every prefix set (box bias 1, class bias log(5 / nc /
    (640 / s)^2)); the optimizer group and the ``sr`` predicates of every
    head parameter; the conv/bn pairs the fold takes (every tower pair, and
    the stem: the BN statistics JAX's ``fuse_conv_bn`` resets).  The
    backbone's parameters are res10's (test_torch_port_train,
    test_torch_port_fuse)."""
    d = _narrow(cfg)
    snn = SNNConfig(time_window=T)
    jm, v = _jax_head(d, port_yolo.build_model(d, nc=3, snn=snn, device="meta"))
    pm = port_yolo.build_model(d, nc=3, snn=snn, device="cpu")
    idx, name = jm.head["index"], jm.head_name
    layer, pre = f"layers_{idx}", f"model.{idx}."
    head = pm.model[idx]
    head.load_state_dict(CV.convert_block(name, v["params"][layer], v["batch_stats"][layer]),
                         strict=True)
    assert pm.spec == jm.spec
    assert pm.head_info["strides"] == jm.strides == STRIDES
    assert pm.head_info["name"] == name

    def jax_labels(fn):
        tree = jax.tree_util.tree_map_with_path(fn, v["params"])[layer]
        return {pre + k: lab for k, lab in CV.convert_block(
            name, tree, None, leaf=lambda b, p, x: x).items()}

    labels = PO.build_optimizer(dict(pm.named_parameters())).labels
    assert {k: g for k, g in labels.items() if k.startswith(pre)} == \
        jax_labels(JO.param_group_label)
    for jax_pred, port_pred in ((JSP._is_bn_scale, PSP.is_bn_scale),
                                (JSP._is_bn_bias, PSP.is_bn_bias)):
        want = jax_labels(lambda p, _: jax_pred(p))
        assert {k: port_pred(k) for k in want} == want and any(want.values())

    before = {k: t.clone() for k, t in head.state_dict().items()}
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    biases = jax.jit(lambda p: jax_yolo.init_head_biases(jm, {"params": p}),
                     compiler_options=_FAST)(params)
    want = CV.convert_block(name, biases["params"][layer])
    port_yolo.init_head_biases(pm)
    sd = head.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(sd[k].numpy(), np.asarray(w), atol=1e-6, rtol=0)
    prefixes = {"ASFF_DDetect": 1, "ASFF_v10Detect": 2, "DualDDetect": 2,
                "TripleDDetect": 3, "DualDetect": 2}[name]
    moved = [k for k in sd if not torch.equal(sd[k], before[k])]
    assert len(moved) == 2 * 2 * prefixes      # two levels, a box and a class bias each

    fused = jax.jit(JMU.fuse_conv_bn, compiler_options=_FAST)(v)     # one compile
    reset = {pre + k[:-len(".bn.bn.running_mean")]
             for k, w in CV.convert_block(name, {}, fused["batch_stats"][layer]).items()
             if k.endswith(".bn.bn.running_mean") and not np.asarray(w).any()}
    folded = set(PMU.fuse_conv_bn(pm))
    assert {f for f in folded if f.startswith(pre)} == reset
    assert len(reset) > 8 and "model.0" in folded


#: the whole models held to JAX, with the leaf count of their eval and
#: training outputs: the dual, triple and v10 wirings, the panoptic head and
#: the v9 wiring (``CBLinear`` / ``CBFuse``).  res10v8 and res10-seg are left
#: out for time: their files are res10v10's and res10-panoptic's row for row
#: but the head (each head is held alone above and in
#: test_torch_port_segment), so their backbone-to-head wiring is held here.
WHOLE = {"res10-dualplain.yaml": (5, 4), "res10v10.yaml": (5, 4), "res10-dual.yaml": (5, 4),
         "res10-triple.yaml": (7, 6), "res10-panoptic.yaml": (6, 5),
         "resnet10-v9.yaml": (7, 6)}


def _narrow_whole(cfg):
    """``cfg`` at width 1/4; ``CBLinear`` groups, which the YAML gives
    unscaled, narrowed by the same factor (as ``test_torch_port_zoo``'s
    ``_narrow`` does at 1/8)."""
    d = _narrow(cfg)
    for row in d["head"]:
        if row[2] == "CBLinear":
            row[3] = [[c // 4 for c in row[3][0]]]
    return d


@pytest.mark.parametrize("cfg", list(WHOLE))
def test_whole_dual_model_matches_jax_f64_in_eval_and_training(cfg):
    """``cfg`` narrowed, whole, in both packages with every weight converted
    (strict load): the eval output (decoded predictions and every branch's
    maps), the training output and the moved BN statistics, in float64 to
    1e-9 (statistics 1e-12).  This holds the backbone-to-head wiring (the
    head's ``from`` list, e.g. res10-dual's ``[11, 12, 10, 6]``, the v9
    ``CBLinear`` / ``CBFuse`` taps) that the head cases above feed by hand.
    JAX's model is built as its ``build_model`` builds it, with the strides
    of the port's build (its probe is a whole trace more); one
    cheap-compile jit."""
    d = _narrow_whole(cfg)
    snn = JaxSNNConfig(time_window=T)
    pm = port_yolo.build_model(d, nc=3, snn=SNNConfig(time_window=T), device="cpu", imgsz=64)
    strides = tuple(pm.head_info["strides"])
    spec, save, chs, head = jax_yolo.parse_model(dict(d, nc=3), 3)
    head["strides"] = strides
    module = jax_yolo.DetectionModel(
        spec=jax_yolo._with_head_args(spec, head["index"], head["name"], head, strides),
        save=save, snn=snn, packing=jax_yolo._plan_packing(spec, chs, snn.packed_c64),
        tinv_prefix=jax_yolo._t_invariant_prefix(spec, save) if snn.stem_dedup else 0)
    v = _random_variables(lambda: module.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 64, 64, 3)), training=False), 7)
    x = np.random.RandomState(1).rand(2, 64, 64, 3)

    def run(v_, x_):
        out = module.apply(v_, x_, training=False)
        return out, module.apply(v_, x_, training=True, mutable=["batch_stats"])

    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        want, (want_t, upd) = jax.jit(run, compiler_options=_FAST)(v64, x)
    pm.load_state_dict(CV.convert(v["params"], v["batch_stats"], pm.spec), strict=True)
    pm = pm.double()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = pm.eval()(xt)
    got_t = pm.train()(xt)
    assert (len(_leaves(got)), len(_leaves(got_t))) == WHOLE[cfg]
    _assert_tree_close(got, want)
    _assert_tree_close(got_t, want_t)
    sd = pm.state_dict()
    moved = CV.convert({}, upd["batch_stats"], pm.spec)
    assert moved
    for k, w in moved.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-12, rtol=0, err_msg=k)


# --- served through val.run and detect.run -----------------------------------------


def _jax_val_prediction(head_name, out):
    """What the JAX ``val.run`` hands to NMS (``ecs_yolo_tpu/val.py`` line 98)."""
    return out.one2one[0] if head_name in ("v10Detect", "ASFF_v10Detect") else out[0]


@pytest.mark.parametrize("cfg", ["res10v10.yaml", "res10-dual.yaml"])
def test_val_and_detect_serve_the_head_as_jax_val_does(cfg, tmp_path, monkeypatch):
    """The head's inputs and the NMS calls of a ``val.run`` and a
    ``detect.run`` pass are recorded: NMS saw what the JAX ``val.run``
    hands it from the head's eval output (the head itself is held to JAX's
    in ``test_head_matches_jax_f64_in_eval_and_training``, the backbone
    block by block in test_torch_port_model, the NMS on the DFL layout in
    test_torch_port_model's NMS cases), with no objectness, as JAX's."""
    pm = port_yolo.build_model(_narrow(cfg), nc=3, snn=SNNConfig(time_window=T),
                               device="cpu")
    name = pm.head_info["name"]
    head = pm.model[-1]
    inputs, calls = [], []
    head.register_forward_pre_hook(lambda m, a: inputs.append([x.clone() for x in a[0]]))

    def record(nms):
        def wrapped(pred, **kw):
            out = nms(pred, **kw)
            calls.append((pred.clone(), kw, out))
            return out
        return wrapped

    monkeypatch.setattr(port_val, "non_max_suppression", record(port_val.non_max_suppression))
    monkeypatch.setattr(port_detect, "non_max_suppression",
                        record(port_detect.non_max_suppression))
    src = write_split(tmp_path / "s", sizes=[(64, 64), (48, 80), (70, 40)])
    port_val.run(pm, str(src), imgsz=64, batch_size=2, max_labels=8, workers=0)
    port_detect.run(pm, src, imgsz=64, conf_thres=0.05)
    assert len(calls) == len(inputs) == 2 + 3
    kept = 0
    for x, (pred, kw, (out, valid)) in zip(inputs, calls):
        with torch.no_grad():
            want = _jax_val_prediction(name, head(x))
        assert torch.equal(pred, want)
        assert kw["has_obj"] is False
        kept += int(valid.sum())
    assert kept > 0
