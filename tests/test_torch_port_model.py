"""The port's blocks and whole models against the JAX package (CPU), with the
weights carried across by ``ecs_yolo_tpu_torch.models.convert``.

Blocks run in float64 on both sides (JAX inside the scoped
``jax.enable_x64()``): no membrane then lands within rounding of the
threshold, so every spike agrees and the outputs agree to 1e-9.

Whole models run in float32, as they are served.  Tolerance atol/rtol 1e-4
on the decoded boxes: the two frameworks' convolutions sum in different
orders, which moves values by a few ulps; at these seeds no spike flips,
and a flip would show as an O(1) error.  NMS then sees the same candidates
and must keep the same boxes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu.models import yolo as jax_yolo
from ecs_yolo_tpu.models.torch_import import build_mapping
from ecs_yolo_tpu.nn import blocks as JB
from ecs_yolo_tpu.nn import heads as JH
from ecs_yolo_tpu.ops.nms import non_max_suppression as jax_nms
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.models import convert as CV
from ecs_yolo_tpu_torch.models import yolo as port_yolo
from ecs_yolo_tpu_torch.nn import blocks as PB
from ecs_yolo_tpu_torch.nn import heads as PH
from ecs_yolo_tpu_torch.ops.nms import non_max_suppression as port_nms

torch.set_num_threads(2)

T = 2


def _random_variables(init_fn, seed):
    """Seeded numpy values in the shape of ``init_fn()``'s variables, found
    with ``jax.eval_shape`` (no init compile): kernels U(+-1/sqrt(fan_in))
    as torch's default init, biases U(+-0.2), and random BN affine and
    running statistics so that eval BN is exercised in full."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf in ("kernel", "w", "spread_dw_kernel", "spread_pw_kernel"):
            b = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            v = rng.uniform(-b, b, s.shape)
        elif leaf in ("scale", "var"):
            v = rng.rand(*s.shape) + 0.5
        elif leaf == "mean":
            v = rng.randn(*s.shape) * 0.2
        else:
            v = (rng.rand(*s.shape) - 0.5) * 0.4
        return v.astype(np.float32)

    shapes = jax.eval_shape(init_fn)
    return jax.tree_util.tree_map_with_path(
        fill, {k: shapes[k] for k in ("params", "batch_stats") if k in shapes})


def _jax_block_f64(module, x, seed, *, tensors_in_list=False):
    """Random variables for ``module`` on ``x``, applied in float64; returns
    (variables as numpy f32, output as numpy f64)."""
    xs = [jnp.asarray(a, jnp.float32) for a in x] if tensors_in_list \
        else jnp.asarray(x, jnp.float32)
    v = _random_variables(
        lambda: module.init(jax.random.PRNGKey(0), xs, training=False), seed)
    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        xs64 = [jnp.asarray(a, jnp.float64) for a in x] if tensors_in_list \
            else jnp.asarray(x, jnp.float64)
        out = module.apply(v64, xs64, training=False)
        out = jax.tree_util.tree_map(np.asarray, out)
    return v, out


def _port_block_f64(block, name, v, x):
    sd = CV.convert_block(name, v["params"], v.get("batch_stats"))
    block = block.double().eval()
    block.load_state_dict({k: t.double() for k, t in sd.items()}, strict=True)
    with torch.no_grad():
        if isinstance(x, list):
            return block([torch.from_numpy(a).double() for a in x])
        return block(torch.from_numpy(x).double())


def _x(shape, seed):
    return (np.random.RandomState(seed).randn(*shape) * 0.8).astype(np.float32)


BLOCKS = [
    # (name, jax module, port module, input shape [T,N,H,W,C])
    ("Conv_1", lambda: JB.Conv_1(8, 7, 2), lambda: PB.Conv_1(3, 8, 7, 2),
     (T, 2, 16, 16, 3)),
    ("BasicBlock_2", lambda: JB.BasicBlock_2(16, 3, 2),
     lambda: PB.BasicBlock_2(8, 16, 3, 2), (T, 2, 16, 16, 8)),
    ("BasicBlock_2", lambda: JB.BasicBlock_2(8, 3, 1),
     lambda: PB.BasicBlock_2(8, 8, 3, 1), (T, 2, 8, 8, 8)),
    ("BasicBlock_2", lambda: JB.BasicBlock_2(8, 1, 1),
     lambda: PB.BasicBlock_2(16, 8, 1, 1), (T, 2, 8, 8, 16)),
    ("Concat_res2", lambda: JB.Concat_res2(16, 3, 2),
     lambda: PB.Concat_res2(8, 16, 3, 2), (T, 2, 16, 16, 8)),
    ("BasicBlock_1", lambda: JB.BasicBlock_1(16, 1),
     lambda: PB.BasicBlock_1(8, 16, 1), (T, 1, 4, 4, 8)),
]


@pytest.mark.parametrize("name,jax_mod,port_mod,shape", BLOCKS,
                         ids=["Conv_1", "BasicBlock_2-s2", "BasicBlock_2-s1",
                              "BasicBlock_2-k1", "Concat_res2", "BasicBlock_1"])
def test_block_matches_jax_f64(name, jax_mod, port_mod, shape):
    x = _x(shape, seed=len(name))
    v, want = _jax_block_f64(jax_mod(), x, seed=1)
    got = _port_block_f64(port_mod(), name, v, x).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=1e-9)


def test_batch_norm_training_moments_match_jax_f64():
    """Training-mode BN (batch moments over T,N,H,W, biased variance,
    running update with momentum 0.1 = the JAX 0.9 decay)."""
    x = _x((T, 2, 6, 6, 8), seed=9)
    mod = JB.TBatchNorm(0.2)
    v = _random_variables(
        lambda: mod.init(jax.random.PRNGKey(0), jnp.asarray(x), training=False), 4)
    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        want, upd = mod.apply(v64, jnp.asarray(x, jnp.float64), training=True,
                              mutable=["batch_stats"])
    bn = PB.TBatchNorm(8, 0.2).double().train()
    p, st = v["params"]["bn"], v["batch_stats"]["bn"]
    with torch.no_grad():
        for name, a in (("weight", p["scale"]), ("bias", p["bias"]),
                        ("running_mean", st["mean"]), ("running_var", st["var"])):
            getattr(bn.bn, name).copy_(torch.from_numpy(np.asarray(a)))
        got = bn(torch.from_numpy(x).double())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn.bn, name).numpy(),
                                   np.asarray(upd["batch_stats"]["bn"][key]),
                                   atol=1e-12)


def test_detect_head_matches_jax_f64():
    anchors = ((0.625, 0.875, 1.4375, 1.6875, 2.3125, 3.625),
               (2.53125, 2.5625, 4.21875, 5.28125, 10.75, 9.96875))
    strides = (16.0, 32.0)
    xs = [_x((T, 2, 4, 4, 16), 3), _x((T, 2, 2, 2, 32), 4)]
    v, (z, feats) = _jax_block_f64(JH.Detect(2, anchors, strides), xs, seed=2,
                                   tensors_in_list=True)
    gz, gfeats = _port_block_f64(
        PH.Detect(2, anchors, strides, [16, 32], SNNConfig(time_window=T)),
        "Detect", v, xs)
    np.testing.assert_allclose(gz.numpy(), z, atol=1e-9, rtol=1e-9)
    for a, b in zip(gfeats, feats):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-9, rtol=1e-9)


def _narrow(cfg):
    d = port_yolo.load_cfg(cfg)
    d["width_multiple"] = 0.25
    return d


@pytest.fixture(scope="module", params=["resnet10.yaml", "resnet34.yaml"])
def pair(request):
    """(jax model, jax variables, port model with converted weights)."""
    d = _narrow(request.param)
    jm = jax_yolo.build_model(d, nc=2, snn=JaxSNNConfig(time_window=T))
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    v = _random_variables(
        lambda: jm.module.init(jax.random.PRNGKey(0), x, training=False), 7)
    pm = port_yolo.build_model(d, nc=2, snn=SNNConfig(time_window=T),
                               device="cpu")
    pm.load_state_dict(CV.convert(v["params"], v["batch_stats"], pm.spec),
                       strict=True)
    return jm, v, pm


def test_parsed_spec_and_strides_match_jax(pair):
    jm, _, pm = pair
    assert pm.spec == jm.spec
    assert pm.head_info["strides"] == jm.strides


def test_model_decode_and_nms_match_jax_fp32(pair):
    jm, v, pm = pair
    x = np.random.RandomState(11).rand(2, 64, 64, 3).astype(np.float32)
    jz, jfeats = jax.jit(lambda v, x: jm.apply(v, x, training=False))(
        v, jnp.asarray(x))
    with torch.no_grad():
        pz, pfeats = pm(torch.from_numpy(x))
    np.testing.assert_allclose(pz.numpy(), np.asarray(jz), atol=1e-4, rtol=1e-4)
    for a, b in zip(pfeats, jfeats):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)
    # a low threshold keeps many overlapping candidates in play
    jo, jv = jax_nms(jz, conf_thres=0.05, iou_thres=0.45, max_det=50)
    po, pv = port_nms(pz, conf_thres=0.05, iou_thres=0.45, max_det=50)
    assert np.asarray(jv).sum() > 0
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-3, rtol=1e-4)


def test_converter_names_agree_with_the_reference_import_map():
    """For rows without repeats, the port's state_dict names are exactly the
    torch names ``ecs_yolo_tpu/models/torch_import.py`` maps."""
    d = _narrow("resnet10.yaml")
    pm = port_yolo.build_model(d, nc=2, snn=SNNConfig(time_window=T),
                               device="cpu")
    assert set(pm.state_dict()) == set(build_mapping(pm.spec))


def test_nms_matches_jax_on_clustered_boxes():
    rng = np.random.RandomState(3)
    n, nc = 400, 3
    centers = rng.rand(12, 2) * 200
    xy = centers[rng.randint(0, 12, n)] + rng.randn(n, 2) * 6
    wh = 20 + rng.rand(n, 2) * 30
    obj = rng.rand(n, 1)
    cls = rng.rand(n, nc)
    cls[rng.rand(n) < 0.1] = cls[0]           # exact score ties
    pred = np.concatenate([xy, wh, obj, cls], -1)[None].astype(np.float32)
    pred = np.concatenate([pred, pred[:, ::-1]], 0)
    dfl = np.concatenate([pred[..., :4], pred[..., 5:]], -1).transpose(0, 2, 1)
    for p, has_obj, agnostic in ((pred, True, False), (pred, True, True),
                                 (dfl, False, False)):
        kw = dict(conf_thres=0.2, iou_thres=0.45, max_det=30,
                  agnostic=agnostic, has_obj=has_obj)
        jo, jv = jax_nms(jnp.asarray(p), **kw)
        po, pv = port_nms(torch.from_numpy(np.ascontiguousarray(p)), **kw)
        assert np.asarray(jv).sum() > 0
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-4)


def _random_pred(rng, a=200, nc=7, batch=2):
    """Random v1 predictions [B, A, 5+nc], as tests/test_nms.py:random_pred."""
    xy = rng.rand(batch, a, 2) * 600 + 20
    wh = rng.rand(batch, a, 2) * 100 + 5
    obj = rng.rand(batch, a, 1)
    cls = rng.rand(batch, a, nc)
    return np.concatenate([xy, wh, obj, cls], -1).astype(np.float32)


def _clustered_pred(seed, n=300, nc=3):
    """Boxes scattered round a few centres, so that many overlap."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(12, 2) * 300 + 40
    xy = centers[rng.randint(0, 12, n)] + rng.randn(n, 2) * 5
    wh = 30 + rng.rand(n, 2) * 20
    return np.concatenate([xy, wh, rng.rand(n, 1), rng.rand(n, nc)],
                          -1)[None].astype(np.float32)


def _zero_area_pred():
    pred = np.zeros((1, 3, 5 + 2), dtype=np.float32)
    pred[0, 0, :4] = [100, 100, 0, 0]
    pred[0, 0, 4:6] = [1.0, 0.95]
    pred[0, 1, :4] = [300, 300, 40, 40]
    pred[0, 1, 4], pred[0, 1, 6] = 1.0, 0.9
    return pred


def _twin_boxes_pred():
    pred = np.zeros((1, 2, 5 + 3), dtype=np.float32)
    pred[0, :, :4] = [100, 100, 50, 50]
    pred[0, :, 4] = 1.0
    pred[0, 0, 5], pred[0, 1, 6] = 0.9, 0.8
    return pred


def _dfl_pred():
    rng = np.random.RandomState(2)
    return np.concatenate([rng.rand(1, 2, 100) * 600 + 20,
                           rng.rand(1, 2, 100) * 80 + 5,
                           rng.rand(1, 4, 100)], axis=1).astype(np.float32)


# the inputs and options of tests/test_nms.py:TestNMS, and the val settings
NMS_CASES = {
    "single_label": (lambda: _random_pred(np.random.RandomState(0)),
                     dict(conf_thres=0.25, iou_thres=0.45, max_det=20)),
    "multi_label": (lambda: _random_pred(np.random.RandomState(0)),
                    dict(conf_thres=0.25, iou_thres=0.45, max_det=20,
                         multi_label=True)),
    "multi_label_val_settings": (
        lambda: _random_pred(np.random.RandomState(6), a=300, nc=5),
        dict(conf_thres=0.001, iou_thres=0.6, max_det=300, multi_label=True)),
    "multi_label_pool_cut": (
        lambda: _random_pred(np.random.RandomState(7), a=150, nc=4),
        dict(conf_thres=0.01, iou_thres=0.6, max_det=30, multi_label=True,
             max_nms=200)),
    "multi_label_agnostic": (
        lambda: _random_pred(np.random.RandomState(8), a=150, nc=4),
        dict(conf_thres=0.2, iou_thres=0.5, max_det=30, multi_label=True,
             agnostic=True)),
    "multi_label_one_class": (
        lambda: _random_pred(np.random.RandomState(9), a=150, nc=1),
        dict(conf_thres=0.2, iou_thres=0.5, max_det=30, multi_label=True)),
    "padded_rows": (lambda: _random_pred(np.random.RandomState(1), a=50),
                    dict(conf_thres=0.9, max_det=20)),
    "zero_area": (_zero_area_pred, dict(max_det=20)),
    "zero_area_multi_label": (_zero_area_pred,
                              dict(max_det=20, multi_label=True)),
    "merge": (lambda: _clustered_pred(3),
              dict(conf_thres=0.25, iou_thres=0.5, max_det=20, merge=True)),
    "merge_sparse_boxes_all_dropped": (
        lambda: _random_pred(np.random.RandomState(3), a=120, nc=3),
        dict(conf_thres=0.25, iou_thres=0.5, max_det=20, merge=True)),
    "merge_not_redundant": (
        lambda: _random_pred(np.random.RandomState(3), a=120, nc=3),
        dict(conf_thres=0.25, iou_thres=0.5, max_det=20, merge=True,
             redundant=False)),
    "merge_multi_label": (
        lambda: _clustered_pred(4),
        dict(conf_thres=0.25, iou_thres=0.5, max_det=20, merge=True,
             multi_label=True)),
    "twin_boxes": (_twin_boxes_pred, dict(agnostic=False, max_det=20)),
    "twin_boxes_agnostic": (_twin_boxes_pred, dict(agnostic=True, max_det=20)),
    "dfl_layout": (_dfl_pred, dict(has_obj=False, conf_thres=0.5, max_det=20)),
    "dfl_layout_multi_label": (_dfl_pred, dict(has_obj=False, conf_thres=0.5,
                                               max_det=20, multi_label=True)),
}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_nms_options_match_jax(case):
    """``valid`` equal and ``out`` to atol 1e-4 (float32: the merged boxes'
    weighted sums run in another order)."""
    make, kw = NMS_CASES[case]
    pred = make()
    jo, jv = jax_nms(jnp.asarray(pred), **kw)
    po, pv = port_nms(torch.from_numpy(pred), **kw)
    jo, jv = np.asarray(jo), np.asarray(jv)
    assert po.dtype == torch.float32 and tuple(po.shape) == jo.shape
    np.testing.assert_array_equal(pv.numpy(), jv)
    np.testing.assert_allclose(po.numpy(), jo, atol=1e-4, rtol=1e-5)
    assert (po.numpy()[~pv.numpy()] == 0).all()
    if case not in ("padded_rows", "merge_sparse_boxes_all_dropped"):
        assert jv.sum() > 0
    if case == "twin_boxes":
        assert int(pv.sum()) == 2
    if case == "twin_boxes_agnostic":
        assert int(pv.sum()) == 1
    if case.startswith("zero_area"):
        assert int(pv.sum()) == 2


def test_nms_all_zero_prediction_has_no_valid_rows():
    """An all-zero prediction passes no confidence threshold under
    ``multi_label``, ``merge`` and ``redundant``: no valid row, all-zero out."""
    pred = torch.zeros(1, 4, 7)
    for kw in ({"multi_label": True}, {"merge": True},
               {"merge": True, "redundant": False}):
        out, valid = port_nms(pred, **kw)
        assert not valid.any() and not out.any()


def test_build_model_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_yolo.build_model(_narrow("resnet10.yaml"), nc=2)
    m = port_yolo.build_model(_narrow("resnet10.yaml"), nc=2, device="cpu")
    assert next(m.parameters()).device.type == "cpu"
