"""The ``Segment`` / ``Panoptic`` family against the JAX package (CPU): the
heads in eval and training, the mask and semantic losses with their
gradients, ``SegmentDataset`` (items, instance masks, the semantic id map,
the padded collate), ``res10-seg.yaml`` and ``res10-panoptic.yaml`` (spec,
strides, head bias prior, every leaf through the converter, a JAX orbax
checkpoint through ``import_orbax.py``), ``val.run`` / ``detect.run``
dropping the mask rows before NMS as JAX's ``val.run`` does, and a CPU
``train()`` epoch of each YAML.  Blocks the port still leaves out raise
``KeyError``.

Tolerances: heads and losses run in float64 on both sides and agree to
1e-9, but for the panoptic loss's semantic terms, which JAX takes in
float32 (``compute_loss_panoptic`` casts the logits): 1e-6 relative there.
The dataset is numpy and PIL on both sides and must be equal.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import import_orbax
from ecs_yolo_tpu import val as jax_val
from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu.data import dataset as JD
from ecs_yolo_tpu.models import yolo as jax_yolo
from ecs_yolo_tpu.nn import segment as JS
from ecs_yolo_tpu.utils import checkpoint as JCK
from ecs_yolo_tpu_torch import detect as port_detect
from ecs_yolo_tpu_torch import val as port_val
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.data import dataset as PD
from ecs_yolo_tpu_torch.models import convert as CV
from ecs_yolo_tpu_torch.models import yolo as port_yolo
from ecs_yolo_tpu_torch.nn import segment as PS
from ecs_yolo_tpu_torch.train import driver as PDR
from ecs_yolo_tpu_torch.utils import checkpoint as CK
from test_torch_port_heads import _FAST, _assert_tree_close, _jax_f64, _leaves
from test_torch_port_model import _x

torch.set_num_threads(2)

T = 2
NC = 3
STRIDES = (16.0, 32.0)
YAMLS = ["res10-seg.yaml", "res10-panoptic.yaml"]


# --- heads -------------------------------------------------------------------------

# nm 8 and a first level of 32 channels: every SiLU site (the mask towers,
# Proto, UConv) has C % 8 == 0, the fused ECS-LIF kernel's route, whose plain
# version is the exact T-loop (a C % 8 != 0 site takes the general-shape
# kernel's plain version, which sums as that kernel does, in float32)
HEADS = {
    "Segment": (lambda s: JS.Segment(NC, 8, 16, 16, STRIDES, snn=s),
                lambda ch, s: PS.Segment(NC, 8, 16, 16, STRIDES, ch, snn=s)),
    "Panoptic": (lambda s: JS.Panoptic(NC, 5, 8, 16, 16, STRIDES, snn=s),
                 lambda ch, s: PS.Panoptic(NC, 5, 8, 16, 16, STRIDES, ch, snn=s)),
}


def test_panoptic_head_matches_jax_f64_in_eval_and_training():
    """Two levels (4x4x32, 2x2x64): the eval output (decoded boxes and
    classes with the mask coefficients behind them, the maps, the
    coefficients, the prototypes at twice the first level's side, the
    semantic logits), the training output and the moved BN statistics.
    ``Panoptic`` holds a ``Segment`` as ``seg``: the case below holds a
    ``Segment`` of its own to that one."""
    jmod, pmod = HEADS["Panoptic"]
    xs = [_x((T, 2, 4, 4, 32), 21), _x((T, 2, 2, 2, 64), 22)]
    v, (want, (want_t, upd)) = _jax_f64(jmod(JaxSNNConfig(time_window=T)), xs, 23,
                                        training=True)
    head = pmod([32, 64], SNNConfig(time_window=T)).double()
    head.load_state_dict({k: t.double() for k, t in CV.convert_block(
        "Panoptic", v["params"], v["batch_stats"]).items()}, strict=True)
    x = [torch.from_numpy(a).double() for a in xs]
    with torch.no_grad():
        got = head.eval()(x)
    got_t = head.train()(x)
    _assert_tree_close(got, want)
    _assert_tree_close(got_t, want_t)
    assert got[0].shape == (2, 4 + NC + 8, 20)
    assert got_t[2].shape == (2, 8, 8, 8) and got_t[3].shape == (2, 8, 8, 5 + NC)
    sd = head.state_dict()
    for k, w in CV.convert_block("Panoptic", {}, upd["batch_stats"]).items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-12, rtol=0)


def test_segment_head_is_panoptic_s_seg():
    """A ``Segment`` with the weights of a ``Panoptic``'s ``seg`` gives its
    outputs bit for bit, in eval and training (JAX's ``Panoptic`` calls its
    ``Segment`` as its ``seg``; the case above holds that to JAX)."""
    snn = SNNConfig(time_window=T)
    pan = HEADS["Panoptic"][1]([32, 64], snn).double()
    seg = HEADS["Segment"][1]([32, 64], snn).double()
    seg.load_state_dict(pan.seg.state_dict(), strict=True)
    x = [torch.from_numpy(_x((T, 2, 4, 4, 32), 1)).double(),
         torch.from_numpy(_x((T, 2, 2, 2, 64), 2)).double()]
    for train in (False, True):
        want, got = pan.train(train)(x), seg.train(train)(x)
        assert all(torch.equal(a, b) for a, b in zip(_leaves(got), _leaves(want)[:len(
            _leaves(got))]))
        assert len(_leaves(want)) == len(_leaves(got)) + 1


# --- losses ------------------------------------------------------------------------

B, M, NM = 2, 3, 4
C_SEM = 5


def _loss_inputs():
    """float64 numpy inputs: per-level maps for 2x2 + 4x4 anchors at strides
    16 / 32 (a 64 px input), mask coefficients, 8x8 prototypes, targets with
    a padded row, instance masks at 8, 16 and 12 px (12: a ratio where
    ``F.interpolate``'s nearest picks other pixels than JAX's), semantic
    logits and a 12 px id map with background -1 and an id past the
    classes."""
    rng = np.random.RandomState(5)
    f = [rng.randn(B, 4 * 16 + NC, 4, 4), rng.randn(B, 4 * 16 + NC, 2, 2)]
    tg = np.zeros((B, M, 5))
    tg[:, :, 0] = rng.randint(0, NC, (B, M))
    tg[:, :, 1:3] = rng.uniform(0.3, 0.7, (B, M, 2))
    tg[:, :, 3:5] = rng.uniform(0.2, 0.5, (B, M, 2))
    tm = np.ones((B, M), bool)
    tm[1, 2] = False
    masks = {s: (rng.rand(B, M, s, s) > 0.5).astype(np.float64) for s in (8, 16, 12)}
    sem_gt = rng.randint(-1, C_SEM + 1, (B, 12, 12)).astype(np.int32)
    return dict(feats=f, mc=rng.randn(B, NM, 20), protos=rng.randn(B, 8, 8, NM),
                targets=tg, t_mask=tm, masks=masks, sem=rng.randn(B, 8, 8, C_SEM),
                sem_gt=sem_gt, fg=rng.rand(B, 20) > 0.4,
                gt_idx=rng.randint(0, M, (B, 20)),
                boxes=np.concatenate([rng.uniform(0, 30, (B, 20, 2)),
                                      rng.uniform(34, 64, (B, 20, 2))], -1),
                crop_masks=rng.rand(6, 8, 8), crop_boxes=rng.uniform(-1, 9, (6, 4)))


@pytest.fixture(scope="module")
def jax_losses():
    """Every loss of JAX's ``nn/segment.py`` on ``_loss_inputs``, values and
    gradients, in float64: one cheap-compile jit."""
    d = _loss_inputs()
    tg, tm = d["targets"], d["t_mask"]

    def run(feats, mc, protos, sem, masks, sem_gt):
        out = {"crop": JS.crop_mask(d["crop_masks"], d["crop_boxes"])}
        g = jax.value_and_grad(lambda mc_, pr_: JS.segment_mask_loss(
            mc_, pr_, d["fg"], d["gt_idx"], masks[8],
            d["boxes"], 16.0), argnums=(0, 1))
        out["mask"] = g(mc, protos)
        for s in (8, 16, 12):
            out[f"segment_{s}"] = jax.value_and_grad(
                lambda f_, mc_, pr_: JS.compute_loss_segment(
                    (f_, mc_, pr_), tg, tm, masks[s], STRIDES, NC, mask_gain=2.0),
                argnums=(0, 1, 2), has_aux=True)(feats, mc, protos)
        out["focal"] = jax.value_and_grad(
            lambda l_: JS.sigmoid_focal_loss(l_, (sem > 0.3) * 1.0).sum())(sem)
        out["semantic"] = jax.value_and_grad(
            lambda l_: sum(JS.semantic_loss(l_, sem_gt)), has_aux=False)(sem)
        out["semantic_terms"] = JS.semantic_loss(sem, sem_gt)
        out["panoptic"] = jax.value_and_grad(
            lambda f_, mc_, pr_, s_: JS.compute_loss_panoptic(
                (f_, mc_, pr_, s_), tg, tm, masks[16], sem_gt, STRIDES, NC),
            argnums=(0, 1, 2, 3), has_aux=True)(feats, mc, protos, sem)
        return out

    with jax.enable_x64():
        return d, jax.jit(run, compiler_options=_FAST)(
            d["feats"], d["mc"], d["protos"], d["sem"], d["masks"], d["sem_gt"])


def _t(a, grad=True):
    t = torch.from_numpy(np.asarray(a))
    return t.requires_grad_() if grad and t.is_floating_point() else t


def _close(got, want, tol=1e-9):
    for a, b in zip(_leaves(got), _leaves(want)):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_allclose(a, np.asarray(b), atol=tol, rtol=tol)


LOSSES = ["crop", "mask", "segment_8", "segment_16", "segment_12", "focal", "semantic",
          "panoptic"]


@pytest.mark.parametrize("case", LOSSES)
def test_loss_and_gradients_match_jax_f64(jax_losses, case):
    d, want = jax_losses
    f, mc, pr, sem = [_t(a) for a in d["feats"]], _t(d["mc"]), _t(d["protos"]), _t(d["sem"])
    tg, tm = _t(d["targets"], False), _t(d["t_mask"], False)
    sem_gt = _t(d["sem_gt"], False)
    if case == "crop":
        _close(PS.crop_mask(_t(d["crop_masks"]), _t(d["crop_boxes"])), want["crop"])
    elif case == "mask":
        loss = PS.segment_mask_loss(mc, pr, _t(d["fg"], False), _t(d["gt_idx"], False),
                                    _t(d["masks"][8], False), _t(d["boxes"], False), 16.0)
        _close((loss, torch.autograd.grad(loss, (mc, pr))), want["mask"])
    elif case.startswith("segment"):
        s = int(case.split("_")[1])
        total, items = PS.compute_loss_segment((f, mc, pr), tg, tm, _t(d["masks"][s], False),
                                               STRIDES, NC, mask_gain=2.0)
        grads = torch.autograd.grad(total, (*f, mc, pr))
        _close(((total, items), grads), want[case])
        assert float(items[1]) > 0
    elif case == "focal":
        loss = PS.sigmoid_focal_loss(sem, (sem.detach() > 0.3) * 1.0).sum()
        _close((loss, torch.autograd.grad(loss, sem)), want["focal"])
    elif case == "semantic":
        terms = PS.semantic_loss(sem, sem_gt)
        loss = sum(terms)
        _close((loss, torch.autograd.grad(loss, sem)), want["semantic"])
        _close(terms, want["semantic_terms"])
    else:
        (total, items), grads = PS.compute_loss_panoptic(
            (f, mc, pr, sem), tg, tm, _t(d["masks"][16], False), sem_gt, STRIDES, NC), None
        grads = torch.autograd.grad(total, (*f, mc, pr, sem))
        (w_total, w_items), w_grads = want["panoptic"]
        _close((items[:4], grads[:4]), (w_items[:4], w_grads[:3]))
        # the semantic terms: float32 on both sides (JAX casts the logits)
        _close((total, items[4:], grads[4]), (w_total, w_items[4:], w_grads[3]), tol=1e-6)


def test_nearest_resize_is_jax_s():
    x = np.random.RandomState(1).rand(2, 3, 12, 7)
    for hw in ((8, 5), (12, 14), (5, 21), (12, 7)):
        want = jax.image.resize(jnp.asarray(x, jnp.float32), (2, 3) + hw, "nearest")
        got = PS.resize_nearest(torch.from_numpy(x).float(), hw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ids = np.random.RandomState(2).randint(-1, 9, (2, 12, 12)).astype(np.int32)
    want = jax.image.resize(jnp.asarray(ids), (2, 8, 8), "nearest")
    np.testing.assert_array_equal(PS.resize_nearest(torch.from_numpy(ids), (8, 8)).numpy(),
                                  np.asarray(want))


# --- SegmentDataset ----------------------------------------------------------------

SIZES = [(48, 80), (64, 64), (100, 37)]


def write_seg_split(root, sizes=SIZES, seed=0, nc=NC, stuff=True):
    """``root/images/<n>.png`` + YOLO-seg polygon labels (2-3 polygons of
    3-6 points each, one short row that the reader skips) + for all but the
    last image ``stuff/<n>.txt`` stuff polygons of classes ``nc..nc+2``."""
    rng = np.random.RandomState(seed)
    for sub in ("images", "labels", "stuff"):
        (root / sub).mkdir(parents=True)
    for i, (h, w) in enumerate(sizes):
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            root / "images" / f"{i + 1}.png")

        def polys(n, classes):
            rows = []
            for _ in range(n):
                k = rng.randint(3, 7)
                c = rng.uniform(0.25, 0.75, 2)
                ang = np.sort(rng.uniform(0, 2 * np.pi, k))
                r = rng.uniform(0.08, 0.25, k)
                pts = np.clip(c + np.stack([np.cos(ang), np.sin(ang)], 1) * r[:, None], 0, 1)
                rows.append(" ".join([str(rng.randint(*classes))]
                                     + [f"{v:.5f}" for v in pts.ravel()]))
            return rows
        lab = polys(rng.randint(2, 4), (0, nc)) + ["1 0.5 0.5 0.6 0.6"]
        (root / "labels" / f"{i + 1}.txt").write_text("\n".join(lab) + "\n")
        if stuff and i < len(sizes) - 1:
            (root / "stuff" / f"{i + 1}.txt").write_text(
                "\n".join(polys(2, (nc, nc + 3))) + "\n")
    return root / "images"


DATASETS = {
    "masks": dict(),
    "semantic": dict(semantic=True),
    "no_masks": dict(include_masks=False, semantic=True),
    "single_cls": dict(single_cls=True, semantic=True),
}


@pytest.mark.parametrize("mode", sorted(DATASETS))
def test_segment_dataset_items_and_collate_match_jax(mode, tmp_path):
    """``augment=False``: every item (the image, labels, mask, the instance
    masks at a quarter of the canvas, the id map with stuff first and
    background -1) and the batches of 2 over 3 images with the tail padded
    (masks with 0, the id map with -1)."""
    src = write_seg_split(tmp_path / "s")
    kw = dict(img_size=64, augment=False, max_labels=4, **DATASETS[mode])
    jd, pd = JD.SegmentDataset(src, **kw), PD.SegmentDataset(src, **kw)
    assert pd.hyp["mosaic"] == pd.hyp["fliplr"] == 0.0
    for i in range(len(jd)):
        got, want = pd[i], jd[i]
        assert len(got) == len(want) == {"masks": 4, "no_masks": 3}.get(mode, 5)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    got = pd[0]                     # an image with stuff polygons
    if len(got) > 3:
        assert got[3].shape == (4, 16, 16) and got[3].any()
    if len(got) == 5:
        assert (got[4] == -1).any() and (got[4] >= NC).any()
    bk = dict(drop_last=False, yield_count=True)
    got, want = list(pd.batches(2, **bk)), list(jd.batches(2, **bk))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    if mode != "no_masks":
        with pytest.raises(ValueError, match="quad"):
            next(pd.batches(4, quad=True))
    assert PD.img2stuff_path(str(src / "1.png")) == JD.img2stuff_path(str(src / "1.png"))


# --- the two YAMLs -----------------------------------------------------------------


def _narrow(cfg):
    d = port_yolo.load_cfg(cfg)
    d["width_multiple"] = 0.25
    return d


@pytest.mark.parametrize("cfg", YAMLS)
def test_yaml_matches_jax(cfg, tmp_path):
    """A narrowed YAML in both packages: the parsed spec; JAX's head traced
    once, abstractly, at the inputs the port's stride probe hands it (the
    port's model on the meta device; the backbone is res10's, held to JAX
    block by block in test_torch_port_model), its strides taken from that
    training output as JAX's ``build_model`` takes them; seeded head
    variables through the converter (strict load: every leaf placed); the
    head bias prior on ``Segment``'s towers (``Panoptic``'s ``seg``).
    ``res10-seg``: the head's variables written as a JAX training
    checkpoint (``save_checkpoint``) and imported by ``import_orbax.py`` are
    the in-memory conversion's, and load into the port's head."""
    from test_torch_port_model import _random_variables

    d = _narrow(cfg)
    snn = JaxSNNConfig(time_window=T)
    spec, save, _, head = jax_yolo.parse_model(dict(d, nc=NC), 3)
    name, idx = head["name"], head["index"]
    probe = port_yolo.build_model(d, nc=NC, snn=SNNConfig(time_window=T), device="meta")
    shapes = []
    probe.model[idx].register_forward_pre_hook(
        lambda m, a: shapes.extend(tuple(x.shape) for x in a[0]))
    with torch.no_grad():
        probe(torch.zeros(1, 256, 256, 3, device="meta"))
    args = jax_yolo._with_head_args(spec, idx, name, head, None, probe=True)[idx][3]
    jhead, got_out = jax_yolo.HEADS[name](*args, snn=snn), {}

    def init():
        out, variables = jhead.init_with_output(
            jax.random.PRNGKey(0), [jnp.zeros(s) for s in shapes], training=True)
        got_out["o"] = out
        return variables

    v = _random_variables(init, 13)
    strides = tuple(float(256 // h) for h, _ in jax_yolo._head_feat_shapes(got_out["o"], name))
    head["strides"] = strides
    final = jax_yolo._with_head_args(spec, idx, name, head, strides)
    jm = jax_yolo.BuiltModel(None, dict(d, nc=NC), final, save, head, strides, snn)
    layer = f"layers_{idx}"
    v = {k: {layer: t} for k, t in v.items()}

    pm = port_yolo.build_model(d, nc=NC, snn=SNNConfig(time_window=T), device="cpu")
    assert pm.spec == final and pm.head_info["strides"] == strides == STRIDES
    ref = CV.convert(v["params"], v["batch_stats"], pm.spec)
    pm.model[idx].load_state_dict({k[len(f"model.{idx}."):]: t for k, t in ref.items()},
                                  strict=True)
    port_yolo.init_head_biases(pm)
    want = CV.convert(jax_yolo.init_head_biases(
        jm, {"params": jax.tree_util.tree_map(jnp.asarray, v["params"])})["params"],
        None, pm.spec)
    sd = pm.state_dict()
    assert len([k for k in want if not torch.equal(want[k], ref[k])]) == 2 * 2
    for k, w in want.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-6, rtol=0, err_msg=k)

    if cfg == "res10-seg.yaml":
        state = types.SimpleNamespace(params=v["params"], batch_stats=v["batch_stats"],
                                      ema_params=v["params"], step=1,
                                      opt_state={"count": np.int32(1)})
        JCK.save_checkpoint(tmp_path / "last", state, jm.cfg, epoch=0, best_fitness=0.0)
        tree, meta = CK.load_checkpoint(import_orbax.import_checkpoint(
            tmp_path / "last", tmp_path / "seg.pt"))
        assert meta["model_cfg"]["head"][-1][2] == "Segment"
        assert tree["model"].keys() == ref.keys()
        assert all(torch.equal(tree["model"][k], ref[k]) for k in ref)


def test_unported_blocks_still_raise_keyerror():
    """No block of JAX's registry is unported since item 11g-3: a
    ``HetConv`` row in the segment model builds; a name in neither registry
    raises ``KeyError`` in both parsers."""
    d = _narrow("res10-seg.yaml")
    d["head"][5] = [-1, 1, "HetConv", [64]]
    model = port_yolo.build_model(d, nc=NC, device="meta")
    assert type(model.model[len(d["backbone"]) + 5]) is port_yolo.C2_BLOCKS["HetConv"]
    d["head"][5] = [-1, 1, "NoSuchBlock", [64]]
    for parse in (port_yolo.parse_model, jax_yolo.parse_model):
        with pytest.raises(KeyError, match="NoSuchBlock"):
            parse(dict(d), 3)


# --- served through val.run and detect.run -----------------------------------------


def test_val_and_detect_drop_the_mask_rows_as_jax_val_does(tmp_path, monkeypatch):
    """NMS sees the first ``4 + nc`` rows of the head's decoded output in
    ``val.run`` and ``detect.run``; JAX's ``val.run`` handed the whole output
    (mask coefficients included, its exported-model branch) drops the same
    rows and scores the same metrics."""
    pm = port_yolo.build_model(_narrow("res10-seg.yaml"), nc=NC,
                               snn=SNNConfig(time_window=T), device="cpu")
    head, full, calls = pm.model[-1], [], []
    head.register_forward_hook(lambda m, a, o: full.append(o[0].numpy().copy()))
    real = {mod: mod.non_max_suppression for mod in (port_val, port_detect)}
    for mod in real:
        monkeypatch.setattr(mod, "non_max_suppression", lambda pred, _r=real[mod], **kw: (
            calls.append(pred.clone()), _r(pred, **kw))[1])
    src = write_seg_split(tmp_path / "s")
    kw = dict(imgsz=64, batch_size=2, conf_thres=0.01, iou_thres=0.5)
    sets = [mod.SegmentDataset(src, img_size=64, max_labels=8, include_masks=False)
            for mod in (PD, JD)]
    got = port_val.run(pm, None, dataset=sets[0], workers=0, **kw)
    port_detect.run(pm, src, imgsz=64, conf_thres=0.05)
    assert len(calls) == len(full) == 2 + 3
    for pred, y in zip(calls, full):
        assert y.shape[1] == 4 + NC + 32
        np.testing.assert_array_equal(pred.numpy(), y[:, :4 + NC])
    fed = iter(full[:2])
    fake = types.SimpleNamespace(head_name="Segment", nc=NC, predict=lambda im: next(fed))
    want = jax_val.run(fake, None, None, dataset=sets[1], workers=0, **kw)
    for k in ("mp", "mr", "map50", "map", "fitness"):
        assert got[k] == pytest.approx(want[k], abs=1e-12), k


# --- train() -----------------------------------------------------------------------


@pytest.mark.parametrize("cfg", YAMLS)
def test_train_runs_an_epoch_on_the_cpu(cfg, tmp_path, monkeypatch):
    """One epoch of the narrowed YAML over 4 polygon-labelled images (batch
    2): the step takes the masks (and the id map), the logged losses are
    (box, mask, cls), the val pass reads the set without masks."""
    src = write_seg_split(tmp_path / "s", sizes=SIZES + [(70, 60)])
    steps = []
    real = PDR.make_train_step
    monkeypatch.setattr(PDR, "make_train_step", lambda *a, **k: (steps.append(k),
                                                                  real(*a, **k))[1])
    _, _, hist = PDR.train(_narrow(cfg), src, src, nc=NC, epochs=1, batch_size=2,
                           imgsz=64, nbs=2, workers=0, quad=True, device_augment=True,
                           loggers_include=("csv",), device="cpu",
                           save_dir=str(tmp_path / "r"))
    k = steps[0]
    assert k["with_masks"] and k["with_semantic"] == (cfg == "res10-panoptic.yaml")
    h = hist[0]
    assert h["micro_steps"] == 2 and h["loss_finite"] and h["mloss"][1] > 0
    assert h["seen"] == 4


# --- the smoke script's site tables ------------------------------------------------


@pytest.mark.parametrize("cfg", ["res10-seg.yaml", "res10-panoptic.yaml", "events"])
def test_smoke_site_tables_come_from_the_model(cfg):
    """``chip_smoke.SEG_SITES`` (640 px, T=4) and ``EVENT_SITES`` (res10 at
    320 px on a 5-D batch, T=5): the neuron sites of a hooked full-width
    forward on the meta device, and the launches of the fused spread product
    and of the depthwise kernel in a training forward (T-1 a site off the
    SiLU sites, by ``spread_route``)."""
    import chip_smoke
    from ecs_yolo_tpu_torch.nn.blocks import MemUpdate
    from ecs_yolo_tpu_torch.snn import spread as S

    if cfg == "events":
        t, want = chip_smoke.EVENT_T, chip_smoke.EVENT_SITES
        model = port_yolo.build_model("resnet10.yaml", nc=chip_smoke.EVENT_NC,
                                      snn=SNNConfig(time_window=t), device="meta")
        x = torch.zeros(1, t, chip_smoke.EVENT_IMGSZ, chip_smoke.EVENT_IMGSZ, 3,
                        device="meta")
    else:
        t, want = chip_smoke.T, chip_smoke.SEG_SITES[cfg]
        model = port_yolo.build_model(cfg, nc=chip_smoke.NC, device="meta")
        x = torch.zeros(1, chip_smoke.IMGSZ, chip_smoke.IMGSZ, 3, device="meta")
    seen = []
    for m in model.modules():
        if isinstance(m, MemUpdate):
            m.register_forward_pre_hook(lambda m, a: seen.append((tuple(a[0].shape), m.act)))
    with torch.no_grad():
        model(x)
    route = {"gemm": 0, "dw3": 0}
    for (steps, _, h, w, c), act in seen:
        assert steps == t
        if not act:
            route[S.spread_route(c, w)] += t - 1
    assert (len(seen), route["gemm"], route["dw3"]) == want
