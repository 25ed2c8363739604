"""The registry rows of ROADMAP Queue 1 item 11g-2 against the JAX package
(CPU): the rest of ``nn/blocks_tail.py`` (``Bottleneck_1``-``_4``,
``BasicBlock_3``-``_5``, ``PartialConv``, ``FasterNetBlock``,
``Concat_res3``-``_6``, ``ScConv``, ``CoT``, ``DualConv``, ``MobileNetV3``,
``ContextGuideFusionModulev2``, ``TransformerBlock``, ``C3TR``) and the
``AKConv`` of ``nn/blocks_tail2.py`` that ``Concat_res5`` calls, each in
eval and in training with the moved BN statistics; each block's JAX
variables through ``models/convert.py`` with ``strict=True``; the conv/bn
pairs ``fuse_conv_bn`` folds against JAX's walk.  Gradients against
``jax.grad``: ``AKConv`` with random offsets and at JAX's zero offset
weights (every sample on the grid, the clip's ties at the border),
``ScConv`` (its gate takes no gradient to ``gn_gamma``), ``TransformerBlock``
(``pos``), ``Concat_res3`` (``SELayerInner``).  A small model that feeds a
``Bottleneck_2`` (recorded c2 wide by the parser, ``c2 * e`` wide in the
tensors) into a ``Concat`` and a ``BasicBlock_5``, whole, against JAX.

The registry: every name this slice registers parses as in JAX's
``parse_model`` and is a row of ``chip_smoke.PROBES["probe-tail"]``, where
the port builds it; the port's registries hold JAX's names; every neuron
site of that probe takes the tensor-core kernel's layout;
``TransformerBlock`` serves only the map it was built for.

Tolerances: float64 on both sides, 1e-9 (eval, where the port's neuron
sites take their kernels' plain versions, training, and the gradients).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu.models import yolo as jax_yolo
from ecs_yolo_tpu.nn import blocks_tail as JBT
from ecs_yolo_tpu.nn import blocks_tail2 as JBT2
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.models import convert as CV
from ecs_yolo_tpu_torch.models import utils as PMU
from ecs_yolo_tpu_torch.models import yolo as port_yolo
from ecs_yolo_tpu_torch.nn import blocks as PB
from ecs_yolo_tpu_torch.nn import blocks_ext as PBX
from ecs_yolo_tpu_torch.nn import blocks_tail as PBT
from ecs_yolo_tpu_torch.nn import blocks_tail2 as PBT2
from ecs_yolo_tpu_torch.snn import ecs_lif as K
from test_torch_port_blocks_csp import _folded_in_jax, _inputs, _torch
from test_torch_port_heads import _FAST, _assert_tree_close, _jax_f64, _leaves
from test_torch_port_model import _random_variables, _x

torch.set_num_threads(2)

T = 2
JSNN = JaxSNNConfig(time_window=T)
SNN = SNNConfig(time_window=T)

# case -> (registry name for the converter, JAX block, port block, input
# shape(s) [T, N, H, W, C])
BLOCKS = {
    "Bottleneck_1-s2": ("Bottleneck_1", lambda: JBT.Bottleneck_1(16, 2, snn=JSNN),
                        lambda: PBT.Bottleneck_1(8, 16, 2, snn=SNN), (T, 2, 4, 4, 8)),
    "Bottleneck_2-s2": ("Bottleneck_2", lambda: JBT.Bottleneck_2(8, 3, 2, snn=JSNN),
                        lambda: PBT.Bottleneck_2(8, 8, 3, 2, snn=SNN), (T, 2, 6, 6, 8)),
    "Bottleneck_3-s2": ("Bottleneck_3", lambda: JBT.Bottleneck_3(16, 3, 2, snn=JSNN),
                        lambda: PBT.Bottleneck_3(8, 16, 3, 2, snn=SNN), (T, 2, 6, 6, 8)),
    "Bottleneck_4": ("Bottleneck_4", lambda: JBT.Bottleneck_4(16, 3, 1, snn=JSNN),
                     lambda: PBT.Bottleneck_4(8, 16, 3, 1, snn=SNN), (T, 2, 5, 5, 8)),
    "BasicBlock_3-s2": ("BasicBlock_3", lambda: JBT.BasicBlock_3(16, 3, 2, snn=JSNN),
                        lambda: PBT.BasicBlock_3(8, 16, 3, 2, snn=SNN), (T, 2, 6, 6, 8)),
    "BasicBlock_4-s2": ("BasicBlock_4", lambda: JBT.BasicBlock_4(16, 3, 2, snn=JSNN),
                        lambda: PBT.BasicBlock_4(8, 16, 3, 2, snn=SNN), (T, 2, 6, 6, 8)),
    "BasicBlock_5-d2": ("BasicBlock_5", lambda: JBT.BasicBlock_5(16, 3, 1, 2, snn=JSNN),
                        lambda: PBT.BasicBlock_5(8, 16, 3, 1, 2, snn=SNN), (T, 2, 6, 6, 8)),
    "PartialConv-d2": ("PartialConv", lambda: JBT.PartialConv(4, 3, 2),
                       lambda: PBT.PartialConv(16, 4, 3, 2), (T, 2, 6, 6, 16)),
    "FasterNetBlock": ("FasterNetBlock", lambda: JBT.FasterNetBlock(2, snn=JSNN),
                       lambda: PBT.FasterNetBlock(16, 2, snn=SNN), (T, 2, 5, 5, 16)),
    "Concat_res3-s2": ("Concat_res3", lambda: JBT.Concat_res3(16, 3, 2, snn=JSNN),
                       lambda: PBT.Concat_res3(8, 16, 3, 2, snn=SNN), (T, 2, 6, 6, 8)),
    "Concat_res4-s2": ("Concat_res4", lambda: JBT.Concat_res4(16, 3, 2, snn=JSNN),
                       lambda: PBT.Concat_res4(8, 16, 3, 2, snn=SNN), (T, 2, 6, 6, 8)),
    "Concat_res5": ("Concat_res5", lambda: JBT.Concat_res5(16, 3, 1, snn=JSNN),
                    lambda: PBT.Concat_res5(8, 16, 3, 1, snn=SNN), (T, 2, 5, 5, 8)),
    "Concat_res6-s2": ("Concat_res6", lambda: JBT.Concat_res6(16, 3, 2, snn=JSNN),
                       lambda: PBT.Concat_res6(8, 16, 3, 2, snn=SNN), (T, 2, 6, 6, 8)),
    "ScConv": ("ScConv", lambda: JBT.ScConv(snn=JSNN), lambda: PBT.ScConv(16, snn=SNN),
               (T, 2, 4, 5, 16)),
    "CoT": ("CoT", lambda: JBT.CoT(3, snn=JSNN), lambda: PBT.CoT(16, 3, snn=SNN),
            (T, 2, 5, 5, 16)),
    "DualConv-s2": ("DualConv", lambda: JBT.DualConv(8, 2, 4, snn=JSNN),
                    lambda: PBT.DualConv(16, 8, 2, 4, snn=SNN), (T, 2, 6, 6, 16)),
    "MobileNetV3": ("MobileNetV3", lambda: JBT.MobileNetV3(8, 0, 3, 1, snn=JSNN),
                    lambda: PBT.MobileNetV3(8, 8, 0, 3, 1, snn=SNN), (T, 2, 5, 5, 8)),
    "ContextGuideFusionModulev2": (
        "ContextGuideFusionModulev2", lambda: JBT.ContextGuideFusionModulev2(snn=JSNN),
        lambda: PBT.ContextGuideFusionModulev2((8, 16), snn=SNN),
        [(T, 2, 4, 4, 8), (T, 2, 4, 4, 16)]),
    "TransformerBlock-n2": ("TransformerBlock",
                            lambda: JBT.TransformerBlock(16, 2, 2, snn=JSNN),
                            lambda: PBT.TransformerBlock(8, 16, 2, 2, snn=SNN, hw=(3, 4)),
                            (T, 2, 3, 4, 8)),
    "C3TR": ("C3TR", lambda: JBT.C3TR(16, 1, snn=JSNN),
             lambda: PBT.C3TR(8, 16, 1, snn=SNN, hw=(3, 4)), (T, 2, 3, 4, 8)),
    "AKConv": ("AKConv", lambda: JBT2.AKConv(16, 5, 1, snn=JSNN),
               lambda: PBT2.AKConv(8, 16, 5, 1, snn=SNN), (T, 2, 5, 6, 8)),
    "AKConv-np3-s2": ("AKConv", lambda: JBT2.AKConv(16, 3, 2, snn=JSNN),
                      lambda: PBT2.AKConv(8, 16, 3, 2, snn=SNN), (T, 2, 6, 5, 8)),
}

#: the modules whose conv/bn pair both folds take, per case (the rest: none)
FOLDED = {"BasicBlock_4-s2": {""}, "AKConv": {""}, "AKConv-np3-s2": {""}, "Concat_res5": {"conv2"},
          "C3TR": {"cv1", "cv2", "cv3"}}
#: the 1024-wide hidden layer runs faster fully optimised than the cheap compile saves
WIDE = {"Bottleneck_1-s2"}


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_block_matches_jax_f64_in_eval_and_training(case):
    """Eval output, training output and the moved BN statistics in float64;
    the JAX variables load with ``strict=True``; the folded pairs are
    JAX's."""
    name, jax_mod, port_mod, shape = BLOCKS[case]
    x = _inputs(shape, seed=len(case))
    v, (want, (want_t, upd)) = _jax_f64(jax_mod(), x, seed=len(case) + 1, training=True,
                                        compiler_options={} if case in WIDE else _FAST)
    block = port_mod().double()
    block.load_state_dict({k: t.double() for k, t in CV.convert_block(
        name, v["params"], v.get("batch_stats")).items()}, strict=True)
    xt = _torch(x)
    with torch.no_grad():
        got = block.eval()(xt)
    got_t = block.train()(xt)
    _assert_tree_close(got, want, 1e-9)
    _assert_tree_close(got_t, want_t, 1e-9)
    sd = block.state_dict()
    for k, w in CV.convert_block(name, {}, upd.get("batch_stats", {})).items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-12, rtol=0, err_msg=k)
    want_folded = _folded_in_jax(name, v) if "batch_stats" in v else set()
    assert set(PMU.fuse_conv_bn(block)) == want_folded == FOLDED.get(case, set())


# --- gradients ---------------------------------------------------------------------

GRADS = {
    "AKConv": ("AKConv", lambda: JBT2.AKConv(16, 5, 1, snn=JSNN),
               lambda: PBT2.AKConv(8, 16, 5, 1, snn=SNN), (T, 2, 5, 6, 8), (T, 2, 5, 6, 16)),
    "AKConv-zero-offsets": ("AKConv", lambda: JBT2.AKConv(16, 5, 1, snn=JSNN),
                            lambda: PBT2.AKConv(8, 16, 5, 1, snn=SNN), (T, 2, 5, 6, 8),
                            (T, 2, 5, 6, 16)),
    "ScConv": ("ScConv", lambda: JBT.ScConv(snn=JSNN), lambda: PBT.ScConv(16, snn=SNN),
               (T, 2, 4, 5, 16), (T, 2, 4, 5, 16)),
    "TransformerBlock": ("TransformerBlock", lambda: JBT.TransformerBlock(8, 2, 1, snn=JSNN),
                         lambda: PBT.TransformerBlock(8, 8, 2, 1, snn=SNN, hw=(3, 4)),
                         (T, 2, 3, 4, 8), (T, 2, 3, 4, 8)),
    "Concat_res3": ("Concat_res3", lambda: JBT.Concat_res3(16, 3, 1, snn=JSNN),
                    lambda: PBT.Concat_res3(8, 16, 3, 1, snn=SNN), (T, 2, 4, 4, 8),
                    (T, 2, 4, 4, 16)),
}


def _zero_offsets(params):
    """JAX's init of ``p_conv``: a zero kernel (and here a zero bias too, so
    that every sample lies on the grid)."""
    p = jax.tree_util.tree_map(np.asarray, params)
    p["p_conv"]["conv"] = {k: np.zeros_like(w) for k, w in p["p_conv"]["conv"].items()}
    return p


@pytest.mark.parametrize("case", sorted(GRADS))
def test_gradients_match_jax_grad(case):
    """``sum(block(x) * r)``'s gradients with respect to every parameter
    and to x, eval mode, in float64, against ``jax.grad`` (one
    cheap-compile jit).  ``AKConv``'s ``p_conv`` gradient passes the 0.1
    scale, the clip (half a gradient at a tie, as ``jnp.clip``) and the
    bilinear weights; at zero offsets the base pattern puts samples on the
    last row and column, where the clip ties, and beyond them.  ``ScConv``'s
    ``gn_gamma`` / ``gn_beta`` reach the output only through its gate, a
    comparison: zero in both."""
    name, jax_mod, port_mod, shape, rshape = GRADS[case]
    x = _x(shape, seed=21)
    module = jax_mod()
    v = _random_variables(lambda: module.init(jax.random.PRNGKey(0), x), 23)
    if case == "AKConv-zero-offsets":
        v["params"] = _zero_offsets(v["params"])
    stats = {k: w for k, w in v.items() if k != "params"}
    r = _x(rshape, seed=22)

    def loss(params, x_):
        return (module.apply({"params": params, **stats}, x_) * r).sum()

    with jax.enable_x64():
        p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v["params"])
        stats = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), stats)
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)), compiler_options=_FAST)(
            p64, np.asarray(x, np.float64))
    block = port_mod().double().eval()
    block.load_state_dict({k: t.double() for k, t in CV.convert_block(
        name, v["params"], v.get("batch_stats")).items()}, strict=True)
    xt = torch.from_numpy(x).double().requires_grad_(True)
    (block(xt) * torch.from_numpy(r).double()).sum().backward()
    want = CV.convert_block(name, jax.tree_util.tree_map(np.asarray, gp))
    assert set(want) == {k for k, _ in block.named_parameters()}
    for k, p in block.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), want[k].numpy(), atol=1e-9, rtol=1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-9, rtol=1e-9)
    if case == "ScConv":
        assert not want["gn_gamma"].any() and not want["gn_beta"].any()
    if name == "AKConv":
        assert want["p_conv.weight"].abs().sum() > 0


def test_akconv_clip_splits_a_tie_as_jax():
    """``_clip``'s gradient at the bounds is a half (``jnp.clip``'s), inside
    them one, beyond them zero; its values are ``clamp``'s."""
    v = torch.tensor([-1.0, 0.0, 1.5, 3.0, 4.0], dtype=torch.float64, requires_grad=True)
    got = PBT2._clip(v, 3)
    got.sum().backward()
    want = jax.grad(lambda a: jnp.clip(a, 0, 3).sum())(np.asarray(v.detach().numpy(),
                                                               np.float32))
    assert torch.equal(got.detach(), v.detach().clamp(0, 3))
    np.testing.assert_array_equal(v.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(v.grad.numpy(), [0.0, 0.5, 1.0, 0.5, 0.0])


# --- the real widths -----------------------------------------------------------------


def _widths_cfg():
    """A 32 px model whose ``Bottleneck_2`` (e = 4) runs behind a
    ``PartialConv`` and feeds ``Sample`` -> ``Concat`` -> ``BasicBlock_5``:
    the parser records 8 and 24 channels at rows 3 and 5, the tensors carry
    32 and 48."""
    d = port_yolo.load_cfg("resnet10.yaml")
    d["backbone"] = [
        [-1, 1, "Conv_1", [16, 3, 2]],           # 0 16 px
        [-1, 1, "Conv_3", [16, 3, 2]],           # 1 8 px
        [-1, 1, "PartialConv", [4, 3, 1]],       # 2
        [-1, 1, "Bottleneck_2", [8, 1, 1]],      # 3 32 wide
    ]
    d["head"] = [
        [-1, 1, "Sample", ["None", 2, "nearest"]],   # 4 16 px
        [[-1, 0], 1, "Concat", [2]],                 # 5 48 wide
        [-1, 1, "BasicBlock_5", [16, 3, 1]],         # 6
        [[6, 3], 1, "Detect", ["nc", "anchors"]],    # 7
    ]
    return d


def test_bottleneck_2_chain_builds_at_the_real_widths_and_matches_jax_f64():
    """The parser records ``Bottleneck_2``'s c2 (as JAX's); the port builds
    every later layer at the widths its tensors have, and the whole model,
    every weight converted (strict load), equals JAX's in float64 to 1e-9
    in eval and training, with the moved BN statistics."""
    d = _widths_cfg()
    spec, save, chs, head = jax_yolo.parse_model(copy.deepcopy(d), 3)
    assert port_yolo.parse_model(copy.deepcopy(d), 3) == (spec, save, chs, head)
    assert (chs[3], chs[5]) == (8, 24)
    pm = port_yolo.build_model(d, snn=SNNConfig(time_window=T), device="cpu", imgsz=32)
    assert pm.model[6].conv1.in_channels == 48 and pm.model[7].m[1].in_channels == 32
    strides = pm.head_info["strides"]
    assert strides == (2.0, 4.0)
    head["strides"] = strides
    module = jax_yolo.DetectionModel(
        spec=jax_yolo._with_head_args(spec, head["index"], head["name"], head, strides),
        save=save, snn=JSNN, packing=jax_yolo._plan_packing(spec, chs, JSNN.packed_c64),
        tinv_prefix=jax_yolo._t_invariant_prefix(spec, save))
    v = _random_variables(lambda: module.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 32, 32, 3)), training=False), 9)
    x = np.random.RandomState(3).rand(2, 32, 32, 3)

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
    assert len(_leaves(got)) == 3
    _assert_tree_close(got, want)
    _assert_tree_close(got_t, want_t)
    sd = pm.state_dict()
    for k, w in CV.convert({}, upd["batch_stats"], pm.spec).items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-12, rtol=0, err_msg=k)


def test_transformer_block_serves_only_its_map():
    """``pos`` is sized by the map the block is built for: another token
    count raises, in the block and in a model built at another image size."""
    block = PBT.TransformerBlock(8, 8, 2, snn=SNN, hw=(4, 4))
    assert block.pos.shape == (1, 1, 16, 8)
    with pytest.raises(ValueError, match="built for 4x4"):
        block(torch.zeros(T, 1, 3, 5, 8))
    d = port_yolo.load_cfg("resnet10.yaml")
    d["width_multiple"] = 0.125
    d["head"] = [[-1, 1, "C3TR", [256]]] + d["head"]
    d["head"][-1] = [[11, 7], 1, "Detect", ["nc", "anchors"]]
    pm = port_yolo.build_model(d, snn=SNN, device="cpu", imgsz=64)
    assert pm.model[5].m.pos.shape == (1, 1, 4, 16)       # P5 of 64 px: 2 x 2
    with torch.no_grad():
        pm(torch.zeros(1, 64, 64, 3))
        with pytest.raises(ValueError, match="built for 2x2"):
            pm(torch.zeros(1, 96, 96, 3))


# --- the registry ------------------------------------------------------------------

#: the names this slice registers (11g-2 with AKConv)
NEW_NAMES = ("Bottleneck_1", "Bottleneck_2", "Bottleneck_3", "Bottleneck_4", "BasicBlock_3",
             "BasicBlock_4", "BasicBlock_5", "PartialConv", "FasterNetBlock", "Concat_res3",
             "Concat_res4", "Concat_res5", "Concat_res6", "ScConv", "CoT", "DualConv",
             "MobileNetV3", "ContextGuideFusionModulev2", "TransformerBlock", "C3TR", "AKConv")


@functools.lru_cache(maxsize=None)
def _probe_tail():
    """probe-tail on the meta device at 640 px, T=4 (the smoke script's)."""
    return port_yolo.build_model(chip_smoke.probe_cfg("probe-tail"), device="meta")


@pytest.mark.parametrize("name", NEW_NAMES)
def test_registry_name_parses_as_jax(name):
    """probe-tail's parse equals JAX's ``parse_model``; ``name`` is one of
    its rows (only ``TransformerBlock`` and ``C3TR`` depend on the image
    size), built as the registry's block."""
    d = chip_smoke.probe_cfg("probe-tail")
    got = port_yolo.parse_model(copy.deepcopy(d), 3)
    assert got == jax_yolo.parse_model(copy.deepcopy(d), 3)
    rows = [i for i, r in enumerate(got[0]) if r[2] == name]
    assert rows
    cls = (port_yolo.C2_BLOCKS.get(name) or port_yolo.PASS_BLOCKS.get(name)
           or port_yolo.EXTRA_BLOCKS[name])
    assert all(isinstance(_probe_tail().model[i], cls) for i in rows)
    assert (name in port_yolo.SIZE_BOUND) == (name in ("TransformerBlock", "C3TR"))
    assert (name in port_yolo.SNN_AWARE) == (name in jax_yolo.SNN_AWARE)


def test_unported_names_are_item_11g_3():
    """Item 11g-3 took the last 21 names of JAX's registry: the port's four
    registries hold exactly JAX's names, the ones this slice registers
    among them; a name in neither registry raises ``KeyError`` in both
    parsers."""
    regs = ("C2_BLOCKS", "PASS_BLOCKS", "EXTRA_BLOCKS", "HEADS")
    jax_names = set().union(*(getattr(jax_yolo, r) for r in regs))
    assert set().union(*(getattr(port_yolo, r) for r in regs)) == jax_names
    assert set(NEW_NAMES) <= jax_names
    d = port_yolo.load_cfg("resnet10.yaml")
    d["head"] = [[-1, 1, "Bottleneck_9", [64]]] + d["head"]
    for parse in (port_yolo.parse_model, jax_yolo.parse_model):
        with pytest.raises(KeyError, match="Bottleneck_9"):
            parse(copy.deepcopy(d), 3)


def test_probe_tail_sites_take_the_tensor_core_layout():
    """At 640 px every neuron site of probe-tail takes the tensor-core
    kernel's layout (``AKConv``'s samples a dense ``[T, N, Ho * points, Wo,
    C]`` plane), and its two token sites are the ``TransformerBlock``s' of
    rows 8 (inside ``C3TR``) and 14."""
    model = _probe_tail()
    seen, tokens = [], []
    names = {id(m): n for n, m in model.named_modules()}
    hooks = [m.register_forward_pre_hook(
        lambda m, a: (seen if isinstance(m, PB.MemUpdate) else tokens).append(
            (names[id(m)], tuple(a[0].shape), K.layout_refusal(a[0])
             if isinstance(m, PB.MemUpdate) else None)))
        for m in model.modules() if isinstance(m, (PB.MemUpdate, PBX.TokenLIF))]
    try:
        with torch.no_grad():
            model(torch.zeros(1, chip_smoke.IMGSZ, chip_smoke.IMGSZ, 3, device="meta"))
    finally:
        for h in hooks:
            h.remove()
    assert [r for _, _, r in seen] == [None] * len(seen)
    assert len(seen) + len(tokens) == chip_smoke.PROBE_SITES["probe-tail"][0]
    assert [n for n, _, _ in tokens] == ["model.8.m.lif0", "model.14.lif0"]
    planes = {s for n, s, _ in seen if n.endswith("conv2.m") or n == "model.24.m"}
    assert planes == {(chip_smoke.T, 1, 40 * 3, 40, 256), (chip_smoke.T, 1, 40 * 5, 40, 256)}
