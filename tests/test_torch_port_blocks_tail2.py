"""The registry rows of ROADMAP Queue 1 item 11g-3 against the JAX package
(CPU): the rest of ``nn/blocks_star.py`` (``StarBlock``, ``StarBlock_1s``,
``StarBlock_1``, ``StarBlock_3``, ``StarSConv``, ``MStarBlock``,
``MStarBlock_2``) and of ``nn/blocks_tail2.py`` (``BasicBlock_1n``,
``BasicBlock_1m``, ``GN``, ``TPReLU``, the C2f hybrids, ``Attention``,
``OSRAAttention``, ``DynamicConv2d``, ``TransxnetHybridTokenMixer``,
``HetConv``, ``ResNetBlock``, ``ResNetLayerBo``), each in eval and in
training with the moved BN statistics; each block's JAX variables through
``models/convert.py`` with ``strict=True``; the conv/bn pairs
``fuse_conv_bn`` folds against JAX's walk.  Gradients against
``jax.grad``: ``HetConv`` at stride 2 on an even map (XLA's "SAME" pads
(0, 1) there), ``DynamicConv2d`` (its kernel and bias banks),
``Attention`` (the one ``project_out`` of four calls), ``OSRAAttention``
at ``sr_ratio`` 2, ``GN`` and ``TPReLU``.  ``HetConv``'s tap pattern and
``adaptive_avg_pool_hw`` at sizes the output does not divide against
JAX's; ``Concat_res2C2f`` refusing ``s=2``; ``ResNetBlock``'s output
``e * c2`` wide where the parser records c2.

The registry: the port's four tables hold exactly JAX's names; a name in
none of them raises ``KeyError`` in both parsers; every name this slice
registers parses as JAX's in a probe of ``chip_smoke.PROBES``, where the
port builds it; every neuron site of the two probes takes the tensor-core
kernel's layout.

Tolerances: float64 on both sides, 1e-9 (eval, where the port's neuron
sites take their kernels' plain versions, training, and the gradients).
"""

import copy
import functools

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu.models import yolo as jax_yolo
from ecs_yolo_tpu.nn import blocks_star as JBS
from ecs_yolo_tpu.nn import blocks_tail2 as JBT2
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.models import convert as CV
from ecs_yolo_tpu_torch.models import utils as PMU
from ecs_yolo_tpu_torch.models import yolo as port_yolo
from ecs_yolo_tpu_torch.nn import blocks as PB
from ecs_yolo_tpu_torch.nn import blocks_ext as PBX
from ecs_yolo_tpu_torch.nn import blocks_star as PBS
from ecs_yolo_tpu_torch.nn import blocks_tail2 as PBT2
from ecs_yolo_tpu_torch.snn import ecs_lif as K
from test_torch_port_blocks_csp import _folded_in_jax, _inputs, _torch
from test_torch_port_heads import _FAST, _assert_tree_close
from test_torch_port_model import _random_variables, _x

torch.set_num_threads(2)

T = 2
JSNN = JaxSNNConfig(time_window=T)
SNN = SNNConfig(time_window=T)

# case -> (registry name for the converter, JAX block, port block, input shape)
BLOCKS = {
    "StarBlock-s2": ("StarBlock", lambda: JBS.StarBlock(16, 3, 2, snn=JSNN),
                     lambda: PBS.StarBlock(8, 16, 3, 2, snn=SNN), (T, 2, 6, 6, 8)),
    "StarBlock_1s-s2": ("StarBlock_1s", lambda: JBS.StarBlock_1s(16, 3, 2, snn=JSNN),
                        lambda: PBS.StarBlock_1s(8, 16, 3, 2, snn=SNN), (T, 2, 6, 6, 8)),
    "StarBlock_1-s2": ("StarBlock_1", lambda: JBS.StarBlock_1(16, 3, 2, snn=JSNN),
                       lambda: PBS.StarBlock_1(8, 16, 3, 2, snn=SNN), (T, 2, 4, 4, 8)),
    "StarBlock_3-s2": ("StarBlock_3", lambda: JBS.StarBlock_3(16, 3, 2, snn=JSNN),
                       lambda: PBS.StarBlock_3(8, 16, 3, 2, snn=SNN), (T, 2, 6, 6, 8)),
    "StarSConv": ("StarSConv", lambda: JBS.StarSConv(8, 3, 1, snn=JSNN),
                  lambda: PBS.StarSConv(8, 8, 3, 1, snn=SNN), (T, 2, 5, 5, 8)),
    "StarSConv-s2": ("StarSConv", lambda: JBS.StarSConv(16, 3, 2, snn=JSNN),
                     lambda: PBS.StarSConv(8, 16, 3, 2, snn=SNN), (T, 2, 6, 6, 8)),
    "MStarBlock": ("MStarBlock", lambda: JBS.MStarBlock(8, 3, 1, snn=JSNN),
                   lambda: PBS.MStarBlock(8, 8, 3, 1, snn=SNN), (T, 2, 5, 5, 8)),
    "MStarBlock-s2": ("MStarBlock", lambda: JBS.MStarBlock(16, 3, 2, snn=JSNN),
                      lambda: PBS.MStarBlock(8, 16, 3, 2, snn=SNN), (T, 2, 6, 6, 8)),
    "MStarBlock_2": ("MStarBlock_2", lambda: JBS.MStarBlock_2(16, 3, 1, snn=JSNN),
                     lambda: PBS.MStarBlock_2(8, 16, 3, 1, snn=SNN), (T, 2, 5, 5, 8)),
    "BasicBlock_1n-s2": ("BasicBlock_1n", lambda: JBT2.BasicBlock_1n(16, 2, snn=JSNN),
                         lambda: PBT2.BasicBlock_1n(8, 16, 2, snn=SNN), (T, 2, 4, 4, 8)),
    "BasicBlock_1m-s2": ("BasicBlock_1m", lambda: JBT2.BasicBlock_1m(16, 2, snn=JSNN),
                         lambda: PBT2.BasicBlock_1m(8, 16, 2, snn=SNN), (T, 2, 4, 4, 8)),
    "GN": ("GN", lambda: JBT2.GN(4), lambda: PBT2.GN(16, 4), (T, 2, 4, 5, 16)),
    "TPReLU": ("TPReLU", lambda: JBT2.TPReLU(), lambda: PBT2.TPReLU(8), (T, 2, 4, 5, 8)),
    "BasicBlock_2C2f-n2-s2": ("BasicBlock_2C2f",
                              lambda: JBT2.BasicBlock_2C2f(16, 2, True, 3, 2, snn=JSNN),
                              lambda: PBT2.BasicBlock_2C2f(8, 16, 2, True, 3, 2, snn=SNN),
                              (T, 2, 6, 6, 8)),
    "BasicBlock_1C2f": ("BasicBlock_1C2f", lambda: JBT2.BasicBlock_1C2f(16, 1, snn=JSNN),
                        lambda: PBT2.BasicBlock_1C2f(8, 16, 1, snn=SNN), (T, 2, 4, 4, 8)),
    "Concat_res2C2f": ("Concat_res2C2f", lambda: JBT2.Concat_res2C2f(16, 1, snn=JSNN),
                       lambda: PBT2.Concat_res2C2f(8, 16, 1, snn=SNN), (T, 2, 5, 5, 8)),
    "Attention": ("Attention", lambda: JBT2.Attention(2, snn=JSNN),
                  lambda: PBT2.Attention(16, 2, snn=SNN), (T, 2, 5, 6, 16)),
    "OSRAAttention-sr2": ("OSRAAttention", lambda: JBT2.OSRAAttention(2, 2, snn=JSNN),
                          lambda: PBT2.OSRAAttention(16, 2, 2, snn=SNN), (T, 2, 6, 6, 16)),
    "OSRAAttention": ("OSRAAttention", lambda: JBT2.OSRAAttention(1, 1, snn=JSNN),
                      lambda: PBT2.OSRAAttention(16, 1, 1, snn=SNN), (T, 2, 4, 5, 16)),
    "DynamicConv2d": ("DynamicConv2d", lambda: JBT2.DynamicConv2d(3, 4, 2, snn=JSNN),
                      lambda: PBT2.DynamicConv2d(16, 3, 4, 2, snn=SNN), (T, 2, 5, 6, 16)),
    "TransxnetHybridTokenMixer": (
        "TransxnetHybridTokenMixer",
        lambda: JBT2.TransxnetHybridTokenMixer(3, 2, 2, 2, snn=JSNN),
        lambda: PBT2.TransxnetHybridTokenMixer(32, 3, 2, 2, 2, snn=SNN), (T, 2, 6, 6, 32)),
    "HetConv-s2": ("HetConv", lambda: JBT2.HetConv(16, 2, 4, snn=JSNN),
                   lambda: PBT2.HetConv(8, 16, 2, 4, snn=SNN), (T, 2, 6, 6, 8)),
    "HetConv": ("HetConv", lambda: JBT2.HetConv(8, 1, 3, snn=JSNN),
                lambda: PBT2.HetConv(16, 8, 1, 3, snn=SNN), (T, 2, 5, 5, 16)),
    "ResNetBlock-s2": ("ResNetBlock", lambda: JBT2.ResNetBlock(8, 2, snn=JSNN),
                       lambda: PBT2.ResNetBlock(8, 8, 2, snn=SNN), (T, 2, 6, 6, 8)),
    "ResNetLayerBo-first": ("ResNetLayerBo",
                            lambda: JBT2.ResNetLayerBo(16, 1, 1, True, snn=JSNN),
                            lambda: PBT2.ResNetLayerBo(8, 16, 1, 1, True, snn=SNN),
                            (T, 2, 8, 8, 8)),
    "ResNetLayerBo-c3": ("ResNetLayerBo",
                         lambda: JBT2.ResNetLayerBo(16, 1, 1, False, 1, snn=JSNN),
                         lambda: PBT2.ResNetLayerBo(8, 16, 1, 1, False, 1, snn=SNN),
                         (T, 2, 5, 5, 8)),
}

#: the modules whose conv/bn pair both folds take, per case (the rest: none)
FOLDED = {"StarBlock-s2": {"dw", "dwconv", "dwconv2", "f1", "f2", "g"},
          "StarBlock_3-s2": {"f1", "f2", "g"}, "MStarBlock": {"conv2", "conv3"},
          "MStarBlock-s2": {"conv2", "conv3", "shortcut"}, "MStarBlock_2": {"shortcut"},
          "BasicBlock_2C2f-n2-s2": {"cv", "cv1", "cv2"}, "BasicBlock_1C2f": {"cv1", "cv2"},
          "Concat_res2C2f": {"cv1", "cv2"}, "ResNetBlock-s2": {"cv1", "cv2", "cv3", "shortcut"},
          "ResNetLayerBo-first": {"stem"},
          "ResNetLayerBo-c3": {"c3.cv1", "c3.cv2", "c3.cv3", "c3.m0.cv1", "c3.m0.cv2"}}
#: the 1024-wide hidden layers run faster fully optimised than the cheap compile saves
WIDE = {"StarBlock_1-s2", "BasicBlock_1n-s2", "BasicBlock_1m-s2", "BasicBlock_1C2f"}


def _jax_f64(module, x, seed, compiler_options):
    """Seeded variables for ``module`` on ``x`` and, in float64, its eval
    output, its training output and its updated BN statistics (one jit).
    ``flax_nn.Module.init``: ``TPReLU``'s field ``init`` hides the method."""
    v = _random_variables(lambda: flax_nn.Module.init(module, jax.random.PRNGKey(0), x), seed)

    def run(v_, x_):
        return (module.apply(v_, x_, training=False),
                module.apply(v_, x_, training=True, mutable=["batch_stats"]))

    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        return v, jax.jit(run, compiler_options=compiler_options)(v64, np.asarray(x, np.float64))


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_block_matches_jax_f64_in_eval_and_training(case):
    """Eval output, training output and the moved BN statistics in float64;
    the JAX variables load with ``strict=True``; the folded pairs are
    JAX's."""
    name, jax_mod, port_mod, shape = BLOCKS[case]
    x = _inputs(shape, seed=len(case))
    v, (want, (want_t, upd)) = _jax_f64(jax_mod(), x, seed=len(case) + 1,
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
    "HetConv-s2": ("HetConv", lambda: JBT2.HetConv(16, 2, 4, snn=JSNN),
                   lambda: PBT2.HetConv(8, 16, 2, 4, snn=SNN), (T, 2, 6, 6, 8),
                   (T, 2, 3, 3, 16)),
    "DynamicConv2d": ("DynamicConv2d", lambda: JBT2.DynamicConv2d(3, 4, 2, snn=JSNN),
                      lambda: PBT2.DynamicConv2d(16, 3, 4, 2, snn=SNN), (T, 2, 5, 6, 16),
                      (T, 2, 5, 6, 16)),
    "Attention": ("Attention", lambda: JBT2.Attention(2, snn=JSNN),
                  lambda: PBT2.Attention(16, 2, snn=SNN), (T, 2, 5, 6, 16), (T, 2, 5, 6, 16)),
    "OSRAAttention-sr2": ("OSRAAttention", lambda: JBT2.OSRAAttention(2, 2, snn=JSNN),
                          lambda: PBT2.OSRAAttention(16, 2, 2, snn=SNN), (T, 2, 6, 6, 16),
                          (T, 2, 6, 6, 16)),
    "GN": ("GN", lambda: JBT2.GN(4), lambda: PBT2.GN(16, 4), (T, 2, 4, 5, 16),
           (T, 2, 4, 5, 16)),
    "TPReLU": ("TPReLU", lambda: JBT2.TPReLU(), lambda: PBT2.TPReLU(8), (T, 2, 4, 5, 8),
               (T, 2, 4, 5, 8)),
}


@pytest.mark.parametrize("case", sorted(GRADS))
def test_gradients_match_jax_grad(case):
    """``sum(block(x) * r)``'s gradients with respect to every parameter
    and to x, eval mode, in float64, against ``jax.grad`` (one
    cheap-compile jit); every parameter's gradient is non-zero (the bias
    bank of ``DynamicConv2d`` and the shared ``project_out`` included:
    ``DynamicConv2d``'s two gating outputs get a bias of +0.6, so that
    their token neurons fire)."""
    name, jax_mod, port_mod, shape, rshape = GRADS[case]
    x = _x(shape, seed=21)
    module = jax_mod()
    v = _random_variables(lambda: flax_nn.Module.init(module, jax.random.PRNGKey(0), x), 23)
    if name == "DynamicConv2d":
        for tag in ("proj_c2", "projb_c2"):
            v["params"][tag]["conv"]["bias"] = v["params"][tag]["conv"]["bias"] + 0.6
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
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), atol=1e-9, rtol=1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-9, rtol=1e-9)
    for k in ("weight", "bias", "project_out.weight", "project_out.bias", "gn.weight"):
        if k in want:
            assert want[k].abs().sum() > 0, k


@pytest.mark.parametrize("c1,c2,p", [(16, 8, 4), (12, 20, 3), (5, 7, 8)])
def test_hetconv_taps_are_jax_pattern(c1, c2, p):
    """The cyclic 3x3 / 1x1 pattern equals JAX's ``_hetconv_mask`` (also
    where ``p > c1``: no 3x3 pair); the tap mask keeps a 1x1 pair's centre
    only."""
    want = np.asarray(JBT2._hetconv_mask(c1, c2, p))
    got = PBT2.hetconv_mask(c1, c2, p)
    np.testing.assert_array_equal(got.numpy(), want)
    taps = PBT2.HetConv(c1, c2, 1, p).taps
    assert torch.equal(taps[:, :, 1, 1], torch.ones(c2, c1))
    assert torch.equal(taps.sum((2, 3)), 1 + 8 * got)


@pytest.mark.parametrize("size,out", [(5, 3), (7, 3), (6, 3), (3, 3), (2, 3)])
def test_adaptive_avg_pool_matches_jax(size, out):
    """Windows ``[floor(i H / out), ceil((i + 1) H / out))``, also where
    they overlap (H < 2 out) or ``out`` does not divide H, against JAX's
    ``adaptive_avg_pool_hw`` and torch's ``adaptive_avg_pool2d``."""
    x = _x((T, 2, size, size + 1, 4), seed=size)
    got = PBT2.adaptive_avg_pool_hw(torch.from_numpy(x).double(), out)
    with jax.enable_x64():
        want = np.asarray(JBT2.adaptive_avg_pool_hw(jnp.asarray(x, jnp.float64), out))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)
    lib = torch.nn.functional.adaptive_avg_pool2d(
        torch.from_numpy(x).double().reshape(-1, size, size + 1, 4).permute(0, 3, 1, 2), out)
    np.testing.assert_allclose(got.reshape(-1, out, out, 4).permute(0, 3, 1, 2).numpy(),
                               lib.numpy(), atol=1e-12, rtol=0)


def test_concat_res2c2f_refuses_stride_2():
    """JAX asserts ``s == 1`` (the reference's ``s=2`` cannot run); the
    port raises ``ValueError`` when built so."""
    with pytest.raises(ValueError, match="s=1 only"):
        PBT2.Concat_res2C2f(8, 16, 1, 3, 2, snn=SNN)
    with pytest.raises(AssertionError):
        JBT2.Concat_res2C2f(16, 1, 3, 2, snn=JSNN).init(
            jax.random.PRNGKey(0), jnp.zeros((T, 1, 4, 4, 8)))


def test_resnet_block_feeds_the_next_layer_its_tensor_width():
    """The parser records ``ResNetBlock``'s c2, as JAX's; its output is ``e
    * c2`` wide and the next layer (``HetConv``) is built for that width,
    as flax infers it."""
    d = port_yolo.load_cfg("resnet10.yaml")
    d["width_multiple"] = 0.125
    d["backbone"] = [[-1, 1, "Conv_1", [64, 7, 2]], [-1, 1, "ResNetBlock", [64, 2]],
                     [-1, 1, "HetConv", [256, 2, 4]], [-1, 1, "BasicBlock_2", [512, 3, 2]]]
    d["head"] = [[[2, 3], 1, "Detect", ["nc", "anchors"]]]
    got = port_yolo.parse_model(copy.deepcopy(d), 3)
    assert got == jax_yolo.parse_model(copy.deepcopy(d), 3)
    assert got[2][1:3] == [8, 32]
    model = port_yolo.build_model(d, snn=SNN, device="meta", imgsz=64)
    assert model.model[2].weight.shape == (32, 32, 3, 3)      # 4 * 8 channels in
    assert model.head_info["strides"] == (8.0, 16.0)


def test_build_model_draws_the_new_parameters_as_jax():
    """``build_model`` (meta build, then the device) draws ``HetConv``'s
    kernel from ``U(+-1 / sqrt(9 c1))`` with a zero bias and makes its tap
    mask again (``to_empty`` leaves a buffer unset), ``DynamicConv2d``'s
    banks from a normal of std 0.02 cut at two of them, ``GN``'s scale 1 and
    shift 0 and the ``TPReLU`` slopes 0.25, as JAX's initializers."""
    d = port_yolo.load_cfg("resnet10.yaml")
    d["backbone"] = [[-1, 1, "Conv_1", [16, 7, 4]], [-1, 1, "HetConv", [32, 2, 4]],
                     [-1, 1, "GN", [8]], [-1, 1, "TPReLU", []],
                     [-1, 1, "DynamicConv2d", [3, 4, 2]], [-1, 1, "Conv_3", [32, 3, 2]]]
    d["head"] = [[[4, 5], 1, "Detect", ["nc", "anchors"]]]
    model = port_yolo.build_model(d, snn=SNN, device="cpu", imgsz=64,
                                  generator=torch.Generator().manual_seed(3))
    het, gn, prelu, dyn = (model.model[i] for i in (1, 2, 3, 4))
    assert torch.equal(het.taps, het.make_taps()) and not het.bias.any()
    w = het.weight.abs()
    assert w.max() <= 1 / np.sqrt(9 * 16) and w.mean() > 0.4 / np.sqrt(9 * 16)
    for bank in (dyn.weight.detach(), dyn.bias.detach()):
        assert bank.abs().max() <= 0.04 and 0.012 < float(bank.std()) < 0.02
    assert torch.equal(gn.gn.weight, torch.ones(32)) and not gn.gn.bias.any()
    assert torch.equal(prelu.weight, torch.full((32,), 0.25))


# --- the registry ------------------------------------------------------------------

#: the names this slice registers (item 11g-3)
NEW_NAMES = ("StarBlock", "StarBlock_1", "StarBlock_1s", "StarBlock_3", "StarSConv",
             "MStarBlock", "MStarBlock_2", "BasicBlock_2C2f", "BasicBlock_1C2f",
             "Concat_res2C2f", "HetConv", "ResNetBlock", "ResNetLayerBo", "BasicBlock_1n",
             "BasicBlock_1m", "GN", "TPReLU", "Attention", "OSRAAttention", "DynamicConv2d",
             "TransxnetHybridTokenMixer")
_REGISTRIES = ("C2_BLOCKS", "PASS_BLOCKS", "EXTRA_BLOCKS", "HEADS")


@functools.lru_cache(maxsize=None)
def _probe(name):
    """A probe model of the smoke script on the meta device at 640 px, T=4."""
    return port_yolo.build_model(chip_smoke.probe_cfg(name), device="meta")


def _probe_of(name):
    return "probe-star" if name in NEW_NAMES[:10] + ("GN", "TPReLU") else "probe-mixer"


@pytest.mark.parametrize("name", NEW_NAMES)
def test_registry_name_parses_as_jax(name):
    """The probe that carries ``name`` parses as JAX's ``parse_model``;
    each row of ``name`` is built as the registry's block, SNN-aware as in
    JAX, its repeat count its own where JAX inserts it."""
    probe = _probe_of(name)
    d = chip_smoke.probe_cfg(probe)
    got = port_yolo.parse_model(copy.deepcopy(d), 3)
    assert got == jax_yolo.parse_model(copy.deepcopy(d), 3)
    rows = [i for i, r in enumerate(got[0]) if r[2] == name]
    assert rows
    cls = port_yolo.C2_BLOCKS.get(name) or port_yolo.PASS_BLOCKS[name]
    assert all(type(_probe(probe).model[i]) is cls for i in rows)
    assert (name in port_yolo.SNN_AWARE) == (name in jax_yolo.SNN_AWARE)
    assert (name in port_yolo.CSP_N_BLOCKS) == (name in jax_yolo.CSP_N_BLOCKS)


@pytest.mark.parametrize("table", _REGISTRIES)
def test_registries_hold_jax_names(table):
    """Each of the port's four tables holds exactly the names of JAX's;
    since item 11g-3 no name of JAX's registry is left out."""
    assert set(getattr(port_yolo, table)) == set(getattr(jax_yolo, table))


@pytest.mark.parametrize("probe", ["probe-star", "probe-mixer"])
def test_probe_sites_take_the_tensor_core_layout(probe):
    """At 640 px every neuron site of the probe takes the tensor-core
    kernel's layout (the C2f hybrids' and the mixer's channel halves are
    dense copies; ``DynamicConv2d``'s gating sites run on 3 x 3 and 1 x 1
    maps); probe-mixer's token sites are ``OSRAAttention``'s and
    ``DynamicConv2d``'s, inside the mixer too."""
    model = _probe(probe)
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
    assert len(seen) + len(tokens) == chip_smoke.PROBE_SITES[probe][0]
    small = sorted(s[2:4] for _, s, _ in seen if s[2] < 10)
    if probe == "probe-star":
        assert not tokens and not small
        return
    assert [n for n, _, _ in tokens] == [
        "model.7.scale_act", "model.7.bias_act", "model.8.local.scale_act",
        "model.8.local.bias_act", "model.8.global.q_act", "model.8.global.attn_act",
        "model.9.q_act", "model.9.attn_act"]
    assert small == [(1, 1)] * 4 + [(3, 3)] * 4
