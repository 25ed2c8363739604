"""The registry rows of ROADMAP Queue 1 item 11g-1 against the JAX package
(CPU): the rest of ``nn/blocks.py`` (``Conv_A``, ``Conv_5``, ``Pools``,
``ZeroPad``, ``Conv_7``, ``MemUpdate`` as ``mem_update``),
``nn/experimental.py`` (``CrossConv``, ``Sum``, ``MixConv2d``),
``nn/blocks_ext.py`` (``BottleneckCSP``, ``C3Ghost``, ``SPP``, ``C3SPP``,
``Focus``, ``Contract``, ``Expand``, ``SELayer``, ``MHSA``,
``BottleneckTransformer``, ``BoT3``, ``DSSA``, ``ASFF3`` at its three
levels, ``ASFF2`` with ``rfb``) and ``nn/blocks_v9.py`` (``RepConvN``,
``RepNBottleneck``, ``RepNCSP``, ``RepNCSPELAN4``), each in eval and in
training with the moved BN statistics (and ``DSSA``'s moved firing
rates); each block's JAX variables through ``models/convert.py`` with
``strict=True``; the conv/bn pairs ``fuse_conv_bn`` folds against JAX's
walk.  ``Conv_6`` is ``Conv_5`` with another BN init, checked at the
init.  ``Sum``'s weight, ``SELayer``'s ``Dense`` kernels and
``MixConv2d``'s grouped kernels against ``jax.grad``; ``Contract`` and
``Expand`` inverse to each other in both packages; every neuron site of
``RepNCSPELAN4`` takes the tensor-core kernel's layout.

The registry: every name this slice registers parses as in JAX's
``parse_model`` (the two probe models of ``chip_smoke.PROBES``, and
``mem_update`` / ``Conv_7`` in a spec of their own), appears in a probe
(but those two), and builds with JAX's arguments; the T-invariant stem
blocks are JAX's; the smoke script's ``PROBE_SITES`` table against the
probes' hooks.

Tolerances: float64 on both sides, 1e-9 (eval, where the port's neuron
sites take their kernels' plain versions, training, and the gradients).
"""

import copy

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu.models import yolo as jax_yolo
from ecs_yolo_tpu.nn import blocks as JB
from ecs_yolo_tpu.nn import blocks_ext as JBX
from ecs_yolo_tpu.nn import blocks_v9 as JBV
from ecs_yolo_tpu.nn import experimental as JBE
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.models import convert as CV
from ecs_yolo_tpu_torch.models import utils as PMU
from ecs_yolo_tpu_torch.models import yolo as port_yolo
from ecs_yolo_tpu_torch.nn import blocks as PB
from ecs_yolo_tpu_torch.nn import blocks_ext as PBX
from ecs_yolo_tpu_torch.nn import blocks_v9 as PBV
from ecs_yolo_tpu_torch.nn import experimental as PBE
from ecs_yolo_tpu_torch.snn import ecs_lif as K
from test_torch_port_blocks_csp import _folded_in_jax, _inputs, _torch
from test_torch_port_blocks_ext import site_counts
from test_torch_port_heads import _FAST, _assert_tree_close, _jax_f64
from test_torch_port_model import _random_variables, _x

torch.set_num_threads(2)

T = 2
JSNN = JaxSNNConfig(time_window=T)
SNN = SNNConfig(time_window=T)

# case -> (registry name for the converter, JAX block, port block, input
# shape(s) [T, N, H, W, C])
BLOCKS = {
    "Conv_A": ("Conv_A", lambda: JB.Conv_A(16, 3, 2, snn=JSNN),
               lambda: PB.Conv_A(8, 16, 3, 2, snn=SNN), (T, 2, 8, 8, 8)),
    "Conv_5": ("Conv_5", lambda: JB.Conv_5(16, 3, 2, snn=JSNN),
               lambda: PB.Conv_5(8, 16, 3, 2, snn=SNN), (T, 2, 8, 8, 8)),
    "Pools": ("Pools", lambda: JB.Pools(3, 2, 1), lambda: PB.Pools(3, 2, 1), (T, 2, 7, 7, 8)),
    "zeropad": ("zeropad", lambda: JB.ZeroPad((1, 2, 0, 3)), lambda: PB.ZeroPad((1, 2, 0, 3)),
                (T, 2, 5, 6, 8)),
    "Conv_7": ("Conv_7", lambda: JB.Conv_7(snn=JSNN), lambda: PB.Conv_7(T), (T, 2, 4, 4, 8)),
    "mem_update": ("mem_update", lambda: JB.MemUpdate(snn=JSNN),
                   lambda: PB.MemUpdate(8, snn=SNN), (T, 2, 5, 5, 8)),
    "CrossConv": ("CrossConv", lambda: JBE.CrossConv(16, 3, 1, 1, 1.0, True, snn=JSNN),
                  lambda: PBE.CrossConv(16, 16, 3, 1, 1, 1.0, True, snn=SNN),
                  (T, 2, 6, 6, 16)),
    "CrossConv-s2-g2": ("CrossConv", lambda: JBE.CrossConv(16, 3, 2, 2, 0.5, snn=JSNN),
                        lambda: PBE.CrossConv(8, 16, 3, 2, 2, 0.5, snn=SNN),
                        (T, 2, 8, 8, 8)),
    "Sum": ("Sum", lambda: JBE.Sum(3, True), lambda: PBE.Sum(3, True), [(T, 2, 4, 4, 8)] * 3),
    "MixConv2d": ("MixConv2d", lambda: JBE.MixConv2d(16, (1, 3, 5), 2, snn=JSNN),
                  lambda: PBE.MixConv2d(8, 16, (1, 3, 5), 2, snn=SNN), (T, 2, 8, 8, 8)),
    "BottleneckCSP": ("BottleneckCSP", lambda: JBX.BottleneckCSP(16, 2, snn=JSNN),
                      lambda: PBX.BottleneckCSP(8, 16, 2, snn=SNN), (T, 2, 6, 6, 8)),
    "C3Ghost": ("C3Ghost", lambda: JBX.C3Ghost(16, 1, snn=JSNN),
                lambda: PBX.C3Ghost(8, 16, 1, snn=SNN), (T, 2, 6, 6, 8)),
    "SPP": ("SPP", lambda: JBX.SPP(16, (3, 5), snn=JSNN),
            lambda: PBX.SPP(16, 16, (3, 5), snn=SNN), (T, 2, 7, 7, 16)),
    "C3SPP": ("C3SPP", lambda: JBX.C3SPP(16, (3, 5), snn=JSNN),
              lambda: PBX.C3SPP(8, 16, (3, 5), snn=SNN), (T, 2, 7, 7, 8)),
    "Focus": ("Focus", lambda: JBX.Focus(16, 3, snn=JSNN),
              lambda: PBX.Focus(3, 16, 3, snn=SNN), (T, 2, 8, 8, 3)),
    "Contract": ("Contract", lambda: JBX.Contract(2), lambda: PBX.Contract(2),
                 (T, 2, 4, 6, 8)),
    "Expand": ("Expand", lambda: JBX.Expand(2), lambda: PBX.Expand(2), (T, 2, 3, 2, 16)),
    "SELayer": ("SELayer", lambda: JBX.SELayer(4, snn=JSNN),
                lambda: PBX.SELayer(16, 4, snn=SNN), (T, 2, 5, 5, 16)),
    "MHSA": ("MHSA", lambda: JBX.MHSA(16, 2, snn=JSNN),
             lambda: PBX.MHSA(8, 16, 2, snn=SNN), (T, 2, 4, 5, 8)),
    "BottleneckTransformer-s2": (
        "BottleneckTransformer", lambda: JBX.BottleneckTransformer(16, 2, 2, 0.5, snn=JSNN),
        lambda: PBX.BottleneckTransformer(8, 16, 2, 2, 0.5, snn=SNN), (T, 2, 4, 6, 8)),
    "BoT3": ("BoT3", lambda: JBX.BoT3(16, 1, snn=JSNN), lambda: PBX.BoT3(8, 16, 1, snn=SNN),
             (T, 2, 4, 4, 8)),
    "DSSA": ("DSSA", lambda: JBX.DSSA(2, snn=JSNN), lambda: PBX.DSSA(16, 2, snn=SNN),
             (T, 2, 3, 4, 16)),
    "ASFF3-0": ("ASFF3", lambda: JBX.ASFF3(0, snn=JSNN),
                lambda: PBX.ASFF3(0, 16, 8, 8, snn=SNN),
                [(T, 2, 2, 2, 16), (T, 2, 4, 4, 8), (T, 2, 8, 8, 8)]),
    "ASFF3-1": ("ASFF3", lambda: JBX.ASFF3(1, snn=JSNN),
                lambda: PBX.ASFF3(1, 16, 8, 8, snn=SNN),
                [(T, 2, 2, 2, 16), (T, 2, 4, 4, 8), (T, 2, 8, 8, 8)]),
    "ASFF3-2": ("ASFF3", lambda: JBX.ASFF3(2, snn=JSNN),
                lambda: PBX.ASFF3(2, 16, 8, 8, snn=SNN),
                [(T, 2, 2, 2, 16), (T, 2, 4, 4, 8), (T, 2, 8, 8, 8)]),
    "ASFF2-rfb": ("ASFF2", lambda: JBX.ASFF2(1, True, snn=JSNN),
                  lambda: PBX.ASFF2(1, 16, 8, True, snn=SNN),
                  [(T, 2, 2, 2, 16), (T, 2, 4, 4, 8)]),
    "RepConvN": ("RepConvN", lambda: JBV.RepConvN(16, 3, 2, 2, snn=JSNN),
                 lambda: PBV.RepConvN(8, 16, 3, 2, 2, snn=SNN), (T, 2, 6, 6, 8)),
    "RepNBottleneck": ("RepNBottleneck", lambda: JBV.RepNBottleneck(8, snn=JSNN),
                       lambda: PBV.RepNBottleneck(8, 8, snn=SNN), (T, 2, 5, 5, 8)),
    "RepNCSP": ("RepNCSP", lambda: JBV.RepNCSP(16, 2, snn=JSNN),
                lambda: PBV.RepNCSP(8, 16, 2, snn=SNN), (T, 2, 5, 5, 8)),
    "RepNCSPELAN4": ("RepNCSPELAN4", lambda: JBV.RepNCSPELAN4(16, 16, 8, 1, snn=JSNN),
                     lambda: PBV.RepNCSPELAN4(8, 16, 16, 8, 1, snn=SNN), (T, 2, 5, 5, 8)),
}

#: the modules whose conv/bn pair both folds take, per case
FOLDED = {
    "Conv_A": {""}, "Conv_5": set(), "Focus": {"conv"}, "MixConv2d": set(),
    "BottleneckCSP": {"cv1", "m0.cv1", "m0.cv2", "m1.cv1", "m1.cv2", "cv4"},
    "SPP": {"cv1", "cv2"}, "MHSA": set(), "DSSA": set(), "RepConvN": set(),
    "RepNCSP": {"cv1", "cv2", "m0.cv2", "m1.cv2"},
}


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_block_matches_jax_f64_in_eval_and_training(case):
    """Eval output, training output and the moved BN statistics (and
    firing rates) in float64; the JAX variables load with ``strict=True``;
    the folded pairs are JAX's."""
    name, jax_mod, port_mod, shape = BLOCKS[case]
    x = _inputs(shape, seed=len(case))
    v, (want, (want_t, upd)) = _jax_f64(jax_mod(), x, seed=len(case) + 1, training=True)
    block = port_mod().double()
    block.load_state_dict({k: t.double() for k, t in CV.convert_block(
        name, v.get("params", {}), v.get("batch_stats")).items()}, strict=True)
    xt = _torch(x)
    with torch.no_grad():
        got = block.eval()(xt)
    got_t = block.train()(xt)
    _assert_tree_close(got, want, 1e-9)
    _assert_tree_close(got_t, want_t, 1e-9)
    sd = block.state_dict()
    moved = CV.convert_block(name, {}, upd.get("batch_stats", {}))
    for k, w in moved.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-12, rtol=0, err_msg=k)
    if case == "DSSA":          # the firing rates moved, and by JAX's amount
        assert {"firing_rate_x", "firing_rate_attn"} <= set(moved)
        assert not np.allclose(moved["firing_rate_x"].numpy(),
                               np.asarray(v["batch_stats"]["firing_rate_x"]))
    want_folded = _folded_in_jax(name, v) if "batch_stats" in v else set()
    assert set(PMU.fuse_conv_bn(block)) == want_folded
    if case in FOLDED:
        assert want_folded == FOLDED[case]


def test_conv_6_is_conv_5_with_the_small_gamma():
    """``Conv_6``'s BN gamma starts at 0.2 * thresh and ``Conv_5``'s at
    thresh (``init_weights``), JAX's ``gamma_scale`` of each; the rest is
    the same module."""
    for jcls, pcls, scale in ((JB.Conv_5, PB.Conv_5, 1.0), (JB.Conv_6, PB.Conv_6, 0.2)):
        assert jcls(8, snn=JSNN).gamma_scale == pcls.gamma_scale == scale
        block = pcls(8, 16, 3, snn=SNN)
        port_yolo.init_weights(block, torch.Generator().manual_seed(0))
        assert torch.equal(block.bn.bn.weight, torch.full((16,), scale * SNN.thresh))


# --- the new parameter kinds' gradients ---------------------------------------------

GRADS = {
    "Sum": (lambda: JBE.Sum(3, True), lambda: PBE.Sum(3, True), [(T, 2, 3, 3, 8)] * 3),
    "SELayer": (lambda: JBX.SELayer(4, snn=JSNN), lambda: PBX.SELayer(16, 4, snn=SNN),
                (T, 2, 3, 4, 16)),
    "MixConv2d": (lambda: JBE.MixConv2d(16, (1, 3, 5), 1, snn=JSNN),
                  lambda: PBE.MixConv2d(8, 16, (1, 3, 5), 1, snn=SNN), (T, 2, 5, 5, 8)),
}


@pytest.mark.parametrize("name", sorted(GRADS))
def test_new_parameter_gradients_match_jax_grad(name):
    """``sum(block(x) * r)``'s gradients with respect to every parameter
    and to x, eval mode, in float64, against ``jax.grad`` (one
    cheap-compile jit): ``Sum``'s weight, ``SELayer``'s ``Dense`` kernels,
    ``MixConv2d``'s grouped kernels (groups of 6, 5, 5 channels: 2 and 1
    conv groups) and its BN affine."""
    jax_mod, port_mod, shape = GRADS[name]
    x = _inputs(shape, seed=11)
    module = jax_mod()
    x32 = [np.asarray(a) for a in x] if isinstance(x, list) else x
    v = _random_variables(lambda: module.init(jax.random.PRNGKey(0), x32), 13)
    stats = {k: w for k, w in v.items() if k != "params"}
    rshape = (T, 2, 3, 3, 8) if name == "Sum" else (T, 2, 5, 5, 16) if name == "MixConv2d" \
        else shape
    r = _x(rshape, seed=12)

    def loss(params, x_):
        return (module.apply({"params": params, **stats}, x_) * r).sum()

    with jax.enable_x64():
        p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v["params"])
        stats = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), stats)
        x64 = ([np.asarray(a, np.float64) for a in x] if isinstance(x, list)
               else np.asarray(x, np.float64))
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)), compiler_options=_FAST)(p64, x64)
    block = port_mod().double().eval()
    block.load_state_dict({k: t.double() for k, t in CV.convert_block(
        name, v["params"], v.get("batch_stats")).items()}, strict=True)
    xt = [a.requires_grad_(True) for a in _torch(x)] if isinstance(x, list) else \
        _torch(x).requires_grad_(True)
    (block(xt) * torch.from_numpy(r).double()).sum().backward()
    want = CV.convert_block(name, jax.tree_util.tree_map(np.asarray, gp))
    assert set(want) == {k for k, _ in block.named_parameters()}
    for k, p in block.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), atol=1e-9, rtol=1e-9,
                                   err_msg=k)
    for a, b in zip(xt if isinstance(x, list) else [xt], gx if isinstance(x, list) else [gx]):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=1e-9, rtol=1e-9)
    if name == "MixConv2d":
        assert [getattr(block, g).groups for g in block.groups] == [2, 1, 1]


# --- layouts -------------------------------------------------------------------------


@pytest.mark.parametrize("gain", [2, 3])
def test_contract_and_expand_are_inverse_in_both_packages(gain):
    """``Expand(Contract(x)) == x`` and ``Contract(Expand(y)) == y``, and
    the port's channel order is JAX's (exact: a permutation)."""
    x = _x((T, 2, 6, 6, 4), 5)
    y = _x((T, 2, 2, 3, 4 * gain * gain), 6)
    for cls_c, cls_e, conv in ((JBX.Contract, JBX.Expand, np.asarray),
                               (PBX.Contract, PBX.Expand, torch.from_numpy)):
        c, e = cls_c(gain), cls_e(gain)
        run = (lambda m, a: np.asarray(m.apply({}, a))) if conv is np.asarray else \
            (lambda m, a: m(a).numpy())
        np.testing.assert_array_equal(run(e, conv(run(c, conv(x)))), x)
        np.testing.assert_array_equal(run(c, conv(run(e, conv(y)))), y)
    np.testing.assert_array_equal(PBX.Contract(gain)(torch.from_numpy(x)).numpy(),
                                  np.asarray(JBX.Contract(gain).apply({}, x)))


def test_repncspelan4_sites_take_the_tensor_core_layout():
    """At every neuron site of ``RepNCSPELAN4`` the tensor-core kernel takes
    the input's layout (``layout_refusal`` is None): ``csp0`` gets a dense
    copy of ``cv1``'s second half, whose view it would refuse."""
    block = PBV.RepNCSPELAN4(16, 32, 32, 16, 1, snn=SNN).eval()
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append(K.layout_refusal(a[0])))
             for m in block.modules() if isinstance(m, PB.MemUpdate)]
    with torch.no_grad():
        block(torch.from_numpy(_x((T, 2, 8, 8, 16), 3)))
    for h in hooks:
        h.remove()
    assert len(seen) == 14 and seen == [None] * 14
    assert K.layout_refusal(torch.zeros(T, 2, 8, 8, 32)[..., 16:]) is not None


def test_dssa_rates_move_once_under_remat():
    """Under ``nn/blocks.checkpointed`` (``remat``) DSSA's firing rates move
    once a step, as ``_BN``'s statistics: the recompute in the backward
    pass leaves them, and the step's gradients equal the plain step's."""
    x = torch.from_numpy(_x((T, 2, 3, 4, 16), 8)).double()

    def step(remat):
        block = PBX.DSSA(16, 2, snn=SNN).double().train()
        torch.manual_seed(0)
        for p in block.parameters():
            torch.nn.init.uniform_(p, -0.5, 0.5)
        out = PB.checkpointed(block, x) if remat else block(x)
        out.sum().backward()
        return block.firing_rate_x.clone(), block.firing_rate_attn.clone(), [
            p.grad for p in block.parameters()]

    (fx, fa, g), (fx_r, fa_r, g_r) = step(False), step(True)
    assert torch.equal(fx, fx_r) and torch.equal(fa, fa_r)
    assert not torch.equal(fx, torch.full_like(fx, 0.01))
    for a, b in zip(g, g_r):
        torch.testing.assert_close(a, b, atol=1e-12, rtol=1e-12)


# --- the registry ------------------------------------------------------------------

#: the names this slice registers (11g-1), and those no probe row carries
NEW_NAMES = ("Conv_A", "Conv_B", "Conv_5", "Conv_6", "shortcut", "DepthWiseConv", "DWConv",
             "LightConv", "Bottleneck", "BottleneckCSP", "C3Ghost", "C3SPP", "SPP", "Focus",
             "GhostConv", "GhostBottleneck", "GSConv", "RepConv", "MHSA",
             "BottleneckTransformer", "BoT3", "CrossConv", "MixConv2d", "RepConvN",
             "RepNBottleneck", "RepNCSP", "RepNCSPELAN4", "Pools", "zeropad", "mem_update",
             "Conv_7", "DSSA", "SELayer", "ELA", "ClippedTPReLU", "Contract", "Expand",
             "ASFF2", "ASFF3", "Sum")
SPEC_ONLY = ("mem_update", "Conv_7")


def _spec_only_cfg():
    """resnet10 with a ``mem_update`` and a ``Conv_7`` row (its output is
    4-D, so the model is only parsed)."""
    d = port_yolo.load_cfg("resnet10.yaml")
    d["head"] = [[-1, 1, "mem_update", []], [-1, 1, "Conv_7", [1, 1]]] + d["head"]
    d["head"][-1] = [[12, 8], 1, "Detect", ["nc", "anchors"]]
    return d


def _cfgs():
    return {**{n: chip_smoke.probe_cfg(n) for n in chip_smoke.PROBES},
            "spec-only": _spec_only_cfg()}


@pytest.mark.parametrize("name", NEW_NAMES)
def test_registry_name_parses_as_jax(name):
    """The rows of ``name`` (in the probe or spec that holds it) and the
    whole parse of that model equal JAX's ``parse_model``; ``name`` is a
    probe row unless it is ``mem_update`` or ``Conv_7``; the port builds
    the row on the meta device with JAX's arguments."""
    held = {k: d for k, d in _cfgs().items()
            if name in {r[2] for r in d["backbone"] + d["head"]}}
    assert held and (("spec-only" in held) == (name in SPEC_ONLY))
    for d in held.values():
        got = port_yolo.parse_model(copy.deepcopy(d), 3)
        assert got == jax_yolo.parse_model(copy.deepcopy(d), 3)
        rows, _, chs, _ = got
        for i, (f, n, row_name, args) in enumerate(rows):
            if row_name != name:
                continue
            with torch.device("meta"):
                m = port_yolo._construct(name, port_yolo._c_in(f, i, 3, chs), args,
                                         SNNConfig())
            assert isinstance(m, port_yolo.PASS_BLOCKS.get(name) or
                              port_yolo.C2_BLOCKS.get(name) or port_yolo.EXTRA_BLOCKS[name])


def test_spec_only_rows_build_with_the_model_t_and_channels():
    """``mem_update`` takes the input's channels (its spread), ``Conv_7``
    the model's T (its weight ``[1, T, 1, 1, 1]``)."""
    with torch.device("meta"):
        m = port_yolo._construct("mem_update", 24, (), SNNConfig())
        c7 = port_yolo._construct("Conv_7", 24, (1, 1), SNNConfig(time_window=5))
    assert m.spread[0].weight.shape == (24, 1, 3, 3)
    assert c7.conv.weight.shape == (1, 5, 1, 1, 1)


def test_t_invariant_stem_blocks_are_jax():
    """The T-invariant stem blocks are JAX's set; probe-gelan's
    ``Conv_A`` / ``zeropad`` / ``Pools`` stem runs once at T=1 in both."""
    assert port_yolo._T_INVARIANT == jax_yolo._T_INVARIANT
    rows, save, _, _ = port_yolo.parse_model(chip_smoke.probe_cfg("probe-gelan"), 3)
    assert port_yolo._t_invariant_prefix(rows, save) == \
        jax_yolo._t_invariant_prefix(rows, save) == 3


@pytest.mark.parametrize("probe", sorted(chip_smoke.PROBES))
def test_probe_site_table_comes_from_the_model(probe):
    """``chip_smoke.PROBE_SITES`` against the probe's hooks at 640 px, T=4
    (``site_counts``): no site on K2."""
    model = port_yolo.build_model(chip_smoke.probe_cfg(probe), device="meta")
    got = site_counts(model)
    assert got == chip_smoke.PROBE_SITES[probe]
    assert got[2] == 0
