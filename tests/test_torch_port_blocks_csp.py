"""The star / GSConv / context-guide blocks and the CSP / HG / Ghost blocks
against the JAX package (CPU): ``StarBlock_2`` (stride 1 and 2),
``StarBlock_4``, ``StarBlock_5``, ``StarBlock_2C2f`` (stride 2, k 7),
``BasicBlock_6``, ``BasicBlock_1s``, ``ContextGuideFusionModule`` (with
``adjust``; H != W, so the two ELA profiles differ), ``C3``, ``C2f``,
``SPPF``, ``HGBlock`` (``lightconv`` both ways), ``ResNetLayerBasic`` (the
stem and a Ghost stage), ``BasicBlock_2C3``, ``BasicBlock_1C3`` and
``Concat_res2C3``, each in eval and in training with the moved BN
statistics; each block's JAX variables through ``models/convert.py`` with
``strict=True``; the conv/bn pairs ``fuse_conv_bn`` folds against JAX's
walk.  The parent blocks cover their parts: ``GhostConv`` and ``DWConv``
through ``GhostBottleneck``, ``DWConv`` and ``LightConv`` through
``HGBlock``, ``Bottleneck`` through ``C3`` and ``C2f``, ``ELA`` through the
fusion module, ``Shortcut`` through ``BasicBlock_6`` / ``_1s``.
``ClippedTPReLU``'s slope and ``ELA``'s 1-D conv and group-norm parameters
also against ``jax.grad``.  Every neuron site of ``C2f`` and
``StarBlock_2C2f`` takes the tensor-core kernel's layout.

Tolerances: float64 on both sides, 1e-9 (eval, where the port's neuron
sites take their kernels' plain versions, training, and the gradients).
"""

import flax.linen as flax_nn
import jax
import numpy as np
import pytest
import torch

from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu.models import utils as JMU
from ecs_yolo_tpu.nn import blocks_ext as JBX
from ecs_yolo_tpu.nn import blocks_star as JBS
from ecs_yolo_tpu.nn import blocks_tail as JBT
from ecs_yolo_tpu.nn import blocks_tail2 as JBT2
from ecs_yolo_tpu.nn import blocks_v9 as JBV
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.models import convert as CV
from ecs_yolo_tpu_torch.models import utils as PMU
from ecs_yolo_tpu_torch.nn import blocks as PB
from ecs_yolo_tpu_torch.nn import blocks_ext as PBX
from ecs_yolo_tpu_torch.nn import blocks_star as PBS
from ecs_yolo_tpu_torch.nn import blocks_tail as PBT
from ecs_yolo_tpu_torch.nn import blocks_tail2 as PBT2
from ecs_yolo_tpu_torch.nn import blocks_v9 as PBV
from ecs_yolo_tpu_torch.snn import ecs_lif as K
from test_torch_port_heads import _FAST, _assert_tree_close, _jax_f64
from test_torch_port_model import _random_variables, _x

torch.set_num_threads(2)

T = 2
JSNN = JaxSNNConfig(time_window=T)
SNN = SNNConfig(time_window=T)

# case -> (registry name for the converter, JAX block, port block, input
# shape(s) [T, N, H, W, C])
BLOCKS = {
    "StarBlock_2-s1": ("StarBlock_2", lambda: JBX.StarBlock_2(8, 3, 1, 2, snn=JSNN),
                       lambda: PBX.StarBlock_2(8, 8, 3, 1, 2, snn=SNN), (T, 2, 6, 6, 8)),
    "StarBlock_2-s2": ("StarBlock_2", lambda: JBX.StarBlock_2(16, 3, 2, 2, snn=JSNN),
                       lambda: PBX.StarBlock_2(8, 16, 3, 2, 2, snn=SNN), (T, 2, 8, 8, 8)),
    "StarBlock_4": ("StarBlock_4", lambda: JBS.StarBlock_4(16, 3, 2, 4, snn=JSNN),
                    lambda: PBS.StarBlock_4(8, 16, 3, 2, 4, snn=SNN), (T, 2, 8, 8, 8)),
    "StarBlock_5": ("StarBlock_5", lambda: JBS.StarBlock_5(16, 3, 2, 4, snn=JSNN),
                    lambda: PBS.StarBlock_5(8, 16, 3, 2, 4, snn=SNN), (T, 2, 8, 8, 8)),
    "StarBlock_2C2f": ("StarBlock_2C2f", lambda: JBS.StarBlock_2C2f(16, 1, 7, 2, 2, snn=JSNN),
                       lambda: PBS.StarBlock_2C2f(8, 16, 1, 7, 2, 2, snn=SNN),
                       (T, 2, 16, 16, 8)),
    "BasicBlock_6": ("BasicBlock_6", lambda: JBX.BasicBlock_6(16, 3, 2, snn=JSNN),
                     lambda: PBX.BasicBlock_6(8, 16, 3, 2, snn=SNN), (T, 2, 8, 8, 8)),
    "BasicBlock_1s": ("BasicBlock_1s", lambda: JBX.BasicBlock_1s(8, 1, snn=JSNN),
                      lambda: PBX.BasicBlock_1s(16, 8, 1, snn=SNN), (T, 1, 2, 2, 16)),
    "ContextGuideFusionModule": (
        "ContextGuideFusionModule", lambda: JBT.ContextGuideFusionModule(2, snn=JSNN),
        lambda: PBT.ContextGuideFusionModule((8, 16), 2, snn=SNN),
        [(T, 2, 5, 7, 8), (T, 2, 5, 7, 16)]),
    "C3": ("C3", lambda: JBX.C3(16, 2, snn=JSNN), lambda: PBX.C3(8, 16, 2, snn=SNN),
           (T, 2, 6, 6, 8)),
    "C2f": ("C2f", lambda: JBX.C2f(16, 2, True, snn=JSNN),
            lambda: PBX.C2f(8, 16, 2, True, snn=SNN), (T, 2, 6, 6, 8)),
    "SPPF": ("SPPF", lambda: JBX.SPPF(16, 5, snn=JSNN), lambda: PBX.SPPF(16, 16, 5, snn=SNN),
             (T, 2, 7, 7, 16)),
    "HGBlock": ("HGBlock", lambda: JBT.HGBlock(8, 16, 3, 2, 2, snn=JSNN),
                lambda: PBT.HGBlock(8, 8, 16, 3, 2, 2, snn=SNN), (T, 2, 8, 8, 8)),
    "HGBlock-lightconv": ("HGBlock", lambda: JBT.HGBlock(8, 16, 3, 2, 1, True, True, snn=JSNN),
                          lambda: PBT.HGBlock(16, 8, 16, 3, 2, 1, True, True, snn=SNN),
                          (T, 2, 6, 6, 16)),
    "ResNetLayerBasic-first": ("ResNetLayerBasic",
                               lambda: JBT2.ResNetLayerBasic(16, 3, 2, True, 1, snn=JSNN),
                               lambda: PBT2.ResNetLayerBasic(3, 16, 3, 2, True, 1, snn=SNN),
                               (T, 2, 16, 16, 3)),
    "ResNetLayerBasic": ("ResNetLayerBasic",
                         lambda: JBT2.ResNetLayerBasic(16, 3, 2, False, 2, snn=JSNN),
                         lambda: PBT2.ResNetLayerBasic(8, 16, 3, 2, False, 2, snn=SNN),
                         (T, 2, 8, 8, 8)),
    "BasicBlock_2C3": ("BasicBlock_2C3", lambda: JBV.BasicBlock_2C3(16, 1, 3, 2, snn=JSNN),
                       lambda: PBV.BasicBlock_2C3(8, 16, 1, 3, 2, snn=SNN), (T, 2, 8, 8, 8)),
    "BasicBlock_1C3": ("BasicBlock_1C3", lambda: JBV.BasicBlock_1C3(16, 1, 1, snn=JSNN),
                       lambda: PBV.BasicBlock_1C3(8, 16, 1, 1, snn=SNN), (T, 1, 2, 2, 8)),
    "Concat_res2C3": ("Concat_res2C3", lambda: JBV.Concat_res2C3(32, 1, 3, 2, snn=JSNN),
                      lambda: PBV.Concat_res2C3(16, 32, 1, 3, 2, snn=SNN), (T, 2, 8, 8, 16)),
}

#: the cases with 1024-wide hidden sites (``BasicBlock_1s``'s and
#: ``BasicBlock_1``'s fixed width)
WIDE = {"BasicBlock_1s", "BasicBlock_1C3"}
#: the modules whose conv/bn pair both folds take, per case
FOLDED = {
    "StarBlock_2-s1": {"f1", "f2", "g"}, "StarBlock_4": set(), "StarBlock_5": set(),
    "BasicBlock_6": {"shortcut", "conv1.cv1", "conv1.cv2", "conv2.cv1", "conv2.cv2"},
    "ContextGuideFusionModule": set(), "SPPF": {"cv1", "cv2"},
    "HGBlock-lightconv": {"m0.conv1", "m0.conv2.conv", "m1.conv1", "m1.conv2.conv", "sc", "ec"},
    "ResNetLayerBasic-first": {"stem"}, "BasicBlock_1C3": {"cv1", "cv2", "cv3"},
}


def _folded_in_jax(block: str, v) -> set:
    """The modules whose conv/bn pair JAX's ``fuse_conv_bn`` folds (those
    whose BN running mean it resets to zero), under the torch names; one
    compile."""
    stats = jax.jit(JMU.fuse_conv_bn, compiler_options=_FAST)(v)["batch_stats"]
    sd = CV.convert_block(block, {}, stats, leaf=lambda b, p, w: w)
    end = "bn.bn.running_mean"
    return {k[:-len(end)].rstrip(".") for k, w in sd.items()
            if (k == end or k.endswith("." + end)) and not np.asarray(w).any()}


def _inputs(shape, seed):
    if isinstance(shape, list):
        return [_x(s, seed + i) for i, s in enumerate(shape)]
    return _x(shape, seed)


def _torch(x):
    if isinstance(x, list):
        return [torch.from_numpy(a).double() for a in x]
    return torch.from_numpy(x).double()


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_block_matches_jax_f64_in_eval_and_training(case):
    """Eval output, training output and the moved BN statistics in float64;
    the JAX variables load with ``strict=True``; the folded pairs are
    JAX's."""
    name, jax_mod, port_mod, shape = BLOCKS[case]
    x = _inputs(shape, seed=len(case))
    # the 1024-wide sites run faster fully optimised than the cheap compile saves
    opts = {} if case in WIDE else _FAST
    v, (want, (want_t, upd)) = _jax_f64(jax_mod(), x, seed=len(case) + 1, training=True,
                                        compiler_options=opts)
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
    want_folded = _folded_in_jax(name, v)
    assert set(PMU.fuse_conv_bn(block)) == want_folded
    if case in FOLDED:
        assert want_folded == FOLDED[case]


# --- the new parameter kinds' gradients ---------------------------------------------

GRADS = {
    "ClippedTPReLU": (lambda: JBS.ClippedTPReLU(), lambda: PBS.ClippedTPReLU(8),
                      (T, 2, 3, 3, 8)),
    "ELA": (lambda: JBT.ELA(snn=JSNN), lambda: PBT.ELA(32), (T, 2, 5, 7, 32)),
}


@pytest.mark.parametrize("name", sorted(GRADS))
def test_new_parameter_gradients_match_jax_grad(name):
    """``sum(block(x) * r)``'s gradients with respect to every parameter
    and to x, in float64, against ``jax.grad`` (one cheap-compile jit).
    ClippedTPReLU's input is scaled so that some of it passes 6."""
    jax_mod, port_mod, shape = GRADS[name]
    x = _x(shape, seed=11) * (8.0 if name == "ClippedTPReLU" else 1.0)
    r = _x(shape, seed=12)
    module = jax_mod()
    # ClippedTPReLU's field ``init`` hides the module's method of that name
    v = _random_variables(lambda: flax_nn.Module.init(module, jax.random.PRNGKey(0), x),
                          seed=13)

    def loss(params, x_):
        return (module.apply({"params": params}, x_) * r).sum()

    with jax.enable_x64():
        p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v["params"])
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)), compiler_options=_FAST)(
            p64, np.asarray(x, np.float64))
    block = port_mod().double()
    block.load_state_dict({k: t.double() for k, t in CV.convert_block(
        name, v["params"]).items()}, strict=True)
    xt = torch.from_numpy(x).double().requires_grad_(True)
    (block(xt) * torch.from_numpy(r).double()).sum().backward()
    want = CV.convert_block(name, jax.tree_util.tree_map(np.asarray, gp))
    assert set(want) == {k for k, _ in block.named_parameters()}
    for k, p in block.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), atol=1e-9, rtol=1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-9, rtol=1e-9)
    if name == "ClippedTPReLU":
        assert (x > 6).any() and (x < 0).any()


# --- the C2f split and the neuron sites' layout ------------------------------------


@pytest.mark.parametrize("name", ["C2f", "StarBlock_2C2f"])
def test_c2f_sites_take_the_tensor_core_layout(name):
    """At every neuron site of ``C2f`` and ``StarBlock_2C2f`` the
    tensor-core kernel takes the input's layout (``layout_refusal`` is
    None): the first inner block gets a dense copy of ``cv1``'s second
    half, whose view it would refuse."""
    block = (PBX.C2f(16, 32, 2, True, snn=SNN) if name == "C2f"
             else PBS.StarBlock_2C2f(16, 32, 1, 7, 2, 2, snn=SNN)).eval()
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append(K.layout_refusal(a[0])))
             for m in block.modules() if isinstance(m, PB.MemUpdate)]
    with torch.no_grad():
        block(torch.from_numpy(_x((T, 2, 16, 16, 16), 3)))
    for h in hooks:
        h.remove()
    assert len(seen) == (6 if name == "C2f" else 8)
    assert seen == [None] * len(seen)
    y = torch.zeros(T, 2, 8, 8, 2 * block.c)
    assert K.layout_refusal(y[..., block.c:]) is not None


def test_drop_path_draws_only_when_training_with_a_generator():
    """Rate 0, eval, or no generator: the identity; training with a
    generator: each step of T kept (scaled by ``1 / keep``) or dropped,
    from the generator's draws."""
    x = torch.from_numpy(_x((8, 2, 3, 3, 4), 5)).double()
    drop = PBX.DropPath(0.5)
    assert drop.eval()(x) is x and drop.train()(x) is x
    assert PBX.DropPath(0.0).train()(x) is x
    drop.generator = torch.Generator().manual_seed(1)
    y = drop(x)
    kept = (y == 2 * x).flatten(1).all(1)
    dropped = (y == 0).flatten(1).all(1)
    assert bool((kept | dropped).all()) and kept.any() and dropped.any()
    drop.generator = torch.Generator().manual_seed(1)
    assert torch.equal(drop(x), y)
