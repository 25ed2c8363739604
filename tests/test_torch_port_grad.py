"""Gradients of the port's spiking core and blocks against ``jax.grad`` of
the JAX package (CPU), on the same numpy inputs and weights.

Everything runs in float64 on both sides (JAX inside ``jax.enable_x64()``):
no membrane then lands within rounding of the threshold or of the surrogate
window's edge, so spikes and windows agree exactly and values and gradients
agree to reassociation.  Tolerance atol 1e-9 (rtol 1e-9 for blocks, whose
BN gradients sum thousands of terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu.nn import blocks as JB
from ecs_yolo_tpu.nn import heads as JH
from ecs_yolo_tpu.snn import neuron as JN
from ecs_yolo_tpu.snn.surrogate import heaviside as jax_heaviside
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.models import convert as CV
from ecs_yolo_tpu_torch.nn import blocks as PB
from ecs_yolo_tpu_torch.nn import heads as PH
from ecs_yolo_tpu_torch.snn import neuron as PN
from ecs_yolo_tpu_torch.snn.spread import make_kernel_spread
from ecs_yolo_tpu_torch.snn.surrogate import heaviside
from test_torch_port_model import _random_variables, _x

torch.set_num_threads(2)


def _t64(a):
    return torch.from_numpy(np.asarray(a, np.float64)).requires_grad_(True)


def test_heaviside_forward_and_surrogate_backward_match_jax():
    rng = np.random.RandomState(0)
    u = rng.randn(4, 50) * 0.8 + 0.5
    g = rng.randn(4, 50)
    for thresh, lens in ((0.5, 0.5), (0.3, 0.25)):
        with jax.enable_x64():
            want, vjp = jax.vjp(lambda a: jax_heaviside(a, thresh, lens),
                                jnp.asarray(u))
            (want_g,) = vjp(jnp.asarray(g))
        ut = _t64(u)
        got = heaviside(ut, thresh, lens)
        (got_g,) = torch.autograd.grad(got, ut, torch.from_numpy(g))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-12)
    # only the boolean window is kept for the backward, not the membrane
    saved = heaviside(_t64(u), 0.5, 0.5).grad_fn.saved_tensors
    assert [t.dtype for t in saved] == [torch.bool]
    # a bfloat16 membrane is compared in float32 and spikes stay bfloat16
    ub = torch.tensor([0.4999, 0.5, 0.5039], dtype=torch.bfloat16)
    assert heaviside(ub).tolist() == [0.0, 0.0, 1.0]


def _scan_inputs(shape, seed):
    c = shape[-1]
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape) * 2 - 0.5, (rng.rand(3, 3, 1, c) - 0.5) * 0.4,
            (rng.rand(c) - 0.5) * 0.2, (rng.rand(1, 1, c, c) - 0.5) * 0.2,
            (rng.rand(c) - 0.5) * 0.2, rng.randn(*shape))


def _jax_spread(dw, dwb, pw, pwb):
    c = dw.shape[-1]

    def spread(s):
        d = jax.lax.conv_general_dilated(
            s, dw, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=c) + dwb
        return jax.lax.conv_general_dilated(
            d, pw, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + pwb

    return spread


# T=4 at a width the fused dw+pw product takes, T=5 at one the depthwise takes
@pytest.mark.parametrize("act", [False, True], ids=["heaviside", "silu"])
@pytest.mark.parametrize("shape", [(4, 2, 6, 8, 16), (5, 1, 5, 6, 24)],
                         ids=["T4-gemm", "T5-dw3"])
def test_ecs_lif_scan_forward_and_grads_match_jax_f64(shape, act):
    x, dw, dwb, pw, pwb, w = _scan_inputs(shape, seed=shape[0])
    T = shape[0]
    with jax.enable_x64():
        def loss(x_, *p):
            sp = JN.ecs_lif_scan(x_, _jax_spread(*p), JaxSNNConfig(time_window=T),
                                 act=act)
            return jnp.sum(sp * w), sp
        (_, want), want_g = jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
                *(jnp.asarray(a) for a in (x, dw, dwb, pw, pwb)))
    ts = [_t64(a) for a in (x, dw, dwb, pw, pwb)]
    make = PN.make_spread if act else make_kernel_spread
    got = PN.ecs_lif_scan(ts[0], make(*ts[1:]), SNNConfig(time_window=T), act)
    got_g = torch.autograd.grad((got * torch.from_numpy(w)).sum(), ts)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-9)
    for a, b, name in zip(got_g, want_g, ("dx", "ddw", "ddwb", "dpw", "dpwb")):
        assert float(np.abs(np.asarray(b)).max()) > 0, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9,
                                   err_msg=name)


@pytest.mark.parametrize("act", [False, True], ids=["heaviside", "silu"])
@pytest.mark.parametrize("T", [4, 5])
def test_lif_scan_forward_and_grad_match_jax_f64(T, act):
    rng = np.random.RandomState(T)
    x, w = rng.randn(T, 2, 5, 6, 7), rng.randn(T, 2, 5, 6, 7)
    with jax.enable_x64():
        want, want_g = jax.value_and_grad(lambda x_: jnp.sum(
            JN.lif_scan(x_, JaxSNNConfig(), act=act) * w))(jnp.asarray(x))
    xt = _t64(x)
    got = (PN.lif_scan(xt, SNNConfig(), act) * torch.from_numpy(w)).sum()
    (got_g,) = torch.autograd.grad(got, xt)
    np.testing.assert_allclose(got.item(), float(want), atol=1e-9)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-9)


@pytest.mark.parametrize("T", [4, 5])
def test_lif_node_scan_keeps_the_reset_gradient_as_jax_f64(T):
    rng = np.random.RandomState(10 + T)
    x, w = rng.randn(T, 2, 4, 4, 6) + 0.5, rng.randn(T, 2, 4, 4, 6)
    tau, v_th = 0.25, 0.1
    with jax.enable_x64():
        def loss(x_):
            sp = JN.lif_node_scan(x_, tau, v_th, JaxSNNConfig())
            return jnp.sum(sp * w), sp
        (_, want), want_g = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(x))
    xt = _t64(x)
    got = PN.lif_node_scan(xt, tau, v_th, SNNConfig())
    (got_g,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), xt)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-9)
    np.testing.assert_allclose(float(PN.firing_rate(got)),
                               float(JN.firing_rate(jnp.asarray(want, jnp.float32))),
                               atol=1e-6)
    # the detached-reset scan gives another gradient on the same input
    (g_det,) = torch.autograd.grad(
        (PN.lif_scan(xt, SNNConfig(decay=tau)) * torch.from_numpy(w)).sum(), xt)
    assert not np.allclose(g_det.numpy(), got_g.numpy())


@pytest.mark.parametrize("c,act", [(16, False), (24, False), (16, True)],
                         ids=["gemm", "dw3", "silu"])
def test_mem_update_module_training_mode_matches_jax_f64(c, act):
    """The neuron module itself in training mode (the route that runs the
    spread kernels on the card): spikes, the gradient w.r.t. the input and
    the four spread parameters, and the recorded firing rate."""
    shape = (3, 2, 6, 8, c)
    x, w = _x(shape, seed=c), np.random.RandomState(c).randn(*shape)
    mod = JB.MemUpdate(act=act, snn=JaxSNNConfig(time_window=3))
    v = _random_variables(lambda: mod.init(
        jax.random.PRNGKey(0), jnp.asarray(x), training=False), seed=5)
    with jax.enable_x64():
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     v["params"])

        def loss(params, x_):
            sp = mod.apply({"params": params}, x_, training=True)
            return jnp.sum(sp * w), sp
        (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p64, jnp.asarray(x, jnp.float64))
    pm = PB.MemUpdate(c, act=act, snn=SNNConfig(time_window=3)).double().train()
    to_torch = lambda tree: {CV._LEAVES[k]: torch.from_numpy(np.array(
        CV._layout("MemUpdate", k, np.asarray(a, np.float64))))
        for k, a in tree.items()}
    pm.load_state_dict(to_torch(v["params"]), strict=True)
    xt = _t64(x)
    got = pm(xt)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-9)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-9)
    params = dict(pm.named_parameters())
    for k, g in to_torch(gp).items():
        assert float(g.abs().max()) > 0, k
        np.testing.assert_allclose(params[k].grad.numpy(), g.numpy(), atol=1e-9,
                                   err_msg=k)
    if act:
        assert pm.firing_rate is None
    else:
        np.testing.assert_allclose(float(pm.firing_rate), np.asarray(want).mean(),
                                   atol=1e-6)


T = 2
ANCHORS = ((0.625, 0.875, 1.4375, 1.6875, 2.3125, 3.625),
           (2.53125, 2.5625, 4.21875, 5.28125, 10.75, 9.96875))
TRAIN_BLOCKS = {
    # id: (name, jax module(snn), port module(snn), input shape(s))
    "Conv_1": ("Conv_1", lambda s: JB.Conv_1(8, 7, 2, snn=s),
               lambda s: PB.Conv_1(3, 8, 7, 2, snn=s), (T, 2, 16, 16, 3)),
    "BasicBlock_2-s2": ("BasicBlock_2", lambda s: JB.BasicBlock_2(16, 3, 2, snn=s),
                        lambda s: PB.BasicBlock_2(8, 16, 3, 2, snn=s),
                        (T, 2, 16, 16, 8)),
    "BasicBlock_2-s1": ("BasicBlock_2", lambda s: JB.BasicBlock_2(8, 3, 1, snn=s),
                        lambda s: PB.BasicBlock_2(8, 8, 3, 1, snn=s),
                        (T, 2, 8, 8, 8)),
    "Concat_res2": ("Concat_res2", lambda s: JB.Concat_res2(32, 3, 2, snn=s),
                    lambda s: PB.Concat_res2(16, 32, 3, 2, snn=s),
                    (T, 2, 16, 16, 16)),
    "BasicBlock_1": ("BasicBlock_1", lambda s: JB.BasicBlock_1(16, 1, snn=s),
                     lambda s: PB.BasicBlock_1(8, 16, 1, snn=s), (T, 1, 4, 4, 8)),
    "Detect": ("Detect", lambda s: JH.Detect(2, ANCHORS, (16.0, 32.0), snn=s),
               lambda s: PH.Detect(2, ANCHORS, (16.0, 32.0), [16, 32], s),
               [(T, 2, 4, 4, 16), (T, 2, 2, 2, 32)]),
}
CASES = [(k, True) for k in TRAIN_BLOCKS] + [("Conv_1", False),
                                             ("BasicBlock_2-s2", False)]


@pytest.mark.parametrize("block,bn_custom_vjp", CASES,
                         ids=[f"{k}-vjp{int(v)}" for k, v in CASES])
def test_block_training_mode_matches_jax_f64(block, bn_custom_vjp):
    """Training mode: outputs, updated BN running statistics and the
    gradient of a scalar loss w.r.t. every parameter and the input, with the
    JAX BN backward both closed-form (``bn_custom_vjp``) and plain AD."""
    name, jax_mod, port_mod, shape = TRAIN_BLOCKS[block]
    many = isinstance(shape, list)
    xs = [_x(s, seed=7 + i) for i, s in enumerate(shape)] if many \
        else _x(shape, seed=len(block))
    mod = jax_mod(JaxSNNConfig(time_window=T, bn_custom_vjp=bn_custom_vjp))
    as_j = lambda f: [f(a) for a in xs] if many else f(xs)
    v = _random_variables(lambda: mod.init(
        jax.random.PRNGKey(0), as_j(lambda a: jnp.asarray(a, jnp.float32)),
        training=False), seed=1)
    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)

        def loss(params, x_):
            out, upd = mod.apply({**v64, "params": params}, x_, training=True,
                                 mutable=["batch_stats"])
            outs = out if isinstance(out, (list, tuple)) else [out]
            ws = [np.random.RandomState(3 + i).randn(*o.shape)
                  for i, o in enumerate(outs)]
            return sum(jnp.sum(o * w) for o, w in zip(outs, ws)), (outs, upd, ws)

        (_, (want, upd, ws)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(
                v64["params"], as_j(lambda a: jnp.asarray(a, jnp.float64)))
        want = [np.asarray(o) for o in want]
        ws = [np.array(w) for w in ws]

    pm = port_mod(SNNConfig(time_window=T)).double().train()
    pm.load_state_dict({k: t.double() for k, t in CV.convert_block(
        name, v["params"], v.get("batch_stats")).items()}, strict=True)
    xt = [_t64(a) for a in xs] if many else _t64(xs)
    out = pm(xt)
    outs = out if isinstance(out, (list, tuple)) else [out]
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, ws)).backward()

    for o, w in zip(outs, want):
        np.testing.assert_allclose(o.detach().numpy(), w, atol=1e-9, rtol=1e-9)
    stats = CV.convert_block(name, {}, upd.get("batch_stats", {}))
    grads = CV.convert_block(name, gp)
    sd = pm.state_dict()
    assert set(grads) | set(stats) == set(sd)
    for k, t in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), t.numpy(), atol=1e-12,
                                   err_msg=k)
    params = dict(pm.named_parameters())
    for k, t in grads.items():
        assert float(t.abs().max()) > 0, k
        np.testing.assert_allclose(params[k].grad.numpy(), t.numpy(), atol=1e-9,
                                   rtol=1e-9, err_msg=k)
    for a, b in zip(xt if many else [xt], gx if many else [gx]):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=1e-9,
                                   rtol=1e-9)
    sites = [m for m in pm.modules() if isinstance(m, PB.MemUpdate)]
    assert all(0.0 <= float(m.firing_rate) <= 1.0 for m in sites)
