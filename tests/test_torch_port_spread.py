"""The port's spread functions (``ecs_yolo_tpu_torch/snn/spread.py``) against
the JAX package's Pallas spread kernels (``ecs_yolo_tpu/snn/pallas_dw.py``)
in interpret mode, on the same numpy inputs (CPU).

On the CPU the port's wrappers take their plain versions in the forward and
their own (hand-written) convolution gradients in the backward, which is the
backward the card runs too.

Tolerances (float32): forward rtol 1e-5 / atol 1e-6 and K4 gradients rtol
1e-5, K5 gradients rtol 1e-4 / atol 1e-6 -- those of the JAX package's own
tests of these kernels (``tests/test_pallas_kernels.py:153-218``); the two
frameworks' convolutions sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecs_yolo_tpu.snn.packed_spread import pack_w, unpack_w
from ecs_yolo_tpu.snn.pallas_dw import (_compose_m, binary_dw3_conv as
                                        jax_binary_dw3_conv,
                                        packed_spread_pallas)
from ecs_yolo_tpu_torch.snn import spread as S
from ecs_yolo_tpu_torch.snn.neuron import make_spread
from ecs_yolo_tpu_torch.snn.route import plain_kernels, plain_route, use_kernel

torch.set_num_threads(2)


def _spread_inputs(n, h, w, c, seed):
    rng = np.random.RandomState(seed)
    s = (rng.rand(n, h, w, c) > 0.7).astype(np.float32)
    dw = ((rng.rand(3, 3, 1, c) - 0.5) * 0.2).astype(np.float32)
    dwb = ((rng.rand(c) - 0.5) * 0.1).astype(np.float32)
    pw = ((rng.rand(1, 1, c, c) - 0.5) * 0.05).astype(np.float32)
    pwb = ((rng.rand(c) - 0.5) * 0.1).astype(np.float32)
    return s, dw, dwb, pw, pwb


def _torch_grads(fn, arrays):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y = fn(*ts)
    return y.detach().numpy(), [g.numpy() for g in torch.autograd.grad(
        (y * y).sum(), ts)]


@pytest.mark.parametrize("fn", [S.binary_dw3_conv, S.binary_dw3_conv_reference],
                         ids=["wrapper", "plain"])
def test_binary_dw3_conv_matches_pallas(fn):
    s, k, b, _, _ = _spread_inputs(2, 16, 8, 128, seed=0)
    args = [jnp.asarray(a) for a in (s, k, b)]
    want = np.asarray(jax_binary_dw3_conv(*args))
    want_g = jax.grad(lambda *a: jnp.sum(jnp.square(jax_binary_dw3_conv(*a))),
                      argnums=(0, 1, 2))(*args)
    got, got_g = _torch_grads(fn, (s, k, b))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for a, w, name in zip(got_g, want_g, ("ds", "dk", "db")):
        np.testing.assert_allclose(a, np.asarray(w), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("fn", [S.packed_spread, S.packed_spread_reference],
                         ids=["wrapper", "plain"])
def test_packed_spread_matches_pallas_on_the_packed_layout(fn):
    arrays = _spread_inputs(2, 16, 16, 64, seed=1)
    s, *params = [jnp.asarray(a) for a in arrays]

    def packed(s_, *p):             # the TPU kernel's width-packed layout
        return unpack_w(packed_spread_pallas(pack_w(s_, 2), *p), 2)

    want = np.asarray(packed(s, *params))
    want_g = jax.grad(lambda *a: jnp.sum(jnp.square(packed(*a))),
                      argnums=(0, 1, 2, 3, 4))(s, *params)
    got, got_g = _torch_grads(fn, arrays)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for a, w, name in zip(got_g, want_g, ("ds", "ddw", "ddwb", "dpw", "dpwb")):
        np.testing.assert_allclose(a, np.asarray(w), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_compose_m_matches_jax():
    _, *params = _spread_inputs(1, 2, 2, 16, seed=2)
    m, const = S.compose_m(*(torch.from_numpy(a) for a in params))
    jm, jconst = _compose_m(*(jnp.asarray(a) for a in params))
    assert const.dtype == torch.float32
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-7)
    np.testing.assert_allclose(const.numpy(), np.asarray(jconst), rtol=1e-6,
                               atol=1e-8)
    # bfloat16 parameters: M stays bfloat16 (rounded once), const widens
    m16, c16 = S.compose_m(*(torch.from_numpy(a).bfloat16() for a in params))
    assert m16.dtype == torch.bfloat16 and c16.dtype == torch.float32


@pytest.mark.parametrize("c,w,route", [(16, 8, "gemm"), (64, 6, "gemm"),
                                       (24, 8, "dw3"), (16, 7, "dw3"),
                                       (128, 8, "dw3")])
def test_kernel_spread_is_the_spread_in_f64(c, w, route):
    """Either route computes ``pw1x1(dw3x3(s) + dwb) + pwb``: against the
    library-convolution spread in float64, values and all five gradients to
    1e-12 (reassociation only)."""
    assert S.spread_route(c, w) == route
    arrays = [a.astype(np.float64) for a in _spread_inputs(2, 5, w, c, seed=c + w)]
    gy = np.random.RandomState(3).randn(2, 5, w, c)

    def run(make):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        y = make(*ts[1:])(ts[0])
        return [y.detach()] + list(torch.autograd.grad(
            y, ts, torch.from_numpy(gy)))

    for a, b in zip(run(S.make_kernel_spread), run(make_spread)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12, rtol=1e-12)


def test_wrappers_on_cpu_take_the_plain_version_and_launch_nothing():
    s, dw, dwb, pw, pwb = (torch.from_numpy(a) for a in
                           _spread_inputs(1, 4, 4, 16, seed=5))
    before = S.binary_dw3_conv.launches, S.packed_spread.launches
    assert torch.equal(S.binary_dw3_conv(s, dw, dwb),
                       S.binary_dw3_conv_reference(s, dw, dwb))
    assert torch.equal(S.packed_spread(s, dw, dwb, pw, pwb),
                       S.packed_spread_reference(s, dw, dwb, pw, pwb))
    assert (S.binary_dw3_conv.launches, S.packed_spread.launches) == before
    # bfloat16: one rounding, from a float32 sum
    y16 = S.binary_dw3_conv(s.bfloat16(), dw, dwb)
    want = S.binary_dw3_conv_reference(s, dw.bfloat16().float(),
                                       dwb.bfloat16().float()).bfloat16()
    assert y16.dtype == torch.bfloat16 and torch.equal(y16, want)


def test_route_sends_cuda_to_the_kernel_unless_plain_is_asked():
    cpu, meta = torch.zeros(1), torch.zeros(1, device="meta")

    class OnCard:
        device = torch.device("cuda", 0)

    assert not use_kernel(cpu) and use_kernel(OnCard())
    with pytest.raises(ValueError, match="CUDA or CPU"):
        use_kernel(meta)
    with plain_kernels():
        assert plain_route() and not use_kernel(OnCard())
        with plain_kernels():
            assert plain_route()
        assert plain_route()
    assert not plain_route() and use_kernel(OnCard())


def test_kernel_checks_reject_what_the_kernels_do_not_take():
    s8 = torch.zeros(2, 4, 6, 32, dtype=torch.int8)
    k, b = torch.zeros(3, 3, 1, 32), torch.zeros(32)
    S._check("k", s8, 16, k=(k, (3, 3, 1, 32)), b=(b, (32,)))
    with pytest.raises(ValueError, match="contiguous"):
        S._check("k", s8.transpose(1, 2), 8)
    with pytest.raises(ValueError, match="C % 16"):
        S._check("k", s8[..., :8].contiguous(), 16)
    with pytest.raises(ValueError, match=r"\[N, H, W, C\]"):
        S._check("k", s8[0], 8)
    with pytest.raises(ValueError, match="k must be"):
        S._check("k", s8, 8, k=(k[..., :8], (3, 3, 1, 32)))
    with pytest.raises(ValueError, match="is on meta"):
        S._check("k", s8, 8, b=(b.to("meta"), (32,)))


def test_res10_sites_and_launch_counts_come_from_the_model():
    """The smoke script's site table: a forward hook on the full-width
    res10 at 640 px (shapes only, on the meta device) sees 24 neuron sites
    in 9 shapes; by ``spread_route`` a T=4 training forward launches the
    fused product 5 x 3 times and the depthwise kernel 19 x 3 times."""
    import chip_smoke
    from ecs_yolo_tpu_torch.models.yolo import build_model
    from ecs_yolo_tpu_torch.nn.blocks import MemUpdate

    model = build_model("resnet10.yaml", nc=13, device="meta")
    sites = chip_smoke.site_shapes(model, MemUpdate,
                                   torch.zeros(1, 640, 640, 3, device="meta"))
    assert dict(sites) == {
        (320, 320, 64): 1, (160, 160, 64): 4, (80, 80, 128): 3, (40, 40, 384): 2,
        (40, 40, 256): 4, (20, 20, 1024): 1, (20, 20, 512): 4, (20, 20, 256): 4,
        (20, 20, 128): 1}
    steps = chip_smoke.T - 1
    by_route = {"gemm": 0, "dw3": 0}
    for (h, w, c), n in sites.items():
        by_route[S.spread_route(c, w)] += n * steps
    assert by_route == {"gemm": 15, "dw3": 57}
