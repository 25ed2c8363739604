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


ANCHOR_FREE = ("res10v8.yaml", "res10v10.yaml", "res10-dual.yaml", "res10-triple.yaml",
               "res10-dualplain.yaml")


@pytest.mark.parametrize("cfg", ANCHOR_FREE)
def test_anchor_free_sites_and_launch_counts_come_from_the_model(cfg):
    """Every neuron site of the five YAMLs (a hook on the full-width model
    at 640 px, shapes only): a shape the K1 / K2 / K4 / K5 plan cases
    cover; the smoke script's table of sites and of the launches of the
    fused product and of the depthwise kernel in a T=4 training forward
    (by ``spread_route``; the SiLU sites of the plain-Conv towers take the
    library's convolutions)."""
    import chip_smoke
    from ecs_yolo_tpu_torch.models.yolo import build_model
    from ecs_yolo_tpu_torch.nn.blocks import MemUpdate
    from test_torch_port_k1 import HEAD_SITES, RES10_SITES

    model = build_model(cfg, nc=13, device="meta")
    seen = []
    for m in model.modules():
        if isinstance(m, MemUpdate):
            m.register_forward_pre_hook(lambda m, a: seen.append((tuple(a[0].shape[2:]), m.act)))
    sites = chip_smoke.site_shapes(model, MemUpdate, torch.zeros(1, 640, 640, 3, device="meta"))
    assert set(sites) <= set(RES10_SITES + HEAD_SITES)
    by_route = {"gemm": 0, "dw3": 0}
    for (h, w, c), act in seen:
        if not act:
            by_route[S.spread_route(c, w)] += chip_smoke.T - 1
            assert (S.plan_gemm if S.spread_route(c, w) == "gemm" else S.plan_dw3)(8, h, w, c)
    assert (len(seen), by_route["gemm"], by_route["dw3"]) == chip_smoke.HEAD_SITES[cfg]


# --- the bf16 kernel's tile plan ----------------------------------------------

PLAN_SHAPES = [(8, 320, 320, 64), (8, 160, 160, 64), (8, 40, 40, 64), (8, 20, 20, 64)] + [
    (2, hw[0], hw[1], c) for hw in ((5, 160), (5, 6)) for c in (16, 32, 48, 64)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_gemm_covers_every_output_pixel_once(shape):
    n, h, w, c = shape
    plan = S.plan_gemm(n, h, w, c)
    assert plan.th * plan.tw == S.GEMM_TILE_PX and plan.tw in (16, 32, 64)
    assert plan.stages >= 2 and plan.smem <= S.SMEM_PER_BLOCK
    assert S.GEMM_BLOCKS_PER_SM * (plan.smem + S.SMEM_RESERVED) <= S.SMEM_PER_SM
    assert plan.grid <= S.GEMM_BLOCKS_PER_SM * 132
    # every block's tiles, in the kernel's walk; every pixel of the plane once
    walk = np.concatenate([np.arange(b, plan.tiles, plan.grid) for b in range(plan.grid)])
    assert np.array_equal(np.sort(walk), np.arange(plan.tiles))
    i, h0, w0 = S.gemm_tile_origin(plan, h, w, walk)
    hits = np.zeros((n, h + plan.th, w + plan.tw), np.int64)
    for dy in range(plan.th):
        for dx in range(plan.tw):
            np.add.at(hits, (i, h0 + dy, w0 + dx), 1)
    assert (hits[:, :h, :w] == 1).all()
    if h % 8 == 0 and w % 16 == 0:              # the site shapes: no ragged edge
        assert (plan.th, plan.tw) == (8, 16) and hits.sum() == n * h * w


def _dyadic_inputs(n, h, w, c, seed):
    """Spikes and parameters that are multiples of 1/8 in [-1, 1]: every
    product of ``M`` is exact in bfloat16 and every sum exact in float32, so
    any order of summation gives the same bits."""
    rng = np.random.RandomState(seed)
    q = lambda *s: torch.from_numpy(rng.randint(-8, 9, s).astype(np.float32) / 8)
    s = torch.from_numpy((rng.rand(n, h, w, c) < 0.3).astype(np.float32))
    return s, q(3, 3, 1, c), q(c), q(1, 1, c, c), q(c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [16, 32, 48, 64])
@pytest.mark.parametrize("nhw,sms", [((2, 5, 6), 132), ((3, 1, 6), 1)],
                         ids=["2x5x6", "3x1x6-walk"])
def test_tile_walk_reference_is_the_plain_version_bit_for_bit(nhw, sms, c, dtype):
    s, dw, dwb, pw, pwb = (a.to(dtype) for a in _dyadic_inputs(*nhw, c, seed=c))
    plan = S.plan_gemm(*nhw, c, sms=sms)
    assert plan.tiles > plan.grid or sms != 1      # the walk case: tiles > blocks
    m, const = S.compose_m(dw, dwb, pw, pwb)
    got = S.gemm_tile_walk_reference(s.to(torch.int8), m, const, plan)
    want = S.packed_spread_reference(s, dw, dwb, pw, pwb)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)


# --- the depthwise kernel's plan (K4, and K7 on the same kernel) ----------------

# (shape, sms): ragged H and W, C = 8, 24, 128, 1024, N = 1 and 3, one SM
# (long strips) and the H100's 132
DW3_PLAN_CASES = [((1, 7, 9, 8), 132), ((3, 13, 21, 24), 132), ((1, 80, 80, 128), 132),
                  ((3, 20, 20, 1024), 132), ((3, 13, 21, 24), 1), ((1, 9, 7, 128), 1),
                  # the anchor-free heads' training sites on K4: GSConv's C = 8
                  ((8, 40, 40, 8), 132), ((8, 20, 20, 8), 132), ((8, 40, 40, 512), 132)]


@pytest.mark.parametrize("shape,sms", DW3_PLAN_CASES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else f"sms{v}")
def test_plan_dw3_covers_every_output_once(shape, sms):
    """Over the kernel's blocks, threads and strip rows every (pixel,
    channel group) of the plane is written once; one wave of blocks where
    the plane allows it."""
    n, h, w, c = shape
    g = c // 8
    plan = S.plan_dw3(n, h, w, c, sms)
    assert plan.gb * plan.tw == S.DW3_THREADS and g % plan.gb == 0
    assert plan.strips == -(-h // plan.rows)
    if plan.strips > 1:                                 # as many strips as a wave holds
        assert plan.grid <= sms * S.dw3_blocks_per_sm(2, 2) or plan.rows == 1
    i, h0, x0, g0 = S.dw3_block_origin(plan, w, c, np.arange(plan.grid))
    t = np.arange(S.DW3_THREADS)
    x = x0[:, None] + t // plan.gb                      # [block, thread]
    gg = g0[:, None] + t % plan.gb
    hits = np.zeros((n, h, w, g), np.int64)
    for r in range(plan.rows):
        y = h0[:, None] + r + 0 * t
        keep = (x < w) & (y < np.minimum(h0 + plan.rows, h)[:, None])
        np.add.at(hits, (np.broadcast_to(i[:, None], x.shape)[keep], y[keep], x[keep],
                         gg[keep]), 1)
    assert (hits == 1).all(), plan


def _dyadic_dw3(shape, seed):
    """A binary plane and dyadic weights and bias (multiples of 1/64, |k| <=
    1/4): every sum of the depthwise function is exact in float32."""
    rng = np.random.RandomState(seed)
    c = shape[-1]
    s = torch.from_numpy((rng.rand(*shape) < 0.3).astype(np.float32))
    k = torch.from_numpy(rng.randint(-16, 17, (3, 3, 1, c)).astype(np.float32) / 64)
    b = torch.from_numpy(rng.randint(-64, 65, c).astype(np.float32) / 64)
    return s, k, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,sms", [((2, 13, 21, 24), 132), ((1, 9, 7, 128), 1),
                                       ((1, 5, 20, 1024), 132)],
                         ids=["2x13x21x24", "1x9x7x128-sms1", "1x5x20x1024"])
def test_dw3_tile_walk_reference_is_the_plain_version_bit_for_bit(shape, sms, dtype):
    """The float-in mode (K4): the walk on the kernel's plan, from a binary
    plane in its own dtype, gives the plain version's bits and the int8
    plane ``s.to(int8)``."""
    s, k, b = (a.to(dtype) for a in _dyadic_dw3(shape, seed=shape[-1]))
    plan = S.plan_dw3(*shape, sms, s.element_size(), k.element_size())
    got, s8 = S.dw3_tile_walk_reference(s, k, b, plan)
    want = S.binary_dw3_conv_reference(s.to(torch.int8), k, b)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want) and torch.equal(s8, s.to(torch.int8))


def test_k4_launch_binds_once_and_launches_once_a_call(monkeypatch):
    """A stub library in place of the built one: over many calls the entry's
    argtypes are set once and the library loaded once; each call passes the
    float plane, the int8-out and out pointers, the dtype codes and the
    plan, counts one launch, and keeps the plane it wrote for the
    backward."""
    import ctypes

    from ecs_yolo_tpu_torch import _build

    calls, loads = [], []

    class Entry:
        def __init__(self):
            object.__setattr__(self, "binds", 0)

        def __setattr__(self, name, value):
            if name == "argtypes":
                object.__setattr__(self, "binds", self.binds + 1)
            object.__setattr__(self, name, value)

        def __call__(self, block):       # the launch's 18 int64 arguments
            calls.append(tuple((ctypes.c_longlong * 18).from_address(block)))
            return 0

    class Lib:
        spread_dw3_fwd = Entry()

    monkeypatch.setattr(_build, "load", lambda name: loads.append(name) or Lib)
    monkeypatch.setattr(S, "_entries", {})
    monkeypatch.setattr(S, "use_kernel", lambda x: True)
    monkeypatch.setattr(S, "_stream", lambda t: 7)
    s, k, b = (a.bfloat16() for a in _dyadic_dw3((2, 5, 6, 16), seed=0))
    s.requires_grad_(True)
    before = S.binary_dw3_conv.launches
    for _ in range(4):
        y = S.binary_dw3_conv(s, k, b)
    assert Lib.spread_dw3_fwd.binds == 1 and loads == ["spread_dw3"]
    assert S.binary_dw3_conv.launches == before + 4 and len(calls) == 4
    s8 = y.grad_fn.saved_tensors[0]
    assert s8.dtype == torch.int8 and s8.shape == s.shape
    plan = S.plan_dw3(2, 5, 6, 16, 132, 2, 2)
    assert calls[-1] == (1, 1, 1, s.data_ptr(), k.data_ptr(), b.data_ptr(), y.data_ptr(),
                         s8.data_ptr(), 2, 5, 6, 16, plan.rows, plan.strips, plan.tw, plan.gb,
                         plan.grid, 7)
