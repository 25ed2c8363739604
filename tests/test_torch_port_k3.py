"""K3's plan, its walk and its launch path (CPU).

K3 (``snn/fused.ecs_lif_fused_v2``, ``csrc/ecs_lif_v2.cu``) runs every step
of a site in one cooperative launch over (tile x Cout slice) items, as K1
does, with K2's depthwise rounding and the recurrence's state in the
block's shared memory where it fits.  The CUDA kernel runs only on the
card; here the plan that drives it (``plan_k3``, ``k3_block_items``) is
checked for coverage, fit, occupancy and the state's place, the kernel's
walk in plain PyTorch (``k3_grid_walk_reference``) is held to the plain
version and to the JAX TPU kernel, ``block_rows`` is held to its contract,
and a stub library in place of the built one shows what a launch passes.

Tolerances: on dyadic data (every product and sum exact) the walk equals
the plain version bit for bit (``torch.equal``) in both dtypes, Heaviside
and SiLU.  Against the JAX kernel in interpret mode the bounds of
``tests/test_torch_port_ecs_v2.py`` hold: SiLU within atol 2e-4, fewer
than 2 % of the spikes differing (the frameworks' 1x1 sums run in another
order).
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ecs_yolo_tpu.snn.pallas_kernels as pk
from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu_torch import _build
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.nn.blocks import MemUpdate
from ecs_yolo_tpu_torch.snn import fused as FZ
from ecs_yolo_tpu_torch.snn import spread as S

torch.set_num_threads(2)

#: the res10@640 neuron sites [H, W, C], N=8
RES10_SITES = [(320, 320, 64), (160, 160, 64), (80, 80, 128), (40, 40, 384),
               (40, 40, 256), (20, 20, 1024), (20, 20, 512), (20, 20, 256),
               (20, 20, 128)]
#: [N, H, W, C] of sites the tensor-core kernel (K1) refuses (C % 8 != 0)
K1_REFUSED = [(2, 29, 6, 4), (2, 20, 20, 12), (2, 29, 6, 12)]


def _inputs(shape, seed, dtype=torch.float32):
    """x = rand*2-0.5 and the spread parameters as the JAX package's fused
    kernel tests scale them."""
    t, n, h, w, c = shape
    r = np.random.RandomState(seed)
    arrays = (r.rand(*shape) * 2 - 0.5, (r.rand(3, 3, 1, c) - 0.5) * 0.4,
              (r.rand(c) - 0.5) * 0.2, (r.rand(1, 1, c, c) - 0.5) * 0.2,
              (r.rand(c) - 0.5) * 0.2)
    return [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in arrays]


def _dyadic(shape, seed, dtype):
    """x on a grid of 1/8 and the parameters on a grid of 1/64, small enough
    that every product and partial sum of a step is exact in either dtype."""
    t, n, h, w, c = shape
    r = np.random.RandomState(seed)
    arrays = (r.randint(-4, 13, shape) / 8, r.randint(-8, 9, (3, 3, 1, c)) / 64,
              r.randint(-4, 5, c) / 64, r.randint(-8, 9, (1, 1, c, c)) / 64,
              r.randint(-4, 5, c) / 64)
    return [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in arrays]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(8,) + s for s in RES10_SITES] + K1_REFUSED)
def test_plan_k3_covers_every_pixel_and_channel_once(shape, dtype):
    n, h, w, c = shape
    plan = FZ.plan_k3(n, h, w, c, 132, dtype)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    assert plan.sub == 1 and plan.tile == FZ.K3_RUN == 128
    assert plan.slice in (128, 64, 32) and plan.chunk == 128 // itemsize
    assert plan.slices * plan.slice >= c > (plan.slices - 1) * plan.slice
    assert plan.tiles * plan.tile >= n * h * w > (plan.tiles - 1) * plan.tile
    assert plan.items == plan.tiles * plan.slices and plan.window == FZ.k1_window(w)
    assert plan.grid % plan.slices == 0 and plan.grid <= FZ.K3_BLOCKS_PER_SM * 132
    assert plan.smem <= FZ.SMEM_PER_BLOCK
    seen = np.zeros((plan.tiles, plan.slices), dtype=np.int64)
    for b in range(plan.grid):
        items = FZ.k3_block_items(plan, b)
        assert items, f"block {b} owns no item"
        assert {s for _, s in items} == {b % plan.slices}
        for tile, sl in items:
            seen[tile, sl] += 1
    assert (seen == 1).all()
    # the state lies in shared memory where the busiest block's items fit, in f32
    most = -(-plan.tiles // (plan.grid // plan.slices))
    shared = FZ.k3_smem(itemsize, c, w, plan.slice, most, 1)
    assert plan.state == ("shared" if itemsize == 4 and shared <= FZ.SMEM_PER_BLOCK
                          else "workspace")
    assert plan.smem == (shared if plan.state == "shared"
                         else FZ.k3_smem(itemsize, c, w, plan.slice))


def test_plan_k3_follows_the_occupancy_and_keeps_the_state_where_it_fits():
    """More blocks an SM mean a larger grid; the state goes to shared memory
    in float32 only, and only where it keeps the blocks an SM holds."""
    assert FZ.plan_k3(8, 320, 320, 64, 132, torch.bfloat16, 0, 1).grid == 132
    assert FZ.plan_k3(8, 20, 20, 1024, 132, torch.bfloat16, 0, 1).grid == 128   # 16 slices
    small = FZ.plan_k3(8, 20, 20, 128, 132, torch.float32, 0, 1)
    assert (small.grid, small.state) == (25, "shared")         # every item, one a block
    assert FZ.k3_state_fits(small.smem, 1) and not FZ.k3_state_fits(small.smem, 2)
    assert FZ.plan_k3(8, 20, 20, 128, 132, torch.float32, 0, 2).state == "workspace"
    assert FZ.plan_k3(8, 20, 20, 128, 132, torch.bfloat16, 0, 1).state == "workspace"
    assert FZ.plan_k3(8, 320, 320, 64, 132, torch.float32).state == "workspace"
    assert FZ.plan_k3(8, 40, 40, 256, 132, torch.float32).state == "workspace"
    with pytest.raises(ValueError, match="slices"):
        FZ.plan_k3(1, 4, 4, 1024, 4, torch.bfloat16, 0, 1)
    with pytest.raises(ValueError, match="no Cout slice fits"):
        FZ.plan_k3(1, 8, 8, 4000, 132, torch.float32)


#: (3, 2, 12, 11, 72): three runs, Cout slices of 64 + 8 or one of 128, K
#: chunks of 64 + 8 (bf16) or 32 + 32 + 8 (f32); on 132 SMs one item a
#: block, on two SMs every item of a slice in one block
WALK_SHAPE = (3, 2, 12, 11, 72)


@pytest.mark.parametrize("case", ["dense", "broadcast_t", "transposed", "silu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_walk_is_the_plain_version_on_dyadic_data(case, dtype):
    args = _dyadic(WALK_SHAPE, seed=7, dtype=dtype)
    x = args[0]
    if case == "broadcast_t":
        x = x[:1].expand(*WALK_SHAPE)
    elif case == "transposed":
        x = x.transpose(2, 3).contiguous().transpose(2, 3)
        assert not x.is_contiguous()
    act = case == "silu"
    cfg = SNNConfig(time_window=WALK_SHAPE[0])
    want = FZ.ecs_lif_rows_reference(x, *args[1:], cfg, act)
    assert 0.0 < float(want[1:].float().mean()) < 1.0
    for sms, block_rows in ((132, 0), (2, 0), (132, 7)):
        plan = FZ.plan_k3(*WALK_SHAPE[1:], sms, dtype, block_rows)
        got = FZ.k3_grid_walk_reference(x, *args[1:], cfg, act, plan=plan)
        assert got.dtype == dtype
        assert torch.equal(got, want), f"{sms} SMs, block_rows {block_rows}, {plan}"


@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("case", [((4, 2, 29, 6, 4), 5, 8), ((4, 1, 8, 6, 4), 2, 0)],
                         ids=["block_rows_8_h29", "single_block"])
def test_walk_agrees_with_the_jax_kernel(case, act):
    shape, seed, block_rows = case
    arrays = [a.numpy() for a in _inputs(shape, seed=seed)]
    want = np.asarray(pk.ecs_lif_fused_v2(*(jnp.asarray(a) for a in arrays),
                                          JaxSNNConfig(time_window=shape[0]), act=act,
                                          interpret=True, block_rows=block_rows))
    plan = FZ.plan_k3(*shape[1:], 132, torch.float32, block_rows)
    got = FZ.k3_grid_walk_reference(*(torch.from_numpy(a) for a in arrays),
                                    SNNConfig(time_window=shape[0]), act, plan=plan).numpy()
    assert got.shape == want.shape
    if act:
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    else:
        assert np.mean(got != want) < 0.02


@pytest.mark.parametrize("shape,dtype", [((4, 8, 320, 320, 64), torch.bfloat16),
                                         ((4, 8, 40, 40, 384), torch.float32),
                                         ((4, 8, 80, 80, 128), torch.float32),
                                         ((3, 2, 50, 9, 408), torch.bfloat16)])
def test_max_block_rows_is_the_largest_the_planner_takes(shape, dtype):
    """Every block_rows up to it plans, with items of block_rows * W pixels
    rounded up to 128 whose state fits one block; one more raises naming
    it (or it is H, and any larger block_rows is H)."""
    t, n, h, w, c = shape
    itemsize = torch.tensor([], dtype=dtype).element_size()
    most = FZ.max_block_rows(shape, itemsize)
    assert 1 <= most <= h
    for br in sorted({1, most // 2 or 1, most}):
        plan = FZ.plan_k3(n, h, w, c, 132, dtype, br)
        assert plan.sub == -(-br * w // 128) and plan.tile == plan.sub * 128
        assert FZ.k3_smem(itemsize, c, w, plan.slice, 1, plan.sub) <= FZ.SMEM_PER_BLOCK
    if most < h:
        with pytest.raises(ValueError, match=f"the largest block_rows that fits is {most}$"):
            FZ.plan_k3(n, h, w, c, 132, dtype, most + 1)
    else:
        assert FZ.plan_k3(n, h, w, c, 132, dtype, 10 * h).sub == -(-h * w // 128)


def test_block_rows_sets_the_item_and_keeps_the_result():
    """block_rows = 7 at 20 x 20: items of 140 pixels, two runs; the plan's
    slice narrows until one item's state fits; a site where not even one
    row fits names 0."""
    plan = FZ.plan_k3(8, 20, 20, 512, 132, torch.bfloat16, 7)
    assert (plan.tile, plan.sub, plan.slice) == (256, 2, 64)
    assert FZ.plan_k3(8, 20, 20, 512, 132, torch.bfloat16, 0).slice == 128
    assert FZ.max_block_rows((4, 1, 4, 2000, 1024), 4) == 0
    with pytest.raises(ValueError, match="fits is 0$"):
        FZ.plan_k3(1, 4, 2000, 1024, 132, torch.float32, 1)


class _Entry:
    """A C function of the stub library: counts its argtypes bindings and
    records each call's arguments."""

    def __init__(self, name, calls, result=0):
        object.__setattr__(self, "binds", 0)
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "calls", calls)
        object.__setattr__(self, "result", result)

    def __setattr__(self, name, value):
        if name == "argtypes":
            object.__setattr__(self, "binds", self.binds + 1)
        object.__setattr__(self, name, value)

    def __call__(self, *args):
        if self.name == "ecs_lif_v2_fwd":
            block, consts = args
            self.calls.append((tuple((ctypes.c_longlong * 37).from_address(block)),
                               tuple(consts)))
        return self.result


def _stub(monkeypatch):
    calls, loads = [], []

    class Lib:
        ecs_lif_v2_fwd = _Entry("ecs_lif_v2_fwd", calls)
        ecs_lif_v2_occupancy = _Entry("ecs_lif_v2_occupancy", calls, result=1)
        ecs_lif_v2_error_string = _Entry("ecs_lif_v2_error_string", calls)

    monkeypatch.setattr(_build, "load", lambda name: loads.append(name) or Lib)
    monkeypatch.setattr(S, "_entries", {})
    monkeypatch.setattr(FZ, "use_kernel", lambda x: True)
    monkeypatch.setattr(FZ, "_stream", lambda t: 7)
    return Lib, calls, loads


@pytest.mark.parametrize("source", ["module", "jax", "transposed_c12"])
def test_launch_binds_once_launches_once_and_copies_no_parameter(monkeypatch, source):
    """A stub library in place of the built one: the entry is bound once over
    many calls, each call passes one int64 block and the rounded constants
    and counts one launch; x's own strides, the plan and the caller's weight
    pointers and strides are passed (a bf16 ``MemUpdate``'s
    ``spread_params()`` views, contiguous JAX-shaped tensors, a transposed
    float32 x of C = 12)."""
    Lib, calls, loads = _stub(monkeypatch)
    cfg = SNNConfig()
    if source == "transposed_c12":
        shape, dtype = (4, 2, 6, 10, 12), torch.float32
        args = _inputs(shape, seed=3, dtype=dtype)
        x = args[0].transpose(2, 3).contiguous().transpose(2, 3)
        params = args[1:]
    else:
        shape, dtype = (4, 2, 6, 10, 64), torch.bfloat16
        x = _inputs(shape, seed=1, dtype=dtype)[0]
        if source == "module":
            params = MemUpdate(64).bfloat16().spread_params()
        else:
            params = [p.contiguous() for p in _inputs(shape, seed=2, dtype=dtype)[1:]]
    before = FZ.ecs_lif_fused_v2.launches
    for _ in range(3):
        y = FZ.ecs_lif_fused_v2(x, *params, cfg)
    assert Lib.ecs_lif_v2_fwd.binds == 1 and loads == ["ecs_lif_v2"]
    assert FZ.ecs_lif_fused_v2.launches == before + 3 and len(calls) == 3
    assert y.shape == x.shape and y.is_contiguous()
    block, consts = calls[-1]
    dw, dwb, pw, pwb = params
    plan = FZ.k3_launch_plan(x)
    t, n, h, w, c = shape
    assert block[:3] == (FZ.DTYPE_CODES[dtype], plan.slice, x.data_ptr())
    assert block[3:8] == x.stride()
    assert block[8] == (0 if source == "transposed_c12" else 1)          # x in runs
    assert block[9] == y.data_ptr()
    assert (block[10], block[14], block[16], block[20]) == (
        dw.data_ptr(), dwb.data_ptr(), pw.data_ptr(), pwb.data_ptr())
    assert block[11:14] == (dw.stride(0), dw.stride(1), dw.stride(3))
    assert block[15] == dwb.stride(0) and block[21] == pwb.stride(0)
    assert block[17:20] == (pw.stride(2), pw.stride(3),
                            {"module": 1, "jax": 2, "transposed_c12": 0}[source])
    assert block[24:37] == (t, n, h, w, c, plan.slices, plan.tiles, plan.sub,
                            int(plan.state == "shared"), plan.grid, plan.smem, 0, 7)
    assert consts[0] == cfg.thresh
    assert consts[4] == float(torch.tensor(1 - 1 / cfg.ecs_tau, dtype=dtype))


def test_a_build_that_fails_raises_and_nothing_falls_back(monkeypatch):
    def no_build(name):
        raise RuntimeError("kernel build failed: nvcc not found")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(S, "_entries", {})
    monkeypatch.setattr(FZ, "use_kernel", lambda x: True)
    args = _inputs((2, 1, 5, 6, 8), seed=4)
    before = FZ.ecs_lif_fused_v2.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        FZ.ecs_lif_fused_v2(*args, SNNConfig())
    with pytest.raises(RuntimeError, match="nvcc not found"):
        FZ.ecs_lif_fused_v2(*args, SNNConfig(), block_rows=3)
    assert FZ.ecs_lif_fused_v2.launches == before


def test_an_edited_shared_header_rebuilds_every_kernel_that_includes_it(monkeypatch, tmp_path):
    """K1, K2, K3 and K6 include one header (``csrc/ecs_lif_common.cuh``); a
    library's name hashes the header too, so an edited header names new
    libraries for all four and leaves the other sources' alone."""
    names = ("ecs_lif", "ecs_lif_rows", "ecs_lif_v2", "lif_fused", "dense3")
    for name in names:
        (tmp_path / f"{name}.cu").write_bytes((_build.CSRC / f"{name}.cu").read_bytes())
    header = tmp_path / "ecs_lif_common.cuh"
    header.write_bytes((_build.CSRC / header.name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._target(n) for n in names}
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build._target(n) for n in names}
    assert [n for n in names if after[n] != before[n]] == list(names[:4])
