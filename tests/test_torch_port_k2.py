"""K2's grid plan, its walk and its launch path (CPU).

K2 (``snn/fused.ecs_lif_fused_rows``, ``csrc/ecs_lif_rows.cu``) runs every
step of a site in one cooperative launch over (128-pixel tile x Cout slice)
items, its 1x1 summed in channel order on CUDA cores.  The CUDA kernel runs
only on the card; here the plan that drives it (``plan_k2``,
``k2_block_items``) is checked for coverage and fit, the kernel's walk in
plain PyTorch (``k2_grid_walk_reference``) is held to the plain version and
to the JAX TPU kernel, and a stub library in place of the built one shows
what a launch passes.

Tolerances: the walk repeats the plain version's operations one by one, so
the two are bit-equal (``torch.equal``) in both dtypes, Heaviside and SiLU.
Against the JAX kernel in interpret mode the bounds of
``tests/test_torch_port_fused.py:test_ecs_rows_reference_matches_the_tpu_kernel``
hold: SiLU within atol 2e-4, fewer than 2 % of the spikes differing (the
frameworks' 1x1 sums run in another order).
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
from ecs_yolo_tpu_torch.snn import ecs_lif as K1
from ecs_yolo_tpu_torch.snn import fused as FZ
from ecs_yolo_tpu_torch.snn import spread as S

torch.set_num_threads(2)

#: the res10@640 neuron sites [H, W, C], N=8
RES10_SITES = [(320, 320, 64), (160, 160, 64), (80, 80, 128), (40, 40, 384),
               (40, 40, 256), (20, 20, 1024), (20, 20, 512), (20, 20, 256),
               (20, 20, 128)]
#: the anchor-free heads' sites beyond res10's [H, W, C] (every site takes K2
#: under fused_inference)
HEAD_SITES = [(40, 40, 512), (40, 40, 64), (40, 40, 8), (20, 20, 64), (20, 20, 8)]
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(8,) + s for s in RES10_SITES + HEAD_SITES] + K1_REFUSED)
def test_plan_k2_covers_every_pixel_and_channel_once(shape, dtype):
    n, h, w, c = shape
    plan = FZ.plan_k2(n, h, w, c, 132, dtype)
    assert plan.slice == FZ.K2_SLICE == 64
    assert plan.slices * plan.slice >= c > (plan.slices - 1) * plan.slice
    assert plan.tiles * plan.tile >= n * h * w > (plan.tiles - 1) * plan.tile
    assert plan.chunk == 32 and plan.window == FZ.k2_window(w)
    assert plan.grid % plan.slices == 0
    assert plan.grid <= FZ.K2_BLOCKS_PER_SM * 132
    itemsize = torch.tensor([], dtype=dtype).element_size()
    assert plan.smem == FZ.k2_smem(itemsize, w) <= FZ.SMEM_PER_BLOCK
    seen = np.zeros((plan.tiles, plan.slices), dtype=np.int64)
    for b in range(plan.grid):
        items = FZ.k2_block_items(plan, b)
        assert items, f"block {b} owns no item"
        assert {s for _, s in items} == {b % plan.slices}
        for tile, sl in items:
            seen[tile, sl] += 1
    assert (seen == 1).all()
    if n * h * w * c <= 1 << 16:       # pixel x channel pairs, where few
        pairs = np.zeros((n * h * w, c), dtype=np.int64)
        for b in range(plan.grid):
            for tile, sl in FZ.k2_block_items(plan, b):
                pairs[tile * plan.tile:(tile + 1) * plan.tile,
                      sl * plan.slice:(sl + 1) * plan.slice] += 1
        assert (pairs == 1).all()


def test_plan_k2_follows_the_occupancy():
    assert FZ.plan_k2(8, 320, 320, 64, 132, torch.bfloat16, 1).grid == 132
    assert FZ.plan_k2(8, 20, 20, 1024, 132, torch.bfloat16, 2).grid == 256   # 16 slices
    assert FZ.plan_k2(8, 20, 20, 128, 132, torch.bfloat16, 2).grid == 50     # every item
    with pytest.raises(ValueError, match="slices"):
        FZ.plan_k2(1, 4, 4, 1024, 4, torch.bfloat16, 1)


#: (3, 2, 12, 11, 72): three tiles, two Cout slices (64 + 8), three K-chunks
#: (32 + 32 + 8); on 132 SMs one item a block, on one SM three a block
WALK_SHAPE = (3, 2, 12, 11, 72)


@pytest.mark.parametrize("case", ["dense", "broadcast_t", "transposed", "silu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_walk_is_the_plain_version(case, dtype):
    args = _inputs(WALK_SHAPE, seed=7, dtype=dtype)
    x = args[0]
    if case == "broadcast_t":
        x = x[:1].expand(*WALK_SHAPE)
    elif case == "transposed":
        x = x.transpose(2, 3).contiguous().transpose(2, 3)
        assert not x.is_contiguous()
    act = case == "silu"
    cfg = SNNConfig(time_window=WALK_SHAPE[0])
    want = FZ.ecs_lif_rows_reference(x, *args[1:], cfg, act)
    for sms in (132, 1):
        plan = FZ.plan_k2(*WALK_SHAPE[1:], sms, dtype)
        got = FZ.k2_grid_walk_reference(x, *args[1:], cfg, act, plan=plan)
        assert got.dtype == dtype
        assert torch.equal(got, want), f"{sms} SMs, grid {plan.grid}"


@pytest.mark.parametrize("act", [False, True])
def test_walk_agrees_with_the_jax_kernel(act):
    shape = (4, 1, 8, 6, 4)
    arrays = [a.numpy() for a in _inputs(shape, seed=2)]
    want = np.asarray(pk.ecs_lif_fused(*(jnp.asarray(a) for a in arrays),
                                       JaxSNNConfig(time_window=shape[0]), act=act,
                                       interpret=True))
    got = FZ.k2_grid_walk_reference(*(torch.from_numpy(a) for a in arrays),
                                    SNNConfig(time_window=shape[0]), act).numpy()
    assert got.shape == want.shape
    if act:
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    else:
        assert np.mean(got != want) < 0.02


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
        if self.name == "ecs_lif_rows_fwd":
            block, consts = args
            self.calls.append((tuple((ctypes.c_longlong * 35).from_address(block)),
                               tuple(consts)))
        return self.result


def _stub(monkeypatch):
    calls, loads = [], []

    class Lib:
        ecs_lif_rows_fwd = _Entry("ecs_lif_rows_fwd", calls)
        ecs_lif_rows_occupancy = _Entry("ecs_lif_rows_occupancy", calls, result=2)
        ecs_lif_rows_error_string = _Entry("ecs_lif_rows_error_string", calls)

    monkeypatch.setattr(_build, "load", lambda name: loads.append(name) or Lib)
    monkeypatch.setattr(S, "_entries", {})
    monkeypatch.setattr(FZ, "use_kernel", lambda x: True)
    monkeypatch.setattr(FZ, "_stream", lambda t: 7)
    return Lib, calls, loads


@pytest.mark.parametrize("source", ["module", "jax", "transposed_c12"])
def test_launch_binds_once_launches_once_and_copies_no_parameter(monkeypatch, source):
    """A stub library in place of the built one: the entry is bound once over
    many calls, each call passes one int64 block and the rounded constants
    and counts one launch; x's own strides and the caller's weight pointers
    and strides are passed (a bf16 ``MemUpdate``'s ``spread_params()`` views,
    contiguous JAX-shaped tensors, a transposed float32 x of C = 12)."""
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
    before = FZ.ecs_lif_fused_rows.launches
    for _ in range(3):
        y = FZ.ecs_lif_fused_rows(x, *params, cfg)
    assert Lib.ecs_lif_rows_fwd.binds == 1 and loads == ["ecs_lif_rows"]
    assert FZ.ecs_lif_fused_rows.launches == before + 3 and len(calls) == 3
    assert y.shape == x.shape and y.is_contiguous()
    block, consts = calls[-1]
    dw, dwb, pw, pwb = params
    plan = FZ.k2_launch_plan(x)
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
    assert block[24:35] == (t, n, h, w, c, plan.slices, plan.tiles, plan.grid,
                            plan.smem, 0, 7)
    assert consts[0] == cfg.thresh
    assert consts[4] == float(torch.tensor(1 - 1 / cfg.ecs_tau, dtype=dtype))


def test_a_build_that_fails_raises_and_nothing_falls_back(monkeypatch):
    def no_build(name):
        raise RuntimeError("kernel build failed: nvcc not found")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(S, "_entries", {})
    monkeypatch.setattr(FZ, "use_kernel", lambda x: True)
    args = _inputs((2, 1, 5, 6, 8), seed=4)
    before = FZ.ecs_lif_fused_rows.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        FZ.ecs_lif_fused_rows(*args, SNNConfig())
    assert FZ.ecs_lif_fused_rows.launches == before


def test_k2_takes_what_k1_refuses():
    """The general-shape kernel exists for the sites K1 refuses: a C that is
    no multiple of 8 and an x whose [N, H, W, C] dims are not dense plan and
    walk as any other."""
    for n, h, w, c in K1_REFUSED:
        assert "C % 8" in K1.layout_refusal(torch.zeros(4, n, h, w, c))
        assert FZ.plan_k2(n, h, w, c).slices == 1
    # x is read through its strides: in 8-channel runs where the channels
    # are dense and every other stride keeps a run 16-byte aligned
    x = torch.zeros(4, 2, 6, 10, 64).transpose(2, 3)
    assert "contiguous" in K1.layout_refusal(x)
    assert FZ._x_vec(x) == 1
    assert FZ._x_vec(torch.zeros(1, 2, 6, 10, 64).expand(4, -1, -1, -1, -1)) == 1
    assert FZ._x_vec(torch.zeros(4, 2, 6, 64, 10).transpose(3, 4)) == 0    # channel stride 10
    assert FZ._x_vec(torch.zeros(4, 2, 6, 10, 12)) == 0                    # pixel stride 12


def test_an_edited_shared_header_rebuilds_both_ecs_lif_kernels(monkeypatch, tmp_path):
    """K1 and K2 include one header (``csrc/ecs_lif_common.cuh``, the grid
    barrier they share); a library's name hashes the header too, so an edited
    header names new libraries for both and leaves the other sources' alone."""
    for name in ("ecs_lif", "ecs_lif_rows", "dense3"):
        (tmp_path / f"{name}.cu").write_bytes((_build.CSRC / f"{name}.cu").read_bytes())
    header = tmp_path / "ecs_lif_common.cuh"
    header.write_bytes((_build.CSRC / header.name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build._sources("ecs_lif_rows")] == [
        "ecs_lif_rows.cu", "ecs_lif_common.cuh"]
    before = {n: _build._target(n) for n in ("ecs_lif", "ecs_lif_rows", "dense3")}
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build._target(n) for n in before}
    assert after["ecs_lif"] != before["ecs_lif"]
    assert after["ecs_lif_rows"] != before["ecs_lif_rows"]
    assert after["dense3"] == before["dense3"]
