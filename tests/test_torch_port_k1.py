"""K1's grid plan, its walk and its launch path (CPU).

K1 (``snn/ecs_lif.ecs_lif_fused``, ``csrc/ecs_lif.cu``) runs every step of
a site in one cooperative launch over (128-pixel tile x Cout slice) items.
The CUDA kernel runs only on the card; here the plan that drives it
(``plan_grid``, ``k1_block_items``) is checked for coverage and fit, the
kernel's walk in plain PyTorch (``k1_grid_walk_reference``) is held to the
plain version and to the JAX TPU kernel, and a stub library in place of the
built one shows what a launch passes.

Tolerances: the walk is bit-equal to the plain version on exact (dyadic)
data in float32 with Heaviside spikes; SiLU sites (``act=True``) within
atol 2e-4 (the kernel fuses each tap's product and sum, the plain version
rounds them apart); against the JAX kernel at most 1e-3 of the spikes may
differ (``tests/test_torch_port_neuron.py``: the frameworks' convolutions sum
in different orders).
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu.snn.pallas_ecs_v3 import ecs_lif_pallas
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.nn.blocks import MemUpdate
from ecs_yolo_tpu_torch.snn import ecs_lif as K
from ecs_yolo_tpu_torch.snn import spread as S

torch.set_num_threads(2)

#: the res10@640 neuron sites [H, W, C], N=8
RES10_SITES = [(320, 320, 64), (160, 160, 64), (80, 80, 128), (40, 40, 384),
               (40, 40, 256), (20, 20, 1024), (20, 20, 512), (20, 20, 256),
               (20, 20, 128)]
#: the neuron sites of the five anchor-free YAMLs at 640 px (res10v8, res10v10,
#: res10-dual, res10-triple, res10-dualplain; N=8, dense x) beyond res10's [H, W, C]:
#: the heads' towers, the ASFF fusion and GSConv's C = 8 cv2
HEAD_SITES = [(40, 40, 512), (40, 40, 64), (40, 40, 8), (20, 20, 64), (20, 20, 8)]
RAGGED = [(1, 20, 20, 1024), (2, 7, 9, 24), (8, 20, 20, 1024), (1, 16, 24, 8),
          (3, 9, 10, 136)]
#: ``DynamicConv2d``'s gating sites (its kk x kk pooled map and its 1 x 1
#: mean) in probe-mixer at b2 and b8: maps smaller than a tile's row run
TINY = [(2, 3, 3, 512), (2, 1, 1, 1024), (8, 3, 3, 128), (8, 1, 1, 64)]


def _dyadic(shape, seed):
    """x on a 1/16 grid, weights on 1/32 and 1/64 grids: every sum of the
    spread is exact in float32, whatever its order."""
    t, n, h, w, c = shape
    r = np.random.RandomState(seed)
    arrays = (r.randint(-8, 25, size=shape) / 16, r.randint(-6, 7, size=(3, 3, 1, c)) / 32,
              r.randint(-3, 4, size=c) / 32, r.randint(-6, 7, size=(1, 1, c, c)) / 64,
              r.randint(-3, 4, size=c) / 32)
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(8,) + s for s in RES10_SITES + HEAD_SITES] + RAGGED + TINY)
def test_plan_grid_covers_every_pixel_and_channel_once(shape, dtype):
    n, h, w, c = shape
    plan = K.plan_grid(n, h, w, c, 132, dtype)
    assert plan.slices * plan.slice >= c > (plan.slices - 1) * plan.slice
    assert plan.tiles * plan.tile >= n * h * w > (plan.tiles - 1) * plan.tile
    assert plan.grid % plan.slices == 0
    assert plan.grid <= K.K1_BLOCKS_PER_SM * 132
    assert plan.smem <= K.SMEM_PER_BLOCK
    assert plan.smem == K.k1_smem(torch.tensor([], dtype=dtype).element_size(), c, w,
                                  plan.slice)
    seen = np.zeros((plan.tiles, plan.slices), dtype=np.int64)
    for b in range(plan.grid):
        items = K.k1_block_items(plan, b)
        assert items, f"block {b} owns no item"
        assert {s for _, s in items} == {b % plan.slices}
        for tile, sl in items:
            seen[tile, sl] += 1
    assert (seen == 1).all()
    if n * h * w * c <= 1 << 16:       # pixel x channel pairs, where few
        pairs = np.zeros((n * h * w, c), dtype=np.int64)
        for b in range(plan.grid):
            for tile, sl in K.k1_block_items(plan, b):
                pairs[tile * plan.tile:(tile + 1) * plan.tile,
                      sl * plan.slice:(sl + 1) * plan.slice] += 1
        assert (pairs == 1).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k1_takes_every_head_site(dtype):
    """K1 takes every dense site of the anchor-free heads, none goes to K2;
    at C = 8 (GSConv's cv2 in ASFF2) one 32-wide slice holds all of Cout and
    the K-chunk its 8 channels (the rest of the chunk's 64 / 32 masked)."""
    for h, w, c in HEAD_SITES + RES10_SITES:
        x = torch.empty((4, 8, h, w, c), dtype=dtype, device="meta")
        assert K.layout_refusal(x) is None, (h, w, c)
    for h, w in ((40, 40), (20, 20)):
        plan = K.plan_grid(8, h, w, 8, 132, dtype)
        assert (plan.slice, plan.slices) == (32, 1)
        assert plan.chunk == 128 // torch.tensor([], dtype=dtype).element_size()
        assert plan.items == plan.tiles == 8 * h * w // K.K1_TILE


def test_plan_grid_follows_the_occupancy_and_the_slice_rule():
    # all of Cout in one item up to C = 128; 128-wide slices above, 64 where a
    # 128-wide resident slice does not fit (C = 1024)
    slices = {c: K.plan_grid(8, 20, 20, c).slice for c in (24, 64, 128, 256, 512, 1024)}
    assert slices == {24: 32, 64: 64, 128: 128, 256: 128, 512: 128, 1024: 64}
    assert K.plan_grid(8, 320, 320, 64, 132, torch.bfloat16, 2).grid == 264
    assert K.plan_grid(8, 20, 20, 1024, 132, torch.bfloat16, 1).grid == 128
    with pytest.raises(ValueError, match="multiple of 8"):
        K.plan_grid(1, 4, 4, 12)
    with pytest.raises(ValueError, match="slices"):
        K.plan_grid(1, 4, 4, 1024, 8, torch.bfloat16, 1)


@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("shape", [(3, 2, 7, 9, 24), (4, 2, 9, 10, 136), (1, 1, 5, 6, 8),
                                   (5, 1, 6, 5, 16), (4, 2, 3, 3, 64), (4, 2, 1, 1, 16)])
def test_walk_is_the_plain_version_on_dyadic_data(shape, act):
    args = _dyadic(shape, seed=shape[-1])
    cfg = SNNConfig(time_window=shape[0])
    want = K.ecs_lif_reference(*args, cfg, act)
    for sms in (132, 2):
        plan = K.plan_grid(*shape[1:], sms, torch.float32)
        got = K.k1_grid_walk_reference(*args, cfg, act, plan=plan)
        if act:
            torch.testing.assert_close(got, want, atol=2e-4, rtol=0)
        else:
            assert torch.equal(got, want)


def test_walk_agrees_with_the_jax_kernel():
    shape = (4, 2, 16, 24, 8)
    r = np.random.RandomState(0)
    c = shape[-1]
    arrays = [(r.rand(*shape) * 2 - 0.5), (r.rand(3, 3, 1, c) - 0.5) * 0.4,
              (r.rand(c) - 0.5) * 0.2, (r.rand(1, 1, c, c) - 0.5) * 0.2,
              (r.rand(c) - 0.5) * 0.2]
    arrays = [a.astype(np.float32) for a in arrays]
    want = np.asarray(ecs_lif_pallas(*(jnp.asarray(a) for a in arrays),
                                     JaxSNNConfig(time_window=shape[0]), interpret=True))
    got = K.k1_grid_walk_reference(*(torch.from_numpy(a) for a in arrays),
                                   SNNConfig(time_window=shape[0])).numpy()
    assert got.shape == want.shape
    share = float(np.mean(got != want))
    assert share <= 1e-3, f"{share:.2e} of the spikes differ"


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
        if self.name == "ecs_lif_fwd":
            block, consts = args
            self.calls.append((tuple((ctypes.c_longlong * 30).from_address(block)),
                               tuple(consts)))
        return self.result


@pytest.mark.parametrize("source", ["module", "jax"])
def test_launch_binds_once_launches_once_and_copies_no_parameter(monkeypatch, source):
    """A stub library in place of the built one: the entries are bound once
    over many calls, each call passes one int64 block and the rounded
    constants and counts one launch, and the weight pointers passed are the
    caller's own, for a bf16 ``MemUpdate``'s ``spread_params()`` views and for
    contiguous JAX-shaped tensors alike."""
    from ecs_yolo_tpu_torch import _build

    calls, loads = [], []

    class Lib:
        ecs_lif_fwd = _Entry("ecs_lif_fwd", calls)
        ecs_lif_occupancy = _Entry("ecs_lif_occupancy", calls, result=1)
        ecs_lif_error_string = _Entry("ecs_lif_error_string", calls)

    monkeypatch.setattr(_build, "load", lambda name: loads.append(name) or Lib)
    monkeypatch.setattr(S, "_entries", {})
    monkeypatch.setattr(K, "use_kernel", lambda x: True)
    monkeypatch.setattr(K, "_stream", lambda t: 7)
    shape = (4, 2, 6, 10, 64)
    x = _dyadic(shape, seed=1)[0].bfloat16()
    if source == "module":
        m = MemUpdate(64).bfloat16()
        params = m.spread_params()
    else:
        params = [p.bfloat16().contiguous() for p in _dyadic(shape, seed=2)[1:]]
    cfg = SNNConfig()
    before = K.ecs_lif_fused.launches
    for _ in range(3):
        y = K.ecs_lif_fused(x, *params, cfg)
    assert Lib.ecs_lif_fwd.binds == 1 and loads == ["ecs_lif"]
    assert K.ecs_lif_fused.launches == before + 3 and len(calls) == 3
    block, consts = calls[-1]
    dw, dwb, pw, pwb = params
    plan = K.launch_plan(x)
    assert block[:3] == (1, plan.slice, x.data_ptr())
    assert block[4] == y.data_ptr()
    assert (block[5], block[9], block[11], block[15]) == (
        dw.data_ptr(), dwb.data_ptr(), pw.data_ptr(), pwb.data_ptr())
    assert block[6:9] == (dw.stride(0), dw.stride(1), dw.stride(3))
    assert block[12:15] == (pw.stride(2), pw.stride(3), 1 if source == "module" else 2)
    assert block[19:30] == (4, 2, 6, 10, 64, plan.slices, plan.tiles, plan.grid, plan.smem,
                            0, 7)
    assert consts[0] == cfg.thresh
    assert consts[4] == float(torch.tensor(1 - 1 / cfg.ecs_tau, dtype=torch.bfloat16))


def test_layout_refusal_keeps_the_layouts_k1_took():
    x = torch.zeros(4, 1, 20, 30, 1024)
    assert K.layout_refusal(x) is None                       # N = 1, H != W
    assert K.layout_refusal(x[:1].expand(4, -1, -1, -1, -1)) is None
    assert K.layout_refusal(torch.zeros(2, 1, 7, 9, 24)) is None
    assert "C % 8" in K.layout_refusal(torch.zeros(2, 1, 7, 9, 12))
    assert "shared memory" in K.layout_refusal(torch.zeros(1, 1, 4, 400, 4096))
