"""The port's shared-memory ECS-LIF kernel (``snn/fused.ecs_lif_fused_v2``)
against the JAX package's ``pallas_kernels.ecs_lif_fused_v2`` in interpret
mode (CPU), and the tiling its CUDA kernel runs, on the CPU.

On the CPU the wrapper takes its plain version (``ecs_lif_rows_reference``),
which is what the kernel is held to on the card.  The kernel cuts the image
into tiles of rows and columns, each computed on its window grown by T-1
pixels on all four sides and clipped to the image; here that rule is run
with the plain version and must reproduce the whole-image result bit for bit.

Tolerances (float32), those of the JAX package for this kernel and of the
port's K2 tests: SiLU atol 2e-4; Heaviside at most 2 % of the spikes differ
(the 1x1 sums run in another order, and a membrane within an ulp of the
threshold flips).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ecs_yolo_tpu.snn.pallas_kernels as pk
from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.snn import fused as FZ

torch.set_num_threads(2)

CFG, JCFG = SNNConfig(), JaxSNNConfig()
#: [H, W, C] x count of the res10@640 neuron sites (chip_smoke.py reads them
#: from the model; tests/test_torch_port_spread.py checks the table)
RES10_SITES = [(320, 320, 64), (160, 160, 64), (80, 80, 128), (40, 40, 384),
               (40, 40, 256), (20, 20, 1024), (20, 20, 512), (20, 20, 256),
               (20, 20, 128)]


def _tiles(h, w, rows, cols, halo):
    """The kernel's tiles (``csrc/ecs_lif_v2.cu``): each interior ``(r0, r1,
    c0, c1)`` with its window ``(wr0, wr1, wc0, wc1)``, grown by ``halo`` on
    each side and clipped to the image."""
    for r0 in range(0, h, rows):
        r1 = min(h, r0 + rows)
        for c0 in range(0, w, cols):
            c1 = min(w, c0 + cols)
            yield ((r0, r1, c0, c1),
                   (max(0, r0 - halo), min(h, r1 + halo), max(0, c0 - halo), min(w, c1 + halo)))


def _inputs(shape, seed):
    """x and spread parameters as tests/test_pallas_kernels.py draws them."""
    rng = np.random.RandomState(seed)
    c = shape[-1]
    return ((rng.randn(*shape) * 0.7).astype(np.float32),
            (rng.randn(3, 3, 1, c) * 0.2).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32),
            (rng.randn(1, 1, c, c) * 0.2).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32))


# (shape, seed, block_rows): the JAX test's case, and one block of the whole image
CASES = {"block_rows_8_h29": ((4, 2, 29, 6, 4), 5, 8),
         "single_block": ((4, 1, 8, 6, 4), 2, 0)}


@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ecs_lif_fused_v2_matches_the_tpu_kernel(case, act):
    shape, seed, block_rows = CASES[case]
    args = _inputs(shape, seed)
    want = np.asarray(pk.ecs_lif_fused_v2(*(jnp.asarray(a) for a in args), JCFG,
                                          act=act, interpret=True,
                                          block_rows=block_rows))
    before = FZ.ecs_lif_fused_v2.launches
    got = FZ.ecs_lif_fused_v2(*(torch.from_numpy(a) for a in args), CFG, act,
                              block_rows=block_rows).numpy()
    assert FZ.ecs_lif_fused_v2.launches == before
    assert got.shape == want.shape
    if act:
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    else:
        assert np.mean(got != want) < 0.02


@pytest.mark.parametrize("rows,cols", [(8, 5), (5, 4)])
def test_row_and_width_windows_reproduce_the_full_recurrence(rows, cols):
    """The kernel's tiling on the CPU at H=29, W=13 (no multiple of either
    tile): the plain recurrence on each window of (rows + 2(T-1)) x (cols +
    2(T-1)) pixels clipped to the image, interior kept, equals the
    whole-image result exactly (every sum keeps its order)."""
    ts = [torch.from_numpy(a) for a in _inputs((4, 2, 29, 13, 4), 7)]
    x = ts[0]
    t, h, w = x.shape[0], x.shape[2], x.shape[3]
    full = FZ.ecs_lif_rows_reference(*ts, CFG)
    tiled = torch.full_like(full, -1.0)
    tiles = list(_tiles(h, w, rows, cols, t - 1))
    assert len(tiles) == -(-h // rows) * -(-w // cols)
    for (r0, r1, c0, c1), (wr0, wr1, wc0, wc1) in tiles:
        win = FZ.ecs_lif_rows_reference(x[:, :, wr0:wr1, wc0:wc1], *ts[1:], CFG)
        tiled[:, :, r0:r1, c0:c1] = win[:, :, r0 - wr0:r1 - wr0, c0 - wc0:c1 - wc0]
    assert torch.equal(tiled, full)


@pytest.mark.parametrize("block_rows", [1, 29, 40])
def test_block_rows_changes_nothing_on_the_cpu(block_rows):
    """0 (the wrapper's choice), 1, H and more than H give one result, the
    plain version's; fitting in shared memory is a limit of the card only."""
    ts = [torch.from_numpy(a) for a in _inputs((4, 2, 29, 6, 4), 5)]
    want = FZ.ecs_lif_fused_v2(*ts, CFG)
    assert torch.equal(want, FZ.ecs_lif_rows_reference(*ts, CFG))
    assert torch.equal(FZ.ecs_lif_fused_v2(*ts, CFG, block_rows=block_rows), want)


@pytest.mark.parametrize("block_rows", [-1, 2.0, True])
def test_block_rows_must_be_a_non_negative_int(block_rows):
    ts = [torch.from_numpy(a) for a in _inputs((4, 1, 8, 6, 4), 2)]
    with pytest.raises(ValueError, match="block_rows must be an int >= 0"):
        FZ.ecs_lif_fused_v2(*ts, CFG, block_rows=block_rows)


@pytest.mark.parametrize("hwc", RES10_SITES, ids=lambda s: "x".join(map(str, s)))
def test_every_res10_site_has_a_tile_that_fits_shared_memory(hwc):
    """At N=8, T=4, both dtypes: the planned window's three state planes fit
    a block's shared memory, the cluster's slices cover C in multiples of
    16, and C >= 128 in bf16 (>= 64 in f32) is split across a cluster."""
    h, w, c = hwc
    for item in (2, 4):
        shape = (4, 8, h, w, c)
        cs, cl, pitch, br, bc = FZ.plan_v2(shape, item, 0, 132)
        win = min(h, br + 6) * min(w, bc + 6)
        assert 3 * win * pitch * item <= FZ.SMEM_PER_BLOCK
        assert cs * cl == c and cl % 16 == 0 and 1 <= cs <= FZ.MAX_CLUSTER
        assert pitch * item == cl * item + 16
        assert (cs > 1) == (c > FZ.TARGET_CHANNELS[item])
        assert 1 <= br <= h and 1 <= bc <= w
        assert br <= FZ.max_block_rows(shape, item)


def test_a_block_rows_that_cannot_fit_raises_naming_the_largest():
    shape = (4, 8, 320, 320, 64)
    most = FZ.max_block_rows(shape, 2)
    assert 1 <= most < 320
    assert FZ.plan_v2(shape, 2, most, 132)[3] == most
    with pytest.raises(ValueError, match=f"the largest block_rows that fits is {most}$"):
        FZ.plan_v2(shape, 2, most + 1, 132)
    # where the image fits whole, any block_rows > H is H
    assert FZ.plan_v2((4, 8, 20, 20, 512), 2, 1000, 132)[3] == 20
    # a site no window fits at all
    assert FZ.max_block_rows((4, 1, 64, 64, 4000), 4) == 0
    with pytest.raises(ValueError, match="no tile"):
        FZ.plan_v2((4, 1, 64, 64, 4000), 4, 0, 132)


def test_small_and_odd_channel_counts_pad_to_the_product_step():
    assert FZ.split_channels(4, 4) == (1, 16, 20)
    assert FZ.split_channels(12, 2) == (1, 16, 24)
    assert FZ.split_channels(1000, 2) == (1, 1008, 1016)   # no split of 16s
    assert FZ.split_channels(384, 2) == (8, 48, 56)
    assert FZ.split_channels(1024, 2) == (8, 128, 136)


@pytest.mark.parametrize("shape,item", [((4, 8, 320, 320, 64), 2), ((4, 1, 30, 8, 1024), 4),
                                        ((4, 8, 20, 20, 1024), 4), ((3, 2, 50, 9, 408), 2)])
def test_max_block_rows_is_the_largest_the_planner_takes(shape, item):
    """Every block_rows up to it plans, one more raises (or it is H)."""
    most = FZ.max_block_rows(shape, item)
    for br in range(1, most + 1):
        assert FZ.plan_v2(shape, item, br, 132)[3] == br
    if most < shape[2]:
        with pytest.raises(ValueError, match=f"fits is {most}$"):
            FZ.plan_v2(shape, item, most + 1, 132)
    else:
        assert most == shape[2]
