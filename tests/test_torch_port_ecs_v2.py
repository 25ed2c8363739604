"""The port's shared-state ECS-LIF kernel (``snn/fused.ecs_lif_fused_v2``)
against the JAX package's ``pallas_kernels.ecs_lif_fused_v2`` in interpret
mode (CPU), and its ``block_rows`` argument on the CPU.

On the CPU the wrapper takes its plain version (``ecs_lif_rows_reference``),
which is what the kernel is held to on the card.  The kernel's plan, its
walk and its launch path are tested in ``tests/test_torch_port_k3.py``.

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
