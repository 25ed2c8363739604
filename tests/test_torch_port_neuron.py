"""The port's membrane recurrences and the fused ECS-LIF wrapper against the
JAX package (CPU).

The port's plain ``ecs_lif_scan`` is the oracle its CUDA kernel is held to
on the card, so here it is held to the JAX scan and to the TPU kernel
``ecs_lif_pallas`` in interpret mode, on the same numpy inputs.

Tolerances (float32):
* Heaviside sites: at most 1e-3 of the spikes may differ.  The two
  frameworks' convolutions sum in different orders; a 1-ulp difference in
  the membrane flips a spike that sits on the threshold.
* SiLU sites (``act=True``): atol 2e-4, as the JAX package's own fused
  kernel tests (``tests/test_pallas_kernels.py``).
* plain LIF: atol 1e-5 (elementwise only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu.snn.neuron import ecs_lif_scan as jax_ecs_lif_scan
from ecs_yolo_tpu.snn.neuron import lif_scan as jax_lif_scan
from ecs_yolo_tpu.snn.pallas_ecs_v3 import ecs_lif_pallas
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.snn import ecs_lif as K
from ecs_yolo_tpu_torch.nn.blocks import MemUpdate
from ecs_yolo_tpu_torch.snn.neuron import (ecs_lif_scan, lif_scan, make_spread,
                                           mem_update)

torch.set_num_threads(2)

SHAPES = [(4, 2, 16, 24, 8), (5, 1, 32, 16, 8)]


def _inputs(shape, seed=0):
    """x and spread parameters as in tests/test_pallas_kernels.py:TestEcsV3."""
    T, N, H, W, C = shape
    rng = np.random.RandomState(seed)
    x = (rng.rand(*shape) * 2 - 0.5).astype(np.float32)
    dw = ((rng.rand(3, 3, 1, C) - 0.5) * 0.4).astype(np.float32)
    dwb = ((rng.rand(C) - 0.5) * 0.2).astype(np.float32)
    pw = ((rng.rand(1, 1, C, C) - 0.5) * 0.2).astype(np.float32)
    pwb = ((rng.rand(C) - 0.5) * 0.2).astype(np.float32)
    return x, dw, dwb, pw, pwb


def _jax_scan(x, dw, dwb, pw, pwb, cfg, act):
    c = x.shape[-1]

    def spread(s):
        d = jax.lax.conv_general_dilated(
            s, jnp.asarray(dw), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=c,
        ) + dwb
        return jax.lax.conv_general_dilated(
            d, jnp.asarray(pw), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        ) + pwb

    return np.asarray(jax_ecs_lif_scan(jnp.asarray(x), spread, cfg, act=act))


def _windows(h, rb, halo):
    """Per row tile: output rows [r0, r1) and window rows [w0, w1), as the
    kernel computes them from blockIdx.x (csrc/ecs_lif.cu)."""
    for r0 in range(0, h, rb):
        r1 = min(h, r0 + rb)
        yield r0, r1, max(0, r0 - halo), min(h, r1 + halo)


def _assert_spikes_agree(got, want, max_share=1e-3):
    assert got.shape == want.shape
    share = float(np.mean(got != want))
    assert share <= max_share, f"{share:.2e} of the spikes differ"


@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_ecs_lif_scan_matches_jax_scan_and_pallas(shape, act):
    args = _inputs(shape)
    T = shape[0]
    want_scan = _jax_scan(*args, JaxSNNConfig(time_window=T), act)
    want_pallas = np.asarray(ecs_lif_pallas(
        *(jnp.asarray(a) for a in args), JaxSNNConfig(time_window=T),
        act=act, interpret=True))
    x, dw, dwb, pw, pwb = (torch.from_numpy(a) for a in args)
    got = ecs_lif_scan(x, make_spread(dw, dwb, pw, pwb),
                       SNNConfig(time_window=T), act).numpy()
    for want in (want_scan, want_pallas):
        if act:
            np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
        else:
            _assert_spikes_agree(got, want)


@pytest.mark.parametrize("act", [False, True])
def test_lif_scan_matches_jax(act):
    x = np.random.RandomState(1).randn(4, 2, 9, 10, 7).astype(np.float32)
    want = np.asarray(jax_lif_scan(jnp.asarray(x), JaxSNNConfig(), act=act))
    got = lif_scan(torch.from_numpy(x), SNNConfig(), act).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_mem_update_dispatches_on_ecs():
    x, dw, dwb, pw, pwb = (torch.from_numpy(a) for a in _inputs(SHAPES[0]))
    spread = make_spread(dw, dwb, pw, pwb)
    ecs, lif = SNNConfig(), SNNConfig(ecs=False)
    assert torch.equal(mem_update(x, spread, ecs), ecs_lif_scan(x, spread, ecs))
    assert torch.equal(mem_update(x, None, lif), lif_scan(x, lif))
    with pytest.raises(ValueError, match="spread"):
        mem_update(x, None, ecs)
    # the module: plain LIF owns no spread parameters, as in the JAX module
    assert not list(MemUpdate(8, snn=lif).parameters())
    assert torch.equal(MemUpdate(8, snn=lif)(x), lif_scan(x, lif))


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    shape = SHAPES[0]
    ts = [torch.from_numpy(a) for a in _inputs(shape, seed=3)]
    cfg = SNNConfig(time_window=shape[0])
    before = K.ecs_lif_fused.launches
    got = K.ecs_lif_fused(*ts, cfg)
    want = ecs_lif_scan(ts[0], make_spread(*ts[1:]), cfg)
    assert torch.equal(got, want)
    assert K.ecs_lif_fused.launches == before


def test_wrapper_refuses_other_devices():
    ts = [a.to("meta") for a in (torch.from_numpy(a) for a in
                                 _inputs(SHAPES[0]))]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        K.ecs_lif_fused(*ts, SNNConfig())


def test_check_accepts_t_broadcast_and_rejects_bad_layouts():
    x, dw, dwb, pw, pwb = (torch.from_numpy(a) for a in _inputs(SHAPES[0]))
    K._check(x, dw, dwb, pw, pwb)
    K._check(x[:1].expand(4, -1, -1, -1, -1), dw, dwb, pw, pwb)
    with pytest.raises(ValueError, match="contiguous"):
        K._check(x.transpose(2, 3), dw, dwb, pw, pwb)
    with pytest.raises(ValueError, match="pw_kernel"):
        K._check(x, dw, dwb, pw[..., :4], pwb)
    with pytest.raises(TypeError):
        K._check(x.double(), dw, dwb, pw, pwb)
    with pytest.raises(ValueError, match="C % 8"):
        K._check(x[..., :4].contiguous(), dw[..., :4], dwb[:4],
                 pw[..., :4, :4], pwb[:4])


@pytest.mark.parametrize("rb", [3, 5])
def test_halo_windows_reproduce_the_full_recurrence(rb):
    """The kernel's tiling on the CPU: run the plain recurrence on each
    clipped window and keep its interior rows; the T-1 row halo makes that
    the full-image result (convolution sums match exactly here)."""
    shape = SHAPES[0]
    x, dw, dwb, pw, pwb = (torch.from_numpy(a) for a in _inputs(shape, seed=5))
    cfg = SNNConfig(time_window=shape[0])
    spread = make_spread(dw, dwb, pw, pwb)
    full = ecs_lif_scan(x, spread, cfg)
    tiled = torch.empty_like(full)
    for r0, r1, w0, w1 in _windows(shape[2], rb, shape[0] - 1):
        win = ecs_lif_scan(x[:, :, w0:w1].contiguous(), spread, cfg)
        tiled[:, :, r0:r1] = win[:, :, r0 - w0:r1 - w0]
    _assert_spikes_agree(tiled.numpy(), full.numpy(), max_share=0.0)
