"""K6's launch path (CPU): ``snn/fused.lif_fused`` on ``csrc/lif_fused.cu``.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it to
its plain version (mismatch share 0).  Here a stub library in place of the
built one shows what a launch passes: the entry is bound once, each call is
one launch with one int64 argument block, and the constants are rounded to
the dtype once per (dtype, cfg).  The comparison with the JAX kernel in
interpret mode and the failed-build test are in
``tests/test_torch_port_fused.py``.
"""

import ctypes

import pytest
import torch

from ecs_yolo_tpu_torch import _build
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.snn import fused as FZ
from ecs_yolo_tpu_torch.snn import spread as S

torch.set_num_threads(2)

#: int64 values of the argument block (csrc/lif_fused.cu:lif_fused_fwd)
ARGS = 8


class _Entry:
    """A C function of the stub library: counts its argtypes bindings and
    records each call's argument block and constants."""

    def __init__(self, name, calls):
        object.__setattr__(self, "binds", 0)
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "calls", calls)

    def __setattr__(self, name, value):
        if name == "argtypes":
            object.__setattr__(self, "binds", self.binds + 1)
        object.__setattr__(self, name, value)

    def __call__(self, *args):
        if self.name == "lif_fused_fwd":
            block, consts = args
            self.calls.append((tuple((ctypes.c_longlong * ARGS).from_address(block)),
                               tuple(consts)))
        return 0


def _stub(monkeypatch):
    calls, loads = [], []

    class Lib:
        lif_fused_fwd = _Entry("lif_fused_fwd", calls)
        lif_fused_error_string = _Entry("lif_fused_error_string", calls)

    monkeypatch.setattr(_build, "load", lambda name: loads.append(name) or Lib)
    monkeypatch.setattr(S, "_entries", {})
    monkeypatch.setattr(FZ, "use_kernel", lambda x: True)
    monkeypatch.setattr(FZ, "_stream", lambda t: 7)
    return Lib, calls, loads


@pytest.mark.parametrize("case", ["dense_bf16", "broadcast_f32", "one_step", "ragged_silu"])
def test_launch_binds_once_launches_once_with_one_argument_block(monkeypatch, case):
    """Over three calls the entry is bound once and each call launches once,
    passing x's pointer and T stride (0 for a broadcast or one step), the
    output's pointer, the plane size, T, act and the stream."""
    Lib, calls, loads = _stub(monkeypatch)
    shape, dtype, act = {"dense_bf16": ((4, 2, 5, 6, 16), torch.bfloat16, False),
                         "broadcast_f32": ((4, 2, 5, 6, 16), torch.float32, False),
                         "one_step": ((1, 3, 4, 4, 8), torch.bfloat16, False),
                         "ragged_silu": ((3, 3, 5, 7, 3), torch.float32, True)}[case]
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    if case == "broadcast_f32":
        x = x[:1].expand(*shape)
    cfg = SNNConfig()
    before = FZ.lif_fused.launches
    for _ in range(3):
        y = FZ.lif_fused(x, cfg, act)
    assert Lib.lif_fused_fwd.binds == 1 and loads == ["lif_fused"]
    assert FZ.lif_fused.launches == before + 3 and len(calls) == 3
    assert y.shape == x.shape and y.dtype == dtype and y.is_contiguous()
    block, consts = calls[-1]
    t, m = shape[0], x[0].numel()
    stride = 0 if case in ("broadcast_f32", "one_step") else m
    assert block == (FZ.DTYPE_CODES[dtype], x.data_ptr(), stride, y.data_ptr(), m, t,
                     int(act), 7)
    assert consts[0] == cfg.thresh
    assert consts[1] == float(torch.tensor(cfg.decay, dtype=dtype))


def test_constants_are_rounded_once_per_dtype_and_config(monkeypatch):
    _stub(monkeypatch)
    rounded = []
    real = FZ._const
    monkeypatch.setattr(FZ, "_const", lambda v, like: rounded.append((v, like.dtype))
                        or real(v, like))
    FZ._lif_consts.cache_clear()
    x = torch.rand(2, 1, 3, 3, 8)
    for _ in range(4):
        FZ.lif_fused(x, SNNConfig())
        FZ.lif_fused(x.bfloat16(), SNNConfig())
    FZ.lif_fused(x, SNNConfig(decay=0.5))
    assert rounded == [(SNNConfig().decay, torch.float32), (SNNConfig().decay, torch.bfloat16),
                       (0.5, torch.float32)]


def test_what_the_kernel_does_not_take_is_refused_before_any_launch(monkeypatch):
    Lib, calls, loads = _stub(monkeypatch)
    x = torch.rand(4, 2, 5, 6, 8)
    with pytest.raises(ValueError, match="contiguous"):
        FZ.lif_fused(x.transpose(2, 3), SNNConfig())
    with pytest.raises(ValueError, match="T stride"):
        FZ.lif_fused(torch.rand(8, 2, 5, 6, 8)[::2], SNNConfig())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FZ.lif_fused(x.half(), SNNConfig())
    with pytest.raises(ValueError, match=r"\[T, \.\.\.\]"):
        FZ.lif_fused(torch.rand(8), SNNConfig())
    assert calls == [] and loads == []
    # an empty site allocates its output and launches nothing
    before = FZ.lif_fused.launches
    assert FZ.lif_fused(torch.rand(4, 0, 5, 6, 8), SNNConfig()).shape == (4, 0, 5, 6, 8)
    assert FZ.lif_fused.launches == before and calls == []
