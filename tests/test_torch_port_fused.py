"""The port's general-shape fused recurrences (``snn/fused.py``) against the
JAX package (CPU), and the ``MemUpdate`` dispatch between the fused kernels.

On the CPU the wrappers take their plain versions, which are what the CUDA
kernels are held to on the card; here the plain versions are held to the TPU
kernels in interpret mode and to the JAX scans, on the same numpy inputs.

Tolerances (float32):
* plain LIF is elementwise: Heaviside spikes equal, SiLU atol 1e-5 (the JAX
  package's own bound, ``tests/test_pallas_kernels.py:TestLIFFused``).
* ECS-LIF: SiLU atol 2e-4; Heaviside at most 2 % of the spikes differ (the
  JAX package's own bounds for this kernel: the 1x1 sums run in another
  order, and a membrane within an ulp of the threshold flips).
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ecs_yolo_tpu.snn.pallas_kernels as pk
from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu.snn.neuron import lif_scan as jax_lif_scan
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.nn import blocks as PB
from ecs_yolo_tpu_torch.snn import ecs_lif as K1
from ecs_yolo_tpu_torch.snn import fused as FZ
from ecs_yolo_tpu_torch.snn import ops
from ecs_yolo_tpu_torch.snn.neuron import lif_scan

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CFG, JCFG = SNNConfig(), JaxSNNConfig()


# --- plain LIF -------------------------------------------------------------------

# the two shapes of tests/test_pallas_kernels.py:TestLIFFused
LIF_SHAPES = {"aligned": ((4, 2, 9, 10, 7), 0), "ragged": ((2, 3, 5, 7, 3), 1)}


@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("shape", sorted(LIF_SHAPES))
def test_lif_fused_matches_the_tpu_kernel_and_the_scan(shape, act):
    dims, seed = LIF_SHAPES[shape]
    x = np.random.RandomState(seed).randn(*dims).astype(np.float32)
    got = FZ.lif_fused(torch.from_numpy(x), CFG, act).numpy()
    for want in (pk.lif_fused(jnp.asarray(x), JCFG, act=act, interpret=True),
                 jax_lif_scan(jnp.asarray(x), JCFG, act=act)):
        if act:
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(got, np.asarray(want))


def test_lif_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    x = torch.from_numpy(np.random.RandomState(2).randn(3, 2, 4, 5, 6)
                         .astype(np.float32))
    before = FZ.lif_fused.launches
    assert torch.equal(FZ.lif_fused(x, CFG), lif_scan(x, CFG))
    assert torch.equal(FZ.lif_fused(x.bfloat16(), CFG, True),
                       lif_scan(x.bfloat16(), CFG, True))
    assert FZ.lif_fused.launches == before
    assert not FZ.lif_reference(x.requires_grad_(), CFG).requires_grad


# --- ECS-LIF, any shape ------------------------------------------------------------


def _params(c, seed=0):
    """Spread parameters as tests/test_pallas_kernels.py:TestECSFused."""
    rng = np.random.RandomState(seed)
    return ((rng.randn(3, 3, 1, c) * 0.2).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32),
            (rng.randn(1, 1, c, c) * 0.2).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32))


# (shape, x seed, parameter seed, forced TPU row block or None)
ECS_CASES = {
    "single_block": ((4, 1, 8, 6, 4), 2, 0, None),
    "multi_block_h29": ((4, 2, 29, 6, 4), 3, 4, 8),
}


def _ecs_inputs(case):
    shape, xseed, pseed, _ = ECS_CASES[case]
    x = (np.random.RandomState(xseed).randn(*shape) * 0.7).astype(np.float32)
    return (x,) + _params(shape[-1], pseed)


@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("case", sorted(ECS_CASES))
def test_ecs_rows_reference_matches_the_tpu_kernel(case, act, monkeypatch):
    block_rows = ECS_CASES[case][3]
    if block_rows:   # several row blocks: the halo path of the TPU kernel
        monkeypatch.setattr(pk, "_pick_block_rows", lambda *a, **k: block_rows)
    args = _ecs_inputs(case)
    want = np.asarray(pk.ecs_lif_fused(*(jnp.asarray(a) for a in args), JCFG,
                                       act=act, interpret=True))
    ts = [torch.from_numpy(a) for a in args]
    got = FZ.ecs_lif_rows_reference(*ts, CFG, act).numpy()
    k1_plain = K1.ecs_lif_reference(*ts, CFG, act).numpy()
    assert got.shape == want.shape
    if act:
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
        np.testing.assert_allclose(got, k1_plain, atol=2e-4, rtol=0)
    else:
        assert np.mean(got != want) < 0.02
        assert np.mean(got != k1_plain) < 0.02


@pytest.mark.parametrize("rb", [8, 5])
def test_ecs_rows_halo_windows_reproduce_the_full_recurrence(rb):
    """The kernel's tiling on the CPU, at the shape where an off-by-one would
    show (H=29 is no multiple of the tile): the plain recurrence on each
    window of rb + 2(T-1) rows clipped to the image, interior rows kept,
    equals the full-image result exactly (every sum keeps its order)."""
    ts = [torch.from_numpy(a) for a in _ecs_inputs("multi_block_h29")]
    x = ts[0]
    t, h = x.shape[0], x.shape[2]
    full = FZ.ecs_lif_rows_reference(*ts, CFG)
    tiled = torch.empty_like(full)
    for r0 in range(0, h, rb):
        r1 = min(h, r0 + rb)
        w0, w1 = max(0, r0 - (t - 1)), min(h, r1 + t - 1)
        win = FZ.ecs_lif_rows_reference(x[:, :, w0:w1], *ts[1:], CFG)
        tiled[:, :, r0:r1] = win[:, :, r0 - w0:r1 - w0]
    assert torch.equal(tiled, full)


def test_ecs_rows_wrapper_on_cpu_is_its_plain_version():
    ts = [torch.from_numpy(a) for a in _ecs_inputs("single_block")]
    before = FZ.ecs_lif_fused_rows.launches
    got = FZ.ecs_lif_fused_rows(*ts, CFG)
    assert torch.equal(got, FZ.ecs_lif_rows_reference(*ts, CFG))
    # a broadcast T axis and a transposed layout are the same values
    xb = ts[0][:1].expand(4, -1, -1, -1, -1)
    assert torch.equal(FZ.ecs_lif_fused_rows(xb, *ts[1:], CFG),
                       FZ.ecs_lif_rows_reference(xb.contiguous(), *ts[1:], CFG))
    assert FZ.ecs_lif_fused_rows.launches == before


@pytest.mark.parametrize("name", ["lif_fused", "ecs_lif_fused_rows", "ecs_lif_fused_v2"])
def test_wrappers_refuse_other_devices(name):
    ts = [torch.from_numpy(a).to("meta") for a in _ecs_inputs("single_block")]
    args = ts[:1] if name == "lif_fused" else ts
    with pytest.raises(ValueError, match="CUDA or CPU"):
        getattr(FZ, name)(*args, CFG)


@pytest.mark.parametrize("name", ["lif_fused", "ecs_lif_fused_rows", "ecs_lif_fused_v2"])
def test_a_kernel_that_cannot_build_raises_and_nothing_falls_back(name, monkeypatch):
    """On the kernel route a wrapper checks its input and builds its kernel:
    where no CUDA compiler exists that raises, it never takes the plain
    version instead."""
    from ecs_yolo_tpu_torch import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(FZ, "use_kernel", lambda x: True)
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", Path("/nonexistent-build-dir"))
    ts = [torch.from_numpy(a) for a in _ecs_inputs("single_block")]
    args = ts[:1] if name == "lif_fused" else ts
    before = getattr(FZ, name).launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        getattr(FZ, name)(*args, CFG)
    if name in OP_OF:       # the op the wrapper calls raises the same, called alone too
        with pytest.raises(RuntimeError, match="nvcc not found"):
            OP_OF[name](*args, *ops.cfg_args(CFG), False)
    assert getattr(FZ, name).launches == before
    # what the kernels do not take is refused before any build
    with pytest.raises(TypeError):
        getattr(FZ, name)(*(a.double() for a in args), CFG)
    if name == "lif_fused":
        with pytest.raises(ValueError, match="contiguous"):
            FZ.lif_fused(ts[0].transpose(2, 3), CFG)
        with pytest.raises(ValueError, match="T stride"):
            FZ.lif_fused(ts[0][::2], CFG)
    else:
        with pytest.raises(ValueError, match="pw_kernel"):
            getattr(FZ, name)(*ts[:3], ts[3][..., :2], ts[4], CFG)
    if name == "ecs_lif_fused_v2":
        # a site no Cout slice fits, and an item whose state cannot fit a
        # block's shared memory, refused before any build
        def site(h, w, c):
            return (torch.zeros(4, 1, h, w, c), torch.zeros(3, 3, 1, c), torch.zeros(c),
                    torch.zeros(1, 1, 1, 1).expand(1, 1, c, c), torch.zeros(c))

        with pytest.raises(ValueError, match="no Cout slice fits"):
            FZ.ecs_lif_fused_v2(*site(8, 8, 4000), CFG)
        with pytest.raises(ValueError, match="largest block_rows that fits is 12$"):
            FZ.ecs_lif_fused_v2(*site(40, 40, 384), CFG, block_rows=13)


#: the ops the wrappers call (``snn/ops.py``); K3 has none, its entry point is
#: the function itself
OP_OF = {"lif_fused": ops.lif, "ecs_lif_fused_rows": ops.ecs_lif_rows}


class _StubLib:
    """A built library whose every C function succeeds and is counted."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, fn_name):
        stub = self

        class Entry:
            def __call__(self, *args):
                stub.calls.append(fn_name)
                return 0
        return Entry()


@pytest.mark.parametrize("op", ["ecs_lif", "ecs_lif_rows", "lif"])
def test_each_op_call_off_the_cpu_route_counts_one_launch(op, monkeypatch):
    """Where the op's implementation takes the kernel route (``use_kernel``
    true; a stub library in place of the built one), each call through the
    op launches once and adds one to its wrapper's count; on the CPU route
    it counts nothing."""
    from ecs_yolo_tpu_torch import _build
    from ecs_yolo_tpu_torch.snn import spread as S

    lib = _StubLib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(S, "_entries", {})
    for mod in (K1, FZ):
        monkeypatch.setattr(mod, "_stream", lambda t: 7)
    wrapper = {"ecs_lif": K1.ecs_lif_fused, "ecs_lif_rows": FZ.ecs_lif_fused_rows,
               "lif": FZ.lif_fused}[op]
    x = (np.random.RandomState(4).randn(4, 1, 8, 6, 8) * 0.7).astype(np.float32)
    ts = [torch.from_numpy(a) for a in (x,) + _params(8, 1)]     # C % 8 == 0: K1's too
    args = ts[:1] if op == "lif" else ts
    call = lambda: getattr(ops, op)(*args, *ops.cfg_args(CFG), False)  # noqa: E731
    before = wrapper.launches
    call()
    assert wrapper.launches == before and not lib.calls        # the CPU route
    for mod in (K1, FZ):
        monkeypatch.setattr(mod, "use_kernel", lambda x: True)
    for k in range(1, 4):
        out = call()
        assert wrapper.launches == before + k
        assert out.shape == args[0].shape and out.is_contiguous()
    assert sum(c.endswith("_fwd") for c in lib.calls) == 3


# --- MemUpdate's dispatch ----------------------------------------------------------

DISPATCH = {
    # name: (SNNConfig overrides, channels, training, the route taken)
    "plain_lif": (dict(ecs=False), 8, False, "lif_fused"),
    "ecs_default": (dict(), 8, False, "ecs_lif_fused"),
    "ecs_fused_inference": (dict(fused_inference=True), 8, False,
                            "ecs_lif_fused_rows"),
    "ecs_c_not_multiple_of_8": (dict(), 4, False, "ecs_lif_fused_rows"),
    "ecs_non_dense_input": (dict(), 8, False, "ecs_lif_fused_rows"),
    "ecs_training": (dict(), 8, True, "ecs_lif_scan"),
    "plain_lif_training": (dict(ecs=False), 8, True, "lif_scan"),
}


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_mem_update_dispatch(case, monkeypatch):
    overrides, c, training, want = DISPATCH[case]
    calls = []
    for name in ("lif_fused", "ecs_lif_fused", "ecs_lif_fused_rows",
                 "ecs_lif_scan", "lif_scan"):
        real = getattr(PB, name)
        monkeypatch.setattr(PB, name, lambda *a, _n=name, _f=real, **k: (
            calls.append(_n), _f(*a, **k))[1])
    snn = SNNConfig(time_window=2, **overrides)
    m = PB.MemUpdate(c, snn=snn).train(training)
    x = torch.randn(2, 1, 6, 5, c, generator=torch.Generator().manual_seed(0))
    if case == "ecs_non_dense_input":
        x = x.transpose(2, 3)
    with torch.no_grad():
        y = m(x)
    assert calls == [want]
    assert y.shape == x.shape
    if not training:   # autograd on sends eval to the T-loop as well
        calls.clear()
        m(x)
        assert calls == ["ecs_lif_scan" if snn.ecs else "lif_scan"]


def test_layout_refusal_names_what_the_tensor_core_kernel_wants():
    x = torch.zeros(4, 2, 6, 5, 8)
    assert K1.layout_refusal(x) is None
    assert K1.layout_refusal(x[:1].expand(4, -1, -1, -1, -1)) is None
    assert "contiguous" in K1.layout_refusal(x.transpose(2, 3))
    assert "C % 8" in K1.layout_refusal(torch.zeros(4, 2, 6, 5, 12))
    assert "T stride" in K1.layout_refusal(x[::2])


# --- nothing of the port imports JAX -----------------------------------------------


def _port_sources():
    pkg = REPO / "ecs_yolo_tpu_torch"
    files = sorted(p for p in pkg.rglob("*.py")
                   if "_build" not in p.relative_to(pkg).parts)
    return files + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_file_imports_no_jax_and_nothing_of_the_jax_package(path):
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "ecs_yolo_tpu")
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in banned, f"{path}: imports {m}"
