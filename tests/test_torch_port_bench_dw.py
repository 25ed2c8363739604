"""The port of ``scripts/bench_pallas_dw.py``
(``ecs_yolo_tpu_torch/scripts/bench_pallas_dw.py``) against the JAX script's
own TPU kernels in interpret mode (CPU), on the same numpy inputs; and the
two ported bench scripts run end to end on the CPU.

The JAX script is no package: it is loaded from its path, and its
``INTERPRET`` switch, which its kernels read at call time, is set here.  On
the CPU the port's wrappers take their plain versions, which are what the
CUDA kernels are held to on the card.

Tolerances: float32 output to 1e-5 * (1 + |want|) (the sums run in another
order); bfloat16 output at most 1 ulp off on at most 1 % of the elements
(an f32 sum a hair from a rounding boundary may round the other way).  The
int8 planes hold -2..2: the kernels multiply, they do not select.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecs_yolo_tpu_torch.scripts import bench_pallas_dw as BD
from ecs_yolo_tpu_torch.scripts import bench_pallas_v3 as BV3
from ecs_yolo_tpu_torch.snn import spread as S

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "jax_bench_pallas_dw", REPO / "scripts" / "bench_pallas_dw.py")
JB = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(JB)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(JB, "INTERPRET", True)


def _plane(shape, seed):
    return np.random.RandomState(seed).randint(-2, 3, shape).astype(np.int8)


def _assert_close(got: torch.Tensor, want: np.ndarray, dtype: torch.dtype):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.dtype == dtype and g.shape == w.shape
    diff = np.abs(g - w)
    if dtype == torch.float32:
        assert (diff <= 1e-5 * (1 + np.abs(w))).all(), diff.max()
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert (diff <= ulp).all() and np.mean(diff > 0) <= 1e-2


# (shape, weight dtype): the JAX parity_check shape with f32 weights, and a
# ragged width with bf16 weights
DW3_CASES = {"parity_2x16x16x128": ((2, 16, 16, 128), "float32"),
             "ragged_w13_bf16_weights": ((1, 8, 13, 128), "bfloat16")}


@pytest.mark.parametrize("out", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(DW3_CASES))
def test_pallas_dw3_matches_the_tpu_kernel(case, out, interpret):
    shape, wdt = DW3_CASES[case]
    c = shape[-1]
    rng = np.random.RandomState(1)
    s8 = _plane(shape, 0)
    k = ((rng.rand(3, 3, c) - 0.5) * 0.2).astype(np.float32)
    b = ((rng.rand(c) - 0.5) * 0.1).astype(np.float32)
    tw, jw = DTYPES[wdt]
    want = JB.pallas_dw3(jnp.asarray(s8), jnp.asarray(k, jw), jnp.asarray(b, jw),
                         DTYPES[out][1])
    before = BD.pallas_dw3.launches
    got = BD.pallas_dw3(torch.from_numpy(s8), torch.from_numpy(k).to(tw),
                        torch.from_numpy(b).to(tw), DTYPES[out][0])
    assert BD.pallas_dw3.launches == before
    _assert_close(got, want, DTYPES[out][0])


# (shape, bh): the shape checked against the JAX kernel when it was ported,
# and a C = 128 site as the bench's dense sites have
DENSE_CASES = {"1x32x8x16_bh16": ((1, 32, 8, 16), 16),
               "1x16x8x128_bh8": ((1, 16, 8, 128), 8)}


@pytest.mark.parametrize("out", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_pallas_dense3_matches_the_tpu_kernel(case, out, interpret):
    shape, bh = DENSE_CASES[case]
    c = shape[-1]
    rng = np.random.RandomState(2)
    s8 = _plane(shape, 3)
    k9c = ((rng.rand(9 * c, c) - 0.5) * 0.05).astype(np.float32)
    b = ((rng.rand(c) - 0.5) * 0.1).astype(np.float32)
    want = JB.pallas_dense3(jnp.asarray(s8), jnp.asarray(k9c), jnp.asarray(b),
                            DTYPES[out][1], bh=bh)
    got = BD.pallas_dense3(torch.from_numpy(s8), torch.from_numpy(k9c),
                           torch.from_numpy(b), DTYPES[out][0], bh=bh)
    _assert_close(got, want, DTYPES[out][0])
    # bh is the TPU kernel's row block: it changes nothing in the result
    assert torch.equal(got, BD.pallas_dense3(torch.from_numpy(s8), torch.from_numpy(k9c),
                                             torch.from_numpy(b), DTYPES[out][0], bh=16))


@pytest.mark.parametrize("bh", [5, 0])
def test_pallas_dense3_refuses_h_not_a_multiple_of_bh(bh):
    s8 = torch.zeros(1, 16, 4, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="H % bh must be 0"):
        BD.pallas_dense3(s8, torch.zeros(144, 16), torch.zeros(16), bh=bh)


# (shape, route): the two bench sites, the C = 16 case, a ragged H and W, a
# slice of 16 channels, and two shapes of the "mma" route (C >= 320; C > 64
# not a multiple of 64)
PLAN_CASES = {"act1": (BD.SITES["act1"], "wgmma"), "act2": (BD.SITES["act2"], "wgmma"),
              "c16": ((1, 32, 8, 16), "wgmma"), "ragged_2x13x21x128": ((2, 13, 21, 128), "wgmma"),
              "c256_bn16": ((1, 8, 16, 256), "wgmma"), "c512": ((2, 20, 24, 512), "mma"),
              "c80": ((1, 16, 16, 80), "mma")}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_dense3_covers_every_output_once(case):
    """Over K8's walk every (tile, slice) item is taken once, a block of the
    "wgmma" route keeps one Cout slice, and the items cover every (output
    pixel, Cout) pair exactly once."""
    (n, h, w, c), route = PLAN_CASES[case]
    plan = BD.plan_dense3(n, h, w, c)
    assert plan.route == route
    items = BD.dense3_items(plan)
    block, tile, sl = items.T
    assert len(items) == plan.tiles * plan.slices
    assert len(np.unique(tile * plan.slices + sl)) == len(items)
    assert set(np.unique(block)) == set(range(plan.grid))
    if route == "wgmma":
        assert plan.bn * plan.slices == c and plan.grid % plan.slices == 0
        assert (sl == block % plan.slices).all()
        for b in (0, plan.grid - 1):             # a block walks its items in order
            assert (np.diff(tile[block == b] * plan.slices + sl[block == b]) == plan.grid).all()
        i, h0, w0 = BD.S.gemm_tile_origin(plan, h, w, tile)
        dh, dw = np.meshgrid(np.arange(plan.th), np.arange(plan.tw), indexing="ij")
        cnt = np.zeros((n, h + plan.th, w + plan.tw, plan.slices), np.int32)
        np.add.at(cnt, (i[:, None, None], h0[:, None, None] + dh, w0[:, None, None] + dw,
                        sl[:, None, None]), 1)
        assert (cnt[:, :h, :w] == 1).all()
    else:
        assert plan.grid == plan.tiles * plan.slices
        cnt = np.zeros((plan.tiles * 128, c), np.int32)
        for t, s_ in zip(tile, sl):
            cnt[t * 128:(t + 1) * 128, s_ * 64:(s_ + 1) * 64] += 1
        assert (cnt[:n * h * w] == 1).all()


def test_plan_dense3_fits_the_block_and_names_its_route():
    """Every plan's shared memory fits one block of the H100 (227 KB); the
    "wgmma" route takes C <= 64 and C = 128, 192, 256 with the widest slice
    that fits, every other C % 16 the "mma" route; C % 16 != 0 is
    refused."""
    for c in range(16, 1025, 16):
        for n, h, w in ((1, 8, 16), (16, 320, 160), (2, 13, 21)):
            plan = BD.plan_dense3(n, h, w, c)
            assert plan.smem <= BD.S.SMEM_PER_BLOCK, (c, plan)
            resident = c <= 64 or c in (128, 192, 256)
            assert plan.route == ("wgmma" if resident else "mma"), (c, plan)
            if resident:
                assert plan.smem == BD.dense3_smem(c, plan.bn, plan.cw)
                assert (plan.cw, plan.bn, c // plan.cw) in BD.DENSE3_INSTANCES
                wider = [b for b in (64, 32, 16) if b > plan.bn and c > 64]
                assert all(BD.dense3_smem(c, b, 64) > BD.S.SMEM_PER_BLOCK
                           for b in wider), (c, plan)
    plan = BD.plan_dense3(*BD.SITES["act1"])
    assert (plan.th, plan.tw, plan.bn, plan.slices, plan.grid) == (16, 8, 64, 2, 132)
    with pytest.raises(ValueError, match="multiple of 16"):
        BD.plan_dense3(1, 8, 8, 40)


@pytest.mark.parametrize("shape", [(1, 11, 21, 128), (1, 8, 16, 48), (1, 9, 12, 80)])
def test_dense3_tile_walk_is_the_plain_version_bit_for_bit(shape):
    """K8's walk over its plan against the plain version, both output dtypes,
    on dyadic data with a full-range int8 plane (-128..127): every sum is
    exact in float32, so any summation order must agree bit for bit."""
    c = shape[-1]
    rng = np.random.RandomState(7)
    s8 = torch.from_numpy(rng.randint(-128, 128, shape).astype(np.int8))
    k9c = torch.from_numpy(rng.randint(-16, 17, (9 * c, c)).astype(np.float32) / 64)
    b = torch.from_numpy(rng.randint(-64, 65, c).astype(np.float32) / 64)
    assert s8.min() == -128 and s8.max() == 127
    plan = BD.plan_dense3(*shape)
    for out in (torch.float32, torch.bfloat16):
        got = BD.dense3_tile_walk_reference(s8, k9c, b, out, plan)
        assert torch.equal(got, BD.pallas_dense3_reference(s8, k9c, b, out)), (plan, out)


@pytest.mark.parametrize("name", ["xla_dw3", "xla_dense3"])
def test_library_convolutions_match_their_jax_namesakes(name):
    shape = (2, 9, 7, 32)
    c = shape[-1]
    rng = np.random.RandomState(4)
    s8 = _plane(shape, 5)
    kshape = (3, 3, 1, c) if name == "xla_dw3" else (3, 3, c, c)
    k = ((rng.rand(*kshape) - 0.5) * 0.2).astype(np.float32)
    b = ((rng.rand(c) - 0.5) * 0.1).astype(np.float32)
    want = getattr(JB, name)(jnp.asarray(s8), jnp.asarray(k), jnp.asarray(b), jnp.float32)
    got = getattr(BD, name)(torch.from_numpy(s8), torch.from_numpy(k), torch.from_numpy(b),
                            torch.float32)
    _assert_close(got, want, torch.float32)


@pytest.mark.parametrize("name", ["pallas_dw3", "pallas_dense3"])
def test_a_kernel_that_cannot_build_raises_and_nothing_falls_back(name, monkeypatch):
    """On the kernel route a wrapper checks its input and builds its kernel:
    where no CUDA compiler exists that raises; what the kernel does not take
    is refused before any build."""
    from ecs_yolo_tpu_torch import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(BD, "use_kernel", lambda x: True)
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", Path("/nonexistent-build-dir"))
    fn = getattr(BD, name)
    c = 32
    k = torch.zeros(3, 3, c) if name == "pallas_dw3" else torch.zeros(9 * c, c)
    s8 = torch.zeros(1, 16, 4, c, dtype=torch.int8)
    before = fn.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fn(s8, k, torch.zeros(c))
    assert fn.launches == before
    with pytest.raises(TypeError, match="int8"):
        fn(s8.float(), k, torch.zeros(c))
    with pytest.raises(TypeError, match="out_dtype"):
        fn(s8, k, torch.zeros(c), torch.float16)
    narrow = 8 if name == "pallas_dw3" else 16
    with pytest.raises(ValueError, match=f"C % {narrow}"):
        fn(s8[..., :narrow - 4].contiguous(), k, torch.zeros(c))


def test_h100_bounds_of_the_bench_sites():
    """Operations bound the dense sites (2 * 9 * C^2 * N*H*W against 989
    TFLOP/s bf16), bytes the depthwise ones (int8 in, bf16 out)."""
    ms, by = BD.bound_ms(True, BD.SITES["act1"], torch.bfloat16)
    assert by == "operations" and abs(ms - 0.2443) < 1e-4
    ms, by = BD.bound_ms(True, BD.SITES["act2"], torch.bfloat16)
    assert by == "operations" and abs(ms - 0.0611) < 1e-4
    for site in ("c128", "c256", "c512"):
        n, h, w, c = BD.SITES[site]
        ms, by = BD.bound_ms(False, BD.SITES[site], torch.bfloat16)
        assert by == "bytes" and abs(ms - (3 * n * h * w * c + 20 * c) / 3.35e9) < 1e-9


def test_bench_pallas_dw_main_runs_on_the_cpu(capsys):
    assert BD.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "parity pallas_dw3 (2, 16, 16, 128)" in out
    assert "parity pallas_dense3 (2, 16, 16, 128)" in out
    assert "times: not measured (no card)" in out
    with pytest.raises(RuntimeError, match="on the card only"):
        BD.bench(BD.SITES["c128"], "c128", "cpu")


def test_bench_pallas_v3_main_runs_on_the_cpu(capsys):
    assert BV3.main(["--device", "cpu", "--shape", "2", "1", "8", "8", "16"]) == 0
    out = capsys.readouterr().out
    assert "spike mismatch: 0.000000" in out and "times: not measured" in out


@pytest.mark.parametrize("out", sorted(DTYPES))
@pytest.mark.parametrize("shape,sms", [((2, 13, 21, 24), 132), ((1, 9, 7, 128), 1),
                                       ((1, 5, 20, 1024), 132)],
                         ids=["2x13x21x24", "1x9x7x128-sms1", "1x5x20x1024"])
def test_dw3_tile_walk_is_the_plain_version_bit_for_bit(shape, sms, out):
    """K7's int8-in mode on K4's plan: full-range int8 planes with dyadic
    weights and bias (multiples of 1/64, |k| <= 1/4: every sum exact in
    f32), f32 and bf16 weights, the walk gives ``pallas_dw3_reference``'s
    bits."""
    c = shape[-1]
    rng = np.random.RandomState(c)
    s8 = torch.from_numpy(rng.randint(-128, 128, shape).astype(np.int8))
    k = torch.from_numpy(rng.randint(-16, 17, (3, 3, c)).astype(np.float32) / 64)
    b = torch.from_numpy(rng.randint(-64, 65, c).astype(np.float32) / 64)
    out_dtype = DTYPES[out][0]
    for wdt in (torch.float32, torch.bfloat16):
        plan = S.plan_dw3(*shape, sms, 1, wdt.itemsize)
        got, same = S.dw3_tile_walk_reference(s8, k.to(wdt), b.to(wdt), plan, out_dtype)
        assert same is s8 and got.dtype == out_dtype
        assert torch.equal(got, BD.pallas_dw3_reference(s8, k.to(wdt), b.to(wdt), out_dtype))


def test_pallas_dw3_binds_once_and_passes_the_int8_plane(monkeypatch):
    """A stub library in place of the built one: ``pallas_dw3`` loads it
    once and sets the entry's argtypes once over many calls; each call
    passes the int8 plane (code 2) with no int8 output, the weights' and
    the output's dtype codes and K4's plan for an int8 plane, and counts one
    launch."""
    import ctypes

    from ecs_yolo_tpu_torch import _build

    calls, binds = [], []

    class Entry:
        def __setattr__(self, name, value):
            binds.append(name)
            object.__setattr__(self, name, value)

        def __call__(self, block):       # the launch's 18 int64 arguments
            calls.append(tuple((ctypes.c_longlong * 18).from_address(block)))
            return 0

    class Lib:
        spread_dw3_fwd = Entry()

    loads = []
    monkeypatch.setattr(_build, "load", lambda name: loads.append(name) or Lib)
    monkeypatch.setattr(S, "_entries", {})
    monkeypatch.setattr(BD, "use_kernel", lambda x: True)
    monkeypatch.setattr(S, "_stream", lambda t: 5)
    s8 = torch.from_numpy(_plane((2, 6, 10, 32), 0))
    k, b = torch.zeros(3, 3, 32, dtype=torch.bfloat16), torch.zeros(32, dtype=torch.bfloat16)
    before = BD.pallas_dw3.launches
    for _ in range(3):
        y = BD.pallas_dw3(s8, k, b, torch.float32)
    assert loads == ["spread_dw3"] and binds.count("argtypes") == 1
    assert BD.pallas_dw3.launches == before + 3 and y.dtype == torch.float32
    plan = S.plan_dw3(2, 6, 10, 32, 132, 1, 2)
    assert calls[-1] == (2, 1, 0, s8.data_ptr(), k.data_ptr(), b.data_ptr(), y.data_ptr(),
                         0, 2, 6, 10, 32, *plan, 5)
