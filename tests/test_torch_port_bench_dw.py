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
