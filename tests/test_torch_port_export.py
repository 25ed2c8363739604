"""The port's kernel ops (``snn/ops.py``) and its export (``export.py``)
against their plain versions and the JAX package (CPU).

* The ops' CPU implementations are the plain versions: bit-equal outputs
  (``torch.equal``), also on a broadcast T axis; their fake implementations
  give the shape and dtype alone; ``torch.library.opcheck`` holds schema
  and fake implementation together.
* A traced and an exported narrowed res10 hold one op node per neuron site
  (a launch the exporter could not see would leave none), and each artifact,
  reloaded through ``backends.DetectMultiBackend``, is bit-equal to the
  eager port in float32 (``torch.equal``): the graph runs the same
  operators on the same inputs.  The eager port is held to JAX's model in
  ``tests/test_torch_port_model.py``.
* ``metadata.json`` equals JAX ``export.run``'s for the same model; an
  unknown format raises ``KeyError`` in both packages.
"""

import json

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ecs_yolo_tpu import export as jax_export
from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu.models import yolo as jax_yolo
from ecs_yolo_tpu_torch import backends, export
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.models import yolo as port_yolo
from ecs_yolo_tpu_torch.nn.blocks import MemUpdate
from ecs_yolo_tpu_torch.snn import ecs_lif as K1
from ecs_yolo_tpu_torch.snn import fused as FZ
from ecs_yolo_tpu_torch.snn import ops

torch.set_num_threads(2)

T = 2
CFG = SNNConfig(time_window=T)


def _site(shape, seed, dtype=torch.float32, broadcast=False):
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=g)
    if broadcast:
        x = x[:1].expand(shape)
    params = (torch.randn(3, 3, 1, c, generator=g) * 0.3, torch.randn(c, generator=g) * 0.2,
              torch.randn(1, 1, c, c, generator=g) / c ** 0.5, torch.randn(c, generator=g) * 0.2)
    return x.to(dtype), [p.to(dtype) for p in params]


OPS = {"ecs_lif": (ops.ecs_lif, K1.ecs_lif_reference),
       "ecs_lif_rows": (ops.ecs_lif_rows, FZ.ecs_lif_rows_reference),
       "lif": (ops.lif, FZ.lif_reference)}


def _op_args(name, x, params, act):
    return ((x,) if name == "lif" else (x, *params)) + ops.cfg_args(CFG) + (act,)


def _plain(name, x, params, act):
    ref = OPS[name][1]
    return ref(x, CFG, act) if name == "lif" else ref(x, *params, CFG, act)


@pytest.mark.parametrize("act", [False, True], ids=["spike", "silu"])
@pytest.mark.parametrize("case", ["f32", "bf16", "broadcast"])
@pytest.mark.parametrize("name", sorted(OPS))
def test_op_cpu_implementation_is_the_plain_version(name, case, act):
    x, params = _site((3, 2, 5, 6, 8), seed=len(name) + len(case),
                      dtype=torch.bfloat16 if case == "bf16" else torch.float32,
                      broadcast=case == "broadcast")
    got = OPS[name][0](*_op_args(name, x, params, act))
    want = _plain(name, x, params, act)
    assert got.dtype == x.dtype and got.shape == x.shape and got.is_contiguous()
    assert torch.equal(got, want)
    if not act:
        assert 0 < float(got.float().mean()) < 1      # spikes, not a constant


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_fake_implementation_gives_shape_and_dtype(name):
    x, params = _site((3, 2, 5, 6, 8), seed=3, dtype=torch.bfloat16, broadcast=True)
    with FakeTensorMode() as mode:
        fx = mode.from_tensor(x)
        fparams = [mode.from_tensor(p) for p in params]
        out = OPS[name][0](*_op_args(name, fx, fparams, False))
    assert out.shape == x.shape and out.dtype == x.dtype and out.is_contiguous()
    assert out.device == x.device
    torch.library.opcheck(OPS[name][0], _op_args(name, x, params, False),
                          test_utils=("test_schema", "test_faketensor"))


def _narrow_res10():
    d = port_yolo.load_cfg("resnet10.yaml")
    d["width_multiple"] = 0.25
    return d


def _lively(model, seed):
    """Random BN affine and statistics, so that the sites fire (with the
    init's mean 0 / variance 1 nearly every site after the stem is silent)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("bn.weight") or name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif name.endswith("bn.bias"):
                t.copy_((torch.rand(t.shape, generator=g) - 0.5) * 0.4)
            elif name.endswith("running_mean"):
                t.copy_(torch.randn(t.shape, generator=g) * 0.2)
    return model


ROUTES = {"ecs_lif": {}, "lif": {"ecs": False}, "ecs_lif_rows": {"fused_inference": True}}


def _graph_ops(loaded, fmt):
    """The port ops a loaded artifact calls, in graph order."""
    if fmt == "torchscript":
        names = [n.kind() for n in loaded.inlined_graph.nodes()]
    else:       # targets print as ecs_yolo_torch.ecs_lif.default
        names = [str(n.target).removesuffix(".default").replace(".", "::", 1)
                 for n in loaded.graph.nodes if n.op == "call_function"]
    return [n.split("::")[1] for n in names if n.startswith("ecs_yolo_torch::")]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_artifacts_hold_one_op_node_a_site_and_equal_the_eager_model(route, tmp_path):
    """Every route traced; the default route (K1) also through
    ``torch.export``, whose graph keeps ``MemUpdate.firing_rate`` (set by a
    training forward) out."""
    model = _lively(port_yolo.build_model(
        _narrow_res10(), nc=2, snn=SNNConfig(time_window=T, **ROUTES[route]), device="cpu",
        imgsz=64), seed=4)
    sites = sum(isinstance(m, MemUpdate) for m in model.modules())
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = model(x)[0]
    formats = ("torchscript", "pt2") if route == "ecs_lif" else ("torchscript",)
    paths = export.run(model, formats, tmp_path, imgsz=64, batch=2)
    for fmt in formats:
        b = backends.DetectMultiBackend(paths[fmt], device="cpu")
        assert _graph_ops(b.model, fmt) == [route] * sites == [route] * 24, fmt
        got = b.forward(x)
        assert torch.equal(got, want), fmt
        assert b.predict(x.numpy()).shape == tuple(want.shape)
        if fmt == "pt2":
            assert not any("firing_rate" in str(n.target) for n in b.model.graph.nodes)
    assert all(m.firing_rate is None for m in model.modules() if isinstance(m, MemUpdate))
    assert (tmp_path / "metadata.json").is_file()


def test_native_checkpoint_loads_back_through_the_backend(tmp_path):
    model = _lively(port_yolo.build_model(_narrow_res10(), nc=2, snn=CFG, device="cpu",
                                          imgsz=64), seed=6)
    paths = export.run(model, ("native",), tmp_path, imgsz=64)
    b = backends.DetectMultiBackend(paths["native"], cfg=_narrow_res10(), device="cpu",
                                    snn=CFG)
    x = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(b.forward(x), model(x)[0])
    assert (b.head_name, b.nc) == ("Detect", 2)
    with pytest.raises(ValueError, match="cfg"):
        backends.DetectMultiBackend(paths["native"], device="cpu")


@pytest.mark.parametrize("names", [None, ["car", "person"]])
def test_metadata_equals_jax_export_run(names, tmp_path):
    d = _narrow_res10()
    jm = jax_yolo.build_model(d, nc=2, snn=JaxSNNConfig(time_window=T))
    jax_export.run(jm, None, include=(), out_dir=tmp_path / "jax", imgsz=64, batch=2,
                   names=names)
    pm = port_yolo.build_model(d, nc=2, snn=CFG, device="cpu", imgsz=64)
    export.run(pm, ("native",), tmp_path / "port", imgsz=64, batch=2, names=names)
    got = json.loads((tmp_path / "port" / "metadata.json").read_text())
    assert got == json.loads((tmp_path / "jax" / "metadata.json").read_text())


@pytest.mark.parametrize("fmt", ["onnx", "tflite", "stablehlo", "saved_model"])
def test_an_unknown_format_raises_in_both_packages(fmt, tmp_path):
    model = port_yolo.build_model(_narrow_res10(), nc=2, snn=CFG, device="meta")
    with pytest.raises(KeyError, match="torchscript"):
        export.run(model, (fmt,), tmp_path)
    assert not (tmp_path / "metadata.json").exists()
    if fmt == "onnx":
        jm = jax_yolo.build_model(_narrow_res10(), nc=2, snn=JaxSNNConfig(time_window=T))
        with pytest.raises(KeyError, match="stablehlo"):
            jax_export.run(jm, None, include=(fmt,), out_dir=tmp_path / "jax")
    assert set(export.export_formats()) == {"torchscript", "pt2", "native"}
