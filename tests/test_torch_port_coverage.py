"""Every public name of the JAX package has a counterpart in the port, or a
written reason why it has none.

Each ``ecs_yolo_tpu/**/*.py`` module is parsed with ``ast`` (nothing is
imported, so no JAX): its public top-level names (functions, classes,
module-level assignments) must be defined or imported at the top level of
the port's module of the same path, be exempted in ``EXEMPT_NAMES`` with a
reason, or have moved to the port module ``MOVED`` names.  A JAX module the
port has no file for must be in ``EXEMPT_FILES``.  An exemption the port no
longer needs (the name or file exists there now) fails, as does one that
names nothing of the JAX package.  The same table stands in ``ROADMAP.md``.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = REPO / "ecs_yolo_tpu", REPO / "ecs_yolo_tpu_torch"

_LAYOUT = ("math-only layout device (the packed / thin layouts and their custom VJPs): the "
           "port runs the canonical layout and its SNNConfig takes their flags and ignores "
           "them")
_MESH = "JAX mesh / sharding API: the port's layout is process subgroups, see parallel/mesh.shard_plan"

#: JAX modules the port has no file for
EXEMPT_FILES = {
    "nn/bn_vjp.py": _LAYOUT,
    "nn/pool_vjp.py": _LAYOUT,
    "nn/spike_conv.py": _LAYOUT,
    "nn/thin_conv.py": _LAYOUT,
    "snn/packed_spread.py": _LAYOUT,
    "snn/pallas_dw.py": "Pallas kernels, replaced by csrc/spread_dw3.cu + csrc/spread_gemm.cu "
                        "behind snn/spread.py",
    "snn/pallas_ecs_v3.py": "Pallas kernel, replaced by csrc/ecs_lif.cu behind snn/ecs_lif.py",
    "snn/pallas_kernels.py": "Pallas kernels, replaced by csrc/lif_fused.cu, csrc/ecs_lif_rows.cu "
                             "+ csrc/ecs_lif_v2.cu behind snn/fused.py",
}

#: (JAX module, name) without a counterpart
EXEMPT_NAMES = {
    ("config.py", "DEFAULT_COMPUTE_DTYPE"):
        "read nowhere in the JAX package; the port's dtype is explicit (cast_params, --dtype, "
        "--bf16)",
    ("export.py", "export_saved_model"): "needs TensorFlow, absent on the card machine",
    ("export.py", "export_stablehlo"): "needs JAX",
    ("export.py", "export_tflite"): "needs TensorFlow, absent on the card machine",
    ("models/yolo.py", "BuiltModel"):
        "flax shape inference: the port builds from tensors (build_layers), and its "
        "DetectionModel carries the spec, head and strides",
    ("nn/blocks.py", "max_pool_t_packed"): _LAYOUT,
    ("nn/blocks_ext.py", "np_cumsum"):
        "split offsets for jnp.split; torch.split takes the sizes (CBLinear)",
    ("nn/initializers.py", "make_bias_init"):
        "flax initializer factory; the port's init_weights draws in place (torch_conv_init_)",
    ("nn/initializers.py", "torch_conv_bias_init"):
        "flax initializer; the port's torch_conv_init_ draws the same bound in place",
    ("nn/initializers.py", "torch_conv_kernel_init"):
        "flax initializer; the port's torch_conv_init_ draws the same bound in place",
    ("ops/nms.py", "NEG_INF"):
        "the dead-score sentinel of JAX's fixed-length scan; the port's greedy walk keeps a "
        "removed mask on the host (ops/nms_variants.NEG_INF is ported)",
    ("parallel/mesh.py", "batch_sharding"): _MESH,
    ("parallel/mesh.py", "make_mesh"): _MESH,
    ("parallel/mesh.py", "make_mesh_2d"): _MESH,
    ("parallel/mesh.py", "replicate_tree"): _MESH,
    ("parallel/mesh.py", "replicated"): _MESH,
    ("parallel/mesh.py", "shard_batch"): _MESH,
    ("parallel/mesh.py", "shard_params"): _MESH,
    ("parallel/multihost.py", "to_global"):
        "JAX global-array assembly; a torch rank keeps its local rows and reduces explicitly",
}

#: (JAX module, name) -> the port module that holds it
MOVED = {("nn/blocks_tail2.py", "BasicBlock_ms1"): "nn/blocks_tail.py"}


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def defined(path: Path) -> set:
    """Public names a module defines at its top level."""
    out = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out |= {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}
    return {n for n in out if not n.startswith("_")}


def importable(path: Path) -> set:
    """What ``from <module> import name`` finds: its definitions and the
    names it imports at its top level."""
    out = defined(path)
    for node in _tree(path).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_is_ported_or_exempted(module):
    port = PORT_PKG / module
    if module in EXEMPT_FILES:
        assert not port.exists(), f"stale file exemption: the port has {module}"
        return
    assert port.is_file(), f"the port has no {module} and no exemption says why"
    have = importable(port)
    missing = []
    for name in sorted(defined(JAX_PKG / module)):
        key = (module, name)
        if key in EXEMPT_NAMES:
            assert name not in have, f"stale exemption: the port's {module} has {name}"
        elif key in MOVED:
            assert name not in have, f"stale move: the port's {module} has {name}"
            assert name in defined(PORT_PKG / MOVED[key]), f"{name} is not in {MOVED[key]}"
        elif name not in have:
            missing.append(name)
    assert not missing, f"{module}: no counterpart and no exemption for {missing}"


def test_every_exemption_names_something_of_the_jax_package():
    assert set(EXEMPT_FILES) <= set(JAX_MODULES)
    for module, name in [*EXEMPT_NAMES, *MOVED]:
        assert module in JAX_MODULES and name in defined(JAX_PKG / module), (module, name)
    assert all(reason.strip() for reason in [*EXEMPT_FILES.values(), *EXEMPT_NAMES.values()])


def _literal(path: Path, name: str):
    for node in _tree(path).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


@pytest.mark.parametrize("module,name", [("nn/heads.py", "HEAD_NAMES"),
                                         ("data/loaders.py", "VID_FORMATS"),
                                         ("data/dataset.py", "IMG_FORMATS")])
def test_ported_constants_equal_jax(module, name):
    assert _literal(PORT_PKG / module, name) == _literal(JAX_PKG / module, name)


def test_head_names_are_the_heads_the_port_builds():
    from ecs_yolo_tpu_torch.models.yolo import HEADS
    from ecs_yolo_tpu_torch.nn.heads import HEAD_NAMES

    assert tuple(HEADS) == HEAD_NAMES
