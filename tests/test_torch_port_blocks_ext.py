"""The blocks of the EE / SEW residuals, the v9 wiring, EMA attention and the
RT-DETR neck against the JAX package (CPU): ``BasicBlock``,
``BasicBlock_ms`` (stride 1 and 2), ``BasicBlock_ms1``, ``ConcatBlock_ms``,
``CBLinear``, ``CBFuse`` (a 2x and an 8/3 nearest resize), ``EMAAttention``,
``RepConv`` (with and without ``id_bn``), ``RepC3`` and ``AIFI`` (h != w,
both odd, so the w-major position embedding shows), each in eval and in
training with the moved BN statistics; each block's JAX variables through
``models/convert.py`` with ``strict=True``; the conv/bn pairs
``fuse_conv_bn`` folds against JAX's walk, on each block and on the whole
tree of a narrowed ``resnet10-v9`` taken from one ``jax.eval_shape`` of its
init; and the smoke script's ``ZOO_SITES`` table against the models' hooks.

Tolerances: float64 on both sides, 1e-9 (eval, where the port's neuron
sites take their kernels' plain versions, and training).  ``AIFI``'s
position embedding is float32 on both sides (JAX builds it in float32 and
casts it); ``sin`` / ``pow`` differ by one float32 ulp in a few per cent of
its entries between the libraries (the embedding alone: 1e-6), which the
spikes behind the attention absorb, so the block agrees to 1e-9.
"""

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu.models import utils as JMU
from ecs_yolo_tpu.models import yolo as jax_yolo
from ecs_yolo_tpu.nn import blocks as JB
from ecs_yolo_tpu.nn import blocks_ext as JBX
from ecs_yolo_tpu.nn import blocks_tail as JBT
from ecs_yolo_tpu.nn import blocks_tail2 as JBT2
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.models import convert as CV
from ecs_yolo_tpu_torch.models import utils as PMU
from ecs_yolo_tpu_torch.models import yolo as port_yolo
from ecs_yolo_tpu_torch.nn import blocks as PB
from ecs_yolo_tpu_torch.nn import blocks_ext as PBX
from ecs_yolo_tpu_torch.nn import blocks_tail as PBT
from test_torch_port_heads import _FAST, _assert_tree_close, _jax_f64
from test_torch_port_model import _random_variables, _x
from test_torch_port_zoo import _narrow, meta_model

torch.set_num_threads(2)

T = 2
JSNN = JaxSNNConfig(time_window=T)
SNN = SNNConfig(time_window=T)

# name -> (JAX block, port block, input shape [T, N, H, W, C], tolerance)
BLOCKS = {
    "BasicBlock-s2": (lambda: JB.BasicBlock(16, 3, 2, snn=JSNN),
                      lambda: PB.BasicBlock(8, 16, 3, 2, snn=SNN), (T, 2, 8, 8, 8), 1e-9),
    "BasicBlock-s1": (lambda: JB.BasicBlock(16, 3, 1, snn=JSNN),
                      lambda: PB.BasicBlock(16, 16, 3, 1, snn=SNN), (T, 2, 6, 6, 16), 1e-9),
    "BasicBlock_ms-s1": (lambda: JBT.BasicBlock_ms(16, 3, 1, snn=JSNN),
                         lambda: PBT.BasicBlock_ms(16, 16, 3, 1, snn=SNN),
                         (T, 2, 6, 6, 16), 1e-9),
    "BasicBlock_ms-s2": (lambda: JBT.BasicBlock_ms(16, 3, 2, snn=JSNN),
                         lambda: PBT.BasicBlock_ms(8, 16, 3, 2, snn=SNN),
                         (T, 2, 8, 8, 8), 1e-9),
    "BasicBlock_ms1-k1": (lambda: JBT2.BasicBlock_ms1(8, 1, 1, snn=JSNN),
                          lambda: PBT.BasicBlock_ms1(16, 8, 1, 1, snn=SNN),
                          (T, 2, 6, 6, 16), 1e-9),
    "ConcatBlock_ms": (lambda: JBT.ConcatBlock_ms(32, 3, 2, snn=JSNN),
                       lambda: PBT.ConcatBlock_ms(8, 32, 3, 2, snn=SNN),
                       (T, 2, 8, 8, 8), 1e-9),
    "Conv_2-yaml-slot": (lambda: JB.Conv_2(8, 3, 2, None, 1, False, snn=JSNN),
                            lambda: PB.Conv_2(3, 8, 3, 2, None, 1, False, snn=SNN),
                            (T, 2, 16, 16, 3), 1e-9),
    "CBLinear": (lambda: JBX.CBLinear((8, 16), snn=JSNN),
                 lambda: PBX.CBLinear(16, (8, 16), snn=SNN), (T, 2, 4, 4, 16), 1e-9),
    "EMA": (lambda: JBX.EMAAttention(4, snn=JSNN),
            lambda: PBX.EMAAttention(32, 4, snn=SNN), (T, 2, 5, 7, 32), 1e-9),
    "RepConv": (lambda: JBX.RepConv(16, snn=JSNN),
                lambda: PBX.RepConv(8, 16, snn=SNN), (T, 2, 6, 6, 8), 1e-9),
    "RepConv-id_bn": (lambda: JBX.RepConv(16, use_id_bn=True, snn=JSNN),
                      lambda: PBX.RepConv(16, 16, use_id_bn=True, snn=SNN),
                      (T, 2, 6, 6, 16), 1e-9),
    "RepC3": (lambda: JBX.RepC3(16, 2, snn=JSNN),
              lambda: PBX.RepC3(8, 16, 2, snn=SNN), (T, 2, 6, 6, 8), 1e-9),
    "AIFI": (lambda: JBX.AIFI(32, 4, snn=JSNN),
             lambda: PBX.AIFI(16, 32, 4, snn=SNN), (T, 2, 3, 5, 16), 1e-9),
}


def _folded_in_jax(v, prefix=""):
    """The modules whose conv/bn pair JAX's ``fuse_conv_bn`` folds: those
    whose BN running mean it resets to zero, under the torch names."""
    if prefix:      # a whole model's tree: layers_{i} -> model.{i}; one compile
        stats = jax.jit(JMU.fuse_conv_bn, compiler_options=_FAST)(v)["batch_stats"]
        sd = CV.convert({}, stats, prefix, leaf=lambda b, p, w: w)
    else:
        stats = JMU.fuse_conv_bn(v)["batch_stats"]
        sd = CV.convert_block("block", {}, stats, leaf=lambda b, p, w: w)
    end = "bn.bn.running_mean"
    return {k[:-len(end)].rstrip(".") for k, w in sd.items()
            if (k == end or k.endswith("." + end)) and not np.asarray(w).any()}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax_f64_in_eval_and_training(name):
    """Eval output, training output and the moved BN statistics in float64;
    the JAX variables load with ``strict=True``; the folded pairs are
    JAX's."""
    jax_mod, port_mod, shape, tol = BLOCKS[name]
    x = _x(shape, seed=len(name))
    v, (want, (want_t, upd)) = _jax_f64(jax_mod(), x, seed=len(name) + 1, training=True)
    block = port_mod().double()
    block.load_state_dict({k: t.double() for k, t in CV.convert_block(
        name, v["params"], v.get("batch_stats")).items()}, strict=True)
    xt = torch.from_numpy(x).double()
    with torch.no_grad():
        got = block.eval()(xt)
    got_t = block.train()(xt)
    _assert_tree_close(got, want, tol)
    _assert_tree_close(got_t, want_t, tol)
    sd = block.state_dict()
    for k, w in CV.convert_block(name, {}, upd.get("batch_stats", {})).items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-12, rtol=0)
    want_folded = _folded_in_jax(v) if "batch_stats" in v else set()
    assert set(PMU.fuse_conv_bn(block)) == want_folded
    if name.startswith("BasicBlock-") or name == "RepC3":
        assert want_folded == {"cv1", "cv2"}        # RepConv's conv1/bn1 stay


@pytest.mark.parametrize("idx", [(0, 0), (1, 0)])
def test_cbfuse_matches_jax_nearest_resize(idx):
    """Groups picked from two ``CBLinear`` lists, one resized 2x (4 -> 8) and
    one by 8/3 (3 -> 8), where ``F.interpolate`` would pick other pixels;
    float64."""
    a = [_x((T, 2, 4, 4, 8), 1), _x((T, 2, 4, 4, 8), 2)]
    b = [_x((T, 2, 3, 3, 8), 3), _x((T, 2, 3, 3, 8), 4)]
    target = _x((T, 2, 8, 8, 8), 5)
    with jax.enable_x64():
        j = lambda z: np.asarray(z, np.float64)
        want = JBX.CBFuse(idx).apply({}, [[j(z) for z in a], [j(z) for z in b], j(target)])
    d = lambda z: torch.from_numpy(z).double()
    got = PBX.CBFuse(idx)([[d(z) for z in a], [d(z) for z in b], d(target)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12, rtol=0)
    # the 8/3 resize: F.interpolate's "nearest" reads other pixels
    sel = d(b[0])
    ours = PBX.resize_nearest(sel, (8, 8), axes=(-3, -2))
    lib = torch.nn.functional.interpolate(sel.reshape(-1, 3, 3, 8).permute(0, 3, 1, 2),
                                          size=(8, 8)).permute(0, 2, 3, 1)
    assert not torch.equal(lib.reshape(ours.shape), ours)


def test_sincos_embedding_is_w_major():
    """The embedding's rows run over w first (``meshgrid(w, h, "ij")``), as
    JAX builds it, in float32."""
    got = PBX.sincos_pos_embed_2d(5, 3, 16)
    want = np.asarray(jax.jit(JBX.sincos_pos_embed_2d, static_argnums=(0, 1, 2),
                              compiler_options=_FAST)(5, 3, 16))
    assert got.dtype == torch.float32 and got.shape == (1, 15, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # row r is (w = r // h, h = r % h): the sin of the w half changes every h rows
    np.testing.assert_array_equal(got[0, :3, 0].numpy(), np.zeros(3, np.float32))
    assert float(got[0, 3, 0]) != 0.0


def test_token_lif_sites_take_the_lif_kernel_route():
    """AIFI's six neuron points go through ``lif_fused`` in eval (its plain
    version on the CPU, no launch), through ``lif_scan`` in training;
    whatever ``snn.ecs`` says."""
    from ecs_yolo_tpu_torch.snn import fused as FZ
    from ecs_yolo_tpu_torch.snn import neuron as N

    block = PBX.AIFI(16, 32, 4, snn=SNN).double().eval()
    x = torch.from_numpy(_x((T, 1, 3, 5, 16), 9)).double()
    calls = []
    real = FZ.lif_reference
    FZ.lif_reference = lambda *a, **k: (calls.append(a[0].shape), real(*a, **k))[1]
    try:
        with torch.no_grad():
            block(x)
    finally:
        FZ.lif_reference = real
    assert calls == [(T, 1, 15, 16)] * 4 + [(T, 1, 15, 32), (T, 1, 15, 16)]
    tokens = torch.from_numpy(_x((T, 1, 15, 16), 10)).double()
    assert torch.equal(PBX.TokenLIF(SNN)(tokens), N.lif_scan(tokens, SNN))


# --- a whole tree ------------------------------------------------------------------


def test_resnet10_v9_tree_converts_and_folds_as_jax():
    """The whole variables tree of a narrowed ``resnet10-v9`` (one abstract
    JAX init, filled from a numpy seed) loads into the port's model with
    ``strict=True``, and the fold takes JAX's pairs (the stems and every
    ``Conv_1``; no ``CBLinear`` conv)."""
    d = _narrow("resnet10-v9.yaml")
    pm = port_yolo.build_model(d, nc=3, snn=SNN, device="cpu")
    spec, save, chs, hi = jax_yolo.parse_model(dict(d, nc=3), 3)
    final = jax_yolo._with_head_args(spec, hi["index"], hi["name"], hi,
                                     strides=pm.head_info["strides"])
    assert final == pm.spec
    module = jax_yolo.DetectionModel(spec=final, save=save, snn=JSNN)
    x = jnp.zeros((1, 32, 32, 3))
    v = _random_variables(lambda: module.init(jax.random.PRNGKey(0), x), 5)
    sd = CV.convert(v["params"], v["batch_stats"], pm.spec)
    pm.load_state_dict(sd, strict=True)
    assert any(k.startswith("model.16.conv.") for k in sd)       # CBLinear
    want = _folded_in_jax(v, prefix=pm.spec)
    assert set(PMU.fuse_conv_bn(pm)) == want
    assert {"model.1", "model.19"} <= want and not any(".16" in k for k in want)


# --- the smoke script's table ------------------------------------------------------


def zoo_counts(cfg: str):
    """``site_counts`` of the YAML ``cfg`` (its nc: the sites do not depend
    on it)."""
    return site_counts(meta_model(cfg))


def site_counts(model):
    """Per model at 640 px, T=4, on the meta device: (neuron sites,
    K1, K2 and K6 launches of one eval forward, K5 and K4 launches of one
    training forward).  A ``MemUpdate`` site takes K1 unless K1 refuses its
    layout (``layout_refusal``), then K2; a ``TokenLIF`` site (``AIFI``,
    ``MHSA``, ``DSSA``) K6; in training each spiking ECS site of T-1 steps
    the kernel ``spread_route`` names (none for a SiLU site)."""
    from ecs_yolo_tpu_torch.snn import ecs_lif as K
    from ecs_yolo_tpu_torch.snn import spread as S

    t = chip_smoke.T
    c = dict(sites=0, k1=0, k2=0, k6=0, gemm=0, dw3=0)

    def mem(m, a):
        x = a[0]
        c["sites"] += 1
        c["k1" if K.layout_refusal(x) is None else "k2"] += 1
        if not m.act:
            c[S.spread_route(x.shape[-1], x.shape[3])] += t - 1

    def tok(m, a):
        c["sites"] += 1
        c["k6"] += 1

    hooks = [m.register_forward_pre_hook(mem if isinstance(m, PB.MemUpdate) else tok)
             for m in model.modules() if isinstance(m, (PB.MemUpdate, PBX.TokenLIF))]
    try:
        with torch.no_grad():
            model(torch.zeros(1, chip_smoke.IMGSZ, chip_smoke.IMGSZ, 3, device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return tuple(c[k] for k in ("sites", "k1", "k2", "k6", "gemm", "dw3"))


@pytest.mark.parametrize("cfg", sorted(chip_smoke.ZOO_SITES))
def test_zoo_site_table_comes_from_the_model(cfg):
    assert zoo_counts(cfg) == chip_smoke.ZOO_SITES[cfg]
