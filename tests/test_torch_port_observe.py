"""The port's observability against the JAX package (CPU): firing rates
(``observe.py``), test-time augmentation and ``autobatch``
(``models/utils.py``), profiling (``utils/profiling.py``), plots
(``utils/plots.py``) and spike maps / noise sweeps (``utils/visualize.py``).

One narrowed res10 (width 0.25, T=2, 64 px) with random weights, lively BN
statistics included, carried across by ``models/convert.py``.  The JAX side
is one ``jax.jit`` of a function that returns both the ``spike_stats`` of a
forward and JAX's ``forward_augment``; JAX's ``calculate_fr`` then runs its
own code on that forward (a stand-in ``module.apply`` hands it the jitted
result), so its averaging, keys and ``.npy`` files are JAX's.  It is one
test, so that the compile runs once whichever worker takes it; the other
tests use the port's model alone.

Tolerances (float32): firing rates atol 1e-6 (the means of equal spikes;
the two frameworks' convolutions sum in different orders, and at this seed
no spike flips); the TTA predictions atol/rtol 1e-4 as the whole models of
``tests/test_torch_port_model.py`` (the resize agrees to a few ulps).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecs_yolo_tpu import observe as jax_observe
from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
from ecs_yolo_tpu.models import utils as jax_mu
from ecs_yolo_tpu.models import yolo as jax_yolo
from ecs_yolo_tpu_torch import observe
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.data.dataset import Dataset
from ecs_yolo_tpu_torch.models import convert as CV
from ecs_yolo_tpu_torch.models import utils as port_mu
from ecs_yolo_tpu_torch.models import yolo as port_yolo
from ecs_yolo_tpu_torch.utils import plots, profiling, visualize
from tests.test_torch_port_export import _lively
from tests.test_torch_port_model import _random_variables
from tests.test_torch_port_val import write_split

torch.set_num_threads(2)

T = 2


def _narrow_res10():
    d = port_yolo.load_cfg("resnet10.yaml")
    d["width_multiple"] = 0.25
    return d


def _pair():
    """(JAX model, its variables, the port model with the same weights)."""
    d = _narrow_res10()
    jm = jax_yolo.build_model(d, nc=2, snn=JaxSNNConfig(time_window=T))
    v = _random_variables(None, 9, jax.eval_shape(
        lambda: jm.module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                               training=False)))
    pm = port_yolo.build_model(d, nc=2, snn=SNNConfig(time_window=T), device="cpu", imgsz=64)
    pm.load_state_dict(CV.convert(v["params"], v["batch_stats"], pm.spec), strict=True)
    return jm, v, pm


@pytest.fixture(scope="module")
def port_model():
    """A port model alone: the init's weights with lively BN statistics
    from a seed."""
    return _lively(port_yolo.build_model(_narrow_res10(), nc=2, snn=SNNConfig(time_window=T),
                                         device="cpu", imgsz=64), seed=9)


def test_firing_rates_and_tta_match_jax(tmp_path):
    """JAX's ``calculate_fr`` (keys, averages, ``.npy`` files) and
    ``forward_augment`` on one batch, from one ``jax.jit``."""
    jm, v, pm = _pair()
    x = np.random.RandomState(4).rand(2, 64, 64, 3).astype(np.float32)

    @jax.jit
    def both(v, x):
        _, aux = jm.module.apply(v, x, training=False, mutable=["spike_stats"])
        return aux, jax_mu.forward_augment(jm, v, x)

    aux, tta = both(v, jnp.asarray(x))
    stand_in = types.SimpleNamespace(module=types.SimpleNamespace(
        apply=lambda *a, **k: (None, aux)))
    want = jax_observe.calculate_fr(stand_in, v, [(x,)], save_prefix=str(tmp_path / "jax"))
    got = observe.calculate_fr(pm, [(x,)], save_prefix=str(tmp_path / "port"))
    # JAX's jitted collection comes back in key order, the port's in call order
    assert sorted(got) == sorted(want) and len(got) == 24
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert 0.05 < np.mean(list(got.values())) < 0.95        # the sites fire
    for suffix in ("_firerate.npy", "_layers.npy"):
        a = np.load(tmp_path / f"port{suffix}")
        b = np.load(tmp_path / f"jax{suffix}")
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, atol=1e-6)
        else:
            assert a.tolist() == b.tolist()
    # uint8 batches are scaled as JAX's Dataset scales them
    u8 = (x * 255).round().astype(np.uint8)
    _, r8 = observe.forward_with_firing_rates(pm, torch.from_numpy(u8).float() / 255.0)
    assert observe.calculate_fr(pm, [(u8,)]) == r8
    # test-time augmentation
    tta = np.asarray(tta)
    aug = port_mu.forward_augment(pm, torch.from_numpy(x)).numpy()
    assert aug.shape == tta.shape and aug.shape[-1] == 2 + 5
    np.testing.assert_allclose(aug, tta, atol=1e-4, rtol=1e-4)
    # the spike maps' keys are the sites' JAX paths, as JAX's captured ones
    maps = visualize.spike_heatmap(pm, x[0])
    assert sorted(maps) == sorted(k.replace("/firing_rate/0", "/__call__") for k in want)


def test_jax_site_path_of_nested_and_repeated_rows():
    spec = ((-1, 1, "BasicBlock_2", ()), (-1, 2, "Concat_res2C3", ()), (-1, 1, "Conv_2", ()))
    assert observe.jax_site_path("model.0.residual_function.3", spec) == "layers_0/act2"
    assert observe.jax_site_path("model.1.1.m0.shortcut.0", spec) == "layers_1/1/m0/sc_act"
    assert observe.jax_site_path("model.2.act", spec) == "layers_2/act"
    with pytest.raises(ValueError):
        observe.jax_site_path("head.act", spec)


@pytest.mark.parametrize("ratio", [0.83, 0.67])
def test_tta_resize_is_jax_antialiased_bilinear(ratio):
    x = np.random.RandomState(1).rand(2, 64, 48, 3).astype(np.float32)
    got = port_mu._scale_img(torch.from_numpy(x), ratio).numpy()
    want = np.asarray(jax_mu._scale_img(jnp.asarray(x), ratio))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_autobatch_picks_the_largest_power_of_two_that_fits():
    model = port_yolo.build_model(_narrow_res10(), nc=2, snn=SNNConfig(time_window=T),
                                  device="meta")
    gib = 2 ** 30
    for per_image, want in ((gib, 4), (gib // 8, 32), (100 * gib, 1), (1, 64)):
        seen = []

        def footprint(b):
            seen.append(b)
            return 2 * gib + b * per_image      # weights and workspace, then per image
        got = port_mu.autobatch(model, imgsz=64, fraction=0.8, device_bytes=8 * gib,
                                footprint=footprint)
        assert got == want, per_image
        assert seen == list(port_mu.BATCHES[:len(seen)])     # up to the first too large
        assert len(seen) == len(port_mu.BATCHES) or footprint(seen[-1]) > 0.8 * 8 * gib
    # off the card no footprint is known: batch 1, as JAX's without a memory analysis
    cpu = port_yolo.build_model(_narrow_res10(), nc=2, snn=SNNConfig(time_window=T),
                                device="cpu", imgsz=64)
    assert port_mu.autobatch(cpu, imgsz=64, device_bytes=8 * gib) == 1


def test_profiling_rows_trace_and_timers(port_model, tmp_path):
    pm = port_model
    t0 = profiling.time_sync()
    assert profiling.time_sync() >= t0
    assert profiling.benchmark_fn(lambda a: a * 2, torch.ones(128), iters=3, warmup=1) >= 0
    rows = profiling.profile_layers(pm, imgsz=64, iters=1)
    assert [r["index"] for r in rows] == list(range(len(pm.spec)))
    assert [r["name"] for r in rows] == [row[2] for row in pm.spec]
    assert "Conv_1" in rows[0]["name"] and rows[-1]["name"] == "Detect"
    assert all(r["ms"] >= 0 for r in rows) and rows[1]["out_shape"][0] == T
    with profiling.trace(tmp_path / "tr") as path, torch.no_grad():
        pm(torch.zeros(1, 64, 64, 3))
    assert path.is_file() and "ecs_yolo_torch::ecs_lif" in path.read_text()


def test_plots_and_spike_maps_are_written(port_model, tmp_path):
    pm = port_model
    x = np.random.RandomState(4).rand(1, 64, 64, 3).astype(np.float32)
    csv = tmp_path / "results.csv"
    csv.write_text("epoch,loss,mAP\n0,1.0,0.1\n1,0.8,0.2\n")
    assert plots.plot_results(csv).exists()
    ev = tmp_path / "evolve.csv"
    ev.write_text("fitness,lr0,momentum\n0.1,0.01,0.9\n0.2,0.02,0.95\n")
    assert plots.plot_evolve(ev).exists()
    labels = np.array([[0, 0.5, 0.5, 0.2, 0.2], [1, 0.3, 0.3, 0.1, 0.1]])
    assert plots.plot_labels(labels, save_dir=tmp_path).exists()
    px = np.linspace(0, 1, 11)
    plots.plot_pr_curve(px, np.stack([px, px ** 2]), np.array([0.5, 0.3]),
                        save_path=tmp_path / "pr.png", names=("a", "b"))
    assert (tmp_path / "pr.png").exists()
    out = visualize.plot_noise_robustness({"LIF": {0.0: 0.5, 0.1: 0.4},
                                           "ECS-LIF": {0.0: 0.5, 0.1: 0.45}},
                                          save_path=str(tmp_path / "nr.png"))
    assert (tmp_path / "nr.png").exists() and out == str(tmp_path / "nr.png")
    maps = visualize.spike_heatmap(pm, x[0], save_path=str(tmp_path / "hm.png"))
    assert (tmp_path / "hm.png").exists()
    assert len(maps) == 24 and all(m.ndim == 2 for m in maps.values())
    only = visualize.spike_heatmap(pm, x[0], layer_filter="layers_1/")
    assert only and all(k.startswith("layers_1/") for k in only)


def test_noise_sweep_at_zero_noise_is_the_plain_val_pass(port_model, tmp_path):
    from ecs_yolo_tpu_torch import val as port_val

    pm = port_model
    src = write_split(tmp_path / "s", sizes=[(64, 64), (48, 80), (70, 50)], nc=2)
    ds = Dataset(str(src), img_size=64, augment=False, max_labels=8, uint8_out=True)
    curve = visualize.noise_sweep(pm, ds, noise_levels=(0.0, 0.3), imgsz=64, batch_size=2)
    assert list(curve) == [0.0, 0.3]
    plain = port_val.run(pm, str(src), imgsz=64, batch_size=2, max_labels=8, workers=0)
    assert curve[0.0] == plain["map50"]
