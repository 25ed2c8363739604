"""Data-parallel, model-parallel and multi-process training and the sharded
val pass of the port (``ecs_yolo_tpu_torch/parallel/``, the step's
``layout``, ``Dataset.batches(host_shard=)``, ``val.run`` under a group,
``train()`` under a group), on CPU gloo groups.

Each 1-vs-N case spawns real processes (``torch.multiprocessing.spawn``,
gloo, a ``file://`` store, no TCP port) and holds them against the port's
one-process run in the parent.  That one-process run is held to JAX's step
by ``test_torch_port_train.py`` and ``test_torch_port_tal.py``, and JAX's own
``tests/test_mesh.py`` / ``test_multihost.py`` hold its 1-vs-N parity, so
the chain reaches JAX without a JAX compile here.  Each spawned group is
world 2, 64 px, T = 2, tiny models (two spawned groups):

* the step: data-parallel, float64, two micro-steps with ``accumulate=2``,
  for the v1 loss and a TAL head: parameters, EMA, BN statistics and loss
  items within 1e-10 relative of the one-process steps (the float32 loss
  within its rounding); data 1 x model 2 bit
  for bit; both ranks' gathered states bit-equal to each other;
* a ``train()`` run and its resume: rank 0 alone writes checkpoints and
  logs into one run directory, both ranks end with the same parameters,
  and rank 0's fitness, broadcast, stops both early where rank 1's own
  would not; then
  ``val.run`` of its EMA model under the group: ``seen``, the metrics and
  the COCO json equal to the one-process pass.

Without spawning: ``host_shard`` rows are the concatenation of the world's
shards (``Dataset``, the quad collate, ``SegmentDataset``); ``shard_rule``
picks the leaves JAX's ``shard_params`` rule picks on the JAX variables'
shapes; the driver refuses a world with JAX's messages.

The spawned processes import this module: it imports JAX only inside the
one test that needs it.
"""

import copy
import datetime
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from ecs_yolo_tpu_torch import val as PV
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.data import dataset as PD
from ecs_yolo_tpu_torch.data.hyps import HYP_SCRATCH
from ecs_yolo_tpu_torch.models import yolo as PY
from ecs_yolo_tpu_torch.parallel import mesh, multihost
from ecs_yolo_tpu_torch.train import driver as PDR
from ecs_yolo_tpu_torch.train import optim as PO
from ecs_yolo_tpu_torch.train import trainer as PT

REPO = Path(__file__).resolve().parents[1]
T, IMG, WORLD, NC = 2, 64, 2, 2
SNN = SNNConfig(time_window=T)
_BODY = {"backbone": [[-1, 1, "Conv_1", [8, 3, 4]], [-1, 1, "BasicBlock_2", [16, 3, 4]]]}
TINY_V1 = {"nc": NC, "depth_multiple": 1.0, "width_multiple": 1.0,
           "anchors": [[10, 14, 23, 27, 37, 58], [81, 82, 135, 169, 344, 319]], **_BODY,
           "head": [[-1, 1, "BasicBlock_2", [16, 3, 2]],
                    [[1, 2], 1, "Detect", ["nc", "anchors"]]]}
TINY_TAL = {"nc": NC, "depth_multiple": 1.0, "width_multiple": 1.0, "anchors": 2, **_BODY,
            "head": [[-1, 1, "BasicBlock_2", [16, 3, 2]], [[1, 2], 1, "DDetect", ["nc"]]]}
HEADS = {"v1": TINY_V1, "tal": TINY_TAL}
OPT = dict(lr0=0.01, lrf=0.1, momentum=0.9, weight_decay=5e-4, epochs=2,
           steps_per_epoch=4, warmup_epochs=1.0, warmup_floor=2.0, accumulate=2)


# --- spawning ------------------------------------------------------------------------


def _child(rank, job, root):
    torch.set_num_threads(1)
    multihost.initialize(init_method=f"file://{root}/store", world_size=WORLD, rank=rank,
                         device="cpu", timeout=datetime.timedelta(seconds=60))
    try:
        job(rank, Path(root))
    finally:
        dist.destroy_process_group()


def _spawn(job, root: Path) -> None:
    tmp.spawn(_child, args=(job, str(root)), nprocs=WORLD, join=True)


# --- (a) the step ----------------------------------------------------------------------


def _targets(b, m, seed):
    rng = np.random.RandomState(seed)
    t = np.zeros((b, m, 5))
    mask = np.zeros((b, m), bool)
    for i in range(b):
        k = 3 if i % 2 == 0 else 2
        t[i, :k, 0] = rng.randint(0, NC, k)
        t[i, :k, 1:3] = rng.rand(k, 2) * 0.8 + 0.1
        t[i, :k, 3:5] = rng.rand(k, 2) * 0.4 + 0.05
        mask[i, :k] = True
    return t, mask


def _micro_batches():
    """Two global micro-batches of 4 images (float64)."""
    out = []
    for seed in (21, 22):
        t, mask = _targets(4, 4, seed)
        ims = np.random.RandomState(seed + 50).rand(4, IMG, IMG, 3)
        out.append((torch.from_numpy(ims), torch.from_numpy(t), torch.from_numpy(mask)))
    return out


def _model(cfg):
    return PY.build_model(cfg, snn=SNN, device="cpu",
                          generator=torch.Generator().manual_seed(5)).double()


def _steps(model, batches, layout=None, rows=slice(None)):
    """Two micro-steps (one apply) of the SGD step; the whole state after
    them and each step's loss and items."""
    tx = PO.build_optimizer(dict(model.named_parameters()), **OPT)
    state = PT.create_train_state(model, tx, device="cpu")
    plan = mesh.shard_plan(model, layout.mp) if layout is not None else {}
    state = mesh.shard_state(state, plan, layout)
    step = PT.make_train_step(model, tx, HYP_SCRATCH, accumulate=2, device="cpu",
                              layout=layout, plan=plan)
    items = []
    for b in batches:
        state, m = step(state, *(a[rows] for a in b))
        items.append(torch.cat([m["loss"].reshape(1), m["items"]]))
    whole = mesh.gather_state(state, plan, layout)
    return {"params": {k: v.detach().clone() for k, v in whole.params.items()},
            "ema": dict(whole.ema_params), "stats": dict(model.named_buffers()),
            "mu": dict(whole.opt_state.mu), "items": torch.stack(items),
            "sharded": sorted(plan)}


def _job_steps(rank, root):
    batches = _micro_batches()
    for name, cfg in HEADS.items():
        for mp in (1, 2):
            model = _model(cfg)
            model.load_state_dict(torch.load(root / f"{name}_init.pt"))
            layout = mesh.make_layout(mp)
            rows = slice(2 * rank, 2 * rank + 2) if mp == 1 else slice(None)
            torch.save(_steps(model, batches, layout, rows), root / f"{name}_mp{mp}_r{rank}.pt")


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def test_two_rank_steps_match_one_process(tmp_path):
    """Data-parallel within 1e-10 relative of the one-process steps on the
    global batch; data 1 x model 2 bit for bit; the ranks' gathered states
    equal to each other."""
    torch.set_num_threads(1)
    batches = _micro_batches()
    ref = {}
    for name, cfg in HEADS.items():
        model = _model(cfg)
        torch.save(model.state_dict(), tmp_path / f"{name}_init.pt")
        ref[name] = _steps(model, batches)
    _spawn(_job_steps, tmp_path)
    for name in HEADS:
        want = ref[name]
        for mp in (1, 2):
            got = [torch.load(tmp_path / f"{name}_mp{mp}_r{r}.pt") for r in range(WORLD)]
            assert (len(got[0]["sharded"]) > 0) == (mp == 2)
            for key in ("params", "ema", "stats", "mu"):
                for k, v in want[key].items():
                    a, b = got[0][key][k], got[1][key][k]
                    assert torch.equal(a, b), (name, mp, key, k)
                    if mp == 2 or not v.is_floating_point():
                        assert torch.equal(a, v), (name, key, k)
                    else:
                        assert _rel(a, v) <= 1e-10, (name, key, k, _rel(a, v))
            if mp == 2:
                assert torch.equal(got[0]["items"], want["items"])
            else:       # the step's loss is float32 (train/trainer.py), its items not
                assert _rel(got[0]["items"][:, 1:], want["items"][:, 1:]) <= 1e-10
                assert _rel(got[0]["items"][:, 0], want["items"][:, 0]) <= 2.0 ** -23
            assert torch.equal(got[0]["items"], got[1]["items"])
    torch.set_num_threads(2)


def _write_split(root: Path, n=6, seed=0, nc=NC, empty=(2,)):
    from PIL import Image

    rng = np.random.RandomState(seed)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir(parents=True)
    for i in range(n):
        h, w = (48, 64) if i % 2 else (64, 40)
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            root / "images" / f"{i + 11}.png")
        rows = []
        for _ in range(0 if i in empty else rng.randint(1, 4)):
            bw, bh = rng.uniform(0.2, 0.6, 2)
            cx, cy = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(bh / 2, 1 - bh / 2)
            rows.append(f"{rng.randint(0, nc)} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}")
        (root / "labels" / f"{i + 11}.txt").write_text("\n".join(rows) + "\n")
    return root / "images"


# --- (c) train() under a group -----------------------------------------------------------


def _job_train(rank, root):
    saved, fits = [], []
    real_save, real_run = PDR.save_checkpoint, PDR.val_mod.run
    own = [0.5, 0.4, 0.3] if rank == 0 else [0.1, 0.2, 0.3]

    def save(path, **kw):
        saved.append(Path(path).name)
        return real_save(path, **kw)

    def run(*a, **k):           # the real sharded pass, then a fitness of the rank's own
        res = real_run(*a, **k)
        fits.append(own[len(fits)])
        return dict(res, fitness=fits[-1])

    PDR.save_checkpoint, PDR.val_mod.run = save, run
    kw = dict(epochs=3, batch_size=4, imgsz=IMG, nbs=4, patience=1, workers=0,
              steps_per_call=2, loggers_include=("csv",), snn=SNN, device="cpu", seed=2,
              save_dir=str(root / "runs" / "exp"))
    images = str(root / "split" / "images")
    try:
        state, best, hist = PDR.train(TINY_V1, images, images, **kw)
        first = {k: v.detach().clone() for k, v in state.params.items()}
        # resumed from rank 0's last.pt on both ranks: one more epoch, then
        # rank 0's fitness (0.3 < 0.5) stops both again
        state, best, again = PDR.train(TINY_V1, images, images,
                                       resume=root / "runs" / "exp" / "weights" / "last.pt",
                                       **kw)
    finally:
        PDR.save_checkpoint, PDR.val_mod.run = real_save, real_run
    # the sharded val pass on its own: 8 images in batches of 6 (3 a rank), the
    # last batch's 2 real rows both on rank 0
    model = PY.build_model(TINY_V1, snn=SNN, device="cpu")
    model.load_state_dict({**dict(model.named_buffers()), **state.ema_params})
    res = PV.run(model, str(root / "split" / "images"), imgsz=IMG, batch_size=6, workers=0,
                 save_json=str(root / "sharded.json"))
    res.pop("speed")
    torch.save({"first": first, "params": {k: v.detach() for k, v in state.params.items()},
                "ema": dict(state.ema_params), "val": res, "saved": saved,
                "epochs": [len(hist), len(again)],
                "fit": [h["fitness"] for h in hist + again]}, root / f"train_r{rank}.pt")


def test_train_and_val_under_a_group(tmp_path):
    """Two ranks, 8 images, global batch 4 (2 a rank), two steps a call,
    autoanchor on rank 0, patience 1: rank 0's falling fitness stops both
    after the second epoch although rank 1's own rises; rank 0 alone writes
    its checkpoints, into one run directory; both ranks resume from rank 0's
    ``last.pt`` for one more epoch; both end each run with the same
    parameters.  Then ``val.run`` of the EMA model
    under the group: every rank returns the one-process result (``seen``,
    the metrics, per class), and rank 0 writes the same COCO json."""
    _write_split(tmp_path / "split", n=8, empty=(2,))
    _spawn(_job_train, tmp_path)
    got = [torch.load(tmp_path / f"train_r{r}.pt", weights_only=False) for r in range(WORLD)]
    model = PY.build_model(TINY_V1, snn=SNN, device="cpu")
    model.load_state_dict({**dict(model.named_buffers()), **got[0]["ema"]})
    want = PV.run(model, str(tmp_path / "split" / "images"), imgsz=IMG, batch_size=6,
                  workers=0, save_json=str(tmp_path / "one.json"))
    want.pop("speed")
    assert want["seen"] == 8 and want["map50"] > 0, want
    assert got[0]["val"] == got[1]["val"] == want
    assert json.loads((tmp_path / "sharded.json").read_text()) == \
        json.loads((tmp_path / "one.json").read_text())
    assert got[0]["epochs"] == got[1]["epochs"] == [2, 1]
    assert got[0]["fit"] == [0.5, 0.4, 0.3] and got[1]["fit"] == [0.1, 0.2, 0.3]
    assert got[1]["saved"] == [] and \
        got[0]["saved"] == ["best.pt", "last.pt", "last.pt", "last.pt"]
    assert sorted(p.name for p in (tmp_path / "runs").iterdir()) == ["exp", "exp2"]
    assert sorted(p.name for p in (tmp_path / "runs" / "exp" / "weights").iterdir()) == \
        ["best.pt", "best_stripped.pt", "last.pt"]
    for key in ("first", "params"):
        for k, v in got[0][key].items():
            assert torch.equal(v, got[1][key][k]), (key, k)
    assert any(not torch.equal(v, got[0]["first"][k]) for k, v in got[0]["params"].items())


# --- without spawning --------------------------------------------------------------------


def _seg_split(root: Path, n=8, polygons=True):
    """Noise images with one triangle each: a YOLO-seg polygon, or its box."""
    from PIL import Image

    rng = np.random.RandomState(4)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir(parents=True)
    for i in range(n):
        Image.fromarray((rng.rand(32, 40, 3) * 255).astype(np.uint8)).save(
            root / "images" / f"{i}.png")
        x0, y0 = rng.uniform(0.1, 0.4, 2)
        row = (f"{x0:.4f} {y0:.4f} {x0 + 0.4:.4f} {y0:.4f} {x0 + 0.2:.4f} {y0 + 0.4:.4f}"
               if polygons else f"{x0 + 0.2:.4f} {y0 + 0.2:.4f} 0.4 0.4")
        (root / "labels" / f"{i}.txt").write_text(f"{i % NC} {row}\n")
    return root / "images"


@pytest.mark.parametrize("kind", ["dataset", "quad", "segment"])
def test_host_shards_concatenate_to_the_global_batches(kind, tmp_path):
    """Each global batch is rank 0's rows then rank 1's (the quad collate:
    each rank's canvases); a partial batch is dropped; a world that does not
    divide the batch raises JAX's message."""
    images = _seg_split(tmp_path / "s", n=10, polygons=kind == "segment")
    cls = PD.SegmentDataset if kind == "segment" else PD.Dataset
    ds = cls(str(images), img_size=32, augment=False, max_labels=4)
    bs, kw = (8, {"quad": True}) if kind == "quad" else (4, {})
    whole = list(ds.batches(bs, shuffle=True, seed=3, **kw))
    shards = [list(ds.batches(bs, shuffle=True, seed=3, host_shard=(r, 2), **kw))
              for r in range(2)]
    assert len(whole) == len(shards[0]) == len(shards[1]) == (1 if kind == "quad" else 2)
    for j, batch in enumerate(whole):
        for col, arr in enumerate(batch):
            assert np.array_equal(np.concatenate([s[j][col] for s in shards]), arr)
    with pytest.raises(ValueError, match="global batch 5 not divisible by 2 hosts"):
        next(ds.batches(5, host_shard=(0, 2)))


def _jax_rule(shape, mp, min_last):
    """``ecs_yolo_tpu/parallel/mesh.shard_params``'s predicate."""
    return len(shape) >= 2 and shape[-1] % mp == 0 and shape[-1] >= max(mp, min_last)


def test_shard_rule_picks_the_leaves_jax_shards():
    """On a tiny model with an ``AIFI`` encoder (convolutions, depthwise
    spreads, the attention's ``[C, heads, head_dim]`` kernels, ``Dense``
    layers, ``Detect``'s ``[1,1,T,1]`` kernels): JAX's rule on the JAX variables'
    shapes (one ``jax.eval_shape``), through the converter's name map, names
    the port's plan, at two model extents and two ``min_last``."""
    import jax
    import jax.numpy as jnp

    from ecs_yolo_tpu.config import SNNConfig as JaxSNNConfig
    from ecs_yolo_tpu.models import yolo as jax_yolo
    from ecs_yolo_tpu_torch.models import convert as CV

    d = dict(TINY_V1, head=[[-1, 1, "AIFI", [16, 2]], [-1, 1, "BasicBlock_2", [16, 3, 2]],
                            [[1, 3], 1, "Detect", ["nc", "anchors"]]])
    jm = jax_yolo.build_model(d, nc=NC, snn=JaxSNNConfig(time_window=T))
    shapes = jax.eval_shape(lambda: jm.module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), training=False))["params"]
    pm = PY.build_model(d, nc=NC, snn=SNN, device="meta", imgsz=IMG)
    assert any(m.endswith("ma.query.weight") for m, _ in pm.named_parameters())
    for mp, min_last in ((2, 0), (4, 0), (2, 64), (8, 16)):
        want = CV.convert_labels(jax.tree_util.tree_map(
            lambda s: _jax_rule(s.shape, mp, min_last), shapes), pm.spec)
        plan = mesh.shard_plan(pm, mp, min_last)
        assert set(plan) == {k for k, v in want.items() if v}, (mp, min_last)
        assert len(plan) < len(want) and (plan or min_last)
        for k, dim in plan.items():
            assert dict(pm.named_parameters())[k].shape[dim] % mp == 0


def _jax_messages():
    """The two layout refusals of ``ecs_yolo_tpu/train/driver.py``, as
    f-string sources."""
    src = (REPO / "ecs_yolo_tpu" / "train" / "driver.py").read_text()
    found = []
    for m in re.finditer(r"raise ValueError\(\s*((?:f\"[^\"]*\"\s*)+)\)", src):
        if "model_parallel" in m[1] or "multi-host" in m[1]:
            found.append('"' + "".join(re.findall(r'f"([^"]*)"', m[1])) + '"')
    assert len(found) == 2
    return found


@pytest.mark.parametrize("mp,batch,quad,world", [(4, 8, False, 2), (1, 6, False, 4),
                                                  (2, 8, True, 8), (3, 12, False, 4)])
def test_driver_refuses_a_world_with_jax_messages(mp, batch, quad, world, monkeypatch):
    """The world is smaller than the model axis, or does not divide the
    step batch (the quad collate's is a quarter of the batch) or the model
    axis: the JAX driver's text with the same values."""
    monkeypatch.setattr(multihost, "rank_world", lambda: (0, world))
    need, divide = _jax_messages()
    vals = dict(mp=mp, step_batch=batch // 4 if quad else batch, batch_size=batch,
                devs=[None] * world)
    want = eval("f" + (need if world < mp else divide), {}, vals)   # noqa: S307
    with pytest.raises(ValueError) as e:
        PDR._layout(mp, batch, quad)
    assert str(e.value) == want


def test_one_process_answers_without_a_group():
    assert multihost.rank_world() == (0, 1) and multihost.is_main()
    assert multihost.broadcast_scalar(0.25) == 0.25
    assert multihost.broadcast_object({"a": 1}) == {"a": 1}
    assert multihost.local_batch_slice(8, 1, 4) == slice(2, 4)
    with pytest.raises(ValueError, match="global batch 6 not divisible by 4 hosts"):
        multihost.local_batch_slice(6, 0, 4)
    assert mesh.make_layout(1) is None and PDR._layout(1, 8, False) is None
    with pytest.raises(ValueError, match="model_parallel=2 needs"):
        mesh.make_layout(2)
    x = torch.arange(6.0)
    assert mesh.data_size() == 1 and mesh.data_sum(x) is x
    assert mesh.global_mean(x) == x.mean() and mesh.global_batch(3) == 3


def test_initialize_reads_torchrun_env_and_binds_a_cpu_group(tmp_path, monkeypatch):
    """``initialize`` takes torchrun's ``RANK`` / ``WORLD_SIZE`` when no
    argument names them (a ``file://`` store here), makes a gloo group on
    the CPU, and a second call joins nothing; the group is destroyed again,
    so the tests after this one run without it."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    dev = multihost.initialize(init_method=f"file://{tmp_path}/store", device="cpu")
    try:
        assert dev == torch.device("cpu") and dist.get_backend() == "gloo"
        assert multihost.rank_world() == (0, 1) and multihost.is_main()
        assert multihost.initialize(device="cpu") == dev
        layout = mesh.make_layout(1)
        assert (layout.world, layout.data_size, layout.host_shard) == (1, 1, (0, 1))
        assert multihost.broadcast_scalar(0.5) == 0.5
        assert multihost.broadcast_object([1, "a"]) == [1, "a"]
    finally:
        dist.destroy_process_group()
    assert not multihost.initialized()
