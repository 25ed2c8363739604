"""The port's training options (``ecs_yolo_tpu_torch/train/{optim,sparsity,
trainer}.py``, ``nn/blocks.checkpointed``, ``models/yolo.build_model(remat=)``)
against the JAX package (CPU).

* Lion: the port's optimizer against JAX's ``build_optimizer(optimizer=
  "Lion", accumulate=k)`` (``optax.lion`` per group inside
  ``apply_if_finite`` and, for k > 1, ``MultiSteps``) in float64 at every
  micro-step, one micro-gradient not finite: to 1e-11 (the float32
  schedules are bit-equal, the rest reassociates).
* ``sr``: the step's L1 term and ``train/sparsity.py``'s functions against
  JAX's on a narrowed res10 tree, the port model's weights in the JAX
  layout (``models/convert.py``'s maps read backwards): exactly (the same
  float operations on the same values).
* ``remat`` / ``remat_neuron``: port against port (a JAX compile of the step
  would cost more than this file's budget), as ``tests/test_train_steps.py``
  holds JAX's against its plain step: loss, every gradient and every BN
  running statistic after one float64 step bit-equal to the plain step's,
  so the statistics moved exactly once; also a bf16 step, whose recompute
  must bind the step's bf16 casts again.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ecs_yolo_tpu.train import optim as JO
from ecs_yolo_tpu.train import sparsity as JS
from ecs_yolo_tpu.train import trainer as JT
from ecs_yolo_tpu_torch.config import SNNConfig
from ecs_yolo_tpu_torch.data.hyps import HYP_SCRATCH
from ecs_yolo_tpu_torch.models import convert as CV
from ecs_yolo_tpu_torch.models import yolo as port_yolo
from ecs_yolo_tpu_torch.nn import blocks as PB
from ecs_yolo_tpu_torch.train import optim as PO
from ecs_yolo_tpu_torch.train import sparsity as PS
from ecs_yolo_tpu_torch.train import trainer as PT
from test_torch_port_model import _narrow
from test_torch_port_train import _targets

torch.set_num_threads(2)

T = 2


def _t64(a):
    return torch.from_numpy(np.array(a, np.float64))


# --- Lion ------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2])
def test_lion_matches_optax_lion_f64(k):
    """Four windows of k micro-gradients, one micro-gradient not finite (in
    the third window): parameters equal at every micro-step of the first
    three windows, Lion's moment after them, the poisoned window skipped and
    counted on both sides.  Then the fourth: applied by the port, while
    ``MultiSteps`` (k > 1) keeps the NaN in its mean and skips it too, the
    deviation named in the port's ``train/optim.py``."""
    rng = np.random.RandomState(3 + k)
    shapes = {"conv/kernel": (3, 3, 2, 4), "conv/bias": (4,), "bn/scale": (4,)}
    names = {"conv/kernel": "m.0.weight", "conv/bias": "m.0.bias",
             "bn/scale": "m.1.bn.weight"}
    p0 = {key: rng.randn(*s) for key, s in shapes.items()}
    gs = [{key: rng.randn(*s) for key, s in shapes.items()} for _ in range(4 * k)]
    gs[2 * k]["conv/bias"][1] = np.nan
    gs[0]["bn/scale"][2] = 0.0          # sign(0) on a moment of 0
    kw = dict(name="Lion", lr0=0.02, lrf=0.1, momentum=0.9, weight_decay=0.05,
              epochs=3, steps_per_epoch=2 * k, warmup_epochs=1.0,
              warmup_floor=3.0 * k, accumulate=k)
    tree = lambda d: {"conv": {"kernel": d["conv/kernel"], "bias": d["conv/bias"]},
                      "bn": {"scale": d["bn/scale"]}}
    leaves = lambda t: {"conv/kernel": t["conv"]["kernel"], "conv/bias": t["conv"]["bias"],
                        "bn/scale": t["bn"]["scale"]}
    pp = {names[key]: _t64(v) for key, v in p0.items()}
    ptx = PO.build_optimizer(pp, **kw)
    assert ptx.labels == {"m.0.weight": "g1", "m.0.bias": "g2", "m.1.bn.weight": "g0"}
    pst = ptx.init(pp)
    assert pst.nu is None
    applied = []
    with jax.enable_x64():
        jp = jax.tree_util.tree_map(jnp.asarray, tree(p0))
        tx = JO.build_optimizer(jp, **kw)
        st = tx.init(jp)
        update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
            *tx.update(g, s, p)))
        for i, g in enumerate(gs):
            jp, st = update(jax.tree_util.tree_map(jnp.asarray, tree(g)), st, jp)
            a, boundary = ptx.update(pp, {names[key]: _t64(v) for key, v in g.items()}, pst)
            if boundary:
                applied.append(bool(a))
            if i >= 3 * k:
                continue
            for key, v in leaves(jp).items():
                np.testing.assert_allclose(pp[names[key]].numpy(), np.asarray(v),
                                           atol=1e-11, rtol=1e-11,
                                           err_msg=f"{key} micro-step {i}")
            if i == 3 * k - 1:
                inner = st.inner_opt_state if k > 1 else st
                lion = [s for s in jax.tree_util.tree_leaves(
                    inner.inner_state,
                    is_leaf=lambda x: isinstance(x, optax.ScaleByLionState))
                    if isinstance(s, optax.ScaleByLionState)]
                want_mu = {}
                for s in lion:
                    for path, v in jax.tree_util.tree_flatten_with_path(
                            s.mu, is_leaf=lambda x: isinstance(x, optax.MaskedNode))[0]:
                        if not isinstance(v, optax.MaskedNode):
                            want_mu["/".join(p.key for p in path)] = np.asarray(v)
                assert set(want_mu) == set(names) and int(pst.errors) == 1
                assert int(inner.total_notfinite) == 1
                for key, v in want_mu.items():
                    np.testing.assert_allclose(pst.mu[names[key]].numpy(), v, atol=1e-12,
                                               err_msg=f"moment {key}")
        errors = int((st.inner_opt_state if k > 1 else st).total_notfinite)
    assert applied == [True, True, False, True] and int(pst.count) == 3
    assert int(pst.errors) == 1 and errors == (1 if k == 1 else 2)
    assert all(float((pp[names[key]] - _t64(p0[key])).abs().max()) > 1e-3 for key in p0)
    assert all(torch.isfinite(t).all() for t in pp.values())


# --- sr and train/sparsity.py ----------------------------------------------------


def _jax_tree(sd, spec):
    """The JAX package's ``params`` and ``batch_stats`` of a port
    ``state_dict``: ``models/convert.py``'s maps read backwards (checked by
    converting the result forwards again)."""
    to_jax = {blk: {v: k for k, v in m.items()} for blk, m in CV._MODULES.items()}
    leaves = {v: k for k, v in CV._LEAVES.items()}
    params, stats = {}, {}
    for name, t in sd.items():
        _, i, *rest = name.split(".")
        _, n, blk, _ = spec[int(i)]
        scope = [f"layers_{i}"]
        if n > 1:
            scope.append(rest.pop(0))
        rest = ".".join(rest)
        a = t.numpy()
        if blk == "Detect":
            kind, j, *tail = rest.split(".")
            path = ([f"m{j}", "conv", "kernel" if tail == ["weight"] else "bias"]
                    if kind == "m" else [f"w{j}", "w"])
            if kind == "w":
                a = a.reshape(1, 1, a.shape[1], 1)
        else:
            child = next(c for c in sorted(to_jax[blk], key=len, reverse=True)
                         if rest.startswith(c + "."))
            path = [to_jax[blk][child]] + leaves[rest[len(child) + 1:]].split("/")
        if a.ndim == 4 and not (blk == "Detect" and path[-1] == "w"):
            a = np.transpose(a, (2, 3, 1, 0))             # OIHW -> HWIO
        node = stats if path[-1] in ("mean", "var") else params
        for key in scope + path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.array(a)
    return params, stats


@pytest.fixture(scope="module")
def res10_tree(port_model):
    """(JAX params + batch_stats of the narrowed res10, gradients in its
    shape, its spec), from the port model's weights; BN scales of every sign
    and some near zero, for the sign and the pruning."""
    sd = {k: v.float() for k, v in port_model.state_dict().items()}
    rng = np.random.RandomState(4)
    for k, v in sd.items():
        if PS.is_bn_scale(k):
            v.copy_(torch.from_numpy(rng.rand(len(v)) + 0.1))
            v[: len(v) // 3] *= -1
            v[len(v) // 3: len(v) // 2] = 1e-5
        elif PS.is_bn_bias(k):
            v.copy_(torch.from_numpy(rng.randn(len(v))))
    params, stats = _jax_tree(sd, port_model.spec)
    back = CV.convert(params, stats, port_model.spec)
    assert set(back) == set(sd) and all(torch.equal(back[k], v) for k, v in sd.items())
    grads = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32), params)
    return {"params": params, "batch_stats": stats}, grads, port_model.spec


def _conv(tree, spec):
    return CV.convert(tree, None, spec)


def test_sr_term_and_sparsity_functions_match_jax(res10_tree):
    v, grads, spec = res10_tree
    params = _conv(v["params"], spec)
    pg = _conv(grads, spec)
    sr, total = 0.01, 40
    for step in (0, 13, 60):
        srtmp_j = sr * (1.0 - 0.9 * jnp.clip(jnp.float32(step) / total, 0.0, 1.0))
        want = _conv(jax.tree_util.tree_map_with_path(
            JT._sparsity_grad(srtmp_j, sr), grads, v["params"]), spec)
        srtmp = PS.sparsity_rate(sr, torch.tensor(step).to(torch.float32) / total)
        assert float(srtmp) == float(srtmp_j)
        got = PS.add_l1_subgradient(pg, params, srtmp, sr)
        assert set(got) == set(want)
        for k, w in want.items():
            assert torch.equal(got[k], w), (step, k)
    want = _conv(JS.bn_l1_grads(grads, v["params"], sr, epoch=7, epochs=30), spec)
    got = PS.bn_l1_grads(pg, params, sr, epoch=7, epochs=30)
    assert all(torch.equal(got[k], w) for k, w in want.items())
    moved = [k for k in got if not torch.equal(got[k], pg[k])]
    assert moved and all(PS.is_bn_scale(k) or PS.is_bn_bias(k) for k in moved)

    jg = JS.collect_bn_gammas(v["params"])
    pgm = PS.collect_bn_gammas(params)
    assert len(jg) == len(pgm) and sorted(np.concatenate([g for _, g in jg]).tolist()) \
        == sorted(np.concatenate([g for _, g in pgm]).tolist())
    assert PS.bn_gamma_sparsity(params) == JS.bn_gamma_sparsity(v["params"]) > 0

    for ratio in (0.3, 0.5):
        jv, jrep = JS.prune_by_bn_gamma(v, ratio=ratio)
        sd = CV.convert(v["params"], v["batch_stats"], spec)
        pruned, prep = PS.prune_by_bn_gamma(sd, ratio=ratio)
        assert prep == jrep and prep["pruned_channels"] > 0
        want = CV.convert(jv["params"], v["batch_stats"], spec)
        assert set(pruned) == set(want)
        assert all(torch.equal(pruned[k], w) for k, w in want.items())


def test_step_with_sr_adds_the_term_before_the_optimizer(port_model):
    """``make_train_step(sr=)`` over two steps: the parameters are those of
    the plain gradients plus the term at each step's count (float32, as
    JAX's), applied by the same optimizer, exactly."""
    hyp = dict(HYP_SCRATCH)
    kw = dict(epochs=2, steps_per_epoch=4, warmup_epochs=1.0, warmup_floor=2.0)
    batch = _batch()
    pm, ref = copy.deepcopy(port_model), copy.deepcopy(port_model)
    tx = PO.build_optimizer(dict(pm.named_parameters()), **kw)
    state = PT.create_train_state(pm, tx, device="cpu")
    step = PT.make_train_step(pm, tx, hyp, sr=0.05, sr_total_steps=8, device="cpu")
    rtx = PO.build_optimizer(dict(ref.named_parameters()), **kw)
    rstate = PT.create_train_state(ref, rtx, device="cpu")
    grad_fn = PT.make_grad_fn(ref, hyp)
    for i in range(2):
        state, _ = step(state, *batch)
        g = grad_fn(rstate, *batch)[2]
        srtmp = PS.sparsity_rate(0.05, torch.tensor(i, dtype=torch.float32) / 8)
        g = PS.add_l1_subgradient(g, rstate.params, srtmp, 0.05)
        rtx.apply(rstate.params, g, rstate.opt_state)
    for k, v in state.params.items():
        assert torch.equal(v, rstate.params[k]), k


# --- remat / remat_neuron ----------------------------------------------------------


def _batch(dtype=np.float64):
    rng = np.random.RandomState(12)
    t, mask = _targets(2, 4, 2, seed=13, n_valid=3)
    return (torch.from_numpy(rng.rand(2, 64, 64, 3).astype(dtype)),
            torch.from_numpy(t.astype(dtype)), torch.from_numpy(mask))


def _model(remat=False, remat_neuron=False):
    return port_yolo.build_model(
        _narrow("resnet10.yaml"), nc=2, device="cpu", remat=remat,
        snn=SNNConfig(time_window=T, remat_neuron=remat_neuron),
        generator=torch.Generator().manual_seed(3))


@pytest.fixture(scope="module")
def port_model():
    return _model().double()


@pytest.fixture(scope="module")
def plain_step(port_model):
    """The plain float64 step's loss, gradients, BN statistics and firing
    rates, from the fixture's weights."""
    pm = copy.deepcopy(port_model)
    tx = PO.build_optimizer(dict(pm.named_parameters()))
    state = PT.create_train_state(pm, tx, device="cpu")
    total, items, grads = PT.make_grad_fn(pm, HYP_SCRATCH)(state, *_batch())
    stats = {k: v.clone() for k, v in state.batch_stats.items()}
    rates = [m.firing_rate for m in pm.modules() if isinstance(m, PB.MemUpdate)]
    return total, grads, stats, rates


@pytest.mark.parametrize("remat,remat_neuron", [(True, False), (False, True), (True, True)],
                         ids=["remat", "remat_neuron", "both"])
def test_remat_gives_the_plain_step_with_statistics_moved_once(remat, remat_neuron,
                                                               port_model, plain_step):
    total0, grads0, stats0, rates0 = plain_step
    pm = _model(remat, remat_neuron).double()
    pm.load_state_dict(port_model.state_dict())
    calls = []
    real = PB.checkpointed
    PB.checkpointed = lambda *a: calls.append(PB.recomputing()) or real(*a)
    try:
        tx = PO.build_optimizer(dict(pm.named_parameters()))
        state = PT.create_train_state(pm, tx, device="cpu")
        total, _, grads = PT.make_grad_fn(pm, HYP_SCRATCH)(state, *_batch())
    finally:
        PB.checkpointed = real
    n_layers = sum(name != "Detect" for _, _, name, _ in pm.spec)
    n_sites = sum(isinstance(m, PB.MemUpdate) for m in pm.modules())
    # in the forward: one a layer, one a site; in the layers' recompute the
    # sites' again (so the recompute ran, flagged)
    assert calls.count(False) == remat * n_layers + remat_neuron * n_sites
    assert calls.count(True) == remat * remat_neuron * n_sites
    assert torch.equal(total, total0)
    assert set(grads) == set(grads0) and all(torch.equal(grads[k], g)
                                             for k, g in grads0.items())
    init = port_model.state_dict()
    for k, v in stats0.items():
        assert torch.equal(state.batch_stats[k], v), k
        if v.is_floating_point():
            assert not torch.equal(v, init[k]), k            # it moved, and once
    rates = [m.firing_rate for m in pm.modules() if isinstance(m, PB.MemUpdate)]
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(rates, rates0))


def test_remat_bf16_step_equals_the_plain_bf16_step(port_model):
    """A bf16 step (parameters cast at the apply boundary inside
    ``functional_call``) with both recomputes: parameters, EMA and BN
    statistics bit-equal to the plain bf16 step's."""
    out = []
    for remat in (False, True):
        pm = _model(remat, remat).float()
        pm.load_state_dict({k: v.float() for k, v in port_model.state_dict().items()})
        tx = PO.build_optimizer(dict(pm.named_parameters()))
        state = PT.create_train_state(pm, tx, device="cpu")
        step = PT.make_train_step(pm, tx, HYP_SCRATCH, compute_dtype=torch.bfloat16,
                                  device="cpu")
        state, m = step(state, *_batch(np.float32))
        out.append((pm.state_dict(), state.ema_params, float(m["loss"])))
    (sd0, e0, l0), (sd1, e1, l1) = out
    assert l0 == l1 and all(torch.equal(sd1[k], v) for k, v in sd0.items())
    assert all(torch.equal(e1[k], v) for k, v in e0.items())
