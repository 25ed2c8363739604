"""ROADMAP Queue 1 item 11g-4 against the JAX package (CPU): the RT-DETR
training ops of ``train/rtdetr.py`` (``hungarian_match``, ``get_cdn_group``,
``rtdetr_loss``) and the NMS variants of ``ops/nms_variants.py``.

``hungarian_match`` and ``rtdetr_loss`` in float64 on both sides: the same
assignment (padded ground truths never matched), the loss items and the
gradients of the total with respect to the logits and the boxes at 1e-9; a
batch's costs reach the host in one copy.  ``get_cdn_group``: JAX's draws
from one key (split as the JAX function splits it) fed to the port's
draw-free ``cdn_group`` give JAX's groups at 1e-9.  The five NMS variants on
pools with tied scores: the same order, keep sets and soft-NMS picks and
scores; ``cluster_nms``'s keep set is the port's greedy NMS's.
"""

import jax
import numpy as np
import pytest
import torch

from ecs_yolo_tpu.ops import nms_variants as JN
from ecs_yolo_tpu.train import rtdetr as JR
from ecs_yolo_tpu_torch.ops import nms as PN
from ecs_yolo_tpu_torch.ops import nms_variants as PNV
from ecs_yolo_tpu_torch.train import rtdetr as PR
from test_torch_port_heads import _FAST

torch.set_num_threads(2)


def _set(seed, b=3, q=16, m=6, nc=5):
    """Logits, xywh boxes, labels, boxes and a mask of padded ground truths
    (image i keeps ``m - i`` of them; padded rows hold garbage)."""
    r = np.random.RandomState(seed)
    logits = r.randn(b, q, nc)
    boxes = r.rand(b, q, 4) * 0.5 + 0.25
    labels = r.randint(0, nc, (b, m)).astype(np.float64)
    gt = r.rand(b, m, 4) * 0.4 + 0.3
    mask = np.arange(m)[None] < (m - np.arange(b))[:, None]
    return logits, boxes, labels, gt, mask


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def test_hungarian_match_matches_jax_and_never_takes_a_padded_truth():
    logits, boxes, labels, gt, mask = _set(1)
    scores = 1 / (1 + np.exp(-logits))
    with jax.enable_x64():
        rows, matched = jax.jit(jax.vmap(JR.hungarian_match), compiler_options=_FAST)(
            scores, boxes, labels, gt, mask)
        want = list(zip(np.asarray(rows), np.asarray(matched)))
    got = PR.hungarian_match(*_t(scores, boxes, labels, gt, mask))
    for i, (rows, matched) in enumerate(want):
        np.testing.assert_array_equal(got[0][i].numpy(), rows)
        np.testing.assert_array_equal(got[1][i].numpy(), matched)
        assert mask[i][got[0][i][got[1][i]].numpy()].all()
        assert int(got[1][i].sum()) == int(mask[i].sum())
        one = PR.hungarian_match(*_t(scores[i], boxes[i], labels[i], gt[i], mask[i]))
        assert torch.equal(one[0], got[0][i]) and torch.equal(one[1], got[1][i])


def test_a_batch_costs_one_host_copy(monkeypatch):
    """The batch's stacked costs reach the host in one ``cpu()`` and the
    assignment comes back in one copy, whatever the batch size."""
    logits, boxes, labels, gt, mask = _set(2, b=4)
    calls = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: calls.append(
        tuple(self.shape)) or real(self, *a, **k))
    PR.hungarian_match(*_t(1 / (1 + np.exp(-logits)), boxes, labels, gt, mask))
    assert calls == [(4, 16, 6)]


@pytest.mark.parametrize("seed", [3, 4])
def test_rtdetr_loss_matches_jax_f64(seed):
    """Total, items and the gradients of the total with respect to the
    logits and the boxes at 1e-9; the assignment carries no gradient."""
    logits, boxes, labels, gt, mask = _set(seed)
    nc = logits.shape[-1]
    with jax.enable_x64():
        (total, items), (g_s, g_b) = jax.jit(jax.value_and_grad(
            lambda s, b, *rest: JR.rtdetr_loss(s, b, *rest, nc), argnums=(0, 1),
            has_aux=True), compiler_options=_FAST)(logits, boxes, labels, gt, mask)
        total, items, g_s, g_b = map(np.asarray, (total, items, g_s, g_b))
    s, b, lab, g, m = _t(logits, boxes, labels, gt, mask)
    s.requires_grad_(True)
    b.requires_grad_(True)
    got, got_items = PR.rtdetr_loss(s, b, lab, g, m, nc)
    got.backward()
    np.testing.assert_allclose(got.item(), float(total), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got_items.numpy(), items, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(s.grad.numpy(), g_s, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(b.grad.numpy(), g_b, rtol=1e-9, atol=1e-9)
    assert not got_items.requires_grad and np.abs(g_b).sum() > 0


def _jax_draws(key, b, m, nc):
    """The draws JAX's ``get_cdn_group`` makes from ``key``, under the
    port's names."""
    k_cls, k_flip, k_box_p, k_box_n, k_sign = jax.random.split(key, 5)
    return {"flip_u": jax.random.uniform(k_cls, (b, m)),
            "rand_cls": jax.random.randint(k_flip, (b, m), 0, nc),
            "signs": jax.random.randint(k_sign, (b, m, 4), 0, 2) * 2 - 1,
            "u_pos": jax.random.uniform(k_box_p, (b, m, 4)),
            "u_neg": jax.random.uniform(k_box_n, (b, m, 4))}


@pytest.mark.parametrize("ratio,scale", [(0.5, 1.0), (1.6, 0.4)])
def test_cdn_group_matches_jax_given_its_draws(ratio, scale):
    """JAX's groups from key 0 equal the port's ``cdn_group`` on JAX's
    draws; both halves take their signs from one draw (JAX's ``k_sign``),
    so each negative is moved the same way as its positive."""
    _, _, labels, gt, mask = _set(5, b=2, m=5)
    nc = 7
    with jax.enable_x64():
        key = jax.random.PRNGKey(0)
        want, draws = jax.jit(lambda *a: (
            JR.get_cdn_group(*a, nc, 100, key, cls_noise_ratio=ratio, box_noise_scale=scale),
            _jax_draws(key, 2, 5, nc)), compiler_options=_FAST)(labels, gt, mask)
        draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
        want = [np.asarray(a) for a in want]
    got = PR.cdn_group(*_t(labels, gt, mask), nc, draws, ratio, scale)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert (got[0][:, 5:] == nc).all() and (want[0][:, 5:] == nc).all()


def test_get_cdn_group_draws_from_the_generator():
    """Fresh draws from a ``torch.Generator``: the same generator state gives
    the same groups; 2M queries an image, the negatives background; the
    signs +-1."""
    _, _, labels, gt, mask = _set(6, b=2, m=4)
    a = PR.get_cdn_group(*_t(labels, gt, mask), 7, 300, torch.Generator().manual_seed(1))
    b = PR.get_cdn_group(*_t(labels, gt, mask), 7, 300, torch.Generator().manual_seed(1))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (2, 8) and a[1].shape == (2, 8, 4) and (a[0][:, 4:] == 7).all()
    draws = PR.cdn_draws(2, 4, 7, torch.Generator().manual_seed(1))
    assert set(draws["signs"].unique().tolist()) <= {-1, 1}


# --- the NMS variants ----------------------------------------------------------------


def _pool(seed, n=40):
    """xyxy boxes in clusters, and scores with ties (a quarter of them
    repeated) and a few non-positive ones."""
    r = np.random.RandomState(seed)
    centres = r.rand(6, 2) * 300
    xy = centres[r.randint(0, 6, n)] + r.randn(n, 2) * 12
    wh = r.rand(n, 2) * 50 + 20
    scores = np.round(r.rand(n), 2)
    scores[r.rand(n) < 0.25] = 0.5
    scores[:3] = [0.0, -0.1, 0.5]
    return np.concatenate([xy, xy + wh], -1), scores


VARIANTS = {
    "cluster_nms": dict(iou_thres=0.5),
    "cluster_diou_nms": dict(iou_thres=0.45),
    "cluster_spm_nms": dict(iou_thres=0.5, score_thres=0.3),
    "cluster_spm_dist_nms": dict(iou_thres=0.5, score_thres=0.3),
    "soft_nms": dict(sigma=0.5, score_thres=0.2, max_det=40),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_nms_variant_matches_jax_f64(name):
    """The sort order (stable on ties), the keep mask; soft-NMS's picks and
    decayed scores at 1e-9."""
    boxes, scores = _pool(len(name))
    with jax.enable_x64():
        want = [np.asarray(a) for a in jax.jit(
            lambda b, s: getattr(JN, name)(b, s, **VARIANTS[name]),
            compiler_options=_FAST)(boxes, scores)]
    got = getattr(PNV, name)(*_t(boxes, scores), **VARIANTS[name])
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    if name == "soft_nms":
        np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-9, atol=1e-9)
        assert (got[1] > 0).any() and (got[1] == 0).any()
    else:
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        assert 0 < int(got[1].sum()) < len(scores)


def test_cluster_nms_keeps_the_greedy_set():
    """``order[keep]`` of ``cluster_nms`` is the set greedy NMS keeps
    (``ops/nms.py``'s walk over the sorted pool) at the same threshold, on a
    pool with tied scores."""
    boxes, scores = _pool(9, n=64)
    b, s = _t(boxes, scores)
    order, keep = PNV.cluster_nms(b, s, 0.5)
    pos = order[s[order] > 0]
    supp = (PN._pair_iou(b[pos], b[pos]) > 0.5).numpy()
    want = set(pos[PN._greedy(supp, len(pos))].tolist())
    assert set(order[keep].tolist()) == want
