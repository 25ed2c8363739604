"""The port's batch augmentation on the card (``ecs_yolo_tpu_torch/data/
device_augment.py``) against the JAX package's (CPU).

The two frameworks' generators never give the same bits, so each case draws
with ``jax.random`` in this file exactly as the JAX function splits its key,
runs the JAX function on that key, and hands the same draws to the port's
applying function.  Images are float32 in both; tolerances: exact for the
label masks, 1e-6 for labels and pixel maps that are pure elementwise
arithmetic, 1e-5 where a product or a matrix inverse sums in another order
(the warp, the mosaic's shrink, the resample's tent products).  Batches are
4 images of 32x48 (not square, so a swapped height and width shows).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecs_yolo_tpu.data import device_augment as JA
from ecs_yolo_tpu_torch.data import device_augment as PA

B, H, W, M = 4, 32, 48, 6
HYP_FAST = dict(mosaic=1.0, translate=0.1, scale=0.5, fliplr=0.5, hsv_h=0.015,
                hsv_s=0.7, hsv_v=0.4)
HYP_GENERIC = dict(HYP_FAST, degrees=10.0, shear=2.0)


def _batch(seed=0, b=B, h=H, w=W):
    rng = np.random.RandomState(seed)
    ims = rng.rand(b, h, w, 3).astype(np.float32)
    ims[0, :4] = 0.5                                      # flat: d == 0 in HSV
    ims[1, :, :3] = ims[1, :, :3, :1]                     # grey columns
    labels = np.zeros((b, M, 5), np.float32)
    masks = np.zeros((b, M), bool)
    for i in range(b):
        n = 2 + i % 3
        wh = rng.rand(n, 2) * 0.4 + 0.1
        labels[i, :n] = np.c_[rng.randint(0, 3, n), rng.rand(n, 2) * (1 - wh) + wh / 2, wh]
        masks[i, :n] = True
    labels[3, 2] = [1, 0.02, 0.5, 0.01, 0.3]              # dropped: too thin
    masks[3, 2] = True
    return ims, labels, masks


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0,
                               err_msg=what)


def _same_labels(got, want, atol=1e-6):
    (gi, gl, gm), (wi, wl, wm) = got, want
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    _close(gl, wl, atol, "labels")
    return gi, wi


# --- JAX's draws, split as the JAX functions split their key ---------------------
# (jitted, as the JAX functions below: one compile each instead of one a
# primitive)


@jax.jit
def _j_hsv(key, gains):
    return jax.random.uniform(key, (B, 3), minval=-1.0, maxval=1.0) * gains + 1.0


def _gains(hyp):
    return jnp.asarray([hyp["hsv_h"], hyp["hsv_s"], hyp["hsv_v"]])


@partial(jax.jit, static_argnames=("translate", "scale", "fliplr"))
def _j_stf(key, translate=0.1, scale=0.5, fliplr=0.5):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    t, sc = translate, scale
    return (jax.random.uniform(k1, (B,), minval=1 - sc, maxval=1 + sc),
            jax.random.uniform(k2, (B,), minval=(0.5 - t) * W, maxval=(0.5 + t) * W),
            jax.random.uniform(k3, (B,), minval=(0.5 - t) * H, maxval=(0.5 + t) * H),
            jax.random.bernoulli(k4, fliplr, (B,)))


@partial(jax.jit, static_argnames=("degrees", "translate", "scale", "shear"))
def _j_affine(key, degrees, translate, scale, shear):
    d, t, sc, sh = degrees, translate, scale, shear
    u = lambda k, lo, hi: jax.random.uniform(k, (), minval=lo, maxval=hi)

    def one(k):
        k1, k2, k3, k4, k5 = jax.random.split(k, 5)
        return jnp.stack([u(k1, -d, d), u(k2, 1 - sc, 1 + sc), u(k3, -sh, sh),
                          u(k4, -sh, sh), u(k5, 0.5 - t, 0.5 + t),
                          u(jax.random.fold_in(k5, 1), 0.5 - t, 0.5 + t)])

    return jax.vmap(one)(jax.random.split(key, B))


@jax.jit
def _j_flip(key):
    return jax.random.bernoulli(key, 0.5, (B,))


@jax.jit
def _j_partners(key):
    return jax.random.randint(key, (B, 3), 0, B)


@jax.jit
def _j_mosaic(key):
    k1, k2 = jax.random.split(key)
    return (jax.random.randint(k1, (B, 3), 0, B),
            jax.random.uniform(k2, (B, 2), minval=0.4, maxval=0.6))


def _geom(hyp):
    return {k: hyp.get(k, 0.0) for k in ("degrees", "translate", "scale", "shear")}


def _jax_draws(key, hyp):
    """``draw_augment``'s dict, drawn as JAX's ``augment_batch`` draws."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    if PA._fast_geometry(hyp):
        d = dict(zip(("s", "tx", "ty", "flip"), _j_stf(
            k2, hyp["translate"], hyp["scale"], hyp["fliplr"])))
        d.update(partners=_j_partners(k1), hsv=_j_hsv(k3, _gains(hyp)))
    else:
        partners, centers = _j_mosaic(k1)
        d = dict(partners=partners, centers=centers, affine=_j_affine(k2, **_geom(hyp)),
                 hsv=_j_hsv(k3, _gains(hyp)), flip=_j_flip(k4))
    return {k: _t(v) for k, v in d.items()}


# --- colour ------------------------------------------------------------------------


def test_hsv_conversions_and_jitter_match_jax():
    ims, _, _ = _batch(1)
    key = jax.random.PRNGKey(3)
    hsv = jax.jit(JA.rgb_to_hsv)(jnp.asarray(ims))
    _close(PA.rgb_to_hsv(_t(ims)), hsv, 1e-6, "rgb_to_hsv")
    _close(PA.hsv_to_rgb(_t(hsv)), jax.jit(JA.hsv_to_rgb)(hsv), 1e-6, "hsv_to_rgb")
    r = _t(_j_hsv(key, _gains(HYP_FAST)))
    _close(PA.apply_hsv(_t(ims), r), jax.jit(JA.random_hsv)(jnp.asarray(ims), key), 1e-6,
           "random_hsv")
    _close(PA.apply_hsv_fast(_t(ims), r),
           jax.jit(JA.random_hsv_fast)(jnp.asarray(ims), key), 1e-6, "random_hsv_fast")
    g = torch.Generator().manual_seed(0)
    out = PA.random_hsv_fast(_t(ims), g)
    assert out.shape == (B, H, W, 3) and 0 <= float(out.min()) and float(out.max()) <= 1


# --- geometry ----------------------------------------------------------------------


def test_random_affine_and_warp_match_jax():
    hyp = dict(degrees=10.0, translate=0.1, scale=0.3, shear=3.0)
    ims, labels, masks = _batch(2)
    key = jax.random.PRNGKey(5)
    want = JA.random_affine(jnp.asarray(ims), jnp.asarray(labels), jnp.asarray(masks),
                            key, **hyp)
    ms = PA.affine_matrices(_t(_j_affine(key, **hyp)), W, H)
    got = PA.apply_affine(_t(ims), _t(labels), _t(masks), ms)
    gi, wi = _same_labels(got, want, atol=1e-5)
    _close(gi, wi, 1e-5, "warped images")
    assert torch.equal(PA._warp_one(_t(ims[0]), torch.linalg.inv(ms[0])), gi[0])
    # the centring map alone is the identity
    eye = PA.affine_matrices(torch.tensor([[0.0, 1.0, 0.0, 0.0, 0.5, 0.5]] * B), W, H)
    gi, gl, gm = PA.apply_affine(_t(ims), _t(labels), _t(masks), eye)
    _close(gi, ims, 1e-5, "identity warp")
    kept = gm.numpy()
    assert (kept == masks).sum() == masks.size - 1 and not kept[3, 2]   # the thin box
    np.testing.assert_allclose(gl.numpy()[kept], labels[kept], atol=1e-5)


def test_fliplr_matches_jax():
    ims, labels, _ = _batch(3)
    key = jax.random.PRNGKey(7)
    wi, wl = jax.jit(JA.random_fliplr)(jnp.asarray(ims), jnp.asarray(labels), key)
    gi, gl = PA.apply_fliplr(_t(ims), _t(labels), _t(_j_flip(key)))
    assert torch.equal(gi, _t(wi)) and torch.equal(gl, _t(wl))


def test_mosaic4_matches_jax():
    """The generic mosaic: quadrants placed where JAX's clamped slice puts
    them, the antialiased 2x shrink, labels from the unclamped offsets."""
    ims, labels, masks = _batch(4)
    key = jax.random.PRNGKey(11)
    want = jax.jit(JA.mosaic4)(jnp.asarray(ims), jnp.asarray(labels), jnp.asarray(masks),
                               key)
    partners, centers = (_t(v) for v in _j_mosaic(key))
    got = PA.apply_mosaic4(_t(ims), _t(labels), _t(masks), partners, centers)
    gi, wi = _same_labels(got, want)
    assert gi.shape == (B, H, W, 3) and got[1].shape == (B, 4 * M, 5)
    _close(gi, wi, 1e-5, "mosaic4 images")


def test_mosaic4_grid_and_resample_match_jax():
    ims, labels, masks = _batch(5)
    key = jax.random.PRNGKey(13)
    want = jax.jit(JA.mosaic4_grid)(jnp.asarray(ims), jnp.asarray(labels),
                                    jnp.asarray(masks), key)
    got = PA.apply_mosaic4_grid(_t(ims), _t(labels), _t(masks),
                                _t(_j_partners(key)))
    gi, wi = _same_labels(got, want)
    assert torch.equal(gi, _t(wi))
    canvas, cl, cm = (np.asarray(v) for v in want)
    want = jax.jit(JA.scale_translate_flip, static_argnums=4)(
        *(jnp.asarray(v) for v in (canvas, cl, cm)), key, (H, W))
    s, tx, ty, flip = (_t(v) for v in _j_stf(key))
    got = PA._resample_core(_t(canvas), _t(cl), _t(cm), s, tx, ty, flip, (H, W))
    gi, wi = _same_labels(got, want)
    _close(gi, wi, 1e-5, "resample")


# --- the pipeline ------------------------------------------------------------------


@pytest.mark.parametrize("hyp", [HYP_FAST, dict(HYP_FAST, mosaic=0.0), HYP_GENERIC],
                         ids=["fast", "fast-no-mosaic", "generic"])
def test_augment_batch_matches_jax_on_both_routes(hyp):
    """Pixels within 1e-5; on the generic route a warp's 1-ulp difference
    can move a pixel across a hue sector (``hsv_to_rgb``'s choice), so
    there at most 1e-3 of them may differ more, each by less than 0.05."""
    ims, labels, masks = _batch(6)
    key = jax.random.PRNGKey(17)
    want = jax.jit(lambda *a: JA.augment_batch(*a, hyp))(
        jnp.asarray(ims), jnp.asarray(labels), jnp.asarray(masks), key)
    got = PA.apply_augment(_t(ims), _t(labels), _t(masks), _jax_draws(key, hyp), hyp)
    gi, wi = _same_labels(got, want, atol=1e-5)
    if PA._fast_geometry(hyp):
        _close(gi, wi, 1e-5, "augmented images")
    else:
        err = np.abs(gi.numpy() - np.asarray(wi))
        assert (err > 1e-5).mean() <= 1e-3 and err.max() < 0.05, (err > 1e-5).mean()
    assert got[1].shape[1] == (4 * M if hyp["mosaic"] else M)
    assert 0.0 <= float(gi.min()) and float(gi.max()) <= 1.0


def test_augment_batch_draws_from_its_generator():
    """The port's own draws: the same generator state gives the same batch,
    another seed another one; shapes, range and labels inside the image."""
    ims, labels, masks = (_t(v) for v in _batch(7))
    run = lambda seed: PA.augment_batch(ims, labels, masks,
                                        torch.Generator().manual_seed(seed), HYP_FAST)
    a, b, c = run(1), run(1), run(2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    kept = a[1][a[2]]
    assert a[0].shape == (B, H, W, 3) and bool((kept[:, 1:] >= 0).all())
    assert bool((kept[:, 1:] <= 1).all()) and int(a[2].sum()) > 0


@pytest.mark.parametrize("bad", ["flipud", "mixup", "copy_paste"])
def test_hyps_the_pipeline_lacks_are_refused(bad):
    ims, labels, masks = (_t(v) for v in _batch(8))
    with pytest.raises(ValueError, match=bad):
        PA.augment_batch(ims, labels, masks, torch.Generator(), dict(HYP_FAST, **{bad: 0.1}))
    PA.check_hyp(dict(HYP_FAST, flipud=0.0, mixup=0.0, copy_paste=0.0))
