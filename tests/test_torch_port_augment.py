"""The train half of the port's data path (``ecs_yolo_tpu_torch/data/``,
``native/``, ``utils/autoanchor.py``) against the JAX package's (CPU), on
the same numpy images and the same ``random.Random`` seeds.

Tolerances: images are uint8 and must be equal bit for bit (the same numpy
code, the same C++ source built with the same flags); labels come out of
the same float64 numpy arithmetic and are held to 1e-9; anchors to 1e-6.
"""

import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ecs_yolo_tpu import native as jax_native
from ecs_yolo_tpu.data import augment as JA
from ecs_yolo_tpu.data import dataset as JD
from ecs_yolo_tpu.utils import autoanchor as JAA
from ecs_yolo_tpu_torch import native as port_native
from ecs_yolo_tpu_torch.data import augment as PA
from ecs_yolo_tpu_torch.data import dataset as PD
from ecs_yolo_tpu_torch.data.hyps import HYP_SCRATCH
from ecs_yolo_tpu_torch.utils import autoanchor as PAA
from test_torch_port_val import write_split

REPO = Path(__file__).resolve().parents[1]
# the affine and perspective settings of the warp, the mosaic's hyp
WARPS = [dict(degrees=10.0, translate=0.1, scale=0.5, shear=5.0, perspective=0.0),
         dict(degrees=0.0, translate=0.2, scale=0.3, shear=0.0, perspective=0.0005)]
HYP = dict(HYP_SCRATCH, degrees=5.0, shear=2.0, mixup=0.5, flipud=0.5)


def _image(seed, h=48, w=64):
    rng = np.random.RandomState(seed)
    im = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    im[10:30, 5:40] = rng.randint(0, 255, 3)          # a flat patch
    return im


def _labels(seed, n=6, h=48, w=64):
    """(cls, x1, y1, x2, y2) in pixels."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2) * [w - 12, h - 12]
    wh = rng.rand(n, 2) * 20 + 3
    return np.concatenate([rng.randint(0, 3, (n, 1)), xy, xy + wh], 1).astype(np.float32)


def test_augment_hsv_is_bit_equal_to_jax():
    im = _image(0)
    for seed in range(3):
        rp, rj = random.Random(seed), random.Random(seed)
        got = PA.augment_hsv(im, 0.015, 0.7, 0.4, rng=rp)
        want = JA.augment_hsv(im, 0.015, 0.7, 0.4, rng=rj)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
        assert rp.getstate() == rj.getstate()


@pytest.mark.parametrize("route", ["native", "pil"])
@pytest.mark.parametrize("warp", WARPS, ids=["affine", "perspective"])
def test_random_perspective_is_bit_equal_to_jax(warp, route, monkeypatch):
    """The native route against the JAX function with its native library,
    the PIL route against it with the library hidden (its PIL branch)."""
    if route == "pil":
        monkeypatch.setattr(jax_native, "is_available", lambda: False)
    else:
        assert jax_native.is_available()
    im, lb = _image(1), _labels(2)
    for seed in range(3):
        rp, rj = random.Random(seed), random.Random(seed)
        got_im, got_lb = PA.random_perspective(im, lb.copy(), **warp, border=(-8, -8),
                                               rng=rp, native=route == "native")
        want_im, want_lb = JA.random_perspective(im, lb.copy(), **warp,
                                                 border=(-8, -8), rng=rj)
        assert got_im.shape == want_im.shape == (32, 48, 3)
        assert np.array_equal(got_im, want_im)
        np.testing.assert_allclose(got_lb, want_lb, atol=1e-9, rtol=0)
        assert rp.getstate() == rj.getstate()


def test_box_candidates_mixup_and_flips_match_jax():
    rng = np.random.RandomState(3)
    b1 = np.sort(rng.rand(4, 30) * 40, axis=0)
    b2 = b1 * rng.uniform(0.2, 1.5, (4, 30))
    assert np.array_equal(PA.box_candidates(b1, b2), JA.box_candidates(b1, b2))
    im1, im2 = _image(4), _image(5)
    l1, l2 = _labels(6), _labels(7, n=2)
    got = PA.mixup(im1, l1, im2, l2, rng=random.Random(9))
    want = JA.mixup(im1, l1, im2, l2, rng=random.Random(9))
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    norm = np.concatenate([l1[:, :1], rng.rand(len(l1), 4)], 1).astype(np.float32)
    for pf, jf in ((PA.flip_lr, JA.flip_lr), (PA.flip_ud, JA.flip_ud)):
        (a, la), (b, lb) = pf(im1, norm), jf(im1, norm)
        assert np.array_equal(a, b) and np.array_equal(la, lb)
    # without albumentations installed the hook is the identity, as in JAX
    a = PA.Albumentations()
    assert (a.transform is None) == (JA.Albumentations().transform is None)


def test_native_build_is_the_ports_own_and_bit_equal_to_jax():
    lib = port_native.target()
    port_native.get_lib()
    assert lib.is_file() and lib.parent == REPO / "ecs_yolo_tpu_torch" / "_build"
    src = _image(10, 40, 56)
    rng = np.random.RandomState(11)
    for _ in range(3):
        m = np.eye(3) + rng.randn(3, 3) * [[0.1, 0.1, 3], [0.1, 0.1, 3], [1e-3, 1e-3, 0]]
        got = port_native.warp_perspective(src, m, (36, 60))
        assert np.array_equal(got, jax_native.warp_perspective(src, m, (36, 60)))
        gains = rng.uniform(0.5, 1.5, 3)
        assert np.array_equal(port_native.hsv_jitter(src.copy(), *gains),
                              jax_native.hsv_jitter(src.copy(), *gains))


def test_a_failed_native_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(port_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="building augment.cpp failed"):
        PA.random_perspective(_image(1), rng=random.Random(0), native=True)
    assert not list(tmp_path.glob("*.so"))


_BUILDER = """
import sys
from pathlib import Path
import numpy as np
from ecs_yolo_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
im = (np.arange(20 * 24 * 3) % 251).astype(np.uint8).reshape(20, 24, 3)
out = native.warp_perspective(im, np.eye(3) * [1.1, 0.9, 1.0], (18, 22))
print(native.target().name, int(out.astype(np.int64).sum()))
"""


def test_two_processes_building_at_once_both_load_a_whole_library(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0]
    assert len(list(tmp_path.glob("*.so"))) == 1 and not list(tmp_path.glob("*.tmp"))


# --- the dataset's train half ------------------------------------------------------


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return write_split(tmp_path_factory.mktemp("aug") / "s",
                       sizes=[(48, 80), (64, 64), (100, 37), (30, 45)])


def test_load_mosaic_matches_jax(split):
    pd_ = PD.Dataset(split, img_size=64, augment=True, hyp=HYP)
    jd = JD.Dataset(split, img_size=64, augment=True, hyp=HYP)
    for i in range(4):
        rp, rj = random.Random(i), random.Random(i)
        (a, la), (b, lb) = pd_.load_mosaic(i, rp), jd.load_mosaic(i, rj)
        assert a.shape == (64, 64, 3) and np.array_equal(a, b)
        np.testing.assert_allclose(la, lb, atol=1e-9, rtol=0)
        assert rp.getstate() == rj.getstate()


def test_getitem_augmented_matches_jax_under_the_sample_rng(split, monkeypatch):
    """The JAX ``__getitem__`` seeds its generator from the process id and
    the global ``random``; given the port's per-sample generator instead it
    must produce the port's sample bit for bit (mosaic, mixup, HSV, flips)."""
    pd_ = PD.Dataset(split, img_size=64, augment=True, hyp=HYP, seed=3)
    jd = JD.Dataset(split, img_size=64, augment=True, hyp=HYP)

    class _Random:
        @staticmethod
        def Random(s):
            return pd_.sample_rng(s & 0xFFFFF)

        @staticmethod
        def randrange(n):
            return 0

    monkeypatch.setattr(JD, "random", _Random)
    for epoch in (0, 1):
        pd_.epoch = epoch
        for i in range(4):
            got, want = pd_[i], jd[i]
            for a, b in zip(got, want):
                assert np.array_equal(a, b)


@pytest.mark.parametrize("uint8_out", [False, True])
def test_getitem_augmented_shapes_dtypes_and_ranges(split, uint8_out):
    ds = PD.Dataset(split, img_size=64, augment=True, hyp=HYP, uint8_out=uint8_out,
                    max_labels=40)
    n_labels = 0
    for epoch in range(2):
        ds.epoch = epoch
        for i in range(len(ds)):
            im, lb, mask = ds[i]
            assert im.shape == (64, 64, 3) and lb.shape == (40, 5) and mask.shape == (40,)
            assert im.dtype == (np.uint8 if uint8_out else np.float32)
            assert lb.dtype == np.float32 and mask.dtype == bool
            v = lb[mask]
            n_labels += len(v)
            assert np.all((v[:, 1:] >= 0) & (v[:, 1:] <= 1)) and np.all(v[:, 3:] > 0)
            assert set(v[:, 0].astype(int)) <= {0, 1, 2}
            assert not lb[~mask].any()
    assert n_labels > 0
    # the same (seed, epoch, index) gives the same sample; another epoch differs
    ds.epoch = 0
    assert np.array_equal(ds[1][0], ds[1][0])
    ds2 = PD.Dataset(split, img_size=64, augment=True, hyp=HYP, uint8_out=uint8_out,
                     max_labels=40, seed=1)
    assert not np.array_equal(ds[1][0], ds2[1][0])
    # close_mosaic edits this instance's copy of hyp only
    ds.hyp["mosaic"] = 0.0
    assert HYP["mosaic"] == 1.0 and ds[0][0].shape == (64, 64, 3)


@pytest.mark.parametrize("cache", ["ram", "disk"])
def test_image_caches_equal_uncached(split, cache, tmp_path):
    plain = PD.Dataset(split, img_size=64, augment=True, hyp=HYP)
    cached = PD.Dataset(split, img_size=64, augment=True, hyp=HYP,
                        cache_images=cache, cache_dir=str(tmp_path))
    for _ in range(2):          # the first pass fills the cache, the second reads it
        for i in range(len(plain)):
            for a, b in zip(cached[i], plain[i]):
                assert np.array_equal(a, b)
            (a, ahw, ash), (b, bhw, bsh) = cached.load_image(i), plain.load_image(i)
            assert np.array_equal(a, b) and ahw == bhw and ash == bsh
    if cache == "disk":
        assert len(list(tmp_path.glob("*.npy"))) == 2 * len(plain)
    # a multi-scale epoch: an entry cached at 64 px is not served at 32 px
    cached.img_size = plain.img_size = 32
    assert np.array_equal(cached.load_image(2)[0], plain.load_image(2)[0])
    assert max(cached.load_image(2)[0].shape[:2]) == 32


def test_check_and_kmean_anchors_match_jax():
    rng = np.random.RandomState(12)
    labels = [np.concatenate([rng.randint(0, 3, (n, 1)), rng.rand(n, 2),
                              rng.uniform(0.005, 0.9, (n, 2))], 1).astype(np.float32)
              for n in rng.randint(0, 9, 40)]
    shapes = rng.randint(200, 900, (40, 2)).astype(np.float64)
    wh = PAA.dataset_wh(labels, shapes, 640)
    np.testing.assert_allclose(wh, JAA.dataset_wh(labels, shapes, 640), rtol=1e-12)
    np.testing.assert_allclose(PAA.kmean_anchors(wh, n=6, gen=200, seed=4),
                               JAA.kmean_anchors(wh, n=6, gen=200, seed=4), rtol=1e-6)
    anchors = np.array([[10, 14, 23, 27, 37, 58], [81, 82, 135, 169, 344, 319]],
                       np.float64)
    for a in (anchors, anchors * 8):                 # kept, then refit
        (ga, gc), (wa, wc) = (PAA.check_anchors(labels, shapes, a, 4.0, 640),
                              JAA.check_anchors(labels, shapes, a, 4.0, 640))
        assert gc == wc
        np.testing.assert_allclose(ga, wa, rtol=1e-6)
    assert gc    # the scaled-up anchors are refit


def test_quad_collate_matches_jax(split):
    """``batches(quad=True)`` on the val half (no augmentation, so both sides
    load the same pixels): each 2x canvas and its labels equal JAX's, and a
    batch not divisible by 4 or eval metadata are refused as there."""
    pd_ = PD.Dataset(split, img_size=32, augment=False, max_labels=5, uint8_out=True)
    jd = JD.Dataset(split, img_size=32, augment=False, max_labels=5, uint8_out=True)
    got = list(pd_.batches(4, shuffle=True, seed=2, quad=True))
    want = list(jd.batches(4, shuffle=True, seed=2, quad=True))
    assert len(got) == len(want) == 1
    for a, b in zip(got[0], want[0]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ims, lbs, ms = got[0]
    assert ims.shape == (1, 64, 64, 3) and lbs.shape == (1, 20, 5) and ms.shape == (1, 20)
    assert ms.any() and (lbs[ms][:, 1:3] <= 1).all()
    for kw in (dict(batch_size=6), dict(batch_size=4, yield_count=True)):
        with pytest.raises(ValueError):
            next(pd_.batches(quad=True, **kw))
